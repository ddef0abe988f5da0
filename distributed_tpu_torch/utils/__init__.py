"""Host helpers of the port: the reference's collections and the part of
its ``utils/misc.py`` that the control plane reads (``utils/sizeof.py``,
the tensor ``sizeof``, is imported on its own)."""

from distributed_tpu_torch.utils.collections import LRU, HeapSet, OrderedSet, sum_mappings
from distributed_tpu_torch.utils.misc import (
    funcname,
    import_term,
    key_split,
    seq_name,
    time,
    wall_clock,
)

__all__ = [
    "LRU",
    "HeapSet",
    "OrderedSet",
    "sum_mappings",
    "funcname",
    "import_term",
    "key_split",
    "seq_name",
    "time",
    "wall_clock",
]
