from distributed_tpu_torch.graph.order import order, validate_order
from distributed_tpu_torch.graph.spec import Graph, Key, TaskRef, TaskSpec, tokenize

__all__ = ["Graph", "Key", "TaskRef", "TaskSpec", "order", "tokenize", "validate_order"]
