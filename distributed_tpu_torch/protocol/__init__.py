from distributed_tpu_torch.protocol.core import dumps, loads
from distributed_tpu_torch.protocol.serialize import (
    Pickled,
    Serialize,
    Serialized,
    ToPickle,
    deserialize,
    nested_deserialize,
    register_serialization_family,
    serialize,
    to_serialize,
)

__all__ = [
    "dumps",
    "loads",
    "serialize",
    "deserialize",
    "nested_deserialize",
    "register_serialization_family",
    "Serialize",
    "Serialized",
    "ToPickle",
    "Pickled",
    "to_serialize",
]
