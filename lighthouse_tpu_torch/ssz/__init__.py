"""SSZ type system (serialization + merkleization)."""

from lighthouse_tpu_torch.ssz.core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    SSZType,
    Uint,
    Vector,
    boolean,
    coerce_type,
    hash_tree_root,
    uint64,
    uint256,
)

__all__ = [
    "Bitlist", "Bitvector", "ByteList", "ByteVector", "Bytes4", "Bytes20", "Bytes32",
    "Bytes48", "Bytes96", "Container", "List", "SSZType", "Uint", "Vector",
    "boolean", "coerce_type", "hash_tree_root", "uint64", "uint256",
]
