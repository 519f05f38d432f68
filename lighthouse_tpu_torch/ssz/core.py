"""SSZ (SimpleSerialize) types: serialization and hash_tree_root.

Port of ``lighthouse_tpu/ssz/core.py``, cut to the types a Deneb beacon
state needs.  Large homogeneous collections hash columnar: all element
roots come from one batched merkleization over a ``uint32[N, leaves, 8]``
word array whose levels run through the pair-hash kernel on ``device``.

Every ``hash_tree_root`` takes ``device`` (default ``cuda``; ``"cpu"``
runs the kernels' plain versions) and passes it down.
"""

from __future__ import annotations

import sys
from typing import Any, Sequence

import numpy as np
import torch

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import sha256 as sha_ops

BYTES_PER_CHUNK = 32
OFFSET_BYTES = 4


def _pad_chunks(data: bytes) -> bytes:
    if len(data) % BYTES_PER_CHUNK:
        data += b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return data


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class SSZType:
    """Base descriptor.  ``fixed_size`` is None for variable-size types."""

    fixed_size: int | None = None

    def serialize(self, value: Any) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes) -> Any:
        raise NotImplementedError

    def hash_tree_root(self, value: Any, device=None) -> bytes:
        raise NotImplementedError

    def default(self) -> Any:
        raise NotImplementedError

    def batch_roots(self, values: Sequence[Any], device: torch.device) -> np.ndarray:
        """Roots for many values at once -> uint32[N, 8] (per-value loop
        unless a columnar override exists)."""
        out = np.empty((len(values), 8), dtype=np.uint32)
        for i, v in enumerate(values):
            out[i] = np.frombuffer(self.hash_tree_root(v, device), dtype=">u4")
        return out

    def chunk_count(self) -> int:
        raise NotImplementedError


def _batch_merkleize_subtrees(leaves: np.ndarray, device: torch.device) -> np.ndarray:
    """Merkleize N subtrees of identical depth in lockstep.

    leaves: uint32[N, L, 8] with L a power of two -> uint32[N, 8].  When the
    first level reaches the device threshold, the words cross to ``device``
    once and every level runs there; otherwise each level hashes on the host.
    """
    n, width, _ = leaves.shape
    if width & (width - 1):
        raise ValueError("subtree width must be a power of two")
    if n * width // 2 >= sha_ops._DEVICE_MIN_PAIRS:
        level = sha_ops.to_tensor(leaves.reshape(n * width, 8), device)
        while level.shape[0] > n:
            level = sha_ops.hash_pairs_device(level.reshape(-1, 16))
        return sha_ops.to_numpy(level)
    level = leaves
    while level.shape[1] > 1:
        pairs = level.reshape(n * level.shape[1] // 2, 16)
        level = sha_ops.hash_pairs_np(pairs).reshape(n, level.shape[1] // 2, 8)
    return level[:, 0, :]


# ---------------------------------------------------------------------------
# Basic types
# ---------------------------------------------------------------------------

class Uint(SSZType):
    def __init__(self, byte_len: int):
        if byte_len not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"no uint of {byte_len} bytes")
        self.fixed_size = byte_len

    def serialize(self, value: int) -> bytes:
        return int(value).to_bytes(self.fixed_size, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.fixed_size:
            raise ValueError(f"uint{self.fixed_size * 8}: expected {self.fixed_size} bytes, got {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value: int, device=None) -> bytes:
        resolve_device(device)
        return self.serialize(value).ljust(32, b"\x00")

    def default(self) -> int:
        return 0

    def chunk_count(self) -> int:
        return 1

    def batch_roots(self, values: Sequence[int], device: torch.device) -> np.ndarray:
        raw = b"".join(self.serialize(v).ljust(32, b"\x00") for v in values)
        return np.frombuffer(raw, dtype=">u4").reshape(len(values), 8).astype(np.uint32)

    def __repr__(self):
        return f"uint{self.fixed_size * 8}"


class _Boolean(SSZType):
    fixed_size = 1

    def serialize(self, value: bool) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("invalid boolean byte")

    def hash_tree_root(self, value: bool, device=None) -> bytes:
        resolve_device(device)
        return self.serialize(value).ljust(32, b"\x00")

    def default(self) -> bool:
        return False

    def chunk_count(self) -> int:
        return 1

    def __repr__(self):
        return "boolean"


uint64 = Uint(8)
uint256 = Uint(32)
boolean = _Boolean()


class ByteVector(SSZType):
    """Fixed-length opaque bytes (Bytes4/20/32/48/96)."""

    def __init__(self, length: int):
        self.length = length
        self.fixed_size = length

    def serialize(self, value: bytes) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)} bytes")
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        return self.serialize(data)

    def hash_tree_root(self, value: bytes, device=None) -> bytes:
        return sha_ops.merkleize(_pad_chunks(self.serialize(value)),
                                 device=resolve_device(device))

    def default(self) -> bytes:
        return b"\x00" * self.length

    def chunk_count(self) -> int:
        return (self.length + 31) // 32

    def batch_roots(self, values: Sequence[bytes], device: torch.device) -> np.ndarray:
        n = len(values)
        for v in values:
            if len(v) != self.length:
                raise ValueError(f"ByteVector[{self.length}]: got {len(v)} bytes")
        if self.length <= 32:
            raw = b"".join(bytes(v).ljust(32, b"\x00") for v in values)
            return np.frombuffer(raw, dtype=">u4").reshape(n, 8).astype(np.uint32)
        width = _next_pow2(self.chunk_count())
        raw = b"".join(bytes(v).ljust(width * 32, b"\x00") for v in values)
        leaves = np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(n, width, 8)
        return _batch_merkleize_subtrees(leaves, device)

    def __repr__(self):
        return f"ByteVector[{self.length}]"


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


class ByteList(SSZType):
    """Variable-length bytes with a max length (e.g. extra_data)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.fixed_size = None

    def serialize(self, value: bytes) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: got {len(value)} bytes")
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(data)

    def hash_tree_root(self, value: bytes, device=None) -> bytes:
        root = sha_ops.merkleize(_pad_chunks(bytes(value)), (self.limit + 31) // 32,
                                 device=resolve_device(device))
        return sha_ops.mix_in_length(root, len(value))

    def default(self) -> bytes:
        return b""

    def chunk_count(self) -> int:
        return (self.limit + 31) // 32

    def __repr__(self):
        return f"ByteList[{self.limit}]"


class Bitvector(SSZType):
    def __init__(self, length: int):
        if length <= 0:
            raise ValueError("Bitvector length must be positive")
        self.length = length
        self.fixed_size = (length + 7) // 8

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Bitvector[{self.length}]: got {len(value)} bits")
        out = bytearray(self.fixed_size)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def deserialize(self, data: bytes) -> list[bool]:
        if len(data) != self.fixed_size:
            raise ValueError("Bitvector size mismatch")
        for i in range(self.length, len(data) * 8):
            if data[i // 8] >> (i % 8) & 1:
                raise ValueError("Bitvector padding bits set")
        return [bool(data[i // 8] >> (i % 8) & 1) for i in range(self.length)]

    def hash_tree_root(self, value: Sequence[bool], device=None) -> bytes:
        return sha_ops.merkleize(self.serialize(value), self.chunk_count(),
                                 device=resolve_device(device))

    def default(self) -> list[bool]:
        return [False] * self.length

    def chunk_count(self) -> int:
        return (self.length + 255) // 256

    def __repr__(self):
        return f"Bitvector[{self.length}]"


def _pack_bits(value: Sequence[bool], nbytes: int) -> bytearray:
    out = bytearray(nbytes)
    for i, bit in enumerate(value):
        if bit:
            out[i // 8] |= 1 << (i % 8)
    return out


class Bitlist(SSZType):
    def __init__(self, limit: int):
        self.limit = limit
        self.fixed_size = None

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: {len(value)} bits over limit")
        out = _pack_bits(value, (len(value) + 8) // 8)
        out[len(value) // 8] |= 1 << (len(value) % 8)      # delimiter
        return bytes(out)

    def deserialize(self, data: bytes) -> list[bool]:
        if not data:
            raise ValueError("Bitlist needs at least the delimiter byte")
        last = data[-1]
        if last == 0:
            raise ValueError("Bitlist missing delimiter bit")
        bit_len = (len(data) - 1) * 8 + last.bit_length() - 1
        if bit_len > self.limit:
            raise ValueError("Bitlist over limit")
        return [bool(data[i // 8] >> (i % 8) & 1) for i in range(bit_len)]

    def hash_tree_root(self, value: Sequence[bool], device=None) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: {len(value)} bits over limit")
        root = sha_ops.merkleize(bytes(_pack_bits(value, (len(value) + 7) // 8)),
                                 self.chunk_count(), device=resolve_device(device))
        return sha_ops.mix_in_length(root, len(value))

    def default(self) -> list[bool]:
        return []

    def chunk_count(self) -> int:
        return (self.limit + 255) // 256

    def __repr__(self):
        return f"Bitlist[{self.limit}]"


# ---------------------------------------------------------------------------
# Composite types
# ---------------------------------------------------------------------------

def _pack_basics(typ: Uint | _Boolean, values: Sequence[Any]) -> bytes:
    return _pad_chunks(b"".join(typ.serialize(v) for v in values))


class Vector(SSZType):
    def __init__(self, element, length: int):
        if length <= 0:
            raise ValueError("Vector length must be positive")
        element = coerce_type(element)
        self.element = element
        self.length = length
        self.fixed_size = (
            element.fixed_size * length if element.fixed_size is not None else None
        )

    def serialize(self, value: Sequence[Any]) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Vector[{self.element},{self.length}]: got {len(value)}")
        return _serialize_homogeneous(self.element, value)

    def deserialize(self, data: bytes) -> list[Any]:
        out = _deserialize_homogeneous(self.element, data)
        if len(out) != self.length:
            raise ValueError("Vector length mismatch")
        return out

    def hash_tree_root(self, value: Sequence[Any], device=None) -> bytes:
        device = resolve_device(device)
        if len(value) != self.length:
            raise ValueError(
                f"Vector[{self.element},{self.length}]: got {len(value)} elements")
        if isinstance(self.element, (Uint, _Boolean)):
            return sha_ops.merkleize(_pack_basics(self.element, value),
                                     self.chunk_count(), device=device)
        roots = self.element.batch_roots(list(value), device)
        return sha_ops.words_to_bytes(
            sha_ops.merkleize_words(roots, self.chunk_count(), device=device))

    def default(self) -> list[Any]:
        return [self.element.default() for _ in range(self.length)]

    def chunk_count(self) -> int:
        if isinstance(self.element, (Uint, _Boolean)):
            return (self.length * self.element.fixed_size + 31) // 32
        return self.length

    def __repr__(self):
        return f"Vector[{self.element},{self.length}]"


class List(SSZType):
    def __init__(self, element, limit: int):
        self.element = coerce_type(element)
        self.limit = limit
        self.fixed_size = None

    def serialize(self, value: Sequence[Any]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"List limit {self.limit} exceeded: {len(value)}")
        return _serialize_homogeneous(self.element, value)

    def deserialize(self, data: bytes) -> list[Any]:
        out = _deserialize_homogeneous(self.element, data)
        if len(out) > self.limit:
            raise ValueError("List over limit")
        return out

    def hash_tree_root(self, value: Sequence[Any], device=None) -> bytes:
        device = resolve_device(device)
        if len(value) > self.limit:
            raise ValueError(f"List limit {self.limit} exceeded: {len(value)}")
        if isinstance(self.element, (Uint, _Boolean)):
            root = sha_ops.merkleize(_pack_basics(self.element, value),
                                     self.chunk_count(), device=device)
        else:
            roots = (self.element.batch_roots(list(value), device) if value
                     else np.zeros((0, 8), dtype=np.uint32))
            root = sha_ops.words_to_bytes(
                sha_ops.merkleize_words(roots, self.chunk_count(), device=device))
        return sha_ops.mix_in_length(root, len(value))

    def default(self) -> list[Any]:
        return []

    def chunk_count(self) -> int:
        if isinstance(self.element, (Uint, _Boolean)):
            return (self.limit * self.element.fixed_size + 31) // 32
        return self.limit

    def __repr__(self):
        return f"List[{self.element},{self.limit}]"


def _serialize_homogeneous(element: SSZType, values: Sequence[Any]) -> bytes:
    if element.fixed_size is not None:
        return b"".join(element.serialize(v) for v in values)
    parts = [element.serialize(v) for v in values]
    offset = OFFSET_BYTES * len(parts)
    head, body = bytearray(), bytearray()
    for p in parts:
        head += offset.to_bytes(OFFSET_BYTES, "little")
        body += p
        offset += len(p)
    return bytes(head + body)


def _deserialize_homogeneous(element: SSZType, data: bytes) -> list[Any]:
    if element.fixed_size is not None:
        size = element.fixed_size
        if len(data) % size:
            raise ValueError("element size misalignment")
        return [element.deserialize(data[i * size:(i + 1) * size])
                for i in range(len(data) // size)]
    if not data:
        return []
    first_off = int.from_bytes(data[:OFFSET_BYTES], "little")
    if first_off == 0 or first_off % OFFSET_BYTES or first_off > len(data):
        raise ValueError("bad first offset")
    n = first_off // OFFSET_BYTES
    offs = [int.from_bytes(data[i * 4:(i + 1) * 4], "little") for i in range(n)] + [len(data)]
    out = []
    for i in range(n):
        if offs[i + 1] < offs[i]:
            raise ValueError("offsets not monotonic")
        out.append(element.deserialize(data[offs[i]:offs[i + 1]]))
    return out


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

def coerce_type(t) -> SSZType:
    """Accept either an SSZType instance or a Container subclass."""
    if isinstance(t, SSZType):
        return t
    if isinstance(t, type) and issubclass(t, Container):
        return t.as_ssz_type()
    raise TypeError(f"not an SSZ type: {t!r}")


class ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: dict[str, SSZType] = {}
        container_cls = globals().get("Container")
        for base in reversed(cls.__mro__):
            for fname, ftype in vars(base).get("__annotations__", {}).items():
                if isinstance(ftype, str):
                    # stringified by `from __future__ import annotations` in
                    # the defining module: resolve there, and fail loudly,
                    # since a dropped field changes the root
                    mod = sys.modules.get(base.__module__)
                    try:
                        ftype = eval(ftype, vars(mod) if mod else {})  # noqa: S307
                    except Exception as e:
                        raise TypeError(
                            f"{name}.{fname}: cannot resolve annotation "
                            f"{ftype!r} ({e})") from e
                is_nested = (container_cls is not None and isinstance(ftype, type)
                             and issubclass(ftype, container_cls))
                if isinstance(ftype, SSZType) or is_nested:
                    fields[fname] = coerce_type(ftype)
        cls.fields = fields
        if fields and all(t.fixed_size is not None for t in fields.values()):
            cls.ssz_fixed_size = sum(t.fixed_size for t in fields.values())
        else:
            cls.ssz_fixed_size = None
        return cls


class Container(metaclass=ContainerMeta):
    """SSZ container; subclass with annotated fields holding SSZType instances.

    The class doubles as its type descriptor, so containers nest inside
    Vector/List.
    """

    fields: dict[str, SSZType] = {}
    ssz_fixed_size: int | None = None

    def __init__(self, **kwargs):
        for fname, ftype in type(self).fields.items():
            if fname in kwargs:
                setattr(self, fname, kwargs.pop(fname))
            else:
                setattr(self, fname, ftype.default())
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    def __eq__(self, other):
        if type(self) is not type(other):
            return False
        for f in type(self).fields:
            a, b = getattr(self, f), getattr(other, f)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in type(self).fields)
        return f"{type(self).__name__}({inner})"

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)

    class _Descriptor(SSZType):
        """Adapter making a Container class usable as an SSZType instance."""

        def __init__(self, cls):
            self.cls = cls
            self.fixed_size = cls.ssz_fixed_size

        def serialize(self, value):
            return value.serialize()

        def deserialize(self, data):
            return self.cls.deserialize(data)

        def hash_tree_root(self, value, device=None):
            return value.hash_tree_root(device)

        def default(self):
            return self.cls()

        def chunk_count(self):
            return len(self.cls.fields)

        def batch_roots(self, values, device):
            return self.cls.batch_roots(values, device)

        def __repr__(self):
            return self.cls.__name__

    @classmethod
    def as_ssz_type(cls) -> "Container._Descriptor":
        return cls._Descriptor(cls)

    def serialize(self) -> bytes:
        parts = [(ftype.fixed_size is not None, ftype.serialize(getattr(self, fname)))
                 for fname, ftype in type(self).fields.items()]
        fixed_len = sum(len(p) if fixed else OFFSET_BYTES for fixed, p in parts)
        head, body = bytearray(), bytearray()
        offset = fixed_len
        for fixed, p in parts:
            if fixed:
                head += p
            else:
                head += offset.to_bytes(OFFSET_BYTES, "little")
                body += p
                offset += len(p)
        return bytes(head + body)

    @classmethod
    def deserialize(cls, data: bytes):
        pos = 0
        var_fields: list[tuple[str, SSZType, int]] = []
        values: dict[str, Any] = {}
        for fname, ftype in cls.fields.items():
            if ftype.fixed_size is not None:
                values[fname] = ftype.deserialize(data[pos:pos + ftype.fixed_size])
                pos += ftype.fixed_size
            else:
                off = int.from_bytes(data[pos:pos + OFFSET_BYTES], "little")
                var_fields.append((fname, ftype, off))
                pos += OFFSET_BYTES
        if not var_fields and pos != len(data):
            raise ValueError(
                f"{cls.__name__}: {len(data) - pos} trailing bytes after fixed fields")
        if var_fields and var_fields[0][2] != pos:
            raise ValueError(f"first offset {var_fields[0][2]} != fixed-part length {pos}")
        ends = [off for _, _, off in var_fields[1:]] + [len(data)]
        for (fname, ftype, off), end in zip(var_fields, ends):
            if end < off or off > len(data):
                raise ValueError(f"bad offset for field {fname}")
            values[fname] = ftype.deserialize(data[off:end])
        return cls(**values)

    def hash_tree_root(self, device=None) -> bytes:
        """Root of this container on ``device``.  With a tree cache attached
        (``ssz.tree_cache.enable_tree_cache``) the cache's device is used."""
        cache = getattr(self, "_tree_cache", None)
        if cache is not None:
            if device is not None and resolve_device(device) != cache.device:
                raise ValueError(
                    f"state tree cache lives on {cache.device}, not {device}")
            return cache.state_root(self)
        device = resolve_device(device)
        roots = b"".join(ftype.hash_tree_root(getattr(self, fname), device)
                         for fname, ftype in type(self).fields.items())
        return sha_ops.merkleize(roots, len(type(self).fields), device=device)

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def batch_roots(cls, values: Sequence["Container"], device: torch.device) -> np.ndarray:
        """Columnar container hashing: one batched root per field column,
        then lockstep subtree merkleization."""
        n = len(values)
        if n == 0:
            return np.zeros((0, 8), dtype=np.uint32)
        leaves = np.zeros((n, _next_pow2(len(cls.fields)), 8), dtype=np.uint32)
        for i, (fname, ftype) in enumerate(cls.fields.items()):
            leaves[:, i, :] = ftype.batch_roots([getattr(v, fname) for v in values], device)
        return _batch_merkleize_subtrees(leaves, device)


def hash_tree_root(value: Any, typ: SSZType | None = None, device=None) -> bytes:
    """Convenience entry point: root of a Container instance or (value, type)."""
    if typ is None:
        return value.hash_tree_root(device)
    return typ.hash_tree_root(value, device)
