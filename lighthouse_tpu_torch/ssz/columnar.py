"""Columnar batch SSZ decode of gossip attestations.

Port of ``lighthouse_tpu/ssz/columnar.py`` for the phase0 ... Deneb wire
layout: a same-topic admission batch has a fixed field order and, bar the
aggregation bitlist, fixed sizes, so it parses with one ``np.frombuffer``
per equal-length class, a column slice per field and vectorised structural
checks (offset, bitlist delimiter and limit).  Containers are built lazily,
only for rows that need them (``ColumnarAttestations.materialize``).

Wire layout::

    [bits_offset u32 == 228][data 128][signature 96][aggregation_bits ...]

``AttestationData`` (128 bytes)::

    slot u64 | index u64 | beacon_block_root 32 |
    source.epoch u64 | source.root 32 | target.epoch u64 | target.root 32

Malformed blobs never poison a batch: ``decode_batch`` returns the rows its
parse rejected and the caller runs exactly those through the scalar
``cls.deserialize``.  ``validate_blob`` is the per-delivery check, true iff
the scalar deserialize succeeds.  The Electra layout (EIP-7549) is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DATA_BYTES = 128
SIG_BYTES = 96
OFFSET_BYTES = 4

# bit_length per byte value (the bitlist delimiter, vectorised)
_BIT_LENGTH = np.array([int(b).bit_length() for b in range(256)], dtype=np.int64)


@dataclass(frozen=True)
class WireLayout:
    """Fixed-part geometry of the phase0 ... Deneb attestation."""

    bits_limit: int          # aggregation_bits Bitlist limit

    @property
    def head(self) -> int:
        """Fixed-part length == the required value of the bits offset."""
        return OFFSET_BYTES + DATA_BYTES + SIG_BYTES

    @property
    def sig_off(self) -> int:
        return OFFSET_BYTES + DATA_BYTES


def layout_for(preset, electra: bool = False) -> WireLayout:
    if electra:
        raise NotImplementedError("the Electra attestation layout is not ported (ROADMAP A 16)")
    return WireLayout(preset.max_validators_per_committee)


def validate_blob(blob: bytes, layout: WireLayout) -> bool:
    """True iff the scalar ``Attestation.deserialize`` would succeed."""
    head = layout.head
    if len(blob) <= head:
        return False
    if int.from_bytes(blob[:OFFSET_BYTES], "little") != head:
        return False
    last = blob[-1]
    if last == 0:
        return False                      # bitlist delimiter missing
    return (len(blob) - head - 1) * 8 + last.bit_length() - 1 <= layout.bits_limit


class ColumnarAttestations:
    """Column views over one decoded batch, in arrival order;
    ``row_index[i]`` names the caller's blob.  ``data_raw`` doubles as the
    group key: byte-equal rows attest the same message."""

    __slots__ = ("n", "row_index", "blobs", "slot", "index", "beacon_block_root",
                 "source_epoch", "target_epoch", "target_root", "data_raw", "signature",
                 "bit_count", "set_bits", "first_bit", "_cls", "_materialized")

    def __init__(self, n: int, cls=None):
        self.n = n
        self.row_index = np.empty(n, np.int64)
        self.blobs: list[bytes] = [b""] * n
        self.slot = np.empty(n, np.uint64)
        self.index = np.empty(n, np.uint64)
        self.beacon_block_root = np.empty((n, 32), np.uint8)
        self.source_epoch = np.empty(n, np.uint64)
        self.target_epoch = np.empty(n, np.uint64)
        self.target_root = np.empty((n, 32), np.uint8)
        self.data_raw = np.empty((n, DATA_BYTES), np.uint8)
        self.signature = np.empty((n, SIG_BYTES), np.uint8)
        self.bit_count = np.empty(n, np.int64)   # aggregation bit length
        self.set_bits = np.empty(n, np.int64)    # popcount
        self.first_bit = np.empty(n, np.int64)   # first set bit, -1 if none
        self._cls = cls
        self._materialized: dict[int, object] = {}

    def materialize(self, i: int):
        """The full container of row ``i`` (built once)."""
        obj = self._materialized.get(i)
        if obj is None:
            if self._cls is None:
                raise ValueError("no container class bound to this batch")
            obj = self._cls.deserialize(self.blobs[i])
            self._materialized[i] = obj
        return obj

    def group_keys(self) -> tuple[np.ndarray, np.ndarray]:
        """(group_of_row int64[n], first_row_of_group int64[G]): rows with
        byte-equal AttestationData share a group, the (slot, committee
        index, beacon_block_root) lane."""
        if self.n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        view = np.ascontiguousarray(self.data_raw).view([("d", f"V{DATA_BYTES}")]).ravel()
        _, first, inverse = np.unique(view, return_index=True, return_inverse=True)
        return inverse.astype(np.int64).ravel(), first.astype(np.int64)


_COLUMNS = ("row_index", "slot", "index", "beacon_block_root", "source_epoch", "target_epoch",
            "target_root", "data_raw", "signature", "bit_count", "set_bits", "first_bit")


def decode_batch(blobs: list[bytes], layout: WireLayout, cls=None,
                 ) -> tuple[ColumnarAttestations, list[int]]:
    """Strided parse of a whole admission batch -> (columns of every row
    the vectorised checks accepted, in arrival order; the indices of the
    rows they rejected)."""
    n_in = len(blobs)
    head = layout.head
    lengths = np.fromiter((len(b) for b in blobs), np.int64, count=n_in)
    good_rows: list[np.ndarray] = []
    class_arrays: list[tuple[np.ndarray, np.ndarray]] = []
    for L in np.unique(lengths[lengths > head]):
        rows = np.nonzero(lengths == L)[0]
        arr = np.frombuffer(b"".join(blobs[i] for i in rows), np.uint8).reshape(len(rows), int(L))
        offs = np.ascontiguousarray(arr[:, :OFFSET_BYTES]).view("<u4").ravel()
        last = arr[:, -1].astype(np.int64)
        bit_len = (int(L) - head - 1) * 8 + _BIT_LENGTH[last] - 1
        valid = (offs == head) & (last != 0) & (bit_len <= layout.bits_limit)
        good_rows.append(rows[valid])
        class_arrays.append((arr[valid], bit_len[valid]))

    cols = ColumnarAttestations(sum(len(r) for r in good_rows), cls=cls)
    pos = 0
    for rows, (arr, bit_len) in zip(good_rows, class_arrays):
        m = len(rows)
        if not m:
            continue
        sl = slice(pos, pos + m)
        d = OFFSET_BYTES
        cols.row_index[sl] = rows
        cols.slot[sl] = _read_u64_col(arr, d)
        cols.index[sl] = _read_u64_col(arr, d + 8)
        cols.beacon_block_root[sl] = arr[:, d + 16:d + 48]
        cols.source_epoch[sl] = _read_u64_col(arr, d + 48)
        cols.target_epoch[sl] = _read_u64_col(arr, d + 88)
        cols.target_root[sl] = arr[:, d + 96:d + 128]
        cols.data_raw[sl] = arr[:, d:d + DATA_BYTES]
        cols.signature[sl] = arr[:, layout.sig_off:layout.sig_off + SIG_BYTES]
        cols.bit_count[sl] = bit_len
        # aggregation bits, LSB first within bytes; the delimiter and what
        # follows it are masked out before the popcount
        bits = np.unpackbits(arr[:, head:], axis=1, bitorder="little").astype(bool)
        bits &= np.arange(bits.shape[1]) < bit_len[:, None]
        cols.set_bits[sl] = bits.sum(axis=1)
        cols.first_bit[sl] = np.where(bits.any(axis=1), bits.argmax(axis=1), -1)
        pos += m
    if cols.n:                                  # arrival order across length classes
        order = np.argsort(cols.row_index, kind="stable")
        for name in _COLUMNS:
            setattr(cols, name, getattr(cols, name)[order])
    cols.blobs = [blobs[int(i)] for i in cols.row_index]
    bad = np.ones(n_in, bool)
    bad[cols.row_index] = False
    return cols, [int(i) for i in np.nonzero(bad)[0]]


def _read_u64_col(arr: np.ndarray, off: int) -> np.ndarray:
    """Little-endian u64 column at byte ``off``."""
    return np.ascontiguousarray(arr[:, off:off + 8]).view("<u8").ravel().astype(np.uint64)
