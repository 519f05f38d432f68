"""Naive attestation aggregation pool: gossip-verified unaggregated
attestations OR-ed into one aggregate per (AttestationData root, committee)
per slot.

Port of ``insert`` and ``insert_single_bit`` of
``lighthouse_tpu/pool/naive_aggregation.py``.  Signatures are kept as the
constituents' ``Signature`` objects; aggregating them waits for a reader
(block production).
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.crypto.bls import api as bls


class NaiveAggregationPool:
    def __init__(self, retained_slots: int = 32):
        self.retained_slots = retained_slots
        # slot -> (data_root, committee) -> (data, bits, [sigs], committee)
        self._slots: dict[int, dict[tuple, tuple]] = {}

    def insert(self, attestation) -> bool:
        """Fold one (single-bit or partial) attestation in.  True if it
        contributed at least one new bit."""
        data = attestation.data
        committee = int(data.index)
        key = (data.hash_tree_root("cpu"), committee)
        per_slot = self._slots.setdefault(int(data.slot), {})
        bits = np.asarray(attestation.aggregation_bits, dtype=bool)
        entry = per_slot.get(key)
        if entry is None:
            per_slot[key] = (data, bits.copy(), [bls.Signature(bytes(attestation.signature))],
                             committee)
            self._prune()
            return True
        _, agg_bits, sigs, _ci = entry
        if not (bits & ~agg_bits).any() or (bits & agg_bits).any():
            return False            # nothing new, or an overlap naive OR cannot take
        agg_bits |= bits
        sigs.append(bls.Signature(bytes(attestation.signature)))
        return True

    def insert_single_bit(self, data, data_root: bytes, committee: int, committee_len: int,
                          bit_pos: int, sig_bytes: bytes) -> bool:
        """The columnar lane's form of ``insert`` for one bit: no container
        and no re-hash of the data (the caller holds its root)."""
        per_slot = self._slots.setdefault(int(data.slot), {})
        key = (data_root, committee)
        entry = per_slot.get(key)
        if entry is None:
            bits = np.zeros(committee_len, dtype=bool)
            bits[bit_pos] = True
            per_slot[key] = (data, bits, [bls.Signature(sig_bytes)], committee)
            self._prune()
            return True
        _, agg_bits, sigs, _ci = entry
        if agg_bits.shape[0] != committee_len or agg_bits[bit_pos]:
            return False
        agg_bits[bit_pos] = True
        sigs.append(bls.Signature(sig_bytes))
        return True

    def snapshot(self) -> dict:
        """{(slot, (data_root, committee)): (bits as a list, signature
        bytes in insertion order)}: the pool's content, for comparisons."""
        return {(slot, key): (bits.tolist(), [s.to_bytes() for s in sigs])
                for slot, per_slot in self._slots.items()
                for key, (_d, bits, sigs, _ci) in per_slot.items()}

    def _prune(self):
        if len(self._slots) <= self.retained_slots:
            return
        for slot in sorted(self._slots)[:len(self._slots) - self.retained_slots]:
            del self._slots[slot]

    def __len__(self):
        return sum(len(v) for v in self._slots.values())
