"""Pre-BLS coalescing of signature sets: exact-duplicate dedup, then the
blinded same-message merge.

Port of ``lighthouse_tpu/pool/pre_aggregation.py`` (``enabled``,
``dedup_sets``, ``merge_same_message``, ``coalesce_sets``).

1. Byte-identical sets verify once.
2. Sets sharing a message fold into ONE set: ``Σ rᵢ·sigᵢ`` against the keys
   ``[rᵢ·aggpkᵢ]``, with a fresh random 64-bit blinder ``rᵢ`` per
   constituent.  The blinders make the fold sound: without them two
   crafted invalid signatures could cancel (``sig₁ = good + δ``,
   ``sig₂ = good₂ − δ``) and ride a merged set through.  With them the
   merged set verifies iff, except with probability 2⁻⁶⁴ per constituent,
   every constituent does.

A group whose members do not decompress, carry an infinity signature, or
fail any step of the fold passes through UNMERGED: coalescing can remove
redundant pairings, never change a verdict.  ``LHGPU_PRE_BLS=0`` turns the
stage off.
"""

from __future__ import annotations

import os
import secrets

from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.crypto.bls import curve as cv


def enabled() -> bool:
    return os.environ.get("LHGPU_PRE_BLS", "1") != "0"


def _set_key(s) -> tuple:
    return (s.signature.to_bytes(), s.message, tuple(pk.to_bytes() for pk in s.pubkeys))


def dedup_sets(sets: list) -> list:
    """Drop byte-identical sets (one verification covers every copy)."""
    seen: set[tuple] = set()
    out = []
    for s in sets:
        key = _set_key(s)
        if key not in seen:
            seen.add(key)
            out.append(s)
    return out


def _fold_group(group: list, message: bytes):
    """One blinded merged set for a same-message group, or None when a
    constituent resists the fold."""
    sig_acc = cv.INF
    pubkeys = []
    try:
        for s in group:
            sig_pt = s.signature.point              # decompress + subgroup check
            if sig_pt is cv.INF or not s.pubkeys:
                return None
            agg_pk = s.aggregate_pubkey()
            r = 0
            while r == 0:
                r = secrets.randbits(64)
            sig_acc = cv.g2_add(sig_acc, cv.g2_mul(sig_pt, r))
            pk_pt = cv.g1_mul(agg_pk, r)
            pubkeys.append(bls.PublicKey(cv.g1_to_bytes(pk_pt), pk_pt))
        merged_sig = bls.Signature(cv.g2_to_bytes(sig_acc), sig_acc)
    except (bls.BlsError, ValueError, TypeError):
        return None
    return bls.SignatureSet(merged_sig, pubkeys, message)


def merge_same_message(sets: list) -> list:
    """Fold same-message sets into one blinded set each; unfoldable groups
    pass through unchanged."""
    groups: dict[bytes, list] = {}
    for s in sets:
        groups.setdefault(s.message, []).append(s)
    out = []
    for message, group in groups.items():
        merged = _fold_group(group, message) if len(group) > 1 else None
        if merged is None:
            out.extend(group)
        else:
            out.append(merged)
    return out


def coalesce_sets(sets: list) -> list:
    """The whole pre-BLS stage: dedup, then the blinded merge.  With
    ``LHGPU_PRE_BLS=0`` (or fewer than 2 sets) the input passes through."""
    if len(sets) < 2 or not enabled():
        return list(sets)
    return merge_same_message(dedup_sets(sets))
