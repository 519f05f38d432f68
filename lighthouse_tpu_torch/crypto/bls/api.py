"""BLS signature API and backend registry of the port.

Port of ``lighthouse_tpu/crypto/bls/api.py``: key and signature types,
``SignatureSet``, ``verify``, the pure-Python ``reference`` backend, and
``verify_signature_sets`` over named backends.  The ``cuda`` backend
(``ops/bls_backend.py``) and the ``sharded`` backend over a device mesh
(``parallel/bls_sharded.py``) register themselves when first asked for.

There is no supervisor in the port: ``verify_signature_sets`` calls the
named backend directly, and a device fault raises instead of recovering
onto the reference backend, so a fault can never hide behind the host.

Batch semantics mirror blst's verify_multiple_aggregate_signatures: per-set
nonzero 64-bit random scalars r_i and one combined multi-pairing check

    e(-g1, Σ r_i·sig_i) · ∏ e(r_i·agg_pk_i, H(m_i)) == 1
"""

from __future__ import annotations

import importlib
import secrets
from dataclasses import dataclass
from typing import Callable, Sequence

from lighthouse_tpu_torch.common.utils import LruCache
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import R
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2

RAND_BITS = 64


class BlsError(ValueError):
    pass


# hash-to-curve memo for the default DST (bounded: a stream of unique
# messages stays O(1) memory)
_H2G_MEMO = LruCache(capacity=512)


def _hash_to_g2_memo(message: bytes):
    pt = _H2G_MEMO.get(message)
    if pt is None:
        pt = hash_to_g2(message)
        _H2G_MEMO.put(message, pt)
    return pt


# process-wide interning of wire keys and signatures (bounded)
_PK_INTERN = LruCache(capacity=1 << 21)
_SIG_INTERN = LruCache(capacity=1 << 17)


class PublicKey:
    """Compressed G1 public key with lazy decompression and cached
    Montgomery words (a node keeps its validators' keys decompressed)."""

    __slots__ = ("_bytes", "_point", "_limbs")

    def __init__(self, data: bytes, point=None):
        if len(data) != 48:
            raise BlsError("public key must be 48 bytes")
        self._bytes = bytes(data)
        self._point = point
        self._limbs = None

    @property
    def point(self):
        if self._point is None:
            pt = cv.g1_from_bytes(self._bytes)
            if pt is cv.INF:
                raise BlsError("infinity public key rejected (eth2 KeyValidate)")
            self._point = pt
        return self._point

    def mont_limbs(self):
        """(x, y) Montgomery words uint32[12] each, cached."""
        if self._limbs is None:
            from lighthouse_tpu_torch.ops import bigint

            rows = bigint.ints_to_mont_limbs(self.point)
            self._limbs = (rows[0], rows[1])
        return self._limbs

    def to_bytes(self) -> bytes:
        return self._bytes

    @staticmethod
    def interned(data: bytes) -> "PublicKey":
        """One PublicKey object per key bytes, process-wide, so its
        decompression, membership check and words are paid once per
        validator whichever state or batch the key appears in."""
        pk = _PK_INTERN.get(data)
        if pk is None:
            pk = PublicKey(data)
            _PK_INTERN.put(bytes(data), pk)
        return pk

    @staticmethod
    def intern_decompressed(pks: Sequence["PublicKey"]) -> None:
        """Make keys that already hold their points (made from their secret
        scalars, so in G1 by construction) the interned objects of their
        bytes: a node holds its registry's keys decompressed, and later
        ``interned`` lookups skip the host decompression and [r]P check."""
        for pk in pks:
            if pk._point is None:
                raise BlsError("intern_decompressed: key without its point")
            _PK_INTERN.put(pk._bytes, pk)

    @staticmethod
    def decompress_batch(pks: Sequence["PublicKey"]) -> bool:
        """Decompress and membership-check every not-yet-decompressed key
        in one native call each (``csrc/bls_host.cc``).  A key that fails
        either step, or encodes infinity, stays pending, so that its
        ``point`` raises for it alone.  False if any failed."""
        from lighthouse_tpu_torch.ops import native_bls

        pending = [pk for pk in pks if pk._point is None]
        if not pending:
            return True
        pts = native_bls.g1_decompress_batch([pk._bytes for pk in pending])
        live = [(pk, pt) for pk, pt in zip(pending, pts)
                if pt is not None and pt != native_bls.G1_INF]
        verdicts = native_bls.g1_in_subgroup_batch([pt for _pk, pt in live])
        for (pk, pt), ok in zip(live, verdicts):
            if ok == 1:
                pk._point = pt
        return len(live) == len(pending) and all(v == 1 for v in verdicts)

    def __eq__(self, o):
        return isinstance(o, PublicKey) and self._bytes == o._bytes

    def __hash__(self):
        return hash(self._bytes)

    def __repr__(self):
        return f"PublicKey({self._bytes.hex()[:16]}…)"


class Signature:
    """Compressed G2 signature with lazy decompression.  The subgroup check
    is split from decompression (``point_unchecked`` and
    ``mark_subgroup_checked``) so that a batch verifier checks many fresh
    signatures in one kernel."""

    __slots__ = ("_bytes", "_point", "_subgroup_ok")

    def __init__(self, data: bytes, point=None):
        if len(data) != 96:
            raise BlsError("signature must be 96 bytes")
        self._bytes = bytes(data)
        self._point = point
        self._subgroup_ok = point is not None

    @property
    def point(self):
        if self._point is None:
            self._point = cv.g2_from_bytes(self._bytes)
            self._subgroup_ok = True
        elif not self._subgroup_ok:
            if not cv.g2_in_subgroup_fast(self._point):
                raise BlsError("signature not in G2 subgroup")
            self._subgroup_ok = True
        return self._point

    def point_unchecked(self):
        """The decompressed point WITHOUT the subgroup check."""
        if self._point is None:
            self._point = cv.g2_from_bytes(self._bytes, subgroup_check=False)
        return self._point

    def subgroup_checked(self) -> bool:
        return self._subgroup_ok

    def mark_subgroup_checked(self):
        self._subgroup_ok = True

    def to_bytes(self) -> bytes:
        return self._bytes

    def __eq__(self, o):
        return isinstance(o, Signature) and self._bytes == o._bytes

    def __repr__(self):
        return f"Signature({self._bytes.hex()[:16]}…)"

    @staticmethod
    def interned(data: bytes) -> "Signature":
        """One Signature object per signature bytes, process-wide: its
        decompressed point and membership verdict (properties of the bytes)
        are paid once, however many batches or duplicate copies carry it."""
        sig = _SIG_INTERN.get(data)
        if sig is None:
            sig = Signature(data)
            _SIG_INTERN.put(bytes(data), sig)
        return sig

    @staticmethod
    def subgroup_check_batch(sigs: Sequence["Signature"]) -> bool:
        """Complete the G2 membership test of every decompressed,
        not-yet-checked signature in one native call.  Passing signatures
        are marked checked; failing and infinity ones stay unmarked, so
        per-signature paths check them again and attribute.  True when
        every pending signature passed."""
        from lighthouse_tpu_torch.ops import native_bls

        pending, pts = [], []
        all_finite = True
        for s in sigs:
            if s._subgroup_ok:
                continue
            try:
                pt = s.point_unchecked()
            except (BlsError, ValueError):
                all_finite = False
                continue
            if pt is cv.INF:
                all_finite = False
                continue
            pending.append(s)
            pts.append(((pt[0].a, pt[0].b), (pt[1].a, pt[1].b)))
        ok = all_finite
        for s, v in zip(pending, native_bls.g2_in_subgroup_batch(pts)):
            if v == 1:
                s._subgroup_ok = True
            else:
                ok = False
        return ok

    @staticmethod
    def decompress_batch(sigs: Sequence["Signature"]) -> bool:
        """Decompress every not-yet-decompressed signature in one native
        call (``csrc/bls_host.cc``), without subgroup checks.  False if any
        fails to decompress; a valid infinity encoding decompresses to
        ``cv.INF`` (verifiers reject it)."""
        from lighthouse_tpu_torch.ops import native_bls

        pending = [s for s in sigs if s._point is None]
        if not pending:
            return True
        ok = True
        for s, r in zip(pending, native_bls.g2_decompress_batch([s._bytes for s in pending])):
            if r is None:
                ok = False
            elif r == native_bls.G2_INF:
                s._point = cv.INF
            else:
                (xa, xb), (ya, yb) = r
                s._point = (cv.Fq2(xa, xb), cv.Fq2(ya, yb))
        return ok


class SecretKey:
    __slots__ = ("k",)

    def __init__(self, k: int):
        if not 0 < k < R:
            raise BlsError("secret key out of range")
        self.k = k

    @staticmethod
    def from_bytes(data: bytes) -> "SecretKey":
        return SecretKey(int.from_bytes(data, "big"))

    def public_key(self) -> PublicKey:
        pt = cv.g1_mul(cv.g1_generator(), self.k)
        return PublicKey(cv.g1_to_bytes(pt), pt)

    def sign(self, message: bytes) -> Signature:
        pt = cv.g2_mul(_hash_to_g2_memo(message), self.k)
        return Signature(cv.g2_to_bytes(pt), pt)


@dataclass
class SignatureSet:
    """One verification unit: ``signature`` over ``message`` by the
    aggregate of ``pubkeys``."""

    signature: Signature
    pubkeys: list[PublicKey]
    message: bytes

    def aggregate_pubkey(self):
        pt = cv.INF
        for pk in self.pubkeys:
            pt = cv.g1_add(pt, pk.point)
        return pt


def verify(pubkey: PublicKey, message: bytes, signature: Signature) -> bool:
    try:
        sig_pt = signature.point
        pk_pt = pubkey.point
    except (BlsError, ValueError):
        return False
    if sig_pt is cv.INF:
        return False
    res = cv.multi_pairing([(cv.g1_neg(cv.g1_generator()), sig_pt),
                            (pk_pt, _hash_to_g2_memo(message))])
    return res.is_one()


def _verify_signature_sets_reference(sets: Sequence[SignatureSet],
                                     chunk_size: int | None = None, device=None) -> bool:
    """Randomized batch verification on the host (one multi-pairing).
    ``chunk_size`` and ``device`` are accepted for seam compatibility and
    ignored."""
    if not sets:
        return False
    prepared = []
    for s in sets:
        if not s.pubkeys:
            return False
        try:
            sig_pt = s.signature.point
            agg_pk = s.aggregate_pubkey()
        except (BlsError, ValueError):
            return False
        if sig_pt is cv.INF:
            return False
        prepared.append((sig_pt, agg_pk, s.message))
    pairs = []
    sig_acc = cv.INF
    for sig_pt, agg_pk, message in prepared:
        rand = 0
        while rand == 0:
            rand = secrets.randbits(RAND_BITS)
        sig_acc = cv.g2_add(sig_acc, cv.g2_mul(sig_pt, rand))
        pairs.append((cv.g1_mul(agg_pk, rand), _hash_to_g2_memo(message)))
    pairs.append((cv.g1_neg(cv.g1_generator()), sig_acc))
    return cv.multi_pairing(pairs).is_one()


_BACKENDS: dict[str, Callable[..., bool]] = {"reference": _verify_signature_sets_reference}


def register_backend(name: str, fn: Callable[..., bool]) -> None:
    _BACKENDS[name] = fn


def _resolve_backend(name: str) -> Callable[..., bool]:
    if name in ("cuda", "sharded") and name not in _BACKENDS:
        importlib.import_module("lighthouse_tpu_torch.ops.bls_backend" if name == "cuda"
                                else "lighthouse_tpu_torch.parallel.bls_sharded")
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown BLS backend {name!r}; have {sorted(_BACKENDS)}") from None


def verify_signature_sets(sets: Sequence[SignatureSet], *, backend: str = "cuda",
                          chunk_size: int | None = None, device=None) -> bool:
    """Batch-verify signature sets on the named backend, the card's
    (``cuda``) unless another is named.

    ``chunk_size`` tunes the chunked pipeline of the ``cuda`` and ``sharded``
    backends (None: LHGPU_BLS_CHUNK or the default; 0: one chunk).
    ``device`` is passed to the backend: ``cuda`` unless ``"cpu"`` is given,
    and without a card the call raises (``sharded``: every visible card,
    or a mesh of that one device).  ``reference`` is the pure-Python host
    check.  No supervisor: the backend is called directly and its faults
    raise."""
    fn = _resolve_backend(backend)
    kwargs = {} if chunk_size is None else {"chunk_size": chunk_size}
    if device is not None:
        kwargs["device"] = device
    return fn(sets, **kwargs)
