"""BLS signature API and backend registry of the port.

Port of ``lighthouse_tpu/crypto/bls/api.py``: key and signature types,
``SignatureSet``, ``verify``, ``fast_aggregate_verify``,
``aggregate_verify``, the pure-Python ``reference`` backend, the ``fake``
backend, the registry (``register_backend``, ``set_backend``,
``get_backend``, ``auto``) and ``verify_signature_sets`` over named
backends, with the offload supervisor (:650-920 of the JAX module).  The
``cuda`` backend (``ops/bls_backend.py``) and the ``sharded`` backend over
a device mesh (``parallel/bls_sharded.py``) register themselves when first
asked for.

The supervisor runs the device backends (``cuda``, ``sharded``): each
batch on a watchdog thread (on the caller's CUDA device and stream) with
an ``LHGPU_WATCHDOG_S`` deadline, behind a circuit breaker per backend
(closed, open with exponential backoff, a half-open probe), down the
ladder ``LHGPU_SUPERVISOR_LADDER`` (default ``cuda,sharded,reference``);
a device fault (``ops/faults.is_device_fault``: an injected fault, a
watchdog timeout, a CUDA or build error) re-verifies the batch on the
``reference`` rung, which is never broken, and an optional audit
(``LHGPU_SUPERVISOR_AUDIT``, a probability) holds a device verdict to the
reference one.  Any other exception of a backend is a bug and raises.  The
supervisor is the one place a BLS device fault is caught: each is counted
in ``faults()`` (by backend and kind) and each recovery in
``recoveries()`` and logged at warning level, so a run that must show none
(the smoke run, the tests that hold a backend to the JAX package) can
assert it.  A missing card is not a fault: it raises before the ladder.

Batch semantics mirror blst's verify_multiple_aggregate_signatures: per-set
nonzero 64-bit random scalars r_i and one combined multi-pairing check

    e(-g1, Σ r_i·sig_i) · ∏ e(r_i·agg_pk_i, H(m_i)) == 1
"""

from __future__ import annotations

import importlib
import logging
import os
import random
import secrets
import threading
import time
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


def fast_aggregate_verify(pubkeys: Sequence[PublicKey], message: bytes, signature: Signature,
                          **kwargs) -> bool:
    """One message signed by every key: one signature set through
    ``verify_signature_sets`` (``kwargs``: its ``backend``, ``device``)."""
    if not pubkeys:
        return False
    return verify_signature_sets([SignatureSet(signature, list(pubkeys), message)], **kwargs)


def aggregate_verify(pubkeys: Sequence[PublicKey], messages: Sequence[bytes],
                     signature: Signature) -> bool:
    """Distinct messages, one key each, one aggregate signature (a host
    multi-pairing)."""
    if not pubkeys or len(pubkeys) != len(messages):
        return False
    try:
        sig_pt = signature.point
        pairs = [(cv.g1_neg(cv.g1_generator()), sig_pt)]
        for pk, msg in zip(pubkeys, messages):
            pairs.append((pk.point, _hash_to_g2_memo(msg)))
    except (BlsError, ValueError):
        return False
    if sig_pt is cv.INF:
        return False
    return cv.multi_pairing(pairs).is_one()


def _verify_signature_sets_fake(sets: Sequence[SignatureSet], chunk_size: int | None = None,
                                device=None) -> bool:
    """Structure checks only: every well-formed set verifies (the
    reference client's fake_crypto backend, for tests of the logic around
    verification)."""
    if not sets:
        return False
    return all(s.pubkeys and len(s.signature.to_bytes()) == 96 for s in sets)


_BACKENDS: dict[str, Callable[..., bool]] = {"reference": _verify_signature_sets_reference,
                                             "fake": _verify_signature_sets_fake}
_active_backend = "cuda"


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


def set_backend(name: str) -> None:
    """The backend ``verify_signature_sets`` takes when none is named
    (``cuda`` until set; ``auto`` resolves at each call)."""
    global _active_backend
    if name != "auto":
        _resolve_backend(name)
    _active_backend = name


def get_backend() -> str:
    return _active_backend


def resolve_auto_backend() -> str:
    """``auto``: ``LHGPU_BLS_BACKEND`` when set, else ``cuda`` when a card
    is visible and ``reference`` otherwise.  A probe that fails is counted
    as a fault of ``auto`` and logged, and gives ``reference``."""
    env = os.environ.get("LHGPU_BLS_BACKEND", "").strip()
    if env:
        _resolve_backend(env)
        return env
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "reference"
    except Exception as e:
        record_fault("auto", "probe", e)
        return "reference"


# --- the offload supervisor ----------------------------------------------------

_LOG = logging.getLogger(__name__)
_DEVICE_BACKENDS = ("cuda", "sharded")
_COUNT_LOCK = threading.Lock()
_FAULTS: dict[tuple[str, str], int] = {}
_RECOVERIES: dict[str, int] = {}


def record_fault(backend: str, kind: str, exc: BaseException | None = None) -> None:
    """Count one fault of ``backend`` (a BLS backend, or a plane such as
    the pubkey fold) by kind."""
    with _COUNT_LOCK:
        _FAULTS[(backend, kind)] = _FAULTS.get((backend, kind), 0) + 1
    _LOG.warning("BLS offload fault on %s (%s): %r", backend, kind, exc)


def record_recovery(entry: str, served: str = "reference") -> None:
    """Count one batch that ``entry`` (the requested backend, or the
    plane) handed to ``served`` after a fault, and log it."""
    with _COUNT_LOCK:
        _RECOVERIES[entry] = _RECOVERIES.get(entry, 0) + 1
    _LOG.warning("recovered a batch of %s on %s", entry, served)


def faults() -> dict[tuple[str, str], int]:
    """Faults caught so far, by (backend, kind)."""
    with _COUNT_LOCK:
        return dict(_FAULTS)


def recoveries() -> dict[str, int]:
    """Recoveries so far, by the backend or plane that faulted."""
    with _COUNT_LOCK:
        return dict(_RECOVERIES)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


class _CircuitBreaker:
    """One backend's health: closed -> open after ``fail_threshold``
    faults in a row; open -> half_open when the backoff has passed (one
    probe batch goes through); half_open -> closed when the probe passes,
    or open again with the backoff doubled (to ``backoff_max_s``)."""

    def __init__(self, backend: str, fail_threshold: int, backoff_s: float,
                 backoff_max_s: float):
        self.backend = backend
        self.fail_threshold = fail_threshold
        self.base_backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.clock = time.monotonic
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0
        self.backoff_s = backoff_s
        self.open_until = 0.0

    def allow(self) -> bool:
        """May a batch go to this backend now?"""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open" and self.clock() >= self.open_until:
                self.state = "half_open"
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self.backoff_s = self.base_backoff_s

    def record_failure(self) -> None:
        with self._lock:
            old = self.state
            self.failures += 1
            if old == "half_open" or self.failures >= self.fail_threshold:
                # a failed probe doubles the backoff of the opening it
                # causes (the JAX breaker sets the opening before it doubles)
                if old == "half_open":
                    self.backoff_s = min(self.backoff_s * 2, self.backoff_max_s)
                self.state = "open"
                self.open_until = self.clock() + self.backoff_s


class _Supervisor:
    """The knobs read once and the breakers; rebuilt by
    :func:`reset_supervisor`."""

    BREAKERS = _DEVICE_BACKENDS + ("pubkey",)

    def __init__(self):
        from lighthouse_tpu_torch.ops import faults

        self.enabled = faults.supervisor_enabled()
        self.watchdog_s = _env_float("LHGPU_WATCHDOG_S", 900.0)
        self.audit = min(max(_env_float("LHGPU_SUPERVISOR_AUDIT", 0.0), 0.0), 1.0)
        ladder = [r.strip() for r in os.environ.get("LHGPU_SUPERVISOR_LADDER", "").split(",")
                  if r.strip()]
        self.ladder = ladder or ["cuda", "sharded", "reference"]
        if "reference" not in self.ladder:
            self.ladder.append("reference")
        threshold = max(1, int(_env_float("LHGPU_SUPERVISOR_FAILS", 1)))
        backoff = max(0.0, _env_float("LHGPU_SUPERVISOR_BACKOFF_S", 1.0))
        backoff_max = max(backoff, _env_float("LHGPU_SUPERVISOR_BACKOFF_MAX_S", 60.0))
        self.breakers = {b: _CircuitBreaker(b, threshold, backoff, backoff_max)
                         for b in self.BREAKERS}

    def ladder_from(self, entry: str) -> list[str]:
        if entry in self.ladder:
            return self.ladder[self.ladder.index(entry):]
        return [entry, "reference"]

    def _should_audit(self) -> bool:
        return self.audit >= 1.0 or (self.audit > 0.0 and random.random() < self.audit)

    def _call(self, rung: str, fn, sets, kwargs):
        if not self.watchdog_s or self.watchdog_s <= 0:
            return fn(sets, **kwargs)
        from lighthouse_tpu_torch.ops import faults as _faults

        return _faults.run_with_deadline(lambda: fn(sets, **kwargs), self.watchdog_s,
                                         f"lhgpu-bls-{rung}", f"{rung} batch")

    def verify(self, entry: str, sets, kwargs: dict) -> bool:
        """Down the ladder from ``entry``; the reference rung ends it and
        never raises for the card's sake."""
        from lighthouse_tpu_torch.ops import faults as _faults

        for rung in self.ladder_from(entry):
            if rung == "reference":
                break
            breaker = self.breakers.get(rung)
            if breaker is None or not breaker.allow():
                continue
            try:
                ok = self._call(rung, _resolve_backend(rung), sets, kwargs)
            except Exception as e:
                if not _faults.is_device_fault(e):
                    raise                   # a bug of the backend, not of the card
                record_fault(rung, _faults.classify(e), e)
                breaker.record_failure()
                continue
            except BaseException:
                breaker.record_failure()
                raise
            if self._should_audit():
                ref = _verify_signature_sets_reference(sets)
                if ref != ok:
                    record_fault(rung, "corrupt")
                    breaker.record_failure()
                    record_recovery(entry)
                    return ref
            breaker.record_success()
            return ok
        record_recovery(entry)
        return _verify_signature_sets_reference(sets)


_SUPERVISOR: _Supervisor | None = None
_SUPERVISOR_LOCK = threading.Lock()


def _get_supervisor() -> _Supervisor:
    global _SUPERVISOR
    with _SUPERVISOR_LOCK:
        if _SUPERVISOR is None:
            _SUPERVISOR = _Supervisor()
        return _SUPERVISOR


def reset_supervisor() -> None:
    """Drop the supervisor: the next call reads the ``LHGPU_SUPERVISOR*``
    and ``LHGPU_WATCHDOG_S`` variables again, with every breaker closed.
    The counters stay."""
    global _SUPERVISOR
    with _SUPERVISOR_LOCK:
        _SUPERVISOR = None


def backend_health() -> dict[str, str]:
    """Each breaker's state: the device backends' and the pubkey plane's."""
    return {b: br.state for b, br in _get_supervisor().breakers.items()}


def plane_breaker(name: str) -> _CircuitBreaker:
    """The breaker of a device plane outside the BLS ladder (``pubkey``:
    the pubkey fold's device rungs)."""
    return _get_supervisor().breakers[name]


def verify_signature_sets(sets: Sequence[SignatureSet], *, backend: str | None = None,
                          chunk_size: int | None = None, device=None) -> bool:
    """Batch-verify signature sets on the named backend, else the one
    ``set_backend`` chose: the card's (``cuda``) unless set.

    ``chunk_size`` tunes the chunked pipeline of the ``cuda`` and ``sharded``
    backends (None: LHGPU_BLS_CHUNK or the default; 0: one chunk).
    ``device`` is passed to the backend: ``cuda`` unless ``"cpu"`` is given,
    and without a card the call raises before any work (``sharded``: every
    visible card, or a mesh of that one device).  The device backends run
    under the supervisor (the module doc; ``LHGPU_SUPERVISOR=0`` calls them
    directly); ``reference`` is the pure-Python host check, ``fake`` checks
    structure only."""
    name = backend or _active_backend
    if name == "auto":
        name = resolve_auto_backend()
    kwargs = {} if chunk_size is None else {"chunk_size": chunk_size}
    if device is not None:
        kwargs["device"] = device
    sup = _get_supervisor()
    if sup.enabled and name in _DEVICE_BACKENDS:
        from lighthouse_tpu_torch.device import resolve_device

        resolve_device(device)
        return sup.verify(name, sets, kwargs)
    return _resolve_backend(name)(sets, **kwargs)
