"""The validator pubkey plane: the registry's pubkeys resident on the card,
and the committee-aggregate pubkey fold of the attestation firehose.

Port of ``lighthouse_tpu/chain/pubkey_plane.py``.  The columnar ingest lane
folds every signing-root lane's blinded pubkeys, Σ r_i·pk(v_i) per group,
in one call.  Rungs (routing as in the JAX package):

- ``device``: row 11 (``ops/pubkey_kernels.gather_fold``) over the
  resident table, taken at ``LHGPU_PUBKEY_DEVICE_MIN`` lanes or more
  (default 256) when the plane's device is the card;
- ``reference``: the scalar-sum collapse per (group, pubkey), then one
  native segment MSM on the host (``g1_lincomb_groups``).

``LHGPU_PUBKEY_BACKEND=device|reference`` forces a rung (tests, the smoke
run).  A device fault RAISES: the JAX package's recovery onto the reference
rung and its breaker are not ported (the supervisor, ROADMAP A 5a, is the
only place a recovery may live).

Table discipline: validator pubkeys are append-only and immutable per
index, so a table covering rows [0, T) stays valid for any registry grown
from the same prefix.  The plane fingerprints the pubkey column (sha256) at
build; a registry object not seen yet is checked against the prefix
fingerprint before reuse (and remembered).  A match appends only the new
rows; a mismatch rebuilds.  The swap is all-or-nothing: the new table is
complete before it replaces the old.  The build decompresses and
membership-checks every key natively, through the interned ``PublicKey``
objects, so the verify path finds them decompressed.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as np

from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.crypto.bls.fields import R as _R
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import native_bls, pubkey_kernels

_RUNGS = ("device", "reference")
_DEVICE_MIN_DEFAULT = 256


def device_min() -> int:
    return int(os.environ.get("LHGPU_PUBKEY_DEVICE_MIN", _DEVICE_MIN_DEFAULT))


class PubkeyPlane:
    """The resident table and the fold (a module singleton, ``get_plane``)."""

    def __init__(self, device=None):
        self._device = device
        self._lock = threading.Lock()
        self._table = None              # (tx, ty) on the device
        self._table_rows = 0            # registry rows the table covers
        self._rows = None               # host word rows (x, y) of those rows
        self._prefix_sha = b""          # sha256 of the pubkey rows [0, table_rows)
        self._seen: dict[int, object] = {}    # verified registries, id -> strong ref
        self.refreshes = {"append": 0, "rebuild": 0}
        self.folds = {"device": 0, "reference": 0}

    @property
    def device(self):
        return resolve_device(self._device)

    @property
    def table_rows(self) -> int:
        return self._table_rows

    def resolve_rung(self, n_lanes: int) -> str:
        """Which rung folds an ``n_lanes`` batch: a forced rung first, then
        the device rung on the card at ``device_min()`` lanes or more."""
        forced = os.environ.get("LHGPU_PUBKEY_BACKEND")
        if forced:
            if forced not in _RUNGS:
                raise ValueError(f"LHGPU_PUBKEY_BACKEND={forced!r}: use one of {_RUNGS}")
            return forced
        if n_lanes < max(device_min(), 1) or self.device.type != "cuda":
            return "reference"
        return "device"

    # -- the table --------------------------------------------------------------

    @staticmethod
    def _column_sha(validators, n: int) -> bytes:
        return hashlib.sha256(np.ascontiguousarray(validators.pubkeys[:n]).tobytes()).digest()

    def _registry_matches(self, validators) -> bool:
        """True when the resident table is a prefix of this registry;
        remembered per registry object."""
        if self._table_rows == 0 or len(validators) < self._table_rows:
            return False
        if id(validators) in self._seen:
            return True
        ok = self._column_sha(validators, self._table_rows) == self._prefix_sha
        if ok:
            if len(self._seen) >= 4:
                self._seen.pop(next(iter(self._seen)))
            self._seen[id(validators)] = validators
        return ok

    def ensure_table(self, validators) -> None:
        """Make the table cover this registry: append the new rows when the
        prefix matches, rebuild otherwise.  A registry shorter than the
        table is a prefix already covered (append-only)."""
        n = len(validators)
        with self._lock:
            if self._registry_matches(validators) and self._table_rows >= n:
                return
            if 0 < n < self._table_rows:
                return
            if self._registry_matches(validators):
                start, (rows_x, rows_y) = self._table_rows, self._rows
            else:
                start, rows_x, rows_y = 0, None, None
            new_x, new_y = pubkey_kernels.mont_rows(self._decompress_rows(validators, start, n))
            if start:
                rows_x, rows_y = np.concatenate([rows_x, new_x]), np.concatenate([rows_y, new_y])
            else:
                rows_x, rows_y = new_x, new_y
            table = pubkey_kernels.table_from_rows(rows_x, rows_y, self.device)
            sha = self._column_sha(validators, n)
            self._table, self._table_rows, self._rows = table, n, (rows_x, rows_y)
            self._prefix_sha = sha
            self._seen = {id(validators): validators}
            self.refreshes["append" if start else "rebuild"] += 1

    @staticmethod
    def _decompress_rows(validators, start: int, n: int) -> list:
        """Affine points of registry rows [start, n): one native batched
        decompression and membership sweep over the interned keys.  A row
        that fails either raises, naming the row."""
        pks = [bls.PublicKey.interned(validators.pubkeys[i].tobytes()) for i in range(start, n)]
        bls.PublicKey.decompress_batch(pks)
        out = []
        for i, pk in enumerate(pks):
            try:
                out.append(pk.point)
            except (bls.BlsError, ValueError) as e:
                raise bls.BlsError(f"pubkey row {start + i}: {e}") from e
        return out

    # -- the fold ---------------------------------------------------------------

    def fold(self, validators, indices: np.ndarray, scalars: np.ndarray, groups: np.ndarray,
             n_groups: int) -> list:
        """Blinded committee-aggregate pubkeys: out[g] = Σ_{i: groups[i] == g}
        scalars[i]·pubkey(indices[i]) as affine int points, None for an
        identity aggregate (such a merged set can never verify)."""
        rung = self.resolve_rung(len(indices))
        self.folds[rung] += 1
        if rung == "device":
            return self._fold_device(validators, indices, scalars, groups, n_groups)
        return self._fold_host(validators, indices, scalars, groups, n_groups)

    def _fold_device(self, validators, indices, scalars, groups, n_groups: int) -> list:
        self.ensure_table(validators)
        with self._lock:
            table = self._table         # tables only grow: one read is consistent
        xa, ya, inf = pubkey_kernels.gather_fold(table, np.asarray(indices, np.int64),
                                                 np.asarray(scalars, np.uint64),
                                                 np.asarray(groups, np.int64), n_groups)
        xs, ys = bi.mont_limbs_to_ints(xa), bi.mont_limbs_to_ints(ya)
        return [None if inf[g] else (xs[g], ys[g]) for g in range(n_groups)]

    @staticmethod
    def _fold_host(validators, indices, scalars, groups, n_groups: int) -> list:
        """Reference rung: r₁·pk + r₂·pk = (r₁ + r₂)·pk per (group, pubkey),
        then one native segment MSM over the unique pairs."""
        sums: dict[tuple[int, bytes], int] = {}
        for i in range(len(indices)):
            key = (int(groups[i]), validators.pubkeys[int(indices[i])].tobytes())
            sums[key] = (sums.get(key, 0) + int(scalars[i])) % _R
        entries = [(g, pk, s) for (g, pk), s in sums.items() if s != 0]
        if not entries:
            return [None] * n_groups
        pks = [bls.PublicKey.interned(pk) for _g, pk, _s in entries]
        bls.PublicKey.decompress_batch(pks)
        return native_bls.g1_lincomb_groups([pk.point for pk in pks],
                                            [s for _g, _pk, s in entries],
                                            [g for g, _pk, _s in entries], n_groups)


_PLANE = PubkeyPlane()


def get_plane() -> PubkeyPlane:
    return _PLANE


def reset_pubkey_plane(device=None) -> PubkeyPlane:
    """A fresh plane (no table) on ``device``: tests, and a node that
    changes card."""
    global _PLANE
    _PLANE = PubkeyPlane(device)
    return _PLANE


def notify_registry(validators) -> None:
    """Registry write-back hook: refresh the table eagerly when the device
    rung is armed for a full batch."""
    plane = get_plane()
    if plane.resolve_rung(device_min()) == "device":
        plane.ensure_table(validators)
