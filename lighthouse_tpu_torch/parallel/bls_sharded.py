"""Multi-device BLS batch verification: the pair lanes over a device mesh.

Port of ``lighthouse_tpu/parallel/bls_sharded.py``.  Batch verification is
data parallel over the pairs: each shard runs the Miller loops of its slice
of the lanes and multiplies them down to one Fq12 partial on its own
device; the n_dev partials are gathered on ``mesh[0]`` and multiplied
there; the one final exponentiation runs on the host, once per batch.

``sharded_miller_reduce`` is the port of ``_sharded_miller_reduce``
(``lighthouse_tpu/parallel/bls_sharded.py:39``, jitted at :63-67; row 19):
per shard ``ops/bls12_381.miller_reduce_device`` (``lh_miller`` and the
``lh_fq12_mul_halves`` tree, row 10), the gather as a device copy
(``parallel/mesh.gather``), then the same ``lh_fq12_mul_halves`` tree over
the partials.  ``sharded_miller_reduce_plain`` is its plain version over the
same mesh logic.  A mesh is a list of torch devices (``parallel/mesh.py``);
its size must be a power of two, as the JAX package asserts.

The host prep is the JAX package's: ``ops/bls_backend.prepare_pairs``
(pure-Python curve arithmetic, each signature's subgroup check with its
decompression), ``_dispatch_chunk``'s padding, and the chunk plan of
``ops/dispatch_pipeline`` with the chunk partials multiplied on
``mesh[0]``.  A shard's fault raises out of the backend, for the
supervisor (``crypto/bls/api.py``) to recover; the fault sites of
``ops/faults.py`` are the JAX package's: ``chunk`` before each chunk
(:138) and ``sharded`` at the entry (:180).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_cuda, native_bls
from lighthouse_tpu_torch.ops import dispatch_pipeline as dp
from lighthouse_tpu_torch.ops import faults
from lighthouse_tpu_torch.ops.bls_backend import prepare_pairs
from lighthouse_tpu_torch.parallel import mesh as pm


def check_bls_mesh(mesh: Sequence) -> list[torch.device]:
    """The mesh, checked (``mesh.check_mesh``) and of a power-of-two size."""
    mesh = pm.check_mesh(mesh)
    n = len(mesh)
    if n & (n - 1):
        raise ValueError(f"a BLS mesh's size must be a power of two, got {n}")
    return mesh


def fq12_tree_plain(f: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``lh_fq12_mul_halves`` tree: Fq12 rows int32
    [n, 12, 12] (n a power of two), row i times row i + n/2 per level ->
    their product [1, 12, 12]."""
    while f.shape[0] > 1:
        half = f.shape[0] // 2
        f = dp.fq12_mul_plain(f[:half].contiguous(), f[half:].contiguous())
    return f.clone()


def _fq12_tree(f: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The product of the rows f [n, 12, 12] (n a power of two) on their
    device: one ``lh_fq12_mul_halves`` launch per level, in place on a copy
    -> (product [1, 12, 12], launches)."""
    if f.device.type == "cpu":
        return fq12_tree_plain(f), 0
    f = f.contiguous().clone()
    launches = 0
    half = f.shape[0] // 2
    while half >= 1:
        bls_cuda.launch("lh_fq12_mul_halves", f, half)
        launches += 1
        half //= 2
    return f[:1].clone(), launches


def _place(cols, mask, mesh) -> list[tuple]:
    """``P("data")`` of the four point columns and the mask: per shard
    (xp, yp, xq, yq, mask) on its device."""
    parts = [pm.split(c, mesh) for c in (*cols, mask)]
    return list(zip(*parts))


def _check_lanes(cols, mask, mesh) -> None:
    n = int(mask.shape[0])
    if n % len(mesh) or (n // len(mesh)) & (n // len(mesh) - 1) or n == 0:
        raise ValueError(f"sharded_miller_reduce: {n} lanes over {len(mesh)} shards: each "
                         "shard must hold a power of two")
    if any(c.shape[0] != n for c in cols):
        raise ValueError("sharded_miller_reduce: columns and mask differ in length")


def _reduce_placed(shards: list[tuple], mesh: list[torch.device]) -> torch.Tensor:
    """Row 19 on placed shards: each shard's Miller product on its device,
    the gather onto ``mesh[0]``, the product of the partials there."""
    before = t12.miller_reduce_device.launches
    parts = [t12.miller_reduce_device(*s) for s in shards]
    f, top = _fq12_tree(pm.gather(parts, mesh))
    if mesh[0].type == "cuda":
        sharded_miller_reduce.launches += t12.miller_reduce_device.launches - before + top
        sharded_miller_reduce.calls += 1
    return f


def sharded_miller_reduce(cols, mask, mesh: Sequence) -> torch.Tensor:
    """Π over lanes of miller(P_i, Q_i), masked lanes (mask False) one, the
    lanes split over ``mesh``: ``cols`` = (xp, yp [n, 12], xq, yq [n, 2, 12])
    int32 Montgomery words, mask bool [n], each shard a power of two of
    lanes -> Fq12 row [1, 12, 12] on ``mesh[0]``.  A shard whose lanes are
    all masked gives one.  Replaces
    ``lighthouse_tpu/parallel/bls_sharded.py:39`` ``_sharded_miller_reduce``
    (row 19).  On a mesh of the CPU each shard runs the plain version."""
    mesh = check_bls_mesh(mesh)
    _check_lanes(cols, mask, mesh)
    return _reduce_placed(_place(cols, mask, mesh), mesh)


sharded_miller_reduce.launches = 0
sharded_miller_reduce.calls = 0


def sharded_miller_reduce_plain(cols, mask, mesh: Sequence) -> torch.Tensor:
    """Plain version of ``sharded_miller_reduce``: the same placement,
    ``miller_reduce_plain`` per shard, the gather and ``fq12_tree_plain``."""
    mesh = check_bls_mesh(mesh)
    _check_lanes(cols, mask, mesh)
    parts = [t12.miller_reduce_plain(*s) for s in _place(cols, mask, mesh)]
    return fq12_tree_plain(pm.gather(parts, mesh))


def lane_columns(pairs, n_dev: int):
    """``_dispatch_chunk``'s host layout: ``points_to_device`` of the pairs,
    padded so that each of ``n_dev`` shards holds a power of two of lanes
    (the last lane tiled, its mask False) -> ((xp, yp, xq, yq) int32
    tensors, mask bool tensor), on the host."""
    xp, yp, xq, yq, mask = t12.points_to_device(pairs)
    n = len(pairs)
    per_dev = 1 << max((n + n_dev - 1) // n_dev - 1, 0).bit_length()
    padded = per_dev * n_dev
    cols = [xp, yp, xq, yq]
    if padded != n:
        cols = [np.concatenate([c, np.tile(c[-1:], (padded - n,) + (1,) * (c.ndim - 1))])
                for c in cols]
        mask = np.concatenate([mask, np.zeros(padded - n, bool)])
    return tuple(bi.to_tensor(c, "cpu") for c in cols), torch.from_numpy(mask)


def _dispatch_chunk(pairs, mesh, stage: dict) -> torch.Tensor:
    """Prep, copies to the shards and launches for one chunk of pairs ->
    its Fq12 partial on ``mesh[0]`` (not synchronized)."""
    t0 = time.perf_counter()
    cols, mask = lane_columns(pairs, len(mesh))
    t1 = time.perf_counter()
    shards = _place(cols, mask, mesh)
    t2 = time.perf_counter()
    stage["prep_host"] += t1 - t0
    stage["h2d"] += t2 - t1
    return _reduce_placed(shards, mesh)


def multi_pairing_sharded(pairs, mesh: Sequence, chunk_size: int | None = None,
                          ledger: dict | None = None):
    """Π e(P_i, Q_i) as a python Fq12 after the final exponentiation, the
    Miller loops sharded over ``mesh``.  Pair sets above the chunk size
    (``chunk_size`` > LHGPU_BLS_CHUNK > the default) run as power-of-two
    chunks whose partials multiply on ``mesh[0]`` (``lh_fq12_mul``, row 7);
    the batch pays one copy to the host and one native final
    exponentiation.  With ``ledger``, the stage seconds prep_host, h2d,
    kernel (up to the synchronized product), d2h and final_exp are added
    to it."""
    mesh = check_bls_mesh(mesh)
    stage = {"prep_host": 0.0, "h2d": 0.0}
    partials = []
    for ci, (lo, hi) in enumerate(dp.plan_chunks(len(pairs), dp.chunk_size(chunk_size))):
        faults.fire("chunk", index=ci)
        partials.append(_dispatch_chunk(pairs[lo:hi], mesh, stage))
    t0 = time.perf_counter()
    f = dp.combine_partials(partials)
    pm.synchronize(mesh)
    t1 = time.perf_counter()
    f_host = dp.fq12_row_to_host(f)
    t2 = time.perf_counter()
    out = native_bls.final_exp(f_host)
    stage.update(kernel=t1 - t0, d2h=t2 - t1, final_exp=time.perf_counter() - t2)
    if ledger is not None:
        for k, v in stage.items():
            ledger[k] = ledger.get(k, 0.0) + v
    return out


def verify_signature_sets_sharded(sets: Sequence[api.SignatureSet], *,
                                  n_devices: int | None = None, mesh: Sequence | None = None,
                                  chunk_size: int | None = None, device=None,
                                  ledger: dict | None = None) -> bool:
    """The ``sharded`` backend: batch-verify signature sets with the Miller
    lanes split over a mesh.  ``mesh`` if given; else ``device`` named
    ``n_devices`` times (``"cpu"``: the plain versions); else the first
    ``n_devices`` visible cards (all by default, a power of two).  Same
    verdicts as the ``cuda`` backend: the same batch equation, other lane
    placement.  ``ledger`` adds the stage seconds (``multi_pairing_sharded``)
    and ``prepare_pairs``."""
    if mesh is None:
        mesh = ([resolve_device(device)] * (n_devices or 1) if device is not None
                else pm.device_mesh(n_devices))
    mesh = check_bls_mesh(mesh)
    if not sets:
        return False
    if faults.fire("sharded") == "corrupt":
        return faults.corrupt_verdict()
    t0 = time.perf_counter()
    pairs = prepare_pairs(sets)
    if ledger is not None:
        ledger["prepare_pairs"] = ledger.get("prepare_pairs", 0.0) + time.perf_counter() - t0
    if pairs is None:
        return False
    return multi_pairing_sharded(pairs, mesh, chunk_size, ledger).is_one()


api.register_backend("sharded", verify_signature_sets_sharded)
