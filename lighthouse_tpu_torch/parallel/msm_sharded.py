"""The pubkey fold's mesh rung: the gather fold's groups split over devices.

Port of ``lighthouse_tpu/parallel/msm_sharded.py``.  The gather fold
(``ops/pubkey_kernels.gather_fold``, row 11) sums r_i·pk[row_i] per group.
Here whole groups are dealt to the shards, contiguous ranges balanced by
lane count, so that each group's sum forms on one shard and no point is
added across shards; the resident table is copied once to each distinct
device of the mesh (and kept there while the table lives).  The affine sum
of a group is the JAX rung's, whichever device forms it: the sum commutes.
``chain/pubkey_plane.py`` picks this rung (``LHGPU_PUBKEY_BACKEND=sharded``,
or more than one card visible).
"""

from __future__ import annotations

import threading
import weakref
from typing import Sequence

import numpy as np
import torch

from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import msm, pubkey_kernels
from lighthouse_tpu_torch.parallel import mesh as pm

_REPLICA_LOCK = threading.Lock()
# id(tx) -> (weak reference to tx, {device: (tx, ty) there})
_REPLICAS: dict = {}


def msm_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` visible cards (all by default), rounded down
    to a power of two."""
    return pm.device_mesh(n_devices)


def _replica(table: tuple, device: torch.device) -> tuple:
    """The table (tx, ty) on ``device``: itself where it lies, else one
    copy per device, made once and dropped with the table."""
    tx, ty = table
    if tx.device == device:
        return table
    with _REPLICA_LOCK:
        ref, copies = _REPLICAS.get(id(tx), (None, None))
        if ref is None or ref() is not tx:
            copies = {}
            _REPLICAS[id(tx)] = (weakref.ref(tx), copies)
            weakref.finalize(tx, _REPLICAS.pop, id(tx), None)
        if device not in copies:
            copies[device] = (tx.to(device), ty.to(device))
        return copies[device]


def group_ranges(group_of_lane: np.ndarray, n_groups: int, n_shards: int
                 ) -> list[tuple[int, int]]:
    """Contiguous group ranges [g0, g1), one per shard, cut where the
    running lane count crosses each shard's equal share; a shard may get
    none."""
    cum = np.cumsum(np.bincount(group_of_lane, minlength=n_groups))
    total = int(cum[-1]) if n_groups else 0
    cuts = [0] + [min(int(np.searchsorted(cum, total * (k + 1) / n_shards, "left")) + 1,
                      n_groups) for k in range(n_shards - 1)] + [n_groups]
    cuts = list(np.maximum.accumulate(cuts))
    return list(zip(cuts[:-1], cuts[1:]))


def gather_fold_sharded(table, row_of_lane: np.ndarray, scalars: np.ndarray,
                        group_of_lane: np.ndarray, n_groups: int, mesh: Sequence | None = None):
    """``ops/pubkey_kernels.gather_fold`` with the groups split over
    ``mesh`` (default ``msm_mesh()``): the same contract, (xa, ya uint32
    [G, 12] affine Montgomery words, inf bool[G]) on the host, every shard
    launched before any output is fetched."""
    mesh = msm_mesh() if mesh is None else pm.check_mesh(mesh)
    row_of_lane = np.asarray(row_of_lane, np.int64)
    scalars = np.asarray(scalars, np.uint64)
    group_of_lane = np.asarray(group_of_lane, np.int64)
    if len(row_of_lane) == 0 or n_groups == 0:
        return (np.zeros((0, bi.L), np.uint32), np.zeros((0, bi.L), np.uint32),
                np.zeros(0, bool))
    launched = []
    for (g0, g1), d in zip(group_ranges(group_of_lane, n_groups, len(mesh)), mesh):
        if g0 == g1:
            continue
        sel = (group_of_lane >= g0) & (group_of_lane < g1)
        if not sel.any():       # groups without lanes: identities, as the kernel gives
            launched.append((g1 - g0, None))
            continue
        tx, ty = _replica(table, d)
        lane_idx, digits, g_pad = pubkey_kernels.lane_layout(
            row_of_lane[sel], scalars[sel], group_of_lane[sel] - g0, g1 - g0)
        launched.append((g1 - g0, msm.gather_fold_device(
            tx, ty, torch.from_numpy(lane_idx).to(d), torch.from_numpy(digits).to(d), g_pad)))
    xs, ys, infs = [], [], []
    for g, out in launched:
        if out is None:
            xs.append(np.zeros((g, bi.L), np.uint32))
            ys.append(np.zeros((g, bi.L), np.uint32))
            infs.append(np.ones(g, bool))
        else:
            xs.append(bi.to_numpy(out[0][:g]))
            ys.append(bi.to_numpy(out[1][:g]))
            infs.append(out[2][:g].cpu().numpy())
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(infs)


__all__ = ["gather_fold_sharded", "group_ranges", "msm_mesh"]
