"""The fused epoch pass with the registry rows split over a device mesh.

Port of ``lighthouse_tpu/parallel/epoch_sharded.py``.  The pass is pure
lane parallelism: each validator's update reads only its own columns and
small gather tables.  So the rows split into contiguous slices, one per
shard, the tables and params are copied once to each distinct device, each
shard runs ``ops/epoch_kernels.fused_epoch_pass`` (row 17) on its slice,
and the outputs come back to the host in shard order; nothing crosses
between shards.  The port's pass runs exactly n lanes (no power-of-two
bucket), so when the mesh does not divide n the last shard takes what
remains.  ``state_transition/epoch_device.epoch_backend`` picks this rung
(``LHGPU_EPOCH_BACKEND=sharded``, or more than one card visible).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lighthouse_tpu_torch.ops import epoch_kernels as ek
from lighthouse_tpu_torch.parallel import mesh as pm
from lighthouse_tpu_torch.state_transition.epoch_device import COLUMNS


def epoch_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` visible cards (all by default), rounded down
    to a power of two."""
    return pm.device_mesh(n_devices)


def epoch_pass_sharded(columns: dict, tables: dict, params: np.ndarray, *,
                       mesh: Sequence | None = None
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``epoch_device.epoch_pass`` with the rows split over ``mesh``
    (default ``epoch_mesh()``): host columns, tables and params in, host
    int64 (scores, balances, effective balances) out, every shard launched
    before any output is fetched."""
    mesh = epoch_mesh() if mesh is None else pm.check_mesh(mesh)
    n = columns["balances"].shape[0]
    shared = [pm.replicate(torch.from_numpy(a), mesh)
              for a in (tables["reward"], tables["penalty"], tables["slash"], params)]
    outs = []
    for (lo, hi), d in zip(pm.bounds(n, len(mesh)), mesh):
        ins = [torch.from_numpy(columns[c][lo:hi]).to(d) for c in COLUMNS]
        outs.append(ek.fused_epoch_pass(*ins, *(r[d] for r in shared)))
    return tuple(np.concatenate([o[k].cpu().numpy() for o in outs]) for k in range(3))
