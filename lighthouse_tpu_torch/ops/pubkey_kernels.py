"""The registry's pubkey table on the card and the host lane layout of the
gather fold (row 11).

Port of ``lighthouse_tpu/ops/pubkey_kernels.py``: the table is the
registry's affine pubkeys as Montgomery words, resident on the card and
padded to a power of two (the padding rows repeat row 0 and are never
named); ``gather_fold`` lays the lanes out s-major over (segment, group) by
a group-wise cumcount and launches ``msm.gather_fold_device``, which reads
each lane's row straight from the table.

Soundness of the Jacobian tree with repeated validators: every lane is
r_i·P_i with an independent random 64-bit r_i, so an H == 0 chord between
tree nodes needs a relation over the r_i (probability about 2^-64).  Zero
scalar padding lanes are the identity.  An identity GROUP (cancelling keys)
is reported in the flag row, never returned as a point.
"""

from __future__ import annotations

import numpy as np
import torch

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import ec, msm


def mont_rows(points) -> tuple[np.ndarray, np.ndarray]:
    """Affine G1 int points -> host Montgomery word rows (x, y) uint32[n, 12]:
    the per-row half of ``build_table``, so the plane converts only rows
    appended to the registry."""
    return (bi.ints_to_mont_limbs([p[0] for p in points]),
            bi.ints_to_mont_limbs([p[1] for p in points]))


def table_from_rows(rows_x: np.ndarray, rows_y: np.ndarray, device=None) -> tuple:
    """Host word rows -> the resident table (tx, ty) int32 [T, 12] on
    ``device`` (``cuda`` unless ``"cpu"``), T the next power of two."""
    dev = resolve_device(device)
    n = len(rows_x)
    if n == 0:
        rows_x, rows_y = mont_rows([(1, 2)])
        n = 1
    t_pad = msm.bucket(n)
    if t_pad > n:
        rows_x = np.concatenate([rows_x, np.repeat(rows_x[:1], t_pad - n, 0)])
        rows_y = np.concatenate([rows_y, np.repeat(rows_y[:1], t_pad - n, 0)])
    return bi.to_tensor(rows_x, dev), bi.to_tensor(rows_y, dev)


def build_table(points, device=None) -> tuple:
    """Affine G1 int points -> the resident table (``mont_rows`` then
    ``table_from_rows``)."""
    return table_from_rows(*mont_rows(points), device=device)


def lane_layout(row_of_lane: np.ndarray, scalars: np.ndarray, group_of_lane: np.ndarray,
                n_groups: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(lane_idx int32[seg·g_pad], digits int32[16, seg·g_pad], g_pad): lane
    s·g_pad + g holds the s-th lane of group g in arrival order (a
    group-wise cumcount, no per-lane Python); empty lanes carry scalar 0."""
    n = len(row_of_lane)
    counts = np.bincount(group_of_lane, minlength=n_groups)
    seg = msm.bucket(int(counts.max()))
    g_pad = msm.bucket(n_groups, floor=2)
    order = np.argsort(group_of_lane, kind="stable")
    offsets = np.zeros(n_groups, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n, dtype=np.int64) - np.repeat(offsets, counts)
    lanes = rank * g_pad + group_of_lane
    lane_idx = np.zeros(seg * g_pad, np.int32)
    lane_scalars = np.zeros(seg * g_pad, np.uint64)
    lane_idx[lanes] = row_of_lane
    lane_scalars[lanes] = scalars
    return lane_idx, ec.scalars_to_digits(lane_scalars.tolist()).astype(np.int32), g_pad


def gather_fold(table, row_of_lane: np.ndarray, scalars: np.ndarray, group_of_lane: np.ndarray,
                n_groups: int):
    """Σ r_i·pk[row_i] per group -> (xa, ya uint32[G, 12] affine Montgomery
    words, inf bool[G]) on the host, computed on the table's device."""
    n = len(row_of_lane)
    if n == 0 or n_groups == 0:
        return (np.zeros((0, bi.L), np.uint32), np.zeros((0, bi.L), np.uint32),
                np.zeros(0, bool))
    tx, ty = table
    lane_idx, digits, g_pad = lane_layout(np.asarray(row_of_lane, np.int64),
                                          np.asarray(scalars, np.uint64),
                                          np.asarray(group_of_lane, np.int64), n_groups)
    xa, ya, inf = msm.gather_fold_device(tx, ty, torch.from_numpy(lane_idx).to(tx.device),
                                         torch.from_numpy(digits).to(tx.device), g_pad)
    return (bi.to_numpy(xa[:n_groups]), bi.to_numpy(ya[:n_groups]),
            inf[:n_groups].cpu().numpy())
