"""Multi-device dry run: the sharded merkle fold and the sharded BLS batch
verify over a mesh, each checked against the host.

Port of ``lighthouse_tpu/parallel/dryrun_worker.py``:

- ``sharded_fold_to_root`` (row 20, ``_merkle_dryrun`` at
  ``lighthouse_tpu/parallel/dryrun_worker.py:40``, jitted at :78): each
  shard folds its block of leaves to a subroot with
  ``ops/sha256.fold_to_root_device`` (``k_fold_subtrees``, row 3), the
  subroots are gathered on ``mesh[0]``, zero-padded to a power of two and
  folded there, so any mesh size works; ``sharded_fold_to_root_plain`` is
  its plain version over the same mesh logic;
- ``merkle_dryrun``: the JAX package's leaves (64 a shard, ``arange``
  words) through ``sharded_fold_to_root``, held to hashlib;
- ``bls_dryrun``: one signature set a shard through the ``sharded``
  backend, valid and with one wrong key.

Run as ``python -m lighthouse_tpu_torch.parallel.dryrun_worker N [--device
cuda|cpu]``: both in this process over a mesh of N entries, the visible
cards named in turn (a mesh longer than the cards repeats them) or the CPU
N times.  The JAX package spawns a child only to get an interpreter with N
virtual devices; a mesh of torch devices needs none.  The BLS part needs N a
power of two, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Sequence

import numpy as np
import torch

from lighthouse_tpu_torch.ops import sha256 as sha
from lighthouse_tpu_torch.parallel import mesh as pm

LEAVES_PER_SHARD = 64


def _top(subroots: torch.Tensor) -> torch.Tensor:
    """The gathered subroots [n_dev, 8], zero rows appended up to a power
    of two."""
    n = subroots.shape[0]
    top_n = 1 << max(n - 1, 0).bit_length()
    if top_n == n:
        return subroots
    pad = subroots.new_zeros((top_n - n, 8))
    return torch.cat([subroots, pad])


def _blocks(leaves: torch.Tensor, mesh: list[torch.device]) -> list[torch.Tensor]:
    n = leaves.shape[0]
    per = n // len(mesh)
    if n % len(mesh) or per < 1 or per & (per - 1):
        raise ValueError(f"{n} leaves over {len(mesh)} shards: each shard must hold a "
                         "power of two")
    return pm.split(leaves, mesh)


def sharded_fold_to_root(leaves: torch.Tensor, mesh: Sequence) -> torch.Tensor:
    """Merkle root of int32 word leaves [n_dev·b, 8] (b a power of two)
    split over ``mesh``: each shard's block folded on its device, the
    subroots zero-padded to a power of two and folded on ``mesh[0]`` ->
    [1, 8] on ``mesh[0]``.  Replaces
    ``lighthouse_tpu/parallel/dryrun_worker.py:40`` ``_merkle_dryrun``'s
    program (row 20).  On a mesh of the CPU each fold runs the plain
    version."""
    mesh = pm.check_mesh(mesh)
    before = sha.fold_to_root_device.launches
    subroots = [sha.fold_to_root_device(b) for b in _blocks(leaves, mesh)]
    root = sha.fold_to_root_device(_top(pm.gather(subroots, mesh)))
    if mesh[0].type == "cuda":
        sharded_fold_to_root.launches += sha.fold_to_root_device.launches - before
        sharded_fold_to_root.calls += 1
    return root


sharded_fold_to_root.launches = 0
sharded_fold_to_root.calls = 0


def sharded_fold_to_root_plain(leaves: torch.Tensor, mesh: Sequence) -> torch.Tensor:
    """Plain version of ``sharded_fold_to_root``: the same placement and
    padding, ``fold_to_root_plain`` per shard and at the top."""
    mesh = pm.check_mesh(mesh)
    subroots = [sha.fold_to_root_plain(b) for b in _blocks(leaves, mesh)]
    return sha.fold_to_root_plain(_top(pm.gather(subroots, mesh)))


def host_root(leaves: np.ndarray, n_shards: int) -> np.ndarray:
    """The same root with hashlib: each block's tree, then the zero-padded
    top tree -> uint32 [1, 8]."""
    top_n = 1 << max(n_shards - 1, 0).bit_length()
    lvl = np.asarray(leaves, np.uint32)
    while lvl.shape[0] > n_shards:
        lvl = sha.hash_pairs_np(lvl.reshape(lvl.shape[0] // 2, 16))
    tops = np.zeros((top_n, 8), np.uint32)
    tops[:lvl.shape[0]] = lvl
    while tops.shape[0] > 1:
        tops = sha.hash_pairs_np(tops.reshape(tops.shape[0] // 2, 16))
    return tops


def merkle_dryrun(mesh: Sequence, leaves: np.ndarray | None = None) -> np.ndarray:
    """``sharded_fold_to_root`` over ``mesh`` (default leaves: the JAX
    package's, 64 a shard of ``arange`` words), held to ``host_root``; a
    mismatch raises.  Returns the root, uint32 [1, 8]."""
    mesh = pm.check_mesh(mesh)
    if leaves is None:
        n = len(mesh) * LEAVES_PER_SHARD
        leaves = np.arange(n * 8, dtype=np.uint32).reshape(n, 8)
    root = sha.to_numpy(sharded_fold_to_root(sha.to_tensor(leaves, mesh[0]), mesh))
    want = host_root(leaves, len(mesh))
    if not np.array_equal(root, want):
        raise RuntimeError(f"sharded merkle root {root[0].tolist()} != host root "
                           f"{want[0].tolist()} over a mesh of {len(mesh)}")
    return root


def bls_dryrun(mesh: Sequence) -> None:
    """One signature set a shard through ``verify_signature_sets_sharded``:
    valid sets must verify, and the batch with one signature by another
    key must not (raises otherwise)."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.parallel.bls_sharded import verify_signature_sets_sharded

    sks = [bls.SecretKey.from_bytes(bytes([0] * 31 + [i + 1])) for i in range(len(mesh))]
    msg = b"m" * 32
    sets = [bls.SignatureSet(sk.sign(msg), [sk.public_key()], msg) for sk in sks]
    if not verify_signature_sets_sharded(sets, mesh=mesh):
        raise RuntimeError("sharded BLS batch verify rejected valid sets")
    other = bls.SecretKey.from_bytes(bytes([0] * 31 + [len(mesh) + 1]))
    bad = [bls.SignatureSet(other.sign(msg), sets[0].pubkeys, msg)] + sets[1:]
    if verify_signature_sets_sharded(bad, mesh=mesh):
        raise RuntimeError("sharded BLS batch verify accepted an invalid set")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The merkle and BLS dry runs over ``mesh.round_robin(n_devices,
    device)`` -> {"mesh", "root", "seconds"}."""
    t0 = time.perf_counter()
    mesh = pm.round_robin(n_devices, device)
    root = merkle_dryrun(mesh)
    bls_dryrun(mesh)
    return {"mesh": [str(d) for d in mesh],
            "root": sha.words_to_bytes(root[0]).hex(),
            "seconds": time.perf_counter() - t0}


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.n_devices, torch.device(args.device))
    print(f"mesh of {args.n_devices}: {out['mesh']}")
    print(json.dumps({"ok": True, "n_devices": args.n_devices, "root": out["root"],
                      "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
