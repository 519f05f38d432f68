#!/usr/bin/env python3
"""Time chosen rows of the kernel table (``PERF.md`` §6) in two checkouts
of the port on one card, in turns.

    python3 chip_ab.py OLD_TREE NEW_TREE [--rows 3,8,12,15,16,18,20]

Each tree is the root of a checkout (``git archive`` of a commit unpacked
anywhere); its ``lighthouse_tpu_torch`` is imported and built in a process
of its own, in the order OLD, NEW, NEW, OLD, so that both are measured on
the same card and a drift shows as a difference between a tree's two
runs.  Each run prints one JSON line: the card's name and power limit, and
CUDA-event means at the main path's shapes (``chip_smoke.py``'s seeds):

- row 8 at the block batch (131 sets, 262,144 lanes in 256 segments): the
  whole call, its launches a call, and each launch timed alone (a tree
  launch by its half, then the final launch);
- row 15 at 768 blobs of width 4096 (one challenge on the domain) and at
  1, 132 and 264 blobs: one blob is one block's critical path, 264 fill
  two blocks an SM once;
- row 12 over the 4,096 points of ``KzgSettings.dev(4096)`` (the
  trusted-setup load's lanes);
- row 3 at 2^12, 2^16 and 2^20 random leaves (also its device time alone,
  the calls queued behind a spin kernel);
- row 20 over a mesh naming the card 4 times, at 2^20 random leaves and at
  the JAX package's dry-run shape (64 leaves a shard);
- row 16 at the 768-blob batch's 768 x 4096 elements (also its device time
  alone, behind a spin kernel);
- row 18 at the new epoch's 944,080 positions of ``chip_smoke.py``'s
  2^20-validator state, at 2^20, 2^21 and its 2^22 capacity (90 rounds,
  random pivots and decision bytes; also its device time alone).

Every kernel is first held to its plain version (tolerance 0; row 12 also
on a point outside G1, both points of order 3 and a point off the curve,
row 3 also to hashlib).  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

BLS_SEED = 20240314          # chip_smoke.py's block batch
KZG_SEED = 11                # chip_smoke.py's 768-blob batch
KZG_WIDTH = 4096
KZG_BLOBS = 768
SHA_SEED = 20240313          # chip_smoke.py's SEED
EPOCH_SEED = 20240315        # chip_smoke.py's epoch seed
SHUFFLE_COUNTS = (944_080, 1 << 20, 1 << 21, 1 << 22)
SHUFFLE_ROUNDS = 90
ROWS = (3, 8, 12, 15, 16, 18, 20)


def one(tree: str, rows: tuple) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import lighthouse_tpu_torch
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls_backend as bb
    from lighthouse_tpu_torch.ops import bls_cuda, fr, msm

    if not lighthouse_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {lighthouse_tpu_torch.__file__}, not the tree {root}")
    dev = torch.device("cuda")

    def ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": tree}
    if 8 in rows:
        out.update(row8(torch, np, T, bi, bb, bls_cuda, msm, dev, ms))
    if 15 in rows:
        out.update(row15(torch, np, kzg, bi, fr, dev, ms))
    if 12 in rows:
        out.update(row12(torch, T, kzg, bb, dev, ms))
    if 3 in rows or 20 in rows:
        out.update(rows_3_20(torch, np, rows, dev, ms))
    if 16 in rows:
        out.update(row16(torch, np, fr, dev, ms))
    if 18 in rows:
        out.update(row18(torch, np, dev, ms))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip()
    return out


def row8(torch, np, T, bi, bb, bls_cuda, msm, dev, ms) -> dict:
    out = {}
    X, Y, Z, ux, uy, n_seg = bb.fold_lanes(T.block_signature_sets(BLS_SEED))
    args = [bi.to_tensor(a, dev) for a in (X, Y, Z, ux, uy)]
    got, want = msm.blinded_fold_device(*args, n_seg), msm.blinded_fold_plain(*args, n_seg)
    if not all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)):
        raise SystemExit("row 8 disagrees with its plain version")
    before = msm.blinded_fold_device.launches
    out["row8_ms"] = ms(lambda: msm.blinded_fold_device(*args, n_seg), 20)
    out["row8_launches_a_call"] = (msm.blinded_fold_device.launches - before) / 21
    # the tree's launch plan: a checkout without blinded_fold_plan ran the
    # tree down to one row a segment and took no row count in its final launch
    total = X.shape[0]
    if hasattr(msm, "blinded_fold_plan"):
        halves, rows = msm.blinded_fold_plan(total, n_seg)
        final = (n_seg, rows)
    else:
        halves = [total >> k for k in range(1, (total // n_seg).bit_length())]
        final = (n_seg,)
    split = np.zeros(len(halves) + 1)
    for rep in range(21):
        Xc, Yc, Zc = (a.clone() for a in args[:3])
        xa = torch.empty((n_seg, 12), dtype=torch.int32, device=dev)
        ya = torch.empty_like(xa)
        inf = torch.empty(n_seg, dtype=torch.uint8, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(halves) + 2)]
        torch.cuda.synchronize()
        ev[0].record()
        for k, half in enumerate(halves):
            bls_cuda.launch("lh_g1_add_halves", Xc, Yc, Zc, half)
            ev[k + 1].record()
        bls_cuda.launch("lh_blinded_final", Xc, Yc, Zc, args[3], args[4], xa, ya, inf, *final)
        ev[-1].record()
        torch.cuda.synchronize()
        if rep:
            split += [ev[k].elapsed_time(ev[k + 1]) for k in range(len(ev) - 1)]
    out["row8_split_ms"] = dict(zip([f"half {h}" for h in halves] + ["final"],
                                    (split / 20).tolist()))
    return out


def row15(torch, np, kzg, bi, fr, dev, ms) -> dict:
    R = fr.R_INT
    rng = np.random.default_rng(KZG_SEED)
    n, w = KZG_BLOBS, KZG_WIDTH
    raw = rng.integers(0, 256, (n, w, 32), dtype=np.uint8)
    raw[..., 0] &= 0x3F
    roots = kzg._bit_reversal_permutation(kzg._compute_roots_of_unity(w))
    zs = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    zs[5] = roots[77 % w]
    f_m = fr.fr_to_mont_device(torch.from_numpy(raw).to(dev))
    z_t = bi.to_tensor(fr.to_mont_host(zs), dev)
    roots_t = bi.to_tensor(fr.to_mont_host(roots), dev)
    invw_t = bi.to_tensor(fr.to_mont_host([pow(w, -1, R)]), dev)
    if not torch.equal(fr.eval_device(f_m, z_t, roots_t, invw_t).cpu(),
                       fr.eval_plain(f_m, z_t, roots_t, invw_t).cpu()):
        raise SystemExit("row 15 disagrees with its plain version")
    return {"row15_ms": {str(k): ms(lambda: fr.eval_device(f_m[:k], z_t[:k], roots_t, invw_t),
                                    10) for k in (n, 1, 132, 264)}}


def row16(torch, np, fr, dev, ms) -> dict:
    rng = np.random.default_rng(KZG_SEED)
    raw = rng.integers(0, 256, (KZG_BLOBS, KZG_WIDTH, 32), dtype=np.uint8)
    raw[..., 0] &= 0x3F
    raw_t = torch.from_numpy(raw).to(dev)
    if not torch.equal(fr.fr_to_mont_device(raw_t), fr.fr_to_mont_plain(raw_t)):
        raise SystemExit("row 16 disagrees with its plain version")
    return {"row16_ms": ms(lambda: fr.fr_to_mont_device(raw_t), 50),
            "row16_device_ms": device_ms(torch, lambda: fr.fr_to_mont_device(raw_t), 50)}


def row18(torch, np, dev, ms) -> dict:
    from lighthouse_tpu_torch.ops import epoch_kernels as ek

    rng = np.random.default_rng(EPOCH_SEED)
    out = {"row18_ms": {}, "row18_device_ms": {}}
    for count in SHUFFLE_COUNTS:
        row_bytes = (count + 255) // 256 * 32
        src = torch.from_numpy(rng.integers(0, 256, (SHUFFLE_ROUNDS, row_bytes),
                                            dtype=np.uint8)).to(dev)
        piv = torch.from_numpy(rng.integers(0, count, SHUFFLE_ROUNDS).astype(np.int32)).to(dev)
        if not torch.equal(ek.shuffle_rounds(piv, src, count),
                           ek.shuffle_rounds_plain(piv, src, count)):
            raise SystemExit(f"row 18 disagrees with its plain version at {count} positions")
        out["row18_ms"][str(count)] = ms(lambda: ek.shuffle_rounds(piv, src, count), 20)
        out["row18_device_ms"][str(count)] = device_ms(
            torch, lambda: ek.shuffle_rounds(piv, src, count), 20)
    return out


def row12(torch, T, kzg, bb, dev, ms) -> dict:
    from lighthouse_tpu_torch.crypto.bls import curve as cv
    from lighthouse_tpu_torch.ops import ec

    settings = kzg.KzgSettings.dev(KZG_WIDTH, device=dev)
    pts = list(settings.g1_lagrange_brp)
    edges = [T.non_g1_point(3), T.ORDER3_G1, cv.g1_neg(T.ORDER3_G1), (5, 7)]
    xp, yp = ec.g1_words(edges + pts[len(edges):], dev)
    got, want = bb.g1_subgroup_device(xp, yp), bb.g1_subgroup_plain(xp, yp)
    if not torch.equal(got.cpu(), want.cpu()) or got[:4].any() or not got[4:].all():
        raise SystemExit("row 12 disagrees with its plain version or reads a wrong verdict")
    xp, yp = ec.g1_words(pts, dev)
    return {"row12_ms": ms(lambda: bb.g1_subgroup_device(xp, yp), 10)}


def rows_3_20(torch, np, rows, dev, ms) -> dict:
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.parallel import dryrun_worker as dw

    rng = np.random.default_rng(SHA_SEED)
    words = rng.integers(0, 2**32, (1 << 20, 8), dtype=np.uint64).astype(np.uint32)
    leaves = {k: sha.to_tensor(words[:1 << k], dev) for k in (12, 16, 20)}
    out = {}
    if 3 in rows:
        for k, x in leaves.items():
            got = sha.fold_to_root_device(x)
            if not torch.equal(got, sha.fold_to_root_plain(x)):
                raise SystemExit(f"row 3 disagrees with its plain version at 2^{k} leaves")
        if not np.array_equal(sha.to_numpy(got), dw.host_root(words, 1)):
            raise SystemExit("row 3 disagrees with hashlib at 2^20 leaves")
        out["row3_ms"] = {f"2^{k}": ms(lambda: sha.fold_to_root_device(x), 20)
                          for k, x in leaves.items()}
        out["row3_device_ms"] = {f"2^{k}": device_ms(torch, lambda: sha.fold_to_root_device(x),
                                                     20) for k, x in leaves.items()}
    if 20 in rows:
        mesh = [dev] * 4
        out["row20_ms"] = {}
        for label, x in (("2^20", leaves[20]), ("256", leaves[12][:256])):
            if not torch.equal(dw.sharded_fold_to_root(x, mesh),
                               dw.sharded_fold_to_root_plain(x, mesh)):
                raise SystemExit(f"row 20 disagrees with its plain version at {label} leaves")
            out["row20_ms"][label] = ms(lambda: dw.sharded_fold_to_root(x, mesh), 20)
    return out


def device_ms(torch, fn, reps: int) -> float:
    """CUDA-event mean of ``reps`` calls queued behind a 2 ms spin kernel,
    so that the host's enqueueing does not show between short launches."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list) -> int:
    rows = ROWS
    if "--rows" in argv:
        at = argv.index("--rows")
        rows = tuple(int(r) for r in argv[at + 1].split(","))
        argv = argv[:at] + argv[at + 2:]
        if not set(rows) <= set(ROWS):
            print(f"chip_ab: rows must be among {ROWS}", file=sys.stderr)
            return 2
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(one(argv[2], rows)), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    old, new = argv[1:]
    for tree in (old, new, new, old):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, "--rows",
                             ",".join(map(str, rows))]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
