#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and a CUDA build of PyTorch:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. Build every kernel source at once (nvcc for ``csrc/sha256.cu``,
   ``csrc/bls12_381.cu``, ``csrc/epoch.cu`` and ``csrc/kzg.cu``, g++ for
   the host ``csrc/bls_host.cc``) and print the SHA-256 build's
   ``-Xptxas -v`` report.
2. Each SHA-256 kernel against its plain PyTorch version on the card, at
   the shapes of a 2^20-validator state root, bit for bit (tolerance 0:
   SHA-256 is integer arithmetic); the pair hash also against hashlib.
   Times every kernel and plain version with CUDA events.
3. The state root of a 2^14-validator mainnet-preset Deneb state from the
   kernels against the root hashed on the host with hashlib.
4. The main path at 2^20 validators (mainnet preset): the full state root,
   then the incremental tree cache through 8 ``per_slot_processing`` steps
   with a block-shaped diff before each.  Launch counts are read over this
   run alone.  Afterwards: the full root against the root from the plain
   versions on the card, each cached slot root against an uncached one,
   and one more slot profiled for where its time goes.
5. The BLS build report: seconds and each kernel's registers and stack.
6. Each BLS12-381 kernel against its plain PyTorch version on the card at
   the main path's shapes, tolerance 0 (integer arithmetic): the verify
   pipeline at the block batch's flat 256 lanes and the 1k batch's grouped
   512 lanes, the ψ subgroup check at 256 and 1024 lanes with a point
   outside G2 and a point of order 13 (both must read False), the blinded
   pubkey fold at 262,144 lanes and the chunk-partial Fq12 product.  Times
   every kernel and plain version with CUDA events.
7. The BLS main path: ``verify_signature_sets(backend="cuda")`` on the 1k-set
   microbench and on the 131 sets of one mainnet block at 2^20 validators,
   each cold once, then timed with fresh signatures (decompression and the
   ψ check run every time; pubkeys stay cached).  Launch counts are read
   over this run alone.  Afterwards: tampered batches (wrong message,
   signature outside G2, identity aggregate) must fail, chunked and
   monolithic verdicts must agree, small batches must agree with the host
   reference backend, and one block run is profiled.
8. The epoch kernels against their plain PyTorch versions on the card,
   tolerance 0 (integer arithmetic), on a 2^20-validator mainnet Deneb
   state at the last slot of an epoch (``testing.epoch_state``): the fused
   epoch pass over its 2^20 lanes, the shuffle rounds over the new epoch's
   active set (and over 2^20 positions), and the single-block SHA-256 over
   the shuffle's source messages, also against hashlib; the shuffle also
   against ``compute_shuffled_index`` at sampled positions.
9. The epoch main path, once for each fill of ``testing.epoch_state``:
   the stress fill of phase 8, then a mainnet-shaped registry (what a
   node crosses every epoch).  With the tree cache attached,
   ``per_slot_processing`` across the epoch boundary, the new epoch's
   ``compute_committee_shuffle``, then 4 cached slots with block-shaped
   diffs.  Launch counts are read over each run alone (one epoch pass, one
   shuffle, one single-block SHA-256 sweep).  Afterwards: the same steps
   with the epoch and the shuffle on the CPU must give the same registry
   digest, post-state root and shuffle, and each cached slot root must
   equal the uncached one; then ``epoch_ms``, ``shuffle_device_ms`` and
   one traced and one cProfiled boundary slot.
10. The KZG kernels against their plain PyTorch versions on the card,
    tolerance 0 (integer arithmetic), at the shapes of the 768-blob batch
    of width 4096: raw to Montgomery and the barycentric evaluation over
    [768, 4096] (one challenge on the domain), the G1 fold over 4096 lanes
    in one segment and interleaved in two, the fused check over its 4096
    lanes, and the Miller product of 2 pairs padded to 4 lanes.
11. The KZG main path (BASELINE config 5, as the JAX package's
    ``bench.py`` builds it): ``KzgSettings.dev(4096)``, the 6 unique blobs'
    commitments and proofs (checked against p(τ), q(τ) and the host
    lincomb), the 768-blob ``verify_blob_kzg_proof_batch`` cold then warm
    (p50 of 5; ``kzg_blobs_per_s``, ``kzg_batch_s``, ``kzg_cold_s``,
    ``kzg_n_blobs``, a stage split), the evaluations of the unique blobs
    against the host oracle, the tampered and edge-case batches of
    ``testing.kzg_cell``, a Deneb block's 6 blobs on the unfused path
    (p50 ms), and one traced and one cProfiled warm batch.  Launch counts
    are read over this phase alone.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that the kernel table.
"""

from __future__ import annotations

import cProfile
import hashlib
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

SEED = 20240313
N_SMALL = 1 << 14
N_FULL = 1 << 20
SLOTS = 8
BLS_SEED = 20240314
TIMED_RUNS = 5
EPOCH_SEED = 20240315
SLOTS_AFTER_EPOCH = 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
INT32_LANES_PER_SM = 64          # int32 ALU lanes per Hopper SM and clock
IMAD_LANES_PER_SM = 64           # 32-bit integer multiply-adds per SM and clock


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    import numpy as np

    from lighthouse_tpu_torch import native
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.ssz.tree_cache import enable_tree_cache
    from lighthouse_tpu_torch.state_transition import per_slot_processing
    from lighthouse_tpu_torch.testing import build_state, slot_diff

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(smi("clocks.max.sm").split()[0])
    int32_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * max_mhz * 1e6
    log(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{props.multi_processor_count} SMs at {max_mhz:.0f} MHz max -> "
        f"int32 issue rate {int32_ops_per_s:.4e}/s")

    # -- 1. build every source at once --------------------------------------
    def timed_build(build, name):
        t = time.perf_counter()
        build(name)
        return time.perf_counter() - t

    with ThreadPoolExecutor(5) as pool:
        jobs = {name: pool.submit(timed_build, build, name) for build, name in (
            (native.build_cuda_lib, "sha256"), (native.build_cuda_lib, "bls12_381"),
            (native.build_cuda_lib, "epoch"), (native.build_cuda_lib, "kzg"),
            (native.build_host_lib, "bls_host"))}
        build_s = {name: job.result() for name, job in jobs.items()}
    log(f"build sha256.cu {build_s['sha256']:.3f} s (all five sources built at once)")
    for line in native.build_log("sha256").splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")

    # -- 2. kernels against their plain versions -------------------------
    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(pairs: int, nbytes: int) -> tuple[float, str]:
        ops_ms = pairs * sha.OPS_PER_PAIR / int32_ops_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    rng = np.random.default_rng(SEED)
    pairs_np = rng.integers(0, 2**32, (N_FULL, 16), dtype=np.uint64).astype(np.uint32)
    leaves_np = rng.integers(0, 2**32, (N_FULL, 8), dtype=np.uint64).astype(np.uint32)
    pairs, leaves = sha.to_tensor(pairs_np, dev), sha.to_tensor(leaves_np, dev)
    cases = [
        # name, kernel, plain, input, pairs hashed, bytes moved, replaces
        ("hash_pairs", sha.hash_pairs_device, sha.hash_pairs_plain, pairs,
         N_FULL, N_FULL * 96, "lighthouse_tpu/ops/sha256.py:167"),
        ("fold_levels", sha.fold_levels_device, sha.fold_levels_plain, leaves,
         N_FULL - 1, N_FULL * 32 + (N_FULL - 1) * 32, "lighthouse_tpu/ops/sha256.py:196"),
        ("fold_to_root", sha.fold_to_root_device, sha.fold_to_root_plain, leaves,
         N_FULL - 1, N_FULL * 32 + 32, "lighthouse_tpu/ops/sha256.py:410"),
    ]
    table = {}
    for name, kernel, plain, x, n_pairs, nbytes, replaces in cases:
        got, want = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)).abs().max())
        if got.shape != want.shape or err != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain version "
                             f"(shape {list(got.shape)} vs {list(want.shape)}, max err {err})")
        if name == "hash_pairs":
            ref = sha.hash_pairs_np(pairs_np[:4096])
            if not np.array_equal(sha.to_numpy(got[:4096]), ref):
                raise SystemExit("hash_pairs: kernel disagrees with hashlib")
        ms = cuda_ms(lambda: kernel(x), 20)
        plain_ms = cuda_ms(lambda: plain(x), 3)
        bound_ms, bound_by = bound(n_pairs, nbytes)
        table[name] = dict(name=name, route="cuda", source="lighthouse_tpu_torch/csrc/sha256.cu",
                           replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
        log(f"kernel {name} [{N_FULL} x {x.shape[1]}]: == plain (max err {err}); "
            f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    del pairs, leaves, got, want

    # -- 3. small state: kernels against hashlib ---------------------------
    small, _ = build_state(N_SMALL, SEED, "mainnet")
    sha.reset_launches()
    root_kernels = small.hash_tree_root(dev)
    small_launches = {k.__name__: k.launches for k in sha.KERNELS}
    saved = sha._DEVICE_MIN_PAIRS, sha._DEVICE_FOLD_MIN_LEAVES
    sha._DEVICE_MIN_PAIRS = sha._DEVICE_FOLD_MIN_LEAVES = 1 << 62
    root_host = small.hash_tree_root(dev)
    sha._DEVICE_MIN_PAIRS, sha._DEVICE_FOLD_MIN_LEAVES = saved
    if root_kernels != root_host:
        raise SystemExit(f"{N_SMALL}-validator root: kernels {root_kernels.hex()} "
                         f"!= hashlib {root_host.hex()}")
    log(f"state root, {N_SMALL} validators: kernels == hashlib {root_host.hex()} "
        f"(launches {small_launches})")
    del small

    # -- 4. main path at 2^20 validators -----------------------------------
    t0 = time.perf_counter()
    state, spec = build_state(N_FULL, SEED, "mainnet")
    replay = state.copy()
    log(f"built {N_FULL}-validator mainnet Deneb state in {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sha.reset_launches()
    t0 = time.perf_counter()
    root_full = state.hash_tree_root(dev)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    per_root = {k.__name__: k.launches for k in sha.KERNELS}
    t0 = time.perf_counter()
    enable_tree_cache(state, dev)
    root_cached = state.hash_tree_root()
    torch.cuda.synchronize()
    cache_build_ms = (time.perf_counter() - t0) * 1e3
    before_slots = {k.__name__: k.launches for k in sha.KERNELS}
    diff_rng = np.random.default_rng(SEED + 1)
    slot_roots, slot_ms = [], []
    for _ in range(SLOTS):
        slot_diff(state, spec, diff_rng)
        t0 = time.perf_counter()
        slot_roots.append(per_slot_processing(state, spec))
        torch.cuda.synchronize()
        slot_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in sha.KERNELS}
    peak_bytes = torch.cuda.max_memory_allocated()
    per_slot = {k: (launches[k] - before_slots[k]) / SLOTS for k in launches}
    for name in table:
        table[name]["launches"] = launches[f"{name}_device"]
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise SystemExit(f"kernels never launched on the main path: {idle}")
    if root_cached != root_full:
        raise SystemExit("first cached root differs from the full root")
    log(f"main path, {N_FULL} validators: full root {full_ms:.1f} ms, cache build "
        f"{cache_build_ms:.1f} ms, slots {[round(m, 1) for m in slot_ms]} ms "
        f"(median {statistics.median(slot_ms):.1f} ms)")
    log(f"launches: main path {launches}; per full root {per_root}; "
        f"per incremental slot {per_slot}")
    log(f"max_memory_allocated {peak_bytes} bytes")

    # checks after the counted run
    with mock.patch.multiple(sha, hash_pairs_device=sha.hash_pairs_plain,
                             fold_levels_device=sha.fold_levels_plain,
                             fold_to_root_device=sha.fold_to_root_plain):
        t0 = time.perf_counter()
        root_plain = replay.hash_tree_root(dev)
        plain_root_ms = (time.perf_counter() - t0) * 1e3
    if root_plain != root_full:
        raise SystemExit(f"full root: kernels {root_full.hex()} != plain {root_plain.hex()}")
    log(f"full root: kernels == plain versions on the card {root_full.hex()} "
        f"(plain path {plain_root_ms:.1f} ms)")
    replay_rng = np.random.default_rng(SEED + 1)
    for i in range(SLOTS):
        slot_diff(replay, spec, replay_rng)
        fresh = per_slot_processing(replay, spec, dev)
        if fresh != slot_roots[i]:
            raise SystemExit(f"slot {i}: cached root {slot_roots[i].hex()} != "
                             f"uncached {fresh.hex()}")
    log(f"{SLOTS} cached slot roots == uncached roots; last {slot_roots[-1].hex()}")

    # where one more slot's time goes: device busy time against host work
    slot_diff(state, spec, diff_rng)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per_slot_processing(state, spec)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            device_us[ev.key] = us
    busy = sum(device_us.values()) / 1e3
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    log(f"profiled slot: wall {prof_wall_ms:.1f} ms, device busy {busy:.3f} ms; "
        f"top device entries (us) {[(k[:40], round(v, 1)) for k, v in top]}")
    slot_diff(state, spec, diff_rng)
    prof_py = cProfile.Profile()
    prof_py.enable()
    per_slot_processing(state, spec)
    torch.cuda.synchronize()
    prof_py.disable()
    stats = pstats.Stats(prof_py).stats
    host = {}
    for (fname, _line, func), (_cc, _nc, _tt, ct, _callers) in stats.items():
        if func in ("leaf_words", "_dirty_rows", "update", "root_words", "batch_roots",
                    "hash_pairs_device", "index_copy_", "to_tensor", "to_numpy",
                    "per_slot_processing") and "lighthouse_tpu_torch" in fname:
            host[func] = host.get(func, 0.0) + ct * 1e3
    log(f"host profile of one slot (cumulative ms): "
        f"{ {k: round(v, 2) for k, v in sorted(host.items(), key=lambda kv: -kv[1])} }")

    del state, replay
    bls_phases(torch, np, native, dev, table, build_s, max_mhz)
    epoch_phase(torch, np, native, dev, table, build_s, int32_ops_per_s)
    kzg_phases(torch, np, native, dev, table, build_s, max_mhz)
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s from start to the kernel table")

    print(json.dumps({"kernels": list(table.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def bls_phases(torch, np, native, dev, table, build_s, max_mhz) -> None:
    """Phases 5-7: the BLS12-381 batch-verify path."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import curve as cv
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls_backend as bb
    from lighthouse_tpu_torch.ops import bls_cuda
    from lighthouse_tpu_torch.ops import dispatch_pipeline as dp
    from lighthouse_tpu_torch.ops import ec, msm

    # -- 5. build report ----------------------------------------------------
    log(f"build bls12_381.cu {build_s['bls12_381']:.3f} s, bls_host.cc (g++) "
        f"{build_s['bls_host']:.3f} s (built in parallel in phase 1)")
    entry = None
    for line in native.build_log("bls12_381").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1].split("_cu_")[-1][8:40]
        elif "Used" in line and entry:
            log(f"  {entry}: {line.split(':', 1)[1].strip()}")
            entry = None
        elif "spill" in line and "0 bytes spill stores" not in line:
            log(f"  spill: {line.strip()}")

    props = torch.cuda.get_device_properties(0)
    imad_per_s = props.multi_processor_count * IMAD_LANES_PER_SM * max_mhz * 1e6
    log(f"IMAD rate (derived, not published: {props.multi_processor_count} SMs x "
        f"{IMAD_LANES_PER_SM} lanes x {max_mhz:.0f} MHz) {imad_per_s:.4e}/s; "
        f"{bls_cuda.IMADS_PER_FP_MUL} multiply-adds per Fp product")

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(fp_muls: int, nbytes: int) -> tuple[float, str]:
        ops_ms = fp_muls * bls_cuda.IMADS_PER_FP_MUL / imad_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    def max_err(got, want) -> int:
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise SystemExit(f"shape {list(got.shape)} != {list(want.shape)}")
        return int((bi.u64(got.to(torch.int32)) - bi.u64(want.to(torch.int32))).abs().max())

    # -- 6. BLS kernels against their plain versions ------------------------
    t0 = time.perf_counter()
    micro = T.microbench_sets(1024)
    block = T.block_signature_sets(BLS_SEED)
    log(f"built the 1k-set microbench and the block batch ({len(block)} sets over "
        f"{sum(len(s.pubkeys) for s in block)} member keys) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(BLS_SEED)

    def layout(sets):
        sig_pts = [s.signature.point for s in sets]
        h2 = [bb._hash_to_g2_cached(s.message) for s in sets]
        if sum(len(s.pubkeys) for s in sets) - len(sets) >= 16:
            px, py, _ = bb.aggregate_pubkeys_device(sets, dev)
        else:
            px, py = (bi.ints_to_mont_limbs([s.pubkeys[0].point[k] for s in sets]) for k in (0, 1))
        scalars = [int(r) for r in rng.integers(1, 1 << 63, len(sets))]
        return bb._chunk_layout(sets, sig_pts, h2, px, py, scalars, dev)

    cases = []
    for name, sets in (("block", block), ("1k chunk", micro[:512])):
        args = layout(sets)
        n, m, groups = args[0].shape[0], args[4].shape[0], args[-1]
        fp_muls = bls_cuda.pipeline_fp_muls(args[6].cpu().numpy(), groups, args[7].cpu().numpy())
        nbytes = n * (2 * 48 + 2 * 96 + 16 * 4) + m * (2 * 96 + 1) + 2 * 48 + 576
        cases.append((f"pipeline [{name}: {n} lanes, {groups or 'flat'} groups, {m + 1} Miller]",
                      "bls_pipeline", bb.pipeline_device, bb.pipeline_plain, args,
                      fp_muls, nbytes, "lighthouse_tpu/ops/bls_backend.py:124", 3))
    for name, sets in (("block", block), ("1k", micro)):
        pts = [s.signature.point for s in sets]
        pts += [cv.g2_generator()] * (msm.bucket(len(pts), floor=4) - len(pts))
        pts[0], pts[1] = T.non_subgroup_point(9), T.SMALL_ORDER_G2
        xq, yq = ec.g2_words(pts, dev)
        cases.append((f"g2_subgroup [{name}: {len(pts)} lanes]", "g2_subgroup",
                      bb.g2_subgroup_device, bb.g2_subgroup_plain, (xq, yq),
                      len(pts) * bls_cuda.PSI_LANE, len(pts) * (192 + 1),
                      "lighthouse_tpu/ops/bls_backend.py:175", 3))
    X, Y, Z, ux, uy, n_pad = bb.fold_lanes(block)
    fold_args = tuple(bi.to_tensor(a, dev) for a in (X, Y, Z, ux, uy)) + (n_pad,)
    cases.append((f"blinded_fold [{X.shape[0]} lanes -> {n_pad} segments]", "blinded_fold",
                  msm.blinded_fold_device, msm.blinded_fold_plain, fold_args,
                  bls_cuda.blinded_fold_fp_muls(Z.any(axis=1), n_pad),
                  3 * X.shape[0] * 48 + 96 + n_pad * (96 + 1),
                  "lighthouse_tpu/ops/msm.py:143", 3))
    rows = bi.ints_to_mont_limbs([int(v) % bi.P_INT for v in rng.integers(1, 1 << 62, 24)])
    fa, fb = (bi.to_tensor(rows[k:k + 12].reshape(1, 12, 12), dev) for k in (0, 12))
    cases.append(("fq12_mul [1 lane]", "fq12_mul", dp.fq12_mul_device, dp.fq12_mul_plain,
                  (fa, fb), bls_cuda.FP12_MUL, 3 * 576,
                  "lighthouse_tpu/ops/dispatch_pipeline.py:162", 20))
    for label, name, kernel, plain, args, fp_muls, nbytes, replaces, reps in cases:
        got = kernel(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args)          # timed once: thousands of small launches
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        if isinstance(got, tuple):
            errs = [max_err(g, w) for g, w in zip(got, want)]
            err = max(errs)
        else:
            err = max_err(got, want)
        if err != 0:
            raise SystemExit(f"{label}: kernel disagrees with its plain version (max err {err})")
        if name == "g2_subgroup":
            verdict = got.tolist()
            if verdict[:2] != [False, False] or not all(verdict[2:]):
                raise SystemExit(f"{label}: wrong membership verdicts {verdict[:4]}...")
        ms = cuda_ms(lambda: kernel(*args), reps)
        bound_ms, bound_by = bound(fp_muls, nbytes)
        log(f"kernel {label}: == plain (max err {err}); {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {fp_muls} Fp products)")
        if name not in table:       # the table keeps the block batch's shapes
            table[name] = dict(name=name, route="cuda",
                               source="lighthouse_tpu_torch/csrc/bls12_381.cu", replaces=replaces,
                               launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    del cases, fold_args

    # -- 7. the BLS main path ------------------------------------------------
    def verify(sets, **kw):
        t = time.perf_counter()
        ok = bls.verify_signature_sets(sets, backend="cuda", **kw)
        return ok, (time.perf_counter() - t) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bb.reset_launches()
    cold = {name: verify(T.fresh(sets)) for name, sets in (("1k", micro), ("block", block))}
    runs = {"1k": [], "block": []}
    for _ in range(TIMED_RUNS):
        for name, sets in (("1k", micro), ("block", block)):
            runs[name].append(verify(T.fresh(sets)))
    launches = {k.__name__: k.launches for k in bb.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    if not all(ok for ok, _ in list(cold.values()) + runs["1k"] + runs["block"]):
        raise SystemExit(f"a valid batch failed to verify: cold {cold}, runs {runs}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise SystemExit(f"BLS kernels never launched on the main path: {idle}")
    for name, key in (("bls_pipeline", "pipeline_device"), ("g2_subgroup", "g2_subgroup_device"),
                      ("blinded_fold", "blinded_fold_device"), ("fq12_mul", "fq12_mul_device")):
        table[name]["launches"] = launches[key]
    p50 = {k: statistics.median(ms for _, ms in v) for k, v in runs.items()}
    log(f"main path: 1k-set microbench cold {cold['1k'][1]:.1f} ms, runs "
        f"{[round(ms, 1) for _, ms in runs['1k']]} ms -> {1024 / p50['1k'] * 1e3:.1f} sets/s "
        f"(median); block batch cold {cold['block'][1]:.1f} ms, runs "
        f"{[round(ms, 1) for _, ms in runs['block']]} ms -> p50 {p50['block']:.1f} ms")
    log(f"launches over the main path: {launches}; max_memory_allocated {peak} bytes")

    # checks after the counted run
    bad = {"wrong message": T.with_wrong_message(T.fresh(block), 7),
           "signature outside G2": T.with_non_subgroup_signature(T.fresh(block), 11),
           "identity aggregate": T.with_identity_aggregate(T.fresh(block), 3)}
    verdicts = {name: verify(sets)[0] for name, sets in bad.items()}
    if any(verdicts.values()):
        raise SystemExit(f"a tampered batch verified: {verdicts}")
    chunked, mono = verify(T.fresh(block), chunk_size=64)[0], verify(T.fresh(block), chunk_size=0)[0]
    if not (chunked and mono):
        raise SystemExit(f"chunked ({chunked}) and monolithic ({mono}) verdicts differ")
    small = T.microbench_sets(8)
    for name, sets in (("valid", small), ("wrong message", T.with_wrong_message(small, 2))):
        ours, ref = verify(T.fresh(sets))[0], bls.verify_signature_sets(T.fresh(sets),
                                                                         backend="reference")
        if ours != ref:
            raise SystemExit(f"8-set {name} batch: cuda {ours} != reference {ref}")
    log(f"tampered block batches rejected {verdicts}; chunked (64) == monolithic verdict; "
        f"8-set batches agree with the host reference backend")

    ledger: dict = {}
    bb.verify_signature_sets_device(T.fresh(block), ledger=ledger)
    log(f"block batch stages (synchronized, ms): "
        f"{ {k: round(v * 1e3, 2) for k, v in ledger.items()} }")
    # one profiled block batch, after a warm-up step that starts the tracer
    # (a kernel launched as tracing starts can be lost); device busy is the
    # union of the trace's kernel and copy spans
    from torch.profiler import ProfilerActivity, profile, schedule
    bb.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "block.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(trace_path)) as prof:
            for fresh in (T.fresh(block), T.fresh(block)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bls.verify_signature_sets(fresh, backend="cuda")
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        busy, spans, device_us = device_busy(trace_path)
    per_run = {k.__name__: k.launches // 2 for k in bb.KERNELS}
    expected = ["k_g2_subgroup", "k_g1_add_halves", "k_blinded_final", "k_gj_scalar_mul",
                "k_g2_add_halves", "k_miller", "k_fq12_mul_halves"]
    lost = [k for k in expected if not any(name.startswith(k) for name in device_us)]
    log(f"profiled block batch: wall {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans, sum "
        f"{sum(device_us.values()) / 1e3:.3f} ms); wrapper launches per run {per_run}; "
        f"device time by name (us) "
        f"{[(k, round(v, 1)) for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])]}")
    if lost:
        log(f"WARNING: the trace lacks kernels the run launched: {lost}; "
            f"the busy figure above is short by their time")
    fresh = T.fresh(block)
    log(f"host profile of one block batch, top 5 by own time (ms): "
        f"{host_top5(lambda: bls.verify_signature_sets(fresh, backend='cuda'))}")


def device_busy(trace_path: str) -> tuple[float, int, dict]:
    """(busy ms as the union of the trace's kernel and copy spans, number of
    spans, device us by name) of a Chrome trace from torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, device_us = [], {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            key = ev["name"].replace("(anonymous namespace)::", "").split("(")[0][:40]
            device_us[key] = device_us.get(key, 0.0) + float(ev["dur"])
    busy_us, end_us = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
    return busy_us / 1e3, len(spans), device_us


def host_top5(fn) -> list:
    """The five functions with the most own time in one run of ``fn``
    under cProfile, as (name, ms)."""
    prof_py = cProfile.Profile()
    prof_py.enable()
    fn()
    prof_py.disable()
    stats = pstats.Stats(prof_py).stats
    own = sorted(((tt * 1e3, f"{func} ({fname.rsplit('/', 1)[-1]}:{line})")
                  for (fname, line, func), (_cc, _nc, tt, _ct, _callers) in stats.items()),
                 reverse=True)[:5]
    return [(name, round(ms, 2)) for ms, name in own]


def epoch_phase(torch, np, native, dev, table, build_s, int32_ops_per_s) -> None:
    """Phases 8-9: the epoch boundary of a 2^20-validator Deneb state."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.state_transition import epoch_device, epoch_processing, misc
    from lighthouse_tpu_torch.state_transition import shuffle

    # -- 8. epoch kernels against their plain versions ----------------------
    log(f"build epoch.cu {build_s['epoch']:.3f} s (built in parallel in phase 1)")
    for line in native.build_log("epoch").splitlines():
        if "Used" in line or ("spill" in line and "0 bytes spill stores" not in line):
            log(f"  {line.strip()}")

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(ops: int, nbytes: int) -> tuple[float, str]:
        ops_ms = ops / int32_ops_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    t0 = time.perf_counter()
    state, spec = T.epoch_state(N_FULL, EPOCH_SEED, "mainnet")
    epoch = misc.current_epoch(state, spec)
    log(f"built the {N_FULL}-validator epoch state (epoch {epoch}, slot {int(state.slot)}) "
        f"in {time.perf_counter() - t0:.2f} s")

    # the epoch pass at the main path's columns, tables and params
    leak = epoch_processing.is_in_inactivity_leak(state, spec)
    columns = epoch_device.build_columns(state, spec)
    tables = epoch_device.build_tables(state, spec, leak=leak)
    params = epoch_device.build_params(state, spec, leak=leak)
    args = [torch.from_numpy(columns[c]).to(dev) for c in epoch_device.COLUMNS]
    args += [torch.from_numpy(tables[k]).to(dev) for k in ("reward", "penalty", "slash")]
    args.append(torch.from_numpy(params).to(dev))
    k = tables["slash"].shape[0]
    # the new epoch's shuffle: its active count, seed and source messages
    # are those of the main path below (the epoch changes neither)
    rounds = spec.preset.shuffle_round_count
    count = int(state.validators.is_active(epoch + 1).sum())
    seed = misc.get_seed(state, spec, epoch + 1, spec.domain_beacon_attester)
    msgs = shuffle.source_messages(seed, rounds, count)
    sha_state = sha.to_tensor(np.broadcast_to(sha._H0, (msgs.shape[0], 8)), dev)
    sha_block = sha.to_tensor(sha.single_block_words(msgs), dev)
    digest = sha.to_numpy(sha.sha256_block_device(sha_state, sha_block))
    src = digest.astype(">u4").view(np.uint8).reshape(rounds, -1)
    pivots = shuffle.shuffle_pivots(seed, rounds, count).astype(np.int32)
    piv_t, src_t = torch.from_numpy(pivots).to(dev), torch.from_numpy(src.copy()).to(dev)
    rng = np.random.default_rng(EPOCH_SEED)
    full_seed = rng.bytes(32)
    full_src = sha.sha256_msgs(shuffle.source_messages(full_seed, rounds, N_FULL), device=dev)
    full_piv = torch.from_numpy(rng.integers(0, N_FULL, rounds).astype(np.int32)).to(dev)
    full_src_t = torch.from_numpy(full_src.reshape(rounds, -1)).to(dev)

    cases = [
        # key, label, kernel, plain, args, ops, bytes, source, replaces, reps
        ("epoch_pass", f"epoch_pass [{N_FULL} lanes, k {k}]", ek.fused_epoch_pass,
         ek.fused_epoch_pass_plain, tuple(args), N_FULL * ek.EPOCH_OPS_PER_LANE,
         N_FULL * ek.EPOCH_BYTES_PER_LANE + (7 * k + ek.N_PARAMS) * 8,
         "lighthouse_tpu_torch/csrc/epoch.cu", "lighthouse_tpu/ops/epoch_kernels.py:101", 20),
        ("shuffle_rounds", f"shuffle_rounds [{count} positions, {rounds} rounds]",
         ek.shuffle_rounds, ek.shuffle_rounds_plain, (piv_t, src_t, count),
         count * rounds * ek.SHUFFLE_OPS_PER_ROUND, src.size + 4 * rounds + 4 * count,
         "lighthouse_tpu_torch/csrc/epoch.cu", "lighthouse_tpu/ops/epoch_kernels.py:224", 20),
        ("shuffle_rounds@2^20", f"shuffle_rounds [{N_FULL} positions, {rounds} rounds]",
         ek.shuffle_rounds, ek.shuffle_rounds_plain, (full_piv, full_src_t, N_FULL),
         N_FULL * rounds * ek.SHUFFLE_OPS_PER_ROUND, full_src.size + 4 * rounds + 4 * N_FULL,
         "", "", 20),
        ("sha256_block", f"sha256_block [{msgs.shape[0]} lanes]", sha.sha256_block_device,
         sha.sha256_block_plain, (sha_state, sha_block), msgs.shape[0] * sha.OPS_PER_BLOCK,
         msgs.shape[0] * (32 + 64 + 32), "lighthouse_tpu_torch/csrc/sha256.cu",
         "lighthouse_tpu/ops/sha256.py:157", 20),
    ]
    for key, label, kernel, plain, kargs, ops, nbytes, source, replaces, reps in cases:
        got = kernel(*kargs)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*kargs)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        if err != 0 or [g.shape for g in got] != [w.shape for w in want]:
            raise SystemExit(f"{label}: kernel disagrees with its plain version (max err {err})")
        ms = cuda_ms(lambda: kernel(*kargs), reps)
        bound_ms, bound_by = bound(ops, nbytes)
        log(f"kernel {label}: == plain (max err {err}); {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {ops} int32 operations, {nbytes} bytes)")
        if source:
            table[key] = dict(name=key, route="cuda", source=source, replaces=replaces,
                              launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    hashed = np.stack([np.frombuffer(hashlib.sha256(m.tobytes()).digest(), np.uint8)
                       for m in msgs])
    if not np.array_equal(hashed, digest.astype(">u4").view(np.uint8).reshape(-1, 32)):
        raise SystemExit("sha256_block: kernel disagrees with hashlib on the source messages")
    fwd = ek.shuffle_rounds(piv_t, src_t, count).cpu().numpy()
    sample = np.random.default_rng(EPOCH_SEED + 1).integers(0, count, 32)
    if any(int(fwd[i]) != shuffle.compute_shuffled_index(int(i), count, seed, rounds)
           for i in sample):
        raise SystemExit("shuffle_rounds: kernel disagrees with compute_shuffled_index")
    log(f"sha256_block == hashlib on all {msgs.shape[0]} source messages; shuffle_rounds == "
        f"compute_shuffled_index at {sample.size} sampled positions")
    del args, cases, sha_state, sha_block, full_src_t, piv_t, src_t

    # -- 9. the main path at both fills: the stress fill whose shapes phase
    # 8 checked, then a mainnet-shaped registry, what a node crosses
    launches = boundary_path(torch, np, dev, state, spec, "stress")
    for key, name in (("epoch_pass", "fused_epoch_pass"), ("shuffle_rounds", "shuffle_rounds"),
                      ("sha256_block", "sha256_block_device")):
        table[key]["launches"] = launches[name]
    del state
    t0 = time.perf_counter()
    state, spec = T.epoch_state(N_FULL, EPOCH_SEED, "mainnet", fill="mainnet")
    log(f"built the {N_FULL}-validator mainnet-fill epoch state in "
        f"{time.perf_counter() - t0:.2f} s")
    boundary_path(torch, np, dev, state, spec, "mainnet")


def boundary_path(torch, np, dev, state, spec, fill: str) -> dict:
    """Phase 9 for one fill of ``testing.epoch_state``: the boundary slot
    with the tree cache, the new epoch's shuffle and 4 cached slots, with
    the epoch launch counts read over this run alone; the same steps with
    the epoch and the shuffle on the CPU; then the numbers.  Returns the
    launch counts."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.ssz.tree_cache import enable_tree_cache
    from lighthouse_tpu_torch.state_transition import (
        misc,
        per_slot_processing,
        process_epoch,
        process_slot,
    )

    epoch = misc.current_epoch(state, spec)

    enable_tree_cache(state, dev)
    state.hash_tree_root()
    ref = state.copy()                          # the device="cpu" run's copy
    del ref._tree_cache
    timing = ref.copy()                         # for epoch_ms after the main path
    profiled = [state.copy() for _ in range(3)]   # warm-up, traced, cProfiled crossings
    torch.cuda.synchronize()
    sha.reset_launches()
    ek.reset_launches()
    t0 = time.perf_counter()
    boundary_root = per_slot_processing(state, spec)
    torch.cuda.synchronize()
    boundary_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    shuffled = misc.compute_committee_shuffle(state, spec, epoch + 1, device=dev)
    shuffle_ms = (time.perf_counter() - t0) * 1e3
    post_digest, post_root = T.registry_state_digest(state), state.hash_tree_root()
    diff_rng = np.random.default_rng(EPOCH_SEED + 2)
    slot_roots, slot_ms = [], []
    for _ in range(SLOTS_AFTER_EPOCH):
        T.slot_diff(state, spec, diff_rng)
        t0 = time.perf_counter()
        slot_roots.append(per_slot_processing(state, spec))
        torch.cuda.synchronize()
        slot_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"fused_epoch_pass": ek.fused_epoch_pass.launches,
                "shuffle_rounds": ek.shuffle_rounds.launches,
                "sha256_block_device": sha.sha256_block_device.launches}
    merkle = {k.__name__: k.launches for k in sha.KERNELS}
    if list(launches.values()) != [1, 1, 1]:
        raise SystemExit(f"the boundary did not launch each epoch kernel once: {launches}")
    log(f"main path, {fill} fill, {N_FULL} validators: boundary slot {boundary_ms:.1f} ms, new-epoch "
        f"shuffle of {shuffled.shape[0]} ({shuffle_ms:.1f} ms), then slots "
        f"{[round(m, 1) for m in slot_ms]} ms; launches {launches}, merkle kernels {merkle}")

    # checks after the counted run: the same steps with the epoch and the
    # shuffle on the CPU (plain versions; the roots hash uncached on the
    # card, whose SHA kernels phase 2 held to their plain versions)
    t0 = time.perf_counter()
    ref_root = process_slot(ref, spec, dev)
    process_epoch(ref, spec, "cpu")
    ref.slot = int(ref.slot) + 1
    ref_shuffled = misc.compute_committee_shuffle(ref, spec, epoch + 1, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if ref_root != boundary_root:
        raise SystemExit("boundary slot: cached pre-state root != uncached root")
    ref_digest, ref_root = T.registry_state_digest(ref), ref.hash_tree_root(dev)
    replay_rng = np.random.default_rng(EPOCH_SEED + 2)
    ref_slot_roots = []
    for _ in range(SLOTS_AFTER_EPOCH):
        T.slot_diff(ref, spec, replay_rng)
        ref_slot_roots.append(per_slot_processing(ref, spec, dev))
    if post_digest != ref_digest:
        raise SystemExit(f"post-state registry digest: card {post_digest} != CPU {ref_digest}")
    if post_root != ref_root:
        raise SystemExit(f"post-state root: card {post_root.hex()} != CPU {ref_root.hex()}")
    if not np.array_equal(shuffled, ref_shuffled):
        raise SystemExit("new-epoch shuffle: card != CPU")
    if slot_roots != ref_slot_roots:
        raise SystemExit(f"cached slot roots {[r.hex()[:12] for r in slot_roots]} != uncached "
                         f"{[r.hex()[:12] for r in ref_slot_roots]}")
    log(f"{fill} fill: boundary == device='cpu' run ({cpu_ms:.1f} ms): registry digest {ref_digest}, "
        f"post-state root {ref_root.hex()}, shuffle equal, {SLOTS_AFTER_EPOCH} cached slot "
        f"roots == uncached")
    del ref

    # numbers: the epoch core alone, the warm shuffle, one traced and one
    # cProfiled boundary slot
    t0 = time.perf_counter()
    stages = process_epoch(timing, spec, dev)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    misc.compute_committee_shuffle(timing, spec, epoch + 1, device=dev)
    shuffle_device_ms = (time.perf_counter() - t0) * 1e3
    log(json.dumps({"fill": fill, "epoch_validators": N_FULL, "epoch_ms": epoch_ms,
                    "epoch_validators_per_s": N_FULL / (epoch_ms / 1e3),
                    "prep_host_ms": stages["prep_host_ms"], "dispatch_ms": stages["dispatch_ms"],
                    "shuffle_device_ms": shuffle_device_ms, "boundary_slot_ms": boundary_ms}))
    del timing
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "boundary.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(trace_path)) as prof:
            for crossing in profiled[:2]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                per_slot_processing(crossing, spec)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        busy, spans, device_us = device_busy(trace_path)
    lost = [k for k in ("k_fused_epoch_pass",) if not any(n.startswith(k) for n in device_us)]
    log(f"{fill} fill, profiled boundary slot: wall {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans); device time by name "
        f"(us) {[(n, round(v, 1)) for n, v in sorted(device_us.items(), key=lambda kv: -kv[1])][:8]}")
    if lost:
        log(f"WARNING: the trace lacks kernels the run launched: {lost}")
    log(f"{fill} fill, host profile of one boundary slot, top 5 by own time (ms): "
        f"{host_top5(lambda: per_slot_processing(profiled[2], spec))}")
    return launches


KZG_SEED = 11                    # bench.py's default_rng(11)
KZG_WIDTH = 4096
KZG_UNIQUE = 6
KZG_BLOCKS = 128
KZG_BLOCK_BLOBS = 6              # a Deneb block's most blobs


def kzg_phases(torch, np, native, dev, table, build_s, max_mhz) -> None:
    """Phases 10-11: Deneb blob KZG verification."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.bls import curve as cv
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as t12
    from lighthouse_tpu_torch.ops import bls_cuda, fr, msm

    # -- 10. KZG kernels against their plain versions ------------------------
    t_phase = time.perf_counter()
    log(f"build kzg.cu {build_s['kzg']:.3f} s (built in parallel in phase 1)")
    for name in ("kzg", "bls12_381"):
        entry = None
        for line in native.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry and any(k in entry for k in (
                    "k_fr_", "k_g1_scalar_mul")):
                log(f"  {entry.split('_cu_')[-1][8:40]}: {line.split(':', 1)[1].strip()}")
                entry = None
    props = torch.cuda.get_device_properties(0)
    imad_per_s = props.multi_processor_count * IMAD_LANES_PER_SM * max_mhz * 1e6

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(imads: int, nbytes: int) -> tuple[float, str]:
        ops_ms = imads / imad_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    R = fr.R_INT
    rng = np.random.default_rng(KZG_SEED)
    n, w = KZG_UNIQUE * KZG_BLOCKS, KZG_WIDTH
    raw = rng.integers(0, 256, (n, w, 32), dtype=np.uint8)
    raw[..., 0] &= 0x3F                                     # canonical: below 2^254
    roots = kzg._bit_reversal_permutation(kzg._compute_roots_of_unity(w))
    zs = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    zs[5] = roots[77 % w]                                     # a challenge on the domain
    raw_t = torch.from_numpy(raw).to(dev)
    f_m = fr.fr_to_mont_device(raw_t)
    z_t = bi.to_tensor(fr.to_mont_host(zs), dev)
    roots_t = bi.to_tensor(fr.to_mont_host(roots), dev)
    invw_t = bi.to_tensor(fr.to_mont_host([pow(w, -1, R)]), dev)
    # the fold's lanes: a blob's MSM (W) and the fused check's 2·bucket(2n + 1),
    # both 4096 at the cell; distinct points P_i = (i + 2)·G, 255-bit
    # scalars, two of them zero
    lanes = max(w, 2 * msm.bucket(2 * n + 1))
    g = cv.g1_generator()
    pts, p = [], cv.g1_mul(g, 2)
    for _ in range(lanes):
        pts.append(p)
        p = cv.g1_add(p, g)
    ks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(lanes)]
    ks[9] = ks[-7] = 0
    xs, ys, digits = msm._fold_lanes(pts, ks, lanes, dev)
    digits_np = digits.cpu().numpy()
    settings16 = kzg.KzgSettings.dev(16, device="cpu")
    xq, yq = settings16.g2_rows(dev)
    pair_pts = [(cv.g1_mul(g, 5), cv.g2_generator()),
                (cv.g1_neg(g), cv.g2_mul(cv.g2_generator(), 5))]
    mp = t12.points_to_device(pair_pts + [(cv.INF, cv.g2_generator())] * 2)
    mr_args = tuple(bi.to_tensor(c, dev) for c in mp[:4]) + (torch.from_numpy(mp[4]).to(dev),)
    fused_live = (msm.fold_device(xs, ys, digits, 2)[2] != 0).any(-1).cpu().numpy()
    fp, frm = bls_cuda.IMADS_PER_FP_MUL, fr.IMADS_PER_FR_MUL
    cases = [
        # key, label, kernel, plain, args, multiply-adds, bytes, source, replaces, reps
        ("fr_to_mont", f"fr_to_mont [{n} x {w}]", fr.fr_to_mont_device, fr.fr_to_mont_plain,
         (raw_t,), n * w * frm, n * w * 64, "lighthouse_tpu_torch/csrc/kzg.cu",
         "lighthouse_tpu/ops/fr.py:332", 10),
        ("fr_eval", f"fr_eval [{n} x {w}, one challenge on the domain]", fr.eval_device,
         fr.eval_plain, (f_m, z_t, roots_t, invw_t), fr.eval_fr_muls(n, w) * frm,
         n * w * 32 + w * 32 + 32 + n * 64, "lighthouse_tpu_torch/csrc/kzg.cu",
         "lighthouse_tpu/ops/fr.py:297", 10),
        ("g1_fold", f"g1_fold [{lanes} lanes, 1 segment]", msm.fold_device, msm.fold_plain,
         (xs, ys, digits, 1), bls_cuda.g1_fold_fp_muls(digits_np, 1) * fp,
         lanes * (96 + 256) + 144, "lighthouse_tpu_torch/csrc/bls12_381.cu",
         "lighthouse_tpu/ops/msm.py:115", 3),
        ("g1_fold@2", f"g1_fold [{lanes} lanes, 2 interleaved segments]", msm.fold_device,
         msm.fold_plain, (xs, ys, digits, 2), bls_cuda.g1_fold_fp_muls(digits_np, 2) * fp,
         lanes * (96 + 256) + 288, "", "", 3),
        ("kzg_fused", f"kzg_fused [{lanes} lanes, 2 Miller lanes]", kzg.kzg_fused_device,
         kzg.kzg_fused_plain, (xs, ys, digits, xq, yq),
         (bls_cuda.g1_fold_fp_muls(digits_np, 2) + bls_cuda.miller_reduce_fp_muls(fused_live)) * fp,
         lanes * (96 + 256) + 2 * 192 + 576, "lighthouse_tpu_torch/csrc/bls12_381.cu",
         "lighthouse_tpu/crypto/kzg.py:437", 3),
        ("miller_reduce", "miller_reduce [2 pairs, 4 lanes]", t12.miller_reduce_device,
         t12.miller_reduce_plain, mr_args, bls_cuda.miller_reduce_fp_muls(mp[4]) * fp,
         4 * (96 + 192 + 1) + 576, "lighthouse_tpu_torch/csrc/bls12_381.cu",
         "lighthouse_tpu/ops/bls12_381.py:779", 5),
    ]
    for key, label, kernel, plain, kargs, imads, nbytes, source, replaces, reps in cases:
        got = kernel(*kargs)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*kargs)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        if [g_.shape for g_ in got] != [w_.shape for w_ in want]:
            raise SystemExit(f"{label}: shapes {[list(g_.shape) for g_ in got]} != "
                             f"{[list(w_.shape) for w_ in want]}")
        err = max(int((bi.u64(g_) - bi.u64(w_)).abs().max()) for g_, w_ in zip(got, want))
        if err != 0:
            raise SystemExit(f"{label}: kernel disagrees with its plain version (max err {err})")
        del got, want
        ms = cuda_ms(lambda: kernel(*kargs), reps)
        bound_ms, bound_by = bound(imads, nbytes)
        log(f"kernel {label}: == plain (max err {err}); {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {imads} multiply-adds, {nbytes} bytes)")
        if source:
            table[key] = dict(name=key, route="cuda", source=source, replaces=replaces,
                              launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    ys_dev = fr.from_mont_host(bi.to_numpy(fr.eval_device(f_m, z_t, roots_t, invw_t)[:8]))
    host_settings = kzg.KzgSettings(w, [], None, roots)
    for i in (0, 6, 7):
        poly = [int.from_bytes(raw[i, j].tobytes(), "big") for j in range(w)]
        if int(ys_dev[i]) != kzg.evaluate_polynomial_in_evaluation_form(poly, zs[i], host_settings):
            raise SystemExit(f"fr_eval: blob {i} disagrees with the host evaluation")
    log("fr_eval == the host barycentric evaluation on blobs 0, 6, 7")
    del raw_t, f_m, z_t, cases
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # -- 11. the KZG main path -------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kzg.reset_launches()
    t0 = time.perf_counter()
    settings = kzg.KzgSettings.dev(w, device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cell = T.kzg_cell(w, KZG_UNIQUE, KZG_BLOCKS, KZG_SEED, settings=settings, device=dev)
    cell_s = time.perf_counter() - t0
    uniq, cs, proofs = cell["unique"]
    blobs, commits, prfs = cell["blobs"], cell["commitments"], cell["proofs"]
    log(f"KzgSettings.dev({w}) {setup_s:.2f} s; the cell's {KZG_UNIQUE} commitments and proofs, "
        f"its variants and {n} challenges {cell_s:.2f} s")

    def verify(bl, cm, pr, **kw):
        t = time.perf_counter()
        ok = kzg.verify_blob_kzg_proof_batch(bl, cm, pr, settings, dev, **kw)
        return ok, time.perf_counter() - t

    probe: dict = {}
    t0 = time.perf_counter()
    cold_ok = kzg._verify_batch(blobs, commits, prfs, settings, dev, probe=probe)
    cold_s = time.perf_counter() - t0
    runs = [verify(blobs, commits, prfs) for _ in range(TIMED_RUNS)]
    verdicts = {v["name"]: kzg._verify_batch(v["blobs"], v["commitments"], v["proofs"], settings,
                                             dev, zs=v["challenges"]) for v in cell["variants"]}
    bb = slice(0, KZG_BLOCK_BLOBS)
    block_runs = [verify(blobs[bb], commits[bb], prfs[bb]) for _ in range(TIMED_RUNS)]
    bad_block = list(prfs[bb])
    bad_block[0], bad_block[1] = bad_block[1], bad_block[0]
    block_bad = verify(blobs[bb], commits[bb], bad_block)[0]
    single = kzg.verify_blob_kzg_proof(uniq[0], cs[0], proofs[0], settings, dev)
    launches = {k.__name__: k.launches for k in kzg.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    if not cold_ok or not all(ok for ok, _ in runs + block_runs) or not single:
        raise SystemExit(f"a valid KZG batch failed: cold {cold_ok}, runs {runs}, "
                         f"block {block_runs}, single proof {single}")
    wrong = {k: v for k, v in verdicts.items()
             if v != next(x["valid"] for x in cell["variants"] if x["name"] == k)}
    if wrong or block_bad:
        raise SystemExit(f"KZG variants gave wrong verdicts: {wrong}; tampered block {block_bad}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise SystemExit(f"KZG kernels never launched on the main path: {idle}")
    for key, name in (("fr_to_mont", "fr_to_mont_device"), ("fr_eval", "eval_device"),
                      ("g1_fold", "fold_device"), ("kzg_fused", "kzg_fused_device"),
                      ("miller_reduce", "miller_reduce_device")):
        table[key]["launches"] = launches[name]
    p50 = statistics.median(s_ for _, s_ in runs)
    block_p50_ms = statistics.median(s_ for _, s_ in block_runs) * 1e3
    log(f"main path: {n}-blob batch cold {cold_s:.3f} s, runs {[round(s_, 3) for _, s_ in runs]} s; "
        f"block of {KZG_BLOCK_BLOBS} runs {[round(s_ * 1e3, 1) for _, s_ in block_runs]} ms; "
        f"variants {verdicts}; tampered block False; single proof True")
    log(f"launches over the main path: {launches}; max_memory_allocated {peak} bytes")

    # checks after the counted run
    tau = 0x123456789ABCDEF
    g1 = cv.g1_generator()
    for blob, c, pf in zip(uniq, cs, proofs):
        poly = kzg.blob_to_polynomial(blob, settings)
        p_tau = kzg.evaluate_polynomial_in_evaluation_form(poly, tau, settings)
        z = kzg.compute_challenge(blob, c, settings)
        y = kzg.evaluate_polynomial_in_evaluation_form(poly, z, settings)
        q_tau = (p_tau - y) * pow(tau - z, -1, R) % R
        want = msm.host_lincomb_groups([g1, g1], [p_tau, q_tau], [0, 1], 2)
        if [c, pf] != [cv.g1_to_bytes(x) for x in want]:
            raise SystemExit("a commitment or proof differs from [p(tau)]G1 / [q(tau)]G1")
    lincomb = msm.host_lincomb_groups(settings.g1_lagrange_brp,
                                      kzg.blob_to_polynomial(uniq[0], settings), None, 1)[0]
    if cv.g1_to_bytes(lincomb) != cs[0]:
        raise SystemExit("commitment 0 differs from the host lincomb")
    host_ys = [kzg.evaluate_polynomial_in_evaluation_form(kzg.blob_to_polynomial(b, settings),
                                                          kzg.compute_challenge(b, c, settings),
                                                          settings) for b, c in zip(uniq, cs)]
    if probe["ys"][:KZG_UNIQUE] != host_ys or probe["ys"][KZG_UNIQUE:2 * KZG_UNIQUE] != host_ys:
        raise SystemExit("the batch's evaluations differ from the host oracle")
    log(f"{KZG_UNIQUE} commitments and proofs == [p(tau)]G1 and [q(tau)]G1 (commitment 0 also "
        f"== the host lincomb); the batch's evaluations of the unique blobs == the host oracle")

    ledger: dict = {}
    verify(blobs, commits, prfs, ledger=ledger)
    block_ledger: dict = {}
    verify(blobs[bb], commits[bb], prfs[bb], ledger=block_ledger)
    log(json.dumps({"kzg_blobs_per_s": n / p50, "kzg_batch_s": p50, "kzg_cold_s": cold_s,
                    "kzg_n_blobs": n, "kzg_block_p50_ms": block_p50_ms,
                    "kzg_setup_s": setup_s,
                    "stages_ms": {k: v * 1e3 for k, v in ledger.items()},
                    "block_stages_ms": {k: v * 1e3 for k, v in block_ledger.items()}}))
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "kzg.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p_: p_.export_chrome_trace(trace_path)) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kzg.verify_blob_kzg_proof_batch(blobs, commits, prfs, settings, dev)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        busy, spans, device_us = device_busy(trace_path)
    lost = [k for k in ("k_fr_to_mont", "k_fr_eval", "k_g1_scalar_mul", "k_g1_add_halves",
                        "k_miller", "k_fq12_mul_halves")
            if not any(name.startswith(k) for name in device_us)]
    log(f"profiled {n}-blob batch: wall {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans); device time by name "
        f"(us) {[(k, round(v, 1)) for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])][:8]}")
    if lost:
        raise SystemExit(f"the traced {n}-blob batch lacks kernels the run launched: {lost}")
    log(f"host profile of one {n}-blob batch, top 5 by own time (ms): "
        f"{host_top5(lambda: kzg.verify_blob_kzg_proof_batch(blobs, commits, prfs, settings, dev))}")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
