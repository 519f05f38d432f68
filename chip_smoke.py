#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and a CUDA build of PyTorch:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. Build every kernel source at once (nvcc for ``csrc/sha256.cu`` and
   ``csrc/bls12_381.cu``, g++ for the host ``csrc/bls_host.cc``) and print
   the SHA-256 build's ``-Xptxas -v`` report.
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

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that the kernel table.
"""

from __future__ import annotations

import cProfile
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

    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(timed_build, build, name) for build, name in (
            (native.build_cuda_lib, "sha256"), (native.build_cuda_lib, "bls12_381"),
            (native.build_host_lib, "bls_host"))}
        build_s = {name: job.result() for name, job in jobs.items()}
    log(f"build sha256.cu {build_s['sha256']:.3f} s (all three sources built at once)")
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

    bls_phases(torch, np, native, dev, table, build_s, max_mhz)

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
    busy = busy_us / 1e3
    per_run = {k.__name__: k.launches // 2 for k in bb.KERNELS}
    expected = ["k_g2_subgroup", "k_g1_add_halves", "k_blinded_final", "k_gj_scalar_mul",
                "k_g2_add_halves", "k_miller", "k_fq12_mul_halves"]
    lost = [k for k in expected if not any(name.startswith(k) for name in device_us)]
    log(f"profiled block batch: wall {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall_ms):.1f}% idle; {len(spans)} device spans, sum "
        f"{sum(device_us.values()) / 1e3:.3f} ms); wrapper launches per run {per_run}; "
        f"device time by name (us) "
        f"{[(k, round(v, 1)) for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])]}")
    if lost:
        log(f"WARNING: the trace lacks kernels the run launched: {lost}; "
            f"the busy figure above is short by their time")
    fresh = T.fresh(block)
    prof_py = cProfile.Profile()
    prof_py.enable()
    bls.verify_signature_sets(fresh, backend="cuda")
    prof_py.disable()
    stats = pstats.Stats(prof_py).stats
    own = sorted(((tt * 1e3, f"{func} ({fname.rsplit('/', 1)[-1]}:{line})")
                  for (fname, line, func), (_cc, _nc, tt, _ct, _callers) in stats.items()),
                 reverse=True)[:5]
    log(f"host profile of one block batch, top 5 by own time (ms): "
        f"{[(name, round(ms, 2)) for ms, name in own]}")


if __name__ == "__main__":
    sys.exit(main())
