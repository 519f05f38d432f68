#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and a CUDA build of PyTorch:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. Build ``csrc/sha256.cu`` with nvcc and print its ``-Xptxas -v`` report.
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

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that the kernel table.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time
from unittest import mock

SEED = 20240313
N_SMALL = 1 << 14
N_FULL = 1 << 20
SLOTS = 8
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
INT32_LANES_PER_SM = 64          # int32 ALU lanes per Hopper SM and clock


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

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    native.build_cuda_lib("sha256")
    log(f"build sha256.cu {time.perf_counter() - t0:.3f} s")
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

    print(json.dumps({"kernels": list(table.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
