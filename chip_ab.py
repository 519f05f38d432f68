#!/usr/bin/env python3
"""Time chosen rows of the kernel table (``PERF.md`` §6) in two checkouts
of the port on one card, in turns.

    python3 chip_ab.py OLD_TREE NEW_TREE [--rows 3,8,12,15,16,17,18,20]

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
- row 17 on ``chip_smoke.py`` phase 8's columns (the 2^20-validator
  stress-fill epoch state): 2^14 lanes, 2^20, 2^21 (the columns twice),
  the second shard of a mesh naming the card 4 times (a view 2^18 lanes
  in) and a view 5 lanes in (the scalar head and tail path), each also as
  device time alone behind a spin kernel long enough to hide the host's
  enqueueing, and as the host's time to enqueue one call; and a copy-only
  probe (built here with nvcc, not part of either tree) that moves the
  same 70 bytes a lane in the same vector pattern and grid, at 2, 4 and 8
  lanes a thread streaming and at 2 through the caches (102): the floor
  this access pattern reaches on the card;
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
import time

BLS_SEED = 20240314          # chip_smoke.py's block batch
KZG_SEED = 11                # chip_smoke.py's 768-blob batch
KZG_WIDTH = 4096
KZG_BLOBS = 768
SHA_SEED = 20240313          # chip_smoke.py's SEED
EPOCH_SEED = 20240315        # chip_smoke.py's epoch seed
SHUFFLE_COUNTS = (944_080, 1 << 20, 1 << 21, 1 << 22)
SHUFFLE_ROUNDS = 90
EPOCH_SIZES = (1 << 14, 1 << 20, 1 << 21)
EPOCH_MESH = 4
# row 17's spin: about 20 ms at 1,980 MHz, past the enqueueing of 50 calls
# (a wrapper call costs the host tens of microseconds, more than the
# kernel at 2^20 lanes)
EPOCH_SPIN = 40_000_000
ROWS = (3, 8, 12, 15, 16, 17, 18, 20)


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
    if 17 in rows:
        out.update(row17(torch, np, dev, ms))
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


PROBE_SRC = r"""
// Copy-only probe of row 17's access pattern: L lanes a thread, every
// column's L values in one vector streaming load (int64 in 16-byte pairs),
// three int64 outputs in 16-byte streaming stores, a grid of the SMs times
// the resident blocks walking the groups.  Each output mixes the inputs so
// that no load is dropped.
#include <cuda_runtime.h>
#include <cstdint>

template <bool C, class T>
__device__ __forceinline__ T l1(const T* p) {
    if constexpr (C) return __ldg(p);
    else return __ldcs(p);
}

template <int B, bool C>
__device__ __forceinline__ void ld(void* d, const void* s) {
    if constexpr (B % 16 == 0) {
#pragma unroll
        for (int j = 0; j < B / 16; ++j)
            static_cast<int4*>(d)[j] = l1<C>(static_cast<const int4*>(s) + j);
    } else if constexpr (B == 8) {
        *static_cast<int2*>(d) = l1<C>(static_cast<const int2*>(s));
    } else if constexpr (B == 4) {
        *static_cast<int*>(d) = l1<C>(static_cast<const int*>(s));
    } else {
        *static_cast<short*>(d) = l1<C>(static_cast<const short*>(s));
    }
}

template <int B, bool C>
__device__ __forceinline__ void st(void* d, const void* s) {
#pragma unroll
    for (int j = 0; j < B / 16; ++j) {
        if constexpr (C) static_cast<int4*>(d)[j] = static_cast<const int4*>(s)[j];
        else __stcs(static_cast<int4*>(d) + j, static_cast<const int4*>(s)[j]);
    }
}

template <int L, bool C>
__global__ void __launch_bounds__(256)
k_copy(long long groups, const int32_t* a, const int64_t* b, const int64_t* c, const uint8_t* d,
       const uint8_t* e, const int64_t* f, const int64_t* g, const int64_t* h, int64_t* o1,
       int64_t* o2, int64_t* o3) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < groups; q += stride) {
        const long long i = q * L;
        alignas(16) int32_t ia[L];
        alignas(16) int64_t ib[L], ic[L], iff[L], ig[L], ih[L], x[L], y[L], z[L];
        alignas(8) uint8_t id[L], ie[L];
        ld<4 * L, C>(ia, a + i); ld<8 * L, C>(ib, b + i); ld<8 * L, C>(ic, c + i);
        ld<8 * L, C>(iff, f + i); ld<8 * L, C>(ig, g + i); ld<8 * L, C>(ih, h + i);
        ld<L, C>(id, d + i); ld<L, C>(ie, e + i);
#pragma unroll
        for (int j = 0; j < L; ++j) {
            x[j] = ib[j] + ia[j];
            y[j] = ic[j] ^ iff[j] ^ id[j];
            z[j] = ig[j] + ih[j] + ie[j];
        }
        st<8 * L, C>(o1 + i, x); st<8 * L, C>(o2 + i, y); st<8 * L, C>(o3 + i, z);
    }
}

template <int L, bool C>
int launch(long long n, void** p, cudaStream_t s) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_copy<L, C>, 256, 0);
    const long long groups = n / L;
    long long blocks = (groups + 255) / 256;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
    k_copy<L, C><<<(unsigned)blocks, 256, 0, s>>>(
        groups, (const int32_t*)p[0], (const int64_t*)p[1], (const int64_t*)p[2],
        (const uint8_t*)p[3], (const uint8_t*)p[4], (const int64_t*)p[5], (const int64_t*)p[6],
        (const int64_t*)p[7], (int64_t*)p[8], (int64_t*)p[9], (int64_t*)p[10]);
    return (int)cudaGetLastError();
}

// lanes 2, 4, 8 stream; 102 is 2 lanes through the caches
extern "C" int probe(int lanes, long long n, void** p, void* s) {
    auto st = static_cast<cudaStream_t>(s);
    return lanes == 2 ? launch<2, false>(n, p, st) : lanes == 4 ? launch<4, false>(n, p, st)
         : lanes == 8 ? launch<8, false>(n, p, st) : launch<2, true>(n, p, st);
}
"""


def copy_probe(torch, ins: list, n: int, lanes: int):
    """The copy-only probe over the first n lanes of ``ins`` (the pass's
    eight input columns), built into a temporary directory at first use."""
    import ctypes
    import tempfile

    global _PROBE
    if "_PROBE" not in globals():
        from lighthouse_tpu_torch import native

        d = tempfile.mkdtemp(prefix="chip_ab_probe_")
        src = os.path.join(d, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE_SRC)
        subprocess.run([native._nvcc(), *native.NVCC_FLAGS, src, "-o", os.path.join(d, "p.so")],
                       check=True, capture_output=True)
        _PROBE = ctypes.CDLL(os.path.join(d, "p.so"))
        _PROBE.probe.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p]
    outs = [torch.empty(n, dtype=torch.int64, device=ins[0].device) for _ in range(3)]
    ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in ins + outs])

    def run():
        rc = _PROBE.probe(lanes, n, ptrs, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"copy probe: CUDA error {rc}")
    return run


def row17(torch, np, dev, ms) -> dict:
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.state_transition import epoch_device, epoch_processing

    state, spec = T.epoch_state(1 << 20, EPOCH_SEED, "mainnet")
    leak = epoch_processing.is_in_inactivity_leak(state, spec)
    columns = epoch_device.build_columns(state, spec)
    tables = epoch_device.build_tables(state, spec, leak=leak)
    params = epoch_device.build_params(state, spec, leak=leak)
    del state
    full = [torch.from_numpy(columns[c]).to(dev) for c in epoch_device.COLUMNS]
    shared = [torch.from_numpy(a).to(dev) for a in (tables["reward"], tables["penalty"],
                                                     tables["slash"], params)]
    per = (1 << 20) // EPOCH_MESH
    cases = {f"2^{n.bit_length() - 1}": [x[:n] if n <= x.shape[0] else torch.cat([x, x])
                                          for x in full] for n in EPOCH_SIZES}
    cases["mesh4 shard 1"] = [x[per:2 * per] for x in full]
    cases["view +5"] = [x[5:(1 << 20) - 11] for x in full]
    out = {"row17_ms": {}, "row17_device_ms": {}, "row17_host_ms": {}}
    for label, cols in cases.items():
        args = cols + shared
        for g, w in zip(ek.fused_epoch_pass(*args), ek.fused_epoch_pass_plain(*args)):
            if not torch.equal(g, w):
                raise SystemExit(f"row 17 disagrees with its plain version at {label}")
        out["row17_ms"][label] = ms(lambda: ek.fused_epoch_pass(*args), 50)
        out["row17_device_ms"][label] = device_ms(torch, lambda: ek.fused_epoch_pass(*args), 50,
                                                  EPOCH_SPIN)
        out["row17_host_ms"][label] = host_ms(torch, lambda: ek.fused_epoch_pass(*args), 50)
    out["row17_probe_device_ms"] = {
        lanes: device_ms(torch, copy_probe(torch, cases["2^20"], 1 << 20, lanes), 50, EPOCH_SPIN)
        for lanes in (2, 4, 8, 102)}
    out["row17_bytes_2^20"] = (1 << 20) * ek.EPOCH_BYTES_PER_LANE
    return out


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


def host_ms(torch, fn, reps: int) -> float:
    """Host milliseconds to enqueue one of ``reps`` calls (behind a spin
    kernel, so that the card's queue never pushes back)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(EPOCH_SPIN)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def device_ms(torch, fn, reps: int, spin: int = 4_000_000) -> float:
    """CUDA-event mean of ``reps`` calls queued behind a spin kernel of
    ``spin`` cycles (2 ms by default), so that the host's enqueueing does
    not show between short launches: the spin must outlast the enqueueing
    of all ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
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
