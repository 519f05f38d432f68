#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and a CUDA build of PyTorch:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. Build every kernel source at once (nvcc for ``csrc/sha256.cu``,
   ``csrc/bls12_381.cu``, ``csrc/epoch.cu`` and ``csrc/kzg.cu``, g++ for
   the host ``csrc/bls_host.cc`` and ``csrc/bls_tapes.cc``, the tapes of
   the BLS group kernels) and print the SHA-256 build's ``-Xptxas -v``
   report.
2. Each SHA-256 kernel against its plain PyTorch version on the card, at
   the shapes of a 2^20-validator state root, bit for bit (tolerance 0:
   SHA-256 is integer arithmetic); the pair hash also against hashlib, and
   the whole-tree fold against hashlib at 2^20 leaves and against its plain
   version and hashlib at every width 2 to 2^12 (with its plan per width).
   Times every kernel and plain version with CUDA events.
3. The state root of a 2^14-validator mainnet-preset Deneb state from the
   kernels against the root hashed on the host with hashlib.
4. The main path at 2^20 validators (mainnet preset): the full state root,
   then the incremental tree cache through 8 ``per_slot_processing`` steps
   with a block-shaped diff before each.  Launch counts are read over this
   run alone.  Afterwards: the full root against the root from the plain
   versions on the card, each cached slot root against an uncached one,
   and one more slot profiled for where its time goes.
5. The BLS build report: seconds of each build.
6. Each BLS12-381 kernel's ptxas line (stack frame, spills, registers,
   stack, static shared memory; a group kernel that spills fails the run,
   and so does a stack frame or spill in the blinded fold's tail),
   the group kernels' widths and dynamic shared memory and their tapes'
   levels, products, rounds and rows (the ψ check's doubling, mixed add
   and tail among them), the Fp product's cycles in a chain of one
   warp alone (held to Python integers); then each kernel against its
   plain PyTorch version on the card at the main path's shapes, tolerance 0
   (integer arithmetic): the verify pipeline at the block batch's flat 256
   lanes and the 1k batch's grouped 512 lanes, the ψ subgroup check at 256
   and 1024 lanes with a point outside G2 and a point of order 13 (both
   must read False; the ψ check's time also as cycles of a lane per tape
   level and per row), the blinded pubkey fold at 262,144 lanes (also
   each of its launches timed alone) and the chunk-partial Fq12 product.
   Times every kernel and plain version with CUDA events.  Then edge
   batches, compared only: the pipeline at one lane, with every Miller
   lane masked and with every scalar zero, an Fq12 product with a factor
   of one, the ψ check at 3 lanes, and the blinded fold at the 1k-set
   microbench's segments of 2 rows.
7. The BLS main path: ``verify_signature_sets(backend="cuda")`` on the 1k-set
   microbench and on the 131 sets of one mainnet block at 2^20 validators,
   each cold once, then timed with fresh signatures (decompression and the
   ψ check run every time; pubkeys stay cached).  Launch counts are read
   over this run alone.  Afterwards: tampered batches (wrong message,
   signature outside G2, identity aggregate) must fail, chunked and
   monolithic verdicts must agree, small batches must agree with the host
   reference backend, and one block run is profiled (with ``k_miller``'s
   time as cycles per Fp product of a lane).
8. The epoch kernels against their plain PyTorch versions on the card,
   tolerance 0 (integer arithmetic), on a 2^20-validator mainnet Deneb
   state at the last slot of an epoch (``testing.epoch_state``): the fused
   epoch pass over its 2^20 lanes (also at 1, 3, 5 and 2^20 + 7 lanes, on
   views 1 to 15 lanes into its columns, and, in phase 9, on the
   mainnet-fill state's columns), the shuffle rounds over the new epoch's
   active set (and over 2^20 and 2^21 positions: a row of decision bytes
   larger than one block's shared memory), and the single-block SHA-256
   over the shuffle's source messages, also against hashlib; the shuffle
   also against ``compute_shuffled_index`` at sampled positions; first both
   epoch kernels' ptxas lines (a stack frame or spill in
   ``k_shuffle_rounds`` or ``k_fused_epoch_pass`` fails the run).
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
    lanes, and the Miller product of 2 pairs padded to 4 lanes; first the
    ptxas lines of the path's kernels (a group kernel that spills fails the
    run, and so does a stack frame or spill in ``k_fr_eval`` or
    ``k_fr_to_mont``) and the evaluation's blocks resident an SM; last
    edge batches, compared only: raw to Montgomery over all but 5 of the
    batch's elements and over 7 (counts that are not a multiple of the
    kernel's 4 elements a thread), the fold at one lane and with every
    scalar zero.
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
12. The ingest kernels against their plain versions on the card,
    tolerance 0 (integer arithmetic): the gather fold (row 11) at the flood
    cell's shape (one batch's 2,048 lanes in its 16 committees, gathered
    from the 65,536-row registry table), at BASELINE config 3's full shape
    (32,768 lanes in 64 groups of 512 over a 2^20-row table tiling the
    registry's points) and on edges (a group of P and -P under one scalar
    and an empty group must read as the identity, the others must equal
    the host lincomb); the G1 membership check (row 12) over 4,096 lanes
    led by a point outside G1, both points of order 3, a member plus a
    point of order 3 and a point off the curve (all must read False),
    with its ptxas line and its time as cycles of a lane per tape level
    and row.
13. The main paths (BASELINE config 3, ``testing.flood_cell``: a
    65,536-validator mainnet Deneb state, 32,768 single-bit attestations,
    each signed by its attester's own key, in 16 wire batches of 2,048):
    (a) the chain and the pubkey plane's table (``pubkey_table_build_s``);
    (b) ``process_wire_batch`` over the 16 batches with the ``cuda`` BLS
    backend (no pre-merge) and (c) with the ``reference`` backend on a
    fresh chain, whose pre-merge folds every committee's pubkeys by row 11:
    both must verify every attestation and leave equal pools, observed
    attesters and fork-choice votes (``flood_atts_per_s`` and a stage
    split for each); (d) a tampered batch (a signature by another key, an
    undecompressable signature, a wrong target, an intra-batch duplicate,
    a wrong bits length, garbage) must give the same rejects, entry by
    entry, under (b), under (c) with the plane's device rung and with its
    reference rung; (e) on fresh chains, with attestations of later
    slots whose signatures the run has not seen, one traced batch per
    backend (the device-busy share; a traced batch that lacks a kernel it
    launched fails the run) and one cProfiled batch per backend; (f) ``load_trusted_setup`` of
    ``KzgSettings.dev(4096)`` in the ceremony's format with
    ``validate=True`` (``kzg_load_s``) must equal ``dev(4096)``, and a
    ceremony with a point outside G1 must raise ``KzgError`` naming it.
    Launch counts are read over this phase alone; row 11 must have
    launched in (c), row 12 once in (f).
14. Row 9, the hard part of the final exponentiation
    (``bls12_381.final_exp_hard_device``, ``csrc/bls12_381.cu``
    ``lh_final_exp_hard``, a warp a lane over its tapes): its ptxas line
    (a spill fails the run) and tapes, then against its plain PyTorch
    version on the card, tolerance 0 (integer arithmetic), on 1 lane, on
    132 lanes and on the identity, and against the host oracle
    ``fields.final_exp_hard``; its time (also as cycles of a lane per tape
    level and per row), bound and plain time; then the route the unset
    ``LHGPU_DEVICE_FINAL_EXP`` takes here, and the block batch, its
    wrong-message twin and the 768-blob KZG batch must give the same
    verdicts under ``LHGPU_DEVICE_FINAL_EXP=0`` (the native host final
    exponentiation, no row 9) and ``=1`` (row 9), which must launch once a
    batch.  Every other phase runs with the variable unset: on the card,
    row 9.
15. Block verify end to end (BASELINE config 2, ``testing.block_cell``: a
    2^20-validator mainnet-preset Deneb state and 3 consecutive full
    blocks, each of 128 aggregate attestations over whole committees of
    512, a full sync aggregate, 16 withdrawals, randao and proposal: 131
    signature sets over 66,050 member keys), under each final
    exponentiation route: ``process_block(VERIFY_BULK)`` cold once, then
    ``block_verify_p50_ms`` as ``bench.py`` defines it (p50 of 7 runs on
    fresh copies of the parent state advanced to the block's slot) with a
    stage split (shuffle, sets, verify with its aggregate, pipeline and
    final exponentiation, transition), held to BASELINE's 20 ms (printed
    as met or not met; a miss does not fail the run), the final
    exponentiation stage's p50 of 3 more runs per route beside the
    default route (the device's is to be at least 25% below the native
    one; printed, not a failure); and
    ``BeaconChain.process_block`` of the three blocks
    (``block_import_p50_ms``, split into gossip, signatures, copy, advance,
    transition, state root, import and the head recompute within it).
    Launch counts are read over these
    runs alone.  Afterwards: each imported block is its parent's child in
    fork choice, both routes import the same roots, the last post-state
    root equals a hashlib root of the same state, tampered blocks (two
    attestation signatures swapped, a wrong state root, a wrong proposer
    index) give the JAX package's reasons; then one traced import under
    each final exponentiation route (the device-busy share; a kernel the
    wrappers launched in it but the trace lacks fails the run, and so does
    a device-route import without row 9) and one cProfiled import.  Then
    a block with blobs (``testing.blob_block_cell``: the full block after
    the cell's last, with 6 blobs of width 4096 on ``KzgSettings.dev(4096)``
    and its 6 sidecars): tampered sidecars (another blob's proof, index 6,
    index 1, a changed branch node, the next validator as proposer) must
    give the JAX package's ``BlobError`` reasons, then the block is
    imported in both arrival orders into two chains that hold the cell's
    blocks (block first: ``process_block`` returns None, the missing
    indices are 0-5 and the sixth ``process_gossip_blob`` imports it;
    sidecars first, then the block), counted; afterwards each chain's head
    is the block, its post-state root equals the block's and a hashlib
    root, its 6 blobs are kept, and a repeated sidecar gives
    ``repeat_blob``; ``blob_block_import_ms`` per order and the gossip
    sidecar's p50 with its stages (gossip checks, proposer check, header
    signature, KZG, commit).
16. The multi-device rungs (``lighthouse_tpu_torch/parallel/``) over
    meshes that name this card 1, 2 and 4 times (a mesh's shards then run
    one after another on it): row 19, ``sharded_miller_reduce``, against
    its plain version, tolerance 0, on the block batch's pairs
    (``prepare_pairs`` of phase 7's 131 sets) over meshes of 1, 2 and 4,
    with its time, bound and plain time; one pair over 4 shards; a chunked
    sharded multi-pairing against a monolithic one.  Then the main path,
    counted: ``verify_signature_sets(backend="sharded")`` on the block
    batch (the default mesh) and p50 of 3 verifies over meshes of 1 and 4
    with their stage seconds, the full-width merkle dry run (the
    2^20-validator epoch state's validator roots over 4) and
    ``dryrun_multichip(4)``.  Afterwards: the ``cuda`` backend's verdict,
    a wrong-message, a swapped-signature, an empty and a no-pubkey batch
    reading False; row 20, ``sharded_fold_to_root``, against its plain
    version and hashlib at the JAX package's shape over 4, 3, 2 and 1 and at
    full width over 4, the full-width root also against the single-device
    fold; ``epoch_pass_sharded`` over 4 on phase 8's columns against the
    single-device pass and ``gather_fold_sharded`` over 4 at phase 12's
    full shape against the single-device fold, both tolerance 0; peak
    device memory under 8 GB.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that the kernel table.
"""

from __future__ import annotations

import cProfile
import hashlib
import json
import os
import pstats
import re
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

# calls of each row's wrapper over its main path, beside the table's
# launches: a tree wrapper launches once per level (its ``calls``
# counter), the others once a call
CALLS: dict = {}


def calls_of(fn) -> int:
    return getattr(fn, "calls", fn.launches)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    CALLS.clear()
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

    with ThreadPoolExecutor(6) as pool:
        jobs = {name: pool.submit(timed_build, build, name) for build, name in (
            (native.build_cuda_lib, "sha256"), (native.build_cuda_lib, "bls12_381"),
            (native.build_cuda_lib, "epoch"), (native.build_cuda_lib, "kzg"),
            (native.build_host_lib, "bls_host"), (native.build_host_lib, "bls_tapes"))}
        build_s = {name: job.result() for name, job in jobs.items()}
    log(f"build sha256.cu {build_s['sha256']:.3f} s (all six sources built at once)")
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
    # the whole-tree fold also against hashlib at 2^20 leaves, and at every
    # width 2 to 2^12 against its plain version and hashlib (one launch each)
    host = leaves_np
    while host.shape[0] > 1:
        host = sha.hash_pairs_np(host.reshape(-1, 16))
    if not np.array_equal(sha.to_numpy(sha.fold_to_root_device(leaves)), host):
        raise SystemExit("fold_to_root: kernel disagrees with hashlib at 2^20 leaves")
    for log_n in range(1, 13):
        x = leaves[:1 << log_n]
        got = sha.fold_to_root_device(x)
        host = leaves_np[:1 << log_n]
        while host.shape[0] > 1:
            host = sha.hash_pairs_np(host.reshape(-1, 16))
        if not torch.equal(got, sha.fold_to_root_plain(x)) or \
                not np.array_equal(sha.to_numpy(got), host):
            raise SystemExit(f"fold_to_root: kernel disagrees at 2^{log_n} leaves")
    log(f"fold_to_root == plain == hashlib at 2^20 leaves and at every width 2 to 2^12; "
        f"plans (leaves a thread, threads a block, blocks, one launch's capacity): "
        f"{ {f'2^{k}': tuple(sha.fold_plan(1 << k).values()) for k in (12, 16, 17, 18, 19, 20)} }")
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
    CALLS.update({k.__name__.removesuffix("_device"): calls_of(k) for k in sha.KERNELS})
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
    block_sets = bls_phases(torch, np, native, dev, table, build_s, max_mhz)
    shard_inputs = epoch_phase(torch, np, native, dev, table, build_s, int32_ops_per_s)
    kzg_batch = kzg_phases(torch, np, native, dev, table, build_s, max_mhz)
    shard_inputs["fold"] = ingest_phases(torch, np, dev, table, max_mhz)
    final_exp_phase(torch, np, native, dev, table, max_mhz, block_sets, kzg_batch)
    kzg_settings = kzg_batch[3]
    del kzg_batch
    block_phase(torch, np, dev, table, kzg_settings)
    del kzg_settings
    sharded_phase(torch, np, dev, table, max_mhz, int32_ops_per_s, block_sets, shard_inputs)
    del block_sets, shard_inputs
    log(f"calls on the main paths (the table's launches count a tree kernel's levels): "
        f"{ {k: CALLS[k] for k in table} }")
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s from start to the kernel table")

    print(json.dumps({"kernels": list(table.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def bls_phases(torch, np, native, dev, table, build_s, max_mhz) -> list:
    """Phases 5-7: the BLS12-381 batch-verify path.  Returns the block
    batch's signature sets (phase 14 verifies them again)."""
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
        f"{build_s['bls_host']:.3f} s, bls_tapes.cc (g++) {build_s['bls_tapes']:.3f} s "
        f"(built in parallel in phase 1)")

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

    def bound(imads: int, nbytes: int) -> tuple[float, str]:
        ops_ms = imads / imad_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    def max_err(got, want) -> int:
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise SystemExit(f"shape {list(got.shape)} != {list(want.shape)}")
        return int((bi.u64(got.to(torch.int32)) - bi.u64(want.to(torch.int32))).abs().max())

    # -- 6. BLS kernels against their plain versions ------------------------
    ptxas_report(native, "bls12_381", BLS_KERNELS)
    stats = bls_cuda.tape_stats()
    for k, v in stats["kernels"].items():
        staged = sum(stats["tapes"][t]["positions"] * 8 + stats["tapes"][t]["levels"] * 2
                     for t in v["tapes"])
        log(f"  {k}: groups of {v['width']} threads, {v['workspace_slots']} Fp slots a lane; "
            f"dynamic shared memory a warp-sized block {v['workspace_slots'] * 48 * 32 // v['width']}"
            f" bytes of workspaces + about {staged} bytes of staged tapes")
    log(f"  tapes (levels, temporaries, products, rounds of a level's products over the group "
        f"width, positions, rows): { {t: tuple(v.values()) for t, v in stats['tapes'].items()} }")
    fp_cycles = fp_mul_cycles(torch, np, dev, bls_cuda, bi, max_mhz)
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
    fp = bls_cuda.IMADS_PER_FP_MUL
    for name, sets in (("block", block), ("1k chunk", micro[:512])):
        args = layout(sets)
        n, m, groups = args[0].shape[0], args[4].shape[0], args[-1]
        fp_muls = bls_cuda.pipeline_fp_muls(args[6].cpu().numpy(), groups, args[7].cpu().numpy())
        nbytes = n * (2 * 48 + 2 * 96 + 16 * 4) + m * (2 * 96 + 1) + 2 * 48 + 576
        cases.append((f"pipeline [{name}: {n} lanes, {groups or 'flat'} groups, {m + 1} Miller]",
                      "bls_pipeline", bb.pipeline_device, bb.pipeline_plain, args,
                      fp_muls * fp, nbytes, "lighthouse_tpu/ops/bls_backend.py:124", 3))
    for name, sets in (("block", block), ("1k", micro)):
        pts = [s.signature.point for s in sets]
        pts += [cv.g2_generator()] * (msm.bucket(len(pts), floor=4) - len(pts))
        pts[0], pts[1] = T.non_subgroup_point(9), T.SMALL_ORDER_G2
        xq, yq = ec.g2_words(pts, dev)
        cases.append((f"g2_subgroup [{name}: {len(pts)} lanes]", "g2_subgroup",
                      bb.g2_subgroup_device, bb.g2_subgroup_plain, (xq, yq),
                      len(pts) * bls_cuda.PSI_LANE * fp, len(pts) * (192 + 1),
                      "lighthouse_tpu/ops/bls_backend.py:175", 3))
    X, Y, Z, ux, uy, n_pad = bb.fold_lanes(block)
    fold_args = tuple(bi.to_tensor(a, dev) for a in (X, Y, Z, ux, uy)) + (n_pad,)
    # the bound counts each segment's inversion on the Z its sum has
    fold_z = bi.to_numpy(msm.blinded_sum_plain(*fold_args)[2])
    cases.append((f"blinded_fold [{X.shape[0]} lanes -> {n_pad} segments]", "blinded_fold",
                  msm.blinded_fold_device, msm.blinded_fold_plain, fold_args,
                  bls_cuda.blinded_fold_muladds(Z.any(axis=1), fold_z),
                  3 * X.shape[0] * 48 + 96 + n_pad * (96 + 1),
                  "lighthouse_tpu/ops/msm.py:143", 3))
    rows = bi.ints_to_mont_limbs([int(v) % bi.P_INT for v in rng.integers(1, 1 << 62, 24)])
    fa, fb = (bi.to_tensor(rows[k:k + 12].reshape(1, 12, 12), dev) for k in (0, 12))
    cases.append(("fq12_mul [1 lane]", "fq12_mul", dp.fq12_mul_device, dp.fq12_mul_plain,
                  (fa, fb), bls_cuda.FP12_MUL * fp, 3 * 576,
                  "lighthouse_tpu/ops/dispatch_pipeline.py:162", 20))
    for label, name, kernel, plain, args, imads, nbytes, replaces, reps in cases:
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
        bound_ms, bound_by = bound(imads, nbytes)
        log(f"kernel {label}: == plain (max err {err}); {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {imads} multiply-adds, {imads / fp:.0f} "
            f"Fp products' worth)")
        if name == "blinded_fold":
            blinded_fold_split(torch, np, bls_cuda, msm, fold_args)
        if name == "g2_subgroup":
            lane_cycles(stats, bls_cuda.PSI_TAPES, bls_cuda.PSI_OTHER_LEVELS, ms, max_mhz,
                        fp_cycles, label)
        if name not in table:       # the table keeps the block batch's shapes
            table[name] = dict(name=name, route="cuda",
                               source="lighthouse_tpu_torch/csrc/bls12_381.cu", replaces=replaces,
                               launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    del cases, fold_args
    # edge batches of the group kernels, compared only: one lane, every Miller
    # lane masked, every scalar zero; an Fq12 factor of one
    t_edges = time.perf_counter()
    eight, one = layout(micro[:8]), layout(micro[:1])
    edges = [("one lane", one),
             ("8 lanes, every Miller lane masked", eight[:7] + (torch.zeros_like(eight[7]),)
              + eight[8:]),
             ("8 lanes, every scalar zero", eight[:6] + (torch.zeros_like(eight[6]),) + eight[7:])]
    for what, args in edges:
        err = max_err(bb.pipeline_device(*args), bb.pipeline_plain(*args))
        if err != 0:
            raise SystemExit(f"pipeline [{what}]: kernel disagrees with its plain version "
                             f"(max err {err})")
    f_one = bi.to_tensor(np.stack([bi.ints_to_mont_limbs([1] + [0] * 11)]), dev)
    for x, y in ((fa, f_one), (f_one, fb)):
        err = max_err(dp.fq12_mul_device(x, y), dp.fq12_mul_plain(x, y))
        if err != 0:
            raise SystemExit(f"fq12_mul with a factor of one: kernel disagrees (max err {err})")
    # the ψ check at an odd lane count: the last warp's second group idles
    pts = [T.SMALL_ORDER_G2, cv.g2_generator(), T.non_subgroup_point(5)]
    xq, yq = ec.g2_words(pts, dev)
    got, want = bb.g2_subgroup_device(xq, yq), bb.g2_subgroup_plain(xq, yq)
    torch.cuda.synchronize()
    if got.tolist() != want.tolist() or got.tolist() != [False, True, False]:
        raise SystemExit(f"g2_subgroup [3 lanes]: kernel {got.tolist()}, plain {want.tolist()}")
    # the blinded fold at the microbench's segments (2 rows: the tail alone)
    mfold = tuple(bi.to_tensor(a, dev) for a in bb.fold_lanes(micro)[:5])
    n_micro = msm.bucket(len(micro))
    for g_, w_ in zip(msm.blinded_fold_device(*mfold, n_micro),
                      msm.blinded_fold_plain(*mfold, n_micro)):
        if max_err(g_, w_) != 0:
            raise SystemExit("blinded_fold [1k sets]: kernel disagrees with its plain version")
    log(f"edge batches == plain ({time.perf_counter() - t_edges:.1f} s): pipeline "
        f"{[w for w, _ in edges]}; fq12_mul with a factor of one; g2_subgroup at 3 lanes; "
        f"blinded_fold at {mfold[0].shape[0]} lanes in {n_micro} segments "
        f"(plan {msm.blinded_fold_plan(mfold[0].shape[0], n_micro)})")

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
    CALLS.update(zip(("bls_pipeline", "g2_subgroup", "blinded_fold", "fq12_mul"),
                     map(calls_of, bb.KERNELS)))
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
    def block_step():
        fresh = T.fresh(block)
        bb.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bls.verify_signature_sets(fresh, backend="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    busy, spans, device_us, wall_ms = traced("block", block_step)
    per_run = {k.__name__: k.launches for k in bb.KERNELS}
    expected = ["k_g2_subgroup", "k_g1_add_halves", "k_blinded_final", "k_gj_scalar_mul",
                "k_g2_add_halves", "k_miller", "k_fq12_mul_halves"]
    lost = [k for k in expected if not any(name.startswith(k) for name in device_us)]
    log(f"profiled block batch: wall {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans, sum "
        f"{sum(device_us.values()) / 1e3:.3f} ms); wrapper launches per run {per_run}; "
        f"device time by name (us) "
        f"{[(k, round(v, 1)) for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])]}")
    if lost:
        raise SystemExit(f"the traced block batch lacks kernels the run launched: {lost}")
    per = device_us["k_miller"] * max_mhz / bls_cuda.MILLER_LANE
    log(f"k_miller in the traced block batch: {device_us['k_miller'] / 1e3:.3f} ms, its lanes "
        f"side by side: {per:.0f} cycles at {max_mhz:.0f} MHz per Fp product of a lane "
        f"({bls_cuda.MILLER_LANE} products)")
    fresh = T.fresh(block)
    log(f"host profile of one block batch, top 5 by own time (ms): "
        f"{host_top5(lambda: bls.verify_signature_sets(fresh, backend='cuda'))}")
    return block


# The kernels that run a lane on a group of threads from tapes (csrc/bls12_381.cuh):
# a spill in any of them fails the run.
GROUP_KERNELS = ("k_gj_scalar_mul", "k_g1_scalar_mul", "k_g1_gather_scalar_mul", "k_miller",
                 "k_fq12_mul_halves", "k_fq12_mul", "k_g2_subgroup", "k_final_exp_hard",
                 "k_g1_subgroup")
# Kernels whose values must all stay in registers or shared memory (rows 8
# and 15's redesign): a stack frame or a spill in either fails the run.
NO_STACK_KERNELS = ("k_blinded_final", "k_fr_eval", "k_fr_to_mont", "k_shuffle_rounds",
                    "k_fused_epoch_pass")
BLS_KERNELS = GROUP_KERNELS + ("k_g1_add_halves", "k_g2_add_halves", "k_blinded_final",
                               "k_g1_affine", "k_fp_mul_chain")


def ptxas_report(native, name: str, kernels) -> None:
    """Log each kernel's ptxas report from the build of csrc/<name>.cu
    (stack frame, spills, registers, barriers, stack, static shared memory);
    fail the run when a group kernel spills or a NO_STACK_KERNELS kernel has
    a stack frame or spills."""
    rows, fn = {}, None
    for line in native.build_log(name).splitlines():
        if "Function properties for" in line:
            fn = line.rsplit(" ", 1)[-1]
        elif fn and ("spill" in line or "Used" in line):
            rows.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    spilled = []
    for k in kernels:
        # a template kernel reports each instantiation
        hits = [v for f, v in rows.items() if re.search(rf"{len(k)}{k}[EI]", f)]
        if not hits:
            raise SystemExit(f"ptxas reported nothing for {k} in {name}.cu")
        for hit in hits:
            log(f"  {k}: {'; '.join(hit)}")
            line = " ".join(hit)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = m is None or int(m.group(1)) or int(m.group(2))
            if k in GROUP_KERNELS and spills:
                spilled.append(k)
            frame = re.search(r"(\d+) bytes stack frame", line)
            if k in NO_STACK_KERNELS and (spills or frame is None or int(frame.group(1))):
                spilled.append(k)
    if spilled:
        raise SystemExit(f"kernels spill registers or keep a stack frame: {spilled}")


def blinded_fold_split(torch, np, bls_cuda, msm, fold_args) -> None:
    """Log each launch of one blinded fold (row 8) timed alone with CUDA
    events, mean of 20: the tree launches by half, then the tail."""
    X, Y, Z, ux, uy, n_seg = fold_args
    halves, rows = msm.blinded_fold_plan(X.shape[0], n_seg)
    acc = np.zeros(len(halves) + 1)
    for rep in range(21):
        Xc, Yc, Zc = X.clone(), Y.clone(), Z.clone()
        xa = torch.empty((n_seg, 12), dtype=torch.int32, device=X.device)
        ya = torch.empty_like(xa)
        inf = torch.empty(n_seg, dtype=torch.uint8, device=X.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(halves) + 2)]
        torch.cuda.synchronize()
        ev[0].record()
        for k, half in enumerate(halves):
            bls_cuda.launch("lh_g1_add_halves", Xc, Yc, Zc, half)
            ev[k + 1].record()
        bls_cuda.launch("lh_blinded_final", Xc, Yc, Zc, ux, uy, xa, ya, inf, n_seg, rows)
        ev[-1].record()
        torch.cuda.synchronize()
        if rep:                             # the first run warms up
            acc += [ev[k].elapsed_time(ev[k + 1]) for k in range(len(ev) - 1)]
    acc /= 20
    log(f"  blinded_fold per launch (ms, mean of 20): "
        f"{ {f'half {h}': round(float(t), 4) for h, t in zip(halves, acc)} }, "
        f"tail of {rows} rows a segment {acc[-1]:.4f}; sum {acc.sum():.4f}")


def fp_mul_cycles(torch, np, dev, bls_cuda, bi, max_mhz: float) -> float:
    """The Fp product's latency in the kernels' code: one warp alone on the
    card, each thread a chain of dependent products (clock64), the results
    held to Python integers."""
    rng = np.random.default_rng(BLS_SEED + 9)
    n, iters = 32, 256
    xs, ys = ([int.from_bytes(rng.bytes(48), "little") % bi.P_INT for _ in range(n)]
              for _ in range(2))
    a, b = (bi.to_tensor(bi.ints_to_mont_limbs(v), dev) for v in (xs, ys))
    out = torch.empty_like(a)
    cycles = torch.empty(n, dtype=torch.int64, device=dev)
    for _ in range(2):                      # the first run warms the instruction cache
        bls_cuda.launch("lh_fp_mul_chain", a, b, out, cycles, n, iters)
    torch.cuda.synchronize()
    if bi.mont_limbs_to_ints(bi.to_numpy(out)) != [x * pow(y, iters, bi.P_INT) % bi.P_INT
                                                  for x, y in zip(xs, ys)]:
        raise SystemExit("lh_fp_mul_chain disagrees with Python integers")
    per = cycles.double().mean().item() / iters
    log(f"Fp product: {per:.1f} cycles each in chains of {iters} dependent products, one warp "
        f"alone on the card ({per / max_mhz * 1e3:.1f} ns at {max_mhz:.0f} MHz); "
        f"== Python integers")
    return per


def lane_cycles(stats, plan, other_levels, ms, max_mhz, fp_cycles, label) -> None:
    """Log a group kernel's time as cycles of one lane: per tape level, and,
    taking each product round at the Fp product's chain cycles, per
    remaining row (the linear operations a level's busiest thread runs)."""
    from lighthouse_tpu_torch.ops import bls_cuda

    shape = bls_cuda.lane_shape(stats, plan, other_levels)
    cycles = ms * 1e-3 * max_mhz * 1e6
    linear_rows = shape["rows"] - shape["rounds"]
    per_row = (cycles - shape["rounds"] * fp_cycles) / max(linear_rows, 1)
    log(f"  {label}: {cycles:.0f} cycles a lane at {max_mhz:.0f} MHz over {shape['levels']} "
        f"tape levels ({cycles / shape['levels']:.0f} a level), {shape['rounds']} product rounds "
        f"and {linear_rows} other rows: at {fp_cycles:.0f} cycles a round, {per_row:.0f} a row")


def traced(name: str, step) -> tuple:
    """Run ``step()`` twice under torch.profiler and trace the second run (a
    kernel launched as tracing starts can be lost) -> (busy ms, device spans,
    device us by name, the traced run's result).  A trace that holds no
    device activity at all, kernel or copy (the profiler recorded nothing),
    is taken once more on two more runs; the callers' checks hold either
    way."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(2):
        with tempfile.TemporaryDirectory() as tmp:
            trace_path = os.path.join(tmp, f"{name}.json")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(trace_path)) as prof:
                for _ in range(2):
                    out = step()
                    prof.step()
            busy, spans, device_us = device_busy(trace_path)
        if spans or attempt:
            return busy, spans, device_us, out
        log(f"{name}: the profiler recorded no device activity in the traced run; tracing "
            f"two more runs")


def device_busy(trace_path: str) -> tuple[float, int, dict]:
    """(busy ms as the union of the trace's kernel and copy spans, number of
    spans, device us by name) of a Chrome trace from torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, device_us = [], {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            # a template kernel's name carries its return type
            key = ev["name"].replace("(anonymous namespace)::", "").removeprefix("void ")
            key = key.split("(")[0][:40]
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


def epoch_phase(torch, np, native, dev, table, build_s, int32_ops_per_s) -> dict:
    """Phases 8-9: the epoch boundary of a 2^20-validator Deneb state.
    Returns phase 8's pass inputs (columns, tables, params) and the state's
    validator roots, the leaves of its registry tree (phase 16 splits
    them over a mesh)."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.state_transition import epoch_device, epoch_processing, misc
    from lighthouse_tpu_torch.state_transition import shuffle

    # -- 8. epoch kernels against their plain versions ----------------------
    log(f"build epoch.cu {build_s['epoch']:.3f} s (built in parallel in phase 1)")
    ptxas_report(native, "epoch", ("k_fused_epoch_pass", "k_shuffle_rounds"))

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

    def spun_ms(fn, reps: int) -> float:
        """CUDA-event mean of ``reps`` calls queued behind a spin kernel of
        about 20 ms: the kernel's own time, where a back-to-back mean of a
        launch shorter than its wrapper's host work shows the host's."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
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
    n_wide = 2 * N_FULL
    wide_src = sha.sha256_msgs(shuffle.source_messages(rng.bytes(32), rounds, n_wide), device=dev)
    wide_piv = torch.from_numpy(rng.integers(0, n_wide, rounds).astype(np.int32)).to(dev)
    wide_src_t = torch.from_numpy(wide_src.reshape(rounds, -1)).to(dev)

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
        ("shuffle_rounds@2^21", f"shuffle_rounds [{n_wide} positions, {rounds} rounds]",
         ek.shuffle_rounds, ek.shuffle_rounds_plain, (wide_piv, wide_src_t, n_wide),
         n_wide * rounds * ek.SHUFFLE_OPS_PER_ROUND, wide_src.size + 4 * rounds + 4 * n_wide,
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
        if key == "epoch_pass":
            # row 17 runs shorter than its wrapper's host work: the table
            # takes its time behind a spin kernel
            log(f"kernel {label}: back-to-back mean {ms:.4f} ms (the wrapper's host work)")
            ms = spun_ms(lambda: kernel(*kargs), 50)
        bound_ms, bound_by = bound(ops, nbytes)
        log(f"kernel {label}: == plain (max err {err}); {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {ops} int32 operations, {nbytes} bytes)")
        if source:
            table[key] = dict(name=key, route="cuda", source=source, replaces=replaces,
                              launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    epoch_pass_edges(torch, ek, args)
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
    del args, cases, sha_state, sha_block, full_src_t, wide_src_t, piv_t, src_t
    from lighthouse_tpu_torch.types.registry import ValidatorRegistryType

    # after phase 8's own counts; phase 9 reads its counts over its run alone
    shard_inputs = {"epoch_args": (columns, tables, params),
                    "registry_leaves": ValidatorRegistryType(N_FULL).batch_roots(
                        state.validators, dev)}

    # -- 9. the main path at both fills: the stress fill whose shapes phase
    # 8 checked, then a mainnet-shaped registry, what a node crosses
    launches = boundary_path(torch, np, dev, state, spec, "stress")
    for key, name in (("epoch_pass", "fused_epoch_pass"), ("shuffle_rounds", "shuffle_rounds"),
                      ("sha256_block", "sha256_block_device")):
        table[key]["launches"] = CALLS[key] = launches[name]      # one launch a call
    del state
    t0 = time.perf_counter()
    state, spec = T.epoch_state(N_FULL, EPOCH_SEED, "mainnet", fill="mainnet")
    log(f"built the {N_FULL}-validator mainnet-fill epoch state in "
        f"{time.perf_counter() - t0:.2f} s")
    leak = epoch_processing.is_in_inactivity_leak(state, spec)
    columns = epoch_device.build_columns(state, spec)
    main_args = [torch.from_numpy(columns[c]).to(dev) for c in epoch_device.COLUMNS]
    main_args += [torch.from_numpy(a).to(dev) for a in (
        *(epoch_device.build_tables(state, spec, leak=leak)[k] for k in ("reward", "penalty",
                                                                          "slash")),
        epoch_device.build_params(state, spec, leak=leak))]
    for g, w in zip(ek.fused_epoch_pass(*main_args), ek.fused_epoch_pass_plain(*main_args)):
        if not torch.equal(g, w):
            raise SystemExit("epoch_pass: kernel disagrees with its plain version on the "
                             "mainnet-fill columns")
    log(f"epoch_pass == plain on the {N_FULL} mainnet-fill columns")
    del main_args, columns
    boundary_path(torch, np, dev, state, spec, "mainnet")
    return shard_inputs


def epoch_pass_edges(torch, ek, args) -> None:
    """Row 17 against its plain version, tolerance 0, at counts that leave
    a scalar head or tail beside the vector groups (1, 3, 5 and 2^20 + 7
    lanes, the last the columns and 7 of their lanes again) and on views
    that start 1 to 15 lanes into the columns (a mesh shard's view)."""
    cols, shared = list(args[:8]), list(args[8:])
    cases = [(f"{n} lanes", [x[:n] for x in cols]) for n in (1, 3, 5)]
    cases.append((f"{N_FULL + 7} lanes", [torch.cat([x, x[:7]]) for x in cols]))
    cases += [(f"a view {o} lanes in", [x[o:] for x in cols]) for o in range(1, 16)]
    for label, case in cases:
        for g, w in zip(ek.fused_epoch_pass(*case, *shared),
                        ek.fused_epoch_pass_plain(*case, *shared)):
            if not torch.equal(g, w):
                raise SystemExit(f"epoch_pass: kernel disagrees with its plain version at "
                                 f"{label}")
    log(f"epoch_pass == plain at {len(cases)} edge cases: counts 1, 3, 5, {N_FULL + 7}; "
        f"views 1-15 lanes in")


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
    profiled = state.copy()       # the traced runs cross copies of it, the cProfiled run itself
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
    def boundary_step():
        crossing = profiled.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_slot_processing(crossing, spec)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    busy, spans, device_us, wall_ms = traced("boundary", boundary_step)
    lost = [k for k in ("k_fused_epoch_pass",) if not any(n.startswith(k) for n in device_us)]
    log(f"{fill} fill, profiled boundary slot: wall {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans); device time by name "
        f"(us) {[(n, round(v, 1)) for n, v in sorted(device_us.items(), key=lambda kv: -kv[1])][:8]}")
    if lost:
        raise SystemExit(f"{fill} fill: the traced boundary slot lacks kernels the run "
                         f"launched: {lost}")
    log(f"{fill} fill, host profile of one boundary slot, top 5 by own time (ms): "
        f"{host_top5(lambda: per_slot_processing(profiled, spec))}")
    return launches


KZG_SEED = 11                    # bench.py's default_rng(11)
KZG_WIDTH = 4096
KZG_UNIQUE = 6
KZG_BLOCKS = 128
KZG_BLOCK_BLOBS = 6              # a Deneb block's most blobs


def kzg_phases(torch, np, native, dev, table, build_s, max_mhz) -> tuple:
    """Phases 10-11: Deneb blob KZG verification.  Returns the 768-blob
    batch and its setup (phase 14 verifies them again)."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.bls import curve as cv
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as t12
    from lighthouse_tpu_torch.ops import bls_cuda, fr, msm

    # -- 10. KZG kernels against their plain versions ------------------------
    t_phase = time.perf_counter()
    log(f"build kzg.cu {build_s['kzg']:.3f} s (built in parallel in phase 1)")
    ptxas_report(native, "kzg", ("k_fr_to_mont", "k_fr_eval"))
    ptxas_report(native, "bls12_381", ("k_g1_scalar_mul", "k_g1_add_halves", "k_miller",
                                       "k_fq12_mul_halves"))
    threads, chunk = fr.eval_threads(KZG_WIDTH)
    log(f"  k_fr_eval at W = {KZG_WIDTH}: {threads} threads of {chunk} points, "
        f"{fr.eval_blocks_per_sm(KZG_WIDTH)} blocks resident an SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
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
         fr.eval_plain, (f_m, z_t, roots_t, invw_t), fr.eval_muladds(zs, w),
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
    # edge batches of the G1 lanes, compared only: one lane, every scalar
    # zero (the Miller and Fq12 lanes' edges ran in phase 6; the card tests
    # hold rows 10 and 14 to their plain versions on theirs)
    t_edges = time.perf_counter()
    flat = raw_t.view(-1, 32)
    edges = [(f"fr_to_mont [{flat.shape[0] - 5}]", fr.fr_to_mont_device, fr.fr_to_mont_plain,
              (flat[:-5],)),
             ("fr_to_mont [7]", fr.fr_to_mont_device, fr.fr_to_mont_plain, (flat[:7],)),
             ("g1_fold [1 lane]", msm.fold_device, msm.fold_plain,
              (xs[:1], ys[:1], digits[:, :1].contiguous(), 1)),
             ("g1_fold [4 lanes, every scalar zero]", msm.fold_device, msm.fold_plain,
              (xs[:4], ys[:4], torch.zeros_like(digits[:, :4]), 2))]
    for label, kernel, plain, kargs in edges:
        got, want = kernel(*kargs), plain(*kargs)
        torch.cuda.synchronize()
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        err = max(int((bi.u64(g_) - bi.u64(w_)).abs().max()) for g_, w_ in zip(got, want))
        if err != 0:
            raise SystemExit(f"{label}: kernel disagrees with its plain version (max err {err})")
    log(f"edge batches == plain ({time.perf_counter() - t_edges:.1f} s): {[e[0] for e in edges]}")
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
    CALLS.update(zip(("fr_to_mont", "fr_eval", "g1_fold", "kzg_fused", "miller_reduce"),
                     map(calls_of, kzg.KERNELS)))
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
    def kzg_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kzg.verify_blob_kzg_proof_batch(blobs, commits, prfs, settings, dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    busy, spans, device_us, wall_ms = traced("kzg", kzg_step)
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
    return blobs, commits, prfs, settings


FLOOD_SEED = 20240316
FLOOD_VALIDATORS = 1 << 16       # cut from 2^20: the pubkey table's host build (PERF.md §4)
FLOOD_ATTS = 1 << 15             # BASELINE config 3: 32k single-bit attestations a slot
FULL_TABLE_ROWS = 1 << 20        # config 3's registry, for row 11 alone
FULL_GROUPS = 64                 # 64 committees of 512 in config 3's full-size batch
TAMPERED_ROWS = 16
EDGE_ROWS = 4096                 # the edge case's table; row 12 runs over as many lanes


def ingest_phases(torch, np, dev, table, max_mhz) -> dict:
    """Phases 12-13: the gossip attestation flood and the trusted-setup load.
    Returns the host inputs of row 11 at config 3's full shape (phase 16
    folds them over a mesh)."""
    from lighthouse_tpu_torch import native
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.chain import columnar_ingest as ci
    from lighthouse_tpu_torch.chain import pubkey_plane
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.bls import curve as cv
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls_backend as bb
    from lighthouse_tpu_torch.ops import bls_cuda, ec, msm, native_bls, pubkey_kernels
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.state_transition import misc

    t_phase = time.perf_counter()
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

    def bound(fp_muls: int, nbytes: int) -> tuple[float, str]:
        ops_ms = fp_muls * bls_cuda.IMADS_PER_FP_MUL / imad_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    # -- 12. the gather fold and the G1 membership kernels against their plain
    #        versions, tolerance 0 (integer arithmetic) ------------------------
    t0 = time.perf_counter()
    cell = T.flood_cell(FLOOD_VALIDATORS, FLOOD_ATTS, FLOOD_SEED, n_spare=10, device=dev)
    flood_build_s = time.perf_counter() - t0
    state, spec = cell["state"], cell["spec"]
    log(f"built the flood cell ({FLOOD_VALIDATORS} validators, {FLOOD_ATTS} signed single-bit "
        f"attestations in {len(cell['batches'])} batches of {len(cell['batches'][0])}) in "
        f"{flood_build_s:.1f} s")
    rng = np.random.default_rng(FLOOD_SEED)
    rows_x, rows_y = pubkey_kernels.mont_rows(cell["points"])
    per_slot = misc.get_committee_count_per_slot(spec, cell["shuffle"].shape[0])
    committee_of = {int(v): (slot - int(state.slot)) * per_slot + c
                    for slot in range(int(state.slot), cell["current_slot"])
                    for c in range(per_slot)
                    for v in misc.get_beacon_committee(state, spec, slot, c, cell["shuffle"])}

    def scalars(n):
        return [int(v) for v in rng.integers(1, 1 << 63, n, dtype=np.int64)]

    def gather_case(tx, ty, rows, groups, n_groups, ks):
        lane_idx, digits, g_pad = pubkey_kernels.lane_layout(
            np.asarray(rows, np.int64), np.asarray(ks, np.uint64), np.asarray(groups, np.int64),
            n_groups)
        return (tx, ty, torch.from_numpy(lane_idx).to(dev), torch.from_numpy(digits).to(dev),
                g_pad)

    # the cell's shape: one batch's 2048 lanes in its 16 committees of 128,
    # gathered from the 65,536-row registry table
    tx, ty = pubkey_kernels.table_from_rows(rows_x, rows_y, dev)
    batch0 = cell["attesters"][0]
    groups0 = np.unique([committee_of[v] for v in batch0], return_inverse=True)[1]
    cell_args = gather_case(tx, ty, batch0, groups0, int(groups0.max()) + 1,
                            scalars(len(batch0)))
    # config 3's full shape: 32,768 lanes in 64 groups of 512 over a 2^20-row
    # table (tiling the registry's points: only the gather pattern matters)
    reps = FULL_TABLE_ROWS // FLOOD_VALIDATORS
    ftx, fty = (bi.to_tensor(np.tile(r, (reps, 1)), dev) for r in (rows_x, rows_y))
    full_rows = rng.integers(0, FULL_TABLE_ROWS, FLOOD_ATTS)
    full_fold = {"rows": (rows_x, rows_y), "lanes": full_rows,
                 "groups": np.repeat(np.arange(FULL_GROUPS), FLOOD_ATTS // FULL_GROUPS),
                 "scalars": scalars(FLOOD_ATTS)}
    full_args = gather_case(ftx, fty, full_rows, full_fold["groups"], FULL_GROUPS,
                            full_fold["scalars"])
    # edges: a group of P and -P under one scalar (the identity), an empty
    # group, non-power-of-two groups, a repeated row
    ex = list(cell["points"][:EDGE_ROWS - 1]) + [cv.g1_neg(cell["points"][0])]
    etx, ety = ec.g1_words(ex, dev)
    e_rows = [0, EDGE_ROWS - 1] + [int(r) for r in rng.integers(1, EDGE_ROWS - 1, 254)]
    e_rows[7] = e_rows[9]
    e_groups = [0, 0] + [int(g) for g in rng.choice([g for g in range(18) if g not in (0, 5)],
                                                     254)]
    e_ks = scalars(256)
    e_ks[1] = e_ks[0]
    edge_args = gather_case(etx, ety, e_rows, e_groups, 18, e_ks)
    edge_want = native_bls.g1_lincomb_groups([ex[r] for r in e_rows[2:]], e_ks[2:],
                                             e_groups[2:], 18)
    cases = []
    for key, label, args in (("gather_fold", f"gather_fold [cell: {len(batch0)} lanes, "
                              f"{int(groups0.max()) + 1} committees, {FLOOD_VALIDATORS}-row "
                              f"table]", cell_args),
                             ("gather_fold@full", f"gather_fold [config 3: {FLOOD_ATTS} lanes, "
                              f"{FULL_GROUPS} groups of {FLOOD_ATTS // FULL_GROUPS}, "
                              f"{FULL_TABLE_ROWS}-row table]",
                              full_args),
                             ("gather_fold@edges", "gather_fold [edges: 256 lanes, 18 groups "
                              "(identity, empty)]", edge_args)):
        digits_np = args[3].cpu().numpy()
        lanes, segs = args[2].shape[0], args[4]
        cases.append((key, label, msm.gather_fold_device, msm.gather_fold_plain, args,
                      bls_cuda.gather_fold_fp_muls(digits_np, segs),
                      lanes * (96 + 4 + 64) + segs * 97, "lighthouse_tpu/ops/msm.py:127", 3))
    # row 12's edge lanes first: a curve point outside G1, both points of
    # order 3, a member plus a point of order 3 and a point off the curve
    off_curve = (int.from_bytes(rng.bytes(48), "big") % bi.P_INT,
                 int.from_bytes(rng.bytes(48), "big") % bi.P_INT)
    edges = [T.non_g1_point(3), T.ORDER3_G1, cv.g1_neg(T.ORDER3_G1),
             cv.g1_add(cell["points"][0], T.ORDER3_G1), off_curve]
    sub = edges + list(cell["points"][len(edges):EDGE_ROWS])
    sxp, syp = ec.g1_words(sub, dev)
    cases.append(("g1_subgroup", f"g1_subgroup [{len(sub)} lanes: a non-G1 point, both points "
                  "of order 3, a member plus one, a point off the curve, then members]",
                  bb.g1_subgroup_device, bb.g1_subgroup_plain, (sxp, syp),
                  len(sub) * bls_cuda.G1_SUBGROUP_LANE, len(sub) * 97,
                  "lighthouse_tpu/ops/bls_backend.py:207", 3))
    for key, label, kernel, plain, kargs, fp_muls, nbytes, replaces, reps_ in cases:
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
        err = max(int((g_.long() - w_.long()).abs().max()) for g_, w_ in zip(got, want))
        if err != 0:
            raise SystemExit(f"{label}: kernel disagrees with its plain version (max err {err})")
        if key == "g1_subgroup":
            verdict = got[0].tolist()
            if any(verdict[:len(edges)]) or not all(verdict[len(edges):]):
                raise SystemExit(f"{label}: wrong membership verdicts {verdict[:8]}...")
        if key == "gather_fold@edges":
            xs, ys = bi.mont_limbs_to_ints(bi.to_numpy(got[0])), bi.mont_limbs_to_ints(
                bi.to_numpy(got[1]))
            inf = got[2].tolist()
            pts = [None if inf[g] else (xs[g], ys[g]) for g in range(18)]
            if not (inf[0] and inf[5]) or pts[1:5] + pts[6:18] != \
                    edge_want[1:5] + edge_want[6:18]:
                raise SystemExit(f"{label}: identity flags {inf[:6]} or sums differ from the "
                                 f"host lincomb")
        ms = cuda_ms(lambda: kernel(*kargs), reps_)
        bound_ms, bound_by = bound(fp_muls, nbytes)
        log(f"kernel {label}: == plain (max err {err}); {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {fp_muls} Fp products)")
        if key == "g1_subgroup":      # row 12's lane as group 4 threads wide (row 6's line)
            ptxas_report(native, "bls12_381", ("k_g1_subgroup",))
            lane_cycles(bls_cuda.tape_stats(), bls_cuda.G1_SUBGROUP_TAPES,
                        bls_cuda.G1_SUBGROUP_OTHER_LEVELS, ms, max_mhz,
                        fp_mul_cycles(torch, np, dev, bls_cuda, bi, max_mhz),
                        f"g1_subgroup ({bls_cuda.G1_SUBGROUP_LANE} Fp products a lane)")
        if "@" not in key:
            table[key] = dict(name=key, route="cuda",
                              source="lighthouse_tpu_torch/csrc/bls12_381.cu", replaces=replaces,
                              launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del got, want
    log("gather_fold edges: the P + (-P) group and the empty group read as the identity; the "
        "other 16 groups == the host lincomb")
    del cases, ftx, fty, full_args, cell_args, edge_args
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # -- 13. the main paths ------------------------------------------------------
    path_kernels = (*bb.KERNELS, msm.gather_fold_device, bb.g1_subgroup_device,
                    ek.shuffle_rounds, sha.sha256_block_device)

    def launches():
        return {k.__name__: k.launches for k in path_kernels}

    def new_chain(backend, slot=cell["current_slot"]):
        c = BeaconChain(spec, state, bls_backend=backend, device=dev)
        c.slot_clock.set_slot(slot)
        return c

    def flood(c):
        ci.reset_stages()
        verified, rejects = 0, []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in cell["batches"]:
            r = ci.process_wire_batch(c, [(blob, False) for blob in b])
            verified += r.verified
            rejects += r.rejects
        torch.cuda.synchronize()
        return verified, rejects, time.perf_counter() - t, ci.stage_snapshot()

    def chain_view(c):
        node, epoch, queued = c.fork_choice.votes()
        return (c.naive_pool.snapshot(), c.observed_attesters.seen_indices(cell["epoch"]).tolist(),
                node.tolist(), epoch.tolist(), queued)

    # (a) the chain and the plane's table
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in path_kernels:
        k.launches = 0
    chain_b = new_chain("cuda")
    plane = pubkey_plane.reset_pubkey_plane(dev)
    t0 = time.perf_counter()
    plane.ensure_table(state.validators)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    log(f"pubkey table: {plane.table_rows} rows in {table_s:.2f} s (decompression and "
        f"membership of every key on the host, then the upload) -> at 2^20 validators about "
        f"{table_s * (1 << 20) / FLOOD_VALIDATORS:.0f} s")
    # (b) BLS backend cuda: the node's default on the card (no pre-merge)
    verified_b, rejects_b, secs_b, stages_b = flood(chain_b)
    launches_b = launches()
    idle = [k for k in ("pipeline_device", "g2_subgroup_device", "fq12_mul_device",
                        "shuffle_rounds", "sha256_block_device") if launches_b[k] == 0]
    if idle:
        raise SystemExit(f"kernels of the cuda-backend flood never launched: {idle}")
    # (c) BLS backend reference, the plane's device rung: row 11 in each batch
    chain_c = new_chain("reference")
    before_c, calls_before = launches(), msm.gather_fold_device.calls
    verified_c, rejects_c, secs_c, stages_c = flood(chain_c)
    launches_c = {k: v - before_c[k] for k, v in launches().items()}
    CALLS["gather_fold"] = msm.gather_fold_device.calls - calls_before
    if verified_b != FLOOD_ATTS or verified_c != FLOOD_ATTS or rejects_b or rejects_c:
        raise SystemExit(f"the flood did not verify whole: cuda {verified_b} "
                         f"(rejects {rejects_b[:5]}), reference {verified_c} "
                         f"(rejects {rejects_c[:5]}) of {FLOOD_ATTS}")
    if chain_view(chain_b) != chain_view(chain_c):
        raise SystemExit("the two BLS backends left different pools, observed attesters or "
                         "fork-choice votes")
    if launches_c["gather_fold_device"] == 0 or plane.folds["device"] == 0:
        raise SystemExit(f"row 11 never launched in the reference-backend flood: "
                         f"{launches_c}, plane folds {plane.folds}")
    for name, secs, stages in (("cuda", secs_b, stages_b), ("reference", secs_c, stages_c)):
        log(json.dumps({"flood_atts_per_s": FLOOD_ATTS / secs, "flood_n": FLOOD_ATTS,
                        "flood_verified": FLOOD_ATTS, "flood_batch_s": secs,
                        "flood_build_s": flood_build_s, "flood_platform": "cuda",
                        "bls_backend": name, "pubkey_table_build_s": table_s,
                        "stages_s": stages["seconds"], "stage_counts": stages["counts"]}))
    log(f"both backends: {FLOOD_ATTS} verified, equal pools ({len(chain_b.naive_pool)} "
        f"aggregates), observed attesters and votes; launches over the cuda flood "
        f"{launches_b}, over the reference flood {launches_c}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")

    # (d) the tampered batch: the same rejects, entry by entry, in three runs
    blobs, want = T.flood_tampered(cell, TAMPERED_ROWS)
    outcomes = {}
    for name, c, rung in (("cuda", chain_b, None), ("reference, device rung", chain_c, "device"),
                          ("reference, reference rung", new_chain("reference"), "reference")):
        before = launches()["gather_fold_device"]
        with mock.patch.dict(os.environ, {"LHGPU_PUBKEY_BACKEND": rung} if rung else {}):
            r = ci.process_wire_batch(c, [(b, False) for b in blobs])
        outcomes[name] = (r.verified, dict(r.rejects), launches()["gather_fold_device"] - before)
    verdicts = {(v, tuple(sorted(rj.items()))) for v, rj, _ in outcomes.values()}
    if len(verdicts) != 1 or next(iter(outcomes.values()))[1] != want \
            or next(iter(outcomes.values()))[0] != len(blobs) - len(want):
        raise SystemExit(f"tampered batch: {outcomes}, expected rejects {want}")
    if outcomes["reference, device rung"][2] == 0:
        raise SystemExit("tampered batch: row 11 did not run on the forced device rung")
    log(f"tampered batch of {len(blobs)}: the same rejects in all three runs {sorted(want.items())}"
        f"; row 11 launches on the device rung {outcomes['reference, device rung'][2]}")

    # (e) one traced and one cProfiled batch per backend, on fresh chains, with
    # fresh signatures (the spare batches: a node sees each gossip signature
    # once); the kernels a traced batch must show are those its wrappers
    # launched in the traced step
    kernel_names = {"pipeline_device": ["k_gj_scalar_mul", "k_miller", "k_fq12_mul_halves"],
                    "g2_subgroup_device": ["k_g2_subgroup"], "fq12_mul_device": ["k_fq12_mul"],
                    "blinded_fold_device": ["k_blinded_final"],
                    "gather_fold_device": ["k_g1_gather_scalar_mul", "k_g1_affine"],
                    "g1_subgroup_device": ["k_g1_subgroup"],
                    "shuffle_rounds": ["k_shuffle_rounds"],
                    "sha256_block_device": ["k_sha256_block"]}
    spare = iter(cell["spare"])
    for name in ("cuda", "reference"):
        c = new_chain(name, cell["spare_slot"])
        c.committee_shuffle(state, cell["epoch"])

        def flood_step():
            b = next(spare)
            before = launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ci.process_wire_batch(c, [(blob, False) for blob in b])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            return wall_ms, len(b), {k: v - before[k] for k, v in launches().items() if v > before[k]}

        busy, spans, device_us, (wall_ms, n_b, in_trace) = traced("flood", flood_step)
        lost = [n for k in in_trace for n in kernel_names[k]
                if not any(d.startswith(n) for d in device_us)]
        log(f"{name} backend, profiled batch of {n_b}: wall {wall_ms:.1f} ms, device busy "
            f"{busy:.3f} ms ({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans); "
            f"wrapper launches {in_trace}; device time by name (us) "
            f"{[(n, round(v, 1)) for n, v in sorted(device_us.items(), key=lambda kv: -kv[1])][:8]}")
        if lost:
            raise SystemExit(f"the traced {name} batch lacks kernels the run launched: {lost}")
        b = next(spare)
        log(f"{name} backend, host profile of one batch, top 5 by own time (ms): "
            f"{host_top5(lambda: ci.process_wire_batch(c, [(x, False) for x in b]))}")

    # (f) the trusted-setup cell: KzgSettings.load_trusted_setup(validate=True)
    settings = kzg.KzgSettings.dev(KZG_WIDTH, device=dev)
    ceremony = T.ceremony_dict(settings)
    before = bb.g1_subgroup_device.launches
    t0 = time.perf_counter()
    loaded = kzg.KzgSettings.load_trusted_setup(ceremony, validate=True, device=dev)
    kzg_load_s = time.perf_counter() - t0
    load_launches = bb.g1_subgroup_device.launches - before
    if (loaded.width, loaded.g1_lagrange_brp, loaded.g2_tau, loaded.roots_brp) != \
            (settings.width, settings.g1_lagrange_brp, settings.g2_tau, settings.roots_brp):
        raise SystemExit("load_trusted_setup of the dev ceremony differs from KzgSettings.dev")
    if load_launches != 1:
        raise SystemExit(f"load_trusted_setup launched row 12 {load_launches} times, not once")
    bad_at = KZG_WIDTH * 3 // 10
    tampered = dict(ceremony, g1_lagrange=list(ceremony["g1_lagrange"]))
    tampered["g1_lagrange"][bad_at] = "0x" + cv.g1_to_bytes(T.non_g1_point(5)).hex()
    try:
        kzg.KzgSettings.load_trusted_setup(tampered, validate=True, device=dev)
        raise SystemExit("a ceremony with a point outside G1 loaded")
    except kzg.KzgError as e:
        if f"index {bad_at} " not in str(e):
            raise SystemExit(f"the tampered ceremony's error names the wrong point: {e}")
    table["gather_fold"]["launches"] = launches_c["gather_fold_device"]
    table["g1_subgroup"]["launches"] = CALLS["g1_subgroup"] = load_launches
    log(json.dumps({"kzg_load_s": kzg_load_s, "kzg_load_width": settings.width,
                    "kzg_load_g1_points": settings.width}))
    log(f"load_trusted_setup(dev({KZG_WIDTH}) as a ceremony, validate=True) == KzgSettings.dev; a "
        f"non-G1 point at {bad_at} raises KzgError naming it; launches over phase 13 {launches()}")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return full_fold


FINAL_EXP_SEED = 20240317
FINAL_EXP_LANES = 132            # one per SM: the widest batch a Miller reduction ends in
BLOCK_SEED = 20240318
BLOCK_CELL_BLOCKS = 3            # distinct consecutive blocks for the chain import
BLOCK_VERIFY_RUNS = 7            # bench.py's block_verify repeats
BLOCK_VERIFY_LIMIT_MS = 20.0     # BASELINE.json north star: full mainnet-block verify p50
FINAL_EXP_STAGE_RUNS = 3         # block verifies per route for the final_exp stage's p50


def _final_exp_route(on: bool | None) -> None:
    """Force the final exponentiation's route (``LHGPU_DEVICE_FINAL_EXP``),
    or with None leave it to the default (the device on a CUDA device)."""
    if on is None:
        os.environ.pop("LHGPU_DEVICE_FINAL_EXP", None)
    else:
        os.environ["LHGPU_DEVICE_FINAL_EXP"] = "1" if on else "0"


def _default_route(dev) -> str:
    from lighthouse_tpu_torch.ops import bls_backend as bb

    saved = os.environ.pop("LHGPU_DEVICE_FINAL_EXP", None)
    try:
        return "device" if bb.device_final_exp(dev) else "native"
    finally:
        if saved is not None:
            os.environ["LHGPU_DEVICE_FINAL_EXP"] = saved


def final_exp_phase(torch, np, native, dev, table, max_mhz, block, kzg_batch) -> None:
    """Phase 14: row 9, the hard part of the final exponentiation."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.crypto import bls, kzg
    from lighthouse_tpu_torch.crypto.bls.fields import (
        Fq2, Fq6, Fq12, P, final_exp_easy, final_exp_hard,
    )
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as t12
    from lighthouse_tpu_torch.ops import bls_cuda

    t_phase = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    imad_per_s = props.multi_processor_count * IMAD_LANES_PER_SM * max_mhz * 1e6
    rng = np.random.default_rng(FINAL_EXP_SEED)
    ptxas_report(native, "bls12_381", ("k_final_exp_hard",))
    stats = bls_cuda.tape_stats()
    k = stats["kernels"]["k_final_exp_hard"]
    log(f"  k_final_exp_hard: groups of {k['width']} threads, {k['workspace_slots']} Fp slots a "
        f"lane; tapes (levels, temporaries, products, rounds, positions, rows) "
        f"{ {t: tuple(stats['tapes'][t].values()) for t in k['tapes']} }; a lane runs "
        f"{bls_cuda.FINAL_EXP_HARD_TAPES}")
    fp_cycles = fp_mul_cycles(torch, np, dev, bls_cuda, bi, max_mhz)

    def f2():
        return Fq2(int.from_bytes(rng.bytes(48), "big") % P,
                   int.from_bytes(rng.bytes(48), "big") % P)

    ms_host = [final_exp_easy(Fq12(Fq6(f2(), f2(), f2()), Fq6(f2(), f2(), f2())))
               for _ in range(8)]
    rows = np.stack([t12.fq12_to_words(ms_host[i % 8]) for i in range(FINAL_EXP_LANES)])
    rows[FINAL_EXP_LANES - 1] = t12.fq12_to_words(Fq12.ONE)
    lanes = bi.to_tensor(rows, dev)
    one = bi.to_tensor(t12.fq12_to_words(Fq12.ONE)[None], dev)
    results = {}
    for label, x in (("1 lane", lanes[:1].contiguous()), (f"{FINAL_EXP_LANES} lanes", lanes),
                     ("identity", one)):
        got = t12.final_exp_hard_device(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = t12.final_exp_hard_plain(x)        # timed once: thousands of small launches
        end.record()
        end.synchronize()
        err = int((bi.u64(got) - bi.u64(want)).abs().max())
        if got.shape != want.shape or err != 0:
            raise SystemExit(f"final_exp_hard [{label}]: kernel disagrees with its plain version "
                             f"(max err {err})")
        results[label] = (got, err, start.elapsed_time(end))
    got_rows = bi.to_numpy(results[f"{FINAL_EXP_LANES} lanes"][0])
    n_check = min(8, FINAL_EXP_LANES - 1)
    oracle = all(t12.fq12_from_words(got_rows[i]) == final_exp_hard(ms_host[i])
                 for i in range(n_check))
    if not oracle or t12.fq12_from_words(got_rows[-1]) != Fq12.ONE or \
            t12.fq12_from_words(bi.to_numpy(results["identity"][0])) != Fq12.ONE:
        raise SystemExit("final_exp_hard: the card disagrees with the host oracle "
                         "fields.final_exp_hard (or maps one elsewhere)")

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

    for label in ("1 lane", f"{FINAL_EXP_LANES} lanes"):
        n = 1 if label == "1 lane" else FINAL_EXP_LANES
        x = lanes[:n].contiguous()
        ms = cuda_ms(lambda: t12.final_exp_hard_device(x), 10)
        fp_muls = n * bls_cuda.FINAL_EXP_HARD_LANE
        ops_ms = fp_muls * bls_cuda.IMADS_PER_FP_MUL / imad_per_s * 1e3
        bytes_ms = 2 * n * 576 / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                              else (bytes_ms, "bytes"))
        _got, err, plain_ms = results[label]
        log(f"kernel final_exp_hard [{label}]: == plain (max err {err}); {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {bound_ms:.6f} ms ({bound_by}: {fp_muls} Fp products)")
        lane_cycles(stats, bls_cuda.FINAL_EXP_HARD_TAPES, bls_cuda.FINAL_EXP_HARD_OTHER_LEVELS,
                    ms, max_mhz, fp_cycles, f"final_exp_hard [{label}]")
        if n == 1:                  # the main path's shape: one product a call
            table["final_exp_hard"] = dict(
                name="final_exp_hard", route="cuda",
                source="lighthouse_tpu_torch/csrc/bls12_381.cu",
                replaces="lighthouse_tpu/ops/bls_backend.py:395", launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)
    log(f"final_exp_hard == fields.final_exp_hard (host oracle) on {n_check} lanes; one maps "
        f"to one")

    # the verdicts under both routes of LHGPU_DEVICE_FINAL_EXP
    log(f"final exponentiation route with LHGPU_DEVICE_FINAL_EXP unset on {dev}: "
        f"{_default_route(dev)} (a CUDA device takes row 9, the CPU the native library; "
        f"0 and 1 force a route)")
    blobs, commits, prfs, settings = kzg_batch
    cases = {"block batch": (lambda: bls.verify_signature_sets(T.fresh(block), backend="cuda",
                                                               device=dev), True),
             "block batch, wrong message": (lambda: bls.verify_signature_sets(
                 T.with_wrong_message(T.fresh(block), 2), backend="cuda", device=dev), False),
             f"{len(blobs)}-blob KZG batch": (lambda: kzg.verify_blob_kzg_proof_batch(
                 blobs, commits, prfs, settings, dev), True)}
    verdicts = {}
    for on in (False, True):
        _final_exp_route(on)
        t12.final_exp_hard_device.launches = 0
        for name, (fn, want) in cases.items():
            t0 = time.perf_counter()
            ok = fn()
            torch.cuda.synchronize()
            verdicts[(name, on)] = (ok, round((time.perf_counter() - t0) * 1e3, 1))
            if ok != want:
                raise SystemExit(f"{name} with LHGPU_DEVICE_FINAL_EXP={int(on)}: verdict {ok}")
        if on and t12.final_exp_hard_device.launches != len(cases):
            raise SystemExit(f"the device route launched row 9 "
                             f"{t12.final_exp_hard_device.launches} times, not {len(cases)}")
        if not on and t12.final_exp_hard_device.launches:
            raise SystemExit("the native route launched row 9")
    _final_exp_route(None)
    log(f"verdicts (verdict, wall ms) under LHGPU_DEVICE_FINAL_EXP=0 / 1: "
        f"{ {f'{k[0]} [{int(k[1])}]': v for k, v in verdicts.items()} }")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


def block_phase(torch, np, dev, table, kzg_settings) -> None:
    """Phase 15: block verify end to end (BASELINE config 2), then a block
    with 6 blobs imported in both arrival orders."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.chain.block_verification import BlockError
    from lighthouse_tpu_torch.ops import bls12_381 as t12
    from lighthouse_tpu_torch.ops import bls_backend as bb
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.state_transition import SignatureStrategy, process_block

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cell = T.block_cell(N_FULL, BLOCK_SEED, BLOCK_CELL_BLOCKS, device=dev)
    spec, blocks = cell["spec"], cell["blocks"]
    b0 = blocks[0].message
    n_sets = 2 + len(b0.body.attestations) + 1
    n_keys = sum(len(a.aggregation_bits) for a in b0.body.attestations) + 2 + \
        spec.preset.sync_committee_size
    log(f"block cell: {N_FULL} validators (mainnet preset, Deneb), {len(blocks)} blocks of "
        f"{len(b0.body.attestations)} attestations, a full sync aggregate and "
        f"{len(b0.body.execution_payload.withdrawals)} withdrawals ({n_sets} signature sets over "
        f"{n_keys} member keys); built in {time.perf_counter() - t0:.1f} s, of which the key "
        f"column {cell['keygen_s']:.1f} s")

    path_kernels = (*bb.KERNELS, t12.final_exp_hard_device, *sha.KERNELS,
                    sha.sha256_block_device, ek.shuffle_rounds)

    def launches():
        return {k.__name__: k.launches for k in path_kernels}

    def verify_once(k=0, ledger=None):
        state = cell["pre_states"][k].copy()
        torch.cuda.synchronize()
        t = time.perf_counter()
        process_block(state, spec, blocks[k], SignatureStrategy.VERIFY_BULK, device=dev,
                      ledger=ledger)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, state

    def new_chain():
        return BeaconChain(spec, cell["state"], device=dev, kzg_settings=kzg_settings)

    def import_all(c):
        roots = []
        for b in blocks:
            c.slot_clock.set_slot(int(b.message.slot))
            torch.cuda.synchronize()
            roots.append(c.process_block(b))
            torch.cuda.synchronize()
        return roots

    # the main path, counted: block verify (p50 of 7 after one warm-up, on
    # fresh copies of the parent state advanced to the slot) and the chain
    # import of the cell's distinct blocks, under each final exponentiation
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bb.reset_launches()
    sha.reset_launches()
    ek.reset_launches()
    t12.final_exp_hard_device.launches = 0
    results = {}
    for route in ("native", "device"):
        _final_exp_route(route == "device")
        cold_ms, post = verify_once()
        if post.hash_tree_root() != cell["post_roots"][0]:
            raise SystemExit(f"block verify [{route}]: post-state root != the block's state root")
        runs = [verify_once()[0] for _ in range(BLOCK_VERIFY_RUNS)]
        bb._H2C_CACHE.clear()                # the import below hashes unseen messages
        chain = new_chain()
        roots = import_all(chain)
        times = [chain.block_times[r] for r in roots]
        results[route] = dict(cold_ms=cold_ms, runs=runs, p50=statistics.median(runs),
                              chain=chain, roots=roots, times=times,
                              import_p50=statistics.median(t["total"] for t in times) * 1e3)
    _final_exp_route(None)
    counted = launches()
    peak = torch.cuda.max_memory_allocated()
    idle = [k for k, v in counted.items() if v == 0 and k not in (
        "fq12_mul_device", "fold_levels_device", "fold_to_root_device")]
    if idle:
        raise SystemExit(f"block path kernels never launched: {idle}")
    table["final_exp_hard"]["launches"] = CALLS["final_exp_hard"] = counted["final_exp_hard_device"]
    log(f"launches over the block path (both routes): {counted}; max_memory_allocated {peak} "
        f"bytes")

    # checks after the counted run
    for route, r in results.items():
        chain, roots = r["chain"], r["roots"]
        parent = cell["anchor_root"]
        for b, root in zip(blocks, roots):
            node = chain.fork_choice.proto.node(root)
            if node["parent"] != parent or node["slot"] != int(b.message.slot):
                raise SystemExit(f"fork choice [{route}]: block {root.hex()[:16]} is not a child "
                                 f"of {parent.hex()[:16]} at its slot ({node})")
            parent = root
        last = chain.state_for_block(roots[-1])
        if last.hash_tree_root() != cell["post_roots"][-1]:
            raise SystemExit(f"chain import [{route}]: last post-state root differs")
    if results["native"]["roots"] != results["device"]["roots"]:
        raise SystemExit("the two final exponentiation routes imported different roots")
    plain = results["native"]["chain"].state_for_block(results["native"]["roots"][-1]).copy()
    plain._tree_cache = None
    saved = sha._DEVICE_MIN_PAIRS, sha._DEVICE_FOLD_MIN_LEAVES
    sha._DEVICE_MIN_PAIRS = sha._DEVICE_FOLD_MIN_LEAVES = 1 << 62
    host_root = plain.hash_tree_root(dev)
    sha._DEVICE_MIN_PAIRS, sha._DEVICE_FOLD_MIN_LEAVES = saved
    del plain
    if host_root != cell["post_roots"][-1]:
        raise SystemExit(f"last post-state root {cell['post_roots'][-1].hex()} != hashlib "
                         f"{host_root.hex()}")
    reasons = {}
    for want, bad in T.tampered_blocks(cell).items():
        chain = new_chain()
        chain.slot_clock.set_slot(int(bad.message.slot))
        try:
            chain.process_block(bad)
            reasons[want] = "imported"
        except BlockError as e:
            reasons[want] = e.reason
    if any(want != got for want, got in reasons.items()):
        raise SystemExit(f"tampered blocks gave the wrong reasons: {reasons}")
    log(f"imports: each block a child of its parent in fork choice, both routes the same roots, "
        f"the last post-state root == hashlib {host_root.hex()}; tampered blocks rejected "
        f"{reasons}")
    blob_block_import(torch, dev, cell, results["native"]["chain"], results["device"]["chain"],
                      kzg_settings)

    final_exp_ms = {}
    for route, r in results.items():
        _final_exp_route(route == "device")
        ledgers = []
        for _ in range(FINAL_EXP_STAGE_RUNS):
            ledgers.append({})
            verify_once(ledger=ledgers[-1])
        final_exp_ms[route] = [lg["bls"]["final_exp"] * 1e3 for lg in ledgers]
        ledger = ledgers[0]
        bls_st = ledger.get("bls", {})
        stages = {"shuffle": ledger.get("shuffle", 0.0), "sets": ledger.get("sets", 0.0),
                  "verify": ledger.get("verify", 0.0),
                  "verify.aggregate": bls_st.get("aggregate", 0.0),
                  "verify.pipeline": bls_st.get("pipeline", 0.0) + bls_st.get("limbs", 0.0),
                  "verify.final_exp": bls_st.get("final_exp", 0.0),
                  "verify.other": (bls_st.get("subgroup", 0.0) + bls_st.get("prep_host", 0.0)),
                  "transition": ledger["total"] - ledger.get("shuffle", 0.0)
                  - ledger.get("sets", 0.0) - ledger.get("verify", 0.0)}
        imp = {k: statistics.median(t[k] for t in r["times"]) * 1e3
               for k in ("gossip", "signatures", "copy", "advance", "transition", "state_root",
                         "import", "head", "total")}
        met = "met" if r["p50"] <= BLOCK_VERIFY_LIMIT_MS else "not met"
        log(json.dumps({"route": route, "block_verify_p50_ms": r["p50"],
                        "block_verify_runs_ms": r["runs"], "block_verify_cold_ms": r["cold_ms"],
                        "block_verify_limit_ms": BLOCK_VERIFY_LIMIT_MS, "limit": met,
                        "block_verify_stages_ms": {k: v * 1e3 for k, v in stages.items()},
                        "block_import_p50_ms": r["import_p50"],
                        "block_import_ms": [t["total"] * 1e3 for t in r["times"]],
                        "block_import_stages_p50_ms": imp}))
    _final_exp_route(None)
    p50 = {route: statistics.median(v) for route, v in final_exp_ms.items()}
    below = 1 - p50["device"] / p50["native"]
    log(json.dumps({"final_exp_default_route": _default_route(dev),
                    "verify_final_exp_ms": final_exp_ms, "verify_final_exp_p50_ms": p50,
                    "device_below_native": below, "device_25pct_below_native": below >= 0.25}))
    log(f"final exponentiation route with LHGPU_DEVICE_FINAL_EXP unset on this card: "
        f"{_default_route(dev)}; the block verify's final_exp stage on the device route is "
        f"{100 * below:.1f}% below the native host's (p50 of {FINAL_EXP_STAGE_RUNS} runs each): "
        f"the rule for a device default (at least 25% below) is "
        f"{'met' if below >= 0.25 else 'not met'}")
    log(f"caches: block_verify_cold_ms is the first process_block of the run (hash-to-G2 of its "
        f"{n_sets} messages and the member keys' Montgomery words computed); the "
        f"{BLOCK_VERIFY_RUNS} runs repeat the same block (hash-to-G2 and key words cached; "
        f"signatures decompressed and subgroup-checked anew each run); block_import hashes every message anew on each route "
        f"(the hash-to-G2 cache cleared before it); the registry's keys are decompressed once, "
        f"at the cell's build")

    # one traced import of the first block per final exponentiation route
    # (a fresh chain each, the counts of the traced import only), then a
    # cProfiled one
    names = {"pipeline_device": ("k_gj_scalar_mul", "k_miller"), "g2_subgroup_device":
             ("k_g2_subgroup",), "blinded_fold_device": ("k_blinded_final",),
             "hash_pairs_device": ("k_hash_pairs",), "final_exp_hard_device": ("k_final_exp_hard",),
             "shuffle_rounds": ("k_shuffle_rounds",), "sha256_block_device": ("k_sha256_block",),
             "fq12_mul_device": ("k_fq12_mul",), "fold_levels_device": ("k_hash_pairs",),
             "fold_to_root_device": ("k_fold_subtrees",)}
    def import_step():
        chain = new_chain()
        chain.slot_clock.set_slot(int(b0.slot))
        bb.reset_launches()
        sha.reset_launches()
        ek.reset_launches()
        t12.final_exp_hard_device.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain.process_block(blocks[0])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for route in ("native", "device"):
        _final_exp_route(route == "device")
        busy, spans, device_us, wall_ms = traced("block_import", import_step)
        launched = {k: v for k, v in launches().items() if v}
        lost = [k for fn, ks in names.items() if launched.get(fn) for k in ks
                if not any(name.startswith(k) for name in device_us)]
        log(f"traced import of block 1 [{route}]: wall {wall_ms:.1f} ms, device busy "
            f"{busy:.3f} ms ({100 * (1 - busy / wall_ms):.1f}% idle; {spans} device spans); "
            f"wrapper launches in the traced import {launched}; device time by name (us) "
            f"{[(k, round(v, 1)) for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])][:8]}")
        if lost:
            raise SystemExit(f"the traced import [{route}] lacks kernels the wrappers launched: "
                             f"{lost}")
        if route == "device" and not launched.get("final_exp_hard_device"):
            raise SystemExit("the traced import on the device route launched no row 9")
    _final_exp_route(None)
    chain = new_chain()
    chain.slot_clock.set_slot(int(b0.slot))
    log(f"host profile of one block import, top 5 by own time (ms): "
        f"{host_top5(lambda: chain.process_block(blocks[0]))}")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


BLOB_SEED = 20240319


def blob_block_import(torch, dev, cell, first, second, settings) -> None:
    """Phase 15, the block with blobs (queue A 10): ``testing.blob_block_cell``'s
    full block after the cell's last, with 6 blobs of width 4096 and their
    sidecars, into two chains that hold the cell's blocks: into ``first``
    block first (it waits; the sixth sidecar imports it), into ``second``
    sidecars first.  Before that, tampered sidecars on ``first`` must give
    the JAX package's reasons and mark nothing.  Launch counts are read over
    the two imports."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.chain.blob_verification import BlobError
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.ops import bls12_381 as t12
    from lighthouse_tpu_torch.ops import bls_backend as bb
    from lighthouse_tpu_torch.ops import epoch_kernels as ek
    from lighthouse_tpu_torch.ops import sha256 as sha

    t0 = time.perf_counter()
    blob = T.blob_block_cell(cell, settings, KZG_BLOCK_BLOBS, BLOB_SEED)
    signed, sidecars = blob["block"], blob["sidecars"]
    slot = int(signed.message.slot)
    root = signed.message.hash_tree_root(dev)
    log(f"blob block: slot {slot}, {len(sidecars)} blobs of {settings.width} field elements, "
        f"{len(signed.message.body.attestations)} attestations; built in "
        f"{time.perf_counter() - t0:.1f} s, of which the commitments and proofs "
        f"{blob['kzg_s']:.1f} s")
    for c in (first, second):
        c.slot_clock.set_slot(slot)

    def variant(edit):
        sc = sidecars[0].copy()
        edit(sc)
        return sc

    def set_branch(sc):
        proof = [bytes(b) for b in sc.kzg_commitment_inclusion_proof]
        proof[3] = b"\x5a" * 32
        sc.kzg_commitment_inclusion_proof = proof

    header = sidecars[0].signed_block_header.message
    n_val = len(cell["state"].validators)
    tampered = {
        "invalid_kzg_proof": variant(lambda sc: setattr(sc, "kzg_proof",
                                                        bytes(sidecars[1].kzg_proof))),
        "invalid_subnet_index": variant(lambda sc: setattr(sc, "index", KZG_BLOCK_BLOBS)),
        "invalid_inclusion_proof (index)": variant(lambda sc: setattr(sc, "index", 1)),
        "invalid_inclusion_proof (branch)": variant(set_branch),
        "invalid_proposer": variant(lambda sc: setattr(
            sc.signed_block_header.message, "proposer_index",
            (int(header.proposer_index) + 1) % n_val)),
    }
    reasons = {}
    for want, sc in tampered.items():
        try:
            first.process_gossip_blob(sc)
            reasons[want] = "accepted"
        except BlobError as e:
            reasons[want] = e.reason
    if any(want.split(" ")[0] != got for want, got in reasons.items()):
        raise SystemExit(f"tampered sidecars gave the wrong reasons: {reasons}")

    # the main path, counted: both arrival orders
    path = (*bb.KERNELS, t12.final_exp_hard_device, *kzg.KERNELS, *sha.KERNELS,
            sha.sha256_block_device, *ek.KERNELS)
    for k in path:
        k.launches = 0
    kzg.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got_first = [first.process_block(signed)]
    missing = first.da_checker.missing_blob_indices(root)
    got_first += [first.process_gossip_blob(sc) for sc in sidecars]
    torch.cuda.synchronize()
    block_first_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    got_second = [second.process_gossip_blob(sc) for sc in sidecars]
    got_second.append(second.process_block(signed))
    torch.cuda.synchronize()
    sidecars_first_ms = (time.perf_counter() - t) * 1e3
    launched = {k.__name__: k.launches for k in path}
    miller_calls = t12.miller_reduce_device.calls

    if got_first != [None] * KZG_BLOCK_BLOBS + [root] or missing != list(range(KZG_BLOCK_BLOBS)):
        raise SystemExit(f"block first: returns {[r and r.hex()[:16] for r in got_first]}, "
                         f"missing {missing}")
    if got_second != [None] * KZG_BLOCK_BLOBS + [root]:
        raise SystemExit(f"sidecars first: returns {[r and r.hex()[:16] for r in got_second]}")
    want_blobs = b"".join(sc.serialize() for sc in sidecars)
    parent = bytes(signed.message.parent_root)
    for name, c in (("block first", first), ("sidecars first", second)):
        if c.head_root != root or c.fork_choice.proto.node(root)["parent"] != parent:
            raise SystemExit(f"{name}: the head did not move to the blob block")
        if c.state_for_block(root).hash_tree_root() != blob["post_root"]:
            raise SystemExit(f"{name}: post-state root != the block's state root")
        if c.get_blobs(root) != want_blobs or len(c.da_checker) or c._pending_executed:
            raise SystemExit(f"{name}: the blobs were not kept, or the checker still waits")
    plain = first.state_for_block(root).copy()
    plain._tree_cache = None
    saved = sha._DEVICE_MIN_PAIRS, sha._DEVICE_FOLD_MIN_LEAVES
    sha._DEVICE_MIN_PAIRS = sha._DEVICE_FOLD_MIN_LEAVES = 1 << 62
    host_root = plain.hash_tree_root(dev)
    sha._DEVICE_MIN_PAIRS, sha._DEVICE_FOLD_MIN_LEAVES = saved
    del plain
    if host_root != blob["post_root"]:
        raise SystemExit(f"blob block post-state root {blob['post_root'].hex()} != hashlib "
                         f"{host_root.hex()}")
    try:
        first.process_gossip_blob(sidecars[0])
        repeat = "accepted"
    except BlobError as e:
        repeat = e.reason
    if repeat != "repeat_blob":
        raise SystemExit(f"a repeated sidecar gave {repeat}, not repeat_blob")
    if not miller_calls or kzg.kzg_fused_device.launches or not launched["pipeline_device"]:
        raise SystemExit(f"the blob imports' kernels: {launched}, row 10 calls {miller_calls}")
    log(f"blob block imported in both orders: the head moved to it, post-state root == hashlib "
        f"{host_root.hex()}, the 6 blobs kept; tampered sidecars rejected {reasons}; a repeated "
        f"sidecar: {repeat}")
    times = [c.blob_times[(root, i)] for c in (first, second) for i in range(KZG_BLOCK_BLOBS)]
    stages = {k: statistics.median(t[k] for t in times) * 1e3
              for k in ("gossip", "proposer", "signature", "kzg", "commit", "total")}
    log(json.dumps({"blob_block_import_ms": {"block_first": block_first_ms,
                                             "sidecars_first": sidecars_first_ms},
                    "gossip_blob_p50_ms": stages["total"],
                    "gossip_blob_stages_p50_ms": stages,
                    "gossip_blob_ms": [t["total"] * 1e3 for t in times],
                    "launches": launched, "miller_reduce_calls": miller_calls}))
    log(f"at one blob a call the KZG check takes the unfused path (below "
        f"{kzg._DEVICE_EVAL_MIN} blobs): row 10 (lh_miller) {miller_calls} calls, row 9 "
        f"{launched['final_exp_hard_device']} launches; rows 14-16 "
        f"{[launched[k] for k in ('kzg_fused_device', 'eval_device', 'fr_to_mont_device')]}")


SHARD_COUNTS = (1, 2, 4)           # mesh sizes of phase 16 on the one card
SHARD_TIMED_RUNS = 3               # sharded block verifies per mesh for the p50
SHARD_CHUNK = 64                   # the chunked sharded run's chunk size


def sharded_phase(torch, np, dev, table, max_mhz, int32_ops_per_s, block, inputs) -> None:
    """Phase 16: the multi-device rungs over meshes that name the card 1 to 4
    times (the shards of one mesh run one after another on it)."""
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import bls12_381 as t12
    from lighthouse_tpu_torch.ops import bls_backend as bb
    from lighthouse_tpu_torch.ops import bls_cuda, pubkey_kernels
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import sha256 as sha
    from lighthouse_tpu_torch.parallel import bls_sharded as bs
    from lighthouse_tpu_torch.parallel import dryrun_worker as dw
    from lighthouse_tpu_torch.parallel import epoch_sharded as es
    from lighthouse_tpu_torch.parallel import msm_sharded as ms
    from lighthouse_tpu_torch.state_transition import epoch_device

    t_phase = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    imad_per_s = props.multi_processor_count * IMAD_LANES_PER_SM * max_mhz * 1e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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

    def once_ms(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def bound(ops_ms: float, nbytes: int) -> tuple[float, str]:
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    def rows_err(got, want) -> int:
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise SystemExit(f"shape {list(got.shape)} != {list(want.shape)}")
        return int((bi.u64(got) - bi.u64(want)).abs().max())

    # -- 16a. row 19 against its plain version on the block batch's pairs ------
    t0 = time.perf_counter()
    pairs = bb.prepare_pairs(T.fresh(block))
    log(f"phase 16: prepare_pairs of the block batch ({len(pairs)} pairs) "
        f"{time.perf_counter() - t0:.2f} s on the host")
    row19 = {}
    for n_dev in SHARD_COUNTS:
        mesh = [dev] * n_dev
        cols, mask = bs.lane_columns(pairs, n_dev)
        cols, mask = tuple(c.to(dev) for c in cols), mask.to(dev)
        got = bs.sharded_miller_reduce(cols, mask, mesh)
        want, plain_ms = once_ms(lambda: bs.sharded_miller_reduce_plain(cols, mask, mesh))
        err = rows_err(got, want)
        if err != 0:
            raise SystemExit(f"sharded_miller_reduce [mesh of {n_dev}]: kernels disagree with "
                             f"the plain version (max err {err})")
        ms_ = cuda_ms(lambda: bs.sharded_miller_reduce(cols, mask, mesh), 5)
        m = mask.cpu().numpy()
        per = m.shape[0] // n_dev
        live = [m[i * per:(i + 1) * per] for i in range(n_dev)]
        fp_muls = (sum(bls_cuda.miller_reduce_fp_muls(x) for x in live)
                   + bls_cuda.tree_products(np.array([x.any() for x in live]))[0]
                   * bls_cuda.FP12_MUL)
        bound_ms, bound_by = bound(fp_muls * bls_cuda.IMADS_PER_FP_MUL / imad_per_s * 1e3,
                                   m.shape[0] * (2 * 48 + 2 * 96 + 1) + 576)
        row19[n_dev] = dict(err=err, ms=ms_, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, got=got)
        log(f"kernel sharded_miller_reduce [mesh of {n_dev} x {per} lanes, {len(pairs)} live]: "
            f"== plain (max err {err}); {ms_:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {fp_muls} Fp products)")
    one = t12.fq12_from_words(bi.to_numpy(row19[1]["got"]).reshape(12, 12))
    if any(t12.fq12_from_words(bi.to_numpy(r["got"]).reshape(12, 12)) != one
           for r in row19.values()):
        raise SystemExit("sharded_miller_reduce: the meshes of 1, 2 and 4 give other products")
    # edges: one pair over 4 shards (three all masked); chunked against monolithic
    cols, mask = bs.lane_columns(pairs[:1], 4)
    cols, mask = tuple(c.to(dev) for c in cols), mask.to(dev)
    err = rows_err(bs.sharded_miller_reduce(cols, mask, [dev] * 4),
                   bs.sharded_miller_reduce_plain(cols, mask, [dev] * 4))
    if err != 0:
        raise SystemExit(f"sharded_miller_reduce [1 pair over 4]: max err {err}")
    chunked = bs.multi_pairing_sharded(pairs, [dev] * 4, chunk_size=SHARD_CHUNK)
    mono = bs.multi_pairing_sharded(pairs, [dev] * 4, chunk_size=0)
    if chunked != mono or not mono.is_one():
        raise SystemExit("multi_pairing_sharded: chunked and monolithic products differ, or "
                         "the valid block batch's product is not one")
    log(f"sharded_miller_reduce: meshes of {SHARD_COUNTS} give one product; one pair over 4 "
        f"shards == plain; chunked ({SHARD_CHUNK}) == monolithic, and one")
    del row19[1]["got"], row19[2]["got"], row19[4]["got"], cols, mask

    # -- 16b. the main path: the sharded backend and the dry run, counted -------
    def verify(sets, mesh, ledger=None):
        t = time.perf_counter()
        ok = bs.verify_signature_sets_sharded(sets, mesh=mesh, ledger=ledger)
        return ok, (time.perf_counter() - t) * 1e3

    t12.miller_reduce_device.launches = t12.miller_reduce_device.calls = 0
    bs.sharded_miller_reduce.launches = bs.sharded_miller_reduce.calls = 0
    dw.sharded_fold_to_root.launches = dw.sharded_fold_to_root.calls = 0
    sha.reset_launches()
    runs = {}
    ledgers = {}
    api_ok = bls.verify_signature_sets(T.fresh(block), backend="sharded")
    for n_dev in (1, 4):
        ledgers[n_dev] = {}
        runs[n_dev] = [verify(T.fresh(block), [dev] * n_dev, ledgers[n_dev])
                       for _ in range(SHARD_TIMED_RUNS)]
    leaves = inputs["registry_leaves"]
    full_root = dw.merkle_dryrun([dev] * 4, leaves)
    dry = dw.dryrun_multichip(4, dev)
    launched = {"sharded_miller_reduce": bs.sharded_miller_reduce.launches,
                "miller_reduce (row 10 inside)": t12.miller_reduce_device.launches,
                "sharded_fold_to_root": dw.sharded_fold_to_root.launches,
                "fold_to_root (row 3 inside)": sha.fold_to_root_device.launches}
    CALLS["sharded_miller_reduce"] = bs.sharded_miller_reduce.calls
    CALLS["sharded_merkle_fold"] = dw.sharded_fold_to_root.calls
    if not (api_ok and all(ok for v in runs.values() for ok, _ in v)):
        raise SystemExit(f"the block batch failed on the sharded backend: api {api_ok}, "
                         f"runs {runs}")
    idle = [k for k, v in launched.items() if v == 0]
    if idle:
        raise SystemExit(f"kernels never launched on the sharded path: {idle}")
    for n_dev in (1, 4):
        p50 = statistics.median(t for _, t in runs[n_dev])
        stages = {k: round(v / SHARD_TIMED_RUNS * 1e3, 2) for k, v in ledgers[n_dev].items()}
        log(f"sharded block batch, mesh of {n_dev} on one card: runs "
            f"{[round(t, 1) for _, t in runs[n_dev]]} ms -> p50 {p50:.1f} ms; mean stages (ms) "
            f"{stages}")
    log(f"dry run over a mesh of 4: {dry['mesh']}, root {dry['root'][:16]}..., "
        f"{dry['seconds']:.2f} s; launches over the sharded path {launched}")

    # checks after the counted run
    cuda_ok = bls.verify_signature_sets(T.fresh(block), backend="cuda", device=dev)
    swapped = T.fresh(block)
    swapped[0].signature, swapped[1].signature = swapped[1].signature, swapped[0].signature
    nokey = T.fresh(block)
    nokey[0] = api.SignatureSet(nokey[0].signature, [], nokey[0].message)
    verdicts = {"wrong message": verify(T.with_wrong_message(T.fresh(block), 7), [dev] * 4)[0],
                "swapped signatures": verify(swapped, [dev] * 4)[0],
                "empty batch": verify([], [dev] * 4)[0],
                "a set with no pubkeys": verify(nokey, [dev] * 4)[0]}
    if not cuda_ok or any(verdicts.values()):
        raise SystemExit(f"sharded verdicts: cuda backend {cuda_ok}, tampered {verdicts}")
    log(f"the block batch verifies on sharded (meshes 1, 4, and the api's default mesh) and "
        f"on cuda; tampered and empty batches read False on sharded {verdicts}")

    # -- 16c. row 20 against its plain version and hashlib ------------------------
    # (merkle_dryrun above held the full-width root to hashlib already)
    single = sha.to_numpy(sha.fold_to_root_device(sha.to_tensor(leaves, dev)))
    if not np.array_equal(full_root, single):
        raise SystemExit("sharded merkle fold at full width: root differs from the "
                         "single-device fold")
    row20 = {}
    for label, n_dev, words in (("JAX shape", 4, None), ("JAX shape", 3, None),
                                ("JAX shape", 2, None), ("JAX shape", 1, None),
                                (f"{leaves.shape[0]} validator roots", 4, leaves)):
        if words is None:
            n = n_dev * dw.LEAVES_PER_SHARD
            words = np.arange(n * 8, dtype=np.uint32).reshape(n, 8)
        want_root = full_root if words is leaves else dw.host_root(words, n_dev)
        x = sha.to_tensor(words, dev)
        mesh = [dev] * n_dev
        got = dw.sharded_fold_to_root(x, mesh)
        want, plain_ms = once_ms(lambda: dw.sharded_fold_to_root_plain(x, mesh))
        err = rows_err(got, want)
        if err != 0 or not np.array_equal(sha.to_numpy(got), want_root):
            raise SystemExit(f"sharded merkle fold [{label}, mesh of {n_dev}]: kernels "
                             f"disagree with the plain version or hashlib (max err {err})")
        ms_ = cuda_ms(lambda: dw.sharded_fold_to_root(x, mesh), 10)
        top_n = 1 << max(n_dev - 1, 0).bit_length()
        n_pairs = words.shape[0] - n_dev + top_n - 1
        bound_ms, bound_by = bound(n_pairs * sha.OPS_PER_PAIR / int32_ops_per_s * 1e3,
                                   words.shape[0] * 32 + 32)
        row20[(label, n_dev)] = dict(err=err, ms=ms_, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
        log(f"kernel sharded merkle fold [{label}: {words.shape[0]} leaves, mesh of {n_dev}]: "
            f"== plain == hashlib (max err {err}); {ms_:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {n_pairs} pairs)")
    full20 = row20[(f"{leaves.shape[0]} validator roots", 4)]

    # -- 16d. the epoch pass and the gather fold over a mesh of 4 ----------------
    args = inputs["epoch_args"]
    t0 = time.perf_counter()
    got = es.epoch_pass_sharded(*args, mesh=[dev] * 4)
    shard_s = time.perf_counter() - t0
    want = epoch_device.epoch_pass(*args, dev)
    if any(not np.array_equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("epoch_pass_sharded over 4: scores, balances or effective balances "
                         "differ from the single-device pass")
    fold = inputs["fold"]
    reps = FULL_TABLE_ROWS // fold["rows"][0].shape[0]
    ftable = tuple(bi.to_tensor(np.tile(r, (reps, 1)), dev) for r in fold["rows"])
    fargs = (fold["lanes"], np.asarray(fold["scalars"], np.uint64), fold["groups"], FULL_GROUPS)
    t0 = time.perf_counter()
    got = ms.gather_fold_sharded(ftable, *fargs, mesh=[dev] * 4)
    fold_s = time.perf_counter() - t0
    want = pubkey_kernels.gather_fold(ftable, *fargs)
    if any(not np.array_equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("gather_fold_sharded over 4: the points differ from the single-device "
                         "gather_fold")
    peak = torch.cuda.max_memory_allocated()
    log(f"epoch_pass_sharded over 4 ({args[0]['balances'].shape[0]} rows, {shard_s * 1e3:.1f} ms "
        f"host wall) == the single-device pass; gather_fold_sharded over 4 ({FLOOD_ATTS} lanes, "
        f"{FULL_GROUPS} groups, {FULL_TABLE_ROWS}-row table; {fold_s * 1e3:.1f} ms host wall) == "
        f"the single-device fold; max_memory_allocated over phase 16 {peak} bytes")
    if peak >= 8e9:
        raise SystemExit(f"phase 16 peak device memory {peak} bytes is not under 8 GB")

    r19 = row19[4]
    table["sharded_miller_reduce"] = dict(
        name="sharded_miller_reduce", route="cuda",
        source="lighthouse_tpu_torch/csrc/bls12_381.cu",
        replaces="lighthouse_tpu/parallel/bls_sharded.py:39",
        launches=launched["sharded_miller_reduce"], max_abs_err=r19["err"], ms=r19["ms"],
        plain_ms=r19["plain_ms"], bound_ms=r19["bound_ms"], bound_by=r19["bound_by"],
        library_ms=None)
    table["sharded_merkle_fold"] = dict(
        name="sharded_merkle_fold", route="cuda", source="lighthouse_tpu_torch/csrc/sha256.cu",
        replaces="lighthouse_tpu/parallel/dryrun_worker.py:40",
        launches=launched["sharded_fold_to_root"], max_abs_err=full20["err"], ms=full20["ms"],
        plain_ms=full20["plain_ms"], bound_ms=full20["bound_ms"], bound_by=full20["bound_by"],
        library_ms=None)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
