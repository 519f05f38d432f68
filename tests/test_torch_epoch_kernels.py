"""The port's epoch kernels and single-block SHA-256
(``lighthouse_tpu_torch.ops.epoch_kernels``, ``ops.sha256.sha256_block``)
against the JAX package's programs, the spec's scalar shuffle and hashlib.

On the CPU each wrapper runs its plain PyTorch version.  The kernels'
per-lane code (``csrc/epoch.cuh``, ``csrc/sha256.cuh``) is also built for
the host with g++ and held to the plain versions, which checks the CUDA
kernels' arithmetic without a card; the test marked ``cuda`` runs the
kernels themselves.  Every comparison is exact (tolerance 0): all of it is
integer arithmetic.

The JAX package's ``ops/epoch_kernels.py`` imports ``enable_x64`` from
``jax.experimental``, a name the installed JAX no longer has (it has
``jax.enable_x64``).  The fixture ``jax_ek`` sets the old name for the
length of a test, imports the JAX module, and removes both afterwards, so
that nothing else in the process sees a changed JAX package.
"""

import ctypes
import hashlib
import importlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import sha256 as jsha
from lighthouse_tpu.state_transition import shuffle as jshuffle
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.ops import epoch_kernels as ek
from lighthouse_tpu_torch.ops import sha256 as tsha
from lighthouse_tpu_torch.state_transition import shuffle as tshuffle

CPU = torch.device("cpu")
JAX_EK = "lighthouse_tpu.ops.epoch_kernels"

HARNESS = r"""
#include "epoch.cuh"
#include "sha256.cuh"
extern "C" {
void h_epoch(long n, int k, const int64_t* reward, const int64_t* penalty, const int64_t* slash,
             const int64_t* params, const int32_t* eff_incr, const int64_t* balances,
             const int64_t* scores, const uint8_t* prev_part, const uint8_t* slashed,
             const int64_t* activation, const int64_t* exit_epoch, const int64_t* withdrawable,
             int64_t* sc, int64_t* bal, int64_t* eff) {
    const epoch::EpochCols c{eff_incr, balances, scores, prev_part, slashed, activation,
                             exit_epoch, withdrawable, sc, bal, eff};
    const epoch::EpochTables t{reward, penalty, slash, params};
    for (long i = 0; i < n; i++)
        epoch::lane_fused_epoch_pass(i, k, t, c);
}
// k_fused_epoch_pass's grid of blocks x threads; -1 if a pair's load or
// store is not aligned to its width
int h_epoch_kernel(long n, int k, const int64_t* reward, const int64_t* penalty,
                   const int64_t* slash, const int64_t* params, const int32_t* eff_incr,
                   const int64_t* balances, const int64_t* scores, const uint8_t* prev_part,
                   const uint8_t* slashed, const int64_t* activation, const int64_t* exit_epoch,
                   const int64_t* withdrawable, int64_t* sc, int64_t* bal, int64_t* eff,
                   long blocks, int threads) {
    const epoch::EpochCols c{eff_incr, balances, scores, prev_part, slashed, activation,
                             exit_epoch, withdrawable, sc, bal, eff};
    return epoch::host_fused_epoch_pass(n, k, reward, penalty, slash, params, c, blocks,
                                        threads);
}
// (head, pairs) of epoch_split, as head * 10^6 + pairs
long long h_epoch_split(long n, const void* const* cols) {
    const epoch::EpochCols c{static_cast<const int32_t*>(cols[0]),
                             static_cast<const int64_t*>(cols[1]),
                             static_cast<const int64_t*>(cols[2]),
                             static_cast<const uint8_t*>(cols[3]),
                             static_cast<const uint8_t*>(cols[4]),
                             static_cast<const int64_t*>(cols[5]),
                             static_cast<const int64_t*>(cols[6]),
                             static_cast<const int64_t*>(cols[7]),
                             static_cast<int64_t*>(const_cast<void*>(cols[8])),
                             static_cast<int64_t*>(const_cast<void*>(cols[9])),
                             static_cast<int64_t*>(const_cast<void*>(cols[10]))};
    const epoch::EpochSplit s = epoch::epoch_split(n, c);
    return s.head * 1000000 + s.pairs;
}
int h_shuffle(long count, int rounds, long row_bytes, const int32_t* pivots,
              const uint8_t* src, int32_t* out) {
    return epoch::host_shuffle_rounds(count, rounds, row_bytes, pivots, src, out, 16,
                                      epoch::SHUFFLE_THREADS, 0);
}
// k_shuffle_rounds's schedule: its plan on a card holding max_clusters
// clusters of blocks of `threads` (cluster 0: the kernel's own choice),
// each lookup through the round's window in slices; -1 if a window outgrew
// its bound or a lookup read a byte no copy wrote
int h_shuffle_kernel(long count, int rounds, long row_bytes, const int32_t* pivots,
                     const uint8_t* src, int32_t* out, long max_clusters, int threads,
                     int cluster) {
    return epoch::host_shuffle_rounds(count, rounds, row_bytes, pivots, src, out, max_clusters,
                                      threads, cluster);
}
long long h_shuffle_capacity() { return epoch::SHUFFLE_CAPACITY; }
// the plan's cluster size and row buffers for `count` positions
int h_shuffle_layout(long count) {
    const epoch::ShufflePlan p = epoch::shuffle_plan(count, 16, epoch::SHUFFLE_THREADS);
    return p.cluster * 10 + p.stages;
}
void h_sha256_block(long n, const uint32_t* state, const uint32_t* block, uint32_t* out) {
    for (long i = 0; i < n; i++) sha::lane_sha256_block(i, state, block, out);
}
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def jax_ek(monkeypatch):
    """The JAX package's ``ops/epoch_kernels`` module, importable for the
    length of the test (see the module docstring)."""
    import jax.experimental
    import lighthouse_tpu.ops as jops
    from lighthouse_tpu.ops import program_store

    had = JAX_EK in sys.modules
    registered = dict(program_store._REGISTERED)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    yield importlib.import_module(JAX_EK)
    if not had:
        sys.modules.pop(JAX_EK, None)
        if hasattr(jops, "epoch_kernels"):
            delattr(jops, "epoch_kernels")
        program_store._REGISTERED.clear()
        program_store._REGISTERED.update(registered)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """The headers' lane functions built for the host."""
    d = tmp_path_factory.mktemp("epoch_lanes")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{native.CSRC}", str(d / "harness.cc"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_shuffle_capacity.restype = ctypes.c_longlong
    lib.h_epoch_split.restype = ctypes.c_longlong
    return lib


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

K = 33          # Deneb: MAX_EFFECTIVE_BALANCE / EFFECTIVE_BALANCE_INCREMENT + 1
PREV = 40


def _epoch_inputs(n: int, seed: int, *, leak: bool, rewards: bool = True):
    """Seeded columns, tables and params that reach every branch of the
    pass: lanes active, exited and not yet active, slashed lanes on and off
    the slashings target, all flag patterns, scores at 0 and above, and
    balances small enough that penalties and slashings drive some to 0."""
    rng = np.random.default_rng(seed)
    incr = 10**9
    far = 1 << 62
    slash_target = PREV + 1 + 32
    eff_incr = rng.integers(0, K, n).astype(np.int32)
    cols = {
        "eff_incr": eff_incr,
        "balances": np.where(rng.random(n) < 0.1, rng.integers(0, 3 * 10**6, n),
                             eff_incr.astype(np.int64) * incr
                             + rng.integers(-2 * 10**9, 2 * 10**9, n)).clip(0).astype(np.int64),
        "scores": np.where(rng.random(n) < 0.2, 0, rng.integers(0, 400, n)).astype(np.int64),
        "prev_part": rng.integers(0, 8, n).astype(np.uint8),
        "slashed": (rng.random(n) < 0.15).astype(np.uint8),
        "activation": rng.choice([0, PREV - 1, PREV, PREV + 1, far], n).astype(np.int64),
        "exit_epoch": rng.choice([PREV - 2, PREV, PREV + 1, PREV + 9, far], n).astype(np.int64),
        "withdrawable": rng.choice([PREV, PREV + 1, PREV + 2, slash_target, far],
                                   n).astype(np.int64),
    }
    tables = {
        "reward": np.zeros((3, K), np.int64) if leak
        else rng.integers(0, 10**7, (3, K)).astype(np.int64),
        "penalty": rng.integers(0, 10**7, (3, K)).astype(np.int64),
        "slash": np.arange(K, dtype=np.int64) * rng.integers(10**8, 10**9),
    }
    tables["penalty"][2] = 0
    params = np.array([PREV, int(leak), 4, 16, 4 * 2**24, slash_target, incr, incr // 4,
                       5 * incr // 4, 32 * incr, int(rewards)], np.int64)
    return cols, tables, params


def _tensors(cols, tables, params, dev=CPU):
    from lighthouse_tpu_torch.state_transition.epoch_device import COLUMNS

    args = [torch.from_numpy(cols[c].copy()).to(dev) for c in COLUMNS]
    args += [torch.from_numpy(a.copy()).to(dev)
             for a in (tables["reward"], tables["penalty"], tables["slash"], params)]
    return args


# --------------------------------------------------------------------------
# fused epoch pass
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [200, 777])
@pytest.mark.parametrize("leak", [False, True])
def test_fused_epoch_pass_matches_jax(jax_ek, n, leak):
    cols, tables, params = _epoch_inputs(n, seed=n + leak, leak=leak)
    got = [t.numpy() for t in ek.fused_epoch_pass(*_tensors(cols, tables, params))]
    jcols = dict(cols, slashed=cols["slashed"].astype(bool))
    want = jax_ek.epoch_pass_device(jcols, tables, params[:jax_ek.N_PARAMS], apply_eb=True)
    for g, w, name in zip(got, want, ("scores", "balances", "effective balances")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert ((cols["balances"] > 0) & (got[1] == 0)).any()     # balances driven to zero


def test_param_layout_matches_jax(jax_ek):
    for name in ("P_PREV_EPOCH", "P_LEAK", "P_SCORE_BIAS", "P_SCORE_RECOVERY", "P_INACT_DENOM",
                 "P_SLASH_TARGET", "P_INCREMENT", "P_HYST_DOWN", "P_HYST_UP", "P_MAX_EFF"):
        assert getattr(ek, name) == getattr(jax_ek, name), name
    assert ek.N_PARAMS == jax_ek.N_PARAMS + 1 and ek.P_REWARDS == jax_ek.N_PARAMS


def test_fused_epoch_pass_genesis_gate_runs_only_slashings_and_hysteresis():
    """P_REWARDS = 0 (the genesis epoch): scores pass through; balances see
    only proportional slashings, then hysteresis."""
    cols, tables, params = _epoch_inputs(300, seed=5, leak=False, rewards=False)
    sc, bal, eff = (t.numpy() for t in ek.fused_epoch_pass(*_tensors(cols, tables, params)))
    np.testing.assert_array_equal(sc, cols["scores"])
    hit = (cols["slashed"] == 1) & (cols["withdrawable"] == params[ek.P_SLASH_TARGET])
    assert hit.any()
    want_bal = np.where(hit, np.maximum(cols["balances"] - tables["slash"][cols["eff_incr"]], 0),
                        cols["balances"])
    np.testing.assert_array_equal(bal, want_bal)
    e = cols["eff_incr"].astype(np.int64) * 10**9
    update = (want_bal + 10**9 // 4 < e) | (e + 5 * 10**9 // 4 < want_bal)
    np.testing.assert_array_equal(
        eff, np.where(update, np.minimum(want_bal - want_bal % 10**9, 32 * 10**9), e))


@pytest.mark.parametrize("n,leak,rewards", [(200, False, True), (777, True, True),
                                            (300, False, False)])
def test_epoch_lane_matches_plain(lanes, n, leak, rewards):
    cols, tables, params = _epoch_inputs(n, seed=3 * n, leak=leak, rewards=rewards)
    want = [t.numpy() for t in ek.fused_epoch_pass(*_tensors(cols, tables, params))]
    got = [np.zeros(n, np.int64) for _ in range(3)]
    from lighthouse_tpu_torch.state_transition.epoch_device import COLUMNS

    lanes.h_epoch(ctypes.c_long(n), ctypes.c_int(K), _ptr(tables["reward"]),
                  _ptr(tables["penalty"]), _ptr(tables["slash"]), _ptr(params),
                  *(_ptr(cols[c]) for c in COLUMNS), *(_ptr(g) for g in got))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _at_offset(a: np.ndarray, lanes: int) -> np.ndarray:
    """A copy of ``a`` starting ``lanes`` elements past a 128-byte boundary."""
    raw = np.zeros(a.nbytes + (lanes + 64) * a.itemsize + 128, np.uint8)
    start = (-raw.ctypes.data) % 128 + lanes * a.itemsize
    out = raw[start:start + a.nbytes].view(a.dtype)
    out[:] = a
    return out


GRID_COUNTS = range(38)
GRID_OFFSETS = range(16)
GRIDS = [(2, 4), (1, 1), (3, 32)]


@pytest.mark.parametrize("blocks,threads", GRIDS)
def test_epoch_kernel_grid_matches_plain_and_jax(jax_ek, lanes, blocks, threads):
    """Row 17's grid on the host (csrc/epoch.cuh host_fused_epoch_pass, a
    grid of blocks x threads): counts 0-37 at column offsets 0-15 lanes
    past a 128-byte boundary (a mesh shard's view; the three grids share
    the offsets out, each takes every third), outputs at the inputs'
    lane parity as the wrapper places them, against the plain version and
    the JAX ``_fused_epoch_pass`` on the same lanes; the split takes pairs
    from the columns' first even-aligned lane, and columns whose offsets
    disagree in parity run every lane alone."""
    from lighthouse_tpu_torch.state_transition.epoch_device import COLUMNS

    total = max(GRID_OFFSETS) + max(GRID_COUNTS) + 1
    cols, tables, params = _epoch_inputs(total, seed=71 + threads, leak=blocks == 3)
    want = [t.numpy() for t in ek.fused_epoch_pass_plain(*_tensors(cols, tables, params))]
    jcols = dict(cols, slashed=cols["slashed"].astype(bool))
    jwant = jax_ek.epoch_pass_device(jcols, tables, params[:jax_ek.N_PARAMS], apply_eb=True)
    for w, j in zip(want, jwant):
        np.testing.assert_array_equal(w, j)
    tabs = [_ptr(tables["reward"]), _ptr(tables["penalty"]), _ptr(tables["slash"]), _ptr(params)]
    for off in GRID_OFFSETS[GRIDS.index((blocks, threads))::len(GRIDS)]:
        for n in GRID_COUNTS:
            ins = [_at_offset(cols[c][off:off + n], off) for c in COLUMNS]
            for out_off, skew in ((off, False), (off + 1, False), (off, True)):
                if skew:        # one input column at the other parity
                    ins = list(ins)
                    ins[4] = _at_offset(cols["slashed"][off:off + n], off + 1)
                outs = [_at_offset(np.full(n, -7, np.int64), out_off) for _ in range(3)]
                ptrs = [_ptr(a) for a in ins + outs]
                split = lanes.h_epoch_split(ctypes.c_long(n),
                                            (ctypes.c_void_p * 11)(*[p.value for p in ptrs]))
                if out_off % 2 != off % 2 or skew:
                    assert split == n * 1000000
                else:
                    head = min(off % 2, n)
                    assert split == head * 1000000 + (n - head) // 2
                rc = lanes.h_epoch_kernel(ctypes.c_long(n), ctypes.c_int(K), *tabs, *ptrs,
                                          ctypes.c_long(blocks), ctypes.c_int(threads))
                assert rc == 0, f"a pair was not aligned at offset {off}, count {n}"
                for g, w in zip(outs, want):
                    np.testing.assert_array_equal(g, w[off:off + n])


# --------------------------------------------------------------------------
# shuffle rounds
# --------------------------------------------------------------------------

SEED = hashlib.sha256(b"shuffle").digest()


def _sweep(count: int, rounds: int):
    pivots, src = tshuffle._shuffle_hash_sweep(SEED, rounds, count, CPU)
    jp, js = jshuffle._shuffle_hash_sweep(SEED, rounds, count, device=False)
    np.testing.assert_array_equal(pivots, jp)
    np.testing.assert_array_equal(src, js)
    return pivots, src


@pytest.mark.parametrize("count", [1, 2, 255, 256, 1000])
@pytest.mark.parametrize("rounds", [10, 90])
def test_shuffle_rounds_match_jax_and_the_scalar_shuffle(jax_ek, count, rounds):
    pivots, src = _sweep(count, rounds)
    got = ek.shuffle_rounds(torch.from_numpy(pivots.astype(np.int32)), torch.from_numpy(src),
                            count).numpy()
    bucket = max(256, 1 << (count - 1).bit_length())
    np.testing.assert_array_equal(got, jax_ek.shuffle_rounds_device(count, pivots, src, bucket))
    step = max(1, count // 64)
    for i in range(0, count, step):
        assert got[i] == tshuffle.compute_shuffled_index(i, count, SEED, rounds)
        assert got[i] == jshuffle.compute_shuffled_index(i, count, SEED, rounds)
    indices = np.arange(count, dtype=np.int64) * 3 + 7
    out = tshuffle.shuffle_list(indices, SEED, rounds, device="cpu")
    np.testing.assert_array_equal(out, jshuffle.shuffle_list(indices, SEED, rounds, device=False))
    if count >= 256:
        np.testing.assert_array_equal(out, jshuffle.shuffle_list_device(indices, SEED, rounds))


@pytest.mark.parametrize("count,rounds", [(1, 10), (255, 90), (1000, 90)])
def test_shuffle_lane_matches_plain(lanes, count, rounds):
    pivots, src = _sweep(count, rounds)
    piv32 = pivots.astype(np.int32)
    want = ek.shuffle_rounds(torch.from_numpy(piv32), torch.from_numpy(src), count).numpy()
    got = np.zeros(count, np.int32)
    src = np.ascontiguousarray(src)
    assert lanes.h_shuffle(ctypes.c_long(count), ctypes.c_int(rounds),
                           ctypes.c_long(src.shape[1]), _ptr(piv32), _ptr(src), _ptr(got)) == 0
    np.testing.assert_array_equal(got, want)


# cluster sizes of k_shuffle_rounds the host schedule is run at: 1 (a
# block holds the whole window, the kernel's choice at these counts) and 2
# (the window split, as past about 3.6M positions)
CLUSTERS = (1, 2)


def _host_schedule(lanes, count, rounds, piv32, src, cluster):
    """The host schedule at the kernel's 512 threads on a card of 16
    clusters, and at 32 threads on cards of 1 and 3 clusters (several grid
    waves, other positions a thread)."""
    for max_clusters, threads in ((16, 512), (1, 32), (3, 32)):
        got = np.full(count, -1, np.int32)
        rc = lanes.h_shuffle_kernel(ctypes.c_long(count), ctypes.c_int(rounds),
                                    ctypes.c_long(src.shape[1]), _ptr(piv32), _ptr(src),
                                    _ptr(got), ctypes.c_long(max_clusters),
                                    ctypes.c_int(threads), ctypes.c_int(cluster))
        assert rc == 0, "a window outgrew its bound or a lookup read a byte no copy wrote"
        yield got


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("count", [256, 257, 1000, 4099, (1 << 16) + 3])
def test_shuffle_kernel_schedule_matches_plain_jax_and_the_scalar_shuffle(jax_ek, lanes, count,
                                                                          cluster):
    """Row 18's round-major schedule on the host: each round's window (the
    half of the row the round reads) in `cluster` slices, each lookup
    resolved to (slice, offset) as the kernel resolves it, every block and
    thread of the kernel's plan, for rows that are not a multiple of the
    cluster nor of 16 bytes; then the pivots at the window's edges (0, 1,
    count / 2, count - 2, count - 1) on random decision bytes."""
    rounds = 90
    pivots, src = _sweep(count, rounds)
    piv32, src = pivots.astype(np.int32), np.ascontiguousarray(src)
    want = ek.shuffle_rounds_plain(torch.from_numpy(piv32), torch.from_numpy(src), count).numpy()
    np.testing.assert_array_equal(
        want, ek.shuffle_rounds(torch.from_numpy(piv32), torch.from_numpy(src), count).numpy())
    bucket = max(256, 1 << (count - 1).bit_length())
    np.testing.assert_array_equal(want, jax_ek.shuffle_rounds_device(count, pivots, src, bucket))
    for got in _host_schedule(lanes, count, rounds, piv32, src, cluster):
        np.testing.assert_array_equal(got, want)
    for i in np.random.default_rng(count).integers(0, count, 6).tolist() + [0, count - 1]:
        assert want[i] == tshuffle.compute_shuffled_index(i, count, SEED, rounds)
        assert want[i] == jshuffle.compute_shuffled_index(i, count, SEED, rounds)
    edge = np.array([0, 1, count // 2, count - 2, count - 1], np.int32)
    rnd = np.random.default_rng(count + 1).integers(0, 256, (edge.size, src.shape[1]),
                                                    dtype=np.uint8)
    want = ek.shuffle_rounds_plain(torch.from_numpy(edge), torch.from_numpy(rnd), count).numpy()
    for got in _host_schedule(lanes, count, edge.size, edge, rnd, cluster):
        np.testing.assert_array_equal(got, want)


def test_shuffle_plan_holds_the_window_in_one_block_up_to_the_main_path(lanes):
    """One block and two row buffers (the next round's copy under this
    round's lookups) at the main path's counts; one buffer at 2^21; a
    cluster of two at the capacity."""
    assert [lanes.h_shuffle_layout(n) for n in (944_080, 1_022_315, 1 << 20, 1 << 21,
                                                ek.SHUFFLE_CAPACITY)] == [12, 12, 12, 11, 21]


def test_shuffle_rounds_raise_past_the_kernel_capacity(lanes):
    cap = ek.SHUFFLE_CAPACITY
    assert cap == lanes.h_shuffle_capacity() >= 1 << 22
    src = torch.zeros((1, (cap + 1 + 7) // 8 + 16), dtype=torch.uint8)
    piv = torch.zeros(1, dtype=torch.int32)
    out = ek.shuffle_rounds(piv, src, cap)                     # at the capacity: runs
    assert torch.equal(out, torch.arange(cap, dtype=torch.int32))
    with pytest.raises(ValueError, match=f"capacity of {cap}"):
        ek.shuffle_rounds(piv, src, cap + 1)


# --------------------------------------------------------------------------
# single-block SHA-256
# --------------------------------------------------------------------------

def _words(n: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, width), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 5, 64])
def test_sha256_block_matches_jax_and_the_host_lane(lanes, n):
    state, block = _words(n, 8, seed=n), _words(n, 16, seed=n + 1)
    got = tsha.to_numpy(tsha.sha256_block_device(tsha.to_tensor(state, CPU),
                                                 tsha.to_tensor(block, CPU)))
    np.testing.assert_array_equal(got, np.asarray(jsha.sha256_block(state, block)))
    lane = np.zeros((n, 8), np.uint32)
    lanes.h_sha256_block(ctypes.c_long(n), _ptr(state), _ptr(block), _ptr(lane))
    np.testing.assert_array_equal(lane, got)


@pytest.mark.parametrize("length", [0, 33, 37, 55])
@pytest.mark.parametrize("route", ["kernel", "hashlib"])
def test_sha256_msgs_matches_jax_and_hashlib(monkeypatch, route, length):
    if route == "kernel":
        monkeypatch.setattr(tsha, "_DEVICE_MIN_PAIRS", 1)
    msgs = np.random.default_rng(length).integers(0, 256, (37, length), dtype=np.uint8)
    tsha.reset_launches()
    got = tsha.sha256_msgs(msgs, device=CPU)
    want = np.stack([np.frombuffer(hashlib.sha256(m.tobytes()).digest(), np.uint8)
                     for m in msgs])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsha.sha256_msgs(msgs, device=True))
    assert tsha.sha256_block_device.launches == 0     # the CPU runs the plain version
    with pytest.raises(ValueError):
        tsha.sha256_msgs(np.zeros((2, 56), np.uint8), device=CPU)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    cols, tables, params = _epoch_inputs(8, seed=1, leak=False)
    args = _tensors(cols, tables, params)
    bad = list(args)
    bad[1] = bad[1].int()                                   # balances not int64
    with pytest.raises(TypeError):
        ek.fused_epoch_pass(*bad)
    bad = list(args)
    bad[0] = bad[0][:4]                                     # short column
    with pytest.raises(ValueError):
        ek.fused_epoch_pass(*bad)
    bad = list(args)
    bad[-1] = bad[-1][:10]                                  # the JAX package's 10 params
    with pytest.raises(ValueError):
        ek.fused_epoch_pass(*bad)
    src = torch.zeros((10, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ek.shuffle_rounds(torch.zeros(10, dtype=torch.int32), src, 257)   # too few bytes
    with pytest.raises(TypeError):
        ek.shuffle_rounds(torch.zeros(10, dtype=torch.int64), src, 256)
    with pytest.raises(ValueError):
        tsha.sha256_block_device(torch.zeros((3, 8), dtype=torch.int32),
                                 torch.zeros((4, 16), dtype=torch.int32))


def test_wrappers_count_no_launch_on_the_cpu():
    ek.reset_launches()
    tsha.reset_launches()
    cols, tables, params = _epoch_inputs(8, seed=2, leak=False)
    ek.fused_epoch_pass(*_tensors(cols, tables, params))
    ek.shuffle_rounds(torch.zeros(4, dtype=torch.int32), torch.zeros((4, 32), dtype=torch.uint8),
                      256)
    tsha.sha256_block_device(torch.zeros((2, 8), dtype=torch.int32),
                             torch.zeros((2, 16), dtype=torch.int32))
    assert [k.launches for k in ek.KERNELS] == [0, 0]
    assert tsha.sha256_block_device.launches == 0


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    ek.reset_launches()
    tsha.reset_launches()
    epoch_cases = 0
    for n, leak, rewards in ((777, False, True), (4099, True, True), (300, False, False)):
        cols, tables, params = _epoch_inputs(n, seed=n, leak=leak, rewards=rewards)
        args = _tensors(cols, tables, params, dev)
        # the whole columns, short counts, and views 1-3 lanes in (row 17's
        # scalar head and tail beside its aligned pairs)
        for case in ([x for x in args[:8]], *([x[:m] for x in args[:8]] for m in (1, 2, 3)),
                     *([x[o:] for x in args[:8]] for o in (1, 2, 3))):
            got = ek.fused_epoch_pass(*case, *args[8:])
            for g, w in zip(got, ek.fused_epoch_pass_plain(*case, *args[8:])):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
            epoch_cases += 1
    # rows that are not a multiple of the cluster nor of 16 bytes, up to a
    # row larger than one block's shared memory (2^21 positions)
    shuffles = ((1000, 90), (4099, 10), (256, 90), (257, 90), ((1 << 16) + 3, 90),
                (1 << 21, 90))
    for count, rounds in shuffles:
        pivots, src = _sweep(count, rounds)
        p, s = torch.from_numpy(pivots.astype(np.int32)).to(dev), torch.from_numpy(src).to(dev)
        torch.testing.assert_close(ek.shuffle_rounds(p, s, count),
                                   ek.shuffle_rounds_plain(p, s, count), rtol=0, atol=0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ek.shuffle_rounds(p, s.view(-1)[1:1 + 90 * 32].view(90, 32), 256)
    state, block = (tsha.to_tensor(_words(4099, w, seed=w), dev) for w in (8, 16))
    got = tsha.sha256_block_device(state, block)
    torch.testing.assert_close(got, tsha.sha256_block_plain(state, block), rtol=0, atol=0)
    assert [k.launches for k in ek.KERNELS] == [epoch_cases, len(shuffles)]
    assert tsha.sha256_block_device.launches == 1
