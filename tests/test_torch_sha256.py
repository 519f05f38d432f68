"""The port's SHA-256 kernels (``lighthouse_tpu_torch.ops.sha256``) against
the JAX package's device programs and hashlib.

On the CPU each kernel wrapper runs its plain PyTorch version; the test
marked ``cuda`` holds the CUDA kernels against the plain versions on a card.
Every comparison is bit-exact (tolerance 0): SHA-256 is integer arithmetic.
"""

import ctypes
import hashlib
import re
import subprocess
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import sha256 as jsha
from lighthouse_tpu_torch.ops import sha256 as tsha

CPU = torch.device("cpu")
# the kernels' constant tables live in the header their compression shares
CSRC = Path(tsha.__file__).resolve().parent.parent / "csrc" / "sha256.cuh"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep each test worker to one intra-op thread, so parallel workers do
    not load every core."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _words(n: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, width), dtype=np.uint64).astype(np.uint32)


def _hashlib_pairs(pairs: np.ndarray) -> np.ndarray:
    data = pairs.astype(">u4").tobytes()
    digests = b"".join(hashlib.sha256(data[64 * i:64 * (i + 1)]).digest()
                       for i in range(pairs.shape[0]))
    return np.frombuffer(digests, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def _hashlib_levels(leaves: np.ndarray) -> list[np.ndarray]:
    levels, x = [], leaves
    while x.shape[0] > 1:
        x = _hashlib_pairs(x.reshape(-1, 16))
        levels.append(x)
    return levels


@pytest.mark.parametrize("n", [1, 3, 64])
def test_hash_pairs_matches_jax_and_hashlib(n):
    pairs = _words(n, 16, seed=n)
    got = tsha.to_numpy(tsha.hash_pairs_device(tsha.to_tensor(pairs, CPU)))
    np.testing.assert_array_equal(got, np.asarray(jsha.hash_pairs_device(pairs)))
    np.testing.assert_array_equal(got, _hashlib_pairs(pairs))


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_fold_levels_matches_jax_and_hashlib(n):
    leaves = _words(n, 8, seed=100 + n)
    t = tsha.to_tensor(leaves, CPU)
    got = tsha.to_numpy(tsha.fold_levels_device(t))
    want = _hashlib_levels(leaves)
    jax_levels = [np.asarray(lv) for lv in jsha._fold_levels_device(leaves)]
    assert got.shape == (n - 1, 8)
    if n > 1:
        np.testing.assert_array_equal(got, np.concatenate(want))
        np.testing.assert_array_equal(got, np.concatenate(jax_levels))
    views = [tsha.to_numpy(v) for v in tsha.fold_levels(t)]
    assert len(views) == len(want) == len(jax_levels)
    for v, w in zip(views, want):
        np.testing.assert_array_equal(v, w)


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_fold_to_root_matches_jax_and_hashlib(n):
    leaves = _words(n, 8, seed=200 + n)
    got = tsha.to_numpy(tsha.fold_to_root_device(tsha.to_tensor(leaves, CPU)))
    want = _hashlib_levels(leaves)[-1] if n > 1 else leaves
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jsha._fold_to_root_jit(leaves)))


FOLD_HARNESS = r"""
#include "sha256.cuh"
extern "C" int h_fold(const uint32_t* leaves, long long n, int k, long long threads,
                      uint32_t* root) {
    if (n > sha::fold_capacity(k, threads)) return 1;
    switch (k) {
        case 1: sha::host_fold_subtrees<1>(leaves, n, threads, root); return 0;
        case 2: sha::host_fold_subtrees<2>(leaves, n, threads, root); return 0;
        case 3: sha::host_fold_subtrees<3>(leaves, n, threads, root); return 0;
        case 4: sha::host_fold_subtrees<4>(leaves, n, threads, root); return 0;
        case 5: sha::host_fold_subtrees<5>(leaves, n, threads, root); return 0;
    }
    return 2;
}
extern "C" long long h_fold_plan(long long n, long long* cap) {
    const int k = sha::fold_log_per(n);
    *cap = sha::fold_capacity(k, 256);
    return k;
}
"""


@pytest.fixture(scope="module")
def fold_model(tmp_path_factory):
    """``k_fold_subtrees``' passes as ``sha256.cuh``'s host model runs them
    (``host_fold_subtrees``: each block's threads, shared-memory levels and
    warp 0's shuffle levels as loops), built with g++."""
    d = tmp_path_factory.mktemp("fold_model")
    (d / "h.cc").write_text(FOLD_HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{CSRC.parent}", str(d / "h.cc"), "-o", str(d / "h.so")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(d / "h.so"))
    lib.h_fold.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("log_n", range(1, 13))
def test_fold_subtrees_model_matches_hashlib_and_jax(fold_model, k, log_n):
    """2^k leaves a thread, at every width 2 to 2^12: at the kernel's 256
    threads a block (one block up to 2^(k+8) leaves) and at 16 and 64 (a
    part of a warp, two warps: many blocks and the last block's second pass
    over their roots) where one launch takes the tree, the root equals
    hashlib's and the JAX fold's."""
    n = 1 << log_n
    leaves = _words(n, 8, seed=400 + n)
    want = _hashlib_levels(leaves)[-1]
    np.testing.assert_array_equal(want, np.asarray(jsha._fold_to_root_jit(leaves)))
    for threads in (256, 64, 16):
        if n > (threads << k) ** 2:     # past one launch's capacity
            continue
        root = np.zeros((1, 8), np.uint32)
        assert fold_model.h_fold(leaves.ctypes.data, n, k, threads, root.ctypes.data) == 0
        np.testing.assert_array_equal(root, want)


def test_fold_plan_takes_the_measured_leaves_a_thread(fold_model):
    """2 leaves a thread up to 2^16 leaves, then twice as many for each
    doubling, 32 from 2^20 on; one launch takes every width up to 2^26."""
    fold_model.h_fold_plan.restype = ctypes.c_longlong
    cap = ctypes.c_longlong()
    got = {}
    for log_n in range(1, 27):
        got[log_n] = fold_model.h_fold_plan(1 << log_n, ctypes.byref(cap))
        assert cap.value >= 1 << log_n
    assert got == {**{g: 1 for g in range(1, 17)}, 17: 2, 18: 3, 19: 4,
                   **{g: 5 for g in range(20, 27)}}


@pytest.mark.parametrize("route", ["fold", "levels", "host"])
@pytest.mark.parametrize("n,limit", [(0, None), (1, 16), (5, 8), (33, None), (100, 1 << 40)])
def test_merkleize_words_matches_jax(monkeypatch, route, n, limit):
    """Every routing of the port's merkleization gives the JAX package's root
    (the JAX side at its own default routing)."""
    if route == "fold":
        monkeypatch.setattr(tsha, "_DEVICE_FOLD_MIN_LEAVES", 1)
    elif route == "levels":
        monkeypatch.setattr(tsha, "_DEVICE_MIN_PAIRS", 1)
    leaves = _words(n, 8, seed=300 + n)
    got = tsha.merkleize_words(leaves, limit, device=CPU)
    np.testing.assert_array_equal(got, jsha.merkleize_words(leaves, limit))
    data = tsha.words_to_bytes(leaves)
    assert tsha.merkleize(data, limit, device=CPU) == jsha.merkleize(data, limit)


def test_host_helpers_match_jax():
    np.testing.assert_array_equal(tsha.ZERO_HASH_WORDS, jsha.ZERO_HASH_WORDS)
    assert tsha.ZERO_HASHES == jsha.ZERO_HASHES
    np.testing.assert_array_equal(tsha._PAD_W, jsha._PAD_W)
    data = bytes(range(96))
    np.testing.assert_array_equal(tsha.chunks_to_words(data), jsha.chunks_to_words(data))
    assert tsha.words_to_bytes(tsha.chunks_to_words(data)) == data
    assert tsha.mix_in_length(data[:32], 12345) == jsha.mix_in_length(data[:32], 12345)
    pairs = _words(9, 16, seed=7)
    np.testing.assert_array_equal(tsha.hash_pairs_np(pairs), jsha.hash_pairs_np(pairs))
    np.testing.assert_array_equal(tsha.batch_hash_pairs(pairs, device=CPU),
                                  jsha.batch_hash_pairs(pairs))


def test_cuda_source_tables_match_the_spec_constants():
    """The kernel's __constant__ tables (which no compiler checks here)
    equal the round constants and the padding-block schedule."""
    src = CSRC.read_text()

    def table(name):
        body = re.search(rf"{name}\[64\] = \{{(.*?)\}};", src, re.S).group(1)
        return np.array([int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u", body)],
                        dtype=np.uint32)

    np.testing.assert_array_equal(table("K"), jsha._K)
    np.testing.assert_array_equal(table("PAD_W"), tsha._PAD_W)


def test_wrappers_reject_what_the_kernels_do_not_take():
    good = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        tsha.hash_pairs_device(good.long())
    with pytest.raises(ValueError):
        tsha.hash_pairs_device(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tsha.hash_pairs_device(torch.zeros((16, 4), dtype=torch.int32).t())
    with pytest.raises(ValueError):
        tsha.fold_levels_device(torch.zeros((6, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tsha.fold_to_root_device(torch.zeros((0, 8), dtype=torch.int32))


def test_wrappers_count_no_launch_on_the_cpu():
    tsha.reset_launches()
    t = tsha.to_tensor(_words(8, 8, seed=1), CPU)
    tsha.hash_pairs_device(t.reshape(-1, 16))
    tsha.fold_levels_device(t)
    tsha.fold_to_root_device(t)
    assert [k.launches for k in tsha.KERNELS] == [0, 0, 0]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    pairs = _words(4099, 16, seed=11)
    leaves = tsha.to_tensor(_words(1 << 12, 8, seed=12), dev)
    tsha.reset_launches()
    got = tsha.hash_pairs_device(tsha.to_tensor(pairs, dev))
    torch.testing.assert_close(got, tsha.hash_pairs_plain(tsha.to_tensor(pairs, dev)),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(tsha.to_numpy(got), _hashlib_pairs(pairs))
    torch.testing.assert_close(tsha.fold_levels_device(leaves),
                               tsha.fold_levels_plain(leaves), rtol=0, atol=0)
    torch.testing.assert_close(tsha.fold_to_root_device(leaves),
                               tsha.fold_to_root_plain(leaves), rtol=0, atol=0)
    # every width from 1 to 2^12 leaves in one launch (none for 1)
    for log_n in range(13):
        x = leaves[:1 << log_n].contiguous()
        before = tsha.fold_to_root_device.launches
        got = tsha.fold_to_root_device(x)
        assert tsha.fold_to_root_device.launches == before + (log_n > 0)
        assert torch.equal(got, tsha.fold_to_root_plain(x))
    assert [k.launches for k in tsha.KERNELS] == [1, 12, 13]
