"""Chunk planning, deferred verdicts and the chunk-partial product of the
batch verifier.

Counterpart of ``lighthouse_tpu/ops/dispatch_pipeline.py`` (``chunk_size``
and ``plan_chunks`` :52-102, ``AsyncVerdict`` with its ``verdict`` fault
site :133-143, ``combine_partials`` :167).  The JAX read's own deadline
(``watchdog_deadline_s``, :76) is not ported: the BLS supervisor's
watchdog bounds the whole batch, the read included, and a direct caller of
a backend has left the supervisor.
Batches above the chunk size split into fixed power-of-two chunks whose
host layout runs while the previous chunk's kernels execute (CUDA launches
return before the card finishes); the per-chunk Fq12 partials multiply down
on the card, so a batch pays one device-to-host fetch and one final
exponentiation.

``fq12_mul_device`` is the kernel wrapper of ``lh_fq12_mul``
(``csrc/bls12_381.cu``), which replaces ``_fq12_mul_pair``
(``lighthouse_tpu/ops/dispatch_pipeline.py:162``): one thread per Fq12
product (54 Fp products, bound by integer multiply-adds; a factor equal
to one costs none).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_cuda, faults

# batches at or below this verify in one chunk; LHGPU_BLS_CHUNK overrides
# (0 disables chunking)
DEFAULT_CHUNK_SETS = 512


def chunk_size(override: int | None = None) -> int:
    """Effective chunk size: explicit override > LHGPU_BLS_CHUNK > default."""
    if override is not None:
        return int(override)
    env = os.environ.get("LHGPU_BLS_CHUNK")
    if env is not None and env.strip():
        return int(env)
    return DEFAULT_CHUNK_SETS


def plan_chunks(n: int, chunk: int) -> list[tuple[int, int]]:
    """[(lo, hi), ...] covering range(n) in fixed power-of-two chunks;
    chunk <= 0 (or n <= chunk) gives one chunk, and a non-power-of-two
    chunk rounds down."""
    if n <= 0:
        return []
    if chunk <= 0 or n <= chunk:
        return [(0, n)]
    if chunk & (chunk - 1):
        chunk = 1 << (chunk.bit_length() - 1)
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


class AsyncVerdict:
    """A bool-row verdict on the card whose read is deferred to commit().

    The row is produced by a kernel launched on the current stream; a CUDA
    event recorded behind it is what commit() waits on.  ``on_pass`` runs
    once iff every real lane passed."""

    __slots__ = ("_ok", "_n", "_on_pass", "_event", "_result")

    def __init__(self, ok: torch.Tensor | None, n: int, on_pass=None):
        self._ok = ok
        self._n = n
        self._on_pass = on_pass
        self._result: bool | None = None
        self._event = None
        if ok is not None and ok.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(ok.device))

    @staticmethod
    def immediate(value: bool) -> "AsyncVerdict":
        v = AsyncVerdict(None, 0)
        v._result = bool(value)
        return v

    def commit(self) -> bool:
        """Wait for the row (its CUDA event) and read the verdict.  A
        corrupt-mode fault flips the verdict and never marks the signatures
        checked."""
        if self._result is None:
            mode = faults.fire("verdict")
            if self._event is not None:
                self._event.synchronize()
            result = bool(self._ok[: self._n].all().item())
            self._result = (not result) if mode == "corrupt" else result
            if self._result and self._on_pass is not None and mode != "corrupt":
                self._on_pass()
            self._ok = None
        return self._result


def fq12_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lh_fq12_mul``: int32 [N, 12, 12] rows -> their
    products."""
    return bi.i32(t12.fp12_mul(t12.fq12_nested(bi.u64(a)), t12.fq12_nested(bi.u64(b))).reshape(a.shape))


def fq12_mul_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Products of Fq12 rows, int32 [N, 12, 12] each (coefficients c0.c0.a
    ... c1.c2.b, Montgomery words)."""
    bls_cuda.check(a, (12, bi.L), "fq12_mul a")
    bls_cuda.check(b, (12, bi.L), "fq12_mul b")
    dev = bls_cuda.same_device("fq12_mul", a, b)
    if a.shape != b.shape:
        raise ValueError(f"fq12_mul: shapes {list(a.shape)} and {list(b.shape)} differ")
    if dev.type == "cpu":
        return fq12_mul_plain(a, b)
    out = torch.empty_like(a)
    if a.shape[0]:
        bls_cuda.launch("lh_fq12_mul", a, b, out, a.shape[0])
        fq12_mul_device.launches += 1
    return out


fq12_mul_device.launches = 0


def combine_partials(partials: list[torch.Tensor]) -> torch.Tensor:
    """Multiply the per-chunk Fq12 partials down to one on their device."""
    acc = partials[0]
    for p in partials[1:]:
        acc = fq12_mul_device(acc, p)
    return acc


def fq12_row_to_host(f: torch.Tensor):
    """An Fq12 row [1, 12, 12] on any device -> python Fq12 (one fetch)."""
    return t12.fq12_from_words(bi.to_numpy(f).reshape(12, 12).astype(np.uint32))
