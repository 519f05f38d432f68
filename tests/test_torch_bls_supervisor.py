"""The port's BLS offload supervisor (``crypto/bls/api.py``) and fault
plans (``ops/faults.py``), on the CPU.

The fault matrix injects each mode (raise, compile, corrupt, hang) into the
``cuda`` backend on one chunk and chunked, and into the ``sharded``
backend, all on ``device="cpu"`` (the plain versions): each batch gives the
reference verdict, opens its backend's breaker and counts one fault of the
JAX package's kind (``tests/test_offload_faults.py``) and one recovery.  A
hang blocks on a ``threading.Event`` (no wall-clock race): a 0.2 s
watchdog cuts it off, the bound is several seconds, and the event is
released before the test ends.  A backend's exception that is not a
device fault (a bug) raises and is not recovered.  Then the breakers'
transitions under a monkeypatched clock, the disabled supervisor, the
deferred verdict read's hang (cut by the supervisor's watchdog) and
corrupt flip, the environment's plans, and the rest of the API
(``fast_aggregate_verify``, ``aggregate_verify``, ``auto``, ``fake``)
against the JAX package's on the same keys (its ``reference`` backend).
"""

import threading
import time
import types

import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls_pkg
from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.ops import dispatch_pipeline as dp
from lighthouse_tpu_torch.ops import faults

CPU = "cpu"
TUNED = dict(LHGPU_WATCHDOG_S="0.2", LHGPU_SUPERVISOR_AUDIT="1", LHGPU_SUPERVISOR_FAILS="1",
             LHGPU_SUPERVISOR_BACKOFF_S="30")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("LHGPU_SUPERVISOR", "LHGPU_SUPERVISOR_LADDER", "LHGPU_BLS_BACKEND",
              "LHGPU_FAULT_MODE", "LHGPU_FAULT_SITE", "LHGPU_FAULT_MAX_FIRES",
              "LHGPU_FAULT_INDICES", "LHGPU_FAULT_HANG_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in TUNED.items():
        monkeypatch.setenv(k, v)
    faults.clear()
    api.reset_supervisor()
    yield
    faults.clear()
    api.reset_supervisor()
    api.set_backend("cuda")


@pytest.fixture(scope="module")
def sets():
    """A valid and an invalid 2-set batch (signatures made with their
    points, so no membership kernel runs)."""
    sk = bls.SecretKey(3)
    msgs = [b"offload-fault-a".ljust(32, b"\x00"), b"offload-fault-b".ljust(32, b"\x00")]
    valid = [bls.SignatureSet(sk.sign(m), [sk.public_key()], m) for m in msgs]
    invalid = [bls.SignatureSet(sk.sign(msgs[1]), [sk.public_key()], msgs[0]), valid[1]]
    return valid, invalid


@pytest.fixture
def hang_gate(monkeypatch):
    """A hang that blocks on an event instead of a sleep; released, and its
    watchdog threads joined, at the end."""
    release = threading.Event()
    monkeypatch.setattr(faults, "time", types.SimpleNamespace(sleep=lambda _s: release.wait(60)))
    yield release
    release.set()
    for t in threading.enumerate():
        if t.name.startswith("lhgpu-") and t.name != faults.IDLE_NAME:
            t.join(10)                  # an abandoned watchdog thread ends
            assert not t.is_alive(), t.name


def _site(mode: str, path: str) -> str:
    """Where the JAX matrix injects each mode: the entry (single, sharded)
    or chunk 0 (chunked); a corrupt verdict is an entry's answer, so the
    chunked path takes it at the ``cuda`` entry with one set a chunk."""
    if path == "chunked":
        return "cuda" if mode == "corrupt" else "chunk"
    return {"single": "cuda", "sharded": "sharded"}[path]


@pytest.mark.parametrize("path", ["single", "chunked", "sharded"])
@pytest.mark.parametrize("mode", ["raise", "compile", "corrupt", "hang"])
def test_fault_matrix_gives_the_reference_verdict(sets, mode, path, monkeypatch, hang_gate):
    valid, _ = sets
    backend = "sharded" if path == "sharded" else "cuda"
    monkeypatch.setenv("LHGPU_SUPERVISOR_LADDER", f"{backend},reference")
    api.reset_supervisor()
    kwargs = {"chunk_size": 1} if path == "chunked" else {}
    faults0, rec0 = api.faults(), api.recoveries()
    faults.install_plan(faults.FaultPlan(mode, sites={_site(mode, path)}, hang_s=60,
                                         corrupt_value=False))
    t0 = time.perf_counter()
    ok = bls.verify_signature_sets(valid, backend=backend, device=CPU, **kwargs)
    elapsed = time.perf_counter() - t0
    faults.install_plan(None)
    assert ok is True
    assert bls.backend_health()[backend] == "open"
    assert api.faults().get((backend, mode), 0) == faults0.get((backend, mode), 0) + 1
    assert api.recoveries().get(backend, 0) == rec0.get(backend, 0) + 1
    if mode == "hang":
        assert elapsed < 10.0           # the watchdog, not the 60 s stall
        assert any(t.name == f"lhgpu-bls-{backend}" for t in threading.enumerate())


@pytest.mark.parametrize("corrupt_value,use_invalid", [(True, True), (False, False)])
def test_corrupt_verdict_caught_by_the_audit(sets, corrupt_value, use_invalid):
    valid, invalid = sets
    with_plan = faults.FaultPlan("corrupt", sites={"cuda"}, corrupt_value=corrupt_value)
    faults.install_plan(with_plan)
    ok = bls.verify_signature_sets(invalid if use_invalid else valid, device=CPU)
    assert ok is (not use_invalid)
    assert bls.backend_health()["cuda"] == "open"


def test_the_ladder_degrades_across_both_device_rungs(sets):
    valid, _ = sets
    rec0 = api.recoveries().get("cuda", 0)
    faults.install_plan(faults.FaultPlan("raise", sites={"cuda", "sharded"}))
    assert bls.verify_signature_sets(valid, backend="cuda", device=CPU) is True
    health = bls.backend_health()
    assert health["cuda"] == health["sharded"] == "open"
    assert api.recoveries().get("cuda", 0) == rec0 + 1


def test_bisection_of_a_poisoned_batch_under_faults_names_the_reference_sets(sets):
    """Every sub-batch of the bisection faults on the ``cuda`` rung and is
    recovered: the mask names the same sets as the reference backend's."""
    from lighthouse_tpu_torch.chain.attestation_verification import (
        verify_signature_sets_with_bisection,
    )

    valid, invalid = sets
    batch = [valid[0], invalid[0], valid[1]]
    want = verify_signature_sets_with_bisection(batch, backend="reference")
    rec0 = api.recoveries().get("cuda", 0)
    faults.install_plan(faults.FaultPlan("raise", sites={"cuda"}))
    api._get_supervisor().ladder = ["cuda", "reference"]
    got = verify_signature_sets_with_bisection(batch, backend="cuda", device=CPU)
    assert got.tolist() == want.tolist() == [True, False, True]
    assert api.recoveries().get("cuda", 0) > rec0


def test_a_missing_card_raises_before_the_ladder(sets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec0 = api.recoveries()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bls.verify_signature_sets(sets[0])
    assert api.recoveries() == rec0


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_breaker_open_half_open_closed_under_backoff(sets, monkeypatch):
    """closed -> (1 of 2 faults) closed -> open -> benched -> (backoff
    passed) a failed half-open probe re-opens with the backoff doubled ->
    a good probe closes and resets it."""
    valid, _ = sets
    monkeypatch.setenv("LHGPU_SUPERVISOR_AUDIT", "0")
    monkeypatch.setenv("LHGPU_SUPERVISOR_FAILS", "2")
    monkeypatch.setenv("LHGPU_SUPERVISOR_LADDER", "cuda,reference")
    api.reset_supervisor()
    calls = {"n": 0, "fail": True}

    def stub(sets_, **kw):
        calls["n"] += 1
        if calls["fail"]:
            raise faults.InjectedFault("stub fault")
        return True

    monkeypatch.setitem(api._BACKENDS, "cuda", stub)
    breaker = api._get_supervisor().breakers["cuda"]
    clock = breaker.clock = _Clock()
    assert bls.backend_health()["cuda"] == "closed"
    assert bls.verify_signature_sets(valid, device=CPU) is True
    assert breaker.state == "closed" and calls["n"] == 1
    assert bls.verify_signature_sets(valid, device=CPU) is True
    assert breaker.state == "open" and breaker.backoff_s == 30.0
    assert bls.verify_signature_sets(valid, device=CPU) is True
    assert calls["n"] == 2                                  # benched
    clock.t += 29.9
    assert not breaker.allow() and breaker.state == "open"
    clock.t += 0.2
    assert bls.verify_signature_sets(valid, device=CPU) is True
    assert calls["n"] == 3 and breaker.state == "open" and breaker.backoff_s == 60.0
    clock.t += 30.0
    assert not breaker.allow()
    clock.t += 30.1
    calls["fail"] = False
    assert bls.verify_signature_sets(valid, device=CPU) is True
    assert calls["n"] == 4 and breaker.state == "closed" and breaker.backoff_s == 30.0
    assert breaker.failures == 0


def test_a_half_open_breaker_lets_one_probe_through(monkeypatch):
    monkeypatch.setenv("LHGPU_SUPERVISOR_BACKOFF_S", "5")
    api.reset_supervisor()
    breaker = api.plane_breaker("pubkey")
    clock = breaker.clock = _Clock()
    breaker.record_failure()
    assert breaker.state == "open" and not breaker.allow()
    clock.t += 5
    assert breaker.allow() and breaker.state == "half_open"
    assert not breaker.allow()                              # the probe is out
    breaker.record_success()
    assert breaker.state == "closed" and breaker.allow()


def test_a_disabled_supervisor_lets_faults_through(sets, monkeypatch):
    monkeypatch.setenv("LHGPU_SUPERVISOR", "0")
    api.reset_supervisor()
    faults.install_plan(faults.FaultPlan("raise", sites={"cuda"}))
    with pytest.raises(faults.InjectedFault):
        bls.verify_signature_sets(sets[0], device=CPU)


@pytest.mark.parametrize("backend", ["cuda", "sharded"])
def test_a_bug_in_a_backend_raises_and_is_not_recovered(sets, backend, monkeypatch):
    """A TypeError or a ValueError of a backend (a bad layout, a wrong
    argument) is the code's fault, not the card's: it raises out of the
    call, counts nothing and leaves the breaker closed."""
    valid, _ = sets
    monkeypatch.setenv("LHGPU_SUPERVISOR_LADDER", f"{backend},reference")
    api.reset_supervisor()
    for exc in (TypeError("a bug in the backend"), ValueError("a bad chunk layout")):
        def stub(sets_, exc=exc, **kw):
            raise exc

        monkeypatch.setitem(api._BACKENDS, backend, stub)
        counted = api.faults(), api.recoveries()
        with pytest.raises(type(exc), match=str(exc)):
            bls.verify_signature_sets(valid, backend=backend, device=CPU)
        assert (api.faults(), api.recoveries()) == counted
        assert bls.backend_health()[backend] == "closed"


@pytest.mark.parametrize("exc,device", [
    (faults.InjectedFault("x"), True), (faults.WatchdogTimeout("x"), True),
    (faults.DeviceFault("final_exp_hard: the card returned a non-canonical field element"),
     True),
    (RuntimeError("lh_miller: CUDA error 700: an illegal memory access was encountered"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("nvcc failed to build bls12_381.cu (rc 1):\nerror"), True),
    (RuntimeError("the group kernels' tapes did not build"), True),
    (RuntimeError("injected row-11 fault"), False), (TypeError("x"), False),
    (ValueError("CUDA error in a message of a ValueError"), False), (KeyError("cuda"), False)])
def test_device_faults_are_told_from_bugs(exc, device):
    assert faults.is_device_fault(exc) is device


def test_a_hang_at_the_verdict_read_is_cut_by_the_supervisors_watchdog(sets, monkeypatch,
                                                                       hang_gate):
    """The deferred verdict read has no deadline of its own: a read that
    stalls (a backend whose batch is one ``AsyncVerdict.commit``) is cut
    off by the supervisor's watchdog over the whole batch, and the batch
    is answered on the reference rung."""
    valid, _ = sets
    monkeypatch.setenv("LHGPU_SUPERVISOR_LADDER", "cuda,reference")
    api.reset_supervisor()
    monkeypatch.setitem(api._BACKENDS, "cuda",
                        lambda sets_, **kw: dp.AsyncVerdict(torch.tensor([True]), 1).commit())
    faults0, rec0 = api.faults(), api.recoveries()
    plan = faults.FaultPlan("hang", sites={"verdict"}, hang_s=60)
    faults.install_plan(plan)
    t0 = time.perf_counter()
    assert bls.verify_signature_sets(valid, backend="cuda", device=CPU) is True
    assert time.perf_counter() - t0 < 10.0
    assert plan.fires == 1
    faults.install_plan(None)
    assert api.faults().get(("cuda", "hang"), 0) == faults0.get(("cuda", "hang"), 0) + 1
    assert api.recoveries().get("cuda", 0) == rec0.get("cuda", 0) + 1
    faults.install_plan(faults.FaultPlan("raise", sites={"verdict"}))
    with pytest.raises(faults.InjectedFault):          # a direct caller gets the fault
        dp.AsyncVerdict(torch.tensor([True]), 1).commit()


def test_a_nested_deadline_runs_inline():
    """On a watchdog thread a nested ``run_with_deadline`` runs its call in
    place: the outer deadline covers it, and no second thread starts."""
    def inner():
        return faults.under_watchdog(), threading.current_thread()

    def outer():
        return threading.current_thread(), faults.run_with_deadline(inner, 5, "lhgpu-in", "in")

    me, (nested, there) = faults.run_with_deadline(outer, 5, "lhgpu-out", "out")
    assert nested is True and there is me and me is not threading.current_thread()
    assert faults.under_watchdog() is False


def test_a_corrupt_read_flips_and_never_marks(monkeypatch):
    marks = []
    faults.install_plan(faults.FaultPlan("corrupt", sites={"verdict"}))
    v = dp.AsyncVerdict(torch.tensor([True]), 1, on_pass=lambda: marks.append(1))
    assert v.commit() is False
    v2 = dp.AsyncVerdict(torch.tensor([False]), 1, on_pass=lambda: marks.append(2))
    assert v2.commit() is True
    assert marks == []


def test_plans_from_the_environment(monkeypatch, caplog):
    monkeypatch.setenv("LHGPU_FAULT_MODE", "raise")
    monkeypatch.setenv("LHGPU_FAULT_SITE", "cuda,chunk")
    monkeypatch.setenv("LHGPU_FAULT_INDICES", "2")
    monkeypatch.setenv("LHGPU_FAULT_MAX_FIRES", "1")
    faults.clear()
    assert faults.fire("cuda", 0) is None and faults.fire("chunk", 1) is None
    with pytest.raises(faults.InjectedFault):
        faults.fire("chunk", 2)
    assert faults.fire("chunk", 2) is None                  # max fires reached
    assert faults.fire("sharded", 2) is None
    monkeypatch.setenv("LHGPU_FAULT_MODE", "raze")
    faults.clear()
    assert faults.active_plan() is None and faults.fire("cuda") is None
    assert "malformed LHGPU_FAULT_" in caplog.text or "raze" in caplog.text
    with pytest.raises(ValueError):
        faults.FaultPlan("explode")


def test_classify():
    assert faults.classify(faults.WatchdogTimeout("x")) == "hang"
    assert faults.classify(faults.InjectedCompileFault("x")) == "compile"
    assert faults.classify(RuntimeError("nvcc compilation failed")) == "compile"
    assert faults.classify(ValueError("launch failed")) == "raise"


def test_the_watchdog_thread_takes_the_callers_cuda_context(monkeypatch):
    """Where CUDA is in use, the thread sets the caller's device and stream
    before it runs (both are per thread)."""
    seen = []

    class _Stream:
        def __init__(self, s):
            self.s = s

        def __enter__(self):
            seen.append(("stream", self.s))

        def __exit__(self, *_):
            return False

    fake = types.SimpleNamespace(
        is_available=lambda: True, is_initialized=lambda: True,
        current_device=lambda: 3, current_stream=lambda: "stream-7",
        set_device=lambda d: seen.append(("device", d)), stream=_Stream)
    monkeypatch.setattr(torch, "cuda", fake)
    assert faults.run_with_deadline(lambda: "done", 5, "lhgpu-ctx", "ctx") == "done"
    assert seen == [("device", 3), ("stream", "stream-7")]


# -- the rest of the API against the JAX package's ---------------------------------

@pytest.fixture(scope="module")
def jax_reference():
    old = jbls.get_backend()
    jbls.set_backend("reference")
    yield
    jbls.set_backend(old)


def _keys(n):
    jsks = [jbls_pkg.SecretKey(7 + i) for i in range(n)]
    return jsks, [bls.PublicKey(sk.public_key().to_bytes()) for sk in jsks]


def test_fast_aggregate_verify_equals_jax(jax_reference):
    jsks, pks = _keys(3)
    msg = b"fast-aggregate".ljust(32, b"\x00")
    jsig = jbls_pkg.Signature.aggregate([sk.sign(msg) for sk in jsks])
    sig = bls.Signature(jsig.to_bytes())
    jpks = [sk.public_key() for sk in jsks]
    for m in (msg, b"other".ljust(32, b"\x00")):
        want = jbls.fast_aggregate_verify(jpks, m, jsig)
        assert bls.fast_aggregate_verify(pks, m, sig, backend="reference") == want
    assert want is False and jbls.fast_aggregate_verify(jpks, msg, jsig) is True
    assert bls.fast_aggregate_verify([], msg, sig, backend="reference") is False


def test_aggregate_verify_equals_jax(jax_reference):
    from lighthouse_tpu.crypto.bls import curve as jcv

    jsks, pks = _keys(3)
    msgs = [bytes([i]) * 32 for i in range(3)]
    pt = jcv.INF
    for sk, m in zip(jsks, msgs):
        pt = jcv.g2_add(pt, sk.sign(m).point)
    jsig = jbls_pkg.Signature(jcv.g2_to_bytes(pt))
    sig = bls.Signature(jsig.to_bytes())
    jpks = [sk.public_key() for sk in jsks]
    for ms in (msgs, msgs[::-1]):
        assert bls.aggregate_verify(pks, ms, sig) == jbls.aggregate_verify(jpks, ms, jsig)
    assert bls.aggregate_verify(pks, msgs, sig) is True
    assert bls.aggregate_verify(pks, msgs[:2], sig) is False
    assert bls.aggregate_verify(pks, msgs, bls.Signature(b"\x00" * 96)) is False


def test_auto_and_the_registry(sets, jax_reference, monkeypatch):
    valid, invalid = sets
    assert bls.get_backend() == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bls.set_backend("auto")
    assert api.resolve_auto_backend() == "reference" == jbls.resolve_auto_backend()
    from lighthouse_tpu_torch import convert

    jsets = [jbls.SignatureSet(jbls.Signature(s.signature.to_bytes()),
                               [jbls.PublicKey(pk.to_bytes()) for pk in s.pubkeys], s.message)
             for s in valid + invalid[:1]]
    assert bls.verify_signature_sets(valid) is True
    assert bls.verify_signature_sets(convert.signature_sets_from_bytes(
        [([pk.to_bytes() for pk in s.pubkeys], s.signature.to_bytes(), s.message)
         for s in jsets])) == jbls.verify_signature_sets(jsets) is False
    monkeypatch.setenv("LHGPU_BLS_BACKEND", "fake")
    assert api.resolve_auto_backend() == "fake"
    assert bls.verify_signature_sets(invalid) is True       # fake: structure only
    assert bls.verify_signature_sets([]) is False
    monkeypatch.setenv("LHGPU_BLS_BACKEND", "nope")
    with pytest.raises(KeyError):
        api.resolve_auto_backend()
    monkeypatch.delenv("LHGPU_BLS_BACKEND")

    def broken():
        raise OSError("device probe failed")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    before = api.faults().get(("auto", "probe"), 0)
    assert api.resolve_auto_backend() == "reference"
    assert api.faults()[("auto", "probe")] == before + 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert api.resolve_auto_backend() == "cuda"
    with pytest.raises(KeyError):
        bls.set_backend("tpu")
