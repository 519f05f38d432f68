"""Deterministic fault injection for the card's offload path, and the
watchdog that turns a hang into a fault.

Port of the device-fault part of ``lighthouse_tpu/ops/faults.py``
(``DeviceFault`` and its kinds, ``FaultPlan``, ``install_plan``,
``clear``, ``active_plan``, ``plan_from_env``, ``corrupt_verdict``,
``fire`` :198-240, ``under_watchdog``, ``run_with_deadline`` :578-604 and
``classify``).  An installed plan makes the instrumented sites fail on
command; the BLS supervisor (``crypto/bls/api.py``) recovers from each.
What counts as a fault of the card is :func:`is_device_fault`: the
recoveries catch nothing else, so a bug of the calling code raises.

Sites: ``cuda`` (the ``cuda`` backend's entry, ``ops/bls_backend.py``),
``subgroup`` (the ψ verdict's launch), ``chunk`` (each chunk of the
pipeline and of the sharded backend, ``index`` the chunk), ``verdict``
(the deferred verdict read, ``ops/dispatch_pipeline.py``) and ``sharded``
(the sharded backend's entry, ``parallel/bls_sharded.py``).

==========  =================================================================
mode        at a matching site
==========  =================================================================
raise       raise :class:`InjectedFault` (a failed launch)
compile     raise :class:`InjectedCompileFault` (a failed kernel build)
hang        sleep ``hang_s`` seconds, then raise: the caller's watchdog must
            cut the stall off, and an abandoned watchdog thread never goes
            on into real device work
corrupt     return ``"corrupt"``: the site substitutes
            :func:`corrupt_verdict` (or flips its verdict), a card that
            silently returned garbage
==========  =================================================================

Plans come from :func:`install_plan` (tests, the smoke run) or from the
``LHGPU_FAULT_MODE`` / ``_SITE`` / ``_INDICES`` / ``_HANG_S`` /
``_MAX_FIRES`` variables, read at the first :func:`fire` after
:func:`clear`.  The peer and ingest plans of the JAX module belong to the
network and the processor, which the port does not have yet.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field

_LOG = logging.getLogger(__name__)


class DeviceFault(RuntimeError):
    """Base class of the offload faults the supervisor recovers from."""


class InjectedFault(DeviceFault):
    """Raised by an installed :class:`FaultPlan` (modes raise and hang)."""


class InjectedCompileFault(InjectedFault):
    """A failed kernel build at launch time."""


class WatchdogTimeout(DeviceFault):
    """A supervised call outlived its deadline."""


VALID_MODES = ("raise", "hang", "corrupt", "compile")


@dataclass
class FaultPlan:
    """One injection directive (see the module table for ``mode``)."""

    mode: str
    sites: frozenset = frozenset({"cuda"})
    indices: frozenset | None = None   # chunk indices; None: every hit
    hang_s: float = 0.05
    max_fires: int | None = None       # stop after this many fires
    corrupt_value: bool = True         # the verdict a corrupt site returns
    fires: int = field(default=0)

    def __post_init__(self):
        if self.mode not in VALID_MODES:
            raise ValueError(f"fault mode {self.mode!r} not in {VALID_MODES}")
        self.sites = frozenset(self.sites)
        if self.indices is not None:
            self.indices = frozenset(int(i) for i in self.indices)


_LOCK = threading.Lock()
_PLAN: FaultPlan | None = None
_ENV_LOADED = False


def install_plan(plan: FaultPlan | None) -> None:
    """Install (or, with None, remove) the process-wide plan; it wins over
    the environment's."""
    global _PLAN, _ENV_LOADED
    with _LOCK:
        _PLAN = plan
        _ENV_LOADED = True


def clear() -> None:
    """Remove any plan and forget the environment's (the next fire reads
    it again)."""
    global _PLAN, _ENV_LOADED
    with _LOCK:
        _PLAN = None
        _ENV_LOADED = False


def plan_from_env() -> FaultPlan | None:
    """The plan of the ``LHGPU_FAULT_*`` variables; None when
    ``LHGPU_FAULT_MODE`` is unset.  A malformed value logs a warning and
    disables injection."""
    mode = os.environ.get("LHGPU_FAULT_MODE", "").strip()
    if not mode:
        return None
    sites = frozenset(s.strip() for s in os.environ.get("LHGPU_FAULT_SITE", "cuda").split(",")
                      if s.strip())
    try:
        raw = os.environ.get("LHGPU_FAULT_INDICES", "").strip()
        indices = frozenset(int(i) for i in raw.split(",") if i.strip()) if raw else None
        fires = os.environ.get("LHGPU_FAULT_MAX_FIRES", "").strip()
        return FaultPlan(mode=mode, sites=sites, indices=indices,
                         hang_s=float(os.environ.get("LHGPU_FAULT_HANG_S", "30")),
                         max_fires=int(fires) if fires else None)
    except ValueError as e:
        _LOG.warning("ignoring malformed LHGPU_FAULT_* settings (%s): no fault injection", e)
        return None


def active_plan() -> FaultPlan | None:
    global _PLAN, _ENV_LOADED
    with _LOCK:
        if not _ENV_LOADED:
            _PLAN = plan_from_env()
            _ENV_LOADED = True
        return _PLAN


def corrupt_verdict() -> bool:
    """The verdict a corrupt-mode site returns in place of its own."""
    plan = active_plan()
    return plan.corrupt_value if plan is not None else True


def fire(site: str, index: int = 0) -> str | None:
    """Consult the active plan at an instrumented site: None (no fault),
    ``"corrupt"`` (the caller substitutes or flips its verdict), or the
    planned fault raised.  ``index`` is the chunk at looped sites."""
    plan = active_plan()
    if plan is None or site not in plan.sites:
        return None
    with _LOCK:
        if plan is not _PLAN:
            return None                   # the plan changed underneath
        if plan.indices is not None and int(index) not in plan.indices:
            return None
        if plan.max_fires is not None and plan.fires >= plan.max_fires:
            return None
        plan.fires += 1
    if plan.mode == "corrupt":
        return "corrupt"
    if plan.mode == "compile":
        raise InjectedCompileFault(f"injected kernel build failure at {site}[{index}]")
    if plan.mode == "hang":
        time.sleep(plan.hang_s)
        raise InjectedFault(f"injected hang released after {plan.hang_s}s at {site}[{index}]")
    raise InjectedFault(f"injected device fault at {site}[{index}]")


def supervisor_enabled() -> bool:
    """``LHGPU_SUPERVISOR`` (on unless ``0`` or ``false``): the supervisor
    runs the device backends."""
    return os.environ.get("LHGPU_SUPERVISOR", "1").strip() not in ("0", "false")


# --- the watchdog ------------------------------------------------------------

_UNDER_WATCHDOG = threading.local()


def under_watchdog() -> bool:
    """True on a thread that :func:`run_with_deadline` started (a nested
    deadline there is redundant: :func:`run_with_deadline` runs inline)."""
    return getattr(_UNDER_WATCHDOG, "value", False)


def _cuda_context():
    """The caller's CUDA device and stream when CUDA is in use, else None:
    ``torch.cuda.current_device()`` and the current stream are per thread,
    so a watchdog thread must take the caller's."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.current_device(), torch.cuda.current_stream()


IDLE_NAME = "lhgpu-watchdog-idle"


class _Worker:
    """A daemon thread that runs watchdog jobs one after another.  It is
    kept between calls (a new thread a batch would pay for its own memory
    arena and thread pools each time) until a job outlives its deadline:
    then it is abandoned and ends when that job returns."""

    def __init__(self):
        self.jobs: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=self._loop, daemon=True, name=IDLE_NAME).start()

    def _loop(self):
        _UNDER_WATCHDOG.value = True
        while (job := self.jobs.get()) is not None:
            job()


_IDLE: list[_Worker] = []
_IDLE_LOCK = threading.Lock()


def run_with_deadline(fn, timeout_s: float, thread_name: str, what: str):
    """Run ``fn()`` on a watchdog thread (an idle one, or a new daemon
    thread) named ``thread_name`` while it runs, on the caller's CUDA
    device and stream, and raise :class:`WatchdogTimeout` after
    ``timeout_s`` seconds.  On a timeout the thread is abandoned (its late
    result or exception is dropped); an exception of ``fn`` re-raises on
    the caller.  On a watchdog thread already, ``fn`` runs inline: the
    outer deadline covers it."""
    if under_watchdog():
        return fn()
    box: dict = {}
    done = threading.Event()
    ctx = _cuda_context()

    def job():
        me = threading.current_thread()
        me.name = thread_name
        try:
            if ctx is None:
                box["ok"] = fn()
            else:
                import torch

                torch.cuda.set_device(ctx[0])
                with torch.cuda.stream(ctx[1]):
                    box["ok"] = fn()
        except BaseException as e:       # re-raised on the caller below
            box["exc"] = e
        finally:
            me.name = IDLE_NAME
            done.set()

    with _IDLE_LOCK:
        worker = _IDLE.pop() if _IDLE else None
    worker = worker or _Worker()
    worker.jobs.put(job)
    if not done.wait(timeout_s):
        worker.jobs.put(None)            # abandoned: it ends after the stuck job
        raise WatchdogTimeout(f"{what} exceeded its {timeout_s:.3f}s watchdog deadline")
    with _IDLE_LOCK:
        _IDLE.append(worker)
    if "exc" in box:
        raise box["exc"]
    return box.get("ok")


# what the port's kernel wrappers and builders (``CUDA error`` with the
# runtime's code, ``failed to build``, ``nvcc not found``, the tapes'
# ``did not build``) and torch's CUDA runtime put in the RuntimeError they
# raise
_DEVICE_ERROR_MARKERS = ("CUDA error", "CUDA out of memory", "CUDA driver error",
                         "failed to build", "nvcc not found", "did not build",
                         "refused the tapes")


def is_device_fault(exc: BaseException) -> bool:
    """Is ``exc`` a fault of the card or of a kernel's build, which a
    recovery may answer on the host?  A :class:`DeviceFault` (an injected
    fault, a watchdog timeout, garbage read back from the card), torch's
    out-of-memory and accelerator errors, or a ``RuntimeError`` that names
    a CUDA or build failure.  Anything else (a ``TypeError``, a bad
    layout's ``ValueError``) is a bug of the calling code and propagates."""
    if isinstance(exc, DeviceFault):
        return True
    import torch

    cuda_types = tuple(t for t in (getattr(torch.cuda, "OutOfMemoryError", None),
                                   getattr(torch, "AcceleratorError", None)) if t is not None)
    if cuda_types and isinstance(exc, cuda_types):
        return True
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in _DEVICE_ERROR_MARKERS)


def classify(exc: BaseException) -> str:
    """The fault's kind for the counters: hang, compile or raise."""
    if isinstance(exc, WatchdogTimeout):
        return "hang"
    if isinstance(exc, InjectedCompileFault):
        return "compile"
    if "compil" in f"{type(exc).__name__}: {exc}".lower():
        return "compile"
    return "raise"
