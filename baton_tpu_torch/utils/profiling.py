"""Profiler hooks on ``torch.profiler`` (counterpart of the first part of
``baton_tpu/utils/profiling.py``).

* :func:`profile_trace` — context manager writing a Chrome trace of the
  enclosed block (host ops and, on a card, its kernels) to a directory.
  Enabled explicitly or via ``BATON_TPU_PROFILE=<dir>``; a no-op
  otherwise, so call sites can wrap hot paths unconditionally.
* :func:`arm_forensics_trace` / :func:`forensics_trace` — the alerting
  plane's one-shot capture of the next training step.
* :func:`annotate` — named region that shows up inside traces.
* :func:`timed` — wall-clock a function, synchronising the device of its
  tensor outputs, so asynchronous CUDA launches don't fake instant
  completion.
* The wave sizer's measurements (``FedSim.auto_wave_size``):
  :func:`is_oom_error`, :func:`device_budget_gb` and
  :func:`fedsim_wave_footprint_gb`. They take the place of the
  reference's XLA memory-plan readers (``hbm_budget_gb``,
  ``fedsim_wave_plan_gb``, ``fedsim_wave_hbm``): torch has no static
  plan, so a wave's footprint is measured from the caching allocator's
  peak in a trial wave, and the budget is the card's own memory, not a
  table of TPU budgets.
* The benchmark's set-up and probes: :func:`configure_torch_for_bench`
  (the kernels built once, a card-measured attention sweep applied),
  :func:`resolve_artifact_path` (the sweeps' clobber policy) and
  :func:`fedsim_fused_donation_plan` (the fused rounds' peak memory with
  and without buffer donation, measured on the card).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import torch

ENV_VAR = "BATON_TPU_PROFILE"
TRACE_FILE = "trace.json"


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextmanager
def _chrome_trace(log_dir: str):
    """Profile the enclosed block and write ``<log_dir>/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Trace the enclosed block to ``log_dir`` (or ``$BATON_TPU_PROFILE``).

    No-op when neither is set — safe to leave in production paths.
    """
    log_dir = log_dir or os.environ.get(ENV_VAR)
    if not log_dir:
        yield
        return
    with _chrome_trace(log_dir):
        yield


# ---------------------------------------------------------------------------
# Forensics arming: the alerting plane (obs/alerts.py) arms a one-shot
# profiler capture when a `capture: true` rule fires; the NEXT training
# step that reaches a `forensics_trace()` call site consumes the arm and
# traces itself into the armed directory. Consume-once under a lock so
# an alert storm cannot stack traces, and every profiler failure is
# swallowed — forensics is advisory, it must never break the step.

_FORENSICS_LOCK = threading.Lock()
_FORENSICS_DIR: Optional[str] = None


def arm_forensics_trace(log_dir: str) -> None:
    """Arm the next :func:`forensics_trace` call site to capture a
    profiler trace into ``log_dir``. Re-arming before the previous arm is
    consumed just re-points the directory."""
    global _FORENSICS_DIR
    with _FORENSICS_LOCK:
        _FORENSICS_DIR = log_dir


def forensics_armed() -> bool:
    with _FORENSICS_LOCK:
        return _FORENSICS_DIR is not None


@contextmanager
def forensics_trace():
    """Consume a pending forensics arm around the enclosed block,
    yielding the trace directory (or None when unarmed / the profiler
    refused to start). A profiler error never reaches the block."""
    global _FORENSICS_DIR
    with _FORENSICS_LOCK:
        log_dir, _FORENSICS_DIR = _FORENSICS_DIR, None
    if not log_dir:
        yield None
        return
    trace = None
    try:
        trace = _chrome_trace(log_dir)
        trace.__enter__()
    except Exception:
        trace = None
    try:
        yield log_dir if trace is not None else None
    finally:
        if trace is not None:
            try:
                trace.__exit__(None, None, None)
            except Exception:
                pass


def annotate(name: str):
    """Named trace region (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _devices(out: Any, found: set) -> set:
    if isinstance(out, torch.Tensor):
        found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def timed(fn: Callable, *args: Any, **kwargs: Any) -> Tuple[Any, float]:
    """Run ``fn`` and return ``(result, seconds)``, synchronising every
    CUDA device its tensor outputs live on, so the measurement covers
    device execution, not just the launches."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices(out, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# wave sizing on the card (FedSim.auto_wave_size)

GIB = float(1 << 30)
# the share of the card a wave's peak may not use: the CUDA context,
# cuBLAS/cuDNN workspaces and the caching allocator's fragmentation live
# outside the allocated bytes that max_memory_allocated counts
DEVICE_HEADROOM = 0.10


def is_oom_error(e: BaseException) -> bool:
    """True for the caching allocator's out-of-memory error."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def device_budget_gb(device) -> float:
    """GiB a wave may reach on ``device``: the card's total memory
    (``torch.cuda.mem_get_info``) less ``DEVICE_HEADROOM`` of it."""
    _, total = torch.cuda.mem_get_info(torch.device(device))
    return total * (1.0 - DEVICE_HEADROOM) / GIB


def fedsim_wave_footprint_gb(sim, params, data, n_samples, wave_size: int) -> Optional[float]:
    """Peak GiB that one wave of ``wave_size`` clients of ``sim``'s round
    (``FedSim._trial_wave``: one epoch of its training step on the first
    clients, folded as the round folds it, the results thrown away)
    allocates above the memory already in use on the card; None off the
    card (the CPU has no allocator peak). An out-of-memory error
    propagates (:func:`is_oom_error`)."""
    device = sim.device
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    in_use = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = sim._trial_wave(params, data, n_samples, wave_size)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - in_use
    del out
    return peak / GIB


# ---------------------------------------------------------------------------
# the benchmark's set-up and probes

# the card-measured flash-vs-dense crossover, where a sweep has written one
# (benchmarks/attention_sweep.py's record shape, "platform": "gpu")
ATTENTION_SWEEP = Path(__file__).resolve().parents[2] / "benchmarks" / "attention_sweep_gpu.json"


def configure_torch_for_bench(device="cuda") -> dict:
    """The benchmark process's set-up (the counterpart of the reference's
    ``configure_jax_for_bench``), under the port's device rule:
    ``device="cuda"`` needs a GPU and raises without one; nothing selects
    the CPU on its own. On the card the flash kernels are built (or loaded
    from ``ops/_build``) once here, so no timed call pays ``nvcc``: the
    counterpart of the persistent compilation cache. On either device the
    attention sweep at :data:`ATTENTION_SWEEP`, where one exists, goes to
    ``models.transformer.configure_attention_dispatch``, which trusts only
    ``"platform": "gpu"`` artifacts; a malformed artifact never raises.
    Returns what it did: ``{"device", "kernels" (the library's file name,
    or None on the CPU), "sweep" (the artifact's path, or None),
    "dispatch" (the flash threshold and tile now in effect)}``."""
    from baton_tpu_torch import resolve_device
    from baton_tpu_torch.models import transformer

    device = resolve_device(device)
    out = {"device": str(device), "kernels": None, "sweep": None, "dispatch": None}
    if device.type == "cuda":
        from baton_tpu_torch.ops import flash_attention as fa

        fa.load_library()
        out["kernels"] = fa.library_path().name
    if ATTENTION_SWEEP.exists():
        out["sweep"] = str(ATTENTION_SWEEP)
        try:
            out["dispatch"] = transformer.configure_attention_dispatch(
                sweep_path=str(ATTENTION_SWEEP))
        except Exception as e:  # a malformed artifact must never kill a bench run
            out["sweep_error"] = f"{type(e).__name__}: {e}"
    return out


def resolve_artifact_path(out_path: str, run_has_tpu_success: bool,
                          prior_has_tpu_success) -> str:
    """Shared artifact-clobber policy for the hardware sweeps: never
    overwrite a recorded artifact holding hardware measurements with a run
    that produced none (a run whose every cell failed, or a CPU smoke run
    with plausible-looking numbers). The lesser run is still evidence: it
    goes to a ``*_failed`` sibling instead.

    ``prior_has_tpu_success`` is a callable applied to the parsed prior
    JSON (artifact shapes differ per sweep); unreadable/foreign priors
    are treated as clobber-safe."""
    if run_has_tpu_success:
        return out_path
    try:
        with open(out_path) as f:
            prior = json.load(f)
        keep = bool(prior_has_tpu_success(prior))
    except (OSError, ValueError, TypeError, AttributeError, KeyError):
        return out_path
    if not keep:
        return out_path
    base, ext = os.path.splitext(out_path)
    return f"{base}_failed{ext or '.json'}"


def fedsim_fused_donation_plan(sim, params, data, n_samples, generator,
                               n_rounds: int = 2, n_epochs: int = 1,
                               wave_size: Optional[int] = None) -> dict:
    """The fused rounds' peak memory with and without buffer donation,
    measured on the card: the answer to "what does ``donate_buffers`` buy".
    Torch has no static memory plan, so where the reference compiles both
    variants and reads XLA's plan, this runs them: for each of donation
    on and off it takes fresh clones of ``params`` and of the server
    optimizer's fresh state (the caller's tensors are never touched),
    resets the caching allocator's peak and runs ``sim.run_rounds_fused``
    from ``generator`` for ``n_rounds`` rounds. Each variant's ``plan_gb``
    is the allocator's measured peak in GiB above the memory in use before
    the run (``torch.cuda.max_memory_allocated``), not a plan; beside it
    ``peak_gb`` (the peak itself), ``in_use_gb`` and ``donation`` (the
    run's ``last_fused["donation"]``). Returns ``{"donate_on": {...},
    "donate_off": {...}, "delta_gb": off - on}``, the keys the SLO gate
    reads. Without a CUDA device it raises ``RuntimeError``: the CPU has
    no allocator peak, and nothing falls back."""
    device = sim.device
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("fedsim_fused_donation_plan measures the caching allocator's peak "
                           "and needs a CUDA device; this FedSim runs on "
                           f"{device}")
    out = {}
    for label, donate in (("donate_on", True), ("donate_off", False)):
        start = {k: v.clone() for k, v in params.items()}
        sos = sim.init_server_opt_state(start)
        torch.cuda.synchronize(device)
        in_use = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        result = sim.run_rounds_fused(start, data, n_samples, generator, n_rounds=n_rounds,
                                      n_epochs=n_epochs, wave_size=wave_size,
                                      server_opt_state=sos, donate_buffers=donate)
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        out[label] = {"plan_gb": (peak - in_use) / GIB, "peak_gb": peak / GIB,
                      "in_use_gb": in_use / GIB, "donation": dict(sim.last_fused["donation"])}
        del result, start, sos
    out["delta_gb"] = out["donate_off"]["plan_gb"] - out["donate_on"]["plan_gb"]
    return out
