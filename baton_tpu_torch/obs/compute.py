"""Compute probe: analytic FLOPs and MFU, warm-up tracking and peak
device memory for each training round (counterpart of
``baton_tpu/obs/compute.py``).

``FedSim.run_round`` fills ``last_compute`` with one record per round.
Every ``None`` in a record carries a sibling ``<name>_reason`` or
``<name>_source`` string (:func:`validate_record`): a silent null reads as
"stopped measuring" and hides regressions.

What differs from the JAX package:

* The MFU denominator is the card's peak dense bf16 FLOP/s, looked up by
  ``torch.cuda.get_device_name()`` in :data:`CUDA_PEAKS` (NVIDIA's data
  sheets). No TPU figure is kept: an unknown device, the CPU included,
  gets a null MFU with a reason.
* Peak memory is ``torch.cuda.max_memory_allocated`` (the allocator's
  peak since the process started or its last reset); on the CPU it is
  null with a reason.
* Nothing is compiled, but the first call with a new shape signature
  still pays one-time work (cuDNN and cuBLAS plan selection, the caching
  allocator's growth, lazy CUDA initialisation): :class:`CompileTracker`
  marks it, and ``compile_s`` is that warm-up call's wall time.

As in the JAX package, :func:`register_model_flops` adds a model family's
analytic training FLOPs per sample, so that rounds of that family get a
measured MFU; a probe resolves its model's family when it is built.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# ResNet-18 (CIFAR-10 variant, 32x32 input): 0.557 GMAC forward per image
# = 1.11 GFLOP; training ~3x forward (forward + 2x backward).
RESNET18_CIFAR_FWD_FLOPS_PER_IMG = 1.11e9
TRAIN_FLOPS_PER_IMG = 3.0 * RESNET18_CIFAR_FWD_FLOPS_PER_IMG

#: (substrings of the device name, dense bf16 tensor FLOP/s, memory
#: bytes/s), first match wins; from NVIDIA's data sheets
CUDA_PEAKS: Tuple[Tuple[Tuple[str, ...], float, float], ...] = (
    (("H100", "PCIe"), 756e12, 2.0e12),
    (("H200",), 989e12, 4.8e12),
    (("H100",), 989e12, 3.35e12),  # SXM
)

#: analytic *training* FLOPs per sample, by model family
MODEL_FAMILY_FLOPS: Dict[str, float] = {
    "resnet18_cifar": TRAIN_FLOPS_PER_IMG,
}

# model-name prefix -> family key in MODEL_FAMILY_FLOPS, first match wins
_FAMILY_PREFIXES: List[Tuple[str, str]] = [
    ("resnet18", "resnet18_cifar"),
]


def register_model_flops(family: str, train_flops_per_sample: float,
                         name_prefixes: Sequence[str] = ()) -> None:
    """Register a model family's analytic training FLOPs per sample, so
    that rounds of that family get a measured MFU; ``name_prefixes`` map
    ``FedModel.name`` values to the family (appended: earlier prefixes
    match first)."""
    if not (train_flops_per_sample > 0):
        raise ValueError("train_flops_per_sample must be > 0")
    MODEL_FAMILY_FLOPS[family] = float(train_flops_per_sample)
    for p in name_prefixes:
        _FAMILY_PREFIXES.append((str(p), family))


def card_peaks(device_kind: str) -> Optional[Tuple[float, float]]:
    """(memory bytes/s, dense bf16 FLOP/s) of a CUDA card by its name, or
    None for a device not in :data:`CUDA_PEAKS`."""
    for parts, flops, bandwidth in CUDA_PEAKS:
        if all(p in device_kind for p in parts):
            return bandwidth, flops
    return None


def model_family_of(model: Any) -> Tuple[Optional[str], Optional[str]]:
    """``(family, reason)`` for a model, anything with a ``name``, or a
    bare name; an unknown family gives ``(None, reason)``."""
    name = model if isinstance(model, str) else getattr(model, "name", None)
    if not name:
        return None, "model has no name attribute"
    for prefix, family in _FAMILY_PREFIXES:
        if name.startswith(prefix):
            return family, None
    return None, f"no FLOPs accounting registered for model {name!r}"


def train_flops_per_sample(family: Optional[str]) -> Tuple[Optional[float], Optional[str]]:
    if family is None:
        return None, "model family unknown"
    flops = MODEL_FAMILY_FLOPS.get(family)
    if flops is None:
        return None, f"no FLOPs accounting for family {family!r}"
    return flops, None


def peak_flops_for(device_kind: str) -> Tuple[Optional[float], Optional[str]]:
    """The device's peak dense bf16 FLOP/s, or ``(None, reason)``."""
    peaks = card_peaks(device_kind)
    if peaks is None:
        return None, f"no peak-FLOPs spec for device kind {device_kind!r}"
    return peaks[1], None


def compute_mfu(samples_per_sec_per_chip: Optional[float], flops_per_sample: Optional[float],
                device_kind: str) -> Tuple[Optional[float], Optional[str]]:
    """MFU = delivered analytic training FLOP/s over the device's peak;
    ``(None, reason)`` when any input is unavailable."""
    if samples_per_sec_per_chip is None:
        return None, "throughput unmeasured"
    if flops_per_sample is None:
        return None, "model FLOPs unavailable"
    peak, why = peak_flops_for(device_kind)
    if peak is None:
        return None, why
    return samples_per_sec_per_chip * flops_per_sample / peak, None


# ---------------------------------------------------------------------------
# Warm-up tracking

#: new shape signatures within the window that flag a recompile storm
RECOMPILE_STORM_THRESHOLD = 3
RECOMPILE_STORM_WINDOW = 8


class CompileTracker:
    """Shape-signature watcher: a call with a signature not seen before
    for ``key`` is a warm-up call (a miss); repeated misses within a short
    window are a storm of shape churn."""

    def __init__(self, storm_window: int = RECOMPILE_STORM_WINDOW,
                 storm_threshold: int = RECOMPILE_STORM_THRESHOLD) -> None:
        self.storm_window = max(2, int(storm_window))
        self.storm_threshold = max(2, int(storm_threshold))
        self._sigs: Dict[Any, set] = {}
        self._recent: Dict[Any, deque] = {}

    def observe(self, key: Any, signature: Any, wall_s: Optional[float] = None) -> dict:
        """Record one call of ``key`` with shape ``signature``; ``wall_s``
        is that call's wall time (``compile_s`` on a miss)."""
        sigs = self._sigs.setdefault(key, set())
        miss = signature not in sigs
        if miss:
            sigs.add(signature)
        recent = self._recent.setdefault(key, deque(maxlen=self.storm_window))
        recent.append(miss)
        out: dict = {
            "cache_hit": not miss,
            "recompiles": max(0, len(sigs) - 1),
            "recompile_storm": sum(recent) >= self.storm_threshold,
        }
        if not miss:
            out["compile_s"] = 0.0
            out["compile_s_source"] = "cache_hit"
        elif wall_s is not None:
            out["compile_s"] = float(wall_s)
            out["compile_s_source"] = "first_call_wall"
        else:
            out["compile_s"] = None
            out["compile_s_reason"] = "wall time unavailable for the warm-up call"
        return out


# ---------------------------------------------------------------------------
# Records and the null-with-reason invariant

def validate_record(record: dict) -> List[str]:
    """Every ``None`` value must have a non-empty ``<key>_reason`` or
    ``<key>_source`` sibling string. Returns the violations."""
    bad = []
    for key, val in record.items():
        if val is not None:
            continue
        if key.endswith(("_reason", "_source")):
            bad.append(f"{key}: reason/source field itself is null")
            continue
        excuse = record.get(f"{key}_reason") or record.get(f"{key}_source")
        if not (isinstance(excuse, str) and excuse):
            bad.append(f"{key}: null without {key}_reason/{key}_source")
    return bad


def build_record(
    *,
    train_s: float,
    n_samples: float,
    n_epochs: int = 1,
    steps: Optional[int] = None,
    device_kind: str = "unknown",
    n_chips: int = 1,
    model_family: Optional[str] = None,
    model_family_reason: Optional[str] = None,
    compile_fields: Optional[dict] = None,
    peak_hbm_gb: Optional[float] = None,
    peak_hbm_source: Optional[str] = None,
    peak_hbm_reason: Optional[str] = None,
) -> dict:
    """One round's compute record, with throughput and MFU derived and
    the null-with-reason invariant kept by construction. ``n_samples`` is
    the whole round's, trained over ``n_chips`` chips (the distinct
    (process, device) pairs of a mesh; 1 off a mesh and on a mesh whose
    shards all lie on one card), so the per-chip rate is the round's rate
    over ``n_chips``."""
    train_s = float(train_s)
    n_chips = max(1, int(n_chips))
    rec: dict = {
        "train_s": round(train_s, 6),
        "steps": int(steps) if steps is not None else int(max(1, n_epochs)),
        "n_chips": n_chips,
        "device_kind": device_kind,
    }
    rec["model_family"] = model_family
    if model_family is None:
        rec["model_family_reason"] = model_family_reason or "model family unknown"
    if train_s > 0 and n_samples > 0:
        sps = float(n_samples) * max(1, int(n_epochs)) / train_s
        rec["samples_per_sec"] = round(sps, 3)
        rec["samples_per_sec_per_chip"] = round(sps / n_chips, 3)
    else:
        why = "zero training wall time" if n_samples > 0 else "no samples"
        rec["samples_per_sec"] = None
        rec["samples_per_sec_reason"] = why
        rec["samples_per_sec_per_chip"] = None
        rec["samples_per_sec_per_chip_reason"] = why
    flops, flops_why = train_flops_per_sample(model_family)
    rec["flops_per_sample"] = flops
    if flops is None:
        rec["flops_per_sample_reason"] = flops_why
    mfu, mfu_why = compute_mfu(rec["samples_per_sec_per_chip"], flops, device_kind)
    rec["mfu"] = None if mfu is None else round(mfu, 6)
    if mfu is None:
        rec["mfu_reason"] = mfu_why
    rec.update(compile_fields or {
        "compile_s": None,
        "compile_s_reason": "warm-up tracking not wired for this path",
    })
    if peak_hbm_gb is not None:
        rec["peak_hbm_gb"] = round(float(peak_hbm_gb), 6)
        rec["peak_hbm_gb_source"] = peak_hbm_source or "unspecified"
    else:
        rec["peak_hbm_gb"] = None
        rec["peak_hbm_gb_reason"] = peak_hbm_reason or "no allocator statistics available"
    violations = validate_record(rec)
    if violations:  # unreachable: every null above gets its reason
        raise ValueError(f"compute record breaks null-with-reason: {violations}")
    return rec


def device_kind_of(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_memory_gb(device: torch.device) -> Tuple[Optional[float], Optional[str], Optional[str]]:
    """(GB, source, reason): the caching allocator's peak on a CUDA
    device; null with a reason elsewhere."""
    if device.type != "cuda":
        return None, None, f"no allocator statistics on the {device.type} device"
    return torch.cuda.max_memory_allocated(device) / 1e9, "torch.cuda.max_memory_allocated", None


class ComputeProbe:
    """One training call site's probe: :meth:`record_round` is called once
    per round with its wall time and shape signature and returns the
    round's compute record. An explicit ``model_family`` wins over the
    model's name; the family is resolved when the probe is built."""

    def __init__(self, model: Any = None, model_family: Optional[str] = None,
                 storm_window: int = RECOMPILE_STORM_WINDOW,
                 storm_threshold: int = RECOMPILE_STORM_THRESHOLD) -> None:
        if model_family is not None:
            self.model_family: Optional[str] = model_family
            self.model_family_reason: Optional[str] = None
        elif model is not None:
            self.model_family, self.model_family_reason = model_family_of(model)
        else:
            self.model_family, self.model_family_reason = None, "no model attached to probe"
        self.tracker = CompileTracker(storm_window, storm_threshold)
        # the process's device and the run's device count do not change
        # while it runs; resolve them once a probe
        self._cached_device: Optional[torch.device] = None
        self._cached_n_chips: Optional[int] = None

    @staticmethod
    def _device() -> torch.device:
        """The device this process's work runs on: its current card when
        CUDA is up, else the CPU (``jax.devices()[0]`` in the JAX
        package). The probe only names it; nothing runs there."""
        if torch.cuda.is_available():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    @staticmethod
    def _n_chips(device: torch.device) -> int:
        """The run's device count (``jax.device_count()`` in the JAX
        package): the process group's world size when one is up, else
        the cards of this process when the device is a card, else 1."""
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        if device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def record_round(self, *, key: Any, signature: Any, train_s: float, n_samples: float,
                     n_epochs: int = 1, steps: Optional[int] = None,
                     device: Optional[torch.device] = None,
                     n_chips: Optional[int] = None) -> dict:
        """One round's record. ``device`` and ``n_chips`` default to the
        process's device and the run's device count, each resolved once
        a probe; explicit values are used as given."""
        if device is None:
            if self._cached_device is None:
                self._cached_device = self._device()
            device = self._cached_device
        if n_chips is None:
            if self._cached_n_chips is None:
                self._cached_n_chips = self._n_chips(device)
            n_chips = self._cached_n_chips
        gb, source, reason = peak_memory_gb(device)
        return build_record(
            train_s=train_s,
            n_samples=n_samples,
            n_epochs=n_epochs,
            steps=steps,
            device_kind=device_kind_of(device),
            n_chips=n_chips,
            model_family=self.model_family,
            model_family_reason=self.model_family_reason,
            compile_fields=self.tracker.observe(key, signature, wall_s=train_s),
            peak_hbm_gb=gb,
            peak_hbm_source=source,
            peak_hbm_reason=reason,
        )


# ---------------------------------------------------------------------------
# Round-level aggregation (the rounds.jsonl ``compute`` section)

def _nums(records: Sequence[dict], key: str) -> List[float]:
    return [float(r[key]) for r in records
            if isinstance(r.get(key), (int, float)) and not isinstance(r.get(key), bool)
            and math.isfinite(float(r[key]))]


def _first_reason(records: Sequence[dict], key: str, default: str) -> str:
    for r in records:
        why = r.get(f"{key}_reason") or r.get(f"{key}_source")
        if isinstance(why, str) and why:
            return why
    return default


def summarize_round(records: Sequence[dict]) -> dict:
    """Fold the reporters' compute records into one round ``compute``
    section; a value no reporter measured is null with the first
    reporter's reason."""
    records = [r for r in records if isinstance(r, dict)]
    out: dict = {"reporters": len(records)}
    if not records:
        for key in ("compile_s", "steps", "samples_per_sec_per_chip", "mfu", "peak_hbm_gb"):
            out[key] = None
            out[f"{key}_reason"] = "no compute records this round"
        out["recompile_storms"] = 0
        return out

    def put(key: str, vals: List[float], agg) -> None:
        if vals:
            out[key] = round(agg(vals), 6)
        else:
            out[key] = None
            out[f"{key}_reason"] = _first_reason(records, key, f"no reporter measured {key}")

    put("compile_s", _nums(records, "compile_s"), max)
    steps = _nums(records, "steps")
    out["steps"] = int(sum(steps)) if steps else None
    if not steps:
        out["steps_reason"] = "no reporter measured steps"
    put("samples_per_sec_per_chip", _nums(records, "samples_per_sec_per_chip"),
        lambda v: sum(v) / len(v))
    put("mfu", _nums(records, "mfu"), lambda v: sum(v) / len(v))
    hbm = _nums(records, "peak_hbm_gb")
    if hbm:
        out["peak_hbm_gb"] = round(max(hbm), 6)
        out["peak_hbm_gb_source"] = _first_reason(records, "peak_hbm_gb", "allocator")
    else:
        out["peak_hbm_gb"] = None
        out["peak_hbm_gb_reason"] = _first_reason(records, "peak_hbm_gb",
                                                  "no reporter measured peak HBM")
    out["recompile_storms"] = sum(1 for r in records if r.get("recompile_storm"))
    return out
