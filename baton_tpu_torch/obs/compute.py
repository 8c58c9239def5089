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
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

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

# model-name prefix -> family key in MODEL_FAMILY_FLOPS
_FAMILY_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("resnet18", "resnet18_cifar"),
)


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

    def __init__(self) -> None:
        self._sigs: Dict[Any, set] = {}
        self._recent: Dict[Any, deque] = {}

    def observe(self, key: Any, signature: Any, wall_s: Optional[float] = None) -> dict:
        """Record one call of ``key`` with shape ``signature``; ``wall_s``
        is that call's wall time (``compile_s`` on a miss)."""
        sigs = self._sigs.setdefault(key, set())
        miss = signature not in sigs
        if miss:
            sigs.add(signature)
        recent = self._recent.setdefault(key, deque(maxlen=RECOMPILE_STORM_WINDOW))
        recent.append(miss)
        out: dict = {
            "cache_hit": not miss,
            "recompiles": max(0, len(sigs) - 1),
            "recompile_storm": sum(recent) >= RECOMPILE_STORM_THRESHOLD,
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
    model_family: Optional[str] = None,
    model_family_reason: Optional[str] = None,
    compile_fields: Optional[dict] = None,
    peak_hbm_gb: Optional[float] = None,
    peak_hbm_source: Optional[str] = None,
    peak_hbm_reason: Optional[str] = None,
) -> dict:
    """One round's compute record, with throughput and MFU derived and
    the null-with-reason invariant kept by construction. The port runs a
    round on one device, so per chip is per round."""
    train_s = float(train_s)
    rec: dict = {
        "train_s": round(train_s, 6),
        "steps": int(steps) if steps is not None else int(max(1, n_epochs)),
        "n_chips": 1,
        "device_kind": device_kind,
    }
    rec["model_family"] = model_family
    if model_family is None:
        rec["model_family_reason"] = model_family_reason or "model family unknown"
    if train_s > 0 and n_samples > 0:
        sps = float(n_samples) * max(1, int(n_epochs)) / train_s
        rec["samples_per_sec"] = round(sps, 3)
        rec["samples_per_sec_per_chip"] = round(sps, 3)
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
    round's compute record."""

    def __init__(self, model: Any) -> None:
        self.model_family, self.model_family_reason = model_family_of(model)
        self.tracker = CompileTracker()

    def record_round(self, *, key: Any, signature: Any, train_s: float, n_samples: float,
                     device: torch.device, n_epochs: int = 1,
                     steps: Optional[int] = None) -> dict:
        gb, source, reason = peak_memory_gb(device)
        return build_record(
            train_s=train_s,
            n_samples=n_samples,
            n_epochs=n_epochs,
            steps=steps,
            device_kind=device_kind_of(device),
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
