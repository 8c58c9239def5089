"""The port's compute probe: records keep the null-with-reason invariant,
MFU divides by the card's peak looked up by its CUDA name (no TPU entry,
none for the CPU), warm-up calls are marked by first-seen shape
signatures, the per-chip rate divides by the chips a round ran on, and
``summarize_round`` folds records as the JAX package's does."""

import pytest
import torch

from baton_tpu.obs import compute as jcompute
from baton_tpu_torch.obs import compute

H100_SXM = "NVIDIA H100 80GB HBM3"


def test_h100_mfu_from_a_fixed_train_s():
    rec = compute.build_record(train_s=0.25, n_samples=1536, n_epochs=1, steps=64,
                               device_kind=H100_SXM, model_family="resnet18_cifar",
                               peak_hbm_gb=12.5, peak_hbm_source="torch.cuda.max_memory_allocated")
    assert compute.validate_record(rec) == []
    assert rec["samples_per_sec"] == pytest.approx(1536 / 0.25)
    assert rec["flops_per_sample"] == pytest.approx(3.33e9)
    assert rec["mfu"] == pytest.approx(1536 / 0.25 * 3.33e9 / 989e12, rel=1e-5)
    assert rec["peak_hbm_gb"] == 12.5 and rec["steps"] == 64


@pytest.mark.parametrize("n_chips", [1, 2, 4])
def test_per_chip_rate_and_mfu_divide_by_the_chips_as_the_references_do(n_chips):
    """A round over ``n_chips`` chips: the per-chip rate and the MFU are the
    round's over ``n_chips``, as in the JAX package's record."""
    kw = dict(train_s=0.25, n_samples=1536, steps=64, device_kind=H100_SXM,
              model_family="resnet18_cifar", n_chips=n_chips)
    rec = compute.build_record(**kw)
    ref = jcompute.build_record(**kw)
    assert rec["n_chips"] == ref["n_chips"] == n_chips
    assert rec["samples_per_sec"] == pytest.approx(1536 / 0.25)
    assert rec["samples_per_sec_per_chip"] == ref["samples_per_sec_per_chip"] == \
        pytest.approx(1536 / 0.25 / n_chips)
    assert rec["mfu"] == pytest.approx(1536 / 0.25 / n_chips * 3.33e9 / 989e12, abs=1e-6)


@pytest.mark.parametrize("name,flops,bandwidth", [
    (H100_SXM, 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H200", 989e12, 4.8e12),
])
def test_card_peaks_by_cuda_name(name, flops, bandwidth):
    assert compute.card_peaks(name) == (bandwidth, flops)
    assert compute.peak_flops_for(name) == (flops, None)


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "TPU v4", "NVIDIA A100-SXM4-80GB"])
def test_no_peak_and_a_null_mfu_with_reason_elsewhere(kind):
    peak, why = compute.peak_flops_for(kind)
    assert peak is None and kind in why
    rec = compute.build_record(train_s=1.0, n_samples=10, device_kind=kind,
                               model_family="resnet18_cifar")
    assert rec["mfu"] is None and rec["mfu_reason"]
    assert compute.validate_record(rec) == []


def test_cpu_record_from_the_probe():
    probe = compute.ComputeProbe(model="resnet18_cifar")
    rec = probe.record_round(key="run_round", signature=("s",), train_s=0.5, n_samples=8,
                             device=torch.device("cpu"), steps=4)
    assert compute.validate_record(rec) == []
    assert rec["device_kind"] == "cpu" and rec["n_chips"] == 1
    assert rec["peak_hbm_gb"] is None and "cpu" in rec["peak_hbm_gb_reason"]
    assert rec["mfu"] is None and rec["model_family"] == "resnet18_cifar"
    assert rec["cache_hit"] is False and rec["compile_s"] == 0.5
    again = probe.record_round(key="run_round", signature=("s",), train_s=0.1, n_samples=8,
                               device=torch.device("cpu"))
    assert again["cache_hit"] is True and again["compile_s"] == 0.0


def test_unknown_model_family_is_null_with_reason():
    probe = compute.ComputeProbe(model="lineartest")
    assert probe.model_family is None and "lineartest" in probe.model_family_reason
    rec = probe.record_round(key="k", signature=1, train_s=0.0, n_samples=0,
                             device=torch.device("cpu"))
    assert rec["samples_per_sec"] is None and rec["samples_per_sec_reason"] == "no samples"
    assert compute.validate_record(rec) == []


def test_compile_tracker_marks_warm_ups_and_storms():
    tracker = compute.CompileTracker()
    first = tracker.observe("f", (1,), wall_s=2.0)
    assert first["cache_hit"] is False and first["compile_s"] == 2.0
    assert first["compile_s_source"] == "first_call_wall"
    assert tracker.observe("f", (1,), wall_s=0.1)["compile_s"] == 0.0
    assert tracker.observe("f", (2,))["recompile_storm"] is False
    storm = tracker.observe("f", (3,))
    assert storm["recompile_storm"] is True and storm["recompiles"] == 2
    for _ in range(compute.RECOMPILE_STORM_WINDOW):
        calm = tracker.observe("f", (1,))
    assert calm["recompile_storm"] is False
    assert compute.validate_record(tracker.observe("g", (1,))) == []


def test_validate_record_flags_a_null_without_reason():
    assert compute.validate_record({"mfu": None}) == ["mfu: null without mfu_reason/mfu_source"]
    assert compute.validate_record({"mfu": None, "mfu_reason": "x"}) == []
    assert compute.validate_record({"mfu_reason": None})


def test_summarize_round_matches_jax():
    records = [
        compute.build_record(train_s=0.5, n_samples=100, device_kind=H100_SXM,
                             model_family="resnet18_cifar", peak_hbm_gb=3.0,
                             peak_hbm_source="torch.cuda.max_memory_allocated",
                             compile_fields={"compile_s": 1.5, "compile_s_source": "x",
                                             "recompile_storm": True}),
        compute.build_record(train_s=0.25, n_samples=100, device_kind="cpu"),
        "not a record",
    ]
    assert compute.summarize_round(records) == jcompute.summarize_round(records)
    assert compute.summarize_round([]) == jcompute.summarize_round([])


def test_model_family_from_the_port_models():
    from baton_tpu_torch.models import cnn_mnist_model, resnet18_cifar_model
    probe = compute.ComputeProbe(resnet18_cifar_model(compute_dtype=torch.bfloat16))
    assert (probe.model_family, probe.model_family_reason) == ("resnet18_cifar", None)
    family, why = compute.model_family_of(cnn_mnist_model())
    assert family is None and "cnn" in why
    assert compute.model_family_of(object()) == (None, "model has no name attribute")
