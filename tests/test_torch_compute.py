"""The port's compute probe: records keep the null-with-reason invariant,
MFU divides by the card's peak looked up by its CUDA name (no TPU entry,
none for the CPU), warm-up calls are marked by first-seen shape
signatures, the per-chip rate divides by the chips a round ran on, and
``summarize_round`` folds records as the JAX package's does. The FLOPs
registry (``register_model_flops``), the probe's ``model_family`` and the
tracker's storm window and threshold behave as the JAX package's on the
same calls; every test that registers a family restores both packages'
tables."""

import math

import numpy as np
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


@pytest.fixture
def fresh_registries(monkeypatch):
    """Both packages' FLOPs tables as copies, put back after the test."""
    for mod in (compute, jcompute):
        monkeypatch.setattr(mod, "MODEL_FAMILY_FLOPS", dict(mod.MODEL_FAMILY_FLOPS))
        monkeypatch.setattr(mod, "_FAMILY_PREFIXES", list(mod._FAMILY_PREFIXES))


def test_register_model_flops_roundtrip_in_both_packages(fresh_registries):
    """The reference's ``test_register_model_flops_roundtrip``, run against
    both packages with the same calls."""
    for mod in (compute, jcompute):
        mod.register_model_flops("toynet_test", 123.0, name_prefixes=["toynet"])
        assert mod.model_family_of("toynet_v2") == ("toynet_test", None)
        assert mod.train_flops_per_sample("toynet_test") == (123.0, None)
        with pytest.raises(ValueError):
            mod.register_model_flops("badnet", 0.0)
    assert compute.MODEL_FAMILY_FLOPS == jcompute.MODEL_FAMILY_FLOPS
    assert compute._FAMILY_PREFIXES == jcompute._FAMILY_PREFIXES


@pytest.mark.parametrize("flops", [0.0, -1.0, float("nan")])
def test_register_model_flops_refuses_what_the_reference_refuses(fresh_registries, flops):
    for mod in (compute, jcompute):
        with pytest.raises(ValueError, match="must be > 0"):
            mod.register_model_flops("badnet", flops, name_prefixes=["bad"])
        assert "badnet" not in mod.MODEL_FAMILY_FLOPS
        assert mod.model_family_of("badnet")[0] is None


def test_registered_prefixes_are_appended_so_resnet18_matches_first(fresh_registries):
    for mod in (compute, jcompute):
        mod.register_model_flops("catch_all", 7.0, name_prefixes=["res", "llama"])
        mod.register_model_flops("catch_all", 9.0, name_prefixes=["llama_lm"])
    for name in ("resnet18_cifar10", "resnet50", "llama_lm_lora16", "other"):
        assert compute.model_family_of(name) == jcompute.model_family_of(name), name
    assert compute.model_family_of("resnet18_cifar10")[0] == "resnet18_cifar"
    assert compute.train_flops_per_sample("catch_all") == (9.0, None)


def _h100(monkeypatch):
    monkeypatch.setattr(compute, "device_kind_of", lambda device: H100_SXM)
    monkeypatch.setattr(compute, "peak_memory_gb",
                        lambda device: (12.5, "torch.cuda.max_memory_allocated", None))


class _Device:
    device_kind = H100_SXM


@pytest.mark.parametrize("model,family", [(None, "toynet_test"), ("resnet18_x", "toynet_test"),
                                          ("toynet_v2", None)])
def test_probe_mfu_of_a_registered_family_on_an_h100(fresh_registries, monkeypatch, model,
                                                     family):
    """An explicit ``model_family`` wins over the model's name; the record's
    MFU is the per-chip rate times the registered FLOPs over the H100's
    peak, exact to the record's rounding."""
    _h100(monkeypatch)
    for mod in (compute, jcompute):
        mod.register_model_flops("toynet_test", 2.5e9, name_prefixes=["toynet"])
    kw = dict(key="run_round", signature=("s",), train_s=0.37, n_samples=96, n_epochs=2,
              n_chips=2)
    probe = compute.ComputeProbe(model, model_family=family)
    ref = jcompute.ComputeProbe(model, model_family=family)
    assert (probe.model_family, probe.model_family_reason) == ("toynet_test", None)
    assert (ref.model_family, ref.model_family_reason) == ("toynet_test", None)
    rec = probe.record_round(device=torch.device("cpu"), **kw)
    want = ref.record_round(device=_Device(), **kw)
    assert compute.validate_record(rec) == []
    for key in ("model_family", "flops_per_sample", "samples_per_sec",
                "samples_per_sec_per_chip", "n_chips", "device_kind"):
        assert rec[key] == want[key], key
    assert rec["flops_per_sample"] == 2.5e9
    assert rec["samples_per_sec_per_chip"] == round(96 * 2 / 0.37 / 2, 3)
    assert rec["mfu"] == round(rec["samples_per_sec_per_chip"] * 2.5e9 / 989e12, 6)
    assert want["mfu"] is None and H100_SXM in want["mfu_reason"]  # no TPU peak for it


def test_a_probe_without_a_model_says_so_as_the_reference_does():
    probe, ref = compute.ComputeProbe(), jcompute.ComputeProbe()
    assert (probe.model_family, probe.model_family_reason) == \
        (ref.model_family, ref.model_family_reason) == (None, "no model attached to probe")
    rec = probe.record_round(key="k", signature=1, train_s=0.5, n_samples=8,
                             device=torch.device("cpu"))
    assert rec["model_family"] is None and rec["model_family_reason"] == "no model attached to probe"
    assert rec["mfu"] is None and rec["flops_per_sample_reason"] == "model family unknown"
    assert compute.validate_record(rec) == []


@pytest.mark.parametrize("window,threshold", [(2, 2), (8, 3), (4, 2), (0, 1), (5, 9)])
def test_compile_tracker_flags_the_references_storms(window, threshold):
    """The same signatures through both trackers give the same records,
    storms included (the reasons' wording aside); a window or threshold
    below 2 is clamped to 2."""
    ours = compute.CompileTracker(window, threshold)
    ref = jcompute.CompileTracker(window, threshold)
    assert (ours.storm_window, ours.storm_threshold) == (ref.storm_window, ref.storm_threshold)
    assert min(ours.storm_window, ours.storm_threshold) >= 2
    rng = np.random.default_rng(window * 10 + threshold)
    storms = 0
    for i in range(200):
        key = "train" if i % 3 else "eval"
        sig = (int(rng.integers(0, 12)) if rng.random() < 0.4 else 0,)
        wall = None if i % 7 == 0 else float(i) / 10
        got, want = ours.observe(key, sig, wall_s=wall), ref.observe(key, sig, wall_s=wall)
        # the one difference is the wording of compile_s_reason (no compiler here)
        assert set(got) == set(want), (i, got, want)
        assert ({k: v for k, v in got.items() if not k.endswith("_reason")}
                == {k: v for k, v in want.items() if not k.endswith("_reason")}), (i, got, want)
        storms += got["recompile_storm"]
    # a threshold above the window can never be reached
    assert (0 < storms < 200) if ours.storm_threshold <= ours.storm_window else storms == 0


def test_probe_passes_its_storm_window_to_its_tracker():
    for mod in (compute, jcompute):
        probe = mod.ComputeProbe("lineartest", storm_window=3, storm_threshold=2)
        assert (probe.tracker.storm_window, probe.tracker.storm_threshold) == (3, 2)
        assert (mod.ComputeProbe().tracker.storm_window,
                mod.ComputeProbe().tracker.storm_threshold) == (8, 3)


def test_fedsim_records_the_flops_of_a_registered_family(fresh_registries):
    """A family registered before the sim is built reaches every round's
    record (on the CPU the MFU stays null: no peak for it)."""
    from baton_tpu_torch import FedSim
    from baton_tpu_torch.models.linear import linear_regression_model

    model = linear_regression_model(3)
    compute.register_model_flops("linear_test", 6.0 * 4, name_prefixes=[model.name])
    sim = FedSim(model, batch_size=2, device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    data = {"x": torch.ones(2, 4, 3), "y": torch.zeros(2, 4)}
    sim.run_round(params, data, torch.tensor([4, 3]), torch.Generator().manual_seed(1))
    rec = sim.last_compute
    assert rec["model_family"] == "linear_test" and rec["flops_per_sample"] == 24.0
    assert rec["mfu"] is None and "cpu" in rec["mfu_reason"]
    assert math.isfinite(rec["samples_per_sec"])


# Fields each side reads from its own run: the device it names, the chips it
# counts and the allocator it asks. The per-chip rate and the MFU divide by
# that side's ``n_chips`` and are checked against it.
_OWN_RUN = {"n_chips", "device_kind", "peak_hbm_gb", "peak_hbm_gb_source", "peak_hbm_gb_reason",
            "samples_per_sec_per_chip", "mfu", "mfu_reason"}


class _TPU:
    """A JAX device with a peak in the reference's table and no allocator."""
    device_kind = "TPU v5 lite"
    platform = "tpu"

    def memory_stats(self):
        return None


def _default_records(monkeypatch, kinds):
    """The same round through both probes with neither ``device`` nor
    ``n_chips`` given; ``kinds`` "card" names an H100 in the port and a
    TPU in the reference, so both MFUs are measured."""
    if kinds == "card":
        monkeypatch.setattr(compute, "device_kind_of", lambda device: H100_SXM)
        monkeypatch.setattr(jcompute.ComputeProbe, "_device", staticmethod(lambda: _TPU()))
    kw = dict(key="run_round", signature=("defaults",), train_s=0.37, n_samples=96, n_epochs=2,
              steps=6)
    probe = compute.ComputeProbe("resnet18_cifar")
    ref = jcompute.ComputeProbe("resnet18_cifar")
    return probe, probe.record_round(**kw), ref.record_round(**kw), kw


def _divides_by_its_own_chips(mod, rec, kw):
    sps = kw["n_samples"] * kw["n_epochs"] / kw["train_s"]
    assert rec["samples_per_sec"] == round(sps, 3)
    assert rec["samples_per_sec_per_chip"] == round(sps / rec["n_chips"], 3)
    peak, _ = mod.peak_flops_for(rec["device_kind"])
    if peak is None:
        assert rec["mfu"] is None and rec["mfu_reason"]
    else:
        assert rec["mfu"] == round(sps / rec["n_chips"] * rec["flops_per_sample"] / peak, 6)


@pytest.mark.parametrize("kinds", ["cpu", "card"])
def test_record_round_defaults_follow_each_packages_rule(monkeypatch, kinds):
    """``record_round`` with neither ``device`` nor ``n_chips``: the port
    names this process's device and counts 1 chip without a process group;
    the reference counts ``jax.device_count()`` (8 forced CPU devices here).
    Every other field agrees, and each side's per-chip rate and MFU divide
    by the ``n_chips`` it reports."""
    import jax

    _, rec, want, kw = _default_records(monkeypatch, kinds)
    assert compute.validate_record(rec) == []
    assert rec["n_chips"] == 1
    assert want["n_chips"] == jax.device_count()
    assert rec["device_kind"] == (H100_SXM if kinds == "card" else "cpu")
    assert rec["peak_hbm_gb"] is None and "cpu" in rec["peak_hbm_gb_reason"]
    assert set(rec) - _OWN_RUN == set(want) - _OWN_RUN
    for key in set(rec) - _OWN_RUN:
        assert rec[key] == want[key], key
    _divides_by_its_own_chips(compute, rec, kw)
    _divides_by_its_own_chips(jcompute, want, kw)
    if kinds == "card":
        assert rec["mfu"] is not None and want["mfu"] is not None


def test_record_round_counts_the_process_groups_world_size(monkeypatch):
    """In a process group the default ``n_chips`` is its world size, read
    once a probe as the reference caches ``jax.device_count()``."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    probe, rec, want, kw = _default_records(monkeypatch, "cpu")
    assert compute.validate_record(rec) == []
    assert rec["n_chips"] == 2 and rec["device_kind"] == "cpu"
    for key in set(rec) - _OWN_RUN:
        assert rec[key] == want[key], key
    _divides_by_its_own_chips(compute, rec, kw)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    kw["signature"] = ("again",)
    assert probe.record_round(**kw)["n_chips"] == 2
    assert compute.ComputeProbe().record_round(**kw)["n_chips"] == 4


def test_explicit_device_and_chips_win_over_the_defaults(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    probe = compute.ComputeProbe("resnet18_cifar")
    rec = probe.record_round(key="k", signature=1, train_s=0.5, n_samples=9,
                             device=torch.device("cpu"), n_chips=3)
    assert compute.validate_record(rec) == []
    assert rec["n_chips"] == 3 and rec["device_kind"] == "cpu"
    assert rec["samples_per_sec_per_chip"] == round(9 / 0.5 / 3, 3)
    assert probe.record_round(key="k", signature=1, train_s=0.5, n_samples=9)["n_chips"] == 2
