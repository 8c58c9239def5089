"""Rules of the port: it imports neither JAX nor the JAX package, its entry
points (``FedSim``, the HTTP ``Manager`` and ``ExperimentWorker``, the
demo, the examples, and FedSim over each model of the zoo) refuse to run
without a GPU unless asked for the CPU, every option not ported yet
raises ``NotImplementedError`` while the ported ones build, the only
such refusal left is a mesh with a ``model`` axis, the next slice (no
``NotImplementedError`` in the port's source names DP-SGD, the wave
sizer, the fused rounds or a clients mesh as not ported), the
federation variants refuse the reference's incompatible sims with its
``ValueError``s, and the chip smoke test has no CPU fallback."""

import ast
import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from aiohttp import web

import baton_tpu_torch
from baton_tpu_torch import FedSim, demo
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.core import optim
from baton_tpu_torch.examples import (
    advanced_aggregation,
    bert_fedprox,
    llama_lora,
    long_context_ring,
    lstm_shakespeare,
    vit_dp_secure,
)
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.ops.privacy import DPConfig
from baton_tpu_torch.parallel import ClusteredFedSim, FedBuff, FedPer, StatefulClients, make_mesh
from baton_tpu_torch.server import http_worker
from baton_tpu_torch.server.http_manager import Manager
from baton_tpu_torch.server.http_worker import ExperimentWorker
from baton_tpu_torch.utils.checkpoint import RestoredState

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p for p in (ROOT / "baton_tpu_torch").rglob("*.py")
                    if "_build" not in p.parts) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "baton_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_the_import_scan_covers_the_federation_variants():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"baton_tpu_torch/parallel/{m}.py" for m in
            ("stateful", "fedbuff", "personalization", "clustered")} <= names
    assert "baton_tpu_torch/examples/advanced_aggregation.py" in names
    # the model zoo and its examples
    assert {f"baton_tpu_torch/models/{m}.py" for m in
            ("transformer", "llama", "lora", "moe", "vit", "lstm")} <= names
    assert {f"baton_tpu_torch/examples/{m}.py" for m in
            ("llama_lora", "lstm_shakespeare")} <= names
    # DP-SGD, config 5 and the single-device examples of the last slice
    assert "baton_tpu_torch/ops/privacy.py" in names
    assert {f"baton_tpu_torch/examples/{m}.py" for m in
            ("vit_dp_secure", "resnet_cifar_dirichlet", "real_digits",
             "bandwidth_efficient_http")} <= names
    # sequence parallelism, examples 03 and 06
    assert {f"baton_tpu_torch/parallel/{m}.py" for m in ("mesh", "ring_attention")} <= names
    # the clients mesh: the partition tables, placement and the processes
    assert {f"baton_tpu_torch/parallel/{m}.py" for m in
            ("partition", "mesh", "multihost")} <= names
    assert {f"baton_tpu_torch/examples/{m}.py" for m in
            ("bert_fedprox", "long_context_ring")} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = bert_classifier_model(BertConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedSim(model)
    with pytest.raises(RuntimeError):
        baton_tpu_torch.resolve_device()
    assert FedSim(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        advanced_aggregation.run()
    for example in (llama_lora, lstm_shakespeare, vit_dp_secure, bert_fedprox,
                    long_context_ring):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.run()
    # a mesh is every CUDA device unless given its devices
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(8, ("seq",), devices=["cpu"] * 8).shape == {"seq": 8}


def _zoo():
    from baton_tpu_torch.models import (
        LlamaConfig,
        LSTMConfig,
        MoEConfig,
        ViTConfig,
        llama_lm_model,
        llama_lora_target,
        lora_trainable,
        lora_wrap,
        lstm_lm_model,
        vit_model,
    )

    return {
        "llama": (llama_lm_model(LlamaConfig.tiny(), remat=True), {}),
        "llama_moe": (llama_lm_model(LlamaConfig.tiny(moe=MoEConfig(4, 2))), {}),
        "llama_lora": (lora_wrap(llama_lm_model(LlamaConfig.tiny()), rank=2,
                                 target=llama_lora_target), {"trainable": lora_trainable}),
        "vit": (vit_model(ViTConfig.tiny(), remat=True), {}),
        "lstm": (lstm_lm_model(LSTMConfig.tiny()), {}),
    }


@pytest.mark.parametrize("name", ["llama", "llama_moe", "llama_lora", "vit", "lstm"])
def test_zoo_models_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, name):
    """FedSim over each model of the zoo (and ``lora_wrap``) refuses the
    default device without a GPU and builds its params on the CPU when
    asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, kw = _zoo()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedSim(model, **kw)
    sim = FedSim(model, device="cpu", **kw)
    params = sim.init(torch.Generator().manual_seed(0))
    assert {t.device.type for t in params.values()} == {"cpu"}


def _in_loop(fn):
    """Run ``fn`` inside an event loop (aiohttp apps and the worker's locks
    are built in one)."""
    async def main():
        return fn()
    return asyncio.run(main())


def _worker(**kw):
    return ExperimentWorker(web.Application(), linear_regression_model(), "127.0.0.1:1",
                            auto_register=False, **kw)


def _experiment(**kw):
    return Manager(web.Application()).register_experiment(
        linear_regression_model(), start_background_tasks=False, **kw)


def test_http_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (_worker, _experiment):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _in_loop(build)
    assert _in_loop(lambda: _worker(device="cpu")).params["w"].device.type == "cpu"
    assert _in_loop(lambda: _experiment(device="cpu")).params["w"].device.type == "cpu"
    for role, addr in (("manager", "127.0.0.1"), ("worker", "127.0.0.1:1")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _in_loop(lambda: demo.build_app([role, addr, "0"]))
        app, port = _in_loop(lambda: demo.build_app([role, addr, "0", "--cpu"]))
        assert isinstance(app, web.Application) and port == 0


@pytest.mark.parametrize("kw", [{"secure_agg": True}, {"broadcast_quantize_bits": 8},
                                {"broadcast_delta": "q8"}, {"checkpoint_dir": "ckpt"}],
                         ids=lambda kw: next(iter(kw)))
def test_unported_manager_options_are_refused(kw, tmp_path):
    """Refused until the second ring was ported; each option now builds an
    experiment on the CPU."""
    if "checkpoint_dir" in kw:
        kw = {"checkpoint_dir": str(tmp_path / kw["checkpoint_dir"])}
    exp = _in_loop(lambda: _experiment(device="cpu", **kw))
    assert exp.params["w"].device.type == "cpu"
    if "secure_agg" in kw:
        assert exp.secure_agg
    if "broadcast_quantize_bits" in kw:
        assert exp.broadcast_quantize_bits == 8
    if "broadcast_delta" in kw:
        assert exp._delta_spec == {"frac": None, "bits": 8}
    if "checkpoint_dir" in kw:
        assert exp.checkpointer.directory == kw["checkpoint_dir"]


@pytest.mark.parametrize("kw", [{"secure_agg": True, "allow_pickle": True},
                                {"broadcast_delta": "q8", "broadcast_quantize_bits": 8}],
                         ids=["secure_agg+allow_pickle", "broadcast_delta+quantize_bits"])
def test_incompatible_manager_options_raise_value_errors(kw):
    """The reference's incompatible pairs stay ValueErrors."""
    with pytest.raises(ValueError):
        _in_loop(lambda: _experiment(device="cpu", **kw))


def test_unported_worker_options_are_refused():
    """Refused until the second ring was ported; ``compress=`` now builds
    a worker with its error-feedback compressor."""
    worker = _in_loop(lambda: _worker(device="cpu", compress="topk:0.05"))
    assert (worker.compressor.frac, worker.compressor.bits) == (0.05, None)
    compressor = http_worker._parse_compress("topk:0.05:q8")
    assert (compressor.frac, compressor.bits) == (0.05, 8)


@pytest.mark.parametrize("flags", [["manager", "h", "1", "--secure"],
                                   ["manager", "h", "1", "--quantize-broadcast", "8"],
                                   ["worker", "h:1", "1", "--compress", "topk:0.1"]],
                         ids=lambda f: f[3])
def test_unported_demo_flags_are_refused_with_the_usage(flags, capsys):
    """Refused until the second ring was ported; each flag now parses and
    builds its role's app, and a flag given to the wrong role still exits
    with the usage."""
    app, port = _in_loop(lambda: demo.build_app(flags + ["--cpu"]))
    assert isinstance(app, web.Application) and port == 1
    other = ["worker", "h:1"] if flags[0] == "manager" else ["manager", "h"]
    with pytest.raises(SystemExit) as exc:
        demo.build_app(other + flags[2:] + ["--cpu"])
    assert exc.value.code == 2
    assert "python -m baton_tpu_torch.demo" in capsys.readouterr().err


def test_unported_options_are_refused():
    """Only a mesh with a ``model`` axis is refused now; a clients mesh,
    ``dp=``, ``auto_wave_size``, ``wave_size="auto"`` and
    ``run_rounds_fused`` run on the CPU."""
    model = bert_classifier_model(BertConfig.tiny())
    with pytest.raises(NotImplementedError):
        FedSim(model, mesh=make_mesh(8, ("clients", "model"), devices=["cpu"] * 8))
    assert FedSim(model, mesh=make_mesh(8, devices=["cpu"] * 8)).device.type == "cpu"
    dp = DPConfig(clip_norm=1.0, noise_multiplier=0.5)
    assert FedSim(model, device="cpu", dp=dp).trainer.dp == dp
    with pytest.raises(ValueError, match="unknown aggregator"):
        FedSim(model, device="cpu", aggregator="krum")
    sim = FedSim(linear_regression_model(2), batch_size=2, device="cpu")
    params = sim.init(torch.Generator().manual_seed(0))
    data = {"x": torch.ones(3, 2, 2), "y": torch.zeros(3, 2)}
    n = torch.tensor([2, 1, 2])
    assert sim.auto_wave_size(params, data, n) is None
    res = sim.run_round(params, data, n, torch.Generator().manual_seed(1), wave_size="auto")
    assert torch.isfinite(res.loss_history).all()
    _, history = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                      n_rounds=2)
    assert len(history) == 2
    # run_rounds(checkpointer=) is ported: a run restored at its last
    # round trains no further and hands back what was restored
    restored = {"w": torch.ones(2)}

    class Done:
        def restore(self, params, server_opt_template=None):
            return RestoredState(step=3, params=restored, server_opt_state=None,
                                 meta={"loss_history": [0.5, 0.25, 0.125]})

    params, history = sim.run_rounds({}, {}, torch.zeros(0), torch.Generator(), n_rounds=3,
                                     checkpointer=Done())
    assert params is restored and history == [0.5, 0.25, 0.125]


def _head(name, leaf):
    return name.startswith("1/")


def _linear_sim(**kw):
    return FedSim(linear_regression_model(), device="cpu", **kw)


# each variant on a sim it cannot honour: the reference's ValueError,
# matched by a phrase of its message
REFUSED = [
    ("stateful+trainable", lambda: StatefulClients(_linear_sim(trainable=_head)),
     "full-param optimizer state"),
    ("fedbuff buffer>concurrency", lambda: FedBuff(_linear_sim(), buffer_size=4, concurrency=2),
     "concurrency >= buffer_size"),
    ("fedbuff buffer 0", lambda: FedBuff(_linear_sim(), buffer_size=0, concurrency=2),
     "concurrency >= buffer_size"),
    ("fedbuff+median", lambda: FedBuff(_linear_sim(aggregator="median")),
     "staleness-weighted mean"),
    ("fedbuff+server optimizer",
     lambda: FedBuff(_linear_sim(server_optimizer=optim.adam(1e-2))), "silently ignored"),
    ("fedper+trainable", lambda: FedPer(_linear_sim(trainable=_head), personal=_head),
     "re-plumb"),
    ("fedper+server optimizer",
     lambda: FedPer(_linear_sim(server_optimizer=optim.adam(1e-2)), personal=_head),
     "silently ignored"),
    ("clustered k=1", lambda: ClusteredFedSim(_linear_sim(), n_clusters=1), "n_clusters >= 2"),
    ("clustered+trainable", lambda: ClusteredFedSim(_linear_sim(trainable=_head), 2),
     "partitioned"),
    ("clustered+median", lambda: ClusteredFedSim(_linear_sim(aggregator="median"), 2),
     "sample-weighted mean"),
    ("clustered+server optimizer",
     lambda: ClusteredFedSim(_linear_sim(server_optimizer=optim.adam(1e-2)), 2),
     "FedOpt server state"),
]


@pytest.mark.parametrize("build,match", [r[1:] for r in REFUSED], ids=[r[0] for r in REFUSED])
def test_federation_variants_refuse_incompatible_sims(build, match):
    with pytest.raises(ValueError, match=match):
        build()


def _not_implemented_messages(path):
    """The literal text of every ``raise NotImplementedError(...)`` in a file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                and getattr(node.exc.func, "id", None) == "NotImplementedError"):
            yield " ".join(c.value for c in ast.walk(node.exc)
                           if isinstance(c, ast.Constant) and isinstance(c.value, str))


def test_the_only_refusal_left_is_a_mesh_with_a_model_axis():
    messages = [m for path in PORT_FILES for m in _not_implemented_messages(path)]
    assert any("'model' axis" in m and "next slice" in m for m in messages)
    for m in messages:
        assert "ROADMAP item 11" not in m and "not ported" not in m, m
        assert "next slice" not in m or "model" in m, m
        for name in ("DP-SGD", "dp=", "auto_wave_size"):
            assert name not in m, m


def test_a_mesh_is_refused_naming_its_roadmap_item():
    """A clients mesh runs; the hybrid mesh's ``model`` axis is refused,
    naming the next slice and ROADMAP's queue."""
    queue = "next slice of the port \\(ROADMAP Queue 1\\)"
    with pytest.raises(NotImplementedError, match=queue):
        FedSim(linear_regression_model(),
               mesh=make_mesh(4, ("clients", "model"), devices=["cpu"] * 4))
    assert FedSim(linear_regression_model(), mesh=make_mesh(4, devices=["cpu"] * 4)).mesh


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
