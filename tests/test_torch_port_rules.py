"""Rules of the port: it imports neither JAX nor the JAX package, its entry
points (``FedSim``, the HTTP ``Manager`` and ``ExperimentWorker``, the
demo, the examples, FedSim over each model of the zoo, and the loadgen's
``run_scenario`` and CLI) refuse to run
without a GPU unless asked for the CPU, every option builds (a clients
mesh and a hybrid clients x model mesh among them), no
``NotImplementedError`` in the port's source names a next slice or an
option as not ported (what is left of them are JAX's own refusals, such
as a robust aggregator on a hybrid mesh), the federation variants refuse
the reference's incompatible sims with its ``ValueError``s, and the chip
smoke test has no CPU fallback. And the port is complete name by name:
every public name of every module of the JAX package, each public method
of its public classes and each parameter of those functions has its
counterpart in the same module of the port, or stands in ``EXEMPT`` with
its reason, and each parameter both have takes the same default, or
stands in ``DEFAULTS_DIFFER`` with its reason (both packages read with
``ast``, neither imported)."""

import ast
import asyncio
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
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
from baton_tpu_torch.parallel.mesh import Mesh
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
    # the operations planes: the edge tier, the ops console and the loadgen
    assert {"baton_tpu_torch/server/edge.py", "baton_tpu_torch/ops/console.py",
            "baton_tpu_torch/ops/__main__.py"} <= names
    assert {f"baton_tpu_torch/loadgen/{m}.py" for m in
            ("__init__", "__main__", "engine", "scenario", "slo")} <= names
    # batonlint's carried copy
    assert {f"baton_tpu_torch/analysis/{m}.py" for m in
            ("__init__", "__main__", "engine", "summaries", "checkers/tracer")} <= names


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


def test_loadgen_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """``run_scenario``/``ScenarioRunner`` and ``python -m
    baton_tpu_torch.loadgen`` hold their managers' and workers' params on
    the card unless given ``device="cpu"`` / ``--device cpu``; without a GPU
    they raise before they start a server, and never fall back."""
    from baton_tpu_torch.loadgen.engine import ScenarioRunner, run_scenario
    from baton_tpu_torch.loadgen.scenario import parse_scenario

    scn = parse_scenario({"name": "t", "phases": [{"duration_s": 1.0}]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenarioRunner(scn, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(run_scenario(scn, str(tmp_path)))
    assert ScenarioRunner(scn, str(tmp_path), device="cpu").device.type == "cpu"
    path = tmp_path / "t.json"
    path.write_text('{"name": "t", "phases": [{"duration_s": 1.0}]}')
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "baton_tpu_torch.loadgen", str(path),
                          "--artifacts", str(tmp_path / "a")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    assert not (tmp_path / "a" / "rounds.jsonl").exists()


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
def test_manager_options_build_an_experiment_on_the_cpu(kw, tmp_path):
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


def test_worker_compress_option_builds_its_compressor():
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


def test_every_fedsim_option_runs_on_the_cpu():
    """No option is refused now: a hybrid clients x model mesh, a clients
    mesh, ``dp=``, ``auto_wave_size``, ``wave_size="auto"`` and
    ``run_rounds_fused`` run on the CPU."""
    model = bert_classifier_model(BertConfig.tiny())
    hybrid = FedSim(model, mesh=make_mesh(8, ("clients", "model"), devices=["cpu"] * 8))
    assert hybrid.is_hybrid and hybrid.device.type == "cpu"
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


def test_no_refusal_names_a_slice_or_an_unported_option():
    """No ``NotImplementedError`` in the port names a next slice, ROADMAP or
    an option as not ported; the refusals left are JAX's own (the robust
    aggregators on a hybrid mesh among them)."""
    messages = [m for path in PORT_FILES for m in _not_implemented_messages(path)]
    assert any("hybrid clients x model mesh" in m and "pure clients mesh" in m
               for m in messages)
    for m in messages:
        assert "ROADMAP" not in m and "not ported" not in m, m
        assert "next slice" not in m, m
        for name in ("DP-SGD", "dp=", "auto_wave_size"):
            assert name not in m, m


def test_both_meshes_run_a_round_and_a_hybrid_one_refuses_a_robust_aggregator():
    """A clients mesh and a hybrid clients x model mesh both run a round;
    on the hybrid mesh a robust aggregator is refused with JAX's reason."""
    data = {"x": torch.ones(4, 2, 10), "y": torch.zeros(4, 2)}
    n = torch.tensor([2, 1, 2, 2])
    for shape in ((4, 1), (2, 2)):
        mesh = Mesh(np.array([[torch.device("cpu")] * shape[1]] * shape[0], dtype=object),
                    ("clients", "model"))
        sim = FedSim(linear_regression_model(), batch_size=2, mesh=mesh)
        params = sim.init(torch.Generator().manual_seed(0))
        assert torch.isfinite(sim.run_round(params, data, n, torch.Generator()).loss_history).all()
        with pytest.raises(NotImplementedError, match="pure clients mesh"):
            FedSim(linear_regression_model(), batch_size=2, mesh=mesh,
                   aggregator="median").run_round(params, data, n, torch.Generator())
    assert FedSim(linear_regression_model(), mesh=make_mesh(4, devices=["cpu"] * 4)).mesh


def test_fused_rounds_refuse_only_a_process_whose_shards_lie_on_several_cards(monkeypatch):
    """``run_rounds_fused`` captures CUDA graphs on one card: a mesh whose
    shards lie on two cards of this process is refused on a CUDA device
    (CUDA stubbed, the refusal comes before any tensor reaches a card) with
    its reason, while a CPU mesh across two processes runs its fused rounds
    (the all-reduce stubbed as the other process's same sums)."""
    from baton_tpu_torch.ops import aggregation as agg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    data = {"x": torch.ones(4, 2, 2), "y": torch.zeros(4, 2)}
    n = torch.tensor([2, 1, 2, 2])
    params = {"w": torch.zeros(2), "b": torch.zeros(())}
    two_cards = make_mesh(2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    sim = FedSim(linear_regression_model(2), batch_size=2, mesh=two_cards)
    with pytest.raises(NotImplementedError, match="one CUDA graph belongs to one card") as exc:
        sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1), n_rounds=2)
    assert "cuda:1" in str(exc.value) and "initialize_multihost" in str(exc.value)
    across = Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("clients",),
                  process_ids=[0, 0, 1, 1], process_index=0)
    assert across.spans_processes
    monkeypatch.setattr(agg, "_all_reduce", lambda flat, group: flat.mul_(2))
    sim = FedSim(linear_regression_model(2), batch_size=2, mesh=across)
    _, history = sim.run_rounds_fused(params, data, n, torch.Generator().manual_seed(1),
                                      n_rounds=2)
    assert len(history) == 2 and all(np.isfinite(history))
    assert sim.last_fused == {"graph": False, "rounds": 2}


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout



# -- the name-by-name parity guard ------------------------------------------

REF_PACKAGE = ROOT / "baton_tpu"
PORT_PACKAGE = ROOT / "baton_tpu_torch"
FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)

KEY = "a JAX PRNG key: the port draws from an explicit torch.Generator, or takes none"
PALLAS_TILES = "Pallas tile sizes: each CUDA kernel design fixes its own tiles"
PALLAS_INTERPRET = "Pallas interpret mode: on the CPU the port's wrapper runs the plain version"
XLA_PLAN = ("XLA's compile-time memory plan: the port measures the allocator instead "
            "(utils/profiling.fedsim_wave_footprint_gb, obs/compute.peak_memory_gb)")
TPU_BUDGET = "TPU memory budgets: the port's budget is the card's own memory (device_budget_gb)"
TPU_BUDGET_TIER = ("picks a tier of the TPU's plan budget (hbm_budget_gb): the card's budget is "
                   "its own memory and has one tier (device_budget_gb)")
RENAMED = "renamed to "  # a reason "renamed to <port's name>: <why>"

# (module of baton_tpu, name or None for the module, parameter or None) -> reason
EXEMPT = {
    ("parallel/compat.py", None, None): "a shard_map shim for JAX 0.4; torch has no shard_map",
    ("core/model.py", "FedModel.from_flax", None): "Flax is JAX",
    ("core/model.py", "PRNGKey", None): "JAX's key type: the port passes torch.Generators",
    ("core/model.py", "FedModel.masked_loss", "rng"): KEY,
    ("core/model.py", "FedModel.loss_and_count", "rng"): KEY,
    ("core/losses.py", "mse", "rng"): KEY,
    ("core/losses.py", "softmax_cross_entropy", "rng"): KEY,
    ("core/losses.py", "sigmoid_binary_cross_entropy", "rng"): KEY,
    ("core/partition.py", "path_str", None):
        "renders a JAX pytree key path: the port's params are flat dicts keyed by the path",
    ("core/partition.py", "ParamPartition.__init__", "treedef"):
        "a JAX pytree's treedef: the port's flat dicts need the paths alone",
    ("core/training.py", "LocalTrainer.train", "rng"): KEY,
    ("core/training.py", "LocalTrainer.train_with_opt_state", "rng"): KEY,
    ("models/moe.py", "moe_init", "key"): KEY,
    ("models/transformer.py", "normal_init", "key"): KEY,
    ("models/transformer.py", "dense_init", "key"): KEY,
    ("models/transformer.py", "mha_init", "key"): KEY,
    ("models/transformer.py", "gelu_mlp_init", "key"): KEY,
    ("models/transformer.py", "swiglu_init", "key"): KEY,
    ("models/transformer.py", "prenorm_block_init", "key"): KEY,
    ("obs/compute.py", "TPU_PEAK_FLOPS", None): "TPU peaks: the port's MFU divides by CUDA_PEAKS",
    ("ops/aggregation.py", "psum_weighted_mean", "axis_name"):
        "a shard_map axis name: the port's psum forms take the mesh",
    ("ops/aggregation.py", "psum_weighted_scalar_mean", "axis_name"):
        "a shard_map axis name: the port's psum forms take the mesh",
    ("ops/compression.py", "quantize_stochastic", "rng"): KEY,
    ("ops/flash_attention.py", "flash_attention", "block_q"): PALLAS_TILES,
    ("ops/flash_attention.py", "flash_attention", "block_k"): PALLAS_TILES,
    ("ops/flash_attention.py", "flash_attention", "interpret"): PALLAS_INTERPRET,
    ("ops/flash_attention.py", "flash_block_fwd", "block_q"): PALLAS_TILES,
    ("ops/flash_attention.py", "flash_block_fwd", "block_k"): PALLAS_TILES,
    ("ops/flash_attention.py", "flash_block_fwd", "interpret"): PALLAS_INTERPRET,
    ("ops/flash_attention.py", "flash_block_bwd", "block_q"): PALLAS_TILES,
    ("ops/flash_attention.py", "flash_block_bwd", "block_k"): PALLAS_TILES,
    ("ops/flash_attention.py", "flash_block_bwd", "interpret"): PALLAS_INTERPRET,
    ("ops/flash_attention.py", "make_flash_attention_fn", "block_q"): PALLAS_TILES,
    ("ops/flash_attention.py", "make_flash_attention_fn", "block_k"): PALLAS_TILES,
    ("ops/flash_attention.py", "make_flash_attention_fn", "interpret"): PALLAS_INTERPRET,
    ("ops/privacy.py", "per_example_clipped_grad_sum", "rng"): KEY,
    ("ops/privacy.py", "gaussian_noise_like", "rng"): KEY,
    ("ops/privacy.py", "dp_sgd_grads", "rng"): KEY,
    ("ops/privacy.py", "dp_fedavg", "rng"): KEY,
    ("ops/secure_agg.py", "Params", None): "a type alias: the port's is Tree",
    ("ops/secure_agg.py", "net_mask_of", "seed_key"):
        "a JAX key made from the pair's seed: the port takes the integer seed",
    ("ops/secure_agg.py", "mask_update", "seed_key"):
        "a JAX key made from the pair's seed: the port takes the integer seed",
    ("parallel/clustered.py", "ClusteredFedSim.init_clusters", "rng"): KEY,
    ("parallel/clustered.py", "ClusteredFedSim.run_round", "rng"): KEY,
    ("parallel/clustered.py", "ClusteredFedSim.evaluate", "rng"): KEY,
    ("parallel/engine.py", "client_eval_sums", "r"): KEY,
    ("parallel/engine.py", "FedSim.init", "rng"): KEY,
    ("parallel/engine.py", "FedSim.auto_wave_size", "key"): KEY,
    ("parallel/engine.py", "FedSim.run_round", "rng"): KEY,
    ("parallel/engine.py", "FedSim.evaluate_round", "rng"): KEY,
    ("parallel/engine.py", "FedSim.evaluate_clients", "rng"): KEY,
    ("parallel/engine.py", "FedSim.run_rounds", "rng"): KEY,
    ("parallel/engine.py", "FedSim.run_rounds_fused", "rng"): KEY,
    ("parallel/fedbuff.py", "FedBuff.run", "rng"): KEY,
    ("parallel/personalization.py", "FedPer.run_round", "rng"): KEY,
    ("parallel/personalization.py", "FedPer.evaluate", "rng"): KEY,
    ("parallel/stateful.py", "StatefulClients.run_round", "rng"): KEY,
    ("parallel/ring_attention.py", "flash_ring_attention", "block_q"): PALLAS_TILES,
    ("parallel/ring_attention.py", "flash_ring_attention", "block_k"): PALLAS_TILES,
    ("parallel/ring_attention.py", "flash_ring_attention", "interpret"): PALLAS_INTERPRET,
    ("parallel/ring_attention.py", "make_flash_ring_attention_fn", "block_q"): PALLAS_TILES,
    ("parallel/ring_attention.py", "make_flash_ring_attention_fn", "block_k"): PALLAS_TILES,
    ("parallel/ring_attention.py", "make_flash_ring_attention_fn", "interpret"):
        PALLAS_INTERPRET,
    ("utils/profiling.py", "plan_breakdown_gb", None): XLA_PLAN,
    ("utils/profiling.py", "peak_hbm_gb", None): XLA_PLAN,
    ("utils/profiling.py", "fedsim_wave_plan_gb", None): XLA_PLAN,
    ("utils/profiling.py", "fedsim_wave_hbm", None): XLA_PLAN,
    ("utils/profiling.py", "HBM_BUDGET_GB", None): TPU_BUDGET,
    ("utils/profiling.py", "DEFAULT_HBM_BUDGET_GB", None): TPU_BUDGET,
    ("utils/profiling.py", "ANCHORED_DIRECT_CONV_BUDGET_GB", None): TPU_BUDGET,
    ("utils/profiling.py", "hbm_budget_gb", None): TPU_BUDGET,
    ("utils/profiling.py", "configure_jax_for_bench", None):
        RENAMED + "configure_torch_for_bench: the port sets up torch and its kernels, not JAX",
    ("utils/profiling.py", "conv_kernel_class", None): TPU_BUDGET_TIER,
    ("utils/profiling.py", "ANCHORED_CONV_KERNEL", None): TPU_BUDGET_TIER,
    ("utils/profiling.py", "fedsim_fused_donation_plan", "key"): KEY,
}


def _params(fn) -> set:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return {n for n in names if n not in ("self", "cls")}


def _module_level(stmts):
    """A module's top-level statements, those under ``if`` and ``try`` too."""
    for node in stmts:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _module_level(node.body + node.orelse + getattr(node, "finalbody", [])
                                     + [s for h in getattr(node, "handlers", []) for s in h.body])
        else:
            yield node


def _defaults(fn) -> dict:
    """``{parameter: its default's source text, or None if required}``;
    ``jnp.`` reads as ``torch.``, so the dtypes of both packages compare."""
    a = fn.args
    positional = a.posonlyargs + a.args
    pairs = list(zip(positional, [None] * (len(positional) - len(a.defaults)) + a.defaults))
    pairs += list(zip(a.kwonlyargs, a.kw_defaults))
    return {x.arg: None if d is None else re.sub(r"\bjnp\.", "torch.", ast.unparse(d))
            for x, d in pairs if x.arg not in ("self", "cls")}


def module_surface(path, public_only: bool, of=_params) -> dict:
    """``{name: of(function) or set()}`` of a module: its functions,
    classes, each class's methods (``Class.method``) and annotated fields,
    its assigned names, and the names it imports (only an
    ``__init__.py``'s are public re-exports). ``of`` is what is kept of a
    function (its parameters by default); ``public_only`` keeps the names
    without a leading underscore, and ``__init__``."""
    def wanted(name):
        return not public_only or all(not part.startswith("_") or part == "__init__"
                                      for part in name.split("."))

    out = {}
    for node in _module_level(ast.parse(path.read_text(), filename=str(path)).body):
        if isinstance(node, FUNCTIONS):
            out[node.name] = of(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = set()
            for sub in node.body:
                if isinstance(sub, FUNCTIONS):
                    out[f"{node.name}.{sub.name}"] = of(sub)
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    out[f"{node.name}.{sub.target.id}"] = set()
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                out.update({n.id: set() for n in ast.walk(target) if isinstance(n, ast.Name)})
        elif (isinstance(node, (ast.Import, ast.ImportFrom))
              and (path.name == "__init__.py" or not public_only)):
            out.update({(a.asname or a.name).split(".")[0]: set() for a in node.names})
    return {k: v for k, v in out.items() if wanted(k)}


def parity_gaps(ref_package, port_package, module: str) -> set:
    """What the port's ``module`` lacks of the JAX package's: ``(module,
    None, None)`` for the whole module, ``(module, name, None)`` for a
    name, ``(module, name, parameter)`` for a parameter."""
    port = port_package / module
    if not port.exists():
        return {(module, None, None)}
    want = module_surface(ref_package / module, public_only=True)
    have = module_surface(port, public_only=False)
    gaps = set()
    for name, params in want.items():
        if name not in have:
            gaps.add((module, name, None))
        else:
            gaps |= {(module, name, p) for p in params - have[name]}
    return gaps


def default_gaps(ref_package, port_package, module: str) -> set:
    """``(module, name, parameter)`` for each parameter of a function or
    method that both packages' ``module`` have whose defaults differ: a
    default changed, dropped, or given by the port alone."""
    port = port_package / module
    if not port.exists():
        return set()
    want = module_surface(ref_package / module, public_only=True, of=_defaults)
    have = module_surface(port, public_only=False, of=_defaults)
    gaps = set()
    for name, defaults in want.items():
        theirs = have.get(name) or {}
        gaps |= {(module, name, p) for p in set(defaults or {}) & set(theirs)
                 if defaults[p] != theirs[p]}
    return gaps


GENERATOR_FIRST = ("required in the JAX package; the port's generator stands before it, so the "
                   "count takes a default: every call the reference accepts runs")

# (module of baton_tpu, name, parameter) -> why the port's default differs
DEFAULTS_DIFFER = {
    ("core/partition.py", "ParamPartition.__init__", "paths"):
        "the reference defaults it to (); the port has no treedef (EXEMPT), so the paths are "
        "its only key and required",
    ("core/training.py", "LocalTrainer.train", "n_epochs"): GENERATOR_FIRST,
    ("core/training.py", "LocalTrainer.train_with_opt_state", "n_epochs"): GENERATOR_FIRST,
    ("parallel/engine.py", "FedSim.run_rounds", "n_rounds"): GENERATOR_FIRST,
    ("parallel/fedbuff.py", "FedBuff.run", "n_steps"): GENERATOR_FIRST,
}


REF_MODULES = sorted(p.relative_to(REF_PACKAGE).as_posix() for p in REF_PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_of_the_jax_package_is_in_the_port(module):
    """Each public name, method and parameter of ``baton_tpu/<module>`` is in
    ``baton_tpu_torch/<module>``, or exempt with its reason."""
    missing = parity_gaps(REF_PACKAGE, PORT_PACKAGE, module) - set(EXEMPT)
    assert not missing, f"not in the port and not exempt: {sorted(missing, key=str)}"


def test_every_exemption_has_a_reason_and_is_still_missing():
    """No stale entry: each exempt name is in the JAX package and still
    missing from the port, and its reason is one line."""
    gaps = set().union(*(parity_gaps(REF_PACKAGE, PORT_PACKAGE, m) for m in REF_MODULES))
    for entry, reason in EXEMPT.items():
        assert entry[0] in REF_MODULES, entry
        assert entry in gaps, (f"{entry} is not a gap of the port: ported (take it out of "
                               "EXEMPT), or its whole name is missing")
        assert isinstance(reason, str) and reason.strip() and "\n" not in reason, entry


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_default_of_the_jax_package_is_the_ports(module):
    """Each parameter that a function or method of ``baton_tpu/<module>``
    and its port both have takes the same default on both sides (the
    dtype's module mapped), or stands in ``DEFAULTS_DIFFER`` with its
    reason: a default the reference gives is never dropped or changed
    silently, and the port gives a default the reference lacks only where
    the table says why."""
    differ = default_gaps(REF_PACKAGE, PORT_PACKAGE, module) - set(DEFAULTS_DIFFER)
    assert not differ, f"defaults differ and not in DEFAULTS_DIFFER: {sorted(differ, key=str)}"


def test_every_defaults_difference_has_a_reason_and_still_stands():
    """No stale entry: each entry's defaults still differ (so its name and
    parameter are on both sides), and its reason is one line."""
    gaps = set().union(*(default_gaps(REF_PACKAGE, PORT_PACKAGE, m) for m in REF_MODULES))
    for entry, reason in DEFAULTS_DIFFER.items():
        assert entry[0] in REF_MODULES, entry
        assert entry in gaps, (f"{entry}: the defaults agree now, or the name is gone: take "
                               "it out of DEFAULTS_DIFFER")
        assert isinstance(reason, str) and reason.strip() and "\n" not in reason, entry


def test_no_exemption_is_owed():
    """Every name of the JAX package is ported or exempt for good: no
    entry waits for a later port."""
    assert not [entry for entry, reason in EXEMPT.items() if re.search(r"\bowed\b", reason)]


def test_a_renamed_name_has_its_counterpart_in_the_port():
    """An entry that says the port renamed a name names a counterpart that
    the port's module has, and the JAX package's module does not."""
    renamed = {entry: reason[len(RENAMED):].split(":")[0].strip()
               for entry, reason in EXEMPT.items() if reason.startswith(RENAMED)}
    assert renamed
    for (module, name, parameter), counterpart in renamed.items():
        have = module_surface(PORT_PACKAGE / module, public_only=False)
        if parameter is None:
            assert counterpart in have, (module, name, counterpart)
        else:
            assert counterpart in have[name], (module, name, parameter, counterpart)
        assert counterpart not in module_surface(REF_PACKAGE / module, public_only=True)


def test_the_parity_guard_catches_a_missing_module_name_method_and_parameter(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    for root in (ref, port):
        (root / "sub").mkdir(parents=True)
    (ref / "__init__.py").write_text("from .sub.a import f, C\n")
    (port / "__init__.py").write_text("from .sub.a import f\n")
    (ref / "sub" / "a.py").write_text(
        "import math\nLIMIT = 3\n\ndef f(x, rng, *, scale=1.0):\n    pass\n\n"
        "def _private(y):\n    pass\n\nclass C:\n    n: int = 0\n\n"
        "    def __init__(self, model=None, family=None):\n        pass\n\n"
        "    def run(self, a):\n        pass\n\n    def _helper(self):\n        pass\n")
    (port / "sub" / "a.py").write_text(
        "try:\n    LIMIT = 3\nexcept ImportError:\n    pass\n\n"
        "def f(x, scale=1.0):\n    pass\n\nclass C:\n    def __init__(self, model=None):\n"
        "        pass\n")
    (ref / "sub" / "b.py").write_text("def g():\n    pass\n")
    gaps = set().union(*(parity_gaps(ref, port, m) for m in ("__init__.py", "sub/a.py",
                                                              "sub/b.py")))
    assert gaps == {("__init__.py", "C", None), ("sub/a.py", "f", "rng"),
                    ("sub/a.py", "C.n", None), ("sub/a.py", "C.__init__", "family"),
                    ("sub/a.py", "C.run", None), ("sub/b.py", None, None)}
    assert not set().union(*(default_gaps(ref, port, m) for m in ("sub/a.py", "sub/b.py")))
    # the defaults guard: a changed default, a dropped one, one the port
    # alone gives; a dtype's module and a default under an ``if`` compare
    (ref / "sub" / "a.py").write_text(
        "import jax.numpy as jnp\n\ndef f(x, rng, *, scale=1.0, dtype=jnp.float32):\n"
        "    pass\n\nclass C:\n    def __init__(self, model=None, family=None):\n"
        "        pass\n\n    def run(self, a, n):\n        pass\n")
    (port / "sub" / "a.py").write_text(
        "import torch\n\nif True:\n    def f(x, *, scale=2.0, dtype=torch.float32):\n"
        "        pass\n\nclass C:\n    def __init__(self, model, family=None):\n"
        "        pass\n\n    def run(self, a, n=1):\n        pass\n")
    assert default_gaps(ref, port, "sub/a.py") == {
        ("sub/a.py", "f", "scale"), ("sub/a.py", "C.__init__", "model"),
        ("sub/a.py", "C.run", "n")}
