"""Rules of the port: it imports neither JAX nor the JAX package, its entry
points refuse to run without a GPU unless asked for the CPU, and the chip
smoke test has no CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import baton_tpu_torch
from baton_tpu_torch import FedSim
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model

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


def test_unported_options_are_refused():
    model = bert_classifier_model(BertConfig.tiny())
    for kw in ({"mesh": object()}, {"dp": object()}, {"regularizer": object()},
               {"trainable": object()}, {"server_optimizer": object()},
               {"optimizer": object()}):
        with pytest.raises(NotImplementedError):
            FedSim(model, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown aggregator"):
        FedSim(model, device="cpu", aggregator="krum")
    with pytest.raises(NotImplementedError):
        FedSim(model, device="cpu").run_rounds_fused()


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
