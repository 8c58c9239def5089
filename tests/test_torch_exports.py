"""What the port's packages export against the JAX package's: the
top-level names of ``baton_tpu``, the checkpointer in ``utils`` and
example 02's ``make_data`` signature (each once a fault of the port)."""

import importlib.util
import inspect
from pathlib import Path

import baton_tpu
import baton_tpu.utils
import baton_tpu_torch
import baton_tpu_torch.utils
from baton_tpu_torch.examples import resnet_cifar_dirichlet

ROOT = Path(__file__).resolve().parents[1]


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


def test_top_level_names_are_the_references():
    want = _public(baton_tpu)
    assert want == {"FedModel", "FedSim", "LocalTrainer", "RoundResult", "make_local_trainer",
                    "weighted_tree_mean"}
    assert want <= set(baton_tpu_torch.__all__)
    for name in want:
        assert getattr(baton_tpu_torch, name).__name__ == name


def test_utils_exports_the_checkpointer():
    assert set(baton_tpu.utils.__all__) <= set(baton_tpu_torch.utils.__all__)
    from baton_tpu_torch.utils.checkpoint import Checkpointer, RestoredState

    assert baton_tpu_torch.utils.Checkpointer is Checkpointer
    assert baton_tpu_torch.utils.RestoredState is RestoredState
    assert "not ported" not in baton_tpu_torch.utils.__doc__


def test_example02_make_data_keeps_the_references_parameters():
    spec = importlib.util.spec_from_file_location(
        "resnet_cifar_example", ROOT / "examples" / "02_resnet_cifar_dirichlet.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    want = inspect.signature(example.make_data).parameters
    got = inspect.signature(resnet_cifar_dirichlet.make_data).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default for p in want.values()]
    assert list(got)[5] == "n_classes" and got["n_classes"].default == 10
