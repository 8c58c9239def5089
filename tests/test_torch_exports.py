"""What the port's packages export against the JAX package's: the
top-level names of ``baton_tpu``, the checkpointer in ``utils`` and
example 02's ``make_data`` signature (each once a fault of the port);
``parallel``'s names, all of the reference's but the three
tensor-parallel helpers of the next slice; and the signatures of the
clients-mesh functions, whose only differences are listed here."""

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


def test_core_exports_the_references_names():
    """``baton_tpu_torch.core`` re-exports what ``baton_tpu.core`` does
    (it once exported nothing)."""
    import baton_tpu.core
    import baton_tpu_torch.core
    from baton_tpu_torch.core import (  # noqa: F401
        FedModel,
        LocalTrainer,
        ParamPartition,
        fedprox,
        make_local_trainer,
        make_partition,
    )

    want = set(baton_tpu.core.__all__)
    assert want == {"FedModel", "LocalTrainer", "make_local_trainer", "ParamPartition",
                    "make_partition", "fedprox"}
    assert set(baton_tpu_torch.core.__all__) == want
    for name in want:
        assert getattr(baton_tpu_torch.core, name).__name__ == name


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


# tensor parallelism over the hybrid mesh's model axis (exported since the
# model axis was ported)
TENSOR_PARALLEL = {"shard_params_tp", "tp_sharding_tree", "transformer_tp_spec"}


def test_parallel_exports_the_references_names_but_tensor_parallelism():
    """The port's ``parallel`` exports exactly JAX's names, tensor
    parallelism's included."""
    import baton_tpu.parallel
    import baton_tpu_torch.parallel

    want = set(baton_tpu.parallel.__all__)
    assert TENSOR_PARALLEL <= want
    assert set(baton_tpu_torch.parallel.__all__) == want
    for name in want:
        assert getattr(baton_tpu_torch.parallel, name).__name__ == name


# the port's deliberate signature differences: (module, function) ->
# parameters the port adds; every other parameter is the reference's, in
# its order and with its default
SIGNATURE_DIFFERENCES = {
    ("multihost", "initialize_multihost"): ["backend", "devices", "timeout_s"],
    ("multihost", "make_hybrid_mesh"): ["devices"],
    ("mesh", "make_mesh"): [],
    ("mesh", "client_sharding"): [],
    ("mesh", "replicated_sharding"): [],
    ("mesh", "shard_client_arrays"): [],
    ("mesh", "require_clients_mesh"): [],
    ("partition", "match_partition_rules"): [],
    ("partition", "kernel_specs"): [],
    ("partition", "dim_spec"): [],
    ("partition", "transformer_rules"): [],
    ("tensor_parallel", "transformer_tp_spec"): [],
    ("tensor_parallel", "leaf_tp_sharding"): [],
    ("tensor_parallel", "shard_params_tp"): [],
    ("tensor_parallel", "tp_sharding_tree"): [],
    ("tensor_parallel", "describe_tp_sharding"): [],
}


def test_mesh_signatures_are_the_references_plus_the_listed_differences():
    import importlib

    for (module, name), added in SIGNATURE_DIFFERENCES.items():
        ref = inspect.signature(getattr(importlib.import_module(f"baton_tpu.parallel.{module}"),
                                        name)).parameters
        port = inspect.signature(getattr(importlib.import_module(
            f"baton_tpu_torch.parallel.{module}"), name)).parameters
        assert [p for p in port if p not in added] == list(ref), name
        # a default that is a function (tensor_parallel's spec_fn) is the
        # port's function of the same name
        assert all(port[p].default.__name__ == ref[p].default.__name__
                   if callable(ref[p].default) else port[p].default == ref[p].default
                   for p in ref), name
