"""The port's LoRA (``baton_tpu_torch/models/lora.py``) against the JAX
package: the adapters' names, ``merge_lora`` on the same weights (1e-6),
and a LoRA FedSim round of the tiny Llama on the same weights, data and
JAX's shuffles (1e-4) that leaves every base tensor bit-equal. Then the
reference's own cases (``tests/test_lora_fedprox.py:25-66``): the
partition's split and merge, an empty selection refused, LoRA's step 0
equal to the base model, and federated rounds that train the adapters
only."""

import jax
import numpy as np
import pytest
import torch

from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu.models.llama import llama_lora_target as jax_target
from baton_tpu.models.lora import lora_trainable as jax_lora_trainable
from baton_tpu.models.lora import lora_wrap as jax_lora_wrap
from baton_tpu.models.lora import merge_lora as jax_merge_lora
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch.core.partition import make_partition
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model, llama_lora_target
from baton_tpu_torch.models.lora import (
    LoraSpec,
    lora_trainable,
    lora_wrap,
    merge_lora,
    merge_lora_model,
)
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.server.state import params_to_state_dict
from _torch_zoo import close, port, rounds_agree

torch.set_num_threads(1)

RANK = 2


def _jax_lora_llama(seed=0):
    """The JAX LoRA Llama with nonzero adapters (B is zeros at init)."""
    jmodel = jax_lora_wrap(jax_llama(JaxLlamaConfig.tiny()), rank=RANK, target=jax_target)
    jparams = jmodel.init(jax.random.key(seed))
    state = jax_to_state(jparams)
    rng = np.random.default_rng(seed)
    state = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
             if k.startswith("lora/") else v for k, v in state.items()}
    return jmodel, jax_from_state(jparams, state)


def _port_lora_llama():
    return lora_wrap(llama_lm_model(LlamaConfig.tiny()), rank=RANK, target=llama_lora_target)


def test_adapter_names_and_init():
    params = _port_lora_llama().init(torch.Generator().manual_seed(0))
    jmodel, jparams = _jax_lora_llama()
    assert set(params) == set(jax_to_state(jparams))
    a, b = params["lora/blocks/0/attn/wq/a"], params["lora/blocks/0/attn/wq/b"]
    assert a.shape == (64, RANK) and b.shape == (RANK, 64)
    assert torch.equal(b, torch.zeros_like(b))
    assert 0.5 < float(a.std() * 64 ** 0.5) < 1.5  # normal / sqrt(fan_in)
    adapted = {k[len("lora/"):-len("/a")] for k in params if k.endswith("/a")}
    assert adapted == {f"blocks/{i}/attn/{w}" for i in range(2)
                       for w in ("wq", "wk", "wv", "wo")}


def test_merge_lora_matches_jax():
    jmodel, jparams = _jax_lora_llama()
    params = port(jparams)
    want = jax_to_state(jax_merge_lora(jparams, 2.0 * RANK, RANK))
    got = merge_lora(params, 2.0 * RANK, RANK)
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name], 1e-6, name)
    model = _port_lora_llama()
    assert model.aux == LoraSpec(rank=RANK, alpha=2.0 * RANK)
    for name, t in merge_lora_model(model, params).items():
        assert torch.equal(t, got[name]), name


def test_lora_round_matches_jax_and_keeps_the_base():
    jmodel, jparams = _jax_lora_llama()
    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(3)
    datasets = []
    for n in (5, 0, 8):
        toks = rng.integers(0, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
        datasets.append({"x": toks, "y": toks,
                         "loss_mask": (rng.random((n, cfg.max_len)) > 0.5).astype(np.float32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    assert jax_lora_trainable("lora/x/a", None) and lora_trainable("lora/x/a", None)
    params, res = rounds_agree(jmodel, _port_lora_llama(), jparams, data, n_samples, 4, 0.05,
                               n_epochs=2, trainable=lora_trainable)
    moved = 0.0
    for name, before in params.items():
        if name.startswith("base/"):
            assert torch.equal(res.params[name], before), name
        else:
            moved = max(moved, float((res.params[name] - before).abs().max()))
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_lora_fedprox.py:25-66), on the port


def test_partition_split_merge_roundtrip():
    params = {"a/w": torch.ones(2, 3), "a/b": torch.zeros(3), "c": torch.arange(4.0)}
    part = make_partition(params, lambda path, leaf: leaf.dim() == 2)
    trainable, frozen = part.split(params)
    assert len(trainable) == 1 and len(frozen) == 2
    merged = part.merge(trainable, frozen)
    assert list(merged) == list(params)
    for name in params:
        assert torch.equal(merged[name], params[name])


def test_partition_rejects_empty_selection():
    with pytest.raises(ValueError):
        make_partition({"a": torch.ones(3)}, lambda p, l: False)


def _classif_data(nprng, n_clients=4, dim=8, n_classes=4):
    datasets = []
    w = nprng.normal(size=(dim, n_classes))
    for _ in range(n_clients):
        n = int(nprng.integers(20, 40))
        x = nprng.normal(size=(n, dim)).astype(np.float32)
        y = np.argmax(x @ w + 0.1 * nprng.normal(size=(n, n_classes)), axis=1)
        datasets.append({"x": x, "y": y.astype(np.int32)})
    return stack_client_datasets(datasets, batch_size=16)


def test_lora_init_is_identity(nprng):
    base_model = mlp_classifier_model(8, (16,), 4)
    model = lora_wrap(base_model, rank=4)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"x": torch.from_numpy(nprng.normal(size=(5, 8)).astype(np.float32)),
             "y": torch.zeros(5, dtype=torch.int64)}
    base = {k[len("base/"):]: v for k, v in params.items() if k.startswith("base/")}
    close(model.apply(params, batch), base_model.apply(base, batch).numpy(), 1e-6)


def test_federated_lora_trains_only_adapters(nprng):
    base_model = mlp_classifier_model(8, (16,), 4)
    model = lora_wrap(base_model, rank=4)
    params = model.init(torch.Generator().manual_seed(0))
    data, n_samples = _classif_data(nprng)
    sim = FedSim(model, batch_size=16, learning_rate=0.1, trainable=lora_trainable,
                 device="cpu")
    p, hist = sim.run_rounds(params, data, n_samples, torch.Generator().manual_seed(2),
                             n_rounds=4, n_epochs=2)
    for name, before in params.items():
        if name.startswith("base/"):
            assert torch.equal(p[name], before), name
    assert any(float((p[k] - params[k]).abs().max()) > 0 for k in params if lora_trainable(k, 0))
    assert hist[-1] < hist[0]
    merged = merge_lora_model(model, p)
    assert max(float((merged[k] - params[f"base/{k}"]).abs().max()) for k in merged) > 0
    assert set(params_to_state_dict(merged)) == {"0/w", "0/b", "1/w", "1/b"}
