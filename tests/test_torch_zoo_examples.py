"""Examples 04 (Llama LoRA, BASELINE config 4) and 07 (the Shakespeare
char LSTM) in the port (``baton_tpu_torch/examples/llama_lora.py``,
``lstm_shakespeare.py``) on the CPU, at their tiny presets: each example's
data equals the JAX example's, its round agrees with the JAX example's
round on the same weights (carried by ``server/state.py`` names) and the
shuffles JAX draws from the example's round key, within 1e-4; and
``run()`` as the example runs it lowers the loss (example 04's ``run``
also checks that its base is bit-equal after the rounds)."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from baton_tpu.data.synthetic import synthetic_char_clients as jax_char_clients
from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu.models.llama import llama_lora_target as jax_target
from baton_tpu.models.lora import lora_wrap as jax_lora_wrap
from baton_tpu.models.lstm import LSTMConfig as JaxLSTMConfig
from baton_tpu.models.lstm import lstm_lm_model as jax_lstm
from baton_tpu.server.state import state_dict_to_params as jax_from_state
from baton_tpu_torch.examples import llama_lora, lstm_shakespeare
from baton_tpu_torch.models.llama import LlamaConfig
from baton_tpu_torch.models.lora import lora_trainable
from baton_tpu_torch.models.lstm import LSTMConfig
from baton_tpu_torch.server.state import params_to_state_dict
from _torch_zoo import rounds_agree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _round_key():
    """The examples' round-0 key: ``fold_in(key(seed + 1), 0)``."""
    return jax.random.fold_in(jax.random.key(SEED + 1), 0)


def test_example04_data_is_the_jax_examples():
    cfg = LlamaConfig.tiny()
    want = _jax_example("04_llama_lora").make_data(np.random.default_rng(SEED),
                                                   JaxLlamaConfig.tiny(), 4, 8)
    got = llama_lora.make_data(np.random.default_rng(SEED), cfg, 4, 8)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"x", "y", "loss_mask"}
        for k in w:
            assert np.array_equal(g[k], w[k]), k


def test_example04_round_matches_the_jax_example():
    cfg = LlamaConfig.tiny()
    data, n_samples = llama_lora.client_data(cfg, 4, 8, 4, SEED)
    sim, model = llama_lora.make_sim(cfg, rank=4, batch_size=4, device="cpu")
    params = sim.init(torch.Generator().manual_seed(SEED))
    jmodel = jax_lora_wrap(jax_llama(JaxLlamaConfig.tiny()), rank=4, target=jax_target)
    jparams = jax_from_state(jmodel.init(jax.random.key(SEED)), params_to_state_dict(params))
    before, res = rounds_agree(jmodel, model, jparams, data, n_samples, 4,
                               llama_lora.LEARNING_RATE, trainable=lora_trainable,
                               key=_round_key())
    for name, t in before.items():
        if name.startswith("base/"):
            assert torch.equal(res.params[name], t), name


def test_example04_run_learns_and_keeps_its_base():
    history, merged = llama_lora.run(device="cpu")
    assert history[-1] < history[0], "loss should fall"
    assert "lm_head" in merged and not any(k.startswith("lora/") for k in merged)


def test_example04_full_preset_is_the_references():
    assert llama_lora.FULL == dict(n_clients=64, n_per_client=512, n_rounds=10, batch_size=8,
                                   rank=16)
    assert llama_lora.FULL_CONFIG == LlamaConfig(
        vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        max_len=1024)


def test_example07_round_matches_the_jax_example():
    cfg = LSTMConfig.tiny(vocab_size=16)
    data, n_samples = lstm_shakespeare.client_data(cfg, 8, 16, 24, 8, SEED)
    want = jax_char_clients(np.random.default_rng(SEED), 8, n_per_client=16, seq_len=24,
                            vocab_size=16, order=1)
    assert np.array_equal(data["x"][:, :16], np.stack([d["x"] for d in want]))
    sim = lstm_shakespeare.make_sim(cfg, batch_size=8, device="cpu")
    params = sim.init(torch.Generator().manual_seed(SEED))
    jmodel = jax_lstm(JaxLSTMConfig.tiny(vocab_size=16))
    jparams = jax_from_state(jmodel.init(jax.random.key(SEED)), params_to_state_dict(params))
    rounds_agree(jmodel, sim.model, jparams, data, n_samples, 8,
                 lstm_shakespeare.LEARNING_RATE, n_epochs=2, key=_round_key())


def test_example07_run_learns():
    history, metrics = lstm_shakespeare.run(device="cpu")
    assert history[-1] < history[0], "loss should fall"
    assert metrics["loss"] < np.log(16)


@pytest.mark.parametrize("example", [llama_lora, lstm_shakespeare],
                         ids=["llama_lora", "lstm_shakespeare"])
def test_examples_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.run()
