"""Example 06 (long-context training with ring × flash sequence
parallelism) in the port (``baton_tpu_torch/examples/long_context_ring.py``)
on the CPU, against the JAX example (``examples/06_long_context_ring.py``)
at its tiny preset: the port's ``run()`` starts from the JAX model's
weights (carried by ``server/state.py`` names), takes the same tokens and
the row shuffles JAX draws from the example's key, and trains 3 steps on
an 8-way mesh of the CPU, as JAX's run does on its 8 virtual devices.
Step 0's loss agrees within 1e-5 (the same weights and tokens: the ring
alone differs), every step within the reference's 5e-2 multi-epoch band
(tests/test_mesh_equivalence.py); ring × flash and ``--striped`` alike. The full preset is
the example's own arguments."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu_torch.examples import long_context_ring
from baton_tpu_torch.models.llama import LlamaConfig
from _torch_zoo import port

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEED, N_STEPS, BATCH = 0, 3, 2


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "long_context_ring_example", ROOT / "examples" / "06_long_context_ring.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_perm():
    """The row shuffle of each step that JAX's ``train`` draws from the
    example's key ``seed + 1`` (one epoch a step)."""
    keys = jax.random.split(jax.random.key(SEED + 1), N_STEPS)
    return np.stack([np.asarray(jax.random.permutation(jax.random.split(k)[0], BATCH))
                     for k in keys])


@pytest.mark.parametrize("striped", [False, True], ids=["ring_flash", "striped"])
def test_tiny_preset_trains_as_the_jax_example(striped):
    example = _jax_example()
    want = example.run(striped=striped)  # 3 steps of the tiny preset
    cfg = long_context_ring.example_config()
    jcfg = JaxLlamaConfig.tiny(max_len=64, n_heads=4, n_kv_heads=2, n_layers=2)
    assert (cfg.vocab_size, cfg.max_len, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers) == (
        jcfg.vocab_size, jcfg.max_len, jcfg.n_heads, jcfg.n_kv_heads, jcfg.n_layers)
    # the same draw as the JAX example's (its model.init(key(seed)))
    params = port(jax_llama(jcfg).init(jax.random.key(SEED)))
    got = long_context_ring.run(striped=striped, device="cpu", params=params,
                                perm=torch.from_numpy(_jax_perm()))
    assert len(got) == len(want) == N_STEPS
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert got[-1] < got[0]


def test_tokens_and_full_preset_are_the_examples():
    example = _jax_example()
    cfg = long_context_ring.example_config()
    rng = np.random.default_rng(SEED)
    want = rng.integers(0, cfg.vocab_size, size=(BATCH, cfg.max_len)).astype(np.int32)
    np.testing.assert_array_equal(long_context_ring.make_tokens(cfg, BATCH, SEED), want)
    for striped, seq in ((False, 32768), (True, 8192)):
        full = long_context_ring.full_preset(striped)
        assert full["config"] == LlamaConfig(vocab_size=32000, max_len=seq, d_model=512,
                                             n_heads=8, n_kv_heads=4, n_layers=8, d_ff=1536)
        assert {k: full[k] for k in ("n_devices", "seq_len", "n_steps", "batch_size",
                                     "remat", "striped")} == dict(
            n_devices=8, seq_len=seq, n_steps=5, batch_size=1, remat=True, striped=striped)
    assert example.run.__defaults__[:5] == (8, 64, 3, 2, 1e-2)


def test_run_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        long_context_ring.run()
