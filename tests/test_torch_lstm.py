"""The port's char LSTM (``baton_tpu_torch/models/lstm.py``) against the
JAX package on the same weights and numpy inputs: the logits and masked
per-example losses 1e-5, and a FedSim round on JAX's shuffles 1e-4. Then
the reference's own cases (``tests/test_lstm.py:21-114``): the cell
against a numpy oracle, the forget-gate bias, shapes and the masked
loss, learning a deterministic sequence, and a federated round."""

import jax
import numpy as np
import torch

from baton_tpu.models.lstm import LSTMConfig as JaxLSTMConfig
from baton_tpu.models.lstm import lstm_lm_model as jax_lstm
from baton_tpu_torch.core import optim
from baton_tpu_torch.models.lstm import LSTMConfig, _cell_step, lstm_lm_model
from baton_tpu_torch.models.transformer import per_token_cross_entropy
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim
from _torch_zoo import close, port, rounds_agree, to_jax, to_torch

torch.set_num_threads(1)


def _chars(seed, n, l, vocab, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (n, l)).astype(np.int32)
    batch = {"x": x, "y": np.roll(x, -1, axis=1)}
    if masked:
        batch["loss_mask"] = (rng.random((n, l)) > 0.3).astype(np.float32)
    return batch


def test_lstm_forward_matches_jax():
    jmodel = jax_lstm(JaxLSTMConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    model = lstm_lm_model(LSTMConfig.tiny())
    params = port(jparams)
    assert set(params) == set(model.init(torch.Generator().manual_seed(0)))
    batch = _chars(1, 3, 12, 32, masked=True)
    close(model.apply(params, to_torch(batch)), jmodel.apply(jparams, to_jax(batch), None), 1e-5)
    close(model.per_example_loss(params, to_torch(batch)),
          jmodel.per_example_loss(jparams, to_jax(batch), None), 1e-5)


def test_lstm_round_matches_jax():
    jmodel = jax_lstm(JaxLSTMConfig.tiny())
    datasets = [_chars(2 + i, n, 10, 32) for i, n in enumerate((6, 0, 9))]
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    rounds_agree(jmodel, lstm_lm_model(LSTMConfig.tiny()), jmodel.init(jax.random.key(0)),
                 data, n_samples, 4, 0.5, n_epochs=2)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_lstm.py:21-114), on the port


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def test_cell_step_matches_numpy_oracle(nprng):
    d_in, h_dim, b = 5, 7, 3
    kernel = nprng.normal(size=(d_in + h_dim, 4 * h_dim)).astype(np.float32)
    bias = nprng.normal(size=(4 * h_dim,)).astype(np.float32)
    x, h, c = (nprng.normal(size=s).astype(np.float32)
               for s in ((b, d_in), (b, h_dim), (b, h_dim)))
    p = {"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(bias)}
    h2, c2 = _cell_step(p, *map(torch.from_numpy, (x, h, c)), torch.float32)
    z = np.concatenate([x, h], axis=-1) @ kernel + bias
    i, f, g, o = np.split(z, 4, axis=-1)
    c_want = _sigmoid(f) * c + _sigmoid(i) * np.tanh(g)
    h_want = _sigmoid(o) * np.tanh(c_want)
    np.testing.assert_allclose(c2.numpy(), c_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), h_want, rtol=1e-5, atol=1e-6)


def test_forget_gate_bias_is_one():
    cfg = LSTMConfig.tiny()
    params = lstm_lm_model(cfg).init(torch.Generator().manual_seed(0))
    h = cfg.d_hidden
    for i in range(cfg.n_layers):
        b = params[f"layers/{i}/bias"]
        assert torch.equal(b[h:2 * h], torch.ones(h))  # forget gate
        assert torch.equal(b[:h], torch.zeros(h))


def test_shapes_and_masked_loss(nprng):
    cfg = LSTMConfig.tiny()
    model = lstm_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    b, l = 4, 12
    batch = {"x": torch.from_numpy(nprng.integers(0, cfg.vocab_size, (b, l))),
             "y": torch.from_numpy(nprng.integers(0, cfg.vocab_size, (b, l)))}
    logits = model.apply(params, batch)
    assert logits.shape == (b, l, cfg.vocab_size) and logits.dtype == torch.float32
    losses = model.per_example_loss(params, batch)
    assert losses.shape == (b,) and bool(torch.isfinite(losses).all())
    mask = torch.zeros(b, l)
    mask[:, : l // 2] = 1.0
    masked = model.per_example_loss(params, {**batch, "loss_mask": mask})
    want = per_token_cross_entropy(logits, batch["y"])[:, : l // 2].mean(-1)
    close(masked, want.detach().numpy(), 1e-5)


def test_learns_deterministic_sequence():
    """A repeating character cycle is perfectly predictable: Adam drives
    the next-char loss well below chance."""
    cfg = LSTMConfig.tiny(vocab_size=8)
    model = lstm_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    l = 16
    seq = np.arange(64 + l + 1) % 8
    batch = {"x": torch.from_numpy(np.stack([seq[i:i + l] for i in range(64)])),
             "y": torch.from_numpy(np.stack([seq[i + 1:i + 1 + l] for i in range(64)]))}
    opt = optim.adam(1e-2)
    state = opt.init(params)
    grad_fn = torch.func.grad_and_value(lambda q: model.per_example_loss(q, batch).mean())
    first = None
    for _ in range(120):
        g, loss = grad_fn(params)
        updates, state = opt.update(g, state, params)
        params = optim.apply_updates(params, updates)
        first = float(loss) if first is None else first
    assert float(loss) < 0.25 < first, (first, float(loss))


def test_federated_round(nprng):
    cfg = LSTMConfig.tiny()
    model = lstm_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    datasets = []
    for _ in range(4):
        n = int(nprng.integers(6, 12))
        x = nprng.integers(0, cfg.vocab_size, (n, 10)).astype(np.int32)
        datasets.append({"x": x, "y": np.roll(x, -1, axis=1)})
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    sim = FedSim(model, batch_size=4, learning_rate=0.5, device="cpu")
    res = sim.run_round(params, data, n_samples, torch.Generator().manual_seed(1), n_epochs=2)
    assert bool(torch.isfinite(res.loss_history).all())
    assert any(not torch.equal(res.params[k], params[k]) for k in params)
