"""The port's ViT (``baton_tpu_torch/models/vit.py``) against the JAX
package on the same weights and numpy images: patchify (exact), the
logits and per-example losses 1e-5, and a FedSim round on JAX's shuffles
1e-4. Remat against no remat for the encoder blocks ViT shares with BERT,
for both models, 1e-6 (``tests/test_transformers.py``'s remat cases),
and the reference's ViT shape, round and ViT-B/16 parameter count."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from baton_tpu.models.vit import ViTConfig as JaxViTConfig
from baton_tpu.models.vit import _patchify as jax_patchify
from baton_tpu.models.vit import vit_model as jax_vit
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.vit import ViTConfig, _patchify, vit_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim
from _torch_zoo import close, port, rounds_agree, to_jax, to_torch

torch.set_num_threads(1)


def _images(seed, n, cfg):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, cfg.image_size, cfg.image_size, cfg.channels)
                            ).astype(np.float32),
            "y": rng.integers(0, cfg.n_classes, (n,)).astype(np.int32)}


def test_patchify_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    assert np.array_equal(_patchify(torch.from_numpy(x), 4).numpy(),
                          np.asarray(jax_patchify(jnp.asarray(x), 4)))


def test_vit_forward_matches_jax():
    jmodel = jax_vit(JaxViTConfig.tiny())
    jparams = jmodel.init(jax.random.key(0))
    model = vit_model(ViTConfig.tiny())
    params = port(jparams)
    assert set(params) == set(model.init(torch.Generator().manual_seed(0)))
    batch = _images(1, 3, ViTConfig.tiny())
    close(model.apply(params, to_torch(batch)), jmodel.apply(jparams, to_jax(batch), None), 1e-5)
    close(model.per_example_loss(params, to_torch(batch)),
          jmodel.per_example_loss(jparams, to_jax(batch), None), 1e-5)


def test_vit_round_matches_jax():
    cfg = ViTConfig.tiny()
    jmodel = jax_vit(JaxViTConfig.tiny())
    datasets = [_images(2 + i, n, cfg) for i, n in enumerate((5, 8, 0))]
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    rounds_agree(jmodel, vit_model(cfg), jmodel.init(jax.random.key(0)), data, n_samples, 4,
                 0.05, n_epochs=2)


def _grads_equal(plain, remat, params, batch, tol=1e-6):
    def loss(model):
        return lambda p: model.per_example_loss(p, batch).mean()

    g0, l0 = torch.func.grad_and_value(loss(plain))(params)
    g1, l1 = torch.func.grad_and_value(loss(remat))(params)
    close(l1, l0, tol)
    for name in g0:
        close(g1[name], g0[name], tol, name)


def test_vit_remat_matches_no_remat():
    cfg = ViTConfig.tiny()
    params = vit_model(cfg).init(torch.Generator().manual_seed(0))
    _grads_equal(vit_model(cfg), vit_model(cfg, remat=True), params,
                 to_torch(_images(4, 4, cfg)))


def test_bert_remat_matches_no_remat():
    cfg = BertConfig.tiny()
    params = bert_classifier_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    mask = rng.integers(0, 2, (4, cfg.max_len)).astype(np.float32)
    mask[:, 0] = 1.0
    batch = {"x": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, cfg.max_len))),
             "attn_mask": torch.from_numpy(mask),
             "y": torch.from_numpy(rng.integers(0, cfg.n_classes, (4,)))}
    _grads_equal(bert_classifier_model(cfg), bert_classifier_model(cfg, remat=True), params,
                 batch)
    no_mask = {k: v for k, v in batch.items() if k != "attn_mask"}
    _grads_equal(bert_classifier_model(cfg), bert_classifier_model(cfg, remat=True), params,
                 no_mask)


def test_vit_remat_round_equals_the_plain_round():
    """Under FedSim's vmap over clients, remat changes no param."""
    cfg = ViTConfig.tiny()
    data, n_samples = stack_client_datasets([_images(5 + i, 6, cfg) for i in range(2)],
                                            batch_size=4)
    out = []
    for remat in (False, True):
        sim = FedSim(vit_model(cfg, remat=remat), batch_size=4, learning_rate=0.05,
                     device="cpu")
        params = sim.init(torch.Generator().manual_seed(0))
        out.append(sim.run_round(params, data, n_samples, torch.Generator().manual_seed(1)))
    for name, want in out[0].params.items():
        close(out[1].params[name], want.numpy(), 1e-6, name)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_transformers.py), on the port


def test_vit_shapes_and_round(nprng):
    cfg = ViTConfig.tiny()
    model = vit_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"x": torch.from_numpy(nprng.normal(size=(2, 16, 16, 3)).astype(np.float32)),
             "y": torch.zeros(2, dtype=torch.int64)}
    assert model.apply(params, batch).shape == (2, cfg.n_classes)
    datasets = []
    for _ in range(2):
        n = int(nprng.integers(5, 9))
        datasets.append({"x": nprng.normal(size=(n, 16, 16, 3)).astype(np.float32),
                         "y": nprng.integers(0, 10, size=(n,)).astype(np.int32)})
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    sim = FedSim(model, batch_size=4, learning_rate=0.01, device="cpu")
    res = sim.run_round(params, data, n_samples, torch.Generator().manual_seed(2))
    assert np.isfinite(float(res.loss_history[0]))


def test_vit_b16_param_count():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = vit_model(ViTConfig.b16()).init(torch.Generator())
        n = sum(v.numel() for v in params.values())
    assert 85_000_000 < n < 88_000_000  # ViT-B/16 is ~86.6M
