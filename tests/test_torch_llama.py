"""The port's Llama parts (``baton_tpu_torch/models/transformer.py``,
``llama.py``) against the JAX package on the same weights (carried by the
weights bridge) and the same numpy inputs: ``rms_norm``, ``apply_rope``
and ``per_token_cross_entropy`` 1e-6; ``mha_apply`` with RoPE and GQA,
causal, 1e-5; the tiny Llama's logits and masked per-example loss 1e-5.
Remat against no remat for the Llama and its MoE variant, plain and
under the trainer's vmap over clients with a frozen base, 1e-6. The
reference's own attention, RoPE and Llama cases
(``tests/test_transformers.py``), and ``configure_attention_dispatch``:
explicit arguments win, a foreign or malformed artifact changes nothing,
one bad row does not discard the rows after it, a TPU artifact is ignored
and any tile but the kernels' raises."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models import transformer as jt
from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu.models.moe import MoEConfig as JaxMoEConfig
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.models import transformer as tt
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
from baton_tpu_torch.models.moe import MoEConfig
from _torch_zoo import close, port, to_jax, to_torch

torch.set_num_threads(1)

B, L, D, HQ, HKV = 3, 16, 32, 4, 2


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm():
    x = _x(0, B, L, D) * 3 + 1
    p = {"scale": jnp.asarray(_x(1, D))}
    close(tt.rms_norm(torch.from_numpy(x), port(p)), jt.rms_norm(jnp.asarray(x), p), 1e-6)


def test_rope_angles_and_apply_rope():
    cos, sin = jt.rope_angles(L, 8, 500000.0)
    tcos, tsin = tt.rope_angles(L, 8, 500000.0)
    close(tcos, cos, 1e-6)
    close(tsin, sin, 1e-6)
    x = _x(2, B, HQ, L, 8)
    close(tt.apply_rope(torch.from_numpy(x), tcos, tsin),
          jt.apply_rope(jnp.asarray(x), cos, sin), 1e-6)


def test_per_token_cross_entropy():
    logits = _x(3, B, L, 50) * 4
    labels = np.random.default_rng(4).integers(0, 50, (B, L)).astype(np.int32)
    close(tt.per_token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
          jt.per_token_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)


def test_swiglu():
    p = jt.swiglu_init(jax.random.key(0), D, 64)
    x = _x(5, B, L, D)
    close(tt.swiglu_apply(port(p), torch.from_numpy(x)), jt.swiglu_apply(p, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("n_kv", [HKV, HQ], ids=["gqa", "mha"])
def test_mha_with_rope_causal(n_kv):
    p = jt.mha_init(jax.random.key(1), D, HQ, n_kv_heads=n_kv)
    x = _x(6, B, L, D)
    rope = jt.rope_angles(L, D // HQ)
    want = jt.mha_apply(p, jnp.asarray(x), HQ, n_kv_heads=n_kv, causal=True, rope=rope)
    got = tt.mha_apply(port(p), torch.from_numpy(x), HQ, n_kv_heads=n_kv, causal=True,
                       rope=tt.rope_angles(L, D // HQ))
    close(got, want, 1e-5)


def _tokens(seed, cfg, b=3, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    batch = {"x": x, "y": np.roll(x, -1, axis=1)}
    if masked:
        mask = (rng.random((b, cfg.max_len)) > 0.4).astype(np.float32)
        mask[-1] = 0.0  # a sequence with no token in the loss
        batch["loss_mask"] = mask
    return batch


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_tiny_llama_logits_and_masked_loss(moe):
    jcfg = JaxLlamaConfig.tiny(moe=JaxMoEConfig(n_experts=4, top_k=2) if moe else None)
    jmodel = jax_llama(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = llama_lm_model(LlamaConfig.tiny(moe=MoEConfig(n_experts=4, top_k=2) if moe else None))
    batch = _tokens(0, jcfg)
    params, tb = port(jparams), to_torch(batch)
    close(model.apply(params, tb), jmodel.apply(jparams, to_jax(batch), None), 1e-5)
    close(model.per_example_loss(params, tb),
          jmodel.per_example_loss(jparams, to_jax(batch), None), 1e-5)


def _grads_equal(plain, remat, params, batch, tol=1e-6):
    """Loss and every gradient of the mean loss, remat against none."""
    def loss(model):
        return lambda p: model.per_example_loss(p, batch).mean()

    g0, l0 = torch.func.grad_and_value(loss(plain))(params)
    g1, l1 = torch.func.grad_and_value(loss(remat))(params)
    close(l1, l0, tol)
    for name in g0:
        close(g1[name], g0[name], tol, name)


@pytest.mark.parametrize("moe", [None, MoEConfig(n_experts=2, top_k=1)], ids=["dense", "moe"])
def test_llama_remat_matches_no_remat(moe):
    cfg = LlamaConfig.tiny(moe=moe)
    params = llama_lm_model(cfg).init(torch.Generator().manual_seed(0))
    _grads_equal(llama_lm_model(cfg), llama_lm_model(cfg, remat=True), params,
                 to_torch(_tokens(1, cfg)))


def test_llama_remat_under_the_client_vmap_with_a_frozen_base():
    """Remat inside the trainer's ``vmap(grad)``: the frozen params enter
    unbatched, the trainable ones per client; two steps of two clients
    end on the same params as without remat."""
    from baton_tpu_torch.core.partition import make_partition

    cfg = LlamaConfig.tiny()
    params = llama_lm_model(cfg).init(torch.Generator().manual_seed(0))
    part = make_partition(params, lambda name, leaf: name.endswith(("wq", "norm_f/scale")))
    trainable, frozen = part.split(params)
    data = {k: torch.stack([v, v.flip(0)]) for k, v in to_torch(_tokens(2, cfg, b=4)).items()}
    n = torch.tensor([4, 3])
    perms = torch.stack([torch.randperm(4, generator=torch.Generator().manual_seed(i))
                         for i in range(2)])[:, None]
    out = []
    for remat in (False, True):
        trainer = make_local_trainer(llama_lm_model(cfg, remat=remat), batch_size=2,
                                     learning_rate=0.1, partition=part)
        out.append(trainer.train_clients(trainable, data, n, 1, perms, frozen=frozen))
    (p0, l0), (p1, l1) = out
    close(l1, l0, 1e-6)
    for name in p0:
        close(p1[name], p0[name], 1e-6, name)
        assert not torch.equal(p0[name], trainable[name].expand_as(p0[name])), name


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_transformers.py), on the port


def _naive_attention(q, k, v, bias=None, causal=False):
    """Oracle: kv heads repeated explicitly, plain softmax."""
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    scores = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if bias is not None:
        scores = scores + bias
    if causal:
        idx = torch.arange(q.shape[2])
        scores = torch.where(idx[:, None] >= idx[None, :], scores, torch.tensor(-1e30))
    return torch.softmax(scores, -1) @ v


def _qkv(nprng, b, hq, hkv, l, dh):
    return (torch.from_numpy(nprng.normal(size=s).astype(np.float32))
            for s in ((b, hq, l, dh), (b, hkv, l, dh), (b, hkv, l, dh)))


@pytest.mark.parametrize("attention", [tt.dot_product_attention, tt.default_attention],
                         ids=["dense", "default"])
def test_gqa_matches_naive_repeat(nprng, attention):
    q, k, v = _qkv(nprng, 2, 8, 2, 6, 64)
    close(attention(q, k, v), _naive_attention(q, k, v), 1e-5)


@pytest.mark.parametrize("attention", [tt.dot_product_attention, tt.default_attention],
                         ids=["dense", "default"])
def test_causal_masking(nprng, attention):
    q, k, v = _qkv(nprng, 1, 2, 2, 5, 64)
    out1 = attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1], v2[:, :, -1] = 99.0, 99.0
    out2 = attention(q, k2, v2, causal=True)
    close(out1[:, :, :-1], out2[:, :, :-1].numpy(), 1e-6)


def test_padding_bias_excludes_padded_keys(nprng):
    q, k, v = _qkv(nprng, 1, 2, 2, 6, 64)
    bias = tt.padding_bias(torch.tensor([[1, 1, 1, 1, 0, 0]], dtype=torch.float32))
    out = tt.default_attention(q, k, v, bias=bias)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 4:], v2[:, :, 4:] = 7.0, -7.0
    close(tt.default_attention(q, k2, v2, bias=bias), out.numpy(), 1e-6)


def test_rope_preserves_norm_and_relative_position(nprng):
    l, dh = 8, 8
    cos, sin = tt.rope_angles(l, dh)
    x = torch.from_numpy(nprng.normal(size=(1, 1, l, dh)).astype(np.float32))
    close(tt.apply_rope(x, cos, sin).norm(dim=-1), x.norm(dim=-1).numpy(), 1e-5)
    q, k = (torch.from_numpy(nprng.normal(size=(1, 1, l, dh)).astype(np.float32))
            for _ in range(2))

    def dots(q, k):
        return tt.apply_rope(q, cos, sin) @ tt.apply_rope(k, cos, sin).transpose(-1, -2)

    shifted = dots(q.roll(1, 2), k.roll(1, 2))
    np.testing.assert_allclose(float(dots(q, k)[0, 0, 2, 1]), float(shifted[0, 0, 3, 2]),
                               rtol=1e-4)


def test_llama_lm_loss_masking(nprng):
    cfg = LlamaConfig.tiny()
    model = llama_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    l = cfg.max_len
    x = torch.from_numpy(nprng.integers(0, cfg.vocab_size, (2, l)))
    y = torch.from_numpy(nprng.integers(0, cfg.vocab_size, (2, l)))
    batch = {"x": x, "y": y, "loss_mask": torch.ones(2, l)}
    assert model.apply(params, batch).shape == (2, l, cfg.vocab_size)
    assert model.per_example_loss(params, batch).shape == (2,)
    half = torch.cat([torch.ones(2, l // 2), torch.zeros(2, l - l // 2)], dim=1)
    garbage = y.clone()
    garbage[:, l // 2:] = 0
    l1 = model.per_example_loss(params, dict(batch, loss_mask=half))
    l2 = model.per_example_loss(params, dict(batch, loss_mask=half, y=garbage))
    close(l2, l1.detach().numpy(), 1e-6)


def test_llama_causality_end_to_end(nprng):
    cfg = LlamaConfig.tiny()
    model = llama_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(nprng.integers(0, cfg.vocab_size, (1, cfg.max_len)))
    x2 = x.clone()
    x2[0, -1] = (x[0, -1] + 1) % cfg.vocab_size
    logits = model.apply(params, {"x": x, "y": x})
    logits2 = model.apply(params, {"x": x2, "y": x2})
    close(logits2[:, :-1], logits[:, :-1].detach().numpy(), 1e-5)


def test_llama3_8b_shape():
    """Llama-3-8B's parameter count, from the shapes alone (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = llama_lm_model(LlamaConfig.llama3_8b()).init(torch.Generator())
        n = sum(v.numel() for v in params.values())
    assert n == 8_030_261_248


# ---------------------------------------------------------------------------
# configure_attention_dispatch (tests/test_transformers.py:316, on the port)


@pytest.fixture
def dispatch_state():
    orig = (tt._FLASH_MIN_LEN, tt._FLASH_BLOCKS)
    yield orig
    tt._FLASH_MIN_LEN, tt._FLASH_BLOCKS = orig


def _sweep(tmp_path, platform, results):
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({"platform": platform, "results": results}))
    return str(path)


ROWS = [
    {"L": 512, "dense_ms": 1.0, "flash": {"64x64": None}},        # a null timing
    {"L": 1024, "dense_ms": 1.0, "flash": {"64x64": 1.5}},        # dense wins
    {"L": 2048, "dense_ms": 4.0, "flash": {"128x128": 2.0, "64x64": 3.0}},  # a foreign tile
    {"L": 4096, "dense_ms": 20.0, "flash": {"64x64": 5.0}},
    {"L": 8192, "dense_ms": 80.0, "flash": {"64x64": 9.0}},
]


def test_dispatch_adopts_the_gpu_crossover(tmp_path, dispatch_state):
    """The smallest L whose flash time beats dense; the malformed rows
    before it are skipped, not fatal."""
    assert tt.configure_attention_dispatch(
        sweep_path=_sweep(tmp_path, "gpu", ROWS)) == (4096, (64, 64))


@pytest.mark.parametrize("platform", ["tpu", "cpu", None])
def test_dispatch_ignores_foreign_artifacts(tmp_path, dispatch_state, platform):
    assert tt.configure_attention_dispatch(
        sweep_path=_sweep(tmp_path, platform, ROWS)) == dispatch_state


def test_dispatch_without_crossover_missing_or_malformed_changes_nothing(tmp_path,
                                                                         dispatch_state):
    slow = [dict(r, flash={"64x64": r["dense_ms"] * 2}) for r in ROWS]
    assert tt.configure_attention_dispatch(
        sweep_path=_sweep(tmp_path, "gpu", slow)) == dispatch_state
    assert tt.configure_attention_dispatch(
        sweep_path=str(tmp_path / "absent.json")) == dispatch_state
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tt.configure_attention_dispatch(sweep_path=str(bad)) == dispatch_state
    bad.write_text(json.dumps(["a list"]))
    assert tt.configure_attention_dispatch(sweep_path=str(bad)) == dispatch_state


def test_dispatch_explicit_arguments_win(tmp_path, dispatch_state):
    assert tt.configure_attention_dispatch(
        min_len=8192, blocks=(64, 64), sweep_path=_sweep(tmp_path, "gpu", ROWS)
    ) == (8192, (64, 64))
    assert tt.configure_attention_dispatch(min_len=0) == (0, (64, 64))


@pytest.mark.parametrize("blocks", [(128, 128), (64, 128), (512, 1024)])
def test_dispatch_refuses_a_tile_the_kernels_lack(dispatch_state, blocks):
    with pytest.raises(ValueError, match="one tile"):
        tt.configure_attention_dispatch(blocks=blocks)
    assert (tt._FLASH_MIN_LEN, tt._FLASH_BLOCKS) == dispatch_state


def test_default_attention_follows_the_crossover_and_the_dense_budget(monkeypatch,
                                                                      dispatch_state):
    """Below the crossover the dense path runs, unless its fp32 scores
    would pass the budget; a bias that is not per-key always goes dense."""
    calls = []
    monkeypatch.setattr(tt, "flash_attention", lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(tt, "dot_product_attention", lambda *a, **kw: calls.append("dense"))
    q = k = v = torch.zeros(2, 4, 64, 8)
    tt.configure_attention_dispatch(min_len=128)
    tt.default_attention(q, k, v)
    tt.configure_attention_dispatch(min_len=64)
    tt.default_attention(q, k, v)
    tt.default_attention(q, k, v, bias=torch.zeros(2, 4, 64, 64))
    tt.configure_attention_dispatch(min_len=1 << 20)
    monkeypatch.setattr(tt, "_DENSE_SCORES_BUDGET_BYTES", 4 * 2 * 4 * 64 * 64 - 1)
    tt.default_attention(q, k, v)
    assert calls == ["dense", "flash", "dense", "flash"]
