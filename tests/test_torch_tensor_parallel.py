"""Tensor parallelism over the mesh's ``model`` axis
(``baton_tpu_torch/parallel/tensor_parallel.py`` and the Megatron products
of ``models/transformer.py``) against the JAX package, on the CPU.

The five cases of ``tests/test_tensor_parallel.py``, each held against
JAX's result on the same params and batch: the spec rules; the hybrid
mesh of one process; the tiny Llama's loss and gradients with the base on
a ``model``-4 axis (``wk``'s shard edges fall inside its kv heads) against
JAX's replicated ones (1e-5 loss, rtol 2e-4 / atol 1e-5 gradients, JAX's
own tolerances); a step whose update keeps the TP layout, against JAX's
step; the non-divisible fallback. Then the pieces the port computes by
hand where GSPMD derives them in JAX: the MoE layer with its experts over
4 shards against JAX's expert-parallel case and the replicated port
(JAX's tolerances); a Llama whose heads divide the shards (each shard its
own q and kv heads) against the replicated port; BERT's GELU MLP with
``b1`` split and ``b2`` added once, and its vocab on 2 shards (split) and
on 4 (the replicated fallback); the LoRA merge shard by shard; remat over
placed leaves; the weights bridge, which gathers on the way out and
places with a mesh on the way in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu.models.moe import MoEConfig as JaxMoEConfig
from baton_tpu.models.moe import moe_apply as jax_moe_apply
from baton_tpu.models.moe import moe_init as jax_moe_init
from baton_tpu.parallel import tensor_parallel as jtp
from baton_tpu.parallel.mesh import make_mesh as jax_make_mesh
from baton_tpu.parallel.multihost import make_hybrid_mesh as jax_hybrid_mesh
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.models import transformer as tt
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model, llama_lora_target
from baton_tpu_torch.models.lora import lora_wrap, merge_lora
from baton_tpu_torch.models.moe import MoEConfig, moe_apply
from baton_tpu_torch.parallel import tensor_parallel as ttp
from baton_tpu_torch.parallel.mesh import Mesh, make_mesh
from baton_tpu_torch.parallel.multihost import make_hybrid_mesh
from baton_tpu_torch.parallel.partition import PartitionSpec
from baton_tpu_torch.server.state import params_to_state_dict, state_dict_to_params
from _torch_zoo import port, to_jax, to_torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(c, m):
    return Mesh(np.array([[CPU] * m] * c, dtype=object), ("clients", "model"))


def _whole(tree):
    return {k: v.gather() if ttp.is_sharded(v) else v for k, v in tree.items()}


def _tokens(cfg, b, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, cfg.max_len))
    return {"x": toks.astype(np.int32), "y": toks.astype(np.int32)}


def test_spec_rules():
    """``transformer_tp_spec`` gives JAX's spec for each of JAX's cases."""
    cases = [("blocks/0/attn/wq", (8, 8)), ("blocks/0/attn/wo", (8, 8)),
             ("blocks/0/mlp/w_gate", (8, 8)), ("blocks/0/mlp/w_down", (8, 8)),
             ("tok_emb", (8, 8)), ("lm_head", (8, 8)), ("blocks/0/norm_attn/scale", (8,)),
             ("mlp/b1", (8,)), ("blocks/0/mlp/w_up", (4, 8, 8)), ("lora/blocks/0/attn/wq/a", (8, 2))]
    for path, shape in cases:
        want = jtp.transformer_tp_spec(path, jnp.zeros(shape))
        got = ttp.transformer_tp_spec(path, torch.zeros(shape))
        assert tuple(got) == tuple(want) and str(got) == str(want), path
    assert ttp.transformer_tp_spec("blocks/0/attn/wq", torch.zeros(8, 8)) == \
        PartitionSpec(None, "model")
    assert ttp.transformer_tp_spec("blocks/0/attn/wo", torch.zeros(8, 8)) == \
        PartitionSpec("model", None)


def test_hybrid_mesh_single_process():
    """``make_hybrid_mesh`` in one process: JAX's shapes, and the model axis
    never crosses a process (its one owner a line)."""
    for ici, want in (([("model", 4)], {"clients": 2, "model": 4}),
                      ([("seq", 8)], {"clients": 1, "seq": 8})):
        assert make_hybrid_mesh(ici, dcn_axis="clients", devices=[CPU] * 8).shape == want
        assert jax_hybrid_mesh(ici, dcn_axis="clients").shape == want
    mesh = make_hybrid_mesh([("model", 4)], dcn_axis="clients", devices=[CPU] * 8)
    for j in range(2):
        line = mesh.line("model", clients=j)
        assert line.shape == {"model": 4} and set(line.process_ids.flat) == {0}
    assert mesh.local_line("model").devices.shape == (4,)


def test_tp_grads_match_replicated():
    """The tiny Llama (d 64, 4/2 heads of 16) with its base on a ``model``-4
    axis: ``wk``/``wv`` [64, 32] split into 8 columns a shard, half a kv
    head, so attention runs on the gathered projections; the loss and
    every gradient against JAX's replicated ones (JAX's tolerances) and
    against the port's replicated ones."""
    jcfg = JaxLlamaConfig.tiny(max_len=8, n_heads=4, n_kv_heads=2)
    jmodel = jax_llama(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = _tokens(jcfg, 4)
    rng = jax.random.key(1)

    def jloss(p, b):
        return jmodel.per_example_loss(p, b, rng).mean()

    want_l, want_g = jax.jit(jax.value_and_grad(jloss))(jparams, to_jax(batch))
    want_g = jax_to_state(want_g)

    model = llama_lm_model(LlamaConfig.tiny(max_len=8, n_heads=4, n_kv_heads=2))
    params = port(jparams)
    mesh = make_hybrid_mesh([("model", 4)], dcn_axis="clients", devices=[CPU] * 8)
    tp_params = ttp.shard_params_tp(params, mesh)
    assert ttp.describe_tp_sharding(params, mesh)["blocks/0/attn/wq"] == str(
        PartitionSpec(None, "model"))
    assert ttp.is_sharded(tp_params["blocks/0/attn/wk"])
    assert tp_params["blocks/0/attn/wk"].shards[0].shape == (64, 8)  # half of a 16-wide head

    def loss(p):
        return model.per_example_loss(p, to_torch(batch)).mean()

    got_g, got_l = torch.func.grad_and_value(loss)(tp_params)
    rep_g, rep_l = torch.func.grad_and_value(loss)(params)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(float(got_l), float(rep_l), rtol=1e-6)
    assert ttp.is_sharded(got_g["blocks/0/attn/wq"])
    got_g = _whole(got_g)
    assert set(got_g) == set(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name].numpy(), want_g[name], rtol=2e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got_g[name].numpy(), rep_g[name].numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=name)


def test_tp_sharding_preserved_across_steps():
    """A step whose update is a tree map over the placed params keeps the
    TP layout (``tp_sharding_tree``'s specs), and its values are JAX's step."""
    jcfg = JaxLlamaConfig.tiny(max_len=8)
    jmodel = jax_llama(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    jmesh = jax_hybrid_mesh([("model", 4)], dcn_axis="clients")
    toks = jnp.zeros((2, jcfg.max_len), jnp.int32)
    rng = jax.random.key(1)

    @jax.jit
    def jstep(p, b):
        g = jax.grad(lambda q: jmodel.per_example_loss(q, b, rng).mean())(p)
        return jax.tree_util.tree_map(lambda w, d: w - 0.1 * d, p, g)

    want = jax_to_state(jax.jit(jstep, out_shardings=jtp.tp_sharding_tree(jparams, jmesh))(
        jtp.shard_params_tp(jparams, jmesh), {"x": toks, "y": toks}))

    model = llama_lm_model(LlamaConfig.tiny(max_len=8))
    params = port(jparams)
    mesh = make_hybrid_mesh([("model", 4)], dcn_axis="clients", devices=[CPU] * 8)
    shardings = ttp.tp_sharding_tree(params, mesh)
    tp_params = ttp.shard_params_tp(params, mesh)
    batch = {"x": torch.zeros(2, 8, dtype=torch.long), "y": torch.zeros(2, 8, dtype=torch.long)}
    g = torch.func.grad(lambda q: model.per_example_loss(q, batch).mean())(tp_params)
    new = torch.utils._pytree.tree_map(lambda w, d: w - 0.1 * d, tp_params, g)
    new = ttp.place_params(new, shardings, mesh)
    assert new["blocks/0/attn/wq"].spec == PartitionSpec(None, "model")
    assert new["blocks/0/attn/wo"].spec == PartitionSpec("model", None)
    for name, w in _whole(new).items():
        np.testing.assert_allclose(w.numpy(), want[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_nondivisible_falls_back_to_replicated():
    """``wq`` of 6 x 6 on a ``model``-4 axis stays a plain tensor, as JAX's
    stays replicated; a divisible one is placed, its shards views of it."""
    jmesh = jax_hybrid_mesh([("model", 4)], dcn_axis="clients")
    jplaced = jtp.shard_params_tp({"attn": {"wq": jnp.zeros((6, 6))}}, jmesh)
    assert jplaced["attn"]["wq"].sharding.spec in (P(), P(None), P(None, None))
    mesh = make_hybrid_mesh([("model", 4)], dcn_axis="clients", devices=[CPU] * 8)
    placed = ttp.shard_params_tp({"attn/wq": torch.zeros(6, 6), "attn/wo": torch.ones(8, 6)},
                                 mesh)
    assert not ttp.is_sharded(placed["attn/wq"])
    assert ttp.describe_tp_sharding({"attn/wq": torch.zeros(6, 6)}, mesh) == \
        {"attn/wq": str(PartitionSpec())}
    wo = placed["attn/wo"]
    assert wo.spec == PartitionSpec("model", None) and [t.shape for t in wo.shards] == [(2, 6)] * 4
    assert wo.shards[1].untyped_storage().data_ptr() == \
        placed["attn/wo"].shards[0].untyped_storage().data_ptr()
    assert ttp.shard_params_tp({"attn/wo": wo}, mesh)["attn/wo"] is wo  # placed already


def test_expert_parallel_sharding_matches_replicated():
    """The MoE layer with its stacked experts over a ``model``-4 mesh
    against JAX's expert-parallel run and the replicated port, at JAX's
    tolerances (rtol 1e-5, atol 1e-6; aux rtol 1e-6)."""
    jcfg = JaxMoEConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    jp = jax_moe_init(jax.random.key(0), 16, 32, jcfg)
    x = np.random.default_rng(0).normal(size=(2, 12, 16)).astype(np.float32)
    jmesh = jax_make_mesh(4, axis_names=("model",))
    want_y, want_aux = jax.jit(lambda p, x: jax_moe_apply(p, x, jcfg))(
        jtp.shard_params_tp(jp, jmesh, axis="model"), jnp.asarray(x))
    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    p = port(jp)
    assert ttp.transformer_tp_spec("blocks/0/mlp/w_gate", p["w_gate"]) == \
        PartitionSpec("model", None, None)
    assert ttp.transformer_tp_spec("blocks/0/mlp/router", p["router"]) == PartitionSpec()
    mesh = make_mesh(4, axis_names=("model",), devices=[CPU] * 4)
    p_ep = ttp.shard_params_tp(p, mesh, axis="model")
    assert ttp.is_sharded(p_ep["w_down"]) and not ttp.is_sharded(p_ep["router"])
    y_ep, aux_ep = moe_apply(p_ep, torch.from_numpy(x), cfg)
    y_rep, aux_rep = moe_apply(p, torch.from_numpy(x), cfg)
    for got in ((y_ep, aux_ep), (y_rep, aux_rep)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(y_ep.numpy(), y_rep.numpy(), rtol=1e-5, atol=1e-6)


def test_each_shard_attends_over_its_own_heads(monkeypatch):
    """A Llama whose heads divide the shards (8/4 heads over 2 and 4): each
    shard's attention call sees its own ``Hq/m`` and ``Hkv/m`` heads, and
    the loss and gradients equal the replicated port's (1e-6 loss; the
    gradients at JAX's TP-against-replicated tolerance, rtol 2e-4 / atol
    1e-5: the row-parallel sums reassociate)."""
    cfg = LlamaConfig.tiny(max_len=8, d_model=64, n_heads=8, n_kv_heads=4)
    model_calls = []

    def noting(q, k, v, bias=None, causal=False):
        model_calls.append((q.shape[1], k.shape[1]))
        return tt.dot_product_attention(q, k, v, bias=bias, causal=causal)

    model = llama_lm_model(cfg, attention_fn=noting)
    params = model.init(torch.Generator().manual_seed(0))
    batch = to_torch(_tokens(cfg, 3, seed=2))
    batch = {k: v.long() for k, v in batch.items()}

    def loss(p):
        return model.per_example_loss(p, batch).mean()

    rep_g, rep_l = torch.func.grad_and_value(loss)(params)
    for m in (2, 4):
        model_calls.clear()
        tp_params = ttp.shard_params_tp(params, _mesh(2, m))
        got_g, got_l = torch.func.grad_and_value(loss)(tp_params)
        assert model_calls == [(8 // m, 4 // m)] * (m * cfg.n_layers)
        np.testing.assert_allclose(float(got_l), float(rep_l), rtol=1e-6)
        for name, g in _whole(got_g).items():
            np.testing.assert_allclose(g.numpy(), rep_g[name].numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("m", [2, 4])
def test_bert_mlp_bias_once_and_the_vocab_fallback(m):
    """BERT with 32,000 + 522 ids' worth of vocab (30,522 rows, as BERT-base):
    on 2 shards ``tok_emb`` is vocab-parallel, on 4 it falls back to
    replicated; ``b1`` rides ``w1``'s columns and ``b2`` is added once. The
    logits equal the replicated model's (1e-5)."""
    cfg = BertConfig.tiny(vocab_size=30522, d_model=32, n_heads=4, d_ff=64)
    model = bert_classifier_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    params = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
              if k.endswith(("b1", "b2")) else v for k, v in params.items()}
    rng = np.random.default_rng(3)
    batch = {"x": torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, cfg.max_len))),
             "attn_mask": torch.ones(3, cfg.max_len), "y": torch.zeros(3, dtype=torch.long)}
    batch["attn_mask"][:, -3:] = 0
    tp_params = ttp.shard_params_tp(params, _mesh(2, m))
    assert ttp.is_sharded(tp_params["tok_emb"]) == (m == 2)
    assert ttp.is_sharded(tp_params["blocks/0/mlp/b1"])
    assert not ttp.is_sharded(tp_params["blocks/0/mlp/b2"])
    np.testing.assert_allclose(model.apply(tp_params, batch).detach().numpy(),
                               model.apply(params, batch).detach().numpy(), rtol=1e-5, atol=1e-6)


def test_lora_merge_shard_by_shard():
    """``merge_lora`` of a placed base: each shard of ``wq`` (column) and
    ``wo`` (row) gets its slice of ``s·A@B``, equal to the whole merge."""
    model = lora_wrap(llama_lm_model(LlamaConfig.tiny()), rank=4, target=llama_lora_target)
    params = model.init(torch.Generator().manual_seed(0))
    params = {k: v + 0.05 * torch.ones_like(v) if k.endswith("/b") else v
              for k, v in params.items()}
    placed = ttp.shard_params_tp(params, _mesh(1, 4))
    assert not ttp.is_sharded(placed["lora/blocks/0/attn/wq/a"])
    got, want = merge_lora(placed, 8.0, 4), merge_lora(params, 8.0, 4)
    for name in ("blocks/0/attn/wq", "blocks/0/attn/wo", "blocks/1/attn/wk"):
        assert ttp.is_sharded(got[name])
        np.testing.assert_allclose(got[name].gather().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_remat_carries_placed_leaves():
    """Remat over blocks whose params are placed: loss and gradients equal
    those without remat (1e-6)."""
    cfg = LlamaConfig.tiny(max_len=8, n_heads=4, n_kv_heads=4)
    params = llama_lm_model(cfg).init(torch.Generator().manual_seed(0))
    batch = {k: v.long() for k, v in to_torch(_tokens(cfg, 2, seed=5)).items()}
    tp_params = ttp.shard_params_tp(params, _mesh(1, 2))
    out = []
    for remat in (False, True):
        model = llama_lm_model(cfg, remat=remat)
        out.append(torch.func.grad_and_value(
            lambda p: model.per_example_loss(p, batch).mean())(tp_params))
    np.testing.assert_allclose(float(out[1][1]), float(out[0][1]), rtol=1e-6)
    for name, g in _whole(out[1][0]).items():
        np.testing.assert_allclose(g.numpy(), _whole(out[0][0])[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_weights_bridge_gathers_and_places():
    """``params_to_state_dict`` gathers placed leaves; ``state_dict_to_params``
    with a mesh places them again by the table (JAX's params carried in)."""
    jparams = jax_llama(JaxLlamaConfig.tiny()).init(jax.random.key(0))
    state = jax_to_state(jparams)
    params = port(jparams)
    mesh = _mesh(2, 2)
    placed = state_dict_to_params(params, state, mesh=mesh)
    assert placed["blocks/0/attn/wq"].spec == PartitionSpec(None, "model")
    assert placed["tok_emb"].spec == PartitionSpec("model", None)
    back = params_to_state_dict(placed)
    assert set(back) == set(state)
    for name in state:
        np.testing.assert_array_equal(back[name], state[name])
    again = state_dict_to_params(placed, back, device="cpu")  # a placed template
    assert all(torch.equal(again[k], params[k]) for k in params)


def test_a_spec_over_the_clients_axis_is_not_a_param_layout():
    """A custom spec that splits a param over ``clients`` raises ValueError."""
    with pytest.raises(ValueError, match="split over one dim along the 'model'"):
        ttp.shard_params_tp({"w": torch.zeros(4, 4)}, _mesh(2, 2),
                            spec_fn=lambda path, leaf, axis: PartitionSpec("clients", None))
    jmesh = jax_hybrid_mesh([("model", 4)], dcn_axis="clients")
    assert jtp.leaf_tp_sharding("attn/wq", jnp.zeros((8, 8)), jmesh) == JaxNamedSharding(
        jmesh, P(None, "model"))
    assert ttp.leaf_tp_sharding("attn/wq", torch.zeros(8, 8), _mesh(2, 4)).spec == \
        PartitionSpec(None, "model")
