"""FedSim on a hybrid ``("clients", "model")`` mesh in the port
(``baton_tpu_torch/parallel/engine.py`` with the frozen base placed over
``model``), on CPU shards, against the JAX package's hybrid FedSim on 8
virtual devices and against the port's own meshless round.

The cases of ``tests/test_hybrid_tp.py`` and of
``tests/test_mesh_equivalence.py::test_hybrid_round_semantic_guardrail``:
the frozen base comes back placed (``wq`` column-parallel over ``model``,
``wo`` row-parallel, the adapters replicated), and the hybrid round lies
in the reference's 5e-2 band of the 1-D clients mesh's. Then, tighter: the
port's hybrid round against JAX's hybrid round on JAX's params and
shuffles (1e-4), and against the port's meshless round (1e-4) on 4 x 2
and 2 x 4 shards (the latter with the kv heads split inside); a BERT with
its encoder frozen (the trainable-head variant: ``b1`` split, ``b2`` once,
the vocab split on 2 shards) against JAX; a LoRA Llama-MoE with its
experts over ``model``; DP-SGD with noise, the fused rounds, the wave
sizer's unit, evaluation and a second round fed the first's placed
params, each against meshless; the robust aggregators refused with JAX's
reason; and a mesh whose ``model`` axis crosses processes refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from baton_tpu.models.llama import llama_lm_model as jax_llama
from baton_tpu.models.llama import llama_lora_target as jax_target
from baton_tpu.models.lora import lora_trainable as jax_lora_trainable
from baton_tpu.models.lora import lora_wrap as jax_lora_wrap
from baton_tpu.parallel.engine import FedSim as JaxFedSim
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model, llama_lora_target
from baton_tpu_torch.models.lora import lora_trainable, lora_wrap
from baton_tpu_torch.models.moe import MoEConfig
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import DPConfig
from baton_tpu_torch.parallel import tensor_parallel as ttp
from baton_tpu_torch.parallel.engine import FedSim
from baton_tpu_torch.parallel.mesh import Mesh, make_mesh
from baton_tpu_torch.parallel.partition import PartitionSpec
from baton_tpu_torch.server.state import params_to_state_dict
from _torch_variants import BAND, round_perms
from _torch_zoo import close, port, to_jax

torch.set_num_threads(1)

CPU = torch.device("cpu")
KW = dict(batch_size=4, learning_rate=0.05, trainable=lora_trainable)


def _hybrid(c=4, m=2):
    return Mesh(np.array([[CPU] * m] * c, dtype=object), ("clients", "model"))


def _jax_hybrid(c=4, m=2):
    return jax.sharding.Mesh(np.asarray(jax.devices()[: c * m]).reshape(c, m),
                             ("clients", "model"))


def _cohort(vocab, max_len, n_clients=8, seed=0):
    """``tests/test_hybrid_tp.py``'s cohort: 3-6 sequences a client."""
    rng = np.random.default_rng(seed)
    datasets = []
    for _ in range(n_clients):
        n = int(rng.integers(3, 7))
        toks = rng.integers(0, vocab, size=(n, max_len)).astype(np.int32)
        datasets.append({"x": toks, "y": toks})
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    return {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(n_samples)


def _tiny_lora(n_heads=4, n_kv_heads=2, moe=None):
    cfg = LlamaConfig.tiny(max_len=16, d_model=64, n_heads=n_heads, n_kv_heads=n_kv_heads,
                           d_ff=128, moe=moe)
    model = lora_wrap(llama_lm_model(cfg), rank=4, target=llama_lora_target)
    params = model.init(torch.Generator().manual_seed(0))
    # nonzero adapters: at init B is zeros and the merge adds nothing
    gen = torch.Generator().manual_seed(1)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen) if k.startswith("lora/") else v
              for k, v in params.items()}
    data, n_samples = _cohort(cfg.vocab_size, cfg.max_len)
    return model, params, data, n_samples


def _perms(data, n_samples, n_epochs=1, seed=1):
    return round_perms(jax.random.key(seed), len(n_samples), n_epochs, data["x"].shape[1])


def _whole(params):
    return {k: v.gather() if ttp.is_sharded(v) else v for k, v in params.items()}


def _close_params(got, want, tol):
    got, want = _whole(got), _whole(want)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol, msg=k)


def test_hybrid_base_stays_tp_sharded():
    """The frozen base in the merged output keeps the Megatron layout: wq
    column-parallel over ``model``, wo row-parallel; the adapters, the
    global trainable state, are plain (replicated) tensors."""
    model, params, data, n_samples = _tiny_lora()
    sim = FedSim(model, mesh=_hybrid(4, 2), **KW)
    assert sim.is_hybrid and sim.partition_rule_set == "transformer-tp"
    assert sim._clients_per_wave_unit() == 4
    res = sim.run_round(params, data, n_samples, perms=_perms(data, n_samples))
    wq, wo = res.params["base/blocks/0/attn/wq"], res.params["base/blocks/0/attn/wo"]
    assert ttp.is_sharded(wq) and wq.spec == PartitionSpec(None, "model")
    assert wo.spec == PartitionSpec("model", None) and wo.axis == "model"
    assert res.params["base/tok_emb"].spec == PartitionSpec("model", None)
    assert all(not ttp.is_sharded(v) for k, v in res.params.items() if k.startswith("lora/"))
    # the base is placed as views of the caller's tensors: nothing copied
    assert wq.shards[1].untyped_storage().data_ptr() == \
        params["base/blocks/0/attn/wq"].untyped_storage().data_ptr()
    assert all(torch.equal(_whole(res.params)[k], v) for k, v in params.items()
               if k.startswith("base/"))


def test_hybrid_round_semantic_guardrail():
    """The hybrid round against the 1-D clients mesh's: identical math in
    two layouts, within the reference's 5e-2 band (params and losses)."""
    model, params, data, n_samples = _tiny_lora()
    perms = _perms(data, n_samples)
    res_1d = FedSim(model, mesh=make_mesh(8, devices=[CPU] * 8), **KW).run_round(
        params, data, n_samples, perms=perms)
    res_h = FedSim(model, mesh=_hybrid(4, 2), **KW).run_round(params, data, n_samples,
                                                               perms=perms)
    _close_params(res_h.params, res_1d.params, BAND)
    torch.testing.assert_close(res_h.loss_history, res_1d.loss_history, rtol=BAND, atol=0)


def test_hybrid_round_against_jax_hybrid_round():
    """The port's hybrid round on 4 x 2 CPU shards against JAX's hybrid
    FedSim on 4 x 2 virtual devices: JAX's params carried over, JAX's
    shuffles injected; params and losses within 1e-4."""
    jcfg = JaxLlamaConfig.tiny(max_len=16, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    jmodel = jax_lora_wrap(jax_llama(jcfg), rank=4, target=jax_target)
    jparams = jmodel.init(jax.random.key(0))
    data, n_samples = _cohort(jcfg.vocab_size, jcfg.max_len)
    key = jax.random.key(1)
    jres = JaxFedSim(jmodel, batch_size=4, learning_rate=0.05, trainable=jax_lora_trainable,
                     mesh=_jax_hybrid(4, 2)).run_round(
        jparams, to_jax(data), jnp.asarray(n_samples), key, n_epochs=1)
    cfg = LlamaConfig.tiny(max_len=16, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    model = lora_wrap(llama_lm_model(cfg), rank=4, target=llama_lora_target)
    res = FedSim(model, mesh=_hybrid(4, 2), **KW).run_round(
        port(jparams), data, n_samples, perms=round_perms(key, 8, 1, data["x"].shape[1]))
    close(res.loss_history, jres.loss_history, 1e-4, "loss history")
    got, want = params_to_state_dict(res.params), jax_to_state(jres.params)
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name], 1e-4, name)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 2)], ids=["4x2", "2x4", "1x2"])
def test_hybrid_round_against_meshless(shape):
    """The hybrid round against the port's meshless round on the same
    params and shuffles (1e-4): on 2 x 4 the kv heads' shard edges fall
    inside a head (the gathered path), on 4 x 2 each shard has its own."""
    model, params, data, n_samples = _tiny_lora()
    perms = _perms(data, n_samples, n_epochs=2)
    want = FedSim(model, device="cpu", **KW).run_round(params, data, n_samples, n_epochs=2,
                                                       perms=perms)
    got = FedSim(model, mesh=_hybrid(*shape), **KW).run_round(params, data, n_samples,
                                                              n_epochs=2, perms=perms)
    _close_params(got.params, want.params, 1e-4)
    torch.testing.assert_close(got.loss_history, want.loss_history, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.client_losses, want.client_losses, rtol=1e-4, atol=1e-4)


def test_a_second_round_takes_the_first_rounds_placed_params():
    """Round 2 on a hybrid mesh from round 1's result (its base placed)
    equals two meshless rounds (1e-4); nothing is placed again."""
    model, params, data, n_samples = _tiny_lora()
    perms = _perms(data, n_samples)
    plain, hybrid = FedSim(model, device="cpu", **KW), FedSim(model, mesh=_hybrid(), **KW)
    p_plain, p_hybrid = params, params
    for _ in range(2):
        p_plain = plain.run_round(p_plain, data, n_samples, perms=perms).params
        out = hybrid.run_round(p_hybrid, data, n_samples, perms=perms).params
        if p_hybrid is not params:
            assert out["base/blocks/1/mlp/w_down"] is p_hybrid["base/blocks/1/mlp/w_down"]
        p_hybrid = out
    _close_params(p_hybrid, p_plain, 1e-4)


def test_bert_with_a_frozen_encoder_against_jax():
    """BERT with its encoder frozen (the trainable-head variant of config
    3: ``pooler/*`` and ``head/*`` train) on a 2 x 2 hybrid mesh, its vocab
    of 30,522 split over 2 shards, ``b1`` split and ``b2`` added once,
    against JAX's meshless round on the same weights and shuffles (1e-4)."""
    def head(path, leaf):
        return path.startswith(("pooler", "head"))

    jcfg = JaxBertConfig.tiny(vocab_size=30522)
    jmodel = jax_bert(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(2)
    datasets = [{"x": rng.integers(0, 30522, (n, jcfg.max_len)).astype(np.int32),
                 "attn_mask": np.ones((n, jcfg.max_len), np.float32),
                 "y": rng.integers(0, jcfg.n_classes, n).astype(np.int32)} for n in (5, 3, 8, 6)]
    data, n_samples = stack_client_datasets(datasets, batch_size=4)
    key = jax.random.key(3)
    jres = JaxFedSim(jmodel, batch_size=4, learning_rate=0.1, trainable=head).run_round(
        jparams, to_jax(data), jnp.asarray(n_samples), key, n_epochs=1)
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    sim = FedSim(bert_classifier_model(BertConfig.tiny(vocab_size=30522)), batch_size=4,
                 learning_rate=0.1, trainable=head, mesh=_hybrid(2, 2))
    res = sim.run_round(port(jparams), data, torch.from_numpy(n_samples),
                        perms=round_perms(key, 4, 1, data["x"].shape[1]))
    assert res.params["tok_emb"].spec == PartitionSpec("model", None)
    assert res.params["blocks/0/mlp/b1"].spec == PartitionSpec("model")
    assert not ttp.is_sharded(res.params["blocks/0/mlp/b2"])
    close(res.loss_history, jres.loss_history, 1e-4, "loss history")
    got, want = params_to_state_dict(res.params), jax_to_state(jres.params)
    for name in want:
        close(got[name], want[name], 1e-4, name)


def test_lora_llama_moe_with_experts_over_model():
    """A LoRA Llama-MoE (4 experts over a 2-shard model axis, the router
    replicated, tokens dropped at capacity 1.0) hybrid against meshless."""
    model, params, data, n_samples = _tiny_lora(moe=MoEConfig(4, 2, capacity_factor=1.0))
    perms = _perms(data, n_samples)
    want = FedSim(model, device="cpu", **KW).run_round(params, data, n_samples, perms=perms)
    got = FedSim(model, mesh=_hybrid(4, 2), **KW).run_round(params, data, n_samples,
                                                             perms=perms)
    assert got.params["base/blocks/0/mlp/w_gate"].spec == PartitionSpec("model", None, None)
    assert not ttp.is_sharded(got.params["base/blocks/0/mlp/router"])
    _close_params(got.params, want.params, 1e-4)


def test_dp_with_noise_on_a_hybrid_mesh():
    """DP-SGD with noise: each client gets the noise it gets meshless (the
    noise touches the adapters only), params within 1e-5."""
    model, params, data, n_samples = _tiny_lora()
    perms = _perms(data, n_samples)
    kw = dict(KW, dp=DPConfig(clip_norm=1.0, noise_multiplier=0.5))
    want = FedSim(model, device="cpu", **kw).run_round(
        params, data, n_samples, torch.Generator().manual_seed(4), perms=perms)
    got = FedSim(model, mesh=_hybrid(4, 2), **kw).run_round(
        params, data, n_samples, torch.Generator().manual_seed(4), perms=perms)
    _close_params(got.params, want.params, 1e-5)


def test_fused_rounds_evaluation_and_waves_on_a_hybrid_mesh():
    """``run_rounds_fused`` (the CPU loop) against ``run_rounds`` meshless;
    ``evaluate_round`` / ``evaluate_clients`` of the placed result against
    meshless; ``wave_size`` rounded up to the clients extent; the wave
    sizer answers None off the card."""
    model, params, data, n_samples = _tiny_lora()
    gen = torch.Generator().manual_seed(6)
    plain, hybrid = FedSim(model, device="cpu", **KW), FedSim(model, mesh=_hybrid(4, 2), **KW)
    want, want_hist = plain.run_rounds(params, data, n_samples, gen, n_rounds=2)
    got, got_hist = hybrid.run_rounds_fused(params, data, n_samples, gen, n_rounds=2)
    assert hybrid.last_fused == {"graph": False, "rounds": 2}
    assert ttp.is_sharded(got["base/blocks/0/attn/wq"])
    _close_params(got, want, 1e-4)
    np.testing.assert_allclose(got_hist, want_hist, rtol=1e-4, atol=1e-4)
    ev_h, ev_p = hybrid.evaluate_round(got, data, n_samples), plain.evaluate_round(want, data,
                                                                                   n_samples)
    assert ev_h["n"] == ev_p["n"] and abs(ev_h["loss"] - ev_p["loss"]) < 1e-4
    cl_h = hybrid.evaluate_clients(got, data, n_samples, wave_size=3)
    cl_p = plain.evaluate_clients(want, data, n_samples)
    np.testing.assert_allclose(cl_h["per_client"]["loss"], cl_p["per_client"]["loss"],
                               rtol=1e-4, atol=1e-4)
    waved = hybrid.run_round(params, data, n_samples, perms=_perms(data, n_samples),
                             wave_size=3)  # rounded up to 4, the clients extent
    full = plain.run_round(params, data, n_samples, perms=_perms(data, n_samples))
    _close_params(waved.params, full.params, 1e-4)
    assert hybrid.auto_wave_size(params, data, n_samples) is None


def test_robust_aggregators_are_refused_on_a_hybrid_mesh():
    """JAX's refusal: a robust rule needs per-client params stacked along
    the client axis, and the hybrid mesh shards params over ``model``."""
    model, params, data, n_samples = _tiny_lora()
    for rule in ("median", "trimmed:0.1"):
        sim = FedSim(model, mesh=_hybrid(4, 2), aggregator=rule, **KW)
        with pytest.raises(NotImplementedError, match="pure clients mesh"):
            sim.run_round(params, data, n_samples, perms=_perms(data, n_samples))


def test_a_model_axis_across_processes_is_refused():
    """A hand-made mesh whose ``model`` axis spans two processes raises
    ValueError; one whose ``clients`` axis does is accepted."""
    model = _tiny_lora()[0]
    devices = np.array([[CPU] * 2] * 2, dtype=object)
    across = Mesh(devices, ("clients", "model"), process_ids=[[0, 1], [0, 1]])
    with pytest.raises(ValueError, match="'model' axis of the mesh crosses processes"):
        FedSim(model, mesh=across, **KW)
    along = Mesh(devices, ("clients", "model"), process_ids=[[0, 0], [1, 1]])
    assert FedSim(model, mesh=along, **KW).is_hybrid
