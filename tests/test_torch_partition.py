"""The port's declarative partition layer (``baton_tpu_torch/parallel/
partition.py``) against the JAX package's (``baton_tpu/parallel/
partition.py``): the same spec for every leaf of BERT-tiny, Llama-tiny,
MoE-tiny and ResNet-tiny params under each default table (exact, as
strings and tuples), the unmatched-leaf counter, the non-divisible
fallback, ``kernel_specs`` entry by entry; the cases of
``tests/test_partition_rules.py`` and of ``tests/test_tensor_parallel.py``'s
``test_spec_rules`` / ``test_nondivisible_falls_back_to_replicated``
against the port; the rule that no ``PartitionSpec`` is built outside
``partition.py`` in ``baton_tpu_torch/``; and the cases of
``tests/test_partition.py`` (the data partitioners' exact cover and skew)
against ``baton_tpu_torch/data/partition.py``."""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from baton_tpu.parallel import partition as jp
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    label_shard_partition,
    partition_stats,
)
from baton_tpu_torch.parallel import partition as tp
from baton_tpu_torch.parallel.mesh import Mesh, device_put, make_mesh
from baton_tpu_torch.parallel.multihost import make_hybrid_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _jax_params(name):
    from baton_tpu.models.bert import BertConfig, bert_classifier_model
    from baton_tpu.models.llama import LlamaConfig, llama_lm_model
    from baton_tpu.models.moe import MoEConfig
    from baton_tpu.models.resnet import resnet_model

    model = {
        "bert_tiny": lambda: bert_classifier_model(BertConfig.tiny()),
        "llama_tiny": lambda: llama_lm_model(LlamaConfig.tiny()),
        "moe_tiny": lambda: llama_lm_model(LlamaConfig.tiny(moe=MoEConfig(4, 2))),
        "resnet_tiny": lambda: resnet_model(blocks_per_stage=(1, 1), n_groups=8),
    }[name]()
    return model.init(jax.random.key(0))


def _port_params(name):
    from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
    from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
    from baton_tpu_torch.models.moe import MoEConfig
    from baton_tpu_torch.models.resnet import resnet_model

    model = {
        "bert_tiny": lambda: bert_classifier_model(BertConfig.tiny()),
        "llama_tiny": lambda: llama_lm_model(LlamaConfig.tiny()),
        "moe_tiny": lambda: llama_lm_model(LlamaConfig.tiny(moe=MoEConfig(4, 2))),
        "resnet_tiny": lambda: resnet_model(blocks_per_stage=(1, 1), n_groups=8),
    }[name]()
    return model.init(torch.Generator().manual_seed(0))


MODELS = ["bert_tiny", "llama_tiny", "moe_tiny", "resnet_tiny"]
TABLES = ["transformer-tp", "client-stacked", "replicated"]


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("model", MODELS)
def test_every_leaf_gets_the_jax_tables_spec(model, table):
    """The port's params carry the JAX params' paths and shapes, and each
    leaf gets the JAX table's spec, before and after the divisibility
    fallback on a mesh (a hybrid 2 x 4 mesh, and for the tables that name
    no model axis an 8-way clients mesh)."""
    jparams = _jax_params(model)
    want = jax_to_state(jparams)
    got = _port_params(model)
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(np.shape(w)) for k, w in want.items())
    jrules, trules = jp.DEFAULT_RULE_SETS[table](), tp.DEFAULT_RULE_SETS[table]()
    jp.reset_unmatched_leaf_count()
    tp.reset_unmatched_leaf_count()
    assert trules.describe(got) == jrules.describe(jparams)
    jspecs = jax_to_state(jax.tree_util.tree_map(
        lambda s: np.asarray(tuple(s), dtype=object), jrules.tree_specs(jparams),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    for name, spec in trules.tree_specs(got).items():
        assert isinstance(spec, tp.PartitionSpec)
        assert spec == tuple(jspecs[name]), name
    jmeshes = {"hybrid": jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                                           ("clients", "model")),
               "clients": jax.sharding.Mesh(np.array(jax.devices()[:8]), ("clients",))}
    tmeshes = {"hybrid": make_hybrid_mesh([("model", 4)], devices=[CPU] * 8),
               "clients": make_mesh(8, devices=[CPU] * 8)}
    for mesh_name, jmesh in jmeshes.items():
        if table == "transformer-tp" and mesh_name == "clients":
            continue  # the table names the model axis, which that mesh lacks
        assert trules.describe(got, tmeshes[mesh_name]) == jrules.describe(jparams, jmesh)
    assert tp.unmatched_leaf_count() == jp.unmatched_leaf_count() == 0


def test_kernel_specs_entry_by_entry():
    names = ["engine.wave_sums", "engine.wave_params", "fedbuff.train", "clustered.round",
             "stateful.round", "personalization.round"]
    for name in names:
        for axis in ("clients", "workers"):
            jins, jouts = jp.kernel_specs(name, axis=axis)
            tins, touts = tp.kernel_specs(name, axis=axis)
            assert [tuple(s) for s in tins] == [tuple(s) for s in jins], name
            assert [tuple(s) for s in touts] == [tuple(s) for s in jouts], name
            assert [str(s) for s in tins + touts] == [str(s) for s in jins + jouts]
    with pytest.raises(KeyError):
        tp.kernel_specs("engine.nothing")


def test_spec_helpers_print_and_compare_as_jaxs():
    P = jax.sharding.PartitionSpec
    pairs = [(tp.replicated_spec(), jp.replicated_spec()), (tp.client_spec(), jp.client_spec()),
             (tp.waved_client_spec(), jp.waved_client_spec()),
             (tp.dim_spec("seq", 2, 4), jp.dim_spec("seq", 2, 4)),
             (tp.axes_spec(None, "model"), jp.axes_spec(None, "model"))]
    for got, want in pairs:
        assert str(got) == str(want) and tuple(got) == tuple(want)
    assert tp.CLIENT_AXIS == jp.CLIENT_AXIS and tp.MODEL_AXIS == jp.MODEL_AXIS
    assert tp.client_spec() == tp.PartitionSpec("clients") != tp.replicated_spec()
    assert str(P("a", None)) == str(tp.PartitionSpec("a", None))
    with pytest.raises(ValueError):
        tp.dim_spec("seq", 4, 4)


# ---------------------------------------------------------------------------
# the cases of tests/test_partition_rules.py, against the port


def test_first_match_wins_ordering():
    leaf = torch.zeros(8, 4)
    broad = tp.Rule(r"w", tp.PartitionSpec(tp.MODEL_AXIS, None))
    narrow = tp.Rule(r"(^|/)w1$", tp.PartitionSpec(None, tp.MODEL_AXIS))
    assert tp.RuleSet("broad-first", (broad, narrow)).spec_for(
        "blk/w1", leaf) == tp.PartitionSpec(tp.MODEL_AXIS, None)
    assert tp.RuleSet("narrow-first", (narrow, broad)).spec_for(
        "blk/w1", leaf) == tp.PartitionSpec(None, tp.MODEL_AXIS)


def test_ndim_constraint_disambiguates_same_name():
    rs = tp.transformer_rules()
    assert rs.spec_for("moe/w_gate", torch.zeros(4, 8, 16)) == tp.PartitionSpec(
        tp.MODEL_AXIS, None, None)
    assert rs.spec_for("moe/w_gate", torch.zeros(8, 16)) == tp.PartitionSpec(None, tp.MODEL_AXIS)


def test_unmatched_leaf_falls_back_replicated_and_counts():
    rs = tp.RuleSet("partial", (tp.Rule(r"(^|/)w$", tp.PartitionSpec(tp.CLIENT_AXIS)),))
    tp.reset_unmatched_leaf_count()
    specs = rs.tree_specs({"w": torch.zeros(8, 2), "stray": torch.zeros(8),
                           "step": torch.zeros(())})
    assert specs["w"] == tp.PartitionSpec(tp.CLIENT_AXIS)
    assert specs["stray"] == tp.replicated_spec()
    assert specs["step"] == tp.replicated_spec()
    assert tp.unmatched_leaf_count() == 1  # stray only; the scalar is free
    tp.reset_unmatched_leaf_count()
    assert tp.unmatched_leaf_count() == 0


def test_default_tables_cover_model_zoo_params():
    params = _port_params("llama_tiny")
    tp.reset_unmatched_leaf_count()
    for make in tp.DEFAULT_RULE_SETS.values():
        make().tree_specs(params)
    assert tp.unmatched_leaf_count() == 0


def test_transformer_rules_over_nested_and_lora_paths():
    rs = tp.transformer_rules()
    tree = {
        "blocks": {"b0": {"attn": {"wq": torch.zeros(8, 8)},
                          "mlp": {"w1": torch.zeros(8, 16), "w2": torch.zeros(16, 8)},
                          "lora": {"wq": {"a": torch.zeros(8, 4), "b": torch.zeros(4, 8)}}}},
        "tok_emb": torch.zeros(64, 8),
    }
    tp.reset_unmatched_leaf_count()
    d = rs.describe(tree)
    assert d["blocks/b0/attn/wq"] == str(tp.PartitionSpec(None, tp.MODEL_AXIS))
    assert d["blocks/b0/mlp/w1"] == str(tp.PartitionSpec(None, tp.MODEL_AXIS))
    assert d["blocks/b0/mlp/w2"] == str(tp.PartitionSpec(tp.MODEL_AXIS, None))
    assert d["tok_emb"] == str(tp.PartitionSpec(tp.MODEL_AXIS, None))
    assert d["blocks/b0/lora/wq/a"] == d["blocks/b0/lora/wq/b"] == str(tp.replicated_spec())
    assert tp.unmatched_leaf_count() == 0
    # the same paths as a flat dict, the port's param layout
    flat = {"blocks/b0/attn/wq": torch.zeros(8, 8), "tok_emb": torch.zeros(64, 8)}
    assert rs.describe(flat) == {k: d[k] for k in flat}


def test_match_partition_rules_entry_point():
    params = {"enc": {"kernel": torch.zeros(8, 8), "bias": torch.zeros(8)},
              "head": {"kernel": torch.zeros(8, 2)}}
    specs = tp.match_partition_rules(
        [(r"head/kernel", tp.PartitionSpec(None, tp.MODEL_AXIS)),
         (r"kernel", tp.PartitionSpec(tp.MODEL_AXIS, None)),
         (r".*", tp.PartitionSpec())], params)
    assert specs["head"]["kernel"] == tp.PartitionSpec(None, tp.MODEL_AXIS)
    assert specs["enc"]["kernel"] == tp.PartitionSpec(tp.MODEL_AXIS, None)
    assert specs["enc"]["bias"] == tp.PartitionSpec()


def test_place_round_trip_on_one_and_four_shards():
    """``place`` gives each leaf its per-shard tensors: on a 1-shard mesh
    the values whole, on 4 shards dim 0 in four equal slices in shard
    order; a replicated leaf one copy a device."""
    params = {"w": torch.arange(24, dtype=torch.float32).reshape(8, 3), "b": torch.ones(8)}
    one = tp.client_stacked_rules().place(params, make_mesh(1, devices=[CPU]))
    for k in params:
        assert len(one[k]) == 1 and torch.equal(one[k][0], params[k])
    four = tp.client_stacked_rules().place(params, make_mesh(4, devices=[CPU] * 4))
    for k in params:
        assert [t.shape[0] for t in four[k]] == [2] * 4
        assert torch.equal(torch.cat(four[k]), params[k])
    rep = tp.replicated_rules().place(params, make_mesh(4, devices=[CPU] * 4))
    assert all(len(v) == 4 and all(torch.equal(t, params[k]) for t in v) for k, v in rep.items())
    shardings = tp.client_stacked_rules().shardings(params, make_mesh(4, devices=[CPU] * 4))
    assert all(s.spec == tp.client_spec() for s in shardings.values())


def test_indivisible_leaf_falls_back_replicated_on_mesh():
    rs = tp.client_stacked_rules()
    odd = torch.zeros(6, 3)
    assert rs.leaf_sharding("odd", odd, make_mesh(8, devices=[CPU] * 8)).spec == \
        tp.replicated_spec()
    assert rs.leaf_sharding("odd", odd, make_mesh(2, devices=[CPU] * 2)).spec == \
        tp.PartitionSpec(tp.CLIENT_AXIS)
    with pytest.raises(ValueError, match="does not split"):
        device_put(odd, tp.NamedSharding(make_mesh(4, devices=[CPU] * 4), tp.client_spec()))


def test_a_spec_over_two_axes_is_the_next_slice():
    mesh = Mesh(np.array([[CPU] * 2] * 2, dtype=object), ("clients", "model"))
    with pytest.raises(NotImplementedError, match="next slice"):
        device_put(torch.zeros(4, 4), tp.NamedSharding(mesh, tp.PartitionSpec("clients", "model")))


# tests/test_tensor_parallel.py's rule cases, through the port's table


def test_spec_rules():
    rs = tp.transformer_rules()
    w2 = torch.zeros(8, 8)
    assert rs.spec_for("blocks/0/attn/wq", w2) == tp.PartitionSpec(None, "model")
    assert rs.spec_for("blocks/0/attn/wo", w2) == tp.PartitionSpec("model", None)
    assert rs.spec_for("blocks/0/mlp/w_gate", w2) == tp.PartitionSpec(None, "model")
    assert rs.spec_for("blocks/0/mlp/w_down", w2) == tp.PartitionSpec("model", None)
    assert rs.spec_for("tok_emb", w2) == tp.PartitionSpec("model", None)
    assert rs.spec_for("lm_head", w2) == tp.PartitionSpec(None, "model")
    assert rs.spec_for("blocks/0/norm_attn/scale", torch.zeros(8)) == tp.PartitionSpec()
    assert rs.spec_for("mlp/b1", torch.zeros(8)) == tp.PartitionSpec("model")


def test_nondivisible_falls_back_to_replicated():
    mesh = make_hybrid_mesh([("model", 4)], dcn_axis="clients", devices=[CPU] * 8)
    sharding = tp.transformer_rules().leaf_sharding("attn/wq", torch.zeros(6, 6), mesh)
    assert sharding.spec == tp.replicated_spec()  # 6 % 4 != 0
    assert tp.transformer_rules().leaf_sharding("attn/wq", torch.zeros(8, 8), mesh).spec == \
        tp.PartitionSpec(None, "model")


def _partition_spec_calls(path: pathlib.Path):
    """Line of every PartitionSpec construction in a file: direct calls,
    attribute calls and any ``import ... as`` alias."""
    tree = ast.parse(path.read_text())
    aliases = {a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
               for a in node.names if a.name == "PartitionSpec"}
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if ((isinstance(f, ast.Name) and f.id in aliases | {"PartitionSpec"})
                or (isinstance(f, ast.Attribute) and f.attr == "PartitionSpec")):
            hits.append(node.lineno)
    return hits


def test_no_ad_hoc_partition_spec_outside_partition_module():
    pkg = ROOT / "baton_tpu_torch"
    offenders = []
    for py in sorted(pkg.rglob("*.py")):
        if py.relative_to(pkg).as_posix() == "parallel/partition.py":
            continue
        offenders += [f"{py.relative_to(pkg)}:{ln}" for ln in _partition_spec_calls(py)]
    offenders += [f"chip_smoke.py:{ln}" for ln in _partition_spec_calls(ROOT / "chip_smoke.py")]
    assert not offenders, f"PartitionSpec built outside parallel/partition.py: {offenders}"


# ---------------------------------------------------------------------------
# the cases of tests/test_partition.py, against baton_tpu_torch/data/partition.py


def _dataset(rng, n=500, n_classes=10):
    return {"x": rng.standard_normal((n, 8)).astype(np.float32),
            "y": rng.integers(0, n_classes, size=n).astype(np.int32),
            "row": np.arange(n, dtype=np.int64)}


def _assert_exact_cover(shards, n):
    rows = np.concatenate([s["row"] for s in shards])
    assert rows.shape[0] == n
    assert np.array_equal(np.sort(rows), np.arange(n))


def test_iid_partition_exact_cover(nprng):
    _assert_exact_cover(iid_partition(_dataset(nprng), 7, nprng), 500)


def test_dirichlet_partition_exact_cover(nprng):
    _assert_exact_cover(dirichlet_partition(_dataset(nprng), 8, nprng, alpha=0.5), 500)


def test_dirichlet_min_samples_rebalance_keeps_cover(nprng):
    data = _dataset(nprng, n=300)
    for seed in range(5):
        shards = dirichlet_partition(data, 12, np.random.default_rng(seed), alpha=0.05,
                                     min_samples=4)
        _assert_exact_cover(shards, 300)
        assert all(s["row"].shape[0] >= 4 for s in shards)


def test_dirichlet_is_more_skewed_than_iid(nprng):
    data = _dataset(nprng, n=2000)
    iid = iid_partition(data, 10, nprng)
    noniid = dirichlet_partition(data, 10, nprng, alpha=0.1)

    def mean_label_entropy(shards):
        ents = []
        for s in partition_stats(shards):
            p = np.asarray(list(s["labels"].values()), np.float64)
            p = p / p.sum()
            ents.append(-(p * np.log(p)).sum())
        return np.mean(ents)

    assert mean_label_entropy(noniid) < mean_label_entropy(iid) - 0.5


def test_label_shard_partition_is_pathological(nprng):
    n, k = 400, 10
    data = {"x": nprng.normal(size=(n, 4)).astype(np.float32),
            "y": nprng.integers(0, k, size=n).astype(np.int32)}
    shards = label_shard_partition(data, n_clients=10, rng=nprng, classes_per_client=2)
    assert len(shards) == 10
    all_x = np.concatenate([s["x"] for s in shards])
    assert all_x.shape[0] == n and len({tuple(r) for r in np.round(all_x, 6)}) == n
    n_labels = [len(np.unique(s["y"])) for s in shards]
    assert max(n_labels) <= 4 and np.mean(n_labels) <= 4.0
    with pytest.raises(ValueError):
        label_shard_partition(data, n_clients=300, rng=nprng, classes_per_client=2)
