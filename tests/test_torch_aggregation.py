"""The port's aggregation against numpy's reference formulas and the JAX
package's functions on the same stacked params: the robust rules with
even and odd client counts (an even count's median is the mean of the two
middle values), the spec parser, the zero-sample exclusion of
``aggregate_stacked``, the tree helpers, and the numpy streaming folds
(bit-equal to the JAX package's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.ops import aggregation as jagg
from baton_tpu_torch.ops import aggregation as agg

torch.set_num_threads(1)


def _stacked(c, seed=0):
    rng = np.random.default_rng(seed)
    return {"a/w": rng.normal(size=(c, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(c, 5)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("c", [4, 5, 6])
def test_coordinate_median_matches_numpy_and_jax(c):
    tree = _stacked(c)
    got = agg.coordinate_median(_t(tree))
    jgot = jagg.coordinate_median({k: jnp.asarray(v) for k, v in tree.items()})
    for k, v in tree.items():
        np.testing.assert_allclose(got[k].numpy(), np.median(v, axis=0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jgot[k]), rtol=1e-6, atol=1e-6)


def test_even_median_is_the_mean_of_the_two_middle_values():
    """torch.median would return the lower middle value (2.0 here)."""
    got = agg.coordinate_median({"x": torch.tensor([[1.0], [2.0], [4.0], [10.0]])})
    assert float(got["x"]) == 3.0


@pytest.mark.parametrize("c,ratio", [(6, 0.2), (5, 0.25), (4, 0.1), (2, 0.49)])
def test_trimmed_mean_matches_numpy_and_jax(c, ratio):
    tree = _stacked(c, seed=c)
    got = agg.trimmed_mean(_t(tree), ratio)
    jgot = jagg.trimmed_mean({k: jnp.asarray(v) for k, v in tree.items()}, ratio)
    k_trim = int(c * ratio)
    for k, v in tree.items():
        srt = np.sort(v, axis=0)
        want = srt[k_trim: c - k_trim].mean(axis=0)
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jgot[k]), rtol=1e-6, atol=1e-6)


def test_robust_rules_keep_the_leaf_dtype():
    tree = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16()}
    assert agg.coordinate_median(tree)["w"].dtype == torch.bfloat16
    assert agg.trimmed_mean(tree, 0.25)["w"].dtype == torch.bfloat16


def test_parse_aggregator():
    assert agg.parse_aggregator("mean") == ("mean",)
    assert agg.parse_aggregator("median") == ("median",)
    assert agg.parse_aggregator("trimmed:0.1") == ("trimmed", 0.1)
    for bad in ("trimmed:0.5", "trimmed:-0.1", "geomedian", "Mean"):
        with pytest.raises(ValueError):
            agg.parse_aggregator(bad)


@pytest.mark.parametrize("spec", ["mean", "median", "trimmed:0.25"])
def test_aggregate_stacked_matches_jax(spec):
    """Zero-sample clients are dropped before a robust combine; the mean
    weights by n_samples; the result takes ``like``'s dtypes."""
    tree = _stacked(6, seed=3)
    n = np.array([5, 0, 3, 0, 7, 2], np.int32)
    like = {k: v[0] for k, v in tree.items()}
    parsed = agg.parse_aggregator(spec)
    got = agg.aggregate_stacked(parsed, _t(tree), torch.from_numpy(n), _t(like))
    want = jagg.aggregate_stacked(jagg.parse_aggregator(spec),
                                  {k: jnp.asarray(v) for k, v in tree.items()},
                                  jnp.asarray(n), {k: jnp.asarray(v) for k, v in like.items()})
    for k, v in tree.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
        assert got[k].dtype == torch.float32
    if spec == "median":  # the four clients with samples: an even count
        kept = tree["b"][n > 0]
        np.testing.assert_allclose(got["b"].numpy(), np.median(kept, axis=0), rtol=1e-6)


def test_aggregate_stacked_keeps_everyone_when_nobody_has_samples():
    tree = _stacked(3, seed=4)
    got = agg.aggregate_stacked(("median",), _t(tree), torch.zeros(3, dtype=torch.int32),
                                {k: torch.from_numpy(v[0]) for k, v in tree.items()})
    np.testing.assert_allclose(got["b"].numpy(), np.median(tree["b"], axis=0), rtol=1e-6)


def test_weighted_means_match_the_reference_formula():
    tree = _stacked(4, seed=5)
    w = np.array([3, 0, 1, 6], np.float32)
    mean = agg.weighted_tree_mean(_t(tree), torch.from_numpy(w))
    for k, v in tree.items():
        want = np.tensordot(w.astype(np.float64), v.astype(np.float64), axes=(0, 0)) / w.sum()
        np.testing.assert_allclose(mean[k].numpy(), want, rtol=1e-6, atol=1e-6)
    losses = np.random.default_rng(5).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        agg.weighted_scalar_mean(torch.from_numpy(losses), torch.from_numpy(w)).numpy(),
        np.asarray(jagg.weighted_scalar_mean(jnp.asarray(losses), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    assert float(agg.weighted_scalar_mean(torch.ones(2, 1), torch.zeros(2))[0]) == 0.0


def test_tree_helpers_match_jax():
    a, b = _stacked(2, seed=6), _stacked(2, seed=7)
    ta, tb = _t(a), _t(b)
    ja, jb = ({k: jnp.asarray(v) for k, v in t.items()} for t in (a, b))
    pairs = [(agg.tree_add(ta, tb), jagg.tree_add(ja, jb)),
             (agg.tree_sub(ta, tb), jagg.tree_sub(ja, jb)),
             (agg.tree_scale(ta, 0.5), jagg.tree_scale(ja, 0.5)),
             (agg.tree_zeros_like(ta), jagg.tree_zeros_like(ja))]
    for got, want in pairs:
        for k in a:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(agg.global_sq_dist(ta, tb)),
                               float(jagg.global_sq_dist(ja, jb)), rtol=1e-6)
    halves = agg.tree_cast_like(ta, {k: v.bfloat16() for k, v in ta.items()})
    assert all(v.dtype == torch.bfloat16 for v in halves.values())


def test_tree_stack_and_unstack_round_trip():
    trees = [{"w": torch.full((2, 3), float(i)), "b": torch.tensor([float(i)])} for i in range(3)]
    stacked = agg.tree_stack(trees)
    assert tuple(stacked["w"].shape) == (3, 2, 3)
    back = agg.tree_unstack(stacked)
    assert len(back) == 3
    for got, want in zip(back, trees):
        for k in want:
            assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("shards", [1, 3])
def test_streaming_means_equal_jax(shards):
    rng = np.random.default_rng(8)
    updates = [({"w": rng.normal(size=(4, 2)).astype(np.float32),
                 "b": rng.normal(size=(3,)).astype(np.float32)}, float(rng.integers(0, 9)))
               for _ in range(7)]
    ours, theirs = agg.ShardedStreamingMean(shards), jagg.ShardedStreamingMean(shards)
    single, jsingle = agg.StreamingMean(), jagg.StreamingMean()
    assert ours.mean() is None and single.mean() is None
    for i, (sd, w) in enumerate(updates):
        ours.add(sd, w, shard=i)
        theirs.add(sd, w, shard=i)
        single.add(sd, w)
        jsingle.add(sd, w)
    assert ours.count == single.count == 7
    assert ours.total_weight == theirs.total_weight == single.total_weight
    for got, want in ((ours.mean(), theirs.mean()), (single.mean(), jsingle.mean())):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()
    with pytest.raises(ValueError):
        agg.ShardedStreamingMean(0)
