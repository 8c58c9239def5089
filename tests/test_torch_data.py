"""The port's numpy data helpers give the JAX package's arrays bit for bit
from the same numpy seed."""

import numpy as np
import pytest

from baton_tpu.data import partition as jpartition
from baton_tpu.data import synthetic as jsynthetic
from baton_tpu_torch.data import partition, synthetic


def _assert_bit_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_bit_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_bit_equal(g, w)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name,kw", [
    ("linear_client_data", {"noise": 0.1}),
    ("synthetic_classification_clients", {"n_clients": 4, "n_per_client": 16}),
    ("synthetic_image_clients", {"n_clients": 3, "n_per_client": 5, "image_size": 8}),
    ("synthetic_char_clients", {"n_clients": 2, "n_per_client": 4, "seq_len": 8,
                                "vocab_size": 12}),
])
def test_synthetic_is_bit_equal(name, kw):
    got = getattr(synthetic, name)(np.random.default_rng(3), **kw)
    want = getattr(jsynthetic, name)(np.random.default_rng(3), **kw)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("iid_partition", {}),
    ("dirichlet_partition", {"alpha": 0.3, "min_samples": 2}),
    ("label_shard_partition", {"classes_per_client": 2}),
])
def test_partitions_are_bit_equal(name, kw):
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(200, 3)).astype(np.float32),
            "y": rng.integers(0, 5, 200).astype(np.int32)}
    got = getattr(partition, name)(data, 7, np.random.default_rng(1), **kw)
    want = getattr(jpartition, name)(data, 7, np.random.default_rng(1), **kw)
    _assert_bit_equal(got, want)
    assert partition.partition_stats(got) == jpartition.partition_stats(want)
