"""The weights bridge: a JAX BERT-tiny init crosses into the port's params
and back with equal names, shapes and bytes; the port's own init has the
JAX package's names and shapes. The same for the vision models (HWIO conv
kernels, ``[d_in, d_out]`` dense weights, list-indexed MLP layers)."""

import jax
import numpy as np
import pytest
import torch

from baton_tpu.models.bert import BertConfig as JaxBertConfig
from baton_tpu.models.bert import bert_classifier_model as jax_bert
from baton_tpu import models as jax_models
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch import models
from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.server.state import params_to_state_dict, state_dict_to_params

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_state():
    params = jax_bert(JaxBertConfig.tiny()).init(jax.random.key(0))
    return jax_to_state(params)


@pytest.fixture(scope="module")
def template():
    return bert_classifier_model(BertConfig.tiny()).init(torch.Generator().manual_seed(0))


def test_port_init_has_jax_names_and_shapes(jax_state, template):
    assert set(template) == set(jax_state)
    for name, arr in jax_state.items():
        assert tuple(template[name].shape) == arr.shape, name
        assert template[name].dtype == torch.float32
    assert tuple(template["blocks/1/attn/wq"].shape) == (32, 32)  # [d_in, d_out]


def test_round_trip_is_byte_equal(jax_state, template):
    params = state_dict_to_params(template, jax_state, device="cpu")
    back = params_to_state_dict(params)
    assert set(back) == set(jax_state)
    for name, arr in jax_state.items():
        assert back[name].shape == arr.shape
        assert back[name].dtype == arr.dtype
        assert back[name].tobytes() == np.asarray(arr).tobytes(), name


def test_malformed_state_is_refused(jax_state, template):
    missing = dict(jax_state)
    del missing["head/w"]
    with pytest.raises(KeyError):
        state_dict_to_params(template, missing, device="cpu")
    wrong = dict(jax_state)
    wrong["head/w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        state_dict_to_params(template, wrong, device="cpu")


VISION = {
    "resnet_imagenet_stem": (lambda m: m.resnet_model(blocks_per_stage=(1, 2), n_groups=8,
                                                      imagenet_stem=True, n_classes=7)),
    "cnn": lambda m: m.cnn_mnist_model(image_size=12, channels=3, width=4),
    "mlp": lambda m: m.mlp_classifier_model(6, hidden=(5, 4), n_classes=3),
    "linear": lambda m: m.linear_regression_model(4),
}


@pytest.mark.parametrize("name", VISION)
def test_vision_models_cross_the_bridge(name):
    state = jax_to_state(VISION[name](jax_models).init(jax.random.key(0)))
    template = VISION[name](models).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in template.items()} == {
        k: v.shape for k, v in state.items()}
    back = params_to_state_dict(state_dict_to_params(template, state, device="cpu"))
    for k, arr in state.items():
        assert back[k].tobytes() == np.asarray(arr).tobytes(), k
