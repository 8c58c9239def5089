"""The port's vision models against the JAX package's on the CPU, on the
same weights (crossed through the JAX ``params_to_state_dict``) and inputs
made from a numpy seed: each conv lowering on every shape of
``tests/test_resnet.py`` (2e-5), ResNet logits and per-example loss (fp32
1e-5, bf16 within 2e-2 of max(|x|, 1)), vmapped per-client grads (5e-4),
and the CNN, linear and MLP models (1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baton_tpu.models import cnn as jcnn
from baton_tpu.models import linear as jlinear
from baton_tpu.models import mlp as jmlp
from baton_tpu.models import resnet as jresnet
from baton_tpu.server.state import params_to_state_dict as jax_to_state
from baton_tpu_torch.models import cnn, linear, mlp, resnet

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores (and runs these tests faster)
torch.set_num_threads(1)

IMPLS = ("direct", "im2col", "shift")
CONV_SHAPES = [  # (kh, cin, cout, stride, hw), as tests/test_resnet.py:76-83
    (3, 3, 16, 1, 32),   # stem
    (3, 16, 16, 1, 32),  # body
    (3, 16, 32, 2, 32),  # strided stage entry: asymmetric SAME padding
    (1, 16, 32, 2, 32),  # strided 1x1 projection
    (3, 8, 8, 2, 9),     # odd spatial size
    (7, 3, 16, 2, 33),   # imagenet stem shape
]


def _to_torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _assert_bf16_close(got, want):
    """bf16 compute: within 2e-2 of max(|want|, 1), as test_resnet.py:216-219."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "k{}_c{}-{}_s{}_hw{}".format(*s))
@pytest.mark.parametrize("impl", IMPLS)
def test_conv_lowering_matches_jax(impl, shape):
    kh, cin, cout, stride, hw = shape
    rng = np.random.default_rng(kh * cin * stride + hw)
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    w = rng.normal(size=(kh, kh, cin, cout)).astype(np.float32)
    want = np.asarray(jresnet._CONV_IMPLS[impl](jnp.asarray(x), jnp.asarray(w), stride))
    got = resnet._CONV_IMPLS[impl](torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(3, 64, 64, 1, 32), (7, 3, 64, 2, 33)],
                         ids=["body64", "imagenet_stem"])
@pytest.mark.parametrize("impl", IMPLS)
def test_conv_lowering_bf16_matches_jax(impl, shape):
    """bf16 inputs: the shift lowering keeps each tap's product in fp32
    (a bf16 sum per tap would drift past the band on the 49-tap stem)."""
    kh, cin, cout, stride, hw = shape
    rng = np.random.default_rng(11 + kh)
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    w = rng.normal(size=(kh, kh, cin, cout)).astype(np.float32)
    want = jresnet._CONV_IMPLS[impl](jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), stride)
    got = resnet._CONV_IMPLS[impl](torch.from_numpy(x).bfloat16(), torch.from_numpy(w), stride)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), np.asarray(want, np.float32))


def _resnet_pair(impl, imagenet_stem=False, dtype="float32", blocks=(1, 1), n_classes=10,
                 n_groups=8):
    kw = dict(blocks_per_stage=blocks, n_classes=n_classes, n_groups=n_groups,
              imagenet_stem=imagenet_stem, conv_impl=impl)
    jm = jresnet.resnet_model(compute_dtype=getattr(jnp, dtype), **kw)
    tm = resnet.resnet_model(compute_dtype=getattr(torch, dtype), **kw)
    jparams = jm.init(jax.random.key(0))
    return jm, tm, jparams, _to_torch(jax_to_state(jparams))


@pytest.mark.parametrize("imagenet_stem", [False, True], ids=["cifar_stem", "imagenet_stem"])
@pytest.mark.parametrize("impl", IMPLS)
def test_logits_and_loss_match_jax(impl, imagenet_stem):
    jm, tm, jparams, tparams = _resnet_pair(impl, imagenet_stem)
    rng = np.random.default_rng(1)
    hw = 17 if imagenet_stem else 16  # odd: asymmetric stem and max-pool padding
    batch = {"x": rng.normal(size=(3, hw, hw, 3)).astype(np.float32),
             "y": rng.integers(0, 10, 3).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = tm.apply(tparams, tb)
    assert logits.dtype == torch.float32 and logits.shape == (3, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm.apply(jparams, jb, None)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.per_example_loss(tparams, tb).numpy(),
                               np.asarray(jm.per_example_loss(jparams, jb, None)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_logits_and_loss_match_jax(impl):
    jm, tm, jparams, tparams = _resnet_pair(impl, dtype="bfloat16")
    rng = np.random.default_rng(2)
    batch = {"x": rng.normal(size=(3, 16, 16, 3)).astype(np.float32),
             "y": rng.integers(0, 10, 3).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = tm.apply(tparams, tb)
    assert logits.dtype == torch.float32  # the head runs in fp32
    assert all(p.dtype == torch.float32 for p in tparams.values())
    _assert_bf16_close(logits.numpy(), jm.apply(jparams, jb, None))
    _assert_bf16_close(tm.per_example_loss(tparams, tb).numpy(),
                       jm.per_example_loss(jparams, jb, None))


@pytest.mark.parametrize("impl", IMPLS)
def test_vmapped_grads_match_jax(impl):
    """Per-client params and data under vmap, as the trainer runs them (a
    grouped convolution for ``direct``, batched matmuls for the others)."""
    jm, tm, jparams, _ = _resnet_pair(impl, blocks=(1,), n_classes=4, n_groups=4)
    c = 3
    jstacked = jax.tree_util.tree_map(
        lambda a: jnp.stack([a * (1.0 + 0.1 * i) for i in range(c)]), jparams)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(c, 2, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, (c, 2)).astype(np.int32)

    def jloss(p, xb, yb):
        return jnp.mean(jm.per_example_loss(p, {"x": xb, "y": yb}, None))

    jl, jg = jax.vmap(jax.value_and_grad(jloss))(jstacked, jnp.asarray(x), jnp.asarray(y))

    def tloss(p, xb, yb):
        return tm.per_example_loss(p, {"x": xb, "y": yb}).mean()

    tg, tl = torch.func.vmap(torch.func.grad_and_value(tloss))(
        _to_torch(jax_to_state(jstacked)), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for name, want in jax_to_state(jg).items():
        np.testing.assert_allclose(tg[name].numpy(), want, rtol=5e-4, atol=5e-4, err_msg=name)


def test_resnet18_names_shapes_and_size():
    jparams = jresnet.resnet18_cifar_model().init(jax.random.key(0))
    state = jax_to_state(jparams)
    model = resnet.resnet18_cifar_model(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params) == set(state)
    for name, arr in state.items():
        assert tuple(params[name].shape) == arr.shape, name
        assert params[name].dtype == torch.float32
    assert tuple(params["s1b0/proj"].shape) == (1, 1, 64, 128)  # HWIO
    n = sum(p.numel() for p in params.values())
    assert 11_100_000 < n < 11_300_000
    logits = model.apply(params, {"x": torch.zeros(2, 32, 32, 3)})
    assert logits.shape == (2, 10) and logits.dtype == torch.float32


def test_unknown_conv_impl_is_refused():
    with pytest.raises(ValueError, match="conv_impl"):
        resnet.resnet_model(conv_impl="winograd")
    with pytest.raises(ValueError, match="conv_impl"):
        cnn.cnn_mnist_model(conv_impl="winograd")


def _nhwc_rows_as_nchw(w, h, wd, c):
    """fc1/w with its rows reordered as an NCHW flatten would read them."""
    return w.reshape(h, wd, c, -1).permute(2, 0, 1, 3).reshape(h * wd * c, -1)


@pytest.mark.parametrize("impl", IMPLS)
def test_cnn_matches_jax_with_nhwc_flatten(impl):
    jm = jcnn.cnn_mnist_model(image_size=8, channels=1, width=4, conv_impl=impl)
    tm = cnn.cnn_mnist_model(image_size=8, channels=1, width=4, conv_impl=impl)
    jparams = jm.init(jax.random.key(0))
    tparams = _to_torch(jax_to_state(jparams))
    assert set(tparams) == set(tm.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(4)
    batch = {"x": rng.normal(size=(3, 8, 8)).astype(np.float32),  # rank 3: channel added
             "y": rng.integers(0, 10, 3).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jm.apply(jparams, jb, None))
    np.testing.assert_allclose(tm.apply(tparams, tb).numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.per_example_loss(tparams, tb).numpy(),
                               np.asarray(jm.per_example_loss(jparams, jb, None)),
                               rtol=1e-5, atol=1e-5)
    # the same weights read in NCHW order give other logits: the check
    # above would catch a flatten in the wrong order
    scrambled = dict(tparams, **{"fc1/w": _nhwc_rows_as_nchw(tparams["fc1/w"], 2, 2, 8)})
    assert np.abs(tm.apply(scrambled, tb).numpy() - want).max() > 1e-3


def test_cnn_vmapped_grads_match_jax():
    jm = jcnn.cnn_mnist_model(image_size=8, channels=1, width=4)
    tm = cnn.cnn_mnist_model(image_size=8, channels=1, width=4)
    jparams = jm.init(jax.random.key(1))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 2, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, (3, 2)).astype(np.int32)
    jl, jg = jax.vmap(jax.value_and_grad(
        lambda p, xb, yb: jnp.mean(jm.per_example_loss(p, {"x": xb, "y": yb}, None))),
        in_axes=(None, 0, 0))(jparams, jnp.asarray(x), jnp.asarray(y))
    tg, tl = torch.func.vmap(torch.func.grad_and_value(
        lambda p, xb, yb: tm.per_example_loss(p, {"x": xb, "y": yb}).mean()),
        in_dims=(None, 0, 0))(_to_torch(jax_to_state(jparams)), torch.from_numpy(x),
                              torch.from_numpy(y))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for name, want in jax_to_state(jg).items():
        np.testing.assert_allclose(tg[name].numpy(), want, rtol=5e-4, atol=5e-4, err_msg=name)


def test_linear_matches_jax():
    jm, tm = jlinear.linear_regression_model(10), linear.linear_regression_model(10)
    jparams = jm.init(jax.random.key(0))
    tparams = _to_torch(jax_to_state(jparams))
    init = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == {"w": (10, 1), "b": (1,)}
    assert float(init["w"].abs().max()) <= 10 ** -0.5
    rng = np.random.default_rng(6)
    batch = {"x": rng.normal(size=(5, 10)).astype(np.float32),
             "y": rng.normal(size=(5,)).astype(np.float32)}
    np.testing.assert_allclose(
        tm.per_example_loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}).numpy(),
        np.asarray(jm.per_example_loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                       None)), rtol=1e-5, atol=1e-5)


def test_mlp_matches_jax():
    jm = jmlp.mlp_classifier_model(12, hidden=(16, 8), n_classes=5)
    tm = mlp.mlp_classifier_model(12, hidden=(16, 8), n_classes=5)
    jparams = jm.init(jax.random.key(0))
    state = jax_to_state(jparams)
    init = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in state.items()}
    rng = np.random.default_rng(7)
    batch = {"x": rng.normal(size=(4, 3, 4)).astype(np.float32),  # flattened to 12
             "y": rng.integers(0, 5, 4).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(tm.apply(_to_torch(state), tb).numpy(),
                               np.asarray(jm.apply(jparams, jb, None)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.per_example_loss(_to_torch(state), tb).numpy(),
                               np.asarray(jm.per_example_loss(jparams, jb, None)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["resnet_imagenet_stem", "cnn"])
@pytest.mark.parametrize("impl", IMPLS)
def test_vmapped_forward_without_grad_matches_per_client(impl, model):
    """The evaluation path: a plain ``vmap`` over clients under no_grad
    (GroupNorm there refuses a channels-last input) gives each client's
    own forward."""
    if model == "cnn":
        m, hw, ch = cnn.cnn_mnist_model(image_size=8, width=4, conv_impl=impl), 8, 1
    else:
        m, hw, ch = resnet.resnet_model(blocks_per_stage=(1, 1), n_groups=8, imagenet_stem=True,
                                        conv_impl=impl), 17, 3
    params = m.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(3, 2, hw, hw, ch))
                         .astype(np.float32))
    with torch.no_grad():
        got = torch.func.vmap(lambda xb: m.apply(params, {"x": xb}))(x)
        want = torch.stack([m.apply(params, {"x": xb}) for xb in x])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
