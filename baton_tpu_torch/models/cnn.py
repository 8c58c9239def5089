"""2-layer CNN for MNIST-shaped inputs (counterpart of
``baton_tpu/models/cnn.py``): two SAME 3x3 convs with bias, each followed
by ReLU and a 2x2 VALID max-pool, then two dense layers. It shares the
ResNet's conv lowerings (``conv_impl``) and layouts: NHWC activations,
HWIO kernels, ``[d_in, d_out]`` dense weights.

The flatten before ``fc1`` is in NHWC order (h, w, c), as in the JAX
package, so the rows of ``fc1/w`` mean the same in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from baton_tpu_torch.core.losses import softmax_cross_entropy
from baton_tpu_torch.core.model import FedModel
from baton_tpu_torch.models.resnet import _CONV_IMPLS, _conv


def _max_pool_2x2(x):
    """2x2 VALID max-pool of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def cnn_mnist_model(
    image_size: int = 28,
    channels: int = 1,
    n_classes: int = 10,
    width: int = 32,
    conv_impl: str = "direct",
    name: str = "cnn_mnist",
) -> FedModel:
    if conv_impl not in _CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {sorted(_CONV_IMPLS)}, got {conv_impl!r}")
    reduced = image_size // 4  # two 2x2 maxpools
    flat = reduced * reduced * 2 * width

    def init(gen: torch.Generator):
        def he(shape, fan_in):
            return torch.randn(shape, generator=gen, dtype=torch.float32) * (2.0 / fan_in) ** 0.5

        return {
            "conv1/w": he((3, 3, channels, width), 9 * channels),
            "conv1/b": torch.zeros(width),
            "conv2/w": he((3, 3, width, 2 * width), 9 * width),
            "conv2/b": torch.zeros(2 * width),
            "fc1/w": he((flat, 128), flat),
            "fc1/b": torch.zeros(128),
            "fc2/w": he((128, n_classes), 128),
            "fc2/b": torch.zeros(n_classes),
        }

    def apply(params, batch):
        x = batch["x"]
        if x.dim() == 3:
            x = x[..., None]
        x = torch.relu(_conv(x, params["conv1/w"], 1, conv_impl) + params["conv1/b"])
        x = _max_pool_2x2(x)
        x = torch.relu(_conv(x, params["conv2/w"], 1, conv_impl) + params["conv2/b"])
        x = _max_pool_2x2(x)
        x = x.reshape(x.shape[0], -1)  # NHWC order: (h, w, c)
        x = torch.relu(x @ params["fc1/w"] + params["fc1/b"])
        return x @ params["fc2/w"] + params["fc2/b"]

    def per_example_loss(params, batch):
        return softmax_cross_entropy(apply(params, batch), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss, name=name)
