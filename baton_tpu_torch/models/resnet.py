"""ResNet with GroupNorm (counterpart of ``baton_tpu/models/resnet.py``):
ResNet-18 for 32x32 inputs is ``bench.py``'s model.

Layouts are the JAX package's: activations are NHWC, conv kernels HWIO
(``[kh, kw, cin, cout]``), the head ``fc/w`` is ``[d_in, n_classes]``, so
the weights bridge copies without transposes. Param names are its
slash-joined tree paths (``stem``, ``gn_stem/scale``, ``s1b0/proj``,
``fc/w``). Params stay fp32; activations and conv kernels are cast to
``compute_dtype`` per apply; GroupNorm and the head run in fp32.

Padding is XLA's SAME: ``total = max((out - 1) * stride + k - in, 0)``,
``total // 2`` on the low side. For a stride-2 conv on an even size that
is asymmetric (0 on top/left, 1 on bottom/right for 3x3 on 32 px), which
``F.conv2d(padding=...)`` cannot express: :func:`_same_pads` computes it,
and an asymmetric pad goes through ``F.pad`` before a ``padding=0`` conv.

Three lowerings of the same conv, selected by ``conv_impl``:

* ``direct``: ``F.conv2d``. The NHWC activation is handed over as an
  NCHW view (channels-last memory, no copy) and the kernel permuted to
  OIHW, here and nowhere else. Under ``torch.func.vmap`` with per-client
  weights it becomes one grouped convolution (groups = clients).
* ``im2col``: the kh*kw shifted slices concatenated tap-major, in (i, j)
  order, along channels, then one matmul with ``w.reshape(kh*kw*cin,
  cout)`` (a batched matmul under vmap).
* ``shift``: the sum of kh*kw shifted matmuls ``x_ij @ w[i, j]``. Each
  tap's product is kept in fp32 before the sum, as the JAX lowering's
  ``preferred_element_type=float32`` does: the product of two bf16 values
  is exact in fp32, so bf16 operands are multiplied as fp32 and the sum
  is cast back once.

Batches: ``{"x": [B, H, W, C], "y": int[B]}``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from baton_tpu_torch.core.losses import softmax_cross_entropy
from baton_tpu_torch.core.model import FedModel

STAGE_WIDTHS: Tuple[int, ...] = (64, 128, 256, 512)
BLOCKS_PER_STAGE_18: Tuple[int, ...] = (2, 2, 2, 2)
BLOCKS_PER_STAGE_34: Tuple[int, ...] = (3, 4, 6, 3)


def _he(gen, shape, fan_in):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * (2.0 / fan_in) ** 0.5


def _conv_init(gen, kh, kw, cin, cout):
    return _he(gen, (kh, kw, cin, cout), kh * kw * cin)


def _gn_init(prefix, c):
    return {f"{prefix}/scale": torch.ones(c), f"{prefix}/bias": torch.zeros(c)}


def _same_pads(size, k, stride):
    """(low, high) padding of one spatial axis for a SAME window, and the
    output size."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2, out


def _pad_nhwc(x, kh, kw, stride, value=0.0):
    """``x`` [B, H, W, C] padded for a SAME kh x kw window; returns it and
    the output size."""
    top, bottom, oh = _same_pads(x.shape[1], kh, stride)
    left, right, ow = _same_pads(x.shape[2], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom), value=value)
    return x, oh, ow


def _shifted_views(x, kh, kw, stride):
    """Yield ``(i, j, view)`` for each tap of a SAME conv: the strided
    slice of the padded input that tap (i, j) multiplies. Shared by the
    im2col and shift lowerings."""
    xp, oh, ow = _pad_nhwc(x, kh, kw, stride)
    for i in range(kh):
        for j in range(kw):
            yield i, j, xp[:, i: i + (oh - 1) * stride + 1: stride,
                           j: j + (ow - 1) * stride + 1: stride, :]


def _conv_direct(x, w, stride=1):
    kh, kw = w.shape[:2]
    top, bottom, _ = _same_pads(x.shape[1], kh, stride)
    left, right, _ = _same_pads(x.shape[2], kw, stride)
    if top == bottom and left == right:
        padding = (top, left)
    else:
        x = F.pad(x, (0, 0, left, right, top, bottom))
        padding = 0
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                   stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def _conv_im2col(x, w, stride=1):
    kh, kw, cin, cout = w.shape
    patches = torch.cat([xs for _, _, xs in _shifted_views(x, kh, kw, stride)], dim=-1)
    return patches @ w.to(x.dtype).reshape(kh * kw * cin, cout)


def _conv_shift(x, w, stride=1):
    kh, kw = w.shape[:2]
    wm = w.to(x.dtype).float()
    out = None
    for i, j, xs in _shifted_views(x, kh, kw, stride):
        term = xs.float() @ wm[i, j]
        out = term if out is None else out + term
    return out.to(x.dtype)


_CONV_IMPLS = {"direct": _conv_direct, "im2col": _conv_im2col, "shift": _conv_shift}


def _conv(x, w, stride=1, impl="direct"):
    return _CONV_IMPLS[impl](x, w, stride)


def _group_norm(x, p, prefix, n_groups=32, eps=1e-5):
    """GroupNorm of NHWC ``x`` over ``min(n_groups, C)`` groups of
    contiguous channels: population statistics, scale and bias in fp32,
    the result cast back to ``x``'s dtype. It normalises an [N, C, H*W]
    tensor: under a plain ``vmap`` (evaluation) a 4-D input that may be
    channels-last makes ``group_norm`` query a memory format vmap cannot
    answer."""
    b, h, w, c = x.shape
    out = F.group_norm(x.float().permute(0, 3, 1, 2).reshape(b, c, h * w), min(n_groups, c),
                       p[f"{prefix}/scale"], p[f"{prefix}/bias"], eps)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(x.dtype)


def _max_pool_same(x, k, stride):
    """k x k max-pool of NHWC ``x``, SAME padding with -inf."""
    xp, _, _ = _pad_nhwc(x, k, k, stride, value=float("-inf"))
    return F.max_pool2d(xp.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def _block_init(gen, prefix, cin, cout, stride):
    p = {f"{prefix}/conv1": _conv_init(gen, 3, 3, cin, cout), **_gn_init(f"{prefix}/gn1", cout),
         f"{prefix}/conv2": _conv_init(gen, 3, 3, cout, cout), **_gn_init(f"{prefix}/gn2", cout)}
    if stride != 1 or cin != cout:
        p[f"{prefix}/proj"] = _conv_init(gen, 1, 1, cin, cout)
        p.update(_gn_init(f"{prefix}/gn_proj", cout))
    return p


def _block_apply(x, p, prefix, stride, n_groups, impl):
    out = _conv(x, p[f"{prefix}/conv1"], stride, impl)
    out = torch.relu(_group_norm(out, p, f"{prefix}/gn1", n_groups))
    out = _conv(out, p[f"{prefix}/conv2"], 1, impl)
    out = _group_norm(out, p, f"{prefix}/gn2", n_groups)
    if f"{prefix}/proj" in p:
        x = _group_norm(_conv(x, p[f"{prefix}/proj"], stride, impl), p,
                        f"{prefix}/gn_proj", n_groups)
    return torch.relu(out + x)


def resnet_model(
    blocks_per_stage: Sequence[int] = BLOCKS_PER_STAGE_18,
    n_classes: int = 10,
    channels: int = 3,
    n_groups: int = 32,
    width_multiplier: int = 1,
    imagenet_stem: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    conv_impl: str = "direct",
    name: str = "resnet18",
) -> FedModel:
    if conv_impl not in _CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {sorted(_CONV_IMPLS)}, got {conv_impl!r}")
    if len(blocks_per_stage) > len(STAGE_WIDTHS):
        raise ValueError(f"at most {len(STAGE_WIDTHS)} stages supported, got "
                         f"{len(blocks_per_stage)}")
    widths = [w * width_multiplier for w in STAGE_WIDTHS]

    def stride_of(s, b):
        return 2 if (b == 0 and s > 0) else 1

    def init(gen: torch.Generator):
        stem_k = 7 if imagenet_stem else 3
        params = {"stem": _conv_init(gen, stem_k, stem_k, channels, widths[0]),
                  **_gn_init("gn_stem", widths[0])}
        cin = widths[0]
        for s, (n_blocks, cout) in enumerate(zip(blocks_per_stage, widths)):
            for b in range(n_blocks):
                params.update(_block_init(gen, f"s{s}b{b}", cin, cout, stride_of(s, b)))
                cin = cout
        params["fc/w"] = _he(gen, (cin, n_classes), cin)
        params["fc/b"] = torch.zeros(n_classes)
        return params

    def apply(params, batch):
        x = batch["x"].to(compute_dtype)
        x = _conv(x, params["stem"], 2 if imagenet_stem else 1, conv_impl)
        x = torch.relu(_group_norm(x, params, "gn_stem", n_groups))
        if imagenet_stem:
            x = _max_pool_same(x, 3, 2)
        for s, n_blocks in enumerate(blocks_per_stage):
            for b in range(n_blocks):
                x = _block_apply(x, params, f"s{s}b{b}", stride_of(s, b), n_groups, conv_impl)
        x = x.mean(dim=(1, 2))
        return x.float() @ params["fc/w"] + params["fc/b"]

    def per_example_loss(params, batch):
        return softmax_cross_entropy(apply(params, batch), batch)

    return FedModel(init=init, apply=apply, per_example_loss=per_example_loss, name=name)


def resnet18_cifar_model(n_classes: int = 10, compute_dtype: torch.dtype = torch.float32,
                         conv_impl: str = "direct", name: str = "resnet18_cifar") -> FedModel:
    """ResNet-18 for 32x32 inputs: ``bench.py``'s model (11.2 M params)."""
    return resnet_model(BLOCKS_PER_STAGE_18, n_classes=n_classes, compute_dtype=compute_dtype,
                        conv_impl=conv_impl, name=name)
