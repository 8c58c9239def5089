"""Flash attention — hand-written CUDA kernels for Hopper (``csrc/``),
each beside a plain PyTorch version of the same function (counterpart of
``baton_tpu/ops/flash_attention.py``).

Three designs, chosen by dtype and pass (``_design``), not as a fallback:

- ``wgmma`` (``csrc/flash_attention_wgmma.cu``): Hopper's design, for the
  bf16 forward and dkv. Tiles land in shared memory by TMA under
  ``mbarrier`` stages kept full by one producer thread; two consumer
  warpgroups run the products as ``wgmma`` (ping-ponged, so one's softmax
  overlaps the other's products), with p and ds fed back from registers.
  Persistent: one block an SM walks its share of the work items.
- ``mma`` (``csrc/flash_attention_mma.cu``): bf16 tiles in shared memory
  filled by ``cp.async``, products on the tensor cores (``mma.sync``).
  The bf16 dq.
- ``tf32x3`` (``csrc/flash_attention_tf32.cu``): fp32 tiles by
  ``cp.async``, every product on the TF32 tensor cores in three parts
  (each operand split into two TF32 values; fp32 accuracy). Every fp32
  pass: the forward and both passes of the backward.

=================  ====================================  ===========================
wrapper            CUDA kernel (design)                  TPU kernel it replaces
=================  ====================================  ===========================
``_fwd``           ``fwd_wgmma_kernel`` (wgmma, bf16)    ``_fwd_kernel`` (:65-131)
                   ``fwd_tf32x3_kernel`` (tf32x3, fp32)
``_bwd_dkv``       ``dkv_wgmma_kernel`` (wgmma, bf16)    ``_bwd_dkv_kernel`` (:203-250)
                   ``dkv_tf32x3_kernel`` (tf32x3, fp32)
``_bwd_dq``        ``dq_mma_kernel`` (mma, bf16)         ``_bwd_dq_kernel`` (:253-290)
                   ``dq_tf32x3_kernel`` (tf32x3, fp32)
=================  ====================================  ===========================

``flash_block_fwd`` and ``flash_block_bwd`` expose one k/v block's
passes (out with its lse; the gradients against a global out and lse)
for ring × flash (``parallel/ring_attention.py``).

A wrapper takes its plain version only because the tensor it was given
lies on the CPU; a CUDA tensor goes to a kernel or raises. Each kernel
launch adds one to ``launches_by_design[pass_design]``, and nothing else
does; ``launches()`` sums them by pass. The kernels are built for
``sm_90a`` at the first CUDA launch, one ``nvcc`` a source started
together and one link (into ``_build/`` beside this file, keyed by the
sources' hash), and bound with ctypes. The
sources note what bounds each kernel on the card.

Semantics are those of the JAX kernels: q [B, Hq, Lq, D], k/v
[B, Hkv, Lk, D], an additive per-key bias [B, Lk] in fp32, fp32 softmax,
``NEG_INF = -1e30`` (finite, so fully masked rows average uniformly
instead of giving NaN), query head h reads kv head h // (Hq / Hkv).
Keys past Lk count for nothing (the JAX wrapper pads them with -1e30
bias; these kernels mask the ragged edge themselves, so no pad copies).
The delta precompute ``rowsum(do·o)`` and the GQA fold of the per-head
kv gradients are torch ops, outside the kernels, as in JAX.

Training runs under ``torch.func.vmap(grad(...))`` over a client axis. A
ctypes launch cannot read a batched tensor, so the forward and the
backward are each a ``torch.autograd.Function`` whose ``vmap`` rule folds
the client axis into the kernels' batch axis: one launch per layer per
step covers every client of a wave.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("flash_attention_mma.cu", "flash_attention_wgmma.cu", "flash_attention_tf32.cu")
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches on CUDA tensors, by pass and design ("<pass>_<design>");
# chip_smoke.py resets them before the path it counts
launches_by_design = {"fwd_wgmma": 0, "fwd_tf32x3": 0, "bwd_dkv_wgmma": 0,
                      "bwd_dkv_tf32x3": 0, "bwd_dq_mma": 0, "bwd_dq_tf32x3": 0}

# the C entry points and their ctypes argument types: a pointer (tensors,
# the stream) is c_void_p, an int c_int, a float c_float
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_fwd_wgmma": [_I] + [_P] * 6 + [_I] * 6 + [_F, _P],
    "flash_bwd_dkv_wgmma": [_I] + [_P] * 10 + [_I] * 6 + [_F, _P],
    "flash_fwd_tf32x3": [_I] + [_P] * 6 + [_I] * 6 + [_F, _P],
    "flash_bwd_dkv_tf32x3": [_I] + [_P] * 10 + [_I] * 6 + [_F, _P],
    "flash_bwd_dq_mma": [_I] + [_P] * 8 + [_I] * 6 + [_F, _P],
    "flash_bwd_dq_tf32x3": [_I] + [_P] * 8 + [_I] * 6 + [_F, _P],
}

_lib = None


def launches() -> dict:
    """Kernel launches by pass (``fwd``, ``bwd_dkv``, ``bwd_dq``), over designs."""
    by_pass = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}
    for key, n in launches_by_design.items():
        by_pass[key.rsplit("_", 1)[0]] += n
    return by_pass


def reset_launches() -> None:
    for name in launches_by_design:
        launches_by_design[name] = 0


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            digest.update(src.name.encode() + src.read_bytes())
    tag = digest.hexdigest()[:16]
    return _BUILD_DIR / f"libflash_attention_{tag}.so"


def load_library() -> ctypes.CDLL:
    """Build the kernels (once per source version) and bind them."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        # one nvcc a source, all started together, then one link
        objs = [so.with_name(f"{Path(name).stem}.{os.getpid()}.o") for name in _SOURCES]
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / name)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for name, obj in zip(_SOURCES, objs)]
        outs = [p.communicate() for p in procs]
        log = "".join(out + err for out, err in outs)
        failed = [err for p, (_, err) in zip(procs, outs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed.append(link.stderr)
        for obj in objs:
            obj.unlink(missing_ok=True)
        so.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    _lib = lib
    return lib


def _on_cpu(*xs) -> bool:
    """True when the plain version applies; raises for a device that has
    no kernel (there is no silent fallback from CUDA to the plain path)."""
    kinds = {x.device.type for x in xs}
    if kinds in ({"cpu"}, {"cuda"}):
        return kinds == {"cpu"}
    raise ValueError(f"flash attention needs all inputs on one CPU or CUDA device, got {kinds}")


def _design(dtype: torch.dtype, d: int, pass_: str) -> str:
    """The kernel design for a dtype, head dim and pass (``"fwd"``,
    ``"bwd_dkv"``, ``"bwd_dq"``): ``"wgmma"`` (Hopper's warpgroup products
    fed by TMA) for the bf16 forward and dkv, ``"mma"`` (``mma.sync``) for
    the bf16 dq, ``"tf32x3"`` (TF32 tensor cores, three products) for every
    fp32 pass. Raises for anything else."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take fp32 or bf16, got {dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash kernels take head dim 64 or 128, got {d}")
    if pass_ not in ("fwd", "bwd_dkv", "bwd_dq"):
        raise ValueError(f"no flash pass {pass_!r}")
    if dtype == torch.float32:
        return "tf32x3"
    return "mma" if pass_ == "bwd_dq" else "wgmma"


def _kernel_args(q, k, v, pass_):
    """Validate what the kernels take; returns (design, head dim)."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must lie on one device")
    d = q.shape[-1]
    return _design(q.dtype, d, pass_), d


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the mma and tf32x3 kernels
    copy rows in 16-byte pieces, and TMA reads only 16-byte aligned
    tensors); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn_name: str, device, *args) -> None:
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


# ======================================================================
# plain PyTorch versions: dense fp32 math with the kernels' rounding points


def _expand_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    return x.repeat_interleave(hq // x.shape[1], dim=1)


def _scores(q, k, bias2d, causal, scale):
    """fp32 s = q·kᵀ·scale + bias, causal entries replaced by NEG_INF."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + bias2d.float()[:, None, None, :]
    if causal:
        lq, lk = s.shape[-2:]
        qpos = torch.arange(lq, device=s.device)[:, None]
        kpos = torch.arange(lk, device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    return s


def _fwd_plain(q, k, v, bias2d, causal, scale):
    """out [B,Hq,Lq,D] in q's dtype, lse [B,Hq,Lq] fp32."""
    hq = q.shape[1]
    k, v = _expand_kv(k, hq), _expand_kv(v, hq)
    s = _scores(q, k, bias2d, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_ds(q, k, v, bias2d, dout, lse, delta, causal, scale):
    s = _scores(q, k, bias2d, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def _bwd_dkv_plain(q, k, v, bias2d, dout, lse, delta, causal, scale):
    """Per-query-head dk, dv [B,Hq,Lk,D] and db [B,Hq,Lk], all fp32."""
    hq = q.shape[1]
    k, v = _expand_kv(k, hq), _expand_kv(v, hq)
    p, ds = _p_ds(q, k, v, bias2d, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), dout.float())
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return dk, dv, ds.sum(dim=2)


def _bwd_dq_plain(q, k, v, bias2d, dout, lse, delta, causal, scale):
    """dq [B,Hq,Lq,D] fp32."""
    hq = q.shape[1]
    k, v = _expand_kv(k, hq), _expand_kv(v, hq)
    _, ds = _p_ds(q, k, v, bias2d, dout, lse, delta, causal, scale)
    return scale * torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())


# ======================================================================
# wrappers: the kernel for CUDA tensors, the plain version for CPU ones


def _fwd(q, k, v, bias2d, causal, scale):
    if _on_cpu(q, k, v, bias2d):
        return _fwd_plain(q, k, v, bias2d, causal, scale)
    design, d = _kernel_args(q, k, v, "fwd")
    q, k, v = _dense(q), _dense(k), _dense(v)
    bias2d = _dense(bias2d.float())
    b, hq, lq, _ = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    _launch(f"flash_fwd_{design}", q.device, d,
            *(t.data_ptr() for t in (q, k, v, bias2d, out, lse)),
            b, hq, hkv, lq, lk, int(causal), scale)
    launches_by_design[f"fwd_{design}"] += 1
    return out, lse


def _bwd_inputs(q, k, v, bias2d, dout, lse, delta):
    """The backward kernels' inputs as they read them: q, k, v, dout
    contiguous and aligned in one dtype; bias, lse, delta contiguous and
    aligned fp32."""
    if dout.dtype != q.dtype:
        raise TypeError("dout must have q's dtype")
    return ([_dense(t) for t in (q, k, v)] + [_dense(bias2d.float())]
            + [_dense(dout)] + [_dense(t.float()) for t in (lse, delta)])


def _bwd_dkv(q, k, v, bias2d, dout, lse, delta, causal, scale):
    if _on_cpu(q, k, v, bias2d, dout, lse, delta):
        return _bwd_dkv_plain(q, k, v, bias2d, dout, lse, delta, causal, scale)
    design, _ = _kernel_args(q, k, v, "bwd_dkv")
    inputs = _bwd_inputs(q, k, v, bias2d, dout, lse, delta)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dk = torch.empty((b, hq, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    db = torch.empty((b, hq, lk), dtype=torch.float32, device=q.device)
    _launch(f"flash_bwd_dkv_{design}", q.device, d,
            *(t.data_ptr() for t in (*inputs, dk, dv, db)),
            b, hq, hkv, lq, lk, int(causal), scale)
    launches_by_design[f"bwd_dkv_{design}"] += 1
    return dk, dv, db


def _bwd_dq(q, k, v, bias2d, dout, lse, delta, causal, scale):
    if _on_cpu(q, k, v, bias2d, dout, lse, delta):
        return _bwd_dq_plain(q, k, v, bias2d, dout, lse, delta, causal, scale)
    design, _ = _kernel_args(q, k, v, "bwd_dq")
    inputs = _bwd_inputs(q, k, v, bias2d, dout, lse, delta)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dq = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    _launch(f"flash_bwd_dq_{design}", q.device, d,
            *(t.data_ptr() for t in (*inputs, dq)),
            b, hq, hkv, lq, lk, int(causal), scale)
    launches_by_design[f"bwd_dq_{design}"] += 1
    return dq


def _bwd(q, k, v, bias2d, out, dout, lse, causal, scale):
    """(dq, dk, dv, dbias) in fp32: the two backward kernels plus the torch
    glue around them (delta before, the GQA fold after)."""
    b, hq, _, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    delta = (dout.float() * out.float()).sum(dim=-1)
    dk_h, dv_h, db_h = _bwd_dkv(q, k, v, bias2d, dout, lse, delta, causal, scale)
    dq = _bwd_dq(q, k, v, bias2d, dout, lse, delta, causal, scale)
    dk = dk_h.reshape(b, hkv, hq // hkv, lk, d).sum(dim=2)
    dv = dv_h.reshape(b, hkv, hq // hkv, lk, d).sum(dim=2)
    return dq, dk, dv, db_h.sum(dim=1)


# ======================================================================
# autograd: forward and backward are Functions with vmap rules that fold
# the vmapped client axis into the kernels' batch axis


def _fold(info, in_dims, *xs):
    """[C, B, ...] (or an unbatched [B, ...]) -> [C·B, ...]."""
    out = []
    for x, dim in zip(xs, in_dims):
        if dim is None:
            x = x.unsqueeze(0).expand(info.batch_size, *x.shape)
        else:
            x = x.movedim(dim, 0)
        out.append(x.reshape(-1, *x.shape[2:]))
    return out


def _unfold(c, xs):
    return tuple(x.reshape(c, -1, *x.shape[1:]) for x in xs)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, bias2d, causal, scale):
        return _fwd(q, k, v, bias2d, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias2d, ctx.causal, ctx.scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, bias2d, out, lse)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias2d, out, lse = ctx.saved_tensors
        dq, dk, dv, db = _FlashAttentionBackward.apply(
            q, k, v, bias2d, out, dout, lse, ctx.causal, ctx.scale)
        return dq, dk, dv, db, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias2d, causal, scale):
        folded = _fold(info, in_dims[:4], q, k, v, bias2d)
        out = _FlashAttention.apply(*folded, causal, scale)
        return _unfold(info.batch_size, out), (0, 0)


class _FlashAttentionBackward(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, bias2d, out, dout, lse, causal, scale):
        dq, dk, dv, db = _bwd(q, k, v, bias2d, out, dout, lse, causal, scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db.to(bias2d.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias2d, out, dout, lse, causal, scale):
        folded = _fold(info, in_dims[:7], q, k, v, bias2d, out, dout, lse)
        grads = _FlashAttentionBackward.apply(*folded, causal, scale)
        return _unfold(info.batch_size, grads), (0, 0, 0, 0)


# ======================================================================
# public API


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Flash attention with ``dot_product_attention`` semantics
    (models/transformer.py): q [B, Hq, L, Dh], k/v [B, Hkv, L, Dh],
    optional additive per-key ``bias`` [B, 1, 1, L]; returns
    [B, Hq, L, Dh] in q's dtype. Differentiable (kernel backward), and
    composes with ``torch.func.vmap``/``grad``. Any L works."""
    b, hq, _, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} % {hkv}")
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}")
    if bias is None:
        bias2d = torch.zeros((b, lk), dtype=torch.float32, device=q.device)
    else:
        if tuple(bias.shape) != (b, 1, 1, lk):
            raise ValueError(f"bias must be [B,1,1,L], got {tuple(bias.shape)}")
        bias2d = bias.reshape(b, lk).float()
    out, _ = _FlashAttention.apply(q, k, v, bias2d, causal, d ** -0.5)
    return out


# ======================================================================
# block entry points for ring × flash (parallel/ring_attention.py): one k/v
# block's forward with its lse, and its backward against the GLOBAL out and
# lse, which gives exactly that block's share of the global gradients.
# The kernels take any L, so JAX's padding to whole tiles has no
# counterpart; its dtypes do.


def flash_block_fwd(q, k, v, bias2d, causal):
    """One block's flash forward (``baton_tpu/ops/flash_attention.py``
    ``flash_block_fwd``): ``(out [B, Hq, Lq, D]`` normalised in q's dtype,
    ``lse [B, Hq, Lq]`` fp32). ``bias2d`` is the per-key additive bias
    [B, Lk]. Not differentiable: pair it with :func:`flash_block_bwd`
    inside an outer ``autograd.Function``."""
    with torch.no_grad():
        return _fwd(q, k, v, bias2d, causal, q.shape[-1] ** -0.5)


def flash_block_bwd(q, k, v, bias2d, out, dout, lse, causal):
    """One block's flash backward against the GLOBAL ``out`` and ``lse``:
    ``(dq, dk, dv, dbias2d)``, this block's exact contributions to the
    global gradients; dq, dk and dv in their inputs' dtypes, dbias2d
    [B, Lk] in fp32. Not differentiable."""
    with torch.no_grad():
        dq, dk, dv, db = _bwd(q, k, v, bias2d, out, dout, lse, causal, q.shape[-1] ** -0.5)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db


def make_flash_attention_fn():
    """Seam-compatible ``attention_fn(q, k, v, bias, causal)`` for any
    model: ``model(..., attention_fn=make_flash_attention_fn())``. The
    kernels pick their own tiles, so there is nothing to configure."""
    return flash_attention
