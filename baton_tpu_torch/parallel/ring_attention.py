"""Sequence parallelism: ring attention, ring × flash, Ulysses and striped
attention over a device mesh (counterpart of
``baton_tpu/parallel/ring_attention.py``).

The JAX module runs each kernel inside ``shard_map`` on length shards,
with ``lax.ppermute`` and ``lax.all_to_all`` between devices. Here one
process drives every shard: a kernel takes the N shards of q, k, v (and of
the per-key bias) as lists, shard ``j`` on the ``j``-th device of the mesh
axis, and returns the N output shards. The ring's transport is one
function, :func:`_rotate`: at each step the block held by shard ``j`` moves
to shard ``j + 1`` (a no-op where both are the same device, as on a mesh
that repeats one card or the CPU).

* **Ring** (:func:`ring_attention`): k/v blocks rotate while each shard's
  q stays; exact softmax by the online (max, sum) recurrence in fp32, never
  the full L x L. Causal masks come from global positions, and a block
  wholly in a shard's future is skipped.
* **Ring × flash** (:func:`flash_ring_attention`): the same ring with each
  block's math in the flash kernels (``ops/flash_attention.py``
  ``flash_block_fwd`` / ``flash_block_bwd``), combined by the blocks' lse.
  The diagonal block runs causal; then only blocks from the past, not
  causal. Its gradient is a ring-level ``autograd.Function``: the backward
  rotates k/v again and runs each block's flash backward against the
  GLOBAL out and lse, with the dk/dv/dbias accumulators riding the ring
  with their block and one last rotation bringing them home.
* **Ulysses** (:func:`ulysses_attention`): a re-shard of heads against
  length between the devices, dense attention over the whole sequence for
  H/N heads on each, and back. Head counts must divide by N.
* **Striped** (:func:`make_striped_attention_fn`): causal ring attention
  with token ``t`` on shard ``t % N`` (load-balanced), permuted at the
  seam; the dense ring kernel (there is no striped flash).

Every seam (``make_*_attention_fn``) takes and returns global
[B, H, L, Dh] tensors, the model zoo's ``attention_fn`` contract: it
splits L into N contiguous shards (each made contiguous once, on its
device), runs the kernel and gathers the output on the caller's device.
Additive per-key padding biases [B, 1, 1, L] are supported.

Gradients: the dense ring, Ulysses and striped kernels are plain torch
ops that autograd differentiates through the slices and ``.to()``; the
flash ring is a ``torch.autograd.Function`` whose ``vmap`` rule folds a
client axis into the kernels' batch axis, so ``torch.func.vmap(grad(...))``
(``LocalTrainer``) runs one kernel launch per block for every client.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from baton_tpu_torch.models.transformer import dot_product_attention
from baton_tpu_torch.ops.flash_attention import (
    _fold,
    _unfold,
    flash_block_bwd,
    flash_block_fwd,
)
from baton_tpu_torch.parallel.mesh import Mesh

SEQ_AXIS = "seq"

_NEG = -1e30


def _rotate(held: list, devices: Sequence[torch.device]) -> list:
    """One step of the ring: ``held[j]`` (a tuple of tensors on shard
    ``j``'s device) moves to shard ``j + 1``. The ring's only transport:
    a mesh that spans processes swaps this function out."""
    n = len(devices)
    return [tuple(t.to(devices[j], non_blocking=True) for t in held[(j - 1) % n])
            for j in range(n)]


def _devices(shards) -> list:
    return [x.device for x in shards]


def _zero_bias(q, k):
    """Per-shard zero key biases [B, Lk/N] fp32, for a call without one."""
    return [torch.zeros((qs.shape[0], ks.shape[2]), dtype=torch.float32, device=ks.device)
            for qs, ks in zip(q, k)]


# ======================================================================
# the dense ring


def _block_scores(q, k, scale):
    """[B,Hq,Lq,Dh] x [B,Hkv,Lk,Dh] -> fp32 [B,Hq,Lq,Lk] with GQA
    head-grouping (query head h reads kv head h // (Hq//Hkv))."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq != hkv:
        qg = q.reshape(b, hkv, hq // hkv, lq, dh)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).reshape(b, hq, lq, lk)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    return s.float() * scale


def _block_pv(p, v, hq):
    """[B,Hq,Lq,Lk] probs x [B,Hkv,Lk,Dh] -> [B,Hq,Lq,Dh], GQA-grouped."""
    b, _, lq, lk = p.shape
    hkv = v.shape[1]
    if hq != hkv:
        pg = p.reshape(b, hkv, hq // hkv, lq, lk)
        return torch.einsum("bhgqk,bhkd->bhgqd", pg, v).reshape(b, hq, lq, v.shape[3])
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _ring_positions(my, src, n, lc, lk, striped, device):
    """Global positions of shard ``my``'s queries and block ``src``'s keys:
    contiguous (shard d holds tokens d*lc ...), or striped (local j on
    shard d is token j*n + d)."""
    qi = torch.arange(lc, device=device)
    ki = torch.arange(lk, device=device)
    if striped:
        return my + n * qi, src + n * ki
    return my * lc + qi, src * lc + ki


def ring_attention(q, k, v, causal: bool = False, bias=None, striped: bool = False):
    """Exact attention with k/v ring-rotated over the shards.

    ``q``, ``k``, ``v``: the N length shards ([B, H, L/N, Dh], shard ``j``
    on its device), in ring order; ``bias``: None or the N per-shard key
    biases [B, Lk/N] (fp32, -1e30 masks a key). Returns the N output
    shards in q's dtype. The online-softmax carry (running max ``m``,
    normaliser ``l``, accumulator ``o``) is rescaled as each block
    arrives, so the result is a softmax over the whole sequence, never
    holding L x L scores.

    ``striped=True`` maps positions to the striped layout: shard ``d``'s
    local index ``j`` is global token ``j*N + d``
    (:func:`make_striped_attention_fn` permutes the tokens at the seam).
    """
    n = len(q)
    devices = _devices(q)
    b, hq, lc, dh = q[0].shape
    lk = k[0].shape[2]
    scale = dh ** -0.5
    if bias is None:
        bias = _zero_bias(q, k)
    qf = [x.float() for x in q]
    o = [torch.zeros((b, hq, lc, dh), dtype=torch.float32, device=d) for d in devices]
    m = [torch.full((b, hq, lc), _NEG, dtype=torch.float32, device=d) for d in devices]
    l = [torch.zeros((b, hq, lc), dtype=torch.float32, device=d) for d in devices]
    held = [(k[j], v[j], bias[j].float()) for j in range(n)]
    # step 0 attends the local block; each later step first rotates, so
    # exactly n - 1 rotations are made
    for s in range(n):
        if s:
            held = _rotate(held, devices)
        for my in range(n):
            # after s rotations shard my holds the block of shard (my - s) mod n
            src = (my - s) % n
            if causal and not striped and src > my:
                # contiguous layout: a block wholly in this shard's future
                # is fully masked; skip its two matmuls
                continue
            k_cur, v_cur, b_cur = held[my]
            scores = _block_scores(qf[my], k_cur.float(), scale) + b_cur[:, None, None, :]
            if causal:
                q_pos, k_pos = _ring_positions(my, src, n, lc, lk, striped, devices[my])
                scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                                     torch.full_like(scores, _NEG))
            m_new = torch.maximum(m[my], scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            # fully masked entries: exp(NEG - NEG) == 1 must be zeroed
            p = torch.where(scores > _NEG / 2, p, torch.zeros_like(p))
            corr = torch.exp(m[my] - m_new)
            l[my] = l[my] * corr + p.sum(dim=-1)
            o[my] = o[my] * corr[..., None] + _block_pv(p, v_cur.float(), hq)
            m[my] = m_new
    return [(o[j] / l[j].clamp_min(1e-30)[..., None]).to(q[j].dtype) for j in range(n)]


# ======================================================================
# ring × flash


def _ring_combine(o, lse, blk_out, blk_lse):
    """Online combination of two normalised partial softmax results over
    disjoint key sets: (o, lse) ⊕ (blk_out, blk_lse). A block whose keys
    are all padding has lse near -1e30 and gets weight 0."""
    lse_new = torch.logaddexp(lse, blk_lse)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(blk_lse - lse_new)[..., None]
    return o * w_old + blk_out.float() * w_new, lse_new


def _groups(tensors, n):
    return [list(tensors[i * n:(i + 1) * n]) for i in range(len(tensors) // n)]


def _flash_ring_fwd(q, k, v, bias, causal):
    """The N out shards (q's dtype) and global lse shards (fp32)."""
    n = len(q)
    devices = _devices(q)
    o, lse = [], []
    for j in range(n):
        # the diagonal block: the only one that needs the causal mask inside
        o0, lse0 = flash_block_fwd(q[j], k[j], v[j], bias[j], causal)
        o.append(o0.float())
        lse.append(lse0)
    held = [(k[j], v[j], bias[j]) for j in range(n)]
    for s in range(1, n):
        held = _rotate(held, devices)
        for my in range(n):
            if causal and (my - s) % n > my:
                continue  # a block from the future is fully masked
            k_cur, v_cur, b_cur = held[my]
            blk_out, blk_lse = flash_block_fwd(q[my], k_cur, v_cur, b_cur, False)
            o[my], lse[my] = _ring_combine(o[my], lse[my], blk_out, blk_lse)
    return [o[j].to(q[j].dtype) for j in range(n)], lse


def _flash_ring_bwd(q, k, v, bias, out, dout, lse, causal):
    """(dq, dk, dv, dbias) shards: each block's flash backward against
    the global out and lse; dk/dv/dbias ride the ring with their block."""
    n = len(q)
    devices = _devices(q)
    dout = [d.contiguous() for d in dout]  # read by every block: copied once
    dq, acc = [], []
    for j in range(n):
        bdq, bdk, bdv, bdb = flash_block_bwd(q[j], k[j], v[j], bias[j], out[j], dout[j],
                                             lse[j], causal)
        dq.append(bdq.float())
        acc.append((bdk.float(), bdv.float(), bdb))
    held = [(k[j], v[j], bias[j]) for j in range(n)]
    for s in range(1, n):
        held = _rotate(held, devices)
        acc = _rotate(acc, devices)
        for my in range(n):
            if causal and (my - s) % n > my:
                continue
            k_cur, v_cur, b_cur = held[my]
            bdq, bdk, bdv, bdb = flash_block_bwd(q[my], k_cur, v_cur, b_cur, out[my],
                                                 dout[my], lse[my], False)
            dk_acc, dv_acc, db_acc = acc[my]
            dq[my] = dq[my] + bdq.float()
            acc[my] = (dk_acc + bdk.float(), dv_acc + bdv.float(), db_acc + bdb)
    # one last rotation brings each block's accumulated gradients home
    acc = _rotate(acc, devices)
    return ([dq[j].to(q[j].dtype) for j in range(n)],
            [acc[j][0].to(k[j].dtype) for j in range(n)],
            [acc[j][1].to(v[j].dtype) for j in range(n)],
            [acc[j][2].to(bias[j].dtype) for j in range(n)])


class _FlashRing(torch.autograd.Function):
    """Inputs: the shard count, causal, then the N shards each of q, k, v
    and the key bias. Outputs: the N out shards, then the N lse shards."""

    @staticmethod
    def forward(n, causal, *shards):
        q, k, v, bias = _groups(shards, n)
        out, lse = _flash_ring_fwd(q, k, v, bias, causal)
        return (*out, *lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.causal = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:], *output)
        ctx.mark_non_differentiable(*output[ctx.n:])

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        saved = ctx.saved_tensors
        grads = _FlashRingBackward.apply(n, ctx.causal, *saved[:4 * n],
                                         *saved[4 * n:5 * n], *grads[:n], *saved[5 * n:])
        return (None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, n, causal, *shards):
        folded = _fold(info, in_dims[2:], *shards)
        return _unfold(info.batch_size, _FlashRing.apply(n, causal, *folded)), (0,) * (2 * n)


class _FlashRingBackward(torch.autograd.Function):
    """Inputs: the shard count, causal, then the N shards each of q, k, v,
    bias, out, dout and lse. Outputs: the N shards each of dq, dk, dv and
    dbias."""

    @staticmethod
    def forward(n, causal, *shards):
        q, k, v, bias, out, dout, lse = _groups(shards, n)
        dq, dk, dv, db = _flash_ring_bwd(q, k, v, bias, out, dout, lse, causal)
        return (*dq, *dk, *dv, *db)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ring × flash has no second derivative")

    @staticmethod
    def vmap(info, in_dims, n, causal, *shards):
        folded = _fold(info, in_dims[2:], *shards)
        grads = _FlashRingBackward.apply(n, causal, *folded)
        return _unfold(info.batch_size, grads), (0,) * (4 * n)


def flash_ring_attention(q, k, v, causal: bool = False, bias=None):
    """Exact ring attention whose block math is the flash kernels.

    ``q``, ``k``, ``v``: the N length shards ([B, H, L/N, Dh], shard ``j``
    on its device) in ring order; ``bias``: None or the N per-shard key
    biases [B, Lk/N]. Returns the N output shards in q's dtype.
    Differentiable (the ring-level ``autograd.Function``), and composes
    with ``torch.func.vmap``/``grad``."""
    n = len(q)
    if bias is None:
        bias = _zero_bias(q, k)
    bias = [b.float() for b in bias]
    return list(_FlashRing.apply(n, causal, *q, *k, *v, *bias)[:n])


# ======================================================================
# Ulysses


def ulysses_attention(q, k, v, causal: bool = False, bias=None):
    """Exact attention by re-sharding heads against length.

    ``q``, ``k``, ``v``: the N length shards, shard ``j`` on its device.
    Device ``i`` gathers heads ``i*H/N ...`` of the whole sequence from
    every shard, runs the dense ``dot_product_attention`` on them, and the
    output is re-sharded back to length. The query and kv head counts must
    divide by N. ``bias`` (N per-shard key biases [B, Lk/N]) is gathered
    to the whole sequence on every device."""
    n = len(q)
    devices = _devices(q)
    hq, hkv = q[0].shape[1], k[0].shape[1]
    if hq % n or hkv % n:
        raise ValueError(f"Ulysses attention needs query and kv head counts divisible by "
                         f"{n}; got Hq={hq}, Hkv={hkv}")

    def to_heads(shards, i, h):
        """[B, H, L/N, Dh] on every shard -> [B, H/N, L, Dh] on device i."""
        w = h // n
        return torch.cat([x[:, i * w:(i + 1) * w].to(devices[i]) for x in shards], dim=2)

    outs = []
    for i in range(n):
        full_bias = None
        if bias is not None:
            full_bias = torch.cat([b.float().to(devices[i]) for b in bias], dim=1)
            full_bias = full_bias[:, None, None, :]
        outs.append(dot_product_attention(to_heads(q, i, hq), to_heads(k, i, hkv),
                                          to_heads(v, i, hkv), bias=full_bias, causal=causal))
    lc = q[0].shape[2]
    return [torch.cat([o[:, :, j * lc:(j + 1) * lc].to(devices[j]) for o in outs], dim=1)
            for j in range(n)]


# ======================================================================
# the seams: global [B, H, L, Dh] in and out


def _check_seam_bias(bias, b, lk):
    """The transformer seam passes additive key bias as [B, 1, 1, L]
    (transformer.py contract); flatten to the [B, L] the SP kernels
    shard."""
    if tuple(bias.shape) != (b, 1, 1, lk):
        raise ValueError(
            f"sequence-parallel attention supports per-key bias "
            f"[B, 1, 1, L] only; got {tuple(bias.shape)}"
        )
    return bias.reshape(b, lk)


def _shard(x, devices, dim):
    """``x`` split into len(devices) contiguous pieces along ``dim``, piece
    j on ``devices[j]`` and made contiguous there (once, not per step)."""
    return [piece.to(d).contiguous()
            for piece, d in zip(torch.chunk(x, len(devices), dim=dim), devices)]


def _seq_sharded_fn(kernel, mesh: Mesh, axis_name: str):
    """``fn(q, k, v, bias2d=None)`` on global tensors: shards [B, H, L, Dh]
    on L (and the [B, L] key bias with them) over ``mesh[axis_name]``, runs
    ``kernel`` on the shard lists, and gathers its output shards on q's
    device."""
    devices = mesh.axis_devices(axis_name)

    def sharded(q, k, v, bias2d=None):
        qs, ks, vs = (_shard(x, devices, 2) for x in (q, k, v))
        bs = None if bias2d is None else _shard(bias2d, devices, 1)
        outs = kernel(qs, ks, vs, bias=bs)
        return torch.cat([o.to(q.device) for o in outs], dim=2)

    return sharded


def _check_length(q, n, axis_name, what):
    if q.shape[2] % n:
        raise ValueError(f"{what} needs sequence length divisible by mesh axis "
                         f"{axis_name!r} size {n}; got L={q.shape[2]}")


def _bias2d(bias, q, k):
    return None if bias is None else _check_seam_bias(bias, q.shape[0], k.shape[2])


def make_ring_attention_fn(mesh: Mesh, axis_name: str = SEQ_AXIS):
    """An ``attention_fn`` for the model zoo: shards [B, H, L, Dh] over
    ``mesh[axis_name]`` on L and runs :func:`ring_attention`. The
    sequence length must be divisible by the axis size. Padded batches
    work: the [B, 1, 1, L] key bias is sharded with k/v and rotates around
    the ring."""

    def attention_fn(q, k, v, bias=None, causal=False):
        _check_length(q, mesh.shape[axis_name], axis_name, "ring attention")
        fn = _seq_sharded_fn(
            lambda qs, ks, vs, bias: ring_attention(qs, ks, vs, causal=causal, bias=bias),
            mesh, axis_name)
        return fn(q, k, v, _bias2d(bias, q, k))

    return attention_fn


def make_striped_attention_fn(mesh: Mesh, axis_name: str = SEQ_AXIS):
    """An ``attention_fn`` running causal ring attention in the striped
    (round-robin) token layout, the load-balanced form of causal sequence
    parallelism: token ``t`` goes to shard ``t % N``, so every (shard,
    rotated block) pair carries about half a block of unmasked work. The
    permutation into and out of striped order happens here at the seam;
    positions inside the kernel are mapped accordingly, so the result
    equals dense causal attention. Non-causal calls go to the plain ring
    (striping buys nothing without a triangular mask)."""
    plain_ring = make_ring_attention_fn(mesh, axis_name)

    def attention_fn(q, k, v, bias=None, causal=False):
        n = mesh.shape[axis_name]
        l = q.shape[2]
        _check_length(q, n, axis_name, "striped attention")
        if not causal:
            return plain_ring(q, k, v, bias=bias, causal=False)
        # stripe: token j*n + d -> contiguous slot (d, j), so the
        # contiguous shards hand shard d exactly its stripe
        perm = torch.arange(l, device=q.device).reshape(l // n, n).T.reshape(l)
        inv = torch.argsort(perm)
        qs, ks, vs = (x[:, :, perm, :] for x in (q, k, v))
        fn = _seq_sharded_fn(
            lambda qs, ks, vs, bias: ring_attention(qs, ks, vs, causal=True, bias=bias,
                                                    striped=True),
            mesh, axis_name)
        b2 = _bias2d(bias, q, k)
        out = fn(qs, ks, vs, None if b2 is None else b2[:, perm])
        return out[:, :, inv, :]

    return attention_fn


def make_flash_ring_attention_fn(mesh: Mesh, axis_name: str = SEQ_AXIS):
    """An ``attention_fn`` for the model zoo backed by
    :func:`flash_ring_attention`: sequence parallelism over
    ``mesh[axis_name]`` with the flash kernels doing each shard's block
    math, the long-context configuration. The kernels pick their own
    tiles, so there are no block sizes to give."""

    def attention_fn(q, k, v, bias=None, causal=False):
        _check_length(q, mesh.shape[axis_name], axis_name, "ring attention")
        fn = _seq_sharded_fn(
            lambda qs, ks, vs, bias: flash_ring_attention(qs, ks, vs, causal=causal, bias=bias),
            mesh, axis_name)
        return fn(q, k, v, _bias2d(bias, q, k))

    return attention_fn


def make_ulysses_attention_fn(mesh: Mesh, axis_name: str = SEQ_AXIS):
    """An ``attention_fn`` for the model zoo backed by
    :func:`ulysses_attention`. Head counts must be divisible by the axis
    size. Padded batches work: the per-key bias shards are gathered next
    to the head re-shard."""

    def attention_fn(q, k, v, bias=None, causal=False):
        n = mesh.shape[axis_name]
        hq, hkv = q.shape[1], k.shape[1]
        if hq % n or hkv % n:
            raise ValueError(
                f"Ulysses attention needs query AND kv head counts "
                f"divisible by mesh axis {axis_name!r} size {n}; got "
                f"Hq={hq}, Hkv={hkv} (use ring attention for GQA models "
                f"whose kv heads don't divide)"
            )
        _check_length(q, n, axis_name, "Ulysses attention")
        fn = _seq_sharded_fn(
            lambda qs, ks, vs, bias: ulysses_attention(qs, ks, vs, causal=causal, bias=bias),
            mesh, axis_name)
        return fn(q, k, v, _bias2d(bias, q, k))

    return attention_fn
