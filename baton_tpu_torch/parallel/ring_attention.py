"""Sequence parallelism: ring attention, ring × flash, Ulysses and striped
attention over a device mesh (counterpart of
``baton_tpu/parallel/ring_attention.py``).

The JAX module runs each kernel inside ``shard_map`` on length shards,
with ``lax.ppermute`` and ``lax.all_to_all`` between devices, on any mesh:
one whose ``seq`` axis spans hosts too. Here a process drives the shards of
the mesh axis that it holds (``Mesh.local_shards``): a kernel takes this
process's shards of q, k, v (and of the per-key bias) as lists, shard ``j``
on the ``j``-th device of the axis, and returns its output shards. In one
process that is every shard. On a mesh whose axis spans processes
(``multihost.make_hybrid_mesh([], dcn_axis="seq")``) each process computes
only the shards it holds, and the blocks cross the process boundary through
``torch.distributed``.

Every move of a block between shards is one exchange (:class:`_Exchange`),
an ``autograd.Function`` whose backward is the transposed exchange and
whose ``vmap`` rule folds the batch axis into the blocks', so every kernel
differentiates and vmaps across processes as in one:

* the ring's step (:class:`_Step`): the block held by shard ``j`` moves to
  shard ``j + 1``; by ``.to()`` inside a process, while across the
  boundary a process's last shard sends to the next process's first and its
  first receives from the previous process's last, all of a step's sends
  and receives posted in one ``batch_isend_irecv``. Every process takes part
  in every step, also one whose blocks are all skipped at that step; the
  backward sends the gradient the other way.
* the seams' shard-in and gather (:class:`_Scatter`, :class:`_Gather`):
  every process holds the global [B, H, L, Dh] tensors (what lies outside
  attention is computed on each, on the same values). The shard-in takes
  this process's slices, and its backward all-gathers their gradients; the
  gather all-gathers the output shards, and its backward is this process's
  slice of the gradient, which every process holds whole (not a
  reduce-scatter, which would multiply it by the number of processes).
* Ulysses' re-shard (:class:`_Reshard`): heads against length, inside a
  process by ``.to()``, across processes by one ``all_to_all_single``.

A gloo group (two processes on one card: NCCL refuses two ranks on one
device) stages CUDA blocks through host memory; an nccl group sends them
from the card. A transport that fails raises: nothing carries on in one
process. ``transport_counts`` holds the bytes this process sent to others
and the seconds its exchanges took.

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
  with their block and one last rotation bringing them home. Its ``vmap``
  rule folds a client axis into the kernels' batch axis, so
  ``torch.func.vmap(grad(...))`` (``LocalTrainer``) runs one kernel launch
  per block for every client.
* **Ulysses** (:func:`ulysses_attention`): a re-shard of heads against
  length, dense attention over the whole sequence for H/N heads on each
  shard, and back. Head counts must divide by N.
* **Striped** (:func:`make_striped_attention_fn`): causal ring attention
  with token ``t`` on shard ``t % N`` (load-balanced), permuted at the
  seam; the dense ring kernel (there is no striped flash).

Every seam (``make_*_attention_fn``) takes and returns global
[B, H, L, Dh] tensors, the model zoo's ``attention_fn`` contract: it
splits L into N contiguous shards, runs the kernel on this process's and
gathers the output on the caller's device. Additive per-key padding biases
[B, 1, 1, L] are supported.
"""

from __future__ import annotations

import time
from collections import Counter
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

# what this process's exchanges with other processes moved: the bytes it
# sent, the exchanges, and their seconds (staging copies included, timed
# between two synchronisations of the card)
transport_counts = {"bytes": 0, "exchanges": 0, "seconds": 0.0}


def reset_transport_counts() -> None:
    transport_counts.update(bytes=0, exchanges=0, seconds=0.0)


# ======================================================================
# where the shards live, and the exchanges between them


class _Ring:
    """The shards of one sequence axis: its size ``n``, the global index
    and device of each shard this process holds (``index``, ``devices``),
    the rank of the process that holds each of the ``n`` shards
    (``owners``), this process's rank and the process group (None: the
    default group)."""

    def __init__(self, n: int, index: Sequence[int], devices: Sequence[torch.device],
                 owners: Sequence[int], rank: int = 0, group=None):
        self.n, self.index, self.devices = n, list(index), list(devices)
        self.owners, self.rank, self.group = list(owners), rank, group
        self.pos = {j: i for i, j in enumerate(self.index)}
        self.spans = len(set(self.owners)) > 1

    @classmethod
    def of(cls, mesh: Mesh, axis_name: str) -> "_Ring":
        """The ring of ``mesh[axis_name]`` as this process sees it."""
        owners = mesh.axis_process_ids(axis_name)
        held = Counter(owners)
        if len(set(held.values())) > 1:
            raise ValueError(f"mesh axis {axis_name!r} gives its processes unequal shard "
                             f"counts {dict(held)}")
        if len(held) > 1 and sorted(held) != list(range(
                _dist().get_world_size(mesh.process_group))):
            raise ValueError(f"mesh axis {axis_name!r} crosses processes {sorted(held)}, not "
                             "every process of its group")
        local = mesh.local_shards(axis_name)
        return cls(mesh.shape[axis_name], [j for j, _ in local], [d for _, d in local], owners,
                   mesh.process_index, mesh.process_group)

    def shards_of(self, rank: int) -> list:
        return [j for j, p in enumerate(self.owners) if p == rank]

    def processes(self) -> list:
        return sorted(set(self.owners))


def _ring_of(shards, mesh: Optional[Mesh], axis_name: str) -> _Ring:
    """The ring that ``shards`` (this process's) lie on: ``mesh[axis_name]``,
    or without a mesh every shard in this process, each on its own
    device."""
    if mesh is None:
        devices = [x.device for x in shards]
        return _Ring(len(devices), range(len(devices)), devices, [0] * len(devices))
    ring = _Ring.of(mesh, axis_name)
    if len(shards) != len(ring.index):
        raise ValueError(f"process {ring.rank} holds {len(ring.index)} shards of mesh axis "
                         f"{axis_name!r}, got {len(shards)}")
    return ring


def _dist():
    import torch.distributed as dist

    return dist


def _gloo(ring: _Ring) -> bool:
    return _dist().get_backend(ring.group) == "gloo"


def _staged(ring: _Ring, x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, where the group's backend reads it: host memory
    for gloo (which cannot read CUDA memory), the card for nccl."""
    x = x.contiguous()
    return x.cpu() if _gloo(ring) else x


def _buffer(ring: _Ring, like: torch.Tensor) -> torch.Tensor:
    """An empty tensor shaped as ``like`` where the backend writes it."""
    return torch.empty(like.shape, dtype=like.dtype,
                       device="cpu" if _gloo(ring) else like.device)


def _peer(ring: _Ring, rank: int) -> int:
    return rank if ring.group is None else _dist().get_global_rank(ring.group, rank)


def _across(ring: _Ring, nbytes: int, run):
    """``run()``, an exchange with other processes, counted and timed in
    ``transport_counts`` (the card synchronised before and after: a staged
    copy would wait for it either way)."""
    cuda = {d for d in ring.devices if d.type == "cuda"}
    for d in cuda:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = run()
    for d in cuda:
        torch.cuda.synchronize(d)
    transport_counts["seconds"] += time.perf_counter() - t0
    transport_counts["bytes"] += nbytes
    transport_counts["exchanges"] += 1
    return out


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


class _Step:
    """The ring's step: each local shard's block (its ``len(xs) / shards``
    tensors, in ``xs`` shard-major) moves from shard ``j`` to shard
    ``(j + shift) mod n``."""

    def __init__(self, ring: _Ring, shift: int):
        self.ring, self.shift = ring, shift

    def transpose(self) -> "_Step":
        return _Step(self.ring, -self.shift)

    def __call__(self, xs: list) -> list:
        ring = self.ring
        width = len(xs) // len(ring.index)
        held = [xs[i * width:(i + 1) * width] for i in range(len(ring.index))]
        out = [None] * len(held)
        sends, recvs = [], []
        for i, j in enumerate(ring.index):
            dst = (j + self.shift) % ring.n
            if dst in ring.pos:
                t = ring.pos[dst]
                out[t] = [x.to(ring.devices[t], non_blocking=True) for x in held[i]]
            else:
                sends.append((dst, held[i]))
        for t, j in enumerate(ring.index):
            src = (j - self.shift) % ring.n
            if src not in ring.pos:
                recvs.append((j, t, src))
        if sends or recvs:
            _send_and_receive(ring, sends, recvs, held, out)
        return [x for block in out for x in block]


def _send_and_receive(ring: _Ring, sends, recvs, held, out) -> None:
    """Post every send (``(destination shard, block)``) and receive
    (``(shard, local position, source shard)``) of one step in one
    ``batch_isend_irecv`` and wait for them; a received block lands in
    ``out`` at its shard's local position. Both sides order a pair's
    messages by the destination shard, so they match on every backend."""
    dist = _dist()
    ops, landed = [], []
    for dst, block in sorted(sends, key=lambda s: s[0]):
        peer = _peer(ring, ring.owners[dst])
        ops += [dist.P2POp(dist.isend, _staged(ring, x), peer, ring.group) for x in block]
    for j, t, src in sorted(recvs):
        bufs = [_buffer(ring, x) for x in held[t]]
        peer = _peer(ring, ring.owners[src])
        ops += [dist.P2POp(dist.irecv, b, peer, ring.group) for b in bufs]
        landed.append((t, bufs))

    def run():
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for t, bufs in landed:
            out[t] = [b.to(ring.devices[t]) for b in bufs]

    _across(ring, sum(_nbytes(block) for _, block in sends), run)


class _Scatter:
    """The seam's shard-in: global tensors -> this process's shards of
    each along its dim (tensor-major: every local shard of the first, then
    of the next). ``devices`` are the global tensors' devices, where the
    transpose (:class:`_Gather`) puts their gradients."""

    def __init__(self, ring: _Ring, dims: Sequence[int], devices: Sequence[torch.device]):
        self.ring, self.dims, self.devices = ring, tuple(dims), tuple(devices)

    def transpose(self) -> "_Gather":
        return _Gather(self.ring, self.dims, self.devices)

    def __call__(self, xs: list) -> list:
        out = []
        for x, dim in zip(xs, self.dims):
            size = x.shape[dim] // self.ring.n
            out += [x.narrow(dim, j * size, size).to(d).contiguous()
                    for j, d in zip(self.ring.index, self.ring.devices)]
        return out


class _Gather:
    """The seam's gather: this process's shards of each tensor
    (tensor-major) -> each whole tensor along its dim on its device in
    ``devices``; the other processes' shards come by one ``all_gather`` a
    tensor."""

    def __init__(self, ring: _Ring, dims: Sequence[int], devices: Sequence[torch.device]):
        self.ring, self.dims, self.devices = ring, tuple(dims), tuple(devices)

    def transpose(self) -> _Scatter:
        return _Scatter(self.ring, self.dims, self.devices)

    def __call__(self, xs: list) -> list:
        k = len(self.ring.index)
        out = []
        for t, (dim, device) in enumerate(zip(self.dims, self.devices)):
            shards = xs[t * k:(t + 1) * k]
            if self.ring.spans:
                shards = _all_gather(self.ring, shards, dim)
            out.append(torch.cat([s.to(device) for s in shards], dim))
        return out


def _all_gather(ring: _Ring, shards: list, dim: int) -> list:
    """Every shard of the axis in shard order: this process's ``shards``
    and the others', by one ``all_gather`` of each process's shards
    concatenated along ``dim``."""
    dist = _dist()
    mine = _staged(ring, torch.cat([s.to(ring.devices[0]) for s in shards], dim))
    procs = ring.processes()
    bufs = [torch.empty_like(mine) for _ in procs]
    _across(ring, _nbytes([mine]) * (len(procs) - 1),
            lambda: dist.all_gather(bufs, mine, group=ring.group))
    by_shard = dict(zip(ring.index, shards))
    for p, buf in zip(procs, bufs):
        if p != ring.rank:
            by_shard.update(zip(ring.shards_of(p), torch.chunk(buf, len(shards), dim)))
    return [by_shard[j] for j in range(ring.n)]


class _Reshard:
    """Ulysses' re-shard over the axis's n shards. ``to_heads`` takes each
    shard's [B, H, L/n, D] to head group ``g``'s [B, H/n, L, D] on shard
    ``g``; the transpose takes them back. Each (source, destination) pair
    of shards trades one [B, H/n, L/n, D] piece: inside a process by
    ``.to()``, across processes by one ``all_to_all_single``."""

    def __init__(self, ring: _Ring, to_heads: bool):
        self.ring, self.to_heads = ring, to_heads

    def transpose(self) -> "_Reshard":
        return _Reshard(self.ring, not self.to_heads)

    def piece(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """What the shard holding ``x`` sends to shard ``g``."""
        if self.to_heads:
            w = x.shape[1] // self.ring.n
            return x[:, g * w:(g + 1) * w]
        lc = x.shape[2] // self.ring.n
        return x[:, :, g * lc:(g + 1) * lc]

    def __call__(self, xs: list) -> list:
        ring = self.ring
        got = {(g, j): self.piece(x, g) for x, j in zip(xs, ring.index) for g in ring.index}
        if ring.spans:
            got.update(_all_to_all(ring, xs, self.piece))
        dim = 2 if self.to_heads else 1
        return [torch.cat([got[g, j].to(d) for j in range(ring.n)], dim)
                for g, d in zip(ring.index, ring.devices)]


def _all_to_all(ring: _Ring, xs: list, piece) -> dict:
    """The pieces the other processes' shards send to this process's:
    ``{(destination shard, source shard): piece}``, by one
    ``all_to_all_single`` of every process's pieces stacked by destination
    process, its shards, then the source shards."""
    dist = _dist()
    procs, k = ring.processes(), len(ring.index)
    send = _staged(ring, torch.stack([piece(x, g).to(ring.devices[0]) for p in procs
                                      for g in ring.shards_of(p) for x in xs]))
    recv = torch.empty_like(send)
    _across(ring, _nbytes([send]) * (len(procs) - 1) // len(procs),
            lambda: dist.all_to_all_single(recv, send, group=ring.group))
    recv = recv.reshape(len(procs), k, k, *send.shape[1:])
    return {(g, j): recv[p, a, b]
            for p, proc in enumerate(procs) if proc != ring.rank
            for a, g in enumerate(ring.index)
            for b, j in enumerate(ring.shards_of(proc))}


class _Keep:
    """The first ``m`` tensors as they are, the rest dropped. The dense
    ring passes its last step's blocks through it beside its output, so
    every process's backward reaches every step's exchange (and takes part
    in it), also a process that used none of the last step's blocks. The
    dropped tensors' gradients are zero."""

    def __init__(self, m: int):
        self.m = m

    def transpose(self) -> "_Keep":
        return self

    def __call__(self, xs: list) -> list:
        return [x.view_as(x) for x in xs[:self.m]]


class _Exchange(torch.autograd.Function):
    """``move`` (:class:`_Step`, :class:`_Scatter`, :class:`_Gather`,
    :class:`_Reshard`, :class:`_Keep`) applied to tensors: a linear map
    that only moves data, so its backward is the transposed move, itself an
    ``_Exchange`` (any order of derivative, under ``vmap`` too)."""

    @staticmethod
    def forward(move, *xs):
        return tuple(move(list(xs)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.move, ctx.n_in = inputs[0], len(inputs) - 1

    @staticmethod
    def backward(ctx, *grads):
        back = _Exchange.apply(ctx.move.transpose(), *grads)
        return (None, *back, *[None] * (ctx.n_in - len(back)))

    @staticmethod
    def vmap(info, in_dims, move, *xs):
        out = _Exchange.apply(move, *_fold(info, in_dims[1:], *xs))
        return _unfold(info.batch_size, out), (0,) * len(out)


def _blocks(flat: Sequence[torch.Tensor], width: int) -> list:
    return [tuple(flat[i:i + width]) for i in range(0, len(flat), width)]


def _flat(blocks) -> list:
    return [x for block in blocks for x in block]


def _rotate(ring: _Ring, held: list) -> list:
    """One differentiable step of the ring: ``held[i]`` (a tuple of
    tensors on local shard ``i``) moves to the next shard."""
    return _blocks(_Exchange.apply(_Step(ring, 1), *_flat(held)), len(held[0]))


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


def ring_attention(q, k, v, causal: bool = False, bias=None, striped: bool = False,
                   mesh: Optional[Mesh] = None, axis_name: str = SEQ_AXIS):
    """Exact attention with k/v ring-rotated over the shards.

    ``q``, ``k``, ``v``: this process's length shards of ``mesh[axis_name]``
    ([B, H, L/N, Dh], in shard order, each on its device; without a mesh,
    all N shards, in ring order); ``bias``: None or the same shards of the
    per-key biases [B, Lk/N] (fp32, -1e30 masks a key). Returns the output
    shards in q's dtype. The online-softmax carry (running max ``m``,
    normaliser ``l``, accumulator ``o``) is rescaled as each block arrives,
    so the result is a softmax over the whole sequence, never holding
    L x L scores.

    ``striped=True`` maps positions to the striped layout: shard ``d``'s
    local index ``j`` is global token ``j*N + d``
    (:func:`make_striped_attention_fn` permutes the tokens at the seam).
    """
    ring = _ring_of(q, mesh, axis_name)
    n = ring.n
    b, hq, lc, dh = q[0].shape
    lk = k[0].shape[2]
    scale = dh ** -0.5
    if bias is None:
        bias = _zero_bias(q, k)
    qf = [x.float() for x in q]
    o = [torch.zeros((b, hq, lc, dh), dtype=torch.float32, device=d) for d in ring.devices]
    m = [torch.full((b, hq, lc), _NEG, dtype=torch.float32, device=d) for d in ring.devices]
    l = [torch.zeros((b, hq, lc), dtype=torch.float32, device=d) for d in ring.devices]
    held = [(k[i], v[i], bias[i].float()) for i in range(len(q))]
    # step 0 attends the local block; each later step first rotates, so
    # exactly n - 1 rotations are made
    for s in range(n):
        if s:
            held = _rotate(ring, held)
        for i, my in enumerate(ring.index):
            # after s rotations shard my holds the block of shard (my - s) mod n
            src = (my - s) % n
            if causal and not striped and src > my:
                # contiguous layout: a block wholly in this shard's future
                # is fully masked; skip its two matmuls
                continue
            k_cur, v_cur, b_cur = held[i]
            scores = _block_scores(qf[i], k_cur.float(), scale) + b_cur[:, None, None, :]
            if causal:
                q_pos, k_pos = _ring_positions(my, src, n, lc, lk, striped, ring.devices[i])
                scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                                     torch.full_like(scores, _NEG))
            m_new = torch.maximum(m[i], scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            # fully masked entries: exp(NEG - NEG) == 1 must be zeroed
            p = torch.where(scores > _NEG / 2, p, torch.zeros_like(p))
            corr = torch.exp(m[i] - m_new)
            l[i] = l[i] * corr + p.sum(dim=-1)
            o[i] = o[i] * corr[..., None] + _block_pv(p, v_cur.float(), hq)
            m[i] = m_new
    out = [(o[i] / l[i].clamp_min(1e-30)[..., None]).to(q[i].dtype) for i in range(len(q))]
    return list(_Exchange.apply(_Keep(len(out)), *out, *_flat(held)))


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


def _flash_ring_fwd(ring, q, k, v, bias, causal):
    """This process's out shards (q's dtype) and global lse shards (fp32)."""
    n = ring.n
    o, lse = [], []
    for i in range(len(q)):
        # the diagonal block: the only one that needs the causal mask inside
        o0, lse0 = flash_block_fwd(q[i], k[i], v[i], bias[i], causal)
        o.append(o0.float())
        lse.append(lse0)
    step = _Step(ring, 1)
    held = [(k[i], v[i], bias[i]) for i in range(len(q))]
    for s in range(1, n):
        held = _blocks(step(_flat(held)), 3)
        for i, my in enumerate(ring.index):
            if causal and (my - s) % n > my:
                continue  # a block from the future is fully masked
            k_cur, v_cur, b_cur = held[i]
            blk_out, blk_lse = flash_block_fwd(q[i], k_cur, v_cur, b_cur, False)
            o[i], lse[i] = _ring_combine(o[i], lse[i], blk_out, blk_lse)
    return [o[i].to(q[i].dtype) for i in range(len(q))], lse


def _flash_ring_bwd(ring, q, k, v, bias, out, dout, lse, causal):
    """(dq, dk, dv, dbias) of this process's shards: each block's flash
    backward against the global out and lse; dk/dv/dbias ride the ring
    with their block."""
    n = ring.n
    dout = [d.contiguous() for d in dout]  # read by every block: copied once
    dq, acc = [], []
    for i in range(len(q)):
        bdq, bdk, bdv, bdb = flash_block_bwd(q[i], k[i], v[i], bias[i], out[i], dout[i],
                                             lse[i], causal)
        dq.append(bdq.float())
        acc.append((bdk.float(), bdv.float(), bdb))
    step = _Step(ring, 1)
    held = [(k[i], v[i], bias[i]) for i in range(len(q))]
    for s in range(1, n):
        # a block and its accumulators move in one exchange
        moved = _blocks(step(_flat(h + a for h, a in zip(held, acc))), 6)
        held, acc = [m[:3] for m in moved], [m[3:] for m in moved]
        for i, my in enumerate(ring.index):
            if causal and (my - s) % n > my:
                continue
            k_cur, v_cur, b_cur = held[i]
            bdq, bdk, bdv, bdb = flash_block_bwd(q[i], k_cur, v_cur, b_cur, out[i],
                                                 dout[i], lse[i], False)
            dk_acc, dv_acc, db_acc = acc[i]
            dq[i] = dq[i] + bdq.float()
            acc[i] = (dk_acc + bdk.float(), dv_acc + bdv.float(), db_acc + bdb)
    # one last rotation brings each block's accumulated gradients home
    acc = _blocks(step(_flat(acc)), 3)
    return ([dq[i].to(q[i].dtype) for i in range(len(q))],
            [acc[i][0].to(k[i].dtype) for i in range(len(q))],
            [acc[i][1].to(v[i].dtype) for i in range(len(q))],
            [acc[i][2].to(bias[i].dtype) for i in range(len(q))])


class _FlashRing(torch.autograd.Function):
    """Inputs: the ring, causal, then this process's shards each of q, k,
    v and the key bias. Outputs: its out shards, then its lse shards."""

    @staticmethod
    def forward(ring, causal, *shards):
        q, k, v, bias = _groups(shards, len(ring.index))
        out, lse = _flash_ring_fwd(ring, q, k, v, bias, causal)
        return (*out, *lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ring, ctx.causal = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:], *output)
        ctx.mark_non_differentiable(*output[len(ctx.ring.index):])

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.ring.index)
        saved = ctx.saved_tensors
        grads = _FlashRingBackward.apply(ctx.ring, ctx.causal, *saved[:4 * n],
                                         *saved[4 * n:5 * n], *grads[:n], *saved[5 * n:])
        return (None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, ring, causal, *shards):
        folded = _fold(info, in_dims[2:], *shards)
        out = _FlashRing.apply(ring, causal, *folded)
        return _unfold(info.batch_size, out), (0,) * len(out)


class _FlashRingBackward(torch.autograd.Function):
    """Inputs: the ring, causal, then this process's shards each of q, k,
    v, bias, out, dout and lse. Outputs: its shards each of dq, dk, dv and
    dbias."""

    @staticmethod
    def forward(ring, causal, *shards):
        q, k, v, bias, out, dout, lse = _groups(shards, len(ring.index))
        dq, dk, dv, db = _flash_ring_bwd(ring, q, k, v, bias, out, dout, lse, causal)
        return (*dq, *dk, *dv, *db)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ring × flash has no second derivative")

    @staticmethod
    def vmap(info, in_dims, ring, causal, *shards):
        folded = _fold(info, in_dims[2:], *shards)
        grads = _FlashRingBackward.apply(ring, causal, *folded)
        return _unfold(info.batch_size, grads), (0,) * len(grads)


def flash_ring_attention(q, k, v, causal: bool = False, bias=None,
                         mesh: Optional[Mesh] = None, axis_name: str = SEQ_AXIS):
    """Exact ring attention whose block math is the flash kernels.

    ``q``, ``k``, ``v``: this process's length shards of ``mesh[axis_name]``
    ([B, H, L/N, Dh], in shard order, each on its device; without a mesh,
    all N shards, in ring order); ``bias``: None or the same shards of the
    per-key biases [B, Lk/N]. Returns the output shards in q's dtype.
    Differentiable (the ring-level ``autograd.Function``), and composes
    with ``torch.func.vmap``/``grad``."""
    ring = _ring_of(q, mesh, axis_name)
    if bias is None:
        bias = _zero_bias(q, k)
    bias = [b.float() for b in bias]
    return list(_FlashRing.apply(ring, causal, *q, *k, *v, *bias)[:len(q)])


# ======================================================================
# Ulysses


def ulysses_attention(q, k, v, causal: bool = False, bias=None,
                      mesh: Optional[Mesh] = None, axis_name: str = SEQ_AXIS):
    """Exact attention by re-sharding heads against length.

    ``q``, ``k``, ``v``: this process's length shards of ``mesh[axis_name]``
    (without a mesh, all N shards), each on its device. Shard ``i`` gathers
    heads ``i*H/N ...`` of the whole sequence from every shard, runs the
    dense ``dot_product_attention`` on them, and the output is re-sharded
    back to length. The query and kv head counts must divide by N.
    ``bias`` (the same shards of the per-key biases [B, Lk/N]) reaches
    every shard whole: each shard's part goes to every head group as a
    head of its own."""
    ring = _ring_of(q, mesh, axis_name)
    n = ring.n
    hq, hkv = q[0].shape[1], k[0].shape[1]
    if hq % n or hkv % n:
        raise ValueError(f"Ulysses attention needs query and kv head counts divisible by "
                         f"{n}; got Hq={hq}, Hkv={hkv}")

    def to_heads(shards):
        """[B, H, L/N, Dh] on each shard -> [B, H/N, L, Dh] on each."""
        return list(_Exchange.apply(_Reshard(ring, True), *shards))

    biases = [None] * len(q)
    if bias is not None:
        # n copies of each shard's keys' bias, one a head group: [B, n, L/N, 1]
        copies = [b.float()[:, None, :, None].expand(b.shape[0], n, b.shape[1], 1)
                  for b in bias]
        biases = [fb.reshape(fb.shape[0], 1, 1, -1) for fb in to_heads(copies)]
    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    outs = [dot_product_attention(qh[i], kh[i], vh[i], bias=biases[i], causal=causal)
            for i in range(len(q))]
    return list(_Exchange.apply(_Reshard(ring, False), *outs))


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


def _seq_sharded_fn(kernel, mesh: Mesh, axis_name: str):
    """``fn(q, k, v, bias2d=None)`` on global tensors: takes this
    process's shards of [B, H, L, Dh] on L (and of the [B, L] key bias with
    them) over ``mesh[axis_name]``, runs ``kernel`` on the shard lists, and
    gathers its output shards, every process's, on q's device."""
    ring = _Ring.of(mesh, axis_name)

    def sharded(q, k, v, bias2d=None):
        xs = [q, k, v] + ([] if bias2d is None else [bias2d])
        shards = _Exchange.apply(_Scatter(ring, (2, 2, 2, 1)[:len(xs)], [x.device for x in xs]),
                                 *xs)
        qs, ks, vs, *bs = _groups(shards, len(ring.index))
        outs = kernel(qs, ks, vs, bias=bs[0] if bs else None, mesh=mesh, axis_name=axis_name)
        return _Exchange.apply(_Gather(ring, (2,), (q.device,)), *outs)[0]

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
            lambda qs, ks, vs, **kw: ring_attention(qs, ks, vs, causal=causal, **kw),
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
            lambda qs, ks, vs, **kw: ring_attention(qs, ks, vs, causal=True, striped=True, **kw),
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
            lambda qs, ks, vs, **kw: flash_ring_attention(qs, ks, vs, causal=causal, **kw),
            mesh, axis_name)
        return fn(q, k, v, _bias2d(bias, q, k))

    return attention_fn


def make_ulysses_attention_fn(mesh: Mesh, axis_name: str = SEQ_AXIS):
    """An ``attention_fn`` for the model zoo backed by
    :func:`ulysses_attention`. Head counts must be divisible by the axis
    size. Padded batches work: every head group gets every shard's per-key
    bias beside the head re-shard."""

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
            lambda qs, ks, vs, **kw: ulysses_attention(qs, ks, vs, causal=causal, **kw),
            mesh, axis_name)
        return fn(q, k, v, _bias2d(bias, q, k))

    return attention_fn
