"""Child process of ``tests/test_torch_ring_multiprocess.py`` (not a test
module): ``python _torch_ring_child.py <coordinator host:port> <n> <rank>
<out dir>``.

Each process holds 2 CPU shards of a ``seq`` axis of 4 that crosses the
process boundary (``make_hybrid_mesh([], dcn_axis="seq", devices=[cpu] *
2)``) and joins one gloo group. On the same numpy inputs as the parent
(:func:`case_arrays`) it runs every case of :data:`CASES` through the
port's seams (the dense ring, ring × flash on its plain path, striped,
Ulysses): the output and the vjp of a drawn cotangent for q, k, v and the
padding bias; the flash ring under ``torch.func.vmap(grad)`` over 2
clients; one training step of a 2-layer Llama decoder per attention kind
(:data:`LLAMA`); and the block calls each process makes. Writes
``rank<r>.npz`` to the out dir and prints one JSON line; the process group
is destroyed on every exit. Imports torch and the port only."""

import json
import sys
from pathlib import Path

import numpy as np
import torch

SHARDS_A_PROCESS = 2
AXIS = 4  # the seq axis: 2 processes x 2 shards

# kind, b, hq, hkv, l, d, causal, valid key lengths by row (None: no bias), dtype;
# rows with few valid keys leave whole shards of padding
CASES = {
    "ring": ("ring", 2, 4, 4, 32, 8, False, None, "float32"),
    "ring_causal_gqa_bias": ("ring", 2, 8, 2, 32, 8, True, (5, 32), "float32"),
    "flash": ("flash", 2, 4, 4, 32, 8, False, None, "float32"),
    "flash_causal_gqa_bias": ("flash", 2, 4, 2, 32, 8, True, (3, 29), "float32"),
    "flash_bias": ("flash", 2, 4, 4, 32, 8, False, (7, 24), "float32"),
    "flash_bf16_causal": ("flash", 1, 4, 2, 32, 8, True, (20,), "bfloat16"),
    "striped_causal_gqa_bias": ("striped", 2, 8, 2, 32, 8, True, (7, 32), "float32"),
    "striped_not_causal": ("striped", 1, 4, 4, 32, 8, False, None, "float32"),
    "ulysses": ("ulysses", 2, 4, 4, 32, 8, False, None, "float32"),
    "ulysses_causal_gqa_bias": ("ulysses", 2, 8, 4, 32, 8, True, (6, 30), "float32"),
}

# the Llama step's attention kinds and their heads (Ulysses needs both
# head counts divisible by the axis)
LLAMA = {"flash": (4, 2), "ring": (4, 2), "ulysses": (4, 4)}
LLAMA_LR = 0.05


def case_arrays(name):
    """The case's q, k, v, cotangent (fp32) and [B, 1, 1, L] bias or None."""
    _, b, hq, hkv, l, d, _, lengths, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((b, hq, l, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, l, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, hq, l, d)).astype(np.float32)
    bias = None
    if lengths is not None:
        valid = np.arange(l)[None, :] < np.asarray(lengths)[:, None]
        bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, None, :]
    return q, k, v, dout, bias


def ring_module():
    """The module (the package exports a function of the same name)."""
    import importlib

    return importlib.import_module("baton_tpu_torch.parallel.ring_attention")


def attention_fn(kind, mesh):
    ra = ring_module()
    return {"ring": ra.make_ring_attention_fn, "flash": ra.make_flash_ring_attention_fn,
            "striped": ra.make_striped_attention_fn,
            "ulysses": ra.make_ulysses_attention_fn}[kind](mesh)


def run_case(name, mesh) -> dict:
    """The case's output and its vjp for q, k, v (and the bias), as fp32
    numpy arrays."""
    kind, *_, causal, _, dtype = CASES[name]
    q, k, v, dout, bias = case_arrays(name)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    if bias is not None:
        args.append(torch.from_numpy(bias).requires_grad_())
    out = attention_fn(kind, mesh)(*args[:3], bias=args[3] if bias is not None else None,
                                   causal=causal)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dout).to(td))
    res = {"out": out}
    res.update(zip(("dq", "dk", "dv", "dbias"), grads))
    return {k: t.detach().float().numpy() for k, t in res.items()}


def vmap_arrays():
    rng = np.random.default_rng(99)
    q = rng.normal(size=(2, 2, 4, 16, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 2, 16, 8)).astype(np.float32) for _ in range(2))
    valid = np.arange(16)[None, :] < np.array([5, 16])[:, None]
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, None, :]
    return q, k, v, bias


def run_vmap_grad(mesh) -> dict:
    """The flash ring under ``vmap(grad)`` over 2 clients, as LocalTrainer
    runs it; then with k and v shared by the clients."""
    from baton_tpu_torch.parallel.ring_attention import make_flash_ring_attention_fn

    q, k, v, bias = (torch.from_numpy(a) for a in vmap_arrays())
    ring = make_flash_ring_attention_fn(mesh)

    def loss(q, k, v):
        return (ring(q, k, v, bias=bias, causal=True) ** 2).sum()

    dq, dk, dv = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    shared = torch.func.vmap(torch.func.grad(loss), in_dims=(0, None, None))(q, k[0], v[0])
    return {"dq": dq.numpy(), "dk": dk.numpy(), "dv": dv.numpy(), "dq_shared": shared.numpy()}


def llama_case(kind):
    """The 2-layer decoder of the Llama step, its params and tokens."""
    from baton_tpu_torch.models.llama import LlamaConfig

    hq, hkv = LLAMA[kind]
    cfg = LlamaConfig.tiny(max_len=32, n_heads=hq, n_kv_heads=hkv, n_layers=2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return cfg, toks


def run_llama_step(kind, mesh) -> dict:
    """Step 0's loss and every gradient, and the params after one step of
    the port's trainer, on the decoder whose attention is ``kind`` over
    ``mesh``."""
    from baton_tpu_torch.core.training import make_local_trainer
    from baton_tpu_torch.models.llama import llama_lm_model

    cfg, toks = llama_case(kind)
    model = llama_lm_model(cfg, attention_fn=attention_fn(kind, mesh))
    params = model.init(torch.Generator().manual_seed(0))
    data = {"x": torch.from_numpy(toks), "y": torch.from_numpy(toks)}
    grads, loss = torch.func.grad_and_value(
        lambda p: model.per_example_loss(p, data).mean())(params)
    trainer = make_local_trainer(model, batch_size=2, learning_rate=LLAMA_LR)
    stepped, _, _ = trainer.train(params, data, 2, 1, generator=torch.Generator().manual_seed(1))
    res = {"loss": loss.detach().numpy()}
    res.update({f"grad/{k}": g.numpy() for k, g in grads.items()})
    res.update({f"param/{k}": p.detach().numpy() for k, p in stepped.items()})
    return res


def block_calls(mesh) -> dict:
    """The blocks this process computes in a causal flash ring and a
    causal dense ring (case ``flash_causal_gqa_bias``'s shapes): flash
    block calls by pass, and the query shards the dense ring placed."""
    ra = ring_module()
    calls = {"fwd": 0, "bwd": 0, "dense_shards": []}
    real_fwd, real_bwd, real_pos = ra.flash_block_fwd, ra.flash_block_bwd, ra._ring_positions

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    def positions(my, *a):
        calls["dense_shards"].append(int(my))
        return real_pos(my, *a)

    ra.flash_block_fwd, ra.flash_block_bwd, ra._ring_positions = fwd, bwd, positions
    try:
        q, k, v, dout, _ = (None if a is None else torch.from_numpy(a)
                            for a in case_arrays("flash_causal_gqa_bias"))
        args = [x.requires_grad_() for x in (q, k, v)]
        out = attention_fn("flash", mesh)(*args, causal=True)
        torch.autograd.grad(out, args, dout)
        with torch.no_grad():
            attention_fn("ring", mesh)(q, k, v, causal=True)
    finally:
        ra.flash_block_fwd, ra.flash_block_bwd, ra._ring_positions = real_fwd, real_bwd, real_pos
    calls["dense_shards"] = sorted(set(calls["dense_shards"]))
    return calls


def main() -> None:
    import torch.distributed as dist

    from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh

    coord, n_proc, rank, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    try:
        assert initialize_multihost(coord, n_proc, rank, backend="gloo", devices=["cpu"],
                                    timeout_s=60) == rank
        mesh = make_hybrid_mesh([], dcn_axis="seq",
                                devices=[torch.device("cpu")] * SHARDS_A_PROCESS)
        assert mesh.shape == {"seq": AXIS} and mesh.spans_processes, mesh.shape
        arrays = {}
        for name in CASES:
            arrays.update({f"{name}/{k}": a for k, a in run_case(name, mesh).items()})
        arrays.update({f"vmap/{k}": a for k, a in run_vmap_grad(mesh).items()})
        for kind in LLAMA:
            arrays.update({f"llama_{kind}/{k}": a for k, a in run_llama_step(kind, mesh).items()})
        ra = ring_module()
        ra.reset_transport_counts()
        calls = block_calls(mesh)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
        print(json.dumps({"rank": rank, "world": dist.get_world_size(),
                          "local_shards": [j for j, _ in mesh.local_shards("seq")],
                          "calls": calls, "transport": dict(ra.transport_counts),
                          "ok": True}), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
