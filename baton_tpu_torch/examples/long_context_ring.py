"""Long-context causal LM training with ring × flash sequence parallelism
(the port of ``examples/06_long_context_ring.py``).

A Llama-class decoder whose attention runs as ring attention over a
``Mesh(("seq",))``: k/v blocks rotate between the shards while each shard
keeps its part of the sequence, and each block's math runs in the flash
kernels (``parallel/ring_attention.py`` ``flash_ring_attention``).
Attention memory per shard is O(L/N · tile) instead of O(L²).

The mesh is ``n_devices`` shards on one device (``make_mesh(...,
devices=[device] * n_devices)``): ``--scale full`` runs its 8-way ring of
32,768 tokens on one card, the tiny preset the same code on the CPU with
``--cpu``. ``remat=True`` recomputes each decoder block in the backward
pass, the usual pairing with long context.

  python -m baton_tpu_torch.examples.long_context_ring [--scale tiny|full] [--striped] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baton_tpu_torch import resolve_device
from baton_tpu_torch.core.training import make_local_trainer
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model
from baton_tpu_torch.parallel.mesh import make_mesh
from baton_tpu_torch.parallel.ring_attention import (
    make_flash_ring_attention_fn,
    make_ring_attention_fn,
    make_striped_attention_fn,
)

# --scale full: the decoder the reference sizes for a TPU slice
FULL_WIDTHS = dict(vocab_size=32000, d_model=512, n_heads=8, n_kv_heads=4, n_layers=8,
                   d_ff=1536)


def full_preset(striped=False) -> dict:
    """``run()``'s arguments at ``--scale full``: ring × flash takes 32,768
    tokens 8 ways; the striped variant (the dense ring kernel) is sized
    down to 8,192 to keep each shard's (L/N)² score block small."""
    seq = 8192 if striped else 32768
    return dict(n_devices=8, seq_len=seq, n_steps=5, batch_size=1,
                config=LlamaConfig(max_len=seq, **FULL_WIDTHS), remat=True, striped=striped)


def example_config(config=None, seq_len=64) -> LlamaConfig:
    return config or LlamaConfig.tiny(max_len=seq_len, n_heads=4, n_kv_heads=2, n_layers=2)


def make_attention_fn(mesh, flash=True, striped=False):
    """The example's ``attention_fn``: striped (the dense ring kernel;
    ``flash`` is then ignored), ring × flash, or the dense ring."""
    if striped:
        return make_striped_attention_fn(mesh)
    return make_flash_ring_attention_fn(mesh) if flash else make_ring_attention_fn(mesh)


def make_tokens(cfg, batch_size, seed=0) -> np.ndarray:
    """The example's tokens: int32 [batch_size, max_len] from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(batch_size, cfg.max_len)).astype(np.int32)


def run(n_devices=8, seq_len=64, n_steps=3, batch_size=2, lr=1e-2, config=None, remat=False,
        flash=True, striped=False, seed=0, device="cuda", params=None, perm=None,
        progress_fn=None):
    """Train ``n_steps`` full-batch steps of next-token prediction on the
    example's tokens; returns the per-step losses.

    ``striped=True`` uses the load-balanced causal layout (round-robin token
    sharding): the same exact math, but every shard does equal work per
    ring step. It runs the dense ring kernel (there is no striped flash),
    so per-shard attention memory is O((L/N)²). ``params`` (a flat dict
    on ``device``) replaces the seeded init, ``perm`` ([n_steps,
    batch_size]) the row shuffles drawn from ``seed + 1``, and
    ``progress_fn(step, loss)`` runs after each step."""
    device = resolve_device(device)
    mesh = make_mesh(n_devices, axis_names=("seq",), devices=[device] * n_devices)
    cfg = example_config(config, seq_len)
    if striped and flash:
        print("note: striped layout uses the dense ring kernel (no striped flash variant); "
              "flash ignored")
    model = llama_lm_model(cfg, attention_fn=make_attention_fn(mesh, flash, striped),
                           remat=remat)
    trainer = make_local_trainer(model, batch_size=batch_size, learning_rate=lr,
                                 progress_fn=progress_fn)
    toks = torch.as_tensor(make_tokens(cfg, batch_size, seed), device=device)
    data = {"x": toks, "y": toks}
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed))
    # one multi-epoch run: every epoch is one step over the batch's rows
    _, _, hist = trainer.train(params, data, batch_size, n_steps, perm=perm,
                               generator=torch.Generator().manual_seed(seed + 1))
    losses = [float(x) for x in hist]
    for step, loss in enumerate(losses):
        print(f"epoch {step}: loss {loss:.4f} (seq {cfg.max_len} over {n_devices}-way ring)")
    return losses


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--striped", action="store_true",
                   help="load-balanced causal layout (striped attention)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        run(**full_preset(args.striped), device=device)
    else:
        losses = run(striped=args.striped, device=device)
        assert losses[-1] < losses[0], "loss should fall"
