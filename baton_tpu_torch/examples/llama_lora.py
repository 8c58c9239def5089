"""BASELINE config 4: Llama-class LoRA federated instruction-tune (the port
of ``examples/04_llama_lora.py``).

Each client trains only low-rank adapters on the attention projections
(:func:`llama_lora_target`); the frozen base is held once on the device
and never repeated per client, so client state and the FedAvg aggregate
are rank·(d_in + d_out) per target matrix instead of d_in·d_out.
``trainable=lora_trainable`` makes the engine train and aggregate the
``lora/*`` params only; ``run()`` asserts that every base weight is
bit-equal after the rounds, as the reference does. The tokens are
synthetic (the prompt half masked out of the loss): no weights or text
are downloaded.

  python -m baton_tpu_torch.examples.llama_lora [--scale tiny|full] [--cpu]

``--scale full`` keeps the reference's numbers: Llama-3-8B's shape
(vocab 128,256, d 4096, 32 layers, 32/8 heads, d_ff 14,336, L 1024),
LoRA rank 16, 64 clients x 512 samples, batch 8, 10 rounds, fp32
compute and no remat. As written it does not fit one 80 GB card: the
fp32 base alone is 32.1 GB, and without remat one client's stored fp32
activations at batch 8 x 1024 tokens come to about 94 GB (~180 KB a
token a layer in bf16, twice that in fp32, over 32 layers; an estimate
from the shapes). ``chip_smoke.py`` phase 16 runs this shape in bf16
with ``remat=True`` instead, on a cut cohort.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model, llama_lora_target
from baton_tpu_torch.models.lora import lora_trainable, lora_wrap, merge_lora_model
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.parallel.engine import FedSim

LEARNING_RATE = 1e-2

# --scale full: Llama-3-8B's shape, 64 clients (BASELINE config 4)
FULL_CONFIG = LlamaConfig(vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
                          n_kv_heads=8, d_ff=14336, max_len=1024)
FULL = dict(n_clients=64, n_per_client=512, n_rounds=10, batch_size=8, rank=16)


def make_data(rng, cfg, n_clients, n_per_client):
    """Instruction-tune stand-in: token sequences with the 'prompt' half
    masked out of the loss (loss_mask 0) and the 'response' half kept."""
    datasets = []
    half = cfg.max_len // 2
    for _ in range(n_clients):
        toks = rng.integers(0, cfg.vocab_size, size=(n_per_client, cfg.max_len)).astype(np.int32)
        mask = np.concatenate([
            np.zeros((n_per_client, half), np.float32),
            np.ones((n_per_client, cfg.max_len - half), np.float32),
        ], axis=1)
        datasets.append({"x": toks, "y": toks, "loss_mask": mask})
    return datasets


def client_data(cfg, n_clients, n_per_client, batch_size, seed=0):
    """The example's stacked client data ``(data, n_samples)`` (numpy)."""
    rng = np.random.default_rng(seed)
    return stack_client_datasets(make_data(rng, cfg, n_clients, n_per_client),
                                 batch_size=batch_size)


def make_sim(cfg, rank=4, batch_size=4, device="cuda", compute_dtype=torch.float32,
             remat=False):
    """``(sim, model)``: the LoRA-wrapped decoder and a FedSim that trains
    and aggregates its adapters only, local SGD at the example's lr."""
    base = llama_lm_model(cfg, compute_dtype=compute_dtype, remat=remat)
    model = lora_wrap(base, rank=rank, target=llama_lora_target)
    sim = FedSim(model, batch_size=batch_size, learning_rate=LEARNING_RATE,
                 trainable=lora_trainable, device=device)
    return sim, model


def run(n_clients=4, n_per_client=8, n_rounds=2, n_epochs=1, batch_size=4,
        rank=4, config=None, seed=0, device="cuda"):
    """Train ``n_rounds`` rounds; returns ``(loss history, merged deploy
    params)``. The base is built on the device from a generator there."""
    cfg = config or LlamaConfig.tiny()
    sim, model = make_sim(cfg, rank, batch_size, device)
    data, n_samples = client_data(cfg, n_clients, n_per_client, batch_size, seed)
    params = sim.init(torch.Generator(device=sim.device).manual_seed(seed))
    # a host copy of every frozen tensor, compared after the rounds
    base_before = {k: v.detach().to("cpu", copy=True) for k, v in params.items()
                   if not lora_trainable(k, v)}

    t0 = time.perf_counter()
    params, history = sim.run_rounds(params, data, n_samples,
                                     torch.Generator().manual_seed(seed + 1),
                                     n_rounds=n_rounds, n_epochs=n_epochs)
    train_s = time.perf_counter() - t0
    for k, before in base_before.items():
        if not torch.equal(params[k].cpu(), before):
            raise AssertionError(f"frozen base tensor {k} changed")
    n_adapter = sum(v.numel() for k, v in params.items() if lora_trainable(k, v))
    n_base = sum(v.numel() for v in base_before.values())
    print(f"LoRA rank={rank}: {n_adapter:,} trainable / {n_base:,} frozen "
          f"params ({100 * n_adapter / n_base:.2f}%)")
    print(f"loss: {history[0]:.4f} -> {history[-1]:.4f} ({train_s:.2f} s of rounds on "
          f"{sim.device})")
    # deploy: fold the adapters into the base weights (no inference cost)
    return history, merge_lora_model(model, params)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.scale == "full":
        # does not fit one 80 GB card as written (module docstring)
        run(**FULL, config=FULL_CONFIG, device=device)
    else:
        history, _ = run(device=device)
        assert history[-1] < history[0], "loss should fall"
