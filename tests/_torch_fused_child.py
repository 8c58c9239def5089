"""Child process of ``tests/test_torch_fused_processes.py`` (not a test
module): ``python _torch_fused_child.py <coordinator host:port> <n> <rank>
<params.pt> <out.pt>``.

Each process holds 4 CPU shards and joins one gloo process group. First
the split psum across the two processes: ``psum_local``, ``psum_across``
and ``psum_views`` in a row against ``psum``, bit for bit. Then each case
of :data:`CASES` (the params from ``params.pt``, JAX's carried over by the
parent; the data made here from a seed, one batch a client) runs
``run_rounds`` and ``run_rounds_fused`` for :data:`ROUNDS` rounds on
``make_hybrid_mesh([], dcn_axis="clients")``, a clients axis of 8 across
both processes (the LoRA case on ``make_hybrid_mesh([("model", 2)],
dcn_axis="clients")``: clients 4 x model 2), and both results go to
``out.pt``, the frozen leaves gathered. Last, a compute record from
``ComputeProbe.record_round`` with neither ``device`` nor ``n_chips``,
which counts the group's processes. Prints one JSON line; the process
group is destroyed on every exit. The parent imports :func:`cohort` and
:func:`mesh_of` to run the same cases in one process."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from baton_tpu_torch import FedSim
from baton_tpu_torch.core import optim
from baton_tpu_torch.core.regularizers import fedprox
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.obs.compute import ComputeProbe
from baton_tpu_torch.ops import aggregation as agg
from baton_tpu_torch.ops.padding import stack_client_datasets
from baton_tpu_torch.ops.privacy import DPConfig
from baton_tpu_torch.parallel.multihost import initialize_multihost, make_hybrid_mesh
from baton_tpu_torch.parallel.tensor_parallel import gather_params

CPU4 = [torch.device("cpu")] * 4
# "dp" binds the clip without noise (JAX's noise comes from its own keys, so
# only a noiseless run can be held against it); "dp_noise" draws noise
CASES = ("linear", "mlp_fedadam", "fedprox", "dp", "dp_noise", "lora")
ROUNDS = 3
N_EPOCHS = 2
SIZES = (16, 11, 0, 16, 9, 5, 16, 3, 7, 16, 12, 1)  # one batch of 16 a client
LORA_SIZES = (4, 2, 0, 3, 4, 1, 4, 2)  # one batch of 4 a client


def lora_config(cfg_cls):
    """The tiny Llama of the LoRA case, from either package's config."""
    return cfg_cls.tiny(max_len=8, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64)


def cohort(case: str):
    """``(model, data, n_samples, FedSim kwargs, wave_size)`` of a case:
    the data numpy arrays from seed 0, one batch a client."""
    rng = np.random.default_rng(0)
    if case == "lora":
        from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model, llama_lora_target
        from baton_tpu_torch.models.lora import lora_trainable, lora_wrap

        cfg = lora_config(LlamaConfig)
        toks = [rng.integers(0, cfg.vocab_size, (s, cfg.max_len)).astype(np.int32)
                for s in LORA_SIZES]
        data, n = stack_client_datasets([{"x": t, "y": t} for t in toks], batch_size=4)
        model = lora_wrap(llama_lm_model(cfg), rank=2, target=llama_lora_target)
        return model, data, n, dict(batch_size=4, learning_rate=0.05,
                                    trainable=lora_trainable), 4
    if case == "linear":
        datasets = [{"x": rng.normal(size=(s, 6)).astype(np.float32),
                     "y": rng.normal(size=(s,)).astype(np.float32)} for s in SIZES]
        model = linear_regression_model(6)
    else:
        datasets = [{"x": rng.normal(size=(s, 6)).astype(np.float32),
                     "y": rng.integers(0, 3, s).astype(np.int32)} for s in SIZES]
        model = mlp_classifier_model(6, (8,), 3)
    kw = dict(batch_size=16, learning_rate=0.05)
    kw.update({"linear": {}, "mlp_fedadam": {"server_optimizer": optim.adam(0.05)},
               "fedprox": {"regularizer": fedprox(0.1)},
               "dp": {"dp": DPConfig(clip_norm=0.05, noise_multiplier=0.0)},
               "dp_noise": {"dp": DPConfig(clip_norm=0.5, noise_multiplier=0.7)}}[case])
    data, n = stack_client_datasets(datasets, batch_size=16)
    return model, data, n, kw, 8


def mesh_of(case: str, devices):
    """The case's mesh over ``devices`` (this process's, or 8 CPU shards
    in one process): a clients axis, or clients x model 2 for LoRA."""
    return make_hybrid_mesh([("model", 2)] if case == "lora" else [], dcn_axis="clients",
                            devices=devices)


def both_runs(case: str, params: dict, devices) -> dict:
    """``run_rounds`` and ``run_rounds_fused`` of a case on its mesh over
    ``devices``, from the same params and generator: both results (the
    frozen leaves gathered) and the fused run's ``last_fused``."""
    model, data, n, kw, wave = cohort(case)
    sim = FedSim(model, mesh=mesh_of(case, devices), **kw)
    out = {}
    for label, run in (("loop", sim.run_rounds), ("fused", sim.run_rounds_fused)):
        p, h = run(params, data, n, torch.Generator().manual_seed(1), n_rounds=ROUNDS,
                   n_epochs=N_EPOCHS, wave_size=wave)
        out[label] = {"params": gather_params(p), "history": h}
    out["last_fused"] = sim.last_fused
    return out


def split_psum(rank: int) -> bool:
    """The split psum across the processes: its three parts in a row give
    exactly ``psum``'s result, and the local part is this process's alone."""
    mesh = make_hybrid_mesh([], dcn_axis="clients", devices=CPU4)
    gen = torch.Generator().manual_seed(10 + rank)
    parts = [{"a": torch.randn(5, 3, generator=gen),
              "b": {"c": torch.randn(7, generator=gen).bfloat16(),
                    "w": torch.rand((), generator=gen)}} for _ in range(4)]
    whole = agg.psum(parts, mesh)
    buf = torch.empty(agg.flat_size(parts[0]))
    local = agg.psum_local(parts, mesh, out=buf).clone()
    split = agg.psum_views(agg.psum_across(buf, mesh), parts[0], mesh)
    flat = lambda tree: torch.cat([t.reshape(-1) for t in agg._leaves(tree)])  # noqa: E731
    want_local = sum(flat(p).float() for p in parts)
    return (all(torch.equal(flat(w), flat(s)) for w, s in zip(whole, split))
            and torch.allclose(local, want_local) and not torch.equal(local, buf))


def main() -> None:
    coord, n_proc, rank, params_path, out_path = (sys.argv[1], int(sys.argv[2]),
                                                  int(sys.argv[3]), sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    try:
        assert initialize_multihost(coord, n_proc, rank, backend="gloo", devices=["cpu"],
                                    timeout_s=60) == rank
        assert dist.get_world_size() == n_proc and dist.get_backend() == "gloo"
        split_ok = split_psum(rank)
        params = torch.load(params_path)
        results = {case: both_runs(case, params[case], CPU4) for case in CASES}
        torch.save(results, out_path)
        record = ComputeProbe("linear").record_round(key="defaults", signature=(rank,),
                                                     train_s=0.5, n_samples=8)
        print(json.dumps({"rank": rank, "world": dist.get_world_size(), "split_psum": split_ok,
                          "last_fused": {c: r["last_fused"] for c, r in results.items()},
                          "default_record": record, "ok": True}), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
