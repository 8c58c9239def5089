"""Times the port's bf16 flash kernels, pass by pass, at the attention shapes
of its paths, for comparing two checkouts on one card in one session.

    python3 scripts/flash_kernel_times.py [ROOT ...]

Each ROOT (default: the checkout holding this script) is a checkout of the
repo; its ``baton_tpu_torch`` is built and timed in a child process of its
own, in the order given, so ``parent change change parent`` times both
twice on the same card. Per shape and pass it prints the launch key that
ran (``<pass>_<design>``, from the checkout's own counters) and the ms of
one call: CUDA events, the median of 5 readings of the mean of ``iters``
calls. The shapes: BERT-base (phase 3's path), config 5's ViT-B/16 (B 192,
a wave of 3 under the per-example vmap), Llama-3-8B (config 4), the ring
block of example 06 and one causal call over its 32,768 tokens. The last
line is one JSON object: {root: {shape: {key: ms}}}. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# name: (B, Hq, Hkv, L, D, causal, padding bias, iters)
SHAPES = {
    "bert": (256, 12, 12, 128, 64, False, True, 20),
    "config5": (192, 12, 12, 197, 64, False, True, 20),
    "llama": (8, 32, 8, 1024, 128, True, False, 20),
    "ring_block": (1, 8, 4, 4096, 64, False, False, 20),
    "l32768": (1, 8, 4, 32768, 64, True, False, 2),
}


def time_ms(fn, iters):
    import numpy as np
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(5):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return float(np.median(means))


def child(root: str) -> dict:
    """The times of the checkout at ``root`` (run in its own process)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from baton_tpu_torch.ops import flash_attention as fa

    fa.load_library()
    out = {}
    for name, (b, hq, hkv, l, d, causal, padded, iters) in SHAPES.items():
        gen = torch.Generator().manual_seed(0)
        q, dout = (torch.randn(b, hq, l, d, generator=gen).cuda().bfloat16() for _ in range(2))
        k, v = (torch.randn(b, hkv, l, d, generator=gen).cuda().bfloat16() for _ in range(2))
        valid = np.arange(l)[None, :] < np.random.default_rng(0).integers(16, l + 1, b)[:, None]
        bias = torch.from_numpy(np.where(valid | (not padded), 0.0, -1e30).astype(np.float32))
        bias = bias.cuda()
        scale = d ** -0.5
        o, lse = fa._fwd(q, k, v, bias, causal, scale)
        args = (q, k, v, bias, dout, lse, (dout.float() * o.float()).sum(-1), causal, scale)
        row = {}
        for pass_, fn in (("fwd", lambda: fa._fwd(q, k, v, bias, causal, scale)),
                          ("bwd_dkv", lambda: fa._bwd_dkv(*args)),
                          ("bwd_dq", lambda: fa._bwd_dq(*args))):
            before = dict(fa.launches_by_design)
            fn()
            torch.cuda.synchronize()
            key, = (k_ for k_, n in fa.launches_by_design.items() if n != before.get(k_, 0))
            row[key] = time_ms(fn, iters)
        out[name] = row
        print(f"  {name}: " + ", ".join(f"{k_} {ms:.4f} ms" for k_, ms in row.items()),
              flush=True)
        del q, k, v, dout, o, lse, args
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2])))
        return 0
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    results = {}
    for i, root in enumerate(roots):
        print(f"{i}: {root}", flush=True)
        done = subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve())],
                              capture_output=True, text=True, timeout=900)
        print(done.stdout.rstrip(), flush=True)
        if done.returncode != 0:
            print(done.stderr[-3000:], file=sys.stderr)
            return 1
        results[f"{i}: {root}"] = json.loads(done.stdout.strip().splitlines()[-1])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
