#!/usr/bin/env python3
"""Which of gloo's calls take CUDA tensors: ``all_gather``,
``all_to_all_single`` and ``batch_isend_irecv``.

``python3 scripts/gloo_cuda_probe.py`` starts two processes on the first
card, joined over gloo on a free local port, and prints each one's JSON
line: every call on an 8-element CUDA tensor, ``"ok"`` where it returned
the other process's data, else what it raised. The calls run in that
order, since a send of a CUDA tensor may abort the process (gloo hands its
address to the socket). Each child runs under a time limit and is killed
after it. This is why ``parallel/ring_attention.py`` stages a gloo group's
CUDA blocks through host memory. Needs a CUDA card.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys

CHILD_LIMIT_S = 120


def child(coordinator: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=30))
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 100 * rank
    other = torch.arange(8.0) + 100 * (1 - rank)

    def all_gather():
        bufs = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(bufs, x)
        return torch.equal(bufs[1 - rank].cpu(), other)

    def all_to_all_single():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        mine = slice(rank * 4, (rank + 1) * 4)
        want = torch.cat([(torch.arange(8.0) + 100 * p)[mine] for p in range(2)])
        return torch.equal(out.cpu(), want)

    def batch_isend_irecv():
        y = torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                            dist.P2POp(dist.irecv, y, 1 - rank)]):
            work.wait()
        return torch.equal(y.cpu(), other)

    result = {"rank": rank}
    try:
        for call in (all_gather, all_to_all_single, batch_isend_irecv):
            try:
                result[call.__name__] = "ok" if call() else "wrong data"
            except RuntimeError as e:
                result[call.__name__] = f"raised: {e}"[:300]
            print(json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, __file__, coordinator, str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_LIMIT_S)
            lines = out.strip().splitlines()
            print(json.dumps({"exit": p.returncode, "last": json.loads(lines[-1]) if lines
                              else None, "stderr": err.strip()[-300:]}))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3:
        child(sys.argv[1], int(sys.argv[2]))
    else:
        sys.exit(main())
