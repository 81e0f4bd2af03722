"""Which gloo collectives take CUDA tensors on this machine's torch.

Two ranks on cuda:0 over gloo (the layout of ``parallel/mesh.py`` on one
card) run each op on CUDA tensors, every op in a fresh pair of processes,
so that an op that aborts a process hides no other.  For each op it
prints "ok" (the result checked against the op's definition), the
exception a rank raised, or each rank's exit code and the last line it
wrote to stderr.  ``mesh.GLOO_CUDA_OPS`` lists the kinds that passed;
``RankGroup`` stages the others through host memory.

    python3 scripts/torch_gloo_cuda_probe.py [--out FILE]

The last line of its output is one JSON object: the torch version and,
for each op, what each rank reported.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "all_to_all", "all_to_all_single", "send_recv", "batch_isend_irecv")
WAIT_S = 120


def _child(op: str, rank: int, init: str) -> dict:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    other = 1 - rank
    want = torch.arange(4, dtype=torch.float32) + 10 * other
    try:
        if op == "all_reduce":
            dist.all_reduce(x)
            ok = torch.equal(x.cpu(), 2 * torch.arange(4.0) + 10)
        elif op == "broadcast":
            dist.broadcast(x, 0)
            ok = torch.equal(x.cpu(), torch.arange(4.0))
        elif op == "all_gather":
            outs = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(outs, x)
            ok = torch.equal(outs[other].cpu(), want)
        elif op == "all_gather_into_tensor":
            out = torch.empty(8, device=dev)
            dist.all_gather_into_tensor(out, x)
            ok = torch.equal(out[4 * other:4 * other + 4].cpu(), want)
        elif op == "all_to_all":
            outs = [torch.empty(2, device=dev) for _ in range(2)]
            dist.all_to_all(outs, list(x.chunk(2)))
            ok = torch.equal(outs[other].cpu(), want[2 * rank:2 * rank + 2])
        elif op == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            ok = torch.equal(out[2 * other:2 * other + 2].cpu(),
                             want[2 * rank:2 * rank + 2])
        elif op == "send_recv":
            out = torch.empty_like(x)
            if rank == 0:
                dist.send(x, 1)
                dist.recv(out, 1)
            else:
                dist.recv(out, 0)
                dist.send(x, 0)
            ok = torch.equal(out.cpu(), want)
        else:
            out = torch.empty_like(x)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, other),
                                           dist.P2POp(dist.irecv, out, other)])
            for r in reqs:
                r.wait()
            ok = torch.equal(out.cpu(), want)
        res = {"ok": bool(ok)}
    except (RuntimeError, ValueError, NotImplementedError) as e:
        res = {"error": repr(e)}
    dist.destroy_process_group()
    return res


def _probe(op: str) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, __file__, "--child", op,
                                   str(r), init], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        out = []
        for p in procs:
            try:
                so, se = p.communicate(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
            lines = [x for x in so.splitlines() if x.startswith("{")]
            rep = json.loads(lines[-1]) if lines else {}
            if p.returncode != 0 or not lines:
                err = [x for x in se.splitlines() if x.strip()]
                rep.update(rc=p.returncode, stderr=err[-1] if err else "")
            out.append(rep)
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        op, rank, init = args.child
        print(json.dumps(_child(op, int(rank), init)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = {"torch": torch.__version__, "ops": {}}
    for op in OPS:
        res["ops"][op] = _probe(op)
        print(f"{op}: " + "; ".join(
            f"rank {r}: " + ("ok" if x.get("ok") else json.dumps(x))
            for r, x in enumerate(res["ops"][op])), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
