#!/usr/bin/env python3
"""Time the superblock gather-sparse attention kernel (gather_super) of one or
more checkouts of this repository on one NVIDIA GPU, beside the dense sdpa
kernel of the same checkout: Wan2.2-A14B at 480x832x81 (32760 tokens, 40
heads of 128), q/k/v from a seed, the radial superblock tables of
examples/sparse/radial_attn_wan.json (q tiles of 256 tokens, 8 entries per
group, fine blocks of 128, superblocks of 4), as the engine builds them.

    python3 fastdm_tpu_torch/sparse_ab.py ROOT [ROOT ...]

Each ROOT (a checkout, e.g. a `git archive` of a commit) is timed in a process
of its own, in the order given (for an A/B comparison on one card: parent,
change, change, parent); one JSON line per ROOT (the times and an exact
checksum of the gather kernel's output), then the card's name and power
limit. Needs nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.sparse.xsparse import SparseAttn

    with open(os.path.join(root, "examples", "sparse", "radial_attn_wan.json")) as f:
        radial = SparseAttn.from_dict(json.load(f))
    s, frames, h, hd = 21 * 30 * 52, 21, 40, 128
    bq, group, sb = 256, 8, 4
    fine = radial.config.block_size
    radial.post_init(s, frames)
    dev = torch.device("cuda")
    tables = [torch.from_numpy(t).to(dev) for t in radial.block_lists_super(bq, group, sb)]
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, s, h * hd, generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))

    def gather():
        return cb.gather_super_attention_cuda(q, k, v, *tables, h, h, hd, block_q=bq,
                                              group=group, fine=fine, superblock=sb)

    def dense():
        return cb.sdpa_cuda(q, k, v, h, h, hd)

    def ms(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = gather()
    return {"root": root, "gather_super_ms": ms(gather, 20), "sdpa_ms": ms(dense, 20),
            "gather_super_again_ms": ms(gather, 20),
            "out_checksum": int(out.view(torch.int16).long().sum())}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
