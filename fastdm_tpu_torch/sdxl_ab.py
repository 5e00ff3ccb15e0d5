#!/usr/bin/env python3
"""Time the SDXL-base UNet forward (int8 by default) of one or more checkouts
of this repository on one NVIDIA GPU: full width and depth (random weights
from seed 5), 1024x2048 (128x256 latents), batched CFG (batch 2), 77 random
text tokens (seed 51), the first Euler step of 4, as chip_smoke.py's SDXL
phase runs it.

    python3 fastdm_tpu_torch/sdxl_ab.py [--forwards N] [--quant int8|fp8|bf16] ROOT [ROOT ...]

Each ROOT (a checkout, e.g. a `git archive` of a commit) is timed in a process
of its own, in the order given (for an A/B comparison on one card: parent,
change, change, parent): after two warm-up forwards, N forwards (default 20)
each timed alone, on the host's clock (synchronised before and after; also
the time until forward() returns, i.e. until the host has queued it) and by
CUDA events; then one forward under torch.profiler, whose kernels' device
times give the device's busy time, its idle share and the largest kernels.
One JSON line per ROOT (median, min and max of each clock, the profile, and
an exact checksum of the output), then the card's name and power limit.
Needs nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

H, W, TEXT, BATCH, STEPS = 1024, 2048, 77, 2, 4


def _stats(xs: list) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "all": xs}


def _one(root: str, forwards: int, quant: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from fastdm_tpu_torch.models.sdxl import SDXLConfig, sdxl_forward, sdxl_init_random
    from fastdm_tpu_torch.pipeline.schedulers import EulerDiscreteScheduler

    dev = torch.device("cuda")
    cfg = SDXLConfig(quant=None if quant == "bf16" else quant)
    params = sdxl_init_random(5, cfg, device=dev)
    sched = EulerDiscreteScheduler.create(STEPS)
    g = torch.Generator(device=dev).manual_seed(51)
    latents = torch.randn(1, cfg.in_channels, H // 8, W // 8, generator=g,
                          device=dev) * sched.init_noise_sigma
    embeds = torch.randn(BATCH, TEXT, cfg.cross_attention_dim, generator=g, device=dev,
                         dtype=torch.bfloat16)
    pooled = torch.randn(BATCH, cfg.add_embedding_in_dim - 6 * cfg.addition_time_embed_dim,
                         generator=g, device=dev, dtype=torch.bfloat16)
    time_ids = torch.tensor([[H, W, 0, 0, H, W]] * BATCH, dtype=torch.float32, device=dev)
    x = torch.cat([sched.scale_model_input(latents, 0)] * 2).to(torch.bfloat16)
    t = torch.full((BATCH,), float(sched.timesteps[0]), device=dev)

    def forward():
        with torch.inference_mode():
            return sdxl_forward(params, cfg, x, t, embeds, pooled, time_ids)

    for _ in range(2):
        out = forward()
    torch.cuda.synchronize()
    host_s, queued_s, device_ms = [], [], []
    for _ in range(forwards):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        forward()
        queued_s.append(time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        device_ms.append(start.elapsed_time(end))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (device events); the host ops that launched them
    # carry the same time and are left out
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return {"root": root, "quant": quant, "forwards": forwards, "host_s": _stats(host_s),
            "queued_s": _stats(queued_s), "device_ms": _stats(device_ms),
            "profiled": {"wall_ms": wall_ms, "kernel_ms": busy_ms,
                         "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
                         "kernels": len(kernels), "launches": sum(n for _, _, n in kernels),
                         "top": [{"kernel": k[:90], "ms": ms, "count": n}
                                 for k, ms, n in kernels[:12]]},
            "out_checksum": int(out.view(torch.int16).long().sum())}


def main() -> int:
    args = sys.argv[1:]
    forwards, quant = 20, "int8"
    while args[:1] in (["--forwards"], ["--quant"]) and len(args) > 1:
        if args[0] == "--forwards":
            forwards = int(args[1])
        else:
            quant = args[1]
        args = args[2:]
    if quant not in ("int8", "fp8", "bf16"):
        print(__doc__, file=sys.stderr)
        return 1
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(_one(args[1], forwards, quant)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 1
    for root in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--forwards", str(forwards),
                        "--quant", quant, "--one", root], check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
