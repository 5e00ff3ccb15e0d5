#!/usr/bin/env python3
"""Time the attention, norm, RoPE and W8A8 GEMM kernels of one or more
checkouts of this repository on one NVIDIA GPU, on the same inputs (from
seeds) in every checkout:
  - Wan2.2-A14B at 480x832x81 (32760 tokens, 40 heads of 128): dense sdpa,
    the superblock walk (gather_super) on the radial superblock tables of
    examples/sparse/radial_attn_wan.json (q tiles of 256 tokens, 8 entries per
    group, fine blocks of 128, superblocks of 4), the fine walk (gather_fine)
    on its fine tables (q tiles of 512 tokens, groups of 32, fine blocks of
    128), the coarse walk (gather_coarse) on its coarse lists (512 x 1024
    tiles) and the mask walk (sparse_mask) on its (1, 40, 256, 256) block
    mask of 128 x 128 tiles, as the engine builds them; qk_norm_rope on a
    (1, 32760, 15360) fused QKV output and qk_norm_rope2 on the split path's
    (1, 4095, 5120) chunk, with bf16 norm weights and the real 3D RoPE tables;
    rmsnorm_wan, the cross-attention's q norm on (1, 32760, 5120) with a bf16
    weight;
  - FLUX.1-dev at 1024x2048: sdpa at (1, 8704, 24x128), and the int8 and fp8
    W8A8 GEMMs and the W4A4 int4 GEMM (int4_gemm_flux) at the single-block
    qkv_mlp product (8704 x 3072 @ 3072 x 21504), each on its per-token
    quantized activation and a random quantized weight (int4: the int4p
    weight unpacked); the int4 quantizer (quantize_int4_flux) on the (8704,
    3072) activation and the int4p unpack (unpack_int4_flux) of the qkv_mlp
    weight; rmsnorm_flux, the per-head q norm on the strided
    (1, 8192, 24, 128) view of a dual block's fused QKV output with a bf16
    weight; rotembd_flux and rotembd_neox, q and k of (1, 8704, 3072) with
    the real FLUX tables, interleaved and half-split.

    python3 fastdm_tpu_torch/kernel_ab.py [--kernels NAME,...] ROOT [ROOT ...]

Each ROOT (a checkout, e.g. a `git archive` of a commit) is timed in a process
of its own, in the order given (for an A/B comparison on one card: parent,
change, change, parent, repeated); one JSON line per ROOT given (each kernel's
mean ms over 20 calls, CUDA events, after 2 s of warm-up calls of that kernel,
the calls queued behind a busy-wait so that the device, not the host, is timed,
and an exact checksum of its output; for the rmsnorm kernels also the
largest distance from the plain version in bf16 ulp), then
one JSON line per distinct ROOT with each kernel's median, min and max over
that ROOT's runs and whether its checksums agree across all runs of all ROOTs,
then the card's name and power limit. The norm, qk-norm+RoPE and mask outputs
may differ between checkouts whose kernels sum in another order. A kernel a
checkout does not take (NotImplementedError, e.g. the half-split RoPE before
the CUDA kernel took it, or a wrapper it does not have yet, e.g. the W4A4
ones before they existed) is left out of that checkout's line. --kernels times
only the kernels named. Needs nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _one(root: str, only) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.layers.qlinear import qlinear_random
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_rope_cache
    from fastdm_tpu_torch.models.wan import WanConfig, wan_rope_cos_sin
    from fastdm_tpu_torch.sparse.xsparse import SparseAttn

    with open(os.path.join(root, "examples", "sparse", "radial_attn_wan.json")) as f:
        radial = SparseAttn.from_dict(json.load(f))
    s, frames, h, hd = 21 * 30 * 52, 21, 40, 128
    bq, group, sb = 256, 8, 4
    fine = radial.config.block_size
    radial.post_init(s, frames)
    dev = torch.device("cuda")
    to = lambda ts: [torch.from_numpy(t).to(dev) for t in ts]  # noqa: E731
    super_tables, coarse_tables = to(radial.block_lists_super(bq, group, sb)), \
        to(radial.block_lists(512, 1024))
    fine_bq, fine_group = 512, 32
    fine_tables = to(radial.block_lists_fine(fine_bq, fine_group))
    (mask,) = to([radial.block_mask(1, h, block_tokens=128)])
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, s, h * hd, generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    fq, fk, fv = (torch.randn(1, 8704, 24 * hd, generator=g, device=dev, dtype=torch.bfloat16)
                  for _ in range(3))
    m, kk, n = 8704, 3072, 21504
    x = torch.randn(m, kk, generator=g, device=dev, dtype=torch.bfloat16)
    w8 = qlinear_random(g, kk, n, quant="int8", device=dev)
    a8, s8, z8 = tb.quantize_to_int8_torch(x, symmetric=False)
    wf = qlinear_random(g, kk, n, quant="fp8", device=dev)
    af, sf = tb.quantize_to_fp8_torch(x)
    d, chunk = h * hd, 4095
    cos, sin = wan_rope_cos_sin(WanConfig(), frames, 60, 104, device=dev)
    qkv = (torch.randn(1, s, 3 * d, generator=g, device=dev) * 2).bfloat16()
    gq, gk = ((1 + 0.1 * torch.randn(d, generator=g, device=dev)).bfloat16() for _ in range(2))
    cq, ck = (qkv[:, :chunk, i * d:(i + 1) * d].contiguous() for i in range(2))
    fh = 24
    fqkv = torch.randn(1, 8192, 3 * fh * hd, generator=g, device=dev, dtype=torch.bfloat16)
    fx = fqkv[..., :fh * hd].reshape(1, 8192, fh, hd)  # the strided per-head view
    fw = (1 + 0.05 * torch.randn(hd, generator=g, device=dev)).bfloat16()
    wx = torch.randn(1, s, d, generator=g, device=dev, dtype=torch.bfloat16)
    fcos, fsin = flux_rope_cache(FluxConfig(), 512, 64, 128, device=dev)
    w4 = qlinear_random(g, kk, n, quant="int4p", device=dev) if hasattr(tb, "unpack_int4_torch") \
        else None
    if w4 is not None:
        a4, s4 = tb.quantize_to_int4_torch(x)
        u4 = tb.unpack_int4_torch(w4.w4p)

    kernels = {
        "gather_super": lambda: cb.gather_super_attention_cuda(
            q, k, v, *super_tables, h, h, hd, block_q=bq, group=group, fine=fine, superblock=sb),
        "gather_fine": lambda: cb.gather_fine_attention_cuda(
            q, k, v, *fine_tables, h, h, hd, block_q=fine_bq, group=fine_group, fine=fine),
        "gather_coarse": lambda: cb.gather_sparse_attention_cuda(
            q, k, v, *coarse_tables, h, h, hd, block_q=512, block_k=1024),
        "sparse_mask": lambda: cb.sparse_attention_cuda(
            q, k, v, h, h, hd, sparse_mask=mask, block_q=128, block_k=128),
        "qk_norm_rope": lambda: cb.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, inner_dim=d),
        "qk_norm_rope2": lambda: cb.qk_norm_rope2_cuda(cq, ck, gq, gk, hd, cos[:chunk],
                                                       sin[:chunk]),
        "sdpa_wan": lambda: cb.sdpa_cuda(q, k, v, h, h, hd),
        "sdpa_flux": lambda: cb.sdpa_cuda(fq, fk, fv, 24, 24, hd),
        "int8_matmul": lambda: cb.int8_matmul_cuda(a8, w8.w, s8, w8.scale, torch.bfloat16,
                                                   w8.colsum, z8, w8.bias),
        "fp8_matmul": lambda: cb.fp8_matmul_cuda(af, wf.w, sf, wf.scale, torch.bfloat16,
                                                 wf.bias),
        "rmsnorm_flux": lambda: cb.rms_norm_cuda(fx, fw, 1e-6),
        "rmsnorm_wan": lambda: cb.rms_norm_cuda(wx, gq, 1e-6),
        "rotembd_flux": lambda: cb.rotary_pos_embedding_cuda(fq, fk, hd, fcos, fsin),
        "rotembd_neox": lambda: cb.rotary_pos_embedding_cuda(fq, fk, hd, fcos, fsin,
                                                             is_neox=True),
        "int4_gemm_flux": lambda: cb.int4_matmul_cuda(a4, u4, s4, w4.scale, torch.bfloat16,
                                                      w4.bias),
        "quantize_int4_flux": lambda: cb.quantize_to_int4_cuda(x),
        "unpack_int4_flux": lambda: cb.unpack_int4_cuda(w4.w4p),
    }
    plain = {"rmsnorm_flux": lambda: tb.rms_norm_torch(fx, fw, 1e-6),
             "rmsnorm_wan": lambda: tb.rms_norm_torch(wx, gq, 1e-6)}

    def ms(fn, iters):
        # the card's clocks follow its load: a kernel is timed after 2 s of its
        # own calls, not at the clocks the previous kernel's load left
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.0:
            fn()
            torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # a busy-wait (~0.1 ms a call) holds the stream while the host queues
        # the calls: a kernel shorter than its wrapper's host time is timed on
        # the device
        torch.cuda._sleep(200_000 * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {"root": root}
    for name, fn in kernels.items():
        if only and name not in only:
            continue
        try:
            got = fn()
        except (NotImplementedError, AttributeError, NameError):
            continue
        # (contiguous: the unpack returns the (K, N) view of an (N, K) buffer)
        out[f"{name}_checksum"] = sum(int(t.contiguous().view(torch.int16).long().sum())
                                      for t in (got if isinstance(got, tuple) else (got,)))
        if name in plain:
            want = plain[name]().float()
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - 7)
            out[f"{name}_max_ulp"] = ((got.float() - want).abs() / ulp).max().item()
            del want, ulp
        out[f"{name}_ms"] = ms(fn, 20)
        del got
    return out


def main() -> int:
    args = sys.argv[1:]
    only = ""
    if args[:1] == ["--kernels"] and len(args) > 1:
        only, args = args[1], args[2:]
    if len(args) > 1 and args[0] == "--one":
        print(json.dumps(_one(args[1], set(filter(None, only.split(","))))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 1
    runs = []
    for root in args:
        one = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernels", only,
                              "--one", root], check=True, stdout=subprocess.PIPE, text=True)
        line = one.stdout.splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    names = list(dict.fromkeys(key[:-3] for r in runs for key in r if key.endswith("_ms")))
    for root in dict.fromkeys(args):
        mine = [r for r in runs if r["root"] == root]
        summary = {"root": root, "runs": len(mine)}
        for name in names:
            ms = sorted(r[f"{name}_ms"] for r in mine if f"{name}_ms" in r)
            if not ms:
                continue
            summary[name] = {"median_ms": statistics.median(ms), "min_ms": ms[0],
                             "max_ms": ms[-1],
                             "same_output": len({r[f"{name}_checksum"] for r in runs
                                                 if f"{name}_checksum" in r}) == 1}
            ulps = [r[f"{name}_max_ulp"] for r in mine if f"{name}_max_ulp" in r]
            if ulps:
                summary[name]["max_ulp"] = max(ulps)
        print(json.dumps(summary), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
