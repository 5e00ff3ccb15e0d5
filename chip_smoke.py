#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero and prints no result line:
  1. kernels: build every hand-written kernel from csrc/ (one nvcc per source,
     all at once), run each at the FLUX.1-dev 1024x2048 main-path shapes and
     hold it to its plain PyTorch version with a stated tolerance; time the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (a yardstick the port never calls). The W8A8 kernels
     are also timed at every GEMM / quantize shape of a forward, which gives
     the forward's GEMM and quantize time.
  2. slice: FLUX.1-dev at full width (19 dual + 38 single blocks, 24x128
     heads, random weights from a seed) three times: in bf16, in int8 and in
     fp8 (W8A8 block linears drawn straight into int8 / e4m3). Each serves
     1024x2048 requests through make_flux_denoiser with TeaCache, then the
     full-size FLUX VAE decoder; launch counters are zeroed just before each
     path and read just after: every kernel of the path must have run, and the
     W8A8 quantize and GEMM exactly 228 times per computed forward. One
     full-width forward on the kernels is then held to the same forward on
     the plain versions and, for W8A8, to the forward with only the W8A8 ops
     on their plain versions (bit-identical for int8).
  3. engine: a synthetic diffusers-layout FLUX checkpoint (full width, one
     dual and one single block, full-size VAE) is written to a scratch dir;
     FastDMEngine loads it in bf16, with use_int8 and with use_fp8 (load-time
     quantization) and calls generate() once each.

Before the last line it prints the card's name and power limit and a
{"kernels": [...]} line; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX or of fastdm_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
INT8_FP8_OPS = 1979e12       # H100 SXM dense int8 / fp8 tensor cores
F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores

# FLUX.1-dev at 1024x2048: 64x128 latent tokens, 512 text tokens
IMG_TOKENS, TXT_TOKENS = 64 * 128, 512
HEADS, HEAD_DIM = 24, 128
DIM, MLP = HEADS * HEAD_DIM, 4 * HEADS * HEAD_DIM
DUAL, SINGLE = 19, 38
# the W8A8 linears of one forward (quant_mods=False): (M, K, N) -> count
W8A8_GEMMS = {}
for _m, _n in ((IMG_TOKENS, DUAL), (TXT_TOKENS, DUAL)):
    for _kn in ((DIM, 3 * DIM), (DIM, DIM), (DIM, MLP), (MLP, DIM)):
        W8A8_GEMMS[(_m, *_kn)] = _n
W8A8_GEMMS[(IMG_TOKENS + TXT_TOKENS, DIM, 3 * DIM + MLP)] = SINGLE  # qkv_mlp
W8A8_GEMMS[(IMG_TOKENS + TXT_TOKENS, DIM + MLP, DIM)] = SINGLE      # proj_out
W8A8_PER_FORWARD = sum(W8A8_GEMMS.values())                        # 228
QKV_MLP = (IMG_TOKENS + TXT_TOKENS, DIM, 3 * DIM + MLP)            # the timing shape


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch

    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1


def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from fastdm_tpu_torch.kernels import build, cuda_backend, torch_backend
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_rope_cache

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[kernels] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # --- rmsnorm: per-head q norm on the strided q view of a fused QKV output
    qkv = torch.randn(1, IMG_TOKENS, 3 * HEADS * HEAD_DIM, generator=g, device=dev,
                      dtype=torch.bfloat16)
    x = qkv[..., :HEADS * HEAD_DIM].reshape(1, IMG_TOKENS, HEADS, HEAD_DIM)
    w = (1 + 0.05 * torch.randn(HEAD_DIM, generator=g, device=dev)).to(torch.bfloat16)
    eps = 1e-6
    got = cuda_backend.rms_norm_cuda(x, w, eps)
    ref = torch_backend.rms_norm_torch(x, w, eps)
    err = (got.float() - ref.float()).abs()
    ulps = (err / bf16_ulp(ref)).max().item()
    log(f"[rmsnorm] {tuple(x.shape)} bf16: max_abs_err {err.max().item():.3e}, "
        f"max {ulps:.2f} bf16 ulp (tolerance 1 ulp)")
    if not ulps <= 1.0:
        raise AssertionError(f"rmsnorm disagrees with its plain version: {ulps} ulp")
    ms = cuda_ms(lambda: cuda_backend.rms_norm_cuda(x, w, eps), 50)
    plain_ms = cuda_ms(lambda: torch_backend.rms_norm_torch(x, w, eps), 10)
    lib_ms = None
    if hasattr(F, "rms_norm"):
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (HEAD_DIM,), w, eps), 50)
    n = x.numel()
    b_ms, b_by = bound(2 * n * 2 + HEAD_DIM * 2, 4 * n, F32_FLOPS)
    results["rmsnorm"] = dict(
        name="rmsnorm", route="cuda", source="fastdm_tpu_torch/csrc/rmsnorm.cu",
        replaces="fastdm_tpu/kernels/pallas/elementwise.py:66",
        max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    del qkv, x, got, ref, err

    # --- rotembd: joint (txt + img) q and k with the real FLUX cos/sin
    s = TXT_TOKENS + IMG_TOKENS
    cos, sin = flux_rope_cache(FluxConfig(), TXT_TOKENS, 64, 128, device=dev)
    q = torch.randn(1, s, HEADS * HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, s, HEADS * HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    worst, max_err = 0.0, 0.0
    gq, gk = cuda_backend.rotary_pos_embedding_cuda(q, k, HEAD_DIM, cos, sin)
    rq, rk = torch_backend.rotary_pos_embedding_torch(q, k, HEAD_DIM, cos, sin)
    for a, r in ((gq, rq), (gk, rk)):
        e = (a.float() - r.float()).abs()
        worst = max(worst, (e / bf16_ulp(r)).max().item())
        max_err = max(max_err, e.max().item())
    log(f"[rotembd] {tuple(q.shape)} bf16 interleaved: max_abs_err {max_err:.3e}, "
        f"max {worst:.2f} bf16 ulp (tolerance 1 ulp)")
    del gq, gk, rq, rk
    if not worst <= 1.0:
        raise AssertionError(f"rotembd disagrees with its plain version: {worst} ulp")
    ms = cuda_ms(lambda: cuda_backend.rotary_pos_embedding_cuda(q, k, HEAD_DIM, cos, sin), 50)
    plain_ms = cuda_ms(lambda: torch_backend.rotary_pos_embedding_torch(
        q, k, HEAD_DIM, cos, sin), 10)
    n = q.numel() + k.numel()
    b_ms, b_by = bound(2 * n * 2 + 2 * cos.numel() * 4, 3 * n, F32_FLOPS)
    results["rotembd"] = dict(
        name="rotembd", route="cuda", source="fastdm_tpu_torch/csrc/rope.cu",
        replaces="fastdm_tpu/kernels/pallas/elementwise.py:483",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)

    # --- sdpa: the joint self-attention, plus causal, GQA and D=64 cases. At
    # the FLUX shape the outputs average 8704 keys (std ~0.018), so that case is
    # held to max|err| <= 1e-3 + 2 bf16 ulp of |plain| and relative L2 <= 5e-3
    # (one 64-key tile dropped or doubled gives ~5e-2); the smaller cases, whose
    # outputs are larger, to 1e-2 + 1e-2*|plain|.
    v = torch.randn(1, s, HEADS * HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    cases = [("flux", q, k, v, HEADS, HEADS, HEAD_DIM, False)]
    for name, sq, hq, hkv, d, causal in (("causal", 1000, 8, 8, 128, True),
                                          ("gqa", 777, 8, 2, 128, False),
                                          ("d64-causal-gqa", 300, 4, 2, 64, True)):
        cq = torch.randn(2, sq, hq * d, generator=g, device=dev, dtype=torch.bfloat16)
        ck = torch.randn(2, sq, hkv * d, generator=g, device=dev, dtype=torch.bfloat16)
        cv = torch.randn(2, sq, hkv * d, generator=g, device=dev, dtype=torch.bfloat16)
        cases.append((name, cq, ck, cv, hq, hkv, d, causal))
    flux_err = None
    for name, cq, ck, cv, hq, hkv, d, causal in cases:
        got = cuda_backend.sdpa_cuda(cq, ck, cv, hq, hkv, d, causal)
        ref = torch_backend.sdpa_torch(cq, ck, cv, hq, hkv, d, causal)
        e = (got.float() - ref.float()).abs()
        rel = (e.norm() / ref.float().norm()).item()
        if name == "flux":
            tol, rel_tol, stated = 1e-3 + 2 * bf16_ulp(ref), 5e-3, "1e-3 + 2 ulp, rel L2 5e-3"
        else:
            tol, rel_tol, stated = 1e-2 + 1e-2 * ref.float().abs(), None, "1e-2 + 1e-2*|plain|"
        excess = (e - tol).max().item()
        log(f"[sdpa] {name} q{tuple(cq.shape)} k{tuple(ck.shape)} causal={causal}: "
            f"max_abs_err {e.max().item():.3e}, rel L2 {rel:.3e} (tolerance {stated})")
        if (not excess <= 0 or (rel_tol is not None and not rel <= rel_tol)
                or not torch.isfinite(got).all()):
            raise AssertionError(f"sdpa {name} disagrees with its plain version")
        if name == "flux":
            flux_err = e.max().item()
    ms = cuda_ms(lambda: cuda_backend.sdpa_cuda(q, k, v, HEADS, HEADS, HEAD_DIM), 10)
    plain_ms = cuda_ms(lambda: torch_backend.sdpa_torch(q, k, v, HEADS, HEADS, HEAD_DIM), 3, 1)
    heads = lambda t: t.view(1, s, HEADS, HEAD_DIM).transpose(1, 2)  # noqa: E731
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 10)
    b_ms, b_by = bound(4 * q.numel() * 2, 4 * s * s * HEAD_DIM * HEADS, BF16_FLOPS)
    results["sdpa"] = dict(
        name="sdpa", route="cuda", source="fastdm_tpu_torch/csrc/flash_attn.cu",
        replaces="fastdm_tpu/kernels/pallas/attention.py:429",
        max_abs_err=flux_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms)
    del q, k, v, cases
    torch.cuda.empty_cache()
    results.update(_w8a8_kernels(dev, g))
    for r in results.values():
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library {r['library_ms']})")
    return results


def _quantize_bytes(m: int, k: int, fp8: bool) -> int:
    # x read once (bf16), q written once, scale (and zp) per row
    return 3 * m * k + m * (4 if fp8 else 8)


def _gemm_bytes(m: int, k: int, n: int) -> int:
    # a, b read once, bf16 out written once, scales/colsum/bias/azp once
    return m * k + k * n + 2 * m * n + 8 * m + 10 * n


def _w8a8_operands(quant: str, m: int, k: int, n: int, g, dev):
    """A bf16 activation quantized per token by the plain version, a random
    W8A8 QLinear drawn as flux_init_random draws it, and the GEMM's arguments."""
    import torch

    from fastdm_tpu_torch.kernels import torch_backend
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    lin = qlinear_random(g, k, n, quant=quant, device=dev)
    if quant == "int8":
        a, sa, azp = torch_backend.quantize_to_int8_torch(x, symmetric=False)
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, azp, lin.bias)
    else:
        a, sa = torch_backend.quantize_to_fp8_torch(x)
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.bias)
    return a, sa, lin, args


def _w8a8_kernels(dev, g) -> dict:
    """The per-token quantizers and the W8A8 GEMMs against their plain
    versions at the FLUX single-block shapes (K = 3072 and K = 15360, the
    longest on the path), timed at the qkv_mlp shape and at every GEMM and
    quantize shape of a forward. Quantizers and the int8 GEMM are held
    bit-exact; the fp8 GEMM (f32 sums in another order) to 1 bf16 ulp of
    |plain| plus 2^-16 * scale_a*scale_b*(|a| @ |b|) for outputs that cancel."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    m_single = IMG_TOKENS + TXT_TOKENS
    results = {}
    quantizers = {
        "quantize_to_int8": (lambda x: cb.quantize_to_int8_cuda(x, symmetric=False),
                             lambda x: tb.quantize_to_int8_torch(x, symmetric=False),
                             "elementwise.py:162", False),
        "quantize_to_fp8": (cb.quantize_to_fp8_cuda, tb.quantize_to_fp8_torch,
                            "elementwise.py:208", True),
    }
    for name, (kern, plain, replaces, fp8) in quantizers.items():
        for k in (DIM, DIM + MLP):
            x = torch.randn(m_single, k, generator=g, device=dev, dtype=torch.bfloat16)
            x[0] = 0  # an all-zero row
            got, want = kern(x), plain(x)
            same = all(torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1 else a,
                                   b.view(torch.uint8) if b.dtype.itemsize == 1 else b)
                       for a, b in zip(got, want))
            log(f"[{name}] ({m_single}, {k}) bf16: q, scale{'' if fp8 else ', zp'} "
                f"bit-exact with the plain version: {same}")
            if not same:
                raise AssertionError(f"{name} disagrees with its plain version at K={k}")
        x = torch.randn(m_single, DIM, generator=g, device=dev, dtype=torch.bfloat16)
        b_ms, b_by = bound(_quantize_bytes(m_single, DIM, fp8), 8 * m_single * DIM, F32_FLOPS)
        results[name] = dict(
            name=name, route="cuda", source="fastdm_tpu_torch/csrc/quant.cu",
            replaces=f"fastdm_tpu/kernels/pallas/{replaces}", max_abs_err=0.0,
            ms=cuda_ms(lambda: kern(x), 50), plain_ms=cuda_ms(lambda: plain(x), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del x, got, want

    m, k, n = QKV_MLP
    w16 = torch.randn(k, n, generator=g, device=dev, dtype=torch.bfloat16)
    x16 = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    log(f"[w8a8] bf16 torch.matmul at the qkv_mlp shape ({m}x{k} @ {k}x{n}): "
        f"{cuda_ms(lambda: x16 @ w16, 20):.4f} ms (yardstick)")
    del w16, x16
    for quant in ("int8", "fp8"):
        name = f"{quant}_matmul"
        kern = getattr(cb, f"{name}_cuda")
        plain = getattr(tb, f"{name}_torch")
        worst = 0.0
        for k_, n_ in ((DIM, 3 * DIM + MLP), (DIM + MLP, DIM)):
            a, sa, lin, args = _w8a8_operands(quant, m, k_, n_, g, dev)
            got, want = kern(*args).float(), plain(*args).float()
            err = (got - want).abs()
            worst = max(worst, err.max().item())
            if quant == "int8":
                ok, stated = torch.equal(got, want), "bit-exact"
            else:
                mag = (a.float().abs() @ lin.w.float().abs()) * (sa * lin.scale[None, :])
                ok = bool((err <= bf16_ulp(want) + 2.0**-16 * mag).all())
                stated = "1 bf16 ulp + 2^-16 * sa*sb*(|a|@|b|)"
                del mag
            log(f"[{name}] {m}x{k_} @ {k_}x{n_}: max_abs_err {err.max().item():.3e} "
                f"(tolerance {stated}): {ok}")
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"{name} disagrees with its plain version at K={k_}")
            del got, want, err
        a, sa, lin, args = _w8a8_operands(quant, m, k, n, g, dev)
        ms = cuda_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 2, 1)
        if quant == "int8":  # the s32 product alone: no azp, scales or bias
            lib_call = lambda: torch._int_mm(a, lin.w)  # noqa: E731
            lib = "torch._int_mm, s32 product only"
        else:
            lib_call = lambda: torch._scaled_mm(  # noqa: E731
                a, lin.w, scale_a=sa, scale_b=lin.scale.reshape(1, -1), bias=lin.bias,
                out_dtype=torch.bfloat16)
            lib = "torch._scaled_mm, row-wise scales, bias, bf16 out"
        try:  # a yardstick only; the port never calls it
            lib_ms = cuda_ms(lib_call, 20)
        except RuntimeError as e:
            lib_ms, lib = None, f"{lib}: not available here ({str(e).splitlines()[0]})"
        b_ms, b_by = bound(_gemm_bytes(m, k, n), 2 * m * n * k, INT8_FP8_OPS)
        log(f"[{name}] qkv_mlp {m}x{k} @ {k}x{n}: {ms:.4f} ms "
            f"({2 * m * n * k / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, "
            f"library {lib_ms} ms ({lib})")
        results[name] = dict(
            name=name, route="cuda", source="fastdm_tpu_torch/csrc/w8a8_gemm.cu",
            replaces=f"fastdm_tpu/kernels/pallas/matmul.py:{158 if quant == 'int8' else 182}",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms)
        del a, sa, lin, args

        # every GEMM and quantize shape of one forward, for the forward's split
        gemm_ms = quant_ms = gemm_bound = quant_bound = 0.0
        for (mm, kk, nn), count in W8A8_GEMMS.items():
            _, _, _, args = _w8a8_operands(quant, mm, kk, nn, g, dev)
            gemm_ms += count * cuda_ms(lambda: kern(*args), 5)
            gemm_bound += count * bound(_gemm_bytes(mm, kk, nn), 2 * mm * nn * kk,
                                        INT8_FP8_OPS)[0]
            x = torch.randn(mm, kk, generator=g, device=dev, dtype=torch.bfloat16)
            qk = quantizers[f"quantize_to_{quant}"][0]
            quant_ms += count * cuda_ms(lambda: qk(x), 5)
            quant_bound += count * bound(_quantize_bytes(mm, kk, quant == "fp8"),
                                         8 * mm * kk, F32_FLOPS)[0]
            del args, x
        log(f"[w8a8] {quant} forward ({W8A8_PER_FORWARD} linears, from kernel times at each "
            f"shape): GEMMs {gemm_ms:.3f} ms (bound {gemm_bound:.3f} ms), quantize "
            f"{quant_ms:.3f} ms (bound {quant_bound:.3f} ms)")
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 2

# TeaCache as bench.py's FLUX default (threshold 0.25 with random weights,
# the reference's published 5-term polynomial)
TEACACHE = dict(cache_algorithm="teacache", enable_caching=True, threshold=0.25,
                coefficients=(4.98651651e02, -2.83781631e02, 5.58554382e01,
                              -3.82021401e00, 2.64230861e-01))
STEPS = 4
# Relative L2 of a full-width forward on the kernels against the same forward
# on the plain versions, per weight format: twice the first value measured on
# an H100 80GB HBM3 (bf16 1.533e-2, int8 2.895e-2, fp8 5.336e-2). The W8A8
# formats sit higher although their kernels match their plain versions (int8
# bit for bit): each per-token quantization turns a one-ulp difference
# upstream (rmsnorm, sdpa) into a whole quantization step in a few elements,
# and e4m3's steps are the coarsest. A wrong tile, scale or layout gives O(1).
FORWARD_REL_L2_TOL = {None: 3e-2, "int8": 6e-2, "fp8": 1.1e-1}
W8A8_OPS = ("quantize_to_int8", "quantize_to_fp8", "int8_matmul", "fp8_matmul")
# (quant, request seeds): the bf16 path of the first slice, then W8A8
PATHS = ((None, (11, 12, 13)), ("int8", (21, 22, 23)), ("fp8", (31,)))
PATH_KERNELS = {None: ("rmsnorm", "rotembd", "sdpa"),
                "int8": ("rmsnorm", "rotembd", "sdpa", "quantize_to_int8", "int8_matmul"),
                "fp8": ("rmsnorm", "rotembd", "sdpa", "quantize_to_fp8", "fp8_matmul")}


def _conditioning(dev, seed: int, cfg, seq: int):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    latents = torch.randn(1, seq, cfg.in_channels, generator=g, device=dev)
    encoder = torch.randn(1, TXT_TOKENS, cfg.joint_attention_dim, generator=g, device=dev,
                          dtype=torch.bfloat16)
    pooled = torch.randn(1, cfg.pooled_projection_dim, generator=g, device=dev,
                         dtype=torch.bfloat16)
    return latents, encoder, pooled


def _launch_counts():
    from fastdm_tpu_torch.kernels import cuda_backend as cb

    return {"rmsnorm": cb.rms_norm_cuda.launches, "rotembd": cb.rotary_pos_embedding_cuda.launches,
            "sdpa": cb.sdpa_cuda.launches, "quantize_to_int8": cb.quantize_to_int8_cuda.launches,
            "quantize_to_fp8": cb.quantize_to_fp8_cuda.launches,
            "int8_matmul": cb.int8_matmul_cuda.launches, "fp8_matmul": cb.fp8_matmul_cuda.launches}


def _serve_path(dev, quant, seeds, vae, vae_cfg) -> dict:
    """FLUX.1-dev at full width in one weight format: requests, launch check,
    kernel forward vs plain forward. Returns the launches of the path's kernels."""
    import torch

    from fastdm_tpu_torch.caching.config import TeaCacheConfig
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_forward, flux_init_random, \
        flux_rope_cache
    from fastdm_tpu_torch.pipeline.denoise import flux_unpack_latents, make_flux_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, \
        flow_match_shift_mu
    from fastdm_tpu_torch.pipeline.vae import vae_decode

    label = quant or "bf16"
    cfg = FluxConfig(quant=quant)  # FLUX.1-dev: 19 dual + 38 single blocks, 24x128 heads
    ht, wt = 64, 128               # 1024x2048 pixels
    t0 = time.perf_counter()
    params = flux_init_random(0, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[slice {label}] FLUX.1-dev {label} random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.1f} GiB) in {time.perf_counter() - t0:.1f} s")
    sched = FlowMatchEulerScheduler.create(STEPS, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * wt))
    run = make_flux_denoiser(cfg, sched, STEPS, TeaCacheConfig(**TEACACHE), guidance_scale=3.5)
    cos, sin = flux_rope_cache(cfg, TXT_TOKENS, ht, wt, device=dev)

    torch.cuda.reset_peak_memory_stats()
    computed = 0
    cuda_backend.reset_launch_counts()
    for seed in seeds:
        latents, encoder, pooled = _conditioning(dev, seed, cfg, ht * wt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, skips = run(params, latents, encoder, pooled, cos, sin)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = vae_decode(vae, vae_cfg, flux_unpack_latents(lat, ht, wt))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        computed += STEPS - skips
        finite = bool(torch.isfinite(img).all())
        log(f"[slice {label}] request seed={seed} 1024x2048 {STEPS} steps: {t2 - t0:.3f} s "
            f"(denoise {t1 - t0:.3f} s, VAE decode {t2 - t1:.3f} s), TeaCache skipped "
            f"{skips}/{STEPS}, image {tuple(img.shape)} finite={finite}")
        if not finite or tuple(img.shape) != (1, 1024, 2048, 3):
            raise AssertionError(f"{label} request seed={seed} produced a bad image")
    counts = _launch_counts()
    log(f"[slice {label}] kernel launches over {len(seeds)} requests ({computed} computed "
        f"forwards): {counts}")
    mine = {k: counts[k] for k in PATH_KERNELS[quant]}
    if min(mine.values()) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: {counts}")
    if quant is not None:
        want = W8A8_PER_FORWARD * computed
        other = "fp8" if quant == "int8" else "int8"
        if (counts[f"quantize_to_{quant}"], counts[f"{quant}_matmul"]) != (want, want) \
                or counts[f"quantize_to_{other}"] or counts[f"{other}_matmul"]:
            raise AssertionError(f"{label}: expected {W8A8_PER_FORWARD} x {computed} = {want} "
                                 f"quantize and GEMM launches, got {counts}")
        log(f"[slice {label}] W8A8 launch check: {W8A8_PER_FORWARD} x {computed} computed "
            f"forwards = {want} quantize and {want} GEMM launches, as counted")
    log(f"[slice {label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # one full-width forward on the kernels vs the same forward on the plain
    # versions; for W8A8 also vs the forward with only the W8A8 ops plain,
    # which the int8 kernels must match bit for bit
    latents, encoder, pooled = _conditioning(dev, 99, cfg, ht * wt)
    t = torch.full((1,), float(sched.sigmas[0]), device=dev)
    guidance = torch.full((1,), 3.5, device=dev)
    x = latents.to(torch.bfloat16)

    def forward(plain_ops=()):
        with kernel_registry.plain_on_device(plain_ops):
            return flux_forward(params, cfg, x, encoder, pooled, t, cos, sin, guidance).float()

    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    tol = FORWARD_REL_L2_TOL[quant]
    with torch.inference_mode():
        forward()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_p = forward(plain_ops=None)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if quant is not None:
            out_w = forward(plain_ops=W8A8_OPS)
            rel_w, same_w = rel_l2(out_k, out_w), torch.equal(out_k, out_w)
            log(f"[slice {label}] full-width forward with only the W8A8 ops plain: relative L2 "
                f"difference {rel_w:.3e}, bit-identical {same_w} (required: "
                f"{'bit-identical' if quant == 'int8' else f'<= {tol}'})")
            if not (same_w if quant == "int8" else rel_w <= tol):
                raise AssertionError(f"{label} W8A8 kernels change the forward: {rel_w}")
            del out_w
    rel = rel_l2(out_k, out_p)
    log(f"[slice {label}] full-width forward: kernels {t1 - t0:.3f} s, plain versions "
        f"{t2 - t1:.3f} s, relative L2 difference {rel:.3e} (tolerance {tol})")
    if not rel <= tol or not torch.isfinite(out_k).all():
        raise AssertionError(f"{label} kernel forward departs from the plain forward: {rel}")
    del params, out_k, out_p
    torch.cuda.empty_cache()
    return mine


def phase_slice(dev) -> dict:
    """Every weight format's path; returns {kernel: launches} (the bf16 path's
    counts for the first slice's kernels, each W8A8 path's for its own)."""
    import torch

    from fastdm_tpu_torch.pipeline.vae import VAEConfig, vae_decoder_random

    vae_cfg = VAEConfig(latent_channels=16)
    vae = vae_decoder_random(1, vae_cfg, device=dev)
    launches = {}
    for quant, seeds in PATHS:
        for k, v in _serve_path(dev, quant, seeds, vae, vae_cfg).items():
            launches.setdefault(k, v)
    del vae
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 3


def _write_checkpoint(root: str, dev) -> None:
    """Synthetic diffusers-layout FLUX checkpoint: FLUX.1-dev widths with one
    dual and one single block, plus the full-size FLUX AutoencoderKL decoder."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.flux import FluxConfig
    from fastdm_tpu_torch.pipeline.vae import VAEConfig

    cfg = FluxConfig(num_layers=1, num_single_layers=1)
    g = torch.Generator(device=dev).manual_seed(5)
    sd = {}

    def lin(name, k, n, std=0.02):
        sd[f"{name}.weight"] = (torch.randn(n, k, generator=g, device=dev) * std).bfloat16().cpu()
        sd[f"{name}.bias"] = (torch.randn(n, generator=g, device=dev) * 0.01).bfloat16().cpu()

    d, mlp = cfg.inner_dim, cfg.mlp_hidden_dim
    for e, k in (("timestep_embedder", 256), ("guidance_embedder", 256),
                 ("text_embedder", cfg.pooled_projection_dim)):
        lin(f"time_text_embed.{e}.linear_1", k, d)
        lin(f"time_text_embed.{e}.linear_2", d, d)
    lin("context_embedder", cfg.joint_attention_dim, d)
    lin("x_embedder", cfg.in_channels, d)
    p = "transformer_blocks.0"
    lin(f"{p}.norm1.linear", d, 6 * d)
    lin(f"{p}.norm1_context.linear", d, 6 * d)
    for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0",
              "to_add_out"):
        lin(f"{p}.attn.{n}", d, d)
    for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        sd[f"{p}.attn.{n}.weight"] = torch.ones(cfg.attention_head_dim, dtype=torch.bfloat16)
    for ff in ("ff", "ff_context"):
        lin(f"{p}.{ff}.net.0.proj", d, mlp)
        lin(f"{p}.{ff}.net.2", mlp, d)
    p = "single_transformer_blocks.0"
    lin(f"{p}.norm.linear", d, 3 * d)
    for n in ("to_q", "to_k", "to_v"):
        lin(f"{p}.attn.{n}", d, d)
    for n in ("norm_q", "norm_k"):
        sd[f"{p}.attn.{n}.weight"] = torch.ones(cfg.attention_head_dim, dtype=torch.bfloat16)
    lin(f"{p}.proj_mlp", d, mlp)
    lin(f"{p}.proj_out", d + mlp, d)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg.out_channels)
    os.makedirs(os.path.join(root, "transformer"))
    save_file(sd, os.path.join(root, "transformer", "model.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump({"num_layers": 1, "num_single_layers": 1}, f)

    vcfg = VAEConfig(latent_channels=16)
    sd = {}

    def conv(name, cin, cout, k=3):
        sd[f"{name}.weight"] = (torch.randn(cout, cin, k, k, generator=g, device=dev)
                                * 0.05).cpu()
        sd[f"{name}.bias"] = torch.zeros(cout)

    def norm(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(c), torch.zeros(c)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, k=1)

    rev = list(reversed(vcfg.block_out_channels))
    top = rev[0]
    conv("decoder.conv_in", vcfg.latent_channels, top)
    resnet("decoder.mid_block.resnets.0", top, top)
    resnet("decoder.mid_block.resnets.1", top, top)
    norm("decoder.mid_block.attentions.0.group_norm", top)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        sd[f"decoder.mid_block.attentions.0.{n}.weight"] = (
            torch.randn(top, top, generator=g, device=dev) * 0.02).cpu()
        sd[f"decoder.mid_block.attentions.0.{n}.bias"] = torch.zeros(top)
    prev = top
    for i, c in enumerate(rev):
        for r in range(vcfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{r}", prev if r == 0 else c, c)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
        prev = c
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], 3)
    conv("post_quant_conv", vcfg.latent_channels, vcfg.latent_channels, k=1)
    os.makedirs(os.path.join(root, "vae"))
    save_file(sd, os.path.join(root, "vae", "model.safetensors"))


def phase_engine(dev) -> None:
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.engine import FastDMEngine

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
        t0 = time.perf_counter()
        _write_checkpoint(root, dev)
        log(f"[engine] wrote the synthetic checkpoint in {time.perf_counter() - t0:.1f} s")
        for seed, flags in ((1, {}), (2, {"use_int8": True}), (3, {"use_fp8": True})):
            t0 = time.perf_counter()
            eng = FastDMEngine(root, architecture="flux", cache_config=dict(TEACACHE),
                               verbose=False, **flags)
            label = eng.cfg.quant or "bf16"
            log(f"[engine {label}] FastDMEngine loaded in {time.perf_counter() - t0:.1f} s "
                f"({eng.cfg.num_layers} dual + {eng.cfg.num_single_layers} single blocks, "
                f"inner dim {eng.cfg.inner_dim}, block linears "
                f"{eng.params.single_blocks[0].qkv_mlp.w.dtype})")
            want = {None: torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
            if eng.params.dual_blocks[0].attn.qkv.w.dtype != want[eng.cfg.quant]:
                raise AssertionError(f"engine {flags} loaded the wrong weight format")
            g = torch.Generator(device=dev).manual_seed(100 + seed)
            embeds = torch.randn(1, TXT_TOKENS, eng.cfg.joint_attention_dim, generator=g,
                                 device=dev, dtype=torch.bfloat16)
            pooled = torch.randn(1, eng.cfg.pooled_projection_dim, generator=g, device=dev,
                                 dtype=torch.bfloat16)
            t0 = time.perf_counter()
            img = eng.generate(prompt_embeds=embeds, pooled_prompt_embeds=pooled, height=1024,
                               width=1024, num_inference_steps=STEPS, seed=seed)
            log(f"[engine {label}] generate seed={seed} 1024x1024 {STEPS} steps: "
                f"{time.perf_counter() - t0:.3f} s, image {img.shape} {img.dtype}, "
                f"TeaCache skipped {eng.last_cache_skips}")
            if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
                    and img.shape == (1, 1024, 1024, 3)):
                raise AssertionError(f"generate returned {type(img)} {getattr(img, 'shape', '')}")
            del eng
            torch.cuda.empty_cache()


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to drive", file=sys.stderr)
        return 1
    import fastdm_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    dev = torch.device("cuda")
    # the plain versions' f32 products (fp8 GEMM) in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    kernels = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_engine(dev)
    for name, r in kernels.items():
        r["launches"] = launches[name]

    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
