"""TeaCache polynomial-coefficient fitting on the PyTorch/CUDA port (port of
examples/xcaching/fit_teacache.py: the same flags, flow and output JSON,
plus --device).

Records, over an uncached generation, per-step pairs of
  x = rel-L1 distance of the block-0 modulated input between steps
  y = rel-L1 change of the full block-stack residual between steps
and fits y ~ poly(x) (degree 4), producing the `coefficients` consumed by
TeaCacheConfig. --dual (qwen) also fits `negtive_coefficients` on the
true-CFG negative branch; --algorithm dicache (flux) records the output of
the first --probe-depth dual blocks instead and sweeps thresholds.

Runs with random weights when no checkpoint is given (the fit is then only a
pipeline smoke test; real coefficients need real weights + prompts). The
model-facing velocity of each step is the head applied to the recorded
block-stack output (the reference calls the whole forward again: the same
values, computed once here).

    python examples/xcaching/fit_teacache_torch.py --architecture flux \\
        --model-path CKPT --steps 25 --output teacache_flux.json
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def rel_l1(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _quant(args) -> Optional[str]:
    return "int8" if args.use_int8 else ("fp8" if args.use_fp8 else None)


def _draws(args, dev, shapes: Dict[str, tuple], inputs: Optional[dict]) -> dict:
    """The run's random inputs: `inputs` (numpy arrays, e.g. another
    implementation's draws) where given, else normal draws from a
    torch.Generator seeded with --seed; the latents f32, the rest bf16."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = {}
    for name, shape in shapes.items():
        dt = torch.float32 if name == "latents" else torch.bfloat16
        if inputs is not None and name in inputs:
            out[name] = torch.from_numpy(np.array(inputs[name], np.float32)).to(dev, dt)
        else:
            out[name] = torch.randn(shape, generator=gen, device=dev).to(dt)
    return out


def _source(args, dev):
    from fastdm_tpu_torch.models.loader import TensorSource

    return TensorSource.from_path(os.path.join(args.model_path, "transformer"), dev)


def _write(out: dict, args) -> None:
    print(json.dumps(out, indent=2))
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.output}")


def _polyfit_and_write(xs, ys, args, negtive_coefficients=None) -> None:
    coeffs = np.polyfit(np.asarray(xs), np.asarray(ys), deg=min(4, len(xs) - 1))
    out = {"cache_algorithm": "teacache", "enable_caching": True, "threshold": args.threshold,
           "coefficients": [float(c) for c in coeffs]}
    if negtive_coefficients is not None:
        # reference spelling (TeaCacheConfig.negtive_coefficients)
        out["negtive_coefficients"] = [float(c) for c in negtive_coefficients]
    _write(out, args)


def _dicache_write(xs, ys, args, probe_depth: int) -> None:
    """The threshold sweep over the recorded delta_y series: for each
    quantile, the steps that would skip and the residual change they would
    incur; the threshold whose skip rate lands closest to 50%."""
    xs_a, ys_a = np.asarray(xs), np.asarray(ys)
    print("threshold sweep (delta_y -> skips, mean residual-change when skipping):")
    best = None
    target = 0.5
    for th in np.quantile(xs_a, [0.2, 0.35, 0.5, 0.65, 0.8]):
        mask = xs_a < th
        err = float(ys_a[mask].mean()) if mask.any() else 0.0
        ratio = mask.mean()
        print(f"  threshold={th:.4f}: skips {int(mask.sum())}/{len(xs_a)} mean_err={err:.4f}")
        if best is None or abs(ratio - target) < best[1]:
            best = (float(th), abs(ratio - target))
    _write({"cache_algorithm": "dicache", "enable_caching": True,
            "threshold": args.threshold if args.threshold != 0.25 else best[0],
            "probe_depth": probe_depth, "ret_ratio": 0.2, "rel_l1_distance_algo": "delta_y"},
           args)


def _step_log(i: int, xs, ys) -> None:
    print(f"step {i}: x={xs[-1] if xs else None} y={ys[-1] if ys else None}", flush=True)


def fit_flux(args, inputs: Optional[dict] = None) -> Tuple[List[float], List[float]]:
    """FLUX: x from dual block 0's modulated input (TeaCache) or the output
    of the first probe_depth dual blocks (DiCache) -> (xs, ys)."""
    import torch

    from fastdm_tpu_torch.device import resolve_device
    from fastdm_tpu_torch.models import flux as fm
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, flow_match_shift_mu

    dev = resolve_device(args.device)
    cfg = fm.FluxConfig(quant=_quant(args), quant_mods=args.quant_mods,
                        num_layers=args.layers or 19, num_single_layers=args.single_layers or 38)
    params = (fm.flux_load(_source(args, dev), cfg) if args.model_path
              else fm.flux_init_random(0, cfg, device=dev))
    ht, wt, txt = args.height // 16, args.width // 16, 512
    cos, sin = fm.flux_rope_cache(cfg, txt, ht, wt, device=dev)
    sched = FlowMatchEulerScheduler.create(args.steps, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * wt))
    d = _draws(args, dev, {"encoder": (1, txt, cfg.joint_attention_dim),
                           "pooled": (1, cfg.pooled_projection_dim),
                           "latents": (1, ht * wt, cfg.in_channels)}, inputs)
    dicache = args.algorithm == "dicache"
    guidance = torch.full((1,), args.guidance_scale, device=dev)
    xs, ys, prev = [], [], None
    lat = d["latents"]
    with torch.inference_mode():
        for i in range(args.steps):
            t = torch.full((1,), float(sched.sigmas[i]), device=dev)
            hidden, temb, encoder = fm._flux_embed(params, cfg, lat.bfloat16(), d["encoder"],
                                                   d["pooled"], t, guidance)
            if dicache:
                probe, _ = fm._run_dual(params, cfg, hidden, encoder, temb, cos, sin,
                                        stop=args.probe_depth)
            else:
                probe = params.dual_blocks[0].norm1(hidden, temb)[0]
            out = fm.flux_run_blocks(params, cfg, hidden, encoder, temb, cos, sin)
            cur = (_host(probe), _host(out - hidden))
            if prev is not None:
                xs.append(rel_l1(cur[0], prev[0]))
                ys.append(rel_l1(cur[1], prev[1]))
            prev = cur
            v = params.proj_out(params.norm_out(out, temb))
            lat = sched.step(v, i, lat)
            _step_log(i, xs, ys)
    if dicache:
        _dicache_write(xs, ys, args, args.probe_depth)
    else:
        _polyfit_and_write(xs, ys, args)
    return xs, ys


def fit_sd35(args, inputs: Optional[dict] = None) -> Tuple[List[float], List[float]]:
    """SD3.5: x from the first dual block's 9-chunk modulated input."""
    import torch

    from fastdm_tpu_torch.device import resolve_device
    from fastdm_tpu_torch.models import sd35 as sm
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler

    dev = resolve_device(args.device)
    cfg = sm.SD3Config(quant=_quant(args), num_layers=args.layers or 24)
    params = (sm.sd3_load(_source(args, dev), cfg) if args.model_path
              else sm.sd3_init_random(0, cfg, device=dev))
    lh, lw = args.height // 8, args.width // 8
    pos = sm.sd3_cropped_pos_embed(cfg, params.pos_embed_table, lh, lw, device=dev)
    sched = FlowMatchEulerScheduler.create(args.steps, shift=3.0)
    d = _draws(args, dev, {"encoder": (1, 77, cfg.joint_attention_dim),
                           "pooled": (1, cfg.pooled_projection_dim),
                           "latents": (1, cfg.in_channels, lh, lw)}, inputs)
    xs, ys, prev = [], [], None
    lat = d["latents"]
    with torch.inference_mode():
        for i in range(args.steps):
            t = torch.full((1,), float(sched.sigmas[i]) * 1000.0, device=dev)
            hidden, temb, encoder = sm._sd3_embed(params, cfg, lat, d["encoder"], d["pooled"],
                                                  t, pos)
            probe = params.dual_blocks[0].norm1(hidden, temb)[0]
            out = sm.sd3_run_blocks(params, cfg, hidden, encoder, temb)
            cur = (_host(probe), _host(out - hidden))
            if prev is not None:
                xs.append(rel_l1(cur[0], prev[0]))
                ys.append(rel_l1(cur[1], prev[1]))
            prev = cur
            v = sm._sd3_output(params, cfg, out, temb, 1, lh, lw)
            lat = sched.step(v, i, lat)
            _step_log(i, xs, ys)
    _polyfit_and_write(xs, ys, args)
    return xs, ys


def fit_qwen(args, inputs: Optional[dict] = None) -> Tuple[List[float], List[float]]:
    """Qwen-Image: x from block 0's TEXT-stream modulated input; --dual also
    records the true-CFG negative branch (its own text draw) and fits
    negtive_coefficients. The latents step on the positive branch."""
    import torch
    import torch.nn.functional as F

    from fastdm_tpu_torch.device import resolve_device
    from fastdm_tpu_torch.models import qwenimage as qm
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, flow_match_shift_mu

    dev = resolve_device(args.device)
    cfg = qm.QwenImageConfig(quant=_quant(args), quant_mods=args.quant_mods,
                             num_layers=args.layers or 60)
    params = (qm.qwen_load(_source(args, dev), cfg) if args.model_path
              else qm.qwen_init_random(0, cfg, device=dev))
    ht, wt, txt = args.height // 16, args.width // 16, 128
    cos, sin = qm.qwen_rope_cos_sin(cfg, 1, ht, wt, txt, device=dev)
    sched = FlowMatchEulerScheduler.create(args.steps, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * wt))
    shapes = {"encoder": (1, txt, cfg.joint_attention_dim),
              "latents": (1, ht * wt, cfg.in_channels)}
    if args.dual:
        shapes["encoder_neg"] = shapes["encoder"]
    d = _draws(args, dev, shapes, inputs)
    branches = {"positive": d["encoder"]}
    if args.dual:
        branches["negative"] = d["encoder_neg"]
    series = {b: {"xs": [], "ys": [], "prev": None} for b in branches}
    lat = d["latents"]
    with torch.inference_mode():
        for i in range(args.steps):
            t = torch.full((1,), float(sched.sigmas[i]), device=dev)
            v_pos = None
            for b, enc in branches.items():
                hidden, encoder, temb = qm._qwen_embed(params, lat.bfloat16(), enc, t)
                txt_mod1, _ = params.blocks[0].txt_mod(F.silu(temb)).chunk(2, dim=-1)
                probe = qm._modulate(encoder, txt_mod1)[0]
                out, _ = qm.qwen_run_blocks(params, cfg, hidden, encoder, temb, cos, sin)
                s = series[b]
                cur = (_host(probe), _host(out - hidden))
                if s["prev"] is not None:
                    s["xs"].append(rel_l1(cur[0], s["prev"][0]))
                    s["ys"].append(rel_l1(cur[1], s["prev"][1]))
                s["prev"] = cur
                if b == "positive":
                    v_pos = params.proj_out(params.norm_out(out, temb))
            lat = sched.step(v_pos, i, lat)
            _step_log(i, series["positive"]["xs"], series["positive"]["ys"])
    neg = None
    if args.dual:
        sn = series["negative"]
        neg = np.polyfit(np.asarray(sn["xs"]), np.asarray(sn["ys"]), deg=min(4, len(sn["xs"]) - 1))
    sp = series["positive"]
    _polyfit_and_write(sp["xs"], sp["ys"], args, negtive_coefficients=neg)
    return sp["xs"], sp["ys"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("teacache coefficient fitting (PyTorch/CUDA port)")
    parser.add_argument("--architecture", default="flux", choices=["flux", "sd35", "qwen"])
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--use-int8", action="store_true")
    parser.add_argument("--use-fp8", action="store_true")
    parser.add_argument("--quant-mods", action="store_true")
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--guidance-scale", type=float, default=3.5)
    parser.add_argument("--threshold", type=float, default=0.25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--single-layers", type=int, default=None)
    parser.add_argument("--output", default="teacache_flux.json")
    parser.add_argument("--dual", action="store_true",
                        help="also fit negtive_coefficients from the true-CFG negative branch "
                             "(qwen)")
    parser.add_argument("--algorithm", default="teacache", choices=["teacache", "dicache"],
                        help="dicache records probe-block delta_y and sweeps thresholds (flux)")
    parser.add_argument("--probe-depth", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device of the model (cpu: the plain PyTorch versions)")
    return parser


FITS = {"flux": fit_flux, "sd35": fit_sd35, "qwen": fit_qwen}


def main(argv=None, inputs: Optional[dict] = None):
    """-> the positive branch's (xs, ys)."""
    args = build_parser().parse_args(argv)
    return FITS[args.architecture](args, inputs)


if __name__ == "__main__":
    main()
