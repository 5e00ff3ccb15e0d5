"""Shared CLI flags of the port's front-ends (port of
fastdm_tpu/common_args.py): the same flags, defaults and choices, so that
reference command lines parse unchanged, plus --device. Three flags act
differently here:

  * --kernel-backend: "auto" and "pallas" both mean the port's hand-written
    kernels; "jnp" is refused by `check_engine_args` (the plain PyTorch
    versions serve CPU tensors only).
  * --mesh-shape parses as in JAX and reaches the engine (one process a
    device under torchrun); the API server and the Gradio UI then take
    requests on rank 0 and broadcast them to the other ranks
    (parallel/request_loop.py).
  * --use-int4 states no device rate in its help text.
"""

from __future__ import annotations

import argparse


def add_engine_args(parser: argparse.ArgumentParser,
                    extra_architectures=()) -> argparse.ArgumentParser:
    """The engine flags; extra_architectures adds names to --architecture's
    choices (the API server's wan-lightning names)."""
    parser.add_argument("--model-path", type=str, required=True,
                        help="diffusers-format model directory")
    parser.add_argument("--architecture", type=str, default="flux",
                        choices=["flux", "flux-dev", "flux-krea", "flux-kontext",
                                 "sd35", "sdxl", "qwen-image", "qwen-image-edit",
                                 "wan2.2-t2v", "wan2.2-i2v", "wan2.2-ti2v",
                                 *extra_architectures])
    parser.add_argument("--use-fp8", action="store_true",
                        help="W8A8 float8_e4m3fn quantization")
    parser.add_argument("--use-int8", action="store_true",
                        help="W8A8 int8 quantization (asym activations)")
    parser.add_argument("--use-int4", action="store_true",
                        help="W4A4 int4 + SVDQuant low-rank branch")
    parser.add_argument("--pack-int4", action="store_true",
                        help="with --use-int4: pack two int4 per byte in device memory "
                             "(0.5 byte/param; unpacked before the GEMM)")
    parser.add_argument("--kernel-backend", type=str, default="auto",
                        choices=["auto", "jnp", "pallas"],
                        help="kernel dispatch: auto / pallas run the hand-written CUDA "
                             "kernels; jnp is refused (the plain versions serve CPU "
                             "tensors only)")
    parser.add_argument("--cache-config", type=str, default=None,
                        help="JSON config for TeaCache/FBCache/DiCache")
    parser.add_argument("--sparse-attn-config", type=str, default=None,
                        help="JSON config for radial sparse attention")
    parser.add_argument("--oom-resolve", action="store_true",
                        help="accepted for parity; the text encoders run on the engine's device")
    parser.add_argument("--mesh-shape", type=str, default=None,
                        help="dp,sp,tp[,pp] device-mesh shape, e.g. 1,2,4; a mesh of N "
                             "devices runs one process a device (torchrun --nproc-per-node N)")
    parser.add_argument("--quant-mods", action="store_true",
                        help="also quantize AdaLN/mod projections")
    parser.add_argument("--snapshot-path", type=str, default=None,
                        help="quantized-snapshot dir: the first run writes the quantized "
                             "denoiser there, later runs read it back and skip parsing and "
                             "quantization")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device of the engine (cpu: the plain PyTorch versions)")
    return parser


def add_generation_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--task", type=str, default="t2i",
                        choices=["t2i", "i2i", "t2v", "i2v"])
    parser.add_argument("--prompt", type=str,
                        default="a photo of an astronaut riding a horse on mars")
    parser.add_argument("--negative-prompt", type=str, default=None)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--num-inference-steps", type=int, default=25)
    parser.add_argument("--guidance-scale", type=float, default=3.5)
    parser.add_argument("--true-cfg-scale", type=float, default=4.0,
                        help="qwen-image true CFG scale")
    parser.add_argument("--num-frames", type=int, default=81)
    parser.add_argument("--fps", type=int, default=16)
    parser.add_argument("--image", type=str, default=None,
                        help="input image path (i2i / i2v)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-images-per-prompt", type=int, default=1)
    parser.add_argument("--output", type=str, default="output.png")
    parser.add_argument("--warmup", type=int, default=1,
                        help="warmup generations before the timed one")
    return parser


def parse_mesh_shape(val):
    """'1,2,4' -> (1, 2, 4); None passes through."""
    if not val:
        return None
    return tuple(int(x) for x in val.split(","))


def check_engine_args(args) -> None:
    """Refuse what the port does not run: --kernel-backend jnp."""
    if args.kernel_backend == "jnp":
        raise ValueError("--kernel-backend jnp is not available in the PyTorch port: its plain "
                         "PyTorch versions serve CPU tensors only (use --device cpu); auto and "
                         "pallas run the hand-written CUDA kernels")


def engine_kwargs(args) -> dict:
    """FastDMEngine's keywords from the flags of add_engine_args, after
    check_engine_args."""
    check_engine_args(args)
    return dict(model_path=args.model_path, architecture=args.architecture,
                use_fp8=args.use_fp8, use_int8=args.use_int8, use_int4=args.use_int4,
                pack_int4=args.pack_int4, quant_mods=args.quant_mods,
                cache_config=args.cache_config, sparse_attn_config=args.sparse_attn_config,
                snapshot_path=args.snapshot_path, device=args.device,
                kernel_backend=args.kernel_backend,
                mesh_shape=parse_mesh_shape(args.mesh_shape))
