"""ControlNet demo for SDXL / FLUX on the PyTorch/CUDA port (port of
examples/demo/controlnet_demo.py: the same flags and flow, an engine with a
ControlNet checkpoint and a hint image conditioning the generation, plus
--device).

The hint is read by the port's codec (PNG; other formats through PIL where
it imports) and resized to --width x --height with the port's bicubic
resize, which is PIL's Image.resize default for RGB, bit for bit. Under
torchrun with --mesh-shape every rank generates and rank 0 saves.

    python examples/demo/controlnet_demo_torch.py --model-path CKPT \\
        --architecture sdxl --controlnet-path CN --control-image canny.png
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fastdm_tpu_torch.common_args import (  # noqa: E402
    add_engine_args,
    add_generation_args,
    engine_kwargs,
)
from fastdm_tpu_torch.pipeline.image_processor import resize_bicubic  # noqa: E402
from fastdm_tpu_torch.utils.png import read_image, write_image  # noqa: E402
from gen_torch import saves  # noqa: E402


def main(argv=None):
    """-> the generated array."""
    parser = argparse.ArgumentParser("fastdm_tpu_torch controlnet demo")
    add_engine_args(parser)
    add_generation_args(parser)
    parser.add_argument("--controlnet-path", required=True)
    parser.add_argument("--control-image", required=True)
    parser.add_argument("--conditioning-scale", type=float, default=1.0)
    parser.add_argument("--guess-mode", action="store_true")
    parser.add_argument("--control-mode", type=int, default=None,
                        help="union-checkpoint mode index (FLUX only)")
    args = parser.parse_args(argv)

    from fastdm_tpu_torch.engine import FastDMEngine

    hint = resize_bicubic(read_image(args.control_image), args.height, args.width)

    t0 = time.perf_counter()
    engine = FastDMEngine(controlnet_path=args.controlnet_path, **engine_kwargs(args))
    print(f"model + controlnet load: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    images = engine.generate(
        prompt=args.prompt,
        negative_prompt=args.negative_prompt,
        height=args.height,
        width=args.width,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        seed=args.seed,
        control_image=hint,
        controlnet_conditioning_scale=args.conditioning_scale,
        guess_mode=args.guess_mode,
        control_mode=args.control_mode,
    )
    print(f"generate: {time.perf_counter() - t0:.1f}s")
    if saves():
        write_image(args.output, images[0])
        print(f"saved {args.output}")
    return images


if __name__ == "__main__":
    main()
