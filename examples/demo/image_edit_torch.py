"""Image-editing demo (i2i: flux-kontext / qwen-image-edit / sdxl img2img) on
the PyTorch/CUDA port (port of examples/demo/image_edit.py: the same flags
and flow, plus --device). Sources are read by the port's codec (PNG; other
formats through PIL where it imports); the edit is written as PNG. Under
torchrun with --mesh-shape every rank generates and rank 0 saves.

    python examples/demo/image_edit_torch.py --model-path CKPT \\
        --architecture flux-kontext --image in.png --prompt "make it snow"
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
from fastdm_tpu_torch.utils.png import read_image, write_image  # noqa: E402
from gen_torch import saves  # noqa: E402


def main(argv=None):
    """-> the edited array."""
    parser = argparse.ArgumentParser("fastdm_tpu_torch image edit demo")
    add_engine_args(parser)
    add_generation_args(parser)
    parser.add_argument("--images", nargs="+", default=None,
                        help="multiple source images (multi-image edit; "
                             "qwen-image-edit-2509 style)")
    args = parser.parse_args(argv)
    paths = args.images or ([args.image] if args.image else None)
    if not paths:
        raise SystemExit("--image (or --images) is required for i2i")

    from fastdm_tpu_torch.engine import FastDMEngine

    engine = FastDMEngine(**engine_kwargs(args))
    imgs = [read_image(p) for p in paths]
    t0 = time.perf_counter()
    out = engine.generate(
        prompt=args.prompt, negative_prompt=args.negative_prompt,
        image=imgs if len(imgs) > 1 else imgs[0], task="i2i",
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        true_cfg_scale=args.true_cfg_scale if "qwen" in args.architecture else None,
        seed=args.seed,
    )
    print(f"edit latency: {time.perf_counter() - t0:.2f}s")
    if saves():
        write_image(args.output, out[0])
        print(f"saved {args.output}")
    return out


if __name__ == "__main__":
    main()
