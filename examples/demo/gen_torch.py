"""CLI generation demo on the PyTorch/CUDA port (port of examples/demo/gen.py:
the same flags and flow, engine -> warmup -> timed generate -> save, plus
--device).

Images are written as PNG by the port's codec (fastdm_tpu_torch/utils/png.py)
and a video as one PNG a frame, `<output>_f0000.png`, ..., as the reference
writes it where imageio is missing; an --image is read the same way. Under
torchrun with --mesh-shape every rank generates and rank 0 saves.

    python examples/demo/gen_torch.py --model-path CKPT --architecture flux \\
        --use-int8 --height 1024 --width 2048 --output out.png
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from fastdm_tpu_torch.common_args import (  # noqa: E402
    add_engine_args,
    add_generation_args,
    engine_kwargs,
)
from fastdm_tpu_torch.utils.png import read_image, write_image  # noqa: E402


def saves() -> bool:
    """Whether this process writes the outputs: rank 0 of a mesh, or the one
    process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save_images(images, path, fps=16):
    """Images: (N, H, W, 3) stills or (1, F, H, W, 3) video frames (t2v),
    the frames as `<base>_fNNNN.png`. -> the paths written."""
    base, ext = os.path.splitext(path)
    arr = np.asarray(images)
    written = []
    if arr.ndim == 5:  # video: (B, F, H, W, 3)
        for i, f in enumerate(arr[0]):
            written.append(f"{base}_f{i:04d}.png")
            write_image(written[-1], f)
        print(f"saved {len(arr[0])} frames as {base}_f*.png ({fps} fps)")
        return written
    for i, img in enumerate(arr):
        written.append(path if len(arr) == 1 else f"{base}_{i}{ext}")
        write_image(written[-1], img)
        print(f"saved {written[-1]}")
    return written


def main(argv=None):
    """-> the generated array."""
    parser = argparse.ArgumentParser("fastdm_tpu_torch generation demo")
    add_engine_args(parser)
    add_generation_args(parser)
    args = parser.parse_args(argv)

    from fastdm_tpu_torch.engine import FastDMEngine

    t0 = time.perf_counter()
    engine = FastDMEngine(**engine_kwargs(args))
    print(f"model load latency: {time.perf_counter() - t0:.2f}s")

    gen_kwargs = dict(
        prompt=args.prompt,
        negative_prompt=args.negative_prompt,
        height=args.height,
        width=args.width,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        seed=args.seed,
        num_images_per_prompt=args.num_images_per_prompt,
        task=args.task,
    )

    for _ in range(args.warmup):
        engine.generate(**gen_kwargs)

    t0 = time.perf_counter()
    if args.task in ("t2v", "i2v", "ti2v"):
        gen_kwargs["num_frames"] = args.num_frames
        if args.image:
            gen_kwargs["image"] = read_image(args.image)
    images = engine.generate(**gen_kwargs)
    print(f"generation latency: {time.perf_counter() - t0:.2f}s")
    if saves():
        save_images(images, args.output, fps=args.fps)
    return images


if __name__ == "__main__":
    main()
