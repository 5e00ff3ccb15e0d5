"""LoRA fine-tuning of FLUX on the flow-matching objective with the PyTorch /
CUDA port (port of examples/lora-train/train.py: the same flags, lines and
export, plus --device).

The factors, merge, loss, AdamW step, batches and export are
fastdm_tpu_torch/training/lora.py; the forward is the port's bf16 FLUX on its
kernels, whose gradients are kernels/autograd.py. Without --model-path the
model is random (flux_init_random, seed 1); without --data-dir, --synthetic
batches are drawn by numpy from --seed.

    python examples/lora-train/train_torch.py --synthetic --steps 100 \\
        --output lora_out.safetensors [--layers 2] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

TXT_TOKENS = 128


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("lora train")
    p.add_argument("--architecture", default="flux", choices=["flux", "qwen"])
    p.add_argument("--model-path", default=None, help="checkpoint dir; random if unset")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--output", default="lora_out.safetensors")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def train(args: argparse.Namespace, on_step=None) -> dict:
    """Run args.steps steps and export the factors. on_step(step, loss), when
    given, is called after each step (loss a 0-dim tensor on the device).
    -> {"model", "cfg", "lora", "losses" (floats, every step), "tensors"
    (the count exported)}."""
    if args.architecture != "flux":
        raise SystemExit("qwen lora training lands next round")
    import torch

    from fastdm_tpu_torch.device import resolve_device
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_init_random, flux_load, \
        flux_rope_cache
    from fastdm_tpu_torch.models.loader import TensorSource
    from fastdm_tpu_torch.training import lora as L

    dev = resolve_device(args.device)
    kw = dict(quant=None)  # training runs bf16
    if args.layers:
        kw.update(num_layers=args.layers, num_single_layers=args.layers)
    cfg = FluxConfig(**kw)
    if args.model_path:
        model = flux_load(TensorSource.from_path(os.path.join(args.model_path, "transformer"),
                                                 device=dev), cfg)
    else:
        model = flux_init_random(1, cfg, device=dev)
    ht, wt = args.height // 16, args.width // 16
    cos, sin = flux_rope_cache(cfg, TXT_TOKENS, ht, wt, device=dev)
    data_shapes = dict(latents=(ht * wt, cfg.in_channels),
                       embeds=(TXT_TOKENS, cfg.joint_attention_dim),
                       pooled=(cfg.pooled_projection_dim,))

    lora = L.init_lora(model, args.rank, args.seed)
    print(f"lora params: {L.lora_count(lora) / 1e6:.2f}M (rank {args.rank})")
    opt = L.make_optimizer(lora, args.lr)
    it = L.batches(data_shapes, args.seed, dev, args.data_dir)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = next(it)
        eps, t = L.draw_noise(batch["latents"], gen)
        loss = L.train_step(model, cfg, lora, opt, args.lora_scale, batch, eps, t, cos, sin)
        losses.append(loss)
        if on_step is not None:
            on_step(step, loss)
        if step % 10 == 0:
            print(f"step {step}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)

    n = L.export_lora(lora, args.output)
    print(f"wrote {args.output} ({n} tensors)")
    return dict(model=model, cfg=cfg, lora=lora, losses=[float(x) for x in losses], tensors=n)


def main(argv=None) -> None:
    train(parse_args(argv))


if __name__ == "__main__":
    main()
