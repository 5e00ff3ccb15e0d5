"""LoRA fine-tuning of FLUX on the flow-matching objective (port of the
functions of examples/lora-train/train.py:37-214).

Design, as the JAX trainer's: LoRA factors mirror every targeted bf16 block
weight w (K, N) as down (K, r) and up (r, N) in f32; each step merges them
(w' = w + scale * down @ up, rounded once to bf16) and runs the unmodified
bf16 forward on the merged weights, so that gradients flow only into the
factors. The merged weights reach the model through torch.func.functional_call
(the frozen base weights keep requires_grad=False); autograd keeps them for
the backward (~13.6 GB beside the 23.8 GB base at FLUX.1-dev's widths). Loss:
rectified-flow MSE, x_t = (1 - t) x0 + t eps, target eps - x0, guidance 1.0.
The optimizer is AdamW without weight decay (optax.adamw(lr,
weight_decay=0.0): b1 0.9, b2 0.999, eps 1e-8, bias-corrected).

A LoRA here is a dict {module path of the QLinear: {"down", "up"}}, e.g.
"dual_blocks.3.attn.qkv"; train.py's tree stacks the blocks instead
({"dual_blocks": {"attn": {"qkv": {"down": (L, K, r), ...}}}}), and its
export names a factor by that tree path, the block index and the PEFT
suffix (lora_name, export_lora). models/convert.py lora_from_numpy hands a
JAX tree across.

Departures from train.py, by design: the factors are drawn by one explicit
torch.Generator(seed) in module order (train.py seeds each leaf with
hash(path) % 2**31, which changes with PYTHONHASHSEED); the forward runs the
port's kernels where train.py switches every op to jnp (kernels/autograd.py
gives them gradients); and export_lora writes the transposed factors
contiguous, where train.py:205-206 hands safetensors.numpy the transposed
views and so writes each factor's buffer under the transposed shape.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor
LoRA = Dict[str, Dict[str, Tensor]]

LORA_TARGETS = ("qkv", "add_qkv", "to_out", "to_add_out", "proj", "out",
                "proj_mlp", "qkv_mlp")
BATCH_KEYS = ("latents", "embeds", "pooled")


def lora_targets(model: nn.Module) -> List[Tuple[str, QLinear]]:
    """(module path, QLinear) of every linear LoRA targets: its own name in
    LORA_TARGETS and a 2D weight w (train.py:47), in module order."""
    return [(path, m) for path, m in model.named_modules()
            if isinstance(m, QLinear) and path.rsplit(".", 1)[-1] in LORA_TARGETS
            and m.w is not None and m.w.dim() >= 2]


def init_lora(model: nn.Module, rank: int, seed: int) -> LoRA:
    """Factors of every target (train.py:41-65): down (K, r) ~ 0.01 N(0, 1)
    and up (r, N) zeros, f32 on the model's device, requiring gradients;
    drawn by one torch.Generator seeded with `seed`, in module order."""
    targets = lora_targets(model)
    if not targets:
        raise ValueError("the model has no LoRA target linear")
    gen = torch.Generator(device=targets[0][1].w.device).manual_seed(seed)
    lora = {}
    for path, lin in targets:
        if lin.w.dtype != torch.bfloat16:
            raise ValueError(f"{path}: LoRA training runs the bf16 model (quant=None), "
                             f"got a {lin.w.dtype} weight")
        k, n = lin.w.shape
        down = torch.randn(k, rank, generator=gen, device=lin.w.device,
                           dtype=torch.float32).mul_(0.01)
        up = torch.zeros(rank, n, device=lin.w.device, dtype=torch.float32)
        lora[path] = {"down": down.requires_grad_(), "up": up.requires_grad_()}
    return lora


def lora_parameters(lora: LoRA) -> List[Tensor]:
    return [f for p in lora.values() for f in (p["down"], p["up"])]


def lora_count(lora: LoRA) -> int:
    return sum(t.numel() for t in lora_parameters(lora))


def merge_lora(model: nn.Module, lora: LoRA, scale: float) -> Dict[str, Tensor]:
    """{"<path>.w": w'} with w' = (f32(w) + scale * down @ up) in w's dtype,
    train.py:68-85's order of operations."""
    mods = dict(model.named_modules())
    out = {}
    for path, f in lora.items():
        w = mods[path].w
        out[f"{path}.w"] = (w.float() + scale * (f["down"] @ f["up"])).to(w.dtype)
    return out


class _Bound(nn.Module):
    """model with a function of it as its forward (for functional_call)."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def call_with(model: nn.Module, tensors: Dict[str, Tensor], fn: Callable, *args, **kwargs):
    """fn(model, *args, **kwargs) with the parameters named in `tensors`
    (model.named_parameters() names) replaced by those tensors."""
    tensors = {f"model.{k}": v for k, v in tensors.items()}
    return torch.func.functional_call(_Bound(model, fn), tensors, args, kwargs)


def lora_forward(model: nn.Module, lora: LoRA, scale: float, fn: Callable, *args, **kwargs):
    """fn(model, *args, **kwargs) with every target's w replaced by its
    merged weight."""
    return call_with(model, merge_lora(model, lora, scale), fn, *args, **kwargs)


def draw_noise(x0: Tensor, generator: torch.Generator) -> Tuple[Tensor, Tensor]:
    """(eps ~ N(0, 1) like x0 in f32, t ~ U[0, 1) per batch entry)."""
    eps = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=torch.float32)
    t = torch.rand(x0.shape[0], generator=generator, device=x0.device, dtype=torch.float32)
    return eps, t


def flow_loss(model: nn.Module, cfg, lora: LoRA, scale: float, batch: Dict[str, Tensor],
              eps: Tensor, t: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """train.py:144-156: x_t = ((1 - t) x0 + t eps) in bf16, the merged
    model's prediction at guidance 1.0, f32 MSE against eps - x0."""
    from fastdm_tpu_torch.models.flux import flux_forward

    x0 = batch["latents"].float()
    tt = t[:, None, None]
    x_t = ((1 - tt) * x0 + tt * eps).to(torch.bfloat16)
    g = torch.full(t.shape, 1.0, dtype=torch.float32, device=t.device)
    v_pred = lora_forward(model, lora, scale, flux_forward, cfg, x_t,
                          batch["embeds"].to(torch.bfloat16), batch["pooled"].to(torch.bfloat16),
                          t, cos, sin, guidance=g)
    return ((v_pred.float() - (eps - x0)) ** 2).mean()


def make_optimizer(lora: LoRA, lr: float) -> torch.optim.Optimizer:
    """optax.adamw(lr, weight_decay=0.0)'s update."""
    return torch.optim.AdamW(lora_parameters(lora), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)


def train_step(model: nn.Module, cfg, lora: LoRA, opt: torch.optim.Optimizer, scale: float,
               batch: Dict[str, Tensor], eps: Tensor, t: Tensor, cos: Tensor,
               sin: Tensor) -> Tensor:
    """One step: loss, its gradients in the factors, one AdamW update of the
    factors in place. -> the loss (detached)."""
    opt.zero_grad(set_to_none=True)
    loss = flow_loss(model, cfg, lora, scale, batch, eps, t, cos, sin)
    loss.backward()
    opt.step()
    return loss.detach()


def batches(data_shapes: Dict[str, Tuple[int, ...]], seed: int, device,
            data_dir: Optional[str] = None) -> Iterator[Dict[str, Tensor]]:
    """Endless batches of one sample (train.py:164-181): the .npz files of
    data_dir in name order, over and over (arrays latents, embeds, pooled),
    or synthetic f32 N(0, 1) arrays of data_shapes drawn by
    numpy.random.default_rng(seed) in the order latents, embeds, pooled."""
    rng = np.random.default_rng(seed)
    if data_dir:
        files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                       if f.endswith(".npz"))
        if not files:
            raise FileNotFoundError(f"no .npz files under {data_dir!r}")
        while True:
            for f in files:
                d = np.load(f)
                yield {k: torch.from_numpy(np.asarray(d[k])[None]).to(device)
                       for k in BATCH_KEYS}
    while True:
        yield {k: torch.from_numpy(rng.standard_normal((1, *data_shapes[k]))
                                   .astype(np.float32)).to(device)
               for k in BATCH_KEYS}


def lora_name(path: str) -> Tuple[str, Optional[int]]:
    """A module path -> (train.py's tree path, block index): the index of
    the block list leaves the path ("dual_blocks.3.attn.qkv" ->
    ("dual_blocks.attn.qkv", 3)); a path outside a block list has None."""
    parts = path.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return ".".join(parts[:i] + parts[i + 1:]), int(p)
    return path, None


def export_tensors(lora: LoRA) -> Dict[str, Tensor]:
    """train.py's export layout (train.py:191-214): under "<tree path>.<block
    index>.lora_A.default.weight" down^T (r, K) and under "...lora_B..." up^T
    (N, r), f32, contiguous, on the CPU."""
    out = {}
    for path, f in lora.items():
        name, idx = lora_name(path)
        key = name if idx is None else f"{name}.{idx}"
        out[f"{key}.lora_A.default.weight"] = f["down"].detach().float().t().contiguous().cpu()
        out[f"{key}.lora_B.default.weight"] = f["up"].detach().float().t().contiguous().cpu()
    return out


def export_lora(lora: LoRA, path: str) -> int:
    """Write export_tensors(lora) as safetensors at path. -> the tensor count."""
    from safetensors.torch import save_file

    tensors = export_tensors(lora)
    save_file(tensors, path)
    return len(tensors)
