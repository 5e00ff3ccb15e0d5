"""Model factory (port of fastdm_tpu/model_entry.py): `create_model` resolves
an architecture name to (config, params, forward_fn), loading and quantizing
a checkpoint when given one, else drawing random weights from a seed
(profiling). The params are the port's nn.Modules on `device`; forward_fn is
the family's forward, called as forward_fn(params, cfg, ...)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple


def _flux():
    from fastdm_tpu_torch.models import flux as m

    return m.FluxConfig, m.flux_load, m.flux_init_random, m.flux_forward


def _sd35():
    from fastdm_tpu_torch.models import sd35 as m

    return m.SD3Config, m.sd3_load, m.sd3_init_random, m.sd3_forward


def _sdxl():
    from fastdm_tpu_torch.models import sdxl as m

    return m.SDXLConfig, m.sdxl_load, m.sdxl_init_random, m.sdxl_forward


def _qwen():
    from fastdm_tpu_torch.models import qwenimage as m

    return m.QwenImageConfig, m.qwen_load, m.qwen_init_random, m.qwen_forward


def _wan():
    from fastdm_tpu_torch.models import wan as m

    return m.WanConfig, m.wan_load, m.wan_init_random, m.wan_forward


def _sdxl_controlnet():
    from fastdm_tpu_torch.models import controlnets as m
    from fastdm_tpu_torch.models.sdxl import SDXLConfig

    return SDXLConfig, m.sdxl_controlnet_load, None, m.sdxl_controlnet_forward


def _flux_controlnet():
    from fastdm_tpu_torch.models import controlnets as m

    return m.FluxControlNetConfig, m.flux_controlnet_load, None, m.flux_controlnet_forward


# the JAX registry's names (fastdm_tpu/model_entry.py:58-66)
MODEL_REGISTRY: Dict[str, Callable] = {
    "flux": _flux, "flux-dev": _flux, "flux-krea": _flux, "flux-kontext": _flux,
    "sd35": _sd35, "sd3.5": _sd35,
    "sdxl": _sdxl,
    "qwen-image": _qwen, "qwen-image-edit": _qwen,
    "wan": _wan, "wan2.2-t2v": _wan, "wan2.2-i2v": _wan, "wan2.2-ti2v": _wan,
    "sdxl-controlnet": _sdxl_controlnet,
    "flux-controlnet": _flux_controlnet,
}


def create_model(
    architecture: str,
    ckpt_path: Optional[str] = None,
    quant: Optional[str] = "int8",
    seed: int = 0,
    device="cuda",
    **cfg_overrides: Any,
) -> Tuple[Any, Any, Callable]:
    """(cfg, params, forward_fn) of the named architecture on `device` (the
    GPU unless the caller passes "cpu"). The ControlNets have no random init
    and need a checkpoint, as in JAX."""
    from fastdm_tpu_torch.device import resolve_device

    if architecture not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown architecture {architecture!r}; have {sorted(MODEL_REGISTRY)}")
    cfg_cls, load_fn, init_fn, forward_fn = MODEL_REGISTRY[architecture]()
    cfg = cfg_cls(quant=quant, **cfg_overrides)
    device = resolve_device(device)
    if ckpt_path is not None:
        from fastdm_tpu_torch.models.loader import TensorSource

        params = load_fn(TensorSource.from_path(ckpt_path, device), cfg)
    else:
        if init_fn is None:
            raise ValueError(f"{architecture} requires a checkpoint")
        params = init_fn(seed, cfg, device=device)
    return cfg, params, forward_fn
