"""ComfyUI loader nodes on the PyTorch/CUDA port (port of comfyui/nodes.py).

The same six nodes, class names, inputs and mapping keys as comfyui/nodes.py,
so that a workflow saved against those nodes loads: each builds the port's
quantized model from a checkpoint file, on the device ComfyUI samples on
(comfy.model_management.get_torch_device(), the GPU in a real ComfyUI), and
wraps it in the port's forward wrapper (fastdm_tpu_torch/comfyui_entry.py).
The model is handed to ModelPatcher / ControlNet on that device: the
wrappers keep every tensor there. Requires a ComfyUI runtime (imports
gated to call time).
"""

from __future__ import annotations


def _torch_device():
    import comfy.model_management

    return comfy.model_management.get_torch_device()


def _load_state_dict(ckpt_path, device):
    from fastdm_tpu_torch.models.loader import TensorSource

    return TensorSource.from_path(ckpt_path, device)


def _build_cache(use_cache: bool, cache_threshold: float):
    """Node-level cache controls -> AutoCache: DiCache with probe depth 1 and
    ret_ratio 0.2, as comfyui/nodes.py:19-33. None when caching is off."""
    if not use_cache:
        return None
    from fastdm_tpu_torch.caching.xcaching import AutoCache

    return AutoCache.from_dict({
        "cache_algorithm": "dicache",
        "enable_caching": True,
        "threshold": cache_threshold,
        "probe_depth": 1,
        "ret_ratio": 0.2,
    })


_CACHE_INPUTS = {
    "use_cache": ("BOOLEAN", {"default": False}),
    "cache_threshold": ("FLOAT", {"default": 0.2, "min": 0.0, "max": 1.0,
                                  "step": 0.01}),
}


class FastdmTpuFluxLoader:
    @classmethod
    def INPUT_TYPES(cls):
        import folder_paths

        return {
            "required": {
                "ckpt_name": (folder_paths.get_filename_list("diffusion_models"),),
                "quant": (["int8", "fp8", "bf16"],),
                **_CACHE_INPUTS,
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "load_model"
    CATEGORY = "fastdm_tpu"

    def load_model(self, ckpt_name, quant, use_cache=False, cache_threshold=0.2):
        import comfy.model_patcher
        import comfy.model_base
        import comfy.supported_models
        import folder_paths

        from fastdm_tpu_torch.comfyui_entry import ComfyUIFluxForwardWrapper
        from fastdm_tpu_torch.models.flux import FluxConfig, flux_load

        dev = _torch_device()
        ckpt_path = folder_paths.get_full_path("diffusion_models", ckpt_name)
        cfg = FluxConfig(quant=None if quant == "bf16" else quant,
                         quant_mods=quant != "bf16")
        params = flux_load(_load_state_dict(ckpt_path, dev), cfg)

        model_conf = comfy.supported_models.Flux({})
        model = comfy.model_base.Flux(model_conf)
        model.diffusion_model = ComfyUIFluxForwardWrapper(
            params, cfg, cache=_build_cache(use_cache, cache_threshold))
        return (comfy.model_patcher.ModelPatcher(model, dev, dev),)


class FastdmTpuSDXLLoader:
    @classmethod
    def INPUT_TYPES(cls):
        import folder_paths

        return {
            "required": {
                "ckpt_name": (folder_paths.get_filename_list("diffusion_models"),),
                "quant": (["int8", "fp8", "bf16"],),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "load_model"
    CATEGORY = "fastdm_tpu"

    def load_model(self, ckpt_name, quant):
        import comfy.model_patcher
        import comfy.model_base
        import comfy.supported_models
        import folder_paths

        from fastdm_tpu_torch.comfyui_entry import ComfyUISDXLForwardWrapper
        from fastdm_tpu_torch.models.sdxl import SDXLConfig, sdxl_load

        dev = _torch_device()
        ckpt_path = folder_paths.get_full_path("diffusion_models", ckpt_name)
        cfg = SDXLConfig(quant=None if quant == "bf16" else quant)
        params = sdxl_load(_load_state_dict(ckpt_path, dev), cfg)
        model_conf = comfy.supported_models.SDXL({})
        model = comfy.model_base.SDXL(model_conf)
        model.diffusion_model = ComfyUISDXLForwardWrapper(params, cfg)
        return (comfy.model_patcher.ModelPatcher(model, dev, dev),)


class FastdmTpuSD35Loader:
    @classmethod
    def INPUT_TYPES(cls):
        import folder_paths

        return {
            "required": {
                "ckpt_name": (folder_paths.get_filename_list("diffusion_models"),),
                "quant": (["int8", "fp8", "bf16"],),
                **_CACHE_INPUTS,
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "load_model"
    CATEGORY = "fastdm_tpu"

    def load_model(self, ckpt_name, quant, use_cache=False, cache_threshold=0.2):
        import comfy.model_base
        import comfy.model_patcher
        import comfy.supported_models
        import folder_paths

        from fastdm_tpu_torch.comfyui_entry import ComfyUISD3ForwardWrapper
        from fastdm_tpu_torch.models.sd35 import SD3Config, sd3_load

        dev = _torch_device()
        ckpt_path = folder_paths.get_full_path("diffusion_models", ckpt_name)
        cfg = SD3Config(quant=None if quant == "bf16" else quant)
        params = sd3_load(_load_state_dict(ckpt_path, dev), cfg)
        model_conf = comfy.supported_models.SD3({})
        model = comfy.model_base.SD3(model_conf)
        model.diffusion_model = ComfyUISD3ForwardWrapper(
            params, cfg, cache=_build_cache(use_cache, cache_threshold))
        return (comfy.model_patcher.ModelPatcher(model, dev, dev),)


class FastdmTpuQwenImageLoader:
    @classmethod
    def INPUT_TYPES(cls):
        import folder_paths

        return {
            "required": {
                "ckpt_name": (folder_paths.get_filename_list("diffusion_models"),),
                "quant": (["int8", "fp8", "bf16"],),
                **_CACHE_INPUTS,
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "load_model"
    CATEGORY = "fastdm_tpu"

    def load_model(self, ckpt_name, quant, use_cache=False, cache_threshold=0.2):
        import comfy.model_base
        import comfy.model_patcher
        import comfy.supported_models
        import folder_paths

        from fastdm_tpu_torch.comfyui_entry import ComfyUIQwenForwardWrapper
        from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, qwen_load

        dev = _torch_device()
        ckpt_path = folder_paths.get_full_path("diffusion_models", ckpt_name)
        cfg = QwenImageConfig(quant=None if quant == "bf16" else quant,
                              quant_mods=quant != "bf16")
        params = qwen_load(_load_state_dict(ckpt_path, dev), cfg)
        model_conf = comfy.supported_models.QwenImage({})
        model = comfy.model_base.QwenImage(model_conf)
        model.diffusion_model = ComfyUIQwenForwardWrapper(
            params, cfg, cache=_build_cache(use_cache, cache_threshold))
        return (comfy.model_patcher.ModelPatcher(model, dev, dev),)


class FastdmTpuSDXLControlnetLoader:
    @classmethod
    def INPUT_TYPES(cls):
        import folder_paths

        return {
            "required": {
                "controlnet_name": (folder_paths.get_filename_list("controlnet"),),
                "quant": (["int8", "fp8", "bf16"],),
            }
        }

    RETURN_TYPES = ("CONTROL_NET",)
    FUNCTION = "load_model"
    CATEGORY = "fastdm_tpu"

    def load_model(self, controlnet_name, quant):
        import folder_paths
        from comfy.controlnet import ControlNet

        from fastdm_tpu_torch.comfyui_entry import ComfyUISDXLControlnetForwardWrapper
        from fastdm_tpu_torch.models.controlnets import sdxl_controlnet_load
        from fastdm_tpu_torch.models.sdxl import SDXLConfig

        dev = _torch_device()
        ckpt_path = folder_paths.get_full_path("controlnet", controlnet_name)
        cfg = SDXLConfig(quant=None if quant == "bf16" else quant)
        params = sdxl_controlnet_load(_load_state_dict(ckpt_path, dev), cfg)
        wrapper = ComfyUISDXLControlnetForwardWrapper(params, cfg)
        return (ControlNet(control_model=wrapper, global_average_pooling=False,
                           load_device=dev, manual_cast_dtype=None),)


class FastdmTpuFluxControlnetLoader:
    @classmethod
    def INPUT_TYPES(cls):
        import folder_paths

        return {
            "required": {
                "controlnet_name": (folder_paths.get_filename_list("controlnet"),),
                "quant": (["int8", "fp8", "bf16"],),
            }
        }

    RETURN_TYPES = ("CONTROL_NET",)
    FUNCTION = "load_model"
    CATEGORY = "fastdm_tpu"

    def load_model(self, controlnet_name, quant):
        import comfy.latent_formats
        import folder_paths
        from comfy.controlnet import ControlNet

        from fastdm_tpu_torch.comfyui_entry import ComfyUIFluxControlnetForwardWrapper
        from fastdm_tpu_torch.models.controlnets import (
            FluxControlNetConfig, flux_controlnet_load,
        )

        dev = _torch_device()
        ckpt_path = folder_paths.get_full_path("controlnet", controlnet_name)
        cfg = FluxControlNetConfig(quant=None if quant == "bf16" else quant,
                                   guidance_embeds=True)
        params = flux_controlnet_load(_load_state_dict(ckpt_path, dev), cfg)
        wrapper = ComfyUIFluxControlnetForwardWrapper(params, cfg)
        return (ControlNet(wrapper, compression_ratio=1,
                           latent_format=comfy.latent_formats.Flux(),
                           concat_mask=False, load_device=dev,
                           manual_cast_dtype=None, extra_conds=["y", "guidance"]),)


NODE_CLASS_MAPPINGS = {
    "FastdmTpuFluxLoader": FastdmTpuFluxLoader,
    "FastdmTpuSDXLLoader": FastdmTpuSDXLLoader,
    "FastdmTpuSD35Loader": FastdmTpuSD35Loader,
    "FastdmTpuQwenImageLoader": FastdmTpuQwenImageLoader,
    "FastdmTpuSDXLControlnetLoader": FastdmTpuSDXLControlnetLoader,
    "FastdmTpuFluxControlnetLoader": FastdmTpuFluxControlnetLoader,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "FastdmTpuFluxLoader": "FastDM-TPU Flux Loader",
    "FastdmTpuSDXLLoader": "FastDM-TPU SDXL Loader",
    "FastdmTpuSD35Loader": "FastDM-TPU SD3.5 Loader",
    "FastdmTpuQwenImageLoader": "FastDM-TPU Qwen-Image Loader",
    "FastdmTpuSDXLControlnetLoader": "FastDM-TPU SDXL ControlNet Loader",
    "FastdmTpuFluxControlnetLoader": "FastDM-TPU Flux ControlNet Loader",
}
