"""The port's ComfyUI loader nodes (comfyui/nodes_torch.py) against a stubbed
ComfyUI runtime: the stubs of tests/test_comfyui_nodes.py, plus
comfy.model_management.get_torch_device answering the CPU here (the card in
a real ComfyUI). A node loads a tiny checkpoint for real: synthetic
checkpoint -> the port's quantized model on that device -> the port's
forward wrapper -> ModelPatcher on that device. Both node files register
the same classes under the same keys, with the same inputs."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from fastdm_tpu_torch import comfyui_entry as tce
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models.loader import TensorSource

sys.path.insert(0, os.path.dirname(__file__))
from test_comfyui_nodes import _install_comfy_stubs, _Patcher  # noqa: E402
from test_engine_e2e import _write_st  # noqa: E402
from test_golden_flux import _synthetic_state_dict  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

COMFYUI = os.path.join(os.path.dirname(__file__), "..", "comfyui")
TINY = dict(num_layers=1, num_single_layers=1, attention_head_dim=32, num_attention_heads=2,
            joint_attention_dim=24, pooled_projection_dim=16, in_channels=8, out_channels=8,
            axes_dims_rope=(8, 12, 12), guidance_embeds=True, patch_size=1)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test",
                                                  os.path.join(COMFYUI, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def comfy(tmp_path, monkeypatch):
    _install_comfy_stubs(monkeypatch, str(tmp_path))
    mm = types.ModuleType("comfy.model_management")
    mm.get_torch_device = lambda: torch.device("cpu")
    monkeypatch.setitem(sys.modules, "comfy.model_management", mm)
    sys.modules["comfy"].model_management = mm
    return tmp_path


@pytest.mark.parametrize("use_cache", [False, True])
def test_flux_loader_builds_an_int8_patcher_on_the_torch_device(comfy, monkeypatch, use_cache):
    rng = np.random.default_rng(0)
    _write_st(str(comfy / "flux.safetensors"), _synthetic_state_dict(TINY, rng))
    real_cfg = tflux.FluxConfig
    # the node builds the full-size FluxConfig; steer it to the tiny widths
    monkeypatch.setattr(tflux, "FluxConfig",
                        lambda quant=None, quant_mods=False: real_cfg(
                            quant=quant, quant_mods=quant_mods, **TINY))
    nodes = _load("nodes_torch")
    (patcher,) = nodes.FastdmTpuFluxLoader().load_model("flux.safetensors", "int8",
                                                        use_cache=use_cache,
                                                        cache_threshold=0.25)
    assert isinstance(patcher, _Patcher)
    assert patcher.load_device == patcher.offload_device == torch.device("cpu")
    assert patcher.model.model_config == {"arch": "Flux"}
    wrapper = patcher.model.diffusion_model
    assert isinstance(wrapper, tce.ComfyUIFluxForwardWrapper)
    # int8 block linears and, as the JAX node asks, int8 modulations
    assert wrapper.params.dual_blocks[0].attn.qkv.w.dtype == torch.int8
    assert wrapper.params.dual_blocks[0].norm1.linear.w.dtype == torch.int8
    assert wrapper.device == torch.device("cpu")
    if use_cache:
        cfg = wrapper.cache.config
        assert (cfg.cache_algorithm, cfg.threshold, cfg.probe_depth, cfg.ret_ratio) == \
            ("dicache", 0.25, 1, 0.2)
    else:
        assert wrapper.cache is None
    # driven the way ComfyUI's sampler does, it equals the wrapper of the
    # same weights loaded directly
    x = torch.from_numpy(rng.standard_normal((1, 2, 8, 8)).astype(np.float32))
    kw = dict(timestep=torch.tensor([0.5]),
              context=torch.from_numpy(rng.standard_normal((1, 5, 24)).astype(np.float32)),
              y=torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32)))
    out = wrapper(x, **kw)
    assert out.shape == x.shape and out.dtype == x.dtype and torch.isfinite(out).all()
    from safetensors.torch import load_file

    cfg = real_cfg(quant="int8", quant_mods=True, **TINY)
    direct = tce.ComfyUIFluxForwardWrapper(
        tflux.flux_load(TensorSource(load_file(str(comfy / "flux.safetensors")), "cpu"), cfg),
        cfg)
    assert torch.equal(out, direct(x, **kw))


def test_node_mappings_match_the_jax_nodes(comfy):
    port, ref = _load("nodes_torch"), _load("nodes")
    assert set(port.NODE_CLASS_MAPPINGS) == set(port.NODE_DISPLAY_NAME_MAPPINGS)
    assert port.NODE_DISPLAY_NAME_MAPPINGS == ref.NODE_DISPLAY_NAME_MAPPINGS
    assert set(port.NODE_CLASS_MAPPINGS) == set(ref.NODE_CLASS_MAPPINGS)
    for name, cls in port.NODE_CLASS_MAPPINGS.items():
        want = ref.NODE_CLASS_MAPPINGS[name]
        assert cls.__name__ == want.__name__ == name
        assert (cls.FUNCTION, cls.RETURN_TYPES, cls.CATEGORY) == \
            (want.FUNCTION, want.RETURN_TYPES, want.CATEGORY)
        assert cls.INPUT_TYPES() == want.INPUT_TYPES()
        assert cls.INPUT_TYPES()["required"]["quant"] == (["int8", "fp8", "bf16"],)


def test_build_cache_matches_the_jax_nodes(comfy):
    port, ref = _load("nodes_torch"), _load("nodes")
    assert port._build_cache(False, 0.3) is None and ref._build_cache(False, 0.3) is None
    got, want = port._build_cache(True, 0.3).config, ref._build_cache(True, 0.3).config
    for k in ("cache_algorithm", "enable_caching", "threshold", "probe_depth", "ret_ratio",
              "rel_l1_distance_algo"):
        assert getattr(got, k) == getattr(want, k), k
