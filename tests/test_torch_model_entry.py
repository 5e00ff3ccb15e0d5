"""The port's front-end plumbing against the JAX package's:

  * model_entry.create_model: the registry's names equal JAX's; a tiny
    FLUX checkpoint gives a forward within the port's bf16 FLUX tolerance
    (relative L2 1e-2, tests/test_torch_flux.py) of JAX's create_model
    forward, in bf16 and int8 (the integer GEMMs exact, the same weights:
    2e-2, as tests/test_torch_flux.py's W8A8 forwards); its ValueErrors;
  * common_args: reference argv parse to the same values as JAX's, and the
    port's refusals (--kernel-backend jnp, a mesh of more than one device);
  * utils.profiling on the CPU: time_record, benchmark_kernel, trace;
  * FastDMEngine.generate's reference spellings (steps, gen_seed,
    gen_width, gen_height, src_image, max_seq_len) on all five families:
    the same latents, bit for bit, as the diffusers spelling; both spellings
    of one argument raise TypeError; a per-call max_sequence_length is
    taken and ignored. The tiny engines are also the API server tests'."""

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdm_tpu_torch.engine as teng
from fastdm_tpu_torch import common_args as targs
from fastdm_tpu_torch import model_entry as tme
from fastdm_tpu_torch.models import sdxl as tsdxl
from fastdm_tpu_torch.pipeline import vae as tvae
from fastdm_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(__file__))
from test_engine_e2e import _vae_sd, _write_st  # noqa: E402
from test_golden_flux import TINY as FLUX_TINY  # noqa: E402
from test_golden_flux import _synthetic_state_dict  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

FAMILIES = ("flux", "sd35", "sdxl", "qwen", "wan")


# ------------------------------------------------------------ tiny engines


def _flux_root(root):
    from test_torch_pipeline import _tiny_checkpoint

    class _P:  # _tiny_checkpoint writes under tmp_path / "flux-tiny"
        def __truediv__(self, name):
            return os.path.join(root, name)

    path, _ = _tiny_checkpoint(_P())
    return path


def _write_root(family: str, root: str) -> str:
    """A tiny diffusers-layout checkpoint of the family under root (the
    writers of the family's own engine tests)."""
    if family == "flux":
        return _flux_root(root)
    path = os.path.join(root, f"{family}-tiny")
    if family == "sd35":
        from test_torch_sd35 import N_DUAL, TINY, _state_dict

        _write_st(os.path.join(path, "transformer", "model.safetensors"), _state_dict(11))
        with open(os.path.join(path, "transformer", "config.json"), "w") as f:
            json.dump(dict(TINY, dual_attention_layers=list(range(N_DUAL))), f)
        _write_st(os.path.join(path, "vae", "model.safetensors"),
                  _vae_sd(np.random.default_rng(12), latent_channels=4))
    elif family == "sdxl":
        from test_engine_e2e import _sdxl_sd

        rng = np.random.default_rng(9)
        _write_st(os.path.join(path, "unet", "model.safetensors"), _sdxl_sd(rng))
        _write_st(os.path.join(path, "vae", "model.safetensors"),
                  _vae_sd(rng, latent_channels=4))
    elif family == "qwen":
        from test_torch_qwen import _write_checkpoint

        _write_checkpoint(path, wan_vae=False)
    else:
        from test_torch_wan import _write_wan_checkpoint

        os.makedirs(path)
        _write_wan_checkpoint(path)
    return path


ARCH = {"flux": "flux", "sd35": "sd3.5", "sdxl": "sdxl", "qwen": "qwen-image",
        "wan": "wan2.2-t2v"}


def tiny_engine(family: str, root: str, architecture=None, **kw):
    """A FastDMEngine on the CPU over the family's tiny checkpoint, the
    engine's VAE and SDXL configs shrunk to it while it loads."""
    from test_torch_pipeline import VAE_TINY
    from test_torch_sdxl import TINY as SDXL_TINY

    vaes = {"flux": tvae.VAEConfig(**VAE_TINY),
            "sd35": tvae.VAEConfig(**dict(VAE_TINY, scaling_factor=1.5305,
                                          shift_factor=0.0609)),
            "sdxl": tvae.VAEConfig(**VAE_TINY),
            "qwen": tvae.VAEConfig(latent_channels=4, block_out_channels=(8, 8, 8, 8),
                                   layers_per_block=1, norm_num_groups=4, scaling_factor=1.0,
                                   shift_factor=0.0)}
    with pytest.MonkeyPatch.context() as mp:
        if family in vaes:
            mp.setitem(teng.VAE_CONFIGS, family, vaes[family])
        if family == "sdxl":
            tiny = tsdxl.SDXLConfig
            mp.setattr(tsdxl, "SDXLConfig", lambda quant=None: tiny(quant=quant, **SDXL_TINY))
        return teng.FastDMEngine(root, architecture=architecture or ARCH[family],
                                 verbose=False, device="cpu", **kw)


def embeds(family: str, seed: int) -> dict:
    """Prompt embeddings of the family's tiny widths, as the engine takes them."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if family == "flux":
        return dict(prompt_embeds=r(1, 12, FLUX_TINY["joint_attention_dim"]),
                    pooled_prompt_embeds=r(1, FLUX_TINY["pooled_projection_dim"]))
    if family == "sd35":
        return dict(prompt_embeds=r(1, 7, 32), pooled_prompt_embeds=r(1, 24),
                    negative_prompt_embeds=r(1, 7, 32), negative_pooled_prompt_embeds=r(1, 24))
    if family == "sdxl":
        return dict(prompt_embeds=r(1, 6, 16), pooled_prompt_embeds=r(1, 8),
                    negative_prompt_embeds=r(1, 6, 16), negative_pooled_prompt_embeds=r(1, 8))
    if family == "qwen":
        return dict(prompt_embeds=r(1, 5, 24), negative_prompt_embeds=r(1, 5, 24))
    return dict(prompt_embeds=r(1, 8, 32), negative_prompt_embeds=r(1, 8, 32))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("engines"))
    return {f: tiny_engine(f, _write_root(f, base)) for f in FAMILIES}


# ------------------------------------------------------------ engine spellings


def _request(family: str, reference: bool) -> dict:
    """One small request in the reference's spellings or in diffusers'."""
    size = {"height": 64, "width": 64}
    if family == "qwen":
        size = {"height": 64, "width": 96}
    kw = dict(embeds(family, 3), guidance_scale=4.0, output_type="latent")
    if family == "wan":
        kw["num_frames"] = 5
    if reference:
        kw.update(steps=2, gen_seed=7, gen_width=size["width"], gen_height=size["height"],
                  max_seq_len=77)
    else:
        kw.update(num_inference_steps=2, seed=7, **size)
    return kw


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_takes_the_reference_spellings(engines, family):
    eng = engines[family]
    got = eng.generate(**_request(family, True))
    want = eng.generate(**_request(family, False))
    np.testing.assert_array_equal(got, want)
    # a per-call max_sequence_length is taken and ignored (the constructor's holds)
    np.testing.assert_array_equal(
        eng.generate(max_sequence_length=300, **_request(family, False)), want)
    for ref, ours, val in (("steps", "num_inference_steps", 2), ("gen_seed", "seed", 7),
                           ("gen_width", "width", 64), ("gen_height", "height", 64),
                           ("src_image", "image", None),
                           ("max_seq_len", "max_sequence_length", 77)):
        with pytest.raises(TypeError, match=f"both '{ref}' and '{ours}'"):
            eng.generate(**{ref: val, ours: val}, **embeds(family, 3))
    with pytest.raises(TypeError):
        eng.generate(not_an_argument=1, **_request(family, False))


# ------------------------------------------------------------ the JAX keywords


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_keywords_at_defaults_equal_their_absence(engines, tmp_path, family):
    """kernel_backend, oom_resolve, mesh_shape and offload_inactive_expert
    (fastdm_tpu/engine.py:103-116) at their defaults, and a mesh of one
    device in either form, give the engine built without them bit for bit."""
    want = engines[family].generate(**_request(family, False))
    root = _write_root(family, str(tmp_path))
    for kw in (dict(kernel_backend="auto", oom_resolve=False, mesh_shape=None,
                    offload_inactive_expert=False),
               dict(kernel_backend="pallas", oom_resolve=True, mesh_shape=(1, 1, 1),
                    offload_inactive_expert=True),
               dict(mesh_shape=(1, 1, 1, 1))):
        eng = tiny_engine(family, root, **kw)
        np.testing.assert_array_equal(eng.generate(**_request(family, False)), want)
        assert eng.mesh is None if kw.get("mesh_shape") is None else eng.mesh.size == 1


def test_jax_keyword_refusals():
    """kernel_backend 'jnp' and unknown names raise ValueError (JAX's type
    for a bad backend), a mesh not of 3 or 4 axes ValueError, a larger mesh
    without torch.distributed RuntimeError (tp > 1 for SDXL as for FLUX):
    each before any weight is read."""
    for kw, exc, msg in ((dict(kernel_backend="jnp"), ValueError, "jnp"),
                         (dict(kernel_backend="cuda"), ValueError, "invalid kernel backend"),
                         (dict(mesh_shape=(1, 2)), ValueError, "mesh_shape must be"),
                         (dict(mesh_shape=(1, 1, 2), architecture="sdxl"), RuntimeError,
                          "torchrun"),
                         (dict(mesh_shape=(1, 1, 2)), RuntimeError, "torchrun"),
                         (dict(mesh_shape=(2, 1, 1, 1)), RuntimeError, "torchrun")):
        with pytest.raises(exc, match=msg):
            teng.FastDMEngine("/nonexistent", device="cpu", **dict(dict(architecture="flux"), **kw))


def test_wan_t2i_runs_t2v_or_i2v(engines, tmp_path):
    """task "t2i", the CLI's default, on a Wan engine is t2v without an image
    and i2v with one (fastdm_tpu/engine.py:812-813), bit for bit the task=None
    generates (on the tiny t2v checkpoint, and on a Wan2.2-I2V-A14B layout
    for the image)."""
    from test_torch_wan_ti2v import VAE_TINY as WAN_VAE_TINY
    from test_torch_wan_ti2v import _embeds as wan_embeds
    from test_torch_wan_ti2v import _mk_diffusers_state_dict, _write_transformer, _write_vae

    eng = engines["wan"]
    kw = _request("wan", False)
    np.testing.assert_array_equal(eng.generate(task="t2i", **kw), eng.generate(**kw))
    root = str(tmp_path)
    for sub, seed in (("transformer", 0), ("transformer_2", 1)):
        _write_transformer(root, sub, seed, 36, 16)
    vcfg = dataclasses.replace(WAN_VAE_TINY, z_dim=16,
                               latents_mean=tuple(0.05 * i for i in range(16)),
                               latents_std=tuple(1.0 + 0.05 * i for i in range(16)))
    _write_vae(root, vcfg, _mk_diffusers_state_dict(vcfg))
    i2v = teng.FastDMEngine(root, architecture="wan2.2-i2v", verbose=False, device="cpu")
    pos, neg = wan_embeds(6)
    image = np.random.default_rng(7).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=32, width=48, num_frames=5,
              num_inference_steps=2, seed=2, output_type="latent", image=image)
    np.testing.assert_array_equal(i2v.generate(task="t2i", **kw), i2v.generate(**kw))
    np.testing.assert_array_equal(i2v.generate(task="t2i", **kw),
                                  i2v.generate(task="i2v", **kw))


def test_src_image_is_the_image():
    """src_image maps to image: a FLUX-Kontext generate from src_image equals
    the one from image (the alias runs before the task is chosen)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        eng = tiny_engine("flux", _flux_root(d), architecture="flux-kontext")
        img = (np.random.default_rng(4).random((64, 64, 3)) * 255).astype(np.uint8)
        kw = dict(embeds("flux", 5), num_inference_steps=2, seed=3, output_type="latent")
        np.testing.assert_array_equal(eng.generate(src_image=img, **kw),
                                      eng.generate(image=img, **kw))


# ------------------------------------------------------------ create_model


def test_registry_names_equal_jax():
    from fastdm_tpu.model_entry import MODEL_REGISTRY as JREG

    assert sorted(tme.MODEL_REGISTRY) == sorted(JREG)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_create_model_from_checkpoint_matches_jax(tmp_path, quant):
    from fastdm_tpu.model_entry import create_model as j_create_model
    from fastdm_tpu.models import flux as jflux
    from fastdm_tpu_torch.models import flux as tflux

    _write_st(str(tmp_path / "model.safetensors"),
              _synthetic_state_dict(FLUX_TINY, np.random.default_rng(0)))
    jcfg, jparams, jfwd = j_create_model("flux-dev", ckpt_path=str(tmp_path), quant=quant,
                                         **FLUX_TINY)
    tcfg, tparams, tfwd = tme.create_model("flux-dev", ckpt_path=str(tmp_path), quant=quant,
                                           device="cpu", **FLUX_TINY)
    assert tfwd is tflux.flux_forward and tcfg.quant == quant
    want_dtype = torch.int8 if quant else torch.bfloat16
    assert tparams.dual_blocks[0].attn.qkv.w.dtype == want_dtype
    rng = np.random.default_rng(1)
    h = rng.standard_normal((1, 16, FLUX_TINY["in_channels"]))
    e = rng.standard_normal((1, 8, FLUX_TINY["joint_attention_dim"]))
    p = rng.standard_normal((1, FLUX_TINY["pooled_projection_dim"]))
    jcos, jsin = jflux.flux_rope_cache(jcfg, 8, 4, 4)
    want = jfwd(jparams, jcfg, jnp.asarray(h, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16),
                jnp.asarray(p, jnp.bfloat16), jnp.full((1,), 0.5, jnp.float32), jcos, jsin,
                guidance=jnp.full((1,), 3.5, jnp.float32))
    tcos, tsin = tflux.flux_rope_cache(tcfg, 8, 4, 4, device="cpu")
    t = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32))  # noqa
    with torch.inference_mode():
        got = tfwd(tparams, tcfg, t(h).bfloat16(), t(e).bfloat16(), t(p).bfloat16(),
                   torch.full((1,), 0.5), tcos, tsin, guidance=torch.full((1,), 3.5))
    w = np.asarray(want, np.float32)
    rel = np.linalg.norm(got.float().numpy() - w) / np.linalg.norm(w)
    assert rel <= (1e-2 if quant is None else 2e-2), rel


def test_create_model_random_runs_on_the_cpu():
    cfg, params, fwd = tme.create_model("qwen-image", quant=None, seed=3, device="cpu",
                                        num_layers=1, attention_head_dim=32,
                                        num_attention_heads=2, joint_attention_dim=24,
                                        in_channels=8, out_channels=2, axes_dims_rope=(8, 12, 12))
    assert cfg.num_layers == 1 and next(params.parameters()).device.type == "cpu"
    cfg2, params2, _ = tme.create_model("qwen-image", quant=None, seed=3, device="cpu",
                                        **{k: getattr(cfg, k) for k in (
                                            "num_layers", "attention_head_dim",
                                            "num_attention_heads", "joint_attention_dim",
                                            "in_channels", "out_channels", "axes_dims_rope")})
    for a, b in zip(params.parameters(), params2.parameters()):
        assert torch.equal(a, b)  # seeded


def test_create_model_errors():
    with pytest.raises(ValueError, match="unknown architecture"):
        tme.create_model("sd15", device="cpu")
    for name in ("sdxl-controlnet", "flux-controlnet"):
        with pytest.raises(ValueError, match="requires a checkpoint"):
            tme.create_model(name, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tme.create_model("flux", quant=None, num_layers=1)  # the card by default


# ------------------------------------------------------------ common_args


ARGVS = [
    ["--model-path", "m"],
    ["--model-path", "m", "--architecture", "wan2.2-i2v", "--use-int4", "--pack-int4",
     "--cache-config", "c.json", "--sparse-attn-config", "s.json", "--quant-mods",
     "--snapshot-path", "snap", "--oom-resolve", "--kernel-backend", "pallas"],
    ["--model-path", "m", "--architecture", "qwen-image-edit", "--use-fp8", "--mesh-shape",
     "1,1,1", "--task", "i2i", "--prompt", "a cat", "--negative-prompt", "blur", "--height",
     "512", "--width", "768", "--num-inference-steps", "8", "--guidance-scale", "1.5",
     "--true-cfg-scale", "2.5", "--num-frames", "33", "--fps", "8", "--image", "x.png",
     "--seed", "3", "--num-images-per-prompt", "2", "--output", "o.png", "--warmup", "0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "engine", "generation"])
def test_flags_parse_as_jax(argv):
    from fastdm_tpu import common_args as jargs

    def parse(mod):
        p = argparse.ArgumentParser()
        mod.add_engine_args(p)
        mod.add_generation_args(p)
        return vars(p.parse_args(argv))

    got, want = parse(targs), parse(jargs)
    assert got.pop("device") == "cuda"  # the port's own flag, the card by default
    assert got == want
    assert targs.parse_mesh_shape(got["mesh_shape"]) == jargs.parse_mesh_shape(want["mesh_shape"])


def _args(*extra):
    p = argparse.ArgumentParser()
    targs.add_engine_args(p, extra_architectures=("wan-lightning",))
    return p.parse_args(["--model-path", "m", *extra])


def _load_api_server():
    """examples/serve/api_server_torch.py, loaded by path (its dataclasses
    look their module up in sys.modules)."""
    import importlib.util

    name = "_api_server_torch_entry"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(
            os.path.dirname(__file__), "..", "examples", "serve", "api_server_torch.py"))
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def test_port_refusals_and_engine_kwargs():
    with pytest.raises(ValueError, match="jnp"):
        targs.engine_kwargs(_args("--kernel-backend", "jnp"))
    # every family takes tp > 1
    for arch in ("sdxl", "flux"):
        assert targs.engine_kwargs(_args("--mesh-shape", "1,1,2", "--architecture", arch)
                                   )["mesh_shape"] == (1, 1, 2)
    kw = targs.engine_kwargs(_args("--mesh-shape", "1,1,1", "--use-int8", "--device", "cpu",
                                   "--architecture", "wan-lightning"))
    assert kw["use_int8"] and kw["device"] == "cpu" and kw["architecture"] == "wan-lightning"
    assert kw["mesh_shape"] == (1, 1, 1) and kw["kernel_backend"] == "auto"
    for mesh in ("1,2,1", "2,1,1", "1,1,1,4", "2,1,1,2"):
        kw = targs.engine_kwargs(_args("--mesh-shape", mesh, "--kernel-backend", "pallas"))
        assert kw["mesh_shape"] == targs.parse_mesh_shape(mesh)
        assert kw["kernel_backend"] == "pallas"
        # the mesh reaches the engine of every front-end: the API server and
        # the Gradio UI serve a larger one from rank 0 (parallel/request_loop.py)
        server = _load_api_server().build_parser().parse_args(
            ["--model-path", "m", "--served-model-name", "s", "--mesh-shape", mesh])
        assert targs.engine_kwargs(server)["mesh_shape"] == targs.parse_mesh_shape(mesh)
    with pytest.raises(SystemExit):  # not a choice without extra_architectures
        p = argparse.ArgumentParser()
        targs.add_engine_args(p)
        p.parse_args(["--model-path", "m", "--architecture", "wan-lightning"])


# ------------------------------------------------------------ profiling


def test_time_record_and_benchmark_kernel(monkeypatch):
    calls = []

    @profiling.time_record("unit")
    def f(x):
        calls.append(x)
        time.sleep(0.01)
        return x + 1

    monkeypatch.setattr(profiling, "time_records", {})
    monkeypatch.setattr(profiling, "do_time_prof", False)
    assert f(torch.ones(2)).sum() == 4 and profiling.time_records == {}
    monkeypatch.setattr(profiling, "do_time_prof", True)
    f(torch.ones(2))
    f(torch.ones(2))
    assert len(profiling.time_records["unit"]) == 2
    assert all(t >= 0.01 for t in profiling.time_records["unit"])
    best = profiling.benchmark_kernel(lambda: time.sleep(0.002), warmup=1, reps=3)
    assert 0.002 <= best < 1.0
    profiling.kernel_output_assert_close(torch.ones(3), torch.ones(3) + 1e-3)
    with pytest.raises(AssertionError):
        profiling.kernel_output_assert_close(torch.ones(3), torch.ones(3) + 1.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.nn.functional.softmax(torch.randn(64, 64), dim=-1)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("softmax" in e.get("name", "") for e in events)
    assert any("softmax" in e.key for e in prof.key_averages())
