"""The port's CLI demos (examples/demo/*_torch.py) and TeaCache fitter
(examples/xcaching/fit_teacache_torch.py) on tiny checkpoints, on the CPU:

  * each demo's main() with --device cpu writes, through the port's PNG
    codec, exactly the image (or, for a video, the frames) that the
    engine's generate() gives for the same arguments; the ControlNet demo's
    hint is resized with Pillow's bicubic, bit for bit;
  * the fitter against the reference fitter (examples/xcaching/fit_teacache.py,
    loaded by path) on the same tiny FLUX, SD3.5 and Qwen-Image checkpoints
    and the same inputs (the reference's jax.random draws handed to the
    port): every per-step (x, y) pair within FIT_REL of the reference's
    (bf16 forwards of two implementations: their rel-L1 distances agree to
    a few bf16 roundings), the same JSON keys; FLUX's DiCache sweep and
    Qwen's --dual too.

Prompts reach the engines through a seeded stand-in text encoder (the
encoders are tests/test_torch_text_engine.py's)."""

import dataclasses
import functools
import importlib.util
import json
import os
import re
import sys
import zlib

import numpy as np
import pytest
import torch

from fastdm_tpu_torch import engine as teng
from fastdm_tpu_torch.pipeline import vae as tvae
from fastdm_tpu_torch.utils.png import read_image, write_image

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model_entry import _flux_root, _write_root, embeds, tiny_engine  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
FIT_REL = 3e-2


def _load(rel: str):
    """An examples/ script loaded by path (its directory on sys.path, as
    when it runs)."""
    path = os.path.join(EXAMPLES, rel)
    sys.path.insert(0, os.path.dirname(path))
    name = "_" + rel.replace("/", "_")[:-3]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


class _StubEncoder:
    """Prompt strings -> embeddings drawn from a seed of the string, at the
    family's tiny widths: (embeds, pooled) for FLUX and SDXL, embeds for
    Wan."""

    def __init__(self, family):
        self.family = family

    def encode(self, prompt, num_images_per_prompt=1):
        e = embeds(self.family, zlib.crc32(prompt.encode()))
        t = lambda a: torch.from_numpy(a).bfloat16().repeat(  # noqa: E731
            num_images_per_prompt, *([1] * (a.ndim - 1)))
        if self.family in ("flux", "sdxl"):
            return t(e["prompt_embeds"]), t(e["pooled_prompt_embeds"])
        return t(e["prompt_embeds"])


@pytest.fixture
def stub_encoders(monkeypatch):
    """The engine's text encoder classes replaced by the stand-in."""
    for family, cls in (("flux", "FluxTextEncoder"), ("sdxl", "SDXLTextEncoder"),
                        ("wan", "WanTextEncoder")):
        monkeypatch.setattr(teng, cls, lambda *a, _f=family, **k: _StubEncoder(_f))


def _argv(root, out, *extra):
    return ["--model-path", root, "--device", "cpu", "--prompt", "a red fox", "--height", "64",
            "--width", "64", "--num-inference-steps", "2", "--seed", "3", "--warmup", "0",
            "--output", str(out), *extra]


def test_gen_writes_what_generate_gives(tmp_path, stub_encoders):
    """gen_torch.py: a FLUX image (one warmup, as the CLI's default) and a
    Wan t2v video as one PNG a frame."""
    from test_torch_pipeline import VAE_TINY

    gen = _load("demo/gen_torch.py")
    root = _flux_root(str(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(teng.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
        argv = _argv(root, tmp_path / "fox.png", "--guidance-scale", "3.0")
        got = gen.main([a for a in argv if a not in ("--warmup", "0")])
    want = tiny_engine("flux", root).generate(
        prompt="a red fox", negative_prompt=None, height=64, width=64, num_inference_steps=2,
        guidance_scale=3.0, seed=3, num_images_per_prompt=1, task="t2i")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(str(tmp_path / "fox.png")), want[0])

    wan = _write_root("wan", str(tmp_path))
    frames = gen.main(_argv(wan, tmp_path / "clip.png", "--architecture", "wan2.2-t2v",
                            "--task", "t2v", "--num-frames", "5"))
    want = tiny_engine("wan", wan).generate(
        prompt="a red fox", negative_prompt=None, height=64, width=64, num_inference_steps=2,
        guidance_scale=3.5, seed=3, num_images_per_prompt=1, task="t2v", num_frames=5)
    np.testing.assert_array_equal(frames, want)
    assert want.shape[:2] == (1, 5)
    for i in range(5):
        np.testing.assert_array_equal(read_image(str(tmp_path / f"clip_f{i:04d}.png")),
                                      want[0, i])


def test_controlnet_demo_writes_what_generate_gives(tmp_path, stub_encoders):
    """controlnet_demo_torch.py on SDXL with an SDXL ControlNet: the 48x80
    hint resized to 64x64 as PIL's Image.resize does by default (bicubic),
    guess mode and the conditioning scale passed through."""
    from PIL import Image
    from test_engine_e2e import _sdxl_sd, _write_st
    from test_torch_sdxl import TINY as SDXL_TINY

    from fastdm_tpu_torch.models import sdxl as tsdxl

    demo = _load("demo/controlnet_demo_torch.py")
    root = _write_root("sdxl", str(tmp_path))
    cn = str(tmp_path / "cn")
    _write_st(os.path.join(cn, "diffusion_pytorch_model.safetensors"),
              _sdxl_sd(np.random.default_rng(24), cn=True))
    hint = (np.random.default_rng(5).random((48, 80, 3)) * 255).astype(np.uint8)
    write_image(str(tmp_path / "hint.png"), hint)
    resized = np.asarray(Image.fromarray(hint).resize((64, 64)))
    with pytest.MonkeyPatch.context() as mp:
        tiny = tsdxl.SDXLConfig
        mp.setattr(tsdxl, "SDXLConfig", lambda quant=None: tiny(quant=quant, **SDXL_TINY))
        from test_torch_pipeline import VAE_TINY

        mp.setitem(teng.VAE_CONFIGS, "sdxl", tvae.VAEConfig(**VAE_TINY))
        got = demo.main(_argv(root, tmp_path / "cn.png", "--architecture", "sdxl",
                              "--controlnet-path", cn, "--control-image",
                              str(tmp_path / "hint.png"), "--conditioning-scale", "0.7",
                              "--guess-mode"))
    want = tiny_engine("sdxl", root, controlnet_path=cn).generate(
        prompt="a red fox", negative_prompt=None, height=64, width=64, num_inference_steps=2,
        guidance_scale=3.5, seed=3, control_image=resized, controlnet_conditioning_scale=0.7,
        guess_mode=True, control_mode=None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(str(tmp_path / "cn.png")), want[0])


def test_image_edit_writes_what_generate_gives(tmp_path, stub_encoders):
    """image_edit_torch.py on flux-kontext: one --image, then two --images
    (a list reference)."""
    from test_torch_pipeline import VAE_TINY

    demo = _load("demo/image_edit_torch.py")
    root = _flux_root(str(tmp_path))
    srcs = [(np.random.default_rng(s).random((64, 64, 3)) * 255).astype(np.uint8)
            for s in (6, 7)]
    for i, s in enumerate(srcs):
        write_image(str(tmp_path / f"src{i}.png"), s)
    eng = tiny_engine("flux", root, architecture="flux-kontext")
    for flag, paths, image in (("--image", ["src0.png"], srcs[0]),
                               ("--images", ["src0.png", "src1.png"], srcs)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(teng.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
            got = demo.main(_argv(root, tmp_path / "edit.png", "--architecture", "flux-kontext",
                                  flag, *[str(tmp_path / p) for p in paths]))
        want = eng.generate(prompt="a red fox", negative_prompt=None, image=image, task="i2i",
                            num_inference_steps=2, guidance_scale=3.5, true_cfg_scale=None,
                            seed=3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_image(str(tmp_path / "edit.png")), want[0])


# ------------------------------------------------------------ the fitter


def _steps(out: str):
    """The (x, y) pairs of the 'step i: x=.. y=..' lines."""
    return [(float(x), float(y)) for x, y in
            re.findall(r"^step \d+: x=([-\d.e]+) y=([-\d.e]+)$", out, re.M)]


def _tiny_defaults(family):
    """{config class's module, class name, the tiny checkpoint's fields}."""
    if family == "flux":
        from test_engine_e2e import TINY

        return "flux", "FluxConfig", {k: v for k, v in TINY.items()
                                      if k not in ("num_layers", "num_single_layers",
                                                   "patch_size")}
    if family == "sd35":
        from test_torch_sd35 import N_DUAL, TINY

        return "sd35", "SD3Config", dict({k: v for k, v in TINY.items() if k != "num_layers"},
                                         num_dual_layers=N_DUAL)
    from test_torch_qwen import TINY

    return "qwenimage", "QwenImageConfig", {k: v for k, v in TINY.items() if k != "num_layers"}


def _with_defaults(cls, defaults: dict):
    """A frozen dataclass subclass of config class `cls`, of its name, whose
    fields in `defaults` default to those values (the fitters build their
    configs from the defaults)."""
    ns = {"__annotations__": {k: cls.__dataclass_fields__[k].type for k in defaults},
          "__module__": cls.__module__, **defaults}
    return dataclasses.dataclass(frozen=True)(type(cls.__name__, (cls,), ns))


@functools.lru_cache(maxsize=None)
def _fit_root(family, base):
    return _write_root(family, base) if family != "flux" else _flux_root(base)


FIT_CASES = {  # case: (family, fitter flags)
    "flux": ("flux", ["--layers", "2", "--single-layers", "2"]),
    "flux-dicache": ("flux", ["--layers", "2", "--single-layers", "2", "--algorithm",
                              "dicache", "--probe-depth", "1"]),
    "sd35": ("sd35", ["--layers", "4"]),
    "qwen-dual": ("qwen", ["--layers", "3", "--dual"]),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fitter_records_the_reference_pairs(tmp_path_factory, monkeypatch, capsys, case):
    """fit_teacache_torch.py and fit_teacache.py on one tiny checkpoint,
    bf16, 4 steps at 64x64, the same inputs: the same
    number of (x, y) pairs, each within FIT_REL (relative) of the
    reference's; both write the same JSON keys."""
    import jax
    import jax.numpy as jnp

    family, flags = FIT_CASES[case]
    mod, cls, tiny = _tiny_defaults(family)
    jmod = importlib.import_module(f"fastdm_tpu.models.{mod}")
    tmod = importlib.import_module(f"fastdm_tpu_torch.models.{mod}")
    monkeypatch.setattr(jmod, cls, _with_defaults(getattr(jmod, cls), tiny))
    monkeypatch.setattr(tmod, cls, _with_defaults(getattr(tmod, cls), tiny))
    # the reference calls its forward eagerly, op by op: jitted here, once
    fwd = {"flux": "flux_forward", "sd35": "sd3_forward", "qwen": "qwen_forward"}[family]
    monkeypatch.setattr(jmod, fwd, jax.jit(getattr(jmod, fwd), static_argnums=1))
    root = _fit_root(family, str(tmp_path_factory.mktemp("fit")))
    out = tmp_path_factory.mktemp("fit-out")
    argv = ["--architecture", family, "--model-path", root, "--steps", "4", "--height", "64",
            "--width", "64", *flags]

    ref = _load("xcaching/fit_teacache.py")
    monkeypatch.setattr(sys, "argv", ["fit_teacache.py", *argv, "--output", str(out / "j.json")])
    capsys.readouterr()
    ref.main()
    want = _steps(capsys.readouterr().out)

    # the reference's draws: one key for every input, the negative text folded in
    k = jax.random.key(0)
    jcfg = getattr(jmod, cls)()
    txt = {"flux": 512, "sd35": 77, "qwen": 128}[family]
    lat = (1, jcfg.in_channels, 8, 8) if family == "sd35" else (1, 16, jcfg.in_channels)
    inputs = {"encoder": jax.random.normal(k, (1, txt, jcfg.joint_attention_dim), jnp.bfloat16),
              "latents": jax.random.normal(k, lat, jnp.float32),
              "encoder_neg": jax.random.normal(jax.random.fold_in(k, 1),
                                               (1, txt, jcfg.joint_attention_dim), jnp.bfloat16)}
    if family != "qwen":
        inputs["pooled"] = jax.random.normal(k, (1, jcfg.pooled_projection_dim), jnp.bfloat16)
    fit = _load("xcaching/fit_teacache_torch.py")
    xs, ys = fit.main([*argv, "--device", "cpu", "--output", str(out / "t.json")],
                      inputs={n: np.asarray(a, np.float32) for n, a in inputs.items()})
    got = list(zip(xs, ys))
    assert len(got) == len(want) == 3, (got, want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert abs(gx - wx) <= FIT_REL * abs(wx) and abs(gy - wy) <= FIT_REL * abs(wy), \
            (case, got, want)
    with open(out / "t.json") as f, open(out / "j.json") as g:
        t, j = json.load(f), json.load(g)
    assert sorted(t) == sorted(j)
    assert ("negtive_coefficients" in t) == (case == "qwen-dual")
