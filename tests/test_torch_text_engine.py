"""Prompt strings through the port's encoder classes and engine (the CPU
here, the card on the GPU machine):

  * FluxTextEncoder, SDXLTextEncoder, SD3TextEncoder and WanTextEncoder
    against the JAX package's classes of the same names (transformers'
    modules on the host) on one tiny checkpoint directory each, written by
    transformers' save_pretrained: equal in bf16 but for elements one bf16
    ulp apart (f32 sums taken in another order round the other way), at
    most BF16_ULP_FRACTION of them;
  * FastDMEngine.generate(prompt=..., negative_prompt=...) for flux, sd35,
    sdxl and wan equal, bit for bit, to generate with the port encoder's
    embeddings; a missing encoder directory raises and names it; qwen
    prompts raise, naming the Qwen2.5-VL item."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import fastdm_tpu_torch.engine as engine_mod
from fastdm_tpu_torch.engine import FastDMEngine
from fastdm_tpu_torch.pipeline import text_encoder as ttext
from fastdm_tpu_torch.pipeline import vae as tvae

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_pipeline import VAE_TINY as FLUX_VAE_TINY  # noqa: E402
from test_torch_pipeline import _tiny_checkpoint  # noqa: E402
from test_torch_pipeline import TINY as FLUX_TINY  # noqa: E402
from test_torch_sd35 import sd35_root  # noqa: E402,F401  (fixture)
from test_torch_sdxl import sdxl_engine_root  # noqa: E402,F401  (fixture)
from test_torch_text_encoder import PROMPTS, write_text_dirs  # noqa: E402
from test_torch_wan import _write_wan_checkpoint  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

DIMS = {"flux": dict(pooled=FLUX_TINY["pooled_projection_dim"], t5=FLUX_TINY["joint_attention_dim"]),
        "sdxl": dict(l=8, g=8, g_proj=8),   # cross_attention_dim 16, pooled 8
        "sd35": dict(l=8, l_proj=8, g=16, g_proj=16, t5=32),  # joint 32, pooled 24
        "wan": dict(t5=32)}                 # text_dim 32
# elements allowed one bf16 ulp from the JAX class's (none further)
BF16_ULP_FRACTION = 2e-3
ENC_PROMPTS = [PROMPTS[0], PROMPTS[2], PROMPTS[4], PROMPTS[-1]]


@pytest.fixture(scope="module")
def text_roots(tmp_path_factory):
    roots = {}
    for family in DIMS:
        roots[family] = str(tmp_path_factory.mktemp(f"text-{family}"))
        write_text_dirs(roots[family], family, DIMS[family])
    return roots


def _bf16_ulps(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in units of want's bf16 spacing, elementwise."""
    import jax.numpy as jnp

    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    spacing = np.spacing(np.abs(w).astype(np.float32)) * 2.0 ** 16  # f32 -> bf16 spacing
    return np.abs(g - w) / np.maximum(spacing, np.finfo(np.float32).tiny)


def _check_bf16(got, want):
    ulps = _bf16_ulps(got, want)
    assert ulps.max() <= 1.0, ulps.max()
    assert (ulps > 0).mean() <= BF16_ULP_FRACTION, (ulps > 0).mean()


@pytest.mark.parametrize("family", ["flux", "sdxl", "sd35", "wan"])
def test_encoder_classes_match_jax(text_roots, family):
    from fastdm_tpu.pipeline import text_encoder as jtext

    root = text_roots[family]
    if family == "wan":
        got = ttext.WanTextEncoder(root, 64, device="cpu").encode(ENC_PROMPTS, 2)
        want = jtext.WanTextEncoder(root, 64).encode(ENC_PROMPTS, 2)
        assert got.dtype == torch.bfloat16 and got.shape == (8, 64, 32)
        assert (got[-4:, -1] != 0).any() and not got[:2, -1].any()  # zero past the mask
        _check_bf16(got, want)
        return
    if family == "flux":
        port, ref = ttext.FluxTextEncoder(root, 96, device="cpu"), jtext.FluxTextEncoder(root, 96)
    elif family == "sdxl":
        port, ref = ttext.SDXLTextEncoder(root, device="cpu"), jtext.SDXLTextEncoder(root)
    else:
        port, ref = ttext.SD3TextEncoder(root, device="cpu"), jtext.SD3TextEncoder(root)
    (e, p), (je, jp) = port.encode(ENC_PROMPTS, 2), ref.encode(ENC_PROMPTS, 2)
    assert e.dtype == p.dtype == torch.bfloat16 and e.shape[0] == p.shape[0] == 8
    _check_bf16(e, je)
    _check_bf16(p, jp)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _flux_engine(tmp_path, monkeypatch, text_roots):
    root, _ = _tiny_checkpoint(tmp_path)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "flux", tvae.VAEConfig(**FLUX_VAE_TINY))
    for name in os.listdir(text_roots["flux"]):
        shutil.copytree(os.path.join(text_roots["flux"], name), os.path.join(root, name))
    return root


def test_engine_flux_prompt_equals_its_embeddings(tmp_path, monkeypatch, text_roots):
    root = _flux_engine(tmp_path, monkeypatch, text_roots)
    eng = FastDMEngine(root, verbose=False, device="cpu", max_sequence_length=40)
    kw = dict(height=64, width=64, num_inference_steps=2, seed=1)
    img = eng.generate(prompt=["a photo of a cat", PROMPTS[4]], negative_prompt="ignored",
                       num_images_per_prompt=2, max_sequence_length=77, **kw)
    embeds, pooled = eng.text_encoder.encode(["a photo of a cat", PROMPTS[4]], 2)
    assert embeds.shape == (4, 40, FLUX_TINY["joint_attention_dim"])  # the constructor's 40
    assert pooled.shape == (4, FLUX_TINY["pooled_projection_dim"])
    _same(img, eng.generate(prompt_embeds=embeds, pooled_prompt_embeds=pooled, **kw))
    # given embeddings win over the prompt
    _same(img, eng.generate(prompt="unused", prompt_embeds=embeds, pooled_prompt_embeds=pooled,
                            **kw))


@pytest.mark.parametrize("family", ["sd35", "sdxl"])
def test_engine_cfg_prompt_equals_its_embeddings(request, text_roots, family):
    root = request.getfixturevalue("sd35_root" if family == "sd35" else "sdxl_engine_root")
    for name in os.listdir(text_roots[family]):
        shutil.copytree(os.path.join(text_roots[family], name), os.path.join(root, name))
    arch = "sd3.5" if family == "sd35" else "sdxl"
    eng = FastDMEngine(root, architecture=arch, verbose=False, device="cpu")
    kw = dict(height=64, width=64, num_inference_steps=2, seed=3, output_type="latent")
    prompts = ["a photo of a cat", PROMPTS[2]]
    pos, pooled = eng.text_encoder.encode(prompts, 2)
    # a negative string: encoded under CFG, one row serving the batch
    neg, neg_pooled = eng.text_encoder.encode("blurry", 2)
    got = eng.generate(prompt=prompts, negative_prompt="blurry", num_images_per_prompt=2,
                       guidance_scale=5.0, **kw)
    want = eng.generate(prompt_embeds=pos, pooled_prompt_embeds=pooled,
                        negative_prompt_embeds=neg[:1].expand(4, -1, -1),
                        negative_pooled_prompt_embeds=neg_pooled[:1].expand(4, -1),
                        guidance_scale=5.0, **kw)
    assert got.shape[0] == 4
    _same(got, want)
    # no negative: "" under CFG; none without CFG
    neg, neg_pooled = eng.text_encoder.encode("", 1)
    pos, pooled = eng.text_encoder.encode("a cat", 1)
    got = eng.generate(prompt="a cat", guidance_scale=4.0, **dict(kw, output_type="np"))
    _same(got, eng.generate(prompt_embeds=pos, pooled_prompt_embeds=pooled,
                            negative_prompt_embeds=neg, negative_pooled_prompt_embeds=neg_pooled,
                            guidance_scale=4.0, **dict(kw, output_type="np")))
    _same(eng.generate(prompt="a cat", negative_prompt="x", guidance_scale=1.0, **kw),
          eng.generate(prompt_embeds=pos, pooled_prompt_embeds=pooled, guidance_scale=1.0,
                       **kw))


def test_engine_wan_prompt_equals_its_embeddings(tmp_path, text_roots):
    _write_wan_checkpoint(str(tmp_path))
    for name in os.listdir(text_roots["wan"]):
        shutil.copytree(os.path.join(text_roots["wan"], name), os.path.join(str(tmp_path), name))
    eng = FastDMEngine(str(tmp_path), architecture="wan2.2-t2v", verbose=False, device="cpu")
    assert eng.text_encoder.text_len == eng.cfg.text_len == 512
    kw = dict(height=64, width=64, num_frames=5, num_inference_steps=2, seed=5)
    pos, neg = eng.text_encoder.encode(PROMPTS[1]), eng.text_encoder.encode("static")
    assert pos.shape == (1, 512, 32) and not pos[0, 100:].any()
    video = eng.generate(prompt=PROMPTS[1], negative_prompt="static", **kw)
    _same(video, eng.generate(prompt_embeds=pos, negative_prompt_embeds=neg, **kw))
    # the negative is always encoded, "" when None
    _same(eng.generate(prompt=PROMPTS[1], **kw),
          eng.generate(prompt_embeds=pos, negative_prompt_embeds=eng.text_encoder.encode(""),
                       **kw))


@pytest.mark.parametrize("family", ["flux", "sd35", "sdxl", "wan"])
def test_engine_prompt_without_an_encoder_dir_raises(request, tmp_path, monkeypatch,
                                                     text_roots, family):
    """Each family's encoder directory taken away: a prompt raises
    FileNotFoundError naming it, embeddings still generate."""
    if family == "flux":
        root, arch = _flux_engine(tmp_path, monkeypatch, text_roots), "flux"
    elif family == "wan":
        root, arch = str(tmp_path), "wan2.2-t2v"
        _write_wan_checkpoint(root)
        for name in os.listdir(text_roots["wan"]):
            shutil.copytree(os.path.join(text_roots["wan"], name), os.path.join(root, name))
    else:
        root = request.getfixturevalue("sd35_root" if family == "sd35" else "sdxl_engine_root")
        arch = "sd3.5" if family == "sd35" else "sdxl"
        for name in os.listdir(text_roots[family]):
            shutil.copytree(os.path.join(text_roots[family], name), os.path.join(root, name))
    gone = "text_encoder" if family == "wan" else "text_encoder_2"
    shutil.rmtree(os.path.join(root, gone))
    eng = FastDMEngine(root, architecture=arch, verbose=False, device="cpu")
    with pytest.raises(FileNotFoundError, match=f"{gone}/"):
        eng.generate(prompt="a cat", height=64, width=64, num_inference_steps=1)


def test_qwen_prompt_raises_naming_the_vl_encoder(tmp_path, monkeypatch):
    from test_torch_qwen import _write_checkpoint

    root = str(tmp_path / "qwen")
    _write_checkpoint(root, wan_vae=False)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "qwen", tvae.VAEConfig(
        latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
        norm_num_groups=4, scaling_factor=1.0, shift_factor=0.0))
    eng = FastDMEngine(root, architecture="qwen-image", verbose=False, device="cpu")
    assert eng.text_encoder is None
    with pytest.raises(NotImplementedError, match="Qwen2.5-VL"):
        eng.generate(prompt="a cat", negative_prompt="blurry", height=64, width=64)
