"""Qwen prompts through the port's QwenImageTextEncoder and engine (the CPU
here, the card on the GPU machine), on tiny tokenizer/, text_encoder/ and
processor/ directories written by tests/test_torch_qwen_vl.py's helpers
(the encoders by transformers' save_pretrained):

  * encode() against the JAX package's QwenImageTextEncoder.encode (the
    Qwen2.5-VL text_encoder/ through AutoModelForVision2Seq, a qwen2 one
    through AutoModelForCausalLM), also truncated: equal in bf16 but for
    elements one bf16 ulp apart, at most BF16_ULP_FRACTION of them (the rule
    of tests/test_torch_text_engine.py);
  * encode_with_image() against the same computation through transformers'
    pieces: Qwen2VLImageProcessor on processor/, the edit template's pads
    expanded as Qwen2_5_VLProcessor does, AutoTokenizer, the model with
    pixel_values / image_grid_thw, hidden_states[-1] past the first 64
    positions. The JAX class's own encode_with_image cannot serve as the
    reference here: its AutoProcessor builds Qwen2VLVideoProcessor, which
    needs torchvision, absent from this sandbox, so it falls back to
    text-only encoding (checked below: it equals its encode());
  * the port's text-only fallback without processor/ or a vision tower;
  * FastDMEngine.generate(prompt=...) for qwen-image and qwen-image-edit
    (one image and a list) equal, bit for bit, to generate with the port
    encoder's embeddings."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from fastdm_tpu_torch.engine import FastDMEngine
from fastdm_tpu_torch.pipeline import image_processor as tip
from fastdm_tpu_torch.pipeline import text_encoder as ttext

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_qwen import _write_checkpoint as write_qwen_checkpoint  # noqa: E402
from test_torch_qwen_vl import IDS, write_qwen_tokenizer, write_text_encoder  # noqa: E402
from test_torch_text_engine import _check_bf16  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

PROMPTS = ["a photo of a cat sitting on the mat", "日本語 café, 100% real\n\n  end  "]
NEGATIVE = "blurry, low quality"
# processor/ at the published limits; the images' sides give 4 x 6 and 10 x
# 14 patches (6 and 35 image tokens)
MIN_PIXELS, MAX_PIXELS = 3136, 12845056


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def write_encoder_dirs(root: str, seed: int = 21, vision: bool = True,
                       processor: bool = True) -> str:
    write_qwen_tokenizer(os.path.join(root, "tokenizer"))
    write_text_encoder(os.path.join(root, "text_encoder"), seed, vision)
    if processor:
        tip.Qwen2VLImageProcessor(MIN_PIXELS, MAX_PIXELS).save(os.path.join(root, "processor"))
    return root


@pytest.fixture(scope="module")
def vl_root(tmp_path_factory):
    return write_encoder_dirs(str(tmp_path_factory.mktemp("qwen-vl")))


@pytest.mark.parametrize("vision,max_len", [(True, 1024), (True, 40), (False, 1024)],
                         ids=["vl", "vl-truncated", "qwen2"])
def test_encode_matches_jax(tmp_path, vl_root, vision, max_len):
    from fastdm_tpu.pipeline import text_encoder as jtext

    root = vl_root if vision else write_encoder_dirs(str(tmp_path), 22, vision=False,
                                                     processor=False)
    prompts = PROMPTS + [" ".join(["a majestic castle on a hill at dawn"] * 12)]
    port = ttext.QwenImageTextEncoder(root, max_len, device="cpu")
    got = port.encode(prompts, 2)
    want = jtext.QwenImageTextEncoder(root, max_len).encode(prompts, 2)
    assert got.dtype == torch.bfloat16 and got.shape[0] == 6 and got.shape[2] == 24
    assert (got.shape[1] == 40) == (max_len == 40)  # 40 + 34 tokens, the first 34 dropped
    mask = got.float().abs().sum(-1) != 0
    assert (~mask).any() and mask.any()  # zero past the shorter prompt
    _check_bf16(got, want)


def _hf_encode_with_image(root, prompts, images):
    """JAX's encode_with_image with transformers' pieces standing in for its
    AutoProcessor (which needs torchvision here)."""
    from transformers import AutoModelForImageTextToText, AutoTokenizer, Qwen2VLImageProcessor

    enc = ttext.QwenImageTextEncoder
    vision = enc.VISION
    prefix = vision if len(images) == 1 else "".join(
        f"Picture {i + 1}: {vision}" for i in range(len(images)))
    template = enc.EDIT_TEMPLATE.replace("<|im_start|>user\n" + vision,
                                         "<|im_start|>user\n" + prefix)
    texts = [template.format(p) for p in prompts]
    proc = Qwen2VLImageProcessor.from_pretrained(os.path.join(root, "processor"))
    pix = proc(images=images * len(texts), return_tensors="pt")
    k = 0
    for i, t in enumerate(texts):  # Qwen2_5_VLProcessor.__call__'s expansion
        while "<|image_pad|>" in t:
            n = int(pix.image_grid_thw[k].prod()) // proc.merge_size ** 2
            t = t.replace("<|image_pad|>", "<|placeholder|>" * n, 1)
            k += 1
        texts[i] = t.replace("<|placeholder|>", "<|image_pad|>")
    ids = AutoTokenizer.from_pretrained(os.path.join(root, "tokenizer"))(
        texts, padding=True, return_tensors="pt")
    model = AutoModelForImageTextToText.from_pretrained(os.path.join(root, "text_encoder"),
                                                        torch_dtype=torch.float32)
    with torch.no_grad():
        out = model(input_ids=ids.input_ids, attention_mask=ids.attention_mask,
                    pixel_values=pix.pixel_values, image_grid_thw=pix.image_grid_thw,
                    output_hidden_states=True)
    return out.hidden_states[-1][:, enc.EDIT_DROP_IDX:], ids.input_ids


@pytest.mark.parametrize("n_images", [1, 2])
def test_encode_with_image_matches_transformers(vl_root, n_images):
    images = [_image(30, 56, 84), _image(31, 140, 196)][:n_images]
    port = ttext.QwenImageTextEncoder(vl_root, device="cpu")
    got = port.encode_with_image(PROMPTS, images if n_images > 1 else images[0], 2)
    want, ids = _hf_encode_with_image(vl_root, PROMPTS, images)
    assert got.shape == (4, ids.shape[1] - 64, 24)
    assert int((ids == IDS["<|image_pad|>"]).sum()) == 2 * (6 + 35 * (n_images - 1))
    _check_bf16(got, want.repeat_interleave(2, dim=0).to(torch.bfloat16).float().numpy())


def test_jax_encode_with_image_falls_back_to_text_here(vl_root):
    """The reason encode_with_image is held to transformers' pieces above."""
    from fastdm_tpu.pipeline import text_encoder as jtext

    ref = jtext.QwenImageTextEncoder(vl_root)
    got = ref.encode_with_image(PROMPTS[0], _image(30, 56, 84))
    assert ref._vl is None
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(ref.encode(PROMPTS[0]), np.float32))


@pytest.mark.parametrize("missing", ["processor", "vision"])
def test_encode_with_image_without_a_vision_path_encodes_text(tmp_path, capsys, missing):
    root = write_encoder_dirs(str(tmp_path), 23, vision=missing != "vision")
    if missing == "processor":
        shutil.rmtree(os.path.join(root, "processor"))
    port = ttext.QwenImageTextEncoder(root, device="cpu")
    img = _image(32, 56, 84)
    for _ in range(2):
        assert torch.equal(port.encode_with_image(PROMPTS, img), port.encode(PROMPTS))
    said = capsys.readouterr().out
    assert said.count("encoded without the image") == 1
    assert ("processor/" if missing == "processor" else "vision_config") in said


def _engine(tmp_path, arch):
    root = str(tmp_path / "qwen")
    write_qwen_checkpoint(root, wan_vae=True)
    write_encoder_dirs(root, 24)
    return FastDMEngine(root, architecture=arch, verbose=False, device="cpu")


def test_engine_qwen_image_prompt_equals_its_embeddings(tmp_path):
    eng = _engine(tmp_path, "qwen-image")
    kw = dict(height=64, width=96, num_inference_steps=2, seed=3, output_type="latent")
    pos, neg = eng.text_encoder.encode(PROMPTS, 2), eng.text_encoder.encode(NEGATIVE)
    got = eng.generate(prompt=PROMPTS, negative_prompt=NEGATIVE, num_images_per_prompt=2,
                       true_cfg_scale=3.0, **kw)
    assert got.shape[0] == 4
    # one negative string serves every prompt
    np.testing.assert_array_equal(got, eng.generate(
        prompt_embeds=pos, negative_prompt_embeds=neg.expand(4, -1, -1), true_cfg_scale=3.0,
        **kw))
    # the negative defaults to " " under true CFG; none is encoded without it
    one = eng.text_encoder.encode(PROMPTS[0])
    np.testing.assert_array_equal(
        eng.generate(prompt=PROMPTS[0], true_cfg_scale=3.0, **dict(kw, output_type="np")),
        eng.generate(prompt_embeds=one, negative_prompt_embeds=eng.text_encoder.encode(" "),
                     true_cfg_scale=3.0, **dict(kw, output_type="np")))
    np.testing.assert_array_equal(
        eng.generate(prompt=PROMPTS[0], negative_prompt="x", true_cfg_scale=1.0, **kw),
        eng.generate(prompt_embeds=one, true_cfg_scale=1.0, **kw))
    # given embeddings win over the strings
    np.testing.assert_array_equal(
        eng.generate(prompt="unused", prompt_embeds=one, true_cfg_scale=1.0, **kw),
        eng.generate(prompt_embeds=one, true_cfg_scale=1.0, **kw))


@pytest.mark.parametrize("n_images", [1, 2])
def test_engine_qwen_image_edit_prompt_equals_its_embeddings(tmp_path, n_images):
    """The prompt and negative through encode_with_image on the images the
    engine resized to multiples of 16 (70 x 100 -> 64 x 96)."""
    from fastdm_tpu_torch.engine import _resize_to_multiple

    eng = _engine(tmp_path, "qwen-image-edit")
    images = [_image(33, 70, 100), _image(34, 40, 60)][:n_images]
    kw = dict(num_inference_steps=2, seed=4, true_cfg_scale=3.0, output_type="latent")
    got = eng.generate(prompt=PROMPTS[1], negative_prompt=NEGATIVE,
                       image=images if n_images > 1 else images[0], **kw)
    resized = [_resize_to_multiple(im, 16) for im in images]
    pos = eng.text_encoder.encode_with_image(PROMPTS[1], resized)
    neg = eng.text_encoder.encode_with_image(NEGATIVE, resized)
    assert pos.shape[1] > 0 and eng.text_encoder.processor is not False
    np.testing.assert_array_equal(got, eng.generate(
        prompt_embeds=pos, negative_prompt_embeds=neg, image=images, **kw))
