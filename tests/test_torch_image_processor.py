"""The port's CLIP image preprocessing (fastdm_tpu_torch/pipeline/
image_processor.py) against what the JAX package's CLIPImageEncoder runs on
the host, bit for bit:

  * resize_bicubic against PIL.Image.resize(BICUBIC) over upscales,
    downscales, the identity, odd sizes and extreme aspect ratios;
  * the whole pixel_values against transformers' CLIPImageProcessor at its
    defaults, at JAX's fallback settings and at preprocessor_config.json
    files with other size / crop_size (a crop larger than the resize pads),
    and over a bounded, derandomized hypothesis sweep;
  * the module with PIL hidden (sys.modules["PIL"] = None) gives the same
    bits; a resample other than BICUBIC raises, naming it."""

import importlib
import json
import os
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fastdm_tpu_torch.pipeline import image_processor as tip

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

RESIZES = [
    (720, 1280, 224, 398),    # a 720p frame to ViT-H's short side
    (224, 224, 224, 224),     # the identity: no pass runs
    (100, 50, 448, 224),      # an upscale on both axes
    (5, 7, 224, 313),         # a strong upscale
    (1000, 2040, 224, 456),   # a downscale, not a multiple of anything
    (17, 999, 224, 13152),    # extreme aspect: up along one axis only
    (999, 17, 13152, 224),
    (480, 640, 257, 300),     # odd output sides
    (301, 299, 300, 301),     # nearly the identity, one pass each way
    (64, 2048, 8, 256),       # a large downscale (support widened 8x)
]


def _image(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("h,w,oh,ow", RESIZES)
def test_resize_matches_pil(h, w, oh, ow):
    from PIL import Image

    img = _image(h * 7 + w, h, w)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
    np.testing.assert_array_equal(tip.resize_bicubic(img, oh, ow), want)


def test_resize_smooth_image_and_extremes():
    """A smooth gradient (overshoot near 0 and 255 exercises the clip), a
    constant image and a one-pixel image."""
    from PIL import Image

    y, x = np.mgrid[0:37, 0:53]
    grad = np.stack([x * 255 // 52, y * 255 // 36, (x + y) % 2 * 255], -1).astype(np.uint8)
    for img, (oh, ow) in ((grad, (224, 320)), (grad, (11, 9)),
                          (np.full((9, 9, 3), 200, np.uint8), (224, 224)),
                          (np.full((1, 1, 3), 7, np.uint8), (5, 5))):
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
        np.testing.assert_array_equal(tip.resize_bicubic(img, oh, ow), want)


def _hf(**kw):
    from transformers import CLIPImageProcessor

    return CLIPImageProcessor(**kw)


def _hf_pixels(proc, img) -> np.ndarray:
    return proc(images=img, return_tensors="pt")["pixel_values"].numpy()


@pytest.mark.parametrize("h,w", [(720, 1280), (224, 224), (100, 50), (5, 7), (1000, 2040),
                                 (17, 999), (999, 17), (2, 300), (480, 640), (223, 225)])
def test_pixel_values_match_transformers(h, w):
    """JAX's fallback settings (shortest edge and crop 224, OpenAI CLIP
    mean / std, bicubic) and transformers' defaults, which are the same."""
    img = _image(h + 31 * w, h, w)
    want = _hf_pixels(_hf(size={"shortest_edge": 224},
                          crop_size={"height": 224, "width": 224}), img)
    got = tip.CLIPImageProcessor(224, 224)(img)
    assert got.dtype == np.float32 and got.shape == (1, 3, 224, 224)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tip.CLIPImageProcessor()(img), _hf_pixels(_hf(), img))


CONFIGS = [
    dict(size={"shortest_edge": 336}, crop_size={"height": 336, "width": 336}),
    dict(size={"shortest_edge": 256}, crop_size={"height": 224, "width": 224}),
    dict(size={"shortest_edge": 200}, crop_size={"height": 224, "width": 240}),  # pads
    dict(size={"height": 230, "width": 190}, crop_size={"height": 224, "width": 180}),
    dict(size=56, crop_size=56, image_mean=[0.5, 0.5, 0.5], image_std=[0.5, 0.5, 0.5]),
    dict(size=64, crop_size=48, do_center_crop=True, rescale_factor=0.5 / 255),
    dict(size=64, do_center_crop=False),
    dict(do_resize=False, crop_size=32),
    dict(size=40, crop_size=40, do_normalize=False),
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_preprocessor_config_files(tmp_path, i):
    """preprocessor_config.json written by transformers' save_pretrained,
    read by from_dir, other sizes and settings; a missing file gives the
    fallback at the tower's image_size."""
    from transformers import CLIPImageProcessor

    hf = _hf(**CONFIGS[i])
    hf.save_pretrained(str(tmp_path))
    hf = CLIPImageProcessor.from_pretrained(str(tmp_path))
    port = tip.CLIPImageProcessor.from_dir(str(tmp_path), image_size=999)
    for h, w in ((720, 1280), (61, 45), (300, 300)):
        img = _image(i * 100 + h, h, w)
        np.testing.assert_array_equal(port(img), _hf_pixels(hf, img))
    os.remove(tmp_path / "preprocessor_config.json")
    fallback = tip.CLIPImageProcessor.from_dir(str(tmp_path), image_size=56)
    img = _image(i, 90, 70)
    np.testing.assert_array_equal(
        fallback(img),
        _hf_pixels(_hf(size={"shortest_edge": 56}, crop_size={"height": 56, "width": 56}), img))


def test_old_int_sizes_and_a_batch(tmp_path):
    """An old config with int size / crop_size; a list of images is one batch."""
    with open(tmp_path / "preprocessor_config.json", "w") as f:
        json.dump({"size": 48, "crop_size": 40, "resample": 3,
                   "image_mean": list(tip.OPENAI_CLIP_MEAN),
                   "image_std": list(tip.OPENAI_CLIP_STD)}, f)
    from transformers import CLIPImageProcessor

    hf = CLIPImageProcessor.from_pretrained(str(tmp_path))
    port = tip.CLIPImageProcessor.from_dir(str(tmp_path), 224)
    imgs = [_image(1, 50, 80), _image(2, 120, 33)]
    want = hf(images=imgs, return_tensors="pt")["pixel_values"].numpy()
    np.testing.assert_array_equal(port(imgs), want)


@settings(max_examples=40, derandomize=True, deadline=None)
@given(h=st.integers(2, 400).filter(lambda v: v != 3), w=st.integers(2, 400).filter(lambda v: v != 3),
       size=st.integers(8, 300), crop=st.integers(4, 300), seed=st.integers(0, 2**16))
def test_pixel_values_sweep(h, w, size, crop, seed):
    """Random sides (3 is left out: transformers reads an (H, W, 3) image
    with H == 3 as channels first), short sides and crops."""
    img = _image(seed, h, w)
    want = _hf_pixels(_hf(size={"shortest_edge": size}, crop_size={"height": crop, "width": crop}),
                      img)
    np.testing.assert_array_equal(tip.CLIPImageProcessor(size, crop)(img), want)


def test_runs_without_pil(monkeypatch):
    """With PIL hidden the module imports and gives the same bits."""
    img = _image(5, 333, 517)
    want = _hf_pixels(_hf(), img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    mod = importlib.reload(tip)
    try:
        np.testing.assert_array_equal(mod.CLIPImageProcessor()(img), want)
    finally:
        monkeypatch.undo()
        importlib.reload(tip)


@pytest.mark.parametrize("resample,name", [(2, "BILINEAR"), (1, "LANCZOS"), (0, "NEAREST")])
def test_other_resample_raises(resample, name):
    with pytest.raises(NotImplementedError, match=name):
        tip.CLIPImageProcessor(resample=resample)


def test_bad_images_raise():
    with pytest.raises(ValueError, match="uint8"):
        tip.CLIPImageProcessor()(np.zeros((10, 10, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tip.CLIPImageProcessor()(np.zeros((10, 10, 4), np.uint8))
