"""The port's CLIP vision tower (fastdm_tpu_torch/models/clip_vision.py) and
CLIPImageEncoder (fastdm_tpu_torch/pipeline/text_encoder.py) against
transformers and the JAX package's CLIPImageEncoder, on tiny towers this file
writes with save_pretrained (patch 14, 56 px: 16 patches and the class
token):

  * CLIPVisionModelWithProjection and CLIPVisionModel, quick_gelu and gelu:
    image_embeds, pooler_output and hidden_states[-2] within relative L2
    REL_L2_TOL of transformers in f32 (transformers' SDPA attention sums in
    another order), a one-layer tower's hidden_states[-2] (pre_layrnorm's
    output) too;
  * CLIPImageEncoder against JAX's on the same directory, in bf16: equal but
    for elements one bf16 ulp apart, at most BF16_ULP_FRACTION of them, with
    num_images_per_prompt repeats;
  * a tower without visual_projection loads and gives hidden states, and its
    image_embeds raise (JAX would project through random weights); a missing
    directory raises naming it; clip_vision_init_random + save_image_encoder
    read back by transformers."""

import os
import sys

import numpy as np
import pytest
import torch

from fastdm_tpu_torch.models import clip_vision as tcv
from fastdm_tpu_torch.models.loader import TensorSource
from fastdm_tpu_torch.pipeline import text_encoder as ttext

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

REL_L2_TOL = 1e-5
# elements allowed one bf16 ulp from the JAX class's (none further)
BF16_ULP_FRACTION = 2e-3
TINY = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
            patch_size=14, image_size=56, projection_dim=24)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def write_tower(path: str, projection: bool = True, act: str = "gelu", seed: int = 0,
                layers: int = 3, **kw) -> str:
    """A tiny tower written by transformers' save_pretrained (its own init,
    LayerNorms and biases perturbed), with its preprocessor_config.json."""
    from transformers import CLIPImageProcessor, CLIPVisionConfig
    from transformers import CLIPVisionModel, CLIPVisionModelWithProjection

    cfg = CLIPVisionConfig(**dict(TINY, num_hidden_layers=layers, hidden_act=act, **kw))
    torch.manual_seed(seed)
    model = (CLIPVisionModelWithProjection if projection else CLIPVisionModel)(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    model.save_pretrained(path)
    s = cfg.image_size
    CLIPImageProcessor(size={"shortest_edge": s},
                       crop_size={"height": s, "width": s}).save_pretrained(path)
    return path


def _hf_model(path: str, projection: bool):
    from transformers import CLIPVisionModel, CLIPVisionModelWithProjection

    cls = CLIPVisionModelWithProjection if projection else CLIPVisionModel
    return cls.from_pretrained(path, torch_dtype=torch.float32).eval()


def _pixels(seed: int, b: int = 2, s: int = 56) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 3, s, s)).astype(np.float32))


@pytest.mark.parametrize("projection", [True, False])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_tower_matches_transformers(tmp_path, projection, act):
    path = write_tower(str(tmp_path), projection, act, seed=3)
    cfg = tcv.CLIPVisionConfig.from_dir(path)
    assert cfg.hidden_act == act and cfg.image_size == 56 and cfg.num_positions == 17
    port = tcv.clip_vision_load(TensorSource.from_path(path, "cpu"), cfg)
    assert port.projection == projection
    x = _pixels(1)
    with torch.no_grad():
        want = _hf_model(path, projection)(pixel_values=x, output_hidden_states=True)
    got = port(x)
    assert _rel_l2(got.penultimate, want.hidden_states[-2]) <= REL_L2_TOL
    assert _rel_l2(got.last_hidden_state, want.last_hidden_state) <= REL_L2_TOL
    if projection:
        assert _rel_l2(got.image_embeds, want.image_embeds) <= REL_L2_TOL
    else:
        assert got.image_embeds is None
        assert _rel_l2(got.pooler_output, want.pooler_output) <= REL_L2_TOL


def test_one_layer_penultimate_is_pre_layrnorm(tmp_path):
    path = write_tower(str(tmp_path), True, layers=1, seed=4)
    port = tcv.clip_vision_load(TensorSource.from_path(path, "cpu"),
                                tcv.CLIPVisionConfig.from_dir(path))
    x = _pixels(2, b=1)
    with torch.no_grad():
        want = _hf_model(path, True)(pixel_values=x, output_hidden_states=True)
    assert _rel_l2(port(x).penultimate, want.hidden_states[-2]) <= REL_L2_TOL
    with pytest.raises(ValueError, match=r"\(3, 56, 56\)"):
        port(_pixels(2, b=1, s=42))


def test_projection_flag_and_unclaimed_keys(tmp_path):
    """projection=False leaves a checkpoint's projection unread, as
    transformers' CLIPVisionModel; projection=True on a tower without one
    raises."""
    path = write_tower(str(tmp_path / "with"), True, seed=5)
    cfg = tcv.CLIPVisionConfig.from_dir(path)
    assert not tcv.clip_vision_load(TensorSource.from_path(path, "cpu"), cfg, False).projection
    bare = write_tower(str(tmp_path / "bare"), False, seed=5)
    with pytest.raises(Exception, match="visual_projection"):
        tcv.clip_vision_load(TensorSource.from_path(bare, "cpu"), cfg, True)


def _bf16_ulps(got: torch.Tensor, want) -> np.ndarray:
    import jax.numpy as jnp

    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    spacing = np.spacing(np.abs(w).astype(np.float32)) * 2.0 ** 16  # f32 -> bf16 spacing
    return np.abs(g - w) / np.maximum(spacing, np.finfo(np.float32).tiny)


@pytest.mark.parametrize("projection", [True, False])
def test_image_encoder_matches_jax(tmp_path, projection):
    """The port's CLIPImageEncoder against JAX's on one directory and a
    720x1280 frame, both outputs, num_images_per_prompt 2."""
    from fastdm_tpu.pipeline import text_encoder as jtext

    path = write_tower(str(tmp_path), projection, seed=6)
    img = np.random.default_rng(7).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    port = ttext.CLIPImageEncoder(path, device="cpu")
    jax_enc = jtext.CLIPImageEncoder(path)
    outputs = [True] + ([False] if projection else [])
    for hidden in outputs:
        got = port.encode(img, 2, hidden_states=hidden)
        want = jax_enc.encode(img, 2, hidden_states=hidden)
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert torch.equal(got[0], got[1])
        ulps = _bf16_ulps(got, want)
        assert ulps.max() <= 1.0, ulps.max()
        assert (ulps > 0).mean() <= BF16_ULP_FRACTION, (ulps > 0).mean()
    if not projection:
        with pytest.raises(ValueError, match="visual_projection.weight"):
            port.encode(img)


def test_image_encoder_is_lazy_and_names_a_missing_dir(tmp_path):
    missing = str(tmp_path / "image_encoder")
    enc = ttext.CLIPImageEncoder(missing, device="cpu")  # nothing read yet
    with pytest.raises(FileNotFoundError, match="image_encoder"):
        enc.encode(np.zeros((64, 64, 3), np.uint8))


@pytest.mark.parametrize("projection", [True, False])
def test_random_tower_writer_reads_back(tmp_path, projection):
    """clip_vision_init_random + save_image_encoder (what chip_smoke.py
    writes) read back by transformers and by the port's encoder class."""
    cfg = tcv.CLIPVisionConfig(**dict(TINY, hidden_act="quick_gelu"))
    model = tcv.clip_vision_init_random(11, cfg, projection, device="cpu")
    path = str(tmp_path / "image_encoder")
    tcv.save_image_encoder(model, path)
    hf = _hf_model(path, projection)
    assert hf.config.hidden_act == "quick_gelu"
    x = _pixels(8)
    with torch.no_grad():
        want = hf(pixel_values=x, output_hidden_states=True)
    got = model(x)
    assert _rel_l2(got.penultimate, want.hidden_states[-2]) <= REL_L2_TOL
    if projection:
        assert _rel_l2(got.image_embeds, want.image_embeds) <= REL_L2_TOL
    img = np.random.default_rng(9).integers(0, 256, (90, 160, 3), dtype=np.uint8)
    enc = ttext.CLIPImageEncoder(path, device="cpu")
    np.testing.assert_array_equal(
        enc.encode(img, hidden_states=True).float().numpy(),
        model(torch.from_numpy(enc.processor(img))).penultimate.to(torch.bfloat16).float().numpy())


def test_entry_points_default_to_the_card(tmp_path):
    """Without a GPU the new entry points raise unless the caller asks for
    the CPU: no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    cfg = tcv.CLIPVisionConfig(**TINY)
    for call in (lambda: ttext.CLIPImageEncoder(str(tmp_path)),
                 lambda: tcv.clip_vision_init_random(0, cfg, True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
