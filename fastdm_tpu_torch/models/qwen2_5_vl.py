"""Qwen2.5-VL, the prompt encoder of Qwen-Image and Qwen-Image-Edit, in plain
PyTorch: transformers' Qwen2_5_VLTextModel with its 3-D M-RoPE positions
(get_rope_index) and Qwen2_5_VisionTransformerPretrainedModel, which the
JAX package runs in torch f32 on the host
(fastdm_tpu/pipeline/text_encoder.py:234-333, AutoModelForVision2Seq, or
AutoModelForCausalLM for a plain qwen2 text_encoder/).

The module's attribute names are the published checkpoint's
(model.embed_tokens / model.layers.* / model.norm / visual.*), so its
state_dict is that layout; qwen2_5_vl_load also reads transformers' newer
model.language_model.* / model.visual.* one, and leaves lm_head.weight
unread (the encoder returns hidden states, never logits). The forward is
the port's own, in the parameters' dtype (f32, as the reference), and
launches no kernel of the port:

  * language model -- the token embedding with the image-token rows
    replaced in order by the vision tower's output (masked_scatter);
    RMSNorm with an f32 variance; GQA attention with biased q / k / v and
    an unbiased o, under a causal plus key-padding mask added as
    finfo.min (never -inf, so a row that sees no key stays finite:
    uniform weights, as transformers' eager mask gives); M-RoPE (cos / sin
    cut into mrope_section * 2 chunks, chunk i from axis i % 3), or 1-D
    RoPE on arange positions for a plain qwen2 config; the SwiGLU MLP;
    the final norm. The output is the normed last hidden state
    (transformers' hidden_states[-1]).
  * attention -- F.scaled_dot_product_attention with the additive mask
    (on the card its memory-efficient f32 kernel: no (keys x keys) score
    matrix, so an image at the processor's 12.8 MP limit fits), the key /
    value heads repeated for GQA.
  * get_rope_index -- transformers' (t, h, w) positions: text-only rows
    cumsum(mask) - 1 with padding at 1; an image's tokens at t 0 and its
    merged (h, w) grid, offset past the text before it; text after an
    image from that image's maximum + 1.
  * vision tower -- the (2, 14, 14) Conv3d patch embedding as a matmul on
    the processor's (N, 3 * 2 * 14 * 14) rows; the 2-D rotary table of
    rot_pos_emb (h / w positions in 2 x 2 merge blocks); tokens and rotary
    rows reordered by get_window_index (windows of window_size / patch /
    merge merged units, edge windows smaller, empty ones dropped); blocks of
    RMSNorm, biased qkv / proj attention within each window (each whole
    image on fullatt_block_indexes) and the biased SiLU MLP; the merger
    (ln_q, four rows to one, Linear, exact GELU, Linear) and the inverse
    reorder. transformers' eager path splits by cu_seqlens and loops; here
    the windows are padded to the longest and run as one batched
    attention, the padded keys masked with finfo.min.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Qwen2_5_VisionConfig:
    """transformers' Qwen2_5_VLVisionConfig fields the tower reads
    (Qwen2.5-VL-7B-Instruct's)."""
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    hidden_act: str = "silu"

    @classmethod
    def from_json(cls, cj: dict) -> "Qwen2_5_VisionConfig":
        cj = dict(cj)
        if "in_chans" in cj and "in_channels" not in cj:  # the published config's name
            cj["in_channels"] = cj["in_chans"]
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cj.items() if k in names and v is not None}
        if "fullatt_block_indexes" in kw:
            kw["fullatt_block_indexes"] = tuple(kw["fullatt_block_indexes"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class Qwen2_5_VLConfig:
    """The text tower's fields (Qwen2.5-VL-7B-Instruct's, Qwen-Image's
    text_encoder/) and the optional vision tower. mrope_section None is a
    plain qwen2 text config: 1-D RoPE on arange positions."""
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_section: Optional[Tuple[int, ...]] = (16, 24, 24)
    hidden_act: str = "silu"
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    vision: Optional[Qwen2_5_VisionConfig] = Qwen2_5_VisionConfig()

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, cj: dict) -> "Qwen2_5_VLConfig":
        """A config.json in transformers' nested form (text_config,
        vision_config), the published flat one (the text fields at the top,
        vision_config nested), or a plain qwen2 one (no vision_config, no
        mrope_section)."""
        text = dict(cj.get("text_config") or cj)
        names = {f.name for f in dataclasses.fields(cls)} - {"mrope_section", "vision"}
        kw = {k: v for k, v in text.items() if k in names and v is not None}
        for k in ("image_token_id", "video_token_id", "vision_start_token_id",
                  "vision_end_token_id"):
            if cj.get(k) is not None:
                kw[k] = cj[k]
        rope = text.get("rope_scaling") or {}
        section = rope.get("mrope_section")
        kind = rope.get("rope_type", rope.get("type", "default"))
        if kind not in ("default", "mrope"):
            raise NotImplementedError(f"Qwen2.5-VL rope_scaling type {kind!r} is not supported")
        vision = cj.get("vision_config")
        return cls(**kw, mrope_section=tuple(section) if section else None,
                   vision=Qwen2_5_VisionConfig.from_json(vision) if vision else None)

    @classmethod
    def from_dir(cls, path: str) -> "Qwen2_5_VLConfig":
        with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
            return cls.from_json(json.load(f))

    def to_json(self) -> dict:
        """The config.json transformers reads back: Qwen2.5-VL's flat
        published form."""
        if self.vision is None or self.mrope_section is None:
            raise ValueError("only a Qwen2.5-VL config (a vision tower, mrope_section) is "
                             "written")
        text = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in ("mrope_section", "vision")}
        text.update(max_position_embeddings=128000, tie_word_embeddings=False,
                    torch_dtype="float32", use_sliding_window=False)
        vision = dataclasses.asdict(self.vision)
        vision["fullatt_block_indexes"] = list(self.vision.fullatt_block_indexes)
        return dict(text, model_type="qwen2_5_vl",
                    architectures=["Qwen2_5_VLForConditionalGeneration"],
                    rope_scaling={"type": "mrope", "mrope_section": list(self.mrope_section)},
                    vision_config=dict(vision, model_type="qwen2_5_vl"))


# ---------------------------------------------------------------- modules


class _RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.eps = eps


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int, bias: bool):
        super().__init__()
        self.gate_proj, self.up_proj = nn.Linear(d, inner, bias), nn.Linear(d, inner, bias)
        self.down_proj = nn.Linear(inner, d, bias)


class _Attention(nn.Module):
    def __init__(self, cfg: Qwen2_5_VLConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * hd)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * hd)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, bias=False)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2_5_VLConfig):
        super().__init__()
        self.self_attn = _Attention(cfg)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class _TextModel(nn.Module):
    def __init__(self, cfg: Qwen2_5_VLConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(_DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = _RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class _PatchEmbed(nn.Module):
    def __init__(self, v: Qwen2_5_VisionConfig):
        super().__init__()
        k = (v.temporal_patch_size, v.patch_size, v.patch_size)
        self.proj = nn.Conv3d(v.in_channels, v.hidden_size, k, k, bias=False)


class _VisionAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)


class _VisionBlock(nn.Module):
    def __init__(self, v: Qwen2_5_VisionConfig):
        super().__init__()
        self.norm1, self.norm2 = _RMSNorm(v.hidden_size, 1e-6), _RMSNorm(v.hidden_size, 1e-6)
        self.attn = _VisionAttention(v.hidden_size)
        self.mlp = _MLP(v.hidden_size, v.intermediate_size, bias=True)


class _Merger(nn.Module):
    def __init__(self, v: Qwen2_5_VisionConfig):
        super().__init__()
        wide = v.hidden_size * v.spatial_merge_size ** 2
        self.ln_q = _RMSNorm(v.hidden_size, 1e-6)
        self.mlp = nn.Sequential(nn.Linear(wide, wide), nn.GELU(),
                                 nn.Linear(wide, v.out_hidden_size))


class _Vision(nn.Module):
    def __init__(self, v: Qwen2_5_VisionConfig):
        super().__init__()
        self.patch_embed = _PatchEmbed(v)
        self.blocks = nn.ModuleList(_VisionBlock(v) for _ in range(v.depth))
        self.merger = _Merger(v)


class Qwen2_5_VLModel(nn.Module):
    """The parameters of Qwen2_5_VLForConditionalGeneration without lm_head
    (or of Qwen2ForCausalLM's model when cfg.vision is None); the forward
    is qwen2_5_vl_forward()."""

    def __init__(self, cfg: Qwen2_5_VLConfig):
        super().__init__()
        for name, act in (("text", cfg.hidden_act),
                          ("vision", cfg.vision and cfg.vision.hidden_act)):
            if act not in ("silu", None):
                raise NotImplementedError(f"Qwen2.5-VL {name} hidden_act {act!r} (silu only)")
        self.cfg = cfg
        self.model = _TextModel(cfg)
        if cfg.vision is not None:
            self.visual = _Vision(cfg.vision)

    def forward(self, input_ids, attention_mask=None, pixel_values=None,
                image_grid_thw=None) -> Tensor:
        return qwen2_5_vl_forward(self, input_ids, attention_mask, pixel_values, image_grid_thw)


# ---------------------------------------------------------------- forward


def _rms(norm: _RMSNorm, x: Tensor) -> Tensor:
    """Qwen2RMSNorm: the variance in f32, the weight applied in x's dtype."""
    h = x.float()
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + norm.eps)
    return norm.weight * h.to(x.dtype)


def _rotate_half(x: Tensor) -> Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _swiglu(mlp: _MLP, x: Tensor) -> Tensor:
    return mlp.down_proj(F.silu(mlp.gate_proj(x)) * mlp.up_proj(x))


def text_rope(cfg: Qwen2_5_VLConfig, position_ids: Tensor, device) -> Tuple[Tensor, Tensor]:
    """(cos, sin) of shape (B, 1, S, head_dim) in f32 for (3, B, S) M-RoPE
    positions (chunk i of mrope_section * 2 from axis i % 3) or (B, S) 1-D
    positions."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.int64, device=device).float() / hd))
    freqs = position_ids.to(device).float()[..., None] * inv_freq
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos(), emb.sin()
    if cfg.mrope_section is not None:
        sec = list(cfg.mrope_section) * 2
        cos = torch.cat([m[i % 3] for i, m in enumerate(cos.split(sec, dim=-1))], dim=-1)
        sin = torch.cat([m[i % 3] for i, m in enumerate(sin.split(sec, dim=-1))], dim=-1)
    return cos[:, None], sin[:, None]


def _attention_mask(mask: Optional[Tensor], b: int, s: int, dtype, device) -> Tensor:
    """(B, 1, S, S) additive mask: 0 where key k <= query q and k is not
    padding, finfo.min elsewhere."""
    keep = torch.ones(s, s, dtype=torch.bool, device=device).tril()[None, None]
    if mask is not None:
        keep = keep & mask.to(device=device, dtype=torch.bool)[:, None, None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(keep, zero, torch.finfo(dtype).min).expand(b, 1, s, s)


def _decoder_layer(layer: _DecoderLayer, cfg: Qwen2_5_VLConfig, x: Tensor, mask: Tensor,
                   cos: Tensor, sin: Tensor) -> Tensor:
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    att = layer.self_attn
    h = _rms(layer.input_layernorm, x)
    q = att.q_proj(h).view(b, s, nh, hd).transpose(1, 2)
    k = att.k_proj(h).view(b, s, nkv, hd).transpose(1, 2)
    v = att.v_proj(h).view(b, s, nkv, hd).transpose(1, 2)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    # grouped-query attention: query heads j*g .. j*g+g-1 read key / value head j
    k, v = (t.repeat_interleave(nh // nkv, dim=1) for t in (k, v))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    x = x + att.o_proj(o.transpose(1, 2).reshape(b, s, nh * hd))
    return x + _swiglu(layer.mlp, _rms(layer.post_attention_layernorm, x))


def qwen2_5_vl_text_forward(model: Qwen2_5_VLModel, inputs_embeds: Tensor,
                            attention_mask: Optional[Tensor], position_ids: Tensor) -> Tensor:
    """(B, S, D) input embeddings -> the normed last hidden state (B, S, D).
    position_ids: (3, B, S) M-RoPE positions, or (B, S) for a plain qwen2
    config."""
    cfg, tm = model.cfg, model.model
    x = inputs_embeds
    b, s, _ = x.shape
    cos, sin = text_rope(cfg, position_ids, x.device)
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    mask = _attention_mask(attention_mask, b, s, x.dtype, x.device)
    for layer in tm.layers:
        x = _decoder_layer(layer, cfg, x, mask, cos, sin)
    return _rms(tm.norm, x)


def qwen2_5_vl_forward(model: Qwen2_5_VLModel, input_ids, attention_mask=None,
                       pixel_values: Optional[Tensor] = None, image_grid_thw=None) -> Tensor:
    """(B, S) ids (with image_grid_thw's images behind their <|image_pad|>
    tokens) -> the normed last hidden state (B, S, D), on the model's
    device in its dtype."""
    cfg = model.cfg
    emb = model.model.embed_tokens.weight
    ids = torch.as_tensor(input_ids).to(emb.device)
    mask = None if attention_mask is None else torch.as_tensor(attention_mask).to(emb.device)
    x = model.model.embed_tokens(ids)
    grid = None
    if pixel_values is not None:
        if cfg.vision is None:
            raise ValueError("pixel_values given to a Qwen2.5-VL model without a vision tower")
        grid = np.asarray(torch.as_tensor(image_grid_thw).cpu(), np.int64).reshape(-1, 3)
        image = qwen2_5_vl_vision_forward(model, torch.as_tensor(pixel_values), grid)
        where = ids == cfg.image_token_id
        if int(where.sum()) != image.shape[0]:
            raise ValueError(f"Image features and image tokens do not match: tokens "
                             f"{int(where.sum())}, features {image.shape[0]}")
        x = x.masked_scatter(where[..., None].expand_as(x), image.to(x.dtype))
    if cfg.mrope_section is not None:
        pos = get_rope_index(cfg, ids, grid, mask)
    else:
        pos = torch.arange(ids.shape[1]).expand(ids.shape)
    return qwen2_5_vl_text_forward(model, x, mask, pos)


def get_rope_index(cfg: Qwen2_5_VLConfig, input_ids, image_grid_thw=None,
                   attention_mask=None) -> Tensor:
    """transformers' Qwen2_5_VLModel.get_rope_index for text and images
    (int64 (3, B, S) on the CPU). Without images: cumsum(mask) - 1 with the
    padding at 1 (arange without a mask), the same on all three axes. With
    images, per row over its unmasked tokens: the text before an image
    continues from the last maximum + 1; the image's grid_t x (grid_h / m)
    x (grid_w / m) tokens (after each <|vision_start|><|image_pad|>) take t
    0 and their (h, w) indices, all offset by that text's end; padding 1."""
    ids = np.asarray(torch.as_tensor(input_ids).cpu(), np.int64)
    b, s = ids.shape
    mask = None if attention_mask is None else \
        np.asarray(torch.as_tensor(attention_mask).cpu(), np.int64)
    if image_grid_thw is None:
        if mask is None:
            return torch.arange(s).expand(3, b, s).clone()
        pos = np.cumsum(mask, -1) - 1
        pos[mask == 0] = 1
        return torch.from_numpy(np.broadcast_to(pos, (3, b, s)).copy())
    grid = np.asarray(torch.as_tensor(image_grid_thw).cpu(), np.int64).reshape(-1, 3)
    m = cfg.vision.spatial_merge_size
    out = np.ones((3, b, s), np.int64)
    image = 0
    for i in range(b):
        keep = mask[i] == 1 if mask is not None else np.ones(s, bool)
        row = ids[i][keep]
        starts = np.nonzero(row == cfg.vision_start_token_id)[0]
        n_images = int((row[starts[starts + 1 < len(row)] + 1] == cfg.image_token_id).sum())
        tokens = row.tolist()
        parts: List[np.ndarray] = []
        st = 0
        for _ in range(n_images):
            ed = tokens.index(cfg.image_token_id, st)
            t, h, w = (int(v) for v in grid[image])
            image += 1
            gt, gh, gw = t, h // m, w // m
            st_idx = int(parts[-1].max()) + 1 if parts else 0
            parts.append(np.broadcast_to(np.arange(ed - st), (3, ed - st)) + st_idx)
            t_index = np.repeat(np.arange(gt) * 0, gh * gw)  # images: t index 0
            h_index = np.tile(np.repeat(np.arange(gh), gw), gt)
            w_index = np.tile(np.arange(gw), gt * gh)
            parts.append(np.stack([t_index, h_index, w_index]) + (ed - st) + st_idx)
            st = ed + gt * gh * gw
        if st < len(tokens):
            st_idx = int(parts[-1].max()) + 1 if parts else 0
            parts.append(np.broadcast_to(np.arange(len(tokens) - st), (3, len(tokens) - st))
                         + st_idx)
        out[:, i, keep] = np.concatenate(parts, axis=1)
    return torch.from_numpy(out)


# ---------------------------------------------------------------- vision


def vision_rot_pos(v: Qwen2_5_VisionConfig, grid: np.ndarray) -> Tensor:
    """rot_pos_emb: (N, head_dim / 2) f32 rotary angles, each patch's h then
    w position (patches in 2 x 2 merge blocks, raster order of the blocks)
    times the 10000-base frequencies of head_dim / 2."""
    m = v.spatial_merge_size
    pos = []
    for t, h, w in grid.tolist():
        hpos = np.arange(h)[:, None].repeat(w, 1).reshape(h // m, m, w // m, m)
        wpos = np.arange(w)[None, :].repeat(h, 0).reshape(h // m, m, w // m, m)
        hw = np.stack([hpos.transpose(0, 2, 1, 3).ravel(), wpos.transpose(0, 2, 1, 3).ravel()], -1)
        pos.append(np.tile(hw, (t, 1)))
    pos = torch.from_numpy(np.concatenate(pos))
    dim = v.hidden_size // v.num_heads // 2
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float) / dim))
    table = torch.outer(torch.arange(int(grid[:, 1:].max()), dtype=torch.float), inv_freq)
    return table[pos].flatten(1)


def vision_window_index(v: Qwen2_5_VisionConfig, grid: np.ndarray) -> Tuple[np.ndarray, List[int]]:
    """get_window_index: the merged units' order window by window (windows
    of window_size / patch_size / spatial_merge_size units on a side, edge
    windows smaller), and the cumulative patch counts at each window's end
    from 0 (empty windows repeat a count)."""
    m, unit = v.spatial_merge_size, v.spatial_merge_size ** 2
    ws = v.window_size // m // v.patch_size
    index, cu, offset = [], [0], 0
    for t, h, w in grid.tolist():
        gh, gw = h // m, w // m
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        ph, pw = ws - gh % ws, ws - gw % ws
        nh, nw = (gh + ph) // ws, (gw + pw) // ws
        padded = np.pad(idx, ((0, 0), (0, ph), (0, pw)), constant_values=-100)
        padded = padded.reshape(t, nh, ws, nw, ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nh * nw, ws, ws)
        seqlens = (padded != -100).sum((2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        index.append(flat[flat != -100] + offset)
        cu.extend((np.cumsum(seqlens) * unit + cu[-1]).tolist())
        offset += t * gh * gw
    return np.concatenate(index), cu


class _Segments:
    """Contiguous runs of tokens (cu_seqlens) padded to the longest: the
    gather index (n, L), the valid slots (n, L) and an additive key mask (n,
    1, 1, L) with finfo.min on the padding."""

    def __init__(self, cu: Sequence[int], device, dtype):
        cu = np.unique(np.asarray(cu, np.int64))  # unique_consecutive of a sorted list
        lens = np.diff(cu)
        span = int(lens.max())
        slot = np.arange(span)[None]
        valid = slot < lens[:, None]
        self.index = torch.from_numpy(np.where(valid, cu[:-1, None] + slot, 0)).to(device)
        self.valid = torch.from_numpy(valid).to(device)
        zero = torch.zeros((), dtype=dtype, device=device)
        self.key_mask = torch.where(self.valid, zero, torch.finfo(dtype).min)[:, None, None]


def _vision_attention(att: _VisionAttention, x: Tensor, seg: _Segments, heads: int,
                      cos: Tensor, sin: Tensor) -> Tensor:
    n, d = x.shape
    hd = d // heads
    q, k, v = att.qkv(x).reshape(n, 3, heads, hd).unbind(1)
    # apply_rotary_pos_emb_vision: in f32, back to the input dtype
    q = (q.float() * cos + _rotate_half(q.float()) * sin).to(x.dtype)
    k = (k.float() * cos + _rotate_half(k.float()) * sin).to(x.dtype)
    q, k, v = (t[seg.index].permute(0, 2, 1, 3) for t in (q, k, v))  # (windows, heads, L, hd)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=seg.key_mask)
    return att.proj(o.permute(0, 2, 1, 3)[seg.valid].reshape(n, d))  # valid: (n, heads, hd)


def qwen2_5_vl_vision_forward(model: Qwen2_5_VLModel, pixel_values: Tensor,
                              grid: np.ndarray) -> Tensor:
    """(N, C * T * P * P) processor rows of the images in `grid` ((n, 3)
    t, h, w patches each) -> (N / merge**2, out_hidden_size) tokens in
    raster order of the merged units, in the parameters' dtype."""
    vm, v = model.visual, model.cfg.vision
    grid = np.asarray(grid, np.int64).reshape(-1, 3)
    w = vm.patch_embed.proj.weight
    x = pixel_values.to(device=w.device, dtype=w.dtype)
    n = x.shape[0]
    if n != int(grid.prod(-1).sum()) or x.shape[1] != w[0].numel():
        raise ValueError(f"pixel_values {tuple(x.shape)} do not match image_grid_thw "
                         f"{grid.tolist()} and {w[0].numel()} values a patch")
    x = x @ w.reshape(w.shape[0], -1).t()  # the stride-sized Conv3d
    unit = v.spatial_merge_size ** 2
    window_index, cu_window = vision_window_index(v, grid)
    order = torch.from_numpy(window_index).to(x.device)
    x = x.reshape(n // unit, unit, -1)[order].reshape(n, -1)
    rot = vision_rot_pos(v, grid).to(x.device)
    rot = rot.reshape(n // unit, unit, -1)[order].reshape(n, -1)
    emb = torch.cat((rot, rot), dim=-1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    full = _Segments(np.concatenate([[0], np.cumsum(np.repeat(grid[:, 1] * grid[:, 2],
                                                             grid[:, 0]))]), x.device, x.dtype)
    windows = _Segments(cu_window, x.device, x.dtype)
    for i, blk in enumerate(vm.blocks):
        seg = full if i in v.fullatt_block_indexes else windows
        x = x + _vision_attention(blk.attn, _rms(blk.norm1, x), seg, v.num_heads, cos, sin)
        x = x + _swiglu(blk.mlp, _rms(blk.norm2, x))
    mg = vm.merger
    x = mg.mlp(_rms(mg.ln_q, x).view(-1, mg.mlp[0].in_features))
    return x[torch.argsort(order)]


# ---------------------------------------------------------------- params

# transformers' newer layout (Qwen2_5_VLForConditionalGeneration since 4.52)
_NEW_PREFIXES = (("model.", "model.language_model."), ("visual.", "model.visual."))
_LM_HEAD = "lm_head.weight"


def qwen2_5_vl_load(src: TensorSource, cfg: Qwen2_5_VLConfig) -> Qwen2_5_VLModel:
    """The encoder from a text_encoder/ checkpoint (one file or shards) onto
    src's device in f32 (the reference's torch_dtype), from the published
    model.* / visual.* keys or transformers' model.language_model.* /
    model.visual.* ones. lm_head.weight is left unread; a missing or
    any other unclaimed tensor raises."""
    with torch.device("meta"):
        model = Qwen2_5_VLModel(cfg)
    names = src.names()
    new = any(k.startswith(("model.language_model.", "model.visual.")) for k in names)

    def key(k: str) -> str:
        if new:
            for old, cur in _NEW_PREFIXES:
                if k.startswith(old):
                    return cur + k[len(old):]
        return k

    sd = {k: src.tensor(key(k), torch.float32) for k in model.state_dict()}
    if _LM_HEAD in src:
        src.take(_LM_HEAD)
    src.assert_consumed()
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()


def qwen2_5_vl_init_random(seed: int, cfg: Qwen2_5_VLConfig, device="cuda") -> Qwen2_5_VLModel:
    """Random f32 weights from a torch.Generator seeded with `seed`, drawn on
    `device` (smoke runs): linears and the patch embedding N(0, 1/fan_in),
    biases N(0, 0.02²), the token embedding N(0, 1), RMSNorm weights
    1 + N(0, 0.1²)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        model = Qwen2_5_VLModel(cfg)
    sd = {}
    for k, p in model.state_dict().items():
        t = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
        if "norm" in k or k.endswith("ln_q.weight"):
            t = 1.0 + 0.1 * t
        elif k.endswith("patch_embed.proj.weight"):
            t = t * p[0].numel() ** -0.5
        elif not k.endswith("embed_tokens.weight"):
            t = t * (p.shape[-1] ** -0.5 if k.endswith("weight") else 0.02)
        sd[k] = t
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()
