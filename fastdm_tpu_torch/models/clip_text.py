"""CLIP's text tower: transformers' CLIPTextModel and
CLIPTextModelWithProjection in plain PyTorch (the JAX package runs those
transformers modules in torch f32, fastdm_tpu/pipeline/text_encoder.py:44-49,
93-99, 138-144).

The module's attribute names are the checkpoint's, so a diffusers
text_encoder*/ directory (model.safetensors + config.json, as transformers'
save_pretrained writes it) loads with load_state_dict and writes back with
state_dict. The forward is the port's own: token + position embeddings, a
causal additive mask (no padding mask: the reference passes none), pre-LN
layers with quick_gelu (CLIP-L) or gelu (bigG) MLPs, the final LayerNorm;
the pooled token is the argmax of the ids when eos_token_id == 2 (the
legacy configs), else the first position holding eos_token_id; the
projection has no bias. `penultimate` is hidden_states[-2], the input of
the last layer, without the final LayerNorm (SDXL's and SD3's per-token
embeddings).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """transformers' CLIPTextConfig fields the forward reads (CLIP-L's defaults)."""
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 2
    projection_dim: int = 768

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTextConfig":
        with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
            cj = json.load(f)
        cj = cj.get("text_config", cj)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cj.items() if k in names and v is not None})

    def to_json(self) -> dict:
        """The config.json transformers reads back for this config."""
        return dict(dataclasses.asdict(self), model_type="clip_text_model",
                    architectures=["CLIPTextModel"], bos_token_id=0, pad_token_id=1,
                    torch_dtype="float32")


class CLIPTextOutput(NamedTuple):
    last_hidden_state: Tensor      # (B, S, D) after the final LayerNorm
    pooler_output: Tensor          # (B, D)
    penultimate: Tensor            # (B, S, D), hidden_states[-2]
    text_embeds: Optional[Tensor]  # (B, projection_dim) with the projection


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = _Attention(d)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(d, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_hidden_layers))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """The parameters of CLIPTextModel (projection=False) or
    CLIPTextModelWithProjection; the forward is clip_text_forward()."""

    def __init__(self, cfg: CLIPTextConfig, projection: bool = False):
        super().__init__()
        self.cfg, self.projection = cfg, projection
        self.text_model = _TextTransformer(cfg)
        if projection:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: Tensor) -> CLIPTextOutput:
        return clip_text_forward(self, input_ids)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise NotImplementedError(f"CLIP hidden_act {name!r} is not supported (quick_gelu, gelu)")


def _layer_forward(layer: _Layer, x: Tensor, mask: Optional[Tensor], heads: int, act) -> Tensor:
    """One pre-LN encoder layer; `mask` is added to the scaled scores (the
    text tower's causal mask; None for the vision tower)."""
    b, s, d = x.shape
    hd = d // heads
    h = layer.layer_norm1(x)
    att = layer.self_attn

    def split(t):
        return t.view(b, s, heads, hd).transpose(1, 2)

    q, k, v = split(att.q_proj(h)), split(att.k_proj(h)), split(att.v_proj(h))
    w = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        w = w + mask
    w = torch.softmax(w, dim=-1, dtype=torch.float32).to(q.dtype)
    o = torch.matmul(w, v).transpose(1, 2).reshape(b, s, d)
    x = x + att.out_proj(o)
    h = layer.layer_norm2(x)
    return x + layer.mlp.fc2(act(layer.mlp.fc1(h)))


def clip_text_forward(model: CLIPTextModel, input_ids: Tensor) -> CLIPTextOutput:
    """(B, S) int ids -> CLIPTextOutput, in the parameters' dtype."""
    cfg, tm = model.cfg, model.text_model
    ids = input_ids.to(model.text_model.embeddings.token_embedding.weight.device)
    b, s = ids.shape
    emb = tm.embeddings
    pos = torch.arange(s, device=ids.device)
    x = emb.token_embedding(ids) + emb.position_embedding(pos)[None]
    mask = torch.full((s, s), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)
    mask = torch.triu(mask, diagonal=1)[None, None]
    act = _act(cfg.hidden_act)
    penultimate = x
    for i, layer in enumerate(tm.encoder.layers):
        if i == len(tm.encoder.layers) - 1:
            penultimate = x
        x = _layer_forward(layer, x, mask, cfg.num_attention_heads, act)
    last = tm.final_layer_norm(x)
    ids32 = ids.to(torch.int)
    eos_pos = ids32.argmax(dim=-1) if cfg.eos_token_id == 2 else \
        (ids32 == cfg.eos_token_id).int().argmax(dim=-1)
    pooled = last[torch.arange(b, device=x.device), eos_pos]
    text_embeds = model.text_projection(pooled) if model.projection else None
    return CLIPTextOutput(last, pooled, penultimate, text_embeds)


# ---------------------------------------------------------------- params

# keys a checkpoint may hold that the forward does not read: the position
# ids buffer of older transformers versions
_IGNORED = ("text_model.embeddings.position_ids",)


def clip_text_load(src: TensorSource, cfg: CLIPTextConfig, projection: bool) -> CLIPTextModel:
    """A CLIP text tower from a text_encoder*/ checkpoint onto src's device
    in f32 (the reference's torch_dtype). A projection in the
    checkpoint of a CLIPTextModel is left unread, as transformers leaves it;
    any other unclaimed tensor raises."""
    with torch.device("meta"):
        model = CLIPTextModel(cfg, projection)
    sd = {k: src.tensor(k, torch.float32) for k in model.state_dict()}
    for k in _IGNORED + (() if projection else ("text_projection.weight",)):
        if k in src:
            src.take(k)
    src.assert_consumed()
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()


def clip_text_init_random(seed: int, cfg: CLIPTextConfig, projection: bool,
                          device="cuda") -> CLIPTextModel:
    """Random f32 weights from a torch.Generator seeded with `seed`, drawn on
    `device` (smoke runs): linears N(0, 1/fan_in), biases N(0, 0.02²),
    embeddings N(0, 1), LayerNorm weights 1 + N(0, 0.1²), biases 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        model = CLIPTextModel(cfg, projection)
    sd = {}
    for k, p in model.state_dict().items():
        t = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
        if "norm" in k:
            t = 1.0 + 0.1 * t if k.endswith("weight") else torch.zeros_like(t)
        elif "embedding" not in k:
            t = t * (p.shape[-1] ** -0.5 if k.endswith("weight") else 0.02)
        sd[k] = t
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()
