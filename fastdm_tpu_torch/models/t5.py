"""The T5 v1.1 and UMT5 encoders: transformers' T5EncoderModel and
UMT5EncoderModel in plain PyTorch (the JAX package runs those transformers
modules in torch f32, fastdm_tpu/pipeline/text_encoder.py:53-55,148-150,
212-214).

The module's attribute names are the checkpoint's (shared, encoder.block.N.
layer.0.SelfAttention.q, ...), so a text_encoder*/ directory, sharded or
not, loads with load_state_dict (the embedding under shared.weight or
encoder.embed_tokens.weight) and writes back with state_dict. The forward
is the port's own:
  * a bidirectional relative-position bias: 32 buckets, max distance 128,
    the bucket table computed on the CPU with transformers' f32 ops (its
    log decides the buckets near their edges) and cached; T5 keeps the bias
    in block 0 and reuses it, UMT5 has one per block;
  * attention without the 1/sqrt(d) scale, softmax in f32; a padding mask,
    where one is given, added to the bias as finfo.min;
  * T5LayerNorm: RMS with an f32 variance, eps 1e-6, no bias;
  * the gated gelu_new (tanh) FFN: wo(gelu_new(wi_0 x) * wi_1 x);
  * the final T5LayerNorm.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from functools import lru_cache
from typing import Optional

import torch
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class T5Config:
    """transformers' T5Config / UMT5Config fields the encoder reads
    (T5-v1.1-XXL's defaults)."""
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    umt5: bool = False  # one relative-position bias per block

    @classmethod
    def from_dir(cls, path: str) -> "T5Config":
        with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
            cj = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cj.items() if k in names and v is not None}
        return cls(umt5=cj.get("model_type") == "umt5", **kw)

    def to_json(self) -> dict:
        """The config.json transformers reads back for this config."""
        out = dataclasses.asdict(self)
        umt5 = out.pop("umt5")
        return dict(out, model_type="umt5" if umt5 else "t5", is_encoder_decoder=True,
                    architectures=["UMT5EncoderModel" if umt5 else "T5EncoderModel"],
                    pad_token_id=0, eos_token_id=1, decoder_start_token_id=0,
                    num_decoder_layers=self.num_layers, tie_word_embeddings=False,
                    torch_dtype="float32")


class _RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class _Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _Attention(cfg, has_bias)
        self.layer_norm = _RMSNorm(cfg.d_model)


class _GatedFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _GatedFF(cfg)
        self.layer_norm = _RMSNorm(cfg.d_model)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias), _FFLayer(cfg)])


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(_Block(cfg, cfg.umt5 or i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = _RMSNorm(cfg.d_model)


class T5Encoder(nn.Module):
    """The parameters of T5EncoderModel / UMT5EncoderModel (cfg.umt5); the
    forward is t5_encoder_forward()."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.feed_forward_proj != "gated-gelu":
            raise NotImplementedError(f"feed_forward_proj {cfg.feed_forward_proj!r}: the port "
                                      "has T5 v1.1's and UMT5's gated-gelu")
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        return t5_encoder_forward(self, input_ids, attention_mask)


@lru_cache(maxsize=8)
def relative_position_buckets(length: int, num_buckets: int, max_distance: int) -> Tensor:
    """The (length, length) bidirectional bucket table on the CPU, with
    transformers' ops in their order (T5Attention._relative_position_bucket)."""
    ctx = torch.arange(length, dtype=torch.long)[:, None]
    mem = torch.arange(length, dtype=torch.long)[None, :]
    rel = mem - ctx
    num_buckets //= 2
    buckets = (rel > 0).to(torch.long) * num_buckets
    rel = torch.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(is_small, rel, large)


def _rms(norm: _RMSNorm, x: Tensor, eps: float) -> Tensor:
    var = x.to(torch.float32).pow(2).mean(-1, keepdim=True)
    return norm.weight * (x * torch.rsqrt(var + eps))


def _gelu_new(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def t5_encoder_forward(model: T5Encoder, input_ids: Tensor,
                       attention_mask: Optional[Tensor] = None) -> Tensor:
    """(B, S) ids (and a (B, S) 0 / 1 padding mask) -> the encoder's
    (B, S, d_model) last hidden state, in the parameters' dtype."""
    cfg = model.cfg
    dev = model.shared.weight.device
    ids = input_ids.to(dev)
    b, s = ids.shape
    x = model.shared(ids)
    mask = None
    if attention_mask is not None:
        mask = attention_mask.to(device=dev, dtype=x.dtype)[:, None, None, :]
        mask = (1.0 - mask) * torch.finfo(x.dtype).min
    buckets = relative_position_buckets(s, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance).to(dev)
    bias = None
    for block in model.encoder.block:
        sa, ff = block.layer[0], block.layer[1]
        att = sa.SelfAttention
        if bias is None or cfg.umt5:
            # (1, heads, S, S); T5 computes it in block 0 only and reuses it
            bias = att.relative_attention_bias(buckets).permute(2, 0, 1)[None]
            if mask is not None:
                bias = bias + mask
        h = _rms(sa.layer_norm, x, cfg.layer_norm_epsilon)

        def split(t):
            return t.view(b, s, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = split(att.q(h)), split(att.k(h)), split(att.v(h))
        scores = torch.matmul(q, k.transpose(3, 2))
        scores += bias
        w = torch.softmax(scores.float(), dim=-1).type_as(scores)
        o = torch.matmul(w, v).transpose(1, 2).reshape(b, s, -1)
        x = x + att.o(o)
        h = _rms(ff.layer_norm, x, cfg.layer_norm_epsilon)
        dense = ff.DenseReluDense
        x = x + dense.wo(_gelu_new(dense.wi_0(h)) * dense.wi_1(h))
    return _rms(model.encoder.final_layer_norm, x, cfg.layer_norm_epsilon)


# ---------------------------------------------------------------- params

_EMBED_NAMES = ("shared.weight", "encoder.embed_tokens.weight")


def t5_encoder_load(src: TensorSource, cfg: T5Config) -> T5Encoder:
    """A T5 / UMT5 encoder from a text_encoder*/ checkpoint (its shards
    globbed by TensorSource.from_path) onto src's device in f32 (the
    reference's torch_dtype). The embedding is read under
    shared.weight or, failing it, encoder.embed_tokens.weight; every other
    tensor must be claimed."""
    with torch.device("meta"):
        model = T5Encoder(cfg)
    names = [n for n in _EMBED_NAMES if n in src]
    if not names:
        raise KeyError(f"checkpoint has no embedding ({' or '.join(_EMBED_NAMES)})")
    sd = {"shared.weight": src.tensor(names[0], torch.float32)}
    for n in names[1:]:
        src.take(n)  # the tied copy
    sd.update({k: src.tensor(k, torch.float32) for k in model.state_dict()
               if k != "shared.weight"})
    src.assert_consumed()
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()


def t5_encoder_init_random(seed: int, cfg: T5Config, device="cuda") -> T5Encoder:
    """Random f32 weights from a torch.Generator seeded with `seed`, drawn on
    `device` (smoke runs), scaled as T5's own init so the unscaled scores
    stay O(1): q N(0, 1/(d_model d_kv)), other linears N(0, 1/fan_in),
    embedding and relative biases N(0, 1), norm weights 1 + N(0, 0.1²)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        model = T5Encoder(cfg)
    sd = {}
    for k, p in model.state_dict().items():
        t = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
        if "layer_norm" in k:
            t = 1.0 + 0.1 * t
        elif k.endswith(".q.weight"):
            t = t * (cfg.d_model * cfg.d_kv) ** -0.5
        elif k != "shared.weight" and "relative_attention_bias" not in k:
            t = t * p.shape[-1] ** -0.5
        sd[k] = t
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()
