"""Move parameter trees of the JAX package into the port.

The JAX random inits (jax.random) cannot be reproduced by a torch.Generator,
so tests that compare the two packages hand the JAX tree across instead of
re-drawing it. The converters take that tree as numpy arrays — the caller
runs jax.device_get — and import nothing of JAX: numpy bfloat16 and
float8_e4m3fn go through their bit patterns (models/loader.as_tensor).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.attention import JointAttention
from fastdm_tpu_torch.layers.embeddings import (
    AttentionPooling,
    CombinedTimestepTextProj,
    PixArtTextProjection,
    TextImageProjection,
    TextImageTimeEmbedding,
    TextTimeEmbedding,
    TimestepEmbedding,
)
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.layers.ip_adapter import (
    ImageProjection,
    IPAdapterPlusProjection,
    ResamplerBlock,
)
from fastdm_tpu_torch.layers.normalization import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    AdaLayerNormZeroSingle,
    SD35AdaLayerNormZeroX,
)
from fastdm_tpu_torch.layers.qlinear import QLinear
from fastdm_tpu_torch.models.controlnets import (
    ControlNetCondEmbedding,
    FluxControlNet,
    SDXLControlNet,
)
from fastdm_tpu_torch.models.flux import FluxDualBlock, FluxSingleBlock, FluxTransformer
from fastdm_tpu_torch.models.loader import as_tensor
from fastdm_tpu_torch.models.qwenimage import QwenBlock, QwenImageTransformer
from fastdm_tpu_torch.models.sd35 import SD3JointBlock, SD3Transformer
from fastdm_tpu_torch.models.sdxl import (
    SDXLAttention,
    SDXLResnet,
    SDXLStage,
    SDXLTransformer2D,
    SDXLTransformerBlock,
    SDXLUNet,
    frozen_params,
)
from fastdm_tpu_torch.models.wan import (
    WanBlock,
    WanCrossAttention,
    WanImageEmbedder,
    WanSelfAttention,
    WanTransformer,
)


def _shard(model, cfg, tp):
    """With a tp group (parallel/tensor_parallel.py), this rank's shard of the
    whole model: a JAX tree handed to each rank of a test's tp group."""
    if tp is None:
        return model
    from fastdm_tpu_torch.parallel.tensor_parallel import shard_model

    return shard_model(model, cfg, tp)


def unstack_blocks(tree: Dict, n: int):
    """Split a tree of layer-stacked leaves (leading axis n) into n trees."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return [take(tree, i) for i in range(n)]


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


_LINEAR_LEAVES = ("w", "bias", "scale", "colsum", "w4", "w4p", "lora_u", "lora_v")


def _linear_converter(dev):
    """A JAX QLinear dict (bf16, int8, fp8, int4 or int4p leaves) -> QLinear on
    dev; an 8- or 4-bit (K, N) or (K/2, N) weight is copied once into its
    K-contiguous buffer by the QLinear constructor."""
    def lin(p) -> QLinear:
        if set(p) - set(_LINEAR_LEAVES):
            raise NotImplementedError(
                f"unknown QLinear leaves {sorted(set(p) - set(_LINEAR_LEAVES))}")
        w, bias, scale, colsum, w4, w4p, lora_u, lora_v = (
            as_tensor(p[k]).to(dev) if k in p else None for k in _LINEAR_LEAVES)
        return QLinear(w, bias, scale, colsum, w4=w4, w4p=w4p, lora_u=lora_u, lora_v=lora_v)

    return lin


def flux_params_from_numpy(tree: Dict, device="cuda", cfg=None, tp=None) -> FluxTransformer:
    """FLUX param tree of fastdm_tpu.models.flux (bf16, int8, fp8, int4 or
    int4p QLinears, numpy leaves, stacked block axis) -> FluxTransformer on
    `device`. An 8- or 4-bit JAX weight is (K, N) (or packed (K/2, N))
    N-contiguous; QLinear copies it once into its K-contiguous buffer."""
    dev = resolve_device(device)

    def t(a):
        return as_tensor(a).to(dev)

    lin = _linear_converter(dev)
    dual, single = _flux_blocks(tree, lin, t)
    return _shard(FluxTransformer(
        x_embedder=lin(tree["x_embedder"]), context_embedder=lin(tree["context_embedder"]),
        time_text_embed=_flux_time_text_embed(tree["time_text_embed"], lin),
        dual_blocks=dual, single_blocks=single,
        norm_out=AdaLayerNormContinuous(lin(tree["norm_out"]["linear"])),
        proj_out=lin(tree["proj_out"])), cfg, tp)


def _flux_time_text_embed(tte: Dict, lin) -> CombinedTimestepTextProj:
    def mlp(p) -> TimestepEmbedding:
        return TimestepEmbedding(lin(p["linear1"]), lin(p["linear2"]))

    return CombinedTimestepTextProj(
        mlp(tte["timestep_embedder"]), mlp(tte["text_embedder"]),
        mlp(tte["guidance_embedder"]) if "guidance_embedder" in tte else None)


def _flux_blocks(tree: Dict, lin, t):
    """The stacked dual / single FLUX blocks of a JAX tree (either may be
    absent) -> two lists of block modules."""
    dual = []
    if tree.get("dual_blocks") is not None:
        for blk in unstack_blocks(tree["dual_blocks"], _n_layers(tree["dual_blocks"])):
            a = blk["attn"]
            dual.append(FluxDualBlock(
                AdaLayerNormZero(lin(blk["norm1"]["linear"])),
                AdaLayerNormZero(lin(blk["norm1_context"]["linear"])),
                JointAttention(qkv=lin(a["qkv"]), add_qkv=lin(a["add_qkv"]),
                               to_out=lin(a["to_out"]), to_add_out=lin(a["to_add_out"]),
                               norm_q=t(a["norm_q"]), norm_k=t(a["norm_k"]),
                               norm_added_q=t(a["norm_added_q"]),
                               norm_added_k=t(a["norm_added_k"])),
                FeedForward(lin(blk["ff"]["proj"]), lin(blk["ff"]["out"])),
                FeedForward(lin(blk["ff_context"]["proj"]), lin(blk["ff_context"]["out"]))))
    single = []
    if tree.get("single_blocks") is not None:
        for blk in unstack_blocks(tree["single_blocks"], _n_layers(tree["single_blocks"])):
            single.append(FluxSingleBlock(
                AdaLayerNormZeroSingle(lin(blk["norm"]["linear"])), lin(blk["qkv_mlp"]),
                lin(blk["proj_out"]),
                JointAttention(norm_q=t(blk["attn"]["norm_q"]), norm_k=t(blk["attn"]["norm_k"]))))
    return dual, single


def _joint_attention(a: Dict, lin, t) -> JointAttention:
    """A JAX attention dict (qkv, to_out, norms; add_qkv, to_add_out and the
    added norms where present) -> JointAttention."""
    def opt(key, fn):
        return fn(a[key]) if key in a else None

    return JointAttention(qkv=lin(a["qkv"]), add_qkv=opt("add_qkv", lin),
                          to_out=lin(a["to_out"]), to_add_out=opt("to_add_out", lin),
                          norm_q=t(a["norm_q"]), norm_k=t(a["norm_k"]),
                          norm_added_q=opt("norm_added_q", t), norm_added_k=opt("norm_added_k", t))


def sd3_params_from_numpy(tree: Dict, device="cuda", cfg=None, tp=None) -> SD3Transformer:
    """SD3 param tree of fastdm_tpu.models.sd35 (numpy leaves; the
    layer-stacked "dual_attn_blocks" and "std_blocks" segments, either may be
    None, and the unstacked "last_block"; "pos_embed_table" when it came from
    sd3_load) -> SD3Transformer on `device`."""
    dev = resolve_device(device)
    lin = _linear_converter(dev)

    def t(a):
        return as_tensor(a).to(dev)

    def block(blk, dual, last) -> SD3JointBlock:
        d1, dc = lin(blk["norm1"]["linear"]), lin(blk["norm1_context"]["linear"])
        return SD3JointBlock(
            SD35AdaLayerNormZeroX(d1) if dual else AdaLayerNormZero(d1),
            AdaLayerNormContinuous(dc) if last else AdaLayerNormZero(dc),
            _joint_attention(blk["attn"], lin, t),
            FeedForward(lin(blk["ff"]["proj"]), lin(blk["ff"]["out"])),
            attn2=_joint_attention(blk["attn2"], lin, t) if dual else None,
            ff_context=None if last else FeedForward(lin(blk["ff_context"]["proj"]),
                                                     lin(blk["ff_context"]["out"])))

    def segment(key, dual):
        group = tree.get(key)
        if group is None:
            return []
        return [block(b, dual, False) for b in unstack_blocks(group, _n_layers(group))]

    tte = tree["time_text_embed"]
    return _shard(SD3Transformer(
        patch_proj=lin(tree["patch_proj"]),
        time_text_embed=CombinedTimestepTextProj(
            *(TimestepEmbedding(lin(tte[k]["linear1"]), lin(tte[k]["linear2"]))
              for k in ("timestep_embedder", "text_embedder"))),
        context_embedder=lin(tree["context_embedder"]),
        dual_blocks=segment("dual_attn_blocks", True), std_blocks=segment("std_blocks", False),
        last_block=block(tree["last_block"], False, True),
        norm_out=AdaLayerNormContinuous(lin(tree["norm_out"]["linear"])),
        proj_out=lin(tree["proj_out"]),
        pos_embed_table=t(tree["pos_embed_table"]) if "pos_embed_table" in tree else None),
        cfg, tp)


def qwen_params_from_numpy(tree: Dict, device="cuda", cfg=None, tp=None) -> QwenImageTransformer:
    """Qwen-Image param tree of fastdm_tpu.models.qwenimage (numpy leaves,
    layer-stacked "blocks") -> QwenImageTransformer on `device`."""
    dev = resolve_device(device)
    lin = _linear_converter(dev)

    def t(a):
        return as_tensor(a).to(dev)

    blocks = [QwenBlock(lin(b["img_mod"]), lin(b["txt_mod"]), _joint_attention(b["attn"], lin, t),
                        FeedForward(lin(b["img_mlp"]["proj"]), lin(b["img_mlp"]["out"])),
                        FeedForward(lin(b["txt_mlp"]["proj"]), lin(b["txt_mlp"]["out"])))
              for b in unstack_blocks(tree["blocks"], _n_layers(tree["blocks"]))]
    te = tree["time_text_embed"]["timestep_embedder"]
    return _shard(QwenImageTransformer(
        img_in=lin(tree["img_in"]), txt_in=lin(tree["txt_in"]), txt_norm=t(tree["txt_norm"]),
        timestep_embedder=TimestepEmbedding(lin(te["linear1"]), lin(te["linear2"])),
        blocks=blocks, norm_out=AdaLayerNormContinuous(lin(tree["norm_out"]["linear"])),
        proj_out=lin(tree["proj_out"])), cfg, tp)


def wan_params_from_numpy(tree: Dict, device="cuda", cfg=None, tp=None) -> WanTransformer:
    """Wan param tree of fastdm_tpu.models.wan (numpy leaves; the layer-stacked
    "dense_blocks" then "blocks" groups, either may be None) -> WanTransformer
    on `device` with one block list in layer order. A per_token_timestep
    config has the same tree; Wan2.1-I2V's image embedder and add_k / add_v /
    norm_added_k come across when the tree holds them."""
    dev = resolve_device(device)
    lin = _linear_converter(dev)

    def t(a):
        return as_tensor(a).to(dev)

    blocks = []
    for group in ("dense_blocks", "blocks"):
        if tree.get(group) is None:
            continue
        for blk in unstack_blocks(tree[group], _n_layers(tree[group])):
            a1, a2 = blk["attn1"], blk["attn2"]
            added = {}
            if "add_k" in a2:
                added = dict(add_k=lin(a2["add_k"]), add_v=lin(a2["add_v"]),
                             norm_added_k=t(a2["norm_added_k"]))
            norm2 = (t(blk["norm2"]["gamma"]), t(blk["norm2"]["beta"])) if "norm2" in blk else None
            blocks.append(WanBlock(
                t(blk["scale_shift_table"]),
                WanSelfAttention(lin(a1["qkv"]), t(a1["norm_q"]), t(a1["norm_k"]),
                                 lin(a1["to_out"])),
                WanCrossAttention(lin(a2["q"]), lin(a2["kv"]), t(a2["norm_q"]), t(a2["norm_k"]),
                                  lin(a2["to_out"]), **added),
                FeedForward(lin(blk["ffn"]["proj"]), lin(blk["ffn"]["out"])), norm2))
    ce = tree["condition_embedder"]
    image_embedder = None
    if "image_embedder" in ce:
        ie = ce["image_embedder"]
        image_embedder = WanImageEmbedder(
            (t(ie["norm1"]["gamma"]), t(ie["norm1"]["beta"])), lin(ie["ff"]["proj"]),
            lin(ie["ff"]["out"]), (t(ie["norm2"]["gamma"]), t(ie["norm2"]["beta"])),
            t(ie["pos_embed"]) if "pos_embed" in ie else None)
    return _shard(WanTransformer(
        patch_embedding=lin(tree["patch_embedding"]),
        time_embedder=TimestepEmbedding(lin(ce["time_embedder"]["linear1"]),
                                        lin(ce["time_embedder"]["linear2"])),
        time_proj=lin(ce["time_proj"]),
        text_embedder=PixArtTextProjection(lin(ce["text_embedder"]["linear1"]),
                                           lin(ce["text_embedder"]["linear2"])),
        scale_shift_table=t(tree["scale_shift_table"]), proj_out=lin(tree["proj_out"]),
        blocks=blocks, image_embedder=image_embedder), cfg, tp)


def sdxl_params_from_numpy(tree: Dict, device="cuda") -> SDXLUNet:
    """SDXL UNet param tree of fastdm_tpu.models.sdxl (numpy leaves, HWIO
    convs, each Transformer2D's blocks stacked) -> SDXLUNet on `device`, with
    (out, in, kh, kw) convs and one module per block."""
    c = _SDXLConverter(resolve_device(device))
    return SDXLUNet(
        conv_in=c.conv(tree["conv_in"]), time_embedding=c.mlp(tree["time_embedding"]),
        add_embedding=c.mlp(tree["add_embedding"]),
        down=[c.stage(tree[f"down{i}"]) for i in range(3)], mid=c.stage(tree["mid"]),
        up=[c.stage(tree[f"up{i}"]) for i in range(3)], conv_norm_out=c.norm(tree["conv_norm_out"]),
        conv_out=c.conv(tree["conv_out"]))


class _SDXLConverter:
    """Converters of the SDXL UNet's JAX leaves (HWIO convs, stacked
    Transformer2D blocks) onto `dev`, shared with the SDXL ControlNet."""

    def __init__(self, dev):
        self.dev = dev
        self.lin = _linear_converter(dev)

    def t(self, a):
        return as_tensor(a).to(self.dev)

    def conv(self, p):  # HWIO -> (out, in, kh, kw)
        return frozen_params(w=as_tensor(p["w"]).permute(3, 2, 0, 1).contiguous().to(self.dev),
                             b=self.t(p["b"]))

    def norm(self, p):
        return frozen_params(gamma=self.t(p["gamma"]), beta=self.t(p["beta"]))

    def mlp(self, p):
        return TimestepEmbedding(self.lin(p["linear1"]), self.lin(p["linear2"]))

    def resnet(self, p):
        conv, norm = self.conv, self.norm
        return SDXLResnet(norm(p["norm1"]), conv(p["conv1"]), self.lin(p["time_emb_proj"]),
                          norm(p["norm2"]), conv(p["conv2"]),
                          conv(p["shortcut"]) if "shortcut" in p else None)

    def t2d(self, p):
        lin, norm = self.lin, self.norm
        blocks = []
        for blk in unstack_blocks(p["blocks"], _n_layers(p["blocks"])):
            a1, a2 = blk["attn1"], blk["attn2"]
            blocks.append(SDXLTransformerBlock(
                norm(blk["norm1"]), SDXLAttention(lin(a1["out"]), qkv=lin(a1["qkv"])),
                norm(blk["norm2"]),
                SDXLAttention(lin(a2["out"]), q=lin(a2["q"]), kv=lin(a2["kv"]),
                              ipadp_kv=lin(a2["ipadp_kv"]) if "ipadp_kv" in a2 else None),
                norm(blk["norm3"]), FeedForward(lin(blk["ff"]["proj"]), lin(blk["ff"]["out"]))))
        return SDXLTransformer2D(norm(p["norm"]), lin(p["proj_in"]), blocks, lin(p["proj_out"]))

    def stage(self, p):
        attns = p.get("attns") or ([p["attn"]] if "attn" in p else None)
        return SDXLStage([self.resnet(r) for r in p["resnets"]],
                         [self.t2d(a) for a in attns] if attns else None,
                         downsample=self.conv(p["downsample"]) if "downsample" in p else None,
                         upsample=self.conv(p["upsample"]) if "upsample" in p else None)

    def cond_embedding(self, p) -> ControlNetCondEmbedding:
        return ControlNetCondEmbedding(self.conv(p["conv_in"]),
                                       [self.conv(b) for b in p["blocks"]],
                                       self.conv(p["conv_out"]))


def sdxl_controlnet_params_from_numpy(tree: Dict, device="cuda") -> SDXLControlNet:
    """SDXL ControlNet param tree of fastdm_tpu.models.controlnets (numpy
    leaves; any of its addition / class / encoder-projection variants) ->
    SDXLControlNet on `device`."""
    c = _SDXLConverter(resolve_device(device))
    lin = c.lin

    def optional(key, fn):
        return fn(tree[key]) if key in tree else None

    def add_embedding(p):
        if "pool" in p:  # "text"
            pool = p["pool"]
            return TextTimeEmbedding(c.norm(p["norm1"]), AttentionPooling(
                c.t(pool["positional_embedding"]), lin(pool["q_proj"]), lin(pool["k_proj"]),
                lin(pool["v_proj"])), lin(p["proj"]), c.norm(p["norm2"]))
        if "text_proj" in p:  # "text_image"
            return TextImageTimeEmbedding(lin(p["text_proj"]), c.norm(p["text_norm"]),
                                          lin(p["image_proj"]))
        return c.mlp(p)  # "text_time"

    def class_embedding(p):
        return frozen_params(weight=c.t(p["weight"])) if "weight" in p else c.mlp(p)

    def encoder_hid_proj(p):
        if "image_embeds" in p:
            return TextImageProjection(lin(p["image_embeds"]), lin(p["text_proj"]))
        return lin(p)

    return SDXLControlNet(
        conv_in=c.conv(tree["conv_in"]), time_embedding=c.mlp(tree["time_embedding"]),
        cond_embedding=c.cond_embedding(tree["cond_embedding"]),
        add_embedding=optional("add_embedding", add_embedding),
        class_embedding=optional("class_embedding", class_embedding),
        encoder_hid_proj=optional("encoder_hid_proj", encoder_hid_proj),
        down=[c.stage(tree[f"down{i}"]) for i in range(3)], mid=c.stage(tree["mid"]),
        controlnet_down_blocks=[c.conv(p) for p in tree["controlnet_down_blocks"]],
        controlnet_mid_block=c.conv(tree["controlnet_mid_block"]))


def flux_controlnet_params_from_numpy(tree: Dict, device="cuda") -> FluxControlNet:
    """FLUX ControlNet param tree of fastdm_tpu.models.controlnets (numpy
    leaves, stacked blocks and zero heads; input_hint_block with HWIO convs,
    controlnet_mode_embedder where present) -> FluxControlNet on `device`."""
    dev = resolve_device(device)
    lin = _linear_converter(dev)

    def t(a):
        return as_tensor(a).to(dev)

    def heads(key):
        p = tree.get(key)
        return None if p is None else frozen_params(w=t(p["w"]), bias=t(p["bias"]))

    dual, single = _flux_blocks(tree, lin, t)
    hint = tree.get("input_hint_block")
    return FluxControlNet(
        x_embedder=lin(tree["x_embedder"]), context_embedder=lin(tree["context_embedder"]),
        time_text_embed=_flux_time_text_embed(tree["time_text_embed"], lin),
        controlnet_x_embedder=lin(tree["controlnet_x_embedder"]), dual_blocks=dual,
        single_blocks=single, controlnet_blocks=heads("controlnet_blocks"),
        controlnet_single_blocks=heads("controlnet_single_blocks"),
        input_hint_block=None if hint is None else _SDXLConverter(dev).cond_embedding(hint),
        controlnet_mode_embedder=(t(tree["controlnet_mode_embedder"])
                                  if "controlnet_mode_embedder" in tree else None))


def ip_adapter_proj_from_numpy(proj: Dict, device="cuda"):
    """The image projection JAX's sdxl_attach_ip_adapter returns (kind
    "simple" or "plus", numpy leaves) -> ImageProjection or
    IPAdapterPlusProjection on `device`."""
    c = _SDXLConverter(resolve_device(device))
    lin, norm = c.lin, c.norm
    if proj["kind"] == "simple":
        return ImageProjection(lin(proj["proj"]), norm(proj["norm"]), int(proj["num_tokens"]))
    layers = [ResamplerBlock(norm(p["norm0"]), norm(p["norm1"]), lin(p["attn"]["q"]),
                             lin(p["attn"]["kv"]), lin(p["attn"]["out"]), norm(p["ff_norm"]),
                             lin(p["ff"]["proj"]), lin(p["ff"]["out"])) for p in proj["layers"]]
    return IPAdapterPlusProjection(c.t(proj["latents"]), lin(proj["proj_in"]), layers,
                                   lin(proj["proj_out"]), norm(proj["norm_out"]),
                                   heads=int(proj["heads"]), head_dim=int(proj["head_dim"]))


def vae_params_from_numpy(tree: Dict, device="cuda") -> Dict:
    """AutoencoderKL param tree of fastdm_tpu.pipeline.vae (numpy leaves,
    HWIO convs) -> the port's dict (OIHW convs) on `device`."""
    dev = resolve_device(device)

    def conv(node):
        return node.get("w") is not None and getattr(node["w"], "ndim", 0) == 4

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            if conv(node):
                w = as_tensor(node["w"]).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
                return {"w": w.to(dev), "b": as_tensor(node["b"]).to(dev)}
            return {k: walk(v) for k, v in node.items()}
        return as_tensor(node).to(dev)

    return walk(tree)



def wan_vae_params_from_numpy(tree: Dict, device="cuda") -> Dict:
    """Wan VAE param tree of fastdm_tpu.pipeline.wan_vae (numpy leaves, DHWIO
    conv3d / HWIO conv2d kernels; either layout, residual or not) -> the
    port's dict (PyTorch's (out, in, ...) conv layout) on `device`: the
    encoder, quant_conv, post_quant_conv and decoder it holds."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            w = node.get("w")
            if w is not None and getattr(w, "ndim", 0) in (4, 5):
                perm = (4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1)
                return {"w": as_tensor(w).permute(*perm).contiguous().to(dev),
                        "b": as_tensor(node["b"]).to(dev)}
            return {k: walk(v) for k, v in node.items()}
        return as_tensor(node).to(dev)

    return {k: walk(v) for k, v in tree.items()}


def lora_from_numpy(tree: Dict, device="cuda") -> Dict[str, Dict]:
    """A LoRA tree of examples/lora-train/train.py init_lora (numpy leaves:
    stacked down (L, K, r) / up (L, r, N) per block list, or unstacked
    (K, r) / (r, N)) -> the port's LoRA (training/lora.py): {module path:
    {"down", "up"}} in f32 on `device`, requiring gradients, block i of
    "dual_blocks.attn.qkv" at "dual_blocks.<i>.attn.qkv"."""
    dev = resolve_device(device)
    out = {}

    def leaf(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev).requires_grad_()

    def walk(node: Dict, path: str):
        if "down" in node:
            down, up = np.asarray(node["down"]), np.asarray(node["up"])
            if down.ndim == 2:
                out[path] = {"down": leaf(down), "up": leaf(up)}
                return
            head, _, rest = path.partition(".")
            for i in range(down.shape[0]):
                out[f"{head}.{i}.{rest}"] = {"down": leaf(down[i]), "up": leaf(up[i])}
            return
        for k, v in node.items():
            walk(v, f"{path}.{k}" if path else k)

    walk(tree, "")
    return out
