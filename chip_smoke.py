#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero and prints no result line:
  1. kernels: build every hand-written kernel from csrc/ (one nvcc per source,
     all at once; registers and spills from ptxas, the shared memory and
     setmaxnreg split of the wgmma + TMA kernels), run each at its main-path
     shapes (FLUX.1-dev 1024x2048; Wan2.2-A14B 480x832x81, 32760 tokens, for
     qk_norm_rope, qk_norm_rope2 and the four sparse-attention walks, each on
     its mode's radial tables) and
     hold it to its plain PyTorch version with a stated tolerance; time the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (a yardstick the port never calls). The W8A8 kernels
     are also timed at every GEMM / quantize shape of a FLUX forward, which
     gives the forward's GEMM and quantize time. SDXL-base at 1024x2048 with
     CFG: gelu_and_mul at both GEGLU shapes, sdpa at its four attention shapes
     (head dim 64, q|k|v read in place from the fused projections), and the
     int8 and fp8 GEMM and quantize at every W8A8 shape of its forward. The
     int8 GEMM is held bit-exact, with and without the zero point, at every
     int8 shape of the FLUX, SDXL and Wan forwards. The W4A4 kernels (the
     int4 quantizer, the int4 GEMM on the int8 GEMM's ring, the int4p
     unpack) are held bit-exact at every int4 shape of a FLUX int4p
     quant_mods forward, and qk_norm_rope / qk_norm_rope2 in the half-split
     layout too. On tables that allow
     every key the mask, coarse, superblock and fine walks, which run on
     sdpa's kernel, equal sdpa bit for bit. SD3.5-medium and Qwen-Image at
     1024x2048: every kernel at every shape of their forwards (rmsnorm on
     64-wide head rows and Qwen's 3584-wide txt_norm rows, sdpa on the joint
     333 + 8192 and 512 + 8192 tokens, rotembd bit-exact on Qwen's scale_rope
     tables, the int8 GEMM and quantizer bit-exact at every SD3.5 shape,
     N = 64 and M = 2 included, the W4A4 kernels at every Qwen shape), timed
     beside bounds and library calls: each forward's split. Wan2.2-TI2V-5B
     at 768x768x121 (17856 tokens, 24 heads of 128): qk_norm_rope on its
     3072-wide rows, rmsnorm, sdpa on the self-attention (a tail tile) and
     the 512-key cross-attention, the int8 quantizer and GEMM bit-exact at
     every W8A8 shape of its forward. The ControlNet / IP-Adapter shapes:
     sdpa on the IP-Adapter branch (4 or 16 keys read in place from the
     fused k|v, at both SDXL levels), the IP-Adapter-Plus resampler (16 x
     273) and the union FLUX ControlNet's 513 + 8192 = 8705-token joint,
     rotembd and rmsnorm there, the int8 quantizer and GEMM bit-exact at
     M = 513 and 8705. Wan2.1-I2V-14B's image branch at batch 1 and 2: sdpa of
     a 4095-token chunk against 257 image keys (a one-key tail tile), the
     int8 quantizer and GEMM bit-exact at M = 257 and 514 (K = N = 5120) beside
     torch._int_mm's time or its error, rmsnorm on (B, 257, 5120) rows.
  2. slice: FLUX.1-dev at full width (19 dual + 38 single blocks, 24x128
     heads, random weights from a seed) four times: in bf16, in int8, in
     fp8 (W8A8 block linears drawn straight into int8 / e4m3) and in int4p
     with quant_mods (bench.py's headline config: W4A4 block linears and
     AdaLN modulations, packed two int4 values a byte). Each serves
     1024x2048 requests through make_flux_denoiser with TeaCache, then the
     full-size FLUX VAE decoder; launch counters are zeroed just before each
     path and read just after: every kernel of the path must have run, the
     W8A8 quantize and GEMM exactly 228 times per computed forward, the W4A4
     quantize, GEMM and unpack 304 times (plus TeaCache's quantized probe
     once a step). One full-width forward on the kernels is then held to the
     same forward on the plain versions and to the forward with only the
     W8A8 / W4A4 ops on their plain versions (bit-identical for int8 and
     int4p). On the int4p model: the quantized snapshot (save_snapshot of
     the full-depth tree into a scratch dir of the checkout, load_tree onto
     the card, every parameter equal, one 1024x2048 forward from the
     reloaded tree bit-identical to the in-memory tree's; write and load
     seconds, bytes on disk and the free disk before the write, beside the
     tree's random init and a fresh quantize_weight("int4p") of each of its
     W4A4 linears on the card), then a request under dicache_flux.json and
     forced FBCache / DiCache skips that must replay the cached residual. On the
     int8 model, a 1024x2048 request from a prompt string (the port's
     FluxTextEncoder on CLIP-L and T5-v1.1-XXL at full width and depth in
     f32, drawn from seeds, and tokenizers written here) against the same
     request from its embeddings, the images equal; the image-conditioned
     requests: SDEdit at 1024x2048 (the
     full-size AutoencoderKL encoder, strength 0.6 of 4 steps: steps 1-3, the
     first computed under TeaCache, which counts from the loop's start) with
     its decode also tiled, and FLUX-Kontext at 1024x1024 with one 1024x1024
     reference (8704 tokens); launches per computed forward from
     flux_forward_launches. Then the union ControlNet at
     InstantX/FLUX.1-dev-Controlnet-Union's shape (5 dual + 10 single
     blocks, int8) serves a 1024x2048 request on a latent hint with
     control_mode 2, launches 4 x (flux_forward_launches +
     flux_controlnet_launches), one ControlNet forward held to its plain one.
  3. wan: frees FLUX, draws the two Wan2.2-T2V-A14B experts in int8 at full
     width and depth (40 blocks, 40x128 heads) from seeds and serves one
     480x832, 81-frame request through make_wan_dual_phase_denoiser (UniPC
     shift 5, CFG 4.0 / 3.0, boundary 0.875, 4 steps: 2 per expert, radial
     sparse attention on the superblock tables with one dense warmup step),
     then the full-size chunked Wan VAE decode; exact launch counts derived
     from the code; one full-size forward on the kernels held to the same
     forward on the plain versions; the split-QKV forward (qk_norm_rope2)
     held bit for bit to the fused one; each kernel timed at every shape of
     a forward, for the forward's split. Then one full-size forward in each
     other sparse mode (fine, coarse, mask), timed, with exact launch counts,
     and each held to its plain forward at 17 frames; the request again under
     FBCache (fbcache_wan.json, warmup cut to 1) and DiCache (dicache_wan.json)
     with skips, block stacks and launches equal to the counts derived from
     the code; and a forced skip that must replay the cached residual.
  sdxl: frees Wan, draws SDXL-base at full width and depth (70 transformer
     blocks, 2.57 B params) from a seed and serves 1024x2048 requests through
     make_sdxl_denoiser (batched CFG 5.0, Euler, 25 steps cut to 4) and the
     full-size VAE decode: two in int8, then one each in bf16 and fp8, with
     launch counts per forward equal to sdxl_forward_launches (int8: 529
     quantize, 529 GEMM, 140 sdpa, 70 gelu_and_mul); one full-width forward
     on the kernels held to the plain one in each format, the int8 one bit
     for bit to the forward with only the W8A8 ops plain; the int8 forward's
     split (each kernel and conv call of a recorded forward replayed alone,
     times its count). On the int8 UNet: an SDXL ControlNet at
     controlnet-canny-sdxl-1.0's shape serves a CFG request and a guess-mode
     one, random IP-Adapter k|v on every cross-attention an ip-adapter_sdxl
     and an ip-adapter-plus request (launches from sdxl_controlnet_launches
     and sdxl_ip_adapter_launches); the ControlNet forward and the UNet
     forward with its residuals and with IP tokens held to their plain ones;
     then both IP-Adapter requests through FastDMEngine.generate from a
     720x1280 ip_adapter_image (ip-adapter_sdxl on the full ViT-bigG tower,
     ip-adapter-plus on the full ViT-H tower), each equal bit for bit to the
     request from ip_adapter_image_embeds of that tower's output.
  sd35: frees SDXL, draws SD3.5-medium int8 at full width and depth (24
     blocks, 13 dual-attention, 24x64 heads) from a seed and serves 1024x2048
     requests through make_sd3_denoiser as bench.py's main_sd35 (batched CFG
     7.0, shift 3.0, TeaCache with teacache_sd35.json, 333 text tokens, 25
     steps cut to 4), then the full-size 16-channel VAE decode; launches per
     computed forward from sd35_forward_launches (217 quantize, 217 GEMM, 122
     rmsnorm, 37 sdpa; a skipped step 2); one CFG forward on the kernels held
     to the plain one, and bit for bit to the one with only the W8A8 ops plain.
  qwen: frees SD3.5, draws Qwen-Image at full width and depth (60 blocks,
     24x128 heads) in int4p with quant_mods from a seed and serves 1024x2048
     requests through make_qwen_denoiser as bench.py's main_qwen (true CFG
     1.0, 512 text tokens, TeaCache 0.1 with teacache_qwenimage.json's
     polynomial, dynamic shift, 4 steps), then the full-size Wan VAE decoder
     on a singleton frame; launches from qwen_forward_launches (600 of each
     W4A4 op, 240 rmsnorm, 60 rotembd, 60 sdpa per computed forward, plus the
     txt_norm rmsnorm and TeaCache's W4A4 probe every step); one forward held
     to the plain one, and bit for bit to the one with only the W4A4 ops plain;
     then a Qwen-Image-Edit request: one 1024x1024 source through the
     full-size Wan2.1-layout VAE encoder, its tokens after the 1024x1024
     noise's, true CFG 4.0 on two TeaCache streams, 4 steps.
  wan5b: frees Qwen, draws Wan2.2-TI2V-5B int8 at full width and depth (30
     blocks, 24x128 heads, ffn 14336, per-token timesteps) from a seed: one
     768x768x121 forward with the TI2V per-token timestep, launches exactly
     as derived (210 quantize, 210 GEMM, 60 sdpa, 60 rmsnorm, 30
     qk_norm_rope), held to the plain forward and bit for bit to the forward
     with only the int8 ops plain; then FastDMEngine on a written checkpoint
     (30 blocks, pos_embed_seq_len, the full-size residual 2x2-patchified VAE
     with its encoder): a t2v request (UniPC shift 5, CFG 5.0, FBCache with
     warmup 8 cut to 1, 50 steps cut to 4, the chunked decode) and a ti2v
     request on a seeded image whose first latent frame must equal the
     encoded image; then Wan i2v at Wan2.2-I2V-A14B width (in_channels 36,
     two experts cut to 2 blocks, 2 steps) at 480x832x81 through the engine's
     _wan_i2v_latents. Request, forward, VAE encode / decode seconds and peak
     GiB are summed up on a line after [done].
  text: the four text encoders at full width and depth in f32 from seeds
     (CLIP-L 12x768; CLIP-bigG 32x1280, projection 1280; T5-v1.1-XXL and
     UMT5-XXL 24x4096, 64 heads of 64, FFN 10240, vocabularies 32128 and
     256384), each tokenizing a CFG pair through the port's tokenizer of a
     directory written here (CLIP's 49408-id BPE padded with <|endoftext|>
     or "!", Unigram tokenizer.json files of 32100 and 256300 pieces with a
     Precompiled charsmap) and encoding it at its lengths (77; T5 512 and
     256; UMT5 512 with the mask): seconds, f32 TFLOP/s, peak GiB; no kernel
     launches; its first two layers on the card held to the same layers on
     the CPU within TEXT_REL_L2_TOL; then freed. A [text] line after [done]
     sums up the encoders and the prompt-string requests.
  vision: the two CLIP vision towers at full width and depth in f32 from
     seeds (ViT-H/14 32x1280, ViT-bigG/14 48x1664), each encoding a 720x1280
     frame through the port's preprocessing: preprocessing and encode ms, f32
     TFLOP/s, peak GiB, no kernel launches, two layers on the card held to the
     CPU within VISION_REL_L2_TOL.
  i2v: Wan2.1-I2V-14B-480P int8 at full width and depth on the full ViT-H
     tower's tokens of a 480x832 frame: one 480x832x81 forward timed with
     exact launches, bit-identical with only the int8 ops plain, held to the
     plain forward at 17 frames; an i2v request (2 steps, CFG 5.0) through
     make_wan_denoiser(encoder_image=...) with the i2v channels (the
     full-size Wan VAE's encoder) and the chunked decode. An [i2v] line after
     [done] sums up the towers, Wan2.1-I2V and the SDXL image requests.
  4. engine: the tokenizers and the four text encoders at full width, two
     layers each (bf16), are written once and linked into the FLUX, SD3.5,
     SDXL and Wan checkpoints as their tokenizer*/ and text_encoder*/; the
     bf16 FLUX, the SDXL, the SD3.5 and the Wan engine each run one generate
     from prompt strings (prompt and negative_prompt, encoded on the card),
     equal bit for bit to the generate from the encoder's embeddings of
     them. Synthetic diffusers-layout checkpoints are written to a scratch
     dir — FLUX (full width, one dual and one single block, full-size VAE),
     loaded in bf16, with use_int8, with use_fp8 and with use_int4,
     pack_int4 and quant_mods (the SVDQuant split on the card); Wan2.2-A14B (two experts
     at full width with one block each, model_index.json, the full-size VAE
     with its encoder),
     loaded with use_int8 and the radial config — and generate() is called
     once each; for Wan once in each sparse mode (FASTDM_SPARSE_GATHER) and
     once under each cache JSON; SDXL-base (the full UNet in bf16, 5.1 GB,
     full-size VAE), loaded with use_int8, one 1024x2048 generate; SD3.5-medium
     (full width, one dual, one standard and the last block, dual_attention_layers
     in its config.json, the checkpoint's 384x384 position table, full-size
     VAE) with use_int8 and Qwen-Image (full width, two blocks, the full-size
     Wan-layout VAE with base_dim in its config.json) with use_int4,
     pack_int4 and quant_mods, one 1024x2048 generate each. Every vae/ holds
     the encoder too. The int8 and int4p FLUX engines and the Wan dual-expert
     int8 engine are built with snapshot_path on an empty dir beside the
     checkpoint (they write the quantized snapshot), then again from it:
     every denoiser parameter equal on the card, one generate with the same
     seed on each, outputs equal and the same launches; both construction
     times and the snapshot's bytes are logged, and summed up on a
     [snapshot] line after [done]. FLUX (as flux, and int8 as flux-kontext), SD3.5, SDXL
     and qwen-image-edit (through the Wan-layout VAE, then on a bf16 engine
     through an AutoencoderKL vae/) each run one task="i2i" generate on a
     1000x2040 image (not a multiple of 16: the log names the
     _resize_to_multiple branch), with launches derived per computed
     forward; the fp8 FLUX engine generates 1024x2048 after
     enable_vae_tiling(). An [img2img] line after [done] sums up the
     image-conditioned requests. The int8 flux-kontext engine also loads a
     full-width 2-block raw-hint ControlNet (controlnet_path) and generates
     with a control_image; the SDXL engine loads a full-size ControlNet and
     an ip-adapter_sdxl checkpoint (controlnet_path, ip_adapter_path) and
     generates with a control_image, with ip_adapter_image_embeds and with an
     ip_adapter_image (a 2-layer full-width ViT-bigG image_encoder/ in the
     checkpoint). A [controlnet] line sums up the ControlNet / IP-Adapter
     numbers. A one-block Wan2.1-I2V checkpoint (the image branch, a 2-layer
     ViT-H image_encoder/, the UMT5 directories) loads as wan2.1-i2v and as
     wan-i2v, each running an i2v generate from prompt strings and a uint8
     image, the two videos equal.

Before the last line it prints the card's name and power limit and a
{"kernels": [...]} line; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX or of fastdm_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
INT8_FP8_OPS = 1979e12       # H100 SXM dense int8 / fp8 tensor cores
F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores

# Wan2.2-T2V-A14B at 480x832, 81 frames: 21 x 60 x 104 latents, 21 x 30 x 52
# = 32760 patch tokens (1x2x2 patches), 40 heads of 128; the engine's
# one-block checkpoint generates a 17-frame clip
WAN_H, WAN_W, WAN_FRAMES, WAN_ENGINE_FRAMES = 480, 832, 81, 17
WAN_HEADS, WAN_DIM, WAN_TEXT = 40, 40 * 128, 512
WAN_STEPS, WAN_CFG, WAN_BOUNDARY = 4, (4.0, 3.0), 0.875
# the radial config of examples/sparse/radial_attn_wan.json, with dense_steps
# cut from 11 to 1 so that the sparse kernel runs within the 4 steps
WAN_DENSE_STEPS = 1

# FLUX.1-dev at 1024x2048: 64x128 latent tokens, 512 text tokens
FLUX_HT, FLUX_WT = 64, 128  # latent tokens of 16x16 pixels
IMG_TOKENS, TXT_TOKENS = FLUX_HT * FLUX_WT, 512
HEADS, HEAD_DIM = 24, 128
DIM, MLP = HEADS * HEAD_DIM, 4 * HEADS * HEAD_DIM
DUAL, SINGLE = 19, 38
# the W8A8 linears of one forward (quant_mods=False): (M, K, N) -> count
W8A8_GEMMS = {}
for _m, _n in ((IMG_TOKENS, DUAL), (TXT_TOKENS, DUAL)):
    for _kn in ((DIM, 3 * DIM), (DIM, DIM), (DIM, MLP), (MLP, DIM)):
        W8A8_GEMMS[(_m, *_kn)] = _n
W8A8_GEMMS[(IMG_TOKENS + TXT_TOKENS, DIM, 3 * DIM + MLP)] = SINGLE  # qkv_mlp
W8A8_GEMMS[(IMG_TOKENS + TXT_TOKENS, DIM + MLP, DIM)] = SINGLE      # proj_out
W8A8_PER_FORWARD = sum(W8A8_GEMMS.values())                        # 228
QKV_MLP = (IMG_TOKENS + TXT_TOKENS, DIM, 3 * DIM + MLP)            # the timing shape
# the W4A4 linears of one int4p forward with quant_mods (bench.py's FLUX
# default): the block linears plus the AdaLN modulations, one token each
# (dual blocks: norm1 and norm1_context, 3072 -> 18432; single: 3072 -> 9216)
W4A4_GEMMS = dict(W8A8_GEMMS)
W4A4_GEMMS[(1, DIM, 6 * DIM)] = 2 * DUAL
W4A4_GEMMS[(1, DIM, 3 * DIM)] = SINGLE
W4A4_PER_FORWARD = sum(W4A4_GEMMS.values())                        # 304
# the W4A4 linears of one dual block (8 block linears, 2 modulations): what
# an FBCache or DiCache probe of depth 1 launches
W4A4_PER_DUAL_BLOCK = 10

# SDXL-base at 1024x2048 with batched CFG (batch 2): 128x256 latents, the
# Transformer2Ds at 64x128 = 8192 tokens (640 wide, 10 heads of 64) and at
# 32x64 = 2048 tokens (1280 wide, 20 heads), 77 text tokens of 2048
SDXL_H, SDXL_W, SDXL_TEXT, SDXL_BATCH = 1024, 2048, 77, 2
SDXL_STEPS, SDXL_CFG = 4, 5.0
GELU_MUL_OPS = 20  # f32 operations per output: erff's polynomial, the gate's scale, products

# SD3.5-medium at 1024x2048 with batched CFG 7.0 (batch 2; bench.py:159-226):
# 128x256 latents, 64x128 = 8192 patch tokens, 333 text tokens first in the
# joint attention (8525 tokens), 24 heads of 64; 25 FlowMatch steps cut to 4
SD35_H, SD35_W, SD35_TEXT, SD35_BATCH = 1024, 2048, 333, 2
SD35_STEPS, SD35_CFG = 4, 7.0
# Qwen-Image at 1024x2048 (bench.py:484-575): 64x128 = 8192 packed tokens,
# 512 text tokens, true CFG 1.0 (one forward a step), TeaCache 0.1 with
# teacache_qwenimage.json's polynomial; 25 steps cut to 4
QWEN_HT, QWEN_WT, QWEN_TEXT, QWEN_STEPS, QWEN_CFG = 64, 128, 512, 4, 1.0
QWEN_TEACACHE_THRESHOLD = 0.1
# Wan2.2-TI2V-5B at 768x768, 121 frames (bench.py:272-356): the 16x
# patchified VAE gives 31 x 48 x 48 latents, 31 x 24 x 24 = 17856 patch tokens
# (1x2x2 patches), 24 heads of 128; 50 UniPC steps cut to 4, CFG 5.0
WAN5B_H, WAN5B_W, WAN5B_FRAMES, WAN5B_STEPS, WAN5B_CFG = 768, 768, 121, 4, 5.0
# Wan2.2-I2V-A14B i2v at WAN_H x WAN_W x WAN_FRAMES: two experts cut to 2
# blocks each, 2 steps (one per expert)
I2V_LAYERS, I2V_STEPS = 2, 2
# Image-conditioned requests on the phase-2 int8 FLUX.1-dev and the qwen
# phase's Qwen-Image: SDEdit at 1024x2048 (strength 0.6 of 4 steps: the loop
# runs steps 1..3), FLUX-Kontext at 1024x1024 with one 1024x1024 reference
# (4096 noise + 4096 reference + 512 text = 8704 tokens, guidance 2.5, 4
# steps), Qwen-Image-Edit at 1024x1024 with one 1024x1024 source (4096 + 4096
# image tokens, true CFG 4.0, TeaCache 0.1, 4 steps)
SDEDIT_H, SDEDIT_W, SDEDIT_STRENGTH = 1024, 2048, 0.6
KONTEXT_SIZE, KONTEXT_GUIDANCE = 1024, 2.5
EDIT_SIZE, EDIT_CFG = 1024, 4.0
# phase 4's input images: sides that are not multiples of 16
ENGINE_IMAGE_H, ENGINE_IMAGE_W = 1000, 2040
# ControlNet / IP-Adapter requests at 1024x2048, 4 steps, conditioning scale
# 0.7: InstantX/FLUX.1-dev-Controlnet-Union at its published shape (5 dual +
# 10 single blocks at FLUX width, 10 modes, guidance-distilled; its mode
# token makes the text stream 513 and the joint sequence 8705 tokens) on the
# phase-2 int8 FLUX.1-dev; diffusers/controlnet-canny-sdxl-1.0 (the UNet's
# down + mid path, hint channels 16, 32, 96, 256, "text_time"), h94/IP-Adapter
# ip-adapter_sdxl (a 1280-wide image embedding to 4 tokens of 2048) and
# ip-adapter-plus_sdxl_vit-h (4 resampler layers, 16 latents of 1280, 20
# heads of 64, over 257 x 1280 CLIP states) on the sdxl phase's int8
# SDXL-base
UNION_LAYERS, UNION_SINGLE, UNION_MODES, UNION_MODE = 5, 10, 10, 2
UNION_TEXT = TXT_TOKENS + 1
CN_SCALE = 0.7
IP_EMBED, IP_TOKENS = 1280, 4
PLUS_LAYERS, PLUS_LATENTS, PLUS_HIDDEN, PLUS_STATES = 4, 16, 1280, 257
# the ControlNet / IP-Adapter numbers of every phase, printed after [done]
CN_SUMMARY: dict = {}
# the quantized-snapshot numbers of phases 2 and 4, printed after [done]
SNAPSHOT_SUMMARY: dict = {}
# The text encoders at their published widths and depths, in f32 as the
# reference loads them (torch_dtype=torch.float32), random weights from seeds:
# CLIP-L (openai/clip-vit-large-patch14: FLUX.1-dev's, SD3.5's and SDXL's
# text_encoder), CLIP-bigG (laion/CLIP-ViT-bigG-14: SDXL's and SD3.5's
# text_encoder_2), T5-v1.1-XXL (FLUX.1-dev's text_encoder_2 at 512 tokens,
# SD3.5's text_encoder_3 at 256) and UMT5-XXL (Wan's text_encoder at 512):
# (name, kind, config, tokenizer, lengths). Each encodes TEXT_PROMPTS, a CFG
# pair, at each length.
TEXT_ENCODERS = (
    ("clip-l", "clip", dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                            num_attention_heads=12, hidden_act="quick_gelu", eos_token_id=2,
                            projection_dim=768), "clip-tok", (77,)),
    ("clip-bigg", "clip", dict(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                               num_attention_heads=20, hidden_act="gelu", eos_token_id=49407,
                               projection_dim=1280), "clip-tok-bang", (77,)),
    ("t5-xxl", "t5", dict(vocab_size=32128), "t5-tok", (512, 256)),
    ("umt5-xxl", "umt5", dict(vocab_size=256384, umt5=True), "umt5-tok", (512,)),
)
TEXT_PROMPTS = ("a photo of an astronaut riding a horse on the moon, highly detailed, 8k, "
                "cinematic lighting, Ｆｕｌｌ ｗｉｄｔｈ… ½ café",
                "blurry, low quality, watermark")
# the card's f32 two-layer encoder against the same two layers on the CPU:
# measured 4.3e-7 to 2.7e-6 on an H100 80GB HBM3 (f32 sums in another order);
# a wrong layer, mask or bucket gives O(1)
TEXT_REL_L2_TOL = 1e-4
# tokenizer sizes: CLIP's 49408 ids, T5's 32100 pieces, UMT5's 256300
T5_PIECES, UMT5_PIECES = 32100, 256300
# the encoders' encode seconds and peaks, printed after [done]
TEXT_SUMMARY: dict = {}
# The CLIP vision towers at their published widths and depths, in f32 as the
# reference loads them, random weights from seeds: (config, projection, seed).
# ViT-H/14 (OpenCLIP, laion2B): Wan2.1-I2V's image_encoder (a CLIPVisionModel,
# no projection) and ip-adapter-plus_sdxl_vit-h's (projection 1024); ViT-bigG/14
# (laion/CLIP-ViT-bigG-14): ip-adapter_sdxl's (projection 1280). Each encodes
# one 720x1280 frame through the port's preprocessing (224 px: 257 tokens).
VISION_TOWERS = {
    "vit-h": (dict(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                   num_attention_heads=16, patch_size=14, image_size=224, projection_dim=1024,
                   hidden_act="gelu"), True, 610),
    "vit-bigg": (dict(hidden_size=1664, intermediate_size=8192, num_hidden_layers=48,
                      num_attention_heads=16, patch_size=14, image_size=224, projection_dim=1280,
                      hidden_act="gelu"), True, 611),
}
VISION_FRAME_H, VISION_FRAME_W = 720, 1280
# the card's f32 two-layer tower against the same two layers on the CPU, as
# the text encoders' gate (f32 sums in another order; a wrong layer is O(1))
VISION_REL_L2_TOL = 1e-4
# Wan2.1-I2V-14B-480P (Wan-AI/Wan2.1-I2V-14B-480P-Diffusers transformer/
# config.json): 40 blocks, 40x128 heads, ffn 13824, in_channels 36 (16 latent
# + 4 mask + 16 encoded), image_dim 1280 and added_kv_proj_dim 5120, text_len
# 512; ViT-H's 257 penultimate tokens; at 480x832x81 (32760 tokens in 8
# chunks of 4095), CFG 5.0, 40 UniPC steps cut to 2; its forward is held to
# the plain forward at 17 frames (7800 tokens, chunks of 975): the full-size
# plain forward takes ~80 s
I2V21_IMAGE_DIM, I2V21_IMAGE_TOKENS, I2V21_STEPS, I2V21_CFG = 1280, 257, 2, 5.0
I2V21_GATE_FRAMES = 17
# the vision and Wan2.1-I2V numbers of every phase, printed after [done]
I2V_SUMMARY: dict = {}


def log(*a):
    print(*a, flush=True)


# cycles of the busy-wait that holds the stream per timed run (~0.1 ms)
QUEUE_CYCLES_PER_RUN = 200_000


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` runs (CUDA events). A
    busy-wait kernel holds the stream while the host queues the runs, so a
    kernel shorter than its wrapper's host time is timed on the device, not
    at the rate the host enqueues it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES_PER_RUN * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch

    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ptxas_entries(report: str):
    """(mangled entry, registers, spill line) of each kernel in a ptxas -v report."""
    import re

    out, entry, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                out.append((entry, int(m.group(1)), spills))
                entry = None
    return out


def _kernel_name(entry: str) -> str:
    """A mangled kernel entry's name with its template arguments, e.g.
    rms_norm_head_rows_kernel<2> (each name is prefixed by its length)."""
    import re

    for m in re.finditer(r"(?=(\d{1,3}))", entry):  # a length may follow other digits
        start = m.start() + len(m.group(1))
        name = entry[start:start + int(m.group(1))]
        if name.endswith("_kernel") and name.isidentifier():
            args = re.findall(r"L[ib](\d+)E", entry[start + len(name):])
            return name + (f"<{', '.join(args)}>" if args else "")
    return entry


def _log_ptxas() -> None:
    """Registers and spills of every kernel, from the ptxas report of its build
    (fastdm_tpu_torch/_build/<source>.ptxas.txt), the dynamic shared memory of
    the wgmma + TMA kernels (both W8A8 GEMMs, the attention kernel per head dim, walk and consumer count), from their libraries, and
    every ptxas performance warning (e.g. C7514: wgmma serialised; C7508:
    setmaxnreg ignored). The warp-specialised kernels start at the launch
    allocation ptxas reports and then move registers with setmaxnreg
    (producer / consumers, read from the libraries as the shared memory is)."""
    import ctypes
    import re

    from fastdm_tpu_torch.kernels import build

    fp8, int8 = build.load_library("fp8_gemm"), build.load_library("w8a8_gemm")
    attn = build.load_library("flash_attn")
    attn.fdm_flash_attn_smem_bytes.argtypes = [ctypes.c_int] * 3
    fp8.fdm_fp8_gemm_setmaxnreg.argtypes = [ctypes.c_int]
    int8.fdm_w8a8_gemm_setmaxnreg.argtypes = [ctypes.c_int]
    attn.fdm_flash_attn_setmaxnreg.argtypes = [ctypes.c_int]
    for name in build.SOURCES:
        path = build.BUILD_DIR / f"{name}.ptxas.txt"
        report = path.read_text() if path.exists() else ""
        for line in report.splitlines():
            if "Performance Loss" in line:
                log(f"[ptxas {name}] {line.strip()}")
        for entry, regs, spills in _ptxas_entries(report):
            label, extra = name, ""
            d = re.search(r"ILi(\d+)E", entry)
            walk = re.search(r"NS_\d+(\w+?)TablesE", entry)
            if name == "fp8_gemm":
                extra = (f"; dynamic shared memory {fp8.fdm_fp8_gemm_smem_bytes()} B; setmaxnreg "
                         f"{fp8.fdm_fp8_gemm_setmaxnreg(0)} / {fp8.fdm_fp8_gemm_setmaxnreg(1)}")
            elif name == "w8a8_gemm":
                extra = (f"; dynamic shared memory {int8.fdm_w8a8_gemm_smem_bytes()} B; "
                         f"setmaxnreg {int8.fdm_w8a8_gemm_setmaxnreg(0)} / "
                         f"{int8.fdm_w8a8_gemm_setmaxnreg(1)}")
            elif name == "flash_attn" and d and walk:
                cons = int(re.search(r"ILi\d+ELi(\d)E", entry).group(1))
                table = {"Dense": 0, "Mask": 2}.get(walk.group(1), 1)
                label += f" D={d.group(1)} {walk.group(1)} {cons} consumer(s)"
                extra = (f"; dynamic shared memory "
                         f"{attn.fdm_flash_attn_smem_bytes(int(d.group(1)), cons, table)} B; "
                         f"setmaxnreg {attn.fdm_flash_attn_setmaxnreg(0)} / "
                         f"{attn.fdm_flash_attn_setmaxnreg(1)}")
            else:
                label += f" {_kernel_name(entry)}"
            log(f"[ptxas {label}] {regs} registers at launch; {spills}{extra}")


def _sdpa_ms(label: str, q, k, v, h: int, hd: int, flops: float, bound_ms: float,
             lib_ms: float, iters: int) -> float:
    """The dense sdpa kernel's mean ms on (q, k, v), logged beside its rate,
    its bound and the library call's ms."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb

    ms = cuda_ms(lambda: cb.sdpa_cuda(q, k, v, h, h, hd), iters)
    log(f"[sdpa] {label}: {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, {bound_ms / ms:.1%} of "
        f"the bound {bound_ms:.4f} ms); library {lib_ms:.4f} ms")
    return ms


# ------------------------------------------------------------------ phase 1


def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from fastdm_tpu_torch.kernels import build, cuda_backend, torch_backend
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_rope_cache

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[kernels] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    _log_ptxas()

    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # --- rmsnorm: per-head q norm on the strided q view of a FLUX dual block's
    # fused QKV output (head rows), and Wan2.2-A14B's cross-attention q norm
    # on (1, 32760, 5120) (wide rows); each with a bf16 weight and without,
    # within one bf16 ulp of the plain version
    qkv = torch.randn(1, IMG_TOKENS, 3 * HEADS * HEAD_DIM, generator=g, device=dev,
                      dtype=torch.bfloat16)
    eps = 1e-6
    gw = torch.Generator(device=dev).manual_seed(1)  # the Wan case's; g's draws stay as they were
    rms_cases = {
        "flux": (qkv[..., :HEADS * HEAD_DIM].reshape(1, IMG_TOKENS, HEADS, HEAD_DIM),
                 (1 + 0.05 * torch.randn(HEAD_DIM, generator=g, device=dev)).bfloat16()),
        "wan": (torch.randn(1, _wan_shape(WAN_FRAMES)[3], WAN_DIM, generator=gw, device=dev,
                            dtype=torch.bfloat16),
                (1 + 0.05 * torch.randn(WAN_DIM, generator=gw, device=dev)).bfloat16())}
    for case, (x, w) in rms_cases.items():
        d = x.shape[-1]
        max_err = 0.0
        for weight in (w, None):
            got = cuda_backend.rms_norm_cuda(x, weight, eps)
            ref = torch_backend.rms_norm_torch(x, weight, eps)
            err = (got.float() - ref.float()).abs()
            ulps = (err / bf16_ulp(ref)).max().item()
            max_err = max(max_err, err.max().item())
            log(f"[rmsnorm] {case} {tuple(x.shape)} bf16, weight "
                f"{'bf16' if weight is not None else 'none'}: max_abs_err "
                f"{err.max().item():.3e}, max {ulps:.2f} bf16 ulp (tolerance 1 ulp)")
            if not ulps <= 1.0:
                raise AssertionError(f"rmsnorm ({case}) disagrees with its plain version: "
                                     f"{ulps} ulp")
            del got, ref, err
        ms = cuda_ms(lambda: cuda_backend.rms_norm_cuda(x, w, eps), 50)
        plain_ms = cuda_ms(lambda: torch_backend.rms_norm_torch(x, w, eps), 10)
        lib_ms = None
        if hasattr(F, "rms_norm"):
            lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), w, eps), 50)
        n = x.numel()
        b_ms, b_by = bound(2 * n * 2 + d * 2, 4 * n, F32_FLOPS)
        log(f"[rmsnorm] {case}: {ms:.4f} ms ({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, "
            f"{b_by}); plain {plain_ms:.4f} ms; library {lib_ms} ms")
        if case == "flux":
            results["rmsnorm"] = dict(
                name="rmsnorm", route="cuda", source="fastdm_tpu_torch/csrc/rmsnorm.cu",
                replaces="fastdm_tpu/kernels/pallas/elementwise.py:66",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
    del qkv, rms_cases, x

    # --- rotembd: joint (txt + img) q and k with the real FLUX cos/sin, in the
    # interleaved layout FLUX runs and the half-split (neox) one; bit-exact
    s = TXT_TOKENS + IMG_TOKENS
    cos, sin = flux_rope_cache(FluxConfig(), TXT_TOKENS, 64, 128, device=dev)
    q = torch.randn(1, s, HEADS * HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, s, HEADS * HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    n = q.numel() + k.numel()
    b_ms, b_by = bound(2 * n * 2 + 2 * cos.numel() * 4, 3 * n, F32_FLOPS)
    for neox in (False, True):
        layout = "half-split" if neox else "interleaved"
        gq, gk = cuda_backend.rotary_pos_embedding_cuda(q, k, HEAD_DIM, cos, sin, neox)
        rq, rk = torch_backend.rotary_pos_embedding_torch(q, k, HEAD_DIM, cos, sin, neox)
        max_err = max((a.float() - r.float()).abs().max().item() for a, r in ((gq, rq), (gk, rk)))
        exact = torch.equal(gq, rq) and torch.equal(gk, rk)
        log(f"[rotembd] {tuple(q.shape)} bf16 {layout}: max_abs_err {max_err:.3e}, "
            f"bit-exact {exact} (tolerance: bit-exact)")
        del gq, gk, rq, rk
        if not exact:
            raise AssertionError(f"rotembd ({layout}) is not bit-exact with its plain version")
        ms = cuda_ms(lambda: cuda_backend.rotary_pos_embedding_cuda(q, k, HEAD_DIM, cos, sin,
                                                                    neox), 50)
        plain_ms = cuda_ms(lambda: torch_backend.rotary_pos_embedding_torch(
            q, k, HEAD_DIM, cos, sin, neox), 10)
        log(f"[rotembd] {layout}: {ms:.4f} ms ({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, "
            f"{b_by}); plain {plain_ms:.4f} ms")
        if not neox:
            results["rotembd"] = dict(
                name="rotembd", route="cuda", source="fastdm_tpu_torch/csrc/rope.cu",
                replaces="fastdm_tpu/kernels/pallas/elementwise.py:483",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)

    # --- sdpa: the joint self-attention, plus causal, GQA and D=64 cases. At
    # the FLUX shape the outputs average 8704 keys (std ~0.018), so that case is
    # held to max|err| <= 1e-3 + 2 bf16 ulp of |plain| and relative L2 <= 5e-3
    # (one 64-key tile dropped or doubled gives ~5e-2); the smaller cases, whose
    # outputs are larger, to 1e-2 + 1e-2*|plain|.
    v = torch.randn(1, s, HEADS * HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    cases = [("flux", q, k, v, HEADS, HEADS, HEAD_DIM, False)]
    for name, sq, hq, hkv, d, causal in (("causal", 1000, 8, 8, 128, True),
                                          ("gqa", 777, 8, 2, 128, False),
                                          ("d64-causal-gqa", 300, 4, 2, 64, True)):
        cq = torch.randn(2, sq, hq * d, generator=g, device=dev, dtype=torch.bfloat16)
        ck = torch.randn(2, sq, hkv * d, generator=g, device=dev, dtype=torch.bfloat16)
        cv = torch.randn(2, sq, hkv * d, generator=g, device=dev, dtype=torch.bfloat16)
        cases.append((name, cq, ck, cv, hq, hkv, d, causal))
    flux_err = None
    for name, cq, ck, cv, hq, hkv, d, causal in cases:
        got = cuda_backend.sdpa_cuda(cq, ck, cv, hq, hkv, d, causal)
        ref = torch_backend.sdpa_torch(cq, ck, cv, hq, hkv, d, causal)
        e = (got.float() - ref.float()).abs()
        rel = (e.norm() / ref.float().norm()).item()
        if name == "flux":
            tol, rel_tol, stated = 1e-3 + 2 * bf16_ulp(ref), 5e-3, "1e-3 + 2 ulp, rel L2 5e-3"
        else:
            tol, rel_tol, stated = 1e-2 + 1e-2 * ref.float().abs(), None, "1e-2 + 1e-2*|plain|"
        excess = (e - tol).max().item()
        log(f"[sdpa] {name} q{tuple(cq.shape)} k{tuple(ck.shape)} causal={causal}: "
            f"max_abs_err {e.max().item():.3e}, rel L2 {rel:.3e} (tolerance {stated})")
        if (not excess <= 0 or (rel_tol is not None and not rel <= rel_tol)
                or not torch.isfinite(got).all()):
            raise AssertionError(f"sdpa {name} disagrees with its plain version")
        if name == "flux":
            flux_err = e.max().item()
    heads = lambda t: t.view(1, s, HEADS, HEAD_DIM).transpose(1, 2)  # noqa: E731
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 10)
    flops = 4 * s * s * HEAD_DIM * HEADS
    b_ms, b_by = bound(4 * q.numel() * 2, flops, BF16_FLOPS)
    ms = _sdpa_ms(f"FLUX (1, {s}, {HEADS}x{HEAD_DIM})", q, k, v, HEADS, HEAD_DIM, flops, b_ms,
                  lib_ms, 10)
    plain_ms = cuda_ms(lambda: torch_backend.sdpa_torch(q, k, v, HEADS, HEADS, HEAD_DIM), 3, 1)
    results["sdpa"] = dict(
        name="sdpa", route="cuda", source="fastdm_tpu_torch/csrc/flash_attn.cu",
        replaces="fastdm_tpu/kernels/pallas/attention.py:429",
        max_abs_err=flux_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms)
    del q, k, v, cases
    torch.cuda.empty_cache()
    results.update(_w8a8_kernels(dev, g))
    results.update(_w4a4_kernels(dev))
    results.update(_wan_kernels(dev, g))
    results.update(_sdxl_kernels(dev, g))
    _sd35_kernels(dev, g)
    _qwen_kernels(dev)
    _wan5b_kernels(dev, torch.Generator(device=dev).manual_seed(4))
    _controlnet_kernels(dev, torch.Generator(device=dev).manual_seed(11))
    _image_branch_kernels(dev, torch.Generator(device=dev).manual_seed(12))
    for r in results.values():
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library {r['library_ms']})")
    return results


def _quantize_bytes(m: int, k: int, fp8: bool) -> int:
    # x read once (bf16), q written once, scale (and zp) per row
    return 3 * m * k + m * (4 if fp8 else 8)


def _gemm_bytes(m: int, k: int, n: int) -> int:
    # a, b read once, bf16 out written once, scales/colsum/bias/azp once
    return m * k + k * n + 2 * m * n + 8 * m + 10 * n


def _w8a8_operands(quant: str, m: int, k: int, n: int, g, dev):
    """A bf16 activation quantized per token by the plain version, a random
    W8A8 QLinear drawn as flux_init_random draws it, and the GEMM's arguments."""
    import torch

    from fastdm_tpu_torch.kernels import torch_backend
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    lin = qlinear_random(g, k, n, quant=quant, device=dev)
    if quant == "int8":
        a, sa, azp = torch_backend.quantize_to_int8_torch(x, symmetric=False)
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, azp, lin.bias)
    else:
        a, sa = torch_backend.quantize_to_fp8_torch(x)
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.bias)
    return a, sa, lin, args


def _int8_exact(args, label: str) -> None:
    """The int8 GEMM held bit-exact to its plain version on `args`, with the
    zero point and with azp None; raises on any mismatch."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    for zp_args in (args, (*args[:6], None, args[7])):
        got, want = cb.int8_matmul_cuda(*zp_args), tb.int8_matmul_torch(*zp_args)
        if not (torch.equal(got, want) and torch.isfinite(got).all()):
            raise AssertionError(f"int8_matmul disagrees with its plain version at {label} "
                                 f"(azp {'given' if zp_args[6] is not None else 'None'})")
        del got, want


def _w8a8_kernels(dev, g) -> dict:
    """The per-token quantizers and the W8A8 GEMMs against their plain
    versions at the FLUX single-block shapes (K = 3072 and K = 15360, the
    longest on the path), timed at the qkv_mlp shape and at every GEMM and
    quantize shape of a forward. Quantizers and the int8 GEMM are held
    bit-exact (the GEMM with and without the zero point); the fp8 GEMM (f32
    sums in another order) to 1 bf16 ulp of |plain| plus 2^-16 *
    scale_a*scale_b*(|a| @ |b|) for outputs that cancel."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    m_single = IMG_TOKENS + TXT_TOKENS
    results = {}
    quantizers = {
        "quantize_to_int8": (lambda x: cb.quantize_to_int8_cuda(x, symmetric=False),
                             lambda x: tb.quantize_to_int8_torch(x, symmetric=False),
                             "elementwise.py:162", False),
        "quantize_to_fp8": (cb.quantize_to_fp8_cuda, tb.quantize_to_fp8_torch,
                            "elementwise.py:208", True),
    }
    for name, (kern, plain, replaces, fp8) in quantizers.items():
        for k in (DIM, DIM + MLP):
            x = torch.randn(m_single, k, generator=g, device=dev, dtype=torch.bfloat16)
            x[0] = 0  # an all-zero row
            got, want = kern(x), plain(x)
            same = all(torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1 else a,
                                   b.view(torch.uint8) if b.dtype.itemsize == 1 else b)
                       for a, b in zip(got, want))
            log(f"[{name}] ({m_single}, {k}) bf16: q, scale{'' if fp8 else ', zp'} "
                f"bit-exact with the plain version: {same}")
            if not same:
                raise AssertionError(f"{name} disagrees with its plain version at K={k}")
        x = torch.randn(m_single, DIM, generator=g, device=dev, dtype=torch.bfloat16)
        b_ms, b_by = bound(_quantize_bytes(m_single, DIM, fp8), 8 * m_single * DIM, F32_FLOPS)
        results[name] = dict(
            name=name, route="cuda", source="fastdm_tpu_torch/csrc/quant.cu",
            replaces=f"fastdm_tpu/kernels/pallas/{replaces}", max_abs_err=0.0,
            ms=cuda_ms(lambda: kern(x), 50), plain_ms=cuda_ms(lambda: plain(x), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del x, got, want

    m, k, n = QKV_MLP
    w16 = torch.randn(k, n, generator=g, device=dev, dtype=torch.bfloat16)
    x16 = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    log(f"[w8a8] bf16 torch.matmul at the qkv_mlp shape ({m}x{k} @ {k}x{n}): "
        f"{cuda_ms(lambda: x16 @ w16, 20):.4f} ms (yardstick)")
    del w16, x16
    for quant in ("int8", "fp8"):
        name = f"{quant}_matmul"
        kern = getattr(cb, f"{name}_cuda")
        plain = getattr(tb, f"{name}_torch")
        worst = 0.0
        for k_, n_ in ((DIM, 3 * DIM + MLP), (DIM + MLP, DIM)):
            a, sa, lin, args = _w8a8_operands(quant, m, k_, n_, g, dev)
            got, want = kern(*args).float(), plain(*args).float()
            err = (got - want).abs()
            worst = max(worst, err.max().item())
            if quant == "int8":
                _int8_exact(args, f"{m}x{k_} @ {k_}x{n_}")  # raises on a mismatch
                ok, stated = True, "bit-exact, with and without azp"
            else:
                mag = (a.float().abs() @ lin.w.float().abs()) * (sa * lin.scale[None, :])
                ok = bool((err <= bf16_ulp(want) + 2.0**-16 * mag).all())
                stated = "1 bf16 ulp + 2^-16 * sa*sb*(|a|@|b|)"
                del mag
            log(f"[{name}] {m}x{k_} @ {k_}x{n_}: max_abs_err {err.max().item():.3e} "
                f"(tolerance {stated}): {ok}")
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"{name} disagrees with its plain version at K={k_}")
            del got, want, err
        a, sa, lin, args = _w8a8_operands(quant, m, k, n, g, dev)
        ms = cuda_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 2, 1)
        if quant == "int8":  # the s32 product alone: no azp, scales or bias
            lib_call = lambda: torch._int_mm(a, lin.w)  # noqa: E731
            lib = "torch._int_mm, s32 product only"
        else:
            lib_call = lambda: torch._scaled_mm(  # noqa: E731
                a, lin.w, scale_a=sa, scale_b=lin.scale.reshape(1, -1), bias=lin.bias,
                out_dtype=torch.bfloat16)
            lib = "torch._scaled_mm, row-wise scales, bias, bf16 out"
        try:  # a yardstick only; the port never calls it
            lib_ms = cuda_ms(lib_call, 20)
        except RuntimeError as e:
            lib_ms, lib = None, f"{lib}: not available here ({str(e).splitlines()[0]})"
        b_ms, b_by = bound(_gemm_bytes(m, k, n), 2 * m * n * k, INT8_FP8_OPS)
        log(f"[{name}] qkv_mlp {m}x{k} @ {k}x{n}: {ms:.4f} ms "
            f"({2 * m * n * k / ms / 1e9:.1f} TOP/s, {b_ms / ms:.1%} of the bound {b_ms:.4f} "
            f"ms), plain {plain_ms:.4f} ms, library {lib_ms} ms ({lib})")
        results[name] = dict(
            name=name, route="cuda",
            source=f"fastdm_tpu_torch/csrc/{'w8a8_gemm' if quant == 'int8' else 'fp8_gemm'}.cu",
            replaces=f"fastdm_tpu/kernels/pallas/matmul.py:{158 if quant == 'int8' else 182}",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms)
        del a, sa, lin, args

        # every GEMM and quantize shape of one forward, for the forward's split
        gemm_ms = quant_ms = gemm_bound = quant_bound = 0.0
        for (mm, kk, nn), count in W8A8_GEMMS.items():
            _, _, _, args = _w8a8_operands(quant, mm, kk, nn, g, dev)
            gemm_ms += count * cuda_ms(lambda: kern(*args), 5)
            gemm_bound += count * bound(_gemm_bytes(mm, kk, nn), 2 * mm * nn * kk,
                                        INT8_FP8_OPS)[0]
            x = torch.randn(mm, kk, generator=g, device=dev, dtype=torch.bfloat16)
            qk = quantizers[f"quantize_to_{quant}"][0]
            quant_ms += count * cuda_ms(lambda: qk(x), 5)
            quant_bound += count * bound(_quantize_bytes(mm, kk, quant == "fp8"),
                                         8 * mm * kk, F32_FLOPS)[0]
            del args, x
        log(f"[w8a8] {quant} forward ({W8A8_PER_FORWARD} linears, from kernel times at each "
            f"shape): GEMMs {gemm_ms:.3f} ms (bound {gemm_bound:.3f} ms), quantize "
            f"{quant_ms:.3f} ms (bound {quant_bound:.3f} ms)")
        torch.cuda.empty_cache()
    i8, f8 = results["int8_matmul"]["ms"], results["fp8_matmul"]["ms"]
    log(f"[w8a8] qkv_mlp: fp8 wgmma + TMA GEMM {f8:.4f} ms vs int8 wgmma + TMA GEMM {i8:.4f} ms "
        f"(fp8/int8 {f8 / i8:.3f}; the same tensor-core rate on one ring: the fp8 kernel "
        f"waits to promote every 32 products, the exact s32 sums need no wait)")
    return results


def _w4a4_operands(dev, g, m: int, k: int, n: int):
    """A bf16 activation with an all-zero row (the 1e-12 scale floor) and a
    random int4p QLinear."""
    import torch

    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    x[0] = 0
    return x, qlinear_random(g, k, n, quant="int4p", device=dev)


def _w4a4_bounds(m: int, k: int, n: int) -> dict:
    return {"quantize_to_int4": bound(_quantize_bytes(m, k, True), 8 * m * k, F32_FLOPS),
            "int4_matmul": bound(_gemm_bytes(m, k, n), 2 * m * n * k, INT8_FP8_OPS),
            "unpack_int4": bound(1.5 * k * n, k * n, F32_FLOPS)}


def _w4a4_split(dev, g, gemms: dict, label: str) -> dict:
    """The three W4A4 kernels held bit-exact to their plain versions at every
    (M, K, N) of `gemms` and timed there: {kernel: [ms, bound ms] per
    forward}, each shape's time times its count."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    split = {"quantize_to_int4": [0.0, 0.0], "int4_matmul": [0.0, 0.0],
             "unpack_int4": [0.0, 0.0]}
    for (m, k, n), count in gemms.items():
        x, lin = _w4a4_operands(dev, g, m, k, n)
        q, scale = cb.quantize_to_int4_cuda(x)
        w = cb.unpack_int4_cuda(lin.w4p)
        args = (q, w, scale, lin.scale, torch.bfloat16, lin.bias)
        checks = {"quantize_to_int4": all(torch.equal(a, b) for a, b in
                                          zip((q, scale), tb.quantize_to_int4_torch(x))),
                  "unpack_int4": (torch.equal(w, tb.unpack_int4_torch(lin.w4p))
                                  and w.stride() == (1, k)),
                  "int4_matmul": torch.equal(cb.int4_matmul_cuda(*args),
                                             tb.int4_matmul_torch(*args))}
        log(f"[w4a4] {label} {m}x{k} @ {k}x{n} (x{count} per forward): bit-exact with the "
            f"plain versions: {checks}")
        if not all(checks.values()):
            raise AssertionError(f"a W4A4 kernel disagrees with its plain version at "
                                 f"{label} {(m, k, n)}: {checks}")
        calls = {"quantize_to_int4": lambda: cb.quantize_to_int4_cuda(x),
                 "int4_matmul": lambda: cb.int4_matmul_cuda(*args),
                 "unpack_int4": lambda: cb.unpack_int4_cuda(lin.w4p)}
        for name, (b_ms, _) in _w4a4_bounds(m, k, n).items():
            split[name][0] += count * cuda_ms(calls[name], 5)
            split[name][1] += count * b_ms
        del x, lin, q, scale, w, args
    log(f"[w4a4] {label} forward ({sum(gemms.values())} linears each, from kernel times at "
        "each shape): " + ", ".join(f"{k} {v[0]:.3f} ms (bound {v[1]:.3f} ms)"
                                    for k, v in split.items()))
    torch.cuda.empty_cache()
    return split


def _w4a4_kernels(dev) -> dict:
    """The W4A4 kernels -- the int4 quantizer (A), the int4 GEMM on the s8
    wgmma ring (B) and the int4p unpack (C) -- held bit-exact to their plain
    versions at every int4 shape of a FLUX int4p quant_mods forward (the M = 1
    modulation GEMMs and K = 15360 included, an all-zero activation row in
    each), each kernel timed at each shape (the forward's split), and at the
    qkv_mlp shape beside its bound, its plain version and, for the GEMM,
    torch._int_mm (the s32 product only)."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    g = torch.Generator(device=dev).manual_seed(2)  # the other phases' draws stay as they were
    _w4a4_split(dev, g, W4A4_GEMMS, "FLUX int4p")
    m, k, n = QKV_MLP
    x, lin = _w4a4_operands(dev, g, m, k, n)
    q, scale = tb.quantize_to_int4_torch(x)
    w = tb.unpack_int4_torch(lin.w4p)
    args = (q, w, scale, lin.scale, torch.bfloat16, lin.bias)
    bounds = _w4a4_bounds(m, k, n)
    timed = {"quantize_to_int4": (lambda: cb.quantize_to_int4_cuda(x),
                                  lambda: tb.quantize_to_int4_torch(x), "quant.cu", None),
             "int4_matmul": (lambda: cb.int4_matmul_cuda(*args),
                             lambda: tb.int4_matmul_torch(*args), "w8a8_gemm.cu",
                             lambda: torch._int_mm(q, w)),
             "unpack_int4": (lambda: cb.unpack_int4_cuda(lin.w4p),
                             lambda: tb.unpack_int4_torch(lin.w4p), "int4_pack.cu", None)}
    # the ops replace jnp-only code of the W4A4 path (no Pallas kernel)
    replaces = {"quantize_to_int4": "fastdm_tpu/kernels/jnp_backend/impl.py:143",
                "int4_matmul": "fastdm_tpu/kernels/jnp_backend/impl.py:163",
                "unpack_int4": "fastdm_tpu/layers/qlinear.py:75"}
    results = {}
    for name, (kern, plain, src, lib_call) in timed.items():
        b_ms, b_by = bounds[name]
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 2, 1)
        lib_ms = None
        if lib_call is not None:  # a yardstick only; the port never calls it
            try:
                lib_ms = cuda_ms(lib_call, 20)
            except RuntimeError as e:
                log(f"[w4a4] torch._int_mm not available here ({str(e).splitlines()[0]})")
        log(f"[{name}] qkv_mlp {m}x{k} @ {k}x{n}: {ms:.4f} ms ({b_ms / ms:.1%} of the bound "
            f"{b_ms:.4f} ms, {b_by}), plain {plain_ms:.4f} ms, library {lib_ms} ms"
            + (" (torch._int_mm, s32 product only)" if lib_call is not None else ""))
        results[name] = dict(name=name, route="cuda", source=f"fastdm_tpu_torch/csrc/{src}",
                             replaces=replaces[name], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del x, lin, q, scale, w, args, timed
    torch.cuda.empty_cache()
    return results


def _radial():
    """examples/sparse/radial_attn_wan.json (radial, block_size 128, decay 0.3,
    dense_layers 1), with dense_steps cut to WAN_DENSE_STEPS."""
    from fastdm_tpu_torch.sparse.xsparse import SparseAttn

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "sparse", "radial_attn_wan.json")) as f:
        cfg = json.load(f)
    cfg["dense_steps"] = WAN_DENSE_STEPS
    return SparseAttn.from_dict(cfg)


def _wan_shape(frames: int):
    """(latent frames, latent height, latent width, patch tokens) of a
    WAN_H x WAN_W clip."""
    lf, lh, lw = (frames - 1) // 4 + 1, WAN_H // 8, WAN_W // 8
    return lf, lh, lw, lf * (lh // 2) * (lw // 2)


def _qk_excess(got, want, head_dim: int = 0):
    """(max of |got - want| minus its tolerance, max |got - want|): the
    tolerance is one bf16 ulp of the value plus two of its rotation pair's
    magnitude — the normalized value, rounded to bf16 before the rotation,
    may sit one ulp away (f32 sum order), and the rotation mixes the pair.
    Pairs are interleaved, or with a head_dim half-split within each head."""
    worst = err = 0.0
    for a, w in zip(got, want):
        w = w.float()
        if head_dim:
            pair = w.reshape(*w.shape[:-1], -1, 2, head_dim // 2)
            mag = pair.norm(dim=-2, keepdim=True).expand_as(pair).reshape(w.shape)
        else:
            pair = w.reshape(*w.shape[:-1], -1, 2)
            mag = pair.norm(dim=-1, keepdim=True).expand_as(pair).reshape(w.shape)
        e = (a.float() - w).abs()
        worst = max(worst, (e - bf16_ulp(w) - 2 * bf16_ulp(mag)).max().item())
        err = max(err, e.max().item())
    return worst, err


def _wan_kernels(dev, g) -> dict:
    """qk_norm_rope on the fused QKV output of a Wan2.2-A14B self-attention at
    480x832x81 (32760 tokens, q|k read in place from (1, S, 15360)),
    qk_norm_rope2 on the split path's per-chunk q and k ((1, 4095, 5120) at
    480p, (1, 9450, 5120) as a 720p chunk), with the real 3D RoPE tables; then
    the four sparse-attention walks (_sparse_walks)."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.models.wan import WanConfig, wan_rope_cos_sin

    results = {}
    lf, lh, lw, s = _wan_shape(WAN_FRAMES)
    d, hd = WAN_DIM, HEAD_DIM
    cos, sin = wan_rope_cos_sin(WanConfig(), lf, lh, lw, device=dev)
    gq = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).bfloat16()
    gk = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).bfloat16()
    qk_ops = 7  # per element: square-add, two multiplies, then 3 of the pair's rotation

    # --- qk_norm_rope, the fused form
    qkv = (torch.randn(1, s, 3 * d, generator=g, device=dev) * 2).bfloat16()
    kern = lambda: cb.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, inner_dim=d)  # noqa: E731
    plain = lambda: tb.qk_norm_rope_torch(qkv, gq, gk, hd, cos, sin, inner_dim=d)  # noqa: E731
    worst, err = _qk_excess(kern(), plain())
    log(f"[qk_norm_rope] qkv (1, {s}, {3 * d}) inner_dim {d}: max_abs_err {err:.3e}, "
        f"excess over 1 ulp + 2 ulp of the pair's magnitude {worst:.3e} (must be <= 0)")
    if not worst <= 0:
        raise AssertionError("qk_norm_rope disagrees with its plain version")
    nbytes = 4 * s * d * 2 + 2 * s * (hd // 2) * 4 + 2 * d * 2
    b_ms, b_by = bound(nbytes, qk_ops * 2 * s * d, F32_FLOPS)
    results["qk_norm_rope"] = dict(
        name="qk_norm_rope", route="cuda", source="fastdm_tpu_torch/csrc/qk_norm_rope.cu",
        replaces="fastdm_tpu/kernels/pallas/elementwise.py:341", max_abs_err=err,
        ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 3, 1), bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    # the half-split (neox) layout on the same rows, held to the same bound
    kern = lambda: cb.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, True, inner_dim=d)  # noqa: E731
    plain = lambda: tb.qk_norm_rope_torch(qkv, gq, gk, hd, cos, sin, True,  # noqa: E731
                                          inner_dim=d)
    worst, err = _qk_excess(kern(), plain(), hd)
    ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3, 1)
    log(f"[qk_norm_rope] half-split qkv (1, {s}, {3 * d}) inner_dim {d}: max_abs_err {err:.3e}, "
        f"excess over 1 ulp + 2 ulp of the pair's magnitude {worst:.3e} (must be <= 0); "
        f"{ms:.4f} ms ({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, {b_by}), interleaved "
        f"{results['qk_norm_rope']['ms']:.4f} ms; plain {plain_ms:.4f} ms")
    if not worst <= 0:
        raise AssertionError("qk_norm_rope (half-split) disagrees with its plain version")
    del qkv

    # --- qk_norm_rope2, the split form's per-chunk operands
    for s2 in (4095, 9450):
        q = (torch.randn(1, s2, d, generator=g, device=dev) * 2).bfloat16()
        k = (torch.randn(1, s2, d, generator=g, device=dev) * 2).bfloat16()
        c2, n2 = cos[:s2], sin[:s2]
        kern = lambda: cb.qk_norm_rope2_cuda(q, k, gq, gk, hd, c2, n2)  # noqa: E731
        plain = lambda: tb.qk_norm_rope2_torch(q, k, gq, gk, hd, c2, n2)  # noqa: E731
        worst, err = _qk_excess(kern(), plain())
        ms = cuda_ms(kern, 50)
        log(f"[qk_norm_rope2] q, k (1, {s2}, {d}): max_abs_err {err:.3e}, excess {worst:.3e} "
            f"(must be <= 0); {ms:.4f} ms")
        if not worst <= 0:
            raise AssertionError(f"qk_norm_rope2 disagrees with its plain version at S={s2}")
        nw, _ = _qk_excess(cb.qk_norm_rope2_cuda(q, k, gq, gk, hd, c2, n2, True),
                           tb.qk_norm_rope2_torch(q, k, gq, gk, hd, c2, n2, True), hd)
        log(f"[qk_norm_rope2] half-split q, k (1, {s2}, {d}): excess {nw:.3e} (must be <= 0)")
        if not nw <= 0:
            raise AssertionError(f"qk_norm_rope2 (half-split) disagrees with its plain version "
                                 f"at S={s2}")
        if s2 == 4095:
            b_ms, b_by = bound(4 * s2 * d * 2 + 2 * s2 * (hd // 2) * 4 + 2 * d * 2,
                               qk_ops * 2 * s2 * d, F32_FLOPS)
            results["qk_norm_rope2"] = dict(
                name="qk_norm_rope2", route="cuda",
                source="fastdm_tpu_torch/csrc/qk_norm_rope.cu",
                replaces="fastdm_tpu/kernels/pallas/elementwise.py:416", max_abs_err=err,
                ms=ms, plain_ms=cuda_ms(plain, 5, 1), bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
        del q, k

    del cos, sin
    results.update(_sparse_walks(dev, g))
    return results


# the sparse mode -> (its kernel's name in the counts and the kernels line,
# the TPU kernel it replaces)
SPARSE_KERNEL = {"super": ("gather_super", "attention.py:1002"),
                 "fine": ("gather_fine", "attention.py:759"),
                 "coarse": ("gather_coarse", "attention.py:1069"),
                 "mask": ("sparse_mask", "attention.py:1122")}


def _walk(mode: str, cfg, tables, q, k, v, plain: bool = False):
    """One self-attention of the mode on its tables (kernel or plain version)."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    h, hd = cfg.num_attention_heads, cfg.attention_head_dim
    bq, grp, fine = cfg.sparse_gather_fine_blocks
    sb = cfg.sparse_gather_superblock
    if mode == "mask":
        fn = tb.sdpa_sparse_torch if plain else cb.sparse_attention_cuda
        return fn(q, k, v, h, h, hd, sparse_mask=tables, block_q=128, block_k=128)
    if mode == "coarse":
        fn = tb.sdpa_gather_torch if plain else cb.gather_sparse_attention_cuda
        bq, bk = cfg.sparse_gather_blocks
        return fn(q, k, v, *tables, h, h, hd, block_q=bq, block_k=bk)
    if mode == "fine":
        fn = tb.sdpa_gather_fine_torch if plain else cb.gather_fine_attention_cuda
        return fn(q, k, v, *tables, h, h, hd, block_q=bq, group=grp, fine=fine)
    fn = tb.sdpa_gather_super_torch if plain else cb.gather_super_attention_cuda
    return fn(q, k, v, *tables, h, h, hd, block_q=bq, group=grp // sb, fine=fine, superblock=sb)


def _walk_tables(mode: str, cfg, tables, s: int):
    """(allowed (nq, S) bool: the keys each table row allows, block_q,
    tables that allow every key, the tables with row 5 emptied)."""
    import numpy as np
    import torch

    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.sparse.xsparse import fine_tables_from_mask, mask_to_block_lists, \
        super_tables_from_mask

    dev = tables[0].device
    to = lambda ts: tuple(torch.from_numpy(t).to(dev) for t in ts)  # noqa: E731
    tok = torch.arange(s, device=dev)
    bq, grp, fine = cfg.sparse_gather_fine_blocks
    sb = cfg.sparse_gather_superblock
    if mode == "mask":
        m = tables[0, 0].bool()
        empty = tables.clone()
        empty[:, :, 5] = 0
        return m[:, tok // 128], 128, torch.ones_like(tables), empty
    if mode == "coarse":
        bq, bk = cfg.sparse_gather_blocks
        m = tb.gather_lists_allowed(*tables, s, bk)
        full = to(mask_to_block_lists(np.ones(tuple(m.shape), bool))[:2])
        counts = tables[1].clone()
        counts[5, 0] = 0
        return m[:, tok // bk], bq, full, (tables[0], counts)
    nq, nfine = tables[2].shape[0], -(-s // fine)
    rows = tables[2].clone()
    rows[5, 1] = 0
    empty = (tables[0], tables[1], rows)
    if mode == "fine":
        full = to(fine_tables_from_mask(np.ones((nq, nfine), bool), grp, fine, s))
        return tb.gather_fine_allowed(*tables, s, fine), bq, full, empty
    full = to(super_tables_from_mask(np.ones((nq, nfine), bool), grp // sb, sb))
    return tb.gather_super_allowed(*tables, s, fine, sb), bq, full, empty


def _sparse_walks(dev, g) -> dict:
    """The sparse-attention kernel in each mode of the engine
    (FASTDM_SPARSE_GATHER: super, fine, coarse, mask) on that mode's radial
    tables of the 81-frame 480x832 video (32760 tokens, 40 heads of 128),
    held to its plain version with sdpa's tolerance (1e-3 + 2 bf16 ulp, rel
    L2 5e-3); tables that allow every key give sdpa's result bit for bit (all
    four walks run on sdpa's wgmma + TMA kernel: the same 128-key tiles in the
    same order through the same code), and an emptied table row gives zeros.
    The dense sdpa kernel is held to its plain version here too, with the
    FLUX tolerance: this shape runs 40 times in each dense Wan forward, and
    its 256 KV tiles (the last one 120 keys) pass through the ring. Timed
    beside sdpa, the plain version and F.scaled_dot_product_attention with the
    mode's dense boolean mask (the same for every head here); the bound counts
    the allowed keys only."""
    import torch
    import torch.nn.functional as F

    from fastdm_tpu_torch.engine import wan_sparse_tables
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend
    from fastdm_tpu_torch.models.wan import WanConfig

    results = {}
    lf, _, _, s = _wan_shape(WAN_FRAMES)
    h, hd = WAN_HEADS, HEAD_DIM
    q, k, v = (torch.randn(1, s, WAN_DIM, generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    got = cb.sdpa_cuda(q, k, v, h, h, hd)
    want = torch_backend.sdpa_torch(q, k, v, h, h, hd)
    e = (got.float() - want.float()).abs()
    rel = (e.norm() / want.float().norm()).item()
    excess = (e - 1e-3 - 2 * bf16_ulp(want)).max().item()
    log(f"[sdpa] wan q{tuple(q.shape)} ({s // 128} KV tiles of 128 + {s % 128}): max_abs_err "
        f"{e.max().item():.3e}, rel L2 {rel:.3e} (tolerance 1e-3 + 2 ulp, rel L2 5e-3)")
    if not (excess <= 0 and rel <= 5e-3 and torch.isfinite(got).all()):
        raise AssertionError("sdpa wan disagrees with its plain version")
    sdpa_out = got
    del want, e
    torch.cuda.empty_cache()
    heads = lambda t: t.view(1, s, h, hd).transpose(1, 2)  # noqa: E731
    flops = 4 * s * s * hd * h
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 3)
    sdpa_ms = _sdpa_ms(f"Wan (1, {s}, {h}x{hd})", q, k, v, h, hd, flops,
                       bound(4 * q.numel() * 2, flops, BF16_FLOPS)[0], lib_ms, 3)
    for mode, (name, replaces) in SPARSE_KERNEL.items():
        cfg, tables = wan_sparse_tables(_radial(), WanConfig(), s, lf, dev, mode)
        allowed, bq, full, empty = _walk_tables(mode, cfg, tables, s)
        kern = lambda t=tables: _walk(mode, cfg, t, q, k, v)  # noqa: E731
        plain = lambda: _walk(mode, cfg, tables, q, k, v, plain=True)  # noqa: E731
        got = kern()
        want = plain()
        e = (got.float() - want.float()).abs()
        rel = (e.norm() / want.float().norm()).item()
        excess = (e - 1e-3 - 2 * bf16_ulp(want)).max().item()
        err = e.max().item()
        shapes = (tuple(tables.shape) if mode == "mask"
                  else " ".join(str(tuple(t.shape)) for t in tables))
        log(f"[{name}] {mode} tables {shapes}: max_abs_err {err:.3e}, rel L2 {rel:.3e} "
            f"(tolerance 1e-3 + 2 ulp, rel L2 5e-3)")
        if not (excess <= 0 and rel <= 5e-3 and torch.isfinite(got).all()):
            raise AssertionError(f"{name} disagrees with its plain version")
        del want, e
        # every walk runs on sdpa's kernel
        same_dense = torch.equal(kern(full), sdpa_out)
        emptied = kern(empty)
        rows = slice(5 * bq, 6 * bq)
        zero_row = not emptied[:, rows].any()
        others = (torch.equal(emptied[:, :rows.start], got[:, :rows.start])
                  and torch.equal(emptied[:, rows.stop:], got[:, rows.stop:]))
        log(f"[{name}] tables allowing every key == sdpa bit for bit: "
            f"{same_dense}; emptied row 5 gives zeros: {zero_row}, other rows unchanged: "
            f"{others}")
        if not (same_dense and zero_row and others):
            raise AssertionError(f"{name}: all-active or empty-row check failed")
        del emptied, full, empty
        q_rows = torch.clamp(s - torch.arange(allowed.shape[0], device=dev) * bq, max=bq)
        active = (allowed.sum(dim=1) * q_rows).sum().item()  # allowed (q, k) pairs per head
        ms = cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain, 1, 0)
        mask = allowed[torch.arange(s, device=dev) // bq][None, None]
        lib = "F.scaled_dot_product_attention with the dense boolean mask"
        try:  # a yardstick only; the port never calls it
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=mask), 3)
        except RuntimeError as exc:
            lib_ms, lib = None, f"{lib}: not available here ({str(exc).splitlines()[0]})"
        del mask, allowed
        b_ms, b_by = bound(4 * q.numel() * 2, 4 * active * hd * h, BF16_FLOPS)
        log(f"[{name}] {mode}: allowed keys {active / s**2:.4f} of dense attention; {ms:.4f} ms "
            f"(sparse/sdpa {ms / sdpa_ms:.3f}, sdpa "
            f"{sdpa_ms:.4f} ms); plain {plain_ms:.1f} ms; library {lib_ms} ms ({lib}); bound "
            f"{b_ms:.4f} ms by {b_by}")
        results[name] = dict(
            name=name, route="cuda", source="fastdm_tpu_torch/csrc/flash_attn.cu",
            replaces=f"fastdm_tpu/kernels/pallas/{replaces}", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del got
        torch.cuda.empty_cache()
    del q, k, v, sdpa_out
    torch.cuda.empty_cache()
    return results


def sdxl_levels(cfg):
    """(tokens per image, width) of SDXL's two Transformer2D levels at
    SDXL_H x SDXL_W: down1/up1, then down2/mid/up0."""
    lh, lw = SDXL_H // 8, SDXL_W // 8
    return ((lh // 2) * (lw // 2), cfg.block_channels[1]), \
        ((lh // 4) * (lw // 4), cfg.block_channels[2])


def sdxl_level_blocks(cfg):
    """(BasicTransformerBlocks, Transformer2Ds) per level, read off
    models/sdxl.py: down1 2 and up1 3 Transformer2Ds of attn_layers[1]
    blocks; down2 2, mid 1 and up0 3 of attn_layers[2]."""
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]
    return (5 * n1, 5), (6 * n2, 6)


def sdxl_w8a8_gemms(cfg) -> dict:
    """The W8A8 linears of one CFG forward (batch SDXL_BATCH): (M, K, N) ->
    count. Per block self qkv, self out, cross q, cross kv (on the text),
    cross out, ff proj (GEGLU, 8C), ff out; per Transformer2D proj_in and
    proj_out; per resnet time_emb_proj (M = batch: one row per image). The
    time and add embedders stay bf16."""
    b, gemms = SDXL_BATCH, {}

    def add(key, n):
        gemms[key] = gemms.get(key, 0) + n

    for (tokens, c), (blocks, t2ds) in zip(sdxl_levels(cfg), sdxl_level_blocks(cfg)):
        m = b * tokens
        add((m, c, 3 * c), blocks)
        add((m, c, c), 3 * blocks + 2 * t2ds)
        add((b * SDXL_TEXT, cfg.cross_attention_dim, 2 * c), blocks)
        add((m, c, 8 * c), blocks)
        add((m, 4 * c, c), blocks)
    c0, c1, c2 = cfg.block_channels
    # resnets by output width: down0 2 + up2 3; down1 2 + up1 3; down2 2, mid 2, up0 3
    for cout, n in ((c0, 5), (c1, 5), (c2, 7)):
        add((b, cfg.time_embed_dim, cout), n)
    return gemms


def sdxl_forward_launches(cfg) -> dict:
    """Kernel launches of one SDXL UNet forward (no IP-Adapter tokens): per
    block two sdpa (self, cross) and one gelu_and_mul; the W8A8 linears of
    sdxl_w8a8_gemms in cfg.quant. Convs, GroupNorms, LayerNorms and the
    embedders launch no kernel of the port."""
    blocks = sum(n for n, _ in sdxl_level_blocks(cfg))
    counts = dict.fromkeys(_launch_counts(), 0)
    counts.update(sdpa=2 * blocks, gelu_and_mul=blocks)
    if cfg.quant is not None:
        w8a8 = sum(sdxl_w8a8_gemms(cfg).values())
        counts[f"quantize_to_{cfg.quant}"] = counts[f"{cfg.quant}_matmul"] = w8a8
    return counts


def _sdxl_kernels(dev, g) -> dict:
    """gelu_and_mul on the GEGLU projection outputs of both levels, held
    within one bf16 ulp of its plain version (both round once from f32; erff
    and ATen's erf may differ by an f32 ulp); sdpa at SDXL's four attention
    shapes with q|k|v read in place from the fused projections, the
    self-attentions held to the FLUX shape's tolerance, the 77-key
    cross-attentions to the small cases' plus relative L2 5e-3 (as the
    sparse walks' short rows); the int8 and fp8 quantizers and GEMMs at every
    W8A8 shape of the forward (quantizers and the int8 GEMM bit-exact, fp8 as
    in _w8a8_kernels). Returns the gelu_and_mul entry of the kernels line
    (timed at the larger shape); the sdpa times at D 64 are logged."""
    import torch
    import torch.nn.functional as F

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.models.sdxl import SDXLConfig

    cfg = SDXLConfig()
    b, hd = SDXL_BATCH, cfg.head_dim
    results = {}
    for (tokens, c), (blocks, _) in zip(sdxl_levels(cfg), sdxl_level_blocks(cfg)):
        x = (torch.randn(b, tokens, 8 * c, generator=g, device=dev) * 2).bfloat16()
        got, want = cb.gelu_and_mul_cuda(x), tb.gelu_and_mul_torch(x)
        e = (got.float() - want.float()).abs()
        ulps = (e / bf16_ulp(want)).max().item()
        ms = cuda_ms(lambda: cb.gelu_and_mul_cuda(x), 50)
        plain_ms = cuda_ms(lambda: tb.gelu_and_mul_torch(x), 10)
        n = want.numel()
        b_ms, b_by = bound(3 * n * 2, GELU_MUL_OPS * n, F32_FLOPS)
        log(f"[gelu_and_mul] {tuple(x.shape)} -> {tuple(got.shape)} bf16 ({blocks} per forward): "
            f"max_abs_err {e.max().item():.3e}, max {ulps:.2f} bf16 ulp (tolerance 1 ulp); "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({3 * n * 2 / ms / 1e6:.0f} GB/s)")
        if not ulps <= 1.0 or not torch.isfinite(got).all():
            raise AssertionError(f"gelu_and_mul disagrees with its plain version: {ulps} ulp")
        results.setdefault("gelu_and_mul", dict(
            name="gelu_and_mul", route="cuda", source="fastdm_tpu_torch/csrc/gelu_mul.cu",
            replaces="fastdm_tpu/kernels/pallas/elementwise.py:123",
            max_abs_err=e.max().item(), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        del x, got, want, e

        # sdpa, self- and cross-attention, on strided views of the projections
        h = c // hd
        qkv = torch.randn(b, tokens, 3 * c, generator=g, device=dev, dtype=torch.bfloat16)
        kv = torch.randn(b, SDXL_TEXT, 2 * c, generator=g, device=dev, dtype=torch.bfloat16)
        q = qkv[..., :c]
        for kind, k, v in (("self", qkv[..., c:2 * c], qkv[..., 2 * c:]),
                           ("cross", kv[..., :c], kv[..., c:])):
            got = cb.sdpa_cuda(q, k, v, h, h, hd)
            want = tb.sdpa_torch(q, k, v, h, h, hd)
            e = (got.float() - want.float()).abs()
            rel = (e.norm() / want.float().norm()).item()
            if kind == "self":
                tol, stated = 1e-3 + 2 * bf16_ulp(want), "1e-3 + 2 ulp, rel L2 5e-3"
            else:  # 77 keys: larger outputs, p rounded to bf16 against another max per tile
                tol, stated = 1e-2 + 1e-2 * want.float().abs(), "1e-2 + 1e-2*|plain|, rel L2 5e-3"
            excess = (e - tol).max().item()
            skv = k.shape[1]
            plain_ms = cuda_ms(lambda: tb.sdpa_torch(q, k, v, h, h, hd), 1, 1)
            heads = lambda t: t.unflatten(-1, (h, hd)).transpose(1, 2)  # noqa: E731
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k),
                                                                    heads(v)), 10)
            b_ms, b_by = bound(2 * (2 * q.numel() + 2 * b * skv * c), 4 * b * tokens * skv * c,
                               BF16_FLOPS)
            ms = cuda_ms(lambda: cb.sdpa_cuda(q, k, v, h, h, hd), 10)
            log(f"[sdpa] SDXL {kind} q{tuple(q.shape)} k{tuple(k.shape)} {h}x{hd} heads "
                f"({blocks} per forward): max_abs_err {e.max().item():.3e}, rel L2 {rel:.3e} "
                f"(tolerance {stated}); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
            if not (excess <= 0 and rel <= 5e-3 and torch.isfinite(got).all()):
                raise AssertionError(f"sdpa disagrees with its plain version at SDXL {kind} "
                                     f"{tokens}x{c}")
            del got, want, e
        del qkv, kv, q
        torch.cuda.empty_cache()

    for quant in ("int8", "fp8"):
        quantize = getattr(cb, f"quantize_to_{quant}_cuda")
        quantize_plain = getattr(tb, f"quantize_to_{quant}_torch")
        kw = {"symmetric": False} if quant == "int8" else {}
        kern, plain = getattr(cb, f"{quant}_matmul_cuda"), getattr(tb, f"{quant}_matmul_torch")
        for (m, k, n), count in sdxl_w8a8_gemms(cfg).items():
            a, sa, lin, args = _w8a8_operands(quant, m, k, n, g, dev)
            x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
            same_q = all(torch.equal(u.view(torch.uint8) if u.dtype.itemsize == 1 else u,
                                     w.view(torch.uint8) if w.dtype.itemsize == 1 else w)
                         for u, w in zip(quantize(x, **kw), quantize_plain(x, **kw)))
            got, want = kern(*args).float(), plain(*args).float()
            err = (got - want).abs()
            if quant == "int8":
                _int8_exact(args, f"SDXL {m}x{k} @ {k}x{n}")  # raises on a mismatch
                ok, stated = True, "bit-exact with and without azp"
            else:
                mag = (a.float().abs() @ lin.w.float().abs()) * (sa * lin.scale[None, :])
                ok = bool((err <= bf16_ulp(want) + 2.0**-16 * mag).all())
                stated = "within 1 ulp + 2^-16 sa*sb*(|a|@|b|)"
                del mag
            log(f"[{quant} w8a8] SDXL {m}x{k} @ {k}x{n} ({count} per forward): quantize "
                f"bit-exact {same_q}, GEMM max_abs_err {err.max().item():.3e} ({stated}: {ok})")
            if not (same_q and ok and torch.isfinite(got).all()):
                raise AssertionError(f"{quant} W8A8 kernels disagree with their plain versions "
                                     f"at SDXL {m}x{k} @ {k}x{n}")
            del a, sa, lin, args, x, got, want, err
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 2

# TeaCache as bench.py's FLUX default (threshold 0.25 with random weights,
# the reference's published 5-term polynomial)
TEACACHE = dict(cache_algorithm="teacache", enable_caching=True, threshold=0.25,
                coefficients=(4.98651651e02, -2.83781631e02, 5.58554382e01,
                              -3.82021401e00, 2.64230861e-01))
STEPS = 4
# Relative L2 of a full-width forward on the kernels against the same forward
# on the plain versions, per weight format: twice the first value measured on
# an H100 80GB HBM3 (bf16 1.533e-2, int8 2.895e-2, fp8 5.336e-2, int4p with
# quant_mods 7.448e-2). The quantized formats sit higher although their
# kernels match their plain versions (the integer ones bit for bit): each
# per-token quantization turns a one-ulp difference upstream (rmsnorm, sdpa)
# into a whole quantization step in a few elements, and int4's steps are the
# coarsest. A wrong tile, scale or layout gives O(1).
FORWARD_REL_L2_TOL = {None: 3e-2, "int8": 6e-2, "fp8": 1.1e-1, "int4p": 1.49e-1}
W8A8_OPS = ("quantize_to_int8", "quantize_to_fp8", "int8_matmul", "fp8_matmul")
W4A4_OPS = ("quantize_to_int4", "int4_matmul", "unpack_int4")
# (quant, request seeds): the bf16 path of the first slice, then W8A8, then
# int4p with the AdaLN modulations quantized too
PATHS = ((None, (11, 12, 13)), ("int8", (21, 22, 23)), ("fp8", (31,)), ("int4p", (41, 42, 43)))
# the quantized paths' kernels: (quantize, GEMM[, unpack]) and their launches
# per computed forward
QUANT_KERNELS = {"int8": (("quantize_to_int8", "int8_matmul"), W8A8_PER_FORWARD),
                 "fp8": (("quantize_to_fp8", "fp8_matmul"), W8A8_PER_FORWARD),
                 "int4p": (W4A4_OPS, W4A4_PER_FORWARD)}
PATH_KERNELS = {q: ("rmsnorm", "rotembd", "sdpa") + (QUANT_KERNELS[q][0] if q else ())
                for q, _ in PATHS}


def _conditioning(dev, seed: int, cfg, seq: int):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    latents = torch.randn(1, seq, cfg.in_channels, generator=g, device=dev)
    encoder = torch.randn(1, TXT_TOKENS, cfg.joint_attention_dim, generator=g, device=dev,
                          dtype=torch.bfloat16)
    pooled = torch.randn(1, cfg.pooled_projection_dim, generator=g, device=dev,
                         dtype=torch.bfloat16)
    return latents, encoder, pooled


def _launch_counts():
    from fastdm_tpu_torch.kernels import cuda_backend as cb

    return {"qk_norm_rope": cb.qk_norm_rope_cuda.launches,
            "qk_norm_rope2": cb.qk_norm_rope2_cuda.launches,
            "gather_super": cb.gather_super_attention_cuda.launches,
            "gather_fine": cb.gather_fine_attention_cuda.launches,
            "gather_coarse": cb.gather_sparse_attention_cuda.launches,
            "sparse_mask": cb.sparse_attention_cuda.launches,
            "sdpa": cb.sdpa_cuda.launches, "rmsnorm": cb.rms_norm_cuda.launches,
            "rotembd": cb.rotary_pos_embedding_cuda.launches,
            "quantize_to_int8": cb.quantize_to_int8_cuda.launches,
            "int8_matmul": cb.int8_matmul_cuda.launches,
            "quantize_to_fp8": cb.quantize_to_fp8_cuda.launches,
            "fp8_matmul": cb.fp8_matmul_cuda.launches,
            "quantize_to_int4": cb.quantize_to_int4_cuda.launches,
            "int4_matmul": cb.int4_matmul_cuda.launches,
            "unpack_int4": cb.unpack_int4_cuda.launches,
            "gelu_and_mul": cb.gelu_and_mul_cuda.launches}


def _serve_path(dev, quant, seeds, vae, vae_cfg, summary: dict) -> dict:
    """FLUX.1-dev at full width in one weight format: requests, launch check,
    kernel forward vs plain forward (int8: also the image-conditioned
    requests, their numbers into `summary`). Returns the launches of the
    path's kernels."""
    import torch

    from fastdm_tpu_torch.caching.config import TeaCacheConfig
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_forward, flux_init_random, \
        flux_rope_cache
    from fastdm_tpu_torch.pipeline.denoise import flux_unpack_latents, make_flux_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, \
        flow_match_shift_mu
    from fastdm_tpu_torch.pipeline.vae import vae_decode

    label = quant or "bf16"
    # FLUX.1-dev: 19 dual + 38 single blocks, 24x128 heads
    cfg = FluxConfig(quant=quant, quant_mods=quant == "int4p")
    ht, wt = FLUX_HT, FLUX_WT      # 1024x2048 pixels
    t0 = time.perf_counter()
    params = flux_init_random(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[slice {label}] FLUX.1-dev {label} random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.1f} GiB) in {time.perf_counter() - t0:.1f} s")
    sched = FlowMatchEulerScheduler.create(STEPS, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * wt))
    run = make_flux_denoiser(cfg, sched, STEPS, TeaCacheConfig(**TEACACHE), guidance_scale=3.5)
    cos, sin = flux_rope_cache(cfg, TXT_TOKENS, ht, wt, device=dev)

    torch.cuda.reset_peak_memory_stats()
    computed = 0
    cuda_backend.reset_launch_counts()
    for seed in seeds:
        latents, encoder, pooled = _conditioning(dev, seed, cfg, ht * wt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, skips = run(params, latents, encoder, pooled, cos, sin)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = vae_decode(vae, vae_cfg, flux_unpack_latents(lat, ht, wt))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        computed += STEPS - skips
        finite = bool(torch.isfinite(img).all())
        log(f"[slice {label}] request seed={seed} 1024x2048 {STEPS} steps: {t2 - t0:.3f} s "
            f"(denoise {t1 - t0:.3f} s, VAE decode {t2 - t1:.3f} s), TeaCache skipped "
            f"{skips}/{STEPS}, image {tuple(img.shape)} finite={finite}")
        if not finite or tuple(img.shape) != (1, 16 * ht, 16 * wt, 3):
            raise AssertionError(f"{label} request seed={seed} produced a bad image")
    counts = _launch_counts()
    log(f"[slice {label}] kernel launches over {len(seeds)} requests ({computed} computed "
        f"forwards): {counts}")
    mine = {k: counts[k] for k in PATH_KERNELS[quant]}
    if min(mine.values()) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: {counts}")
    if quant is not None:
        ops, per = QUANT_KERNELS[quant]
        # with quant_mods, TeaCache's probe (dual block 0's norm1 modulation)
        # is a quantized linear too, run once by every forward, skipped or not
        probes = len(seeds) * STEPS if cfg.quant_mods else 0
        want = per * computed + probes
        others = {k for o, _ in QUANT_KERNELS.values() for k in o} - set(ops)
        if any(counts[k] != want for k in ops) or any(counts[k] for k in others):
            raise AssertionError(f"{label}: expected {per} x {computed} + {probes} = {want} "
                                 f"launches of each of {ops} and none of {sorted(others)}, got "
                                 f"{counts}")
        log(f"[slice {label}] launch check: {per} x {computed} computed forwards + {probes} "
            f"TeaCache probes = {want} launches of each of {ops}, none of the other formats' "
            "kernels, as counted")
    log(f"[slice {label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # one full-width forward on the kernels vs the same forward on the plain
    # versions; for W8A8 also vs the forward with only the W8A8 ops plain,
    # which the int8 kernels must match bit for bit
    latents, encoder, pooled = _conditioning(dev, 99, cfg, ht * wt)
    t = torch.full((1,), float(sched.sigmas[0]), device=dev)
    guidance = torch.full((1,), 3.5, device=dev)
    x = latents.to(torch.bfloat16)

    def forward(plain_ops=()):
        with kernel_registry.plain_on_device(plain_ops):
            return flux_forward(params, cfg, x, encoder, pooled, t, cos, sin, guidance).float()

    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    tol = FORWARD_REL_L2_TOL[quant]
    with torch.inference_mode():
        forward()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_p = forward(plain_ops=None)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if quant is not None:
            exact = quant != "fp8"  # integer GEMMs
            fmt = "W4A4" if quant == "int4p" else "W8A8"
            out_w = forward(plain_ops=W4A4_OPS if quant == "int4p" else W8A8_OPS)
            rel_w, same_w = rel_l2(out_k, out_w), torch.equal(out_k, out_w)
            log(f"[slice {label}] full-width forward with only the {fmt} ops plain: relative L2 "
                f"difference {rel_w:.3e}, bit-identical {same_w} (required: "
                f"{'bit-identical' if exact else f'<= {tol}'})")
            if not (same_w if exact else rel_w <= tol):
                raise AssertionError(f"{label} {fmt} kernels change the forward: {rel_w}")
            del out_w
    rel = rel_l2(out_k, out_p)
    log(f"[slice {label}] full-width forward: kernels {t1 - t0:.3f} s, plain versions "
        f"{t2 - t1:.3f} s, relative L2 difference {rel:.3e} (tolerance {tol})")
    if not rel <= tol or not torch.isfinite(out_k).all():
        raise AssertionError(f"{label} kernel forward departs from the plain forward: {rel}")
    del out_k, out_p
    if quant == "int4p":
        _flux_snapshot(dev, params, cfg, init_s,
                       lambda p: flux_forward(p, cfg, x, encoder, pooled, t, cos, sin, guidance))
        _flux_step_caches(dev, params, cfg, sched, cos, sin, x, encoder, pooled, t, guidance)
    if quant == "int8":
        _flux_prompt_request(dev, params, cfg, vae, vae_cfg, run, cos, sin)
        _flux_image_requests(dev, params, cfg, vae, vae_cfg, sched, cos, sin, summary)
        _flux_controlnet_request(dev, params, cfg, vae, vae_cfg)
    del params
    torch.cuda.empty_cache()
    return mine


def _flux_prompt_request(dev, params, cfg, vae, vae_cfg, run, cos, sin) -> None:
    """One 1024x2048 request from a prompt string against the same request
    from its embeddings, on FLUX.1-dev: the port's FluxTextEncoder given
    CLIP-L and T5-v1.1-XXL at full width and depth (f32, from seeds) and the
    tokenizers this function writes; the two images equal."""
    import tempfile

    import torch

    from fastdm_tpu_torch.models.clip_text import clip_text_init_random
    from fastdm_tpu_torch.pipeline.denoise import flux_unpack_latents
    from fastdm_tpu_torch.pipeline.text_encoder import FluxTextEncoder
    from fastdm_tpu_torch.pipeline.tokenizers import load_tokenizer
    from fastdm_tpu_torch.pipeline.vae import vae_decode

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-tok-") as base:
        paths = _write_tokenizers(base, ("clip-tok", "t5-tok"))
        enc = FluxTextEncoder(base, TXT_TOKENS, dev)
        enc.tokenizer, enc.tokenizer_2 = (load_tokenizer(paths[n]) for n in ("clip-tok", "t5-tok"))
    kws = {name: kw for name, _, kw, _, _ in TEXT_ENCODERS}
    enc.text_encoder = clip_text_init_random(510, _text_config("clip", kws["clip-l"]), False, dev)
    enc.text_encoder_2 = _text_model("t5", _text_config("t5", kws["t5-xxl"]), 512, dev)
    enc.loaded = True
    latents, _, _ = _conditioning(dev, 77, cfg, FLUX_HT * FLUX_WT)

    def request(encoder, pooled):
        lat, skips = run(params, latents, encoder, pooled, cos, sin)
        return vae_decode(vae, vae_cfg, flux_unpack_latents(lat, FLUX_HT, FLUX_WT)), skips

    encoder, pooled = enc.encode(TEXT_PROMPTS[0])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # two pairs, the prompt-string request first in one and second in the other
    prompt_s, emb_s, enc_s, imgs = [], [], [], []
    for kind in ("prompt", "embeddings", "embeddings", "prompt"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "prompt":
            encoder, pooled = enc.encode(TEXT_PROMPTS[0])
            torch.cuda.synchronize()
            enc_s.append(time.perf_counter() - t0)
        img, skips = request(encoder, pooled)
        torch.cuda.synchronize()
        (prompt_s if kind == "prompt" else emb_s).append(time.perf_counter() - t0)
        imgs.append(img)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = all(torch.equal(imgs[0], i) for i in imgs[1:])
    log(f"[slice int8] 1024x2048 request from a prompt string (CLIP-L + T5-XXL full depth in "
        f"f32 on the card, 512 tokens): {[round(t, 3) for t in prompt_s]} s, of it encode "
        f"{[round(t, 4) for t in enc_s]} s; the same request from its embeddings "
        f"{[round(t, 3) for t in emb_s]} s (order: prompt, embeddings, embeddings, prompt); "
        f"TeaCache skipped {skips}; images equal {same}; peak {peak:.2f} GiB")
    if not same or tuple(imgs[0].shape) != (1, 16 * FLUX_HT, 16 * FLUX_WT, 3):
        raise AssertionError("the prompt-string request and its embeddings' request differ")
    TEXT_SUMMARY.update({"flux_1024x2048_prompt_request_s": [round(t, 3) for t in prompt_s],
                         "flux_1024x2048_embeddings_request_s": [round(t, 3) for t in emb_s],
                         "flux_prompt_encode_s": [round(t, 4) for t in enc_s],
                         "flux_prompt_request_peak_gib": round(peak, 2)})
    del enc, imgs, img
    torch.cuda.empty_cache()


def same_modules(a, b, label: str) -> int:
    """Hold two modules equal parameter by parameter: names, class, dtype,
    shape, strides, device and bytes. Returns the bytes compared."""
    import torch

    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if list(pa) != list(pb):
        raise AssertionError(f"{label}: the reloaded module's parameters differ in name: "
                             f"{sorted(set(pa) ^ set(pb))[:8]}")
    nbytes = 0
    for k, x in pa.items():
        y = pb[k]
        if (type(x), x.dtype, x.shape, x.stride(), x.device) != \
                (type(y), y.dtype, y.shape, y.stride(), y.device) or not torch.equal(
                    x.detach().contiguous().view(torch.uint8),
                    y.detach().contiguous().view(torch.uint8)):
            raise AssertionError(f"{label}: parameter {k} differs after the snapshot round trip")
        nbytes += x.numel() * x.element_size()
    return nbytes


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _flux_snapshot(dev, params, cfg, init_s: float, forward) -> None:
    """The full-depth FLUX.1-dev int4p quant_mods tree through the quantized
    snapshot: save_snapshot into a scratch dir of the checkout, load_tree
    onto the card (a warm read: the files were just written), every
    parameter equal, one 1024x2048 forward from the reloaded tree equal to
    the in-memory tree's bit for bit. Beside them, the fresh build the
    snapshot saves an engine: quantize_weight("int4p") (the SVDQuant split:
    QR and SVD, then the int4 residual, on the card) of every W4A4 linear of
    the tree, each from a bf16 weight of its shape drawn on the card."""
    import shutil
    import tempfile

    import torch

    from fastdm_tpu_torch.layers.qlinear import QLinear, quantize_weight
    from fastdm_tpu_torch.models import snapshot

    here = os.path.dirname(os.path.abspath(__file__))
    g = torch.Generator(device=dev).manual_seed(7)
    build_s, n_lin = 0.0, 0
    for mod in params.modules():
        if isinstance(mod, QLinear) and mod.w4p is not None:
            k, n = mod.w4p.shape[0] * 2, mod.w4p.shape[1]
            w = torch.randn(k, n, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
            b = None if mod.bias is None else torch.zeros(n, device=dev, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = quantize_weight(w, "int4p", b)
            torch.cuda.synchronize()
            build_s += time.perf_counter() - t0
            n_lin += 1
            if q.w4p.shape != mod.w4p.shape or q.lora_u.shape != mod.lora_u.shape:
                raise AssertionError("quantize_weight gave another int4p layout than the tree's")
            del w, b, q
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-snap-") as d:
        free = shutil.disk_usage(d)
        t0 = time.perf_counter()
        snapshot.save_snapshot(d, {"transformer": params}, architecture="flux", quant="int4p",
                               cfg=cfg)
        write_s = time.perf_counter() - t0
        on_disk = _dir_bytes(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = snapshot.load_tree(d, "transformer", device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    nbytes = same_modules(params, back, "phase 2 int4p snapshot")
    with torch.inference_mode():
        want, got = forward(params), forward(back)
        torch.cuda.synchronize()
    same = torch.equal(want, got)
    log(f"[slice int4p] snapshot of the full-depth tree ({cfg.num_layers} + "
        f"{cfg.num_single_layers} blocks, {nbytes / 2**30:.3f} GiB of parameters): disk before "
        f"the write {free.free / 2**30:.1f} GiB free of {free.total / 2**30:.1f}; write "
        f"{write_s:.3f} s, {on_disk} bytes on disk; load_tree onto the card {load_s:.3f} s "
        f"(warm read); every parameter equal; the 1024x2048 forward from the reloaded tree "
        f"bit-identical {same}. Beside it: random init of the tree {init_s:.3f} s, fresh "
        f"quantize_weight('int4p') of its {n_lin} W4A4 linears {build_s:.3f} s")
    if not same:
        raise AssertionError("the forward of the reloaded int4p tree departs from the "
                             "in-memory tree's")
    SNAPSHOT_SUMMARY.update(int4p_full_depth_bytes=on_disk, int4p_write_s=round(write_s, 4),
                            int4p_load_s=round(load_s, 4), int4p_random_init_s=round(init_s, 4),
                            int4p_quantize_build_s=round(build_s, 4),
                            int4p_linears=n_lin, disk_free_before_gib=round(free.free / 2**30, 1))
    del back, want, got
    torch.cuda.empty_cache()


def _engine_snapshot(label: str, make, eng, first_s: float, snap_dir: str, gen_kw: dict) -> None:
    """eng was built by make(snap_dir) on an empty snap_dir and wrote the
    snapshot; build it again from the snapshot, hold every denoiser module
    equal to the first engine's on the card, and run one generate with the
    same seed on each: the outputs must be equal and launch the same
    kernels as often."""
    import numpy as np
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend

    t0 = time.perf_counter()
    eng2 = make(snap_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    names = sorted(eng._loaded_trees)
    if sorted(eng2._loaded_trees) != names or not names:
        raise AssertionError(f"{label}: the snapshot engine loaded {sorted(eng2._loaded_trees)}, "
                             f"not {names}")
    for name in names:
        same_modules(eng._loaded_trees[name], eng2._loaded_trees[name], f"{label} {name}")
    outs = []
    for e in (eng, eng2):
        cuda_backend.reset_launch_counts()
        outs.append((e.generate(**gen_kw), _launch_counts()))
    (a, ca), (b, cb) = outs
    nbytes = _dir_bytes(snap_dir)
    log(f"[engine {label}] snapshot round trip: engine that wrote it {first_s:.3f} s, engine "
        f"from it {load_s:.3f} s, {nbytes} bytes ({', '.join(names)}); every parameter equal; "
        f"generate outputs equal {np.array_equal(a, b)}, launches equal {ca == cb} ({ca})")
    if not np.array_equal(a, b) or ca != cb or not isinstance(a, np.ndarray):
        raise AssertionError(f"{label}: the engine from the snapshot generates otherwise")
    SNAPSHOT_SUMMARY[f"engine_{label}"] = dict(write_engine_s=round(first_s, 4),
                                               load_engine_s=round(load_s, 4), bytes=nbytes)
    del eng2
    torch.cuda.empty_cache()


def _flux_step_caches(dev, params, cfg, sched, cos, sin, x, encoder, pooled, t,
                      guidance) -> None:
    """FLUX's FBCache and DiCache probes on the int4p model: a 1024x2048
    request under examples/xcaching/configs/dicache_flux.json (threshold 0.2,
    probe depth 1, ret_ratio 0.2) whose skips equal the forwards whose
    remaining blocks did not run (hooks), with W4A4 launches derived from the
    code (a forward runs its probe's dual blocks, a computed one the rest
    too); then, under each of FBCache and DiCache, a forced skip (threshold
    1e9, no warmup): the second of two forwards on the same input launches
    only the probe block's W4A4 linears and returns the replayed residual
    through the output head bit for bit."""
    import torch

    from fastdm_tpu_torch.caching.config import CacheConfig, DiCacheConfig, FBCacheConfig
    from fastdm_tpu_torch.caching.xcaching import cache_init_state
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.flux import _flux_embed, _run_dual, flux_forward_cached
    from fastdm_tpu_torch.pipeline.denoise import make_flux_denoiser

    cc = CacheConfig.from_dict(_cache_json("dicache_flux.json"))
    run = make_flux_denoiser(cfg, sched, STEPS, cc, guidance_scale=3.5)
    calls, rest = [0], [0]
    hooks = [params.x_embedder.register_forward_hook(
                 lambda *_: calls.__setitem__(0, calls[0] + 1)),
             params.dual_blocks[cc.probe_depth].norm1.register_forward_hook(
                 lambda *_: rest.__setitem__(0, rest[0] + 1))]
    latents, enc, pool = _conditioning(dev, 44, cfg, x.shape[1])
    torch.cuda.synchronize()
    cuda_backend.reset_launch_counts()
    t0 = time.perf_counter()
    lat, skips = run(params, latents, enc, pool, cos, sin)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _launch_counts()
    for hk in hooks:
        hk.remove()
    probe = W4A4_PER_DUAL_BLOCK * cc.probe_depth
    want = STEPS * probe + (STEPS - skips) * (W4A4_PER_FORWARD - probe)
    log(f"[slice int4p cache] dicache_flux.json ({cc}): request {STEPS} steps {sec:.3f} s "
        f"denoise, skipped {skips} of {calls[0]} forwards, remaining-block stacks run "
        f"{rest[0]}; W4A4 launches {[counts[k] for k in W4A4_OPS]} (derived {want} each)")
    if (calls[0] != STEPS or skips != STEPS - rest[0]
            or any(counts[k] != want for k in W4A4_OPS) or not torch.isfinite(lat).all()):
        raise AssertionError(f"DiCache request: forwards {calls}, stacks {rest}, skips {skips}, "
                             f"launches {counts} != derived {want}")
    del lat

    shape = (1, x.shape[1], cfg.inner_dim)
    for cc in (FBCacheConfig(enable_caching=True, threshold=1e9, warmup_steps=0),
               DiCacheConfig(enable_caching=True, threshold=1e9, probe_depth=1, ret_ratio=0.0)):
        name = type(cc).__name__
        with torch.inference_mode():
            st0 = cache_init_state(cc, shape, shape, device=dev)
            out0, st1 = flux_forward_cached(params, cfg, cc, st0, 0, 2, x, encoder, pooled, t,
                                            cos, sin, guidance)
            torch.cuda.synchronize()
            cuda_backend.reset_launch_counts()
            out1, st2 = flux_forward_cached(params, cfg, cc, st1, 1, 2, x, encoder, pooled, t,
                                            cos, sin, guidance)
            torch.cuda.synchronize()
            counts = _launch_counts()
            hidden, temb, enc_h = _flux_embed(params, cfg, x, encoder, pooled, t, guidance)
            if isinstance(cc, DiCacheConfig):  # DiCache replays onto the probe's output
                hidden, _ = _run_dual(params, cfg, hidden, enc_h, temb, cos, sin, stop=1)
            replay = params.proj_out(params.norm_out(
                (hidden + st1["prev_residual"]).to(hidden.dtype), temb))
        same = torch.equal(out1, replay)
        rel = ((out1.float() - out0.float()).norm() / out0.float().norm()).item()
        log(f"[slice int4p cache] forced skip ({name}, threshold 1e9, no warmup): skips "
            f"{st1['skips']} -> {st2['skips']}; the skipped forward launched W4A4 "
            f"{[counts[k] for k in W4A4_OPS]} (one dual block: {W4A4_PER_DUAL_BLOCK} each); its "
            f"output is the replay bit for bit: {same}; relative L2 to the computed forward "
            f"{rel:.3e}")
        if not (st1["skips"] == 0 and st2["skips"] == 1 and same
                and all(counts[k] == W4A4_PER_DUAL_BLOCK for k in W4A4_OPS)
                and torch.isfinite(out1).all()):
            raise AssertionError(f"the forced {name} skip did not replay the cached residual")
        del out0, out1, replay


def flux_forward_launches(cfg) -> dict:
    """Kernel launches of one computed FLUX forward in bf16 or W8A8 without
    quant_mods, whatever its token count: per dual block four rmsnorm (q, k
    of each stream), one rotembd, one sdpa and 8 W8A8 linears, per single
    block two rmsnorm, one rotembd, one sdpa and 2 W8A8 linears. A TeaCache
    skip launches nothing (its probe is a bf16 modulation)."""
    counts = dict.fromkeys(_launch_counts(), 0)
    d, s = cfg.num_layers, cfg.num_single_layers
    counts.update(rmsnorm=4 * d + 2 * s, rotembd=d + s, sdpa=d + s)
    if cfg.quant is not None:
        counts[f"quantize_to_{cfg.quant}"] = counts[f"{cfg.quant}_matmul"] = 8 * d + 2 * s
    return counts


def _seeded_image(seed: int, h: int, w: int):
    """A (h, w, 3) uint8 image drawn on the host from a seed."""
    import numpy as np

    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _timed(fn, *a, **k):
    """(fn's result, its device-synced seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _flux_image_requests(dev, params, cfg, vae, vae_cfg, sched, cos, sin, summary) -> None:
    """On the full-depth int8 FLUX.1-dev: an SDEdit request at 1024x2048
    (the full-size AutoencoderKL encoder, strength 0.6 of 4 steps from
    start_step 1, TeaCache counting from the loop's start, so its first step
    is computed) and a Kontext request at 1024x1024 with one 1024x1024
    reference (8704 tokens); launches equal to flux_forward_launches per
    computed forward; encode, request, one Kontext forward and the tiled
    decode timed; peak memory."""
    import torch

    from fastdm_tpu_torch.caching.config import TeaCacheConfig
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.flux import flux_forward, flux_rope_cache
    from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents, \
        make_flux_denoiser, make_flux_kontext_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, \
        flow_match_shift_mu
    from fastdm_tpu_torch.pipeline.vae import vae_decode, vae_decode_tiled, vae_encode

    per = flux_forward_launches(cfg)
    resident = torch.cuda.memory_allocated() / 2**30

    def encode(img_u8):
        x = torch.from_numpy(img_u8).to(dev).float()[None] / 127.5 - 1.0
        torch.cuda.reset_peak_memory_stats()
        z, sec = _timed(vae_encode, vae["encoder"], vae_cfg, x)
        return z, sec, torch.cuda.max_memory_allocated() / 2**30

    # SDEdit at 1024x2048
    ht, wt = SDEDIT_H // 16, SDEDIT_W // 16
    start = min(int(STEPS * (1 - SDEDIT_STRENGTH)), STEPS - 1)
    run = make_flux_denoiser(cfg, sched, STEPS, TeaCacheConfig(**TEACACHE), 3.5, start)
    latents, encoder, pooled = _conditioning(dev, 24, cfg, ht * wt)
    z, enc_sec, enc_peak = encode(_seeded_image(25, SDEDIT_H, SDEDIT_W))
    log(f"[slice int8 sdedit] full-size AutoencoderKL encode {SDEDIT_H}x{SDEDIT_W} -> "
        f"{tuple(z.shape)}: {enc_sec:.3f} s, peak {enc_peak:.2f} GiB ({resident:.2f} resident)")
    sig = float(sched.sigmas[start])
    init = (1.0 - sig) * flux_pack_latents(z) + sig * latents
    computed = []  # per forward: did the blocks after the TeaCache probe run?
    hooks = [params.x_embedder.register_forward_hook(lambda *_: computed.append(False)),
             params.single_blocks[0].register_forward_hook(
                 lambda *_: computed.__setitem__(-1, True))]
    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    (lat, skips), den_sec = _timed(run, params, init, encoder, pooled, cos, sin)
    counts = _launch_counts()
    for hk in hooks:
        hk.remove()
    img, dec_sec = _timed(vae_decode, vae, vae_cfg, flux_unpack_latents(lat, ht, wt))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = STEPS - start
    want = {k: v * (n - skips) for k, v in per.items()}
    finite = bool(torch.isfinite(img).all())
    log(f"[slice int8 sdedit] request {SDEDIT_H}x{SDEDIT_W} strength {SDEDIT_STRENGTH}: steps "
        f"{start}..{STEPS - 1} at sigma {sig:.4f}, {enc_sec + den_sec + dec_sec:.3f} s (encode "
        f"{enc_sec:.3f}, denoise {den_sec:.3f}, decode {dec_sec:.3f}), TeaCache skipped "
        f"{skips}/{n}, forwards computed {computed}, image {tuple(img.shape)} finite={finite}, "
        f"peak {peak:.2f} GiB; launches {counts} (derived {n - skips} x per forward)")
    if (not finite or tuple(img.shape) != (1, SDEDIT_H, SDEDIT_W, 3) or len(computed) != n
            or not computed[0] or counts != want):
        raise AssertionError(f"SDEdit request: forwards {computed}, launches {counts} != {want}")
    # the same latents through the tiled decode (64-latent tiles, 25% overlap)
    torch.cuda.reset_peak_memory_stats()
    tiled, tiled_sec = _timed(vae_decode_tiled, vae, vae_cfg, flux_unpack_latents(lat, ht, wt))
    tiled_peak = torch.cuda.max_memory_allocated() / 2**30
    rel = ((tiled - img).norm() / img.norm()).item()
    log(f"[slice int8 sdedit] tiled decode {SDEDIT_H}x{SDEDIT_W}: {tiled_sec:.3f} s, peak "
        f"{tiled_peak:.2f} GiB (untiled {dec_sec:.3f} s, peak {peak:.2f}); relative L2 to the "
        f"untiled image {rel:.3e} (the seams), finite {bool(torch.isfinite(tiled).all())}")
    if not torch.isfinite(tiled).all() or tiled.shape != img.shape:
        raise AssertionError("the tiled decode failed")
    summary.update(encode_1024x2048_s=round(enc_sec, 4),
                         encode_1024x2048_peak_gib=round(enc_peak, 2),
                         sdedit_request_s=round(enc_sec + den_sec + dec_sec, 4),
                         sdedit_skips=skips, decode_1024x2048_s=round(dec_sec, 4),
                         tiled_decode_1024x2048_s=round(tiled_sec, 4),
                         tiled_decode_peak_gib=round(tiled_peak, 2),
                         untiled_decode_peak_gib=round(peak, 2))
    del img, tiled, lat, init, z

    # Kontext: 1024x1024 with one 1024x1024 reference
    kt = KONTEXT_SIZE // 16
    z, enc_sec, enc_peak = encode(_seeded_image(26, KONTEXT_SIZE, KONTEXT_SIZE))
    log(f"[slice int8 kontext] full-size AutoencoderKL encode {KONTEXT_SIZE}x{KONTEXT_SIZE}: "
        f"{enc_sec:.3f} s, peak {enc_peak:.2f} GiB ({resident:.2f} resident)")
    ref = flux_pack_latents(z)
    kcos, ksin = flux_rope_cache(cfg, TXT_TOKENS, kt, kt, ref_tokens_hw=(kt, kt), device=dev)
    ksched = FlowMatchEulerScheduler.create(STEPS, use_dynamic_shifting=True,
                                            mu=flow_match_shift_mu(kt * kt))
    krun = make_flux_kontext_denoiser(cfg, ksched, STEPS, None, KONTEXT_GUIDANCE)
    latents, encoder, pooled = _conditioning(dev, 27, cfg, kt * kt)
    tokens = TXT_TOKENS + kt * kt + ref.shape[1]
    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    (lat, _), den_sec = _timed(krun, params, latents, ref, encoder, pooled, kcos, ksin)
    counts = _launch_counts()
    img, dec_sec = _timed(vae_decode, vae, vae_cfg, flux_unpack_latents(lat, kt, kt))
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * STEPS for k, v in per.items()}
    finite = bool(torch.isfinite(img).all())
    log(f"[slice int8 kontext] request {KONTEXT_SIZE}x{KONTEXT_SIZE} + one reference "
        f"({tokens} tokens, cos {tuple(kcos.shape)}), guidance {KONTEXT_GUIDANCE}, {STEPS} "
        f"steps: {enc_sec + den_sec + dec_sec:.3f} s (encode {enc_sec:.3f}, denoise "
        f"{den_sec:.3f}, decode {dec_sec:.3f}), image {tuple(img.shape)} finite={finite}, peak "
        f"{peak:.2f} GiB; launches {counts} (derived {STEPS} x per forward)")
    if (not finite or tuple(img.shape) != (1, KONTEXT_SIZE, KONTEXT_SIZE, 3)
            or kcos.shape[0] != tokens or counts != want):
        raise AssertionError(f"Kontext request: launches {counts} != derived {want}")
    # one Kontext forward at 8704 tokens on the kernels
    x = torch.cat([latents.to(torch.bfloat16), ref.to(torch.bfloat16)], dim=1)
    t = torch.full((1,), float(ksched.sigmas[0]), device=dev)
    g = torch.full((1,), KONTEXT_GUIDANCE, device=dev)
    with torch.inference_mode():
        flux_forward(params, cfg, x, encoder, pooled, t, kcos, ksin, g)  # warm
        out, fwd_sec = _timed(flux_forward, params, cfg, x, encoder, pooled, t, kcos, ksin, g)
    log(f"[slice int8 kontext] one forward at {tokens} tokens: {fwd_sec:.3f} s, output "
        f"{tuple(out.shape)} finite {bool(torch.isfinite(out).all())}")
    summary.update(encode_1024x1024_s=round(enc_sec, 4),
                         encode_1024x1024_peak_gib=round(enc_peak, 2),
                         kontext_request_s=round(enc_sec + den_sec + dec_sec, 4),
                         kontext_forward_s=round(fwd_sec, 4), flux_int8_peak_gib=round(peak, 2))
    del img, lat, out, x, ref, z
    torch.cuda.empty_cache()


def phase_slice(dev, summary: Optional[dict] = None) -> dict:
    """Every weight format's path; returns {kernel: launches} (the bf16 path's
    counts for the first slice's kernels, each W8A8 path's for its own)."""
    import torch

    from fastdm_tpu_torch.pipeline.vae import VAEConfig, vae_decoder_random, \
        vae_encoder_random

    vae_cfg = VAEConfig(latent_channels=16)
    vae = vae_decoder_random(1, vae_cfg, device=dev)
    vae["encoder"] = vae_encoder_random(2, vae_cfg, device=dev)  # the SDEdit / Kontext requests
    launches = {}
    for quant, seeds in PATHS:
        for k, v in _serve_path(dev, quant, seeds, vae, vae_cfg,
                                {} if summary is None else summary).items():
            launches.setdefault(k, v)
    del vae
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 3

# Relative L2 of a full-depth Wan int8 forward on the kernels against the same
# forward on the plain versions (sparse layers on the superblock tables): twice
# the first value measured on an H100 80GB HBM3 (1.448e-2, at 17 frames). A
# wrong tile, table or layout gives O(1).
WAN_FORWARD_REL_L2_TOL = 3e-2
# The same at 17 frames (7800 tokens) in the other three sparse modes, each on
# its own tables: twice the first value measured on an H100 80GB HBM3 (fine
# 1.450e-2, coarse 1.455e-2, mask 1.448e-2).
WAN_MODE_REL_L2_TOL = {"fine": 2.9e-2, "coarse": 2.91e-2, "mask": 2.9e-2}


def wan_block_launches(cfg, tokens: int, attention: str, image: bool = False) -> dict:
    """Kernel launches of one Wan block, read off models/wan.py: the
    self-attention's qk_norm_rope (fused QKV) or one qk_norm_rope2 per token
    chunk (split QKV); one launch of `attention` (sdpa in a dense block, else
    the sparse mode's kernel); the cross-attention's q and k rmsnorm and one
    sdpa per token chunk; W8A8 linears: qkv (1, or q, k, v per chunk when
    split), self to_out, cross q, cross to_out and the two FFN linears once per
    token chunk each, and cross kv once (the 512 text tokens are one chunk).
    With Wan2.1-I2V's image tokens (`image`): add_k and add_v once each (the
    257 image tokens are one chunk), norm_added_k's rmsnorm, and one more sdpa
    per token chunk. The embedders and the output head are bf16 (no kernel)."""
    ct = cfg.ffn_chunk_tokens
    n = tokens // ct if ct and tokens > ct and tokens % ct == 0 else 1
    w8a8 = (3 * n if cfg.split_qkv_proj else 1) + 5 * n + 1 + (2 if image else 0)
    counts = dict.fromkeys(_launch_counts(), 0)
    counts.update(qk_norm_rope=0 if cfg.split_qkv_proj else 1,
                  qk_norm_rope2=n if cfg.split_qkv_proj else 0, sdpa=n * (2 if image else 1),
                  rmsnorm=3 if image else 2, quantize_to_int8=w8a8, int8_matmul=w8a8)
    counts[attention] += 1
    return counts


def wan_forward_launches(cfg, tokens: int, mode=None, blocks=None, image: bool = False) -> dict:
    """Kernel launches of the Wan blocks `blocks` (default: every block) in one
    forward, dense (mode None) or in a sparse mode, where the blocks from
    cfg.dense_layers on run the mode's kernel; `image`: with Wan2.1-I2V's
    image tokens."""
    total = dict.fromkeys(_launch_counts(), 0)
    for i in range(cfg.num_layers) if blocks is None else blocks:
        attention = "sdpa" if mode is None or i < cfg.dense_layers else SPARSE_KERNEL[mode][0]
        for name, n in wan_block_launches(cfg, tokens, attention, image).items():
            total[name] += n
    return total


def _wan_forward_split(dev, cfg, tokens: int, tables, secs: dict) -> None:
    """Each kernel of a Wan forward timed alone at every shape the forward
    gives it, times its launches per forward (wan_forward_launches): the
    forward's kernel split, dense and sparse; the rest is the measured
    forward minus these. The int8 GEMM is held bit-exact to its plain version
    at each of those shapes, with and without the zero point."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    g = torch.Generator(device=dev).manual_seed(77)
    d, ffn, layers = cfg.inner_dim, cfg.ffn_dim, cfg.num_layers
    ct = cfg.ffn_chunk_tokens or tokens
    n = tokens // ct
    h, hd = cfg.num_attention_heads, cfg.attention_head_dim
    # W8A8 linears of one block: (M, K, N) -> count (qkv once, cross kv on
    # the text, the rest per token chunk)
    linears = {(tokens, d, 3 * d): 1, (ct, d, d): 3 * n, (WAN_TEXT, d, 2 * d): 1,
               (ct, d, ffn): n, (ct, ffn, d): n}
    gemm = quant = gemm_bound = 0.0
    for (m, k, nn), count in linears.items():
        x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        lin = qlinear_random(g, k, nn, quant="int8", device=dev)
        a, sa, azp = tb.quantize_to_int8_torch(x, symmetric=False)
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, azp, lin.bias)
        _int8_exact(args, f"Wan {m}x{k} @ {k}x{nn}")  # raises on a mismatch
        gemm += layers * count * cuda_ms(lambda: cb.int8_matmul_cuda(*args), 5)
        quant += layers * count * cuda_ms(lambda: cb.quantize_to_int8_cuda(x, False), 5)
        gemm_bound += layers * count * bound(_gemm_bytes(m, k, nn), 2 * m * nn * k,
                                             INT8_FP8_OPS)[0]
        del x, lin, a, args
    q = torch.randn(1, ct, d, generator=g, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(1, WAN_TEXT, 2 * d, generator=g, device=dev, dtype=torch.bfloat16)
    cross = layers * n * cuda_ms(lambda: cb.sdpa_cuda(q, kv[..., :d], kv[..., d:], h, h, hd), 5)
    xq = torch.randn(1, tokens, d, generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.ones(d, device=dev, dtype=torch.bfloat16)
    norms = layers * (cuda_ms(lambda: cb.rms_norm_cuda(xq, w, 1e-6), 5)
                      + cuda_ms(lambda: cb.rms_norm_cuda(kv[..., :d], w, 1e-6), 5))
    qkv = torch.randn(1, tokens, 3 * d, generator=g, device=dev, dtype=torch.bfloat16)
    cos = torch.zeros(tokens, hd // 2, device=dev)
    qk = layers * cuda_ms(lambda: cb.qk_norm_rope_cuda(qkv, w, w, hd, cos, cos, inner_dim=d), 5)
    v = qkv[..., 2 * d:]
    dense_attn = cuda_ms(lambda: cb.sdpa_cuda(xq, xq, v, h, h, hd), 3)
    sparse_attn = cuda_ms(lambda: cb.gather_super_attention_cuda(
        xq, xq, v, *tables, h, h, hd, block_q=cfg.sparse_gather_fine_blocks[0],
        group=cfg.sparse_gather_fine_blocks[1] // cfg.sparse_gather_superblock,
        fine=cfg.sparse_gather_fine_blocks[2], superblock=cfg.sparse_gather_superblock), 3)
    del q, kv, xq, qkv, v
    torch.cuda.empty_cache()
    shared = gemm + quant + cross + norms + qk
    for label, attn in (("dense", layers * dense_attn),
                        ("sparse", cfg.dense_layers * dense_attn
                         + (layers - cfg.dense_layers) * sparse_attn)):
        total = secs[label] * 1e3
        log(f"[wan] {label} forward {total:.1f} ms, from the kernels timed alone x launches: "
            f"int8 GEMMs {gemm:.1f} (bound {gemm_bound:.1f}; each of {len(linears)} shapes "
            f"bit-exact with and without azp), int8 quantize {quant:.1f}, "
            f"self-attention {attn:.1f}, cross-attention sdpa {cross:.1f}, rmsnorm {norms:.1f}, "
            f"qk_norm_rope {qk:.1f}; the rest by subtraction {total - shared - attn:.1f} ms")


def phase_wan(dev) -> dict:
    """Wan2.2-T2V-A14B int8 at full width and depth: one 480x832x81 request
    through the dual-expert phase denoiser and the chunked VAE, launch and
    expert checks, the kernel-vs-plain and split-vs-fused forwards. Returns
    {kernel: launches} of the new kernels (qk_norm_rope2 from the split run)."""
    import torch

    from fastdm_tpu_torch.engine import wan_capacity_config, wan_sparse_tables
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.wan import WanConfig, wan_forward, wan_init_random, \
        wan_rope_cos_sin
    from fastdm_tpu_torch.pipeline.denoise_wan import make_wan_dual_phase_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler
    from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig, wan_vae_decode_chunked, \
        wan_vae_decoder_random

    radial = _radial()
    lf, lh, lw, tokens = _wan_shape(WAN_FRAMES)
    # the capacity knobs as the engine derives them; each sparse mode syncs its
    # own table geometry into a copy (wan_sparse_tables)
    capacity = wan_capacity_config(
        WanConfig(quant="int8", dense_layers=radial.config.dense_layers), tokens, dual=True)
    cfg, tables = wan_sparse_tables(radial, capacity, tokens, lf, dev)
    log(f"[wan] Wan2.2-T2V-A14B int8, {cfg.num_layers} blocks, {cfg.num_attention_heads}x"
        f"{cfg.attention_head_dim} heads, ffn {cfg.ffn_dim}; {WAN_H}x{WAN_W}x{WAN_FRAMES} = "
        f"{tokens} tokens: ffn_chunk_tokens {cfg.ffn_chunk_tokens}, split_qkv_proj "
        f"{cfg.split_qkv_proj}, radial superblock tables (block_q, group, fine) "
        f"{cfg.sparse_gather_fine_blocks} x {cfg.sparse_gather_superblock}, dense_layers "
        f"{cfg.dense_layers}, dense_steps {radial.config.dense_steps} (cut from 11 so the "
        f"sparse kernel runs within {WAN_STEPS} steps)")
    t0 = time.perf_counter()
    experts = [wan_init_random(seed, cfg, device=dev) for seed in (1, 2)]
    torch.cuda.synchronize()
    n = sum(p.numel() for p in experts[0].parameters())
    nbytes = sum(p.numel() * p.element_size() for e in experts for p in e.parameters())
    log(f"[wan] two experts drawn in int8 in {time.perf_counter() - t0:.1f} s: {n / 1e9:.3f} B "
        f"params each, {nbytes / 2**30:.1f} GiB both")
    vae_cfg = WanVAEConfig()
    vae = wan_vae_decoder_random(3, vae_cfg, device=dev)
    sched = UniPCMultistepScheduler.create(WAN_STEPS, shift=5.0)
    run = make_wan_dual_phase_denoiser(cfg, sched, WAN_STEPS, *WAN_CFG, WAN_BOUNDARY,
                                       radial.config.dense_steps)
    log(f"[wan] UniPC shift 5 sigmas {[round(float(x), 4) for x in sched.sigmas[:WAN_STEPS]]}, "
        f"boundary {WAN_BOUNDARY}: steps per expert {run.phase_steps}")
    if run.phase_steps != (2, 2):
        raise AssertionError(f"expected 2 + 2 steps per expert, got {run.phase_steps}")
    cos, sin = wan_rope_cos_sin(cfg, lf, lh, lw, device=dev)

    # the request: each expert's forwards counted by a hook on its patch embedding
    calls = [0, 0]
    hooks = [e.patch_embedding.register_forward_hook(
        lambda *_, i=i: calls.__setitem__(i, calls[i] + 1)) for i, e in enumerate(experts)]
    g = torch.Generator(device=dev).manual_seed(41)
    latents = torch.randn(1, cfg.out_channels, lf, lh, lw, generator=g, device=dev)
    pos, neg = (torch.randn(1, WAN_TEXT, cfg.text_dim, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    t0 = time.perf_counter()
    lat, _ = run(*experts, latents, pos, neg, cos, sin, tables)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    video = wan_vae_decode_chunked(vae, vae_cfg, lat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _launch_counts()
    for hk in hooks:
        hk.remove()
    finite = bool(torch.isfinite(video).all())
    shape = (1, WAN_FRAMES, WAN_H, WAN_W, 3)
    log(f"[wan] request {WAN_H}x{WAN_W}x{WAN_FRAMES}, {WAN_STEPS} steps, CFG {WAN_CFG}: "
        f"{t2 - t0:.3f} s (denoise {t1 - t0:.3f} s, VAE decode {t2 - t1:.3f} s), video "
        f"{tuple(video.shape)} finite={finite}, |x| max {video.abs().max().item():.3f}; forwards "
        f"per expert {calls}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not finite or tuple(video.shape) != shape or calls != [4, 4]:
        raise AssertionError("the Wan request produced a bad video or skipped an expert")
    dense_fwd, sparse_fwd = 2 * WAN_DENSE_STEPS, 2 * (WAN_STEPS - WAN_DENSE_STEPS)
    want = {k: dense_fwd * a + sparse_fwd * b for (k, a), b in zip(
        wan_forward_launches(cfg, tokens).items(),
        wan_forward_launches(cfg, tokens, "super").values())}
    log(f"[wan] kernel launches over the request ({dense_fwd} dense + {sparse_fwd} sparse "
        f"forwards): {counts}")
    if counts != want:
        raise AssertionError(f"Wan launch counts {counts} != derived {want}")
    log(f"[wan] launch check: counts equal the ones derived from the code (qk_norm_rope "
        f"{cfg.num_layers} per forward, gather_super {cfg.num_layers - cfg.dense_layers} per "
        f"sparse forward)")
    del video, lat, vae

    # one dense and one sparse forward alone; then the split-QKV forward
    # (qk_norm_rope2, its own path: counts zeroed before it) held to the fused
    t = torch.full((1,), float(sched.sigmas[2]) * 1000.0, device=dev)
    x = latents.to(torch.bfloat16)

    def forward(c, mask):
        with torch.inference_mode():
            return wan_forward(experts[1], c, x, t, pos, rope_cos=cos, rope_sin=sin,
                               sparse_mask=mask).float()

    secs = {}
    for label, mask in (("dense", None), ("sparse", tables)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(cfg, mask)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    out_k = out
    split_cfg = dataclasses.replace(cfg, split_qkv_proj=True)
    cuda_backend.reset_launch_counts()
    split = forward(split_cfg, tables)
    split_counts = _launch_counts()
    same = torch.equal(split, out_k)
    rel = ((split - out_k).norm() / out_k.norm()).item()
    log(f"[wan] full-depth forward at {tokens} tokens: dense {secs['dense']:.3f} s, sparse "
        f"{secs['sparse']:.3f} s; split-QKV (chunks of {cfg.ffn_chunk_tokens}) vs fused: "
        f"bit-identical {same}, relative L2 {rel:.3e} (required: bit-identical); split-path "
        f"launches {split_counts}")
    want_split = wan_forward_launches(split_cfg, tokens, "super")
    if not same or split_counts != want_split:
        raise AssertionError(f"split-QKV forward: equal {same}, launches {split_counts} != "
                             f"{want_split}")
    del split, out
    _wan_forward_split(dev, cfg, tokens, tables, secs)

    # the same sparse forward on the plain versions
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with kernel_registry.plain_on_device():
        out_p = forward(cfg, tables)
    torch.cuda.synchronize()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    log(f"[wan] full-depth sparse forward at {tokens} tokens: kernels vs plain versions "
        f"({time.perf_counter() - t0:.1f} s) relative L2 difference {rel:.3e} (tolerance "
        f"{WAN_FORWARD_REL_L2_TOL})")
    if not rel <= WAN_FORWARD_REL_L2_TOL or not torch.isfinite(out_k).all():
        raise AssertionError(f"the Wan kernel forward departs from the plain forward: {rel}")
    del out_k, out_p
    torch.cuda.empty_cache()
    launches = {"qk_norm_rope": counts["qk_norm_rope"], "gather_super": counts["gather_super"],
                "qk_norm_rope2": split_counts["qk_norm_rope2"]}
    launches.update(_wan_modes(dev, experts[1], capacity, radial, secs, x, t, pos, cos, sin))
    _wan_cached_requests(dev, experts, cfg, tables, latents, pos, neg, cos, sin, tokens)
    _wan_forced_skip(dev, experts[1], cfg, tables, x, t, pos, cos, sin, tokens)
    del experts
    torch.cuda.empty_cache()
    return launches


def _wan_modes(dev, expert, cfg, radial, secs, x, t, pos, cos, sin) -> dict:
    """The full-depth 480x832x81 forward in each of the other sparse modes
    (fine, coarse, mask), on the engine's table geometry of the mode (cfg:
    the capacity config before any mode synced it), timed, with exact launch
    counts (the mode's kernel 39 times, no other sparse kernel); then each
    mode's kernel forward against its plain forward at 17 frames. Returns
    {kernel: launches in its forward}."""
    import torch

    from fastdm_tpu_torch.engine import wan_capacity_config, wan_sparse_tables
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.wan import wan_forward, wan_rope_cos_sin

    tokens = cos.shape[0]
    lf = _wan_shape(WAN_FRAMES)[0]
    launches = {}
    for mode in ("fine", "coarse", "mask"):
        name = SPARSE_KERNEL[mode][0]
        cfg_m, tables = wan_sparse_tables(radial, cfg, tokens, lf, dev, mode)
        torch.cuda.synchronize()
        cuda_backend.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = wan_forward(expert, cfg_m, x, t, pos, rope_cos=cos, rope_sin=sin,
                              sparse_mask=tables)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        want = wan_forward_launches(cfg_m, tokens, mode)
        shapes = (tuple(tables.shape) if mode == "mask"
                  else " ".join(str(tuple(a.shape)) for a in tables))
        log(f"[wan {mode}] full-depth forward at {tokens} tokens on the {mode} tables {shapes}: "
            f"{sec:.3f} s (superblock tables {secs['sparse']:.3f} s, dense {secs['dense']:.3f} "
            f"s); {name} launched {counts[name]} times; launches {counts}")
        if counts != want or not torch.isfinite(out).all():
            raise AssertionError(f"{mode} forward: launches {counts} != derived {want}")
        launches[name] = counts[name]
        del out

    lf, lh, lw, tokens = _wan_shape(WAN_ENGINE_FRAMES)
    cfg17 = wan_capacity_config(cfg, tokens, dual=True)
    cos, sin = wan_rope_cos_sin(cfg17, lf, lh, lw, device=dev)
    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.randn(1, cfg.out_channels, lf, lh, lw, generator=g, device=dev).bfloat16()
    for mode in ("fine", "coarse", "mask"):
        cfg_m, tables = wan_sparse_tables(radial, cfg17, tokens, lf, dev, mode)

        def forward():
            with torch.inference_mode():
                return wan_forward(expert, cfg_m, x, t, pos, rope_cos=cos, rope_sin=sin,
                                   sparse_mask=tables).float()

        out_k = forward()
        with kernel_registry.plain_on_device():
            out_p = forward()
        rel = ((out_k - out_p).norm() / out_p.norm()).item()
        log(f"[wan {mode}] full-depth forward at {tokens} tokens ({WAN_ENGINE_FRAMES} frames): "
            f"kernels vs plain versions relative L2 difference {rel:.3e} (tolerance "
            f"{WAN_MODE_REL_L2_TOL[mode]})")
        if not rel <= WAN_MODE_REL_L2_TOL[mode] or not torch.isfinite(out_k).all():
            raise AssertionError(f"the {mode} kernel forward departs from the plain one: {rel}")
        del out_k, out_p
    torch.cuda.empty_cache()
    return launches


def _cache_json(name: str, **cuts) -> dict:
    """A published cache config (examples/xcaching/configs/), with `cuts`."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "xcaching", "configs", name)) as f:
        return dict(json.load(f), **cuts)


# the published Wan cache configs; FBCache's 8 warmup steps cut to 1 so that
# a skip can happen within the 4 steps
WAN_CACHES = (("fbcache_wan.json", {"warmup_steps": 1}), ("dicache_wan.json", {}))


def _wan_cached_requests(dev, experts, cfg, tables, latents, pos, neg, cos, sin,
                         tokens: int) -> None:
    """The 480x832x81 request of phase_wan again (superblock tables, no VAE
    decode) under FBCache and under DiCache: both experts run 4 forwards; the
    skip count equals the forwards whose remaining blocks did not run (hooks);
    the launches equal those derived from the code: every forward runs its
    probe blocks, a computed one the rest too (skips fall on sparse steps:
    step 0, the dense one, always computes)."""
    import torch

    from fastdm_tpu_torch.caching.config import CacheConfig, FBCacheConfig
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.pipeline.denoise_wan import make_wan_dual_phase_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler

    sched = UniPCMultistepScheduler.create(WAN_STEPS, shift=5.0)
    for name, cuts in WAN_CACHES:
        cc = CacheConfig.from_dict(_cache_json(name, **cuts))
        depth = 1 if isinstance(cc, FBCacheConfig) else cc.probe_depth
        run = make_wan_dual_phase_denoiser(cfg, sched, WAN_STEPS, *WAN_CFG, WAN_BOUNDARY,
                                           WAN_DENSE_STEPS, cache_cfg=cc)
        calls, rest = [0, 0], [0, 0]
        hooks = [e.patch_embedding.register_forward_hook(
            lambda *_, i=i: calls.__setitem__(i, calls[i] + 1)) for i, e in enumerate(experts)]
        hooks += [e.blocks[depth].attn1.to_out.register_forward_hook(
            lambda *_, i=i: rest.__setitem__(i, rest[i] + 1)) for i, e in enumerate(experts)]
        torch.cuda.synchronize()
        cuda_backend.reset_launch_counts()
        t0 = time.perf_counter()
        lat, skips = run(*experts, latents, pos, neg, cos, sin, tables)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        for hk in hooks:
            hk.remove()
        dense_fwd, sparse_fwd = 2 * WAN_DENSE_STEPS, 2 * (WAN_STEPS - WAN_DENSE_STEPS)
        parts = (wan_forward_launches(cfg, tokens),
                 wan_forward_launches(cfg, tokens, "super", range(depth)),
                 wan_forward_launches(cfg, tokens, "super", range(depth, cfg.num_layers)))
        want = {k: dense_fwd * a + sparse_fwd * b + (sparse_fwd - skips) * c
                for k, a, b, c in zip(parts[0], *(p.values() for p in parts))}
        log(f"[wan cache] {name} ({cc}; cut: {cuts or 'none'}): request {WAN_STEPS} steps "
            f"{sec:.3f} s denoise, skipped {skips} of {sum(calls)} forwards; forwards per expert "
            f"{calls}, remaining-block stacks run per expert {rest}; launches {counts}")
        if (calls != [4, 4] or skips != sum(calls) - sum(rest) or counts != want
                or not torch.isfinite(lat).all()):
            raise AssertionError(f"{name} request: forwards {calls}, stacks {rest}, skips {skips}, "
                                 f"launches {counts} != derived {want}")
        log(f"[wan cache] {name}: skips, block stacks and launches equal the counts derived "
            f"from the code")
        del lat


def _wan_forced_skip(dev, expert, cfg, tables, x, t, pos, cos, sin, tokens: int) -> None:
    """FBCache that skips every step it may (threshold 1e9, no warmup): the
    second of two forwards on the same input must skip, launch only block 0's
    kernels, and return exactly the embedded input plus the stored residual
    through the output head -- the replay path, on the card."""
    import torch

    from fastdm_tpu_torch.caching.config import FBCacheConfig
    from fastdm_tpu_torch.caching.xcaching import cache_init_state
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.wan import _wan_embed, _wan_output, wan_forward_cached

    cc = FBCacheConfig(enable_caching=True, threshold=1e9, warmup_steps=0)
    shape = (1, tokens, cfg.inner_dim)
    with torch.inference_mode():
        st0 = cache_init_state(cc, shape, shape, device=dev)
        out0, st1 = wan_forward_cached(expert, cfg, cc, st0, 0, 2, x, t, pos, rope_cos=cos,
                                       rope_sin=sin, sparse_mask=tables)
        torch.cuda.synchronize()
        cuda_backend.reset_launch_counts()
        out1, st2 = wan_forward_cached(expert, cfg, cc, st1, 1, 2, x, t, pos, rope_cos=cos,
                                       rope_sin=sin, sparse_mask=tables)
        torch.cuda.synchronize()
        counts = _launch_counts()
        hidden, temb, *_ = _wan_embed(expert, cfg, x, t, pos, None, cos, sin)
        replay = _wan_output(expert, cfg, (hidden + st1["prev_residual"]).to(hidden.dtype), temb,
                             x.shape[2:])
    same = torch.equal(out1, replay)
    rel = ((out1.float() - out0.float()).norm() / out0.float().norm()).item()
    want = wan_forward_launches(cfg, tokens, "super", range(1))
    log(f"[wan cache] forced skip (FBCache threshold 1e9, no warmup): skips {st1['skips']} -> "
        f"{st2['skips']}; the skipped forward launched {counts}; its output is the replay bit "
        f"for bit: {same}; relative L2 to the computed forward on the same input {rel:.3e}")
    if not (st1["skips"] == 0 and st2["skips"] == 1 and same and counts == want
            and st2["prev_residual"] is st1["prev_residual"] and rel <= 1e-2):
        raise AssertionError("the forced skip did not replay the cached residual")


# ------------------------------------------------------------------ sdxl

# Relative L2 of a full-width SDXL CFG forward on the kernels against the
# same forward on the plain versions, per weight format: twice the first value
# measured on an H100 80GB HBM3 (bf16 1.975e-2, int8 1.620e-2, fp8 1.485e-2;
# fp8 with only its W8A8 ops plain 1.444e-2, under the same bound). A wrong
# tile, scale or layout gives O(1).
SDXL_FORWARD_REL_L2_TOL = {None: 3.95e-2, "int8": 3.24e-2, "fp8": 2.97e-2}
# (quant, request seeds): int8, the main path, first
SDXL_PATHS = (("int8", (51, 52)), (None, (53,)), ("fp8", (54,)))


def _sdxl_conditioning(dev, seed: int, cfg, init_noise_sigma: float):
    """Seeded latents (1, 4, H/8, W/8) times init_noise_sigma and random
    [neg; pos] text embeddings, pooled embeddings and time ids, as
    FastDMEngine._generate_sdxl builds them from precomputed embeddings."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    latents = torch.randn(1, cfg.in_channels, SDXL_H // 8, SDXL_W // 8, generator=g,
                          device=dev) * init_noise_sigma
    embeds = torch.randn(SDXL_BATCH, SDXL_TEXT, cfg.cross_attention_dim, generator=g,
                         device=dev, dtype=torch.bfloat16)
    pooled = torch.randn(SDXL_BATCH, cfg.add_embedding_in_dim - 6 * cfg.addition_time_embed_dim,
                         generator=g, device=dev, dtype=torch.bfloat16)
    time_ids = torch.tensor([[SDXL_H, SDXL_W, 0, 0, SDXL_H, SDXL_W]] * SDXL_BATCH,
                            dtype=torch.float32, device=dev)
    return latents, embeds, pooled, time_ids


def _record_calls(forward) -> dict:
    """Run forward() once with every kernel op of the port and the UNet's
    conv2d wrapped: {(label, argument shapes, strides, dtypes and values):
    [label, function, args, kwargs, calls]}, one set of arguments kept per
    distinct call, for replaying each alone."""
    import torch

    import fastdm_tpu_torch.models.sdxl as sdxl_mod
    from fastdm_tpu_torch.kernels import kernel_registry

    calls = {}

    def key_of(a):
        if isinstance(a, torch.Tensor):
            return tuple(a.shape), a.stride(), a.dtype
        if isinstance(a, (list, tuple)):
            return tuple(key_of(x) for x in a)
        if isinstance(a, (dict, torch.nn.ParameterDict)):
            return tuple((k, key_of(v)) for k, v in a.items())
        return a

    def wrap(label, fn):
        def recorded(*args, **kw):
            key = (label, key_of(args), key_of(kw))
            if key in calls:
                calls[key][4] += 1
            else:
                calls[key] = [label, fn, args, kw, 1]
            return fn(*args, **kw)
        return recorded

    saved = {op: impls["cuda"] for op, impls in kernel_registry._ops.items() if "cuda" in impls}
    conv = sdxl_mod.conv2d
    try:
        for op, fn in saved.items():
            kernel_registry._ops[op]["cuda"] = wrap(op, fn)
        sdxl_mod.conv2d = wrap("conv2d", conv)
        forward()
    finally:
        for op, fn in saved.items():
            kernel_registry._ops[op]["cuda"] = fn
        sdxl_mod.conv2d = conv
    return calls


def _sdxl_forward_split(forward, sec: float, label: str) -> dict:
    """The forward's split: each kernel and conv call of one recorded
    forward timed alone on its recorded arguments, times its count per
    forward; the rest (GroupNorm, LayerNorm, SiLU, residual adds, embedders,
    layout copies) by subtraction from the measured forward. Returns the
    launches per op of the recorded forward."""
    import torch

    calls = _record_calls(forward)
    total, launches, shapes = {}, {}, {}
    for key, (op, fn, args, kw, count) in calls.items():
        ms = cuda_ms(lambda: fn(*args, **kw), 5)
        total[op] = total.get(op, 0.0) + count * ms
        launches[op] = launches.get(op, 0) + count
        shapes[op] = shapes.get(op, 0) + 1
    del calls
    torch.cuda.empty_cache()
    fwd = sec * 1e3
    parts = ", ".join(f"{op} {ms:.1f} ms ({launches[op]} calls, {shapes[op]} shapes)"
                      for op, ms in sorted(total.items(), key=lambda kv: -kv[1]))
    log(f"[sdxl {label}] forward {fwd:.1f} ms; each call of a recorded forward replayed alone "
        f"x its count: {parts}; the rest by subtraction {fwd - sum(total.values()):.1f} ms")
    return launches


def _serve_sdxl(dev, quant, seeds, vae, vae_cfg) -> dict:
    """SDXL-base at full width and depth in one weight format: requests,
    launch check, kernel forward vs plain forward (and, for int8, vs the
    forward with only the W8A8 ops plain), the int8 forward's split. Returns
    the launches of the path's kernels over its requests."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.sdxl import SDXLConfig, sdxl_forward, sdxl_init_random
    from fastdm_tpu_torch.pipeline.denoise_sdxl import make_sdxl_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import EulerDiscreteScheduler
    from fastdm_tpu_torch.pipeline.vae import vae_decode

    label = quant or "bf16"
    cfg = SDXLConfig(quant=quant)
    t0 = time.perf_counter()
    params = sdxl_init_random(5, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    blocks = sum(nb for nb, _ in sdxl_level_blocks(cfg))
    log(f"[sdxl {label}] SDXL-base {label} random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.2f} GiB), {blocks} transformer blocks, in "
        f"{time.perf_counter() - t0:.1f} s")
    sched = EulerDiscreteScheduler.create(SDXL_STEPS)
    run = make_sdxl_denoiser(cfg, sched, SDXL_STEPS, SDXL_CFG)

    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    for seed in seeds:
        latents, embeds, pooled, time_ids = _sdxl_conditioning(dev, seed, cfg,
                                                               sched.init_noise_sigma)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, _ = run(params, latents, embeds, pooled, time_ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = vae_decode(vae, vae_cfg, lat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        finite = bool(torch.isfinite(img).all())
        log(f"[sdxl {label}] request seed={seed} {SDXL_H}x{SDXL_W} {SDXL_STEPS} steps, CFG "
            f"{SDXL_CFG}: {t2 - t0:.3f} s (denoise {t1 - t0:.3f} s, VAE decode {t2 - t1:.3f} s), "
            f"image {tuple(img.shape)} finite={finite}, |x| max {img.abs().max().item():.3f}")
        if not finite or tuple(img.shape) != (1, SDXL_H, SDXL_W, 3):
            raise AssertionError(f"SDXL {label} request seed={seed} produced a bad image")
    counts = _launch_counts()
    forwards = SDXL_STEPS * len(seeds)
    want = {k: v * forwards for k, v in sdxl_forward_launches(cfg).items()}
    log(f"[sdxl {label}] kernel launches over {len(seeds)} requests ({forwards} forwards): "
        f"{counts}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"SDXL {label} launch counts {counts} != derived {want}")
    log(f"[sdxl {label}] launch check: {sdxl_forward_launches(cfg)} per forward, as derived")

    # one full-width CFG forward on the kernels vs the plain versions
    x = torch.cat([sched.scale_model_input(latents, 0)] * 2).to(torch.bfloat16)
    t = torch.full((SDXL_BATCH,), float(sched.timesteps[0]), device=dev)

    def forward(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return sdxl_forward(params, cfg, x, t, embeds, pooled, time_ids).float()

    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    tol = SDXL_FORWARD_REL_L2_TOL[quant]
    forward()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = forward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_p = forward(plain_ops=None)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if quant is not None:
        out_w = forward(plain_ops=W8A8_OPS)
        rel_w, same_w = rel_l2(out_k, out_w), torch.equal(out_k, out_w)
        log(f"[sdxl {label}] full-width forward with only the W8A8 ops plain: relative L2 "
            f"difference {rel_w:.3e}, bit-identical {same_w} (required: "
            f"{'bit-identical' if quant == 'int8' else f'<= {tol}'})")
        if not (same_w if quant == "int8" else rel_w <= tol):
            raise AssertionError(f"SDXL {label} W8A8 kernels change the forward: {rel_w}")
        del out_w
    rel = rel_l2(out_k, out_p)
    log(f"[sdxl {label}] full-width CFG forward (batch {SDXL_BATCH}, {SDXL_H // 8}x"
        f"{SDXL_W // 8} latents): kernels {t1 - t0:.3f} s, plain versions {t2 - t1:.3f} s, "
        f"relative L2 difference {rel:.3e} (tolerance {tol})")
    if not rel <= tol or not torch.isfinite(out_k).all():
        raise AssertionError(f"SDXL {label} kernel forward departs from the plain forward: {rel}")
    del out_k, out_p
    torch.cuda.empty_cache()
    if quant == "int8":
        split = _sdxl_forward_split(forward, t1 - t0, label)
        per_forward = {k: v for k, v in sdxl_forward_launches(cfg).items() if v}
        if {k: split.get(k, 0) for k in per_forward} != per_forward:
            raise AssertionError(f"the recorded forward's calls {split} != {per_forward}")
        _sdxl_conditioned_requests(dev, params, cfg, vae, vae_cfg)
    del params
    torch.cuda.empty_cache()
    return {k: counts[k] for k, v in want.items() if v}


def phase_sdxl(dev) -> dict:
    """SDXL-base at full width and depth in int8, bf16 and fp8 (one format
    resident at a time) with the full-size SDXL VAE decoder. Returns
    {kernel: launches} of the int8 path, the main one."""
    import torch

    from fastdm_tpu_torch.engine import VAE_CONFIGS
    from fastdm_tpu_torch.pipeline.vae import vae_decoder_random

    vae_cfg = VAE_CONFIGS["sdxl"]
    vae = vae_decoder_random(6, vae_cfg, device=dev)
    launches = {}
    for quant, seeds in SDXL_PATHS:
        mine = _serve_sdxl(dev, quant, seeds, vae, vae_cfg)
        if quant == "int8":
            launches = mine
    del vae
    torch.cuda.empty_cache()
    return {"gelu_and_mul": launches["gelu_and_mul"]}


# ------------------------------------------------------------------ sd35, qwen

# Relative L2 of a full-width forward on the kernels against the same forward
# on the plain versions: SD3.5-medium int8 (batched CFG) and Qwen-Image int4p
# with quant_mods, twice the first value measured on an H100 80GB HBM3
# (1.460e-2 and 4.822e-2). A wrong tile, scale or layout gives O(1).
SD35_FORWARD_REL_L2_TOL = 2.92e-2
QWEN_FORWARD_REL_L2_TOL = 9.644e-2
# the output head's W8A8 linears (norm_out, proj_out): run by every SD3.5
# forward, a TeaCache skip too
SD35_HEAD_LINEARS = 2


def _cache_config(name: str, **cuts):
    from fastdm_tpu_torch.caching.config import CacheConfig

    return CacheConfig.from_dict(_cache_json(name, **cuts))


def sd35_w8a8_gemms(cfg) -> dict:
    """The W8A8 linears of one SD3.5 CFG forward at SD35_H x SD35_W (batch
    SD35_BATCH): (M, K, N) -> count. Every block: image qkv, to_out, ff proj
    and out, context add_qkv; all but the last: to_add_out and ff_context;
    the dual blocks: attn2 qkv and to_out; then norm_out (one row per image)
    and proj_out (N = p*p*out = 64). The block AdaLNs, patch_proj and the
    embedders stay bf16."""
    b, d, p = SD35_BATCH, cfg.inner_dim, cfg.patch_size
    img = b * (SD35_H // 8 // p) * (SD35_W // 8 // p)
    txt = b * SD35_TEXT
    n, nd = cfg.num_layers, cfg.num_dual_layers
    gemms = {}

    def add(key, count):
        gemms[key] = gemms.get(key, 0) + count

    add((img, d, 3 * d), n + nd)
    add((img, d, d), n + nd)
    add((img, d, 4 * d), n)
    add((img, 4 * d, d), n)
    add((txt, d, 3 * d), n)
    add((txt, d, d), n - 1)
    add((txt, d, 4 * d), n - 1)
    add((txt, 4 * d, d), n - 1)
    add((b, d, 2 * d), 1)
    add((img, d, p * p * cfg.out_channels), 1)
    return gemms


def sd35_forward_launches(cfg) -> dict:
    """Kernel launches of one computed SD3.5 forward: per joint block four
    rmsnorm (q, k of each stream) and one sdpa, per dual block two more
    rmsnorm and a self-attention sdpa; the W8A8 linears of sd35_w8a8_gemms
    in cfg.quant. A TeaCache skip launches only the SD35_HEAD_LINEARS."""
    counts = dict.fromkeys(_launch_counts(), 0)
    n, nd = cfg.num_layers, cfg.num_dual_layers
    counts.update(rmsnorm=4 * n + 2 * nd, sdpa=n + nd)
    if cfg.quant is not None:
        w8a8 = sum(sd35_w8a8_gemms(cfg).values())
        counts[f"quantize_to_{cfg.quant}"] = counts[f"{cfg.quant}_matmul"] = w8a8
    return counts


def qwen_w4a4_gemms(cfg) -> dict:
    """The W4A4 linears of one Qwen-Image forward at 1024x2048 with
    QWEN_TEXT text tokens, quant_mods on: (M, K, N) -> count. Per block each
    stream's qkv, out, mlp proj and out, and the img_mod / txt_mod
    modulations (one row); norm_out, proj_out and the embedders stay bf16."""
    d, n = cfg.inner_dim, cfg.num_layers
    gemms = {}
    for m in (QWEN_HT * QWEN_WT, QWEN_TEXT):
        for kn in ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)):
            gemms[(m, *kn)] = n
    gemms[(1, d, 6 * d)] = 2 * n
    return gemms


def qwen_forward_launches(cfg, teacache: bool) -> tuple:
    """(launches of one computed Qwen-Image int4p quant_mods forward, launches
    every forward makes, a TeaCache skip too): per block four rmsnorm, one
    rotembd and one sdpa, the W4A4 linears of qwen_w4a4_gemms; every forward
    the txt_norm rmsnorm and, under TeaCache, its probe's block-0 txt_mod
    linear (W4A4 under quant_mods)."""
    computed = dict.fromkeys(_launch_counts(), 0)
    n = cfg.num_layers
    computed.update(rmsnorm=4 * n, rotembd=n, sdpa=n)
    every = dict.fromkeys(computed, 0)
    every["rmsnorm"] = 1
    w4a4 = sum(qwen_w4a4_gemms(cfg).values())
    for op in W4A4_OPS:
        computed[op], every[op] = w4a4, int(teacache)
    return computed, every


def _rms_case(label: str, x, w, ulp_tol: float = 1.0) -> float:
    """rmsnorm on x (bf16) held within one bf16 ulp of its plain version,
    timed beside its bound and F.rms_norm; returns the kernel's ms."""
    import torch.nn.functional as F

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    got, ref = cb.rms_norm_cuda(x, w, 1e-6), tb.rms_norm_torch(x, w, 1e-6)
    err = (got.float() - ref.float()).abs()
    ulps = (err / bf16_ulp(ref)).max().item()
    if not ulps <= ulp_tol:
        raise AssertionError(f"rmsnorm {label} disagrees with its plain version: {ulps} ulp")
    d, n = x.shape[-1], x.numel()
    ms = cuda_ms(lambda: cb.rms_norm_cuda(x, w, 1e-6), 50)
    plain_ms = cuda_ms(lambda: tb.rms_norm_torch(x, w, 1e-6), 5, 1)
    lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), w, 1e-6), 50) if hasattr(F, "rms_norm") \
        else None
    b_ms, b_by = bound(2 * n * 2 + d * 2, 4 * n, F32_FLOPS)
    log(f"[rmsnorm] {label} {tuple(x.shape)} strides {x.stride()}: max {ulps:.2f} bf16 ulp "
        f"(tolerance 1 ulp); {ms:.4f} ms ({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, {b_by}); "
        f"plain {plain_ms:.4f} ms, library {lib_ms} ms")
    return ms


def _sdpa_case(label: str, q, k, v, h: int, hd: int, long_rows: bool = True) -> float:
    """The dense sdpa kernel held to its plain version at the FLUX shape's
    tolerance (max|err| <= 1e-3 + 2 bf16 ulp, relative L2 <= 5e-3: long rows
    of thousands of keys, whose outputs are small) or, for short rows of a
    few hundred keys (long_rows False), at the small cases' 1e-2 +
    1e-2*|plain| and relative L2 <= 5e-3; timed beside its bound and the
    library call; returns the kernel's ms."""
    import torch
    import torch.nn.functional as F

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    got = cb.sdpa_cuda(q, k, v, h, h, hd)
    want = tb.sdpa_torch(q, k, v, h, h, hd)
    e = (got.float() - want.float()).abs()
    rel = (e.norm() / want.float().norm()).item()
    tol, stated = ((1e-3 + 2 * bf16_ulp(want), "1e-3 + 2 ulp") if long_rows else
                   (1e-2 + 1e-2 * want.float().abs(), "1e-2 + 1e-2*|plain|"))
    excess = (e - tol).max().item()
    if not (excess <= 0 and rel <= 5e-3 and torch.isfinite(got).all()):
        raise AssertionError(f"sdpa disagrees with its plain version at {label}: max "
                             f"{e.max().item()}, rel L2 {rel}")
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    heads = lambda t: t.unflatten(-1, (h, hd)).transpose(1, 2)  # noqa: E731
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 10)
    plain_ms = cuda_ms(lambda: tb.sdpa_torch(q, k, v, h, h, hd), 1, 1)
    flops = 4 * b * sq * skv * h * hd
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * b * skv * h * hd), flops, BF16_FLOPS)
    log(f"[sdpa] {label} q{tuple(q.shape)} k{tuple(k.shape)} {h}x{hd} heads: max_abs_err "
        f"{e.max().item():.3e}, rel L2 {rel:.3e} (tolerance {stated}, rel L2 5e-3); plain "
        f"{plain_ms:.4f} ms")
    return _sdpa_ms(label, q, k, v, h, hd, flops, b_ms, lib_ms, 10)


def _sd35_kernels(dev, g) -> None:
    """Every kernel an SD3.5-medium int8 CFG forward at 1024x2048 launches, at
    each of its shapes: rmsnorm on the 64-wide head rows read in place from
    the fused (B, S, 3*1536) projections of both streams; sdpa on the joint
    [333 context; 8192 image] = 8525 tokens (66 tiles of 128 and a tail of
    77) and on attn2's image self-attention with q|k|v column slices of one
    projection; the int8 quantizer and GEMM bit-exact (the GEMM with and
    without the zero point) at every W8A8 shape, N = 64 and M = 2 included.
    Logs the forward's split (kernel times at each shape x counts)."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.models.sd35 import SD3Config

    cfg = SD3Config()
    b, d, h, hd = SD35_BATCH, cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim
    n, nd = cfg.num_layers, cfg.num_dual_layers
    img = (SD35_H // 16) * (SD35_W // 16)
    qkv = torch.randn(b, img, 3 * d, generator=g, device=dev, dtype=torch.bfloat16)
    ctx = torch.randn(b, SD35_TEXT, 3 * d, generator=g, device=dev, dtype=torch.bfloat16)
    w = (1 + 0.05 * torch.randn(hd, generator=g, device=dev)).bfloat16()
    split = {}
    split["rmsnorm"] = (2 * (n + nd)) * _rms_case("SD3.5 image head rows", qkv[..., :d].unflatten(
        -1, (h, hd)), w) + 2 * n * _rms_case("SD3.5 context head rows",
                                             ctx[..., :d].unflatten(-1, (h, hd)), w)
    joint = [torch.cat([ctx[..., i * d:(i + 1) * d], qkv[..., i * d:(i + 1) * d]], dim=1)
             for i in range(3)]
    split["sdpa joint"] = n * _sdpa_case(f"SD3.5 joint ({SD35_TEXT} context first)", *joint, h,
                                         hd)
    split["sdpa attn2"] = nd * _sdpa_case("SD3.5 attn2 (in-place q|k|v)", qkv[..., :d],
                                          qkv[..., d:2 * d], qkv[..., 2 * d:], h, hd)
    del qkv, ctx, joint
    torch.cuda.empty_cache()
    gemm_ms = quant_ms = gemm_bound = quant_bound = 0.0
    gemms = sd35_w8a8_gemms(cfg)
    for (m, k, n_), count in gemms.items():
        a, sa, lin, args = _w8a8_operands("int8", m, k, n_, g, dev)
        x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        same_q = all(torch.equal(u, v) for u, v in
                     zip(cb.quantize_to_int8_cuda(x, symmetric=False),
                         tb.quantize_to_int8_torch(x, symmetric=False)))
        _int8_exact(args, f"SD3.5 {m}x{k} @ {k}x{n_}")  # raises on a mismatch
        g_ms = cuda_ms(lambda: cb.int8_matmul_cuda(*args), 5)
        q_ms = cuda_ms(lambda: cb.quantize_to_int8_cuda(x, symmetric=False), 5)
        gb = bound(_gemm_bytes(m, k, n_), 2 * m * n_ * k, INT8_FP8_OPS)[0]
        log(f"[int8 w8a8] SD3.5 {m}x{k} @ {k}x{n_} ({count} per forward): quantize bit-exact "
            f"{same_q}, GEMM bit-exact with and without azp; GEMM {g_ms:.4f} ms (bound "
            f"{gb:.4f}), quantize {q_ms:.4f} ms")
        if not same_q:
            raise AssertionError(f"quantize_to_int8 disagrees with its plain version at SD3.5 "
                                 f"{m}x{k}")
        gemm_ms += count * g_ms
        quant_ms += count * q_ms
        gemm_bound += count * gb
        quant_bound += count * bound(_quantize_bytes(m, k, False), 8 * m * k, F32_FLOPS)[0]
        del a, sa, lin, args, x
    torch.cuda.empty_cache()
    split["int8 GEMMs"], split["int8 quantize"] = gemm_ms, quant_ms
    log(f"[sd35] int8 CFG forward from the kernels timed alone x launches "
        f"({sum(gemms.values())} W8A8 linears; GEMM bound {gemm_bound:.1f} ms, quantize bound "
        f"{quant_bound:.1f} ms): " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; total {sum(split.values()):.1f} ms")


def _qwen_kernels(dev) -> None:
    """Every kernel a Qwen-Image int4p quant_mods forward at 1024x2048
    launches, at each of its shapes: rmsnorm on txt_norm's 3584-wide rows
    (the wide-row path) and the head rows of both streams; rotembd bit-exact
    on Qwen's scale_rope tables (negative image positions, text from 32 on)
    over the joint 512 + 8192 = 8704 tokens; sdpa there; the W4A4 kernels
    bit-exact at every int4 shape (the M = 1, N = 18432 modulations
    included). Logs the forward's split."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, qwen_rope_cos_sin

    cfg = QwenImageConfig(quant="int4p", quant_mods=True)
    g = torch.Generator(device=dev).manual_seed(3)  # the other phases' draws stay as they were
    d, h, hd, n = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim, cfg.num_layers
    img, s = QWEN_HT * QWEN_WT, QWEN_TEXT + QWEN_HT * QWEN_WT
    split = {}
    txt = torch.randn(1, QWEN_TEXT, cfg.joint_attention_dim, generator=g, device=dev,
                      dtype=torch.bfloat16) * 3
    txt_w = (1 + 0.05 * torch.randn(cfg.joint_attention_dim, generator=g, device=dev)).bfloat16()
    split["rmsnorm txt_norm"] = _rms_case("Qwen txt_norm (wide rows)", txt, txt_w)
    qkv = torch.randn(1, img, 3 * d, generator=g, device=dev, dtype=torch.bfloat16)
    ctx = torch.randn(1, QWEN_TEXT, 3 * d, generator=g, device=dev, dtype=torch.bfloat16)
    w = (1 + 0.05 * torch.randn(hd, generator=g, device=dev)).bfloat16()
    split["rmsnorm heads"] = 2 * n * (
        _rms_case("Qwen image head rows", qkv[..., :d].unflatten(-1, (h, hd)), w)
        + _rms_case("Qwen text head rows", ctx[..., :d].unflatten(-1, (h, hd)), w))
    joint = [torch.cat([ctx[..., i * d:(i + 1) * d], qkv[..., i * d:(i + 1) * d]], dim=1)
             for i in range(3)]
    del qkv, ctx
    cos, sin = qwen_rope_cos_sin(cfg, 1, QWEN_HT, QWEN_WT, QWEN_TEXT, device=dev)
    gq, gk = cb.rotary_pos_embedding_cuda(joint[0], joint[1], hd, cos, sin, False)
    rq, rk = tb.rotary_pos_embedding_torch(joint[0], joint[1], hd, cos, sin, False)
    exact = torch.equal(gq, rq) and torch.equal(gk, rk)
    rot_ms = cuda_ms(lambda: cb.rotary_pos_embedding_cuda(joint[0], joint[1], hd, cos, sin,
                                                          False), 50)
    nb = 2 * joint[0].numel()
    b_ms, b_by = bound(2 * nb * 2 + 2 * cos.numel() * 4, 3 * nb, F32_FLOPS)
    log(f"[rotembd] Qwen {tuple(joint[0].shape)} on the scale_rope tables {tuple(cos.shape)} "
        f"(negative image positions): bit-exact {exact} (tolerance: bit-exact); {rot_ms:.4f} "
        f"ms ({b_ms / rot_ms:.1%} of the bound {b_ms:.4f} ms, {b_by})")
    if not exact:
        raise AssertionError("rotembd is not bit-exact with its plain version on Qwen's tables")
    split["rotembd"] = n * rot_ms
    split["sdpa"] = n * _sdpa_case(f"Qwen joint ({QWEN_TEXT} text first)", gq, gk, joint[2], h,
                                   hd)
    del joint, gq, gk, rq, rk
    torch.cuda.empty_cache()
    gemms = dict(qwen_w4a4_gemms(cfg))
    w4a4 = _w4a4_split(dev, g, gemms, "Qwen int4p")
    split.update({k: v[0] for k, v in w4a4.items()})
    log(f"[qwen] int4p quant_mods forward from the kernels timed alone x launches "
        f"({sum(gemms.values())} W4A4 linears; bounds "
        + ", ".join(f"{k} {v[1]:.1f}" for k, v in w4a4.items()) + " ms): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; total {sum(split.values()):.1f} ms")


def _forward_gate(label: str, forward, tol: float, quant_ops) -> tuple:
    """One full-width forward on the kernels (timed after a warm one) held to
    the same forward on the plain versions within relative L2 `tol`, and bit
    for bit to the forward with only `quant_ops` (the integer quantize and
    GEMM ops) plain. Returns the (kernels, plain) forward seconds."""
    import torch

    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    forward()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = forward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_p = forward(plain_ops=None)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out_w = forward(plain_ops=quant_ops)
    same_w = torch.equal(out_k, out_w)
    rel = rel_l2(out_k, out_p)
    log(f"[{label}] full-width forward: kernels {t1 - t0:.3f} s, plain versions {t2 - t1:.3f} s, "
        f"relative L2 difference {rel:.3e} (tolerance {tol}); with only {list(quant_ops)} plain: "
        f"bit-identical {same_w} (required), relative L2 {rel_l2(out_k, out_w):.3e}")
    if not (rel <= tol and same_w and torch.isfinite(out_k).all()):
        raise AssertionError(f"{label} kernel forward departs from the plain forward: {rel}, "
                             f"bit-identical with only {quant_ops} plain: {same_w}")
    return t1 - t0, t2 - t1


def phase_sd35(dev) -> None:
    """SD3.5-medium int8 at full width and depth (24 blocks, 13 dual, 24x64
    heads, random weights from a seed) serving 1024x2048 requests through
    make_sd3_denoiser as bench.py's main_sd35 does (batched CFG 7.0,
    FlowMatch shift 3.0, TeaCache with teacache_sd35.json, 333 text tokens,
    4 steps), then the full-size 16-channel VAE decode with SD3.5's scaling
    and shift; exact launches; one CFG forward against the plain one."""
    import torch

    from fastdm_tpu_torch.engine import VAE_CONFIGS
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.sd35 import SD3Config, sd3_cropped_pos_embed, sd3_forward, \
        sd3_init_random
    from fastdm_tpu_torch.pipeline.denoise_sd3 import make_sd3_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler
    from fastdm_tpu_torch.pipeline.vae import vae_decode, vae_decoder_random

    cfg = SD3Config(quant="int8")
    lh, lw = SD35_H // 8, SD35_W // 8
    t0 = time.perf_counter()
    params = sd3_init_random(7, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[sd35] SD3.5-medium int8 random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.2f} GiB), {cfg.num_layers} blocks ({cfg.num_dual_layers} dual), in "
        f"{time.perf_counter() - t0:.1f} s")
    vae_cfg = VAE_CONFIGS["sd35"]
    vae = vae_decoder_random(9, vae_cfg, device=dev)
    t0 = time.perf_counter()
    pos = sd3_cropped_pos_embed(cfg, None, lh, lw, device=dev)
    log(f"[sd35] cropped position table {tuple(pos.shape)} from the {cfg.pos_embed_max_size}^2 "
        f"host table: {time.perf_counter() - t0:.2f} s, once per resolution (outside requests)")
    tea = _cache_config("teacache_sd35.json")
    sched = FlowMatchEulerScheduler.create(SD35_STEPS, shift=3.0)
    run = make_sd3_denoiser(cfg, sched, SD35_STEPS, SD35_CFG, tea)

    def conditioning(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(1, cfg.in_channels, lh, lw, generator=g, device=dev),
                torch.randn(SD35_BATCH, SD35_TEXT, cfg.joint_attention_dim, generator=g,
                            device=dev, dtype=torch.bfloat16),
                torch.randn(SD35_BATCH, cfg.pooled_projection_dim, generator=g, device=dev,
                            dtype=torch.bfloat16))

    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    seeds, skipped = (61, 62), 0
    for seed in seeds:
        latents, embeds, pooled = conditioning(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, skips = run(params, latents, embeds, pooled, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = vae_decode(vae, vae_cfg, lat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        skipped += skips
        finite = bool(torch.isfinite(img).all())
        log(f"[sd35] request seed={seed} {SD35_H}x{SD35_W} {SD35_STEPS} steps, CFG {SD35_CFG}: "
            f"{t2 - t0:.3f} s (denoise {t1 - t0:.3f} s, VAE decode {t2 - t1:.3f} s), TeaCache "
            f"skipped {skips}/{SD35_STEPS}, image {tuple(img.shape)} finite={finite}")
        if not finite or tuple(img.shape) != (1, SD35_H, SD35_W, 3):
            raise AssertionError(f"SD3.5 request seed={seed} produced a bad image")
    counts = _launch_counts()
    forwards = SD35_STEPS * len(seeds)
    per = sd35_forward_launches(cfg)
    want = {k: v * (forwards - skipped) for k, v in per.items()}
    for op in ("quantize_to_int8", "int8_matmul"):
        want[op] += SD35_HEAD_LINEARS * skipped
    log(f"[sd35] kernel launches over {len(seeds)} requests ({forwards} forwards, {skipped} "
        f"skipped): {counts}; per computed forward {({k: v for k, v in per.items() if v})}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"SD3.5 launch counts {counts} != derived {want}")

    x = torch.cat([latents] * 2).to(torch.bfloat16)
    t = torch.full((SD35_BATCH,), float(sched.sigmas[0]) * 1000.0, device=dev)

    def forward(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return sd3_forward(params, cfg, x, embeds, pooled, t, pos).float()

    _forward_gate("sd35 int8", forward, SD35_FORWARD_REL_L2_TOL,
                  ("quantize_to_int8", "int8_matmul"))
    del params, vae, pos
    torch.cuda.empty_cache()


def phase_qwen(dev, summary: Optional[dict] = None) -> None:
    """Qwen-Image int4p with quant_mods at full width and depth (60 blocks,
    24x128 heads, random weights from a seed) serving 1024x2048 requests
    through make_qwen_denoiser as bench.py's main_qwen does (true CFG 1.0,
    512 text tokens, TeaCache 0.1 with teacache_qwenimage.json's polynomial,
    dynamic shift, 4 steps), then the full-size Wan VAE decoder on a
    singleton frame; exact launches; one forward against the plain one."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, qwen_forward, \
        qwen_init_random, qwen_rope_cos_sin
    from fastdm_tpu_torch.pipeline.denoise import flux_unpack_latents
    from fastdm_tpu_torch.pipeline.denoise_qwen import make_qwen_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, \
        flow_match_shift_mu
    from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig, wan_vae_decode, \
        wan_vae_decoder_random

    cfg = QwenImageConfig(quant="int4p", quant_mods=True)
    ht, wt = QWEN_HT, QWEN_WT
    t0 = time.perf_counter()
    params = qwen_init_random(8, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[qwen] Qwen-Image int4p quant_mods random init: {n / 1e9:.3f} B stored values "
        f"({nbytes / 2**30:.2f} GiB), {cfg.num_layers} blocks, in {time.perf_counter() - t0:.1f} s")
    vae_cfg = WanVAEConfig()
    vae = wan_vae_decoder_random(10, vae_cfg, device=dev)
    t0 = time.perf_counter()
    cos, sin = qwen_rope_cos_sin(cfg, 1, ht, wt, QWEN_TEXT, device=dev)
    log(f"[qwen] RoPE tables {tuple(cos.shape)}: {time.perf_counter() - t0:.3f} s on the host")
    tea = _cache_config("teacache_qwenimage.json", threshold=QWEN_TEACACHE_THRESHOLD)
    sched = FlowMatchEulerScheduler.create(QWEN_STEPS, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * wt))
    run = make_qwen_denoiser(cfg, sched, QWEN_STEPS, QWEN_CFG, tea)

    def conditioning(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(1, ht * wt, cfg.in_channels, generator=g, device=dev),
                torch.randn(1, QWEN_TEXT, cfg.joint_attention_dim, generator=g, device=dev,
                            dtype=torch.bfloat16))

    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    seeds, skipped = (71, 72), 0
    for seed in seeds:
        latents, embeds = conditioning(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, skips = run(params, latents, embeds, embeds, cos, sin)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = wan_vae_decode(vae, vae_cfg, flux_unpack_latents(lat, ht, wt)[:, :, None])[:, 0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        skipped += skips
        finite = bool(torch.isfinite(img).all())
        log(f"[qwen] request seed={seed} {16 * ht}x{16 * wt} {QWEN_STEPS} steps, true CFG "
            f"{QWEN_CFG}: {t2 - t0:.3f} s (denoise {t1 - t0:.3f} s, Wan VAE decode of one "
            f"frame {t2 - t1:.3f} s), TeaCache skipped {skips}/{QWEN_STEPS}, image "
            f"{tuple(img.shape)} finite={finite}")
        if not finite or tuple(img.shape) != (1, 16 * ht, 16 * wt, 3):
            raise AssertionError(f"Qwen-Image request seed={seed} produced a bad image")
    counts = _launch_counts()
    forwards = QWEN_STEPS * len(seeds)
    computed, every = qwen_forward_launches(cfg, teacache=True)
    want = {k: computed[k] * (forwards - skipped) + every[k] * forwards for k in computed}
    log(f"[qwen] kernel launches over {len(seeds)} requests ({forwards} forwards, {skipped} "
        f"skipped): {counts}; per computed forward {({k: v for k, v in computed.items() if v})} "
        f"plus every forward {({k: v for k, v in every.items() if v})} (txt_norm, TeaCache's "
        f"W4A4 txt_mod probe); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"Qwen-Image launch counts {counts} != derived {want}")

    x = latents.to(torch.bfloat16)
    t = torch.full((1,), float(sched.sigmas[0]), device=dev)

    def forward(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return qwen_forward(params, cfg, x, embeds, t, cos, sin).float()

    _forward_gate("qwen int4p", forward, QWEN_FORWARD_REL_L2_TOL, W4A4_OPS)
    del x
    _qwen_edit_request(dev, params, cfg, vae, vae_cfg, tea, {} if summary is None else summary)
    del params, vae
    torch.cuda.empty_cache()


def _qwen_edit_request(dev, params, cfg, vae, vae_cfg, tea, summary) -> None:
    """Qwen-Image-Edit on the resident int4p quant_mods model: one 1024x1024
    source encoded by the full-size Wan2.1-layout VAE encoder (one frame),
    its 4096 tokens after the 4096 noise tokens, true CFG 4.0 on two
    TeaCache streams (0.1, teacache_qwenimage.json's polynomial), 4 steps;
    launches from qwen_forward_launches per forward; one edit forward timed."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.qwenimage import qwen_forward, qwen_rope_cos_sin
    from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents
    from fastdm_tpu_torch.pipeline.denoise_qwen import make_qwen_edit_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, \
        flow_match_shift_mu
    from fastdm_tpu_torch.pipeline.wan_vae import wan_vae_decode, wan_vae_encode, \
        wan_vae_encoder_random

    vae = dict(vae, **wan_vae_encoder_random(11, vae_cfg, device=dev))
    ht = EDIT_SIZE // 16
    x = torch.from_numpy(_seeded_image(73, EDIT_SIZE, EDIT_SIZE)).to(dev).float() / 127.5 - 1
    torch.cuda.reset_peak_memory_stats()
    z, enc_sec = _timed(wan_vae_encode, vae, vae_cfg, x[None, None])
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    src = flux_pack_latents(z[:, :, 0])
    log(f"[qwen edit] full-size Wan2.1-layout VAE encode of one {EDIT_SIZE}x{EDIT_SIZE} frame "
        f"-> {tuple(z.shape)}: {enc_sec:.3f} s, peak {enc_peak:.2f} GiB")
    cos, sin = qwen_rope_cos_sin(cfg, 1, ht, ht, QWEN_TEXT, extra_shapes=((1, ht, ht),),
                                 device=dev)
    sched = FlowMatchEulerScheduler.create(QWEN_STEPS, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * ht))
    run = make_qwen_edit_denoiser(cfg, sched, QWEN_STEPS, EDIT_CFG, tea)
    g = torch.Generator(device=dev).manual_seed(74)
    latents = torch.randn(1, ht * ht, cfg.in_channels, generator=g, device=dev)
    pos, neg = (torch.randn(1, QWEN_TEXT, cfg.joint_attention_dim, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    (lat, skips), den_sec = _timed(run, params, latents, src, pos, neg, cos, sin)
    counts = _launch_counts()
    img, dec_sec = _timed(lambda: wan_vae_decode(
        vae, vae_cfg, flux_unpack_latents(lat, ht, ht)[:, :, None])[:, 0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    forwards = 2 * QWEN_STEPS  # true CFG: the positive and the negative stream
    computed, every = qwen_forward_launches(cfg, teacache=True)
    want = {k: computed[k] * (forwards - skips) + every[k] * forwards for k in computed}
    finite = bool(torch.isfinite(img).all())
    log(f"[qwen edit] request {EDIT_SIZE}x{EDIT_SIZE} + one source ({QWEN_TEXT} + {ht * ht} + "
        f"{src.shape[1]} tokens), true CFG {EDIT_CFG}, TeaCache {QWEN_TEACACHE_THRESHOLD}, "
        f"{QWEN_STEPS} steps: {enc_sec + den_sec + dec_sec:.3f} s (encode {enc_sec:.3f}, "
        f"denoise {den_sec:.3f}, decode {dec_sec:.3f}), skipped {skips}/{forwards} forwards, "
        f"image {tuple(img.shape)} finite={finite}, peak {peak:.2f} GiB; launches {counts}")
    if not finite or tuple(img.shape) != (1, EDIT_SIZE, EDIT_SIZE, 3) or counts != want:
        raise AssertionError(f"Qwen-Image-Edit request: launches {counts} != derived {want}")
    xin = torch.cat([latents.to(torch.bfloat16), src.to(torch.bfloat16)], dim=1)
    t = torch.full((1,), float(sched.sigmas[0]), device=dev)
    with torch.inference_mode():
        qwen_forward(params, cfg, xin, pos, t, cos, sin)  # warm
        out, fwd_sec = _timed(qwen_forward, params, cfg, xin, pos, t, cos, sin)
    log(f"[qwen edit] one forward at {QWEN_TEXT} + {xin.shape[1]} tokens: {fwd_sec:.3f} s, "
        f"finite {bool(torch.isfinite(out).all())}")
    summary.update(qwen_edit_encode_s=round(enc_sec, 4),
                         qwen_edit_encode_peak_gib=round(enc_peak, 2),
                         qwen_edit_request_s=round(enc_sec + den_sec + dec_sec, 4),
                         qwen_edit_skips=skips, qwen_edit_forward_s=round(fwd_sec, 4),
                         qwen_edit_peak_gib=round(peak, 2))
    del img, lat, out, xin, src, z


# ------------------------------------------------------------------ wan5b

# Relative L2 of the full-depth Wan2.2-TI2V-5B int8 forward on the kernels
# (per-token timesteps, 17856 tokens) against the same forward on the plain
# versions: twice the first value measured on an H100 80GB HBM3 (1.178e-2).
# A wrong tile, scale or layout gives O(1).
WAN5B_FORWARD_REL_L2_TOL = 2.356e-2


def wan5b_config():
    """Wan2.2-TI2V-5B's transformer (bench.py:300-307, diffusers'
    Wan2.2-TI2V-5B transformer/config.json) in int8 with per-token
    timesteps, and its VAE (residual, 2x2 pixel patches, base_dim 160, z_dim
    48) as the JAX engine's config reads it."""
    from fastdm_tpu_torch.models.wan import WanConfig
    from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig

    cfg = WanConfig(num_layers=30, num_attention_heads=24, attention_head_dim=128,
                    ffn_dim=14336, in_channels=48, out_channels=48, per_token_timestep=True,
                    quant="int8")
    return cfg, WanVAEConfig(base_dim=160, z_dim=48, patch_size=2, is_residual=True)


def _wan5b_shape():
    """(latent frames, latent height, latent width, patch tokens) of a
    WAN5B_H x WAN5B_W x WAN5B_FRAMES clip through the 16x VAE."""
    lf, lh, lw = (WAN5B_FRAMES - 1) // 4 + 1, WAN5B_H // 16, WAN5B_W // 16
    return lf, lh, lw, lf * (lh // 2) * (lw // 2)


def _wan5b_kernels(dev, g) -> None:
    """Every kernel a Wan2.2-TI2V-5B int8 forward at 768x768x121 launches, at
    each of its shapes (17856 tokens, 24 heads of 128): qk_norm_rope on the
    fused (1, 17856, 9216) QKV with the 3D RoPE tables of 31 x 24 x 24
    patches (3072-wide rows), rmsnorm on the cross-attention's 3072-wide q
    and k rows (k read in place from the fused text K|V), sdpa on the
    self-attention (17856 = 139 x 128 + 64: the tail tile runs) and the
    512-key cross-attention, and the int8 quantizer and GEMM bit-exact (the
    GEMM with and without the zero point) at every W8A8 shape. Logs each time
    beside its bound and the forward's split (times x launches)."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.models.wan import wan_rope_cos_sin

    cfg, _ = wan5b_config()
    lf, lh, lw, s = _wan5b_shape()
    d, h, hd, n = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim, cfg.num_layers
    split = {}
    cos, sin = wan_rope_cos_sin(cfg, lf, lh, lw, device=dev)
    gq = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).bfloat16()
    gk = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).bfloat16()
    qkv = (torch.randn(1, s, 3 * d, generator=g, device=dev) * 2).bfloat16()
    kern = lambda: cb.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, inner_dim=d)  # noqa: E731
    plain = lambda: tb.qk_norm_rope_torch(qkv, gq, gk, hd, cos, sin, inner_dim=d)  # noqa: E731
    worst, err = _qk_excess(kern(), plain())
    ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3, 1)
    b_ms, b_by = bound(4 * s * d * 2 + 2 * s * (hd // 2) * 4 + 2 * d * 2, 7 * 2 * s * d,
                       F32_FLOPS)
    log(f"[qk_norm_rope] Wan5B qkv (1, {s}, {3 * d}) inner_dim {d}: max_abs_err {err:.3e}, "
        f"excess over 1 ulp + 2 ulp of the pair's magnitude {worst:.3e} (must be <= 0); "
        f"{ms:.4f} ms ({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, {b_by}); plain "
        f"{plain_ms:.4f} ms; {n} per forward")
    if not worst <= 0:
        raise AssertionError("qk_norm_rope disagrees with its plain version at the 5B shape")
    split["qk_norm_rope"] = n * ms
    del qkv
    kv = torch.randn(1, WAN_TEXT, 2 * d, generator=g, device=dev, dtype=torch.bfloat16)
    xq = torch.randn(1, s, d, generator=g, device=dev, dtype=torch.bfloat16)
    split["rmsnorm"] = n * (_rms_case("Wan5B cross-attention q (wide rows)", xq, gq)
                            + _rms_case("Wan5B cross-attention k (in place in K|V)",
                                        kv[..., :d], gk))
    # q|k|v ~ N(0, 1), read in place from one (1, S, 3D) projection, as the
    # SD3.5 and Qwen cases
    qkv = torch.randn(1, s, 3 * d, generator=g, device=dev, dtype=torch.bfloat16)
    split["sdpa self"] = n * _sdpa_case(f"Wan5B self-attention ({s} tokens, tail tile)",
                                        qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], h, hd)
    split["sdpa cross"] = n * _sdpa_case(f"Wan5B cross-attention ({WAN_TEXT} keys)", xq,
                                         kv[..., :d], kv[..., d:], h, hd, long_rows=False)
    del qkv, kv, xq, cos, sin
    torch.cuda.empty_cache()
    gemm_ms = quant_ms = gemm_bound = quant_bound = 0.0
    gemms = wan5b_w8a8_gemms(cfg, s)
    for (m, k, n_), count in gemms.items():
        a, sa, lin, args = _w8a8_operands("int8", m, k, n_, g, dev)
        x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        same_q = all(torch.equal(u, v) for u, v in
                     zip(cb.quantize_to_int8_cuda(x, symmetric=False),
                         tb.quantize_to_int8_torch(x, symmetric=False)))
        _int8_exact(args, f"Wan5B {m}x{k} @ {k}x{n_}")  # raises on a mismatch
        g_ms = cuda_ms(lambda: cb.int8_matmul_cuda(*args), 5)
        q_ms = cuda_ms(lambda: cb.quantize_to_int8_cuda(x, symmetric=False), 5)
        # the library yardstick: torch._int_mm (the s32 product only; M, K, N
        # are multiples of 8 at every Wan5B shape)
        lib_ms = cuda_ms(lambda: torch._int_mm(a, lin.w), 5)
        g_plain = cuda_ms(lambda: tb.int8_matmul_torch(*args), 2, 1)
        q_plain = cuda_ms(lambda: tb.quantize_to_int8_torch(x, symmetric=False), 3, 1)
        gb = bound(_gemm_bytes(m, k, n_), 2 * m * n_ * k, INT8_FP8_OPS)[0]
        qb = bound(_quantize_bytes(m, k, False), 8 * m * k, F32_FLOPS)[0]
        log(f"[int8 w8a8] Wan5B {m}x{k} @ {k}x{n_} ({count} per forward): quantize bit-exact "
            f"{same_q}, GEMM bit-exact with and without azp; GEMM {g_ms:.4f} ms (bound "
            f"{gb:.4f}, {gb / g_ms:.1%}; plain {g_plain:.4f} ms), library (torch._int_mm, s32 "
            f"product only) {lib_ms:.4f} ms, quantize {q_ms:.4f} ms (bound {qb:.4f}, "
            f"{qb / q_ms:.1%}; plain {q_plain:.4f} ms)")
        if not same_q:
            raise AssertionError(f"quantize_to_int8 disagrees with its plain version at Wan5B "
                                 f"{m}x{k}")
        gemm_ms += count * g_ms
        quant_ms += count * q_ms
        gemm_bound += count * gb
        quant_bound += count * qb
        del a, sa, lin, args, x
    torch.cuda.empty_cache()
    split["int8 GEMMs"], split["int8 quantize"] = gemm_ms, quant_ms
    log(f"[wan5b] int8 forward from the kernels timed alone x launches "
        f"({sum(gemms.values())} W8A8 linears; GEMM bound {gemm_bound:.1f} ms, quantize bound "
        f"{quant_bound:.1f} ms): " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; total {sum(split.values()):.1f} ms")


def wan5b_w8a8_gemms(cfg, tokens: int) -> dict:
    """The W8A8 linears of one Wan forward with no token chunking, (M, K, N)
    -> count: per block the fused QKV, self to_out, cross q and to_out, the
    two FFN linears on the video tokens, cross K|V on the text."""
    d, n = cfg.inner_dim, cfg.num_layers
    return {(tokens, d, 3 * d): n, (tokens, d, d): 3 * n, (WAN_TEXT, d, 2 * d): n,
            (tokens, d, cfg.ffn_dim): n, (tokens, cfg.ffn_dim, d): n}


class _Timed:
    """Wraps module functions for the duration of a with-block and adds the
    device-synced seconds of each call to `seconds[name]` (the engine imports
    them from their module at call time)."""

    def __init__(self, module, *names):
        self.module, self.names, self.seconds, self.saved = module, names, {}, {}

    def __enter__(self):
        import torch

        for name in self.names:
            fn = self.saved[name] = getattr(self.module, name)

            def timed(*a, _fn=fn, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t0
                return out

            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def phase_wan5b(dev) -> dict:
    """Wan2.2-TI2V-5B int8 at full width and depth (30 blocks, 24x128 heads,
    ffn 14336, 48 latent channels, per-token timesteps) at 768x768x121, as
    bench.py's wan5b row: one forward with the TI2V per-token timestep on the
    kernels held to the plain forward and bit for bit to the forward with only
    the int8 ops plain, with exact launches; then FastDMEngine on a written
    checkpoint (pos_embed_seq_len in transformer/config.json, the full-size
    residual VAE with its encoder): a t2v request (UniPC shift 5, CFG 5.0,
    FBCache with warmup 8 cut to 1, 50 steps cut to 4, the chunked VAE
    decode) and a ti2v request on a seeded 768x768 image whose first latent
    frame must come back equal to the encoded image; then Wan i2v at
    Wan2.2-I2V-A14B width (in_channels 36, two experts of 2 blocks, the
    Wan2.1-layout VAE's encoder) at 480x832x81, 2 steps. Returns the
    phase's seconds and peak GiB, for the summary line."""
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.caching.config import CacheConfig
    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.wan import wan_forward, wan_init_random
    from fastdm_tpu_torch.pipeline import wan_vae
    from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler

    cfg, vcfg = wan5b_config()
    lf, lh, lw, tokens = _wan5b_shape()
    t0 = time.perf_counter()
    params = wan_init_random(81, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[wan5b] Wan2.2-TI2V-5B int8 random init: {n / 1e9:.3f} B params ({nbytes / 2**30:.2f} "
        f"GiB), {cfg.num_layers} blocks, {cfg.num_attention_heads}x{cfg.attention_head_dim} "
        f"heads, ffn {cfg.ffn_dim}, in {time.perf_counter() - t0:.1f} s; {WAN5B_H}x{WAN5B_W}x"
        f"{WAN5B_FRAMES} = {lf}x{lh}x{lw} latents, {tokens} tokens")
    g = torch.Generator(device=dev).manual_seed(82)
    x = torch.randn(1, cfg.in_channels, lf, lh, lw, generator=g, device=dev).bfloat16()
    pos = torch.randn(1, WAN_TEXT, cfg.text_dim, generator=g, device=dev, dtype=torch.bfloat16)
    sched = UniPCMultistepScheduler.create(WAN5B_STEPS, shift=5.0)
    per_frame = (lh // 2) * (lw // 2)
    t = torch.full((1, tokens), float(sched.sigmas[1]) * 1000.0, device=dev)
    t[:, :per_frame] = 0.0  # the TI2V form: the conditioning frame's tokens at 0

    def forward(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return wan_forward(params, cfg, x, t, pos).float()

    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    forward()
    torch.cuda.synchronize()
    counts = _launch_counts()
    want = wan_forward_launches(cfg, tokens)
    log(f"[wan5b] kernel launches of one forward: {({k: v for k, v in counts.items() if v})}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want or (counts["quantize_to_int8"], counts["int8_matmul"], counts["sdpa"],
                          counts["rmsnorm"], counts["qk_norm_rope"]) != (210, 210, 60, 60, 30):
        raise AssertionError(f"Wan5B launch counts {counts} != derived {want}")
    summary = {"forward peak GiB": round(torch.cuda.max_memory_allocated() / 2**30, 2)}
    summary["forward s (kernels, plain)"] = tuple(round(v, 3) for v in _forward_gate(
        "wan5b int8", forward, WAN5B_FORWARD_REL_L2_TOL, ("quantize_to_int8", "int8_matmul")))
    del params, x
    torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    fbcache = _cache_json("fbcache_wan.json", warmup_steps=1)
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
        t0 = time.perf_counter()
        _write_wan_checkpoint(root, dev, cfg, experts=1, vcfg=vcfg, seed=83,
                              extra_config={"pos_embed_seq_len": tokens})
        log(f"[wan5b engine] wrote the synthetic Wan2.2-TI2V-5B checkpoint ({cfg.num_layers} "
            f"blocks in bf16, the full-size residual VAE) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        eng = FastDMEngine(root, architecture="wan2.2-ti2v", use_int8=True, cache_config=fbcache,
                           verbose=False, device=dev)
        torch.cuda.synchronize()
        log(f"[wan5b engine] FastDMEngine loaded in {time.perf_counter() - t0:.1f} s: "
            f"per_token_timestep {eng.cfg.per_token_timestep}, {eng.cfg.num_layers} blocks, "
            f"block linears {eng.params.blocks[0].attn1.qkv.w.dtype}, VAE {eng.vae_cfg}, encoder "
            f"loaded {'encoder' in (eng.vae_params or {})}; cache {CacheConfig.from_dict(fbcache)}")
        if not (eng.cfg.per_token_timestep and eng.vae_params is not None
                and "encoder" in eng.vae_params and eng.vae_cfg.patch_size == 2
                and eng.params.blocks[0].attn1.qkv.w.dtype == torch.int8):
            raise AssertionError("the Wan5B engine did not load the per-token int8 transformer "
                                 "and the residual VAE")
        g = torch.Generator(device=dev).manual_seed(84)
        pos, neg = (torch.randn(1, WAN_TEXT, cfg.text_dim, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
        kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=WAN5B_H, width=WAN5B_W,
                  num_frames=WAN5B_FRAMES, num_inference_steps=WAN5B_STEPS,
                  guidance_scale=WAN5B_CFG, seed=85)
        fwds = 2 * WAN5B_STEPS
        probe = wan_forward_launches(cfg, tokens, blocks=range(1))
        rest = wan_forward_launches(cfg, tokens, blocks=range(1, cfg.num_layers))
        for task in ("t2v", "ti2v"):
            image = None
            if task == "ti2v":
                image = np.random.default_rng(86).integers(0, 256, (WAN5B_H, WAN5B_W, 3),
                                                           dtype=np.uint8)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_backend.reset_launch_counts()
            with _Timed(wan_vae, "wan_vae_encode", "wan_vae_decode_chunked") as tm:
                t0 = time.perf_counter()
                out = eng.generate(task=task, image=image, **kw,
                                   output_type="latent" if task == "ti2v" else "np")
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            counts, skips = _launch_counts(), eng.last_cache_skips
            want = {k: fwds * a + (fwds - skips) * b for (k, a), b in
                    zip(probe.items(), rest.values())}
            summary[f"{task} request s (VAE encode, decode)"] = (
                round(sec, 3), round(tm.seconds.get("wan_vae_encode", 0.0), 3),
                round(tm.seconds.get("wan_vae_decode_chunked", 0.0), 3))
            summary[f"{task} peak GiB"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
            log(f"[wan5b engine] {task} request {WAN5B_H}x{WAN5B_W}x{WAN5B_FRAMES}, "
                f"{WAN5B_STEPS} steps, CFG {WAN5B_CFG}, FBCache (warmup 1): {sec:.3f} s (VAE "
                f"encode {tm.seconds.get('wan_vae_encode', 0.0):.3f} s, chunked VAE decode "
                f"{tm.seconds.get('wan_vae_decode_chunked', 0.0):.3f} s), output "
                f"{out.shape} {out.dtype}, FBCache skipped {skips} of {fwds} forwards; launches "
                f"{({k: v for k, v in counts.items() if v})}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if counts != want:
                raise AssertionError(f"Wan5B {task} launches {counts} != derived {want}")
            if task == "t2v":
                if not (out.dtype == np.uint8 and out.shape == (1, WAN5B_FRAMES, WAN5B_H,
                                                                 WAN5B_W, 3)):
                    raise AssertionError(f"the Wan5B t2v request returned {out.shape}")
                continue
            img = torch.from_numpy(image).to(dev).float()[None, None] / 127.5 - 1.0
            cond = wan_vae.wan_vae_encode(eng.vae_params, eng.vae_cfg, img).cpu().numpy()
            same = np.array_equal(out[:, :, :1], cond)
            log(f"[wan5b engine] ti2v: latents {out.shape}, the first latent frame equals the "
                f"encoded image {cond.shape} bit for bit: {same} (required); finite "
                f"{bool(np.isfinite(out).all())}")
            if not (same and np.isfinite(out).all() and out.shape == (1, cfg.out_channels, lf,
                                                                        lh, lw)):
                raise AssertionError("the Wan5B ti2v request did not keep the encoded image")
        del eng
        torch.cuda.empty_cache()
    summary.update(_wan_i2v(dev, here))
    return summary


def _wan_i2v(dev, here: str) -> dict:
    """Wan i2v channel-concat conditioning at Wan2.2-I2V-A14B width:
    FastDMEngine (use_int8) on a written checkpoint with two experts of
    I2V_LAYERS blocks, in_channels 36, and the full-size Wan2.1-layout VAE;
    generate(task="i2v") on a seeded 480x832 image at 81 frames, 2 steps (one
    per expert), latents out: the engine's _wan_i2v_latents encodes the image
    and 80 zero frames and packs the frame mask; exact launches. Returns the
    request's seconds and peak GiB."""
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.wan import WanConfig
    from fastdm_tpu_torch.pipeline import wan_vae

    cfg = dataclasses.replace(WanConfig(), num_layers=I2V_LAYERS, in_channels=36)
    lf, lh, lw, tokens = _wan_shape(WAN_FRAMES)
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
        t0 = time.perf_counter()
        _write_wan_checkpoint(root, dev, cfg, experts=2, seed=87)
        log(f"[wan i2v] wrote the synthetic Wan2.2-I2V-A14B checkpoint (two experts of "
            f"{I2V_LAYERS} blocks, in_channels 36, the full-size Wan2.1-layout VAE) in "
            f"{time.perf_counter() - t0:.1f} s")
        eng = FastDMEngine(root, architecture="wan2.2-i2v", use_int8=True, verbose=False,
                           device=dev)
        g = torch.Generator(device=dev).manual_seed(88)
        pos, neg = (torch.randn(1, WAN_TEXT, cfg.text_dim, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
        image = np.random.default_rng(89).integers(0, 256, (WAN_H, WAN_W, 3), dtype=np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_backend.reset_launch_counts()
        with _Timed(wan_vae, "wan_vae_encode") as tm:
            t0 = time.perf_counter()
            lat = eng.generate(task="i2v", image=image, prompt_embeds=pos,
                               negative_prompt_embeds=neg, height=WAN_H, width=WAN_W,
                               num_frames=WAN_FRAMES, num_inference_steps=I2V_STEPS,
                               guidance_scale=WAN_CFG[0], guidance_scale_2=WAN_CFG[1], seed=90,
                               output_type="latent")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        counts = _launch_counts()
        per_fwd = wan_forward_launches(eng.cfg, tokens)
        want = {k: 2 * I2V_STEPS * v for k, v in per_fwd.items()}
        log(f"[wan i2v] request {WAN_H}x{WAN_W}x{WAN_FRAMES}, {I2V_STEPS} steps, CFG {WAN_CFG}: "
            f"{sec:.3f} s (VAE encode of the {WAN_FRAMES}-frame conditioning video "
            f"{tm.seconds.get('wan_vae_encode', 0.0):.3f} s), latents {lat.shape}, steps per "
            f"expert {eng.last_phase_steps}, finite {bool(np.isfinite(lat).all())}; launches "
            f"{({k: v for k, v in counts.items() if v})}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (lat.shape == (1, 16, lf, lh, lw) and np.isfinite(lat).all()
                and eng.last_phase_steps == (1, 1) and counts == want):
            raise AssertionError(f"the Wan i2v request: {lat.shape}, steps "
                                 f"{eng.last_phase_steps}, launches {counts} != {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del eng
        torch.cuda.empty_cache()
    return {"i2v request s (VAE encode)": (round(sec, 3),
                                           round(tm.seconds.get("wan_vae_encode", 0.0), 3)),
            "i2v peak GiB": round(peak, 2)}


def _linear_writer(sd: dict, g, dev):
    """lin(name, k, n): a diffusers Linear (out, in) weight ~ N(0, 1/k) and a
    zero bias, bf16 on the host."""
    import torch

    def lin(name, k, n):
        sd[f"{name}.weight"] = (torch.randn(n, k, generator=g, device=dev) * k**-0.5
                                ).bfloat16().cpu()
        sd[f"{name}.bias"] = torch.zeros(n, dtype=torch.bfloat16)

    return lin


def _write_sd35_checkpoint(root: str, dev) -> None:
    """Synthetic diffusers-layout SD3.5-medium checkpoint: the published
    widths with one dual, one standard and the last block (transformer/
    config.json with dual_attention_layers [0]), pos_embed.pos_embed as the
    full 384 x 384 f32 table, and the full-size 16-channel AutoencoderKL
    (decoder and encoder) in vae/."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.layers.embeddings import sincos_pos_embed_2d
    from fastdm_tpu_torch.models.sd35 import SD3Config
    from fastdm_tpu_torch.pipeline.vae import VAEConfig

    cfg = SD3Config(num_layers=3, num_dual_layers=1)
    g = torch.Generator(device=dev).manual_seed(13)
    d, hd, m, p = cfg.inner_dim, cfg.attention_head_dim, cfg.pos_embed_max_size, cfg.patch_size
    sd = {"pos_embed.proj.weight": (torch.randn(d, cfg.in_channels, p, p, generator=g,
                                                device=dev) * 0.05).bfloat16().cpu(),
          "pos_embed.proj.bias": torch.zeros(d, dtype=torch.bfloat16),
          "pos_embed.pos_embed": torch.from_numpy(sincos_pos_embed_2d(
              d, m, m, base_size=cfg.sample_size // p).astype("float32"))[None]}
    lin = _linear_writer(sd, g, dev)
    for e, k in (("timestep_embedder", 256), ("text_embedder", cfg.pooled_projection_dim)):
        lin(f"time_text_embed.{e}.linear_1", k, d)
        lin(f"time_text_embed.{e}.linear_2", d, d)
    lin("context_embedder", cfg.joint_attention_dim, cfg.caption_projection_dim)
    for i in range(cfg.num_layers):
        pre, last, dual = f"transformer_blocks.{i}", i == cfg.num_layers - 1, i == 0
        lin(f"{pre}.norm1.linear", d, (9 if dual else 6) * d)
        lin(f"{pre}.norm1_context.linear", d, (2 if last else 6) * d)
        names = ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0"]
        for nm in names + ([] if last else ["to_add_out"]):
            lin(f"{pre}.attn.{nm}", d, d)
        norms = [("attn", nm) for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k")]
        if dual:
            for nm in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(f"{pre}.attn2.{nm}", d, d)
            norms += [("attn2", "norm_q"), ("attn2", "norm_k")]
        for a, nm in norms:
            sd[f"{pre}.{a}.{nm}.weight"] = torch.ones(hd, dtype=torch.bfloat16)
        for ff in ("ff",) + (() if last else ("ff_context",)):
            lin(f"{pre}.{ff}.net.0.proj", d, 4 * d)
            lin(f"{pre}.{ff}.net.2", 4 * d, d)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, p * p * cfg.out_channels)
    os.makedirs(os.path.join(root, "transformer"))
    save_file(sd, os.path.join(root, "transformer", "model.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump({"num_layers": cfg.num_layers, "dual_attention_layers": [0]}, f)
    os.makedirs(os.path.join(root, "vae"))
    save_file(_vae_state_dict(VAEConfig(latent_channels=16), g, dev),
              os.path.join(root, "vae", "model.safetensors"))


def _write_qwen_checkpoint(root: str, dev) -> None:
    """Synthetic diffusers-layout Qwen-Image checkpoint: the published widths
    with two blocks (bf16; the engine quantizes at load) and the full-size
    Wan-layout VAE decoder with a vae/config.json carrying base_dim."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.qwenimage import QwenImageConfig

    cfg = QwenImageConfig(num_layers=2)
    g = torch.Generator(device=dev).manual_seed(14)
    d, hd = cfg.inner_dim, cfg.attention_head_dim
    sd = {"txt_norm.weight": torch.ones(cfg.joint_attention_dim, dtype=torch.bfloat16)}
    lin = _linear_writer(sd, g, dev)
    lin("img_in", cfg.in_channels, d)
    lin("txt_in", cfg.joint_attention_dim, d)
    lin("time_text_embed.timestep_embedder.linear_1", 256, d)
    lin("time_text_embed.timestep_embedder.linear_2", d, d)
    for i in range(cfg.num_layers):
        pre = f"transformer_blocks.{i}"
        lin(f"{pre}.img_mod.1", d, 6 * d)
        lin(f"{pre}.txt_mod.1", d, 6 * d)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0",
                   "to_add_out"):
            lin(f"{pre}.attn.{nm}", d, d)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            sd[f"{pre}.attn.{nm}.weight"] = torch.ones(hd, dtype=torch.bfloat16)
        for mlp in ("img_mlp", "txt_mlp"):
            lin(f"{pre}.{mlp}.net.0.proj", d, 4 * d)
            lin(f"{pre}.{mlp}.net.2", 4 * d, d)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg.patch_size**2 * cfg.out_channels)
    os.makedirs(os.path.join(root, "transformer"))
    save_file(sd, os.path.join(root, "transformer", "model.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump({"num_layers": cfg.num_layers}, f)
    _write_wan_vae(root, dev, 15)


def _engine_mmdit(dev, here: str, summary: dict) -> None:
    """FastDMEngine on the synthetic SD3.5-medium checkpoint with use_int8 (one
    1024x2048 CFG generate, then an SDEdit i2i) and on the synthetic
    Qwen-Image checkpoint as qwen-image-edit with use_int4, pack_int4 and
    quant_mods (quantize_weight's SVDQuant split on the card; one 1024x2048
    t2i generate, true CFG 1.0, decoded by the Wan VAE route its
    vae/config.json names; then an edit through that VAE and, on a bf16
    engine, through an AutoencoderKL vae/); launches as derived per step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.pipeline.vae import VAEConfig
    from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig

    for arch, writer, flags in (("sd35", _write_sd35_checkpoint, {"use_int8": True}),
                                ("qwen-image-edit", _write_qwen_checkpoint,
                                 {"use_int4": True, "pack_int4": True, "quant_mods": True})):
        with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
            t0 = time.perf_counter()
            writer(root, dev)
            if arch == "sd35":
                _link_text_dirs(root, "sd35")
            size = os.path.getsize(os.path.join(root, "transformer", "model.safetensors"))
            log(f"[engine {arch}] wrote the synthetic checkpoint (transformer/ {size / 1e9:.2f} "
                f"GB, full-size vae/) in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            eng = FastDMEngine(root, architecture=arch, verbose=False, **flags)
            torch.cuda.synchronize()
            cfg = eng.cfg
            g = torch.Generator(device=dev).manual_seed(400)
            if arch == "sd35":
                qkv = eng.params.dual_blocks[0].attn2.qkv.w
                ok = (qkv.dtype == torch.int8 and cfg.num_dual_layers == 1
                      and eng.params.pos_embed_table is not None
                      and eng.vae_cfg.latent_channels == 16)
                pos, neg = (torch.randn(1, SD35_TEXT, cfg.joint_attention_dim, generator=g,
                                        device=dev, dtype=torch.bfloat16) for _ in range(2))
                pos_pooled, neg_pooled = (torch.randn(1, cfg.pooled_projection_dim, generator=g,
                                                      device=dev, dtype=torch.bfloat16)
                                          for _ in range(2))
                kw = dict(prompt_embeds=pos, pooled_prompt_embeds=pos_pooled,
                          negative_prompt_embeds=neg, negative_pooled_prompt_embeds=neg_pooled,
                          guidance_scale=SD35_CFG, num_inference_steps=SD35_STEPS)
                want = {k: v * SD35_STEPS for k, v in sd35_forward_launches(cfg).items()}
                shape = (1, SD35_H, SD35_W, 3)
            else:
                lin = eng.params.blocks[1].txt_mod
                ok = (lin.w4p is not None and torch.isfinite(lin.lora_u).all()
                      and isinstance(eng.vae_cfg, WanVAEConfig))
                kw = dict(prompt_embeds=torch.randn(1, QWEN_TEXT, cfg.joint_attention_dim,
                                                    generator=g, device=dev,
                                                    dtype=torch.bfloat16),
                          true_cfg_scale=QWEN_CFG, num_inference_steps=QWEN_STEPS)
                computed, every = qwen_forward_launches(cfg, teacache=False)
                want = {k: (computed[k] + every[k]) * QWEN_STEPS for k in computed}
                shape = (1, 16 * QWEN_HT, 16 * QWEN_WT, 3)
            log(f"[engine {arch}] FastDMEngine {flags} loaded in {time.perf_counter() - t0:.1f} s: "
                f"{cfg.num_layers} blocks, inner dim {cfg.inner_dim}, VAE "
                f"{type(eng.vae_cfg).__name__}; formats as asked: {bool(ok)}")
            if not ok:
                raise AssertionError(f"the {arch} engine loaded the wrong formats or VAE")
            cuda_backend.reset_launch_counts()
            t0 = time.perf_counter()
            img = eng.generate(height=shape[1], width=shape[2], seed=11, **kw)
            sec = time.perf_counter() - t0
            counts = _launch_counts()
            log(f"[engine {arch}] generate {shape[1]}x{shape[2]} {kw['num_inference_steps']} "
                f"steps: {sec:.3f} s, image {img.shape} {img.dtype}; launches {counts}")
            if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.shape == shape) \
                    or counts != want:
                raise AssertionError(f"the {arch} generate returned "
                                     f"{getattr(img, 'shape', type(img))}, launches {counts} != "
                                     f"derived {want}")
            if arch == "sd35":
                _engine_prompt(eng, "engine sd35", dict(kw, height=shape[1], width=shape[2],
                                                        seed=11))
                _engine_i2i(eng, "engine sd35", sd35_forward_launches(cfg), kw, 16, summary)
            else:
                # Qwen-Image-Edit through the Wan-layout VAE, then through an
                # AutoencoderKL vae/ (no base_dim) on a bf16 engine
                per = {k: computed[k] + every[k] for k in computed}
                _engine_i2i(eng, "engine qwen-image-edit wan-vae", per, kw, 16, summary)
                del eng
                torch.cuda.empty_cache()
                shutil.rmtree(os.path.join(root, "vae"))
                os.makedirs(os.path.join(root, "vae"))
                save_file(_vae_state_dict(VAEConfig(latent_channels=16), g, dev),
                          os.path.join(root, "vae", "model.safetensors"))
                eng = FastDMEngine(root, architecture=arch, verbose=False)
                if eng.cfg.quant is not None or isinstance(eng.vae_cfg, WanVAEConfig):
                    raise AssertionError("the second qwen-image-edit engine is not bf16 on the "
                                         "AutoencoderKL")
                per = {k: 0 if k in W4A4_OPS else v for k, v in per.items()}
                _engine_i2i(eng, "engine qwen-image-edit autoencoderkl", per, kw, 16, summary)
            del eng
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ text


def _clip_vocab(seed: int):
    """A CLIP-layout BPE of 49408 ids, drawn from a seed: the 256 byte
    symbols, each again with </w>, 48894 merges (a lowercase piece and one
    letter, a third of them ending a word), <|startoftext|>, <|endoftext|>."""
    import numpy as np

    from fastdm_tpu_torch.pipeline.tokenizers import bytes_to_unicode

    rng = np.random.default_rng(seed)
    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    seen, inner, letters = set(vocab), list("abcdefghijklmnopqrstuvwxyz"), "etaoinshrdlucmfwypvbgkqjxz"
    merges, n_merges = [], 49408 - 2 - len(vocab)
    while len(merges) < n_merges:
        a = inner[int(rng.integers(len(inner)))]
        if len(a) > 8:
            continue
        b = letters[min(int(rng.exponential(6.0)), 25)]
        b = b + "</w>" if rng.random() < 0.33 else b
        if a + b in seen:
            continue
        seen.add(a + b)
        merges.append((a, b))
        vocab.append(a + b)
        if not b.endswith("</w>"):
            inner.append(a + b)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(vocab)}, merges


def _unigram_vocab(seed: int, size: int):
    """A Unigram vocabulary of `size` pieces drawn from a seed: <pad>, </s>,
    <unk>, ▁, the printable ASCII characters, ▁ + each word of TEXT_PROMPTS,
    then lowercase pieces of 2-8 letters (half after ▁); scores in (-14, -2)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pieces = ["▁"] + [chr(c) for c in range(33, 127)]
    pieces += sorted({"▁" + w for p in TEXT_PROMPTS for w in p.lower().split()})
    seen = set(pieces)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(pieces) < size - 3:
        for n, pre in zip(rng.integers(2, 9, 4096), rng.random(4096) < 0.5):
            p = ("▁" if pre else "") + "".join(letters[rng.integers(0, 26, n)])
            if p not in seen and len(pieces) < size - 3:
                seen.add(p)
                pieces.append(p)
    scores = -rng.uniform(2.0, 14.0, len(pieces))
    return [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + list(zip(pieces, scores.tolist()))


# the charsmap of the synthetic T5 / UMT5 tokenizers: full-width letters, the
# ellipsis, NBSP, a ligature (sentencepiece's nmt_nfkc maps these so)
TEXT_CHARSMAP = dict({chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
                     **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
                     **{"…": "...", "\u00a0": " ", "ﬁ": "fi", "\u3000": " "})


def _write_tokenizers(base: str, names=("clip-tok", "clip-tok-bang", "t5-tok",
                                         "umt5-tok")) -> dict:
    """CLIP's (padded with <|endoftext|>, and with "!" as bigG's), T5's and
    UMT5's tokenizer directories under base -> {name: path}."""
    from fastdm_tpu_torch.pipeline.tokenizers import save_clip_tokenizer, \
        save_unigram_tokenizer

    paths = {n: os.path.join(base, n) for n in names}
    if "clip-tok" in names or "clip-tok-bang" in names:
        vocab, merges = _clip_vocab(600)
        for n, pad in (("clip-tok", "<|endoftext|>"), ("clip-tok-bang", "!")):
            if n in names:
                save_clip_tokenizer(paths[n], vocab, merges, pad_token=pad)
    for n, seed, size in (("t5-tok", 601, T5_PIECES), ("umt5-tok", 602, UMT5_PIECES)):
        if n in names:
            save_unigram_tokenizer(paths[n], _unigram_vocab(seed, size), TEXT_CHARSMAP)
    return paths


def _text_config(kind: str, kw: dict, layers: Optional[int] = None):
    from fastdm_tpu_torch.models.clip_text import CLIPTextConfig
    from fastdm_tpu_torch.models.t5 import T5Config

    if kind == "clip":
        cfg = CLIPTextConfig(**kw)
        return cfg if layers is None else dataclasses.replace(cfg, num_hidden_layers=layers)
    cfg = T5Config(**kw)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def _text_model(kind: str, cfg, seed: int, dev):
    from fastdm_tpu_torch.models.clip_text import clip_text_init_random
    from fastdm_tpu_torch.models.t5 import t5_encoder_init_random

    if kind == "clip":
        return clip_text_init_random(seed, cfg, True, dev)
    return t5_encoder_init_random(seed, cfg, dev)


def _text_outputs(kind: str, model, ids, mask) -> list:
    """What the engine's encoders read: CLIP's penultimate states, pooled
    and projected tokens; T5's states unmasked (FLUX, SD3.5); UMT5's masked
    and zeroed past the mask (Wan)."""
    import torch

    with torch.inference_mode():
        if kind == "clip":
            out = model(ids)
            return [out.penultimate, out.pooler_output, out.text_embeds]
        if kind == "t5":
            return [model(ids)]
        return [model(ids, mask) * mask[..., None]]


def _text_flops(kind: str, cfg, b: int, s: int) -> float:
    """Multiply-adds x 2 of one encode: the projections, the FFN, q.k and p.v."""
    if kind == "clip":
        d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
        per_token = 4 * d * d + 2 * d * f + 2 * s * d
    else:
        d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
        inner = cfg.num_heads * cfg.d_kv
        per_token = 4 * d * inner + 3 * d * f + 2 * s * inner
    return 2.0 * per_token * b * s * n


def phase_text(dev) -> None:
    """The four text encoders at full width and depth on the card in f32,
    from seeds: each tokenizes TEXT_PROMPTS through the port's tokenizer of
    a directory this phase writes, encodes the pair at each of its lengths
    (a warm-up, then one timed encode: seconds, f32 TFLOP/s, peak GiB), its
    outputs finite; then its first two layers (and embeddings, final norm,
    projection) on the card are held to the same two layers on the CPU,
    within TEXT_REL_L2_TOL; then it is freed."""
    import tempfile

    import torch

    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.pipeline.tokenizers import load_tokenizer

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-tok-") as base:
        t0 = time.perf_counter()
        paths = _write_tokenizers(base)
        log(f"[text] wrote the CLIP (49408 ids), T5 ({T5_PIECES} pieces) and UMT5 "
            f"({UMT5_PIECES}) tokenizers in {time.perf_counter() - t0:.1f} s")
        for i, (name, kind, kw, tok_name, lengths) in enumerate(TEXT_ENCODERS):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cfg = _text_config(kind, kw)
            t0 = time.perf_counter()
            model = _text_model(kind, cfg, 500 + i, dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            n_params = sum(p.numel() for p in model.parameters())
            weights = torch.cuda.memory_allocated() / 2**30
            t0 = time.perf_counter()
            tok = load_tokenizer(paths[tok_name])
            load_s = time.perf_counter() - t0
            cuda_backend.reset_launch_counts()
            entry = {"params": n_params, "weights_gib": round(weights, 3),
                     "init_s": round(init_s, 3), "tokenizer_load_s": round(load_s, 3)}
            for length in lengths:
                t0 = time.perf_counter()
                ids, mask = tok(list(TEXT_PROMPTS), length)
                tok_s = time.perf_counter() - t0
                ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
                _text_outputs(kind, model, ids, mask)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                outs = _text_outputs(kind, model, ids, mask)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2**30
                tflops = _text_flops(kind, cfg, 2, length) / sec / 1e12
                if not all(bool(torch.isfinite(o).all()) for o in outs) or \
                        outs[0].shape[:2] != (2, length):
                    raise AssertionError(f"{name} encoded to {[tuple(o.shape) for o in outs]} "
                                         "or to non-finite values")
                log(f"[text {name}] {n_params / 1e9:.3f} B params ({weights:.2f} GiB f32, "
                    f"drawn in {init_s:.2f} s): a CFG pair at {length} tokens "
                    f"({mask.sum(1).tolist()} real), tokenized in {tok_s * 1e3:.1f} ms, encoded "
                    f"in {sec * 1e3:.2f} ms "
                    f"({tflops:.1f} TFLOP/s f32), peak {peak:.2f} GiB")
                entry[f"encode_{length}_s"] = round(sec, 5)
                entry[f"peak_{length}_gib"] = round(peak, 3)
            if any(_launch_counts().values()):
                raise AssertionError(f"{name} launched a kernel: {_launch_counts()}")
            # the first two layers, on the card and on the CPU
            small = _text_config(kind, kw, layers=2)
            with torch.device("meta"):
                gpu2 = type(model)(small, True) if kind == "clip" else type(model)(small)
                cpu2 = type(model)(small, True) if kind == "clip" else type(model)(small)
            full = model.state_dict()
            gpu2.load_state_dict({k: full[k] for k in gpu2.state_dict()}, assign=True)
            cpu2.load_state_dict({k: full[k].cpu() for k in cpu2.state_dict()}, assign=True)
            length = lengths[0]
            ids, mask = tok(list(TEXT_PROMPTS), length)
            ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
            t0 = time.perf_counter()
            want = _text_outputs(kind, cpu2, ids, mask)
            cpu_s = time.perf_counter() - t0
            got = _text_outputs(kind, gpu2, ids.to(dev), mask.to(dev))
            errs = [float((g.cpu() - w).norm() / w.norm()) for g, w in zip(got, want)]
            log(f"[text {name}] 2 layers on the card vs the CPU at {length} tokens: relative L2 "
                f"{[f'{e:.3e}' for e in errs]} (gate {TEXT_REL_L2_TOL}; CPU {cpu_s:.1f} s)")
            if max(errs) > TEXT_REL_L2_TOL:
                raise AssertionError(f"{name}: the card's two layers are {errs} from the CPU's")
            entry["two_layer_rel_l2"] = [float(f"{e:.3e}") for e in errs]
            TEXT_SUMMARY[name] = entry
            del model, gpu2, cpu2, full, got, want, outs
            torch.cuda.empty_cache()


def _write_text_dirs(base: str, dev) -> dict:
    """The tokenizers and the four encoders at full width, two layers each,
    in bf16 (save_text_encoder), under base, for phase 4's checkpoints."""
    import torch

    from fastdm_tpu_torch.pipeline.text_encoder import save_text_encoder

    paths = _write_tokenizers(base)
    for i, (name, kind, kw, _, _) in enumerate(TEXT_ENCODERS):
        model = _text_model(kind, _text_config(kind, kw, layers=2), 700 + i, dev)
        paths[name] = os.path.join(base, name)
        save_text_encoder(model, paths[name], torch.bfloat16)
        del model
    return paths


# the tokenizer*/ and text_encoder*/ directories of each family, from the
# names of _write_text_dirs (CLIP-L's directory holds its projection, which a
# CLIPTextModel leaves unread)
TEXT_LAYOUT = {
    "flux": {"tokenizer": "clip-tok", "text_encoder": "clip-l", "tokenizer_2": "t5-tok",
             "text_encoder_2": "t5-xxl"},
    "sdxl": {"tokenizer": "clip-tok", "text_encoder": "clip-l", "tokenizer_2": "clip-tok-bang",
             "text_encoder_2": "clip-bigg"},
    "sd35": {"tokenizer": "clip-tok", "text_encoder": "clip-l", "tokenizer_2": "clip-tok-bang",
             "text_encoder_2": "clip-bigg", "tokenizer_3": "t5-tok", "text_encoder_3": "t5-xxl"},
    "wan": {"tokenizer": "umt5-tok", "text_encoder": "umt5-xxl"},
}
# phase 4's text directories, written once and linked into each checkpoint
TEXT_DIRS: dict = {}


def _link_text_dirs(root: str, family: str) -> None:
    for sub, name in TEXT_LAYOUT[family].items():
        os.symlink(TEXT_DIRS[name], os.path.join(root, sub))


def _engine_prompt(eng, label: str, kw: dict) -> None:
    """One generate from TEXT_PROMPTS as prompt and negative_prompt on the
    engine's two-layer full-width encoders (encoded on the card, launching
    no kernel), equal bit for bit to the generate from the encoder's own
    embeddings of them."""
    import numpy as np
    import torch

    kw = {k: v for k, v in kw.items() if "prompt_embeds" not in k}
    prompt, negative = TEXT_PROMPTS
    t0 = time.perf_counter()
    eng.text_encoder.load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = eng.generate(prompt=prompt, negative_prompt=negative, **kw)
    sec = time.perf_counter() - t0
    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if eng.architecture == "wan":
        emb = dict(prompt_embeds=eng.text_encoder.encode(prompt),
                   negative_prompt_embeds=eng.text_encoder.encode(negative))
    else:
        pe, pp = eng.text_encoder.encode(prompt)
        emb = dict(prompt_embeds=pe, pooled_prompt_embeds=pp)
        if eng.architecture != "flux":
            ne, npool = eng.text_encoder.encode(negative)
            emb.update(negative_prompt_embeds=ne, negative_pooled_prompt_embeds=npool)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    if _launch_counts() != before:
        raise AssertionError(f"{label}: the text encoders launched a kernel")
    t0 = time.perf_counter()
    want = eng.generate(**emb, **kw)
    emb_s = time.perf_counter() - t0
    same = isinstance(got, np.ndarray) and got.shape == want.shape and np.array_equal(got, want)
    log(f"[{label}] 2-layer full-width encoders loaded in {load_s:.2f} s; generate from prompt "
        f"strings {sec:.3f} s, from their embeddings {emb_s:.3f} s (the CFG pair encoded in "
        f"{enc_s * 1e3:.1f} ms); {got.shape} equal: {same}; embeddings "
        f"{tuple(emb['prompt_embeds'].shape)}")
    if not same:
        raise AssertionError(f"{label}: generate from prompts != generate from their embeddings")
    TEXT_SUMMARY[f"{label} prompt generate_s"] = round(sec, 3)
    TEXT_SUMMARY[f"{label} embeddings generate_s"] = round(emb_s, 3)


# ------------------------------------------------------------------ phase 4


def _flux_lin_writer(sd: dict, g, dev):
    """lin(name, k, n): a diffusers Linear (out, in) weight ~ N(0, 0.02^2)
    and a N(0, 0.01^2) bias, bf16 on the host."""
    import torch

    def lin(name, k, n, std=0.02):
        sd[f"{name}.weight"] = (torch.randn(n, k, generator=g, device=dev) * std).bfloat16().cpu()
        sd[f"{name}.bias"] = (torch.randn(n, generator=g, device=dev) * 0.01).bfloat16().cpu()

    return lin


def _flux_trunk_sd(sd: dict, lin, cfg) -> None:
    """The embedders and cfg's dual and single blocks of a FLUX checkpoint
    under diffusers' names (what a FLUX ControlNet holds too)."""
    import torch

    d, mlp = cfg.inner_dim, cfg.mlp_hidden_dim
    for e, k in (("timestep_embedder", 256), ("guidance_embedder", 256),
                 ("text_embedder", cfg.pooled_projection_dim)):
        lin(f"time_text_embed.{e}.linear_1", k, d)
        lin(f"time_text_embed.{e}.linear_2", d, d)
    lin("context_embedder", cfg.joint_attention_dim, d)
    lin("x_embedder", cfg.in_channels, d)
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", d, 6 * d)
        lin(f"{p}.norm1_context.linear", d, 6 * d)
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0",
                  "to_add_out"):
            lin(f"{p}.attn.{n}", d, d)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            sd[f"{p}.attn.{n}.weight"] = torch.ones(cfg.attention_head_dim, dtype=torch.bfloat16)
        for ff in ("ff", "ff_context"):
            lin(f"{p}.{ff}.net.0.proj", d, mlp)
            lin(f"{p}.{ff}.net.2", mlp, d)
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", d, 3 * d)
        for n in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{n}", d, d)
        for n in ("norm_q", "norm_k"):
            sd[f"{p}.attn.{n}.weight"] = torch.ones(cfg.attention_head_dim, dtype=torch.bfloat16)
        lin(f"{p}.proj_mlp", d, mlp)
        lin(f"{p}.proj_out", d + mlp, d)


def _write_checkpoint(root: str, dev) -> None:
    """Synthetic diffusers-layout FLUX checkpoint: FLUX.1-dev widths with one
    dual and one single block, plus the full-size FLUX AutoencoderKL (decoder
    and encoder)."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.flux import FluxConfig
    from fastdm_tpu_torch.pipeline.vae import VAEConfig

    cfg = FluxConfig(num_layers=1, num_single_layers=1)
    g = torch.Generator(device=dev).manual_seed(5)
    sd = {}
    lin = _flux_lin_writer(sd, g, dev)
    _flux_trunk_sd(sd, lin, cfg)
    lin("norm_out.linear", cfg.inner_dim, 2 * cfg.inner_dim)
    lin("proj_out", cfg.inner_dim, cfg.out_channels)
    os.makedirs(os.path.join(root, "transformer"))
    save_file(sd, os.path.join(root, "transformer", "model.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump({"num_layers": 1, "num_single_layers": 1}, f)

    os.makedirs(os.path.join(root, "vae"))
    save_file(_vae_state_dict(VAEConfig(latent_channels=16), g, dev),
              os.path.join(root, "vae", "model.safetensors"))


def _vae_state_dict(vcfg, g, dev) -> dict:
    """A diffusers AutoencoderKL of config vcfg, decoder and encoder (the
    image-conditioned paths encode with it), under diffusers' names, f32 on
    the host."""
    import torch

    sd = {}

    def conv(name, cin, cout, k=3):
        sd[f"{name}.weight"] = (torch.randn(cout, cin, k, k, generator=g, device=dev)
                                * 0.05).cpu()
        sd[f"{name}.bias"] = torch.zeros(cout)

    def norm(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(c), torch.zeros(c)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, k=1)

    rev = list(reversed(vcfg.block_out_channels))
    top = rev[0]
    conv("decoder.conv_in", vcfg.latent_channels, top)
    resnet("decoder.mid_block.resnets.0", top, top)
    resnet("decoder.mid_block.resnets.1", top, top)
    norm("decoder.mid_block.attentions.0.group_norm", top)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        sd[f"decoder.mid_block.attentions.0.{n}.weight"] = (
            torch.randn(top, top, generator=g, device=dev) * 0.02).cpu()
        sd[f"decoder.mid_block.attentions.0.{n}.bias"] = torch.zeros(top)
    prev = top
    for i, c in enumerate(rev):
        for r in range(vcfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{r}", prev if r == 0 else c, c)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
        prev = c
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], 3)
    conv("post_quant_conv", vcfg.latent_channels, vcfg.latent_channels, k=1)
    chans = list(vcfg.block_out_channels)
    conv("encoder.conv_in", vcfg.in_channels, chans[0])
    prev = chans[0]
    for i, c in enumerate(chans):
        for r in range(vcfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{r}", prev if r == 0 else c, c)
        if i < len(chans) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
        prev = c
    resnet("encoder.mid_block.resnets.0", prev, prev)
    resnet("encoder.mid_block.resnets.1", prev, prev)
    norm("encoder.mid_block.attentions.0.group_norm", prev)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        sd[f"encoder.mid_block.attentions.0.{n}.weight"] = (
            torch.randn(prev, prev, generator=g, device=dev) * 0.02).cpu()
        sd[f"encoder.mid_block.attentions.0.{n}.bias"] = torch.zeros(prev)
    norm("encoder.conv_norm_out", prev)
    conv("encoder.conv_out", prev, 2 * vcfg.latent_channels)
    conv("quant_conv", 2 * vcfg.latent_channels, 2 * vcfg.latent_channels, k=1)
    return sd


def _write_wan_checkpoint(root: str, dev, cfg=None, experts: int = 2, vcfg=None,
                          extra_config=None, seed: int = 6) -> None:
    """Synthetic diffusers-layout Wan checkpoint: transformer/ (and, with two
    experts, transformer_2/ and a model_index.json with the published
    boundary_ratio) at cfg's widths and depth (bf16, the engine quantizes at
    load; extra_config joins transformer/config.json), and the full-size
    AutoencoderKLWan of vcfg in vae/. With cfg.image_dim, Wan2.1-I2V's image
    embedder and each block's add_k_proj / add_v_proj / norm_added_k, and
    image_dim / added_kv_proj_dim in the config. By default Wan2.2-T2V-A14B's
    two experts with one block each and the Wan2.1-layout VAE."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.wan import WanConfig

    cfg = cfg or dataclasses.replace(WanConfig(), num_layers=1)
    d, ffn = cfg.inner_dim, cfg.ffn_dim
    subs = ("transformer", "transformer_2")[:experts]
    for i, sub in enumerate(subs):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        sd = {}

        def lin(name, k, n, std=0.02):
            w = torch.randn(n, k, generator=g, device=dev) * std
            sd[f"{name}.weight"] = w.bfloat16().cpu()
            sd[f"{name}.bias"] = (torch.randn(n, generator=g, device=dev) * 0.01).bfloat16().cpu()

        sd["patch_embedding.weight"] = (torch.randn(d, cfg.in_channels, *cfg.patch_size,
                                                    generator=g, device=dev)
                                        * 0.05).bfloat16().cpu()
        sd["patch_embedding.bias"] = torch.zeros(d, dtype=torch.bfloat16)
        ce = "condition_embedder"
        lin(f"{ce}.time_embedder.linear_1", cfg.freq_dim, d)
        lin(f"{ce}.time_embedder.linear_2", d, d)
        lin(f"{ce}.time_proj", d, 6 * d)
        lin(f"{ce}.text_embedder.linear_1", cfg.text_dim, d)
        lin(f"{ce}.text_embedder.linear_2", d, d)
        sd["scale_shift_table"] = torch.randn(1, 2, d, generator=g, device=dev).cpu() / d**0.5
        lin("proj_out", d, cfg.out_channels * 4)
        image = {}
        if cfg.image_dim is not None:
            e, ie = cfg.image_dim, f"{ce}.image_embedder"
            lin(f"{ie}.ff.net.0.proj", e, e, e**-0.5)
            lin(f"{ie}.ff.net.2", e, d, e**-0.5)
            for nm, width in (("norm1", e), ("norm2", d)):
                sd[f"{ie}.{nm}.weight"], sd[f"{ie}.{nm}.bias"] = torch.ones(width), \
                    torch.zeros(width)
            image = {"image_dim": e, "added_kv_proj_dim": cfg.added_kv_proj_dim}
        for b in range(cfg.num_layers):
            p = f"blocks.{b}"
            sd[f"{p}.scale_shift_table"] = torch.randn(1, 6, d, generator=g,
                                                       device=dev).cpu() / d**0.5
            for a in ("attn1", "attn2"):
                for nm in ("to_q", "to_k", "to_v", "to_out.0"):
                    lin(f"{p}.{a}.{nm}", d, d)
                for nm in ("norm_q", "norm_k"):
                    sd[f"{p}.{a}.{nm}.weight"] = torch.ones(d, dtype=torch.bfloat16)
            lin(f"{p}.ffn.net.0.proj", d, ffn)
            lin(f"{p}.ffn.net.2", ffn, d)
            sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"] = torch.ones(d), torch.zeros(d)
            if cfg.added_kv_proj_dim is not None:
                lin(f"{p}.attn2.add_k_proj", cfg.added_kv_proj_dim, d)
                lin(f"{p}.attn2.add_v_proj", cfg.added_kv_proj_dim, d)
                sd[f"{p}.attn2.norm_added_k.weight"] = torch.ones(d, dtype=torch.bfloat16)
        os.makedirs(os.path.join(root, sub))
        save_file(sd, os.path.join(root, sub, "model.safetensors"))
        del sd
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump({"num_layers": cfg.num_layers, "num_attention_heads": cfg.num_attention_heads,
                       "attention_head_dim": cfg.attention_head_dim, "ffn_dim": ffn,
                       "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
                       "patch_size": list(cfg.patch_size), **image, **(extra_config or {})}, f)
    if experts == 2:
        with open(os.path.join(root, "model_index.json"), "w") as f:
            json.dump({"boundary_ratio": WAN_BOUNDARY}, f)
    _write_wan_vae(root, dev, seed + 2, vcfg)


def _write_wan_vae(root: str, dev, seed: int, vcfg=None) -> None:
    """vae/: a full-size AutoencoderKLWan of vcfg (default: the Wan2.1 layout
    Wan2.2-A14B and Qwen-Image's AutoencoderKLQwenImage share) under
    diffusers' names, encoder and decoder, in the flat Wan2.1 or the nested
    residual key layout, with a config.json that carries base_dim."""
    from safetensors.torch import save_file

    from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig, wan_vae_decoder_random, \
        wan_vae_encoder_random

    vcfg = vcfg or WanVAEConfig()
    vae = {**wan_vae_decoder_random(seed, vcfg, device=dev),
           **wan_vae_encoder_random(seed + 100, vcfg, device=dev)}
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"].cpu(), p["b"].cpu()

    def norm(name, p, dims=3):
        sd[f"{name}.gamma"] = p["gamma"].reshape(-1, *([1] * dims)).cpu()

    def res(name, p):
        norm(f"{name}.norm1", p["norm1"])
        conv(f"{name}.conv1", p["conv1"])
        norm(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv2", p["conv2"])
        if "shortcut" in p:
            conv(f"{name}.conv_shortcut", p["shortcut"])

    def mid(m, p):
        res(f"{m}.resnets.0", p["res0"])
        res(f"{m}.resnets.1", p["res1"])
        norm(f"{m}.attentions.0.norm", p["attn"]["norm"], dims=2)
        for nm, key in (("qkv", "to_qkv"), ("proj", "proj")):
            sd[f"{m}.attentions.0.{key}.weight"] = \
                p["attn"][nm]["w"].t().contiguous()[:, :, None, None].cpu()
            sd[f"{m}.attentions.0.{key}.bias"] = p["attn"][nm]["b"].cpu()

    def stages(part, blocks, key, nested):
        idx = 0
        for i, blk in enumerate(blocks):
            for j, r in enumerate(blk["resnets"]):
                res(f"{part}.{i}.resnets.{j}" if nested else f"{part}.{idx}", r)
                idx += 1
            if key in blk:
                pre = (f"{part}.{i}.{'downsampler' if key == 'downsample' else 'upsampler'}"
                       if nested else f"{part}.{idx}")
                if "time_conv" in blk:
                    conv(f"{pre}.time_conv", blk["time_conv"])
                conv(f"{pre}.resample.1", blk[key])
                idx += 1

    for part, tree, blocks, key in (("encoder", vae["encoder"], "down", "downsample"),
                                    ("decoder", vae["decoder"], "up", "upsample")):
        conv(f"{part}.conv_in", tree["conv_in"])
        mid(f"{part}.mid_block", tree["mid"])
        stages(f"{part}.{blocks}_blocks", tree[blocks], key, vcfg.is_residual)
        norm(f"{part}.norm_out", tree["norm_out"])
        conv(f"{part}.conv_out", tree["conv_out"])
    conv("quant_conv", vae["quant_conv"])
    conv("post_quant_conv", vae["post_quant_conv"])
    os.makedirs(os.path.join(root, "vae"))
    save_file(sd, os.path.join(root, "vae", "model.safetensors"))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump({"base_dim": vcfg.base_dim, "z_dim": vcfg.z_dim,
                   "dim_mult": list(vcfg.dim_mult), "num_res_blocks": vcfg.num_res_blocks,
                   "temperal_downsample": list(vcfg.temporal_downsample),
                   "patch_size": vcfg.patch_size, "is_residual": vcfg.is_residual}, f)


def _sdxl_down_mid_sd(sd: dict, g, dev, cfg, writers: Optional[dict] = None):
    """The conv_in, embedders, down blocks and mid block of an SDXL UNet at
    cfg's widths in bf16 under diffusers' names (what an SDXL ControlNet
    holds too); returns the conv writer. `writers` receives the lin, norm,
    resnet and t2d writers."""
    import torch

    def rand(*shape, std):
        return (torch.randn(*shape, generator=g, device=dev) * std).bfloat16().cpu()

    def conv(name, cin, cout, k=3):
        sd[f"{name}.weight"] = rand(cout, cin, k, k, std=0.03)
        sd[f"{name}.bias"] = torch.zeros(cout, dtype=torch.bfloat16)

    def lin(name, cin, cout, bias=True):
        sd[f"{name}.weight"] = rand(cout, cin, std=cin**-0.5)
        if bias:
            sd[f"{name}.bias"] = torch.zeros(cout, dtype=torch.bfloat16)

    def norm(name, c):
        sd[f"{name}.weight"] = torch.ones(c, dtype=torch.bfloat16)
        sd[f"{name}.bias"] = torch.zeros(c, dtype=torch.bfloat16)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout)
        lin(f"{name}.time_emb_proj", cfg.time_embed_dim, cout)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, k=1)

    def t2d(name, c, n_layers):
        norm(f"{name}.norm", c)
        lin(f"{name}.proj_in", c, c)
        for j in range(n_layers):
            p = f"{name}.transformer_blocks.{j}"
            for nm in ("norm1", "norm2", "norm3"):
                norm(f"{p}.{nm}", c)
            for nm in ("to_q", "to_k", "to_v"):
                lin(f"{p}.attn1.{nm}", c, c, bias=False)
            lin(f"{p}.attn1.to_out.0", c, c)
            lin(f"{p}.attn2.to_q", c, c, bias=False)
            for nm in ("to_k", "to_v"):
                lin(f"{p}.attn2.{nm}", cfg.cross_attention_dim, c, bias=False)
            lin(f"{p}.attn2.to_out.0", c, c)
            lin(f"{p}.ff.net.0.proj", c, 8 * c)
            lin(f"{p}.ff.net.2", 4 * c, c)
        lin(f"{name}.proj_out", c, c)

    c0, c1, c2 = cfg.block_channels
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]
    te = cfg.time_embed_dim
    conv("conv_in", cfg.in_channels, c0)
    lin("time_embedding.linear_1", c0, te)
    lin("time_embedding.linear_2", te, te)
    lin("add_embedding.linear_1", cfg.add_embedding_in_dim, te)
    lin("add_embedding.linear_2", te, te)
    for i, (cin, c, nl) in enumerate(((c0, c0, 0), (c0, c1, n1), (c1, c2, n2))):
        for j in range(2):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else c, c)
            if nl:
                t2d(f"down_blocks.{i}.attentions.{j}", c, nl)
        if i < 2:
            conv(f"down_blocks.{i}.downsamplers.0.conv", c, c)
    resnet("mid_block.resnets.0", c2, c2)
    t2d("mid_block.attentions.0", c2, n2)
    resnet("mid_block.resnets.1", c2, c2)
    if writers is not None:
        writers.update(lin=lin, norm=norm, resnet=resnet, t2d=t2d)
    return conv


def _write_sdxl_checkpoint(root: str, dev) -> None:
    """Synthetic diffusers-layout SDXL-base checkpoint: the whole UNet at the
    published widths and depth in bf16 (the engine quantizes at load) in
    unet/, and the full-size AutoencoderKL (decoder and encoder) with 4
    latent channels in vae/. Names as diffusers' UNet2DConditionModel."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.sdxl import SDXLConfig
    from fastdm_tpu_torch.pipeline.vae import VAEConfig

    cfg = SDXLConfig(quant=None)
    g = torch.Generator(device=dev).manual_seed(12)
    sd, w = {}, {}
    conv = _sdxl_down_mid_sd(sd, g, dev, cfg, w)
    c0, c1, c2 = cfg.block_channels
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]
    for i, (c, nl, cins) in enumerate(((c2, n2, (2 * c2, 2 * c2, c2 + c1)),
                                       (c1, n1, (c2 + c1, 2 * c1, c1 + c0)),
                                       (c0, 0, (c1 + c0, 2 * c0, 2 * c0)))):
        for j, cin in enumerate(cins):
            w["resnet"](f"up_blocks.{i}.resnets.{j}", cin, c)
            if nl:
                w["t2d"](f"up_blocks.{i}.attentions.{j}", c, nl)
        if i < 2:
            conv(f"up_blocks.{i}.upsamplers.0.conv", c, c)
    w["norm"]("conv_norm_out", c0)
    conv("conv_out", c0, cfg.out_channels)
    os.makedirs(os.path.join(root, "unet"))
    save_file(sd, os.path.join(root, "unet", "model.safetensors"))
    del sd
    os.makedirs(os.path.join(root, "vae"))
    save_file(_vae_state_dict(VAEConfig(latent_channels=4), g, dev),
              os.path.join(root, "vae", "model.safetensors"))


def _engine_sdxl(dev, here: str, summary: dict) -> None:
    """FastDMEngine on the synthetic SDXL-base checkpoint with use_int8: one
    1024x2048 CFG generate, its launches equal to sdxl_forward_launches per
    step."""
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.kernels import cuda_backend

    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
        t0 = time.perf_counter()
        _write_sdxl_checkpoint(root, dev)
        _link_text_dirs(root, "sdxl")
        cn_path, ip_path = os.path.join(root, "controlnet"), os.path.join(root, "ip-adapter")
        _write_sdxl_controlnet(cn_path, dev)
        _write_ip_adapter(ip_path, dev)
        # ip-adapter_sdxl's image encoder: ViT-bigG at full width, 2 layers
        _write_image_encoder(os.path.join(root, "image_encoder"), "vit-bigg", dev, True)
        size = os.path.getsize(os.path.join(root, "unet", "model.safetensors"))
        cn_size = os.path.getsize(os.path.join(cn_path, "diffusion_pytorch_model.safetensors"))
        log(f"[engine sdxl] wrote the synthetic SDXL-base checkpoint (unet/ {size / 1e9:.2f} GB "
            f"in bf16, full-size vae/), a ControlNet ({cn_size / 1e9:.2f} GB) and an "
            f"IP-Adapter in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        eng = FastDMEngine(root, architecture="sdxl", use_int8=True, verbose=False,
                           controlnet_path=cn_path, ip_adapter_path=ip_path)
        cfg = eng.cfg
        qkv = eng.params.down[2].attns[1].blocks[-1].attn1.qkv.w
        log(f"[engine sdxl] FastDMEngine loaded in {time.perf_counter() - t0:.1f} s: block "
            f"channels {cfg.block_channels}, attn layers {cfg.attn_layers}, block linears "
            f"{qkv.dtype}, VAE latent channels {eng.vae_cfg.latent_channels}")
        if qkv.dtype != torch.int8 or eng.vae_cfg.latent_channels != 4:
            raise AssertionError("the SDXL engine did not load an int8 UNet and a 4-channel VAE")
        g = torch.Generator(device=dev).manual_seed(300)
        pooled_dim = cfg.add_embedding_in_dim - 6 * cfg.addition_time_embed_dim
        pos, neg = (torch.randn(1, SDXL_TEXT, cfg.cross_attention_dim, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
        pos_pooled, neg_pooled = (torch.randn(1, pooled_dim, generator=g, device=dev,
                                              dtype=torch.bfloat16) for _ in range(2))
        cuda_backend.reset_launch_counts()
        t0 = time.perf_counter()
        img = eng.generate(prompt_embeds=pos, pooled_prompt_embeds=pos_pooled,
                           negative_prompt_embeds=neg, negative_pooled_prompt_embeds=neg_pooled,
                           height=SDXL_H, width=SDXL_W, num_inference_steps=SDXL_STEPS,
                           guidance_scale=SDXL_CFG, seed=7)
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        want = {k: v * SDXL_STEPS for k, v in sdxl_forward_launches(cfg).items()}
        log(f"[engine sdxl] generate {SDXL_H}x{SDXL_W} {SDXL_STEPS} steps CFG {SDXL_CFG}: "
            f"{sec:.3f} s, image {img.shape} {img.dtype}; launches {counts}")
        if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
                and img.shape == (1, SDXL_H, SDXL_W, 3)) or counts != want:
            raise AssertionError(f"the SDXL generate returned {getattr(img, 'shape', type(img))}, "
                                 f"launches {counts} != derived {want}")
        _engine_prompt(eng, "engine sdxl", dict(height=SDXL_H, width=SDXL_W,
                                                num_inference_steps=SDXL_STEPS,
                                                guidance_scale=SDXL_CFG, seed=7))
        # SDEdit: resized to the UNet's granularity (8 pixels a latent, halved twice)
        _engine_i2i(eng, "engine sdxl", sdxl_forward_launches(cfg),
                    dict(prompt_embeds=pos, pooled_prompt_embeds=pos_pooled,
                         negative_prompt_embeds=neg, negative_pooled_prompt_embeds=neg_pooled,
                         num_inference_steps=SDXL_STEPS, guidance_scale=SDXL_CFG, seed=8), 32,
                    summary)
        _engine_sdxl_conditioning(eng, dict(
            prompt_embeds=pos, pooled_prompt_embeds=pos_pooled, negative_prompt_embeds=neg,
            negative_pooled_prompt_embeds=neg_pooled, num_inference_steps=SDXL_STEPS,
            guidance_scale=SDXL_CFG, seed=9))
        del eng
        torch.cuda.empty_cache()


def phase_engine(dev, summary: Optional[dict] = None) -> None:
    import tempfile

    summary = {} if summary is None else summary
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-text-") as text_base:
        t0 = time.perf_counter()
        TEXT_DIRS.update(_write_text_dirs(text_base, dev))
        log(f"[engine] wrote the tokenizers and the four text encoders (full width, 2 layers, "
            f"bf16) in {time.perf_counter() - t0:.1f} s")
        try:
            _engine_flux(dev, here, summary)
            _engine_wan(dev, here)
            _engine_wan21_i2v(dev, here)
            _engine_sdxl(dev, here, summary)
            _engine_mmdit(dev, here, summary)
        finally:
            TEXT_DIRS.clear()


def _engine_flux(dev, here: str, summary: dict) -> None:
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.engine import FastDMEngine

    from fastdm_tpu_torch.kernels import cuda_backend

    cuda_backend.reset_launch_counts()
    # the quantized snapshots, beside (not in) the checkpoint dir, whose
    # weight files they fingerprint
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root, \
            tempfile.TemporaryDirectory(dir=here, prefix=".smoke-snap-") as snaps:
        t0 = time.perf_counter()
        _write_checkpoint(root, dev)
        _link_text_dirs(root, "flux")
        cn_path = os.path.join(root, "controlnet")
        _write_flux_controlnet(cn_path, dev)
        log(f"[engine] wrote the synthetic checkpoint and a 2-block ControlNet in "
            f"{time.perf_counter() - t0:.1f} s")
        # int8 as flux-kontext (its i2i appends the reference) with the
        # ControlNet; fp8 decodes tiled
        for seed, arch, flags in ((1, "flux", {}),
                                  (2, "flux-kontext", {"use_int8": True,
                                                       "controlnet_path": cn_path}),
                                  (3, "flux", {"use_fp8": True}),
                                  (4, "flux", {"use_int4": True, "pack_int4": True,
                                               "quant_mods": True})):
            # the int8 and int4p engines write a quantized snapshot, and a
            # second engine is built from it
            snap = os.path.join(snaps, f"seed{seed}") if seed in (2, 4) else None

            def make(snapshot_path, arch=arch, flags=flags):
                return FastDMEngine(root, architecture=arch, cache_config=dict(TEACACHE),
                                    verbose=False, snapshot_path=snapshot_path, **flags)

            t0 = time.perf_counter()
            eng = make(snap)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            label = eng.cfg.quant or "bf16"
            int4p = label == "int4p"
            # int4p: quantize_weight's SVDQuant split (QR and SVD) ran on the card
            lin, mod = eng.params.dual_blocks[0].attn.qkv, eng.params.dual_blocks[0].norm1.linear
            w, wm = (lin.w4p, mod.w4p) if int4p else (lin.w, mod.w)
            log(f"[engine {label}] FastDMEngine({arch!r}) loaded in {time.perf_counter() - t0:.1f} s "
                f"({eng.cfg.num_layers} dual + {eng.cfg.num_single_layers} single blocks, "
                f"inner dim {eng.cfg.inner_dim}, block linears {w.dtype}"
                f"{' packed int4, lora rank ' + str(lin.lora_u.shape[1]) if int4p else ''}, "
                f"modulations {wm.dtype if wm is not None else None})")
            want = {None: torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn,
                    "int4p": torch.int8}
            # quant_mods only with int4p: its modulations packed, the others' in bf16
            mods_ok = wm is not None if int4p else wm.dtype == torch.bfloat16
            if (w is None or w.dtype != want[eng.cfg.quant] or not mods_ok
                    or (int4p and not (torch.isfinite(lin.lora_u).all()
                                       and torch.isfinite(lin.lora_v).all()))):
                raise AssertionError(f"engine {flags} loaded the wrong weight format")
            cuda_backend.reset_launch_counts()
            g = torch.Generator(device=dev).manual_seed(100 + seed)
            embeds = torch.randn(1, TXT_TOKENS, eng.cfg.joint_attention_dim, generator=g,
                                 device=dev, dtype=torch.bfloat16)
            pooled = torch.randn(1, eng.cfg.pooled_projection_dim, generator=g, device=dev,
                                 dtype=torch.bfloat16)
            t0 = time.perf_counter()
            img = eng.generate(prompt_embeds=embeds, pooled_prompt_embeds=pooled, height=1024,
                               width=1024, num_inference_steps=STEPS, seed=seed)
            log(f"[engine {label}] generate seed={seed} 1024x1024 {STEPS} steps: "
                f"{time.perf_counter() - t0:.3f} s, image {img.shape} {img.dtype}, "
                f"TeaCache skipped {eng.last_cache_skips}")
            if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
                    and img.shape == (1, 1024, 1024, 3)):
                raise AssertionError(f"generate returned {type(img)} {getattr(img, 'shape', '')}")
            if snap is not None:
                _engine_snapshot(f"flux {label}", make, eng, first_s, snap,
                                 dict(prompt_embeds=embeds, pooled_prompt_embeds=pooled,
                                      height=1024, width=1024, num_inference_steps=STEPS,
                                      seed=seed))
            if int4p:  # one dual + one single block: 13 W4A4 linears per computed
                # forward, and TeaCache's probe (a modulation) in every step
                counts = _launch_counts()
                n = (STEPS - eng.last_cache_skips) * 13 + STEPS
                log(f"[engine int4p] W4A4 launches {[counts[k] for k in W4A4_OPS]} "
                    f"(13 x {STEPS - eng.last_cache_skips} computed forwards + {STEPS} "
                    f"TeaCache probes = {n} each)")
                if any(counts[k] != n for k in W4A4_OPS):
                    raise AssertionError(f"engine int4p: W4A4 launches {counts} != {n} each")
            if label == "bf16":
                _engine_prompt(eng, "engine flux bf16", dict(height=1024, width=1024,
                                                            num_inference_steps=STEPS, seed=seed))
            if label in ("bf16", "int8"):  # SDEdit on flux, Kontext on flux-kontext
                _engine_i2i(eng, f"engine {label} {arch}", flux_forward_launches(eng.cfg),
                            dict(prompt_embeds=embeds, pooled_prompt_embeds=pooled,
                                 num_inference_steps=STEPS, seed=seed), 16, summary)
            if label == "int8":
                _engine_flux_controlnet(eng, embeds, pooled)
            elif label == "fp8":
                eng.enable_vae_tiling()
                t0 = time.perf_counter()
                img = eng.generate(prompt_embeds=embeds, pooled_prompt_embeds=pooled,
                                   height=SDEDIT_H, width=SDEDIT_W, num_inference_steps=STEPS,
                                   seed=seed)
                sec = time.perf_counter() - t0
                finite = bool(np.isfinite(img).all())
                log(f"[engine fp8] enable_vae_tiling(): generate {SDEDIT_H}x{SDEDIT_W} {STEPS} "
                    f"steps with the tiled decode: {sec:.3f} s, image {img.shape} {img.dtype}")
                if img.shape != (1, SDEDIT_H, SDEDIT_W, 3) or img.dtype != np.uint8:
                    raise AssertionError("the tiled-decode generate returned a wrong image")
                summary["engine_tiled_generate_1024x2048_s"] = round(sec, 4)
            del eng
            torch.cuda.empty_cache()


def _resize_branch() -> str:
    """Which branch of the engine's _resize_to_multiple runs on this machine."""
    import importlib.util

    return ("PIL's LANCZOS resize" if importlib.util.find_spec("PIL") is not None
            else "no PIL: the center crop / edge pad")


def _engine_i2i(eng, label: str, per_forward: dict, kw: dict, multiple: int,
                summary: dict) -> None:
    """One task="i2i" generate on a seeded ENGINE_IMAGE_H x ENGINE_IMAGE_W
    image (sides not multiples of 16): an image of the size the model's
    granularity `multiple` resizes it to, and launches per_forward times the
    forwards the loop computed (SDEdit starts at int(steps * (1 -
    strength)); Kontext and the Qwen edit at true CFG 1.0 run one forward a
    step). Its seconds go into `summary`."""
    import numpy as np

    from fastdm_tpu_torch.kernels import cuda_backend

    steps, strength = kw["num_inference_steps"], 0.6
    sdedit = eng.architecture in ("flux", "sd35", "sdxl") and \
        eng.architecture_full != "flux-kontext"
    forwards = steps - (min(int(steps * (1 - strength)), steps - 1) if sdedit else 0)
    image = _seeded_image(500, ENGINE_IMAGE_H, ENGINE_IMAGE_W)
    cuda_backend.reset_launch_counts()
    t0 = time.perf_counter()
    img = eng.generate(task="i2i", image=image, **(dict(strength=strength) if sdedit else {}),
                       **kw)
    sec = time.perf_counter() - t0
    counts = _launch_counts()
    skips = eng.last_cache_skips if eng.cache_config is not None else 0
    want = {k: v * (forwards - skips) for k, v in per_forward.items()}
    shape = (1, ENGINE_IMAGE_H // multiple * multiple, ENGINE_IMAGE_W // multiple * multiple, 3)
    log(f"[{label}] generate task='i2i' on a {ENGINE_IMAGE_H}x{ENGINE_IMAGE_W} image "
        f"(_resize_to_multiple({multiple}) ran {_resize_branch()}): {sec:.3f} s, image "
        f"{img.shape} {img.dtype}, {forwards} forwards, {skips} skipped; launches {counts}")
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.shape == shape
            and np.isfinite(img).all()) or counts != want:
        raise AssertionError(f"the {label} i2i generate returned "
                             f"{getattr(img, 'shape', type(img))}, launches {counts} != "
                             f"derived {want}")
    summary[f"{label.replace(' ', '_')}_i2i_s"] = round(sec, 4)


def _engine_wan(dev, here: str) -> None:
    """FastDMEngine on the synthetic Wan2.2-A14B checkpoint with use_int8: one
    17-frame 480x832 generate in each sparse mode (FASTDM_SPARSE_GATHER; the
    radial config with dense_layers 0, so the checkpoint's one block per
    expert takes the mode's kernel), then one under each published cache
    JSON."""
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.wan import WanConfig

    radial = dict(dataclasses.asdict(_radial().config), dense_layers=0)
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
        t0 = time.perf_counter()
        _write_wan_checkpoint(root, dev)
        _link_text_dirs(root, "wan")
        log(f"[engine wan] wrote the synthetic two-expert checkpoint in "
            f"{time.perf_counter() - t0:.1f} s")
        g = torch.Generator(device=dev).manual_seed(200)
        text_dim = WanConfig().text_dim
        pos, neg = (torch.randn(1, WAN_TEXT, text_dim, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
        kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=WAN_H, width=WAN_W,
                  num_frames=WAN_ENGINE_FRAMES, num_inference_steps=WAN_STEPS,
                  guidance_scale=WAN_CFG[0], guidance_scale_2=WAN_CFG[1], seed=9)
        shape = (1, WAN_ENGINE_FRAMES, WAN_H, WAN_W, 3)

        def make(snapshot_path):
            return FastDMEngine(root, architecture="wan2.2-t2v", use_int8=True,
                                sparse_attn_config=radial, verbose=False, device=dev,
                                snapshot_path=snapshot_path)

        # the dual-expert int8 engine through a quantized snapshot, beside
        # the checkpoint dir
        with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-snap-") as snap:
            t0 = time.perf_counter()
            eng = make(snap)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            os.environ["FASTDM_SPARSE_GATHER"] = "super"
            _engine_snapshot("wan int8 dual expert", make, eng, first_s, snap, kw)
            del eng
            torch.cuda.empty_cache()
        runs = [(mode, None) for mode in SPARSE_KERNEL] + [("super", name)
                                                           for name, _ in WAN_CACHES]
        eng, loaded = None, None
        for mode, cache in runs:
            if loaded != cache or eng is None:
                del eng
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                eng = FastDMEngine(root, architecture="wan2.2-t2v", use_int8=True,
                                   sparse_attn_config=radial, verbose=False, device=dev,
                                   cache_config=None if cache is None else _cache_json(cache))
                loaded = cache
                log(f"[engine wan] FastDMEngine loaded in {time.perf_counter() - t0:.1f} s "
                    f"(cache {cache}): two experts {eng.params_2 is not None}, "
                    f"{eng.cfg.num_layers} block each, inner dim {eng.cfg.inner_dim}, block "
                    f"linears {eng.params.blocks[0].attn1.qkv.w.dtype}, boundary "
                    f"{eng.boundary_ratio}, VAE loaded {eng.vae_params is not None}")
                if eng.params_2 is None or eng.vae_params is None or \
                        eng.params.blocks[0].attn1.qkv.w.dtype != torch.int8:
                    raise AssertionError("the Wan engine did not load both int8 experts and "
                                         "the VAE")
            os.environ["FASTDM_SPARSE_GATHER"] = mode
            cuda_backend.reset_launch_counts()
            t0 = time.perf_counter()
            video = eng.generate(**kw)
            sec = time.perf_counter() - t0
            counts = {name: _launch_counts()[name] for name, _ in SPARSE_KERNEL.values()}
            log(f"[engine wan] generate {WAN_H}x{WAN_W}x{WAN_ENGINE_FRAMES} {WAN_STEPS} steps, "
                f"mode {mode}, cache {cache}: {sec:.3f} s, video {video.shape} {video.dtype}, "
                f"steps per expert {eng.last_phase_steps}, cache skips {eng.last_cache_skips}, "
                f"sparse kernel launches {counts}")
            mine = SPARSE_KERNEL[mode][0]
            if not (isinstance(video, np.ndarray) and video.dtype == np.uint8
                    and video.shape == shape) or counts[mine] <= 0 or \
                    sum(counts.values()) != counts[mine]:
                raise AssertionError(f"the Wan generate in mode {mode} returned "
                                     f"{getattr(video, 'shape', type(video))}, launches {counts}")
            if mode == "super" and cache is None:
                _engine_prompt(eng, "engine wan", kw)
        os.environ.pop("FASTDM_SPARSE_GATHER")
        del eng
        torch.cuda.empty_cache()


# ------------------------------------------------------ ControlNet / IP-Adapter


def _controlnet_kernels(dev, g) -> None:
    """The kernels at the shapes the ControlNet and IP-Adapter requests give
    them, each held to its plain version and timed beside its bound and the
    library call: sdpa on the IP-Adapter branch of both SDXL levels (q on
    8192 tokens at 640 wide and 2048 at 1280, CFG batch 2) against 4 or 16
    image-token keys read in place from the fused k|v projection (a 128-key
    box over 4 rows), on the Plus resampler (16 latents over 257 + 16 keys)
    and on the union ControlNet's joint 513 + 8192 = 8705 tokens (the last
    query tile one row); rotembd bit-exact on that sequence with the mode
    token's extra table row; rmsnorm on its 8705- and 513-row head rows; the
    int8 quantizer and GEMM bit-exact, with and without the zero point, at
    every new M of the union ControlNet (513 text rows in the dual blocks,
    8705 joint rows in the single blocks)."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_rope_cache
    from fastdm_tpu_torch.models.sdxl import SDXLConfig

    cfg = SDXLConfig()
    t = CN_SUMMARY.setdefault("kernel_ms", {})
    for (tokens, c), (blocks, _) in zip(sdxl_levels(cfg), sdxl_level_blocks(cfg)):
        q = torch.randn(SDXL_BATCH, tokens, c, generator=g, device=dev, dtype=torch.bfloat16)
        for keys in (IP_TOKENS, PLUS_LATENTS):
            kv = torch.randn(SDXL_BATCH, keys, 2 * c, generator=g, device=dev,
                             dtype=torch.bfloat16)
            t[f"sdpa_ip_{c}x{keys}"] = _sdpa_case(
                f"IP-Adapter branch {c} wide, {keys} image tokens ({blocks} per forward)", q,
                kv[..., :c], kv[..., c:], c // 64, 64, long_rows=False)
        del q, kv
    lat = torch.randn(1, PLUS_LATENTS, PLUS_HIDDEN, generator=g, device=dev,
                      dtype=torch.bfloat16)
    kv = torch.randn(1, PLUS_STATES + PLUS_LATENTS, 2 * PLUS_HIDDEN, generator=g, device=dev,
                     dtype=torch.bfloat16)
    t["sdpa_resampler"] = _sdpa_case(
        f"IP-Adapter-Plus resampler ({PLUS_LAYERS} per request)", lat, kv[..., :PLUS_HIDDEN],
        kv[..., PLUS_HIDDEN:], PLUS_HIDDEN // 64, 64, long_rows=False)

    s = UNION_TEXT + IMG_TOKENS
    cos, sin = flux_rope_cache(FluxConfig(), TXT_TOKENS, FLUX_HT, FLUX_WT, device=dev)
    cos, sin = torch.cat([cos[:1], cos]), torch.cat([sin[:1], sin])
    qkv = torch.randn(1, s, 3 * DIM, generator=g, device=dev, dtype=torch.bfloat16)
    q, k, v = qkv.split(DIM, dim=-1)
    per = UNION_LAYERS + UNION_SINGLE
    t["sdpa_union_8705"] = _sdpa_case(f"union ControlNet joint ({per} per forward)", q, k, v,
                                      HEADS, HEAD_DIM)
    qc, kc = q.contiguous(), k.contiguous()
    got = cb.rotary_pos_embedding_cuda(qc, kc, HEAD_DIM, cos, sin, False)
    want = tb.rotary_pos_embedding_torch(qc, kc, HEAD_DIM, cos, sin, False)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("rotembd is not bit-exact at the union ControlNet's 8705 tokens")
    ms = cuda_ms(lambda: cb.rotary_pos_embedding_cuda(qc, kc, HEAD_DIM, cos, sin, False), 50)
    n = qc.numel() + kc.numel()
    b_ms, b_by = bound(2 * n * 2 + 2 * cos.numel() * 4, 3 * n, F32_FLOPS)
    log(f"[rotembd] union ControlNet {tuple(qc.shape)} interleaved, cos {tuple(cos.shape)}: "
        f"bit-exact True; {ms:.4f} ms ({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, {b_by}); "
        f"plain {cuda_ms(lambda: tb.rotary_pos_embedding_torch(qc, kc, HEAD_DIM, cos, sin, False), 10):.4f} ms")
    t["rotembd_union_8705"] = ms
    w = (1 + 0.05 * torch.randn(HEAD_DIM, generator=g, device=dev)).bfloat16()
    for rows in (s, UNION_TEXT):
        x = qkv[:, :rows, :DIM].reshape(1, rows, HEADS, HEAD_DIM)
        t[f"rmsnorm_union_{rows}"] = _rms_case(f"union ControlNet {rows} head rows", x, w)
    del qkv, q, k, v, qc, kc, got, want, cos, sin

    # the int8 linears at the union ControlNet's new M: (M, K, N) -> per forward
    gemms = {(UNION_TEXT, DIM, 3 * DIM): UNION_LAYERS, (UNION_TEXT, DIM, DIM): UNION_LAYERS,
             (UNION_TEXT, DIM, MLP): UNION_LAYERS, (UNION_TEXT, MLP, DIM): UNION_LAYERS,
             (s, DIM, 3 * DIM + MLP): UNION_SINGLE, (s, DIM + MLP, DIM): UNION_SINGLE}
    for (m, k_, n_), count in gemms.items():
        a, sa, lin, args = _w8a8_operands("int8", m, k_, n_, g, dev)
        _int8_exact(args, f"union ControlNet {m}x{k_} @ {k_}x{n_}")  # raises on a mismatch
        x = torch.randn(m, k_, generator=g, device=dev, dtype=torch.bfloat16)
        if not all(torch.equal(u, v) for u, v in zip(cb.quantize_to_int8_cuda(x, symmetric=False),
                                                     tb.quantize_to_int8_torch(x, symmetric=False))):
            raise AssertionError(f"quantize_to_int8 disagrees at the union ControlNet's M={m}")
        ms = cuda_ms(lambda: cb.int8_matmul_cuda(*args), 10)
        q_ms = cuda_ms(lambda: cb.quantize_to_int8_cuda(x, symmetric=False), 10)
        lib_ms = _int_mm_ms(a, lin.w, f"M={m}")
        plain_ms = cuda_ms(lambda: tb.int8_matmul_torch(*args), 2, 1)
        b_ms, b_by = bound(_gemm_bytes(m, k_, n_), 2 * m * n_ * k_, INT8_FP8_OPS)
        log(f"[int8 w8a8] union ControlNet {m}x{k_} @ {k_}x{n_} ({count} per forward): quantize "
            f"and GEMM bit-exact (with and without azp); GEMM {ms:.4f} ms ({b_ms / ms:.1%} of the "
            f"bound {b_ms:.4f} ms, {b_by}), plain {plain_ms:.4f} ms, quantize {q_ms:.4f} ms, "
            f"library (torch._int_mm, s32 product only) {lib_ms} ms")
        t[f"int8_matmul_{m}x{k_}x{n_}"] = ms
        del a, sa, lin, args, x
    torch.cuda.empty_cache()


def flux_controlnet_launches(cn_cfg) -> dict:
    """Kernel launches of one FLUX ControlNet forward: its dual and single
    blocks are FLUX's, so flux_forward_launches of its depth; its
    embedders, mode table, controlnet_x_embedder and zero heads are bf16
    products and launch none."""
    return flux_forward_launches(cn_cfg)


# Relative L2 of one full-width forward on the kernels against the same
# forward on the plain versions: the union FLUX ControlNet's stacked
# residuals, the SDXL ControlNet's residuals, the SDXL UNet with ControlNet
# residuals and with IP-Adapter tokens, all int8; twice the first value
# measured on an H100 80GB HBM3 (2.125e-2, 7.612e-3, 1.386e-2, 1.596e-2). A
# wrong tile, scale or layout gives O(1).
FLUX_CN_REL_L2_TOL = 4.25e-2
SDXL_CN_REL_L2_TOL = {"controlnet": 1.522e-2, "unet_cn": 2.772e-2, "unet_ip": 3.192e-2}


INT8_OPS = ("quantize_to_int8", "int8_matmul")


def _flux_controlnet_request(dev, params, cfg, vae, vae_cfg) -> None:
    """On the full-depth int8 FLUX.1-dev: the union ControlNet drawn at its
    published shape in int8, one 1024x2048 request (4 steps, guidance 3.5,
    scale 0.7, control_mode 2) on a latent hint from the full-size
    AutoencoderKL encoder, its launches equal to 4 x (flux_forward_launches +
    flux_controlnet_launches), and one ControlNet forward held to its plain
    forward."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.controlnets import FluxControlNetConfig, \
        flux_controlnet_forward, flux_controlnet_init_random
    from fastdm_tpu_torch.models.flux import flux_rope_cache
    from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents, \
        make_flux_cn_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, \
        flow_match_shift_mu
    from fastdm_tpu_torch.pipeline.vae import vae_decode, vae_encode

    cn_cfg = FluxControlNetConfig(quant="int8", num_layers=UNION_LAYERS,
                                  num_single_layers=UNION_SINGLE, guidance_embeds=True)
    cn, init_sec = _timed(flux_controlnet_init_random, 9, cn_cfg, device=dev,
                          num_modes=UNION_MODES)
    n = sum(p.numel() for p in cn.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in cn.parameters())
    log(f"[slice int8 controlnet] union ControlNet ({UNION_LAYERS} dual + {UNION_SINGLE} single "
        f"blocks, {UNION_MODES} modes) int8 random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.2f} GiB) in {init_sec:.1f} s")
    ht, wt = FLUX_HT, FLUX_WT
    sched = FlowMatchEulerScheduler.create(STEPS, use_dynamic_shifting=True,
                                           mu=flow_match_shift_mu(ht * wt))
    cos, sin = flux_rope_cache(cfg, TXT_TOKENS, ht, wt, device=dev)
    image = torch.from_numpy(_seeded_image(29, 16 * ht, 16 * wt)).to(dev).float()[None]
    z, enc_sec = _timed(vae_encode, vae["encoder"], vae_cfg, image / 127.5 - 1.0)
    hint = flux_pack_latents(z.float())
    run = make_flux_cn_denoiser(cfg, cn_cfg, sched, STEPS, 3.5, CN_SCALE, UNION_MODE)
    latents, encoder, pooled = _conditioning(dev, 30, cfg, ht * wt)
    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    (lat, _), den_sec = _timed(run, params, cn, latents, hint, encoder, pooled, cos, sin)
    counts = _launch_counts()
    img, dec_sec = _timed(vae_decode, vae, vae_cfg, flux_unpack_latents(lat, ht, wt))
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_f, per_c = flux_forward_launches(cfg), flux_controlnet_launches(cn_cfg)
    want = {k: STEPS * (per_f[k] + per_c[k]) for k in per_f}
    finite = bool(torch.isfinite(img).all())
    log(f"[slice int8 controlnet] request {16 * ht}x{16 * wt} {STEPS} steps, control_mode "
        f"{UNION_MODE}, scale {CN_SCALE}: {enc_sec + den_sec + dec_sec:.3f} s (hint encode "
        f"{enc_sec:.3f}, denoise {den_sec:.3f}, decode {dec_sec:.3f}), image {tuple(img.shape)} "
        f"finite={finite}, peak {peak:.2f} GiB; launches {counts} (derived {STEPS} x (FLUX "
        f"forward + ControlNet forward))")
    if not finite or tuple(img.shape) != (1, 16 * ht, 16 * wt, 3) or counts != want:
        raise AssertionError(f"ControlNet request: launches {counts} != derived {want}")
    x, t = latents.to(torch.bfloat16), torch.full((1,), float(sched.sigmas[0]), device=dev)
    guidance = torch.full((1,), 3.5, device=dev)
    ccos, csin = torch.cat([cos[:1], cos]), torch.cat([sin[:1], sin])
    hb = hint.to(torch.bfloat16)

    def forward(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            bs, sbs = flux_controlnet_forward(cn, cn_cfg, x, hb, encoder, pooled, t, ccos, csin,
                                              guidance=guidance, conditioning_scale=CN_SCALE,
                                              control_mode=UNION_MODE)
            return torch.cat([bs, sbs]).float()

    fwd_sec, _ = _forward_gate("slice int8 controlnet", forward, FLUX_CN_REL_L2_TOL, INT8_OPS)
    CN_SUMMARY.update(flux_union_request_s=round(enc_sec + den_sec + dec_sec, 4),
                      flux_union_denoise_s=round(den_sec, 4),
                      flux_union_forward_s=round(fwd_sec, 4),
                      flux_union_peak_gib=round(peak, 2),
                      flux_union_launches_per_step={k: v for k, v in per_c.items() if v})
    _zero_heads_times(cn, dev)
    del cn, img, lat, hint, z
    torch.cuda.empty_cache()


def _zero_heads_times(cn, dev) -> None:
    """The union ControlNet's stacked zero-linear heads alone, at the
    request's shapes ((L, 1, 8192, 3072) samples times (L, 3072, 3072)
    weights): _zero_heads (TF32 tensor cores) beside the same f32 product on
    the CUDA cores (TF32 off), which both compute from exact products of bf16
    values; the two differ only in the f32 summation order, so their bf16
    outputs agree within one bf16 ulp (relative L2 3.9e-3)."""
    import torch

    from fastdm_tpu_torch.models.controlnets import _zero_heads

    g = torch.Generator(device=dev).manual_seed(41)
    times = CN_SUMMARY.setdefault("zero_heads_ms", {})
    for name, heads in (("dual", cn.controlnet_blocks), ("single", cn.controlnet_single_blocks)):
        n, d = heads["w"].shape[:2]
        x = torch.randn(n, 1, IMG_TOKENS, d, generator=g, device=dev, dtype=torch.bfloat16)

        def cuda_cores():
            out = torch.matmul(x.float(), heads["w"].float()[:, None])
            return ((out + heads["bias"].float()[:, None, None, :]) * CN_SCALE).to(x.dtype)

        with torch.inference_mode():
            torch.backends.cuda.matmul.allow_tf32 = False
            rel = ((_zero_heads(x, heads, CN_SCALE).float() - cuda_cores().float()).norm()
                   / cuda_cores().float().norm()).item()
            tf32_ms = cuda_ms(lambda: _zero_heads(x, heads, CN_SCALE), 5)
            f32_ms = cuda_ms(cuda_cores, 5)
        times[name] = dict(tf32_ms=round(tf32_ms, 4), f32_cuda_cores_ms=round(f32_ms, 4),
                           rel_l2=rel)
        log(f"[slice int8 controlnet] zero heads {name} ({n} x {IMG_TOKENS} x {d} x {d}): TF32 "
            f"{tf32_ms:.4f} ms, f32 on the CUDA cores {f32_ms:.4f} ms, relative L2 {rel:.3e}")
        if not rel <= 3.9e-3:
            raise AssertionError(f"zero heads {name}: TF32 and f32 products differ, {rel:.3e}")
        del x


def sdxl_controlnet_launches(cfg) -> dict:
    """Kernel launches of one SDXL ControlNet forward, read off
    models/controlnets.py: the UNet's down1 (2 Transformer2Ds of
    attn_layers[1] blocks), down2 (2 of attn_layers[2]) and mid (1) blocks,
    each two sdpa, one gelu_and_mul and 7 W8A8 linears; proj_in / proj_out
    per Transformer2D; time_emb_proj per resnet (down 6, mid 2). The hint
    encoder, zero convs and embedders launch none. Whatever the batch."""
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]
    blocks, t2ds, resnets = 2 * n1 + 3 * n2, 5, 8
    counts = dict.fromkeys(_launch_counts(), 0)
    counts.update(sdpa=2 * blocks, gelu_and_mul=blocks)
    if cfg.quant is not None:
        counts[f"quantize_to_{cfg.quant}"] = counts[f"{cfg.quant}_matmul"] = \
            7 * blocks + 2 * t2ds + resnets
    return counts


def sdxl_ip_adapter_launches(cfg) -> dict:
    """What the IP-Adapter adds to one UNet forward: on every cross-attention
    the ipadp_kv linear (W8A8 in cfg.quant) and one more sdpa."""
    blocks = sum(n for n, _ in sdxl_level_blocks(cfg))
    counts = dict.fromkeys(_launch_counts(), 0)
    counts["sdpa"] = blocks
    if cfg.quant is not None:
        counts[f"quantize_to_{cfg.quant}"] = counts[f"{cfg.quant}_matmul"] = blocks
    return counts


def _random_ip_adapter(params, cfg, dev, seed: int):
    """Attach random ipadp_kv linears (no bias, cfg.quant) to every
    cross-attention of `params` and draw both image projections at
    h94/IP-Adapter's SDXL shapes: ip-adapter_sdxl (one 1280 -> 4 x 2048
    linear and a LayerNorm) and ip-adapter-plus_sdxl_vit-h (the resampler)."""
    import torch

    from fastdm_tpu_torch.layers.ip_adapter import ImageProjection, IPAdapterPlusProjection, \
        ResamplerBlock
    from fastdm_tpu_torch.layers.qlinear import qlinear_random
    from fastdm_tpu_torch.models.sdxl import frozen_params

    g = torch.Generator(device=dev).manual_seed(seed)
    ctx, hid = cfg.cross_attention_dim, PLUS_HIDDEN
    for stage in (*params.down, *params.up, params.mid):
        for t2d in stage.attns or []:
            for blk in t2d.blocks:
                c = blk.attn2.out.w.shape[1]
                blk.attn2.ipadp_kv = qlinear_random(g, ctx, 2 * c, bias=False, quant=cfg.quant,
                                                    device=dev)

    def lin(k, n, bias=True):
        return qlinear_random(g, k, n, bias=bias, w_std=k**-0.5, device=dev)

    def norm(c):
        return frozen_params(gamma=torch.ones(c, dtype=torch.bfloat16, device=dev),
                             beta=torch.zeros(c, dtype=torch.bfloat16, device=dev))

    simple = ImageProjection(lin(IP_EMBED, IP_TOKENS * ctx), norm(ctx), IP_TOKENS)
    layers = [ResamplerBlock(norm(hid), norm(hid), lin(hid, hid, False), lin(hid, 2 * hid, False),
                             lin(hid, hid, False), norm(hid), lin(hid, 4 * hid, False),
                             lin(4 * hid, hid, False)) for _ in range(PLUS_LAYERS)]
    latents = torch.randn(1, PLUS_LATENTS, hid, generator=g, device=dev) * hid**-0.5
    plus = IPAdapterPlusProjection(latents.bfloat16(), lin(IP_EMBED, hid), layers,
                                   lin(hid, ctx), norm(ctx), heads=hid // 64, head_dim=64)
    return simple, plus


def _sdxl_conditioned_requests(dev, params, cfg, vae, vae_cfg) -> None:
    """On the full-depth int8 SDXL-base: the SDXL ControlNet drawn at
    diffusers/controlnet-canny-sdxl-1.0's shape in int8; 1024x2048 CFG
    requests of 4 steps with a [0, 1] hint, without and with guess mode,
    launches 4 x (sdxl_forward_launches + sdxl_controlnet_launches); the
    ControlNet forward and the UNet forward with its residuals held to their
    plain forwards. Then random IP-Adapter k|v on every cross-attention and
    an ip-adapter_sdxl and an ip-adapter-plus request (the image tokens
    projected once, zeros for the negative half), launches 4 x
    (sdxl_forward_launches + sdxl_ip_adapter_launches) plus the resampler's
    sdpa; the forward with IP tokens held to its plain forward."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.controlnets import sdxl_controlnet_forward, \
        sdxl_controlnet_init_random
    from fastdm_tpu_torch.models.sdxl import sdxl_forward
    from fastdm_tpu_torch.pipeline.denoise_sdxl import make_sdxl_cn_denoiser, make_sdxl_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import EulerDiscreteScheduler
    from fastdm_tpu_torch.pipeline.vae import vae_decode

    cn, init_sec = _timed(sdxl_controlnet_init_random, 8, cfg, device=dev)
    n = sum(p.numel() for p in cn.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in cn.parameters())
    log(f"[sdxl controlnet] SDXL ControlNet int8 random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.2f} GiB) in {init_sec:.1f} s")
    sched = EulerDiscreteScheduler.create(SDXL_STEPS)
    hint = torch.from_numpy(_seeded_image(57, SDXL_H, SDXL_W)).to(dev).float()
    hint = (hint / 255.0).permute(2, 0, 1)[None]
    per_u, per_c = sdxl_forward_launches(cfg), sdxl_controlnet_launches(cfg)

    def request(label, run, args, per, extra=None):
        torch.cuda.reset_peak_memory_stats()
        cuda_backend.reset_launch_counts()
        (lat, _), den_sec = _timed(run, *args)
        counts = _launch_counts()
        img, dec_sec = _timed(vae_decode, vae, vae_cfg, lat)
        want = {k: SDXL_STEPS * (per_u[k] + per[k]) + (extra or {}).get(k, 0) for k in per_u}
        finite = bool(torch.isfinite(img).all())
        log(f"[sdxl {label}] request {SDXL_H}x{SDXL_W} {SDXL_STEPS} steps, CFG {SDXL_CFG}: "
            f"{den_sec + dec_sec:.3f} s (denoise {den_sec:.3f}, decode {dec_sec:.3f}), image "
            f"{tuple(img.shape)} finite={finite}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
        if not finite or tuple(img.shape) != (1, SDXL_H, SDXL_W, 3) or counts != want:
            raise AssertionError(f"SDXL {label} request: launches {counts} != derived {want}")
        CN_SUMMARY[f"sdxl_{label.replace(' ', '_').replace('-', '_')}_request_s"] = round(
            den_sec + dec_sec, 4)

    for guess in (False, True):
        latents, embeds, pooled, time_ids = _sdxl_conditioning(dev, 58 + guess, cfg,
                                                               sched.init_noise_sigma)
        run = make_sdxl_cn_denoiser(cfg, sched, SDXL_STEPS, SDXL_CFG, CN_SCALE, guess)
        request("controlnet guess" if guess else "controlnet", run,
                (params, cn, latents, embeds, pooled, time_ids, hint), per_c)
    x = torch.cat([sched.scale_model_input(latents, 0)] * 2).to(torch.bfloat16)
    t = torch.full((SDXL_BATCH,), float(sched.timesteps[0]), device=dev)
    hint2 = torch.cat([hint] * 2)

    def cn_forward(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            down, mid = sdxl_controlnet_forward(cn, cfg, x, t, embeds, pooled, time_ids, hint2,
                                                conditioning_scale=CN_SCALE)
            return torch.cat([r.flatten() for r in (*down, mid)]).float()

    CN_SUMMARY["sdxl_controlnet_forward_s"] = round(_forward_gate(
        "sdxl controlnet", cn_forward, SDXL_CN_REL_L2_TOL["controlnet"], INT8_OPS)[0], 4)
    with torch.inference_mode():
        down, mid = sdxl_controlnet_forward(cn, cfg, x, t, embeds, pooled, time_ids, hint2,
                                            conditioning_scale=CN_SCALE)

    def unet_cn(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return sdxl_forward(params, cfg, x, t, embeds, pooled, time_ids,
                                down_block_additional_residuals=down,
                                mid_block_additional_residual=mid).float()

    _forward_gate("sdxl unet with controlnet residuals", unet_cn, SDXL_CN_REL_L2_TOL["unet_cn"],
                  INT8_OPS)
    del cn, down, mid, hint, hint2
    torch.cuda.empty_cache()

    simple, plus = _random_ip_adapter(params, cfg, dev, 59)
    g = torch.Generator(device=dev).manual_seed(60)
    per_ip = sdxl_ip_adapter_launches(cfg)
    run = make_sdxl_denoiser(cfg, sched, SDXL_STEPS, SDXL_CFG)
    for label, proj, shape, resampler in (
            ("ip-adapter", simple, (1, IP_EMBED), 0),
            ("ip-adapter-plus", plus, (1, PLUS_STATES, IP_EMBED), PLUS_LAYERS)):
        emb = torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)
        latents, embeds, pooled, time_ids = _sdxl_conditioning(dev, 61, cfg,
                                                               sched.init_noise_sigma)

        def conditioned(*args):
            with torch.inference_mode():
                tokens = proj(emb)
            return run(*args, torch.cat([torch.zeros_like(tokens), tokens]))

        request(label, conditioned, (params, latents, embeds, pooled, time_ids), per_ip,
                {"sdpa": resampler})
    with torch.inference_mode():
        tokens = simple(torch.randn(1, IP_EMBED, generator=g, device=dev, dtype=torch.bfloat16))
    ip = torch.cat([torch.zeros_like(tokens), tokens])

    def unet_ip(plain_ops=()):
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return sdxl_forward(params, cfg, x, t, embeds, pooled, time_ids, ip_embeds=ip).float()

    CN_SUMMARY["sdxl_ip_forward_s"] = round(_forward_gate(
        "sdxl unet with ip-adapter tokens", unet_ip, SDXL_CN_REL_L2_TOL["unet_ip"], INT8_OPS)[0], 4)
    del ip
    torch.cuda.empty_cache()
    _sdxl_image_requests(dev, params, cfg, simple, plus)
    for stage in (*params.down, *params.up, params.mid):
        for t2d in stage.attns or []:
            for blk in t2d.blocks:
                blk.attn2.ipadp_kv = None
    del simple, plus
    torch.cuda.empty_cache()


def _write_flux_controlnet(path: str, dev) -> None:
    """A FLUX ControlNet checkpoint in diffusers' layout at FLUX.1-dev width
    with 2 dual blocks and no single block (the depth of the XLabs
    ControlNets), guidance-distilled, with a raw-hint input_hint_block (the
    ControlNetConditioningEmbedding layout: 3 -> 16, 16, 32, 96, 256 -> 16
    channels, so that the 2x2-packed hint has FLUX's 64 input channels), and
    config.json."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.flux import FluxConfig

    cfg = FluxConfig(num_layers=2, num_single_layers=0)
    g = torch.Generator(device=dev).manual_seed(13)
    sd = {}
    lin = _flux_lin_writer(sd, g, dev)
    _flux_trunk_sd(sd, lin, cfg)
    d = cfg.inner_dim
    lin("controlnet_x_embedder", cfg.in_channels, d)
    for i in range(cfg.num_layers):
        lin(f"controlnet_blocks.{i}", d, d)

    def conv(name, cin, cout):
        sd[f"{name}.weight"] = (torch.randn(cout, cin, 3, 3, generator=g, device=dev)
                                * 0.05).bfloat16().cpu()
        sd[f"{name}.bias"] = torch.zeros(cout, dtype=torch.bfloat16)

    e = (16, 32, 96, 256)
    conv("input_hint_block.conv_in", 3, e[0])
    for i in range(6):
        conv(f"input_hint_block.blocks.{i}", e[i // 2], e[(i + 1) // 2])
    conv("input_hint_block.conv_out", e[3], cfg.in_channels // 4)
    os.makedirs(path)
    save_file(sd, os.path.join(path, "diffusion_pytorch_model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"num_layers": cfg.num_layers, "num_single_layers": 0,
                   "guidance_embeds": True}, f)


def _engine_flux_controlnet(eng, embeds, pooled) -> None:
    """The int8 engine's ControlNet (controlnet_path, the raw-hint one of
    _write_flux_controlnet): one 1024x1024 generate on a seeded hint image,
    launches 4 x (flux_forward_launches + flux_controlnet_launches)."""
    import numpy as np

    from fastdm_tpu_torch.kernels import cuda_backend

    hint = _seeded_image(501, 1024, 1024)
    cuda_backend.reset_launch_counts()
    img, sec = _timed(eng.generate, prompt_embeds=embeds, pooled_prompt_embeds=pooled,
                      height=1024, width=1024, num_inference_steps=STEPS, seed=11,
                      control_image=hint, controlnet_conditioning_scale=CN_SCALE)
    counts = _launch_counts()
    per_f, per_c = flux_forward_launches(eng.cfg), flux_controlnet_launches(eng.cn_cfg)
    want = {k: STEPS * (per_f[k] + per_c[k]) for k in per_f}
    log(f"[engine int8 controlnet] controlnet_path ({eng.cn_cfg.num_layers} dual + "
        f"{eng.cn_cfg.num_single_layers} single blocks, raw hint "
        f"{eng.cn_params.input_hint_block is not None}): generate 1024x1024 {STEPS} steps with "
        f"control_image: {sec:.3f} s, image {img.shape} {img.dtype}; launches {counts}")
    if not (isinstance(img, np.ndarray) and img.shape == (1, 1024, 1024, 3)
            and img.dtype == np.uint8) or counts != want:
        raise AssertionError(f"the FLUX ControlNet generate: launches {counts} != {want}")
    CN_SUMMARY["engine_flux_controlnet_1024_s"] = round(sec, 4)


def _write_sdxl_controlnet(path: str, dev) -> None:
    """A diffusers SDXL ControlNet checkpoint at controlnet-canny-sdxl-1.0's
    shape in bf16: the UNet's down and mid blocks as _write_sdxl_checkpoint
    writes them, the hint encoder (16, 32, 96, 256) and the zero convs."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.controlnets import sdxl_controlnet_skip_channels
    from fastdm_tpu_torch.models.sdxl import SDXLConfig

    cfg = SDXLConfig(quant=None)
    sd = {}
    conv = _sdxl_down_mid_sd(sd, torch.Generator(device=dev).manual_seed(14), dev, cfg)
    e = (16, 32, 96, 256)
    conv("controlnet_cond_embedding.conv_in", 3, e[0])
    for i in range(6):
        conv(f"controlnet_cond_embedding.blocks.{i}", e[i // 2], e[(i + 1) // 2])
    conv("controlnet_cond_embedding.conv_out", e[3], cfg.block_channels[0])
    for i, c in enumerate(sdxl_controlnet_skip_channels(cfg)):
        conv(f"controlnet_down_blocks.{i}", c, c, k=1)
    conv("controlnet_mid_block", cfg.block_channels[2], cfg.block_channels[2], k=1)
    os.makedirs(path)
    save_file(sd, os.path.join(path, "diffusion_pytorch_model.safetensors"))


def _write_ip_adapter(path: str, dev) -> None:
    """An h94/IP-Adapter ip-adapter_sdxl checkpoint in its official layout:
    to_k_ip / to_v_ip (2048 -> C, no bias) at ip_adapter.{odd index} in
    diffusers' processor order (down blocks, up blocks, the mid block last),
    image_proj.proj (1280 -> 4 x 2048) and image_proj.norm."""
    import torch
    from safetensors.torch import save_file

    from fastdm_tpu_torch.models.sdxl import SDXLConfig

    cfg = SDXLConfig(quant=None)
    g = torch.Generator(device=dev).manual_seed(15)
    ctx = cfg.cross_attention_dim
    _, c1, c2 = cfg.block_channels
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]
    sd, idx = {}, 0
    for c, n_blocks in ((c1, 2 * n1), (c2, 2 * n2), (c2, 3 * n2), (c1, 3 * n1), (c2, n2)):
        for _ in range(n_blocks):
            idx += 1
            for name in ("to_k_ip", "to_v_ip"):
                sd[f"ip_adapter.{idx}.{name}.weight"] = (
                    torch.randn(c, ctx, generator=g, device=dev) * ctx**-0.5).bfloat16().cpu()
            idx += 1
    sd["image_proj.proj.weight"] = (torch.randn(IP_TOKENS * ctx, IP_EMBED, generator=g,
                                                device=dev) * IP_EMBED**-0.5).bfloat16().cpu()
    sd["image_proj.proj.bias"] = torch.zeros(IP_TOKENS * ctx, dtype=torch.bfloat16)
    sd["image_proj.norm.weight"] = torch.ones(ctx, dtype=torch.bfloat16)
    sd["image_proj.norm.bias"] = torch.zeros(ctx, dtype=torch.bfloat16)
    os.makedirs(path)
    save_file(sd, os.path.join(path, "ip-adapter.safetensors"))


def _engine_sdxl_conditioning(eng, kw: dict) -> None:
    """The int8 SDXL engine's ControlNet (controlnet_path) and IP-Adapter
    (ip_adapter_path): one 1024x2048 CFG generate with a control_image, one
    with ip_adapter_image_embeds and one with an ip_adapter_image (the
    checkpoint's image_encoder/, read at the first image), launches 4 x
    (sdxl_forward_launches + sdxl_controlnet_launches /
    sdxl_ip_adapter_launches); the image generate equals, bit for bit, the
    generate from the image encoder's own embeddings of it."""
    import numpy as np
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend

    per_u = sdxl_forward_launches(eng.cfg)
    emb = torch.randn(1, IP_EMBED, generator=torch.Generator(device=eng.device).manual_seed(16),
                      device=eng.device)
    image = _seeded_image(503, VISION_FRAME_H, VISION_FRAME_W)
    for label, extra, per in (
            ("controlnet", dict(control_image=_seeded_image(502, SDXL_H, SDXL_W),
                                controlnet_conditioning_scale=CN_SCALE),
             sdxl_controlnet_launches(eng.cfg)),
            ("ip-adapter", dict(ip_adapter_image_embeds=emb), sdxl_ip_adapter_launches(eng.cfg)),
            ("ip-adapter image", dict(ip_adapter_image=image),
             sdxl_ip_adapter_launches(eng.cfg))):
        cuda_backend.reset_launch_counts()
        img, sec = _timed(eng.generate, height=SDXL_H, width=SDXL_W, **kw, **extra)
        counts = _launch_counts()
        want = {k: SDXL_STEPS * (per_u[k] + per[k]) for k in per_u}
        log(f"[engine sdxl {label}] generate {SDXL_H}x{SDXL_W} {SDXL_STEPS} steps CFG: "
            f"{sec:.3f} s, image {img.shape} {img.dtype}; launches {counts}")
        if not (isinstance(img, np.ndarray) and img.shape == (1, SDXL_H, SDXL_W, 3)
                and img.dtype == np.uint8) or counts != want:
            raise AssertionError(f"the SDXL {label} generate: launches {counts} != {want}")
        CN_SUMMARY[f"engine_sdxl_{label.replace('-', '_').replace(' ', '_')}_s"] = round(sec, 4)
        if label == "ip-adapter image":
            from_embeds = eng.generate(height=SDXL_H, width=SDXL_W, **kw,
                                       ip_adapter_image_embeds=eng.image_encoder.encode(image))
            same = np.array_equal(img, from_embeds)
            log(f"[engine sdxl {label}] equal bit for bit to the generate from the 2-layer "
                f"ViT-bigG tower's image_embeds of it: {same} (required)")
            if not same:
                raise AssertionError("the SDXL ip_adapter_image generate != its embeds generate")


# ------------------------------------------- CLIP vision tower and Wan2.1-I2V


def _int_mm_ms(a, b, label: str):
    """torch._int_mm(a, b)'s mean ms (the s32 product alone, a yardstick the
    port never calls), or None when it refuses the shape; the first line of
    its error is logged."""
    import torch

    try:
        return cuda_ms(lambda: torch._int_mm(a, b), 10)
    except RuntimeError as e:
        msg = str(e).strip().splitlines()[0] if str(e).strip() else type(e).__name__
        log(f"[int8 w8a8] torch._int_mm at {label} {tuple(a.shape)} @ {tuple(b.shape)} refused: "
            f"{msg}")
        I2V_SUMMARY.setdefault("int_mm_errors", {})[label] = msg
        return None


def _image_branch_kernels(dev, g) -> None:
    """The kernels at the shapes Wan2.1-I2V-14B's image branch gives them at
    480x832x81 (40 heads of 128, 5120 wide, 257 image tokens, 32760 video
    tokens in 8 chunks of 4095), at batch 1 and batch 2, each held to its
    plain version and timed beside its bound and the library call: sdpa of a
    4095-token chunk against the 257 image keys (two 128-key tiles and a tail
    of one; 8 per block), and once unchunked (32760 queries); the int8
    quantizer and GEMM at M = 257 * batch, K = N = 5120 (add_k and add_v, a
    one-row M tail) bit-exact, with and without the zero point, beside
    torch._int_mm's time or its error; rmsnorm (norm_added_k) on (batch,
    257, 5120) rows within one bf16 ulp."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb

    d, h, hd, m = WAN_DIM, WAN_HEADS, WAN_DIM // WAN_HEADS, I2V21_IMAGE_TOKENS
    tokens = _wan_shape(WAN_FRAMES)[3]
    chunk = tokens // 8
    t = I2V_SUMMARY.setdefault("kernel_ms", {})
    w = (1 + 0.05 * torch.randn(d, generator=g, device=dev)).bfloat16()
    for b in (1, 2):
        q = torch.randn(b, chunk, d, generator=g, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(b, m, d, generator=g, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        t[f"sdpa_image_b{b}"] = _sdpa_case(
            f"Wan2.1-I2V image keys, batch {b} ({chunk}-token chunk, 8 per block)", q, k, v, h,
            hd, long_rows=False)
        if b == 1:
            qf = torch.randn(1, tokens, d, generator=g, device=dev, dtype=torch.bfloat16)
            t["sdpa_image_unchunked"] = _sdpa_case(
                "Wan2.1-I2V image keys, unchunked", qf, k, v, h, hd, long_rows=False)
            del qf
        rows = b * m
        x = torch.randn(rows, d, generator=g, device=dev, dtype=torch.bfloat16) * 3
        x[0] = 0  # an all-zero row: the scale floor
        got = cb.quantize_to_int8_cuda(x, symmetric=False)
        want = tb.quantize_to_int8_torch(x, symmetric=False)
        if not all(torch.equal(u, v_) for u, v_ in zip(got, want)):
            raise AssertionError(f"quantize_to_int8 disagrees at M={rows}, K={d}")
        q_ms = cuda_ms(lambda: cb.quantize_to_int8_cuda(x, symmetric=False), 50)
        q_plain = cuda_ms(lambda: tb.quantize_to_int8_torch(x, symmetric=False), 10)
        qb_ms, qb_by = bound(_quantize_bytes(rows, d, False), 8 * rows * d, F32_FLOPS)
        a, sa, lin, args = _w8a8_operands("int8", rows, d, d, g, dev)
        _int8_exact(args, f"Wan2.1-I2V add_k/add_v {rows}x{d} @ {d}x{d}")  # raises on a mismatch
        ms = cuda_ms(lambda: cb.int8_matmul_cuda(*args), 20)
        plain_ms = cuda_ms(lambda: tb.int8_matmul_torch(*args), 3, 1)
        lib_ms = _int_mm_ms(a, lin.w, f"M={rows}")
        b_ms, b_by = bound(_gemm_bytes(rows, d, d), 2 * rows * d * d, INT8_FP8_OPS)
        log(f"[int8 w8a8] Wan2.1-I2V add_k / add_v, batch {b}: {rows}x{d} @ {d}x{d} (2 per "
            f"block) quantize and GEMM bit-exact (with and without azp); GEMM {ms:.4f} ms "
            f"({b_ms / ms:.1%} of the bound {b_ms:.4f} ms, {b_by}), plain {plain_ms:.4f} ms, "
            f"library (torch._int_mm, s32 product only) {lib_ms} ms; quantize {q_ms:.4f} ms "
            f"({qb_ms / q_ms:.1%} of the bound {qb_ms:.4f} ms, {qb_by}), plain {q_plain:.4f} ms")
        t[f"int8_matmul_{rows}x{d}x{d}"], t[f"quantize_to_int8_{rows}x{d}"] = ms, q_ms
        t[f"int_mm_{rows}x{d}x{d}"] = lib_ms
        xr = torch.randn(b, m, d, generator=g, device=dev, dtype=torch.bfloat16) * 2
        t[f"rmsnorm_image_b{b}"] = _rms_case(f"Wan2.1-I2V norm_added_k, batch {b}", xr, w)
        del q, k, v, x, got, want, a, sa, lin, args, xr
    torch.cuda.empty_cache()


def _engine_shell(dev, architecture: str, **attrs):
    """A FastDMEngine around modules drawn in memory (no checkpoint read), so
    that generate() and the engine's own helpers (its image encoders, the
    i2v conditioning channels) run on full-depth random models."""
    from fastdm_tpu_torch.engine import FastDMEngine

    eng = FastDMEngine.__new__(FastDMEngine)
    vars(eng).update(architecture=architecture, architecture_full=architecture, device=dev,
                     verbose=False, cache_config=None, cn_params=None, cn_cfg=None,
                     text_encoder=None, _denoisers={}, last_cache_skips=0, vae_tiling=False,
                     vae_slicing=False, ip_proj=None, image_encoder=None)
    vars(eng).update(attrs)
    return eng


def _vision_config(name: str, layers: Optional[int] = None):
    from fastdm_tpu_torch.models.clip_vision import CLIPVisionConfig

    kw, _, _ = VISION_TOWERS[name]
    return CLIPVisionConfig(**dict(kw, **({} if layers is None else
                                          {"num_hidden_layers": layers})))


def _vision_encoder(name: str, dev, layers: Optional[int] = None):
    """A CLIPImageEncoder holding VISION_TOWERS[name] drawn from its seed (f32,
    layers cut when given) and the preprocessing at its image size."""
    from fastdm_tpu_torch.models.clip_vision import clip_vision_init_random
    from fastdm_tpu_torch.pipeline.image_processor import CLIPImageProcessor
    from fastdm_tpu_torch.pipeline.text_encoder import CLIPImageEncoder

    _, projection, seed = VISION_TOWERS[name]
    cfg = _vision_config(name, layers)
    enc = CLIPImageEncoder(f"<{name} drawn from seed {seed}>", device=dev)
    enc.model = clip_vision_init_random(seed, cfg, projection, device=dev)
    enc.processor = CLIPImageProcessor(cfg.image_size, cfg.image_size)
    enc.loaded = True
    return enc


def _vision_flops(cfg, b: int = 1) -> float:
    """The tower's forward operations: the patch matmul, per layer q, k, v,
    out and the MLP (2 * tokens * weights) and the attention (4 * tokens^2 *
    width), the projection."""
    s, d, mlp = cfg.num_positions, cfg.hidden_size, cfg.intermediate_size
    layer = 2 * s * (4 * d * d + 2 * d * mlp) + 4 * s * s * d
    return b * (2 * (s - 1) * d * cfg.num_channels * cfg.patch_size ** 2
                + cfg.num_hidden_layers * layer + 2 * d * cfg.projection_dim)


def phase_vision(dev) -> None:
    """The two CLIP vision towers (VISION_TOWERS) at full width and depth on
    the card in f32, from seeds: each encodes one seeded 720x1280 uint8 frame
    through the port's preprocessing (resize, crop, normalize on the host,
    then the (1, 3, 224, 224) batch to the card) into its penultimate
    hidden states and its projected image_embeds (a warm-up, then timed:
    preprocessing ms, encode ms, f32 TFLOP/s, peak GiB); no kernel launches;
    then its first two layers (embeddings, pre_layrnorm, post_layernorm, the
    projection) on the card are held to the same two layers on the CPU
    within VISION_REL_L2_TOL; then it is freed."""
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.clip_vision import CLIPVisionModel

    frame = _seeded_image(600, VISION_FRAME_H, VISION_FRAME_W)
    for name in VISION_TOWERS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        enc, init_s = _timed(_vision_encoder, name, dev)
        cfg, model = enc.model.cfg, enc.model
        n_params = sum(p.numel() for p in model.parameters())
        weights = torch.cuda.memory_allocated() / 2**30
        cuda_backend.reset_launch_counts()
        enc.encode(frame, hidden_states=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        px, pre_s = _timed(lambda: torch.from_numpy(enc.processor(frame)).to(dev))
        with torch.inference_mode():
            out, fwd_s = _timed(model, px)
        hidden, enc_s = _timed(enc.encode, frame, hidden_states=True)
        embeds, emb_s = _timed(enc.encode, frame)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tflops = _vision_flops(cfg) / fwd_s / 1e12
        counts = _launch_counts()
        ok = (tuple(hidden.shape) == (1, cfg.num_positions, cfg.hidden_size)
              and tuple(embeds.shape) == (1, cfg.projection_dim)
              and bool(torch.isfinite(hidden.float()).all())
              and bool(torch.isfinite(embeds.float()).all()))
        log(f"[vision {name}] {n_params / 1e9:.3f} B params ({weights:.2f} GiB f32, drawn in "
            f"{init_s:.2f} s), {cfg.num_hidden_layers} layers of {cfg.hidden_size}, "
            f"{cfg.num_attention_heads} heads, MLP {cfg.intermediate_size}: a "
            f"{VISION_FRAME_H}x{VISION_FRAME_W} frame preprocessed in {pre_s * 1e3:.1f} ms, the "
            f"tower's forward {fwd_s * 1e3:.2f} ms ({tflops:.1f} TFLOP/s f32 of "
            f"{_vision_flops(cfg) / 1e12:.3f} TFLOP), encode to hidden states "
            f"{tuple(hidden.shape)} {enc_s * 1e3:.2f} ms, to image_embeds "
            f"{tuple(embeds.shape)} {emb_s * 1e3:.2f} ms; peak {peak:.2f} GiB; kernel "
            f"launches {sum(counts.values())}")
        if not ok or any(counts.values()):
            raise AssertionError(f"{name}: outputs {tuple(hidden.shape)}, {tuple(embeds.shape)} "
                                 f"(finite, as expected: {ok}), launches {counts}")
        entry = {"params": n_params, "init_s": round(init_s, 3),
                 "preprocess_ms": round(pre_s * 1e3, 2), "forward_ms": round(fwd_s * 1e3, 2),
                 "encode_hidden_ms": round(enc_s * 1e3, 2), "encode_embeds_ms":
                 round(emb_s * 1e3, 2), "tflops_f32": round(tflops, 1), "peak_gib": round(peak, 3)}
        # the first two layers, on the card and on the CPU
        small = _vision_config(name, 2)
        with torch.device("meta"):
            gpu2, cpu2 = CLIPVisionModel(small, True), CLIPVisionModel(small, True)
        full = model.state_dict()
        gpu2.load_state_dict({k: full[k] for k in gpu2.state_dict()}, assign=True)
        cpu2.load_state_dict({k: full[k].cpu() for k in cpu2.state_dict()}, assign=True)
        with torch.inference_mode():
            t0 = time.perf_counter()
            want = cpu2(px.cpu())
            cpu_s = time.perf_counter() - t0
            got = gpu2(px)
        errs = [float((g_.cpu() - w_).norm() / w_.norm()) for g_, w_ in
                zip((got.penultimate, got.last_hidden_state, got.image_embeds),
                    (want.penultimate, want.last_hidden_state, want.image_embeds))]
        log(f"[vision {name}] 2 layers on the card vs the CPU: relative L2 (hidden_states[-2], "
            f"last, image_embeds) {[f'{e:.3e}' for e in errs]} (gate {VISION_REL_L2_TOL}; CPU "
            f"{cpu_s:.2f} s)")
        if max(errs) > VISION_REL_L2_TOL:
            raise AssertionError(f"{name}: the card's two layers are {errs} from the CPU's")
        entry["two_layer_rel_l2"] = [float(f"{e:.3e}") for e in errs]
        I2V_SUMMARY[f"vision {name}"] = entry
        del enc, model, gpu2, cpu2, full, got, want, out, px, hidden, embeds
        torch.cuda.empty_cache()


def _sdxl_image_requests(dev, params, cfg, simple, plus) -> None:
    """On the full-depth int8 SDXL-base with the random IP-Adapter k|v: an
    ip_adapter_image request through FastDMEngine.generate for each adapter
    (ip-adapter_sdxl with the full ViT-bigG tower's projected image_embeds,
    ip-adapter-plus with the full ViT-H tower's penultimate states) on a
    seeded 720x1280 frame, equal bit for bit to the same request made from
    ip_adapter_image_embeds of that tower's output; launches 4 x
    (sdxl_forward_launches + sdxl_ip_adapter_launches) plus the resampler's
    sdpa, the towers launching none."""
    import numpy as np
    import torch

    from fastdm_tpu_torch.kernels import cuda_backend

    per_u, per_ip = sdxl_forward_launches(cfg), sdxl_ip_adapter_launches(cfg)
    frame = _seeded_image(601, VISION_FRAME_H, VISION_FRAME_W)
    g = torch.Generator(device=dev).manual_seed(602)
    pooled_dim = cfg.add_embedding_in_dim - 6 * cfg.addition_time_embed_dim
    pos, neg = (torch.randn(1, SDXL_TEXT, cfg.cross_attention_dim, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    pp, npool = (torch.randn(1, pooled_dim, generator=g, device=dev, dtype=torch.bfloat16)
                 for _ in range(2))
    kw = dict(prompt_embeds=pos, pooled_prompt_embeds=pp, negative_prompt_embeds=neg,
              negative_pooled_prompt_embeds=npool, height=SDXL_H, width=SDXL_W,
              num_inference_steps=SDXL_STEPS, guidance_scale=SDXL_CFG, seed=603,
              output_type="latent")
    for label, proj, tower, resampler in (("ip-adapter", simple, "vit-bigg", 0),
                                          ("ip-adapter-plus", plus, "vit-h", PLUS_LAYERS)):
        enc, init_s = _timed(_vision_encoder, tower, dev)
        eng = _engine_shell(dev, "sdxl", params=params, cfg=cfg, ip_proj=proj,
                            image_encoder=enc)
        eng.generate(ip_adapter_image=frame, **kw)  # warm
        torch.cuda.reset_peak_memory_stats()
        cuda_backend.reset_launch_counts()
        got, sec = _timed(eng.generate, ip_adapter_image=frame, **kw)
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        emb, enc_s = _timed(enc.encode, frame, hidden_states=label == "ip-adapter-plus")
        want, emb_sec = _timed(eng.generate, ip_adapter_image_embeds=emb, **kw)
        same = np.array_equal(got, want)
        expect = {k: SDXL_STEPS * (per_u[k] + per_ip[k]) + (resampler if k == "sdpa" else 0)
                  for k in per_u}
        log(f"[sdxl {label} image] request {SDXL_H}x{SDXL_W} {SDXL_STEPS} steps, CFG "
            f"{SDXL_CFG}, from a {VISION_FRAME_H}x{VISION_FRAME_W} ip_adapter_image through the "
            f"full {tower} tower (drawn in {init_s:.2f} s): {sec:.3f} s, from its "
            f"ip_adapter_image_embeds {tuple(emb.shape)} {emb_sec:.3f} s (the encode alone "
            f"{enc_s * 1e3:.1f} ms); latents equal bit for bit: {same} (required); peak "
            f"{peak:.2f} GiB; launches equal the derived ones: {counts == expect}")
        if not same or counts != expect or not np.isfinite(got).all():
            raise AssertionError(f"SDXL {label} image request: equal {same}, launches {counts} "
                                 f"!= {expect}")
        I2V_SUMMARY[f"sdxl {label} image request s (embeds request s, encode s)"] = (
            round(sec, 3), round(emb_sec, 3), round(enc_s, 4))
        del enc, eng, emb
        torch.cuda.empty_cache()


def phase_i2v(dev) -> None:
    """Wan2.1-I2V-14B-480P int8 at full width and depth (40 blocks, 40x128
    heads, in_channels 36, image_dim 1280, added_kv_proj_dim 5120), drawn
    from a seed, conditioned on the full ViT-H tower's 257 penultimate tokens
    of a seeded 480x832 first frame: one 480x832x81 forward (32760 tokens,
    8 chunks of 4095, 512 text tokens) timed, with exact launches (the image
    branch adds 2 int8 linears, 1 rmsnorm and 8 sdpa a block) and held bit
    for bit to the forward with only the int8 ops plain; the same forward at
    17 frames (7800 tokens, 8 chunks of 975) held to the plain forward; then
    an i2v request through make_wan_denoiser(encoder_image=...) (UniPC shift
    5, CFG 5.0, 2 steps) with the engine's i2v conditioning channels (the
    full-size Wan VAE encodes the frame and 80 zero frames) and the chunked
    decode: seconds, peak GiB, launches."""
    import torch

    from fastdm_tpu_torch.engine import wan_capacity_config
    from fastdm_tpu_torch.kernels import cuda_backend, kernel_registry
    from fastdm_tpu_torch.models.wan import WanConfig, wan_forward, wan_init_random, \
        wan_rope_cos_sin
    from fastdm_tpu_torch.pipeline.denoise_wan import make_wan_denoiser
    from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler
    from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig, wan_vae_decode_chunked, \
        wan_vae_decoder_random, wan_vae_encoder_random

    lf, lh, lw, tokens = _wan_shape(WAN_FRAMES)
    cfg = wan_capacity_config(WanConfig(quant="int8", in_channels=36, image_dim=I2V21_IMAGE_DIM,
                                        added_kv_proj_dim=WAN_DIM), tokens, dual=False)
    params, init_s = _timed(wan_init_random, 91, cfg, device=dev)
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[i2v] Wan2.1-I2V-14B-480P int8 random init: {n / 1e9:.3f} B params "
        f"({nbytes / 2**30:.2f} GiB), {cfg.num_layers} blocks, in_channels {cfg.in_channels}, "
        f"image_dim {cfg.image_dim}, added_kv_proj_dim {cfg.added_kv_proj_dim}, in {init_s:.1f} "
        f"s; {WAN_H}x{WAN_W}x{WAN_FRAMES} = {tokens} tokens, ffn_chunk_tokens "
        f"{cfg.ffn_chunk_tokens}")
    enc = _vision_encoder("vit-h", dev)
    image = _seeded_image(92, WAN_H, WAN_W)
    img_tokens, enc_s = _timed(enc.encode, image, hidden_states=True)
    log(f"[i2v] ViT-H image tokens {tuple(img_tokens.shape)} {img_tokens.dtype} in "
        f"{enc_s * 1e3:.1f} ms (the first encode)")
    if tuple(img_tokens.shape) != (1, I2V21_IMAGE_TOKENS, I2V21_IMAGE_DIM):
        raise AssertionError(f"the ViT-H tokens are {tuple(img_tokens.shape)}")
    g = torch.Generator(device=dev).manual_seed(93)
    x = torch.randn(1, cfg.in_channels, lf, lh, lw, generator=g, device=dev).bfloat16()
    pos, neg = (torch.randn(1, WAN_TEXT, cfg.text_dim, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    t = torch.full((1,), 937.5, device=dev)

    def forward(plain_ops=(), c=cfg, frames=lf):
        cos, sin = wan_rope_cos_sin(c, frames, lh, lw, device=dev)
        with torch.inference_mode(), kernel_registry.plain_on_device(plain_ops):
            return wan_forward(params, c, x[:, :, :frames], t, pos, img_tokens, rope_cos=cos,
                               rope_sin=sin).float()

    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    out_k = forward()
    torch.cuda.synchronize()
    counts = _launch_counts()
    want = wan_forward_launches(cfg, tokens, image=True)
    plain_t2v = wan_forward_launches(cfg, tokens)
    added = {k: want[k] - plain_t2v[k] for k in want if want[k] != plain_t2v[k]}
    log(f"[i2v] kernel launches of one forward: {({k: v for k, v in counts.items() if v})}; "
        f"the image branch adds {added}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want or added != {"sdpa": 320, "rmsnorm": 40, "quantize_to_int8": 80,
                                   "int8_matmul": 80}:
        raise AssertionError(f"Wan2.1-I2V launch counts {counts} != derived {want}")
    _, fwd_s = _timed(forward)
    out_w = forward(plain_ops=INT8_OPS)
    same = torch.equal(out_k, out_w)
    log(f"[i2v] full-depth forward at {tokens} tokens with {I2V21_IMAGE_TOKENS} image tokens: "
        f"{fwd_s:.3f} s; with only {list(INT8_OPS)} plain: bit-identical {same} (required)")
    if not same or not torch.isfinite(out_k).all():
        raise AssertionError("the Wan2.1-I2V forward departs from its int8-plain forward")
    lf17, _, _, tokens17 = _wan_shape(I2V21_GATE_FRAMES)
    cfg17 = dataclasses.replace(cfg, ffn_chunk_tokens=tokens17 // 8)
    out17 = forward(c=cfg17, frames=lf17)
    out17_p, plain_s = _timed(forward, None, cfg17, lf17)
    rel = ((out17 - out17_p).norm() / out17_p.norm()).item()
    log(f"[i2v] full-depth forward at {I2V21_GATE_FRAMES} frames ({tokens17} tokens, chunks of "
        f"{cfg17.ffn_chunk_tokens}): kernels vs plain versions ({plain_s:.1f} s) relative L2 "
        f"{rel:.3e} (tolerance {WAN_FORWARD_REL_L2_TOL})")
    if not rel <= WAN_FORWARD_REL_L2_TOL or not torch.isfinite(out17).all():
        raise AssertionError(f"the Wan2.1-I2V kernel forward departs from the plain one: {rel}")
    I2V_SUMMARY["wan2.1-i2v forward s"] = round(fwd_s, 3)
    I2V_SUMMARY["wan2.1-i2v 17-frame rel L2"] = float(f"{rel:.3e}")
    del out_k, out_w, out17, out17_p
    torch.cuda.empty_cache()

    # the request: the engine's i2v channels on a shell engine, the loop, the decode
    vae_cfg = WanVAEConfig()
    vae = {**wan_vae_encoder_random(94, vae_cfg, device=dev),
           **wan_vae_decoder_random(95, vae_cfg, device=dev)}
    eng = _engine_shell(dev, "wan", vae_params=vae, vae_cfg=vae_cfg)
    sched = UniPCMultistepScheduler.create(I2V21_STEPS, shift=5.0)
    run = make_wan_denoiser(cfg, sched, I2V21_STEPS, I2V21_CFG)
    cos, sin = wan_rope_cos_sin(cfg, lf, lh, lw, device=dev)
    latents = torch.randn(1, cfg.out_channels, lf, lh, lw, generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_backend.reset_launch_counts()
    t0 = time.perf_counter()
    img_tokens, enc_s = _timed(enc.encode, image, hidden_states=True)
    cond, cond_s = _timed(eng._wan_i2v_latents, image, lf, lh, lw, WAN_FRAMES)
    (lat, _), den_s = _timed(run, params, latents, pos, neg, cos, sin, None, cond, img_tokens)
    video, dec_s = _timed(wan_vae_decode_chunked, vae, vae_cfg, lat)
    sec = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: 2 * I2V21_STEPS * v for k, v in wan_forward_launches(cfg, tokens, image=True).items()}
    finite = bool(torch.isfinite(video).all())
    log(f"[i2v] request {WAN_H}x{WAN_W}x{WAN_FRAMES}, {I2V21_STEPS} steps, CFG {I2V21_CFG}: "
        f"{sec:.3f} s (ViT-H encode {enc_s * 1e3:.1f} ms, i2v channels {cond_s:.3f} s, denoise "
        f"{den_s:.3f} s, chunked VAE decode {dec_s:.3f} s), cond {tuple(cond.shape)}, video "
        f"{tuple(video.shape)} finite={finite}; peak device memory {peak:.2f} GiB; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    if not finite or tuple(video.shape) != (1, WAN_FRAMES, WAN_H, WAN_W, 3) or counts != want:
        raise AssertionError(f"the Wan2.1-I2V request: launches {counts} != {want}")
    I2V_SUMMARY["wan2.1-i2v request s (encode, cond, denoise, decode)"] = (
        round(sec, 3), round(enc_s, 4), round(cond_s, 3), round(den_s, 3), round(dec_s, 3))
    I2V_SUMMARY["wan2.1-i2v request peak GiB"] = round(peak, 2)
    del params, enc, vae, eng, video, lat, cond
    torch.cuda.empty_cache()


def _write_image_encoder(path: str, name: str, dev, projection: bool, layers: int = 2) -> None:
    """VISION_TOWERS[name] at full width, `layers` layers, bf16, as an
    image_encoder/ directory (config.json, preprocessor_config.json)."""
    import torch

    from fastdm_tpu_torch.models.clip_vision import clip_vision_init_random, save_image_encoder

    _, _, seed = VISION_TOWERS[name]
    model = clip_vision_init_random(seed + 100, _vision_config(name, layers), projection,
                                    device=dev)
    save_image_encoder(model, path, torch.bfloat16)


def _engine_wan21_i2v(dev, here: str) -> None:
    """FastDMEngine as wan2.1-i2v and as wan-i2v on one synthetic
    Wan2.1-I2V-14B checkpoint (full width, one block, int8 at load, the
    image embedder and add_k / add_v, the full-size Wan2.1-layout VAE, the
    UMT5 directories and a full-width 2-layer ViT-H image_encoder/ without
    projection): an i2v generate from prompt strings and a uint8 480x832
    image at 17 frames, 2 steps, CFG 5.0; launches exact, the two names'
    videos equal."""
    import tempfile

    import numpy as np
    import torch

    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models.wan import WanConfig

    cfg = dataclasses.replace(WanConfig(), num_layers=1, in_channels=36,
                              image_dim=I2V21_IMAGE_DIM, added_kv_proj_dim=WAN_DIM)
    tokens = _wan_shape(WAN_ENGINE_FRAMES)[3]
    with tempfile.TemporaryDirectory(dir=here, prefix=".smoke-ckpt-") as root:
        t0 = time.perf_counter()
        _write_wan_checkpoint(root, dev, cfg, experts=1, seed=96)
        _write_image_encoder(os.path.join(root, "image_encoder"), "vit-h", dev, False)
        _link_text_dirs(root, "wan")
        log(f"[engine wan2.1-i2v] wrote the synthetic Wan2.1-I2V checkpoint (one block, the "
            f"image branch, a 2-layer ViT-H image_encoder/) in {time.perf_counter() - t0:.1f} s")
        image = _seeded_image(97, WAN_H, WAN_W)
        prompt, negative = TEXT_PROMPTS
        videos = {}
        for arch in ("wan2.1-i2v", "wan-i2v"):
            eng, load_s = _timed(FastDMEngine, root, architecture=arch, use_int8=True,
                                 verbose=False, device=dev)
            if not (eng.params.image_embedder is not None and eng.wan_image_encoder is not None
                    and eng.params.blocks[0].attn2.add_k.w.dtype == torch.int8):
                raise AssertionError(f"the {arch} engine did not load the int8 image branch")
            eng.generate(task="i2v", image=image, prompt=prompt, negative_prompt=negative,
                         height=WAN_H, width=WAN_W, num_frames=WAN_ENGINE_FRAMES,
                         num_inference_steps=1, guidance_scale=I2V21_CFG, seed=98)  # warm
            cuda_backend.reset_launch_counts()
            video, sec = _timed(eng.generate, task="i2v", image=image, prompt=prompt,
                                negative_prompt=negative, height=WAN_H, width=WAN_W,
                                num_frames=WAN_ENGINE_FRAMES, num_inference_steps=I2V21_STEPS,
                                guidance_scale=I2V21_CFG, seed=98)
            counts = _launch_counts()
            want = {k: 2 * I2V21_STEPS * v
                    for k, v in wan_forward_launches(eng.cfg, tokens, image=True).items()}
            log(f"[engine {arch}] loaded in {load_s:.1f} s; i2v generate from prompt strings "
                f"and a {WAN_H}x{WAN_W} uint8 image, {WAN_ENGINE_FRAMES} frames, {I2V21_STEPS} "
                f"steps: {sec:.3f} s, video {video.shape} {video.dtype}; launches "
                f"{({k: v for k, v in counts.items() if v})}")
            if not (isinstance(video, np.ndarray) and video.dtype == np.uint8 and video.shape ==
                    (1, WAN_ENGINE_FRAMES, WAN_H, WAN_W, 3)) or counts != want:
                raise AssertionError(f"the {arch} generate: launches {counts} != {want}")
            videos[arch] = video
            I2V_SUMMARY[f"engine {arch} generate s"] = round(sec, 3)
            del eng
            torch.cuda.empty_cache()
        if not np.array_equal(*videos.values()):
            raise AssertionError("wan2.1-i2v and wan-i2v generate different videos")
        log("[engine wan-i2v] the wan2.1-i2v and wan-i2v videos are equal bit for bit")



# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to drive", file=sys.stderr)
        return 1
    import fastdm_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    dev = torch.device("cuda")
    # the plain versions' f32 products (fp8 GEMM) in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    kernels = phase_kernels(dev)
    summary = {}  # the image-conditioned requests' numbers
    launches = phase_slice(dev, summary)
    launches.update(phase_wan(dev))
    launches.update(phase_sdxl(dev))
    phase_sd35(dev)
    phase_qwen(dev, summary)
    wan5b = phase_wan5b(dev)
    phase_text(dev)
    phase_vision(dev)
    phase_i2v(dev)
    phase_engine(dev, summary)
    for name, r in kernels.items():
        r["launches"] = launches[name]
    log(f"[done] {len(kernels)} kernels, all phases in {time.perf_counter() - t0:.1f} s")
    log(f"[wan5b] Wan2.2-TI2V-5B int8 {WAN5B_H}x{WAN5B_W}x{WAN5B_FRAMES}, {WAN5B_STEPS} steps, "
        f"and Wan i2v {WAN_H}x{WAN_W}x{WAN_FRAMES}: {wan5b}")
    log(f"[img2img] image-conditioned requests (seconds, GiB): {summary}")
    log(f"[controlnet] ControlNet / IP-Adapter kernels (ms), requests and forwards (seconds, "
        f"GiB): {CN_SUMMARY}")
    log(f"[snapshot] quantized snapshots (seconds, bytes): {SNAPSHOT_SUMMARY}")
    log(f"[text] text encoders (seconds, GiB) and prompt generates (seconds): {TEXT_SUMMARY}")
    log(f"[i2v] CLIP vision towers, Wan2.1-I2V and the SDXL image requests (ms, seconds, GiB): "
        f"{I2V_SUMMARY}")

    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
