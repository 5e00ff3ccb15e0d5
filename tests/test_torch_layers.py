"""The port's layers (fastdm_tpu_torch.layers) against the JAX package's on
the same parameters and inputs (numpy seeds, bf16 weights on both sides).

Tolerances: float32 activations, rtol 1e-4 / atol 1e-5 (the layers end in
matmuls whose f32 sums run in another order in torch and in XLA); bf16
activations, within one bf16 ulp (QLinear) or stated per test; parameter
conversion, RoPE tables and the chunked/sliced QLinear identities are exact.
W8A8 QLinear: quantize_weight / fuse_and_quantize bit-exact in int8 and fp8
(w, scale, colsum); qlinear_apply bit-exact in int8 (integer GEMM, the same
per-token quantization and epilogue) and, in fp8, within 1 bf16 ulp of |JAX|
plus 2^-16 of the output's absolute-product scale (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.layers import attention as jattn
from fastdm_tpu.layers import embeddings as jemb
from fastdm_tpu.layers import feedforward as jff
from fastdm_tpu.layers import normalization as jnorm
from fastdm_tpu.layers import qlinear as jql
from fastdm_tpu_torch.layers import attention as tattn
from fastdm_tpu_torch.layers import embeddings as temb
from fastdm_tpu_torch.layers import normalization as tnorm
from fastdm_tpu_torch.layers import qlinear as tql
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.models.loader import as_tensor
from fastdm_tpu_torch.kernels import quantize_to_fp8
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

F32 = dict(rtol=1e-4, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _lin_pair(rng, k, n, bias=True):
    """One bf16 QLinear built from the same f32 numpy draw on both sides."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.02).astype(np.float32) if bias else None
    jp = jql.quantize_weight(jnp.asarray(w), None, None if b is None else jnp.asarray(b))
    tp = tql.quantize_weight(torch.from_numpy(w), None, None if b is None else torch.from_numpy(b))
    return jp, tp


def _x_pair(rng, shape, dtype="f32", scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if dtype == "f32":
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


# ------------------------------------------------------------------ qlinear


def test_quantize_weight_and_fuse_match_jax():
    rng = np.random.default_rng(0)
    jp, tp = _lin_pair(rng, 24, 40)
    np.testing.assert_array_equal(_np(tp.w), _np(jp["w"]))
    np.testing.assert_array_equal(_np(tp.bias), _np(jp["bias"]))
    assert tp.w.dtype == tp.bias.dtype == torch.bfloat16
    # fused projections with a bias-free segment: zero-filled, not dropped
    ws = [rng.standard_normal((8, n)).astype(np.float32) for n in (4, 6)]
    bs = [rng.standard_normal(4).astype(np.float32), None]
    jf = jql.fuse_and_quantize([jnp.asarray(w) for w in ws],
                               [jnp.asarray(bs[0]), None], None)
    tf = tql.fuse_and_quantize([torch.from_numpy(w) for w in ws],
                               [torch.from_numpy(bs[0]), None], None)
    np.testing.assert_array_equal(_np(tf.w), _np(jf["w"]))
    np.testing.assert_array_equal(_np(tf.bias), _np(jf["bias"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk_tokens", [0, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_qlinear_apply_matches_jax(dtype, chunk_tokens, bias):
    rng = np.random.default_rng(1)
    jp, tp = _lin_pair(rng, 32, 48, bias)
    xj, xt = _x_pair(rng, (2, 8, 32), dtype)
    got = tql.qlinear_apply(tp, xt, chunk_tokens)
    want = jql.qlinear_apply(jp, xj, chunk_tokens)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert (np.abs(_np(got) - _np(want)) <= _bf16_ulp(_np(want))).all()
    # chunking is an exact rewrite
    np.testing.assert_array_equal(_np(got), _np(tql.qlinear_apply(tp, xt)))


def test_qlinear_slice_out_is_exact_view():
    rng = np.random.default_rng(2)
    jp, tp = _lin_pair(rng, 16, 30)
    xj, xt = _x_pair(rng, (5, 16))
    part = tql.qlinear_slice_out(tp, 10, 22)
    assert part.w.data_ptr() == tp.w[:, 10:].data_ptr()  # no weight copy
    np.testing.assert_array_equal(_np(part(xt)), _np(tp(xt))[:, 10:22])
    np.testing.assert_allclose(_np(part(xt)),
                               _np(jql.qlinear_apply(jql.qlinear_slice_out(jp, 10, 22), xj)), **F32)


@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_qlinear_w8a8_waits_for_its_slice(quant):
    """int8 and fp8 (8-bit w as the (K, N) view of a K-contiguous buffer,
    per-channel f32 scale, int8 colsum) and, since the W4A4 slice, int4 and
    int4p (w4 / w4p as the (K, N) / (K/2, N) view of a K-contiguous buffer,
    no w, per-channel f32 scale, bf16 lora_u (K, 32) and lora_v (32, N))."""
    gen = torch.Generator().manual_seed(0)
    if quant == "int4":
        for q in ("int4", "int4p"):
            for lin in (tql.quantize_weight(torch.randn(64, 48), q),
                        tql.qlinear_random(gen, 64, 48, quant=q, device="cpu")):
                w4 = lin.w4 if q == "int4" else lin.w4p
                assert lin.w is None and (lin.w4p if q == "int4" else lin.w4) is None
                assert w4.dtype == torch.int8 and w4.stride(0) == 1
                assert tuple(w4.shape) == ((64, 48) if q == "int4" else (32, 48))
                assert lin.scale.dtype == torch.float32 and tuple(lin.scale.shape) == (48,)
                assert lin.colsum is None
                assert tuple(lin.lora_u.shape) == (64, 32) and tuple(lin.lora_v.shape) == (32, 48)
                assert lin.lora_u.dtype == lin.lora_v.dtype == torch.bfloat16
                y = lin(torch.randn(3, 64).bfloat16())
                assert y.dtype == torch.bfloat16 and tuple(y.shape) == (3, 48)
                assert torch.isfinite(y).all()
        return
    dtype = torch.int8 if quant == "int8" else torch.float8_e4m3fn
    for lin in (tql.quantize_weight(torch.randn(32, 16), quant),
                tql.qlinear_random(gen, 32, 16, quant=quant, device="cpu")):
        assert lin.w.dtype == dtype and tuple(lin.w.shape) == (32, 16) and lin.w.stride(0) == 1
        assert lin.scale.dtype == torch.float32 and tuple(lin.scale.shape) == (16,)
        assert (lin.colsum is not None) == (quant == "int8")
        if quant == "int8":
            assert torch.equal(lin.colsum, lin.w.sum(0, dtype=torch.int32))
        y = lin(torch.randn(3, 32).bfloat16())
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (3, 16) and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="unsupported"):
        tql.quantize_weight(torch.zeros(4, 4), "int3")


def _bits(x) -> np.ndarray:
    """Exact bit patterns: 16-bit floats as uint16, fp8 as uint8, the rest as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.uint16 if x.dtype == torch.bfloat16 else torch.uint8)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view(np.uint16 if a.dtype.name == "bfloat16" else np.uint8)
    return a


def _assert_qlinear_equal(tp, jp):
    """Every leaf of the port's QLinear bit-identical to the JAX param dict."""
    assert {k for k, _ in tp.named_parameters()} == set(jp)
    for k in jp:
        np.testing.assert_array_equal(_bits(getattr(tp, k)), _bits(jax.device_get(jp[k])),
                                      err_msg=k)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantize_weight_w8a8_matches_jax(quant):
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((48, 40)) * 0.05).astype(np.float32)
    w[:, 7] = 0  # an all-zero column: the 1e-12 scale floor
    b = (rng.standard_normal(40) * 0.02).astype(np.float32)
    _assert_qlinear_equal(tql.quantize_weight(torch.from_numpy(w), quant, torch.from_numpy(b)),
                          jql.quantize_weight(jnp.asarray(w), quant, jnp.asarray(b)))
    # fused projections, as the loader hands them over: transposed views
    ws = [rng.standard_normal((n, 24)).astype(np.float32) for n in (16, 8, 24)]
    bs = [rng.standard_normal(n).astype(np.float32) for n in (16, 8, 24)]
    tf = tql.fuse_and_quantize([torch.from_numpy(x).t() for x in ws],
                               [torch.from_numpy(x) for x in bs], quant)
    jf = jql.fuse_and_quantize([jnp.asarray(x.T) for x in ws], [jnp.asarray(x) for x in bs], quant)
    _assert_qlinear_equal(tf, jf)


def _w8a8_pair(rng, quant, k, n, bias=True):
    """A W8A8 QLinear quantized by JAX and carried across by the converter's rule."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.02).astype(np.float32) if bias else None
    jp = jql.quantize_weight(jnp.asarray(w), quant, None if b is None else jnp.asarray(b))
    leaves = {key: as_tensor(jax.device_get(v)) for key, v in jp.items()}
    return jp, tql.QLinear(**leaves)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("chunk_tokens", [0, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_qlinear_w8a8_apply_matches_jax(quant, chunk_tokens, bias):
    rng = np.random.default_rng(11)
    jp, tp = _w8a8_pair(rng, quant, 64, 48, bias)
    xj, xt = _x_pair(rng, (2, 8, 64), "bf16", scale=2.0)
    got = tql.qlinear_apply(tp, xt, chunk_tokens)
    want = jql.qlinear_apply(jp, xj, chunk_tokens)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    if quant == "int8":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        xq = np.abs(_np(quantize_to_fp8(xt.reshape(-1, 64))[0]))
        xs = _np(quantize_to_fp8(xt.reshape(-1, 64))[1])
        mag = (xq @ np.abs(_np(tp.w))) * xs * _np(tp.scale)[None, :]
        err = np.abs(_np(got) - _np(want)).reshape(-1, 48)
        assert (err <= _bf16_ulp(_np(want)).reshape(-1, 48) + 2.0**-16 * mag).all()
    np.testing.assert_array_equal(_np(got), _np(tql.qlinear_apply(tp, xt)))  # chunking is exact


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_qlinear_w8a8_slice_out_is_exact_view(quant):
    rng = np.random.default_rng(12)
    jp, tp = _w8a8_pair(rng, quant, 32, 30)
    xj, xt = _x_pair(rng, (5, 32), "bf16")
    part = tql.qlinear_slice_out(tp, 10, 22)
    assert part.w.data_ptr() == tp.w[:, 10:].data_ptr() and part.w.stride(0) == 1  # no copy
    np.testing.assert_array_equal(_np(part(xt)), _np(tp(xt))[:, 10:22])
    _assert_qlinear_equal(part, jql.qlinear_slice_out(jp, 10, 22))
    if quant == "int8":
        np.testing.assert_array_equal(
            _np(part(xt)), _np(jql.qlinear_apply(jql.qlinear_slice_out(jp, 10, 22), xj)))


# ------------------------------------------------------------ normalization


@pytest.mark.parametrize("shape", [(2, 7, 32), (1, 5, 3072)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(3)
    xj, xt = _x_pair(rng, shape, scale=3.0)
    np.testing.assert_allclose(_np(tnorm.layer_norm(xt)), _np(jnorm.layer_norm(xj)), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp32_layer_norm_affine_matches_jax(dtype):
    """Wan's norm2 (gamma, beta) and norm1/norm3 (no affine): f32 out from
    either input dtype."""
    rng = np.random.default_rng(13)
    xj, xt = _x_pair(rng, (2, 9, 48), dtype, scale=3.0)
    g = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    for gb in ((None, None), (g, b)):
        gj, bj = (None if a is None else jnp.asarray(a) for a in gb)
        gt, bt = (None if a is None else torch.from_numpy(a) for a in gb)
        got = tnorm.fp32_layer_norm(xt, gt, bt, 1e-6)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(jnorm.fp32_layer_norm(xj, gj, bj, 1e-6)), **F32)


def test_feedforward_chunks_are_exact():
    """Token chunks of the FFN (Wan's ffn_chunk_tokens) give the unchunked
    result bit for bit, in bf16 and in int8; a chunk that does not divide the
    token count runs unchunked, as in JAX."""
    rng = np.random.default_rng(14)
    _, xt = _x_pair(rng, (1, 12, 32), "bf16")
    for quant in (None, "int8"):
        g = torch.Generator().manual_seed(5)
        ff = FeedForward(tql.qlinear_random(g, 32, 64, quant=quant, device="cpu"),
                         tql.qlinear_random(g, 64, 32, quant=quant, device="cpu"))
        full = ff(xt)
        for chunk in (4, 6, 5):
            assert torch.equal(ff(xt, chunk_tokens=chunk), full)


@pytest.mark.parametrize("kind", ["zero", "zero_single", "continuous"])
def test_ada_layer_norm_family_matches_jax(kind):
    rng = np.random.default_rng(4)
    d = 32
    chunks = {"zero": 6, "zero_single": 3, "continuous": 2}[kind]
    jp, tp = _lin_pair(rng, d, chunks * d)
    xj, xt = _x_pair(rng, (2, 9, d), scale=2.0)
    ej, et = _x_pair(rng, (2, d))
    if kind == "zero":
        want = jnorm.ada_layer_norm_zero({"linear": jp}, xj, ej)
        got = tnorm.AdaLayerNormZero(tp)(xt, et)
    elif kind == "zero_single":
        want = jnorm.ada_layer_norm_zero_single({"linear": jp}, xj, ej)
        got = tnorm.AdaLayerNormZeroSingle(tp)(xt, et)
    else:
        want = (jnorm.ada_layer_norm_continuous({"linear": jp}, xj, ej),)
        got = (tnorm.AdaLayerNormContinuous(tp)(xt, et),)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


# --------------------------------------------------------------- embeddings


def test_timestep_embedding_matches_jax():
    """FLUX feeds timesteps in [0, 1000]; sin/cos of arguments up to 1e3 in
    float32 agree to ~1 ulp of the argument (6e-5)."""
    t = np.array([0.0, 1.0, 250.5, 999.0], np.float32)
    for flip, shift in ((True, 0.0), (False, 1.0)):
        want = jemb.get_timestep_embedding(jnp.asarray(t), 256, flip, shift)
        got = temb.get_timestep_embedding(torch.from_numpy(t), 256, flip, shift)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-4)


@pytest.mark.parametrize("guidance", [True, False])
def test_combined_timestep_text_proj_matches_jax(guidance):
    rng = np.random.default_rng(5)
    d, pooled_dim = 32, 24
    names = ["timestep_embedder", "text_embedder"] + (["guidance_embedder"] if guidance else [])
    jparams, tmods = {}, {}
    for n in names:
        j1, t1 = _lin_pair(rng, pooled_dim if n == "text_embedder" else 256, d)
        j2, t2 = _lin_pair(rng, d, d)
        jparams[n] = {"linear1": j1, "linear2": j2}
        tmods[n] = temb.TimestepEmbedding(t1, t2)
    mod = temb.CombinedTimestepTextProj(tmods["timestep_embedder"], tmods["text_embedder"],
                                        tmods.get("guidance_embedder"))
    t = np.array([0.3, 0.9], np.float32) * 1000
    g = np.array([3.5, 3.5], np.float32) * 1000
    pj, pt = _x_pair(rng, (2, pooled_dim))
    want = jemb.combined_timestep_text_proj_apply(
        jparams, jnp.asarray(t), pj, jnp.asarray(g) if guidance else None)
    got = mod(torch.from_numpy(t), pt, torch.from_numpy(g) if guidance else None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=2e-4)


def test_flux_rope_tables_equal_jax():
    """Host float64 angles -> float32: bit-identical tables."""
    ids = np.stack([np.zeros(60), np.repeat(np.arange(6), 10), np.tile(np.arange(10), 6)], -1)
    jc, js = jemb.flux_rope_cos_sin(ids, (8, 12, 12))
    tc, ts = temb.flux_rope_cos_sin(ids, (8, 12, 12), device="cpu")
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (60, 16)
    np.testing.assert_array_equal(_np(tc), _np(jc))
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(temb.rope_1d_freqs(16, np.arange(5)),
                                  jemb.rope_1d_freqs(16, np.arange(5)))


# -------------------------------------------------------------- feedforward


FF_CASES = [pytest.param(act, dtype, id=dtype if act == "gelu-approximate" else f"{act}-{dtype}")
            for act in ("gelu-approximate", "gelu", "geglu", "geglu-approximate", "swiglu")
            for dtype in ("f32", "bf16", "int8")]


@pytest.mark.parametrize("activation,dtype", FF_CASES)
def test_feedforward_matches_jax(activation, dtype):
    """The five activations of the JAX FeedForward. f32: within F32. bf16:
    XLA and PyTorch round bf16 GELU / sigmoid / SiLU differently on many
    elements (one ulp each), so the bound is relative L2 <= 1e-2. int8: both
    linears W8A8 (the same quantized weights on both sides) on bf16
    activations, relative L2 <= 1e-2 (a one-ulp activation difference can
    move an int8 step of the second linear's input). Token chunking is exact.
    An unknown name raises ValueError, as in JAX."""
    rng = np.random.default_rng(6)
    gated = activation in ("geglu", "swiglu")
    w1 = (rng.standard_normal((16, 128 if gated else 64)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((64, 16)) * 0.05).astype(np.float32)
    b1, b2 = ((rng.standard_normal(n) * 0.02).astype(np.float32) for n in (w1.shape[1], 16))
    quant = "int8" if dtype == "int8" else None
    jp = {k: jql.quantize_weight(jnp.asarray(w), quant, jnp.asarray(b))
          for k, w, b in (("proj", w1, b1), ("out", w2, b2))}
    ff = FeedForward(*(tql.quantize_weight(torch.from_numpy(w), quant, torch.from_numpy(b))
                       for w, b in ((w1, b1), (w2, b2))))
    xj, xt = _x_pair(rng, (2, 8, 16), "f32" if dtype == "f32" else "bf16")
    want = _np(jff.feedforward_apply(jp, xj, activation))
    got = _np(ff(xt, activation))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
    np.testing.assert_array_equal(_np(ff(xt, activation, chunk_tokens=4)), got)
    with pytest.raises(ValueError, match="unknown activation_fn"):
        ff(xt, "relu2")


# ---------------------------------------------------------------- attention


def _attn_pair(rng, heads, hd, joint):
    d = heads * hd
    jp, tkw = {}, {}
    names = ["qkv", "to_out"] + (["add_qkv", "to_add_out"] if joint else [])
    for n in names:
        j, t = _lin_pair(rng, d, 3 * d if n.endswith("qkv") else d)
        jp[n], tkw[n] = j, t
    norms = ["norm_q", "norm_k"] + (["norm_added_q", "norm_added_k"] if joint else [])
    for n in norms:
        w = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
        jp[n] = jnp.asarray(w, jnp.bfloat16)
        tkw[n] = as_tensor(jax.device_get(jp[n]))
    return jp, tattn.JointAttention(**tkw)


@pytest.mark.parametrize("joint", [True, False])
def test_attention_apply_matches_jax(joint):
    """Joint: context tokens first in the concat, per-head q/k norms, RoPE,
    split and both output projections. Single: precomputed fused qkv."""
    rng = np.random.default_rng(7)
    heads, hd, s_img, s_txt = 2, 16, 12, 5
    jp, tp = _attn_pair(rng, heads, hd, joint)
    hj, ht = _x_pair(rng, (1, s_img, heads * hd))
    s = s_img + (s_txt if joint else 0)
    freqs = rng.uniform(0, 6, (s, hd // 2))
    cos, sin = np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)
    kw_j = dict(heads=heads, head_dim=hd, rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    kw_t = dict(heads=heads, head_dim=hd, rope_cos=torch.from_numpy(cos),
                rope_sin=torch.from_numpy(sin))
    if joint:
        ej, et = _x_pair(rng, (1, s_txt, heads * hd))
        want = jattn.attention_apply(jp, hj, ej, **kw_j)
        got = tattn.attention_apply(tp, ht, et, **kw_t)
    else:
        qj, qt = _x_pair(rng, (1, s_img, 3 * heads * hd))
        want = (jattn.attention_apply(jp, hj, None, pre_only=True, qkv_override=qj, **kw_j),)
        got = (tattn.attention_apply(tp, ht, None, pre_only=True, qkv_override=qt, **kw_t),)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    if joint:
        with pytest.raises(ValueError, match="add_qkv"):
            tattn.attention_apply(tattn.JointAttention(qkv=tp.qkv), ht, et, **kw_t)
