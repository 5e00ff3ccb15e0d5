"""The port's kernel ops (fastdm_tpu_torch.kernels) against the JAX package.

On the CPU each op runs its plain PyTorch version, held here to both the JAX
jnp oracle and the Pallas TPU kernel run through the Pallas interpreter
(tests/conftest.py sets FASTDM_PALLAS_INTERPRET=1). Inputs come from a numpy
seed and are rounded to the working dtype identically on both sides.

Tolerances: float32, max |port - JAX| <= 1e-5 (absolute and relative);
bfloat16 elementwise ops (rmsnorm, rotembd), within 1 bf16 ulp of the JAX
value; bfloat16 attention (outputs of order 1), within 2e-3 absolute of the
jnp oracle (the probabilities are rounded at the same point; only the f32 sum
order differs, which moves a few outputs by one bf16 step) and within
1e-2 + 1e-2*|x| of the Pallas kernel (which also rounds q*scale*log2(e) to
bf16 before the product). W8A8: the int8 and fp8 quantizers (q, scale, zp)
and the int8 GEMM (s32 accumulate, azp and bias epilogue) bit-exact with the
jnp oracle, and the int8 GEMM with the Pallas kernel too; the fp8 GEMM (f32
sums in another order) within 1 bf16 ulp of |JAX| plus 2^-16 *
scale_a*scale_b * (|a| @ |b|) for outputs near zero after cancellation. The
Pallas quantizers, run by the interpreter, differ from the oracle in two
stated ways: their scale floor is 1e-8, not 1e-12 (all-zero rows), and XLA
compiles their division by 127/255/448 as a product with the reciprocal, so
a scale may sit one f32 ulp away; q (and zp) then differ by at most one step,
and only in those rows — each of their q is round(x / their own scale).

tests/test_torch_cuda_kernels.py holds the hand-written kernels themselves
to these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.kernels.jnp_backend.impl import (
    fp8_matmul_jnp,
    int8_matmul_jnp,
    quantize_to_fp8_jnp,
    quantize_to_int8_jnp,
    qk_norm_rope2_jnp,
    qk_norm_rope_jnp,
    rms_norm_jnp,
    rotary_pos_embedding_jnp,
    sdpa_gather_fine_jnp,
    sdpa_gather_jnp,
    sdpa_gather_super_jnp,
    sdpa_jnp,
    sdpa_sparse_jnp,
)
from fastdm_tpu.kernels.pallas.attention import (
    sdpa_gather_fine_pallas,
    sdpa_gather_pallas,
    sdpa_gather_super_pallas,
    sdpa_pallas,
    sdpa_sparse_pallas,
)
from fastdm_tpu.kernels.pallas.elementwise import (
    qk_norm_rope2_pallas,
    qk_norm_rope_pallas,
    quantize_to_fp8_pallas,
    quantize_to_int8_pallas,
    rms_norm_pallas,
    rotary_pos_embedding_pallas,
)
from fastdm_tpu.kernels.pallas.matmul import fp8_matmul_pallas, int8_matmul_pallas
from fastdm_tpu_torch.kernels import (
    fp8_matmul,
    gather_fine_attention,
    gather_sparse_attention,
    gather_super_attention,
    int8_matmul,
    kernel_registry,
    qk_norm_rope,
    qk_norm_rope2,
    quantize_to_fp8,
    quantize_to_int8,
    rms_norm,
    rotary_pos_embedding,
    scaled_dot_product_attention,
    sparse_scaled_dot_product_attention,
)
from fastdm_tpu_torch.models.loader import as_tensor
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a torch tensor and a JAX array of `dtype`."""
    td, jd = DTYPES[dtype]
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(td), jnp.asarray(a, jd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_close(port, ref, dtype: str):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    if dtype == "f32":
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)
    else:
        excess = np.abs(p - r) / _bf16_ulp(r)
        assert excess.max() <= 1.0, f"max {excess.max()} bf16 ulp > 1"


def _rope_tables(s: int, d: int):
    freqs = np.outer(np.arange(s), 1.0 / 10000 ** (np.arange(0, d, 2) / d))
    cos, sin = np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)
    return (torch.from_numpy(cos), torch.from_numpy(sin)), (jnp.asarray(cos), jnp.asarray(sin))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_rmsnorm_matches_jax(dtype, affine, ref):
    rng = np.random.default_rng(0)
    x_t, x_j = _pair(rng.standard_normal((2, 77, 4, 64)) * 3, dtype)
    w_t = w_j = None
    if affine:
        w_t, w_j = _pair(1 + 0.1 * rng.standard_normal(64), dtype)
    got = rms_norm(x_t, w_t, 1e-6)
    want = (rms_norm_jnp if ref == "jnp" else rms_norm_pallas)(x_j, w_j, 1e-6)
    assert got.dtype == x_t.dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("is_neox", [False, True])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_rotembd_matches_jax(dtype, is_neox, ref):
    """GQA head counts: q carries 8 heads, k 2."""
    rng = np.random.default_rng(1)
    b, s, d = 2, 77, 64
    q_t, q_j = _pair(rng.standard_normal((b, s, 8 * d)), dtype)
    k_t, k_j = _pair(rng.standard_normal((b, s, 2 * d)), dtype)
    (cos_t, sin_t), (cos_j, sin_j) = _rope_tables(s, d)
    gq, gk = rotary_pos_embedding(q_t, k_t, d, cos_t, sin_t, is_neox)
    fn = rotary_pos_embedding_jnp if ref == "jnp" else rotary_pos_embedding_pallas
    wq, wk = fn(q_j, k_j, d, cos_j, sin_j, is_neox)
    _assert_close(gq, wq, dtype)
    _assert_close(gk, wk, dtype)


SDPA_CASES = {
    # name: (batch, sq, skv, hq, hkv, d, causal)
    "dense-ragged": (2, 200, 200, 4, 4, 64, False),   # S not a multiple of 128
    "causal": (1, 160, 160, 4, 4, 32, True),
    "gqa": (1, 130, 130, 8, 2, 32, False),
    "cross-len": (1, 70, 150, 2, 2, 64, False),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_sdpa_matches_jax(dtype, case, ref):
    b, sq, skv, hq, hkv, d, causal = SDPA_CASES[case]
    rng = np.random.default_rng(2)
    q_t, q_j = _pair(rng.standard_normal((b, sq, hq * d)), dtype)
    k_t, k_j = _pair(rng.standard_normal((b, skv, hkv * d)), dtype)
    v_t, v_j = _pair(rng.standard_normal((b, skv, hkv * d)), dtype)
    got = scaled_dot_product_attention(q_t, k_t, v_t, hq, hkv, d, causal)
    fn = sdpa_jnp if ref == "jnp" else sdpa_pallas
    want = fn(q_j, k_j, v_j, hq, hkv, d, causal)
    if dtype == "f32":
        _assert_close(got, want, dtype)
    elif ref == "jnp":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-3)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


def test_dispatch_follows_device():
    """CPU tensors take the plain version, CUDA tensors the kernel; the
    comparison context routes CUDA tensors to the plain version too, for all
    ops or for the ops it names."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    w8a8 = ("quantize_to_int8", "quantize_to_fp8", "int8_matmul", "fp8_matmul")
    for op in ("rmsnorm", "rotembd", "qk_norm_rope", "qk_norm_rope2", "sdpa", "sdpa_sparse",
               "sdpa_gather", "sdpa_gather_fine", "sdpa_gather_super") + w8a8:
        assert kernel_registry.backend_for(op, cpu) == "torch"
        assert kernel_registry.backend_for(op, cuda) == "cuda"
        with kernel_registry.plain_on_device():
            assert kernel_registry.backend_for(op, cuda) == "torch"
        with kernel_registry.plain_on_device(w8a8):
            assert kernel_registry.backend_for(op, cuda) == ("torch" if op in w8a8 else "cuda")
            assert kernel_registry.backend_for(op, cpu) == "torch"
        assert kernel_registry.backend_for(op, cuda) == "cuda"
    with pytest.raises(KeyError):
        kernel_registry.select("no_such_op", cpu)


def test_sdpa_contract_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4 * 16)
    with pytest.raises(ValueError, match="contract violation"):
        scaled_dot_product_attention(q, torch.zeros(1, 8, 3 * 16), q, 4, 4, 16)
    with pytest.raises(ValueError, match="not a multiple"):
        scaled_dot_product_attention(q, torch.zeros(1, 8, 3 * 16), torch.zeros(1, 8, 3 * 16),
                                     4, 3, 16)


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    """Each CUDA source carries its header note: the Pallas function it
    replaces (for the W4A4 ops, the jnp function: they have no Pallas
    kernel), and what bounds it on the card."""
    from fastdm_tpu_torch.kernels.build import CSRC, SOURCES

    replaces = {"rmsnorm": ("rms_norm_pallas",), "rope": ("rotary_pos_embedding_pallas",),
                "qk_norm_rope": ("qk_norm_rope_pallas", "qk_norm_rope2_pallas"),
                "flash_attn": ("sdpa_pallas", "sdpa_sparse_pallas", "sdpa_gather_pallas",
                               "sdpa_gather_super_pallas", "sdpa_gather_fine_pallas"),
                "quant": ("quantize_to_int8_pallas", "quantize_to_fp8_pallas",
                          "quantize_to_int4_jnp"),
                "w8a8_gemm": ("int8_matmul_pallas", "int4_matmul_jnp"),
                "fp8_gemm": ("fp8_matmul_pallas",), "gelu_mul": ("gelu_and_mul_pallas",),
                "int4_pack": ("layers/qlinear.py unpack_int4",),
                "w4a4_gemm": ("int4_matmul_jnp", "layers/qlinear.py unpack_int4")}
    assert set(SOURCES) == set(replaces)
    for name in SOURCES:
        text = (CSRC / f"{name}.cu").read_text()
        assert all(f in text for f in replaces[name]) and "What bounds it on the H100" in text


# ------------------------------------------------------------------- W8A8


def _activations(seed: int, m: int = 77, k: int = 256):
    """bf16 rows with an all-zero row and an all-positive row (a zero point
    far from -128) among random ones."""
    a = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32) * 3
    a[3] = 0
    a[5] = np.abs(a[5]) + 1
    return _pair(a, "bf16")


def _to_np_bits(x) -> np.ndarray:
    """Exact numpy view: integers as they are, fp8 through its bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _pallas_scale_rows(scale: torch.Tensor, pallas_scale, divisor: int) -> np.ndarray:
    """Check the Pallas scales against the port's (see the module note) and
    return the mask of rows where the two are equal."""
    s, ps = scale.numpy()[:, 0], np.asarray(pallas_scale)[:, 0]
    assert s[3] == np.float32(1e-12) / np.float32(divisor)  # the all-zero row
    assert ps[3] == np.float32(1e-8) * (np.float32(1) / np.float32(divisor))
    rest = np.arange(len(s)) != 3
    assert (np.abs(s - ps)[rest] <= np.spacing(s)[rest]).all()
    return s == ps


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_quantize_to_int8_matches_jax(symmetric, ref):
    x_t, x_j = _activations(3)
    got = quantize_to_int8(x_t, symmetric)
    want = (quantize_to_int8_jnp if ref == "jnp" else quantize_to_int8_pallas)(x_j, symmetric)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    assert tuple(got[1].shape) == (77, 1) and (got[2] is None) == symmetric
    if not symmetric:
        assert got[2].dtype == torch.int32
    if ref == "jnp":
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    same = _pallas_scale_rows(got[1], want[1], 255 if not symmetric else 127)
    for g, w in zip(got, want):
        if w is not None:
            g, w = g.numpy().astype(np.int32), np.asarray(w).astype(np.int32)
            np.testing.assert_array_equal(g[same], w[same])
            assert np.abs(g - w).max() <= 1
    # Pallas's q is the oracle's formula applied to its own scale
    x32, ps = _np(x_t), np.asarray(want[1])
    zp = np.asarray(want[2]).astype(np.float32) if not symmetric else 0
    q = np.clip(np.round(x32 / ps) + zp, -128, 127)
    np.testing.assert_array_equal(q, np.asarray(want[0]))


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_quantize_to_fp8_matches_jax(ref):
    x_t, x_j = _activations(4)
    q, scale = quantize_to_fp8(x_t)
    wq, wscale = (quantize_to_fp8_jnp if ref == "jnp" else quantize_to_fp8_pallas)(x_j)
    assert q.dtype == torch.float8_e4m3fn
    if ref == "jnp":
        np.testing.assert_array_equal(_to_np_bits(q), _to_np_bits(wq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(wscale))
        return
    same = _pallas_scale_rows(scale, wscale, 448)
    np.testing.assert_array_equal(_to_np_bits(q)[same], _to_np_bits(wq)[same])
    ps = np.asarray(wscale)
    want_q = jnp.asarray(np.clip(_np(x_t) / ps, -448, 448)).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(_to_np_bits(want_q), _to_np_bits(wq))


def _gemm_operands(seed: int, quant: str, m=77, k=96, n=40):
    """A per-token quantized activation (from the jnp oracle) and a per-channel
    weight, as numpy; scales positive."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, k)) * 2, jnp.bfloat16)
    if quant == "int8":
        a, sa, azp = (np.asarray(v) for v in quantize_to_int8_jnp(x, symmetric=False))
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    else:
        a, sa = (np.asarray(v) for v in quantize_to_fp8_jnp(x))
        azp = None
        b = np.asarray(jnp.asarray(np.clip(rng.standard_normal((k, n)) * 150, -448, 448),
                                   jnp.float8_e4m3fn))
    sb = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = np.asarray(jnp.asarray(rng.standard_normal(n) * 0.1, jnp.bfloat16))
    return a, b, sa, sb, azp, bias


@pytest.mark.parametrize("azp", [True, False])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_int8_matmul_matches_jax(azp, bias, ref):
    a, b, sa, sb, zp, bi = _gemm_operands(5, "int8")
    colsum = b.astype(np.int32).sum(0)
    zp = zp if azp else None
    bi = bi if bias else None
    t = lambda v: None if v is None else as_tensor(v)  # noqa: E731
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    got = int8_matmul(t(a), t(b), t(sa), t(sb), torch.bfloat16, t(colsum), t(zp), t(bi))
    fn = int8_matmul_jnp if ref == "jnp" else int8_matmul_pallas
    want = fn(j(a), j(b), j(sa), j(sb), jnp.bfloat16, j(colsum), j(zp), j(bi))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_fp8_matmul_matches_jax(bias, ref):
    a, b, sa, sb, _, bi = _gemm_operands(6, "fp8")
    bi = bi if bias else None
    t = lambda v: None if v is None else as_tensor(v)  # noqa: E731
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    got = _np(fp8_matmul(t(a), t(b), t(sa), t(sb), torch.bfloat16, t(bi)))
    fn = fp8_matmul_jnp if ref == "jnp" else fp8_matmul_pallas
    want = _np(fn(j(a), j(b), j(sa), j(sb), jnp.bfloat16, j(bi)))
    mag = (np.abs(a.astype(np.float32)) @ np.abs(b.astype(np.float32))) * (sa * sb[None, :])
    assert (np.abs(got - want) <= _bf16_ulp(want) + 2.0**-16 * mag).all()


def test_scaled_mm_contract_rejects_bad_shapes():
    a, b = torch.zeros(4, 32, dtype=torch.int8), torch.zeros(32, 8, dtype=torch.int8)
    sa, sb, cs = torch.ones(4, 1), torch.ones(8), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="inner dims"):
        int8_matmul(a, torch.zeros(16, 8, dtype=torch.int8), sa, sb, torch.bfloat16, cs, None)
    with pytest.raises(ValueError, match="scale_b"):
        int8_matmul(a, b, sa, torch.ones(7), torch.bfloat16, cs, None)
    with pytest.raises(ValueError, match="int8 operands"):
        int8_matmul(a.float(), b, sa, sb, torch.bfloat16, cs, None)
    with pytest.raises(ValueError, match="azp"):
        int8_matmul(a, b, sa, sb, torch.bfloat16, cs, torch.zeros(3, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias"):
        fp8_matmul(a.to(torch.float8_e4m3fn), b.to(torch.float8_e4m3fn), sa, sb, torch.bfloat16,
                   torch.zeros(5))



# ------------------------------------------------------------ Wan kernels
#
# qk_norm_rope / qk_norm_rope2: f32 within 1e-5; bf16 within one bf16 ulp of
# the JAX value plus two of its rotation pair's magnitude (the normalized
# value, rounded to bf16 before the rotation, may sit one ulp away: f32 sum
# order; the rotation mixes the pair). gather_super: as sdpa above — f32 within
# 1e-5 of the jnp oracle, within 2e-2 of the Pallas kernel (which rounds
# q*scale*log2(e) to the input dtype, attention.py:838) as
# tests/test_gather_super.py holds it.


def _qk_close(port, ref, dtype: str):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    if dtype == "f32":
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)
        return
    pair = r.reshape(*r.shape[:-1], -1, 2)
    mag = np.repeat(np.linalg.norm(pair, axis=-1), 2, axis=-1).reshape(r.shape)
    assert (np.abs(p - r) <= _bf16_ulp(r) + 2 * _bf16_ulp(mag)).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["qkv-inner-dim", "qk", "two-operand"])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_qk_norm_rope_matches_jax(dtype, form, ref):
    """Full-width RMSNorm of q and k (3 heads of 32, gamma of length 96), then
    interleaved RoPE; the fused form reads q|k in place from a (B, S, 3D)
    qkv, from a (B, S, 2D) one, or q and k come as two operands."""
    rng = np.random.default_rng(4)
    b, s, hd, heads = 2, 37, 32, 3
    d = heads * hd
    x_t, x_j = _pair(rng.standard_normal((b, s, 3 * d)) * 2, dtype)
    gq_t, gq_j = _pair(1 + 0.1 * rng.standard_normal(d), dtype)
    gk_t, gk_j = _pair(1 + 0.1 * rng.standard_normal(d), dtype)
    (cos_t, sin_t), (cos_j, sin_j) = _rope_tables(s, hd)
    args_t = (gq_t, gk_t, hd, cos_t, sin_t, False, 1e-6)
    args_j = (gq_j, gk_j, hd, cos_j, sin_j, False, 1e-6)
    if form == "two-operand":
        got = qk_norm_rope2(x_t[..., :d], x_t[..., d:2 * d], *args_t)
        fn = qk_norm_rope2_jnp if ref == "jnp" else qk_norm_rope2_pallas
        want = fn(x_j[..., :d], x_j[..., d:2 * d], *args_j)
    else:
        xt, xj, inner = (x_t, x_j, d) if form == "qkv-inner-dim" else \
            (x_t[..., :2 * d], x_j[..., :2 * d], None)
        got = qk_norm_rope(xt, *args_t, inner_dim=inner)
        fn = qk_norm_rope_jnp if ref == "jnp" else qk_norm_rope_pallas
        want = fn(xj, *args_j, inner_dim=inner)
    for g, w in zip(got, want):
        assert g.dtype == x_t.dtype
        _qk_close(g, w, dtype)


def _super_tables(nq, nfine, group, sb, density, seed, full=False):
    from fastdm_tpu_torch.sparse.xsparse import super_tables_from_mask

    rng = np.random.default_rng(seed)
    m = np.ones((nq, nfine), bool) if full else rng.random((nq, nfine)) < density
    m[:, 0] = True
    return super_tables_from_mask(m, group, sb)


def _gather_pair(sq, skv, h, d, fine, bq, group, sb, density, seed, full=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, n, h * d)) for n in (sq, skv, skv))
    tables = _super_tables(-(-sq // bq), -(-skv // fine), group, sb, density, seed, full)
    kw = dict(block_q=bq, group=group, fine=fine, superblock=sb)
    got = gather_super_attention(*(_pair(a, "f32")[0] for a in (q, k, v)),
                                 *(torch.from_numpy(t) for t in tables), h, h, d, **kw)
    jargs = tuple(jnp.asarray(a, jnp.float32) for a in (q, k, v)) + tuple(
        jnp.asarray(t) for t in tables)
    return got, jargs, kw, (q, k, v)


@pytest.mark.parametrize("skv,group,sb", [(1024, 2, 4), (961, 2, 4), (1024, 4, 2), (900, 1, 8)])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_gather_super_matches_jax(skv, group, sb, ref):
    """tests/test_gather_super.py:83 on the port: random fine masks packed
    into superblock tables (ragged skv: a partial tail fine block)."""
    h, d = 2, 64
    got, jargs, kw, _ = _gather_pair(512, skv, h, d, 64, 256, group, sb, 0.4, 0)
    fn = sdpa_gather_super_jnp if ref == "jnp" else sdpa_gather_super_pallas
    want = fn(*jargs, h, h, d, **kw)
    if ref == "jnp":
        _assert_close(got, want, "f32")
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


def test_gather_super_full_tables_equal_dense():
    """tests/test_gather_super.py:121: tables that allow every key give sdpa."""
    h, d = 2, 64
    got, _, _, (q, k, v) = _gather_pair(256, 512, h, d, 64, 128, 2, 4, 1.0, 2, full=True)
    want = scaled_dot_product_attention(*(_pair(a, "f32")[0] for a in (q, k, v)), h, h, d)
    _assert_close(got, want, "f32")


@pytest.mark.parametrize("sq", [480, 300])
def test_gather_super_partial_tail_q_block(sq):
    """tests/test_gather_super.py:230: sq % block_q != 0. The tail q tile's
    row is emptied (count 0) and must give 0; the first tile matches the
    oracle (which reads every slot of a segment, not only `count` of them, so
    its tail rows keep their old entries)."""
    h, d, bq = 2, 64, 256
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((1, n, h * d)) for n in (sq, 1024, 1024))
    idx, val, rows = _super_tables(-(-sq // bq), 16, 2, 4, 0.5, 21)
    rows = rows.copy()
    rows[1, 1] = 0  # the tail q tile sees nothing
    kw = dict(block_q=bq, group=2, fine=64, superblock=4)
    got = gather_super_attention(*(_pair(a, "f32")[0] for a in (q, k, v)),
                                 *(torch.from_numpy(t) for t in (idx, val, rows)), h, h, d, **kw)
    want = sdpa_gather_super_jnp(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                                 jnp.asarray(idx), jnp.asarray(val), jnp.asarray(rows),
                                 h, h, d, **kw)
    assert tuple(got.shape) == (1, sq, h * d)
    assert not got[:, bq:].any()
    np.testing.assert_allclose(_np(got)[:, :bq], _np(want)[:, :bq], rtol=1e-5, atol=1e-5)


def test_gather_super_contract_rejects_bad_tables():
    from fastdm_tpu_torch.kernels.contracts import check_gather_super

    idx, val, rows = _super_tables(2, 16, 2, 4, 0.5, 3)
    ok = dict(sq=512, skv=1024, block_q=256, group=2, fine=64, superblock=4)
    check_gather_super("t", idx, val, rows, strict=True, **ok)
    bad = {"block_rows": (idx, val, rows[:1]), "int32": (idx.astype(np.int64), val, rows),
           "multiple of group": (idx[:-1], val[:-1], rows)}
    for msg, tables in bad.items():
        with pytest.raises(ValueError, match=msg):
            check_gather_super("t", *tables, **ok)
    wrong = {"out of range": (idx + 4, val, rows), "valbits": (idx, val + 16, rows),
             "group-aligned": (idx, val, rows + np.array([[1, 0]], np.int32))}
    for msg, tables in wrong.items():
        check_gather_super("t", *tables, **ok)  # shapes only: values are not read
        with pytest.raises(ValueError, match=msg):
            check_gather_super("t", *tables, strict=True, **ok)


# ------------------------------------------------- mask / coarse / fine modes
#
# The other three sparse ops, against the jnp oracle (f32, within 1e-5) and
# the Pallas kernel in interpret mode (within 2e-2, as gather_super above: it
# rounds q*scale*log2(e) to the input dtype). Cases: ragged skv (a partial
# last KV tile or fine block), a partial tail q tile, rows with no allowed key
# (0 out), GQA, a per-head mask, and a fine table whose entries allow only
# part of their block (interior `valid` < fine: jnp only -- the Pallas kernel
# derives validity from the global tail alone, attention.py:654-681).

# name: (batch, sq, skv, heads_q, heads_kv, block_q, block_k or fine, group, empty row)
SPARSE_OP_CASES = {
    "ragged-gqa": (1, 300, 450, 4, 2, 128, 128, 2, None),
    "tail-q-empty-row": (2, 200, 640, 2, 2, 128, 128, 2, 1),
    "wide-tiles": (1, 256, 961, 2, 2, 128, 256, 1, 0),
}


def _qkv(seed, b, sq, skv, hq, hkv, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h * d)) for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))


def _sparse_ref(fn, ref, jargs, *rest, **kw):
    """The JAX side: jnp oracle or Pallas interpreter, same numpy inputs."""
    return fn(*(jnp.asarray(a, jnp.float32) for a in jargs[:3]),
              *(jnp.asarray(a) for a in jargs[3:]), *rest, **kw)


def _check_sparse(got, want, ref, empty_rows=(), bq=None):
    if ref == "jnp":
        _assert_close(got, want, "f32")
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)
    for r in empty_rows:
        assert not got[:, r * bq:(r + 1) * bq].any()


@pytest.mark.parametrize("case", sorted(SPARSE_OP_CASES))
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_sparse_mask_matches_jax(case, ref):
    """A different random block mask per batch entry and head."""
    b, sq, skv, hq, hkv, bq, bk, _, empty = SPARSE_OP_CASES[case]
    d = 64
    q, k, v = _qkv(30, b, sq, skv, hq, hkv, d)
    ni, nj = -(-sq // bq), -(-skv // bk)
    mask = (np.random.default_rng(31).random((b, hq, ni, nj)) < 0.5).astype(np.int32)
    mask[..., 0] = 1
    mask[:, 1, -1, -1] = 1 - mask[:, 0, -1, -1]  # the heads' masks differ
    if empty is not None:
        mask[:, :, empty] = 0
    got = sparse_scaled_dot_product_attention(
        *(_pair(a, "f32")[0] for a in (q, k, v)), hq, hkv, d, sparse_mask=torch.from_numpy(mask),
        block_q=bq, block_k=bk)
    fn = sdpa_sparse_jnp if ref == "jnp" else sdpa_sparse_pallas
    want = fn(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)), hq, hkv, d,
              sparse_mask=jnp.asarray(mask), block_q=bq, block_k=bk)
    _check_sparse(got, want, ref, () if empty is None else (empty,), bq)


def test_sparse_mask_none_is_dense_sdpa():
    q, k, v = (_pair(a, "f32")[0] for a in _qkv(32, 1, 100, 130, 2, 2))
    assert torch.equal(sparse_scaled_dot_product_attention(q, k, v, 2, 2, 64),
                       scaled_dot_product_attention(q, k, v, 2, 2, 64))


def _coarse_lists(nq, nk, seed, empty=None):
    from fastdm_tpu_torch.sparse.xsparse import mask_to_block_lists

    m = np.random.default_rng(seed).random((nq, nk)) < 0.5
    m[:, -1] = True  # the ragged last KV tile
    if empty is not None:
        m[empty] = False
    idx, cnt, _ = mask_to_block_lists(m)
    return idx, cnt


@pytest.mark.parametrize("case", sorted(SPARSE_OP_CASES))
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_gather_coarse_matches_jax(case, ref):
    b, sq, skv, hq, hkv, bq, bk, _, empty = SPARSE_OP_CASES[case]
    d = 64
    q, k, v = _qkv(33, b, sq, skv, hq, hkv, d)
    idx, cnt = _coarse_lists(-(-sq // bq), -(-skv // bk), 34, empty)
    got = gather_sparse_attention(*(_pair(a, "f32")[0] for a in (q, k, v)),
                                  torch.from_numpy(idx), torch.from_numpy(cnt), hq, hkv, d,
                                  block_q=bq, block_k=bk)
    fn = sdpa_gather_jnp if ref == "jnp" else sdpa_gather_pallas
    want = _sparse_ref(fn, ref, (q, k, v, idx, cnt), hq, hkv, d, block_q=bq, block_k=bk)
    _check_sparse(got, want, ref, () if empty is None else (empty,), bq)


def _fine_tables(nq, skv, fine, group, seed, empty=None):
    from fastdm_tpu_torch.sparse.xsparse import fine_tables_from_mask

    nfine = -(-skv // fine)
    m = np.random.default_rng(seed).random((nq, nfine)) < 0.4
    m[:, -1] = True  # the partial tail fine block
    if empty is not None:
        m[empty] = False
    return fine_tables_from_mask(m, group, fine, skv)


@pytest.mark.parametrize("case", sorted(SPARSE_OP_CASES))
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_gather_fine_matches_jax(case, ref):
    b, sq, skv, hq, hkv, bq, fine, group, empty = SPARSE_OP_CASES[case]
    fine, d = 64, 64  # the Pallas kernel's group * fine must be a multiple of 128
    group = 2 * group
    q, k, v = _qkv(35, b, sq, skv, hq, hkv, d)
    tables = _fine_tables(-(-sq // bq), skv, fine, group, 36, empty)
    kw = dict(block_q=bq, group=group, fine=fine)
    got = gather_fine_attention(*(_pair(a, "f32")[0] for a in (q, k, v)),
                                *(torch.from_numpy(t) for t in tables), hq, hkv, d, **kw)
    fn = sdpa_gather_fine_jnp if ref == "jnp" else sdpa_gather_fine_pallas
    want = _sparse_ref(fn, ref, (q, k, v, *tables), hq, hkv, d, **kw)
    _check_sparse(got, want, ref, () if empty is None else (empty,), bq)


def test_gather_fine_honours_partial_interior_valid():
    """Entries whose valid count is below `fine` allow only that many tokens
    of their block, as the jnp oracle reads block_valid; with every valid
    cut to 10 the result differs from the full tables'."""
    b, sq, skv, h, d, bq, fine, group = 1, 256, 700, 2, 64, 128, 64, 4
    q, k, v = _qkv(37, b, sq, skv, h, h, d)
    idx, val, rows = _fine_tables(2, skv, fine, group, 38)
    cut = val.copy()
    cut[::3] = np.minimum(cut[::3], 10)  # padding slots stay 0
    kw = dict(block_q=bq, group=group, fine=fine)
    tq = tuple(_pair(a, "f32")[0] for a in (q, k, v))
    got = gather_fine_attention(*tq, *(torch.from_numpy(t) for t in (idx, cut, rows)), h, h, d,
                                **kw)
    want = _sparse_ref(sdpa_gather_fine_jnp, "jnp", (q, k, v, idx, cut, rows), h, h, d, **kw)
    _assert_close(got, want, "f32")
    full = gather_fine_attention(*tq, *(torch.from_numpy(t) for t in (idx, val, rows)), h, h,
                                 d, **kw)
    assert (got - full).abs().max() > 1e-2


def test_sparse_contracts_reject_bad_tables():
    from fastdm_tpu_torch.kernels import contracts

    idx, cnt = _coarse_lists(3, 4, 40)
    ok = dict(sq=300, skv=450, block_q=128, block_k=128)
    contracts.check_gather_lists("t", idx, cnt, strict=True, **ok)
    for msg, (i, c) in {"block_indices": (idx[:2], cnt), "block_counts": (idx, cnt[:2]),
                        "int32": (idx.astype(np.int64), cnt),
                        "multiples of 16": (idx, cnt)}.items():
        kw = dict(ok, block_k=100) if msg == "multiples of 16" else ok
        with pytest.raises(ValueError, match=msg):
            contracts.check_gather_lists("t", i, c, **kw)
    for msg, (i, c) in {"out of range": (idx + 4, cnt), "block_counts out": (idx, cnt + 9)}.items():
        contracts.check_gather_lists("t", i, c, **ok)  # shapes only: values are not read
        with pytest.raises(ValueError, match=msg):
            contracts.check_gather_lists("t", i, c, strict=True, **ok)

    tables = _fine_tables(2, 700, 64, 4, 41)
    ok = dict(sq=256, skv=700, block_q=128, group=4, fine=64)
    contracts.check_gather_fine("t", *tables, strict=True, **ok)
    i, val, rows = tables
    for msg, t in {"block_rows": (i, val, rows[:1]), "int32": (i, val.astype(np.int64), rows),
                   "multiple of group": (i[:-1], val[:-1], rows)}.items():
        with pytest.raises(ValueError, match=msg):
            contracts.check_gather_fine("t", *t, **ok)
    for msg, t in {"out of range": (i + 11, val, rows), "block_valid": (i, val + 65, rows),
                   "group-aligned": (i, val, rows + np.array([[1, 0]], np.int32)),
                   "exceeds": (i, val, rows + np.array([[0, 99]], np.int32))}.items():
        contracts.check_gather_fine("t", *t, **ok)
        with pytest.raises(ValueError, match=msg):
            contracts.check_gather_fine("t", *t, strict=True, **ok)

    mask = np.ones((1, 2, 3, 4), np.int32)
    ok = dict(batch=1, heads=2, sq=300, skv=450, block_q=128, block_k=128)
    contracts.check_sparse_mask("t", mask, strict=True, **ok)
    with pytest.raises(ValueError, match="retile"):
        contracts.check_sparse_mask("t", mask[:, :, :2], **ok)
    contracts.check_sparse_mask("t", mask * 2, **ok)
    with pytest.raises(ValueError, match="0 .skip. or 1"):
        contracts.check_sparse_mask("t", mask * 2, strict=True, **ok)
