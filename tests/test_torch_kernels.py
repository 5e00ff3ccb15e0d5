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
bf16 before the product).

tests/test_torch_cuda_kernels.py holds the hand-written kernels themselves
to these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.kernels.jnp_backend.impl import (
    rms_norm_jnp,
    rotary_pos_embedding_jnp,
    sdpa_jnp,
)
from fastdm_tpu.kernels.pallas.attention import sdpa_pallas
from fastdm_tpu.kernels.pallas.elementwise import (
    rms_norm_pallas,
    rotary_pos_embedding_pallas,
)
from fastdm_tpu_torch.kernels import (
    kernel_registry,
    rms_norm,
    rotary_pos_embedding,
    scaled_dot_product_attention,
)

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
    comparison context routes CUDA tensors to the plain version too."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for op in ("rmsnorm", "rotembd", "sdpa"):
        assert kernel_registry.backend_for(op, cpu) == "torch"
        assert kernel_registry.backend_for(op, cuda) == "cuda"
        with kernel_registry.plain_on_device():
            assert kernel_registry.backend_for(op, cuda) == "torch"
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
    replaces, and what bounds it on the card."""
    from fastdm_tpu_torch.kernels.build import CSRC, SOURCES

    replaces = {"rmsnorm": "rms_norm_pallas", "rope": "rotary_pos_embedding_pallas",
                "flash_attn": "sdpa_pallas"}
    for name in SOURCES:
        text = (CSRC / f"{name}.cu").read_text()
        assert replaces[name] in text and "What bounds it on the H100" in text
