"""The port's W4A4 linear op (w4a4_linear: int4_matmul, the int4p unpack and
the SVDQuant low-rank branch as one op, fastdm_tpu/layers/qlinear.py:280-291)
against the JAX package's composition on the CPU, where the op takes its
plain version. The same numpy-seeded operands go to both: int4 activations
and their per-token scales, int4 weights (unpacked, or packed in each
package's own halves layout), per-channel scales, a bias, xu = bf16(x) @
lora_u and lora_v.

JAX's side runs op by op (jax.disable_jit): jitted, XLA contracts
int4_matmul_jnp's epilogue product and bias add into one FMA and rounds once
where the written code, and the port, round twice (one bf16 ulp in a few
elements in 10^4 with a bias). Tolerances: with lora_v = 0, bit-exact (the s32
product is exact on both sides and the epilogue rounds in the same order);
otherwise within one bf16
ulp of the output plus one bf16 ulp of the low-rank term: XLA and PyTorch
sum the rank-32 product's f32 terms in different orders, so the rounded term
may differ by one ulp, and the add's rounding by one more of the output. The
host side of the CUDA wrappers (which entry, which pitches) is in
tests/test_torch_tma_geometry.py; the kernels against this plain version in
tests/test_torch_cuda_kernels.py (on the card).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.kernels.jnp_backend import impl as jimpl
from fastdm_tpu.layers import qlinear as jql
from fastdm_tpu_torch.kernels import int4_matmul, kernel_registry, w4a4_linear
from fastdm_tpu_torch.kernels.cuda_backend import W4A4_SMALL_M_MAX, w4a4_small_m
from fastdm_tpu_torch.kernels.torch_backend import w4a4_linear_torch
from fastdm_tpu_torch.layers import qlinear as tql

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

K, N, RANK = 160, 200, 32  # K a multiple of 32 but not of 128; N not a multiple of 128


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, back in f32 (exact in both packages)."""
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _operands(seed: int, m: int, bias: bool, zero_lora: bool):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-8, 8, (m, K)).astype(np.int8)
    xq[0] = 0  # an all-zero row (the quantizer's 1e-12 scale floor)
    xs = (rng.random((m, 1)) * 0.5 + 1e-3).astype(np.float32)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    scale = (rng.random(N) * 0.01 + 1e-4).astype(np.float32)
    b = _bf16(rng.standard_normal(N) * 0.5) if bias else None
    xu = _bf16(rng.standard_normal((m, RANK)))
    lora_v = np.zeros((RANK, N), np.float32) if zero_lora else _bf16(
        rng.standard_normal((RANK, N)) * 0.3)
    return xq, xs, q, scale, b, xu, lora_v


def _jax(xq, xs, q, scale, b, xu, lora_v, packed: bool) -> np.ndarray:
    """JAX's W4A4 branch from xq on, op by op: the unpack of its own packed
    layout, int4_matmul, the bf16 low-rank product and the add."""
    with jax.disable_jit():
        w = jql.unpack_int4(jql.pack_int4(jnp.asarray(q))) if packed else jnp.asarray(q)
        out = jimpl.int4_matmul_jnp(jnp.asarray(xq), w, jnp.asarray(xs), jnp.asarray(scale),
                                    jnp.bfloat16,
                                    None if b is None else jnp.asarray(b, jnp.bfloat16))
        low = jnp.asarray(xu, jnp.bfloat16) @ jnp.asarray(lora_v, jnp.bfloat16)
        return np.asarray((out + low.astype(out.dtype)).astype(jnp.float32))


def _port(xq, xs, q, scale, b, xu, lora_v, packed: bool) -> torch.Tensor:
    qt = torch.from_numpy(q)
    w = tql.pack_int4(tql.k_contiguous(qt)) if packed else qt
    return w4a4_linear(torch.from_numpy(xq), w, torch.from_numpy(xs), torch.from_numpy(scale),
                       torch.bfloat16, None if b is None else torch.from_numpy(b).bfloat16(),
                       torch.from_numpy(xu).bfloat16(), torch.from_numpy(lora_v).bfloat16())


def _ulp(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


@pytest.mark.parametrize("m", [1, 30, 65, 200])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("zero_lora", [True, False])
def test_w4a4_linear_matches_jax_composition(m, bias, packed, zero_lora):
    ops = _operands(10 * m + 2 * bias + packed, m, bias, zero_lora)
    want = _jax(*ops, packed)
    got = _port(*ops, packed)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, N)
    got = got.float().numpy()
    if zero_lora:
        np.testing.assert_array_equal(got, want)
    else:
        xu, lora_v = ops[5], ops[6]
        low = xu.astype(np.float64) @ lora_v.astype(np.float64)
        excess = np.abs(got - want) - (_ulp(want) + _ulp(low))
        assert excess.max() <= 0, excess.max()
        assert np.isfinite(got).all() and np.abs(low).max() > 1  # the branch is not negligible


def test_w4a4_linear_packed_equals_unpacked_and_dispatches_by_device():
    """The packed and the unpacked weight give one result bit for bit (the
    shape tells them apart); CPU tensors take the plain version, CUDA
    tensors the kernels, and the comparison context the plain version."""
    ops = _operands(3, 37, True, False)
    assert torch.equal(_port(*ops, True), _port(*ops, False))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert kernel_registry.backend_for("w4a4_linear", cpu) == "torch"
    assert kernel_registry.backend_for("w4a4_linear", cuda) == "cuda"
    with kernel_registry.plain_on_device(("quantize_to_int4", "w4a4_linear")):
        assert kernel_registry.backend_for("w4a4_linear", cuda) == "torch"
    assert kernel_registry.select("w4a4_linear", cpu) is w4a4_linear_torch


def test_w4a4_linear_contract_rejects_bad_operands():
    ops = _operands(4, 5, False, False)
    xq, xs, q, scale = (torch.from_numpy(a) for a in ops[:4])
    xu, lora_v = (torch.from_numpy(a).bfloat16() for a in ops[5:])
    with pytest.raises(ValueError, match="packed pairs"):
        w4a4_linear(xq, q[:K // 2 + 1], xs, scale, torch.bfloat16, None, xu, lora_v)
    with pytest.raises(ValueError, match="low-rank branch"):
        w4a4_linear(xq, q, xs, scale, torch.bfloat16, None, xu[:, :16], lora_v)
    with pytest.raises(ValueError, match="low-rank branch"):
        w4a4_linear(xq, q, xs, scale, torch.bfloat16, None, xu[:4], lora_v)
    with pytest.raises(ValueError, match="int8"):
        w4a4_linear(xq.float(), q, xs, scale, torch.bfloat16, None, xu, lora_v)
    with pytest.raises(ValueError, match="bias size"):
        w4a4_linear(xq, q, xs, scale, torch.bfloat16, torch.zeros(3), xu, lora_v)


@pytest.mark.parametrize("m,k,small", [(1, 3072, True), (30, 3072, True), (60, 12288, True),
                                       (W4A4_SMALL_M_MAX, 15360, True),
                                       (W4A4_SMALL_M_MAX + 1, 3072, False), (512, 3072, False),
                                       (1, 144, False), (1, 160, True)])
def test_w4a4_small_m_rule(m, k, small):
    """The small-M entry takes a packed weight up to W4A4_SMALL_M_MAX rows
    when K is a multiple of 32 (its 16-byte packed loads)."""
    assert w4a4_small_m(m, k) == small


def test_qlinear_w4a4_goes_through_the_op(monkeypatch):
    """An int4 / int4p QLinear's call is quantize_to_int4, the (M, r) low-rank
    product and one w4a4_linear with the stored weight (packed for int4p);
    the result equals the composition it replaces bit for bit."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 9, 96, generator=g).bfloat16()
    seen = []
    real = tql.w4a4_linear

    def spy(a, b, *args):
        seen.append(tuple(b.shape))
        return real(a, b, *args)

    monkeypatch.setattr(tql, "w4a4_linear", spy)
    for quant in ("int4", "int4p"):
        lin = tql.qlinear_random(g, 96, 40, quant=quant, device="cpu")
        y = lin(x)
        w = lin.w4 if quant == "int4" else tql.unpack_int4(lin.w4p)
        xq, xs = tql.quantize_to_int4(x.reshape(-1, 96))
        ref = int4_matmul(xq, w, xs, lin.scale, torch.bfloat16, lin.bias)
        ref = ref + ((x.reshape(-1, 96) @ lin.lora_u) @ lin.lora_v).to(ref.dtype)
        assert torch.equal(y, ref.reshape(2, 9, 40))
    assert seen == [(96, 40), (48, 40)]
