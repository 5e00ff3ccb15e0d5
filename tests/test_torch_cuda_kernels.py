"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card. Marked `gpu`; without a CUDA device they skip (a CUDA kernel has no
CPU mode — tests/test_torch_kernels.py holds the plain versions to JAX here).
On a GPU machine, which needs no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu

Tolerances: rotembd bit-exact (same f32 operations, no contraction, one
rounding); rmsnorm within one bf16 ulp (rsqrt vs 1/sqrt); sdpa (f32 sums in
another order; p rounded to bf16 in both) within 1e-2 + 1e-2*|x| on the small
cases, and on the FLUX-heads case, whose outputs average 1100 keys and are
small, within 1e-3 + 2 bf16 ulp of |x| and relative L2 5e-3. The W8A8
kernels: both quantizers (q, scale, zp) and the int8 GEMM bit-exact (integer
math, correctly rounded divisions, the epilogue in the same order without
contraction); the fp8 GEMM (f32 sums in another order) within 1 bf16 ulp of
|plain| plus 2^-16 * scale_a*scale_b * (|a| @ |b|) for outputs that cancel
towards zero — about twice the random-walk rounding of a K-term f32 sum
relative to its absolute sum, and 60x under the worst case at K = 15360.
"""

import numpy as np
import pytest
import torch

SDPA_CASES = {
    # name: (batch, sq, skv, hq, hkv, d, causal)
    "dense-ragged": (2, 200, 200, 4, 4, 64, False),
    "causal": (1, 160, 160, 4, 4, 128, True),
    "gqa": (1, 130, 130, 8, 2, 128, False),
    "cross-len": (1, 70, 150, 2, 2, 64, False),
    "flux-heads": (1, 1100, 1100, 24, 24, 128, False),
}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _rope_tables(s: int, d: int, device):
    freqs = np.outer(np.arange(s), 1.0 / 10000 ** (np.arange(0, d, 2) / d))
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (hand-written CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_kernel_matches_plain_on_card(cuda_device, case):
    from fastdm_tpu_torch.kernels.cuda_backend import sdpa_cuda
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_torch

    b, sq, skv, hq, hkv, d, causal = SDPA_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    mk = lambda s, h: torch.randn(b, s, h * d, generator=g, device=cuda_device,  # noqa: E731
                                  dtype=torch.bfloat16)
    q, k, v = mk(sq, hq), mk(skv, hkv), mk(skv, hkv)
    got = sdpa_cuda(q, k, v, hq, hkv, d, causal).float()
    want = sdpa_torch(q, k, v, hq, hkv, d, causal).float()
    if case == "flux-heads":
        assert ((got - want).abs() <= 1e-3 + 2 * _bf16_ulp(want)).all()
        assert (got - want).norm() / want.norm() <= 5e-3
    else:
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend

    x = torch.zeros(2, 8, 4, 128, device=cuda_device)  # float32: the kernels take bf16
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_backend.rms_norm_cuda(x, None, 1e-6)
    q = torch.zeros(1, 8, 4 * 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_backend.sdpa_cuda(q, q, q, 4, 4, 32)


@pytest.mark.gpu
def test_launch_counters_count_launches(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend, rms_norm

    cuda_backend.reset_launch_counts()
    x = torch.ones(3, 4, 128, device=cuda_device, dtype=torch.bfloat16)
    rms_norm(x, None, 1e-6)
    rms_norm(x, None, 1e-6)
    assert cuda_backend.rms_norm_cuda.launches == 2 and cuda_backend.sdpa_cuda.launches == 0


@pytest.mark.gpu
def test_elementwise_kernels_match_plain_on_card(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(2, 100, 3 * 4 * 128, generator=g, device=cuda_device, dtype=torch.bfloat16)
    x = qkv[..., :512].reshape(2, 100, 4, 128)  # strided per-head view, as on the main path
    w = torch.rand(128, generator=g, device=cuda_device).bfloat16()
    for weight in (w, None):
        got = cuda_backend.rms_norm_cuda(x, weight, 1e-6)
        want = torch_backend.rms_norm_torch(x, weight, 1e-6)
        assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()
    cos, sin = _rope_tables(100, 128, cuda_device)
    # strided q/k views of the fused projection, GQA head counts
    gq, gk = cuda_backend.rotary_pos_embedding_cuda(
        qkv[..., :512], qkv[..., 512:768], 128, cos, sin)
    wq, wk = torch_backend.rotary_pos_embedding_torch(
        qkv[..., :512], qkv[..., 512:768], 128, cos, sin)
    torch.testing.assert_close(gq, wq, rtol=0, atol=0)
    torch.testing.assert_close(gk, wk, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="neox"):
        cuda_backend.rotary_pos_embedding_cuda(
            qkv[..., :512], qkv[..., 512:768], 128, cos, sin, is_neox=True)


# (M, K, N): a ragged size and the FLUX single-block proj_out (the longest K)
W8A8_SHAPES = {"ragged": (77, 96, 40), "proj_out": (8704, 15360, 3072)}


def _w8a8_operands(quant, m, k, n, device, bias=True):
    """A bf16 activation quantized by the plain per-token quantizer and a
    random weight quantized by quantize_weight, as qlinear_apply feeds the GEMM."""
    from fastdm_tpu_torch.kernels import torch_backend
    from fastdm_tpu_torch.layers.qlinear import quantize_weight

    g = torch.Generator(device=device).manual_seed(1)
    x = (torch.randn(m, k, generator=g, device=device) * 2).bfloat16()
    w = torch.randn(k, n, generator=g, device=device) * 0.05
    b = torch.randn(n, generator=g, device=device) * 0.1 if bias else None
    lin = quantize_weight(w, quant, b)
    if quant == "int8":
        xq, xs, xzp = torch_backend.quantize_to_int8_torch(x, symmetric=False)
    else:
        (xq, xs), xzp = torch_backend.quantize_to_fp8_torch(x), None
    return xq, xs, xzp, lin


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(W8A8_SHAPES))
@pytest.mark.parametrize("mode", ["int8-sym", "int8-asym", "fp8"])
def test_quantize_kernels_match_plain_on_card(cuda_device, shape, mode):
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, _ = W8A8_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(m, k, generator=g, device=cuda_device) * 3).bfloat16()
    x[3] = 0  # an all-zero row: the 1e-12 scale floor
    x[5] = x[5].abs() + 1  # an all-positive row: a zero point far from -128
    if mode == "fp8":
        got, want = cuda_backend.quantize_to_fp8_cuda(x), torch_backend.quantize_to_fp8_torch(x)
        got, want = (got[0].view(torch.uint8), got[1]), (want[0].view(torch.uint8), want[1])
    else:
        sym = mode == "int8-sym"
        got = cuda_backend.quantize_to_int8_cuda(x, symmetric=sym)
        want = torch_backend.quantize_to_int8_torch(x, symmetric=sym)
        assert (got[2] is None) == (want[2] is None) == sym
    for a, b in zip(got, want):
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(W8A8_SHAPES))
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_w8a8_gemm_kernels_match_plain_on_card(cuda_device, shape, quant):
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, n = W8A8_SHAPES[shape]
    for bias in (True, False) if shape == "ragged" else (True,):
        a, sa, azp, lin = _w8a8_operands(quant, m, k, n, cuda_device, bias)
        assert lin.w.stride(0) == 1  # the (K, N) view of a K-contiguous buffer
        if quant == "int8":
            for zp in (azp, None):
                args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, zp, lin.bias)
                got = cuda_backend.int8_matmul_cuda(*args)
                want = torch_backend.int8_matmul_torch(*args)
                assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        else:
            args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.bias)
            got = cuda_backend.fp8_matmul_cuda(*args).float()
            want = torch_backend.fp8_matmul_torch(*args).float()
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                mag = (a.float().abs() @ lin.w.float().abs()) * (sa * lin.scale[None, :])
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            assert ((got - want).abs() <= _bf16_ulp(want) + 2.0**-16 * mag).all()


@pytest.mark.gpu
def test_w8a8_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend

    a, sa, azp, lin = _w8a8_operands("int8", 32, 64, 48, cuda_device)
    n_contiguous = lin.w.contiguous()  # (K, N) with N contiguous: not taken
    with pytest.raises(ValueError, match="K-contiguous"):
        cuda_backend.int8_matmul_cuda(a, n_contiguous, sa, lin.scale, torch.bfloat16,
                                      lin.colsum, azp, lin.bias)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_backend.int8_matmul_cuda(a, lin.w, sa, lin.scale, torch.float32, lin.colsum, azp,
                                      lin.bias)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_backend.int8_matmul_cuda(a[:, :40], lin.w[:40], sa, lin.scale, torch.bfloat16,
                                      lin.colsum, azp, lin.bias)
    f8, _, _, lin8 = _w8a8_operands("fp8", 32, 64, 48, cuda_device)
    with pytest.raises(ValueError, match="K-contiguous"):
        cuda_backend.fp8_matmul_cuda(f8, lin8.w.contiguous(), sa, lin8.scale, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_backend.quantize_to_int8_cuda(torch.zeros(4, 12, device=cuda_device,
                                                       dtype=torch.bfloat16))


@pytest.mark.gpu
def test_qlinear_w8a8_launches_its_kernels(cuda_device):
    """One int8 and one fp8 QLinear call: one quantize and one GEMM launch each."""
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(3, 50, 128, generator=g, device=cuda_device).bfloat16()
    cuda_backend.reset_launch_counts()
    for quant in ("int8", "fp8"):
        y = qlinear_random(g, 128, 96, quant=quant, device=cuda_device)(x)
        assert y.shape == (3, 50, 96) and y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    assert (cuda_backend.quantize_to_int8_cuda.launches, cuda_backend.int8_matmul_cuda.launches,
            cuda_backend.quantize_to_fp8_cuda.launches, cuda_backend.fp8_matmul_cuda.launches) \
        == (1, 1, 1, 1)
