"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card. Marked `gpu`; without a CUDA device they skip (a CUDA kernel has no
CPU mode — tests/test_torch_kernels.py holds the plain versions to JAX here).
On a GPU machine, which needs no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu

Tolerances: rotembd bit-exact (same f32 operations, no contraction, one
rounding); rmsnorm within one bf16 ulp (rsqrt vs 1/sqrt); sdpa (f32 sums in
another order; p rounded to bf16 in both) within 1e-2 + 1e-2*|x| on the small
cases, and on the FLUX-heads case, whose outputs average 1100 keys and are
small, within 1e-3 + 2 bf16 ulp of |x| and relative L2 5e-3.
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
