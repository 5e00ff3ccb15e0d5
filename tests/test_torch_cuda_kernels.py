"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card. Marked `gpu`; without a CUDA device they skip (a CUDA kernel has no
CPU mode — tests/test_torch_kernels.py holds the plain versions to JAX here).
On a GPU machine, which needs no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu

Tolerances: rotembd bit-exact in both pair layouts (same f32 operations, no
contraction, one rounding); rmsnorm within one bf16 ulp (rsqrt vs 1/sqrt, f32
sums in another order) on each of its kernel's paths; sdpa (f32 sums in
another order; p rounded to bf16 in both) within 1e-2 + 1e-2*|x| on the small
cases (ragged, causal with sq < skv, GQA, 77 and 512 keys, q|k|v slices of
one fused projection at D 64, a softmax scale <= 0), and on the FLUX-heads,
Wan-dense and Wan5B self-attention cases, whose outputs average 1100, 32760
and 17856 keys and are small, within 1e-3 + 2 bf16 ulp of |x| and relative
L2 5e-3. The W8A8
kernels: both quantizers (q, scale, zp) and the int8 GEMM bit-exact (integer
math, correctly rounded divisions, the epilogue in the same order without
contraction); the fp8 GEMM (f32 sums in another order) within 1 bf16 ulp of
|plain| plus 2^-16 * scale_a*scale_b * (|a| @ |b|) for outputs that cancel
towards zero — about twice the random-walk rounding of a K-term f32 sum
relative to its absolute sum, and 60x under the worst case at K = 15360.
The W4A4 kernels: the int4 quantizer (q, scale), the int4 GEMM and the int4p
unpack bit-exact (integer math, correctly rounded divisions, the epilogue in
the same order; the unpack moves bits); both entries of the W4A4 linear
(w4a4_gemm.cu) bit-exact with lora_v = 0 and otherwise within one bf16 ulp of
the output plus one of the low-rank term (its rank-32 f32 sum in another
order than cuBLAS's, whose bf16 reductions are turned off for the plain
version). The Wan kernels: qk_norm_rope /
qk_norm_rope2 within one bf16 ulp of the value plus two of its rotation
pair's magnitude (the normalized value may sit one ulp away before the
bit-exact rotation mixes the pair), in both pair layouts, and the fused and
two-operand forms bit-identical, at widths on and off the kernel's fast path
and with bf16, f32 or no norm weights; gather_super as sdpa's FLUX-heads
case, the other three sparse-attention walks (gather_fine, gather_coarse,
sparse_mask) as sdpa's small cases plus relative L2 5e-3 (see
_close_to_plain); on tables that allow every key, all four walks, which run on
sdpa's kernel, bit-identical to sdpa_cuda (the same tiles in the same order
through the same tile code). The SDXL kernels: gelu_and_mul within one bf16 ulp of its
plain version (both round once from f32; erff and ATen's erf may differ by an
f32 ulp), in f32 within 1e-6 relative plus |h*g| * 2^-22; sdpa at head dim 64
on the fused projections as the small cases. The ControlNet / IP-Adapter
shapes: sdpa on 4 and 16 IP keys and the Plus resampler's 16 x 273 as the
small cases, on the union ControlNet's 8705-token joint sequence as the long
ones; rotembd bit-exact, rmsnorm within one ulp and the int8 quantizer and
GEMM bit-exact at its 8705 and 513 rows. Wan2.1-I2V's image branch at batch 1
and 2: sdpa against 257 image keys as the small cases plus relative L2 5e-3,
the int8 quantizer and GEMM at M = 257 / 514 bit-exact, rmsnorm within one
ulp. Qwen-Image-Edit's text stream from the Qwen2.5-VL encoder (1396 tokens
before 4096 + 4096 image tokens) at batch 1 and 2: rmsnorm within one ulp,
rotembd bit-exact, sdpa as the long cases, the W4A4 kernels bit-exact at
M = 1396 * batch; Qwen2.5-VL-7B's widths at two layers on the card within
relative L2 1e-4 of the CPU, launching no kernel. The log-sum-exp variant of
sdpa: its output bit-identical to the sdpa kernel's, its f32 log-sum-exp
within 1e-3 absolute of the plain version's; the ring over 2 and 4 virtual
ranks (bf16 block outputs merged in f32: one more bf16 rounding a step) within
2e-3 + 2 bf16 ulp of |x| of one sdpa kernel call. The tensor-parallel
variants: the quantizer's statistics pass and its given-statistics modes
bit-exact with their plain versions and, on column shards with MAX-reduced
statistics, with the one-device quantizer; the int8 / int4 f32 partials
bit-exact, the fp8 one within 2^-14 of sum |a| |b| (no bf16 rounding hides
the fp8 wgmma's ~14-bit step sums there); two shards' partials
summed within 1 bf16 ulp of the one-device GEMM plus the f32 roundings of the
partials; rms_sumsq within 1e-5 relative, rms_norm_given within one ulp and
the qk_norm_rope*_given forms within the qk_norm_rope tolerance; full-width
FLUX blocks over 2 virtual tp ranks within relative L2 1e-2. Training over
a mesh: sdpa and sdpa_lse at head dims 32 and 96 (zero-padded to 64 / 128)
as the small cases, the log-sum-exp within 1e-3; the ring's gradients over 2
and 4 virtual ranks (sdpa_lse blocks, the ring-attention backward) within
relative L2 1e-2 of SDPAFn on the whole sequence; a virtual-tp training step
over two threads finishes with finite, bit-equal losses.
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
    "sdxl-cross": (2, 300, 77, 20, 20, 64, False),
    "causal-cross-len": (1, 100, 300, 4, 2, 64, True),
    "fused-d64": (2, 333, 333, 10, 10, 64, False),
    # Wan2.2-A14B's dense self-attention at 480x832x81: 255 KV tiles of 128
    # and a tail of 120 through the ring
    "wan-dense": (1, 32760, 32760, 40, 40, 128, False),
    # Wan2.2-TI2V-5B at 768x768x121: self-attention on 17856 tokens (139
    # tiles of 128 and a tail of 64), cross-attention on the 512 text keys
    "wan5b-self": (1, 17856, 17856, 24, 24, 128, False),
    "wan5b-cross": (1, 17856, 512, 24, 24, 128, False),
}
# cases whose outputs average many keys, held as FLUX's
LONG_SDPA_CASES = {"flux-heads", "wan-dense", "wan5b-self"}
# cases whose q|k|v are column slices of one fused (B, S, (hq + 2 hkv) * d) projection
FUSED_SDPA_CASES = {"fused-d64"}


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
    if case in FUSED_SDPA_CASES:
        qkv = mk(sq, hq + 2 * hkv)
        q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    else:
        q, k, v = mk(sq, hq), mk(skv, hkv), mk(skv, hkv)
    got = sdpa_cuda(q, k, v, hq, hkv, d, causal).float()
    want = sdpa_torch(q, k, v, hq, hkv, d, causal).float()
    if case in LONG_SDPA_CASES:
        assert ((got - want).abs() <= 1e-3 + 2 * _bf16_ulp(want)).all()
        assert (got - want).norm() / want.norm() <= 5e-3
    else:
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


# sdpa_lse: (batch, sq, skv, hq, hkv, d, scale); the FLUX joint 8704 tokens cut
# to a quarter (one ring shard), Wan's 32760 / 4 = 8190-row shard, ragged and
# GQA / D = 64 / cross lengths, a scale <= 0
LSE_CASES = {
    "flux-shard": (1, 2176, 2176, 24, 24, 128, None),
    "wan-shard": (1, 8190, 8190, 40, 40, 128, None),
    "gqa-ragged": (2, 200, 333, 8, 2, 128, None),
    "d64": (1, 130, 70, 4, 4, 64, None),
    "negative-scale": (1, 100, 300, 4, 2, 64, -0.3),
}
LSE_TOL = 1e-3  # absolute, on the f32 log-sum-exp


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_sdpa_lse_kernel_matches_plain_on_card(cuda_device, case):
    """The log-sum-exp variant: its output bit for bit the sdpa kernel's (the
    same kernel, one more store), its f32 log-sum-exp within LSE_TOL of the
    plain version's, one launch counted on its own wrapper."""
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_lse_torch

    b, sq, skv, hq, hkv, d, scale = LSE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(b, s, h * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    cuda_backend.reset_launch_counts()
    out, lse = cuda_backend.sdpa_lse_cuda(q, k, v, hq, hkv, d, scale)
    assert cuda_backend.sdpa_lse_cuda.launches == 1 and cuda_backend.sdpa_cuda.launches == 0
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    assert torch.equal(out, cuda_backend.sdpa_cuda(q, k, v, hq, hkv, d, False, scale))
    want_out, want_lse = sdpa_lse_torch(q, k, v, hq, hkv, d, scale)
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    got, want = out.float(), want_out.float()
    if sq > 1000:
        assert ((got - want).abs() <= 1e-3 + 2 * _bf16_ulp(want)).all()
    else:
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_virtual_ring_matches_sdpa_kernel_on_card(cuda_device, n):
    """sdpa_ring over n virtual ranks in one process (self-attention with
    GQA, cross-attention, a length n does not divide) against one sdpa
    kernel call; n * n log-sum-exp launches per self-attention call."""
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.parallel.context_parallel import VirtualRing, sdpa_ring

    g = torch.Generator(device=cuda_device).manual_seed(6)
    mk = lambda s, h, d=128: torch.randn(1, s, h * d, generator=g,  # noqa: E731
                                         device=cuda_device, dtype=torch.bfloat16)
    for sq, skv, hq, hkv in ((4096, 4096, 8, 2), (1024, 333, 4, 4), (1001, 1001, 4, 4)):
        q, k, v = mk(sq, hq), mk(skv, hkv), mk(skv, hkv)
        cuda_backend.reset_launch_counts()
        got = sdpa_ring(q, k, v, hq, hkv, 128, ring=VirtualRing(n)).float()
        counts = (cuda_backend.sdpa_lse_cuda.launches, cuda_backend.sdpa_cuda.launches)
        assert counts == ((n * n, 0) if sq == skv and sq % n == 0 else (0, n if sq % n == 0
                                                                         else 1))
        want = cuda_backend.sdpa_cuda(q, k, v, hq, hkv, 128).float()
        assert ((got - want).abs() <= 2e-3 + 2 * _bf16_ulp(want)).all()


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend

    x = torch.zeros(2, 8, 4, 128, device=cuda_device)  # float32: the kernels take bf16
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_backend.rms_norm_cuda(x, None, 1e-6)
    # head dims under 128 run zero-padded to 64 / 128; wider ones the kernel does not take
    q = torch.zeros(1, 8, 4 * 160, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_backend.sdpa_cuda(q, q, q, 4, 4, 160)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_sdpa_kernel_takes_any_scale_on_card(cuda_device, scale, d):
    """A softmax scale <= 0 (the plain version and the JAX op take any): a
    negative one weights the smallest logits most, 0 averages the visible
    keys; causal with sq < skv and GQA, so masked keys must stay out."""
    from fastdm_tpu_torch.kernels.cuda_backend import sdpa_cuda
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_torch

    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(1, s, h * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
               for s, h in ((100, 4), (300, 2), (300, 2)))
    got = sdpa_cuda(q, k, v, 4, 2, d, True, scale).float()
    want = sdpa_torch(q, k, v, 4, 2, d, True, scale).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


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
    # the half-split (neox) layout on the same strided views, bit-exact too
    gq, gk = cuda_backend.rotary_pos_embedding_cuda(
        qkv[..., :512], qkv[..., 512:768], 128, cos, sin, is_neox=True)
    wq, wk = torch_backend.rotary_pos_embedding_torch(
        qkv[..., :512], qkv[..., 512:768], 128, cos, sin, is_neox=True)
    torch.testing.assert_close(gq, wq, rtol=0, atol=0)
    torch.testing.assert_close(gk, wk, rtol=0, atol=0)


# name: (x's shape as a view, (buffer shape, slice of its last dim), path of
# csrc/rmsnorm.cu): strided per-head views of a fused QKV output at head dims
# 128 and 64 (head rows), a Wan2.2-A14B q row and a column slice of its kv
# projection at 5120 and a 3072 row (wide rows), a 130-wide row and a 128-wide
# row at a 4-byte offset (tail)
RMS_CASES = {
    "heads128-strided": ((2, 100, 24, 128), ((2, 100, 3 * 24 * 128), 0), 0),
    "heads64-strided": ((1, 77, 6, 64), ((1, 77, 3 * 6 * 64), 0), 0),
    "wan-5120": ((1, 300, 5120), ((1, 300, 5120), 0), 1),
    "wan-k-5120-slice": ((1, 77, 5120), ((1, 77, 2 * 5120), 0), 1),
    "wide-3072": ((3, 50, 3072), ((3, 50, 3072), 0), 1),
    "tail-130": ((2, 40, 4, 130), ((2, 40, 4 * 130), 0), 2),
    "tail-offset": ((5, 128), ((5, 3 * 128 + 8), 2), 2),
}


def _rms_input(case, g, device):
    shape, (buf, off), _ = RMS_CASES[case]
    x = torch.randn(*buf, generator=g, device=device) * 2
    n = 1
    for v in shape[len(buf) - 1:]:
        n *= v
    return x.bfloat16()[..., off:off + n].reshape(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RMS_CASES))
@pytest.mark.parametrize("gamma", [torch.bfloat16, torch.float32, None])
def test_rmsnorm_kernel_paths_match_plain_on_card(cuda_device, case, gamma):
    """Each path of csrc/rmsnorm.cu (the plan the wrapper picks is asserted)
    within one bf16 ulp of the plain version, with the weight in bf16, in f32
    or absent; strided views are read in place, one launch per call."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = _rms_input(case, g, cuda_device)
    d = x.shape[-1]
    w = None if gamma is None else (1 + 0.1 * torch.randn(d, generator=g,
                                                          device=cuda_device)).to(gamma)
    plans = []
    plan = cuda_backend.rms_norm_plan
    cuda_backend.reset_launch_counts()
    try:
        cuda_backend.rms_norm_plan = lambda *a: plans.append(plan(*a)) or plans[-1]
        got = cuda_backend.rms_norm_cuda(x, w, 1e-6)
    finally:
        cuda_backend.rms_norm_plan = plan
    want = torch_backend.rms_norm_torch(x, w, 1e-6)
    assert plans[0][0] == RMS_CASES[case][2]
    assert got.shape == x.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()
    assert cuda_backend.rms_norm_cuda.launches == 1


@pytest.mark.gpu
def test_rmsnorm_kernel_takes_empty_input_and_launches_no_weight_cast(cuda_device):
    """An empty input gives an empty output and no launch; a bf16 or f32
    weight reaches the kernel as it is: one device kernel per call, the
    rmsnorm one (no cast kernel before it)."""
    from torch.profiler import ProfilerActivity, profile

    from fastdm_tpu_torch.kernels import cuda_backend

    cuda_backend.reset_launch_counts()
    empty = cuda_backend.rms_norm_cuda(torch.zeros(0, 24, 128, device=cuda_device,
                                                   dtype=torch.bfloat16), None, 1e-6)
    assert empty.shape == (0, 24, 128) and cuda_backend.rms_norm_cuda.launches == 0
    x = torch.randn(1, 64, 24, 128, device=cuda_device).bfloat16()
    for dtype in (torch.bfloat16, torch.float32):
        w = torch.ones(128, device=cuda_device, dtype=dtype)
        cuda_backend.rms_norm_cuda(x, w, 1e-6)  # built and loaded before the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cuda_backend.rms_norm_cuda(x, w, 1e-6)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        assert len(kernels) == 1 and "rms_norm" in kernels[0], (dtype, kernels)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cuda_backend.rms_norm_cuda(x, torch.ones(128, device=cuda_device).half(), 1e-6)


# name: (batch, seq, q heads, kv heads, head_dim, view): GQA head counts on
# q|k column slices of one fused projection ("fused"), separate tensors
# ("separate"), or slices at a 4-byte offset ("offset", the tail path); head
# dims 128 and 64 (vector path in both layouts), 24 (half-split: not a
# multiple of 16, the tail path) and 6 (the tail path in both)
ROPE_CASES = {
    "gqa-fused-128": (2, 77, 8, 2, 128, "fused"),
    "flux-heads-128": (1, 300, 24, 24, 128, "separate"),
    "gqa-fused-64": (2, 50, 10, 5, 64, "fused"),
    "hd24": (1, 33, 3, 1, 24, "fused"),
    "tail-hd6": (2, 20, 3, 2, 6, "separate"),
    "offset-128": (1, 40, 4, 2, 128, "offset"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ROPE_CASES))
@pytest.mark.parametrize("is_neox", [False, True])
def test_rotembd_kernel_layouts_match_plain_on_card(cuda_device, case, is_neox):
    """Both pair layouts bit-exact with the plain version, on the vector path
    and the tail path (the plan the wrapper picks is asserted)."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    b, s, hq, hkv, d, view = ROPE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(6)
    mk = lambda *shape: torch.randn(*shape, generator=g,  # noqa: E731
                                    device=cuda_device).bfloat16()
    if view == "separate":
        q, k = mk(b, s, hq * d), mk(b, s, hkv * d)
    else:
        off = 2 if view == "offset" else 0  # 2 bf16: 4-byte aligned rows, not 16
        buf = mk(b, s, (hq + 2 * hkv) * d + 2 * off)
        q, k = buf[..., off:off + hq * d], buf[..., off + hq * d:off + (hq + hkv) * d]
    cos, sin = _rope_tables(s, d, cuda_device)
    plans = []
    plan = cuda_backend.rope_plan
    try:
        cuda_backend.rope_plan = lambda *a: plans.append(plan(*a)) or plans[-1]
        got = cuda_backend.rotary_pos_embedding_cuda(q, k, d, cos, sin, is_neox)
    finally:
        cuda_backend.rope_plan = plan
    tail = view == "offset" or d % (16 if is_neox else 8) != 0
    assert plans[0][0] == (cuda_backend.ROPE_TAIL if tail else cuda_backend.ROPE_VECTOR)
    want = torch_backend.rotary_pos_embedding_torch(q, k, d, cos, sin, is_neox)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.is_contiguous() and torch.equal(a, w)


# (M, K, N): a ragged size and the FLUX single-block proj_out (the longest K)
W8A8_SHAPES = {"ragged": (77, 96, 40), "proj_out": (8704, 15360, 3072)}
# the GEMMs also at SDXL's shortest row counts: the time embedding (M = batch
# 2) and the text K/V projection (M = 2 x 77)
W8A8_GEMM_SHAPES = {**W8A8_SHAPES, "sdxl-temb": (2, 1280, 640), "sdxl-text": (154, 2048, 1280)}
# the int8 GEMM's edges, at both of its tile shapes: K tails that are not
# multiples of the 128-byte stage (48, 80 and SDXL's 640), one and ragged row
# counts (M = 1, 77, 154, 193), N not a multiple of either tile's width, a
# Wan2.2-A14B FFN width (K 5120 -> N 13824 on a 32760-token chunk's rows), and
# SD3.5-medium's edges: proj_out's N = 64 (under one tile), the int8 norm_out
# modulation at M = 2 (one row per CFG image) and the context stream's
# M = 2 x 333 rows at K = 1536 and 6144
INT8_GEMM_EDGES = {"k48-m1": (1, 48, 40), "k80-m77": (77, 80, 300),
                   "sdxl-k640-m154": (154, 640, 1920), "k640-m193": (193, 640, 1000),
                   "wan-ffn": (4095, 5120, 13824), "sd35-proj-out-n64": (16384, 1536, 64),
                   "sd35-norm-out-m2": (2, 1536, 3072), "sd35-ctx-m666": (666, 1536, 4608),
                   "sd35-ctx-ff-m666": (666, 6144, 1536)}


@pytest.mark.gpu
@pytest.mark.parametrize("c", [640, 1280])
def test_sdpa_kernel_on_sdxl_fused_projections(cuda_device, c):
    """SDXL's attentions at head dim 64: self-attention q|k|v read in place
    from the fused (B, S, 3C) projection, cross-attention k|v from the fused
    (B, 77, 2C) one (a 13-key tail tile), held as the small cases."""
    from fastdm_tpu_torch.kernels.cuda_backend import sdpa_cuda
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_torch

    g = torch.Generator(device=cuda_device).manual_seed(1)
    h = c // 64
    qkv = torch.randn(2, 333, 3 * c, generator=g, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.randn(2, 77, 2 * c, generator=g, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    for kk, vv in ((k, v), (kv[..., :c], kv[..., c:])):
        got = sdpa_cuda(q, kk, vv, h, h, 64, False).float()
        want = sdpa_torch(q, kk, vv, h, h, 64, False).float()
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_sdpa_kernel_on_sd35_joint_layout(cuda_device):
    """SD3.5's joint attention at head dim 64: 333 context tokens first, then
    a 640-token image stream (973 = 7 tiles of 128 and a 77-token tail), q
    and k concatenated from the per-head-normalized streams, v from column
    slices of the fused projections; and attn2's image self-attention with
    q|k|v read in place from one (B, S, 3C) projection. Held as the small
    cases."""
    from fastdm_tpu_torch.kernels.cuda_backend import sdpa_cuda
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_torch

    g = torch.Generator(device=cuda_device).manual_seed(4)
    c, h = 1536, 24
    img = torch.randn(2, 640, 3 * c, generator=g, device=cuda_device, dtype=torch.bfloat16)
    ctx = torch.randn(2, 333, 3 * c, generator=g, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = (torch.cat([ctx[..., i * c:(i + 1) * c], img[..., i * c:(i + 1) * c]], dim=1)
               for i in range(3))
    assert q.shape[1] % 128 == 77
    for args in ((q, k, v), (img[..., :c], img[..., c:2 * c], img[..., 2 * c:])):
        got = sdpa_cuda(*args, h, h, 64, False).float()
        want = sdpa_torch(*args, h, h, 64, False).float()
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_and_mul_kernel_matches_plain_on_card(cuda_device, dtype):
    """A ragged row count (3 x 333 rows), a column slice of a wider tensor
    read in place (16-byte aligned: vector path) and one that is not (scalar
    path). Both round once from f32; erff and ATen's erf may differ by an f32
    ulp, so bf16 is held within one bf16 ulp of the plain version and f32
    within 1e-6 relative plus |h*g| * 2^-22 (1 + erf cancels in the far
    negative tail)."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    g = torch.Generator(device=cuda_device).manual_seed(3)
    d = 1280
    x = torch.randn(3, 333, 2 * d, generator=g, device=cuda_device) * 3
    wide = torch.randn(2, 77, 2 * d + 24, generator=g, device=cuda_device) * 3
    cuda_backend.reset_launch_counts()
    for a in (x, wide[..., 8:8 + 2 * d], wide[..., 1:1 + 2 * d]):
        a = a.to(dtype)
        got, want = cuda_backend.gelu_and_mul_cuda(a).float(), torch_backend.gelu_and_mul_torch(a)
        assert got.shape == want.shape == (*a.shape[:-1], d)
        want = want.float()
        e = (got - want).abs()
        if dtype == torch.bfloat16:
            assert (e <= _bf16_ulp(want)).all()
        else:
            hg = (a[..., :d].float() * a[..., d:].float()).abs()
            assert (e <= 1e-6 * want.abs() + hg * 2.0**-22).all()
    assert cuda_backend.gelu_and_mul_cuda.launches == 3


@pytest.mark.gpu
def test_gelu_and_mul_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend

    with pytest.raises(ValueError, match="even"):
        cuda_backend.gelu_and_mul_cuda(torch.zeros(4, 7, device=cuda_device))
    with pytest.raises(ValueError, match="dtype"):
        cuda_backend.gelu_and_mul_cuda(torch.zeros(4, 8, device=cuda_device,
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_backend.gelu_and_mul_cuda(torch.zeros(4, 8, dtype=torch.bfloat16))


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
@pytest.mark.parametrize("shape", sorted(W8A8_GEMM_SHAPES))
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_w8a8_gemm_kernels_match_plain_on_card(cuda_device, shape, quant):
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, n = W8A8_GEMM_SHAPES[shape]
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
@pytest.mark.parametrize("shape", sorted(INT8_GEMM_EDGES))
def test_int8_gemm_edges_bit_exact_on_card(cuda_device, shape):
    """The wgmma + TMA int8 GEMM, with and without azp and bias, and on a strided `a` (a column slice of a wider activation, 16-
    byte aligned rows): bit-exact with the plain version."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, n = INT8_GEMM_EDGES[shape]
    cuda_backend.reset_launch_counts()
    for bias in (True, False):
        a, sa, azp, lin = _w8a8_operands("int8", m, k, n, cuda_device, bias)
        wide = torch.zeros(m, k + 32, dtype=torch.int8, device=cuda_device)
        wide[:, 16:16 + k] = a
        for x in (a, wide[:, 16:16 + k]):
            for zp in (azp, None):
                args = (x, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, zp, lin.bias)
                got = cuda_backend.int8_matmul_cuda(*args)
                want = torch_backend.int8_matmul_torch(*args)
                assert got.shape == (m, n) and torch.equal(got, want), (bias, zp is None)
    assert cuda_backend.int8_matmul_cuda.launches == 8


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
    with pytest.raises(ValueError, match="16-byte aligned"):  # a row pitch of 72 bytes
        cuda_backend.int8_matmul_cuda(torch.zeros(32, 72, dtype=torch.int8, device=cuda_device)
                                      [:, :64], lin.w, sa, lin.scale, torch.bfloat16,
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


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4p"])
def test_qlinear_takes_the_token_view_of_one_nchw_map(cuda_device, quant):
    """The (1, H*W, C) token view of one NCHW map (the SDXL Transformer2D's
    proj_in input at batch 1: its rows are strided, last-dim stride H*W) goes
    through the quantized QLinear as its contiguous copy does, bit for bit."""
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    g = torch.Generator(device=cuda_device).manual_seed(3)
    fmap = torch.randn(1, 128, 16, 24, generator=g, device=cuda_device).bfloat16()
    view = fmap.flatten(2).transpose(1, 2)
    assert view.reshape(-1, 128).stride(-1) != 1
    lin = qlinear_random(g, 128, 96, quant=quant, device=cuda_device)
    assert torch.equal(lin(view), lin(view.contiguous()))


# ----------------------------------------------------------- W4A4 kernels

# (M, K, N): one token (FLUX's AdaLN modulations, (1, 3072) -> 18432), a
# ragged row count, and FLUX's longest K (the single blocks' proj_out, 15360)
W4A4_SHAPES = {"mod-m1": (1, 3072, 18432), "ragged": (77, 96, 40),
               "proj_out": (8704, 15360, 3072)}


def _w4a4_operands(m, k, n, device, bias=True, packed=True):
    """A bf16 activation quantized by the plain int4 quantizer and a random
    W4A4 QLinear (int4p: its packed weight unpacked by the plain version), as
    qlinear_apply feeds the GEMM."""
    from fastdm_tpu_torch.kernels import torch_backend
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    g = torch.Generator(device=device).manual_seed(4)
    x = (torch.randn(m, k, generator=g, device=device) * 2).bfloat16()
    lin = qlinear_random(g, k, n, bias=bias, quant="int4p" if packed else "int4", device=device)
    xq, xs = torch_backend.quantize_to_int4_torch(x)
    w = torch_backend.unpack_int4_torch(lin.w4p) if packed else lin.w4
    return x, xq, xs, w, lin


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(W4A4_SHAPES))
def test_w4a4_kernels_bit_exact_on_card(cuda_device, shape):
    """Kernel A (the int4 quantizer, an all-zero row included), kernel C (the
    int4p unpack into a K-contiguous buffer) and kernel B (the int4 GEMM, with
    and without bias, on a strided activation too) bit-exact with their plain
    versions; one launch each per call."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, n = W4A4_SHAPES[shape]
    cuda_backend.reset_launch_counts()
    x, xq, xs, w, lin = _w4a4_operands(m, k, n, cuda_device)
    x[0] = 0
    got, want = cuda_backend.quantize_to_int4_cuda(x), torch_backend.quantize_to_int4_torch(x)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0].min()) >= -8 and int(got[0].max()) <= 7
    unpacked = cuda_backend.unpack_int4_cuda(lin.w4p)
    assert unpacked.shape == (k, n) and unpacked.stride() == (1, k) and torch.equal(unpacked, w)
    wide = torch.zeros(m, k + 32, dtype=torch.int8, device=cuda_device)
    wide[:, 16:16 + k] = xq
    for a in (xq, wide[:, 16:16 + k]):
        for bias in (lin.bias, None):
            args = (a, unpacked, xs, lin.scale, torch.bfloat16, bias)
            assert torch.equal(cuda_backend.int4_matmul_cuda(*args),
                               torch_backend.int4_matmul_torch(*args))
    assert (cuda_backend.quantize_to_int4_cuda.launches, cuda_backend.unpack_int4_cuda.launches,
            cuda_backend.int4_matmul_cuda.launches, cuda_backend.int8_matmul_cuda.launches) \
        == (1, 1, 4, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("half,n", [(8, 5), (24, 3), (1, 1), (48, 0), (32, 3)])
def test_unpack_int4_kernel_byte_path_on_card(cuda_device, half, n):
    """Packed rows whose K/2 is not a multiple of 16, or that start off a
    16-byte boundary, take the byte path (K/2 of 32 the vector path); a slice
    of packed rows (qlinear_slice_out) unpacks in place; bit-exact with the
    plain version on every byte value."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    buf = torch.arange(256, dtype=torch.int32, device=cuda_device).repeat(
        -(-(half * (n + 2)) // 256))[:half * (n + 2)].to(torch.uint8).view(torch.int8)
    p = buf.reshape(n + 2, half).t()[:, 1:n + 1]  # rows 1..n of an (n + 2, K/2) buffer
    got = cuda_backend.unpack_int4_cuda(p)
    assert got.shape == (2 * half, n) and torch.equal(got, torch_backend.unpack_int4_torch(p))


@pytest.mark.gpu
def test_w4a4_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend

    _, xq, xs, w, lin = _w4a4_operands(32, 64, 48, cuda_device)
    with pytest.raises(ValueError, match="K-contiguous"):
        cuda_backend.int4_matmul_cuda(xq, w.contiguous(), xs, lin.scale, torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        cuda_backend.int4_matmul_cuda(xq.float(), w, xs, lin.scale, torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):  # a row pitch of 72 bytes
        cuda_backend.int4_matmul_cuda(torch.zeros(32, 72, dtype=torch.int8, device=cuda_device)
                                      [:, :64], w, xs, lin.scale, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_backend.unpack_int4_cuda(lin.w4p.contiguous())
    with pytest.raises(ValueError, match="int8"):
        cuda_backend.unpack_int4_cuda(lin.w4p.view(torch.uint8))
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_backend.quantize_to_int4_cuda(torch.zeros(4, 12, device=cuda_device,
                                                       dtype=torch.bfloat16))


@pytest.fixture
def exact_bf16_products():
    """cuBLAS's bf16 products (the plain W4A4 linear's low-rank term) with f32
    reductions only: PyTorch lets cuBLAS reduce split sums in bf16 by default,
    which at an N that is not a multiple of 8 put the term thousands of ulp
    from its exact value on an H100."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


@pytest.mark.gpu
def test_qlinear_w4a4_launches_its_kernels(cuda_device, exact_bf16_products):
    """int4 and int4p QLinear calls on the card: the quantizer and one
    w4a4_linear entry each; at 150 rows the large-M entry, after the unpack
    for int4p only, and int4p equals int4 on the same values bit for bit; at
    3 rows int4p's small-M entry on the packed weight (no unpack), within one
    bf16 ulp of the output plus one of the low-rank term of int4's large-M
    entry; int4_matmul's kernel launches no more on this path."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random, unpack_int4

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(3, 50, 128, generator=g, device=cuda_device).bfloat16()
    packed = qlinear_random(g, 128, 96, quant="int4p", device=cuda_device)
    unpacked = QLinear(None, packed.bias, packed.scale, w4=unpack_int4(packed.w4p),
                       lora_u=packed.lora_u, lora_v=packed.lora_v)
    cb.reset_launch_counts()
    y = packed(x)
    plain = unpacked(x)
    assert y.shape == (3, 50, 96) and y.dtype == torch.bfloat16 and torch.equal(y, plain)
    few = x[:, :1]
    z, z_plain = packed(few), unpacked(few)
    low = (few.reshape(3, 128) @ packed.lora_u).double() @ packed.lora_v.double()
    excess = (z.float() - z_plain.float()).abs().reshape(3, 96) - (
        _bf16_ulp(z_plain.reshape(3, 96)) + _bf16_ulp(low))
    assert excess.max().item() <= 0
    assert (cb.quantize_to_int4_cuda.launches, cb.unpack_int4_cuda.launches,
            cb.w4a4_linear_large_cuda.launches, cb.w4a4_linear_small_cuda.launches,
            cb.int4_matmul_cuda.launches) == (4, 1, 3, 1, 0)


# (K, N) of FLUX's (and Qwen-Image's) W4A4 linears, the AdaLN modulations'
# 18432 and 9216 among them, and a ragged N (not a multiple of 128 or of 8)
W4A4_LINEAR_KN = [(3072, 3072), (3072, 9216), (3072, 18432), (3072, 21504), (12288, 3072),
                  (15360, 3072), (3072, 1003)]
# the rows: one token, Qwen-Image's text rows (30 / 60), the small-M entry's
# last block sizes and the threshold's neighbours, a ragged large M and
# Qwen-Image-Edit's 1396 text rows
W4A4_LINEAR_M = [1, 16, 30, 60, 64, 65, 513, 1396]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("m", W4A4_LINEAR_M)
@pytest.mark.parametrize("kn", W4A4_LINEAR_KN, ids=lambda kn: f"{kn[0]}x{kn[1]}")
def test_w4a4_linear_entries_match_plain_on_card(cuda_device, exact_bf16_products, kn, m,
                                                 batch):
    """Both entries of w4a4_linear against its plain version (unpack_int4,
    int4_matmul, the bf16 low-rank product and the add) on batch * m rows,
    with and without bias: the small-M entry on the packed weight, the
    large-M entry on the unpacked one. Bit-exact with lora_v = 0; otherwise
    within one bf16 ulp of the output plus one of the low-rank term.
    w4a4_linear_cuda takes the small-M entry at batch * m <= W4A4_SMALL_M_MAX
    (no unpack), else unpack_int4 and the large-M entry, one launch each."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import torch_backend as tb
    from fastdm_tpu_torch.layers.qlinear import qlinear_random

    k, n = kn
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = (torch.randn(batch, m, k, generator=g, device=cuda_device) * 2).bfloat16()
    x[0, 0] = 0
    x2 = x.reshape(-1, k)
    lin = qlinear_random(g, k, n, quant="int4p", device=cuda_device)
    xq, xs = tb.quantize_to_int4_torch(x2)
    xu = x2 @ lin.lora_u
    w = tb.unpack_int4_torch(lin.w4p)
    zero = torch.zeros_like(lin.lora_v)
    for lora_v in (zero, lin.lora_v):
        low = _bf16_ulp(xu.double() @ lora_v.double())
        for bias in (lin.bias, None):
            args = (xs, lin.scale, torch.bfloat16, bias, xu, lora_v)
            want = tb.w4a4_linear_torch(xq, lin.w4p, *args)
            for got in (cb.w4a4_linear_small_cuda(xq, lin.w4p, *args),
                        cb.w4a4_linear_large_cuda(xq, w, *args)):
                assert got.shape == (batch * m, n) and got.dtype == torch.bfloat16
                if lora_v is zero:
                    assert torch.equal(got, want)
                else:
                    excess = (got.float() - want.float()).abs() - (_bf16_ulp(want) + low)
                    assert excess.max().item() <= 0
    cb.reset_launch_counts()
    got = cb.w4a4_linear_cuda(xq, lin.w4p, xs, lin.scale, torch.bfloat16, lin.bias, xu,
                              lin.lora_v)
    small = cb.w4a4_small_m(batch * m, k)
    assert (cb.w4a4_linear_small_cuda.launches, cb.w4a4_linear_large_cuda.launches,
            cb.unpack_int4_cuda.launches) == ((1, 0, 0) if small else (0, 1, 1))
    assert torch.isfinite(got.float()).all()


# ------------------------------------------------------------ Wan kernels


def _pair_ulp_excess(got: torch.Tensor, want: torch.Tensor,
                     head_dim: int = 0) -> torch.Tensor:
    """|got - want| minus the qk_norm_rope tolerance: one bf16 ulp of the
    value plus two of its rotation pair's magnitude (the normalized input may
    sit one ulp away, and the rotation mixes the pair). The pairs are
    interleaved, or with a head_dim the half-split pairs (p, p + head_dim/2)
    of each head."""
    w = want.float()
    if head_dim:
        pair = w.reshape(*w.shape[:-1], -1, 2, head_dim // 2)
        mag = pair.norm(dim=-2, keepdim=True).expand_as(pair).reshape(w.shape)
    else:
        pair = w.reshape(*w.shape[:-1], -1, 2)
        mag = pair.norm(dim=-1, keepdim=True).expand_as(pair).reshape(w.shape)
    return (got.float() - w).abs() - (_bf16_ulp(w) + 2 * _bf16_ulp(mag))


# (heads, head_dim): 768; Wan2.2-A14B's 5120 and Wan2.2-5B's 3072 (the fast
# path); 8320 (past the fast path's 8192) and 30 (not a multiple of 8, head
# dim 6), which take the tail path
QK_WIDTHS = [(6, 128), (40, 128), (24, 128), (65, 128), (5, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,hd", QK_WIDTHS)
@pytest.mark.parametrize("gamma", [torch.bfloat16, torch.float32, None])
def test_qk_norm_rope_kernels_match_plain_on_card(cuda_device, gamma, heads, hd):
    """The fused form reads q|k in place from a strided (2, S, 3D) qkv
    (inner_dim) and from a (2, S, 2D) one; the two-operand form takes strided
    q and k views; both forms give the same bits on the same rows, with the
    norm weights in bf16, in f32 or absent, in the interleaved and the
    half-split layout (fast path at head dim 128, tail at 6)."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    b, s = 2, 77
    d = heads * hd
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = (torch.randn(b, s, 3 * d, generator=g, device=cuda_device) * 2).bfloat16()
    gq = gk = None
    if gamma is not None:
        gq = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).to(gamma)
        gk = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).to(gamma)
    cos, sin = _rope_tables(s, hd, cuda_device)
    for neox in (False, True):
        want = torch_backend.qk_norm_rope_torch(qkv, gq, gk, hd, cos, sin, neox, inner_dim=d)
        fused = cuda_backend.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, neox, inner_dim=d)
        two_d = cuda_backend.qk_norm_rope_cuda(qkv[..., :2 * d].contiguous(), gq, gk, hd, cos,
                                               sin, neox)
        split = cuda_backend.qk_norm_rope2_cuda(qkv[..., :d], qkv[..., d:2 * d], gq, gk, hd,
                                                cos, sin, neox)
        for got in (fused, two_d, split):
            for a, w in zip(got, want):
                assert a.shape == (b, s, d) and a.dtype == torch.bfloat16 and a.is_contiguous()
                assert (_pair_ulp_excess(a, w, hd if neox else 0) <= 0).all(), neox
        for a, c, e in zip(fused, two_d, split):
            assert torch.equal(a, c) and torch.equal(a, e)


def _random_super_tables(nq, skv, fine, group, sb, density, seed, empty_rows=()):
    from fastdm_tpu_torch.sparse.xsparse import super_tables_from_mask

    rng = np.random.default_rng(seed)
    nfine = -(-skv // fine)
    m = rng.random((nq, nfine)) < density
    m[:, 0] = True
    m[:, -1] |= rng.random(nq) < 0.5  # the partial tail fine block, in about half the rows
    for r in empty_rows:
        m[r] = False
    return super_tables_from_mask(m, group, sb)


# name: (batch, sq, skv, heads_q, heads_kv, head_dim, block_q, fine, group, superblock,
#        density, empty rows)
GATHER_CASES = {
    "ragged-tail": (1, 700, 961, 4, 4, 128, 256, 64, 2, 4, 0.4, ()),
    "fine128-empty-rows": (2, 1000, 1000, 2, 2, 128, 256, 128, 3, 4, 0.3, (1,)),
    "gqa-d64-pad": (1, 513, 1500, 8, 2, 64, 128, 64, 4, 2, 0.5, (0,)),
    "wan-heads": (1, 2048, 2048, 40, 40, 128, 256, 128, 8, 4, 0.4, ()),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_super_kernel_matches_plain_on_card(cuda_device, case):
    """Ragged sq and skv (a partial tail q tile and a partial tail fine
    block), rows with no allowed key (0 out), padding slots (segments not a
    multiple of `group`), GQA and head_dim 64; tolerance as sdpa's FLUX-heads
    case: 1e-3 + 2 bf16 ulp of |plain| and relative L2 5e-3."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    b, sq, skv, hq, hkv, d, bq, fine, group, sb, density, empty = GATHER_CASES[case]
    nq = -(-sq // bq)
    tables = [torch.from_numpy(t).to(cuda_device) for t in
              _random_super_tables(nq, skv, fine, group, sb, density, 7, empty)]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    mk = lambda s, h: torch.randn(b, s, h * d, generator=g, device=cuda_device,  # noqa: E731
                                  dtype=torch.bfloat16)
    q, k, v = mk(sq, hq), mk(skv, hkv), mk(skv, hkv)
    kw = dict(block_q=bq, group=group, fine=fine, superblock=sb)
    got = cuda_backend.gather_super_attention_cuda(q, k, v, *tables, hq, hkv, d, **kw).float()
    want = torch_backend.sdpa_gather_super_torch(q, k, v, *tables, hq, hkv, d, **kw).float()
    assert ((got - want).abs() <= 1e-3 + 2 * _bf16_ulp(want)).all()
    assert (got - want).norm() / want.norm() <= 5e-3
    for r in empty:
        assert not got[:, r * bq:(r + 1) * bq].any()


@pytest.mark.gpu
def test_gather_super_all_active_equals_dense_kernel(cuda_device):
    """Tables that allow every key give the dense sdpa kernel's result: the
    same 128-key tiles in the same order through the same code, so bit for
    bit."""
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.sparse.xsparse import super_tables_from_mask

    b, sq, skv, h, d, bq, fine, sb = 1, 1000, 1000, 4, 128, 256, 128, 4
    nq = -(-sq // bq)
    tables = [torch.from_numpy(t).to(cuda_device) for t in
              super_tables_from_mask(np.ones((nq, -(-skv // fine)), bool), 2, sb)]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(b, s, h * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
               for s in (sq, skv, skv))
    got = cuda_backend.gather_super_attention_cuda(q, k, v, *tables, h, h, d, block_q=bq,
                                                   group=2, fine=fine, superblock=sb)
    assert torch.equal(got, cuda_backend.sdpa_cuda(q, k, v, h, h, d))


@pytest.mark.gpu
def test_wan_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.sparse.xsparse import super_tables_from_mask

    q = torch.zeros(1, 300, 2 * 128, device=cuda_device, dtype=torch.bfloat16)
    tables = [torch.from_numpy(t).to(cuda_device) for t in
              super_tables_from_mask(np.ones((2, 5), bool), 2, 4)]
    with pytest.raises(ValueError, match="multiples of 64"):
        cuda_backend.gather_super_attention_cuda(q, q, q, *tables, 2, 2, 128, block_q=256,
                                                 group=2, fine=32, superblock=4)
    with pytest.raises(ValueError, match="block_rows"):
        cuda_backend.gather_super_attention_cuda(q, q, q, *tables, 2, 2, 128, block_q=128,
                                                 group=2, fine=64, superblock=4)
    with pytest.raises(ValueError, match="int32"):
        cuda_backend.gather_super_attention_cuda(q, q, q, tables[0].long(), *tables[1:], 2, 2,
                                                 128, block_q=256, group=2, fine=64,
                                                 superblock=4)
    cos = torch.zeros(300, 64, device=cuda_device)
    with pytest.raises(ValueError, match="cos/sin"):
        cuda_backend.qk_norm_rope2_cuda(q, q, None, None, 128, cos[:10], cos[:10])
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_backend.qk_norm_rope2_cuda(q.float(), q.float(), None, None, 128, cos, cos)


# -------------------------------------------------- mask / coarse / fine walks

# name: (batch, sq, skv, heads_q, heads_kv, head_dim, block_q, block_k or fine, group,
#        density, empty row)
WALK_CASES = {
    "ragged-tail": (1, 700, 961, 4, 4, 128, 256, 128, 4, 0.4, None),
    "empty-row-batch2": (2, 1000, 1000, 2, 2, 128, 128, 128, 3, 0.3, 1),
    "gqa-d64": (1, 513, 1500, 8, 2, 64, 128, 64, 8, 0.5, 0),
    "wan-heads": (1, 2048, 2048, 40, 40, 128, 512, 128, 32, 0.4, None),
}
# block_q and block_k odd multiples of 64 (blocks of one consumer; tiles
# pairing the 64-key halves of two entries), one of them GQA at D 64
ODD_TILE_CASES = {
    "odd-192x320": (1, 1000, 1111, 4, 4, 128, 192, 320, None, 0.5, 2),
    "odd-gqa-d64": (2, 700, 900, 8, 2, 64, 64, 192, None, 0.5, 3),
}


def _walk_operands(case, device, seed=8):
    b, sq, skv, hq, hkv, d = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda s, h: torch.randn(b, s, h * d, generator=g, device=device,  # noqa: E731
                                  dtype=torch.bfloat16)
    return mk(sq, hq), mk(skv, hkv), mk(skv, hkv)


def _close_to_plain(got, want, empty, bq):
    """Within sdpa's small-case tolerance, 1e-2 + 1e-2*|x|: rows that see a
    single 104-key tail block average few keys, and the kernel's and the plain
    version's bf16 rounding of p (unnormalized, normalized) moves such outputs
    by up to ~1e-3. Over the whole output, relative L2 <= 5e-3 (a dropped or
    doubled 64-key tile gives ~5e-2)."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert (got - want).norm() / want.norm() <= 5e-3
    if empty is not None:
        assert not got[:, empty * bq:(empty + 1) * bq].any()


MASK_CASES = {**WALK_CASES, **ODD_TILE_CASES}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_sparse_mask_kernel_matches_plain_on_card(cuda_device, case):
    """A different random mask per batch entry and head (ragged skv, a
    partial tail q tile, an empty row, GQA, head_dim 64, tiles that are odd
    multiples of 64)."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    b, sq, skv, hq, hkv, d, bq, bk, _, density, empty = MASK_CASES[case]
    q, k, v = _walk_operands(MASK_CASES[case], cuda_device)
    rng = np.random.default_rng(9)
    mask = (rng.random((b, hq, -(-sq // bq), -(-skv // bk))) < density).astype(np.int32)
    mask[..., -1] = 1
    if empty is not None:
        mask[:, :, empty] = 0
    m = torch.from_numpy(mask).to(cuda_device)
    kw = dict(sparse_mask=m, block_q=bq, block_k=bk)
    got = cuda_backend.sparse_attention_cuda(q, k, v, hq, hkv, d, **kw)
    _close_to_plain(got, torch_backend.sdpa_sparse_torch(q, k, v, hq, hkv, d, **kw), empty, bq)


# the coarse walk: each WALK_CASES case with block_k doubled, and the odd tiles
COARSE_CASES = {
    **{name: (*c[:7], 2 * c[7], *c[8:]) for name, c in WALK_CASES.items()},
    **ODD_TILE_CASES,
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COARSE_CASES))
def test_gather_coarse_kernel_matches_plain_on_card(cuda_device, case):
    """Coarse lists with padding entries past each row's count (index 0
    repeated, never computed), a ragged last KV tile, an empty row, and tile
    sizes that are odd multiples of 64."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend
    from fastdm_tpu_torch.sparse.xsparse import mask_to_block_lists

    b, sq, skv, hq, hkv, d, bq, bk, _, density, empty = COARSE_CASES[case]
    q, k, v = _walk_operands(COARSE_CASES[case], cuda_device)
    m = np.random.default_rng(10).random((-(-sq // bq), -(-skv // bk))) < density
    m[:, -1] = True
    if empty is not None:
        m[empty] = False
    idx, cnt, _ = mask_to_block_lists(m)
    tables = [torch.from_numpy(t).to(cuda_device) for t in (idx, cnt)]
    kw = dict(block_q=bq, block_k=bk)
    got = cuda_backend.gather_sparse_attention_cuda(q, k, v, *tables, hq, hkv, d, **kw)
    _close_to_plain(got, torch_backend.sdpa_gather_torch(q, k, v, *tables, hq, hkv, d, **kw),
                    empty, bq)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_gather_fine_kernel_matches_plain_on_card(cuda_device, case):
    """Fine tables with padding slots, the partial tail fine block, an empty
    row, and a third of the entries cut to a partial `valid` (the kernel
    honours it, as the plain version and the jnp oracle do)."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend
    from fastdm_tpu_torch.sparse.xsparse import fine_tables_from_mask

    b, sq, skv, hq, hkv, d, bq, fine, group, density, empty = WALK_CASES[case]
    q, k, v = _walk_operands(WALK_CASES[case], cuda_device)
    rng = np.random.default_rng(11)
    m = rng.random((-(-sq // bq), -(-skv // fine))) < density
    m[:, -1] = True
    if empty is not None:
        m[empty] = False
    idx, val, rows = fine_tables_from_mask(m, group, fine, skv)
    val[::3] = np.minimum(val[::3], rng.integers(1, fine, size=val[::3].shape))
    tables = [torch.from_numpy(t).to(cuda_device) for t in (idx, val, rows)]
    kw = dict(block_q=bq, group=group, fine=fine)
    got = cuda_backend.gather_fine_attention_cuda(q, k, v, *tables, hq, hkv, d, **kw)
    _close_to_plain(got, torch_backend.sdpa_gather_fine_torch(q, k, v, *tables, hq, hkv, d,
                                                              **kw), empty, bq)


# walks on tables that allow every key: (walk, block_q, fine (the mask's
# block_k), superblock, GQA at D 64)
ALL_KEY_WALKS = {
    "super-sb4-fine128": ("super", 256, 128, 4, False),
    "super-sb3-fine64": ("super", 256, 64, 3, False),
    "super-bq192": ("super", 192, 128, 4, False),
    "super-gqa-d64": ("super", 256, 64, 3, True),
    "fine-bq512": ("fine", 512, 128, 1, False),
    "fine-64-bq192": ("fine", 192, 64, 1, False),
    "fine-gqa-d64": ("fine", 256, 128, 1, True),
    "mask": ("mask", 128, 128, 1, False),
    "mask-gqa-d64": ("mask", 128, 128, 1, True),
    "mask-bq192": ("mask", 192, 128, 1, False),
    "mask-bq192-bk320": ("mask", 192, 320, 1, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ALL_KEY_WALKS))
def test_walks_allowing_every_key_equal_dense_kernel(cuda_device, case):
    """Tables that allow every key give, bit for bit, the result of the dense
    sdpa kernel their walk runs on (skv = 1000: the last tile is partial): the
    same 128-key tiles in the same order through the same code, also when
    halves pair across fine sub-blocks and entries (fine 64, superblock 3, a
    mask's block_k 320), in blocks of one consumer (block_q 192) and with GQA
    at head dim 64. An emptied row gives zeros and leaves the other rows as
    they were. The coarse walk is held to sdpa in
    test_coarse_allowing_every_key_equals_sdpa_kernel."""
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.sparse.xsparse import fine_tables_from_mask, super_tables_from_mask

    walk, bq, fine, sb, gqa_d64 = ALL_KEY_WALKS[case]
    b, s, hq, hkv, d = (2, 1000, 8, 2, 64) if gqa_d64 else (1, 1000, 4, 4, 128)
    q, k, v = _walk_operands((b, s, s, hq, hkv, d), cuda_device, seed=12)
    to = lambda ts: [torch.from_numpy(t).to(cuda_device) for t in ts]  # noqa: E731
    nq, every = -(-s // bq), np.ones((-(-s // bq), -(-s // fine)), bool)
    if walk == "mask":
        full = torch.ones(b, hq, nq, -(-s // fine), dtype=torch.int32, device=cuda_device)
        empty = full.clone()
        empty[:, :, 1] = 0
        run = lambda m: cuda_backend.sparse_attention_cuda(  # noqa: E731
            q, k, v, hq, hkv, d, sparse_mask=m, block_q=bq, block_k=fine)
    else:
        if walk == "super":
            full = to(super_tables_from_mask(every, 2, sb))
            run = lambda t: cuda_backend.gather_super_attention_cuda(  # noqa: E731
                q, k, v, *t, hq, hkv, d, block_q=bq, group=2, fine=fine, superblock=sb)
        else:
            full = to(fine_tables_from_mask(every, 4, fine, s))
            run = lambda t: cuda_backend.gather_fine_attention_cuda(  # noqa: E731
                q, k, v, *t, hq, hkv, d, block_q=bq, group=4, fine=fine)
        rows = full[2].clone()
        rows[1, 1] = 0
        empty = (full[0], full[1], rows)
    want = cuda_backend.sdpa_cuda(q, k, v, hq, hkv, d)
    got = run(full)
    assert torch.equal(got, want)
    emptied = run(empty)
    assert not emptied[:, bq:2 * bq].any()
    assert torch.equal(emptied[:, :bq], got[:, :bq])
    assert torch.equal(emptied[:, 2 * bq:], got[:, 2 * bq:])


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(256, 256), (192, 320), (64, 64)])
@pytest.mark.parametrize("gqa_d64", [False, True])
def test_coarse_allowing_every_key_equals_sdpa_kernel(cuda_device, blocks, gqa_d64):
    """Coarse lists of every KV tile in order give dense sdpa's kernel result
    bit for bit: the same 128-key tiles in the same order through the same
    code (skv = 1000: the last tile is partial), also when block_k is an odd
    multiple of 64 (tiles pair the halves of two entries) and when block_q is
    one (blocks of one consumer); an emptied row gives zeros and leaves the
    other rows as they were."""
    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.sparse.xsparse import mask_to_block_lists

    bq, bk = blocks
    b, s, hq, hkv, d = (2, 1000, 8, 2, 64) if gqa_d64 else (1, 1000, 4, 4, 128)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = (torch.randn(b, s, h * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
               for h in (hq, hkv, hkv))
    idx, cnt, _ = mask_to_block_lists(np.ones((-(-s // bq), -(-s // bk)), bool))
    idx, cnt = (torch.from_numpy(t).to(cuda_device) for t in (idx, cnt))
    got = cuda_backend.gather_sparse_attention_cuda(q, k, v, idx, cnt, hq, hkv, d, block_q=bq,
                                                    block_k=bk)
    assert torch.equal(got, cuda_backend.sdpa_cuda(q, k, v, hq, hkv, d))
    cnt[1] = 0
    emptied = cuda_backend.gather_sparse_attention_cuda(q, k, v, idx, cnt, hq, hkv, d,
                                                        block_q=bq, block_k=bk)
    assert not emptied[:, bq:2 * bq].any()
    assert torch.equal(emptied[:, :bq], got[:, :bq])
    assert torch.equal(emptied[:, 2 * bq:], got[:, 2 * bq:])


@pytest.mark.gpu
def test_sparse_walk_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend

    q = torch.zeros(1, 300, 2 * 128, device=cuda_device, dtype=torch.bfloat16)
    mask = torch.ones(1, 2, 3, 3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_backend.sparse_attention_cuda(q.float(), q.float(), q.float(), 2, 2, 128,
                                           sparse_mask=mask)
    with pytest.raises(ValueError, match="int32"):
        cuda_backend.sparse_attention_cuda(q, q, q, 2, 2, 128, sparse_mask=mask.bool())
    with pytest.raises(ValueError, match="lie on"):
        cuda_backend.sparse_attention_cuda(q, q.cpu(), q, 2, 2, 128, sparse_mask=mask)
    with pytest.raises(ValueError, match="non-causal"):
        cuda_backend.sparse_attention_cuda(q, q, q, 2, 2, 128, True, sparse_mask=mask)
    with pytest.raises(ValueError, match="multiples of 64"):
        cuda_backend.sparse_attention_cuda(q, q, q, 2, 2, 128, sparse_mask=torch.ones(
            1, 2, 10, 10, dtype=torch.int32, device=cuda_device), block_q=32, block_k=32)
    idx = torch.zeros(3, 2, dtype=torch.int32, device=cuda_device)
    cnt = torch.ones(3, 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous int32 tensor on"):
        cuda_backend.gather_sparse_attention_cuda(q, q, q, idx.cpu(), cnt, 2, 2, 128,
                                                  block_q=128, block_k=256)
    with pytest.raises(ValueError, match="int32"):
        cuda_backend.gather_sparse_attention_cuda(q, q, q, idx.long(), cnt, 2, 2, 128,
                                                  block_q=128, block_k=256)
    rows = torch.zeros(3, 2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 64"):
        cuda_backend.gather_fine_attention_cuda(q, q, q, idx[:, 0].contiguous(), idx[:, 0].
                                                contiguous(), rows, 2, 2, 128, block_q=128,
                                                group=1, fine=32)


# Wan2.2-TI2V-5B's W8A8 linears at 768x768x121 (17856 video tokens, 512 text
# tokens, width 3072, FFN 14336): (M, K, N)
WAN5B_W8A8 = {"qkv": (17856, 3072, 9216), "proj": (17856, 3072, 3072),
              "text-kv": (512, 3072, 6144), "ffn-in": (17856, 3072, 14336),
              "ffn-out": (17856, 14336, 3072)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(WAN5B_W8A8))
def test_int8_kernels_bit_exact_at_wan5b_shapes(cuda_device, shape):
    """The per-token int8 quantizer and the int8 GEMM (with and without the
    zero point) at every W8A8 shape of a Wan2.2-TI2V-5B forward: bit-exact."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, n = WAN5B_W8A8[shape]
    a, sa, azp, lin = _w8a8_operands("int8", m, k, n, cuda_device)
    x = (torch.randn(m, k, generator=torch.Generator(device=cuda_device).manual_seed(5),
                     device=cuda_device) * 3).bfloat16()
    for got, want in zip(cuda_backend.quantize_to_int8_cuda(x, symmetric=False),
                         torch_backend.quantize_to_int8_torch(x, symmetric=False)):
        assert torch.equal(got, want)
    for zp in (azp, None):
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, zp, lin.bias)
        assert torch.equal(cuda_backend.int8_matmul_cuda(*args),
                           torch_backend.int8_matmul_torch(*args))


@pytest.mark.gpu
def test_wan5b_qk_norm_rope_and_rmsnorm_on_card(cuda_device):
    """Wan2.2-TI2V-5B's fused q|k norm + 3D RoPE on the (1, 17856, 9216) QKV
    with its 31 x 24 x 24 patch tables (3072-wide rows, one block per token)
    in both pair layouts, and the cross-attention's rmsnorm on 3072-wide q
    rows and on k read in place from the fused text K|V, at the tolerances
    above."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend
    from fastdm_tpu_torch.models.wan import WanConfig, wan_rope_cos_sin

    cfg = WanConfig(num_attention_heads=24, attention_head_dim=128)
    d, hd = cfg.inner_dim, cfg.attention_head_dim
    cos, sin = wan_rope_cos_sin(cfg, 31, 48, 48, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    qkv = (torch.randn(1, 17856, 3 * d, generator=g, device=cuda_device) * 2).bfloat16()
    gq = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).bfloat16()
    gk = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).bfloat16()
    for neox in (False, True):
        got = cuda_backend.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, neox, inner_dim=d)
        want = torch_backend.qk_norm_rope_torch(qkv, gq, gk, hd, cos, sin, neox, inner_dim=d)
        for a, w in zip(got, want):
            assert (_pair_ulp_excess(a, w, hd if neox else 0) <= 0).all(), neox
    kv = torch.randn(1, 512, 2 * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
    for x in (qkv[..., :d].contiguous(), kv[..., :d]):
        got = cuda_backend.rms_norm_cuda(x, gq, 1e-6).float()
        want = torch_backend.rms_norm_torch(x, gq, 1e-6).float()
        assert ((got - want).abs() <= _bf16_ulp(want)).all()


# ControlNet / IP-Adapter shapes: the IP-Adapter branch of SDXL's
# cross-attentions at 1024x2048 with CFG (q on 8192 tokens at 640 wide and on
# 2048 at 1280, 4 image tokens of ip-adapter_sdxl or 16 of IP-Adapter-Plus,
# k|v read in place from the fused ipadp_kv output), the Plus resampler (16
# latents over 257 CLIP tokens + 16), the union FLUX ControlNet's joint
# sequence (512 text + 1 mode + 8192 image tokens: the last 128-row query
# tile holds one row)
IP_KEYS = {"ip-640x4": (640, 8192, 4), "ip-1280x4": (1280, 2048, 4),
           "ip-640x16": (640, 8192, 16), "ip-1280x16": (1280, 2048, 16)}
UNION_TOKENS, UNION_TEXT = 8705, 513


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(IP_KEYS))
def test_sdpa_kernel_on_ip_adapter_keys(cuda_device, case):
    """4 or 16 keys against a 128-key box: the out-of-bounds rows are
    zero-filled and masked, so no row is -inf / NaN and no key past the
    view's end is read (the fused buffer's later rows hold 1e4 values, which
    would dominate every softmax); held as the small cases."""
    from fastdm_tpu_torch.kernels.cuda_backend import sdpa_cuda
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_torch

    c, tokens, keys = IP_KEYS[case]
    h = c // 64
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(2, tokens, c, generator=g, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.randn(2, keys + 20, 2 * c, generator=g, device=cuda_device, dtype=torch.bfloat16)
    kv[:, keys:] = 1e4
    k, v = kv[:, :keys, :c], kv[:, :keys, c:]
    got = sdpa_cuda(q, k, v, h, h, 64, False).float()
    want = sdpa_torch(q, k, v, h, h, 64, False).float()
    assert torch.isfinite(got).all() and got.abs().max() < 10
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    exact = kv[:, :keys].contiguous()  # the same keys in a buffer of their own
    torch.testing.assert_close(sdpa_cuda(q, exact[..., :c], exact[..., c:], h, h, 64).float(),
                               got, rtol=0, atol=0)


@pytest.mark.gpu
def test_sdpa_kernel_on_the_plus_resampler(cuda_device):
    """IP-Adapter-Plus's resampler: q (2, 16, 20x64) from the latents against
    k|v (2, 273, 2x1280) read in place: one short query tile and a 17-key
    tail; held as the small cases."""
    from fastdm_tpu_torch.kernels.cuda_backend import sdpa_cuda
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_torch

    g = torch.Generator(device=cuda_device).manual_seed(8)
    q = torch.randn(2, 16, 1280, generator=g, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.randn(2, 273, 2560, generator=g, device=cuda_device, dtype=torch.bfloat16)
    got = sdpa_cuda(q, kv[..., :1280], kv[..., 1280:], 20, 20, 64).float()
    want = sdpa_torch(q, kv[..., :1280], kv[..., 1280:], 20, 20, 64).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_union_controlnet_joint_sequence_on_card(cuda_device):
    """The union ControlNet's 8705-token joint sequence (24 heads of 128):
    sdpa held as the long cases (the last query tile holds one row), rotembd
    bit-exact on the mode-token-extended tables (row 0 duplicated in front),
    rmsnorm within one ulp on the strided head rows of the 8705-row image +
    text QKV and the 513-row text one."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_rope_cache

    s, hd, h = UNION_TOKENS, 128, 24
    cos, sin = flux_rope_cache(FluxConfig(), UNION_TEXT - 1, 64, 128, device=cuda_device)
    cos, sin = torch.cat([cos[:1], cos]), torch.cat([sin[:1], sin])
    assert cos.shape[0] == s and s % 128 == 1
    g = torch.Generator(device=cuda_device).manual_seed(9)
    qkv = torch.randn(1, s, 3 * h * hd, generator=g, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = qkv.split(h * hd, dim=-1)
    got = cuda_backend.sdpa_cuda(q, k, v, h, h, hd).float()
    want = torch_backend.sdpa_torch(q, k, v, h, h, hd).float()
    assert ((got - want).abs() <= 1e-3 + 2 * _bf16_ulp(want)).all()
    assert (got - want).norm() / want.norm() <= 5e-3
    qc, kc = q.contiguous(), k.contiguous()
    for a, w in zip(cuda_backend.rotary_pos_embedding_cuda(qc, kc, hd, cos, sin, False),
                    torch_backend.rotary_pos_embedding_torch(qc, kc, hd, cos, sin, False)):
        assert torch.equal(a, w)
    gamma = (1 + 0.05 * torch.randn(hd, generator=g, device=cuda_device)).bfloat16()
    for rows in (s, UNION_TEXT):
        x = qkv[:, :rows, :h * hd].reshape(1, rows, h, hd)
        got = cuda_backend.rms_norm_cuda(x, gamma, 1e-6).float()
        want = torch_backend.rms_norm_torch(x, gamma, 1e-6).float()
        assert ((got - want).abs() <= _bf16_ulp(want)).all(), rows


# the union ControlNet's W8A8 linears at its new M: 513 text rows (the dual
# blocks' context stream with the mode token) and 8705 joint rows (the
# single blocks): (M, K, N)
UNION_W8A8 = {"text-qkv": (513, 3072, 9216), "text-ff-out": (513, 12288, 3072),
              "joint-qkv-mlp": (8705, 3072, 21504), "joint-proj-out": (8705, 15360, 3072)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(UNION_W8A8))
def test_int8_kernels_bit_exact_at_union_controlnet_shapes(cuda_device, shape):
    """The per-token int8 quantizer and the int8 GEMM (with and without the
    zero point) at the union ControlNet's new row counts: bit-exact."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    m, k, n = UNION_W8A8[shape]
    a, sa, azp, lin = _w8a8_operands("int8", m, k, n, cuda_device)
    x = (torch.randn(m, k, generator=torch.Generator(device=cuda_device).manual_seed(10),
                     device=cuda_device) * 3).bfloat16()
    for got, want in zip(cuda_backend.quantize_to_int8_cuda(x, symmetric=False),
                         torch_backend.quantize_to_int8_torch(x, symmetric=False)):
        assert torch.equal(got, want)
    for zp in (azp, None):
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, zp, lin.bias)
        assert torch.equal(cuda_backend.int8_matmul_cuda(*args),
                           torch_backend.int8_matmul_torch(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_wan21_image_branch_shapes_on_card(cuda_device, batch):
    """Wan2.1-I2V-14B's image branch at 480x832x81, batch 1 and 2: sdpa of a
    4095-token chunk (40 heads of 128) against 257 image keys (two 128-key
    tiles and a tail of one), as the small cases plus relative L2 5e-3; the
    int8 quantizer and GEMM at M = 257 * batch, K = N = 5120 (add_k / add_v:
    a one-row M tail) bit-exact with and without the zero point; rmsnorm
    (norm_added_k) on (batch, 257, 5120) rows within one bf16 ulp."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(batch, 4095, 5120, generator=g, device=cuda_device, dtype=torch.bfloat16)
    k, v = (torch.randn(batch, 257, 5120, generator=g, device=cuda_device, dtype=torch.bfloat16)
            for _ in range(2))
    got = cuda_backend.sdpa_cuda(q, k, v, 40, 40, 128, False).float()
    want = torch_backend.sdpa_torch(q, k, v, 40, 40, 128, False).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert (got - want).norm() / want.norm() <= 5e-3
    a, sa, azp, lin = _w8a8_operands("int8", 257 * batch, 5120, 5120, cuda_device)
    x = (torch.randn(257 * batch, 5120, generator=g, device=cuda_device) * 3).bfloat16()
    for gq, wq in zip(cuda_backend.quantize_to_int8_cuda(x, symmetric=False),
                      torch_backend.quantize_to_int8_torch(x, symmetric=False)):
        assert gq.dtype == wq.dtype and torch.equal(gq, wq)
    for zp in (azp, None):
        args = (a, lin.w, sa, lin.scale, torch.bfloat16, lin.colsum, zp, lin.bias)
        assert torch.equal(cuda_backend.int8_matmul_cuda(*args),
                           torch_backend.int8_matmul_torch(*args))
    x = (torch.randn(batch, 257, 5120, generator=g, device=cuda_device) * 2).bfloat16()
    w = (1 + 0.1 * torch.randn(5120, generator=g, device=cuda_device)).bfloat16()
    got, want = cuda_backend.rms_norm_cuda(x, w, 1e-6), torch_backend.rms_norm_torch(x, w, 1e-6)
    assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()


# Qwen-Image-Edit at 1024x1024 with one 1024x1024 source, its prompt through
# the Qwen2.5-VL encoder: 1396 text tokens after the template's 64 for
# chip_smoke.py's edit prompt (1369 of them the image's), then 4096 noise and
# 4096 source tokens
QWEN_EDIT_TEXT, QWEN_EDIT_IMAGE = 1396, 4096
QWEN_TEXT_W4A4 = {"qkv": (3072, 9216), "out": (3072, 3072), "mlp-in": (3072, 12288),
                  "mlp-out": (12288, 3072)}


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_qwen_edit_text_stream_shapes_on_card(cuda_device, batch):
    """The shapes a Qwen-Image-Edit prompt from the VL encoder sends to the
    DiT's kernels, batch 1 and 2: rmsnorm on txt_norm's (B, 1396, 3584) rows
    and the text stream's 128-wide head rows in place, within one bf16 ulp;
    rotembd bit-exact on the edit's scale_rope tables over the 1396 + 4096 +
    4096 joint; sdpa there as the long cases; the W4A4 quantizer, unpack and
    GEMM bit-exact at M = 1396 * B (a tail tile) for each text-stream
    linear."""
    from fastdm_tpu_torch.kernels import cuda_backend, torch_backend
    from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, qwen_rope_cos_sin

    cfg = QwenImageConfig()
    d, h, hd, t = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim, QWEN_EDIT_TEXT
    g = torch.Generator(device=cuda_device).manual_seed(19)
    x = (torch.randn(batch, t, cfg.joint_attention_dim, generator=g, device=cuda_device) * 3
         ).bfloat16()
    gamma = (1 + 0.05 * torch.randn(cfg.joint_attention_dim, generator=g, device=cuda_device)
             ).bfloat16()
    got, want = cuda_backend.rms_norm_cuda(x, gamma, 1e-6), torch_backend.rms_norm_torch(
        x, gamma, 1e-6)
    assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()
    s = t + 2 * QWEN_EDIT_IMAGE
    qkv = torch.randn(batch, s, 3 * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
    gamma = (1 + 0.05 * torch.randn(hd, generator=g, device=cuda_device)).bfloat16()
    heads = qkv[:, :t, :d].unflatten(-1, (h, hd))
    got, want = cuda_backend.rms_norm_cuda(heads, gamma, 1e-6), torch_backend.rms_norm_torch(
        heads, gamma, 1e-6)
    assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()
    cos, sin = qwen_rope_cos_sin(cfg, 1, 64, 64, t, extra_shapes=((1, 64, 64),),
                                 device=cuda_device)
    q, k, v = (qkv[..., i * d:(i + 1) * d].contiguous() for i in range(3))
    rq, rk = cuda_backend.rotary_pos_embedding_cuda(q, k, hd, cos, sin, False)
    wq, wk = torch_backend.rotary_pos_embedding_torch(q, k, hd, cos, sin, False)
    assert torch.equal(rq, wq) and torch.equal(rk, wk)
    got = cuda_backend.sdpa_cuda(rq, rk, v, h, h, hd).float()
    want = torch_backend.sdpa_torch(rq, rk, v, h, h, hd).float()
    assert ((got - want).abs() <= 1e-3 + 2 * _bf16_ulp(want)).all()
    assert (got - want).norm() / want.norm() <= 5e-3
    for kk, n in QWEN_TEXT_W4A4.values():
        x, xq, xs, w, lin = _w4a4_operands(t * batch, kk, n, cuda_device)
        for a, b in zip(cuda_backend.quantize_to_int4_cuda(x),
                        torch_backend.quantize_to_int4_torch(x)):
            assert torch.equal(a, b)
        assert torch.equal(cuda_backend.unpack_int4_cuda(lin.w4p), w)
        args = (xq, w, xs, lin.scale, torch.bfloat16, lin.bias)
        assert torch.equal(cuda_backend.int4_matmul_cuda(*args),
                           torch_backend.int4_matmul_torch(*args))


@pytest.mark.gpu
def test_qwen2_5_vl_two_layers_on_card_match_cpu(cuda_device):
    """Qwen2.5-VL-7B's widths cut to two language-model layers and two
    vision blocks (the second a full-attention one), drawn on the card: a
    prompt with one 224x308 image (16 x 22 patches, partial windows) on the
    card against the same modules on the CPU, f32 without TF32, within
    relative L2 1e-4 (f32 sums in another order; a wrong layer is O(1)); no
    kernel of the port launched."""
    import dataclasses

    from fastdm_tpu_torch.kernels import cuda_backend
    from fastdm_tpu_torch.models import qwen2_5_vl as tvl
    from fastdm_tpu_torch.pipeline.image_processor import Qwen2VLImageProcessor

    base = tvl.Qwen2_5_VLConfig()
    cfg = dataclasses.replace(base, num_hidden_layers=2, vision=dataclasses.replace(
        base.vision, depth=2, fullatt_block_indexes=(1,)))
    assert not torch.backends.cuda.matmul.allow_tf32
    gpu = tvl.qwen2_5_vl_init_random(5, cfg, device=cuda_device)
    with torch.device("meta"):
        cpu = tvl.Qwen2_5_VLModel(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    img = np.random.default_rng(5).integers(0, 256, (224, 308, 3), dtype=np.uint8)
    pixels, grid = Qwen2VLImageProcessor()(img)
    n = int(grid.prod()) // 4
    ids = np.array([[151644, 872, 198, 151652] + [151655] * n + [151653, 1000, 2000, 151645]])
    mask = np.ones_like(ids)
    cuda_backend.reset_launch_counts()
    with torch.inference_mode():
        got = gpu(ids, mask, torch.from_numpy(pixels), grid)
        want = cpu(ids, mask, torch.from_numpy(pixels), grid)
    assert sum(f.launches for f in (cuda_backend.sdpa_cuda, cuda_backend.rms_norm_cuda)) == 0
    assert (got.cpu() - want).norm() / want.norm() <= 1e-4


# ------------------------------------------------------------ tensor parallelism

# (M, K) rows of a row-parallel rank: FLUX's to_out at tp 4 (768 of 3072), its
# single-block proj_out at tp 2 (7680 of 15360), one modulation token, and
# Wan2.2-A14B's ffn.out at tp 4 (3456 of 13824)
TP_ROWS = {"flux-to-out-tp4": (333, 768), "flux-proj-out-tp2": (128, 7680),
           "token": (1, 3072), "wan-ffn-out-tp4": (77, 3456)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(TP_ROWS))
def test_tp_quantizers_bit_exact_on_card(cuda_device, shape):
    """The statistics pass and the given-statistics quantizers (int8 asym /
    sym, fp8, int4) bit-exact with their plain versions, and on two column
    shards with their statistics reduced by MAX bit for bit the one-device
    quantizer's values on those columns, its scales and zero points."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb, torch_backend as tb

    m, k = TP_ROWS[shape]
    g = torch.Generator(device=cuda_device).manual_seed(21)
    x = (torch.randn(m, 2 * k, generator=g, device=cuda_device) * 3).bfloat16()
    x[0, :k] = 0  # a shard row of zeros
    halves = [x[:, :k].contiguous(), x[:, k:].contiguous()]
    cb.reset_launch_counts()
    for sym in (True, False):
        stats = [cb.quantize_stats_cuda(h, sym) for h in halves]
        for st, h in zip(stats, halves):
            assert torch.equal(st, tb.quantize_stats_torch(h, sym))
        red = torch.maximum(*stats)
        whole = {"int8": cb.quantize_to_int8_cuda(x, sym)}
        given = {"int8": [cb.quantize_to_int8_given_cuda(h, red, sym) for h in halves]}
        plain = {"int8": [tb.quantize_to_int8_given_torch(h, red, sym) for h in halves]}
        if sym:
            whole.update(fp8=cb.quantize_to_fp8_cuda(x), int4=cb.quantize_to_int4_cuda(x))
            given.update(fp8=[cb.quantize_to_fp8_given_cuda(h, red) for h in halves],
                         int4=[cb.quantize_to_int4_given_cuda(h, red) for h in halves])
            plain.update(fp8=[tb.quantize_to_fp8_given_torch(h, red) for h in halves],
                         int4=[tb.quantize_to_int4_given_torch(h, red) for h in halves])
        for name, w in whole.items():
            for i, (got, ref) in enumerate(zip(given[name], plain[name])):
                cols = slice(i * k, (i + 1) * k)
                assert torch.equal(got[0].view(torch.int8), ref[0].view(torch.int8)), name
                assert torch.equal(got[0].view(torch.int8), w[0][:, cols].view(torch.int8))
                for a, b, c in zip(got[1:], ref[1:], w[1:]):
                    assert (a is None and b is None and c is None) or (
                        torch.equal(a, b) and torch.equal(a, c)), name
    assert cb.quantize_stats_cuda.launches == 4
    assert cb.quantize_to_int8_given_cuda.launches == 4
    assert (cb.quantize_to_fp8_given_cuda.launches, cb.quantize_to_int4_given_cuda.launches) \
        == (2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(TP_ROWS))
def test_tp_partial_gemms_on_card(cuda_device, shape):
    """The f32 row partials: int8 (with and without the zero point) and int4
    bit-exact with their plain versions, fp8 within 2^-14 of sum |a| |b|
    (Hopper's fp8 wgmma sums a k32 step in about 14 bits, DeepSeek-V3's
    report; the kernel adds each step into f32); two shards' partials
    summed, plus the bias, within 1 bf16 ulp (plus that bound) of the
    one-device bf16 GEMM."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb, torch_backend as tb
    from fastdm_tpu_torch.layers.qlinear import quantize_weight
    from fastdm_tpu_torch.parallel.tensor_parallel import qlinear_split_rows

    m, k = TP_ROWS[shape]
    n = 384
    g = torch.Generator(device=cuda_device).manual_seed(22)
    x = (torch.randn(m, 2 * k, generator=g, device=cuda_device) * 2).bfloat16()
    w = torch.randn(2 * k, n, generator=g, device=cuda_device) * 0.05
    b = torch.randn(n, generator=g, device=cuda_device) * 0.1
    halves = [x[:, :k].contiguous(), x[:, k:].contiguous()]
    for quant in ("int8", "fp8", "int4"):
        lin = quantize_weight(w, quant, b)
        shards = [qlinear_split_rows(lin, [(2 * k, 1)], 2, r) for r in range(2)]
        sym = quant != "int8"
        red = torch.maximum(*(cb.quantize_stats_cuda(h, sym) for h in halves))
        parts, bound = [], 0.0
        for h, s in zip(halves, shards):
            if quant == "int8":
                xq, xs, xzp = cb.quantize_to_int8_given_cuda(h, red, False)
                for zp in (None, xzp):  # the zero point's term last: the layer's partial
                    args = (xq, s.w, xs, s.scale, s.colsum, zp)
                    got = cb.int8_matmul_partial_cuda(*args)
                    assert got.dtype == torch.float32
                    assert torch.equal(got, tb.int8_matmul_partial_torch(*args))
                parts.append(got)
            elif quant == "int4":
                xq, xs = cb.quantize_to_int4_given_cuda(h, red)
                args = (xq, s.w4, xs, s.scale)
                got = cb.int4_matmul_partial_cuda(*args)
                assert torch.equal(got, tb.int4_matmul_partial_torch(*args))
                parts.append(got)
            else:
                xq, xs = cb.quantize_to_fp8_given_cuda(h, red)
                args = (xq, s.w, xs, s.scale)
                got = cb.fp8_matmul_partial_cuda(*args)
                ref = tb.fp8_matmul_partial_torch(*args)
                mag = (xs * s.scale[None, :]) * (xq.float().abs() @ s.w.float().abs())
                bound = bound + 2.0**-14 * mag
                assert ((got - ref).abs() <= 2.0**-14 * mag + 1e-30).all()
                parts.append(got)
        total = (parts[0] + parts[1] + b.bfloat16().float()).bfloat16().float()
        if quant == "int8":
            xq, xs, xzp = cb.quantize_to_int8_cuda(x, False)
            one = cb.int8_matmul_cuda(xq, lin.w, xs, lin.scale, torch.bfloat16, lin.colsum, xzp,
                                      lin.bias).float()
        elif quant == "int4":
            xq, xs = cb.quantize_to_int4_cuda(x)
            one = cb.int4_matmul_cuda(xq, lin.w4, xs, lin.scale, torch.bfloat16,
                                      lin.bias).float()
        else:
            xq, xs = cb.quantize_to_fp8_cuda(x)
            one = cb.fp8_matmul_cuda(xq, lin.w, xs, lin.scale, torch.bfloat16, lin.bias).float()
        # one bf16 ulp, plus the f32 roundings of the two partials where they cancel
        tol = _bf16_ulp(one) + 2.0**-22 * (parts[0].abs() + parts[1].abs()) + 2 * bound
        assert ((total - one).abs() <= tol).all(), quant


@pytest.mark.gpu
@pytest.mark.parametrize("heads,hd", [(40, 128), (24, 128), (5, 6)])
def test_tp_norm_kernels_on_card(cuda_device, heads, hd):
    """rms_sumsq within f32 rounding (1e-5 relative) of the plain sum;
    rms_norm_given within one bf16 ulp and qk_norm_rope_given /
    qk_norm_rope2_given within the qk_norm_rope tolerance of their plain
    versions, in both pair layouts, the fused and two-operand forms
    bit-identical; on a rank's heads with the whole row's statistic, the
    whole-row kernels' values on its columns within the same tolerances."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb, torch_backend as tb

    b, s = 2, 77
    d = heads * hd
    tp = 5 if heads == 5 else 4
    per = d // tp
    g = torch.Generator(device=cuda_device).manual_seed(23)
    qkv = (torch.randn(b, s, 3 * d, generator=g, device=cuda_device) * 2).bfloat16()
    gq = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).bfloat16()
    gk = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).bfloat16()
    cos, sin = _rope_tables(s, hd, cuda_device)
    q, k = qkv[..., :d], qkv[..., d:2 * d]
    whole_st = cb.rms_sumsq_cuda(qkv[..., :2 * d].unflatten(-1, (2, d)))
    ref_st = tb.rms_sumsq_torch(qkv[..., :2 * d].unflatten(-1, (2, d)))
    assert ((whole_st - ref_st).abs() <= 1e-5 * ref_st).all()
    cols = slice(0, per)  # rank 0's heads
    local = torch.cat([q[..., cols], k[..., cols], qkv[..., 2 * d:][..., cols]], dim=-1)
    got = cb.rms_norm_given_cuda(q[..., cols], gq[cols], whole_st[..., 0], d, 1e-6)
    want = tb.rms_norm_given_torch(q[..., cols], gq[cols], whole_st[..., 0], d, 1e-6)
    assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()
    whole = cb.rms_norm_cuda(q.contiguous(), gq, 1e-6)[..., cols]
    assert ((got.float() - whole.float()).abs() <= _bf16_ulp(whole)).all()
    for neox in (False, True):
        fused = cb.qk_norm_rope_given_cuda(local, gq[cols], gk[cols], hd, cos, sin, whole_st, d,
                                           neox, inner_dim=per)
        split = cb.qk_norm_rope2_given_cuda(q[..., cols], k[..., cols], gq[cols], gk[cols], hd,
                                            cos, sin, whole_st, d, neox)
        plain = tb.qk_norm_rope_given_torch(local, gq[cols], gk[cols], hd, cos, sin, whole_st,
                                            d, neox, inner_dim=per)
        one = cb.qk_norm_rope_cuda(qkv, gq, gk, hd, cos, sin, neox, inner_dim=d)
        for a, c, p, o in zip(fused, split, plain, one):
            assert torch.equal(a, c)
            assert (_pair_ulp_excess(a, p, hd if neox else 0) <= 0).all(), neox
            assert (_pair_ulp_excess(a, o[..., cols], hd if neox else 0) <= 0).all(), neox


@pytest.mark.gpu
def test_tp_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from fastdm_tpu_torch.kernels import cuda_backend as cb

    x = torch.zeros(4, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="stats must be float32"):
        cb.quantize_to_int8_given_cuda(x, torch.zeros(4, 1, device=cuda_device), False)
    with pytest.raises(ValueError, match="sumsq must be float32"):
        cb.rms_norm_given_cuda(x, None, torch.zeros(4, dtype=torch.float64, device=cuda_device),
                               64, 1e-6)
    with pytest.raises(ValueError, match="n_total"):
        cb.rms_norm_given_cuda(x, None, torch.zeros(4, device=cuda_device), 32, 1e-6)
    a = torch.zeros(4, 64, dtype=torch.int8, device=cuda_device)
    w = torch.zeros(8, 64, dtype=torch.int8, device=cuda_device).t()
    s = torch.ones(4, 1, device=cuda_device)
    with pytest.raises(ValueError, match="float32 without a bias"):
        cb._w8a8_gemm("int8_matmul_partial", cb.int8_matmul_partial_cuda, a, w, s,
                      torch.ones(8, device=cuda_device), torch.float32, None, None,
                      torch.zeros(8, dtype=torch.bfloat16, device=cuda_device), fp8=False,
                      partial=True)
    with pytest.raises(ValueError, match="must be bfloat16"):
        cb.int8_matmul_cuda(a, w, s, torch.ones(8, device=cuda_device), torch.float32,
                            torch.zeros(8, dtype=torch.int32, device=cuda_device), None)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "int4p", "fp8"])
def test_flux_blocks_over_virtual_tp_on_card(cuda_device, quant):
    """Two FLUX blocks of each kind at the full width (24 x 128 heads), int8
    / int4p / fp8 with quant_mods, run as 2 virtual tp ranks on the card:
    every rank's output identical, within relative L2 1e-2 of the unsplit
    blocks, every tp kernel of the format launched."""
    import copy

    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_init_random, flux_rope_cache, \
        flux_run_blocks
    from fastdm_tpu_torch.parallel.tensor_parallel import run_virtual_ranks, shard_model, \
        virtual_groups

    cfg = FluxConfig(num_layers=1, num_single_layers=1, quant=quant, quant_mods=True)
    model = flux_init_random(3, cfg, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(24)
    h = torch.randn(1, 256, 3072, generator=g, device=cuda_device).bfloat16()
    e = torch.randn(1, 64, 3072, generator=g, device=cuda_device).bfloat16()
    t = torch.randn(1, 3072, generator=g, device=cuda_device).bfloat16()
    cos, sin = flux_rope_cache(cfg, 64, 16, 16, device=cuda_device)
    with torch.inference_mode():
        want = flux_run_blocks(model, cfg, h, e, t, cos, sin)
    groups = virtual_groups(2)
    shards = [shard_model(copy.deepcopy(model), cfg, gr) for gr in groups]
    cb.reset_launch_counts()
    outs = run_virtual_ranks(lambda r: flux_run_blocks(shards[r], cfg, h, e, t, cos, sin), groups)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert ((outs[0].float() - want.float()).norm() / want.float().norm()).item() <= 1e-2
    quantizer = {"int8": cb.quantize_to_int8_given_cuda, "fp8": cb.quantize_to_fp8_given_cuda,
                 "int4p": cb.quantize_to_int4_given_cuda}[quant]
    gemm = {"int8": cb.int8_matmul_partial_cuda, "fp8": cb.fp8_matmul_partial_cuda,
            "int4p": cb.int4_matmul_partial_cuda}[quant]
    assert min(cb.quantize_stats_cuda.launches, quantizer.launches, gemm.launches) > 0


# the Functions of kernels/autograd.py: (shape of q, heads, kv heads, head dim)
AUTOGRAD_CASES = {"rmsnorm": ((1, 1152, 3 * 3072), 24, 24, 128),
                  "rotembd": ((1, 1152, 3072), 24, 8, 128),
                  "sdpa": ((1, 1152, 3072), 24, 24, 128),
                  "sdpa-gqa": ((2, 300, 1024), 8, 2, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_autograd_functions_on_card(cuda_device, case):
    """Each Function with its forward on the kernel against torch.autograd of
    the plain version (plain_on_device): rotembd's output and gradients
    bit-exact (its backward is the kernel again, two launches); rmsnorm's dx
    (on the strided q heads of a fused projection) within one bf16 ulp plus
    1e-6 of the largest |dx| (the f32 formula cancels near 0); sdpa's dq, dk,
    dv within relative L2 1e-2 (the backward reads the kernel's output and
    log-sum-exp), the forward on sdpa_lse, bit-identical to sdpa."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import kernel_registry, rms_norm, rotary_pos_embedding, \
        scaled_dot_product_attention

    shape, hq, hkv, hd = AUTOGRAD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(30)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda_device, dtype=torch.bfloat16)

    b, s = shape[:2]
    if case == "rmsnorm":
        x = rnd(*shape)[..., :hq * hd].reshape(b, s, hq, hd).requires_grad_()
        w = (1 + 0.05 * torch.randn(hd, generator=g, device=cuda_device)).bfloat16()
        inputs, fn, op = (x,), lambda x: rms_norm(x, w, 1e-6), "rmsnorm"
    elif case == "rotembd":
        ang = torch.rand(s, hd // 2, generator=g, device=cuda_device) * 6.0
        cos, sin = ang.cos(), ang.sin()
        inputs = (rnd(b, s, hq * hd).requires_grad_(), rnd(b, s, hkv * hd).requires_grad_())
        fn, op = (lambda q, k: rotary_pos_embedding(q, k, hd, cos, sin)), "rotembd"
    else:
        inputs = (rnd(b, s, hq * hd).requires_grad_(), rnd(b, s, hkv * hd).requires_grad_(),
                  rnd(b, s, hkv * hd).requires_grad_())
        fn, op = (lambda q, k, v: scaled_dot_product_attention(q, k, v, hq, hkv, hd)), "sdpa"
    cb.reset_launch_counts()
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [rnd(*o.shape) for o in outs]
    got = torch.autograd.grad(outs, inputs, cots)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in cb.KERNEL_WRAPPERS if w.launches}
    with kernel_registry.plain_on_device([op]):
        ref = fn(*inputs)
        refs = ref if isinstance(ref, tuple) else (ref,)
        want = torch.autograd.grad(refs, inputs, cots)
    if case == "rotembd":
        assert launches == {"rotary_pos_embedding_cuda": 2}
        assert all(torch.equal(a, r) for a, r in zip(outs + got, refs + want))
    elif case == "rmsnorm":
        assert launches == {"rms_norm_cuda": 1}
        e = (got[0].float() - want[0].float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(want[0].float().abs().clamp_min(1e-30))) - 7)
        assert (e <= ulp + 1e-6 * want[0].float().abs().max()).all()
    else:
        assert launches == {"sdpa_lse_cuda": 1}
        q, k, v = (t.detach() for t in inputs)
        assert torch.equal(out, cb.sdpa_cuda(q, k, v, hq, hkv, hd))
        for a, r in zip(got, want):
            assert torch.isfinite(a).all()
            assert ((a.float() - r.float()).norm() / r.float().norm()).item() <= 1e-2


@pytest.mark.gpu
def test_serving_and_ops_without_gradients_on_card(cuda_device):
    """Under no_grad the sdpa op launches sdpa (not sdpa_lse) and returns no
    grad_fn; an op without a Function refuses a gradient on the card instead
    of returning a kernel output that carries none; causal sdpa with a
    gradient raises."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import gelu_and_mul, scaled_dot_product_attention

    q = torch.randn(1, 256, 256, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    cb.reset_launch_counts()
    with torch.no_grad():
        out = scaled_dot_product_attention(q, q, q, 2, 2, 128)
    assert out.grad_fn is None and cb.sdpa_cuda.launches == 1 and cb.sdpa_lse_cuda.launches == 0
    with pytest.raises(NotImplementedError, match="no gradient"):
        gelu_and_mul(q)
    with pytest.raises(NotImplementedError, match="causal"):
        scaled_dot_product_attention(q, q, q, 2, 2, 128, True)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 96])
def test_sdpa_pads_small_head_dims_on_card(cuda_device, d):
    """A head dim the kernel does not tile runs zero-padded to 64 or 128:
    one launch, the output as the small cases, the log-sum-exp within 1e-3."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_lse_torch, sdpa_torch

    g = torch.Generator(device=cuda_device).manual_seed(41)
    q, k, v = (torch.randn(2, 80, 4 * d, generator=g, device=cuda_device, dtype=torch.bfloat16)
               for _ in range(3))
    cb.reset_launch_counts()
    got = cb.sdpa_cuda(q, k, v, 4, 4, d)
    out, lse = cb.sdpa_lse_cuda(q, k, v, 4, 4, d)
    assert cb.sdpa_cuda.launches == 1 and cb.sdpa_lse_cuda.launches == 1
    assert got.shape == q.shape and got.is_contiguous() and torch.equal(got, out)
    want = sdpa_torch(q, k, v, 4, 4, d).float()
    assert ((got.float() - want).abs() <= 1e-2 + 1e-2 * want.abs()).all()
    assert (lse - sdpa_lse_torch(q, k, v, 4, 4, d)[1]).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_on_card(cuda_device, n):
    """The ring under autograd over n virtual ranks at FLUX's training width
    (1152 tokens, 24 x 128): its forward n^2 sdpa_lse launches, its dq, dk,
    dv within relative L2 1e-2 of SDPAFn on the whole sequence."""
    from fastdm_tpu_torch.kernels import cuda_backend as cb
    from fastdm_tpu_torch.kernels import scaled_dot_product_attention
    from fastdm_tpu_torch.parallel import cp_state
    from fastdm_tpu_torch.parallel.context_parallel import VirtualRing

    g = torch.Generator(device=cuda_device).manual_seed(42)
    q, k, v, cot = (torch.randn(1, 1152, 24 * 128, generator=g, device=cuda_device,
                                dtype=torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(scaled_dot_product_attention(q, k, v, 24, 24, 128), (q, k, v),
                               cot)
    cb.reset_launch_counts()
    with cp_state.cp_ring(VirtualRing(n)):
        out = scaled_dot_product_attention(q, k, v, 24, 24, 128)
    assert cb.sdpa_lse_cuda.launches == n * n and cb.sdpa_cuda.launches == 0
    got = torch.autograd.grad(out, (q, k, v), cot)
    for a, r in zip(got, want):
        assert torch.isfinite(a).all()
        assert ((a.float() - r.float()).norm() / r.float().norm()).item() <= 1e-2


@pytest.mark.gpu
def test_virtual_tp_training_step_finishes_on_card(cuda_device):
    """Two virtual tp ranks train through their backward collectives on one
    card: each thread runs its own backward (run_virtual_ranks(grad=True)),
    so no rank waits in a collective behind another on autograd's device
    thread. JAX's tiny dryrun at mesh (1, 1, 2)."""
    from fastdm_tpu_torch.parallel.mesh import flux_dryrun_step

    loss, grads = flux_dryrun_step(mesh_shape=(1, 1, 2), device="cuda")
    assert sorted(grads) == [0, 1] and loss > 0
    assert all(torch.isfinite(t).all() for g in grads.values() for t in g.values())
