"""What the CPU can check of the port's Hopper kernels that load through the
Tensor Memory Accelerator (csrc/fp8_gemm.cu, csrc/w8a8_gemm.cu over
csrc/w8a8_sm90.cuh, csrc/flash_attn.cu, csrc/sm90.cuh): the tensor-map
geometry the attention wrappers (dense sdpa, the mask, coarse, superblock and
fine walks) compute from their operand views (kernels/tma.py) against the
strides of real CPU tensor views, the build list and the library hash, and
which C launcher, with which arguments, the W8A8, attention and qk-norm+RoPE
wrappers pick; the path and block shape the rmsnorm and rotembd wrappers
choose for csrc/rmsnorm.cu and csrc/rope.cu (rms_norm_plan, rope_plan) and
the arguments they pass. Nothing is built or launched here; the kernels themselves are
held to their plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from fastdm_tpu_torch.kernels import build, cuda_backend, kernel_registry
from fastdm_tpu_torch.kernels.tma import ATTN_ROWS, HALF_ROWS, attention_geometry, walk_rows
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)


def _element_at(view: torch.Tensor, geom, coord) -> torch.Tensor:
    """The element a tensor map with `geom` over view's data pointer reads at
    coord (innermost first), found through the byte strides alone in the
    buffer the view lies in."""
    es = view.element_size()
    byte_off = coord[0] * es + sum(c * s for c, s in zip(coord[1:], geom.strides))
    assert byte_off % es == 0
    flat = view.as_strided((view.untyped_storage().nbytes() // es,), (1,), 0)
    return flat[view.storage_offset() + byte_off // es]


@pytest.mark.parametrize("head_dim", [64, 128])
def test_attention_geometry_of_a_contiguous_view(head_dim):
    b, s, h = 2, 300, 4
    t = torch.zeros(b, s, h * head_dim, dtype=torch.bfloat16)
    g = attention_geometry(t, head_dim)
    assert g.dims == (h * head_dim, s, b)
    assert g.strides == (h * head_dim * 2, s * h * head_dim * 2)
    assert g.box == (64, ATTN_ROWS, 1)  # one 128-byte swizzle atom of columns
    assert g.packed() == (*g.dims, *g.strides, *g.box)


def test_attention_geometry_of_fused_projection_slices():
    """q|k|v column slices of one (B, S, 3C) projection, cut to fewer rows than
    the buffer holds: the S extent is the view's, the strides the buffer's."""
    b, s_buf, s, c, hd = 2, 90, 77, 640, 64
    qkv = torch.zeros(b, s_buf, 3 * c, dtype=torch.bfloat16)
    for i in range(3):
        view = qkv[:, :s, i * c:(i + 1) * c]
        g = attention_geometry(view, hd)
        assert g.dims == (c, s, b)  # not s_buf: the tail tile is zero-filled
        assert g.strides == (3 * c * 2, s_buf * 3 * c * 2)
        assert all(x % 16 == 0 for x in g.strides)  # TMA's stride rule
        assert view.data_ptr() % 16 == 0  # and its base-address rule


@pytest.mark.parametrize("fused", [False, True])
def test_geometry_addresses_the_heads_of_the_view(fused):
    """Head h's tile starts at coordinate (h*D + 64a, row, b): every such
    coordinate, walked through the geometry's strides from the view's data
    pointer, lands on view[b, row, h*D + 64a + col]; GQA's kv heads alike."""
    rng = np.random.default_rng(0)
    b, s, hq, hkv, d = 2, 130, 4, 2, 128
    width = (hq + 2 * hkv) * d
    buf = torch.from_numpy(rng.standard_normal((b, s, width)).astype(np.float32)).bfloat16()
    if fused:
        views = {"q": (buf[..., :hq * d], hq), "k": (buf[..., hq * d:(hq + hkv) * d], hkv),
                 "v": (buf[..., (hq + hkv) * d:], hkv)}
    else:
        views = {"q": (buf[..., :hq * d].contiguous(), hq),
                 "k": (buf[..., hq * d:(hq + hkv) * d].contiguous(), hkv)}
    for name, (view, heads) in views.items():
        g = attention_geometry(view, d)
        assert g.dims == (heads * d, s, b)
        for _ in range(50):
            hh, a, col = rng.integers(heads), rng.integers(d // 64), rng.integers(64)
            row, bb = rng.integers(s), rng.integers(b)
            c0 = hh * d + a * g.box[0] + col
            got = _element_at(view, g, (c0, row, bb))
            assert torch.equal(got, view[bb, row, c0]), (name, hh, a, col, row, bb)


def test_attention_geometry_of_one_batch_entry_and_rejections():
    t = torch.zeros(1, 40, 2 * 64, dtype=torch.bfloat16)
    g = attention_geometry(t, 64)
    assert g.dims == (128, 40, 1) and g.strides == (256, 40 * 256)
    with pytest.raises(ValueError, match="contiguous last dim"):
        attention_geometry(t.transpose(1, 2), 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        attention_geometry(torch.zeros(1, 8, 4 * 32, dtype=torch.bfloat16), 32)


def test_build_lists_the_fp8_gemm_and_the_shared_header():
    assert "fp8_gemm" in build.SOURCES and "w8a8_gemm" in build.SOURCES
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
    assert '#include "sm90.cuh"' in (build.CSRC / "flash_attn.cu").read_text()
    assert '#include "sm90.cuh"' in (build.CSRC / "w8a8_sm90.cuh").read_text()
    for name in ("fp8_gemm", "w8a8_gemm"):  # both GEMMs on the one ring
        assert '#include "w8a8_sm90.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    assert (build.CSRC / "sm90.cuh").exists()


def _csrc_files():
    return sorted((*build.CSRC.glob("*.cu"), *build.CSRC.glob("*.cuh")))


def test_no_mma_sync_int8_gemm_or_coarse_walk_remains():
    """No kernel issues the warp-level mma.sync, ldmatrix or cp.async of the
    retired attention tile: the int8 GEMM issues wgmma (s32.s8.s8) only, and
    every attention walk runs on flash_attn.cu."""
    for f in _csrc_files():
        text = f.read_text()
        for instruction in ("mma.sync", "ldmatrix.sync", "cp.async.cg"):
            assert instruction not in text, (f.name, instruction)
    assert "s32.s8.s8" in (build.CSRC / "sm90.cuh").read_text()
    assert "CoarseTables" in (build.CSRC / "flash_attn.cu").read_text()
    assert not (build.CSRC / "gather_attn.cu").exists()
    assert "gather_attn" not in build.SOURCES


@pytest.mark.parametrize("source,name,present", [
    ("*", "mma.sync", False), ("*", "attn_tile.cuh", False),
    ("*", "fdm_gather_dense", False), ("*", "fdm_sparse_mask_fwd", False),
    ("flash_attn.cu", "MaskTables", True), ("flash_attn.cu", "CoarseTables", True),
    ("flash_attn.cu", "SuperTables", True), ("flash_attn.cu", "FineTables", True),
    ("flash_attn.cu", "fdm_flash_attn_mask_fwd", True),
    ("flash_attn.cu", "fdm_flash_attn_coarse_fwd", True),
    ("flash_attn.cu", "fdm_flash_attn_super_fwd", True),
    ("flash_attn.cu", "fdm_flash_attn_fine_fwd", True)])
def test_superblock_and_fine_walks_left_the_mma_sync_tile(source, name, present):
    """The four table walks (mask, coarse, superblock, fine) and their
    exports live in the wgmma + TMA kernel of flash_attn.cu; the mma.sync
    tile (attn_tile.cuh), its dense walk and the old mask export are gone from
    every csrc/ file ("*")."""
    if source == "*":
        assert not any(name in f.read_text() for f in _csrc_files())
    else:
        assert (name in (build.CSRC / source).read_text()) == present


def test_library_path_changes_when_sm90_header_changes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert before["fp8_gemm"].name.startswith("fp8_gemm-")
    assert before == {name: build.library_path(name) for name in build.SOURCES}  # stable
    (csrc / "sm90.cuh").write_text((csrc / "sm90.cuh").read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after[name] != before[name] for name in build.SOURCES)


def test_w8a8_wrapper_picks_its_launcher_by_operand_type(monkeypatch):
    picked = []

    def fake_entry(lib_name, fn_name, argtypes):
        picked.append((lib_name, fn_name, len(argtypes)))
        return None, None

    monkeypatch.setattr(cuda_backend, "_entry", fake_entry)
    cuda_backend._w8a8_entry(torch.float8_e4m3fn)
    cuda_backend._w8a8_entry(torch.int8)
    # fp8: a, b, scale_a, scale_b, bias, out, m, n, k, lda, ldb, stream;
    # int8 adds azp and colsum
    assert picked == [("fp8_gemm", "fdm_fp8_gemm", 12), ("w8a8_gemm", "fdm_w8a8_gemm", 14)]


@pytest.mark.parametrize("block_q,rows", [(512, 128), (256, 128), (128, 128), (64, 64),
                                          (192, 64), (320, 64)])
def test_walk_rows_keep_each_block_in_one_table_row(block_q, rows):
    """A block of a table walk takes 128 query rows when block_q is a
    multiple of 128, else 64, and loads K / V in 64-key boxes; every block
    then lies inside one table row (row q0 // block_q)."""
    assert walk_rows(block_q) == (rows, HALF_ROWS)
    for q0 in range(0, 4 * block_q, rows):
        assert q0 // block_q == (q0 + rows - 1) // block_q


@pytest.mark.parametrize("block_q", [0, 32, 96, 100])
def test_walk_rows_reject_blocks_not_multiples_of_64(block_q):
    with pytest.raises(ValueError, match="multiple of 64"):
        walk_rows(block_q)


class _FakeLaunch:
    """Stands in for a ctypes launcher: records its arguments, returns 0, and
    (library, entry, argument count) of the last launcher looked up."""

    def __init__(self):
        self.args = None
        self.entry = None

    def __call__(self, *args):
        self.args = args
        return 0


def _fake_cuda_wrapper(monkeypatch):
    """Routes cuda_backend's launches to a _FakeLaunch, with CPU tensors
    passing the device checks, so the host-side arguments of a wrapper can
    be read on the CPU."""
    fake = _FakeLaunch()

    def entry(lib, fn, types):
        fake.entry = (lib, fn, len(types))
        return fake.entry, fake

    monkeypatch.setattr(cuda_backend, "_entry", entry)
    monkeypatch.setattr(cuda_backend, "_check_tensor", lambda *a: None)
    monkeypatch.setattr(cuda_backend, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    return fake


@pytest.mark.parametrize("block_q,block_k,q_rows", [(512, 1024, 128), (192, 320, 64)])
def test_coarse_wrapper_passes_the_walk_its_tables_and_box_rows(monkeypatch, block_q, block_k,
                                                                  q_rows):
    """gather_sparse_attention_cuda launches the coarse walk of flash_attn.cu
    with the table arguments first and q's box rows from walk_rows, K's and
    V's 64; the geometry it packs equals attention_geometry of each view."""
    fake = _fake_cuda_wrapper(monkeypatch)
    b, sq, skv, hq, hkv, d = 1, 700, 1300, 4, 2, 128
    q = torch.zeros(b, sq, hq * d, dtype=torch.bfloat16)
    kv = torch.zeros(b, skv, 2 * hkv * d, dtype=torch.bfloat16)
    k, v = kv[..., :hkv * d], kv[..., hkv * d:]
    nq, nk = -(-sq // block_q), -(-skv // block_k)
    idx = torch.zeros(nq, nk, dtype=torch.int32)
    cnt = torch.ones(nq, 1, dtype=torch.int32)
    cuda_backend.reset_launch_counts()
    out = cuda_backend.gather_sparse_attention_cuda(q, k, v, idx, cnt, hq, hkv, d,
                                                    block_q=block_q, block_k=block_k)
    assert out.shape == q.shape and cuda_backend.gather_sparse_attention_cuda.launches == 1
    args = fake.args
    assert args[:6] == (idx.data_ptr(), cnt.data_ptr(), nq, nk, block_q, block_k)
    geom = list(args[10])
    want = [x for t, r in ((q, q_rows), (k, HALF_ROWS), (v, HALF_ROWS))
            for x in attention_geometry(t, d, r).packed()]
    assert geom == want
    assert args[11:17] == (b, sq, skv, hq, hkv, d)
    assert args[-2] == 0  # not causal


@pytest.mark.parametrize("block_q,block_k,q_rows", [(128, 128, 128), (512, 1024, 128),
                                                  (192, 320, 64)])
def test_mask_wrapper_passes_the_walk_its_mask_and_box_rows(monkeypatch, block_q, block_k,
                                                            q_rows):
    """sparse_attention_cuda launches the mask walk of flash_attn.cu with the
    mask pointer, ni, nj, block_q and block_k first, q's box rows from
    walk_rows and K's and V's 64; not causal. It is a registered op, counted
    and reset like every wrapper."""
    fake = _fake_cuda_wrapper(monkeypatch)
    b, sq, skv, hq, hkv, d = 2, 700, 1300, 4, 2, 128
    q = torch.zeros(b, sq, hq * d, dtype=torch.bfloat16)
    kv = torch.zeros(b, skv, 2 * hkv * d, dtype=torch.bfloat16)
    k, v = kv[..., :hkv * d], kv[..., hkv * d:]
    ni, nj = -(-sq // block_q), -(-skv // block_k)
    mask = torch.ones(b, hq, ni, nj, dtype=torch.int32)
    assert cuda_backend.sparse_attention_cuda in cuda_backend.KERNEL_WRAPPERS
    assert kernel_registry._ops["sdpa_sparse"]["cuda"] is cuda_backend.sparse_attention_cuda
    cuda_backend.sparse_attention_cuda.launches = 3
    cuda_backend.reset_launch_counts()
    out = cuda_backend.sparse_attention_cuda(q, k, v, hq, hkv, d, sparse_mask=mask,
                                             block_q=block_q, block_k=block_k)
    assert out.shape == q.shape and cuda_backend.sparse_attention_cuda.launches == 1
    # mask, ni, nj, block_q, block_k, then q, k, v, out, the geometry, batch, sq, skv, hq,
    # hkv, D, out's two strides, scale, causal and stream
    assert fake.entry == ("flash_attn", "fdm_flash_attn_mask_fwd", 5 + 16)
    args = fake.args
    assert args[:5] == (mask.data_ptr(), ni, nj, block_q, block_k)
    assert list(args[9]) == [x for t, r in ((q, q_rows), (k, HALF_ROWS), (v, HALF_ROWS))
                             for x in attention_geometry(t, d, r).packed()]
    assert args[10:16] == (b, sq, skv, hq, hkv, d)
    assert args[-2] == 0  # not causal


def test_mask_wrapper_bounds_a_row_by_the_kernel_buffer(monkeypatch):
    """A mask row is packed into a fixed shared-memory bitmask of
    32 * MaskTables::kRowWords entries (flash_attn.cu); the wrapper rejects a
    longer row before the launch, and its limit is the kernel's."""
    import re

    text = (build.CSRC / "flash_attn.cu").read_text()
    words = int(re.search(r"struct MaskTables \{[^}]*kRowWords = (\d+);", text).group(1))
    assert cuda_backend.MASK_ROW_ENTRIES == 32 * words
    fake = _fake_cuda_wrapper(monkeypatch)
    hq, d, bk = 1, 64, 64
    for nj, ok in ((cuda_backend.MASK_ROW_ENTRIES, True), (cuda_backend.MASK_ROW_ENTRIES + 1,
                                                           False)):
        q = torch.zeros(1, 64, hq * d, dtype=torch.bfloat16)
        k = torch.zeros(1, nj * bk, hq * d, dtype=torch.bfloat16)
        mask = torch.ones(1, hq, 1, nj, dtype=torch.int32)
        fake.args = None
        if ok:
            cuda_backend.sparse_attention_cuda(q, k, k, hq, hq, d, sparse_mask=mask, block_q=64,
                                               block_k=bk)
            assert fake.args[2] == nj
        else:
            with pytest.raises(ValueError, match="exceeds the kernel's"):
                cuda_backend.sparse_attention_cuda(q, k, k, hq, hq, d, sparse_mask=mask,
                                                   block_q=64, block_k=bk)
            assert fake.args is None


@pytest.mark.parametrize("form", ["fused", "split"])
@pytest.mark.parametrize("gamma", ["bf16", "f32", None])
def test_qk_wrappers_pass_the_norm_weights_own_storage(monkeypatch, form, gamma):
    """qk_norm_rope_cuda and qk_norm_rope2_cuda hand the kernel the norm
    weights' own storage, with no f32 copy, and their dtype as gamma_kind
    (0 none, 1 bf16, 2 f32), then cos, sin, the outputs, B, S, D, head_size,
    the pair layout (0 interleaved, 1 half-split), eps and the stream;
    weights of two dtypes, or another dtype, are refused."""
    fake = _fake_cuda_wrapper(monkeypatch)
    b, s, heads, hd = 2, 5, 3, 16
    d = heads * hd
    qkv = torch.zeros(b, s, 3 * d, dtype=torch.bfloat16)
    cos = sin = torch.zeros(s, hd // 2)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}[gamma]
    gq = gk = None
    if dt is not None:
        gq, gk = torch.ones(d, dtype=dt), torch.ones(d, dtype=dt)
    if form == "fused":
        wrapper = cuda_backend.qk_norm_rope_cuda
        wrapper(qkv, gq, gk, hd, cos, sin, inner_dim=d)
        lead = (qkv.data_ptr(), qkv.stride(0), qkv.stride(1))
        entry = "fdm_qk_norm_rope_bf16"
    else:
        wrapper = cuda_backend.qk_norm_rope2_cuda
        q, k = qkv[..., :d], qkv[..., d:2 * d]
        wrapper(q, k, gq, gk, hd, cos, sin)
        lead = (q.data_ptr(), k.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1))
        entry = "fdm_qk_norm_rope2_bf16"
    assert fake.entry == ("qk_norm_rope", entry, len(lead) + 14)
    args = fake.args
    n = len(lead)
    assert args[:n] == lead
    want = (None, None, 0) if dt is None else (gq.data_ptr(), gk.data_ptr(),
                                               {"bf16": 1, "f32": 2}[gamma])
    assert args[n:n + 3] == want
    assert args[n + 3:n + 5] == (cos.data_ptr(), sin.data_ptr())
    assert args[n + 7:n + 12] == (b, s, d, hd, 0)
    if form == "fused":
        wrapper(qkv, gq, gk, hd, cos, sin, is_neox=True, inner_dim=d)
    else:
        wrapper(q, k, gq, gk, hd, cos, sin, is_neox=True)
    assert fake.args[n + 7:n + 12] == (b, s, d, hd, 1)
    if dt is not None:
        operands = (qkv,) if form == "fused" else (qkv[..., :d], qkv[..., d:2 * d])
        kw = {"inner_dim": d} if form == "fused" else {}
        for bad in ((gq, gk.half()), (gq.half(), gk.half())):
            with pytest.raises(ValueError, match="share a dtype"):
                wrapper(*operands, *bad, hd, cos, sin, **kw)


@pytest.mark.parametrize("walk", ["super", "fine"])
@pytest.mark.parametrize("block_q,q_rows", [(256, 128), (512, 128), (192, 64)])
def test_super_and_fine_wrappers_pass_the_walk_its_tables_and_box_rows(monkeypatch, walk,
                                                                         block_q, q_rows):
    """gather_super_attention_cuda and gather_fine_attention_cuda launch their
    walk of flash_attn.cu with the CSR tables, n_slots, block_q, fine (and
    superblock) first, q's box rows from walk_rows (128 for a block_q that is
    a multiple of 128, else 64) and K's and V's 64; not causal."""
    fake = _fake_cuda_wrapper(monkeypatch)
    b, sq, skv, hq, hkv, d, fine, sb = 1, 700, 1300, 4, 2, 128, 128, 4
    q = torch.zeros(b, sq, hq * d, dtype=torch.bfloat16)
    kv = torch.zeros(b, skv, 2 * hkv * d, dtype=torch.bfloat16)
    k, v = kv[..., :hkv * d], kv[..., hkv * d:]
    nq, group = -(-sq // block_q), 2
    rows = torch.zeros(nq, 2, dtype=torch.int32)
    rows[:, 0] = torch.arange(nq) * group
    rows[:, 1] = 1
    idx = torch.zeros(nq * group, dtype=torch.int32)
    cuda_backend.reset_launch_counts()
    if walk == "super":
        wrapper, n_table = cuda_backend.gather_super_attention_cuda, 7
        per_entry = torch.ones(nq * group, dtype=torch.int32)  # sub-block bitmasks
        out = wrapper(q, k, v, idx, per_entry, rows, hq, hkv, d, block_q=block_q, group=group,
                      fine=fine, superblock=sb)
        want_sizes = (block_q, fine, sb)
    else:
        wrapper, n_table = cuda_backend.gather_fine_attention_cuda, 6
        per_entry = torch.full((nq * group,), fine, dtype=torch.int32)  # valid tokens
        out = wrapper(q, k, v, idx, per_entry, rows, hq, hkv, d, block_q=block_q,
                      group=group, fine=fine)
        want_sizes = (block_q, fine)
    assert out.shape == q.shape and wrapper.launches == 1
    # the table arguments, then q, k, v, out, the geometry, batch, sq, skv, hq, hkv, D, out's
    # two strides, scale, causal and stream
    assert fake.entry == ("flash_attn", f"fdm_flash_attn_{walk}_fwd", n_table + 16)
    args = fake.args
    assert args[:4] == (idx.data_ptr(), per_entry.data_ptr(), rows.data_ptr(), idx.shape[0])
    assert args[4:n_table] == want_sizes
    geom = list(args[n_table + 4])
    want = [x for t, r in ((q, q_rows), (k, HALF_ROWS), (v, HALF_ROWS))
            for x in attention_geometry(t, d, r).packed()]
    assert geom == want
    assert args[n_table + 5:n_table + 11] == (b, sq, skv, hq, hkv, d)
    assert args[-2] == 0  # not causal


def test_sdpa_wrapper_keeps_128_row_boxes(monkeypatch):
    fake = _fake_cuda_wrapper(monkeypatch)
    q = torch.zeros(2, 300, 4 * 64, dtype=torch.bfloat16)
    cuda_backend.sdpa_cuda(q, q, q, 4, 4, 64, True)
    assert list(fake.args[4]) == [x for _ in range(3)
                                  for x in attention_geometry(q, 64, ATTN_ROWS).packed()]
    assert fake.args[-2] == 1  # causal


def test_int8_wrapper_passes_shape_pitches_and_zero_point(monkeypatch):
    """int8_matmul_cuda hands the launcher m, n, k, a's row pitch (a strided
    view keeps its own), the weight buffer's row pitch and the stream; the
    zero-point pointers are NULL without azp."""
    fake = _fake_cuda_wrapper(monkeypatch)
    wide = torch.zeros(3, 96, dtype=torch.int8)
    w = torch.zeros(48, 64, dtype=torch.int8).t()  # the (K, N) view of an (N, K) buffer
    sa, sb = torch.ones(3, 1), torch.ones(48)
    colsum, azp = torch.zeros(48, dtype=torch.int32), torch.zeros(3, 1, dtype=torch.int32)
    for a, lda in ((wide[:, :64].contiguous(), 64), (wide[:, 16:80], 96)):
        for zp in (azp, None):
            cuda_backend.int8_matmul_cuda(a, w, sa, sb, torch.bfloat16, colsum, zp, None)
            assert len(fake.args) == 14
            assert fake.args[0] == a.data_ptr()
            assert fake.args[4:6] == ((azp.data_ptr(), colsum.data_ptr()) if zp is not None
                                      else (None, None))
            assert fake.args[8:] == (3, 48, 64, lda, 64, 0)  # m, n, k, lda, ldb, stream


def test_w4a4_wrappers_pass_their_launchers_shapes_and_pitches(monkeypatch):
    """int4_matmul_cuda takes the W4A4 entry of the int8 GEMM's library (no
    zero point: a, b, scale_a, scale_b, bias, out, m, n, k, lda, ldb, stream);
    quantize_to_int4_cuda the quantizer in mode 3; unpack_int4_cuda hands its
    kernel the packed buffer, a fresh (N, K) buffer, N and K/2, and returns
    that buffer's (K, N) view."""
    fake = _fake_cuda_wrapper(monkeypatch)
    wide = torch.zeros(3, 96, dtype=torch.int8)
    w = torch.zeros(48, 64, dtype=torch.int8).t()  # the (K, N) view of an (N, K) buffer
    sa, sb, bias = torch.ones(3, 1), torch.ones(48), torch.zeros(48, dtype=torch.bfloat16)
    a = wide[:, 16:80]
    cuda_backend.int4_matmul_cuda(a, w, sa, sb, torch.bfloat16, bias)
    assert fake.entry == ("w8a8_gemm", "fdm_w4a4_gemm", 12)
    assert fake.args[:5] == (a.data_ptr(), w.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                             bias.data_ptr())
    assert fake.args[6:] == (3, 48, 64, 96, 64, 0)  # m, n, k, lda, ldb, stream
    x = torch.zeros(5, 32, dtype=torch.bfloat16)
    q, scale = cuda_backend.quantize_to_int4_cuda(x)
    assert fake.entry == ("quant", "fdm_quantize_rows", 9)
    assert fake.args[2:4] == (5, 32) and fake.args[-2] == 3
    assert q.dtype == torch.int8 and tuple(q.shape) == (5, 32) and tuple(scale.shape) == (5, 1)
    buf = torch.zeros(48, 32, dtype=torch.int8)  # N = 48 rows of K/2 = 32 packed bytes
    for p, n in ((buf.t(), 48), (buf[8:20].t(), 12)):
        out = cuda_backend.unpack_int4_cuda(p)
        assert fake.entry == ("int4_pack", "fdm_unpack_int4", 5)
        assert fake.args[0] == p.data_ptr() and fake.args[2:] == (n, 32, 0)
        assert out.shape == (64, n) and out.stride() == (1, 64) and out.dtype == torch.int8
        assert fake.args[1] == out.data_ptr()


def test_w4a4_wrappers_and_pack_refuse_what_they_do_not_take(monkeypatch):
    """An odd K for pack_int4, a packed view whose row pitch is not K/2 (a
    slice along K) or that is N-contiguous, the wrong dtype, an activation
    row pitch that is not a multiple of 16 bytes or an N-contiguous weight:
    refused before any launch."""
    from fastdm_tpu_torch.layers.qlinear import pack_int4

    fake = _fake_cuda_wrapper(monkeypatch)
    with pytest.raises(ValueError, match="even K"):
        pack_int4(torch.zeros(63, 8, dtype=torch.int8))
    buf = torch.zeros(48, 32, dtype=torch.int8)
    for bad in (buf.t()[:16], buf.t().contiguous()):
        with pytest.raises(ValueError, match="contiguous"):
            cuda_backend.unpack_int4_cuda(bad)
    with pytest.raises(ValueError, match="int8"):
        cuda_backend.unpack_int4_cuda(buf.t().view(torch.uint8))
    w = torch.zeros(48, 64, dtype=torch.int8).t()
    sa, sb = torch.ones(3, 1), torch.ones(48)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_backend.int4_matmul_cuda(torch.zeros(3, 72, dtype=torch.int8)[:, :64], w, sa, sb,
                                      torch.bfloat16)
    with pytest.raises(ValueError, match="K-contiguous"):
        cuda_backend.int4_matmul_cuda(torch.zeros(3, 64, dtype=torch.int8), w.contiguous(), sa,
                                      sb, torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        cuda_backend.int4_matmul_cuda(torch.zeros(3, 64, dtype=torch.float8_e4m3fn), w, sa, sb,
                                      torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_backend.int4_matmul_cuda(torch.zeros(3, 64, dtype=torch.int8), w, sa, sb,
                                      torch.float32)
    assert fake.args is None


# (dim, rows per token, 16-byte aligned) -> (path, threads, rows per block):
# FLUX's per-head rows (24 heads of 128), head dims 64 and 256, 96 (12
# vectors: a group of 16 lanes), a 2-D input of many 128-wide rows, Wan2.2's
# 5120 and 3072 and the widest vector row 8192 (wide rows), then the tail: a
# row that is not 16-byte aligned, an odd number of vectors past 8192, a dim
# that is not a multiple of 8
RMS_PLANS = {
    (128, 24, True): (0, 384, 48), (64, 24, True): (0, 192, 48),
    (256, 1, True): (0, 1024, 64), (96, 40, True): (0, 320, 40),
    (128, 5000, True): (0, 512, 64), (5120, 32760, True): (1, 320, 1),
    (3072, 50, True): (1, 192, 1), (8192, 1, True): (1, 512, 1),
    (128, 24, False): (2, 0, 0), (8200, 1, True): (2, 0, 0),
    (130, 4, True): (2, 0, 0),
}


@pytest.mark.parametrize("dim,heads,aligned", sorted(RMS_PLANS))
def test_rms_norm_plan_picks_path_and_block(dim, heads, aligned):
    """csrc/rmsnorm.cu's head-row blocks cover whole tokens (up to 64 rows),
    two rows per thread in groups of a power of two >= dim / 8 lanes, whole
    warps; a wide row is one block of 2 vectors a thread."""
    plan = cuda_backend.rms_norm_plan(dim, heads, aligned)
    assert plan == RMS_PLANS[(dim, heads, aligned)]
    path, threads, rows = plan
    assert threads % 32 == 0 and threads <= 1024
    if path == cuda_backend.RMS_HEAD_ROWS:
        lanes = 1 << (dim // 8 - 1).bit_length()
        assert lanes >= dim // 8 and rows <= 2 * (threads // lanes)
        assert rows % heads == 0 or heads > cuda_backend.RMS_HEAD_ROWS_PER_BLOCK
    elif path == cuda_backend.RMS_WIDE_ROWS:
        assert threads * cuda_backend.RMS_WIDE_VECS * 8 >= dim > 256


@pytest.mark.parametrize("dim", [8, 40, 64, 96, 128, 136, 248, 256])
@pytest.mark.parametrize("heads", [1, 3, 24, 40, 64, 65, 32760])
def test_rms_norm_head_row_plan_covers_every_row_once(dim, heads):
    """The head-row kernel's mapping (group g of a block holds local rows g
    and g + groups; lane c holds columns 8c..8c+7) under the plan visits each
    (row, vector) of a block exactly once, with whole warps, never past
    1024 threads."""
    path, threads, rows = cuda_backend.rms_norm_plan(dim, heads, True)
    assert path == cuda_backend.RMS_HEAD_ROWS
    lanes = 1 << (dim // 8 - 1).bit_length()
    groups = threads // lanes
    seen = np.zeros((rows, dim // 8), int)
    for tid in range(threads):
        g, c = tid // lanes, tid % lanes
        for i in range(2):
            local = g + i * groups
            if c < dim // 8 and local < rows:
                seen[local, c] += 1
    assert (seen == 1).all() and threads % 32 == 0 and threads <= 1024


# (head_size, q + k heads, neox, aligned) -> (path, head slots, tokens per block)
ROPE_PLANS = {
    (128, 48, False, True): (0, 4, 4), (128, 48, True, True): (0, 8, 4),
    (64, 15, False, True): (0, 8, 4), (64, 15, True, True): (0, 15, 4),
    (128, 2, False, True): (0, 2, 8), (24, 4, False, True): (0, 4, 21),
    (24, 4, True, True): (1, 0, 0), (6, 5, False, True): (1, 0, 0),
    (128, 48, False, False): (1, 0, 0),
}


@pytest.mark.parametrize("key", sorted(ROPE_PLANS))
def test_rope_plan_picks_path_and_block(key):
    """csrc/rope.cu's vector path takes head dims that are multiples of 8
    (interleaved) or 16 (half-split) on 16-byte aligned rows: at most 64
    threads per token (column groups x head slots), whole tokens in blocks
    of at most 256 threads; anything else the tail."""
    head_size, heads, neox, aligned = key
    plan = cuda_backend.rope_plan(head_size, heads, neox, aligned)
    assert plan == ROPE_PLANS[key]
    path, slots, tokens = plan
    if path == cuda_backend.ROPE_VECTOR:
        groups = head_size // (16 if neox else 8)
        assert slots <= heads and groups * slots * tokens <= cuda_backend.ROPE_THREADS


@pytest.mark.parametrize("gamma", ["bf16", "f32", None])
@pytest.mark.parametrize("view", ["flux-heads", "wan-k-slice", "tail-130"])
def test_rms_norm_wrapper_passes_rows_and_weight_storage(monkeypatch, gamma, view):
    """rms_norm_cuda hands the kernel the input's own storage with its token
    and head strides (no copy of a strided view), the weight's own storage
    with no f32 copy and its dtype as gamma_kind (0 none, 1 bf16, 2 f32), and
    the plan's path and block shape; another weight dtype is refused."""
    fake = _fake_cuda_wrapper(monkeypatch)
    if view == "flux-heads":  # the q heads of a fused (B, S, 3*H*D) QKV output
        buf = torch.zeros(1, 10, 3 * 24 * 128, dtype=torch.bfloat16)
        x, rows, ts, hs, d = buf[..., :24 * 128].reshape(1, 10, 24, 128), 240, 3 * 24 * 128, \
            128, 128
        heads = 24
    elif view == "wan-k-slice":  # Wan's k = kv[..., :D] of the (B, 77, 2D) kv projection
        buf = torch.zeros(1, 77, 2 * 5120, dtype=torch.bfloat16)
        x, rows, ts, hs, d, heads = buf[..., :5120], 77, 0, 2 * 5120, 5120, 77
    else:
        x = torch.zeros(2, 3, 4, 130, dtype=torch.bfloat16)
        rows, ts, hs, d, heads = 24, 4 * 130, 130, 130, 4
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}[gamma]
    w = None if dt is None else torch.ones(d, dtype=dt)
    cuda_backend.reset_launch_counts()
    out = cuda_backend.rms_norm_cuda(x, w, 1e-6)
    assert out.shape == x.shape and cuda_backend.rms_norm_cuda.launches == 1
    assert fake.entry == ("rmsnorm", "fdm_rms_norm_bf16", 14)
    args = fake.args
    assert args[0] == x.data_ptr()
    assert args[1:3] == ((None, 0) if dt is None else (w.data_ptr(), {"bf16": 1, "f32": 2}[gamma]))
    assert args[3] == out.data_ptr()
    assert args[4:9] == (rows, heads, ts, hs, d)
    assert args[10:13] == cuda_backend.rms_norm_plan(d, heads, True)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cuda_backend.rms_norm_cuda(x, torch.ones(d, dtype=torch.float16), 1e-6)


@pytest.mark.parametrize("neox", [False, True])
def test_rope_wrapper_passes_layout_strides_and_plan(monkeypatch, neox):
    """rotary_pos_embedding_cuda takes the half-split (neox) layout on the
    card too: it passes the layout flag, q's and k's own storage with their
    batch and sequence strides (column slices of one fused projection, GQA
    head counts) and the plan's path and block shape."""
    fake = _fake_cuda_wrapper(monkeypatch)
    b, s, hq, hkv, d = 2, 9, 8, 2, 128
    qkv = torch.zeros(b, s, (hq + 2 * hkv) * d, dtype=torch.bfloat16)
    q, k = qkv[..., :hq * d], qkv[..., hq * d:(hq + hkv) * d]
    cos = sin = torch.zeros(s, d // 2)
    cuda_backend.reset_launch_counts()
    qo, ko = cuda_backend.rotary_pos_embedding_cuda(q, k, d, cos, sin, is_neox=neox)
    assert qo.shape == q.shape and ko.shape == k.shape
    assert cuda_backend.rotary_pos_embedding_cuda.launches == 1
    assert fake.entry == ("rope", "fdm_rope_bf16", 20)
    args = fake.args
    assert args[:2] == (q.data_ptr(), k.data_ptr())
    assert args[6:11] == (b, s, hq, hkv, d)
    assert args[11:15] == (qkv.stride(0), qkv.stride(1)) * 2
    assert args[15] == int(neox)
    assert args[16:19] == cuda_backend.rope_plan(d, hq + hkv, neox, True)


@pytest.mark.parametrize("keys", [4, 16])
def test_sdpa_plan_for_ip_adapter_keys_and_the_union_joint_query(monkeypatch, keys):
    """The IP-Adapter branch's k|v, column slices of the fused (2, keys, 2C)
    ipadp_kv output, map with the view's own extent (4 or 16 rows under a
    128-row box: the rest zero-filled) and the buffer's 16-byte-aligned row
    stride; the union ControlNet's 8705-row query (68 tiles of 128 and one
    row) maps with its 8705 rows; the launcher gets both row counts."""
    c, hd = 640, 64
    kv = torch.zeros(2, keys, 2 * c, dtype=torch.bfloat16)
    for i, view in enumerate((kv[..., :c], kv[..., c:])):
        g = attention_geometry(view, hd)
        assert g.dims == (c, keys, 2) and g.box == (64, ATTN_ROWS, 1)
        assert g.strides == (2 * c * 2, keys * 2 * c * 2)
        assert all(x % 16 == 0 for x in g.strides) and view.data_ptr() % 16 == 0
        assert _element_at(view, g, (hd + 3, keys - 1, 1)).item() == 0
        kv[1, keys - 1, i * c + hd + 3] = 7.0
        assert _element_at(view, g, (hd + 3, keys - 1, 1)).item() == 7.0
    fake = _fake_cuda_wrapper(monkeypatch)
    q = torch.zeros(2, 8192, c, dtype=torch.bfloat16)
    cuda_backend.sdpa_cuda(q, kv[..., :c], kv[..., c:], c // hd, c // hd, hd)
    assert fake.entry == ("flash_attn", "fdm_flash_attn_fwd", 16)
    geom = list(fake.args[4])
    assert geom == [x for t in (q, kv[..., :c], kv[..., c:])
                    for x in attention_geometry(t, hd).packed()]
    assert geom[8:11] == [c, keys, 2]  # k's dims: the view's 4 or 16 rows
    assert fake.args[5:11] == (2, 8192, keys, c // hd, c // hd, hd)
    joint = torch.zeros(1, 8705, 3 * 3072, dtype=torch.bfloat16)
    jq, jk, jv = joint.split(3072, dim=-1)
    cuda_backend.sdpa_cuda(jq, jk, jv, 24, 24, 128)
    assert list(fake.args[4])[:8] == [3072, 8705, 1, 9216 * 2, 8705 * 9216 * 2, 64, ATTN_ROWS, 1]
    assert fake.args[5:11] == (1, 8705, 8705, 24, 24, 128)
    assert -(-8705 // ATTN_ROWS) == 69 and 8705 - 68 * ATTN_ROWS == 1
