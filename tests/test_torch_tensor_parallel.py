"""Tensor parallelism of the port (fastdm_tpu_torch/parallel/tensor_parallel.py
and the tp rules of parallel/mesh.py) against the JAX engine's tp: JAX's
shard_params_by_name placement on conftest's virtual CPU devices, GSPMD
inserting the collectives. torch.distributed runs for real: gloo worker
pools (tests/torch_parallel_workers.py, no JAX there); the splits and the
norms are also checked over virtual ranks in one process (threads).

Tolerances:
  * column shards: concatenated, bit for bit the whole layer's output;
  * row shards: the quantized values, scales and zero points of every rank
    bit for bit the whole row's on its columns; the output within 2 bf16 ulp
    of the whole layer's plus 2e-3 of its largest magnitude (f32 partial
    sums in another order; the int4 low-rank intermediate is summed in f32
    and rounded once, where the whole layer rounds its bf16 product);
  * the norms across heads on given statistics: whole-row statistics bit for
    bit the whole-row plain versions, summed shard statistics within 1 bf16
    ulp;
  * a family's blocks under tp: every rank bit-identical, within relative L2
    1e-2 of the port's one-process run and 2e-2 of JAX's tp-placed run;
  * the engine under tp (and dp x tp, sp x tp): every rank bit-identical and
    with the same cache skips, within relative L2 2e-2 of one process;
    offload with tp and a snapshot read under tp or pp bit for bit the
    resident / freshly loaded run;
  * the SDXL UNet under tp (int8, fp8, bf16; with and without IP-Adapter
    tokens): every rank bit-identical, within relative L2 2e-2 of the
    port's one-process forward and 5e-2 (SDXL's whole-forward tolerance,
    tests/test_torch_sdxl.py) of JAX's sdxl_forward on JAX's load of the
    same state dict.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parallel_workers import Pool  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

ROW_ULP, ROW_REL_MAX = 2.0, 2e-3
BLOCKS_REL_L2, BLOCKS_JAX_REL_L2, ENGINE_REL_L2 = 1e-2, 2e-2, 2e-2
FORMATS = [None, "int8", "fp8", "int4", "int4p"]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}
    store = str(tmp_path_factory.mktemp("tp-store"))

    def get(world: int) -> Pool:
        if world not in made:
            made[world] = Pool(world, store)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |x| (the smallest normal's below it)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126)))
    return torch.pow(2.0, e - 7)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


# ------------------------------------------------------------ splits

K_PARTS = [(64, 16), (96, 1)]  # FLUX's single-block proj_out form: heads, then the mlp
N_PARTS = [(64, 16)] * 3       # a fused q | k | v of 4 heads of 16


def _layer(quant, k, n, seed):
    from fastdm_tpu_torch.layers.qlinear import quantize_weight

    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    return quantize_weight(w, quant, b)


def _cols(ranges):
    return torch.cat([torch.arange(a, b) for a, b in ranges])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", FORMATS, ids=lambda q: q or "bf16")
def test_column_shards_concatenate_bit_for_bit(quant, tp):
    """Each rank's column shard (each fused part cut by whole heads) gives
    the whole layer's output on its columns, bit for bit; the shards hold
    only their columns (scales, column sums, bias, lora_v) and lora_u whole."""
    from fastdm_tpu_torch.parallel.tensor_parallel import _ranges, qlinear_split_columns

    lin = _layer(quant, 48, 192, 1)
    x = _bf16(np.random.default_rng(2), 2, 5, 48)
    with torch.inference_mode():
        whole = lin(x)
        for r in range(tp):
            shard = qlinear_split_columns(lin, N_PARTS, tp, r)
            cols = _cols(_ranges(N_PARTS, tp, r))
            assert shard.scale is None or torch.equal(shard.scale, lin.scale[cols])
            assert torch.equal(shard(x), whole[..., cols]), (quant, tp, r)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", FORMATS, ids=lambda q: q or "bf16")
def test_row_shards_quantize_on_whole_rows(quant, tp):
    """Row shards over tp virtual ranks: the per-row statistics reduced over
    the group quantize each rank's columns exactly as the whole row is
    quantized (int8 asymmetric with its zero point, and symmetric without
    one, fp8, int4); the layer's output equal on every rank and within the
    row tolerance of the whole layer's."""
    from fastdm_tpu_torch import kernels as K
    from fastdm_tpu_torch.parallel.tensor_parallel import _ranges, qlinear_split_rows, \
        run_virtual_ranks, virtual_groups

    k = sum(w for w, _ in K_PARTS)
    lin = _layer(quant, k, 40, 3)
    x = _bf16(np.random.default_rng(4), 7, k)
    groups = virtual_groups(tp)
    shards, xs = [], []
    for r in range(tp):
        s = qlinear_split_rows(lin, K_PARTS, tp, r)
        s.tp_reduce = groups[r]
        shards.append(s)
        xs.append(x[:, _cols(_ranges(K_PARTS, tp, r))].contiguous())

    def rank(r):
        g = groups[r]
        out = {"y": shards[r](xs[r])}
        for name, sym in (("int8", False), ("int8sym", True)):
            out[name] = K.quantize_to_int8_given(
                xs[r], g.all_reduce(K.quantize_stats(xs[r], sym), "max"), sym)
        amax = g.all_reduce(K.quantize_stats(xs[r], True), "max")
        out["fp8"] = K.quantize_to_fp8_given(xs[r], amax)
        out["int4"] = K.quantize_to_int4_given(xs[r], amax)
        return out

    outs = run_virtual_ranks(rank, groups)
    with torch.inference_mode():
        want = {"y": lin(x), "int8": K.quantize_to_int8(x, False),
                "int8sym": K.quantize_to_int8(x, True), "fp8": K.quantize_to_fp8(x),
                "int4": K.quantize_to_int4(x)}
    for r, out in enumerate(outs):
        cols = _cols(_ranges(K_PARTS, tp, r))
        assert torch.equal(out["y"], outs[0]["y"]), r
        for name in ("int8", "int8sym", "fp8", "int4"):
            got, ref = out[name], want[name]
            assert torch.equal(got[0].view(torch.int8), ref[0][:, cols].view(torch.int8)), name
            for a, b in zip(got[1:], ref[1:]):
                assert (a is None and b is None) or torch.equal(a, b), name
    y, ref = outs[0]["y"].float(), want["y"].float()
    tol = ROW_ULP * _ulp(ref) + ROW_REL_MAX * ref.abs().max()
    assert ((y - ref).abs() <= tol).all(), (quant, tp, (y - ref).abs().max().item())


def test_split_refusals_and_int4p_halves():
    """A part that tp does not cut into whole heads raises; an int4p row
    shard is packed in its own halves layout (not a contiguous cut of the
    packed rows) and unpacks to the whole weight's rows."""
    from fastdm_tpu_torch.kernels import unpack_int4
    from fastdm_tpu_torch.parallel.tensor_parallel import _ranges, qlinear_split_columns, \
        qlinear_split_rows

    lin = _layer("int4p", 160, 24, 5)
    with pytest.raises(ValueError, match="whole units"):
        qlinear_split_columns(_layer(None, 16, 48, 6), [(48, 16)], 2, 0)
    whole = unpack_int4(lin.w4p)
    for r in range(2):
        shard = qlinear_split_rows(lin, K_PARTS, 2, r)
        assert shard.w4p.shape == (40, 24) and shard.w4p.stride(0) == 1
        assert torch.equal(unpack_int4(shard.w4p), whole[_cols(_ranges(K_PARTS, 2, r))])
    with pytest.raises(ValueError, match="already a tp shard"):
        s = qlinear_split_rows(lin, K_PARTS, 2, 0)
        s.tp_reduce = object()
        qlinear_split_rows(s, K_PARTS, 2, 0)


# ------------------------------------------------------------ norms across heads


def test_norms_across_heads_on_given_statistics():
    """Wan's RMSNorm spans every head: with the whole row's statistic the
    given forms equal rms_norm / qk_norm_rope / qk_norm_rope2 bit for bit;
    with each rank's heads' statistics summed they give the whole row's
    values on the rank's columns within 1 bf16 ulp."""
    from fastdm_tpu_torch import kernels as K
    from fastdm_tpu_torch.models.wan import WanConfig, wan_rope_cos_sin

    rng = np.random.default_rng(7)
    heads, hd, eps = 4, 24, 1e-6
    d = heads * hd
    x = _bf16(rng, 2, 6, d)
    w = (1 + 0.1 * _bf16(rng, d).float()).bfloat16()
    qkv = _bf16(rng, 2, 6, 3 * d)
    gq, gk = (1 + 0.1 * _bf16(rng, d).float()).bfloat16(), (1 + 0.1 * _bf16(rng, d).float())
    gk = gk.bfloat16()
    cos, sin = wan_rope_cos_sin(WanConfig(num_attention_heads=heads, attention_head_dim=hd),
                                1, 4, 6, device="cpu")
    assert torch.equal(K.rms_norm_given(x, w, K.rms_sumsq(x), d, eps), K.rms_norm(x, w, eps))
    st = K.rms_sumsq(qkv[..., :2 * d].unflatten(-1, (2, d)))
    want = K.qk_norm_rope(qkv, gq, gk, hd, cos, sin, False, eps, inner_dim=d)
    for a, b in zip(K.qk_norm_rope_given(qkv, gq, gk, hd, cos, sin, st, d, False, eps,
                                         inner_dim=d), want):
        assert torch.equal(a, b)
    q, k = qkv[..., :d], qkv[..., d:2 * d]
    for a, b in zip(K.qk_norm_rope2_given(q, k, gq, gk, hd, cos, sin, st, d), want):
        assert torch.equal(a, b)
    for tp in (2, 4):
        per = d // tp
        cols = [slice(r * per, (r + 1) * per) for r in range(tp)]
        st_x = sum(K.rms_sumsq(x[..., c]) for c in cols)
        st_qk = sum(K.rms_sumsq(torch.stack([q[..., c], k[..., c]], dim=2)) for c in cols)
        for c in cols:
            got = K.rms_norm_given(x[..., c], w[c], st_x, d, eps).float()
            ref = K.rms_norm(x, w, eps)[..., c].float()
            assert ((got - ref).abs() <= _ulp(ref)).all()
            local = torch.cat([q[..., c], k[..., c], qkv[..., 2 * d:][..., c]], dim=-1)
            for a, b in zip(K.qk_norm_rope_given(local, gq[c], gk[c], hd, cos, sin, st_qk, d,
                                                 False, eps, inner_dim=per), want):
                b = b[..., c].float()
                assert ((a.float() - b).abs() <= _ulp(b)).all()


# ------------------------------------------------------------ the rules


@functools.lru_cache(maxsize=None)
def _family(family):
    """(config keywords, state dict, JAX model module, port model module):
    the family's tiny checkpoint, made once."""
    return _FAMILY_SOURCES[family]()


@functools.lru_cache(maxsize=None)
def _jax_params(family):
    """(JAX config, JAX's tree loaded from the family's state dict)."""
    from fastdm_tpu.models.loader import TensorSource as JSource

    cfg_kw, sd, jmod, _ = _family(family)
    jcfg = jmod.__dict__[_CFG[family]](**cfg_kw)
    return jcfg, jmod.__dict__[_LOAD[family]](JSource(dict(sd)), jcfg)


@functools.lru_cache(maxsize=None)
def _jax_placed(family, tp):
    """(JAX config, its tree placed by shard_params_by_name on a (1, 1, tp)
    mesh of virtual devices, the mesh)."""
    from jax.sharding import Mesh

    from fastdm_tpu.parallel.mesh import AXES, shard_params_by_name

    jcfg, params = _jax_params(family)
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, 1, tp), AXES)
    return jcfg, shard_params_by_name(params, mesh), mesh


def _rule_case(family, tp=2):
    """(port model split as rank 0 of tp, the whole port model, JAX's tree
    placed by shard_params_by_name on a (1, 1, tp) mesh)."""
    from fastdm_tpu_torch.models.loader import TensorSource
    from fastdm_tpu_torch.parallel.tensor_parallel import shard_block, virtual_groups

    cfg_kw, sd, jmod, tmod = _family(family)
    tcfg = tmod.__dict__[_CFG[family]](**cfg_kw)
    jplaced = _jax_placed(family, tp)[1]
    g = virtual_groups(tp)[0]
    src = TensorSource(dict(sd), "cpu")
    src.shard = lambda path, block: shard_block(block, path, tcfg, g)
    split = tmod.__dict__[_LOAD[family]](src, tcfg)
    whole = tmod.__dict__[_LOAD[family]](TensorSource(dict(sd), "cpu"), tcfg)
    return split, whole, jplaced


def _jax_kind(leaf) -> str:
    spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
    if "tp" not in spec:
        return "replicate"
    return "column" if spec.index("tp") == leaf.ndim - 1 else "row"


def _port_kind(split, whole) -> str:
    if split.tp_reduce is not None:
        return "row"
    n = (lambda q: q.scale.numel() if q.scale is not None else q.w.shape[1])
    return "column" if n(split) < n(whole) else "replicate"


JAX_STACKS = {"sd35": {"dual_blocks": "dual_attn_blocks"}}
# the port's recorded departures (ROADMAP.md section 3): Wan2.1-I2V's image
# K / V and the SDXL IP-Adapter's k | v cut by heads (no JAX rule names
# them), SDXL's attention out-projections row-split (the JAX tree names them
# "out", which no rule names), and SD3.5's last block split (JAX's rules
# shard only the layer-stacked leaves: its unstacked last block stays
# replicated)
_SDXL_DEPARTURES = {"attn1.out": "row", "attn2.out": "row"}
DEPARTURES = {("wan", "attn2.add_k"): "column", ("wan", "attn2.add_v"): "column",
              ("sdxl", "attn2.ipadp_kv"): "column",
              **{(f, k): v for f in ("sdxl", "sdxl-cn") for k, v in _SDXL_DEPARTURES.items()}}


def _jax_keys(family, path):
    """The keys of JAX's tree (list indices as ints) to the QLinear at a
    port module path: the block index dropped (JAX stacks the blocks); an
    SDXL stage "down.1" / "up.0" is JAX's "down1" / "up0", its mid stage's
    one Transformer2D "mid.attns.0" JAX's "mid.attn"."""
    parts = path.split(".")
    if family.startswith("sdxl"):
        if parts[0] == "mid":
            return ["mid", "attn", "blocks"] + parts[5:]
        return [parts[0] + parts[1], "attns", int(parts[3]), "blocks"] + parts[6:]
    stack, rest = parts[0], parts[1:]
    if stack != "last_block":
        rest = rest[1:]
    return [JAX_STACKS.get(family, {}).get(stack, stack)] + rest


RULE_CASES = [("flux", 2), ("sd35", 2), ("qwen", 2), ("wan", 2), ("sdxl", 2), ("sdxl", 4),
              ("sdxl-cn", 2), ("flux-cn", 2)]


@pytest.mark.parametrize("family,tp", RULE_CASES,
                         ids=[f if t == 2 else f"{f}-tp{t}" for f, t in RULE_CASES])
def test_split_kinds_match_jax_rules(family, tp):
    """For every QLinear of each family's blocks (both ControlNets' too), the
    port's split (column: output columns cut; row: input rows cut and
    reduced; replicate) is what JAX's shard_params_by_name places on the tp
    axis, except the recorded departures; the port's name rules are JAX's
    generic_param_pspec (generic_tp_kind), and on FLUX also
    flux_param_pspec's (the rules of JAX's FLUX dry run), which replicate the
    AdaLN modulations. SDXL at tp 4: the tiny level-1 blocks' 2 heads do not
    divide, so the port keeps their attention whole, where JAX cuts each
    leaf whose dim divides (its GEGLU feed-forward splits in both)."""
    from fastdm_tpu.parallel.mesh import flux_param_pspec, generic_param_pspec
    from fastdm_tpu_torch.layers.qlinear import QLinear
    from fastdm_tpu_torch.parallel.mesh import generic_tp_kind
    from fastdm_tpu_torch.parallel.tensor_parallel import block_paths

    split, whole, jplaced = _rule_case(family, tp)
    checked = whole_heads = 0
    for bpath in block_paths(whole):
        block = whole.get_submodule(bpath)
        for name, lin in block.named_modules():
            if not isinstance(lin, QLinear):
                continue
            path = f"{bpath}.{name}"
            keys = _jax_keys(family, path)
            node = jplaced
            for key in keys:
                node = node[key]
            key = "w4p" if "w4p" in node else "w4" if "w4" in node else "w"
            jpath = ".".join(map(str, keys))
            jkind = _jax_kind(node[key])
            pkind = _port_kind(split.get_submodule(path), lin)
            spec = generic_param_pspec(f"{jpath}.{key}")
            rule = "column" if spec[2:] == ("tp",) else "row" if spec[1:2] == ("tp",) else \
                "replicate"
            assert generic_tp_kind(path) == rule, path
            if family == "flux":  # FLUX's own, narrower rules (the modulations replicated)
                fspec = flux_param_pspec(f"{jpath}.{key}")
                fkind = "column" if fspec[2:] == ("tp",) else "row" if fspec[1:2] == ("tp",) \
                    else "replicate"
                assert fkind == ("replicate" if "norm" in jpath else rule), path
            dep = next((v for (f, k), v in DEPARTURES.items() if f == family
                        and path.endswith(k)), None)
            heads = (block.norm1["gamma"].numel() // _family(family)[0]["head_dim"]
                     if family.startswith("sdxl") else 0)
            if heads % tp and name.startswith("attn"):
                assert pkind == "replicate", path
                whole_heads += 1
            elif dep is not None:
                assert (jkind, pkind) == ("replicate", dep), path
            elif keys[0] == "last_block":
                assert jkind == "replicate" and pkind == rule, path
            else:
                assert pkind == jkind, (path, pkind, jkind)
            checked += 1
    assert checked >= 8
    assert (whole_heads > 0) == (family == "sdxl" and tp == 4)


# ------------------------------------------------------------ families under tp


def _flux_source():
    from test_golden_flux import TINY, _synthetic_state_dict

    from fastdm_tpu.models import flux as jmod
    from fastdm_tpu_torch.models import flux as tmod

    return dict(TINY), _synthetic_state_dict(TINY, np.random.default_rng(3)), jmod, tmod


def _sd35_source():
    from test_torch_sd35 import TINY, _state_dict

    from fastdm_tpu.models import sd35 as jmod
    from fastdm_tpu_torch.models import sd35 as tmod

    # one block of each kind: dual, standard and the last (context pre-only)
    return dict(TINY, num_layers=3, num_dual_layers=1), _state_dict(5, 3, 1), jmod, tmod


def _qwen_source():
    from test_torch_qwen import TINY, _state_dict

    from fastdm_tpu.models import qwenimage as jmod
    from fastdm_tpu_torch.models import qwenimage as tmod

    return dict(TINY), _state_dict(5), jmod, tmod


def _wan_source():
    """Wan2.1-I2V's blocks (the image K / V and norm_added_k) at the tiny
    t2v widths."""
    from test_torch_wan import IMG_DIM, INNER, TEXT, TINY, _image_sd

    from fastdm_tpu.models import wan as jmod
    from fastdm_tpu_torch.models import wan as tmod

    return (dict(TINY, patch_size=(1, 2, 2), text_len=TEXT, image_dim=IMG_DIM,
                 added_kv_proj_dim=INNER), _image_sd(21), jmod, tmod)


def _sdxl_source():
    """The tiny UNet (head_dim 8: 2 heads at level 1, 4 at level 2) with an
    IP-Adapter k | v on every cross-attention."""
    from test_torch_sdxl import TINY, _sdxl_sd_ip

    from fastdm_tpu.models import sdxl as jmod
    from fastdm_tpu_torch.models import sdxl as tmod

    return dict(TINY, ip_adapter=True), _sdxl_sd_ip(6), jmod, tmod


def _sdxl_cn_source():
    from test_engine_e2e import _sdxl_sd
    from test_torch_sdxl import TINY

    from fastdm_tpu.models import controlnets as jmod
    from fastdm_tpu_torch.models import controlnets as tmod

    return dict(TINY), _sdxl_sd(np.random.default_rng(24), cn=True), jmod, tmod


def _flux_cn_source():
    """A union FLUX ControlNet of one dual and one single block."""
    from test_engine_e2e import TINY, _flux_cn_sd

    from fastdm_tpu.models import controlnets as jmod
    from fastdm_tpu_torch.models import controlnets as tmod

    return (dict(TINY, num_layers=1, num_single_layers=1),
            _flux_cn_sd(np.random.default_rng(1), TINY, union=True), jmod, tmod)


_FAMILY_SOURCES = {"flux": _flux_source, "sd35": _sd35_source, "qwen": _qwen_source,
                   "wan": _wan_source, "sdxl": _sdxl_source, "sdxl-cn": _sdxl_cn_source,
                   "flux-cn": _flux_cn_source}
_CFG = {"flux": "FluxConfig", "sd35": "SD3Config", "qwen": "QwenImageConfig",
        "wan": "WanConfig", "sdxl": "SDXLConfig", "sdxl-cn": "SDXLConfig",
        "flux-cn": "FluxControlNetConfig"}
_LOAD = {"flux": "flux_load", "sd35": "sd3_load", "qwen": "qwen_load", "wan": "wan_load",
         "sdxl": "sdxl_load", "sdxl-cn": "sdxl_controlnet_load",
         "flux-cn": "flux_controlnet_load"}


def _block_inputs(family, cfg_kw):
    """(port inputs, JAX inputs) of a block-stack run, batch 2."""
    rng = np.random.default_rng(11)
    d = cfg_kw["num_attention_heads"] * cfg_kw["attention_head_dim"]
    b = 2
    arrs, f32 = {}, set()
    tcos = tsin = jcos = jsin = None
    if family == "flux":
        from fastdm_tpu.models.flux import FluxConfig as JC, flux_rope_cache as jrope
        from fastdm_tpu_torch.models.flux import FluxConfig as TC, flux_rope_cache as trope

        arrs = dict(hidden=rng.standard_normal((b, 16, d)), encoder=rng.standard_normal((b, 6, d)),
                    temb=rng.standard_normal((b, d)))
        tcos, tsin = trope(TC(**cfg_kw), 6, 4, 4, device="cpu")
        jcos, jsin = jrope(JC(**cfg_kw), 6, 4, 4)
    elif family == "sd35":
        arrs = dict(hidden=rng.standard_normal((b, 16, d)), encoder=rng.standard_normal((b, 7, d)),
                    temb=rng.standard_normal((b, d)))
    elif family == "qwen":
        from fastdm_tpu.models.qwenimage import QwenImageConfig as JC, qwen_rope_cos_sin as jrope
        from fastdm_tpu_torch.models.qwenimage import QwenImageConfig as TC, \
            qwen_rope_cos_sin as trope

        arrs = dict(hidden=rng.standard_normal((b, 16, d)), encoder=rng.standard_normal((b, 5, d)),
                    temb=rng.standard_normal((b, d)))
        tcos, tsin = trope(TC(**cfg_kw), 1, 4, 4, 5, device="cpu")
        jcos, jsin = jrope(JC(**cfg_kw), 1, 4, 4, 5)
    else:
        from fastdm_tpu.models.wan import WanConfig as JC, wan_rope_cos_sin as jrope
        from fastdm_tpu_torch.models.wan import WanConfig as TC, wan_rope_cos_sin as trope

        # the image context first (17 tokens), then the text_len text tokens
        arrs = dict(hidden=rng.standard_normal((b, 16, d)),
                    encoder=rng.standard_normal((b, 17 + cfg_kw["text_len"], d)),
                    temb=0.1 * rng.standard_normal((b, 6, d)))
        f32 = {"temb"}
        tcos, tsin = trope(TC(**cfg_kw), 4, 4, 4, device="cpu")
        jcos, jsin = jrope(JC(**cfg_kw), 4, 4, 4)
    arrs = {k: a.astype(np.float32) for k, a in arrs.items()}
    tin = {k: torch.from_numpy(a) if k in f32 else torch.from_numpy(a).bfloat16()
           for k, a in arrs.items()}
    jin = {k: jnp.asarray(a, jnp.float32 if k in f32 else jnp.bfloat16) for k, a in arrs.items()}
    if tcos is not None:
        tin.update(cos=tcos, sin=tsin)
        jin.update(cos=jcos, sin=jsin)
    return tin, jin


def _jax_blocks(family, jin, tp):
    """JAX's block runner on its tree placed by shard_params_by_name over a
    (1, 1, tp) mesh of virtual devices, jitted."""
    jmod = _family(family)[2]
    jcfg, params, mesh = _jax_placed(family, tp)
    if family == "flux":
        fn = lambda p, i: jmod.flux_run_blocks(p, jcfg, i["hidden"], i["encoder"], i["temb"],  # noqa: E731
                                               i["cos"], i["sin"])
    elif family == "sd35":
        fn = lambda p, i: jmod.sd3_run_blocks(p, jcfg, i["hidden"], i["encoder"], i["temb"])  # noqa: E731
    elif family == "qwen":
        fn = lambda p, i: jmod.qwen_run_blocks(p, jcfg, i["hidden"], i["encoder"],  # noqa: E731
                                               i["temb"], i["cos"], i["sin"])
    else:
        fn = lambda p, i: jmod.wan_run_blocks(p, jcfg, i["hidden"], i["encoder"], i["temb"],  # noqa: E731
                                              i["cos"], i["sin"])
    with mesh:
        return np.asarray(jax.jit(fn)(params, jin), np.float32)


@pytest.mark.parametrize("family,tp", [("flux", 2), ("flux", 4), ("sd35", 2), ("qwen", 2),
                                       ("wan", 2)])
def test_family_blocks_under_tp(pools, tmp_path, family, tp):
    """Each family's blocks loaded as tp shards (each block built whole,
    then cut by the loader) in tp gloo ranks: every rank's output
    bit-identical, within BLOCKS_REL_L2 of the port's one-process run and
    (tp 2) BLOCKS_JAX_REL_L2 of JAX's blocks placed by shard_params_by_name
    on tp virtual devices; each rank holds about 1/tp of the split weights."""
    import torch_parallel_workers as w
    from safetensors.torch import save_file

    cfg_kw, sd, _, _ = _family(family)
    path = str(tmp_path / "model.safetensors")
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    tin, jin = _block_inputs(family, cfg_kw)
    per_rank = pools(tp).run("task_tp_blocks", family, path, cfg_kw, tin)
    params, tcfg = w._load(family, path, cfg_kw)
    with torch.inference_mode():
        want = w.run_blocks(family, params, tcfg, tin)
    from fastdm_tpu_torch.parallel.offload import module_bytes
    from fastdm_tpu_torch.parallel.tensor_parallel import block_paths

    whole_bytes = sum(module_bytes(params.get_submodule(p)) for p in block_paths(params))
    for r, (out, nbytes) in enumerate(per_rank):
        assert torch.equal(out, per_rank[0][0]), (family, r)
        assert nbytes < whole_bytes * (1.0 / tp + 0.25), (family, r, nbytes, whole_bytes)
    assert _rel_l2(per_rank[0][0], want) <= BLOCKS_REL_L2, family
    if tp == 2:  # JAX compiles its placement once a tp; FLUX's tp 4 is held to one process
        assert _rel_l2(per_rank[0][0], _jax_blocks(family, jin, tp)) <= \
            BLOCKS_JAX_REL_L2, family


SDXL_JAX_REL_L2 = 5e-2


@functools.lru_cache(maxsize=None)
def _jax_sdxl_outputs(quant):
    """JAX's sdxl_forward on its load of the tiny UNet state dict, jitted
    once: the IP-Adapter tokens at scale 0.6 and at 0.0 (their branch then
    adds zeros: the forward without them)."""
    from test_torch_sdxl import TINY, _inputs, _sdxl_sd_ip

    from fastdm_tpu.models import sdxl as jsdxl
    from fastdm_tpu.models.loader import TensorSource as JSource

    jcfg = jsdxl.SDXLConfig(quant=quant, ip_adapter=True, **TINY)
    jp = jsdxl.sdxl_load(JSource(dict(_sdxl_sd_ip(6))), jcfg)
    j, _ = _inputs(7)
    run = jax.jit(lambda p, s: jsdxl.sdxl_forward(p, jcfg, j["sample"], j["t"], j["ctx"],
                                                   j["pooled"], j["time_ids"], ip_embeds=j["ip"],
                                                   ip_scale=s))
    return [np.asarray(run(jp, jnp.float32(s)), np.float32) for s in (0.6, 0.0)]


SDXL_CASES = [(q, tp) for q in (None, "int8", "fp8") for tp in (2, 4)]


@pytest.mark.parametrize("quant,tp", SDXL_CASES,
                         ids=[f"{q or 'bf16'}-tp{tp}" for q, tp in SDXL_CASES])
def test_sdxl_unet_under_tp(pools, tmp_path, quant, tp):
    """The tiny SDXL UNet (2 heads at level 1, 4 at level 2: at tp 4 the
    level-1 attention stays whole on every rank, its GEGLU feed-forward
    splits) loaded as tp shards in tp gloo ranks, with and without
    IP-Adapter tokens: every rank's output bit-identical, within
    ENGINE_REL_L2 of the port's one-process forward and SDXL_JAX_REL_L2 of
    JAX's; each rank holds less than the whole blocks' bytes."""
    import torch_parallel_workers as w
    from safetensors.torch import save_file
    from test_torch_sdxl import TINY, _inputs, _sdxl_sd_ip

    from fastdm_tpu_torch.models import sdxl as tsdxl
    from fastdm_tpu_torch.models.loader import TensorSource
    from fastdm_tpu_torch.parallel.offload import module_bytes
    from fastdm_tpu_torch.parallel.tensor_parallel import block_paths

    del w
    cfg_kw = dict(TINY, quant=quant, ip_adapter=True)
    sd = _sdxl_sd_ip(6)
    path = str(tmp_path / "unet.safetensors")
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    _, t = _inputs(7)
    per_rank = pools(tp).run("task_tp_sdxl", path, cfg_kw, t)
    cfg = tsdxl.SDXLConfig(**cfg_kw)
    unet = tsdxl.sdxl_load(TensorSource(dict(sd), "cpu"), cfg)
    with torch.inference_mode():
        want = [tsdxl.sdxl_forward(unet, cfg, t["sample"], t["t"], t["ctx"], t["pooled"],
                                   t["time_ids"], ip_embeds=ip) for ip in (t["ip"], None)]
    whole = sum(module_bytes(unet.get_submodule(p)) for p in block_paths(unet))
    jax_out = _jax_sdxl_outputs(quant)
    for r, (outs, nbytes) in enumerate(per_rank):
        assert nbytes < whole, (r, nbytes, whole)
        for got, r0, ref, jref in zip(outs, per_rank[0][0], want, jax_out):
            assert torch.equal(got, r0), r
            assert _rel_l2(got, ref) <= ENGINE_REL_L2, (quant, tp, _rel_l2(got, ref))
            assert _rel_l2(got, jref) <= SDXL_JAX_REL_L2, (quant, tp, _rel_l2(got, jref))
    assert _rel_l2(want[0], want[1]) > 1e-2  # the image tokens enter


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The tiny checkpoints of the engine tests (tests/test_torch_model_entry.py's
    writers), one per family."""
    from test_torch_model_entry import _write_root

    base = str(tmp_path_factory.mktemp("tp-roots"))
    return {f: _write_root(f, base) for f in ("flux", "sd35", "qwen", "wan")}


def _vae_kw(family):
    """The tiny AutoencoderKL config test_torch_model_entry.tiny_engine gives
    the family (None: Wan reads its own vae/config.json)."""
    import dataclasses

    import fastdm_tpu_torch.engine as teng
    from test_torch_pipeline import VAE_TINY

    kw = {"flux": dict(VAE_TINY), "sd35": dict(VAE_TINY, scaling_factor=1.5305,
                                                   shift_factor=0.0609),
          "qwen": dict(latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                       norm_num_groups=4, scaling_factor=1.0, shift_factor=0.0)}.get(family)
    assert kw is None or set(kw) <= {f.name for f in dataclasses.fields(teng.VAEConfig)}
    return kw


RADIAL = dict(sparse_algorithm="radial", model_type="wan", block_size=16, decay_factor=0.3,
              dense_layers=1, dense_steps=1)
# TeaCache on FLUX and FBCache on Wan with thresholds whose every decision
# lies >= 5% from them in the one-process run (its accumulated errors)
FLUX_TEACACHE = {"cache_algorithm": "teacache", "enable_caching": True, "threshold": 0.24,
                 "coefficients": [1.0, 0.0]}
WAN_FBCACHE = {"cache_algorithm": "fbcache", "enable_caching": True, "threshold": 0.05,
               "warmup_steps": 0}


def _requests(family, steps=4):
    from test_torch_model_entry import _request

    kw = dict(_request(family, False), num_inference_steps=steps)
    return [kw, dict(kw, seed=11)]


def _one_process(root, family, arch, sparse_gather=None, **kw):
    from test_torch_model_entry import tiny_engine

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("FASTDM_SPARSE_GATHER", raising=False)
        if sparse_gather is not None:
            mp.setenv("FASTDM_SPARSE_GATHER", sparse_gather)
        eng = tiny_engine(family, root, architecture=arch, **kw)
        outs = []
        for req in _requests(family):
            outs.append((eng.generate(**req), eng.last_cache_skips))
    return outs


def _check_ranks(per_rank, want, label, exact=False, split=True):
    """Every rank's outputs and skips equal rank 0's and the reference's
    skips; the outputs within ENGINE_REL_L2 of the reference (exact: bit for
    bit); every rank's blocks hold row shards (split) or none."""
    for r, (outs, n_row) in enumerate(per_rank):
        assert (n_row > 0) == split, (label, r, n_row)
        for (got, skips), (ref, ref_skips), (r0, r0_skips) in zip(outs, want, per_rank[0][0]):
            np.testing.assert_array_equal(got, r0)
            assert skips == r0_skips == ref_skips, (label, r, skips, ref_skips)
            if exact:
                np.testing.assert_array_equal(got, ref)
            else:
                assert _rel_l2(got, ref) <= ENGINE_REL_L2, (label, r, _rel_l2(got, ref))


ENGINE_CASES = [  # family, architecture, engine keywords
    ("flux", "flux", dict(cache_config=FLUX_TEACACHE)),
    ("flux", "flux", dict(use_int4=True, pack_int4=True, quant_mods=True)),
    ("sd35", "sd3.5", dict(use_int8=True)),
    ("qwen", "qwen-image", dict(use_fp8=True)),
    ("qwen", "qwen-image-edit", {}),
    ("wan", "wan2.2-t2v", dict(cache_config=WAN_FBCACHE, use_int8=True)),
    # radial sparse attention: the superblock walk (JAX's default) and the
    # block mask of every head (a rank takes its heads' rows)
    ("wan", "wan2.2-t2v", dict(sparse_attn_config=RADIAL, sparse_gather="super")),
    ("wan", "wan2.2-t2v", dict(sparse_attn_config=RADIAL, sparse_gather="mask")),
]


@pytest.mark.parametrize("family,arch,kw", ENGINE_CASES,
                         ids=[f"{c[1]}-{'-'.join(c[2]) or 'bf16'}-{c[2].get('sparse_gather', '')}"
                              for c in ENGINE_CASES])
def test_engine_tp2_matches_one_process(pools, roots, family, arch, kw):
    """FastDMEngine(mesh_shape=(1, 1, 2)) over gloo: each family in a format,
    FLUX under TeaCache, Wan under FBCache and in two radial sparse modes,
    every rank's latents identical with the same skips as one process,
    within ENGINE_REL_L2."""
    want = _one_process(roots[family], family, arch, **kw)
    assert family not in ("flux", "wan") or "cache_config" not in kw or \
        0 < sum(s for _, s in want) < 2 * 4, want
    per_rank = pools(2).run("task_tp_engine", roots[family], arch, _requests(family), (1, 1, 2),
                            _vae_kw(family), **kw)
    _check_ranks(per_rank, want, (arch, kw))


def test_engine_meshes_with_tp(pools, roots):
    """FLUX under (2, 1, 2) (dp x tp), (1, 2, 2) (the ring on each rank's
    heads) and (1, 1, 4) over four gloo ranks against one process."""
    want = _one_process(roots["flux"], "flux", "flux", use_int8=True)
    for shape in ((2, 1, 2), (1, 2, 2), (1, 1, 4)):
        per_rank = pools(4).run("task_tp_engine", roots["flux"], "flux", _requests("flux"),
                                shape, _vae_kw("flux"), use_int8=True)
        _check_ranks(per_rank, want, shape)


def test_offload_and_snapshot_under_tp(pools, roots, tmp_path):
    """offload_inactive_expert under tp (each rank pins its shard of both
    experts) bit-equal to the resident tp run; a snapshot written by a
    one-device engine, read under tp and under pp, bit-equal to the fresh
    tp / pp loads."""
    from test_torch_model_entry import tiny_engine

    resident = pools(2).run("task_tp_engine", roots["wan"], "wan2.2-t2v", _requests("wan"),
                            (1, 1, 2), None, use_int8=True)
    offload = pools(2).run("task_tp_engine", roots["wan"], "wan2.2-t2v", _requests("wan"),
                           (1, 1, 2), None, use_int8=True, offload_inactive_expert=True)
    _check_ranks(offload, resident[0][0], "offload", exact=True)
    snap = str(tmp_path / "snap")
    tiny_engine("flux", roots["flux"], use_int8=True, snapshot_path=snap)
    for shape in ((1, 1, 2), (1, 1, 1, 2)):
        fresh = pools(2).run("task_tp_engine", roots["flux"], "flux", _requests("flux"), shape,
                             _vae_kw("flux"), use_int8=True)
        read = pools(2).run("task_tp_engine", roots["flux"], "flux", _requests("flux"), shape,
                            _vae_kw("flux"), use_int8=True, snapshot_path=snap)
        _check_ranks(read, fresh[0][0], ("snapshot", shape), exact=True, split=len(shape) == 3)


def _sdxl_roots(base: str) -> dict:
    """The tiny SDXL checkpoint of tests/test_torch_model_entry.py and an
    SDXL ControlNet of the same config beside it."""
    from test_engine_e2e import _sdxl_sd, _write_st
    from test_torch_model_entry import _write_root

    cn = os.path.join(base, "sdxl-cn")
    _write_st(os.path.join(cn, "diffusion_pytorch_model.safetensors"),
              _sdxl_sd(np.random.default_rng(24), cn=True))
    return {"sdxl": _write_root("sdxl", base), "sdxl-cn": cn}


def _flux_union_cn(base: str) -> str:
    """A union FLUX ControlNet (one dual, one single block, guidance) of the
    tiny FLUX checkpoint's widths."""
    import json

    from test_engine_e2e import TINY, _flux_cn_sd, _write_st

    path = os.path.join(base, "flux-cn")
    _write_st(os.path.join(path, "diffusion_pytorch_model.safetensors"),
              _flux_cn_sd(np.random.default_rng(20), TINY, union=True))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(TINY, num_layers=1, num_single_layers=1), f)
    return path


def _hint(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((64, 64, 3)) * 255).astype(np.uint8)


CONDITIONED = ["sdxl-int8", "sdxl-controlnet", "flux-union-controlnet"]


@pytest.mark.parametrize("case", CONDITIONED)
def test_engine_tp2_sdxl_and_controlnets(pools, roots, tmp_path, case):
    """FastDMEngine(mesh_shape=(1, 1, 2)) over gloo for what tp did not split
    before: SDXL (int8), SDXL with a controlnet_path and FLUX with a union
    controlnet_path (its blocks cut like FLUX's, its zero heads and
    x-embedder whole), against one process within ENGINE_REL_L2, every
    rank's latents identical."""
    from test_torch_model_entry import tiny_engine
    from test_torch_pipeline import VAE_TINY
    from test_torch_sdxl import TINY as SDXL_TINY

    if case.startswith("sdxl"):
        family, arch, root, sdxl_kw = "sdxl", "sdxl", _sdxl_roots(str(tmp_path)), SDXL_TINY
        kw = dict(use_int8=True) if case == "sdxl-int8" else dict(controlnet_path=root["sdxl-cn"])
        root = root["sdxl"]
    else:
        family, arch, root, sdxl_kw = "flux", "flux", roots["flux"], None
        kw = dict(controlnet_path=_flux_union_cn(str(tmp_path)))
    requests = _requests(family)
    if "controlnet" in case:
        extra = dict(control_image=_hint(31), controlnet_conditioning_scale=0.8)
        if family == "flux":
            extra["control_mode"] = 2
        requests = [dict(r, **extra) for r in requests]
    eng = tiny_engine(family, root, architecture=arch, **kw)
    want = [(eng.generate(**r), eng.last_cache_skips) for r in requests]
    per_rank = pools(2).run("task_tp_engine", root, arch, requests, (1, 1, 2), dict(VAE_TINY),
                            sdxl_kw=sdxl_kw, **kw)
    _check_ranks(per_rank, want, case)


def test_tp_refusals():
    """pp with tp raises JAX's ValueError; SDXL and controlnet_path take tp
    like every family (their mesh then needs a process group); the CLI
    passes a tp mesh through for every architecture."""
    import argparse

    from fastdm_tpu_torch import common_args as targs
    from fastdm_tpu_torch.engine import FastDMEngine

    for kw in (dict(architecture="sdxl"), dict(architecture="flux", controlnet_path="/nx-cn")):
        with pytest.raises(RuntimeError, match="torchrun"):
            FastDMEngine("/nonexistent", device="cpu", mesh_shape=(1, 1, 2), **kw)
    with pytest.raises(ValueError, match="pp > 1 requires sp == 1 and tp == 1"):
        FastDMEngine("/nonexistent", device="cpu", mesh_shape=(1, 1, 2, 2))
    p = argparse.ArgumentParser()
    targs.add_engine_args(p)
    for arch in ("sdxl", "flux"):
        kw = targs.engine_kwargs(p.parse_args(["--model-path", "m", "--architecture", arch,
                                               "--mesh-shape", "1,1,4"]))
        assert kw["mesh_shape"] == (1, 1, 4) and kw["architecture"] == arch
