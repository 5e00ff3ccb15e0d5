"""The port's parallel/ (the mesh, ring attention, the GPipe schedule,
offload_inactive_expert) against the JAX package, with torch.distributed
run for real: worker processes under gloo (tests/torch_parallel_workers.py,
which imports no JAX), one pool per world size, a file:// store under the
test's temporary directory so that xdist workers never share a port. The
JAX references run here in the parent on conftest's 8 virtual CPU devices.

Tolerances: the ring (bf16 blocks merged in f32 over the ranks' K/V shards)
within 1e-2 absolute of the port's one-process sdpa and 2e-2 of JAX's
sdpa_ring (f32 logits, p rounded to bf16 on both sides, sums in other
orders), every rank's output identical; GPipe bit-identical to the port's
sequential run of the same microbatches, and at pp 4 within the JAX tests'
5e-2 (tests/test_parallel.py) of JAX's GPipe route; the engine under (2, 1, 1)
bit-equal to one process (replicated compute), under (1, 2, 1) and
(1, 1, 1, 2) within relative L2 2e-2 of it (the ring's merge, and batch-1
microbatches against the batch-2 forward, round bf16 differently);
offload_inactive_expert bit-equal to the resident run.
"""

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

RING_TOL, RING_JAX_TOL, JAX_PP_TOL, ENGINE_REL_L2 = 1e-2, 2e-2, 5e-2, 2e-2


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """{world: Pool}, each started at its first use and closed at the end."""
    made = {}
    store = str(tmp_path_factory.mktemp("dist-store"))

    def get(world: int) -> Pool:
        if world not in made:
            made[world] = Pool(world, store)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ mesh


def test_factor_mesh_matches_jax():
    from fastdm_tpu.parallel.mesh import AXES, factor_mesh as jfactor
    from fastdm_tpu_torch.parallel import mesh as tmesh

    assert tmesh.AXES == AXES
    for n in range(1, 17):
        assert tmesh.factor_mesh(n) == jfactor(n), n


def test_mesh_of_one_device_needs_no_group():
    import torch.distributed as dist

    from fastdm_tpu_torch.parallel.mesh import init_mesh

    assert not dist.is_initialized()
    for shape in ((1, 1, 1), (1, 1, 1, 1)):
        mesh = init_mesh(shape, "cpu")
        assert mesh.size == 1 and mesh.device_mesh is None
        assert all(mesh.axis(n).group is None for n in mesh.names)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        init_mesh((1, 2, 1), "cpu")
    with pytest.raises(ValueError):
        init_mesh((1, 1), "cpu")


def test_mesh_groups_follow_the_axes(pools):
    got = pools(4).run("task_mesh", (1, 2, 1, 2))
    # row-major over (dp, sp, tp, pp): rank = sp * 2 + pp
    for r, axes in enumerate(got):
        assert axes["sp"] == (r // 2, (r % 2, r % 2 + 2))
        assert axes["pp"] == (r % 2, (r // 2 * 2, r // 2 * 2 + 1))
        assert axes["dp"] == (0, (r,)) and axes["tp"] == (0, (r,))
    with pytest.raises(RuntimeError, match="has 4 devices but the process group has 2"):
        pools(2).run("task_mesh", (1, 2, 1, 2))


# ------------------------------------------------------------ the log-sum-exp


def test_plain_lse_matches_float64():
    from fastdm_tpu_torch.kernels import scaled_dot_product_attention, \
        scaled_dot_product_attention_lse

    rng = np.random.default_rng(0)
    b, sq, skv, hq, hkv, d = 2, 9, 13, 4, 2, 16
    q, k, v = _t(_bf16(rng, b, sq, hq * d)), _t(_bf16(rng, b, skv, hkv * d)), \
        _t(_bf16(rng, b, skv, hkv * d))
    for scale in (None, 0.3, -0.2):
        out, lse = scaled_dot_product_attention_lse(q, k, v, hq, hkv, d, scale)
        assert torch.equal(out, scaled_dot_product_attention(q, k, v, hq, hkv, d, False, scale))
        qq = q.double().view(b, sq, hq, d)
        kk = k.double().view(b, skv, hkv, d).repeat_interleave(hq // hkv, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", qq, kk) * (d**-0.5 if scale is None else scale)
        assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
        assert (torch.logsumexp(logits, -1) - lse.double()).abs().max().item() <= 1e-5


def test_merge_guards_rows_without_mass():
    """A block whose rows saw no key (lse -inf) merges to nothing, and a row
    whose first block has no mass takes the next block's whole: no NaN."""
    from fastdm_tpu_torch.parallel.context_parallel import _merge

    acc = torch.zeros(1, 2, 1, 4)
    m = torch.full((1, 2, 1, 1), float("-inf"))
    l_ = torch.zeros(1, 2, 1, 1)
    empty = torch.zeros(1, 2, 4)
    m, l_ = _merge(acc, m, l_, empty, torch.full((1, 1, 2), float("-inf")))
    assert torch.isfinite(acc).all() and (l_ == 0).all()
    out = torch.arange(8.0).view(1, 2, 4)
    m, l_ = _merge(acc, m, l_, out, torch.tensor([[[0.5, -3.0]]]))
    torch.testing.assert_close(acc / l_, out.view(1, 2, 1, 4))


# ------------------------------------------------------------ the ring


RING_CASES = {
    # name: (batch, sq, skv, hq, hkv, d)
    "self": (1, 24, 24, 4, 4, 32),
    "gqa": (2, 16, 16, 4, 2, 16),
    "cross": (1, 24, 10, 2, 2, 32),
    "indivisible": (1, 19, 19, 2, 2, 16),
}


def _ring_inputs(n: int):
    rng = np.random.default_rng(n)
    cases = []
    for b, sq, skv, hq, hkv, d in RING_CASES.values():
        cases.append((_t(_bf16(rng, b, sq, hq * d)), _t(_bf16(rng, b, skv, hkv * d)),
                      _t(_bf16(rng, b, skv, hkv * d)), hq, hkv, d))
    return cases


def _jax_ring(n: int, q, k, v, hq, hkv, d):
    from jax.sharding import Mesh

    from fastdm_tpu.parallel import cp_state
    from fastdm_tpu.parallel.context_parallel import sdpa_ring
    from fastdm_tpu.parallel.mesh import AXES

    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n, 1), AXES)
    cp_state.set_cp_mesh(mesh)
    try:  # a jit of its own: the trace reads the active mesh
        ring = jax.jit(lambda *a: sdpa_ring(*a, hq, hkv, d))
        return np.asarray(ring(*(jnp.asarray(_np(t), jnp.bfloat16) for t in (q, k, v))),
                          np.float32)
    finally:
        cp_state.set_cp_mesh(None)


@pytest.mark.parametrize("n", [2, 4])
def test_sdpa_ring_matches_jax_and_one_process(pools, n):
    """sdpa_ring over gloo at world n, reached through the registry's route:
    self-attention (the K/V ring), GQA, cross-attention (query shards) and a
    length n does not divide (one device), each against the port's
    one-process sdpa and JAX's sdpa_ring on n virtual devices."""
    from fastdm_tpu_torch.kernels import scaled_dot_product_attention
    from fastdm_tpu_torch.parallel.context_parallel import VirtualRing, sdpa_ring

    cases = _ring_inputs(n)
    per_rank = pools(n).run("task_ring", cases)
    for name, case, *outs in zip(RING_CASES, cases, *per_rank):
        assert all(torch.equal(o, outs[0]) for o in outs[1:]), name
        got = _np(outs[0])
        one = _np(scaled_dot_product_attention(*case))
        assert np.abs(got - one).max() <= RING_TOL, name
        assert np.abs(got - _jax_ring(n, *case)).max() <= RING_JAX_TOL, name
        # the same per-rank loop over n virtual ranks in one process
        assert torch.equal(sdpa_ring(*case, ring=VirtualRing(n)), outs[0]), name


def test_sdpa_routes_to_the_ring_only_while_one_is_active():
    from fastdm_tpu_torch.kernels.registry import kernel_registry
    from fastdm_tpu_torch.parallel import cp_state
    from fastdm_tpu_torch.parallel.context_parallel import VirtualRing

    cpu = torch.device("cpu")
    assert kernel_registry.backend_for("sdpa", cpu) == "torch"
    with cp_state.cp_ring(VirtualRing(2)):
        assert kernel_registry.backend_for("sdpa", cpu) == "ring"
        assert kernel_registry.backend_for("sdpa", cpu, routed=False) == "torch"
        assert kernel_registry.backend_for("sdpa_gather_super", cpu) == "torch"
        q = torch.zeros(1, 8, 32, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="non-causal"):
            kernel_registry.select("sdpa", cpu)(q, q, q, 2, 2, 16, True)
    assert kernel_registry.backend_for("sdpa", cpu) == "torch"


# ------------------------------------------------------------ GPipe


def _flux_family():
    from test_golden_flux import TINY, _synthetic_state_dict

    cfg = dict(TINY, num_layers=4, num_single_layers=4)
    return cfg, _synthetic_state_dict(cfg, np.random.default_rng(3))


def _wan_family():
    import test_golden_wan

    cfg = dict(test_golden_wan.TINY, num_layers=4, patch_size=(1, 2, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(test_golden_wan.TINY, "num_layers", 4)
        sd = test_golden_wan._state_dict(np.random.default_rng(4))
    return cfg, sd


def _qwen_family():
    from test_torch_qwen import TINY, _state_dict

    cfg = dict(TINY, num_layers=4)
    return cfg, _state_dict(5, cfg)


FAMILIES = {"flux": _flux_family, "wan": _wan_family, "qwen": _qwen_family}


def _family_inputs(family: str, cfg: dict, m: int):
    """(port inputs, JAX inputs) of a block-stack run on m microbatches."""
    rng = np.random.default_rng(11)
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    if family == "flux":
        from fastdm_tpu.models.flux import FluxConfig as JC, flux_rope_cache as jrope
        from fastdm_tpu_torch.models.flux import FluxConfig as TC, flux_rope_cache as trope

        txt, ht, wt = 6, 4, 4
        arrs = dict(hidden=_bf16(rng, m, ht * wt, d), encoder=_bf16(rng, m, txt, d),
                    temb=_bf16(rng, m, d))
        tcos, tsin = trope(TC(**cfg), txt, ht, wt, device="cpu")
        jcos, jsin = jrope(JC(**cfg), txt, ht, wt)
    elif family == "wan":
        from fastdm_tpu.models.wan import WanConfig as JC, wan_rope_cos_sin as jrope
        from fastdm_tpu_torch.models.wan import WanConfig as TC, wan_rope_cos_sin as trope

        arrs = dict(hidden=_bf16(rng, m, 16, d), encoder=_bf16(rng, m, 8, d),
                    temb=0.1 * _bf16(rng, m, 6, d))
        tcos, tsin = trope(TC(**cfg), 4, 4, 4, device="cpu")
        jcos, jsin = jrope(JC(**cfg), 4, 4, 4)
    else:
        from fastdm_tpu.models.qwenimage import QwenImageConfig as JC, qwen_rope_cos_sin as jrope
        from fastdm_tpu_torch.models.qwenimage import QwenImageConfig as TC, \
            qwen_rope_cos_sin as trope

        txt, ht, wt = 5, 4, 4
        arrs = dict(hidden=_bf16(rng, m, ht * wt, d), encoder=_bf16(rng, m, txt, d),
                    temb=_bf16(rng, m, d))
        tcos, tsin = trope(TC(**cfg), 1, ht, wt, txt, device="cpu")
        jcos, jsin = jrope(JC(**cfg), 1, ht, wt, txt)
    f32 = {"temb"} if family == "wan" else set()
    tin = {k: torch.from_numpy(a) if k in f32 else _t(a) for k, a in arrs.items()}
    jin = {k: jnp.asarray(a, jnp.float32 if k in f32 else jnp.bfloat16) for k, a in arrs.items()}
    tin.update(cos=tcos, sin=tsin)
    jin.update(cos=jcos, sin=jsin)
    return tin, jin


_JAX_GPIPE = {}


def _jax_gpipe(family: str, cfg: dict, sd: dict, jin: dict, pp: int):
    """JAX's GPipe route of the family's block runner on a (1, 1, 1, pp) mesh,
    jitted (its eager shard_map traces on every call), once per (family, pp)."""
    if (family, pp) not in _JAX_GPIPE:
        _JAX_GPIPE[family, pp] = _jax_gpipe_run(family, cfg, sd, jin, pp)
    return _JAX_GPIPE[family, pp]


def _jax_gpipe_run(family: str, cfg: dict, sd: dict, jin: dict, pp: int):
    from jax.sharding import Mesh

    from fastdm_tpu.models.loader import TensorSource
    from fastdm_tpu.parallel import pp_state
    from fastdm_tpu.parallel.pipeline import shard_model_stacks_pp

    if family == "flux":
        from fastdm_tpu.models.flux import FluxConfig as C, flux_load as load, \
            flux_run_blocks as run
    elif family == "wan":
        from fastdm_tpu.models.wan import WanConfig as C, wan_load as load, wan_run_blocks as run
    else:
        from fastdm_tpu.models.qwenimage import QwenImageConfig as C, qwen_load as load, \
            qwen_run_blocks as run
    jcfg = C(**cfg)
    params = load(TensorSource(dict(sd)), jcfg)
    mesh = Mesh(np.asarray(jax.devices()[:pp]).reshape(1, 1, 1, pp), ("dp", "sp", "tp", "pp"))
    params = dict(params)
    params.update(shard_model_stacks_pp({k: v for k, v in params.items() if "blocks" in k
                                         and v is not None}, mesh))
    pp_state.set_pp_mesh(mesh)
    try:
        out = jax.jit(lambda p, *a: run(p, jcfg, *a))(
            params, jin["hidden"], jin["encoder"], jin["temb"], jin["cos"], jin["sin"])
    finally:
        pp_state.set_pp_mesh(None)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("shape", [(1, 1, 1, 2), (1, 1, 1, 4), (2, 1, 1, 2)],
                         ids=["pp2", "pp4", "dp2-pp2"])
def test_gpipe_matches_sequential_and_jax(pools, tmp_path, family, shape):
    """Each family's 4-block stacks through its runner's GPipe route over
    gloo: every rank holds only its stage's blocks (the loader's placement),
    returns the same output, bit-identical to the port's sequential run of
    the same microbatches, and (pp 4; JAX compiles its pipeline once a pp)
    within the JAX tests' tolerance of JAX's GPipe route."""
    import torch_parallel_workers as w
    from safetensors.torch import save_file

    cfg, sd = FAMILIES[family]()
    path = str(tmp_path / "model.safetensors")
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    m = 4
    tin, jin = _family_inputs(family, cfg, m)
    world = int(np.prod(shape))
    per_rank = pools(world).run("task_gpipe", family, path, cfg, tin, shape)

    params, tcfg = w._load(family, path, cfg)
    with torch.inference_mode():
        want = torch.cat([w.run_blocks(family, params, tcfg, {
            k: (t[i:i + 1] if k not in ("cos", "sin") else t) for k, t in tin.items()})
            for i in range(m)])
    pp = shape[3]
    for r, (out, held) in enumerate(per_rank):
        assert torch.equal(out, want), (family, shape, r)
        stage = r % pp
        for stack, depth in held.items():
            n = len(getattr(params, stack))
            assert depth == list(range(stage * n // pp, (stage + 1) * n // pp)), (stack, r)
    if pp == 4:  # pp 2 is bit-identical to the same sequential run
        np.testing.assert_allclose(_np(want), _jax_gpipe(family, cfg, sd, jin, pp),
                                   atol=JAX_PP_TOL, rtol=JAX_PP_TOL)


def test_gpipe_schedule_and_refusals():
    from fastdm_tpu_torch.parallel.pipeline import VirtualPipeline, gpipe_run_blocks, \
        gpipe_schedule, stage_blocks

    sched = gpipe_schedule(3, 2)
    assert sched == [[(0, 0)], [(0, 1), (1, 0)], [(1, 1), (2, 0)], [(2, 1)]]
    with pytest.raises(ValueError, match="not divisible by pp=4"):
        gpipe_run_blocks(lambda b, s: s, [None] * 6, [(torch.zeros(1),)], VirtualPipeline(4))
    # FLUX.1-dev's 19 dual blocks divide by no pp in {2, 4}: both stacks stay whole
    assert stage_blocks(2, 1, {"transformer_blocks": 19,
                               "single_transformer_blocks": 38}) is None
    assert stage_blocks(4, 1, {"blocks": 40}) == {"blocks": frozenset(range(10, 20))}
    assert stage_blocks(2, 1, {"transformer_blocks": 60}, {"transformer_blocks": (0,)}) == \
        {"transformer_blocks": frozenset([0, *range(30, 60)])}


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def wan_root(tmp_path_factory):
    from test_torch_wan import _write_wan_checkpoint

    root = str(tmp_path_factory.mktemp("wan-a14b"))
    _write_wan_checkpoint(root)
    return root


def _wan_requests():
    from test_torch_wan import _embeds

    pos, neg = _embeds(3)
    # 2 x 4 x 8 latent patches: 16 tokens against 8 text tokens
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=32, width=64,
              num_frames=5, num_inference_steps=4, guidance_scale=4.0, seed=1,
              output_type="latent")
    return [kw, dict(kw, task="t2i", seed=2)]


def _one_process(root, **kw):
    import torch_parallel_workers as w

    return w.task_engine(root, "wan2.2-t2v", _wan_requests(), **kw)


RADIAL = dict(sparse_algorithm="radial", model_type="wan", block_size=16, decay_factor=0.3,
              dense_layers=0, dense_steps=1)


def test_engine_meshes_match_one_process(pools, wan_root):
    """The tiny two-expert Wan engine, one process a rank: (2, 1, 1)
    computes replicated, bit-equal to one process; (1, 2, 1) rings every
    self-attention (and drops its sparse_attn_config, as JAX does) and
    (1, 1, 1, 2) pipelines the 2-block experts, one block a stage, alone and
    with offload_inactive_expert; every rank returns the same latents."""
    want, held = _one_process(wan_root)
    assert held == [0, 1]
    cases = [((2, 1, 1), {}), ((1, 2, 1), {"sparse_attn_config": RADIAL}),
             ((1, 1, 1, 2), {}), ((1, 1, 1, 2), {"offload_inactive_expert": True})]
    pp_out = None
    for shape, kw in cases:
        per_rank = pools(2).run("task_engine", wan_root, "wan2.2-t2v", _wan_requests(),
                                mesh_shape=shape, **kw)
        for r, (outs, held) in enumerate(per_rank):
            for got, ref, other in zip(outs, want, per_rank[0][0]):
                np.testing.assert_array_equal(got, other)
                if shape == (2, 1, 1):
                    np.testing.assert_array_equal(got, ref)
                else:
                    assert _rel_l2(got, ref) <= ENGINE_REL_L2, (shape, kw, r)
            assert held == ([r] if len(shape) == 4 else [0, 1]), (shape, r)
        if len(shape) == 4:
            if pp_out is not None:  # offload moves the weights, not the numbers
                np.testing.assert_array_equal(per_rank[0][0], pp_out)
            pp_out = per_rank[0][0]


def test_offload_inactive_expert_bit_equal(wan_root, monkeypatch):
    """Both experts in host memory, each placed for its own phase only
    (two placements a generate), the latents bit-equal to the resident run;
    a one-expert model takes the keyword and does nothing."""
    from fastdm_tpu_torch.engine import FastDMEngine
    from fastdm_tpu_torch.parallel import offload

    want, _ = _one_process(wan_root)
    placed = []
    real = offload.to_device
    monkeypatch.setattr(offload, "to_device",
                        lambda m, d: placed.append(m) or real(m, d))
    eng = FastDMEngine(wan_root, architecture="wan2.2-t2v", verbose=False, device="cpu",
                       offload_inactive_expert=True)
    assert eng._offloaded
    outs = [eng.generate(**kw) for kw in _wan_requests()]
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got, ref)
    assert placed == [eng.params, eng.params_2] * 2
    moved = real(eng.params, "cpu")
    assert moved is not eng.params and all(
        a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
        for a, b in zip(moved.parameters(), eng.params.parameters()))


def test_engine_mesh_refusals_match_jax(wan_root):
    """Every mesh refusal of the JAX constructor, with its exception type,
    in its order; tp > 1 with SDXL, and writing a snapshot under pp, pass
    the constructor's checks as in JAX (without a process group the mesh
    then raises); pp with a sparse config's dense_layers > 0 raises as JAX's
    does."""
    from fastdm_tpu.engine import FastDMEngine as JEngine
    from fastdm_tpu_torch.engine import FastDMEngine as TEngine

    fb = {"cache_algorithm": "fbcache", "enable_caching": True, "threshold": 0.1}
    di = {"cache_algorithm": "dicache", "enable_caching": True, "threshold": 0.1}
    cases = [
        dict(architecture="flux", mesh_shape=(2, 2)),
        dict(architecture="flux", mesh_shape=(1, 2, 3, 4, 5)),
        dict(architecture="flux", mesh_shape=(1, 1, 2, 2)),
        dict(architecture="wan", mesh_shape=(1, 2, 1, 2)),
        dict(architecture="sd35", mesh_shape=(1, 1, 1, 2)),
        dict(architecture="sdxl", mesh_shape=(1, 1, 1, 2)),
        dict(architecture="flux", mesh_shape=(1, 1, 1, 2), controlnet_path="/nonexistent-cn"),
        dict(architecture="flux", mesh_shape=(1, 1, 1, 2), cache_config=fb),
        dict(architecture="qwen-image", mesh_shape=(1, 1, 1, 2), cache_config=di),
        # pp checks come before pack_int4's
        dict(architecture="sd35", mesh_shape=(1, 1, 1, 2), pack_int4=True),
    ]
    for kw in cases:
        with pytest.raises(Exception) as want:
            JEngine("/nonexistent", **kw)
        with pytest.raises(type(want.value)) as got:
            TEngine("/nonexistent", device="cpu", **kw)
        assert str(got.value).split(" ")[:3] == str(want.value).split(" ")[:3], kw
    with pytest.raises(RuntimeError, match="torchrun"):
        TEngine("/nonexistent", architecture="sdxl", device="cpu", mesh_shape=(1, 1, 2))
    with pytest.raises(ValueError, match="dense_layers == 0"):
        TEngine(wan_root, architecture="wan2.2-t2v", device="cpu", mesh_shape=(1, 1, 1, 2),
                sparse_attn_config=dict(RADIAL, dense_layers=1))
    with pytest.raises(RuntimeError, match="torchrun"):
        TEngine(wan_root, architecture="wan2.2-t2v", device="cpu", mesh_shape=(1, 1, 1, 2),
                snapshot_path="/nonexistent-snap")
