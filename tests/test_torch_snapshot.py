"""The port's quantized snapshot (fastdm_tpu_torch/models/snapshot.py and the
engine's snapshot_path / save_quantized) against the JAX package's
(fastdm_tpu/models/snapshot.py, fastdm_tpu/engine.py:337-447) on tiny
configs.

Everything here is exact: a reloaded module equals the saved one in its
structure and in every parameter's class, dtype, shape, strides and bytes;
an engine built from a snapshot generates bit for bit what the engine that
wrote it generates, without calling quantize_weight; the fingerprints,
the manifest fields and check_compatible's verdicts equal JAX's on the same
inputs.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from fastdm_tpu.models import snapshot as jsnap
from fastdm_tpu_torch.layers import qlinear as tql
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models import qwenimage as tqwen
from fastdm_tpu_torch.models import sd35 as tsd35
from fastdm_tpu_torch.models import sdxl as tsdxl
from fastdm_tpu_torch.models import snapshot as tsnap
from fastdm_tpu_torch.models import wan as twan
from fastdm_tpu_torch.pipeline import vae as tvae

sys.path.insert(0, os.path.dirname(__file__))
from test_engine_e2e import TINY, _flux_transformer_sd, _sdxl_sd, _vae_sd, _write_st  # noqa: E402
from test_golden_wan import TINY as WAN_TINY  # noqa: E402
from test_golden_wan import _state_dict as _wan_sd  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

VAE_TINY = dict(latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=4, scaling_factor=0.5, shift_factor=0.0)
SDXL_TINY = dict(block_channels=(8, 16, 32), cross_attention_dim=16, attn_layers=(0, 1, 2),
                 head_dim=8, addition_time_embed_dim=4, time_embed_dim=16,
                 add_embedding_in_dim=8 + 6 * 4, norm_groups=4)
FLUX_CFG = {k: v for k, v in TINY.items() if k != "patch_size"}


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.uint8)


def assert_same_module(a: torch.nn.Module, b: torch.nn.Module) -> None:
    """The same module tree, and every parameter equal in class, dtype,
    shape, strides and bytes."""
    assert repr(a) == repr(b)
    assert [type(m) for m in a.modules()] == [type(m) for m in b.modules()]
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert list(pa) == list(pb)
    for k in pa:
        x, y = pa[k], pb[k]
        assert (type(x), x.dtype, x.shape, x.stride()) == (type(y), y.dtype, y.shape, y.stride()), k
        assert torch.equal(_bytes(x), _bytes(y)), k
    for ma, mb in zip(a.modules(), b.modules()):
        for k in set(vars(ma)) - set(tsnap._MODULE_INTERNALS):
            assert getattr(ma, k) == getattr(mb, k), k
        assert [n for n, p in ma._parameters.items() if p is None] == \
            [n for n, p in mb._parameters.items() if p is None]


# ------------------------------------------------------------------- trees


def _tree(kind: str):
    if kind.startswith("flux"):
        quant = kind.split("-")[1]
        cfg = tflux.FluxConfig(quant=None if quant == "bf16" else quant,
                               quant_mods=kind.endswith("mods"), **FLUX_CFG)
        return {"transformer": tflux.flux_init_random(0, cfg, device="cpu")}, cfg
    if kind == "wan-dual":
        cfg = twan.WanConfig(quant="int8", **WAN_TINY)
        return {"transformer": twan.wan_init_random(0, cfg, device="cpu"),
                "transformer_2": twan.wan_init_random(1, cfg, device="cpu")}, cfg
    if kind == "wan-i2v":  # Wan2.1-I2V's image branch, with a first-last-frame pos_embed
        d = WAN_TINY["num_attention_heads"] * WAN_TINY["attention_head_dim"]
        cfg = twan.WanConfig(quant="int8", image_dim=20, added_kv_proj_dim=d, **WAN_TINY)
        tree = twan.wan_init_random(2, cfg, device="cpu")
        tree.image_embedder.pos_embed = torch.nn.Parameter(torch.randn(1, 34, 20).bfloat16(),
                                                           requires_grad=False)
        return {"transformer": tree}, cfg
    if kind == "sdxl":
        cfg = tsdxl.SDXLConfig(quant="int8", **SDXL_TINY)
        return {"unet": tsdxl.sdxl_init_random(0, cfg, device="cpu")}, cfg
    if kind == "sd35":
        cfg = tsd35.SD3Config(quant="int8", num_layers=3, num_dual_layers=1,
                              attention_head_dim=16, num_attention_heads=2,
                              joint_attention_dim=32, caption_projection_dim=32,
                              pooled_projection_dim=16, pos_embed_max_size=16, sample_size=16)
        return {"transformer": tsd35.sd3_init_random(0, cfg, device="cpu")}, cfg
    cfg = tqwen.QwenImageConfig(quant="int4p", quant_mods=True, num_layers=2,
                                attention_head_dim=16, num_attention_heads=2,
                                joint_attention_dim=32, axes_dims_rope=(4, 6, 6))
    return {"transformer": tqwen.qwen_init_random(0, cfg, device="cpu")}, cfg


@pytest.mark.parametrize("kind", ["flux-bf16", "flux-int8", "flux-fp8", "flux-int4",
                                  "flux-int4p-mods", "wan-dual", "wan-i2v", "sdxl", "sd35",
                                  "qwen"])
def test_tree_round_trip(tmp_path, kind):
    """Every tree comes back as the same modules with the same bytes, the
    8- and 4-bit weights as (K, N) views of K-contiguous buffers again; the
    manifest records the config's fingerprint as JAX's _cfg_fingerprint."""
    trees, cfg = _tree(kind)
    tsnap.save_snapshot(str(tmp_path), trees, architecture=kind, quant=cfg.quant, cfg=cfg)
    m = tsnap.load_manifest(str(tmp_path))
    assert m["config"] == tsnap._cfg_fingerprint(cfg) and m["config_class"] == type(cfg).__name__
    assert sorted(m["trees"]) == sorted(trees)
    for name, tree in trees.items():
        back = tsnap.load_tree(str(tmp_path), name, m, device="cpu")
        assert_same_module(tree, back)
    with pytest.raises(KeyError, match="no tree"):
        tsnap.load_tree(str(tmp_path), "missing", device="cpu")


def test_forward_of_a_reloaded_tree_is_bit_equal(tmp_path):
    """An int4p + quant_mods FLUX forward from the reloaded tree equals the
    in-memory tree's bit for bit."""
    trees, cfg = _tree("flux-int4p-mods")
    tsnap.save_snapshot(str(tmp_path), trees, cfg=cfg)
    back = tsnap.load_tree(str(tmp_path), "transformer", device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 16, TINY["in_channels"])).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 6, TINY["joint_attention_dim"])).astype(
        np.float32))
    pooled = torch.from_numpy(rng.standard_normal((1, TINY["pooled_projection_dim"])).astype(
        np.float32))
    cos, sin = tflux.flux_rope_cache(cfg, 6, 4, 4, device="cpu")
    args = (x.bfloat16(), ctx.bfloat16(), pooled.bfloat16(), torch.tensor([0.5]), cos, sin,
            torch.tensor([3.5]))
    want = tflux.flux_forward(trees["transformer"], cfg, *args)
    assert torch.equal(tflux.flux_forward(back, cfg, *args), want)


def test_unsupported_state_and_classes_are_refused(tmp_path):
    """The encoder takes parameters, child modules of the port's classes and
    JSON-type attributes; anything else (a plain tensor attribute, a buffer,
    another class) raises before a file is written."""
    lin = tql.quantize_weight(torch.ones(4, 4), "int8")
    lin.note = torch.zeros(2)  # a tensor that is neither parameter nor buffer
    with pytest.raises(ValueError, match="unsupported state"):
        tsnap.save_snapshot(str(tmp_path / "a"), {"transformer": lin})

    lin = tql.quantize_weight(torch.ones(4, 4), "int8")
    lin.register_buffer("running", torch.zeros(2))
    with pytest.raises(ValueError, match="holds buffers"):
        tsnap.save_snapshot(str(tmp_path / "a"), {"transformer": lin})

    class Foreign(torch.nn.Module):
        pass

    with pytest.raises(ValueError, match="not a model or layer class"):
        tsnap.save_snapshot(str(tmp_path / "b"), {"transformer": Foreign()})
    assert not tsnap.is_snapshot(str(tmp_path / "a")) and not tsnap.is_snapshot(
        str(tmp_path / "b"))
    # every nn.Module class of the port's model and layer files is allowed
    allowed = tsnap._allowed_classes()
    for mod in (tflux, twan, tsdxl, tsd35, tqwen, tql):
        for obj in vars(mod).values():
            if (isinstance(obj, type) and issubclass(obj, torch.nn.Module)
                    and obj.__module__ == mod.__name__):
                assert allowed[f"{obj.__module__}.{obj.__qualname__}"] is obj


def test_jax_written_snapshot_is_refused(tmp_path):
    import jax.numpy as jnp

    jsnap.save_snapshot(str(tmp_path), {"transformer": {"w": jnp.ones((2, 2), jnp.int8)}},
                        architecture="flux", quant="int8", cfg=None)
    m = tsnap.load_manifest(str(tmp_path))  # the same manifest format
    with pytest.raises(ValueError, match="not a module of the port"):
        tsnap.load_tree(str(tmp_path), "transformer", m, device="cpu")


# ---------------------------------------------------- fingerprints and checks


def test_fingerprints_and_checks_match_jax(tmp_path):
    from fastdm_tpu.models import flux as jflux

    root = tmp_path / "ckpt"
    for rel, n in (("transformer/a.safetensors", 10), ("vae/b.bin", 3), ("x.json", 4)):
        os.makedirs(root / os.path.dirname(rel), exist_ok=True)
        (root / rel).write_bytes(b"\0" * n)
    assert tsnap.source_fingerprint(str(root)) == jsnap.source_fingerprint(str(root))
    assert tsnap.source_fingerprint(str(tmp_path / "nope")) is None
    assert tsnap._RUNTIME_ONLY_FIELDS == jsnap._RUNTIME_ONLY_FIELDS
    assert (tsnap.MANIFEST, tsnap._FORMAT_VERSION) == (jsnap.MANIFEST, jsnap._FORMAT_VERSION)
    for quant, mods in ((None, False), ("int8", False), ("int4p", True)):
        tc = tflux.FluxConfig(quant=quant, quant_mods=mods, **FLUX_CFG)
        jc = jflux.FluxConfig(quant=quant, quant_mods=mods, **FLUX_CFG)
        assert tsnap._cfg_fingerprint(tc) == jsnap._cfg_fingerprint(jc)
    base = tflux.FluxConfig(quant="int8", **FLUX_CFG)
    manifest = {"architecture": "flux", "quant": "int8", "config_class": "FluxConfig",
                "config": dict(tsnap._cfg_fingerprint(base), sparse_gather_superblock=4)}
    jbase = jflux.FluxConfig(quant="int8", **FLUX_CFG)
    cases = [("flux", "int8", {}), ("flux-krea", "int8", {}), ("flux", "fp8", {}),
             ("flux", "int8", {"num_layers": 3}), ("flux", "int8", {"quant_mods": True})]
    for arch, quant, change in cases:
        verdicts = []
        for snap, cfg in ((tsnap, base), (jsnap, jbase)):
            try:
                snap.check_compatible(manifest, architecture=arch, quant=quant,
                                      cfg=dataclasses.replace(cfg, **change))
                verdicts.append(None)
            except ValueError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1], (arch, quant, change)
        assert (verdicts[0] is None) == ((arch, quant, change) == cases[0])


# ------------------------------------------------------------------ engines


def _flux_root(tmp_path, monkeypatch):
    import fastdm_tpu_torch.engine as engine_mod

    rng = np.random.default_rng(0)
    root = str(tmp_path / "flux-tiny")
    _write_st(os.path.join(root, "transformer", "model.safetensors"), _flux_transformer_sd(rng))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(TINY, f)
    _write_st(os.path.join(root, "vae", "model.safetensors"), _vae_sd(rng))
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    return root


def _wan_root(tmp_path):
    root = str(tmp_path / "wan-tiny")
    for sub, seed in (("transformer", 31), ("transformer_2", 32)):
        _write_st(os.path.join(root, sub, "model.safetensors"),
                  _wan_sd(np.random.default_rng(seed)))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(dict(WAN_TINY, patch_size=[1, 2, 2]), f)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"boundary_ratio": 0.5}, f)
    return root


def _sdxl_root(tmp_path, monkeypatch):
    import fastdm_tpu_torch.engine as engine_mod

    rng = np.random.default_rng(9)
    root = str(tmp_path / "sdxl-tiny")
    _write_st(os.path.join(root, "unet", "model.safetensors"), _sdxl_sd(rng))
    _write_st(os.path.join(root, "vae", "model.safetensors"), _vae_sd(rng, latent_channels=4))
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "sdxl", tvae.VAEConfig(**VAE_TINY))
    tiny = tsdxl.SDXLConfig
    monkeypatch.setattr(tsdxl, "SDXLConfig", lambda quant=None: tiny(quant=quant, **SDXL_TINY))
    return root


def _generate_kw(family: str):
    rng = np.random.default_rng(5)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if family == "flux":
        return dict(prompt_embeds=r(1, 12, TINY["joint_attention_dim"]),
                    pooled_prompt_embeds=r(1, TINY["pooled_projection_dim"]), height=64,
                    width=64, num_inference_steps=2, seed=1)
    if family == "wan":
        return dict(prompt_embeds=r(1, 8, WAN_TINY["text_dim"]),
                    negative_prompt_embeds=r(1, 8, WAN_TINY["text_dim"]), height=32, width=32,
                    num_frames=5, num_inference_steps=2, seed=4, output_type="latent")
    return dict(prompt_embeds=r(1, 6, 16), pooled_prompt_embeds=r(1, 8),
                negative_prompt_embeds=r(1, 6, 16), negative_pooled_prompt_embeds=r(1, 8),
                height=64, width=64, num_inference_steps=2, guidance_scale=5.0, seed=3)


ENGINE_CASES = {
    "flux-bf16": ("flux", {}), "flux-int8": ("flux", {"use_int8": True}),
    "flux-fp8": ("flux", {"use_fp8": True}), "flux-int4": ("flux", {"use_int4": True}),
    "flux-int4p-mods": ("flux", {"use_int4": True, "pack_int4": True, "quant_mods": True}),
    "wan2.1-t2v-dual": ("wan2.1-t2v", {"use_int8": True}),
    "sdxl-int8": ("sdxl", {"use_int8": True}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_round_trip(tmp_path, monkeypatch, case):
    """The first engine writes the snapshot; the second reads it over a junk
    checkpoint (under FASTDM_SNAPSHOT_ALLOW_MISMATCH) with quantize_weight
    raising, and holds the same parameters and generates the same output
    bit for bit (tests/test_snapshot.py:110-281 for the JAX engine)."""
    from fastdm_tpu_torch.engine import FastDMEngine

    arch, flags = ENGINE_CASES[case]
    family = arch.split("2.1")[0].split("-")[0].rstrip(".")
    root = {"flux": _flux_root, "sdxl": _sdxl_root}[family](tmp_path, monkeypatch) \
        if family != "wan" else _wan_root(tmp_path)
    snap_dir = str(tmp_path / "snap")
    kw = dict(architecture=arch, verbose=False, device="cpu", snapshot_path=snap_dir, **flags)
    eng1 = FastDMEngine(root, **kw)
    m = tsnap.load_manifest(snap_dir)
    names = {"flux": ["transformer"], "wan": ["transformer", "transformer_2"],
             "sdxl": ["unet"]}[family]
    assert sorted(m["trees"]) == names and m["architecture"] == arch
    assert m["quant"] == eng1.quant and m["extra"]["source_files"] == \
        tsnap.source_fingerprint(root)

    # a new file in place of the checkpoint (the old one stays readable to the
    # tensors the first engine maps from it)
    ckpt = os.path.join(root, "unet" if family == "sdxl" else "transformer", "model.safetensors")
    os.rename(ckpt, ckpt + ".bak")
    with open(ckpt, "w") as f:
        f.write("not a checkpoint")
    monkeypatch.setenv("FASTDM_SNAPSHOT_ALLOW_MISMATCH", "1")

    def refuse(*a, **k):
        raise AssertionError("quantize_weight called on a snapshot load")

    monkeypatch.setattr(tql, "quantize_weight", refuse)
    eng2 = FastDMEngine(root, **kw)
    monkeypatch.delenv("FASTDM_SNAPSHOT_ALLOW_MISMATCH")
    assert_same_module(eng1.params, eng2.params)
    if family == "wan":
        assert eng2.params_2 is not None
        assert_same_module(eng1.params_2, eng2.params_2)
    gen = _generate_kw(family)
    np.testing.assert_array_equal(eng1.generate(**gen), eng2.generate(**gen))


def test_engine_manifest_equals_jax(tmp_path, monkeypatch):
    """The same tiny checkpoint and flags: the port's engine writes the
    manifest fields JAX's engine writes."""
    import fastdm_tpu.engine as jengine_mod
    from fastdm_tpu.pipeline.vae import VAEConfig as JVAEConfig
    from fastdm_tpu_torch.engine import FastDMEngine

    root = _flux_root(tmp_path, monkeypatch)
    monkeypatch.setitem(jengine_mod.VAE_CONFIGS, "flux", JVAEConfig(**VAE_TINY))
    jengine_mod.FastDMEngine(root, architecture="flux-dev", use_int8=True, verbose=False,
                             snapshot_path=str(tmp_path / "jax"))
    FastDMEngine(root, architecture="flux-dev", use_int8=True, verbose=False, device="cpu",
                 snapshot_path=str(tmp_path / "port"))
    jm = jsnap.load_manifest(str(tmp_path / "jax"))
    tm = tsnap.load_manifest(str(tmp_path / "port"))
    for k in ("architecture", "quant", "config_class", "config"):
        assert tm[k] == jm[k], k
    assert tm["extra"]["source_files"] == jm["extra"]["source_files"] is not None
    assert sorted(tm["trees"]) == sorted(jm["trees"])


def test_engine_refuses_stale_and_changed_snapshots(tmp_path, monkeypatch):
    from fastdm_tpu_torch.engine import FastDMEngine

    root = _flux_root(tmp_path, monkeypatch)
    snap_dir = str(tmp_path / "snap")
    kw = dict(verbose=False, device="cpu", snapshot_path=snap_dir)
    FastDMEngine(root, architecture="flux", use_int8=True, **kw)
    with pytest.raises(ValueError, match="incompatible"):
        FastDMEngine(root, architecture="flux", use_fp8=True, **kw)
    with pytest.raises(ValueError, match="incompatible"):
        FastDMEngine(root, architecture="flux-krea", use_int8=True, **kw)
    with pytest.raises(ValueError, match="incompatible"):
        FastDMEngine(root, architecture="flux", use_int8=True, quant_mods=True, **kw)
    assert FastDMEngine(root, architecture="flux", use_int8=True, **kw).params is not None
    with open(os.path.join(root, "transformer", "model.safetensors"), "ab") as f:
        f.write(b"\0" * 16)  # updated in place: same path, new size
    with pytest.raises(ValueError, match="weight files differ"):
        FastDMEngine(root, architecture="flux", use_int8=True, **kw)
    monkeypatch.setenv("FASTDM_SNAPSHOT_ALLOW_MISMATCH", "1")
    assert FastDMEngine(root, architecture="flux", use_int8=True, **kw).params is not None


def test_manifest_cfg_is_pinned_at_init(tmp_path, monkeypatch):
    """save_quantized after a runtime replace of the engine's cfg writes the
    init-time cfg, so the snapshot still passes check_compatible."""
    from fastdm_tpu_torch.engine import FastDMEngine

    root = _flux_root(tmp_path, monkeypatch)
    snap_dir = str(tmp_path / "snap")
    eng = FastDMEngine(root, architecture="flux", use_int8=True, verbose=False, device="cpu")
    eng.cfg = dataclasses.replace(eng.cfg, guidance_embeds=not eng.cfg.guidance_embeds)
    eng.save_quantized(snap_dir)
    eng2 = FastDMEngine(root, architecture="flux", use_int8=True, verbose=False, device="cpu",
                        snapshot_path=snap_dir)
    assert_same_module(eng.params, eng2.params)


def test_wan21_names(tmp_path):
    """wan2.1-t2v and the Wan2.1 image-branch names map to the Wan core as in
    JAX (fastdm_tpu/engine.py:54-56)."""
    from fastdm_tpu_torch.engine import ARCHITECTURES

    for name in ("wan2.1-t2v", "wan-i2v", "wan2.1-i2v"):
        assert ARCHITECTURES[name] == "wan", name


def test_engine_round_trip_wan21_i2v(tmp_path, monkeypatch):
    """A Wan2.1-I2V int8 engine writes its transformer with the image branch
    (image embedder, add_k / add_v) into the snapshot; a second engine reads
    it back with quantize_weight raising, the same parameters, and generates
    the same i2v latents from an image (the CLIP tower of image_encoder/ is
    not in the snapshot and is read from the checkpoint)."""
    from fastdm_tpu_torch.engine import FastDMEngine
    from test_torch_wan import _i2v_embeds, _write_i2v_checkpoint

    root = str(tmp_path / "wan21-i2v")
    _write_i2v_checkpoint(root)
    snap_dir = str(tmp_path / "snap")
    kw = dict(architecture="wan2.1-i2v", use_int8=True, verbose=False, device="cpu",
              snapshot_path=snap_dir)
    eng1 = FastDMEngine(root, **kw)
    assert sorted(tsnap.load_manifest(snap_dir)["trees"]) == ["transformer"]
    monkeypatch.setattr(tql, "quantize_weight", lambda *a, **k: 1 / 0)
    eng2 = FastDMEngine(root, **kw)
    assert_same_module(eng1.params, eng2.params)
    assert eng2.params.image_embedder is not None and eng2.wan_image_encoder is not None
    pos, neg = _i2v_embeds(3)
    gen = dict(image=np.random.default_rng(4).integers(0, 256, (32, 48, 3), dtype=np.uint8),
               prompt_embeds=pos, negative_prompt_embeds=neg, height=32, width=48,
               num_frames=5, num_inference_steps=2, seed=6, output_type="latent")
    np.testing.assert_array_equal(eng1.generate(**gen), eng2.generate(**gen))


# ------------------------------------------------------------ written on a mesh


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    from torch_parallel_workers import Pool

    pool = Pool(2, str(tmp_path_factory.mktemp("snap-store")))
    yield pool
    pool.close()


def assert_same_snapshot(got_dir: str, want_dir: str) -> None:
    """The same files (no part file left behind), the same manifest, and in
    every tree file the same tensors in dtype, shape and bytes."""
    from safetensors.torch import load_file

    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    with open(os.path.join(got_dir, tsnap.MANIFEST)) as f, \
            open(os.path.join(want_dir, tsnap.MANIFEST)) as g:
        assert json.load(f) == json.load(g)
    for name in os.listdir(want_dir):
        if name.endswith(".safetensors"):
            got = load_file(os.path.join(got_dir, name))
            want = load_file(os.path.join(want_dir, name))
            assert list(got) == list(want), name
            for k in want:
                assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
                assert torch.equal(_bytes(got[k]), _bytes(want[k])), k


MESH_CASES = [("flux", (1, 1, 2)), ("flux", (1, 1, 1, 2)), ("sdxl", (1, 1, 2))]


@pytest.mark.parametrize("family,shape", MESH_CASES,
                         ids=[f"{f}-{'x'.join(map(str, s))}" for f, s in MESH_CASES])
def test_snapshot_written_on_a_mesh_equals_one_device(pool2, tmp_path, family, shape):
    """An int8 engine under tp (1, 1, 2) or pp (1, 1, 1, 2) with an empty
    snapshot_path writes the snapshot a one-device engine writes from the
    same checkpoint, manifest for manifest and tensor for tensor (rank 0
    recorded each block whole before tp cut it; the other pp stage handed
    its blocks over); an engine on the same mesh reading it back generates
    bit for bit what the writing (freshly loaded) engine generated."""
    from test_torch_model_entry import _request, _write_root, tiny_engine
    from test_torch_pipeline import VAE_TINY as PIPE_VAE

    root = _write_root(family, str(tmp_path / "ckpt"))
    one = str(tmp_path / "one-device")
    tiny_engine(family, root, use_int8=True, snapshot_path=one)
    snap = str(tmp_path / "on-mesh")
    arch = "sdxl" if family == "sdxl" else "flux"
    requests = [_request(family, False)]
    kw = dict(sdxl_kw=SDXL_TINY if family == "sdxl" else None, use_int8=True,
              snapshot_path=snap)
    fresh = pool2.run("task_tp_engine", root, arch, requests, shape, dict(PIPE_VAE), **kw)
    assert_same_snapshot(snap, one)
    read = pool2.run("task_tp_engine", root, arch, requests, shape, dict(PIPE_VAE), **kw)
    for (got, _), (want, _) in zip(read, fresh):
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
