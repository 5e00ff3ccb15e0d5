"""FLUX LoRA training on the port (fastdm_tpu_torch/training/lora.py,
kernels/autograd.py, examples/lora-train/train_torch.py) against the JAX
trainer (examples/lora-train/train.py) and XLA's derivatives of the jnp ops,
on a tiny config (2 dual + 2 single blocks, 4 heads x 32), the JAX random
params and LoRA trees moved across by the converters.

Tolerances: each Function's gradients against jax.vjp of its jnp op in f32
within 1e-5 of the largest magnitude (the same f32 formulas summed in
another order); in bf16 rmsnorm and rotembd within one bf16 ulp of the
largest magnitude (one rounding of f32 values that differ in their last
bits), sdpa within relative L2 2e-2 (JAX rounds dP to bf16, the port keeps
it in f32; measured up to 4.1e-3); merge_lora within one bf16 ulp; one
step's loss within 1e-2 relative (measured 2.4e-5) and the LoRA gradients
within relative L2 5e-2 of jax.value_and_grad of train.py's loss body (the
bf16 forwards round at different points: XLA fuses, the port rounds each
op; measured up to 1.6e-2 in a factor); AdamW against optax.adamw on the
same gradients within 1e-6 relative; three whole training steps against
JAX's within relative L2 5e-2 of the factors' change (measured 3.0-3.2e-2).
"""

import dataclasses
import functools
import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.kernels.jnp_backend import impl as jimpl
from fastdm_tpu.models import flux as jflux
from fastdm_tpu_torch.kernels import autograd as tag
from fastdm_tpu_torch.kernels import kernel_registry, rms_norm, rotary_pos_embedding, \
    scaled_dot_product_attention
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models.convert import flux_params_from_numpy, lora_from_numpy
from fastdm_tpu_torch.training import lora as tlora

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(num_layers=2, num_single_layers=2, attention_head_dim=32, num_attention_heads=4,
            joint_attention_dim=64, pooled_projection_dim=48, in_channels=16, out_channels=16,
            axes_dims_rope=(8, 12, 12), guidance_embeds=True, patch_size=1)
HT, WT, TXT = 4, 4, 7
RANK, SCALE, LR = 4, 0.75, 1e-3
BF16_ULP = 2.0**-7


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtrain():
    """examples/lora-train/train.py as a module. Importing it sets
    FASTDM_KERNEL_BACKEND=jnp (train.py:25), which the JAX registry reads at
    every call; the previous value is restored for the worker's later files."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FASTDM_KERNEL_BACKEND", "jnp")
        return _load("lora_train_jax", "examples/lora-train/train.py")


@pytest.fixture(scope="module")
def models():
    jcfg = jflux.FluxConfig(quant=None, **TINY)
    tcfg = tflux.FluxConfig(quant=None, **TINY)
    jparams = jax.jit(lambda k: jflux.flux_init_random(k, jcfg))(jax.random.key(1))
    tparams = flux_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want, rel: float):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _pair(arrs, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(np.asarray(a, np.float32)).to(td).requires_grad_() for a in arrs])


def _vjp_both(jfn, tfn, arrs, cot_seed: int, dtype: str):
    """Gradients of <cotangent, f(inputs)> by jax.vjp and by the port's
    Function, on the same numpy inputs and cotangents."""
    jin, tin = _pair(arrs, dtype)
    jout, vjp = jax.vjp(jax.jit(jfn), *jin)
    outs = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.default_rng(cot_seed)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    jcot = tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs))
    jgrads = vjp(jcot if isinstance(jout, tuple) else jcot[0])
    tout = tfn(*tin)
    touts = tout if isinstance(tout, tuple) else (tout,)
    tgrads = torch.autograd.grad(touts, tin, [torch.from_numpy(c).to(o.dtype)
                                              for c, o in zip(cots, touts)])
    for o, jo in zip(touts, outs):
        assert o.grad_fn is not None and o.shape == jo.shape
    return jgrads, tgrads


# ------------------------------------------------------------- the Functions


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_rmsnorm_grad_matches_jax_vjp(dtype, weighted):
    """On the strided per-head view _qk_headnorm hands the op (the q columns
    of a fused projection) with and without a weight."""
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((2, 6, 3 * 3 * 16))
    w = 1 + 0.1 * rng.standard_normal(16)

    def jfn(qkv, *w):
        return jimpl.rms_norm_jnp(qkv[..., :48].reshape(2, 6, 3, 16), w[0] if w else None, 1e-6)

    def tfn(qkv, *w):
        out = rms_norm(qkv[..., :48].reshape(2, 6, 3, 16), w[0] if w else None, 1e-6)
        assert isinstance(out.grad_fn, tag.RMSNormFn._backward_cls)
        return out

    arrs = [qkv, w] if weighted else [qkv]
    jg, tg = _vjp_both(jfn, tfn, arrs, 2, dtype)
    for a, b in zip(tg, jg):
        _close(a, b, 1e-5 if dtype == "f32" else BF16_ULP)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("is_neox", [False, True])
def test_rotary_grad_matches_jax_vjp(dtype, is_neox):
    """GQA widths (4 query heads, 2 key heads of 16); the backward is the op
    itself with sin negated."""
    rng = np.random.default_rng(3)
    q, k = rng.standard_normal((2, 5, 64)), rng.standard_normal((2, 5, 32))
    cos, sin = (rng.standard_normal((5, 8)).astype(np.float32) for _ in range(2))

    def jfn(q, k):
        return jimpl.rotary_pos_embedding_jnp(q, k, 16, jnp.asarray(cos), jnp.asarray(sin),
                                              is_neox)

    def tfn(q, k):
        return rotary_pos_embedding(q, k, 16, torch.from_numpy(cos), torch.from_numpy(sin),
                                    is_neox)

    jg, tg = _vjp_both(jfn, tfn, [q, k], 4, dtype)
    for a, b in zip(tg, jg):
        _close(a, b, 1e-5 if dtype == "f32" else BF16_ULP)


SDPA_CASES = {"mha": (4, 4), "gqa": (4, 2), "mqa": (4, 1)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_grad_matches_jax_vjp(dtype, case):
    hq, hkv = SDPA_CASES[case]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, hq * 16))
    k, v = (rng.standard_normal((2, 11, hkv * 16)) for _ in range(2))

    def jfn(q, k, v):
        return jimpl.sdpa_jnp(q, k, v, hq, hkv, 16, False, 0.3)

    def tfn(q, k, v):
        return scaled_dot_product_attention(q, k, v, hq, hkv, 16, False, 0.3)

    jg, tg = _vjp_both(jfn, tfn, [q, k, v], 6, dtype)
    for a, b in zip(tg, jg):
        if dtype == "f32":
            _close(a, b, 1e-5)
        else:
            assert _rel_l2(a, b) <= 2e-2


def test_sdpa_backward_chunks_agree_and_causal_raises():
    """The backward a KV head at a time equals it with every head in one
    chunk (f32, within 1e-6); causal attention with a gradient raises."""
    rng = np.random.default_rng(7)
    q, k, v, o, d = (torch.from_numpy(rng.standard_normal((1, 13, 4 * 16)).astype(np.float32))
                     for _ in range(5))
    k, v = k[..., :32], v[..., :32]
    from fastdm_tpu_torch.kernels.torch_backend import sdpa_lse_torch

    out, lse = sdpa_lse_torch(q, k, v, 4, 2, 16, 0.25)
    whole = tag.sdpa_backward(d, q, k, v, out, lse, 4, 2, 16, 0.25)
    per_head = tag.sdpa_backward(d, q, k, v, out, lse, 4, 2, 16, 0.25, chunk_bytes=1)
    for a, b in zip(per_head, whole):
        _close(a, b, 1e-6)
    with pytest.raises(NotImplementedError, match="causal"):
        scaled_dot_product_attention(q.requires_grad_(), k, v, 4, 2, 16, True)


def test_ops_without_grad_keep_the_serving_dispatch():
    """Under no_grad, or with no input requiring a gradient, the ops return
    the plain dispatch's tensors (no grad_fn); with one they go through the
    Functions."""
    q = torch.randn(1, 5, 32, requires_grad=True)
    with torch.no_grad():
        assert scaled_dot_product_attention(q, q, q, 2, 2, 16).grad_fn is None
    assert scaled_dot_product_attention(q.detach(), q.detach(), q.detach(), 2, 2,
                                        16).grad_fn is None
    out = scaled_dot_product_attention(q, q, q, 2, 2, 16)
    assert isinstance(out.grad_fn, tag.SDPAFn._backward_cls)
    assert set(kernel_registry._grads) == {"rmsnorm", "rotembd", "sdpa"}


# ------------------------------------------------------------ LoRA and step


def _jlora(jtrain, jparams, up_seed=None):
    """JAX init_lora's tree, up drawn non-zero when up_seed is given (at init
    up is 0 and down's gradient would be 0)."""
    lora = jtrain.init_lora(jparams, RANK, jax.random.key(0))
    if up_seed is None:
        return lora
    return _with_up(lora, np.random.default_rng(up_seed))


def _with_up(node, rng):
    if "down" in node:
        return {"down": node["down"],
                "up": jnp.asarray(0.01 * rng.standard_normal(node["up"].shape), jnp.float32)}
    return {k: _with_up(v, rng) for k, v in node.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if "down" in v:
            yield prefix + k, v
        else:
            yield from _leaves(v, f"{prefix}{k}.")


def test_init_lora_mirrors_jax_tree(jtrain, models):
    """The port's factors have JAX init_lora's keys (through
    lora_from_numpy) and shapes, down ~ 0.01 N(0, 1), up zero; the count
    train.py prints."""
    _, jparams, _, tparams = models
    jl = _jlora(jtrain, jparams)
    tl = tlora.init_lora(tparams, RANK, 0)
    conv = lora_from_numpy(jax.device_get(jl), device="cpu")
    assert sorted(conv) == sorted(tl)
    assert len(tl) == 2 * 8 + 2
    for path in tl:
        for f in ("down", "up"):
            assert tl[path][f].shape == conv[path][f].shape
            assert tl[path][f].dtype == torch.float32 and tl[path][f].requires_grad
        assert not tl[path]["up"].any()
    downs = torch.cat([p["down"].flatten() for p in tl.values()])
    assert abs(downs.std().item() - 0.01) < 1e-3
    n_jax = sum(x.size for x in jax.tree.leaves(jl))
    assert tlora.lora_count(tl) == n_jax
    assert all(not p.requires_grad for p in tparams.parameters())


def test_merge_lora_matches_jax(jtrain, models):
    _, jparams, _, tparams = models
    jl = _jlora(jtrain, jparams, up_seed=8)
    jm = jtrain.merge_lora(jparams, jl, SCALE)
    tm = tlora.merge_lora(tparams, lora_from_numpy(jax.device_get(jl), device="cpu"), SCALE)
    mods = dict(tparams.named_modules())
    assert len(tm) == 18
    for key, w in tm.items():
        path = key[:-2]
        name, idx = tlora.lora_name(path)
        node = jm
        for part in name.split("."):
            node = node[part]
        want = np.asarray(jnp.asarray(node["w"][idx], jnp.float32))
        assert w.dtype == torch.bfloat16 and w.shape == mods[path].w.shape
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(_np(w) - want) <= ulp).all()
        assert (_np(w) != _np(mods[path].w)).any()


def _step_inputs(seed: int):
    rng = np.random.default_rng(seed)
    return dict(x0=rng.standard_normal((1, HT * WT, TINY["in_channels"])).astype(np.float32),
                eps=rng.standard_normal((1, HT * WT, TINY["in_channels"])).astype(np.float32),
                t=rng.uniform(size=(1,)).astype(np.float32),
                embeds=rng.standard_normal((1, TXT, TINY["joint_attention_dim"]))
                .astype(np.float32),
                pooled=rng.standard_normal((1, TINY["pooled_projection_dim"])).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jtrain):
    """jax.value_and_grad of train.py's loss body (:144-156) with eps and t
    given, jitted once."""
    cfg = jflux.FluxConfig(quant=None, **TINY)
    cos, sin = jflux.flux_rope_cache(cfg, TXT, HT, WT)

    def loss_fn(lora, params, x0, eps, t, embeds, pooled):
        merged = jtrain.merge_lora(params, lora, SCALE)
        x_t = ((1 - t)[:, None, None] * x0 + t[:, None, None] * eps).astype(jnp.bfloat16)
        g = jnp.full(t.shape, 1.0, jnp.float32)
        v_pred = jflux.flux_forward(merged, cfg, x_t, embeds.astype(jnp.bfloat16),
                                    pooled.astype(jnp.bfloat16), t, cos, sin, guidance=g)
        return jnp.mean((v_pred.astype(jnp.float32) - (eps - x0)) ** 2)

    return jax.jit(jax.value_and_grad(loss_fn))


def _port_loss(tparams, tcfg, lora, inp):
    cos, sin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    batch = dict(latents=t["x0"], embeds=t["embeds"], pooled=t["pooled"])
    return tlora.flow_loss(tparams, tcfg, lora, SCALE, batch, t["eps"], t["t"], cos, sin)


def test_step_loss_and_grads_match_jax(jtrain, models):
    """One step's loss and the gradients of every down and up against
    jax.value_and_grad of train.py's loss, on the same x0, eps, t, embeds,
    pooled and a non-zero up handed across."""
    _, jparams, tcfg, tparams = models
    jl = _jlora(jtrain, jparams, up_seed=9)
    inp = _step_inputs(10)
    jloss, jgrads = _jax_value_and_grad(jtrain)(jl, jparams,
                                                *(jnp.asarray(v) for v in inp.values()))
    tl = lora_from_numpy(jax.device_get(jl), device="cpu")
    loss = _port_loss(tparams, tcfg, tl, inp)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-2 * float(jloss)
    conv = lora_from_numpy(jax.device_get(jgrads), device="cpu")
    worst = 0.0
    for path, f in tl.items():
        for k in ("down", "up"):
            assert f[k].grad is not None and f[k].grad.abs().max() > 0
            worst = max(worst, _rel_l2(f[k].grad, conv[path][k]))
    assert worst <= 5e-2, worst


def test_adamw_matches_optax():
    """make_optimizer's AdamW against optax.adamw(lr, weight_decay=0.0) on
    the same three gradients."""
    import optax

    rng = np.random.default_rng(11)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((3, 7)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = optax.adamw(LR, weight_decay=0.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    lora = {"x": {"down": torch.from_numpy(p0["a"]).requires_grad_(),
                  "up": torch.from_numpy(p0["b"]).requires_grad_()}}
    opt = tlora.make_optimizer(lora, LR)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        lora["x"]["down"].grad = torch.from_numpy(g["a"])
        lora["x"]["up"].grad = torch.from_numpy(g["b"])
        opt.step()
    for k, f in (("a", "down"), ("b", "up")):
        _close(lora["x"][f], jp[k], 1e-6)


def test_three_steps_match_jax_train_step(jtrain, models):
    """Three whole steps (loss, backward, AdamW) of train_step against the
    JAX loss's value_and_grad and optax.adamw, on the same per-step inputs:
    the losses within 1e-2 relative, the factors' change (all factors
    together) within relative L2 5e-2. AdamW's first steps move each element
    by about lr times the sign of its gradient, so an element whose gradient
    is smaller than the gradients' bf16 error moves the other way: one such
    element weighs ~2/sqrt(n) in a factor of n elements, which is why the
    factors are taken together."""
    import optax

    _, jparams, tcfg, tparams = models
    jl = _jlora(jtrain, jparams, up_seed=12)
    tl = lora_from_numpy(jax.device_get(jl), device="cpu")
    start = {p: {k: f[k].detach().clone() for k in f} for p, f in tl.items()}
    tx = optax.adamw(LR, weight_decay=0.0)
    state = tx.init(jl)
    opt = tlora.make_optimizer(tl, LR)
    cos, sin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    vg = _jax_value_and_grad(jtrain)
    for step in range(3):
        inp = _step_inputs(20 + step)
        jloss, g = vg(jl, jparams, *(jnp.asarray(v) for v in inp.values()))
        upd, state = tx.update(g, state, jl)
        jl = optax.apply_updates(jl, upd)
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        loss = tlora.train_step(tparams, tcfg, tl, opt, SCALE,
                                dict(latents=t["x0"], embeds=t["embeds"], pooled=t["pooled"]),
                                t["eps"], t["t"], cos, sin)
        assert abs(loss.item() - float(jloss)) <= 1e-2 * float(jloss)
    conv = lora_from_numpy(jax.device_get(jl), device="cpu")
    got, want = (torch.cat([(t[p][k].detach() - start[p][k]).flatten() for p in tl
                            for k in ("down", "up")]) for t in (tl, conv))
    assert _rel_l2(got, want) <= 5e-2


# ------------------------------------------------------------------ export


def _jax_export_shapes(jl):
    """train.py:191-211's keys and shapes for a JAX LoRA tree."""
    out = {}
    for name, v in _leaves(jl):
        d, u = np.asarray(v["down"]), np.asarray(v["up"])
        for li in range(d.shape[0]):
            out[f"{name}.{li}.lora_A.default.weight"] = d[li].T.shape
            out[f"{name}.{li}.lora_B.default.weight"] = u[li].T.shape
    return out


def test_export_keys_shapes_and_values(jtrain, models, tmp_path):
    """The exported file has train.py's keys and shapes, reads back (with
    safetensors.numpy) as down^T / up^T, and lora_merge.load_lora pairs
    every A with its B."""
    from safetensors.numpy import load_file

    _, jparams, _, tparams = models
    jl = _jlora(jtrain, jparams, up_seed=13)
    tl = lora_from_numpy(jax.device_get(jl), device="cpu")
    path = str(tmp_path / "lora.safetensors")
    assert tlora.export_lora(tl, path) == 36
    back = load_file(path)
    assert {k: v.shape for k, v in back.items()} == _jax_export_shapes(jl)
    for p, f in tl.items():
        name, idx = tlora.lora_name(p)
        np.testing.assert_array_equal(back[f"{name}.{idx}.lora_A.default.weight"],
                                      _np(f["down"]).T)
        np.testing.assert_array_equal(back[f"{name}.{idx}.lora_B.default.weight"],
                                      _np(f["up"]).T)
    pairs = _load("lora_merge_np", "examples/lora-gen/lora_merge.py").load_lora(path)
    assert len(pairs) == len(tl)
    for base, (down, up, scale) in pairs.items():
        assert down.shape[0] == RANK and up.shape[1] == RANK and scale == 1.0


def test_reference_export_writes_transposed_views_scrambled(tmp_path):
    """The fault of train.py:205-206 the port does not copy:
    safetensors.numpy.save_file of a transposed view writes the view's
    buffer under the transposed shape, so it reads back as a reshape of the
    factor, not its transpose; export_tensors writes the transpose."""
    from safetensors.numpy import load_file, save_file

    d = np.arange(12, dtype=np.float32).reshape(4, 3)
    save_file({"a": d.T}, str(tmp_path / "ref.safetensors"))
    back = load_file(str(tmp_path / "ref.safetensors"))["a"]
    assert back.shape == (3, 4)
    assert not np.array_equal(back, d.T)
    np.testing.assert_array_equal(back, d.reshape(3, 4))
    ours = tlora.export_tensors({"x.0.y": {"down": torch.from_numpy(d),
                                           "up": torch.from_numpy(d)}})
    np.testing.assert_array_equal(ours["x.y.0.lora_A.default.weight"].numpy(), d.T)


# -------------------------------------------------------------- the CLI


@dataclasses.dataclass(frozen=True)
class _TinyFlux(tflux.FluxConfig):
    num_layers: int = 2
    num_single_layers: int = 2
    attention_head_dim: int = 32
    num_attention_heads: int = 4
    joint_attention_dim: int = 64
    pooled_projection_dim: int = 48
    in_channels: int = 16
    out_channels: int = 16
    axes_dims_rope: tuple = (8, 12, 12)


def test_train_cli_on_cpu(monkeypatch, tmp_path, capsys):
    """train_torch.py's train() on the tiny config: train.py's lines, a
    finite loss each step, every up non-zero after a step, and the export
    read back."""
    from safetensors.numpy import load_file

    monkeypatch.setattr(tflux, "FluxConfig", _TinyFlux)
    cli = _load("train_torch", "examples/lora-train/train_torch.py")
    out = str(tmp_path / "cli.safetensors")
    res = cli.train(cli.parse_args(["--synthetic", "--steps", "3", "--rank", str(RANK),
                                    "--height", "64", "--width", "64", "--layers", "2",
                                    "--lr", "1e-3", "--output", out, "--device", "cpu"]))
    text = capsys.readouterr().out
    n = tlora.lora_count(res["lora"])
    assert f"lora params: {n / 1e6:.2f}M (rank {RANK})" in text
    assert "step 0: loss " in text and f"wrote {out} (36 tensors)" in text
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert all(f["up"].abs().max() > 0 for f in res["lora"].values())
    back = load_file(out)
    for p, f in res["lora"].items():
        name, idx = tlora.lora_name(p)
        np.testing.assert_array_equal(back[f"{name}.{idx}.lora_B.default.weight"],
                                      _np(f["up"]).T)


def test_qwen_refused_as_train_py_refuses(jtrain, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py", "--architecture", "qwen"])
    with pytest.raises(SystemExit) as want:
        jtrain.main()
    cli = _load("train_torch", "examples/lora-train/train_torch.py")
    with pytest.raises(SystemExit) as got:
        cli.main(["--architecture", "qwen", "--device", "cpu"])
    assert str(got.value) == str(want.value) == "qwen lora training lands next round"
