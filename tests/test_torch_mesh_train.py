"""FLUX's sharded training step (fastdm_tpu_torch/parallel/mesh.py
flux_dryrun_step) over (dp, sp, tp) meshes against JAX's value_and_grad of
the same loss, and the pieces it stands on: the tp collectives' autograd
Functions (parallel/tensor_parallel.py tp_reduce / tp_copy / tp_gather), the
ring-attention backward (parallel/context_parallel.py) and the training form
of run_virtual_ranks. torch.distributed runs for real: gloo worker pools of
tests/torch_parallel_workers.py (no JAX there), one pool per world size.

The JAX reference runs here, on one device: jax.value_and_grad of JAX's
flux_forward MSE at JAX's dryrun config (2 + 2 blocks, 4 heads of 32,
quant=None) with FASTDM_KERNEL_BACKEND=jnp, its params from
flux_init_random(jax.random.key(0)), the inputs from a numpy seed
(dryrun_inputs; JAX's own step draws them with jax.random). The port's
steps take JAX's params through flux_params_from_numpy; JAX's gradient tree
goes through the same converter with each rank's tp group, so that every
rank's shard is compared with JAX's.

Tolerances (measured values in brackets):
  * the loss within 1e-2 relative of JAX's [1.3e-6 to 8.0e-6], bit-equal on
    every rank;
  * every parameter's gradient within relative L2 5e-2 of JAX's (the
    whole-model bf16 bound of tests/test_torch_lora_train.py; XLA fuses and
    rounds at other points) [worst 1.09e-2 to 1.30e-2] and 2e-2 of the
    port's one-process step [worst 4.1e-3 to 7.0e-3]; a replicated
    parameter's gradient bit-equal on every rank;
  * the three Functions over world 2 in f32 within 1e-5 of the largest
    magnitude of unsharded autograd [1.6e-7];
  * the ring's gradients in f32 within 1e-5 relative L2 of SDPAFn on the
    whole sequence [2.3e-7], every rank's bit-equal, the virtual ring's
    bit-equal to the process group's (the accumulators travel in one order)
    but for cross-attention's dK and dV, summed over the ring in gloo's
    order, within 1e-6;
  * the step over virtual ranks bit-equal to the same step over gloo at tp
    2, where a sum over two ranks has one order (at tp 4 the f32 sums'
    orders differ and the bf16 gradients move by up to 8.6e-3).
"""

import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fastdm_tpu.models import flux as jflux
from fastdm_tpu_torch.kernels import scaled_dot_product_attention
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models.convert import flux_params_from_numpy
from fastdm_tpu_torch.parallel import cp_state
from fastdm_tpu_torch.parallel.context_parallel import VirtualRing
from fastdm_tpu_torch.parallel.mesh import DRYRUN_CONFIG, DRYRUN_GUIDANCE, DRYRUN_HT, \
    DRYRUN_T, DRYRUN_TXT, DRYRUN_WT, dryrun_inputs, flux_dryrun_step
from fastdm_tpu_torch.parallel.tensor_parallel import run_virtual_ranks, shard_copy, \
    virtual_groups

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_workers as workers  # noqa: E402
from torch_parallel_workers import Pool  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

LOSS_REL, JAX_REL_L2, PORT_REL_L2 = 1e-2, 5e-2, 2e-2
F32_ABS, RING_REL_L2 = 1e-5, 1e-5
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 1, 4), (1, 2, 4), (2, 2, 2)]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """{world: Pool}, each started at its first use and closed at the end."""
    made = {}
    store = str(tmp_path_factory.mktemp("mesh-train-store"))

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
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _reference():
    """(JAX params tree, JAX loss, JAX gradient tree, inputs) at the dryrun
    config, numpy leaves; value_and_grad jitted once."""
    cfg = jflux.FluxConfig(**DRYRUN_CONFIG)
    tcfg = tflux.FluxConfig(**DRYRUN_CONFIG)
    inputs = dryrun_inputs(tcfg, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FASTDM_KERNEL_BACKEND", "jnp")
        params = jax.jit(lambda k: jflux.flux_init_random(k, cfg))(jax.random.key(0))
        cos, sin = jflux.flux_rope_cache(cfg, DRYRUN_TXT, DRYRUN_HT, DRYRUN_WT)

        def loss_fn(params, hidden, encoder, pooled, target):
            b = hidden.shape[0]
            t = jnp.full((b,), DRYRUN_T, jnp.float32)
            g = jnp.full((b,), DRYRUN_GUIDANCE, jnp.float32)
            out = jflux.flux_forward(params, cfg, hidden, encoder, pooled, t, cos, sin,
                                     guidance=g)
            return jnp.mean((out.astype(jnp.float32) - target) ** 2)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, *(jnp.asarray(inputs[k], jnp.bfloat16) for k in ("hidden", "encoder",
                                                                     "pooled")),
            jnp.asarray(inputs["target"]))
    return jax.device_get(params), float(loss), jax.device_get(grads), inputs


@functools.lru_cache(maxsize=None)
def _port_model():
    return flux_params_from_numpy(_reference()[0], device="cpu")


@functools.lru_cache(maxsize=None)
def _one_process():
    """The port's step on one process: (loss, gradients by name)."""
    _, _, _, inputs = _reference()
    loss, grads = flux_dryrun_step(mesh_shape=(1, 1, 1), device="cpu", params=_port_model(),
                                   inputs=inputs)
    return loss, grads[0]


def _tcfg():
    return tflux.FluxConfig(**DRYRUN_CONFIG)


def _shards_of(model: nn.Module, tp: int) -> list:
    """Each tp rank's {name: tensor} of `model`'s parameters under the
    engine's split."""
    if tp == 1:
        return [dict(model.named_parameters())]
    return [dict(shard_copy(model, _tcfg(), g).named_parameters()) for g in virtual_groups(tp)]


def _as_model(grads: dict) -> nn.Module:
    """The whole model with each parameter replaced by its gradient."""
    model = _port_model()
    memo = {id(p): nn.Parameter(grads[n], requires_grad=False)
            for n, p in model.named_parameters()}
    return copy.deepcopy(model, memo)


@functools.lru_cache(maxsize=None)
def _want(tp: int):
    """(JAX's gradients, the one-process step's) as each tp rank's shards."""
    jgrads = _reference()[2]
    jax_shards = [dict(flux_params_from_numpy(jgrads, device="cpu", cfg=_tcfg(), tp=g)
                       .named_parameters()) for g in (virtual_groups(tp) if tp > 1 else [None])]
    return jax_shards, _shards_of(_as_model(_one_process()[1]), tp)


def _check_rank(grads: dict, rank: int, tp: int, label) -> tuple:
    jax_shards, port_shards = _want(tp)
    assert sorted(grads) == sorted(jax_shards[rank]), label
    worst_jax = worst_port = 0.0
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16 and g.shape == jax_shards[rank][name].shape, name
        worst_jax = max(worst_jax, _rel_l2(g, jax_shards[rank][name]))
        worst_port = max(worst_port, _rel_l2(g, port_shards[rank][name]))
    assert worst_jax <= JAX_REL_L2, (label, worst_jax)
    assert worst_port <= PORT_REL_L2, (label, worst_port)
    return worst_jax, worst_port


# ------------------------------------------------------------ the step


def test_one_process_step_matches_jax(capsys):
    """The port's step on one process against JAX's value_and_grad: the loss,
    every gradient (84 parameters: JAX's 34 stacked leaves unstacked), and
    JAX's printed line."""
    _, jloss, _, _ = _reference()
    loss, grads = _one_process()
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    assert len(grads) == 84
    _check_rank(grads, 0, 1, "one process")
    capsys.readouterr()
    flux_dryrun_step(1, device="cpu", params=_port_model(), inputs=_reference()[3])
    assert capsys.readouterr().out.strip() == \
        f"dryrun_multichip ok: mesh dp=1 sp=1 tp=1, loss={loss:.4f}, 84 grad leaves"


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, s)) for s in MESHES])
def test_mesh_step_matches_jax(pools, shape):
    """flux_dryrun_step over gloo, one process a rank: every rank's loss
    equal, within 1e-2 of JAX's; every rank's gradients (its shard) within
    relative L2 of JAX's and of the one-process step's."""
    _, jloss, _, inputs = _reference()
    world = int(np.prod(shape))
    per_rank = pools(world).run("task_dryrun", shape, _port_model(), inputs)
    losses = [loss for loss, _, _ in per_rank]
    assert all(x == losses[0] for x in losses), losses
    assert abs(losses[0] - jloss) <= LOSS_REL * abs(jloss)
    tp = shape[2]
    for r, (_, tp_rank, grads) in enumerate(per_rank):
        assert tp_rank == r % tp
        _check_rank(grads, tp_rank, tp, (shape, r))
    if tp > 1:
        # replicated parameters: every rank's gradient bit-equal (whole)
        rep = [n for n, t in _shards_of(_port_model(), tp)[0].items()
               if t is dict(_port_model().named_parameters())[n]]
        assert rep and all(torch.equal(g[n], per_rank[0][2][n])
                           for _, _, g in per_rank for n in rep)


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 2, 2)], ids=["1x1x2", "2x2x2"])
def test_virtual_ranks_match_process_group(pools, shape):
    """The same step over virtual ranks in this process (tp threads under
    run_virtual_ranks(grad=True), a VirtualRing, dp in sequence) against the
    gloo pool's ranks: bit for bit at tp 2."""
    _, _, _, inputs = _reference()
    loss, grads = flux_dryrun_step(mesh_shape=shape, device="cpu",
                                   params=_port_model(), inputs=inputs)
    assert sorted(grads) == list(range(shape[2]))
    per_rank = pools(int(np.prod(shape))).run("task_dryrun", shape, _port_model(), inputs)
    for ploss, tp_rank, pgrads in per_rank:
        assert ploss == loss
        assert all(torch.equal(grads[tp_rank][n], g) for n, g in pgrads.items())


def test_step_refusals():
    model = flux_init_random_tiny()
    with pytest.raises(ValueError, match="quant=None"):
        flux_dryrun_step(mesh_shape=(1, 1, 1), device="cpu",
                         cfg=tflux.FluxConfig(**dict(DRYRUN_CONFIG, quant="int8")))
    with pytest.raises(ValueError, match="do not fit dp=4"):
        flux_dryrun_step(mesh_shape=(4, 1, 1), device="cpu", params=model,
                         inputs=dryrun_inputs(_tcfg(), 2))
    with pytest.raises(ValueError, match=r"\(dp, sp, tp\)"):
        flux_dryrun_step(mesh_shape=(1, 1, 1, 2), device="cpu")


def flux_init_random_tiny():
    return tflux.flux_init_random(0, _tcfg(), device="cpu")


# ------------------------------------------------------------ the tp Functions


def _tp_inputs():
    rng = np.random.default_rng(3)
    arrs = dict(x=(5, 8), w1=(8, 12), w2=(12, 6), wm=(8, 10), cot=(5, 6), cot_g=(5, 10))
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in arrs.items()}


def _tp_unsharded(inputs):
    x, w1, w2, wm = (inputs[k].clone().requires_grad_() for k in ("x", "w1", "w2", "wm"))
    out = torch.nn.functional.gelu(x @ w1) @ w2
    gathered = x @ wm
    loss = (out * inputs["cot"]).sum() + (gathered * inputs["cot_g"]).sum()
    return dict(zip(("x", "w1", "w2", "wm"), torch.autograd.grad(loss, (x, w1, w2, wm))),
                out=out.detach(), gathered=gathered.detach())


@pytest.mark.parametrize("form", ["virtual", "gloo"])
def test_tp_functions_match_unsharded_autograd(pools, form):
    """tp_copy / tp_reduce / tp_gather over world 2: the outputs whole, x's
    gradient whole on both ranks, each rank's weight gradients its slice of
    the unsharded ones (column: w1 and wm columns; row: w2 rows)."""
    inputs = _tp_inputs()
    want = _tp_unsharded(inputs)
    if form == "virtual":
        groups = virtual_groups(2)
        got = run_virtual_ranks(lambda r: workers.tp_functions_case(groups[r], inputs), groups,
                                grad=True)
    else:
        got = pools(2).run("task_tp_functions", inputs)
    for r, g in enumerate(got):
        for k, dim in (("w1", 1), ("w2", 0), ("wm", 1)):
            w = want[k].chunk(2, dim=dim)[r]
            torch.testing.assert_close(g[k], w, rtol=0, atol=F32_ABS * w.abs().max().item())
        for k in ("x", "out", "gathered"):
            torch.testing.assert_close(g[k], want[k], rtol=0,
                                       atol=F32_ABS * want[k].abs().max().item())


# ------------------------------------------------------------ the ring backward


RING_CASES = {
    # name: (batch, sq, skv, hq, hkv, d)
    "self": (1, 24, 24, 4, 4, 32),
    "gqa": (2, 16, 16, 4, 2, 16),
    "cross": (1, 24, 10, 2, 2, 32),
    "indivisible": (1, 19, 19, 2, 2, 16),
}


def _ring_cases(n: int):
    rng = np.random.default_rng(10 + n)
    out = []
    for b, sq, skv, hq, hkv, d in RING_CASES.values():
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((b, sq, hq * d), (b, skv, hkv * d), (b, skv, hkv * d)))
        cot = torch.from_numpy(rng.standard_normal((b, sq, hq * d)).astype(np.float32))
        out.append((q, k, v, hq, hkv, d, cot))
    return out


def _whole_grads(q, k, v, hq, hkv, d, cot):
    from fastdm_tpu_torch.kernels.autograd import SDPAFn

    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = scaled_dot_product_attention(q, k, v, hq, hkv, d)
    assert isinstance(out.grad_fn, SDPAFn._backward_cls)
    return torch.autograd.grad(out, (q, k, v), cot)


def _virtual_grads(n, q, k, v, hq, hkv, d, cot):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    with cp_state.cp_ring(VirtualRing(n)):
        out = scaled_dot_product_attention(q, k, v, hq, hkv, d)
    return torch.autograd.grad(out, (q, k, v), cot), type(out.grad_fn).__name__


@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_matches_sdpa_on_the_whole_sequence(pools, n):
    """The ring's gradients, reached through the registry under autograd,
    over n VirtualRing ranks and over gloo's GroupRing (self, GQA, cross and
    a length n does not divide), against SDPAFn on the whole sequence."""
    cases = _ring_cases(n)
    per_rank = pools(n).run("task_ring_grad", cases)
    kinds = ("_RingSDPABackward", "_RingSDPABackward", "_RingGatherBackward",
             "SDPAFnBackward")
    for name, kind, case, *ranks in zip(RING_CASES, kinds, cases, *per_rank):
        want = _whole_grads(*case)
        got, fn = _virtual_grads(n, *case)
        assert fn == kind, (name, fn)
        for a, w in zip(got, want):
            assert _rel_l2(a, w) <= RING_REL_L2, name
        for grads in ranks:
            assert all(torch.equal(a, b) for a, b in zip(grads, ranks[0])), name
            if name == "cross":  # dK, dV summed over the ring: gloo's order, rank order
                assert all(_rel_l2(a, b) <= 1e-6 for a, b in zip(grads, got)), name
            else:
                assert all(torch.equal(a, b) for a, b in zip(grads, got)), name


def test_ring_rows_without_mass_stay_finite(monkeypatch):
    """A row that no block gives mass (every block's log-sum-exp -inf) gets
    a merged log-sum-exp of +inf, and the ring's backward gives it zero
    gradients, not NaN; the ring under autograd refuses causal attention."""
    import fastdm_tpu_torch.kernels as kernels
    from fastdm_tpu_torch.kernels.autograd import sdpa_backward, sdpa_delta
    from fastdm_tpu_torch.parallel.context_parallel import ring_attention

    real = kernels.scaled_dot_product_attention_lse

    def no_mass_row0(*args):
        out, lse = real(*args)
        out, lse = out.clone(), lse.clone()
        out[:, 0] = 0
        lse[:, :, 0] = float("-inf")
        return out, lse

    monkeypatch.setattr(kernels, "scaled_dot_product_attention_lse", no_mass_row0)
    q, k, v, hq, hkv, d, cot = _ring_cases(2)[0]
    shards = [(k[:, :12], v[:, :12]), (k[:, 12:], v[:, 12:])]
    out, lse = ring_attention(q[:, :12], *shards[0], 2, lambda k_, v_, s: lambda: shards[1],
                              hq, hkv, d, d**-0.5, with_lse=True)
    assert torch.isinf(lse[:, :, 0]).all() and (lse[:, :, 0] > 0).all()
    assert torch.isfinite(lse[:, :, 1:]).all() and not out[:, 0].any()
    do = cot[:, :12]
    grads = sdpa_backward(do, q[:, :12], *shards[1], None, lse, hq, hkv, d, d**-0.5,
                          delta=sdpa_delta(do, out, hq), grad_dtype=torch.float32)
    assert all(torch.isfinite(g).all() for g in grads)
    assert not grads[0][:, 0].any()
    monkeypatch.setattr(kernels, "scaled_dot_product_attention_lse", real)
    with cp_state.cp_ring(VirtualRing(2)), pytest.raises(NotImplementedError, match="non-causal"):
        scaled_dot_product_attention(q.requires_grad_(), k, v, hq, hkv, d, True)


def test_quantized_collectives_refuse_gradients():
    """Under autograd a quantized row shard (the MAX all-reduce of its
    statistics) and Wan's norm statistics raise, naming themselves; without
    a gradient they run as before."""
    from fastdm_tpu_torch.layers.qlinear import qlinear_random
    from fastdm_tpu_torch.parallel.tensor_parallel import norm_stats, qlinear_split_rows

    gen = torch.Generator().manual_seed(0)
    lin = qlinear_random(gen, 16, 8, quant="int8", device="cpu")
    shards = [qlinear_split_rows(lin, [(16, 1)], 2, r) for r in range(2)]
    x = torch.randn(3, 16, dtype=torch.bfloat16)

    def run(grad: bool):
        groups = virtual_groups(2)  # a failed run leaves its barrier broken
        for s, g in zip(shards, groups):
            s.tp_reduce = g
        return run_virtual_ranks(
            lambda r: shards[r](x[:, r * 8:(r + 1) * 8].clone().requires_grad_(grad)), groups,
            grad=True)

    with pytest.raises(RuntimeError) as err:
        run(True)
    assert isinstance(err.value.__cause__, NotImplementedError)
    assert "quantize_stats" in str(err.value.__cause__)
    outs = run(False)
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(NotImplementedError, match="norm_stats"):
        norm_stats(torch.randn(2, 4, requires_grad=True), virtual_groups(2)[0])
