"""Worker processes of tests/test_torch_parallel.py: a pool of `world` ranks
under torch.distributed (gloo, a file:// store), each running the tasks the
test hands it. This module imports only the standard library, numpy, torch
and the port, so that a spawned worker never imports JAX; the tests compute
their JAX references in the parent.

    pool = Pool(world, store_dir)    # one pool per world size
    results = pool.run("task_ring", cases)   # [rank 0's result, rank 1's, ...]
    pool.close()

A task that does not answer within its timeout (a collective posted in
another order on some rank hangs under gloo rather than failing) closes the
pool and raises TimeoutError.
"""

from __future__ import annotations

import os
import queue
import sys
import traceback

import torch
import torch.multiprocessing as mp

TASK_TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pool:
    def __init__(self, world: int, store_dir: str, timeout: float = TASK_TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        store = os.path.join(store_dir, f"store-{world}")
        self.procs = [ctx.Process(target=_worker, args=(r, world, store, self.tasks[r],
                                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, task: str, *args, **kwargs) -> list:
        """task(*args, **kwargs) on every rank -> the ranks' results in rank order."""
        for q in self.tasks:
            q.put((task, args, kwargs))
        out, failed = [None] * self.world, []
        for _ in range(self.world):  # every rank's answer, so none is left queued
            try:
                rank, ok, value = self.results.get(timeout=self.timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{task} did not finish within {self.timeout} s") from None
            out[rank] = value
            if not ok:
                failed.append(f"{task} failed on rank {rank}:\n{value}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


def _worker(rank: int, world: int, store: str, tasks, results) -> None:
    import torch.distributed as dist

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            name, args, kwargs = item
            try:
                results.put((rank, True, globals()[name](*args, **kwargs)))
            except Exception:  # noqa: BLE001  (the parent reports it)
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- tasks


def _mesh(shape):
    from fastdm_tpu_torch.parallel.mesh import init_mesh

    return init_mesh(shape, "cpu")


def task_mesh(shape):
    """This rank's (coordinate, group ranks) on each axis of `shape`."""
    mesh = _mesh(shape)
    return {n: (mesh.axis(n).rank, mesh.axis(n).ranks) for n in mesh.names}


def task_ring(cases):
    """sdpa_ring over the sp group of a (1, world, 1) mesh, through the
    registry's route: the whole output of each case."""
    import torch.distributed as dist

    from fastdm_tpu_torch.kernels import scaled_dot_product_attention
    from fastdm_tpu_torch.parallel import cp_state
    from fastdm_tpu_torch.parallel.context_parallel import GroupRing

    mesh = _mesh((1, dist.get_world_size(), 1))
    outs = []
    with cp_state.cp_ring(GroupRing(mesh.axis("sp"))):
        for q, k, v, hq, hkv, d in cases:
            outs.append(scaled_dot_product_attention(q, k, v, hq, hkv, d))
    return outs


def _load(family: str, sd_path: str, cfg_kw: dict, stage_blocks=None, tp=None):
    """The family's model from a state-dict file; tp: a TPGroup whose
    rank's shard of each block the loader keeps."""
    from safetensors.torch import load_file

    from fastdm_tpu_torch.models.loader import TensorSource

    src = TensorSource(load_file(sd_path), "cpu")
    src.stage_blocks = stage_blocks
    if tp is not None:
        from fastdm_tpu_torch.parallel.tensor_parallel import shard_block

        src.shard = lambda path, block: shard_block(block, path, cfg, tp)
    if family == "flux":
        from fastdm_tpu_torch.models.flux import FluxConfig, flux_load

        cfg = FluxConfig(**cfg_kw)
        return flux_load(src, cfg), cfg
    if family == "wan":
        from fastdm_tpu_torch.models.wan import WanConfig, wan_load

        cfg = WanConfig(**cfg_kw)
        return wan_load(src, cfg), cfg
    if family == "sd35":
        from fastdm_tpu_torch.models.sd35 import SD3Config, sd3_load

        cfg = SD3Config(**cfg_kw)
        return sd3_load(src, cfg), cfg
    from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, qwen_load

    cfg = QwenImageConfig(**cfg_kw)
    return qwen_load(src, cfg), cfg


STACKS = {"flux": ("dual_blocks", "single_blocks"), "wan": ("blocks",), "qwen": ("blocks",)}
PREFIXES = {"flux": ("transformer_blocks", "single_transformer_blocks"), "wan": ("blocks",),
            "qwen": ("transformer_blocks",)}


def run_blocks(family: str, params, cfg, inputs: dict):
    """The family's block runner on `inputs` (the image-stream output)."""
    if family == "flux":
        from fastdm_tpu_torch.models.flux import flux_run_blocks

        return flux_run_blocks(params, cfg, inputs["hidden"], inputs["encoder"], inputs["temb"],
                               inputs["cos"], inputs["sin"])
    if family == "wan":
        from fastdm_tpu_torch.models.wan import wan_run_blocks

        return wan_run_blocks(params, cfg, inputs["hidden"], inputs["encoder"], inputs["temb"],
                              inputs["cos"], inputs["sin"])
    if family == "sd35":
        from fastdm_tpu_torch.models.sd35 import sd3_run_blocks

        return sd3_run_blocks(params, cfg, inputs["hidden"], inputs["encoder"], inputs["temb"])
    from fastdm_tpu_torch.models.qwenimage import qwen_run_blocks

    return qwen_run_blocks(params, cfg, inputs["hidden"], inputs["encoder"], inputs["temb"],
                           inputs["cos"], inputs["sin"])[0]


def held_blocks(family: str, params) -> dict:
    """{stack: indices of the blocks that hold parameters}."""
    return {name: [i for i, b in enumerate(getattr(params, name))
                   if any(True for _ in b.parameters())] for name in STACKS[family]}


def task_gpipe(family: str, sd_path: str, cfg_kw: dict, inputs: dict, shape):
    """The family's stacks loaded with this rank's stage placement and run
    through the GPipe route of its block runner over a (dp, 1, 1, pp) mesh
    -> (output, the blocks this rank holds)."""
    from fastdm_tpu_torch.parallel import pp_state
    from fastdm_tpu_torch.parallel.pipeline import GroupPipeline, stage_blocks

    mesh = _mesh(shape)
    pp = mesh.axis("pp")
    depths = dict(zip(PREFIXES[family], (cfg_kw["num_layers"], cfg_kw["num_single_layers"])
                      if family == "flux" else (cfg_kw["num_layers"],)))
    params, cfg = _load(family, sd_path, cfg_kw, stage_blocks(pp.size, pp.rank, depths))
    with torch.inference_mode(), pp_state.pp_pipeline(GroupPipeline(pp, mesh.axis("dp"))):
        out = run_blocks(family, params, cfg, inputs)
    return out, held_blocks(family, params)


def task_engine(root: str, architecture: str, requests, mesh_shape=None, **engine_kw):
    """A CPU FastDMEngine over root (with mesh_shape) -> the outputs of its
    generate(**kw) for each kw of `requests`, and the blocks it holds."""
    from fastdm_tpu_torch.engine import FastDMEngine

    eng = FastDMEngine(root, architecture=architecture, verbose=False, device="cpu",
                       mesh_shape=mesh_shape, **engine_kw)
    outs = [eng.generate(**kw) for kw in requests]
    held = [i for i, b in enumerate(eng.params.blocks) if any(True for _ in b.parameters())]
    return outs, held


def task_tp_blocks(family: str, sd_path: str, cfg_kw: dict, inputs: dict):
    """The family's blocks loaded as this rank's tp shards over a (1, 1,
    world) mesh and run on `inputs` -> (the image-stream output, bytes of
    this rank's block parameters)."""
    import torch.distributed as dist

    from fastdm_tpu_torch.parallel.offload import module_bytes
    from fastdm_tpu_torch.parallel.tensor_parallel import DistTPGroup, block_paths

    mesh = _mesh((1, 1, dist.get_world_size()))
    params, cfg = _load(family, sd_path, cfg_kw, tp=DistTPGroup(mesh.axis("tp")))
    with torch.inference_mode():
        out = run_blocks(family, params, cfg, inputs)
    return out, sum(module_bytes(params.get_submodule(p)) for p in block_paths(params))


def _engine(root: str, architecture: str, mesh_shape, vae_kw=None, sdxl_kw=None,
            **engine_kw):
    """A CPU FastDMEngine over root under mesh_shape. vae_kw: the tiny
    AutoencoderKL config of the family (the tests' shrunk VAE); sdxl_kw: the
    tiny SDXLConfig fields of an SDXL checkpoint (the engine reads no
    unet/config.json)."""
    import functools

    import fastdm_tpu_torch.engine as teng
    from fastdm_tpu_torch.models import sdxl as tsdxl
    from fastdm_tpu_torch.pipeline.vae import VAEConfig

    if vae_kw is not None:
        teng.VAE_CONFIGS[teng.ARCHITECTURES[architecture]] = VAEConfig(**vae_kw)
    base = getattr(tsdxl.SDXLConfig, "func", tsdxl.SDXLConfig)
    tsdxl.SDXLConfig = base if sdxl_kw is None else functools.partial(base, **sdxl_kw)
    return teng.FastDMEngine(root, architecture=architecture, verbose=False, device="cpu",
                             mesh_shape=mesh_shape, **engine_kw)


def task_tp_engine(root: str, architecture: str, requests, mesh_shape, vae_kw=None,
                   sparse_gather=None, sdxl_kw=None, **engine_kw):
    """_engine(...) -> ([(each request's output, the engine's cache skips
    after it)], the row-parallel QLinears of its denoiser and ControlNet).
    sparse_gather: FASTDM_SPARSE_GATHER for the call (the engine's radial
    sparse mode)."""
    os.environ.pop("FASTDM_SPARSE_GATHER", None)
    if sparse_gather is not None:
        os.environ["FASTDM_SPARSE_GATHER"] = sparse_gather
    eng = _engine(root, architecture, mesh_shape, vae_kw, sdxl_kw, **engine_kw)
    outs = []
    for kw in requests:
        outs.append((eng.generate(**kw), eng.last_cache_skips))
    trees = [t for t in (eng.params, getattr(eng, "params_2", None), eng.cn_params)
             if t is not None]
    n_row = sum(getattr(m, "tp_reduce", None) is not None for t in trees for m in t.modules())
    return outs, n_row


def task_tp_sdxl(sd_path: str, cfg_kw: dict, inputs: dict):
    """The SDXL UNet of a state-dict file loaded as this rank's tp shards
    over a (1, 1, world) mesh, its forward on `inputs` with the IP-Adapter
    tokens and without -> ([output with, output without], bytes of this
    rank's block parameters)."""
    import torch.distributed as dist
    from safetensors.torch import load_file

    from fastdm_tpu_torch.models.loader import TensorSource
    from fastdm_tpu_torch.models.sdxl import SDXLConfig, sdxl_forward, sdxl_load
    from fastdm_tpu_torch.parallel.offload import module_bytes
    from fastdm_tpu_torch.parallel.tensor_parallel import DistTPGroup, block_paths, shard_block

    tp = DistTPGroup(_mesh((1, 1, dist.get_world_size())).axis("tp"))
    cfg = SDXLConfig(**cfg_kw)
    src = TensorSource(load_file(sd_path), "cpu")
    src.shard = lambda path, block: shard_block(block, path, cfg, tp)
    unet = sdxl_load(src, cfg)
    i = inputs
    with torch.inference_mode():
        outs = [sdxl_forward(unet, cfg, i["sample"], i["t"], i["ctx"], i["pooled"],
                             i["time_ids"], ip_embeds=ip) for ip in (i["ip"], None)]
    return outs, sum(module_bytes(unet.get_submodule(p)) for p in block_paths(unet))


class TableEncoder:
    """A text encoder that looks prompts up: table[prompt] holds the
    embeddings a stand-in encoder of the parent gives for it."""

    def __init__(self, family: str, table: dict):
        self.family, self.table = family, table

    def encode(self, prompt, num_images_per_prompt=1):
        e = self.table[prompt]
        t = lambda a: torch.from_numpy(a).bfloat16().repeat(  # noqa: E731
            num_images_per_prompt, *([1] * (a.ndim - 1)))
        if self.family == "flux":
            return t(e["prompt_embeds"]), t(e["pooled_prompt_embeds"])
        return t(e["prompt_embeds"])

    def encode_with_image(self, prompt, images, num_images_per_prompt=1):
        return self.encode(prompt, num_images_per_prompt)


def task_serve(root: str, architecture: str, mesh_shape, vae_kw: dict, table: dict, calls):
    """The API server (examples/serve/api_server_torch.py) on a mesh through
    parallel/request_loop.serve: rank 0 runs each (route, request keywords)
    of `calls` through its Routes on the LeadEngine -> [(200, decoded
    image) or (status, detail)]; the other ranks follow -> the number of
    calls they ran. Either returns only after rank 0's shutdown."""
    import importlib.util

    from fastdm_tpu_torch.parallel import request_loop

    name = "_api_server_torch_worker"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "examples", "serve", "api_server_torch.py"))
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    api = sys.modules[name]
    eng = _engine(root, architecture, mesh_shape, vae_kw)
    eng.text_encoder = TableEncoder(eng.architecture, table)
    answers = []

    def front_end(lead):
        routes = api.Routes(lead, "tiny")
        for route, kw in calls:
            req = (api.EditRequest if route == "edit" else api.GenerateRequest)(**kw)
            try:
                answers.append((200, api.base64_to_image(getattr(routes, route)(req).image)))
            except api.HTTPError as e:
                answers.append((e.status_code, e.detail))

    done = request_loop.serve(eng, front_end)
    return answers if done["rank"] == 0 else done["followed"]


def task_dryrun(shape, model, inputs):
    """flux_dryrun_step over this pool's process group on the (dp, sp, tp)
    mesh `shape`, the whole bf16 model handed in -> (loss, tp rank, this
    rank's gradients by parameter name)."""
    from fastdm_tpu_torch.parallel.mesh import flux_dryrun_step

    loss, grads = flux_dryrun_step(mesh_shape=shape, device="cpu", params=model,
                                   inputs=inputs)
    ((rank, g),) = grads.items()
    return loss, rank, g


def tp_functions_case(group, inputs: dict) -> dict:
    """A column shard (tp_copy on its input), GELU, a row shard (tp_reduce of
    the f32 partial) and a gathered column shard (tp_gather) of one rank of
    `group`, in f32 -> the gradients of <cot, out> + <cot_g, gathered> in x
    and in the rank's weights."""
    from fastdm_tpu_torch.parallel.tensor_parallel import tp_copy, tp_gather, tp_reduce

    r, n = group.rank, group.size
    x = inputs["x"].clone().requires_grad_()
    w1, w2, wm = (inputs[k].chunk(n, dim=d)[r].clone().requires_grad_()
                  for k, d in (("w1", 1), ("w2", 0), ("wm", 1)))
    with torch.enable_grad():
        xc = tp_copy(x, group)
        out = tp_reduce(torch.nn.functional.gelu(xc @ w1) @ w2, group)
        gathered = tp_gather(tp_copy(x, group) @ wm, group)
        loss = (out * inputs["cot"]).sum() + (gathered * inputs["cot_g"]).sum()
        grads = torch.autograd.grad(loss, (x, w1, w2, wm))
    return dict(zip(("x", "w1", "w2", "wm"), grads), out=out.detach(),
                gathered=gathered.detach())


def task_tp_functions(inputs: dict):
    """tp_functions_case over the world as one DistTPGroup."""
    import torch.distributed as dist

    from fastdm_tpu_torch.parallel.mesh import Axis
    from fastdm_tpu_torch.parallel.tensor_parallel import DistTPGroup

    world = dist.get_world_size()
    group = DistTPGroup(Axis(world, dist.get_rank(), dist.group.WORLD, tuple(range(world))))
    return tp_functions_case(group, inputs)


def task_ring_grad(cases):
    """sdpa_ring's gradients over the sp group of a (1, world, 1) mesh:
    (dq, dk, dv) of <cot, out> for each (q, k, v, hq, hkv, d, cot) case."""
    import torch.distributed as dist

    from fastdm_tpu_torch.kernels import scaled_dot_product_attention
    from fastdm_tpu_torch.parallel import cp_state
    from fastdm_tpu_torch.parallel.context_parallel import GroupRing

    mesh = _mesh((1, dist.get_world_size(), 1))
    outs = []
    with cp_state.cp_ring(GroupRing(mesh.axis("sp"))):
        for q, k, v, hq, hkv, d, cot in cases:
            q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
            out = scaled_dot_product_attention(q, k, v, hq, hkv, d)
            outs.append(torch.autograd.grad(out, (q, k, v), cot))
    return outs
