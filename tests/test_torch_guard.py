"""The PyTorch/CUDA port stands alone: fastdm_tpu_torch and chip_smoke.py
import neither JAX nor the JAX package, nor the text packages the GPU
machine lacks (transformers, tokenizers, sentencepiece, regex, ftfy: the
port tokenizes and encodes prompts itself), checked two ways — a fresh
interpreter imports every module of the port and every module chip_smoke.py
names (at top level or inside its functions) and then inspects sys.modules,
and a scan of the sources finds no such import statement anywhere, including
imports that run only inside functions."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fastdm_tpu", "optax", "transformers", "tokenizers",
             "sentencepiece", "regex", "ftfy")


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


# the port's files outside the package: the ComfyUI nodes and the serving front-ends
FRONTEND_FILES = (REPO / "comfyui" / "nodes_torch.py",
                  *sorted((REPO / "examples" / "serve").glob("*_torch.py")))

# the port's CLI demos, TeaCache fitter and LoRA trainer
CLI_FILES = (*sorted((REPO / "examples" / "demo").glob("*_torch.py")),
             REPO / "examples" / "xcaching" / "fit_teacache_torch.py",
             REPO / "examples" / "lora-train" / "train_torch.py")


def _sources():
    """chip_smoke.py, the package's sources and the port's front-end and CLI
    files outside it; the git-ignored build directory holds kernel build
    outputs (and, for GPU runs, unpacked copies of the whole tree), not
    sources of the port."""
    yield REPO / "chip_smoke.py"
    pkg = REPO / "fastdm_tpu_torch"
    yield from sorted(p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts)
    yield from FRONTEND_FILES
    yield from CLI_FILES


def test_port_sources_import_no_jax():
    bad = [(str(p.relative_to(REPO)), m) for p in _sources() for m in _imports(p)
           if _forbidden(m)]
    assert not bad, bad


def test_port_imports_leave_no_jax_in_sys_modules():
    smoke_imports = sorted({m for m in _imports(REPO / "chip_smoke.py")
                            if m.startswith("fastdm_tpu_torch") or m.split(".")[0] in
                            ("torch", "numpy", "safetensors")})
    code = f"""
import importlib, pkgutil, sys
import fastdm_tpu_torch
for info in pkgutil.walk_packages(fastdm_tpu_torch.__path__, "fastdm_tpu_torch."):
    importlib.import_module(info.name)
for name in {smoke_imports!r}:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r}))
print("FORBIDDEN", bad)
print("PORT_MODULES", sum(m.startswith("fastdm_tpu_torch") for m in sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    n = int(out.stdout.split("PORT_MODULES ")[1].split()[0])
    assert n >= 20, out.stdout  # every module of the port really was imported


# the CLIP and Qwen2-VL image preprocessing, the vision towers, Qwen2.5-VL and
# its tokenizer run where PIL is missing
NO_PIL = ("fastdm_tpu_torch/pipeline/image_processor.py", "fastdm_tpu_torch/models/clip_vision.py",
          "fastdm_tpu_torch/pipeline/text_encoder.py", "fastdm_tpu_torch/models/qwen2_5_vl.py",
          "fastdm_tpu_torch/pipeline/tokenizers.py")


def test_image_preprocessing_and_vision_tower_import_no_pil():
    """The preprocessing, towers and Qwen2.5-VL import and run with PIL
    hidden (sys.modules["PIL"] = None)."""
    bad = [(p, m) for p in NO_PIL for m in _imports(REPO / p) if m == "PIL" or
           m.startswith("PIL.")]
    assert not bad, bad
    code = """
import sys
sys.modules["PIL"] = None
import numpy as np
from fastdm_tpu_torch.models import clip_vision
from fastdm_tpu_torch.models import qwen2_5_vl
from fastdm_tpu_torch.pipeline.image_processor import CLIPImageProcessor, Qwen2VLImageProcessor
from fastdm_tpu_torch.pipeline.text_encoder import CLIPImageEncoder, QwenImageTextEncoder
x = CLIPImageProcessor()(np.full((30, 50, 3), 128, np.uint8))
q, grid = Qwen2VLImageProcessor()(np.full((30, 50, 3), 128, np.uint8))
print("SHAPE", tuple(x.shape), sorted(m for m in sys.modules if m.startswith("PIL")))
print("QWEN", tuple(q.shape), grid.tolist())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "SHAPE (1, 3, 224, 224) ['PIL']" in out.stdout, out.stdout
    assert "QWEN (24, 1176) [[1, 4, 6]]" in out.stdout, out.stdout


# what the card's machine lacks: the front-ends import these only inside the
# functions that need them
SERVE_ONLY = ("PIL", "fastapi", "uvicorn", "pydantic", "imageio", "gradio")
FRONTEND_MODULES = ("fastdm_tpu_torch/model_entry.py", "fastdm_tpu_torch/common_args.py",
                    "fastdm_tpu_torch/comfyui_entry.py", "fastdm_tpu_torch/utils/logging.py",
                    "fastdm_tpu_torch/utils/profiling.py", "fastdm_tpu_torch/utils/png.py",
                    "fastdm_tpu_torch/pipeline/image_processor.py")


def _module_level_imports(path: Path):
    """Imports that run when the module is imported: its top-level
    statements, and those inside top-level if / try blocks."""
    body = list(ast.parse(path.read_text(), str(path)).body)
    while body:
        node = body.pop(0)
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try)):
            body.extend(node.body + node.orelse + getattr(node, "finalbody", []))
            body.extend(s for h in getattr(node, "handlers", []) for s in h.body)


def test_frontends_import_no_serving_package_at_module_level():
    assert len(FRONTEND_FILES) == 3, FRONTEND_FILES  # nodes, API server, Gradio UI
    files = [REPO / p for p in FRONTEND_MODULES] + list(FRONTEND_FILES)
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _module_level_imports(p)
           if m.split(".")[0] in SERVE_ONLY]
    assert not bad, bad


def test_server_codec_and_resampler_run_without_pil_fastapi_imageio():
    """With PIL, fastapi, uvicorn, imageio and gradio hidden, the API
    server, the PNG codec and the resampler import; one PNG round-trips
    through the server's helpers and the blend modes run."""
    code = """
import importlib.util, sys
for m in ("PIL", "fastapi", "uvicorn", "imageio", "gradio"):
    sys.modules[m] = None
import numpy as np
spec = importlib.util.spec_from_file_location("api_server_torch", "examples/serve/api_server_torch.py")
api = importlib.util.module_from_spec(spec)
sys.modules["api_server_torch"] = api
spec.loader.exec_module(api)
from fastdm_tpu_torch.pipeline.image_processor import resize_lanczos
from fastdm_tpu_torch.utils.png import decode_png, encode_png
img = (np.arange(5 * 7 * 3) % 251).astype(np.uint8).reshape(5, 7, 3)
back = api.base64_to_image(api.image_to_base64(img))
cat = api.process_multiple_images([img, resize_lanczos(img, 10, 3)], "concatenate")
print("ROUNDTRIP", bool((back == img).all()), cat.shape,
      sorted(m for m in ("PIL", "fastapi", "imageio") if sys.modules.get(m) is not None))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ROUNDTRIP True (5, 8, 3) []" in out.stdout, out.stdout


# parallel/ and the worker processes of tests/test_torch_parallel.py: a spawned
# worker imports only torch and the port
PARALLEL_FILES = (*sorted((REPO / "fastdm_tpu_torch" / "parallel").glob("*.py")),
                  REPO / "tests" / "torch_parallel_workers.py")


def test_parallel_and_its_workers_import_no_jax():
    """Every module of parallel/ is among the scanned sources, and neither
    it nor the test workers import JAX or the JAX package, at any depth; an
    interpreter that imports them all has no JAX module loaded."""
    scanned = set(_sources())
    names = {p.name for p in PARALLEL_FILES}
    assert {"mesh.py", "context_parallel.py", "pipeline.py", "cp_state.py", "pp_state.py",
            "offload.py"} <= names
    assert all(p in scanned for p in PARALLEL_FILES if p.parent.name == "parallel")
    bad = [(p.name, m) for p in PARALLEL_FILES for m in _imports(p) if _forbidden(m)]
    assert not bad, bad
    code = f"""
import sys
sys.path.insert(0, {str(REPO / "tests")!r})
import torch_parallel_workers
from fastdm_tpu_torch.parallel import context_parallel, cp_state, mesh, offload, pipeline, pp_state
print("FORBIDDEN", sorted(m for m in sys.modules
                          if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_cli_demos_and_fitter_import_no_jax_nor_pil():
    """The CLI demos, the TeaCache fitter and the LoRA trainer are among the
    scanned sources and import nothing of JAX or optax at any depth; a fresh
    interpreter with PIL, imageio and optax hidden (the GPU machine has
    none of them) loads each of them and every port module their mains
    reach, and has no JAX module loaded."""
    names = sorted(p.name for p in CLI_FILES)
    assert names == ["controlnet_demo_torch.py", "fit_teacache_torch.py", "gen_torch.py",
                     "image_edit_torch.py", "train_torch.py"], names
    assert set(CLI_FILES) <= set(_sources())
    bad = [(p.name, m) for p in CLI_FILES for m in _imports(p) if _forbidden(m)]
    assert not bad, bad
    code = f"""
import importlib.util, sys
for m in ("PIL", "imageio", "optax"):
    sys.modules[m] = None
for path in {[str(p) for p in CLI_FILES]!r}:
    sys.path.insert(0, path.rsplit("/", 1)[0])
    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[1][:-3], path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
import fastdm_tpu_torch.engine, fastdm_tpu_torch.models.sd35, fastdm_tpu_torch.models.qwenimage
import fastdm_tpu_torch.training.lora
print("FORBIDDEN", sorted(m for m, mod in sys.modules.items() if mod is not None
                          and any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
