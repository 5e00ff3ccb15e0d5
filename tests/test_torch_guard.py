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
FORBIDDEN = ("jax", "jaxlib", "fastdm_tpu", "transformers", "tokenizers", "sentencepiece",
             "regex", "ftfy")


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    """chip_smoke.py and the package's sources; the git-ignored build
    directory holds kernel build outputs (and, for GPU runs, unpacked copies
    of the whole tree), not sources of the port."""
    yield REPO / "chip_smoke.py"
    pkg = REPO / "fastdm_tpu_torch"
    yield from sorted(p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts)


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


# the CLIP image preprocessing and vision tower run where PIL is missing
NO_PIL = ("fastdm_tpu_torch/pipeline/image_processor.py", "fastdm_tpu_torch/models/clip_vision.py",
          "fastdm_tpu_torch/pipeline/text_encoder.py")


def test_image_preprocessing_and_vision_tower_import_no_pil():
    bad = [(p, m) for p in NO_PIL for m in _imports(REPO / p) if m == "PIL" or
           m.startswith("PIL.")]
    assert not bad, bad
    code = """
import sys
sys.modules["PIL"] = None
import numpy as np
from fastdm_tpu_torch.models import clip_vision
from fastdm_tpu_torch.pipeline.image_processor import CLIPImageProcessor
from fastdm_tpu_torch.pipeline.text_encoder import CLIPImageEncoder
x = CLIPImageProcessor()(np.full((30, 50, 3), 128, np.uint8))
print("SHAPE", tuple(x.shape), sorted(m for m in sys.modules if m.startswith("PIL")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "SHAPE (1, 3, 224, 224) ['PIL']" in out.stdout, out.stdout
