"""Quantized-snapshot save / load (port of fastdm_tpu/models/snapshot.py):
persist the denoiser modules AFTER quantization, so that an engine start
reads the exact tensors its forward consumes (int8 / fp8 / int4 carriers,
per-channel scales, column sums, the SVDQuant low-rank branches, packed int4
bytes) instead of parsing, fusing and quantizing the checkpoint again.

Layout of a snapshot directory (the JAX package's):
  fastdm_snapshot.json        manifest: architecture, quant, the config
                              dataclass, extra (the source checkpoint's
                              fingerprint) and one skeleton per saved tree
  <name>.safetensors          the tensors of tree <name> ("transformer", ...)

The port's trees are nn.Modules, not pytrees. A module node of the skeleton
names its class (resolved only against the port's own model and layer
modules, _CLASS_MODULES), its parameter slots (a tensor reference or None),
its child modules and its plain attributes of JSON types (an absent QLinear
weight is one: None); the loader rebuilds each module with cls.__new__ +
nn.Module.__init__ and register_parameter, so nothing is quantized again.
The port's modules hold no buffers; one that did is refused. A tensor is
stored in the layout of its storage: the (K, N) weight views of
K-contiguous (N, K) buffers (layers/qlinear.py) are written as the (N, K)
buffers and viewed back on load.

A snapshot is written by the port and read only by the port: one the JAX
package wrote (a pytree skeleton) is refused, never half-decoded.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from fastdm_tpu_torch.device import resolve_device

MANIFEST = "fastdm_snapshot.json"
_FORMAT_VERSION = 1

# Config fields that tune runtime execution only: they never change the
# weight tree a snapshot stores, so they do not invalidate it (the engine
# replaces them per generate: sparse tile shapes, dense warmup, FFN chunking)
_RUNTIME_ONLY_FIELDS = frozenset({
    "dense_layers", "sparse_gather_blocks", "sparse_gather_fine_blocks",
    "sparse_gather_superblock", "ffn_chunk_tokens", "split_qkv_proj",
})

# the port modules whose nn.Module classes a snapshot may name
_CLASS_MODULES = (
    "fastdm_tpu_torch.layers.attention", "fastdm_tpu_torch.layers.conv2d",
    "fastdm_tpu_torch.layers.embeddings", "fastdm_tpu_torch.layers.feedforward",
    "fastdm_tpu_torch.layers.ip_adapter", "fastdm_tpu_torch.layers.normalization",
    "fastdm_tpu_torch.layers.qlinear", "fastdm_tpu_torch.models.controlnets",
    "fastdm_tpu_torch.models.flux", "fastdm_tpu_torch.models.qwenimage",
    "fastdm_tpu_torch.models.sd35", "fastdm_tpu_torch.models.sdxl",
    "fastdm_tpu_torch.models.wan",
)
_TORCH_CONTAINERS = (nn.ModuleList, nn.ModuleDict, nn.ParameterDict, nn.Sequential)
# what nn.Module.__init__ puts in an instance's __dict__
_MODULE_INTERNALS = frozenset(vars(nn.Module()))


def _class_name(cls) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def _allowed_classes() -> Dict[str, type]:
    """Qualified name -> class, for every nn.Module class defined in
    _CLASS_MODULES and the torch containers the models use."""
    out = {_class_name(c): c for c in _TORCH_CONTAINERS}
    for mod_name in _CLASS_MODULES:
        mod = importlib.import_module(mod_name)
        for obj in vars(mod).values():
            if (isinstance(obj, type) and issubclass(obj, nn.Module)
                    and obj.__module__ == mod_name):
                out[_class_name(obj)] = obj
    return out


def _storage_order(t: torch.Tensor):
    """The permutation p with t.permute(p) contiguous (t's dims by falling
    stride), or None when t is already contiguous or no permutation is."""
    if t.is_contiguous():
        return None
    p = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    return p if t.permute(p).is_contiguous() else None


class _Encoder:
    def __init__(self):
        self.tensors: Dict[str, torch.Tensor] = {}
        self.allowed = _allowed_classes()

    def tensor(self, t: torch.Tensor, path: str) -> Dict[str, Any]:
        node: Dict[str, Any] = {"t": "tensor", "name": path}
        data = t.detach()
        perm = _storage_order(data)
        if perm is not None:
            data = data.permute(perm)
            node["perm"] = perm
        if data.dim() == 0:
            # stored as (1,), as the JAX package stores 0-d arrays
            data = data.reshape(1)
            node["scalar"] = True
        # a compact copy of its own: the writer refuses shared storage
        data = data.to("cpu", copy=True).contiguous()
        self.tensors[path] = data
        return node

    def value(self, v, path: str):
        """A plain attribute: JSON types, lists, tuples and str-keyed dicts."""
        if v is None:
            return {"t": "none"}
        if isinstance(v, (bool, int, float, str)):
            return {"t": "scalar", "v": v}
        if isinstance(v, (list, tuple)):
            return {"t": "list" if isinstance(v, list) else "tuple",
                    "v": [self.value(x, f"{path}/{i}") for i, x in enumerate(v)]}
        if isinstance(v, dict) and all(isinstance(k, str) for k in v):
            return {"t": "dict", "v": {k: self.value(x, f"{path}/{k}") for k, x in v.items()}}
        raise ValueError(f"snapshot: unsupported state {type(v).__name__} at {path!r} "
                         "(a module holds tensors, child modules and JSON-type attributes)")

    def module(self, m: nn.Module, path: str) -> Dict[str, Any]:
        name = _class_name(type(m))
        if self.allowed.get(name) is not type(m):
            raise ValueError(f"snapshot: {name} at {path!r} is not a model or layer class "
                             "of the port")
        if m._buffers:
            raise ValueError(f"snapshot: {name} at {path!r} holds buffers {sorted(m._buffers)}")
        join = (lambda k: f"{path}/{k}") if path else (lambda k: k)
        return {
            "t": "module", "class": name,
            "params": {k: None if p is None else self.tensor(p, join(k))
                       for k, p in m._parameters.items()},
            "modules": {k: None if c is None else self.module(c, join(k))
                        for k, c in m._modules.items()},
            "attrs": {k: self.value(v, join(k)) for k, v in vars(m).items()
                      if k not in _MODULE_INTERNALS},
        }


class _Decoder:
    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.tensors = tensors
        self.allowed = _allowed_classes()

    def tensor(self, node) -> torch.Tensor:
        t = self.tensors[node["name"]]
        if node.get("scalar"):
            t = t.reshape(())
        if "perm" in node:
            inv = sorted(range(t.dim()), key=lambda d: node["perm"][d])
            t = t.permute(inv)
        return t

    def value(self, node):
        t = node["t"]
        if t == "none":
            return None
        if t == "scalar":
            return node["v"]
        if t in ("list", "tuple"):
            seq = [self.value(x) for x in node["v"]]
            return seq if t == "list" else tuple(seq)
        if t == "dict":
            return {k: self.value(x) for k, x in node["v"].items()}
        raise ValueError(f"snapshot: bad attribute node {t!r}")

    def module(self, node) -> nn.Module:
        cls = self.allowed.get(node["class"])
        if cls is None:
            raise ValueError(f"snapshot: {node['class']!r} is not a model or layer class of "
                             "the port")
        m = cls.__new__(cls)
        nn.Module.__init__(m)
        for k, v in node["attrs"].items():
            object.__setattr__(m, k, self.value(v))
        for k, v in node["params"].items():
            m.register_parameter(k, None if v is None else nn.Parameter(self.tensor(v),
                                                                        requires_grad=False))
        for k, v in node["modules"].items():
            m.add_module(k, None if v is None else self.module(v))
        return m


def _cfg_fingerprint(cfg) -> Any:
    """JSON-normalized dataclass dict (tuples -> lists) for an exact compare,
    minus the runtime-only fields (_RUNTIME_ONLY_FIELDS)."""
    if cfg is None:
        return None
    d = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in _RUNTIME_ONLY_FIELDS}
    return json.loads(json.dumps(d))


def save_snapshot(dir_path: str, trees: Dict[str, nn.Module], *,
                  architecture: Optional[str] = None, quant: Optional[str] = None, cfg=None,
                  extra: Optional[Dict[str, Any]] = None) -> None:
    """Write `trees` ({"transformer": module, ...}) and the manifest to
    dir_path. Each file is written under a temporary name and moved into
    place (os.replace), the manifest last."""
    from safetensors.torch import save_file

    os.makedirs(dir_path, exist_ok=True)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "architecture": architecture,
        "quant": quant,
        "config_class": type(cfg).__name__ if cfg is not None else None,
        "config": _cfg_fingerprint(cfg),
        "extra": extra or {},
        "trees": {},
    }
    for name, tree in trees.items():
        enc = _Encoder()
        manifest["trees"][name] = enc.module(tree, "")
        path = os.path.join(dir_path, f"{name}.safetensors")
        save_file(enc.tensors, path + ".tmp", metadata={"fastdm_snapshot": name})
        os.replace(path + ".tmp", path)
    tmp = os.path.join(dir_path, MANIFEST + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(dir_path, MANIFEST))


def source_fingerprint(model_path: Optional[str]):
    """A cheap content fingerprint of a checkpoint directory's weight files:
    sorted [[relpath, size, mtime_ns], ...], or None when model_path is not a
    directory or holds no weight files. Recorded at save time and checked at
    load time, so a snapshot of other weights (or of a checkpoint updated in
    place) is refused."""
    if not model_path or not os.path.isdir(model_path):
        return None
    out = []
    for root, _, names in os.walk(model_path):
        for n in names:
            if n.endswith((".safetensors", ".bin")):
                p = os.path.join(root, n)
                st = os.stat(p)
                out.append([os.path.relpath(p, model_path).replace(os.sep, "/"),
                            st.st_size, st.st_mtime_ns])
    return sorted(out) or None


def is_snapshot(dir_path: str) -> bool:
    return os.path.isfile(os.path.join(dir_path, MANIFEST))


def load_manifest(dir_path: str) -> Dict[str, Any]:
    with open(os.path.join(dir_path, MANIFEST), "r", encoding="utf-8") as f:
        m = json.load(f)
    if m.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"snapshot format {m.get('format_version')} != {_FORMAT_VERSION}")
    return m


def load_tree(dir_path: str, name: str, manifest: Optional[Dict] = None,
              device="cuda") -> nn.Module:
    """Rebuild one saved module, its tensors read straight onto `device`."""
    from safetensors.torch import load_file

    manifest = manifest or load_manifest(dir_path)
    if name not in manifest["trees"]:
        raise KeyError(f"snapshot has no tree {name!r}; available: {sorted(manifest['trees'])}")
    skel = manifest["trees"][name]
    if skel.get("t") != "module":
        raise ValueError(f"snapshot {dir_path}: tree {name!r} is a {skel.get('t')!r} node, not a "
                         "module of the port (a snapshot written by the JAX package?); the port "
                         "reads only the snapshots it writes")
    dev = resolve_device(device)
    tensors = load_file(os.path.join(dir_path, f"{name}.safetensors"), device=str(dev))
    return _Decoder(tensors).module(skel)


def check_compatible(manifest: Dict[str, Any], *, architecture: str, quant: Optional[str],
                     cfg) -> None:
    """Raise if a snapshot was built for another architecture, quant or
    config: a stale snapshot must never serve wrong weights."""
    want = {
        "architecture": architecture,
        "quant": quant,
        "config_class": type(cfg).__name__ if cfg is not None else None,
        "config": _cfg_fingerprint(cfg),
    }
    have = {k: manifest.get(k) for k in want}
    if isinstance(have.get("config"), dict):
        # a runtime-only field in an older manifest does not invalidate it
        have["config"] = {k: v for k, v in have["config"].items()
                          if k not in _RUNTIME_ONLY_FIELDS}
    if have != want:
        diffs = []
        for k in want:
            if have[k] != want[k]:
                if k == "config" and isinstance(want[k], dict) and isinstance(have[k], dict):
                    fields = sorted(set(want[k]) | set(have[k]))
                    inner = [f"{f}: snapshot={have[k].get(f)!r} vs engine={want[k].get(f)!r}"
                             for f in fields if have[k].get(f) != want[k].get(f)]
                    diffs.append(f"config[{', '.join(inner)}]")
                else:
                    diffs.append(f"{k}: snapshot={have[k]!r} vs engine={want[k]!r}")
        raise ValueError("quantized snapshot is incompatible with this engine config — "
                         "rebuild it (delete the snapshot dir) or fix the flags: "
                         + "; ".join(diffs))
