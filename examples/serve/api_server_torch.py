"""The API server on the PyTorch/CUDA port (port of examples/serve/api_server.py).

The reference server's routes and schema:
  GET  /health, GET /get_model_info
  POST /generate  -- an image (PNG, base64) or, for Wan, a video (MP4, base64)
  POST /edit      -- source images blended as average / concatenate / first /
                     list
plus the wan-lightning / wan-i2v-lightning architecture names, which serve
the distilled 4-step, guidance-1.0 defaults.

The routes are plain functions of `Routes`, which raise HTTPError(status,
detail); `build_app` binds them to FastAPI where FastAPI imports. Images are
(H, W, 3) uint8 numpy arrays, encoded and decoded as PNG by the port's own
codec (fastdm_tpu_torch/utils/png.py) and resized by its Pillow-exact LANCZOS
(pipeline/image_processor.py), so the request path needs neither PIL nor
FastAPI. A source image in another format is decoded through PIL where PIL
imports, and refused with 400, naming its format, where it does not.

    python examples/serve/api_server_torch.py --model-path CKPT \\
        --architecture flux --use-int8 --served-model-name flux

On a mesh, one process a device; rank 0 listens and broadcasts each
request to the other ranks (fastdm_tpu_torch/parallel/request_loop.py):

    torchrun --nproc-per-node 4 examples/serve/api_server_torch.py \\
        --model-path CKPT --mesh-shape 1,1,4 --use-int8 --served-model-name flux
"""

from __future__ import annotations

import argparse
import base64
import binascii
import dataclasses
import logging
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from fastdm_tpu_torch.common_args import add_engine_args, engine_kwargs  # noqa: E402
from fastdm_tpu_torch.parallel import request_loop  # noqa: E402
from fastdm_tpu_torch.pipeline.image_processor import resize_lanczos  # noqa: E402
from fastdm_tpu_torch.utils.png import decode_image_bytes, encode_png  # noqa: E402

logger = logging.getLogger("fastdm_tpu_torch.serve")

# the reference's distilled-Wan names -> (architecture, lightning)
LIGHTNING = {"wan-lightning": "wan2.2-t2v", "wan-i2v-lightning": "wan2.2-i2v"}


class HTTPError(Exception):
    """A failed request: the HTTP status and its cause."""

    def __init__(self, status_code: int, detail: str):
        super().__init__(f"{status_code}: {detail}")
        self.status_code = status_code
        self.detail = detail


@dataclasses.dataclass
class GenerateRequest:
    model: str
    prompt: str
    negative_prompt: Optional[str] = None
    steps: Optional[int] = 25
    guidance_scale: Optional[float] = 3.5
    true_cfg_scale: Optional[float] = 4.0   # Qwen's true CFG
    seed: int = 0
    width: Optional[int] = 1024
    height: Optional[int] = 1024
    num_frames: Optional[int] = 121         # Wan
    fps: int = 24                           # Wan
    max_seq_len: Optional[int] = 512
    input_image: Optional[str] = None       # base64 source image (i2v)


@dataclasses.dataclass
class EditRequest(GenerateRequest):
    input_images: Optional[Union[str, List[str]]] = None
    blend_mode: Optional[str] = "list"      # average | concatenate | first | list
    concat_direction: Optional[str] = "horizontal"  # horizontal | vertical


@dataclasses.dataclass
class GenerateResponse:
    success: bool
    type: str  # "image" or "video"
    image: Optional[str] = None
    video: Optional[str] = None
    format: str = "png"
    fps: Optional[int] = None
    frames: Optional[int] = None
    generation_time: float = 0.0
    model_used: str = ""
    parameters: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ModelInfo:
    model_name: str = ""


def image_to_base64(image) -> str:
    """An (H, W, 3) uint8 array -> base64 PNG."""
    return base64.b64encode(encode_png(np.asarray(image, np.uint8))).decode()


def base64_to_image(b64: str) -> np.ndarray:
    """base64 image -> (H, W, 3) uint8 RGB."""
    try:
        data = base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError) as e:
        raise ValueError(f"not base64: {e}") from e
    return decode_image_bytes(data)


def video_to_base64_mp4(frames, fps: int) -> str:
    """(F, H, W, 3) uint8 -> base64 MP4 (imageio, imported here)."""
    import imageio

    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as tmp:
        path = tmp.name
    try:
        imageio.mimsave(path, list(frames), fps=fps)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    finally:
        os.unlink(path)


def _rgb(img: np.ndarray) -> np.ndarray:
    """An (H, W), (H, W, 3) or (H, W, 4) uint8 array as RGB (Image.convert)."""
    img = np.asarray(img)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def concatenate_images(images, direction: str = "horizontal"):
    """Side by side (or stacked) at the smallest common height (width),
    each resized with its aspect kept (LANCZOS)."""
    if not images:
        return None
    if len(images) == 1:
        return images[0]
    if direction == "vertical":
        min_w = min(img.shape[1] for img in images)
        resized = [resize_lanczos(img, int(min_w * img.shape[0] / img.shape[1]), min_w)
                   for img in images]
        return np.concatenate(resized, axis=0)
    min_h = min(img.shape[0] for img in images)
    resized = [resize_lanczos(img, min_h, int(min_h * img.shape[1] / img.shape[0]))
               for img in images]
    return np.concatenate(resized, axis=1)


def process_multiple_images(images, blend_mode: str = "list",
                            concat_direction: str = "horizontal"):
    """'first' -> the first image, 'list' -> the list untouched, 'average'
    -> the pixel mean at the first image's size, 'concatenate' -> the
    aspect-keeping concatenation; one image passes through."""
    if not images:
        return None
    rgb = [_rgb(img) for img in images if isinstance(img, np.ndarray)]
    if not rgb:
        return None
    if len(rgb) == 1:
        return rgb[0]
    if blend_mode == "first":
        return rgb[0]
    if blend_mode == "list":
        return rgb
    if blend_mode == "average":
        h, w = rgb[0].shape[:2]
        arrays = [np.asarray(resize_lanczos(img, h, w), dtype=np.float32) for img in rgb]
        return np.mean(arrays, axis=0).astype(np.uint8)
    if blend_mode == "concatenate":
        return concatenate_images(rgb, concat_direction)
    return rgb[0]


class Routes:
    """The server's routes on one engine. `timings` holds the last request's
    seconds: source decode, generate and result encode."""

    def __init__(self, engine, served_model_name: str, wan_lightning: bool = False):
        self.engine = engine
        self.model_info = ModelInfo(model_name=served_model_name)
        self.wan_lightning = wan_lightning
        self.is_video = engine.architecture == "wan"
        self.needs_input_image = "i2v" in getattr(engine, "architecture_full", "")
        self.timings: Dict[str, float] = {}

    def _check(self, req) -> None:
        if not req.prompt.strip():
            raise HTTPError(400, "prompt must not be empty")
        if req.model != self.model_info.model_name:
            raise HTTPError(400, f"unsupported model: {req.model}")

    def _base_params(self, req) -> Dict[str, Any]:
        # the reference's spellings, which FastDMEngine.generate maps
        p = {"prompt": req.prompt, "steps": req.steps, "guidance_scale": req.guidance_scale,
             "gen_seed": req.seed, "gen_width": req.width, "gen_height": req.height,
             "max_seq_len": req.max_seq_len}
        if req.negative_prompt:
            p["negative_prompt"] = req.negative_prompt
        if self.engine.architecture == "qwen":
            p["true_cfg_scale"] = req.true_cfg_scale
        return p

    def _run(self, what: str, params: Dict[str, Any]):
        t0 = time.perf_counter()
        try:
            out = self.engine.generate(**params)
        except Exception as e:  # noqa: BLE001  (answered as 500 with its cause)
            logger.exception("%s failed", what)
            raise HTTPError(500, f"{what} failed: {e}") from e
        dt = time.perf_counter() - t0
        self.timings["generate_s"] = dt
        logger.info("%s done in %.2fs", what, dt)
        return out, dt

    def _encode(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.timings["encode_s"] = time.perf_counter() - t0
        return out

    def health(self) -> Dict[str, str]:
        return {"status": "ok", "architecture": self.engine.architecture}

    def get_model_info(self) -> ModelInfo:
        return self.model_info

    def generate(self, req: GenerateRequest) -> GenerateResponse:
        self._check(req)
        self.timings = {"decode_s": 0.0}
        if self.needs_input_image and not req.input_image:
            raise HTTPError(400, "i2v requires input_image")
        if self.wan_lightning:  # the distilled 4-step serving defaults
            req.guidance_scale = 1.0
            req.steps = 4
        params = self._base_params(req)
        if self.is_video:
            params["num_frames"] = req.num_frames
        if req.input_image:
            t0 = time.perf_counter()
            try:
                params["src_image"] = base64_to_image(req.input_image)
            except ValueError as e:
                raise HTTPError(400, f"invalid source image: {e}") from e
            self.timings["decode_s"] = time.perf_counter() - t0
        out, dt = self._run("generation", params)
        if self.is_video:
            frames = out[0] if getattr(out, "ndim", 4) == 5 else out  # drop the batch
            return GenerateResponse(
                success=True, type="video",
                video=self._encode(video_to_base64_mp4, frames, req.fps), format="mp4",
                fps=req.fps, frames=len(frames), generation_time=dt, model_used=req.model)
        img = out[0] if getattr(out, "ndim", 3) == 4 else out
        return GenerateResponse(
            success=True, type="image", image=self._encode(image_to_base64, img), format="png",
            generation_time=dt, model_used=req.model,
            parameters={k: v for k, v in params.items() if k != "src_image"})

    def edit(self, req: EditRequest) -> GenerateResponse:
        self._check(req)
        raw = req.input_images
        if isinstance(raw, str):
            raw = [raw]
        if not raw:
            raise HTTPError(400, "edit requires at least one input image")
        t0 = time.perf_counter()
        try:
            imgs = [base64_to_image(b) for b in raw]
        except ValueError as e:
            raise HTTPError(400, f"invalid image data: {e}") from e
        processed = process_multiple_images(imgs, req.blend_mode, req.concat_direction)
        self.timings = {"decode_s": time.perf_counter() - t0}
        params = self._base_params(req)
        if processed is not None:
            params["src_image"] = processed
        out, dt = self._run("edit", params)
        img = out[0] if getattr(out, "ndim", 3) == 4 else out
        return GenerateResponse(success=True, type="image",
                                image=self._encode(image_to_base64, img), format="png",
                                generation_time=dt, model_used=req.model)


def build_app(engine, served_model_name: str, wan_lightning: bool = False):
    """The FastAPI app of the routes (FastAPI takes the dataclasses as the
    request and response schemas)."""
    from fastapi import FastAPI, HTTPException

    routes = Routes(engine, served_model_name, wan_lightning)
    app = FastAPI(title="FastDM API (PyTorch/CUDA port)", version="1.0.0", docs_url="/docs",
                  redoc_url="/redoc")

    def http(fn, *args):
        try:
            return fn(*args)
        except HTTPError as e:
            raise HTTPException(e.status_code, e.detail) from e

    @app.post("/generate", response_model=GenerateResponse)
    def generate(req: GenerateRequest):
        return http(routes.generate, req)

    @app.post("/edit", response_model=GenerateResponse)
    def edit(req: EditRequest):
        return http(routes.edit, req)

    @app.get("/get_model_info", response_model=ModelInfo)
    def get_model_info():
        return routes.get_model_info()

    @app.get("/health")
    def health():
        return routes.health()

    return app


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("fastdm_tpu_torch api server")
    add_engine_args(parser, extra_architectures=tuple(LIGHTNING))
    parser.add_argument("--served-model-name", type=str, required=True)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    return parser


def make_engine(args):
    """(FastDMEngine, wan_lightning) from the parsed flags; a lightning name
    loads its checkpoint as the Wan architecture it names."""
    from fastdm_tpu_torch.engine import FastDMEngine

    wan_lightning = args.architecture in LIGHTNING
    if wan_lightning:
        args.architecture = LIGHTNING[args.architecture]
    return FastDMEngine(**engine_kwargs(args)), wan_lightning


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    try:
        import uvicorn
    except ImportError:
        raise SystemExit("fastapi/uvicorn not installed in this environment") from None
    t0 = time.time()
    engine, wan_lightning = make_engine(args)
    logger.info("Model loading latency: %.4f seconds", time.time() - t0)
    # on a mesh, rank 0 serves and the other ranks follow its broadcasts
    request_loop.serve(engine, lambda eng: uvicorn.run(
        build_app(eng, args.served_model_name, wan_lightning), host=args.host, port=args.port))


if __name__ == "__main__":
    main()
