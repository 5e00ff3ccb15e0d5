"""The port's API server (examples/serve/api_server_torch.py) and its image
I/O without PIL:

  * the PNG codec (fastdm_tpu_torch/utils/png.py) both ways against PIL,
    bit for bit, over every supported colour type and row filter, and its
    refusals;
  * resize_lanczos bit for bit with PIL.Image.resize(LANCZOS), shrinking
    and enlarging;
  * process_multiple_images / concatenate_images equal to
    examples/serve/api_server.py's (loaded by path, as
    tests/test_api_server.py does);
  * the routes, called as functions, on tiny CPU engines whose text
    encoder is a seeded stand-in (prompt strings -> fixed embeddings; the
    encoders themselves are tests/test_torch_text_engine.py's):
    /generate's PNG decodes to generate() in the diffusers spelling, bit for
    bit; Qwen's true_cfg_scale; wan-lightning's 4 steps at guidance 1.0
    with the (F, H, W, 3) frames handed to the video encoder; /edit in all
    four blend modes; 400 for an empty prompt, a wrong model, i2v without
    an image, bad base64 and a non-PNG image without PIL; 500 with the
    cause;
  * the rank-0 request loop (fastdm_tpu_torch/parallel/request_loop.py) on a
    2-rank gloo pool (tests/torch_parallel_workers.py): /generate and /edit
    answered with the one-process server's images, bit for bit; a refused
    request answered 400 and never broadcast; the followers end at the
    shutdown; and, in one process with the broadcast stubbed, what the
    leader broadcasts, the engine state it carries and the failures that
    end the run."""

import base64
import importlib.util
import io
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fastdm_tpu_torch.pipeline.image_processor import resize_lanczos
from fastdm_tpu_torch.utils.png import decode_png, encode_png

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model_entry import _flux_root, _write_root, embeds, tiny_engine  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

SERVE = os.path.join(os.path.dirname(__file__), "..", "examples", "serve")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test",
                                                  os.path.join(SERVE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


api = _load("api_server_torch")


def _image(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """A smooth gradient with noise: PIL's adaptive filtering picks every
    row filter on it."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (3 + k) + y * (5 - k) + 40 * k) % 256 for k in range(c)], -1)
    return (base + rng.random((h, w, c)) * 24).clip(0, 255).astype(np.uint8)


def _pil_png(img: Image.Image, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **opts)
    return buf.getvalue()


# ------------------------------------------------------------ PNG


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
@pytest.mark.parametrize("opts", [{}, {"optimize": True}, {"compress_level": 1}],
                         ids=["default", "optimize", "level1"])
def test_decode_png_matches_pil(mode, opts):
    arr = _image(1, 37, 53, {"L": 1, "LA": 2, "RGBA": 4}.get(mode, 3))
    if mode == "P":
        img = Image.fromarray(arr).convert("P", palette=Image.Palette.ADAPTIVE, colors=60)
    else:
        img = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
    data = _pil_png(img, **opts)
    raw = zlib.decompress(b"".join(_idat(data)))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)
    if opts == {} and mode == "RGB":  # PIL's adaptive filters: several kinds here
        bpr = 1 + 53 * 3
        assert len({raw[i * bpr] for i in range(37)}) >= 2


def _idat(data: bytes):
    from fastdm_tpu_torch.utils.png import _chunks

    return [body for kind, body in _chunks(data) if kind == b"IDAT"]


@pytest.mark.parametrize("shape", [(1, 1), (17, 9), (64, 96)])
def test_encode_png_decodes_in_pil_and_back(shape):
    arr = _image(2, *shape)
    data = encode_png(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), arr)
    np.testing.assert_array_equal(decode_png(data), arr)


def test_decode_png_refusals():
    arr = _image(3, 8, 8)
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(_pil_png(Image.fromarray(arr[..., 0].astype(np.uint16) * 257)))
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_interlaced(encode_png(arr)))
    bad = bytearray(encode_png(arr))
    bad[-20] ^= 0xFF  # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a....")
    with pytest.raises(ValueError, match="uint8"):
        encode_png(arr.astype(np.float32))


def _interlaced(data: bytes) -> bytes:
    """The same PNG with IHDR's interlace byte set (and its CRC redone)."""
    import struct

    n = struct.unpack(">I", data[8:12])[0]
    body = bytearray(data[16:16 + n])
    body[12] = 1
    chunk = data[8:16] + bytes(body)
    crc = struct.pack(">I", zlib.crc32(bytes(chunk[4:])) & 0xFFFFFFFF)
    return data[:8] + chunk + crc + data[16 + n + 4:]


# ------------------------------------------------------------ LANCZOS


@pytest.mark.parametrize("src,dst", [((37, 53), (20, 31)), ((20, 31), (64, 90)),
                                     ((64, 64), (64, 23)), ((48, 30), (97, 30)),
                                     ((5, 7), (200, 3)), ((300, 200), (31, 77))])
def test_resize_lanczos_matches_pil(src, dst):
    arr = _image(4, *src)
    want = np.asarray(Image.fromarray(arr).resize((dst[1], dst[0]), Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(arr, *dst), want)


# ------------------------------------------------------------ blend modes


@pytest.fixture(scope="module")
def ref_api():
    return _load("api_server")


SOURCES = [(_image(5, 40, 60), _image(6, 64, 48)),
           (_image(7, 32, 32), _image(8, 32, 32), _image(9, 16, 48))]


@pytest.mark.parametrize("mode", ["first", "list", "average", "concatenate"])
@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
@pytest.mark.parametrize("which", [0, 1])
def test_blend_modes_match_the_jax_server(ref_api, mode, direction, which):
    srcs = list(SOURCES[which])
    got = api.process_multiple_images(srcs, mode, direction)
    want = ref_api.process_multiple_images([Image.fromarray(s) for s in srcs], mode, direction)
    if mode == "list":
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        return
    np.testing.assert_array_equal(got, np.asarray(want))
    cat = api.concatenate_images(srcs, direction)
    np.testing.assert_array_equal(
        cat, np.asarray(ref_api.concatenate_images([Image.fromarray(s) for s in srcs],
                                                   direction)))


def test_single_gray_and_rgba_sources_convert_as_pil(ref_api):
    for arr in (_image(10, 12, 9, 1)[..., 0], _image(11, 12, 9, 4)):
        got = api.process_multiple_images([arr], "average")
        want = ref_api.process_multiple_images([Image.fromarray(arr)], "average")
        np.testing.assert_array_equal(got, np.asarray(want))


def test_base64_round_trip_and_formats(monkeypatch):
    arr = _image(12, 9, 14)
    np.testing.assert_array_equal(api.base64_to_image(api.image_to_base64(arr)), arr)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG")
    jpeg = base64.b64encode(buf.getvalue()).decode()
    np.testing.assert_array_equal(api.base64_to_image(jpeg), np.asarray(
        Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    with pytest.raises(ValueError, match="base64"):
        api.base64_to_image("not base64 at all!")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="JPEG images need PIL"):
        api.base64_to_image(jpeg)
    np.testing.assert_array_equal(api.base64_to_image(api.image_to_base64(arr)), arr)


# ------------------------------------------------------------ routes


class _StubEncoder:
    """Prompt strings -> embeddings drawn from a seed of the string, at the
    family's tiny widths."""

    def __init__(self, family):
        self.family = family

    def _draw(self, prompt):
        return embeds(self.family, zlib.crc32(prompt.encode()))

    def encode(self, prompt, num_images_per_prompt=1):
        e = self._draw(prompt)
        t = lambda a: torch.from_numpy(a).bfloat16().repeat(  # noqa: E731
            num_images_per_prompt, *([1] * (a.ndim - 1)))
        if self.family == "flux":
            return t(e["prompt_embeds"]), t(e["pooled_prompt_embeds"])
        return t(e["prompt_embeds"])

    def encode_with_image(self, prompt, images, num_images_per_prompt=1):
        return self.encode(prompt, num_images_per_prompt)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("served"))
    out = {"flux": tiny_engine("flux", _flux_root(base)),
           "kontext": tiny_engine("flux", _flux_root(base), architecture="flux-kontext"),
           "qwen": tiny_engine("qwen", _write_root("qwen", base)),
           "wan": tiny_engine("wan", _write_root("wan", base))}
    for name, eng in out.items():
        eng.text_encoder = _StubEncoder(eng.architecture)
    return out


def _req(cls=None, **kw):
    return (cls or api.GenerateRequest)(**dict(dict(model="tiny", prompt="a red fox", steps=2,
                                                    seed=5, width=64, height=64), **kw))


def test_generate_route_png_equals_the_engine(served):
    eng = served["flux"]
    routes = api.Routes(eng, "tiny")
    assert routes.health() == {"status": "ok", "architecture": "flux"}
    assert routes.get_model_info().model_name == "tiny"
    for prompt, seed in (("a red fox", 5), ("a lighthouse at dusk", 6)):
        resp = routes.generate(_req(prompt=prompt, seed=seed, guidance_scale=3.0))
        assert resp.success and resp.type == "image" and resp.format == "png"
        assert resp.parameters == dict(prompt=prompt, steps=2, guidance_scale=3.0,
                                       gen_seed=seed, gen_width=64, gen_height=64,
                                       max_seq_len=512)
        want = eng.generate(prompt=prompt, num_inference_steps=2, guidance_scale=3.0,
                            seed=seed, width=64, height=64)[0]
        np.testing.assert_array_equal(api.base64_to_image(resp.image), want)
        assert set(routes.timings) == {"decode_s", "generate_s", "encode_s"}
    # a source image makes it an SDEdit request, as the JAX server's src_image
    src = _image(13, 64, 64)
    resp = routes.generate(_req(input_image=api.image_to_base64(src)))
    want = eng.generate(prompt="a red fox", num_inference_steps=2, seed=5, image=src)[0]
    np.testing.assert_array_equal(api.base64_to_image(resp.image), want)
    assert "src_image" not in resp.parameters


def test_qwen_route_passes_true_cfg_scale(served):
    eng = served["qwen"]
    routes = api.Routes(eng, "tiny")
    resp = routes.generate(_req(width=96, negative_prompt="blurry", true_cfg_scale=2.5))
    assert resp.parameters["true_cfg_scale"] == 2.5
    assert resp.parameters["negative_prompt"] == "blurry"
    want = eng.generate(prompt="a red fox", negative_prompt="blurry", true_cfg_scale=2.5,
                        num_inference_steps=2, seed=5, width=96, height=64)[0]
    np.testing.assert_array_equal(api.base64_to_image(resp.image), want)


def test_wan_lightning_route_serves_4_steps_at_guidance_1(served, monkeypatch):
    eng = served["wan"]
    seen = {}

    def encoder(frames, fps):
        seen.update(frames=np.asarray(frames), fps=fps)
        return "bXA0"

    monkeypatch.setattr(api, "video_to_base64_mp4", encoder)
    routes = api.Routes(eng, "tiny", wan_lightning=True)
    resp = routes.generate(_req(num_frames=5, guidance_scale=7.0, steps=30, fps=8))
    assert (resp.type, resp.format, resp.video, resp.fps) == ("video", "mp4", "bXA0", 8)
    want = eng.generate(prompt="a red fox", num_inference_steps=4, guidance_scale=1.0,
                        seed=5, width=64, height=64, num_frames=5)[0]
    assert seen["frames"].shape == want.shape == (5, 64, 64, 3) and seen["fps"] == 8
    np.testing.assert_array_equal(seen["frames"], want)
    assert resp.frames == 5


@pytest.mark.parametrize("mode", ["list", "first", "average", "concatenate"])
def test_edit_route_blend_modes(served, mode):
    eng = served["kontext"]
    routes = api.Routes(eng, "tiny")
    srcs = [_image(14, 64, 64), _image(15, 48, 80)]
    req = _req(api.EditRequest, input_images=[api.image_to_base64(s) for s in srcs],
               blend_mode=mode, concat_direction="horizontal")
    resp = routes.edit(req)
    image = api.process_multiple_images(srcs, mode, "horizontal")
    want = eng.generate(prompt="a red fox", num_inference_steps=2, seed=5, image=image)[0]
    np.testing.assert_array_equal(api.base64_to_image(resp.image), want)


class _Engine:
    """An engine stand-in for the refusals: generate records or raises."""

    def __init__(self, architecture="flux", architecture_full="flux", fail=None):
        self.architecture, self.architecture_full, self.fail = (
            architecture, architecture_full, fail)
        self.calls = []

    def generate(self, **kw):
        if self.fail is not None:
            raise self.fail
        self.calls.append(kw)
        return np.zeros((1, 8, 8, 3), np.uint8)


def _status(fn, *args):
    with pytest.raises(api.HTTPError) as e:
        fn(*args)
    return e.value.status_code, e.value.detail


def test_route_refusals(monkeypatch):
    routes = api.Routes(_Engine(), "tiny")
    assert _status(routes.generate, _req(prompt="  ")) == (400, "prompt must not be empty")
    assert _status(routes.generate, _req(model="other")) == (400, "unsupported model: other")
    code, detail = _status(routes.generate, _req(input_image="%%%"))
    assert code == 400 and detail.startswith("invalid source image")
    assert _status(routes.edit, _req(api.EditRequest)) == (
        400, "edit requires at least one input image")
    code, detail = _status(routes.edit, _req(api.EditRequest, input_images="%%%"))
    assert code == 400 and detail.startswith("invalid image data")
    i2v = api.Routes(_Engine("wan", "wan2.2-i2v"), "tiny")
    assert _status(i2v.generate, _req()) == (400, "i2v requires input_image")
    buf = io.BytesIO()
    Image.fromarray(_image(16, 8, 8)).save(buf, "JPEG")
    jpeg = base64.b64encode(buf.getvalue()).decode()
    monkeypatch.setitem(sys.modules, "PIL", None)
    code, detail = _status(routes.generate, _req(input_image=jpeg))
    assert code == 400 and "JPEG" in detail and "PIL" in detail
    assert not routes.engine.calls  # nothing reached the engine


def test_route_failures_answer_500_with_the_cause():
    routes = api.Routes(_Engine(fail=RuntimeError("out of memory on the card")), "tiny")
    assert _status(routes.generate, _req()) == (
        500, "generation failed: out of memory on the card")
    req = _req(api.EditRequest, input_images=api.image_to_base64(_image(17, 8, 8)))
    assert _status(routes.edit, req) == (500, "edit failed: out of memory on the card")


def test_parser_accepts_the_lightning_names():
    p = api.build_parser()
    for name in ("wan-lightning", "wan-i2v-lightning", "flux"):
        args = p.parse_args(["--model-path", "m", "--served-model-name", "s",
                             "--architecture", name])
        assert args.architecture == name and args.device == "cuda"


# ------------------------------------------------------------ rank 0's loop


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    from torch_parallel_workers import Pool

    pool = Pool(2, str(tmp_path_factory.mktemp("serve-store")))
    yield pool
    pool.close()


def test_server_loop_on_two_ranks_answers_as_one_process(pool2, served, tmp_path):
    """A flux-kontext engine on a (2, 1, 1) mesh of two gloo ranks behind
    request_loop.serve: rank 0's /generate and /edit images equal the
    one-process server's bit for bit; an empty prompt answers 400 between
    them and reaches no rank; the follower returns at the shutdown, having
    run the two broadcast calls."""
    from test_torch_pipeline import VAE_TINY as PIPE_VAE

    srcs = [_image(18, 64, 64), _image(19, 48, 80)]
    calls = [("generate", dict(model="tiny", prompt="a red fox", steps=2, seed=5, width=64,
                               height=64, guidance_scale=3.0)),
             ("generate", dict(model="tiny", prompt="  ")),
             ("edit", dict(model="tiny", prompt="a lighthouse at dusk", steps=2, seed=6,
                           input_images=[api.image_to_base64(s) for s in srcs],
                           blend_mode="average"))]
    encoder = _StubEncoder("flux")
    table = {kw["prompt"]: encoder._draw(kw["prompt"]) for _, kw in calls
             if kw["prompt"].strip()}
    root = _flux_root(str(tmp_path))
    answers, followed = pool2.run("task_serve", root, "flux-kontext", (2, 1, 1),
                                  dict(PIPE_VAE), table, calls)
    assert followed == 2
    routes = api.Routes(served["kontext"], "tiny")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a worker's: CPU bf16 sums depend on the thread count
    try:
        for (route, kw), (status, got) in zip(calls, answers):
            if not kw["prompt"].strip():
                assert (status, got) == (400, "prompt must not be empty")
                continue
            req = (api.EditRequest if route == "edit" else api.GenerateRequest)(**kw)
            want = api.base64_to_image(getattr(routes, route)(req).image)
            assert status == 200
            np.testing.assert_array_equal(got, want)
    finally:
        torch.set_num_threads(threads)


def test_lead_engine_broadcasts_and_failures_end_the_run(monkeypatch):
    """With the broadcast stubbed: LeadEngine.generate broadcasts (shared
    engine state, the call's keywords) before it runs, sets attributes on
    the engine, and hands an error to `fail` before it raises; follow()
    runs each broadcast call with its state until None, and an error on a
    follower leaves it."""
    from fastdm_tpu_torch.parallel import request_loop as rl

    sent = []
    monkeypatch.setattr(rl, "_broadcast", lambda m=None: sent.append(m))
    eng = _Engine()
    failed = []
    lead = rl.LeadEngine(eng, fail=failed.append)
    lead.scheduler_name = "euler"
    out = lead.generate(prompt="a", seed=1)
    assert out.shape == (1, 8, 8, 3) and eng.scheduler_name == "euler"
    assert sent == [({"scheduler_name": "euler"}, {"prompt": "a", "seed": 1})]
    assert lead.architecture == "flux" and not failed
    lead.shutdown()
    assert sent[-1] is None
    boom = RuntimeError("device lost")
    bad = rl.LeadEngine(_Engine(fail=boom), fail=failed.append)
    with pytest.raises(RuntimeError, match="device lost"):
        bad.generate(prompt="b")
    assert failed == [boom]

    script = iter([({"scheduler_name": "unipc"}, {"prompt": "c"}), ({}, {"prompt": "d"}), None])
    monkeypatch.setattr(rl, "_broadcast", lambda m=None: next(script))
    follower = _Engine()
    assert rl.follow(follower) == 2
    assert follower.calls == [{"prompt": "c"}, {"prompt": "d"}]
    assert follower.scheduler_name == "unipc"
    monkeypatch.setattr(rl, "_broadcast", lambda m=None: ({}, {"prompt": "e"}))
    with pytest.raises(RuntimeError, match="device lost"):
        rl.follow(_Engine(fail=boom))
    assert not rl.on_mesh()
    ran = []
    assert rl.serve(eng, ran.append) == {"rank": 0, "followed": 0} and ran == [eng]
