"""Single-model Gradio web UI on the PyTorch/CUDA port (port of
examples/serve/gradio_launch.py; the same tabs and controls).

gradio is imported in main() only. The UI-independent logic comes from
api_server_torch.py (the blend modes, image decoding without PIL) and
ui_common.py (history, generation info), which import nothing of JAX.
The multi-model router (multi_model_gradio.py) needs no port: it speaks
HTTP to any server with this schema, api_server_torch.py's included.

    python examples/serve/gradio_launch_torch.py --model-path CKPT --architecture flux

On a mesh, one process a device, rank 0 serving the UI and broadcasting
each request to the other ranks (fastdm_tpu_torch/parallel/request_loop.py):

    torchrun --nproc-per-node 2 examples/serve/gradio_launch_torch.py \\
        --model-path CKPT --architecture flux --mesh-shape 1,1,2
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fastdm_tpu_torch.common_args import add_engine_args, engine_kwargs  # noqa: E402
from fastdm_tpu_torch.parallel import request_loop  # noqa: E402

EXAMPLE_PROMPTS = [
    ["a photo of an astronaut riding a horse on mars"],
    ["a watercolor painting of a fox in a snowy forest"],
    ["macro photo of a dew drop on a spider web at sunrise"],
    ["isometric cutaway of a cozy underground library, warm light"],
]


def main():
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio not installed in this environment") from None

    parser = argparse.ArgumentParser("fastdm_tpu_torch gradio ui")
    add_engine_args(parser)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--history-dir", default=None)
    parser.add_argument("--history-limit", type=int, default=50)
    args = parser.parse_args()

    from fastdm_tpu_torch.engine import FastDMEngine

    request_loop.serve(FastDMEngine(**engine_kwargs(args)), lambda eng: _launch(gr, args, eng))


def _launch(gr, args, engine):
    """The UI on `engine` (rank 0's LeadEngine on a mesh), until it closes."""
    from api_server_torch import decode_image_bytes, process_multiple_images
    from ui_common import GenerationHistory, format_gen_info

    history = GenerationHistory(args.history_dir, args.history_limit)
    is_qwen = args.architecture.startswith("qwen")

    def _gather_inputs(files, blend_mode, direction):
        srcs = []
        for f in files or []:
            path = f.name if hasattr(f, "name") else (
                f[0] if isinstance(f, (tuple, list)) else f)
            with open(path, "rb") as fh:
                srcs.append(decode_image_bytes(fh.read()))
        if not srcs:
            return None
        return process_multiple_images(srcs, blend_mode, direction)

    def preview(files, blend_mode, direction):
        """Live preview of the processed (blended/concatenated) input —
        ref: preview_processed_image."""
        out = _gather_inputs(files, blend_mode, direction)
        if out is None:
            return None
        return out[0] if isinstance(out, list) else out

    def generate(prompt, negative_prompt, files, blend_mode, direction,
                 strength, height, width, steps, guidance, seed, sampler):
        if not prompt:
            raise gr.Error("enter a prompt")
        src = _gather_inputs(files, blend_mode, direction)
        t0 = time.perf_counter()
        kw = dict(
            negative_prompt=negative_prompt or None,
            height=int(height), width=int(width),
            num_inference_steps=int(steps), seed=int(seed),
        )
        if is_qwen:
            kw["true_cfg_scale"] = float(guidance)
        else:
            kw["guidance_scale"] = float(guidance)
        if src is not None:
            kw["image"] = src
            if not is_qwen:  # SDEdit strength (flux i2i); qwen-edit has none
                kw["strength"] = float(strength)
            kw.pop("height", None), kw.pop("width", None)
        # "default" must RESET any previously selected sampler (None = the
        # engine's per-family default), not keep the last non-default choice
        engine.scheduler_name = (
            sampler if sampler and sampler != "default" else None)
        images = engine.generate(prompt=prompt, **kw)
        dt = time.perf_counter() - t0
        params = dict(model=args.architecture, prompt=prompt,
                      negative_prompt=negative_prompt,
                      blend_mode=blend_mode if src is not None else None,
                      steps=int(steps), guidance=float(guidance),
                      strength=float(strength) if src is not None else None,
                      width=int(width), height=int(height), seed=int(seed),
                      sampler=sampler, seconds=dt)
        if args.architecture.startswith("wan"):
            # video: one history entry (preview frame), not one per frame —
            # 121 frames would immediately evict the whole session history
            history.add(image=images[0], **params)
        else:
            for img in images:
                history.add(image=img, **params)
        info = format_gen_info(**params)
        return [img for img in images], info, history.gallery()

    samplers = (["default", "unipc", "euler"]
                if args.architecture.startswith("wan") else ["default"])

    with gr.Blocks(title=f"fastdm_tpu_torch [{args.architecture}]") as demo:
        gr.Markdown(f"# fastdm_tpu_torch — {args.architecture}")
        with gr.Tab("Generate"):
            with gr.Row():
                with gr.Column(scale=3):
                    prompt = gr.Textbox(label="Prompt", lines=3)
                    negative = gr.Textbox(label="Negative prompt", lines=1)
                    with gr.Accordion("Image editing (multi-image input)",
                                      open=False):
                        files = gr.Gallery(label="Source image(s)",
                                           columns=4, rows=1, interactive=True)
                        with gr.Row():
                            blend = gr.Dropdown(
                                ["list", "first", "average", "concatenate"],
                                value="list", label="Blend mode")
                            direction = gr.Dropdown(
                                ["horizontal", "vertical"],
                                value="horizontal", label="Concat direction",
                                visible=False)
                        processed = gr.Image(label="Processed input preview",
                                             interactive=False)
                        strength = gr.Slider(
                            0.0, 1.0, 0.6, step=0.05,
                            label="Denoise strength (i2i)")
                    with gr.Row():
                        steps = gr.Slider(1, 100, 25, step=1, label="Steps")
                        guidance = gr.Slider(
                            0.0, 20.0, 4.0 if is_qwen else 3.5, step=0.1,
                            label="True CFG" if is_qwen else "Guidance")
                    with gr.Row():
                        sampler = gr.Dropdown(samplers, value="default",
                                              label="Sampler")
                        seed = gr.Number(42, label="Seed", precision=0)
                    with gr.Row():
                        width = gr.Slider(256, 2048, 1024, step=64,
                                          label="Width")
                        height = gr.Slider(256, 2048, 1024, step=64,
                                           label="Height")
                    btn = gr.Button("Generate", variant="primary", size="lg")
                    gr.Examples(EXAMPLE_PROMPTS, inputs=[prompt])
                with gr.Column(scale=2):
                    gallery = gr.Gallery(label="Results", columns=2)
                    gen_info = gr.Textbox(label="Generation info", lines=8,
                                          interactive=False)
        with gr.Tab("History"):
            hist_gallery = gr.Gallery(label="Session history", columns=4,
                                      value=history.gallery())
            refresh_hist = gr.Button("Refresh")
            refresh_hist.click(lambda: history.gallery(), None, hist_gallery)

        blend.change(
            lambda m: gr.Dropdown(visible=(m == "concatenate")),
            blend, direction)
        for comp in (files, blend, direction):
            comp.change(preview, [files, blend, direction], processed)
        btn.click(generate,
                  [prompt, negative, files, blend, direction, strength,
                   height, width, steps, guidance, seed, sampler],
                  [gallery, gen_info, hist_gallery])
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
