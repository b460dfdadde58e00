"""Interactive demo of the port (reference `app.py:295-340`).

    python -m amodal_depth_anything_tpu_torch.cli.app \\
        --base_ckpt work_dir/ckp/amodal_depth_anything_base.pth \\
        --amodal_ckpt work_dir/ckp/amodal_dav2_vitl \\
        [--sam_ckpt ... --p2g_ckpt ... --vae_ckpt ... --clip_ckpt ...
         [--rmbg_ckpt ...] | --heur_serving DIR] [--device cuda]

Port of the JAX package's `cli/app.py`. Two mask modes:
  * "amodal_mask": the user draws the amodal mask;
  * "prompt_points": the user marks points on the object and
    `heuristics.MaskHeuristics` derives the amodal mask (SAM, pix2gestalt,
    RMBG), which needs the heuristics stack.
Then `AmodalDepthPipeline.__call__` predicts base and amodal depth, and the
prediction is fitted to the base depth by least squares over the visible
region (`app.py:249-265`).

`AmodalDepthApp.predict_arrays` is that path and returns arrays only;
`predict_amodal_depth` adds the colour renders (`utils.image`: the
Spectral_r table and the native contour drawing, bit for bit what
matplotlib and cv2 give, so they run on the card's machine too).
`build_http_demo` serves the flow from the standard library, its PNGs
through `utils/host_image.py` (the native codec where it is built);
`build_demo` needs gradio. Everything runs on `--device` ("cuda" unless
told otherwise). `--random` draws seeded weights at full width instead of
reading checkpoints (smoke runs). `--p2g_int8` stores the pix2gestalt UNet
weight-only int8 (`MaskHeuristics.quantize_p2g_int8`), as the JAX app
does.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["AmodalDepthApp", "build_demo", "build_http_demo", "main",
           "MASK_TYPES"]

MASK_TYPES = ("amodal_mask", "prompt_points")


class AmodalDepthApp:
    def __init__(self, pipeline, heuristics=None):
        """pipeline: `AmodalDepthPipeline`; heuristics: optional
        `heuristics.MaskHeuristics`."""
        self.pipeline = pipeline
        self.heuristics = heuristics

    def predict_arrays(self, image_rgb: np.ndarray, mask: np.ndarray,
                       mask_type: str = "amodal_mask", **heuristics_kw):
        """image_rgb: [H,W,3] uint8 RGB; mask: [H,W], the amodal mask for
        "amodal_mask", the point hints for "prompt_points"
        (`heuristics_kw`, e.g. `seed` or `noise`, go to
        `amodal_mask_from_points`).

        Returns {"mask": the amodal mask [H,W] float32, "base" and
        "blended": depth [S,S] float32, "aligned": the blended depth fitted
        to the base over the visible region and clipped to [0, 1], "mask_s":
        the mask at [S,S]}."""
        import torch

        from ..ops.resize import resize_nearest
        from ..utils.alignment import align_depth_least_square_np

        if mask_type == "prompt_points":
            if self.heuristics is None:
                raise RuntimeError(
                    "prompt_points mode needs the SAM + pix2gestalt "
                    "heuristics stack; construct AmodalDepthApp with "
                    "heuristics=MaskHeuristics.from_checkpoints(...) or use "
                    "mask_type='amodal_mask'")
            mask = self.heuristics.amodal_mask_from_points(image_rgb, mask,
                                                           **heuristics_kw)
        elif mask_type != "amodal_mask":
            raise ValueError(f"unknown mask_type: {mask_type!r} (one of "
                             f"{MASK_TYPES})")
        mask = np.asarray(mask, np.float32)
        base, blended = self.pipeline(image_rgb, (mask > 0).astype(np.float32))
        size = self.pipeline.size
        mask_s = resize_nearest(torch.from_numpy(mask[None, :, :, None]),
                                size=(size, size))[0, :, :, 0].numpy()
        # the prediction rescaled to the base depth over the visible region
        # (reference app.py:214-216,249-265)
        aligned, _s, _t = align_depth_least_square_np(base, blended,
                                                      mask_s <= 0)
        return {"mask": mask, "base": base, "blended": blended,
                "aligned": np.clip(aligned, 0.0, 1.0), "mask_s": mask_s}

    def predict_amodal_depth(self, image_rgb: np.ndarray, mask: np.ndarray,
                             mask_type: str = "amodal_mask", **heuristics_kw):
        """`predict_arrays` plus the colour renders, as the JAX app returns
        them: (base render, amodal render with the mask's contour, aligned
        depth)."""
        out = self.predict_arrays(image_rgb, mask, mask_type, **heuristics_kw)
        return (*self.render(out, image_rgb.shape[:2]), out["aligned"])

    @staticmethod
    def render(arrays: dict, hw: tuple[int, int]):
        """(base render, amodal render) [H,W,3] uint8 of `predict_arrays`'
        "base", "aligned" and "mask_s" at the image's size `hw`: the
        Spectral colour map, the amodal one with the mask's contour, resized
        nearest."""
        from ..heuristics.host_ops import resize_nearest
        from ..utils.image import colorize_depth, highlight_target

        h, w = hw
        mask_u8 = (arrays["mask_s"] > 0).astype(np.uint8) * 255

        def one(depth, highlight):
            colored = (colorize_depth(depth) * 255).astype(np.uint8)
            if highlight:
                colored = highlight_target(colored, mask_u8)
            return resize_nearest(colored, (w, h))

        return one(arrays["base"], False), one(arrays["aligned"], True)


def build_demo(app: AmodalDepthApp):
    """The Gradio UI (needs gradio)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use build_http_demo or "
            "AmodalDepthApp.predict_arrays") from e

    def run(editor_value, mask_type):
        image = editor_value["background"][..., :3]
        mask = np.zeros(image.shape[:2], np.float32)
        for layer in editor_value.get("layers") or []:
            mask = np.maximum(mask, (layer[..., -1] > 0).astype(np.float32))
        base, amodal, _ = app.predict_amodal_depth(image, mask, mask_type)
        return base, amodal

    with gr.Blocks(title="Amodal Depth Anything") as demo:
        gr.Markdown("## Amodal Depth Anything")
        with gr.Row():
            editor = gr.ImageEditor(label="image + drawn amodal mask")
            with gr.Column():
                base_out = gr.Image(label="base depth")
                amodal_out = gr.Image(label="amodal depth")
        mask_type = gr.Radio(list(MASK_TYPES), value="amodal_mask",
                             label="mask mode")
        gr.Button("Predict").click(run, [editor, mask_type],
                                   [base_out, amodal_out])
    return demo


_DEMO_HTML = """<!doctype html>
<html><head><title>Amodal Depth Anything</title></head>
<body style="font-family:sans-serif;max-width:960px;margin:2em auto">
<h2>Amodal Depth Anything</h2>
<p>Pick an image, paint the amodal mask (or point hints) on it, hit
Predict.</p>
<input type="file" id="file" accept="image/png">
<label>mode <select id="mode"><option>amodal_mask</option>
<option>prompt_points</option></select></label>
<button onclick="predict()">Predict</button>
<div><canvas id="cv" style="border:1px solid #888;cursor:crosshair">
</canvas></div>
<div id="out"></div>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let img = null, drawing = false;
const mask = document.createElement('canvas'), mctx = mask.getContext('2d');
document.getElementById('file').onchange = e => {
  img = new Image();
  img.onload = () => { cv.width = mask.width = img.width;
    cv.height = mask.height = img.height; ctx.drawImage(img, 0, 0); };
  img.src = URL.createObjectURL(e.target.files[0]);
};
cv.onmousedown = () => drawing = true;
cv.onmouseup = () => drawing = false;
cv.onmousemove = e => {
  if (!drawing) return;
  const r = cv.getBoundingClientRect();
  const x = e.clientX - r.left, y = e.clientY - r.top;
  for (const c of [ctx, mctx]) { c.fillStyle = 'rgba(255,0,0,0.8)';
    c.beginPath(); c.arc(x, y, 8, 0, 7); c.fill(); }
};
async function predict() {
  const body = JSON.stringify({
    image: cv.toDataURL().split(',')[1],
    mask: mask.toDataURL().split(',')[1],
    mask_type: document.getElementById('mode').value});
  const resp = await fetch('/predict', {method: 'POST', body});
  const out = await resp.json();
  document.getElementById('out').innerHTML =
    '<h3>base</h3><img src="data:image/png;base64,' + out.base +
    '"><h3>amodal</h3><img src="data:image/png;base64,' + out.amodal + '">';
}
</script></body></html>
"""


def _as_rgb(px: np.ndarray) -> np.ndarray:
    """A decoded PNG as PIL's `convert("RGB")` gives it (gray repeated,
    alpha dropped); 8-bit only."""
    if px.dtype != np.uint8:
        raise ValueError(f"the demo takes 8-bit PNGs, got {px.dtype}")
    if px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=-1)
    if px.shape[-1] == 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def _mask_from_png(px: np.ndarray) -> np.ndarray:
    """The painted mask as the JAX demo reads it: PIL's `convert("L")`
    (ITU-R 601-2 luma in 16-bit fixed point) united with the alpha
    channel, when there is one."""
    if px.ndim == 2:
        return px.astype(np.float32)
    rgb = _as_rgb(px).astype(np.int64)
    luma = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.float32)
    if px.shape[-1] in (2, 4):
        luma = np.maximum(luma, px[..., -1].astype(np.float32))
    return luma


def build_http_demo(app: AmodalDepthApp, *, host="127.0.0.1", port=7860):
    """The demo behind a stdlib ThreadingHTTPServer. GET / serves a canvas
    mask editor; POST /predict takes JSON {image, mask: base64 PNG,
    mask_type} and returns JSON {base, amodal: base64 PNG} (the colour
    renders). Returns the server; the
    caller runs `serve_forever` and `shutdown`."""
    import base64
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..utils.host_image import decode_png, encode_png

    def _png(arr: np.ndarray) -> str:
        return base64.b64encode(encode_png(arr)).decode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _DEMO_HTML.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                image = _as_rgb(decode_png(base64.b64decode(req["image"])))
                mask = _mask_from_png(decode_png(base64.b64decode(
                    req["mask"])))
                base, amodal, _ = app.predict_amodal_depth(
                    image, mask, req.get("mask_type", "amodal_mask"))
                body = json.dumps({"base": _png(base),
                                   "amodal": _png(amodal)}).encode()
                self._send(200, body, "application/json")
            except Exception as e:  # noqa: BLE001 (reported to the client)
                self._send(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def _p2g_steps(args) -> int:
    """The DDIM step count the stack will run, known before any weight is
    read: a serving state's `serving_meta.json` says it; the released
    checkpoints and --random run `Pix2GestaltConfig`'s."""
    if args.heur_serving is not None:
        import json
        import os
        with open(os.path.join(args.heur_serving, "serving_meta.json")) as f:
            return int(json.load(f)["p2g_cfg"]["ddim_steps"])
    from ..models.pix2gestalt import Pix2GestaltConfig
    return Pix2GestaltConfig().ddim_steps


def _check_deep_cache(deep_cache, steps: int) -> None:
    if deep_cache is not None and steps % deep_cache[0]:
        raise SystemExit(f"--p2g_deep_cache interval {deep_cache[0]} must "
                         f"divide the pix2gestalt DDIM steps ({steps})")


def _build_heuristics(args):
    """The heuristics stack for prompt_points mode, or None. Flag checks
    come first, before any checkpoint is read: the DeepCache spec is parsed
    and its interval held against the step count before the stack loads;
    DeepCache is set before the first call."""
    has_ckpt = bool(args.sam_ckpt or args.p2g_ckpt or args.vae_ckpt
                    or args.clip_ckpt)
    if args.heur_serving is None and not has_ckpt and not args.random:
        for flag, value in (("--p2g_deep_cache", args.p2g_deep_cache),
                            ("--p2g_int8", args.p2g_int8 or None)):
            if value is not None:
                raise SystemExit(f"{flag} requires the heuristics stack "
                                 "(--sam_ckpt/--p2g_ckpt/--vae_ckpt/"
                                 "--clip_ckpt, --heur_serving or --random)")
        return None
    deep_cache = None
    if args.p2g_deep_cache is not None:
        from ..ops.ddim import parse_deep_cache
        try:
            deep_cache = parse_deep_cache(args.p2g_deep_cache)
        except ValueError as e:
            raise SystemExit(f"--p2g_deep_cache: {e}") from None
        _check_deep_cache(deep_cache, _p2g_steps(args))
    if has_ckpt:
        missing = [f for f in ("sam_ckpt", "p2g_ckpt", "vae_ckpt",
                               "clip_ckpt") if getattr(args, f) is None]
        if missing:
            raise SystemExit("prompt_points mode needs all four stack "
                             f"checkpoints; missing --{' --'.join(missing)}")
    from ..heuristics import MaskHeuristics

    if args.heur_serving is not None:
        mh = MaskHeuristics.load_serving(args.heur_serving,
                                         device=args.device)
    elif has_ckpt:
        mh = MaskHeuristics.from_checkpoints(
            args.sam_ckpt, args.p2g_ckpt, args.vae_ckpt, args.clip_ckpt,
            rmbg_ckpt=args.rmbg_ckpt, device=args.device)
    else:
        mh = MaskHeuristics.init_random(0, device=args.device)
    if args.p2g_deep_cache is not None:
        import dataclasses

        _check_deep_cache(deep_cache, mh.p2g_cfg.ddim_steps)
        mh.p2g_cfg = dataclasses.replace(mh.p2g_cfg,
                                         ddim_deep_cache=deep_cache)
    if args.p2g_int8:
        try:
            mh.quantize_p2g_int8()   # weight_only=True: the JAX app's mode
        except ValueError as e:      # a serving state already quantised
            raise SystemExit(f"--p2g_int8: {e}") from None
    return mh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Amodal depth demo (PyTorch/CUDA "
                                            "port; Gradio, or plain HTTP)")
    p.add_argument("--base_ckpt", type=str,
                   default="work_dir/ckp/amodal_depth_anything_base.pth")
    p.add_argument("--amodal_ckpt", type=str,
                   default="work_dir/ckp/amodal_dav2_vitl")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--http", action="store_true",
                   help="the plain-HTTP demo even if gradio is installed")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--random", action="store_true",
                   help="seeded random weights at full width (vitg + vitl, "
                        "and the heuristics stack) instead of checkpoints")
    # prompt_points mode (reference app.py:101-124): SAM point prompts ->
    # pix2gestalt completion -> matting
    p.add_argument("--sam_ckpt", default=None)
    p.add_argument("--p2g_ckpt", default=None)
    p.add_argument("--vae_ckpt", default=None,
                   help="SD VAE weights for the pix2gestalt stack")
    p.add_argument("--clip_ckpt", default=None)
    p.add_argument("--rmbg_ckpt", default=None)
    p.add_argument("--heur_serving", default=None,
                   help="a MaskHeuristics.save_serving directory (of either "
                        "package) instead of the four checkpoints")
    p.add_argument("--p2g_deep_cache", default=None,
                   help="DeepCache 'interval[,groups]' over the p2g DDIM "
                        "steps (opt-in, changes the result)")
    p.add_argument("--p2g_int8", action="store_true",
                   help="weight-only int8 pix2gestalt UNet (w8, "
                        "MaskHeuristics.quantize_p2g_int8; changes the "
                        "result)"),
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..pipeline.amodal_pipeline import AmodalDepthPipeline

    # heuristics first: its flag checks must fire before the multi-GB
    # pipeline checkpoints load
    heuristics = _build_heuristics(args)
    if args.random:
        pipe = AmodalDepthPipeline.init_random(
            0, encoder="vitl", base_encoder="vitg", size=518,
            device=args.device)
    else:
        pipe = AmodalDepthPipeline.from_checkpoints(
            args.base_ckpt, args.amodal_ckpt, device=args.device)
    app = AmodalDepthApp(pipe, heuristics=heuristics)
    if not args.http:
        try:
            build_demo(app).launch(server_port=args.port)
            return
        except RuntimeError:
            print("gradio not installed: serving the plain-HTTP demo")
    server = build_http_demo(app, port=args.port)
    print(f"demo on http://127.0.0.1:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
