"""HTTP serving entry point of the port.

    python -m amodal_depth_anything_tpu_torch.cli.serve \\
        --serving_state /ckpt/serving   # from <pipeline>.save_serving
        --port 8000 --max_batch 8

or build the pipeline from the reference checkpoints:

    python -m amodal_depth_anything_tpu_torch.cli.serve \\
        --base_ckpt work_dir/ckp/amodal_depth_anything_base.pth \\
        --amodal_ckpt work_dir/ckp/amodal_dav2_vitl --dtype bfloat16

    python -m amodal_depth_anything_tpu_torch.cli.serve --family depthfm \\
        --depthfm_ckpt depthfm-v1.ckpt --vae_ckpt sd_vae.safetensors \\
        --deep_cache 2,2

Port of the JAX package's `cli/serve.py`, with the same flags plus
`--device`. On the card (the default) `main()` captures the pipeline's
program as one CUDA graph at (`--max_batch`, size, size)
(`pipeline.aot`) and serves that handle; `--device cpu` serves the eager
pipeline, by request. A failed capture or replay raises: nothing falls back
to eager execution or to the CPU.

Stdlib only (ThreadingHTTPServer): concurrent POSTs are coalesced by
`pipeline.server.MicroBatcher` into the one captured batch shape. PNG
decoding, encoding and the host resizes are numpy versions of what the JAX
server asks PIL for (`utils.host_image`), so the server runs without PIL;
PIL is imported only to decode a payload that is not a PNG (e.g. JPEG).

API:
  GET  /healthz              -> {"status": "ok", "dispatches": N, "size": S}
  POST /v1/amodal_depth      body {"image": <b64 png/jpg>, "mask": <b64 png>}
       -> {"base_depth": <b64 u16 png>, "blended_depth": <b64 u16 png>,
           "size": S}   (depth quantised [0,1] -> uint16)
  POST /v1/depthfm_depth     (--family depthfm) body {"image", "mask",
       "observation": <b64 u16 png, depth in [0,1]>}
       -> {"depth": <b64 u16 png>, "size": S}
Inputs are host-resized to the pipeline's square `size` (image bilinear,
mask nearest: the reference's own preprocessing geometry), so every request
rides the same captured program.

Not ported (each exits with a message): `--int8`, `--artifact`,
`--export_artifact`.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.host_image import (decode_png, encode_png, resize_bilinear,
                                resize_nearest)

__all__ = ["build_parser", "build_server", "main"]

_NOT_PORTED = ("int8", "artifact", "export_artifact")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="amodal-depth HTTP server on the "
                                            "PyTorch/CUDA port")
    p.add_argument("--family", type=str, default="amodal",
                   choices=["amodal", "depthfm"],
                   help="amodal = discriminative AmodalDepthPipeline; "
                        "depthfm = generative DepthFMPipeline")
    p.add_argument("--serving_state", type=str, default=None,
                   help="Dir from <pipeline>.save_serving of either package "
                        "(restores the exact serving state).")
    p.add_argument("--artifact", type=str, default=None,
                   help="not ported: serialised programs (torch.export) "
                        "come later")
    p.add_argument("--export_artifact", type=str, default=None,
                   help="not ported: serialised programs (torch.export) "
                        "come later")
    p.add_argument("--random", action="store_true",
                   help="Seeded random tiny-preset weights: serve without "
                        "checkpoints (demo/smoke mode)")
    p.add_argument("--base_ckpt", type=str, default=None)
    p.add_argument("--amodal_ckpt", type=str, default=None)
    p.add_argument("--depthfm_ckpt", type=str, default=None,
                   help="(depthfm) torch depthfm-v1-style ckpt")
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="(depthfm) diffusers SD VAE weights")
    p.add_argument("--num_steps", type=int, default=4,
                   help="(depthfm) Euler ODE steps")
    p.add_argument("--deep_cache", default=None,
                   help="(depthfm) DeepCache 'interval[,groups]' over the "
                        "Euler steps: opt-in, parity-breaking. '0' forces "
                        "it off (overrides a --serving_state saved with "
                        "caching on).")
    p.add_argument("--int8", default=None, choices=["wo", "dynamic", "ln"],
                   help="not ported: int8 serving")
    p.add_argument("--size", type=int, default=None,
                   help="input square size (default: 518 amodal / 512 "
                        "depthfm; the depthfm size must be divisible by "
                        "the VAE factor 8)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda: capture the program as a CUDA graph and "
                        "replay it; cpu: run the pipeline eagerly")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    return p


def _b64_png_to_array(data: str) -> np.ndarray:
    raw = base64.b64decode(data)
    if raw.startswith(b"\x89PNG"):
        return decode_png(raw)
    from PIL import Image   # other formats (JPEG, ...) need PIL
    return np.asarray(Image.open(io.BytesIO(raw)))


def _depth_to_b64_png(depth: np.ndarray) -> str:
    u16 = (np.clip(depth, 0.0, 1.0) * 65535.0).astype(np.uint16)
    return base64.b64encode(encode_png(u16)).decode("ascii")


def _b64_depth_to_array(data: str, size: int) -> np.ndarray:
    """b64 depth png -> [size,size] float32 [0,1], host-bilinear-resized
    like the image. Scales by the SOURCE bit depth (u16 -> /65535,
    u8 -> /255) so an 8-bit observation isn't crushed to ~0."""
    src = _b64_png_to_array(data)
    arr = src.astype(np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    denom = 65535.0 if src.dtype.itemsize > 1 else 255.0
    arr = np.clip(arr / denom, 0.0, 1.0)
    return resize_bilinear(arr, (size, size))


def _prep(image: np.ndarray, mask: np.ndarray, size: int):
    """Host-resize to the one captured square shape (image bilinear, mask
    nearest: reference infer.py:17,84-86 geometry)."""
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    img = resize_bilinear(image[..., :3].astype(np.uint8),
                          (size, size)).astype(np.float32)
    if mask.ndim == 3:
        mask = mask[..., 0]
    msk = resize_nearest((mask > 0).astype(np.uint8),
                         (size, size)).astype(np.float32)
    return img, msk


def build_server(pipeline, host: str = "127.0.0.1", port: int = 0, *,
                 max_batch: int = 8, max_delay_ms: float = 5.0,
                 family: str = "amodal") -> ThreadingHTTPServer:
    """Wrap a ready pipeline (or a captured handle of `pipeline.aot`) in a
    ThreadingHTTPServer + MicroBatcher. The caller runs
    `server.serve_forever()` (or a thread around it), then
    `server.shutdown()` and `server.batcher.close()`; `server.batcher`
    exposes dispatch counts. `family`: "amodal" (2 outputs) or "depthfm"
    (image + mask + observation -> depth)."""
    from ..pipeline.server import MicroBatcher

    batcher = MicroBatcher(pipeline, max_batch=max_batch,
                           max_delay_ms=max_delay_ms)
    size = pipeline.size
    route = "/v1/amodal_depth" if family == "amodal" else "/v1/depthfm_depth"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "dispatches": batcher.dispatches,
                                 "size": size})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != route:
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                image = _b64_png_to_array(req["image"])
                mask = _b64_png_to_array(req["mask"])
                img, msk = _prep(image, mask, size)
                if family == "amodal":
                    base, blended = batcher.infer(img, msk)
                    payload = {"base_depth": _depth_to_b64_png(base),
                               "blended_depth": _depth_to_b64_png(blended)}
                else:
                    obs = _b64_depth_to_array(req["observation"], size)
                    depth = batcher.infer(img, msk, obs)
                    payload = {"depth": _depth_to_b64_png(depth)}
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            payload["size"] = size
            self._json(200, payload)

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server


def _pipeline(args, torch):
    """The pipeline the flags ask for, on `args.device`."""
    from ..pipeline.amodal_pipeline import AmodalDepthPipeline
    from ..pipeline.depthfm_pipeline import DepthFMPipeline

    dtype = getattr(torch, args.dtype)
    dev = args.device
    if args.random:
        if args.family == "depthfm":
            return DepthFMPipeline.init_random(0, size=args.size,
                                               num_steps=args.num_steps,
                                               device=dev)
        return AmodalDepthPipeline.init_random(0, size=args.size, device=dev)
    if args.family == "depthfm":
        if args.serving_state:
            return DepthFMPipeline.load_serving(args.serving_state,
                                                device=dev)
        if args.depthfm_ckpt and args.vae_ckpt:
            return DepthFMPipeline.from_checkpoints(
                args.depthfm_ckpt, args.vae_ckpt, size=args.size,
                num_steps=args.num_steps, dtype=dtype, device=dev)
        raise SystemExit("need --serving_state or --depthfm_ckpt/--vae_ckpt")
    if args.serving_state:
        return AmodalDepthPipeline.load_serving(args.serving_state,
                                                device=dev)
    if args.base_ckpt and args.amodal_ckpt:
        return AmodalDepthPipeline.from_checkpoints(
            args.base_ckpt, args.amodal_ckpt, size=args.size, dtype=dtype,
            device=dev)
    raise SystemExit("need --serving_state or --base_ckpt/--amodal_ckpt")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag) is not None:
            raise SystemExit(
                f"--{flag} is not ported to the torch server yet (int8 "
                f"serving and torch.export artifacts are queued in "
                f"ROADMAP.md)")
    if args.size is None:
        if args.random:
            args.size = 32 if args.family == "depthfm" else 56
        else:
            args.size = 512 if args.family == "depthfm" else 518
    if args.family == "depthfm" and args.size % 8 != 0:
        raise SystemExit(f"--size {args.size} must be divisible by the VAE "
                         f"factor 8 for --family depthfm")
    if args.deep_cache is not None and args.family != "depthfm":
        raise SystemExit("--deep_cache is a depthfm-family knob")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but no CUDA device is available; "
                         "--device cpu serves the eager pipeline on the CPU")
    pipe = _pipeline(args, torch)
    if args.deep_cache is not None:
        # before capture: the graph is recorded with the pipeline's knobs
        from ..ops.ddim import parse_deep_cache
        pipe.deep_cache = parse_deep_cache(args.deep_cache)

    served, how = pipe, "eager on the CPU"
    if args.device == "cuda":
        from ..pipeline.aot import (capture_amodal_program,
                                    capture_depthfm_program)
        capture = (capture_amodal_program if args.family == "amodal"
                   else capture_depthfm_program)
        served = capture(pipe, batch=args.max_batch,
                         hw=(pipe.size, pipe.size))
        how = f"CUDA graph at batch {args.max_batch}"
    server = build_server(served, args.host, args.port,
                          max_batch=args.max_batch,
                          max_delay_ms=args.max_delay_ms, family=args.family)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(size={pipe.size}, max_batch={args.max_batch}, {how})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.batcher.close()


if __name__ == "__main__":
    main()
