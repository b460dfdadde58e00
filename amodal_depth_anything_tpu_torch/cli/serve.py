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
decoding, encoding and the host resizes compute what the JAX server asks
PIL for (`utils.host_image`: the C++ host library `native` where it is
built, which releases the GIL, so request threads decode and resize in
parallel; numpy otherwise), so the server runs without PIL; a JPEG payload
decodes through the native codec's libjpeg route where it was built, and
PIL is imported only for what neither takes.

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

`--int8 {wo,dynamic,ln}` compresses the pipeline at startup, before the
capture, as the JAX CLI does: `wo` (weight-only int8 UNet + VAE) and
`dynamic` (W8A8 with run-time scales) for `--family depthfm`, `ln`
(calibration-free LayerNorm-bound W8A8 on both trunks) for the amodal
family.

Serialised programs (`pipeline.aot`, `torch.export`), as the JAX CLI:
`--export_artifact DIR` writes the program at (`--max_batch`, size, size)
-- after `--int8` / `--deep_cache`, so a compressed point exports as it
serves -- and exits; `--artifact DIR` serves such a directory on a replica,
its weights bound from `--serving_state` (or `--random`'s seeded ones), each
bucket's loaded program captured as a CUDA graph on the card.
`--int8` / `--deep_cache` with `--artifact` are refused: they belong to the
export.

    python -m amodal_depth_anything_tpu_torch.cli.serve --serving_state S \
        --max_batch 4 --export_artifact /art
    python -m amodal_depth_anything_tpu_torch.cli.serve --serving_state S \
        --max_batch 4 --artifact /art
"""

from __future__ import annotations

import argparse
import base64
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..native import imagecodec
from ..utils.host_image import (decode_png, encode_png, resize_bilinear,
                                resize_nearest)
from ..utils.image import decode_with_pil

__all__ = ["build_parser", "build_server", "main"]

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
                   help="Serve a --export_artifact directory (torch.export "
                        "programs, one per batch bucket), its weights bound "
                        "from --serving_state (or --random)")
    p.add_argument("--export_artifact", type=str, default=None,
                   help="Write the serving program at (--max_batch, size, "
                        "size) to this directory and exit")
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
                   help="opt-in int8 at startup (applied after load, before "
                        "the capture; parity-breaking): depthfm 'wo' = "
                        "weight-only int8 UNet+VAE, 'dynamic' = W8A8 with "
                        "run-time scales; amodal 'ln' = calibration-free "
                        "LN-bound W8A8 on both trunks")
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
    if imagecodec.available():
        px = imagecodec.decode(raw)     # baseline JPEG
        if px is not None:
            return px
    return decode_with_pil(raw)     # other formats need PIL


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


def _artifact_handle(args, torch):
    """The `--artifact` replica: the loaded programs, bound to the weights
    of `--serving_state` (or `--random`'s seeded pipeline) on
    `--device`."""
    from ..pipeline.aot import ExportedAmodalServing, ExportedDepthFMServing

    amodal = args.family == "amodal"
    served = (ExportedAmodalServing if amodal
              else ExportedDepthFMServing).load(args.artifact)
    if served.hw != (served.size, served.size):
        raise SystemExit(f"artifact hw {served.hw} != (size, size): serve-CLI "
                         f"artifacts must be exported at the serve input "
                         f"shape (use --export_artifact)")
    if args.max_batch not in served.batches:
        raise SystemExit(f"--max_batch {args.max_batch} not among the "
                         f"artifact's compiled buckets {served.batches}")
    args.size = served.size
    pipe = _pipeline(args, torch)
    if amodal:
        served.bind(pipe.raw_model.state_dict(), pipe.amodal_model.state_dict())
    else:
        served.bind(pipe.model.state_dict())
    return served


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.artifact is not None:
        if args.deep_cache is not None or args.int8:
            raise SystemExit("--deep_cache/--int8 cannot be applied to a "
                             "pre-compiled --artifact program: pass them to "
                             "the --export_artifact build instead")
        if not (args.serving_state or args.random):
            raise SystemExit("--artifact needs --serving_state (or --random "
                             "for smoke mode)")
        if args.export_artifact is not None:
            raise SystemExit("--artifact serves a program; --export_artifact "
                             "writes one: pass one of them")
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
    if args.int8 in ("wo", "dynamic") and args.family != "depthfm":
        raise SystemExit(f"--int8 {args.int8} is a depthfm-family mode; "
                         "the amodal family's data-free mode is 'ln'")
    if args.int8 == "ln" and args.family != "amodal":
        raise SystemExit("--int8 ln (LN-bound scales) is an amodal-family "
                         "mode; depthfm modes are 'wo'/'dynamic'")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but no CUDA device is available; "
                         "--device cpu serves the eager pipeline on the CPU")
    if args.artifact is not None:
        served = _artifact_handle(args, torch)
        _serve(args, served, f"artifact {args.artifact}, "
               f"{'CUDA graph' if args.device == 'cuda' else 'eager'} at "
               f"batch {args.max_batch}")
        return
    pipe = _pipeline(args, torch)
    if args.deep_cache is not None:
        # before capture: the graph is recorded with the pipeline's knobs
        from ..ops.ddim import parse_deep_cache
        pipe.deep_cache = parse_deep_cache(args.deep_cache)
    if args.int8:
        from ..ops.quant import is_quantized
        models = [getattr(pipe, n) for n in ("model", "raw_model",
                                             "amodal_model")
                  if hasattr(pipe, n)]
        if any(is_quantized(m) for model in models
               for m in model.modules()):
            raise SystemExit(f"--int8 {args.int8}: the serving state is "
                             f"already quantised; serve it without --int8")
    if args.int8 in ("wo", "dynamic"):
        pipe.quantize_int8(weight_only=(args.int8 == "wo"))
    elif args.int8 == "ln":
        pipe.quantize_int8(base=True, amodal=True)

    if args.export_artifact is not None:
        from ..pipeline.aot import save_amodal_artifact, save_depthfm_artifact
        save = (save_amodal_artifact if args.family == "amodal"
                else save_depthfm_artifact)
        meta = save(pipe, args.export_artifact, batches=(args.max_batch,),
                    hw=(pipe.size, pipe.size))
        print(f"artifact written to {args.export_artifact} (device "
              f"{meta['device']}, batches {meta['batches']}, "
              f"{sum(meta['export_seconds'].values()):.1f} s)", flush=True)
        return
    served, how = pipe, "eager on the CPU"
    if args.device == "cuda":
        from ..pipeline.aot import (capture_amodal_program,
                                    capture_depthfm_program)
        capture = (capture_amodal_program if args.family == "amodal"
                   else capture_depthfm_program)
        served = capture(pipe, batch=args.max_batch,
                         hw=(pipe.size, pipe.size))
        how = f"CUDA graph at batch {args.max_batch}"
    _serve(args, served, how)


def _serve(args, served, how: str) -> None:
    server = build_server(served, args.host, args.port,
                          max_batch=args.max_batch,
                          max_delay_ms=args.max_delay_ms, family=args.family)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(size={served.size}, max_batch={args.max_batch}, {how})",
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
