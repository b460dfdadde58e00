"""Offline serving autotuner: sweep the compression ladder, pick the fastest
point under a quality budget.

Port of the JAX package's `scripts/autotune_serving.py`, with the same
candidates (`candidate_configs`) and report. The serving knobs (W8A8 int8,
ToMe token merging, DeepCache for DepthFM) trade accuracy for speed, and
which stack wins depends on the hardware, the batch and the model:

    python -m amodal_depth_anything_tpu_torch.scripts.autotune_serving \\
        --family amodal --base_ckpt ... --amodal_ckpt ... \\
        --batch 4 --quality_budget 0.02 --out report.json

Each candidate pipeline is captured at the batch and the corpus's input
shape by `pipeline.aot` and timed replayed, as `cli.serve` serves it (on
the CPU the handle runs eagerly): images/s and the p50 of a batch, and the
max-abs blended-depth delta against the exact pipeline (the "bf16" row,
in `--dtype`). The report lists every row and the fastest one whose delta
fits the budget.

Weights: checkpoints, the trained in-repo proxy (`--proxy`, the default
when `checkpoints/proxy` exists and nothing else is given), or `--random`
(seeded; `--random_preset tiny`, the JAX script's smoke presets, or `full`:
vitg + vitl, or the SD-1.5 DepthFMAmodal). A delta on random weights checks
the plumbing only. `--image` / `--mask` read a corpus image through
`utils.image.read_image` (the native codec), repeated to the batch.
Runs on the card unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import time

import numpy as np

__all__ = ["build_parser", "candidate_configs", "run_autotune", "main"]

_PROXY = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "checkpoints",
    "proxy"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="serving-ladder autotuner")
    p.add_argument("--family", choices=["amodal", "depthfm"],
                   default="amodal")
    p.add_argument("--random", action="store_true",
                   help="seeded random weights (smoke mode)")
    p.add_argument("--random_preset", choices=["tiny", "full"],
                   default="tiny",
                   help="--random's widths: the tiny presets, or full width "
                        "(vitg + vitl; the SD-1.5 DepthFMAmodal)")
    p.add_argument("--proxy", nargs="?", const="checkpoints/proxy",
                   default=None,
                   help="trained proxy dir; the default when no "
                        "checkpoints are given and checkpoints/proxy exists")
    p.add_argument("--base_ckpt", type=str, default=None)
    p.add_argument("--amodal_ckpt", type=str, default=None)
    p.add_argument("--depthfm_ckpt", type=str, default=None)
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--quality_budget", type=float, default=0.02,
                   help="max allowed max-abs depth delta against the exact "
                        "pipeline (depth is in [0,1])")
    p.add_argument("--configs", type=str, default=None,
                   help="comma list to restrict the sweep (names from "
                        "candidate_configs)")
    p.add_argument("--include_calibrated", action="store_true",
                   help="also sweep calibrated int8")
    p.add_argument("--image", type=str, default=None,
                   help="optional RGB image file for the measurement corpus")
    p.add_argument("--mask", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--out", type=str, default=None)
    return p


def _tome_cfg(vit_cfg, size: int, frac: float, late: bool):
    """(after_layer, r) for a trunk: merge r = frac*N tokens after a late
    (after most taps) or early layer, clamped to r < N//2."""
    n = (size // vit_cfg.patch_size) ** 2 + 1
    r = min(int(frac * n), n // 2 - 1)
    depth = vit_cfg.depth
    layer = min(9, depth - 2) if late else max(1, min(4, depth // 2))
    if r < 1:
        return None
    return (layer, r)


def candidate_configs(family: str, include_calibrated: bool = False):
    """Ordered candidate names for the sweep (exact first)."""
    if family == "amodal":
        names = ["bf16", "int8_dynamic", "tome_base", "tome_both",
                 "int8_dynamic+tome_both"]
        if include_calibrated:
            names.insert(2, "int8_calib")
        return names
    return ["bf16", "int8_dynamic", "tome_0.75", "deepcache_2",
            "deepcache_2+tome_0.75", "int8_dynamic+tome_0.75",
            "int8_dynamic+deepcache_2"]


def _tiny(args) -> bool:
    return args.random and args.random_preset == "tiny"


def _default_size(args) -> int:
    if args.family == "amodal":
        return 56 if _tiny(args) else 518
    return 32 if _tiny(args) else 512


def _load_amodal(args):
    """The exact models, built once; each candidate deep-copies them
    (quantisation works in place)."""
    from ..models.amodal_dav2 import DAV2Config, build_model

    if args.proxy:
        from ..convert.weights import load_params_npz, params_from_jax
        with open(os.path.join(args.proxy, "meta.json")) as f:
            enc = json.load(f)["encoder"]
        models = []
        for name, cfg in (
                ("raw_base", DAV2Config(encoder=enc, guide_type="none",
                                        raw=True)),
                ("amodal", DAV2Config(encoder=enc,
                                      guide_type="mask+observation"))):
            model = build_model(cfg, device=args.device)
            model.load_state_dict(params_from_jax(load_params_npz(
                os.path.join(args.proxy, f"{name}.npz")), cfg), strict=True)
            models.append(model)
        return tuple(models)
    from ..pipeline.amodal_pipeline import AmodalDepthPipeline
    if args.random:
        enc, base = ("vitt", "vitt") if _tiny(args) else ("vitl", "vitg")
        pipe = AmodalDepthPipeline.init_random(
            args.seed, encoder=enc, base_encoder=base, size=args.size,
            device=args.device)
    else:
        pipe = AmodalDepthPipeline.from_checkpoints(
            args.base_ckpt, args.amodal_ckpt, size=args.size,
            device=args.device)
    return pipe.raw_model, pipe.amodal_model


def _load_depthfm(args):
    from ..pipeline.depthfm_pipeline import DepthFMPipeline

    if args.proxy and os.path.exists(os.path.join(args.proxy,
                                                  "depthfm.npz")):
        from ..convert.weights import load_depthfm_proxy
        return load_depthfm_proxy(os.path.join(args.proxy, "depthfm.npz"),
                                  device=args.device)
    if args.random:
        return DepthFMPipeline.init_random(
            args.seed, tiny=_tiny(args), size=args.size,
            device=args.device).model
    return DepthFMPipeline.from_checkpoints(
        args.depthfm_ckpt, args.vae_ckpt, size=args.size,
        device=args.device).model


def _build_amodal(args, name, loaded):
    import torch

    from ..pipeline.amodal_pipeline import AmodalDepthPipeline

    raw, amodal = (copy.deepcopy(m) for m in loaded)
    size = args.size

    def tm(frac, late):
        # merge geometry from the loaded trunk (tiny / proxy / checkpoint)
        return _tome_cfg(raw.cfg.vit, size, frac, late)

    kw = {}
    if "tome_base" in name:
        kw["base_token_merge"] = tm(0.45, late=True)
    if "tome_both" in name:
        kw["base_token_merge"] = tm(0.45, late=False)
        kw["amodal_token_merge"] = tm(0.45, late=False)
    pipe = AmodalDepthPipeline(raw, amodal, size=size, device=args.device,
                               dtype=getattr(torch, args.dtype), **kw)
    if "int8_dynamic" in name:
        pipe.quantize_int8(base=True, amodal=True, head=True, dynamic=True)
    elif "int8_calib" in name:
        img, msk = _corpus(args, size)
        pipe.quantize_int8(base=True, amodal=True, head=True,
                           calibration=(img[: min(4, len(img))],
                                        msk[: min(4, len(msk))]))
    return pipe


def _build_depthfm(args, name, loaded):
    import torch

    from ..pipeline.depthfm_pipeline import DepthFMPipeline

    # the tiny presets' transformer levels hold ~16 tokens: (0.4, 8) keeps
    # the merge legal there
    tome = ((0.75, 4096) if not _tiny(args) else (0.4, 8)) \
        if "tome" in name else None
    deep_cache = (2, 2) if "deepcache" in name else None
    pipe = DepthFMPipeline(copy.deepcopy(loaded), size=args.size,
                           num_steps=2 if _tiny(args) else 4,
                           dtype=getattr(torch, args.dtype),
                           device=args.device, tome=tome,
                           deep_cache=deep_cache)
    if "int8_dynamic" in name:
        pipe.quantize_int8()
    return pipe


def _luma(px: np.ndarray) -> np.ndarray:
    """PIL's `convert("L")` of a decoded image (ITU-R 601-2 luma in 16-bit
    fixed point; alpha dropped)."""
    if px.ndim == 2:
        return px.astype(np.float32)
    if px.shape[-1] == 2:
        return px[..., 0].astype(np.float32)
    rgb = px[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.float32)


def _corpus(args, size):
    """[B,H,W,3] float 0-255 + [B,H,W] mask: user files repeated to the
    batch, or a seeded synthetic corpus."""
    b = args.batch
    if args.image:
        from ..cli.app import _as_rgb
        from ..utils.image import read_image
        img = _as_rgb(read_image(args.image)).astype(np.float32)
        msk = (_luma(read_image(args.mask)) if args.mask
               else np.ones(img.shape[:2], np.float32) * 255)
        imgs = np.repeat(img[None], b, axis=0)
        msks = np.repeat((msk > 0).astype(np.float32)[None], b, axis=0)
        return imgs, msks
    rng = np.random.default_rng(args.seed)
    imgs = (rng.random((b, size, size, 3)) * 255).astype(np.float32)
    msks = (rng.random((b, size, size)) > 0.5).astype(np.float32)
    return imgs, msks


def _measure(call, reps):
    call()  # warm
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def run_autotune(args) -> dict:
    import torch

    from ..pipeline.aot import capture_amodal_program, capture_depthfm_program

    # the trained proxy is the default quality evidence when no
    # checkpoints and no --random are given
    if (not args.random and args.proxy is None
            and not (args.base_ckpt or args.depthfm_ckpt)):
        marker = ("meta.json" if args.family == "amodal"
                  else "depthfm_meta.json")
        if os.path.exists(os.path.join(_PROXY, marker)):
            args.proxy = _PROXY

    names = candidate_configs(args.family, args.include_calibrated)
    if args.configs:
        keep = [s.strip() for s in args.configs.split(",")]
        unknown = set(keep) - set(names)
        if unknown:
            raise SystemExit(f"unknown configs {sorted(unknown)}; "
                             f"choose from {names}")
        names = [n for n in names if n in keep]
    if names[0] != "bf16":
        names = ["bf16"] + names  # the exact reference point is mandatory
    if args.quality_budget < 0:
        raise SystemExit("--quality_budget must be >= 0 (0 = exact only)")

    if args.size is None:
        args.size = _default_size(args)
    if args.family == "depthfm" and args.size % 8 != 0:
        raise SystemExit(f"--size {args.size} must be divisible by the VAE "
                         f"factor 8 for --family depthfm")
    size = args.size
    build = _build_amodal if args.family == "amodal" else _build_depthfm
    loaded = (_load_amodal if args.family == "amodal" else _load_depthfm)(
        args)
    img, msk = _corpus(args, size)
    hw = img.shape[1:3]
    if args.family == "depthfm":
        rng = np.random.default_rng(args.seed + 1)
        obs = rng.random((args.batch, *hw)).astype(np.float32)

    rows, exact_out = [], None
    for name in names:
        pipe = build(args, name, loaded)
        if args.family == "amodal":
            handle = capture_amodal_program(pipe, batch=args.batch, hw=hw)
            call = lambda: handle(img, msk)   # noqa: E731
        else:
            handle = capture_depthfm_program(pipe, batch=args.batch, hw=hw)
            call = lambda: handle(img, msk, obs)   # noqa: E731
        dt, out = _measure(call, args.reps)
        if name == "bf16":
            exact_out = out
            delta = {"max_abs": 0.0, "mean_abs": 0.0}
        elif args.family == "amodal":
            from ..pipeline.quality import blended_depth_delta
            d = blended_depth_delta(*exact_out, *out)
            delta = {"max_abs": d["blended_max_abs"],
                     "mean_abs": d["blended_mean_abs"],
                     "base_max_abs": d["base_max_abs"]}
        else:
            diff = np.abs(np.float32(exact_out) - np.float32(out))
            delta = {"max_abs": float(diff.max()),
                     "mean_abs": float(diff.mean())}
        rows.append({
            "config": name,
            "img_per_sec": round(args.batch / dt, 3),
            "p50_batch_ms": round(dt * 1e3, 1),
            "quality_delta": {k: round(v, 6) for k, v in delta.items()},
            "passes_budget": delta["max_abs"] <= args.quality_budget,
        })
        del handle, call, pipe
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    passing = [r for r in rows if r["passes_budget"]]
    best = max(passing, key=lambda r: r["img_per_sec"]) if passing else None
    return {
        "family": args.family,
        "batch": args.batch,
        "size": size,
        "dtype": args.dtype,
        "quality_budget": args.quality_budget,
        "random_weights": bool(args.random),
        # which weights judged these rows
        "weights": ("random" if args.random else
                    f"proxy:{args.proxy}" if args.proxy else "checkpoints"),
        "rows": rows,
        "best": best["config"] if best else None,
        "best_img_per_sec": best["img_per_sec"] if best else None,
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # explicit checkpoints > explicit --proxy/--random > the trained proxy
    have_proxy_default = os.path.exists(os.path.join(
        _PROXY, "meta.json" if args.family == "amodal"
        else "depthfm_meta.json"))
    if args.family == "amodal" and not args.random and not args.proxy \
            and not (args.base_ckpt and args.amodal_ckpt) \
            and not have_proxy_default:
        raise SystemExit("need --random, --proxy or "
                         "--base_ckpt/--amodal_ckpt")
    if args.family == "depthfm" and not args.random and not args.proxy \
            and not (args.depthfm_ckpt and args.vae_ckpt) \
            and not have_proxy_default:
        raise SystemExit("need --random, --proxy or "
                         "--depthfm_ckpt/--vae_ckpt")
    report = run_autotune(args)
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
