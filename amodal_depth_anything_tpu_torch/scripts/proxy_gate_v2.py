"""Proxy-v2 quality-gate ladder of the serving compression, on the card.

Port of the JAX package's `scripts/proxy_gate_v2.py`: loads the trained
proxy pair (`checkpoints/proxy/{raw_base,amodal}.npz`, a vitp raw base and a
guided AmodalDAv2 trained on the layered-scenes task), runs every operating
point of the ladder (int8 LN-bound / calibrated / SmoothQuant / mixed /
dynamic, ToMe on one or both trunks, and their stacks) through
`pipeline.AmodalDepthPipeline` against the exact pipeline on a held-out
scenes corpus (`data.synthetic.make_synthetic_sam_tree(style="scenes")`),
and prints a markdown gate table (`pipeline.quality.check_gate`: blended
max abs <= 0.05, mean abs <= 0.01).

The ladder points are the JAX script's, scale-mapped from the flagship
knobs (vitg serves ~5330 tokens with taps at 9/19/29/39; the vitp proxy
serves (size/14)^2 tokens with taps at 2/5/8/11).

    python -m amodal_depth_anything_tpu_torch.scripts.proxy_gate_v2 \\
        --ckpt checkpoints/proxy --size 224 --eval-n 8

Runs on the card unless `--device cpu` asks for the CPU. Needs neither PIL
nor cv2: the corpus PNGs are read by `utils.host_image`.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

__all__ = ["load_params_npz", "load_corpus", "build_ladder", "main"]


def load_params_npz(path: str) -> dict:
    """The JAX package's flat "/"-keyed proxy .npz as a nested dict of
    float32 numpy arrays (its `scripts/train_proxy.py::load_params_npz`)."""
    from ..convert.weights import load_params_npz as load
    return load(path)


def load_corpus(root: str, list_path: str, size: int):
    """The whole scenes tree as arrays (its `train_proxy._load_corpus`):
    (rgbs [N,S,S,3] in [0,1], depths, amodal depths, whole masks, visible
    masks), each image nearest-resized to `size` if it is not."""
    from ..utils.host_image import decode_png, resize_nearest

    def img(d, name):
        with open(os.path.join(root, d, name), "rb") as f:
            a = decode_png(f.read())
        if a.shape[:2] != (size, size):
            a = resize_nearest(a, (size, size))
        return a

    rgbs, depths, amodal_depths, wholes, visibles = [], [], [], [], []
    with open(list_path) as f:
        for line in f:
            stem = os.path.basename(line.split()[0])
            rgbs.append(img("occlusion", stem).astype(np.float32) / 255.0)
            depths.append(img("depth_da_update_occ", stem).astype(np.float32)
                          / 65535.0)
            amodal_depths.append(img("depth_da_update_combine", stem)
                                 .astype(np.float32) / 65535.0)
            wholes.append(img("whole_mask", stem) > 127)
            visibles.append(img("visible_object_mask", stem) > 127)
    return (np.stack(rgbs), np.stack(depths), np.stack(amodal_depths),
            np.stack(wholes), np.stack(visibles))


def _build_corpus(size: int, n: int, seed: int, root: str | None):
    """Held-out scenes with visible / whole masks (difficulty buckets)."""
    from ..data.synthetic import make_synthetic_sam_tree

    root = root or os.path.join(tempfile.gettempdir(),
                                f"proxy_gate_scenes_{n}_{size}_{seed}")
    list_path = os.path.join(root, "train.txt")
    if not os.path.exists(list_path):
        list_path = make_synthetic_sam_tree(root, n=n, hw=size, seed=seed,
                                            style="scenes")
    rgbs, _, _, wholes, visibles = load_corpus(root, list_path, size)
    return [{"image": (rgbs[i] * 255).astype(np.uint8),
             "mask": visibles[i].astype(np.float32),
             "visible": visibles[i], "whole": wholes[i]}
            for i in range(rgbs.shape[0])]


def build_ladder(size: int, first_tap: int, depth: int):
    """(name, tome_base, tome_amodal, int8 kwargs or None) per point: the
    JAX script's ladder."""
    n_tok = (size // 14) ** 2 + 1
    r_half = n_tok // 2 - 1
    r_quarter = n_tok // 4
    early = first_tap + 1                # vitg 9 (tap 9) -> vitp 3
    late = depth - 3                     # vitg 29 -> vitp 9
    return [
        ("exact (control)", None, None, None),
        ("int8 LN-bound base", None, None, dict(base=True, amodal=False)),
        ("int8 LN-bound both trunks", None, None,
         dict(base=True, amodal=True)),
        ("int8 calib both", None, None,
         dict(base=True, amodal=True, calib=True)),
        ("int8 calib both + smooth 0.5", None, None,
         dict(base=True, amodal=True, calib=True, smooth_alpha=0.5)),
        ("int8 calib both + head", None, None,
         dict(base=True, amodal=True, head=True, calib=True)),
        ("int8 calib both + head + smooth 0.5", None, None,
         dict(base=True, amodal=True, head=True, calib=True,
              smooth_alpha=0.5)),
        ("int8 mixed-scales + smooth 0.5", None, None,
         dict(base=True, amodal=True, calib=True, smooth_alpha=0.5,
              mixed=True)),
        ("int8 calib margin 0.7 (outlier clip)", None, None,
         dict(base=True, amodal=True, calib=True, margin=0.7)),
        ("int8 dynamic", None, None,
         dict(base=True, amodal=True, dynamic=True)),
        (f"tome base {early},{r_half} ('9,2560' analog)",
         (early, r_half), None, None),
        (f"tome base {late},{r_quarter} ('29,1280' analog)",
         (late, r_quarter), None, None),
        (f"tome both {early},{r_half} (max-merge analog)",
         (early, r_half), (early, r_half), None),
        (f"int8 calib + tome base {early},{r_half} (stack analog)",
         (early, r_half), None,
         dict(base=True, amodal=True, head=True, calib=True)),
        (f"int8+smooth + tome both {early},{r_half} (max-stack analog)",
         (early, r_half), (early, r_half),
         dict(base=True, amodal=True, head=True, calib=True,
              smooth_alpha=0.5)),
    ]


def _runner(pipe):
    """A `corpus_quality_report` callable over `pipe`'s device program."""
    import torch

    def run(image, mask):
        with torch.inference_mode():
            base, blended = pipe._graph(pipe._device(image),
                                        pipe._device(mask))
        return base.cpu().numpy(), blended.cpu().numpy()

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default="checkpoints/proxy")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--eval-n", type=int, default=8)
    ap.add_argument("--eval-seed", type=int, default=777,
                    help="held out from train_proxy's --seed")
    ap.add_argument("--points", default=None,
                    help="comma-separated ladder indices to run")
    ap.add_argument("--corpus-dir", default=None,
                    help="where the held-out scenes are written (default: "
                         "a directory under the temp dir)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..models.amodal_dav2 import DAV2Config, build_model
    from ..models.dinov2 import INTERMEDIATE_LAYER_IDX, VIT_PRESETS
    from ..pipeline.amodal_pipeline import AmodalDepthPipeline
    from ..pipeline.quality import check_gate, corpus_quality_report
    from ..convert.weights import params_from_jax

    with open(os.path.join(args.ckpt, "meta.json")) as f:
        meta = json.load(f)
    enc = meta["encoder"]
    trees = {name: load_params_npz(os.path.join(args.ckpt, f"{name}.npz"))
             for name in ("raw_base", "amodal")}
    cfgs = {"raw_base": DAV2Config(encoder=enc, guide_type="none", raw=True),
            "amodal": DAV2Config(encoder=enc, guide_type="mask+observation")}

    corpus = _build_corpus(args.size, args.eval_n, args.eval_seed,
                           args.corpus_dir)
    calib = (corpus[0]["image"], corpus[0]["mask"])
    ladder = build_ladder(args.size, INTERMEDIATE_LAYER_IDX[enc][0],
                          VIT_PRESETS[enc]["depth"])
    if args.points:
        keep = {int(i) for i in args.points.split(",")}
        ladder = [pt for i, pt in enumerate(ladder) if i in keep]

    def make_pipe(tome_base=None, tome_amodal=None, int8=None):
        models = []
        for name in ("raw_base", "amodal"):
            model = build_model(cfgs[name], device=args.device)
            model.load_state_dict(params_from_jax(trees[name], cfgs[name]),
                                  strict=True)
            models.append(model)
        pipe = AmodalDepthPipeline(
            *models, size=args.size, device=args.device,
            dtype=getattr(torch, args.dtype), base_token_merge=tome_base,
            amodal_token_merge=tome_amodal)
        if int8:
            kw = dict(int8)
            pipe.quantize_int8(
                calibration=calib if kw.pop("calib", False) else None, **kw)
        return pipe

    run_exact = _runner(make_pipe())
    rows = []
    print(f"\n## Proxy-v2 gate ladder — trained {enc} "
          f"(steps={meta['steps']}, scenes task) @ {args.size}px, "
          f"{len(corpus)} held-out samples, {args.device} {args.dtype}\n")
    print("| operating point | blended max_abs | blended mean_abs | "
          "hard-bucket max | gate |")
    print("|---|---|---|---|---|")
    for name, tb, ta, int8 in ladder:
        rep = corpus_quality_report(run_exact,
                                    _runner(make_pipe(tb, ta, int8)), corpus)
        verdict = check_gate(rep["overall"])
        hard = rep["per_bucket"]["hard"]["blended_max_abs"]
        row = {"point": name,
               "blended_max_abs": rep["overall"]["blended_max_abs"],
               "blended_mean_abs": rep["overall"]["blended_mean_abs"],
               "hard_max_abs": hard, "pass": verdict["pass"]}
        rows.append(row)
        print(f"| {name} | {row['blended_max_abs']:.4f} | "
              f"{row['blended_mean_abs']:.4f} | "
              f"{'-' if hard is None else f'{hard:.4f}'} | "
              f"{'PASS' if row['pass'] else 'FAIL'} |", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"meta": meta, "size": args.size, "rows": rows}, f,
                      indent=1)
    return rows


if __name__ == "__main__":
    main()
