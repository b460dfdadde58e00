"""Greedy per-layer int8 sensitivity walk over the trunks' blocks.

Port of the JAX package's `scripts/int8_layer_walk.py`. It finds, per
trunk, the largest set of blocks whose calibrated W8A8 keeps the pipeline
under the quality gate (`pipeline.quality.QUALITY_GATE`), so a serving
chain can keep the best passing subset instead of all or nothing:

  1. *Sensitivity pass*: quantise ONE candidate at a time (each block of
     each trunk, all four matmul families, calibrated scales; with `--head`
     also both DPT heads as one candidate) and measure the blended-depth
     delta on a held-out corpus.
  2. *Greedy walk*: add candidates in ascending sensitivity, re-measuring
     the CUMULATIVE delta; a candidate is kept only while the gate still
     passes (deltas compose nonlinearly), a failing one is reverted and the
     walk goes on.

Each point is `AmodalDepthPipeline.quantize_int8(base=True, amodal=True,
calibration=..., base_layer_mask=..., amodal_layer_mask=...)` against the
exact pipeline, over the held-out scenes of `scripts.proxy_gate_v2`. The
default is the trained proxy (`checkpoints/proxy`, vitp) at 224 px;
`--random-weights` draws seeded random weights instead.

    python -m amodal_depth_anything_tpu_torch.scripts.int8_layer_walk \\
        --ckpt checkpoints/proxy --size 224 --eval-n 8

Runs on the card unless `--device cpu` asks for the CPU. Prints the
sensitivity and walk tables and the kept set; `--json-out` writes them in
the JAX script's format.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default="checkpoints/proxy")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--eval-n", type=int, default=8)
    ap.add_argument("--eval-seed", type=int, default=777)
    ap.add_argument("--head", action="store_true",
                    help="include the DPT heads as one greedy candidate")
    ap.add_argument("--random-weights", action="store_true",
                    help="seeded random weights of the checkpoint's encoder "
                         "instead of the trained proxy")
    ap.add_argument("--corpus-dir", default=None,
                    help="where the held-out scenes are written (default: "
                         "a directory under the temp dir)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..convert.weights import params_from_jax
    from ..models.amodal_dav2 import DAV2Config, build_model, init_weights_
    from ..models.dinov2 import VIT_PRESETS
    from ..pipeline.amodal_pipeline import AmodalDepthPipeline
    from ..pipeline.quality import check_gate, corpus_quality_report
    from .proxy_gate_v2 import _build_corpus, _runner, load_params_npz

    with open(os.path.join(args.ckpt, "meta.json")) as f:
        meta = json.load(f)
    enc = meta["encoder"]
    depth = VIT_PRESETS[enc]["depth"]
    cfgs = {"raw_base": DAV2Config(encoder=enc, guide_type="none", raw=True),
            "amodal": DAV2Config(encoder=enc, guide_type="mask+observation")}
    if args.random_weights:
        gen = torch.Generator(device=args.device).manual_seed(0)
        states = {name: init_weights_(build_model(cfg, device=args.device),
                                      gen).state_dict()
                  for name, cfg in cfgs.items()}
        wtag = f"seeded-random {enc}"
    else:
        states = {name: params_from_jax(load_params_npz(
            os.path.join(args.ckpt, f"{name}.npz")), cfg)
            for name, cfg in cfgs.items()}
        wtag = f"trained {enc}"

    corpus = _build_corpus(args.size, args.eval_n, args.eval_seed,
                           args.corpus_dir)
    calib = (corpus[0]["image"], corpus[0]["mask"])

    def pipeline():
        models = []
        for name, cfg in cfgs.items():
            model = build_model(cfg, device=args.device)
            model.load_state_dict(states[name], strict=True)
            models.append(model)
        return AmodalDepthPipeline(*models, size=args.size,
                                   device=args.device)

    def make_pipe(base_mask, amodal_mask, head):
        pipe = pipeline()
        pipe.quantize_int8(base=True, amodal=True, head=head,
                           calibration=calib,
                           base_layer_mask=np.asarray(base_mask, bool),
                           amodal_layer_mask=np.asarray(amodal_mask, bool))
        return pipe

    run_exact = _runner(pipeline())

    def measure(base_mask, amodal_mask, head=False):
        rep = corpus_quality_report(
            run_exact, _runner(make_pipe(base_mask, amodal_mask, head)),
            corpus)
        o = rep["overall"]
        return (o["blended_max_abs"], o["blended_mean_abs"],
                check_gate(o)["pass"])

    zeros = np.zeros(depth, bool)

    # ---- 1. per-candidate sensitivity --------------------------------
    print(f"\n## int8 per-layer sensitivity — {wtag} "
          f"(depth {depth}) @ {args.size}px, {len(corpus)} samples, "
          f"{args.device} float32\n")
    print("| candidate | blended max_abs | mean_abs |")
    print("|---|---|---|")
    sens = []  # (max_abs, trunk, layer); trunk "head" has layer None
    for trunk in ("base", "amodal"):
        for layer in range(depth):
            m = zeros.copy()
            m[layer] = True
            mx, mn, _ = measure(m if trunk == "base" else zeros,
                                m if trunk == "amodal" else zeros)
            sens.append((mx, trunk, layer))
            print(f"| {trunk}:{layer} | {mx:.4f} | {mn:.4f} |", flush=True)
    if args.head:
        mx, mn, _ = measure(zeros, zeros, head=True)
        sens.append((mx, "head", None))
        print(f"| head (both DPT heads) | {mx:.4f} | {mn:.4f} |",
              flush=True)

    # ---- 2. greedy walk ----------------------------------------------
    order = sorted(sens, key=lambda t: t[0])
    base_mask, amodal_mask = zeros.copy(), zeros.copy()
    head_on = False
    steps = []
    print("\n## Greedy walk (ascending single-candidate sensitivity)\n")
    print("| step | added | cum candidates | blended max_abs | "
          "mean_abs | gate |")
    print("|---|---|---|---|---|---|")
    n_cand = len(order)
    for i, (_s, trunk, layer) in enumerate(order):
        if trunk == "head":
            head_on = True
        else:
            (base_mask if trunk == "base" else amodal_mask)[layer] = True
        mx, mn, ok = measure(base_mask, amodal_mask, head_on)
        n_cum = int(base_mask.sum() + amodal_mask.sum()) + int(head_on)
        tag = "head" if trunk == "head" else f"{trunk}:{layer}"
        steps.append({"candidate": tag, "max_abs": mx, "mean_abs": mn,
                      "pass": ok, "kept": ok})
        print(f"| {i} | {tag} | {n_cum}/{n_cand} | {mx:.4f} "
              f"| {mn:.4f} | {'PASS' if ok else 'FAIL -> revert'} |",
              flush=True)
        if not ok:   # revert and walk on: a later candidate may still fit
            if trunk == "head":
                head_on = False
            else:
                (base_mask if trunk == "base" else amodal_mask)[layer] = \
                    False

    n_base, n_amodal = int(base_mask.sum()), int(amodal_mask.sum())
    mx, mn, ok = measure(base_mask, amodal_mask, head_on)
    print(f"\nBest passing subset: base {n_base}/{depth} layers "
          f"{sorted(np.where(base_mask)[0].tolist())}, amodal "
          f"{n_amodal}/{depth} layers "
          f"{sorted(np.where(amodal_mask)[0].tolist())}, head="
          f"{'int8' if head_on else 'float32'} — final delta "
          f"{mx:.4f}/{mn:.4f} gate={'PASS' if ok else 'FAIL'}")
    coverage = (n_base + n_amodal) / (2 * depth)
    print(f"int8 layer coverage: {coverage:.0%}")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({
                "meta": meta, "size": args.size, "head": args.head,
                "random_weights": args.random_weights,
                "sensitivity": [{"trunk": t, "layer": lyr, "max_abs": s}
                                for s, t, lyr in sens],
                "walk": steps,
                "base_mask": base_mask.tolist(),
                "amodal_mask": amodal_mask.tolist(),
                "head_int8": head_on,
                "final": {"max_abs": mx, "mean_abs": mn, "pass": ok,
                          "coverage": coverage},
            }, f, indent=1)
    return base_mask, amodal_mask


if __name__ == "__main__":
    main()
