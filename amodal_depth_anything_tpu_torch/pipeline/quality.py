"""Serving-optimisation quality gate: blended-depth delta against the exact
pipeline.

Port of the JAX package's `pipeline/quality.py` (its own copy). A
parity-breaking serving knob (on the port: DeepCache in the DepthFM family)
trades exactness for speed; no throughput number for it is honest without
the accuracy cost beside it. This harness runs the SAME (image, mask) corpus
through an exact pipeline and an optimised one and reports the depth delta:
max / mean abs, overall and per difficulty bucket when visible/whole masks
are available (buckets per the eval protocol: visibility ratio > 0.75 easy,
> 0.5 mid, else hard; reference `discriminative_trainer.py:563-568`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["blended_depth_delta", "corpus_quality_report", "check_gate",
           "QUALITY_GATE"]

# Acceptance thresholds for the parity-breaking serving knobs: an optimised
# mode is only RECOMMENDED when its delta against the exact pipeline stays
# inside this gate on the evaluation corpus. Depth maps live in [0, 1], so
# 0.05 max abs is a 5%-of-range worst-case excursion and 0.01 mean abs keeps
# the bulk error within colourisation quantisation.
QUALITY_GATE = {"max_abs": 0.05, "mean_abs": 0.01}


def check_gate(delta: dict, *, max_abs: float | None = None,
               mean_abs: float | None = None) -> dict:
    """Verdict for a delta-stats dict against the acceptance gate.

    Applies to every quality proxy (keys ending in `_max_abs` /
    `_mean_abs`: blended or base depth, DepthFM depth). Returns
    {limits, pass, failed}."""
    limits = {"max_abs": QUALITY_GATE["max_abs"] if max_abs is None
              else float(max_abs),
              "mean_abs": QUALITY_GATE["mean_abs"] if mean_abs is None
              else float(mean_abs)}
    failed = []
    for k, v in delta.items():
        if not isinstance(v, (int, float)):
            continue
        if k.endswith("_max_abs") and v > limits["max_abs"]:
            failed.append(k)
        elif k.endswith("_mean_abs") and v > limits["mean_abs"]:
            failed.append(k)
    return {"limits": limits, "pass": not failed, "failed": failed}


def blended_depth_delta(base_a, blended_a, base_b, blended_b) -> dict:
    """Delta stats between two pipeline outputs (numpy arrays, [B,S,S])."""
    d_blend = np.abs(np.float32(blended_a) - np.float32(blended_b))
    d_base = np.abs(np.float32(base_a) - np.float32(base_b))
    return {
        "blended_max_abs": float(d_blend.max()),
        "blended_mean_abs": float(d_blend.mean()),
        "base_max_abs": float(d_base.max()),
        "base_mean_abs": float(d_base.mean()),
    }


def corpus_quality_report(run_exact, run_optimized, corpus) -> dict:
    """Run both pipeline callables over a corpus and aggregate deltas.

    run_*(image [B,H,W,3] float 0-255, mask [B,H,W,1] float) ->
    (base [B,S,S], blended [B,S,S]), e.g. two closures over
    `AmodalDepthPipeline` instances.

    corpus: iterable of dicts with 'image' [H,W,3] uint8 and 'mask'
    [H,W]; optional 'visible' and 'whole' masks enable difficulty
    buckets. Returns {overall: stats, per_bucket: {easy/mid/hard: stats},
    n_samples}."""
    per_bucket: dict[str, list] = {"easy": [], "mid": [], "hard": []}
    blend_max, blend_sum, base_max, base_sum, n_px = 0.0, 0.0, 0.0, 0.0, 0

    n = 0
    for item in corpus:
        image = np.asarray(item["image"], np.float32)[None]
        mask = np.asarray(item["mask"], np.float32)[None, ..., None]
        base_a, blended_a = run_exact(image, mask)
        base_b, blended_b = run_optimized(image, mask)
        d = blended_depth_delta(base_a, blended_a, base_b, blended_b)
        n += 1
        blend_max = max(blend_max, d["blended_max_abs"])
        base_max = max(base_max, d["base_max_abs"])
        px = int(np.prod(np.shape(blended_a)))
        blend_sum += d["blended_mean_abs"] * px
        base_sum += d["base_mean_abs"] * px
        n_px += px
        if "visible" in item and "whole" in item:
            vis = np.asarray(item["visible"]) > 0
            whole = np.asarray(item["whole"]) > 0
            ratio = float(vis.sum()) / max(float(whole.sum()), 1.0)
            bucket = "easy" if ratio > 0.75 else \
                "mid" if ratio > 0.5 else "hard"
            per_bucket[bucket].append(d["blended_max_abs"])

    return {
        "n_samples": n,
        "overall": {
            "blended_max_abs": blend_max,
            "blended_mean_abs": blend_sum / max(n_px, 1),
            "base_max_abs": base_max,
            "base_mean_abs": base_sum / max(n_px, 1),
        },
        "per_bucket": {
            k: {"blended_max_abs": float(np.max(v)) if v else None,
                "n": len(v)}
            for k, v in per_bucket.items()
        },
    }
