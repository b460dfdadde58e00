"""Which module makes a batch row's result depend on its position in the
batch.

    python -m amodal_depth_anything_tpu_torch.tools.batch_position_probe

Runs the seeded vitg raw base + vitl AmodalDAv2 (518 px, batch 4) in
bfloat16 and in float32 on one image repeated in every row of the batch,
with a forward hook on every module, and prints the first modules whose
output rows differ from row 0, each row's max abs difference, and the same
for the pipeline's two maps. The rows hold one input, so any difference is
the position's: `MicroBatcher` coalesces and pads requests, so on the card a
request's result is that of its row. Needs a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["probe"]

BATCH, SIZE, SHOWN = 4, 518, 6


def probe(dtype: torch.dtype) -> None:
    from ..ops.precision import apply_precision_policy
    from ..pipeline.amodal_pipeline import AmodalDepthPipeline

    apply_precision_policy(dtype)
    pipe = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=dtype)
    found = []

    def hook(name):
        def fn(mod, inputs, out):
            t = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(t, torch.Tensor) and t.dim() and len(t) == BATCH:
                rows = [float((t[b].float() - t[0].float()).abs().max())
                        for b in range(BATCH)]
                if max(rows) > 0:
                    found.append((name, type(mod).__name__,
                                  list(t.shape), rows))
        return fn

    for tag, model in (("raw", pipe.raw_model),
                       ("amodal", pipe.amodal_model)):
        for name, mod in model.named_modules():
            mod.register_forward_hook(hook(f"{tag}.{name}"))
    rng = np.random.default_rng(0)
    img = np.repeat((rng.random((1, SIZE, SIZE, 3)) * 255).astype(
        np.float32), BATCH, axis=0)
    mask = np.zeros(img.shape[:3], np.float32)
    mask[:, SIZE // 5:4 * SIZE // 5, SIZE // 5:4 * SIZE // 5] = 1.0
    maps = pipe(img, mask)
    print(f"{dtype}, batch {BATCH}, {SIZE} px, {torch.cuda.get_device_name(0)}"
          f": {len(found)} module outputs differ between rows of one "
          f"repeated input", flush=True)
    for name, kind, shape, rows in found[:SHOWN]:
        print(f"  {name} ({kind}, {shape}): rows vs row 0 max abs "
              f"{[f'{r:.3g}' for r in rows]}")
    for what, a in zip(("base", "blended"), maps):
        rows = [float(np.abs(a[b] - a[0]).max()) for b in range(BATCH)]
        print(f"  {what} map: rows vs row 0 max abs "
              f"{[f'{r:.4g}' for r in rows]}", flush=True)


if __name__ == "__main__":
    for dt in (torch.bfloat16, torch.float32):
        probe(dt)
        torch.cuda.empty_cache()
