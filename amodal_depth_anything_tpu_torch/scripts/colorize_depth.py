"""Colorize 16-bit depth PNGs to rendered images (viz helper).

Port of the JAX package's `scripts/colorize_depth.py` (the reference's
`src/scripts/colorize_depth.py`): maps each uint16 depth PNG through a
colormap with percentile-based vmin / vmax (`utils.image.colorize_depth`:
Spectral_r from the copied table, other names through matplotlib) and
writes `{name}_rendered.png` next to it (or into `--out_dir`). PNGs are read
and written by the port's host codec, so the default colormap needs no
PIL or matplotlib.

    python -m amodal_depth_anything_tpu_torch.scripts.colorize_depth \\
        --input preds/ [--out_dir renders/] [--cmap Spectral_r]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

__all__ = ["main"]


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True,
                   help="a depth PNG or a directory of them")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--cmap", default="Spectral_r")
    p.add_argument("--vminp", type=float, default=2.0,
                   help="lower percentile for the color range "
                        "(reference colorize vminp=2)")
    p.add_argument("--vmaxp", type=float, default=95.0)
    return p


def main(argv=None):
    from ..utils.image import colorize_depth, read_image, write_png

    args = _parser().parse_args(argv)
    paths = ([args.input] if os.path.isfile(args.input)
             else sorted(glob.glob(os.path.join(args.input, "*.png"))))
    paths = [p for p in paths if not p.endswith("_rendered.png")]
    if not paths:
        raise SystemExit(f"no PNGs under {args.input}")
    out_dir = args.out_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    written = []
    for path in paths:
        d = read_image(path).astype(np.float32)
        if d.ndim == 3:
            d = d[..., 0]
        # percentile normalisation is scale-invariant: no need to guess
        # the stored unit (u8 vs u16)
        vmin = float(np.percentile(d, args.vminp))
        vmax = float(np.percentile(d, args.vmaxp))
        rgb = colorize_depth(d, min_depth=vmin,
                             max_depth=max(vmax, vmin + 1e-6),
                             cmap=args.cmap)
        out = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        name = os.path.splitext(os.path.basename(path))[0] + "_rendered.png"
        dest = os.path.join(out_dir or os.path.dirname(path) or ".", name)
        write_png(dest, out)
        print(dest)
        written.append(dest)
    return written


if __name__ == "__main__":
    main()
