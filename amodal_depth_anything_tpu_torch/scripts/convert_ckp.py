"""Checkpoint surgery utilities.

Port of the JAX package's `scripts/convert_ckp.py` (the reference's
`src/scripts/convert_ckp.py:1-7` strips a DAV2 checkpoint to its backbone
keys):

    # strip a torch DAV2 checkpoint to backbone-only keys
    python -m amodal_depth_anything_tpu_torch.scripts.convert_ckp strip \\
        --input ckpt.pth --output backbone.pth

`to_orbax` (an Orbax pytree directory for the JAX package) is the JAX
package's own: Orbax needs JAX, which the port does not use; this command
exits naming the JAX package's script. The port itself loads the torch
checkpoint directly.
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("command", choices=["strip", "to_orbax"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    if args.command == "to_orbax":
        raise SystemExit(
            "convert_ckp to_orbax writes an Orbax checkpoint, which needs "
            "JAX: run `python -m amodal_depth_anything_tpu.scripts."
            "convert_ckp to_orbax` from the JAX package (amodal_depth_"
            "anything_tpu). The port loads the torch checkpoint as it is.")

    import torch
    sd = torch.load(args.input, map_location="cpu", weights_only=True)
    stripped = {k.replace("pretrained.", "", 1): v for k, v in sd.items()
                if k.startswith("pretrained.")}
    torch.save(stripped, args.output)
    print(f"wrote {len(stripped)} backbone tensors to {args.output}")
    return stripped


if __name__ == "__main__":
    main()
