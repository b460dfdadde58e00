"""Sampler options shared by the generative pipelines.

Only the DeepCache spec parser so far: the DDIM loop itself belongs to the
pix2gestalt (mask heuristics) path.
"""

from __future__ import annotations

__all__ = ["parse_deep_cache"]


def parse_deep_cache(spec, default_groups: int = 3):
    """A DeepCache spec -> (interval, groups) or None.

    None, "" and 0 turn it off; an int or "N" means (N, default_groups);
    "N,G" or a pair means (N, G). The interval is how many solver steps
    share one full UNet pass, the groups how many of the shallowest
    input/output groups the steps in between still run. Malformed specs
    and non-positive values raise ValueError."""
    if spec is None or spec == "" or (isinstance(spec, int) and spec == 0):
        return None
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(f"deep_cache pair must be (interval, groups), "
                             f"got {spec!r}")
        parts = list(spec)
    elif isinstance(spec, int):
        parts = [spec]
    else:
        parts = str(spec).split(",")
        if len(parts) > 2:
            raise ValueError(f"deep_cache spec must be 'N' or 'N,G', got "
                             f"{spec!r}")
    try:
        values = [int(p) for p in parts]
    except (TypeError, ValueError):
        raise ValueError(f"deep_cache spec must hold integers, got "
                         f"{spec!r}") from None
    if values[0] == 0:
        return None
    if len(values) == 1:
        values.append(default_groups)
    interval, groups = values
    if interval < 1 or groups < 1:
        raise ValueError(f"deep_cache interval and groups must be positive, "
                         f"got {spec!r}")
    return (interval, groups)
