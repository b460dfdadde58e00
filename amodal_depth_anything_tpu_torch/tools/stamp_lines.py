"""Where a long run's wall time goes, read from its output lines.

    python3 chip_smoke.py 2>&1 | \\
        python -m amodal_depth_anything_tpu_torch.tools.stamp_lines > run.log
    python -m amodal_depth_anything_tpu_torch.tools.stamp_lines \\
        --gaps run.log [--match TEXT ...]

The first form copies standard input to standard output, each line led by
the seconds since the first line was read. The second reads such a log and
prints the 30 longest stretches: each line's seconds since the line before
it (the work that ended with that line), longest first; with `--match`, only
the lines that hold one of the texts, in log order, and their sum.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

__all__ = ["stamp", "gaps"]

_STAMPED = re.compile(r"\s*(\d+(?:\.\d+)?) (.*)")


def stamp(src=sys.stdin, dst=sys.stdout) -> None:
    t0 = None
    for line in src:
        now = time.time()
        t0 = now if t0 is None else t0
        dst.write(f"{now - t0:7.1f} {line}")
        dst.flush()


def gaps(lines) -> list[tuple[float, float, str]]:
    """(seconds since the line before, seconds since the start, text) for
    every stamped line, in log order."""
    out, prev = [], 0.0
    for line in lines:
        m = _STAMPED.match(line)
        if m:
            t = float(m.group(1))
            out.append((t - prev, t, m.group(2)))
            prev = t
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gaps", metavar="LOG", help="a stamped log to read")
    p.add_argument("--match", nargs="*", default=None)
    args = p.parse_args(argv)
    if args.gaps is None:
        stamp()
        return
    with open(args.gaps, errors="replace") as f:
        rows = gaps(f)
    if args.match:
        rows = [r for r in rows if any(m in r[2] for m in args.match)]
        for d, t, text in rows:
            print(f"{d:7.1f} @{t:7.1f}  {text[:120]}")
        print(f"{sum(r[0] for r in rows):7.1f}  in all")
        return
    for d, t, text in sorted(rows, reverse=True)[:30]:
        print(f"{d:7.1f} @{t:7.1f}  {text[:120]}")


if __name__ == "__main__":
    main()
