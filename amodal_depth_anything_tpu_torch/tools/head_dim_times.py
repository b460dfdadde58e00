"""Device time of the bf16 attention kernels at the SD-1.5 UNet's head dims
(40, 80, 160) and at the DINOv2 trunks' 64, beside SDPA's, the card's bound
and the exponentials' floor.

    python -m amodal_depth_anything_tpu_torch.tools.head_dim_times \\
        [--calls 20] [--out FILE.json]

Needs one NVIDIA GPU and nvcc. Times the port it belongs to (to compare
two checkouts on one card, run each checkout's own copy in one call): the
forward (`mha`) at the DepthFM and pix2gestalt UNet shapes (self-attention
and onto 77 or 1 keys; at d = 40 also ToMe-SD's merged 2049 tokens and the
p2g proxy replay's batch 10), and dQ and dK/dV at DepthFM training's (batch
4, and the shapes of a step at the recipe's batch 8: self and onto 77
keys); then the d = 64 trunk shapes as guards. A backward row onto at most
80 keys ("bwd short") times the short-key backward the gradient takes
there (`flash_attn_bwd_short`: the one-pass kernel and, where a head's
tiles span several blocks, the sum of their partial dK and dV), with the
one-pass bound (10 B*H*Nq*Nk*d operations; q, dO, k, v, LSE and delta read
and dq, dk, dv written once), beside the pair on the same inputs. Each time is the
kernel's device time per call from a torch.profiler trace (no launch or
dispatch cost), with the name of the kernel the trace shows; SDPA's
forward and backward are read the same way (a yardstick only). The bound
is the larger of the operations over 989 TFLOP/s and the bytes (each input
read once, each output written once) over 3.35 TB/s. The exponentials'
floor is B*H*Nq*Nk exponentials (one a score; the backward kernels each
rebuild P) over the card's MUFU rate, 16 a clock on each of 132 SMs at the
highest SM clock `nvidia-smi` reads (`clocks.max.sm`): no call that
exponentiates every score in the MUFU unit takes less.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys

# (q shape [B, H, Nq, d], Nk): the SD-1.5 UNet in DepthFM at 512 px batch 4
# (4096 / 1024 / 256 / 64 latent tokens, onto 77 context keys), at d = 40
# also batch 8 (the training recipe's), batch 10 (the p2g proxy's replay)
# and ToMe-SD's 2049 merged tokens,
# and in pix2gestalt at 256 px batch 2 (both guidance halves; onto one
# key); then the vitl / vitg trunks at 518 and 1022 px (d = 64)
FWD_CASES = [((4, 8, 4096, 40), 4096), ((4, 8, 4096, 40), 77),
             ((8, 8, 4096, 40), 4096), ((10, 8, 4096, 40), 4096),
             ((4, 8, 2049, 40), 2049),
             ((2, 8, 1024, 40), 1024), ((2, 8, 1024, 40), 1),
             ((4, 8, 1024, 80), 1024), ((4, 8, 256, 160), 256),
             ((4, 8, 64, 160), 64), ((4, 8, 1024, 80), 77),
             ((4, 8, 256, 160), 77), ((4, 8, 64, 160), 77),
             ((2, 8, 256, 80), 256),
             ((2, 8, 64, 160), 64), ((2, 8, 16, 160), 16),
             ((2, 8, 256, 80), 1), ((2, 8, 64, 160), 1),
             ((2, 8, 16, 160), 1), ((4, 24, 1370, 64), 1370),
             ((1, 24, 5330, 64), 5330)]
# DepthFM training's backward: batch 4, and every shape of a train step at
# the recipe's batch 8 (the mid block's 64 tokens included); then the vitl
# train step's (d = 64)
BWD_CASES = [((4, 8, 4096, 40), 4096), ((4, 8, 4096, 40), 77),
             ((8, 8, 4096, 40), 4096), ((8, 8, 4096, 40), 77),
             ((4, 8, 1024, 80), 1024), ((4, 8, 256, 160), 256),
             ((4, 8, 1024, 80), 77), ((4, 8, 256, 160), 77),
             ((8, 8, 1024, 80), 1024), ((8, 8, 256, 160), 256),
             ((8, 8, 1024, 80), 77), ((8, 8, 256, 160), 77),
             ((8, 8, 64, 160), 64), ((8, 8, 64, 160), 77),
             ((8, 16, 1370, 64), 1370)]
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM, bf16 dense, HBM3
SMS, EX2_PER_CLOCK = 132, 16   # H100 SXM: SMs, MUFU ex2 a clock an SM
KERNEL = re.compile(r"(flash_attn_\w+(?:<[^>]*>)?)")

__all__ = ["FWD_CASES", "BWD_CASES", "fwd_bound", "bwd_bounds", "short_bound",
           "exp_floor", "sm_clock_mhz", "device_events", "device_times",
           "fwd_row", "bwd_row"]


def _roofline(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def fwd_bound(shape, nk: int) -> tuple[float, str]:
    """(ms, what bounds it) of the bf16 forward: q, o and k, v once."""
    b, h, n, d = shape
    return _roofline(4 * b * h * n * nk * d, 2 * (2 * b * h * (n + nk) * d))


def bwd_bounds(shape, nk: int) -> tuple[tuple, tuple]:
    """(dQ, dK/dV) bounds of the bf16 backward, as `fwd_bound`: each reads
    q, dO, k, v, LSE and delta once and writes its gradients once."""
    b, h, n, d = shape
    io = 2 * (2 * b * h * n * d + 2 * b * h * nk * d) + 2 * b * h * n * 4
    return (_roofline(6 * b * h * n * nk * d, io + 2 * b * h * n * d),
            _roofline(8 * b * h * n * nk * d, io + 4 * b * h * nk * d))


def short_bound(shape, nk: int) -> tuple[float, str]:
    """(ms, what bounds it) of the one-pass bf16 backward onto a short key
    set: q, dO, k, v, LSE and delta read once, dq, dk and dv written once;
    S, dP, dS K, P^T dO and dS^T Q."""
    b, h, n, d = shape
    return _roofline(10 * b * h * n * nk * d,
                     2 * (3 * b * h * n * d + 4 * b * h * nk * d)
                     + 2 * b * h * n * 4)


def exp_floor(shape, nk: int, mhz: float) -> float:
    """ms of B*H*Nq*Nk exponentials at the card's MUFU rate and SM clock
    `mhz`: the forward's, and each backward kernel's (P rebuilt)."""
    b, h, n, _ = shape
    return b * h * n * nk / (SMS * EX2_PER_CLOCK * mhz * 1e6) * 1e3


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The highest SM clock `nvidia-smi` reads for card 0, MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    return float(out.strip().splitlines()[0])


def device_events(prof) -> list:
    """(name, ms) of every device-side event (kernel, copy, set) of a
    finished torch.profiler trace, read from its raw Kineto events: the
    profiler's own event list builds a Python object and a tree over every
    host and device event, tens of seconds for a call of some 10^5."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda
            and not getattr(e, "is_hidden_event", lambda: False)()]


def device_times(fn, calls: int) -> dict:
    """{kernel name: device ms per call} over `calls` calls of `fn` under
    torch.profiler (`device_events`): each name's mean event time times its
    launches a call (its events over `calls`, rounded), so that an event
    the trace lost or gained does not move the time; "all" sums every
    name's. A trace that recorded no device event at all (seen about once
    in a hundred traces on the card) is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    found: dict[str, list] = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for name, ms in device_events(prof):
            found.setdefault(name, []).append(ms)
        if found:
            break
    out = {"all": 0.0}
    for name, ms in found.items():
        per_call = sum(ms) / len(ms) * max(1, round(len(ms) / calls))
        out["all"] += per_call
        kernel = KERNEL.search(name)
        if kernel:
            out[kernel.group(1)] = out.get(kernel.group(1), 0.0) + per_call
    return out


def _kernel(times: dict, prefix: str) -> tuple[str | None, float | None]:
    hits = [(k, v) for k, v in times.items() if k.startswith(prefix + "_")]
    if not hits:
        return None, None
    return hits[0][0], sum(v for _, v in hits)


def _inputs(shape, nk: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, _, d = shape
    q, do = (torch.randn(shape, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def fwd_row(shape, nk: int, calls: int = 20) -> dict:
    """The forward kernel and SDPA's forward at one shape, bf16."""
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha

    q, k, v, _ = _inputs(shape, nk, 0)
    name, ms = _kernel(device_times(lambda: mha(q, k, v), calls),
                       "flash_attn_fwd")
    sdpa = device_times(lambda: F.scaled_dot_product_attention(q, k, v),
                        calls)["all"]
    bound, by = fwd_bound(shape, nk)
    return {"q": list(shape), "nk": nk, "kernel": name, "device_ms": ms,
            "sdpa_device_ms": sdpa, "bound_ms": bound, "bound_by": by,
            "exp_floor_ms": exp_floor(shape, nk, sm_clock_mhz())}


def bwd_row(shape, nk: int, calls: int = 20) -> dict:
    """dQ, dK/dV and SDPA's backward at one shape, bf16; onto at most
    SHORT_KEYS keys also the short-key backward ("short_*")."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        SHORT_KEYS, flash_attn_bwd_dkv, flash_attn_bwd_dq,
        flash_attn_bwd_short, mha)

    q, k, v, do = _inputs(shape, nk, 1)
    o, lse = mha(q, k, v, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args, scale = (q, k, v, do, lse, delta), shape[3] ** -0.5
    times = device_times(lambda: (flash_attn_bwd_dq(*args, sm_scale=scale),
                                  flash_attn_bwd_dkv(*args, sm_scale=scale)),
                         calls)
    dq_name, dq_ms = _kernel(times, "flash_attn_bwd_dq")
    dkv_name, dkv_ms = _kernel(times, "flash_attn_bwd_dkv")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    sdpa = device_times(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), calls)["all"]
    dq_bound, dkv_bound = bwd_bounds(shape, nk)
    short = {}
    if nk <= SHORT_KEYS:   # the one-pass kernel, then (maybe) the sum
        t = device_times(lambda: flash_attn_bwd_short(*args, sm_scale=scale),
                         calls)
        one = [(k, v) for k, v in t.items()
               if k.startswith("flash_attn_bwd_bf16_short<")]
        bound, by = short_bound(shape, nk)
        short = {"short_kernel": one[0][0] if one else None,
                 "short_device_ms": (sum(v for _, v in one)
                                     + t.get("flash_attn_bwd_short_sum", 0.0)
                                     if one else None),
                 "short_sum_ms": t.get("flash_attn_bwd_short_sum"),
                 "short_bound_ms": bound, "short_bound_by": by}
    return {"q": list(shape), "nk": nk, **short, "dq_kernel": dq_name,
            "dq_device_ms": dq_ms, "dq_bound_ms": dq_bound[0],
            "dkv_kernel": dkv_name, "dkv_device_ms": dkv_ms,
            "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
            "sdpa_bwd_device_ms": sdpa,
            "exp_floor_ms": exp_floor(shape, nk, sm_clock_mhz())}


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", help="also write the rows here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("head_dim_times: no CUDA device", file=sys.stderr)
        return 1
    from amodal_depth_anything_tpu_torch.ops import _build

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build(("flash_attn_fwd", "flash_attn_bwd"))
    print(f"head_dim_times of {_build.CSRC} [{gpu}, SM clock up to "
          f"{sm_clock_mhz():.0f} MHz]", flush=True)
    rows = {"card": gpu, "sm_clock_max_mhz": sm_clock_mhz(), "fwd": [],
            "bwd": []}
    for shape, nk in FWD_CASES:
        r = fwd_row(shape, nk, args.calls)
        rows["fwd"].append(r)
        print(f"  fwd q {r['q']} Nk={nk}: {r['kernel']} "
              f"{_ms(r['device_ms'])}, SDPA {_ms(r['sdpa_device_ms'])}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), exp floor "
              f"{r['exp_floor_ms']:.4f} ms", flush=True)
    for shape, nk in BWD_CASES:
        r = bwd_row(shape, nk, args.calls)
        rows["bwd"].append(r)
        if "short_kernel" in r:
            print(f"  bwd short q {r['q']} Nk={nk}: {r['short_kernel']} "
                  f"{_ms(r['short_device_ms'])} (the sum "
                  f"{_ms(r['short_sum_ms'])}; bound "
                  f"{r['short_bound_ms']:.4f}, {r['short_bound_by']})",
                  flush=True)
        print(f"  bwd q {r['q']} Nk={nk}: {r['dq_kernel']} "
              f"{_ms(r['dq_device_ms'])} (bound {r['dq_bound_ms']:.4f}), "
              f"{r['dkv_kernel']} {_ms(r['dkv_device_ms'])} (bound "
              f"{r['dkv_bound_ms']:.4f}, {r['dkv_bound_by']}), SDPA "
              f"backward {_ms(r['sdpa_bwd_device_ms'])}, exp floor "
              f"{r['exp_floor_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
