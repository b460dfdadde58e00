#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives the port (`amodal_depth_anything_tpu_torch`, never JAX) through
its user entry points and holds every hand-written kernel against its
plain PyTorch version on the card:

  1. device and flags: `nvidia-smi` name and power limit, the TF32 flags;
  2. build: nvcc compiles every kernel from `csrc/` (all at once);
  3. kernel vs plain version at the main path's attention shapes and
     more, float32 (max abs <= 2e-5) and bfloat16 (<= 2e-2, plain version
     on the bf16-rounded inputs in float32), with kernel, plain and
     `F.scaled_dot_product_attention` times (the last a yardstick only);
  4. the trained in-repo proxies through the pipeline on the card (f32,
     TF32 off, kernel) against the same pipeline on the CPU (plain), max
     abs <= 1e-4;
  5. full width: seeded random vitg raw base + vitl AmodalDAv2 at 518 px,
     one float32 image through the kernel and the plain path, then
     bfloat16 batch 4 through `AmodalDepthPipeline.__call__` for timed
     calls: finite [4, 518, 518] outputs, exactly 64 kernel launches per
     call, images/s, p50 latency and peak memory; then one more call
     under torch.profiler for the device time by kernel.

Prints a `{"kernels": [...]}` line, the card's name and power limit, and as
its last line `{"ok": true, "device": {...}}`. Exits non-zero without that
line when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

KERNEL_SOURCE = "amodal_depth_anything_tpu_torch/csrc/flash_attn_fwd.cu"
KERNEL_REPLACES = "amodal_depth_anything_tpu/ops/flash_attention.py:111"
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, FP32 outside the
# tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-5
PROXY_TOL = 1e-4
FULL_F32_TOL = 1e-3
MIN_STD = 1e-3   # a depth map that varies: the trunks reach the output
# (shape [B, H, N, D], kv_len): vitg/vitl trunk shapes at 518 px (N = 1370)
# for batch 1 and 4, vitg at 1022 px (N = 5330), a ragged N and kv_len < N
ATTN_CASES = [((4, 24, 1370, 64), None), ((1, 24, 1370, 64), None),
              ((4, 16, 1370, 64), None), ((1, 24, 5330, 64), None),
              ((2, 16, 777, 64), None), ((1, 16, 1408, 64), 1370)]
MAIN_CASE = ((4, 24, 1370, 64), None, "bfloat16")   # the kernels-line shape
FULL_BATCH, FULL_CALLS, SIZE = 4, 5, 518

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        failures.append(what)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_phase(gpu: str) -> dict:
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        mha, mha_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for shape, kv_len in ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            b, h, n, d = shape
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            out, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = mha_reference(q.float(), k.float(), v.float(),
                                         kv_len=kv_len, return_lse=True)
            err = (out.float() - ref).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            del ref, ref_lse
            kv = n if kv_len is None else kv_len
            flops = 4 * b * h * n * kv * d
            nbytes = (2 * b * h * n * d + 2 * b * h * kv * d) * q.element_size()
            t_ops, t_bytes = flops / PEAK_FLOPS[dt_name], nbytes / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            mask = None if kv_len is None else (
                torch.arange(n, device="cuda") < kv_len)[None, None, None]
            iters = max(3, min(50, int(2e11 / flops)))
            ms = cuda_ms(lambda: mha(q, k, v, kv_len=kv_len), iters)
            plain_ms = cuda_ms(
                lambda: mha_reference(q, k, v, kv_len=kv_len), 3, warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), iters)
            print(f"  attn {dt_name:8s} {str(list(shape)):20s} "
                  f"kv_len={kv} max_abs={err:.3e} lse_abs={lse_err:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa "
                  f"{lib_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({'operations' if t_ops >= t_bytes else 'bytes'}) "
                  f"{flops / ms / 1e9:.1f} TFLOP/s [{gpu}]", flush=True)
            check(err <= TOL[dt_name] and err == err,
                  f"flash_attn_fwd {dt_name} {list(shape)} kv_len={kv}: "
                  f"max abs {err:.3e} <= {TOL[dt_name]}")
            check(lse_err <= LSE_TOL,
                  f"flash_attn_fwd {dt_name} {list(shape)} LSE max abs "
                  f"{lse_err:.3e} <= {LSE_TOL}")
            if (shape, kv_len, dt_name) == MAIN_CASE:
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms,
                        "bound_by": ("operations" if t_ops >= t_bytes
                                     else "bytes"),
                        "library_ms": lib_ms}
            del q, k, v, out, lse
    torch.cuda.empty_cache()
    return main


def proxy_phase() -> None:
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import (
        load_params_npz, params_from_jax)
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model)
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline

    cfgs = {"raw_base": DAV2Config(encoder="vitp", guide_type="none",
                                   raw=True),
            "amodal": DAV2Config(encoder="vitp")}
    params = {name: params_from_jax(load_params_npz(
        os.path.join("checkpoints", "proxy", f"{name}.npz")), cfg)
        for name, cfg in cfgs.items()}

    def pipe(device):
        models = []
        for name, cfg in cfgs.items():
            model = build_model(cfg)
            model.load_state_dict(params[name], strict=True)
            models.append(model)
        return AmodalDepthPipeline(*models, size=112, device=device,
                                   dtype=torch.float32)

    rng = np.random.default_rng(0)
    img = (rng.random((2, 90, 130, 3)) * 255).astype(np.float32)
    mask = np.zeros((2, 90, 130), np.float32)
    mask[:, 20:70, 40:90] = 1.0
    cpu_base, cpu_blended = pipe("cpu")(img, mask)
    mha.launches = 0
    gpu_base, gpu_blended = pipe("cuda")(img, mask)
    launches = mha.launches
    for name, a, b in (("base", gpu_base, cpu_base),
                       ("blended", gpu_blended, cpu_blended)):
        err = float(np.abs(a - b).max())
        check(np.isfinite(a).all() and err <= PROXY_TOL,
              f"proxy {name} map, card (kernel) vs CPU (plain): max abs "
              f"{err:.3e} <= {PROXY_TOL}")
    check(launches == 24, f"proxy call launched flash_attn_fwd {launches} "
                          f"times (12 + 12 blocks)")


def profile_call(pipe, img, mask, gpu: str) -> None:
    """Where one bf16 call's device time goes: the device-side (kernel and
    copy) events of a torch.profiler trace, summed by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe(img, mask)
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    if not by_name:
        print("  profiler recorded no device time: breakdown not measured",
              flush=True)
        return
    busy_ms = sum(ms for ms, _ in by_name.values())
    print(f"  one profiled bf16 call: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall) "
          f"[{gpu}]", flush=True)
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:14]:
        print(f"    {ms:8.2f} ms {100 * ms / busy_ms:5.1f}% x{count:<5d} "
              f"{name[:100]}", flush=True)


def full_width_phase(gpu: str) -> int:
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline

    t0 = time.time()
    pipe = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"  seeded vitg raw base + vitl AmodalDAv2 built on the card in "
          f"{time.time() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(1)
    img = (rng.random((FULL_BATCH, 600, 800, 3)) * 255).astype(np.float32)
    mask = np.zeros((FULL_BATCH, 600, 800), np.float32)
    mask[:, 150:450, 250:600] = 1.0

    mha.launches = 0
    base_k, blended_k = pipe(img[:1], mask[:1])
    f32_launches = mha.launches
    pipe.attn_impl = "plain"
    base_p, blended_p = pipe(img[:1], mask[:1])
    pipe.attn_impl = None
    check(f32_launches == 64, f"f32 full-width call launched "
                              f"flash_attn_fwd {f32_launches} times (64)")
    for name, a, b in (("base", base_k, base_p),
                       ("blended", blended_k, blended_p)):
        err = float(np.abs(a - b).max())
        print(f"  full width f32 {name}: std {a.std():.4f}, kernel vs plain "
              f"attention max abs {err:.3e}", flush=True)
        check(a.shape == (1, SIZE, SIZE) and np.isfinite(a).all()
              and a.std() > MIN_STD and err <= FULL_F32_TOL,
              f"full-width f32 {name} map finite, [1,{SIZE},{SIZE}], not "
              f"constant, kernel vs plain max abs {err:.3e} <= "
              f"{FULL_F32_TOL}")

    # the same modules, cast in place to bfloat16
    pipe = AmodalDepthPipeline(pipe.raw_model, pipe.amodal_model, size=SIZE,
                               device="cuda", dtype=torch.bfloat16)
    pipe(img, mask)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    mha.launches = 0                      # the main path starts here
    for _ in range(FULL_CALLS):
        t = time.perf_counter()
        base, blended = pipe(img, mask)   # returns numpy: synchronised
        latencies.append(time.perf_counter() - t)
    launches = mha.launches               # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == 64 * FULL_CALLS,
          f"bf16 main path launched flash_attn_fwd {launches} times "
          f"({64 * FULL_CALLS} = 64 per call)")
    for name, a in (("base", base), ("blended", blended)):
        check(a.shape == (FULL_BATCH, SIZE, SIZE) and np.isfinite(a).all()
              and a.std() > MIN_STD,
              f"bf16 {name} map finite, [{FULL_BATCH},{SIZE},{SIZE}], not "
              f"constant (std {a.std():.4f})")
    profile_call(pipe, img, mask, gpu)
    diff = float(np.abs(blended[0] - blended_k[0]).max())
    p50 = float(np.median(latencies)) * 1e3
    print(f"  full width bf16 batch {FULL_BATCH} at {SIZE} px: "
          f"{FULL_BATCH * FULL_CALLS / sum(latencies):.3f} images/s, p50 "
          f"{p50:.1f} ms per call, latencies "
          f"{[round(x * 1e3, 1) for x in latencies]} ms, peak memory "
          f"{peak:.2f} GiB; bf16 vs f32 blended max abs {diff:.3e} [{gpu}]",
          flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 1
    from amodal_depth_anything_tpu_torch.ops import _build
    from amodal_depth_anything_tpu_torch.ops.precision import \
        apply_precision_policy

    gpu = card()
    print(f"[1] device: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    apply_precision_policy(torch.float32)
    print(f"  allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    print("[2] build", flush=True)
    t0 = time.time()
    reports = _build.build()
    print(f"  built {sorted(reports)} in {time.time() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    print("[3] kernels against their plain versions", flush=True)
    main_attn = attention_phase(gpu)

    print("[4] trained proxies: card vs CPU", flush=True)
    proxy_phase()

    print("[5] full width: vitg base + vitl AmodalDAv2", flush=True)
    launches = full_width_phase(gpu)

    kernels = [{"name": "flash_attn_fwd", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "launches": launches, **main_attn}]
    print(json.dumps({"kernels": kernels}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for what in failures:
            print(f"  {what}", file=sys.stderr)
        return 1
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
