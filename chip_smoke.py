#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives the port (`amodal_depth_anything_tpu_torch`, never JAX) through
its user entry points and holds every hand-written kernel against its
plain PyTorch version on the card:

  1. device and flags: `nvidia-smi` name and power limit, the TF32 flags;
  2. build: nvcc compiles the three kernel libraries from `csrc/` (all at
     once); where `cuobjdump` is found, each library's SASS must hold
     HGMMA (wgmma) and UTMALDG (TMA load) opcodes;
  3. kernel vs plain version at the main paths' attention shapes and
     more, float32 (max abs <= 2e-5) and bfloat16 (<= 2e-2, plain version
     on the bf16-rounded inputs in float32), with kernel, plain and
     `F.scaled_dot_product_attention` times (the last a yardstick only):
     the forward at the DINOv2 trunks' head dim 64 and at the SD-1.5
     UNet's shapes (head dims 40/80/160, self-attention and
     cross-attention onto 77 keys, the proxy's 12/24/48) and on the
     edges of the Hopper kernel's 128-row tiles (N from 1 to 257, kv_len
     one short of N and in the middle of a tile, 77 keys under 4096 rows,
     strided views of one qkv buffer, with and without the LSE), then the
     two backward kernels (dQ; dK and dV) against `mha_bwd_reference`,
     tolerances relative to the reference's max abs, at the trunks' shapes
     and the UNet's (head dims 40/80/160, self-attention and onto 77
     keys), each timed beside SDPA's backward (CUDA events, and the
     kernels' device time from torch.profiler, which launch-bound shapes
     need), and on the edges of their
     tiles (the forward's sweep: N from 1 to 257, kv_len inside a tile,
     dead dK/dV rows exactly 0, head dims 64/40/24/8), and `mha` under
     autograd on strided CUDA views; then the fused matmul + LayerScale +
     residual epilogue against `matmul_scale_residual_reference` at the
     trunks' proj / fc2 shapes, and its path: a chain of four blocks at
     vitg width with the kernel and with the library chain (`F.linear`,
     `torch.addcmul`), results compared and both timed; and what a launch
     of each redesigned kernel costs the host (1000 launches, no sync);
  4. the trained in-repo proxies on the card (f32, TF32 off, kernels)
     against the CPU (plain): the pipeline's maps, max abs <= 1e-4, one
     train step's loss and every parameter's gradient, <= 1e-4 of each
     gradient's max abs, the DepthFM proxy through
     `DepthFMPipeline.__call__` at 64 px, max abs <= 1e-4, and one
     `DepthFMAmodalTrainer` step on it (128 px, the same draws on both
     sides): the loss and every UNet gradient within 1e-4 of its max abs;
     both proxy pipelines also captured as CUDA graphs (`pipeline.aot`)
     and replayed against the CPU, max abs <= 1e-4;
  5. inference at full width: seeded random vitg raw base + vitl
     AmodalDAv2 at 518 px, one float32 image through the kernel and the
     plain path, then bfloat16 batch 4 through
     `AmodalDepthPipeline.__call__` for timed calls: finite [4, 518, 518]
     outputs, exactly 64 kernel launches per call, images/s, p50 latency
     and peak memory; then one more call under torch.profiler for the
     device time by kernel;
  6. training at full width: seeded random vitl AmodalDAv2 under
     `DiscriminativeTrainer` with the shipped recipe
     (`configs/train_discriminative_vitl.yaml`: bfloat16, remat "attn",
     Adam, clip 0.01), fed batches of 8 synthetic scenes at 518 px from
     memory. Five steps through `trainer.train()`: finite losses, moved
     parameters, exactly 24 forward, 24 dQ and 24 dK/dV launches per step;
     one float32 step at batch 1 with the kernels against the same step
     with plain attention (loss and gradient norm within 1e-3); one
     `validate()` over two batches; steps/s, p50 step time, peak memory
     and a torch.profiler breakdown of one step;
  7. DepthFM inference at full width: seeded random DepthFMAmodal (SD-1.5
     UNet 320 x (1,2,4,4), 8 heads, context 77 x 1024, VAE
     (128,256,512,512) x 2) at 512 px, 4 Euler steps. One float32 image
     with the kernels against plain attention, then bfloat16 batch 4
     through `DepthFMPipeline.__call__` from host arrays: finite
     [4, 512, 512] outputs in [0, 1], exactly 128 forward-kernel launches
     per call (4 steps x (16 self + 16 cross)), images/s, p50 latency,
     peak memory and a torch.profiler breakdown of one call;
  8. DepthFM training at full width: a seeded random DepthFMAmodal at the
     SD-1.5 widths under `DepthFMAmodalTrainer` with the shipped recipe
     (`configs/train_depthfm_base.yaml`: bfloat16, l1 on the target object,
     remat "attn", so no UNet recompute), fed batches of 8 synthetic scenes
     at 518 px (64 x 64 latents) from memory. Five steps through
     `trainer.train()`: finite losses, a moved UNet, a bit-identical frozen
     VAE and text embedding, exactly 32 forward, 32 dQ and 32 dK/dV
     launches per step; one step with `remat=True` (64 forward launches)
     beside the recipe's, with peak memory; steps/s, p50 step time, peak
     memory and a torch.profiler breakdown of one step (each attention
     instantiation, GroupNorm's plain ops, device busy against wall); one
     `validate()`; one float32 step at batch 1 with the kernels against
     plain attention (loss and UNet gradient norm within 1e-3); then two
     `DepthFMTrainer` steps under `configs/train_depthfm_ddpm_finetune.yaml`
     (v-prediction, annealed multi-resolution noise) on the plain DepthFM
     and its `validate()` (DDIM, 4 steps);
  9. serving at full width: (a) the phase-5 pipeline (vitg + vitl, 518 px,
     bf16, batch 4) captured by `capture_amodal_program` and (b) the
     phase-7 one (DepthFMAmodal, 512 px, 4 steps, bf16, batch 4) by
     `capture_depthfm_program`, each replay against its eager call (max
     abs <= 1e-3), exactly 64 / 128 forward-kernel launches in a profiled
     replay (the Python counters count only warm-up and capture), images/s,
     p50, device busy against wall and peak memory for eager and replay;
     DeepCache (2, 2) captured and replayed with its `quality` delta and
     gate verdict against the exact replay; (c) `cli.serve.build_server`
     over the amodal program captured at the server's square input, 16
     POSTs from 8 threads over loopback, all 200, dispatches, per-request
     p50, depth within one uint16 step + 1e-3 of a direct call, and
     `python -m ...cli.serve --random` as a subprocess (it must say that it
     serves a CUDA graph; one POST, then it is stopped); (d) the
     phase-(a) pipeline's serving state saved and restored (under
     build/, deleted after), its replay bit-identical, bytes and seconds;
 10. the heuristics demo: (a) the forward kernel at pix2gestalt's UNet
     shapes (batch 2 at 256 px: self-attention over 1024/256/64/16 tokens
     at d 40/80/160, and onto ONE context token, where the output must be
     V exactly) and at CLIP ViT-L/14's [1,16,257,64], in f32 and bf16,
     with and without the LSE, k/v from a one-token context and as views
     whose size-1 token dimension has an odd stride; the device time of
     the kernel and of SDPA at [1,16,257,64] and [2,8,1024,40] onto one
     key; (b) the trained pix2gestalt proxy in f32 with TF32 off, card
     (kernels) against CPU (plain): one UNet call (<= 1e-4) and
     `MaskHeuristics.pix2gestalt_completion` at 64 px after 10 and 100
     DDIM steps on the same noise (<= 1e-3, with the error per step);
     (c) seeded SAM ViT-H, pix2gestalt (SD-1.5 UNet, 12-channel conv-in,
     768-wide context; CLIP ViT-L/14; SD VAE) and RMBG-1.4 at full width,
     (d) one f32 UNet step with the kernels against plain attention, then
     in bf16 `cli.app.AmodalDepthApp.predict_arrays` in "prompt_points"
     mode on a 600 x 800 scene with point hints (amodal_mask_from_points:
     SAM at 1024 px, 100 guided DDIM steps at 256 px, RMBG at 1024 px;
     then vitg + vitl depth at 518 px on the derived mask): one warm-up,
     three timed calls with exactly 24 + 3,200 + 64 launches each, a
     staged call timed stage by stage, peak memory, the mask (binary,
     covering the visible mask, its area) and one call under
     torch.profiler (device busy against wall).

Prints a `{"kernels": [...]}` line (the backward entries also list every
instantiation that ran, with its cases, worst error and times), the card's
name and power limit, and as
its last line `{"ok": true, "device": {...}}`. Exits non-zero without that
line when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

CSRC = "amodal_depth_anything_tpu_torch/csrc/"
JAX_KERNELS = "amodal_depth_anything_tpu/ops/flash_attention.py"
JAX_EPILOGUE = "amodal_depth_anything_tpu/ops/fused_epilogue.py"
# name -> (source, file:line of the TPU kernel it replaces)
KERNELS = {"flash_attn_fwd": (CSRC + "flash_attn_fwd.cu",
                              JAX_KERNELS + ":111"),
           "flash_attn_bwd_dq": (CSRC + "flash_attn_bwd.cu",
                                 JAX_KERNELS + ":208"),
           "flash_attn_bwd_dkv": (CSRC + "flash_attn_bwd.cu",
                                  JAX_KERNELS + ":228"),
           "fused_epilogue": (CSRC + "fused_epilogue.cu",
                              JAX_EPILOGUE + ":46")}
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, FP32 outside the
# tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-5
PROXY_TOL = 1e-4
PROXY_GRAD_TOL = 1e-4   # of each gradient's max abs: sums in another order
FULL_F32_TOL = 1e-3
TRAIN_F32_TOL = 1e-3    # loss and gradient norm, kernels vs plain attention
MIN_STD = 1e-3   # a depth map that varies: the trunks reach the output
# (shape [B, H, N, D], kv_len): vitg/vitl trunk shapes at 518 px (N = 1370)
# for batch 1 and 4, vitg at 1022 px (N = 5330), a ragged N and kv_len < N
ATTN_CASES = [((4, 24, 1370, 64), None), ((1, 24, 1370, 64), None),
              ((4, 16, 1370, 64), None), ((8, 16, 1370, 64), None),
              ((1, 24, 5330, 64), None), ((2, 16, 777, 64), None),
              ((1, 16, 1408, 64), 1370)]
MAIN_CASE = ((4, 24, 1370, 64), None, "bfloat16")   # the kernels-line shape
# (q shape, Nk): the SD-1.5 UNet at 512 px, batch 4 (8 heads over 320 / 640
# / 1280 channels): self-attention over 4096 / 1024 / 256 / 64 latent
# tokens, cross-attention onto the 77 context tokens
DEPTHFM_ATTN_CASES = [((4, 8, 4096, 40), 4096), ((4, 8, 1024, 80), 1024),
                      ((4, 8, 256, 160), 256), ((4, 8, 64, 160), 64),
                      ((4, 8, 4096, 40), 77), ((4, 8, 1024, 80), 77),
                      ((4, 8, 256, 160), 77)]
# pix2gestalt's UNet (the same body) at 256 px with both guidance halves in
# one call, batch 2: self-attention over 1024 / 256 / 64 / 16 latent tokens
# and cross-attention onto ONE context token (the CLIP embedding)
P2G_ATTN_CASES = [((2, 8, 1024, 40), 1024), ((2, 8, 256, 80), 256),
                  ((2, 8, 64, 160), 64), ((2, 8, 16, 160), 16),
                  ((2, 8, 1024, 40), 1), ((2, 8, 256, 80), 1),
                  ((2, 8, 64, 160), 1), ((2, 8, 16, 160), 1)]
UNET_ATTN_CASES = DEPTHFM_ATTN_CASES + P2G_ATTN_CASES
# the CLIP ViT-L/14 tower at 224 px: 16 heads of 64 over 257 tokens
CLIP_ATTN_CASE = ((1, 16, 257, 64), 257)
# the heuristics' rows of the kernels line: CLIP's shape and the p2g UNet's
# largest cross-attention onto one key
HEUR_MAIN_CASES = (CLIP_ATTN_CASE, ((2, 8, 1024, 40), 1))
# N = Nq = Nk on the edges of the bf16 kernel's tiles (128 query rows a
# block, 64 a warpgroup, 128 keys a tile); each also with kv_len = N - 1 and,
# where it fits, N - 70; head dims 64 and 40 (the main paths') and 24 and 8,
# so that all four instantiations of the bf16 kernel (16, 32, 48 and 64
# columns) are held against the plain version
EDGE_NS = (1, 63, 64, 65, 127, 128, 129, 255, 257)
EDGE_HEAD_DIMS = (64, 40, 24, 8)
HOST_LAUNCHES = 1000
# the DepthFM proxy's self-attention shapes (float32 only: head dim 12 is
# no multiple of the bfloat16 kernel's 8)
PROXY_ATTN_CASES = [((2, 4, 64, 12), 64), ((2, 4, 16, 24), 16),
                    ((2, 4, 4, 48), 4)]
# (M, K, N) of the fused epilogue: vitg proj and fc2, vitl proj and fc2 at
# 518 px batch 4 (M = 4 x 1370), vitl proj at batch 8, the two trunks' proj
# at 1022 px batch 8 (M = 8 x 5330), a ragged M, and M, K and N all off the
# kernel's 128 x 256 x 64 tiles
EPILOGUE_CASES = [(5480, 1536, 1536), (5480, 4096, 1536), (5480, 1024, 1024),
                  (5480, 4096, 1024), (10960, 1024, 1024),
                  (42640, 1024, 1024), (42640, 1536, 1536), (777, 128, 256),
                  (777, 136, 264), (129, 72, 8)]
EPILOGUE_MAIN_CASE = ((42640, 1536, 1536), "bfloat16")   # the chain's shape
CHAIN_BLOCKS = 4
DEPTHFM_PROXY = os.path.join("checkpoints", "proxy", "depthfm.npz")
DEPTHFM_SIZE, DEPTHFM_STEPS, DEPTHFM_BATCH, DEPTHFM_CALLS = 512, 4, 4, 3
DEPTHFM_LAUNCHES = DEPTHFM_STEPS * 32   # 16 self + 16 cross per UNet call
# the backward kernels, (q shape, Nk, kv_len): the training main path (vitl,
# batch 8, 518 px) first, then batch 1, a ragged N, vitg at 1022 px and
# kv_len < N; then the SD-1.5 UNet's self-attention at head dims 40/80/160
# and each onto the 77 context keys (DepthFM training's shapes)
BWD_CASES = [((8, 16, 1370, 64), 1370, None), ((1, 16, 1370, 64), 1370, None),
             ((2, 16, 777, 64), 777, None), ((1, 24, 5330, 64), 5330, None),
             ((1, 16, 1408, 64), 1408, 1370)] + [
                 (shape, nk, None) for shape, nk in DEPTHFM_ATTN_CASES
                 if shape[2] > 64]
BWD_MAIN_CASE = ((8, 16, 1370, 64), 1370, None, "bfloat16")
FULL_BATCH, FULL_CALLS, SIZE = 4, 3, 518
# serving (phase 9): timed calls of each eager call and replay, the replay's
# tolerance against the eager call (bf16), the HTTP load, DeepCache's point
SERVE_CALLS, REPLAY_TOL = 10, 1e-3
SERVE_REQUESTS, SERVE_CLIENTS = 16, 8
DEEP_CACHE = (2, 2)
TRAIN_CONFIG = "configs/train_discriminative_vitl.yaml"
TRAIN_BATCH, TRAIN_STEPS, TRAIN_BLOCKS = 8, 5, 24
# DepthFM training: the shipped recipes, batches of 8 synthetic scenes at
# 518 px (the recipe's max_train_batch_size and resize_to_hw; the VAE floors
# 518 to 64 x 64 latents); 16 self + 16 cross attentions per UNet call
DEPTHFM_TRAIN_CONFIG = "configs/train_depthfm_base.yaml"
DDPM_TRAIN_CONFIG = "configs/train_depthfm_ddpm_finetune.yaml"
DEPTHFM_TRAIN_STEPS, DDPM_TRAIN_STEPS, UNET_ATTN = 5, 2, 32
# heuristics (phase 10): the trained pix2gestalt proxy card vs CPU at 64 px
# (one UNet call at the proxies' bar; the 100-step completion at a bar of
# its own, set before its first run, since a loop can grow an error), then
# the full-width stack
P2G_PROXY = os.path.join("checkpoints", "proxy", "p2g.npz")
P2G_PROXY_SIZE, P2G_COMPLETION_TOL = 64, 1e-3
HEUR_CALLS, HEUR_HW = 3, (600, 800)
HEUR_STEPS = 100
HEUR_LAUNCHES = 24 + 32 * HEUR_STEPS   # CLIP's 24 blocks, 16 + 16 a step
DEPTH_LAUNCHES = 64                    # vitg 40 + vitl 24 blocks
# kernel device time and launches of the profiled DepthFM train step, and the
# share of GroupNorm's plain ops (forward var_mean / addcmul, their backward)
GROUP_NORM_OPS = ("aten::var_mean", "aten::addcmul", "VarMeanBackward",
                  "AddcmulBackward")

# a kernel's name, and its padded head dim if it is a template, in the
# mangled name ptxas reports
ENTRY_NAME = re.compile(r"((?:flash_attn|fused_epilogue)_[a-z_]*(?:bf16|f32)"
                        r"(?:_wgmma)?)(?:ILi(\d+)E)?")

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


def attention_case(gen, shape, nk, kv_len, dt_name: str, gpu: str) -> dict:
    """One forward-attention case: q `shape` [B,H,Nq,D] against k, v with
    `nk` keys of which `kv_len` are live; kernel against plain version,
    with their times, SDPA's and the roofline bound."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        mha, mha_reference)

    dtype = getattr(torch, dt_name)
    b, h, n, d = shape
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    out, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = mha_reference(q.float(), k.float(), v.float(),
                                 kv_len=kv_len, return_lse=True)
    err = (out.float() - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse
    kv = nk if kv_len is None else kv_len
    flops = 4 * b * h * n * kv * d
    nbytes = (2 * b * h * n * d + 2 * b * h * kv * d) * q.element_size()
    bound_ms, bound_by = roofline(flops, nbytes, dt_name)
    mask = None if kv_len is None else (
        torch.arange(nk, device="cuda") < kv_len)[None, None, None]
    iters = max(3, min(50, int(2e11 / flops)))
    ms = cuda_ms(lambda: mha(q, k, v, kv_len=kv_len), iters)
    plain_ms = cuda_ms(
        lambda: mha_reference(q, k, v, kv_len=kv_len), 3, warmup=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters)
    print(f"  attn {dt_name:8s} q {str(list(shape)):20s} Nk={nk} "
          f"kv_len={kv} max_abs={err:.3e} lse_abs={lse_err:.3e} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa "
          f"{lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
          f"{flops / ms / 1e9:.1f} TFLOP/s [{gpu}]", flush=True)
    check(err <= TOL[dt_name] and err == err,
          f"flash_attn_fwd {dt_name} {list(shape)} Nk={nk} kv_len={kv}: "
          f"max abs {err:.3e} <= {TOL[dt_name]}")
    check(lse_err <= LSE_TOL,
          f"flash_attn_fwd {dt_name} {list(shape)} Nk={nk} LSE max abs "
          f"{lse_err:.3e} <= {LSE_TOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def attention_edge_cases() -> None:
    """The forward kernel on the edges of its tiles, through strided views
    of one qkv buffer as the models hand them over, with and without the
    LSE, against the plain version on the same (bf16-rounded) inputs."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        mha, mha_reference)

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(n, n, kv) for n in EDGE_NS for kv in (None, n - 1, n - 70)
             if kv is None or kv >= 1] + [(4096, 77, None)]
    b, h = 2, 2
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for d in EDGE_HEAD_DIMS:
            worst, worst_lse, bad = 0.0, 0.0, []
            for nq, nk, kv_len in cases:
                qkv = torch.randn((b, nk, 3, h, d), generator=gen,
                                  device="cuda").to(dtype)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                if nq != nk:
                    q = torch.randn((b, nq, h, d), generator=gen,
                                    device="cuda").to(dtype).transpose(1, 2)
                out, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
                alone = mha(q, k, v, kv_len=kv_len)
                torch.cuda.synchronize()
                ref, ref_lse = mha_reference(q.float(), k.float(), v.float(),
                                             kv_len=kv_len, return_lse=True)
                err = max((out.float() - ref).abs().max().item(),
                          (alone.float() - ref).abs().max().item())
                lse_err = (lse - ref_lse).abs().max().item()
                if not (err <= TOL[dt_name] and lse_err <= LSE_TOL):
                    bad.append((nq, nk, kv_len, err, lse_err))
                worst, worst_lse = max(worst, err), max(worst_lse, lse_err)
            check(not bad,
                  f"flash_attn_fwd {dt_name} d={d} on {len(cases)} tile-edge "
                  f"cases (N in {list(EDGE_NS)}, kv_len N-1 and N-70, 4096 x "
                  f"77), with and without LSE: max abs {worst:.3e} <= "
                  f"{TOL[dt_name]}, LSE {worst_lse:.3e} <= {LSE_TOL}"
                  + (f"; failing (Nq, Nk, kv_len, err, lse err): {bad}"
                     if bad else ""))


def heuristics_device_ms(shape, nk: int, gpu: str) -> dict:
    """Device time of the forward kernel and of SDPA at one of the
    heuristics' launch-bound shapes (bf16), where event timing reads the
    host's launch rate instead."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha

    gen = torch.Generator(device="cuda").manual_seed(13)
    b, h, _, d = shape
    q = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    kernel = device_ms(lambda: mha(q, k, v), ["flash_attn_fwd"])[
        "flash_attn_fwd"]
    sdpa = all_device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    print(f"  device time bf16 q {list(shape)} Nk={nk}: flash_attn_fwd "
          f"{as_ms(kernel)}, SDPA {as_ms(sdpa)} [{gpu}]", flush=True)
    return {"device_ms": kernel, "library_device_ms": sdpa}


def heuristics_attention_cases() -> None:
    """The forward kernel at the heuristics' shapes with k and v made as
    pix2gestalt's UNet makes them: projections of a one-token context
    [B, 1, 768], viewed [B, H, 1, d]; and the same k, v as views whose
    token dimension (size 1) has a stride of 3 elements, which the kernels
    never step along and the wrapper must not hand to a TMA map. With and
    without the LSE, float32 and bfloat16, against the plain version; onto
    one key the output must be that key's value exactly (P = 1)."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        mha, mha_reference)

    gen = torch.Generator(device="cuda").manual_seed(10)
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        worst, worst_lse, bad, one_key = 0.0, 0.0, [], 0.0
        for (b, h, nq, d), nk in P2G_ATTN_CASES + [CLIP_ATTN_CASE]:
            q = torch.randn((b, nq, h, d), generator=gen, device="cuda").to(
                dtype).transpose(1, 2)
            ctx = torch.randn((b, nk, 768), generator=gen, device="cuda")
            w = torch.randn((768, 2 * h * d), generator=gen,
                            device="cuda") * 768 ** -0.5
            kv = (ctx @ w).to(dtype).view(b, nk, 2, h, d)
            k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
            views = [(k, v)]
            if nk == 1:
                odd = (k.stride(0), k.stride(1), 3, 1)
                views.append((k.as_strided(k.shape, odd),
                              v.as_strided(v.shape, odd)))
            for kk, vv in views:
                out, lse = mha(q, kk, vv, return_lse=True)
                alone = mha(q, kk, vv)
                torch.cuda.synchronize()
                ref, ref_lse = mha_reference(q.float(), kk.float(),
                                             vv.float(), return_lse=True)
                err = max((out.float() - ref).abs().max().item(),
                          (alone.float() - ref).abs().max().item())
                lse_err = (lse - ref_lse).abs().max().item()
                if nk == 1:
                    exact = max((o - vv.expand_as(o)).abs().max().item()
                                for o in (out, alone))
                    one_key = max(one_key, exact)
                    err = max(err, exact)
                if not (err <= TOL[dt_name] and lse_err <= LSE_TOL):
                    bad.append(((b, h, nq, d), nk, kk.stride(), err,
                                lse_err))
                worst, worst_lse = max(worst, err), max(worst_lse, lse_err)
        check(not bad and one_key == 0.0,
              f"flash_attn_fwd {dt_name} at the heuristics' shapes (p2g "
              f"self and onto 1 key at d 40/80/160, CLIP [1,16,257,64]), "
              f"k/v from a one-token context and as odd-strided views, "
              f"with and without LSE: max abs {worst:.3e} <= "
              f"{TOL[dt_name]}, LSE {worst_lse:.3e} <= {LSE_TOL}, onto one "
              f"key output - v = {one_key:.1e} (exactly 0)"
              + (f"; failing (q, Nk, k strides, err, lse err): {bad}"
                 if bad else ""))


def host_cost_phase(gpu: str) -> None:
    """What one launch of each redesigned kernel costs the host, wrapper
    and tensor-map encodes included: many launches of a tiny case, no
    synchronisation inside the loop. The float32 launch of the same
    wrapper, which encodes no tensor map, is timed beside it, so that the
    difference is what the encodes (and the shared-memory opt-in) cost."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.ops.fused_epilogue import \
        matmul_scale_residual

    def per_launch_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_LAUNCHES):
            fn()
        us = (time.perf_counter() - t) / HOST_LAUNCHES * 1e6
        torch.cuda.synchronize()
        return us

    us = {}
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn((1, 128, 3, 2, 64), device="cuda", dtype=dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        x = torch.randn((128, 64), device="cuda", dtype=dtype)
        w = torch.randn((64, 128), device="cuda", dtype=dtype)
        b, g = torch.zeros(128, device="cuda"), torch.ones(128, device="cuda")
        r = torch.zeros((128, 128), device="cuda", dtype=dtype)
        us["flash_attn_fwd", dtype] = per_launch_us(lambda: mha(q, k, v))
        us["fused_epilogue", dtype] = per_launch_us(
            lambda: matmul_scale_residual(x, w, b, g, r))
    for name, what in (("flash_attn_fwd", "[1,2,128,64], three tensor maps"),
                       ("fused_epilogue", "[128,64]x[64,128], four tensor "
                        "maps")):
        print(f"  host cost of a launch of {name} (bf16 {what}): "
              f"{us[name, torch.bfloat16]:.1f} us; float32, no tensor map: "
              f"{us[name, torch.float32]:.1f} us; over {HOST_LAUNCHES} "
              f"launches each [{gpu}]", flush=True)


def sass_check() -> None:
    """The three redesigned libraries' SASS holds wgmma and TMA-load
    opcodes."""
    import shutil

    from amodal_depth_anything_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        print("  cuobjdump not found: SASS not inspected", flush=True)
        return
    for name in ("flash_attn_fwd", "flash_attn_bwd", "fused_epilogue"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True).stdout
        counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
        check(all(counts.values()),
              f"{name}: SASS holds {counts['HGMMA']} HGMMA and "
              f"{counts['UTMALDG']} UTMALDG opcodes")


def attention_phase(gpu: str) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for shape, kv_len in ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            got = attention_case(gen, shape, shape[2], kv_len, dt_name, gpu)
            if (shape, kv_len, dt_name) == MAIN_CASE:
                main = got
    unet, heur = [], []
    for shape, nk in UNET_ATTN_CASES + [CLIP_ATTN_CASE]:
        for dt_name in ("float32", "bfloat16"):
            got = attention_case(gen, shape, nk, None, dt_name, gpu)
            if dt_name == "bfloat16":   # the main paths' dtype
                rows = unet if (shape, nk) in DEPTHFM_ATTN_CASES else heur
                rows.append({"q": list(shape), "nk": nk, **got})
    for shape, nk in PROXY_ATTN_CASES:
        attention_case(gen, shape, nk, None, "float32", gpu)
    attention_edge_cases()
    heuristics_attention_cases()
    main["depthfm_shapes"] = unet
    main["heuristics_shapes"] = heur
    for row in heur:
        if (tuple(row["q"]), row["nk"]) in HEUR_MAIN_CASES:
            row.update(heuristics_device_ms(row["q"], row["nk"], gpu))
    torch.cuda.empty_cache()
    return main


def epilogue_phase(gpu: str) -> dict:
    """The fused epilogue kernel against its plain version at the trunks'
    shapes, then its path: the four-block chain with the kernel and with
    the library chain."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.fused_epilogue import (
        matmul_scale_residual, matmul_scale_residual_reference)

    def library(x, w_t, b, g, r):
        # yardstick only: cuBLAS with the bias fused, then one addcmul
        return torch.addcmul(r, F.linear(x, w_t, b), g)

    gen = torch.Generator(device="cuda").manual_seed(3)
    main = None
    for m, k, n in EPILOGUE_CASES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 * 0.02).to(dtype)
            b = torch.randn((n,), generator=gen, device="cuda")
            g = torch.randn((n,), generator=gen, device="cuda") * 0.1
            r = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
            out = matmul_scale_residual(x, w, b, g, r)
            torch.cuda.synchronize()
            ref = matmul_scale_residual_reference(x.float(), w.float(), b, g,
                                                  r.float())
            err = (out.float() - ref).abs().max().item()
            del ref
            es = x.element_size()
            flops = 2 * m * k * n
            bound_ms, bound_by = roofline(
                flops, (m * k + k * n + 2 * m * n) * es + 8 * n, dt_name)
            iters = max(3, min(50, int(2e11 / flops)))
            w_t, b_d, g_d = w.t().contiguous(), b.to(dtype), g.to(dtype)
            ms = cuda_ms(lambda: matmul_scale_residual(x, w, b, g, r), iters)
            plain_ms = cuda_ms(lambda: matmul_scale_residual_reference(
                x, w, b, g, r), iters)
            lib_ms = cuda_ms(lambda: library(x, w_t, b_d, g_d, r), iters)
            print(f"  epilogue {dt_name:8s} [{m},{k}]x[{k},{n}] "
                  f"max_abs={err:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms library chain {lib_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) "
                  f"{flops / ms / 1e9:.1f} TFLOP/s [{gpu}]", flush=True)
            check(err <= TOL[dt_name] and err == err,
                  f"fused_epilogue {dt_name} [{m},{k}]x[{k},{n}]: max abs "
                  f"{err:.3e} <= {TOL[dt_name]}")
            if ((m, k, n), dt_name) == EPILOGUE_MAIN_CASE:
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms}
            del x, w, b, g, r, out, w_t
            torch.cuda.empty_cache()

    # the kernel's path: x <- x + gamma * (x @ W + b), four blocks at vitg
    # width, bf16, 8 x 5330 tokens
    (m, d, _), _ = EPILOGUE_MAIN_CASE
    x0 = torch.randn((m, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((d, d), generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    b = torch.zeros((d,), device="cuda")
    g = torch.full((d,), 1e-5, device="cuda")
    w_t, b_d, g_d = w.t().contiguous(), b.bfloat16(), g.bfloat16()

    def chain(fused: bool):
        x = x0
        for _ in range(CHAIN_BLOCKS):
            x = matmul_scale_residual(x, w, b, g, x) if fused \
                else library(x, w_t, b_d, g_d, x)
        return x

    matmul_scale_residual.launches = 0        # the path starts here
    fused_out = chain(True)
    torch.cuda.synchronize()
    launches = matmul_scale_residual.launches  # ... and ends here
    diff = (fused_out.float() - chain(False).float()).abs().max().item()
    check(launches == CHAIN_BLOCKS, f"the chain launched fused_epilogue "
                                    f"{launches} times ({CHAIN_BLOCKS})")
    check(bool(torch.isfinite(fused_out).all()) and diff <= TOL["bfloat16"],
          f"4-block chain, kernel vs library chain: max abs {diff:.3e} <= "
          f"{TOL['bfloat16']}")
    times = {}
    for name, fused in (("kernel/a", True), ("library/a", False),
                        ("library/b", False), ("kernel/b", True)):
        times[name] = cuda_ms(lambda: chain(fused), 10)
    print(f"  4-block chain [{m},{d}] bf16: kernel "
          f"{times['kernel/a']:.4f} / {times['kernel/b']:.4f} ms, library "
          f"chain (F.linear + addcmul) {times['library/a']:.4f} / "
          f"{times['library/b']:.4f} ms [{gpu}]", flush=True)
    main.update(launches=launches, chain_ms=times["kernel/b"],
                chain_library_ms=times["library/b"])
    return main


def roofline(flops: float, nbytes: float, dt_name: str):
    """(bound in ms, what bounds it): the larger of the operations over the
    card's peak for the type and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dt_name], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def device_ms(fn, names, calls: int = 5) -> dict:
    """Device time per call of `fn` of each kernel whose name holds one of
    `names`, from the device-side events of a torch.profiler trace (None
    where the profiler recorded none): event timing of a launch-bound
    shape reads the host's launch rate instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = {name: [] for name in names}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name + "_" in e.name:
                    found[name].append(e.time_range.elapsed_us() / 1e3)
    return {name: sum(t) / calls if t else None for name, t in found.items()}


def all_device_ms(fn, calls: int = 5) -> float | None:
    """Device time per call of `fn`, every kernel it launches summed (a
    torch.profiler trace; None where it recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(times) / calls if times else None


def as_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def attention_bwd_phase(gpu: str) -> dict:
    """The two backward kernels against `mha_bwd_reference` on the same
    inputs (the kernels' own forward output and LSE among them): the main
    paths' and the UNet's shapes, timed, then the tile-edge sweep."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        bwd_instantiations, flash_attn_bwd_dkv, flash_attn_bwd_dq, mha,
        mha_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(1)
    main, runs = {}, {}
    for shape, nk, kv_len in BWD_CASES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            b, h, n, d = shape
            kv = nk if kv_len is None else kv_len
            scale = d ** -0.5
            q, do = (torch.randn(shape, generator=gen, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            if kv_len is not None:
                do[:, :, kv_len:] = 0   # padded query rows carry no cotangent
            o, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, lse, delta)
            kw = {"sm_scale": scale, "kv_len": kv_len}
            dq = flash_attn_bwd_dq(*args, **kw)
            dk, dv = flash_attn_bwd_dkv(*args, **kw)
            torch.cuda.synchronize()
            refs = mha_bwd_reference(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), **kw)
            errs, rels = {}, {}
            for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                errs[name] = (out.float() - ref).abs().max().item()
                rels[name] = errs[name] / ref.abs().max().item()
            del refs
            what = f"{dt_name} q {list(shape)} Nk={nk} kv_len={kv}"
            for name in ("dq", "dk", "dv"):
                check(rels[name] <= TOL[dt_name],
                      f"flash_attn_bwd {name} {what}: max abs "
                      f"{errs[name]:.3e} = {rels[name]:.3e} of the "
                      f"reference's max abs <= {TOL[dt_name]}")
            if kv_len is not None:
                dead = max(dk[:, :, kv_len:].abs().max().item(),
                           dv[:, :, kv_len:].abs().max().item())
                check(dead == 0.0, f"flash_attn_bwd {dt_name} rows >= kv_len "
                                   f"of dK and dV exactly 0 (max {dead})")
            es = q.element_size()
            io = 2 * b * h * n * d + 2 * b * h * nk * d   # q, dO, k, v
            stats = 2 * b * h * n * 4                      # LSE, delta
            q_len = kv if n == nk else n
            dq_flops = 6 * b * h * n * kv * d
            dkv_flops = 8 * b * h * q_len * kv * d
            dq_bound = roofline(dq_flops, (io + b * h * n * d) * es + stats,
                                dt_name)
            dkv_bound = roofline(dkv_flops,
                                 (io + 2 * b * h * nk * d) * es + stats,
                                 dt_name)
            iters = max(3, min(30, int(1e11 / dq_flops)))
            dq_ms = cuda_ms(lambda: flash_attn_bwd_dq(*args, **kw), iters)
            dkv_ms = cuda_ms(lambda: flash_attn_bwd_dkv(*args, **kw), iters)
            dev = device_ms(lambda: (flash_attn_bwd_dq(*args, **kw),
                                     flash_attn_bwd_dkv(*args, **kw)),
                            ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
            plain_ms = cuda_ms(lambda: mha_bwd_reference(
                q, k, v, o, lse, do, **kw), 2, warmup=1)
            # yardstick only: the library's backward, as the time of its
            # forward plus backward less the time of its forward
            mask = None if kv_len is None else (
                torch.arange(nk, device="cuda") < kv_len)[None, None, None]
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]

            def sdpa_fwd_bwd():
                F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask).backward(do)
                for t in leaves:
                    t.grad = None

            lib_ms = cuda_ms(sdpa_fwd_bwd, iters) - cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask), iters)
            print(f"  attn bwd {what} rel err dq {rels['dq']:.2e} dk "
                  f"{rels['dk']:.2e} dv {rels['dv']:.2e}; dq kernel "
                  f"{dq_ms:.4f} ms (bound {dq_bound[0]:.4f} ms, "
                  f"{dq_bound[1]}, {dq_flops / dq_ms / 1e9:.1f} TFLOP/s), "
                  f"dk/dv kernel {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f} "
                  f"ms, {dkv_bound[1]}, {dkv_flops / dkv_ms / 1e9:.1f} "
                  f"TFLOP/s); device (profiler) dq "
                  f"{as_ms(dev['flash_attn_bwd_dq'])}, dk/dv "
                  f"{as_ms(dev['flash_attn_bwd_dkv'])}; plain "
                  f"dq+dk+dv {plain_ms:.4f} ms; sdpa backward (dq+dk+dv) "
                  f"{lib_ms:.4f} ms [{gpu}]", flush=True)
            for kernel, ms, dms, bound, flops, err in zip(
                    bwd_instantiations(dtype, d), (dq_ms, dkv_ms),
                    dev.values(), (dq_bound, dkv_bound),
                    (dq_flops, dkv_flops),
                    (rels["dq"], max(rels["dk"], rels["dv"]))):
                run = runs.setdefault(kernel, {"cases": 0, "max_rel_err": 0.0,
                                               "timed": []})
                run["cases"] += 1
                run["max_rel_err"] = max(run["max_rel_err"], err)
                run["timed"].append({"q": list(shape), "nk": nk, "kv_len": kv,
                                     "ms": ms, "device_ms": dms,
                                     "bound_ms": bound[0],
                                     "tflops": flops / ms / 1e9,
                                     "library_ms": lib_ms})
            if (shape, nk, kv_len, dt_name) == BWD_MAIN_CASE:
                # the plain version and the library compute all three
                # gradients in one call: both kernels carry that one time
                main["flash_attn_bwd_dq"] = {
                    "max_abs_err": errs["dq"], "ms": dq_ms,
                    "plain_ms": plain_ms, "bound_ms": dq_bound[0],
                    "bound_by": dq_bound[1], "library_ms": lib_ms}
                main["flash_attn_bwd_dkv"] = {
                    "max_abs_err": max(errs["dk"], errs["dv"]), "ms": dkv_ms,
                    "plain_ms": plain_ms, "bound_ms": dkv_bound[0],
                    "bound_by": dkv_bound[1], "library_ms": lib_ms}
            del q, k, v, do, o, lse, delta, dq, dk, dv, args, leaves
            torch.cuda.empty_cache()
    attention_bwd_edge_cases(runs)
    autograd_check()
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        main[name]["instantiations"] = [
            {"name": kernel, **run} for kernel, run in sorted(runs.items())
            if kernel.startswith(name + "_")]
    return main


def attention_bwd_edge_cases(runs: dict) -> None:
    """Both backward kernels on the edges of their tiles (128 resident rows
    a block, 64 a warpgroup, 64-row streamed tiles), through strided views
    of one qkv buffer as the models hand them over, against
    `mha_bwd_reference`. The error is relative to the largest of the three
    reference gradients' max abs: at N = 1, dQ and dK are zero up to
    rounding (P = 1, dP = delta), so a ratio to their own max abs would
    measure only that rounding."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        bwd_instantiations, flash_attn_bwd_dkv, flash_attn_bwd_dq, mha,
        mha_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(n, n, kv) for n in EDGE_NS for kv in (None, n - 1, n - 70)
             if kv is None or kv >= 1] + [(4096, 77, None)]
    b, h = 2, 2
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for d in EDGE_HEAD_DIMS:
            worst, bad, dead = 0.0, [], 0.0
            for nq, nk, kv_len in cases:
                qkv = torch.randn((b, nk, 3, h, d), generator=gen,
                                  device="cuda").to(dtype)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                if nq != nk:
                    q = torch.randn((b, nq, h, d), generator=gen,
                                    device="cuda").to(dtype).transpose(1, 2)
                do = torch.randn((b, nq, h, d), generator=gen,
                                 device="cuda").to(dtype).transpose(1, 2)
                if kv_len is not None:
                    do[:, :, kv_len:] = 0
                o, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
                delta = (do.float() * o.float()).sum(-1)
                args = (q, k, v, do, lse, delta)
                kw = {"sm_scale": d ** -0.5, "kv_len": kv_len}
                outs = (flash_attn_bwd_dq(*args, **kw),
                        *flash_attn_bwd_dkv(*args, **kw))
                torch.cuda.synchronize()
                refs = mha_bwd_reference(q.float(), k.float(), v.float(),
                                         o.float(), lse, do.float(), **kw)
                top = max(r.abs().max().item() for r in refs)
                err = max((a.float() - r).abs().max().item()
                          for a, r in zip(outs, refs)) / top
                if kv_len is not None:
                    dead = max(dead, outs[1][:, :, kv_len:].abs().max().item(),
                               outs[2][:, :, kv_len:].abs().max().item())
                if not err <= TOL[dt_name]:
                    bad.append((nq, nk, kv_len, err))
                worst = max(worst, err)
            for kernel in bwd_instantiations(dtype, d):
                run = runs.setdefault(kernel, {"cases": 0, "max_rel_err": 0.0,
                                               "timed": []})
                run["cases"] += len(cases)
                run["max_rel_err"] = max(run["max_rel_err"], worst)
            check(not bad and dead == 0.0,
                  f"flash_attn_bwd {dt_name} d={d} on {len(cases)} tile-edge "
                  f"cases (N in {list(EDGE_NS)}, kv_len N-1 and N-70, 4096 x "
                  f"77): max abs {worst:.3e} of the largest reference "
                  f"gradient <= {TOL[dt_name]}; rows >= kv_len of dK and dV "
                  f"exactly 0 (max {dead})"
                  + (f"; failing (Nq, Nk, kv_len, err): {bad}" if bad else ""))


def autograd_check() -> None:
    """`mha` on CUDA tensors that need gradients returns them from the two
    backward kernels, on the strided views the model hands over."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        mha, mha_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, n, h, d = 2, 1370, 16, 64
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16).requires_grad_()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches)
    o = mha(q, k, v)
    tokens = o.transpose(1, 2).reshape(b, n, h * d)
    w = torch.randn((b, n, h * d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    (tokens * w).sum().backward()
    torch.cuda.synchronize()
    after = (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches)
    check(o.grad_fn is not None and qkv.grad is not None
          and tuple(a - c for a, c in zip(after, before)) == (1, 1, 1),
          "mha on CUDA tensors with requires_grad: a grad_fn, a gradient and "
          "one launch of each of the three kernels")
    with torch.no_grad():
        qf, kf, vf = (t.float() for t in (q, k, v))
        o2, lse = mha(q, k, v, return_lse=True)
        do = w.view(b, n, h, d).transpose(1, 2).float()
        refs = mha_bwd_reference(qf, kf, vf, o2.float(), lse, do)
        worst = max(((qkv.grad[:, :, i].transpose(1, 2).float() - ref)
                     .abs().max() / ref.abs().max()).item()
                    for i, ref in enumerate(refs))
    check(worst <= TOL["bfloat16"],
          f"autograd gradients of the qkv buffer vs mha_bwd_reference: "
          f"{worst:.3e} of the max abs <= {TOL['bfloat16']}")


def proxy_phase() -> None:
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import (
        load_params_npz, params_from_jax)
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model)
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        capture_amodal_program

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
    gpu_pipe = pipe("cuda")
    mha.launches = 0
    gpu_base, gpu_blended = gpu_pipe(img, mask)
    launches = mha.launches
    for name, a, b in (("base", gpu_base, cpu_base),
                       ("blended", gpu_blended, cpu_blended)):
        err = float(np.abs(a - b).max())
        check(np.isfinite(a).all() and err <= PROXY_TOL,
              f"proxy {name} map, card (kernel) vs CPU (plain): max abs "
              f"{err:.3e} <= {PROXY_TOL}")
    check(launches == 24, f"proxy call launched flash_attn_fwd {launches} "
                          f"times (12 + 12 blocks)")
    served = capture_amodal_program(gpu_pipe, batch=img.shape[0],
                                    hw=img.shape[1:3])
    for name, a, b in zip(("base", "blended"), served(img, mask),
                          (cpu_base, cpu_blended)):
        err = float(np.abs(a - b).max())
        check(np.isfinite(a).all() and err <= PROXY_TOL,
              f"proxy {name} map, captured replay on the card vs CPU "
              f"(plain): max abs {err:.3e} <= {PROXY_TOL}")


def depthfm_proxy_phase() -> None:
    """The trained DepthFM proxy through `DepthFMPipeline.__call__` at
    64 px: the card (kernels) against the CPU (plain), same seeded noise."""
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import \
        load_depthfm_proxy
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        capture_depthfm_program
    from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
        DepthFMPipeline

    rng = np.random.default_rng(5)
    img = (rng.random((2, 50, 70, 3)) * 255).astype(np.float32)
    mask = np.zeros((2, 50, 70), np.float32)
    mask[:, 10:40, 20:55] = 1.0
    obs = rng.random((2, 50, 70)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        pipe = DepthFMPipeline(
            load_depthfm_proxy(DEPTHFM_PROXY, device=device), size=64,
            num_steps=DEPTHFM_STEPS, dtype=torch.float32, device=device)
        mha.launches = 0
        out[device] = pipe(img, mask, obs)
    launches = mha.launches
    replay = capture_depthfm_program(pipe, batch=img.shape[0],
                                     hw=img.shape[1:3])(img, mask, obs)
    err = float(np.abs(replay - out["cpu"]).max())
    check(np.isfinite(replay).all() and err <= PROXY_TOL,
          f"DepthFM proxy depth, captured replay on the card vs CPU (plain): "
          f"max abs {err:.3e} <= {PROXY_TOL}")
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    check(out["cuda"].shape == (2, 64, 64) and np.isfinite(out["cuda"]).all()
          and out["cuda"].std() > MIN_STD and err <= PROXY_TOL,
          f"DepthFM proxy depth, card (kernel) vs CPU (plain): max abs "
          f"{err:.3e} <= {PROXY_TOL}, std {out['cuda'].std():.4f}")
    check(launches == DEPTHFM_LAUNCHES,
          f"DepthFM proxy call launched flash_attn_fwd {launches} times "
          f"({DEPTHFM_LAUNCHES} = {DEPTHFM_STEPS} steps x (16 self + 16 "
          f"cross))")


def profile_call(fn, what: str, gpu: str):
    """Where the device time of one call of `fn` goes: the device-side
    (kernel and copy) events of a torch.profiler trace, summed by name. `fn`
    must end synchronised. Returns the profile, or None when it recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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
        return None
    busy_ms = sum(ms for ms, _ in by_name.values())
    print(f"  one profiled {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall) "
          f"[{gpu}]", flush=True)
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:14]:
        print(f"    {ms:8.2f} ms {100 * ms / busy_ms:5.1f}% x{count:<5d} "
              f"{name[:100]}", flush=True)
    return prof


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
    profile_call(lambda: pipe(img, mask), "bf16 call", gpu)
    diff = float(np.abs(blended[0] - blended_k[0]).max())
    p50 = float(np.median(latencies)) * 1e3
    print(f"  full width bf16 batch {FULL_BATCH} at {SIZE} px: "
          f"{FULL_BATCH * FULL_CALLS / sum(latencies):.3f} images/s, p50 "
          f"{p50:.1f} ms per call, latencies "
          f"{[round(x * 1e3, 1) for x in latencies]} ms, peak memory "
          f"{peak:.2f} GiB; bf16 vs f32 blended max abs {diff:.3e} [{gpu}]",
          flush=True)
    return launches


def depthfm_phase(gpu: str) -> int:
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
        DepthFMPipeline

    t0 = time.time()
    pipe = DepthFMPipeline.init_random(
        0, tiny=False, size=DEPTHFM_SIZE, num_steps=DEPTHFM_STEPS,
        device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    cfg = pipe.cfg
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"  seeded DepthFMAmodal ({n_params / 1e6:.1f} M parameters) built "
          f"on the card in {time.time() - t0:.1f} s", flush=True)
    check((cfg.guide_type, cfg.model_channels, tuple(cfg.channel_mult),
           cfg.num_heads, cfg.context_len, cfg.context_dim,
           tuple(cfg.vae_channels), cfg.vae_layers) ==
          ("mask+observation", 320, (1, 2, 4, 4), 8, 77, 1024,
           (128, 256, 512, 512), 2),
          "DepthFMAmodal at the SD-1.5 widths: UNet 320 x (1,2,4,4), 8 "
          "heads, context 77 x 1024, VAE (128,256,512,512) x 2")
    rng = np.random.default_rng(6)
    img = (rng.random((DEPTHFM_BATCH, 600, 800, 3)) * 255).astype(np.float32)
    mask = np.zeros((DEPTHFM_BATCH, 600, 800), np.float32)
    mask[:, 150:450, 250:600] = 1.0
    obs = rng.random((DEPTHFM_BATCH, 600, 800)).astype(np.float32)
    shape = (DEPTHFM_SIZE, DEPTHFM_SIZE)

    mha.launches = 0
    depth_k = pipe(img[0], mask[0], obs[0])
    f32_launches = mha.launches
    pipe.attn_impl = "plain"
    depth_p = pipe(img[0], mask[0], obs[0])
    pipe.attn_impl = None
    err = float(np.abs(depth_k - depth_p).max())
    print(f"  full width f32 depth: std {depth_k.std():.4f}, kernel vs "
          f"plain attention max abs {err:.3e}", flush=True)
    check(f32_launches == DEPTHFM_LAUNCHES,
          f"f32 full-width DepthFM call launched flash_attn_fwd "
          f"{f32_launches} times ({DEPTHFM_LAUNCHES})")
    check(depth_k.shape == shape and np.isfinite(depth_k).all()
          and depth_k.std() > MIN_STD and err <= FULL_F32_TOL,
          f"full-width f32 DepthFM depth finite, {list(shape)}, not "
          f"constant, kernel vs plain max abs {err:.3e} <= {FULL_F32_TOL}")

    # the same module, cast in place to bfloat16
    pipe = DepthFMPipeline(pipe.model, size=DEPTHFM_SIZE,
                           num_steps=DEPTHFM_STEPS, device="cuda",
                           dtype=torch.bfloat16)
    pipe(img, mask, obs)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    mha.launches = 0                      # the main path starts here
    for _ in range(DEPTHFM_CALLS):
        t = time.perf_counter()
        depth = pipe(img, mask, obs)      # returns numpy: synchronised
        latencies.append(time.perf_counter() - t)
    launches = mha.launches               # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == DEPTHFM_LAUNCHES * DEPTHFM_CALLS,
          f"bf16 DepthFM main path launched flash_attn_fwd {launches} times "
          f"({DEPTHFM_LAUNCHES * DEPTHFM_CALLS} = {DEPTHFM_LAUNCHES} per "
          f"call)")
    check(depth.shape == (DEPTHFM_BATCH, *shape) and np.isfinite(depth).all()
          and depth.min() >= 0.0 and depth.max() <= 1.0
          and depth.std() > MIN_STD,
          f"bf16 DepthFM depth finite, [{DEPTHFM_BATCH},{shape[0]},"
          f"{shape[1]}], in [0,1], not constant (std {depth.std():.4f})")
    profile_call(lambda: pipe(img, mask, obs), "bf16 DepthFM call", gpu)
    diff = float(np.abs(depth[0] - depth_k).max())
    p50 = float(np.median(latencies)) * 1e3
    print(f"  DepthFM full width bf16 batch {DEPTHFM_BATCH} at "
          f"{DEPTHFM_SIZE} px, {DEPTHFM_STEPS} steps: "
          f"{DEPTHFM_BATCH * DEPTHFM_CALLS / sum(latencies):.3f} images/s, "
          f"p50 {p50:.1f} ms per call, latencies "
          f"{[round(x * 1e3, 1) for x in latencies]} ms, peak memory "
          f"{peak:.2f} GiB; bf16 vs f32 depth max abs {diff:.3e} [{gpu}]",
          flush=True)
    return launches


class SceneDataset:
    """Synthetic amodal scenes held in memory, with every key the port's
    `SAMAmodalDataset` yields (same shapes, dtypes and quantisation: 8-bit
    images, 16-bit depths), rendered by `data/synthetic.py::_render_scene`
    from a seed. Stands in for the dataset on disk, whose decoding needs
    PIL."""

    disp_name = "synthetic_scenes"

    def __init__(self, n: int, hw: int, seed: int):
        from amodal_depth_anything_tpu_torch.data.synthetic import \
            _render_scene

        rng = np.random.default_rng(seed)
        self.samples = []
        while len(self.samples) < n:
            (rgb, whole, scene_depth, amodal_depth, whole_mask, visible,
             frac) = _render_scene(rng, hw)
            if not (0.05 < frac < 0.95 and visible.sum() > 4):
                continue   # the target must be partially occluded

            def image(x):
                x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
                return x.astype(np.float32)

            def depth(x):
                x = (x * 65535).astype(np.uint16).astype(np.float32)
                return (x / 65535.0)[..., None]

            def mask(x):
                return x.astype(np.float32)[..., None]

            i = len(self.samples)
            ones = np.ones((hw, hw, 1), bool)
            self.samples.append({
                "rgb_int": image(rgb),
                "rgb_norm": image(rgb) / 255.0 * 2.0 - 1.0,
                "guide_rgb_int": image(whole),
                "guide_rgb_norm": image(whole) / 255.0 * 2.0 - 1.0,
                "guide": mask(whole_mask), "visible_mask": mask(visible),
                "depth_observation": depth(scene_depth),
                "depth_gt": depth(amodal_depth),
                "valid_mask_raw": ones, "valid_mask_filled": ones.copy(),
                "invisible_mask": mask(whole_mask & ~visible),
                "index": i, "rgb_relative_path": f"occlusion/{i:04d}.png"})

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        return self.samples[index]


def proxy_grad_phase() -> None:
    """One train step's loss and gradients on the trained amodal proxy:
    the card (kernels, forward and backward) against the CPU (plain)."""
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import (
        load_params_npz, params_from_jax)
    from amodal_depth_anything_tpu_torch.data import collate
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model)
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.train import (DiscriminativeTrainer,
                                                       TrainerConfig)

    cfg = DAV2Config(encoder="vitp")
    params = params_from_jax(load_params_npz(
        os.path.join("checkpoints", "proxy", "amodal.npz")), cfg)
    scenes = SceneDataset(2, 112, seed=3)
    batch = collate([scenes[0], scenes[1]])
    tcfg = TrainerConfig(compute_dtype="float32", remat="attn")
    out = {}
    for device in ("cpu", "cuda"):
        trainer = DiscriminativeTrainer(tcfg, build_model(cfg), None,
                                        device=device, params=params)
        mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
        loss, grads = trainer.loss_and_grads(trainer._device_batch(batch))
        out[device] = (loss.item(), {k: g.cpu() for k, g in grads.items()})
    launches = (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches)
    check(launches == (12, 12, 12), f"proxy train step on the card launched "
                                    f"fwd, dq, dkv {launches} times (12 each)")
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = out["cpu"], out["cuda"]
    check(np.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <=
          PROXY_GRAD_TOL * abs(cpu_loss),
          f"proxy train loss, card {gpu_loss:.6f} vs CPU {cpu_loss:.6f}")
    worst, worst_name, live = 0.0, "", 0
    for name, ref in cpu_grads.items():
        scale = ref.abs().max().item()
        err = (gpu_grads[name] - ref).abs().max().item()
        if scale == 0.0:
            rel = 0.0 if err == 0.0 else float("inf")
        else:
            rel, live = err / scale, live + 1
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= PROXY_GRAD_TOL and live >= len(cpu_grads) - 5,
          f"proxy gradients, card (kernels) vs CPU (plain), {live} of "
          f"{len(cpu_grads)} non-zero: worst {worst:.3e} of its max abs "
          f"({worst_name}) <= {PROXY_GRAD_TOL}")


def depthfm_proxy_grad_phase() -> None:
    """One `DepthFMAmodalTrainer` step's loss and UNet gradients on the
    trained DepthFM proxy, float32 (TF32 off): the card (kernels, forward
    and backward, at head dims 12/24/48) against the CPU (plain), with the
    CPU trainer's draws on both sides. 128 px, so that the deepest level
    attends over 2 x 2 latents (at the proxy's 64 px it is one token, and
    the gradients of its queries and keys are zero up to rounding); the
    proxy's empty-text embedding, all zeros (frozen while it was trained),
    is replaced by a seeded normal draw, or every key of the cross-attention
    is the same and the gradients of its queries are zero up to rounding
    too."""
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import \
        load_depthfm_proxy
    from amodal_depth_anything_tpu_torch.data import collate
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.train import (DepthFMAmodalTrainer,
                                                       TrainerConfig)

    scenes = SceneDataset(2, 128, seed=8)
    batch = collate([scenes[0], scenes[1]])
    tcfg = TrainerConfig(compute_dtype="float32", loss_name="l1_loss",
                         loss_kwargs={}, remat="attn")
    params = load_depthfm_proxy(DEPTHFM_PROXY, device="cpu").state_dict()
    params["empty_text_embed"] = torch.randn(
        params["empty_text_embed"].shape,
        generator=torch.Generator().manual_seed(0))
    cpu, gpu = (DepthFMAmodalTrainer(
        tcfg, load_depthfm_proxy(DEPTHFM_PROXY, device=device), None,
        device=device, params=params) for device in ("cpu", "cuda"))
    gpu._draws = lambda specs, step=None: {
        k: v.cuda() for k, v in cpu._draws(specs, step=step).items()}
    out = {}
    for device, trainer in (("cpu", cpu), ("cuda", gpu)):
        mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
        loss, grads = trainer.loss_and_grads(trainer._device_batch(batch))
        out[device] = (loss.item(), {k: g.cpu() for k, g in grads.items()})
    launches = (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches)
    check(launches == (UNET_ATTN,) * 3,
          f"DepthFM proxy train step on the card launched fwd, dq, dkv "
          f"{launches} times ({UNET_ATTN} each: 16 self + 16 cross)")
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = out["cpu"], out["cuda"]
    check(np.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <=
          PROXY_GRAD_TOL * abs(cpu_loss),
          f"DepthFM proxy train loss, card {gpu_loss:.6f} vs CPU "
          f"{cpu_loss:.6f}")
    worst, worst_name, live = 0.0, "", 0
    for name, ref in cpu_grads.items():
        scale = ref.abs().max().item()
        err = (gpu_grads[name] - ref).abs().max().item()
        rel = err / scale if scale else (0.0 if err == 0.0 else float("inf"))
        live += scale > 0
        if rel > worst:
            worst, worst_name = rel, name
    check(all(k.startswith("unet.") for k in cpu_grads)
          and worst <= PROXY_GRAD_TOL and live == len(cpu_grads),
          f"DepthFM proxy UNet gradients, card (kernels) vs CPU (plain), "
          f"{live} of {len(cpu_grads)} non-zero: worst {worst:.3e} of its "
          f"max abs ({worst_name}) <= {PROXY_GRAD_TOL}")


def train_phase(gpu: str) -> dict:
    import torch

    from amodal_depth_anything_tpu_torch.cli.train import \
        trainer_config_from_cfg
    from amodal_depth_anything_tpu_torch.data import DataLoader
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.train import get_trainer_cls
    from amodal_depth_anything_tpu_torch.train.state import global_norm
    from amodal_depth_anything_tpu_torch.utils.config import \
        recursive_load_config
    from amodal_depth_anything_tpu_torch.utils.profiling import StepTimer

    cfg = recursive_load_config(TRAIN_CONFIG)
    # one card and batches of 8: no accumulation (the recipe's effective
    # batch of 32 is four cards of 8). No warm-up, so that no step has a
    # learning rate of 0; no periodic validation, saving or visualisation
    tcfg = dataclasses.replace(
        trainer_config_from_cfg(cfg, accumulation_steps=1),
        lr_warmup_steps=0, max_iter=TRAIN_STEPS, log_interval=1,
        validation_period=0, save_period=0, visualization_period=0)
    check((tcfg.compute_dtype, tcfg.remat, tcfg.optimizer, tcfg.max_grad_norm,
           tcfg.loss_name, tcfg.loss_strategy, tcfg.lr) ==
          ("bfloat16", "attn", "adam", 0.01, "silog_loss",
           "entire_target_object", 3e-5),
          f"recipe {TRAIN_CONFIG}: bfloat16, remat attn, adam, clip 0.01, "
          f"silog_loss on entire_target_object, lr 3e-5")

    t0 = time.time()
    scenes = SceneDataset(2 * TRAIN_BATCH, SIZE, seed=4)
    train_loader = DataLoader(scenes, batch_size=TRAIN_BATCH, shuffle=True,
                              drop_last=True, seed=0)
    val_loader = DataLoader(scenes, batch_size=TRAIN_BATCH, pad_last=True)
    model = get_model(cfg.model.name, device="cuda",
                      **cfg.model.kwargs.to_dict())
    trainer = get_trainer_cls(cfg.trainer.name)(
        tcfg, model, train_loader, [val_loader], device="cuda", seed=0)
    n_params = sum(p.numel() for p in trainer.state.params.values())
    torch.cuda.synchronize()
    print(f"  {len(scenes)} scenes at {SIZE} px rendered and seeded vitl "
          f"AmodalDAv2 ({n_params / 1e6:.1f} M parameters, "
          f"{model.cfg.vit.depth} blocks, width {model.cfg.vit.embed_dim}) "
          f"built on the card in {time.time() - t0:.1f} s", flush=True)
    check(model.cfg.vit.depth == TRAIN_BLOCKS, "vitl at full depth")

    watched = ("encoder.pretrained.cls_token",
               "encoder.pretrained.blocks.11.attn.qkv.weight",
               "encoder.depth_head.scratch.output_conv1.weight")
    before = {k: trainer.state.params[k].detach().clone() for k in watched}
    losses = []
    step = trainer._train_step

    def recording_step(batch):
        loss = step(batch)
        losses.append(float(loss))
        return loss

    trainer._train_step = recording_step
    trainer.step_timer = StepTimer(warmup=1)   # the first step loads cuDNN
    torch.cuda.reset_peak_memory_stats()
    mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
    trainer.train()                            # the main path
    launches = {"flash_attn_fwd": mha.launches,
                "flash_attn_bwd_dq": mha.bwd_dq_launches,
                "flash_attn_bwd_dkv": mha.bwd_dkv_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer._train_step = step
    check(trainer.effective_iter == TRAIN_STEPS and
          len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all())
          and min(losses) > 0,
          f"{TRAIN_STEPS} train steps, losses finite and positive: "
          f"{[round(x, 5) for x in losses]}")
    for name, count in launches.items():
        check(count == TRAIN_BLOCKS * TRAIN_STEPS,
              f"training launched {name} {count} times "
              f"({TRAIN_BLOCKS} per step under remat='attn')")
    for k, old in before.items():
        new = trainer.state.params[k]
        check(bool(torch.isfinite(new).all()) and not torch.equal(new, old),
              f"parameter {k} finite and moved (max abs change "
              f"{(new - old).abs().max().item():.3e})")
    timing = trainer.step_timer.summary()
    print(f"  training vitl AmodalDAv2 bf16 batch {TRAIN_BATCH} at {SIZE} px, "
          f"remat='attn': {timing['steps_per_sec']:.4f} steps/s "
          f"({TRAIN_BATCH * timing['steps_per_sec']:.3f} images/s), p50 "
          f"{timing['p50_s'] * 1e3:.1f} ms per step over {timing['steps']} "
          f"steps {[round(x * 1e3, 1) for x in trainer.step_timer.durations]} "
          f"ms, peak memory {peak:.2f} GiB [{gpu}]", flush=True)

    # the remat modes on the card, forward + backward without the update:
    # launches of the forward kernel per step, time and peak memory
    batch8 = trainer._device_batch(next(iter(val_loader)))
    for remat, want in ((False, 1), (True, 2), ("attn", 1)):
        trainer.cfg.remat = remat
        torch.cuda.reset_peak_memory_stats()
        mha.launches = 0
        ms = cuda_ms(lambda: trainer.loss_and_grads(batch8), 2, warmup=1)
        check(mha.launches == 3 * want * TRAIN_BLOCKS,
              f"remat={remat!r}: {mha.launches // 3} forward launches per "
              f"step ({want * TRAIN_BLOCKS})")
        print(f"  remat={remat!r}: forward + backward {ms:.1f} ms, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              f"GiB [{gpu}]", flush=True)
    profile_call(lambda: float(trainer._train_step(batch8)),
                 "bf16 train step", gpu)

    results = trainer.validate()
    banks = results[scenes.disp_name]
    values = [banks[bank][m] for bank in ("overall", "align_overall")
              for m in tcfg.eval_metrics]
    check(len(values) == 20 and bool(np.isfinite(values).all()),
          f"validate() over 2 batches of {TRAIN_BATCH}: 10 metrics x "
          f"(raw, aligned) finite; abs_rel raw "
          f"{banks['overall']['abs_relative_difference']:.4f}, aligned "
          f"{banks['align_overall']['abs_relative_difference']:.4f} (the "
          f"scenes' objects are flat, so the alignment alone recovers the "
          f"hidden part)")

    # one float32 step at batch 1: the kernels against plain attention
    del batch8
    cfg32 = dataclasses.replace(tcfg, compute_dtype="float32")
    t32 = get_trainer_cls(cfg.trainer.name)(
        cfg32, model, None, device="cuda", params=model.state_dict())
    batch1 = {k: v[:1] for k, v in next(iter(val_loader)).items()
              if isinstance(v, np.ndarray)}
    batch1 = t32._device_batch(batch1)
    got = {}
    for impl in (None, "plain"):
        t32.cfg.attn_impl = impl
        loss, grads = t32.loss_and_grads(batch1)
        got[impl] = (loss.item(), global_norm(list(grads.values())).item())
        del grads
    (k_loss, k_norm), (p_loss, p_norm) = got[None], got["plain"]
    check(abs(k_loss - p_loss) <= TRAIN_F32_TOL * abs(p_loss) and
          abs(k_norm - p_norm) <= TRAIN_F32_TOL * p_norm and p_norm > 0,
          f"f32 step at batch 1, kernels vs plain attention: loss "
          f"{k_loss:.6f} vs {p_loss:.6f}, gradient norm {k_norm:.6e} vs "
          f"{p_norm:.6e} (within {TRAIN_F32_TOL} relative)")
    return launches


def step_breakdown(prof) -> None:
    """From one profiled train step: the device time and launches of each
    attention kernel instantiation, and the device time under GroupNorm's
    plain ops (the forward's var_mean and addcmul, the autograd nodes of
    their backward; the casts around them are not told apart from others)."""
    import torch

    attn: dict[str, list] = {}
    busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            if "flash_attn" in e.name:
                acc = attn.setdefault(e.name, [0.0, 0])
                acc[0] += ms
                acc[1] += 1
    for name, (ms, count) in sorted(attn.items()):
        print(f"    attention {ms:8.3f} ms x{count:<3d} {name[:100]}",
              flush=True)
    gn_us = 0.0
    for avg in prof.key_averages():
        key = avg.key
        if key in GROUP_NORM_OPS[:2] or (
                key.startswith("autograd::engine::evaluate_function:")
                and any(op in key for op in GROUP_NORM_OPS[2:])):
            gn_us += getattr(avg, "device_time_total",
                             getattr(avg, "cuda_time_total", 0.0))
    attn_ms = sum(ms for ms, _ in attn.values())
    print(f"    attention kernels {attn_ms:.2f} ms "
          f"({100 * attn_ms / busy:.1f}% of device busy); GroupNorm's plain "
          f"ops {gn_us / 1e3:.2f} ms ({100 * gn_us / 1e3 / busy:.1f}%)",
          flush=True)


def depthfm_train_phase(gpu: str) -> dict:
    """DepthFM training at the SD-1.5 widths under the shipped recipes, fed
    synthetic scenes at 518 px from memory: DepthFMAmodalTrainer (five
    steps through `train()`, remat, a float32 step against plain attention,
    `validate()`), then DepthFMTrainer (two steps, `validate()`)."""
    import torch

    from amodal_depth_anything_tpu_torch.cli.train import (
        trainer_config_from_cfg, trainer_kwargs_from_cfg)
    from amodal_depth_anything_tpu_torch.data import DataLoader
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.train import get_trainer_cls
    from amodal_depth_anything_tpu_torch.train.state import global_norm
    from amodal_depth_anything_tpu_torch.utils.config import \
        recursive_load_config
    from amodal_depth_anything_tpu_torch.utils.profiling import StepTimer

    def counts():
        return (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches)

    def zero_counts():
        mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0

    def build(path, steps, loader, val_loader):
        cfg = recursive_load_config(path)
        # one card and batches of 8: no accumulation; no warm-up, so that
        # no step has a learning rate of 0; no periodic callbacks
        tcfg = dataclasses.replace(
            trainer_config_from_cfg(cfg, accumulation_steps=1),
            lr_warmup_steps=0, max_iter=steps, log_interval=1,
            validation_period=0, save_period=0, visualization_period=0)
        model = get_model(cfg.model.name, device="cuda",
                          **cfg.model.kwargs.to_dict())
        trainer = get_trainer_cls(cfg.trainer.name)(
            tcfg, model, loader, [val_loader], device="cuda", seed=0,
            **trainer_kwargs_from_cfg(cfg))
        trainer.step_timer = StepTimer(warmup=1)   # the first loads cuDNN
        return cfg, tcfg, trainer

    def run(trainer):
        """`trainer.train()`, the main path: its losses, launches, peak."""
        losses, step = [], trainer._train_step

        def recording_step(batch):
            loss = step(batch)
            losses.append(float(loss))
            return loss

        trainer._train_step = recording_step
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                     # the main path starts here
        trainer.train()
        launches = counts()               # ... and ends here
        del trainer._train_step           # no trainer <-> closure cycle
        return losses, launches, torch.cuda.max_memory_allocated() / 2 ** 30

    t0 = time.time()
    scenes = SceneDataset(TRAIN_BATCH, SIZE, seed=9)
    loader = DataLoader(scenes, batch_size=TRAIN_BATCH, shuffle=True,
                        drop_last=True, seed=0)
    val_loader = DataLoader(scenes, batch_size=TRAIN_BATCH, pad_last=True)
    cfg, tcfg, trainer = build(DEPTHFM_TRAIN_CONFIG, DEPTHFM_TRAIN_STEPS,
                               loader, val_loader)
    mcfg = trainer.model.cfg
    n_unet = sum(p.numel() for p in trainer.state.params.values())
    torch.cuda.synchronize()
    print(f"  {len(scenes)} scenes at {SIZE} px rendered and seeded "
          f"DepthFMAmodal (UNet {n_unet / 1e6:.1f} M trained parameters) "
          f"built on the card in {time.time() - t0:.1f} s", flush=True)
    check((tcfg.compute_dtype, tcfg.remat, tcfg.optimizer, tcfg.max_grad_norm,
           tcfg.loss_name, tcfg.loss_kwargs, tcfg.loss_strategy, tcfg.lr,
           type(trainer).__name__) ==
          ("bfloat16", "attn", "adam", 0.01, "l1_loss", {},
           "entire_target_object", 3e-5, "DepthFMAmodalTrainer"),
          f"recipe {DEPTHFM_TRAIN_CONFIG}: DepthFMAmodalTrainer, bfloat16, "
          f"remat attn (no UNet recompute), adam, clip 0.01, l1_loss on "
          f"entire_target_object, lr 3e-5")
    check((mcfg.guide_type, mcfg.model_channels, tuple(mcfg.channel_mult),
           mcfg.num_heads, mcfg.context_len, mcfg.context_dim,
           tuple(mcfg.vae_channels), mcfg.vae_layers) ==
          ("mask+observation", 320, (1, 2, 4, 4), 8, 77, 1024,
           (128, 256, 512, 512), 2),
          "DepthFMAmodal at the SD-1.5 widths: UNet 320 x (1,2,4,4), 8 "
          "heads, context 77 x 1024, VAE (128,256,512,512) x 2")
    unet = {k: trainer.state.params[k].detach().clone() for k in (
        "unet.input_blocks.1.0.in_layers.2.weight",
        "unet.middle_block.1.transformer_blocks.0.attn1.to_q.weight",
        "unet.out.2.weight")}
    frozen = {k: p.detach().clone() for k, p in
              trainer.model.named_parameters() if not p.requires_grad}

    losses, launches, peak = run(trainer)
    check(trainer.effective_iter == DEPTHFM_TRAIN_STEPS
          and len(losses) == DEPTHFM_TRAIN_STEPS
          and bool(np.isfinite(losses).all()) and min(losses) > 0,
          f"{DEPTHFM_TRAIN_STEPS} DepthFMAmodal train steps, losses finite "
          f"and positive: {[round(x, 5) for x in losses]}")
    check(launches == (UNET_ATTN * DEPTHFM_TRAIN_STEPS,) * 3,
          f"DepthFM training launched fwd, dq, dkv {launches} times "
          f"({UNET_ATTN} each per step: 16 self + 16 cross)")
    for k, old in unet.items():
        new = trainer.state.params[k]
        check(bool(torch.isfinite(new).all()) and not torch.equal(new, old),
              f"UNet parameter {k} finite and moved (max abs change "
              f"{(new - old).abs().max().item():.3e})")
    check(len(frozen) > 0 and all(torch.equal(p, frozen[k]) for k, p in
                                  trainer.model.named_parameters()
                                  if k in frozen),
          f"the {len(frozen)} frozen VAE and text-embedding parameters "
          f"bit-identical after {DEPTHFM_TRAIN_STEPS} steps")
    del frozen
    timing = trainer.step_timer.summary()
    print(f"  DepthFM training bf16 batch {TRAIN_BATCH} at {SIZE} px "
          f"({SIZE // 8} x {SIZE // 8} latents), remat='attn': "
          f"{timing['steps_per_sec']:.4f} steps/s "
          f"({TRAIN_BATCH * timing['steps_per_sec']:.3f} images/s), p50 "
          f"{timing['p50_s'] * 1e3:.1f} ms per step over {timing['steps']} "
          f"steps {[round(x * 1e3, 1) for x in trainer.step_timer.durations]} "
          f"ms, peak memory {peak:.2f} GiB [{gpu}]", flush=True)

    # UNet recompute on the card, forward + backward without the update:
    # forward launches per step, time and peak memory beside the default's
    batch8 = trainer._device_batch(next(iter(val_loader)))
    for remat, want in ((True, 2), ("attn", 1)):   # ends at the recipe's
        trainer.cfg.remat = remat
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        ms = cuda_ms(lambda: trainer.loss_and_grads(batch8), 1, warmup=0)
        got = counts()
        check(got == (want * UNET_ATTN, UNET_ATTN, UNET_ATTN),
              f"DepthFM remat={remat!r}: fwd, dq, dkv launches {got} per step "
              f"({want * UNET_ATTN}, {UNET_ATTN}, {UNET_ATTN})")
        print(f"  DepthFM remat={remat!r}: forward + backward {ms:.1f} ms, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              f"GiB [{gpu}]", flush=True)
    prof = profile_call(lambda: float(trainer._train_step(batch8)),
                        "bf16 DepthFM train step", gpu)
    if prof is not None:
        step_breakdown(prof)
    del batch8, prof

    results = trainer.validate()
    bank = results[scenes.disp_name]
    values = [bank[b][m] for b in ("overall", "align_overall")
              for m in tcfg.eval_metrics]
    check(len(values) == 20 and bool(np.isfinite(values).all()),
          f"DepthFMAmodal validate() over 1 batch of {TRAIN_BATCH} (4 Euler "
          f"steps): 10 metrics x (raw, aligned) finite; abs_rel raw "
          f"{bank['overall']['abs_relative_difference']:.4f}, aligned "
          f"{bank['align_overall']['abs_relative_difference']:.4f}")

    # one float32 step at batch 1: the kernels against plain attention
    model, cls = trainer.model, type(trainer)
    del trainer                       # its optimizer state
    torch.cuda.empty_cache()
    t32 = cls(dataclasses.replace(tcfg, compute_dtype="float32"), model, None,
              device="cuda", params=model.state_dict())
    batch1 = t32._device_batch({k: v[:1] for k, v in
                                next(iter(val_loader)).items()
                                if isinstance(v, np.ndarray)})
    got = {}
    for impl in (None, "plain"):
        t32.cfg.attn_impl = impl
        loss, grads = t32.loss_and_grads(batch1)
        got[impl] = (loss.item(), global_norm(list(grads.values())).item())
        del grads
    (k_loss, k_norm), (p_loss, p_norm) = got[None], got["plain"]
    check(abs(k_loss - p_loss) <= TRAIN_F32_TOL * abs(p_loss) and
          abs(k_norm - p_norm) <= TRAIN_F32_TOL * p_norm and p_norm > 0,
          f"DepthFM f32 step at batch 1, kernels vs plain attention: loss "
          f"{k_loss:.6f} vs {p_loss:.6f}, UNet gradient norm {k_norm:.6e} vs "
          f"{p_norm:.6e} (within {TRAIN_F32_TOL} relative)")
    del t32, model, batch1
    torch.cuda.empty_cache()

    # the DDPM finetune (v-prediction, annealed multi-resolution noise) on
    # the plain DepthFM at the same widths
    cfg, tcfg, trainer = build(DDPM_TRAIN_CONFIG, DDPM_TRAIN_STEPS, loader,
                               val_loader)
    check((type(trainer).__name__, trainer.model.cfg.guide_type,
           trainer.prediction_type, trainer.multi_res_noise, tcfg.loss_name)
          == ("DepthFMTrainer", "none", "v_prediction",
              {"strength": 0.9, "annealed": True,
               "downscale_strategy": "original"}, "mse_loss"),
          f"recipe {DDPM_TRAIN_CONFIG}: DepthFMTrainer on DepthFM (guide "
          f"none), v-prediction, annealed multi-resolution noise, mse_loss")
    ddpm_losses, ddpm_launches, ddpm_peak = run(trainer)
    check(len(ddpm_losses) == DDPM_TRAIN_STEPS
          and bool(np.isfinite(ddpm_losses).all()) and min(ddpm_losses) > 0
          and ddpm_launches == (UNET_ATTN * DDPM_TRAIN_STEPS,) * 3,
          f"{DDPM_TRAIN_STEPS} DDPM train steps: losses "
          f"{[round(x, 5) for x in ddpm_losses]} finite and positive, fwd, "
          f"dq, dkv launches {ddpm_launches} ({UNET_ATTN} each per step); "
          f"peak memory {ddpm_peak:.2f} GiB [{gpu}]")
    results = trainer.validate()
    bank = results[scenes.disp_name]
    values = [bank[b][m] for b in ("overall", "align_overall")
              for m in tcfg.eval_metrics]
    check(len(values) == 20 and bool(np.isfinite(values).all()),
          f"DepthFMTrainer validate() over 1 batch of {TRAIN_BATCH} (DDIM, 4 "
          f"steps): 10 metrics x (raw, aligned) finite; abs_rel aligned "
          f"{bank['align_overall']['abs_relative_difference']:.4f}")
    return {"flash_attn_fwd": launches[0], "flash_attn_bwd_dq": launches[1],
            "flash_attn_bwd_dkv": launches[2], "ddpm": ddpm_launches}


def trace_call(fn, names=("flash_attn_fwd",)):
    """One call of `fn` (which must end synchronised) under torch.profiler:
    (wall ms, device-busy ms, {name: launches}) with device busy the sum of
    every kernel and copy event (None when the profiler recorded no device
    time) and the launches those of each kernel whose name holds `name`;
    the kernel nodes of a replayed CUDA graph count as launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy, seen, counts = 0.0, False, {name: 0 for name in names}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            seen = True
            busy += e.time_range.elapsed_us() / 1e3
            for name in names:
                counts[name] += name + "_" in e.name
    return wall_ms, busy if seen else None, counts


def eager_against_replay(what: str, eager, replay, batch: int,
                         launches: int, gpu: str) -> dict:
    """A captured handle against the eager call on the same host arrays:
    the max abs of every output (<= REPLAY_TOL), then for each of the two
    images/s and p50 over SERVE_CALLS calls, peak allocated memory, and
    device busy against the wall of one profiled call, whose trace must
    show `launches` forward-kernel launches for the replay. `eager` and
    `replay` return tuples of numpy arrays."""
    import torch

    out_e, out_r = eager(), replay()
    err = max(float(np.abs(a - b).max()) for a, b in zip(out_e, out_r))
    check(all(np.isfinite(b).all() and b.std() > MIN_STD for b in out_r)
          and err <= REPLAY_TOL,
          f"{what}: replay vs eager max abs {err:.3e} <= {REPLAY_TOL}, "
          f"finite, not constant")
    rows = {"max_abs": err}
    for label, fn in (("eager", eager), ("replay", replay)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(SERVE_CALLS):
            t = time.perf_counter()
            fn()                              # returns numpy: synchronised
            lat.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, counts = trace_call(fn)
        row = {"images_per_s": batch * SERVE_CALLS / sum(lat),
               "p50_ms": float(np.median(lat)) * 1e3, "peak_gib": peak,
               "wall_ms": wall, "busy_ms": busy,
               "launches": counts["flash_attn_fwd"]}
        rows[label] = row
        share = "not measured" if busy is None else \
            f"{busy:.1f} ms ({100 * busy / wall:.1f}% of the wall)"
        print(f"  {what} {label}: {row['images_per_s']:.3f} images/s, p50 "
              f"{row['p50_ms']:.1f} ms, latencies "
              f"{[round(x * 1e3, 1) for x in lat]} ms, peak allocated "
              f"{peak:.2f} GiB; one profiled call: wall {wall:.1f} ms, "
              f"device busy {share}, {row['launches']} flash_attn_fwd "
              f"launches [{gpu}]", flush=True)
    check(rows["replay"]["launches"] == launches,
          f"{what}: a profiled replay holds {rows['replay']['launches']} "
          f"flash_attn_fwd launches ({launches})")
    return rows


def capture(make, what: str):
    """Capture with `make()`; prints the seconds, the forward-kernel count
    of the warm-up and the capture, and the device memory the handle holds
    beyond what was held before (static buffers and the graph pool)."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    counted, t0 = mha.launches, time.time()
    served = make()
    seconds = time.time() - t0
    torch.cuda.empty_cache()
    pool = (torch.cuda.memory_reserved() - held) / 2 ** 30
    print(f"  {what} captured at batches {served.batches}, hw {served.hw} "
          f"in {seconds:.1f} s ({mha.launches - counted} flash_attn_fwd "
          f"launches counted over the warm-up and the capture); static "
          f"buffers + graph pool {pool:.2f} GiB", flush=True)
    return served


def serve_cli_check(gpu: str, state: str, body: bytes, want) -> None:
    """`python -m amodal_depth_anything_tpu_torch.cli.serve --serving_state
    STATE --max_batch 4` on the card as a subprocess, as a user starts the
    server: it restores the full-width state of phase (d), captures its
    CUDA graph at batch 4 and must say so at startup. One POST of `body`
    must answer 200 with depth maps within one uint16 step + 1e-3 of `want`
    (base, blended: a direct call of the in-process handle with the request
    in row 0, where the batcher puts a lone request). The process is
    stopped after."""
    import base64
    import select
    import urllib.request

    from amodal_depth_anything_tpu_torch.utils.host_image import decode_png

    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "amodal_depth_anything_tpu_torch.cli.serve",
         "--serving_state", state, "--port", "0",
         "--max_batch", str(FULL_BATCH)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line, deadline = "", time.time() + 300
        while time.time() < deadline and "serving on" not in line:
            ready, _, _ = select.select([proc.stdout], [], [], 5.0)
            if ready:
                line = proc.stdout.readline()
            if proc.poll() is not None:
                break
        up = time.time() - t0
        check("serving on" in line and "CUDA graph" in line,
              f"cli.serve --serving_state on the card serves a CUDA graph: "
              f"{line.strip()!r}")
        if "serving on" not in line:
            return
        port = re.search(r":(\d+) ", line).group(1)
        t = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/amodal_depth", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            code, res = r.status, json.loads(r.read())
        ms = (time.perf_counter() - t) * 1e3
        got = [decode_png(base64.b64decode(res[key])).astype(np.float64)
               / 65535.0 for key in ("base_depth", "blended_depth")]
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        check(code == 200 and err <= 1.0 / 65535 + 1e-3,
              f"cli.serve POST answered {code}; depth vs the direct call "
              f"max abs {err:.3e} <= one uint16 step + 1e-3")
        print(f"  cli.serve --serving_state subprocess: up in {up:.1f} s "
              f"(process start, state read, capture), one POST in "
              f"{ms:.1f} ms [{gpu}]", flush=True)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def serving_phase(gpu: str) -> dict:
    """Serving at full width: (a) vitg + vitl at 518 px and (b) DepthFM at
    512 px, 4 steps, each bf16 batch 4 captured as a CUDA graph and held
    against its eager call; (b) also DeepCache (2, 2) replayed, with its
    quality delta against the exact replay; (c) HTTP: the captured amodal
    handle behind `cli.serve.build_server`, 16 POSTs from 8 threads of
    textured PNGs filtered as PIL filters them (Paeth rows); (d) the
    phase-(a) pipeline's serving state saved, served by `cli.serve
    --serving_state` in a subprocess (one POST), restored and captured
    again, bit-identical. Returns the replays' traced launch counts."""
    import base64
    import shutil
    import threading
    import urllib.error
    import urllib.request

    import torch

    from amodal_depth_anything_tpu_torch.cli.serve import (
        _b64_png_to_array, _depth_to_b64_png, _prep, build_server)
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu_torch.pipeline.aot import (
        capture_amodal_program, capture_depthfm_program)
    from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
        DepthFMPipeline
    from amodal_depth_anything_tpu_torch.pipeline.quality import (
        blended_depth_delta, check_gate)
    from amodal_depth_anything_tpu_torch.utils.host_image import (
        _filter_rows, decode_png, encode_png)

    rng = np.random.default_rng(9)
    hw = (600, 800)
    img = (rng.random((FULL_BATCH, *hw, 3)) * 255).astype(np.float32)
    mask = np.zeros((FULL_BATCH, *hw), np.float32)
    mask[:, 150:450, 250:600] = 1.0
    obs = rng.random((FULL_BATCH, *hw)).astype(np.float32)

    print("  (a) amodal capture", flush=True)
    pipe = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=torch.bfloat16)
    served = capture(lambda: capture_amodal_program(
        pipe, batch=FULL_BATCH, hw=hw), "vitg + vitl bf16")
    amodal = eager_against_replay(
        f"vitg + vitl bf16 batch {FULL_BATCH} at {SIZE} px", lambda: pipe(
            img, mask), lambda: served(img, mask), FULL_BATCH, 64, gpu)

    print("  (b) DepthFM capture", flush=True)
    dfm = DepthFMPipeline.init_random(
        0, tiny=False, size=DEPTHFM_SIZE, num_steps=DEPTHFM_STEPS,
        device="cuda", dtype=torch.bfloat16)
    dfm_served = capture(lambda: capture_depthfm_program(
        dfm, batch=DEPTHFM_BATCH, hw=hw), "DepthFMAmodal bf16")
    depthfm = eager_against_replay(
        f"DepthFM bf16 batch {DEPTHFM_BATCH} at {DEPTHFM_SIZE} px, "
        f"{DEPTHFM_STEPS} steps", lambda: (dfm(img, mask, obs),),
        lambda: (dfm_served(img, mask, obs),), DEPTHFM_BATCH,
        DEPTHFM_LAUNCHES, gpu)
    exact = dfm_served(img, mask, obs)
    dfm.deep_cache = DEEP_CACHE
    cached = capture(lambda: capture_depthfm_program(
        dfm, batch=DEPTHFM_BATCH, hw=hw), f"DepthFM DeepCache {DEEP_CACHE}")
    dfm.deep_cache = None
    approx = cached(img, mask, obs)
    lat = []
    for _ in range(SERVE_CALLS):
        t = time.perf_counter()
        cached(img, mask, obs)
        lat.append(time.perf_counter() - t)
    wall, busy, counts = trace_call(lambda: cached(img, mask, obs))
    delta = blended_depth_delta(exact, exact, approx, approx)
    gate = check_gate(delta)
    check(np.isfinite(approx).all() and approx.shape == exact.shape,
          f"DeepCache {DEEP_CACHE} replay finite, {list(approx.shape)}")
    rate = DEPTHFM_BATCH * SERVE_CALLS / sum(lat)
    print(f"  DeepCache {DEEP_CACHE} replay: {rate:.3f} images/s, p50 "
          f"{np.median(lat) * 1e3:.1f} ms, "
          f"device busy {as_ms(busy)} of a {wall:.1f} ms profiled wall, "
          f"{counts['flash_attn_fwd']} flash_attn_fwd launches; against the "
          f"exact replay: depth max abs {delta['blended_max_abs']:.4f}, mean "
          f"abs {delta['blended_mean_abs']:.4f}; gate {gate['limits']}: "
          f"{'pass' if gate['pass'] else 'fail'} (random weights; recorded, "
          f"not a check) [{gpu}]", flush=True)
    del dfm, dfm_served, cached
    torch.cuda.empty_cache()

    print("  (c) HTTP over the captured amodal handle", flush=True)
    # the server resizes every request to the square size on the host, so
    # its handle is captured there, as `cli.serve` captures it
    square = capture(lambda: capture_amodal_program(
        pipe, batch=FULL_BATCH, hw=(SIZE, SIZE)), "vitg + vitl bf16 square")
    server = build_server(square, port=0, max_batch=FULL_BATCH,
                          max_delay_ms=5.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/amodal_depth"
    # photograph-like request images: smooth shading under a texture whose
    # neighbouring pixels correlate, which PIL's encoder (and encode_png,
    # which filters as it does) writes as Paeth rows
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]] / 100.0
    grain = rng.normal(0, 8, (4, hw[0] + 2, hw[1] + 2, 3))
    grain = sum(grain[:, i:i + hw[0], j:j + hw[1]]
                for i in range(3) for j in range(3)) / 3
    images = np.stack([np.stack([np.sin(xx * (2 + k) + c)
                                 * np.cos(yy * 1.5 - c) for c in range(3)],
                                -1) for k in range(4)]) * 90 + 128 + grain
    images = images.clip(0, 255).astype(np.uint8)
    masks = (mask[:4] * 255).astype(np.uint8)
    masks[1:, :100] = 255           # four different requests

    def b64(a):
        return base64.b64encode(encode_png(a)).decode("ascii")

    bodies = [json.dumps({"image": b64(images[i]),
                          "mask": b64(masks[i])}).encode() for i in range(4)]
    rows = np.bincount(np.concatenate(
        [_filter_rows(a.reshape(hw[0], -1), 3)[:, 0] for a in images]),
        minlength=5)
    png = encode_png(images[0])
    t = time.perf_counter()
    decode_png(png)
    decode_ms = (time.perf_counter() - t) * 1e3
    print(f"  request images {hw[1]}x{hw[0]} RGB, rows filtered None/Sub/Up/"
          f"Average/Paeth {rows.tolist()}; one image PNG ({len(png)} bytes) "
          f"decoded on the host in {decode_ms:.1f} ms", flush=True)
    results: list = [None] * SERVE_REQUESTS

    def client(k):
        for i in range(k, SERVE_REQUESTS, SERVE_CLIENTS):
            t = time.perf_counter()
            try:
                req = urllib.request.Request(
                    url, data=bodies[i % 4],
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    code, res = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                code, res = e.code, None
            results[i] = (code, res, time.perf_counter() - t)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.shutdown()
        server.batcher.close()
    codes = [r[0] if r else None for r in results]
    check(codes == [200] * SERVE_REQUESTS,
          f"HTTP: {SERVE_REQUESTS} POSTs from {SERVE_CLIENTS} threads all "
          f"answered 200 ({codes})")
    # a direct call with the request in every row of the batch: in bf16 a
    # row's result depends on its position in the batch (not on the other
    # rows), and the batcher may have put the request in any position
    worst = spread = 0.0
    for i in range(4):
        img_p, msk_p = _prep(images[i], masks[i], SIZE)
        want = square(np.stack([img_p] * FULL_BATCH),
                      np.stack([msk_p] * FULL_BATCH))
        if i == 0:
            first = [w[0] for w in want]    # request 0 at row 0
        spread = max(spread, max(float(np.abs(w - w[:1]).max())
                                 for w in want))
        for code, res, _ in results[i::4]:
            if code != 200:
                continue
            got = [decode_png(base64.b64decode(res[key])).astype(np.float64)
                   / 65535.0 for key in ("base_depth", "blended_depth")]
            worst = max(worst, min(
                max(float(np.abs(g - w[p]).max()) for g, w in zip(got, want))
                for p in range(FULL_BATCH)))
    check(worst <= 1.0 / 65535 + 1e-3,
          f"HTTP depth vs a direct call of the handle at the same batch "
          f"position: max abs {worst:.3e} <= one uint16 step + 1e-3 (the "
          f"positions of one input differ by up to {spread:.3e} in bf16)")
    lat = [r[2] for r in results if r]
    del square
    print(f"  HTTP: {SERVE_REQUESTS} requests, {server.batcher.dispatches} "
          f"dispatches, per-request p50 {np.median(lat) * 1e3:.1f} ms (min "
          f"{min(lat) * 1e3:.1f}, max {max(lat) * 1e3:.1f}) [{gpu}]",
          flush=True)
    # one request's host work alone, stage by stage, as the handler does it
    req, stages = json.loads(bodies[0]), {}
    t = time.perf_counter()
    for name, fn in (
            ("json", lambda: json.loads(bodies[0])),
            ("image decode", lambda: _b64_png_to_array(req["image"])),
            ("mask decode", lambda: _b64_png_to_array(req["mask"])),
            ("resize", lambda: _prep(images[0], masks[0], SIZE)),
            ("two depth encodes", lambda: [_depth_to_b64_png(d)
                                           for d in first])):
        fn()
        stages[name] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
    print("  one request's host work alone: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; {sum(stages.values()):.1f} ms in all [{gpu}]", flush=True)

    print("  (d) serving state", flush=True)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "serving_state_smoke")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.time()
        pipe.save_serving(path)
        write_s = time.time() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(path) for f in files)
        serve_cli_check(gpu, path, bodies[0], first)
        t0 = time.time()
        restored = AmodalDepthPipeline.load_serving(path, device="cuda")
        torch.cuda.synchronize()
        read_s = time.time() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    check(restored.dtype == torch.bfloat16 and all(
        p.dtype == torch.bfloat16 for m in (restored.raw_model,
                                            restored.amodal_model)
        for p in m.parameters()), "restored serving state is bfloat16")
    again = capture_amodal_program(restored, batch=FULL_BATCH, hw=hw)
    same = all(np.array_equal(a, b) for a, b in zip(again(img, mask),
                                                    served(img, mask)))
    check(same, "restored pipeline's replay bit-identical to the saved "
                "pipeline's")
    print(f"  serving state: {nbytes / 1e9:.3f} GB, written in {write_s:.2f} "
          f"s ({nbytes / 1e9 / write_s:.2f} GB/s), read to the card in "
          f"{read_s:.2f} s ({nbytes / 1e9 / read_s:.2f} GB/s) [{gpu}]",
          flush=True)
    return {"amodal": amodal["replay"]["launches"],
            "depthfm": depthfm["replay"]["launches"]}


def p2g_proxy_phase() -> None:
    """The trained pix2gestalt proxy (UNet 48 channels, CLIP 64 wide) in
    float32 with TF32 off: the card (kernels) against the CPU (plain), one
    UNet call on the same inputs, then `MaskHeuristics.
    pix2gestalt_completion` at 64 px on the same initial noise after 10 and
    100 guided DDIM steps."""
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import \
        load_p2g_proxy
    from amodal_depth_anything_tpu_torch.heuristics import MaskHeuristics
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha

    stacks = {}
    for device in ("cuda", "cpu"):
        p2g = load_p2g_proxy(P2G_PROXY, device=device).eval()
        sam = MaskHeuristics.init_random(0, tiny=True, device=device).sam
        stacks[device] = MaskHeuristics(sam, p2g)
    cfg = dataclasses.replace(stacks["cuda"].p2g_cfg,
                              image_size=P2G_PROXY_SIZE)
    hw = P2G_PROXY_SIZE // 8
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, hw, hw, 4), generator=gen)
    cond = torch.randn((2, hw, hw, 8), generator=gen)
    ctx = torch.randn((2, 1, cfg.context_dim), generator=gen)
    t = torch.tensor([999.0, 499.0])
    outs = {}
    for device, mh in stacks.items():
        mha.launches = 0
        with torch.inference_mode():
            outs[device] = mh.p2g.unet(
                x.to(device), t.to(device), context=cond.to(device),
                context_ca=ctx.to(device)).cpu()
        if device == "cuda":
            launches = mha.launches
    err_call = (outs["cuda"] - outs["cpu"]).abs().max().item()
    check(launches == 32 and err_call <= PROXY_TOL,
          f"p2g proxy UNet call at {P2G_PROXY_SIZE} px: card (kernels, "
          f"{launches} launches, 32) vs CPU (plain) max abs {err_call:.3e} "
          f"<= {PROXY_TOL}")

    rng = np.random.default_rng(8)
    image = (rng.random((96, 128, 3)) * 255).astype(np.uint8)
    visible = np.zeros((96, 128), bool)
    visible[24:80, 30:100] = True
    noise = torch.randn((1, hw, hw, 4), generator=gen)
    errs = {}
    for steps in (10, HEUR_STEPS):
        got = {}
        for device, mh in stacks.items():
            mh.p2g_cfg = dataclasses.replace(cfg, ddim_steps=steps)
            mha.launches = 0
            got[device] = mh.pix2gestalt_completion(image, visible,
                                                    noise=noise)
            if device == "cuda":
                launches = mha.launches
        errs[steps] = float(np.abs(got["cuda"] - got["cpu"]).max())
        want = 2 + 32 * steps    # the proxy's CLIP has 2 blocks
        check(launches == want and np.isfinite(got["cuda"]).all(),
              f"p2g proxy completion, {steps} steps: {launches} launches "
              f"({want}), finite")
    growth = (errs[HEUR_STEPS] / max(err_call, 1e-12)) ** (1 / HEUR_STEPS)
    print(f"  p2g proxy card vs CPU: one UNet call {err_call:.3e}, "
          f"completion after 10 steps {errs[10]:.3e}, after {HEUR_STEPS} "
          f"{errs[HEUR_STEPS]:.3e}: a factor {growth:.4f} per step over the "
          f"one call's error", flush=True)
    check(errs[HEUR_STEPS] <= P2G_COMPLETION_TOL,
          f"p2g proxy {HEUR_STEPS}-step completion at {P2G_PROXY_SIZE} px, "
          f"card vs CPU: max abs {errs[HEUR_STEPS]:.3e} <= "
          f"{P2G_COMPLETION_TOL}")


def synthetic_scene(hw):
    """A 600 x 800 scene: a textured background, a lit disc (the target)
    half behind a dark bar, and the user's point hints on the visible part
    of the disc: a small blob (< 100 px, its centroid) and a stroke (> 100
    px, a 10 px grid of prompts)."""
    h, w = hw
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([60 + 40 * np.sin(xx / 23.0), 90 + 30 * np.cos(yy / 17.0),
                    np.full((h, w), 120.0)], -1)
    disc = (yy - 300) ** 2 + (xx - 400) ** 2 < 160 ** 2
    img[disc] = (220, 170, 60)
    img[:, 380:470] = (25, 25, 30)                   # the occluder
    img += rng.normal(0, 6, img.shape)
    hint = np.zeros((h, w), np.float32)
    hint[296:302, 300:306] = 1.0                     # 36 px: a centroid
    hint[250:270, 260:340] = 1.0                     # 1600 px: a grid
    return np.clip(img, 0, 255).astype(np.uint8), hint


def heuristics_phase(gpu: str) -> int:
    """The demo's heuristics at full width: a seeded SAM ViT-H, pix2gestalt
    (SD-1.5 UNet, 12-channel conv-in, 768-wide context) with CLIP ViT-L/14
    and the SD VAE, RMBG-1.4 at 1024 px, and vitg + vitl at 518 px. One
    float32 UNet step with the kernels against plain attention; then, cast
    to bfloat16, `cli.app.AmodalDepthApp.predict_arrays` in "prompt_points"
    mode (`MaskHeuristics.amodal_mask_from_points`, then
    `AmodalDepthPipeline.__call__` on its mask): one warm-up, timed calls,
    the launches, the mask; a staged call, each stage timed; one call under
    torch.profiler. Returns the forward kernel's launches over the timed
    calls."""
    import torch

    from amodal_depth_anything_tpu_torch.cli.app import AmodalDepthApp
    from amodal_depth_anything_tpu_torch.heuristics import (
        MaskHeuristics, get_points_from_components, host_ops,
        init_heuristics_, make_rmbg_matting_fn)
    from amodal_depth_anything_tpu_torch.models.rmbg import ISNet, RMBGConfig
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    mh = MaskHeuristics.init_random(gen, device="cuda")
    with torch.device("meta"):
        rmbg = ISNet(RMBGConfig())
    rmbg = init_heuristics_(rmbg.to_empty(device="cuda"), gen)
    torch.cuda.synchronize()
    p2g, sam = mh.p2g_cfg, mh.sam_cfg
    n_params = {name: sum(p.numel() for p in m.parameters()) / 1e6
                for name, m in (("SAM", mh.sam), ("UNet", mh.p2g.unet),
                                ("CLIP", mh.p2g.clip), ("VAE", mh.p2g.vae),
                                ("RMBG", rmbg))}
    print(f"  seeded heuristics stack built on the card in "
          f"{time.time() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} M" for k, v in n_params.items()),
          flush=True)
    check((sam.embed_dim, sam.depth, sam.img_size, p2g.model_channels,
           tuple(p2g.channel_mult), p2g.context_dim, p2g.image_size,
           p2g.ddim_steps, p2g.guidance_scale, mh.p2g.cfg.unet.in_channels,
           mh.clip_cfg.width, mh.clip_cfg.depth, mh.clip_cfg.image_size)
          == (1280, 32, 1024, 320, (1, 2, 4, 4), 768, 256, HEUR_STEPS, 1.5,
              12, 1024, 24, 224),
          "full width: SAM ViT-H at 1024 px, pix2gestalt UNet 320 x "
          "(1,2,4,4) with 12-channel conv-in and 768-wide context at 256 "
          "px, 100 DDIM steps, guidance 1.5, CLIP ViT-L/14 at 224 px")

    # (d) one full-width float32 UNet step: the kernels against plain
    tg = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((2, 32, 32, 4), generator=tg, device="cuda")
    cond = torch.randn((2, 32, 32, 8), generator=tg, device="cuda")
    ctx = torch.randn((2, 1, 768), generator=tg, device="cuda")
    t = torch.full((2,), 999.0, device="cuda")
    with torch.inference_mode():
        mha.launches = 0
        eps_k = mh.p2g.unet(x, t, context=cond, context_ca=ctx)
        step_launches = mha.launches
        eps_p = mh.p2g.unet(x, t, context=cond, context_ca=ctx,
                            attn_impl="plain")
    err = (eps_k - eps_p).abs().max().item()
    check(step_launches == 32 and err <= FULL_F32_TOL
          and torch.isfinite(eps_k).all().item(),
          f"full-width f32 p2g UNet step (batch 2 at 256 px): {step_launches}"
          f" launches (32), kernels vs plain attention max abs {err:.3e} <= "
          f"{FULL_F32_TOL}")

    # (c) the demo's path in bfloat16
    mh.cast_to(torch.bfloat16)
    mh.matting_fn = make_rmbg_matting_fn(rmbg, input_size=1024)
    pipe = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=torch.bfloat16)
    app = AmodalDepthApp(pipe, mh)
    img, hint = synthetic_scene(HEUR_HW)
    app.predict_arrays(img, hint, "prompt_points", seed=0)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    mha.launches = 0                      # the main path starts here
    for i in range(HEUR_CALLS):
        t1 = time.perf_counter()
        out = app.predict_arrays(img, hint, "prompt_points", seed=i)
        latencies.append(time.perf_counter() - t1)
    launches = mha.launches               # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_call = HEUR_LAUNCHES + DEPTH_LAUNCHES
    check(launches == HEUR_CALLS * per_call,
          f"heuristics main path launched flash_attn_fwd {launches} times "
          f"({HEUR_CALLS} x ({HEUR_LAUNCHES} completion + {DEPTH_LAUNCHES} "
          f"depth))")

    # one call stage by stage (seed 0 again), each stage synchronised
    stages, counts = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        mha.launches = 0
        t1 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t1) * 1e3
        counts[name] = mha.launches
        return r

    with torch.inference_mode():
        hint_u8 = (hint > 0).astype(np.uint8) * 255
        pts = stage("host: point prompts",
                    lambda: get_points_from_components(hint_u8))
        visible = stage("SAM encode + decode (+ host resizes)",
                        lambda: mh.sam_visible_mask(img, pts))
        img01, m01 = stage("host: p2g inputs",
                           lambda: mh.p2g_inputs(img, visible))
        ctx, cond = stage("VAE encode x2 + CLIP",
                          lambda: mh.p2g.context(img01, m01, mh.p2g_cfg))
        clip_in = torch.zeros((1, 224, 224, 3), device="cuda",
                              dtype=torch.bfloat16)
        stage("CLIP alone", lambda: mh.p2g.clip(clip_in))
        x_sam = torch.zeros((1, sam.img_size, sam.img_size, 3),
                            device="cuda", dtype=torch.bfloat16)
        p_sam = torch.full((1, mh.max_points, 2), 0.5, device="cuda")
        l_sam = torch.ones((1, mh.max_points), device="cuda")
        stage("SAM forward alone", lambda: mh.sam(x_sam, p_sam, l_sam))
        x_rmbg = torch.zeros((1, 1024, 1024, 3), device="cuda")
        stage("RMBG forward alone", lambda: rmbg(x_rmbg))
        noise = torch.Generator(device="cuda").manual_seed(0)
        z = stage(f"{HEUR_STEPS} DDIM steps (UNet at batch 2)",
                  lambda: mh.p2g.sample(ctx, cond, noise, cfg=mh.p2g_cfg))
        comp = stage("VAE decode",
                     lambda: mh.p2g.render(z).float()[0].cpu().numpy())
        amodal = stage("RMBG at 1024 px (f32, + host resizes)",
                       lambda: mh.matting_fn(comp))
        mask = stage("host: resize + union", lambda: np.maximum(
            host_ops.resize_nearest(amodal, HEUR_HW[::-1]),
            visible.astype(np.float32)))
        stage("depth: vitg + vitl at 518 px", lambda: pipe(img, mask))
    total = sum(v for k, v in stages.items() if not k.endswith(" alone"))
    for name, ms in stages.items():
        print(f"    {ms:9.1f} ms {100 * ms / total:5.1f}%  {counts[name]:5d} "
              f"launches  {name}", flush=True)
    comp_launches = counts["VAE encode x2 + CLIP"] + counts[
        f"{HEUR_STEPS} DDIM steps (UNet at batch 2)"]
    check(comp_launches == HEUR_LAUNCHES and counts["CLIP alone"] == 24,
          f"one completion launched flash_attn_fwd {comp_launches} times "
          f"({HEUR_LAUNCHES} = 24 CLIP + 32 x {HEUR_STEPS})")
    m = out["mask"]
    area = float(m.sum())
    check(m.shape == HEUR_HW and np.isfinite(m).all()
          and set(np.unique(m)) <= {0.0, 1.0}
          and (m >= visible).all(),
          f"prompt_points mask [{HEUR_HW[0]},{HEUR_HW[1]}] binary, covers "
          f"the visible mask ({int(visible.sum())} px); area {area:.0f} px "
          f"({100 * area / m.size:.1f}%)")
    for name in ("base", "blended"):
        a = out[name]
        check(a.shape == (SIZE, SIZE) and np.isfinite(a).all()
              and a.std() > MIN_STD,
              f"prompt_points {name} depth finite, [{SIZE},{SIZE}], not "
              f"constant (std {a.std():.4f})")
    a = out["aligned"]
    check(np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0,
          "prompt_points aligned depth finite, in [0, 1]")
    profile_call(lambda: app.predict_arrays(img, hint, "prompt_points",
                                            seed=0),
                 "heuristics + depth call (bf16)", gpu)
    p50 = float(np.median(latencies)) * 1e3
    print(f"  heuristics + depth bf16 at full width, {HEUR_HW[0]} x "
          f"{HEUR_HW[1]} scene: p50 {p50:.1f} ms per call, latencies "
          f"{[round(v * 1e3, 1) for v in latencies]} ms, staged total "
          f"{total:.1f} ms, peak memory {peak:.2f} GiB [{gpu}]", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 1
    from amodal_depth_anything_tpu_torch.ops import _build
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.ops.precision import \
        apply_precision_policy

    started = time.time()

    def phase(title: str) -> None:
        print(f"{title} (at {time.time() - started:.1f} s)", flush=True)

    gpu = card()
    print(f"[1] device: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    apply_precision_policy(torch.float32)
    print(f"  allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    phase("[2] build")
    t0 = time.time()
    reports = _build.build()
    print(f"  built {sorted(reports)} in {time.time() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            entry = ENTRY_NAME.search(line)
            if "Compiling entry function" in line and entry:
                pad = f"<{entry.group(2)}>" if entry.group(2) else ""
                print(f"  {name}: {entry.group(1)}{pad}", flush=True)
            elif "(C7" in line:   # an advisory on a wgmma pipeline
                print(f"  {name}:   {line.strip()[:150]} ...", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"  {name}:   {line.strip()}", flush=True)
    sass_check()

    phase("[3] kernels against their plain versions")
    measured = {"flash_attn_fwd": attention_phase(gpu)}
    measured.update(attention_bwd_phase(gpu))
    measured["fused_epilogue"] = epilogue_phase(gpu)
    host_cost_phase(gpu)

    phase("[4] trained proxies: card vs CPU")
    proxy_phase()
    proxy_grad_phase()
    depthfm_proxy_phase()
    depthfm_proxy_grad_phase()

    phase("[5] inference at full width: vitg base + vitl AmodalDAv2")
    infer_launches = full_width_phase(gpu)
    torch.cuda.empty_cache()

    phase("[6] training at full width: vitl AmodalDAv2")
    launches = train_phase(gpu)
    torch.cuda.empty_cache()

    phase("[7] DepthFM inference at full width: SD-1.5 UNet + VAE")
    depthfm_launches = depthfm_phase(gpu)
    torch.cuda.empty_cache()

    phase("[8] DepthFM training at full width: SD-1.5 UNet + VAE")
    dfm_train = depthfm_train_phase(gpu)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[9] serving at full width: both inference programs captured")
    mha.launches = 0                      # the serving path starts here
    per_replay = serving_phase(gpu)
    serve_launches = mha.launches         # ... and ends here
    gc.collect()
    torch.cuda.empty_cache()

    phase("[10] heuristics at full width: SAM ViT-H, pix2gestalt, CLIP "
          "ViT-L/14, RMBG-1.4, then vitg + vitl depth")
    p2g_proxy_phase()
    heur_launches = heuristics_phase(gpu)

    # launches: over the main paths, each counted from 0; the forward
    # kernel runs on seven (inference [5], training [6], DepthFM [7], DepthFM
    # training and its DDPM finetune [8], serving [9], heuristics [10]), the
    # backward pair on three, the fused epilogue on its chain [3]
    launches["fused_epilogue"] = measured["fused_epilogue"]["launches"]
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **measured[name],
                "launches": launches[name]}
               for name, (source, replaces) in KERNELS.items()]
    for i, name in enumerate(("flash_attn_fwd", "flash_attn_bwd_dq",
                              "flash_attn_bwd_dkv")):
        kernels[i].update(
            launches=launches[name] + dfm_train[name] + dfm_train["ddpm"][i],
            launches_training=launches[name],
            launches_depthfm_training=dfm_train[name],
            launches_ddpm_training=dfm_train["ddpm"][i])
    # serving: the Python counter counts the eager calls, warm-ups and
    # captures; a replay's launches are read from its trace
    kernels[0].update(
        launches=kernels[0]["launches"] + infer_launches + depthfm_launches
        + serve_launches + heur_launches,
        launches_inference=infer_launches, launches_depthfm=depthfm_launches,
        launches_serving=serve_launches, launches_heuristics=heur_launches,
        launches_per_replay_traced=per_replay)
    print(f"  all phases took {time.time() - started:.1f} s", flush=True)
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
