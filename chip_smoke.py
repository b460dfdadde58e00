#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives the port (`amodal_depth_anything_tpu_torch`, never JAX) through
its user entry points and holds every hand-written kernel against its
plain PyTorch version on the card:

  1. device and flags: `nvidia-smi` name and power limit, the TF32 flags;
  2. build: nvcc compiles the three kernel libraries from `csrc/` (all at
     once); ptxas's `-v` report (kept beside each library) must show no
     serialised wgmma (C7512 and its kin); where `cuobjdump` is found, the
     SASS of each wgmma kernel function (every bf16 instantiation of the
     forward, the short-key forward, dQ and dK/dV, the short-key backward,
     d = 16 to 160; the epilogue's) must hold
     HGMMA (wgmma) and UTMALDG (TMA load) opcodes, and no bf16 attention
     kernel on mma.sync may be left;
  3. kernel vs plain version at the main paths' attention shapes and
     more, float32 (max abs <= 2e-5) and bfloat16 (<= 2e-2, plain version
     on the bf16-rounded inputs in float32), with kernel, plain and
     `F.scaled_dot_product_attention` times (the last a yardstick only):
     the forward at the DINOv2 trunks' head dim 64 and at the SD-1.5
     UNet's shapes (head dims 40/80/160, self-attention and
     cross-attention onto 77 keys, the proxy's 12/24/48) and on the
     edges of the Hopper kernel's tiles (N from 1 to 257, kv_len
     one short of N and in the middle of a tile, 77 keys under 4096 rows,
     strided views of one qkv buffer, with and without the LSE), the bf16
     short-key kernel (kv_len <= 80, every key in one tile) onto 1, 77, 80
     and 81 keys (one past the cut: the streaming kernel) at d = 40/80/160
     under a ragged Nq, keys past kv_len, a negative scale, with the LSE,
     each call's profiled kernel the table's instantiation, then the
     two backward kernels (dQ; dK and dV) against `mha_bwd_reference`,
     tolerances relative to the reference's max abs, at the trunks' shapes
     and the UNet's (head dims 40/80/160, self-attention and onto 77
     keys), each timed beside SDPA's backward (CUDA events, and the
     kernels' device time from torch.profiler, which launch-bound shapes
     need), and on the edges of their
     tiles (the forward's sweep: N from 1 to 257, kv_len inside a tile,
     dead dK/dV rows exactly 0, a second dQ and dK/dV run bit-identical,
     head dims 64/40/24/8/80/136/160 and bf16 48), dQ at d = 40 on boxes
     of d columns (self with a ragged kv_len, onto 77 and onto 31 keys,
     the profiled kernel checked), and `mha` under autograd on strided
     CUDA views; the bf16 backward onto a short key set (kv_len <= 80:
     dQ, dK and dV in one pass, then the sum of the blocks' partial dK and
     dV) through the gradient's route at d = 40/80/160 onto 1, 16, 17, 77,
     80 and 81 keys (one past the cut: the pair) under 999 query rows, the
     mid block's 64-token self-attention, padded (kv_len < Nq), keys past
     kv_len, a negative scale, each case twice and bit-identical, each
     call's profiled kernels the table's, and timed at [8,8,4096,40] onto
     77 keys beside the pair and SDPA's backward; the KSTEPS 3 (d = 40)
     and short-key kernels' ptxas report without spills; the device time
     (torch.profiler) of the bf16
     forward, dQ and dK/dV at every d > 64 UNet shape and the d = 40 ones
     of HEAD_DIM_40_* (`tools/head_dim_times.py`'s: the forward self and
     onto 77 or 1 keys, DepthFM training's backward at batch 4 and at
     every d > 64 shape of a batch-8 step), each beside SDPA's, the bound
     and the exponentials' floor, and the profiled
     kernel checked to be the table's instantiation; then the fused matmul
     + LayerScale + residual epilogue against
     `matmul_scale_residual_reference` at the trunks' proj / fc2 shapes,
     and its path: a chain of four blocks at vitg width with the kernel
     and with the library chain (`F.linear`, `torch.addcmul`), results
     compared and both timed; and what a launch
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
     memory. Five steps through `trainer.train()`, each one captured CUDA
     graph (the default on the card): finite losses, moved parameters,
     exactly 24 forward, 24 dQ and 24 dK/dV launches counted at the
     capture's warm-up steps and the capture itself, and 24 of each in a
     traced replay; then two eager and two captured steps from one init
     on the same batches, bit-identical (losses, parameters, Adam state),
     the captured step's p50, busy share and peak memory (the resume is
     phase 14's, on the same trainer);
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
     at 518 px (64 x 64 latents) from memory. Five captured steps through
     `trainer.train()`: finite losses, a moved UNet, a bit-identical frozen
     VAE and text embedding, exactly 32 forward launches a step, and of the
     32 backward calls 17 on the short-key backward (the 16 cross-attentions
     onto 77 keys and the mid block's 64-token self-attention) and 15 on
     the dQ and dK/dV pair, at the capture and in a traced replay; one step
     with `remat=True` (64 forward launches, the same backward)
     beside the recipe's, with peak memory; steps/s, p50 step time, peak
     memory and a torch.profiler breakdown of one step (each attention
     instantiation, GroupNorm's plain ops, device busy against wall); one
     `validate()`; one float32 step at batch 1 with the kernels against
     plain attention (loss and UNet gradient norm within 1e-3); then two
     `DepthFMTrainer` steps under `configs/train_depthfm_ddpm_finetune.yaml`
     (v-prediction, annealed multi-resolution noise) on the plain DepthFM
     and its `validate()` (DDIM, 4 steps); for DepthFMAmodalTrainer three
     eager and three captured steps bit-identical, a resume under capture,
     p50, busy share and peak memory;
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
     build/, deleted after), its replay bit-identical, bytes and seconds,
     then `cli.serve --export_artifact` on that state and `cli.serve
     --artifact` serving the artifact over HTTP, as subprocesses (the
     state's own server starts beside the artifact's); also
     the bf16 rows of one input in every row of the bucket, eager and
     replayed, bit-identical to each other and to a direct call at batch 1
     (the DPT heads run one row at a time), with the replay's p50 against
     the heads over the whole batch; and (e) both programs exported by
     `save_*_artifact` at the phase's buckets (meta.json, seconds, bytes),
     loaded, bound and replayed in a fresh process, bit-identical to the
     in-process captures;
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
     then vitg + vitl depth at 518 px on the derived mask): the first call
     captures the completion as one CUDA graph (24 + 3,200 launches
     counted at its warm-up and its capture), three timed calls replay it
     (64 depth launches counted each; a traced call launches 24 + 3,200 +
     64), the captured completion bit-identical to the eager one with and
     without DeepCache (2, 2), each timed and traced, a staged call timed
     stage by stage, peak memory, the mask (binary, covering the visible
     mask, its area) and one call under torch.profiler (device busy
     against wall);
 11. evaluation and the baselines: (a) ADDeepLab, the jo_dpt
     PartialCompletionContentDPT and InvisibleStitch, each seeded at full
     width from its own config (`configs/deeplab.yaml`, `jo_baseline.yaml`,
     `invisible_stitch.yaml`: its trainer, loss and strategy, bf16, batch
     8, 518 px) on a synthetic SAM tree written to disk by
     `data/synthetic.py`: three captured steps through `trainer.train()`
     (finite losses, moved parameters and running statistics, exactly 8 +
     8 + 8 attention launches a step at head dim 16 for ADDeepLab, 24 + 24
     + 24 at 64 for jo_dpt, none for InvisibleStitch's plain BEiT
     attention, at the capture and in a traced replay), steps/s, p50, peak
     memory, one profiled step, then `validate_single_dataset`; then three
     eager and three captured steps of each, bit-identical, and a resume
     under capture (ADDeepLab's, with its deterministic cuDNN's price); (b) `cli.eval.main` on the checkpoint phase
     6 saves, `scripts.zero_shot_eval` with a seeded vitg raw base over a
     NYU-layout split of 16-bit PNGs, and `infer_image` on a 480 x 640
     image (keep-aspect input 518 x 686, output at the input's size); (c)
     the forward, dQ and dK/dV at [8,8,256,16] and [8,16,1025,64] against
     their plain versions in f32 and bf16, device times from CUDA graphs of
     20 calls beside the bound and SDPA's, and one mViT decoder layer at
     full width, kernels on strided self / cross views against plain
     attention (output and gradients); (d) each baseline at its tiny preset
     card (kernels) against CPU (plain) in f32, <= 1e-4;
 12. serving compression (`ops/quant.py`, `ops/token_merge.py`): (a) the
     int8 products on `torch._int_mm` at the vitg / vitl trunks' qkv,
     proj, fc1 and fc2 shapes (batch 4 at 518 px, and at the ToMe'd
     length) and the UNet's, and the im2col int8 convolution at the DPT
     heads', the UNet's and the VAE's shapes: int32 sums equal to the exact
     product (float64), times beside the bf16 product's; (b) the forward
     kernel at the merged lengths (ToMe (4, 658) on both trunks: 712
     tokens; (9, 2560) at 1022 px: 2770; ToMe-SD 0.75: 2049 of 4096
     tokens, self and onto 77 keys) against its plain version with phase
     3's bars; (c) vitg + vitl at 518 px, bf16 batch 4, at six points
     (exact, int8 LN-bound, calibrated + heads, dynamic + heads, ToMe
     (4, 658) on both trunks, int8 + ToMe), each eager and captured by
     `pipeline.aot`: 64 launches an eager call and a call's worth in the
     capture (checked; a profiled replay's count is printed, not checked),
     the replay bit-identical to the eager call, p50 of both, device busy,
     peak memory, the blended depth delta to the exact point; (f) the
     int8 + ToMe state saved and restored bit-identical (under build/,
     deleted after), `cli.serve --serving_state ... --int8 ln` (full width)
     and `cli.serve --family depthfm --random --int8 wo` as subprocesses
     that capture and answer three POSTs each; (d) DepthFM at 512 px, 4
     steps, bf16 batch 4, at six points (exact, w8, w4, dynamic W8A8,
     calibrated W8A8, ToMe-SD 0.75): 128 launches a call, the same
     numbers; (e) `scripts.proxy_gate_v2` over the trained proxies (f32,
     224 px, 4 held-out scenes): its gate table. The kernels line counts
     the forward kernel's launches over (c) and over (d), each from 0.
     `python3 chip_smoke.py --only 12` runs the build and phase 12 alone
     (`--only 6,9`: the named phases of 6, 8, 9, 10, 11, 12, 13, 14, 15);
 13. the host codec and the serving tuners (the build of `native/`'s two
     host libraries by g++ is checked in phase 2, with the codec's routes;
     phase 9 (c) serves its 16 requests twice, over the native host route
     and the numpy one, each route's host work by stage and p50, the two
     answering with the same bytes; phase 11 (a) times `train()`'s loader
     over an epoch with the codec and in numpy): (d) on the phase-10 app,
     "prompt_points" exact (the call, its completion replayed and traced)
     and with a w8 and a w4 pix2gestalt UNet (`quantize_p2g_int8`): each
     one's call, which captures the quantised completion (launches counted
     over the warm-up and the capture), the completion replayed once, and
     its completion / mask / depth delta against exact; a w4 +
     w8-SAM heuristics state saved and restored bit-identical, its bytes
     beside the bf16 state's; (a) `python -m ...cli.infer` in a
     subprocess where importing cv2, PIL or matplotlib fails, on the
     phase-10 vitg + vitl pipeline's bf16 weights written as .pth files,
     its two renders equal to the in-process `infer_single_image`'s and 64
     launches counted in that process; (e) `scripts.autotune_serving
     --family amodal --random --random_preset full` (bf16 batch 4 at 518
     px, every candidate captured and timed replayed): its rows and pick;
     (f) `scripts.int8_layer_walk` on `checkpoints/proxy` at 224 px,
     beside (a)'s subprocess: the kept set. It runs after phase 10 (`--only 13` runs phase 10 first).
 14. the single-card training knobs and the scripts (after phase 13,
     whose .pth files and heuristics it reuses; `--only 14` runs phase 10
     first): (b) `scripts.sam_pl_gen` over an 8-sample pix2gestalt tree
     with the phase-10 vitg (`.pth`, bf16, batch 4), (c)
     `scripts.sam_pl_gen_depthfm` on the `tests/data/` JPEG fixtures
     (decoded natively against PIL's recorded sha256) with a seeded SD-1.5
     UNet + VAE written as `depthfm-v1.ckpt` and `vae.safetensors`,
     ensemble 10, 2 steps, 512 px, (d) `scripts.pix2gestalt_eval_single`
     on one JPEG reconstruction and `pix2gestalt_inpainting.run` over 2
     entries on the phase-10 heuristics (its captured 100-step
     completion), (e) `scripts.batch_inference` with the vitl guided
     `.pth` on the SAM tree, batch 8, (f) `scripts.verify_checkpoints
     --rehearse --skip_chain` (no FAIL row); (b), (c), (d)'s single
     reconstruction and (f) also in one process where PIL, cv2, matplotlib
     and safetensors cannot be imported, their maps equal to the
     in-process calls'; (a) `cli.train --config
     configs/train_discriminative_vitg_singlechip.yaml` (vitg, adafactor,
     remat "attn", bf16, batch 4 at 518 px) on the SAM tree, in a process
     of its own that runs beside (b)-(f) (one iteration: 8 micro-steps of
     4, the accumulate and the apply programs each captured, 40 + 40 + 40
     launches at each one's warm-up and capture); adam and adam-bf16mu
     for two eager steps each and adafactor + `head_tile=1` for two
     captured steps (peak memory, optimizer-state bytes; beside that
     process while it runs); then, alone, the captured adafactor step
     against the eager one and a resume, bit for bit; then the forward
     kernel at
     [1,24,362,64] (vitg at 266 px) and DepthFM's batch-10 shapes and the
     backward pair at [4,24,1370,64], against their plain versions, beside
     SDPA. Capped at 150 s.
 15. scale-out on the one card (`parallel/`), after phase 12 and capped at
     150 s (`--only 15` runs the build and it alone): (a) a one-rank NCCL
     group (`parallel.initialize` with a store on localhost): the vitl
     recipe's step under `DiscriminativeTrainer(mesh=make_mesh())`, its
     data all-reduce inside the captured graph, two steps bit-identical to
     eager; the vitg + vitl pipeline with a 1 x 1 mesh captured, the replay
     bit-identical to its eager call; then two ranks sharing the card over
     gloo (`torch.multiprocessing`, each child's exit code checked), which
     first print which gloo collectives take CUDA tensors (the rest are
     staged through pinned host memory): (b) vitg + vitl
     `AmodalDepthPipeline(mesh=1x2)` at 518 px, tensor- and
     sequence-parallel: f32 batch 1 against the one-process call (blended
     max abs <= 1e-3), bf16 batch 4 timed (p50, the delta to one process),
     64 forward launches a call on each rank at the local heads
     ([4,12,1370,64] and [4,8,1370,64]); (c) the trained proxy's f32
     data-parallel step (2 ranks of 4 rows) against one process of 8 (loss
     and every gradient <= 1e-4 of its max abs), the vitl recipe's bf16
     step the same way (deltas printed), then one `fsdp` step: each rank's
     parameter + Adam bytes (< 0.6 of the unsharded run's) and peak; (d)
     vitg's trunk over pipe = 2 (`get_intermediate_layers(pipeline_mesh=)`,
     f32 batch 2): the taps against the sequential trunk <= 1e-4, and one
     pipelined train step on the proxy, its gradients against the
     sequential step's. The two-rank times are gloo on one card: no
     measure of scale-out.

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
import shutil
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
           # dQ, dK and dV in one pass onto <= 80 keys (also replaces :208)
           "flash_attn_bwd_short": (CSRC + "flash_attn_bwd.cu",
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
# block, 64 a warpgroup, 128 or 64 keys a tile); each also with kv_len = N -
# 1 and, where it fits, N - 70; head dims 64, 40, 80 and 160 (the main
# paths'), 24 and 8, and 136 (a width inside the 160 instantiation, its last
# 64-column box partly filled), so that every instantiation of the bf16
# kernels (16, 32, 48, 64, 80 and 160 columns) is held against the plain
# version
EDGE_NS = (1, 63, 64, 65, 127, 128, 129, 255, 257)
EDGE_HEAD_DIMS = (64, 40, 24, 8, 80, 136, 160)
# bf16 also at d = 48, the other width of the KSTEPS 3 kernels, whose boxes
# of d columns leave no column of the k16 steps to zero (40 leaves 8)
NARROW_EDGE_HEAD_DIMS = (48,)
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
SERVE_CALLS, REPLAY_TOL = 6, 1e-3
SERVE_REQUESTS, SERVE_CLIENTS = 16, 8
DEEP_CACHE = (2, 2)
TRAIN_CONFIG = "configs/train_discriminative_vitl.yaml"
TRAIN_BATCH, TRAIN_STEPS, TRAIN_BLOCKS = 8, 5, 24
CAPTURE_STEPS = 3   # eager and captured steps held bit for bit, per trainer
# DepthFM training: the shipped recipes, batches of 8 synthetic scenes at
# 518 px (the recipe's max_train_batch_size and resize_to_hw; the VAE floors
# 518 to 64 x 64 latents); 16 self + 16 cross attentions per UNet call
DEPTHFM_TRAIN_CONFIG = "configs/train_depthfm_base.yaml"
DDPM_TRAIN_CONFIG = "configs/train_depthfm_ddpm_finetune.yaml"
DEPTHFM_TRAIN_STEPS, DDPM_TRAIN_STEPS, UNET_ATTN = 5, 2, 32
# of a UNet call's 32 backward attentions, those onto at most 80 keys take
# the short-key backward (the 16 cross-attentions onto the 77 context keys
# and the mid block's 64-token self-attention), the rest the pair
UNET_SHORT_BWD = 17
UNET_BWD = {"fwd": UNET_ATTN, "dq": UNET_ATTN - UNET_SHORT_BWD,
            "dkv": UNET_ATTN - UNET_SHORT_BWD, "short": UNET_SHORT_BWD}
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
                        r"(?:_wgmma|_short)?)(?:ILi(\d+)E(?:Li(\d+)E)?)?")

failures: list[str] = []
# the forward's launches that went to its short-key kernel, by main path
SHORT_LAUNCHES: dict[str, int] = {}


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        failures.append(what)


def beside(fn, *args):
    """`fn(*args)` in a started thread, joined by the caller; an exception
    there is a failure."""
    import threading

    def run():
        try:
            fn(*args)
        except Exception as e:
            check(False, f"{getattr(fn, '__name__', fn)}: "
                         f"{type(e).__name__}: {e}")

    t = threading.Thread(target=run)
    t.start()
    return t


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


def fwd_run(runs: dict | None, dtype, d: int, cases: int, err: float,
            timed: dict | None = None, kv_len: int | None = None) -> None:
    """Add a forward case (or `cases` of them) to `runs`, under the
    instantiation that dtype, head dim d and kv_len live keys run."""
    from amodal_depth_anything_tpu_torch.ops.flash_attention import \
        fwd_instantiation

    if runs is None:
        return
    run = runs.setdefault(fwd_instantiation(dtype, d, kv_len),
                          {"cases": 0, "max_abs_err": 0.0, "timed": []})
    run["cases"] += cases
    run["max_abs_err"] = max(run["max_abs_err"], err)
    if timed is not None:
        run["timed"].append(timed)


def attention_case(gen, shape, nk, kv_len, dt_name: str, gpu: str,
                   runs: dict | None = None) -> dict:
    """One forward-attention case: q `shape` [B,H,Nq,D] against k, v with
    `nk` keys of which `kv_len` are live; kernel against plain version,
    with their times, SDPA's and the roofline bound (added to `runs` under
    its instantiation, if given)."""
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
    fwd_run(runs, dtype, d, 1, err, {"q": list(shape), "nk": nk,
                                     "kv_len": kv, "ms": ms,
                                     "bound_ms": bound_ms}, kv_len=kv)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def edge_sweeps():
    """(dtype name, head dim, cases (Nq, Nk, kv_len)) of the tile-edge
    sweeps: every head dim of EDGE_HEAD_DIMS in both dtypes, then
    NARROW_EDGE_HEAD_DIMS in bf16, each with N = Nq = Nk in EDGE_NS,
    kv_len N - 1 and N - 70 where they fit, and 4096 queries onto 77
    keys."""
    cases = [(n, n, kv) for n in EDGE_NS for kv in (None, n - 1, n - 70)
             if kv is None or kv >= 1] + [(4096, 77, None)]
    return ([(dt, d, cases) for dt in ("float32", "bfloat16")
             for d in EDGE_HEAD_DIMS]
            + [("bfloat16", d, cases) for d in NARROW_EDGE_HEAD_DIMS])


def attention_edge_cases(runs: dict) -> None:
    """The forward kernel on the edges of its tiles, through strided views
    of one qkv buffer as the models hand them over, with and without the
    LSE, against the plain version on the same (bf16-rounded) inputs."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        mha, mha_reference)

    gen = torch.Generator(device="cuda").manual_seed(4)
    b, h = 2, 2
    for dt_name, d, cases in edge_sweeps():
        dtype = getattr(torch, dt_name)
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
            fwd_run(runs, dtype, d, 1, err, kv_len=kv_len or nk)
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


# the bf16 forward onto a short key set (kv_len <= SHORT_KEYS: every key in
# one tile) at the UNets' head dims, under a ragged Nq: onto one key and 77,
# at the cut and one key past it (the streaming kernel), keys past kv_len in
# the tile, and a negative scale: (q shape, Nk, kv_len, sm_scale)
SHORT_KEY_CASES = [((2, 4, 999, d), nk, None, None) for d in (40, 80, 160)
                   for nk in (1, 77, 80, 81)] + [
                       ((2, 4, 999, 160), 96, 80, None),
                       ((2, 4, 999, 80), 77, None, -0.3)]


def launched_kernels(fns, prefix: str, expect: int | None = None) -> list:
    """The name (with its template, as `fwd_instantiation` writes it) of
    each kernel whose name starts with `prefix` that the calls `fns`
    launched, in launch order, read from one torch.profiler trace of one
    call of each; a trace that lost events (fewer than `expect`, by default
    one a call) is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from amodal_depth_anything_tpu_torch.tools.head_dim_times import KERNEL

    cuda = torch.autograd.DeviceType.CUDA
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        found = sorted(
            (e.start_ns(), KERNEL.search(e.name()))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda
            and not getattr(e, "is_hidden_event", lambda: False)())
        names = [m.group(1) for _, m in found
                 if m and m.group(1).startswith(prefix)]
        if len(names) == (len(fns) if expect is None else expect):
            break
    return names


def short_key_cases(runs: dict) -> None:
    """The bf16 forward on SHORT_KEY_CASES against the plain version,
    output and LSE; each call's profiled kernel must be the instantiation
    `fwd_instantiation` names (the short-key kernel up to the cut, the
    streaming one past it)."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        SHORT_KEYS, fwd_instantiation, mha, mha_reference)

    gen = torch.Generator(device="cuda").manual_seed(14)
    worst, worst_lse, bad, calls, wants = 0.0, 0.0, [], [], []
    for (b, h, nq, d), nk, kv_len, scale in SHORT_KEY_CASES:
        q = torch.randn((b, nq, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        kw = {"kv_len": kv_len, "sm_scale": scale}
        out, lse = mha(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = mha_reference(q.float(), k.float(), v.float(),
                                     return_lse=True, **kw)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        kv = kv_len or nk
        if not (err <= TOL["bfloat16"] and lse_err <= LSE_TOL):
            bad.append(((b, h, nq, d), nk, kv_len, scale, err, lse_err))
        worst, worst_lse = max(worst, err), max(worst_lse, lse_err)
        fwd_run(runs, torch.bfloat16, d, 1, err, kv_len=kv)
        calls.append(lambda q=q, k=k, v=v, kw=kw: mha(q, k, v, **kw))
        wants.append(fwd_instantiation(torch.bfloat16, d, kv))
    ran = launched_kernels(calls, "flash_attn_fwd_")
    if ran != wants:
        bad.append(("profiled", ran, "wanted", wants))
    check(not bad,
          f"flash_attn_fwd bf16 onto a short key set on "
          f"{len(SHORT_KEY_CASES)} cases (d 40/80/160 onto 1, 77, "
          f"{SHORT_KEYS} and {SHORT_KEYS + 1} keys under 999 query rows, "
          f"keys past kv_len in the tile, a negative scale), with the LSE: "
          f"max abs {worst:.3e} <= {TOL['bfloat16']}, LSE {worst_lse:.3e} "
          f"<= {LSE_TOL}; each call's profiled kernel the table's "
          f"instantiation"
          + (f"; failing (q, Nk, kv_len, scale, err, lse err): {bad}"
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


def native_build_check() -> None:
    """The host libraries of `native/`, built by g++ from the checkout's
    sources (the codec's zlib and libjpeg routes where their headers are
    found); a library that does not build is a failure here, not a quiet
    return to numpy."""
    from amodal_depth_anything_tpu_torch import native
    from amodal_depth_anything_tpu_torch.native import _build, imagecodec

    t0 = time.time()
    headers = {h: _build.header_found(h)
               for h in ("zlib.h", "jpeglib.h", "png.h")}
    try:
        paths = [native.require(), imagecodec.require()]
        routes = imagecodec.routes()
    except _build.BuildError as e:
        check(False, f"native host libraries build: {e}")
        return
    check(native.available() and imagecodec.available(),
          f"native host libraries built by g++ in {time.time() - t0:.1f} s: "
          f"{[os.path.basename(p) for p in paths]}; codec routes {routes} "
          f"(headers {headers})")


# the kernel functions that must run on wgmma fed by TMA, by the mangled
# name cuobjdump heads each function's SASS with: every bf16 instantiation of
# the forward, dQ and dK/dV, the fused epilogue's bf16 kernel
# (<KSTEPS, consumer warpgroups> for the forward and dK/dV)
WGMMA_STEPS = ((1, 2), (2, 2), (3, 2), (4, 2), (5, 2), (10, 2))
WGMMA_FUNCTIONS = {
    "flash_attn_fwd": [f"flash_attn_fwd_bf16_wgmmaILi{k}ELi{w}E"
                       for k, w in WGMMA_STEPS]
                      + [f"flash_attn_fwd_bf16_shortILi{k}ELi{n}E"
                         for k, _ in WGMMA_STEPS for n in (16, 80)],
    "flash_attn_bwd": [f"flash_attn_bwd_dkv_bf16_wgmmaILi{k}ELi{w}E"
                       for k, w in WGMMA_STEPS]
                      + [f"flash_attn_bwd_dq_bf16_wgmmaILi{k}E"
                         for k in (1, 2, 3, 4, 5, 10)]
                      + [f"flash_attn_bwd_bf16_shortILi{k}ELi{n}E"
                         for k, _ in WGMMA_STEPS for n in (16, 80)],
    "fused_epilogue": ["fused_epilogue_bf16"]}
# bf16 kernels on mma.sync that no longer exist: the forward, dQ and dK/dV
# run on wgmma at every head dim
GONE_FUNCTIONS = ("flash_attn_fwd_bf16ILi", "flash_attn_bwd_dkv_bf16ILi",
                  "flash_attn_bwd_dq_bf16ILi")


def sass_functions(sass: str) -> dict:
    """{mangled function name: its SASS} of a `cuobjdump -sass` listing."""
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def sass_check() -> None:
    """Each wgmma kernel function's SASS holds wgmma and TMA-load opcodes,
    no bf16 attention kernel on mma.sync is left, and ptxas
    serialised no wgmma of any kernel (its `-v` report, kept beside each
    library)."""
    import shutil

    from amodal_depth_anything_tpu_torch.ops import _build

    from amodal_depth_anything_tpu_torch.tools.kernel_ablation import \
        ptxas_lines

    for name in _build.KERNELS:
        report = _build.ptxas_report(name) or ""
        serial = [line.strip() for line in report.splitlines()
                  if "(C75" in line and "serializ" in line]
        check(bool(report) and not serial,
              f"{name}: ptxas reports no serialised wgmma"
              + (f" ({len(serial)}: {serial[0][:200]} ...)" if serial
                 else "" if report else " (no report kept)"))
        # the KSTEPS 3 (d = 40) kernels of the attention libraries and
        # every instantiation of the short-key forward
        for wanted, what in (("bf16_wgmmaILi3E", "KSTEPS 3 kernels"),
                             ("bf16_short", "short-key kernels")):
            lines = ptxas_lines(report, wanted)
            spills = [line.strip() for line in lines
                      if re.search(r"[1-9]\d* bytes spill stores", line)]
            if lines:
                check(not spills, f"{name}: ptxas reports no spill in the "
                                  f"{what}" + (f" ({spills})" if spills
                                               else ""))
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        print("  cuobjdump not found: SASS not inspected", flush=True)
        return
    for name, wanted in WGMMA_FUNCTIONS.items():
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True).stdout
        functions = sass_functions(sass)
        counts, missing = {}, []
        for want in wanted:
            found = [f for f in functions if want in f]
            if not found:
                missing.append(want)
                continue
            text = functions[found[0]]
            counts[want] = (text.count("HGMMA"), text.count("UTMALDG"))
        gone = [f for f in functions if any(g in f for g in GONE_FUNCTIONS)]
        check(not missing and not gone
              and all(h and t for h, t in counts.values()),
              f"{name}: each of {len(wanted)} wgmma kernel functions holds "
              f"HGMMA and UTMALDG opcodes ({counts})"
              + (f"; missing {missing}" if missing else "")
              + (f"; bf16 mma.sync kernels left: {gone}" if gone else ""))


# the d = 40 rows of `tools/head_dim_times.py` that phase 3 times beside its
# d > 64 ones: the forward and the backward pair at DepthFM's 4096 tokens,
# self and onto its 77 context keys, the forward at the pix2gestalt grid,
# self and onto its one key
HEAD_DIM_40_FWD = (((4, 8, 4096, 40), 4096), ((4, 8, 4096, 40), 77),
                   ((2, 8, 1024, 40), 1024), ((2, 8, 1024, 40), 1))
HEAD_DIM_40_BWD = (((4, 8, 4096, 40), 4096), ((4, 8, 4096, 40), 77))


def wide_head_rows(gpu: str) -> tuple[list, list]:
    """Device time of the bf16 forward, dQ and dK/dV at the UNet's d > 64
    shapes and at HEAD_DIM_40_* (`tools/head_dim_times.py`'s), beside
    SDPA's, the bound and the exponentials' floor; each profiled kernel
    must be the instantiation the table names, on wgmma for all three.
    Returns (forward rows, backward rows)."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        bwd_instantiations, fwd_instantiation)
    from amodal_depth_anything_tpu_torch.tools import head_dim_times as hd

    fwd, bwd = [], []
    for shape, nk in [c for c in hd.FWD_CASES
                      if c[0][3] > 64 or c in HEAD_DIM_40_FWD]:
        r = hd.fwd_row(shape, nk, calls=10)
        want = fwd_instantiation(torch.bfloat16, shape[3], nk)
        print(f"  device time bf16 fwd q {list(shape)} Nk={nk}: "
              f"{r['kernel']} {as_ms(r['device_ms'])}, SDPA "
              f"{as_ms(r['sdpa_device_ms'])}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), exp floor {r['exp_floor_ms']:.4f} ms "
              f"[{gpu}]", flush=True)
        check(r["kernel"] == want and r["device_ms"] is not None,
              f"the forward at {list(shape)} Nk={nk} ran {r['kernel']} "
              f"({want})")
        fwd.append(r)
    for shape, nk in [c for c in hd.BWD_CASES
                      if c[0][3] > 64 or c in HEAD_DIM_40_BWD]:
        r = hd.bwd_row(shape, nk, calls=10)
        want = bwd_instantiations(torch.bfloat16, shape[3])
        print(f"  device time bf16 bwd q {list(shape)} Nk={nk}: "
              f"{r['dkv_kernel']} {as_ms(r['dkv_device_ms'])} (bound "
              f"{r['dkv_bound_ms']:.4f} ms, {r['dkv_bound_by']}); "
              f"{r['dq_kernel']} {as_ms(r['dq_device_ms'])} (bound "
              f"{r['dq_bound_ms']:.4f} ms); SDPA backward "
              f"{as_ms(r['sdpa_bwd_device_ms'])}; exp floor "
              f"{r['exp_floor_ms']:.4f} ms [{gpu}]", flush=True)
        check((r["dq_kernel"], r["dkv_kernel"]) == want
              and all("wgmma" in name for name in want)
              and r["dq_device_ms"] is not None
              and r["dkv_device_ms"] is not None,
              f"the backward at {list(shape)} Nk={nk} ran {r['dq_kernel']} "
              f"and {r['dkv_kernel']} ({want})")
        if "short_kernel" in r:   # the route onto at most 80 keys
            short = bwd_instantiations(torch.bfloat16, shape[3],
                                       kv_len=nk)[0]
            print(f"  device time bf16 bwd short q {list(shape)} Nk={nk}: "
                  f"{r['short_kernel']} (+ the sum) "
                  f"{as_ms(r['short_device_ms'])} (bound "
                  f"{r['short_bound_ms']:.4f} ms, {r['short_bound_by']}) "
                  f"[{gpu}]", flush=True)
            check(r["short_kernel"] == short
                  and r["short_device_ms"] is not None,
                  f"the short backward at {list(shape)} Nk={nk} ran "
                  f"{r['short_kernel']} ({short})")
        bwd.append(r)
    torch.cuda.empty_cache()
    return fwd, bwd


def attention_phase(gpu: str) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    main, runs = None, {}
    for shape, kv_len in ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            got = attention_case(gen, shape, shape[2], kv_len, dt_name, gpu,
                                 runs)
            if (shape, kv_len, dt_name) == MAIN_CASE:
                main = got
    unet, heur = [], []
    for shape, nk in UNET_ATTN_CASES + [CLIP_ATTN_CASE]:
        for dt_name in ("float32", "bfloat16"):
            got = attention_case(gen, shape, nk, None, dt_name, gpu, runs)
            if dt_name == "bfloat16":   # the main paths' dtype
                rows = unet if (shape, nk) in DEPTHFM_ATTN_CASES else heur
                rows.append({"q": list(shape), "nk": nk, **got})
    for shape, nk in PROXY_ATTN_CASES:
        attention_case(gen, shape, nk, None, "float32", gpu, runs)
    attention_edge_cases(runs)
    short_key_cases(runs)
    heuristics_attention_cases()
    main["depthfm_shapes"] = unet
    main["heuristics_shapes"] = heur
    main["instantiations"] = [{"name": kernel, **run}
                              for kernel, run in sorted(runs.items())]
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
    """Device time per call of `fn` of each kernel whose name starts with
    one of `names` (None where the profiler recorded none), from
    `tools/head_dim_times.device_times` (a kernel's mean device time a
    launch times its launches a call): event timing of a launch-bound shape
    reads the host's launch rate instead."""
    from amodal_depth_anything_tpu_torch.tools.head_dim_times import \
        device_times

    times = device_times(fn, calls)
    return {name: sum(ms for kernel, ms in times.items()
                      if kernel.startswith(name + "_")) or None
            for name in names}


def all_device_ms(fn, calls: int = 5) -> float | None:
    """Device time per call of `fn`, every kernel it launches summed (None
    where the profiler recorded none)."""
    from amodal_depth_anything_tpu_torch.tools.head_dim_times import \
        device_times

    return device_times(fn, calls)["all"] or None


def as_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def bwd_case(gen, shape, nk, kv_len, dt_name: str, gpu: str,
             runs: dict) -> dict:
    """One backward case: dQ and dK/dV of q `shape` [B,H,Nq,D] against
    `nk` keys (`kv_len` live) against `mha_bwd_reference`, timed beside the
    plain version and SDPA's backward, each run added to `runs` under its
    instantiation. Returns the two kernels' entries."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        bwd_instantiations, flash_attn_bwd_dkv, flash_attn_bwd_dq, mha,
        mha_bwd_reference)

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
    # the plain version and the library compute all three gradients in one
    # call: both kernels carry that one time
    out = {"flash_attn_bwd_dq": {
        "max_abs_err": errs["dq"], "ms": dq_ms, "device_ms":
        dev["flash_attn_bwd_dq"], "plain_ms": plain_ms, "bound_ms": dq_bound[0],
        "bound_by": dq_bound[1], "library_ms": lib_ms},
        "flash_attn_bwd_dkv": {
        "max_abs_err": max(errs["dk"], errs["dv"]), "ms": dkv_ms,
        "device_ms": dev["flash_attn_bwd_dkv"], "plain_ms": plain_ms,
        "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
        "library_ms": lib_ms}}
    del q, k, v, do, o, lse, delta, dq, dk, dv, args, leaves
    torch.cuda.empty_cache()
    return out


def attention_bwd_phase(gpu: str) -> dict:
    """The two backward kernels against `mha_bwd_reference` on the same
    inputs (the kernels' own forward output and LSE among them): the main
    paths' and the UNet's shapes, timed, then the tile-edge sweep."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    main, runs = {}, {}
    for shape, nk, kv_len in BWD_CASES:
        for dt_name in ("float32", "bfloat16"):
            got = bwd_case(gen, shape, nk, kv_len, dt_name, gpu, runs)
            if (shape, nk, kv_len, dt_name) == BWD_MAIN_CASE:
                main.update(got)
    attention_bwd_edge_cases(runs)
    dq_narrow_cases(runs)
    main["flash_attn_bwd_short"] = short_bwd_cases(runs)
    autograd_check()
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        main[name]["instantiations"] = [
            {"name": kernel, **run} for kernel, run in sorted(runs.items())
            if kernel.startswith(name + "_")]
    return main


def attention_bwd_edge_cases(runs: dict) -> None:
    """Both backward kernels on the edges of their tiles (128 resident rows
    a block and 64 a warpgroup, or 64 a split block; 64-row streamed
    tiles), through strided views of one qkv buffer as the models hand them
    over, against `mha_bwd_reference` (the sweeps of `edge_sweeps`). The
    error is relative to the largest of the three reference gradients' max
    abs: at N = 1, dQ and dK are zero up to rounding (P = 1, dP = delta),
    so a ratio to their own max abs would measure only that rounding."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        bwd_instantiations, flash_attn_bwd_dkv, flash_attn_bwd_dq, mha,
        mha_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, h = 2, 2
    for dt_name, d, cases in edge_sweeps():
        dtype = getattr(torch, dt_name)
        worst, bad, dead, unequal = 0.0, [], 0.0, 0
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
            again = (flash_attn_bwd_dq(*args, **kw),   # the same bits
                     *flash_attn_bwd_dkv(*args, **kw))
            unequal += sum(not torch.equal(a, r)
                           for a, r in zip(outs, again))
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
        check(not bad and dead == 0.0 and not unequal,
              f"flash_attn_bwd {dt_name} d={d} on {len(cases)} tile-edge "
              f"cases (N in {list(EDGE_NS)}, kv_len N-1 and N-70, 4096 x 77): "
              f"max abs {worst:.3e} of the largest reference gradient <= "
              f"{TOL[dt_name]}; rows >= kv_len of dK and dV exactly 0 (max "
              f"{dead}); a second run of dQ and dK/dV bit-identical "
              f"({unequal} of {3 * len(cases)} differ)"
              + (f"; failing (Nq, Nk, kv_len, err): {bad}" if bad else ""))


# dQ at d = 40 (boxes of d columns) at a cut-down DepthFM training shape:
# self-attention with a ragged kv_len, onto 77 keys of which 70 live (K and
# V narrow), onto 31 keys (under half a streamed tile: 64-column K and V
# boxes): (q shape, Nk, kv_len)
DQ_NARROW_CASES = [((2, 8, 1000, 40), 1000, 990), ((2, 8, 1000, 40), 77, 70),
                   ((2, 8, 1000, 40), 31, None)]


def dq_narrow_cases(runs: dict) -> None:
    """dQ at d = 40 on DQ_NARROW_CASES against `mha_bwd_reference`, its
    error relative to the reference dQ's max abs; each call's profiled
    kernel must be the instantiation `bwd_instantiations` names."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        bwd_instantiations, flash_attn_bwd_dq, mha, mha_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(15)
    worst, bad, calls, wants = 0.0, [], [], []
    for (b, h, nq, d), nk, kv_len in DQ_NARROW_CASES:
        q, do = (torch.randn((b, nq, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        if kv_len is not None and nq == nk:
            do[:, :, kv_len:] = 0   # padded query rows carry no cotangent
        o, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        kw = {"sm_scale": d ** -0.5, "kv_len": kv_len}
        dq = flash_attn_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ref = mha_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                lse, do.float(), **kw)[0]
        err = ((dq.float() - ref).abs().max() / ref.abs().max()).item()
        want = bwd_instantiations(torch.bfloat16, d)[0]
        if not err <= TOL["bfloat16"]:
            bad.append(((b, h, nq, d), nk, kv_len, err))
        worst = max(worst, err)
        calls.append(lambda args=(q, k, v, do, lse, delta), kw=kw:
                     flash_attn_bwd_dq(*args, **kw))
        wants.append(want)
        run = runs.setdefault(want, {"cases": 0, "max_rel_err": 0.0,
                                     "timed": []})
        run["cases"] += 1
        run["max_rel_err"] = max(run["max_rel_err"], err)
    ran = launched_kernels(calls, "flash_attn_bwd_dq_")
    if ran != wants:
        bad.append(("profiled", ran, "wanted", wants))
    check(not bad,
          f"flash_attn_bwd dq bf16 d=40 on boxes of d columns, "
          f"{len(DQ_NARROW_CASES)} cases (self with kv_len N-10, onto 77 "
          f"keys of which 70 live, onto 31 keys): max abs {worst:.3e} of "
          f"the reference's max abs <= {TOL['bfloat16']}; each call's "
          f"profiled kernel the table's instantiation"
          + (f"; failing (q, Nk, kv_len, err): {bad}" if bad else ""))


# the bf16 backward onto a short key set (kv_len <= SHORT_KEYS: dQ, dK and dV
# in one pass, then the sum of the blocks' partial dK and dV) through the
# gradient's route at the UNet's head dims under a ragged Nq, on 64 heads,
# so that a block takes several tiles (its Q / dO and P / dS rings wrap, and
# its partial dK, dV sum over them) and both score warpgroups run: onto 1,
# 16 and 17 keys (the two key tiles), 77, 80 (the cut) and 81 (past it: the
# pair); DepthFM training's cross-attentions at batch 8 and 4 (d = 80 at
# 1024 tokens, d = 160 at 256); the mid block's 64-token self-attention,
# and padded (kv_len < Nq); keys past kv_len; a negative scale; the last
# four one tile a block: (q shape, Nk, kv_len, sm_scale)
SHORT_BWD_CASES = [((8, 8, 999, d), nk, None, None) for d in (40, 80, 160)
                   for nk in (1, 16, 17, 77, 80, 81)] + [
                       ((b, 8, n, d), 77, None, None) for b in (8, 4)
                       for n, d in ((1024, 80), (256, 160))] + [
                       ((8, 8, 64, 160), 64, None, None),
                       ((2, 4, 64, 160), 64, 50, None),
                       ((2, 4, 64, 40), 96, 80, None),
                       ((2, 4, 300, 80), 77, None, -0.3)]
# the kernels-line shape: DepthFM training's [8,8,4096,40] onto 77 keys
SHORT_BWD_MAIN_CASE = ((8, 8, 4096, 40), 77)


def err_of(outs, refs, one_key: bool = False) -> list:
    """The max abs error of each of dQ, dK, dV `outs` against float32
    `refs`, relative to that reference's max abs; `one_key`: relative to
    the largest of the three (onto one key P = 1 and dP - delta = 0, so
    dQ and dK are 0 up to rounding)."""
    tops = [r.abs().max().item() for r in refs]
    return [(a.float() - r).abs().max().item() / (max(tops) if one_key
                                                   else top)
            for a, r, top in zip(outs, refs, tops)]


def short_bwd_cases(runs: dict) -> dict:
    """The gradient's route (`_attn_backward`, as `mha`'s autograd runs it)
    on SHORT_BWD_CASES against `mha_bwd_reference`, with phase 3's
    backward bar (each gradient's error relative to its own reference's
    max abs, as `bwd_case` holds it; onto one key, where P = 1 and dQ, dK
    are 0 up to rounding, to the largest gradient's), each case twice and
    bit-identical, rows of dK and dV past kv_len exactly 0; each
    call's profiled kernels those `bwd_instantiations(..., kv_len=)` names
    (the sum only where a head's tiles span several blocks); then the
    short route timed at SHORT_BWD_MAIN_CASE beside the pair, the plain
    version and SDPA's backward. Returns the kernels-line entry."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops import flash_attention as fa
    from amodal_depth_anything_tpu_torch.tools.head_dim_times import \
        device_times

    gen = torch.Generator(device="cuda").manual_seed(16)
    worst, bad, calls, wants = 0.0, [], [], []
    for (b, h, nq, d), nk, kv_len, scale in SHORT_BWD_CASES:
        q, do = (torch.randn((b, nq, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        if kv_len is not None and nq == nk:
            do[:, :, kv_len:] = 0   # padded query rows carry no cotangent
        kv = kv_len or nk
        sc = d ** -0.5 if scale is None else scale
        o, lse = fa.mha(q, k, v, kv_len=kv, sm_scale=sc, return_lse=True)
        args = (q, k, v, o, lse, do, sc, kv)
        outs = fa._attn_backward(*args)
        again = fa._attn_backward(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, r) for a, r in zip(outs, again))
        refs = fa.mha_bwd_reference(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), sm_scale=sc,
                                    kv_len=kv)
        err = max(err_of(outs, refs, one_key=kv == 1))
        dead = max(outs[1][:, :, kv:].abs().max().item(),
                   outs[2][:, :, kv:].abs().max().item()) if kv < nk else 0.0
        if not (err <= TOL["bfloat16"] and same and dead == 0.0):
            bad.append(((b, h, nq, d), nk, kv_len, scale, err, same, dead))
        worst = max(worst, err)
        want = fa.bwd_instantiations(torch.bfloat16, d, kv_len=kv)
        run = runs.setdefault(want[0], {"cases": 0, "max_rel_err": 0.0,
                                        "timed": []})
        run["cases"] += 1
        run["max_rel_err"] = max(run["max_rel_err"], err)
        if kv <= fa.SHORT_KEYS:
            slabs = fa._entry("flash_attn_bwd_short_slabs")(d, kv, nq, h, b)
            want = want[:1] if slabs == 1 else want
        calls.append(lambda args=args: fa._attn_backward(*args))
        wants += list(want)
    ran = launched_kernels(calls, "flash_attn_bwd_", expect=len(wants))
    if ran != wants:
        bad.append(("profiled", ran, "wanted", wants))
    check(not bad,
          f"flash_attn_bwd bf16 onto a short key set through the gradient's "
          f"route on {len(SHORT_BWD_CASES)} cases (d 40/80/160 onto 1, 16, "
          f"17, 77, {fa.SHORT_KEYS} and {fa.SHORT_KEYS + 1} keys under 999 "
          f"query rows, the mid block's 64 tokens, padded, keys past kv_len, "
          f"a negative scale): each gradient's max abs {worst:.3e} of its "
          f"reference's (onto one key: of the largest gradient's) <= "
          f"{TOL['bfloat16']}; each case twice bit-identical; "
          f"rows >= kv_len of dK and dV exactly 0; each call's profiled "
          f"kernels the table's"
          + (f"; failing (q, Nk, kv_len, scale, err, same, dead): {bad}"
             if bad else ""))

    # the kernels-line entry: the short route at DepthFM training's shape
    (b, h, nq, d), nk = SHORT_BWD_MAIN_CASE
    q, do = (torch.randn((b, h, nq, d), generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, lse = fa.mha(q, k, v, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args, kw = (q, k, v, do, lse, delta), {"sm_scale": d ** -0.5}
    outs = fa.flash_attn_bwd_short(*args, **kw)
    torch.cuda.synchronize()
    refs = fa.mha_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                lse, do.float())
    err = max((a.float() - r).abs().max().item() for a, r in zip(outs, refs))
    rel = max(err_of(outs, refs))
    del outs, refs
    flops = 10 * b * h * nq * nk * d
    nbytes = 2 * (3 * b * h * nq * d + 4 * b * h * nk * d) + 8 * b * h * nq
    bound_ms, bound_by = roofline(flops, nbytes, "bfloat16")
    ms = cuda_ms(lambda: fa.flash_attn_bwd_short(*args, **kw), 30)
    pair_ms = cuda_ms(lambda: (fa.flash_attn_bwd_dq(*args, **kw),
                               fa.flash_attn_bwd_dkv(*args, **kw)), 30)
    names = fa.bwd_instantiations(torch.bfloat16, d, kv_len=nk)
    times = device_times(lambda: fa.flash_attn_bwd_short(*args, **kw), 5)
    dev = {name: times.get(name) for name in names}
    dev_ms = sum(x for x in dev.values() if x is not None) or None
    pair_dev = all_device_ms(lambda: (fa.flash_attn_bwd_dq(*args, **kw),
                                      fa.flash_attn_bwd_dkv(*args, **kw)))
    plain_ms = cuda_ms(lambda: fa.mha_bwd_reference(q, k, v, o, lse, do), 2,
                       warmup=1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                 retain_graph=True), 30)
    lib_dev = all_device_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    gpu = card()
    print(f"  short bwd bf16 q {[b, h, nq, d]} Nk={nk}: {names[0]} + "
          f"{names[1]} {ms:.4f} ms (device {as_ms(dev_ms)}: {dev}), the pair "
          f"{pair_ms:.4f} ms (device {as_ms(pair_dev)}), plain "
          f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms (device "
          f"{as_ms(lib_dev)}), bound {bound_ms:.4f} ms ({bound_by}); max abs "
          f"{err:.3e} [{gpu}]", flush=True)
    check(rel <= TOL["bfloat16"],
          f"flash_attn_bwd_short at {[b, h, nq, d]} x {nk}: max abs "
          f"{err:.3e}, of dQ, dK and dV each at most {rel:.3e} of its "
          f"reference's max abs <= {TOL['bfloat16']}")
    del q, k, v, do, o, lse, delta, args, leaves, out
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_rel_err": worst, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "pair_ms": pair_ms,
            "pair_device_ms": pair_dev, "q": [b, h, nq, d], "nk": nk,
            "instantiations": [{"name": kernel, **run}
                               for kernel, run in sorted(runs.items())
                               if "short" in kernel]}


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
    from torch.profiler import ProfilerActivity, profile

    from amodal_depth_anything_tpu_torch.tools.head_dim_times import \
        device_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name: dict[str, list] = {}
    for name, ms in device_events(prof):
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += ms
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
    mha.launches = mha.short_launches = 0   # the main path starts here
    for _ in range(DEPTHFM_CALLS):
        t = time.perf_counter()
        depth = pipe(img, mask, obs)      # returns numpy: synchronised
        latencies.append(time.perf_counter() - t)
    launches = mha.launches               # ... and ends here
    short = mha.short_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == DEPTHFM_LAUNCHES * DEPTHFM_CALLS,
          f"bf16 DepthFM main path launched flash_attn_fwd {launches} times "
          f"({DEPTHFM_LAUNCHES * DEPTHFM_CALLS} = {DEPTHFM_LAUNCHES} per "
          f"call)")
    cross = DEPTHFM_LAUNCHES // 2 * DEPTHFM_CALLS   # onto the 77 keys
    check(cross <= short < launches,
          f"bf16 DepthFM main path: {short} of the launches went to the "
          f"short-key kernel (every cross-attention onto the 77 context "
          f"keys, {cross}, and self-attention over at most 80 tokens)")
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
    SHORT_LAUNCHES["depthfm"] = short
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
    trainer.step_timer = StepTimer(warmup=1)   # the first captures it
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
    captured_launches(launches, TRAIN_BLOCKS, "training")
    replay_launches(trainer, train_loader, TRAIN_BLOCKS, "vitl training")
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

    # the captured Adam step against its eager twin, two steps (the resume
    # is phase 14's, on the same trainer with adafactor)
    def make(captured):
        return get_trainer_cls(cfg.trainer.name)(
            tcfg, get_model(cfg.model.name, device="cuda",
                            **cfg.model.kwargs.to_dict()),
            None, device="cuda", seed=0, captured=captured)

    captured_step_phase("vitl adam train step", make,
                        capture_batches(trainer, scenes, n=2), gpu,
                        RESUME_CKPT, resume=False)

    # the remat modes on the card, forward + backward without the update:
    # launches of the forward kernel per step, time and peak memory (a
    # training batch: a step on it replays the captured program)
    batch8 = trainer._device_batch(next(iter(train_loader)))
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
                 "bf16 train step (replayed)", gpu)
    # the checkpoint phase 11 evaluates through `cli.eval`
    trainer.out_dir_ckpt = EVAL_CKPT
    t0 = time.time()
    trainer.save_checkpoint("latest")
    print(f"  saved the trainer's checkpoint for phase 11 in "
          f"{time.time() - t0:.1f} s", flush=True)

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


def cudnn_reading(trainer, batch, what: str, gpu: str) -> None:
    """What the trainer's deterministic cuDNN costs and buys: forward +
    backward without the update, eagerly, with `cudnn.deterministic` on
    (as the trainer sets it on the card) and off, in turns, and whether two
    runs off give the same gradients. A reading, printed."""
    import torch

    ms = {True: [], False: []}
    same = None
    for det in (True, False, False, True):
        torch.backends.cudnn.deterministic = det
        trainer.loss_and_grads(batch)
        ms[det].append(cuda_ms(lambda: trainer.loss_and_grads(batch), 2,
                               warmup=0))
        if not det and same is None:
            g1 = trainer.loss_and_grads(batch)[1]
            g2 = trainer.loss_and_grads(batch)[1]
            same = all(torch.equal(g1[k], g2[k]) for k in g1)
            del g1, g2
    torch.backends.cudnn.deterministic = True
    print(f"  {what}: eager forward + backward with deterministic cuDNN "
          f"{[round(x, 1) for x in ms[True]]} ms, without "
          f"{[round(x, 1) for x in ms[False]]} ms (two runs without give "
          f"{'the same' if same else 'different'} gradients) [{gpu}]",
          flush=True)


def captured_launches(launches: dict, per_step, what: str) -> None:
    """The counters of a `train()` whose steps are captured: each kernel's
    launches of one step (`per_step`, or `per_step[name]`) at the
    capture's warm-up and the capture itself (the Python counters count
    those; a replay counts none)."""
    from amodal_depth_anything_tpu_torch.utils.graphs import WARMUP_CALLS

    for name, count in launches.items():
        want = per_step[name] if isinstance(per_step, dict) else per_step
        check(count == want * (WARMUP_CALLS + 1),
              f"{what} counted {name} {count} times: {want} a step at "
              f"the capture's {WARMUP_CALLS} warm-up steps and the capture "
              f"(replays launch it from the graph)")


def replay_launches(trainer, loader, per_step, what: str) -> None:
    """One more captured step, traced: the attention kernels' launches in
    the replay's trace (`per_step` each, or as `per_step` names them),
    printed. A reading, not a check: the profiler has dropped a graph
    node's event now and then."""
    batch = trainer._device_batch(next(iter(loader)))
    _, _, got = trace_call(lambda: float(trainer._train_step(batch)), names=(
        "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
        "flash_attn_bwd_bf16", "flash_attn_bwd_short"))   # the short route
    print(f"  {what}: a traced replay of the captured step shows {got} "
          f"launches ({per_step} launched)", flush=True)


def trainer_like(_loader=None):
    """What `capture_batches` needs of a trainer: `_device_batch` onto the
    card."""
    import torch

    class _Cuda:
        @staticmethod
        def _device_batch(batch):
            return {k: torch.from_numpy(v).cuda() for k, v in batch.items()
                    if isinstance(v, np.ndarray) and v.dtype != object}
    return _Cuda()


def capture_batches(trainer, dataset, n: int = CAPTURE_STEPS,
                    batch_size: int = TRAIN_BATCH) -> list:
    """`n` device batches of `batch_size` from `dataset`."""
    from amodal_depth_anything_tpu_torch.data import DataLoader

    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        drop_last=True, seed=1)
    out = []
    epoch = 0
    while len(out) < n:
        loader.set_epoch(epoch)
        out += [trainer._device_batch(b) for b in loader][:n - len(out)]
        epoch += 1
    return out


def trainer_state(trainer, copy: bool = True) -> list:
    """Every tensor a train step changes, in a fixed order: the model's
    state dict (parameters and BatchNorm statistics), the optimizer state
    and the step's device scalars; copied where they lie (on the card: no
    trip through the host), or (`copy=False`) the live tensors."""
    out = list(trainer.model.state_dict().values())
    for key in sorted(trainer.state.opt_state):
        value = trainer.state.opt_state[key]
        if isinstance(value, list):
            out += value
    out += list((trainer._scalars or {}).values())
    return [v.detach().clone() if copy else v.detach() for v in out]


def captured_step_phase(what: str, make, batches: list, gpu: str,
                        ckpt: str, resume: bool = True,
                        cudnn: bool = False) -> dict:
    """The captured train step against the eager one: two trainers from one
    init (`make(captured=...)`), `len(batches)` steps each on the same device
    batches; losses, parameters, BatchNorm statistics, optimizer state and
    device scalars bit-identical. Then (`resume`) a resume under capture:
    the captured trainer saved after two steps, a fresh captured trainer
    loading it and taking the rest, bit-identical to the unbroken run;
    (`cudnn`) `cudnn_reading` on the eager trainer. Then the captured
    step's p50 over the steps after the first, one profiled replay (device
    busy, launches by kernel) and peak memory (less the eager trainer's
    state, held on the card meanwhile for the comparison). Returns {p50_ms,
    busy_pct, peak_gib, launches: {kernel: per replay}, eager_p50_ms,
    eager_peak_gib}."""
    import torch

    def timed(trainer):
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer._train_step(b)))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    torch.cuda.reset_peak_memory_stats()
    eager = make(captured=False)
    eager_losses, eager_ms = timed(eager)
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    held = torch.cuda.memory_allocated()
    eager_state = trainer_state(eager)
    held = torch.cuda.memory_allocated() - held   # the copies' bytes
    if cudnn:
        cudnn_reading(eager, batches[0], what, gpu)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cap = make(captured=True)
    cut = 2
    losses, ms = [], []
    for i, b in enumerate(batches):
        if i == cut and resume:
            cap.out_dir_ckpt = ckpt
            cap.save_checkpoint("resume")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(cap._train_step(b)))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    live = trainer_state(cap, copy=False)
    same = [torch.equal(a, b) for a, b in zip(eager_state, live)]
    n_state = len(eager_state)
    del eager_state
    cap_state = trainer_state(cap) if resume else None
    check(losses == eager_losses and all(same) and len(live) == n_state
          and len(same) == n_state,
          f"{what}: {len(batches)} captured steps bit-identical to eager "
          f"ones (losses {[round(x, 6) for x in losses]}; {sum(same)} of "
          f"{len(same)} state tensors equal)")
    del live
    wall, busy, counts = trace_call(
        lambda: float(cap._train_step(batches[-1])),
        names=("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
               "*"))
    total = counts.pop("*")
    del cap
    gc.collect()
    torch.cuda.empty_cache()
    if not resume:
        return _captured_summary(what, ms, eager_ms, wall, busy, total,
                                 counts, peak, eager_peak, gpu)
    resumed = make(captured=True)
    resumed.load_checkpoint(os.path.join(ckpt, "resume"))
    check(resumed.state.step == cut, f"{what}: resumed at step {cut}")
    rest = [float(resumed._train_step(b)) for b in batches[cut:]]
    got = trainer_state(resumed, copy=False)
    same = [torch.equal(a, b) for a, b in zip(cap_state, got)]
    check(rest == losses[cut:] and all(same),
          f"{what}: save after {cut} captured steps -> load -> "
          f"{len(batches) - cut} more, bit-identical to the unbroken run "
          f"({sum(same)} of {len(same)} state tensors equal)")
    del resumed, got, cap_state
    shutil.rmtree(os.path.join(ckpt, "resume"), ignore_errors=True)
    return _captured_summary(what, ms, eager_ms, wall, busy, total, counts,
                             peak, eager_peak, gpu)


def _captured_summary(what, ms, eager_ms, wall, busy, total, counts, peak,
                      eager_peak, gpu) -> dict:
    """`captured_step_phase`'s printed line and returned numbers."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    p50 = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
    e50 = float(np.median(eager_ms[1:])) if len(ms) > 1 else eager_ms[0]
    pct = None if busy is None else 100 * busy / wall
    print(f"  {what}: captured step p50 {p50:.1f} ms (eager {e50:.1f} ms) "
          f"over {[round(x, 1) for x in ms]} / "
          f"{[round(x, 1) for x in eager_ms]} ms; one profiled replay: "
          f"wall {wall:.1f} ms, device busy {as_ms(busy)} "
          f"({'not measured' if pct is None else f'{pct:.1f}%'}), {total} "
          f"device events, attention {counts}; peak memory "
          f"{peak:.2f} GiB captured, {eager_peak:.2f} GiB eager [{gpu}]",
          flush=True)
    return {"p50_ms": p50, "eager_p50_ms": e50, "busy_pct": pct,
            "peak_gib": peak, "eager_peak_gib": eager_peak,
            "launches": counts, "kernels": total}


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
        return (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches,
                mha.bwd_short_launches)

    def zero_counts():
        mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
        mha.bwd_short_launches = 0

    def build(path, steps, loader, val_loader, captured=None):
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
            captured=captured, **trainer_kwargs_from_cfg(cfg))
        trainer.step_timer = StepTimer(warmup=1)   # the first captures it
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
    captured_launches(dict(zip(UNET_BWD, launches)), UNET_BWD,
                      "DepthFM training (16 self + 16 cross a step; the "
                      "backward onto <= 80 keys short)")
    replay_launches(trainer, loader, UNET_BWD, "DepthFM training")
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
    # (a training batch: a step on it replays the captured program)
    batch8 = trainer._device_batch(next(iter(loader)))
    for remat, want in ((True, 2), ("attn", 1)):   # ends at the recipe's
        trainer.cfg.remat = remat
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        ms = cuda_ms(lambda: trainer.loss_and_grads(batch8), 1, warmup=0)
        got = counts()
        per = (want * UNET_ATTN, UNET_BWD["dq"], UNET_BWD["dkv"],
               UNET_BWD["short"])
        check(got == per,
              f"DepthFM remat={remat!r}: fwd, dq, dkv, short backward "
              f"launches {got} per step {per}")
        print(f"  DepthFM remat={remat!r}: forward + backward {ms:.1f} ms, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              f"GiB [{gpu}]", flush=True)
    prof = profile_call(lambda: float(trainer._train_step(batch8)),
                        "bf16 DepthFM train step (replayed)", gpu)
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
    # (the resume under capture is phase 14's vitg and phase 11's
    # ADDeepLab, whose trainer keeps Adam's state as this one does)
    captured_step_phase(
        "DepthFMAmodal train step",
        lambda captured: build(DEPTHFM_TRAIN_CONFIG, 1, None, None,
                               captured)[2],
        capture_batches(trainer_like(loader), scenes), gpu, RESUME_CKPT,
        resume=False)

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
          and bool(np.isfinite(ddpm_losses).all()) and min(ddpm_losses) > 0,
          f"{DDPM_TRAIN_STEPS} DDPM train steps: losses "
          f"{[round(x, 5) for x in ddpm_losses]} finite and positive; "
          f"peak memory {ddpm_peak:.2f} GiB [{gpu}]")
    captured_launches(dict(zip(UNET_BWD, ddpm_launches)), UNET_BWD,
                      "DDPM training")
    results = trainer.validate()
    bank = results[scenes.disp_name]
    values = [bank[b][m] for b in ("overall", "align_overall")
              for m in tcfg.eval_metrics]
    check(len(values) == 20 and bool(np.isfinite(values).all()),
          f"DepthFMTrainer validate() over 1 batch of {TRAIN_BATCH} (DDIM, 4 "
          f"steps): 10 metrics x (raw, aligned) finite; abs_rel aligned "
          f"{bank['align_overall']['abs_relative_difference']:.4f}")
    # its captured step against an eager twin: the DepthFMAmodal step above
    # holds the same UNet update's
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attn_fwd": launches[0], "flash_attn_bwd_dq": launches[1],
            "flash_attn_bwd_dkv": launches[2],
            "flash_attn_bwd_short": launches[3], "ddpm": ddpm_launches}


def trace_call(fn, names=("flash_attn_fwd",), spent: dict | None = None):
    """One call of `fn` (which must end synchronised) under torch.profiler:
    (wall ms, device-busy ms, {name: launches}) with device busy the sum of
    every kernel and copy event (None when the profiler recorded no device
    time) and the launches those of each kernel whose name holds `name`;
    the kernel nodes of a replayed CUDA graph count as launches; the name
    "*" counts every device event. `spent`, if given, receives each name's
    device ms."""
    from torch.profiler import ProfilerActivity, profile

    from amodal_depth_anything_tpu_torch.tools.head_dim_times import \
        device_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy, seen, counts = 0.0, False, {name: 0 for name in names}
    for event, ms in device_events(prof):
        seen = True
        busy += ms
        for name in names:
            hit = name == "*" or name + "_" in event
            counts[name] += hit
            if hit and spent is not None:
                spent[name] = spent.get(name, 0.0) + ms
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
        spent = {}
        wall, busy, counts = trace_call(fn, spent=spent)
        row = {"images_per_s": batch * SERVE_CALLS / sum(lat),
               "p50_ms": float(np.median(lat)) * 1e3, "peak_gib": peak,
               "wall_ms": wall, "busy_ms": busy,
               "launches": counts["flash_attn_fwd"],
               "attention_ms": spent.get("flash_attn_fwd")}
        rows[label] = row
        share = "not measured" if busy is None else \
            f"{busy:.1f} ms ({100 * busy / wall:.1f}% of the wall)"
        print(f"  {what} {label}: {row['images_per_s']:.3f} images/s, p50 "
              f"{row['p50_ms']:.1f} ms, latencies "
              f"{[round(x * 1e3, 1) for x in lat]} ms, peak allocated "
              f"{peak:.2f} GiB; one profiled call: wall {wall:.1f} ms, "
              f"device busy {share}, {row['launches']} flash_attn_fwd "
              f"launches ({as_ms(row['attention_ms'])}) [{gpu}]", flush=True)
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


def serve_cli_check(gpu: str, state: str, body: bytes, want,
                    extra: tuple = ()) -> None:
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
         "--max_batch", str(FULL_BATCH), *extra],
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
        what = " ".join(("cli.serve --serving_state",) + extra[:1])
        check("serving on" in line and "CUDA graph" in line,
              f"{what} on the card serves a CUDA graph: {line.strip()!r}")
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
        print(f"  {what} subprocess: up in {up:.1f} s (process start, "
              f"state read, capture), one POST in {ms:.1f} ms [{gpu}]",
              flush=True)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def batch_rows_phase(pipe, served, img, mask, gpu: str) -> None:
    """Batch-row invariance of the served bf16 program: one input in every
    row of the bucket gives the same bits in every row, eagerly and
    replayed, and a direct call at batch 1 gives those bits too (the JAX
    server's contract). Then the price of the route: the replay's p50 with
    the DPT heads one row at a time (served) against the heads over the
    whole batch (a capture of `amodal_depth_graph` with
    head_batch_tile=None), in turns."""
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        amodal_depth_graph
    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        CapturedAmodalServing

    one = np.repeat(img[:1], FULL_BATCH, 0), np.repeat(mask[:1], FULL_BATCH,
                                                       0)
    direct = pipe(one[0][:1], one[1][:1])
    for label, fn in (("eager", pipe), ("replay", served)):
        outs = fn(*one)
        rows = [max(float(np.abs(o[b] - o[0]).max()) for o in outs)
                for b in range(FULL_BATCH)]
        batch1 = max(float(np.abs(o[0] - d[0]).max())
                     for o, d in zip(outs, direct))
        check(max(rows) == 0.0 and batch1 == 0.0,
              f"bf16 {label} at batch {FULL_BATCH}: one input in every row "
              f"gives the same bits in every row (max abs to row 0: {rows}) "
              f"and those of a direct call at batch 1 (max abs {batch1})")

    def untiled(b):
        def fn(image, m):
            base, blended = amodal_depth_graph(
                pipe.raw_model, pipe.amodal_model, image, m, size=pipe.size,
                attn_impl=pipe.attn_impl, head_batch_tile=None)
            return base.float(), blended.float()
        return fn

    before = capture(lambda: CapturedAmodalServing(
        device=pipe.device, dtype=pipe.dtype, size=pipe.size,
        batches=FULL_BATCH, hw=served.hw, names=["image", "mask"],
        make_fn=untiled), "vitg + vitl bf16, heads over the whole batch")
    lat = {"whole batch": [], "one row": []}
    for label, fn in (("whole batch", before), ("one row", served),
                      ("one row", served), ("whole batch", before)):
        for _ in range(SERVE_CALLS):
            t = time.perf_counter()
            fn(img, mask)
            lat[label].append((time.perf_counter() - t) * 1e3)
    outs = before(*one)
    spread = max(float(np.abs(o[b] - o[0]).max()) for o in outs
                 for b in range(FULL_BATCH))
    print(f"  batch-row route priced on the replay, bf16 batch "
          f"{FULL_BATCH}: heads over the whole batch p50 "
          f"{np.median(lat['whole batch']):.2f} ms (rows of one input "
          f"differ by up to {spread:.4g}), one row at a time p50 "
          f"{np.median(lat['one row']):.2f} ms [{gpu}]", flush=True)


def depthfm_artifact(dfm, img, mask, obs, hw, gpu: str):
    """(e) DepthFM's program exported by `save_depthfm_artifact` at the
    phase's bucket, at ARTIFACT_DFM_STEPS Euler steps (the export's time
    grows with the program's length; the code path is the same at any
    count), with meta.json, seconds and bytes; and the in-process capture
    at that count, whose output on (img, mask, obs) the fresh process must
    give. Returns (artifact dir, that output)."""
    from amodal_depth_anything_tpu_torch.pipeline.aot import (
        capture_depthfm_program, save_depthfm_artifact)

    path = os.path.join(BUILD, "artifact_smoke_depthfm")
    shutil.rmtree(path, ignore_errors=True)
    steps, dfm.num_steps = dfm.num_steps, ARTIFACT_DFM_STEPS
    try:
        t0 = time.time()
        meta = save_depthfm_artifact(dfm, path, batches=(DEPTHFM_BATCH,),
                                     hw=hw)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        print(f"  DepthFM artifact ({ARTIFACT_DFM_STEPS} Euler step): batch "
              f"{DEPTHFM_BATCH} at {hw}, exported in "
              f"{meta['export_seconds']} s ({time.time() - t0:.1f} s with "
              f"meta), {size / 1e6:.1f} MB on disk; meta "
              f"{ {k: meta[k] for k in ARTIFACT_META} } csrc "
              f"{meta['csrc_sha256'][:12]} [{gpu}]", flush=True)
        want = capture_depthfm_program(dfm, batch=DEPTHFM_BATCH, hw=hw)(
            img, mask, obs)
    finally:
        dfm.num_steps = steps
    return path, want


def replica_start(amodal_dir: str, amodal_in, dfm_dir: str, dfm_in):
    """(e) Start the fresh process (`ARTIFACT_CHILD`) that loads both
    artifacts, binds them to the same seeded weights built there, captures
    and replays them on the same inputs. Returns (process, its I/O dir,
    start time); `replica_finish` waits for it."""
    root = os.path.join(BUILD, "artifact_smoke_io")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for name, a in (("a_img", amodal_in[0]), ("a_mask", amodal_in[1]),
                    ("d_img", dfm_in[0]), ("d_mask", dfm_in[1]),
                    ("d_obs", dfm_in[2])):
        np.save(os.path.join(root, name + ".npy"), a)
    proc = subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_CHILD, root, amodal_dir, dfm_dir,
         str(SIZE), str(DEPTHFM_SIZE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, root, time.time()


def replica_finish(started, amodal_want, dfm_want, gpu: str) -> None:
    """(e) The fresh process's replays bit-identical to the in-process
    captures."""
    proc, root, t0 = started
    try:
        out, _ = proc.communicate(timeout=900)
        seconds = time.time() - t0
        check(proc.returncode == 0,
              f"artifact replica process exited {proc.returncode}: "
              f"{out.strip()[-1500:]}")
        if proc.returncode != 0:
            return
        lines = [ln for ln in out.splitlines() if "artifact:" in ln]
        print("  " + "; ".join(lines) + f" [{gpu}]", flush=True)
        for name, want in (("amodal", amodal_want), ("depthfm", dfm_want)):
            got = np.load(os.path.join(root, f"{name}_out.npz"))
            same = [np.array_equal(got[f"o{i}"], o)
                    for i, o in enumerate(want)]
            check(all(same),
                  f"{name} artifact loaded, bound and replayed in a fresh "
                  f"process ({seconds:.1f} s for both): bit-identical to the "
                  f"in-process capture ({same})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


# the fresh process of `artifact_replica_check`: the seeded pipelines built
# anew (their weights), the artifacts loaded and bound to them, captured and
# replayed; outputs written beside the inputs
ARTIFACT_CHILD = """
import os, sys, time
import numpy as np, torch
from amodal_depth_anything_tpu_torch.pipeline import (
    AmodalDepthPipeline, DepthFMPipeline, ExportedAmodalServing,
    ExportedDepthFMServing)
root, amodal_dir, dfm_dir = sys.argv[1:4]
size, dsize = map(int, sys.argv[4:6])
def load(name):
    return np.load(os.path.join(root, name + ".npy"))
pipe = AmodalDepthPipeline.init_random(
    0, encoder="vitl", base_encoder="vitg", size=size, device="cuda",
    dtype=torch.bfloat16)
t = time.time()
h = ExportedAmodalServing.load(amodal_dir).bind(
    pipe.raw_model.state_dict(), pipe.amodal_model.state_dict())
print(f"amodal artifact: load + bind + capture {time.time() - t:.1f} s")
outs = h(load("a_img"), load("a_mask"))
np.savez(os.path.join(root, "amodal_out.npz"),
         **{f"o{i}": o for i, o in enumerate(outs)})
del h, pipe
torch.cuda.empty_cache()
dfm = DepthFMPipeline.init_random(0, tiny=False, size=dsize, device="cuda",
                                  dtype=torch.bfloat16)
t = time.time()
h = ExportedDepthFMServing.load(dfm_dir).bind(dfm.model.state_dict())
print(f"DepthFM artifact: load + bind + capture {time.time() - t:.1f} s")
np.savez(os.path.join(root, "depthfm_out.npz"),
         o0=h(load("d_img"), load("d_mask"), load("d_obs")))
"""
ARTIFACT_META = ("device", "arch", "torch_version", "cuda_version", "dtype")
ARTIFACT_DFM_STEPS = 1


def serving_phase(gpu: str) -> dict:
    """Serving at full width: (a) vitg + vitl at 518 px and (b) DepthFM at
    512 px, 4 steps, each bf16 batch 4 captured as a CUDA graph and held
    against its eager call; (b) also DeepCache (2, 2) replayed, with its
    quality delta against the exact replay; (c) HTTP: the captured amodal
    handle behind `cli.serve.build_server`, 16 POSTs from 8 threads of
    textured PNGs filtered as PIL filters them (Paeth rows); (d) the
    phase-(a) pipeline's serving state saved, served by `cli.serve
    --serving_state` in a subprocess (one POST), exported by `cli.serve
    --export_artifact` (a subprocess started after (a)) and served by
    `cli.serve --artifact` (one POST), restored and captured again,
    bit-identical; (e) the artifacts replayed in a fresh process. Returns
    the replays' traced launch counts."""
    import torch

    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        capture_amodal_program

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
    batch_rows_phase(pipe, served, img, mask, gpu)
    # the serving state of (d), saved now so that `cli.serve
    # --export_artifact` on it runs beside (b) and (c)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "serving_state_smoke")
    art = os.path.join(os.path.dirname(path), "artifact_cli_smoke")
    for d in (path, art):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    pipe.save_serving(path)
    write_s = time.time() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(path) for f in files)
    export_t0 = time.time()
    export = subprocess.Popen(
        [sys.executable, "-m", "amodal_depth_anything_tpu_torch.cli.serve",
         "--serving_state", path, "--max_batch", str(FULL_BATCH),
         "--export_artifact", art], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        return _serving_rest(gpu, pipe, served, amodal, img, mask, obs, hw,
                             rng, path, art, write_s, nbytes, export,
                             export_t0)
    finally:
        if export.poll() is None:
            export.kill()
            export.wait()
        for d in (path, art):
            shutil.rmtree(d, ignore_errors=True)


def _serving_rest(gpu, pipe, served, amodal, img, mask, obs, hw, rng, path,
                  art, write_s, nbytes, export, export_t0) -> dict:
    """Phase 9 (b)-(e), while `cli.serve --export_artifact` runs."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import contextlib

    import torch

    from amodal_depth_anything_tpu_torch import native
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
    dfm_dir, dfm_want = depthfm_artifact(dfm, img, mask, obs, hw, gpu)
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
    decode_ms = {}
    for route in ("native", "numpy"):
        with (native.plain_route() if route == "numpy"
              else contextlib.nullcontext()):
            t = time.perf_counter()
            decode_png(png)
            decode_ms[route] = (time.perf_counter() - t) * 1e3
    print(f"  request images {hw[1]}x{hw[0]} RGB, rows filtered None/Sub/Up/"
          f"Average/Paeth {rows.tolist()}; one image PNG ({len(png)} bytes) "
          f"decoded on the host in {decode_ms['native']:.1f} ms (native "
          f"codec), {decode_ms['numpy']:.1f} ms (numpy)", flush=True)
    def http_run():
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

        before = server.batcher.dispatches
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results, server.batcher.dispatches - before

    # both host routes over one server: the native host library (codec and
    # resizes in C++, the GIL released) and the numpy plain versions
    runs = {}
    try:
        runs["native"] = http_run()
        with native.plain_route():
            runs["numpy"] = http_run()
    finally:
        server.shutdown()
        server.batcher.close()
    results = runs["native"][0]
    for route, (res_, _) in runs.items():
        codes = [r[0] if r else None for r in res_]
        check(codes == [200] * SERVE_REQUESTS,
              f"HTTP ({route} host route): {SERVE_REQUESTS} POSTs from "
              f"{SERVE_CLIENTS} threads all answered 200 ({codes})")
    same = all(a is not None and b is not None and a[1] == b[1]
               for a, b in zip(runs["native"][0], runs["numpy"][0]))
    check(same, "HTTP: the native and the numpy host routes answered every "
                "request with the same bytes")
    # a direct call with the request in every row of the batch: every row
    # gives the same bits (`batch_rows_phase`); the spread is printed
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
    check(worst <= 1.0 / 65535 + 1e-3 and spread == 0.0,
          f"HTTP depth vs a direct call of the handle: max abs {worst:.3e} "
          f"<= one uint16 step + 1e-3; the rows of one input differ by "
          f"{spread:.3e} (0)")
    square_in = [np.stack(a) for a in zip(*(
        _prep(images[i], masks[i], SIZE) for i in range(FULL_BATCH)))]
    square_want = square(*square_in)
    del square
    req = json.loads(bodies[0])
    for route, (res_, dispatches) in runs.items():
        lat = [r[2] for r in res_ if r]
        print(f"  HTTP, {route} host route: {SERVE_REQUESTS} requests, "
              f"{dispatches} dispatches, per-request p50 "
              f"{np.median(lat) * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}, "
              f"max {max(lat) * 1e3:.1f}) [{gpu}]", flush=True)
        # one request's host work alone, stage by stage, as the handler
        # does it
        stages = {}
        with (native.plain_route() if route == "numpy"
              else contextlib.nullcontext()):
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
        print(f"  one request's host work alone, {route} host route: "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
              + f"; {sum(stages.values()):.1f} ms in all [{gpu}]",
              flush=True)

    print("  (d) serving state", flush=True)
    # the plain server starts beside the wait for the export and the
    # artifact's server
    plain = beside(serve_cli_check, gpu, path, bodies[0], first)
    try:
        _serving_artifact(gpu, path, bodies, first, export, export_t0, art,
                          square_in, square_want, dfm_dir, img, mask, obs,
                          dfm_want)
    finally:
        plain.join()
    t0 = time.time()
    restored = AmodalDepthPipeline.load_serving(path, device="cuda")
    torch.cuda.synchronize()
    read_s = time.time() - t0
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


def _serving_artifact(gpu, path, bodies, first, export, export_t0, art,
                      square_in, square_want, dfm_dir, img, mask, obs,
                      dfm_want) -> None:
    """Phase 9 (d)-(e) once the export has ended: the artifact's meta,
    `cli.serve --artifact` and, beside it, the fresh replica process."""
    out, _ = export.communicate(timeout=900)
    check(export.returncode == 0 and "artifact written" in out,
          f"cli.serve --export_artifact (beside (b) and (c)) in "
          f"{time.time() - export_t0:.1f} s: {out.strip()[-300:]!r}")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    size = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))
    print(f"  amodal artifact (cli.serve): batch {meta['batches']} at "
          f"{meta['hw']}, exported in {meta['export_seconds']} s, "
          f"{size / 1e6:.1f} MB on disk; meta "
          f"{ {k: meta[k] for k in ARTIFACT_META} } csrc "
          f"{meta['csrc_sha256'][:12]} [{gpu}]", flush=True)
    replica = replica_start(art, square_in, dfm_dir, (img, mask, obs))
    try:
        serve_cli_check(gpu, path, bodies[0], first,
                        extra=("--artifact", art))
    finally:
        replica_finish(replica, square_want, (dfm_want,), gpu)
        shutil.rmtree(dfm_dir, ignore_errors=True)


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
    from amodal_depth_anything_tpu_torch.heuristics.mask_heuristics import \
        COMPLETION_WARMUP
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
        # the proxy's CLIP has 2 blocks; on the card the completion is
        # captured: counted at its warm-up and its capture, not the replay
        want = (2 + 32 * steps) * (COMPLETION_WARMUP + 1)
        check(launches == want and np.isfinite(got["cuda"]).all(),
              f"p2g proxy completion, {steps} steps, captured: {launches} "
              f"launches counted ({want}), finite")
    growth = (errs[HEUR_STEPS] / max(err_call, 1e-12)) ** (1 / HEUR_STEPS)
    print(f"  p2g proxy card vs CPU: one UNet call {err_call:.3e}, "
          f"completion after 10 steps {errs[10]:.3e}, after {HEUR_STEPS} "
          f"{errs[HEUR_STEPS]:.3e}: a factor {growth:.4f} per step over the "
          f"one call's error", flush=True)
    check(errs[HEUR_STEPS] <= P2G_COMPLETION_TOL,
          f"p2g proxy {HEUR_STEPS}-step completion at {P2G_PROXY_SIZE} px, "
          f"card vs CPU: max abs {errs[HEUR_STEPS]:.3e} <= "
          f"{P2G_COMPLETION_TOL}")


def completion_phase(mh, img, hint, gpu: str) -> None:
    """The captured pix2gestalt completion against the eager one on the
    prompt_points scene's visible mask, bit for bit, without DeepCache and
    with DEEP_CACHE; each one's time, and a traced replay's launches and
    device busy share."""
    import torch

    from amodal_depth_anything_tpu_torch.heuristics import \
        get_points_from_components

    hint_u8 = (hint > 0).astype(np.uint8) * 255
    visible = mh.sam_visible_mask(img, get_points_from_components(hint_u8))
    plain_cfg = mh.p2g_cfg
    for spec in (None, DEEP_CACHE):
        mh.p2g_cfg = dataclasses.replace(plain_cfg, ddim_deep_cache=spec)
        outs, ms = {}, {}
        for captured in (False, True, True):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs[captured] = mh.pix2gestalt_completion(
                img, visible, seed=3, captured=captured)
            ms[captured] = (time.perf_counter() - t1) * 1e3
        spent = {}
        wall, busy, got = trace_call(lambda: mh.pix2gestalt_completion(
            img, visible, seed=3), spent=spent)
        check(np.array_equal(outs[False], outs[True])
              and np.isfinite(outs[True]).all(),
              f"p2g completion, DeepCache {spec}: the captured replay "
              f"bit-identical to the eager completion (max abs "
              f"{float(np.abs(outs[False] - outs[True]).max())}); a traced "
              f"replay shows {got['flash_attn_fwd']} flash_attn_fwd "
              f"launches")
        pct = None if busy is None else 100 * busy / wall
        print(f"  p2g completion, DeepCache {spec}: eager {ms[False]:.1f} "
              f"ms, replay {ms[True]:.1f} ms; traced replay wall "
              f"{wall:.1f} ms, device busy {as_ms(busy)} "
              f"({'not measured' if pct is None else f'{pct:.1f}%'}), "
              f"flash_attn_fwd {as_ms(spent.get('flash_attn_fwd'))} "
              f"[{gpu}]", flush=True)
    mh.p2g_cfg = plain_cfg


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
    from amodal_depth_anything_tpu_torch.heuristics.mask_heuristics import \
        COMPLETION_WARMUP
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
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    mha.launches = 0                      # the main path starts here
    t1 = time.perf_counter()
    app.predict_arrays(img, hint, "prompt_points", seed=0)  # captures p2g
    first = time.perf_counter() - t1
    for i in range(HEUR_CALLS):
        t1 = time.perf_counter()
        out = app.predict_arrays(img, hint, "prompt_points", seed=i)
        latencies.append(time.perf_counter() - t1)
    launches = mha.launches               # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = ((COMPLETION_WARMUP + 1) * HEUR_LAUNCHES
            + (1 + HEUR_CALLS) * DEPTH_LAUNCHES)
    check(launches == want,
          f"heuristics main path counted flash_attn_fwd {launches} times "
          f"({want}: the completion's {HEUR_LAUNCHES} at its "
          f"{COMPLETION_WARMUP} warm-up and its capture in the first call, "
          f"replays after; {DEPTH_LAUNCHES} depth launches in each of "
          f"{1 + HEUR_CALLS} calls); the first call took {first:.1f} s")
    wall, busy, traced = trace_call(lambda: app.predict_arrays(
        img, hint, "prompt_points", seed=0))
    print(f"  a traced prompt_points call: wall {wall:.1f} ms, device busy "
          f"{as_ms(busy)}"
          + ("" if busy is None else f" ({100 * busy / wall:.1f}%)")
          + f", flash_attn_fwd launches in the trace "
          f"{traced['flash_attn_fwd']} ({HEUR_LAUNCHES} from the "
          f"completion's replay + {DEPTH_LAUNCHES} depth) [{gpu}]",
          flush=True)
    completion_phase(mh, img, hint, gpu)

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
                 "heuristics + depth call (bf16, completion replayed)", gpu)
    p50 = float(np.median(latencies)) * 1e3
    print(f"  heuristics + depth bf16 at full width, {HEUR_HW[0]} x "
          f"{HEUR_HW[1]} scene: p50 {p50:.1f} ms per call, latencies "
          f"{[round(v * 1e3, 1) for v in latencies]} ms, staged total "
          f"{total:.1f} ms, peak memory {peak:.2f} GiB [{gpu}]", flush=True)
    return launches, [app, img, hint]


# evaluation and baselines (phase 11): each baseline trained from its own
# config for a few steps at the recipe's batch and size on a synthetic SAM
# tree written to disk, then validated; launches a step of each attention
# kernel and the head dim they run at (InvisibleStitch's BEiT attention
# carries a relative-position bias and stays plain tensor ops, as in the
# JAX package)
BASELINE_RUNS = (("configs/deeplab.yaml", "ADDeepLab", 16, 8),
                 ("configs/jo_baseline.yaml", "PartialCompletionContentDPT",
                  64, 24),
                 ("configs/invisible_stitch.yaml", "InvisibleStitch", None, 0))
BASELINE_STEPS, BASELINE_TREE = 3, 8
EVAL_CONFIG = TRAIN_CONFIG
BUILD = "build"
EVAL_CKPT = os.path.join(BUILD, "smoke_eval_ckpt")
RESUME_CKPT = os.path.join(BUILD, "smoke_resume_ckpt")
# the mViT's self- and cross-attention (8 heads of 16 over 16 x 16 tokens at
# 518 px, batch 8) and jo_dpt's ViT-L/16 trunk (16 heads of 64 over 32 x 32
# + cls), q shape and keys
BASELINE_ATTN_CASES = [((8, 8, 256, 16), 256), ((8, 16, 1025, 64), 1025)]
ZERO_SHOT_HW, ZERO_SHOT_N, ZERO_SHOT_BATCH = (480, 640), 4, 2
BASELINE_TINY_TOL = 1e-4


class HeadDims:
    """Records the head dims the models' attention dispatch is called with
    while it is installed (`models.deeplab` and `models.layers` import
    `multi_head_attention` by name)."""

    def __init__(self):
        from amodal_depth_anything_tpu_torch.models import deeplab, layers
        self.modules = (deeplab, layers)
        self.seen: set = set()

    def __enter__(self):
        orig = self.modules[0].multi_head_attention
        self.orig = orig

        def recording(q, *args, **kw):
            self.seen.add(int(q.shape[-1]))
            return orig(q, *args, **kw)

        for mod in self.modules:
            mod.multi_head_attention = recording
        return self

    def __exit__(self, *exc):
        for mod in self.modules:
            mod.multi_head_attention = self.orig


def write_sam_tree(n: int, hw: int) -> tuple[str, str]:
    """A synthetic SAM tree of `n` scenes at `hw` px under build/, written
    by the port's `data/synthetic.py` (numpy PNG codec)."""
    from amodal_depth_anything_tpu_torch.data.synthetic import \
        make_synthetic_sam_tree

    root = os.path.join(BUILD, "smoke_sam_tree")
    os.makedirs(root, exist_ok=True)
    t0 = time.time()
    list_path = make_synthetic_sam_tree(root, n=n, hw=hw, style="scenes")
    print(f"  wrote a synthetic SAM tree of {n} scenes at {hw} px in "
          f"{time.time() - t0:.1f} s", flush=True)
    return root, list_path


def baseline_train_case(config: str, name: str, head_dim, per_step: int,
                        root: str, list_path: str, gpu: str) -> dict:
    """Train baseline `name` from `config` (its recipe: bf16, the config's
    trainer, loss and strategy) for BASELINE_STEPS steps at batch 8 on the
    SAM tree through `trainer.train()`, then `validate_single_dataset` over
    the tree; launches of each attention kernel, steps/s, p50, peak memory
    and one profiled step."""
    import torch

    from amodal_depth_anything_tpu_torch.cli.train import (
        trainer_config_from_cfg, trainer_kwargs_from_cfg)
    from amodal_depth_anything_tpu_torch.data import (DataLoader, DatasetMode,
                                                      get_dataset)
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.train import get_trainer_cls
    from amodal_depth_anything_tpu_torch.utils.config import \
        recursive_load_config
    from amodal_depth_anything_tpu_torch.utils.depth_transform import \
        get_depth_normalizer
    from amodal_depth_anything_tpu_torch.utils.profiling import StepTimer

    cfg = recursive_load_config(config)
    batch = int(cfg.dataloader.max_train_batch_size)
    tcfg = dataclasses.replace(
        trainer_config_from_cfg(cfg, accumulation_steps=1),
        lr_warmup_steps=0, max_iter=BASELINE_STEPS, log_interval=1,
        validation_period=0, save_period=0, visualization_period=0)
    check(cfg.model.name == name and tcfg.compute_dtype == "bfloat16"
          and batch == TRAIN_BATCH,
          f"{config}: {name} under {cfg.trainer.name}, bfloat16, batch "
          f"{batch}, {tcfg.loss_name} on {tcfg.loss_strategy}")
    normalizer = get_depth_normalizer(cfg.get("depth_normalization"))
    splits = {}
    for key, mode in (("train", DatasetMode.TRAIN), ("val", DatasetMode.EVAL)):
        split = getattr(cfg.dataset, key).to_dict()
        split["filenames"] = list_path   # the recipe's split, on this tree
        splits[key] = get_dataset(split, root, mode,
                                  depth_transform=normalizer)
    workers = int(cfg.dataloader.get("num_workers", 0) or 0)
    train_loader = DataLoader(splits["train"], batch_size=batch, shuffle=True,
                              drop_last=True, seed=0, num_workers=workers)
    val_loader = DataLoader(splits["val"], batch_size=batch, pad_last=True,
                            num_workers=workers)
    t0 = time.time()
    model = get_model(name, device="cuda", **cfg.model.kwargs.to_dict())
    trainer = get_trainer_cls(cfg.trainer.name)(
        tcfg, model, train_loader, [val_loader], device="cuda", seed=0,
        **trainer_kwargs_from_cfg(cfg))
    n_params = sum(p.numel() for p in trainer.state.params.values())
    torch.cuda.synchronize()
    print(f"  {name}: {n_params / 1e6:.1f} M trained parameters, built and "
          f"seeded on the card in {time.time() - t0:.1f} s", flush=True)
    watched = next(iter(trainer.state.params))
    before = trainer.state.params[watched].detach().clone()
    buffers = {k: v.clone() for k, v in model.named_buffers()
               if "running" in k}
    losses = []
    step = trainer._train_step

    def recording_step(b):
        loss = step(b)
        losses.append(float(loss))
        return loss

    trainer._train_step = recording_step
    trainer.step_timer = StepTimer(warmup=1)   # the first step loads cuDNN
    torch.cuda.reset_peak_memory_stats()
    with HeadDims() as dims:
        mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
        mha.bwd_short_launches = 0
        t_train = time.time()
        trainer.train()                            # the main path
        t_train = time.time() - t_train
        launches = {"flash_attn_fwd": mha.launches,
                    "flash_attn_bwd_dq": mha.bwd_dq_launches,
                    "flash_attn_bwd_dkv": mha.bwd_dkv_launches}
        short = mha.bwd_short_launches
    # the mViT's memory is 256 tokens: none of the baselines' backward
    # calls is onto a short key set
    check(short == 0, f"{name}: {short} short-key backward launches (0)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer._train_step = step
    check(len(losses) == BASELINE_STEPS and bool(np.isfinite(losses).all()),
          f"{name}: {BASELINE_STEPS} steps, finite losses "
          f"{[round(x, 5) for x in losses]}")
    new = trainer.state.params[watched]
    check(bool(torch.isfinite(new).all()) and not torch.equal(new, before),
          f"{name}: parameter {watched} finite and moved")
    if buffers:
        moved = [k for k, v in model.named_buffers() if k in buffers
                 and not torch.equal(v, buffers[k])]
        check(len(moved) == len(buffers),
              f"{name}: {len(moved)} of {len(buffers)} BatchNorm running "
              f"statistics moved by the train-mode steps")
    captured_launches(launches, per_step, name)
    replay_launches(trainer, train_loader, per_step, name)
    check(dims.seen == ({head_dim} if head_dim else set()),
          f"{name}: attention head dims {sorted(dims.seen)}")
    if name == BASELINE_RUNS[0][1]:
        loader_routes(train_loader, workers, t_train, name, gpu)
    timing = trainer.step_timer.summary()
    print(f"  {name} bf16 batch {batch} at {SIZE} px: "
          f"{timing['steps_per_sec']:.4f} steps/s, p50 "
          f"{timing['p50_s'] * 1e3:.1f} ms per step "
          f"{[round(x * 1e3, 1) for x in trainer.step_timer.durations]} ms, "
          f"train() wall {t_train:.1f} s ({workers} loader threads decode "
          f"the PNGs with the native codec), "
          f"peak memory {peak:.2f} GiB, launches a step: {per_step} of "
          f"each attention kernel at head dim {head_dim} [{gpu}]",
          flush=True)
    b8 = trainer._device_batch(next(iter(train_loader)))
    profile_call(lambda: float(trainer._train_step(b8)),
                 f"{name} bf16 train step (replayed)", gpu)
    results = trainer.validate_single_dataset(val_loader, eval=True)
    vals = [results[bank][m] for bank in ("overall", "align_overall")
            for m in tcfg.eval_metrics]
    check(bool(np.isfinite(vals).all()),
          f"{name}: validate_single_dataset over {len(splits['val'])} "
          f"scenes, 10 metrics x (raw, aligned) finite; abs_rel aligned "
          f"{results['align_overall']['abs_relative_difference']:.4f}")
    # the trainer's captured step holds its graph pool: free it (the bound
    # `step` and the closure hold the trainer too)
    del trainer, model, b8, step, recording_step
    gc.collect()
    torch.cuda.empty_cache()

    def make(captured):
        return get_trainer_cls(cfg.trainer.name)(
            tcfg, get_model(name, device="cuda", **cfg.model.kwargs.to_dict()),
            None, device="cuda", seed=0, captured=captured,
            **trainer_kwargs_from_cfg(cfg))

    captured_step_phase(f"{name} train step", make,
                        capture_batches(trainer_like(), splits["train"]), gpu,
                        RESUME_CKPT, resume=name == "ADDeepLab",
                        cudnn=name == "ADDeepLab")
    return launches


def loader_routes(loader, workers: int, t_train: float, name: str,
                  gpu: str) -> None:
    """(c) of the twelfth slice: `train()`'s loader over one epoch of the
    SAM tree with the native codec and resizes, then with the numpy plain
    versions (`native.plain_route()`), beside the train() wall."""
    import contextlib

    from amodal_depth_anything_tpu_torch import native

    walls, counts = {}, {}
    for route in ("native", "numpy"):
        with (native.plain_route() if route == "numpy"
              else contextlib.nullcontext()):
            t = time.perf_counter()
            counts[route] = sum(1 for _ in loader)
            walls[route] = time.perf_counter() - t
    check(counts["native"] == counts["numpy"] > 0,
          f"{name}: the train loader gives {counts['native']} batches an "
          f"epoch on both host routes")
    print(f"  {name}: train() loader ({workers} threads), one epoch of "
          f"{counts['native']} batches: {walls['native']:.2f} s with the "
          f"native codec, {walls['numpy']:.2f} s decoding in numpy; train() "
          f"wall {t_train:.1f} s [{gpu}]", flush=True)


def zero_shot_tree(root: str) -> str:
    """A NYU-layout split of ZERO_SHOT_N scenes at 480 x 640: 8-bit RGB and
    16-bit millimetre depth PNGs (numpy codec), the filled depth the raw
    one."""
    from amodal_depth_anything_tpu_torch.utils.host_image import encode_png

    rng = np.random.default_rng(11)
    os.makedirs(root, exist_ok=True)
    lines = []
    h, w = ZERO_SHOT_HW
    yy, xx = np.mgrid[:h, :w]
    for i in range(ZERO_SHOT_N):
        rgb = (np.stack([xx / w, yy / h, rng.random((h, w)) * 0.3], -1)
               * 255).astype(np.uint8)
        depth = (1000 + 4000 * yy / h + 500 * rng.random((h, w))
                 ).astype(np.uint16)
        for stem, arr in ((f"rgb_{i:04d}.png", rgb),
                          (f"depth_{i:04d}.png", depth)):
            with open(os.path.join(root, stem), "wb") as f:
                f.write(encode_png(arr))
        lines.append(f"rgb_{i:04d}.png depth_{i:04d}.png depth_{i:04d}.png")
    list_path = os.path.join(root, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_path


def eval_phase(root: str, list_path: str, gpu: str) -> int:
    """(b): `cli.eval.main` on the phase-6 vitl checkpoint over the SAM
    tree, `scripts.zero_shot_eval` with a seeded vitg raw base over a
    NYU-layout split, and `infer_image` on a 480 x 640 image. Returns the
    forward launches."""
    import torch

    from amodal_depth_anything_tpu_torch.cli import eval as eval_cli
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import \
        init_weights_
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.raw_infer import (
        image2tensor_np, infer_image)
    from amodal_depth_anything_tpu_torch.scripts import zero_shot_eval

    overlay = os.path.join(BUILD, "smoke_eval.yaml")
    with open(overlay, "w") as f:
        f.write(f"base_config:\n- {os.path.abspath(EVAL_CONFIG)}\n"
                "dataset:\n  val: {name: sam, disp_name: smoke_val, "
                f"filenames: {os.path.abspath(list_path)}, "
                "resize_to_hw: [518, 518]}\n"
                "dataloader: {num_workers: 0}\n")
    out = os.path.join(BUILD, "smoke_eval_out")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.time()
    mha.launches = 0
    eval_cli.main(["--config", overlay, "--trained_checkpoint",
                   os.path.join(EVAL_CKPT, "latest"), "--base_data_dir",
                   root, "--output_dir", out, "--device", "cuda"])
    eval_launches = mha.launches
    with open(os.path.join(out, "evaluation", "eval.txt")) as f:
        text = f.read()
    lines = text.splitlines()
    tables = {lines[i].rsplit("/", 1)[-1]: [float(v) for v in
                                             lines[i + 2].split()]
              for i in range(0, len(lines), 3)}
    check(len(tables) == 8 and all(
              len(tables[k]) == 10 and bool(np.isfinite(tables[k]).all())
              for k in ("overall", "align_overall"))
          and eval_launches == TRAIN_BLOCKS * BASELINE_TREE,
          f"cli.eval on the phase-6 vitl checkpoint: eval.txt with 8 bucket "
          f"tables, overall and align_overall 10 finite metrics each, in "
          f"{time.time() - t0:.1f} s, {eval_launches} forward launches "
          f"({TRAIN_BLOCKS} an image)")
    print("  " + "\n  ".join(text.splitlines()[:4]), flush=True)

    zs_root = os.path.join(BUILD, "smoke_nyu")
    zs_list = zero_shot_tree(zs_root)
    raw = get_model("DepthAnythingV2Raw", encoder="vitg", device="cuda")
    init_weights_(raw, torch.Generator(device="cuda").manual_seed(5))
    ckpt = os.path.join(BUILD, "smoke_vitg_raw.pth")
    torch.save({k: v.to(torch.bfloat16) for k, v in
                raw.state_dict().items()}, ckpt)
    t0 = time.time()
    mha.launches = 0
    res = zero_shot_eval.main([
        "--dataset", "nyu_v2", "--base_data_dir", zs_root, "--filenames",
        zs_list, "--checkpoint", ckpt, "--encoder", "vitg", "--size",
        str(SIZE), "--batch", str(ZERO_SHOT_BATCH), "--dtype", "bfloat16",
        "--align",
        "disparity", "--device", "cuda"])
    zs_launches = mha.launches
    os.remove(ckpt)
    zs_calls = -(-ZERO_SHOT_N // ZERO_SHOT_BATCH)
    check(bool(np.isfinite(list(res.values())).all()) and
          zs_launches == 40 * zs_calls,
          f"scripts.zero_shot_eval, vitg raw bf16 over {ZERO_SHOT_N} "
          f"NYU-layout scenes: 10 finite metrics (abs_rel "
          f"{res['abs_relative_difference']:.4f}) in "
          f"{time.time() - t0:.1f} s, {zs_launches} forward launches (40 "
          f"a call of {ZERO_SHOT_BATCH})")

    raw = raw.to(torch.bfloat16)
    bgr = np.ascontiguousarray(
        (np.random.default_rng(3).random(ZERO_SHOT_HW + (3,)) * 255)
        .astype(np.uint8))
    x, _ = image2tensor_np(bgr, SIZE)
    mha.launches = 0
    t0 = time.time()
    depth = infer_image(raw, bgr, SIZE, dtype=torch.bfloat16)
    ms = (time.time() - t0) * 1e3
    check(x.shape == (1, 518, 686, 3) and depth.shape == ZERO_SHOT_HW
          and bool(np.isfinite(depth).all()) and mha.launches == 40,
          f"infer_image on a 480 x 640 image: keep-aspect input "
          f"{list(x.shape[1:3])}, depth {list(depth.shape)} finite, "
          f"{mha.launches} launches, {ms:.1f} ms with the host resize "
          f"[{gpu}]")
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    return eval_launches + zs_launches + 40


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of `fn`: `reps` calls captured as one CUDA
    graph and replayed, timed with events, so the host's launch cost (which
    an event pair around eager launches reads at launch-bound shapes) is
    paid once a replay and not once a call."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, replays, warmup=1) / reps
    del graph
    return ms


def baseline_attention_phase(gpu: str) -> dict:
    """(c): the forward, dQ and dK/dV at the baselines' shapes against
    their plain versions, bf16 and f32, with device times beside the bound
    and SDPA's."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, mha)

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, runs = [], {}
    for shape, nk in BASELINE_ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            fwd = attention_case(gen, shape, nk, None, dt_name, gpu)
            bwd = bwd_case(gen, shape, nk, None, dt_name, gpu, runs)
            # device times from CUDA graphs of 20 calls (the profiler's
            # traces lose events in a process that has traced before)
            dtype = getattr(torch, dt_name)
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           .to(dtype) for _ in range(4))
            o, lse = mha(q, k, v, return_lse=True)
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, lse, delta)
            kw = {"sm_scale": shape[-1] ** -0.5}
            fwd["graph_ms"] = graph_ms(lambda: mha(q, k, v))
            fwd["library_graph_ms"] = graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))
            bwd["flash_attn_bwd_dq"]["graph_ms"] = graph_ms(
                lambda: flash_attn_bwd_dq(*args, **kw))
            bwd["flash_attn_bwd_dkv"]["graph_ms"] = graph_ms(
                lambda: flash_attn_bwd_dkv(*args, **kw))
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]

            def sdpa_bwd():
                F.scaled_dot_product_attention(*leaves).backward(do)

            lib_bwd = graph_ms(sdpa_bwd) - fwd["library_graph_ms"]
            for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
                bwd[name]["library_graph_ms"] = lib_bwd
            del q, k, v, do, o, lse, delta, args, leaves
            print(f"  baseline shape {list(shape)} {dt_name}: device time "
                  f"(graphs of 20) fwd {fwd['graph_ms']:.4f} ms (bound "
                  f"{fwd['bound_ms']:.4f} ms, sdpa "
                  f"{fwd['library_graph_ms']:.4f} ms), dq "
                  f"{bwd['flash_attn_bwd_dq']['graph_ms']:.4f} ms (bound "
                  f"{bwd['flash_attn_bwd_dq']['bound_ms']:.4f} ms), dk/dv "
                  f"{bwd['flash_attn_bwd_dkv']['graph_ms']:.4f} ms (bound "
                  f"{bwd['flash_attn_bwd_dkv']['bound_ms']:.4f} ms), sdpa "
                  f"backward {lib_bwd:.4f} ms [{gpu}]", flush=True)
            rows.append({"q": list(shape), "nk": nk, "dtype": dt_name,
                         "flash_attn_fwd": fwd, **bwd})
    torch.cuda.empty_cache()
    return rows


def mvit_layer_check() -> None:
    """One of ADDeepLab's mViT decoder layers at full width (128 wide, 8
    heads of 16, 16 x 16 tokens, batch 8): self-attention on strided views
    of one qkv buffer and cross-attention onto strided views of the memory's
    kv buffer, kernels against plain attention, output and every gradient.
    float32: each tensor within 2e-5 of the plain path's max abs. bfloat16:
    both paths against the float32 plain one, the kernels' error on each
    tensor no more than twice the plain bf16 path's or 2e-2 (the whole layer
    rounds to bf16, so two bf16 paths part by more than one kernel does)."""
    import torch

    from amodal_depth_anything_tpu_torch.models.deeplab import DecoderLayer
    from amodal_depth_anything_tpu_torch.ops.precision import \
        apply_precision_policy

    apply_precision_policy(torch.float32)   # TF32 off
    gen = torch.Generator(device="cuda").manual_seed(13)
    layer = DecoderLayer(128, 8, 1024).cuda()
    with torch.no_grad():
        for p in layer.parameters():
            p.uniform_(-0.1, 0.1, generator=gen)
    tgt, mem = (torch.randn((TRAIN_BATCH, 256, 128), generator=gen,
                            device="cuda") for _ in range(2))
    names = ["output", "d tgt", "d memory"] + [
        f"d {n}" for n, _ in layer.named_parameters()]
    got = {}
    for dt_name in ("float32", "bfloat16"):
        for impl in (None, "plain"):
            leaves = [t.detach().to(getattr(torch, dt_name))
                      .requires_grad_() for t in (tgt, mem)]
            layer.zero_grad()
            out = layer(*leaves, impl)
            out.float().square().sum().backward()
            got[dt_name, impl] = [out.detach().float()] + [
                t.grad.float() for t in leaves] + [
                p.grad.float() for p in layer.parameters()]

    def errs(case):
        return [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(got[case], got["float32", "plain"])]

    f32 = errs(("float32", None))
    check(max(f32) <= TOL["float32"],
          f"ADDeepLab mViT layer at full width, f32, kernels on strided self "
          f"/ cross views vs plain: output and {len(f32) - 1} gradients "
          f"within {max(f32):.2e} of each reference's max abs <= "
          f"{TOL['float32']}")
    kern, plain = errs(("bfloat16", None)), errs(("bfloat16", "plain"))
    worst = max(range(len(kern)), key=lambda i: kern[i] / max(plain[i], 1e-30))
    check(all(k <= max(2 * p, TOL["bfloat16"]) for k, p in zip(kern, plain)),
          f"ADDeepLab mViT layer at full width, bf16, against the f32 plain "
          f"one: kernels {max(kern):.2e}, plain attention {max(plain):.2e} "
          f"at worst; the largest ratio at {names[worst]}: {kern[worst]:.2e} "
          f"vs {plain[worst]:.2e} (<= twice the plain path's or "
          f"{TOL['bfloat16']})")


def baseline_tiny_phase() -> None:
    """(d): each baseline at its tiny preset, seeded, card (kernels)
    against CPU (plain) in float32 with TF32 off: eval outputs and, for the
    BatchNorm models, the train-mode outputs and running statistics."""
    import torch

    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.ops.precision import \
        apply_precision_policy

    apply_precision_policy(torch.float32)
    rng = np.random.default_rng(12)
    hw = 64
    x = torch.from_numpy(rng.random((2, hw, hw, 3), dtype=np.float32))
    mask = torch.from_numpy((rng.random((2, hw, hw, 1)) > 0.5)
                            .astype(np.float32))
    obs = torch.from_numpy(rng.random((2, hw, hw, 1), dtype=np.float32))

    def call(name, model, dev, train):
        a, m, o = (t.to(dev) for t in (x, mask, obs))
        if name == "ADDeepLab":
            return torch.cat(model(a, m, train=train), dim=-1)
        if name == "PartialCompletionContentDPT":
            return model(a, guide_mask=m, train=train)
        if name == "InvisibleStitch":
            return model(a, invisible_mask=m, observation=o)
        return model(a, train=train)

    for name in ("ADDeepLab", "PartialCompletionContentDPT",
                 "InvisibleStitch", "JoUNet"):
        cpu = get_model(name, tiny=True, device="cpu")
        cpu.init_weights_(torch.Generator().manual_seed(3))
        gpu_model = get_model(name, tiny=True, device="cuda")
        gpu_model.load_state_dict(cpu.state_dict())
        for train in ((False, True) if name != "InvisibleStitch"
                      else (False,)):
            with torch.no_grad():
                ref = call(name, cpu, "cpu", train)
                got = call(name, gpu_model, "cuda", train).cpu()
            err = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            stats = max([(a.cpu() - b).abs().max().item() for (ka, a), (_, b)
                         in zip(gpu_model.named_buffers(),
                                cpu.named_buffers()) if "running" in ka]
                        or [0.0])
            check(err <= BASELINE_TINY_TOL * scale
                  and stats <= BASELINE_TINY_TOL,
                  f"{name} tiny, card vs CPU in f32 "
                  f"({'train' if train else 'eval'} mode): max abs {err:.2e}"
                  f" <= {BASELINE_TINY_TOL} x {scale:.2f}, running stats "
                  f"{stats:.2e}")


def baselines_phase(gpu: str) -> dict:
    """Phase 11: the baselines' training and evaluation, the eval CLIs and
    the attention kernels at the baselines' shapes. Returns the launches of
    each attention kernel on its main paths and the measured rows."""
    launches = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                "flash_attn_bwd_dkv": 0}
    t0 = time.time()

    def step(what):
        print(f"  {what} (at +{time.time() - t0:.1f} s)", flush=True)

    root, list_path = write_sam_tree(BASELINE_TREE, SIZE)
    for config, name, head_dim, per_step in BASELINE_RUNS:
        step(f"(a) {name}")
        got = baseline_train_case(config, name, head_dim, per_step, root,
                                  list_path, gpu)
        for kernel, count in got.items():
            launches[kernel] += count
    step("(b) cli.eval, zero_shot_eval, infer_image")
    launches["flash_attn_fwd"] += eval_phase(root, list_path, gpu)
    shutil.rmtree(EVAL_CKPT, ignore_errors=True)
    step("(c) the kernels at the baselines' shapes, the mViT layer")
    rows = baseline_attention_phase(gpu)
    mvit_layer_check()
    step("(d) the tiny baselines, card vs CPU")
    baseline_tiny_phase()
    step("phase 11 done")
    return {"launches": launches, "rows": rows}



# compression (phase 12): the trunks' and the UNet's int8 products (M, K, N):
# vitg and vitl qkv, proj, fc1 / w12, fc2 / w3 at 518 px batch 4 (M = 4 x
# 1370), vitg qkv at the ToMe'd length (M = 4 x 712), the UNet's 320-wide
# linears over 4096 tokens and its time-embedding linear (M = 4 rows)
INT8_MM_CASES = [(5480, 1536, 4608), (5480, 1536, 1536), (5480, 1536, 8192),
                 (5480, 4096, 1536), (5480, 1024, 3072), (5480, 1024, 1024),
                 (5480, 1024, 4096), (5480, 4096, 1024), (2848, 1536, 4608),
                 (16384, 320, 320), (16384, 320, 2560), (4, 320, 1280)]
# (x [B,H,W,C], C_out, k, stride): the DPT heads' convs at 518 px batch 4
# (vitl 3x3 256 -> 256 over 148 / 296 px, vitg 1x1 1536 -> 1536 over 37,
# vitg 3x3 384 -> 384 over 74, the 3x3 stride-2 resize conv), the UNet's
# 3x3 convs at 64 x 64 and 8 x 8 latents, a 1x1 skip, and the VAE's
# 512 -> 512 at 64 x 64
INT8_CONV_CASES = [((4, 148, 148, 256), 256, 3, 1),
                   ((4, 296, 296, 256), 256, 3, 1),
                   ((4, 37, 37, 1536), 1536, 1, 1),
                   ((4, 74, 74, 384), 384, 3, 1),
                   ((4, 37, 37, 1536), 1536, 3, 2),
                   ((4, 64, 64, 320), 320, 3, 1),
                   ((4, 8, 8, 1280), 1280, 3, 1),
                   ((4, 32, 32, 960), 640, 1, 1),
                   ((4, 64, 64, 512), 512, 3, 1)]
# the forward kernel at the compression paths' merged lengths: ToMe (4, 658)
# on both trunks at 518 px (1370 - 658 = 712 tokens), (9, 2560) at 1022 px
# (5330 - 2560 = 2770), ToMe-SD 0.75 at the UNet's 4096-token level (2049
# tokens) self and onto the 77 context keys
TOME = (4, 658)
TOME_ATTN_CASES = [((4, 24, 712, 64), 712), ((4, 16, 712, 64), 712),
                   ((1, 24, 2770, 64), 2770), ((4, 8, 2049, 40), 2049),
                   ((4, 8, 2049, 40), 77)]
TOME_SD = 0.75
COMP_CALLS = 3


def int8_products_phase(gpu: str) -> None:
    """(a) `ops.quant.int8_matmul` (torch._int_mm) and the im2col int8 conv
    at the trunks', heads' and UNet's shapes: int32 sums equal to the exact
    plain product (float64, exact below 2^53), and their times beside the
    bf16 product's."""
    import torch
    import torch.nn.functional as F

    from amodal_depth_anything_tpu_torch.ops import quant as Q

    gen = torch.Generator(device="cuda").manual_seed(12)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             device="cuda", dtype=torch.int8)

    for m, k, n in INT8_MM_CASES:
        a, w = codes(m, k), codes(n, k)
        acc = Q.int8_matmul(a, w)
        exact = a.double() @ w.double().t()
        same = bool((acc.double() == exact).all())
        check(acc.dtype == torch.int32 and same,
              f"int8_matmul [{m},{k}] x [{k},{n}] equals the exact product")
        ab, wb = a.bfloat16(), w.bfloat16()
        it = max(3, min(50, int(2e10 / (m * k * n))))
        ms = cuda_ms(lambda: Q.int8_matmul(a, w), it)
        bf_ms = cuda_ms(lambda: F.linear(ab, wb), it)
        print(f"  int8 mm [{m},{k}]x[{k},{n}]: exact {same}; int8 {ms:.4f} "
              f"ms ({2 * m * k * n / ms / 1e9:.1f} TOP/s), bf16 {bf_ms:.4f} "
              f"ms [{gpu}]", flush=True)
    for shape, co, ks, stride in INT8_CONV_CASES:
        b, h, wd, c = shape
        x, w = codes(*shape), codes(co, c, ks, ks)
        pad = ks // 2
        acc = Q._int8_conv_acc(x, w, stride, pad)
        exact = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(),
                         stride=stride, padding=pad).permute(0, 2, 3, 1)
        same = bool((acc.double() == exact).all())
        del exact
        check(same, f"int8 conv {list(shape)} -> {co} k{ks} s{stride} "
                    f"equals the exact convolution")
        xb = x.bfloat16().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wb = w.bfloat16().contiguous(memory_format=torch.channels_last)
        ms = cuda_ms(lambda: Q._int8_conv_acc(x, w, stride, pad), 5)
        bf_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=pad),
                        5)
        print(f"  int8 conv {list(shape)} -> {co} k{ks} s{stride}: exact "
              f"{same} (fan {ks * ks * c}, |sum| up to "
              f"{int(acc.abs().max())}); im2col int8 {ms:.4f} ms, cuDNN "
              f"bf16 {bf_ms:.4f} ms [{gpu}]", flush=True)
        del acc, x, xb


def tome_attention_phase(gpu: str) -> list:
    """(b) the forward kernel at the merged lengths, f32 and bf16, against
    its plain version with the phase-3 bars. Returns the bf16 rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for shape, nk in TOME_ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            row = attention_case(gen, shape, nk, None, dt_name, gpu)
            if dt_name == "bfloat16":
                rows.append({"q": list(shape), "nk": nk, **row})
    return rows


def compressed_point(what, pipe, capture_fn, eager, args, launches: int,
                     exact, gpu: str, breakdown: bool = False) -> dict:
    """One compression point: the eager call's forward-kernel launches
    (`launches` a call) and those recorded into the graph (`launches` a
    call over the warm-up calls and the capture), the captured replay bit
    for bit against the eager call, the eager call's time and the replay's
    p50 over COMP_CALLS, device
    busy and the launches a profiled replay shows (a reading: the profiler
    can drop an event of a replay in a process that has traced many times),
    peak memory, and the depth delta to `exact`; with `breakdown`, where a
    profiled replay's device time goes, by kernel."""
    from amodal_depth_anything_tpu_torch.utils.graphs import WARMUP_CALLS
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.pipeline.quality import \
        blended_depth_delta

    counted = mha.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_e = time.perf_counter()
    out_e = eager(*args)
    eager_ms = (time.perf_counter() - t_e) * 1e3
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_call = mha.launches - counted
    check(per_call == launches, f"{what}: eager call launched "
                                f"flash_attn_fwd {per_call} times ({launches})")
    counted = mha.launches
    served = capture_fn()
    captured = (mha.launches - counted) / (WARMUP_CALLS + 1)
    check(captured == launches,
          f"{what}: {captured:g} flash_attn_fwd launches a call over the "
          f"warm-up and the capture, so in the graph ({launches})")
    out_r = served(*args)
    out_e, out_r = (o if isinstance(o, tuple) else (o,)
                    for o in (out_e, out_r))
    same = all(np.array_equal(a, b) for a, b in zip(out_e, out_r))
    check(same and all(np.isfinite(a).all() and a.std() > MIN_STD
                       for a in out_e),
          f"{what}: replay bit-identical to the eager call, finite, not "
          f"constant")
    # the eager call timed once (the one held against the replay), the
    # replay over COMP_CALLS
    row = {"eager": {"p50_ms": eager_ms, "peak_gib": eager_peak}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(COMP_CALLS):
        t = time.perf_counter()
        served(*args)
        lat.append(time.perf_counter() - t)
    row["replay"] = {"p50_ms": float(np.median(lat)) * 1e3,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    wall, busy, counts = trace_call(lambda: served(*args))
    if breakdown:
        profile_call(lambda: served(*args), f"{what} replay", gpu)
    ex = exact if isinstance(exact, tuple) else (exact,)
    delta = blended_depth_delta(ex[0], ex[-1], out_e[0], out_e[-1]) \
        if exact is not None else None
    print(f"  {what}: eager call {row['eager']['p50_ms']:.1f} ms, replay p50 "
          f"{row['replay']['p50_ms']:.1f} ms, replay device busy "
          f"{as_ms(busy)} of {wall:.1f} ms, peak allocated "
          f"{row['eager']['peak_gib']:.2f} / {row['replay']['peak_gib']:.2f} "
          f"GiB (eager / replay), {per_call} launches eager, "
          f"{captured:g} captured, {counts['flash_attn_fwd']} in a profiled "
          f"replay, replay == eager {same}; against exact: "
          + ("-" if delta is None else
             f"blended max abs {delta['blended_max_abs']:.4f} mean abs "
             f"{delta['blended_mean_abs']:.5f}") + f" [{gpu}]", flush=True)
    del served
    return {"outputs": out_e, "delta": delta, **row}


def amodal_compression_phase(gpu: str):
    """(c) vitg + vitl at 518 px, bf16 batch 4, at six points: exact, LN-
    bound int8 on both trunks, calibrated with the heads, dynamic, ToMe
    (4, 658) on both trunks, LN int8 + ToMe. Returns the exact pipeline,
    the int8 + ToMe one and the inputs, for (f)."""
    import copy

    import torch

    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        capture_amodal_program

    rng = np.random.default_rng(21)
    hw = (600, 800)
    img = (rng.random((FULL_BATCH, *hw, 3)) * 255).astype(np.float32)
    mask = np.zeros((FULL_BATCH, *hw), np.float32)
    mask[:, 150:450, 250:600] = 1.0
    t0 = time.time()
    base = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=torch.bfloat16)
    print(f"  seeded vitg + vitl bf16 built in {time.time() - t0:.1f} s",
          flush=True)
    points = [("exact", {}, {}),
              ("int8 ln", dict(base=True, amodal=True), {}),
              ("int8 calibrated + head",
               dict(base=True, amodal=True, head=True,
                    calibration=(img[:1], mask[:1])), {}),
              ("int8 dynamic + head", dict(base=True, amodal=True, head=True,
                                           dynamic=True), {}),
              (f"ToMe {TOME} both", {},
               dict(base_token_merge=TOME, amodal_token_merge=TOME)),
              (f"int8 ln + ToMe {TOME} both", dict(base=True, amodal=True),
               dict(base_token_merge=TOME, amodal_token_merge=TOME))]
    exact = None
    keep = None
    for name, q, knobs in points:
        pipe = AmodalDepthPipeline(
            copy.deepcopy(base.raw_model), copy.deepcopy(base.amodal_model),
            size=SIZE, device="cuda", dtype=torch.bfloat16, **knobs)
        if q:
            t0 = time.time()
            pipe.quantize_int8(**q)
            torch.cuda.synchronize()
            print(f"  {name}: quantize_int8 in {time.time() - t0:.1f} s",
                  flush=True)
        res = compressed_point(
            f"amodal {name}", pipe,
            lambda: capture_amodal_program(pipe, batch=FULL_BATCH, hw=hw),
            pipe, (img, mask), DEPTH_LAUNCHES, exact, gpu)
        if exact is None:
            exact = res["outputs"]
        if q and knobs:                   # the last point: int8 + ToMe
            keep = pipe
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return base, keep, (img, mask)


def serving_state_phase(gpu: str, state_dir: str, base, keep, inputs
                        ) -> None:
    """(f) the int8 + ToMe pipeline's serving state saved and restored on
    the card, bit-identical; `cli.serve --int8 ln` on the exact state and
    `cli.serve --family depthfm --random --int8 wo` answering requests."""
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline

    img, mask = inputs
    path = os.path.join(state_dir, "serving_state_int8_tome")
    shutil.rmtree(path, ignore_errors=True)
    try:
        want = keep(img, mask)
        t0 = time.time()
        keep.save_serving(path)
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(path) for f in files)
        back = AmodalDepthPipeline.load_serving(path, device="cuda")
        read_s = time.time() - t0
        same = all(np.array_equal(a, b) for a, b in zip(back(img, mask),
                                                        want))
        check(same and back.base_token_merge == TOME,
              "int8 + ToMe serving state restored on the card: knobs kept, "
              "outputs bit-identical")
        print(f"  int8 + ToMe state: {nbytes / 1e9:.3f} GB, written and read "
              f"back in {read_s:.1f} s, bit-identical {same} [{gpu}]",
              flush=True)
        exact_path = os.path.join(state_dir, "serving_state_exact")
        shutil.rmtree(exact_path, ignore_errors=True)
        base.save_serving(exact_path)
        # the two servers start, quantise and capture side by side
        import threading
        servers = [threading.Thread(target=serve_int8_cli_check, args=(
            gpu, argv, family)) for argv, family in (
                (["--serving_state", exact_path, "--int8", "ln"], "amodal"),
                (["--family", "depthfm", "--random", "--int8", "wo"],
                 "depthfm"))]
        for t in servers:
            t.start()
        for t in servers:
            t.join()
    finally:
        shutil.rmtree(path, ignore_errors=True)
        shutil.rmtree(os.path.join(state_dir, "serving_state_exact"),
                      ignore_errors=True)


def serve_int8_cli_check(gpu: str, argv: list, family: str) -> None:
    """`python -m amodal_depth_anything_tpu_torch.cli.serve ... --int8 MODE`
    as a subprocess on the card: it quantises, captures a CUDA graph, says
    so, and answers three POSTs with 200 and finite depth; then it is
    stopped."""
    import base64
    import select
    import urllib.request

    from amodal_depth_anything_tpu_torch.utils.host_image import (decode_png,
                                                                  encode_png)

    rng = np.random.default_rng(5)
    image = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
    mask = np.zeros((120, 160), np.uint8)
    mask[30:90, 40:120] = 255
    payload = {"image": base64.b64encode(encode_png(image)).decode(),
               "mask": base64.b64encode(encode_png(mask)).decode()}
    route, keys = "/v1/amodal_depth", ("base_depth", "blended_depth")
    if family == "depthfm":
        obs = (rng.random((120, 160)) * 65535).astype(np.uint16)
        payload["observation"] = base64.b64encode(encode_png(obs)).decode()
        route, keys = "/v1/depthfm_depth", ("depth",)
    body = json.dumps(payload).encode()
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "amodal_depth_anything_tpu_torch.cli.serve",
         *argv, "--port", "0", "--max_batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    what = f"cli.serve {' '.join(argv)}"
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
              f"{what} serves a CUDA graph: {line.strip()!r}")
        if "serving on" not in line:
            return
        port = re.search(r":(\d+) ", line).group(1)
        lat, ok = [], True
        for _ in range(3):
            t = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{route}", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                code, res = r.status, json.loads(r.read())
            lat.append((time.perf_counter() - t) * 1e3)
            maps = [decode_png(base64.b64decode(res[k])) for k in keys]
            ok &= code == 200 and all(np.isfinite(m).all() and m.std() > 0
                                      for m in maps)
        check(ok, f"{what}: three POSTs answered 200 with varying depth")
        print(f"  {what}: up in {up:.1f} s (start, quantise, capture), POSTs "
              f"{[round(x, 1) for x in lat]} ms [{gpu}]", flush=True)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def depthfm_compression_phase(gpu: str) -> None:
    """(d) DepthFMAmodal at 512 px, 4 Euler steps, bf16 batch 4, at six
    points: exact, w8 ("wo"), w4, dynamic W8A8, calibrated W8A8, ToMe-SD
    0.75."""
    import copy

    import torch

    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        capture_depthfm_program
    from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
        DepthFMPipeline

    rng = np.random.default_rng(22)
    hw = (600, 800)
    img = (rng.random((DEPTHFM_BATCH, *hw, 3)) * 255).astype(np.float32)
    mask = np.zeros((DEPTHFM_BATCH, *hw), np.float32)
    mask[:, 150:450, 250:600] = 1.0
    obs = rng.random((DEPTHFM_BATCH, *hw)).astype(np.float32)
    base = DepthFMPipeline.init_random(
        0, tiny=False, size=DEPTHFM_SIZE, num_steps=DEPTHFM_STEPS,
        device="cuda", dtype=torch.bfloat16)
    points = [("exact", None, None),
              ("w8 (wo)", dict(weight_only=True), None),
              ("w4", dict(weight_only=True, bits=4), None),
              ("int8 dynamic", dict(), None),
              ("int8 calibrated", dict(calibration=(img[:1], mask[:1],
                                                    obs[:1])), None),
              (f"ToMe-SD {TOME_SD}", None, TOME_SD)]
    exact = None
    for name, q, tome in points:
        pipe = DepthFMPipeline(copy.deepcopy(base.model), size=DEPTHFM_SIZE,
                               num_steps=DEPTHFM_STEPS, device="cuda",
                               dtype=torch.bfloat16, tome=tome)
        if q is not None:
            t0 = time.time()
            pipe.quantize_int8(**q)
            torch.cuda.synchronize()
            kinds = {}
            for m in pipe.model.modules():
                if type(m).__name__.startswith("Quant"):
                    kinds[m.mode] = kinds.get(m.mode, 0) + 1
            print(f"  DepthFM {name}: quantize_int8 in "
                  f"{time.time() - t0:.1f} s, layers {kinds}", flush=True)
        res = compressed_point(
            f"DepthFM {name}", pipe,
            lambda: capture_depthfm_program(pipe, batch=DEPTHFM_BATCH,
                                            hw=hw),
            pipe, (img, mask, obs), DEPTHFM_LAUNCHES, exact, gpu,
            breakdown=q is None)
        if exact is None:
            exact = res["outputs"]
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    del base
    gc.collect()
    torch.cuda.empty_cache()


def proxy_gate_phase(gpu: str, state_dir: str) -> None:
    """(e) the JAX package's quality ladder over the trained proxies on the
    card (`scripts.proxy_gate_v2`, float32, 224 px, 4 held-out scenes)."""
    from amodal_depth_anything_tpu_torch.scripts import proxy_gate_v2

    t0 = time.time()
    corpus = os.path.join(state_dir, "proxy_gate_scenes")
    try:
        rows = proxy_gate_v2.main(["--size", "224", "--eval-n", "4",
                                   "--device", "cuda", "--corpus-dir",
                                   corpus])
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    check(rows[0]["blended_max_abs"] == 0.0 and all(
        np.isfinite(r["blended_max_abs"]) for r in rows),
        "proxy_gate_v2: the control row is exact, every point finite")
    print(f"  proxy_gate_v2: {len(rows)} points, "
          f"{sum(r['pass'] for r in rows)} pass, in "
          f"{time.time() - t0:.1f} s [{gpu}]", flush=True)


def compression_phase(gpu: str):
    """Phase 12: the serving compression at full width. Returns the forward
    kernel's rows at the merged lengths (bf16) and its launches on the two
    compression paths, (c) and (d), each counted from 0 (the checks of (a)
    and (b), the quality ladder (e) and the serving checks (f) are not
    counted)."""
    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha

    state_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(state_dir, exist_ok=True)
    t0 = time.time()

    def step(what):
        print(f"  {what} (at +{time.time() - t0:.1f} s)", flush=True)

    step("(a) int8 products")
    int8_products_phase(gpu)
    step("(b) the forward kernel at the merged lengths")
    rows = tome_attention_phase(gpu)
    step("(c) vitg + vitl at six compression points")
    mha.launches = 0                      # the amodal path starts here
    base, keep, inputs = amodal_compression_phase(gpu)
    launches = {"amodal": mha.launches}   # ... and ends here
    step("(f) compressed serving state and cli.serve --int8")
    serving_state_phase(gpu, state_dir, base, keep, inputs)
    del base, keep
    gc.collect()
    torch.cuda.empty_cache()
    step("(d) DepthFM at six compression points")
    mha.launches = 0                      # the DepthFM path starts here
    depthfm_compression_phase(gpu)
    launches["depthfm"] = mha.launches    # ... and ends here
    step("(e) proxy_gate_v2 on the trained proxies")
    proxy_gate_phase(gpu, state_dir)
    step("phase 12 done")
    return rows, launches


# the twelfth slice (phase 13): the host codec on the serving and loader
# paths ((b) in phase 9, (c) in phase 11), `cli.infer` on the card's
# machine, int8 for the heuristics, and the serving tuners
INFER_HW = (480, 640)
AUTOTUNE_REPS = 3
LAYER_WALK_SCENES = 4   # held-out scenes a pipeline of the walk is scored on
HEUR_INT8_POINTS = (("exact", None), ("w8", dict(weight_only=True, bits=8)),
                    ("w4", dict(weight_only=True, bits=4)))


def cli_infer_phase(pipe, gpu: str, meanwhile=None) -> tuple:
    """(a) `python -m ...cli.infer` in a subprocess that cannot import cv2,
    PIL or matplotlib, on seeded vitg base + vitl amodal state dicts (the
    phase-10 pipeline's, bf16, written as the reference's .pth files under
    build/ by `write_depth_weights`, kept for phase 14) at 518 px: both
    renders written, equal to the in-process `infer_single_image` of the
    same pipeline. `meanwhile()` runs while the subprocess does. Returns
    (the subprocess's forward-kernel launches, its wrapper's count printed
    at its end; what `meanwhile` returned)."""
    import torch

    from amodal_depth_anything_tpu_torch.utils.host_image import (
        decode_png, encode_png)

    root = os.path.join(BUILD, "smoke_cli_infer")
    os.makedirs(root, exist_ok=True)
    try:
        base, amodal, write_s, nbytes = write_depth_weights(pipe)
        img, _ = synthetic_scene(INFER_HW)
        mask = np.zeros(INFER_HW, np.uint8)
        mask[100:380, 200:520] = 255
        mask[200:260, 300:400] = 0
        for name, arr in (("scene.png", img), ("scene_mask.png", mask)):
            with open(os.path.join(root, name), "wb") as f:
                f.write(encode_png(arr))
        out = os.path.join(root, "out")
        argv = ["--input_image_path", os.path.join(root, "scene.png"),
                "--input_mask_path", os.path.join(root, "scene_mask.png"),
                "--output_folder", out, "--base_ckpt", base,
                "--amodal_ckpt", amodal, "--size", str(SIZE),
                "--dtype", "bfloat16"]
        code = ("import sys\n"
                "for m in ('cv2', 'PIL', 'matplotlib'):\n"
                "    sys.modules[m] = None\n"
                "from amodal_depth_anything_tpu_torch.cli.infer import main\n"
                "from amodal_depth_anything_tpu_torch.ops.flash_attention "
                "import mha\n"
                "mha.launches = 0\n"
                f"main({argv!r})\n"
                "print('flash_attn_fwd launches', mha.launches)\n")
        t1 = time.time()
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            beside = meanwhile() if meanwhile is not None else None
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        wall = time.time() - t1
        found = re.search(r"flash_attn_fwd launches (\d+)", stdout)
        launches = int(found.group(1)) if found else 0
        check(proc.returncode == 0 and launches == DEPTH_LAUNCHES,
              f"cli.infer without cv2, PIL or matplotlib at {SIZE} px bf16: "
              f"exit {proc.returncode}, {launches} flash_attn_fwd launches "
              f"({DEPTH_LAUNCHES}) {stderr.strip()[-400:]!r}")
        raw, amodal_r = pipe.infer_single_image(
            os.path.join(root, "scene.png"),
            os.path.join(root, "scene_mask.png"), os.path.join(root, "in"))
        same = True
        for name, want in (("raw", raw), ("amodal", amodal_r)):
            path = os.path.join(out, f"scene_{name}_depth_rendered.png")
            if not os.path.exists(path):
                same = False
                continue
            with open(path, "rb") as f:
                got = decode_png(f.read())
            same &= got.shape == want.shape and np.array_equal(
                got, want[:, :, ::-1])
        check(same, "cli.infer's two renders equal the in-process "
                    "infer_single_image's, pixel for pixel")
        print(f"  cli.infer subprocess: {nbytes / 1e9:.2f} GB of bf16 .pth "
              f"written in {write_s:.1f} s (kept for phase 14), the CLI took "
              f"{wall:.1f} s (start, load, one {INFER_HW[0]} x {INFER_HW[1]} "
              f"image, two renders{'; beside it' if meanwhile else ''}) "
              f"[{gpu}]", flush=True)
        return launches, beside
    finally:
        shutil.rmtree(root, ignore_errors=True)


def heuristics_int8_phase(app, img, hint, gpu: str) -> int:
    """(d) "prompt_points" at full width (the phase-10 app: SAM ViT-H,
    pix2gestalt at 256 px with 100 DDIM steps, RMBG-1.4, then vitg + vitl
    depth; bf16) exact (the completion phase 10 captured: the call, the
    completion replayed and traced) and with a w8 and a w4 pix2gestalt UNet
    (`quantize_p2g_int8`; their first call captures the quantised
    completion): each one's call (its launches counted over the capture's
    warm-up and the capture), its completion replayed once (ms; no launch
    counted) and its completion / mask / depth delta against exact; then a
    w4-p2g + w8-SAM state saved and restored bit-identical, its bytes beside
    the bf16 state's. Returns the forward kernel's launches over the three
    calls."""
    import copy

    import torch

    from amodal_depth_anything_tpu_torch.heuristics import (
        MaskHeuristics, get_points_from_components)
    from amodal_depth_anything_tpu_torch.heuristics.mask_heuristics import \
        COMPLETION_WARMUP
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha

    mh = app.heuristics
    float_p2g = mh.p2g
    hint_u8 = (hint > 0).astype(np.uint8) * 255
    visible = mh.sam_visible_mask(img, get_points_from_components(hint_u8))
    outs, comps, launches = {}, {}, 0
    # the exact completion phase 10 captured: quantising a copy drops the
    # captures, so they are put back after (phase 14 replays them)
    exact_graphs = dict(mh._completions)
    try:
        for name, q in HEUR_INT8_POINTS:
            if q is not None:
                mh.p2g = copy.deepcopy(float_p2g)
                t0 = time.time()
                done = mh.quantize_p2g_int8(**q)   # drops the captured ones
                print(f"  p2g {name}: quantize_p2g_int8 in "
                      f"{time.time() - t0:.1f} s, {len(done)} layers "
                      f"{sorted(set(done.values()))}", flush=True)
            mha.launches = 0
            t1 = time.perf_counter()
            outs[name] = out = app.predict_arrays(img, hint, "prompt_points",
                                                  seed=0)
            first = time.perf_counter() - t1
            counted = mha.launches
            launches += counted
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            comps[name] = mh.pix2gestalt_completion(img, visible, seed=0)
            replay_ms = (time.perf_counter() - t1) * 1e3
            finite = (all(np.isfinite(out[k]).all()
                          for k in ("mask", "blended"))
                      and np.isfinite(comps[name]).all())
            if q is None:
                # the exact point's completion, captured in phase 10: a
                # traced replay shows its launches
                wall, busy, got = trace_call(
                    lambda: mh.pix2gestalt_completion(img, visible, seed=0))
                pct = None if busy is None else 100 * busy / wall
                check(finite and counted == DEPTH_LAUNCHES
                      and got["flash_attn_fwd"] == HEUR_LAUNCHES,
                      f"prompt_points with the exact p2g UNet: finite; the "
                      f"call counted flash_attn_fwd {counted} times "
                      f"({DEPTH_LAUNCHES}: depth, the completion replayed), "
                      f"a traced completion replay launches it "
                      f"{got['flash_attn_fwd']} times ({HEUR_LAUNCHES})")
                print(f"  prompt_points, p2g exact: call {first:.1f} s, "
                      f"completion replay {replay_ms:.1f} ms, traced wall "
                      f"{wall:.1f} ms, device busy {as_ms(busy)} "
                      f"({'not measured' if pct is None else f'{pct:.1f}%'})"
                      f" [{gpu}]", flush=True)
            else:
                # the call captured the quantised completion (its warm-up
                # and capture counted); the replay launches from the graph
                want = (COMPLETION_WARMUP + 1) * HEUR_LAUNCHES \
                    + DEPTH_LAUNCHES
                check(finite and counted == want
                      and mha.launches == counted,
                      f"prompt_points with the {name} p2g UNet: finite; the "
                      f"call counted flash_attn_fwd {counted} times ({want}: "
                      f"the completion's {HEUR_LAUNCHES} at its "
                      f"{COMPLETION_WARMUP} warm-up and its capture, "
                      f"{DEPTH_LAUNCHES} depth), its replay "
                      f"{mha.launches - counted} more (0)")
                ref = outs["exact"]
                print(f"  prompt_points, p2g {name}: call {first:.1f} s "
                      f"(captures the completion), completion replay "
                      f"{replay_ms:.1f} ms; against exact: completion max "
                      f"abs "
                      f"{float(np.abs(comps[name] - comps['exact']).max()):.4f}"
                      f", mask {int((out['mask'] != ref['mask']).sum())} px "
                      f"differ, base depth "
                      f"{float(np.abs(out['base'] - ref['base']).max()):.4f}"
                      f", blended depth "
                      f"{float(np.abs(out['blended'] - ref['blended']).max()):.4f}"
                      f" [{gpu}]", flush=True)
            if name == "w8":
                mh.p2g = float_p2g
        # a w4-p2g + w8-SAM serving state against the bf16 one
        quant = MaskHeuristics(copy.deepcopy(mh.sam), mh.p2g,
                               matting_fn=mh.matting_fn)
        quant.quantize_sam_int8()
        mh.p2g = float_p2g
        root = os.path.join(BUILD, "smoke_heur_states")
        sizes, paths = {}, {"bf16": os.path.join(root, "bf16"),
                            "int8": os.path.join(root, "int8")}
        try:
            mh.save_serving(paths["bf16"])
            t0 = time.time()
            quant.save_serving(paths["int8"])
            write_s = time.time() - t0
            for key, path in paths.items():
                sizes[key] = sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(path) for f in fs)
            t0 = time.time()
            back = MaskHeuristics.load_serving(paths["int8"], device="cuda")
            torch.cuda.synchronize()
            read_s = time.time() - t0
        finally:
            shutil.rmtree(root, ignore_errors=True)
        same = True
        for a, b in ((quant.sam, back.sam), (quant.p2g, back.p2g),
                     (quant.matting_fn.rmbg_model,
                      back.matting_fn.rmbg_model)):
            sa, sb = a.state_dict(), b.state_dict()
            same &= sorted(sa) == sorted(sb) and all(
                sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
                for k in sa)
        modes = {m.mode for m in back.p2g.unet.modules()
                 if type(m).__name__.startswith("Quant")}
        check(same and modes == {"w4"},
              f"int8 heuristics state (w4 p2g UNet, w8 SAM) restored "
              f"bit-identical, every leaf in its saved dtype (p2g modes "
              f"{sorted(modes)})")
        print(f"  heuristics serving states: bf16 {sizes['bf16'] / 1e9:.3f} "
              f"GB, int8 (w4 p2g, w8 SAM) {sizes['int8'] / 1e9:.3f} GB "
              f"({100 * sizes['int8'] / sizes['bf16']:.1f}%), written in "
              f"{write_s:.1f} s, restored to the card in {read_s:.1f} s "
              f"[{gpu}]", flush=True)
        del back, quant
    finally:
        mh.p2g = float_p2g
        mh._completions.clear()
        mh._completions.update(exact_graphs)
    return launches


def autotune_phase(gpu: str) -> int:
    """(e) `scripts.autotune_serving --family amodal --random` at full width
    (vitg + vitl, 518 px, bf16 batch 4), each candidate captured and timed
    replayed: its rows and its pick. Returns the forward kernel's
    launches."""
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.scripts import autotune_serving

    t0 = time.time()
    mha.launches = 0
    report = autotune_serving.main([
        "--family", "amodal", "--random", "--random_preset", "full",
        "--batch", str(FULL_BATCH), "--size", str(SIZE), "--dtype",
        "bfloat16", "--reps", str(AUTOTUNE_REPS), "--device", "cuda"])
    launches = mha.launches
    rows = report["rows"]
    check([r["config"] for r in rows]
          == autotune_serving.candidate_configs("amodal")
          and all(r["img_per_sec"] > 0 for r in rows)
          and report["best"] is not None and launches > 0,
          f"autotune_serving at full width: {len(rows)} candidates timed, "
          f"pick {report['best']}, {launches} flash_attn_fwd launches")
    for r in rows:
        print(f"    {r['config']:<24} {r['img_per_sec']:8.3f} img/s, p50 "
              f"{r['p50_batch_ms']:7.1f} ms a batch of {FULL_BATCH}, delta "
              f"{r['quality_delta']['max_abs']:.4f} "
              f"({'within' if r['passes_budget'] else 'over'} the budget "
              f"{report['quality_budget']})", flush=True)
    print(f"  autotune_serving (random weights, vitg + vitl at {SIZE} px, "
          f"bf16 batch {FULL_BATCH}, replayed): pick {report['best']} at "
          f"{report['best_img_per_sec']} img/s, in {time.time() - t0:.1f} s "
          f"[{gpu}]", flush=True)
    return launches


def layer_walk_phase(gpu: str) -> int:
    """(f) `scripts.int8_layer_walk` on the trained proxy
    (`checkpoints/proxy`, vitp) at 224 px over LAYER_WALK_SCENES held-out
    scenes: the kept set. Returns the forward kernel's launches."""
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.scripts import int8_layer_walk

    t0 = time.time()
    corpus = os.path.join(BUILD, "layer_walk_scenes")
    mha.launches = 0
    try:
        base, amodal = int8_layer_walk.main([
            "--ckpt", os.path.join("checkpoints", "proxy"), "--size", "224",
            "--eval-n", str(LAYER_WALK_SCENES), "--device", "cuda",
            "--corpus-dir", corpus])
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    launches = mha.launches
    check(len(base) == len(amodal) == 12 and launches > 0,
          f"int8_layer_walk on the trained proxy: kept base blocks "
          f"{np.where(base)[0].tolist()}, amodal blocks "
          f"{np.where(amodal)[0].tolist()}, {launches} flash_attn_fwd "
          f"launches")
    print(f"  int8_layer_walk (trained vitp proxy, 224 px, "
          f"{LAYER_WALK_SCENES} scenes): "
          f"{int(base.sum())}/12 base and {int(amodal.sum())}/12 amodal "
          f"blocks kept in {time.time() - t0:.1f} s [{gpu}]", flush=True)
    return launches


def slice12_phase(heur: list, gpu: str) -> dict:
    """Phase 13: (d) on the phase-10 app, (e), then (a) on its depth
    pipeline with (f) beside it; each path's forward-kernel launches
    counted from 0. `heur`: [the phase-10 app, its scene, its hints],
    emptied here, and left holding the app's heuristics (phase 14 (d)
    replays its captured completion)."""
    import torch

    app, img, hint = heur
    heur.clear()
    t0 = time.time()

    def step(what):
        print(f"  {what} (at +{time.time() - t0:.1f} s)", flush=True)

    launches = {}
    step("(d) prompt_points exact / w8 / w4, an int8 heuristics state")
    launches["heuristics_int8"] = heuristics_int8_phase(app, img, hint, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    step("(e) autotune_serving at full width")
    launches["autotune"] = autotune_phase(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    step("(a) cli.infer without cv2, PIL or matplotlib, and beside it (f) "
         "int8_layer_walk on the trained proxy")
    launches["cli_infer"], launches["layer_walk"] = cli_infer_phase(
        app.pipeline, gpu, meanwhile=lambda: layer_walk_phase(gpu))
    heur.append(app.heuristics)   # for phase 14 (d)
    del app
    print(f"  phase 13 done in {time.time() - t0:.1f} s [{gpu}]", flush=True)
    return launches



# the thirteenth slice (phase 14): the single-card training knobs on vitg
# (`configs/train_discriminative_vitg_singlechip.yaml`: adafactor, remat
# "attn", batch 4) and the data-factory, baseline and checkpoint scripts
VITG_CONFIG = "configs/train_discriminative_vitg_singlechip.yaml"
VITG_BATCH, VITG_ITERS, VITG_BLOCKS = 4, 1, 40
# the knobs compared with the config's adafactor step (whose eager twin in
# the bit-identity check gives its own row): (optimizer, head_tile)
VITG_KNOBS = (("adam", None), ("adam-bf16mu", None), ("adafactor", 1))
P2G_TREE_N, P2G_TREE_HW, P2G_BATCH = 8, 256, 4
P2G_EVAL_SIZE, P2G_OUT = 266, 256       # pix2gestalt's protocol (266 in)
DFM_LABEL_SIZE, DFM_ENSEMBLE, DFM_LABEL_STEPS = 512, 10, 2
JPEG_DIR = os.path.join("tests", "data")   # PIL-made, with PIL's sha256
NO_HOST_LIBS = ("PIL", "cv2", "matplotlib", "safetensors")
WEIGHTS_DIR = os.path.join(BUILD, "smoke_weights")
SLICE13_DIR = os.path.join(BUILD, "smoke_slice13")
PHASE14_CAP_S = 150.0
# the new kernel shapes: vitg at 266 px (19 x 19 + 1 = 362 tokens), the
# SD-1.5 UNet at DepthFM's ensemble batch of 10 at 512 px (self over 4096 /
# 1024 / 256 / 64 latent tokens at d 40 / 80 / 160, and onto 77 keys), and
# the backward pair of the vitg single-card step
SLICE13_FWD_CASES = [((1, 24, 362, 64), 362), ((10, 8, 4096, 40), 4096),
                     ((10, 8, 1024, 80), 1024), ((10, 8, 256, 160), 256),
                     ((10, 8, 64, 160), 64), ((10, 8, 4096, 40), 77)]
SLICE13_BWD_CASE = ((4, 24, 1370, 64), 1370, None)


def write_depth_weights(pipe) -> tuple:
    """The phase-10 pipeline's vitg base and vitl amodal state dicts (bf16)
    as the reference's .pth files in WEIGHTS_DIR, kept for phase 14:
    (base path, amodal path, seconds, bytes)."""
    import torch

    os.makedirs(WEIGHTS_DIR, exist_ok=True)
    base = os.path.join(WEIGHTS_DIR, "depth_anything_v2_vitg.pth")
    amodal = os.path.join(WEIGHTS_DIR, "amodal_vitl.pth")
    t0 = time.time()
    torch.save(pipe.raw_model.state_dict(), base)
    torch.save(pipe.amodal_model.state_dict(), amodal)
    return (base, amodal, time.time() - t0,
            os.path.getsize(base) + os.path.getsize(amodal))


class HostLibsHidden:
    """Within the block, importing PIL, cv2, matplotlib or safetensors
    fails (as on a machine without them)."""

    def __enter__(self):
        self.saved = {m: sys.modules.get(m) for m in NO_HOST_LIBS}
        for m in NO_HOST_LIBS:
            sys.modules[m] = None
        return self

    def __exit__(self, *exc):
        for m, mod in self.saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def write_p2g_tree(root: str) -> list:
    """The pix2gestalt occlusions layout (whole, occlusion, visible and
    whole masks) of P2G_TREE_N textured scenes at P2G_TREE_HW px, as PNGs
    written by the host codec. Returns the stems."""
    from amodal_depth_anything_tpu_torch.utils.image import write_png

    rng = np.random.default_rng(21)
    hw = P2G_TREE_HW
    yy, xx = np.mgrid[:hw, :hw]
    stems = [f"{i:05d}" for i in range(P2G_TREE_N)]
    for i, stem in enumerate(stems):
        img = np.stack([100 + 60 * np.sin(xx / (9.0 + i) + k)
                        + 40 * np.cos(yy / 13.0 - k) for k in range(3)], -1)
        obj = (yy - 128) ** 2 + (xx - 100 - 4 * i) ** 2 < 70 ** 2
        img[obj] = (200, 150 - 5 * i, 70)
        whole = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(
            np.uint8)
        occ = whole.copy()
        bar = (xx > 120) & (xx < 170)
        occ[bar] = (30, 30, 35)
        if i == 0:   # a 16-bit scene depth (pix2gestalt_eval_single's)
            write_png(os.path.join(root, "depth_raw.png"),
                      (20000 + 150 * yy + 40 * xx).astype(np.uint16))
        for sub, name, arr in (
                ("whole", "whole", whole), ("occlusion", "occlusion", occ),
                ("visible_object_mask", "visible_mask",
                 ((obj & ~bar) * 255).astype(np.uint8)),
                ("whole_mask", "whole_mask", (obj * 255).astype(np.uint8))):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            write_png(os.path.join(root, sub, f"{stem}_{name}.png"), arr)
    return stems


def write_depthfm_label_weights(root: str) -> tuple:
    """A seeded plain DepthFM at the SD-1.5 widths as the reference's
    `depthfm-v1.ckpt` (LDM UNet state dict in float16, hparams, noising
    step, empty-text embedding) and its VAE as `vae.safetensors` (the
    port's writer): (ckpt, vae, seconds, bytes)."""
    import torch

    from amodal_depth_anything_tpu_torch.convert.safetensors import \
        save_file
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.models.depthfm import init_depthfm_

    t0 = time.time()
    model = init_depthfm_(get_model("DepthFM", device="cuda"),
                          torch.Generator(device="cuda").manual_seed(31))
    cfg = model.cfg
    ckpt = os.path.join(root, "depthfm-v1.ckpt")
    vae = os.path.join(root, "vae.safetensors")
    torch.save({
        "ldm_hparams": {"context_dim": cfg.context_dim,
                        "model_channels": cfg.model_channels,
                        "channel_mult": list(cfg.channel_mult),
                        "num_heads": cfg.num_heads},
        "noising_step": cfg.noising_step,
        "state_dict": {k: v.detach().half().cpu() for k, v in
                       model.unet.state_dict().items()},
        "empty_text_embedding":
            model.empty_text_embed.detach()[0].float().cpu().numpy(),
    }, ckpt)
    save_file({k: v.detach().cpu() for k, v in model.vae.state_dict().items()},
              vae)
    del model
    torch.cuda.empty_cache()
    return ckpt, vae, time.time() - t0, os.path.getsize(ckpt) + \
        os.path.getsize(vae)


def jpeg_fixtures(root: str) -> list:
    """The checked-in PIL-made JPEGs, each decoded by the native codec (no
    PIL: the baseline decoder where libjpeg is absent) against the sha256
    of PIL's pixels recorded beside them, copied as `sa_{id}.jpg`. Returns
    the ids."""
    import hashlib

    from amodal_depth_anything_tpu_torch.native import imagecodec

    with open(os.path.join(JPEG_DIR, "jpeg_fixtures.json")) as f:
        meta = json.load(f)["files"]
    ids, same = [], True
    for name, info in sorted(meta.items()):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            data = f.read()
        px = np.ascontiguousarray(imagecodec.decode(data))
        same &= list(px.shape) == info["shape"] and \
            hashlib.sha256(px.tobytes()).hexdigest() == info["sha256"]
        sid = name[len("sa_"):-len(".jpg")]
        shutil.copy(os.path.join(JPEG_DIR, name),
                    os.path.join(root, f"sa_{sid}.jpg"))
        ids.append(sid)
    check(same, f"the native codec decodes the {len(meta)} JPEG fixtures "
                f"(4:4:4 / 4:2:2 / 4:2:0 / grey, restart markers) to PIL's "
                f"pixels (sha256), routes {imagecodec.routes()}")
    return ids


def pngs_equal(a_dir: str, b_dir: str) -> tuple:
    """(files compared, files whose samples differ) of the PNGs in a_dir
    against the same names in b_dir (host codec)."""
    from amodal_depth_anything_tpu_torch.utils.image import read_image

    names = sorted(f for f in os.listdir(a_dir) if f.endswith(".png"))
    differ = [n for n in names
              if not os.path.exists(os.path.join(b_dir, n))
              or not np.array_equal(read_image(os.path.join(a_dir, n)),
                                    read_image(os.path.join(b_dir, n)))]
    return len(names), differ


def scripts_subprocess(argv: dict):
    """Start the scripts `argv` names ({name: argv}) in one Python process
    that cannot import PIL, cv2, matplotlib or safetensors; each script's
    forward-kernel launches counted from 0 and printed. The process exits
    with `verify_checkpoints`' code where it runs."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {NO_HOST_LIBS!r}:\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.backends.cudnn.deterministic = True\n"
        "from amodal_depth_anything_tpu_torch.ops.flash_attention "
        "import mha\n"
        "counts, rc = {}, 0\n"
        f"for name, args in {argv!r}.items():\n"
        "    mod = importlib.import_module(\n"
        "        'amodal_depth_anything_tpu_torch.scripts.' + name)\n"
        "    mha.launches = 0\n"
        "    out = mod.main(args)\n"
        "    counts[name] = mha.launches\n"
        "    if name == 'verify_checkpoints':\n"
        "        rc = out\n"
        "print('LAUNCHES ' + json.dumps(counts), flush=True)\n"
        "sys.exit(rc)\n")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def scripts_phase(mh, tree: str, list_path: str, gpu: str) -> dict:
    """(b)-(f): the scripts at full width, seeded weights, bf16 (the .pth
    files are bf16, and the scripts compute in their dtype): (b)
    `sam_pl_gen` over an 8-sample pix2gestalt tree with the phase-10 vitg
    (`.pth`), batch 4; (c) `sam_pl_gen_depthfm` on the 4 JPEG fixtures
    (seeded SD-1.5 UNet + VAE as `depthfm-v1.ckpt` and `vae.safetensors`,
    ensemble 10, 2 steps, 512 px); (d) `pix2gestalt_eval_single` on one
    reconstruction (a JPEG) and `pix2gestalt_inpainting.run` over 2 entries
    on the phase-10 heuristics (100 DDIM steps: the captured completion);
    (e) `batch_inference` on the SAM tree with the vitl guided `.pth`,
    batch 8; (f) `verify_checkpoints --rehearse --skip_chain`. (b), (c),
    (d)'s single reconstruction and (f) run in a subprocess without PIL,
    cv2, matplotlib and safetensors, and (b)-(d)'s written maps equal an
    in-process call's; the in-process calls run with those imports hidden
    too. Returns the forward kernel's launches by script."""
    import argparse

    import torch

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.scripts import (
        batch_inference, pix2gestalt_eval_single, pix2gestalt_inpainting,
        sam_pl_gen, sam_pl_gen_depthfm)

    t0 = time.time()
    base = os.path.join(WEIGHTS_DIR, "depth_anything_v2_vitg.pth")
    amodal = os.path.join(WEIGHTS_DIR, "amodal_vitl.pth")
    roots = {k: os.path.join(SLICE13_DIR, k) for k in
             ("sub", "ours", "jpeg", "dfm", "rehearse", "batch")}
    for path in roots.values():
        os.makedirs(path, exist_ok=True)
    stems = write_p2g_tree(roots["sub"])
    for sub in ("whole", "occlusion", "visible_object_mask", "whole_mask"):
        shutil.copytree(os.path.join(roots["sub"], sub),
                        os.path.join(roots["ours"], sub))
    ids = jpeg_fixtures(roots["jpeg"])
    split = os.path.join(roots["jpeg"], "split.txt")
    with open(split, "w") as f:
        f.write("\n".join(ids) + "\n")
    ckpt, vae, w_s, w_bytes = write_depthfm_label_weights(roots["dfm"])
    rec = os.path.join(roots["jpeg"], f"sa_{ids[0]}.jpg")
    gt = os.path.join(roots["sub"], "depth_raw.png")
    vis = os.path.join(roots["sub"], "visible_object_mask",
                       f"{stems[0]}_visible_mask.png")

    def args_b(tree):
        return ["--data_root", tree, "--base_ckpt", base, "--batch",
                str(P2G_BATCH)]

    def args_c(out):
        return ["--image_dir", roots["jpeg"], "--split", split, "--ckpt",
                ckpt, "--vae_ckpt", vae, "--out_dir", out, "--ensemble",
                str(DFM_ENSEMBLE), "--num_steps", str(DFM_LABEL_STEPS),
                "--size", str(DFM_LABEL_SIZE)]

    def args_d(out):
        return ["--reconstruction", rec, "--raw_depth", gt,
                "--visible_mask", vis, "--checkpoint", base,
                "--output_dir", out]

    t_sub = time.time()
    # two processes, started together: the rehearsal, and (b) (c) (d)
    procs = [scripts_subprocess({"verify_checkpoints": [
                 "--rehearse", roots["rehearse"], "--skip_chain", "--size",
                 "126", "--device", "cuda"]}),
             scripts_subprocess({
                 "sam_pl_gen": args_b(roots["sub"]),
                 "sam_pl_gen_depthfm": args_c(os.path.join(roots["dfm"],
                                                           "sub")),
                 "pix2gestalt_eval_single": args_d(
                     os.path.join(roots["jpeg"], "sub"))})]
    launches = {}
    try:
        with HostLibsHidden():
            # (b) in process
            mha.launches = 0
            sam_pl_gen.main(args_b(roots["ours"]))
            launches["sam_pl_gen"] = mha.launches
            # (c) in process
            mha.launches = 0
            sam_pl_gen_depthfm.main(args_c(os.path.join(roots["dfm"],
                                                        "ours")))
            launches["sam_pl_gen_depthfm"] = mha.launches
            # (d) in process: one reconstruction, then the inpainting
            # baseline over 2 entries on the phase-10 heuristics
            mha.launches = 0
            depth, _ = pix2gestalt_eval_single.main(
                args_d(os.path.join(roots["jpeg"], "ours")))
            launches["pix2gestalt_eval_single"] = mha.launches
            p2g_split = os.path.join(roots["ours"], "split.txt")
            with open(p2g_split, "w") as f:
                f.write("".join(f"sa_{s}.jpg\n" for s in stems[:2]))
            check(mh.p2g_cfg.ddim_steps == HEUR_STEPS,
                  f"pix2gestalt_inpainting at the phase-10 completion's "
                  f"{HEUR_STEPS} DDIM steps (its capture is reused)")
            dav2 = sam_pl_gen.load_raw_dav2(base, torch.device("cuda"))
            mha.launches = 0
            t1 = time.time()
            banks, n_done = pix2gestalt_inpainting.run(
                argparse.Namespace(
                    data_dir=roots["ours"], split=p2g_split,
                    output_dir=os.path.join(roots["ours"], "inpainting"),
                    limit=0, metrics=["rmse_linear", "log10", "delta1_acc"]),
                mh, pix2gestalt_eval_single.make_dav2_apply(
                    dav2, P2G_EVAL_SIZE))
            launches["pix2gestalt_inpainting"] = mha.launches
            inpaint_s = time.time() - t1
            del dav2
            vals = list(banks["align_overall"].result().values())
            check(n_done == 2 and bool(np.isfinite(vals).all())
                  and launches["pix2gestalt_inpainting"]
                  == 2 * VITG_BLOCKS,
                  f"pix2gestalt_inpainting.run over 2 entries: finite "
                  f"aligned metrics {[round(v, 4) for v in vals]}, "
                  f"{launches['pix2gestalt_inpainting']} flash_attn_fwd "
                  f"launches (2 x 40 vitg blocks; the completions replay)")
            # (e) in process: the vitl guided model over the SAM tree
            mha.launches = 0
            t1 = time.time()
            results = batch_inference.main([
                "--checkpoint", amodal, "--base_data_dir", tree,
                "--filenames", list_path, "--output_dir", roots["batch"],
                "--batch", str(TRAIN_BATCH)])
            launches["batch_inference"] = mha.launches
            batch_s = time.time() - t1
        vals = [results[b][m] for b in ("overall", "align_overall")
                for m in results["overall"]]
        with open(os.path.join(roots["batch"], "metrics.txt")) as f:
            n_tables = f.read().count("Evaluation metrics")
        check(bool(np.isfinite(vals).all()) and n_tables == 8
              and launches["batch_inference"] == 24,
              f"batch_inference (vitl, bf16, batch {TRAIN_BATCH}) over "
              f"{BASELINE_TREE} scenes: metrics.txt with {n_tables} bucket "
              f"tables, finite, {launches['batch_inference']} launches")
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    sub_s = time.time() - t_sub
    stdout = "".join(o for o, _ in outs)
    sub_launches = {}
    for found in re.finditer(r"LAUNCHES (\{.*\})", stdout):
        sub_launches.update(json.loads(found.group(1)))
    codes = [p.returncode for p in procs]
    check(codes == [0, 0] and "FAIL" not in stdout
          and len(sub_launches) == 4,
          f"(b), (c), (d), (f) in processes without "
          f"{', '.join(NO_HOST_LIBS)}: exit {codes}, verify_checkpoints "
          f"--rehearse --skip_chain without a FAIL row "
          f"{''.join(e for _, e in outs).strip()[-400:]!r}")
    rows = [ln for ln in stdout.splitlines()
            if re.match(r"^\w+ +(PASS|SKIP|FAIL) ", ln)]
    print(f"  verify_checkpoints --rehearse --skip_chain on the card: "
          f"{sum(' PASS ' in r for r in rows)} PASS, "
          f"{sum(' SKIP ' in r for r in rows)} SKIP, "
          f"{sum(' FAIL ' in r for r in rows)} FAIL", flush=True)
    for what, a, b, want in (
            ("sam_pl_gen depth_da_update_occ",
             os.path.join(roots["sub"], "depth_da_update_occ"),
             os.path.join(roots["ours"], "depth_da_update_occ"), P2G_TREE_N),
            ("sam_pl_gen depth_da_update_combine",
             os.path.join(roots["sub"], "depth_da_update_combine"),
             os.path.join(roots["ours"], "depth_da_update_combine"),
             P2G_TREE_N),
            ("sam_pl_gen_depthfm", os.path.join(roots["dfm"], "sub"),
             os.path.join(roots["dfm"], "ours"), len(ids)),
            ("pix2gestalt_eval_single", os.path.join(roots["jpeg"], "sub"),
             os.path.join(roots["jpeg"], "ours"), 2)):
        n, differ = pngs_equal(a, b)
        check(n == want and not differ,
              f"{what}: the subprocess's {n} maps equal the in-process "
              f"call's ({len(differ)} differ)")
    check(sub_launches.get("sam_pl_gen") == launches["sam_pl_gen"]
          == 2 * (P2G_TREE_N // P2G_BATCH) * VITG_BLOCKS
          and sub_launches.get("sam_pl_gen_depthfm")
          == launches["sam_pl_gen_depthfm"]
          == len(ids) * DFM_LABEL_STEPS * 32,
          f"launches: sam_pl_gen {launches['sam_pl_gen']} (2 forwards x "
          f"{P2G_TREE_N // P2G_BATCH} batches x {VITG_BLOCKS}), "
          f"sam_pl_gen_depthfm {launches['sam_pl_gen_depthfm']} ({len(ids)} "
          f"images x {DFM_LABEL_STEPS} steps x 32); subprocess "
          f"{sub_launches}")
    check(bool(np.isfinite(depth).all()) and depth.shape == (P2G_OUT,
                                                             P2G_OUT),
          f"pix2gestalt_eval_single: finite depth {depth.shape}")
    print(f"  scripts (bf16, seeded): the two subprocesses took {sub_s:.1f} "
          f"s (start, verify_checkpoints' rehearsal beside three scripts), "
          f"inpainting 2 entries {inpaint_s:.1f} s, batch_inference "
          f"{batch_s:.1f} s; DepthFM label weights "
          f"{w_bytes / 1e9:.2f} GB written in {w_s:.1f} s; phase 14 "
          f"(b)-(f) {time.time() - t0:.1f} s [{gpu}]", flush=True)
    shutil.rmtree(SLICE13_DIR, ignore_errors=True)
    return {**{f"{k}_subprocess": v for k, v in sub_launches.items()},
            **launches}


def vitg_overlay(tree: str, list_path: str) -> str:
    """The single-card vitg recipe on the synthetic SAM tree: an overlay
    YAML under build/ (its splits on the tree, no periodic validation,
    saving or visualisation)."""
    path = os.path.join(BUILD, "smoke_vitg_singlechip.yaml")
    split = {"filenames": os.path.abspath(list_path)}
    with open(path, "w") as f:
        json.dump({   # JSON is YAML
            "base_config": [os.path.abspath(VITG_CONFIG)],
            "dataset": {"train": split, "val": split, "vis": split},
            "trainer": {"validation_period": 0, "save_period": 0,
                        "backup_period": 0, "visualization_period": 0}}, f)
    return path


def opt_state_bytes(trainer) -> int:
    return sum(t.numel() * t.element_size()
               for v in trainer.state.opt_state.values()
               if isinstance(v, list) for t in v)


def vitg_cli_start(tree: str, list_path: str) -> tuple:
    """Start (a)'s `cli.train --config
    configs/train_discriminative_vitg_singlechip.yaml` run in a process of
    its own, so that it runs beside the scripts (b)-(f): VITG_ITERS
    iteration on the synthetic SAM tree, its attention launches counted
    from 0 in that process, which prints them with its peak memory and
    seconds as one `VITG_CLI {json}` line. Its output goes to a log under
    build/. Returns (process, overlay, run directory, log)."""
    overlay = vitg_overlay(tree, list_path)
    run_dir = os.path.join(BUILD, "smoke_vitg_run")
    log = os.path.join(BUILD, "smoke_vitg_cli.log")
    argv = ["--config", overlay, "--base_data_dir", tree, "--output_dir",
            run_dir, "--max_iter", str(VITG_ITERS), "--no_wandb",
            "--device", "cuda"]
    code = (
        "import json, time\n"
        "t0 = time.time()\n"
        "import torch\n"
        "from amodal_depth_anything_tpu_torch.cli import train\n"
        "from amodal_depth_anything_tpu_torch.ops.flash_attention "
        "import mha\n"
        f"train.main({argv!r})\n"
        "print('VITG_CLI ' + json.dumps({'launches': {\n"
        "    'flash_attn_fwd': mha.launches,\n"
        "    'flash_attn_bwd_dq': mha.bwd_dq_launches,\n"
        "    'flash_attn_bwd_dkv': mha.bwd_dkv_launches},\n"
        "    'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,\n"
        "    'seconds': time.time() - t0}), flush=True)\n")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=out,
                                stderr=subprocess.STDOUT, text=True)
    return proc, overlay, run_dir, log


def vitg_cli_finish(cli: tuple, tcfg, gpu: str) -> dict:
    """Wait for the `cli.train` process `vitg_cli_start` started and check
    it: exit 0, its latest checkpoint written, 40 + 40 + 40 attention
    launches at each captured program's warm-up steps and capture. Returns
    those launches."""
    from amodal_depth_anything_tpu_torch.utils.graphs import WARMUP_CALLS

    proc, _, run_dir, log = cli
    t0 = time.time()
    try:
        rc = proc.wait(timeout=600)
        with open(log) as f:
            out = f.read()
        print(out.rstrip(), file=sys.stderr, flush=True)
        found = re.search(r"^VITG_CLI (\{.*\})$", out, re.M)
        run = json.loads(found.group(1)) if found else {}
        check(rc == 0 and bool(run), f"cli.train's process: exit {rc}, "
                                     f"its VITG_CLI line read: {bool(run)}")
        launches = run.get("launches", {})
        saved = [os.path.join(d, f) for d, _, fs in os.walk(run_dir)
                 for f in fs if f == "state.pt"]
        check(len(saved) == 1, f"cli.train wrote its latest checkpoint "
                               f"({len(saved)} state.pt)")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    # the recipe's effective batch of 32 is 8 micro-batches of 4 on one
    # card: two programs (accumulate; accumulate and apply), each captured
    micro = tcfg.accumulation_steps
    programs = 2 if micro > 1 else 1
    check(len(launches) == 3
          and all(n == programs * VITG_BLOCKS * (WARMUP_CALLS + 1)
                  for n in launches.values()),
          f"cli.train vitg single-card recipe, {VITG_ITERS} iteration of "
          f"{micro} micro-steps: {launches} launches ({VITG_BLOCKS} of each "
          f"a step at each of the {programs} programs' {WARMUP_CALLS} "
          f"warm-up steps and capture)")
    print(f"  cli.train {VITG_CONFIG} ({VITG_ITERS} iteration = {micro} "
          f"captured micro-steps of {VITG_BATCH} at {SIZE} px, the latest "
          f"checkpoint written) in a process of its own beside (b)-(f): "
          f"{run.get('seconds', float('nan')):.1f} s from its start, "
          f"{time.time() - t0:.1f} s waited for after the knobs, peak memory "
          f"{run.get('peak_gib', float('nan')):.2f} GiB [{gpu}]",
          flush=True)
    return launches


def vitg_singlechip_phase(cli: tuple, tree: str, gpu: str) -> dict:
    """(a) the vitg single-card recipe (adafactor, remat "attn", batch 4,
    bf16, 518 px): each of VITG_KNOBS for two steps (the tiled head
    captured, the optimizers eagerly; beside the `cli.train` process that
    `vitg_cli_start` started, if it still runs): its peak memory,
    optimizer-state bytes and step time; then that process waited for and
    checked (`vitg_cli_finish`); then, alone on the card, the captured
    adafactor step against the eager one and a resume, bit for bit (p50,
    busy share, peak memory). Returns the attention kernels' launches of
    the CLI run."""
    import torch

    from amodal_depth_anything_tpu_torch.cli.train import \
        trainer_config_from_cfg
    from amodal_depth_anything_tpu_torch.data import DatasetMode, get_dataset
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.train import get_trainer_cls
    from amodal_depth_anything_tpu_torch.utils.config import \
        recursive_load_config
    from amodal_depth_anything_tpu_torch.utils.depth_transform import \
        get_depth_normalizer

    overlay = cli[1]
    cfg = recursive_load_config(overlay)
    tcfg = trainer_config_from_cfg(cfg, accumulation_steps=round(
        int(cfg.dataloader.effective_batch_size)
        / int(cfg.dataloader.max_train_batch_size)))
    check((cfg.model.kwargs.encoder, tcfg.optimizer, tcfg.remat,
           tcfg.compute_dtype, int(cfg.dataloader.max_train_batch_size))
          == ("vitg", "adafactor", "attn", "bfloat16", VITG_BATCH),
          f"{VITG_CONFIG}: vitg, adafactor, remat attn, bfloat16, batch "
          f"{VITG_BATCH}")
    normalizer = get_depth_normalizer(cfg.get("depth_normalization"))
    train_ds = get_dataset(cfg.dataset.train.to_dict(), tree,
                           DatasetMode.TRAIN, depth_transform=normalizer)
    # one micro-step an update, no warm-up: every step moves the weights
    base_cfg = dataclasses.replace(tcfg, accumulation_steps=1,
                                   lr_warmup_steps=0, validation_period=0,
                                   save_period=0, visualization_period=0)

    def make(captured, optimizer="adafactor", head_tile=None):
        return get_trainer_cls(cfg.trainer.name)(
            dataclasses.replace(base_cfg, optimizer=optimizer,
                                head_tile=head_tile),
            get_model(cfg.model.name, device="cuda",
                      **cfg.model.kwargs.to_dict()),
            None, device="cuda", seed=0, captured=captured)

    batches = capture_batches(trainer_like(), train_ds,
                              batch_size=VITG_BATCH)
    rows = []
    for optimizer, tile in VITG_KNOBS:
        # the tiled head captured (its chunks recompute in the backward
        # inside the graph), the optimizers eagerly: each beside the same
        # kind of run of the recipe's step. They run while cli.train's
        # process may still run: their memory is this process's alone,
        # their step times have company
        captured = tile is not None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = make(captured, optimizer, tile)
        ms = []
        for b in batches[:2]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = float(trainer._train_step(b))
            ms.append((time.perf_counter() - t1) * 1e3)
        rows.append({"optimizer": optimizer, "head_tile": tile,
                     "captured": captured,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "opt_state_gb": opt_state_bytes(trainer) / 1e9,
                     "step_ms": ms[-1], "loss": loss, "beside": True})
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    launches = vitg_cli_finish(cli, tcfg, gpu)
    summary = captured_step_phase("vitg adafactor train step", make,
                                  batches, gpu, RESUME_CKPT)
    for captured in (False, True):
        rows.insert(0, {"optimizer": "adafactor", "head_tile": None,
                        "captured": captured,
                        "peak_gib": summary["peak_gib" if captured
                                            else "eager_peak_gib"],
                        "opt_state_gb": rows[-1]["opt_state_gb"],
                        "step_ms": summary["p50_ms" if captured
                                           else "eager_p50_ms"],
                        "loss": float("nan"), "beside": False})
    for r in rows:
        print(f"    vitg {r['optimizer']:<12} head_tile={r['head_tile']} "
              f"{'captured' if r['captured'] else 'eager'}: peak memory "
              f"{r['peak_gib']:.2f} GiB, optimizer state "
              f"{r['opt_state_gb']:.3f} GB, step {r['step_ms']:.1f} ms"
              f"{' (beside cli.train)' if r['beside'] else ''}, "
              f"loss {r['loss']:.5f} [{gpu}]", flush=True)
    by = {(r["optimizer"], r["head_tile"]): r for r in rows}
    check(by[("adafactor", None)]["opt_state_gb"]
          < by[("adam-bf16mu", None)]["opt_state_gb"]
          < by[("adam", None)]["opt_state_gb"]
          and all(np.isfinite(r["loss"]) for r in rows[2:]),
          "vitg knobs: optimizer state adafactor < adam-bf16mu < adam; the "
          "tiled head's step captured; finite losses")
    return {"launches": launches, "summary": summary, "knobs": rows}


def slice13_kernel_cases(gpu: str) -> dict:
    """The kernels at the new shapes against their plain versions (bf16),
    each timed beside SDPA: the forward at vitg's 266 px and DepthFM's
    ensemble batch of 10, the backward pair at the vitg step's shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = {"flash_attn_fwd": [attention_case(gen, shape, nk, None,
                                              "bfloat16", gpu)
                               | {"q": list(shape), "nk": nk}
                               for shape, nk in SLICE13_FWD_CASES]}
    shape, nk, kv_len = SLICE13_BWD_CASE
    bwd = bwd_case(gen, shape, nk, kv_len, "bfloat16", gpu, {})
    for name, row in bwd.items():
        rows[name] = [row | {"q": list(shape), "nk": nk}]
    torch.cuda.empty_cache()
    return rows


def slice13_alone(gpu: str) -> dict:
    """`--only 14`: phase 10's heuristics and pipeline, their weights
    written as phase 13 (a) writes them, then phase 14."""
    _, heur = heuristics_phase(gpu)
    app = heur[0]
    write_depth_weights(app.pipeline)
    heur.clear()
    mh = app.heuristics
    del app
    gc.collect()
    return slice13_phase(mh, gpu)


def slice13_phase(mh, gpu: str) -> dict:
    """Phase 14: (b)-(f) (the scripts) with (a)'s `cli.train` in a process
    beside them, then the rest of (a) (the vitg single-card training
    knobs), then the kernels at the new shapes; each path's launches
    counted from 0."""
    import torch

    t0 = time.time()

    def step(what):
        print(f"  {what} (at +{time.time() - t0:.1f} s)", flush=True)

    step("(b)-(f) the scripts, (b) (c) (d) (f) also without PIL / cv2 / "
         "matplotlib / safetensors; (a)'s cli.train in a process beside")
    tree, list_path = write_sam_tree(BASELINE_TREE, SIZE)
    cli = vitg_cli_start(tree, list_path)   # (a)'s cli.train, beside
    try:
        scripts = scripts_phase(mh, tree, list_path, gpu)
        gc.collect()
        torch.cuda.empty_cache()
        step("(a) the vitg single-card recipe: the knobs, cli.train's "
             "checks, captured vs eager, resume")
        vitg = vitg_singlechip_phase(cli, tree, gpu)
    finally:
        if cli[0].poll() is None:
            cli[0].kill()
            cli[0].wait()
    gc.collect()
    torch.cuda.empty_cache()
    step("the kernels at the new shapes")
    rows = slice13_kernel_cases(gpu)
    took = time.time() - t0
    print(f"  phase 14 done in {took:.1f} s (cap {PHASE14_CAP_S:.0f} s) "
          f"[{gpu}]", flush=True)
    check(took <= PHASE14_CAP_S, f"phase 14 took {took:.1f} s <= "
                                 f"{PHASE14_CAP_S:.0f} s")
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    return {"scripts": scripts, "vitg": vitg, "rows": rows}


PHASE15_CAP_S = 150.0
SCALE_DIR = os.path.join(BUILD, "scale_out")
SCALE_RANKS = 2          # two ranks sharing the one card, over gloo
SCALE_CALLS = 2          # timed bf16 calls of the tensor-parallel pipeline
SCALE_TOL = 1e-3         # f32 blended map, two ranks vs one process
PIPE_TAPS_TOL = 1e-4     # f32 vitg taps, pipe = 2 vs the sequential trunk
VITG_TAPS = (9, 19, 29, 39)


def _grad_summary(grads: dict) -> dict:
    """Host copies of a few named gradients and the global norm: what the
    ranks and the one-process run compare at full width."""
    import torch

    from amodal_depth_anything_tpu_torch.train.state import global_norm
    keep = ("encoder.pretrained.blocks.11.attn.qkv.weight",
            "encoder.pretrained.blocks.23.mlp.fc2.weight",
            "encoder.depth_head.scratch.output_conv1.weight")
    out = {k: grads[k].detach().float().cpu() for k in keep}
    out["norm"] = torch.as_tensor(global_norm(list(grads.values())).item())
    return out


def _proxy_trainer(mesh, **kw):
    """A float32 trainer on the trained amodal proxy (vitp, 112 px)."""
    from amodal_depth_anything_tpu_torch.convert.weights import (
        load_params_npz, params_from_jax)
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model)
    from amodal_depth_anything_tpu_torch.train import (DiscriminativeTrainer,
                                                       TrainerConfig)

    cfg = DAV2Config(encoder="vitp")
    params = params_from_jax(load_params_npz(
        os.path.join("checkpoints", "proxy", "amodal.npz")), cfg)
    tcfg = TrainerConfig(compute_dtype="float32", remat="attn", **kw)
    return DiscriminativeTrainer(tcfg, build_model(cfg), None, device="cuda",
                                 params=params, mesh=mesh, captured=False)


def _vitl_trainer(mesh, captured, **kw):
    """The vitl recipe's trainer (`configs/train_discriminative_vitl.yaml`,
    as phase 6 makes it) on `mesh`."""
    from amodal_depth_anything_tpu_torch.cli.train import \
        trainer_config_from_cfg
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.train import get_trainer_cls
    from amodal_depth_anything_tpu_torch.utils.config import \
        recursive_load_config

    cfg = recursive_load_config(TRAIN_CONFIG)
    tcfg = dataclasses.replace(
        trainer_config_from_cfg(cfg, accumulation_steps=1),
        lr_warmup_steps=0, validation_period=0, save_period=0,
        visualization_period=0, **kw)
    return get_trainer_cls(cfg.trainer.name)(
        tcfg, get_model(cfg.model.name, device="cuda",
                        **cfg.model.kwargs.to_dict()),
        None, device="cuda", seed=0, mesh=mesh, captured=captured)


def _scale_inputs():
    """(image [4,600,800,3], mask [4,600,800]) for the pipelines, the
    training scenes at 518 px and the proxy's at 112 px (host)."""
    from amodal_depth_anything_tpu_torch.data import collate

    img, hint = synthetic_scene(HEUR_HW)
    imgs = np.stack([np.roll(img, 37 * i, axis=1) for i in range(4)])
    masks = np.stack([np.roll((img[..., 0] > 200).astype(np.float32),
                              37 * i, axis=1) for i in range(4)])
    scenes = SceneDataset(TRAIN_BATCH, SIZE, seed=15)
    proxy = SceneDataset(TRAIN_BATCH, 112, seed=16)
    return (imgs.astype(np.float32), masks,
            collate([scenes[i] for i in range(TRAIN_BATCH)]),
            collate([proxy[i] for i in range(TRAIN_BATCH)]))


def _state_bytes(trainer) -> float:
    """GB of the parameters and optimizer moments this rank holds."""
    n = sum(p.numel() * p.element_size()
            for p in trainer.state.params.values())
    for key in ("mu", "nu"):
        n += sum(t.numel() * t.element_size()
                 for t in trainer.state.opt_state.get(key, []))
    return n / 1e9


def scale_out_one_rank(gpu: str) -> dict:
    """(a) A one-rank NCCL group in this process (`parallel.initialize`
    with a store on localhost): the vitl recipe's step under
    `DiscriminativeTrainer(mesh=make_mesh())` captured, its data all-reduce
    inside the graph, two steps bit-identical to eager; the vitg + vitl
    pipeline with a 1 x 1 mesh captured, the replay bit-identical to its
    eager call. Returns the launches of the two paths."""
    import torch
    import torch.distributed as dist

    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.parallel import initialize, make_mesh
    from amodal_depth_anything_tpu_torch.parallel.multihost import backend
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu_torch.pipeline.aot import \
        capture_amodal_program

    made = initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    check(made and backend() == "nccl",
          f"one-rank group made over {backend()!r} (nccl)")
    try:
        mesh = make_mesh()
        check(tuple(mesh.mesh_dim_names) == ("data", "model")
              and mesh.get_group("data") is not None,
              f"make_mesh() over one rank: {mesh}")
        imgs, masks, train_batch, _ = _scale_inputs()
        dev = [{k: torch.from_numpy(v).cuda() for k, v in train_batch.items()
                if isinstance(v, np.ndarray) and v.dtype != object}] * 2
        mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
        summary = captured_step_phase(
            "vitl recipe step on a one-rank NCCL mesh",
            lambda captured: _vitl_trainer(mesh, captured), dev, gpu,
            RESUME_CKPT, resume=False)
        launches = {"flash_attn_fwd": mha.launches,
                    "flash_attn_bwd_dq": mha.bwd_dq_launches,
                    "flash_attn_bwd_dkv": mha.bwd_dkv_launches}
        # two eager steps, then the capture's warm-ups and the capture (a
        # replay launches from the graph; its trace, printed above, has
        # dropped a graph node's event now and then)
        from amodal_depth_anything_tpu_torch.utils.graphs import \
            WARMUP_CALLS
        want = TRAIN_BLOCKS * (2 + WARMUP_CALLS + 1)
        check(set(launches.values()) == {want},
              f"the vitl step on the mesh counted {launches} attention "
              f"launches ({want} each: 2 eager steps, {WARMUP_CALLS} "
              f"warm-ups and the capture)")
        gc.collect()
        torch.cuda.empty_cache()
        pipe = AmodalDepthPipeline.init_random(
            0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
            dtype=torch.bfloat16, mesh=mesh)
        mha.launches = 0
        eager = pipe(imgs, masks)
        served = capture(lambda: capture_amodal_program(
            pipe, batch=4, hw=HEUR_HW), "vitg + vitl on a one-rank mesh")
        replay = served(imgs, masks)
        launches["pipeline"] = mha.launches
        same = all(np.array_equal(a, b) for a, b in zip(eager, replay))
        check(same and launches["pipeline"] == 4 * DEPTH_LAUNCHES,
              f"vitg + vitl with mesh=1x1 captured: replay bit-identical "
              f"to eager ({same}); {launches['pipeline']} launches over the "
              f"eager call, 2 warm-ups and the capture "
              f"({4 * DEPTH_LAUNCHES})")
        del pipe, served
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _scale_refs() -> None:
    """The one-process runs the ranks are held against, on the card, saved
    under SCALE_DIR: the f32 batch-1 and bf16 batch-4 maps of the seeded
    vitg + vitl pipeline, the vitl recipe's loss and gradients on 8 rows
    (bf16), the proxy's (f32) and the unsharded state's bytes and peak."""
    import torch

    from amodal_depth_anything_tpu_torch.parallel.mesh import LocalMesh
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline

    os.makedirs(SCALE_DIR, exist_ok=True)
    imgs, masks, train_batch, proxy_batch = _scale_inputs()
    refs = {}
    pipe = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=torch.float32)
    refs["f32"] = pipe(imgs[:1], masks[:1])[1]
    pipe = AmodalDepthPipeline(pipe.raw_model, pipe.amodal_model, size=SIZE,
                               device="cuda", dtype=torch.bfloat16)
    refs["bf16"] = pipe(imgs, masks)[1]
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _vitl_trainer(LocalMesh(), False)
    loss, grads = tr.loss_and_grads(tr._device_batch(train_batch))
    refs["vitl"] = (loss.item(), _grad_summary(grads))
    tr._train_step(tr._device_batch(train_batch))
    refs["vitl_bytes"] = _state_bytes(tr)
    refs["vitl_peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del tr, grads
    tr = _proxy_trainer(LocalMesh())
    loss, grads = tr.loss_and_grads(tr._device_batch(proxy_batch))
    refs["proxy"] = (loss.item(), {k: g.cpu() for k, g in grads.items()})
    del tr, grads
    torch.save(refs, os.path.join(SCALE_DIR, "refs.pt"))
    gc.collect()
    torch.cuda.empty_cache()


def _pipelined_proxy_step(pmesh, batch: dict, device) -> tuple:
    """One train step of the trained proxy with its trunk pipelined over
    `pmesh`'s pipe ranks (every rank the whole batch): the gradients, summed
    over the stages (`reduce_stage_grads`), against the sequential step's,
    then an Adam step. Returns (worst gradient error relative to its max
    abs, whether the step moved every parameter's first tensor finitely)."""
    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import (
        load_params_npz, params_from_jax)
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model)
    from amodal_depth_anything_tpu_torch.parallel.pipeline import \
        reduce_stage_grads
    from amodal_depth_anything_tpu_torch.train.state import make_optimizer
    from amodal_depth_anything_tpu_torch.utils.loss import get_loss

    cfg = DAV2Config(encoder="vitp")
    sd = params_from_jax(load_params_npz(
        os.path.join("checkpoints", "proxy", "amodal.npz")), cfg)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
         if isinstance(v, np.ndarray) and v.dtype != object}
    grads, moved = {}, False
    for how in ("seq", "pipe"):
        model = build_model(cfg, device=device)
        model.load_state_dict(sd)
        kw = {"pipeline_mesh": pmesh} if how == "pipe" else {}
        pred = model(b["rgb_int"] / 255.0, guide_rgb=b["guide_rgb_norm"],
                     guide_mask=b["guide"] * 2.0 - 1.0,
                     observation=b["depth_observation"] * 2.0 - 1.0,
                     pipeline_microbatches=2, **kw)
        get_loss("silog_loss")(pred, b["depth_gt"], b["guide"] > 0).backward()
        params = list(model.parameters())
        if how == "pipe":
            reduce_stage_grads(model.encoder.pretrained.blocks, pmesh)
        g = [torch.zeros_like(p) if p.grad is None else p.grad.detach()
             for p in params]
        grads[how] = g
        if how == "pipe":
            tx = make_optimizer(lr=1e-4, total_iter=10, warmup_steps=0)
            state = tx.init(params)
            before = params[0].detach().clone()
            tx.update(params, [x.clone() for x in g], state)
            moved = (not torch.equal(before, params[0])
                     and all(bool(torch.isfinite(p).all()) for p in params))
    worst = max(float((a - r).abs().max()) / float(r.abs().max())
                for a, r in zip(grads["pipe"], grads["seq"])
                if r.abs().max() > 0)
    return worst, moved


def _scale_rank(rank: int, world: int, port: int) -> None:
    """One of the ranks sharing the card over gloo: (b) the tensor-parallel
    vitg + vitl pipeline, (c) data parallelism and FSDP in training, (d) the
    GPipe vitg trunk and a pipelined proxy step. Writes what it measured to
    SCALE_DIR/rank<r>.json; a failed check raises (a non-zero exit)."""
    import torch

    from amodal_depth_anything_tpu_torch.models import layers
    from amodal_depth_anything_tpu_torch.models.dinov2 import (
        DinoVisionTransformer, ViTConfig)
    from amodal_depth_anything_tpu_torch.ops.flash_attention import mha
    from amodal_depth_anything_tpu_torch.parallel import (MeshConfig,
                                                          initialize,
                                                          make_mesh)
    from amodal_depth_anything_tpu_torch.parallel.comm import \
        gloo_cuda_support
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline

    t_start = time.time()
    initialize(f"127.0.0.1:{port}", world, rank, device="cuda")
    out = {"rank": rank, "failures": [], "seconds": {}}

    def need(ok, what):
        if not ok:
            out["failures"].append(what)

    def lap(name, t):
        out["seconds"][name] = round(time.time() - t, 1)

    out["backend"] = torch.distributed.get_backend()
    out["gloo_cuda"] = gloo_cuda_support()
    refs = torch.load(os.path.join(SCALE_DIR, "refs.pt"), weights_only=False)
    imgs, masks, train_batch, proxy_batch = _scale_inputs()

    # (b) vitg + vitl tensor- and sequence-parallel over model = 2
    t = time.time()
    mesh = make_mesh(MeshConfig(data=1, model=world))
    pipe = AmodalDepthPipeline.init_random(
        0, encoder="vitl", base_encoder="vitg", size=SIZE, device="cuda",
        dtype=torch.float32, mesh=mesh)
    heads = set()
    orig = layers.multi_head_attention

    def recording(q, *a, **kw):
        heads.add(tuple(q.shape))
        return orig(q, *a, **kw)
    layers.multi_head_attention = recording
    blended = pipe(imgs[:1], masks[:1])[1]
    err = float(np.abs(blended - refs["f32"]).max())
    out["f32_err"] = err
    need(err <= SCALE_TOL, f"f32 batch 1, model = {world} vs one process: "
                           f"blended max abs {err:.3e} <= {SCALE_TOL}")
    pipe = AmodalDepthPipeline(pipe.raw_model, pipe.amodal_model, size=SIZE,
                               device="cuda", dtype=torch.bfloat16, mesh=mesh)
    pipe(imgs, masks)
    heads.clear()
    lat = []
    mha.launches = 0                      # the tensor-parallel path
    for _ in range(SCALE_CALLS):
        t1 = time.perf_counter()
        blended = pipe(imgs, masks)[1]
        lat.append((time.perf_counter() - t1) * 1e3)
    out["tp_launches"] = mha.launches
    layers.multi_head_attention = orig
    out["tp_heads"] = sorted(heads)
    out["tp_ms"] = lat
    out["bf16_delta"] = float(np.abs(blended - refs["bf16"]).max())
    need(mha.launches == DEPTH_LAUNCHES * SCALE_CALLS,
         f"{mha.launches} forward launches over {SCALE_CALLS} calls "
         f"({DEPTH_LAUNCHES} a call)")
    need(sorted(heads) == [(4, 8, 1370, 64), (4, 12, 1370, 64)],
         f"the kernel ran on the local heads: {sorted(heads)}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    lap("b", t)

    # (c) data parallelism: 2 ranks of 4 rows against one process of 8
    t = time.time()
    dmesh = make_mesh(MeshConfig(data=world))
    tr = _proxy_trainer(dmesh)
    mha.launches = mha.bwd_dq_launches = mha.bwd_dkv_launches = 0
    loss, grads = tr.loss_and_grads(tr._device_batch(proxy_batch))
    out["dp_launches"] = [mha.launches, mha.bwd_dq_launches,
                          mha.bwd_dkv_launches]
    ref_loss, ref_grads = refs["proxy"]
    worst = max(float((grads[k].cpu() - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in ref_grads.items() if g.abs().max() > 0)
    out["proxy_dp"] = {"loss_delta": abs(loss.item() - ref_loss),
                       "worst_grad": worst}
    need(abs(loss.item() - ref_loss) <= PROXY_GRAD_TOL * abs(ref_loss)
         and worst <= PROXY_GRAD_TOL,
         f"proxy f32 data-parallel step vs one process: loss "
         f"{loss.item():.6f} vs {ref_loss:.6f}, worst gradient {worst:.3e} "
         f"of its max abs <= {PROXY_GRAD_TOL}")
    del tr, grads
    tr = _vitl_trainer(dmesh, None)     # the default: eager over gloo
    need(not tr.captured, "the vitl trainer over gloo on the card defaults "
                          "to eager steps")
    loss, grads = tr.loss_and_grads(tr._device_batch(train_batch))
    got = _grad_summary(grads)
    ref_loss, ref = refs["vitl"]
    out["vitl_dp"] = {"loss": loss.item(), "loss_delta":
                      abs(loss.item() - ref_loss), "grad_delta": {
                          k: float((got[k] - v).abs().max())
                          / max(float(v.abs().max()), 1e-30)
                          for k, v in ref.items()}}
    del grads
    torch.cuda.reset_peak_memory_stats()
    tr._train_step(tr._device_batch(train_batch))
    out["dp_bytes"] = _state_bytes(tr)
    out["dp_peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _vitl_trainer(dmesh, False, fsdp=True)
    loss = float(tr._train_step(tr._device_batch(train_batch)))
    out["fsdp"] = {"loss": loss, "bytes": _state_bytes(tr),
                   "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "sharded": sum(not p.replicated
                                  for p in tr.placements.values())}
    need(np.isfinite(loss) and out["fsdp"]["bytes"]
         < 0.6 * refs["vitl_bytes"],
         f"fsdp over data = {world}: finite loss {loss:.5f}, parameter + "
         f"Adam bytes {out['fsdp']['bytes']:.3f} GB a rank against "
         f"{refs['vitl_bytes']:.3f} GB unsharded")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    lap("c", t)

    # (d) vitg's trunk over pipe = 2: taps against the sequential trunk
    t = time.time()
    pmesh = make_mesh(MeshConfig(data=1, model=1, pipe=world))
    vit = DinoVisionTransformer(ViTConfig.preset("vitg")).cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for q in vit.parameters():
        q.data.normal_(0.0, 0.02, generator=gen)
    x = torch.rand(2, SIZE, SIZE, 3, device="cuda", generator=gen)
    with torch.no_grad():
        seq = vit.get_intermediate_layers(x, None, VITG_TAPS)
        mha.launches = 0
        piped = vit.get_intermediate_layers(x, None, VITG_TAPS,
                                            pipeline_mesh=pmesh,
                                            pipeline_microbatches=2)
    out["pipe_launches"] = mha.launches
    err = max(float((a - b).abs().max()) for pa, pb in zip(piped, seq)
              for a, b in zip(pa, pb))
    out["pipe_err"] = err
    need(err <= PIPE_TAPS_TOL and mha.launches == 2 * 40 // world,
         f"vitg taps, pipe = {world} vs sequential: max abs {err:.3e} <= "
         f"{PIPE_TAPS_TOL}; {mha.launches} forward launches on this stage")
    del vit, seq, piped
    gc.collect()
    torch.cuda.empty_cache()
    # one pipelined train step on the proxy, its gradients against the
    # sequential step's
    worst, moved = _pipelined_proxy_step(pmesh, proxy_batch, "cuda")
    out["pipe_step_worst_grad"] = worst
    need(moved, "the pipelined step moved the parameters, finite")
    need(worst <= PROXY_GRAD_TOL,
         f"pipelined proxy step: worst gradient {worst:.3e} of its max abs "
         f"<= {PROXY_GRAD_TOL}")
    lap("d", t)
    out["seconds"]["all"] = round(time.time() - t_start, 1)
    with open(os.path.join(SCALE_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    if out["failures"]:
        raise RuntimeError("; ".join(out["failures"]))


def scale_out_phase(gpu: str) -> dict:
    """Phase 15: scale-out on the one card (see the module docstring).
    Returns the launches counted on its paths, each from 0."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.time()
    one = scale_out_one_rank(gpu)
    print(f"  (a) took {time.time() - t0:.1f} s", flush=True)
    t = time.time()
    _scale_refs()
    print(f"  one-process references in {time.time() - t:.1f} s", flush=True)
    t = time.time()
    try:
        mp.spawn(_scale_rank, args=(SCALE_RANKS, free_port()),
                 nprocs=SCALE_RANKS, join=True)
        spawned = True
    except Exception as e:   # noqa: BLE001 -- recorded as a failure
        spawned = False
        check(False, f"the {SCALE_RANKS} ranks: {type(e).__name__}: "
                     f"{str(e)[-600:]}")
    print(f"  {SCALE_RANKS} ranks over gloo took {time.time() - t:.1f} s",
          flush=True)
    ranks = []
    for r in range(SCALE_RANKS):
        path = os.path.join(SCALE_DIR, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    check(spawned and len(ranks) == SCALE_RANKS,
          f"{len(ranks)} of {SCALE_RANKS} ranks exited 0 with their results")
    refs = torch.load(os.path.join(SCALE_DIR, "refs.pt"), weights_only=False)
    for r in ranks:
        print(f"  rank {r['rank']}: backend {r['backend']}; gloo takes CUDA "
              f"tensors for {r['gloo_cuda']} (others staged through pinned "
              f"host memory)", flush=True)
        print(f"  rank {r['rank']} (b) vitg + vitl model = {SCALE_RANKS}: "
              f"f32 batch 1 blended max abs {r['f32_err']:.3e} vs one "
              f"process; bf16 batch 4 calls {[round(x, 1) for x in r['tp_ms']]}"
              f" ms (p50 {np.median(r['tp_ms']):.1f} ms), blended delta "
              f"{r['bf16_delta']:.4f} vs one process; {r['tp_launches']} "
              f"forward launches at {r['tp_heads']} [{gpu}; gloo on one card: "
              f"no measure of scale-out]", flush=True)
        print(f"  rank {r['rank']} (c) proxy f32 data = {SCALE_RANKS}: "
              f"{r['proxy_dp']}; vitl bf16 4 rows a rank vs 8 in one "
              f"process: {r['vitl_dp']}; parameter + Adam "
              f"{r['dp_bytes']:.3f} GB, peak {r['dp_peak']:.2f} GiB; fsdp: "
              f"{r['fsdp']['bytes']:.3f} GB, peak {r['fsdp']['peak']:.2f} "
              f"GiB, {r['fsdp']['sharded']} tensors sharded (one process: "
              f"{refs['vitl_bytes']:.3f} GB, peak {refs['vitl_peak']:.2f} "
              f"GiB) [{gpu}]", flush=True)
        print(f"  rank {r['rank']} (d) vitg pipe = {SCALE_RANKS} taps max "
              f"abs {r['pipe_err']:.3e}, {r['pipe_launches']} launches; "
              f"pipelined proxy step worst gradient "
              f"{r['pipe_step_worst_grad']:.3e}; seconds {r['seconds']}",
              flush=True)
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    took = time.time() - t0
    print(f"  phase 15 took {took:.1f} s (cap {PHASE15_CAP_S:.0f} s) "
          f"[{gpu}]", flush=True)
    check(took <= PHASE15_CAP_S, f"phase 15 took {took:.1f} s <= "
                                 f"{PHASE15_CAP_S:.0f} s")
    launches = {"flash_attn_fwd": one["flash_attn_fwd"] + one["pipeline"],
                "flash_attn_bwd_dq": one["flash_attn_bwd_dq"],
                "flash_attn_bwd_dkv": one["flash_attn_bwd_dkv"]}
    for r in ranks:
        launches["flash_attn_fwd"] += (r["tp_launches"] + r["dp_launches"][0]
                                       + r["pipe_launches"])
        launches["flash_attn_bwd_dq"] += r["dp_launches"][1]
        launches["flash_attn_bwd_dkv"] += r["dp_launches"][2]
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
    stamps = []

    def phase(title: str) -> None:
        stamps.append((title.split("]")[0] + "]", time.time() - started))
        print(f"{title} (at {time.time() - started:.1f} s)", flush=True)

    gpu = card()
    print(f"[1] device: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    apply_precision_policy(torch.float32)
    print(f"  allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch.export can skip "
          f"per-node stack traces: "
          f"{hasattr(torch.fx.config, 'do_not_emit_stack_traces')}",
          flush=True)

    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv else None

    phase("[2] build")
    t0 = time.time()
    reports = _build.build()
    print(f"  built {sorted(reports)} in {time.time() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            entry = ENTRY_NAME.search(line)
            if "Compiling entry function" in line and entry:
                pad = ("" if not entry.group(2) else f"<{entry.group(2)}>"
                       if not entry.group(3)
                       else f"<{entry.group(2)}, {entry.group(3)}>")
                print(f"  {name}: {entry.group(1)}{pad}", flush=True)
            elif "(C7" in line:   # an advisory on a wgmma pipeline
                print(f"  {name}:   {line.strip()[:150]} ...", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"  {name}:   {line.strip()}", flush=True)
    sass_check()
    native_build_check()
    alone = {"6": train_phase, "8": depthfm_train_phase, "9": serving_phase,
             "10": lambda g: (p2g_proxy_phase(), heuristics_phase(g)),
             "11": baselines_phase, "12": compression_phase,
             "13": lambda g: slice12_phase(heuristics_phase(g)[1], g),
             "14": lambda g: slice13_alone(g), "15": scale_out_phase}
    if only is not None:                  # iterate on some phases alone
        for name in only.split(","):
            phase(f"[{name}] alone")
            alone[name](gpu)
            gc.collect()
            torch.cuda.empty_cache()
        for what in failures:
            print(f"FAILED: {what}", flush=True)
        print(f"  took {time.time() - started:.1f} s", flush=True)
        return 1 if failures else 0

    phase("[3] kernels against their plain versions")
    measured = {"flash_attn_fwd": attention_phase(gpu)}
    measured.update(attention_bwd_phase(gpu))
    fwd_rows, bwd_rows = wide_head_rows(gpu)
    measured["flash_attn_fwd"]["d_over_64_device"] = fwd_rows
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        measured[name]["d_over_64_device"] = bwd_rows
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
    heur_launches, heur = heuristics_phase(gpu)
    gc.collect()

    phase("[13] the twelfth slice: int8 heuristics at full width, cli.infer "
          "without cv2 / PIL / matplotlib, autotune_serving, "
          "int8_layer_walk")
    s12_launches = slice12_phase(heur, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[14] the thirteenth slice: the vitg single-card recipe "
          "(adafactor, adam-bf16mu, head_tile) through cli.train; "
          "sam_pl_gen, sam_pl_gen_depthfm, the pix2gestalt baseline, "
          "batch_inference, verify_checkpoints")
    s13 = slice13_phase(heur.pop(), gpu)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[11] evaluation and baselines at full width: ADDeepLab, jo_dpt, "
          "InvisibleStitch; cli.eval, zero-shot eval, infer_image")
    base = baselines_phase(gpu)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[12] serving compression at full width: int8 W8A8 / w8 / w4, "
          "ToMe, ToMe-SD, captured; proxy_gate_v2; cli.serve --int8")
    tome_rows, comp_launches = compression_phase(gpu)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[15] scale-out on the one card: a one-rank NCCL mesh captured; "
          "two ranks over gloo: tensor-parallel vitg + vitl, data-parallel "
          "and FSDP vitl training, the GPipe vitg trunk")
    scale = scale_out_phase(gpu)

    # launches: over the main paths, each counted from 0; the forward
    # kernel runs on twelve (inference [5], training [6], DepthFM [7],
    # DepthFM training and its DDPM finetune [8], serving [9], heuristics
    # [10], compression [12], and [13]'s int8 heuristics, cli.infer (its
    # process's count), autotuner and layer walk), the
    # backward pair on three, the fused epilogue on its chain [3]
    launches["fused_epilogue"] = measured["fused_epilogue"]["launches"]
    launches["flash_attn_bwd_short"] = 0   # none in the vitl step
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **measured[name],
                "launches": launches[name]}
               for name, (source, replaces) in KERNELS.items()]
    vitg = s13["vitg"]["launches"]
    for i, name in enumerate(("flash_attn_fwd", "flash_attn_bwd_dq",
                              "flash_attn_bwd_dkv")):
        kernels[i].update(
            launches=launches[name] + dfm_train[name] + dfm_train["ddpm"][i]
            + base["launches"][name] + vitg[name] + scale[name],
            launches_scale_out=scale[name],
            launches_training=launches[name],
            launches_vitg_singlechip_training=vitg[name],
            slice13_shapes=s13["rows"][name],
            launches_depthfm_training=dfm_train[name],
            launches_ddpm_training=dfm_train["ddpm"][i],
            launches_baselines_and_eval=base["launches"][name],
            baseline_shapes=[{"q": row["q"], "nk": row["nk"],
                              "dtype": row["dtype"], **row[name]}
                             for row in base["rows"]])
    # the short-key backward: DepthFM training and its DDPM finetune (phase
    # 8), each counted from 0 around its path; the baselines run none
    # (phase 11 checks)
    next(k for k in kernels if k["name"] == "flash_attn_bwd_short").update(
        launches=dfm_train["flash_attn_bwd_short"] + dfm_train["ddpm"][3],
        launches_depthfm_training=dfm_train["flash_attn_bwd_short"],
        launches_ddpm_training=dfm_train["ddpm"][3],
        also_replaces=JAX_KERNELS + ":208")
    # serving: the Python counter counts the eager calls, warm-ups and
    # captures; a replay's launches are read from its trace
    kernels[0].update(
        launches=kernels[0]["launches"] + infer_launches + depthfm_launches
        + serve_launches + heur_launches + comp_launches["amodal"]
        + comp_launches["depthfm"] + sum(s12_launches.values())
        + sum(s13["scripts"].values()),
        launches_inference=infer_launches, launches_depthfm=depthfm_launches,
        launches_serving=serve_launches, launches_heuristics=heur_launches,
        launches_compression_amodal=comp_launches["amodal"],
        launches_compression_depthfm=comp_launches["depthfm"],
        **{f"launches_{k}": v for k, v in s12_launches.items()},
        **{f"launches_{k}": v for k, v in s13["scripts"].items()},
        launches_per_replay_traced=per_replay,
        **{f"launches_{k}_short_keys": v for k, v in SHORT_LAUNCHES.items()},
        compression_shapes=tome_rows)
    ends = [t for _, t in stamps[1:]] + [time.time() - started]
    print(f"  all phases took {time.time() - started:.1f} s: "
          f"{[(name, round(end - t, 1)) for (name, t), end in zip(stamps, ends)]}",
          flush=True)
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
