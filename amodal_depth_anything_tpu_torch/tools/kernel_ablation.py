"""Where a tensor-core kernel's time goes, by taking parts of it out.

    python -m amodal_depth_anything_tpu_torch.tools.kernel_ablation \
        [--only LIBRARY:ABLATION,...]

Needs one NVIDIA Hopper card and nvcc. Copies `csrc/` into
`build/kernel_ablation/`, and for each ablation below edits the copy of one
source (every edit must find its text, so a source that has moved on fails
loudly), rebuilds that library and times it at the main paths' shapes in
bfloat16: the device time per call from a torch.profiler trace (the UNet's
shapes at d > 64 take less time on the card than a launch takes the host).
The results of an ablated kernel are wrong on purpose: only its time is
read. The sources in the package are never touched. `--only` runs the named
ablations alone (e.g. `flash_attn_fwd:full,flash_attn_fwd:keys128`).

What the ablations say (the shapes below hold the d = 64, 40, 80 and 160
instantiations of each kernel):
  flash_attn_fwd  no_softmax: the two products, the loads and the barriers;
                  no_exp: the softmax with a multiply-add in place of each
                  exponential (the FP32 work without the MUFU unit);
                  no_products: the softmax path alone; and an alternative
                  the design turned down: 128-key K/V tiles at d = 80, as
                  up to 64 (keys128).
  flash_attn_bwd  the same three for the dQ and the dK/dV kernels: no P
                  and dS rebuild (no_softmax), no exponentials (no_exp),
                  no wgmma (no_products), each timed for both kernels; the
                  first and the last in the split dK/dV kernels of d = 80
                  and 160 too, where one warpgroup sums dV and hands P^T to
                  the other, which sums dK (split_no_softmax: no
                  exponentials and no dS; split_no_products); and three
                  alternatives the design turned down: a ring of three
                  stages instead of four (three_stages), dK/dV with tile
                  t's score products in flight beside tile t-1's
                  accumulating products, as dQ does (dkv_pipelined: ptxas
                  then serialises its wgmmas at KSTEPS 3 and 4, C7512), and
                  at d = 80 each warpgroup summing both dK and dV over its
                  own 64 key rows, as up to d = 64 (dkv80_joint: 144
                  registers, C7512). The split dQ kernel of d = 160,
                  where one warpgroup computes S and P and hands P to the
                  other, which computes dP, dS and dQ: without P and dS
                  (dq_split_no_softmax), without wgmma
                  (dq_split_no_products), and three alternatives: the
                  first warpgroup computing S, dP and dS and handing dS
                  over (dq_split_by_ds: two products against one), the
                  split at d = 80 too (dq80_split), and at d = 160 each
                  warpgroup on its own 64 query rows, as up to d = 80
                  (dq160_joint: 144 registers and more).
  fused_epilogue  product_only: no residual load, no epilogue arithmetic,
                  no store; epilogue_only: one k tile per output tile.
A part that is hidden behind another costs nothing when it is taken out.
Each build's ptxas C75xx advisories are printed beside the times (C7510-C7515:
wgmmas serialised; C7519, an injected warpgroup.arrive, is informational).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys

ATTN_SHAPES = [(4, 24, 1370, 64), (1, 24, 5330, 64), (4, 8, 4096, 40),
               (4, 8, 1024, 80), (4, 8, 256, 160)]
BWD_SHAPES = [(8, 16, 1370, 64), (1, 24, 5330, 64), (4, 8, 4096, 40),
              (8, 8, 1024, 80), (8, 8, 256, 160)]
GEMM_SHAPES = [(42640, 1536, 1536), (42640, 1024, 1024), (5480, 4096, 1536)]

# the dK/dV consumer loop of csrc/flash_attn_bwd.cu, and the same loop with
# tile t's score products issued beside tile t-1's accumulating products
DKV_LOOP = """\
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        float st[32], dpt[32];
        mbar_wait(sm.full + stage, phase);
        turn_wait(wg);
        wgmma_fence();
        scores<KSTEPS, T::kResBox, T::kStrBox>(st, kw,
                                               sm.str0 + stage * T::kStrTile);
        wgmma_commit();
        scores<KSTEPS, T::kResBox, T::kStrBox>(dpt, vw,
                                               sm.str1 + stage * T::kStrTile);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();   // S^T is complete, dP^T may still run
        wgmma_pin(st);
        dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);
        wgmma_wait<0>();
        wgmma_pin(dpt);
        dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);
        uint32_t pf[4][4], dsf[4][4];   // P^T and dS^T in bf16
        pack_a(pf, st);
        pack_a(dsf, dpt);

        turn_wait(wg);
        wgmma_fence();   // pf, dsf were written by ordinary code
        accumulate<KSTEPS>(dva, pf, sm.str1 + stage * T::kStrTile);
        accumulate<KSTEPS>(dka, dsf, sm.str0 + stage * T::kStrTile);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();   // the stage is free
        wgmma_pin(dka);
        wgmma_pin(dva);
        if (elected) mbar_arrive(sm.empty + stage);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

"""
DKV_PIPELINED = """\
      uint32_t pf[4][4], dsf[4][4];
      {
        float st[32], dpt[32];
        mbar_wait(sm.full, 0);
        turn_wait(wg);
        wgmma_fence();
        scores<KSTEPS, T::kResBox, T::kStrBox>(st, kw, sm.str0);
        wgmma_commit();
        scores<KSTEPS, T::kResBox, T::kStrBox>(dpt, vw, sm.str1);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();
        wgmma_pin(st);
        dkv_tile_p(st, sm.lse2, c, col0);
        wgmma_wait<0>();
        wgmma_pin(dpt);
        dkv_tile_ds(dpt, st, sm.dl, col0);
        pack_a(pf, st);
        pack_a(dsf, dpt);
      }
      int prev = 0, stage = 1 % T::kStages;
      uint32_t phase = T::kStages == 1;
      for (int t = 1; t < n_tiles; ++t) {
        float st[32], dpt[32];
        mbar_wait(sm.full + stage, phase);
        turn_wait(wg);
        wgmma_fence();
        scores<KSTEPS, T::kResBox, T::kStrBox>(st, kw,
                                               sm.str0 + stage * T::kStrTile);
        wgmma_commit();
        scores<KSTEPS, T::kResBox, T::kStrBox>(dpt, vw,
                                               sm.str1 + stage * T::kStrTile);
        wgmma_commit();
        accumulate<KSTEPS>(dva, pf, sm.str1 + prev * T::kStrTile);
        accumulate<KSTEPS>(dka, dsf, sm.str0 + prev * T::kStrTile);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<2>();
        wgmma_pin(st);
        dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);
        wgmma_wait<1>();
        wgmma_pin(dpt);
        dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);
        wgmma_wait<0>();
        wgmma_pin(dka);
        wgmma_pin(dva);
        if (elected) mbar_arrive(sm.empty + prev);
        pack_a(pf, st);
        pack_a(dsf, dpt);
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      turn_wait(wg);
      wgmma_fence();
      accumulate<KSTEPS>(dva, pf, sm.str1 + prev * T::kStrTile);
      accumulate<KSTEPS>(dka, dsf, sm.str0 + prev * T::kStrTile);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      wgmma_pin(dka);
      wgmma_pin(dva);

"""

# the split dQ kernel's P rebuild (P warpgroup) and dP product (dS warpgroup)
DQ_SPLIT_P = """\
    if ((t + 1) * kWgStream > kv_len)
      dq_tile_p<true>(s, lse2, c, t * kWgStream + col0, kv_len);
    else
      dq_tile_p<false>(s, lse2, c, t * kWgStream + col0, kv_len);
"""
DQ_SPLIT_DP = """\
    scores<KSTEPS, T::kResBox, T::kStrBox>(dp, sm.res1,
                                           sm.str1 + stage * T::kStrTile);
"""

# library -> {ablation: [(text in the source, its replacement), ...]}
ABLATIONS = {
    "flash_attn_fwd": {
        "full": [],
        "no_softmax": [(
            "      softmax_tile(s, m, l, alpha, scale_log2, t * kKeys + col0,\n"
            "                   (t + 1) * kKeys, kv_len);\n",
            "      alpha[0] = alpha[1] = 1.f; l[0] += s[0]; l[1] += s[2];\n")],
        "no_exp": [(
            'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "y = x * 0.001f + 1.f;")],
        "no_products": [
            ("        wgmma_ss<0>(s, kstep_desc(dq, kk, 2 * T::kQBox),\n"
             "                    kstep_desc(dk, kk, 2 * T::kKVBox), kk != 0);\n",
             "        s[kk] = __uint_as_float((uint32_t)(dq + dk) & "
             "0x3fffffffu);\n"),
            ("        wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * "
             "kSwizzleRow));\n",
             "        acc[kk] += __uint_as_float(pf[kk][0] ^ (uint32_t)dv);\n")],
        "keys128": [("  static constexpr int kKeys = KSTEPS <= 4 ? 128 : 64;\n",
                     "  static constexpr int kKeys = KSTEPS <= 5 ? 128 : 64;\n")],
    },
    "flash_attn_bwd": {
        "full": [],
        "no_softmax": [
            ("      dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);\n", ""),
            ("      dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);\n", ""),
            ("    tile(s, dp, t);\n", "")],
        "no_exp": [(
            'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "y = x * 0.001f + 1.f;")],
        "no_products": [
            ("    wgmma_ss<0>(s, kstep_desc(da, kk, 2 * A_BOX),\n"
             "                kstep_desc(db, kk, 2 * B_BOX), kk != 0);\n",
             "    s[kk] = __uint_as_float((uint32_t)(da + db) & "
             "0x3fffffffu);\n"),
            ("    wgmma_rs(acc, f[kk], wgmma_desc_advance(db, kk * "
             "kWgKStepBytes));\n",
             "    acc[kk] += __uint_as_float(f[kk][0] ^ (uint32_t)db);\n")],
        "split_no_softmax": [
            ("    dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);\n"
             "    mbar_wait(sm.pt_empty", "    mbar_wait(sm.pt_empty"),
            ("      dpt[4 * j] = p.x * (dpt[4 * j] - dd.x);\n"
             "      dpt[4 * j + 1] = p.y * (dpt[4 * j + 1] - dd.y);\n"
             "      dpt[4 * j + 2] = p.z * (dpt[4 * j + 2] - dd.x);\n"
             "      dpt[4 * j + 3] = p.w * (dpt[4 * j + 3] - dd.y);\n",
             "      dpt[4 * j] += p.x + dd.x;\n")],
        "split_no_products": [
            ("    scores<KSTEPS, T::kResBox, T::kStrBox>(st, sm.res0,\n"
             "                                           sm.str0 + stage * "
             "T::kStrTile);\n",
             "    st[0] = __uint_as_float((uint32_t)stage & 0x3fffffffu);\n"),
            ("    scores<KSTEPS, T::kResBox, T::kStrBox>(dpt, sm.res1,\n"
             "                                           sm.str1 + stage * "
             "T::kStrTile);\n",
             "    dpt[0] = __uint_as_float((uint32_t)stage & 0x3fffffffu);\n"),
            ("    accumulate<KSTEPS>(acc, pf, sm.str1 + stage * T::kStrTile);\n",
             "    acc[0] += __uint_as_float(pf[0][0]);\n"),
            ("    accumulate<KSTEPS>(acc, dsf, sm.str0 + stage * T::kStrTile);"
             "\n",
             "    acc[0] += __uint_as_float(dsf[0][0]);\n")],
        "dq_split_no_softmax": [
            (DQ_SPLIT_P, ""),
            ("      dp[4 * j] = p.x * (dp[4 * j] - dl[0]);\n"
             "      dp[4 * j + 1] = p.y * (dp[4 * j + 1] - dl[0]);\n"
             "      dp[4 * j + 2] = p.z * (dp[4 * j + 2] - dl[1]);\n"
             "      dp[4 * j + 3] = p.w * (dp[4 * j + 3] - dl[1]);\n",
             "      dp[4 * j] += p.x + dl[0];\n")],
        "dq_split_no_products": [
            ("    scores<KSTEPS, T::kResBox, T::kStrBox>(s, sm.res0,\n"
             "                                           sm.str0 + stage * "
             "T::kStrTile);\n",
             "    s[0] = __uint_as_float((uint32_t)stage & 0x3fffffffu);\n"),
            (DQ_SPLIT_DP,
             "    dp[0] = __uint_as_float((uint32_t)stage & 0x3fffffffu);\n"),
            ("    accumulate<KSTEPS>(acc, dsf, sm.str0 + stage * T::kStrTile);"
             "   // dS K\n",
             "    acc[0] += __uint_as_float(dsf[0][0]);\n")],
        "dq_split_by_ds": [
            ("void dq_split_p(const WgSmem<T>& sm, int n_tiles,\n"
             "                                           const float "
             "(&lse2)[2], float c,\n",
             "void dq_split_p(const WgSmem<T>& sm, int n_tiles,\n"
             "    const float (&lse2)[2], const float (&dl)[2], float c,\n"),
            ("dq_split_p<KSTEPS>(sm, n_tiles, lse2, c,",
             "dq_split_p<KSTEPS>(sm, n_tiles, lse2, dl, c,"),
            ("    float s[32];\n", "    float s[32], dp[32];\n"),
            ("    wgmma_wait<0>();   // done with the stage's K\n"
             "    wgmma_pin(s);\n",
             DQ_SPLIT_DP + "    wgmma_commit();\n    wgmma_wait<0>();\n"
             "    wgmma_pin(s);\n    wgmma_pin(dp);\n"),
            (DQ_SPLIT_P,
             DQ_SPLIT_P.replace("dq_tile_p<true>(s,", "dq_tile<true>(s, dp,")
             .replace("dq_tile_p<false>(s,", "dq_tile<false>(s, dp,")
             .replace("lse2, c,", "lse2, dl, c,")
             + "    #pragma unroll\n"
             "    for (int e = 0; e < 32; ++e) s[e] = dp[e];\n"),
            ("    wgmma_fence();\n" + DQ_SPLIT_DP + "    wgmma_commit();\n"
             "    wgmma_wait<0>();\n    wgmma_pin(dp);\n", ""),
            ("      dp[4 * j] = p.x * (dp[4 * j] - dl[0]);\n"
             "      dp[4 * j + 1] = p.y * (dp[4 * j + 1] - dl[0]);\n"
             "      dp[4 * j + 2] = p.z * (dp[4 * j + 2] - dl[1]);\n"
             "      dp[4 * j + 3] = p.w * (dp[4 * j + 3] - dl[1]);\n",
             "      dp[4 * j] = p.x;\n      dp[4 * j + 1] = p.y;\n"
             "      dp[4 * j + 2] = p.z;\n      dp[4 * j + 3] = p.w;\n")],
        "three_stages": [(
            "  static constexpr int kStages = kRoom / kStageBytes < 4\n"
            "                                     ? kRoom / kStageBytes : 4;",
            "  static constexpr int kStages = kRoom / kStageBytes < 3\n"
            "                                     ? kRoom / kStageBytes : 3;")],
        "dkv_pipelined": [(DKV_LOOP, DKV_PIPELINED)],
        "dkv80_joint": [("constexpr bool kDkvSplit = KSTEPS > 4;",
                         "constexpr bool kDkvSplit = KSTEPS > 5;")],
        "dq80_split": [("constexpr bool kDqSplit = KSTEPS > 5;",
                        "constexpr bool kDqSplit = KSTEPS > 4;")],
        "dq160_joint": [("constexpr bool kDqSplit = KSTEPS > 5;",
                         "constexpr bool kDqSplit = KSTEPS > 10;")],
    },
    "fused_epilogue": {
        "full": [],
        "product_only": [
            ("            mbar_arrive_expect_tx(c_full, 2 * kCTile);\n"
             "            #pragma unroll\n"
             "            for (int c = 0; c < kBoxes; ++c)\n"
             "              tma_load_2d(cs + c * kBox, &map_resid, c_full, "
             "n0 + 64 * c, m0);\n",
             "            mbar_arrive(c_full);\n"),
            ("          tma_store_2d(&map_out, cs + c * kBox, n0 + 64 * c, "
             "m0);\n", "          ;\n"),
            ("          const float2 rv = __bfloat1622float2(*at);\n"
             "          *at = __floats2bfloat162_rn(\n"
             "              rv.x + gv.x * (acc[4 * j + 2 * r] + bv.x),\n"
             "              rv.y + gv.y * (acc[4 * j + 2 * r + 1] + bv.y));\n",
             "          if (acc[4 * j + 2 * r] == 123.456f && gv.x == bv.y)\n"
             "            *at = __floats2bfloat162_rn(1.f, 2.f);\n")],
        "epilogue_only": [(
            "  const int k_tiles = (k + kBK - 1) / kBK;\n"
            "  const int wg = threadIdx.x >> 7;\n\n  if (wg == 2) {\n"
            "    setmaxnreg_dec<40>();\n    if (threadIdx.x == 2 * 128) {\n"
            "      // ---",
            "  const int k_tiles = 1;\n"
            "  const int wg = threadIdx.x >> 7;\n\n  if (wg == 2) {\n"
            "    setmaxnreg_dec<40>();\n    if (threadIdx.x == 2 * 128) {\n"
            "      // ---")],
    },
}


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call of `fn`, every kernel it launches summed."""
    from .head_dim_times import device_times

    return device_times(fn, calls)["all"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="LIBRARY:ABLATION,... to run alone")
    only = ap.parse_args().only
    import torch

    from ..ops import _build
    from ..ops.flash_attention import (flash_attn_bwd_dkv, flash_attn_bwd_dq,
                                       mha, mha_reference)
    from ..ops.fused_epilogue import matmul_scale_residual

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    work = _build.BUILD_DIR.parent / "kernel_ablation"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work / "csrc")
    sources = {name: (_build.CSRC / f"{name}.cu").read_text()
               for name in ABLATIONS}
    _build.CSRC, _build.BUILD_DIR = work / "csrc", work / "lib"

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkvs = [torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for b, h, n, d in ATTN_SHAPES]
    bwds = []   # (q, k, v, dO, LSE, delta); the forward by the plain version
    for b, h, n, d in BWD_SHAPES:
        q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = mha_reference(q, k, v, return_lse=True)
        bwds.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
        del o
    gemms = []
    for m, k, n in GEMM_SHAPES:
        x, r = (torch.randn((m, c), generator=gen, device="cuda")
                .bfloat16() for c in (k, n))
        w = (torch.randn((k, n), generator=gen, device="cuda")
             * 0.02).bfloat16()
        b, g = (torch.randn((n,), generator=gen, device="cuda")
                for _ in range(2))
        gemms.append((x, w, b, g, r))

    for name, ablations in ABLATIONS.items():
        for label, edits in ablations.items():
            if only is not None and f"{name}:{label}" not in only.split(","):
                continue
            text = sources[name]
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{name}/{label}: the source no longer "
                                     f"holds {old[:60]!r}")
                text = text.replace(old, new)
            (_build.CSRC / f"{name}.cu").write_text(text)
            _build._loaded.clear()
            report = _build.build((name,)).get(name, "")
            for line in report.splitlines():
                if "(C75" in line:   # ptxas serialised a wgmma pipeline
                    print(f"{name} {label}: {line.strip()[:120]} ...",
                          flush=True)
            times = []
            if name == "flash_attn_bwd":
                for shape, args in zip(BWD_SHAPES, bwds):
                    scale = shape[3] ** -0.5
                    dq_ms = device_ms(lambda: flash_attn_bwd_dq(
                        *args, sm_scale=scale))
                    dkv_ms = device_ms(lambda: flash_attn_bwd_dkv(
                        *args, sm_scale=scale))
                    times.append(f"{list(shape)} dq {dq_ms:.4f} ms, dk/dv "
                                 f"{dkv_ms:.4f} ms")
            elif name == "flash_attn_fwd":
                for shape, qkv in zip(ATTN_SHAPES, qkvs):
                    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                    times.append(f"{list(shape)} "
                                 f"{device_ms(lambda: mha(q, k, v)):.4f} ms")
            else:
                for shape, args in zip(GEMM_SHAPES, gemms):
                    ms = device_ms(lambda: matmul_scale_residual(*args))
                    times.append(f"{list(shape)} {ms:.4f} ms")
            print(f"{name} {label}: {'; '.join(times)} [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
