"""Where a tensor-core kernel's time goes, by taking parts of it out.

    python -m amodal_depth_anything_tpu_torch.tools.kernel_ablation \
        [--only LIBRARY:ABLATION,...] [--head_dims 40,...] [--ptxas ILi3E]

Needs one NVIDIA Hopper card and nvcc. Copies `csrc/` into
`build/kernel_ablation/`, and for each ablation below edits the copy of one
source (every edit must find its text, so a source that has moved on fails
loudly), rebuilds that library and times it at the main paths' shapes in
bfloat16: the device time per call from a torch.profiler trace (the UNet's
shapes at d > 64 take less time on the card than a launch takes the host).
The results of an ablated kernel are wrong on purpose: only its time is
read. The sources in the package are never touched. `--only` runs the named
ablations alone (e.g. `flash_attn_fwd:full,flash_attn_fwd:keys128`; a label
"a+b" applies a's edits, then b's), `--head_dims` times the attention
shapes of those head dims alone, and `--ptxas` prints ptxas's `-v` lines
(registers, stack, spills) of each kernel function whose mangled name holds
the given text.

What the ablations say (the shapes below hold the d = 64, 40, 80 and 160
instantiations of each kernel):
  flash_attn_fwd  no_softmax: the two products, the loads and the barriers;
                  no_exp: the softmax with a multiply-add in place of each
                  exponential (the FP32 work without the MUFU unit);
                  no_products: the softmax path alone (no_qk, no_pv: one
                  product out); and alternatives the design turned down:
                  128-key K/V tiles at d = 80, as up to 64 (keys128); at
                  d = 40 the 64-column boxes of the parent (box64_map; of
                  Q or of K and V alone: q_box64, kv_box64), the tile's row
                  sum added to l rescaled first (sum_into_l), the row max
                  and sum on four chains (four_chains), three consumer
                  warpgroups on 192 rows (three_warpgroups: 64-key tiles,
                  ptxas's 128 registers a thread; narrow_keys128 the same
                  on 128 keys: spills, C7512), two on 64-key tiles
                  (narrow_keys64), a ring of six stages
                  (narrow_six_stages), and no turns between the
                  warpgroups (no_turns). The short-key kernel (kv_len
                  <= 80, the cross-attention rows): short_off sends those
                  calls to the streaming kernel (the design it replaced);
                  short_no_softmax and short_no_products take its softmax
                  or its two products out; and the choices of its design,
                  each turned back: two warpgroups on 128 rows a step
                  sharing K and V (short_two_warpgroups), two Q stages
                  (short_two_stages: a larger block, fewer an SM),
                  64-column boxes at d = 40
                  (short_box64), 4-byte stores from the accumulator in
                  place of the TMA store (short_stores4), and one 64-row
                  tile a block (short_one_item: K and V loaded for each).
  flash_attn_bwd  the same three for the dQ and the dK/dV kernels: no P
                  and dS rebuild (no_softmax), no exponentials (no_exp),
                  no wgmma (no_products), each timed for both kernels; the
                  first and the last in the split dK/dV kernels of d = 80
                  and 160 too, where one warpgroup sums dV and hands P^T to
                  the other, which sums dK (split_no_softmax: no
                  exponentials and no dS; split_no_products); and three
                  alternatives the design turned down: a ring of three
                  stages instead of four (three_stages) or of up to eight
                  (eight_stages), dK/dV with tile
                  t's score products in flight beside tile t-1's
                  accumulating products, as dQ does (dkv_pipelined: ptxas
                  then serialises its wgmmas at KSTEPS 3 and 4, C7512), and
                  at d = 80 each warpgroup summing both dK and dV over its
                  own 64 key rows, as up to d = 64 (dkv80_joint: 144
                  registers, C7512). At d = 40 (KSTEPS 3): 64-column
                  boxes (box64_map); three warpgroups on 192 key rows
                  (dkv_three_warpgroups: 128 registers a thread, spills,
                  C7512); a split block of 64 key rows (dkv40_split: twice
                  the streamed tiles); and three orders of the joint loop:
                  tile t+1's S^T behind tile t's accumulating products
                  (dkv_scores_behind: 112 registers in flight, slower),
                  the same issued under a condition (dkv_scores_early:
                  C7518), dV's product issued under dS^T
                  (dkv_early_dv: three turns a tile, slower). The ablation
                  tool times dK/dV's products (no_score_products,
                  no_acc_products) apart too. The split dQ kernel of d = 160,
                  where one warpgroup computes S and P and hands P to the
                  other, which computes dP, dS and dQ: without P and dS
                  (dq_split_no_softmax), without wgmma
                  (dq_split_no_products), and three alternatives: the
                  first warpgroup computing S, dP and dS and handing dS
                  over (dq_split_by_ds: two products against one), the
                  split at d = 80 too (dq80_split), and at d = 160 each
                  warpgroup on its own 64 query rows, as up to d = 80
                  (dq160_joint: 144 registers and more). dQ at d = 40 on
                  64-column boxes, as before boxes of d columns
                  (dq_box64), and on narrow Q and dO but 64-column K and
                  V boxes (dq_kv_box64); three warpgroups on 192 query
                  rows (dq_three_warpgroups: 128 registers a thread).
                  The short-key backward (kv_len <= 80, timed at DepthFM
                  training's shapes onto 77 keys and the mid block's 64
                  tokens): bwd_short_off times the dQ and dK/dV pair there
                  (the design it replaced, no edit); bwd_short_no_exp,
                  bwd_short_no_sums, bwd_short_no_dq and
                  bwd_short_no_scores take out its exponentials, the dV
                  and dK products, dS K, or S and dP; and the choices of
                  its design, each turned back: the keys as the sums' M
                  (bwd_short_keys_as_m: two m64 chunks for 80 keys, 16
                  KSTEPS registers each), one score warpgroup at d = 40
                  too (bwd_short_one_score), one, two or eight Q/dO stages
                  (bwd_short_one_q_stage, bwd_short_two_q_stages,
                  bwd_short_eight_q_stages) and one P/dS stage
                  (bwd_short_one_p_stage; at d = 40, with two score
                  warpgroups, both rings keep an even count: two and six
                  Q stages, two P stages), 64-column boxes at d = 40
                  (bwd_short_box64), every tile of a head in one block
                  (bwd_short_one_slab: no second pass, fewer blocks) and
                  one tile a block (bwd_short_one_tile: the most slabs);
                  and one alternative: P and dS handed over by one arrive
                  a warp after a __syncwarp, not one a thread
                  (bwd_short_warp_arrives).
  fused_epilogue  product_only: no residual load, no epilogue arithmetic,
                  no store; epilogue_only: one k tile per output tile.
  pad_rows        (both attention libraries) edits nothing: the same kernel
                  on operands whose rows are padded to a multiple of 64
                  columns (128 bytes at d = 40), the head dim still d, so
                  that each row a TMA box reads starts on a 128-byte line;
                  timed at the head dims that are no multiple of 64.
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
               (8, 8, 4096, 40), (4, 8, 1024, 80), (4, 8, 256, 160)]
BWD_SHAPES = [(8, 16, 1370, 64), (1, 24, 5330, 64), (4, 8, 4096, 40),
              (8, 8, 4096, 40), (8, 8, 1024, 80), (8, 8, 256, 160)]
# the forward's cross-attention (q shape, keys), the short-key kernel's
# main-path shapes: pix2gestalt's UNet onto its one context key, DepthFM's
# onto 77, at d = 40, 80 and 160
FWD_CROSS = [((2, 8, 1024, 40), 1), ((4, 8, 4096, 40), 77),
             ((2, 8, 256, 80), 1), ((4, 8, 1024, 80), 77),
             ((2, 8, 64, 160), 1), ((4, 8, 256, 160), 77),
             ((4, 8, 64, 160), 77)]
# the backward onto DepthFM's 77 context keys at d = 40 (batch 4 and the
# training recipe's 8): dQ streams K and V of 77 keys
BWD_CROSS = [((4, 8, 4096, 40), 77), ((8, 8, 4096, 40), 77)]
# the short-key backward's shapes: DepthFM training's onto 77 keys at d =
# 40, 80 and 160 and the mid block's 64-token self-attention
SHORT_BWD = [((4, 8, 4096, 40), 77), ((8, 8, 4096, 40), 77),
             ((8, 8, 1024, 80), 77), ((8, 8, 256, 160), 77),
             ((8, 8, 64, 160), 64)]
GEMM_SHAPES = [(42640, 1536, 1536), (42640, 1024, 1024), (5480, 4096, 1536)]

# the dK/dV consumer loop of csrc/flash_attn_bwd.cu (one batch of wgmmas in
# flight, two turns a tile); the same with tile t+1's S^T issued behind
# tile t's accumulating products (112 registers in flight); and with tile
# t's score products issued beside tile t-1's accumulating products
DKV_LOOP = """\
      // A tile is two batches of wgmmas: S^T = K Q^T and dP^T = V dO^T,
      // then dV += P^T dO and dK += dS^T Q, each batch on a turn of its
      // own, so that one warpgroup's exponentials run under the other's
      // products. Only one batch is in flight per warpgroup: tile t's score
      // accumulators beside tile t-1's accumulating products would need
      // more registers than ptxas has and it would serialise every wgmma
      // (C7512).
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
        turn_pass<WGS>(wg);
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
        turn_pass<WGS>(wg);
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
DKV_SCORES_BEHIND = """\
      // A tile is three batches of wgmmas: dP^T = V dO^T; then dV += P^T dO
      // and dK += dS^T Q together with the next tile's S^T = K Q^T, so that
      // the score product follows the accumulating ones on the tensor cores
      // without a round trip through the warpgroup, and the next tile's
      // P^T runs under its dP^T. Each batch takes a turn, so that one
      // warpgroup's exponentials run under the other's products. In flight
      // beside the accumulating products are S^T and the P^T and dS^T
      // fragments: 112 registers a thread. Both score products there are
      // 144, and ptxas serialises every wgmma (C7512:
      // `tools/kernel_ablation.py`, dkv_pipelined); the last tile is peeled
      // off, since a batch issued under a condition serialises them too
      // (C7518, dkv_scores_early).
      constexpr int kA = T::kResBox, kB = T::kStrBox;
      float st[32], dpt[32];
      uint32_t pf[4][4], dsf[4][4];   // P^T and dS^T in bf16
      const auto score_dp = [&](int stage) {   // dP^T, then P^T and dS^T
        turn_wait(wg);
        wgmma_fence();
        scores<KSTEPS, kA, kB>(dpt, vw, sm.str1 + stage * T::kStrTile);
        wgmma_commit();
        turn_pass<WGS>(wg);
        wgmma_wait<1>();   // S^T is complete, dP^T may still run
        wgmma_pin(st);
        dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);
        wgmma_wait<0>();
        wgmma_pin(dpt);
        dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);
        pack_a(pf, st);
        pack_a(dsf, dpt);
      };
      mbar_wait(sm.full, 0);   // tile 0's S^T: nothing to overlap with yet
      wgmma_fence();
      scores<KSTEPS, kA, kB>(st, kw, sm.str0);
      wgmma_commit();
      score_dp(0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t + 1 < n_tiles; ++t) {
        const int next = stage + 1 == T::kStages ? 0 : stage + 1;
        const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
        mbar_wait(sm.full + next, next_phase);
        turn_wait(wg);
        wgmma_fence();   // pf, dsf were written by ordinary code
        accumulate<KSTEPS>(dva, pf, sm.str1 + stage * T::kStrTile);
        accumulate<KSTEPS>(dka, dsf, sm.str0 + stage * T::kStrTile);
        wgmma_commit();
        scores<KSTEPS, kA, kB>(st, kw, sm.str0 + next * T::kStrTile);
        wgmma_commit();
        turn_pass<WGS>(wg);
        wgmma_wait<1>();   // the accumulating products: the stage is free
        wgmma_pin(dka);
        wgmma_pin(dva);
        if (elected) mbar_arrive(sm.empty + stage);
        stage = next;
        phase = next_phase;
        score_dp(stage);
      }
      turn_wait(wg);   // the last tile's accumulating products
      wgmma_fence();
      accumulate<KSTEPS>(dva, pf, sm.str1 + stage * T::kStrTile);
      accumulate<KSTEPS>(dka, dsf, sm.str0 + stage * T::kStrTile);
      wgmma_commit();
      turn_pass<WGS>(wg);
      wgmma_wait<0>();
      wgmma_pin(dka);
      wgmma_pin(dva);
      if (elected) mbar_arrive(sm.empty + stage);

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
        turn_pass<WGS>(wg);
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
        turn_pass<WGS>(wg);
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
      turn_pass<WGS>(wg);
      wgmma_wait<0>();
      wgmma_pin(dka);
      wgmma_pin(dva);

"""

# two more orders of the same loop that were turned down: tile t's
# accumulating products issued together with tile t+1's S^T, and tile t+1's
# dP^T on a turn of its own (C7518: ptxas serialises them); dV += P^T dO
# issued as soon as P^T is packed, under dS^T (three turns a tile; C7512)
DKV_KERNEL = """\
template <int KSTEPS,   // k16 steps over the head dim: ceil(d / 16) up to 4,
                        // then 5 or 10
          int WGS>"""
DKV_SCORES_EARLY_FN = """\
// A joint dK/dV warpgroup's tiles (dkv_scores_early) over its 64 key rows
// (kw, vw): tile t's dV += P^T dO and dK += dS^T Q go out together with
// tile t+1's S^T = K Q^T, so that the score product follows the
// accumulating ones on the tensor cores without a round trip through the
// warpgroup; tile t+1's dP^T = V dO^T goes out on a turn of its own once
// tile t's stage is free, and P^T's exponentials run under it. Two turns a
// tile, as the joint loop below.
template <int KSTEPS, int WGS, typename T>
__device__ __forceinline__ void dkv_scores_early(
    float (&dka)[8 * KSTEPS], float (&dva)[8 * KSTEPS], const WgSmem<T>& sm,
    const bf16* kw, const bf16* vw, int wg, int n_tiles, float c, int col0,
    bool elected) {
  constexpr int kA = T::kResBox, kB = T::kStrBox;
  float st[32], dpt[32];
  uint32_t pf[4][4], dsf[4][4];   // P^T and dS^T in bf16
  const auto rebuild = [&](int stage) {   // P^T, dS^T of a scored tile
    wgmma_wait<1>();   // S^T is complete, dP^T may still run
    wgmma_pin(st);
    dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);
    wgmma_wait<0>();
    wgmma_pin(dpt);
    dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);
    pack_a(pf, st);
    pack_a(dsf, dpt);
  };
  mbar_wait(sm.full, 0);   // tile 0's scores: nothing to overlap with yet
  turn_wait(wg);
  wgmma_fence();
  scores<KSTEPS, kA, kB>(st, kw, sm.str0);
  wgmma_commit();
  scores<KSTEPS, kA, kB>(dpt, vw, sm.str1);
  wgmma_commit();
  turn_pass<WGS>(wg);
  rebuild(0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    const int next = stage + 1 == T::kStages ? 0 : stage + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
    if (more) mbar_wait(sm.full + next, next_phase);
    turn_wait(wg);
    wgmma_fence();   // pf, dsf were written by ordinary code
    accumulate<KSTEPS>(dva, pf, sm.str1 + stage * T::kStrTile);
    accumulate<KSTEPS>(dka, dsf, sm.str0 + stage * T::kStrTile);
    wgmma_commit();
    if (more) {
      scores<KSTEPS, kA, kB>(st, kw, sm.str0 + next * T::kStrTile);
      wgmma_commit();
    }
    turn_pass<WGS>(wg);
    if (more)
      wgmma_wait<1>();   // the accumulating products: tile t's stage is free
    else
      wgmma_wait<0>();
    wgmma_pin(dka);
    wgmma_pin(dva);
    if (elected) mbar_arrive(sm.empty + stage);
    stage = next;
    phase = next_phase;
    if (!more) break;
    turn_wait(wg);
    wgmma_fence();
    scores<KSTEPS, kA, kB>(dpt, vw, sm.str1 + stage * T::kStrTile);
    wgmma_commit();
    turn_pass<WGS>(wg);
    rebuild(stage);
  }
}

"""
DKV_SCORES_EARLY_LOOP = """\
      dkv_scores_early<KSTEPS, WGS>(dka, dva, sm, kw, vw, wg, n_tiles, c,
                                    col0, elected);

"""
DKV_LATE_DV = """\
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
"""
DKV_EARLY_DV = """\
        uint32_t pf[4][4], dsf[4][4];   // P^T and dS^T in bf16
        pack_a(pf, st);
        turn_wait(wg);
        wgmma_fence();   // pf was written by ordinary code
        accumulate<KSTEPS>(dva, pf, sm.str1 + stage * T::kStrTile);
        wgmma_commit();
        turn_pass<WGS>(wg);
        wgmma_wait<1>();   // dP^T is complete, dV += P^T dO may still run
        wgmma_pin(dpt);
        dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);
        pack_a(dsf, dpt);
        turn_wait(wg);
        wgmma_fence();   // dsf was written by ordinary code
        accumulate<KSTEPS>(dka, dsf, sm.str0 + stage * T::kStrTile);
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

# the forward softmax's row max and row sum, each a chain of N / 2 steps a
# row, and the same on four chains a row joined at the end
# the forward softmax's row max and row sum, each a chain of N / 2 steps a
# row, and the same on four chains a row joined at the end; and the sum as
# it was before (l rescaled by alpha first, each exponential added to it)
SOFTMAX_MAX = """\
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  #pragma unroll
  for (int i = 0; i < N; ++i) {
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) continue;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], NEG ? -s[i] : s[i]);
  }
"""
SOFTMAX_MAX4 = """\
  float mx[2], sum[2] = {0.f, 0.f}, m4[2][4], l4[2][4] = {};
  #pragma unroll
  for (int c = 0; c < 4; ++c) m4[0][c] = m4[1][c] = -INFINITY;
  #pragma unroll
  for (int i = 0; i < N; ++i) {
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) continue;
    float& x = m4[(i >> 1) & 1][(2 * (i >> 2) + (i & 1)) % 4];
    x = fmaxf(x, NEG ? -s[i] : s[i]);
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(m4[r][0], m4[r][1]), fmaxf(m4[r][2], m4[r][3]));
"""
SOFTMAX_SUM = """\
    sum[(i >> 1) & 1] += s[i];
  }
"""
SOFTMAX_SUM4 = """\
    l4[(i >> 1) & 1][(2 * (i >> 2) + (i & 1)) % 4] += s[i];
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r)
    sum[r] = (l4[r][0] + l4[r][1]) + (l4[r][2] + l4[r][3]);
"""
SOFTMAX_JOIN = """\
    m[r] = m_new;
  }
"""
SOFTMAX_JOIN_FIRST = """\
    m[r] = m_new;
    l[r] *= alpha[r];
  }
"""

# the forward's S = Q K^T and P V wgmmas, each for a cheap stand-in
NO_QK = ("        wgmma_ss<0>(s, kstep_desc(dq, kk, 2 * T::kQBox),\n"
         "                    kstep_desc(dk, kk, 2 * T::kKVBox), kk != 0);\n",
         "        s[kk] = __uint_as_float((uint32_t)(dq + dk) & "
         "0x3fffffffu);\n")
NO_PV = ("        wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * "
         "kSwizzleRow));\n",
         "        acc[kk] += __uint_as_float(pf[kk][0] ^ (uint32_t)dv);\n")

# the short-key kernel's S = Q K^T and P V wgmmas
SHORT_QK = ("      wgmma_ss<0>(s, kstep_desc(dq, kk, 2 * T::kQBox),\n"
            "                  kstep_desc(dk, kk, 2 * T::kKVBox), kk != 0);\n",
            "      s[kk] = __uint_as_float((uint32_t)(dq + dk) & "
            "0x3fffffffu);\n")
SHORT_PV = ("      wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * "
            "kSwizzleRow));\n",
            "      acc[kk] += __uint_as_float(pf[kk][0] ^ (uint32_t)dv);\n")

# the forward's key tile: 128 keys up to d = 64 with two warpgroups
KEYS = "  static constexpr int kKeys = KSTEPS <= 4 && WGS == 2 ? 128 : 64;"

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
        "no_products": [NO_QK, NO_PV],
        "no_qk": [NO_QK],
        "no_pv": [NO_PV],
        "keys128": [(KEYS, KEYS.replace("KSTEPS <= 4", "KSTEPS <= 5"))],
        "pad_rows": [],
        "box64_map": [("kNarrowQBoxes = true, kNarrowKVBoxes = true;",
                       "kNarrowQBoxes = false, kNarrowKVBoxes = false;")],
        "q_box64": [("kNarrowQBoxes = true,", "kNarrowQBoxes = false,")],
        "kv_box64": [("kNarrowKVBoxes = true;", "kNarrowKVBoxes = false;")],
        "three_warpgroups": [("constexpr int kNarrowWarpgroups = 2;",
                              "constexpr int kNarrowWarpgroups = 3;")],
        "no_turns": [("turn_wait(wg);", ";"), ("turn_pass<WGS>(wg);", ";")],
        "narrow_keys64": [(KEYS, KEYS.replace("WGS == 2", "KSTEPS != 3"))],
        "four_chains": [(SOFTMAX_MAX, SOFTMAX_MAX4), (SOFTMAX_SUM,
                                                      SOFTMAX_SUM4)],
        "sum_into_l": [
            (SOFTMAX_JOIN, SOFTMAX_JOIN_FIRST),
            ("    sum[(i >> 1) & 1] += s[i];", "    l[(i >> 1) & 1] += s[i];"),
            ("  #pragma unroll\n"
             "  for (int r = 0; r < 2; ++r) "
             "l[r] = l[r] * alpha[r] + sum[r];\n",
             "")],
        "narrow_six_stages": [(
            "  static constexpr int kMaxStages = WGS == 2 ? 3 : 8;",
            "  static constexpr int kMaxStages = KSTEPS == 3 ? 6 : 3;")],
        "narrow_keys128": [
            ("constexpr int kNarrowWarpgroups = 2;",
             "constexpr int kNarrowWarpgroups = 3;"),
            (KEYS, KEYS.replace(" && WGS == 2", ""))],
        "short_off": [("    if (kv_len <= kShortKeys) {   // every key in one tile",
                       "    if (false) {   // every key in one tile")],
        "short_no_softmax": [(
            "    softmax_tile(s, m, l, alpha, scale_log2, col0, NK, kv_len);\n",
            "    m[0] = m[1] = 0.f; l[0] = 1.f + s[0]; l[1] = 1.f + s[2];\n")],
        "short_no_products": [SHORT_QK, SHORT_PV],
        "short_two_warpgroups": [("constexpr int kShortWarpgroups = 1;",
                                  "constexpr int kShortWarpgroups = 2;")],
        "short_two_stages": [("constexpr int kShortStages = 1;",
                              "constexpr int kShortStages = 2;")],
        "short_box64": [("constexpr bool kShortNarrow = true;",
                         "constexpr bool kShortNarrow = false;")],
        "short_stores4": [("constexpr bool kShortTmaStore = true;",
                           "constexpr bool kShortTmaStore = false;")],
        "short_one_item": [(
            "  const int items = tiles < per_wg * T::kWgs ? tiles : per_wg * "
            "T::kWgs;",
            "  const int items = 1 + 0 * per_wg;")],
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
        "no_score_products": [
            ("    wgmma_ss<0>(s, kstep_desc(da, kk, 2 * A_BOX),\n"
             "                kstep_desc(db, kk, 2 * B_BOX), kk != 0);\n",
             "    s[kk] = __uint_as_float((uint32_t)(da + db) & "
             "0x3fffffffu);\n")],
        "no_acc_products": [
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
        "eight_stages": [(
            "  static constexpr int kStages = kRoom / kStageBytes < 4\n"
            "                                     ? kRoom / kStageBytes : 4;",
            "  static constexpr int kStages = kRoom / kStageBytes < 8\n"
            "                                     ? kRoom / kStageBytes : 8;")],
        "three_stages": [(
            "  static constexpr int kStages = kRoom / kStageBytes < 4\n"
            "                                     ? kRoom / kStageBytes : 4;",
            "  static constexpr int kStages = kRoom / kStageBytes < 3\n"
            "                                     ? kRoom / kStageBytes : 3;")],
        "dkv_scores_behind": [(DKV_LOOP, DKV_SCORES_BEHIND)],
        "dkv_pipelined": [(DKV_LOOP, DKV_PIPELINED)],
        "dkv_scores_early": [(DKV_KERNEL, DKV_SCORES_EARLY_FN + DKV_KERNEL),
                             (DKV_LOOP, DKV_SCORES_EARLY_LOOP)],
        "dkv_early_dv": [(DKV_LATE_DV, DKV_EARLY_DV)],
        "dkv40_split": [("kDkvSplit = KSTEPS > 4;",
                         "kDkvSplit = KSTEPS > 4 || KSTEPS == 3;")],
        "dkv80_joint": [("constexpr bool kDkvSplit = KSTEPS > 4;",
                         "constexpr bool kDkvSplit = KSTEPS > 5;")],
        "dq80_split": [("constexpr bool kDqSplit = KSTEPS > 5;",
                        "constexpr bool kDqSplit = KSTEPS > 4;")],
        "dq160_joint": [("constexpr bool kDqSplit = KSTEPS > 5;",
                         "constexpr bool kDqSplit = KSTEPS > 10;")],
        "pad_rows": [],
        "box64_map": [("constexpr bool kNarrowBoxes = true;",
                       "constexpr bool kNarrowBoxes = false;")],
        "dkv_three_warpgroups": [("constexpr int kDkvNarrowWarpgroups = 2;",
                                  "constexpr int kDkvNarrowWarpgroups = 3;")],
        "dq_three_warpgroups": [("constexpr int kDqNarrowWarpgroups = 2;",
                                 "constexpr int kDqNarrowWarpgroups = 3;")],
        "dq_box64": [("constexpr bool kNarrowDqBoxes = true;",
                      "constexpr bool kNarrowDqBoxes = false;")],
        "dq_kv_box64": [("  return T::kNarrow && kv_len >= kWgStream / 2;",
                         "  return T::kNarrow && kv_len < 0;")],
        "bwd_short_off": [],
        "bwd_short_no_exp": [(
            "        const float p = ex2(fmaf(s[i], c, -lse2[(i >> 1) & 1]));",
            "        const float p = fmaf(s[i], c, -lse2[(i >> 1) & 1]);")],
        "bwd_short_no_sums": [(
            "          wgmma_ss<1, 1>(acc[m],\n"
            "                         wgmma_desc_advance(da, kk * "
            "kWgKStepBytes),\n"
            "                         wgmma_desc_advance(db, kk * "
            "kWgKStepBytes), 1);",
            "          acc[m][kk] += __uint_as_float((uint32_t)(da + db) & "
            "0x3fffffffu);")],
        "bwd_short_keys_as_m": [("constexpr bool kShortDRows = true;",
                                 "constexpr bool kShortDRows = false;")],
        "bwd_short_one_q_stage": [(
            "constexpr int kShortQStages = 4;",
            "constexpr int kShortQStages = 1;")],
        "bwd_short_two_q_stages": [(
            "constexpr int kShortQStages = 4;",
            "constexpr int kShortQStages = 2;")],
        "bwd_short_eight_q_stages": [(
            "constexpr int kShortQStages = 4;",
            "constexpr int kShortQStages = 8;")],
        "bwd_short_no_dq": [(
            "        wgmma_rs(acc, f[kk],\n"
            "                 wgmma_desc_advance(kn_desc, kk * "
            "kWgKStepBytes));",
            "        acc[kk] += __uint_as_float(f[kk][0] ^ "
            "(uint32_t)kn_desc);")],
        "bwd_short_no_scores": [
            ("        wgmma_ss<0>(s, kstep_desc(q_desc, kk, 2 * T::kQBox),\n"
             "                    kstep_desc(k_desc, kk, 2 * T::kKVBox), "
             "kk != 0);",
             "        s[kk] = __uint_as_float((uint32_t)(q_desc + k_desc) & "
             "0x3fffffffu);"),
            ("        wgmma_ss<0>(dp, kstep_desc(do_desc, kk, 2 * T::kQBox),\n"
             "                    kstep_desc(v_desc, kk, 2 * T::kKVBox), "
             "kk != 0);",
             "        dp[kk] = __uint_as_float((uint32_t)(do_desc + v_desc) & "
             "0x3fffffffu);")],
        "bwd_short_one_p_stage": [(
            "constexpr int kShortPStages = 2;",
            "constexpr int kShortPStages = 1;")],
        "bwd_short_box64": [("constexpr bool kShortNarrow = true;",
                             "constexpr bool kShortNarrow = false;")],
        "bwd_short_one_slab": [(
            "  *items = tiles < per_block ? tiles : per_block;",
            "  *items = tiles + 0 * per_block;")],
        "bwd_short_one_score": [("constexpr bool kShortTwoScores = true;",
                                 "constexpr bool kShortTwoScores = false;")],
        "bwd_short_warp_arrives": [
            ("      mbar_init(p_full + s, 128);   // every score thread, after "
             "its fence\n      mbar_init(ds_full + s, 128);",
             "      mbar_init(p_full + s, 4);\n"
             "      mbar_init(ds_full + s, 4);"),
            ("      fence_proxy_async();\n      mbar_arrive(p_full + pst);",
             "      fence_proxy_async();\n      __syncwarp();\n"
             "      if ((threadIdx.x & 31) == 0) mbar_arrive(p_full + pst);"),
            ("      fence_proxy_async();\n      mbar_arrive(ds_full + pst);",
             "      fence_proxy_async();\n      __syncwarp();\n"
             "      if ((threadIdx.x & 31) == 0) mbar_arrive(ds_full + pst);")],
        "bwd_short_one_tile": [(
            "  *items = tiles < per_block ? tiles : per_block;",
            "  *items = 1 + 0 * per_block;")],
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


# ablations that edit no source but time the kernel on other operands
PADDED = ("pad_rows",)
# ... or another kernel: the pair where the short-key backward runs
PAIR = ("bwd_short_off",)


def ablation_edits(ablations: dict, label: str) -> list:
    """The edits of ablation `label`, or of each of "a+b+..." in turn."""
    return [edit for part in label.split("+") for edit in ablations[part]]


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call of `fn`, every kernel it launches summed."""
    from .head_dim_times import device_times

    return device_times(fn, calls)["all"]


def padded(t):
    """`t` [..., d] as a view of a zero buffer whose rows are padded to a
    multiple of 64 columns (128 bytes in bfloat16)."""
    import torch

    d = t.shape[-1]
    buf = torch.zeros((*t.shape[:-1], -(-d // 64) * 64), dtype=t.dtype,
                      device=t.device)
    buf[..., :d] = t
    return buf[..., :d]


def ptxas_lines(report: str, wanted: str) -> list[str]:
    """ptxas's `-v` lines (entry, stack and spills, registers) of each
    kernel function whose mangled name holds `wanted`."""
    out, current = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = line.split()[-1] if "properties" in line else \
                line.split("'")[1]
            if wanted in current and "Compiling" in line:
                out.append(current)
        elif current and wanted in current and (
                "stack frame" in line or "Used" in line):
            out.append("  " + line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="LIBRARY:ABLATION,... to run alone")
    ap.add_argument("--head_dims", help="time the attention shapes of these "
                    "head dims alone (comma-separated)")
    ap.add_argument("--ptxas", help="print ptxas -v lines of the kernel "
                    "functions whose mangled name holds this text")
    args = ap.parse_args()
    only = args.only
    import torch

    from ..ops import _build
    from ..ops.flash_attention import (flash_attn_bwd_dkv, flash_attn_bwd_dq,
                                       flash_attn_bwd_short, mha,
                                       mha_reference)
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
    dims = (None if args.head_dims is None
            else {int(d) for d in args.head_dims.split(",")})
    attn_shapes = [s for s in ATTN_SHAPES if dims is None or s[3] in dims]
    bwd_shapes = [(s, s[2]) for s in BWD_SHAPES
                  if dims is None or s[3] in dims]
    bwd_shapes += [c for c in BWD_CROSS if dims is None or c[0][3] in dims]

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkvs = [torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for b, h, n, d in attn_shapes]
    cross = [(shape, nk, *(torch.randn(s, generator=gen, device="cuda",
                                       dtype=torch.bfloat16)
                           for s in (shape, (*shape[:2], nk, shape[3]),
                                     (*shape[:2], nk, shape[3]))))
             for shape, nk in FWD_CROSS if dims is None or shape[3] in dims]
    short_shapes = [c for c in SHORT_BWD if dims is None or c[0][3] in dims]
    bwds = []   # (q, k, v, dO, LSE, delta); the forward by the plain version
    for (b, h, n, d), nk in bwd_shapes + short_shapes:
        q, k, v, do = (torch.randn((b, h, rows, d), generator=gen,
                                   device="cuda", dtype=torch.bfloat16)
                       for rows in (n, nk, nk, n))
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
        labels = list(ablations) if only is None else [
            item.split(":", 1)[1] for item in only.split(",")
            if item.startswith(name + ":")]
        for label in labels:
            text = sources[name]
            for old, new in ablation_edits(ablations, label):
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
            if args.ptxas:
                for line in ptxas_lines(report, args.ptxas):
                    print(f"{name} {label} ptxas: {line}", flush=True)
            pad = any(part in PADDED for part in label.split("+"))
            times = []
            if name == "flash_attn_bwd":
                short_only = label.startswith("bwd_short")
                for (shape, nk), args_ in zip(short_shapes,
                                              bwds[len(bwd_shapes):]):
                    if not short_only and label != "full":
                        break
                    scale = shape[3] ** -0.5
                    if label in PAIR:
                        ms = device_ms(lambda: (
                            flash_attn_bwd_dq(*args_, sm_scale=scale),
                            flash_attn_bwd_dkv(*args_, sm_scale=scale)))
                    else:
                        ms = device_ms(lambda: flash_attn_bwd_short(
                            *args_, sm_scale=scale))
                    times.append(f"{list(shape)} x {nk} short {ms:.4f} ms")
                for (shape, nk), args_ in zip(bwd_shapes, bwds):
                    if short_only:
                        break
                    if pad and shape[3] % 64 == 0:
                        continue
                    if pad:
                        args_ = (*(padded(t) for t in args_[:4]), *args_[4:])
                    scale = shape[3] ** -0.5
                    dq_ms = device_ms(lambda: flash_attn_bwd_dq(
                        *args_, sm_scale=scale))
                    dkv_ms = device_ms(lambda: flash_attn_bwd_dkv(
                        *args_, sm_scale=scale))
                    onto = "" if nk == shape[2] else f" x {nk}"
                    times.append(f"{list(shape)}{onto} dq {dq_ms:.4f} ms, "
                                 f"dk/dv {dkv_ms:.4f} ms")
            elif name == "flash_attn_fwd":
                for shape, qkv in zip(attn_shapes, qkvs):
                    if pad and shape[3] % 64 == 0:
                        continue
                    if pad:
                        qkv = padded(qkv)
                    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                    times.append(f"{list(shape)} "
                                 f"{device_ms(lambda: mha(q, k, v)):.4f} ms")
                for shape, nk, q, k, v in cross:
                    if pad:
                        q, k, v = padded(q), padded(k), padded(v)
                    times.append(f"{list(shape)} x {nk} "
                                 f"{device_ms(lambda: mha(q, k, v)):.4f} ms")
            else:
                for shape, args_ in zip(GEMM_SHAPES, gemms):
                    ms = device_ms(lambda: matmul_scale_residual(*args_))
                    times.append(f"{list(shape)} {ms:.4f} ms")
            print(f"{name} {label}: {'; '.join(times)} [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
