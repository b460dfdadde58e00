// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ by hand.
//
// Replaces the Pallas TPU kernel
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_fwd_kernel
// and computes the same function: O = softmax(sm_scale * Q K^T) V over
// q [B, H, Nq, d] and k, v [B, H, Nk, d], with the softmax in float32 in the
// exp2 domain (log2(e) folded into the scale), keys at index >= kv_len
// excluded, an optional natural-log log-sum-exp per query row, and float32
// or bfloat16 operands. With bfloat16 operands P is rounded to bfloat16
// before P.V and the product accumulates in float32, as on the TPU; float32
// operands run in full float32.
//
// Bound on this card: 4*B*H*Nq*kv_len*d operations against
// 2*B*H*(Nq+kv_len)*d elements moved. Self-attention on the main paths
// (N = 1370 at d = 64, N = 4096 at d = 40) is compute-bound by a wide
// margin; cross-attention onto 77 keys does 2*77 operations per q/o element
// and is memory-bound in bfloat16 (float32 is held to the 67 TFLOP/s of the
// FP32 units outside the tensor cores).
//
// Design. The TPU kernel keeps all of K/V resident in VMEM; at N = 5330 that
// is ~1.4 MB per head, far above the 227 KB of shared memory a block may
// use. Every kernel here streams K/V tiles through shared memory instead and
// keeps an online softmax (running max and sum per row) and the output
// accumulator in float32 registers, dividing by the sum once at the end.
// Query rows past Nq are never stored and key columns past kv_len are masked
// to -inf (their K/V rows load as zero), so no caller has to pad the
// sequence, and Nq and Nk are independent. Operands are addressed through
// (batch, head, token) strides with a unit stride on the head dim, so the
// q/k/v views of one fused qkv projection and an output laid out
// [B, N, H, D] need no copies.
//
// Which kernel runs is a fixed table by dtype, kv_len and head dim d:
//
//   bfloat16, kv_len <= 80
//                       flash_attn_fwd_bf16_short<KSTEPS, NK>, KSTEPS as
//                       below (boxes of d columns at 3), NK 16 up to 16
//                       keys and 80 above (kShortKeys, kShortFewKeys)
//   bfloat16, d <= 32   flash_attn_fwd_bf16_wgmma<ceil(d / 16), 2>
//   bfloat16, d <= 48   flash_attn_fwd_bf16_wgmma<3, 2>, boxes of d columns
//   bfloat16, d <= 64   flash_attn_fwd_bf16_wgmma<4, 2>
//   bfloat16, d <= 80   flash_attn_fwd_bf16_wgmma<5, 2>
//   bfloat16, d <= 160  flash_attn_fwd_bf16_wgmma<10, 2>
//   float32,  d <= 160  flash_attn_fwd_f32<DPAD>, DPAD the smallest of
//                       16, 32, 48, 64, 80, 160 that holds d
//
//  * bfloat16 (the DINOv2 trunks' 64, the SD-1.5 UNet's 40, 80 and 160): the
//    tensor cores' full-rate path, wgmma fed by TMA, FlashAttention-3's
//    shape at its simplest. A block is three warpgroups on 128 query rows
//    (the template's second argument counts the consumer warpgroups).
//    One thread of the producer warpgroup (which gives its registers away
//    with setmaxnreg) starts TMA loads through 4-D tensor maps over (d,
//    token, head, batch) that the C entry encodes from the strides it is
//    given: Q once, then K and V tiles into a ring of three stages, each
//    stage with a "full" and an "empty" mbarrier for K and another pair for
//    V. A tile's head dim lies in 64-column boxes of the 128-byte swizzle
//    (one box up to d = 64, two at 80, three at 160), so the padded widths
//    are 16 * ceil(d / 16) up to 64, then 80 and 160. TMA fills what lies
//    outside the tensor with zeros: rows past Nq or kv_len (the K and V maps
//    end at kv_len) and the columns from d on. At 32 < d <= 48 (the UNet's
//    40) a box is d columns wide instead: TMA zero-fills a 64-column box's
//    last columns in every row at a cost that bounded the kernel, and the
//    narrow box lands in the same swizzled rows; the columns from d to 48
//    are zeroed once in shared memory (kNarrowQBoxes, kNarrowKVBoxes).
//    Each of the two consumer
//    warpgroups owns 64 query rows: S = Q K^T is KSTEPS wgmma m64nKk16 with
//    both operands in shared memory (each k16 step in its box); the online
//    softmax runs on the accumulator fragments in registers; P, rounded to
//    bfloat16, is regrouped in place into m64k16 A fragments (no shuffle)
//    and P.V is one wgmma m64nNk16 a k16 step, N = 16 * ceil(d / 16) up to
//    64 (d = 40 pays for 48 columns, not 64), then 80 and 160, with V as the
//    MN-major B operand straight from its [keys, d] boxes (the descriptor's
//    leading byte offset steps from box to box). K/V tiles are 128 keys up
//    to d = 64 and 64 keys above (FwdTiles). What bounds the kernel is the
//    softmax (FP32 and exp work of two warps a scheduler; each tile's row
//    sums start from zero, so that none waits on the rescale), so the
//    products are made to run under it: tile t's S goes out with tile t-1's
//    P.V, the softmax of tile t runs while P.V is still in flight, and the
//    two warpgroups take turns on the tensor cores over a pair of named
//    barriers, so that one's softmax falls under the other's products.
//  * bfloat16 onto a short key set (kv_len <= 80: the UNets' cross-attention
//    onto DepthFM's 77 context keys and pix2gestalt's one): the streaming
//    kernel would spend a block of one 128-row item on a serial chain of
//    loads, one tile's products and softmax and 4-byte stores, with a
//    three-stage K/V ring in shared memory, 128 or 64-key tiles mostly fill
//    and one block an SM. Here all keys are one tile of NK = 16 or 80, the
//    N of S = Q K^T (wgmma m64n16k16 / m64n80k16), so the softmax is one
//    pass (max, exp2, sum) with no rescale and the mask touches only the
//    last columns. A block is one warpgroup with no producer: K and V land
//    once by TMA and stay; the block's `items` 64-row query tiles of one
//    (batch, head) stream through a ring of Q stages (kShortStages), the
//    next tile's load issued as soon as S has read its stage, so that one
//    tile's load runs under another's softmax and P V; O goes to a swizzled
//    64-row tile in shared memory and out by TMA store (rows past Nq and
//    columns past d are not written). The host sizes `items` so that the
//    grid fills every warpgroup the card holds at once (several blocks
//    share an SM: 37 KB of shared memory at d = 40, 72 at 80), and no
//    more, so that K and V are read again as seldom as that allows.
//  * float32: 256 threads, each 4 rows x 4 keys of the score tile and 4 rows
//    x DPAD/16 columns of the output tile, scalar FMAs on float32 smem
//    tiles: exact to float32 (TF32 tensor cores would lose the parity the
//    float32 path exists for), bounded by the 67 TFLOP/s of the FP32 units.
//    The shared-memory columns from d to DPAD are zero-filled, which changes
//    no result.

#include "sm90.cuh"

namespace {

// ------------------------------------------------------------ float32 path

template <int DPAD>
struct F32Tile : F32Cols<DPAD> {
  static constexpr int kLd = F32Cols<DPAD>::kLd;
  static constexpr int kSmemBytes = 4 * (kBM * kLd      // Q (pre-scaled)
                                         + kBN * kLd    // K
                                         + kBN * DPAD   // V
                                         + kBM * kPLd); // P
};

template <int DPAD>
__global__ void __launch_bounds__(kF32Threads)
flash_attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int nq, int kv_len, int d,
                   float scale_log2, Strides sq, Strides sk, Strides sv,
                   Strides so, long long lse_sb, long long lse_sh) {
  using T = F32Tile<DPAD>;
  constexpr int kLd = T::kLd, kCols = T::kCols, kVec = T::kVec;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBM * kLd;
  float* vs = ks + kBN * kLd;
  float* ps = vs + kBN * DPAD;

  const int tx = threadIdx.x & 15;   // score cols tx + 16j
  const int ty = threadIdx.x >> 4;   // rows 4ty + i
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  stage_tile_f32<DPAD>(qs, kLd, q + b * sq.b + h * sq.h, sq.n, q0, nq,
                       scale_log2, d);

  float m[4], l[4], acc[4][kCols];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    #pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBN) {
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    stage_tile_f32<DPAD>(ks, kLd, kb, sk.n, k0, kv_len, 1.f, d);
    stage_tile_f32<DPAD>(vs, DPAD, vb, sv.n, k0, kv_len, 1.f, d);
    __syncthreads();

    // S = (scale * log2e * Q) K^T for rows 4ty+i, cols tx+16j
    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll 4
    for (int c = 0; c < DPAD; c += 4) {
      float4 qv[4], kv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + c);
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + c);
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // online softmax; every tile holds at least one key < kv_len, so the
    // new running max is finite
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= kv_len) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], lanes16_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + lanes16_sum(rs);
      m[i] = m_new;
      #pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows 4ty+i and this thread's output columns
    #pragma unroll 2
    for (int kk = 0; kk < kBN; kk += 4) {
      float4 pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPLd + kk);
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kCols];
        #pragma unroll
        for (int g = 0; g < T::kGroups; ++g)
          load_vec<kVec>(vv + g * kVec, vs + (kk + u) * DPAD + g * 16 * kVec +
                                            tx * kVec);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          #pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] += p * vv[j];
        }
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= nq) continue;
    const float inv = 1.f / l[i];
    #pragma unroll
    for (int g = 0; g < T::kGroups; ++g) {
      const int col = g * 16 * kVec + tx * kVec;   // d is a multiple of 4
      if (col < d)
        store_vec<kVec>(ob + (long long)row * so.n + col, acc[i] + g * kVec,
                        inv);
    }
    if (lse != nullptr && tx == 0)
      lse[b * lse_sb + h * lse_sh + row] = m[i] * kLn2 + logf(l[i]);
  }
}

// ------------------------------------------- bfloat16 path: wgmma + TMA

// A bf16 block is WGS consumer warpgroups of 64 query rows each, then the
// producer's warpgroup.
template <int WGS>
constexpr int kFwdThreads = 128 * (WGS + 1);

// KSTEPS 3 (33 <= d <= 48) reads Q, K and V in boxes of d columns
// (attention_map in sm90.cuh): a 64-column box over 40 columns costs the
// skeleton alone 0.29 ms at [4,8,4096,40], the boxes of d columns 0.15. It
// keeps two consumer warpgroups: three on 192 rows are compiled for the
// 128 registers a thread of a 512-thread block (setmaxnreg does not raise
// ptxas's count), so they take 64-key tiles and lose to two on 128 keys at
// the UNet's grids (`tools/kernel_ablation.py`, box64_map,
// three_warpgroups; PERF.md).
constexpr bool kNarrowQBoxes = true, kNarrowKVBoxes = true;
constexpr int kNarrowWarpgroups = 2;

// The tiles of flash_attn_fwd_bf16_wgmma<KSTEPS, WGS>: Q (64 WGS rows), then
// a ring of K and V tiles of kKeys keys, each tile kBoxes boxes of 64
// head-dim columns. A tile is 128 keys up to d = 64 and 64 keys above (and
// with three warpgroups, whose 128 registers hold no more). At d = 160,
// 128 keys would tie 176 registers a consumer thread to wgmmas in flight
// (the scores, 64; P as bf16 fragments, 32; the output, 80), past the 168
// a thread of a 384-thread block has. At d = 80 they would tie 136, which
// ptxas still keeps in flight, and take 3-4% less time at 1024 keys but
// about 20% more onto the pix2gestalt UNet's one context key, a tile that
// is nearly all zero fill (`tools/kernel_ablation.py`, keys128; PERF.md).
template <int KSTEPS, int WGS>
struct FwdTiles {
  static constexpr int kBoxes = kHeadBoxes<KSTEPS>;
  static constexpr int kRows = 64 * WGS;           // query rows a block
  static constexpr int kKeys = KSTEPS <= 4 && WGS == 2 ? 128 : 64;
  static constexpr int kQBox = kRows * 64;          // elements of a Q box
  static constexpr int kKVBox = kKeys * 64;         // ... of a K or V box
  static constexpr int kQBytes = 2 * kBoxes * kQBox;
  static constexpr int kKVBytes = 2 * kBoxes * kKVBox;
  static constexpr int kMaxStages = WGS == 2 ? 3 : 8;
  static constexpr int kRoom = kSmemMax - kSwizzleAtom -
                               (1 + 4 * kMaxStages) * 8 - kQBytes;
  static constexpr int kStages = kRoom / (2 * kKVBytes) < kMaxStages
                                     ? kRoom / (2 * kKVBytes) : kMaxStages;
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kKVBytes +
                                    (1 + 4 * kStages) * 8 +
                                    kSwizzleAtom;   // room to align the tiles
  // registers a thread: the consumers take what the producer gives away
  // (65536 a block: 40 + 2 x 232 or 32 + 3 x 160 a warpgroup's threads)
  static constexpr int kProducerRegs = WGS == 2 ? 40 : 32;
  static constexpr int kConsumerRegs = WGS == 2 ? 232 : 160;
  static constexpr bool kNarrowQ = KSTEPS == 3 && kNarrowQBoxes;
  static constexpr bool kNarrowKV = KSTEPS == 3 && kNarrowKVBoxes;
  static_assert(kStages >= 2 && kSmemBytes <= kSmemMax, "shared memory");
};

// K and V come in boxes of d columns where their keys fill at least half a
// tile: onto one key (the pix2gestalt UNet's context) the 64-column boxes
// take less time, onto 77 (DepthFM's) the narrow ones
// (`tools/kernel_ablation.py`, kv_box64; PERF.md). The host's maps and the
// kernel's byte counts both follow it.
template <typename T>
__host__ __device__ __forceinline__ bool kv_boxes_narrow(int kv_len) {
  return T::kNarrowKV && kv_len >= T::kKeys / 2;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64-row score tile of N / 2 keys held as
// accumulator fragments: s becomes P = exp2(scale * s - new max) in place, m
// (the running max of scale * s) and l (this thread's share of the row sums)
// are brought up to date, and alpha is what the output so far must be
// multiplied by. The max is taken over the raw scores, of s or, for a
// negative scale (NEG), of -s: rounding is monotonic, so |scale| times that
// is exactly the max of the rounded scale * s, and the scale costs no
// instruction of its own: it is the multiplier of the one fused multiply-add
// under the exponential. In a RAGGED tile (the last one, when kv_len is no
// multiple of the tile) keys >= kv_len are left out of the max and get P = 0.
// The tile's row sums start from zero and join l once complete, so that no
// addition waits on alpha's exponential (the running sum rescaled first
// takes 10% longer at d = 40: `tools/kernel_ablation.py`, sum_into_l).
template <bool RAGGED, bool NEG, int N>
__device__ __forceinline__ void softmax_body(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int key0,
                                             int kv_len) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  #pragma unroll
  for (int i = 0; i < N; ++i) {
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) continue;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], NEG ? -s[i] : s[i]);
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // finite: every tile holds a key < kv_len
    const float m_new = fmaxf(m[r], mx[r] * fabsf(scale_log2));
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
  #pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) s[i] = 0.f;
    sum[(i >> 1) & 1] += s[i];
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// tile_end: one past the tile's last key
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int key0,
                                             int tile_end, int kv_len) {
  if (scale_log2 < 0.f) {
    if (tile_end > kv_len)
      softmax_body<true, true>(s, m, l, alpha, scale_log2, key0, kv_len);
    else
      softmax_body<false, true>(s, m, l, alpha, scale_log2, key0, kv_len);
  } else if (tile_end > kv_len) {
    softmax_body<true, false>(s, m, l, alpha, scale_log2, key0, kv_len);
  } else {
    softmax_body<false, false>(s, m, l, alpha, scale_log2, key0, kv_len);
  }
}

// P, rounded to bf16, regrouped into the A fragments of N / 8 k16 steps: the
// accumulator's column tiles 2kk and 2kk + 1 are one m64k16 A fragment
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[N / 8][4],
                                       const float (&s)[N]) {
  #pragma unroll
  for (int i = 0; i < N; i += 2)
    pf[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
}

template <int KSTEPS,   // k16 steps over the head dim: ceil(d / 16) to 4,
                        // then 5, 10
          int WGS>      // consumer warpgroups, 64 query rows each
__global__ void __launch_bounds__(kFwdThreads<WGS>, 1)
flash_attn_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int nq, int kv_len, int d, float scale_log2,
                          Strides so, long long lse_sb, long long lse_sh) {
  using T = FwdTiles<KSTEPS, WGS>;
  constexpr int kNV = 16 * KSTEPS;      // output columns computed
  constexpr int kKeys = T::kKeys, kStages = T::kStages;
  constexpr int kS = kKeys / 2;         // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern is a function of the address: 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((kSwizzleAtom - smem_addr(smem_raw)) &
                              (kSwizzleAtom - 1));
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + T::kBoxes * T::kQBox;
  bf16* vs = ks + kStages * T::kBoxes * T::kKVBox;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(vs + kStages * T::kBoxes * T::kKVBox);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);   // the producer's arrive; TMA adds the bytes
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, WGS);  // one thread of each consumer warpgroup
      mbar_init(v_empty + s, WGS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_tiles = (kv_len + kKeys - 1) / kKeys;
  const uint32_t q_bytes = T::kNarrowQ ? 2 * T::kRows * d : T::kQBytes;
  const bool kv_narrow = kv_boxes_narrow<T>(kv_len);
  const uint32_t kv_bytes = kv_narrow ? 2 * kKeys * d : T::kKVBytes;

  const int q0 = blockIdx.x * T::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x >> 7;

  if (wg == WGS) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == WGS * 128) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_arrive_expect_tx(q_full, q_bytes);
      tma_load_boxes<T::kBoxes>(qs, T::kQBox, &map_q, q_full, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int off = stage * T::kBoxes * T::kKVBox;
        mbar_wait(k_empty + stage, phase ^ 1);   // free from the start
        mbar_arrive_expect_tx(k_full + stage, kv_bytes);
        tma_load_boxes<T::kBoxes>(ks + off, T::kKVBox, &map_k,
                                  k_full + stage, t * kKeys, h, b);
        mbar_wait(v_empty + stage, phase ^ 1);
        mbar_arrive_expect_tx(v_full + stage, kv_bytes);
        tma_load_boxes<T::kBoxes>(vs + off, T::kKVBox, &map_v,
                                  v_full + stage, t * kKeys, h, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<T::kConsumerRegs>();
    if (T::kNarrowQ || T::kNarrowKV) {
      // A narrow box brings d columns: the k16 steps' columns from d on
      // are zeros written here once, while the first loads are under way,
      // in Q and in the K stages in use (V's reach only output columns
      // that are never stored).
      if (T::kNarrowQ)
        zero_chunks(qs, T::kRows, d / 8, 2 * KSTEPS, threadIdx.x, 128 * WGS);
      if (kv_narrow)
        zero_chunks(ks, min(n_tiles, kStages) * kKeys, d / 8, 2 * KSTEPS,
                    threadIdx.x, 128 * WGS);
      fence_proxy_async();
      consumers_sync<WGS>();
    }
    const int lane = threadIdx.x & 31;
    // per thread: rows row0 and row0 + 8; in each 8-wide column tile,
    // columns col0 and col0 + 1 (the accumulator layout, see sm90.cuh)
    const int row0 = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                     (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const bool elected = (threadIdx.x & 127) == 0;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float acc[kNV / 2];
    #pragma unroll
    for (int i = 0; i < kNV / 2; ++i) acc[i] = 0.f;
    uint32_t pf[kKeys / 16][4];   // the tile before's P in bf16, read by P.V

    // Tile t's S = Q K^T (KSTEPS wgmma m64nKk16, K the tile's keys, operands
    // in shared memory) is started together with tile t-1's O += P V (one
    // wgmma m64nNk16 a k16 step, N = 16 KSTEPS, P from registers, V [keys,
    // d] the MN-major B operand, its boxes LBO apart), so that tile t's
    // softmax runs while the tensor cores work on P V.
    if (wg == WGS - 1) turn_pass<WGS>(wg);   // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    const uint64_t dq = wgmma_desc(qs + wg * 64 * 64, 16, kSwizzleAtom);
    const auto start_s = [&](float (&s)[kS], int stage) {
      const uint64_t dk = wgmma_desc(ks + stage * T::kBoxes * T::kKVBox, 16,
                                     kSwizzleAtom);
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss<0>(s, kstep_desc(dq, kk, 2 * T::kQBox),
                    kstep_desc(dk, kk, 2 * T::kKVBox), kk != 0);
      wgmma_commit();
    };
    const auto start_pv = [&](int stage) {
      const uint64_t dv = wgmma_desc(vs + stage * T::kBoxes * T::kKVBox,
                                     2 * T::kKVBox, kSwizzleAtom);
      #pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * kSwizzleRow));
      wgmma_commit();
    };

    {   // tile 0: nothing to overlap with yet
      float s[kS];
      mbar_wait(k_full, 0);
      turn_wait(wg);
      wgmma_fence();
      start_s(s, 0);
      turn_pass<WGS>(wg);
      wgmma_wait<0>();
      wgmma_pin(s);
      if (elected) mbar_arrive(k_empty);
      softmax_tile(s, m, l, alpha, scale_log2, col0, kKeys, kv_len);
      pack_p(pf, s);   // acc is 0: nothing to rescale
    }
    int k_stage = 1 % kStages, v_stage = 0;
    uint32_t k_phase = kStages == 1, v_phase = 0;
    for (int t = 1; t < n_tiles; ++t) {
      float s[kS];
      mbar_wait(k_full + k_stage, k_phase);
      turn_wait(wg);
      wgmma_fence();   // acc, rescaled, and pf were written by ordinary code
      start_s(s, k_stage);
      mbar_wait(v_full + v_stage, v_phase);
      start_pv(v_stage);
      turn_pass<WGS>(wg);

      wgmma_wait<1>();   // S is complete, P V may still run
      wgmma_pin(s);
      if (elected) mbar_arrive(k_empty + k_stage);
      if (++k_stage == kStages) {
        k_stage = 0;
        k_phase ^= 1;
      }
      softmax_tile(s, m, l, alpha, scale_log2, t * kKeys + col0,
                   (t + 1) * kKeys, kv_len);
      wgmma_wait<0>();
      wgmma_pin(acc);
      if (elected) mbar_arrive(v_empty + v_stage);
      if (++v_stage == kStages) {
        v_stage = 0;
        v_phase ^= 1;
      }
      pack_p(pf, s);
      if (alpha[0] != 1.f || alpha[1] != 1.f) {   // a row's max has moved
        #pragma unroll
        for (int i = 0; i < kNV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
    }
    mbar_wait(v_full + v_stage, v_phase);   // the last tile's P V
    turn_wait(wg);
    wgmma_fence();
    start_pv(v_stage);
    turn_pass<WGS>(wg);
    wgmma_wait<0>();
    wgmma_pin(acc);

    bf16* ob = o + b * so.b + h * so.h;
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + r * 8;
      if (row >= nq) continue;
      const float inv = 1.f / l[r];
      #pragma unroll
      for (int j = 0; j < kNV / 8; ++j) {
        const int col = j * 8 + col0;   // d is a multiple of 8
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * so.n + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
      if (lse != nullptr && col0 == 0)
        lse[b * lse_sb + h * lse_sh + row] = m[r] * kLn2 + logf(l[r]);
    }
  }
}

// ------------------------------- bfloat16 onto a short key set: one tile

// kv_len up to kShortKeys runs flash_attn_fwd_bf16_short<KSTEPS, NK>: every
// key in one tile of NK keys, 16 up to kShortFewKeys and 80 above (the
// pix2gestalt UNet's one context key, DepthFM's 77), the N of S = Q K^T.
// Each choice below has an ablation in `tools/kernel_ablation.py`.
constexpr int kShortKeys = 80, kShortFewKeys = 16;
constexpr int kShortWarpgroups = 1;      // a block's warpgroups, 64 rows each
constexpr int kShortStages = 1;          // Q tiles in flight a warpgroup
constexpr bool kShortNarrow = true;      // boxes of d columns at KSTEPS 3
constexpr bool kShortTmaStore = true;    // O out through shared memory
constexpr int kSmemPerSm = 233472;       // an SM's 228 KB, 1 KB a block kept

// The shared memory of flash_attn_fwd_bf16_short<KSTEPS, NK>: K and V (NK
// rows), then each warpgroup's ring of kStages 64-row Q tiles and its
// 64-row O tile, each kBoxes boxes of 64 head-dim columns, then the
// barriers. Registers (the scores, P as bf16 fragments and the output: 40
// + 20 + 8 KSTEPS a thread at NK = 80) and shared memory (37 KB at d = 40,
// 72 at 80, 108 at 160) bound how many blocks share an SM. One Q stage
// takes less time than two: the next tile's load is issued as soon as S
// has read the stage, so it runs under this tile's softmax, P V and store,
// and the smaller block lets more blocks share an SM
// (`tools/kernel_ablation.py`, short_two_stages).
template <int KSTEPS, int NK>
struct ShortTiles {
  static constexpr int kBoxes = kHeadBoxes<KSTEPS>;
  static constexpr int kWgs = kShortWarpgroups;
  static constexpr int kStages = kShortStages;
  static constexpr int kQBox = 64 * 64;      // elements of a Q or O box
  static constexpr int kKVBox = NK * 64;     // ... of a K or V box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKVTile = kBoxes * kKVBox;
  static constexpr bool kNarrow = KSTEPS == 3 && kShortNarrow;
  static constexpr int kBars = 1 + kWgs * kStages;
  static constexpr int kSmemBytes =
      2 * (2 * kKVTile + kWgs * (kStages + 1) * kQTile) + 8 * kBars +
      kSwizzleAtom;   // room to align the tiles
  static constexpr int kBySmem = kSmemPerSm / (kSmemBytes + 1024);
  static constexpr int kByRegs =
      (KSTEPS <= 4 ? 4 : KSTEPS <= 5 ? 3 : 2) / kWgs;
  static constexpr int kMinBlocks =
      kBySmem < kByRegs ? (kBySmem < 1 ? 1 : kBySmem)
                        : (kByRegs < 1 ? 1 : kByRegs);
  static_assert(kSmemBytes <= kSmemMax, "shared memory");
};

// the 128 threads of consumer warpgroup wg meet (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

template <int KSTEPS,   // k16 steps over the head dim, as the streaming kernel
          int NK>       // keys of the one K/V tile: 16 or 80
__global__ void __launch_bounds__(128 * kShortWarpgroups,
                                  ShortTiles<KSTEPS, NK>::kMinBlocks)
flash_attn_fwd_bf16_short(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int nq, int kv_len, int d, float scale_log2,
                          int items, Strides so, long long lse_sb,
                          long long lse_sh) {
  using T = ShortTiles<KSTEPS, NK>;
  constexpr int kNV = 16 * KSTEPS;   // output columns computed
  constexpr int kS = NK / 2;         // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kSwizzleAtom - smem_addr(smem_raw)) &
                              (kSwizzleAtom - 1));
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T::kKVTile;
  bf16* qs = vs + T::kKVTile;                         // [warpgroup][stage]
  bf16* os = qs + T::kWgs * T::kStages * T::kQTile;   // [warpgroup]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(os + T::kWgs * T::kQTile);
  uint64_t* q_full = kv_full + 1;                     // [warpgroup][stage]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile0 = blockIdx.x * items;   // the block's first 64-row tile
  const int tiles = min(items, (nq + 63) / 64 - tile0);
  // warpgroup w's n-th tile is tile0 + w + n kWgs
  const auto tiles_of = [&](int w) {
    return tiles > w ? (tiles - w + T::kWgs - 1) / T::kWgs : 0;
  };
  const uint32_t q_bytes = T::kNarrow ? 2 * 64 * d : 2 * T::kQTile;
  const uint32_t kv_bytes = T::kNarrow ? 2 * NK * d : 2 * T::kKVTile;
  const CUtensorMap* mq = &map_q;
  const auto load_q = [&](int w, int n) {   // one thread
    const int slot = w * T::kStages + n % T::kStages;
    mbar_arrive_expect_tx(q_full + slot, q_bytes);
    tma_load_boxes<T::kBoxes>(qs + slot * T::kQTile, T::kQBox, mq,
                              q_full + slot, (tile0 + w + n * T::kWgs) * 64,
                              h, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kBars; ++i) mbar_init(kv_full + i, 1);
    mbar_init_fence();
    tma_prefetch_map(&map_q);
    tma_prefetch_map(&map_k);
    tma_prefetch_map(&map_v);
    mbar_arrive_expect_tx(kv_full, 2 * kv_bytes);
    tma_load_boxes<T::kBoxes>(ks, T::kKVBox, &map_k, kv_full, 0, h, b);
    tma_load_boxes<T::kBoxes>(vs, T::kKVBox, &map_v, kv_full, 0, h, b);
    for (int w = 0; w < T::kWgs; ++w)
      for (int n = 0; n < T::kStages && n < tiles_of(w); ++n) load_q(w, n);
    if (kShortTmaStore) tma_prefetch_map(&map_o);
  }
  if (T::kNarrow) {
    // A narrow box brings d columns: the k16 steps' columns from d on are
    // zeros written here once, while the first loads are under way, in K
    // and in every Q stage (V's reach only output columns never stored).
    zero_chunks(ks, NK, d / 8, 2 * KSTEPS, threadIdx.x, 128 * T::kWgs);
    zero_chunks(qs, T::kWgs * T::kStages * 64, d / 8, 2 * KSTEPS,
                threadIdx.x, 128 * T::kWgs);
    fence_proxy_async();
  }
  __syncthreads();   // the barriers are set up and the zeros written

  const int wg = threadIdx.x >> 7;
  const int n_tiles = tiles_of(wg);
  const bool elected = (threadIdx.x & 127) == 0;
  const int lane = threadIdx.x & 31;
  // per thread: rows rsub and rsub + 8 of a tile; in each 8-wide column
  // tile, columns col0 and col0 + 1 (the accumulator layout, sm90.cuh)
  const int rsub = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  bf16* qw = qs + wg * T::kStages * T::kQTile;
  bf16* ow = os + wg * T::kQTile;
  uint64_t* fw = q_full + wg * T::kStages;
  const uint64_t dk = wgmma_desc(ks, 16, kSwizzleAtom);
  const uint64_t dv = wgmma_desc(vs, 2 * T::kKVBox, kSwizzleAtom);
  if (n_tiles > 0) mbar_wait(kv_full, 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n % T::kStages;
    const int q0 = (tile0 + wg + n * T::kWgs) * 64;
    // S = Q K^T: KSTEPS wgmma m64nNKk16, both operands in shared memory
    float s[kS];
    mbar_wait(fw + stage, (n / T::kStages) & 1);
    const uint64_t dq = wgmma_desc(qw + stage * T::kQTile, 16, kSwizzleAtom);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss<0>(s, kstep_desc(dq, kk, 2 * T::kQBox),
                  kstep_desc(dk, kk, 2 * T::kKVBox), kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);
    // the stage is read: this warpgroup's tile n + kStages comes into it
    if (elected && n + T::kStages < n_tiles) load_q(wg, n + T::kStages);

    // one pass: the row max, the exponentials and the row sums over all
    // keys at once, those at or past kv_len masked
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    softmax_tile(s, m, l, alpha, scale_log2, col0, NK, kv_len);
    uint32_t pf[NK / 16][4];
    pack_p(pf, s);
    // O = P V: one wgmma m64nNk16 a k16 step of keys, N = 16 KSTEPS
    float acc[kNV / 2];
    #pragma unroll
    for (int i = 0; i < kNV / 2; ++i) acc[i] = 0.f;
    wgmma_fence();   // acc and pf were written by ordinary code
    #pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * kSwizzleRow));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(acc);

    float inv[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    if (kShortTmaStore) {
      // O into this warpgroup's swizzled tile, then out by TMA (rows past
      // nq and columns past d are not written); the tile is free once the
      // tile before's store has read it
      if (elected) tma_store_wait_read();
      warpgroup_sync(wg);
      #pragma unroll
      for (int j = 0; j < kNV / 8; ++j) {
        uint8_t* box = reinterpret_cast<uint8_t*>(ow + (j / 8) * T::kQBox);
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rsub + r * 8;
          *reinterpret_cast<__nv_bfloat162*>(
              box + row * kSwizzleRow + (((j % 8) ^ (row & 7)) << 4) +
              2 * col0) = __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                                acc[4 * j + 2 * r + 1] *
                                                    inv[r]);
        }
      }
      fence_proxy_async();
      warpgroup_sync(wg);
      if (elected) {
        #pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_store_4d(&map_o, ow + x * T::kQBox, 64 * x, q0, h, b);
        tma_store_commit();
      }
    } else {
      bf16* ob = o + b * so.b + h * so.h;
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rsub + r * 8;
        if (row >= nq) continue;
        #pragma unroll
        for (int j = 0; j < kNV / 8; ++j) {
          const int col = j * 8 + col0;   // d is a multiple of 8
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * so.n +
                                               col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                      acc[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
    if (lse != nullptr && col0 == 0) {
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rsub + r * 8;
        if (row < nq)
          lse[b * lse_sb + h * lse_sh + row] = m[r] * kLn2 + logf(l[r]);
      }
    }
  }
  if (kShortTmaStore && elected) tma_store_wait_read();
}

struct Args {
  const void *q, *k, *v;
  void *o;
  float* lse;
  int nq, kv_len, d;
  float scale_log2;
  Strides sq, sk, sv, so;
  long long lse_sb, lse_sh;
};

// above 48 KB of dynamic shared memory only after opting in (per device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DPAD>
cudaError_t launch_f32(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr int smem = F32Tile<DPAD>::kSmemBytes;
  const cudaError_t err = allow_smem(flash_attn_fwd_f32<DPAD>, smem);
  if (err != cudaSuccess) return err;
  flash_attn_fwd_f32<DPAD><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.nq,
      a.kv_len, a.d, a.scale_log2, a.sq, a.sk, a.sv, a.so, a.lse_sb,
      a.lse_sh);
  return cudaGetLastError();
}

template <int KSTEPS, int WGS>
cudaError_t launch_wgmma(const Args& a, int heads, int batch,
                         cudaStream_t s) {
  using T = FwdTiles<KSTEPS, WGS>;
  CUtensorMap map_q, map_k, map_v;
  if (!attention_map(&map_q, a.q, a.d, a.nq, heads, batch, a.sq, T::kRows,
                     T::kNarrowQ) ||
      !attention_map(&map_k, a.k, a.d, a.kv_len, heads, batch, a.sk,
                     T::kKeys, kv_boxes_narrow<T>(a.kv_len)) ||
      !attention_map(&map_v, a.v, a.d, a.kv_len, heads, batch, a.sv,
                     T::kKeys, kv_boxes_narrow<T>(a.kv_len)))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem(flash_attn_fwd_bf16_wgmma<KSTEPS, WGS>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + T::kRows - 1) / T::kRows, heads, batch);
  constexpr int threads = kFwdThreads<WGS>;
  flash_attn_fwd_bf16_wgmma<KSTEPS, WGS><<<grid, threads, T::kSmemBytes, s>>>(
          map_q, map_k, map_v, static_cast<bf16*>(a.o), a.lse, a.nq,
          a.kv_len, a.d, a.scale_log2, a.so, a.lse_sb, a.lse_sh);
  return cudaGetLastError();
}

// The short-key grid: `items` 64-row tiles of one (batch, head) a block, as
// few as fill every warpgroup the card holds at once (so that K and V are
// loaded once for as many tiles as the grid allows); the warpgroups the
// card holds are counted once per instantiation.
template <int KSTEPS, int NK>
cudaError_t launch_short(const Args& a, int heads, int batch,
                         cudaStream_t s) {
  using T = ShortTiles<KSTEPS, NK>;
  const auto kernel = flash_attn_fwd_bf16_short<KSTEPS, NK>;
  constexpr int threads = 128 * T::kWgs;
  CUtensorMap map_q, map_k, map_v, map_o;
  if (!attention_map(&map_q, a.q, a.d, a.nq, heads, batch, a.sq, 64,
                     T::kNarrow) ||
      !attention_map(&map_k, a.k, a.d, a.kv_len, heads, batch, a.sk, NK,
                     T::kNarrow) ||
      !attention_map(&map_v, a.v, a.d, a.kv_len, heads, batch, a.sv, NK,
                     T::kNarrow) ||
      !attention_map(&map_o, a.o, a.d, a.nq, heads, batch, a.so, 64,
                     T::kNarrow))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  static int slots = 0;   // warpgroups in flight on the card
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, T::kSmemBytes)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = sms * per_sm * T::kWgs;
  }
  const int tiles = (a.nq + 63) / 64;
  const int per_wg = (tiles * heads * batch + slots - 1) / slots;
  const int items = tiles < per_wg * T::kWgs ? tiles : per_wg * T::kWgs;
  const dim3 grid((tiles + items - 1) / items, heads, batch);
  flash_attn_fwd_bf16_short<KSTEPS, NK><<<grid, threads, T::kSmemBytes, s>>>(
      map_q, map_k, map_v, map_o, static_cast<bf16*>(a.o), a.lse, a.nq,
      a.kv_len, a.d, a.scale_log2, items, a.so, a.lse_sb, a.lse_sh);
  return cudaGetLastError();
}

template <int KSTEPS>
cudaError_t launch_short_keys(const Args& a, int heads, int batch,
                              cudaStream_t s) {
  return a.kv_len <= kShortFewKeys
             ? launch_short<KSTEPS, kShortFewKeys>(a, heads, batch, s)
             : launch_short<KSTEPS, kShortKeys>(a, heads, batch, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: the head dim, <= 160 and a multiple
// of 4 (float32) or 8 (bfloat16). strides: 12 values, (batch, head, token)
// for q, k, v, o in elements (the head dim is contiguous), multiples of the
// 16-byte vector. lse: float32 [.., Nq] addressed by (lse_sb, lse_sh, 1), or
// null. Returns the cudaError_t of the tensor-map encode or the launch (0 on
// success).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse, int batch,
                              int heads, int nq, int kv_len, int d,
                              float sm_scale, const long long* st,
                              long long lse_sb, long long lse_sh,
                              void* stream) {
  if ((dtype != 0 && dtype != 1) || d < 1 || d > 160 ||
      d % (dtype == 0 ? 4 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, o, static_cast<float*>(lse), nq, kv_len, d,
               sm_scale * kLog2e,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               lse_sb, lse_sh};
  if (dtype == 1) {   // the fixed table of the header note
    if (kv_len <= kShortKeys) {   // every key in one tile
      if (d <= 16) return (int)launch_short_keys<1>(a, heads, batch, s);
      if (d <= 32) return (int)launch_short_keys<2>(a, heads, batch, s);
      if (d <= 48) return (int)launch_short_keys<3>(a, heads, batch, s);
      if (d <= 64) return (int)launch_short_keys<4>(a, heads, batch, s);
      if (d <= 80) return (int)launch_short_keys<5>(a, heads, batch, s);
      return (int)launch_short_keys<10>(a, heads, batch, s);
    }
    if (d <= 16) return (int)launch_wgmma<1, 2>(a, heads, batch, s);
    if (d <= 32) return (int)launch_wgmma<2, 2>(a, heads, batch, s);
    if (d <= 48) return (int)launch_wgmma<3, kNarrowWarpgroups>(a, heads,
                                                                batch, s);
    if (d <= 64) return (int)launch_wgmma<4, 2>(a, heads, batch, s);
    if (d <= 80) return (int)launch_wgmma<5, 2>(a, heads, batch, s);
    return (int)launch_wgmma<10, 2>(a, heads, batch, s);
  }
  const dim3 grid((nq + kBM - 1) / kBM, heads, batch);
  if (d <= 16) return (int)launch_f32<16>(a, grid, s);
  if (d <= 32) return (int)launch_f32<32>(a, grid, s);
  if (d <= 48) return (int)launch_f32<48>(a, grid, s);
  if (d <= 64) return (int)launch_f32<64>(a, grid, s);
  if (d <= 80) return (int)launch_f32<80>(a, grid, s);
  return (int)launch_f32<160>(a, grid, s);
}
