// The Hopper attention-backward mainloops of flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel and flash_bwd_fused_kernel (flash_attention.cu; the
// fused one is described at attention_bwd_fused_sm90), on the sm_90a
// primitives of
// attention_fwd_sm90.cuh (mbarriers, 3-D TMA maps, 128-byte-swizzle wgmma
// descriptors). Built for sm_90a only (wgmma, setmaxnreg).
//
// What they compute, per (batch*head), from the forward's lse and the
// caller's delta_i = sum_d do_id o_id:
//   p_ij = exp2(s_ij log2 e - lse_i log2 e), s = sm_scale q k^T, masked to 0
//     where j >= Sk, i >= Sq or, causal, q_offset + i < k_offset + j; a row
//     whose keys are all masked (lse -inf) shifts by 0, so its p is 0 and
//     its gradients are 0, never NaN;
//   dS = p (dP - delta) sm_scale with dP = do v^T;
//   dq = dS k (flash_bwd_dq_kernel), dk = dS^T q and dv = p^T do
//     (flash_bwd_dkv_kernel), all three (flash_bwd_fused_kernel).
// p and dS are rounded to bf16 as the A operands of their products; every
// product accumulates in f32. Each gradient row is summed in a fixed order,
// with no atomics on the data: inside one block, but for the fused
// kernel's dq, which it sums across blocks in key-slot order.
//
// Block: three warpgroups, 384 threads, persistent (one block per SM takes
// every gridDim.x-th work item), as in the forward:
//   * warpgroup 0 is the producer (setmaxnreg down to 40). One thread issues
//     the TMA loads: each item's two operands of 128 rows into one of two
//     item buffers, then tiles of 64 rows of the two streamed operands into
//     a ring of kStages stages (full/empty mbarriers, as the forward's).
//     In dk/dv and the fused kernel its warp 1 also writes each stage's lse (base 2) and delta
//     rows into shared memory, so the consumers hold none of them in
//     registers; the stage's full barrier counts its 32 arrivals beside the
//     TMA bytes.
//   * warpgroups 1 and 2 are consumers of 64 item rows each (232 registers).
// dq: an item is 128 query rows; Q and dO come in once, K and V tiles of 64
// keys through the ring. Per visible key tile:
//     S = Q K^T and dP = dO V^T: wgmma m64n64k16 from shared memory, both
//       operands K-major as they lie (the forward's q k^T);
//     dS in registers;
//     dQ += dS K: wgmma with dS from registers (the accumulator fragment
//       packed two bf16 a register is the A fragment, as P is in the
//       forward's P V) and K as an MN-major B operand (as V is there).
// dk/dv: an item is 128 key rows; K and V come in once, Q and dO tiles of
// 64 queries through the ring. Per query tile that sees the item's keys
// (from first_query on):
//     S^T = K Q^T and dP^T = V dO^T: K-major, as above;
//     P^T and dS^T in registers, the stage's lse and delta from shared
//       memory (a padded row i >= Sq reads lse +inf and delta 0: p = 0);
//     dV += P^T dO and dK += dS^T Q: register A, dO and Q MN-major.
// No operand is transposed by hand: the transposes are the wgmma
// descriptors' (K-major or MN-major). Each product's B operand is a ring
// tile of 64 rows, so every map has boxes of 64 rows x 64 columns (D 128:
// two boxes side by side), and an item's 128 rows come in as two boxes one
// above the other: dq and dk/dv share their four maps (q, k, v, do), which
// the host caches (bwd_map).
//
// Within a consumer, tile j's S and dP (S^T and dP^T) are issued together
// with tile j-1's register products, and dS of tile j is formed while those
// still run: tile 0, the middle tiles and the last register products are
// separate straight-line code, so no wgmma is issued under a per-tile
// condition (ptxas's C7513 in the forward). dk/dv at D 128 does not
// overlap them: its dK and dV accumulators are 128 registers a thread, and
// S^T and dP^T (64) issued while the packed P^T and dS^T (32) still feed
// tile j-1's products made ptxas serialise every wgmma (C7512,
// insufficient register resources, with spills). There tile j-1's products
// are issued and done first, then tile j's scores: 192 registers at the
// peak; the other consumer warpgroup's products fill the gaps.
//
// Causal items are handed out longest first: dq's last query blocks (the
// most keys), dk/dv's first key blocks (the most queries).

#pragma once

#include <type_traits>

#include "attention_fwd_sm90.cuh"

namespace {

constexpr int kBwdThreads = 384;  // producer + two consumer warpgroups
constexpr int kFusedThreads = 256;  // the fused backward: two warpgroups
constexpr int kBwdItem = 128;     // rows of a work item (64 a consumer)
constexpr int kBwdTile = 64;      // rows of a ring tile

// Byte offsets in the block's shared memory (base aligned to 1024): two
// item buffers of two operands, the ring's stages of two operands, the
// stages' rows (lse and delta, dk/dv only), the mbarriers. Each 64-column
// box of an operand is stored whole (rows x 128 bytes) before the next.
// The fused backward adds two dS tiles (128 keys x 64 queries, bf16) after
// the rows.
template <int D, bool kFused = false>
struct BwdLayout {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kItemBytes = D / 64 * kBwdItem * kBoxBytes;
  static constexpr int kTileBytes = D / 64 * kBwdTile * kBoxBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRows = 4 * kItemBytes + kStages * kStageBytes;
  static constexpr int kRowBytes = 2 * kBwdTile * 4;  // lse2[64], delta[64]
  static constexpr int kDsBytes = kBwdItem * kBoxBytes;  // one dS tile
  static constexpr int kDs = kRows + kStages * kRowBytes;  // 1024-aligned
  static constexpr int kBars = kDs + (kFused ? 2 * kDsBytes : 0);
  // full[kStages], empty[kStages], item_full[2], item_empty[2]
  static constexpr size_t kSmem = kBars + 8 * (2 * kStages + 4) + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// The block's buffers and barriers. Ring tile g (counted over the block's
// items) sits in stage g % kStages; item it's operands in buffer it % 2.
template <int D, bool kFused = false>
struct BwdRing {
  using L = BwdLayout<D, kFused>;
  static constexpr int kStages = L::kStages;
  uint32_t base;
  unsigned char* generic;  // the same base as a generic pointer

  __device__ uint32_t item(int it, int op) const {
    return base + ((it & 1) * 2 + op) * L::kItemBytes;
  }
  __device__ uint32_t tile(int g, int op) const {
    return base + 4 * L::kItemBytes + (g % kStages) * L::kStageBytes +
           op * L::kTileBytes;
  }
  __device__ float* rows(int g) const {  // lse2[64] then delta[64]
    return reinterpret_cast<float*>(generic + L::kRows +
                                    (g % kStages) * L::kRowBytes);
  }
  // the fused backward's dS tile b (0, 1), as a shared address and generic
  __device__ uint32_t ds(int b) const { return base + L::kDs + b * L::kDsBytes; }
  __device__ unsigned char* ds_generic(int b) const {
    return generic + L::kDs + b * L::kDsBytes;
  }
  __device__ uint32_t full(int g) const { return base + L::kBars + 8 * (g % kStages); }
  __device__ uint32_t empty(int g) const {
    return base + L::kBars + 8 * (kStages + g % kStages);
  }
  __device__ uint32_t item_full(int it) const {
    return base + L::kBars + 8 * (2 * kStages + (it & 1));
  }
  __device__ uint32_t item_empty(int it) const {
    return base + L::kBars + 8 * (2 * kStages + 2 + (it & 1));
  }
  __device__ uint32_t parity(int g) const { return (uint32_t)(g / kStages) & 1u; }
  __device__ uint32_t item_parity(int it) const { return (uint32_t)(it >> 1) & 1u; }

  // Thread 0: the barriers. A full barrier takes the TMA thread's arrival
  // and `row_writers` more (dk/dv: warp 1's lanes; the fused kernel:
  // warpgroup 1's threads); an empty one, one arrival per consumer
  // warpgroup (the fused kernel uses none).
  __device__ void init(int row_writers) const {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1 + row_writers);
      mbar_init(empty(st), 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(item_full(b), 1);
      mbar_init(item_empty(b), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

template <int D, bool kFused = false>
__device__ __forceinline__ BwdRing<D, kFused> bwd_ring() {
  extern __shared__ unsigned char bwd_smem[];
  BwdRing<D, kFused> r;
  const uint32_t raw = smem_u32(bwd_smem);
  r.base = (raw + 1023u) & ~1023u;
  r.generic = bwd_smem + (r.base - raw);
  return r;
}

// An item's two operands, rows [r0, r0 + n) (n <= 128), into their item
// buffers: one box of 64 rows per 64 columns and 64-row half; a half that
// lies wholly past the item's last row is not loaded (no consumer reads it).
template <int D>
__device__ __forceinline__ void tma_item(const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint32_t dst0,
                                         uint32_t dst1, uint32_t bar, int r0,
                                         int n, int bh) {
  const int halves = n > kBwdTile ? 2 : 1;
  mbar_expect_tx(bar, 2 * halves * (D / 64) * kBwdTile * kBoxBytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    for (int h = 0; h < halves; ++h) {
      const uint32_t off = c * kBwdItem * kBoxBytes + h * kBwdTile * kBoxBytes;
      tma_load_3d(dst0 + off, m0, bar, 64 * c, r0 + kBwdTile * h, bh);
      tma_load_3d(dst1 + off, m1, bar, 64 * c, r0 + kBwdTile * h, bh);
    }
}

// A ring tile's two operands, rows [r0, r0 + 64), into stage g.
template <int D>
__device__ __forceinline__ void tma_tile(const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint32_t dst0,
                                         uint32_t dst1, uint32_t bar, int r0,
                                         int bh) {
  mbar_expect_tx(bar, BwdLayout<D>::kStageBytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load_3d(dst0 + c * kBwdTile * kBoxBytes, m0, bar, 64 * c, r0, bh);
    tma_load_3d(dst1 + c * kBwdTile * kBoxBytes, m1, bar, 64 * c, r0, bh);
  }
}

// s (+)= A B^T over D, not committed: A this consumer's 64 rows of an item
// operand, B N rows of a ring tile (64 rows; N 32: a half, b offset by its
// first row); both K-major, k16 slices 32 bytes apart within a 64-column
// box.
template <int D, int N = 64>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        sw128_desc(a + (kk / 4) * kBwdItem * kBoxBytes + (kk % 4) * 32, 16);
    const uint64_t db =
        sw128_desc(b + (kk / 4) * kBwdTile * kBoxBytes + (kk % 4) * 32, 16);
    if constexpr (N == 64)
      wgmma_ss_n64(s, da, db, kk > 0);
    else
      wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// acc += A B, not committed: A (64 x 64) from registers, B a ring tile
// (64 rows x D) as an MN-major operand: 16 rows are two 8-row swizzle atoms
// down the tile; the leading byte offset steps from one 64-column box to
// the next (the forward's P V).
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
  constexpr uint32_t kBox = kBwdTile * kBoxBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(b + kk * 16 * kBoxBytes, kBox);
    if constexpr (D == 64)
      wgmma_rs_n64<0>(acc, a[kk], desc);
    else
      wgmma_rs_n128<0>(acc, a[kk], desc);
  }
}

// A 64 x 64 (N 32: 64 x 32) accumulator to bf16 as the A fragment of a k64
// (k32) product: accumulator groups 2kk and 2kk+1 are A's k16 slice kk.
template <int N = 32>
__device__ __forceinline__ void pack64(const float (&p)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// The accumulator fragment (attention_fwd_sm90.cuh): element 4i + 2r + e
// of a thread (warp w, lane g * 4 + t) is row 16w + g + 8r, column
// 8i + 2t + e.

// dq: s (scores) becomes dS of one key tile [k0, k0 + 64) for this
// thread's rows row_lo + 8r; kEdge masks keys >= Sk and, causal, keys past
// each row's diagonal.
template <bool kEdge>
__device__ __forceinline__ void dq_dscores(
    float (&s)[32], const float (&dp)[32], int k0, int row_lo, int Sk,
    int causal, int q_offset, int k_offset, float c, float sm_scale,
    const float (&lse2)[2], const float (&dl)[2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int lim = kBwdTile;  // keep columns 8i + e < lim (from k0 + 2t)
    if (kEdge) {
      long long keep = Sk;
      if (causal) {
        const long long diag =
            (long long)q_offset + row_lo + 8 * r - k_offset + 1;
        keep = diag < keep ? diag : keep;
      }
      const long long rel = keep - k0 - 2 * t;
      lim = rel < 0 ? 0 : rel > kBwdTile ? kBwdTile : (int)rel;
    }
#pragma unroll
    for (int i = 0; i < kBwdTile / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * i + 2 * r + e;
        float p = ex2(fmaf(s[x], c, -lse2[r]));
        if (kEdge && 8 * i + e >= lim) p = 0.f;
        s[x] = p * (dp[x] - dl[r]) * sm_scale;
      }
  }
}

// dk/dv and the fused backward: s (S^T) becomes P^T and dp (dP^T) dS^T of
// one query tile [q0, q0 + 64) for this thread's keys krow_lo + 8r, with the
// tile's rows (lse2, delta) from shared memory; kEdge masks queries >= Sq,
// keys >= Sk and, causal, queries before each key's diagonal, to exact
// zeros in both (whatever the masked scores held).
// N 16: the tile's 32 columns from col0 on (the fused backward at D 128).
template <bool kEdge, int N = 32>
__device__ __forceinline__ void dkv_dscores(
    float (&s)[N], float (&dp)[N], const float* rows, int q0, int krow_lo,
    int Sq, int Sk, int causal, int q_offset, int k_offset, float c,
    float sm_scale, int t, int col0 = 0) {
  int lo[2] = {0, 0}, hi = kBwdTile;  // keep columns [lo, hi) of the tile
  if (kEdge) {
    const int left = Sq - q0;
    hi = left < kBwdTile ? left : kBwdTile;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long first =
          causal ? (long long)k_offset + krow_lo + 8 * r - q_offset - q0 : 0;
      lo[r] = krow_lo + 8 * r >= Sk ? kBwdTile
              : first < 0           ? 0
              : first > kBwdTile    ? kBwdTile
                                    : (int)first;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int col = col0 + 8 * i + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
    const float2 d2 = *reinterpret_cast<const float2*>(rows + kBwdTile + col);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * i + 2 * r + e;
        const float p = ex2(fmaf(s[x], c, -(e ? l2.y : l2.x)));
        const float ds = p * (dp[x] - (e ? d2.y : d2.x)) * sm_scale;
        const bool keep = !kEdge || (col + e >= lo[r] && col + e < hi);
        s[x] = keep ? p : 0.f;
        dp[x] = keep ? ds : 0.f;
      }
  }
}

// One work item: rows [r0, r_end) of the item's side (queries for dq,
// keys for dk/dv) of batch*head bh, and its ring tiles t0 .. t0+n_tiles-1
// (keys for dq, queries for dk/dv). Items are numbered with batch*head
// fastest.
struct BwdItem {
  int bh, r0, r_end, t0, n_tiles;
};

__device__ __forceinline__ BwdItem dq_item(int w, int BH, int Sq, int Sk,
                                           int causal, int q_offset,
                                           int k_offset) {
  BwdItem x;
  const int slots = (Sq + kBwdItem - 1) / kBwdItem, slot = w / BH;
  x.bh = w - slot * BH;
  x.r0 = (causal ? slots - 1 - slot : slot) * kBwdItem;
  x.r_end = min(x.r0 + kBwdItem, Sq);
  x.t0 = 0;
  x.n_tiles =
      (visible_keys(Sk, causal, q_offset, k_offset, x.r_end) + kBwdTile - 1) /
      kBwdTile;
  return x;
}

__device__ __forceinline__ BwdItem dkv_item(int w, int BH, int Sq, int Sk,
                                            int causal, int q_offset,
                                            int k_offset) {
  BwdItem x;
  const int slot = w / BH;
  x.bh = w - slot * BH;
  x.r0 = slot * kBwdItem;
  x.r_end = min(x.r0 + kBwdItem, Sk);
  const int fq = first_query(Sq, causal, q_offset, k_offset, x.r0);
  x.t0 = fq / kBwdTile;
  x.n_tiles = fq >= Sq ? 0 : (Sq + kBwdTile - 1) / kBwdTile - x.t0;
  return x;
}

// ---- dq ------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void attention_bwd_dq_sm90(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int BH, int Sq,
    int Sk, float sm_scale, int causal, int q_offset, int k_offset) {
  const BwdRing<D> ring = bwd_ring<D>();
  const int n_items = BH * ((Sq + kBwdItem - 1) / kBwdItem);
  if (threadIdx.x == 0) ring.init(0);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int g = 0;
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const BwdItem x = dq_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
      if (it >= 2) mbar_wait(ring.item_empty(it), ring.item_parity(it) ^ 1u);
      tma_item<D>(&tq, &tdo, ring.item(it, 0), ring.item(it, 1),
                  ring.item_full(it), x.r0, x.r_end - x.r0, x.bh);
      for (int j = 0; j < x.n_tiles; ++j, ++g) {
        if (g >= BwdRing<D>::kStages)
          mbar_wait(ring.empty(g), ring.parity(g) ^ 1u);
        tma_tile<D>(&tk, &tv, ring.tile(g, 0), ring.tile(g, 1), ring.full(g),
                    j * kBwdTile, x.bh);
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const float c = sm_scale * kLog2e;
  int g0 = 0;  // the item's first ring tile in the block's count
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const BwdItem x = dq_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    const int row0 = x.r0 + 64 * cw;                     // this warpgroup's rows
    const int row_lo = row0 + 16 * warp + (lane >> 2);  // this thread's: +0, +8
    const int rows_end = min(row0 + 64, x.r_end);
    // the key tiles this warpgroup computes: a prefix of the item's
    const int n_mine =
        row0 < x.r_end
            ? (visible_keys(Sk, causal, q_offset, k_offset, rows_end) +
               kBwdTile - 1) / kBwdTile
            : 0;
    const uint32_t sQ = ring.item(it, 0) + cw * 64 * kBoxBytes;
    const uint32_t sO = ring.item(it, 1) + cw * 64 * kBoxBytes;
    // a tile needs the mask if it crosses Sk or, causal, the diagonal of
    // this warpgroup's first row
    auto edge = [&](int k0) {
      return k0 + kBwdTile > Sk ||
             (causal && q_offset + row0 < k_offset + k0 + kBwdTile - 1);
    };
    auto dscores = [&](float (&s)[32], const float (&dp)[32], int k0,
                       const float (&lse2)[2], const float (&dl)[2]) {
      if (edge(k0))
        dq_dscores<true>(s, dp, k0, row_lo, Sk, causal, q_offset, k_offset, c,
                         sm_scale, lse2, dl, t);
      else
        dq_dscores<false>(s, dp, k0, row_lo, Sk, causal, q_offset, k_offset,
                          c, sm_scale, lse2, dl, t);
    };
    // this thread's rows: lse in base 2 (a fully masked row's shifted to 0)
    // and delta; rows past Sq read 0 (their dq is not stored)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      const size_t at = (size_t)x.bh * Sq + row;
      const float l = row < Sq ? lse[at] : 0.f;
      lse2[r] = (l == -INFINITY ? 0.f : l) * kLog2e;
      dl[r] = row < Sq ? delta[at] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint32_t pa[4][4];  // dS of the tile whose dQ product is next

    mbar_wait(ring.item_full(it), ring.item_parity(it));
    if (n_mine > 0) {  // tile 0: S and dP, then dS
      float s[32], dp[32];
      mbar_wait(ring.full(g0), ring.parity(g0));
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D>(s, sQ, ring.tile(g0, 0));
      issue_scores<D>(dp, sO, ring.tile(g0, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dscores(s, dp, 0, lse2, dl);
      pack64(s, pa);
    }
    // tile j: S_j and dP_j in flight with dQ += dS_{j-1} K_{j-1}; dS_j forms
    // while the dQ product still runs. Registers a wgmma in flight reads
    // (acc, pa) are written only before its issue or after its wait.
    for (int j = 1; j < n_mine; ++j) {
      float s[32], dp[32];
      const int g = g0 + j;
      mbar_wait(ring.full(g), ring.parity(g));
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D>(s, sQ, ring.tile(g, 0));
      issue_scores<D>(dp, sO, ring.tile(g, 1));
      wgmma_commit();
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_grad<D>(acc, pa, ring.tile(g - 1, 0));
      wgmma_commit();
      wgmma_wait<1>();  // S_j and dP_j are done (groups complete in order)
      fence_regs(s);
      fence_regs(dp);
      dscores(s, dp, j * kBwdTile, lse2, dl);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (tid == 0) mbar_arrive(ring.empty(g - 1));  // done with tile j-1
      pack64(s, pa);
    }
    if (n_mine > 0) {  // the last tile's dQ product
      const int g = g0 + n_mine - 1;
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_grad<D>(acc, pa, ring.tile(g, 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(ring.empty(g));
    }
    if (tid == 0) mbar_arrive(ring.item_empty(it));  // done with Q and dO
    // the item's later tiles, which no row of this warpgroup sees: release
    // each once it has landed, so the ring's phases stay in step
    for (int j = n_mine; j < x.n_tiles; ++j) {
      mbar_wait(ring.full(g0 + j), ring.parity(g0 + j));
      if (tid == 0) mbar_arrive(ring.empty(g0 + j));
    }
    g0 += x.n_tiles;

    // ---- epilogue: dq in bf16, rows < Sq only -----------------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row >= x.r_end) continue;
      bf16* out = dq + ((size_t)x.bh * Sq + row) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) =
            pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// ---- dk/dv -------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void attention_bwd_dkv_sm90(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int BH, int Sq, int Sk, float sm_scale, int causal,
    int q_offset, int k_offset) {
  // D 128: tile j-1's products are done before tile j's scores are issued
  // (the register budget, in the header note)
  constexpr bool kSerial = D == 128;
  const BwdRing<D> ring = bwd_ring<D>();
  const int n_items = BH * ((Sk + kBwdItem - 1) / kBwdItem);
  if (threadIdx.x == 0) ring.init(32);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 issues every copy, warp 1 writes the rows ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      int g = 0;
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        const BwdItem x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
        if (it >= 2) mbar_wait(ring.item_empty(it), ring.item_parity(it) ^ 1u);
        tma_item<D>(&tk, &tv, ring.item(it, 0), ring.item(it, 1),
                    ring.item_full(it), x.r0, x.r_end - x.r0, x.bh);
        for (int j = 0; j < x.n_tiles; ++j, ++g) {
          if (g >= BwdRing<D>::kStages)
            mbar_wait(ring.empty(g), ring.parity(g) ^ 1u);
          tma_tile<D>(&tq, &tdo, ring.tile(g, 0), ring.tile(g, 1),
                      ring.full(g), (x.t0 + j) * kBwdTile, x.bh);
        }
      }
    } else if (warp == 1) {
      // each stage's lse in base 2 (a fully masked row's shifted to 0) and
      // delta; a row past Sq reads lse +inf and delta 0, so its p is 0
      int g = 0;
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        const BwdItem x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
        for (int j = 0; j < x.n_tiles; ++j, ++g) {
          if (g >= BwdRing<D>::kStages)
            mbar_wait(ring.empty(g), ring.parity(g) ^ 1u);
          float* rows = ring.rows(g);
          for (int i = lane; i < kBwdTile; i += 32) {
            const int q = (x.t0 + j) * kBwdTile + i;
            const size_t at = (size_t)x.bh * Sq + q;
            const float l = q < Sq ? lse[at] : INFINITY;
            rows[i] = (l == -INFINITY ? 0.f : l) * kLog2e;
            rows[kBwdTile + i] = q < Sq ? delta[at] : 0.f;
          }
          mbar_arrive(ring.full(g));
        }
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const float c = sm_scale * kLog2e;
  int g0 = 0;  // the item's first ring tile in the block's count
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const BwdItem x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    const int kr0 = x.r0 + 64 * cw;                      // this warpgroup's keys
    const int krow_lo = kr0 + 16 * warp + (lane >> 2);  // this thread's: +0, +8
    // the query tiles this warpgroup computes: a suffix of the item's (its
    // keys start later, so its first visible query may too)
    int skip = x.n_tiles;
    if (kr0 < x.r_end) {
      const int fq = first_query(Sq, causal, q_offset, k_offset, kr0);
      if (fq < Sq) skip = fq / kBwdTile - x.t0;
    }
    const uint32_t sK = ring.item(it, 0) + cw * 64 * kBoxBytes;
    const uint32_t sV = ring.item(it, 1) + cw * 64 * kBoxBytes;
    // a tile needs the mask if it crosses Sq or, causal, the diagonal of
    // this warpgroup's last key
    auto dscores = [&](float (&s)[32], float (&dp)[32], int j, int g) {
      const int q0 = (x.t0 + j) * kBwdTile;
      const float* rows = ring.rows(g);
      if (q0 + kBwdTile > Sq ||
          (causal && q_offset + q0 < k_offset + kr0 + 63))
        dkv_dscores<true>(s, dp, rows, q0, krow_lo, Sq, Sk, causal, q_offset,
                          k_offset, c, sm_scale, t);
      else
        dkv_dscores<false>(s, dp, rows, q0, krow_lo, Sq, Sk, causal,
                           q_offset, k_offset, c, sm_scale, t);
    };

    float ak[D / 2], av[D / 2];  // dK and dV of this warpgroup's 64 keys
#pragma unroll
    for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;
    uint32_t pp[4][4], pd[4][4];  // P^T, dS^T of the tile whose products are next

    mbar_wait(ring.item_full(it), ring.item_parity(it));
    // the item's first tiles, which no key of this warpgroup sees
    for (int j = 0; j < skip; ++j) {
      mbar_wait(ring.full(g0 + j), ring.parity(g0 + j));
      if (tid == 0) mbar_arrive(ring.empty(g0 + j));
    }
    if (skip < x.n_tiles) {  // the first tile: S^T and dP^T, then dS^T
      float s[32], dp[32];
      const int g = g0 + skip;
      mbar_wait(ring.full(g), ring.parity(g));
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D>(s, sK, ring.tile(g, 0));
      issue_scores<D>(dp, sV, ring.tile(g, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dscores(s, dp, skip, g);
      pack64(s, pp);
      pack64(dp, pd);
    }
    // tile j: at D 64, S^T_j and dP^T_j in flight with dV += P^T_{j-1}
    // dO_{j-1} and dK += dS^T_{j-1} Q_{j-1}, and dS^T_j forms while those
    // still run; at D 128, tile j-1's products first and done, then tile
    // j's (the register budget, in the header note)
    for (int j = skip + 1; j < x.n_tiles; ++j) {
      float s[32], dp[32];
      const int g = g0 + j;
      if constexpr (kSerial) {
        fence_regs(ak);
        fence_regs(av);
        fence_regs(pp);
        fence_regs(pd);
        wgmma_fence();
        issue_grad<D>(av, pp, ring.tile(g - 1, 1));
        issue_grad<D>(ak, pd, ring.tile(g - 1, 0));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ak);
        fence_regs(av);
        fence_regs(pp);
        fence_regs(pd);
        if (tid == 0) mbar_arrive(ring.empty(g - 1));  // done with tile j-1
        mbar_wait(ring.full(g), ring.parity(g));
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D>(s, sK, ring.tile(g, 0));
        issue_scores<D>(dp, sV, ring.tile(g, 1));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        dscores(s, dp, j, g);
      } else {
        mbar_wait(ring.full(g), ring.parity(g));
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D>(s, sK, ring.tile(g, 0));
        issue_scores<D>(dp, sV, ring.tile(g, 1));
        wgmma_commit();
        fence_regs(ak);
        fence_regs(av);
        fence_regs(pp);
        fence_regs(pd);
        wgmma_fence();
        issue_grad<D>(av, pp, ring.tile(g - 1, 1));
        issue_grad<D>(ak, pd, ring.tile(g - 1, 0));
        wgmma_commit();
        wgmma_wait<1>();  // S^T_j and dP^T_j are done
        fence_regs(s);
        fence_regs(dp);
        dscores(s, dp, j, g);
        wgmma_wait<0>();
        fence_regs(ak);
        fence_regs(av);
        fence_regs(pp);
        fence_regs(pd);
        if (tid == 0) mbar_arrive(ring.empty(g - 1));  // done with tile j-1
      }
      pack64(s, pp);
      pack64(dp, pd);
    }
    if (skip < x.n_tiles) {  // the last tile's dV and dK products
      const int g = g0 + x.n_tiles - 1;
      fence_regs(ak);
      fence_regs(av);
      fence_regs(pp);
      fence_regs(pd);
      wgmma_fence();
      issue_grad<D>(av, pp, ring.tile(g, 1));
      issue_grad<D>(ak, pd, ring.tile(g, 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ak);
      fence_regs(av);
      if (tid == 0) mbar_arrive(ring.empty(g));
    }
    if (tid == 0) mbar_arrive(ring.item_empty(it));  // done with K and V
    g0 += x.n_tiles;

    // ---- epilogue: dk and dv in bf16, keys < Sk only ----------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = krow_lo + 8 * r;
      if (row >= x.r_end) continue;
      const size_t at = ((size_t)x.bh * Sk + row) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * i) =
            pack_bf16(ak[4 * i + 2 * r], ak[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * i) =
            pack_bf16(av[4 * i + 2 * r], av[4 * i + 2 * r + 1]);
      }
    }
  }
}

// ---- fused dq, dk/dv -----------------------------------------------------------

// The fused backward walks a dk/dv item's query tiles from the last down to
// the first that sees its keys: tile j of the walk is query tile
// t0 + n_tiles - 1 - j.
__device__ __forceinline__ int fused_tile(const BwdItem& x, int j) {
  return x.t0 + x.n_tiles - 1 - j;
}

// The last key slot (item of 128 keys) whose keys query tile qt sees: the
// last to add to the tile's dq. Called by a slot that sees the tile, so
// the tile's last row sees key 0 at least.
__device__ __forceinline__ int last_slot(int qt, int Sq, int Sk, int causal,
                                         int q_offset, int k_offset) {
  const int slots = (Sk + kBwdItem - 1) / kBwdItem;
  if (!causal) return slots - 1;
  const int row = min(qt * kBwdTile + kBwdTile - 1, Sq - 1);
  const long long key = (long long)q_offset + row - k_offset;  // its last key
  return key >= Sk - 1 ? slots - 1 : (int)(key / kBwdItem);
}

// dS^T of this warpgroup's 64 keys, packed as the dK product's A fragment
// (pack64), into a dS tile: a row per key of the item (key_lo = this
// thread's first, 64 cw + 16 warp + g; +8 for its second), the tile's 64
// queries a 128-byte row under the 128-byte swizzle (16-byte chunk i of
// row r at i ^ (r % 8); r % 8 is g). So the tile is dS (queries x keys) as
// an MN-major A operand, as V is an MN-major B operand in the forward.
__device__ __forceinline__ void store_ds(unsigned char* tile,
                                         const uint32_t (&pd)[4][4],
                                         int key_lo, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)  // 8-query chunk 2 kk + h
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(tile + (key_lo + 8 * r) * kBoxBytes +
                                     (((2 * kk + h) ^ g) << 4) + 4 * t) =
            pd[kk][2 * h + r];
}

// dq (+)= dS K for one query tile, not committed: dS (64 queries x 128
// keys) from a dS tile, MN-major; K (128 keys x 64 columns) from one
// 64-column box of the item buffer, MN-major (the transpose flags of both).
__device__ __forceinline__ void issue_dq(float (&dq)[32], uint32_t ds,
                                         uint32_t k_box) {
  constexpr uint32_t kBox = kBwdItem * kBoxBytes;
#pragma unroll
  for (int kk = 0; kk < kBwdItem / 16; ++kk)
    wgmma_ss_n64<1, 1>(dq, sw128_desc(ds + kk * 16 * kBoxBytes, kBox),
                       sw128_desc(k_box + kk * 16 * kBoxBytes, kBox), kk > 0);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}
// Named barrier 2 + cw: the 128 threads of consumer warpgroup cw.
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + cw) : "memory");
}

// The sum so far of one dq tile, this warpgroup's 64 x 64 share of it: rows
// row_lo + 8r of the head (rows >= Sq read 0), columns col + 8i of its 64;
// the accumulator fragment's layout, two floats a register pair.
struct DqSum {
  float2 v[2][8];
};

// Wait for slot `slot`'s turn on a dq tile (turn counts the slots that have
// added to it) and read the tile's sum so far past L1 (ld.global.cg:
// another block wrote it). Slot 0 reads nothing: the first to reach a tile
// stores. It runs while wgmmas are in flight, so it has no divergent path
// (ptxas would serialise them, C7518): every lane reads the turn (one
// request a warp) and each warp spins on its own, and a row past Sq reads
// the last row and keeps 0.
__device__ __forceinline__ void dq_fetch(DqSum& sum, const float* dq_acc,
                                         const int* turn, int slot,
                                         size_t row0, int row_lo, int Sq,
                                         int D, int col) {
  if (slot == 0) return;
  // a turn that never comes is a fault in this file: trap (the launch
  // fails) rather than hang the card
  for (long long spins = 0;
       __shfl_sync(0xffffffffu, ld_acquire(turn), 0) != slot; ++spins) {
    if (spins > (1LL << 26)) __trap();
    __nanosleep(32);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const float* src = dq_acc + (row0 + min(row, Sq - 1)) * D + col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(src + 8 * i));
      sum.v[r][i] = row < Sq ? v : make_float2(0.f, 0.f);
    }
  }
}

// Add this item's partial (acc) to the tile's sum and write it back past L1
// (slot 0: the partial alone); the last slot writes bf16 dq instead. Rows
// >= Sq are skipped. The caller then owes the tile's turn (slot + 1), which
// it releases (dq_release) once the warpgroup's stores are all issued.
__device__ __forceinline__ void dq_store(const DqSum& sum,
                                         const float (&acc)[32],
                                         float* dq_acc, bf16* dq, int slot,
                                         int last, size_t row0, int row_lo,
                                         int Sq, int D, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_lo + 8 * r >= Sq) continue;
    const size_t at = (row0 + row_lo + 8 * r) * D + col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float2 v = make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
      if (slot > 0) v = make_float2(sum.v[r][i].x + v.x, sum.v[r][i].y + v.y);
      if (slot == last)
        *reinterpret_cast<uint32_t*>(dq + at + 8 * i) = pack_bf16(v.x, v.y);
      else
        __stcg(reinterpret_cast<float2*>(dq_acc + at + 8 * i), v);
    }
  }
}

// Release a turn: every thread's stores of the tile are issued before the
// barrier, and a release after it makes them visible with it (the
// semaphore pattern); every thread stores the same value, so the code has
// no divergent path (it too runs under wgmmas in flight).
__device__ __forceinline__ void dq_release(int* turn, int value, int cw) {
  warpgroup_sync(cw);
  st_release(turn, value);
}

// The fused backward's ring tiles of one block in order: tile j of item w
// (its items w = blockIdx.x + k gridDim.x, items without tiles skipped); g
// counts them, so tile g sits in stage g % kStages.
struct FusedStream {
  int w, j, g, n_items;
  BwdItem x;
  int BH, Sq, Sk, causal, q_offset, k_offset;

  __device__ void skip_done() {
    while (w < n_items && j >= x.n_tiles) {
      w += gridDim.x;
      j = 0;
      if (w < n_items) x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    }
  }
  __device__ void start() {
    w = blockIdx.x;
    j = g = 0;
    if (w < n_items) x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    skip_done();
  }
  __device__ void next() {
    ++j;
    ++g;
    skip_done();
  }
};

// The fused backward (B7): dq, dk and dv of one pass over the dk/dv items
// (128 keys of one batch*head; K and V in the item buffer, Q and dO tiles
// of 64 queries through the ring, walked from the last query tile down).
// Per tile each consumer warpgroup computes S^T, dP^T and from them P^T and
// dS^T of its 64 keys, as dk/dv does, and adds dV += P^T dO, dK += dS^T Q;
// it also writes dS^T to a dS tile in shared memory, and once both halves
// are there (named barrier 1) the tile's dq partial over the item's 128
// keys is dS K, a wgmma with both operands MN-major from shared memory.
// D 64: one warpgroup takes a tile's whole dq product (64 columns), the
// two in turn by tile, issued with dV and dK's; D 128: each takes its 64
// columns (one box of K), so its accumulator stays at 32 registers beside
// dK and dV's 128, and issues it once dV and dK's products are done. The
// partials are summed in dq_acc in key-slot order (dq_fetch, dq_store,
// dq_release), the ordered turns in `turns` (2 per query tile: a column
// half each), zeroed by the launcher. Items are numbered slot-major, so an
// item waits only on items
// of lower index, and all of the grid's blocks are resident at once (one
// per SM): every wait ends. The walk goes down from the last tile so that
// every slot meets tile i at the same step of its walk, one read-add-write
// behind the slot before it. Slot 0 also writes dq = 0 on the rows no key
// is visible to (below its first tile).
// Block: the two warpgroups alone (kFusedThreads = 256), each a consumer
// that also feeds the ring: 256 threads leave a thread up to 255 registers,
// which D 128 needs (dK and dV's 128 accumulators beside the score and dq
// tiles). With a producer warpgroup beside them (384 threads, as dq and
// dk/dv have), ptxas caps every thread at 168 whatever setmaxnreg asks,
// and at D 128 it spilled and serialised the wgmmas (C7512); a producer
// warp alone (288 threads) is refused at launch, registers being given
// out by warpgroups. So the loads are issued from the consumers' own
// flow: the block's ring tiles form one stream over its items
// (FusedStream), kept kStages - 1 tiles ahead of the one being computed.
// Once both warpgroups have passed tile g's dS barrier, both are done with
// tile g - 1's stage, so there warpgroup 0's thread 0 issues the stream's
// next TMA loads into it and warpgroup 1 writes its lse and delta rows
// (the stage's full barrier counts the 128 arrivals beside the TMA bytes);
// an item's K and V are loaded when the item before the last has ended
// (two item buffers), after a barrier of both at each item's start. No
// empty barriers, no setmaxnreg.
template <int D>
__device__ __forceinline__ void attention_bwd_fused_sm90(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_acc,
    int* __restrict__ turns, int BH, int Sq, int Sk, float sm_scale,
    int causal, int q_offset, int k_offset) {
  using Ring = BwdRing<D, true>;
  const Ring ring = bwd_ring<D, true>();
  const int n_items = BH * ((Sk + kBwdItem - 1) / kBwdItem);
  const int n_qt = (Sq + kBwdTile - 1) / kBwdTile;
  // a stage's full barrier: thread 0's TMA bytes and warpgroup 1's rows
  if (threadIdx.x == 0) ring.init(128);
  __syncthreads();

  const int cw = threadIdx.x / 128, tid = threadIdx.x & 127;
  FusedStream stream{0, 0, 0, n_items, {}, BH, Sq, Sk, causal, q_offset,
                     k_offset};
  stream.start();
  // Warpgroup 1's share of the stream's next tile's rows: thread tid holds
  // lse (base 2; a fully masked row's shifted to 0) of its row tid (< 64)
  // or delta of row tid - 64; a row past Sq holds lse +inf and delta 0, so
  // its p is 0. Read a load ahead, so no load waits on the way.
  float row_value = 0.f;
  auto read_row = [&] {
    if (cw != 1 || stream.w >= n_items) return;
    const int q = fused_tile(stream.x, stream.j) * kBwdTile + (tid & 63);
    const size_t at = (size_t)stream.x.bh * Sq + q;
    if (tid < 64) {
      const float l = q < Sq ? lse[at] : INFINITY;
      row_value = (l == -INFINITY ? 0.f : l) * kLog2e;
    } else {
      row_value = q < Sq ? delta[at] : 0.f;
    }
  };
  // The stream's next ring tile into its stage: Q and dO by TMA (thread
  // 0), the rows by warpgroup 1. Every thread calls it at the same points.
  auto load_tile = [&] {
    if (stream.w >= n_items) return;
    const int g = stream.g, q0 = fused_tile(stream.x, stream.j) * kBwdTile;
    if (threadIdx.x == 0)
      tma_tile<D>(&tq, &tdo, ring.tile(g, 0), ring.tile(g, 1), ring.full(g),
                  q0, stream.x.bh);
    if (cw == 1) {
      ring.rows(g)[tid] = row_value;
      mbar_arrive(ring.full(g));
    }
    stream.next();
    read_row();
  };
  // item it's K and V (both halves, so keys past Sk read as zeros in the
  // dq product) into buffer it % 2
  auto load_item = [&](int w, int it) {
    if (threadIdx.x != 0 || w >= n_items) return;
    const BwdItem x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    tma_item<D>(&tk, &tv, ring.item(it, 0), ring.item(it, 1),
                ring.item_full(it), x.r0, kBwdItem, x.bh);
  };
  load_item(blockIdx.x, 0);
  read_row();
  for (int k = 0; k < Ring::kStages - 1; ++k) load_tile();

  const int warp = tid >> 5, lane = tid & 31, t = lane & 3, gl = lane >> 2;
  const float c = sm_scale * kLog2e;
  int g0 = 0;  // the item's first ring tile in the block's count
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const BwdItem x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    const int slot = w / BH;
    const int kr0 = x.r0 + 64 * cw;            // this warpgroup's keys
    const int krow_lo = kr0 + 16 * warp + gl;  // this thread's: +0, +8
    const uint32_t sK = ring.item(it, 0) + cw * 64 * kBoxBytes;
    const uint32_t sV = ring.item(it, 1) + cw * 64 * kBoxBytes;
    const size_t row0 = (size_t)x.bh * Sq;  // the head's first row

    float ak[D / 2], av[D / 2];  // dK and dV of this warpgroup's 64 keys
#pragma unroll
    for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;

    // This warpgroup's dq tiles: D 64, every other tile of the walk, the
    // warpgroups in turn by ring tile; D 128, every tile (its 64 columns).
    auto turn_of = [&](int j) {
      return turns + ((size_t)x.bh * n_qt + fused_tile(x, j)) * 2 +
             (D == 128 ? cw : 0);
    };
    const int col = (D == 128 ? 64 * cw : 0) + 2 * t;
    DqSum sum;             // the sum so far of this warpgroup's next dq tile
    bool have_sum = false;
    int* owed = nullptr;   // the turn of its last dq tile, not yet released

    // both warpgroups are done with item it - 1: its buffer takes item it + 1
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    load_item(w + gridDim.x, it + 1);
    mbar_wait(ring.item_full(it), ring.item_parity(it));
    // One query tile: S^T, dP^T, then P^T and dS^T; dS^T to the dS tile;
    // then dV, dK and, when kDq, this warpgroup's dq product, all done
    // before the next tile's dS barrier (which frees the stage) and the dq
    // partial added to the tile's sum. Two straight-line bodies (with and
    // without the dq product), so no wgmma is issued under a condition.
    // The sum's global memory latency runs under products in flight: while
    // S^T and dP^T of tile j are, the warpgroup releases the turn it owes;
    // it reads the sum so far of its next dq tile while dV and dK of the
    // tile before are (D 64: tile j + 1 when j is the other's; an item's
    // first tile under its own scores) or while the tile's own dq product
    // is (D 128: registers, not beside the score tiles).
    auto tile = [&](auto dq_flag, int j) {
      constexpr bool kDq = decltype(dq_flag)::value;
      const int g = g0 + j, qt = fused_tile(x, j), q0 = qt * kBwdTile;
      const float* rows = ring.rows(g);
      const bool edge = q0 + kBwdTile > Sq || kr0 + 64 > Sk ||
                        (causal && q_offset + q0 < k_offset + kr0 + 63);
      // read the sum so far of dq tile jf of the walk, once
      auto fetch = [&](int jf) {
        if (have_sum || jf >= x.n_tiles) return;
        dq_fetch(sum, dq_acc, turn_of(jf), slot, row0,
                 fused_tile(x, jf) * kBwdTile + 16 * warp + gl, Sq, D, col);
        have_sum = true;
      };
      auto under_scores = [&] {
        if (owed) {
          dq_release(owed, slot + 1, cw);
          owed = nullptr;
        }
        if (D == 64 && kDq) fetch(j);  // an item's first tile
      };
      uint32_t pp[4][4], pd[4][4];  // P^T and dS^T as A fragments
      // S^T and dP^T of the tile's queries [32 h, 32 h + N / 2) (D 128:
      // two halves, so the f32 scores take 32 registers beside dK and dV's
      // 128, not 64), then P^T and dS^T, packed into pp and pd
      auto scores = [&](auto n_flag, auto h_flag) {
        constexpr int N = decltype(n_flag)::value, h = decltype(h_flag)::value;
        float s[N / 2], dp[N / 2];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D, N>(s, sK, ring.tile(g, 0) + h * 32 * kBoxBytes);
        issue_scores<D, N>(dp, sV, ring.tile(g, 1) + h * 32 * kBoxBytes);
        wgmma_commit();
        if constexpr (h == 0) under_scores();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (edge)
          dkv_dscores<true>(s, dp, rows, q0, krow_lo, Sq, Sk, causal,
                            q_offset, k_offset, c, sm_scale, t, 32 * h);
        else
          dkv_dscores<false>(s, dp, rows, q0, krow_lo, Sq, Sk, causal,
                             q_offset, k_offset, c, sm_scale, t, 32 * h);
        uint32_t ps[N / 16][4], ds[N / 16][4];
        pack64(s, ps);
        pack64(dp, ds);
#pragma unroll
        for (int k = 0; k < N / 16; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pp[2 * h + k][e] = ps[k][e];
            pd[2 * h + k][e] = ds[k][e];
          }
      };
      mbar_wait(ring.full(g), ring.parity(g));
      using First = std::integral_constant<int, 0>;
      if constexpr (D == 128) {
        scores(std::integral_constant<int, 32>(), First());
        scores(std::integral_constant<int, 32>(),
               std::integral_constant<int, 1>());
      } else {
        scores(std::integral_constant<int, 64>(), First());
      }
      store_ds(ring.ds_generic(g & 1), pd, 64 * cw + 16 * warp + gl, gl, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both halves written
      load_tile();  // into tile g - 1's stage, which both are done with
      float aq[32];
      const uint32_t k_box =
          ring.item(it, 0) + (D == 128 ? cw : 0) * kBwdItem * kBoxBytes;
      fence_regs(ak);
      fence_regs(av);
      fence_regs(pp);
      fence_regs(pd);
      if constexpr (kDq && D == 64) fence_regs(aq);
      wgmma_fence();
      issue_grad<D>(av, pp, ring.tile(g, 1));
      issue_grad<D>(ak, pd, ring.tile(g, 0));
      if constexpr (kDq && D == 64) issue_dq(aq, ring.ds(g & 1), k_box);
      wgmma_commit();
      if constexpr (!kDq && D == 64) fetch(j + 1);  // the next tile is ours
      wgmma_wait<0>();
      fence_regs(ak);
      fence_regs(av);
      if constexpr (D == 128) {
        // D 128: the dq product once dV and dK's are done, so its 32
        // accumulators never live beside P^T and dS^T
        fence_regs(aq);
        wgmma_fence();
        issue_dq(aq, ring.ds(g & 1), k_box);
        wgmma_commit();
        fetch(j);
        wgmma_wait<0>();
      }
      if constexpr (kDq) {
        fence_regs(aq);
        const int last = last_slot(qt, Sq, Sk, causal, q_offset, k_offset);
        dq_store(sum, aq, dq_acc, dq, slot, last, row0,
                 q0 + 16 * warp + gl, Sq, D, col);
        have_sum = false;
        if (slot < last) owed = turn_of(j);
      }
    };
    for (int j = 0; j < x.n_tiles; ++j) {
      if constexpr (D == 128)
        tile(std::true_type(), j);
      else if (((g0 + j) & 1) == cw)  // D 64: the warpgroups take turns
        tile(std::true_type(), j);
      else
        tile(std::false_type(), j);
    }
    if (owed) dq_release(owed, slot + 1, cw);
    g0 += x.n_tiles;

    // ---- epilogue ----------------------------------------------------------
    if (slot == 0) {  // dq 0 on the rows below the first tile any key sees
      const int zero_rows = x.n_tiles ? x.t0 * kBwdTile : Sq;
      uint4* out = reinterpret_cast<uint4*>(dq + row0 * D);
      for (int i = 128 * cw + tid; i < zero_rows * D / 8; i += 256)
        out[i] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // dk and dv in bf16, keys < Sk only
      const int row = krow_lo + 8 * r;
      if (row >= x.r_end) continue;
      const size_t at = ((size_t)x.bh * Sk + row) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * i) =
            pack_bf16(ak[4 * i + 2 * r], ak[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * i) =
            pack_bf16(av[4 * i + 2 * r], av[4 * i + 2 * r + 1]);
      }
    }
  }
}

// --- host side --------------------------------------------------------------------

// The backward's map of a (BH, S, D) bf16 tensor (boxes of 64 rows), from a
// per-host-thread cache keyed by base address and shape: a map holds
// nothing else, so a hit is the map a fresh encode would give. dq and
// dk/dv of one backward take the same q, k, v and do, so the second launch
// finds its four maps encoded.
inline cudaError_t bwd_map(CUtensorMap* map, const void* base, int BH, int S,
                           int D) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    int bh, s, d;
  };
  constexpr int kEntries = 8;
  static thread_local Entry cache[kEntries];
  static thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.bh == BH && e.s == S && e.d == D && base) {
      *map = e.map;
      return cudaSuccess;
    }
  Entry& e = cache[next];
  e.base = nullptr;  // a failed encode leaves no entry behind
  const cudaError_t err = encode_bhsd(&e.map, base, BH, S, D, kBwdTile);
  if (err != cudaSuccess) return err;
  e.base = base;
  e.bh = BH;
  e.s = S;
  e.d = D;
  next = (next + 1) % kEntries;
  *map = e.map;
  return cudaSuccess;
}

// The four maps and the grid of a backward launch: one persistent block per
// SM, or per work item when there are fewer.
inline cudaError_t bwd_setup(CUtensorMap (&maps)[4], const void* q,
                             const void* k, const void* v, const void* dout,
                             int BH, int Sq, int Sk, int D, long long items,
                             int* grid) {
  cudaError_t err = bwd_map(&maps[0], q, BH, Sq, D);
  if (err == cudaSuccess) err = bwd_map(&maps[1], k, BH, Sk, D);
  if (err == cudaSuccess) err = bwd_map(&maps[2], v, BH, Sk, D);
  if (err == cudaSuccess) err = bwd_map(&maps[3], dout, BH, Sq, D);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  *grid = (int)(items < sms ? items : sms);
  return cudaSuccess;
}

}  // namespace
