// Flash attention for Hopper (sm_90a): a forward kernel, a dq kernel, a
// dk/dv kernel and a fused dq/dk/dv kernel, behind a plain C interface
// (loaded with ctypes by horovod_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel (:109) and _fwd_single_kernel (:205)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel (:395) and _bwd_dq_single_kernel (:523)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (:456) and _bwd_dkv_single_kernel (:591)
//   flash_bwd_fused_kernel <- _bwd_single_kernel (:654), FLASH_FUSED_BWD=1
// The TPU splits each function into a single-block and a multi-block kernel
// because its VMEM holds a whole 1024-key extent; that is TPU tuning. Here
// one tiled kernel per function takes any sequence length and masks the
// ragged edge itself.
//
// What it computes, exactly as the TPU kernels do:
//   * scores s = sm_scale * q k^T, kept in base 2 (times log2 e) for exp2;
//   * the causal mask keeps q_offset + i >= k_offset + j (global positions);
//   * a row whose keys are all masked gets o = 0, lse = -inf and zero
//     gradients, never NaN (the backward shifts by lse_safe = 0 there);
//   * lse is (B, H, Sq) float32 in natural log (no 128-lane broadcast);
//   * delta = sum_d do*o comes from the caller (a torch reduction).
// Inputs are bf16, contiguous (B, H, S, D) with D in {64, 128}, 16-byte
// aligned; the Python wrapper checks all of that before it launches.
//
// Precision: every product takes bf16 operands and accumulates in f32. The
// probability tile p and the dS tile are rounded to bf16 before their
// products, as FLASH_MXU_BF16=1 does on the TPU. The softmax max, exp2 and
// row sums stay f32: the row sum adds the f32 p, so lse is exact to float32
// and the backward, which recomputes p from lse, sees the true softmax;
// only the p.v product sees bf16 p.
//
// The forward, flash_fwd_kernel, runs the Hopper mainloop of
// attention_fwd_sm90.cuh (shared with the attention probes): TMA loads of K
// and V through a ring of shared-memory stages fed by a producer warp,
// two consumer warpgroups of 64 query rows each, wgmma for q k^T (both
// operands from shared memory) and for p v (p from registers, v MN-major
// from shared memory). What bounds it: at the BERT-Large shape (a) (B8 H16
// S512 D64, non-causal) it moves 33.8 MB and does 8.6 GFLOP: 10.1 us of
// HBM at 3.35 TB/s against 8.7 us of bf16 tensor-core time at 989 TFLOP/s;
// at GPT-2's shape (b) (B16 H12 S1024 D64, causal) 101.4 MB and 25.8 GFLOP
// over the unmasked pairs: 30.3 us against 26.1 us. Both are bound by
// bytes, the operations close behind. What the design does about it: each
// operand is read from HBM about once per 128-row query block (K and V of a
// head stay in L2 across its blocks), the (S, S) scores never leave
// registers, the copies run ahead of the products through the stage ring,
// and the products run at the wgmma rate, not mma.sync's.
//
// dq and dk/dv, flash_bwd_dq_kernel and flash_bwd_dkv_kernel, run the
// Hopper backward mainloops of attention_bwd_sm90.cuh on the same
// primitives: persistent blocks of a TMA producer and two wgmma consumer
// warpgroups; every product is a wgmma on its operands as they lie in HBM
// (K-major or MN-major descriptors, no hand transposes), dS and p
// recomputed from lse in registers, each gradient row summed in one block.
// What bounds them: at (a), dq does 12.9 GFLOP and moves 42.5 MB (13.0 us
// of tensor-core time against 12.7 us of HBM), dk/dv 17.2 GFLOP and 50.9
// MB (17.4 against 15.2 us): operations, by a little. The design keeps the
// tensor cores fed: the ring's copies run ahead of the products, the
// register products take dS and p without a trip through shared memory,
// and a tile's exponentials run while the previous tile's products do
// (dk/dv at D 128 excepted: its register budget, in the header).
//
// The fused backward computes s and p once for all three gradients, as the
// TPU kernel does, but not over the TPU's whole-extent block: a 1024 x 1024
// f32 score block is 4 MB against 227 KB of shared memory. One block per
// batch*head (the TPU grid) walks 64-key blocks with dk and dv in
// registers and sums dq in a float32 scratch of its own (below). Its five
// products over the unmasked pairs bound it by operations: 64.5 GFLOP, 65 us
// at GPT-2's shape (B16 H12 S1024 D64, causal). 192 blocks of 4 warps on 132
// SMs leave most of each SM idle, so it is slower than dq + dk/dv there: the
// TPU measured the same loss (the kernel's docstring).

#include "attention_bwd_sm90.cuh"
#include "attention_fwd_sm90.cuh"
#include "mma_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward: one block per (128 query rows, batch*head) on the shared Hopper
// mainloop (attention_fwd_sm90.cuh); q, k and v come in as tensor maps.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int BH, int Sq, int Sk,
                 float sm_scale, int causal, int q_offset, int k_offset) {
  attention_fwd_sm90<D, D, true>(tq, tk, tv, o, lse, BH, Sq, Sk, sm_scale,
                                 causal, q_offset, k_offset);
}

// ---------------------------------------------------------------------------
// dq and dk/dv: persistent blocks on the Hopper backward mainloops
// (attention_bwd_sm90.cuh); q, k, v and do come in as tensor maps.
//   dq: items of 128 query rows, key tiles of 64 through the ring;
//   dk/dv: items of 128 key rows, query tiles of 64 through the ring.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int BH, int Sq, int Sk, float sm_scale, int causal,
                    int q_offset, int k_offset) {
  attention_bwd_dq_sm90<D>(tq, tk, tv, tdo, lse, delta, dq, BH, Sq, Sk,
                           sm_scale, causal, q_offset, k_offset);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int BH, int Sq, int Sk,
                     float sm_scale, int causal, int q_offset, int k_offset) {
  attention_bwd_dkv_sm90<D>(tq, tk, tv, tdo, lse, delta, dk, dv, BH, Sq, Sk,
                            sm_scale, causal, q_offset, k_offset);
}

// ---------------------------------------------------------------------------
// Fused backward (B7): dq, dk and dv in one pass. One block per batch*head
// walks the key blocks of kRows; for each it keeps dk and dv in registers
// and walks the query blocks of BM that see it. s and p are computed once
// per (key block, query block) and give all three products:
//   dv += p^T do, dk += ds^T q (per warp, its 16 keys), and
//   dq[query block] += ds k (the whole block, through shared memory).
// dq is summed in float32 in dq_acc, a (Sq, D) scratch of this block alone:
// each thread always owns the same elements of every query block, so the
// sum runs in a fixed order (key block 0, 1, ...) with no atomics and no
// barrier, and the same thread casts it to bf16 at the end.
// ---------------------------------------------------------------------------

template <int D, int BM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ dq_acc, int Sq, int Sk,
                       float sm_scale, int causal, int q_offset,
                       int k_offset) {
  static_assert(kWarps % (BM / 16) == 0, "warps must tile the dq block");
  constexpr int kStr = D + kPad;      // rows of D: k, v, q, do
  constexpr int kStrT = BM + kPad;    // transposed q and do (query along row)
  constexpr int kStrK = kRows + kPad; // transposed k and ds (key along row)
  // dq block (BM x D) split among the warps: a 16-row tile and kDqN
  // n8 tiles of columns each
  constexpr int kDqN = BM * D / (16 * 8 * kWarps);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // kRows x kStr
  bf16* sV = sK + kRows * kStr;              // kRows x kStr
  bf16* sKt = sV + kRows * kStr;             // D x kStrK
  bf16* sQ = sKt + D * kStrK;                // BM x kStr
  bf16* sQt = sQ + BM * kStr;                // D x kStrT
  bf16* sO = sQt + D * kStrT;                // BM x kStr   (do)
  bf16* sOt = sO + BM * kStr;                // D x kStrT   (do transposed)
  bf16* sDs = sOt + D * kStrT;               // BM x kStrK  (ds, query rows)
  float* sL = reinterpret_cast<float*>(sDs + BM * kStrK);  // BM: lse * log2e
  float* sDl = sL + BM;                                    // BM: delta

  const size_t bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += bh * Sq * D;
  dout += bh * Sq * D;
  dq += bh * Sq * D;
  dq_acc += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  dk += bh * Sk * D;
  dv += bh * Sk * D;
  lse += bh * Sq;
  delta += bh * Sq;

  const float c = sm_scale * kLog2e;
  const int dq_row = (warp % (BM / 16)) * 16;          // this warp's dq tile
  const int dq_col = (warp / (BM / 16)) * kDqN * 8;

  for (int k0 = 0; k0 < Sk; k0 += kRows) {
    __syncthreads();  // the previous key block is done with sK, sV, sKt
    load_tile<D>(sK, kStr, k, k0, kRows, Sk);
    load_tile<D>(sV, kStr, v, k0, kRows, Sk);
    load_tile_t<D>(sKt, kStrK, k, k0, kRows, Sk);

    float ak[D / 8][4], av[D / 8][4];  // dk and dv of this warp's 16 keys
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.f;
      av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.f;
    }
    const int krow_lo = k0 + warp * 16 + g;  // this thread's keys: +0, +8
    const int qstart = first_query(Sq, causal, q_offset, k_offset, k0);
    for (int q0 = (qstart / BM) * BM; q0 < Sq; q0 += BM) {
      __syncthreads();  // the previous query block is done with its tiles
      load_tile<D>(sQ, kStr, q, q0, BM, Sq);
      load_tile_t<D>(sQt, kStrT, q, q0, BM, Sq);
      load_tile<D>(sO, kStr, dout, q0, BM, Sq);
      load_tile_t<D>(sOt, kStrT, dout, q0, BM, Sq);
      for (int i = threadIdx.x; i < BM; i += kThreads) {
        const bool in = q0 + i < Sq;
        const float x = in ? lse[q0 + i] : 0.f;
        sL[i] = (x == -INFINITY ? 0.f : x) * kLog2e;
        sDl[i] = in ? delta[q0 + i] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T for this warp's 16 keys
      float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], a2[4];
        load_a(a, sK, kStr, warp * 16, kk * 16, lane);
        load_a(a2, sV, kStr, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          uint32_t b[2];
          load_b(b, sQ, kStr, j * 8, kk * 16, lane);
          mma16816(s[j], a, b);
          load_b(b, sO, kStr, j * 8, kk * 16, lane);
          mma16816(dp[j], a2, b);
        }
      }
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = j * 8 + 2 * t + (e & 1);  // query, local
          const int col = q0 + cl;
          const int rl = warp * 16 + g + ((e >> 1) << 3);  // key, local
          const int row = k0 + rl;
          const bool masked = col >= Sq || row >= Sk ||
                              (causal && q_offset + col < k_offset + row);
          const float p = masked ? 0.f : exp2f(s[j][e] * c - sL[cl]);
          const float ds = p * (dp[j][e] - sDl[cl]) * sm_scale;
          s[j][e] = p;
          dp[j][e] = ds;
          sDs[cl * kStrK + rl] = __float2bfloat16(ds);  // rounded as in c_to_a
        }
      // dv += p^T do, dk += ds^T q (contraction over the block's queries)
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b[2];
          load_b(b, sOt, kStrT, n * 8, kk * 16, lane);
          mma16816(av[n], pa, b);
          load_b(b, sQt, kStrT, n * 8, kk * 16, lane);
          mma16816(ak[n], da, b);
        }
      }
      __syncthreads();  // every warp's ds is in sDs

      // dq[block] += ds k over the key block: this warp's 16 x (8 kDqN) tile
      float aq[kDqN][4];
#pragma unroll
      for (int n = 0; n < kDqN; ++n)
        aq[n][0] = aq[n][1] = aq[n][2] = aq[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        uint32_t a[4];
        load_a(a, sDs, kStrK, dq_row, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < kDqN; ++n) {
          uint32_t b[2];
          load_b(b, sKt, kStrK, dq_col + n * 8, kk * 16, lane);
          mma16816(aq[n], a, b);
        }
      }
      // key block 0 is the first to visit any query block (the query blocks
      // a key block sees only shrink as k0 grows): it stores, later ones add
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + dq_row + g + 8 * r;
        if (row >= Sq) continue;
#pragma unroll
        for (int n = 0; n < kDqN; ++n) {
          float2* p = reinterpret_cast<float2*>(
              dq_acc + (size_t)row * D + dq_col + n * 8 + 2 * t);
          float2 x = make_float2(aq[n][2 * r], aq[n][2 * r + 1]);
          if (k0 > 0) {
            const float2 y = *p;
            x.x += y.x;
            x.y += y.y;
          }
          *p = x;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = krow_lo + 8 * r;
      if (row >= Sk) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const size_t off = (size_t)row * D + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(ak[n][2 * r], ak[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(av[n][2 * r], av[n][2 * r + 1]);
      }
    }
  }

  // dq to bf16 by the threads that summed it; query blocks that key block 0
  // never visited see no key at all, so their dq is 0.
  const int qstart0 = first_query(Sq, causal, q_offset, k_offset, 0);
  const int visited0 = qstart0 < Sq ? (qstart0 / BM) * BM : Sq;
  for (int q0 = 0; q0 < Sq; q0 += BM)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + dq_row + g + 8 * r;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < kDqN; ++n) {
        const size_t off = (size_t)row * D + dq_col + n * 8 + 2 * t;
        float2 x = make_float2(0.f, 0.f);
        if (q0 >= visited0) x = *reinterpret_cast<const float2*>(dq_acc + off);
        *reinterpret_cast<uint32_t*>(dq + off) = pack_bf16(x.x, x.y);
      }
    }
}

// ---------------------------------------------------------------------------
// Launchers (launch_prep: mma_tiles.cuh)
// ---------------------------------------------------------------------------

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int BH, int Sq, int Sk, float sm_scale, int causal,
               int q_offset, int k_offset, cudaStream_t stream) {
  static const cudaError_t prep =
      launch_prep(flash_fwd_kernel<D>, FwdLayout<D, D>::kSmem);
  if (prep != cudaSuccess) return prep;
  return launch_attention_fwd<D, D>(flash_fwd_kernel<D>, q, k, v, o, lse, BH,
                                    Sq, Sk, sm_scale, causal, q_offset,
                                    k_offset, stream);
}

// The backward launchers: the four maps come from bwd_map's cache, so the
// dk/dv launch of a backward reuses the maps its dq launch encoded.
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int Sq,
              int Sk, float sm_scale, int causal, int q_offset, int k_offset,
              cudaStream_t stream) {
  static const cudaError_t prep =
      launch_prep(flash_bwd_dq_kernel<D>, BwdLayout<D>::kSmem);
  if (prep != cudaSuccess) return prep;
  CUtensorMap m[4];
  int grid = 0;
  const cudaError_t err =
      bwd_setup(m, q, k, v, dout, BH, Sq, Sk, D,
                (long long)BH * ((Sq + kBwdItem - 1) / kBwdItem), &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<grid, kBwdThreads, BwdLayout<D>::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
      (bf16*)dq, BH, Sq, Sk, sm_scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BH,
               int Sq, int Sk, float sm_scale, int causal, int q_offset,
               int k_offset, cudaStream_t stream) {
  static const cudaError_t prep =
      launch_prep(flash_bwd_dkv_kernel<D>, BwdLayout<D>::kSmem);
  if (prep != cudaSuccess) return prep;
  CUtensorMap m[4];
  int grid = 0;
  const cudaError_t err =
      bwd_setup(m, q, k, v, dout, BH, Sq, Sk, D,
                (long long)BH * ((Sk + kBwdItem - 1) / kBwdItem), &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<grid, kBwdThreads, BwdLayout<D>::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, BH, Sq, Sk, sm_scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <int D, int BM>
int launch_bwd_fused(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, void* dq_acc, int BH,
                     int Sq, int Sk, float sm_scale, int causal, int q_offset,
                     int k_offset, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(bf16) * ((2 * kRows + 2 * BM) * (D + kPad) +
                      (D + BM) * (kRows + kPad) + 2 * D * (BM + kPad)) +
      sizeof(float) * 2 * BM;
  static const cudaError_t prep =
      launch_prep(flash_bwd_fused_kernel<D, BM>, smem);
  if (prep != cudaSuccess) return prep;
  flash_bwd_fused_kernel<D, BM><<<BH, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, (bf16*)dk, (bf16*)dv,
      (float*)dq_acc, Sq, Sk, sm_scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

}  // namespace

// The C interface. Each returns a cudaError_t (0 on success); the fused
// backward's tile widths per head_dim keep its f32 accumulators within the
// register file.
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, int D, float sm_scale,
                  int causal, int q_offset, int k_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, BH, Sq, Sk, sm_scale, causal,
                          q_offset, k_offset, s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, BH, Sq, Sk, sm_scale, causal,
                           q_offset, k_offset, s);
  return cudaErrorInvalidValue;
}

int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int Sq, int Sk, int D, float sm_scale,
                     int causal, int q_offset, int k_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, Sq, Sk, sm_scale,
                         causal, q_offset, k_offset, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, Sq, Sk,
                          sm_scale, causal, q_offset, k_offset, s);
  return cudaErrorInvalidValue;
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int BH, int Sq, int Sk, int D,
                      float sm_scale, int causal, int q_offset, int k_offset,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk,
                          sm_scale, causal, q_offset, k_offset, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk,
                           sm_scale, causal, q_offset, k_offset, s);
  return cudaErrorInvalidValue;
}

int hvd_flash_bwd_fused(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, void* dq_acc, int BH,
                        int Sq, int Sk, int D, float sm_scale, int causal,
                        int q_offset, int k_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_bwd_fused<64, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    dq_acc, BH, Sq, Sk, sm_scale, causal,
                                    q_offset, k_offset, s);
  if (D == 128)
    return launch_bwd_fused<128, 32>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     dq_acc, BH, Sq, Sk, sm_scale, causal,
                                     q_offset, k_offset, s);
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
