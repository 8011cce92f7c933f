// Single-k-block attention probes for Hopper (sm_90a), behind a plain C
// interface (loaded with ctypes by horovod_tpu_torch/tools/flash_vpu_probe.py).
//
// Replaces the Pallas TPU kernels of tools/flash_vpu_probe.py:
//   probe_fwd_kernel<D, D, false>   <- _simple1_kernel (:159)      B14
//   probe_fwd_kernel<D, D, true>    <- _simple1_lse_kernel (:173)  B13
//   probe_fwd_kernel<128, 64, false> <- _pack2_kernel (:94)        B12
// Each is its own launch and its own entry point below.
//
// What they compute, as the TPU kernels do: non-causal attention over every
// key of the head with a direct softmax: the row max m and the row sum l of
// exp2(s - m) over the whole key extent first, then o = (p v) / l with the
// unnormalised p = exp2(s - m), scores s = sm_scale * log2(e) * q k^T. B13
// also writes lse = m ln 2 + ln l, (B, H, S) float32 in natural log, as the
// port's flash forward returns it. B12 takes two heads packed by the caller
// into one 128-deep contraction: q2 (b, h/2, 2S, 128) holds head A's q in
// lanes 0:64 of rows 0:S and head B's in lanes 64:128 of rows S:2S (zeros
// elsewhere), k2 and v2 (b, h/2, S, 128) hold both heads' k and v side by
// side, so q2 k2^T is each head's own scores; o2 (b, h/2, 2S, 64) keeps
// lanes 0:64 of p v2 for rows below S and lanes 64:128 above. Both of its
// products run over the zero half, so it executes twice the useful MACs
// (the tool's note, :80-91).
//
// The TPU kernel holds a head's whole K and V in VMEM; here K and V of a
// packed head (S=512 x 128 bf16) are 256 KB, more than shared memory, so a
// block of 4 warps owns 64 query rows of one (batch, head) and streams
// 64-row K (and V) tiles through shared memory twice: pass 1 finds m and l
// (online over tiles, scalars only), pass 2 recomputes s and sums p v, so
// the accumulator is never rescaled, as in the TPU's direct softmax. That
// costs a third product (1.5x the useful tensor-core work) against the
// flash forward's online softmax: the probe measures what the direct
// softmax costs on this card.
//
// Precision: bf16 operands, f32 accumulation (mma.sync m16n8k16); m, l and
// lse in f32 from the f32 scores; p is rounded to bf16 for the p v product.
// What bounds them: at BERT-Large's shape (B8 H16 S512 D64) 8.6 GFLOP of
// useful work (8.7 us at 989 TFLOP/s) against 33.6 MB of q, k, v and o
// (10.0 us at 3.35 TB/s; B12 moves 42 MB with the packed q2): bytes.

#include "mma_tiles.cuh"

namespace {

constexpr int kBN = 64;  // keys per streamed tile

// s = q k^T for this warp's 16 query rows and the kBN keys of sK.
template <int D>
__device__ __forceinline__ void tile_scores(float s[kBN / 8][4],
                                            const uint32_t qa[D / 16][4],
                                            const bf16* sK, int lane) {
  constexpr int kStr = D + kPad;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      load_b(b, sK, kStr, j * 8, kk * 16, lane);
      mma16816(s[j], qa[kk], b);
    }
  }
}

// One block per (64 query rows, batch*head). OUT_D < D is the packed
// layout: rows at or past Sk write lanes OUT_D..2*OUT_D of the product.
template <int D, int OUT_D, bool kLse>
__global__ void __launch_bounds__(kThreads)
probe_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, float sm_scale) {
  static_assert(OUT_D == D || 2 * OUT_D == D, "packed output is half of D");
  constexpr int kStr = D + kPad;
  constexpr int kStrT = kBN + kPad;
  constexpr int kHi = OUT_D < D ? OUT_D / 8 : 0;  // first n tile of lanes hi
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // kRows x kStr
  bf16* sK = sQ + kRows * kStr;              // kBN x kStr
  bf16* sVt = sK + kBN * kStr;               // D x kStrT

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  q += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  o += bh * Sq * OUT_D;

  load_tile<D>(sQ, kStr, q, q0, kRows, Sq);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qa[kk], sQ, kStr, warp * 16, kk * 16, lane);
  const float c = sm_scale * kLog2e;

  // pass 1: the row max m and row sum l over every key
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Sk; k0 += kBN) {
    __syncthreads();
    load_tile<D>(sK, kStr, k, k0, kBN, Sk);
    __syncthreads();
    float s[kBN / 8][4];
    tile_scores<D>(s, qa, sK, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = col < Sk ? s[j][e] * c : -INFINITY;
          mx = fmaxf(mx, s[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: each tile has a key
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        sum += exp2f(s[j][2 * r] - m_new) + exp2f(s[j][2 * r + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * exp2f(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }

  // pass 2: acc = p v with p = exp2(s - m), never rescaled
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += kBN) {
    __syncthreads();
    load_tile<D>(sK, kStr, k, k0, kBN, Sk);
    load_tile_t<D>(sVt, kStrT, v, k0, kBN, Sk);
    __syncthreads();
    float s[kBN / 8][4];
    tile_scores<D>(s, qa, sK, lane);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = col < Sk ? exp2f(s[j][e] * c - m[e >> 1]) : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        load_b(b, sVt, kStrT, n * 8, kk * 16, lane);
        mma16816(acc[n], pa, b);
      }
    }
  }

  const int row_lo = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / l[r];
    const bool hi = kHi > 0 && row >= Sk;  // packed: the second head's rows
#pragma unroll
    for (int n = 0; n < OUT_D / 8; ++n) {
      const float x0 = hi ? acc[n + kHi][2 * r] : acc[n][2 * r];
      const float x1 = hi ? acc[n + kHi][2 * r + 1] : acc[n][2 * r + 1];
      *reinterpret_cast<uint32_t*>(o + (size_t)row * OUT_D + n * 8 + 2 * t) =
          pack_bf16(x0 * inv, x1 * inv);
    }
    if (kLse && t == 0) lse[bh * Sq + row] = m[r] * kLn2 + logf(l[r]);
  }
}

template <int D, int OUT_D, bool kLse>
int launch_probe(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Sq, int Sk, float sm_scale,
                 cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(bf16) * ((kRows + kBN) * (D + kPad) + D * (kBN + kPad));
  static const cudaError_t prep =
      launch_prep(probe_fwd_kernel<D, OUT_D, kLse>, smem);
  if (prep != cudaSuccess) return prep;
  dim3 grid((Sq + kRows - 1) / kRows, BH);
  probe_fwd_kernel<D, OUT_D, kLse><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      Sq, Sk, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// The C interface. Each returns a cudaError_t (0 on success).
extern "C" {

// B14: o only; q, k, v (BH, S, D) with D 64 or 128.
int hvd_probe_simple1(const void* q, const void* k, const void* v, void* o,
                      int BH, int S, int D, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_probe<64, 64, false>(q, k, v, o, nullptr, BH, S, S,
                                       sm_scale, s);
  if (D == 128)
    return launch_probe<128, 128, false>(q, k, v, o, nullptr, BH, S, S,
                                         sm_scale, s);
  return cudaErrorInvalidValue;
}

// B13: o and lse (BH, S) float32.
int hvd_probe_simple1_lse(const void* q, const void* k, const void* v,
                          void* o, void* lse, int BH, int S, int D,
                          float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_probe<64, 64, true>(q, k, v, o, lse, BH, S, S, sm_scale, s);
  if (D == 128)
    return launch_probe<128, 128, true>(q, k, v, o, lse, BH, S, S, sm_scale,
                                        s);
  return cudaErrorInvalidValue;
}

// B12: q2 (BH2, 2S, 128), k2 and v2 (BH2, S, 128) -> o2 (BH2, 2S, 64).
int hvd_probe_pack2(const void* q2, const void* k2, const void* v2, void* o2,
                    int BH2, int S, float sm_scale, void* stream) {
  return launch_probe<128, 64, false>(q2, k2, v2, o2, nullptr, BH2, 2 * S, S,
                                      sm_scale, (cudaStream_t)stream);
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
