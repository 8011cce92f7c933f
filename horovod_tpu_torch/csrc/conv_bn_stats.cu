// A 3x3 convolution with the batch-norm statistics as its epilogue, for
// Hopper (sm_90a), behind a plain C interface (loaded with ctypes by
// horovod_tpu_torch/tools/conv_bn_probe.py).
//
// Replaces the Pallas TPU kernel _conv_kernel of tools/pallas_conv_bn.py
// (:54, launched by pallas_conv_stats :87): y = conv3x3(x) over an input
// padded by one pixel on each side (so SAME on the unpadded image), y
// stored in bf16, and the per-channel sum and sum of squares of the
// UNROUNDED float32 accumulator. The TPU kernel carries the two sums across
// its sequential grid in the output block; Hopper blocks run in no order,
// so here each block writes its tile's column sums to a (M tiles, Cout)
// float32 scratch and a second kernel sums the scratch in a fixed order:
// deterministic, no atomics.
//
// Layouts (the tool's): x_padded (N, H+2, W+2, Cin) bf16, w (3, 3, Cin,
// Cout) bf16, y (N, H, W, Cout) bf16, sums (Cout,) float32; all contiguous
// and 16-byte aligned, Cin % 32 == 0 and Cout % 64 == 0 (checked by the
// Python wrapper).
//
// The product is an implicit GEMM: M = N*H*W output pixels, N = Cout, K =
// 9*Cin. A block owns a 128 x 64 output tile and loops over the 9 taps x
// Cin/32 chunks: the A chunk is 128 rows of 32 input channels at one tap
// (each row a contiguous 64-byte run of the padded input), the B chunk the
// w[dh, dw] slice of 32 x 64; both are staged in shared memory (B
// transposed, so its K runs along the row, as mma.sync's B operand wants)
// and multiplied with mma.sync m16n8k16, bf16 in and float32 accumulate.
// Eight warps each hold a 32 x 32 piece of the tile.
//
// What bounds it on this card: operations. At the tool's shape, 128 x 14 x
// 14 x 256 -> 256, it does 29.6 GFLOP (29.9 us at 989 TFLOP/s) and must
// move 30.8 MB (9.2 us at 3.35 TB/s). This first version loads
// synchronously (no cp.async or TMA pipeline) and issues mma.sync, not
// wgmma, so it reaches a fraction of the tensor cores' rate; wgmma with a
// TMA ring is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // input channels per chunk (one tap)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kBK + 8;  // bf16 per shared row: 16 bytes of pad
constexpr int kReduceThreads = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulator.
// Fragments (g = lane / 4, t = lane % 4):
//   A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8):  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_stats_kernel(const bf16* __restrict__ xp,
                         const bf16* __restrict__ w, bf16* __restrict__ y,
                         float* __restrict__ part_sum,
                         float* __restrict__ part_sq, int N, int H, int W,
                         int Cin, int Cout) {
  __shared__ __align__(16) bf16 As[kBM * kStride];
  __shared__ __align__(16) bf16 Bs[kBN * kStride];
  __shared__ float red_sum[4][kBN];
  __shared__ float red_sq[4][kBN];

  const int M = N * H * W;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps of 32 x 32
  const int Wp = W + 2;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int chunks = Cin / kBK;
  for (int kc = 0; kc < 9 * chunks; ++kc) {
    const int tap = kc / chunks, c0 = (kc % chunks) * kBK;
    const int dh = tap / 3, dw = tap % 3;
    __syncthreads();  // the previous chunk's fragments have been read
    // A: 128 rows x 32 channels = 4 vectors of 8 per row
    for (int i = threadIdx.x; i < kBM * 4; i += kThreads) {
      const int r = i >> 2, v = (i & 3) * 8;
      const int m = m0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const int n = m / (H * W), hw = m % (H * W);
        const int h = hw / W, ww = hw % W;
        const int64_t off =
            (((int64_t)n * (H + 2) + h + dh) * Wp + ww + dw) * Cin + c0 + v;
        val = *reinterpret_cast<const uint4*>(xp + off);
      }
      *reinterpret_cast<uint4*>(As + r * kStride + v) = val;
    }
    // B: w[dh, dw, c0:c0+32, n0:n0+64], stored transposed: Bs[n][k]
    for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
      const int k = i / (kBN / 8), nv = (i % (kBN / 8)) * 8;
      const int64_t off = ((int64_t)tap * Cin + c0 + k) * Cout + n0 + nv;
      uint4 val = *reinterpret_cast<const uint4*>(w + off);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[(nv + j) * kStride + k] = e[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* p = As + (wm * 32 + i * 16 + g) * kStride + kk + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * kStride);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * kStride + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = Bs + (wn * 32 + j * 8 + g) * kStride + kk + 2 * t;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j]);
    }
  }

  // Epilogue 1: y in bf16, rows past M not written.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][j][2 * half],
                                                 acc[i][j][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)m * Cout + col) = v;
      }
    }

  // Epilogue 2: column sums of the f32 accumulator (rows past M hold 0).
  // Within a warp: the thread's 4 rows, then lanes of equal t (xor 4, 8,
  // 16); across the 4 warps of a column strip: in shared memory, in order.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = acc[i][j][2 * half + e];
          s += v;
          q += v * v;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (g == 0) {
        const int col = wn * 32 + j * 8 + 2 * t + e;
        red_sum[wm][col] = s;
        red_sq[wm][col] = q;
      }
    }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int c = threadIdx.x;
    const float s = ((red_sum[0][c] + red_sum[1][c]) + red_sum[2][c]) +
                    red_sum[3][c];
    const float q = ((red_sq[0][c] + red_sq[1][c]) + red_sq[2][c]) +
                    red_sq[3][c];
    part_sum[(int64_t)blockIdx.x * Cout + n0 + c] = s;
    part_sq[(int64_t)blockIdx.x * Cout + n0 + c] = q;
  }
}

// One block per channel: sums its column of the (tiles, Cout) scratch, each
// thread a fixed strided subset in order, then a tree in shared memory.
__global__ void __launch_bounds__(kReduceThreads)
    column_sum_kernel(const float* __restrict__ part_sum,
                      const float* __restrict__ part_sq, float* __restrict__ sum,
                      float* __restrict__ sumsq, int tiles, int Cout) {
  __shared__ float ss[kReduceThreads], sq[kReduceThreads];
  const int c = blockIdx.x;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < tiles; i += kReduceThreads) {
    s += part_sum[(int64_t)i * Cout + c];
    q += part_sq[(int64_t)i * Cout + c];
  }
  ss[threadIdx.x] = s;
  sq[threadIdx.x] = q;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      ss[threadIdx.x] += ss[threadIdx.x + half];
      sq[threadIdx.x] += sq[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sum[c] = ss[0];
    sumsq[c] = sq[0];
  }
}

}  // namespace

// The C interface. Each returns a cudaError_t (0 on success).
extern "C" {

// Rows of the scratch the caller allocates: one per 128 output pixels.
int hvd_conv_bn_stats_tiles(int N, int H, int W) {
  return (N * H * W + kBM - 1) / kBM;
}

int hvd_conv3x3_stats(const void* xp, const void* w, void* y, void* part_sum,
                      void* part_sq, int N, int H, int W, int Cin, int Cout,
                      void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin % kBK || Cout % kBN || Cin <= 0 ||
      Cout <= 0)
    return cudaErrorInvalidValue;
  dim3 grid(hvd_conv_bn_stats_tiles(N, H, W), Cout / kBN);
  conv3x3_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)xp, (const bf16*)w, (bf16*)y, (float*)part_sum,
      (float*)part_sq, N, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

int hvd_column_sums(const void* part_sum, const void* part_sq, void* sum,
                    void* sumsq, int tiles, int Cout, void* stream) {
  if (tiles <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  column_sum_kernel<<<Cout, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const float*)part_sum, (const float*)part_sq, (float*)sum,
      (float*)sumsq, tiles, Cout);
  return (int)cudaGetLastError();
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
