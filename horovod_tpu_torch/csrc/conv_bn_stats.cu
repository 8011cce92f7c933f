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
// so here each output tile writes its column sums to a (M tiles, Cout)
// float32 scratch and a second kernel sums the scratch in a fixed order:
// deterministic, no atomics.
//
// Layouts (the tool's): x_padded (N, H+2, W+2, Cin) bf16, w (3, 3, Cin,
// Cout) bf16, y (N, H, W, Cout) bf16, sums (Cout,) float32; all contiguous
// and 16-byte aligned, Cin % 32 == 0 and Cout % 64 == 0 (checked by the
// Python wrapper).
//
// The product is an implicit GEMM: M = N*H*W output pixels, N = Cout, K =
// 9*Cin, on the wgmma, TMA and mbarrier primitives of attention_fwd_sm90.cuh.
// A work item is an output tile of 128 pixels x BN channels, BN the widest
// of 256, 128 and 64 that divides Cout (conv_n_tile). Its K runs in chunks
// of 64 input channels at one tap (9 taps x ceil(Cin / 64) chunks) through
// a ring of shared-memory stages. Persistent blocks of three warpgroups
// take every gridDim.x-th item, N tiles fastest, so the blocks at work
// share their A rows in L2:
//   * warpgroup 0, the producer, fills a stage. B, w viewed as (9 Cin,
//     Cout), is BN / 64 TMA boxes of 64 rows x 64 channels under the
//     128-byte swizzle, issued by thread 0 against the stage's full
//     mbarrier. A is a gather: each pixel's 64 channels at one tap are one
//     128-byte run of x_padded, but 128 consecutive output pixels are no
//     rectangle of it (rows wrap at W and at each image). Its 128 threads
//     issue cp.async copies of 16 bytes, 8 a thread a chunk, into the
//     128-byte-swizzled layout TMA would write; a pixel past M or a channel
//     past Cin (Cin % 64 == 32: the chunk's upper half) is zero-filled, so
//     its products vanish. The route is cp.async rather than TMA's im2col
//     mode because its addresses are plain arithmetic this file states
//     (the im2col box and offset rules of cuTensorMapEncodeIm2col are not);
//     the producer's threads are otherwise idle. cp.async writes through
//     the generic proxy and wgmma reads through the async proxy, so a
//     thread does not arrive on the stage's full barrier when its copies
//     are merely issued (cp.async.mbarrier.arrive would): it keeps kLag
//     chunks in flight, waits for the oldest (cp.async.wait_group), issues
//     fence.proxy.async and then arrives.
//   * warpgroups 1 and 2, the consumers, take 64 pixels each: per chunk
//     four wgmma m64nBNk16, A K-major (the pixel's channels as they lie)
//     and B MN-major (w's output channels contiguous: the transpose flag,
//     no hand transpose), the f32 accumulator in registers; a stage is
//     released once the next chunk's products are issued and its own done.
//   * epilogue: y in bf16 from the f32 accumulator; each column's sum and
//     sum of squares over the tile's 128 rows in a fixed order (a thread's
//     two rows, then the lanes of its column by xor shuffles, then the 8
//     warps' partials in shared memory in warp order) into the scratch row
//     of its M tile. Rows past M hold 0 and add nothing.
//
// What bounds it on this card: operations. At the tool's shape, 128 x 14 x
// 14 x 256 -> 256, it does 29.6 GFLOP (29.9 us at 989 TFLOP/s) and must
// move 30.8 MB (9.2 us at 3.35 TB/s); every ResNet-50 stage of the sweep
// does the same 29.6 GFLOP. What holds it back is L2: the im2col gather
// reads each input pixel 9 times and each tile re-reads its A chunks once
// per N tile and its B chunks once per M tile, 300-700 MB through L2 per
// call. Wider N tiles re-read A less, and that outweighs their fewer items
// (at 7 x 7 x 512, 98 items of 256 channels for 132 SMs beat 392 of 64:
// PERF.md section 6). This file's kernels fit the 168 registers a thread
// that 384 threads leave, the N tile of 256's 128 accumulators included.

#include "attention_fwd_sm90.cuh"

namespace {

constexpr int kConvThreads = 384;  // producer + two consumer warpgroups
constexpr int kBM = 128;           // output pixels of a tile (64 a consumer)
constexpr int kBK = 64;            // input channels of a chunk (one tap)
constexpr int kReduceThreads = 256;

// Byte offsets in the block's shared memory (base aligned to 1024): the
// stages (A: 128 pixel rows of 128 bytes; B: BN / 64 boxes of 64 k-rows x
// 128 bytes), the column sums of two items (8 warps x {sum, sumsq} x BN
// floats each), the mbarriers.
template <int BN>
struct ConvLayout {
  static_assert(BN == 64 || BN == 128 || BN == 256, "N tile 64, 128, 256");
  static constexpr int kABytes = kBM * kBoxBytes;
  static constexpr int kBBytes = BN / 64 * kBK * kBoxBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = BN == 256 ? 4 : BN == 128 ? 6 : 8;
  // chunks a producer thread keeps in flight beyond the one it arrives for
  // (at most kStages - 1, or the ring could wait on itself)
  static constexpr int kLag = kStages - 2;
  static constexpr int kRed = kStages * kStageBytes;
  static constexpr int kRedItem = 8 * 2 * BN;  // floats of one item
  static constexpr int kBars = kRed + 2 * kRedItem * 4;
  // full[kStages], empty[kStages]; + 1024 for aligning the base
  static constexpr size_t kSmem = kBars + 8 * 2 * kStages + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  // copies src_bytes (16 or 0) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc (+)= A B for one chunk, not committed: A this consumer's 64 pixel rows
// (K-major, k16 slices 32 bytes apart in the 128-byte row), B 64 k-rows x
// BN (MN-major: 16 k-rows are two 8-row swizzle atoms down the box; the
// leading byte offset steps from one 64-column box to the next).
template <int BN>
__device__ __forceinline__ void issue_chunk(float (&acc)[BN / 2], uint32_t a,
                                            uint32_t b, bool first) {
  constexpr uint32_t kBox = kBK * kBoxBytes;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = sw128_desc(a + kk * 32, 16);
    const uint64_t db = sw128_desc(b + kk * 16 * kBoxBytes, kBox);
    const int scale_d = !(first && kk == 0);
    if constexpr (BN == 256)
      wgmma_ss_n256_tb(acc, da, db, scale_d);
    else if constexpr (BN == 128)
      wgmma_ss_n128<0, BN / 2, 0, 1>(acc, da, db, scale_d);
    else
      wgmma_ss_n64<0, 1>(acc, da, db, scale_d);
  }
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    conv3x3_stats_kernel(const __grid_constant__ CUtensorMap tw,
                         const bf16* __restrict__ xp, bf16* __restrict__ y,
                         float* __restrict__ part_sum,
                         float* __restrict__ part_sq, int N, int H, int W,
                         int Cin, int Cout) {
  using L = ConvLayout<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char conv_smem[];
  const uint32_t raw = smem_u32(conv_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* red_base = reinterpret_cast<float*>(conv_smem + (base - raw) + L::kRed);
  auto stage_a = [&](int g) { return base + (g % kStages) * L::kStageBytes; };
  auto stage_b = [&](int g) { return stage_a(g) + L::kABytes; };
  auto full = [&](int g) { return base + L::kBars + 8 * (g % kStages); };
  auto empty = [&](int g) {
    return base + L::kBars + 8 * (kStages + g % kStages);
  };
  auto parity = [&](int g) { return (uint32_t)(g / kStages) & 1u; };

  const int M = N * H * W, HW = H * W, Wp = W + 2;
  const int n_tiles = Cout / BN, m_tiles = (M + kBM - 1) / kBM;
  const int n_items = m_tiles * n_tiles;
  const int cc_per_tap = (Cin + kBK - 1) / kBK;
  const int chunks = 9 * cc_per_tap;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 128 + 1);  // the producers' arrivals + the TMA's
      mbar_init(empty(st), 2);       // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: B by TMA (thread 0), A by cp.async (all 128) ----------
    const int p = threadIdx.x, piece = p & 7, pr = p >> 3;
    int g = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int m0 = (w / n_tiles) * kBM, n0 = (w % n_tiles) * BN;
      // this thread's 8 pixel rows pr + 16 i: element offset of their
      // (tap 0, channel 0) in x_padded, or -1 past M
      int at[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + pr + 16 * i;
        const int n = m / HW, hw = m - n * HW, h = hw / W, ww = hw - h * W;
        at[i] = m < M ? ((n * (H + 2) + h) * Wp + ww) * Cin : -1;
      }
      for (int kc = 0; kc < chunks; ++kc, ++g) {
        const int tap = kc / cc_per_tap, c0 = (kc - tap * cc_per_tap) * kBK;
        if (g >= kStages) mbar_wait(empty(g), parity(g) ^ 1u);
        if (p == 0) {
          mbar_expect_tx(full(g), L::kBBytes);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(stage_b(g) + c * kBK * kBoxBytes, &tw, full(g),
                        n0 + 64 * c, tap * Cin + c0);
        }
        const int ch = c0 + 8 * piece;
        const int off = ((tap / 3) * Wp + tap % 3) * Cin + ch;
        const uint32_t dst = stage_a(g) + pr * kBoxBytes + ((piece ^ (pr & 7)) << 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool in = at[i] >= 0 && ch < Cin;
          cp_async16(dst + 16 * i * kBoxBytes, in ? xp + at[i] + off : xp,
                     in ? 16u : 0u);
        }
        cp_async_commit();
        cp_async_wait<L::kLag>();
        if (g >= L::kLag) {  // chunk g - kLag has landed
          fence_async_shared();
          mbar_arrive(full(g - L::kLag));
        }
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    for (int d = g - L::kLag > 0 ? g - L::kLag : 0; d < g; ++d)
      mbar_arrive(full(d));
    return;
  }

  // ---- consumers -----------------------------------------------------------
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3, gl = lane >> 2;
  int g0 = 0;
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const int mt = w / n_tiles, m0 = mt * kBM, n0 = (w % n_tiles) * BN;
    float acc[BN / 2];
    fence_regs(acc);
    for (int kc = 0; kc < chunks; ++kc) {
      const int g = g0 + kc;
      mbar_wait(full(g), parity(g));
      wgmma_fence();
      issue_chunk<BN>(acc, stage_a(g) + cw * 64 * kBoxBytes, stage_b(g),
                      kc == 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done
      if (kc > 0 && tid == 0) mbar_arrive(empty(g - 1));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(empty(g0 + chunks - 1));
    g0 += chunks;

    // ---- epilogue: y in bf16 (rows < M), then the column sums -------------
    const int m_lo = m0 + 64 * cw + 16 * warp + gl;  // this thread's: +0, +8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m_lo + 8 * r;
      if (m >= M) continue;
      bf16* out = y + (size_t)m * Cout + n0 + 2 * t;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) =
            pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
    // red[warp of 8][sum, sumsq][BN], one buffer per item parity: an item's
    // buffer is rewritten two items later, after every consumer thread has
    // passed the next item's barrier, so after its readers are done
    float* red = red_base + (it & 1) * L::kRedItem + (4 * cw + warp) * 2 * BN;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = acc[4 * i + e], b = acc[4 * i + 2 + e];
        float s = a + b, q = a * a + b * b;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (gl == 0) {
          red[8 * i + 2 * t + e] = s;
          red[BN + 8 * i + 2 * t + e] = q;
        }
      }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // sums: columns ct < BN, sumsq: the next BN
    for (int ct = 128 * cw + tid; ct < 2 * BN; ct += 256) {
      const int which = ct >= BN, col = ct - which * BN;
      const float* rd = red_base + (it & 1) * L::kRedItem + which * BN + col;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += rd[k * 2 * BN];
      (which ? part_sq : part_sum)[(size_t)mt * Cout + n0 + col] = v;
    }
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

template <int BN>
cudaError_t launch_conv(const void* xp, const void* w, void* y,
                        void* part_sum, void* part_sq, int N, int H, int W,
                        int Cin, int Cout, long long items, int sms,
                        cudaStream_t stream) {
  using L = ConvLayout<BN>;
  static const cudaError_t prep = launch_prep(conv3x3_stats_kernel<BN>, L::kSmem);
  if (prep != cudaSuccess) return prep;
  CUtensorMap tw;
  const cudaError_t err = encode_2d(&tw, w, 9 * Cin, Cout, kBK);
  if (err != cudaSuccess) return err;
  conv3x3_stats_kernel<BN><<<(int)(items < sms ? items : sms), kConvThreads,
                             L::kSmem, stream>>>(
      tw, (const bf16*)xp, (bf16*)y, (float*)part_sum, (float*)part_sq, N, H,
      W, Cin, Cout);
  return cudaGetLastError();
}

// The N tile: the widest of 256, 128, 64 that divides Cout (the fewest
// re-reads of A through L2, which bounds the kernel before the waves do).
inline int conv_n_tile(int Cout) {
  return Cout % 256 == 0 ? 256 : Cout % 128 == 0 ? 128 : 64;
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
  if (N <= 0 || H <= 0 || W <= 0 || Cin % 32 || Cout % 64 || Cin <= 0 ||
      Cout <= 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = hvd_conv_bn_stats_tiles(N, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  const int bn = conv_n_tile(Cout);
  if (bn == 256)
    return launch_conv<256>(xp, w, y, part_sum, part_sq, N, H, W, Cin, Cout,
                            tiles * (Cout / 256), sms, s);
  if (bn == 128)
    return launch_conv<128>(xp, w, y, part_sum, part_sq, N, H, W, Cin, Cout,
                            tiles * (Cout / 128), sms, s);
  return launch_conv<64>(xp, w, y, part_sum, part_sq, N, H, W, Cin, Cout,
                         tiles * (Cout / 64), sms, s);
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
