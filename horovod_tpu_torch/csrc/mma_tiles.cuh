// Warp-level bf16 tile helpers of the attention backward kernels
// (flash_attention.cu): the mma.sync m16n8k16 product, its fragment loads
// from padded shared tiles, and the tile loads from global memory. A block
// has kWarps warps; each warp owns 16 rows of the block's own side (one m16
// tile), so a block covers kRows rows. The constants, pack_bf16,
// visible_keys and launch_prep are shared with the forward mainloop
// (attention_fwd_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;
// bf16 elements of padding per shared-memory row (16 bytes), so the 32-bit
// fragment loads of a warp hit 32 distinct banks.
constexpr int kPad = 8;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8):  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)

// A fragment at (row0, col0) of a row-major shared tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int stride,
                                       int row0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (row0 + g) * stride + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment from a shared tile that holds B transposed, row-major: row n of
// the tile is column n of B, and k runs along the row.
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* s, int stride,
                                       int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * stride + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// Two neighbouring 16x8 accumulator tiles, rounded to bf16, are the A
// fragment of a 16x16 operand (k columns 16kk..16kk+15 from tiles 2kk, 2kk+1).
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [row0, row0 + rows) of an (S, D) bf16 matrix into a row-major shared
// tile; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, int stride, const bf16* g,
                                          int row0, int rows, int S) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(s + r * stride + c) = v;
  }
}

// The same rows stored transposed: element (r, c) goes to s[c * stride + r].
template <int D>
__device__ __forceinline__ void load_tile_t(bf16* s, int stride, const bf16* g,
                                            int row0, int rows, int S) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[(c + j) * stride + r] = e[j];
  }
}

// Number of keys [0, n) that some query of rows [q_lo, q_hi) may see under
// the causal mask (all of them when not causal).
__device__ __forceinline__ int visible_keys(int Sk, int causal, int q_offset,
                                            int k_offset, int q_hi) {
  if (!causal) return Sk;
  const long long lim = (long long)q_offset + q_hi - 1 - k_offset;  // last j
  if (lim < 0) return 0;
  return lim + 1 < Sk ? (int)(lim + 1) : Sk;
}

// First query row that sees key row k0 under the causal mask (0 when not
// causal; Sq when none does): query blocks wholly before it see none of the
// keys from k0 on.
__device__ __forceinline__ int first_query(int Sq, int causal, int q_offset,
                                           int k_offset, int k0) {
  if (!causal) return 0;
  const long long first = (long long)k_offset + k0 - q_offset;
  return first <= 0 ? 0 : (first >= Sq ? Sq : (int)first);
}

// Dynamic shared memory above 48 KB needs the attribute set once per kernel
// instance; a launch that is refused shows in cudaGetLastError().
template <typename Kernel>
cudaError_t launch_prep(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
