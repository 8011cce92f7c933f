// The Hopper attention-forward mainloop shared by flash_fwd_kernel
// (flash_attention.cu) and probe_fwd_kernel (attention_probe.cu), and the
// sm_90a primitives (mbarriers, TMA, wgmma, the tensor-map encoder) that the
// backward mainloops of attention_bwd_sm90.cuh and the conv kernel of
// conv_bn_stats.cu build on too: TMA loads
// of K and V through a ring of shared-memory stages, wgmma for both products,
// an online softmax in registers. Built for sm_90a only (wgmma, setmaxnreg).
//
// What it computes, per (batch*head, query row i):
//   s_ij = sm_scale * log2(e) * q_i . k_j (base 2, for exp2),
//   masked to -inf where j >= Sk or, when causal, q_offset + i < k_offset + j;
//   o_i = sum_j p_ij v_j / l_i with p = exp2(s - m_i) over the running row
//   max m_i and row sum l_i (f32); lse_i = m_i ln 2 + ln l_i (natural log).
// A row whose keys are all masked shifts by 0 instead of -inf, so its p is
// 0, never NaN: it gets o = 0 and lse = -inf. p is rounded to bf16 only as
// the A operand of p.v; m, l and the accumulator stay f32.
//
// Block: three warpgroups, 384 threads, persistent: one block per SM takes
// work items of 128 query rows of one batch*head in turn (every
// gridDim.x-th item), so the copies of the next item run under the
// products and the epilogue of the current one.
//   * warpgroup 0 is the producer: it drops to 40 registers (setmaxnreg) and
//     one thread issues the TMA loads: each item's q tile into one of two q
//     buffers, then K and V tiles of kFwdKeys keys into a ring of kStages
//     stages. A stage's "full" mbarrier counts the bytes in (expect_tx); its
//     "empty" mbarrier takes one arrival from each consumer warpgroup when
//     it is done with the stage; the q buffers have a pair of their own.
//   * warpgroups 1 and 2 are consumers, 64 query rows each, with 232
//     registers: S = Q K^T by wgmma m64n128k16 from shared memory (Q and K
//     as they lie: K-major A and B), the masked online softmax on the f32
//     accumulator, then O += P V by wgmma with P from registers (the
//     accumulator fragment of S, packed two bf16 a register, is the A
//     fragment of the next product) and V from shared memory as an MN-major
//     B operand (the transpose flag: V is never transposed by hand).
// Tiles are 64 bf16 (128 bytes) wide, the widest box the 128-byte swizzle
// takes, so D 128 loads as two boxes side by side; the wgmma descriptors'
// 128-byte swizzle matches the one TMA writes. Each tensor map is 3-D,
// (D, S, batch*head) innermost first: a box that runs past S is zero-filled
// within its own head instead of reading the next head's rows. A zero key
// still scores 0, not -inf, so the mask j >= Sk stays.
//
// Causal items walk only the key tiles their rows can see (visible_keys),
// each consumer stops at its own last visible tile, and items are handed
// out with the longest ones (the last query blocks) first, so the blocks
// end together rather than on one long item alone.
//
// Within a consumer, the softmax of key tile j runs while the tensor cores
// still work on P V of tile j-1: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are
// issued together and the consumer waits for S_j only; O takes the rescale
// of tile j-1's softmax just before its P V is issued. Between consumers,
// named barriers make them issue their products in turns, so the tensor
// cores work for one while the other's softmax runs.
//
// ptxas serialises a wgmma pipeline it cannot prove safe, and says so
// under -v (chip_smoke.py fails on it). Two shapes of this loop drew it:
//   * C7511, "insufficient register resources": a packed layout whose
//     warpgroups could straddle Sk, with three P V paths and 64 O
//     accumulators a thread; every item now lies on one side of Sk;
//   * C7513, "non wgmma instructions defining input registers": one turn
//     loop that issued its products under per-turn conditions; tile 0,
//     tiles 1..n-1 and the last P V are now separate straight-line code.

// The packed layout (VD = 64 with D = 128, the B12 probe): q is
// (BH, 2 Sk, 128) and a row keeps lanes 0:64 of p.v below Sk and lanes
// 64:128 from Sk on. Half the items cover rows [0, Sk), the other half rows
// [Sk, 2 Sk), so every item reads one half of V (one 64-lane box, loaded
// alone) and computes only the lanes its rows keep.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder itself is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

constexpr int kFwdThreads = 384;  // producer + two consumer warpgroups
constexpr int kFwdRows = 128;     // query rows of a block (64 a consumer)
constexpr int kFwdKeys = 128;     // keys of a K/V tile
constexpr int kBoxBytes = 128;    // one swizzled row: 64 bf16

// Byte offsets in the block's shared memory (its base aligned to 1024, the
// 128-byte swizzle's atom of 8 rows). Each 64-column box of a tile is
// stored whole (rows x 128 bytes) before the next. D: the depth of q and k;
// VD: the lanes of v a block reads (D, or 64 in the packed layout).
template <int D, int VD>
struct FwdLayout {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(VD == D || (D == 128 && VD == 64), "packed: D 128, VD 64");
  static constexpr int kStages = D + VD <= 128 ? 4 : D + VD <= 192 ? 3 : 2;
  static constexpr int kQBytes = D / 64 * kFwdRows * kBoxBytes;
  static constexpr int kKBytes = D / 64 * kFwdKeys * kBoxBytes;
  static constexpr int kVBytes = VD / 64 * kFwdKeys * kBoxBytes;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // two q buffers, then the stages
  static constexpr int kBars = 2 * kQBytes + kStages * kStageBytes;
  // full[kStages], empty[kStages], q_full[2], q_empty[2]; + 1024 for
  // aligning the base
  static constexpr size_t kSmem = kBars + 8 * (2 * kStages + 4) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// --- TMA ----------------------------------------------------------------------

// One box of a 3-D map at (c0, c1, c2) into shared memory; the bytes count
// against the mbarrier's expected transactions.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D map at (c0, c1).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading byte offset (K-major: unused, 16; MN-major: the distance between
// 64-column boxes) and stride byte offset (1024: the next 8 rows), all in
// 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The two consumer warpgroups (cw 0 and 1) issue their wgmmas in turns:
// named barrier 1 + cw opens cw's turn; each turn ends by opening the
// other's (bar.sync counts the 128 threads waiting and the 128 arriving).
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
}

// Keep the compiler from moving other accesses of these registers into a
// wgmma's asynchronous window (which would serialise the wgmma pipeline).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Accumulator fragment of m64nNk16 (f32), warp w of the warpgroup, lane
// (g = lane / 4, t = lane % 4): d[4i + e] is row 16w + g + 8 (e / 2),
// column 8i + 2t + e % 2. The register A fragment of m64n*k16 (bf16) has the
// same rows: a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..),
// a[3] (g+8, 2t+8..), so two neighbouring 8-column accumulator groups
// packed to bf16 are one k16 slice of A.

// d[OFF .. OFF+64) (+)= A(64x16, shared) * B(16x128, shared); TA, TB: A, B
// MN-major (the transpose flags) instead of K-major
template <int OFF, int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[N], uint64_t da,
                                            uint64_t db, int scale_d) {
  static_assert(OFF + 64 <= N, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[0 .. 32) (+)= A(64x16, shared) * B(16x64, shared), both K-major (the
// backward's score tiles, attention_bwd_sm90.cuh) unless TA, TB make them
// MN-major (the fused backward's dS K, the conv's B)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[0 .. 16) (+)= A(64x16, shared) * B(16x32, shared), both K-major (the
// fused backward's half score tiles at D 128)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0 .. 128) (+)= A(64x16, shared, K-major) * B(16x256, shared, MN-major)
// (the conv's N tile of 256)
__device__ __forceinline__ void wgmma_ss_n256_tb(float (&d)[128], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[OFF .. OFF+32) += A(64x16, registers) * B(16x64, shared, MN-major)
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[N], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(OFF + 32 <= N, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[OFF .. OFF+64) += A(64x16, registers) * B(16x128, shared, MN-major)
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// --- the mainloop ---------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue S = Q K^T for this consumer's 64 rows and one K tile (not waited
// for): k16 slices of the 64-column boxes, 32 bytes apart within a box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kFwdKeys / 2], uint32_t sQw,
                                         uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kFwdKeys * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128<0>(s, sw128_desc(sQw + (kk / 4) * kFwdRows * kBoxBytes +
                                       (kk % 4) * 32, 16),
                     sw128_desc(sK + off, 16), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V for one V tile (not waited for): P (64 x kFwdKeys) from
// registers, V (kFwdKeys x VD) from shared memory, MN-major: 16 keys are two
// 8-row swizzle atoms down the tile; the leading byte offset steps from one
// 64-column box to the next.
template <int VD>
__device__ __forceinline__ void issue_pv(float (&acc)[VD / 2],
                                         uint32_t (&pa)[kFwdKeys / 16][4],
                                         uint32_t sV) {
  constexpr uint32_t kBox = kFwdKeys * kBoxBytes;
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
    const uint64_t desc = sw128_desc(sV + kk * 16 * kBoxBytes, kBox);
    if constexpr (VD == 64)
      wgmma_rs_n64<0>(acc, pa[kk], desc);
    else
      wgmma_rs_n128<0>(acc, pa[kk], desc);
  }
  wgmma_commit();
}

// The online softmax of one score tile, in place (s becomes p): scale to
// base 2, mask (only a tile that crosses Sk or the diagonal), fold into the
// running row max m and this thread's share of the row sum l. alpha is the
// factor the accumulator must be rescaled by before this tile's P V.
__device__ __forceinline__ void softmax_tile(
    float (&s)[kFwdKeys / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool edge, int k0, int row_lo, int Sk, int causal, int q_offset,
    int k_offset, float c, int t) {
  if (edge) {
    // row r keeps columns col < min(Sk, q_offset + row - k_offset + 1)
    // (the second only when causal); as an offset from this thread's first
    // column, k0 + 2t, one compare an element
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      long long keep = Sk;
      if (causal) {
        const long long diag =
            (long long)q_offset + row_lo + 8 * r - k_offset + 1;
        keep = diag < keep ? diag : keep;
      }
      const long long rel = keep - k0 - 2 * t;
      const int lim = rel < 0 ? 0 : rel > kFwdKeys ? kFwdKeys : (int)rel;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[4 * i + 2 * r + e] =
              8 * i + e < lim ? s[4 * i + 2 * r + e] * c : -INFINITY;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kFwdKeys / 2; ++i) s[i] *= c;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kFwdKeys / 8; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    // a row with every key masked so far shifts by 0, so p is 0, not NaN
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = ex2(s[4 * i + e] - m_safe);
        s[4 * i + e] = p;
        sum += p;
      }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// p to bf16 as the A fragment of P V: accumulator groups 2kk and 2kk+1 are
// A's k16 slice kk.
__device__ __forceinline__ void pack_p(const float (&p)[kFwdKeys / 2],
                                       uint32_t (&pa)[kFwdKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    acc[4 * i + 0] *= alpha[0];
    acc[4 * i + 1] *= alpha[0];
    acc[4 * i + 2] *= alpha[1];
    acc[4 * i + 3] *= alpha[1];
  }
}

// One work item: 128 query rows [q0, q_end) of one batch*head, the first
// lane of v its rows read, and the key tiles they see. Items are numbered
// with batch*head fastest and the query blocks slowest, in descending order
// when causal (the blocks with the most keys first); in the packed layout
// the first half of the query blocks covers rows [0, Sk) and reads lanes
// 0:64 of v, the second half rows [Sk, 2 Sk) and lanes 64:128.
struct FwdItem {
  int bh, q0, q_end, v_lane, n_tiles;
};

template <bool kPack>
__device__ __forceinline__ int fwd_slots(int Sq, int Sk) {
  return kPack ? 2 * ((Sk + kFwdRows - 1) / kFwdRows)
               : (Sq + kFwdRows - 1) / kFwdRows;
}

template <bool kPack>
__device__ __forceinline__ FwdItem fwd_item(int w, int BH, int Sq, int Sk,
                                            int causal, int q_offset,
                                            int k_offset) {
  FwdItem x;
  const int slot = w / BH, slots = fwd_slots<kPack>(Sq, Sk);
  x.bh = w - slot * BH;
  if constexpr (kPack) {
    const int half = slot >= slots / 2;
    x.q0 = half * Sk + (slot - half * (slots / 2)) * kFwdRows;
    x.q_end = min(x.q0 + kFwdRows, (half + 1) * Sk);
    x.v_lane = 64 * half;
  } else {
    x.q0 = (causal ? slots - 1 - slot : slot) * kFwdRows;
    x.q_end = min(x.q0 + kFwdRows, Sq);
    x.v_lane = 0;
  }
  x.n_tiles =
      (visible_keys(Sk, causal, q_offset, k_offset, x.q_end) + kFwdKeys - 1) /
      kFwdKeys;
  return x;
}

// The forward: a persistent block takes work items blockIdx.x,
// blockIdx.x + gridDim.x, ... q (BH, Sq, D), k (BH, Sk, D) and v (BH, Sk, *)
// come in as tensor maps; o is (BH, Sq, VD) bf16 and lse (BH, Sq) f32
// (written when kLse). VD == D, or 64 for the packed layout (D 128). The
// producer runs ahead across items: the next item's q (two q buffers) and
// first K/V tiles load while the consumers finish the current one.
template <int D, int VD, bool kLse>
__device__ __forceinline__ void attention_fwd_sm90(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    bf16* __restrict__ o, float* __restrict__ lse, int BH, int Sq, int Sk,
    float sm_scale, int causal, int q_offset, int k_offset) {
  using L = FwdLayout<D, VD>;
  constexpr bool kPack = VD != D;
  constexpr int kStages = L::kStages;

  extern __shared__ unsigned char fwd_smem[];
  const uint32_t base = (smem_u32(fwd_smem) + 1023u) & ~1023u;
  const uint32_t sKV = base + 2 * L::kQBytes, bars = base + L::kBars;
  // K/V tile g (counted over the block's items) sits in stage g % kStages
  auto full = [&](int g) { return bars + 8 * (g % kStages); };
  auto empty = [&](int g) { return bars + 8 * (kStages + g % kStages); };
  auto tile_k = [&](int g) { return sKV + (g % kStages) * L::kStageBytes; };
  auto tile_v = [&](int g) { return tile_k(g) + L::kKBytes; };
  auto parity = [&](int g) { return (uint32_t)(g / kStages) & 1u; };
  // item it's q sits in buffer it % 2
  auto q_tile = [&](int it) { return base + (it & 1) * L::kQBytes; };
  auto q_full = [&](int it) { return bars + 8 * (2 * kStages + (it & 1)); };
  auto q_empty = [&](int it) { return bars + 8 * (2 * kStages + 2 + (it & 1)); };
  const int n_items = BH * fwd_slots<kPack>(Sq, Sk);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    constexpr uint32_t kBox = kFwdKeys * kBoxBytes;
    int g = 0;
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const FwdItem x =
          fwd_item<kPack>(w, BH, Sq, Sk, causal, q_offset, k_offset);
      if (it >= 2) mbar_wait(q_empty(it), ((it >> 1) - 1) & 1);
      mbar_expect_tx(q_full(it), L::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(q_tile(it) + c * kFwdRows * kBoxBytes, &tq, q_full(it),
                    64 * c, x.q0, x.bh);
      for (int j = 0; j < x.n_tiles; ++j, ++g) {
        if (g >= kStages) mbar_wait(empty(g), parity(g) ^ 1u);
        mbar_expect_tx(full(g), L::kStageBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(tile_k(g) + c * kBox, &tk, full(g), 64 * c,
                      j * kFwdKeys, x.bh);
#pragma unroll
        for (int c = 0; c < VD / 64; ++c)
          tma_load_3d(tile_v(g) + c * kBox, &tv, full(g), x.v_lane + 64 * c,
                      j * kFwdKeys, x.bh);
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x - 128 * wg;
  if (wg == 2) turn_pass(1);  // consumer 0 takes the first turn
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const float c = sm_scale * kLog2e;
  int g0 = 0;  // the item's first K/V tile in the block's count
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const FwdItem x =
        fwd_item<kPack>(w, BH, Sq, Sk, causal, q_offset, k_offset);
    const int row0 = x.q0 + 64 * (wg - 1);            // this warpgroup's rows
    const int row_lo = row0 + 16 * warp + (lane >> 2);  // this thread's: +0, +8
    const int rows_end = min(row0 + 64, x.q_end);
    // the key tiles this warpgroup computes: a prefix of the item's
    const int n_mine =
        row0 < x.q_end
            ? (visible_keys(Sk, causal, q_offset, k_offset, rows_end) +
               kFwdKeys - 1) / kFwdKeys
            : 0;
    const uint32_t sQw = q_tile(it) + (wg - 1) * 64 * kBoxBytes;
    // a tile needs the mask if it crosses Sk or, causal, the diagonal of
    // this warpgroup's first row
    auto edge = [&](int k0) {
      return k0 + kFwdKeys > Sk ||
             (causal && q_offset + row0 < k_offset + k0 + kFwdKeys - 1);
    };

    float acc[VD / 2];
#pragma unroll
    for (int i = 0; i < VD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share; the quad's sum at the end
    float alpha[2];           // the rescale acc owes before the next P V
    uint32_t pa[kFwdKeys / 16][4];  // P of the tile whose P V is next

    mbar_wait(q_full(it), (it >> 1) & 1);
    if (n_mine > 0) {  // tile 0: S, then its softmax
      float s[kFwdKeys / 2];
      mbar_wait(full(g0), parity(g0));
      turn_wait(wg - 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk<D>(s, sQw, tile_k(g0));
      turn_pass(wg - 1);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, edge(0), 0, row_lo, Sk, causal, q_offset,
                   k_offset, c, t);
      pack_p(s, pa);
    }
    // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight together;
    // the softmax of S_j runs while P V still does. Registers that a wgmma
    // in flight reads (acc, pa) are written only before its issue or after
    // its wait, so ptxas keeps the wgmma pipeline.
    for (int j = 1; j < n_mine; ++j) {
      float s[kFwdKeys / 2];
      const int g = g0 + j;
      mbar_wait(full(g), parity(g));
      turn_wait(wg - 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk<D>(s, sQw, tile_k(g));
      rescale(acc, alpha);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<VD>(acc, pa, tile_v(g - 1));
      turn_pass(wg - 1);
      wgmma_wait<1>();  // S_j is done (groups complete in order)
      fence_regs(s);
      softmax_tile(s, m, l, alpha, edge(j * kFwdKeys), j * kFwdKeys, row_lo,
                   Sk, causal, q_offset, k_offset, c, t);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (tid == 0) mbar_arrive(empty(g - 1));  // done with tile j-1
      pack_p(s, pa);
    }
    if (tid == 0) mbar_arrive(q_empty(it));  // every q k^T of the item is done
    if (n_mine > 0) {  // the last tile's P V
      rescale(acc, alpha);
      fence_regs(acc);
      fence_regs(pa);
      turn_wait(wg - 1);
      wgmma_fence();
      issue_pv<VD>(acc, pa, tile_v(g0 + n_mine - 1));
      turn_pass(wg - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty(g0 + n_mine - 1));
    }
    // the item's later tiles, which no row of this warpgroup sees: release
    // each once it has landed, so the ring's phases stay in step
    // (a turn each, so both warpgroups take n_tiles + 1 turns an item)
    for (int j = n_mine; j < x.n_tiles; ++j) {
      mbar_wait(full(g0 + j), parity(g0 + j));
      if (tid == 0) mbar_arrive(empty(g0 + j));
      turn_wait(wg - 1);
      turn_pass(wg - 1);
    }
    if (n_mine == 0) {
      turn_wait(wg - 1);
      turn_pass(wg - 1);
    }
    g0 += x.n_tiles;

    // ---- epilogue: o = acc / l in bf16, lse in f32, rows < q_end only ----
    const size_t bh_rows = (size_t)x.bh * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row_lo + 8 * r;
      if (row >= x.q_end) continue;
      const float inv = lt == 0.f ? 0.f : 1.f / lt;
      bf16* out = o + (bh_rows + row) * VD + 2 * t;
#pragma unroll
      for (int i = 0; i < VD / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) =
            pack_bf16(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      if (kLse && t == 0)
        lse[bh_rows + row] = lt == 0.f ? -INFINITY : m[r] * kLn2 + logf(lt);
    }
  }
  if (wg == 1) turn_wait(0);  // the last turn_pass(1): no arrival left over
}

// --- host side --------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous (BH, S, D) bf16 tensor: dimensions (D, S, BH)
// innermost first, boxes of 64 columns x `rows` rows x 1 head, the 128-byte
// swizzle; rows past S read as zeros.
inline cudaError_t encode_bhsd(CUtensorMap* map, const void* base, int BH,
                               int S, int D, int rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16),
                                 (cuuint64_t)S * D * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over a contiguous (rows, cols) bf16 matrix: dimensions (cols,
// rows) innermost first, boxes of 64 columns x `box_rows` rows, the 128-byte
// swizzle; a box past the last row reads as zeros.
inline cudaError_t encode_2d(CUtensorMap* map, const void* base, int rows,
                             int cols, int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Encode the three maps and launch `kernel` (a __global__ wrapper of
// attention_fwd_sm90<D, VD, *> with the signature below): one persistent
// block per SM, or per work item when there are fewer. The caller has set
// the kernel's shared-memory attribute (launch_prep).
template <int D, int VD, typename Kernel>
cudaError_t launch_attention_fwd(Kernel kernel, const void* q, const void* k,
                                 const void* v, void* o, void* lse, int BH,
                                 int Sq, int Sk, float sm_scale, int causal,
                                 int q_offset, int k_offset,
                                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bhsd(&tq, q, BH, Sq, D, kFwdRows);
  if (err == cudaSuccess) err = encode_bhsd(&tk, k, BH, Sk, D, kFwdKeys);
  if (err == cudaSuccess) err = encode_bhsd(&tv, v, BH, Sk, D, kFwdKeys);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)BH * (VD == D ? (Sq + kFwdRows - 1) / kFwdRows
                               : 2 * ((Sk + kFwdRows - 1) / kFwdRows));
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(int)(items < sms ? items : sms), kFwdThreads,
           FwdLayout<D, VD>::kSmem, stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, BH, Sq, Sk, sm_scale, causal,
      q_offset, k_offset);
  return cudaGetLastError();
}

}  // namespace
