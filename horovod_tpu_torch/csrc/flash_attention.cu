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
// The fused backward, flash_bwd_fused_kernel, computes s and p once for all
// three gradients, as the TPU kernel does, on the dk/dv mainloop
// (attention_bwd_sm90.cuh, attention_bwd_fused_sm90): items of 128 keys of
// one batch*head on persistent blocks, dK and dV in the consumers'
// registers, and a fifth product per query tile, dq = dS K, with dS^T
// written to shared memory (bf16, swizzled) as an MN-major A operand. dq
// is summed across the key items in a float32 scratch, dq_acc, in a fixed
// order (key slot 0, 1, ...) with no atomics on the data: a turn counter
// per (batch*head, query tile, column half) tells an item when to read, add
// and write the tile, and the last slot writes bf16 dq. What bounds it:
// five products over the unmasked pairs, 64.5 GFLOP at GPT-2's shape (B16
// H12 S1024 D64, causal), 65.2 us at 989 TFLOP/s, against 177.7 MB of q,
// k, v, do, dq, dk, dv, lse and delta (53.0 us at 3.35 TB/s): operations;
// at (a) 21.5 GFLOP, 21.7 us, against 59.2 MB (17.7 us). The bound counts
// no scratch:
// the ordered sum reads and writes each dq tile once per key item that
// sees it, in L2 mostly. The design saves dq + dk/dv's second computation
// of S and dP (five products where they take seven) and pays that sum.

#include "attention_bwd_sm90.cuh"

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
// Fused backward (B7): dq, dk and dv in one pass, on the dk/dv mainloop with
// dq summed across items in key-slot order (attention_bwd_fused_sm90).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFusedThreads, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ dq_acc, int* __restrict__ turns,
                       int BH, int Sq, int Sk, float sm_scale, int causal,
                       int q_offset, int k_offset) {
  attention_bwd_fused_sm90<D>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, dq_acc,
                              turns, BH, Sq, Sk, sm_scale, causal, q_offset,
                              k_offset);
}

// ---------------------------------------------------------------------------
// Launchers (launch_prep: attention_fwd_sm90.cuh)
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

// The fused backward's turn counters: a column half each of every
// (batch*head, query tile of 64).
inline long long fused_turns(int BH, int Sq) {
  return 2LL * BH * ((Sq + kBwdTile - 1) / kBwdTile);
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

// The fused launcher zeroes the turn counters (2 per batch*head and query
// tile of 64) on the stream before the kernel; dq_acc needs no zeroing
// (the first slot to reach a tile stores).
template <int D>
int launch_bwd_fused(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, void* dq_acc, void* turns,
                     int BH, int Sq, int Sk, float sm_scale, int causal,
                     int q_offset, int k_offset, cudaStream_t stream) {
  using L = BwdLayout<D, true>;
  static const cudaError_t prep =
      launch_prep(flash_bwd_fused_kernel<D>, L::kSmem);
  if (prep != cudaSuccess) return prep;
  CUtensorMap m[4];
  int grid = 0;
  cudaError_t err =
      bwd_setup(m, q, k, v, dout, BH, Sq, Sk, D,
                (long long)BH * ((Sk + kBwdItem - 1) / kBwdItem), &grid);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(turns, 0, fused_turns(BH, Sq) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  flash_bwd_fused_kernel<D><<<grid, kFusedThreads, L::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
      (bf16*)dq, (bf16*)dk, (bf16*)dv, (float*)dq_acc, (int*)turns, BH, Sq,
      Sk, sm_scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

}  // namespace

// The C interface. Each returns a cudaError_t (0 on success).
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

// Fused backward: dq_acc is float32 (BH, Sq, D), turns int32 of
// hvd_flash_bwd_fused_turns(BH, Sq); both scratch of the call.
int hvd_flash_bwd_fused(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, void* dq_acc,
                        void* turns, int BH, int Sq, int Sk, int D,
                        float sm_scale, int causal, int q_offset,
                        int k_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_bwd_fused<64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                                turns, BH, Sq, Sk, sm_scale, causal, q_offset,
                                k_offset, s);
  if (D == 128)
    return launch_bwd_fused<128>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 dq_acc, turns, BH, Sq, Sk, sm_scale, causal,
                                 q_offset, k_offset, s);
  return cudaErrorInvalidValue;
}

long long hvd_flash_bwd_fused_turns(int BH, int Sq) {
  return fused_turns(BH, Sq);
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
