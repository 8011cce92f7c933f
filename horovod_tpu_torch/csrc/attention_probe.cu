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
// key of the head, o = softmax(sm_scale q k^T) v; B13 also writes lse =
// m ln 2 + ln l, (B, H, S) float32 in natural log, as the port's flash
// forward returns it. B12 takes two heads packed by the caller into one
// 128-deep contraction: q2 (b, h/2, 2S, 128) holds head A's q in lanes 0:64
// of rows 0:S and head B's in lanes 64:128 of rows S:2S (zeros elsewhere),
// k2 and v2 (b, h/2, S, 128) hold both heads' k and v side by side, so
// q2 k2^T is each head's own scores; o2 (b, h/2, 2S, 64) keeps lanes 0:64
// of p v2 for rows below S and lanes 64:128 from S on.
//
// Design: all three run the flash forward's Hopper mainloop
// (attention_fwd_sm90.cuh: TMA ring of K/V tiles, wgmma for both products,
// online softmax), non-causal with Sq = Sk, lse on or off at compile time.
// The TPU kernels use a direct softmax (the row max and sum over every key
// first, then p v) because the TPU holds a head's whole K and V in VMEM, so
// the second look at the keys is free there. Here it is not: K and V of a
// packed head (512 x 128 bf16) are 256 KB, more than shared memory, and the
// two-pass version streamed K twice and paid a third product. The online
// softmax gives the same function (softmax is invariant to the shift, and
// the rescaled sums are the same sums up to f32 rounding), so the probe
// keeps the TPU function and drops the TPU's schedule. B12 keeps the
// 128-deep q2 k2^T contraction over all 128 lanes, as its function is
// defined, zero half included; in p v2 it computes only the 64 lanes a row
// keeps (half the grid's blocks cover rows below S and read lanes 0:64 of
// v2, the other half rows from S on and lanes 64:128), so it executes 1.5x
// the useful MACs where the two-pass version executed 2x.
//
// Precision: bf16 operands, f32 accumulation; m, l and lse in f32 from the
// f32 scores; p is rounded to bf16 for the p v product.
// What bounds them: at BERT-Large's shape (B8 H16 S512 D64) 8.6 GFLOP of
// useful work (8.7 us at 989 TFLOP/s) against 33.6 MB of q, k, v and o
// (10.0 us at 3.35 TB/s; B12 moves 42 MB with the packed q2): bytes. The
// mainloop reads each of them from HBM about once per 128-row query block
// and keeps the scores in registers.

#include "attention_fwd_sm90.cuh"

namespace {

// o (BH, Sq, OUT_D); OUT_D < D is the packed layout (attention_fwd_sm90.cuh).
template <int D, int OUT_D, bool kLse>
__global__ void __launch_bounds__(kFwdThreads, 1)
probe_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int BH, int Sq, int Sk,
                 float sm_scale, int causal, int q_offset, int k_offset) {
  attention_fwd_sm90<D, OUT_D, kLse>(tq, tk, tv, o, lse, BH, Sq, Sk, sm_scale,
                                     causal, q_offset, k_offset);
}

template <int D, int OUT_D, bool kLse>
int launch_probe(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Sq, int Sk, float sm_scale,
                 cudaStream_t stream) {
  static const cudaError_t prep = launch_prep(
      probe_fwd_kernel<D, OUT_D, kLse>, FwdLayout<D, OUT_D>::kSmem);
  if (prep != cudaSuccess) return prep;
  return launch_attention_fwd<D, OUT_D>(
      probe_fwd_kernel<D, OUT_D, kLse>, q, k, v, o, lse, BH, Sq, Sk, sm_scale,
      /*causal=*/0, /*q_offset=*/0, /*k_offset=*/0, stream);
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
