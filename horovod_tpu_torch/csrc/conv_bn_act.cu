// The folded batch-norm apply and ReLU of a conv layer, y = relu(x*s[c] +
// b[c]), for Hopper (sm_90a), behind a plain C interface (loaded with ctypes
// by horovod_tpu_torch/ops/conv_bn_act.py).
//
// Replaces the Pallas TPU kernel _sba_kernel of
// horovod_tpu/ops/pallas/conv_bn_act.py (:64, launched by _sba_pallas :75).
// The TPU views x as (rows, 128) lanes and gates shapes on its lane tiling
// (C % 128 == 0 or 128 % C == 0, at least 8 rows of 128, 16 K elements);
// s and b are broadcast to the same (rows, 128) layout before the call. Here
// x is taken as it lies: channels-last contiguous, so element i belongs to
// channel i % C, and s and b stay per-channel vectors of C floats. Every
// shape goes through the kernel; the ragged tail is masked in the launch.
//
// What it computes, exactly as the plain version does (ops/conv_bn_act.py
// sba_plain): y = x * s[c] in float32, rounded; + b[c], rounded (this file is
// built with -fmad=false, so the two are never fused into one fma); then
// max(y, 0) keeping NaN, stored in x's dtype (bf16 round-to-nearest-even, or
// float32). So the kernel and the plain version agree bit for bit.
//
// What bounds it on this card: bytes. Each element is read once and written
// once (2 or 4 bytes each way) for 2 float32 operations, far below the ~295
// operations per byte at which Hopper's bf16 rate would bind; plus 8*C bytes
// of s and b. Inception-V3's largest call, 32x147x147x64 bf16, moves 177 MB:
// 53 us at 3.35 TB/s.
// What the design does about it: one pass, 16-byte loads and stores (8 bf16
// or 4 float32 a thread) when C is a multiple of that width and every
// pointer is 16-byte aligned, s and b read as float4 from L1; a grid-stride
// loop over a grid capped at a few blocks per SM; the channel of the next
// vector is advanced by addition, with no division in the loop. Other
// shapes take the element-by-element loop of the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// relu(x*s + b): a NaN stays NaN, as torch.clamp_min keeps it.
__device__ __forceinline__ float sba(float x, float s, float b) {
  const float y = x * s + b;
  return y < 0.f ? 0.f : y;
}

// V elements a step: V = 16 / sizeof(T) reads and writes 16 bytes (C % V ==
// 0 and aligned pointers, checked by the caller); V = 1 is the plain loop.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    sba_kernel(const T* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ b, T* __restrict__ y, int64_t n,
               int C) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t steps = n / V;
  // the channel of this thread's first element, and how far it moves each
  // step of the loop: (stride * V) mod C < C, so one subtraction wraps it
  int c = (int)((first * V) % C);
  const int dc = (int)((stride * V) % C);
  for (int64_t i = first; i < steps; i += stride) {
    if constexpr (V == 1) {
      y[i] = from_f32<T>(sba(to_f32(x[i]), s[c], b[c]));
    } else {
      uint4 in = reinterpret_cast<const uint4*>(x)[i];
      const T* xv = reinterpret_cast<const T*>(&in);
      float sv[V], bv[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(sv + j) =
            *reinterpret_cast<const float4*>(s + c + j);
        *reinterpret_cast<float4*>(bv + j) =
            *reinterpret_cast<const float4*>(b + c + j);
      }
      uint4 out;
      T* yv = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        yv[j] = from_f32<T>(sba(to_f32(xv[j]), sv[j], bv[j]));
      reinterpret_cast<uint4*>(y)[i] = out;
    }
    c += dc;
    if (c >= C) c -= C;
  }
  // the tail of a vectorised launch: fewer than V elements
  if constexpr (V > 1) {
    const int64_t e = steps * V + first;
    if (e < n) {
      const int ce = (int)(e % C);
      y[e] = from_f32<T>(sba(to_f32(x[e]), s[ce], b[ce]));
    }
  }
}

int grid_limit() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  return sms * kBlocksPerSm;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* x, const void* s, const void* b, void* y, int64_t n,
           int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(s) && aligned16(b);
  const int64_t steps = vec ? n / V : n;
  int64_t blocks = (steps + kThreads - 1) / kThreads;
  const int64_t limit = grid_limit();
  if (blocks > limit) blocks = limit;
  if (blocks < 1) blocks = 1;  // under V elements: only the tail
  if (vec)
    sba_kernel<T, V><<<(int)blocks, kThreads, 0, stream>>>(
        (const T*)x, (const float*)s, (const float*)b, (T*)y, n, C);
  else
    sba_kernel<T, 1><<<(int)blocks, kThreads, 0, stream>>>(
        (const T*)x, (const float*)s, (const float*)b, (T*)y, n, C);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface. Returns a cudaError_t (0 on success). Dtype codes: 0
// float32, 1 bfloat16. x and y hold n elements, channels-last contiguous
// with C channels; s and b hold C float32 values.
extern "C" {

int hvd_sba(const void* x, const void* s, const void* b, void* y,
            long long n, int C, int dtype, void* stream) {
  if (n <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, s, b, y, n, C, st);
  if (dtype == 1) return launch<bf16>(x, s, b, y, n, C, st);
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
