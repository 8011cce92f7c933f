// AdamW for Hopper (sm_90a): a multi-tensor kernel over every parameter
// leaf and a flat kernel over a ZeRO-1 master/moment shard, behind a plain
// C interface (loaded with ctypes by horovod_tpu_torch/ops/fused_adamw.py
// and horovod_tpu_torch/ops/fused_optimizer.py).
//
// Replaces the Pallas TPU kernels:
//   adamw_multi_kernel <- horovod_tpu/ops/pallas/fused_adamw.py:64
//                         _adamw_kernel (one pallas_call per leaf, :114)
//   flat_adamw_kernel  <- horovod_tpu/ops/pallas/fused_optimizer.py:53
//                         _flat_adamw_kernel (one pallas_call per shard, :111)
//
// What both compute, per element, in float32, in this order (optax.adamw:
// bias-corrected moments, decoupled weight decay folded into the lr step):
//   m = b1*m + (1-b1)*g
//   v = b2*v + (1-b2)*g*g
//   p = p - lr*((m*ibc1)/(sqrt(v*ibc2)+eps) + wd*p)
// with ibc1 = 1/(1-b1^t), ibc2 = 1/(1-b2^t) computed on the host in
// float32 and passed by value (the TPU kernels read them from SMEM).
// This file is built with -fmad=false (ops/kernel_build.py), keeping the
// IEEE division and square root, so no multiply and add are contracted
// into one rounding: the kernels give the same bits as the plain PyTorch
// versions beside their wrappers, which round after every operation.
//
// adamw_multi_kernel: p, m and v keep their own dtypes (float32 or
// bfloat16), g is read in its own and widened to float32. One launch
// covers every leaf of one (p, m, v, g) dtype combination: the wrapper
// builds a table of the leaves' pointers, sizes and first chunk on each
// call (gradient addresses change between steps), each leaf is cut into
// chunks of kChunk elements, and each block walks chunks in a grid-stride
// loop, finding its leaf by binary search over the chunk starts.
// flat_adamw_kernel: master, mu and nu are float32 and updated in place;
// the gradient shard is float32 or bfloat16; p_out, the new parameters in
// the parameter dtype, is written to a separate buffer for the allgather.
//
// What bounds them on this card: about 16 float32 operations per element
// against 28 bytes moved (multi, all f32: read p m v g, write p m v) or 32
// (flat: read master mu nu g, write p master mu nu), so about 0.5
// operations per byte against the H100's ~20 f32 (non-tensor) operations
// per byte of HBM: both are bound by bytes. BERT-Large (334,090,240
// parameters in 388 leaves): 9.35 GB, 2.79 ms at 3.35 TB/s for the multi
// kernel; its world-1 ZeRO shard (536,870,912 elements with the bucket
// pad): 17.18 GB, 5.13 ms for the flat kernel.
// What the design does about it: every byte is read and written once, in
// 16-byte vector accesses for float32 (8 bytes for four bfloat16), by a
// grid of at most 8 blocks of 256 threads per SM; the ragged tail of each
// leaf or shard is done element by element in the same launch. Nothing is
// allocated and no second pass is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int64_t kChunk = 16384;  // elements of a leaf per block step

struct Scalars {
  float b1, b2, ibc1, ibc2, lr, wd, eps;
};

__device__ __forceinline__ void adamw(float& p, float& m, float& v, float g,
                                      const Scalars& s) {
  m = s.b1 * m + (1.0f - s.b1) * g;
  v = s.b2 * v + (1.0f - s.b2) * g * g;
  p = p - s.lr * ((m * s.ibc1) / (sqrtf(v * s.ibc2) + s.eps) + s.wd * p);
}

// Four elements at a time: one 16-byte access for float32, 8 for bfloat16.
__device__ __forceinline__ void load4(const float* a, float out[4]) {
  float4 x = *reinterpret_cast<const float4*>(a);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load4(const bf16* a, float out[4]) {
  uint2 x = *reinterpret_cast<const uint2*>(a);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&x.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&x.y);
  float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
  out[0] = l.x; out[1] = l.y; out[2] = h.x; out[3] = h.y;
}

__device__ __forceinline__ void store4(float* a, const float in[4]) {
  *reinterpret_cast<float4*>(a) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store4(bf16* a, const float in[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(a) = x;
}

__device__ __forceinline__ float load1(const float* a) { return *a; }
__device__ __forceinline__ float load1(const bf16* a) {
  return __bfloat162float(*a);
}
__device__ __forceinline__ void store1(float* a, float x) { *a = x; }
__device__ __forceinline__ void store1(bf16* a, float x) {
  *a = __float2bfloat16_rn(x);
}

// Elements [begin, end) of one leaf, by the threads of one block. begin is
// a multiple of 4 and every pointer is 16-byte aligned (the wrapper checks).
template <typename P, typename M, typename V, typename G>
__device__ __forceinline__ void update_range(P* p, M* m, V* v, const G* g,
                                             int64_t begin, int64_t end,
                                             const Scalars& s) {
  const int64_t nvec = (end - begin) / 4;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int64_t e = begin + 4 * i;
    float pf[4], mf[4], vf[4], gf[4];
    load4(p + e, pf);
    load4(m + e, mf);
    load4(v + e, vf);
    load4(g + e, gf);
#pragma unroll
    for (int k = 0; k < 4; ++k) adamw(pf[k], mf[k], vf[k], gf[k], s);
    store4(p + e, pf);
    store4(m + e, mf);
    store4(v + e, vf);
  }
  for (int64_t e = begin + 4 * nvec + threadIdx.x; e < end; e += blockDim.x) {
    float pf = load1(p + e), mf = load1(m + e), vf = load1(v + e);
    adamw(pf, mf, vf, load1(g + e), s);
    store1(p + e, pf);
    store1(m + e, mf);
    store1(v + e, vf);
  }
}

// table (int64, device memory), n leaves: rows of n p, m, v, g pointers and
// n sizes, then n+1 chunk starts (a prefix sum of ceil(size / kChunk)).
template <typename P, typename M, typename V, typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_multi_kernel(const int64_t* __restrict__ table, int n,
                       int64_t n_chunks, Scalars s) {
  const int64_t* ptr_p = table;
  const int64_t* ptr_m = table + n;
  const int64_t* ptr_v = table + 2 * n;
  const int64_t* ptr_g = table + 3 * n;
  const int64_t* sizes = table + 4 * n;
  const int64_t* starts = table + 5 * n;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int lo = 0, hi = n - 1;  // the last leaf whose first chunk is <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (starts[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const int64_t begin = (c - starts[lo]) * kChunk;
    const int64_t end =
        begin + kChunk < sizes[lo] ? begin + kChunk : sizes[lo];
    update_range(reinterpret_cast<P*>(ptr_p[lo]),
                 reinterpret_cast<M*>(ptr_m[lo]),
                 reinterpret_cast<V*>(ptr_v[lo]),
                 reinterpret_cast<const G*>(ptr_g[lo]), begin, end, s);
  }
}

template <typename G, typename P>
__global__ void __launch_bounds__(kThreads)
    flat_adamw_kernel(float* __restrict__ master, float* __restrict__ mu,
                      float* __restrict__ nu, const G* __restrict__ grad,
                      P* __restrict__ p_out, int64_t n, Scalars s) {
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < nvec; i += stride) {
    const int64_t e = 4 * i;
    float wf[4], mf[4], vf[4], gf[4];
    load4(master + e, wf);
    load4(mu + e, mf);
    load4(nu + e, vf);
    load4(grad + e, gf);
#pragma unroll
    for (int k = 0; k < 4; ++k) adamw(wf[k], mf[k], vf[k], gf[k], s);
    store4(p_out + e, wf);
    store4(master + e, wf);
    store4(mu + e, mf);
    store4(nu + e, vf);
  }
  for (int64_t e = 4 * nvec + first; e < n; e += stride) {
    float wf = master[e], mf = mu[e], vf = nu[e];
    adamw(wf, mf, vf, load1(grad + e), s);
    store1(p_out + e, wf);
    master[e] = wf;
    mu[e] = mf;
    nu[e] = vf;
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

// Calls f with a value of the C++ type of dtype code 0 (float32) or 1
// (bfloat16); any other code is refused.
template <typename F>
int with_dtype(int code, F f) {
  if (code == 0) return f(float{});
  if (code == 1) return f(bf16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The C interface. Each returns a cudaError_t (0 on success). Dtype codes:
// 0 float32, 1 bfloat16.
extern "C" {

int hvd_adamw_chunk_elems() { return (int)kChunk; }

int hvd_adamw_multi(const void* table, int n, long long n_chunks, int p_dt,
                    int m_dt, int v_dt, int g_dt, float b1, float b2,
                    float ibc1, float ibc2, float lr, float wd, float eps,
                    void* stream) {
  if (n <= 0 || n_chunks <= 0) return cudaErrorInvalidValue;
  const Scalars s{b1, b2, ibc1, ibc2, lr, wd, eps};
  const long long limit = grid_limit();
  const int blocks = (int)(n_chunks < limit ? n_chunks : limit);
  return with_dtype(p_dt, [&](auto p) {
    return with_dtype(m_dt, [&](auto m) {
      return with_dtype(v_dt, [&](auto v) {
        return with_dtype(g_dt, [&](auto g) {
          adamw_multi_kernel<decltype(p), decltype(m), decltype(v),
                             decltype(g)>
              <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                  (const int64_t*)table, n, (int64_t)n_chunks, s);
          return (int)cudaGetLastError();
        });
      });
    });
  });
}

int hvd_flat_adamw(void* master, void* mu, void* nu, const void* grad,
                   void* p_out, long long n, int g_dt, int p_dt, float b1,
                   float b2, float ibc1, float ibc2, float lr, float wd,
                   float eps, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const Scalars s{b1, b2, ibc1, ibc2, lr, wd, eps};
  const long long limit = grid_limit();
  long long want = (n / 4 + kThreads - 1) / kThreads;
  if (want < 1) want = 1;  // a shard of under 4 elements: the tail loop
  const int blocks = (int)(want < limit ? want : limit);
  return with_dtype(g_dt, [&](auto g) {
    return with_dtype(p_dt, [&](auto p) {
      flat_adamw_kernel<decltype(g), decltype(p)>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
              (float*)master, (float*)mu, (float*)nu,
              (const decltype(g)*)grad, (decltype(p)*)p_out, (int64_t)n, s);
      return (int)cudaGetLastError();
    });
  });
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
