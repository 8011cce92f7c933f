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
// the gradient shard is float32 or bfloat16. For a bfloat16 group the new
// parameters are also written, rounded, to p_out for the allgather; for a
// float32 group they are master itself, so no p stream is written (the
// Pallas kernel writes p_out and mw_out as two arrays because JAX arrays
// are immutable: here that copy would be 4 of 32 bytes an element).
//
// What bounds them on this card: about 16 float32 operations per element
// against 28 bytes moved (multi, all f32: read p m v g, write p m v; flat,
// a float32 group: read master mu nu g, write master mu nu) or 30 (flat, a
// bfloat16 group: 2-byte g and p), so about 0.5 operations per byte
// against the H100's ~20 f32 (non-tensor) operations per byte of HBM: both
// are bound by bytes. BERT-Large (334,090,240 parameters in 388 leaves):
// 9.35 GB, 2.79 ms at 3.35 TB/s for the multi kernel; its world-1 ZeRO
// shard (536,870,912 elements with the bucket pad): 15.03 GB, 4.49 ms for
// the flat kernel.
// What the designs do about it: every byte is read and written once.
// adamw_multi_kernel reads and writes in 16-byte vector accesses for
// float32 (8 bytes for four bfloat16), by a grid of at most 8 blocks of
// 256 threads per SM, the ragged tail of each leaf element by element in
// the same launch. flat_adamw_kernel streams the shard through a ring of
// bulk copies into shared memory (see the note above it), so its loads
// cost its threads no registers or instructions and many bytes stay in
// flight. Nothing is allocated and no second pass is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int64_t kChunk = 16384;  // elements of a leaf per block step

struct Scalars {
  float b1, b2, ibc1, ibc2, lr, wd, eps;
};

// A zero under the square root or over the division is answered without
// the IEEE slow path that sqrtf(0) and 0 / d take, with the same bits
// (sqrt(+-0) + eps is eps; +-0 / d is +-0 for d > 0): a ZeRO shard ends in
// a bucket pad of zeros (37.8 % of BERT-Large's world-1 shard, half of most
// bucket groups), and flat_adamw_kernel's consumer warps, fewer than a
// grid-stride loop keeps on a SM, cannot hide those calls on a tile of pad.
__device__ __forceinline__ void adamw(float& p, float& m, float& v, float g,
                                      const Scalars& s) {
  m = s.b1 * m + (1.0f - s.b1) * g;
  v = s.b2 * v + (1.0f - s.b2) * g * g;
  const float vh = v * s.ibc2, num = m * s.ibc1;
  const float den = (vh == 0.0f ? 0.0f : sqrtf(vh)) + s.eps;
  p = p - s.lr * ((num == 0.0f ? num : num / den) + s.wd * p);
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

// --- flat_adamw_kernel: a ring of bulk copies ------------------------------
//
// The shard is cut into tiles of kTile elements. A persistent grid (at most
// kRingBlocksPerSm blocks a SM, never more blocks than whole tiles) gives
// each block a contiguous run of whole tiles. One thread of the block's
// producer warp fills a ring of kStages stages in shared memory with 1-D
// bulk copies (cp.async.bulk, the TMA's plain-bytes form): one a stream
// (master, mu, nu, grad) a tile, each arriving on the stage's "full"
// mbarrier by its byte count, each read with an L2 evict-first policy (every
// byte is read once, and a shard is many times the 50 MB L2). The consumer
// warps wait on "full", compute from shared memory and store master, mu and
// nu (and p for a bfloat16 group) with 16-byte (8-byte for bfloat16)
// streaming stores, then arrive on the stage's "empty" mbarrier, one arrive
// a warp, which lets the producer refill it. The elements past the last
// whole tile (fewer than kTile) are done by the last block's consumers
// with plain loads after their ring; a shard of fewer than kTile elements
// is only that. Every pointer is 16-byte aligned (the wrapper checks), so
// there is no ragged head. A stage holds 64 KB of a float32 gradient's tile
// (56 KB of a bfloat16 one), the ring 192 KB: one block a SM, whose 16
// consumer warps keep enough IEEE divisions and square roots in flight for
// the memory's rate (the zeros of the bucket pad answered directly, see
// adamw()).

constexpr int kTile = 4096;        // elements of a tile
constexpr int kStages = 3;         // tiles in flight a block
constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kRingThreads = kConsumers + 32;  // + the producer warp
constexpr int kRingBlocksPerSm = 1;
constexpr int kBarBytes = 128;     // the mbarriers, before the stages
static_assert(kTile % (4 * kConsumers) == 0, "a tile is whole float4s a "
              "consumer");
static_assert(2 * kStages * 8 <= kBarBytes, "the mbarriers fit before the "
              "stages");

template <typename G>
__host__ __device__ constexpr int stage_bytes() {
  return kTile * (3 * (int)sizeof(float) + (int)sizeof(G));
}

template <typename G>
__host__ __device__ constexpr int ring_smem() {
  return kBarBytes + kStages * stage_bytes<G>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Four elements by one streaming (evict-first) store.
__device__ __forceinline__ void stcs4(float* a, const float in[4]) {
  __stcs(reinterpret_cast<float4*>(a),
         make_float4(in[0], in[1], in[2], in[3]));
}

__device__ __forceinline__ void stcs4(bf16* a, const float in[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(a), x);
}

// G: the gradient's type. P: bf16 writes the new parameters to p_out;
// float writes no p stream (a float32 group's parameters are its master).
template <typename G, typename P>
__global__ void __launch_bounds__(kRingThreads, kRingBlocksPerSm)
    flat_adamw_kernel(float* __restrict__ master, float* __restrict__ mu,
                      float* __restrict__ nu, const G* __restrict__ grad,
                      P* __restrict__ p_out, int64_t n, Scalars s) {
  constexpr bool kWriteP = sizeof(P) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);  // full[kStages], empty[kStages]
  unsigned char* stages = smem + kBarBytes;
  const int64_t tiles = n / kTile;
  const int64_t first = tiles * blockIdx.x / gridDim.x;
  const int64_t count = tiles * (blockIdx.x + 1) / gridDim.x - first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      const uint64_t policy = evict_first_policy();
      for (int64_t k = 0; k < count; ++k) {
        const int st = (int)(k % kStages);
        const uint32_t full = bars + 8 * st;
        if (k >= kStages)
          mbar_wait(bars + 8 * (kStages + st),
                    (uint32_t)((k / kStages - 1) & 1));
        const int64_t e = (first + k) * kTile;
        const uint32_t dst = smem_u32(stages + st * stage_bytes<G>());
        mbar_expect_tx(full, stage_bytes<G>());
        bulk_load(dst, master + e, kTile * 4, full, policy);
        bulk_load(dst + kTile * 4, mu + e, kTile * 4, full, policy);
        bulk_load(dst + kTile * 8, nu + e, kTile * 4, full, policy);
        bulk_load(dst + kTile * 12, grad + e, kTile * sizeof(G), full,
                  policy);
      }
    }
    return;
  }

  for (int64_t k = 0; k < count; ++k) {
    const int st = (int)(k % kStages);
    mbar_wait(bars + 8 * st, (uint32_t)((k / kStages) & 1));
    const unsigned char* base = stages + st * stage_bytes<G>();
    const float* ws = reinterpret_cast<const float*>(base);
    const float* ms = ws + kTile;
    const float* vs = ws + 2 * kTile;
    const G* gs = reinterpret_cast<const G*>(ws + 3 * kTile);
    const int64_t e0 = (first + k) * kTile;
#pragma unroll
    for (int r = 0; r < kTile / (4 * kConsumers); ++r) {
      const int i = 4 * (threadIdx.x + r * kConsumers);
      float wf[4], mf[4], vf[4], gf[4];
      load4(ws + i, wf);
      load4(ms + i, mf);
      load4(vs + i, vf);
      load4(gs + i, gf);
#pragma unroll
      for (int j = 0; j < 4; ++j) adamw(wf[j], mf[j], vf[j], gf[j], s);
      const int64_t e = e0 + i;
      stcs4(master + e, wf);
      stcs4(mu + e, mf);
      stcs4(nu + e, vf);
      if constexpr (kWriteP) stcs4(p_out + e, wf);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));
  }

  if (blockIdx.x != gridDim.x - 1) return;
  // the elements past the last whole tile: fewer than kTile
  const int64_t rest = tiles * kTile;
  const int64_t nvec = (n - rest) / 4;
  for (int64_t i = threadIdx.x; i < nvec; i += kConsumers) {
    const int64_t e = rest + 4 * i;
    float wf[4], mf[4], vf[4], gf[4];
    load4(master + e, wf);
    load4(mu + e, mf);
    load4(nu + e, vf);
    load4(grad + e, gf);
#pragma unroll
    for (int j = 0; j < 4; ++j) adamw(wf[j], mf[j], vf[j], gf[j], s);
    store4(master + e, wf);
    store4(mu + e, mf);
    store4(nu + e, vf);
    if constexpr (kWriteP) store4(p_out + e, wf);
  }
  for (int64_t e = rest + 4 * nvec + threadIdx.x; e < n; e += kConsumers) {
    float wf = master[e], mf = mu[e], vf = nu[e];
    adamw(wf, mf, vf, load1(grad + e), s);
    master[e] = wf;
    mu[e] = mf;
    nu[e] = vf;
    if constexpr (kWriteP) store1(p_out + e, wf);
  }
}

int grid_limit(int blocks_per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  return sms * blocks_per_sm;
}

// Lets flat_adamw_kernel<G, P> take its ring's shared memory (over the
// 48 KB a launch gets by default), once a device, so that no attribute is
// set while a CUDA graph captures the launch.
template <typename G, typename P>
cudaError_t allow_ring_smem() {
  static std::atomic<uint32_t> devices{0};  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const uint32_t bit = 1u << (dev & 31);
  if (err != cudaSuccess || (devices.load() & bit)) return err;
  err = cudaFuncSetAttribute(flat_adamw_kernel<G, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem<G>());
  if (err == cudaSuccess) devices.fetch_or(bit);
  return err;
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
  const long long limit = grid_limit(kBlocksPerSm);
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

int hvd_flat_adamw_tile_elems() { return kTile; }

// p_dt 0 (float32): the parameters are master itself, and p_out must be
// null or master; p_dt 1 (bfloat16): they are also written to p_out.
int hvd_flat_adamw(void* master, void* mu, void* nu, const void* grad,
                   void* p_out, long long n, int g_dt, int p_dt, float b1,
                   float b2, float ibc1, float ibc2, float lr, float wd,
                   float eps, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  if (p_dt == 0 ? p_out != nullptr && p_out != master : p_out == nullptr)
    return cudaErrorInvalidValue;
  const Scalars s{b1, b2, ibc1, ibc2, lr, wd, eps};
  const long long limit = grid_limit(kRingBlocksPerSm);
  const long long tiles = n / kTile;
  // never more blocks than whole tiles; one for a shard under one tile
  const int blocks = (int)(tiles < 1 ? 1 : tiles < limit ? tiles : limit);
  return with_dtype(g_dt, [&](auto g) {
    return with_dtype(p_dt, [&](auto p) {
      typedef decltype(g) G;
      typedef decltype(p) P;
      const cudaError_t set = allow_ring_smem<G, P>();
      if (set != cudaSuccess) return (int)set;
      flat_adamw_kernel<G, P>
          <<<blocks, kRingThreads, ring_smem<G>(), (cudaStream_t)stream>>>(
              (float*)master, (float*)mu, (float*)nu, (const G*)grad,
              (P*)p_out, (int64_t)n, s);
      return (int)cudaGetLastError();
    });
  });
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
