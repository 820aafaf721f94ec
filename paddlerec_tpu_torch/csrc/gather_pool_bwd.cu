// K1b: gradient of the gather-pool K1 with respect to its table, for Hopper
// (sm_90a): a weighted scatter-add.
//
//     dtable[r, :] = sum over (n, l) with ids[n, l] == r of g[n, :] * mask[n, l]
//
// g (N, D) float32 or bfloat16, row-major; ids (N, L) int32; mask (N, L)
// float32, or null for weight 1; dtable (R, D) float32 or bfloat16 (a
// bfloat16 g only into a bfloat16 dtable).  An id outside [0, R) adds nothing
// (it is dropped).  With `fill` set (the gradient of K1's fill mode, flax's
// `nn.Embed`) a negative id is first wrapped once (id + R), as the forward
// read it.
//
// The JAX package has no kernel for this: K1 (`gather_pool` of
// paddlerec_tpu/ops/pallas_embedding.py) is forward only, and the lookup's
// gradient is XLA's scatter-add in `_packed_lookup_bwd`
// (paddlerec_tpu/ops/packed_embedding.py:94-120).  That function places each
// gradient row into a 128-lane window with a one-hot multiply, because of the
// TPU's lane tiling.  Here the table is addressed through its (R*pack, w)
// view, where logical id i is row i, so the same sum is one w-wide add per id.
//
// Accumulation is always float32.  A float32 dtable is the accumulator
// itself.  A bfloat16 dtable accumulates into a float32 scratch of the same
// shape, which a second kernel rounds once to bfloat16; each contribution
// g[n]*mask[n,l] is rounded to bfloat16 before it is added, as the JAX
// function casts the incoming gradient to the table's dtype before its
// scatter.  atomicAdd on __nv_bfloat162 would round after every add and is not
// used.
//
// What bounds it on the card: memory.  The dense gradient is zero-filled
// (R*D*4 bytes written), g is read once (N*D*es), ids once (N*L*4, mask the
// same), and each touched row is read, added to and written back by the
// atomic units in L2.  For DeepFM's table view (1,000,008 x 16 float32) the
// zero fill is 64 MB of about 100 MB at batch 8192 and nearly all of it at
// batch 512; it is inherent to handing a dense gradient to a dense optimizer.
//
// Design: a thread owns 4 lanes (16 bytes of float32) of one row of g, loads
// them once, and for each of the row's L ids makes one 16-byte vector
// atomicAdd (sm_90) into the accumulator row; neighbouring threads take
// neighbouring chunks, so a warp covers whole rows.  Float sums by atomics
// depend on the order the adds arrive in: the result equals the plain version
// bitwise only where no row receives more than one add.  Rows whose width is
// not a multiple of 4 (ffm's 351 lanes), or pointers not 16-byte aligned, take
// the scalar path: a thread owns one element, loads it and makes one scalar
// atomicAdd per id, so that a warp's loads and atomics are still consecutive
// addresses.
//
// Built by paddlerec_tpu_torch/ops/build.py into a shared library with a
// plain C interface; paddlerec_tpu_torch/ops/gather_pool.py binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

#if CUDART_VERSION < 12010
#error "atomicAdd on float4 needs the CUDA toolkit 12.1 or later"
#endif

// One 16-byte atomic add (atomicAdd on float4: compute capability 9.0).
__device__ __forceinline__ void atomic_add4(float* dst, const float* c) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(c[0], c[1], c[2], c[3]));
}

// kRound: round each contribution to bfloat16 before adding (bfloat16 table).
// kVec: a thread owns 4 lanes and adds them with one 16-byte atomic; else one.
template <typename G, bool kRound, bool kVec>
__global__ void __launch_bounds__(256)
scatter_add_kernel(const G* __restrict__ g, const int32_t* __restrict__ ids,
                   const float* __restrict__ mask, int64_t n, int64_t pool,
                   int64_t dim, int64_t rows, int fill, float* __restrict__ acc) {
  constexpr int W = kVec ? 4 : 1;
  const int64_t chunks = dim / W;  // kVec: dim is a multiple of 4
  const int64_t total = n * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / chunks;
    const int64_t col = (t - r * chunks) * W;
    const G* src = g + r * dim + col;
    float v[W];
    if constexpr (kVec) {
      load4(src, v);
    } else {
      v[0] = to_float(src[0]);
    }
    for (int64_t l = 0; l < pool; ++l) {
      int64_t id = __ldg(ids + r * pool + l);
      if (fill && id < 0) id += rows;  // wrapped once, as the forward's fill mode
      if (id < 0 || id >= rows) continue;  // dropped, as the JAX scatter's mode="drop"
      float c[W];
      if (mask != nullptr) {
        const float w = __ldg(mask + r * pool + l);
#pragma unroll
        for (int k = 0; k < W; ++k) c[k] = __fmul_rn(v[k], w);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) c[k] = v[k];
      }
      if (kRound) {
#pragma unroll
        for (int k = 0; k < W; ++k) c[k] = __bfloat162float(__float2bfloat16_rn(c[k]));
      }
      float* dst = acc + id * dim + col;
      if constexpr (kVec) {
        atomic_add4(dst, c);
      } else {
        atomicAdd(dst, c[0]);
      }
    }
  }
}

__global__ void __launch_bounds__(256)
round_to_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                     int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    out[t] = __float2bfloat16_rn(acc[t]);
  }
}

int64_t blocks_for(int64_t total, int threads) {
  return std::min<int64_t>((total + threads - 1) / threads, 1 << 30);
}

template <typename G, bool kRound>
void launch_scatter(const void* g, const int32_t* ids, const float* mask, int64_t n,
                    int64_t pool, int64_t dim, int64_t rows, int fill, float* acc,
                    cudaStream_t stream) {
  constexpr int kThreads = 256;
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const int64_t total = n * (vec ? dim / 4 : dim);
  const int64_t blocks = blocks_for(total, kThreads);
  const G* gp = static_cast<const G*>(g);
  if (vec) {
    scatter_add_kernel<G, kRound, true><<<blocks, kThreads, 0, stream>>>(
        gp, ids, mask, n, pool, dim, rows, fill, acc);
  } else {
    scatter_add_kernel<G, kRound, false><<<blocks, kThreads, 0, stream>>>(
        gp, ids, mask, n, pool, dim, rows, fill, acc);
  }
}

}  // namespace

// g_dtype, table_dtype: 0 = float32, 1 = bfloat16; a bfloat16 g into a
// float32 dtable is refused.  fill: 1 wraps negative ids once (K1's fill
// mode), 0 drops them.  dtable (rows, dim) is overwritten.  scratch: float32 (rows, dim), needed for a bfloat16 dtable
// and ignored for a float32 one.  Returns the first CUDA error (0 =
// success).  Works on `stream` and allocates nothing.
extern "C" int pr_gather_pool_bwd(const void* g, int g_dtype, const int32_t* ids,
                                  const float* mask, int64_t n, int64_t pool,
                                  int64_t dim, int64_t rows, int fill, void* dtable,
                                  int table_dtype, float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || dim <= 0 || n <= 0 || pool <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((g_dtype != 0 && g_dtype != 1) || (table_dtype != 0 && table_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a float32 table's lookup gives float32, so its gradient never arrives in bfloat16
  if (table_dtype == 0 && g_dtype == 1) return static_cast<int>(cudaErrorInvalidValue);
  if (table_dtype == 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* acc = table_dtype == 0 ? static_cast<float*>(dtable) : scratch;
  const int64_t total = rows * dim;
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(total) * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table_dtype == 0) {
    launch_scatter<float, false>(g, ids, mask, n, pool, dim, rows, fill, acc, s);
  } else {
    if (g_dtype == 0) {
      launch_scatter<float, true>(g, ids, mask, n, pool, dim, rows, fill, acc, s);
    } else {
      launch_scatter<__nv_bfloat16, true>(g, ids, mask, n, pool, dim, rows, fill, acc, s);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table_dtype == 1) {
    round_to_bf16_kernel<<<blocks_for(total, 256), 256, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(dtable), total);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" const char* pr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
