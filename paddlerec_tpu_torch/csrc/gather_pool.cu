// K1: gather-pool forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_pool` / `_gather_pool_kernel` of
// paddlerec_tpu/ops/pallas_embedding.py (pallas_call at line 85):
//
//     out[n, :] = sum_l table[clip(ids[n, l], 0, R - 1), :] * mask[n, l]
//
// or, by `mode`, as `jnp.take`'s default mode (what flax's `nn.Embed` looks
// rows up with, mode 1): a negative id is wrapped once (id + R), and an id
// still outside [0, R) reads a row of NaN.  Modes 2 and 3 are mode 0 and mode
// 1 with a row of zeros for an id outside [0, R) (no clip, no NaN; mode 3
// wraps a negative id once first): the adjoint of K1b, whose gradient those
// ids never reach, so that K1 is also the backward of K1b in a second-order
// gradient.
//
// table (R, D) float32 or bfloat16, row-major; ids (N, L) int32; mask (N, L)
// float32, or null for weight 1 (no mask is read); out (N, D) in the table's
// dtype, or float32 from a bfloat16 table (the f32 sum written unrounded:
// what bf16 rows times a float32 mask promote to in the JAX package).  Any
// N, L and D: the TPU kernel's N % 8 == 0 and L <= 128 limits came from its
// tiling and do not apply here.
//
// What bounds it on the card: memory.  Each gathered element costs one
// multiply-add; the bytes are N*L*D*es of table rows, N*L*4 of ids (plus
// N*L*4 of mask) and N*D*es of output.  DeepFM's serving lookup (N = B*26,
// L = 1, D = 16 on the packed view, f32) moves 132 bytes per id: 1.76 MB at
// B = 512 (0.52 us at 3.35 TB/s), so at serving batch sizes the launch, not
// the bytes, sets its time.
//
// Design: a thread owns one 16-byte chunk of one output row (4 f32 or 8 bf16
// lanes) and loads it with one vector load per id; neighbouring threads take
// neighbouring chunks and then rows, so a warp reads whole table rows.  The
// loop over L runs inside the thread and sums in f32 registers (products and
// sums rounded one by one, no fused multiply-add, as the plain version does);
// the row is written once in the output dtype.  Every output element has one
// owner: no shared memory, no atomics.  Rows whose byte width is not a
// multiple of 16, or pointers not 16-byte aligned, take a scalar load path.
//
// Built by paddlerec_tpu_torch/ops/build.py into a shared library with a
// plain C interface; paddlerec_tpu_torch/ops/gather_pool.py binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int kWidth = 4;
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static void load16(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store16(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
  __device__ static void load16(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void store16(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// Writes the V lanes a thread owns (V is the table dtype's lane count) in the
// output dtype O: O = T, or float from a bfloat16 table (two 16-byte stores).
template <typename T, typename O>
struct Store {
  __device__ static void vec(O* p, const float* v) { Lanes<T>::store16(p, v); }
};

template <>
struct Store<__nv_bfloat16, float> {
  __device__ static void vec(float* p, const float* v) {
    Lanes<float>::store16(p, v);
    Lanes<float>::store16(p + 4, v + 4);
  }
};

template <typename T, typename O, bool kVec>
__global__ void __launch_bounds__(256)
gather_pool_kernel(const T* __restrict__ table, int64_t rows, int64_t dim,
                   const int32_t* __restrict__ ids, const float* __restrict__ mask,
                   int64_t n, int64_t pool, int mode, O* __restrict__ out) {
  constexpr int V = Lanes<T>::kWidth;
  const int64_t chunks = (dim + V - 1) / V;
  const int64_t total = n * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / chunks;
    const int64_t col = (t - r * chunks) * V;
    const int64_t width = dim - col < V ? dim - col : V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int64_t l = 0; l < pool; ++l) {
      int64_t id = __ldg(ids + r * pool + l);
      if ((mode & 1) && id < 0) id += rows;  // wrapped once, as jnp.take does
      const bool inside = id >= 0 && id < rows;
      if (mode == 0) id = id < 0 ? 0 : (id >= rows ? rows - 1 : id);
      const T* src = table + id * dim + col;
      float v[V];
      if (mode != 0 && !inside) {
        // a row of NaN (mode 1) or of zeros (modes 2, 3); nothing is read
        const float outside = (mode & 2) ? 0.f : __int_as_float(0x7fc00000);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = outside;
      } else if (kVec) {
        Lanes<T>::load16(src, v);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = k < width ? Lanes<T>::to_float(src[k]) : 0.f;
      }
      if (mask != nullptr) {
        const float w = __ldg(mask + r * pool + l);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], w));
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      }
    }
    O* dst = out + r * dim + col;
    if (kVec) {
      Store<T, O>::vec(dst, acc);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < width) dst[k] = Lanes<O>::from_float(acc[k]);
      }
    }
  }
}

template <typename T, typename O>
void launch(const void* table, int64_t rows, int64_t dim, const int32_t* ids,
            const float* mask, int64_t n, int64_t pool, int mode, void* out,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int V = Lanes<T>::kWidth;
  const int64_t total = n * ((dim + V - 1) / V);
  const int64_t blocks = std::min<int64_t>((total + kThreads - 1) / kThreads, 1 << 30);
  const bool vec = (dim * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* t = static_cast<const T*>(table);
  O* o = static_cast<O*>(out);
  if (vec) {
    gather_pool_kernel<T, O, true><<<blocks, kThreads, 0, stream>>>(t, rows, dim, ids, mask, n, pool, mode, o);
  } else {
    gather_pool_kernel<T, O, false><<<blocks, kThreads, 0, stream>>>(t, rows, dim, ids, mask, n, pool, mode, o);
  }
}

}  // namespace

// dtype, out_dtype: 0 = float32, 1 = bfloat16; out_dtype is the table's, or
// float32 from a bfloat16 table.  mode: 0 clips ids, 1 wraps and fills with
// NaN, 2 reads zeros for ids outside, 3 wraps and then reads zeros (see the
// top of the file).  Returns cudaGetLastError() after the launch (0 =
// success).  Launches on `stream` and allocates nothing.
extern "C" int pr_gather_pool(const void* table, int dtype, int64_t rows, int64_t dim,
                              const int32_t* ids, const float* mask, int64_t n,
                              int64_t pool, int mode, void* out, int out_dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || dim <= 0 || n <= 0 || pool <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && out_dtype == 0) {
    launch<float, float>(table, rows, dim, ids, mask, n, pool, mode, out, s);
  } else if (dtype == 1 && out_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(table, rows, dim, ids, mask, n, pool, mode, out, s);
  } else if (dtype == 1 && out_dtype == 0) {
    launch<__nv_bfloat16, float>(table, rows, dim, ids, mask, n, pool, mode, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: what any launch costs on the card.  chip_smoke.py times it
// beside K1 and K1b as the floor no kernel's time can go under, whatever its
// byte bound says (K1 at a serving batch moves 1.76 MB: 0.5 us of bytes).
__global__ void empty_kernel() {}

extern "C" int pr_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
