// K1: gather-pool forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_pool` / `_gather_pool_kernel` of
// paddlerec_tpu/ops/pallas_embedding.py (lines 37-106, pallas_call at 85):
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
// N, L and D (D and L below 2^31): the TPU kernel's N % 8 == 0 and L <= 128
// limits came from its tiling and do not apply here.  Each output element is
// summed in float32 in the order l = 0, 1, ..., L-1, each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-add), as the
// plain version does.
//
// What bounds it on the card: memory, and at small N the launch and two
// dependent reads (an id, then the row it names).  Each gathered element
// costs one multiply-add; the bytes are N*L*D*es of table rows, N*L*4 of ids
// (plus N*L*4 of mask) and N*D*es of output.  DeepFM's serving lookup (N =
// B*26, L = 1, D = 16 on the packed view, f32) moves 132 bytes per id: 1.76
// MB at B = 512 (0.52 us at 3.35 TB/s), so there the launch floor (an empty
// kernel, ~1.7 us) sets the time, not the bytes.  Rows of 32-64 bytes at
// random ids are read at the card's random-access rate, well under 3.35
// TB/s: a masked 3-id pool at the Ali-CCP view costs what gathering its
// 70,656 rows unpooled costs (4.8 us each).
//
// Design.  The TPU kernel starts all BLOCK*L row DMAs of a grid step before
// it waits on any.  Each point below is the Hopper counterpart of that, or
// removes work the first design (one thread a 16-byte chunk, the pool walked
// id -> row -> add one id after another) did for every 16 bytes:
// 1. Memory-level parallelism.  A row's ids (and weights) of a block of up
//    to kBlock = 4 pool positions are loaded first, then the block's table
//    rows, all before the first add.  With one id a row (L = 1, most
//    lookups) a lane of a narrow row loads its one unit; a lane of a wider
//    row has kRounds = 4 units in flight.
// 2. No division.  Thread t takes lane t mod G of output row t / G, G a
//    power of two (shifts and masks) sized to the row: one 16-byte unit a
//    lane, or with L = 1 four elements a lane of a scalar row, at most 32
//    lanes with L = 1 (wider rows take passes of 4 units a lane).  Row offsets
//    (id*D, n*D) are 64-bit, one wide multiply a row; everything inside a row
//    is 32-bit.  The first design divided in int64 for every 16 bytes.
// 3. `mode`, mask-or-none and the load path are template parameters, chosen
//    once a launch: 4 modes x 2 x 2 paths x 2 table dtypes x 2 kernels (L = 1
//    and L > 1) = 64 small kernels (the float32 output of a bfloat16 table is
//    a flag of the store).  No loop tests any of them.
// 4. Ids and weights are read once a row: the G lanes of a row load the same
//    id in one warp instruction, one memory request for all of them.
//    Loading them in one lane and passing them on with __shfl_sync was
//    measured slower: 2.43 against 2.32 us at metaheac's dynamic_3 (N = 320,
//    D = 64) and 5.33 against 5.18 us at the Ali-CCP view's B = 1024 pool.
// 5. Cache policy.  Table rows bypass L1 (ld.global.nc.L1::no_allocate) when
//    a launch reads at least 8,192 ids but fewer ids than the table has rows
//    (few rows are read twice): 10.2 against 13.2 us at DeepFM's B = 8192,
//    while under some thousands of ids it cost 0.05-0.2 us.  Small, reused
//    tables (position tables, bert4rec's sentence table) keep the default.
//
// Measured and left out (chip_smoke.py --only k1 --against, each beside
// this design in one call): 4 output rows in flight a lane at L = 1 (106-123
// registers: dynamic_3 2.90 against 2.50 us for the first design); up to
// 1,024 lanes a row (fastformer's 400-wide position rows 11.0 against 8.6
// us); blocks of 8 pool positions (5.06 against 4.87 us at the Ali-CCP
// view); 256-thread blocks (no change); evict-first output stores (no
// change at ffm's 299 MB output or the 8.7 GB one); L2 prefetch-size hints
// (.L2::64B no change, .L2::128B 11.7 against 9.8 us at DeepFM's B = 8192).
// Neither tile TMA nor wgmma applies: K1 computes no matrix product, and
// sm_90's TMA has no row-gather mode.  A 1-D cp.async.bulk per gathered row
// into a shared-memory ring is the only bulk route; it was not tried, since
// rows here are 4-1,600 bytes, each byte is used once, and the register path
// already reads rows at the gather rate above.
//
// Rows whose byte width is not a multiple of 16, or pointers not 16-byte
// aligned, take the scalar path: one element a load.
//
// Built by paddlerec_tpu_torch/ops/build.py into a shared library with a
// plain C interface; paddlerec_tpu_torch/ops/gather_pool.py binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBlock = 4;  // pool positions whose rows are in flight together
constexpr int kRounds = 4;  // units a lane has in flight when L = 1
constexpr int64_t kNoAllocateFrom = 8192;  // ids a launch from which rows can bypass L1

// One unit of a row: 16 bytes (kVec) or one element, loaded raw and widened
// to float32 lanes.
template <typename T, bool kVec>
struct Unit;

template <typename T>
struct Unit<T, true> {
  using Raw = uint4;
  static constexpr int kWidth = 16 / sizeof(T);
  __device__ static Raw load(const T* p, bool no_allocate) {
    Raw q;
    if (no_allocate) {
      asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
          : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
          : "l"(p));
    } else {
      q = __ldg(reinterpret_cast<const uint4*>(p));
    }
    return q;
  }
  __device__ static void widen(const Raw& q, float* v) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 4) {
        v[k] = __uint_as_float(w[k]);
      } else {  // two bfloat16, element 0 in the low half: exact widening
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
};

template <>
struct Unit<float, false> {
  using Raw = float;
  static constexpr int kWidth = 1;
  __device__ static Raw load(const float* p, bool) { return __ldg(p); }
  __device__ static void widen(Raw q, float* v) { v[0] = q; }
};

template <>
struct Unit<__nv_bfloat16, false> {
  using Raw = unsigned short;
  static constexpr int kWidth = 1;
  __device__ static Raw load(const __nv_bfloat16* p, bool) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void widen(Raw q, float* v) {
    v[0] = __uint_as_float(static_cast<unsigned>(q) << 16);
  }
};

// Writes V float32 lanes at element `at` of the output: float32, or (a
// bfloat16 table without out_f32) bfloat16.  V = 1 (scalar path), 4 (a
// float32 unit) or 8 (a bfloat16 unit).
template <typename T, int V>
__device__ __forceinline__ void store_unit(void* out, int64_t at, const float* acc, bool out_f32) {
  if (sizeof(T) == 4 || out_f32) {
    float* p = static_cast<float*>(out) + at;
    if constexpr (V == 1) {
      *p = acc[0];
    } else {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        reinterpret_cast<float4*>(p)[k] =
            make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
      }
    }
  } else {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + at;
    if constexpr (V == 1) {
      *p = __float2bfloat16_rn(acc[0]);
    } else {
      unsigned h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h[k] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * k]))) |
               static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * k + 1])))
                   << 16;
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
}

// Where id `raw` reads from: 0 = table row *row, 1 = a row of NaN, 2 = a
// row of zeros (see the modes at the top of the file).
template <int kMode>
__device__ __forceinline__ int resolve(int raw, int64_t rows, int64_t* row) {
  int64_t id = raw;
  if (kMode & 1) id += raw < 0 ? rows : 0;  // wrapped once, as jnp.take does
  if (kMode == 0) {
    *row = id < 0 ? 0 : (id >= rows ? rows - 1 : id);
    return 0;
  }
  const bool inside = id >= 0 && id < rows;
  *row = inside ? id : 0;
  return inside ? 0 : ((kMode & 2) ? 2 : 1);
}

// acc += row * w (or + row without a mask), for a row already loaded raw
template <typename T, bool kVec, bool kMask>
__device__ __forceinline__ void accumulate(float* acc, const typename Unit<T, kVec>::Raw& raw,
                                           int state, float w) {
  constexpr int V = Unit<T, kVec>::kWidth;
  float v[V];
  Unit<T, kVec>::widen(raw, v);
  if (state == 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __int_as_float(0x7fc00000);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], kMask ? __fmul_rn(v[k], w) : v[k]);
}

struct Shape {
  int64_t rows, n;
  int dim, pool, units, lg;
  bool out_f32;      // a bfloat16 table read into float32
  bool no_allocate;  // table rows bypass L1
};

// kRounds units of one output row, c = p + k*stride: all loaded before the
// first store, then widened, weighted and written.
template <typename T, bool kVec, bool kMask>
__device__ __forceinline__ void row_units(const T* __restrict__ src, void* __restrict__ out,
                                          int64_t at, int p, int stride, const Shape& sh,
                                          int state, float w) {
  using U = Unit<T, kVec>;
  constexpr int V = U::kWidth;
  typename U::Raw raw[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = p + k * stride;
    raw[k] = typename U::Raw{};
    if (state == 0 && c < sh.units) raw[k] = U::load(src + c * V, sh.no_allocate);
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = p + k * stride;
    if (c < sh.units) {
      float acc[V] = {};
      accumulate<T, kVec, kMask>(acc, raw[k], state, w);
      store_unit<T, V>(out, at + c * V, acc, sh.out_f32);
    }
  }
}

// L = 1.  Thread t takes lane q = t mod G of output row t / G (shifts: G
// is a power of two, at most 32).  A row of at most G 16-byte units is one
// load a lane.  A scalar row of at most kRounds*G elements: elements
// q*kRounds + k of lane q (measured faster there than a stride of G).  Any
// wider row: units q + G*k, kRounds a pass (a warp reads and writes whole
// 128-byte runs), as many passes as it takes.
template <typename T, int kMode, bool kMask, bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
gather_one_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                  const float* __restrict__ mask, void* __restrict__ out, Shape sh) {
  using U = Unit<T, kVec>;
  constexpr int V = U::kWidth;
  const int group = 1 << sh.lg;
  const bool one_unit = kVec && sh.units <= group;
  const bool consecutive = !kVec && sh.units <= kRounds * group;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       (t >> sh.lg) < sh.n; t += step) {
    const int64_t r = t >> sh.lg;
    const int q = static_cast<int>(t) & (group - 1);
    int64_t row;
    const int state = resolve<kMode>(__ldg(ids + r), sh.rows, &row);
    const float w = kMask ? __ldg(mask + r) : 1.f;
    const T* src = table + row * sh.dim;
    if (one_unit) {
      if (q < sh.units) {
        typename U::Raw raw{};
        if (state == 0) raw = U::load(src + q * V, sh.no_allocate);
        float acc[V] = {};
        accumulate<T, kVec, kMask>(acc, raw, state, w);
        store_unit<T, V>(out, r * sh.dim + q * V, acc, sh.out_f32);
      }
    } else if (consecutive) {
      row_units<T, kVec, kMask>(src, out, r * sh.dim, q * kRounds, 1, sh, state, w);
    } else {
      for (int p = q; p < sh.units; p += kRounds * group) {
        row_units<T, kVec, kMask>(src, out, r * sh.dim, p, group, sh, state, w);
      }
    }
  }
}

// L > 1.  Thread t takes unit q = t mod G of output row t / G, one unit a
// lane.  For pool positions l0 .. l0 + kb - 1 (kb <= kBlock) it loads the
// ids and weights, then the kb rows, and only then adds them in order.
template <typename T, int kMode, bool kMask, bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
gather_pool_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                   const float* __restrict__ mask, void* __restrict__ out, Shape sh) {
  using U = Unit<T, kVec>;
  constexpr int V = U::kWidth;
  const int group = 1 << sh.lg;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       (t >> sh.lg) < sh.n; t += step) {
    const int64_t r = t >> sh.lg;
    const int c = static_cast<int>(t) & (group - 1);
    if (c >= sh.units) continue;
    const int32_t* rid = ids + r * sh.pool;
    const float* rw = kMask ? mask + r * sh.pool : nullptr;
    float acc[V] = {};
    for (int l0 = 0; l0 < sh.pool; l0 += kBlock) {
      const int kb = min(kBlock, sh.pool - l0);
      int id[kBlock];
      float w[kBlock];
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        if (j < kb) {
          id[j] = __ldg(rid + l0 + j);
          w[j] = kMask ? __ldg(rw + l0 + j) : 1.f;
        }
      }
      typename U::Raw raw[kBlock];
      int state[kBlock];
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        raw[j] = typename U::Raw{};
        if (j < kb) {
          int64_t row;
          state[j] = resolve<kMode>(id[j], sh.rows, &row);
          if (state[j] == 0) raw[j] = U::load(table + row * sh.dim + c * V, sh.no_allocate);
        }
      }
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        if (j < kb) accumulate<T, kVec, kMask>(acc, raw[j], state[j], w[j]);
      }
    }
    store_unit<T, V>(out, r * sh.dim + c * V, acc, sh.out_f32);
  }
}

template <typename T, int kMode, bool kMask, bool kVec>
void launch_kernel(const Shape& sh, int64_t blocks, const void* table, const int32_t* ids,
                   const float* mask, void* out, cudaStream_t stream) {
  const T* t = static_cast<const T*>(table);
  if (sh.pool == 1) {
    gather_one_kernel<T, kMode, kMask, kVec><<<blocks, kThreads, 0, stream>>>(t, ids, mask, out, sh);
  } else {
    gather_pool_kernel<T, kMode, kMask, kVec><<<blocks, kThreads, 0, stream>>>(t, ids, mask, out, sh);
  }
}

template <typename T, int kMode>
void launch_mode(bool vec, const Shape& sh, int64_t blocks, const void* table,
                 const int32_t* ids, const float* mask, void* out, cudaStream_t stream) {
  if (vec && mask != nullptr) {
    launch_kernel<T, kMode, true, true>(sh, blocks, table, ids, mask, out, stream);
  } else if (vec) {
    launch_kernel<T, kMode, false, true>(sh, blocks, table, ids, mask, out, stream);
  } else if (mask != nullptr) {
    launch_kernel<T, kMode, true, false>(sh, blocks, table, ids, mask, out, stream);
  } else {
    launch_kernel<T, kMode, false, false>(sh, blocks, table, ids, mask, out, stream);
  }
}

template <typename T>
int launch(const void* table, int64_t rows, int64_t dim, const int32_t* ids, const float* mask,
           int64_t n, int64_t pool, int mode, void* out, bool out_f32, cudaStream_t stream) {
  if (dim > INT_MAX || pool > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (dim * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  Shape sh{rows, n, static_cast<int>(dim), static_cast<int>(pool), 0, 0, out_f32, false};
  sh.units = vec ? static_cast<int>(dim / Unit<T, true>::kWidth) : static_cast<int>(dim);
  // G lanes a row.  L > 1: one 16-byte unit (or element) a lane.  L = 1:
  // at most a warp, each lane kRounds elements of a scalar row
  const int64_t spread = pool > 1 ? sh.units
                         : std::min<int64_t>(32, vec ? sh.units : (sh.units + kRounds - 1) / kRounds);
  while ((int64_t{1} << sh.lg) < spread) ++sh.lg;
  if (sh.lg > 30) return static_cast<int>(cudaErrorInvalidValue);  // rows of 2^30 units
  // rows that fewer ids than rows read are seldom read twice: keep them out
  // of L1 (measured: it pays from some thousands of ids a launch, and costs
  // a little below)
  sh.no_allocate = n * pool >= kNoAllocateFrom && n * pool < rows;
  const int64_t blocks =
      std::min<int64_t>(((n << sh.lg) + kThreads - 1) / kThreads, INT_MAX);
  switch (mode) {
    case 0: launch_mode<T, 0>(vec, sh, blocks, table, ids, mask, out, stream); break;
    case 1: launch_mode<T, 1>(vec, sh, blocks, table, ids, mask, out, stream); break;
    case 2: launch_mode<T, 2>(vec, sh, blocks, table, ids, mask, out, stream); break;
    default: launch_mode<T, 3>(vec, sh, blocks, table, ids, mask, out, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
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
    return launch<float>(table, rows, dim, ids, mask, n, pool, mode, out, false, s);
  }
  if (dtype == 1 && (out_dtype == 0 || out_dtype == 1)) {
    return launch<__nv_bfloat16>(table, rows, dim, ids, mask, n, pool, mode, out, out_dtype == 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
