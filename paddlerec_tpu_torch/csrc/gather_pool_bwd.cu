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
// (paddlerec_tpu/ops/packed_embedding.py:94-120) and `_grad_sum`
// (paddlerec_tpu/ops/sparse_update.py:200-206).  The JAX function places each
// gradient row into a 128-lane window with a one-hot multiply, because of the
// TPU's lane tiling.  Here the table is addressed through its (R*pack, w)
// view, where logical id i is row i, so the same sum is one w-wide add per id.
//
// Accumulation is always float32, and each sum is rounded once.  For a
// bfloat16 dtable each contribution g[n]*mask[n,l] is rounded to bfloat16
// before it is added, as the JAX function casts the incoming gradient to the
// table's dtype before its scatter; atomicAdd on __nv_bfloat162 would round
// after every add and is not used.  Float sums by atomics depend on the order
// the adds arrive in: the result equals the plain version bitwise only where
// no row receives more than one add.
//
// What bounds it on the card: memory, and where few rows take many adds, the
// serialised adds on those rows.  The dense gradient is written once (R*D*es
// bytes, for a dense optimizer: DeepFM's view 64 MB, ffm's 1.4 GB), g is read
// once, ids once (mask the same).  The first port spent, beyond that: a
// memset and a scatter launched one after the other (two launch floors of
// 1.8 us where the output is small), one global atomic per (n, l) however
// many fall on one row (1,600 serialised adds on bert4rec's row 0: 11 us),
// and for a bfloat16 dtable a float32 scratch of the whole table, zero-filled,
// read back and rounded (92 us at DeepFM's B=8192 against a bound of 12).
//
// Design: a zero fill, then the adds, on PyTorch's stream.
// - The fill is a kernel of evict-first 16-byte stores (`__stcs`: the zeros
//   leave g and the ids in L2 for the adds), one thread a store where the
//   output dwarfs the ids, else a grid of 8 blocks an SM striding over it.
//   Each block lets the next kernel start after its last store, and the adds
//   are launched as its programmatic dependent (sm_90): their launch and
//   whatever they read before `griddepcontrol.wait` (the sort; g and the ids
//   of the first rows) overlap the fill.
// - A. A small table (R <= 4,096) that takes many adds a row (N*L >= 256*R,
//   or D*N*L >= 2^20: bert4rec's sentence table, fastformer's positions): a
//   block takes a chunk of the pairs and up to 64 columns, sorts the pairs
//   by row in shared memory with a counting sort before it waits for the
//   zeros, and a thread sums each run of equal rows it meets in registers
//   and adds it with one 16-byte reduction.
// - B. Otherwise: a thread owns 4 lanes (16 bytes) of one row of g, loads
//   them once and makes one 16-byte atomicAdd (sm_90) per id; rows of 64 or
//   more lanes that do not start on 16 bytes (ffm's row r starts at r*1,404
//   bytes) peel a scalar head and tail around 16-byte atomics; narrower ones
//   give a thread one element.
// - A bfloat16 dtable: its zeros are written once in bfloat16 and the float32
//   scratch is zeroed only at the touched rows, in one kernel; the adds go to
//   the scratch; the touched rows are rounded into the dtable once.
//
// Measured and left out (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py --only
// k1b --against <other source>`, each against the current source in one call):
// - Summing a small table in the shared memory of an 8-block cluster and
//   reducing it over distributed shared memory: a float atomicAdd on shared
//   memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), and naml's
//   words took 39.4 us against 8.6; with a sort and global reductions into a
//   slab the cluster zero-fills, sentence 6.8 and title 7.9 us, but naml 12.9.
// - One launch in which each block zero-fills a slab of rows and then adds the
//   few ids that land there (no memset launch): slower than memset + scatter
//   at every shape it took (dynamic_3 28.4 against 26.6 us): the blocks' fill
//   wrote slower than the memset kernel.
// - The fill with plain stores under the dependent launch: dynamic_3 27.4 us
//   against 26.0 for memset + scatter; evict-first stores made it 24.0.
// - Warp-aggregated integer atomics in the sort (one per group of equal ids):
//   title 8.96 against 7.90 us, sentence unchanged.
// - Peeled 16-byte atomics below 64 lanes: naml's 30 lanes 9.64 against 8.69
//   us for one element a thread; ffm's 351 lanes 827 against 846 us.
// - The sorted path at bert4rec's positions (50 rows, 32 adds a row) 6.8 us
//   and naml's words 9.6 us, against 3.4 and 7.3 through B: hence its rule.
// - The adds waiting for the zeros at their start, not before their first
//   atomic: dynamic_3 23.79 against 23.26 us, din 7.38 against 6.90; but
//   peeled rows (ffm's: 898 against 821 us) and the bfloat16 table (47.0
//   against 46.3) are faster waiting at their start, and do.
// - Two 16-byte stores a thread in the fill: slower everywhere (DeepFM's
//   B=8192 60.0 against 36.1 us).
// - Rows written once from pairs grouped by slab of 32 rows (count, scan,
//   place, then a block a slab summing in shared memory and writing it once):
//   ffm's D=351 975 against 820 us; a slab's dependent loads before its write,
//   at 5 blocks an SM, left the 1.4 GB write latency-bound.
// - kSortItems 8 (sentence 5.95 us, content 13.1) against 16 (6.98, 10.0), 4
//   and 32 slower at both; kSortColumns 32 and 128 within 4% of 64 at title
//   and content.
//
// Built by paddlerec_tpu_torch/ops/build.py into a shared library with a
// plain C interface; paddlerec_tpu_torch/ops/gather_pool.py binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSortRows = 4096;               // path A: rows at most, and
constexpr int kSortAddsPerRow = 256;          //   N * L / R at least,
constexpr int64_t kSortMinWork = 1 << 20;     //   or D * N * L at least
constexpr int kSortColumns = 64;              // path A: columns a block
constexpr int kSortItems = 16;                // path A: 4-column adds a thread
constexpr int kSortMaxChunk = 2048;           // path A: pairs a block at most
constexpr int kPeelDim = 64;                  // path B: unaligned rows peeled from this D
constexpr int kFillBlocksPerSM = 8;           // path B: the fill's grid, striding
constexpr int64_t kFullGridBytes = 32 << 20;  // path B: a full fill grid from this size
constexpr int kFullGridRowsPerId = 64;        //   where the rows are this many an id,
constexpr int64_t kFullGridAlwaysBytes = 256 << 20;  // and from this size always

#if CUDART_VERSION < 12010
#error "atomicAdd on float4 needs the CUDA toolkit 12.1 or later"
#endif

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// a / b and a % b, in 32 bits where both fit (fewer instructions than 64)
__device__ __forceinline__ int64_t div_mod(int64_t a, int64_t b, int64_t* rem) {
  if (((a | b) >> 32) == 0) {
    const uint32_t q = static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
    *rem = a - static_cast<int64_t>(q) * b;
    return q;
  }
  const int64_t q = a / b;
  *rem = a - q * b;
  return q;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

// The destination row of pair k = n * pool + l: wrapped once in fill mode,
// -1 where it is dropped (outside [0, rows)), as the JAX scatter's mode="drop".
__device__ __forceinline__ int64_t dest_row(const int32_t* __restrict__ ids, int64_t k,
                                            int64_t rows, int fill) {
  int64_t id = __ldg(ids + k);
  if (fill && id < 0) id += rows;
  return (id < 0 || id >= rows) ? -1 : id;
}

// c = v * w (mask given) rounded to bfloat16 (kRound), as the plain version.
template <bool kRound>
__device__ __forceinline__ float contribution(float v, const float* __restrict__ mask,
                                              float w) {
  float c = mask != nullptr ? __fmul_rn(v, w) : v;
  return kRound ? round_bf16(c) : c;
}

// One unit of the add of g's row `grow` (dim elements) into the float32 row
// `arow`: u = 0 the head of up to 3 elements before arow's first 16-byte
// boundary, u = 1 .. nb a 16-byte atomic, u = nb + 1 the tail.  A row has
// at most dim / 4 + 2 units; units past its last do nothing.
template <typename G, bool kRound>
__device__ __forceinline__ void add_unit(const G* __restrict__ grow,
                                         const float* __restrict__ mask, float w,
                                         float* arow, int64_t dim, int64_t u) {
  const int64_t head =
      lmin(dim, ((16 - (reinterpret_cast<uintptr_t>(arow) & 15)) & 15) / 4);
  const int64_t nb = (dim - head) / 4;
  if (u >= 1 && u <= nb) {
    const int64_t e0 = head + 4 * (u - 1);
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = contribution<kRound>(to_float(grow[e0 + j]), mask, w);
    atomicAdd(reinterpret_cast<float4*>(arow + e0), make_float4(c[0], c[1], c[2], c[3]));
    return;
  }
  int64_t e0, count;
  if (u == 0) {
    e0 = 0;
    count = head;
  } else if (u == nb + 1) {
    e0 = head + 4 * nb;
    count = dim - e0;
  } else {
    return;
  }
  for (int64_t j = 0; j < count; ++j) {
    atomicAdd(arow + e0 + j, contribution<kRound>(to_float(grow[e0 + j]), mask, w));
  }
}

// Zero bytes [lo, hi) of `base` (even offsets) with 16-byte stores, the
// threads numbered t of `stride`.
__device__ __forceinline__ void zero_bytes(char* base, int64_t lo, int64_t hi, int64_t t,
                                           int64_t stride) {
  const int64_t head = lmin(
      hi - lo, (16 - (reinterpret_cast<uintptr_t>(base + lo) & 15)) & 15);
  for (int64_t i = 2 * t; i < head; i += 2 * stride) {
    *reinterpret_cast<uint16_t*>(base + lo + i) = 0;
  }
  const int64_t body = lo + head;
  const int64_t quads = (hi - body) / 16;
  uint4* v = reinterpret_cast<uint4*>(base + body);
  for (int64_t i = t; i < quads; i += stride) v[i] = make_uint4(0, 0, 0, 0);
  for (int64_t i = body + 16 * quads + 2 * t; i < hi; i += 2 * stride) {
    *reinterpret_cast<uint16_t*>(base + i) = 0;
  }
}

// Programmatic dependent launch (sm_90): a kernel launched with
// `launch_dependent` may start while the kernel before it on the stream
// finishes; it waits here before its first access to that kernel's output.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets the next kernel (launched with `launch_dependent`) start: called by
// each block after its last store.
__device__ __forceinline__ void let_next_kernel_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ---- path A: a small table: its pairs sorted by row, runs added once ----------
// Exclusive prefix sum of a[0 .. len) in place by the block; returns the total.
__device__ int block_exclusive_scan(int* a, int len) {
  __shared__ int warp_total[kThreads / 32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = min(len, t * per), hi = min(len, lo + per);
  int sum = 0;
  for (int r = lo; r < hi; ++r) sum += a[r];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_total[w] : 0;
    total += warp_total[w];
  }
  int base = before + x - sum;
  for (int r = lo; r < hi; ++r) {
    const int c = a[r];
    a[r] = base;
    base += c;
  }
  __syncthreads();
  return total;
}

// Adds a run's sum s (columns col .. col+3 of a row, those below `end`) into
// the float32 row `arow`: one 16-byte reduction where kVec, else one a lane.
template <bool kVec>
__device__ __forceinline__ void add_run(float* arow, int64_t col, int64_t end, const float* s) {
  if constexpr (kVec) {
    atomicAdd(reinterpret_cast<float4*>(arow + col), make_float4(s[0], s[1], s[2], s[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col + j < end) atomicAdd(arow + col + j, s[j]);
    }
  }
}

// grid (pair chunks, column chunks): block (b, c) takes pairs [b * chunk,
// + chunk) and columns [c * cw, + cw) of a small table (rows <= kSortRows).
// Before it waits for the zeros it sorts its pairs by row in shared memory
// (a counting sort with integer atomics, which the card does natively: a
// float atomicAdd on shared memory is a compare-and-swap loop) and loads
// their rows of g; a thread then sums each run of equal rows it meets in
// registers and adds it with one reduction a 4-column unit.
template <typename G, bool kRound, bool kVec>
__global__ void __launch_bounds__(kThreads)
sorted_scatter_kernel(const G* __restrict__ g, const int32_t* __restrict__ ids,
                      const float* __restrict__ mask, int64_t n, int64_t pool, int64_t dim,
                      int rows, int fill, int chunk, int cw_max, float* __restrict__ acc) {
  extern __shared__ int smem[];
  int* offset = smem;                // rows: counts, then where each row's pairs start
  int* row_of = smem + rows;         // the block's pairs: their row, -1 if dropped
  int* sorted = row_of + chunk;      // the block's pairs ordered by row
  const int64_t pairs = n * pool;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int mine = static_cast<int>(lmin(chunk, pairs - k0));
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * cw_max;
  const int cw = static_cast<int>(lmin(cw_max, dim - col0));

  for (int r = threadIdx.x; r < rows; r += blockDim.x) offset[r] = 0;
  __syncthreads();
  constexpr int kBatch = 8;  // loads in flight a thread
  for (int k = threadIdx.x; k < mine; k += kBatch * kThreads) {
    int64_t id[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int kb = k + b * kThreads;
      id[b] = kb < mine ? dest_row(ids, k0 + kb, rows, fill) : -1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int kb = k + b * kThreads;
      if (kb < mine) {
        row_of[kb] = static_cast<int>(id[b]);
        if (id[b] >= 0) atomicAdd(offset + id[b], 1);
      }
    }
  }
  __syncthreads();
  const int kept = block_exclusive_scan(offset, rows);
  for (int k = threadIdx.x; k < mine; k += blockDim.x) {
    if (row_of[k] >= 0) sorted[atomicAdd(offset + row_of[k], 1)] = k;
  }
  __syncthreads();

  // thread (i, q): 4 columns q of a contiguous stretch of the sorted pairs
  const int quads = (cw + 3) / 4;
  const int per_pass = kThreads / quads;
  const int i = threadIdx.x / quads, c = 4 * (threadIdx.x % quads);
  if (i >= per_pass) return;
  const int lo = static_cast<int>(static_cast<int64_t>(kept) * i / per_pass);
  const int hi = static_cast<int>(static_cast<int64_t>(kept) * (i + 1) / per_pass);
  bool waited = false;
  int cur = -1;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = lo; j < hi; j += kBatch) {
    float v[kBatch][4];
    int row[kBatch];
    float w[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int kl = sorted[min(j + b, hi - 1)];
      const int64_t k = k0 + kl;
      row[b] = j + b < hi ? row_of[kl] : -1;
      w[b] = mask != nullptr ? __ldg(mask + k) : 1.f;
      const G* src = g + (pool == 1 ? k : k / pool) * dim + col0 + c;
      if constexpr (kVec) {
        load4(src, v[b]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[b][t] = c + t < cw ? to_float(src[t]) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (row[b] < 0) continue;
      float x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = contribution<kRound>(v[b][t], mask, w[b]);
      if (row[b] == cur) {
#pragma unroll
        for (int t = 0; t < 4; ++t) s[t] += x[t];
      } else {
        if (cur >= 0) {
          if (!waited) wait_for_previous_kernel();  // the zeros
          waited = true;
          add_run<kVec>(acc + cur * dim + col0, c, cw, s);
        }
        cur = row[b];
#pragma unroll
        for (int t = 0; t < 4; ++t) s[t] = x[t];
      }
    }
  }
  if (cur >= 0) {
    if (!waited) wait_for_previous_kernel();
    add_run<kVec>(acc + cur * dim + col0, c, cw, s);
  }
}

// ---- path B: the scatter (after a memset, or into the zeroed scratch rows) ----
// kLayout kVec: dim a multiple of 4 and g and acc 16-byte aligned: a thread
// owns 4 lanes of one row of g, loads them once and makes one 16-byte atomic
// per id.  kPeel (rows of kPeelDim or more): a thread owns one unit
// (add_unit) of a row.  kScalar: a thread owns one element.
enum Layout { kVec, kPeel, kScalar };

template <typename G, bool kRound, Layout kLayout>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const G* __restrict__ g, const int32_t* __restrict__ ids,
                   const float* __restrict__ mask, int64_t n, int64_t pool,
                   int64_t dim, int64_t rows, int fill, float* __restrict__ acc) {
  const int64_t units = kLayout == kVec ? dim / 4 : kLayout == kPeel ? dim / 4 + 2 : dim;
  const int64_t total = n * units;
  // wait for the zeros before the first atomic, or (peeled rows, a bfloat16
  // dtable: measured slower that way) at once
  constexpr bool kLoadFirst = kLayout != kPeel && !kRound;
  if (!kLoadFirst) wait_for_previous_kernel();
  bool waited = !kLoadFirst;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    int64_t u;
    const int64_t r = div_mod(t, units, &u);
    const G* grow = g + r * dim;
    float v[4];
    if constexpr (kLayout == kVec) load4(grow + 4 * u, v);
    if constexpr (kLayout == kScalar) v[0] = to_float(grow[u]);
    for (int64_t l = 0; l < pool; ++l) {
      const int64_t id = dest_row(ids, r * pool + l, rows, fill);
      if (id < 0) continue;
      const float w = mask != nullptr ? __ldg(mask + r * pool + l) : 1.f;
      if (!waited) wait_for_previous_kernel();
      waited = true;
      if constexpr (kLayout == kScalar) {
        atomicAdd(acc + id * dim + u, contribution<kRound>(v[0], mask, w));
      } else if constexpr (kLayout == kVec) {
        float c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = contribution<kRound>(v[j], mask, w);
        atomicAdd(reinterpret_cast<float4*>(acc + id * dim + 4 * u),
                  make_float4(c[0], c[1], c[2], c[3]));
      } else {
        add_unit<G, kRound>(grow, mask, w, acc + id * dim, dim, u);
      }
    }
  }
}

// Path B, bfloat16 dtable, before the scatter: bfloat16 zeros over the whole
// dtable, and float32 zeros in the scratch at every touched row.  Both
// bfloat16 kernels give a row's 4-column units (kVec) or elements to
// neighbouring threads.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
zero_bf16_kernel(const int32_t* __restrict__ ids, int64_t pairs, int64_t dim, int64_t rows,
                 int fill, __nv_bfloat16* __restrict__ dtable, float* __restrict__ acc) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  zero_bytes(reinterpret_cast<char*>(dtable), 0, rows * dim * 2, t0, stride);
  const int64_t units = kVec ? dim / 4 : dim;
  for (int64_t t = t0; t < pairs * units; t += stride) {
    int64_t u;
    const int64_t id = dest_row(ids, div_mod(t, units, &u), rows, fill);
    if (id < 0) continue;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(acc + id * dim + 4 * u) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      acc[id * dim + u] = 0.f;
    }
  }
  let_next_kernel_start();
}

// Path B, bfloat16 dtable, after the scatter: the touched rows rounded once
// (a row taken by several pairs is written with the same values by each).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
round_rows_kernel(const int32_t* __restrict__ ids, int64_t pairs, int64_t dim, int64_t rows,
                  int fill, const float* __restrict__ acc, __nv_bfloat16* __restrict__ dtable) {
  const int64_t units = kVec ? dim / 4 : dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  wait_for_previous_kernel();  // the sums
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < pairs * units; t += stride) {
    int64_t u;
    const int64_t id = dest_row(ids, div_mod(t, units, &u), rows, fill);
    if (id < 0) continue;
    if constexpr (kVec) {
      const float4 q = *reinterpret_cast<const float4*>(acc + id * dim + 4 * u);
      const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(q.x, q.y),
                                   __floats2bfloat162_rn(q.z, q.w)};
      *reinterpret_cast<uint2*>(dtable + id * dim + 4 * u) = *reinterpret_cast<const uint2*>(h);
    } else {
      dtable[id * dim + u] = __float2bfloat16_rn(acc[id * dim + u]);
    }
  }
}

// Path B, float32 dtable: zeros with evict-first 16-byte stores (they keep
// g and the ids in L2 for the scatter), grid-stride over `stride` threads.
__global__ void __launch_bounds__(kThreads)
fill_zero_kernel(float* __restrict__ dtable, int64_t elems) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float4* v = reinterpret_cast<float4*>(dtable);
  const int64_t quads = elems / 4;
  for (int64_t i = t0; i < quads; i += stride) __stcs(v + i, make_float4(0.f, 0.f, 0.f, 0.f));
  for (int64_t i = 4 * quads + t0; i < elems; i += stride) dtable[i] = 0.f;
  let_next_kernel_start();
}

int sm_count() {
  static const int count = [] {
    int device = 0, sms = 132;
    if (cudaGetDevice(&device) == cudaSuccess) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    return sms;
  }();
  return count;
}

int64_t blocks_for(int64_t total, int threads = kThreads) {
  return std::max<int64_t>(1, std::min<int64_t>((total + threads - 1) / threads, 1 << 30));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launches `kernel` on `s`, as a programmatic dependent of the kernel before it
// (it may start early and waits in `wait_for_previous_kernel`).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int64_t blocks, cudaStream_t s,
                             Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kThreads);
  config.stream = s;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

// Path A's launch, after the zeros: columns of at most kSortColumns a block,
// and pairs enough for about kSortItems 4-column adds a thread.
template <typename G, bool kRound>
cudaError_t launch_sorted(const void* g, const int32_t* ids, const float* mask, int64_t n,
                          int64_t pool, int64_t dim, int64_t rows, int fill, float* acc,
                          cudaStream_t s) {
  const int64_t cw = std::min<int64_t>(4 * ((dim + 3) / 4), kSortColumns);
  const int64_t chunk = std::clamp<int64_t>(kSortItems * kThreads / ((cw + 3) / 4), 32,
                                            kSortMaxChunk);
  const int64_t pairs = n * pool;
  const dim3 grid(static_cast<unsigned>((pairs + chunk - 1) / chunk),
                  static_cast<unsigned>((dim + cw - 1) / cw));
  const size_t smem = static_cast<size_t>(rows + 2 * chunk) * sizeof(int);
  const G* gp = static_cast<const G*>(g);
  const int r = static_cast<int>(rows), k = static_cast<int>(chunk), w = static_cast<int>(cw);
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  if (dim % 4 == 0 && aligned16(g) && aligned16(acc)) {
    return cudaLaunchKernelEx(&config, sorted_scatter_kernel<G, kRound, true>, gp, ids, mask, n,
                              pool, dim, r, fill, k, w, acc);
  }
  return cudaLaunchKernelEx(&config, sorted_scatter_kernel<G, kRound, false>, gp, ids, mask, n,
                            pool, dim, r, fill, k, w, acc);
}

template <typename G, bool kRound>
cudaError_t launch_scatter(const void* g, const int32_t* ids, const float* mask, int64_t n,
                           int64_t pool, int64_t dim, int64_t rows, int fill, float* acc,
                           cudaStream_t s) {
  const G* gp = static_cast<const G*>(g);
  if (dim % 4 == 0 && aligned16(g) && aligned16(acc)) {
    return launch_dependent(scatter_add_kernel<G, kRound, kVec>, blocks_for(n * (dim / 4)), s,
                            gp, ids, mask, n, pool, dim, rows, fill, acc);
  }
  if (dim >= kPeelDim) {
    return launch_dependent(scatter_add_kernel<G, kRound, kPeel>, blocks_for(n * (dim / 4 + 2)),
                            s, gp, ids, mask, n, pool, dim, rows, fill, acc);
  }
  return launch_dependent(scatter_add_kernel<G, kRound, kScalar>, blocks_for(n * dim), s, gp,
                          ids, mask, n, pool, dim, rows, fill, acc);
}

template <typename G, bool kRound>
cudaError_t run(const void* g, const int32_t* ids, const float* mask, int64_t n, int64_t pool,
                int64_t dim, int64_t rows, int fill, void* dtable, float* scratch,
                cudaStream_t s) {
  const int64_t pairs = n * pool;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dtable);
  const bool vec = dim % 4 == 0 && aligned16(scratch) && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const int64_t units = pairs * (vec ? dim / 4 : dim);
  if (!kRound) {
    // a thread a 16-byte store where the output dwarfs the ids, else a grid of
    // kFillBlocksPerSM blocks an SM striding over it
    const int64_t elems = rows * dim;
    const bool full = (elems * 4 >= kFullGridBytes && rows >= kFullGridRowsPerId * pairs) ||
                      elems * 4 >= kFullGridAlwaysBytes;
    const int64_t grid = blocks_for(elems / 4 + 1);
    fill_zero_kernel<<<full ? grid : std::min<int64_t>(grid, kFillBlocksPerSM * sm_count()),
                       kThreads, 0, s>>>(static_cast<float*>(dtable), elems);
  } else {
    const int64_t blocks =
        std::min<int64_t>(blocks_for(std::max(rows * dim / 8, units)), 16 * sm_count());
    if (vec) {
      zero_bf16_kernel<true><<<blocks, kThreads, 0, s>>>(ids, pairs, dim, rows, fill, out,
                                                         scratch);
    } else {
      zero_bf16_kernel<false><<<blocks, kThreads, 0, s>>>(ids, pairs, dim, rows, fill, out,
                                                          scratch);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* acc = kRound ? scratch : static_cast<float*>(dtable);
  const bool sorted =
      rows <= kSortRows && (pairs >= kSortAddsPerRow * rows || dim * pairs >= kSortMinWork);
  err = sorted ? launch_sorted<G, kRound>(g, ids, mask, n, pool, dim, rows, fill, acc, s)
               : launch_scatter<G, kRound>(g, ids, mask, n, pool, dim, rows, fill, acc, s);
  if (err != cudaSuccess || !kRound) return err;
  if (vec) {
    return launch_dependent(round_rows_kernel<true>, blocks_for(units), s, ids, pairs, dim, rows,
                            fill, scratch, out);
  }
  return launch_dependent(round_rows_kernel<false>, blocks_for(units), s, ids, pairs, dim, rows,
                          fill, scratch, out);
}

}  // namespace

// g_dtype, table_dtype: 0 = float32, 1 = bfloat16; a bfloat16 g into a
// float32 dtable is refused.  fill: 1 wraps negative ids once (K1's fill
// mode), 0 drops them.  dtable (rows, dim) is overwritten.  scratch: float32
// (rows, dim), needed for a bfloat16 dtable (paths B and C sum its touched
// rows there) and ignored for a float32 one.  Returns the first CUDA error
// (0 = success).  Works on `stream` and allocates nothing.
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
  cudaError_t err;
  if (table_dtype == 0) {
    err = run<float, false>(g, ids, mask, n, pool, dim, rows, fill, dtable, scratch, s);
  } else if (g_dtype == 0) {
    err = run<float, true>(g, ids, mask, n, pool, dim, rows, fill, dtable, scratch, s);
  } else {
    err = run<__nv_bfloat16, true>(g, ids, mask, n, pool, dim, rows, fill, dtable, scratch, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* pr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
