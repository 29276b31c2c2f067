// The dense tier's one-pass reductions for Hopper (sm_90a), one part (or
// one shard of it) a launch, into per-code counts, first selected rows and
// int64 sums (parallel/mesh_exec.py):
//  - dense_segment_sum_count (K7), the segment route, at most 4,096 codes,
//    its tables in shared memory;
//  - dense_table_sum_count (K8), the table route, 4,096 < K <= 2^20 codes
//    of sums and counts only, its tables in device memory (below).
//
// Neither replaces a Pallas kernel: the JAX package leaves these reductions
// to XLA (segment_sum; a sort and prefix sums past 4,096 codes).
//
// dense_segment_sum_count. The port's plain version is
// ops/kernels.dense_group_reduce, three scatter_reduce_ calls
// with int64 global atomics, each over every padded row with about 110
// bytes of temporaries a row.
//
// Inputs: the int32 codes, the bool selection read as bytes, zero or one
// int64 value plane, the live row count n (rows past it are not read),
// row_base (added to the first row) and num_codes <= 4,096. Outputs: counts,
// first and sums, [num_codes] int64 each, filled by the caller with 0,
// INT64_MAX and 0. Selected rows whose code lies outside [0, num_codes)
// contribute nothing.
//
// Bound on the card: memory. A live row costs its code (4 B), its selection
// byte (1 B) and its value (8 B): 13 B a row, plus the [K] outputs. The
// arithmetic is a handful of integer ops a row.
//
// What keeps such a reduction from its bound is writing rows into the
// tables. The parts the dense tier reads are sorted by label, and within a
// label by time, so the selected rows of one (label, time window) code come
// in runs of thousands of rows (Parca's fleet by node and minute: 16,380):
// a scatter with global atomics queues every row of a run on one address.
// The design, after csrc/agg.cu's group_kernel:
//  1. Contiguous chunks. Each block takes one contiguous range of the part,
//     and its lanes read neighbouring 16-byte vectors of it a step, so
//     loads stay coalesced while a lane's rows in one step and the next lie
//     2,048 rows apart: a lane stays in one code for most of a run, and a
//     block's write-out touches only the few codes of its range. (A grid
//     stride, as group_kernel has, puts every block in every code and ends
//     a lane's run at each step: PERF.md has both times.)
//  2. Loads of 16 bytes a lane, streaming (__ldcs: each byte is read once).
//     The code and value vectors are read only where the selection vector
//     holds a selected row.
//  3. Runs in registers. A lane keeps its run (code, count, 64-bit sum,
//     first row) and writes it out when the code changes, and once at the
//     end, with native 32-bit shared atomics: the sum as its low word, then
//     its high word plus the carry out of the low one where either is not 0
//     (a 64-bit shared atomicAdd is a compare-and-swap loop); the first row
//     by atomicMin.
//  4. One block table of num_codes x 16 B (64 KB at 4,096 codes: dynamic
//     shared memory past the default 48 KB). After the block's last write it
//     adds its non-empty entries to the outputs with global atomics.
// Sums wrap modulo 2^64, as int64 adds do, so every result is exact
// whatever the order of the writes.
//
// Each C entry returns cudaGetLastError() after its launches (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCodes = 4096;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors a lane loads per step
// Vectors a block takes per step.
constexpr long long kSpan = (long long)kThreads * kUnroll;
constexpr int kInt32Max = 0x7fffffff;

template <int VEC>
__device__ __forceinline__ unsigned sel_mask(const int8_t* p, long long q) {
  if constexpr (VEC == 4) {
    const unsigned t = __ldcs(reinterpret_cast<const unsigned*>(p) + q);
    return (t & 0xffu ? 1u : 0u) | (t & 0xff00u ? 2u : 0u) |
           (t & 0xff0000u ? 4u : 0u) | (t & 0xff000000u ? 8u : 0u);
  } else {
    return __ldcs(p + q) != 0 ? 1u : 0u;
  }
}

template <int VEC>
__device__ __forceinline__ void load_codes(const int* p, long long q, int (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p) + q);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldcs(p + q);
  }
}

template <int VEC>
__device__ __forceinline__ void load_values(const long long* p, long long q, long long (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p) + 2 * q);
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 2 * q + 1);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else {
    x[0] = __ldcs(p + q);
  }
}

// A lane's run of equal codes, and the block table it writes into: each
// code's sum as low and high words, its count and its first row.
template <bool VALS>
struct Run {
  unsigned* s_lo;
  unsigned* s_hi;
  unsigned* s_cnt;
  int* s_first;
  int code = 0;
  unsigned cnt = 0;
  unsigned long long sum = 0;
  int first = kInt32Max;

  __device__ void write() {
    if (VALS) {
      const unsigned lo = (unsigned)sum;
      const unsigned old = atomicAdd(s_lo + code, lo);
      const unsigned hi = (unsigned)(sum >> 32) + (old + lo < old ? 1u : 0u);
      if (hi != 0u) atomicAdd(s_hi + code, hi);
    }
    atomicAdd(s_cnt + code, cnt);
    atomicMin(s_first + code, first);
    cnt = 0;
    sum = 0;
  }
  // One row (`take`: selected, code in range). A lane visits its rows in
  // increasing order, so a run's first row is its first selected row.
  __device__ __forceinline__ void step(bool take, int c, long long v, int row) {
    if (!take) return;
    if (cnt != 0 && c != code) write();
    if (cnt == 0) {
      code = c;
      first = row;
    }
    cnt += 1;
    if (VALS) sum += (unsigned long long)v;
  }
};

// Block b reads vectors [b * chunk, (b + 1) * chunk) of the n / VEC whole
// vectors; the last block also the n % VEC rows past them, a row a lane.
template <int VEC, bool VALS>
__global__ void __launch_bounds__(kThreads) dense_segment_kernel(
    const int* __restrict__ codes, const int8_t* __restrict__ sel,
    const long long* __restrict__ values, long long n, int num_codes,
    long long chunk, long long row_base, unsigned long long* __restrict__ counts,
    long long* __restrict__ first, unsigned long long* __restrict__ sums) {
  extern __shared__ unsigned smem[];
  Run<VALS> r;
  r.s_lo = smem;
  r.s_hi = smem + num_codes;
  r.s_cnt = smem + 2 * num_codes;
  r.s_first = reinterpret_cast<int*>(smem + 3 * num_codes);
  for (int k = threadIdx.x; k < num_codes; k += kThreads) {
    r.s_lo[k] = 0u;
    r.s_hi[k] = 0u;
    r.s_cnt[k] = 0u;
    r.s_first[k] = kInt32Max;
  }
  __syncthreads();

  const long long nvec = n / VEC;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < nvec ? begin + chunk : nvec;
  for (long long q0 = begin; q0 < end; q0 += kSpan) {
    unsigned m[kUnroll];
    int c[kUnroll][VEC];
    long long v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * kThreads + threadIdx.x;
      m[u] = q < end ? sel_mask<VEC>(sel, q) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        c[u][j] = 0;
        v[u][j] = 0;
      }
      if (m[u]) {
        const long long q = q0 + u * kThreads + threadIdx.x;
        load_codes<VEC>(codes, q, c[u]);
        if (VALS) load_values<VEC>(values, q, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row0 = (int)((q0 + u * kThreads + threadIdx.x) * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool take = ((m[u] >> j) & 1u) && (unsigned)c[u][j] < (unsigned)num_codes;
        r.step(take, c[u][j], v[u][j], row0 + j);
      }
    }
  }
  if (VEC > 1 && blockIdx.x == gridDim.x - 1) {
    const long long row = nvec * VEC + threadIdx.x;
    if (row < n && sel[row] != 0) {
      const int c = codes[row];
      r.step((unsigned)c < (unsigned)num_codes, c, VALS ? values[row] : 0, (int)row);
    }
  }
  if (r.cnt != 0) r.write();
  __syncthreads();

  for (int k = threadIdx.x; k < num_codes; k += kThreads) {
    const unsigned cnt = r.s_cnt[k];
    if (cnt == 0u) continue;
    atomicAdd(&counts[k], (unsigned long long)cnt);
    if (VALS) atomicAdd(&sums[k], (unsigned long long)r.s_hi[k] << 32 | r.s_lo[k]);
    atomicMin(&first[k], row_base + r.s_first[k]);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || ((uintptr_t)p & (bytes - 1)) == 0;
}

struct Job {
  const int* codes;
  const int8_t* sel;
  const long long* values;  // null: count only
  long long n;
  long long row_base;
  int num_codes;
  unsigned long long* counts;
  long long* first;
  unsigned long long* sums;
  int num_sms;
  cudaStream_t stream;
};

// As many blocks as fit the card at once (per_sm a multiprocessor), each on
// a contiguous chunk of a whole number of steps of the nvec vectors.
void grid(long long nvec, int num_sms, int per_sm, long long& blocks, long long& chunk) {
  if (per_sm < 1) per_sm = 1;
  blocks = (nvec + kSpan - 1) / kSpan;
  const long long cap = (long long)num_sms * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  chunk = ((nvec + blocks - 1) / blocks + kSpan - 1) / kSpan * kSpan;
  if (chunk < kSpan) chunk = kSpan;
  blocks = nvec > 0 ? (nvec + chunk - 1) / chunk : 1;
}

template <int VEC, bool VALS>
int launch(const Job& j) {
  void (*kernel)(const int*, const int8_t*, const long long*, long long, int,
                 long long, long long, unsigned long long*, long long*,
                 unsigned long long*) = dense_segment_kernel<VEC, VALS>;
  const size_t smem = (size_t)j.num_codes * 4 * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks, chunk;
  grid(j.n / VEC, j.num_sms, per_sm, blocks, chunk);
  dense_segment_kernel<VEC, VALS><<<dim3((unsigned)blocks), kThreads, smem, j.stream>>>(
      j.codes, j.sel, j.values, j.n, j.num_codes, chunk, j.row_base, j.counts,
      j.first, j.sums);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dense_table_sum_count (K8): the table route, 4,096 < num_codes <= 2^20 and
// every partial an int64 sum. Its plain version,
// ops/agg_kernels.dense_table_sum_count_plain, is one scatter_reduce_ for
// the counts, one for the first rows and one a sum over the selected rows;
// the route took ops/kernels.sorted_group_reduce before it (a stable radix
// sort of every padded row, two searchsorted over [K], a prefix sum and
// gathers a sum).
//
// Inputs and outputs as K7's, with 0 to S int64 value planes (sums: S rows
// of num_codes). Bound: memory, 5 B a live row (code and selection byte)
// and 8 B a sum plane of each selected row, plus the [K] outputs.
//
// The tables do not fit in shared memory (3 MB at Parca's 131,072 stacks
// and one sum, 6 MB at TSBS's 64,000 (host, hour) codes and ten sums), but
// they fit in the card's 50 MB L2, so the writes are global atomics that
// resolve there: RED.64 for counts and sums (native on global memory), and
// atomicMin for first rows. The design, after K7:
//  1. Contiguous chunks a block and 16-byte streaming loads of the codes
//     and the selection, codes read only under a selected row, as K7.
//  2. Runs in registers, as K7: a lane keeps (code, count, first row, a
//     64-bit sum a plane) and writes it out when its code changes. TSBS's
//     (host, hour) codes come in runs of 360 rows; Parca's stacks change
//     nearly every row.
//  3. Hot codes. Stacks are drawn at Zipf 1.1, so the most frequent takes
//     some 13% of the rows, and atomics on one address queue in its L2
//     slice. Before a write-out reaches an atomic, the lanes of the warp
//     that write the same code combine (__match_any_sync; the counts and
//     first rows by __reduce_*_sync, the 64-bit sums by four 16-bit limbs,
//     each exact in 32 bits) and their lowest lane writes the sum.
//  4. Value planes read under each selected row, by plain loads that keep
//     the row's 32-byte sector in L1 for the vector's next rows. One pass
//     reads a row's code and selection once for up to kMaxPlanes sums (TSBS
//     has ten); past that, further passes add the next planes' sums.

constexpr int kMaxPlanes = 12;

struct Planes {
  const long long* p[kMaxPlanes];
};

// The sum of v over the lanes of g, modulo 2^64.
__device__ __forceinline__ unsigned long long group_sum(unsigned g, unsigned long long v) {
  unsigned long long s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned limb = (unsigned)(v >> (16 * k)) & 0xffffu;
    s += (unsigned long long)__reduce_add_sync(g, limb) << (16 * k);
  }
  return s;
}

// A lane's run of equal codes, written out into the [K] tables. ``ns`` of
// the PLANES sums are live; ``counts_too`` is false on the passes past the
// first kMaxPlanes planes.
template <int PLANES>
struct TableRun {
  unsigned long long* counts;
  long long* first;
  unsigned long long* sums;
  long long row_base;
  int num_codes;
  int ns;
  bool counts_too;
  unsigned lane;
  int code = 0;
  unsigned cnt = 0;
  int first_row = kInt32Max;
  unsigned long long acc[PLANES] = {};

  // Warp-collective (every lane of the warp calls it): the lanes with
  // `need` write their runs out, combined by code.
  __device__ __forceinline__ void write(bool need) {
    const unsigned writers = __ballot_sync(0xffffffffu, need);
    if (!need) return;
    const unsigned g = __match_any_sync(writers, code);
    const bool alone = g == (1u << lane);
    const bool leader = (unsigned)(__ffs(g) - 1) == lane;
    if (counts_too) {
      const unsigned c = alone ? cnt : __reduce_add_sync(g, cnt);
      const int f = alone ? first_row : __reduce_min_sync(g, first_row);
      if (leader) {
        atomicAdd(counts + code, (unsigned long long)c);
        atomicMin(first + code, row_base + f);
      }
    }
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      if (p < ns) {
        const unsigned long long s = alone ? acc[p] : group_sum(g, acc[p]);
        if (leader) atomicAdd(sums + (long long)p * num_codes + code, s);
        acc[p] = 0;
      }
    }
    cnt = 0;
  }

  // One row (`take`: selected, code in range), in the lane's increasing
  // row order; warp-collective.
  __device__ __forceinline__ void step(bool take, int c, long long row, const Planes& planes) {
    write(take && cnt != 0 && c != code);
    if (!take) return;
    if (cnt == 0) {
      code = c;
      first_row = (int)row;
    }
    cnt += 1;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      if (p < ns) acc[p] += (unsigned long long)__ldg(planes.p[p] + row);
    }
  }
};

template <int VEC, int PLANES>
__global__ void __launch_bounds__(kThreads) dense_table_kernel(
    const int* __restrict__ codes, const int8_t* __restrict__ sel, const Planes planes,
    int ns, bool counts_too, long long n, int num_codes, long long chunk,
    long long row_base, unsigned long long* __restrict__ counts,
    long long* __restrict__ first, unsigned long long* __restrict__ sums) {
  TableRun<PLANES> r;
  r.counts = counts;
  r.first = first;
  r.sums = sums;
  r.row_base = row_base;
  r.num_codes = num_codes;
  r.ns = ns;
  r.counts_too = counts_too;
  r.lane = threadIdx.x & 31u;

  const long long nvec = n / VEC;
  const long long from = (long long)blockIdx.x * chunk;
  const long long to = from + chunk < nvec ? from + chunk : nvec;
  for (long long q0 = from; q0 < to; q0 += kSpan) {
    unsigned m[kUnroll];
    int c[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * kThreads + threadIdx.x;
      m[u] = q < to ? sel_mask<VEC>(sel, q) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) c[u][j] = 0;
      if (m[u]) load_codes<VEC>(codes, q0 + u * kThreads + threadIdx.x, c[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row0 = (q0 + u * kThreads + threadIdx.x) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool take = ((m[u] >> j) & 1u) && (unsigned)c[u][j] < (unsigned)num_codes;
        r.step(take, c[u][j], row0 + j, planes);
      }
    }
  }
  if (VEC > 1 && blockIdx.x == gridDim.x - 1) {
    // the n % VEC rows past the whole vectors, a row a lane
    const long long row = nvec * VEC + threadIdx.x;
    const int c = row < n && sel[row] != 0 ? codes[row] : -1;
    r.step((unsigned)c < (unsigned)num_codes, c, row, planes);
  }
  r.write(r.cnt != 0);
}

struct TableJob {
  const int* codes;
  const int8_t* sel;
  long long n;
  long long row_base;
  int num_codes;
  unsigned long long* counts;
  long long* first;
  int num_sms;
  cudaStream_t stream;
};

template <int VEC, int PLANES>
int launch_table(const TableJob& j, const Planes& planes, int ns, bool counts_too,
                 unsigned long long* sums) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dense_table_kernel<VEC, PLANES>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  long long blocks, chunk;
  grid(j.n / VEC, j.num_sms, per_sm, blocks, chunk);
  dense_table_kernel<VEC, PLANES><<<dim3((unsigned)blocks), kThreads, 0, j.stream>>>(
      j.codes, j.sel, planes, ns, counts_too, j.n, j.num_codes, chunk, j.row_base,
      j.counts, j.first, sums);
  return (int)cudaGetLastError();
}

}  // namespace

// Counts, first selected rows (+ row_base) and sums per code over the first
// n rows. The caller fills counts and sums with 0 and first with INT64_MAX
// before the launch. With values = NULL the kernel counts only (sums stay
// 0). 16-byte vectors where the code and value planes are 16-byte aligned
// and the selection 4-byte aligned, scalar loads otherwise.
extern "C" int fdb_dense_segment_sum_count(
    const void* codes, const void* sel, const void* values, long long n,
    long long row_base, int num_codes, void* counts, void* first, void* sums,
    int num_sms, void* stream) {
  if (num_codes < 1 || num_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Job j = {(const int*)codes, (const int8_t*)sel, (const long long*)values,
                 n, row_base, num_codes, (unsigned long long*)counts,
                 (long long*)first, (unsigned long long*)sums, num_sms,
                 (cudaStream_t)stream};
  const bool vec = aligned(codes, 16) && aligned(values, 16) && aligned(sel, 4);
  if (values == nullptr) {
    return vec ? launch<4, false>(j) : launch<1, false>(j);
  }
  return vec ? launch<4, true>(j) : launch<1, true>(j);
}

// Counts, first selected rows (+ row_base) and num_values sums per code over
// the first n rows, for any num_codes >= 1 (tables in device memory).
// values: a host array of num_values device pointers to int64 planes; sums:
// num_values rows of num_codes. The caller fills counts and sums with 0 and
// first with INT64_MAX before the launch. The first pass takes the counts,
// the first rows and up to kMaxPlanes sums; each further pass the next
// kMaxPlanes sums. 16-byte code vectors where the codes are 16-byte aligned
// and the selection 4-byte aligned, scalar loads otherwise.
extern "C" int fdb_dense_table_sum_count(
    const void* codes, const void* sel, const void* const* values, int num_values,
    long long n, long long row_base, int num_codes, void* counts, void* first,
    void* sums, int num_sms, void* stream) {
  if (num_codes < 1 || num_values < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const TableJob j = {(const int*)codes, (const int8_t*)sel, n, row_base, num_codes,
                      (unsigned long long*)counts, (long long*)first, num_sms,
                      (cudaStream_t)stream};
  const bool vec = aligned(codes, 16) && aligned(sel, 4);
  int p0 = 0;
  do {
    const int ns = num_values - p0 < kMaxPlanes ? num_values - p0 : kMaxPlanes;
    Planes planes = {};
    for (int p = 0; p < ns; ++p) planes.p[p] = (const long long*)values[p0 + p];
    unsigned long long* s = (unsigned long long*)sums + (long long)p0 * num_codes;
    const bool counts_too = p0 == 0;
    const int e =
        ns <= 1 ? (vec ? launch_table<4, 1>(j, planes, ns, counts_too, s)
                       : launch_table<1, 1>(j, planes, ns, counts_too, s))
                : (vec ? launch_table<4, kMaxPlanes>(j, planes, ns, counts_too, s)
                       : launch_table<1, kMaxPlanes>(j, planes, ns, counts_too, s));
    if (e != 0) return e;
    p0 += kMaxPlanes;
  } while (p0 < num_values);
  return 0;
}
