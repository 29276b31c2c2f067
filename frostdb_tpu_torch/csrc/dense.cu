// The dense tier's segment reduction for Hopper (sm_90a):
// dense_segment_sum_count, one pass over one part (or one shard of it) for
// the per-code count, first selected row and int64 sum of a group-by of at
// most 4,096 codes (parallel/mesh_exec.py, the segment route).
//
// It replaces no Pallas kernel: the JAX package leaves this reduction to
// XLA's segment_sum (three segment reductions a part). The port's plain
// version is ops/kernels.dense_group_reduce, three scatter_reduce_ calls
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
// The C entry returns cudaGetLastError() after its launch (0 = launched).

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

// As many blocks as fit the card at once, each on a contiguous chunk of a
// whole number of steps.
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
  if (per_sm < 1) per_sm = 1;
  const long long nvec = j.n / VEC;
  long long blocks = (nvec + kSpan - 1) / kSpan;
  const long long cap = (long long)j.num_sms * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  long long chunk = ((nvec + blocks - 1) / blocks + kSpan - 1) / kSpan * kSpan;
  if (chunk < kSpan) chunk = kSpan;
  blocks = nvec > 0 ? (nvec + chunk - 1) / chunk : 1;
  dense_segment_kernel<VEC, VALS><<<dim3((unsigned)blocks), kThreads, smem, j.stream>>>(
      j.codes, j.sel, j.values, j.n, j.num_codes, chunk, j.row_base, j.counts,
      j.first, j.sums);
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
