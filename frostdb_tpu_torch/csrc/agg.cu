// Fused filter + group-by aggregation kernels for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in frostdb_tpu/ops/pallas_agg.py:
//   sum_count_kernel<kSel>      pallas_group_sum_count (K2)
//   sum_count_kernel<kBand, n>  pallas_fused_band_group_sum_count (K1)
//   sum_count_kernel<kCmp8>     pallas_fused_cmp_group_sum_count (K4)
//   sum_count_kernel<kBand, 1, FIRST = false>
//                               pallas_filter_group_sum_count (K5): one
//                               `ts >= literal` clause, sums and counts only
//                               (no first-row table)
//   group_min_max_kernel        pallas_group_min_max (K3)
//
// Inputs are flat int32 planes of n rows (the compiled layer's [slabs, 128]
// planes, read contiguously); codes of selected rows lie in [0, num_codes),
// num_codes <= 2048. Rows whose code falls outside that range contribute
// nothing, as in the one-hot formulation.
//
// Bound on the card: memory. The sum/count kernel reads every predicate
// plane once (4 B a row, 1 B for the int8 base plane of kCmp8) and the code
// and value of each selected row; the per-code tables are a few KB. What
// keeps a kernel from that bound is same-address contention: compacted
// parts are sorted by label, so neighbouring rows share a code, and a key
// such as `value > T` folds all rows into 2 codes. The design of the
// sum/count template takes that away in four parts:
//  1. Loads. A lane reads 4 neighbouring rows of each predicate plane as one
//     16-byte vector, two vectors at a time, and turns them into a 4-bit
//     selection mask in registers. It loads the code and value vectors only
//     where a row of the vector is selected. A count-only instantiation
//     (no value plane: the distincts and min/max's count pass) reads no
//     values. Planes that are not 16-byte aligned (the int8 plane: 4-byte)
//     take the same kernel with scalar loads.
//  2. Runs in registers. A lane keeps (code, count, sum, first row) of its
//     current run of equal codes and writes it out only when the code
//     changes, and once at the end. A lane visits its rows in increasing
//     order, so a run's first row is its first selected row.
//  3. Warp-aggregated write-out. When lanes write out in the same step and
//     the first of them shares its code with others (runs that end
//     together on sorted parts, a key of two codes), that code's lanes
//     reduce count, first row and sum across the warp (__reduce_add_sync,
//     __reduce_min_sync; the 64-bit sum as three 32-bit partial sums of
//     bits 0-15, 16-31 and 32-63, none of which can overflow) and one lane
//     writes the entry. The other lanes (codes that differ lane to lane,
//     as in hashed keys) add their own runs with shared atomics.
//  4. Tables sized by num_codes (dynamic shared memory, 16 B a code). Up
//     to 256 codes each warp owns a table, so warps never contend; the
//     block merges its warps' tables at the end. Above 256 codes the block
//     shares one table. Each block then adds its non-empty entries to the
//     outputs with global atomics.
// All accumulation is in integers, so results are bit-exact whatever the
// order of the writes. Sums and counts are int64; the first selected row is
// the exact row index (not a superblock).
//
// Each C entry returns cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCodes = 2048;
constexpr int kThreads = 512;      // group_min_max_kernel
constexpr int kBlocksPerSm = 4;    // group_min_max_kernel
constexpr int kSumThreads = 256;   // sum_count_kernel
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumMinBlocks = 4;   // blocks an SM holds: 64 registers a thread
constexpr int kUnroll = 2;         // vectors a lane loads per step
constexpr int kWarpTableCodes = 256;
constexpr int kInt32Max = 0x7fffffff;
constexpr int kInt32Min = -0x7fffffff - 1;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kSel = 0, kBand = 1, kCmp8 = 2 };

// Each compare clause is a range test, lo <= x <= hi, negated for kCmp8's
// `!=` (inv = 1). An empty range has lo = INT32_MAX, hi = INT32_MIN.
struct Pred {
  const int* p0;      // kSel: 0/1 selection; kBand: clause 0; kCmp8: compare plane
  const int* p1;      // kBand: clause 1
  const int* p2;      // kBand: clause 2
  const int8_t* b8;   // kCmp8: base-validity plane
  int lo0, lo1, lo2;
  int hi0, hi1, hi2;
  unsigned inv;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const int* p, long long q, int (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p) + q);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldg(p + q);
  }
}

// Bit j set where row j of int8 vector q is nonzero.
template <int VEC>
__device__ __forceinline__ unsigned nonzero8(const int8_t* p, long long q) {
  if constexpr (VEC == 4) {
    const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p) + q);
    return (t & 0xffu ? 1u : 0u) | (t & 0xff00u ? 2u : 0u) |
           (t & 0xff0000u ? 4u : 0u) | (t & 0xff000000u ? 8u : 0u);
  } else {
    return __ldg(p + q) != 0 ? 1u : 0u;
  }
}

template <int VEC>
__device__ __forceinline__ unsigned in_range(const int* p, long long q, int lo, int hi) {
  int x[VEC];
  load_vec<VEC>(p, q, x);
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) m |= (unsigned)(x[j] >= lo && x[j] <= hi) << j;
  return m;
}

// Bit j set where row j of vector q (VEC rows) is selected.
template <int MODE, int NCL, int VEC>
__device__ __forceinline__ unsigned sel_mask(const Pred& p, long long q) {
  constexpr unsigned kAll = (1u << VEC) - 1u;
  if (MODE == kSel) {
    int x[VEC];
    load_vec<VEC>(p.p0, q, x);
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) m |= (unsigned)(x[j] != 0) << j;
    return m;
  }
  unsigned m = in_range<VEC>(p.p0, q, p.lo0, p.hi0);
  if (MODE == kCmp8) return (m ^ (p.inv * kAll)) & nonzero8<VEC>(p.b8, q);
  if (NCL > 1) m &= in_range<VEC>(p.p1, q, p.lo1, p.hi1);
  if (NCL > 2) m &= in_range<VEC>(p.p2, q, p.lo2, p.hi2);
  return m;
}

// A lane's current run of equal codes.
struct Run {
  int code;
  unsigned cnt;
  unsigned long long sum;
  int first;
};

// The per-code table a warp writes its runs to: its own (up to
// kWarpTableCodes codes) or its block's.
struct Table {
  unsigned long long* sum;
  unsigned* cnt;
  int* first;
};

template <bool FIRST, bool VALS>
__device__ __forceinline__ void add_run(const Table& t, int c, unsigned long long sum,
                                        unsigned cnt, int first) {
  if (VALS) atomicAdd(t.sum + c, sum);
  atomicAdd(t.cnt + c, cnt);
  if (FIRST) atomicMin(t.first + c, first);
}

// Warp-collective: the lanes with `go` (`pending`, their ballot) write
// their runs out and start empty runs. If the first of them shares its code
// with another (the runs that end together on sorted parts, a key of few
// codes) or is alone, the lanes of that code are reduced across the warp
// and written once by the first; the reductions run over the whole warp,
// other lanes adding 0, so the warp never splits by code. Every other lane
// writes its own run (codes that differ lane to lane).
template <bool FIRST, bool VALS>
__device__ __forceinline__ void flush(bool go, unsigned pending, Run& r,
                                      const Table& t) {
  const int src = __ffs(pending) - 1;
  const int code = __shfl_sync(kFull, r.code, src);
  const bool in = go && r.code == code;
  const unsigned grp = __ballot_sync(kFull, in);
  bool own = go;  // still to write its own run
  if (grp == pending || __popc(grp) > 1) {
    const unsigned cnt = __reduce_add_sync(kFull, in ? r.cnt : 0u);
    unsigned long long sum = 0;
    if (VALS) {
      const unsigned long long x = in ? r.sum : 0ULL;
      const unsigned b0 = __reduce_add_sync(kFull, (unsigned)x & 0xffffu);
      const unsigned b1 = __reduce_add_sync(kFull, (unsigned)(x >> 16) & 0xffffu);
      const unsigned b2 = __reduce_add_sync(kFull, (unsigned)(x >> 32));
      sum = (unsigned long long)b0 + ((unsigned long long)b1 << 16) +
            ((unsigned long long)b2 << 32);
    }
    const int first = FIRST ? __reduce_min_sync(kFull, in ? r.first : kInt32Max) : 0;
    if ((int)(threadIdx.x & 31) == src) add_run<FIRST, VALS>(t, code, sum, cnt, first);
    own = go && !in;
  }
  if (own) add_run<FIRST, VALS>(t, r.code, r.sum, r.cnt, r.first);
  if (go) {
    r.cnt = 0;
    r.sum = 0;
  }
}

// Warp-collective: one row a lane (`take`: selected, code in range).
template <bool FIRST, bool VALS>
__device__ __forceinline__ void step(bool take, int c, unsigned v, int row,
                                     Run& r, const Table& t) {
  const bool go = take && r.cnt != 0 && c != r.code;
  const unsigned pending = __ballot_sync(kFull, go);
  if (pending) flush<FIRST, VALS>(go, pending, r, t);
  if (take) {
    if (r.cnt == 0) {
      r.code = c;
      if (FIRST) r.first = row;
    }
    r.cnt += 1;
    if (VALS) r.sum += v;
  }
}

// FIRST = false drops the first-row table (K5 has no first-row output);
// VALS = false drops the value plane (sums stay 0). `tables` is kSumWarps
// (a table per warp) or 1 (one per block); dynamic shared memory holds
// tables * num_codes entries of 16 bytes.
template <int MODE, int NCL, bool FIRST, bool VALS, int VEC>
__global__ void __launch_bounds__(kSumThreads, kSumMinBlocks) sum_count_kernel(
    const int* __restrict__ codes, const int* __restrict__ values, Pred pred,
    long long n, int num_codes, unsigned int vmask, int tables,
    unsigned long long* __restrict__ sums,
    unsigned long long* __restrict__ counts, int* __restrict__ first) {
  extern __shared__ unsigned long long s_sum[];
  const int entries = tables * num_codes;
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_sum + entries);
  int* s_first = reinterpret_cast<int*>(s_cnt + entries);
  for (int k = threadIdx.x; k < entries; k += kSumThreads) {
    s_sum[k] = 0ULL;
    s_cnt[k] = 0u;
    s_first[k] = kInt32Max;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = tables > 1 ? warp * num_codes : 0;
  const Table t = {s_sum + base, s_cnt + base, s_first + base};
  Run r = {0, 0u, 0ULL, kInt32Max};

  // A warp takes 32 * kUnroll neighbouring vectors a step; the loop bound is
  // the same for its lanes, so the warp-collective steps see all 32.
  const long long nvec = n / VEC;
  constexpr long long kSpan = 32LL * kUnroll;
  const long long stride = (long long)gridDim.x * kSumWarps * kSpan;
  for (long long q0 = ((long long)blockIdx.x * kSumWarps + warp) * kSpan;
       q0 < nvec; q0 += stride) {
    unsigned m[kUnroll];
    int c[kUnroll][VEC];
    int v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * 32 + lane;
      m[u] = q < nvec ? sel_mask<MODE, NCL, VEC>(pred, q) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) c[u][j] = v[u][j] = 0;
      if (m[u]) {
        const long long q = q0 + u * 32 + lane;
        load_vec<VEC>(codes, q, c[u]);
        if (VALS) load_vec<VEC>(values, q, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row0 = (int)((q0 + u * 32 + lane) * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool take =
            ((m[u] >> j) & 1u) && (unsigned)c[u][j] < (unsigned)num_codes;
        step<FIRST, VALS>(take, c[u][j], (unsigned)v[u][j] & vmask, row0 + j, r, t);
      }
    }
  }
  // The last n % VEC rows: one step of block 0's first warp.
  if (VEC > 1 && blockIdx.x == 0 && warp == 0) {
    const long long row = nvec * VEC + lane;
    bool take = false;
    int c = 0;
    unsigned v = 0;
    if (row < n && sel_mask<MODE, NCL, 1>(pred, row)) {
      c = codes[row];
      if (VALS) v = (unsigned)values[row] & vmask;
      take = (unsigned)c < (unsigned)num_codes;
    }
    step<FIRST, VALS>(take, c, v, (int)row, r, t);
  }
  const bool go = r.cnt != 0;
  const unsigned pending = __ballot_sync(kFull, go);
  if (pending) flush<FIRST, VALS>(go, pending, r, t);
  __syncthreads();

  for (int k = threadIdx.x; k < num_codes; k += kSumThreads) {
    unsigned long long s = 0ULL, cnt = 0ULL;
    int f = kInt32Max;
    for (int w = 0; w < tables; ++w) {
      const int i = w * num_codes + k;
      if (VALS) s += s_sum[i];
      cnt += s_cnt[i];
      if (FIRST) f = min(f, s_first[i]);
    }
    if (cnt != 0ULL) {
      if (VALS) atomicAdd(&sums[k], s);
      atomicAdd(&counts[k], cnt);
      if (FIRST) atomicMin(&first[k], f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) group_min_max_kernel(
    const int* __restrict__ codes, const int* __restrict__ values,
    const int* __restrict__ sel, long long n, int num_codes,
    int* __restrict__ mins, int* __restrict__ maxs) {
  __shared__ int s_min[kMaxCodes];
  __shared__ int s_max[kMaxCodes];
  for (int k = threadIdx.x; k < num_codes; k += blockDim.x) {
    s_min[k] = kInt32Max;
    s_max[k] = kInt32Min;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (sel[i] <= 0) continue;
    const int c = codes[i];
    if ((unsigned)c >= (unsigned)num_codes) continue;
    const int v = values[i];
    atomicMin(&s_min[c], v);
    atomicMax(&s_max[c], v);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < num_codes; k += blockDim.x) {
    if (s_min[k] != kInt32Max) atomicMin(&mins[k], s_min[k]);
    if (s_max[k] != kInt32Min) atomicMax(&maxs[k], s_max[k]);
  }
}

unsigned int grid_size(long long n, int num_sms) {
  long long blocks = (n + kThreads - 1) / kThreads;
  long long cap = (long long)num_sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned int)blocks;
}

// Clause `x <op> lit` (op codes: 0 <, 1 <=, 2 >, 3 >=, 4 ==, 5 !=) as a
// range; `!=` is `==` negated.
void set_clause(int op, int lit, int* lo, int* hi, unsigned* inv) {
  *lo = kInt32Min;
  *hi = kInt32Max;
  switch (op) {
    case 0:
      if (lit == kInt32Min) *lo = kInt32Max, *hi = kInt32Min;
      else *hi = lit - 1;
      break;
    case 1: *hi = lit; break;
    case 2:
      if (lit == kInt32Max) *lo = kInt32Max, *hi = kInt32Min;
      else *lo = lit + 1;
      break;
    case 3: *lo = lit; break;
    default:
      *lo = *hi = lit;
      if (op == 5 && inv != nullptr) *inv = 1u;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || ((uintptr_t)p & (bytes - 1)) == 0;
}

template <int MODE, int NCL, bool FIRST, bool VALS, int VEC>
int launch_vec(const int* codes, const int* values, const Pred& p, long long n,
               int num_codes, unsigned vmask, unsigned long long* sums,
               unsigned long long* counts, int* first, int num_sms,
               cudaStream_t stream) {
  const int tables = num_codes <= kWarpTableCodes ? kSumWarps : 1;
  const size_t smem = (size_t)tables * num_codes *
                      (sizeof(unsigned long long) + sizeof(unsigned) + sizeof(int));
  // kSumMinBlocks blocks fit an SM: registers by the launch bounds, shared
  // memory (at most 32 KB a block) by far.
  const long long rows_per_block = (long long)kSumThreads * kUnroll * VEC;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)num_sms * kSumMinBlocks;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  sum_count_kernel<MODE, NCL, FIRST, VALS, VEC>
      <<<dim3((unsigned)blocks), kSumThreads, smem, stream>>>(
          codes, values, p, n, num_codes, vmask, tables, sums, counts, first);
  return (int)cudaGetLastError();
}

// 16-byte vectors where every plane allows them (the int8 plane: 4 bytes),
// scalar loads otherwise.
template <int MODE, int NCL, bool FIRST, bool VALS>
int launch_sum_count(const int* codes, const int* values, const Pred& p,
                     long long n, int num_codes, unsigned vmask,
                     unsigned long long* sums, unsigned long long* counts,
                     int* first, int num_sms, cudaStream_t stream) {
  const bool vec = aligned(codes, 16) && aligned(values, 16) &&
                   aligned(p.p0, 16) && aligned(p.p1, 16) &&
                   aligned(p.p2, 16) && aligned(p.b8, 4);
  if (vec)
    return launch_vec<MODE, NCL, FIRST, VALS, 4>(
        codes, values, p, n, num_codes, vmask, sums, counts, first, num_sms, stream);
  return launch_vec<MODE, NCL, FIRST, VALS, 1>(
      codes, values, p, n, num_codes, vmask, sums, counts, first, num_sms, stream);
}

template <int MODE, int NCL>
int launch_first(const int* codes, const int* values, const Pred& p,
                 long long n, int num_codes, unsigned vmask,
                 unsigned long long* sums, unsigned long long* counts,
                 int* first, int num_sms, cudaStream_t stream) {
  if (values == nullptr)
    return launch_sum_count<MODE, NCL, true, false>(
        codes, values, p, n, num_codes, vmask, sums, counts, first, num_sms, stream);
  return launch_sum_count<MODE, NCL, true, true>(
      codes, values, p, n, num_codes, vmask, sums, counts, first, num_sms, stream);
}

}  // namespace

// Sums, counts and the first selected row per code. The caller fills sums
// and counts with 0 and first with INT32_MAX before the launch. With
// values = NULL the kernel counts only (sums stay 0).
extern "C" int fdb_group_sum_count(
    int mode, int n_cl, const void* codes, const void* values, const void* p0,
    const void* p1, const void* p2, const void* base8, int op0, int op1,
    int op2, int lit0, int lit1, int lit2, long long n, int num_codes,
    unsigned int vmask, void* sums, void* counts, void* first, int num_sms,
    void* stream) {
  if (num_codes < 1 || num_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Pred p = {};
  p.p0 = (const int*)p0;
  p.p1 = (const int*)p1;
  p.p2 = (const int*)p2;
  p.b8 = (const int8_t*)base8;
  if (mode != kSel) {
    set_clause(op0, lit0, &p.lo0, &p.hi0, mode == kCmp8 ? &p.inv : nullptr);
    set_clause(op1, lit1, &p.lo1, &p.hi1, nullptr);
    set_clause(op2, lit2, &p.lo2, &p.hi2, nullptr);
  }
  const int* c = (const int*)codes;
  const int* v = (const int*)values;
  unsigned long long* su = (unsigned long long*)sums;
  unsigned long long* cu = (unsigned long long*)counts;
  int* fi = (int*)first;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kSel)
    return launch_first<kSel, 1>(c, v, p, n, num_codes, vmask, su, cu, fi, num_sms, s);
  if (mode == kBand && n_cl == 1)
    return launch_first<kBand, 1>(c, v, p, n, num_codes, vmask, su, cu, fi, num_sms, s);
  if (mode == kBand && n_cl == 2)
    return launch_first<kBand, 2>(c, v, p, n, num_codes, vmask, su, cu, fi, num_sms, s);
  if (mode == kBand && n_cl == 3)
    return launch_first<kBand, 3>(c, v, p, n, num_codes, vmask, su, cu, fi, num_sms, s);
  if (mode == kCmp8)
    return launch_first<kCmp8, 1>(c, v, p, n, num_codes, vmask, su, cu, fi, num_sms, s);
  return (int)cudaErrorInvalidValue;
}

// Sums and counts per code over rows with ts >= lit (K5). The caller fills
// sums and counts with 0 before the launch.
extern "C" int fdb_filter_group_sum_count(
    const void* codes, const void* values, const void* ts, int lit,
    long long n, int num_codes, unsigned int vmask, void* sums, void* counts,
    int num_sms, void* stream) {
  if (num_codes < 1 || num_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Pred p = {};
  p.p0 = (const int*)ts;
  set_clause(3, lit, &p.lo0, &p.hi0, nullptr);  // >=
  return launch_sum_count<kBand, 1, false, true>(
      (const int*)codes, (const int*)values, p, n, num_codes, vmask,
      (unsigned long long*)sums, (unsigned long long*)counts, nullptr, num_sms,
      (cudaStream_t)stream);
}

// Min and max per code over rows with sel > 0. The caller fills mins with
// INT32_MAX and maxs with INT32_MIN before the launch.
extern "C" int fdb_group_min_max(const void* codes, const void* values,
                                 const void* sel, long long n, int num_codes,
                                 void* mins, void* maxs, int num_sms,
                                 void* stream) {
  if (num_codes < 1 || num_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const dim3 grid(grid_size(n, num_sms));
  group_min_max_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)values, (const int*)sel, n, num_codes,
      (int*)mins, (int*)maxs);
  return (int)cudaGetLastError();
}
