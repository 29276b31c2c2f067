// Fused filter + group-by aggregation kernels for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in frostdb_tpu/ops/pallas_agg.py, all
// instantiations of one template, group_kernel<Acc, MODE, NCL, VEC>, by
// accumulator (Acc) and predicate (MODE, NCL clauses):
//   SumCount, kSel               pallas_group_sum_count (K2)
//   SumCount, kBand              pallas_fused_band_group_sum_count (K1)
//   SumCount, kCmp8              pallas_fused_cmp_group_sum_count (K4)
//   SumCount without the first-row table, kBand with one `ts >= literal`
//                                pallas_filter_group_sum_count (K5)
//   MinMax, kPos (sel > 0)       pallas_group_min_max (K3)
//
// Inputs are flat int32 planes of n rows (the compiled layer's [slabs, 128]
// planes, read contiguously); codes of selected rows lie in [0, num_codes),
// num_codes <= 2048. Rows whose code falls outside that range contribute
// nothing, as in the one-hot formulation.
//
// Bound on the card: memory. A kernel reads every predicate plane once (4 B
// a row, 1 B for the int8 base plane of kCmp8) and the code and value of
// each selected row; the per-code tables are a few KB. What keeps a kernel
// from that bound is writing rows into the tables: on sorted parts all 32
// lanes of a warp write the same code at once (compacted parts are sorted by
// label), and on hashed codes (the newest unsorted part, bench.py's data)
// every selected row is written on its own. The template:
//  1. Loads. A lane reads neighbouring rows of each predicate plane as
//     16-byte vectors of 4 rows, two vectors a step, and turns them into a
//     selection mask in registers. It loads the code and value vectors only
//     where a row of the vector is selected. A count-only instantiation (no
//     value plane: the distincts and min/max's count pass) reads no values.
//     Planes that are not 16-byte aligned (the int8 plane: 4-byte) take the
//     same kernel with scalar loads. Every load is streaming (__ldcs: each
//     byte is read once). Warps take their vectors grid-strided, so every
//     warp sees the same mix of selected and padding rows (a contiguous
//     chunk a warp was slower: warps in selected runs wait on more loads).
//  2. Runs in registers. A lane keeps its current run of equal codes (code
//     and count, sum and first row; or min and max) and writes it out only
//     when the code changes, and once at the end. A lane visits its rows in
//     increasing order, so a run's first row is its first selected row.
//  3. Write-out with native 32-bit shared atomics, each lane on its own: no
//     ballot, shuffle or warp reduction, so no lane waits for another. A
//     64-bit shared atomicAdd is a compare-and-swap loop on the card, which
//     32 lanes writing one code (sorted parts) turn into a retry storm, so a
//     sum goes to two 32-bit words: its low word, then its high word and the
//     carry out of the low one where either is not 0. Same-address 32-bit
//     atomics the card serializes in hardware; measured against a warp-wide
//     reduction of the shared code before the write (PERF.md), the plain
//     per-lane write-out was as fast on sorted parts and faster on hashed
//     and two-code keys, for sums and for min/max alike.
//  4. Tables sized by num_codes (dynamic shared memory; 16 B a code for
//     sums, counts and first rows, 8 B for min and max). Up to 256 codes
//     each warp owns a table, so warps never contend; above, the block
//     shares one. Each block then merges its tables and adds its non-empty
//     entries to the outputs with global atomics.
// All accumulation is in integers, so results are bit-exact whatever the
// order of the writes. Sums and counts are int64; the first selected row is
// the exact row index (not a superblock).
//
// Each C entry returns cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCodes = 2048;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;      // blocks an SM holds: 64 registers a thread
constexpr int kUnroll = 2;         // vectors a lane loads per step
constexpr int kWarpTableCodes = 256;
constexpr int kInt32Max = 0x7fffffff;
constexpr int kInt32Min = -0x7fffffff - 1;

enum Mode { kSel = 0, kBand = 1, kCmp8 = 2, kPos = 3 };

// Each compare clause is a range test, lo <= x <= hi, negated for kCmp8's
// `!=` (inv = 1). An empty range has lo = INT32_MAX, hi = INT32_MIN.
struct Pred {
  const int* p0;      // kSel: sel != 0; kPos: sel > 0; kBand: clause 0; kCmp8: compare plane
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
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p) + q);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldcs(p + q);
  }
}

// Bit j set where row j of int8 vector q is nonzero.
template <int VEC>
__device__ __forceinline__ unsigned nonzero8(const int8_t* p, long long q) {
  if constexpr (VEC == 4) {
    const unsigned t = __ldcs(reinterpret_cast<const unsigned*>(p) + q);
    return (t & 0xffu ? 1u : 0u) | (t & 0xff00u ? 2u : 0u) |
           (t & 0xff0000u ? 4u : 0u) | (t & 0xff000000u ? 8u : 0u);
  } else {
    return __ldcs(p + q) != 0 ? 1u : 0u;
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
  if (MODE == kSel || MODE == kPos) {
    int x[VEC];
    load_vec<VEC>(p.p0, q, x);
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) m |= (unsigned)(MODE == kSel ? x[j] != 0 : x[j] > 0) << j;
    return m;
  }
  unsigned m = in_range<VEC>(p.p0, q, p.lo0, p.hi0);
  if (MODE == kCmp8) return (m ^ (p.inv * kAll)) & nonzero8<VEC>(p.b8, q);
  if (NCL > 1) m &= in_range<VEC>(p.p1, q, p.lo1, p.hi1);
  if (NCL > 2) m &= in_range<VEC>(p.p2, q, p.lo2, p.hi2);
  return m;
}

// Tables an accumulator keeps for num_codes codes: one per warp, or one
// per block above kWarpTableCodes codes.
__host__ __device__ int tables(int num_codes) {
  return num_codes <= kWarpTableCodes ? kWarps : 1;
}

// Offset of this lane's table among tables(num_codes).
__device__ int table_base(int num_codes) {
  return tables(num_codes) > 1 ? (int)(threadIdx.x >> 5) * num_codes : 0;
}

struct SumOut {
  unsigned long long* sums;
  unsigned long long* counts;
  int* first;
};

// Sums, counts and first selected rows. FIRST = false drops the first-row
// table (K5 has no first-row output); VALS = false drops the value plane
// (sums stay 0). A table entry is the sum's low and high words, the count
// and the first row.
template <bool FIRST, bool VALS>
struct SumCount {
  using Out = SumOut;
  static constexpr bool kVals = VALS;
  __host__ __device__ static size_t smem_bytes(int num_codes) {
    return (size_t)tables(num_codes) * num_codes * 4 * sizeof(unsigned);
  }

  unsigned* s_lo;  // the lane's table
  unsigned* s_hi;
  unsigned* s_cnt;
  int* s_first;
  unsigned vmask;
  int code = 0;  // the lane's run
  unsigned cnt = 0;
  unsigned long long sum = 0;
  int first = kInt32Max;

  // Block-wide: fills the block's tables.
  __device__ SumCount(unsigned* smem, int num_codes, unsigned vm) : vmask(vm) {
    const int entries = tables(num_codes) * num_codes;
    s_lo = smem;
    s_hi = s_lo + entries;
    s_cnt = s_hi + entries;
    s_first = reinterpret_cast<int*>(s_cnt + entries);
    for (int k = threadIdx.x; k < entries; k += kThreads) {
      s_lo[k] = 0u;
      s_hi[k] = 0u;
      s_cnt[k] = 0u;
      s_first[k] = kInt32Max;
    }
    const int b = table_base(num_codes);
    s_lo += b;
    s_hi += b;
    s_cnt += b;
    s_first += b;
  }
  __device__ bool live() const { return cnt != 0; }
  __device__ void add(int c, int v, int row) {
    if (cnt == 0) {
      code = c;
      if (FIRST) first = row;
    }
    cnt += 1;
    if (VALS) sum += (unsigned)v & vmask;
  }
  __device__ void write() {
    if (VALS) {
      const unsigned lo = (unsigned)sum;
      const unsigned old = atomicAdd(s_lo + code, lo);
      const unsigned hi = (unsigned)(sum >> 32) + (old + lo < old ? 1u : 0u);
      if (hi != 0u) atomicAdd(s_hi + code, hi);
    }
    atomicAdd(s_cnt + code, cnt);
    if (FIRST) atomicMin(s_first + code, first);
    cnt = 0;
    sum = 0;
  }
  // Block-wide, after the block's last write: the tables to the outputs.
  __device__ static void merge(const unsigned* smem, int num_codes, const Out& out) {
    const int n_tables = tables(num_codes);
    const int entries = n_tables * num_codes;
    const unsigned* t_lo = smem;
    const unsigned* t_hi = t_lo + entries;
    const unsigned* t_cnt = t_hi + entries;
    const int* t_first = reinterpret_cast<const int*>(t_cnt + entries);
    for (int k = threadIdx.x; k < num_codes; k += kThreads) {
      unsigned long long s = 0ULL, n = 0ULL;
      int f = kInt32Max;
      for (int w = 0; w < n_tables; ++w) {
        const int i = w * num_codes + k;
        if (VALS) s += (unsigned long long)t_hi[i] << 32 | t_lo[i];
        n += t_cnt[i];
        if (FIRST) f = min(f, t_first[i]);
      }
      if (n != 0ULL) {
        if (VALS) atomicAdd(&out.sums[k], s);
        atomicAdd(&out.counts[k], n);
        if (FIRST) atomicMin(&out.first[k], f);
      }
    }
  }
};

struct MinMaxOut {
  int* mins;
  int* maxs;
};

// Min and max. A run is empty while mn > mx.
struct MinMax {
  using Out = MinMaxOut;
  static constexpr bool kVals = true;
  __host__ __device__ static size_t smem_bytes(int num_codes) {
    return (size_t)tables(num_codes) * num_codes * 2 * sizeof(int);
  }

  int* s_min;  // the lane's table
  int* s_max;
  int code = 0;  // the lane's run
  int mn = kInt32Max;
  int mx = kInt32Min;

  __device__ MinMax(unsigned* smem, int num_codes, unsigned) {
    const int entries = tables(num_codes) * num_codes;
    s_min = reinterpret_cast<int*>(smem);
    s_max = s_min + entries;
    for (int k = threadIdx.x; k < entries; k += kThreads) {
      s_min[k] = kInt32Max;
      s_max[k] = kInt32Min;
    }
    const int b = table_base(num_codes);
    s_min += b;
    s_max += b;
  }
  __device__ bool live() const { return mn <= mx; }
  __device__ void add(int c, int v, int) {
    if (mn > mx) code = c;
    mn = min(mn, v);
    mx = max(mx, v);
  }
  __device__ void write() {
    atomicMin(s_min + code, mn);
    atomicMax(s_max + code, mx);
    mn = kInt32Max;
    mx = kInt32Min;
  }
  __device__ static void merge(const unsigned* smem, int num_codes, const Out& out) {
    const int n_tables = tables(num_codes);
    const int* t_min = reinterpret_cast<const int*>(smem);
    const int* t_max = t_min + n_tables * num_codes;
    for (int k = threadIdx.x; k < num_codes; k += kThreads) {
      int a = kInt32Max, b = kInt32Min;
      for (int w = 0; w < n_tables; ++w) {
        a = min(a, t_min[w * num_codes + k]);
        b = max(b, t_max[w * num_codes + k]);
      }
      if (a != kInt32Max) atomicMin(&out.mins[k], a);
      if (b != kInt32Min) atomicMax(&out.maxs[k], b);
    }
  }
};

// One row of a lane (`take`: selected, code in range): a new code writes
// the lane's run out first.
template <class A>
__device__ __forceinline__ void step(A& a, bool take, int c, int v, int row) {
  if (!take) return;
  if (a.live() && c != a.code) a.write();
  a.add(c, v, row);
}

// Dynamic shared memory holds Acc's tables (Acc::smem_bytes(num_codes)).
template <class A, int MODE, int NCL, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) group_kernel(
    const int* __restrict__ codes, const int* __restrict__ values, Pred pred,
    long long n, int num_codes, unsigned int vmask, typename A::Out out) {
  extern __shared__ unsigned smem[];
  A a(smem, num_codes, vmask);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // A warp takes 32 * kUnroll neighbouring vectors a step.
  const long long nvec = n / VEC;
  constexpr long long kSpan = 32LL * kUnroll;
  const long long stride = (long long)gridDim.x * kWarps * kSpan;
  for (long long q0 = ((long long)blockIdx.x * kWarps + warp) * kSpan;
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
        if (A::kVals) load_vec<VEC>(values, q, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row0 = (int)((q0 + u * 32 + lane) * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool take =
            ((m[u] >> j) & 1u) && (unsigned)c[u][j] < (unsigned)num_codes;
        step(a, take, c[u][j], v[u][j], row0 + j);
      }
    }
  }
  // The last n % VEC rows: block 0's first warp, a row a lane.
  if (VEC > 1 && blockIdx.x == 0 && warp == 0) {
    const long long row = nvec * VEC + lane;
    if (row < n && sel_mask<MODE, NCL, 1>(pred, row)) {
      const int c = codes[row];
      step(a, (unsigned)c < (unsigned)num_codes, c, A::kVals ? values[row] : 0, (int)row);
    }
  }
  if (a.live()) a.write();
  __syncthreads();
  A::merge(smem, num_codes, out);
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

struct Job {
  const int* codes;
  const int* values;  // null: count only
  Pred pred;
  long long n;
  int num_codes;
  unsigned vmask;
  int num_sms;
  cudaStream_t stream;
};

template <class A, int MODE, int NCL, int VEC>
int launch_vec(const Job& j, const typename A::Out& out) {
  // kMinBlocks blocks fit an SM: registers by the launch bounds, shared
  // memory (at most 32 KB a block) by far.
  const long long rows_per_block = (long long)kThreads * kUnroll * VEC;
  long long blocks = (j.n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)j.num_sms * kMinBlocks;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  group_kernel<A, MODE, NCL, VEC>
      <<<dim3((unsigned)blocks), kThreads, A::smem_bytes(j.num_codes), j.stream>>>(
          j.codes, j.values, j.pred, j.n, j.num_codes, j.vmask, out);
  return (int)cudaGetLastError();
}

// 16-byte vectors where every plane allows them (the int8 plane: 4 bytes),
// scalar loads otherwise.
template <class A, int MODE, int NCL>
int launch(const Job& j, const typename A::Out& out) {
  const bool vec = aligned(j.codes, 16) && aligned(j.values, 16) &&
                   aligned(j.pred.p0, 16) && aligned(j.pred.p1, 16) &&
                   aligned(j.pred.p2, 16) && aligned(j.pred.b8, 4);
  if (vec) return launch_vec<A, MODE, NCL, 4>(j, out);
  return launch_vec<A, MODE, NCL, 1>(j, out);
}

template <int MODE, int NCL>
int launch_first(const Job& j, const SumOut& out) {
  if (j.values == nullptr) return launch<SumCount<true, false>, MODE, NCL>(j, out);
  return launch<SumCount<true, true>, MODE, NCL>(j, out);
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
  const Job j = {(const int*)codes, (const int*)values, p, n, num_codes, vmask,
                 num_sms, (cudaStream_t)stream};
  const SumOut out = {(unsigned long long*)sums, (unsigned long long*)counts, (int*)first};
  if (mode == kSel) return launch_first<kSel, 1>(j, out);
  if (mode == kBand && n_cl == 1) return launch_first<kBand, 1>(j, out);
  if (mode == kBand && n_cl == 2) return launch_first<kBand, 2>(j, out);
  if (mode == kBand && n_cl == 3) return launch_first<kBand, 3>(j, out);
  if (mode == kCmp8) return launch_first<kCmp8, 1>(j, out);
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
  const Job j = {(const int*)codes, (const int*)values, p, n, num_codes, vmask,
                 num_sms, (cudaStream_t)stream};
  const SumOut out = {(unsigned long long*)sums, (unsigned long long*)counts, nullptr};
  return launch<SumCount<false, true>, kBand, 1>(j, out);
}

// Min and max per code over rows with sel > 0. The caller fills mins with
// INT32_MAX and maxs with INT32_MIN before the launch.
extern "C" int fdb_group_min_max(const void* codes, const void* values,
                                 const void* sel, long long n, int num_codes,
                                 void* mins, void* maxs, int num_sms,
                                 void* stream) {
  if (num_codes < 1 || num_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Pred p = {};
  p.p0 = (const int*)sel;
  const Job j = {(const int*)codes, (const int*)values, p, n, num_codes, 0u,
                 num_sms, (cudaStream_t)stream};
  return launch<MinMax, kPos, 1>(j, {(int*)mins, (int*)maxs});
}
