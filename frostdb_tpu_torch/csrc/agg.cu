// Fused filter + group-by aggregation kernels for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in frostdb_tpu/ops/pallas_agg.py:
//   group_sum_count_kernel<kSel>      pallas_group_sum_count (K2)
//   group_sum_count_kernel<kBand, n>  pallas_fused_band_group_sum_count (K1)
//   group_sum_count_kernel<kCmp8>     pallas_fused_cmp_group_sum_count (K4)
//   group_min_max_kernel              pallas_group_min_max (K3)
//   group_sum_count_kernel<kBand, 1, false>
//                                     pallas_filter_group_sum_count (K5):
//                                     one `ts >= literal` clause, sums and
//                                     counts only (no first-row table)
//
// Inputs are flat int32 planes of n rows (the compiled layer's [slabs, 128]
// planes, read contiguously); codes of selected rows lie in [0, num_codes),
// num_codes <= 2048. Rows whose code falls outside that range contribute
// nothing, as in the one-hot formulation.
//
// Bound on the card: memory. Each row is read once (codes + values + one
// predicate plane = 12 B, 13 B with the int8 base plane of kCmp8); the
// per-code tables are a few KB. Design: every block walks a grid-stride row
// range and accumulates into a per-block shared-memory table with shared
// atomics, then flushes its non-empty entries with global atomics. All
// accumulation is in integers, so results are bit-exact whatever the order
// of the atomics. Sums and counts are int64; the first selected row is the
// exact row index (not a superblock). The shared atomics are what keeps
// this from the memory bound: compacted parts are sorted by label, so the
// lanes of a warp mostly share one code and their atomics on it serialize.
// Warp-level pre-aggregation is the next step.
//
// Each C entry returns cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCodes = 2048;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;
constexpr int kInt32Max = 0x7fffffff;
constexpr int kInt32Min = -0x7fffffff - 1;

enum Mode { kSel = 0, kBand = 1, kCmp8 = 2 };

// Op codes: 0 <, 1 <=, 2 >, 3 >=, 4 ==, 5 !=.
__device__ __forceinline__ bool cmp_op(int op, int x, int lit) {
  switch (op) {
    case 0: return x < lit;
    case 1: return x <= lit;
    case 2: return x > lit;
    case 3: return x >= lit;
    case 4: return x == lit;
    default: return x != lit;
  }
}

struct Pred {
  const int* p0;      // kSel: 0/1 selection; kBand: clause 0; kCmp8: compare plane
  const int* p1;      // kBand: clause 1
  const int* p2;      // kBand: clause 2
  const int8_t* b8;   // kCmp8: base-validity plane
  int op0, op1, op2;
  int lit0, lit1, lit2;
};

template <int MODE, int NCL>
__device__ __forceinline__ bool selected(const Pred& p, long long i) {
  if (MODE == kSel) return p.p0[i] != 0;
  if (MODE == kCmp8) return p.b8[i] != 0 && cmp_op(p.op0, p.p0[i], p.lit0);
  bool s = cmp_op(p.op0, p.p0[i], p.lit0);
  if (NCL > 1) s = s && cmp_op(p.op1, p.p1[i], p.lit1);
  if (NCL > 2) s = s && cmp_op(p.op2, p.p2[i], p.lit2);
  return s;
}

// FIRST = false drops the first-row table and its atomics (K5 has no
// first-row output); `first` is then not read or written.
template <int MODE, int NCL, bool FIRST = true>
__global__ void __launch_bounds__(kThreads) group_sum_count_kernel(
    const int* __restrict__ codes, const int* __restrict__ values, Pred pred,
    long long n, int num_codes, unsigned int vmask,
    unsigned long long* __restrict__ sums,
    unsigned long long* __restrict__ counts, int* __restrict__ first) {
  __shared__ unsigned long long s_sum[kMaxCodes];
  __shared__ unsigned long long s_cnt[kMaxCodes];
  __shared__ int s_first[FIRST ? kMaxCodes : 1];
  for (int k = threadIdx.x; k < num_codes; k += blockDim.x) {
    s_sum[k] = 0ULL;
    s_cnt[k] = 0ULL;
    if (FIRST) s_first[k] = kInt32Max;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!selected<MODE, NCL>(pred, i)) continue;
    const int c = codes[i];
    if ((unsigned)c >= (unsigned)num_codes) continue;
    // The value masked to the digit width the caller declared (the Pallas
    // kernel's base-128 digit split keeps exactly these bits).
    const unsigned long long v = (unsigned long long)((unsigned)values[i] & vmask);
    atomicAdd(&s_sum[c], v);
    atomicAdd(&s_cnt[c], 1ULL);
    if (FIRST) atomicMin(&s_first[c], (int)i);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < num_codes; k += blockDim.x) {
    if (s_cnt[k] != 0ULL) {
      atomicAdd(&sums[k], s_sum[k]);
      atomicAdd(&counts[k], s_cnt[k]);
      if (FIRST) atomicMin(&first[k], s_first[k]);
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

}  // namespace

// Sums, counts and the first selected row per code. The caller fills sums
// and counts with 0 and first with INT32_MAX before the launch.
extern "C" int fdb_group_sum_count(
    int mode, int n_cl, const void* codes, const void* values, const void* p0,
    const void* p1, const void* p2, const void* base8, int op0, int op1,
    int op2, int lit0, int lit1, int lit2, long long n, int num_codes,
    unsigned int vmask, void* sums, void* counts, void* first, int num_sms,
    void* stream) {
  if (num_codes < 1 || num_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Pred p;
  p.p0 = (const int*)p0;
  p.p1 = (const int*)p1;
  p.p2 = (const int*)p2;
  p.b8 = (const int8_t*)base8;
  p.op0 = op0;
  p.op1 = op1;
  p.op2 = op2;
  p.lit0 = lit0;
  p.lit1 = lit1;
  p.lit2 = lit2;
  const int* c = (const int*)codes;
  const int* v = (const int*)values;
  unsigned long long* su = (unsigned long long*)sums;
  unsigned long long* cu = (unsigned long long*)counts;
  int* fi = (int*)first;
  const dim3 grid(grid_size(n, num_sms));
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kSel) {
    group_sum_count_kernel<kSel, 1><<<grid, kThreads, 0, s>>>(
        c, v, p, n, num_codes, vmask, su, cu, fi);
  } else if (mode == kBand && n_cl == 1) {
    group_sum_count_kernel<kBand, 1><<<grid, kThreads, 0, s>>>(
        c, v, p, n, num_codes, vmask, su, cu, fi);
  } else if (mode == kBand && n_cl == 2) {
    group_sum_count_kernel<kBand, 2><<<grid, kThreads, 0, s>>>(
        c, v, p, n, num_codes, vmask, su, cu, fi);
  } else if (mode == kBand && n_cl == 3) {
    group_sum_count_kernel<kBand, 3><<<grid, kThreads, 0, s>>>(
        c, v, p, n, num_codes, vmask, su, cu, fi);
  } else if (mode == kCmp8) {
    group_sum_count_kernel<kCmp8, 1><<<grid, kThreads, 0, s>>>(
        c, v, p, n, num_codes, vmask, su, cu, fi);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  p.op0 = 3;  // >=
  p.lit0 = lit;
  group_sum_count_kernel<kBand, 1, false>
      <<<dim3(grid_size(n, num_sms)), kThreads, 0, (cudaStream_t)stream>>>(
          (const int*)codes, (const int*)values, p, n, num_codes, vmask,
          (unsigned long long*)sums, (unsigned long long*)counts, nullptr);
  return (int)cudaGetLastError();
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
