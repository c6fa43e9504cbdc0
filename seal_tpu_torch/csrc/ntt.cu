// K1: negacyclic Harvey NTT of every [N] row of an RNS tower, forward and
// inverse, on Hopper (sm_90a).
//
// Replaces seal_tpu/ops/ntt_pallas.py _ntt_kernel (launched by _call from
// ntt_forward_pallas / ntt_inverse_pallas). Same arithmetic and lazy contract
// as the plain version in seal_tpu_torch/ops/ntt.py, bit for bit:
//   forward: natural order in (< 4q), bit-reversed out, < q (< 4q if lazy);
//   inverse: bit-reversed in (< 2q), natural out, < q (< 2q if lazy), with
//            n^-1 folded into the last stage.
// Root tables are the per-prime Shoup pairs in SEAL's order
// (ops/ntt.py build_ntt_tables): forward psi^i at bitrev(i), inverse
// psi^-i at bitrev(i-1)+1, consumed sequentially stage by stage.
//
// What bounds it on the H100: a transform makes log2(N) passes over its row.
// Done pass by pass in device memory that is 2·log2(N) row transfers; here
// one thread block holds the whole row in shared memory (N=16384 words of
// 8 bytes = 128 KB of the 227 KB a block may take), so each row crosses
// device memory once in and once out, plus its prime's two root tables,
// which stay in L2 across the rows of a tower. What is left is integer work:
// each butterfly is one Shoup product (three 64x64 products, ~12 32-bit
// multiply-adds), N/2·log2(N) butterflies per row. At the main path's
// shapes the bytes and the multiply-adds take about the same time on the
// card (PERF.md), so this first version keeps the traffic minimal and the
// code simple: 1024 threads, __syncthreads() between stages, roots read
// from global memory. Not ported from the TPU kernel: its roll+select
// butterflies, VMEM stage-range paging and pair-compaction variants.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr int kMaxLogN = 14;   // the largest row that fits shared memory
constexpr int kThreads = 1024;

__device__ __forceinline__ u64 shoup_lazy(u64 x, u64 w, u64 w_quot, u64 q) {
  // x·w mod q in [0, 2q) for w < q and w_quot = floor(w·2^64/q)
  return x * w - __umul64hi(x, w_quot) * q;
}

__device__ __forceinline__ u64 guard(u64 x, u64 bound) {
  return x >= bound ? x - bound : x;
}

__global__ void __launch_bounds__(kThreads)
ntt_forward_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                   const u64* __restrict__ root_op,
                   const u64* __restrict__ root_quot,
                   const u64* __restrict__ moduli, int n_primes, int log_n,
                   int lazy) {
  extern __shared__ u64 row[];
  const int n = 1 << log_n;
  const int prime = blockIdx.x % n_primes;
  const u64 q = moduli[prime];
  const u64 two_q = q << 1;
  const u64* w_op = root_op + (size_t)prime * n;
  const u64* w_quot = root_quot + (size_t)prime * n;
  const u64* src = in + (size_t)blockIdx.x * n;
  u64* dst = out + (size_t)blockIdx.x * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = src[i];
  __syncthreads();
  for (int s = 0; s < log_n; ++s) {
    // stage s: 2^s groups of butterflies, gap = n >> (s + 1)
    const int log_gap = log_n - 1 - s;
    const int root_base = 1 << s;
    for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
      const int g = k >> log_gap;
      const int i0 = (g << (log_gap + 1)) | (k & ((1 << log_gap) - 1));
      const int i1 = i0 + (1 << log_gap);
      const u64 u = guard(row[i0], two_q);
      const u64 v = shoup_lazy(row[i1], w_op[root_base + g],
                               w_quot[root_base + g], q);
      row[i0] = u + v;
      row[i1] = u + two_q - v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    u64 x = row[i];
    if (!lazy) x = guard(guard(x, two_q), q);
    dst[i] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
ntt_inverse_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                   const u64* __restrict__ root_op,
                   const u64* __restrict__ root_quot,
                   const u64* __restrict__ moduli,
                   const u64* __restrict__ inv_n_op,
                   const u64* __restrict__ inv_n_quot,
                   const u64* __restrict__ last_op,
                   const u64* __restrict__ last_quot, int n_primes,
                   int log_n, int lazy) {
  extern __shared__ u64 row[];
  const int n = 1 << log_n;
  const int prime = blockIdx.x % n_primes;
  const u64 q = moduli[prime];
  const u64 two_q = q << 1;
  const u64* w_op = root_op + (size_t)prime * n;
  const u64* w_quot = root_quot + (size_t)prime * n;
  const u64* src = in + (size_t)blockIdx.x * n;
  u64* dst = out + (size_t)blockIdx.x * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = src[i];
  __syncthreads();
  for (int s = log_n - 1; s >= 1; --s) {
    // stage s: 2^s groups, gap = n >> (s + 1); its roots start where the
    // previous (larger) stages' end: 1 + n/2 + n/4 + ... = n - 2^(s+1) + 1
    const int log_gap = log_n - 1 - s;
    const int root_base = n - (2 << s) + 1;
    for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
      const int g = k >> log_gap;
      const int i0 = (g << (log_gap + 1)) | (k & ((1 << log_gap) - 1));
      const int i1 = i0 + (1 << log_gap);
      const u64 u = row[i0];
      const u64 v = row[i1];
      row[i0] = guard(u + v, two_q);
      row[i1] = shoup_lazy(u + two_q - v, w_op[root_base + g],
                           w_quot[root_base + g], q);
    }
    __syncthreads();
  }
  // last stage (one group, gap n/2) with n^-1 folded into both outputs
  const int half = n >> 1;
  const u64 a_op = inv_n_op[prime], a_quot = inv_n_quot[prime];
  const u64 b_op = last_op[prime], b_quot = last_quot[prime];
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const u64 u = guard(row[j], two_q);
    const u64 v = row[j + half];
    u64 y0 = shoup_lazy(guard(u + v, two_q), a_op, a_quot, q);
    u64 y1 = shoup_lazy(u + two_q - v, b_op, b_quot, q);
    if (!lazy) {
      y0 = guard(y0, q);
      y1 = guard(y1, q);
    }
    dst[j] = y0;
    dst[j + half] = y1;
  }
}

int threads_for(int log_n) {
  const int half = 1 << (log_n - 1);
  return half < kThreads ? (half < 32 ? 32 : half) : kThreads;
}

}  // namespace

// Every entry returns a cudaError_t (0 on success). `rows` rows of 2^log_n
// words; row r uses prime r % n_primes of the [n_primes, 2^log_n] tables.

extern "C" int sealtorch_ntt_max_log_n() { return kMaxLogN; }

extern "C" int sealtorch_ntt_forward(const void* in, void* out,
                                     const void* root_op,
                                     const void* root_quot,
                                     const void* moduli, long long rows,
                                     int n_primes, int log_n, int lazy,
                                     void* stream) {
  if (log_n < 1 || log_n > kMaxLogN || rows < 1 || n_primes < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(u64) << log_n);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ntt_forward_kernel<<<(unsigned)rows, threads_for(log_n), smem,
                       (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)root_op, (const u64*)root_quot,
      (const u64*)moduli, n_primes, log_n, lazy);
  return (int)cudaGetLastError();
}

extern "C" int sealtorch_ntt_inverse(const void* in, void* out,
                                     const void* root_op,
                                     const void* root_quot,
                                     const void* moduli, const void* inv_n_op,
                                     const void* inv_n_quot,
                                     const void* last_op,
                                     const void* last_quot, long long rows,
                                     int n_primes, int log_n, int lazy,
                                     void* stream) {
  if (log_n < 1 || log_n > kMaxLogN || rows < 1 || n_primes < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(u64) << log_n);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ntt_inverse_kernel<<<(unsigned)rows, threads_for(log_n), smem,
                       (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)root_op, (const u64*)root_quot,
      (const u64*)moduli, (const u64*)inv_n_op, (const u64*)inv_n_quot,
      (const u64*)last_op, (const u64*)last_quot, n_primes, log_n, lazy);
  return (int)cudaGetLastError();
}
