// K1: negacyclic Harvey NTT of every [n] row of an RNS tower, forward and
// inverse, on Hopper (sm_90a), for every n = 2^log_n from 2 to 131072.
//
// Replaces seal_tpu/ops/ntt_pallas.py _ntt_kernel together with the
// stage-range paging of its launcher _call (one pallas_call per range of
// stages), and _ntt_kernel_compact, which computes the same transform from
// the same per-stage roots. Same arithmetic and lazy contract as the plain
// version in seal_tpu_torch/ops/ntt.py, bit for bit:
//   forward: natural order in (< 4q), bit-reversed out, < q (< 4q if lazy);
//   inverse: bit-reversed in (< 2q), natural out, < q (< 2q if lazy), with
//            n^-1 folded into the last stage.
// Root tables are the per-prime Shoup pairs in SEAL's order
// (ops/ntt.py build_ntt_tables): forward stage s, group g reads
// psi-power 2^s + g; inverse stage s, group g reads n - 2^(s+1) + 1 + g.
//
// Design. A row of n = 2^a * 2^b words is transformed in two passes split at
// a stage boundary (a = log_n / 2), each its own launch, each spread over
// many blocks:
//   * the column pass runs stages 0..a-1 (gaps n/2 .. 2^b). They couple only
//     words whose low b bits agree, so each of the 2^b "columns" (2^a words
//     at stride 2^b) is an independent transform of size 2^a, and all
//     columns of a row read the same 2^a - 1 roots, which each block loads
//     into shared memory once;
//   * the chunk pass runs stages a..log_n-1 inside contiguous chunks of 2^b
//     words; chunk j reads 2^t roots at its local stage t, from
//     base(a + t) + (j << t). Most of them serve one or two butterflies, so
//     each is read where it is used, through L1.
// Forward runs column then chunk pass, inverse chunk then column pass (its
// column pass ends with the folded stage 0). n <= 512 runs in one pass, a
// chunk pass over whole rows. The first pass writes the output tensor, the
// second updates it in place: each block owns its words.
// Inside a pass a block takes T sub-transforms (columns or chunks) of 2^M
// words (M <= 9). Each thread holds 8 words of one sub-transform in
// registers and runs 3 stages of butterflies on them with no exchange; the
// block swaps words through shared memory only between such groups of 3
// stages (M = 7: two exchanges). The first group reads device memory and
// the last writes it directly: in a column pass neighbouring threads take
// neighbouring columns (T >= 4: whole 32-byte sectors), in a chunk pass
// neighbouring words, or 8 consecutive words as 16-byte pairs. T is chosen
// on the host from the row count: at most 128 threads, and as many blocks
// as 4 per SM where the rows allow (at 56 rows of 16384 that was faster
// than 256 threads and 2 per SM; 64 threads and 8 per SM was no faster).
// Every butterfly keeps the formulas of the one-pass version, and the final
// reduction runs only in the pass that holds the last stage, so every
// intermediate word is the same (the argument _call makes for its paging).
//
// What bounds it on the H100: bytes, each row once in and once out per pass,
// between the passes mostly through the 50 MB L2 (a [7, 8, 16384] tower is
// 7.3 MB), plus the chunk pass's roots (about n root pairs per row, from
// L2); and integer work, 10 32-bit multiplies per butterfly (a Shoup
// product: one 64x64 high half and two low halves), n/2 * log_n
// butterflies per row. At 56 rows of 16384 both give 4-5 us for the whole
// transform; at a few rows each pass is as long as one block's chain of
// loads, three groups of dependent stages and stores, a few us, whatever
// the row count (PERF.md has the measured times).

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr int kMaxLogN = 17;        // POLY_MOD_DEGREE_MAX = 131072
constexpr int kMaxSubLog = 9;       // largest sub-transform: 512 words
constexpr int kLogMaxThreads = 7;
constexpr int kMaxThreads = 1 << kLogMaxThreads;
constexpr int kFillBlocks = 4 * 132;

__device__ __forceinline__ u64 shoup_lazy(u64 x, u64 w, u64 w_quot, u64 q) {
  // x·w mod q in [0, 2q) for w < q and w_quot = floor(w·2^64/q)
  return x * w - __umul64hi(x, w_quot) * q;
}

__device__ __forceinline__ u64 guard(u64 x, u64 bound) {
  return x >= bound ? x - bound : x;
}

// Shared-memory word of tile index l: one pad word after every 8 keeps the
// strided exchanges of small windows free of bank conflicts.
__device__ __forceinline__ int pad(int l) { return l + (l >> 3); }

struct Pass {
  long long subs;     // sub-transforms over all rows
  int n_primes;
  int log_n;
  int log_subs;       // log2 of the sub-transforms per row
  int s0;             // the row's stage that is local stage 0
  int log_t;          // log2 of the sub-transforms per block
  int lazy;
  int aligned;        // both data pointers on 16 bytes: paired accesses
};

// Index in its sub-transform of word e of thread tau in window lo: bits
// [lo, lo+W) are e, the others come from tau.
template <int W>
__device__ __forceinline__ int word(int tau, int e, int lo) {
  return ((tau >> lo) << (lo + W)) | (e << lo) | (tau & ((1 << lo) - 1));
}

// One pass over sub-transforms of 2^M words: local stages 0..M-1 are the
// row's stages s0..s0+M-1. A column pass (kColumn) takes words at stride
// 2^log_subs and keeps its roots, shared by all its columns, in shared
// memory; a chunk pass takes contiguous words and reads each root where it
// uses it (most of its roots serve one or two butterflies).
template <bool kInverse, bool kColumn, int M>
__global__ void __launch_bounds__(kMaxThreads)
ntt_pass_kernel(const u64* in, u64* out, const u64* __restrict__ root_op,
                const u64* __restrict__ root_quot,
                const u64* __restrict__ moduli,
                const u64* __restrict__ inv_n_op,
                const u64* __restrict__ inv_n_quot,
                const u64* __restrict__ last_op,
                const u64* __restrict__ last_quot, Pass p) {
  constexpr int W = M < 3 ? M : 3;         // stages per group
  constexpr int E = 1 << W;                // words per thread
  constexpr int G = (M + 2) / 3;           // groups
  constexpr int kSub = 1 << M;
  extern __shared__ u64 smem[];

  const int T = 1 << p.log_t;
  const int n = 1 << p.log_n;
  int sub, tau;
  if (kColumn) {               // neighbouring threads: neighbouring columns
    sub = threadIdx.x & (T - 1);
    tau = threadIdx.x >> p.log_t;
  } else {                     // neighbouring threads: neighbouring words
    tau = threadIdx.x & ((1 << (M - W)) - 1);
    sub = threadIdx.x >> (M - W);
  }
  const long long sigma = (long long)blockIdx.x * T + sub;
  const bool active = sigma < p.subs;
  const long long sub_mask = (1LL << p.log_subs) - 1;
  const long long row = sigma >> p.log_subs;
  const long long j = sigma & sub_mask;       // column or chunk in the row
  const int prime = (int)row % p.n_primes;
  const u64 q = moduli[prime];
  const u64 two_q = q << 1;
  const size_t origin = (size_t)row * n + (kColumn ? j : j << M);
  const long long stride = kColumn ? 1LL << p.log_subs : 1;
  const bool paired = !kColumn && p.aligned;   // window 0: k[2i+1] = k[2i]+1
  const bool fold = kInverse && p.s0 == 0;            // holds stage 0
  const bool reduce = !p.lazy && (kInverse ? p.s0 == 0 : p.s0 + M == p.log_n);
  const u64* row_op = root_op + (size_t)prime * n;
  const u64* row_qt = root_quot + (size_t)prime * n;
  u64* tile = smem;
  u64* w_op = smem + pad(T << M);             // column pass: 2^M - 1 roots
  u64* w_qt = w_op + kSub;

  u64 x[E];
  int k[E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int g = kInverse ? G - 1 - gi : gi;
    const int lo = M - 3 * g - 3 > 0 ? M - 3 * g - 3 : 0;
    const int hi_t = 3 * g + 3 < M ? 3 * g + 3 : M;   // local stages [3g, hi_t)
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = word<W>(tau, e, lo);

    if (gi == 0) {
      if (!active) {
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = 0;
      } else if (paired && lo == 0) {
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          const ulonglong2 v =
              *reinterpret_cast<const ulonglong2*>(in + origin + k[e]);
          x[e] = v.x;
          x[e + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = in[origin + k[e] * stride];
      }
      if (kColumn) {
        // the roots of stages s0..s0+M-1 of this row, shared by its columns
        for (int lam = threadIdx.x; lam < kSub - 1; lam += blockDim.x) {
          const int t = 31 - __clz(lam + 1);
          const int s = p.s0 + t;
          const int at = (kInverse ? n - (2 << s) + 1 : 1 << s) +
                         lam + 1 - (1 << t);
          w_op[lam] = row_op[at];
          w_qt[lam] = row_qt[at];
        }
        __syncthreads();
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[e] = tile[pad(kColumn ? k[e] * T + sub : (sub << M) + k[e])];
      __syncthreads();                                   // tile free again
    }

#pragma unroll
    for (int ti = 3 * g; ti < hi_t; ++ti) {
      const int t = kInverse ? hi_t - 1 - (ti - 3 * g) : ti;
      const int r = M - 1 - t - lo;                      // coupled bit of e
      const int s = p.s0 + t;
      const long long base = kInverse ? (long long)n - (2LL << s) + 1
                                      : 1LL << s;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e >> r) & 1) continue;
        const int e1 = e | (1 << r);
        const int g_local = k[e] >> (M - t);             // group in the sub
        u64 w = 0, wq = 0;                               // this group's root
        if (kColumn) {
          w = w_op[(1 << t) - 1 + g_local];
          wq = w_qt[(1 << t) - 1 + g_local];
        } else if (!(kInverse && t == 0 && fold)) {
          const long long at = base + (j << t) + g_local;
          w = __ldg(row_op + at);
          wq = __ldg(row_qt + at);
        }
        if (!kInverse) {
          const u64 u = guard(x[e], two_q);
          const u64 v = shoup_lazy(x[e1], w, wq, q);
          x[e] = u + v;
          x[e1] = u + two_q - v;
        } else if (t == 0 && fold) {
          // stage 0 (gap n/2) with n^-1 folded into both outputs
          const u64 u = guard(x[e], two_q);
          const u64 v = x[e1];
          x[e] = shoup_lazy(guard(u + v, two_q), inv_n_op[prime],
                            inv_n_quot[prime], q);
          x[e1] = shoup_lazy(u + two_q - v, last_op[prime], last_quot[prime],
                             q);
        } else {
          const u64 u = x[e];
          const u64 v = x[e1];
          x[e] = guard(u + v, two_q);
          x[e1] = shoup_lazy(u + two_q - v, w, wq, q);
        }
      }
    }

    if (gi == G - 1) {
      if (reduce) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          x[e] = kInverse ? guard(x[e], q) : guard(guard(x[e], two_q), q);
      }
      if (active && paired && lo == 0) {
#pragma unroll
        for (int e = 0; e < E; e += 2)
          *reinterpret_cast<ulonglong2*>(out + origin + k[e]) =
              make_ulonglong2(x[e], x[e + 1]);
      } else if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) out[origin + k[e] * stride] = x[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        tile[pad(kColumn ? k[e] * T + sub : (sub << M) + k[e])] = x[e];
      __syncthreads();
    }
  }
}

// Sub-transforms per block: at most kMaxThreads threads and at least a
// warp; in a column pass at least 4 neighbouring columns and never past the
// row; the largest count that still leaves kFillBlocks blocks, else the
// smallest.
int choose_log_t(int log_threads_per_sub, bool column, const Pass& p) {
  int hi = kLogMaxThreads - log_threads_per_sub;
  int lo = 5 - log_threads_per_sub;
  if (hi < 0) hi = 0;
  if (lo < 0) lo = 0;
  if (column) {
    if (hi > p.log_subs) hi = p.log_subs;
    if (lo < 2) lo = 2 < p.log_subs ? 2 : p.log_subs;
  }
  while (hi > 0 && (1LL << (hi - 1)) >= p.subs) --hi;   // no empty blocks
  if (lo > hi) lo = hi;
  int log_t = hi;
  while (log_t > lo && (p.subs >> log_t) < kFillBlocks) --log_t;
  return log_t;
}

template <bool kInverse, bool kColumn, int M>
cudaError_t launch(const void* in, void* out, const void* const* tables,
                   Pass p, cudaStream_t stream) {
  constexpr int W = M < 3 ? M : 3;
  // T << (M - W) <= kMaxThreads, so a tile holds at most kMaxThreads << W
  // words and fits the default 48 KB of dynamic shared memory
  constexpr int kMaxWords = (kMaxThreads << W) + ((kMaxThreads << W) >> 3) +
                            (kColumn ? 2 << M : 0);
  static_assert(sizeof(u64) * kMaxWords <= 48 * 1024, "tile too large");
  p.log_t = choose_log_t(M - W, kColumn, p);
  const int T = 1 << p.log_t;
  const int words = (T << M) + ((T << M) >> 3) + (kColumn ? 2 << M : 0);
  const long long blocks = (p.subs + T - 1) >> p.log_t;
  ntt_pass_kernel<kInverse, kColumn, M>
      <<<(unsigned)blocks, T << (M - W), sizeof(u64) * words, stream>>>(
      (const u64*)in, (u64*)out, (const u64*)tables[0],
      (const u64*)tables[1], (const u64*)tables[2], (const u64*)tables[3],
      (const u64*)tables[4], (const u64*)tables[5], (const u64*)tables[6], p);
  return cudaGetLastError();
}

// A column pass has 2^a words per column (a = log_n / 2, 5..8), a chunk
// pass 2^b per chunk (b = log_n - a, 5..9) or a whole row (1..9).
template <bool kInverse, bool kColumn>
cudaError_t launch_m(int m, const void* in, void* out,
                     const void* const* tables, const Pass& p,
                     cudaStream_t stream) {
  switch (m) {
#define SEALTORCH_NTT_CASE(M) \
    case M: return launch<kInverse, kColumn, M>(in, out, tables, p, stream);
    SEALTORCH_NTT_CASE(1) SEALTORCH_NTT_CASE(2) SEALTORCH_NTT_CASE(3)
    SEALTORCH_NTT_CASE(4) SEALTORCH_NTT_CASE(5) SEALTORCH_NTT_CASE(6)
    SEALTORCH_NTT_CASE(7) SEALTORCH_NTT_CASE(8) SEALTORCH_NTT_CASE(9)
#undef SEALTORCH_NTT_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The whole transform: one chunk pass over whole rows for n <= 512, else a
// column pass over stages [0, a) and a chunk pass over [a, log_n), with
// a = log_n / 2; the inverse runs the chunk pass first.
template <bool kInverse>
int transform(const void* in, void* out, const void* const* tables,
              long long rows, int n_primes, int log_n, int lazy,
              void* stream) {
  if (log_n < 1 || log_n > kMaxLogN || rows < 1 || n_primes < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int aligned = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  if (log_n <= kMaxSubLog) {
    const Pass whole{rows, n_primes, log_n, 0, 0, 0, lazy, aligned};
    return (int)launch_m<kInverse, false>(log_n, in, out, tables, whole, st);
  }
  const int a = log_n / 2, b = log_n - a;
  const Pass column{rows << b, n_primes, log_n, b, 0, 0, lazy, aligned};
  const Pass chunk{rows << a, n_primes, log_n, a, a, 0, lazy, aligned};
  cudaError_t err;
  if (!kInverse) {
    err = launch_m<false, true>(a, in, out, tables, column, st);
    if (err == cudaSuccess)
      err = launch_m<false, false>(b, out, out, tables, chunk, st);
  } else {
    err = launch_m<true, false>(b, in, out, tables, chunk, st);
    if (err == cudaSuccess)
      err = launch_m<true, true>(a, out, out, tables, column, st);
  }
  return (int)err;
}

}  // namespace

// Every entry returns a cudaError_t (0 on success). `rows` rows of 2^log_n
// words; row r uses prime r % n_primes of the [n_primes, 2^log_n] tables.
// A transform is one launch for n <= 512 and two for larger n.

extern "C" int sealtorch_ntt_forward(const void* in, void* out,
                                     const void* root_op,
                                     const void* root_quot,
                                     const void* moduli, long long rows,
                                     int n_primes, int log_n, int lazy,
                                     void* stream) {
  const void* tables[7] = {root_op, root_quot, moduli, nullptr,
                           nullptr, nullptr, nullptr};
  return transform<false>(in, out, tables, rows, n_primes, log_n, lazy,
                          stream);
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
  const void* tables[7] = {root_op, root_quot, moduli, inv_n_op,
                           inv_n_quot, last_op, last_quot};
  return transform<true>(in, out, tables, rows, n_primes, log_n, lazy,
                         stream);
}
