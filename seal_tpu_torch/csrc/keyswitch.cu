// K2 and K3: the key-switch inner product on Hopper (sm_90a), in two routes
// that give the same bits.
//
// K2 (sealtorch_keyswitch_inner):
//   out[b, c, i, x] = (sum_j t[b, j, i, x] · k[j, c, i, x]) mod q_i,  c in {0, 1}
//
// with t [B, J, I, N] (B ciphertexts of a batch, B = 1 for one), one key
// k [J, 2, I, N] that the whole batch shares, and out [B, 2, I, N], all
// uint64. The sum is accumulated in 128 bits and reduced once with
// Barrett-128, SEAL's own algebra (evaluator.cpp:2517-2547): with inputs
// below 2^61 the J products fit 128 bits for J <= 64 (checked by the
// wrapper), so one reduction at the end is exact.
//
// Replaces seal_tpu/ops/keyswitch_pallas.py _ks_kernel (launched by
// keyswitch_inner_pallas; under bench.py's jax.vmap it is batched over the
// ciphertexts while the key, closed over, stays unbatched). Bit-identical
// to the plain version in seal_tpu_torch/ops/keyswitch.py, member for
// member.
//
// What bounds it on the H100: device memory. Each output word needs t once
// and both key components, read once, and the integer work per input word
// is about two 64x64 products, far below the card's rate per byte. The key
// is most of the bytes of one call (at J=8, I=9, N=16384: 18.9 of 30.7 MB),
// so a batch must not fetch it from device memory once per ciphertext. The
// design: one thread per (member, i, x), both components from one read of
// t, the accumulators in registers, consecutive threads on consecutive x so
// that every load and store is coalesced along N. The grid puts the batch
// members in blockIdx.x, the fastest-varying block index, so the B blocks
// that read one range of key words run side by side and all but the first
// find those words in L2: the key crosses device memory about once per
// call. Holding tiles of 2, 4 or 8 members per thread in registers, so that
// each thread loads a key word once for all of them, measured slower on the
// card (PERF.md §6): the extra registers cut the warps in flight, and
// this kernel is bound by the latency of its loads. Not ported from the TPU
// kernel: its VMEM row tiling and grid order, which only served the TPU's
// scratch-memory limits.
//
// K3 (sealtorch_keyswitch_inner_shoup): the same integer mod q_i from the
// key's Shoup quotients kq[j, c, i, x] = floor(k·2^64/q_i), kq [J, 2, I, N].
// Each term t·k - umulhi(t, kq)·q is below 2q (SEAL's lazy Shoup product);
// the J terms are summed in 64 bits, which the wrapper allows only while
// 2·J·max q < 2^64; a chain of conditional subtractions of q·2^s, s from
// floor(log2(2J-1)) down to 0, brings the sum below q.
//
// Replaces seal_tpu/ops/keyswitch_pallas.py _ks_kernel_shoup (launched by
// keyswitch_inner_shoup_pallas). Bit-identical to its plain version in
// seal_tpu_torch/ops/keyswitch.py and to K2.
//
// What bounds it on the H100: device memory, more so than K2. Per output
// pair it reads t once and two key words and two quotient words per term
// (5J input words for one ciphertext, against K2's 3J), and computes three
// 64-bit products per term (about 10 32-bit multiplies) instead of K2's
// two full 128-bit products; at J=8, I=9, N=16384 it must move 49.6 MB,
// about 14.8 us at 3.35 TB/s, against about 1.4 us of multiplies. So the
// design is K2's, with one change for a batch: its key and quotients are
// twice K2's key bytes, and there a thread that takes two members (each
// key word and quotient loaded once for both, four accumulators) measured
// faster than one member per thread (PERF.md §6). It saves multiplies
// that do not bound it and reads more bytes, so it is not expected to beat
// K2; on the TPU the route measured neutral too.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void mac128(u64& lo, u64& hi, u64 a, u64 b) {
  const u64 p_lo = a * b;
  lo += p_lo;
  hi += __umul64hi(a, b) + (lo < p_lo);
}

// (x_hi·2^64 + x_lo) mod q with ratio = floor(2^128/q) = r1·2^64 + r0
// (SEAL uintarithsmallmod.h barrett_reduce_128)
__device__ __forceinline__ u64 barrett_128(u64 x_lo, u64 x_hi, u64 q, u64 r0,
                                           u64 r1) {
  const u64 carry = __umul64hi(x_lo, r0);
  u64 tmp1 = x_lo * r1 + carry;
  const u64 tmp3 = __umul64hi(x_lo, r1) + (tmp1 < carry);
  const u64 u_lo = x_hi * r0;
  tmp1 += u_lo;
  const u64 carry2 = __umul64hi(x_hi, r0) + (tmp1 < u_lo);
  const u64 quot = x_hi * r1 + tmp3 + carry2;
  const u64 r = x_lo - quot * q;
  return r >= q ? r - q : r;
}

// One thread per (member b, i, x). The launch grid has the batch members
// in x and the blocks of the (i, x) range in y, so the B blocks that read
// one range of key words are scheduled side by side.
__global__ void __launch_bounds__(kThreads)
keyswitch_inner_kernel(const u64* __restrict__ t, const u64* __restrict__ k,
                       const u64* __restrict__ consts, u64* __restrict__ out,
                       int J, int I, int log_n) {
  const size_t plane = (size_t)I << log_n;
  const size_t idx = (size_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const size_t b = blockIdx.x;
  const int i = (int)(idx >> log_n);
  const u64* tb = t + b * J * plane + idx;
  u64 lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  for (int j = 0; j < J; ++j) {
    const u64 tv = tb[(size_t)j * plane];
    mac128(lo0, hi0, tv, k[(size_t)(2 * j) * plane + idx]);
    mac128(lo1, hi1, tv, k[(size_t)(2 * j + 1) * plane + idx]);
  }
  const u64 q = consts[3 * i], r0 = consts[3 * i + 1], r1 = consts[3 * i + 2];
  u64* ob = out + b * 2 * plane + idx;
  ob[0] = barrett_128(lo0, hi0, q, r0, r1);
  ob[plane] = barrett_128(lo1, hi1, q, r0, r1);
}

// As K2's, with each thread taking BT (1 or 2) members of the batch, so the
// key word and its quotient that it loads serve both.
template <int BT>
__global__ void __launch_bounds__(kThreads)
keyswitch_inner_shoup_kernel(const u64* __restrict__ t, const u64* __restrict__ k,
                             const u64* __restrict__ kq,
                             const u64* __restrict__ consts, u64* __restrict__ out,
                             int B, int J, int I, int log_n) {
  const size_t plane = (size_t)I << log_n;
  const size_t idx = (size_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const int i = (int)(idx >> log_n);
  const u64 q = consts[3 * i];
  const size_t member = (size_t)J * plane;
  const u64* tb = t + (size_t)b0 * member + idx;
  u64 acc0[BT], acc1[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc0[b] = acc1[b] = 0;
  for (int j = 0; j < J; ++j) {
    const size_t k0 = (size_t)(2 * j) * plane + idx, k1 = k0 + plane;
    const u64 kv0 = k[k0], kv1 = k[k1], kq0 = kq[k0], kq1 = kq[k1];
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < nb) {
        const u64 tv = tb[(size_t)b * member + (size_t)j * plane];
        acc0[b] += tv * kv0 - __umul64hi(tv, kq0) * q;
        acc1[b] += tv * kv1 - __umul64hi(tv, kq1) * q;
      }
    }
  }
  u64* ob = out + (size_t)b0 * 2 * plane + idx;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b < nb) {
      u64 a0 = acc0[b], a1 = acc1[b];
      for (int s = 31 - __clz(2 * J - 1); s >= 0; --s) {
        const u64 qs = q << s;
        a0 = a0 >= qs ? a0 - qs : a0;
        a1 = a1 >= qs ? a1 - qs : a1;
      }
      ob[(size_t)(2 * b) * plane] = a0;
      ob[(size_t)(2 * b + 1) * plane] = a1;
    }
  }
}

// The launch grid: `tiles` groups of members in x, blocks of the (i, x)
// range in y. False if the range has too many blocks.
inline bool grid_of(int tiles, int I, int log_n, dim3* grid) {
  const size_t plane = (size_t)I << log_n;
  const size_t blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > 65535) return false;
  *grid = dim3((unsigned)tiles, (unsigned)blocks);
  return true;
}

inline bool valid(int B, int J, int I, int log_n) {
  return B >= 1 && J >= 1 && J <= 64 && I >= 1 && log_n >= 0 && log_n <= 20;
}

}  // namespace

// Returns a cudaError_t (0 on success). t [B, J, I, N], consts: [I, 3]
// rows (q, r0, r1), out [B, 2, I, N].
extern "C" int sealtorch_keyswitch_inner(const void* t, const void* k,
                                         const void* consts, void* out, int B,
                                         int J, int I, int log_n, void* stream) {
  if (!valid(B, J, I, log_n)) return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (!grid_of(B, I, log_n, &grid)) return (int)cudaErrorInvalidConfiguration;
  keyswitch_inner_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)t, (const u64*)k, (const u64*)consts, (u64*)out, J, I, log_n);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 on success). kq: the Shoup quotients of k, same
// shape; the caller guarantees 2·J·max q < 2^64.
extern "C" int sealtorch_keyswitch_inner_shoup(const void* t, const void* k,
                                               const void* kq, const void* consts,
                                               void* out, int B, int J, int I,
                                               int log_n, void* stream) {
  if (!valid(B, J, I, log_n)) return (int)cudaErrorInvalidValue;
  const int bt = B >= 2 ? 2 : 1;
  dim3 grid;
  if (!grid_of((B + bt - 1) / bt, I, log_n, &grid)) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  const u64 *tp = (const u64*)t, *kp = (const u64*)k, *qp = (const u64*)kq,
            *cp = (const u64*)consts;
  if (bt == 2)
    keyswitch_inner_shoup_kernel<2><<<grid, kThreads, 0, st>>>(tp, kp, qp, cp, (u64*)out, B, J, I, log_n);
  else
    keyswitch_inner_shoup_kernel<1><<<grid, kThreads, 0, st>>>(tp, kp, qp, cp, (u64*)out, B, J, I, log_n);
  return (int)cudaGetLastError();
}
