// K2 and K3: the key-switch inner product on Hopper (sm_90a), in two routes
// that give the same bits.
//
// K2 (sealtorch_keyswitch_inner):
//   out[c, i, x] = (sum_j t[j, i, x] · k[j, c, i, x]) mod q_i,  c in {0, 1}
//
// with t [J, I, N], k [J, 2, I, N] and out [2, I, N], all uint64. The sum is
// accumulated in 128 bits and reduced once with Barrett-128, SEAL's own
// algebra (evaluator.cpp:2517-2547): with inputs below 2^61 the J products
// fit 128 bits for J <= 64 (checked by the wrapper), so one reduction at the
// end is exact.
//
// Replaces seal_tpu/ops/keyswitch_pallas.py _ks_kernel (launched by
// keyswitch_inner_pallas). Bit-identical to the plain version in
// seal_tpu_torch/ops/keyswitch.py.
//
// What bounds it on the H100: device memory. Each output word needs 3J input
// words (t once, both key components) read once and nothing else, and the
// integer work per input word is about two 64x64 products, far below the
// card's rate per byte. So the design is one thread per (i, x) that computes
// both c = 0 and c = 1 from one read of t, with the accumulators in
// registers, and consecutive threads on consecutive x so that every load and
// store is coalesced along N. Not ported from the TPU kernel: its VMEM row
// tiling and grid order, which only served the TPU's scratch-memory limits.
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
// (5J input words, against K2's 3J), and computes three 64-bit products per
// term (about 10 32-bit multiplies) instead of K2's two full 128-bit
// products; at J=8, I=9, N=16384 it must move 49.6 MB, about 14.8 us at
// 3.35 TB/s, against about 1.4 us of multiplies. So the design is K2's:
// one thread per (i, x), both components from one read of t, the two 64-bit
// sums in registers, every load and store coalesced along N. It saves
// multiplies that do not bound it and reads 60 % more bytes, so it is not
// expected to beat K2 here; on the TPU the route measured neutral too.

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

__global__ void __launch_bounds__(kThreads)
keyswitch_inner_kernel(const u64* __restrict__ t, const u64* __restrict__ k,
                       const u64* __restrict__ consts, u64* __restrict__ out,
                       int J, int I, int log_n) {
  const size_t plane = (size_t)I << log_n;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int i = (int)(idx >> log_n);
  u64 lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  for (int j = 0; j < J; ++j) {
    const u64 tv = t[(size_t)j * plane + idx];
    mac128(lo0, hi0, tv, k[(size_t)(2 * j) * plane + idx]);
    mac128(lo1, hi1, tv, k[(size_t)(2 * j + 1) * plane + idx]);
  }
  const u64 q = consts[3 * i], r0 = consts[3 * i + 1], r1 = consts[3 * i + 2];
  out[idx] = barrett_128(lo0, hi0, q, r0, r1);
  out[plane + idx] = barrett_128(lo1, hi1, q, r0, r1);
}

__global__ void __launch_bounds__(kThreads)
keyswitch_inner_shoup_kernel(const u64* __restrict__ t, const u64* __restrict__ k,
                             const u64* __restrict__ kq,
                             const u64* __restrict__ consts, u64* __restrict__ out,
                             int J, int I, int log_n) {
  const size_t plane = (size_t)I << log_n;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int i = (int)(idx >> log_n);
  const u64 q = consts[3 * i];
  u64 acc0 = 0, acc1 = 0;
  for (int j = 0; j < J; ++j) {
    const u64 tv = t[(size_t)j * plane + idx];
    const size_t k0 = (size_t)(2 * j) * plane + idx, k1 = k0 + plane;
    acc0 += tv * k[k0] - __umul64hi(tv, kq[k0]) * q;
    acc1 += tv * k[k1] - __umul64hi(tv, kq[k1]) * q;
  }
  for (int s = 31 - __clz(2 * J - 1); s >= 0; --s) {
    const u64 qs = q << s;
    acc0 = acc0 >= qs ? acc0 - qs : acc0;
    acc1 = acc1 >= qs ? acc1 - qs : acc1;
  }
  out[idx] = acc0;
  out[plane + idx] = acc1;
}

}  // namespace

// Returns a cudaError_t (0 on success). consts: [I, 3] rows (q, r0, r1).
extern "C" int sealtorch_keyswitch_inner(const void* t, const void* k,
                                         const void* consts, void* out, int J,
                                         int I, int log_n, void* stream) {
  if (J < 1 || J > 64 || I < 1 || log_n < 0 || log_n > 20)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)I << log_n;
  const unsigned blocks = (unsigned)((plane + kThreads - 1) / kThreads);
  keyswitch_inner_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)t, (const u64*)k, (const u64*)consts, (u64*)out, J, I,
      log_n);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 on success). kq: the Shoup quotients of k, same
// shape; the caller guarantees 2·J·max q < 2^64.
extern "C" int sealtorch_keyswitch_inner_shoup(const void* t, const void* k,
                                               const void* kq, const void* consts,
                                               void* out, int J, int I, int log_n,
                                               void* stream) {
  if (J < 1 || J > 64 || I < 1 || log_n < 0 || log_n > 20)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)I << log_n;
  const unsigned blocks = (unsigned)((plane + kThreads - 1) / kThreads);
  keyswitch_inner_shoup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)t, (const u64*)k, (const u64*)kq, (const u64*)consts,
      (u64*)out, J, I, log_n);
  return (int)cudaGetLastError();
}
