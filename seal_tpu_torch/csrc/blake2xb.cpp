// SEAL's blake2xb byte stream on the host, in C++.
//
// The native counterpart of the port's numpy XOF (utils/blake2.py
// xof_output_blocks, which stays as the plain version the tests and
// chip_smoke.py hold this against). seal_tpu runs the same stream natively
// (seal_tpu/native/blake2_native.cpp); the port keeps its own source.
//
// Refill c of a stream with 64-byte seed K is BLAKE2Xb(4096 bytes, key = K,
// data = c as a little-endian u64), SEAL randomgen.cpp:201-223 over
// util/blake2xb.c:36-149:
//   root  = BLAKE2b-512 of the 8-byte counter under key K, parameter block
//           fanout 1, depth 1, node offset 4096 << 32;
//   block i (0..63) = BLAKE2b-512 of the root, unkeyed, parameter block
//           fanout 0, depth 0, leaf length 64, node offset i | 4096 << 32,
//           inner length 64.
// The 64 output blocks of a refill share their message (the root) and all
// of their initial state but one word, so they run eight at a time as the
// lanes of one compression over vectors of eight u64 words (GCC vector
// extensions: one AVX-512 register per vector where the host has it).
//
// What bounds it: the 12 rounds of additions, xors and rotations, about 65
// compressions per 4 KB refill, on one host core. Little-endian hosts only.
//
// Build: g++ -O3 -march=native -shared -fPIC (seal_tpu_torch/native.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

// The message schedule of BLAKE2b's 12 rounds (rounds 10 and 11 repeat 0, 1).
constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

constexpr uint32_t kRefill = 4096;             // SEAL's buffer (randomgen.h:391)
constexpr uint32_t kBlocks = kRefill / 64;     // output blocks per refill
constexpr int kLanes = 8;

typedef uint64_t lanes_t __attribute__((vector_size(8 * kLanes)));

// One BLAKE2b compression of state h by message m (16 words) with byte
// count t. W is uint64_t (one instance) or lanes_t (kLanes instances that
// share m and t); the state words are W, the message words plain u64.
template <typename W>
inline W rotr(W x, int n) { return (x >> n) | (x << (64 - n)); }

template <typename W>
void compress(W h[8], const uint64_t m[16], uint64_t t, bool last)
{
    W v[16];
    for (int i = 0; i < 8; ++i) {
        v[i] = h[i];
        v[i + 8] = W{} + kIV[i];               // broadcast in the vector case
    }
    v[12] ^= t;
    if (last) v[14] = ~v[14];
    for (int r = 0; r < 12; ++r) {
        const uint8_t *s = kSigma[r];
        auto g = [&](int a, int b, int c, int d, uint64_t x, uint64_t y) {
            v[a] = v[a] + v[b] + x;
            v[d] = rotr(v[d] ^ v[a], 32);
            v[c] = v[c] + v[d];
            v[b] = rotr(v[b] ^ v[c], 24);
            v[a] = v[a] + v[b] + y;
            v[d] = rotr(v[d] ^ v[a], 16);
            v[c] = v[c] + v[d];
            v[b] = rotr(v[b] ^ v[c], 63);
        };
        g(0, 4, 8, 12, m[s[0]], m[s[1]]);
        g(1, 5, 9, 13, m[s[2]], m[s[3]]);
        g(2, 6, 10, 14, m[s[4]], m[s[5]]);
        g(3, 7, 11, 15, m[s[6]], m[s[7]]);
        g(0, 5, 10, 15, m[s[8]], m[s[9]]);
        g(1, 6, 11, 12, m[s[10]], m[s[11]]);
        g(2, 7, 8, 13, m[s[12]], m[s[13]]);
        g(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// The root digest of one refill: the keyed BLAKE2b of the counter.
void root_digest(const uint64_t key[8], uint64_t counter, uint64_t root[8])
{
    uint64_t h[8];
    for (int i = 0; i < 8; ++i) h[i] = kIV[i];
    // digest length 64, key length 64, fanout 1, depth 1; node offset with
    // the XOF length in its high half
    h[0] ^= 64ULL | (64ULL << 8) | (1ULL << 16) | (1ULL << 24);
    h[1] ^= uint64_t{kRefill} << 32;
    uint64_t m[16] = {};
    for (int i = 0; i < 8; ++i) m[i] = key[i];
    compress(h, m, 128, false);                // the key, padded to a block
    std::memset(m, 0, sizeof m);
    m[0] = counter;
    compress(h, m, 128 + 8, true);             // the 8 bytes of data
    for (int i = 0; i < 8; ++i) root[i] = h[i];
}

}  // namespace

extern "C" {

// `count` refills of the stream of `seed` (8 u64 words, little-endian
// bytes), from refill `counter` on, into out (count * 4096 bytes). Returns 0.
int sealtorch_blake2xb_refills(const uint64_t *seed, uint64_t counter,
                               uint64_t count, uint8_t *out)
{
    for (uint64_t r = 0; r < count; ++r) {
        uint64_t m[16] = {};
        root_digest(seed, counter + r, m);
        uint8_t *dst = out + r * kRefill;
        for (uint32_t first = 0; first < kBlocks; first += kLanes) {
            lanes_t h[8];
            for (int i = 0; i < 8; ++i) h[i] = lanes_t{} + kIV[i];
            // digest length 64, leaf length 64; node offset i | XOF length
            // << 32, one i per lane; inner length 64
            h[0] ^= 64ULL | (64ULL << 32);
            for (int j = 0; j < kLanes; ++j)
                h[1][j] ^= (first + j) | (uint64_t{kRefill} << 32);
            h[2] ^= 64ULL << 8;
            compress(h, m, 64, true);
            for (int j = 0; j < kLanes; ++j)
                for (int k = 0; k < 8; ++k)
                    std::memcpy(dst + (first + j) * 64 + 8 * k, &h[k][j], 8);
        }
    }
    return 0;
}

}  // extern "C"
