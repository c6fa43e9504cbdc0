"""BLAKE2b with any parameter block, and the BLAKE2X output blocks in bulk.

The port's own copy of seal_tpu/utils/blake2.py (RFC 7693), plus the
vectorised output stage of BLAKE2Xb. Python's hashlib refuses depth=0,
which the XOF's output blocks need (SEAL util/blake2xb.c:118-141: fanout 0,
depth 0, leaf length 64, inner length 64), so those blocks are computed
here. Every output block is one compression of the 64-byte root digest
under its own parameter block, independent of every other block, so
`xof_output_blocks` runs the 12 rounds over all (root, block) lanes at
once in numpy uint64, whose adds wrap modulo 2^64. `blake2b_param` is the
one-block-at-a-time version the tests hold it against.
"""

from __future__ import annotations

import struct

import numpy as np

_MASK = (1 << 64) - 1

_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

# the G mixes of one round: four columns, then four diagonals
_MIXES = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
          (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotr(x, n):
    return ((x >> n) | (x << (64 - n))) & _MASK


def _compress(h, block, t, last):
    m = struct.unpack("<16Q", block)
    v = list(h) + list(_IV)
    v[12] ^= t & _MASK
    v[13] ^= (t >> 64) & _MASK
    if last:
        v[14] ^= _MASK
    for rnd in _SIGMA:
        for i, (a, b, c, d) in enumerate(_MIXES):
            x = m[rnd[2 * i]]
            y = m[rnd[2 * i + 1]]
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va = (va + vb + x) & _MASK
            vd = _rotr(vd ^ va, 32)
            vc = (vc + vd) & _MASK
            vb = _rotr(vb ^ vc, 24)
            va = (va + vb + y) & _MASK
            vd = _rotr(vd ^ va, 16)
            vc = (vc + vd) & _MASK
            vb = _rotr(vb ^ vc, 63)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return tuple((h[i] ^ v[i] ^ v[i + 8]) & _MASK for i in range(8))


def blake2b_param(
    data: bytes,
    digest_size: int = 64,
    key: bytes = b"",
    fanout: int = 1,
    depth: int = 1,
    leaf_size: int = 0,
    node_offset: int = 0,
    node_depth: int = 0,
    inner_size: int = 0,
    salt: bytes = b"",
    person: bytes = b"",
) -> bytes:
    """blake2b with an arbitrary parameter block (RFC 7693 §2.5, §2.8)."""
    if not (0 < digest_size <= 64):
        raise ValueError("digest_size")
    param = struct.pack(
        "<BBBBIQBB14x16s16s",
        digest_size, len(key), fanout, depth,
        leaf_size, node_offset, node_depth, inner_size,
        salt.ljust(16, b"\0"), person.ljust(16, b"\0"),
    )
    h = tuple(_IV[i] ^ w for i, w in enumerate(struct.unpack("<8Q", param)))
    buf = key.ljust(128, b"\0") if key else b""
    buf += data
    t = 0
    n_full = (len(buf) - 1) // 128 if buf else 0
    for i in range(n_full):
        t += 128
        h = _compress(h, buf[i * 128:(i + 1) * 128], t, False)
    tail = buf[n_full * 128:]
    t += len(tail)
    h = _compress(h, tail.ljust(128, b"\0"), t, True)
    return struct.pack("<8Q", *h)[:digest_size]


def _u64(x: int):
    return np.uint64(x & _MASK)


def _rotr_inplace(x: np.ndarray, n: int, tmp: np.ndarray):
    np.right_shift(x, np.uint64(n), out=tmp)
    np.left_shift(x, np.uint64(64 - n), out=x)
    np.bitwise_or(x, tmp, out=x)


def xof_output_blocks(roots: np.ndarray, xof_length: int, first_block: int = 0,
                      block_count: int | None = None) -> np.ndarray:
    """The BLAKE2Xb output of each root digest: roots [R, 8] uint64 words
    (the 64-byte digests of R independent XOF instances, each of output
    length xof_length) -> uint8 [R, out] with out = the bytes of blocks
    first_block .. first_block + block_count - 1 of each. Block i is the
    blake2b of the root under digest length min(64, xof_length - 64·i),
    fanout 0, depth 0, leaf length 64, node offset i | xof_length << 32 and
    inner length 64; all R·block_count blocks run as lanes of one
    compression."""
    roots = np.ascontiguousarray(roots, dtype=np.uint64).reshape(-1, 8)
    total_blocks = -(-xof_length // 64)
    if block_count is None:
        block_count = total_blocks - first_block
    R, B = roots.shape[0], block_count
    idx = np.arange(first_block, first_block + B, dtype=np.uint64)
    digest = np.minimum(np.int64(xof_length) - 64 * idx.astype(np.int64), 64)
    lanes = R * B
    # parameter words 0-2 (the rest are zero): digest length and leaf length;
    # node offset and XOF length; inner length
    p0 = np.tile(digest.astype(np.uint64) | (np.uint64(64) << np.uint64(32)), R)
    p1 = np.tile(idx | (np.uint64(xof_length) << np.uint64(32)), R)
    v = np.empty((16, lanes), dtype=np.uint64)
    h0 = np.empty((8, lanes), dtype=np.uint64)
    h0[0] = p0 ^ _u64(_IV[0])
    h0[1] = p1 ^ _u64(_IV[1])
    h0[2] = _u64(_IV[2] ^ (64 << 8))
    for i in range(3, 8):
        h0[i] = _u64(_IV[i])
    v[:8] = h0
    for i in range(8):
        v[8 + i] = _u64(_IV[i])
    v[12] ^= np.uint64(64)          # t: the 64-byte root is the whole input
    v[14] ^= _u64(_MASK)            # the last block
    # message words 0-7 are the root's, one per XOF instance; 8-15 are zero
    m = [np.repeat(roots[:, k], B) for k in range(8)] + [None] * 8
    tmp = np.empty(lanes, dtype=np.uint64)
    for rnd in _SIGMA:
        for i, (a, b, c, d) in enumerate(_MIXES):
            x, y = m[rnd[2 * i]], m[rnd[2 * i + 1]]
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va += vb
            if x is not None:
                va += x
            vd ^= va
            _rotr_inplace(vd, 32, tmp)
            vc += vd
            vb ^= vc
            _rotr_inplace(vb, 24, tmp)
            va += vb
            if y is not None:
                va += y
            vd ^= va
            _rotr_inplace(vd, 16, tmp)
            vc += vd
            vb ^= vc
            _rotr_inplace(vb, 63, tmp)
    h = h0 ^ v[:8] ^ v[8:]                                # [8, lanes]
    out = np.ascontiguousarray(h.T, dtype="<u8").view(np.uint8).reshape(R, B, 64)
    if digest[-1] < 64:
        # a short last block: its own digest length, its leading bytes
        keep = int(digest[-1])
        return np.concatenate([out[:, :-1].reshape(R, -1), out[:, -1, :keep]], axis=1)
    return out.reshape(R, B * 64)
