"""SEAL's seeded byte streams: blake2xb (the default) and shake256.

The port's own copy of seal_tpu/randomgen.py (SEAL randomgen.{h,cpp}: the
refill loop randomgen.cpp:201-223, 4096-byte buffers randomgen.h:391, and
the BLAKE2X XOF of util/blake2xb.c:36-149). A seeded stream is byte for
byte SEAL's, which is what makes keys and ciphertexts drawn from it
bit-identical to SEAL's and to seal_tpu's.

Refill c of a blake2xb stream is BLAKE2Xb(4096 bytes, key = the 64-byte
seed, data = c as a little-endian u64). The stream draws its refills from
the port's C++ XOF (native.py, csrc/blake2xb.cpp). Its plain version,
`blake2xb_refills_plain`, which the tests and chip_smoke.py hold the C++
against, computes each refill's root digest with hashlib (its tree
parameters are expressible there: node_offset carries the XOF length in its
high 32 bits) and runs the 64 output blocks of every refill of a draw at
once through utils/blake2.xof_output_blocks. The stream is the
concatenation of its refills, so how a caller chunks its reads does not
change a byte.
"""

from __future__ import annotations

import enum
import hashlib
import secrets
import struct

import numpy as np

from seal_tpu_torch import native
from seal_tpu_torch.utils.blake2 import xof_output_blocks

PRNG_SEED_UINT64_COUNT = 8
PRNG_SEED_BYTE_COUNT = PRNG_SEED_UINT64_COUNT * 8
BUFFER_SIZE = 4096
_B2B_OUT = 64
_REFILLS_PER_BATCH = 1024       # 4 MB of output per vectorised numpy batch


class PrngType(enum.IntEnum):
    UNKNOWN = 0
    BLAKE2XB = 1
    SHAKE256 = 2


def _root_digest(outlen: int, data: bytes, key: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=_B2B_OUT, key=key, fanout=1, depth=1,
                           leaf_size=0, node_offset=outlen << 32, node_depth=0,
                           inner_size=0).digest()


def blake2xb(outlen: int, data: bytes, key: bytes = b"") -> bytes:
    """BLAKE2Xb XOF output of `outlen` bytes, as SEAL's util/blake2xb.c."""
    if not (0 < outlen <= 0xFFFFFFFF):
        raise ValueError("invalid outlen")
    root = np.frombuffer(_root_digest(outlen, data, key), dtype="<u8")
    return xof_output_blocks(root[None], outlen)[0].tobytes()


def blake2xb_refills_plain(seed_bytes: bytes, counter: int, count: int) -> bytes:
    """native.blake2xb_refills in numpy: refills counter .. counter + count
    - 1 of the blake2xb stream of a 64-byte seed."""
    parts = []
    for start in range(0, count, _REFILLS_PER_BATCH):
        batch = range(counter + start, counter + min(count, start + _REFILLS_PER_BATCH))
        roots = np.frombuffer(b"".join(
            _root_digest(BUFFER_SIZE, struct.pack("<Q", c), seed_bytes)
            for c in batch), dtype="<u8").reshape(-1, 8)
        parts.append(xof_output_blocks(roots, BUFFER_SIZE).tobytes())
    return b"".join(parts)


def random_seed() -> tuple:
    """A fresh 512-bit seed from the operating system."""
    return tuple(struct.unpack("<8Q", secrets.token_bytes(PRNG_SEED_BYTE_COUNT)))


class UniformRandomGenerator:
    """A deterministic byte stream over 4096-byte refills."""

    prng_type = PrngType.UNKNOWN

    def __init__(self, seed):
        self.seed = tuple(int(s) & ((1 << 64) - 1) for s in seed)
        if len(self.seed) != PRNG_SEED_UINT64_COUNT:
            raise ValueError("seed must be 8 uint64 words")
        self._seed_bytes = struct.pack("<8Q", *self.seed)
        self._counter = 0
        self._buffer = b""
        self._pos = 0

    def _refill_n(self, count: int) -> bytes:
        """The next `count` refills of the stream."""
        raise NotImplementedError

    def generate(self, byte_count: int) -> bytes:
        out = bytearray()
        while byte_count:
            if self._pos == len(self._buffer):
                self._buffer = self._refill_n(-(-byte_count // BUFFER_SIZE))
                self._pos = 0
            take = min(byte_count, len(self._buffer) - self._pos)
            out += self._buffer[self._pos:self._pos + take]
            self._pos += take
            byte_count -= take
        return bytes(out)

    def info(self):
        return (self.prng_type, self.seed)


class Blake2xbPRNG(UniformRandomGenerator):
    prng_type = PrngType.BLAKE2XB

    def _refill_n(self, count: int) -> bytes:
        out = native.blake2xb_refills(self._seed_bytes, self._counter, count)
        self._counter += count
        return out


class Shake256PRNG(UniformRandomGenerator):
    prng_type = PrngType.SHAKE256

    def _refill_n(self, count: int) -> bytes:
        out = b"".join(
            hashlib.shake_256(self._seed_bytes + struct.pack("<Q", self._counter + i))
            .digest(BUFFER_SIZE) for i in range(count))
        self._counter += count
        return out


_CLASSES = {PrngType.BLAKE2XB: Blake2xbPRNG, PrngType.SHAKE256: Shake256PRNG}


class UniformRandomGeneratorFactory:
    """Creates streams of one type. A factory with a seed starts every
    stream it creates from that seed, so each create() replays the same
    bytes (SEAL's seeded Blake2xbPRNGFactory, randomgen.h:532-560);
    without one, each stream gets a fresh seed."""

    def __init__(self, prng_type: PrngType = PrngType.BLAKE2XB, seed=None):
        self.prng_type = PrngType(prng_type)
        self.default_seed = tuple(seed) if seed is not None else None

    def create(self, seed=None) -> UniformRandomGenerator:
        use = seed if seed is not None else self.default_seed
        return _CLASSES[self.prng_type](random_seed() if use is None else use)


def make_prng(prng_type: PrngType, seed) -> UniformRandomGenerator:
    """The stream of a serialized (type, seed) pair."""
    return _CLASSES[PrngType(prng_type)](seed)
