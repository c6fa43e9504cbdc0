"""The port's byte streams and samplers on the CPU, byte for byte
(tolerance 0).

(a) The blake2xb and shake256 streams against SEAL's own bytes
    (tests/vectors/prng.json: seed (1, ..., 8) at offsets 0 and 4090, the
    zero seed, shake256), chunked reads against one bulk read, the
    vectorised XOF output stage against blake2b one block at a time, and
    the stream against seal_tpu's.
(b) The seed and the PRNG type on the parameters: not part of the parms_id
    (the file's parms_id entries), carried by clone.
(c) The samplers against SEAL's legacy and rejection-order vectors
    (tests/vectors/legacy_samplers.json) and against seal_tpu's host
    samplers at n = 1024, from the same stream.
"""

import json
import pathlib
import struct

import numpy as np
import pytest

import seal_tpu_torch as st
from seal_tpu import randomgen as jrandomgen
from seal_tpu import rlwe as jrlwe
from seal_tpu_torch import randomgen, rlwe
from seal_tpu_torch.utils.blake2 import blake2b_param, xof_output_blocks

VECTORS = pathlib.Path(__file__).parent / "vectors"
V = json.loads((VECTORS / "prng.json").read_text())
SEED = (1, 2, 3, 4, 5, 6, 7, 8)


# -- (a) the streams ---------------------------------------------------------------

def test_blake2xb_stream_matches_seal():
    buf = randomgen.Blake2xbPRNG(SEED).generate(8192)
    assert buf[:160].hex() == V["blake2xb_12345678_first8192"]
    assert buf[4090:4106].hex() == V["blake2xb_12345678_at4090"]
    assert randomgen.Blake2xbPRNG((0,) * 8).generate(64).hex() == V["blake2xb_zero_first64"]


def test_shake256_stream_matches_seal():
    assert randomgen.Shake256PRNG(SEED).generate(64).hex() == V["shake256_12345678_first64"]


@pytest.mark.parametrize("cls", [randomgen.Blake2xbPRNG, randomgen.Shake256PRNG])
def test_chunked_reads_equal_one_bulk_read(cls):
    bulk = cls(SEED).generate(300_000)
    prng, parts = cls(SEED), []
    for size in [1, 63, 64, 4031, 4096, 5, 70_000, 8, 12_345] * 3:
        parts.append(prng.generate(size))
    chunked = b"".join(parts)
    assert chunked == bulk[:len(chunked)]


@pytest.mark.parametrize("outlen", [1, 63, 64, 65, 200, 4096, 4100])
def test_vectorised_xof_equals_block_by_block(outlen):
    """Three XOF instances at once against blake2b_param, one output block
    at a time (SEAL util/blake2xb.c:118-141's parameter block)."""
    roots = [np.frombuffer(bytes(range(k, k + 64)), dtype="<u8") for k in (0, 7, 100)]
    got = xof_output_blocks(np.stack(roots), outlen)
    for r, root in enumerate(roots):
        want = b"".join(
            blake2b_param(root.tobytes(), digest_size=min(64, outlen - 64 * i), fanout=0,
                          depth=0, leaf_size=64, node_offset=i | (outlen << 32),
                          inner_size=64)
            for i in range(-(-outlen // 64)))
        assert got[r].tobytes() == want
    assert randomgen.blake2xb(outlen, b"data", b"key") == jrandomgen.blake2xb(
        outlen, b"data", b"key")


def test_stream_equals_seal_tpu_and_factory_replays():
    """A refill is BLAKE2Xb(4096, key = seed, data = counter); the port's
    bulk batches give seal_tpu's bytes. A seeded factory replays its seed
    on every create(); an unseeded one draws a fresh seed."""
    got = randomgen.Blake2xbPRNG(SEED).generate(5 * 4096 + 17)
    assert got == jrandomgen.Blake2xbPRNG(SEED).generate(5 * 4096 + 17)
    key = struct.pack("<8Q", *SEED)
    assert got[4096:8192] == jrandomgen.blake2xb(4096, struct.pack("<Q", 1), key)
    seeded = randomgen.UniformRandomGeneratorFactory(randomgen.PrngType.BLAKE2XB, SEED)
    assert seeded.create().generate(100) == seeded.create().generate(100)
    fresh = randomgen.UniformRandomGeneratorFactory(randomgen.PrngType.SHAKE256)
    a, b = fresh.create(), fresh.create()
    assert a.generate(64) != b.generate(64) and a.prng_type == randomgen.PrngType.SHAKE256
    assert randomgen.make_prng(1, SEED).generate(64) == got[:64]


# -- (b) the parameters -------------------------------------------------------------

def test_seed_and_prng_type_are_not_part_of_parms_id():
    def with_seed(p):
        p.set_random_seed(SEED)
        p.set_prng_type(st.PrngType.SHAKE256)
        return p

    p = with_seed(st.EncryptionParameters(st.SchemeType.BFV))
    p.set_poly_modulus_degree(4096)
    p.set_coeff_modulus(st.CoeffModulus.bfv_default(4096))
    p.set_plain_modulus(st.PlainModulus.batching(4096, 20))
    assert list(p.parms_id) == V["parms_id_bfv_4096_default"]
    p = with_seed(st.EncryptionParameters(st.SchemeType.BFV))
    p.set_poly_modulus_degree(64)
    p.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40]))
    p.set_plain_modulus(257)
    assert list(p.parms_id) == V["parms_id_bfv_64_tiny"]
    p = with_seed(st.EncryptionParameters(st.SchemeType.CKKS))
    p.set_poly_modulus_degree(8192)
    p.set_coeff_modulus(st.CoeffModulus.create(8192, [60, 40, 40, 60]))
    assert list(p.parms_id) == V["parms_id_ckks_8192"]
    q = p.clone()
    assert q.random_seed == SEED and q.prng_type == st.PrngType.SHAKE256
    q.set_random_seed(None)
    q.set_prng_type(None)
    assert q.random_seed is None and q.prng_type == st.PrngType.BLAKE2XB
    assert q.parms_id == p.parms_id


# -- (c) the samplers ---------------------------------------------------------------

LEGACY = json.loads((VECTORS / "legacy_samplers.json").read_text())
LEGACY_SEED = (9, 8, 7, 6, 5, 4, 3, 2)


def _moduli(n, bits):
    return [m.value for m in st.CoeffModulus.create(n, bits)]


@pytest.mark.parametrize("version", ["seal_3_4", "seal_3_5"])
def test_legacy_uniform_samplers_match_seal(version):
    sampler = getattr(rlwe, f"sample_poly_uniform_{version}")
    out = sampler(randomgen.Blake2xbPRNG(LEGACY_SEED), _moduli(64, [40, 41]), 64)
    assert out.reshape(-1).tolist() == LEGACY[version]


def test_uniform_rejection_order_matches_seal():
    out = rlwe.sample_poly_uniform(randomgen.Blake2xbPRNG(LEGACY_SEED),
                                   _moduli(4096, [48, 48]), 4096).reshape(-1)
    assert out[:32].tolist() == LEGACY["uniform_4096_head"]
    assert out[-32:].tolist() == LEGACY["uniform_4096_tail"]
    assert int(out.astype(object).sum()) & ((1 << 64) - 1) == LEGACY["uniform_4096_sum"]


@pytest.mark.parametrize("name", ["ternary", "cbd", "uniform", "normal"])
def test_samplers_match_seal_tpu(name):
    """The same stream through the port's and seal_tpu's host samplers at
    n = 1024 (the normal sampler is not SEAL's default noise, and like
    seal_tpu's not byte-exact against libstdc++; the two copies agree).
    Then a second draw from each, so the bytes each consumed agree too."""
    n, moduli = 1024, _moduli(1024, [60, 50, 60])
    a, b = randomgen.Blake2xbPRNG(SEED), jrandomgen.Blake2xbPRNG(SEED)
    for _ in range(2):
        got = getattr(rlwe, f"sample_poly_{name}")(a, moduli, n)
        want = getattr(jrlwe, f"sample_poly_{name}")(b, moduli, n)
        assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert a.generate(64) == b.generate(64)


def test_ternary_rejects_zero_words():
    """A zero 32-bit word is skipped (Lemire's rejection for range 3): a
    stream whose first words are zero draws past them."""

    class Scripted(randomgen.UniformRandomGenerator):
        def __init__(self, words):
            super().__init__(SEED)
            self._data = struct.pack(f"<{len(words)}I", *words)

        def generate(self, byte_count):
            out, self._data = self._data[:byte_count], self._data[byte_count:]
            return out

    words = [0, 0, 1 << 31, 0xFFFFFFFF, 0, 1, 3 << 30, 5]
    assert rlwe.ternary_values(Scripted(words), 4).tolist() == [0, 1, -1, 1]
