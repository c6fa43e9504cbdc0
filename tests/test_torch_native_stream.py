"""The port's native blake2xb byte stream (native.py, csrc/blake2xb.cpp)
against its plain version (randomgen.blake2xb_refills_plain, the numpy
XOF), SEAL's bytes (tests/vectors/prng.json) and seal_tpu's stream.

The only seal_tpu call here is its byte stream.
"""

import json
import pathlib
import struct

import pytest

from seal_tpu import randomgen as jrandomgen
from seal_tpu_torch import native, randomgen

V = json.loads((pathlib.Path(__file__).parent / "vectors" / "prng.json").read_text())
SEED = (1, 2, 3, 4, 5, 6, 7, 8)
SEED_BYTES = struct.pack("<8Q", *SEED)
MB16 = 16 << 20


@pytest.mark.parametrize("counter,count", [
    (0, 1), (1, 3), (12345, 5), ((1 << 63) + 7, 2), ((1 << 64) - 2, 2), (9, 0)])
def test_refills_equal_the_numpy_xof(counter, count):
    got = native.blake2xb_refills(SEED_BYTES, counter, count)
    assert len(got) == count * 4096
    assert got == randomgen.blake2xb_refills_plain(SEED_BYTES, counter, count)


def test_stream_gives_seals_bytes_and_seal_tpus():
    buf = randomgen.Blake2xbPRNG(SEED).generate(8192)
    assert buf[:160].hex() == V["blake2xb_12345678_first8192"]
    assert buf[4090:4106].hex() == V["blake2xb_12345678_at4090"]
    assert randomgen.Blake2xbPRNG((0,) * 8).generate(64).hex() == V["blake2xb_zero_first64"]
    assert randomgen.Blake2xbPRNG(SEED).generate(100_003) == \
        jrandomgen.Blake2xbPRNG(SEED).generate(100_003)


@pytest.mark.parametrize("skip", [0, 1, 4095, 4097, 3 * 4096 + 5])
def test_16_mb_from_one_seed_at_odd_offsets(skip):
    """16 MB drawn after `skip` bytes (so from an odd refill counter and an
    odd offset within a refill) against the numpy XOF's bytes there."""
    prng = randomgen.Blake2xbPRNG(SEED)
    prng.generate(skip)
    got = prng.generate(MB16)
    first = skip // 4096
    want = randomgen.blake2xb_refills_plain(SEED_BYTES, first, -(-(skip + MB16) // 4096) - first)
    assert got == want[skip % 4096:skip % 4096 + MB16]


def test_chunked_reads_equal_one_bulk_read_and_factories_replay():
    bulk = randomgen.Blake2xbPRNG(SEED).generate(1 << 20)
    prng, parts = randomgen.Blake2xbPRNG(SEED), []
    for size in [1, 63, 64, 4031, 4096, 5, 70_000, 8, 12_345, 300_001] * 2:
        parts.append(prng.generate(size))
    chunked = b"".join(parts)
    assert chunked == bulk[:len(chunked)]
    seeded = randomgen.UniformRandomGeneratorFactory(randomgen.PrngType.BLAKE2XB, SEED)
    assert seeded.create().generate(50_000) == seeded.create().generate(50_000) == bulk[:50_000]


def test_bad_arguments_and_a_failed_build_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="64 bytes"):
        native.blake2xb_refills(SEED_BYTES[:63], 0, 1)
    with pytest.raises(ValueError, match="2\\^64"):
        native.blake2xb_refills(SEED_BYTES, (1 << 64) - 1, 2)
    broken = tmp_path / "blake2xb.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
