"""SEAL's wire format at n = 4096 on the port, on the CPU: every save of
tests/test_serialization_n4096.py byte for byte against SEAL's bytes
(tests/vectors/serialization_n4096.json, tools/oracle/
dump_serialization_n4096.cpp, a fixed seed), and SEAL's ciphertext loaded
back into the port and decrypted.

The objects are chip_smoke.py's `vector_saves` (the same code phase 14 runs
on the card): BFV n=4096, bits [36, 36, 37], a 20-bit batching t, seeded
relinearization and Galois {3} keys, a public-key encryption and a seeded
symmetric one, in the dumper's order of draws from the stream. ZSTD is
held where `zstandard` imports, as the original holds it.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from seal_tpu_torch import BatchEncoder, Decryptor, KeyGenerator, SchemeType, SEALContext
from seal_tpu_torch import serialization as ser

W = json.loads((pathlib.Path(__file__).parent / "vectors" / "serialization_n4096.json")
               .read_text())


@pytest.fixture(scope="module")
def saves():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield chip_smoke.vector_saves("cpu")
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["parms", "relin_keys_seeded", "galois_keys_seeded",
                                  "ct_none", "ct_sym_seeded"])
def test_save_bytes(saves, name):
    assert saves[0][name] == bytes.fromhex(W[name])


@pytest.mark.parametrize("mode", ["zlib", "zstd"])
def test_compressed_ciphertext_bytes(saves, mode):
    if mode == "zstd" and ser._zstd is None:
        pytest.skip("zstandard does not import")
    assert saves[0][f"ct_{mode}"] == bytes.fromhex(W[f"ct_{mode}"])


def test_large_ct_roundtrips_decrypt(saves):
    """The byte-pinned ciphertext decrypts to the encoded vector, on the
    port that made it and from SEAL's bytes (none and ZLIB) loaded into a
    context of the same seed, whose secret key is the dumper's."""
    assert saves[1]
    ctx = SEALContext(chip_smoke.vector_parms(SchemeType.BFV, [36, 36, 37]), device="cpu")
    dec = Decryptor(ctx, KeyGenerator(ctx).secret_key())
    be = BatchEncoder(ctx)
    want = np.array([(17 * i + 3) % 1000 for i in range(be.slot_count)], dtype=np.int64)
    for name in ("ct_none", "ct_zlib"):
        ct = ser.load_ciphertext(ctx, bytes.fromhex(W[name]))
        assert np.array_equal(be.decode(dec.decrypt(ct)).numpy(), want), name
        assert ser.save_ciphertext(ct) == bytes.fromhex(W["ct_none"])


def test_a_changed_byte_is_named(saves):
    blob = bytearray(saves[0]["ct_none"])
    blob[100] ^= 1
    assert chip_smoke.first_byte_mismatch({"ct_none": bytes(blob)}, W) == (
        f"ct_none: byte 100 differs ({len(blob)} bytes against {len(blob)})")
