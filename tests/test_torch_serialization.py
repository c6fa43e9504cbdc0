"""The port's wire format (seal_tpu_torch/serialization.py) on the CPU, byte
for byte (tolerance 0).

(a) SEAL's own serializations: tests/vectors/serialization_n64.json (BFV
    parameters, keys, plaintext, ciphertexts, a seed-compressed symmetric
    ciphertext), serialization_ckks_n64.json (a CKKS NTT-form plaintext,
    public-key and seeded symmetric ciphertexts, a BGV ciphertext) and
    seeded_keys_n64.json (seed-compressed relinearization, Galois and
    public keys), every object made by the port from the parameters'
    random seed alone, and the reference bytes loaded back into working
    objects.
(b) State carried across: bytes that seal_tpu saves load into the port and
    the port saves them back byte for byte, and bytes the port saves load
    into seal_tpu with the same arrays, for every object kind and every
    compression mode that imports here.
(c) The frame: header validation, the SEAL 3.4 header, zstd's refusal
    without zstandard, the instance save()/load() methods and corrupted
    loads that are refused.
"""

import io
import json
import pathlib
import struct

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu import serialization as ser_ref
from seal_tpu.dtypes import to_host
from seal_tpu_torch import serialization as ser

VECTORS = pathlib.Path(__file__).parent / "vectors"
V = json.loads((VECTORS / "serialization_n64.json").read_text())
W = json.loads((VECTORS / "serialization_ckks_n64.json").read_text())
K = json.loads((VECTORS / "seeded_keys_n64.json").read_text())
SEED = (1, 2, 3, 4, 5, 6, 7, 8)
MODES = [ser.ComprMode.NONE, ser.ComprMode.ZLIB] + (
    [ser.ComprMode.ZSTD] if ser._zstd is not None else [])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def parms(lib, scheme, bits=(40, 40, 40), plain=257, n=64):
    p = lib.EncryptionParameters(scheme)
    p.set_poly_modulus_degree(n)
    p.set_coeff_modulus(lib.CoeffModulus.create(n, list(bits)))
    if plain is not None:
        p.set_plain_modulus(plain)
    p.set_random_seed(SEED)
    return p


def port_ctx(scheme=st.SchemeType.BFV, **kw):
    return st.SEALContext(parms(st, scheme, **kw), sec_level=st.SecLevelType.NONE,
                          device="cpu")


def ref_ctx(scheme=seal_tpu.SchemeType.BFV, **kw):
    return seal_tpu.SEALContext(parms(seal_tpu, scheme, **kw),
                                sec_level=seal_tpu.SecLevelType.NONE)


def plain(text):
    return st.Plaintext.from_hex_string(text, device="cpu")


@pytest.fixture(scope="module")
def bfv():
    ctx = port_ctx()
    kg = st.KeyGenerator(ctx)
    return ctx, kg, kg.create_public_key(), kg.create_relin_keys()


# -- (a) SEAL's bytes --------------------------------------------------------------

def test_parms_bytes(bfv):
    ctx = bfv[0]
    parms_ = ctx.key_context_data().parms
    assert ser.save_encryption_parameters(parms_) == bytes.fromhex(V["parms"])
    loaded = ser.load_encryption_parameters(bytes.fromhex(V["parms"]))
    assert loaded == parms_ and loaded.parms_id == parms_.parms_id


def test_secret_key_bytes(bfv):
    ctx, kg, _, _ = bfv
    assert ser.save_secret_key(kg.secret_key()) == bytes.fromhex(V["secret_key"])
    loaded = ser.load_secret_key(ctx, bytes.fromhex(V["secret_key"]))
    assert torch.equal(loaded.data, kg.secret_key().data)


def test_public_key_bytes(bfv):
    ctx, _, pk, _ = bfv
    assert ser.save_public_key(pk) == bytes.fromhex(V["public_key"])
    assert torch.equal(ser.load_public_key(ctx, bytes.fromhex(V["public_key"])).data.data,
                       pk.data.data)


def test_relin_keys_bytes(bfv):
    ctx, _, _, rk = bfv
    assert ser.save_relin_keys(rk) == bytes.fromhex(V["relin_keys"])
    loaded = ser.load_relin_keys(ctx, bytes.fromhex(V["relin_keys"]))
    assert torch.equal(loaded.keys[0], rk.keys[0])
    assert isinstance(loaded, st.RelinKeys) and loaded.parms_id == rk.parms_id


def test_plaintext_bytes(bfv):
    ctx = bfv[0]
    p = plain("5x^3 + 2x^1 + 3")
    assert ser.save_plaintext(p) == bytes.fromhex(V["plain1"])
    assert ser.load_plaintext(ctx, bytes.fromhex(V["plain1"])) == p


def test_ciphertext_bytes(bfv):
    ctx, _, pk, _ = bfv
    ct = st.Encryptor(ctx, pk).encrypt(plain("5x^3 + 2x^1 + 3"))
    assert ser.save_ciphertext(ct) == bytes.fromhex(V["ct1"])
    loaded = ser.load_ciphertext(ctx, bytes.fromhex(V["ct1"]))
    assert torch.equal(loaded.data, ct.data)
    assert (loaded.scale, loaded.correction_factor, loaded.is_ntt_form) == (1.0, 1, False)


def test_seeded_symmetric_ciphertext(bfv):
    ctx, kg, _, _ = bfv
    loaded = ser.load_ciphertext(ctx, bytes.fromhex(V["ct_sym_seeded"]))
    assert st.Decryptor(ctx, kg.secret_key()).decrypt(loaded).to_hex_string() == \
        "5x^3 + 2x^1 + 3"
    ct = st.Encryptor(ctx, kg.secret_key()).encrypt_symmetric(
        plain("5x^3 + 2x^1 + 3"), save_seed=True)
    assert ser.save_ciphertext(ct) == bytes.fromhex(V["ct_sym_seeded"])
    # the seed regenerates c1 exactly
    assert torch.equal(loaded.data, ct.data)


def test_ckks_and_bgv_bytes():
    ctx = port_ctx(st.SchemeType.CKKS, bits=(40, 40, 40, 40), plain=None)
    kg = st.KeyGenerator(ctx)
    enc = st.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    encoder = st.CKKSEncoder(ctx)
    values = 0.1 * np.arange(encoder.slot_count) - 1.0
    p = encoder.encode(values, 2.0 ** 30)
    assert ser.save_plaintext(p) == bytes.fromhex(W["ckks_plain"])
    assert ser.save_ciphertext(enc.encrypt(p)) == bytes.fromhex(W["ckks_ct"])
    assert ser.save_ciphertext(enc.encrypt_symmetric(p, save_seed=True)) == \
        bytes.fromhex(W["ckks_ct_sym_seeded"])
    loaded = ser.load_plaintext(ctx, bytes.fromhex(W["ckks_plain"]))
    assert loaded == p
    dec = st.Decryptor(ctx, kg.secret_key())
    sct = ser.load_ciphertext(ctx, bytes.fromhex(W["ckks_ct_sym_seeded"]))
    got = encoder.decode(dec.decrypt(sct)).numpy()
    assert np.abs(got - values).max() < 1e-5

    ctx2 = port_ctx(st.SchemeType.BGV)
    kg2 = st.KeyGenerator(ctx2)
    ct2 = st.Encryptor(ctx2, kg2.create_public_key()).encrypt(plain("3x^5 + 1x^1 + 2"))
    assert ser.save_ciphertext(ct2) == bytes.fromhex(W["bgv_ct"])
    lct = ser.load_ciphertext(ctx2, bytes.fromhex(W["bgv_ct"]))
    assert st.Decryptor(ctx2, kg2.secret_key()).decrypt(lct).to_hex_string() == \
        "3x^5 + 1x^1 + 2"


@pytest.fixture(scope="module")
def seeded_keys():
    ctx = port_ctx()
    kg = st.KeyGenerator(ctx)
    rk = kg.create_relin_keys(save_seed=True)
    gk = kg.create_galois_keys([3], save_seed=True)
    pk = kg.create_public_key(save_seed=True)
    return ctx, kg, rk, gk, pk


@pytest.mark.parametrize("what", ["relin_keys", "galois_keys", "public_key"])
def test_seeded_keys_bytes(seeded_keys, what):
    ctx, kg, rk, gk, pk = seeded_keys
    obj = {"relin_keys": rk, "galois_keys": gk, "public_key": pk}[what]
    blob = obj.save()
    assert blob == bytes.fromhex(K[f"{what}_seeded"])
    # the seeds regenerate every c1: the loaded key is the key made
    loader = {"relin_keys": ser.load_relin_keys, "galois_keys": ser.load_galois_keys,
              "public_key": ser.load_public_key}[what]
    loaded = loader(ctx, blob)
    if what == "public_key":
        assert torch.equal(loaded.data.data, pk.data.data)
    else:
        assert [None if k is None else k.tolist() for k in loaded.keys] == \
            [None if k is None else k.tolist() for k in obj.keys]
    # and a seeded key is about half its unseeded twin
    unseeded = {"relin_keys": lambda: kg.create_relin_keys(),
                "galois_keys": lambda: kg.create_galois_keys([3]),
                "public_key": lambda: kg.create_public_key()}[what]().save()
    assert len(blob) < 0.6 * len(unseeded)


def test_seeded_keys_work_after_load(seeded_keys):
    ctx, kg, rk, gk, pk = seeded_keys
    rk2 = ser.load_relin_keys(ctx, rk.save())
    gk2 = ser.load_galois_keys(ctx, gk.save())
    pk2 = ser.load_public_key(ctx, pk.save())
    enc, dec, ev = (st.Encryptor(ctx, pk2), st.Decryptor(ctx, kg.secret_key()),
                    st.Evaluator(ctx))
    ct = enc.encrypt(plain("5"))
    assert dec.decrypt(ev.relinearize(ev.multiply(ct, ct), rk2)).to_hex_string() == "19"
    assert dec.decrypt(ev.apply_galois(ct, 3, gk2)).to_hex_string() == "5"


# -- (b) carried across ---------------------------------------------------------------

KINDS = ["parms", "plain_bfv", "plain_ckks", "secret_key", "public_key", "relin_keys",
         "galois_keys", "ct_bfv", "ct_seeded", "ct_ckks", "ct_bgv"]


def _ref_objects(kind):
    """(seal_tpu context, object, its save function, the port's load function)."""
    scheme = {"plain_ckks": "CKKS", "ct_ckks": "CKKS", "ct_bgv": "BGV"}.get(kind, "BFV")
    kw = dict(bits=(40, 40, 40, 40), plain=None) if scheme == "CKKS" else {}
    ctx = ref_ctx(getattr(seal_tpu.SchemeType, scheme), **kw)
    kg = seal_tpu.KeyGenerator(ctx)
    if kind == "parms":
        return ctx, ctx.key_context_data().parms, ser.load_encryption_parameters
    if kind == "plain_bfv":
        return ctx, seal_tpu.Plaintext.from_hex_string("7x^9 + 3x^1 + 1"), ser.load_plaintext
    encoder = seal_tpu.CKKSEncoder(ctx) if scheme == "CKKS" else None
    if kind == "plain_ckks":
        return ctx, encoder.encode(np.linspace(-1, 1, encoder.slot_count), 2.0 ** 30), \
            ser.load_plaintext
    if kind == "secret_key":
        return ctx, kg.secret_key(), ser.load_secret_key
    if kind == "public_key":
        return ctx, kg.create_public_key(), ser.load_public_key
    if kind == "relin_keys":
        return ctx, kg.create_relin_keys(), ser.load_relin_keys
    if kind == "galois_keys":
        return ctx, kg.create_galois_keys([3, 127]), ser.load_galois_keys
    enc = seal_tpu.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    if kind == "ct_ckks":
        p = encoder.encode(np.linspace(-1, 1, encoder.slot_count), 2.0 ** 30)
        return ctx, enc.encrypt(p), ser.load_ciphertext
    p = seal_tpu.Plaintext.from_hex_string("3x^5 + 1x^1 + 2")
    if kind == "ct_seeded":
        return ctx, enc.encrypt_symmetric(p, save_seed=True), ser.load_ciphertext
    return ctx, enc.encrypt(p), ser.load_ciphertext


def _port_ctx_of(ref):
    p = ref.key_context_data().parms
    scheme = st.SchemeType(int(p.scheme))
    return port_ctx(scheme, bits=[m.bit_count for m in p.coeff_modulus],
                    plain=p.plain_modulus.value or None)


def _arrays(obj):
    """Every array of an object of either package, as uint64 numpy."""
    if hasattr(obj, "keys") and isinstance(obj.keys, list):
        return [None if k is None else (
            k.numpy().view(np.uint64) if isinstance(k, torch.Tensor) else to_host(k))
            for k in obj.keys]
    if isinstance(obj, (seal_tpu.Plaintext, st.Plaintext)):
        if isinstance(obj, st.Plaintext):
            return [obj.to_numpy()]
        return [obj.data if obj.rns_data is None else to_host(obj.rns_data)]
    if isinstance(obj, (seal_tpu.EncryptionParameters, st.EncryptionParameters)):
        return [np.array(obj.parms_id, dtype=np.uint64)]
    if isinstance(obj, seal_tpu.PublicKey):
        return [obj.data.to_numpy()]
    return [obj.to_numpy()]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("kind", KINDS)
def test_seal_tpu_bytes_load_and_save_back(kind, mode):
    ref_ctx_, obj, load = _ref_objects(kind)
    blob = obj.save(ser_ref.ComprMode(int(mode)))
    ctx = _port_ctx_of(ref_ctx_)
    mine = load(blob) if kind == "parms" else load(ctx, blob)
    assert mine.save(mode) == blob
    for a, b in zip(_arrays(mine), _arrays(obj)):
        assert (a is None and b is None) or np.array_equal(a.reshape(-1), b.reshape(-1))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("kind", KINDS)
def test_port_bytes_load_into_seal_tpu(kind, mode):
    ref_ctx_, obj, load = _ref_objects(kind)
    ctx = _port_ctx_of(ref_ctx_)
    mine = load(obj.save()) if kind == "parms" else load(ctx, obj.save())
    blob = ser.save_encryption_parameters(mine, mode) if kind == "parms" else mine.save(mode)
    back = {"parms": lambda: ser_ref.load_encryption_parameters(blob),
            "plain_bfv": lambda: ser_ref.load_plaintext(ref_ctx_, blob),
            "plain_ckks": lambda: ser_ref.load_plaintext(ref_ctx_, blob),
            "secret_key": lambda: ser_ref.load_secret_key(ref_ctx_, blob),
            "public_key": lambda: ser_ref.load_public_key(ref_ctx_, blob),
            "relin_keys": lambda: ser_ref.load_relin_keys(ref_ctx_, blob),
            "galois_keys": lambda: ser_ref.load_galois_keys(ref_ctx_, blob)}.get(
        kind, lambda: ser_ref.load_ciphertext(ref_ctx_, blob))()
    for a, b in zip(_arrays(back), _arrays(mine)):
        assert (a is None and b is None) or np.array_equal(a.reshape(-1), b.reshape(-1))
    if kind.startswith("ct"):
        assert (back.scale, back.correction_factor, back.is_ntt_form) == \
            (mine.scale, mine.correction_factor, mine.is_ntt_form)


# -- (c) the frame ---------------------------------------------------------------------

def test_header_validation(bfv):
    ctx = bfv[0]
    with pytest.raises(ValueError):
        ser.load_ciphertext(ctx, b"\x00" * 32)
    bad = bytearray(bytes.fromhex(V["plain1"]))
    bad[0] ^= 0xFF
    with pytest.raises(ValueError, match="magic"):
        ser.load_plaintext(ctx, bytes(bad))
    bad = bytearray(bytes.fromhex(V["plain1"]))
    bad[2] = 0x20
    with pytest.raises(ValueError, match="size"):
        ser.load_plaintext(ctx, bytes(bad))
    bad = bytearray(bytes.fromhex(V["plain1"]))
    bad[3] = 5
    with pytest.raises(ValueError, match="version"):
        ser.load_plaintext(ctx, bytes(bad))
    with pytest.raises(ValueError, match="insufficient"):
        ser.unwrap(io.BytesIO(b"\x5e\xa1"))
    assert ser.load_header(bytes.fromhex(V["plain1"])[:16]) == \
        ser_ref.load_header(bytes.fromhex(V["plain1"])[:16])


def test_legacy_34_header():
    legacy = struct.pack("<HBBIQ", ser.SEAL_MAGIC, 0, 0, 48, 0)
    assert ser.load_header(legacy) == (3, 4, ser.ComprMode.NONE, 48)
    assert ser.load_header(legacy) == ser_ref.load_header(legacy)
    with pytest.raises(ValueError):
        ser.load_header(legacy, try_upgrade_if_invalid=False)
    with pytest.raises(ValueError, match="3.4"):
        ser.unwrap(io.BytesIO(legacy + b"\0" * 32))


def test_zstd_refused_without_zstandard(bfv, monkeypatch):
    ctx, _, pk, _ = bfv
    monkeypatch.setattr(ser, "_zstd", None)
    with pytest.raises(ValueError, match="zstd"):
        pk.save(ser.ComprMode.ZSTD)
    blob = ser_ref.wrap(b"\0" * 8, ser_ref.ComprMode.NONE)
    blob = blob[:5] + bytes([2]) + blob[6:]          # the compression byte
    with pytest.raises(ValueError, match="zstd"):
        ser.unwrap(io.BytesIO(blob))


def test_instance_methods(bfv):
    ctx, kg, pk, rk = bfv
    ct = st.Encryptor(ctx, pk).encrypt(plain("3x^2 + 1"))
    assert ct.save() == ser.save_ciphertext(ct)
    ct2 = st.Ciphertext()
    assert ct2.load(ctx, ct.save()) is ct2 and torch.equal(ct2.data, ct.data)
    sk2 = st.SecretKey()
    sk2.load(ctx, kg.secret_key().save())
    assert torch.equal(sk2.data, kg.secret_key().data)
    rk2 = st.RelinKeys()
    rk2.load(ctx, rk.save(ser.ComprMode.ZLIB))
    ev, dec = st.Evaluator(ctx), st.Decryptor(ctx, sk2)
    assert dec.decrypt(ev.relinearize(ev.multiply(ct, ct), rk2)).to_hex_string() == \
        "9x^4 + 6x^2 + 1"
    p2 = st.Plaintext()
    p2.load(ctx, plain("5").save())
    assert p2.to_hex_string() == "5"
    parms2 = st.EncryptionParameters(st.SchemeType.CKKS)
    parms2.load(ctx.key_context_data().parms.save())
    assert parms2 == ctx.key_context_data().parms
    m = ctx.key_context_data().parms.coeff_modulus[0]
    assert ser.load_modulus(m.save()) == m


def test_corrupted_loads_refused(bfv):
    ctx, kg, pk, rk = bfv
    ct = st.Encryptor(ctx, pk).encrypt(plain("5"))
    blob = bytearray(ct.save())
    blob[-8:] = (1 << 63).to_bytes(8, "little")      # reads as a negative int64
    with pytest.raises(ValueError, match="invalid"):
        ser.load_ciphertext(ctx, bytes(blob))
    q0 = ctx.first_context_data().key_moduli()[0]
    blob = bytearray(ct.save())
    off = len(blob) - 8 * 2 * 2 * 64                 # the first residue of row 0
    blob[off:off + 8] = q0.to_bytes(8, "little")
    with pytest.raises(ValueError, match="invalid"):
        ser.load_ciphertext(ctx, bytes(blob))
    kblob = bytearray(rk.save())
    kblob[-8:] = (1 << 63).to_bytes(8, "little")
    with pytest.raises(ValueError, match="invalid"):
        ser.load_relin_keys(ctx, bytes(kblob))
    cblob = bytearray(ct.save())
    count_off = 16 + 32 + 1 + 8 * 3 + 8 + 8 + 16
    cblob[count_off:count_off + 8] = (1 << 62).to_bytes(8, "little")
    with pytest.raises(ValueError):
        ser.load_ciphertext(ctx, bytes(cblob))
    wrong = bytearray(ct.save())
    wrong[16:48] = bytes(32)                         # a parms_id not in the chain
    with pytest.raises(ValueError, match="parms_id"):
        ser.load_ciphertext(ctx, bytes(wrong))
    # a ciphertext at the key level is not a ciphertext
    key_level = st.Ciphertext(pk.data.data, tuple(ctx.key_parms_id), True)
    with pytest.raises(ValueError, match="invalid"):
        ser.load_ciphertext(ctx, key_level.save())
    # valid payloads still load
    ser.load_ciphertext(ctx, ct.save())
    ser.load_relin_keys(ctx, rk.save())
    ser.load_public_key(ctx, pk.save())
    ser.load_secret_key(ctx, kg.secret_key().save())


def test_batch_save_refused(bfv):
    ctx, _, pk, _ = bfv
    enc = st.Encryptor(ctx, pk)
    batch = st.dtypes.stack_ciphertexts([enc.encrypt(plain("1")), enc.encrypt(plain("2"))])
    with pytest.raises(ValueError, match="batch"):
        batch.save()
