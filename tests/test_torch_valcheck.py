"""The port's validity checks (seal_tpu_torch/valcheck.py) on the CPU: the
cases of tests/test_valcheck.py on the port's objects, and each answer
against seal_tpu's valcheck on the same object carried across."""

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu import valcheck as valcheck_ref
from seal_tpu.dtypes import to_device
from seal_tpu_torch import interop
from seal_tpu_torch import serialization as ser
from seal_tpu_torch import valcheck

SEED = (1, 2, 3, 4, 5, 6, 7, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parms(lib, scheme=None):
    parms = lib.EncryptionParameters(scheme or lib.SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(lib.CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    return parms


@pytest.fixture(scope="module")
def env():
    ctx = st.SEALContext(_parms(st), sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    pk = kg.create_public_key()
    ct = st.Encryptor(ctx, pk).encrypt(st.Plaintext.from_hex_string("5", device="cpu"))
    return ctx, kg, pk, ct


@pytest.fixture(scope="module")
def ref_env():
    ctx = seal_tpu.SEALContext(_parms(seal_tpu), sec_level=seal_tpu.SecLevelType.NONE)
    kg = seal_tpu.KeyGenerator(ctx)
    pk = kg.create_public_key()
    ct = seal_tpu.Encryptor(ctx, pk).encrypt(seal_tpu.Plaintext.from_hex_string("5"))
    return ctx, kg, pk, ct


def test_valid_objects(env):
    ctx, kg, pk, ct = env
    assert st.is_valid_for(ct, ctx)
    assert st.is_valid_for(kg.secret_key(), ctx)
    assert st.is_valid_for(pk, ctx)
    assert st.is_valid_for(st.Plaintext.from_hex_string("1x^3 + 2", device="cpu"), ctx)
    assert st.is_valid_for(st.Plaintext(), ctx)
    rk = kg.create_relin_keys()
    assert valcheck.is_metadata_valid_for(rk, ctx) and valcheck.is_valid_for(rk, ctx)
    gk = kg.create_galois_keys([3])
    assert valcheck.is_valid_for(gk, ctx)


def test_ckks_plaintext_and_levels():
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40]))
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    encoder = st.CKKSEncoder(ctx)
    p = encoder.encode(np.linspace(0, 1, encoder.slot_count), 2.0 ** 20)
    assert valcheck.is_valid_for(p, ctx)
    bad = st.Plaintext(p.data.clone(), p.parms_id, p.scale)
    bad.data[1, 7] = ctx.first_context_data().key_moduli()[1]
    assert valcheck.is_metadata_valid_for(bad, ctx) and not valcheck.is_valid_for(bad, ctx)
    wrong = st.Plaintext(p.data[:1], p.parms_id, p.scale)
    assert not valcheck.is_metadata_valid_for(wrong, ctx)


def test_invalid_metadata(env):
    ctx, kg, pk, ct = env
    bad = ct.copy()
    bad.parms_id = (1, 2, 3, 4)
    assert not valcheck.is_metadata_valid_for(bad, ctx)
    key_level = ct.copy()
    key_level.parms_id = tuple(ctx.key_parms_id)
    assert not valcheck.is_metadata_valid_for(key_level, ctx)
    assert valcheck.is_metadata_valid_for(pk.data, ctx, allow_pure_key_levels=True)
    one_poly = ct._with(ct.data[:1])
    assert not valcheck.is_metadata_valid_for(one_poly, ctx)
    sk = kg.secret_key()
    assert not valcheck.is_metadata_valid_for(st.SecretKey(sk.data[:2], sk.parms_id), ctx)
    long = st.Plaintext(65, device="cpu")
    assert not valcheck.is_metadata_valid_for(long, ctx)
    rk = kg.create_relin_keys()
    assert not valcheck.is_metadata_valid_for(st.RelinKeys([rk.keys[0][:1]], rk.parms_id), ctx)
    assert not valcheck.is_metadata_valid_for(st.RelinKeys(rk.keys, ct.parms_id), ctx)
    with pytest.raises(TypeError):
        valcheck.is_metadata_valid_for(object(), ctx)


def test_invalid_data(env):
    ctx, kg, pk, ct = env
    bad = ct.copy()
    bad.data = ct.data.clone()
    # 2^63 is a negative int64: no modulus admits it
    bad.data[0, 0, 0] = torch.tensor(np.uint64(1 << 63).view(np.int64))
    assert not valcheck.is_data_valid_for(bad, ctx)
    bad.data = ct.data.clone()
    bad.data[1, 1, 5] = ctx.first_context_data().key_moduli()[1]
    assert not valcheck.is_data_valid_for(bad, ctx)
    bad.data[1, 1, 5] -= 1
    assert valcheck.is_data_valid_for(bad, ctx)
    p = st.Plaintext(2, device="cpu")
    p.set_values([300, 0])                           # >= t = 257
    assert not valcheck.is_data_valid_for(p, ctx)
    p.set_values([256, 0])
    assert valcheck.is_data_valid_for(p, ctx)


def test_kswitch_data_check(env):
    ctx, kg, pk, ct = env
    rk = kg.create_relin_keys()
    assert valcheck.is_data_valid_for(rk, ctx)
    k = rk.keys[0].clone()
    k[0, 0, 0, 0] = -1                               # the u64 0xFFFF...FFFF
    assert not valcheck.is_data_valid_for(st.RelinKeys([k], rk.parms_id), ctx)
    k = rk.keys[0].clone()
    k[1, 1, 2, 3] = ctx.key_context_data().key_moduli()[2]
    assert not valcheck.is_data_valid_for(st.RelinKeys([k], rk.parms_id), ctx)
    sk = kg.secret_key()
    bad_sk = st.SecretKey(sk.data.clone(), sk.parms_id)
    bad_sk.data[2, 0] = ctx.key_context_data().key_moduli()[2]
    assert not valcheck.is_data_valid_for(bad_sk, ctx)
    bad_pk = st.PublicKey(pk.data._with(pk.data.data.clone()))
    bad_pk.data.data[1, 0, 0] = -5
    assert not valcheck.is_valid_for(bad_pk, ctx)


def test_corrupted_loads_rejected(env):
    ctx, kg, pk, ct = env
    blob = bytearray(ser.save_ciphertext(ct))
    blob[-8:] = (1 << 63).to_bytes(8, "little")
    with pytest.raises(ValueError):
        ser.load_ciphertext(ctx, bytes(blob))
    rk = kg.create_relin_keys()
    kblob = bytearray(ser.save_relin_keys(rk))
    kblob[-8:] = (1 << 63).to_bytes(8, "little")
    with pytest.raises(ValueError):
        ser.load_relin_keys(ctx, bytes(kblob))
    cblob = bytearray(ser.save_ciphertext(ct))
    count_off = 16 + 32 + 1 + 8 * 3 + 8 + 8 + 16
    cblob[count_off:count_off + 8] = (1 << 62).to_bytes(8, "little")
    with pytest.raises(ValueError):
        ser.load_ciphertext(ctx, bytes(cblob))
    ser.load_ciphertext(ctx, ser.save_ciphertext(ct))
    ser.load_relin_keys(ctx, ser.save_relin_keys(rk))
    ser.load_public_key(ctx, ser.save_public_key(pk))
    ser.load_secret_key(ctx, ser.save_secret_key(kg.secret_key()))


@pytest.mark.parametrize("case", ["valid", "bad_parms_id", "key_level", "q", "two_63"])
def test_answers_equal_seal_tpu(env, ref_env, case):
    """The same ciphertext, valid or spoiled one way, gets the same answer
    from both packages' metadata, buffer and data checks."""
    ctx = env[0]
    ref_ctx, _, _, ref_ct = ref_env
    arr = ref_ct.to_numpy().copy()
    ref = ref_ct.copy()
    if case == "q":
        arr[1, 0, 3] = ref_ctx.first_context_data().key_moduli()[0]
    if case == "two_63":
        arr[0, 1, 0] = np.uint64(1 << 63)
    ref.data = to_device(arr)
    if case == "bad_parms_id":
        ref.parms_id = (1, 2, 3, 4)
    if case == "key_level":
        ref.parms_id = tuple(ref_ctx.key_parms_id)
    mine = interop.ciphertext_from_numpy(ctx, arr, ref.parms_id, 1.0, False)
    assert valcheck.is_metadata_valid_for(mine, ctx) == \
        valcheck_ref.is_metadata_valid_for(ref, ref_ctx)
    assert valcheck.is_buffer_valid(mine) == valcheck_ref.is_buffer_valid(ref)
    if case not in ("bad_parms_id", "key_level"):      # the data check needs valid metadata
        assert valcheck.is_data_valid_for(mine, ctx) == \
            valcheck_ref.is_data_valid_for(ref, ref_ctx)
    assert valcheck.is_valid_for(mine, ctx) == valcheck_ref.is_valid_for(ref, ref_ctx)
