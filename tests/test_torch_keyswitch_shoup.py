"""The port's Shoup-quotient key switch (config.keyswitch_shoup, kernel K3)
on the CPU, bit for bit.

(d) The plain version of K3 against seal_tpu's Pallas kernel
    _ks_kernel_shoup in interpret mode and against the port's 128-bit plain
    version, at the cases of tests/test_keyswitch_shoup.py; the quotients
    against exact Python ints; a contraction whose lazy sum would overflow
    64 bits is refused.
    Sums and multiples of q past 2^63, which are negative as int64, are
    reduced as the kernel and seal_tpu reduce them.
(e) relinearize and rotate_vector with the flag on, against seal_tpu with
    its flag on (its Pallas key switch in interpret mode, n = 512, and
    n = 256 with 60-bit primes and d = 5), and the port with the flag on
    against the port with it off, on every key switch of the port, with the
    Shoup route shown to be taken.
"""

import numpy as np
import pytest
import torch

import seal_tpu
from seal_tpu.config import config as jax_config
from seal_tpu.dtypes import to_device, to_host
from seal_tpu.ops import keyswitch_pallas as ksp
import seal_tpu_torch as st
from seal_tpu_torch import interop
from seal_tpu_torch.config import config
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import keyswitch, ntt
from seal_tpu_torch.utils import numth


def _rows(rng, lead, moduli, n):
    """Residues below each row's modulus, [*lead, I, N]."""
    q = np.array(moduli, dtype=np.int64)[:, None]
    return rng.integers(0, q, size=lead + (len(moduli), n), dtype=np.int64)


@pytest.mark.parametrize("J,I,n", [(4, 10, 256), (8, 9, 512), (1, 3, 256), (15, 17, 256)])
def test_plain_matches_pallas_and_128bit(J, I, n):
    moduli = [m.value for m in CoeffModulus.create(8192, [44] * I)]
    rng = np.random.default_rng(J * 1000 + I)
    t, k = _rows(rng, (J,), moduli, n), _rows(rng, (J, 2), moduli, n)
    t[..., 0] = k[..., 0] = np.array(moduli) - 1          # q - 1 in every row
    kt = torch.from_numpy(k)
    kq = keyswitch.key_quotients(kt, moduli)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    got = keyswitch.keyswitch_inner_shoup(torch.from_numpy(t), kt, kq, consts, max(moduli))

    assert got.tolist() == keyswitch.keyswitch_inner_plain(
        torch.from_numpy(t), kt, consts).tolist()
    pallas = ksp.keyswitch_inner_shoup_pallas(
        to_device(t.astype(np.uint64)), to_device(k.astype(np.uint64)),
        to_device(kq.numpy().view(np.uint64)), ksp.pack_mod_consts(moduli), interpret=True)
    np.testing.assert_array_equal(got.numpy(), to_host(pallas).view(np.int64))
    quot = kq.numpy().view(np.uint64)
    for c in range(2):
        for i in (0, I - 1):
            assert [int(v) for v in quot[0, c, i, :8]] == [
                (int(v) << 64) // moduli[i] for v in k[0, c, i, :8]]


def test_quotients_use_the_top_bit_and_overflow_is_refused():
    moduli = [m.value for m in CoeffModulus.create(1024, [60, 60])]
    k = torch.tensor(moduli, dtype=torch.int64)[None, None, :, None].expand(1, 2, 2, 4) - 1
    kq = keyswitch.key_quotients(k.contiguous(), moduli)
    assert bool((kq < 0).all())                # floor((q-1)·2^64/q) >= 2^63
    # 2·16·q >= 2^64 for q above 2^59: the lazy 64-bit sum could wrap
    J = 16
    t = torch.zeros((J, 2, 4), dtype=torch.int64)
    keys = torch.zeros((J, 2, 2, 4), dtype=torch.int64)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    with pytest.raises(ValueError, match="2·J·max q"):
        keyswitch.keyswitch_inner_shoup(t, keys, keys, consts, max(moduli))
    with pytest.raises(ValueError, match="CUDA"):
        keyswitch.keyswitch_inner_shoup_cuda(t[:2], keys[:2], keys[:2], consts, max(moduli))
    with pytest.raises(ValueError, match="do not match"):
        keyswitch.keyswitch_inner_shoup(t[:2], keys[:2], keys[:1], consts, max(moduli))


@pytest.mark.parametrize("J,bits", [(7, 60), (8, 60), (3, 61)])
def test_plain_reduces_sums_past_2_63(J, bits):
    """t spans all 64 bits, so about a quarter of the lazy terms land in
    [q, 2q) and some sums pass 2^63; with 61-bit q, q·2^2 passes it too.
    The plain version still gives Σ t·k mod q, and seal_tpu's bits."""
    I, n = 2, 256
    moduli = numth.get_primes(2 * n, bits, I)
    rng = np.random.default_rng(J * 100 + bits)
    t = rng.integers(0, 1 << 64, (J, I, n), dtype=np.uint64).view(np.int64)
    k = _rows(rng, (J, 2), moduli, n)
    kt = torch.from_numpy(k)
    kq = keyswitch.key_quotients(kt, moduli)
    got = keyswitch.keyswitch_inner_shoup(
        torch.from_numpy(t), kt, kq, keyswitch.pack_mod_consts(moduli, "cpu"), max(moduli))

    q = np.array(moduli, dtype=object)[:, None]
    t_o = t.view(np.uint64).astype(object)[:, None]
    k_o, kq_o = k.astype(object), kq.numpy().view(np.uint64).astype(object)
    lazy = ((t_o * k_o - ((t_o * kq_o) >> 64) * q) % (1 << 64)).sum(axis=0)
    assert (lazy >= 1 << 63).any()
    assert (got.numpy() == (t_o * k_o).sum(axis=0) % q).all()
    pallas = ksp.keyswitch_inner_shoup_pallas(
        to_device(t.view(np.uint64)), to_device(k.astype(np.uint64)),
        to_device(kq.numpy().view(np.uint64)), ksp.pack_mod_consts(moduli), interpret=True)
    np.testing.assert_array_equal(got.numpy(), to_host(pallas).view(np.int64))


# -- (e) the flag on every key switch ----------------------------------------------------

def _set_flags(shoup: bool):
    config.keyswitch_shoup = shoup
    jax_config.keyswitch_shoup = shoup


def _relinearize_and_rotate_against_seal_tpu(n, bits):
    """seal_tpu takes its Shoup route only with its Pallas key switch on
    (interpret mode here); the port takes it on either device."""
    old = (config.keyswitch_shoup, jax_config.keyswitch_shoup,
           jax_config.use_pallas_keyswitch)
    try:
        _set_flags(True)
        jax_config.use_pallas_keyswitch = "always"
        sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
        sp.set_poly_modulus_degree(n)
        sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(n, bits))
        sp.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
        sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
        kg = seal_tpu.KeyGenerator(sctx)
        enc = seal_tpu.Encryptor(sctx, kg.create_public_key())
        srk, sgk = kg.create_relin_keys(), kg.create_galois_keys(steps=[1])
        encoder = seal_tpu.CKKSEncoder(sctx)
        sct = enc.encrypt(encoder.encode(np.linspace(-1, 1, encoder.slot_count), 2.0 ** 30))
        sev = seal_tpu.Evaluator(sctx)
        s_relin = sev.relinearize(sev.multiply(sct, sct), srk)
        want = [s_relin.to_numpy(), sev.rotate_vector(s_relin, 1, sgk).to_numpy()]
        assert "_shoup_quot" in srk.__dict__ and "_shoup_quot" in sgk.__dict__

        parms = st.EncryptionParameters(st.SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
        ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
        rk = interop.relin_keys_from_numpy(ctx, [to_host(k) for k in srk.keys])
        gk = interop.galois_keys_from_numpy(
            ctx, [None if k is None else to_host(k) for k in sgk.keys])
        ct = interop.ciphertext_from_numpy(ctx, sct.to_numpy(), sct.parms_id, sct.scale)
        ev = st.Evaluator(ctx)
        got = {}
        for shoup in (True, False):
            config.keyswitch_shoup = shoup
            relin = ev.relinearize(ev.multiply(ct, ct), rk)
            got[shoup] = [relin.to_numpy(), ev.rotate_vector(relin, 1, gk).to_numpy()]
        assert "_shoup_quot" in rk.__dict__ and "_shoup_quot" in gk.__dict__
        for a, b, c in zip(got[True], got[False], want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    finally:
        config.keyswitch_shoup, jax_config.keyswitch_shoup, \
            jax_config.use_pallas_keyswitch = old


def test_relinearize_and_rotate_match_seal_tpu_with_the_flag_on():
    _relinearize_and_rotate_against_seal_tpu(512, [40, 30, 30, 40])


def test_sixty_bit_primes_match_seal_tpu_with_the_flag_on():
    """SEAL-style bits [60] + [40]·4 + [60] with α = 1: d = 5 digits, so
    the 60-bit rows' lazy sums may reach 10·q, past 2^63."""
    _relinearize_and_rotate_against_seal_tpu(256, [60] + [40] * 4 + [60])


@pytest.mark.parametrize("alpha,bits", [(1, [50] * 3 + [60]), (2, [50] * 3 + [55] * 2)])
def test_flag_on_equals_flag_off_on_every_key_switch(alpha, bits):
    """The port's own keys at n = 256: relinearize, relinearize_rescale, a
    NAF rotation, the conjugation and both hoisted branches give the same
    bits with the flag on and off, and the flag-on run computed quotients
    for every key it used (permuted keys too)."""
    n = 256
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gen = torch.Generator().manual_seed(alpha)
    kg = st.KeyGenerator(ctx, gen)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys(steps=list(range(1, 18)) + [0])
    cd = ctx.first_context_data()
    plain = st.Plaintext(ntt.ntt_forward(torch.randint(0, 1 << 20, (3, n), generator=gen),
                                         cd.ntt_tables), tuple(cd.parms_id), 2.0 ** 30)
    ct = st.Encryptor(ctx, kg.secret_key(), gen).encrypt_symmetric(plain)
    ev = st.Evaluator(ctx)

    def run():
        mul = ev.multiply(ct, ct)
        outs = [ev.relinearize(mul, rk), ev.relinearize_rescale(mul, rk),
                ev.rotate_vector(ct, 18, gk), ev.complex_conjugate(ct, gk)]
        outs += ev.rotate_batch_hoisted(ct, [3, 0, 7], gk)
        outs += ev.rotate_batch_hoisted(ct, list(range(1, 18)), gk)
        return [o.to_numpy() for o in outs]

    old = config.keyswitch_shoup
    try:
        config.keyswitch_shoup = False
        off = run()
        assert "_shoup_quot" not in gk.__dict__
        config.keyswitch_shoup = True
        on = run()
    finally:
        config.keyswitch_shoup = old
    for k, (a, b) in enumerate(zip(on, off)):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    assert set(rk.__dict__["_shoup_quot"]) == {0}
    gt = cd.galois_tool
    assert set(gk.__dict__["_perm_quot"]) == {gt.get_elt_from_step(s) for s in (3, 7)}
    assert {gk.get_index(e) for e in gt.get_elts_from_steps(list(range(1, 18)) + [0])} \
        == set(gk.__dict__["_shoup_quot"])
