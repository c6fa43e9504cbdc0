"""The port's Galois automorphisms and Galois keys, on the CPU.

(a) seal_tpu_torch.ops.galois.GaloisTool against seal_tpu's GaloisTool:
    step/element maps, NTT-domain and coefficient-domain tables, and both
    automorphisms applied, bit for bit.
(b) SEAL's own golden vectors (tests/vectors/ckks_n64.json): rotate_vector
    by 1 and complex_conjugate of the file's ciphertext, with Galois keys
    made by seal_tpu from the file's seed and carried across, bit for bit.
(c) The port's own create_galois_keys at n = 1024: rotations and the
    conjugation of its own sparse ciphertext decrypt to the exact
    automorphism of the plaintext within a stated noise bound.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu.dtypes import to_device, to_host
from seal_tpu.ops import modring as jmodring
from seal_tpu.ops.galois import GaloisTool as JaxGaloisTool
from seal_tpu_torch import interop
from seal_tpu_torch.ops import ntt
from seal_tpu_torch.ops.galois import GaloisTool
from seal_tpu_torch.ops.modring import make_mod_consts

V = json.loads((pathlib.Path(__file__).parent / "vectors" / "ckks_n64.json").read_text())


# -- (a) GaloisTool --------------------------------------------------------------

def _elts(gt):
    n = gt.coeff_count
    return [3, 5, 2 * n - 1, gt.get_elt_from_step(-3), gt.get_elt_from_step(n // 2 - 1)]


@pytest.mark.parametrize("log_n", [6, 10])
def test_tables_and_steps_match_seal_tpu(log_n):
    gt, ref = GaloisTool(log_n), JaxGaloisTool(log_n)
    n = 1 << log_n
    for step in (0, 1, -1, 5, -7, n // 2 - 1, -(n // 2 - 1)):
        assert gt.get_elt_from_step(step) == ref.get_elt_from_step(step)
    assert gt.get_elts_from_steps([1, -2, 0]) == ref.get_elts_from_steps([1, -2, 0])
    assert gt.get_elts_all() == ref.get_elts_all()
    for elt in _elts(gt):
        assert gt.get_index_from_elt(elt) == ref.get_index_from_elt(elt)
        np.testing.assert_array_equal(gt.ntt_table(elt), ref._ntt_table(elt))
        src, neg = gt.coeff_table(elt)
        ref_src, ref_neg = ref._coeff_table(elt)
        np.testing.assert_array_equal(src, ref_src)
        np.testing.assert_array_equal(neg, ref_neg)
        inv = gt.ntt_inverse_index(elt).numpy()
        np.testing.assert_array_equal(gt.ntt_table(elt)[inv], np.arange(n))


@pytest.mark.parametrize("log_n", [6, 10])
def test_apply_galois_matches_seal_tpu(log_n):
    n = 1 << log_n
    moduli = [m.value for m in st.CoeffModulus.create(n, [30, 50, 60])]
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, q, (2, n), dtype=np.int64) for q in moduli], axis=1)
    x[..., 0] = 0                     # a zero stays zero under the sign fix
    xt = torch.from_numpy(x)
    pair = to_device(x.astype(np.uint64))
    gt, ref = GaloisTool(log_n), JaxGaloisTool(log_n)
    mc, ref_mc = make_mod_consts(moduli, "cpu"), jmodring.make_mod_consts(moduli)
    for elt in _elts(gt):
        np.testing.assert_array_equal(gt.apply_galois_ntt(xt, elt).numpy(),
                                      to_host(ref.apply_galois_ntt(pair, elt)).view(np.int64))
        np.testing.assert_array_equal(gt.apply_galois(xt, elt, mc).numpy(),
                                      to_host(ref.apply_galois(pair, elt, ref_mc)).view(np.int64))


def test_invalid_elements_raise():
    gt = GaloisTool(6)
    with pytest.raises(ValueError, match="not valid"):
        gt.apply_galois_ntt(torch.zeros((1, 64), dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="not valid"):
        gt.ntt_index(129)
    with pytest.raises(ValueError, match="too large"):
        gt.get_elt_from_step(32)
    with pytest.raises(ValueError, match="not valid"):
        st.GaloisKeys.get_index(1)
    with pytest.raises(ValueError, match="not valid"):
        st.GaloisKeys.get_index(6)


# -- (b) SEAL golden vectors -----------------------------------------------------------

def _ref(name, L, n=64):
    return np.array(V[name], dtype=np.uint64).reshape(L, n)


def test_golden_rotate_and_conjugate():
    """seal_tpu draws pk, rk, then the Galois keys of elements 3 and 2n-1
    from the file's seed, as tests/test_ckks_bitexact.py does."""
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(64)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(64, [40, 40, 40, 40]))
    sp.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
    sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
    kg = seal_tpu.KeyGenerator(sctx)
    kg.create_public_key()
    kg.create_relin_keys()
    sgk = kg.create_galois_keys([3, 127])

    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40, 40]))
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gk = interop.galois_keys_from_numpy(
        ctx, [None if k is None else to_host(k) for k in sgk.keys])
    assert len(gk.keys) == 64 and gk.has_key(3) and gk.has_key(127) and not gk.has_key(5)
    ct1 = interop.ciphertext_from_numpy(
        ctx, np.stack([_ref(f"ct1_c{j}", 3) for j in range(2)]), ctx.first_parms_id,
        2.0 ** V["scale_log2"])
    ev = st.Evaluator(ctx)
    for name, out in (("rot1", ev.rotate_vector(ct1, 1, gk)),
                      ("conj", ev.complex_conjugate(ct1, gk))):
        arr = out.to_numpy()
        for j in range(2):
            np.testing.assert_array_equal(arr[j].reshape(-1),
                                          np.array(V[f"{name}_c{j}"], dtype=np.uint64),
                                          err_msg=f"{name}_c{j}")
        assert out.scale == ct1.scale and tuple(out.parms_id) == tuple(ct1.parms_id)


# -- (c) the port's own Galois keys --------------------------------------------------

N_RT = 1024
ROTATION_NOISE_BOUND = 1 << 8       # |decrypted - exact automorphism|; measured <= 56


def _automorphism(coeffs: dict, elt: int, n: int) -> dict:
    """x^i -> x^(i·elt mod 2n), with x^n = -1."""
    out = {}
    for i, v in coeffs.items():
        k = i * elt % (2 * n)
        out[k % n] = -v if k >= n else v
    return out


@pytest.mark.parametrize("alpha,bits", [(1, [50] * 3 + [60]), (2, [50] * 3 + [55] * 2)])
def test_own_galois_keys_decrypt_to_the_automorphism(alpha, bits):
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N_RT)
    parms.set_coeff_modulus(st.CoeffModulus.create(N_RT, bits))
    parms.set_special_modulus_size(alpha)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gen = torch.Generator().manual_seed(10 + alpha)
    kg = st.KeyGenerator(ctx, gen)
    steps = [1, 2, 8, 0]
    gk = kg.create_galois_keys(steps=steps)
    gt = ctx.key_context_data().galois_tool
    assert len(gk.keys) == N_RT
    assert [i for i, k in enumerate(gk.keys) if k is not None] == sorted(
        gt.get_index_from_elt(e) for e in gt.get_elts_from_steps(steps))
    assert gk.keys[1].shape == (-(-3 // alpha), 2, 3 + alpha, N_RT)
    enc, dec, ev = st.Encryptor(ctx, kg.secret_key(), gen), st.Decryptor(ctx, kg.secret_key()), \
        st.Evaluator(ctx)
    cd = ctx.first_context_data()
    idx = torch.randperm(N_RT, generator=gen)[:6].tolist()
    m = {i: int(v) for i, v in zip(idx, torch.randint(-(1 << 30), 1 << 30, (6,), generator=gen))}
    rows = torch.zeros((cd.coeff_modulus_size, N_RT), dtype=torch.int64)
    for i, v in m.items():
        rows[:, i] = torch.tensor([v % q for q in cd.key_moduli()])
    ct = enc.encrypt_symmetric(st.Plaintext(ntt.ntt_forward(rows, cd.ntt_tables),
                                            tuple(cd.parms_id), 2.0 ** 30))
    # (Galois element, output): rotations by 1 and by 10 (NAF 2 + 8), the
    # conjugation, and a hoisted batch with a zero step
    outs = [(gt.get_elt_from_step(1), ev.rotate_vector(ct, 1, gk)),
            (gt.get_elt_from_step(10), ev.rotate_vector(ct, 10, gk)),
            (2 * N_RT - 1, ev.complex_conjugate(ct, gk))]
    outs += zip([gt.get_elt_from_step(8), 1, gt.get_elt_from_step(2)],
                ev.rotate_batch_hoisted(ct, [8, 0, 2], gk))
    q0 = cd.key_moduli()[0]
    for elt, out in outs:
        exact = _automorphism(m, elt, N_RT)
        phase = ntt.ntt_inverse(dec.decrypt(out).data, cd.ntt_tables)[0].tolist()
        got = [v - q0 if v > q0 // 2 else v for v in phase]
        err = max(abs(got[i] - exact.get(i, 0)) for i in range(N_RT))
        assert err <= ROTATION_NOISE_BOUND, (elt, err)
    with pytest.raises(ValueError, match="Galois key not present"):
        ev.rotate_vector(ct, 4, gk)           # NAF of 4 is one term: no key
    with pytest.raises(ValueError, match="either"):
        kg.create_galois_keys(galois_elts=[3], steps=[1])
    with pytest.raises(ValueError, match="not valid"):
        kg.create_galois_keys(galois_elts=[4])
    assert len(kg.create_galois_keys().keys) == N_RT


def test_create_galois_keys_defaults_to_every_power_of_two_step():
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40]))
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gk = st.KeyGenerator(ctx, torch.Generator().manual_seed(0)).create_galois_keys()
    gt = ctx.key_context_data().galois_tool
    assert [i for i, k in enumerate(gk.keys) if k is not None] == sorted(
        {gt.get_index_from_elt(e) for e in gt.get_elts_all()})
    assert all(k.dtype == torch.int64 and k.device.type == "cpu"
               for k in gk.keys if k is not None)
