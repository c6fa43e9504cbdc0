"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda` marker
and skips without a card. The file imports neither JAX nor seal_tpu, so it
also runs on a machine without them, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

import seal_tpu_torch as st
from seal_tpu_torch import cuda
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import keyswitch, ntt

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


def _residues(shape, moduli, factor, seed):
    """Residues below factor·q of each row's prime (factor·q < 2^63), drawn
    from 63 random bits, with factor·q - 1 and q - 1 in the first two words
    of every row."""
    rng = np.random.default_rng(seed)
    q1 = np.array(moduli, dtype=np.uint64)[:, None]
    q = q1 * np.uint64(factor)
    x = rng.integers(0, 1 << 63, shape, dtype=np.uint64) % q
    x[..., :, 0] = q[:, 0] - np.uint64(1)
    x[..., :, 1] = q1[:, 0] - np.uint64(1)
    return torch.from_numpy(x.view(np.int64))


_NTT_BITS = [30, 50, 60, 40, 45, 55, 35, 58]


def _ntt_moduli(n, count):
    from seal_tpu_torch.utils import numth

    return [numth.get_primes(2 * max(n, 64), bits, 1)[0] for bits in _NTT_BITS[:count]]


# rows 1, 2, 3 as one tower of that many primes, at every log n (each
# one-pass size and each split of the two passes); 56 as [7, 8, n], the
# largest forward of the main path, at some of them. 56 rows at n = 2^17 is
# left out (the plain version takes too long there).
_NTT_SIZES = [(log_n, rows) for log_n in range(1, 18) for rows in (1, 2, 3)] + \
             [(log_n, 56) for log_n in (1, 2, 6, 10, 11, 12, 14, 15)]


@pytest.mark.parametrize("log_n,rows", _NTT_SIZES)
@pytest.mark.parametrize("direction,factor", [("forward", 4), ("inverse", 2)])
def test_ntt_kernel_matches_plain(log_n, rows, direction, factor):
    n = 1 << log_n
    shape = (7, 8, n) if rows == 56 else (rows, n)
    moduli = _ntt_moduli(n, shape[-2])
    t_cpu = ntt.make_ntt_tables(log_n, moduli, "cpu")
    t_dev = ntt.make_ntt_tables(log_n, moduli, "cuda")
    x = _residues(shape, moduli, factor, seed=n + rows)
    for lazy in (False, True):
        plain = getattr(ntt, f"ntt_{direction}_plain")(x, t_cpu, lazy)
        kernel = getattr(ntt, f"ntt_{direction}_cuda")(x.cuda(), t_dev, lazy)
        torch.cuda.synchronize()
        assert torch.equal(kernel.cpu(), plain)


@pytest.mark.parametrize("log_n,shape,bits", [
    (14, (4, 9), 61), (14, (3, 9), 61), (10, (10,), 61), (5, (2, 9), 61),
    (14, (1,), 20), (10, (1,), 20)])
@pytest.mark.parametrize("direction,factor", [("forward", 4), ("inverse", 2)])
def test_ntt_kernel_at_bsk_and_plain_moduli(log_n, shape, bits, direction, factor):
    """The towers of BFV: the auxiliary base Bsk of 61-bit primes, where 4q
    passes 2^62 and the inputs span it, and the one prime of a 20-bit
    plain modulus t (encode and decode)."""
    from seal_tpu_torch.utils import numth

    n = 1 << log_n
    moduli = numth.get_primes(2 * n, bits, shape[-1])
    t_cpu = ntt.make_ntt_tables(log_n, moduli, "cpu")
    t_dev = ntt.make_ntt_tables(log_n, moduli, "cuda")
    x = _residues(shape + (n,), moduli, factor, seed=n + bits)
    if bits == 61 and direction == "forward":
        assert int(x.max()) > 1 << 62
    for lazy in (False, True):
        plain = getattr(ntt, f"ntt_{direction}_plain")(x, t_cpu, lazy)
        kernel = getattr(ntt, f"ntt_{direction}_cuda")(x.cuda(), t_dev, lazy)
        torch.cuda.synchronize()
        assert torch.equal(kernel.cpu(), plain)


@pytest.mark.parametrize("log_n", [15, 17])
def test_ntt_dispatch_runs_large_n_through_the_kernel(log_n):
    """n = 32768 and 131072, which the one-block-per-row kernel refused, go
    through the kernel: one count per transform, the plain version's bits."""
    n = 1 << log_n
    moduli = _ntt_moduli(n, 2)
    t_dev = ntt.make_ntt_tables(log_n, moduli, "cuda")
    t_cpu = ntt.make_ntt_tables(log_n, moduli, "cpu")
    x = _residues((2, n), moduli, 2, seed=log_n)
    before = dict(cuda.launches)
    fwd = ntt.ntt_forward(x.cuda(), t_dev)
    assert cuda.launches["ntt_forward"] == before["ntt_forward"] + 1
    back = ntt.ntt_inverse(fwd, t_dev)
    assert cuda.launches["ntt_inverse"] == before["ntt_inverse"] + 1
    want = ntt.ntt_forward_plain(x, t_cpu)
    assert torch.equal(fwd.cpu(), want)
    assert torch.equal(back.cpu(), ntt.ntt_inverse_plain(want, t_cpu))
    assert torch.equal(back.cpu(), x % torch.tensor(moduli).reshape(2, 1))


@pytest.mark.parametrize("J,I,n", [(1, 1, 64), (8, 9, 16384), (4, 10, 16384), (64, 2, 256)])
def test_keyswitch_kernel_matches_plain(J, I, n):
    """Inputs up to 2^61 and J up to the 64 terms the 128-bit sum holds."""
    rng = np.random.default_rng(J * 100 + I)
    moduli = [m.value for m in CoeffModulus.create(max(n, 1024), [60] * I)]
    t = rng.integers(0, 1 << 61, (J, I, n), dtype=np.int64)
    k = rng.integers(0, 1 << 61, (J, 2, I, n), dtype=np.int64)
    t[..., 0] = k[..., 0] = (1 << 61) - 1
    t, k = torch.from_numpy(t), torch.from_numpy(k)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_plain(t, k, consts)
    kernel = keyswitch.keyswitch_inner(t.cuda(), k.cuda(), consts.cuda())
    assert torch.equal(kernel.cpu(), plain)


@pytest.mark.parametrize("J,I,n", [(1, 1, 64), (8, 9, 16384), (4, 10, 16384), (15, 17, 256)])
def test_keyswitch_shoup_kernel_matches_plain_and_k2(J, I, n):
    """K3 against its plain version and against K2. t and k reach q - 1,
    and keys at q - 1 have quotients with the top bit set; 2·J·max q stays
    below 2^64 (54-bit moduli, J <= 15)."""
    rng = np.random.default_rng(J * 100 + I + 7)
    moduli = [m.value for m in CoeffModulus.create(max(n, 1024), [54] * I)]
    q = np.array(moduli, dtype=np.int64)[:, None]
    t = rng.integers(0, q, (J, I, n), dtype=np.int64)
    k = rng.integers(0, q, (J, 2, I, n), dtype=np.int64)
    t[..., 0] = k[..., 0] = k[..., 1] = q[:, 0] - 1
    t, k = torch.from_numpy(t), torch.from_numpy(k)
    kq = keyswitch.key_quotients(k, moduli)
    assert bool((kq[..., 0] < 0).all())
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts, max(moduli))
    before = cuda.launches["keyswitch_inner_shoup"]
    kernel = keyswitch.keyswitch_inner_shoup(
        t.cuda(), k.cuda(), kq.cuda(), consts.cuda(), max(moduli))
    assert cuda.launches["keyswitch_inner_shoup"] == before + 1
    assert torch.equal(kernel.cpu(), plain)
    assert torch.equal(kernel, keyswitch.keyswitch_inner(t.cuda(), k.cuda(), consts.cuda()))
    kq_dev = keyswitch.key_quotients(k.cuda(), moduli)
    assert torch.equal(kq_dev.cpu(), kq)


@pytest.mark.parametrize("J,bits,n", [(7, 60, 16384), (8, 60, 4096), (3, 61, 4096)])
def test_keyswitch_shoup_kernel_matches_plain_past_2_63(J, bits, n):
    """t spans all 64 bits, so lazy sums (and, with 61-bit q, q·2^2) pass
    2^63; the kernel compares unsigned, and so must the plain version."""
    from seal_tpu_torch.utils import numth

    I = 2
    moduli = numth.get_primes(2 * n, bits, I)
    rng = np.random.default_rng(J * 100 + bits)
    t = torch.from_numpy(rng.integers(0, 1 << 64, (J, I, n), dtype=np.uint64).view(np.int64))
    q = np.array(moduli, dtype=np.int64)[:, None]
    k = torch.from_numpy(rng.integers(0, q, (J, 2, I, n), dtype=np.int64))
    kq = keyswitch.key_quotients(k, moduli)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts, max(moduli))
    kernel = keyswitch.keyswitch_inner_shoup(
        t.cuda(), k.cuda(), kq.cuda(), consts.cuda(), max(moduli))
    assert torch.equal(kernel.cpu(), plain)
    assert bool(((plain >= 0) & (plain < torch.from_numpy(q))).all())


def test_keyswitch_shoup_kernel_refuses_overflow():
    moduli = [m.value for m in CoeffModulus.create(1024, [60])]
    consts = keyswitch.pack_mod_consts(moduli, "cuda")
    t = torch.zeros((16, 1, 64), dtype=torch.int64, device="cuda")
    k = torch.zeros((16, 2, 1, 64), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="2·J·max q"):
        keyswitch.keyswitch_inner_shoup(t, k, k, consts, max(moduli))


def _small_plain(cd, seed):
    """An NTT-form plaintext of coefficients below 2^20 on cd's device."""
    rows = np.random.default_rng(seed).integers(
        0, 1 << 20, (cd.coeff_modulus_size, cd.parms.poly_modulus_degree))
    return st.Plaintext(ntt.ntt_forward(torch.from_numpy(rows).to(cd.device), cd.ntt_tables),
                        tuple(cd.parms_id), 2.0 ** 30)


@pytest.mark.parametrize("alpha,bits", [(1, [50] * 4 + [60]), (2, [50] * 4 + [55] * 2)])
def test_rotations_on_card_match_cpu(alpha, bits):
    """rotate_vector (with the NAF fallback), complex_conjugate and both
    hoisted branches at n = 1024, with the Shoup flag off and on: the
    card's bits equal the plain path's, and the flag changes no bit."""
    from seal_tpu_torch import interop
    from seal_tpu_torch.config import config

    n = 1024
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed((alpha,) * 8)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE)
    cpu = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    steps = list(range(1, 18))
    gk = kg.create_galois_keys(steps=steps + [0])
    ct = st.Encryptor(ctx, kg.secret_key()).encrypt_symmetric(
        _small_plain(ctx.first_context_data(), alpha))
    ct_cpu = interop.ciphertext_from_numpy(cpu, ct.to_numpy(), ct.parms_id, ct.scale)
    gk_cpu = interop.galois_keys_from_numpy(
        cpu, [None if k is None else k.cpu().numpy().view(np.uint64) for k in gk.keys])

    def run(ev, keys, c):
        outs = [ev.rotate_vector(c, 18, keys), ev.complex_conjugate(c, keys)]
        outs += ev.rotate_batch_hoisted(c, [3, 7], keys)
        outs += ev.rotate_batch_hoisted(c, steps, keys)
        return [o.to_numpy() for o in outs]

    old = config.keyswitch_shoup
    try:
        got = {}
        for shoup in (False, True):
            config.keyswitch_shoup = shoup
            before = cuda.launches["keyswitch_inner_shoup"]
            got[shoup] = run(st.Evaluator(ctx), gk, ct)
            assert (cuda.launches["keyswitch_inner_shoup"] > before) == shoup
        config.keyswitch_shoup = False
        want = run(st.Evaluator(cpu), gk_cpu, ct_cpu)
    finally:
        config.keyswitch_shoup = old
    for a, b, c in zip(got[False], got[True], want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("alpha,bits,n", [(1, [50] * 4 + [60], 1024),
                                          (2, [50] * 4 + [55] * 2, 1024),
                                          (1, [50] * 3 + [60], 32768)])
def test_pipeline_on_card_matches_cpu(alpha, bits, n):
    """multiply -> relinearize -> rescale and the fused tail at n = 1024,
    and at n = 32768 with 4 primes (two-pass transforms on the card): the
    card's bits equal the plain path's on the same keys and inputs."""
    from seal_tpu_torch import interop

    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed((alpha, n) * 4)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE)
    cpu = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    enc = st.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    plain = _small_plain(ctx.first_context_data(), alpha)
    cts = [enc.encrypt(plain), enc.encrypt_symmetric(plain)]
    carried = [interop.ciphertext_from_numpy(cpu, c.to_numpy(), c.parms_id, c.scale)
               for c in cts]
    rk_cpu = interop.relin_keys_from_numpy(cpu, [k.cpu().numpy().view(np.uint64)
                                                 for k in rk.keys])
    for ev, (a, b), keys in ((st.Evaluator(ctx), cts, rk), (st.Evaluator(cpu), carried, rk_cpu)):
        mul = ev.multiply(a, b)
        out = [ev.rescale_to_next(ev.relinearize(mul, keys)), ev.relinearize_rescale(mul, keys)]
        if ev.context is ctx:
            got = [o.to_numpy() for o in out]
        else:
            want = [o.to_numpy() for o in out]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scheme,n,alpha", [("BFV", 1024, 1), ("BGV", 1024, 2),
                                            ("BFV", 16384, 1), ("BGV", 16384, 1)])
def test_exact_schemes_on_card_match_cpu(scheme, n, alpha):
    """BFV and BGV at n = 1024 (bits [50]*4 and α special primes) and at
    SEAL's default n = 16384 parameters: keys made on the card, encode ->
    encrypt -> multiply -> relinearize -> mod switch -> rotate_rows /
    rotate_columns, square and multiply_plain; the card's bits equal the
    plain path's on CPU copies, and every decode the exact slotwise result."""
    from seal_tpu_torch import interop

    scheme = st.SchemeType[scheme]
    t = st.PlainModulus.batching(n, 20).value
    parms = st.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.bfv_default(n) if n == 16384 else
                            st.CoeffModulus.create(n, [50] * 4 + [60 - 5 * alpha] * alpha))
    parms.set_plain_modulus(t)
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed((alpha, n) * 4)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE)
    cpu = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    sk, rk, gk = kg.secret_key(), kg.create_relin_keys(), kg.create_galois_keys(steps=[1, 0])
    be = st.BatchEncoder(ctx)
    rng = np.random.default_rng(n)
    m1, m2 = (rng.integers(0, t, n, dtype=np.int64) for _ in range(2))
    enc = st.Encryptor(ctx, kg.create_public_key(), sk)
    ct1, ct2, p2 = enc.encrypt(be.encode(m1)), enc.encrypt_symmetric(be.encode(m2)), \
        be.encode(m2)

    def run(ev, rk, gk, a, b, p):
        mul = ev.multiply(a, b)
        ms = ev.mod_switch_to_next(ev.relinearize(mul, rk))
        return {"multiply": mul, "mod_switch": ms, "rotate_rows": ev.rotate_rows(ms, 1, gk),
                "rotate_columns": ev.rotate_columns(ms, gk), "square": ev.square(a),
                "multiply_plain": ev.multiply_plain(a, p)}

    got = run(st.Evaluator(ctx), rk, gk, ct1, ct2, p2)

    def carry(c):
        return interop.ciphertext_from_numpy(cpu, c.to_numpy(), c.parms_id, 1.0, False,
                                             c.correction_factor)

    want = run(st.Evaluator(cpu),
               interop.relin_keys_from_numpy(cpu, [k.cpu().numpy().view(np.uint64)
                                                   for k in rk.keys]),
               interop.galois_keys_from_numpy(
                   cpu, [None if k is None else k.cpu().numpy().view(np.uint64)
                         for k in gk.keys]),
               carry(ct1), carry(ct2), interop.plaintext_from_numpy(cpu, p2.to_numpy()))
    prod = m1 * m2 % t
    rows = prod.reshape(2, n // 2)
    exact = {"multiply": prod, "mod_switch": prod,
             "rotate_rows": np.roll(rows, -1, axis=1).reshape(-1),
             "rotate_columns": rows[::-1].reshape(-1), "square": m1 * m1 % t,
             "multiply_plain": prod}
    dec = st.Decryptor(ctx, sk)
    for name, ct in got.items():
        np.testing.assert_array_equal(ct.to_numpy(), want[name].to_numpy(), err_msg=name)
        assert ct.correction_factor == want[name].correction_factor, name
        np.testing.assert_array_equal(be.decode(dec.decrypt(ct)).cpu().numpy(), exact[name],
                                      err_msg=name)


def _ckks_context(n, bits, alpha, seed, device=None):
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed(seed)
    return st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device=device)


@pytest.mark.parametrize("alpha,bits", [(1, [50] * 4 + [60]), (2, [50] * 4 + [55] * 2)])
def test_ckks_round_trip_on_card_matches_cpu(alpha, bits):
    """From one random seed the card and the CPU each make sk, pk and rk,
    encode two complex vectors, encrypt them (public and secret key),
    multiply -> relinearize -> rescale, decrypt and decode: every key,
    plaintext, ciphertext and decoded double is the same on both, and the
    decoded product is within 1e-4 of the exact one."""
    n = 1024
    rng = np.random.default_rng(alpha)
    v1, v2 = (rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2) for _ in range(2))
    runs = []
    for device in ("cuda", "cpu"):
        ctx = _ckks_context(n, bits, alpha, (alpha, 5) * 4, device)
        kg = st.KeyGenerator(ctx)
        pk, rk = kg.create_public_key(), kg.create_relin_keys()
        encoder, ev = st.CKKSEncoder(ctx), st.Evaluator(ctx)
        enc = st.Encryptor(ctx, pk, kg.secret_key())
        p1, p2 = encoder.encode(v1, 2.0 ** 40), encoder.encode(v2, 2.0 ** 40)
        c1, c2 = enc.encrypt(p1), enc.encrypt_symmetric(p2)
        out = ev.rescale_to_next(ev.relinearize(ev.multiply(c1, c2), rk))
        plain = st.Decryptor(ctx, kg.secret_key()).decrypt(out)
        decoded = encoder.decode(plain, complex_out=True).cpu().numpy()
        runs.append([kg.secret_key().to_numpy(), pk.to_numpy(), rk.keys[0].cpu().numpy(),
                     p1.to_numpy(), p2.to_numpy(), c1.to_numpy(), c2.to_numpy(),
                     out.to_numpy(), plain.to_numpy(), decoded])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert np.abs(runs[0][-1] - v1 * v2).max() <= 1e-4


def test_noise_budget_chain_on_card():
    """tests/vectors/noise_budget_chain.json (SEAL's budgets along a BFV
    chain at n = 8192 from seed (1, ..., 8)) on the card."""
    import json
    import pathlib

    steps = json.loads((pathlib.Path(__file__).parent / "vectors" /
                        "noise_budget_chain.json").read_text())["steps"]
    parms = st.EncryptionParameters(st.SchemeType.BFV)
    parms.set_poly_modulus_degree(8192)
    parms.set_coeff_modulus(st.CoeffModulus.create(8192, [43, 43, 43, 43, 46]))
    parms.set_plain_modulus(st.PlainModulus.batching(8192, 20))
    parms.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
    ctx = st.SEALContext(parms)
    kg = st.KeyGenerator(ctx)
    rk, ev, be = kg.create_relin_keys(), st.Evaluator(ctx), st.BatchEncoder(ctx)
    dec = st.Decryptor(ctx, kg.secret_key())
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(
        be.encode(np.arange(8192, dtype=np.int64) % 7))
    got = [["fresh", dec.invariant_noise_budget(ct)]]
    for _ in range(4):
        ct = ev.multiply(ct, ct)
        got.append(["multiply", dec.invariant_noise_budget(ct)])
        ct = ev.relinearize(ct, rk)
        got.append(["relinearize", dec.invariant_noise_budget(ct)])
        if ctx.get_context_data(ct.parms_id).next_context_data is None:
            break
        ct = ev.mod_switch_to_next(ct)
        got.append(["mod_switch", dec.invariant_noise_budget(ct)])
    assert got == steps


def test_large_coefficient_encodes_on_card():
    """ckks_encode_big_n1024.json: coefficients past 2^64 (scales 2^80 and
    2^150) reduce on the card as SEAL reduces them."""
    import json
    import pathlib

    vec = json.loads((pathlib.Path(__file__).parent / "vectors" /
                      "ckks_encode_big_n1024.json").read_text())
    n = vec["n"]
    encoder = st.CKKSEncoder(_ckks_context(n, vec["bits"], 1, None))
    i = np.arange(n >> 1, dtype=np.float64)
    v = ((i % 89) / 89.0 - 0.4) + 1j * ((i % 23) / 23.0)
    for lg in (80, 150):
        np.testing.assert_array_equal(
            encoder.encode(v, 2.0 ** lg).to_numpy().reshape(-1),
            np.array(vec[f"plain_{lg}"], dtype=np.uint64), err_msg=f"scale 2^{lg}")


# -- batches ---------------------------------------------------------------------

_BATCH_CASES = [(B, J, I, n) for B in (1, 2, 16) for J, I, n in
                ((1, 3, 4096), (4, 10, 16384), (8, 9, 16384))] + \
               [(3, 8, 9, 1024), (9, 4, 5, 1024)]


def _batched_operands(B, J, I, n, bits, seed):
    """t [B, J, I, N] and one key k [J, 2, I, N] below q (t and k at q - 1 in
    every row's first word), the key's quotients and the constants."""
    rng = np.random.default_rng(seed)
    moduli = [m.value for m in CoeffModulus.create(max(n, 1024), [bits] * I)]
    q = np.array(moduli, dtype=np.int64)[:, None]
    t = rng.integers(0, q, (B, J, I, n), dtype=np.int64)
    k = rng.integers(0, q, (J, 2, I, n), dtype=np.int64)
    t[..., 0] = k[..., 0] = q[:, 0] - 1
    t, k = torch.from_numpy(t), torch.from_numpy(k)
    return moduli, t, k, keyswitch.key_quotients(k, moduli), \
        keyswitch.pack_mod_consts(moduli, "cpu")


@pytest.mark.parametrize("B,J,I,n", _BATCH_CASES)
def test_keyswitch_kernels_batched_match_plain(B, J, I, n):
    """K2 and K3 over a batch [B, J, I, N] that shares one key: one launch
    each, equal to the plain versions' batch bit for bit, and member for
    member to the unbatched kernel (54-bit primes keep 2·J·max q < 2^64)."""
    moduli, t, k, kq, consts = _batched_operands(B, J, I, n, 54, B * 1000 + J * 10 + I)
    dev = [a.cuda() for a in (t, k, kq, consts)]
    before = dict(cuda.launches)
    k2 = keyswitch.keyswitch_inner(dev[0], dev[1], dev[3])
    k3 = keyswitch.keyswitch_inner_shoup(*dev, max(moduli))
    assert cuda.launches["keyswitch_inner"] == before["keyswitch_inner"] + 1
    assert cuda.launches["keyswitch_inner_shoup"] == before["keyswitch_inner_shoup"] + 1
    assert k2.shape == (B, 2, I, n)
    want = keyswitch.keyswitch_inner_plain(t, k, consts)
    assert torch.equal(k2.cpu(), want)
    assert torch.equal(k3.cpu(), keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts,
                                                                       max(moduli)))
    assert torch.equal(k3, k2)
    for b in (0, B - 1):
        assert torch.equal(keyswitch.keyswitch_inner(dev[0][b], dev[1], dev[3]), k2[b])


@pytest.mark.parametrize("B,J,bits,n", [(16, 7, 60, 4096), (5, 3, 61, 4096)])
def test_keyswitch_shoup_kernel_batched_past_2_63(B, J, bits, n):
    """The past-2^63 sums of test_keyswitch_shoup_kernel_matches_plain_past_2_63
    over a batch: t spans all 64 bits."""
    from seal_tpu_torch.utils import numth

    I = 2
    moduli = numth.get_primes(2 * n, bits, I)
    rng = np.random.default_rng(B * 100 + bits)
    t = torch.from_numpy(rng.integers(0, 1 << 64, (B, J, I, n), dtype=np.uint64).view(np.int64))
    q = np.array(moduli, dtype=np.int64)[:, None]
    k = torch.from_numpy(rng.integers(0, q, (J, 2, I, n), dtype=np.int64))
    kq = keyswitch.key_quotients(k, moduli)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts, max(moduli))
    kernel = keyswitch.keyswitch_inner_shoup(
        t.cuda(), k.cuda(), kq.cuda(), consts.cuda(), max(moduli))
    assert torch.equal(kernel.cpu(), plain)


def _batch_vs_sequential(ctx, ops, cts, rk, gk=None):
    """Each op on the stacked batch against the op on each member, on ctx's
    device, flag off and on; the batch launches each kernel as often as one
    member does."""
    from seal_tpu_torch.config import config
    from seal_tpu_torch.dtypes import stack_ciphertexts

    ev = st.Evaluator(ctx)
    batch = stack_ciphertexts(cts)
    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        try:
            for name, op in ops.items():
                cuda.reset_launches()
                got = op(ev, batch, rk, gk)
                batch_launches = dict(cuda.launches)
                for b, ct in enumerate(cts):
                    cuda.reset_launches()
                    want = op(ev, ct, rk, gk)
                    assert dict(cuda.launches) == batch_launches, (name, shoup)
                    assert torch.equal(got.data[b], want.data), (name, shoup, b)
                    assert tuple(got.parms_id) == tuple(want.parms_id)
                    assert got.correction_factor == want.correction_factor
        finally:
            config.keyswitch_shoup = False


@pytest.mark.parametrize("alpha,bits", [(2, [44] * 8 + [43] * 2), (1, [48] * 8 + [54])])
def test_ckks_batch_on_card_matches_sequential(alpha, bits):
    """bench.py's headline configurations at n = 16384, B = 4: encode_many ->
    encrypt_many -> the stacked batch through multiply -> relinearize ->
    rescale (and the fused tail), rotations; each member bit for bit its own
    sequential call on the card."""
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(16384)
    parms.set_coeff_modulus(st.CoeffModulus.create(16384, bits))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed((alpha, 6) * 4)
    ctx = st.SEALContext(parms)
    kg = st.KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys(steps=[1, 2, 0])
    enc = st.Encryptor(ctx, kg.create_public_key())
    encoder = st.CKKSEncoder(ctx)
    rng = np.random.default_rng(alpha)
    values = rng.uniform(-1, 1, (4, 8192))
    plains = encoder.encode_many(values, 2.0 ** 40)
    cts = enc.encrypt_many(plains)
    for p, ct, v in zip(plains, cts, values):
        assert torch.equal(p.data, encoder.encode(v, 2.0 ** 40).data)
        assert torch.equal(ct.data, enc.encrypt(p).data)
    ops = {"mult_relin_rescale": lambda ev, c, rk, gk: ev.rescale_to_next(
               ev.relinearize(ev.multiply(c, c), rk)),
           "mult_relin_rescale_fused": lambda ev, c, rk, gk: ev.relinearize_rescale(
               ev.multiply(c, c), rk),
           "rotate_vector": lambda ev, c, rk, gk: ev.rotate_vector(c, 1, gk),
           "conjugate": lambda ev, c, rk, gk: ev.complex_conjugate(c, gk),
           "hoisted": lambda ev, c, rk, gk: ev.rotate_batch_hoisted(c, [1, 2], gk)[1]}
    _batch_vs_sequential(ctx, ops, cts, rk, gk)


@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_exact_batch_on_card_matches_sequential(scheme):
    """BFV and BGV at bfv_default(16384), B = 2: multiply -> relinearize ->
    mod switch -> rotate_rows and multiply_plain on the stacked batch against
    each member's sequential call on the card; decrypt_many against decrypt."""
    scheme = st.SchemeType[scheme]
    parms = st.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(16384)
    parms.set_coeff_modulus(st.CoeffModulus.bfv_default(16384))
    parms.set_plain_modulus(st.PlainModulus.batching(16384, 20))
    parms.set_random_seed((int(scheme), 6) * 4)
    ctx = st.SEALContext(parms)
    kg = st.KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys(steps=[1])
    enc = st.Encryptor(ctx, kg.create_public_key())
    be = st.BatchEncoder(ctx)
    t = parms.plain_modulus.value
    values = np.random.default_rng(int(scheme)).integers(0, t, (2, 16384))
    plains = be.encode_many(values)
    cts = enc.encrypt_many(plains)
    ops = {"mult_relin_modswitch_rotate": lambda ev, c, rk, gk: ev.rotate_rows(
               ev.mod_switch_to_next(ev.relinearize(ev.multiply(c, c), rk)), 1, gk),
           "multiply_plain": lambda ev, c, rk, gk: ev.multiply_plain(c, plains[1])}
    _batch_vs_sequential(ctx, ops, cts, rk, gk)
    dec = st.Decryptor(ctx, kg.secret_key())
    many = dec.decrypt_many(cts)
    for p, ct in zip(many, cts):
        assert torch.equal(p.data, dec.decrypt(ct).data)
    assert np.array_equal(be.decode_many(many).cpu().numpy(), values)


def _threshold_contexts(scheme, n, device=None):
    """Three parties' contexts at n, each with its own seed (10 + i, 2, ...,
    8): BFV with a 20-bit batching t, CKKS at α = 1."""
    out = []
    for i in range(3):
        parms = st.EncryptionParameters(st.SchemeType[scheme])
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(st.CoeffModulus.create(n, [50] * 4 + [60]))
        if scheme == "BFV":
            parms.set_plain_modulus(st.PlainModulus.batching(n, 20))
        parms.set_random_seed((10 + i, 2, 3, 4, 5, 6, 7, 8))
        out.append(st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device=device))
    return out


def _threshold_flow(ctxs, values):
    """Party keys -> shared-c1 public keys -> Galois shares under party 0's
    c1 -> common keys -> encrypt under the common key -> rotate under the
    aggregated keys (flag off and on) -> partials -> aggregate."""
    from seal_tpu_torch.config import config

    ckks = ctxs[0].key_context_data().parms.scheme == st.SchemeType.CKKS
    kgs = [st.KeyGenerator(c) for c in ctxs]
    sks = [kg.generate_secret_key() for kg in kgs]
    pks = [kgs[0].create_public_key_with_sk(sks[0])]
    pks += [kgs[i].create_public_key_with_same_c1(sks[i], pks[0]) for i in (1, 2)]
    n = ctxs[0].key_context_data().parms.poly_modulus_degree
    elts = [3] + ([] if ckks else [2 * n - 1])
    gks = [kgs[0].create_galois_keys(elts, secret_key=sks[0])]
    refs = [gks[0].key(e)[:, 1] for e in elts]
    gks += [kgs[i].create_galois_keys(elts, secret_key=sks[i], c1_refs_per_elt=refs)
            for i in (1, 2)]
    cpk, csk = kgs[0].create_common_public_key(pks), kgs[0].create_common_secret_key(sks)
    common = kgs[0].aggregate_galois_keys(elts, gks)
    plain = (st.CKKSEncoder(ctxs[0]).encode(values, 2.0 ** 40) if ckks
             else st.BatchEncoder(ctxs[0]).encode(values))
    ct = st.Encryptor(ctxs[0], cpk).encrypt(plain)
    ev = st.Evaluator(ctxs[0])
    rotate = ((lambda: ev.rotate_vector(ct, 1, common)) if ckks
              else (lambda: ev.rotate_rows(ct, 1, common)))
    rot = rotate()
    config.keyswitch_shoup = True
    try:
        rot_shoup = rotate()
    finally:
        config.keyswitch_shoup = False
    decs = [st.Decryptor(c, sk) for c, sk in zip(ctxs, sks)]
    partials = [d.distributed_decrypt(rot) for d in decs]
    agg = decs[0].aggregate_partial_decryption(rot, partials)
    return dict(sks=sks, pks=pks, gks=gks, cpk=cpk, csk=csk, common=common, elts=elts, ct=ct,
                rot=rot, rot_shoup=rot_shoup, partials=partials, agg=agg, decs=decs)


def _threshold_values(scheme, n):
    rng = np.random.default_rng(n)
    if scheme == "CKKS":
        return rng.uniform(-1, 1, n // 2)
    return rng.integers(0, st.PlainModulus.batching(n, 20).value, n, dtype=np.int64)


def _u64(t):
    return t.cpu().numpy().view(np.uint64)


@pytest.mark.parametrize("scheme", ["BFV", "CKKS"])
def test_threshold_flow_on_card_matches_cpu(scheme):
    """The fork's threshold flow at n = 4096, three parties: every key,
    Galois share, ciphertext, partial and aggregate made on the card equals
    the plain path's on CPU contexts from the same seeds; the aggregate
    equals the common secret key's decryption and decodes to the rotated
    slots; K1, K2 and K3 each launched; smudged partials (20 bits) still
    decode (BFV exactly, CKKS within 1e-3)."""
    n = 4096
    values = _threshold_values(scheme, n)
    cuda.reset_launches()
    card = _threshold_flow(_threshold_contexts(scheme, n), values)
    torch.cuda.synchronize()
    assert all(cuda.launches[k] > 0 for k in cuda.launches), dict(cuda.launches)
    cpu = _threshold_flow(_threshold_contexts(scheme, n, device="cpu"), values)
    for name in ("cpk", "csk", "ct", "rot", "rot_shoup", "agg"):
        np.testing.assert_array_equal(card[name].to_numpy(), cpu[name].to_numpy(), err_msg=name)
    for i in range(3):
        for name in ("sks", "pks", "partials"):
            np.testing.assert_array_equal(card[name][i].to_numpy(), cpu[name][i].to_numpy(),
                                          err_msg=f"{name}{i}")
        for e in card["elts"]:
            np.testing.assert_array_equal(_u64(card["gks"][i].key(e)),
                                          _u64(cpu["gks"][i].key(e)))
    for e in card["elts"]:
        np.testing.assert_array_equal(_u64(card["common"].key(e)), _u64(cpu["common"].key(e)))
    np.testing.assert_array_equal(card["rot"].to_numpy(), card["rot_shoup"].to_numpy())
    ctx = card["decs"][0].context
    direct = st.Decryptor(ctx, card["csk"]).decrypt(card["rot"])
    assert torch.equal(direct.data, card["agg"].data)
    smudged = [d.distributed_decrypt(card["rot"], 20) for d in card["decs"]]
    agg_smudged = card["decs"][0].aggregate_partial_decryption(card["rot"], smudged)
    if scheme == "CKKS":
        encoder = st.CKKSEncoder(ctx)
        want = np.roll(values, -1)
        assert np.abs(encoder.decode(card["agg"]).cpu().numpy() - want).max() < 1e-4
        assert np.abs(encoder.decode(agg_smudged).cpu().numpy() - want).max() < 1e-3
    else:
        be = st.BatchEncoder(ctx)
        want = np.roll(values.reshape(2, n // 2), -1, axis=1).reshape(-1)
        np.testing.assert_array_equal(be.decode(card["agg"]).cpu().numpy(), want)
        np.testing.assert_array_equal(be.decode(agg_smudged).cpu().numpy(), want)


@pytest.mark.parametrize("scheme", ["BFV", "CKKS"])
def test_wire_round_trip_on_card(scheme):
    """The threshold objects at n = 4096 through save (ZLIB) -> load onto
    the card: the card's bytes equal the CPU copy's, each load equals the
    original and is valid, and a copy with one residue set to q is not; a
    save_seed relinearization key is about half its unseeded twin."""
    from seal_tpu_torch import serialization as ser
    from seal_tpu_torch import valcheck

    n = 4096
    values = _threshold_values(scheme, n)
    ctxs, ctxs_cpu = _threshold_contexts(scheme, n), _threshold_contexts(scheme, n, "cpu")
    card, cpu = _threshold_flow(ctxs, values), _threshold_flow(ctxs_cpu, values)
    mode = ser.ComprMode.ZLIB
    cases = [(p, q, ser.load_ciphertext) for p, q in zip(card["partials"], cpu["partials"])]
    cases += [(g, h, ser.load_galois_keys) for g, h in zip(card["gks"], cpu["gks"])]
    cases += [(card["cpk"], cpu["cpk"], ser.load_public_key)]
    loaded = []
    for obj, obj_cpu, load in cases:
        blob = obj.save(mode)
        assert blob == obj_cpu.save(mode)
        back = load(ctxs[0], blob)
        assert valcheck.is_valid_for(back, ctxs[0])
        loaded.append(back)
        if isinstance(back, st.GaloisKeys):
            for e in card["elts"]:
                assert torch.equal(back.key(e), obj.key(e))
                assert back.key(e).device.type == ctxs[0].device.type == "cuda"
            back.keys[(card["elts"][0] - 1) // 2][0, 0, 0, 0] = ctxs[0].key_context_data() \
                .key_moduli()[0]
        else:
            ct = back.data if isinstance(back, st.PublicKey) else back
            want = obj.data if isinstance(obj, st.PublicKey) else obj
            assert torch.equal(ct.data, want.data)
            assert ct.data.device.type == ctxs[0].device.type == "cuda"
            ct.data[0, 0, 0] = ctxs[0].key_context_data().key_moduli()[0]
        assert not valcheck.is_valid_for(back, ctxs[0])
    kg = st.KeyGenerator(ctxs[0])
    seeded, plain_rk = kg.create_relin_keys(save_seed=True), kg.create_relin_keys()
    blob = seeded.save(mode)
    assert 0.45 < len(blob) / len(plain_rk.save(mode)) < 0.55
    back = ser.load_relin_keys(ctxs[0], blob)
    assert torch.equal(back.keys[0], seeded.keys[0]) and back.seeds == seeded.seeds
    assert back.save(mode) == blob


def _tp_relinearize_on_card(rank, alpha, bits):
    """One rank: multiply -> TPEvaluator.relinearize (and the fused tail at
    α = 2) on its card against the unsharded card Evaluator, Shoup flag off
    and on; the census and the kernel launches of each split op."""
    from seal_tpu_torch.config import config
    from seal_tpu_torch.parallel import HEMesh, TPEvaluator

    hm = HEMesh(1, rank.world)
    n = 4096
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed((7,) + (0,) * 7)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device=hm.device)
    kg = st.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    enc = st.Encryptor(ctx, kg.create_public_key())
    encoder = st.CKKSEncoder(ctx)
    rng = np.random.default_rng(7)
    a, b = (enc.encrypt(encoder.encode(rng.uniform(-1, 1, n // 2), 2.0 ** 40))
            for _ in range(2))
    ev, tev = st.Evaluator(ctx), TPEvaluator(ctx, hm)
    m = ev.multiply(a, b)
    out = {}
    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        try:
            ops = {"relinearize": lambda e: e.relinearize(m, rk)}
            if alpha > 1:
                ops["relinearize_rescale"] = lambda e: e.relinearize_rescale(m, rk)
            for name, op in ops.items():
                want = op(ev)
                hm.census.reset()
                cuda.reset_launches()
                got = op(tev)
                torch.cuda.synchronize()
                out[f"{name}/{shoup}"] = dict(
                    same=torch.equal(got.data, want.data) and got.parms_id == want.parms_id,
                    census=hm.census.snapshot(), launches=dict(cuda.launches),
                    device=str(got.data.device))
        finally:
            config.keyswitch_shoup = False
    return out


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
@pytest.mark.parametrize("alpha,bits", [(1, [48] * 4 + [54]), (2, [44] * 4 + [43] * 2)])
def test_tp_relinearize_on_card(backend, world, alpha, bits):
    """TP relinearize on the card, at world size 1 over NCCL and on two gloo
    ranks sharing one card (collectives staged through the host, and the
    census says so): the unsharded card result bit for bit, one all_reduce
    of 2·(L+α)·N·8 bytes, K1 and K2 (K3 with the flag) on every rank."""
    from seal_tpu_torch.parallel import launch

    for res in launch.run(_tp_relinearize_on_card, world, backend, "cuda", 300,
                          args=(alpha, bits)):
        for name, rec in res.items():
            assert rec["same"], name
            assert rec["device"].startswith("cuda"), name
            assert rec["census"] == {"all_reduce": {
                "calls": 1, "bytes": 2 * (4 + alpha) * 4096 * 8, "staged": backend == "gloo"}}
            ks = "keyswitch_inner_shoup" if name.endswith("True") else "keyswitch_inner"
            assert rec["launches"]["ntt_forward"] > 0 and rec["launches"][ks] > 0, name


@pytest.mark.parametrize("shoup", [False, True])
@pytest.mark.parametrize("flow", ["bfv", "ckks", "bgv", "multiparty"])
def test_vectors_n4096_on_card(flow, shoup):
    """SEAL's n = 4096 golden hashes (tests/vectors/pipeline_n4096.json)
    from the card's objects, chip_smoke.py's flows, with the Shoup flag off
    (K2) and on (K3): every hash equal, K1 launched, and K2 or K3 in every
    flow that key-switches."""
    import chip_smoke
    from seal_tpu_torch.config import config

    config.keyswitch_shoup = shoup
    try:
        cuda.reset_launches()
        got = chip_smoke.VECTOR_FLOWS[flow]("cuda")
        torch.cuda.synchronize()
    finally:
        config.keyswitch_shoup = False
    assert chip_smoke.first_vector_mismatch(
        got, chip_smoke.load_vectors("pipeline_n4096.json")) is None
    assert cuda.launches["ntt_forward"] > 0 and cuda.launches["ntt_inverse"] > 0
    if flow != "multiparty":
        assert cuda.launches["keyswitch_inner_shoup" if shoup else "keyswitch_inner"] > 0


def test_vector_saves_on_card():
    """SEAL's n = 4096 wire bytes (tests/vectors/serialization_n4096.json)
    saved from the card's objects, byte for byte, ZSTD where zstandard
    imports; the ciphertext decrypts on the card."""
    import chip_smoke

    saves, decrypts = chip_smoke.vector_saves("cuda")
    assert chip_smoke.first_byte_mismatch(
        saves, chip_smoke.load_vectors("serialization_n4096.json")) is None
    assert decrypts
