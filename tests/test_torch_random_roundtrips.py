"""tests/test_random_roundtrips.py's eight randomised flows on the port, on
the CPU at N = 64: the same parameters, encryption seeds, random inputs
and op sequences, checked against the same exact numpy slot models (BFV and
BGV exactly, CKKS within the original's 1e-4 and 1e-3). Randomised
plaintexts and several seeds reach carry-chain, rejection-boundary and
sign-fix edges that a single golden vector does not; the port's decoded
tensors are compared as numpy arrays."""

import numpy as np
import pytest
import torch

from seal_tpu_torch import (
    BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
    Evaluator, KeyGenerator, PlainModulus, Plaintext, SchemeType, SEALContext, SecLevelType,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 64
SEEDS = [(s, s + 1, 3, 4, 5, 6, 7, 8) for s in (11, 97)]


def _ctx(scheme, bits, t=None, seed=SEEDS[0]):
    parms = EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, bits))
    if t is not None:
        parms.set_plain_modulus(t)
    parms.set_random_seed(seed)
    return SEALContext(parms, sec_level=SecLevelType.NONE, device="cpu")


@pytest.mark.parametrize("scheme", [SchemeType.BFV, SchemeType.BGV])
@pytest.mark.parametrize("seed", SEEDS)
def test_exact_slot_algebra(scheme, seed):
    """(a*b + c - d)·e slotwise mod t, exact, under two encryption seeds."""
    t = PlainModulus.batching(N, 17).value
    ctx = _ctx(scheme, [40, 40, 40], t, seed)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key())
    rk = kg.create_relin_keys()
    be = BatchEncoder(ctx)

    rng = np.random.default_rng(seed[0])
    a, b, c, d, e = (rng.integers(0, t, N, dtype=np.uint64) for _ in range(5))
    ca, cb, cc, cd_, = (enc.encrypt(be.encode(x)) for x in (a, b, c, d))
    prod = ev.relinearize(ev.multiply(ca, cb), rk)
    acc = ev.sub(ev.add(prod, cc), cd_)
    out = ev.relinearize(ev.multiply(acc, enc.encrypt(be.encode(e))), rk)
    got = be.decode(dec.decrypt(out)).numpy()
    want = ((a.astype(object) * b + c - d) * e) % t
    assert np.array_equal(got, (want % t).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_bfv_plain_mixed_ops(seed):
    """ct⊙pt ops against the exact model: multiply_plain, add_plain,
    sub_plain composed, including a monomial plaintext (fast path)."""
    t = PlainModulus.batching(N, 17).value
    ctx = _ctx(SchemeType.BFV, [40, 40, 40], t, seed)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key())
    be = BatchEncoder(ctx)

    rng = np.random.default_rng(seed[1])
    a, p, q = (rng.integers(0, t, N, dtype=np.uint64) for _ in range(3))
    ca = enc.encrypt(be.encode(a))
    out = ev.sub_plain(ev.add_plain(ev.multiply_plain(ca, be.encode(p)),
                                    be.encode(q)), be.encode(p))
    got = be.decode(dec.decrypt(out)).numpy()
    want = (a.astype(object) * p + q - p) % t
    assert np.array_equal(got, want.astype(np.int64))

    # monomial plaintext: 3x^5 — negacyclic rotation fast path, coeff domain
    mono = Plaintext.from_hex_string("3x^5", device="cpu")
    cm = ev.multiply_plain(enc.encrypt(Plaintext.from_hex_string("2x^1 + 1", device="cpu")), mono)
    got_hex = dec.decrypt(cm).to_hex_string()
    assert got_hex == "6x^6 + 3x^5"


@pytest.mark.parametrize("seed", SEEDS)
def test_bfv_rotation_orbit(seed):
    """Random row/column rotations compose to the model permutation."""
    t = PlainModulus.batching(N, 17).value
    ctx = _ctx(SchemeType.BFV, [40, 40, 40], t, seed)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key())
    gk = kg.create_galois_keys()
    be = BatchEncoder(ctx)

    rng = np.random.default_rng(seed[0] + 1)
    a = rng.integers(0, t, N, dtype=np.uint64)
    ct = enc.encrypt(be.encode(a))
    half = N // 2
    mat = a.reshape(2, half)
    for step in (1, -3, half // 2):
        ct = ev.rotate_rows(ct, step, gk)
        mat = np.roll(mat, -step, axis=1)
    ct = ev.rotate_columns(ct, gk)
    mat = mat[::-1]
    got = be.decode(dec.decrypt(ct)).numpy().astype(np.uint64)
    assert np.array_equal(got.reshape(2, half), mat)


@pytest.mark.parametrize("seed", SEEDS)
def test_ckks_random_polynomial_eval(seed):
    """Evaluate p(x) = 0.5·x³ + x² − 2x slotwise on random inputs with the
    rescale chain, checking float tolerance (reference ckks tests' bar)."""
    ctx = _ctx(SchemeType.CKKS, [50, 30, 30, 50], seed=seed)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key())
    rk = kg.create_relin_keys()
    encd = CKKSEncoder(ctx)

    rng = np.random.default_rng(seed[1] + 2)
    x = rng.uniform(-1, 1, encd.slot_count)
    scale = 2.0 ** 30
    cx = enc.encrypt(encd.encode(x, scale))
    x2 = ev.rescale_to_next(ev.relinearize(ev.multiply(cx, cx), rk))
    half_x = ev.rescale_to_next(
        ev.multiply_plain(cx, encd.encode(0.5, scale)))
    x3_half = ev.rescale_to_next(ev.relinearize(ev.multiply(x2, half_x), rk))
    # align x² and -2x down to x³'s level and scale
    x2_down = ev.mod_switch_to(x2, x3_half.parms_id)
    x2_down.scale = x3_half.scale
    m2x = ev.multiply_plain(cx, encd.encode(-2.0, scale))
    m2x = ev.mod_switch_to(ev.rescale_to_next(m2x), x3_half.parms_id)
    m2x.scale = x3_half.scale
    out = ev.add(ev.add(x3_half, x2_down), m2x)
    got = encd.decode(dec.decrypt(out)).numpy()
    want = 0.5 * x ** 3 + x ** 2 - 2 * x
    assert np.abs(got - want).max() < 1e-4


def test_bgv_modswitch_chain_random():
    """BGV multiply → mod_switch chain keeps exact values to the last level."""
    t = PlainModulus.batching(N, 17).value
    ctx = _ctx(SchemeType.BGV, [40, 40, 40, 40], t)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key())
    rk = kg.create_relin_keys()
    be = BatchEncoder(ctx)

    rng = np.random.default_rng(1234)
    a = rng.integers(0, t, N, dtype=np.uint64)
    b = rng.integers(0, t, N, dtype=np.uint64)
    ct = ev.relinearize(ev.multiply(enc.encrypt(be.encode(a)),
                                    enc.encrypt(be.encode(b))), rk)
    want = (a.astype(object) * b) % t
    while True:
        assert np.array_equal(be.decode(dec.decrypt(ct)).numpy(), want.astype(np.int64))
        cd = ctx.get_context_data(ct.parms_id)
        if cd.next_context_data is None:
            break
        ct = ev.mod_switch_to_next(ct)


@pytest.mark.parametrize("fuzz_seed", [7, 19, 43])
def test_random_op_sequence_bfv(fuzz_seed):
    """Seeded random op-sequence fuzzer: 14 random Evaluator ops against an
    exact numpy slot model, noise-budget-guarded. Catches interaction edges
    (rotate-after-modswitch, plain ops at lower levels, inplace mixing)
    that fixed circuits don't reach."""
    t = PlainModulus.batching(N, 17).value
    ctx = _ctx(SchemeType.BFV, [40, 40, 40, 40], t=t,
               seed=(fuzz_seed, 2, 3, 4, 5, 6, 7, 8))
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    dec = Decryptor(ctx, kg.secret_key())
    ev = Evaluator(ctx)
    rk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1, -1, 0])  # 0 = columns (elt 2n-1)
    be = BatchEncoder(ctx)
    rng = np.random.default_rng(fuzz_seed)
    half = be.slot_count // 2

    def fresh():
        # model arithmetic in int64: uint64 would wrap mod 2^64 on
        # negate/subtract, which is NOT mod-t arithmetic
        v = rng.integers(0, t, be.slot_count, dtype=np.int64)
        return enc.encrypt(be.encode(v.astype(np.uint64))), v

    ct, model = fresh()
    aux_ct, aux = fresh()
    ops = ["add", "sub", "negate", "mul_relin", "add_plain", "mul_plain",
           "rot_rows", "rot_cols", "modswitch", "inplace_add"]
    for step in range(14):
        op = ops[int(rng.integers(len(ops)))]
        if op == "add":
            ct = ev.add(ct, aux_ct); model = (model + aux) % t
        elif op == "sub":
            ct = ev.sub(ct, aux_ct); model = (model - aux) % t
        elif op == "negate":
            ct = ev.negate(ct); model = (-model) % t
        elif op == "mul_relin":
            if dec.invariant_noise_budget(ct) < 25:
                continue
            ct = ev.relinearize(ev.multiply(ct, aux_ct), rk)
            model = (model * aux) % t
        elif op == "add_plain":
            p = rng.integers(0, t, be.slot_count, dtype=np.int64)
            ct = ev.add_plain(ct, be.encode(p.astype(np.uint64)))
            model = (model + p) % t
        elif op == "mul_plain":
            p = rng.integers(1, t, be.slot_count, dtype=np.int64)
            ct = ev.multiply_plain(ct, be.encode(p.astype(np.uint64)))
            model = (model * p) % t
        elif op == "rot_rows":
            s = 1 if rng.integers(2) else -1
            ct = ev.rotate_rows(ct, s, gk)
            model = np.concatenate([np.roll(model[:half], -s),
                                    np.roll(model[half:], -s)])
        elif op == "rot_cols":
            ct = ev.rotate_columns(ct, gk)
            model = np.concatenate([model[half:], model[:half]])
        elif op == "modswitch":
            if ctx.get_context_data(ct.parms_id).next_context_data is None:
                continue
            if dec.invariant_noise_budget(ct) < 25:
                continue
            ct = ev.mod_switch_to_next(ct)
        elif op == "inplace_add":
            ev.add_inplace(ct, aux_ct); model = (model + aux) % t
        # aux must live at ct's level for the binary ops
        if tuple(aux_ct.parms_id) != tuple(ct.parms_id):
            aux_ct = ev.mod_switch_to(aux_ct, ct.parms_id)
        assert dec.invariant_noise_budget(ct) > 0, f"budget died at step {step} ({op})"
    got = be.decode(dec.decrypt(ct)).numpy()
    assert np.array_equal(got, model % t)


@pytest.mark.parametrize("fuzz_seed", [5, 23])
def test_random_op_sequence_bgv(fuzz_seed):
    """BGV variant of the op-sequence fuzzer: mod-switches multiply the
    correction factor, so add/sub after switching exercises
    balance_correction_factors with random operands."""
    t = PlainModulus.batching(N, 17).value
    ctx = _ctx(SchemeType.BGV, [40, 40, 40, 40], t=t,
               seed=(fuzz_seed, 3, 3, 4, 5, 6, 7, 8))
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    dec = Decryptor(ctx, kg.secret_key())
    ev = Evaluator(ctx)
    rk = kg.create_relin_keys()
    be = BatchEncoder(ctx)
    rng = np.random.default_rng(fuzz_seed)

    v = rng.integers(0, t, be.slot_count, dtype=np.int64)
    w = rng.integers(0, t, be.slot_count, dtype=np.int64)
    ct = enc.encrypt(be.encode(v.astype(np.uint64)))
    aux = enc.encrypt(be.encode(w.astype(np.uint64)))
    model = v.copy()
    for step in range(10):
        op = ["add", "sub", "mul_relin", "modswitch_ct",
              "modswitch_aux", "mul_plain"][int(rng.integers(6))]
        if op == "add":
            ct = ev.add(ct, aux); model = (model + w) % t
        elif op == "sub":
            ct = ev.sub(ct, aux); model = (model - w) % t
        elif op == "mul_relin":
            if dec.invariant_noise_budget(ct) < 30:
                continue
            ct = ev.relinearize(ev.multiply(ct, aux), rk)
            model = (model * w) % t
        elif op == "modswitch_ct":
            # only switch ct; the next binary op must balance correction
            # factors between mismatched levels after re-alignment.
            # keep one level in reserve: a single 40-bit prime has too
            # little room for further random multiplies
            if ctx.get_context_data(ct.parms_id).chain_index <= 1:
                continue
            ct = ev.mod_switch_to_next(ct)
        elif op == "modswitch_aux":
            if ctx.get_context_data(aux.parms_id).chain_index <= 1:
                continue
            aux = ev.mod_switch_to_next(aux)
        elif op == "mul_plain":
            if dec.invariant_noise_budget(ct) < 30:
                continue
            p = rng.integers(1, t, be.slot_count, dtype=np.int64)
            ct = ev.multiply_plain(ct, be.encode(p.astype(np.uint64)))
            model = (model * p) % t
        # re-align levels for the binary ops
        ci = ctx.get_context_data(ct.parms_id).chain_index
        ai = ctx.get_context_data(aux.parms_id).chain_index
        if ai > ci:
            aux = ev.mod_switch_to(aux, ct.parms_id)
        elif ci > ai:
            ct = ev.mod_switch_to(ct, aux.parms_id)
        assert dec.invariant_noise_budget(ct) > 0, f"step {step} ({op})"
    got = be.decode(dec.decrypt(ct)).numpy()
    assert np.array_equal(got, model % t)


@pytest.mark.parametrize("fuzz_seed", [3, 31])
def test_random_op_sequence_ckks(fuzz_seed):
    """CKKS variant: random multiply/rescale/rotate/conjugate/add sequences
    with scale- and level-tracking against a complex slot model."""
    ctx = _ctx(SchemeType.CKKS, [50, 35, 35, 35, 50],
               seed=(fuzz_seed, 4, 3, 4, 5, 6, 7, 8))
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    dec = Decryptor(ctx, kg.secret_key())
    ev = Evaluator(ctx)
    rk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1, -2, 0])
    encd = CKKSEncoder(ctx)
    rng = np.random.default_rng(fuzz_seed)
    scale = 2.0 ** 35

    x = rng.uniform(-1, 1, encd.slot_count) + 1j * rng.uniform(-1, 1, encd.slot_count)
    ct = enc.encrypt(encd.encode(x, scale))
    model = x.copy()
    muls = 0
    for step in range(8):
        op = ["square", "mul_plain", "rot", "conj", "add_self"][int(rng.integers(5))]
        depth_left = ctx.get_context_data(ct.parms_id).chain_index > 1
        if op == "square" and depth_left and muls < 3:
            ct = ev.rescale_to_next(ev.relinearize(ev.square(ct), rk))
            model = model * model
            muls += 1
        elif op == "mul_plain" and depth_left:
            c = complex(rng.uniform(0.5, 1.5), rng.uniform(-0.5, 0.5))
            ct = ev.rescale_to_next(
                ev.multiply_plain(ct, encd.encode_value(c, ct.scale, ct.parms_id)
                                  if hasattr(encd, "encode_value")
                                  else encd.encode(
                                      np.full(encd.slot_count, c), ct.scale,
                                      parms_id=ct.parms_id)))
            model = model * c
        elif op == "rot":
            s = 1 if rng.integers(2) else -2
            ct = ev.rotate_vector(ct, s, gk)
            model = np.roll(model, -s)
        elif op == "conj":
            ct = ev.complex_conjugate(ct, gk)
            model = np.conj(model)
        elif op == "add_self":
            ct = ev.add(ct, ct)
            model = model * 2
    got = encd.decode(dec.decrypt(ct), complex_out=True).numpy()
    assert np.abs(got - model).max() < 1e-3, np.abs(got - model).max()
