"""The port's CKKS rotations against seal_tpu.Evaluator at n = 1024, bit for
bit, with Galois keys and ciphertexts made by seal_tpu and carried across:
rotate_vector by a step with no key of its own (the NAF fallback, two key
switches), complex_conjugate, and rotate_batch_hoisted on both of its
branches (at most 16 nonzero steps: permuted keys, permuted output; 17
steps: permuted operand). seal_tpu runs them under one jax.jit, which
compiles once instead of op by op.

α = 1 (SEAL's key switching) is here; α = 2 is in
test_torch_rotations_hybrid.py, a file of its own so that the two slow JAX
compiles land on different test workers.
"""

import jax
import numpy as np

import seal_tpu
import seal_tpu_torch as st
from seal_tpu.dtypes import to_host
from seal_tpu_torch import interop

HOISTED_STEPS = list(range(1, 18))      # 17 steps: the loop branch
NAF_STEP = 18                           # = 2 + 16, no key of its own


def assert_rotations_match_seal_tpu(alpha, bits, n=1024):
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(n)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(n, bits))
    sp.set_special_modulus_size(alpha)
    sp.set_random_seed((9, 1, 2, 3, 4, 5, 6, alpha))
    sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
    kg = seal_tpu.KeyGenerator(sctx)
    sgk = kg.create_galois_keys(steps=HOISTED_STEPS + [0])
    enc = seal_tpu.Encryptor(sctx, kg.create_public_key())
    encoder = seal_tpu.CKKSEncoder(sctx)
    rng = np.random.default_rng(alpha)
    sct = enc.encrypt(encoder.encode(rng.uniform(-1, 1, encoder.slot_count), 2.0 ** 30))

    def rotations(ev, gk, ct):
        return {"rotate_vector_naf": [ev.rotate_vector(ct, NAF_STEP, gk)],
                "complex_conjugate": [ev.complex_conjugate(ct, gk)],
                "hoisted_one_step": ev.rotate_batch_hoisted(ct, [5, 0], gk),
                "hoisted_17_steps": ev.rotate_batch_hoisted(ct, HOISTED_STEPS, gk)}

    sev = seal_tpu.Evaluator(sctx)
    want = jax.jit(lambda a: rotations(sev, sgk, a))(sct)

    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gk = interop.galois_keys_from_numpy(
        ctx, [None if k is None else to_host(k) for k in sgk.keys])
    ct = interop.ciphertext_from_numpy(ctx, sct.to_numpy(), sct.parms_id, sct.scale,
                                       sct.is_ntt_form)
    got = rotations(st.Evaluator(ctx), gk, ct)
    for op, outs in got.items():
        assert len(outs) == len(want[op]), op
        for k, (a, b) in enumerate(zip(outs, want[op])):
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy(), err_msg=f"{op}[{k}]")
            assert tuple(a.parms_id) == tuple(b.parms_id) and a.scale == b.scale, op


def test_rotations_match_seal_tpu_alpha1():
    """SEAL's key switching: 3 data primes and 1 special prime."""
    assert_rotations_match_seal_tpu(1, [40, 40, 40, 40])
