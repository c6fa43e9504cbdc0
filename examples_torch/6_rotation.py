"""Rotations in BFV and CKKS and the fork's common (multiparty) Galois keys
on the port (the counterpart of examples/6_rotation.py; parity:
native/examples/6_rotation.cpp, with :83-90).

The Galois key shares take their c1s from party 0's own keys in the port's
layout: a key is one tensor [d, 2, L_key, N], so party 0's c1 of every
digit is `key(elt)[:, 1]`. With device="cpu" everything runs as the plain
PyTorch path.
"""

import numpy as np
import torch

from seal_tpu_torch import (
    BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
    Evaluator, KeyGenerator, PlainModulus, SchemeType, SEALContext, SecLevelType,
)


def main(n_bfv: int = 4096, n_ckks: int = 8192, device=None):
    # --- BFV rotations ------------------------------------------------------
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n_bfv)
    if n_bfv >= 1024:
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n_bfv))
        sec = SecLevelType.TC128
    else:
        parms.set_coeff_modulus(CoeffModulus.create(n_bfv, [40, 40, 40]))
        sec = SecLevelType.NONE
    parms.set_plain_modulus(PlainModulus.batching(n_bfv, 20))
    context = SEALContext(parms, sec_level=sec, device=device)
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    encoder = BatchEncoder(context)
    gt = context.key_context_data().galois_tool
    galois_keys = keygen.create_galois_keys(gt.get_elts_from_steps([3, -3, 0]))

    n = encoder.slot_count
    row = n // 2
    vals = list(range(n))
    ct = encryptor.encrypt(encoder.encode(vals))
    out = encoder.decode(decryptor.decrypt(evaluator.rotate_rows(ct, 3, galois_keys)))
    r1, r2 = vals[:row], vals[row:]
    assert out.tolist() == r1[3:] + r1[:3] + r2[3:] + r2[:3]
    out = encoder.decode(decryptor.decrypt(evaluator.rotate_columns(ct, galois_keys)))
    assert out.tolist() == r2 + r1
    print("BFV rotate rows/columns OK")

    # --- multiparty common rotation keys (fork surface) ----------------------
    sks = [keygen.generate_secret_key() for _ in range(3)]
    elts = [gt.get_elt_from_step(1)]
    gk0 = keygen.create_galois_keys(elts, secret_key=sks[0])
    c1_refs = gk0.key(elts[0])[:, 1]            # party 0's c1 of each digit, [d, L_key, N]
    shares = [gk0] + [
        keygen.create_galois_keys(elts, secret_key=sk, c1_refs_per_elt=[c1_refs])
        for sk in sks[1:]
    ]
    common = keygen.aggregate_galois_keys(elts, shares)
    print("common Galois keys aggregated from", len(shares), "parties")
    # the aggregate rotates under the common secret key
    csk = keygen.create_common_secret_key(sks)
    ct = Encryptor(context, csk).encrypt_symmetric(encoder.encode(vals))
    out = encoder.decode(Decryptor(context, csk).decrypt(evaluator.rotate_rows(ct, 1, common)))
    assert out.tolist() == r1[1:] + r1[:1] + r2[1:] + r2[:1]
    print("rotation under the common Galois keys OK")

    # --- CKKS rotations ---------------------------------------------------------
    parms = EncryptionParameters(SchemeType.CKKS)
    # n=8192: 3x40-bit primes fit the 128-bit budget (4096 allows only 109)
    parms.set_poly_modulus_degree(n_ckks)
    parms.set_coeff_modulus(CoeffModulus.create(n_ckks, [40, 40, 40]))
    context = SEALContext(
        parms, sec_level=SecLevelType.TC128 if n_ckks >= 8192 else SecLevelType.NONE,
        device=device)
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    enc = CKKSEncoder(context)
    gt = context.key_context_data().galois_tool
    galois_keys = keygen.create_galois_keys(gt.get_elts_from_steps([2, -2]))
    vals = np.arange(enc.slot_count, dtype=np.float64)
    ct = encryptor.encrypt(enc.encode(vals, 2.0 ** 30))
    out = enc.decode(decryptor.decrypt(evaluator.rotate_vector(ct, 2, galois_keys)))
    want = torch.from_numpy(np.roll(vals, -2)).to(out.device)
    assert float((out - want).abs().max()) < 1e-2
    print("CKKS rotate_vector OK")
    print("6_rotation OK")


if __name__ == "__main__":
    main()
