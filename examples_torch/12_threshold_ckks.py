"""Threshold CKKS on the port: N-party common keys, homomorphic
evaluation, and noise-flooded distributed decryption (the counterpart of
examples/12_threshold_ckks.py).

The fork's multiparty layer (keygenerator.cpp:95-518, decryptor.cpp:89-187)
is demonstrated in the reference only for BFV (examples 1 and 6). This
example runs the same threshold flow on CKKS, with any party count and
smudging noise in each party's partial decryption.

Flow: each party samples its own secret key; public keys share one common
c1 (a common reference string), so the common public key is the sum of the
party keys. Ciphertexts encrypted under the CPK decrypt only when ALL
parties contribute a partial decryption of the form c1·s_i + e_smudge.
With device="cpu" everything runs as the plain PyTorch path.
"""

import numpy as np
import torch

from seal_tpu_torch import (
    CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, SchemeType, SEALContext, SecLevelType,
)


def main(n: int = 8192, parties: int = 4, smudging_bits: int = 20, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 60]))
    sec = SecLevelType.TC128 if n >= 8192 else SecLevelType.NONE
    context = SEALContext(parms, sec_level=sec, device=device)
    keygen = KeyGenerator(context)
    encoder = CKKSEncoder(context)
    evaluator = Evaluator(context)
    scale = 2.0 ** 40

    # --- joint key generation (common reference string = shared c1) --------
    sks = [keygen.generate_secret_key() for _ in range(parties)]
    pks = [keygen.create_public_key_with_sk(sks[0])]
    for i in range(1, parties):
        pks.append(keygen.create_public_key_with_same_c1(sks[i], pks[0]))
    cpk = keygen.create_common_public_key(pks)
    print(f"{parties} parties; common public key = sum of party keys (shared c1)")

    # --- encrypt under the common key, evaluate a weighted sum -------------
    slots = encoder.slot_count
    x = np.linspace(-1.0, 1.0, slots)
    w = 0.5 * np.cos(np.linspace(0, np.pi, slots))
    enc = Encryptor(context, cpk)
    ct = enc.encrypt(encoder.encode(x, scale))
    ct = evaluator.multiply_plain(ct, encoder.encode(w, scale, ct.parms_id))
    ct = evaluator.rescale_to_next(ct)
    expected = torch.from_numpy(w * x).to(context.device)

    # --- distributed decryption: every party adds smudging noise ------------
    partials = [
        Decryptor(context, sk).distributed_decrypt(ct, smudging_bits=smudging_bits)
        for sk in sks
    ]
    agg = Decryptor(context, sks[0]).aggregate_partial_decryption(ct, partials)
    got = encoder.decode(agg)
    err = float((got - expected).abs().max())
    # flooding noise dominates: |err| ~ parties * 2^b * sqrt(n) / scale'
    # where scale' is the rescaled ciphertext's scale; bound with headroom
    bound = max(1e-4, 16 * parties * (2.0 ** smudging_bits) * np.sqrt(n) / ct.scale)
    print(f"threshold decrypt ({parties} partials, smudging 2^{smudging_bits}): "
          f"max err {err:.3e} (bound {bound:.1e})")
    assert err < bound, (err, bound)

    # --- cross-check: the common secret key decrypts the same ciphertext ---
    csk = keygen.create_common_secret_key(sks)
    direct = encoder.decode(Decryptor(context, csk).decrypt(ct))
    err_csk = float((direct - expected).abs().max())
    print(f"common-secret-key direct decrypt: max err {err_csk:.3e}")
    assert err_csk < 1e-4, err_csk

    # without every party's partial, aggregation must NOT recover the data
    agg_partial = Decryptor(context, sks[0]).aggregate_partial_decryption(ct, partials[:-1])
    wrong = encoder.decode(agg_partial)
    assert float((wrong - expected).abs().max()) > 1.0, \
        "missing-party aggregation should not decrypt"
    print("aggregation without the last party yields garbage (as it must)")
    print("12_threshold_ckks OK")


if __name__ == "__main__":
    main()
