"""Encrypted matrix-vector product on the port (the counterpart of
examples/9_encrypted_matvec.py).

Computes y = M·x on an encrypted x with the Halevi-Shoup diagonal method:
y = Σ_d diag_d(M) ⊙ rot(x, d). All D-1 rotations share one hoisted
decomposition (`Evaluator.rotate_batch_hoisted`: decompose and NTT once,
one key-switch inner product per rotation). The parameters carry a random
seed, so keys and ciphertexts are seal_tpu's bit for bit. With
device="cpu" everything runs as the plain PyTorch path.

Reference parity anchor: rotations follow native/examples/6_rotation.cpp;
the diagonal method itself is standard HE practice the reference leaves to
applications.
"""

import numpy as np
import torch

from seal_tpu_torch import (
    CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, SchemeType, SEALContext, SecLevelType,
)


def main(n: int = 8192, dim: int = 8, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    if n >= 8192:
        parms.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 60]))
        sec = SecLevelType.TC128
    else:
        parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
        sec = SecLevelType.NONE
    parms.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
    context = SEALContext(parms, sec_level=sec, device=device)

    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    encoder = CKKSEncoder(context)
    gt = context.key_context_data().galois_tool
    steps = list(range(1, dim))
    galois_keys = keygen.create_galois_keys(gt.get_elts_from_steps(steps))

    scale = 2.0 ** 30
    rng = np.random.default_rng(42)
    M = rng.uniform(-1, 1, (dim, dim))
    x = rng.uniform(-1, 1, dim)

    # pack x cyclically so slot j of rot(x, d) holds x[(j+d) % dim]
    slots = encoder.slot_count
    reps = slots // dim
    x_packed = np.tile(x, reps)
    ct_x = encryptor.encrypt(encoder.encode(x_packed, scale))

    # hoisted batch: all D-1 nontrivial rotations of the SAME ciphertext
    rotated = [ct_x] + evaluator.rotate_batch_hoisted(ct_x, steps, galois_keys)

    # y = Σ_d diag_d ⊙ rot(x, d), with diag_d[j] = M[j, (j+d) % dim]
    acc = None
    for d, ct_rot in enumerate(rotated):
        diag = np.array([M[j % dim, (j + d) % dim] for j in range(slots)])
        term = evaluator.multiply_plain(ct_rot, encoder.encode(diag, scale))
        acc = term if acc is None else evaluator.add(acc, term)

    y = encoder.decode(decryptor.decrypt(acc))[:dim]
    want = torch.from_numpy(M @ x).to(y.device)
    err = float((y - want).abs().max())
    print(f"encrypted {dim}x{dim} matvec, n={n}: max |err| = {err:.2e}")
    assert err < 1e-2, err
    print("9_encrypted_matvec OK")


if __name__ == "__main__":
    main()
