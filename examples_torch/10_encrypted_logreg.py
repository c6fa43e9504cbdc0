"""Encrypted logistic-regression inference on the port (the counterpart of
examples/10_encrypted_logreg.py).

Scores a batch of feature vectors under CKKS without decrypting them:
every slot-block of `dim` slots holds one sample, one multiply_plain takes
the elementwise product with the (plaintext) weights, a log2(dim)
rotate-and-sum tree collapses each block to its dot product, and a degree-3
polynomial approximation of the sigmoid (sigma(s) ~ 0.5 + 0.197 s
- 0.004 s^3 on [-5, 5]) is evaluated homomorphically across three rescale
levels with SEAL-style scale alignment (the forced `ct.scale = 2^40` trick
from the reference's 4_ckks_basics.cpp:380-420). The parameters carry a
random seed, so keys and ciphertexts are seal_tpu's bit for bit. With
device="cpu" everything runs as the plain PyTorch path.

Reference parity anchor: the level/scale choreography follows
native/examples/4_ckks_basics.cpp; rotations follow 6_rotation.cpp. The
batched-inference packing itself is standard HE practice the reference
leaves to applications.
"""

import numpy as np
import torch

from seal_tpu_torch import (
    CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, SchemeType, SEALContext, SecLevelType,
)

A1, A3 = 0.197, -0.004  # sigma(s) ~ 0.5 + A1 s + A3 s^3


def main(n: int = 16384, dim: int = 8, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 40, 60]))
    sec = SecLevelType.TC128 if n >= 16384 else SecLevelType.NONE
    parms.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
    context = SEALContext(parms, sec_level=sec, device=device)

    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    relin_keys = keygen.create_relin_keys()
    encoder = CKKSEncoder(context)
    gt = context.key_context_data().galois_tool
    steps = [dim >> (k + 1) for k in range(dim.bit_length() - 1)]  # dim/2..1
    galois_keys = keygen.create_galois_keys(gt.get_elts_from_steps(steps))

    scale = 2.0 ** 40
    rng = np.random.default_rng(7)
    w = rng.uniform(-1, 1, dim)
    bias = float(rng.uniform(-1, 1))

    slots = encoder.slot_count
    n_samples = slots // dim
    X = rng.uniform(-1, 1, (n_samples, dim))

    # pack: slot j holds X[j // dim][j % dim]
    ct = encryptor.encrypt(encoder.encode(X.reshape(-1), scale))

    # s = <w, x> + b per block: elementwise weights, then a rotation tree
    s = evaluator.rescale_to_next(
        evaluator.multiply_plain(ct, encoder.encode(np.tile(w, n_samples), scale)))
    for k in steps:
        s = evaluator.add(s, evaluator.rotate_vector(s, k, galois_keys))
    s = evaluator.add_plain(s, encoder.encode(bias, s.scale, parms_id=s.parms_id))

    # sigma(s) ~ 0.5 + A1 s + A3 s^3 over three levels (4_ckks_basics.cpp
    # choreography: rescale after every multiply, then align scales/levels)
    s2 = evaluator.rescale_to_next(evaluator.relinearize(evaluator.square(s), relin_keys))
    a3s = evaluator.rescale_to_next(
        evaluator.multiply_plain(s, encoder.encode(A3, scale, parms_id=s.parms_id)))
    t3 = evaluator.rescale_to_next(
        evaluator.relinearize(evaluator.multiply(s2, a3s), relin_keys))
    a1s = evaluator.rescale_to_next(
        evaluator.multiply_plain(s, encoder.encode(A1, scale, parms_id=s.parms_id)))

    # exact scales differ by prime-vs-2^40 drift only; force and mod-switch
    t3.scale = scale
    a1s.scale = scale
    a1s = evaluator.mod_switch_to(a1s, t3.parms_id)
    p = evaluator.add(t3, a1s)
    p = evaluator.add_plain(p, encoder.encode(0.5, p.scale, parms_id=p.parms_id))

    got = encoder.decode(decryptor.decrypt(p))[::dim]
    s_true = X @ w + bias
    want = 0.5 + A1 * s_true + A3 * s_true ** 3
    err = float((got - torch.from_numpy(want).to(got.device)).abs().max())
    sig = 1.0 / (1.0 + np.exp(-s_true))
    approx_err = float(np.max(np.abs(want - sig)))
    print(f"encrypted logreg: {n_samples} samples x {dim} features, n={n}")
    print(f"  max |HE - poly| = {err:.2e} (crypto noise)")
    print(f"  max |poly - sigmoid| = {approx_err:.2e} (approximation)")
    assert err < 1e-4, err
    print("10_encrypted_logreg OK")


if __name__ == "__main__":
    main()
