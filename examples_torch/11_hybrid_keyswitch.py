"""Hybrid key switching on the port (the counterpart of
examples/11_hybrid_keyswitch.py; a seal_tpu extension with no reference
analogue).

The reference implements one key-switching variant: a single special prime
with per-prime decomposition (evaluator.cpp:2382-2677). seal_tpu adds the
GHS-style hybrid scheme: `set_special_modulus_size(alpha)` reserves alpha
special primes and decomposes into ceil(L/alpha) digits, cutting the
decompose NTTs roughly alpha-fold.

This example runs the SAME CKKS workload under alpha=1 (the reference
algorithm) and alpha=2 at an equal total-modulus budget, plus the fused
relinearize+rescale path (one mod-down by P*q_last instead of two), and
checks all three decrypt to the same values. A key-switching key is one
tensor [d, 2, L_key, N]. With device="cpu" everything runs as the plain
PyTorch path.
"""

import numpy as np
import torch

from seal_tpu_torch import (
    CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, SchemeType, SEALContext, SecLevelType,
)


def run(n, bits, alpha, vals, scale, fused=False, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    context = SEALContext(parms, sec_level=SecLevelType.NONE, device=device)
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    decryptor = Decryptor(context, keygen.secret_key())
    evaluator = Evaluator(context)
    encoder = CKKSEncoder(context)
    rk = keygen.create_relin_keys()
    gk = keygen.create_galois_keys(
        context.key_context_data().galois_tool.get_elts_from_steps([1]))

    key = rk.key(2)
    print(f"alpha={alpha}: {context.first_context_data().coeff_modulus_size} "
          f"data primes, {key.shape[0]} keyswitch digit(s), key tensor "
          f"{tuple(key.shape)}")

    ct = encryptor.encrypt(encoder.encode(vals, scale))
    if fused:
        # ONE mod-down by P*q_last (docs/HYBRID_KEYSWITCH.md "Fused rescale")
        out = evaluator.relinearize_rescale(evaluator.multiply(ct, ct), rk)
    else:
        out = evaluator.rescale_to_next(evaluator.relinearize(evaluator.multiply(ct, ct), rk))
    out = evaluator.rotate_vector(out, 1, gk)
    return encoder.decode(decryptor.decrypt(out))


def main(n: int = 256, device=None):
    scale = 2.0 ** 40
    # equal depth (4 data primes), equal total budget:
    #   alpha=1: 4 data + 1 special;  alpha=2: 4 data + 2 specials
    bits1 = [50, 40, 40, 40, 50]
    bits2 = [50, 40, 40, 40, 50, 50]
    vals = np.linspace(-1, 1, n // 2)
    want = np.roll(vals ** 2, -1)

    got1 = run(n, bits1, 1, vals, scale, device=device)
    got2 = run(n, bits2, 2, vals, scale, device=device)
    got3 = run(n, bits2, 2, vals, scale, fused=True, device=device)
    want = torch.from_numpy(want).to(got1.device)
    e1, e2, e3 = (float((got - want).abs().max()) for got in (got1, got2, got3))
    print(f"mult+relin+rescale+rotate error: alpha=1 {e1:.2e}, "
          f"alpha=2 {e2:.2e}, alpha=2 fused {e3:.2e}")
    assert e1 < 1e-5 and e2 < 1e-5 and e3 < 1e-5
    print("hybrid, fused, and reference key switching agree.")
    print("11_hybrid_keyswitch OK")


if __name__ == "__main__":
    main()
