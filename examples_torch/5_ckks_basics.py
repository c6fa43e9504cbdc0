"""CKKS basics on the port: evaluating PI*x^3 + 0.4x + 1 on real data with
rescaling (the counterpart of examples/5_ckks_basics.py; parity:
native/examples/5_ckks_basics.cpp). The decoded result stays a tensor on
the context's device; numpy gives the exact reference. With device="cpu"
everything runs as the plain PyTorch path."""

import numpy as np
import torch

from seal_tpu_torch import (
    CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, SchemeType, SEALContext, SecLevelType,
)


def main(n: int = 8192, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 60]))
    sec = SecLevelType.TC128 if n >= 8192 else SecLevelType.NONE
    context = SEALContext(parms, sec_level=sec, device=device)

    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    relin_keys = keygen.create_relin_keys()
    encoder = CKKSEncoder(context)

    scale = 2.0 ** 40
    x = np.linspace(0, 1, encoder.slot_count)

    x_ct = encryptor.encrypt(encoder.encode(x, scale))
    pi_plain = encoder.encode(3.14159265, scale)
    c04_plain = encoder.encode(0.4, scale)

    # x^2, rescaled
    x_sq = evaluator.rescale_to_next(
        evaluator.relinearize(evaluator.square(x_ct), relin_keys))
    # PI*x, rescaled
    pi_x = evaluator.rescale_to_next(evaluator.multiply_plain(x_ct, pi_plain))
    # PI*x^3 = (x^2)*(PI*x), rescaled again
    pi_x3 = evaluator.rescale_to_next(
        evaluator.relinearize(evaluator.multiply(x_sq, pi_x), relin_keys))
    # 0.4*x, rescaled
    x04 = evaluator.rescale_to_next(evaluator.multiply_plain(x_ct, c04_plain))

    # normalize scales and levels, then sum with +1
    pi_x3.scale = scale
    x04.scale = scale
    x04 = evaluator.mod_switch_to(x04, pi_x3.parms_id)
    total = evaluator.add(pi_x3, x04)
    one = encoder.encode(1.0, scale, total.parms_id)
    total = evaluator.add_plain(total, one)

    out = encoder.decode(decryptor.decrypt(total))
    expected = torch.from_numpy(3.14159265 * x ** 3 + 0.4 * x + 1).to(out.device)
    err = float((out - expected).abs().max())
    print("max error of PI*x^3 + 0.4x + 1:", err)
    assert err < 1e-4
    print("5_ckks_basics OK")


if __name__ == "__main__":
    main()
