"""Encoders on the port: BatchEncoder (BFV SIMD) and CKKSEncoder (the
counterpart of examples/2_encoders.py; parity:
native/examples/2_encoders.cpp). Decoded values stay tensors on the
context's device; with device="cpu" everything runs as the plain PyTorch
path."""

import numpy as np
import torch

from seal_tpu_torch import (
    BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
    Evaluator, KeyGenerator, PlainModulus, SchemeType, SEALContext,
)


def main(device=None):
    # --- BatchEncoder -----------------------------------------------------
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(4096)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(4096))
    parms.set_plain_modulus(PlainModulus.batching(4096, 20))
    context = SEALContext(parms, device=device)
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    encoder = BatchEncoder(context)
    print("slot count:", encoder.slot_count)

    pod = [0, 1, 2, 3] + [0] * (encoder.slot_count - 4)
    ct = encryptor.encrypt(encoder.encode(pod))
    sq = evaluator.add(ct, ct)
    out = encoder.decode(decryptor.decrypt(sq))
    assert out[:4].tolist() == [0, 2, 4, 6]
    print("batched add:", out[:4].tolist())

    # --- CKKSEncoder ------------------------------------------------------
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(8192)
    parms.set_coeff_modulus(CoeffModulus.create(8192, [40, 40, 40, 40, 40]))
    context = SEALContext(parms, device=device)
    enc = CKKSEncoder(context)
    vals = np.array([0.0, 1.1, 2.2, 3.3])
    p = enc.encode(np.concatenate([vals, np.zeros(enc.slot_count - 4)]), 2.0 ** 30)
    out = enc.decode(p)
    err = float((out[:4] - torch.from_numpy(vals).to(out.device)).abs().max())
    print("CKKS encode/decode error:", err)
    assert err < 1e-5
    print("2_encoders OK")


if __name__ == "__main__":
    main()
