"""BGV basics on the port (the counterpart of examples/4_bgv_basics.py;
parity: native/examples/4_bgv_basics.cpp). With device="cpu" everything
runs as the plain PyTorch path."""

from seal_tpu_torch import (
    BatchEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, PlainModulus, SchemeType, SEALContext, SecLevelType,
)


def main(n: int = 4096, device=None):
    parms = EncryptionParameters(SchemeType.BGV)
    parms.set_poly_modulus_degree(n)
    if n >= 1024:
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
        sec = SecLevelType.TC128
    else:
        # reduced-size smoke: insecure parms, same BGV walkthrough
        parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
        sec = SecLevelType.NONE
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    context = SEALContext(parms, sec_level=sec, device=device)

    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    relin_keys = keygen.create_relin_keys()
    encoder = BatchEncoder(context)

    vals = list(range(8)) + [0] * (encoder.slot_count - 8)
    ct = encryptor.encrypt(encoder.encode(vals))
    # x^2 with relinearization, then modulus switch down
    sq = evaluator.relinearize(evaluator.square(ct), relin_keys)
    sq = evaluator.mod_switch_to_next(sq)
    out = encoder.decode(decryptor.decrypt(sq))
    assert out[:8].tolist() == [i * i for i in range(8)]
    print("BGV square after modswitch:", out[:8].tolist())
    print("4_bgv_basics OK")


if __name__ == "__main__":
    main()
