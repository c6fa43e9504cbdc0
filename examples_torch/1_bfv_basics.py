"""BFV basics and the fork's multiparty flow on the port (the counterpart
of examples/1_bfv_basics.py; parity: native/examples/1_bfv_basics.cpp,
with the three-party common-key and distributed-decryption demo at
:160-215).

Computes 4(x+1)^2(x^2+1) at x=6 under encryption, then repeats the
encryption and decryption under a three-party common public key. On the
card (the default) every op runs there; with device="cpu" everything runs
as the plain PyTorch path.
"""

from seal_tpu_torch import (
    CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, Plaintext, SchemeType, SEALContext, SecLevelType,
)


def main(n: int = 4096, device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    if n >= 1024:
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
        sec = SecLevelType.TC128
    else:
        # reduced-size smoke: insecure parms, same walkthrough
        parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
        sec = SecLevelType.NONE
    parms.set_plain_modulus(1024)
    context = SEALContext(parms, sec_level=sec, device=device)
    print("parameters valid:", context.parameters_set)

    def plain(text):
        return Plaintext.from_hex_string(text, device=context.device)

    keygen = KeyGenerator(context)
    public_key = keygen.create_public_key()
    relin_keys = keygen.create_relin_keys()
    encryptor = Encryptor(context, public_key)
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())

    x = 6
    x_plain = plain(f"{x:X}")
    x_encrypted = encryptor.encrypt(x_plain)
    print("fresh noise budget:", decryptor.invariant_noise_budget(x_encrypted), "bits")

    # (x^2 + 1)
    x_sq_plus_one = evaluator.add_plain(
        evaluator.relinearize(evaluator.square(x_encrypted), relin_keys), plain("1"))
    # (x + 1)^2
    x_plus_one_sq = evaluator.relinearize(
        evaluator.square(evaluator.add_plain(x_encrypted, plain("1"))), relin_keys)
    # 4(x+1)^2 (x^2+1)
    result = evaluator.relinearize(
        evaluator.multiply(evaluator.multiply_plain(x_plus_one_sq, plain("4")), x_sq_plus_one),
        relin_keys)
    print("final noise budget:", decryptor.invariant_noise_budget(result), "bits")
    decrypted = int(decryptor.decrypt(result).to_hex_string().replace(" ", ""), 16)
    expected = (4 * (x + 1) ** 2 * (x * x + 1)) % 1024
    print(f"4(x+1)^2(x^2+1) = {decrypted} (expected {expected})")
    assert decrypted == expected

    # ---- multiparty: 3 parties, common public/secret keys -------------------
    parties = 3
    sks = [keygen.generate_secret_key() for _ in range(parties)]
    pks = [keygen.create_public_key_with_sk(sks[0])]
    for i in range(1, parties):
        pks.append(keygen.create_public_key_with_same_c1(sks[i], pks[0]))
    cpk = keygen.create_common_public_key(pks)

    mp_encryptor = Encryptor(context, cpk)
    ct = mp_encryptor.encrypt(x_plain)
    partials = [Decryptor(context, sk).distributed_decrypt(ct) for sk in sks]
    out = Decryptor(context, sks[0]).aggregate_partial_decryption(ct, partials)
    print("multiparty decrypt:", out.to_hex_string(), "(expected 6)")
    assert out.to_hex_string() == "6"
    print("1_bfv_basics OK")


if __name__ == "__main__":
    main()
