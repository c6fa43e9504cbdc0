"""The modulus-switching chain on the port (the counterpart of
examples/3_levels.py; parity: native/examples/3_levels.cpp). With
device="cpu" everything runs as the plain PyTorch path."""

from seal_tpu_torch import (
    CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, Plaintext, SchemeType, SEALContext, SecLevelType,
)


def main(n: int = 8192, device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    if n >= 8192:
        parms.set_coeff_modulus(CoeffModulus.create(n, [50, 30, 30, 50, 50]))
        sec = SecLevelType.TC128
    else:
        # reduced-size smoke: insecure parms, same 5-level chain walk
        parms.set_coeff_modulus(CoeffModulus.create(n, [30, 24, 24, 30, 30]))
        sec = SecLevelType.NONE
    parms.set_plain_modulus(1032193)
    context = SEALContext(parms, sec_level=sec, device=device)

    # Walk the chain
    cd = context.key_context_data()
    print("modulus switching chain:")
    while cd is not None:
        role = "key" if cd.parms_id == tuple(context.key_parms_id) else (
            "first" if cd.parms_id == tuple(context.first_parms_id) else
            ("last" if cd.parms_id == tuple(context.last_parms_id) else "data"))
        print(f"  chain_index {cd.chain_index}: L={cd.coeff_modulus_size} ({role})")
        cd = cd.next_context_data

    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, keygen.create_public_key())
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())

    ct = encryptor.encrypt(Plaintext.from_hex_string("5", device=context.device))
    budgets = [decryptor.invariant_noise_budget(ct)]
    while True:
        cd = context.get_context_data(ct.parms_id)
        if cd.next_context_data is None:
            break
        ct = evaluator.mod_switch_to_next(ct)
        budgets.append(decryptor.invariant_noise_budget(ct))
    print("noise budgets down the chain:", budgets)
    assert decryptor.decrypt(ct).to_hex_string() == "5"

    # mod_switch_to a specific level
    ct = encryptor.encrypt(Plaintext.from_hex_string("7", device=context.device))
    ct = evaluator.mod_switch_to(ct, context.last_parms_id)
    assert decryptor.decrypt(ct).to_hex_string() == "7"
    print("3_levels OK")


if __name__ == "__main__":
    main()
