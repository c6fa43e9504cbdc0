"""Serialization on the port: SEAL 4.0's wire format, seeded ciphertexts
and keys, compression (the counterpart of examples/7_serialization.py;
parity: native/examples/7_serialization.cpp). A load puts the object on
the context's device; with device="cpu" everything runs as the plain
PyTorch path."""

from seal_tpu_torch import (
    CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, Plaintext, SchemeType, SEALContext,
)
from seal_tpu_torch import serialization as ser


def main(device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(4096)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(4096))
    parms.set_plain_modulus(1024)

    # server side: serialize parameters
    parms_blob = ser.save_encryption_parameters(parms)
    print("parms blob:", len(parms_blob), "bytes")

    # client side: load, keygen, encrypt (seed-compressed symmetric)
    client_parms = ser.load_encryption_parameters(parms_blob)
    context = SEALContext(client_parms, device=device)
    keygen = KeyGenerator(context)
    sk_blob = ser.save_secret_key(keygen.secret_key())
    encryptor = Encryptor(context, keygen.secret_key())
    six = Plaintext.from_hex_string("6", device=context.device)
    ct = encryptor.encrypt_symmetric(six, save_seed=True)
    ct_blob = ser.save_ciphertext(ct, ser.ComprMode.ZLIB)
    full_blob = ser.save_ciphertext(encryptor.encrypt_symmetric(six))
    print(f"seeded+zlib ciphertext: {len(ct_blob)} bytes "
          f"(vs {len(full_blob)} uncompressed full)")

    # seed-compressed evaluation keys (Serializable<RelinKeys>): the client
    # ships half-size keys; they expand to full keys on the server's load
    rk_blob = ser.save_relin_keys(keygen.create_relin_keys(save_seed=True))
    rk_full = ser.save_relin_keys(keygen.create_relin_keys())
    print(f"seeded relin keys: {len(rk_blob)} bytes (vs {len(rk_full)} expanded)")

    # server side: load and compute
    server_ct = ser.load_ciphertext(context, ct_blob)
    server_rk = ser.load_relin_keys(context, rk_blob)
    evaluator = Evaluator(context)
    doubled = evaluator.add(server_ct, server_ct)
    squared = evaluator.relinearize(evaluator.multiply(server_ct, server_ct), server_rk)
    out_blob = ser.save_ciphertext(doubled)
    sq_blob = ser.save_ciphertext(squared)

    # client side: decrypt
    sk = ser.load_secret_key(context, sk_blob)
    decryptor = Decryptor(context, sk)
    result = decryptor.decrypt(ser.load_ciphertext(context, out_blob))
    print("decrypted 6+6 =", int(result.to_hex_string(), 16))
    assert result.to_hex_string() == "C"
    sq = decryptor.decrypt(ser.load_ciphertext(context, sq_blob))
    assert sq.to_hex_string() == "24"  # 36
    print("decrypted 6*6 =", int(sq.to_hex_string(), 16), "(seeded relin keys)")
    print("7_serialization OK")


if __name__ == "__main__":
    main()
