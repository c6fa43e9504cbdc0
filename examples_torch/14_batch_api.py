"""Batch host APIs on the port (the counterpart of examples/14_batch_api.py;
no reference counterpart: batchencoder.h / encryptor.h / decryptor.h are
scalar-only).

`encode_many / encrypt_many / decrypt_many / decode_many` run a whole
batch of B inputs through one launch per stage: the plaintexts and
ciphertexts are views of one [B, ...] tensor. Results are bit-identical to
the scalar calls (tests/test_torch_many.py pins that). With device="cpu"
everything runs as the plain PyTorch path.
"""

import time

import numpy as np
import torch

from seal_tpu_torch import (
    BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
    Evaluator, KeyGenerator, PlainModulus, SchemeType, SEALContext, SecLevelType,
)


def _sync(context):
    if context.device.type == "cuda":
        torch.cuda.synchronize(context.device)


def main(n: int = 4096, B: int = 64, device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    if n >= 4096:
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        sec = SecLevelType.TC128
    else:
        # reduced-size smoke: insecure parms with a relin-capable chain
        parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
        parms.set_plain_modulus(PlainModulus.batching(n, 14))
        sec = SecLevelType.NONE
    ctx = SEALContext(parms, sec_level=sec, device=device)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    dec = Decryptor(ctx, kg.secret_key())
    ev = Evaluator(ctx)
    rk = kg.create_relin_keys()
    be = BatchEncoder(ctx)
    t = int(parms.plain_modulus.value)

    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, size=(B, be.slot_count), dtype=np.int64)
    b = rng.integers(0, 100, size=(B, be.slot_count), dtype=np.int64)

    # one launch per stage for the whole batch
    t0 = time.perf_counter()
    cts_a = enc.encrypt_many(be.encode_many(a))
    cts_b = enc.encrypt_symmetric_many(be.encode_many(b))
    _sync(ctx)
    t_enc = time.perf_counter() - t0
    print(f"encoded+encrypted 2x{B} ciphertexts in {t_enc*1e3:.1f} ms "
          f"({2*B/t_enc:.0f} cts/s)")

    # compute stays the ordinary Evaluator: batch cts are ordinary cts
    prods = [ev.relinearize(ev.multiply(x, y), rk) for x, y in zip(cts_a, cts_b)]

    t0 = time.perf_counter()
    outs = be.decode_many(dec.decrypt_many(prods))
    _sync(ctx)
    t_dec = time.perf_counter() - t0
    print(f"decrypted+decoded {B} products in {t_dec*1e3:.1f} ms")

    assert torch.equal(outs, torch.from_numpy((a * b) % t).to(outs.device))
    print(f"all {B} products exact; batch == scalar bit-identity is pinned "
          "by tests/test_torch_many.py")

    # CKKS twin
    cparms = EncryptionParameters(SchemeType.CKKS)
    cparms.set_poly_modulus_degree(n)
    if n >= 4096:
        cparms.set_coeff_modulus(CoeffModulus.create(n, [36, 36, 37]))
        csec = SecLevelType.TC128
    else:
        cparms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
        csec = SecLevelType.NONE
    cctx = SEALContext(cparms, sec_level=csec, device=device)
    ckg = KeyGenerator(cctx)
    cenc = Encryptor(cctx, ckg.create_public_key())
    cdec = Decryptor(cctx, ckg.secret_key())
    ce = CKKSEncoder(cctx)
    vals = rng.normal(size=(B, ce.slot_count))
    got = ce.decode_many(cdec.decrypt_many(cenc.encrypt_many(ce.encode_many(vals, 2.0 ** 30))))
    err = float((got - torch.from_numpy(vals).to(got.device)).abs().max())
    print(f"CKKS batch roundtrip max err {err:.2e}")
    assert err < 1e-4
    print("14_batch_api OK")


if __name__ == "__main__":
    main()
