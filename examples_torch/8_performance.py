"""Performance walkthrough on the port: per-op timings of BFV and CKKS
(the counterpart of examples/8_performance.py; parity:
native/examples/8_performance.cpp). Where seal_tpu runs its ops under
jax.jit, these run as CUDA graphs: `add` through jit.JitEvaluator, the
multiply pipelines through jit.capture. Each replayed result is held bit
for bit against the eager Evaluator's. On the card (the default) the times
are the card's; with device="cpu" everything runs as the plain PyTorch
path."""

import time

import numpy as np
import torch

from seal_tpu_torch import (
    BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
    Evaluator, KeyGenerator, PlainModulus, SchemeType, SEALContext, SecLevelType, jit,
)


def _sync(context):
    if context.device.type == "cuda":
        torch.cuda.synchronize(context.device)


def time_op(label, context, fn, *args, reps=3):
    """fn's result after one untimed call, and its mean time over reps
    calls, the card synchronised."""
    out = fn(*args)
    _sync(context)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(context)
    dt = (time.perf_counter() - t0) / reps
    print(f"  {label:<28s} {dt*1e6:10.0f} us")
    return out


def bfv_performance(n=4096, device=None):
    print(f"BFV performance, n={n}:")
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n) if n >= 1024
                            else CoeffModulus.create(n, [30, 30, 31]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    context = SEALContext(
        parms, sec_level=SecLevelType.TC128 if n >= 1024 else SecLevelType.NONE,
        device=device)
    t0 = time.perf_counter()
    keygen = KeyGenerator(context)
    pk = keygen.create_public_key()
    rk = keygen.create_relin_keys()
    _sync(context)
    print(f"  {'keygen (sk+pk+relin)':<28s} {(time.perf_counter()-t0)*1e6:10.0f} us")
    encryptor = Encryptor(context, pk)
    evaluator = Evaluator(context)
    jevaluator = jit.JitEvaluator(context)
    decryptor = Decryptor(context, keygen.secret_key())
    encoder = BatchEncoder(context)

    vals = list(range(encoder.slot_count))
    plain = encoder.encode(vals)
    ct1 = encryptor.encrypt(plain)
    ct2 = encryptor.encrypt(encoder.encode(vals[::-1]))

    time_op("encode", context, encoder.encode, vals)
    time_op("encrypt", context, encryptor.encrypt, plain)
    time_op("decrypt", context, decryptor.decrypt, ct1)
    added = time_op("add", context, jevaluator.add, ct1, ct2)
    mul = jit.capture(lambda a, b: evaluator.relinearize(evaluator.multiply(a, b), rk))
    product = time_op("multiply+relinearize", context, mul, ct1, ct2)
    assert torch.equal(added.data, evaluator.add(ct1, ct2).data)
    assert torch.equal(product.data,
                       evaluator.relinearize(evaluator.multiply(ct1, ct2), rk).data)


def ckks_performance(n=8192, device=None):
    print(f"CKKS performance, n={n}:")
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    bits = [50, 40, 40, 50] if n >= 8192 else [30, 20, 30]
    scale_bits = 40 if n >= 8192 else 20
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    context = SEALContext(
        parms, sec_level=SecLevelType.TC128 if n >= 8192 else SecLevelType.NONE,
        device=device)
    keygen = KeyGenerator(context)
    pk = keygen.create_public_key()
    rk = keygen.create_relin_keys()
    encryptor = Encryptor(context, pk)
    evaluator = Evaluator(context)
    encoder = CKKSEncoder(context)

    scale = 2.0 ** scale_bits
    vals = np.linspace(-1, 1, encoder.slot_count)
    plain = encoder.encode(vals, scale)
    ct1 = encryptor.encrypt(plain)
    ct2 = encryptor.encrypt(encoder.encode(vals[::-1], scale))

    time_op("encode", context, encoder.encode, vals, scale)
    time_op("encrypt", context, encryptor.encrypt, plain)

    def eager(a, b):
        return evaluator.rescale_to_next(evaluator.relinearize(evaluator.multiply(a, b), rk))

    pipeline = jit.capture(eager)
    out = time_op("multiply+relin+rescale", context, pipeline, ct1, ct2)
    assert torch.equal(out.data, eager(ct1, ct2).data)


def main(n_bfv: int = 4096, n_ckks: int = 8192, device=None):
    bfv_performance(n_bfv, device)
    ckks_performance(n_ckks, device)
    print("8_performance OK")


if __name__ == "__main__":
    main()
