"""Streaming a large ciphertext batch through the flagship pipeline on the
port (the counterpart of examples/13_streaming_pipeline.py).

The pattern: encode/encrypt a stream of plaintext vectors on the host,
feed them to the device in B-sized chunks, run one captured multiply +
relinearize + rescale step per chunk (jit.capture: one CUDA graph replay
per chunk, queued on the card without waiting), then synchronise once
before decrypting. Where seal_tpu's step is lax.map over jax.vmap
sub-batches, the captured step here loops over the sub-batches, each a
batched Evaluator call ([sub, 2, L, N]). With device="cpu" it runs as the
plain PyTorch path.
"""

import numpy as np
import torch

from seal_tpu_torch import (
    CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
    KeyGenerator, SchemeType, SEALContext, SecLevelType, jit,
)


def main(n=2048, total=32, B=8, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 28, 40]))
    parms.set_special_modulus_size(1)
    ctx = SEALContext(parms, sec_level=SecLevelType.NONE, device=device)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, kg.create_public_key())
    dec = Decryptor(ctx, kg.secret_key())
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    scale = 2.0 ** 28

    # host-side stream of inputs (each chunk: B ciphertexts)
    rng = np.random.default_rng(0)
    inputs = rng.uniform(-1, 1, (total, encoder.slot_count))
    weights = np.linspace(0.5, 1.5, encoder.slot_count)
    ct_w = enc.encrypt(encoder.encode(weights, scale))

    # the per-chunk step: batched multiply + relinearize + rescale
    rk = kg.create_relin_keys()

    def one(x):
        ca = ct_w.copy()
        ca.data = x
        cw = ct_w.copy()
        cw.data = ct_w.data.expand(x.shape)       # the weights, shared by the batch
        return ev.rescale_to_next(ev.relinearize(ev.multiply(ca, cw), rk)).data

    # seal_tpu's production recipe: large chunks, the step a loop over
    # sub-batches (its lax.map over vmap sub-batches)
    submap = B // 2

    def stepped(x):
        return torch.cat([one(x[i:i + submap]) for i in range(0, B, submap)])

    step = jit.capture(stepped)

    outs = []
    for c in range(0, total, B):
        chunk = [enc.encrypt(encoder.encode(v, scale)) for v in inputs[c:c + B]]
        outs.append(step(torch.stack([ct.data for ct in chunk])))   # one replay per chunk
    # drain: wait for the whole stream once
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)

    # decrypt a few results and check them
    proto = ev.rescale_to_next(ev.relinearize(ev.multiply(ct_w, ct_w), rk))
    for k in (0, total - 1):
        ct = proto.copy()
        ct.data = outs[k // B][k % B]
        got = encoder.decode(dec.decrypt(ct)).cpu().numpy()
        want = inputs[k] * weights
        assert np.max(np.abs(got - want)) < 1e-3, np.max(np.abs(got - want))
    print(f"streamed {total} ciphertexts in {total // B} chunks of {B}: "
          "products verified")
    print("13_streaming_pipeline OK")


if __name__ == "__main__":
    main()
