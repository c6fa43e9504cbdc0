#!/usr/bin/env python3
"""Drive seal_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. build: compile every CUDA kernel from seal_tpu_torch/csrc (one nvcc per
   source, started together).
2. K1 (the NTT kernel, forward and inverse) at N=16384 at every shape the
   paths below give it (2 to 56 rows), and at n=32768 and 131072 on 2
   rows. 3. K2 (the key-switch inner product, 128-bit route) and 4. K3 (the
   key-switch inner product, Shoup-quotient route) at N=16384, at the
   shapes the main paths give them. Each is held bit for bit against its
   plain PyTorch version on CPU copies of the same inputs (K3 also against
   K2), with the kernel's median time in two ways, `ms` around one call
   with CUDA events (host time included) and `device_ms` with its calls
   replayed from a CUDA graph (the host out of the way), the plain
   version's time on the host CPU, and the least time the card could take
   (bytes at 3.35 TB/s or 32-bit integer multiplies at 16.7 T/s, whichever
   is larger).
5. pipeline: CKKS n=16384 with 8 data primes in both modes of the repo's
   bench.py: α=2 (bits [44]*8 + [43]*2) multiply -> relinearize_rescale, and
   α=1 (bits [48]*8 + [54]) multiply -> relinearize -> rescale_to_next. Keys
   and two sparse plaintexts (a few coefficients of about 2^40) are made on
   the card from one torch.Generator; the card's result is held bit for bit
   against the same pipeline on CPU copies (the plain path), and its
   decryption against the exact negacyclic product m1·m2/q_last. It runs
   again with config.keyswitch_shoup on, bit for bit as with it off.
6. rotations, in both modes: Galois keys for steps 1-8 and the conjugation
   made on the card; on a fresh sparse ciphertext rotate_vector by 1 and by
   9 (no key of its own: NAF 1 + 8), complex_conjugate and
   rotate_batch_hoisted(1..8), with the Shoup flag off and on (bit for bit
   the same), the card against the plain path on CPU copies, and every
   decryption against the exact automorphism of the plaintext.
7. K1 passes: the device time of each of K1's two kernels at phase 2's
   shapes, from torch.profiler's CUDA trace (after the paths, so that the
   profiler does not weigh on their host-clock times).
8. kernels: one JSON line with every ported kernel, its check and times.

Launch counts are zeroed just before each run of a path and read just after.

It needs one CUDA device, and ends with the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

N = 16384
LOG_N = 14
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT32_MUL_PER_S = 16.7e12       # 132 SMs x 64 INT32 lanes x 1.98 GHz
SEED = 20261016
NOISE_BOUND = 1 << 16           # |decrypted - m1·m2/q_last| allowed, in units
MODES = {
    "alpha2_fused": dict(bits=[44] * 8 + [43] * 2, alpha=2, fused=True),
    "alpha1_parity": dict(bits=[48] * 8 + [54], alpha=1, fused=False),
}
# Multiplies of 32-bit words per 64x64-bit product: low half 3, high half 4.
MUL_LO, MUL_HI = 3, 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of one call of fn on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=3):
    """Median milliseconds of one call of fn on the host."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes, muls):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_residues(shape, moduli, gen, factor=1):
    """int64 residues below factor·q of the prime of each row (row % L)."""
    import torch

    L = len(moduli)
    q = torch.tensor(moduli, dtype=torch.int64).reshape(L, 1)
    u = torch.randint(0, 1 << 62, tuple(shape), generator=gen, dtype=torch.int64)
    return u % (q * factor)


# ---------------------------------------------------------------------------
# phases 2 and 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

# K1's shapes on the paths run at N=16384 (direction, shape): rows 8 (two
# towers), 14, 16, 24 and 56 forward; 2, 4, 6 and 8 inverse
NTT_SHAPES = (("ntt_forward", (4, 2, N)), ("ntt_forward", (8, 1, N)),
              ("ntt_forward", (2, 7, N)), ("ntt_forward", (2, 8, N)),
              ("ntt_forward", (3, 8, N)), ("ntt_forward", (7, 8, N)),
              ("ntt_inverse", (2, 1, N)), ("ntt_inverse", (2, 2, N)),
              ("ntt_inverse", (2, 3, N)), ("ntt_inverse", (8, N)))
NTT_LARGE = (15, 17)            # n = 32768 and 131072 at 2 rows
GRAPH_CALLS = 20


def graph_ms(fn, reps=10):
    """Median milliseconds of one call of fn on the card with the host out of
    the way: GRAPH_CALLS calls captured in one CUDA graph, each replay timed
    with CUDA events and divided by GRAPH_CALLS."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    return cuda_ms(graph.replay, reps=reps) / GRAPH_CALLS


def ntt_case(kind, shape, moduli, gen):
    """K1 at one shape: bit for bit against the plain version (lazy off and
    on), timed. Returns its line and the timed call."""
    import torch

    from seal_tpu_torch.ops import ntt

    log_n = shape[-1].bit_length() - 1
    n, L = shape[-1], shape[-2]
    t_dev = ntt.make_ntt_tables(log_n, moduli[:L], "cuda")
    t_cpu = ntt.make_ntt_tables(log_n, moduli[:L], "cpu")
    rows = math.prod(shape[:-1])
    kernel = getattr(ntt, f"{kind}_cuda")
    plain = getattr(ntt, f"{kind}_plain")
    factor = 4 if kind == "ntt_forward" else 2
    q = torch.tensor(moduli[:L], dtype=torch.int64)
    x = random_residues(shape, moduli[:L], gen, factor)
    x[..., 0] = factor * q - 1                  # the largest input and q - 1
    x[..., 1] = q - 1
    x_dev = x.cuda()
    want = {}
    for lazy in (False, True):
        got = kernel(x_dev, t_dev, lazy)
        torch.cuda.synchronize()
        want[lazy] = plain(x, t_cpu, lazy)
        require(torch.equal(got.cpu(), want[lazy]), f"{kind} lazy={lazy} {shape} bit-exact")
    line = {"phase": "K1", "kernel": kind, "shape": list(shape), "rows": rows,
            "bit_exact": True, "max_abs_err": 0}
    run = lambda: kernel(x_dev, t_dev, False)        # noqa: E731
    line["ms"] = cuda_ms(run)
    line["device_ms"] = graph_ms(run)
    line["plain_ms"] = host_ms(lambda: plain(x, t_cpu, False), reps=1)
    # data in and out once, the primes' op and quotient tables once
    nbytes = 2 * rows * n * 8 + 2 * L * n * 8
    muls = rows * (n // 2) * log_n * (2 * MUL_LO + MUL_HI)
    line["bound_ms"], line["bound_by"] = bound(nbytes, muls)
    emit(line)
    return line, run


def phase_ntt(gen):
    """({kernel: its line at the shape the kernels line reports},
    [(kernel, shape, timed call)] at every shape)."""
    from seal_tpu_torch import CoeffModulus

    moduli = [m.value for m in CoeffModulus.create(N, MODES["alpha2_fused"]["bits"])]
    results, runs = {}, []
    cases = [(kind, shape, moduli) for kind, shape in NTT_SHAPES]
    for log_n in NTT_LARGE:
        big = [m.value for m in CoeffModulus.create(1 << log_n, [50, 50])]
        cases += [(kind, (2, 1 << log_n), big) for kind in ("ntt_forward", "ntt_inverse")]
    for kind, shape, mods in cases:
        results[(kind, shape)], run = ntt_case(kind, shape, mods, gen)
        runs.append((kind, shape, run))
    return ({"ntt_forward": results[("ntt_forward", (7, 8, N))],
             "ntt_inverse": results[("ntt_inverse", (8, N))]}, runs)


def phase_ntt_passes(runs):
    """Device microseconds of each of K1's kernels per transform at every
    shape of phase 2, from torch.profiler's CUDA trace of GRAPH_CALLS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for kind, shape, run in runs:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(GRAPH_CALLS):
                run()
            torch.cuda.synchronize()
        passes = {}
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
                passes[name.replace("void ", "").strip()] = ev.device_time_total / ev.count
        emit({"phase": "K1_passes", "kernel": kind, "shape": list(shape), "pass_us": passes})


def key_shapes():
    """(mode, J, I): the key-switch contraction of each mode: α=1 has 8
    digits over 8 + 1 rows, α=2 has 4 digits over 8 + 2 rows."""
    return (("alpha1_parity", 8, 9), ("alpha2_fused", 4, 10))


def phase_keyswitch(gen):
    import torch

    from seal_tpu_torch import CoeffModulus
    from seal_tpu_torch.ops import keyswitch

    results = {}
    for mode, J, I in key_shapes():
        moduli = [m.value for m in CoeffModulus.create(N, MODES[mode]["bits"])]
        t = random_residues((J, I, N), moduli, gen)
        k = random_residues((J, 2, I, N), moduli, gen)
        consts = keyswitch.pack_mod_consts(moduli, "cpu")
        t_dev, k_dev, c_dev = t.cuda(), k.cuda(), consts.cuda()
        got = keyswitch.keyswitch_inner_cuda(t_dev, k_dev, c_dev).cpu()
        want = keyswitch.keyswitch_inner_plain(t, k, consts)
        require(torch.equal(got, want), f"keyswitch_inner (J, I) = {(J, I)} bit-exact")
        run = lambda: keyswitch.keyswitch_inner_cuda(t_dev, k_dev, c_dev)  # noqa: E731
        ms, device_ms = cuda_ms(run), graph_ms(run)
        plain_ms = host_ms(lambda: keyswitch.keyswitch_inner_plain(t, k, consts))
        nbytes = (J * I * N + 2 * J * I * N + 2 * I * N) * 8
        # per (i, x): 2J full products, then two Barrett-128 reductions
        muls = I * N * (2 * J * (MUL_LO + MUL_HI) + 2 * (4 * MUL_LO + 3 * MUL_HI))
        b_ms, b_by = bound(nbytes, muls)
        line = {"phase": "K2", "kernel": "keyswitch_inner", "shape": [J, I, N],
                "bit_exact": True, "max_abs_err": 0, "ms": ms, "device_ms": device_ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        emit(line)
        results[mode] = line
    return {"keyswitch_inner": results["alpha1_parity"]}


def phase_keyswitch_shoup(gen):
    import torch

    from seal_tpu_torch import CoeffModulus
    from seal_tpu_torch.ops import keyswitch

    results = {}
    for mode, J, I in key_shapes():
        moduli = [m.value for m in CoeffModulus.create(N, MODES[mode]["bits"])]
        q = torch.tensor(moduli, dtype=torch.int64).reshape(I, 1)
        t = random_residues((J, I, N), moduli, gen)
        k = random_residues((J, 2, I, N), moduli, gen)
        t[..., 0] = k[..., 0] = q[:, 0] - 1          # quotients with the top bit
        kq = keyswitch.key_quotients(k, moduli)
        consts, max_q = keyswitch.pack_mod_consts(moduli, "cpu"), max(moduli)
        t_dev, k_dev, kq_dev, c_dev = t.cuda(), k.cuda(), kq.cuda(), consts.cuda()
        got = keyswitch.keyswitch_inner_shoup_cuda(t_dev, k_dev, kq_dev, c_dev, max_q)
        want = keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts, max_q)
        require(torch.equal(got.cpu(), want), f"keyswitch_inner_shoup {(J, I)} bit-exact")
        require(torch.equal(got, keyswitch.keyswitch_inner_cuda(t_dev, k_dev, c_dev)),
                f"keyswitch_inner_shoup {(J, I)} equals keyswitch_inner")
        require(torch.equal(keyswitch.key_quotients(k_dev, moduli).cpu(), kq),
                f"key quotients {(J, I)} on the card equal the CPU's")
        run = lambda: keyswitch.keyswitch_inner_shoup_cuda(  # noqa: E731
            t_dev, k_dev, kq_dev, c_dev, max_q)
        ms, device_ms = cuda_ms(run), graph_ms(run)
        plain_ms = host_ms(lambda: keyswitch.keyswitch_inner_shoup_plain(
            t, k, kq, consts, max_q))
        nbytes = (J * I * N + 4 * J * I * N + 2 * I * N) * 8
        # per (i, x) and component: J lazy Shoup terms, three 64-bit products each
        muls = I * N * 2 * J * (2 * MUL_LO + MUL_HI)
        b_ms, b_by = bound(nbytes, muls)
        line = {"phase": "K3", "kernel": "keyswitch_inner_shoup", "shape": [J, I, N],
                "bit_exact": True, "equals_k2": True, "max_abs_err": 0, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        emit(line)
        results[mode] = line
    return {"keyswitch_inner_shoup": results["alpha1_parity"]}


# ---------------------------------------------------------------------------
# phase 4: the pipeline
# ---------------------------------------------------------------------------

def sparse_plain(gen, count=4, bits=40):
    """{index: value}: `count` coefficients of magnitude about 2^bits."""
    import torch

    idx = torch.randperm(N, generator=gen, device=gen.device)[:count].tolist()
    mag = torch.randint(1 << (bits - 1), 1 << bits, (count,), generator=gen,
                        device=gen.device).tolist()
    sign = torch.randint(0, 2, (count,), generator=gen, device=gen.device).tolist()
    return {i: (m if s else -m) for i, m, s in zip(idx, mag, sign)}


def negacyclic_product(a: dict, b: dict, n: int) -> dict:
    out: dict = {}
    for i, x in a.items():
        for j, y in b.items():
            k, v = i + j, x * y
            if k >= n:
                k, v = k - n, -v
            out[k] = out.get(k, 0) + v
    return out


def encode_sparse(ctx, coeffs: dict, scale: float):
    """NTT-form plaintext of an integer polynomial at the first level."""
    import torch

    from seal_tpu_torch import Plaintext
    from seal_tpu_torch.ops import ntt

    cd = ctx.first_context_data()
    rows = torch.zeros((cd.coeff_modulus_size, N), dtype=torch.int64)
    for i, v in coeffs.items():
        rows[:, i] = torch.tensor([v % q for q in cd.key_moduli()])
    return Plaintext(ntt.ntt_forward(rows.to(ctx.device), cd.ntt_tables),
                     tuple(cd.parms_id), scale)


def run_mode(ev, fused, ct1, ct2, rk):
    prod = ev.multiply(ct1, ct2)
    if fused:
        return ev.relinearize_rescale(prod, rk)
    return ev.rescale_to_next(ev.relinearize(prod, rk))


def contexts(spec):
    """(the card's context, the CPU's) for one mode."""
    from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SEALContext

    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, spec["bits"]))
    parms.set_special_modulus_size(spec["alpha"])
    return SEALContext(parms), SEALContext(parms, device="cpu")


def counted(fn):
    """fn()'s result, synchronised, and the kernel launches it made: the
    counts are zeroed just before and read just after."""
    import torch

    from seal_tpu_torch import cuda

    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(cuda.launches)


def add_counts(total, counts):
    for name, count in counts.items():
        total[name] = total.get(name, 0) + count
    return total


def centered_row0(ctx, ct, sk):
    """Row 0 of the decrypted phase in the coefficient domain, centered."""
    from seal_tpu_torch import Decryptor
    from seal_tpu_torch.ops import ntt

    cd = ctx.get_context_data(ct.parms_id)
    phase = ntt.ntt_inverse(Decryptor(ctx, sk).decrypt(ct).data, cd.ntt_tables)
    q0 = cd.key_moduli()[0]
    return [v - q0 if v > q0 // 2 else v for v in phase[0].cpu().tolist()]


def phase_pipeline(mode, spec):
    import numpy as np
    import torch

    from seal_tpu_torch import Encryptor, Evaluator, KeyGenerator, interop
    from seal_tpu_torch.config import config
    from seal_tpu_torch.dtypes import u64_numpy

    ctx, ctx_cpu = contexts(spec)
    gen = torch.Generator(device=ctx.device).manual_seed(SEED)

    t0 = time.perf_counter()
    kg = KeyGenerator(ctx, gen)
    sk = kg.secret_key()
    rk = kg.create_relin_keys()
    enc = Encryptor(ctx, sk, gen)
    scale = 2.0 ** 40
    m1, m2 = sparse_plain(gen), sparse_plain(gen)
    ct1 = enc.encrypt_symmetric(encode_sparse(ctx, m1, scale))
    ct2 = enc.encrypt_symmetric(encode_sparse(ctx, m2, scale))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    ev = Evaluator(ctx)
    out, launches = counted(lambda: run_mode(ev, spec["fused"], ct1, ct2, rk))
    config.keyswitch_shoup = True
    try:
        out_shoup, launches_shoup = counted(lambda: run_mode(ev, spec["fused"], ct1, ct2, rk))
    finally:
        config.keyswitch_shoup = False
    require(np.array_equal(out_shoup.to_numpy(), out.to_numpy()),
            f"{mode}: Shoup route bit-identical to the 128-bit route")
    require(launches_shoup["keyswitch_inner_shoup"] > 0 and launches["keyswitch_inner"] > 0,
            f"{mode}: each key-switch route launched its kernel")

    # the same pipeline on CPU copies of the same inputs: the plain path
    def carry(ct):
        return interop.ciphertext_from_numpy(
            ctx_cpu, ct.to_numpy(), ct.parms_id, ct.scale, ct.is_ntt_form)

    rk_cpu = interop.relin_keys_from_numpy(ctx_cpu, [u64_numpy(k) for k in rk.keys])
    t0 = time.perf_counter()
    out_cpu = run_mode(Evaluator(ctx_cpu), spec["fused"], carry(ct1), carry(ct2), rk_cpu)
    cpu_s = time.perf_counter() - t0
    require(np.array_equal(out.to_numpy(), out_cpu.to_numpy()),
            f"{mode}: card output bit-identical to the plain path")
    require(tuple(out.parms_id) == tuple(out_cpu.parms_id) and out.scale == out_cpu.scale,
            f"{mode}: metadata equal")

    # decrypt: row 0 of the coefficient form, centered mod q0
    q_last = ctx.get_context_data(ct1.parms_id).key_moduli()[-1]
    got = centered_row0(ctx, out, sk)
    exact = negacyclic_product(m1, m2, N)
    err = max(abs(got[i] - exact.get(i, 0) / q_last) for i in range(N))
    require(err <= NOISE_BOUND, f"{mode}: decryption error {err} within {NOISE_BOUND}")
    require(out.size == 2 and out.coeff_modulus_size == 7, f"{mode}: output shape")

    ms = host_ms(lambda: (run_mode(ev, spec["fused"], ct1, ct2, rk),
                          torch.cuda.synchronize()), reps=10)
    line = {"phase": "pipeline", "mode": mode, "n": N, "data_primes": 8,
            "special_primes": spec["alpha"], "bit_exact_vs_plain": True,
            "max_decrypt_err": err, "noise_bound": NOISE_BOUND,
            "signal_log2": math.log2(max(abs(v) for v in exact.values()) / q_last),
            "launches": launches, "launches_shoup": launches_shoup,
            "shoup_bit_identical": True, "ms_per_mult_relin_rescale": ms,
            "setup_s": setup_s, "plain_cpu_s": cpu_s}
    emit(line)
    return add_counts(launches, launches_shoup)


# ---------------------------------------------------------------------------
# phase 6: rotations
# ---------------------------------------------------------------------------

ROT_KEY_STEPS = list(range(1, 9))
ROT_NAF_STEP = 9                    # no key of its own: NAF 1 + 8


def automorphism(coeffs: dict, elt: int, n: int) -> dict:
    """x^i -> x^(i·elt mod 2n), with x^n = -1."""
    out = {}
    for i, v in coeffs.items():
        k = i * elt % (2 * n)
        out[k % n] = -v if k >= n else v
    return out


def rotations(ev, ct, gk):
    """{name: list of ciphertexts}: the rotations the phase holds."""
    return {"rotate_1": [ev.rotate_vector(ct, 1, gk)],
            "rotate_9_naf": [ev.rotate_vector(ct, ROT_NAF_STEP, gk)],
            "conjugate": [ev.complex_conjugate(ct, gk)],
            "hoisted_1_to_8": ev.rotate_batch_hoisted(ct, ROT_KEY_STEPS, gk)}


def phase_rotations(mode, spec):
    import numpy as np
    import torch

    from seal_tpu_torch import Encryptor, Evaluator, KeyGenerator, interop
    from seal_tpu_torch.config import config
    from seal_tpu_torch.dtypes import u64_numpy

    ctx, ctx_cpu = contexts(spec)
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 1)
    t0 = time.perf_counter()
    kg = KeyGenerator(ctx, gen)
    sk = kg.secret_key()
    gk = kg.create_galois_keys(steps=ROT_KEY_STEPS + [0])
    m = sparse_plain(gen)
    ct = Encryptor(ctx, sk, gen).encrypt_symmetric(encode_sparse(ctx, m, 2.0 ** 40))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    ev = Evaluator(ctx)
    outs, launches = counted(lambda: rotations(ev, ct, gk))
    config.keyswitch_shoup = True
    try:
        outs_shoup, launches_shoup = counted(lambda: rotations(ev, ct, gk))
        ms_shoup = host_ms(lambda: (ev.rotate_vector(ct, 1, gk), torch.cuda.synchronize()), 10)
        hoisted_ms_shoup = host_ms(lambda: (ev.rotate_batch_hoisted(ct, ROT_KEY_STEPS, gk),
                                            torch.cuda.synchronize()), 5)
    finally:
        config.keyswitch_shoup = False
    ms = host_ms(lambda: (ev.rotate_vector(ct, 1, gk), torch.cuda.synchronize()), 10)
    hoisted_ms = host_ms(lambda: (ev.rotate_batch_hoisted(ct, ROT_KEY_STEPS, gk),
                                  torch.cuda.synchronize()), 5)
    require(launches_shoup["keyswitch_inner_shoup"] > 0 and launches["keyswitch_inner"] > 0,
            f"{mode}: each key-switch route launched its kernel")
    for name, cts in outs.items():
        for a, b in zip(cts, outs_shoup[name]):
            require(np.array_equal(a.to_numpy(), b.to_numpy()),
                    f"{mode} {name}: Shoup route bit-identical to the 128-bit route")

    # the plain path on CPU copies, for all but the NAF rotation
    ct_cpu = interop.ciphertext_from_numpy(ctx_cpu, ct.to_numpy(), ct.parms_id, ct.scale)
    gk_cpu = interop.galois_keys_from_numpy(
        ctx_cpu, [None if k is None else u64_numpy(k) for k in gk.keys])
    ev_cpu = Evaluator(ctx_cpu)
    t0 = time.perf_counter()
    cpu = {"rotate_1": [ev_cpu.rotate_vector(ct_cpu, 1, gk_cpu)],
           "conjugate": [ev_cpu.complex_conjugate(ct_cpu, gk_cpu)],
           "hoisted_1_to_8": ev_cpu.rotate_batch_hoisted(ct_cpu, ROT_KEY_STEPS, gk_cpu)}
    cpu_s = time.perf_counter() - t0
    for name, cts in cpu.items():
        for a, b in zip(outs[name], cts):
            require(np.array_equal(a.to_numpy(), b.to_numpy()),
                    f"{mode} {name}: card output bit-identical to the plain path")

    gt = ctx.first_context_data().galois_tool
    elts = {"rotate_1": [gt.get_elt_from_step(1)],
            "rotate_9_naf": [gt.get_elt_from_step(ROT_NAF_STEP)],
            "conjugate": [2 * N - 1],
            "hoisted_1_to_8": gt.get_elts_from_steps(ROT_KEY_STEPS)}
    err = 0
    for name, cts in outs.items():
        for elt, out in zip(elts[name], cts):
            require(out.size == 2 and tuple(out.parms_id) == tuple(ct.parms_id),
                    f"{mode} {name}: output shape and level")
            exact = automorphism(m, elt, N)
            got = centered_row0(ctx, out, sk)
            err = max(err, max(abs(got[i] - exact.get(i, 0)) for i in range(N)))
    require(err <= NOISE_BOUND, f"{mode}: rotation decryption error {err} within {NOISE_BOUND}")

    line = {"phase": "rotations", "mode": mode, "n": N, "data_primes": 8,
            "special_primes": spec["alpha"], "key_steps": ROT_KEY_STEPS + [0],
            "bit_exact_vs_plain": True, "shoup_bit_identical": True,
            "max_decrypt_err": err, "noise_bound": NOISE_BOUND,
            "launches": launches, "launches_shoup": launches_shoup,
            "ms_per_rotate_vector": ms, "ms_per_rotate_vector_shoup": ms_shoup,
            "ms_per_hoisted_rotation": hoisted_ms / len(ROT_KEY_STEPS),
            "ms_per_hoisted_rotation_shoup": hoisted_ms_shoup / len(ROT_KEY_STEPS),
            "setup_s": setup_s, "plain_cpu_s": cpu_s}
    emit(line)
    return add_counts(launches, launches_shoup)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from seal_tpu_torch import cuda

    emit({"phase": "build", "seconds": cuda.build(), "sources": list(cuda.SOURCES)})
    gen = torch.Generator().manual_seed(SEED)
    kernels, ntt_runs = phase_ntt(gen)
    kernels.update(phase_keyswitch(gen))
    kernels.update(phase_keyswitch_shoup(gen))

    total = {name: 0 for name in cuda.launches}
    for mode, spec in MODES.items():
        add_counts(total, phase_pipeline(mode, spec))
        add_counts(total, phase_rotations(mode, spec))
    for name, count in total.items():
        require(count > 0, f"{name} launched on the paths run")
    phase_ntt_passes(ntt_runs)

    # K4 (_ntt_kernel_compact) computes K1's transform from the same roots
    # that csrc/ntt.cu reads, in the same order: ntt.cu is its counterpart
    ntt_tpu = ("seal_tpu/ops/ntt_pallas.py:542, seal_tpu/ops/ntt_pallas.py:717, "
               "seal_tpu/ops/ntt_pallas.py:428")
    replaces = {
        "ntt_forward": ntt_tpu,
        "ntt_inverse": ntt_tpu,
        "keyswitch_inner": "seal_tpu/ops/keyswitch_pallas.py:56",
        "keyswitch_inner_shoup": "seal_tpu/ops/keyswitch_pallas.py:81",
    }
    source = {"ntt_forward": "seal_tpu_torch/csrc/ntt.cu",
              "ntt_inverse": "seal_tpu_torch/csrc/ntt.cu",
              "keyswitch_inner": "seal_tpu_torch/csrc/keyswitch.cu",
              "keyswitch_inner_shoup": "seal_tpu_torch/csrc/keyswitch.cu"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": total[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "device_ms": k["device_ms"],
         "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         "shape": k["shape"]}
        for name, k in kernels.items()]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
