#!/usr/bin/env python3
"""Drive seal_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. build: compile every CUDA kernel from seal_tpu_torch/csrc (one nvcc per
   source, started together) and the host byte stream's C++ (g++,
   seal_tpu_torch/native.py); then the host rate of one bulk draw of 16 MB
   from SEAL's seeded blake2xb byte stream (seal_tpu_torch/randomgen.py over
   the C++ XOF), which every key and encryption below draws from, beside
   the rate of its plain version (the numpy XOF) on the same bytes, which
   must be equal.
2. K1 (the NTT kernel, forward and inverse) at N=16384 at every shape the
   paths below give it (1 to 72 rows: the CKKS towers, BFV's auxiliary
   base Bsk of 61-bit primes with forward inputs up to 4q, the [8, 9, N]
   key-switch decomposition of BFV/BGV and the one-prime tower of the plain
   modulus t), and at n=32768 and 131072 on 2 rows. 3. K2 (the key-switch
   inner product, 128-bit route) and 4. K3 (the key-switch inner product,
   Shoup-quotient route) at N=16384, at the shapes the main paths give
   them. Each is held bit for bit against its plain PyTorch version on CPU
   copies of the same inputs (K3 also against K2), with the kernel's
   median time in two ways, `ms` around one call with CUDA events (host
   time included) and `device_ms` with its calls replayed from a CUDA
   graph (the host out of the way), the plain version's time on the host
   CPU, and the least time the card could take (bytes at 3.35 TB/s or
   32-bit integer multiplies at 16.7 T/s, whichever is larger).
5. pipeline: CKKS n=16384 with 8 data primes in both modes of the repo's
   bench.py: α=2 (bits [44]*8 + [43]*2) multiply -> relinearize_rescale, and
   α=1 (bits [48]*8 + [54]) multiply -> relinearize -> rescale_to_next. Keys
   and two sparse plaintexts (a few coefficients of about 2^40) are made on
   the card from a random seed; the card's result is held bit for bit
   against the same pipeline on CPU copies (the plain path), and its
   decryption against the exact negacyclic product m1·m2/q_last. It runs
   again with config.keyswitch_shoup on, bit for bit as with it off.
6. rotations, in both modes: Galois keys for steps 1-8 and the conjugation
   made on the card; on a fresh sparse ciphertext rotate_vector by 1 and by
   9 (no key of its own: NAF 1 + 8), complex_conjugate and
   rotate_batch_hoisted(1..8), with the Shoup flag off and on (bit for bit
   the same), the card against the plain path on CPU copies, and every
   decryption against the exact automorphism of the plaintext.
7. BFV and BGV, each at SEAL's default 128-bit parameters for n=16384
   (CoeffModulus.bfv_default: 8 data primes and one special prime) with a
   20-bit batching t: the card makes the secret, public, relinearization
   and Galois keys (rows step 1, columns) from a random seed; two random
   slot vectors are encoded and encrypted (the first with the public key,
   the second with the secret key); multiply -> relinearize ->
   mod_switch_to_next -> rotate_rows(1) / rotate_columns, square and
   multiply_plain run with the Shoup flag off and on (bit for bit the
   same), every output is held bit for bit against the same ops on CPU
   copies (the plain path), the invariant noise budget of every ciphertext
   on the card against the CPU's, and every decode must equal the exact
   slotwise result mod t, rotated as the 2 x n/2 slot matrix says.
8. round trip, in both CKKS modes, the main path a user runs: from
   parms.set_random_seed alone, keygen (secret, public, relinearization
   keys) -> CKKSEncoder.encode of 8192 complex values from the unit disc
   at scale 2^40 -> encrypt (public key) and encrypt_symmetric -> multiply
   -> relinearize -> rescale (the fused tail at α=2) -> decrypt -> decode,
   on the card and on the CPU: every key, plaintext, ciphertext and decoded
   double bit for bit the same, and the decoded product within 1e-4 of
   numpy's exact product.
9. batch, in both CKKS modes, bench.py's batched main path (its jax.vmap
   over B ciphertexts that share one relinearization key): from
   parms.set_random_seed, encode_many of 16 + 16 vectors from the unit
   disc at scale 2^40 -> encrypt_many and encrypt_symmetric_many -> the
   two stacked batches [16, 2, 8, N] through multiply -> relinearize ->
   rescale (the fused tail at α=2), with the Shoup flag off (K2) and on
   (K3) -> decrypt_many -> decode_many. Every member is held bit for bit
   against its own sequential call on the card (encode, encrypt, the op,
   decrypt, decode), the whole batch against the plain path on CPU copies,
   and each decoded product within 1e-4 of numpy's. Then, at B = 1 (one
   unbatched ciphertext), 4 and 16 and with the flag off and on: the
   launches per batched op (which must equal one ciphertext's), host-clock
   ms per batch and per ciphertext (median of 5, synchronised), and the
   torch.profiler device-busy share of one batched op.
10. exact batch: BFV and BGV at phase 7's parameters, B = 4: encode_many ->
   encrypt_many -> multiply -> relinearize -> mod_switch_to_next on the
   stacked batch, flag off and on, each member against its sequential call
   on the card, decrypt_many -> decode_many against the exact products.
11. threshold, the fork's multiparty layer, in two configurations: BFV at
   phase 7's parameters and CKKS at bench.py's --parity parameters (α=1,
   bits [48]*8 + [54], scale 2^40). Three parties, each with its own
   context and random seed (10 + i, 2, ..., 8), make their secret keys,
   public keys sharing party 0's c1 and Galois key shares under party 0's
   key-switching c1s (BFV rows step 1 and the columns element, CKKS rotate
   step 1) on the card; then the common public key and the aggregated
   Galois keys; random slots encoded and encrypted under the common key;
   one rotation under the aggregated keys, Shoup flag off (K2) and on (K3);
   each party's partial decryption and their aggregate -> decode. Every
   key, share, ciphertext, partial and aggregate is held bit for bit
   against the same flow on CPU copies of the contexts (the plain path),
   the aggregate against the common secret key's decryption, the BFV
   decode exactly and the CKKS decode within 1e-4 against the rotated
   slots. Then the partials again with 20 bits of smudging noise: each
   minus its unsmudged twin is one centred value in [-2^20, 2^20] on every
   row, the BFV decode still exact, the CKKS decode within 1e-3.
12. wire: the threshold objects through SEAL's wire format (ZLIB) and back
   onto the card: each partial before aggregation, each Galois share and
   the common public key; for CKKS also a save_seed relinearization key
   and a seeded symmetric ciphertext (phase 8's α=1 parameters) beside
   their unseeded twins. Each save from the card must equal the save of
   its CPU copy byte for byte, each load equal the original, valcheck hold
   it valid and refuse a copy with one residue set to q, and each seeded
   object be about half its twin; bytes, ms and MB/s of every save and
   load.
13. graphs (seal_tpu_torch/jit.py), in both CKKS modes at phase 5's
   parameters, with the Shoup flag off and on, at B = 1 (one unbatched
   ciphertext) and 16: bench.py's pipeline through a JitEvaluator (one CUDA
   graph per op) and bench.py's `one` under jit.capture (one graph), each
   call on random ciphertexts held bit for bit against the eager Evaluator
   on the card, the first call capturing and the later ones replaying, and
   the launches of every replay equal to the eager call's; host-clock ms
   per call and per ciphertext, eager against replayed (median of 20,
   synchronised), the device-busy share of one replay (torch.profiler,
   flag off), the cache sizes and the graph pools' device memory; then a
   second relinearization key of the same shapes, which must give its own
   eager result. Then phase 7's BFV path (multiply -> relinearize ->
   mod_switch_to_next -> rotate_rows(1)) through a JitEvaluator, the same
   way.
14. examples: all fourteen scripts of examples_torch/ (the port of each
   script of examples/) at the originals' default sizes on the card (CKKS
   n=16384 for 10; n=8192 for 3, 5, 6's CKKS part, 9 and 12; n=4096 for
   1, 4, 6's BFV part and 14, at B=64), each checking its own results,
   with its seconds and launches (each must launch K1, and K2 or K3 where
   it relinearizes or rotates). Then SEAL's n = 4096 golden vectors from
   the card's objects: the BFV, CKKS and BGV pipelines and the fork's
   three-party flow of tests/test_pipeline_n4096.py (its seeds and moduli),
   every intermediate hashed against tests/vectors/pipeline_n4096.json,
   the three key-switching pipelines again with the Shoup flag on (the same
   hashes), and tests/test_serialization_n4096.py's saves byte for byte
   against serialization_n4096.json (ZSTD only where zstandard imports; a
   line says when it is skipped), the first differing hash or byte offset
   named on a mismatch.
15. parallel (seal_tpu_torch/parallel/, parallel/dryrun.py) at phase 5's
   parameters and seeds, in both modes, with the Shoup flag off and on:
   first NCCL with one rank per card, then two gloo ranks that share the
   card, their collectives staged through the host. Each rank makes its
   keys and ciphertexts from the seed and holds against the unsharded card
   Evaluator, bit for bit: multiply -> relinearize split over tp ->
   rescale, the fused relinearize_rescale, a hoisted batch of rotations
   1..8, a batch of 16 through vmap_pipeline (dp x tp = 1 x world), a
   tower shard's forward NTT; and, on two ranks, the four-step NTT of [8,
   N] over 2 shards by both routes and a 2-stage pipeline of 2
   microbatches. One line per rank: each op's K1/K2/K3 launches on that
   rank (each key switch launches K1 and K2 or K3 on every rank), the
   census of its collectives (one all_reduce of 2·(L+α)·N·8 bytes per key
   switch, beside seal_tpu's 2·3·(L+α)·N·4), and host-clock ms per split
   key switch beside the unsharded one's.
16. path shapes: every configuration (kernel, input shape, moduli) at
   which phases 5-14 launched K1, K2 or K3, noted as they ran, that phases
   2-4 did not check (among them the examples' n = 256, 4096, 8192 and
   16384 towers and the n = 4096 vector flows), is checked as phases 2-4
   check theirs: random inputs of that shape over those moduli, bit for
   bit against the plain version on CPU copies, with `ms`, the plain
   version's time and `bound_ms`.
17. K1 passes: the device time of each of K1's two kernels at phase 2's
   shapes, from torch.profiler's CUDA trace (after the paths, so that the
   profiler does not weigh on their host-clock times).
18. kernels: one JSON line with every ported kernel, its check and times;
   its launches count every launch of the paths, graph replays and the
   ranks of phase 15 included. A line before it gives each phase's
   host-clock seconds.

Phases 3 and 4 also hold K2 and K3 over a batch [16, J, I, N] that shares
one key, at both modes' (J, I), against their plain versions.

Phases 7, 8 and 11 print, per step, the host-clock ms, the kernel launches
and the bytes drawn from the byte stream with their rate.
Launch counts are zeroed just before each run of a path and read just after.

It needs one CUDA device, and ends with the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import re
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


def seed_words(seed):
    """The 8-word random seed of a phase."""
    return (seed,) + (0,) * 7


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


def random_residues(shape, moduli, rng, factor=1):
    """int64 residues below factor·q of the prime of each row (row % L),
    from words of 63 random bits (factor·q < 2^63), drawn by a numpy
    generator."""
    import numpy as np
    import torch

    L = len(moduli)
    q = np.array(moduli, dtype=np.int64).reshape(L, 1) * factor
    u = rng.integers(0, 1 << 63, size=tuple(shape), dtype=np.uint64).view(np.int64)
    return torch.from_numpy(u % q)


# ---------------------------------------------------------------------------
# phases 2 and 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

BATCH = 16                      # bench.py's B (LAST_VALIDATED["batch"])
TP_RANKS = 2                    # phase 15's gloo ranks on the one card

# K1's shapes on the paths run at N=16384 (direction, shape): rows 8 (two
# towers), 14, 16, 24 and 56 forward; 2, 4, 6 and 8 inverse; and phase 15's
# own: a tower shard's 2·4 rows and the whole tower of the four-step NTT's
# reference forward, the batch's 16·8 rows inverse (a rank's digits are
# lifted from them)
NTT_SHAPES = (("ntt_forward", (4, 2, N)), ("ntt_forward", (8, 1, N)),
              ("ntt_forward", (2, 7, N)), ("ntt_forward", (2, 8, N)),
              ("ntt_forward", (3, 8, N)), ("ntt_forward", (7, 8, N)),
              ("ntt_forward", (2, 4, N)), ("ntt_forward", (8, N)),
              ("ntt_inverse", (2, 1, N)), ("ntt_inverse", (2, 2, N)),
              ("ntt_inverse", (2, 3, N)), ("ntt_inverse", (8, N)),
              ("ntt_inverse", (BATCH, 8, N)))
NTT_LARGE = (15, 17)            # n = 32768 and 131072 at 2 rows
EXACT_T_BITS = 20               # BFV/BGV: PlainModulus.batching(N, 20)
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


# (kernel, shape, moduli) of every check of a kernel against its plain
# version; phase 16 checks the paths' other configurations
CHECKED: set = set()


def ntt_case(kind, shape, moduli, rng, phase="K1", graph=True):
    """K1 at one shape: bit for bit against the plain version (lazy off and
    on), timed (with graph, also replayed from a CUDA graph, and the plain
    version timed on a call of its own). Returns its line and the timed
    call."""
    import torch

    from seal_tpu_torch.ops import ntt

    log_n = shape[-1].bit_length() - 1
    n, L = shape[-1], shape[-2]
    moduli = list(moduli[:L])
    CHECKED.add((kind, tuple(shape), tuple(moduli)))
    t_dev = ntt.make_ntt_tables(log_n, moduli, "cuda")
    t_cpu = ntt.make_ntt_tables(log_n, moduli, "cpu")
    rows = math.prod(shape[:-1])
    kernel = getattr(ntt, f"{kind}_cuda")
    plain = getattr(ntt, f"{kind}_plain")
    factor = 4 if kind == "ntt_forward" else 2
    q = torch.tensor(moduli, dtype=torch.int64)
    x = random_residues(shape, moduli, rng, factor)
    x[..., 0] = factor * q - 1                  # the largest input and q - 1
    x[..., 1] = q - 1
    x_dev = x.cuda()
    plain_ms = {}
    for lazy in (False, True):
        got = kernel(x_dev, t_dev, lazy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(x, t_cpu, lazy)
        plain_ms[lazy] = (time.perf_counter() - t0) * 1e3
        require(torch.equal(got.cpu(), want), f"{kind} lazy={lazy} {shape} bit-exact")
    line = {"phase": phase, "kernel": kind, "shape": list(shape), "rows": rows,
            "bit_exact": True, "max_abs_err": 0}
    run = lambda: kernel(x_dev, t_dev, False)        # noqa: E731
    line["ms"] = cuda_ms(run)
    if graph:
        line["device_ms"] = graph_ms(run)
        line["plain_ms"] = host_ms(lambda: plain(x, t_cpu, False), reps=1)
    else:
        line["plain_ms"] = plain_ms[False]
    # data in and out once, the primes' op and quotient tables once
    nbytes = 2 * rows * n * 8 + 2 * L * n * 8
    muls = rows * (n // 2) * log_n * (2 * MUL_LO + MUL_HI)
    line["bound_ms"], line["bound_by"] = bound(nbytes, muls)
    emit(line)
    return line, run


def exact_towers():
    """(q: bfv_default's 9 primes, bsk: the BEHZ base of the first level, t)."""
    from seal_tpu_torch import CoeffModulus, PlainModulus
    from seal_tpu_torch.ops import rns

    q = [m.value for m in CoeffModulus.bfv_default(N)]
    t = PlainModulus.batching(N, EXACT_T_BITS).value
    return q, rns.RNSToolHost(N, rns.RNSBase(q[:-1]), t).base_Bsk.base, t


def phase_ntt(rng):
    """({kernel: its line at the shape the kernels line reports},
    [(kernel, shape, timed call)] at every shape)."""
    from seal_tpu_torch import CoeffModulus

    moduli = [m.value for m in CoeffModulus.create(N, MODES["alpha2_fused"]["bits"])]
    results, runs = {}, []
    cases = [(kind, shape, moduli) for kind, shape in NTT_SHAPES]
    # phase 15: a rank's digit rows on the extended base, one target and a
    # batch of BATCH (TP_RANKS ranks), over each mode's own primes
    for mode, J, I in key_shapes()[2:]:
        ext = [m.value for m in CoeffModulus.create(N, MODES[mode]["bits"])]
        cases += [("ntt_forward", (J, I, N), ext), ("ntt_forward", (BATCH, J, I, N), ext)]
    # BFV/BGV: a multiply's two inputs over q and over Bsk (61-bit primes),
    # the key-switch decomposition over the 9 key primes, encode and decode
    # over t
    q, bsk, t = exact_towers()
    cases += [("ntt_forward", (4, len(bsk), N), bsk), ("ntt_inverse", (3, len(bsk), N), bsk),
              ("ntt_forward", (4, 8, N), q), ("ntt_forward", (8, 9, N), q),
              ("ntt_forward", (1, N), [t]), ("ntt_inverse", (1, N), [t])]
    for log_n in NTT_LARGE:
        big = [m.value for m in CoeffModulus.create(1 << log_n, [50, 50])]
        cases += [(kind, (2, 1 << log_n), big) for kind in ("ntt_forward", "ntt_inverse")]
    for kind, shape, mods in cases:
        results[(kind, shape)], run = ntt_case(kind, shape, mods, rng)
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
    digits over 8 + 1 rows, α=2 has 4 digits over 8 + 2 rows; then each
    rank's share of those digits when phase 15 splits them over TP_RANKS."""
    whole = (("alpha1_parity", 8, 9), ("alpha2_fused", 4, 10))
    return whole + tuple((mode, -(-J // TP_RANKS), I) for mode, J, I in whole)


def keyswitch_bytes(B, J, I, quotients, n=N):
    """Bytes a K2 (K3 with quotients) call over B targets must move: t and
    the output once per member, the key (and its quotients) once."""
    key_words = (4 if quotients else 2) * J * I * n
    return (B * J * I * n + key_words + 2 * B * I * n) * 8


def keyswitch_muls(J, I, shoup, n=N):
    """32-bit multiplies of one target's key switch: per (i, x) and
    component, K2 takes J full products and then a Barrett-128 reduction,
    K3 J lazy Shoup terms of three 64-bit products each."""
    if shoup:
        return I * n * 2 * J * (2 * MUL_LO + MUL_HI)
    return I * n * 2 * (J * (MUL_LO + MUL_HI) + 4 * MUL_LO + 3 * MUL_HI)


def keyswitch_batch(kind, mode, J, I, rng):
    """K2 or K3 over a batch [BATCH, J, I, N] that shares one key [J, 2, I,
    N]: one launch, bit for bit the plain version on CPU copies, timed.
    Returns its line."""
    import torch

    from seal_tpu_torch import CoeffModulus, cuda
    from seal_tpu_torch.ops import keyswitch

    moduli = [m.value for m in CoeffModulus.create(N, MODES[mode]["bits"])]
    CHECKED.add((kind, (BATCH, J, I, N), tuple(moduli)))
    q = torch.tensor(moduli, dtype=torch.int64).reshape(I, 1)
    t = random_residues((BATCH, J, I, N), moduli, rng)
    k = random_residues((J, 2, I, N), moduli, rng)
    t[..., 0] = k[..., 0] = q[:, 0] - 1
    consts, max_q = keyswitch.pack_mod_consts(moduli, "cpu"), max(moduli)
    shoup = kind == "keyswitch_inner_shoup"
    args = (t, k, keyswitch.key_quotients(k, moduli)) if shoup else (t, k)
    dev = [a.cuda() for a in args] + [consts.cuda()]
    extra = (max_q,) if shoup else ()
    kernel = getattr(keyswitch, f"{kind}_cuda")
    plain = getattr(keyswitch, f"{kind}_plain")
    before = cuda.launches[kind]
    got = kernel(*dev, *extra)
    torch.cuda.synchronize()
    require(cuda.launches[kind] == before + 1, f"{kind} batch: one launch")
    want = plain(*args, consts, *extra)
    require(torch.equal(got.cpu(), want), f"{kind} [{BATCH}, {J}, {I}, N] bit-exact")
    require(torch.equal(got[BATCH - 1], kernel(dev[0][BATCH - 1], *dev[1:], *extra)),
            f"{kind} batch member equals its unbatched call")
    run = lambda: kernel(*dev, *extra)      # noqa: E731
    per_member = keyswitch_muls(J, I, shoup)
    b_ms, b_by = bound(keyswitch_bytes(BATCH, J, I, shoup), BATCH * per_member)
    line = {"phase": "K3" if shoup else "K2", "kernel": kind, "shape": [BATCH, J, I, N],
            "mode": mode, "bit_exact": True, "max_abs_err": 0, "ms": cuda_ms(run),
            "device_ms": graph_ms(run),
            "plain_ms": host_ms(lambda: plain(*args, consts, *extra), reps=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_separate_calls": bound(BATCH * keyswitch_bytes(1, J, I, shoup),
                                             BATCH * per_member)[0]}
    emit(line)
    return line


def phase_keyswitch(rng):
    import torch

    from seal_tpu_torch import CoeffModulus
    from seal_tpu_torch.ops import keyswitch

    results = {}
    for mode, J, I in key_shapes():
        moduli = [m.value for m in CoeffModulus.create(N, MODES[mode]["bits"])]
        CHECKED.add(("keyswitch_inner", (J, I, N), tuple(moduli)))
        t = random_residues((J, I, N), moduli, rng)
        k = random_residues((J, 2, I, N), moduli, rng)
        consts = keyswitch.pack_mod_consts(moduli, "cpu")
        t_dev, k_dev, c_dev = t.cuda(), k.cuda(), consts.cuda()
        got = keyswitch.keyswitch_inner_cuda(t_dev, k_dev, c_dev).cpu()
        want = keyswitch.keyswitch_inner_plain(t, k, consts)
        require(torch.equal(got, want), f"keyswitch_inner (J, I) = {(J, I)} bit-exact")
        run = lambda: keyswitch.keyswitch_inner_cuda(t_dev, k_dev, c_dev)  # noqa: E731
        ms, device_ms = cuda_ms(run), graph_ms(run)
        plain_ms = host_ms(lambda: keyswitch.keyswitch_inner_plain(t, k, consts))
        b_ms, b_by = bound(keyswitch_bytes(1, J, I, False), keyswitch_muls(J, I, False))
        line = {"phase": "K2", "kernel": "keyswitch_inner", "shape": [J, I, N],
                "bit_exact": True, "max_abs_err": 0, "ms": ms, "device_ms": device_ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        emit(line)
        results[mode, J] = line
        results[mode, J, BATCH] = keyswitch_batch("keyswitch_inner", mode, J, I, rng)
    return {"keyswitch_inner": results["alpha1_parity", 8],
            "keyswitch_inner_batch": results["alpha1_parity", 8, BATCH]}


def phase_keyswitch_shoup(rng):
    import torch

    from seal_tpu_torch import CoeffModulus
    from seal_tpu_torch.ops import keyswitch

    results = {}
    for mode, J, I in key_shapes():
        moduli = [m.value for m in CoeffModulus.create(N, MODES[mode]["bits"])]
        CHECKED.add(("keyswitch_inner_shoup", (J, I, N), tuple(moduli)))
        q = torch.tensor(moduli, dtype=torch.int64).reshape(I, 1)
        t = random_residues((J, I, N), moduli, rng)
        k = random_residues((J, 2, I, N), moduli, rng)
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
        b_ms, b_by = bound(keyswitch_bytes(1, J, I, True), keyswitch_muls(J, I, True))
        line = {"phase": "K3", "kernel": "keyswitch_inner_shoup", "shape": [J, I, N],
                "bit_exact": True, "equals_k2": True, "max_abs_err": 0, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        emit(line)
        results[mode, J] = line
        results[mode, J, BATCH] = keyswitch_batch("keyswitch_inner_shoup", mode, J, I, rng)
    return {"keyswitch_inner_shoup": results["alpha1_parity", 8],
            "keyswitch_inner_shoup_batch": results["alpha1_parity", 8, BATCH]}


# ---------------------------------------------------------------------------
# phase 4: the pipeline
# ---------------------------------------------------------------------------

def sparse_plain(rng, count=4, bits=40):
    """{index: value}: `count` coefficients of magnitude about 2^bits."""
    idx = rng.permutation(N)[:count].tolist()
    mag = rng.integers(1 << (bits - 1), 1 << bits, count).tolist()
    sign = rng.integers(0, 2, count).tolist()
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


def contexts(spec, seed):
    """(the card's context, the CPU's) for one mode, with a random seed."""
    from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SEALContext

    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, spec["bits"]))
    parms.set_special_modulus_size(spec["alpha"])
    parms.set_random_seed(seed)
    return SEALContext(parms), SEALContext(parms, device="cpu")


PHASE_SECONDS: dict = {}


def clocked(name, fn, *args):
    """fn(*args), its host-clock seconds added to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
    return out


def counted(fn):
    """fn()'s result, synchronised, and the kernel launches it made: the
    counts are zeroed just before and read just after."""
    import torch

    from seal_tpu_torch import cuda

    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(cuda.launches)


PRNG = {"bytes": 0, "seconds": 0.0}


def meter_prng():
    """Count the bytes the port's byte streams hand out, and the host time
    they take (the vectorised XOF runs inside generate)."""
    from seal_tpu_torch import randomgen

    generate = randomgen.UniformRandomGenerator.generate

    def metered(self, byte_count):
        t0 = time.perf_counter()
        try:
            return generate(self, byte_count)
        finally:
            PRNG["seconds"] += time.perf_counter() - t0
            PRNG["bytes"] += byte_count

    randomgen.UniformRandomGenerator.generate = metered


def step(record, name, fn):
    """fn() on the card, synchronised. record[name] gets its host-clock ms,
    the kernel launches it made (counted from 0 just before, read just
    after) and the bytes it drew from the byte stream, with their rate."""
    import torch

    from seal_tpu_torch import cuda

    cuda.reset_launches()
    PRNG.update(bytes=0, seconds=0.0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    record[name] = {"ms": ms, "launches": dict(cuda.launches),
                    "prng_mb": PRNG["bytes"] / 1e6,
                    "prng_mb_per_s": (PRNG["bytes"] / 1e6 / PRNG["seconds"]
                                      if PRNG["bytes"] else None)}
    return out


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

    ctx, ctx_cpu = contexts(spec, seed_words(SEED))
    rng = np.random.default_rng(SEED)

    t0 = time.perf_counter()
    kg = KeyGenerator(ctx)
    sk = kg.secret_key()
    rk = kg.create_relin_keys()
    enc = Encryptor(ctx, sk)
    scale = 2.0 ** 40
    m1, m2 = sparse_plain(rng), sparse_plain(rng)
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

    ctx, ctx_cpu = contexts(spec, seed_words(SEED + 1))
    t0 = time.perf_counter()
    kg = KeyGenerator(ctx)
    sk = kg.secret_key()
    gk = kg.create_galois_keys(steps=ROT_KEY_STEPS + [0])
    m = sparse_plain(np.random.default_rng(SEED + 1))
    ct = Encryptor(ctx, sk).encrypt_symmetric(encode_sparse(ctx, m, 2.0 ** 40))
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


# ---------------------------------------------------------------------------
# phase 7: BFV and BGV
# ---------------------------------------------------------------------------

def exact_contexts(scheme):
    """(the card's context, the CPU's): bfv_default(N), a 20-bit batching t,
    a random seed."""
    from seal_tpu_torch import (
        CoeffModulus, EncryptionParameters, PlainModulus, SEALContext)

    parms = EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(N))
    parms.set_plain_modulus(PlainModulus.batching(N, EXACT_T_BITS))
    parms.set_random_seed(seed_words(SEED + int(scheme)))
    return SEALContext(parms), SEALContext(parms, device="cpu")


def exact_ops(ev, ct1, ct2, plain2, rk, gk):
    """[(op name, call)] in path order; each call returns its ciphertext."""
    out = {}

    def step(name, fn):
        return name, lambda: out.setdefault(name, fn())

    return [step("multiply", lambda: ev.multiply(ct1, ct2)),
            step("relinearize", lambda: ev.relinearize(out["multiply"], rk)),
            step("mod_switch_to_next", lambda: ev.mod_switch_to_next(out["relinearize"])),
            step("rotate_rows", lambda: ev.rotate_rows(out["mod_switch_to_next"], 1, gk)),
            step("rotate_columns", lambda: ev.rotate_columns(out["mod_switch_to_next"], gk)),
            step("square", lambda: ev.square(ct1)),
            step("multiply_plain", lambda: ev.multiply_plain(ct1, plain2))]


def run_exact_path(ctx, keys, m1, m2):
    """encode -> encrypt (m1 with the public key, m2 with the secret key) ->
    every op of exact_ops -> the noise budget of every ciphertext ->
    decrypt -> decode on the card, each step through `step`. Returns
    (ciphertexts, decoded slots, noise budgets, per-step record, inputs)."""
    from seal_tpu_torch import BatchEncoder, Decryptor, Encryptor, Evaluator

    sk, pk, rk, gk = keys
    be, enc, dec, ev = BatchEncoder(ctx), Encryptor(ctx, pk, sk), Decryptor(ctx, sk), \
        Evaluator(ctx)
    record = {}
    plains = step(record, "encode", lambda: [be.encode(m) for m in (m1, m2)])
    ct1 = step(record, "encrypt_public", lambda: enc.encrypt(plains[0]))
    ct2 = step(record, "encrypt_symmetric", lambda: enc.encrypt_symmetric(plains[1]))
    outs = {name: step(record, name, fn)
            for name, fn in exact_ops(ev, ct1, ct2, plains[1], rk, gk)}
    every = {"fresh_public": ct1, "fresh_symmetric": ct2, **outs}
    budgets = step(record, "noise_budget",
                   lambda: {k: dec.invariant_noise_budget(v) for k, v in every.items()})
    phases = step(record, "decrypt", lambda: {k: dec.decrypt(v) for k, v in outs.items()})
    slots = step(record, "decode",
                 lambda: {k: be.decode(p).cpu().numpy() for k, p in phases.items()})
    return outs, slots, budgets, record, (ct1, ct2, plains[1])


def phase_exact(scheme):
    import numpy as np
    import torch

    from seal_tpu_torch import Decryptor, Evaluator, KeyGenerator, interop
    from seal_tpu_torch.config import config
    from seal_tpu_torch.dtypes import u64_numpy

    name = scheme.name
    ctx, ctx_cpu = exact_contexts(scheme)
    t = ctx.key_context_data().parms.plain_modulus.value
    t0 = time.perf_counter()
    kg = KeyGenerator(ctx)
    sk, pk, rk = kg.secret_key(), kg.create_public_key(), kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1, 0])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + int(scheme))
    m1, m2 = (rng.integers(0, t, N, dtype=np.int64) for _ in range(2))

    outs, slots, budgets, record, (ct1, ct2, plain2) = run_exact_path(
        ctx, (sk, pk, rk, gk), m1, m2)
    config.keyswitch_shoup = True
    try:
        ev = Evaluator(ctx)
        shoup = {}
        launches_shoup = {}
        for op, fn in exact_ops(ev, ct1, ct2, plain2, rk, gk):
            shoup[op], launches_shoup[op] = counted(fn)
    finally:
        config.keyswitch_shoup = False
    for op, ct in outs.items():
        require(np.array_equal(ct.to_numpy(), shoup[op].to_numpy())
                and ct.correction_factor == shoup[op].correction_factor,
                f"{name} {op}: Shoup route bit-identical to the 128-bit route")

    # the same ops on CPU copies of the same inputs: the plain path
    def carry(ct):
        return interop.ciphertext_from_numpy(ctx_cpu, ct.to_numpy(), ct.parms_id, 1.0,
                                             False, ct.correction_factor)

    rk_cpu = interop.relin_keys_from_numpy(ctx_cpu, [u64_numpy(k) for k in rk.keys])
    gk_cpu = interop.galois_keys_from_numpy(
        ctx_cpu, [None if k is None else u64_numpy(k) for k in gk.keys])
    t0 = time.perf_counter()
    cpu = {op: fn() for op, fn in exact_ops(
        Evaluator(ctx_cpu), carry(ct1), carry(ct2),
        interop.plaintext_from_numpy(ctx_cpu, plain2.to_numpy()), rk_cpu, gk_cpu)}
    cpu_s = time.perf_counter() - t0
    for op, ct in outs.items():
        require(np.array_equal(ct.to_numpy(), cpu[op].to_numpy())
                and tuple(ct.parms_id) == tuple(cpu[op].parms_id)
                and ct.correction_factor == cpu[op].correction_factor,
                f"{name} {op}: card output bit-identical to the plain path")
    dec_cpu = Decryptor(ctx_cpu, interop.secret_key_from_numpy(ctx_cpu, sk.to_numpy()))
    every_cpu = {"fresh_public": carry(ct1), "fresh_symmetric": carry(ct2), **cpu}
    budgets_cpu = {k: dec_cpu.invariant_noise_budget(v) for k, v in every_cpu.items()}
    require(budgets == budgets_cpu, f"{name}: noise budgets on the card equal the CPU's")
    require(all(b > 0 for b in budgets.values()), f"{name}: every noise budget above 0")
    dec = Decryptor(ctx, sk)
    budget_ms = host_ms(lambda: dec.invariant_noise_budget(outs["multiply"]), reps=5)

    # every decode against the exact slotwise result mod t
    prod = m1 * m2 % t
    rows = prod.reshape(2, N // 2)
    exact = {"multiply": prod, "relinearize": prod, "mod_switch_to_next": prod,
             "rotate_rows": np.roll(rows, -1, axis=1).reshape(-1),
             "rotate_columns": rows[::-1].reshape(-1), "square": m1 * m1 % t,
             "multiply_plain": prod}
    for op, want in exact.items():
        require(np.array_equal(slots[op], want), f"{name} {op}: decode equals the exact slots")
    L = ctx.first_context_data().coeff_modulus_size
    require(outs["rotate_rows"].size == 2 and outs["rotate_rows"].coeff_modulus_size == L - 1,
            f"{name}: output shape")

    ev = Evaluator(ctx)
    calls = {"multiply": lambda: ev.multiply(ct1, ct2),
             "relinearize": lambda: ev.relinearize(outs["multiply"], rk),
             "mod_switch_to_next": lambda: ev.mod_switch_to_next(outs["relinearize"]),
             "rotate_rows": lambda: ev.rotate_rows(outs["mod_switch_to_next"], 1, gk)}
    ms = {op: host_ms(lambda call=call: (call(), torch.cuda.synchronize()), reps=10)
          for op, call in calls.items()}
    line = {"phase": "exact", "scheme": name, "n": N, "data_primes": L, "special_primes": 1,
            "t": t, "bsk_primes": len(ctx.first_context_data().rns_tool_host.base_Bsk.base),
            "bit_exact_vs_plain": True, "shoup_bit_identical": True,
            "decode_exact": True, "noise_budgets": budgets, "noise_budgets_card_eq_cpu": True,
            "noise_budget_ms": budget_ms, "steps": record, "launches_shoup": launches_shoup,
            "ms_per_op": ms, "setup_s": setup_s, "plain_cpu_s": cpu_s}
    emit(line)
    total = {}
    for counts in [r["launches"] for r in record.values()] + list(launches_shoup.values()):
        add_counts(total, counts)
    for kernel in ("ntt_forward", "ntt_inverse", "keyswitch_inner", "keyswitch_inner_shoup"):
        require(total[kernel] > 0, f"{name}: {kernel} launched on its path")
    return total


# ---------------------------------------------------------------------------
# phase 8: the CKKS round trip from a random seed
# ---------------------------------------------------------------------------

ROUND_TRIP_SCALE = 2.0 ** 40
DECODE_BOUND = 1e-4             # |decoded - v1·v2| allowed
PRNG_RATE_BYTES = 16 << 20


def unit_disc(rng, count):
    """`count` complex values drawn uniformly from the unit disc."""
    import numpy as np

    return np.sqrt(rng.uniform(0, 1, count)) * np.exp(2j * np.pi * rng.uniform(0, 1, count))


def ckks_round_trip(ctx, values, fused, run):
    """keygen (sk, pk, rk) -> encode both vectors -> encrypt the first with
    the public key, the second with the secret key -> multiply ->
    relinearize -> rescale (the fused tail at α > 1) -> decrypt -> decode
    on ctx, each step through run(name, fn). Returns {name: output} and the
    objects that the timings reuse."""
    from seal_tpu_torch import CKKSEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator

    kg = run("keygen_secret", lambda: KeyGenerator(ctx))
    pk = run("keygen_public", kg.create_public_key)
    rk = run("keygen_relin", kg.create_relin_keys)
    encoder = CKKSEncoder(ctx)
    p1 = run("encode", lambda: encoder.encode(values[0], ROUND_TRIP_SCALE))
    p2 = run("encode_second", lambda: encoder.encode(values[1], ROUND_TRIP_SCALE))
    enc = Encryptor(ctx, pk, kg.secret_key())
    c1 = run("encrypt_public", lambda: enc.encrypt(p1))
    c2 = run("encrypt_symmetric", lambda: enc.encrypt_symmetric(p2))
    ev = Evaluator(ctx)
    out = run("mult_relin_rescale", lambda: run_mode(ev, fused, c1, c2, rk))
    dec = Decryptor(ctx, kg.secret_key())
    plain = run("decrypt", lambda: dec.decrypt(out))
    decoded = run("decode", lambda: encoder.decode(plain, complex_out=True))
    outputs = {"secret_key": kg.secret_key().to_numpy(), "public_key": pk.to_numpy(),
               "relin_key": [k.cpu().numpy() for k in rk.keys],
               "plain_1": p1.to_numpy(), "plain_2": p2.to_numpy(),
               "ct_public": c1.to_numpy(), "ct_symmetric": c2.to_numpy(),
               "result": out.to_numpy(), "decrypted": plain.to_numpy(),
               "decoded": decoded.cpu().numpy()}
    return outputs, dict(encoder=encoder, enc=enc, dec=dec, p1=p1, out=out)


def phase_round_trip(mode, spec):
    """The CKKS main path a user runs, from parms.set_random_seed alone, on
    the card and on the CPU: every output bit for bit equal, and the
    decoded product within DECODE_BOUND of numpy's exact product."""
    import numpy as np
    import torch

    ctx, ctx_cpu = contexts(spec, seed_words(SEED + 2))
    rng = np.random.default_rng(SEED + 2)
    values = [unit_disc(rng, N // 2) for _ in range(2)]
    record = {}
    card, objs = ckks_round_trip(ctx, values, spec["fused"],
                                 lambda name, fn: step(record, name, fn))
    t0 = time.perf_counter()
    cpu, _ = ckks_round_trip(ctx_cpu, values, spec["fused"], lambda name, fn: fn())
    cpu_s = time.perf_counter() - t0
    for name, got in card.items():
        want = cpu[name]
        same = (all(np.array_equal(a, b) for a, b in zip(got, want)) if isinstance(got, list)
                else np.array_equal(got.view(np.uint64), want.view(np.uint64)))
        require(same, f"round trip {mode} {name}: card bit-identical to the CPU path")
    err = float(np.abs(card["decoded"] - values[0] * values[1]).max())
    require(err <= DECODE_BOUND, f"round trip {mode}: decoded error {err} within {DECODE_BOUND}")

    encoder, enc, dec = objs["encoder"], objs["enc"], objs["dec"]
    sync = torch.cuda.synchronize
    medians = {
        "encode": host_ms(lambda: (encoder.encode(values[0], ROUND_TRIP_SCALE), sync()), 5),
        "encrypt_public": host_ms(lambda: (enc.encrypt(objs["p1"]), sync()), 5),
        "decrypt_decode": host_ms(lambda: (encoder.decode(dec.decrypt(objs["out"])), sync()),
                                  5)}
    profiles = {"encode": device_profile(lambda: encoder.encode(values[0], ROUND_TRIP_SCALE)),
                "encrypt_public": device_profile(lambda: enc.encrypt(objs["p1"])),
                "decrypt_decode": device_profile(
                    lambda: encoder.decode(dec.decrypt(objs["out"])))}
    emit({"phase": "round_trip", "mode": mode, "n": N, "slots": N // 2,
          "scale_log2": 40, "bit_exact_vs_plain": True, "max_decode_err": err,
          "decode_bound": DECODE_BOUND, "steps": record, "ms_median": medians,
          "profile": profiles, "plain_cpu_s": cpu_s})
    total = {}
    for r in record.values():
        add_counts(total, r["launches"])
    for kernel in ("ntt_forward", "ntt_inverse", "keyswitch_inner"):
        require(total[kernel] > 0, f"round trip {mode}: {kernel} launched on its path")
    return total


# ---------------------------------------------------------------------------
# phases 9 and 10: the batched main path
# ---------------------------------------------------------------------------

BATCH_SIZES = (1, 4, BATCH)     # B = 1 is one unbatched ciphertext
EXACT_BATCH = 4


def shoup_both(fn):
    """(fn() with the Shoup flag off, its launches, fn() with it on, its
    launches): each route on the card, counted from 0."""
    from seal_tpu_torch.config import config

    out, launches = counted(fn)
    config.keyswitch_shoup = True
    try:
        out_shoup, launches_shoup = counted(fn)
    finally:
        config.keyswitch_shoup = False
    return out, launches, out_shoup, launches_shoup


def batch_timings(run, single, batch):
    """Per B of BATCH_SIZES, flag off and on: the launches of one call of
    run(x) (which must equal one ciphertext's), the host-clock ms per batch
    and per ciphertext (median of 5, synchronised), and the device-busy
    share of one call under torch.profiler, whose kernels counted by name
    must equal the launches counted. x is `single` for B = 1, else the
    first B members of `batch`."""
    import torch

    from seal_tpu_torch.config import config

    out = {}
    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        try:
            base = None
            for B in BATCH_SIZES:
                x = single if B == 1 else batch(B)
                _, launches = counted(lambda: run(x))
                if base is None:
                    base = launches
                require(launches == base, f"B={B}: launches per batch equal one ciphertext's")
                ms = host_ms(lambda: (run(x), torch.cuda.synchronize()), reps=5)
                prof = device_profile(lambda: run(x))
                require(prof["kernels"] == launches, f"B={B}: the kernels traced by name "
                                                     f"{prof['kernels']} equal the counted "
                                                     f"launches {launches}")
                out[f"B{B}_{'shoup' if shoup else 'k2'}"] = {
                    "launches": launches, "ms_per_batch": ms, "ms_per_ciphertext": ms / B,
                    "device_busy_share": (prof["device_busy_ms"] / prof["device_span_ms"]
                                          if prof.get("device_span_ms") else None),
                    "profile": prof}
        finally:
            config.keyswitch_shoup = False
    return out


def phase_batch(mode, spec):
    """bench.py's batched pipeline at B = 16 through the *_many APIs, on the
    card against each member's sequential card calls and against the plain
    path on CPU copies; then the times and launches per B."""
    import numpy as np
    import torch

    from seal_tpu_torch import (
        CKKSEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator, Plaintext, interop)
    from seal_tpu_torch.dtypes import stack_ciphertexts, u64_numpy

    ctx, ctx_cpu = contexts(spec, seed_words(SEED + 3))
    rng = np.random.default_rng(SEED + 3)
    xs, ys = (unit_disc(rng, BATCH * (N // 2)).reshape(BATCH, N // 2) for _ in range(2))
    t0 = time.perf_counter()
    kg = KeyGenerator(ctx)
    sk, rk = kg.secret_key(), kg.create_relin_keys()
    enc = Encryptor(ctx, kg.create_public_key(), sk)
    encoder, dec, ev = CKKSEncoder(ctx), Decryptor(ctx, sk), Evaluator(ctx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fused = spec["fused"]
    record = {}
    px = step(record, "encode_many", lambda: encoder.encode_many(xs, ROUND_TRIP_SCALE))
    py = step(record, "encode_many_second", lambda: encoder.encode_many(ys, ROUND_TRIP_SCALE))
    cx = step(record, "encrypt_many", lambda: enc.encrypt_many(px))
    cy = step(record, "encrypt_symmetric_many", lambda: enc.encrypt_symmetric_many(py))
    X, Y = stack_ciphertexts(cx), stack_ciphertexts(cy)
    out = step(record, "mult_relin_rescale", lambda: run_mode(ev, fused, X, Y, rk))
    plains = step(record, "decrypt_many", lambda: dec.decrypt_many(out.unbind()))
    decoded = step(record, "decode_many",
                   lambda: encoder.decode_many(plains, complex_out=True))
    _, launches, out_shoup, launches_shoup = shoup_both(lambda: run_mode(ev, fused, X, Y, rk))
    require(torch.equal(out_shoup.data, out.data), f"batch {mode}: Shoup route bit-identical")
    require(launches["keyswitch_inner"] > 0 and launches_shoup["keyswitch_inner_shoup"] > 0,
            f"batch {mode}: each key-switch route launched its kernel")
    err = float(np.abs(decoded.cpu().numpy() - xs * ys).max())
    require(err <= DECODE_BOUND, f"batch {mode}: decoded error {err} within {DECODE_BOUND}")

    # every member against its own sequential calls on the card
    for b in range(BATCH):
        require(torch.equal(px[b].data, encoder.encode(xs[b], ROUND_TRIP_SCALE).data)
                and torch.equal(cx[b].data, enc.encrypt(px[b]).data)
                and torch.equal(cy[b].data, enc.encrypt_symmetric(py[b]).data),
                f"batch {mode} member {b}: encode and encrypt equal the sequential calls")
        one = run_mode(ev, fused, cx[b], cy[b], rk)
        require(torch.equal(out.data[b], one.data) and tuple(one.parms_id) == tuple(out.parms_id)
                and one.scale == out.scale,
                f"batch {mode} member {b}: the batched op equals the sequential call")
        plain = dec.decrypt(one)
        require(torch.equal(plains[b].data, plain.data)
                and torch.equal(decoded[b], encoder.decode(plain, complex_out=True)),
                f"batch {mode} member {b}: decrypt and decode equal the sequential calls")

    # the whole batch on CPU copies: the plain path
    t0 = time.perf_counter()
    enc_cpu = CKKSEncoder(ctx_cpu)
    rk_cpu = interop.relin_keys_from_numpy(ctx_cpu, [u64_numpy(k) for k in rk.keys])
    carried = [interop.ciphertext_from_numpy(ctx_cpu, c.to_numpy(), c.parms_id, c.scale)
               for c in (X, Y)]
    out_cpu = run_mode(Evaluator(ctx_cpu), fused, *carried, rk_cpu)
    px_cpu = enc_cpu.encode_many(xs, ROUND_TRIP_SCALE)
    plains_cpu = [Plaintext(interop.u64_to_tensor(p.to_numpy(), ctx_cpu), p.parms_id, p.scale)
                  for p in plains]
    decoded_cpu = enc_cpu.decode_many(plains_cpu, complex_out=True)
    cpu_s = time.perf_counter() - t0
    require(np.array_equal(out.to_numpy(), out_cpu.to_numpy()),
            f"batch {mode}: card bit-identical to the plain path")
    require(all(np.array_equal(a.to_numpy(), b.to_numpy()) for a, b in zip(px, px_cpu)),
            f"batch {mode}: encode_many on the card bit-identical to the plain path")
    require(np.array_equal(decoded.cpu().numpy().view(np.uint64),
                           decoded_cpu.numpy().view(np.uint64)),
            f"batch {mode}: decode_many on the card bit-identical to the plain path")

    timings = batch_timings(lambda x: run_mode(ev, fused, x[0], x[1], rk), (cx[0], cy[0]),
                            lambda B: (stack_ciphertexts(cx[:B]), stack_ciphertexts(cy[:B])))
    emit({"phase": "batch", "mode": mode, "n": N, "batch": BATCH, "data_primes": 8,
          "special_primes": spec["alpha"], "bit_exact_vs_sequential": True,
          "bit_exact_vs_plain": True, "shoup_bit_identical": True, "max_decode_err": err,
          "decode_bound": DECODE_BOUND, "steps": record, "launches": launches,
          "launches_shoup": launches_shoup, "per_batch_size": timings, "setup_s": setup_s,
          "plain_cpu_s": cpu_s})
    total = {}
    for counts in [r["launches"] for r in record.values()] + [launches, launches_shoup]:
        add_counts(total, counts)
    return total


def phase_exact_batch(scheme):
    """BFV or BGV multiply -> relinearize -> mod_switch_to_next on a stacked
    batch of EXACT_BATCH, flag off and on, each member against its
    sequential card call; decrypt_many -> decode_many exact."""
    import numpy as np
    import torch

    from seal_tpu_torch import BatchEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator
    from seal_tpu_torch.dtypes import stack_ciphertexts

    name = scheme.name
    ctx, _ = exact_contexts(scheme)
    t = ctx.key_context_data().parms.plain_modulus.value
    kg = KeyGenerator(ctx)
    sk, rk = kg.secret_key(), kg.create_relin_keys()
    enc, be, ev = Encryptor(ctx, kg.create_public_key(), sk), BatchEncoder(ctx), Evaluator(ctx)
    rng = np.random.default_rng(SEED + 10 + int(scheme))
    m1, m2 = (rng.integers(0, t, (EXACT_BATCH, N), dtype=np.int64) for _ in range(2))
    record = {}
    p1 = step(record, "encode_many", lambda: be.encode_many(m1))
    p2 = step(record, "encode_many_second", lambda: be.encode_many(m2))
    c1 = step(record, "encrypt_many", lambda: enc.encrypt_many(p1))
    c2 = step(record, "encrypt_symmetric_many", lambda: enc.encrypt_symmetric_many(p2))

    def path(a, b):
        return ev.mod_switch_to_next(ev.relinearize(ev.multiply(a, b), rk))

    X, Y = stack_ciphertexts(c1), stack_ciphertexts(c2)
    out, launches, out_shoup, launches_shoup = shoup_both(lambda: path(X, Y))
    require(torch.equal(out.data, out_shoup.data)
            and out.correction_factor == out_shoup.correction_factor,
            f"{name} batch: Shoup route bit-identical")
    for b in range(EXACT_BATCH):
        one, single = counted(lambda: path(c1[b], c2[b]))
        require(single == launches, f"{name} batch: launches per batch equal one ciphertext's")
        require(torch.equal(out.data[b], one.data)
                and out.correction_factor == one.correction_factor,
                f"{name} batch member {b}: the batched op equals the sequential call")
    dec = Decryptor(ctx, sk)
    plains = step(record, "decrypt_many", lambda: dec.decrypt_many(out.unbind()))
    slots = step(record, "decode_many", lambda: be.decode_many(plains).cpu().numpy())
    require(np.array_equal(slots, m1 * m2 % t), f"{name} batch: decode equals the exact slots")
    ms_batch = host_ms(lambda: (path(X, Y), torch.cuda.synchronize()), reps=5)
    ms_one = host_ms(lambda: (path(c1[0], c2[0]), torch.cuda.synchronize()), reps=5)
    emit({"phase": "exact_batch", "scheme": name, "n": N, "batch": EXACT_BATCH,
          "bit_exact_vs_sequential": True, "shoup_bit_identical": True, "decode_exact": True,
          "launches": launches, "launches_shoup": launches_shoup, "steps": record,
          "ms_per_batch": ms_batch, "ms_per_ciphertext": ms_batch / EXACT_BATCH,
          "ms_one_ciphertext": ms_one})
    total = {}
    for counts in [r["launches"] for r in record.values()] + [launches, launches_shoup]:
        add_counts(total, counts)
    return total


# ---------------------------------------------------------------------------
# phases 11 and 12: the threshold (multiparty) layer and the wire format
# ---------------------------------------------------------------------------

PARTIES = 3
SMUDGING_BITS = 20
SMUDGED_DECODE_BOUND = 1e-3     # |decoded - rotated slots| allowed after smudging
# bfv: phase 7's parameters (bfv_default(N), a 20-bit batching t, α = 1);
# ckks_alpha1: bench.py's --parity bits [48]*8 + [54], scale 2^40
THRESHOLD = {"bfv": dict(scheme="BFV"),
             "ckks_alpha1": dict(scheme="CKKS", **MODES["alpha1_parity"])}


def party_contexts(config, device=None):
    """One context per party, each seeded (10 + i, 2, 3, ..., 8) as in the
    fork's vectors (tests/vectors/multiparty_bfv_n64.json)."""
    from seal_tpu_torch import (
        CoeffModulus, EncryptionParameters, PlainModulus, SchemeType, SEALContext)

    spec = THRESHOLD[config]
    out = []
    for i in range(PARTIES):
        parms = EncryptionParameters(SchemeType[spec["scheme"]])
        parms.set_poly_modulus_degree(N)
        if spec["scheme"] == "CKKS":
            parms.set_coeff_modulus(CoeffModulus.create(N, spec["bits"]))
            parms.set_special_modulus_size(spec["alpha"])
        else:
            parms.set_coeff_modulus(CoeffModulus.bfv_default(N))
            parms.set_plain_modulus(PlainModulus.batching(N, EXACT_T_BITS))
        parms.set_random_seed((10 + i, 2, 3, 4, 5, 6, 7, 8))
        out.append(SEALContext(parms) if device is None else SEALContext(parms, device=device))
    return out


def threshold_flow(ctxs, values, run):
    """The fork's threshold flow on the parties' contexts, each step through
    run(name, fn): party secret keys -> public keys sharing party 0's c1 ->
    Galois key shares under party 0's key-switching c1s (BFV: rows step 1
    and the columns element; CKKS: rotate step 1) -> the common public key,
    the common secret key (to check against) and the aggregated Galois keys
    -> encode, encrypt under the common public key -> one rotation, Shoup
    flag off (K2) and on (K3) -> each party's unsmudged partial decryption
    -> the aggregate -> decode. Returns the objects by name."""
    from seal_tpu_torch import (
        BatchEncoder, CKKSEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator)
    from seal_tpu_torch.config import config

    ckks = ctxs[0].key_context_data().parms.scheme.name == "CKKS"
    o = {}

    def secret_keys():
        kgs = [KeyGenerator(c) for c in ctxs]
        return kgs, [kg.generate_secret_key() for kg in kgs]

    kgs, sks = o["kgs"], o["sks"] = run("keygen_secret", secret_keys)

    def public_keys():
        pk0 = kgs[0].create_public_key_with_sk(sks[0])
        return [pk0] + [kgs[i].create_public_key_with_same_c1(sks[i], pk0)
                        for i in range(1, PARTIES)]

    o["pks"] = run("keygen_public", public_keys)
    gt = ctxs[0].key_context_data().galois_tool
    o["elts"] = elts = [gt.get_elt_from_step(1)] + ([] if ckks else [2 * N - 1])

    def galois_shares():
        gk0 = kgs[0].create_galois_keys(elts, secret_key=sks[0])
        refs = [gk0.key(e)[:, 1] for e in elts]
        return [gk0] + [kgs[i].create_galois_keys(elts, secret_key=sks[i],
                                                  c1_refs_per_elt=refs)
                        for i in range(1, PARTIES)]

    o["gks"] = run("keygen_galois_shares", galois_shares)
    o["cpk"], o["csk"], o["common_gk"] = run("common_keys", lambda: (
        kgs[0].create_common_public_key(o["pks"]), kgs[0].create_common_secret_key(sks),
        kgs[0].aggregate_galois_keys(elts, o["gks"])))
    encoder = CKKSEncoder(ctxs[0]) if ckks else BatchEncoder(ctxs[0])
    o["plain"] = run("encode", lambda: encoder.encode(values, ROUND_TRIP_SCALE) if ckks
                     else encoder.encode(values))
    o["ct"] = run("encrypt_common", lambda: Encryptor(ctxs[0], o["cpk"]).encrypt(o["plain"]))
    ev = Evaluator(ctxs[0])

    def rotate():
        return (ev.rotate_vector(o["ct"], 1, o["common_gk"]) if ckks
                else ev.rotate_rows(o["ct"], 1, o["common_gk"]))

    o["rot"] = run("rotate", rotate)
    config.keyswitch_shoup = True
    try:
        o["rot_shoup"] = run("rotate_shoup", rotate)
    finally:
        config.keyswitch_shoup = False
    o["decs"] = [Decryptor(c, sk) for c, sk in zip(ctxs, sks)]
    o["partials"] = run("partial_decrypt",
                        lambda: [d.distributed_decrypt(o["rot"]) for d in o["decs"]])
    o["aggregate"] = run("aggregate", lambda: o["decs"][0].aggregate_partial_decryption(
        o["rot"], o["partials"]))
    o["decoded"] = run("decode", lambda: encoder.decode(o["aggregate"], complex_out=True)
                       if ckks else encoder.decode(o["aggregate"]))
    return o


def threshold_arrays(o):
    """Every key, share, ciphertext, partial, aggregate and decoded slot of
    a flow as uint64 numpy arrays, by name."""
    import numpy as np

    from seal_tpu_torch.dtypes import u64_numpy

    out = {"cpk": o["cpk"].to_numpy(), "csk": o["csk"].to_numpy(),
           "plain": o["plain"].to_numpy(), "ct": o["ct"].to_numpy(),
           "rot": o["rot"].to_numpy(), "rot_shoup": o["rot_shoup"].to_numpy(),
           "aggregate": o["aggregate"].to_numpy(),
           "decoded": np.ascontiguousarray(o["decoded"].cpu().numpy()).view(np.uint64)}
    for i in range(PARTIES):
        out[f"sk{i}"], out[f"pk{i}"] = o["sks"][i].to_numpy(), o["pks"][i].to_numpy()
        out[f"partial{i}"] = o["partials"][i].to_numpy()
        for e in o["elts"]:
            out[f"gk{i}_elt{e}"] = u64_numpy(o["gks"][i].key(e))
    for e in o["elts"]:
        out[f"common_gk_elt{e}"] = u64_numpy(o["common_gk"].key(e))
    return out


def smudge_offsets(o, smudged):
    """Per party: (every row of smudged - unsmudged, centred, is the same
    integer vector; its largest magnitude). For an NTT-form ciphertext the
    difference is taken back through the inverse NTT."""
    import torch

    from seal_tpu_torch.ops import ntt

    rot = o["rot"]
    cd = o["decs"][0].context.get_context_data(rot.parms_id)
    q = cd.mod_consts.q
    out = []
    for part, clean in zip(smudged, o["partials"]):
        diff = torch.remainder(part.poly(0) - clean.poly(0), q)
        if rot.is_ntt_form:
            diff = ntt.ntt_inverse(diff, cd.ntt_tables)
        centred = torch.where(diff > q // 2, diff - q, diff)
        out.append((bool((centred == centred[0]).all()), int(centred.abs().max())))
    return out


def phase_threshold(config):
    """The threshold flow at full width on the card, against the same flow on
    CPU copies of the parties' contexts (the plain path), bit for bit; the
    aggregate against the common secret key's decryption; the decode against
    the rotated slots. Then the partials again with SMUDGING_BITS of noise."""
    import numpy as np
    import torch

    from seal_tpu_torch import BatchEncoder, CKKSEncoder, Decryptor

    start = time.perf_counter()
    ckks = THRESHOLD[config]["scheme"] == "CKKS"
    ctxs, ctxs_cpu = party_contexts(config), party_contexts(config, device="cpu")
    rng = np.random.default_rng(SEED + 20)
    if ckks:
        values = unit_disc(rng, N // 2)
        want = np.roll(values, -1)
    else:
        t = ctxs[0].key_context_data().parms.plain_modulus.value
        values = rng.integers(0, t, N, dtype=np.int64)
        want = np.roll(values.reshape(2, N // 2), -1, axis=1).reshape(-1)
    record = {}
    o = threshold_flow(ctxs, values, lambda name, fn: step(record, name, fn))
    t0 = time.perf_counter()
    o_cpu = threshold_flow(ctxs_cpu, values, lambda name, fn: fn())
    cpu_s = time.perf_counter() - t0
    card, cpu = threshold_arrays(o), threshold_arrays(o_cpu)
    for name, got in card.items():
        require(np.array_equal(got, cpu[name]),
                f"threshold {config} {name}: card bit-identical to the CPU path")
    require(np.array_equal(card["rot"], card["rot_shoup"]),
            f"threshold {config}: Shoup route bit-identical to the 128-bit route")
    shared_c1 = all(torch.equal(pk.data.poly(1), o["pks"][0].data.poly(1)) for pk in o["pks"])
    require(shared_c1, f"threshold {config}: the parties' public keys share c1")
    direct = Decryptor(ctxs[0], o["csk"]).decrypt(o["rot"])
    require(torch.equal(direct.data, o["aggregate"].data),
            f"threshold {config}: the aggregate equals the common secret key's decryption")
    decoded = o["decoded"].cpu().numpy()
    if ckks:
        err = float(np.abs(decoded - want).max())
        require(err <= DECODE_BOUND, f"threshold {config}: decoded error {err} within "
                                     f"{DECODE_BOUND}")
    else:
        err = 0.0
        require(np.array_equal(decoded, want), f"threshold {config}: decode equals the "
                                               "rotated slots")

    # again with smudging noise on every partial (card only: the noise is fresh)
    smudged = step(record, "partial_decrypt_smudged", lambda: [
        d.distributed_decrypt(o["rot"], SMUDGING_BITS) for d in o["decs"]])
    aggregate = step(record, "aggregate_smudged",
                     lambda: o["decs"][0].aggregate_partial_decryption(o["rot"], smudged))
    offsets = smudge_offsets(o, smudged)
    for i, (same_rows, largest) in enumerate(offsets):
        require(same_rows and largest <= 1 << SMUDGING_BITS,
                f"threshold {config} party {i}: the smudging noise is one centred value in "
                f"[-2^{SMUDGING_BITS}, 2^{SMUDGING_BITS}] on every row ({largest})")
    if ckks:
        got = CKKSEncoder(ctxs[0]).decode(aggregate, complex_out=True).cpu().numpy()
        err_smudged = float(np.abs(got - want).max())
        require(err_smudged <= SMUDGED_DECODE_BOUND,
                f"threshold {config}: smudged decoded error {err_smudged} within "
                f"{SMUDGED_DECODE_BOUND}")
    else:
        err_smudged = 0.0
        require(np.array_equal(BatchEncoder(ctxs[0]).decode(aggregate).cpu().numpy(), want),
                f"threshold {config}: smudged decode equals the rotated slots")
    total = {}
    for r in record.values():
        add_counts(total, r["launches"])
    for kernel in ("ntt_forward", "ntt_inverse", "keyswitch_inner", "keyswitch_inner_shoup"):
        require(total.get(kernel, 0) > 0, f"threshold {config}: {kernel} launched on its path")
    emit({"phase": "threshold", "config": config, "n": N, "parties": PARTIES,
          "galois_elts": o["elts"], "bit_exact_vs_plain": True, "shoup_bit_identical": True,
          "aggregate_equals_common_key_decrypt": True, "max_decode_err": err,
          "decode_bound": DECODE_BOUND if ckks else 0, "smudging_bits": SMUDGING_BITS,
          "smudge_max_abs": [largest for _, largest in offsets],
          "max_decode_err_smudged": err_smudged,
          "decode_bound_smudged": SMUDGED_DECODE_BOUND if ckks else 0,
          "steps": record, "plain_cpu_s": cpu_s, "phase_s": time.perf_counter() - start})
    return total, o, o_cpu


def spoiled(obj, ctx):
    """A copy of a ciphertext, public key or key set with its first residue
    set to q_0 (out of range)."""
    import copy

    from seal_tpu_torch import Ciphertext, PublicKey

    q0 = ctx.key_context_data().key_moduli()[0]
    out = copy.copy(obj)
    if isinstance(obj, Ciphertext):
        out.data = obj.data.clone()
        out.data.view(-1)[0] = q0
    elif isinstance(obj, PublicKey):
        out.data = spoiled(obj.data, ctx)
    else:
        out.keys = list(obj.keys)
        i = next(i for i, k in enumerate(obj.keys) if k is not None)
        out.keys[i] = obj.keys[i].clone()
        out.keys[i].view(-1)[0] = q0
    return out


def same_object(a, b):
    """The same residues, metadata and seeds."""
    import torch

    from seal_tpu_torch import Ciphertext, PublicKey

    if isinstance(a, PublicKey):
        return same_object(a.data, b.data)
    if isinstance(a, Ciphertext):
        return (torch.equal(a.data, b.data) and tuple(a.parms_id) == tuple(b.parms_id)
                and (a.is_ntt_form, a.scale, a.correction_factor, a.seed_info)
                == (b.is_ntt_form, b.scale, b.correction_factor, b.seed_info))
    return (tuple(a.parms_id) == tuple(b.parms_id) and len(a.keys) == len(b.keys)
            and all((x is None and y is None) or (x is not None and y is not None
                                                   and torch.equal(x, y))
                    for x, y in zip(a.keys, b.keys)) and a.seeds == b.seeds)


def wire(record, name, obj, obj_cpu, ctx, mode):
    """obj through save -> bytes -> load onto ctx's device: the bytes equal
    those of its CPU copy, the loaded object equals obj, and valcheck holds
    it valid and a copy with one residue set to q invalid. record[name]
    gets the bytes and the ms and MB/s of the save and of the load."""
    import torch

    from seal_tpu_torch import Ciphertext, PublicKey, serialization, valcheck

    load = (serialization.load_ciphertext if isinstance(obj, Ciphertext)
            else serialization.load_public_key if isinstance(obj, PublicKey)
            else serialization.load_relin_keys if type(obj).__name__ == "RelinKeys"
            else serialization.load_galois_keys)
    t0 = time.perf_counter()
    blob = obj.save(mode)
    save_s = time.perf_counter() - t0
    require(blob == obj_cpu.save(mode), f"wire {name}: card bytes equal the CPU copy's")
    t0 = time.perf_counter()
    loaded = load(ctx, blob)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(same_object(loaded, obj), f"wire {name}: the loaded object equals the original")
    require(valcheck.is_valid_for(loaded, ctx), f"wire {name}: valcheck holds it valid")
    require(not valcheck.is_valid_for(spoiled(loaded, ctx), ctx),
            f"wire {name}: valcheck refuses a residue set to q")
    record[name] = {"bytes": len(blob), "mode": mode.name, "save_ms": save_s * 1e3,
                    "load_ms": load_s * 1e3, "save_mb_per_s": len(blob) / 1e6 / save_s,
                    "load_mb_per_s": len(blob) / 1e6 / load_s}
    return loaded


def phase_wire(config, o, o_cpu):
    """The threshold phase's objects across the wire (ZLIB; zstd where
    `zstandard` imports would be the same calls): each partial before
    aggregation, each party's Galois share and the common public key; for
    the CKKS configuration also a save_seed relinearization key and a
    seeded symmetric ciphertext of phase 8's α=1 keys, each about half its
    unseeded twin."""
    import torch

    from seal_tpu_torch import ComprMode, Encryptor, KeyGenerator

    start = time.perf_counter()
    mode = ComprMode.ZLIB
    ctx = o["decs"][0].context
    record = {}
    loaded = [wire(record, f"partial{i}", o["partials"][i], o_cpu["partials"][i], ctx, mode)
              for i in range(PARTIES)]
    aggregate = o["decs"][0].aggregate_partial_decryption(o["rot"], loaded)
    require(torch.equal(aggregate.data, o["aggregate"].data),
            f"wire {config}: the partials after the wire aggregate to the same plaintext")
    for i in range(PARTIES):
        wire(record, f"galois_share{i}", o["gks"][i], o_cpu["gks"][i], ctx, mode)
    wire(record, "common_public_key", o["cpk"], o_cpu["cpk"], ctx, mode)
    ratios = {}
    if THRESHOLD[config]["scheme"] == "CKKS":
        spec = MODES["alpha1_parity"]
        pair = contexts(spec, seed_words(SEED + 2))
        kgs = [KeyGenerator(c) for c in pair]
        rks = [kg.create_relin_keys(save_seed=True) for kg in kgs]
        wire(record, "relin_key_seeded", rks[0], rks[1], pair[0], mode)
        wire(record, "relin_key", kgs[0].create_relin_keys(), kgs[1].create_relin_keys(),
             pair[0], mode)
        encs = [Encryptor(c, kg.create_public_key(), kg.secret_key())
                for c, kg in zip(pair, kgs)]
        plains = [o["plain"], o_cpu["plain"]]      # at the same 8-prime level
        cts = [e.encrypt_symmetric(p, save_seed=True) for e, p in zip(encs, plains)]
        wire(record, "symmetric_ct_seeded", cts[0], cts[1], pair[0], mode)
        wire(record, "symmetric_ct", encs[0].encrypt_symmetric(plains[0]),
             encs[1].encrypt_symmetric(plains[1]), pair[0], mode)
        for what in ("relin_key", "symmetric_ct"):
            ratios[what] = record[f"{what}_seeded"]["bytes"] / record[what]["bytes"]
            require(0.45 <= ratios[what] <= 0.55,
                    f"wire: a seeded {what} is about half its unseeded twin ({ratios[what]})")
    emit({"phase": "wire", "config": config, "n": N, "bytes_card_eq_cpu": True,
          "loaded_equal": True, "valcheck": True, "seeded_ratio": ratios, "objects": record,
          "phase_s": time.perf_counter() - start})


# ---------------------------------------------------------------------------
# phases 13 and 14: the ops replayed from CUDA graphs (jit.py) and the
# ported examples
# ---------------------------------------------------------------------------

GRAPH_BATCHES = (1, BATCH)      # B = 1 is one unbatched ciphertext
GRAPH_REPS = 20
GRAPH_SEED = SEED + 5


def random_ciphertext(ctx, batch, rng, ntt):
    """A size-2 ciphertext at the first level with random residues: the
    ops compute the same whatever it encrypts. [2, L, N] for batch 1, else
    [batch, 2, L, N]."""
    from seal_tpu_torch import Ciphertext

    cd = ctx.first_context_data()
    shape = ((batch,) if batch > 1 else ()) + (2, cd.coeff_modulus_size, N)
    data = random_residues(shape, cd.key_moduli(), rng).to(ctx.device)
    return Ciphertext(data, tuple(cd.parms_id), ntt, 2.0 ** 40 if ntt else 1.0)


def same_result(a, b) -> bool:
    """Tensors, ciphertexts or lists of them equal in bits and metadata."""
    import torch

    if isinstance(a, list):
        return len(a) == len(b) and all(same_result(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return (torch.equal(a.data, b.data) and tuple(a.parms_id) == tuple(b.parms_id)
            and (a.is_ntt_form, a.scale, a.correction_factor)
            == (b.is_ntt_form, b.scale, b.correction_factor))


def graph_case(name, eager, jitted, inputs, batch, total):
    """`jitted` (a JitEvaluator pipeline or a jit.capture) on each input of
    `inputs` in turn (the first call captures, the later ones replay)
    against `eager` on the same inputs: bit for bit, and the launches of
    every call equal to the eager call's. A replay counts the launches its
    kernel wrappers counted while its graph was captured, so one replay is
    also traced with torch.profiler, and the kernels the card ran, counted
    by name, must equal the eager call's launches. Then host-clock ms per
    call and per ciphertext, eager against replayed (medians of GRAPH_REPS
    synchronised calls on the first inputs), and the device-busy share of
    the traced replay. Every launch is added to `total`."""
    import torch

    for args in inputs + inputs[:1]:
        want, launches = counted(lambda: eager(*args))
        got, replayed = counted(lambda: jitted(*args))
        require(same_result(got, want), f"graphs {name}: replayed output bit-identical "
                                        "to the eager one")
        require(replayed == launches, f"graphs {name}: launches per replay {replayed} "
                                      f"equal the eager call's {launches}")
        add_counts(add_counts(total, launches), replayed)
    eager_ms = host_ms(lambda: (eager(*inputs[0]), torch.cuda.synchronize()), GRAPH_REPS)
    replay_ms = host_ms(lambda: (jitted(*inputs[0]), torch.cuda.synchronize()), GRAPH_REPS)
    prof = device_profile(lambda: jitted(*inputs[0]))
    require(prof["kernels"] == launches, f"graphs {name}: the kernels traced in a replay "
                                         f"{prof['kernels']} equal the eager call's "
                                         f"launches {launches}")
    return {"launches": launches, "traced_replay_kernels": prof["kernels"],
            "eager_ms": eager_ms, "replay_ms": replay_ms,
            "eager_ms_per_ciphertext": eager_ms / batch,
            "replay_ms_per_ciphertext": replay_ms / batch, "speedup": eager_ms / replay_ms,
            "replay_device_busy_share": prof["device_busy_ms"] / prof["device_span_ms"],
            "replay_profile": prof}


def graph_context(spec, seed):
    from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SEALContext

    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, spec["bits"]))
    parms.set_special_modulus_size(spec["alpha"])
    parms.set_random_seed(seed_words(seed))
    return SEALContext(parms)


def phase_graphs(mode, spec):
    """bench.py's pipeline in one CKKS mode, flag off and on, at B = 1 and
    16: through a JitEvaluator (one graph per op) and as bench.py's `one`
    under jit.capture (one graph), each replay against the eager Evaluator
    on the card; then a second relinearization key of the same shapes."""
    import numpy as np

    from seal_tpu_torch import Ciphertext, Evaluator, KeyGenerator, jit
    from seal_tpu_torch.config import config

    t0 = time.perf_counter()
    ctx = graph_context(spec, GRAPH_SEED)
    rng = np.random.default_rng(GRAPH_SEED)
    rk = KeyGenerator(ctx).create_relin_keys()
    rk2 = KeyGenerator(graph_context(spec, GRAPH_SEED + 1)).create_relin_keys()
    ev, fused = Evaluator(ctx), spec["fused"]
    inputs = {B: [tuple(random_ciphertext(ctx, B, rng, True) for _ in range(2))
                  for _ in range(2)] for B in GRAPH_BATCHES}
    proto = inputs[1][0][0]

    def one(x, y):
        """bench.py's `one`, its jax.vmap the leading axis of x and y."""
        ca, cb = (Ciphertext(d, proto.parms_id, True, proto.scale) for d in (x, y))
        return run_mode(ev, fused, ca, cb, rk).data

    total, cases = {}, {}
    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        try:
            jev, step = jit.JitEvaluator(ctx), jit.capture(one)
            flag = "shoup" if shoup else "k2"
            for B in GRAPH_BATCHES:
                cases[f"jit_B{B}_{flag}"] = graph_case(
                    f"{mode} JitEvaluator B={B} {flag}",
                    lambda x, y: run_mode(ev, fused, x, y, rk),
                    lambda x, y: run_mode(jev, fused, x, y, rk), inputs[B], B, total)
                data = [tuple(c.data.reshape((B,) + c.data.shape[-3:]) for c in pair)
                        for pair in inputs[B]]
                cases[f"capture_B{B}_{flag}"] = graph_case(
                    f"{mode} capture B={B} {flag}", one, step, data, B, total)
            # a second key of the same shapes gets its own graph and result
            for x, y in inputs[1]:
                prod = ev.multiply(x, y)
                for key in (rk, rk2, rk):
                    require(same_result(jev.relinearize(prod, key), ev.relinearize(prod, key)),
                            f"graphs {mode} {flag}: each relinearization key its own result")
            require(not same_result(ev.relinearize(prod, rk), ev.relinearize(prod, rk2)),
                    f"graphs {mode}: the two keys give different results")
            cases[f"cache_{flag}"] = {"jit_cache_size": jev.cache_size(),
                                      "capture_cache_size": step.cache_size(),
                                      "jit_pool_bytes": jev.pool_bytes(),
                                      "capture_pool_bytes": step.pool_bytes()}
        finally:
            config.keyswitch_shoup = False
    emit({"phase": "graphs", "mode": mode, "n": N, "data_primes": 8,
          "special_primes": spec["alpha"], "bit_exact_vs_eager": True,
          "second_key_own_result": True, "launches_equal_eager": True, "cases": cases,
          "seconds": time.perf_counter() - t0})
    return total


def phase_graphs_exact():
    """Phase 7's BFV path through a JitEvaluator: multiply -> relinearize ->
    mod_switch_to_next -> rotate_rows(1), each op a graph, replays against
    the eager Evaluator on the card."""
    import numpy as np

    from seal_tpu_torch import Evaluator, KeyGenerator, SchemeType, jit

    t0 = time.perf_counter()
    ctx, _ = exact_contexts(SchemeType.BFV)
    rng = np.random.default_rng(GRAPH_SEED)
    kg = KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys(steps=[1])
    ev, jev = Evaluator(ctx), jit.JitEvaluator(ctx)

    def chain(e, x, y):
        prod = e.multiply(x, y)
        relin = e.relinearize(prod, rk)
        down = e.mod_switch_to_next(relin)
        return [prod, relin, down, e.rotate_rows(down, 1, gk)]

    inputs = [tuple(random_ciphertext(ctx, 1, rng, False) for _ in range(2))
              for _ in range(2)]
    total = {}
    line = graph_case("BFV JitEvaluator", lambda x, y: chain(ev, x, y),
                      lambda x, y: chain(jev, x, y), inputs, 1, total)
    emit({"phase": "graphs_exact", "scheme": "BFV", "n": N, "bit_exact_vs_eager": True,
          "launches_equal_eager": True, **line, "jit_cache_size": jev.cache_size(),
          "jit_pool_bytes": jev.pool_bytes(), "seconds": time.perf_counter() - t0})
    return total


EXAMPLES = ("1_bfv_basics.py", "2_encoders.py", "3_levels.py", "4_bgv_basics.py",
            "5_ckks_basics.py", "6_rotation.py", "7_serialization.py", "8_performance.py",
            "9_encrypted_matvec.py", "10_encrypted_logreg.py", "11_hybrid_keyswitch.py",
            "12_threshold_ckks.py", "13_streaming_pipeline.py", "14_batch_api.py")
# the examples that relinearize or rotate, so launch K2 (K3 with the flag on)
KEY_SWITCHING_EXAMPLES = frozenset(EXAMPLES) - {"2_encoders.py", "3_levels.py",
                                                "12_threshold_ckks.py"}


def phase_examples():
    """The examples ported to the port (examples_torch/) at the originals'
    default sizes, on the card; each checks its own results."""
    import importlib.util
    import pathlib

    total = {}
    for name in EXAMPLES:
        path = pathlib.Path(__file__).resolve().parent / "examples_torch" / name
        spec = importlib.util.spec_from_file_location(name[:-3], path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        t0 = time.perf_counter()
        _, launches = counted(module.main)
        require(launches["ntt_forward"] > 0, f"example {name} launched ntt_forward")
        if name in KEY_SWITCHING_EXAMPLES:
            require(launches["keyswitch_inner"] + launches["keyswitch_inner_shoup"] > 0,
                    f"example {name} launched a key-switch kernel")
        emit({"phase": "examples", "example": name, "seconds": time.perf_counter() - t0,
              "launches": launches})
        add_counts(total, launches)
    return total


# ---------------------------------------------------------------------------
# phase 14, second part: SEAL's n = 4096 golden vectors
# ---------------------------------------------------------------------------

VECTOR_N = 4096
VECTOR_SEED = (1, 2, 3, 4, 5, 6, 7, 8)
VECTOR_DIR = "tests/vectors"


def load_vectors(name):
    """A JSON file of SEAL's golden vectors (tests/vectors/), read from the
    checkout beside this script."""
    import pathlib

    return json.loads((pathlib.Path(__file__).resolve().parent / VECTOR_DIR / name).read_text())


def vector_hash(x) -> str:
    """blake2b-256 over the little-endian u64 words of a tensor or array,
    rendered word-wise like the dumper's %016llx of hash_block_type
    (tests/test_pipeline_n4096.py h())."""
    import hashlib
    import struct

    import numpy as np

    if not isinstance(x, np.ndarray):
        x = x.detach().cpu().numpy()
    data = np.ascontiguousarray(x).view(np.uint64).tobytes()
    words = struct.unpack("<4Q", hashlib.blake2b(data, digest_size=32).digest())
    return "".join(f"{w:016x}" for w in words)


def vector_parms(scheme, bits, seed=VECTOR_SEED):
    """The n = 4096 parameters of tests/test_pipeline_n4096.py: the given
    bit sizes, a 20-bit batching t for BFV/BGV, the random seed."""
    from seal_tpu_torch import CoeffModulus, EncryptionParameters, PlainModulus, SchemeType

    parms = EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(VECTOR_N)
    parms.set_coeff_modulus(CoeffModulus.create(VECTOR_N, bits))
    if scheme != SchemeType.CKKS:
        parms.set_plain_modulus(PlainModulus.batching(VECTOR_N, 20))
    parms.set_random_seed(seed)
    return parms


def vector_context(scheme, bits, device, seed=VECTOR_SEED):
    from seal_tpu_torch import SEALContext, SecLevelType

    return SEALContext(vector_parms(scheme, bits, seed), sec_level=SecLevelType.NONE,
                       device=device)


def vector_flow_bfv(device=None) -> dict:
    """BFV keygen -> encode -> encrypt (public and secret key) -> multiply
    -> relinearize -> mod switch, rotate_rows(1) -> decrypt -> decode, each
    intermediate hashed (pipeline_n4096.json's bfv_* entries)."""
    import numpy as np

    from seal_tpu_torch import (
        BatchEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator, SchemeType)

    ctx = vector_context(SchemeType.BFV, [40] * 4, device)
    t = ctx.first_context_data().parms.plain_modulus.value
    out = {"bfv_plain_modulus": t}
    kg = KeyGenerator(ctx)
    out["bfv_secret_key"] = vector_hash(kg.secret_key().data)
    pk = kg.create_public_key()
    out["bfv_public_key"] = vector_hash(pk.data.data)
    rk = kg.create_relin_keys()
    out["bfv_relin_key"] = vector_hash(rk.keys[0])
    gk = kg.create_galois_keys(ctx.key_context_data().galois_tool.get_elts_from_steps([1, -1]))
    be = BatchEncoder(ctx)
    i = np.arange(VECTOR_N, dtype=np.int64)
    p1, p2 = be.encode((i * 7 + 3) % t), be.encode((i * i + 11) % t)
    out["bfv_plain1"], out["bfv_plain2"] = vector_hash(p1.data), vector_hash(p2.data)
    enc, dec, ev = Encryptor(ctx, pk), Decryptor(ctx, kg.secret_key()), Evaluator(ctx)
    c1, c2 = enc.encrypt(p1), enc.encrypt(p2)
    out["bfv_ct1"], out["bfv_ct2"] = vector_hash(c1.data), vector_hash(c2.data)
    out["bfv_ct1_sym"] = vector_hash(Encryptor(ctx, kg.secret_key()).encrypt_symmetric(p1).data)
    cm = ev.multiply(c1, c2)
    out["bfv_mul"] = vector_hash(cm.data)
    cr = ev.relinearize(cm, rk)
    out["bfv_relin"] = vector_hash(cr.data)
    cs = ev.mod_switch_to_next(cr)
    out["bfv_modswitch"] = vector_hash(cs.data)
    out["bfv_rot1"] = vector_hash(ev.rotate_rows(cr, 1, gk).data)
    pd = dec.decrypt(cs)
    out["bfv_decrypted"] = vector_hash(pd.data)
    out["bfv_decoded"] = vector_hash(be.decode(pd))
    out["bfv_noise_budget"] = dec.invariant_noise_budget(cs)
    return out


def vector_flow_ckks(device=None) -> dict:
    """CKKS keygen (relinearization keys, Galois keys of elements 3 and
    2n-1) -> encode at 2^30 -> encrypt -> multiply -> relinearize -> rescale,
    rotate_vector(1), complex_conjugate -> decrypt -> decode (its doubles'
    bits), each hashed (pipeline_n4096.json's ckks_* entries)."""
    import numpy as np

    from seal_tpu_torch import (
        CKKSEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator, SchemeType)

    ctx = vector_context(SchemeType.CKKS, [40] * 4, device)
    out = {}
    kg = KeyGenerator(ctx)
    out["ckks_secret_key"] = vector_hash(kg.secret_key().data)
    pk = kg.create_public_key()
    out["ckks_public_key"] = vector_hash(pk.data.data)
    rk = kg.create_relin_keys()
    out["ckks_relin_key"] = vector_hash(rk.keys[0])
    gk = kg.create_galois_keys([3, 2 * VECTOR_N - 1])
    ce = CKKSEncoder(ctx)
    i = np.arange(ce.slot_count, dtype=np.float64)
    v1 = ((i % 97) / 97.0 - 0.3) + 1j * ((i % 31) / 31.0)
    v2 = ((i % 53) / 53.0) + 1j * ((i % 13) / 13.0 - 0.5)
    p1, p2 = ce.encode(v1, 2.0 ** 30), ce.encode(v2, 2.0 ** 30)
    out["ckks_plain1"], out["ckks_plain2"] = vector_hash(p1.data), vector_hash(p2.data)
    enc, dec, ev = Encryptor(ctx, pk), Decryptor(ctx, kg.secret_key()), Evaluator(ctx)
    c1, c2 = enc.encrypt(p1), enc.encrypt(p2)
    out["ckks_ct1"], out["ckks_ct2"] = vector_hash(c1.data), vector_hash(c2.data)
    cm = ev.multiply(c1, c2)
    out["ckks_mul"] = vector_hash(cm.data)
    cr = ev.relinearize(cm, rk)
    out["ckks_relin"] = vector_hash(cr.data)
    cs = ev.rescale_to_next(cr)
    out["ckks_rescale"] = vector_hash(cs.data)
    out["ckks_rescale_scale"] = cs.scale
    out["ckks_rot1"] = vector_hash(ev.rotate_vector(c1, 1, gk).data)
    out["ckks_conj"] = vector_hash(ev.complex_conjugate(c1, gk).data)
    pd = dec.decrypt(cs)
    out["ckks_decrypted"] = vector_hash(pd.data)
    out["ckks_decoded_bits"] = vector_hash(ce.decode(pd, complex_out=True))
    return out


def vector_flow_bgv(device=None) -> dict:
    """BGV keygen -> encode -> encrypt -> multiply -> relinearize -> mod
    switch, rotate_rows(1) -> decrypt -> decode, each hashed
    (pipeline_n4096.json's bgv_* entries)."""
    import numpy as np

    from seal_tpu_torch import (
        BatchEncoder, Decryptor, Encryptor, Evaluator, KeyGenerator, SchemeType)

    ctx = vector_context(SchemeType.BGV, [40] * 4, device)
    t = ctx.first_context_data().parms.plain_modulus.value
    out = {}
    kg = KeyGenerator(ctx)
    out["bgv_secret_key"] = vector_hash(kg.secret_key().data)
    pk = kg.create_public_key()
    out["bgv_public_key"] = vector_hash(pk.data.data)
    rk = kg.create_relin_keys()
    out["bgv_relin_key"] = vector_hash(rk.keys[0])
    gk = kg.create_galois_keys(ctx.key_context_data().galois_tool.get_elts_from_steps([1]))
    be = BatchEncoder(ctx)
    i = np.arange(VECTOR_N, dtype=np.int64)
    p1, p2 = be.encode((i * 5 + 1) % t), be.encode((i * 3 + 7) % t)
    out["bgv_plain1"] = vector_hash(p1.data)
    enc, dec, ev = Encryptor(ctx, pk), Decryptor(ctx, kg.secret_key()), Evaluator(ctx)
    c1, c2 = enc.encrypt(p1), enc.encrypt(p2)
    out["bgv_ct1"] = vector_hash(c1.data)
    cm = ev.multiply(c1, c2)
    out["bgv_mul"] = vector_hash(cm.data)
    cr = ev.relinearize(cm, rk)
    out["bgv_relin"] = vector_hash(cr.data)
    cs = ev.mod_switch_to_next(cr)
    out["bgv_modswitch"] = vector_hash(cs.data)
    out["bgv_rot1"] = vector_hash(ev.rotate_rows(c1, 1, gk).data)
    pd = dec.decrypt(cs)
    out["bgv_decrypted"] = vector_hash(pd.data)
    out["bgv_decoded"] = vector_hash(be.decode(pd))
    return out


def vector_flow_multiparty(device=None) -> dict:
    """The fork's three-party BFV flow, each party seeded (10 + i, 2, ...,
    8): secret keys, shared-c1 public keys, the common public and secret
    keys, an encryption under the common key, each partial decryption and
    their aggregate, each hashed (pipeline_n4096.json's mp_* entries)."""
    import numpy as np

    from seal_tpu_torch import BatchEncoder, Decryptor, Encryptor, KeyGenerator, SchemeType

    ctxs = [vector_context(SchemeType.BFV, [40] * 3, device, seed=(10 + i, 2, 3, 4, 5, 6, 7, 8))
            for i in range(3)]
    kgs = [KeyGenerator(ctx) for ctx in ctxs]
    out = {}
    sks = [kg.generate_secret_key() for kg in kgs]
    for i, sk in enumerate(sks):
        out[f"mp_sk{i}"] = vector_hash(sk.data)
    pks = [kgs[0].create_public_key_with_sk(sks[0])]
    pks += [kgs[i].create_public_key_with_same_c1(sks[i], pks[0]) for i in (1, 2)]
    cpk = kgs[0].create_common_public_key(pks)
    out["mp_cpk"] = vector_hash(cpk.data.data)
    out["mp_csk"] = vector_hash(kgs[0].create_common_secret_key(sks).data)
    t = ctxs[0].first_context_data().parms.plain_modulus.value
    i = np.arange(VECTOR_N, dtype=np.int64)
    ct = Encryptor(ctxs[0], cpk).encrypt(BatchEncoder(ctxs[0]).encode((i * 9 + 2) % t))
    out["mp_ct"] = vector_hash(ct.data)
    partials = [Decryptor(ctxs[j], sks[j]).distributed_decrypt(ct) for j in range(3)]
    for j, part in enumerate(partials):
        out[f"mp_partial{j}"] = vector_hash(part.data[1])
    agg = Decryptor(ctxs[0], sks[0]).aggregate_partial_decryption(ct, partials)
    out["mp_aggregated_plain"] = vector_hash(agg.data)
    return out


VECTOR_FLOWS = {"bfv": vector_flow_bfv, "ckks": vector_flow_ckks, "bgv": vector_flow_bgv,
                "multiparty": vector_flow_multiparty}


def vector_saves(device=None) -> tuple[dict, bool]:
    """tests/test_serialization_n4096.py's objects (BFV n=4096, bits [36,
    36, 37], the seed; relinearization and Galois {3} keys with save_seed,
    a public-key and a seeded symmetric encryption), saved as SEAL's bytes
    under serialization_n4096.json's names: ZLIB, and ZSTD where
    `zstandard` imports. Also whether the ciphertext decrypts to its
    slots."""
    import numpy as np
    import torch

    from seal_tpu_torch import (
        BatchEncoder, ComprMode, Decryptor, Encryptor, KeyGenerator, SchemeType, SEALContext)
    from seal_tpu_torch import serialization as ser

    parms = vector_parms(SchemeType.BFV, [36, 36, 37])
    ctx = SEALContext(parms, device=device)
    kg = KeyGenerator(ctx)
    # the dumper's stream order: relin (seeded) -> galois {3} (seeded) ->
    # public key -> encrypt -> encrypt_symmetric (seeded)
    rk = kg.create_relin_keys(save_seed=True)
    gk = kg.create_galois_keys([3], save_seed=True)
    pk = kg.create_public_key()
    enc = Encryptor(ctx, pk, kg.secret_key())
    be = BatchEncoder(ctx)
    vals = np.asarray([(17 * i + 3) % 1000 for i in range(be.slot_count)], dtype=np.int64)
    p1 = be.encode(vals)
    ct = enc.encrypt(p1)
    ct_sym = enc.encrypt_symmetric(p1, save_seed=True)
    saves = {"parms": ser.save_encryption_parameters(parms),
             "relin_keys_seeded": ser.save_relin_keys(rk),
             "galois_keys_seeded": ser.save_galois_keys(gk),
             "ct_none": ser.save_ciphertext(ct),
             "ct_sym_seeded": ser.save_ciphertext(ct_sym),
             "ct_zlib": ser.save_ciphertext(ct, ComprMode.ZLIB)}
    if ser._zstd is not None:
        saves["ct_zstd"] = ser.save_ciphertext(ct, ComprMode.ZSTD)
    decoded = be.decode(Decryptor(ctx, kg.secret_key()).decrypt(ct))
    return saves, bool(torch.equal(decoded, torch.from_numpy(vals).to(decoded.device)))


def first_vector_mismatch(got: dict, want: dict):
    """The first entry of got that differs from the vectors, as
    'name: got != want', or None when every one is equal."""
    for name, value in got.items():
        if value != want[name]:
            return f"{name}: {value!r} != {want[name]!r}"
    return None


def first_byte_mismatch(got: dict, want: dict):
    """The first save whose bytes differ from the vectors' hex, with the
    first byte offset that differs, or None."""
    for name, blob in got.items():
        ref = bytes.fromhex(want[name])
        if blob != ref:
            offset = next((k for k, (a, b) in enumerate(zip(blob, ref)) if a != b),
                          min(len(blob), len(ref)))
            return f"{name}: byte {offset} differs ({len(blob)} bytes against {len(ref)})"
    return None


def phase_vectors():
    """SEAL's n = 4096 golden vectors from the card's objects: each flow of
    pipeline_n4096.json hashed, the key-switching flows (BFV, CKKS, BGV)
    with the Shoup flag off (K2) and again on (K3), and the saves of
    serialization_n4096.json byte for byte."""
    from seal_tpu_torch.config import config

    hashes = load_vectors("pipeline_n4096.json")
    total = {}
    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        try:
            for name, flow in VECTOR_FLOWS.items():
                if shoup and name == "multiparty":
                    continue                    # no key switch to run again
                t0 = time.perf_counter()
                got, launches = counted(flow)
                seconds = time.perf_counter() - t0
                bad = first_vector_mismatch(got, hashes)
                require(bad is None, f"vectors {name} (shoup {shoup}) {bad}")
                if name != "multiparty":
                    ks = "keyswitch_inner_shoup" if shoup else "keyswitch_inner"
                    require(launches[ks] > 0, f"vectors {name} launched {ks}")
                require(launches["ntt_forward"] > 0 and launches["ntt_inverse"] > 0,
                        f"vectors {name} launched K1")
                emit({"phase": "vectors", "flow": name, "n": VECTOR_N, "shoup": shoup,
                      "entries": len(got), "equal": True, "seconds": seconds,
                      "launches": launches})
                add_counts(total, launches)
        finally:
            config.keyswitch_shoup = False
    from seal_tpu_torch import serialization

    if serialization._zstd is None:
        emit({"phase": "vectors", "flow": "wire", "mode": "zstd", "skipped": True,
              "reason": "zstandard does not import"})
    t0 = time.perf_counter()
    (saves, decrypts), launches = counted(vector_saves)
    seconds = time.perf_counter() - t0
    bad = first_byte_mismatch(saves, load_vectors("serialization_n4096.json"))
    require(bad is None, f"vectors wire {bad}")
    require(decrypts, "the byte-pinned ciphertext decrypts to its slots")
    emit({"phase": "vectors", "flow": "wire", "n": VECTOR_N,
          "saves": {k: len(v) for k, v in saves.items()}, "bytes_equal": True,
          "decrypts": True, "seconds": seconds, "launches": launches})
    add_counts(total, launches)
    return total


# ---------------------------------------------------------------------------
# phase 15: parallel/ on ranks that share the card
# ---------------------------------------------------------------------------

PARALLEL_LIMIT_S = 300
# the records of ops that key-switch: each rank launches K1 and K2 (K3 with
# the Shoup flag) in every one
KEYSWITCH_OPS = ("/relinearize/", "/relinearize_rescale/", "/hoisted/", "/dp_tp/")


def parallel_ops(res, backend):
    """A rank's dryrun records, checked and cut down for its line: the
    kernels each op launched on the rank, the census of its collectives
    ([calls, bytes], staged through the host exactly under gloo), and the
    census models and host-clock ms where the record has them."""
    ops = {}
    for name, rec in res["records"].items():
        launches = rec["launches"]
        if any(op in name for op in KEYSWITCH_OPS):
            ks = "keyswitch_inner_shoup" if name.endswith("/shoup") else "keyswitch_inner"
            require(launches["ntt_forward"] > 0 and launches["ntt_inverse"] > 0
                    and launches[ks] > 0,
                    f"{backend} rank {res['rank']}: {name} launched K1 and {ks}")
        require(all(e["staged"] == (backend == "gloo") for e in rec["census"].values()),
                f"{backend} rank {res['rank']}: {name} staged through the host "
                f"exactly under gloo")
        ops[name] = {"launches": {k: v for k, v in launches.items() if v},
                     "census": {op: [e["calls"], e["bytes"]]
                                for op, e in rec["census"].items()},
                     **{k: rec[k] for k in ("model_bytes", "seal_tpu_model_bytes", "ms",
                                            "ms_unsharded", "route") if k in rec}}
    return ops


def phase_parallel():
    """seal_tpu_torch/parallel/dryrun.py at bench.py's width in both modes,
    Shoup flag off and on, on NCCL with one rank per card, then on two gloo
    ranks sharing the card (collectives staged through the host); every
    record of every rank bit for bit the unsharded card Evaluator, every
    split key switch one all_reduce of 2·(L+α)·N·8 bytes."""
    import torch

    from seal_tpu_torch.parallel import dryrun

    total = {}
    for backend, world in (("nccl", torch.cuda.device_count()), ("gloo", TP_RANKS)):
        t0 = time.perf_counter()
        results = dryrun.dryrun_multichip(world, backend, "cuda", dryrun.FULL,
                                          timeout_s=PARALLEL_LIMIT_S)
        seconds = time.perf_counter() - t0
        for res in results:
            ops = parallel_ops(res, backend)
            for rec in res["records"].values():
                add_counts(total, rec["launches"])
            emit({"phase": "parallel", "backend": backend, "world": world,
                  "rank": res["rank"], "device": res["device"], "dp": res["dp"],
                  "tp": res["tp"], "staged": backend == "gloo", "n": dryrun.FULL["n"],
                  "bit_exact": True, "rank_seconds": res["seconds"],
                  "run_seconds": seconds, "ops": ops})
    return total


# ---------------------------------------------------------------------------
# phase 16: the kernels at every configuration phases 5-14 gave them
# ---------------------------------------------------------------------------

class PathShapes:
    """While installed, notes the configuration of every kernel launch: each
    *_cuda wrapper of ops/ntt.py and ops/keyswitch.py is replaced by one
    that notes (kernel, input shape, its moduli tensor) and calls the
    wrapper unchanged, so the launches and their counts are the same. A
    call made while a CUDA graph is captured is not noted, as its moduli
    may not hold values yet; jit.py runs every capture's call eagerly just
    before it, at the same shapes. The moduli are read from the card once,
    at the end."""

    WRAPPERS = (("ntt", "ntt_forward"), ("ntt", "ntt_inverse"),
                ("keyswitch", "keyswitch_inner"), ("keyswitch", "keyswitch_inner_shoup"))

    def __init__(self):
        self.seen = {}          # (kernel, shape, moduli address, max q) -> moduli
        self.saved = []

    def __enter__(self):
        import importlib

        for module_name, kind in self.WRAPPERS:
            module = importlib.import_module(f"seal_tpu_torch.ops.{module_name}")
            wrapper = getattr(module, f"{kind}_cuda")
            self.saved.append((module, f"{kind}_cuda", wrapper))
            setattr(module, f"{kind}_cuda", self._noting(kind, wrapper))
        return self

    def __exit__(self, *exc):
        for module, name, wrapper in self.saved:
            setattr(module, name, wrapper)
        self.saved.clear()

    def _noting(self, kind, wrapper):
        import torch

        def call(x, *args):
            if x.numel() and not torch.cuda.is_current_stream_capturing():
                shoup = kind.endswith("shoup")
                # the NTT's tables carry [L, 1] moduli; the key switch's
                # constants are [I, 3] rows (q, ratio0, ratio1)
                moduli = args[0].mc.q if kind.startswith("ntt") else args[-2 if shoup else -1]
                max_q = args[-1] if shoup else None
                key = (kind, tuple(x.shape), moduli.data_ptr(), max_q)
                self.seen.setdefault(key, moduli)   # held, so the address stays its own
            return wrapper(x, *args)
        return call

    def configs(self) -> list:
        """[(kernel, shape, moduli, max q)], each configuration once."""
        out = {}
        for (kind, shape, _, max_q), moduli in self.seen.items():
            values = tuple(int(v) for v in moduli[:, 0].tolist())
            out[(kind, shape, values, max_q)] = None
        return list(out)


def keyswitch_case(kind, shape, moduli, max_q, rng):
    """K2 or K3 at one shape t [*batch, J, I, n] over the rows' moduli (K3
    with the path's max q): bit for bit against the plain version on CPU
    copies, timed."""
    import torch

    from seal_tpu_torch.ops import keyswitch

    J, I, n = shape[-3:]
    B = math.prod(shape[:-3])
    shoup = kind == "keyswitch_inner_shoup"
    q = torch.tensor(moduli, dtype=torch.int64).reshape(I, 1)
    t = random_residues(shape, moduli, rng)
    k = random_residues((J, 2, I, n), moduli, rng)
    t[..., 0] = k[..., 0] = q[:, 0] - 1
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    args = (t, k, keyswitch.key_quotients(k, moduli)) if shoup else (t, k)
    extra = (max_q,) if shoup else ()
    dev = [a.cuda() for a in args] + [consts.cuda()]
    kernel = getattr(keyswitch, f"{kind}_cuda")
    got = kernel(*dev, *extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = getattr(keyswitch, f"{kind}_plain")(*args, consts, *extra)
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(got.cpu(), want), f"{kind} {list(shape)} bit-exact")
    b_ms, b_by = bound(keyswitch_bytes(B, J, I, shoup, n), B * keyswitch_muls(J, I, shoup, n))
    emit({"phase": "K3_paths" if shoup else "K2_paths", "kernel": kind,
          "shape": list(shape), "bit_exact": True, "max_abs_err": 0,
          "ms": cuda_ms(lambda: kernel(*dev, *extra)), "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by})


def phase_path_shapes(shapes: PathShapes, rng):
    """Phases 2-4's check at every configuration of K1, K2 and K3 that
    phases 5-14 launched and phases 2-4 did not check: the same shape, the
    same moduli, random inputs, bit for bit against the plain version."""
    from seal_tpu_torch import cuda

    t0 = time.perf_counter()
    configs = shapes.configs()
    fresh = [c for c in configs if c[:3] not in CHECKED]
    for kind, shape, moduli, max_q in fresh:
        if kind.startswith("ntt"):
            ntt_case(kind, shape, moduli, rng, phase="K1_paths", graph=False)
        else:
            keyswitch_case(kind, shape, moduli, max_q, rng)
    count = lambda cs: {k: sum(c[0] == k for c in cs) for k in cuda.launches}  # noqa: E731
    for kind, recorded in count(configs).items():
        require(recorded > 0, f"{kind}: phases 5-14 launched it at some configuration")
    emit({"phase": "path_shapes", "configurations": count(configs),
          "checked_here": count(fresh), "checked_in_phases_2_4": len(configs) - len(fresh),
          "bit_exact": True, "seconds": time.perf_counter() - t0})


# each K1/K2/K3 wrapper's kernel by name, demangled or mangled: one K1
# transform runs one chunk pass (ntt_pass_kernel<inverse, column=false, M>),
# and for n > 512 a column pass as well
TRACED_KERNELS = {
    "ntt_forward": r"ntt_pass_kernel(<\s*false\s*,\s*false\s*,|ILb0ELb0E)",
    "ntt_inverse": r"ntt_pass_kernel(<\s*true\s*,\s*false\s*,|ILb1ELb0E)",
    "keyswitch_inner": r"keyswitch_inner_kernel",
    "keyswitch_inner_shoup": r"keyswitch_inner_shoup_kernel",
}


def device_profile(fn):
    """One call of fn under torch.profiler, after one call untraced: the
    CUDA kernels and copies it ran, their summed device time, the span
    from the first one's start to the last one's end (the device's idle
    share over that span is 1 - busy / span), and the kernels of each
    wrapper it ran, counted by name (TRACED_KERNELS)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = {name: sum(1 for e in events if re.search(pattern, e.name))
               for name, pattern in TRACED_KERNELS.items()}
    if not events:
        return {"device_events": 0, "kernels": kernels}
    busy = sum(e.device_time_total for e in events) / 1e3
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    return {"device_events": len(events), "device_busy_ms": busy, "device_span_ms": span,
            "kernels": kernels}


def phase_prng_rate():
    """The host rate of one bulk draw from a seeded blake2xb stream (the
    native XOF), beside its plain version's (the numpy XOF) on the same
    bytes."""
    import struct

    from seal_tpu_torch import randomgen

    prng = randomgen.Blake2xbPRNG(seed_words(SEED))
    t0 = time.perf_counter()
    got = prng.generate(PRNG_RATE_BYTES)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = randomgen.blake2xb_refills_plain(struct.pack("<8Q", *seed_words(SEED)), 0,
                                            PRNG_RATE_BYTES // randomgen.BUFFER_SIZE)
    plain_seconds = time.perf_counter() - t0
    require(got == want, "the native byte stream equals the numpy XOF's bytes")
    emit({"phase": "prng", "bytes": PRNG_RATE_BYTES, "seconds": seconds,
          "mb_per_s": PRNG_RATE_BYTES / 1e6 / seconds, "plain_seconds": plain_seconds,
          "plain_mb_per_s": PRNG_RATE_BYTES / 1e6 / plain_seconds, "bytes_equal": True})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from seal_tpu_torch import cuda, native

    t_start = time.perf_counter()
    emit({"phase": "build", "seconds": clocked("1 build", cuda.build),
          "sources": list(cuda.SOURCES),
          "native_seconds": native.build(), "native_source": str(native.SOURCE.name)})
    import numpy as np

    meter_prng()
    clocked("1 prng_rate", phase_prng_rate)
    rng = np.random.default_rng(SEED)
    kernels, ntt_runs = clocked("2 ntt", phase_ntt, rng)
    kernels.update(clocked("3 keyswitch", phase_keyswitch, rng))
    kernels.update(clocked("4 keyswitch_shoup", phase_keyswitch_shoup, rng))

    total = {name: 0 for name in cuda.launches}
    from seal_tpu_torch import SchemeType

    with PathShapes() as shapes:
        for mode, spec in MODES.items():
            add_counts(total, clocked("5 pipeline", phase_pipeline, mode, spec))
            add_counts(total, clocked("6 rotations", phase_rotations, mode, spec))
        for scheme in (SchemeType.BFV, SchemeType.BGV):
            add_counts(total, clocked("7 exact", phase_exact, scheme))
        for mode, spec in MODES.items():
            add_counts(total, clocked("8 round_trip", phase_round_trip, mode, spec))
        for mode, spec in MODES.items():
            add_counts(total, clocked("9 batch", phase_batch, mode, spec))
        for scheme in (SchemeType.BFV, SchemeType.BGV):
            add_counts(total, clocked("10 exact_batch", phase_exact_batch, scheme))
        for config in THRESHOLD:
            counts, flow, flow_cpu = clocked("11 threshold", phase_threshold, config)
            add_counts(total, counts)
            clocked("12 wire", phase_wire, config, flow, flow_cpu)
        for mode, spec in MODES.items():
            add_counts(total, clocked("13 graphs", phase_graphs, mode, spec))
        add_counts(total, clocked("13 graphs", phase_graphs_exact))
        add_counts(total, clocked("14 examples", phase_examples))
        add_counts(total, clocked("14 vectors", phase_vectors))
    add_counts(total, clocked("15 parallel", phase_parallel))
    for name, count in total.items():
        require(count > 0, f"{name} launched on the paths run")
    clocked("16 path_shapes", phase_path_shapes, shapes, rng)
    clocked("17 ntt_passes", phase_ntt_passes, ntt_runs)
    emit({"phase": "seconds", "phases": PHASE_SECONDS,
          "total": time.perf_counter() - t_start})

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
    timed = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": total[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "device_ms": k["device_ms"],
         "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         "shape": k["shape"],
         **({"batch": {key: kernels[name + "_batch"][key] for key in timed}}
            if name + "_batch" in kernels else {})}
        for name, k in kernels.items() if not name.endswith("_batch")]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
