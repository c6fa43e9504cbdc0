"""RLWE samplers on SEAL's byte stream, and the encryptions of zero.

The port of seal_tpu/rlwe.py (SEAL util/rlwe.cpp: sample_poly_ternary :21,
sample_poly_normal :40, sample_poly_cbd :66, sample_poly_uniform :103,
encrypt_zero_asymmetric :189, encrypt_zero_symmetric :415). The samplers
read the stream of randomgen.py on the host, in SEAL's exact order:

* ternary: std::uniform_int_distribution<uint64_t>(0, 2) over 32-bit words
  is Lemire's method, whose rejection for range 3 fires only on a zero
  word, so the accepted sequence is the nonzero 32-bit words of the stream
  and r = (w·3) >> 32;
* uniform: L·N·8 bytes in one read, then each rejected word (at or above
  2^64 - (2^64 mod q) - 1) redrawn 8 bytes at a time, in (prime,
  coefficient) order;
* centered binomial noise: 6 bytes per coefficient, no rejection.

Each sampled polynomial moves to the context's device once (the ternary
and noise polynomials as one row of signed values, lifted to every prime
there); the NTTs and products of an encryption run on the device. For a
batch of B encryptions (`count=B`, the Encryptor's encrypt_many) the host
draws each member's bytes in the order of B sequential calls, the draws of
the batch move to the device together, and every NTT is one launch for the
batch.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch import randomgen
from seal_tpu_torch.context import ContextData, SEALContext
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.ops import modarith, modring
from seal_tpu_torch.ops import ntt as ntt_mod

NOISE_STANDARD_DEVIATION = 3.2
# util/globals.h:36-40: σ times the width multiplier 6
NOISE_MAX_DEVIATION = 6 * 3.2
_MAX_U64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# samplers (host)
# ---------------------------------------------------------------------------

def ternary_values(prng, n: int) -> np.ndarray:
    """n values in {-1, 0, 1} as int64, SEAL's ternary draw."""
    words = np.frombuffer(prng.generate(4 * n), dtype="<u4")
    accepted = words[words != 0]
    while len(accepted) < n:
        extra = np.frombuffer(prng.generate(4 * (n - len(accepted))), dtype="<u4")
        accepted = np.concatenate([accepted, extra[extra != 0]])
    r = (accepted[:n].astype(np.uint64) * np.uint64(3)) >> np.uint64(32)
    return r.astype(np.int64) - 1


_POPCNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def cbd_values(prng, n: int) -> np.ndarray:
    """n centered binomial values (σ = 3.2) as int64: per coefficient 6
    bytes, the difference of the popcounts of two 21-bit words."""
    raw = np.frombuffer(prng.generate(6 * n), dtype=np.uint8).reshape(n, 6).copy()
    raw[:, 2] &= 0x1F
    raw[:, 5] &= 0x1F
    w = _POPCNT[raw]
    return w[:, 0] + w[:, 1] + w[:, 2] - w[:, 3] - w[:, 4] - w[:, 5]


def lift_host(values: np.ndarray, moduli) -> np.ndarray:
    """Signed values [n] -> uint64 residues [L, n]."""
    return np.stack([np.where(values < 0, values + q, values).astype(np.uint64)
                     for q in moduli])


def sample_poly_ternary(prng, moduli, n: int) -> np.ndarray:
    """Ternary poly lifted to each prime -> uint64 [L, N]."""
    return lift_host(ternary_values(prng, n), moduli)


def sample_poly_cbd(prng, moduli, n: int) -> np.ndarray:
    """Centered binomial noise poly -> uint64 [L, N]."""
    return lift_host(cbd_values(prng, n), moduli)


def sample_poly_uniform(prng, moduli, n: int) -> np.ndarray:
    """Uniform poly mod each prime -> uint64 [L, N], rejection-exact."""
    L = len(moduli)
    raw = np.frombuffer(prng.generate(L * n * 8), dtype="<u8").reshape(L, n).copy()
    for j, q in enumerate(moduli):
        max_multiple = _MAX_U64 - (_MAX_U64 % q) - 1
        for i in np.nonzero(raw[j] >= np.uint64(max_multiple))[0]:
            v = int(raw[j, i])
            while v >= max_multiple:
                v = int(np.frombuffer(prng.generate(8), dtype="<u8")[0])
            raw[j, i] = v
        raw[j] %= np.uint64(q)
    return raw


def _legacy_uniform(prng, moduli, n: int, max_random: int, assemble) -> np.ndarray:
    out = np.empty((len(moduli), n), dtype=np.uint64)
    for j, q in enumerate(moduli):
        max_multiple = max_random - (max_random % q) - 1
        for i in range(n):
            while True:
                a = int.from_bytes(prng.generate(4), "little")
                b = int.from_bytes(prng.generate(4), "little")
                rand = assemble(a, b)
                if rand < max_multiple:
                    break
            out[j, i] = rand % q
    return out


def sample_poly_uniform_seal_3_5(prng, moduli, n: int) -> np.ndarray:
    """SEAL <= 3.5's uniform sampler: sequential 64-bit draws from two
    32-bit reads, high word first."""
    return _legacy_uniform(prng, moduli, n, _MAX_U64, lambda a, b: (a << 32) | b)


def sample_poly_uniform_seal_3_4(prng, moduli, n: int) -> np.ndarray:
    """SEAL <= 3.4's uniform sampler: 63-bit draws (a << 31) | (b >> 1)."""
    return _legacy_uniform(prng, moduli, n, _MAX_U64 >> 1, lambda a, b: (a << 31) | (b >> 1))


def sample_poly_normal(prng, moduli, n: int) -> np.ndarray:
    """Clipped rounded Gaussian (σ = 3.2, bound 6σ), the noise of SEAL's
    SEAL_USE_GAUSSIAN_NOISE build: Box-Muller over 16-byte draws. Not the
    default noise (that is the centered binomial) and, like seal_tpu's, not
    byte-exact against libstdc++'s normal_distribution."""
    vals = np.empty(n, dtype=np.int64)
    i = 0
    while i < n:
        u = np.frombuffer(prng.generate(16), dtype="<u8").astype(np.float64) / 2**64
        r = np.sqrt(-2.0 * np.log(max(u[0], 1e-300))) * NOISE_STANDARD_DEVIATION
        for g in (r * np.cos(2 * np.pi * u[1]), r * np.sin(2 * np.pi * u[1])):
            if abs(g) <= NOISE_MAX_DEVIATION and i < n:
                vals[i] = int(round(g))
                i += 1
    return lift_host(vals, moduli)


# ---------------------------------------------------------------------------
# on the device
# ---------------------------------------------------------------------------

def lift(values: np.ndarray, q: torch.Tensor) -> torch.Tensor:
    """Signed values [..., N] (host) -> residues [..., L, N] on q's device
    (q: [L, 1]); one transfer of the signed row."""
    v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64)).to(q.device)
    v = v.unsqueeze(-2)
    return torch.where(v < 0, v + q, v)


def prng_for(context: SEALContext) -> randomgen.UniformRandomGenerator:
    """A new stream from the parameters' factory: with a random seed set,
    every call replays the same bytes, as SEAL's seeded factory does."""
    parms = context.key_context_data().parms
    return randomgen.UniformRandomGeneratorFactory(
        parms.prng_type, seed=parms.random_seed).create()


def _times_t(e: torch.Tensor, cd: ContextData) -> torch.Tensor:
    return modarith.mul_mod_shoup(e, *cd.plain_consts["t_mod_q"], cd.mod_consts.q)


def _members(count):
    return 1 if count is None else count


def _one_or_batch(host: np.ndarray, count):
    """Host draws [B, ...] -> [...] for one encryption (count None)."""
    return host[0] if count is None else host


def encrypt_zero_symmetric(secret_key, context: SEALContext, cd: ContextData,
                           is_ntt_form: bool = True, save_seed: bool = False,
                           count: int | None = None, c1_override=None):
    """SEAL's symmetric encryption of zero at level cd (rlwe.cpp:415-545):
    (c0, c1) = (-(a·s + e), a), with e times t for BGV. A bootstrap stream
    gives the seed of a second stream, which draws a; e comes from the
    bootstrap stream after the seed. In NTT form a is read as the NTT of
    c1; in coefficient form it is read as the NTT form and c1 leaves
    through the inverse NTT, unless save_seed, where a is the coefficient
    form itself (the seed then regenerates c1). Returns ([2, L, N], (prng
    type, seed of a)); with count=B, ([B, 2, L, N], [B seeds]).

    c1_override, an NTT-form [L, N] tensor, is the fork's
    encrypt_zero_symmetric_with_c1 (rlwe.cpp:276-413): it takes the place
    of a, which is then not sampled, but the bootstrap stream still gives
    its 64-byte seed before the noise, so e is the noise of an unshared
    encryption."""
    moduli = cd.key_moduli()
    n = cd.parms.poly_modulus_degree
    mc, tables = cd.mod_consts, cd.ntt_tables
    prng_type = context.key_context_data().parms.prng_type
    if c1_override is not None and count is not None:
        raise ValueError("c1_override encrypts one zero, not a batch")
    seeds, a_host, e_host = [], [], []
    for _ in range(_members(count)):
        bootstrap = prng_for(context)
        public_seed = tuple(np.frombuffer(
            bootstrap.generate(randomgen.PRNG_SEED_BYTE_COUNT), dtype="<u8").tolist())
        if c1_override is None:
            a_host.append(sample_poly_uniform(
                randomgen.UniformRandomGeneratorFactory(prng_type).create(public_seed),
                moduli, n))
        e_host.append(cbd_values(bootstrap, n))
        seeds.append((int(prng_type), public_seed))
    L = len(moduli)
    if c1_override is None:
        # a (below q < 2^61, so its int64 view is its value) and the signed
        # noise rows of the whole batch in one transfer
        draws = np.concatenate([np.stack(a_host).view(np.int64),
                                np.stack(e_host)[:, None, :]], axis=1)
        draws = torch.from_numpy(_one_or_batch(draws, count)).to(context.device)
        a, e = draws[..., :L, :], draws[..., L:, :]
    else:
        a = c1_override
        e = torch.from_numpy(e_host[0][None]).to(context.device)
    if is_ntt_form or not save_seed or c1_override is not None:
        c1_ntt = a
        c1 = a if is_ntt_form else ntt_mod.ntt_inverse(a, tables)
    else:
        c1_ntt, c1 = ntt_mod.ntt_forward(a, tables), a
    e = torch.where(e < 0, e + mc.q, e)
    sc1 = modring.dyadic_product(secret_key.data[:len(moduli)], c1_ntt, mc)
    if is_ntt_form:
        e = ntt_mod.ntt_forward(e, tables)
    else:
        sc1 = ntt_mod.ntt_inverse(sc1, tables)
    if cd.parms.scheme == SchemeType.BGV:
        e = _times_t(e, cd)
    c0 = modring.negate_poly(modring.add_poly(e, sc1, mc), mc)
    return torch.stack([c0, c1], dim=-3), (seeds[0] if count is None else seeds)


def encrypt_zero_asymmetric(public_key, context: SEALContext, cd: ContextData,
                            is_ntt_form: bool, count: int | None = None) -> torch.Tensor:
    """c_j = u·pk_j + e_j, with e_j times t for BGV (rlwe.cpp:189-274): u
    ternary then e_0, e_1, ... from one stream. The public key lives at the
    key level; a lower level uses its first L rows. Returns [size, L, N];
    with count=B, [B, size, L, N]."""
    mc, tables = cd.mod_consts, cd.ntt_tables
    L, n = cd.coeff_modulus_size, cd.parms.poly_modulus_degree
    pk = public_key.data.data[:, :L]
    size = pk.shape[0]
    draws = []
    for _ in range(_members(count)):
        prng = prng_for(context)
        u = ternary_values(prng, n)
        draws.append(np.stack([u] + [cbd_values(prng, n) for _ in range(size)]))
    # u and the e_j of the whole batch in one transfer
    lifted = lift(_one_or_batch(np.stack(draws), count), mc.q)
    u = ntt_mod.ntt_forward(lifted[..., 0, :, :], tables)
    c = modring.dyadic_product(u.unsqueeze(-3), pk, mc)
    e = lifted[..., 1:, :, :]
    if is_ntt_form:
        e = ntt_mod.ntt_forward(e, tables)
    else:
        c = ntt_mod.ntt_inverse(c, tables)
    if cd.parms.scheme == SchemeType.BGV:
        e = _times_t(e, cd)
    return modring.add_poly(e, c, mc)
