"""RLWE samplers and the symmetric encryption of zero, drawn from an explicit
torch.Generator on the context's device.

The port of the samplers of seal_tpu/rlwe.py (SEAL util/rlwe.cpp): the same
distributions, but not SEAL's blake2xb byte stream, so a key or ciphertext
made here is not byte-identical to SEAL's. Bit-exact comparisons carry keys
and ciphertexts across instead (interop.py).
"""

from __future__ import annotations

import torch

from seal_tpu_torch.context import ContextData
from seal_tpu_torch.ops import modring
from seal_tpu_torch.ops import ntt as ntt_mod

# SEAL's centered binomial noise: the difference of two sums of 21 fair bits
# (σ = √(42/4) ≈ 3.24; util/rlwe.cpp sample_poly_cbd)
CBD_BITS = 21


def sample_poly_ternary(gen: torch.Generator, q: torch.Tensor, n: int):
    """Uniform {-1, 0, 1} poly lifted to each prime of q [L, 1] -> [L, N]."""
    r = torch.randint(0, 3, (n,), generator=gen, device=q.device)
    return torch.where(r == 0, q - 1, r - 1)


def sample_poly_cbd(gen: torch.Generator, q: torch.Tensor, n: int):
    """Centered binomial noise poly lifted to each prime -> [L, N]."""
    bits = torch.randint(0, 2, (n, 2 * CBD_BITS), generator=gen, device=q.device)
    e = bits[:, :CBD_BITS].sum(dim=1) - bits[:, CBD_BITS:].sum(dim=1)
    return torch.where(e < 0, e + q, e)


def sample_poly_uniform(gen: torch.Generator, moduli: list[int], n: int, device):
    """Uniform poly mod each prime -> [L, N]."""
    return torch.stack([
        torch.randint(0, q, (n,), generator=gen, device=device, dtype=torch.int64)
        for q in moduli])


def encrypt_zero_symmetric(secret_key, cd: ContextData, gen: torch.Generator):
    """NTT-form symmetric encryption of zero at level cd (SEAL
    rlwe.cpp:415-536, is_ntt_form): c1 uniform, read as NTT form directly;
    c0 = -(s·c1 + NTT(e)). Returns the [2, L, N] tensor."""
    mc = cd.mod_consts
    n = cd.parms.poly_modulus_degree
    c1 = sample_poly_uniform(gen, cd.key_moduli(), n, cd.device)
    e = ntt_mod.ntt_forward(sample_poly_cbd(gen, mc.q, n), cd.ntt_tables)
    s = secret_key.data[:cd.coeff_modulus_size]
    c0 = modring.negate_poly(
        modring.add_poly(e, modring.dyadic_product(s, c1, mc), mc), mc)
    return torch.stack([c0, c1])
