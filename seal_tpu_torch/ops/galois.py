"""Galois automorphisms x -> x^elt on RNS polys.

The port of seal_tpu/ops/galois.py GaloisTool, gather route (SEAL
util/galois.{h,cpp}): the step <-> element map with generator 3, the
NTT-domain permutation tables and the coefficient-domain map with its
negacyclic sign fix. Tables are built with numpy on the host once per
element and moved to the tool's device once; applying an automorphism is one
gather over the last axis on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops.modring import ModConsts
from seal_tpu_torch.utils import numth

GENERATOR = 3


def _reverse_bits_vec(v: np.ndarray, bit_count: int) -> np.ndarray:
    """numth.reverse_bits over an int64 numpy array."""
    out = np.zeros_like(v)
    for _ in range(bit_count):
        out = (out << 1) | (v & 1)
        v = v >> 1
    return out


class GaloisTool:
    def __init__(self, coeff_count_power: int, device="cpu"):
        self.coeff_count_power = coeff_count_power
        self.coeff_count = 1 << coeff_count_power
        self.device = torch.device(device)
        self._cache: dict = {}

    def _cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    # -- step <-> element ------------------------------------------------------

    def get_elt_from_step(self, step: int) -> int:
        n = self.coeff_count
        m = 2 * n
        if step == 0:
            return m - 1
        pos = abs(step)
        if pos >= (n >> 1):
            raise ValueError("step count too large")
        return pow(GENERATOR, (n >> 1) - pos if step < 0 else pos, m)

    def get_elts_from_steps(self, steps) -> list[int]:
        return [self.get_elt_from_step(s) for s in steps]

    def get_elts_all(self) -> list[int]:
        m = 2 * self.coeff_count
        elts = [m - 1]
        pos = GENERATOR
        neg = numth.invert_uint_mod(GENERATOR, m)
        for _ in range(self.coeff_count_power - 1):
            elts.append(pos)
            pos = (pos * pos) % m
            elts.append(neg)
            neg = (neg * neg) % m
        return elts

    @staticmethod
    def get_index_from_elt(galois_elt: int) -> int:
        return (galois_elt - 1) >> 1

    def _validate(self, galois_elt: int):
        if not (galois_elt & 1) or galois_elt >= 2 * self.coeff_count:
            raise ValueError("Galois element is not valid")

    # -- tables (host numpy, int64) -----------------------------------------------

    def ntt_table(self, galois_elt: int) -> np.ndarray:
        """out[k] = in[table[k]] in the NTT domain (galois.cpp:20-51)."""
        def make():
            n, logn = self.coeff_count, self.coeff_count_power
            rev = _reverse_bits_vec(np.arange(n, 2 * n, dtype=np.int64), logn + 1)
            index_raw = ((galois_elt * rev) >> 1) & (n - 1)
            return _reverse_bits_vec(index_raw, logn)

        return self._cached(("ntt", galois_elt), make)

    def coeff_table(self, galois_elt: int):
        """(src, neg): out[k] = ±in[src[k]], negated where neg[k], in the
        coefficient domain (galois.cpp:148-190: x^i -> x^(i·elt mod 2n),
        with x^n = -1)."""
        def make():
            n = self.coeff_count
            i = np.arange(n, dtype=np.int64)
            index_raw = i * galois_elt
            index = index_raw & (n - 1)
            src = np.empty(n, dtype=np.int64)
            neg = np.empty(n, dtype=bool)
            src[index] = i
            neg[index] = ((index_raw >> self.coeff_count_power) & 1).astype(bool)
            return src, neg

        return self._cached(("coeff", galois_elt), make)

    def _on_device(self, key, make):
        return self._cached(("dev",) + key, lambda: torch.from_numpy(make()).to(self.device))

    def ntt_index(self, galois_elt: int) -> torch.Tensor:
        """The NTT-domain table as an index tensor on the tool's device."""
        self._validate(galois_elt)
        return self._on_device(("ntt", galois_elt), lambda: self.ntt_table(galois_elt))

    def ntt_inverse_index(self, galois_elt: int) -> torch.Tensor:
        """The inverse NTT-domain permutation (a stable argsort of the
        table), on the tool's device: gathers a key so that permuting the
        product afterwards equals permuting the operand before."""
        self._validate(galois_elt)
        return self._on_device(
            ("ntt_inv", galois_elt),
            lambda: np.argsort(self.ntt_table(galois_elt), kind="stable"))

    # -- application ----------------------------------------------------------------

    def apply_galois_ntt(self, x: torch.Tensor, galois_elt: int) -> torch.Tensor:
        """NTT-domain automorphism of x [..., N]: one gather."""
        return x.index_select(-1, self.ntt_index(galois_elt))

    def apply_galois(self, x: torch.Tensor, galois_elt: int, mc: ModConsts) -> torch.Tensor:
        """Coefficient-domain automorphism of x [..., L, N] with the
        negacyclic sign fix; mc holds the L moduli."""
        self._validate(galois_elt)
        src = self._on_device(("src", galois_elt), lambda: self.coeff_table(galois_elt)[0])
        neg = self._on_device(("neg", galois_elt), lambda: self.coeff_table(galois_elt)[1])
        g = x.index_select(-1, src)
        return torch.where(neg, modarith.neg_mod(g, mc.q), g)
