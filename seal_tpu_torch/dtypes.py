"""Scheme data types: Plaintext, Ciphertext, PublicKey and keys.

The port of seal_tpu/dtypes.py. Each object holds one int64 tensor whose
words are the uint64 residues (seal_tpu holds a (lo, hi) pair of uint32
arrays): [L, N] for a CKKS plaintext or a secret key, [<= N] coefficients
mod t for a BFV/BGV plaintext, [size, L, N] for a ciphertext, [d, 2, L_key,
N] per key-switching key.

A ciphertext or plaintext may carry leading batch dimensions, [B, size, L,
N], [B, L, N] or [B, <= N]: B members that share one parms_id, scale, NTT
form and correction factor, the PyTorch form of seal_tpu's jax.vmap over
the same ops (bench.py). Every Evaluator op on a batch gives, member for
member, the bits of the op on that member alone.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch.context import resolve_device
from seal_tpu_torch.encryption_params import PARMS_ID_ZERO, ParmsId


def u64_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor on any device -> uint64 numpy array of the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


class Plaintext:
    """CKKS: an RNS poly [L, N] in NTT form, with its level's parms_id and a
    scale. BFV/BGV: at most N coefficients mod t [<= N], in coefficient
    form, with no parms_id (SEAL plaintext.h). A batch has leading
    dimensions: [*batch, L, N] or [*batch, <= N].

    Plaintext(coeff_count) is seal_tpu's constructor: that many zero
    coefficients, on CUDA unless `device` names another device. The count
    and comparison methods read the tensor on its own device, one sync
    each."""

    def __init__(self, data: torch.Tensor | int | None = None,
                 parms_id: ParmsId = PARMS_ID_ZERO, scale: float = 1.0, device=None):
        if isinstance(data, int):
            data = torch.zeros(data, dtype=torch.int64, device=resolve_device(device))
        self.data = data
        self.parms_id = parms_id
        self.scale = scale

    @property
    def is_ntt_form(self) -> bool:
        return self.parms_id != PARMS_ID_ZERO

    @property
    def coeff_count(self) -> int:
        """Coefficients per polynomial: N in NTT form, else the vector's length."""
        return 0 if self.data is None else self.data.shape[-1]

    def set_values(self, values):
        """Coefficient-form values mod t (ints below 2^64), on the device of
        the current data, else on CUDA."""
        where = self.data.device if self.data is not None else resolve_device(None)
        arr = np.asarray(values, dtype=np.uint64).reshape(-1)
        self.data = torch.from_numpy(arr.view(np.int64).copy()).to(where)

    def significant_coeff_count(self) -> int:
        """Index of the last nonzero word plus one, 0 when all are zero; in
        NTT form over the L·N words, as SEAL's (plaintext.h)."""
        if self.data is None or self.data.numel() == 0:
            return 0
        flat = self.data.reshape(-1)
        pos = torch.arange(1, flat.numel() + 1, device=flat.device)
        return int(torch.where(flat != 0, pos, 0).max())

    def nonzero_coeff_count(self) -> int:
        """Nonzero words, over the L·N words in NTT form (as SEAL's)."""
        return 0 if self.data is None else int(torch.count_nonzero(self.data))

    def set_zero(self):
        """Every coefficient to zero; the shape, level and scale stay."""
        if self.data is not None:
            self.data = torch.zeros_like(self.data)

    def is_zero(self) -> bool:
        return self.data is None or not bool(self.data.any())

    def __eq__(self, other):
        """Coefficient form: the same values, the shorter one padded with
        zeros (seal_tpu). NTT form: the same level, scale and words."""
        if not isinstance(other, Plaintext):
            return NotImplemented
        if self.is_ntt_form or other.is_ntt_form:
            return (tuple(self.parms_id) == tuple(other.parms_id)
                    and self.scale == other.scale
                    and self.data.shape == other.data.shape
                    and bool(torch.equal(self.data, other.data.to(self.data.device))))
        a = self.data if self.data is not None else torch.zeros(0, dtype=torch.int64)
        b = other.data if other.data is not None else torch.zeros(0, dtype=torch.int64)
        b = b.to(a.device)
        n = max(a.shape[-1], b.shape[-1])
        pad = torch.nn.functional.pad
        return bool(torch.equal(pad(a, (0, n - a.shape[-1])), pad(b, (0, n - b.shape[-1]))))

    __hash__ = None

    def to_numpy(self) -> np.ndarray:
        return u64_numpy(self.data)

    def to_hex_string(self) -> str:
        """SEAL's polynomial string of a coefficient-form plaintext, highest
        power first, e.g. '3x^2 + 1x^1 + 2'."""
        terms = [f"{v:X}x^{i}" if i else f"{v:X}"
                 for i, v in reversed(list(enumerate(self.to_numpy().tolist()))) if v]
        return " + ".join(terms) if terms else "0"

    @staticmethod
    def from_hex_string(text: str, device=None) -> "Plaintext":
        """The coefficient-form plaintext of a SEAL polynomial string, on
        CUDA unless `device` names another device, as contexts are."""
        coeffs = {}
        text = text.strip()
        if text and text != "0":
            for term in text.split("+"):
                c, _, e = term.strip().partition("x^")
                coeffs[int(e) if e else 0] = int(c, 16)
        data = np.zeros(max(coeffs, default=-1) + 1, dtype=np.uint64)
        for e, c in coeffs.items():
            data[e] = c
        return Plaintext(torch.from_numpy(data.view(np.int64)).to(resolve_device(device)))


class Ciphertext:
    """size >= 2 polynomials over the level's tower: [size, L, N], or
    [*batch, size, L, N] for a batch (SEAL ciphertext.h)."""

    def __init__(self, data: torch.Tensor | None = None,
                 parms_id: ParmsId = PARMS_ID_ZERO, is_ntt_form: bool = False,
                 scale: float = 1.0, correction_factor: int = 1):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self.correction_factor = correction_factor
        # (prng type, seed) of c1 when the encryption was asked to keep it
        self.seed_info = None

    @property
    def size(self) -> int:
        return 0 if self.data is None else self.data.shape[-3]

    @property
    def coeff_modulus_size(self) -> int:
        return 0 if self.data is None else self.data.shape[-2]

    @property
    def poly_modulus_degree(self) -> int:
        return 0 if self.data is None else self.data.shape[-1]

    @property
    def batch_shape(self) -> tuple:
        """The leading batch dimensions; () for one ciphertext."""
        return () if self.data is None else tuple(self.data.shape[:-3])

    def poly(self, j: int) -> torch.Tensor:
        """The j-th polynomial, [*batch, L, N]."""
        return self.data[..., j, :, :]

    def polys(self, start: int, stop: int | None = None) -> torch.Tensor:
        """Polynomials start..stop-1, [*batch, count, L, N]."""
        return self.data[..., start:stop, :, :]

    def unbind(self) -> list["Ciphertext"]:
        """The members of a one-dimensional batch, each a view."""
        return [self._with(d) for d in self.data.unbind(0)]

    def _with(self, data: torch.Tensor) -> "Ciphertext":
        out = self.copy()
        out.data = data
        return out

    def to_numpy(self) -> np.ndarray:
        return u64_numpy(self.data)

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale,
                          self.correction_factor)

    def is_transparent(self) -> bool:
        """True when c1 and above are all zero: decryptable without the secret
        key (SEAL ciphertext.h is_transparent); for a batch, when any member
        is. Reads the device once."""
        if self.size < 2:
            return True
        upper = self.polys(1).reshape(self.batch_shape + (-1,))
        return bool((~upper.any(-1)).any())

    def __repr__(self):
        return (f"Ciphertext(size={self.size}, L={self.coeff_modulus_size}, "
                f"n={self.poly_modulus_degree}, ntt={self.is_ntt_form}, "
                f"scale={self.scale})")


def stack_ciphertexts(cts) -> Ciphertext:
    """One batch [B, size, L, N] of B ciphertexts with the same level,
    size, NTT form, scale and correction factor (the metadata the batch
    shares)."""
    cts = list(cts)
    if not cts:
        raise ValueError("cts cannot be empty")
    first = cts[0]
    for ct in cts[1:]:
        if (tuple(ct.parms_id) != tuple(first.parms_id) or ct.size != first.size
                or ct.is_ntt_form != first.is_ntt_form or ct.scale != first.scale
                or ct.correction_factor != first.correction_factor):
            raise ValueError("a batch needs one level, size, NTT form, scale and "
                             "correction factor")
    return first._with(torch.stack([ct.data for ct in cts]))


class SecretKey:
    """NTT-form RNS poly at the key level: [L_key, N]."""

    def __init__(self, data: torch.Tensor | None = None,
                 parms_id: ParmsId = PARMS_ID_ZERO):
        self.data = data
        self.parms_id = parms_id

    def to_numpy(self) -> np.ndarray:
        return u64_numpy(self.data)


class PublicKey:
    """A symmetric encryption of zero at the key level, in NTT form: data is
    a Ciphertext [2, L_key, N] (SEAL publickey.h)."""

    def __init__(self, data: Ciphertext | None = None):
        self.data = data

    @property
    def parms_id(self) -> ParmsId:
        return self.data.parms_id

    def to_numpy(self) -> np.ndarray:
        return self.data.to_numpy()


class KSwitchKeys:
    """keys[target] = [d, 2, L_key, N]: per decomposition digit, a size-2
    NTT-form encryption over the key-level tower (SEAL kswitchkeys.h)."""

    def __init__(self, keys=None, parms_id: ParmsId = PARMS_ID_ZERO):
        self.keys: list = list(keys or [])
        self.parms_id = parms_id
        # per key, each digit's (prng type, seed) when keygen kept them
        self.seeds = None

    @property
    def size(self) -> int:
        return len(self.keys)


class RelinKeys(KSwitchKeys):
    """Key-switching keys for s^2, s^3, ... (SEAL relinkeys.h)."""

    @staticmethod
    def get_index(key_power: int) -> int:
        if key_power < 2:
            raise ValueError("key_power cannot be less than 2")
        return key_power - 2

    def has_key(self, key_power: int) -> bool:
        i = self.get_index(key_power)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, key_power: int) -> torch.Tensor:
        return self.keys[self.get_index(key_power)]


class GaloisKeys(KSwitchKeys):
    """Key-switching keys indexed by Galois element: keys[(elt - 1) / 2],
    None where there is no key (SEAL galoiskeys.h)."""

    @staticmethod
    def get_index(galois_elt: int) -> int:
        if galois_elt < 3 or galois_elt % 2 == 0:
            raise ValueError("galois_elt is not valid")
        return (galois_elt - 1) >> 1

    def has_key(self, galois_elt: int) -> bool:
        i = self.get_index(galois_elt)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, galois_elt: int) -> torch.Tensor:
        return self.keys[self.get_index(galois_elt)]
