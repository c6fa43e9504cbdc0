"""CKKSEncoder: slot vectors in C^{n/2} <-> plaintexts in Z[X]/(X^n + 1).

The port of seal_tpu/ckks.py's host encoder (SEAL ckks.{h,cpp}): the slot
order of the 3^i index map (ckks.cpp:31-50), encode as the inverse DWT with
scale/n merged into its last stage, rounding half away from zero, the
reduction of each coefficient mod every prime and the forward NTT
(ckks.h:448-630); decode as the inverse NTT, the CRT composition, SEAL's
word-by-word signed double accumulation of the centered value and the
forward DWT (ckks.h:635-737). It is SEAL's encoder bit for bit, including
the float64 rounding, and all of it runs on the context's device: the DWT
stages as float64 tensor ops (utils/dwt.py), the NTTs through K1, the
composition in 32-bit limbs (ops/compose.py). Only the root tables are
built on the host, once per encoder.

seal_tpu's encode_device / decode_device emulate float64 with two or three
float32 words, since the TPU has none; the card computes float64 itself, so
here they are the same functions as encode and decode.

encode_many / decode_many (seal_tpu's batch API) run the same stages over
[B, ...] tensors, one launch per stage for the whole batch, in the same
float64 rounding order, so each member's bits are its own encode's or
decode's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from seal_tpu_torch.context import ContextData, SEALContext
from seal_tpu_torch.dtypes import Plaintext
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.ops import compose, modarith
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.galois import reverse_bits_vec
from seal_tpu_torch.ops.modring import u64_tensor
from seal_tpu_torch.utils import dwt

_TWO_POW_32 = 4294967296.0
_TWO_POW_64 = 18446744073709551616.0


def slot_index_map(n: int) -> np.ndarray:
    """matrix_reps_index_map (ckks.cpp:31-50): slot i's position in the
    bit-reversed DWT input is rev((3^i mod 2n - 1) / 2); the second half
    holds the conjugates at rev(n - 1 - (3^i mod 2n - 1) / 2)."""
    m = 2 * n
    pos = np.ones(n // 2, dtype=np.int64)
    for i in range(1, n // 2):
        pos[i] = pos[i - 1] * 3 % m
    bins = (pos - 1) >> 1
    log_n = n.bit_length() - 1
    return np.concatenate([reverse_bits_vec(bins, log_n),
                           reverse_bits_vec(n - 1 - bins, log_n)])


class CKKSEncoder:
    def __init__(self, context: SEALContext):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        self.context = context
        self.n = cd.parms.poly_modulus_degree
        self.slots = self.n >> 1
        dev = context.device
        self._index_map = torch.from_numpy(slot_index_map(self.n)).to(dev)
        roots, inv_roots = dwt.encoder_root_tables(self.n)
        self._roots = tuple(torch.from_numpy(a).to(dev) for a in roots)
        self._inv_roots = tuple(torch.from_numpy(a).to(dev) for a in inv_roots)

    @property
    def slot_count(self) -> int:
        return self.slots

    def _context_data(self, parms_id) -> ContextData:
        cd = self.context.get_context_data(
            self.context.first_parms_id if parms_id is None else parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        return cd

    @staticmethod
    def _check_scale(scale: float, cd: ContextData):
        if scale <= 0 or (int(np.log2(scale)) + 1) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

    # -- encode ---------------------------------------------------------------

    def _encode_constant(self, coeff: int, cd: ContextData, scale: float) -> Plaintext:
        """A constant polynomial: its NTT is the same value in every slot,
        so each row is a fill of coeff mod q_i, with no transform and no
        rounding (ckks.cpp:75-214 for doubles, :216-270 for int64)."""
        if abs(coeff).bit_length() + 2 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded value is too large")
        rows = u64_tensor([[coeff % q] for q in cd.key_moduli()], cd.device)
        return Plaintext(rows.expand(-1, self.n).contiguous(), tuple(cd.parms_id), float(scale))

    def encode_int(self, value: int, parms_id=None) -> Plaintext:
        """An exact integer at scale 1 (ckks.cpp:216-270)."""
        return self._encode_constant(int(value), self._context_data(parms_id), 1.0)

    def encode(self, values, scale: float, parms_id=None) -> Plaintext:
        """values: a real scalar (an exact constant), a complex scalar (in
        every slot), or up to n/2 real or complex values, as a sequence, a
        numpy array or a tensor."""
        cd = self._context_data(parms_id)
        if np.isscalar(values) and not isinstance(values, complex):
            self._check_scale(scale, cd)
            return self._encode_constant(
                dwt.round_half_away_scalar(float(values) * scale), cd, scale)
        if np.isscalar(values):
            values = [values] * self.slots
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.asarray(values, dtype=np.complex128).reshape(-1))
        values = values.to(self.context.device, torch.complex128).reshape(1, -1)
        if values.shape[1] > self.slots:
            raise ValueError("values_size is too large")
        self._check_scale(scale, cd)
        return Plaintext(self._encode_rows(values, scale, cd)[0], tuple(cd.parms_id),
                         float(scale))

    def encode_many(self, values_batch, scale: float, parms_id=None) -> list[Plaintext]:
        """B slot vectors [B, m] at one scale and level, as one batch through
        every stage. Bit for bit [encode(v, scale) for v in values_batch];
        the plaintexts are views of one [B, L, N] tensor."""
        cd = self._context_data(parms_id)
        if isinstance(values_batch, torch.Tensor):
            values = values_batch.to(self.context.device, torch.complex128)
        else:
            values = torch.from_numpy(np.asarray(values_batch, dtype=np.complex128)).to(
                self.context.device)
        if values.dim() != 2:
            raise ValueError("values_batch must be [B, m]")
        if values.shape[1] > self.slots:
            raise ValueError("values_size is too large")
        self._check_scale(scale, cd)
        if values.shape[0] == 0:
            return []
        rows = self._encode_rows(values, scale, cd)
        return [Plaintext(r, tuple(cd.parms_id), float(scale)) for r in rows.unbind(0)]

    def _encode_rows(self, values: torch.Tensor, scale: float, cd: ContextData) -> torch.Tensor:
        """Complex values [B, k] on the device -> NTT-form rows [B, L, N]."""
        # the values at the bit-reversed index map, their conjugates in the
        # upper half (ckks.h:493-502)
        B, k = values.shape
        n, dev = self.n, cd.device
        re = torch.zeros((B, n), dtype=torch.float64, device=dev)
        im = torch.zeros((B, n), dtype=torch.float64, device=dev)
        re[:, self._index_map[:k]] = values.real
        im[:, self._index_map[:k]] = values.imag
        re[:, self._index_map[self.slots:self.slots + k]] = values.real
        im[:, self._index_map[self.slots:self.slots + k]] = -values.imag
        dwt.transform_from_rev(re, im, self._inv_roots, scalar=scale / float(n))

        # the bit count of each member's largest unrounded coefficient
        # (ckks.h:504-515), read in one sync
        for max_coeff in re.abs().amax(-1).tolist():
            max_bits = int(math.ceil(math.log2(max(max_coeff, 1.0)))) + 1
            if max_bits >= cd.total_coeff_modulus_bit_count:
                raise ValueError("encoded values are too large")
        rows = self._reduce(dwt.round_half_away(re), cd)
        return ntt_mod.ntt_forward(rows, cd.ntt_tables)

    def _reduce(self, coeffs: torch.Tensor, cd: ContextData) -> torch.Tensor:
        """Integral doubles [..., N] -> their residues [..., L, N]. Below
        2^63 a value converts to int64 exactly; above, m·2^e with m < 2^53
        (torch.frexp, exact) reduces as (m mod q)·(2^e mod q). A negative
        value takes q - (|v| mod q)."""
        pow2 = cd.cached("pow2_mod_q", lambda: _pow2_mod_q(cd))
        mc = cd.mod_consts
        L, E = pow2.shape
        a = coeffs.abs()
        small = (a < 2.0 ** 63).unsqueeze(-2)
        mant, exp = torch.frexp(a)
        m = torch.where(a < 2.0 ** 63, a, mant * 2.0 ** 53).to(torch.int64)
        r = modarith.barrett_reduce_64(m.unsqueeze(-2), mc.q, mc.ratio1)     # [..., L, N]
        e = (exp.to(torch.int64) - 53).clamp(0, E - 1).unsqueeze(-2)
        rows = torch.arange(L, device=e.device).unsqueeze(-1) * E
        p2 = pow2.reshape(-1)[e + rows]
        r = torch.where(small, r, modarith.mul_mod(r, p2, mc.q, mc.ratio0, mc.ratio1))
        return torch.where(coeffs.unsqueeze(-2) < 0, modarith.neg_mod(r, mc.q), r)

    # -- decode ---------------------------------------------------------------

    def decode(self, plain: Plaintext, complex_out: bool = False) -> torch.Tensor:
        """The n/2 slot values of an NTT-form plaintext, float64 (complex128
        with complex_out) on the context's device; [*batch, n/2] for a
        batch."""
        if plain.data is None or not plain.is_ntt_form:
            raise ValueError("plain is not valid for CKKS decoding")
        cd = self.context.get_context_data(plain.parms_id)
        if cd is None:
            raise ValueError("plain is not valid for encryption parameters")
        c = cd.cached("compose", lambda: compose.make_compose_consts(cd.key_moduli(), cd.device))
        v = compose.compose(ntt_mod.ntt_inverse(plain.data, cd.ntt_tables), c)
        lead = plain.data.shape[:-2]
        vals = _center_accumulate(v.reshape(c.words, -1), c, 1.0 / plain.scale)
        vals = vals.reshape(lead + (self.n,))
        im = torch.zeros_like(vals)
        dwt.transform_to_rev(vals, im, self._roots)
        sel = self._index_map[:self.slots]
        if complex_out:
            return torch.complex(vals[..., sel], im[..., sel])
        return vals[..., sel]

    def decode_many(self, plains, complex_out: bool = False) -> torch.Tensor:
        """B plaintexts at one level and scale decoded as one batch ->
        [B, n/2]; bit for bit [decode(p) for p in plains], which mixed
        levels or scales fall back to."""
        plains = list(plains)
        if not plains:
            return torch.empty((0, self.slots), device=self.context.device,
                               dtype=torch.complex128 if complex_out else torch.float64)
        first = plains[0]
        if all(p.data is not None and p.is_ntt_form and p.data.dim() == 2
               and tuple(p.parms_id) == tuple(first.parms_id) and p.scale == first.scale
               for p in plains):
            stacked = Plaintext(torch.stack([p.data for p in plains]), first.parms_id,
                                first.scale)
            return self.decode(stacked, complex_out)
        return torch.stack([self.decode(p, complex_out) for p in plains])

    encode_device = encode
    decode_device = decode


def _pow2_mod_q(cd: ContextData) -> torch.Tensor:
    """2^e mod q_i [L, E] for every exponent e a coefficient below Q can
    have."""
    E = cd.total_coeff_modulus_bit_count + 1
    return u64_tensor([[pow(2, e, q) for e in range(E)] for q in cd.key_moduli()], cd.device)


def _center_accumulate(v: torch.Tensor, c: compose.ComposeConsts, inv_scale: float):
    """SEAL's float reconstruction (ckks.h:694-731) of composed values v
    (32-bit limbs [W, N], below Q): at or above (Q + 1)/2 the value is
    negative, and word by word (64 bits) res += (w - q_w)·s where the word
    of v is the larger, else res -= (q_w - w)·s, with no borrow between
    words; below, res += w·s. s starts at inv_scale and doubles by 2^64 a
    word. A u64 word becomes a double with one rounding: hi·2^32 + lo, both
    terms exact."""
    W = v.shape[0]
    neg = compose.sub_limbs(v, c.half)[1].logical_not()
    a, b = v, torch.where(neg, c.Q, 0)
    res = torch.zeros(v.shape[1], dtype=torch.float64, device=v.device)
    s = inv_scale
    for k in range(0, W - 1, 2):
        a_lo, a_hi, b_lo, b_hi = a[k], a[k + 1], b[k], b[k + 1]
        a_big = (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo > b_lo))
        x_lo = torch.where(a_big, a_lo, b_lo)
        x_hi = torch.where(a_big, a_hi, b_hi)
        y_lo = torch.where(a_big, b_lo, a_lo)
        y_hi = torch.where(a_big, b_hi, a_hi)
        d_lo = x_lo - y_lo
        d_hi = x_hi - y_hi + (d_lo >> 32)                 # borrow inside the word
        d = (d_hi & 0xFFFFFFFF).to(torch.float64) * _TWO_POW_32 \
            + (d_lo & 0xFFFFFFFF).to(torch.float64)
        term = d * s
        res = torch.where(a_big | ~neg, res + term, res - term)
        s *= _TWO_POW_64
    return res
