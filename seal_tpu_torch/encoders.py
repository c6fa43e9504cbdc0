"""BatchEncoder: n slots mod t <-> the coefficients of a BFV/BGV plaintext.

The port of seal_tpu/encoders.py BatchEncoder (SEAL batchencoder.cpp):
the slot index map (powers of 3 by row, then bit reversal, :64-88), encode
as a scatter into that map followed by the inverse negacyclic NTT mod t
(:110-149), decode as the forward NTT followed by a gather. Both transforms
are K1 over the one-prime tower {t} on the context's device; encode_many
and decode_many (seal_tpu's batch API) run B vectors through one K1 launch.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Plaintext
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.galois import reverse_bits_vec


def slot_index_map(n: int) -> np.ndarray:
    """Slot i's coefficient index in the NTT-domain order: row 0 holds the
    powers 3^i of the Galois group, row 1 their negatives, both
    bit-reversed."""
    log_n = n.bit_length() - 1
    m = 2 * n
    pos = np.ones(n // 2, dtype=np.int64)
    for i in range(1, n // 2):
        pos[i] = pos[i - 1] * 3 % m
    rows = np.concatenate([(pos - 1) >> 1, (m - pos - 1) >> 1])
    return reverse_bits_vec(rows, log_n)


class BatchEncoder:
    """SIMD encoder for BFV/BGV: n slots <-> plaintext coefficients mod t."""

    def __init__(self, context: SEALContext):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        cd = context.first_context_data()
        if cd.parms.scheme not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")
        if not cd.qualifiers.using_batching:
            raise ValueError("encryption parameters are not valid for batching")
        self.context = context
        self.slots = cd.parms.poly_modulus_degree
        self._t = cd.parms.plain_modulus.value
        self._tables = cd.plain_ntt_tables
        self._index_map = torch.from_numpy(slot_index_map(self.slots)).to(context.device)

    @property
    def slot_count(self) -> int:
        return self.slots

    def _slot_values(self, values, batch: bool) -> torch.Tensor:
        """Slot values (m <= n of them, each in (-t/2, t)) as residues mod t
        [B, m], an int64 tensor on the context's device: one vector, or a
        batch [B, m]."""
        t = self._t
        if isinstance(values, torch.Tensor):
            v = values.to(torch.int64)
        else:
            try:
                v = torch.from_numpy(np.asarray(values, dtype=np.int64))
            except OverflowError:
                raise ValueError("input value is larger than plain_modulus") from None
        if not batch:
            v = v.reshape(1, -1)
        elif v.dim() != 2:
            raise ValueError("values_batch must be [B, m]")
        if v.shape[-1] > self.slots:
            raise ValueError("values_matrix size is too large")
        if v.numel() and (int(v.max()) >= t or -int(v.min()) > (t - 1) // 2):
            raise ValueError("input value is larger than plain_modulus")
        v = v.to(self.context.device)
        return torch.where(v < 0, v + t, v)

    def _encode_rows(self, v: torch.Tensor) -> torch.Tensor:
        """Residues [B, m] -> plaintext coefficients [B, N]: the scatter into
        the slot map, then one inverse NTT over t for the batch."""
        coeffs = torch.zeros((v.shape[0], 1, self.slots), dtype=torch.int64, device=v.device)
        coeffs[:, 0, self._index_map[:v.shape[1]]] = v
        return ntt_mod.ntt_inverse(coeffs, self._tables)[:, 0]

    def encode(self, values) -> Plaintext:
        """values: at most n integers, each in (-t/2, t) (negative ones
        stand for their residue mod t), as a sequence, a numpy array or an
        int64 tensor; missing slots are 0."""
        return Plaintext(self._encode_rows(self._slot_values(values, False))[0])

    def encode_many(self, values_batch) -> list[Plaintext]:
        """B slot vectors [B, m] (m <= n) as B plaintexts, bit for bit
        [encode(v) for v in values_batch]; the plaintexts are views of one
        [B, N] tensor."""
        v = self._slot_values(values_batch, True)
        return [Plaintext(row) for row in self._encode_rows(v).unbind(0)]

    def _decode_rows(self, coeffs: torch.Tensor, signed: bool) -> torch.Tensor:
        """Plaintext coefficients [B, <= N] -> slot values [B, n]: one
        forward NTT over t for the batch, then the gather."""
        padded = torch.zeros((coeffs.shape[0], 1, self.slots), dtype=torch.int64,
                             device=self._index_map.device)
        padded[:, 0, :coeffs.shape[1]] = coeffs
        values = ntt_mod.ntt_forward(padded, self._tables)[:, 0].index_select(-1, self._index_map)
        if signed:
            t = self._t
            values = torch.where(values >= (t + 1) >> 1, values - t, values)
        return values

    @staticmethod
    def _coeffs(plain: Plaintext) -> torch.Tensor:
        if plain.is_ntt_form:
            raise ValueError("plain cannot be in NTT form")
        if plain.data.dim() > 1:
            raise ValueError("decode takes one plaintext; decode_many takes a list")
        return plain.data.reshape(-1)

    def decode(self, plain: Plaintext, signed: bool = False) -> torch.Tensor:
        """The n slot values mod t of a coefficient-form plaintext as an
        int64 tensor on the context's device; signed maps the upper half
        of t to negatives."""
        return self._decode_rows(self._coeffs(plain)[:self.slots].unsqueeze(0), signed)[0]

    def decode_many(self, plains, signed: bool = False) -> torch.Tensor:
        """B plaintexts -> their slots [B, n] through one forward NTT, bit
        for bit [decode(p, signed) for p in plains]."""
        rows = [self._coeffs(p)[:self.slots] for p in plains]
        if not rows:
            return torch.empty((0, self.slots), dtype=torch.int64,
                               device=self._index_map.device)
        width = max(r.numel() for r in rows)
        coeffs = torch.zeros((len(rows), width), dtype=torch.int64,
                             device=self._index_map.device)
        for b, r in enumerate(rows):
            coeffs[b, :r.numel()] = r
        return self._decode_rows(coeffs, signed)
