"""Decryption: CKKS to the NTT-form phase, BFV and BGV to coefficients mod
t; the invariant noise budget of BFV and BGV ciphertexts.

The port of seal_tpu/decryptor.py's decrypt and invariant_noise_budget
(SEAL decryptor.cpp: bfv_decrypt :225, ckks_decrypt :265, bgv_decrypt :300,
dot_product_ct_sk :407, invariant_noise_budget :491-560). The phase c0 +
c1·s + c2·s² + ... is formed in the ciphertext's domain; BFV rounds it
through the base {t, γ}, BGV converts it exactly to t and undoes the
correction factor. Every step runs on the context's device, and like SEAL
it adds no flooding noise. A BFV/BGV result is trimmed as seal_tpu's is:
its coefficients up to the last nonzero one, at least one.

`decrypt_many` (seal_tpu's batch API) forms one phase over the stacked
batch and reads the trim lengths of all members in one host sync; its
results are bit for bit [decrypt(ct) for ct in cts].
"""

from __future__ import annotations

import torch

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, Plaintext, SecretKey
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.ops import compose, modarith, modring, rns
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.modring import shoup_pair
from seal_tpu_torch.utils import numth


class Decryptor:
    def __init__(self, context: SEALContext, secret_key: SecretKey):
        self.context = context
        self.secret_key = secret_key
        self._powers = [secret_key.data]     # s, s^2, ... over the key tower

    def _phase(self, ct: Ciphertext, cd):
        """c0 + Σ_j c_j·s^j over the ciphertext's level, in its domain."""
        key_mc = self.context.key_context_data().mod_consts
        while len(self._powers) < ct.size - 1:
            self._powers.append(modring.dyadic_product(
                self._powers[-1], self._powers[0], key_mc))
        L, mc = cd.coeff_modulus_size, cd.mod_consts
        acc = None
        for j in range(1, ct.size):
            cj = ct.poly(j)
            if not ct.is_ntt_form:
                cj = ntt_mod.ntt_forward(cj, cd.ntt_tables, lazy=True)
            term = modring.dyadic_product(cj, self._powers[j - 1][:L], mc)
            acc = term if acc is None else modring.add_poly(acc, term, mc)
        if not ct.is_ntt_form:
            acc = ntt_mod.ntt_inverse(acc, cd.ntt_tables)
        return modring.add_poly(acc, ct.poly(0), mc)

    def _context_data(self, ct: Ciphertext):
        if ct.size < 2:
            raise ValueError("encrypted is empty")
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        ckks = cd.parms.scheme == SchemeType.CKKS
        if ckks and not ct.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        if not ckks and ct.is_ntt_form:
            raise ValueError("encrypted cannot be in NTT form")
        return cd

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        """CKKS: the NTT-form phase (a batch gives a batch). BFV/BGV: the
        trimmed coefficients mod t of one ciphertext (decrypt_many takes
        several)."""
        cd = self._context_data(ct)
        if cd.parms.scheme == SchemeType.CKKS:
            return Plaintext(self._phase(ct, cd), tuple(ct.parms_id), ct.scale)
        if ct.batch_shape:
            raise ValueError("BFV/BGV decrypt takes one ciphertext; use decrypt_many")
        return self._exact_plains(self._phase(ct, cd).unsqueeze(0), cd,
                                  [ct.correction_factor])[0]

    def decrypt_many(self, cts) -> list[Plaintext]:
        """B ciphertexts at one level and of one size decrypted as one batch
        (seal_tpu decryptor.py decrypt_many); any other list falls back to
        sequential decrypt calls. Bit for bit [decrypt(ct) for ct in cts]."""
        cts = list(cts)
        if not cts:
            return []
        first = cts[0]
        if any(ct.batch_shape for ct in cts) or not all(
                tuple(ct.parms_id) == tuple(first.parms_id) and ct.size == first.size
                and ct.is_ntt_form == first.is_ntt_form for ct in cts):
            return [self.decrypt(ct) for ct in cts]
        cd = self._context_data(first)
        stacked = Ciphertext(torch.stack([ct.data for ct in cts]), first.parms_id,
                             first.is_ntt_form)
        phase = self._phase(stacked, cd)
        if cd.parms.scheme == SchemeType.CKKS:
            return [Plaintext(p, tuple(ct.parms_id), ct.scale)
                    for p, ct in zip(phase.unbind(0), cts)]
        return self._exact_plains(phase, cd, [ct.correction_factor for ct in cts])

    def _exact_plains(self, phase, cd, factors) -> list[Plaintext]:
        """BFV/BGV phases [B, L, N] -> B trimmed plaintexts mod t, each
        BGV member's correction factor undone."""
        if cd.parms.scheme == SchemeType.BFV:
            vals = rns.decrypt_scale_and_round(phase, cd.rns_tool)[..., 0, :]
        else:
            vals = rns.decrypt_modt(phase, cd.rns_tool)[..., 0, :]
            if any(f != 1 for f in factors):
                t = cd.parms.plain_modulus.value
                op, qt = shoup_pair([[numth.invert_uint_mod(f, t)] for f in factors],
                                    [[t]] * len(factors), vals.device)
                vals = modarith.mul_mod_shoup(vals, op, qt, cd.rns_tool.t_mc.q[0])
        counts = _trimmed_counts(vals).tolist()
        return [Plaintext(v[:c].clone()) for v, c in zip(vals.unbind(0), counts)]

    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        """Bits of noise headroom left: log2(Q) minus the bits of the
        largest centered coefficient of the phase (times t for BFV), minus
        one, at least 0. The phase is composed mod Q on the device (ops/
        compose.py); for BFV each residue is first multiplied by t mod q_i,
        which composes to v·t mod Q."""
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        scheme = cd.parms.scheme
        if scheme not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")
        if ct.batch_shape:
            raise ValueError("invariant_noise_budget takes one ciphertext, not a batch")
        if ct.is_ntt_form:
            raise ValueError("encrypted cannot be in NTT form")
        phase = self._phase(ct, cd)
        if scheme == SchemeType.BFV:
            phase = modarith.mul_mod_shoup(phase, *cd.plain_consts["t_mod_q"], cd.mod_consts.q)
        c = cd.cached("compose", lambda: compose.make_compose_consts(
            cd.key_moduli(), cd.device))
        v = compose.compose(phase, c)
        # |v| centered: Q - v above Q/2
        above_half, _ = compose.sub_limbs(v, c.half)
        neg = above_half[-1] >= 0
        norm = torch.where(neg, compose.sub_limbs(c.Q, v)[0], v)
        bits = int(compose.bit_length(norm).max())
        return max(0, cd.total_coeff_modulus_bit_count - bits - 1)


def _trimmed_counts(vals: torch.Tensor) -> torch.Tensor:
    """Per row of vals [B, N]: the index of its last nonzero entry plus one,
    or 1 where the row is zero (seal_tpu decryptor.py _trimmed_plain)."""
    pos = torch.arange(1, vals.shape[-1] + 1, device=vals.device)
    return torch.where(vals != 0, pos, 0).amax(-1).clamp(min=1)
