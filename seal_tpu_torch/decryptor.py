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

The fork's threshold decryption (decryptor.cpp: distributed_decrypt :139,
aggregate_partial_decryption :89): each party's share c1·s_i, optionally
smudged with fresh uniform noise of a chosen width (the fork adds none),
and c0 + Σ shares through the scheme's decrypt tail, for any number of
parties. `decrypt(flood_bits=)` floods a CKKS decryption the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch import randomgen
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

    def dot_product_ct_sk(self, ct: Ciphertext) -> torch.Tensor:
        """c0 + c1·s + c2·s² + ... over the ciphertext's level, in its
        domain (decryptor.cpp:407-489)."""
        return self._phase(ct, self.context.get_context_data(ct.parms_id))

    def _smudging_rows(self, cd, bits: int) -> torch.Tensor:
        """Fresh uniform noise e in [-2^bits, 2^bits) at level cd, lifted to
        its primes in the coefficient domain, [L, N] on the device. Per
        coefficient (bits + 7) // 8 + 1 little-endian bytes of an unseeded
        stream, then mod 2^(bits+1) minus 2^bits, as seal_tpu draws it."""
        n = cd.parms.poly_modulus_degree
        moduli = cd.key_moduli()
        nbytes = (bits + 7) // 8 + 1
        raw = np.frombuffer(randomgen.UniformRandomGeneratorFactory().create().generate(
            n * nbytes), dtype=np.uint8).reshape(n, nbytes)
        if bits + 1 <= 62:
            # the low bits + 1 bits come from the first 8 bytes at most
            low = np.zeros((n, 8), dtype=np.uint8)
            take = min(nbytes, 8)
            low[:, :take] = raw[:, :take]
            words = low.view("<u8")[:, 0] & np.uint64((1 << (bits + 1)) - 1)
            e = words.astype(np.int64) - (1 << bits)
            rows = np.stack([np.mod(e, q) for q in moduli]).astype(np.int64)
        else:
            e = [int.from_bytes(r.tobytes(), "little") % (1 << (bits + 1)) - (1 << bits)
                 for r in raw]
            rows = np.array([[x % q for x in e] for q in moduli], dtype=np.uint64).view(np.int64)
        return torch.from_numpy(rows).to(cd.device)

    def decrypt(self, ct: Ciphertext, flood_bits: int = 0) -> Plaintext:
        """CKKS: the NTT-form phase (a batch gives a batch). BFV/BGV: the
        trimmed coefficients mod t of one ciphertext (decrypt_many takes
        several).

        flood_bits > 0 (CKKS only, one ciphertext) adds fresh uniform noise
        in [-2^flood_bits, 2^flood_bits) to the phase, the noise-flooding
        countermeasure of Li and Micciancio (Eurocrypt 2021): a CKKS
        decryption shown to anyone who did not encrypt leaks the secret key
        through the exact noise unless it is flooded. SEAL has no
        counterpart."""
        if flood_bits and self.context.key_context_data().parms.scheme != SchemeType.CKKS:
            if ct.size < 2:
                raise ValueError("encrypted is empty")
            raise ValueError(
                "flood_bits is a CKKS-only countermeasure (exact-scheme "
                "decryptions do not expose the noise)")
        cd = self._context_data(ct)
        if cd.parms.scheme == SchemeType.CKKS:
            phase = self._phase(ct, cd)
            if flood_bits > 0:
                if ct.batch_shape:
                    raise ValueError("flood_bits takes one ciphertext, not a batch")
                noise = ntt_mod.ntt_forward(self._smudging_rows(cd, flood_bits), cd.ntt_tables)
                phase = modring.add_poly(phase, noise, cd.mod_consts)
            return Plaintext(phase, tuple(ct.parms_id), ct.scale)
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

    # -- the fork's threshold decryption -------------------------------------

    def distributed_decrypt(self, ct: Ciphertext, smudging_bits: int = 0) -> Ciphertext:
        """This party's share of a threshold decryption: c1·s_i in the
        ciphertext's domain (a coefficient-form c1 through one forward and
        one inverse NTT), plus fresh noise in [-2^smudging_bits,
        2^smudging_bits) when smudging_bits > 0 (NTT'd for an NTT-form
        ciphertext). Returned as a ciphertext whose two polynomials are the
        share, with the input's metadata, as the fork returns it."""
        if ct.size != 2:
            raise ValueError("distributed decryption requires size-2 ciphertexts")
        if ct.batch_shape:
            raise ValueError("distributed_decrypt takes one ciphertext, not a batch")
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        mc, tables = cd.mod_consts, cd.ntt_tables
        c1 = ct.poly(1)
        if not ct.is_ntt_form:
            c1 = ntt_mod.ntt_forward(c1, tables, lazy=True)
        part = modring.dyadic_product(c1, self._powers[0][:cd.coeff_modulus_size], mc)
        if not ct.is_ntt_form:
            part = ntt_mod.ntt_inverse(part, tables)
        if smudging_bits > 0:
            noise = self._smudging_rows(cd, smudging_bits)
            if ct.is_ntt_form:
                noise = ntt_mod.ntt_forward(noise, tables)
            part = modring.add_poly(part, noise, mc)
        return Ciphertext(torch.stack([part, part]), tuple(ct.parms_id), ct.is_ntt_form,
                          ct.scale, ct.correction_factor)

    def aggregate_partial_decryption(self, ct: Ciphertext, partials) -> Plaintext:
        """c0 + Σ shares, decrypted as `decrypt` would the phase: BFV through
        the {t, γ} rounding, BGV to t with the correction factor undone
        (both trimmed), CKKS the NTT-form plaintext at the ciphertext's
        level and scale. Any number of parties."""
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        if ct.batch_shape:
            raise ValueError("aggregate_partial_decryption takes one ciphertext, not a batch")
        acc = ct.poly(0)
        for p in partials:
            acc = modring.add_poly(acc, p.poly(0), cd.mod_consts)
        if cd.parms.scheme == SchemeType.CKKS:
            return Plaintext(acc, tuple(ct.parms_id), ct.scale)
        return self._exact_plains(acc.unsqueeze(0), cd, [ct.correction_factor])[0]

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
