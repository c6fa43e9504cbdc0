"""Encryptor: public-key (asymmetric) and secret-key (symmetric) encryption
for CKKS, BFV and BGV.

The port of seal_tpu/encryptor.py (SEAL encryptor.cpp: encrypt_zero_internal
:88, with the modulus switch that brings an encryption of zero at the level
above down to its level, and encrypt_internal :175-253). An encryption is an
encryption of zero plus the plaintext in c0: CKKS adds the NTT-form
plaintext at its own level, BFV its Δ-scaled embedding
(util/scalingvariant.cpp), BGV the coefficients themselves (the noise of a
BGV encryption of zero is t·e), both at the first level. Randomness comes
from SEAL's byte stream (rlwe.py); every step after the draw runs on the
context's device.

encrypt_many / encrypt_symmetric_many (seal_tpu's batch API) draw each
member's bytes on the host in the order of sequential calls, move the
batch's draws to the device together and run every transform once for the
batch: bit for bit B sequential calls, as a list of views of one stacked
tensor.
"""

from __future__ import annotations

import torch

from seal_tpu_torch import rlwe
from seal_tpu_torch.context import ContextData, SEALContext
from seal_tpu_torch.dtypes import Ciphertext, Plaintext, PublicKey, SecretKey
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.ops import hybrid_keyswitch as hyb
from seal_tpu_torch.ops import modring, rns
from seal_tpu_torch.plain_lift import lifted_plain_rows, plain_coeffs, scaled_plain_rows


class Encryptor:
    """Encrypts with a public key, a secret key, or both (SEAL's
    constructors (ctx, pk), (ctx, sk) and (ctx, pk, sk))."""

    def __init__(self, context: SEALContext, key, secret_key: SecretKey | None = None):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self.public_key: PublicKey | None = None
        self.secret_key: SecretKey | None = None
        self.set_key(key)
        if secret_key is not None:
            self.set_key(secret_key)

    def set_key(self, key):
        if isinstance(key, PublicKey):
            self.public_key = key
        elif isinstance(key, SecretKey):
            self.secret_key = key
        else:
            raise TypeError("key must be a PublicKey or SecretKey")

    set_public_key = set_key
    set_secret_key = set_key

    # -- encryptions of zero -----------------------------------------------------

    def _zero_asymmetric(self, cd: ContextData, is_ntt_form: bool,
                         count: int | None = None) -> torch.Tensor:
        """Public-key encryption of zero at level cd: drawn at the level
        above when there is one, then switched down (encryptor.cpp:88-173):
        divided by the α special primes at the step below the key level
        with α > 1, else by the last prime (rounded for CKKS and BFV, exact
        and unchanged mod t for BGV). With count=B, a batch [B, 2, L, N]."""
        if self.public_key is None:
            raise RuntimeError("public key is not set")
        ctx = self.context
        prev = cd.prev_context_data
        if prev is None:
            return rlwe.encrypt_zero_asymmetric(self.public_key, ctx, cd, is_ntt_form, count)
        data = rlwe.encrypt_zero_asymmetric(self.public_key, ctx, prev, is_ntt_form, count)
        scheme = cd.parms.scheme
        key_cd = ctx.key_context_data()
        alpha = key_cd.parms.special_modulus_size
        L = cd.coeff_modulus_size
        if alpha > 1 and tuple(prev.parms_id) == tuple(ctx.key_parms_id):
            key_moduli = tuple(key_cd.key_moduli())
            t_mod = cd.parms.plain_modulus.value if scheme == SchemeType.BGV else 0
            c = ctx.on_device(("tail", L, t_mod),
                              lambda: hyb.tail_consts(key_moduli, alpha, L, t_mod))
            special = key_cd.ntt_rows(slice(len(key_moduli) - alpha, len(key_moduli)))
            return hyb.mod_down(data, c, cd.ntt_tables, special, cd.mod_consts,
                                ntt_out=is_ntt_form, ntt_in=is_ntt_form)
        if is_ntt_form:
            return rns.divide_and_round_q_last_ntt(
                data, prev.rescale_consts, cd.ntt_tables, prev.ntt_rows(slice(L, L + 1)))
        if scheme == SchemeType.BGV:
            return rns.mod_t_and_divide_q_last(data, prev.rns_tool, prev.rescale_consts)
        return rns.divide_and_round_q_last(data, prev.rescale_consts, cd.mod_consts,
                                           prev.mod_consts.rows(slice(L, L + 1)))

    def _zero_data(self, cd: ContextData, asymmetric: bool, save_seed: bool,
                   count: int | None = None):
        """(data, seed of c1 or None): one encryption of zero at level cd,
        or with count=B a batch [B, 2, L, N] and B seeds."""
        is_ntt_form = cd.parms.scheme == SchemeType.CKKS
        if asymmetric:
            return self._zero_asymmetric(cd, is_ntt_form, count), None
        if self.secret_key is None:
            raise RuntimeError("secret key is not set")
        return rlwe.encrypt_zero_symmetric(self.secret_key, self.context, cd, is_ntt_form,
                                           save_seed, count)

    def _zero(self, cd: ContextData, asymmetric: bool, save_seed: bool) -> Ciphertext:
        data, seed = self._zero_data(cd, asymmetric, save_seed)
        ct = Ciphertext(data, tuple(cd.parms_id), cd.parms.scheme == SchemeType.CKKS)
        if save_seed:
            ct.seed_info = seed
        return ct

    def _level(self, parms_id) -> ContextData:
        cd = self.context.get_context_data(
            self.context.first_parms_id if parms_id is None else parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        return cd

    def encrypt_zero(self, parms_id=None) -> Ciphertext:
        """A public-key encryption of zero at parms_id (the first level by
        default)."""
        return self._zero(self._level(parms_id), True, False)

    def encrypt_zero_symmetric(self, parms_id=None, save_seed: bool = False) -> Ciphertext:
        return self._zero(self._level(parms_id), False, save_seed)

    # -- encryptions of a plaintext ----------------------------------------------

    def encrypt(self, plain: Plaintext) -> Ciphertext:
        """Public-key encryption."""
        return self._encrypt_many([plain], asymmetric=True)[0]

    def encrypt_symmetric(self, plain: Plaintext, save_seed: bool = False) -> Ciphertext:
        """Secret-key encryption; with save_seed the seed of c1 is kept on
        the ciphertext (seed_info)."""
        return self._encrypt_many([plain], asymmetric=False, save_seed=save_seed)[0]

    def encrypt_many(self, plains) -> list[Ciphertext]:
        """Public-key encryption of B plaintexts as one batch (seal_tpu
        encryptor.py encrypt_many); bit for bit [encrypt(p) for p in plains]."""
        return self._encrypt_many(list(plains), asymmetric=True)

    def encrypt_symmetric_many(self, plains, save_seed: bool = False) -> list[Ciphertext]:
        """Secret-key twin of encrypt_many."""
        return self._encrypt_many(list(plains), asymmetric=False, save_seed=save_seed)

    def _plain_rows(self, plains: list):
        """(level, rows [B, L, N] added to c0 of each member): CKKS
        plaintexts at one common level as they are, BFV's Δ-embedded and
        BGV's lifted coefficients at the first level."""
        ctx = self.context
        scheme = ctx.key_context_data().parms.scheme
        if any(p.data is not None and p.data.dim() > (2 if scheme == SchemeType.CKKS else 1)
               for p in plains):
            raise ValueError("each plaintext encrypts to one ciphertext: pass a batch as a list")
        if scheme != SchemeType.CKKS:
            cd = ctx.first_context_data()
            m = torch.stack([plain_coeffs(p, cd) for p in plains])
            return cd, (scaled_plain_rows if scheme == SchemeType.BFV else lifted_plain_rows)(m, cd)
        for plain in plains:
            if not plain.is_ntt_form or plain.data is None:
                raise ValueError("plain must be in NTT form")
            if tuple(plain.parms_id) != tuple(plains[0].parms_id):
                raise ValueError("encrypt_many requires one common level")
        cd = ctx.get_context_data(plains[0].parms_id)
        if cd is None:
            raise ValueError("plain is not valid for encryption parameters")
        return cd, torch.stack([p.data for p in plains])

    def _encrypt_many(self, plains: list, asymmetric: bool,
                      save_seed: bool = False) -> list[Ciphertext]:
        if not plains:
            return []
        cd, rows = self._plain_rows(plains)
        data, seeds = self._zero_data(cd, asymmetric, save_seed, len(plains))
        data = torch.cat([modring.add_poly(data[:, :1], rows.unsqueeze(1), cd.mod_consts),
                          data[:, 1:]], dim=1)
        is_ntt_form = cd.parms.scheme == SchemeType.CKKS
        cts = []
        for b, plain in enumerate(plains):
            ct = Ciphertext(data[b], tuple(cd.parms_id), is_ntt_form,
                            plain.scale if is_ntt_form else 1.0)
            if save_seed:
                ct.seed_info = seeds[b]
            cts.append(ct)
        return cts
