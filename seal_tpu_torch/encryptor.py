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

    def _zero_asymmetric(self, cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
        """Public-key encryption of zero at level cd: drawn at the level
        above when there is one, then switched down (encryptor.cpp:88-173):
        divided by the α special primes at the step below the key level
        with α > 1, else by the last prime (rounded for CKKS and BFV, exact
        and unchanged mod t for BGV)."""
        if self.public_key is None:
            raise RuntimeError("public key is not set")
        ctx = self.context
        prev = cd.prev_context_data
        if prev is None:
            return rlwe.encrypt_zero_asymmetric(self.public_key, ctx, cd, is_ntt_form)
        data = rlwe.encrypt_zero_asymmetric(self.public_key, ctx, prev, is_ntt_form)
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

    def _zero(self, cd: ContextData, asymmetric: bool, save_seed: bool) -> Ciphertext:
        is_ntt_form = cd.parms.scheme == SchemeType.CKKS
        seed = None
        if asymmetric:
            data = self._zero_asymmetric(cd, is_ntt_form)
        else:
            if self.secret_key is None:
                raise RuntimeError("secret key is not set")
            data, seed = rlwe.encrypt_zero_symmetric(
                self.secret_key, self.context, cd, is_ntt_form, save_seed)
        ct = Ciphertext(data, tuple(cd.parms_id), is_ntt_form)
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
        return self._encrypt_internal(plain, asymmetric=True)

    def encrypt_symmetric(self, plain: Plaintext, save_seed: bool = False) -> Ciphertext:
        """Secret-key encryption; with save_seed the seed of c1 is kept on
        the ciphertext (seed_info)."""
        return self._encrypt_internal(plain, asymmetric=False, save_seed=save_seed)

    def _encrypt_internal(self, plain: Plaintext, asymmetric: bool,
                          save_seed: bool = False) -> Ciphertext:
        ctx = self.context
        scheme = ctx.key_context_data().parms.scheme
        if scheme == SchemeType.CKKS:
            if not plain.is_ntt_form or plain.data is None:
                raise ValueError("plain must be in NTT form")
            cd = ctx.get_context_data(plain.parms_id)
            if cd is None:
                raise ValueError("plain is not valid for encryption parameters")
            rows = plain.data
        else:
            cd = ctx.first_context_data()
            m = plain_coeffs(plain, cd)
            rows = (scaled_plain_rows if scheme == SchemeType.BFV else lifted_plain_rows)(m, cd)
        ct = self._zero(cd, asymmetric, save_seed)
        ct.data = torch.cat([modring.add_poly(ct.data[:1], rows, cd.mod_consts),
                             ct.data[1:]])
        if scheme == SchemeType.CKKS:
            ct.scale = plain.scale
        return ct
