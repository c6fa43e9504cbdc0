"""Key generation: the secret key, relinearization keys and Galois keys.

The port of seal_tpu/keygenerator.py's secret_key, create_relin_keys and
create_galois_keys (SEAL keygenerator.cpp generate_sk :56,
create_relin_keys :272, create_galois_keys :520, generate_one_kswitch_key
:732). Randomness comes from the torch.Generator
the caller passes, on the context's device.
"""

from __future__ import annotations

import torch

from seal_tpu_torch import rlwe
from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import GaloisKeys, RelinKeys, SecretKey
from seal_tpu_torch.ops import modarith, modring
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.hybrid_keyswitch import digit_ranges


class KeyGenerator:
    def __init__(self, context: SEALContext, generator: torch.Generator):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self.generator = generator
        self.secret_key_ = self._sample_secret_key()

    def _sample_secret_key(self) -> SecretKey:
        cd = self.context.key_context_data()
        s = rlwe.sample_poly_ternary(
            self.generator, cd.mod_consts.q, cd.parms.poly_modulus_degree)
        return SecretKey(ntt_mod.ntt_forward(s, cd.ntt_tables), tuple(cd.parms_id))

    def secret_key(self) -> SecretKey:
        return self.secret_key_

    def _generate_one_kswitch_key(self, new_key: torch.Tensor) -> torch.Tensor:
        """KSwitch key for `new_key` (NTT form [L_key, N]): per digit j, an
        NTT-form encryption of zero whose c0 rows of the digit absorb
        new_key · (P mod q_i), P the product of the special primes. Returns
        [d, 2, L_key, N]."""
        ctx = self.context
        if not ctx.using_keyswitching:
            raise RuntimeError("keyswitching is not supported by the context")
        key_cd = ctx.key_context_data()
        key_moduli = key_cd.key_moduli()
        alpha = key_cd.parms.special_modulus_size
        P = 1
        for q in key_moduli[len(key_moduli) - alpha:]:
            P *= q
        mc = key_cd.mod_consts
        digits = []
        for rows in digit_ranges(ctx.first_context_data().coeff_modulus_size, alpha):
            ct = rlwe.encrypt_zero_symmetric(self.secret_key_, key_cd, self.generator)
            # rows outside the digit carry factor 0: the Shoup product is 0
            f_op, f_qt = modring.shoup_pair(
                [[P % q if i in rows else 0] for i, q in enumerate(key_moduli)],
                [[q] for q in key_moduli], key_cd.device)
            ct[0] = modarith.add_mod(
                ct[0], modarith.mul_mod_shoup(new_key, f_op, f_qt, mc.q), mc.q)
            digits.append(ct)
        return torch.stack(digits)

    def create_relin_keys(self) -> RelinKeys:
        """The key for s^2 (SEAL create_relin_keys with count 1)."""
        key_cd = self.context.key_context_data()
        s = self.secret_key_.data
        s2 = modring.dyadic_product(s, s, key_cd.mod_consts)
        return RelinKeys([self._generate_one_kswitch_key(s2)],
                         tuple(self.context.key_parms_id))

    def create_galois_keys(self, galois_elts=None, steps=None) -> GaloisKeys:
        """Keys for the automorphisms x -> x^elt, from Galois elements or
        from rotation steps (SEAL create_galois_keys(steps)); all of
        get_elts_all() when neither is given. The key list is sized to n,
        every index (elt - 1) / 2 of an odd elt < 2n."""
        key_cd = self.context.key_context_data()
        gt = key_cd.galois_tool
        if steps is not None:
            if galois_elts is not None:
                raise ValueError("pass either galois_elts or steps, not both")
            galois_elts = gt.get_elts_from_steps(steps)
        if galois_elts is None:
            galois_elts = gt.get_elts_all()
        n = key_cd.parms.poly_modulus_degree
        keys = [None] * n
        for elt in galois_elts:
            if elt % 2 == 0 or elt < 1:
                raise ValueError("Galois element is not valid")
            # the secret key under the automorphism, in the NTT domain
            rotated = gt.apply_galois_ntt(self.secret_key_.data, elt)
            keys[GaloisKeys.get_index(elt)] = self._generate_one_kswitch_key(rotated)
        return GaloisKeys(keys, tuple(self.context.key_parms_id))
