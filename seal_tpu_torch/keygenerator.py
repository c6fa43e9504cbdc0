"""Key generation: the secret and public keys, relinearization and Galois
keys.

The port of seal_tpu/keygenerator.py (SEAL keygenerator.cpp generate_sk
:56, create_public_key, create_relin_keys :272, create_galois_keys :520,
generate_one_kswitch_key :732). Every key draws from SEAL's byte stream
(rlwe.prng_for): from the parameters' random seed when one is set, so the
keys are SEAL's and seal_tpu's bit for bit, else from a fresh seed per
stream. The bytes are drawn on the host; the transforms and products run
on the context's device.
"""

from __future__ import annotations

import torch

from seal_tpu_torch import rlwe
from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, GaloisKeys, PublicKey, RelinKeys, SecretKey
from seal_tpu_torch.modulus import CIPHERTEXT_SIZE_MAX
from seal_tpu_torch.ops import modarith, modring
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.hybrid_keyswitch import digit_ranges


class KeyGenerator:
    def __init__(self, context: SEALContext, secret_key: SecretKey | None = None):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self.secret_key_ = (secret_key if secret_key is not None
                            else self._sample_secret_key())
        self._sk_powers = [self.secret_key_.data]    # s, s^2, ... over the key tower

    def _sample_secret_key(self) -> SecretKey:
        cd = self.context.key_context_data()
        s = rlwe.lift(rlwe.ternary_values(rlwe.prng_for(self.context),
                                          cd.parms.poly_modulus_degree), cd.mod_consts.q)
        return SecretKey(ntt_mod.ntt_forward(s, cd.ntt_tables), tuple(cd.parms_id))

    def secret_key(self) -> SecretKey:
        return self.secret_key_

    def create_public_key(self, save_seed: bool = False) -> PublicKey:
        """An NTT-form symmetric encryption of zero at the key level; with
        save_seed the seed of its c1 is kept on it (pk.data.seed_info)."""
        cd = self.context.key_context_data()
        data, seed = rlwe.encrypt_zero_symmetric(self.secret_key_, self.context, cd)
        ct = Ciphertext(data, tuple(cd.parms_id), is_ntt_form=True)
        if save_seed:
            ct.seed_info = seed
        return PublicKey(ct)

    def _generate_one_kswitch_key(self, new_key: torch.Tensor, seeds: list | None = None):
        """KSwitch key for `new_key` (NTT form [L_key, N]): per digit j, an
        NTT-form encryption of zero whose c0 rows of the digit absorb
        new_key · (P mod q_i), P the product of the special primes. Returns
        [d, 2, L_key, N]; each digit's (prng type, seed) is appended to
        `seeds` when it is a list."""
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
            ct, seed = rlwe.encrypt_zero_symmetric(self.secret_key_, ctx, key_cd)
            if seeds is not None:
                seeds.append(seed)
            # rows outside the digit carry factor 0: the Shoup product is 0
            f_op, f_qt = modring.shoup_pair(
                [[P % q if i in rows else 0] for i, q in enumerate(key_moduli)],
                [[q] for q in key_moduli], key_cd.device)
            ct[0] = modarith.add_mod(
                ct[0], modarith.mul_mod_shoup(new_key, f_op, f_qt, mc.q), mc.q)
            digits.append(ct)
        return torch.stack(digits)

    def create_relin_keys(self, count: int = 1, save_seed: bool = False) -> RelinKeys:
        """Keys for s^2, ..., s^(count+1) (keygenerator.cpp:272-310)."""
        if not 1 <= count <= CIPHERTEXT_SIZE_MAX - 2:
            raise ValueError("invalid count")
        key_cd = self.context.key_context_data()
        while len(self._sk_powers) < count + 1:
            self._sk_powers.append(modring.dyadic_product(
                self._sk_powers[-1], self._sk_powers[0], key_cd.mod_consts))
        rk = RelinKeys(parms_id=tuple(self.context.key_parms_id))
        rk.seeds = [] if save_seed else None
        for power in range(2, count + 2):
            seeds = [] if save_seed else None
            rk.keys.append(self._generate_one_kswitch_key(self._sk_powers[power - 1], seeds))
            if save_seed:
                rk.seeds.append(seeds)
        return rk

    def create_galois_keys(self, galois_elts=None, save_seed: bool = False,
                           steps=None) -> GaloisKeys:
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
        seeds = [None] * n if save_seed else None
        for elt in galois_elts:
            if elt % 2 == 0 or elt < 1:
                raise ValueError("Galois element is not valid")
            index = GaloisKeys.get_index(elt)
            key_seeds = [] if save_seed else None
            # the secret key under the automorphism, in the NTT domain
            rotated = gt.apply_galois_ntt(self.secret_key_.data, elt)
            keys[index] = self._generate_one_kswitch_key(rotated, key_seeds)
            if save_seed:
                seeds[index] = key_seeds
        gk = GaloisKeys(keys, tuple(self.context.key_parms_id))
        gk.seeds = seeds
        return gk
