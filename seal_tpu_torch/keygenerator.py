"""Key generation: the secret and public keys, relinearization and Galois
keys, and the fork's multiparty (threshold) keys.

The port of seal_tpu/keygenerator.py (SEAL keygenerator.cpp generate_sk
:56, create_public_key, create_relin_keys :272, create_galois_keys :520,
generate_one_kswitch_key :732; the fork's generate_secret_key :95,
generate_pk_with_sk :132, generate_pk_with_same_c1 :182,
create_common_secret_key :207, create_common_public_key :239, Galois key
shares with a common c1 :404-518 and their aggregate :312-402). Every key
draws from SEAL's byte stream (rlwe.prng_for): from the parameters' random
seed when one is set, so the keys are SEAL's and seal_tpu's bit for bit,
else from a fresh seed per stream. The bytes are drawn on the host; the
transforms and products run on the context's device.
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
        return self.create_public_key_with_sk(self.secret_key_, save_seed)

    # -- the fork's multiparty surface (keygenerator.cpp:95-270) ---------------

    def generate_secret_key(self) -> SecretKey:
        """A fresh party secret key; this generator's own key stays."""
        return self._sample_secret_key()

    def create_public_key_with_sk(self, sk: SecretKey, save_seed: bool = False) -> PublicKey:
        """create_public_key under the secret key `sk`."""
        cd = self.context.key_context_data()
        data, seed = rlwe.encrypt_zero_symmetric(sk, self.context, cd)
        ct = Ciphertext(data, tuple(cd.parms_id), is_ntt_form=True)
        if save_seed:
            ct.seed_info = seed
        return PublicKey(ct)

    def create_public_key_with_same_c1(self, sk: SecretKey, ref: PublicKey) -> PublicKey:
        """A party's public key that shares the reference key's c1 (the
        common reference string): (-(c1·s + e), c1)."""
        cd = self.context.key_context_data()
        data, _ = rlwe.encrypt_zero_symmetric(sk, self.context, cd, c1_override=ref.data.poly(1))
        return PublicKey(Ciphertext(data, tuple(cd.parms_id), is_ntt_form=True))

    def create_common_secret_key(self, sks) -> SecretKey:
        """The common secret key Σ s_i (for tests: no party holds it)."""
        cd = self.context.key_context_data()
        acc = sks[0].data
        for sk in sks[1:]:
            acc = modring.add_poly(acc, sk.data, cd.mod_consts)
        return SecretKey(acc, tuple(cd.parms_id))

    def create_common_public_key(self, pks) -> PublicKey:
        """(Σ c0_i, c1) of public keys that share c1: an encryption of zero
        under the common secret key."""
        cd = self.context.key_context_data()
        c0 = pks[0].data.poly(0)
        for pk in pks[1:]:
            c0 = modring.add_poly(c0, pk.data.poly(0), cd.mod_consts)
        data = torch.stack([c0, pks[0].data.poly(1)])
        return PublicKey(Ciphertext(data, tuple(cd.parms_id), is_ntt_form=True))

    def _generate_one_kswitch_key(self, new_key: torch.Tensor, seeds: list | None = None,
                                  secret_key: SecretKey | None = None, c1_refs=None):
        """KSwitch key for `new_key` (NTT form [L_key, N]): per digit j, an
        NTT-form encryption of zero under `secret_key` (this generator's
        key by default) whose c0 rows of the digit absorb new_key · (P mod
        q_i), P the product of the special primes. Returns [d, 2, L_key,
        N]; each digit's (prng type, seed) is appended to `seeds` when it
        is a list. With c1_refs, digit j takes c1_refs[j] (NTT form [L_key,
        N]) as its c1, the fork's Galois key share under a common c1."""
        ctx = self.context
        if not ctx.using_keyswitching:
            raise RuntimeError("keyswitching is not supported by the context")
        if seeds is not None and c1_refs is not None:
            # the seed drawn would not regenerate the shared c1, so a seeded
            # save would expand to another key
            raise ValueError(
                "save_seed cannot be combined with c1 overrides: the "
                "recorded seed would not regenerate the overridden c1")
        secret_key = self.secret_key_ if secret_key is None else secret_key
        key_cd = ctx.key_context_data()
        key_moduli = key_cd.key_moduli()
        alpha = key_cd.parms.special_modulus_size
        P = 1
        for q in key_moduli[len(key_moduli) - alpha:]:
            P *= q
        mc = key_cd.mod_consts
        digits = []
        for j, rows in enumerate(digit_ranges(ctx.first_context_data().coeff_modulus_size,
                                              alpha)):
            ct, seed = rlwe.encrypt_zero_symmetric(
                secret_key, ctx, key_cd, c1_override=None if c1_refs is None else c1_refs[j])
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
                           secret_key: SecretKey | None = None, c1_refs_per_elt=None,
                           steps=None) -> GaloisKeys:
        """Keys for the automorphisms x -> x^elt, from Galois elements or
        from rotation steps (SEAL create_galois_keys(steps)); all of
        get_elts_all() when neither is given. The key list is sized to n,
        every index (elt - 1) / 2 of an odd elt < 2n.

        The fork's overloads (keygenerator.cpp:404-518): `secret_key` makes
        a party's share under that key, and c1_refs_per_elt[k] gives the c1
        of each digit of the k-th element's key (a [d, L_key, N] tensor or
        a list of d [L_key, N] ones, e.g. party 0's keys[index][:, 1])."""
        sk = self.secret_key_ if secret_key is None else secret_key
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
        for k, elt in enumerate(galois_elts):
            if elt % 2 == 0 or elt < 1:
                raise ValueError("Galois element is not valid")
            index = GaloisKeys.get_index(elt)
            key_seeds = [] if save_seed else None
            # the secret key under the automorphism, in the NTT domain
            rotated = gt.apply_galois_ntt(sk.data, elt)
            keys[index] = self._generate_one_kswitch_key(
                rotated, key_seeds, sk,
                None if c1_refs_per_elt is None else c1_refs_per_elt[k])
            if save_seed:
                seeds[index] = key_seeds
        gk = GaloisKeys(keys, tuple(self.context.key_parms_id))
        gk.seeds = seeds
        return gk

    def aggregate_galois_keys(self, galois_elts, key_shares) -> GaloisKeys:
        """The common Galois keys of the parties' shares: per element, the
        sum of every share's c0 (keys[:, 0]) and the common c1 of the first
        share. The list is sized to n, as create_galois_keys sizes it."""
        key_cd = self.context.key_context_data()
        keys = [None] * key_cd.parms.poly_modulus_degree
        for elt in galois_elts:
            index = GaloisKeys.get_index(elt)
            acc = key_shares[0].keys[index].clone()
            for share in key_shares[1:]:
                acc[:, 0] = modring.add_poly(acc[:, 0], share.keys[index][:, 0],
                                             key_cd.mod_consts)
            keys[index] = acc
        return GaloisKeys(keys, tuple(self.context.key_parms_id))
