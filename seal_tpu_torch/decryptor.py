"""CKKS decryption: the phase c0 + c1·s + c2·s² + ... in NTT form.

The port of seal_tpu/decryptor.py's CKKS decrypt (SEAL decryptor.cpp:249
and dot_product_ct_sk). It returns the raw phase as an NTT-form plaintext;
decoding is a later slice, and like SEAL it adds no flooding noise.
"""

from __future__ import annotations

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, Plaintext, SecretKey
from seal_tpu_torch.ops import modring


class Decryptor:
    def __init__(self, context: SEALContext, secret_key: SecretKey):
        self.context = context
        self.secret_key = secret_key
        self._powers = [secret_key.data]     # s, s^2, ... over the key tower

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        if ct.size < 2:
            raise ValueError("encrypted is empty")
        if not ct.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        key_mc = self.context.key_context_data().mod_consts
        while len(self._powers) < ct.size - 1:
            self._powers.append(modring.dyadic_product(
                self._powers[-1], self._powers[0], key_mc))
        L, mc = cd.coeff_modulus_size, cd.mod_consts
        acc = ct.poly(0)
        for j in range(1, ct.size):
            acc = modring.add_poly(
                acc, modring.dyadic_product(ct.poly(j), self._powers[j - 1][:L], mc), mc)
        return Plaintext(acc, tuple(ct.parms_id), ct.scale)
