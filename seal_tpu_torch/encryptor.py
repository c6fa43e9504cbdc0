"""Symmetric encryption of NTT-form CKKS plaintexts.

The port of seal_tpu/encryptor.py encrypt_symmetric for CKKS (SEAL
encryptor.cpp): an encryption of zero at the plaintext's level plus the
plaintext in c0.
"""

from __future__ import annotations

import torch

from seal_tpu_torch import rlwe
from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, Plaintext, SecretKey
from seal_tpu_torch.ops import modring


class Encryptor:
    def __init__(self, context: SEALContext, secret_key: SecretKey,
                 generator: torch.Generator):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self.secret_key = secret_key
        self.generator = generator

    def encrypt_symmetric(self, plain: Plaintext) -> Ciphertext:
        if not plain.is_ntt_form or plain.data is None:
            raise ValueError("plain must be in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        if cd is None:
            raise ValueError("plain is not valid for encryption parameters")
        ct = rlwe.encrypt_zero_symmetric(self.secret_key, cd, self.generator)
        ct[0] = modring.add_poly(ct[0], plain.data, cd.mod_consts)
        return Ciphertext(ct, tuple(cd.parms_id), is_ntt_form=True, scale=plain.scale)
