"""seal_tpu_torch: the PyTorch and CUDA port of seal_tpu, for NVIDIA Hopper.

It ports CKKS (CKKSEncoder, multiply -> relinearize -> rescale, rotations,
plain ops) and the exact schemes BFV and BGV (BatchEncoder, BEHZ and BGV
multiply, relinearize, mod switch, rotate_rows / rotate_columns, plain ops,
the invariant noise budget): parameters and context, SEAL's seeded byte
stream (randomgen.py; parms.set_random_seed makes every key and ciphertext
SEAL's bit for bit), keys (secret, public, relinearization, Galois),
public-key and symmetric encryption, decryption, and the Evaluator, with the
NTT and both routes of the key-switch inner product (128-bit sum, Shoup
quotients) as hand-written CUDA kernels (csrc/); the fork's multiparty
(threshold) keys and decryption; SEAL's wire format (serialization.py,
ComprMode) and validity checks (valcheck.py); CUDA graphs (jit.py) and
the flags (config.py). Contexts live on CUDA by
default; pass device="cpu" to run the plain PyTorch versions instead.
"""

from seal_tpu_torch.ckks import CKKSEncoder
from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.decryptor import Decryptor
from seal_tpu_torch.encoders import BatchEncoder
from seal_tpu_torch.dtypes import (
    Ciphertext, GaloisKeys, KSwitchKeys, Plaintext, PublicKey, RelinKeys, SecretKey)
from seal_tpu_torch.encryption_params import EncryptionParameters, SchemeType, parms_id_zero
from seal_tpu_torch.encryptor import Encryptor
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.jit import JitEvaluator
from seal_tpu_torch.keygenerator import KeyGenerator
from seal_tpu_torch.modulus import CoeffModulus, Modulus, PlainModulus, SecLevelType
from seal_tpu_torch.randomgen import PrngType
from seal_tpu_torch import config, serialization, valcheck
from seal_tpu_torch.serialization import ComprMode
from seal_tpu_torch.valcheck import (
    is_buffer_valid, is_data_valid_for, is_metadata_valid_for, is_valid_for)

__all__ = [
    "BatchEncoder", "CKKSEncoder", "Ciphertext", "CoeffModulus", "ComprMode", "Decryptor",
    "EncryptionParameters", "Encryptor", "Evaluator", "GaloisKeys", "JitEvaluator",
    "KSwitchKeys", "KeyGenerator", "Modulus", "PlainModulus", "Plaintext", "PrngType", "PublicKey",
    "RelinKeys", "SEALContext", "SchemeType", "SecLevelType", "SecretKey",
    "config", "is_buffer_valid", "is_data_valid_for", "is_metadata_valid_for",
    "is_valid_for", "parms_id_zero", "serialization", "valcheck",
]
