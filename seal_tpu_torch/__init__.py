"""seal_tpu_torch: the PyTorch and CUDA port of seal_tpu, for NVIDIA Hopper.

This slice ports the CKKS multiply -> relinearize -> rescale path: parameters
and context, keys, symmetric encryption, decryption to the NTT-form phase,
and the Evaluator, with the NTT and the key-switch inner product as
hand-written CUDA kernels (csrc/). Contexts live on CUDA by default; pass
device="cpu" to run the plain PyTorch versions instead.
"""

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.decryptor import Decryptor
from seal_tpu_torch.dtypes import Ciphertext, Plaintext, RelinKeys, SecretKey
from seal_tpu_torch.encryption_params import EncryptionParameters, SchemeType
from seal_tpu_torch.encryptor import Encryptor
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.keygenerator import KeyGenerator
from seal_tpu_torch.modulus import CoeffModulus, Modulus, SecLevelType

__all__ = [
    "Ciphertext", "CoeffModulus", "Decryptor", "EncryptionParameters",
    "Encryptor", "Evaluator", "KeyGenerator", "Modulus", "Plaintext",
    "RelinKeys", "SEALContext", "SchemeType", "SecLevelType", "SecretKey",
]
