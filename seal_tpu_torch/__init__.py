"""seal_tpu_torch: the PyTorch and CUDA port of seal_tpu, for NVIDIA Hopper.

It ports the CKKS multiply -> relinearize -> rescale path and CKKS rotations:
parameters and context, keys (relinearization and Galois), symmetric
encryption, decryption to the NTT-form phase, and the Evaluator, with the
NTT and both routes of the key-switch inner product (128-bit sum, Shoup
quotients) as hand-written CUDA kernels (csrc/). Contexts live on CUDA by
default; pass device="cpu" to run the plain PyTorch versions instead.
"""

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.decryptor import Decryptor
from seal_tpu_torch.dtypes import Ciphertext, GaloisKeys, Plaintext, RelinKeys, SecretKey
from seal_tpu_torch.encryption_params import EncryptionParameters, SchemeType
from seal_tpu_torch.encryptor import Encryptor
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.keygenerator import KeyGenerator
from seal_tpu_torch.modulus import CoeffModulus, Modulus, SecLevelType

__all__ = [
    "Ciphertext", "CoeffModulus", "Decryptor", "EncryptionParameters",
    "Encryptor", "Evaluator", "GaloisKeys", "KeyGenerator", "Modulus", "Plaintext",
    "RelinKeys", "SEALContext", "SchemeType", "SecLevelType", "SecretKey",
]
