"""SEALContext: parameter validation, the modulus-switching chain and the
per-level constants on the context's device.

The port of seal_tpu/context.py for CKKS (SEAL context.{h,cpp}). Every tensor
the context builds lives on its device, which defaults to CUDA: without a
card the caller must ask for the CPU (`device="cpu"`), where every kernel
runs as its plain PyTorch version.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from seal_tpu_torch.encryption_params import (
    PARMS_ID_ZERO, EncryptionParameters, ParmsId, SchemeType)
from seal_tpu_torch.modulus import (
    COEFF_MOD_COUNT_MAX, COEFF_MOD_COUNT_MIN, POLY_MOD_DEGREE_MAX,
    POLY_MOD_DEGREE_MIN, USER_MOD_BIT_COUNT_MAX, USER_MOD_BIT_COUNT_MIN,
    CoeffModulus, SecLevelType)
from seal_tpu_torch.utils import numth


_root = functools.lru_cache(maxsize=None)(numth.try_minimal_primitive_root)


def resolve_device(device) -> torch.device:
    """The device a context's tensors live on: CUDA unless the caller asks
    for another; never a silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return device


def to_device(obj, device):
    """Move every tensor in a nest of tuples, lists, dicts and NamedTuples."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


class ContextData:
    """Precomputations for one level of the modulus-switching chain."""

    def __init__(self, parms: EncryptionParameters, device: torch.device):
        self.parms = parms
        self.device = device
        self.parameter_error: Optional[str] = None
        self.total_coeff_modulus = numth.multiply_many(self.key_moduli())
        self.total_coeff_modulus_bit_count = self.total_coeff_modulus.bit_length()
        self.chain_index = 0
        self.prev_context_data: Optional[ContextData] = None
        self.next_context_data: Optional[ContextData] = None
        self._cache: dict = {}

    @property
    def parms_id(self) -> ParmsId:
        return self.parms.parms_id

    @property
    def parameters_set(self) -> bool:
        return self.parameter_error is None

    def key_moduli(self) -> list[int]:
        return [m.value for m in self.parms.coeff_modulus]

    @property
    def coeff_modulus_size(self) -> int:
        return len(self.parms.coeff_modulus)

    @property
    def log_n(self) -> int:
        return numth.get_power_of_two(self.parms.poly_modulus_degree)

    def cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    @property
    def ntt_tables(self):
        from seal_tpu_torch.ops import ntt as ntt_mod

        return self.cached("ntt", lambda: ntt_mod.make_ntt_tables(
            self.log_n, self.key_moduli(), self.device))

    def ntt_rows(self, index: slice):
        """NTT tables of a slice of this level's prime rows."""
        return self.cached(("ntt", index.start, index.stop),
                           lambda: self.ntt_tables.rows(index))

    @property
    def mod_consts(self):
        return self.ntt_tables.mc

    @property
    def rescale_consts(self):
        from seal_tpu_torch.ops import rns

        return self.cached("rescale", lambda: rns.make_rescale_consts(
            self.key_moduli(), self.device))

    @property
    def galois_tool(self):
        from seal_tpu_torch.ops.galois import GaloisTool

        return self.cached("galois", lambda: GaloisTool(self.log_n, self.device))


class SEALContext:
    """Validates CKKS parameters and owns the modulus-switching chain
    (SEAL context.cpp:422-525)."""

    def __init__(self, parms: EncryptionParameters, expand_mod_chain: bool = True,
                 sec_level: SecLevelType = SecLevelType.TC128, device=None):
        self.device = resolve_device(device)
        self.sec_level = sec_level
        self._context_data_map: dict[ParmsId, ContextData] = {}
        self._cache: dict = {}

        key_cd = self._validate(parms.clone())
        self._context_data_map[parms.parms_id] = key_cd
        self.key_parms_id = parms.parms_id

        alpha = parms.special_modulus_size
        if not key_cd.parameters_set or len(parms.coeff_modulus) <= alpha:
            self.first_parms_id = self.key_parms_id
        else:
            # the key level holds the α special primes; the first data level
            # drops all of them at once
            next_id = self._create_next_context_data(self.key_parms_id, drop=alpha)
            self.first_parms_id = (self.key_parms_id if next_id == PARMS_ID_ZERO
                                   else next_id)
        self.last_parms_id = self.first_parms_id
        self.using_keyswitching = self.first_parms_id != self.key_parms_id

        if expand_mod_chain and self.first_context_data().parameters_set:
            prev_id = self.first_parms_id
            while len(self._context_data_map[prev_id].parms.coeff_modulus) > 1:
                next_id = self._create_next_context_data(prev_id)
                if next_id == PARMS_ID_ZERO:
                    break
                prev_id = self.last_parms_id = next_id

        count = len(self._context_data_map)
        cd = key_cd
        while cd is not None:
            count -= 1
            cd.chain_index = count
            cd = cd.next_context_data

    def get_context_data(self, parms_id) -> Optional[ContextData]:
        return self._context_data_map.get(tuple(parms_id))

    def key_context_data(self) -> ContextData:
        return self._context_data_map[self.key_parms_id]

    def first_context_data(self) -> ContextData:
        return self._context_data_map[self.first_parms_id]

    def last_context_data(self) -> ContextData:
        return self._context_data_map[self.last_parms_id]

    @property
    def parameters_set(self) -> bool:
        return self.first_context_data().parameters_set

    def parameter_error_message(self) -> str:
        return self.first_context_data().parameter_error or "valid"

    def on_device(self, key, make):
        """make()'s tensors moved to this context's device, once."""
        if key not in self._cache:
            self._cache[key] = to_device(make(), self.device)
        return self._cache[key]

    def _create_next_context_data(self, prev_id: ParmsId, drop: int = 1) -> ParmsId:
        next_parms = self._context_data_map[prev_id].parms.clone()
        next_parms.set_coeff_modulus(next_parms.coeff_modulus[:-drop])
        next_cd = self._validate(next_parms)
        if not next_cd.parameters_set:
            return PARMS_ID_ZERO
        next_id = next_parms.parms_id
        self._context_data_map[next_id] = next_cd
        self._context_data_map[prev_id].next_context_data = next_cd
        next_cd.prev_context_data = self._context_data_map[prev_id]
        return next_id

    def _validate(self, parms: EncryptionParameters) -> ContextData:
        """The CKKS checks of SEAL context.cpp:135-420."""
        cd = ContextData(parms, self.device)
        moduli = cd.key_moduli()
        n = parms.poly_modulus_degree
        if parms.scheme != SchemeType.CKKS:
            cd.parameter_error = "the port supports the CKKS scheme only"
        elif not COEFF_MOD_COUNT_MIN <= len(moduli) <= COEFF_MOD_COUNT_MAX:
            cd.parameter_error = "coeff_modulus's primes' count is out of bounds"
        elif any(q >> USER_MOD_BIT_COUNT_MAX or not q >> (USER_MOD_BIT_COUNT_MIN - 1)
                 for q in moduli):
            cd.parameter_error = "coeff_modulus's primes' bit counts are out of bounds"
        elif not POLY_MOD_DEGREE_MIN <= n <= POLY_MOD_DEGREE_MAX:
            cd.parameter_error = "poly_modulus_degree is out of bounds"
        elif numth.get_power_of_two(n) < 0:
            cd.parameter_error = "poly_modulus_degree is not a power of two"
        elif (self.sec_level != SecLevelType.NONE and cd.total_coeff_modulus_bit_count
              > CoeffModulus.max_bit_count(n, self.sec_level)):
            cd.parameter_error = ("parameters are not compliant with "
                                  "HomomorphicEncryption.org security standard")
        elif len(set(moduli)) != len(moduli) or any(
                numth.gcd(a, b) != 1 for i, a in enumerate(moduli) for b in moduli[i + 1:]):
            cd.parameter_error = "coeff_modulus's primes are not coprime"
        elif any(_root(2 * n, q) is None for q in moduli):
            cd.parameter_error = ("coeff_modulus's primes are not congruent to 1 "
                                  "modulo 2 * poly_modulus_degree")
        elif parms.plain_modulus.value != 0:
            cd.parameter_error = "plain_modulus is not zero"
        return cd

    def __repr__(self):
        levels = []
        cd = self.key_context_data()
        while cd is not None:
            levels.append(cd.coeff_modulus_size)
            cd = cd.next_context_data
        return f"SEALContext(levels={levels}, device={self.device}, set={self.parameters_set})"
