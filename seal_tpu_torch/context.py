"""SEALContext: parameter validation, the modulus-switching chain and the
per-level constants on the context's device.

The port of seal_tpu/context.py for CKKS, BFV and BGV (SEAL
context.{h,cpp}). Every tensor the context builds lives on its device, which
defaults to CUDA: without a card the caller must ask for the CPU
(`device="cpu"`), where every kernel runs as its plain PyTorch version.
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from seal_tpu_torch.encryption_params import (
    PARMS_ID_ZERO, EncryptionParameters, ParmsId, SchemeType)
from seal_tpu_torch.modulus import (
    COEFF_MOD_COUNT_MAX, COEFF_MOD_COUNT_MIN, POLY_MOD_DEGREE_MAX,
    POLY_MOD_DEGREE_MIN, USER_MOD_BIT_COUNT_MAX, USER_MOD_BIT_COUNT_MIN,
    CoeffModulus, SecLevelType)
from seal_tpu_torch.utils import numth


class ErrorType(enum.Enum):
    """The verdict of parameter validation (SEAL context.h:34-115
    error_type), as seal_tpu names it."""

    NONE = "none"
    SUCCESS = "success"
    INVALID_SCHEME = "invalid_scheme"
    INVALID_COEFF_MODULUS_SIZE = "invalid_coeff_modulus_size"
    INVALID_COEFF_MODULUS_BIT_COUNT = "invalid_coeff_modulus_bit_count"
    INVALID_COEFF_MODULUS_NO_NTT = "invalid_coeff_modulus_no_ntt"
    INVALID_POLY_MODULUS_DEGREE = "invalid_poly_modulus_degree"
    INVALID_POLY_MODULUS_DEGREE_NON_POWER_OF_TWO = "invalid_poly_modulus_degree_non_power_of_two"
    INVALID_PARAMETERS_TOO_LARGE = "invalid_parameters_too_large"
    INVALID_PARAMETERS_INSECURE = "invalid_parameters_insecure"
    FAILED_CREATING_RNS_BASE = "failed_creating_rns_base"
    INVALID_PLAIN_MODULUS_BIT_COUNT = "invalid_plain_modulus_bit_count"
    INVALID_PLAIN_MODULUS_COPRIMALITY = "invalid_plain_modulus_coprimality"
    INVALID_PLAIN_MODULUS_TOO_LARGE = "invalid_plain_modulus_too_large"
    INVALID_PLAIN_MODULUS_NONZERO = "invalid_plain_modulus_nonzero"
    FAILED_CREATING_RNS_TOOL = "failed_creating_rns_tool"


# SEAL's parameter_error_message texts (context.cpp:78-133), as seal_tpu has them
_ERROR_MESSAGES = {
    ErrorType.NONE: "constructed but not yet validated",
    ErrorType.SUCCESS: "valid",
    ErrorType.INVALID_SCHEME: "scheme must be BFV or CKKS or BGV",
    ErrorType.INVALID_COEFF_MODULUS_SIZE:
        "coeff_modulus's primes' count is not bounded by SEAL_COEFF_MOD_COUNT_MIN(MAX)",
    ErrorType.INVALID_COEFF_MODULUS_BIT_COUNT:
        "coeff_modulus's primes' bit counts are not bounded by SEAL_USER_MOD_BIT_COUNT_MIN(MAX)",
    ErrorType.INVALID_COEFF_MODULUS_NO_NTT:
        "coeff_modulus's primes are not congruent to 1 modulo (2 * poly_modulus_degree)",
    ErrorType.INVALID_POLY_MODULUS_DEGREE:
        "poly_modulus_degree is not bounded by SEAL_POLY_MOD_DEGREE_MIN(MAX)",
    ErrorType.INVALID_POLY_MODULUS_DEGREE_NON_POWER_OF_TWO:
        "poly_modulus_degree is not a power of two",
    ErrorType.INVALID_PARAMETERS_TOO_LARGE: "parameters are too large to fit in size_t type",
    ErrorType.INVALID_PARAMETERS_INSECURE:
        "parameters are not compliant with HomomorphicEncryption.org security standard",
    ErrorType.FAILED_CREATING_RNS_BASE: "RNSBase cannot be constructed",
    ErrorType.INVALID_PLAIN_MODULUS_BIT_COUNT:
        "plain_modulus's bit count is not bounded by SEAL_PLAIN_MOD_BIT_COUNT_MIN(MAX)",
    ErrorType.INVALID_PLAIN_MODULUS_COPRIMALITY: "plain_modulus is not coprime to coeff_modulus",
    ErrorType.INVALID_PLAIN_MODULUS_TOO_LARGE: "plain_modulus is not smaller than coeff_modulus",
    ErrorType.INVALID_PLAIN_MODULUS_NONZERO: "plain_modulus is not zero",
    ErrorType.FAILED_CREATING_RNS_TOOL: "RNSTool cannot be constructed",
}


@dataclass
class EncryptionParameterQualifiers:
    """A level's validation verdict and feature flags (SEAL
    context.h:28-209); the one record of both."""

    parameter_error: ErrorType = ErrorType.NONE
    using_fft: bool = False
    using_ntt: bool = False
    using_batching: bool = False
    using_fast_plain_lift: bool = False
    using_descending_modulus_chain: bool = False
    sec_level: SecLevelType = SecLevelType.NONE

    @property
    def parameters_set(self) -> bool:
        return self.parameter_error == ErrorType.SUCCESS

    @property
    def parameter_error_message(self) -> str:
        """SEAL's text of the verdict (context.cpp:78)."""
        return _ERROR_MESSAGES[self.parameter_error]

    @property
    def parameter_error_name(self) -> str:
        """The verdict's snake-case name (context.cpp:21)."""
        return self.parameter_error.name.lower()


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
        self.qualifiers = EncryptionParameterQualifiers()
        self.total_coeff_modulus = 0
        self.total_coeff_modulus_bit_count = 0
        self.rns_base = None
        # BFV/BGV: Δ = ⌊Q/t⌋ in RNS, Q mod t and the plain lift
        self.coeff_div_plain_modulus: Optional[list[int]] = None
        self.coeff_modulus_mod_plain_modulus = 0
        self.upper_half_increment: Optional[list[int]] = None
        self.plain_upper_half_threshold = 0
        self.plain_upper_half_increment: Optional[list[int]] = None
        # CKKS: ⌈Q/2⌉
        self.upper_half_threshold: Optional[int] = None
        self.rns_tool_host = None
        self.chain_index = 0
        self.prev_context_data: Optional[ContextData] = None
        self.next_context_data: Optional[ContextData] = None
        self._cache: dict = {}

    @property
    def parms_id(self) -> ParmsId:
        return self.parms.parms_id

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

    def ntt_rows(self, index):
        """NTT tables of a slice or a list of this level's prime rows."""
        key = (index.start, index.stop) if isinstance(index, slice) else tuple(index)
        return self.cached(("ntt", key), lambda: self.ntt_tables.rows(index))

    @property
    def mod_consts(self):
        return self.ntt_tables.mc

    @property
    def rescale_consts(self):
        from seal_tpu_torch.ops import rns

        return self.cached("rescale", lambda: rns.make_rescale_consts(
            self.key_moduli(), self.device))

    @property
    def plain_ntt_tables(self):
        """NTT tables of the plain modulus t, [1, n] (batching)."""
        from seal_tpu_torch.ops import ntt as ntt_mod

        return self.cached("plain_ntt", lambda: ntt_mod.make_ntt_tables(
            self.log_n, [self.parms.plain_modulus.value], self.device))

    @property
    def plain_consts(self) -> dict:
        """The BFV/BGV plain-modulus constants on the device: t's ModConsts,
        t mod q_i as a Shoup pair [L, 1], Δ_i [L, 1], Q mod t and ⌊(t+1)/2⌋
        [1, 1], and (Q - t) mod q_i [L, 1], the lift of t's upper half."""
        from seal_tpu_torch.ops.modring import make_mod_consts, shoup_pair, u64_tensor

        def build():
            t, moduli = self.parms.plain_modulus.value, self.key_moduli()
            column = [[q] for q in moduli]
            return {
                "t_mc": make_mod_consts([t], self.device),
                "t_mod_q": shoup_pair([[t % q] for q in moduli], column, self.device),
                "delta": u64_tensor([[d] for d in self.coeff_div_plain_modulus], self.device),
                "q_mod_t": u64_tensor([[self.coeff_modulus_mod_plain_modulus]], self.device),
                "threshold": u64_tensor([[self.plain_upper_half_threshold]], self.device),
                "upper_half_increment": u64_tensor(
                    [[v] for v in self.plain_upper_half_increment], self.device),
            }

        return self.cached("plain", build)

    @property
    def rns_tool(self):
        """The level's BFV/BGV RNSTool constants on the device."""
        from seal_tpu_torch.ops import rns

        return self.cached("rns_tool", lambda: rns.make_rns_tool(
            self.rns_tool_host, self.log_n, self.device))

    @property
    def galois_tool(self):
        from seal_tpu_torch.ops.galois import GaloisTool

        return self.cached("galois", lambda: GaloisTool(self.log_n, self.device))


class SEALContext:
    """Validates CKKS, BFV and BGV parameters and owns the modulus-switching
    chain (SEAL context.cpp:422-525)."""

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
        if not key_cd.qualifiers.parameters_set or len(parms.coeff_modulus) <= alpha:
            self.first_parms_id = self.key_parms_id
        else:
            # the key level holds the α special primes; the first data level
            # drops all of them at once
            next_id = self._create_next_context_data(self.key_parms_id, drop=alpha)
            self.first_parms_id = (self.key_parms_id if next_id == PARMS_ID_ZERO
                                   else next_id)
        self.last_parms_id = self.first_parms_id
        self.using_keyswitching = self.first_parms_id != self.key_parms_id

        if expand_mod_chain and self.parameters_set:
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
        return self.first_context_data().qualifiers.parameters_set

    def parameter_error_message(self) -> str:
        return self.first_context_data().qualifiers.parameter_error_message

    def parameter_error_name(self) -> str:
        """SEAL context.h:581 parameter_error_name."""
        return self.first_context_data().qualifiers.parameter_error_name

    def on_device(self, key, make):
        """make()'s tensors moved to this context's device, once."""
        if key not in self._cache:
            self._cache[key] = to_device(make(), self.device)
        return self._cache[key]

    def _create_next_context_data(self, prev_id: ParmsId, drop: int = 1) -> ParmsId:
        next_parms = self._context_data_map[prev_id].parms.clone()
        next_parms.set_coeff_modulus(next_parms.coeff_modulus[:-drop])
        next_cd = self._validate(next_parms)
        if not next_cd.qualifiers.parameters_set:
            return PARMS_ID_ZERO
        next_id = next_parms.parms_id
        self._context_data_map[next_id] = next_cd
        self._context_data_map[prev_id].next_context_data = next_cd
        next_cd.prev_context_data = self._context_data_map[prev_id]
        return next_id

    def _validate(self, parms: EncryptionParameters) -> ContextData:
        """The checks and host constants of SEAL context.cpp:135-420: each
        qualifier flag is set where seal_tpu's _validate sets it."""
        cd = ContextData(parms, self.device)
        cd.qualifiers.parameter_error = self._check(parms, cd) or ErrorType.SUCCESS
        return cd

    def _check(self, parms: EncryptionParameters, cd: ContextData) -> Optional[ErrorType]:
        """The verdict of the first check that fails, or None; fills cd's
        flags and constants on the way."""
        from seal_tpu_torch.ops import rns

        q = cd.qualifiers
        moduli = cd.key_moduli()
        n = parms.poly_modulus_degree
        t = parms.plain_modulus.value
        if parms.scheme == SchemeType.NONE:
            return ErrorType.INVALID_SCHEME
        if not COEFF_MOD_COUNT_MIN <= len(moduli) <= COEFF_MOD_COUNT_MAX:
            return ErrorType.INVALID_COEFF_MODULUS_SIZE
        if any(v >> USER_MOD_BIT_COUNT_MAX or not v >> (USER_MOD_BIT_COUNT_MIN - 1)
               for v in moduli):
            return ErrorType.INVALID_COEFF_MODULUS_BIT_COUNT
        cd.total_coeff_modulus = numth.multiply_many(moduli)
        cd.total_coeff_modulus_bit_count = cd.total_coeff_modulus.bit_length()
        if not POLY_MOD_DEGREE_MIN <= n <= POLY_MOD_DEGREE_MAX:
            return ErrorType.INVALID_POLY_MODULUS_DEGREE
        if numth.get_power_of_two(n) < 0:
            return ErrorType.INVALID_POLY_MODULUS_DEGREE_NON_POWER_OF_TWO
        q.using_fft = True
        q.sec_level = self.sec_level
        if cd.total_coeff_modulus_bit_count > CoeffModulus.max_bit_count(n, self.sec_level):
            q.sec_level = SecLevelType.NONE
            if self.sec_level != SecLevelType.NONE:
                return ErrorType.INVALID_PARAMETERS_INSECURE
        try:
            cd.rns_base = base = rns.RNSBase(moduli)
        except ValueError:
            return ErrorType.FAILED_CREATING_RNS_BASE
        q.using_ntt = all(_root(2 * n, v) is not None for v in moduli)
        if not q.using_ntt:
            return ErrorType.INVALID_COEFF_MODULUS_NO_NTT
        Q = cd.total_coeff_modulus
        if parms.scheme == SchemeType.CKKS:
            if t != 0:
                return ErrorType.INVALID_PLAIN_MODULUS_NONZERO
            q.using_batching = True
            cd.plain_upper_half_threshold = 1 << 63
            # (2^63 mod q_i)·(q_i - 2) mod q_i, as SEAL and seal_tpu have it
            cd.plain_upper_half_increment = [((1 << 63) % v) * (v - 2) % v for v in moduli]
            cd.upper_half_threshold = (Q + 1) >> 1
        else:
            if t >> USER_MOD_BIT_COUNT_MAX or not t >> (USER_MOD_BIT_COUNT_MIN - 1):
                return ErrorType.INVALID_PLAIN_MODULUS_BIT_COUNT
            if any(not numth.are_coprime(v, t) for v in moduli):
                return ErrorType.INVALID_PLAIN_MODULUS_COPRIMALITY
            if t >= Q:
                return ErrorType.INVALID_PLAIN_MODULUS_TOO_LARGE
            q.using_batching = _root(2 * n, t) is not None
            q.using_fast_plain_lift = all(v > t for v in moduli)
            delta, rem = divmod(Q, t)
            cd.coeff_div_plain_modulus = base.decompose(delta)
            cd.coeff_modulus_mod_plain_modulus = rem
            cd.upper_half_increment = base.decompose(rem)
            cd.plain_upper_half_threshold = (t + 1) >> 1
            # t's upper half lifts to v + (Q - t): mod q_i that adds (Q - t) mod q_i
            cd.plain_upper_half_increment = base.decompose(Q - t)
        try:
            cd.rns_tool_host = rns.RNSToolHost(n, base, t)
        except (ValueError, RuntimeError):
            return ErrorType.FAILED_CREATING_RNS_TOOL
        q.using_descending_modulus_chain = all(a > b for a, b in zip(moduli, moduli[1:]))
        return None

    def __repr__(self):
        levels = []
        cd = self.key_context_data()
        while cd is not None:
            levels.append(cd.coeff_modulus_size)
            cd = cd.next_context_data
        return f"SEALContext(levels={levels}, device={self.device}, set={self.parameters_set})"
