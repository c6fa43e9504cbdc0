"""SEAL's parameter qualifiers on the port (context.py: ErrorType,
EncryptionParameterQualifiers, ContextData.qualifiers,
SEALContext.parameter_error_name) against seal_tpu's, field for field.

Each parameter set is built in both packages: tests/test_context.py's
sets (SEAL's default BFV chain, insecure at TC128 and accepted at none, a
plain modulus that shares a prime, no scheme, n = 64 with t = 257, CKKS at
n = 8192) and one set for every other verdict that validation can reach
(no NTT prime, a degree that is not a power of two or is out of bounds,
a plain modulus as large as Q or of 61 bits, no primes, a 61-bit prime,
primes that are not coprime), plus flag cases (no batching, no fast plain
lift, an ascending chain, α = 2). Every level of both chains must agree:
the verdict (ErrorType by name), each flag, the security level, the
level's constants, and the context's parameters_set,
parameter_error_name() and parameter_error_message().
"""

import pytest

import seal_tpu
import seal_tpu.context as jcontext
import seal_tpu_torch as st
import seal_tpu_torch.context as tcontext
from seal_tpu_torch.utils import numth

FLAGS = ("using_fft", "using_ntt", "using_batching", "using_fast_plain_lift",
         "using_descending_modulus_chain")
CONSTANTS = ("total_coeff_modulus", "total_coeff_modulus_bit_count", "chain_index",
             "coeff_div_plain_modulus", "coeff_modulus_mod_plain_modulus",
             "upper_half_increment", "plain_upper_half_threshold",
             "plain_upper_half_increment", "upper_half_threshold")


def _primes(n, bits):
    return [m.value for m in st.CoeffModulus.create(n, bits)]


# name: (scheme, n, coeff modulus values, plain modulus or None, sec level,
# special modulus size)
CASES = {
    "bfv_default_chain": ("BFV", 4096, [m.value for m in st.CoeffModulus.bfv_default(4096)],
                          st.PlainModulus.batching(4096, 20).value, "TC128", 1),
    "insecure_tc128": ("BFV", 2048, [m.value for m in st.CoeffModulus.bfv_default(4096)],
                       65537, "TC128", 1),
    "insecure_accepted_at_none": ("BFV", 2048,
                                  [m.value for m in st.CoeffModulus.bfv_default(4096)],
                                  65537, "NONE", 1),
    "plain_shares_a_prime": ("BFV", 4096, [m.value for m in st.CoeffModulus.bfv_default(4096)],
                             st.CoeffModulus.bfv_default(4096)[0].value, "TC128", 1),
    "no_scheme": ("NONE", 0, [], None, "NONE", 1),
    "tiny_batching": ("BFV", 64, _primes(64, [40, 40, 40]), 257, "NONE", 1),
    "ckks_8192": ("CKKS", 8192, _primes(8192, [60, 40, 40, 60]), None, "TC128", 1),
    "no_ntt_prime": ("BFV", 1024, [1000003, *_primes(1024, [40])], 257, "NONE", 1),
    "degree_not_power_of_two": ("BFV", 3000, _primes(4096, [40, 40]), 257, "NONE", 1),
    "degree_out_of_bounds": ("CKKS", 1 << 18, _primes(1 << 17, [50, 50]), None, "NONE", 1),
    "plain_as_large_as_q": ("BFV", 64, _primes(64, [20, 20]),
                            st.PlainModulus.batching(64, 50).value, "NONE", 1),
    "plain_of_61_bits": ("BFV", 64, _primes(64, [40, 40]), numth.get_primes(128, 61, 1)[0],
                         "NONE", 1),
    "no_primes": ("CKKS", 64, [], None, "NONE", 1),
    "prime_of_61_bits": ("CKKS", 64, [numth.get_primes(128, 61, 1)[0]], None, "NONE", 1),
    "primes_not_coprime": ("CKKS", 64, _primes(64, [40]) * 2, None, "NONE", 1),
    "no_batching": ("BFV", 1024, _primes(1024, [40, 40, 40]), 1024, "NONE", 1),
    "no_fast_plain_lift": ("BGV", 1024, _primes(1024, [30, 30, 30]),
                           st.PlainModulus.batching(1024, 40).value, "NONE", 1),
    "ascending_chain": ("CKKS", 1024, _primes(1024, [30, 40, 50]), None, "NONE", 1),
    "ckks_alpha_2": ("CKKS", 1024, _primes(1024, [44, 44, 44, 43, 43]), None, "NONE", 2),
}

# every verdict the cases reach (seal_tpu sets no other but
# INVALID_PARAMETERS_TOO_LARGE, FAILED_CREATING_RNS_TOOL and, for CKKS with
# a plain modulus, which its setter refuses, INVALID_PLAIN_MODULUS_NONZERO)
VERDICTS = {
    "bfv_default_chain": "SUCCESS", "insecure_tc128": "INVALID_PARAMETERS_INSECURE",
    "insecure_accepted_at_none": "SUCCESS",
    "plain_shares_a_prime": "INVALID_PLAIN_MODULUS_COPRIMALITY",
    "no_scheme": "INVALID_SCHEME", "tiny_batching": "SUCCESS", "ckks_8192": "SUCCESS",
    "no_ntt_prime": "INVALID_COEFF_MODULUS_NO_NTT",
    "degree_not_power_of_two": "INVALID_POLY_MODULUS_DEGREE_NON_POWER_OF_TWO",
    "degree_out_of_bounds": "INVALID_POLY_MODULUS_DEGREE",
    "plain_as_large_as_q": "INVALID_PLAIN_MODULUS_TOO_LARGE",
    "plain_of_61_bits": "INVALID_PLAIN_MODULUS_BIT_COUNT",
    "no_primes": "INVALID_COEFF_MODULUS_SIZE",
    "prime_of_61_bits": "INVALID_COEFF_MODULUS_BIT_COUNT",
    "primes_not_coprime": "FAILED_CREATING_RNS_BASE",
    "no_batching": "SUCCESS", "no_fast_plain_lift": "SUCCESS", "ascending_chain": "SUCCESS",
    "ckks_alpha_2": "SUCCESS",
}


def _build(pkg, case, **device):
    scheme, n, moduli, t, sec, alpha = CASES[case]
    parms = pkg.EncryptionParameters(pkg.SchemeType[scheme])
    if scheme != "NONE":
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus([pkg.Modulus(v) for v in moduli])
        parms.set_special_modulus_size(alpha)
    if t is not None:
        parms.set_plain_modulus(t)
    return pkg.SEALContext(parms, sec_level=pkg.SecLevelType[sec], **device)


def _levels(ctx):
    cd, out = ctx.key_context_data(), []
    while cd is not None:
        out.append(cd)
        cd = cd.next_context_data
    return out


def test_error_types_match():
    assert [(e.name, e.value) for e in tcontext.ErrorType] == [
        (e.name, e.value) for e in jcontext.ErrorType]
    for e in jcontext.ErrorType:
        jq = jcontext.EncryptionParameterQualifiers(parameter_error=e)
        tq = tcontext.EncryptionParameterQualifiers(parameter_error=tcontext.ErrorType[e.name])
        assert (tq.parameters_set, tq.parameter_error_name, tq.parameter_error_message) == (
            jq.parameters_set, jq.parameter_error_name, jq.parameter_error_message)
    defaults = tcontext.EncryptionParameterQualifiers()
    assert defaults.parameter_error == tcontext.ErrorType.NONE and not defaults.parameters_set
    assert defaults.sec_level == st.SecLevelType.NONE


@pytest.mark.parametrize("case", list(CASES))
def test_qualifiers_match_seal_tpu(case):
    ctx = _build(st, case, device="cpu")
    sctx = _build(seal_tpu, case)
    assert ctx.first_context_data().qualifiers.parameter_error.name == VERDICTS[case]
    assert ctx.parameters_set == sctx.parameters_set
    assert ctx.parameter_error_name() == sctx.parameter_error_name()
    assert ctx.parameter_error_message() == sctx.parameter_error_message()
    assert ctx.using_keyswitching == sctx.using_keyswitching
    for ids in ("key_parms_id", "first_parms_id", "last_parms_id"):
        assert tuple(getattr(ctx, ids)) == tuple(getattr(sctx, ids)), ids
    levels, slevels = _levels(ctx), _levels(sctx)
    assert len(levels) == len(slevels)
    for cd, scd in zip(levels, slevels):
        q, sq = cd.qualifiers, scd.qualifiers
        assert isinstance(q, tcontext.EncryptionParameterQualifiers)
        assert q.parameter_error.name == sq.parameter_error.name
        assert q.sec_level.name == sq.sec_level.name
        for flag in FLAGS:
            assert getattr(q, flag) == getattr(sq, flag), flag
        assert (q.parameters_set, q.parameter_error_name, q.parameter_error_message) == (
            sq.parameters_set, sq.parameter_error_name, sq.parameter_error_message)
        for name in CONSTANTS:
            assert getattr(cd, name) == getattr(scd, name), name
        assert (cd.rns_base is None) == (scd.rns_base is None)
        if cd.rns_base is not None:
            assert cd.rns_base.base == scd.rns_base.base


def test_refusals_name_the_verdict():
    """A context that failed validation refuses the objects that need it,
    and says why."""
    ctx = _build(st, "insecure_tc128", device="cpu")
    assert ctx.parameter_error_name() == "invalid_parameters_insecure"
    with pytest.raises(ValueError):
        st.KeyGenerator(ctx)
    assert "insecure" in repr(ctx.first_context_data().qualifiers.parameter_error).lower()


def test_seal_pascal_case_names():
    """SEAL's CoeffModulus::{MaxBitCount, BFVDefault, Create} and
    PlainModulus::Batching, as seal_tpu has them."""
    from seal_tpu.modulus import MOD_BIT_COUNT_MIN

    C, JC = st.CoeffModulus, seal_tpu.CoeffModulus
    assert C.MaxBitCount(8192) == JC.MaxBitCount(8192) == C.max_bit_count(8192)
    assert [m.value for m in C.BFVDefault(4096)] == [m.value for m in JC.BFVDefault(4096)]
    assert [m.value for m in C.Create(1024, [30, 40])] == [
        m.value for m in JC.Create(1024, [30, 40])]
    assert st.PlainModulus.Batching(1024, 20).value == seal_tpu.PlainModulus.Batching(
        1024, 20).value
    assert st.modulus.MOD_BIT_COUNT_MIN == MOD_BIT_COUNT_MIN == 2
