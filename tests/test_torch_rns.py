"""The port's RNS tools (seal_tpu_torch.ops.rns, hybrid mod-down) against
seal_tpu's, bit for bit, at n = 1024 with three 60-bit data primes and a
plain modulus t of 20 and of 60 bits.

Each seal_tpu function runs under a small jax.jit of its own; the port's
plain PyTorch version runs on the same inputs, made from a numpy seed. The
host constants of RNSToolHost are compared value by value.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from seal_tpu.ops import hybrid_keyswitch as jhyb
from seal_tpu.ops import modring as jmodring
from seal_tpu.ops import ntt as jntt
from seal_tpu.ops import rns as jrns
from seal_tpu_torch.modulus import CoeffModulus, PlainModulus
from seal_tpu_torch.ops import hybrid_keyswitch as hyb
from seal_tpu_torch.ops import ntt, rns
from seal_tpu_torch.utils import numth

N, LOG_N = 1024, 10
Q = [m.value for m in CoeffModulus.create(N, [60, 60, 60])]
# the fourth-largest 60-bit NTT prime: coprime to the three data primes
T_BITS = {20: PlainModulus.batching(N, 20).value, 60: numth.get_primes(2 * N, 60, 4)[3]}
HOST_FIELDS = ("m_sk", "gamma", "m_tilde", "prod_B_mod_q", "inv_prod_q_mod_Bsk",
               "inv_prod_B_mod_m_sk", "inv_m_tilde_mod_Bsk", "neg_inv_prod_q_mod_m_tilde",
               "prod_q_mod_Bsk", "inv_gamma_mod_t",
               "prod_t_gamma_mod_q", "neg_inv_q_mod_t_gamma", "inv_q_last_mod_t")


def _pair(x):
    x = np.asarray(x, dtype=np.uint64)
    return ((x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (x >> np.uint64(32)).astype(np.uint32))


def _u64(pair):
    return (np.asarray(pair[0], dtype=np.uint64)
            | (np.asarray(pair[1], dtype=np.uint64) << np.uint64(32)))


def _residues(moduli, seed, batch=(2,)):
    rng = np.random.default_rng(seed)
    q = np.array(moduli, dtype=np.uint64)[:, None]
    x = rng.integers(0, 1 << 63, batch + (len(moduli), N), dtype=np.int64).astype(np.uint64) % q
    x[..., 0] = q[:, 0] - np.uint64(1)
    return x


def _same(port_fn, jax_fn, x):
    got = port_fn(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, _u64(jax.jit(jax_fn)(_pair(x))))


@functools.lru_cache(maxsize=None)
def _tools(t_bits):
    t = T_BITS[t_bits]
    jhost = jrns.RNSToolHost(N, jrns.RNSBase(Q), t)
    host = rns.RNSToolHost(N, rns.RNSBase(Q), t)
    return host, rns.make_rns_tool(host, LOG_N, "cpu"), jhost, jrns.make_rns_tool_device(
        jhost, LOG_N)


@pytest.mark.parametrize("t_bits", sorted(T_BITS))
def test_rns_tool_host_constants(t_bits):
    """With a 60-bit t, Q·t needs the auxiliary base B to grow by one prime."""
    host, _, jhost, _ = _tools(t_bits)
    assert host.base_B.size == (4 if t_bits == 60 else 3)
    for name in HOST_FIELDS:
        assert getattr(host, name) == getattr(jhost, name), name
    for name in ("base_B", "base_Bsk", "base_t_gamma"):
        a, b = getattr(host, name), getattr(jhost, name)
        assert (a.base, a.punctured_prod, a.inv_punctured_prod) == \
            (b.base, b.punctured_prod, b.inv_punctured_prod), name


@pytest.mark.parametrize("fn", ["fastbconv_m_tilde", "sm_mrq", "fast_floor", "fastbconv_sk"])
def test_behz_steps(fn):
    """Over the larger auxiliary base, that of the 60-bit t: Bsk of five
    61-bit primes."""
    host, rt, _, jrt = _tools(60)
    bsk = host.base_Bsk.base
    moduli = {"fastbconv_m_tilde": Q, "sm_mrq": bsk + [host.m_tilde],
              "fast_floor": Q + bsk, "fastbconv_sk": bsk}[fn]
    x = _residues(moduli, seed=len(fn) + len(bsk))
    _same(lambda a: getattr(rns, fn)(a, rt), lambda a: getattr(jrns, fn)(a, jrt), x)


@pytest.mark.parametrize("t_bits", sorted(T_BITS))
@pytest.mark.parametrize("fn", ["decrypt_scale_and_round", "decrypt_modt",
                                "mod_t_and_divide_q_last"])
def test_t_tails(fn, t_bits):
    _, rt, _, jrt = _tools(t_bits)
    rc = rns.make_rescale_consts(Q, "cpu")
    port = {"decrypt_scale_and_round": lambda a: rns.decrypt_scale_and_round(a, rt),
            "decrypt_modt": lambda a: rns.decrypt_modt(a, rt),
            "mod_t_and_divide_q_last": lambda a: rns.mod_t_and_divide_q_last(a, rt, rc)}[fn]
    _same(port, lambda a: getattr(jrns, fn)(a, jrt), _residues(Q, seed=len(fn)))


def test_exact_convert_array_in_the_rounding_corner():
    """Coefficients whose Σ x̂_j/q_j lies next to a half-integer, where the
    v-correction's rounding decides (x = Q·k/2 + small), bit for bit;
    elsewhere the value itself, taken centered mod Q."""
    base = jrns.RNSBase(Q)
    t = T_BITS[60]
    Qp = base.base_prod
    vals = [(Qp * k // 2 + d) % Qp for k in range(4) for d in (-2, -1, 0, 1, 2)]
    vals += list(range(N - len(vals)))
    x = np.array([[v % q for v in vals] for q in Q], dtype=np.uint64)
    bc = rns.make_base_converter(rns.RNSBase(Q), rns.RNSBase([t]), "cpu")
    jbc = jrns.make_base_conv(base, jrns.RNSBase([t]))
    _same(lambda a: rns.exact_convert_array(a, bc),
          lambda a: jrns.exact_convert_array(a, jbc), x)
    # away from the half-way point the result is x mod t, x taken centered
    got = rns.exact_convert_array(torch.from_numpy(x.view(np.int64)), bc).numpy()
    assert got[0, 20:].view(np.uint64).tolist() == [v % t for v in vals[20:]]
    x[:, 0] = [(Qp - 5) % q for q in Q]
    got = rns.exact_convert_array(torch.from_numpy(x.view(np.int64)), bc).numpy()
    assert int(got[0, 0].view(np.uint64)) == (-5) % t


@pytest.mark.parametrize("ntt_form", [False, True], ids=["coeff", "ntt"])
def test_divide_and_round_q_last(ntt_form):
    rc = rns.make_rescale_consts(Q, "cpu")
    jrt = jrns.make_rns_tool_device(jrns.RNSToolHost(N, jrns.RNSBase(Q), 0), LOG_N)
    x = _residues(Q, seed=11 + ntt_form)
    if ntt_form:
        tables = ntt.make_ntt_tables(LOG_N, Q, "cpu")
        jt = jntt.build_device_tables(LOG_N, Q, with_pallas=False)
        _same(lambda a: rns.divide_and_round_q_last_ntt(a, rc, tables.rows(slice(0, 2)),
                                                        tables.rows(slice(2, 3))),
              lambda a: jrns.divide_and_round_q_last_ntt(a, jrt, jt), x)
    else:
        mc = ntt.make_ntt_tables(LOG_N, Q, "cpu").mc
        _same(lambda a: rns.divide_and_round_q_last(a, rc, mc.rows(slice(0, 2)),
                                                    mc.rows(slice(2, 3))),
              lambda a: jrns.divide_and_round_q_last(a, jrt), x)


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_hybrid_mod_down_coefficient_output(scheme):
    """α = 2 special primes over the three data primes: BFV's rounded
    division and BGV's exact one that keeps the value mod t."""
    specials = [m.value for m in CoeffModulus.create(N, [60, 60, 60, 59, 59])][3:]
    key_moduli = tuple(Q + specials)
    t = T_BITS[20] if scheme == "bgv" else 0
    rows = _residues(list(key_moduli), seed=len(scheme), batch=())
    lvl = ntt.make_ntt_tables(LOG_N, Q, "cpu")
    spec = ntt.make_ntt_tables(LOG_N, specials, "cpu")
    c = hyb.tail_consts(key_moduli, 2, 3, t)
    jlvl = jntt.build_device_tables(LOG_N, Q, with_pallas=False)
    jspec = jntt.build_device_tables(LOG_N, specials, with_pallas=False)
    _same(lambda a: hyb.mod_down(a, c, lvl, spec, lvl.mc, ntt_out=False),
          lambda a: jhyb.mod_down(a, scheme == "bgv", key_moduli, 2, 3, t, jlvl, jspec,
                                  jmodring.make_mod_consts(Q), is_ntt_out=False), rows)


# SEAL's RNSBase API (rns.cpp:18-399) on the bases of tests/test_rns.py,
# against seal_tpu's RNSBase
BASES = [[2], [2, 3], [3, 5], [3, 5, 7], [2, 3, 5, 7], [3, 5, 7, 11], [3, 11],
         [0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001], Q]


@pytest.mark.parametrize("values", BASES, ids=lambda b: "x".join(map(str, b))[:40])
def test_rnsbase_api_matches_seal_tpu(values):
    base, jbase = rns.RNSBase(values), jrns.RNSBase(values)
    assert [base[i] for i in range(base.size)] == [jbase[i] for i in range(jbase.size)]
    for v in (2, 3, 5, 11, 13, values[-1], values[-1] + 2):
        assert base.contains(v) == jbase.contains(v), v
    for other in BASES:
        assert base.is_subbase_of(rns.RNSBase(other)) == jbase.is_subbase_of(
            jrns.RNSBase(other)), other
    if len(values) > 1:
        assert base.drop().base == jbase.drop().base
        for v in values:
            assert base.drop(v).base == jbase.drop(v).base
    # 7919 is in no base: both refuse it with the same message
    with pytest.raises(ValueError) as port_error:
        base.drop(7919)
    with pytest.raises(ValueError) as jax_error:
        jbase.drop(7919)
    assert str(port_error.value) == str(jax_error.value)
    if len(values) == 1:
        for drop in (lambda b: b.drop(), lambda b: b.drop(values[0])):
            with pytest.raises(ValueError) as port_error:
                drop(base)
            with pytest.raises(ValueError) as jax_error:
                drop(jbase)
            assert str(port_error.value) == str(jax_error.value)
    if all(v % 13 for v in values):
        assert base.extend(rns.RNSBase([13])).base == jbase.extend(jrns.RNSBase([13])).base
    rng = np.random.default_rng(len(values))
    for value in (0, 1, base.base_prod - 1, int(rng.integers(0, 1 << 62)) % base.base_prod):
        residues = base.decompose(value)
        assert residues == jbase.decompose(value)
        assert base.compose(residues) == jbase.compose(residues) == value


def test_rnsbase_index_out_of_range():
    with pytest.raises(IndexError):
        rns.RNSBase([2, 3, 5])[3]
