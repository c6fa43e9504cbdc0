"""RNS machinery: CRT bases, base conversion and the RNSTool op set.

The port of seal_tpu/ops/rns.py (SEAL util/rns.cpp: RNSBase :18-399,
BaseConverter :400-576, RNSTool :578-1246). Host side, exact Python ints:
bases, punctured products and every derived constant, built once per level.
Device side, elementwise PyTorch ops over int64 tensors [..., L, N]:

* fast base conversion, a 128-bit lazy sum over the input primes and one
  Barrett-128 reduction per output prime;
* exact conversion to one prime, with seal_tpu's integer fixed-point
  rounding count v = round(Σ_j x̂_j·⌊2^128/q_j⌋ / 2^128) in place of SEAL's
  doubles (rns.cpp:481-526): each term is below 2^128, so the sum is a
  128-bit word pair and a carry count;
* the BEHZ steps of BFV multiplication (fastbconv_m_tilde, sm_mrq,
  fast_floor, fastbconv_sk), over the auxiliary base Bsk of 61-bit primes
  and m̃ = 2^32;
* division by the last prime: rounded, in the coefficient domain (BFV) and
  the NTT domain (CKKS), and BGV's exact division that keeps the value mod t;
* decryption: BFV's {t, γ} scale-and-round and BGV's exact conversion to t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from seal_tpu_torch.modulus import (
    COEFF_MOD_COUNT_MAX, COEFF_MOD_COUNT_MIN, INTERNAL_MOD_BIT_COUNT)
from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.modring import ModConsts, make_mod_consts, shoup_pair, u64_tensor
from seal_tpu_torch.utils import numth


# ---------------------------------------------------------------------------
# Host: RNSBase and RNSToolHost
# ---------------------------------------------------------------------------

class RNSBase:
    """A coprime CRT base {q_1, ..., q_k} with punctured-product constants
    (rns.cpp:18-257)."""

    def __init__(self, moduli):
        vals = [int(m) for m in moduli]
        if not vals:
            raise ValueError("rnsbase cannot be empty")
        for i, v in enumerate(vals):
            if v < 2:
                raise ValueError("rnsbase is invalid")
            if any(numth.gcd(v, w) != 1 for w in vals[i + 1:]):
                raise ValueError("rnsbase is invalid (not coprime)")
        self.base = vals
        self.size = len(vals)
        self.base_prod = numth.multiply_many(vals)
        self.punctured_prod = [self.base_prod // v for v in vals]
        self.inv_punctured_prod = [numth.invert_uint_mod(p % v, v)
                                   for v, p in zip(vals, self.punctured_prod)]

    def __getitem__(self, i) -> int:
        return self.base[i]

    def contains(self, value: int) -> bool:
        return int(value) in self.base

    def is_subbase_of(self, other: "RNSBase") -> bool:
        return all(v in other.base for v in self.base)

    def extend(self, other) -> "RNSBase":
        """This base with another base's primes, or one more prime, appended."""
        more = other.base if isinstance(other, RNSBase) else [int(other)]
        return RNSBase(self.base + more)

    def drop(self, value: int | None = None) -> "RNSBase":
        """This base without its last prime, or without `value`."""
        if value is not None and int(value) not in self.base:
            raise ValueError("value is not in the base")
        if self.size == 1:
            raise ValueError("cannot drop from base of size 1")
        if value is None:
            return RNSBase(self.base[:-1])
        return RNSBase([v for v in self.base if v != int(value)])

    def decompose(self, value: int) -> list[int]:
        return [value % v for v in self.base]

    def compose(self, residues) -> int:
        """Residues -> the integer in [0, base_prod) (rns.cpp:321-399)."""
        acc = sum(p * (int(x) * ip % v) for x, v, p, ip in zip(
            residues, self.base, self.punctured_prod, self.inv_punctured_prod))
        return acc % self.base_prod


class RNSToolHost:
    """Every RNSTool constant, exact on the host (RNSTool::initialize,
    rns.cpp:578-787). t = 0 for CKKS."""

    def __init__(self, poly_modulus_degree: int, q: RNSBase, t: int = 0):
        if not COEFF_MOD_COUNT_MIN <= q.size <= COEFF_MOD_COUNT_MAX:
            raise ValueError("rnsbase is invalid")
        if numth.get_power_of_two(poly_modulus_degree) < 0:
            raise ValueError("poly_modulus_degree is invalid")
        self.t = int(t)
        self.base_q = q

        # the auxiliary base B has one more prime when Q·t needs it
        # (rns.cpp:600-615)
        base_B_size = q.size
        if 32 + self.t.bit_length() + q.base_prod.bit_length() >= \
                INTERNAL_MOD_BIT_COUNT * (q.size + 1):
            base_B_size += 1
        primes = numth.get_primes(2 * poly_modulus_degree, INTERNAL_MOD_BIT_COUNT,
                                  base_B_size + 2)
        self.m_sk = primes[0]
        self.gamma = primes[1]
        self.m_tilde = 1 << 32
        self.base_B = RNSBase(primes[2:2 + base_B_size])
        self.base_Bsk = self.base_B.extend(self.m_sk)
        self.base_t_gamma = RNSBase([self.t, self.gamma]) if self.t else None

        Q = q.base_prod
        self.prod_B_mod_q = [self.base_B.base_prod % qi for qi in q.base]
        self.inv_prod_q_mod_Bsk = [numth.invert_uint_mod(Q % b, b) for b in self.base_Bsk.base]
        self.inv_prod_B_mod_m_sk = numth.invert_uint_mod(
            self.base_B.base_prod % self.m_sk, self.m_sk)
        self.inv_m_tilde_mod_Bsk = [numth.invert_uint_mod(self.m_tilde % b, b)
                                    for b in self.base_Bsk.base]
        self.neg_inv_prod_q_mod_m_tilde = (
            -numth.invert_uint_mod(Q % self.m_tilde, self.m_tilde)) % self.m_tilde
        self.prod_q_mod_Bsk = [Q % b for b in self.base_Bsk.base]
        if self.t:
            self.inv_gamma_mod_t = numth.invert_uint_mod(self.gamma % self.t, self.t)
            self.prod_t_gamma_mod_q = [self.t * self.gamma % qi for qi in q.base]
            self.neg_inv_q_mod_t_gamma = [(-numth.invert_uint_mod(Q % p, p)) % p
                                          for p in self.base_t_gamma.base]
            self.inv_q_last_mod_t = numth.invert_uint_mod(q.base[-1] % self.t, self.t)


# ---------------------------------------------------------------------------
# Device: base conversion
# ---------------------------------------------------------------------------

class BaseConverter(NamedTuple):
    """Constants of the ibase -> obase conversion on one device."""

    ibase_mc: ModConsts             # [Li, 1]; ratio0/ratio1 are ⌊2^128/q_j⌋'s words
    obase_mc: ModConsts             # [Lo, 1]
    inv_punct_op: torch.Tensor      # [Li, 1]: (Q/q_j)^{-1} mod q_j, Shoup pair
    inv_punct_qt: torch.Tensor
    matrix: torch.Tensor            # [Lo, Li]: Q/q_j mod o_p
    q_mod_p: torch.Tensor           # [Lo, 1]: Q mod o_p


def make_base_converter(ibase: RNSBase, obase: RNSBase, device) -> BaseConverter:
    inv_op, inv_qt = shoup_pair([[v] for v in ibase.inv_punctured_prod],
                                [[v] for v in ibase.base], device)
    return BaseConverter(
        ibase_mc=make_mod_consts(ibase.base, device),
        obase_mc=make_mod_consts(obase.base, device),
        inv_punct_op=inv_op, inv_punct_qt=inv_qt,
        matrix=u64_tensor([[pj % p for pj in ibase.punctured_prod] for p in obase.base],
                          device, (obase.size, ibase.size)),
        q_mod_p=u64_tensor([[ibase.base_prod % p] for p in obase.base], device))


def _scaled_residues(x, bc: BaseConverter):
    """x̂_j = x_j·(Q/q_j)^{-1} mod q_j, the first half of a conversion."""
    return modarith.mul_mod_shoup(x, bc.inv_punct_op, bc.inv_punct_qt, bc.ibase_mc.q)


def _matrix_dot(temp, bc: BaseConverter):
    """Σ_j x̂_j·(Q/q_j mod o_p) per output prime: a 128-bit lazy sum and one
    Barrett-128. [..., Li, N] -> [..., Lo, N]."""
    zero = torch.zeros(temp.shape[:-2] + (bc.obase_mc.count, temp.shape[-1]),
                       dtype=torch.int64, device=temp.device)
    acc = (zero, zero)
    for j in range(temp.shape[-2]):
        acc = modarith.mul_add_128(acc, temp[..., j:j + 1, :], bc.matrix[:, j:j + 1])
    o = bc.obase_mc
    return modarith.barrett_reduce_128(acc[0], acc[1], o.q, o.ratio0, o.ratio1)


def fast_convert_array(x, bc: BaseConverter):
    """ibase residues [..., Li, N] -> obase residues [..., Lo, N]
    (rns.cpp:418-463)."""
    return _matrix_dot(_scaled_residues(x, bc), bc)


def exact_convert_array(x, bc: BaseConverter):
    """Exact conversion to a one-prime obase with the v-correction
    (rns.cpp:465-539). [..., Li, N] -> [..., 1, N].

    v = round(Σ_j x̂_j/q_j) = ⌊(S + 2^127)/2^128⌋ for S = Σ_j x̂_j·⌊2^128/q_j⌋:
    each term is below 2^128, so S is a 128-bit sum (lo, hi) and a count of
    its carries, and v is that count plus the carry of hi + 2^63."""
    temp = _scaled_residues(x, bc)
    r0, r1 = bc.ibase_mc.ratio0, bc.ibase_mc.ratio1
    lo = hi = top = torch.zeros_like(temp[..., :1, :])
    for j in range(temp.shape[-2]):
        xj = temp[..., j:j + 1, :]
        p_lo, p_hi = modarith.mul_wide(xj, r0[j:j + 1])
        p_hi = p_hi + xj * r1[j:j + 1]                 # x̂_j·r1 < 2^64: no carry out
        lo, c = modarith.add_carry(lo, p_lo)
        hi, c1 = modarith.add_carry(hi, c)
        hi, c2 = modarith.add_carry(hi, p_hi)
        top = top + c1 + c2
    v = top + ((hi >> 63) & 1)
    p = bc.obase_mc
    v_q = modarith.mul_mod(v, bc.q_mod_p, p.q, p.ratio0, p.ratio1)
    return modarith.sub_mod(_matrix_dot(temp, bc), v_q, p.q)


# ---------------------------------------------------------------------------
# Device: RNSTool
# ---------------------------------------------------------------------------

def _sp(values, moduli, device):
    """Shoup pair [L, 1] of host ints."""
    return shoup_pair([[int(v)] for v in values], [[int(m)] for m in moduli], device)


def _val(v, device):
    return u64_tensor([[int(v)]], device)


class RNSTool(NamedTuple):
    """RNSTool's device constants for one level of a BFV or BGV chain
    (seal_tpu's RNSToolDevice). Shoup pairs are (op, qt) tuples of [L, 1]."""

    q_mc: ModConsts
    bsk_mc: ModConsts
    t_mc: ModConsts
    mtilde_mc: ModConsts
    conv_q_to_bsk: BaseConverter
    conv_q_to_bsk_mtilde: BaseConverter    # q -> Bsk ∪ {m̃}, one conversion
    conv_b_to_q_msk: BaseConverter         # B -> q ∪ {m_sk}, one conversion
    conv_q_to_t_gamma: BaseConverter
    conv_q_to_t: BaseConverter
    mtilde_mod_q: tuple
    neg_inv_prod_q_mod_mtilde: tuple
    prod_q_mod_bsk: tuple
    inv_mtilde_mod_bsk: tuple
    inv_prod_q_mod_bsk: tuple
    inv_prod_b_mod_msk: tuple
    prod_b_mod_q: tuple
    neg_prod_b_mod_q: tuple
    msk_div_2: torch.Tensor
    mtilde_div_2: torch.Tensor
    msk_value: torch.Tensor
    mtilde_value: torch.Tensor
    prod_t_gamma_mod_q: tuple
    neg_inv_q_mod_t_gamma: tuple
    inv_gamma_mod_t: tuple
    gamma_div_2: torch.Tensor
    gamma_value: torch.Tensor
    inv_q_last_mod_t: tuple                # [1, 1]
    q_last_value: torch.Tensor             # [1, 1]
    t_mod_bsk: tuple                       # [LBsk, 1]: t mod each Bsk prime
    bsk_ntt: ntt_mod.NTTTables


def make_rns_tool(host: RNSToolHost, log_n: int, device) -> RNSTool:
    """The device constants of a BFV/BGV level (t != 0)."""
    q, bsk, t = host.base_q, host.base_Bsk, host.t
    return RNSTool(
        q_mc=make_mod_consts(q.base, device),
        bsk_mc=make_mod_consts(bsk.base, device),
        t_mc=make_mod_consts([t], device),
        mtilde_mc=make_mod_consts([host.m_tilde], device),
        conv_q_to_bsk=make_base_converter(q, bsk, device),
        conv_q_to_bsk_mtilde=make_base_converter(q, bsk.extend(host.m_tilde), device),
        conv_b_to_q_msk=make_base_converter(host.base_B, q.extend(host.m_sk), device),
        conv_q_to_t_gamma=make_base_converter(q, host.base_t_gamma, device),
        conv_q_to_t=make_base_converter(q, RNSBase([t]), device),
        mtilde_mod_q=_sp([host.m_tilde % qi for qi in q.base], q.base, device),
        neg_inv_prod_q_mod_mtilde=_sp([host.neg_inv_prod_q_mod_m_tilde], [host.m_tilde],
                                      device),
        prod_q_mod_bsk=_sp(host.prod_q_mod_Bsk, bsk.base, device),
        inv_mtilde_mod_bsk=_sp(host.inv_m_tilde_mod_Bsk, bsk.base, device),
        inv_prod_q_mod_bsk=_sp(host.inv_prod_q_mod_Bsk, bsk.base, device),
        inv_prod_b_mod_msk=_sp([host.inv_prod_B_mod_m_sk], [host.m_sk], device),
        prod_b_mod_q=_sp(host.prod_B_mod_q, q.base, device),
        neg_prod_b_mod_q=_sp([(qi - p) % qi for p, qi in zip(host.prod_B_mod_q, q.base)],
                             q.base, device),
        msk_div_2=_val(host.m_sk >> 1, device),
        mtilde_div_2=_val(host.m_tilde >> 1, device),
        msk_value=_val(host.m_sk, device),
        mtilde_value=_val(host.m_tilde, device),
        prod_t_gamma_mod_q=_sp(host.prod_t_gamma_mod_q, q.base, device),
        neg_inv_q_mod_t_gamma=_sp(host.neg_inv_q_mod_t_gamma, host.base_t_gamma.base,
                                  device),
        inv_gamma_mod_t=_sp([host.inv_gamma_mod_t], [t], device),
        gamma_div_2=_val(host.gamma >> 1, device),
        gamma_value=_val(host.gamma, device),
        inv_q_last_mod_t=_sp([host.inv_q_last_mod_t], [t], device),
        q_last_value=_val(q.base[-1], device),
        t_mod_bsk=_sp([t % b for b in bsk.base], bsk.base, device),
        bsk_ntt=ntt_mod.make_ntt_tables(log_n, bsk.base, device),
    )


def fastbconv_m_tilde(x, rt: RNSTool):
    """q -> Bsk ∪ {m̃}: multiply by m̃ mod q, then fast-convert to both at
    once (each output row is its own sum; rns.cpp:1086-1131).
    [..., Lq, N] -> [..., LBsk+1, N]."""
    temp = modarith.mul_mod_shoup(x, *rt.mtilde_mod_q, rt.q_mc.q)
    return fast_convert_array(temp, rt.conv_q_to_bsk_mtilde)


def sm_mrq(x, rt: RNSTool):
    """Montgomery reduction by m̃: Bsk ∪ {m̃} -> Bsk (rns.cpp:979-1039).
    [..., LBsk+1, N] -> [..., LBsk, N]."""
    n_bsk = rt.bsk_mc.count
    r = modarith.mul_mod_shoup(x[..., n_bsk:, :], *rt.neg_inv_prod_q_mod_mtilde,
                               rt.mtilde_mc.q)
    # centered: r >= m̃/2 stands for r - m̃, so add q_i - m̃ (any u64 will do)
    r = torch.where(r >= rt.mtilde_div_2, r + (rt.bsk_mc.q - rt.mtilde_value), r)
    summed = modarith.add_mod(modarith.mul_mod_shoup(r, *rt.prod_q_mod_bsk, rt.bsk_mc.q),
                              x[..., :n_bsk, :], rt.bsk_mc.q)
    return modarith.mul_mod_shoup(summed, *rt.inv_mtilde_mod_bsk, rt.bsk_mc.q)


def fast_floor(x, rt: RNSTool):
    """⌊x/Q⌋ in Bsk: q ∪ Bsk -> Bsk (rns.cpp:1041-1084).
    [..., Lq+LBsk, N] -> [..., LBsk, N]."""
    n_q = rt.q_mc.count
    conv = fast_convert_array(x[..., :n_q, :], rt.conv_q_to_bsk)
    diff = x[..., n_q:, :] + rt.bsk_mc.q - conv                    # < 2q
    return modarith.mul_mod_shoup(diff, *rt.inv_prod_q_mod_bsk, rt.bsk_mc.q)


def fastbconv_sk(x, rt: RNSTool):
    """Shenoy-Kumaresan conversion Bsk -> q (rns.cpp:903-977).
    [..., LBsk, N] -> [..., Lq, N]."""
    n_b = rt.bsk_mc.count - 1
    x_b, x_sk = x[..., :n_b, :], x[..., n_b:, :]
    conv = fast_convert_array(x_b, rt.conv_b_to_q_msk)
    dest, temp = conv[..., :-1, :], conv[..., -1:, :]
    alpha = modarith.mul_mod_shoup(temp + rt.msk_value - x_sk, *rt.inv_prod_b_mod_msk,
                                   rt.msk_value)
    # alpha stands for a centered value: alpha - m_sk where alpha > m_sk/2
    big = alpha > rt.msk_div_2
    arg = torch.where(big, modarith.neg_mod(alpha, rt.msk_value), alpha)
    op = torch.where(big, rt.prod_b_mod_q[0], rt.neg_prod_b_mod_q[0])
    qt = torch.where(big, rt.prod_b_mod_q[1], rt.neg_prod_b_mod_q[1])
    return modarith.add_mod(modarith.mul_mod_shoup(arg, op, qt, rt.q_mc.q), dest, rt.q_mc.q)


class RescaleConsts(NamedTuple):
    """Device constants for dividing by the last prime of a tower
    (RNSTool::initialize, rns.cpp:578-787)."""

    q_last_half: torch.Tensor       # [1, 1]: q_last >> 1
    neg_half_mod_q: torch.Tensor    # [L-1, 1]: q_i - ((q_last >> 1) mod q_i)
    inv_q_last_op: torch.Tensor     # [L-1, 1]: q_last^{-1} mod q_i, Shoup pair
    inv_q_last_qt: torch.Tensor


def make_rescale_consts(moduli, device) -> RescaleConsts:
    last, keep = moduli[-1], moduli[:-1]
    half = last >> 1
    inv_op, inv_qt = shoup_pair(
        [[numth.invert_uint_mod(last, q)] for q in keep], [[q] for q in keep], device)
    return RescaleConsts(
        q_last_half=u64_tensor([[half]], device),
        neg_half_mod_q=u64_tensor([[q - half % q] for q in keep], device),
        inv_q_last_op=inv_op, inv_q_last_qt=inv_qt)


def divide_and_round_q_last(x, rc: RescaleConsts, keep_mc: ModConsts, last_mc: ModConsts):
    """Rounded division by the last prime in the coefficient domain (BFV
    mod switch, rns.cpp:789-828). x: [..., L, N]; keep_mc / last_mc hold
    its prime rows [0, L-1) and [L-1]. Returns [..., L-1, N]."""
    last = modarith.add_mod(x[..., -1:, :], rc.q_last_half, last_mc.q)
    # (last mod q_i) - (half mod q_i), as + (q_i - half mod q_i)
    temp = modarith.cond_sub(
        modarith.barrett_reduce_64(last, keep_mc.q, keep_mc.ratio1) + rc.neg_half_mod_q,
        keep_mc.q)
    diff = modarith.sub_mod(x[..., :-1, :], temp, keep_mc.q)
    return modarith.mul_mod_shoup(diff, rc.inv_q_last_op, rc.inv_q_last_qt, keep_mc.q)


def divide_and_round_q_last_ntt(x, rc: RescaleConsts,
                                keep_tables: ntt_mod.NTTTables,
                                last_tables: ntt_mod.NTTTables):
    """Rescale by the last prime in the NTT domain (SEAL rns.cpp:830-901).
    x: [..., L, N] in NTT form; keep_tables / last_tables cover its prime
    rows [0, L-1) and [L-1]. Returns [..., L-1, N] in NTT form."""
    keep_mc: ModConsts = keep_tables.mc
    last = ntt_mod.ntt_inverse(x[..., -1:, :], last_tables)
    last = modarith.add_mod(last, rc.q_last_half, last_tables.mc.q)
    temp = modarith.barrett_reduce_64(last, keep_mc.q, keep_mc.ratio1)
    temp = ntt_mod.ntt_forward(temp + rc.neg_half_mod_q, keep_tables, lazy=True)
    diff = x[..., :-1, :] + (keep_mc.q << 2) - temp        # < 5q
    return modarith.mul_mod_shoup(diff, rc.inv_q_last_op, rc.inv_q_last_qt, keep_mc.q)


def mod_t_and_divide_q_last(x, rt: RNSTool, rc: RescaleConsts):
    """BGV mod switch: exact division by q_last after adding the multiple of
    q_last that makes the last row 0 and keeps the value mod t
    (rns.cpp:1203-1240). [..., L, N] -> [..., L-1, N]."""
    keep_mc = ModConsts(*(a[:-1] for a in rt.q_mc))
    t = rt.t_mc
    x_last = x[..., -1:, :]
    # -(c_last mod t)·q_last^{-1} mod t, lifted to each q_i and times q_last
    neg_c = modarith.neg_mod(modarith.barrett_reduce_64(x_last, t.q, t.ratio1), t.q)
    neg_c = modarith.mul_mod_shoup(neg_c, *rt.inv_q_last_mod_t, t.q)
    delta = modarith.mul_mod(modarith.barrett_reduce_64(neg_c, keep_mc.q, keep_mc.ratio1),
                             rt.q_last_value, keep_mc.q, keep_mc.ratio0, keep_mc.ratio1)
    c_last = modarith.barrett_reduce_64(x_last, keep_mc.q, keep_mc.ratio1)
    acc = x[..., :-1, :] + (keep_mc.two_q - c_last - delta)
    return modarith.mul_mod_shoup(acc, rc.inv_q_last_op, rc.inv_q_last_qt, keep_mc.q)


def decrypt_scale_and_round(x, rt: RNSTool):
    """BFV decryption's rounding through the base {t, γ}
    (rns.cpp:1133-1201). [..., L, N] -> [..., 1, N] mod t."""
    t = rt.t_mc
    temp = modarith.mul_mod_shoup(x, *rt.prod_t_gamma_mod_q, rt.q_mc.q)
    tg = fast_convert_array(temp, rt.conv_q_to_t_gamma)
    tg = modarith.mul_mod_shoup(tg, *rt.neg_inv_q_mod_t_gamma, rt.conv_q_to_t_gamma.obase_mc.q)
    t_part, g_part = tg[..., 0:1, :], tg[..., 1:2, :]
    # the γ component stands for a centered value
    over = g_part > rt.gamma_div_2
    corr_pos = modarith.add_mod(
        t_part, modarith.barrett_reduce_64(rt.gamma_value - g_part, t.q, t.ratio1), t.q)
    corr_neg = modarith.sub_mod(
        t_part, modarith.barrett_reduce_64(g_part, t.q, t.ratio1), t.q)
    dest = torch.where(over, corr_pos, corr_neg)
    return modarith.mul_mod_shoup(dest, *rt.inv_gamma_mod_t, t.q)


def decrypt_modt(x, rt: RNSTool):
    """BGV decryption: the exact conversion q -> {t} (rns.cpp:1242-1246)."""
    return exact_convert_array(x, rt.conv_q_to_t)
