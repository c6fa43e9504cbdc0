r"""Hybrid (GHS-style) key switching: α-prime digits, α special primes.

The port of seal_tpu/ops/hybrid_keyswitch.py for CKKS. α = 1 is SEAL's own
key switching (one special prime, per-prime digits); α > 1 decomposes into
⌈L/α⌉ digits of α primes. Digit j covers key data primes D_j = [jα, (j+1)α);
the evaluator decomposes the target into y_j, the fast base extension of
[c·\hat{Q}'_{j,t}^{-1}]_{q_t} over the digit's primes, and the key for digit
j carries P mod q_i on the digit's rows, so Σ_j y_j·key_j ≡ P·c·s'
(mod Q_level). ModDown divides by P = Π specials with half-P centered
rounding, through one fast base conversion from the α special rows.

Host constants are exact Python ints built once per argument tuple
(functools.lru_cache) as CPU tensors; the evaluator moves each set to its
context's device once (SEALContext.on_device).
"""

from __future__ import annotations

import functools

import torch

from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.modring import ModConsts, make_mod_consts, shoup_pair, u64_tensor


def digit_ranges(L: int, alpha: int) -> list[range]:
    """Key-level digit partition restricted to the level's first L primes."""
    return [range(j * alpha, min((j + 1) * alpha, L)) for j in range(-(-L // alpha))]


def _split_tower(key_moduli: tuple, alpha: int, L: int):
    """(K, specials, P): the level's first L data primes, the α special
    primes and their product P."""
    K = list(key_moduli[:len(key_moduli) - alpha])[:L]
    specials = list(key_moduli[len(key_moduli) - alpha:])
    P = 1
    for p in specials:
        P *= p
    return K, specials, P


@functools.lru_cache(maxsize=None)
def decomp_consts(key_moduli: tuple, alpha: int, L: int):
    r"""Per digit j: (inv_hat_op, inv_hat_qt, q_dig) [a_j, 1] — the Shoup pair
    of [\hat{Q}'_{j,t}^{-1}]_{q_t} and the digit's moduli — and
    (hat_ext_op, hat_ext_qt) [a_j, I], the Shoup pair of \hat{Q}'_{j,t} mod
    each extended modulus (I = L data + α special rows)."""
    K, specials, _ = _split_tower(key_moduli, alpha, L)
    ext = K + specials
    per_digit = []
    for rows in digit_ranges(L, alpha):
        qd = [K[i] for i in rows]
        Qj = 1
        for q in qd:
            Qj *= q
        hats = [Qj // q for q in qd]
        inv_op, inv_qt = shoup_pair(
            [[pow(h % q, -1, q)] for h, q in zip(hats, qd)], [[q] for q in qd], "cpu")
        hat_op, hat_qt = shoup_pair(
            [[h % m for m in ext] for h in hats], [ext for _ in hats], "cpu")
        per_digit.append((inv_op, inv_qt, u64_tensor([[q] for q in qd], "cpu"),
                          hat_op, hat_qt))
    return tuple(per_digit)


@functools.lru_cache(maxsize=None)
def tail_consts(key_moduli: tuple, alpha: int, L: int) -> dict:
    """Constants of the CKKS ModDown by P (half-P centered rounding)."""
    K, specials, P = _split_tower(key_moduli, alpha, L)
    hats = [P // p for p in specials]
    half = P >> 1
    return {
        "p_mc": make_mod_consts(specials, "cpu"),
        "inv_hat_p": shoup_pair(
            [[pow(h % p, -1, p)] for h, p in zip(hats, specials)],
            [[p] for p in specials], "cpu"),
        "hat_p_q": shoup_pair([[h % q for q in K] for h in hats],
                              [K for _ in hats], "cpu"),
        "p_inv_q": shoup_pair([[pow(P % q, -1, q)] for q in K], [[q] for q in K], "cpu"),
        "half_p": u64_tensor([[half % p] for p in specials], "cpu"),
        "neg_half_q": u64_tensor([[q - half % q] for q in K], "cpu"),
    }


@functools.lru_cache(maxsize=None)
def fused_rescale_consts(key_moduli: tuple, alpha: int, L: int):
    """Shoup pair [L, 1] of P mod q_i on the L live data rows: the fused
    relinearize+rescale lifts the ciphertext body into the key-switch
    dividend as P·(c0, c1), so one centered division by P·q_last replaces
    the division by P followed by the division by q_last."""
    K, _, P = _split_tower(key_moduli, alpha, L)
    return shoup_pair([[P % q] for q in K], [[q] for q in K], "cpu")


def shoup_dot(w, hat_op, hat_qt, mc: ModConsts):
    """Σ_t w_t·hat_t mod q, fully reduced. w: [..., a, N], each row below
    its own modulus; hat: Shoup pair [a, I] per output modulus; mc: the I
    output moduli. Returns [..., I, N].

    Up to 4 terms: per-term Shoup-lazy products summed below 2a·q < 2^64,
    then a chain of conditional subtractions. More terms: a 128-bit sum
    and one Barrett-128. Both give the unique representative in [0, q)."""
    a = w.shape[-2]
    if a > 4:
        zero = torch.zeros(w.shape[:-2] + (mc.count, w.shape[-1]),
                           dtype=torch.int64, device=w.device)
        acc = (zero, zero)
        for t in range(a):
            acc = modarith.mul_add_128(acc, w[..., t:t + 1, :], hat_op[t][:, None])
        return modarith.barrett_reduce_128(acc[0], acc[1], mc.q, mc.ratio0, mc.ratio1)
    acc = None
    for t in range(a):
        term = modarith.mul_mod_shoup_lazy(
            w[..., t:t + 1, :], hat_op[t][:, None], hat_qt[t][:, None], mc.q)
        acc = term if acc is None else acc + term
    for k in range((2 * a - 1).bit_length() - 1, -1, -1):
        acc = modarith.cond_sub(acc, mc.q << k)
    return acc


def decompose(t_target, digits, per_digit, ext_mc: ModConsts):
    r"""Coefficient-domain target [L, N] -> digit rows [d, I, N] (before
    the NTT): y_j[i] = Σ_{t∈T_j} (t_t·[\hat{Q}'_{j,t}^{-1}]_{q_t} mod q_t)·
    (\hat{Q}'_{j,t} mod q_i)."""
    out = []
    for rows, (inv_op, inv_qt, q_dig, hat_op, hat_qt) in zip(digits, per_digit):
        w = modarith.mul_mod_shoup(t_target[rows.start:rows.stop], inv_op, inv_qt, q_dig)
        out.append(shoup_dot(w, hat_op, hat_qt, ext_mc))
    return torch.stack(out)


def diag_skip_ntt(rows, target, lvl_tables: ntt_mod.NTTTables,
                  special_tables: ntt_mod.NTTTables, dig_of: list[int]):
    """Forward NTT of the decomposed rows [d, L+α, N] with the CKKS diagonal
    skip: row i of digit dig_of[i] equals the coefficient-domain target row
    i exactly, so the NTT-form `target` [L, N] row is substituted instead of
    transformed. dig_of[i] = i with d = L is SEAL's α = 1 shortcut
    (evaluator.cpp:2488-2496); dig_of[i] = i // α is the hybrid digit map."""
    d, _, n = rows.shape
    L = target.shape[0]
    dev = rows.device
    out = torch.empty_like(rows)
    out[:, L:] = ntt_mod.ntt_forward(rows[:, L:], special_tables)
    eye = torch.tensor([[dig_of[i] == j for i in range(L)] for j in range(d)],
                       device=dev)[:, :, None]
    if d > 1:
        # the d-1 off-diagonal digits of each row i < L, then back in place
        jidx = torch.tensor([[j for j in range(d) if j != dig_of[i]]
                             for i in range(L)], device=dev).T[:, :, None]
        body = ntt_mod.ntt_forward(
            torch.gather(rows[:, :L], 0, jidx.expand(-1, -1, n)), lvl_tables)
        kidx = torch.tensor([[j if j < dig_of[i] else max(j - 1, 0)
                              for i in range(L)] for j in range(d)],
                            device=dev)[:, :, None]
        lvl = torch.gather(body, 0, kidx.expand(-1, -1, n))
    else:
        lvl = torch.zeros_like(rows[:, :L])
    out[:, :L] = torch.where(eye, target[None], lvl)
    return out


def mod_down(rows, c: dict, lvl_tables: ntt_mod.NTTTables,
             special_tables: ntt_mod.NTTTables, mc: ModConsts):
    """Divide NTT-form key-level rows [..., L+α, N] by P = Π specials with
    half-P centered rounding; returns [..., L, N] in NTT form (the CKKS
    tail of SEAL evaluator.cpp:2572-2676, one fast base conversion in place
    of the single-row lift). c = tail_consts(...) on the device."""
    L = mc.count
    spec = ntt_mod.ntt_inverse(rows[..., L:, :], special_tables)   # < p_k
    p_mc = c["p_mc"]
    y = modarith.add_mod(spec, c["half_p"], p_mc.q)
    w = modarith.mul_mod_shoup(y, *c["inv_hat_p"], p_mc.q)           # [.., α, N]
    r = shoup_dot(w, *c["hat_p_q"], mc) + c["neg_half_q"]            # < 2q
    r = ntt_mod.ntt_forward(r, lvl_tables, lazy=True)                # < 4q
    summed = rows[..., :L, :] + (mc.q << 2) - r
    return modarith.mul_mod_shoup(summed, *c["p_inv_q"], mc.q)
