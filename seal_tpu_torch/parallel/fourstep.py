"""The coefficient-sharded (sequence-parallel) negacyclic NTT, by the
four-step decomposition.

The port of seal_tpu/parallel/fourstep.py. For n = P·M, with the coefficient
axis split into P contiguous shards of M coefficients, the negacyclic NTT
out[j] = Σ_i a_i ψ^{i(2·br_n(j)+1)} (Harvey bit-reversed order, K1's) is

    b_i          = a_i · ψ^i                      (local pre-twiddle)
    c_r[i2]      = Σ_{i1} b[i1·M + i2] · w_P^{i1·r}  (P-point DFT across shards)
    d_r[i2]      = c_r[i2] · w^{i2·r}             (local twiddle)
    out shard p  = cyclic M-point NTT of d_r      (natural in, bit-reversed out)

with w = ψ², w_P = w^M and r = br_P(p): since br_n(p·M + j2) = br_M(j2)·P +
br_P(p), shard p's local result is exactly its block of the global output.
Every step is fully reduced mod q, so each route is K1's transform
(ops/ntt.py) bit for bit. The routes:

* `ntt_forward_local` / `ntt_inverse_local`: one device, the shard axis a
  batch axis, no collective;
* `ntt_forward_sharded` / `ntt_inverse_sharded` on the ranks of a Comm, each
  holding its [L, M] block: route "gather" exchanges the pre-twiddled block
  with one all_gather (O(n) bytes per rank), route "a2a" with two
  all_to_alls around a transposed DFT (O(n/P) bytes per rank; needs P | M).

The cyclic M-point sub-transforms are ops/ntt.py's plain butterflies over
cyclic root tables (the same stage order and lazy ranges as the negacyclic
tables), PyTorch ops on the tensor's device: seal_tpu computes them outside
any Pallas kernel too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.modring import ModConsts, make_mod_consts
from seal_tpu_torch.parallel.comm import Comm
from seal_tpu_torch.utils import numth


def _bitrev(i: int, bits: int) -> int:
    return numth.reverse_bits(i, bits) if bits else 0


def _shoup(values, qs, shape, device):
    """values: per prime a nested list of ints -> Shoup (operand, quotient)
    int64 tensors [L, *shape]."""
    ops, qts = [], []
    for row, q in zip(values, qs):
        flat = [int(v) for v in np.asarray(row, dtype=object).reshape(-1)]
        ops.append(flat)
        qts.append([(v << 64) // q for v in flat])

    def tensor(rows):
        u = np.array(rows, dtype=np.uint64).reshape((len(qs),) + shape)
        return torch.from_numpy(u.view(np.int64).copy()).to(device)

    return tensor(ops), tensor(qts)


@functools.lru_cache(maxsize=None)
def _host_tables(log_n: int, q: int, P: int) -> dict:
    """Exact integer tables of one prime (seal_tpu's _host_tables)."""
    n = 1 << log_n
    M = n // P
    log_p = P.bit_length() - 1
    log_m = log_n - log_p
    psi = numth.try_minimal_primitive_root(2 * n, q)
    if psi is None:
        raise ValueError(f"modulus {q:#x} does not support NTT of size {n}")
    ipsi = numth.invert_uint_mod(psi, q)
    w = psi * psi % q
    iw = numth.invert_uint_mod(w, q)
    wp = pow(w, M, q)
    iwp = numth.invert_uint_mod(wp, q)
    inv_p = numth.invert_uint_mod(P, q)
    br_p = [_bitrev(p, log_p) for p in range(P)]
    # cyclic M-point root tables in ops/ntt.py's layouts: forward
    # cyc[m + b] = w_M^{br_s(b)·M/(2m)}; inverse consumed per stage
    # s = log_m-1..1 from offset 1, 1/M folded into the last stage
    wm = pow(w, P, q)
    iwm = numth.invert_uint_mod(wm, q)
    cyc, icyc = [1] * M, [1] * M
    for s in range(log_m):
        m = 1 << s
        for b in range(m):
            cyc[m + b] = pow(wm, _bitrev(b, s) * (M // (2 * m)), q)
    offset = 1
    for s in range(log_m - 1, 0, -1):
        m = 1 << s
        for b in range(m):
            icyc[offset + b] = pow(iwm, _bitrev(b, s) * (M // (2 * m)), q)
        offset += m
    return dict(
        psi=[pow(psi, i, q) for i in range(n)],
        ipsi=[pow(ipsi, i, q) for i in range(n)],
        # gather route, row p = shard p: w_P^{i1·br(p)} and w_P^{-p·br(p')}/P
        wp=[[pow(wp, i1 * br_p[p] % P, q) for i1 in range(P)] for p in range(P)],
        iwp=[[pow(iwp, p * br_p[pp] % P, q) * inv_p % q for pp in range(P)]
             for p in range(P)],
        tw=[[pow(w, i2 * br_p[p] % n, q) for i2 in range(M)] for p in range(P)],
        itw=[[pow(iw, i2 * br_p[p] % n, q) for i2 in range(M)] for p in range(P)],
        # a2a route: rows by destination shard p', columns by source shard
        wp2=[[pow(wp, i1 * br_p[pp] % P, q) for i1 in range(P)] for pp in range(P)],
        iwp2=[[pow(iwp, i1 * br_p[p] % P, q) * inv_p % q for p in range(P)]
              for i1 in range(P)],
        cyc=cyc, icyc=icyc, inv_m=numth.invert_uint_mod(M, q))


class FourStepTables(NamedTuple):
    """Tables of a P-way four-step transform of an L-prime tower on one
    device: Shoup pairs (op, qt), [L, ...]; rows indexed by shard p."""

    log_n: int
    shards: int
    mc: ModConsts          # [L, 1]
    psi: tuple             # [L, n]  ψ^i
    ipsi: tuple            # [L, n]  ψ^{-i}
    wp: tuple              # [L, P, P]
    iwp: tuple             # [L, P, P]
    tw: tuple              # [L, P, M]
    itw: tuple             # [L, P, M]
    wp2: tuple             # [L, P, P]
    iwp2: tuple            # [L, P, P]
    cyc: ntt_mod.NTTTables  # the cyclic M-point sub-transform


def build_fourstep_tables(log_n: int, moduli, num_shards: int, device) -> FourStepTables:
    P = int(num_shards)
    if P < 2 or P & (P - 1):
        raise ValueError("num_shards must be a power of two >= 2")
    n = 1 << log_n
    if 4 * P > n:
        raise ValueError("a shard must hold at least 4 coefficients")
    qs = [int(m) for m in moduli]
    hosts = [_host_tables(log_n, q, P) for q in qs]
    M = n // P

    def tab(key, shape):
        return _shoup([h[key] for h in hosts], qs, shape, device)

    mc = make_mod_consts(qs, device)
    inv_m = tab("inv_m", (1,))
    cyc_op, cyc_qt = tab("cyc", (M,))
    icyc_op, icyc_qt = tab("icyc", (M,))
    cyc = ntt_mod.NTTTables(log_n - (P.bit_length() - 1), mc, cyc_op, cyc_qt, icyc_op,
                            icyc_qt, *inv_m, *inv_m)
    return FourStepTables(
        log_n, P, mc, tab("psi", (n,)), tab("ipsi", (n,)), tab("wp", (P, P)),
        tab("iwp", (P, P)), tab("tw", (P, M)), tab("itw", (P, M)), tab("wp2", (P, P)),
        tab("iwp2", (P, P)), cyc)


def _mul(x, pair, q):
    return modarith.mul_mod_shoup(x, pair[0], pair[1], q)


def _col(pair, *index):
    """[L, 1] column of a [L, ...] Shoup pair."""
    return tuple(a[(slice(None),) + index].unsqueeze(-1) for a in pair)


def _combine(rows, weights, q):
    """Σ_k rows[k] · weights[k] mod q over rows [K, L, m], with weights a
    list of K [L, 1] Shoup pairs: fully reduced at every step."""
    acc = None
    for k, w in enumerate(weights):
        term = _mul(rows[k], w, q)
        acc = term if acc is None else modarith.add_mod(acc, term, q)
    return acc


def _check(x: torch.Tensor, t: FourStepTables, cols: int):
    if x.dim() != 2 or x.shape[0] != t.mc.count or x.shape[1] != cols:
        raise ValueError(f"the four-step NTT takes [{t.mc.count}, {cols}], "
                         f"got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# one device: the shard axis as a batch axis
# ---------------------------------------------------------------------------

def _split(a: torch.Tensor, P: int) -> torch.Tensor:
    """[L, n] -> [P, L, M]: block p of every row."""
    return a.reshape(a.shape[0], P, -1).movedim(1, 0)


def _join(a: torch.Tensor) -> torch.Tensor:
    """[P, L, M] -> [L, n]."""
    return a.movedim(0, 1).reshape(a.shape[1], -1)


def ntt_forward_local(x: torch.Tensor, t: FourStepTables) -> torch.Tensor:
    """Forward negacyclic NTT of x [L, n] (natural order, < q) by the four
    steps on one device: K1's output (bit-reversed order, < q) bit for bit."""
    P, q = t.shards, t.mc.q
    _check(x, t, 1 << t.log_n)
    b = _mul(_split(x, P), tuple(_split(a, P) for a in t.psi), q)       # [P, L, M]
    c = torch.stack([_combine(b, [_col(t.wp, p, i1) for i1 in range(P)], q)
                     for p in range(P)])
    d = _mul(c, tuple(a.movedim(1, 0) for a in t.tw), q)
    return _join(ntt_mod.ntt_forward_plain(d, t.cyc))


def ntt_inverse_local(x: torch.Tensor, t: FourStepTables) -> torch.Tensor:
    """Inverse negacyclic NTT of x [L, n] (bit-reversed order, < q) on one
    device: natural order, < q, K1's inverse bit for bit."""
    P, q = t.shards, t.mc.q
    _check(x, t, 1 << t.log_n)
    e = ntt_mod.ntt_inverse_plain(_split(x, P), t.cyc)
    e = _mul(e, tuple(a.movedim(1, 0) for a in t.itw), q)
    b = torch.stack([_combine(e, [_col(t.iwp, p, r) for r in range(P)], q)
                     for p in range(P)])
    return _join(_mul(b, tuple(_split(a, P) for a in t.ipsi), q))


# ---------------------------------------------------------------------------
# across the ranks of a Comm: rank p holds block p, [L, M]
# ---------------------------------------------------------------------------

def _block(pair, p: int, M: int):
    return tuple(a[:, p * M:(p + 1) * M] for a in pair)


def _chunks(x: torch.Tensor, P: int) -> torch.Tensor:
    """[L, M] -> [P, L, M/P]: chunk j of the block, bound for rank j."""
    return x.reshape(x.shape[0], P, -1).movedim(1, 0).contiguous()


def _unchunks(y: torch.Tensor) -> torch.Tensor:
    """[P, L, M/P] with row j from rank j -> [L, M]."""
    return y.movedim(0, 1).reshape(y.shape[1], -1)


def pick_route(t: FourStepTables, route: str) -> str:
    """'a2a' (two all_to_alls, O(n/P) bytes per rank) unless the block does
    not split into P chunks (P ∤ M); 'gather' (one all_gather, O(n)) when
    asked for (seal_tpu's _pick_comm)."""
    if route not in ("a2a", "gather"):
        raise ValueError(f"route must be 'a2a' or 'gather', got {route!r}")
    M = (1 << t.log_n) // t.shards
    return "gather" if route == "gather" or M % t.shards else "a2a"


def _check_comm(comm: Comm, t: FourStepTables):
    if comm.size != t.shards:
        raise ValueError(f"tables for {t.shards} shards on a group of {comm.size} ranks")


def ntt_forward_sharded(x: torch.Tensor, t: FourStepTables, comm: Comm,
                        route: str = "a2a") -> torch.Tensor:
    """Forward NTT of a tower whose coefficient axis is split over the
    ranks of `comm`: x is this rank's block [L, M] (natural order); returns
    its block [L, M] of K1's bit-reversed output, bit for bit."""
    _check_comm(comm, t)
    P, p, q = t.shards, comm.rank, t.mc.q
    M = (1 << t.log_n) // P
    _check(x, t, M)
    b = _mul(x, _block(t.psi, p, M), q)
    if pick_route(t, route) == "gather":
        g = comm.all_gather(b)                                      # [P, L, M]
        c = _combine(g, [_col(t.wp, p, i1) for i1 in range(P)], q)
    else:
        recv = comm.all_to_all(_chunks(b, P))                       # [P, L, M/P]
        rows = torch.stack([_combine(recv, [_col(t.wp2, pp, s) for s in range(P)], q)
                            for pp in range(P)])
        c = _unchunks(comm.all_to_all(rows))
    d = _mul(c, tuple(a[:, p] for a in t.tw), q)
    return ntt_mod.ntt_forward_plain(d, t.cyc)


def ntt_inverse_sharded(x: torch.Tensor, t: FourStepTables, comm: Comm,
                        route: str = "a2a") -> torch.Tensor:
    """Inverse NTT of this rank's block [L, M] of a bit-reversed transform:
    its block [L, M] of K1's natural-order inverse, bit for bit."""
    _check_comm(comm, t)
    P, p, q = t.shards, comm.rank, t.mc.q
    M = (1 << t.log_n) // P
    _check(x, t, M)
    e = ntt_mod.ntt_inverse_plain(x, t.cyc)
    e = _mul(e, tuple(a[:, p] for a in t.itw), q)
    if pick_route(t, route) == "gather":
        g = comm.all_gather(e)
        b = _combine(g, [_col(t.iwp, p, r) for r in range(P)], q)
    else:
        recv = comm.all_to_all(_chunks(e, P))
        rows = torch.stack([_combine(recv, [_col(t.iwp2, i1, s) for s in range(P)], q)
                            for i1 in range(P)])
        b = _unchunks(comm.all_to_all(rows))
    return _mul(b, _block(t.ipsi, p, M), q)
