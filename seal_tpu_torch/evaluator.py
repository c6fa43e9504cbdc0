"""Evaluator: CKKS multiply, relinearize, rescale and rotations over
tensors on the context's device.

The port of the CKKS path of seal_tpu/evaluator.py (SEAL evaluator.cpp:
negate/add/sub :124-350, CKKS multiply :569-708, relinearize :1104-1159,
mod switch :1161-1340, rescale :1441-1479, apply_galois :2221-2323, rotate
:2325-2380, switch_key :2382-2677) and seal_tpu's hoisted rotations. The
kernels run through ops/ntt.py (every transform) and ops/keyswitch.py (the
key-switch inner product, by the 128-bit route or, with
config.keyswitch_shoup, the Shoup-quotient route); the automorphisms are
gathers (ops/galois.py) and the elementwise passes PyTorch ops, on the same
device.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.config import config
from seal_tpu_torch.context import ContextData, SEALContext
from seal_tpu_torch.dtypes import Ciphertext, GaloisKeys, KSwitchKeys, RelinKeys
from seal_tpu_torch.ops import hybrid_keyswitch as hyb
from seal_tpu_torch.ops import modarith, modring
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops import rns
from seal_tpu_torch.ops.galois import GaloisTool
from seal_tpu_torch.ops.keyswitch import (
    key_quotients, keyswitch_inner, keyswitch_inner_shoup, pack_mod_consts)
from seal_tpu_torch.ops.modring import make_mod_consts, shoup_pair, u64_tensor
from seal_tpu_torch.utils import numth


class Evaluator:
    """CKKS operations; the context accepts CKKS parameters only."""

    def __init__(self, context: SEALContext):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context

    # -- helpers ---------------------------------------------------------------

    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        return cd

    @staticmethod
    def _check_same(a: Ciphertext, b: Ciphertext):
        if a.parms_id != b.parms_id:
            raise ValueError("encrypted parameters mismatch")
        if a.is_ntt_form != b.is_ntt_form:
            raise ValueError("NTT form mismatch")

    @staticmethod
    def _check_transparent(ct: Ciphertext):
        """SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT, on as in SEAL's default
        build (evaluator.cpp:1152-1158)."""
        if ct.is_transparent():
            raise ValueError("result ciphertext is transparent")

    def _key(self):
        """(key ContextData, key moduli tuple, α)."""
        key_cd = self.context.key_context_data()
        return (key_cd, tuple(key_cd.key_moduli()),
                key_cd.parms.special_modulus_size)

    # -- negate / add / sub ------------------------------------------------------

    def negate(self, ct: Ciphertext) -> Ciphertext:
        out = ct.copy()
        out.data = modring.negate_poly(ct.data, self._cd(ct).mod_consts)
        return out

    def _add_sub(self, a: Ciphertext, b: Ciphertext, sub: bool) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        if not _scales_close(a.scale, b.scale):
            raise ValueError("scale mismatch")
        mc = cd.mod_consts
        polys = []
        for j in range(max(a.size, b.size)):
            if j < min(a.size, b.size):
                op = modring.sub_poly if sub else modring.add_poly
                polys.append(op(a.poly(j), b.poly(j), mc))
            elif j < a.size:
                polys.append(a.poly(j))
            else:
                polys.append(modring.negate_poly(b.poly(j), mc) if sub else b.poly(j))
        out = a.copy()
        out.data = torch.stack(polys)
        return out

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, sub=False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, sub=True)

    # -- multiplication ----------------------------------------------------------

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """CKKS: the NTT-domain dyadic convolution (evaluator.cpp:569-708)."""
        self._check_same(a, b)
        if not (a.is_ntt_form and b.is_ntt_form):
            raise ValueError("CKKS multiply inputs must be in NTT form")
        cd = self._cd(a)
        mc = cd.mod_consts
        out = [None] * (a.size + b.size - 1)
        for i in range(a.size):
            for j in range(b.size):
                p = modring.dyadic_product(a.poly(i), b.poly(j), mc)
                out[i + j] = p if out[i + j] is None else modring.add_poly(out[i + j], p, mc)
        res = a.copy()
        res.data = torch.stack(out)
        res.scale = a.scale * b.scale
        _check_scale(res.scale, cd)
        return res

    # -- key switching -----------------------------------------------------------

    def _ext(self, L: int) -> dict:
        """Constants of the extended tower of a level with L data primes:
        its primes then the α special primes."""
        _, key_moduli, alpha = self._key()
        L_key = len(key_moduli)

        def build():
            idx = list(range(L)) + list(range(L_key - alpha, L_key))
            moduli = [key_moduli[i] for i in idx]
            return {
                "mc": make_mod_consts(moduli, "cpu"),
                "consts": pack_mod_consts(moduli, "cpu"),
                "max_q": max(moduli),
                "gather": None if idx == list(range(L_key)) else torch.tensor(idx),
            }

        return self.context.on_device(("ext", L), build)

    def _special_tables(self):
        key_cd, key_moduli, alpha = self._key()
        return key_cd.ntt_rows(slice(len(key_moduli) - alpha, len(key_moduli)))

    def _switch_key_decompose(self, ct: Ciphertext, target) -> torch.Tensor:
        """RNS-decompose `target` (NTT form [L, N]) and lift each digit into
        the special-prime-extended base, NTT'd: t_op [d, L+α, N]
        (evaluator.cpp:2475-2514)."""
        cd = self._cd(ct)
        _, key_moduli, alpha = self._key()
        L = cd.coeff_modulus_size
        ext = self._ext(L)
        t_target = ntt_mod.ntt_inverse(target, cd.ntt_tables)
        if alpha > 1:
            per_digit = self.context.on_device(
                ("decomp", L), lambda: hyb.decomp_consts(key_moduli, alpha, L))
            digits = hyb.digit_ranges(L, alpha)
            y = hyb.decompose(t_target, digits, per_digit, ext["mc"])
            dig_of = [min(i // alpha, len(digits) - 1) for i in range(L)]
        else:
            # row J of the target reduced into every extended row I
            mc = ext["mc"]
            y = modarith.barrett_reduce_64(t_target[:, None, :], mc.q, mc.ratio1)
            dig_of = list(range(L))
        return hyb.diag_skip_ntt(y, target, cd.ntt_tables, self._special_tables(), dig_of)

    def _key_quot(self, keys_obj: KSwitchKeys, index: int):
        """Shoup quotients of keys_obj.keys[index] when config.keyswitch_shoup
        is set, else None. Computed the first time a key is used and cached
        on the key object, keyed on the key tensor itself, so a replaced key
        is never served stale quotients."""
        if not config.keyswitch_shoup:
            return None
        return self._quot_cached(keys_obj.__dict__.setdefault("_shoup_quot", {}),
                                 index, keys_obj.keys[index])

    def _permuted_key_quot(self, galois_keys: GaloisKeys, elt: int, gt: GaloisTool):
        """Shoup quotients of the permuted Galois key of `elt`
        (_permuted_keys), cached the same way."""
        if not config.keyswitch_shoup:
            return None
        return self._quot_cached(galois_keys.__dict__.setdefault("_perm_quot", {}),
                                 elt, self._permuted_keys(galois_keys, elt, gt))

    def _quot_cached(self, cache: dict, slot, key: torch.Tensor) -> torch.Tensor:
        hit = cache.get(slot)
        if hit is None or hit[0] is not key:
            hit = (key, key_quotients(key, self._key()[1]))
            cache[slot] = hit
        return hit[1]

    def _switch_key_reduce(self, ct: Ciphertext, t_op, keys, keys_quot=None) -> torch.Tensor:
        """⟨decomposed target, key⟩ reduced to [0, q): [2, L+α, N]
        (evaluator.cpp:2517-2547). With the key's Shoup quotients and a
        contraction whose lazy sum fits 64 bits, the Shoup-quotient route
        (K3) replaces the 128-bit one (K2): the same bits."""
        ext = self._ext(self._cd(ct).coeff_modulus_size)
        d = t_op.shape[0]
        keys = keys[:d]
        if ext["gather"] is not None:
            keys = keys.index_select(2, ext["gather"])
        if keys_quot is not None and 2 * d * ext["max_q"] < 1 << 64:
            keys_quot = keys_quot[:d]
            if ext["gather"] is not None:
                keys_quot = keys_quot.index_select(2, ext["gather"])
            return keyswitch_inner_shoup(t_op, keys, keys_quot, ext["consts"], ext["max_q"])
        return keyswitch_inner(t_op, keys, ext["consts"])

    def _switch_key_prod(self, ct: Ciphertext, target, keys, keys_quot=None) -> torch.Tensor:
        return self._switch_key_reduce(
            ct, self._switch_key_decompose(ct, target), keys, keys_quot)

    def _switch_key_inner(self, ct: Ciphertext, t_op, keys, keys_quot=None) -> Ciphertext:
        """Inner product of a decomposed target with one kswitch key, then
        the division by the special prime(s)."""
        return self._switch_key_tail(ct, self._switch_key_reduce(ct, t_op, keys, keys_quot))

    def _switch_key_tail(self, ct: Ciphertext, prod) -> Ciphertext:
        """Divide the reduced inner product [2, L+α, N] by the special
        prime(s); returns the size-2 delta (evaluator.cpp:2572-2676)."""
        cd = self._cd(ct)
        key_cd, key_moduli, alpha = self._key()
        L = cd.coeff_modulus_size
        L_key = len(key_moduli)
        mc = cd.mod_consts
        if alpha > 1:
            c = self.context.on_device(
                ("tail", L), lambda: hyb.tail_consts(key_moduli, alpha, L))
            out = hyb.mod_down(prod, c, cd.ntt_tables, self._special_tables(), mc)
        else:
            qk = key_moduli[-1]

            def build():
                half = qk >> 1
                inv_op, inv_qt = shoup_pair(
                    [[pow(qk, -1, q)] for q in key_moduli[:L]],
                    [[q] for q in key_moduli[:L]], "cpu")
                return {"half": u64_tensor([[half]], "cpu"),
                        "neg_half": u64_tensor([[q - half % q] for q in key_moduli[:L]], "cpu"),
                        "inv_op": inv_op, "inv_qt": inv_qt}

            c = self.context.on_device(("tail1", L), build)
            last_tables = key_cd.ntt_rows(slice(L_key - 1, L_key))
            t_last = ntt_mod.ntt_inverse(prod[:, L:], last_tables)
            t_last = modarith.add_mod(t_last, c["half"], last_tables.mc.q)
            t_red = modarith.barrett_reduce_64(t_last, mc.q, mc.ratio1) + c["neg_half"]
            t_red = ntt_mod.ntt_forward(t_red, cd.ntt_tables, lazy=True)    # < 4q
            summed = prod[:, :L] + (mc.q << 2) - t_red
            out = modarith.mul_mod_shoup(summed, c["inv_op"], c["inv_qt"], mc.q)
        return Ciphertext(out, ct.parms_id, ct.is_ntt_form, ct.scale,
                          ct.correction_factor)

    def _check_relin_keys(self, relin_keys: RelinKeys):
        if tuple(relin_keys.parms_id) != tuple(self.context.key_parms_id):
            raise ValueError("relin_keys is not valid for encryption parameters")

    def relinearize(self, ct: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        """Reduce the ciphertext size back to 2 (evaluator.cpp:1104-1159)."""
        self._check_relin_keys(relin_keys)
        if ct.size == 2:
            return ct.copy()
        cur = ct
        while cur.size > 2:
            cur = self._relin_step(cur, relin_keys)
        self._check_transparent(cur)
        return cur

    def _relin_step(self, cur: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        """Absorb the highest ciphertext power through one key switch."""
        size = cur.size
        delta = self._switch_key_tail(cur, self._switch_key_prod(
            cur, cur.poly(size - 1), relin_keys.key(size - 1),
            self._key_quot(relin_keys, relin_keys.get_index(size - 1))))
        mc = self._cd(cur).mod_consts
        head = modring.add_poly(cur.data[:2], delta.data, mc)
        out = cur.copy()
        out.data = torch.cat([head, cur.data[2:size - 1]])
        return out

    def relinearize_rescale(self, ct: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        """Fused CKKS relinearize + rescale_to_next: the body is lifted into
        the key-switch dividend as P·(c0, c1) + ⟨decomp(c2), ksk⟩ and ONE
        centered division by P·q_last replaces the two sequential
        mod-downs. Like seal_tpu's, it is not bit-exact to the sequential
        pair (one rounding instead of two) but decrypts to the same values
        within noise; it is bit-exact to seal_tpu.relinearize_rescale."""
        self._check_relin_keys(relin_keys)
        cd = self._cd(ct)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        cur = ct
        while cur.size > 3:
            cur = self._relin_step(cur, relin_keys)
        if cur.size == 2:
            return self.rescale_to_next(cur)

        key_cd, key_moduli, alpha = self._key()
        L = cd.coeff_modulus_size
        L_key = len(key_moduli)
        mc = cd.mod_consts
        prod = self._switch_key_prod(cur, cur.poly(2), relin_keys.key(2),
                                     self._key_quot(relin_keys, relin_keys.get_index(2)))
        # the combined divisor tower: q_last then the α special primes
        km2 = tuple(cd.key_moduli()) + key_moduli[L_key - alpha:]
        c = self.context.on_device(
            ("fused", L), lambda: {
                "tail": hyb.tail_consts(km2, alpha + 1, L - 1),
                "lift": hyb.fused_rescale_consts(key_moduli, alpha, L)})
        spec_tables = key_cd.cached(
            ("fused_tables", L),
            lambda: key_cd.ntt_tables.rows([L - 1] + list(range(L_key - alpha, L_key))))
        lift = modarith.mul_mod_shoup(cur.data[:2], *c["lift"], mc.q)
        rows = torch.cat([modarith.add_mod(prod[:, :L], lift, mc.q), prod[:, L:]], dim=1)
        out = Ciphertext(
            hyb.mod_down(rows, c["tail"], next_cd.ntt_tables, spec_tables,
                         next_cd.mod_consts),
            parms_id=tuple(next_cd.parms_id), is_ntt_form=cur.is_ntt_form,
            scale=cur.scale / cd.key_moduli()[-1],
            correction_factor=cur.correction_factor)
        self._check_transparent(out)
        return out

    # -- modulus switching ---------------------------------------------------------

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """CKKS: drop the last RNS row, no scaling (mod_switch_drop_to_next)."""
        next_cd = self._cd(ct).next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        return Ciphertext(ct.data[:, :-1], tuple(next_cd.parms_id), ct.is_ntt_form,
                          ct.scale, ct.correction_factor)

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        """CKKS rescaling by the last prime (evaluator.cpp:1441-1479)."""
        cd = self._cd(ct)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        L = cd.coeff_modulus_size
        data = rns.divide_and_round_q_last_ntt(
            ct.data, cd.rescale_consts, next_cd.ntt_tables, cd.ntt_rows(slice(L - 1, L)))
        return Ciphertext(data, tuple(next_cd.parms_id), ct.is_ntt_form,
                          ct.scale / cd.key_moduli()[-1], ct.correction_factor)

    # -- Galois automorphisms and rotations ------------------------------------------

    def apply_galois(self, ct: Ciphertext, galois_elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        """x -> x^elt on both polynomials, then a key switch of c1 back to
        the secret key (evaluator.cpp:2221-2323)."""
        cd = self._cd(ct)
        gt = cd.galois_tool
        if not galois_keys.has_key(galois_elt):
            raise ValueError("Galois key not present")
        _check_rotatable(ct)
        c0 = gt.apply_galois_ntt(ct.poly(0), galois_elt)
        c1 = gt.apply_galois_ntt(ct.poly(1), galois_elt)
        delta = self._switch_key_tail(ct, self._switch_key_prod(
            ct, c1, galois_keys.key(galois_elt),
            self._key_quot(galois_keys, galois_keys.get_index(galois_elt))))
        out = ct.copy()
        out.data = torch.stack([modring.add_poly(c0, delta.poly(0), cd.mod_consts),
                                delta.poly(1)])
        self._check_transparent(out)
        return out

    def rotate_vector(self, ct: Ciphertext, steps: int,
                      galois_keys: GaloisKeys) -> Ciphertext:
        """CKKS slot rotation by `steps` (left for positive steps)."""
        return self._rotate_internal(ct, steps, galois_keys)

    def complex_conjugate(self, ct: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        return self.apply_galois(ct, self._cd(ct).galois_tool.get_elt_from_step(0),
                                 galois_keys)

    def _rotate_internal(self, ct: Ciphertext, steps: int,
                         galois_keys: GaloisKeys) -> Ciphertext:
        if steps == 0:
            return ct.copy()
        elt = self._cd(ct).galois_tool.get_elt_from_step(steps)
        if galois_keys.has_key(elt):
            return self.apply_galois(ct, elt, galois_keys)
        # no key of its own: the NAF decomposition, one key switch per term
        # (evaluator.cpp:2325-2380)
        naf_steps = numth.naf(steps)
        if len(naf_steps) == 1:
            raise ValueError("Galois key not present")
        for s in naf_steps:
            ct = self._rotate_internal(ct, s, galois_keys)
        return ct

    def rotate_batch_hoisted(self, ct: Ciphertext, steps: list[int],
                             galois_keys: GaloisKeys) -> list[Ciphertext]:
        """Hoisted rotations (Halevi-Shoup), seal_tpu's fast path beside
        SEAL's one-by-one rotations: c1 is decomposed and lifted once, and
        each rotation is a key inner product on that shared operand. Decrypts
        to the same values as rotate_vector; the bits differ from it only in
        the special-prime rounding, and are seal_tpu's on both of its
        branches:
        * up to 16 nonzero steps: per step the operand is contracted with the
          key permuted by the inverse automorphism, and the output is
          permuted (seal_tpu's _hoisted_one);
        * more: per step the operand is permuted and contracted with the key
          as it is (seal_tpu's lax.scan body, here a loop)."""
        _check_rotatable(ct)
        cd = self._cd(ct)
        gt = cd.galois_tool
        mc = cd.mod_consts
        elts = [gt.get_elt_from_step(s) for s in steps]
        for s, e in zip(steps, elts):
            if s != 0 and not galois_keys.has_key(e):
                raise ValueError(f"Galois key for step {s} not present")
        t_op = self._switch_key_decompose(ct, ct.poly(1))
        c0 = ct.poly(0)
        live = [(s, e) for s, e in zip(steps, elts) if s != 0]
        by_step = {}
        for s, elt in live:
            if len(live) <= 16:
                delta = self._switch_key_inner(
                    ct, t_op, self._permuted_keys(galois_keys, elt, gt),
                    self._permuted_key_quot(galois_keys, elt, gt))
                data = gt.apply_galois_ntt(torch.stack(
                    [modring.add_poly(c0, delta.poly(0), mc), delta.poly(1)]), elt)
            else:
                perm = gt.ntt_index(elt)
                delta = self._switch_key_inner(
                    ct, t_op.index_select(-1, perm), galois_keys.key(elt),
                    self._key_quot(galois_keys, galois_keys.get_index(elt)))
                data = torch.stack([modring.add_poly(c0.index_select(-1, perm),
                                                     delta.poly(0), mc), delta.poly(1)])
            out = ct.copy()
            out.data = data
            by_step[s] = out
        return [by_step[s] if s != 0 else ct.copy() for s in steps]

    @staticmethod
    def _permuted_keys(galois_keys: GaloisKeys, elt: int, gt: GaloisTool) -> torch.Tensor:
        """The Galois key of `elt` gathered by the inverse NTT-domain
        permutation, cached on the key object per element and keyed on the
        key tensor: Σ_j t_j ⊙ perm⁻¹(k_j), permuted, is Σ_j perm(t_j) ⊙ k_j."""
        cache = galois_keys.__dict__.setdefault("_perm_cache", {})
        key = galois_keys.key(elt)
        hit = cache.get(elt)
        if hit is None or hit[0] is not key:
            hit = (key, key.index_select(-1, gt.ntt_inverse_index(elt)))
            cache[elt] = hit
        return hit[1]


def _check_rotatable(ct: Ciphertext):
    if ct.size != 2:
        raise ValueError("encrypted size must be 2")
    if not ct.is_ntt_form:
        raise ValueError("CKKS encrypted must be in NTT form")


def _scales_close(a: float, b: float) -> bool:
    return abs(a - b) <= max(abs(a), abs(b)) * 1e-10


def _check_scale(scale: float, cd: ContextData):
    """Scale must stay positive and below the total coeff modulus
    (evaluator.cpp is_scale_within_bounds)."""
    if not scale > 0 or int(scale).bit_length() >= cd.total_coeff_modulus_bit_count:
        raise ValueError("scale out of bounds")
