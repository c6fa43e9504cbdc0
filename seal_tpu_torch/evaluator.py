"""Evaluator: CKKS, BFV and BGV operations over tensors on the context's
device.

The port of seal_tpu/evaluator.py (SEAL evaluator.cpp: BGV correction
factors :56-118, negate/add/sub :124-350, BFV BEHZ multiply :395-567, CKKS
multiply :569-708, BGV multiply :710-794, square :831-1103, relinearize
:1104-1159, mod switch :1161-1340, rescale :1441-1479, BFV/BGV plain ops
:1692-2031, apply_galois :2221-2323, rotate :2325-2380, switch_key
:2382-2677) and seal_tpu's hoisted CKKS rotations. The kernels run through
ops/ntt.py (every transform) and ops/keyswitch.py (the key-switch inner
product, by the 128-bit route or, with config.keyswitch_shoup, the
Shoup-quotient route); the BEHZ base conversions are ops/rns.py, the
automorphisms gathers (ops/galois.py), and the elementwise passes PyTorch
ops, on the same device. CKKS ciphertexts are in NTT form, BFV and BGV
ciphertexts in coefficient form.

Every op takes a batch: ciphertexts with leading dimensions [*batch, size,
L, N] that share their metadata (dtypes.py), the PyTorch form of bench.py's
jax.vmap over these ops. The polynomial axis is dimension -3 throughout;
the batch rides along as more rows of every K1 call and as the batch axis
of K2/K3, which share one key across it, so a batched op launches each
kernel as often as one unbatched op does. A plaintext operand may be one
plaintext, shared by the batch, or a batch of the same shape.

Besides SEAL's ops: add_many, multiply_many and exponentiate, the plain
mod switches, rescale_to, and an `<op>_inplace` twin of every op that
mutates in SEAL (evaluator.h), which runs the op and rebinds the result
onto its first argument, as seal_tpu's do.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.config import config
from seal_tpu_torch.context import ContextData, SEALContext
from seal_tpu_torch.dtypes import Ciphertext, GaloisKeys, KSwitchKeys, Plaintext, RelinKeys
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.ops import hybrid_keyswitch as hyb
from seal_tpu_torch.ops import modarith, modring
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops import rns
from seal_tpu_torch.ops.galois import GaloisTool
from seal_tpu_torch.ops.keyswitch import (
    key_quotients, keyswitch_inner, keyswitch_inner_shoup, pack_mod_consts)
from seal_tpu_torch.ops.modring import make_mod_consts, shoup_pair
from seal_tpu_torch.plain_lift import (
    lifted_plain_rows, plain_coeffs, plain_to_rns_rows, scaled_plain_rows)
from seal_tpu_torch.utils import numth


class Evaluator:
    """Homomorphic operations of the context's scheme."""

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
        if a.batch_shape != b.batch_shape:
            raise ValueError(f"batch shapes {a.batch_shape} and {b.batch_shape} differ")

    @staticmethod
    def _check_transparent(ct: Ciphertext):
        """SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT (evaluator.cpp:1152-1158),
        under config.throw_on_transparent_ciphertext like seal_tpu's; off,
        the op does not read the device. Skipped while a CUDA graph is
        being captured (jit.py), as seal_tpu skips it for traced data: the
        eager call before each capture still checks."""
        if (config.throw_on_transparent_ciphertext and not _capturing(ct.data)
                and ct.is_transparent()):
            raise ValueError("result ciphertext is transparent")

    def _scheme(self) -> SchemeType:
        return self.context.key_context_data().parms.scheme

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

    @staticmethod
    def _balance_correction_factors(f1: int, f2: int, t: int):
        """BGV: (f0, e1, e2) with e1·f1 ≡ e2·f2 ≡ f0 (mod t) and the
        smallest balanced |e1| + |e2|, by extended Euclid on f2/f1 mod t
        (evaluator.cpp:56-118)."""
        half_t = t // 2

        def sum_abs(x, y):
            return abs(x - t if x > half_t else x) + abs(y - t if y > half_t else y)

        ratio = numth.invert_uint_mod(f1, t) * f2 % t
        e1, e2 = ratio, 1
        best = sum_abs(e1, e2)
        prev_a, a = t, ratio
        prev_b, b = 0, 1
        while a != 0:
            q = prev_a // a
            prev_a, a = a, prev_a - q * a
            prev_b, b = b, prev_b - b * q
            a_mod, b_mod = a % t, b % t
            if a_mod != 0 and numth.gcd(a_mod, t) == 1 and sum_abs(a_mod, b_mod) < best:
                best = sum_abs(a_mod, b_mod)
                e1, e2 = a_mod, b_mod
        return e1 * f1 % t, e1, e2

    @staticmethod
    def _scale_by(data, scalar: int, cd: ContextData):
        """data · scalar mod q_i, every polynomial. The scalar (a value mod
        t) and its Shoup quotients are made on the device, so no host copy
        blocks a CUDA graph capture."""
        mc = cd.mod_consts
        op = torch.remainder(torch.full_like(mc.q, scalar), mc.q)
        qt = modarith.shoup_quotient(op, mc.q, mc.ratio0, mc.ratio1)
        return modarith.mul_mod_shoup(data, op, qt, mc.q)

    def _add_sub(self, a: Ciphertext, b: Ciphertext, sub: bool) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        scheme = cd.parms.scheme
        if scheme == SchemeType.CKKS and not _scales_close(a.scale, b.scale):
            raise ValueError("scale mismatch")
        f0, da, db = a.correction_factor, a.data, b.data
        if scheme == SchemeType.BGV and a.correction_factor != b.correction_factor:
            f0, e1, e2 = self._balance_correction_factors(
                a.correction_factor, b.correction_factor, cd.parms.plain_modulus.value)
            da = da if e1 == 1 else self._scale_by(da, e1, cd)
            db = db if e2 == 1 else self._scale_by(db, e2, cd)
        mc = cd.mod_consts
        k = min(a.size, b.size)
        op = modring.sub_poly if sub else modring.add_poly
        parts = [op(da[..., :k, :, :], db[..., :k, :, :], mc)]
        if a.size > k:
            parts.append(da[..., k:, :, :])
        elif b.size > k:
            rest = db[..., k:, :, :]
            parts.append(modring.negate_poly(rest, mc) if sub else rest)
        out = a.copy()
        out.data = torch.cat(parts, dim=-3) if len(parts) > 1 else parts[0]
        out.correction_factor = f0
        return out

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, sub=False)

    def add_many(self, cts) -> Ciphertext:
        """The sum of the ciphertexts, folded left to right as SEAL's
        evaluator.h add_many (sizes may differ)."""
        cts = list(cts)
        if not cts:
            raise ValueError("cts cannot be empty")
        out = cts[0]
        for ct in cts[1:]:
            out = self.add(out, ct)
        return out

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, sub=True)

    # -- multiplication ----------------------------------------------------------

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """CKKS: the NTT-domain dyadic convolution (evaluator.cpp:569-708).
        BGV: the same between forward and inverse NTTs, with the correction
        factors multiplied (:710-794). BFV: BEHZ (:395-567)."""
        self._check_same(a, b)
        scheme = self._scheme()
        cd = self._cd(a)
        if scheme == SchemeType.CKKS:
            if not (a.is_ntt_form and b.is_ntt_form):
                raise ValueError("CKKS multiply inputs must be in NTT form")
            res = a.copy()
            res.data = _convolve(a.data, b.data, cd.mod_consts)
            res.scale = a.scale * b.scale
            _check_scale(res.scale, cd)
            return res
        if a.is_ntt_form or b.is_ntt_form:
            raise ValueError(f"{scheme.name} multiply inputs cannot be in NTT form")
        if scheme == SchemeType.BFV:
            return self._bfv_product(a, b)
        return self._bgv_product(a, b)

    def square(self, a: Ciphertext) -> Ciphertext:
        """multiply(a, a) with three dyadic products instead of four for a
        size-2 input, and BFV's base extension of one input instead of two
        (evaluator.cpp:831-1103); the same bits as multiply(a, a)."""
        if a.size != 2:
            return self.multiply(a, a)
        scheme = self._scheme()
        cd = self._cd(a)
        if scheme == SchemeType.CKKS:
            if not a.is_ntt_form:
                raise ValueError("CKKS square input must be in NTT form")
            res = a.copy()
            res.data = _square_dyadic(a.data, cd.mod_consts)
            res.scale = a.scale * a.scale
            _check_scale(res.scale, cd)
            return res
        if a.is_ntt_form:
            raise ValueError(f"{scheme.name} square input cannot be in NTT form")
        if scheme == SchemeType.BFV:
            return self._bfv_product(a, None)
        return self._bgv_product(a, None)

    def _bgv_product(self, a: Ciphertext, b) -> Ciphertext:
        """a·b (a² where b is None) between forward and inverse NTTs, the
        correction factors multiplied."""
        cd = self._cd(a)
        tables = cd.ntt_tables
        fa, fb = _split(ntt_mod.ntt_forward(_joined(a, b), tables), a.size)
        res = a.copy()
        res.data = ntt_mod.ntt_inverse(_dyadic(fa, fb, cd.mod_consts), tables)
        factor_b = a.correction_factor if b is None else b.correction_factor
        res.correction_factor = a.correction_factor * factor_b % cd.parms.plain_modulus.value
        return res

    def _bfv_product(self, a: Ciphertext, b) -> Ciphertext:
        """BEHZ, a·b (a² where b is None): the inputs, together, extended
        from q to q ∪ Bsk (steps 1-3: fastbconv_m_tilde, sm_mrq, forward
        NTTs in both bases), the dyadic product in each base (step 4), then
        t·c floored by Q in Bsk and brought back to q (steps 5-8: inverse
        NTTs, fast_floor, fastbconv_sk)."""
        cd = self._cd(a)
        rt = cd.rns_tool
        x = _joined(a, b)
        bsk = rns.sm_mrq(rns.fastbconv_m_tilde(x, rt), rt)
        aq, bq = _split(ntt_mod.ntt_forward(x, cd.ntt_tables), a.size)
        ab, bb = _split(ntt_mod.ntt_forward(bsk, rt.bsk_ntt), a.size)
        mc = cd.mod_consts
        out_q, out_b = _dyadic(aq, bq, mc), _dyadic(ab, bb, rt.bsk_mc)
        cq = modarith.mul_mod_shoup(ntt_mod.ntt_inverse(out_q, cd.ntt_tables),
                                    *cd.plain_consts["t_mod_q"], mc.q)
        cb = modarith.mul_mod_shoup(ntt_mod.ntt_inverse(out_b, rt.bsk_ntt),
                                    *rt.t_mod_bsk, rt.bsk_mc.q)
        res = a.copy()
        res.data = rns.fastbconv_sk(rns.fast_floor(torch.cat([cq, cb], dim=-2), rt), rt)
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
        """RNS-decompose `target` ([L, N], in the ciphertext's domain) and
        lift each digit into the special-prime-extended base, NTT'd: t_op
        [d, L+α, N] (evaluator.cpp:2475-2514). CKKS skips the transform of
        the rows that equal the NTT-form target; a coefficient-form target
        (BFV, BGV) sends every row through the forward NTT."""
        cd = self._cd(ct)
        key_cd, key_moduli, alpha = self._key()
        L = cd.coeff_modulus_size
        ext = self._ext(L)
        ntt_target = cd.parms.scheme == SchemeType.CKKS
        t_target = ntt_mod.ntt_inverse(target, cd.ntt_tables) if ntt_target else target
        if alpha > 1:
            per_digit = self.context.on_device(
                ("decomp", L), lambda: hyb.decomp_consts(key_moduli, alpha, L))
            digits = hyb.digit_ranges(L, alpha)
            y = hyb.decompose(t_target, digits, per_digit, ext["mc"])
            dig_of = [min(i // alpha, len(digits) - 1) for i in range(L)]
        else:
            # row J of the target reduced into every extended row I
            mc = ext["mc"]
            y = modarith.barrett_reduce_64(t_target.unsqueeze(-2), mc.q, mc.ratio1)
            dig_of = list(range(L))
        if ntt_target:
            return hyb.diag_skip_ntt(y, target, cd.ntt_tables, self._special_tables(), dig_of)
        idx = list(range(L)) + list(range(len(key_moduli) - alpha, len(key_moduli)))
        return ntt_mod.ntt_forward(y, key_cd.ntt_rows(idx))

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
        d = t_op.shape[-3]
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

    def _switch_key_tail(self, ct: Ciphertext, prod) -> Ciphertext:
        """Divide the reduced inner product [2, L+α, N] by the special
        prime(s); returns the size-2 delta in the ciphertext's domain
        (evaluator.cpp:2572-2676): rounded for CKKS and BFV, exact and
        unchanged mod t for BGV. At α = 1 (P = q_k) this is SEAL's own
        single-prime tail, bit for bit."""
        cd = self._cd(ct)
        _, key_moduli, alpha = self._key()
        scheme = cd.parms.scheme
        L = cd.coeff_modulus_size
        t_mod = cd.parms.plain_modulus.value if scheme == SchemeType.BGV else 0
        c = self.context.on_device(
            ("tail", L, t_mod), lambda: hyb.tail_consts(key_moduli, alpha, L, t_mod))
        out = hyb.mod_down(prod, c, cd.ntt_tables, self._special_tables(), cd.mod_consts,
                           ntt_out=scheme == SchemeType.CKKS)
        return Ciphertext(out, ct.parms_id, ct.is_ntt_form, ct.scale, ct.correction_factor)

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
        head = modring.add_poly(cur.polys(0, 2), delta.data, mc)
        out = cur.copy()
        out.data = torch.cat([head, cur.polys(2, size - 1)], dim=-3)
        return out

    def relinearize_rescale(self, ct: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        """Fused CKKS relinearize + rescale_to_next: the body is lifted into
        the key-switch dividend as P·(c0, c1) + ⟨decomp(c2), ksk⟩ and ONE
        centered division by P·q_last replaces the two sequential
        mod-downs. Like seal_tpu's, it is not bit-exact to the sequential
        pair (one rounding instead of two) but decrypts to the same values
        within noise; it is bit-exact to seal_tpu.relinearize_rescale."""
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported operation for scheme type")
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
        lift = modarith.mul_mod_shoup(cur.polys(0, 2), *c["lift"], mc.q)
        rows = torch.cat([modarith.add_mod(prod[..., :L, :], lift, mc.q), prod[..., L:, :]],
                         dim=-2)
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
        """CKKS: drop the last RNS row, no scaling (mod_switch_drop_to_next).
        BFV: rounded division by the last prime. BGV: exact division that
        keeps the value mod t, the correction factor times q_last^{-1}
        (evaluator.cpp:1161-1340)."""
        cd = self._cd(ct)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        scheme = cd.parms.scheme
        factor = ct.correction_factor
        if scheme == SchemeType.CKKS:
            data = ct.data[..., :-1, :]
        elif scheme == SchemeType.BFV:
            L = cd.coeff_modulus_size
            data = rns.divide_and_round_q_last(ct.data, cd.rescale_consts, next_cd.mod_consts,
                                               cd.mod_consts.rows(slice(L - 1, L)))
        else:
            data = rns.mod_t_and_divide_q_last(ct.data, cd.rns_tool, cd.rescale_consts)
            factor = factor * cd.rns_tool_host.inv_q_last_mod_t % cd.parms.plain_modulus.value
        return Ciphertext(data, tuple(next_cd.parms_id), ct.is_ntt_form, ct.scale, factor)

    def _check_switch_target(self, cur_parms_id, parms_id) -> tuple:
        """parms_id as a tuple, once it names a level at or below the
        current one (evaluator.cpp mod_switch_to_inplace)."""
        target = tuple(parms_id)
        cur_cd, tgt_cd = self.context.get_context_data(cur_parms_id), \
            self.context.get_context_data(target)
        if cur_cd is None or tgt_cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        if cur_cd.chain_index < tgt_cd.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        return target

    def mod_switch_to(self, ct: Ciphertext, parms_id) -> Ciphertext:
        """mod_switch_to_next until the ciphertext is at parms_id's level."""
        target = self._check_switch_target(ct.parms_id, parms_id)
        while tuple(ct.parms_id) != target:
            ct = self.mod_switch_to_next(ct)
        return ct

    def mod_switch_plain_to_next(self, plain: Plaintext) -> Plaintext:
        """An NTT-form plaintext at the next level: its last RNS row dropped,
        no scaling (evaluator.cpp mod_switch_to_next of a Plaintext)."""
        if not plain.is_ntt_form or plain.data is None:
            raise ValueError("plain is not in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        if cd.next_context_data is None:
            raise ValueError("end of modulus switching chain reached")
        return Plaintext(plain.data[..., :-1, :], tuple(cd.next_context_data.parms_id),
                         plain.scale)

    def mod_switch_plain_to(self, plain: Plaintext, parms_id) -> Plaintext:
        target = self._check_switch_target(plain.parms_id, parms_id)
        while tuple(plain.parms_id) != target:
            plain = self.mod_switch_plain_to_next(plain)
        return plain

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        """CKKS rescaling by the last prime (evaluator.cpp:1441-1479)."""
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported operation for scheme type")
        cd = self._cd(ct)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        L = cd.coeff_modulus_size
        data = rns.divide_and_round_q_last_ntt(
            ct.data, cd.rescale_consts, next_cd.ntt_tables, cd.ntt_rows(slice(L - 1, L)))
        return Ciphertext(data, tuple(next_cd.parms_id), ct.is_ntt_form,
                          ct.scale / cd.key_moduli()[-1], ct.correction_factor)

    def rescale_to(self, ct: Ciphertext, parms_id) -> Ciphertext:
        """rescale_to_next until the ciphertext is at parms_id's level."""
        target = self._check_switch_target(ct.parms_id, parms_id)
        while tuple(ct.parms_id) != target:
            ct = self.rescale_to_next(ct)
        return ct

    # -- plaintext operations ----------------------------------------------------

    def add_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._add_sub_plain(ct, plain, sub=False)

    def sub_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._add_sub_plain(ct, plain, sub=True)

    def _add_sub_plain(self, ct: Ciphertext, plain: Plaintext, sub: bool) -> Ciphertext:
        """c0 ± the plaintext: CKKS adds its NTT-form rows at the same level
        and scale, BFV its Δ-scaled embedding, BGV the coefficients times
        the correction factor (evaluator.cpp:1692-1790)."""
        cd = self._cd(ct)
        _check_plain_batch(ct, plain)
        if cd.parms.scheme == SchemeType.CKKS:
            if not plain.is_ntt_form or plain.data is None:
                raise ValueError("plain must be in NTT form")
            if tuple(plain.parms_id) != tuple(ct.parms_id):
                raise ValueError("encrypted_ntt and plain_ntt parameter mismatch")
            if not _scales_close(ct.scale, plain.scale):
                raise ValueError("scale mismatch")
            rows = plain.data
        else:
            m = plain_coeffs(plain, cd)
            if cd.parms.scheme == SchemeType.BFV:
                rows = scaled_plain_rows(m, cd)
            else:
                if ct.correction_factor != 1:
                    t_mc = cd.plain_consts["t_mc"]
                    t = cd.parms.plain_modulus.value
                    m = modarith.mul_mod_shoup(
                        m, *shoup_pair([ct.correction_factor % t], [t], m.device), t_mc.q[0])
                rows = lifted_plain_rows(m, cd)
        op = modring.sub_poly if sub else modring.add_poly
        out = ct.copy()
        out.data = torch.cat([op(ct.polys(0, 1), rows.unsqueeze(-3), cd.mod_consts),
                              ct.polys(1)], dim=-3)
        return out

    def multiply_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        """Each polynomial times the plaintext. Both in NTT form (CKKS, or
        BFV/BGV after transform_to_ntt): a dyadic product at the plaintext's
        level, the scales multiplied. Both in coefficient form (BFV, BGV):
        the plaintext lifted to q (its upper half of t to the negatives),
        through the NTT (multiply_plain_normal, evaluator.cpp:1858-1992)."""
        cd = self._cd(ct)
        _check_plain_batch(ct, plain)
        if ct.is_ntt_form and plain.is_ntt_form:
            if tuple(plain.parms_id) != tuple(ct.parms_id):
                raise ValueError("encrypted_ntt and plain_ntt parameter mismatch")
            out = ct.copy()
            out.data = modring.dyadic_product(ct.data, plain.data.unsqueeze(-3), cd.mod_consts)
            out.scale = ct.scale * plain.scale
            _check_scale(out.scale, cd)
            return out
        if ct.is_ntt_form or plain.is_ntt_form:
            raise ValueError("NTT form mismatch")
        m = plain_coeffs(plain, cd)
        if not bool(m.any(-1).all()):
            raise ValueError("plain cannot be zero")
        tables = cd.ntt_tables
        plain_ntt = ntt_mod.ntt_forward(plain_to_rns_rows(m, cd), tables)
        out = ct.copy()
        out.data = ntt_mod.ntt_inverse(modring.dyadic_product(
            ntt_mod.ntt_forward(ct.data, tables), plain_ntt.unsqueeze(-3), cd.mod_consts),
            tables)
        return out

    # -- NTT transforms -----------------------------------------------------------

    def transform_to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt_form:
            raise ValueError("encrypted is already in NTT form")
        out = ct.copy()
        out.data = ntt_mod.ntt_forward(ct.data, self._cd(ct).ntt_tables)
        out.is_ntt_form = True
        return out

    def transform_from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt_form:
            raise ValueError("encrypted is not in NTT form")
        out = ct.copy()
        out.data = ntt_mod.ntt_inverse(ct.data, self._cd(ct).ntt_tables)
        out.is_ntt_form = False
        return out

    def transform_plain_to_ntt(self, plain: Plaintext, parms_id) -> Plaintext:
        """A BFV/BGV coefficient-form plaintext lifted to the level of
        parms_id (its upper half of t to the negatives) and transformed."""
        if plain.is_ntt_form:
            raise ValueError("plain is already in NTT form")
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for the current context")
        rows = plain_to_rns_rows(plain_coeffs(plain, cd), cd)
        return Plaintext(ntt_mod.ntt_forward(rows, cd.ntt_tables), tuple(parms_id),
                         plain.scale)

    # -- Galois automorphisms and rotations ------------------------------------------

    def apply_galois(self, ct: Ciphertext, galois_elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        """x -> x^elt on both polynomials, then a key switch of c1 back to
        the secret key (evaluator.cpp:2221-2323)."""
        cd = self._cd(ct)
        gt = cd.galois_tool
        if not galois_keys.has_key(galois_elt):
            raise ValueError("Galois key not present")
        _check_rotatable(ct, cd.parms.scheme)
        if ct.is_ntt_form:
            c0 = gt.apply_galois_ntt(ct.poly(0), galois_elt)
            c1 = gt.apply_galois_ntt(ct.poly(1), galois_elt)
        else:
            c0, c1 = gt.apply_galois(ct.data, galois_elt, cd.mod_consts).unbind(-3)
        delta = self._switch_key_tail(ct, self._switch_key_prod(
            ct, c1, galois_keys.key(galois_elt),
            self._key_quot(galois_keys, galois_keys.get_index(galois_elt))))
        out = ct.copy()
        out.data = torch.stack([modring.add_poly(c0, delta.poly(0), cd.mod_consts),
                                delta.poly(1)], dim=-3)
        self._check_transparent(out)
        return out

    def rotate_vector(self, ct: Ciphertext, steps: int,
                      galois_keys: GaloisKeys) -> Ciphertext:
        """CKKS slot rotation by `steps` (left for positive steps)."""
        self._require(SchemeType.CKKS)
        return self._rotate_internal(ct, steps, galois_keys)

    def complex_conjugate(self, ct: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        self._require(SchemeType.CKKS)
        return self._conjugate(ct, galois_keys)

    def rotate_rows(self, ct: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        """BFV/BGV: rotate both rows of the 2 x n/2 slot matrix by `steps`
        (left for positive steps)."""
        self._require(SchemeType.BFV, SchemeType.BGV)
        return self._rotate_internal(ct, steps, galois_keys)

    def rotate_columns(self, ct: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        """BFV/BGV: swap the two rows of the slot matrix."""
        self._require(SchemeType.BFV, SchemeType.BGV)
        return self._conjugate(ct, galois_keys)

    def _require(self, *schemes):
        if self._scheme() not in schemes:
            raise ValueError("unsupported scheme")

    def _conjugate(self, ct: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
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
        each rotation is a key inner product on that shared operand. Steps
        are CKKS slot steps, or BFV/BGV row steps (0 swaps nothing and
        returns the input). Decrypts to the same values as rotate_vector /
        rotate_rows; the bits differ from those only in the special-prime
        rounding, and are seal_tpu's on both of its branches:
        * up to 16 nonzero steps: per step the operand is contracted with the
          key permuted by the inverse NTT-domain automorphism, and the output
          is permuted: in the NTT domain (CKKS) or, after the tail brought it
          to coefficient form, by the coefficient automorphism (BFV, BGV)
          (seal_tpu's _hoisted_one);
        * more: per step the operand is permuted and contracted with the key
          as it is, and c0 is permuted in its own domain (seal_tpu's
          lax.scan body, here a loop)."""
        cd = self._cd(ct)
        _check_rotatable(ct, cd.parms.scheme)
        gt = cd.galois_tool
        mc = cd.mod_consts
        elts = [gt.get_elt_from_step(s) for s in steps]
        for s, e in zip(steps, elts):
            if s != 0 and not galois_keys.has_key(e):
                raise ValueError(f"Galois key for step {s} not present")
        c0 = ct.poly(0)

        def permuted(x, elt):
            if ct.is_ntt_form:
                return gt.apply_galois_ntt(x, elt)
            return gt.apply_galois(x, elt, mc)

        live = [(s, e) for s, e in zip(steps, elts) if s != 0]
        prods = self._hoisted_prods(ct, [e for _, e in live], galois_keys)
        by_step = {}
        for (s, elt), prod in zip(live, prods):
            delta = self._switch_key_tail(ct, prod)
            if len(live) <= 16:
                data = permuted(torch.stack(
                    [modring.add_poly(c0, delta.poly(0), mc), delta.poly(1)], dim=-3), elt)
            else:
                data = torch.stack([modring.add_poly(permuted(c0, elt), delta.poly(0), mc),
                                    delta.poly(1)], dim=-3)
            out = ct.copy()
            out.data = data
            by_step[s] = out
        return [by_step[s] if s != 0 else ct.copy() for s in steps]

    def _hoisted_prods(self, ct: Ciphertext, elts: list[int], galois_keys: GaloisKeys):
        """rotate_batch_hoisted's reduced inner products [*batch, 2, L+α, N],
        one per Galois element of `elts`, from one decomposition of c1: up to
        16 against the permuted keys, more with the decomposition permuted
        instead. Yields them one at a time, so one product is live at once
        (keyswitch.TPEvaluator returns them all from one all_reduce)."""
        gt = self._cd(ct).galois_tool
        t_op = self._switch_key_decompose(ct, ct.poly(1))
        for elt in elts:
            if len(elts) <= 16:
                yield self._switch_key_reduce(ct, t_op,
                                              self._permuted_keys(galois_keys, elt, gt),
                                              self._permuted_key_quot(galois_keys, elt, gt))
            else:
                yield self._switch_key_reduce(
                    ct, t_op.index_select(-1, gt.ntt_index(elt)), galois_keys.key(elt),
                    self._key_quot(galois_keys, galois_keys.get_index(elt)))

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

    # -- products of many ----------------------------------------------------------

    def multiply_many(self, cts, relin_keys: RelinKeys) -> Ciphertext:
        """The product of the ciphertexts by a binary tree of multiply +
        relinearize, pairs taken left to right and an odd last one carried
        up (evaluator.cpp multiply_many, seal_tpu's tree)."""
        layer = list(cts)
        if not layer:
            raise ValueError("encrypteds cannot be empty")
        while len(layer) > 1:
            nxt = [self.relinearize(self.multiply(layer[i], layer[i + 1]), relin_keys)
                   for i in range(0, len(layer) - 1, 2)]
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    def exponentiate(self, ct: Ciphertext, power: int, relin_keys: RelinKeys) -> Ciphertext:
        """ct^power as multiply_many of `power` copies."""
        if power < 1:
            raise ValueError("exponent cannot be 0")
        if power == 1:
            return ct.copy()
        return self.multiply_many([ct] * power, relin_keys)


# The `*_inplace` twin of every op that SEAL's evaluator.h declares in place
# (seal_tpu evaluator.py :1359-1397): the op runs as it is, and its result is
# rebound onto the first argument, which keeps its identity.
_INPLACE_METHODS = (
    "negate", "add", "sub", "multiply", "square", "relinearize",
    "mod_switch_to_next", "mod_switch_to", "rescale_to_next", "rescale_to",
    "add_plain", "sub_plain", "multiply_plain",
    "transform_to_ntt", "transform_from_ntt",
    "apply_galois", "rotate_rows", "rotate_columns", "rotate_vector",
    "complex_conjugate", "exponentiate",
)


def _make_inplace(name: str):
    def method(self, ct, *args, **kwargs):
        out = getattr(self, name)(ct, *args, **kwargs)
        if out is not ct:
            # an op that returns its argument (mod_switch_to at the current
            # level) leaves it as it is
            ct.__dict__.clear()
            ct.__dict__.update(out.__dict__)
        return ct

    method.__name__ = name + "_inplace"
    method.__qualname__ = f"Evaluator.{name}_inplace"
    method.__doc__ = f"`{name}` with the result rebound onto its first argument."
    return method


for _name in _INPLACE_METHODS:
    setattr(Evaluator, _name + "_inplace", _make_inplace(_name))
del _name


def _capturing(data: torch.Tensor) -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return data.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _check_plain_batch(ct: Ciphertext, plain: Plaintext):
    """A plaintext operand is one plaintext or a batch of ct's shape."""
    if plain.data is None:
        return
    batch = tuple(plain.data.shape[:-2] if plain.is_ntt_form else plain.data.shape[:-1])
    if batch and batch != ct.batch_shape:
        raise ValueError(f"plain batch {batch} does not match the ciphertexts' "
                         f"{ct.batch_shape}")


def _check_rotatable(ct: Ciphertext, scheme: SchemeType):
    if ct.size != 2:
        raise ValueError("encrypted size must be 2")
    if scheme == SchemeType.CKKS and not ct.is_ntt_form:
        raise ValueError("CKKS encrypted must be in NTT form")
    if scheme != SchemeType.CKKS and ct.is_ntt_form:
        raise ValueError(f"{scheme.name} encrypted cannot be in NTT form")


def _convolve(xs, ys, mc):
    """out[k] = Σ_{i+j=k} xs[i]·ys[j]: the dyadic product of two NTT-form
    ciphertexts [..., sa, L, N] and [..., sb, L, N] -> [..., sa + sb - 1, L, N]."""
    sa, sb = xs.shape[-3], ys.shape[-3]
    out = [None] * (sa + sb - 1)
    for i in range(sa):
        for j in range(sb):
            p = modring.dyadic_product(xs[..., i, :, :], ys[..., j, :, :], mc)
            out[i + j] = p if out[i + j] is None else modring.add_poly(out[i + j], p, mc)
    return torch.stack(out, dim=-3)


def _square_dyadic(xs, mc):
    """(x0, x1) NTT-form -> (x0², 2·x0·x1, x1²), the same bits as
    _convolve(xs, xs) with one product fewer."""
    x0, x1 = xs.unbind(-3)
    x01 = modring.dyadic_product(x0, x1, mc)
    return torch.stack([modring.dyadic_product(x0, x0, mc),
                        modring.add_poly(x01, x01, mc),
                        modring.dyadic_product(x1, x1, mc)], dim=-3)


def _joined(a: Ciphertext, b):
    """The polynomials of a and b (a alone where b is None), stacked."""
    return a.data if b is None else torch.cat([a.data, b.data], dim=-3)


def _split(x, size_a: int):
    """_joined's inverse: (a's part, b's part or None)."""
    return (x[..., :size_a, :, :],
            x[..., size_a:, :, :] if x.shape[-3] > size_a else None)


def _dyadic(xs, ys, mc):
    """xs·ys, or xs² where ys is None."""
    return _square_dyadic(xs, mc) if ys is None else _convolve(xs, ys, mc)


def _scales_close(a: float, b: float) -> bool:
    return abs(a - b) <= max(abs(a), abs(b)) * 1e-10


def _check_scale(scale: float, cd: ContextData):
    """Scale must stay positive and below the total coeff modulus
    (evaluator.cpp is_scale_within_bounds)."""
    if not scale > 0 or int(scale).bit_length() >= cd.total_coeff_modulus_bit_count:
        raise ValueError("scale out of bounds")
