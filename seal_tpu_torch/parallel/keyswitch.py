"""Tensor-parallel key switching: the decomposition axis split over tp ranks.

The port of seal_tpu/parallel/keyswitch.py. Everything a key switch does per
decomposition row (SEAL evaluator.cpp:2475-2547) is independent until the
final sum over rows, so with the d rows (α = 1: one per data prime; α > 1:
⌈L/α⌉ digits) split over the tp ranks of a group, each rank

* decomposes its own rows of the target and lifts them to the extended base
  (the inverse NTT of a CKKS target first),
* runs the forward NTT of those rows (K1; every row, where the unsharded
  CKKS path substitutes the diagonal rows instead of transforming them: the
  transform of a fully reduced row gives it back bit for bit, as seal_tpu's
  shard_map body does too),
* contracts them with its own rows of the key ([d_loc, 2, L+α, N], sliced
  once per key tensor and cached) with keyswitch_inner (K2), or with
  keyswitch_inner_shoup (K3) under config.keyswitch_shoup, into a partial
  [*batch, 2, L+α, N] in [0, q),

and ONE int64 all_reduce(SUM) over tp adds the partials. The sum is below
tp·q, so a chain of conditional subtractions gives Σ mod q, the reduced
product of the unsharded Evaluator bit for bit, and the unchanged
Evaluator._switch_key_tail runs on it on every rank. seal_tpu splits each
partial into three 21-bit limbs, since its psum runs on u32 lanes; int64
sums are exact while tp·max q < 2^63 (tp ≤ 7 for 60-bit primes), and past
that the partial is split into two 32-bit words (`_split32` /
`_recombine32`), which give the same bits.

The rows split as seal_tpu pads them: d_loc = ⌈d/tp⌉ rows per rank, rank t
owning rows [t·d_loc, (t+1)·d_loc) ∩ [0, d). seal_tpu pads the rows to
tp·d_loc with zero key rows, whose products are zero; the port leaves them
out, so every level of the chain splits, and a rank past the last row adds
a zero partial.

`TPEvaluator` overrides the Evaluator's one key-switch hook,
`_switch_key_prod`, so relinearize, relinearize_rescale, apply_galois, the
rotations and complex_conjugate all split this way; and `_hoisted_prods`,
so a hoisted rotation batch decomposes once per rank, makes its k local
contractions, and adds all k partials [k, *batch, 2, L+α, N] with ONE
all_reduce.
"""

from __future__ import annotations

import weakref

import torch

from seal_tpu_torch.config import config
from seal_tpu_torch.dtypes import Ciphertext, GaloisKeys, RelinKeys
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.ops import hybrid_keyswitch as hyb
from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.keyswitch import key_quotients, keyswitch_inner, keyswitch_inner_shoup
from seal_tpu_torch.ops.modring import ModConsts
from seal_tpu_torch.parallel.comm import Comm
from seal_tpu_torch.parallel.sharding import HEMesh

_MASK32 = (1 << 32) - 1


def _split32(x: torch.Tensor) -> torch.Tensor:
    """Residues below 2^61 -> [2, ...] (low 32 bits, high 29 bits)."""
    return torch.stack([x & _MASK32, x >> 32])


def _recombine32(s: torch.Tensor, mc: ModConsts) -> torch.Tensor:
    """Inverse of _split32 after a sum over ranks: (s[0] + s[1]·2^32) mod q,
    exact while each word's sum stays below 2^63."""
    lo = modarith.barrett_reduce_64(s[0], mc.q, mc.ratio1)
    hi = modarith.barrett_reduce_64(s[1], mc.q, mc.ratio1)
    two32 = modarith.barrett_reduce_64(torch.full_like(mc.q, 1 << 32), mc.q, mc.ratio1)
    return modarith.add_mod(lo, modarith.mul_mod(hi, two32, mc.q, mc.ratio0, mc.ratio1),
                            mc.q)


class TPKeySwitch:
    """The split key switch of one level of the chain, on this rank's rows
    of the decomposition (see the module's docstring).

        tks = TPKeySwitch(ev, ct.parms_id, hm.tp_comm)
        prod = tks.prod_rows(target, keys)   # == ev._switch_key_prod(ct, target, keys)
    """

    def __init__(self, ev: Evaluator, parms_id, comm: Comm):
        cd = ev.context.get_context_data(parms_id)
        key_cd, key_moduli, alpha = ev._key()
        self.cd = cd
        self.comm = comm
        self.tp = comm.size
        self.L = L = cd.coeff_modulus_size
        self.alpha = alpha
        self.ckks = cd.parms.scheme == SchemeType.CKKS
        self.decomp = L if alpha == 1 else -(-L // alpha)
        d_loc = -(-self.decomp // self.tp)
        lo = comm.rank * d_loc
        self.rows = range(min(lo, self.decomp), min(lo + d_loc, self.decomp))
        self.ext = ev._ext(L)
        L_key = len(key_moduli)
        self.ext_moduli = [key_moduli[i] for i in
                           list(range(L)) + list(range(L_key - alpha, L_key))]
        self.tables = key_cd.ntt_rows(list(range(L)) + list(range(L_key - alpha, L_key)))
        if alpha > 1 and self.rows:
            per_digit = ev.context.on_device(
                ("decomp", L), lambda: hyb.decomp_consts(key_moduli, alpha, L))
            self.digits = hyb.digit_ranges(L, alpha)[self.rows.start:self.rows.stop]
            self.per_digit = per_digit[self.rows.start:self.rows.stop]
        # Σ over ranks of values below q, in int64
        self.split = self.tp * self.ext["max_q"] >= 1 << 63
        self._shards: dict = {}

    def decompose(self, target: torch.Tensor):
        """This rank's rows of the decomposed target [*batch, L, N] lifted to
        the extended base and NTT'd: [*batch, d_rank, L+α, N] (K1), or None
        for a rank past the last row."""
        if not self.rows:
            return None
        t_target = ntt_mod.ntt_inverse(target, self.cd.ntt_tables) if self.ckks else target
        mc = self.ext["mc"]
        if self.alpha > 1:
            y = hyb.decompose(t_target, self.digits, self.per_digit, mc)
        else:
            rows = t_target[..., self.rows.start:self.rows.stop, :]
            y = modarith.barrett_reduce_64(rows.unsqueeze(-2), mc.q, mc.ratio1)
        return ntt_mod.ntt_forward(y, self.tables)

    def _shard(self, keys: torch.Tensor, perm=None):
        """(this rank's rows of `keys` on the extended base, their Shoup
        quotients when config.keyswitch_shoup asks for them), sliced once
        per key tensor (and per NTT-domain permutation `perm`, a Galois
        element) and cached, keyed on the tensor itself."""
        slot = (id(keys), perm)
        hit = self._shards.get(slot)
        if hit is None or hit[0] is not keys:
            shard = keys[self.rows.start:self.rows.stop]
            if self.ext["gather"] is not None:
                shard = shard.index_select(2, self.ext["gather"])
            if perm is not None:
                gt = self.cd.galois_tool
                shard = shard.index_select(-1, gt.ntt_inverse_index(perm))
            hit = [keys, shard.contiguous(), None]
            self._shards[slot] = hit
        if config.keyswitch_shoup and hit[2] is None:
            hit[2] = key_quotients(hit[1], self.ext_moduli)
        return hit[1], hit[2] if config.keyswitch_shoup else None

    def contract(self, t_op, keys: torch.Tensor, perm=None, lead=()) -> torch.Tensor:
        """This rank's partial [*batch, 2, L+α, N] in [0, q): K2, or K3 under
        config.keyswitch_shoup where the lazy sum fits 64 bits. `perm`
        contracts against the key permuted by the Galois element's inverse
        NTT-domain permutation (Evaluator._permuted_keys); `lead` is the
        batch shape, for a rank past the last row (t_op None)."""
        ext = self.ext
        if t_op is None:
            n = self.cd.parms.poly_modulus_degree
            return torch.zeros(tuple(lead) + (2, len(self.ext_moduli), n),
                               dtype=torch.int64, device=ext["mc"].q.device)
        shard, quot = self._shard(keys, perm)
        if quot is not None and 2 * len(self.rows) * ext["max_q"] < 1 << 64:
            return keyswitch_inner_shoup(t_op, shard, quot, ext["consts"], ext["max_q"])
        return keyswitch_inner(t_op, shard, ext["consts"])

    def reduce(self, partials: torch.Tensor) -> torch.Tensor:
        """Σ over the tp ranks of partials [..., 2, L+α, N], mod q: ONE
        all_reduce."""
        mc = self.ext["mc"]
        if self.split:
            return _recombine32(self.comm.all_reduce_sum(_split32(partials)), mc)
        s = self.comm.all_reduce_sum(partials)
        for k in range((self.tp - 1).bit_length() - 1, -1, -1):
            s = modarith.cond_sub(s, mc.q << k)
        return s

    def prod_rows(self, target: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """Evaluator._switch_key_prod, split: [*batch, 2, L+α, N] on every rank."""
        lead = tuple(target.shape[:-2])
        return self.reduce(self.contract(self.decompose(target), keys, lead=lead))


class TPEvaluator(Evaluator):
    """An Evaluator whose key switches split over the tp group of `hm`.

    Its only overrides are the key-switch hooks: `_switch_key_prod` (one
    all_reduce per key switch) and `_hoisted_prods` (one all_reduce per
    hoisted rotation batch). Every other op runs as the Evaluator's, on the
    whole tower, on every rank; outputs are the unsharded Evaluator's bit
    for bit, on every rank. The Shoup route makes each rank's quotients from
    its own key rows, so the whole-key quotients are never computed."""

    def __init__(self, context, hm: HEMesh):
        super().__init__(context)
        self.hm = hm
        self._tks: dict = {}

    def _tks_for(self, parms_id) -> TPKeySwitch:
        key = tuple(parms_id)
        if key not in self._tks:
            self._tks[key] = TPKeySwitch(self, parms_id, self.hm.tp_comm)
        return self._tks[key]

    def _key_quot(self, keys_obj, index):
        return None

    def _permuted_key_quot(self, galois_keys, elt, gt):
        return None

    def _switch_key_prod(self, ct: Ciphertext, target, keys, keys_quot=None) -> torch.Tensor:
        return self._tks_for(ct.parms_id).prod_rows(target, keys)

    def _hoisted_prods(self, ct: Ciphertext, elts: list[int], galois_keys: GaloisKeys):
        tks = self._tks_for(ct.parms_id)
        t_op = tks.decompose(ct.poly(1))
        lead = ct.batch_shape
        if len(elts) <= 16:
            parts = [tks.contract(t_op, galois_keys.key(elt), perm=elt, lead=lead)
                     for elt in elts]
        else:
            gt = self._cd(ct).galois_tool
            parts = [tks.contract(None if t_op is None
                                  else t_op.index_select(-1, gt.ntt_index(elt)),
                                  galois_keys.key(elt), lead=lead) for elt in elts]
        if not parts:
            return []
        return list(tks.reduce(torch.stack(parts)).unbind(0))


# one TPEvaluator per (mesh, context), for tp_relinearize: its key rows are
# sliced (and their Shoup quotients made) once, not on every call
_TP_EVALUATORS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tp_relinearize(ev: Evaluator, ct: Ciphertext, relin_keys: RelinKeys,
                   hm: HEMesh) -> Ciphertext:
    """Relinearize a size-3 ciphertext with the split key switch
    (evaluator.cpp:1104-1159): ev.relinearize's bits, on every rank. Runs
    TPEvaluator.relinearize on ev's context."""
    if ct.size != 3:
        raise ValueError("tp_relinearize expects a size-3 ciphertext")
    per_mesh = _TP_EVALUATORS.setdefault(hm, {})
    tev = per_mesh.get(id(ev.context))
    if tev is None or tev.context is not ev.context:
        tev = per_mesh[id(ev.context)] = TPEvaluator(ev.context, hm)
    return tev.relinearize(ct, relin_keys)
