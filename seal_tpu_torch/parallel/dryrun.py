"""The sharded paths of seal_tpu_torch.parallel on a group of ranks, each
held bit for bit against the unsharded port: the counterpart of
__graft_entry__.py's dryrun_multichip and its legs (_production_shape_leg,
_headline_shape_census, _pp_leg).

    python -m seal_tpu_torch.parallel.dryrun              # NCCL, one rank per card
    python -m seal_tpu_torch.parallel.dryrun --world 2 --backend gloo --device cpu --n 1024

On a (dp, tp) grid of ranks (sharding.HEMesh), in each CKKS mode of a spec
(α = 1 and α = 2 at bench.py's parameters by default) and with
config.keyswitch_shoup off (K2) and on (K3), every rank runs, against the
unsharded Evaluator on its own device:

* relinearize: multiply -> TPEvaluator.relinearize -> rescale_to_next;
* relinearize_rescale: multiply -> the fused TPEvaluator.relinearize_rescale;
* hoisted: TPEvaluator.rotate_batch_hoisted over the spec's steps;
* dp_tp: the spec's batch through vmap_pipeline(multiply -> relinearize ->
  rescale, the fused tail at α = 2) over dp, key switches split over tp;
* tower: a coefficient-form ciphertext split into tower shards over tp,
  K1 on the local rows (transform_to_ntt_rows), the rows gathered back;

and once, where the group has two ranks or more:

* sp: the four-step NTT of [rows, n] over every rank (fourstep.py), both
  routes, forward and inverse, against K1 on the whole tower;
* pp: a pipeline of `world` real Evaluator stages (multiply + relinearize,
  then rescales) over the spec's microbatches, pipeline_apply and
  pipeline_apply_sharded, against the sequential composition.

Each op's record holds its bit-exactness, the census of its collectives
(comm.Census), the kernel launches it made on this rank (cuda.launches,
zeroed just before and read just after) and, for the key switches, the
port's census model: ONE all_reduce of 2·(L+α)·N·8 bytes per key switch
(int64 partials, no limb split), k times that for a hoisted batch of k,
against seal_tpu's psum of three 21-bit limbs in u32 lanes, 2·3·(L+α)·N·4
bytes (_headline_shape_census). The records come back to the caller, which
prints them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from seal_tpu_torch import cuda
from seal_tpu_torch.config import config
from seal_tpu_torch.parallel import fourstep, launch, pipeline
from seal_tpu_torch.parallel.keyswitch import TPEvaluator
from seal_tpu_torch.parallel.sharding import (
    HEMesh, batch_ciphertexts, gather_tower, shard_ciphertext, transform_to_ntt_rows,
    vmap_pipeline)

# bench.py's two modes at n = 16384 with 8 data primes (chip_smoke.py's MODES)
MODES = {
    "alpha2_fused": dict(bits=[44] * 8 + [43] * 2, alpha=2, fused=True),
    "alpha1_parity": dict(bits=[48] * 8 + [54], alpha=1, fused=False),
}
FULL = dict(n=16384, modes=MODES, sec_level="tc128", seed=20261016, scale=2.0 ** 40,
            batch=16, steps=list(range(1, 9)), sp_rows=8, microbatches=2, reps=5)


def port_model_bytes(L: int, alpha: int, n: int) -> int:
    """Bytes of the one all_reduce of a split key switch: int64 [2, L+α, N]."""
    return 2 * (L + alpha) * n * 8


def seal_tpu_model_bytes(L: int, alpha: int, n: int) -> int:
    """seal_tpu's psum per key switch: three 21-bit limbs of [2, L+α, N] in
    u32 lanes (__graft_entry__.py _headline_shape_census)."""
    return 2 * 3 * (L + alpha) * n * 4


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted(hm, device, fn):
    """fn()'s result, with the census and kernel launches of that call alone."""
    _sync(device)
    hm.census.reset()
    cuda.reset_launches()
    out = fn()
    _sync(device)
    return out, hm.census.snapshot(), dict(cuda.launches)


def _host_ms(device, fn, reps):
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _same(a, b) -> bool:
    return (tuple(a.parms_id) == tuple(b.parms_id) and a.scale == b.scale
            and torch.equal(a.data, b.data))


def _context(spec, cfg, device):
    import seal_tpu_torch as st

    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(cfg["n"])
    parms.set_coeff_modulus(st.CoeffModulus.create(cfg["n"], spec["bits"]))
    parms.set_special_modulus_size(spec["alpha"])
    parms.set_random_seed((cfg["seed"],) + (0,) * 7)
    level = st.SecLevelType.NONE if cfg["sec_level"] == "none" else st.SecLevelType.TC128
    return st.SEALContext(parms, sec_level=level, device=device)


def _mode_legs(hm: HEMesh, spec: dict, cfg: dict, records: dict, mode: str):
    import seal_tpu_torch as st

    dev = hm.device
    ctx = _context(spec, cfg, dev)
    n, alpha = cfg["n"], spec["alpha"]
    kg = st.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    gt = ctx.key_context_data().galois_tool
    gk = kg.create_galois_keys(gt.get_elts_from_steps(cfg["steps"]))
    enc = st.Encryptor(ctx, kg.create_public_key())
    encoder = st.CKKSEncoder(ctx)
    rng = np.random.default_rng(cfg["seed"])
    slots = n // 2
    ct1, ct2 = (enc.encrypt(encoder.encode(rng.uniform(-1, 1, slots), cfg["scale"]))
                for _ in range(2))
    B = cfg["batch"]
    batch1, batch2 = (batch_ciphertexts(enc.encrypt_many(encoder.encode_many(
        rng.uniform(-1, 1, (B, slots)), cfg["scale"]))) for _ in range(2))
    ev = st.Evaluator(ctx)
    tev = TPEvaluator(ctx, hm)
    L = ctx.first_context_data().coeff_modulus_size
    # two 32-bit words per residue where tp·max q passes 2^63 (TPKeySwitch.split)
    model = port_model_bytes(L, alpha, n) * (2 if tev._tks_for(ct1.parms_id).split else 1)

    def relin(e, a, b):
        return e.rescale_to_next(e.relinearize(e.multiply(a, b), rk))

    def fused(e, a, b):
        return e.relinearize_rescale(e.multiply(a, b), rk)

    def record(name, got, want, census, launches, **extra):
        same = (all(_same(g, w) for g, w in zip(got, want)) if isinstance(got, list)
                else _same(got, want))
        records[f"{mode}/{name}"] = dict(bit_exact=same, census=census, launches=launches,
                                         **extra)

    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        try:
            tag = "shoup" if shoup else "k2"
            m = ev.multiply(ct1, ct2)
            got, census, launches = _counted(hm, dev, lambda: tev.relinearize(m, rk))
            record(f"relinearize/{tag}", ev.rescale_to_next(got), relin(ev, ct1, ct2),
                   census, launches, model_bytes=model,
                   seal_tpu_model_bytes=seal_tpu_model_bytes(L, alpha, n),
                   ms=_host_ms(dev, lambda: tev.relinearize(m, rk), cfg["reps"]),
                   ms_unsharded=_host_ms(dev, lambda: ev.relinearize(m, rk), cfg["reps"]))
            got, census, launches = _counted(hm, dev, lambda: tev.relinearize_rescale(m, rk))
            record(f"relinearize_rescale/{tag}", got, fused(ev, ct1, ct2), census, launches,
                   model_bytes=model)
            steps = cfg["steps"]
            got, census, launches = _counted(
                hm, dev, lambda: tev.rotate_batch_hoisted(ct1, steps, gk))
            record(f"hoisted/{tag}", got, ev.rotate_batch_hoisted(ct1, steps, gk), census,
                   launches, model_bytes=len([s for s in steps if s]) * model)
            run = fused if spec["fused"] else relin
            got, census, launches = _counted(
                hm, dev, lambda: vmap_pipeline(lambda a, b: run(tev, a, b), hm)(batch1, batch2))
            record(f"dp_tp/{tag}", got, run(ev, batch1, batch2), census, launches,
                   batch=B, model_bytes=B // hm.dp * model)
        finally:
            config.keyswitch_shoup = False

    coeff = ev.transform_from_ntt(ct1)
    got, census, launches = _counted(hm, dev, lambda: gather_tower(transform_to_ntt_rows(
        ctx, shard_ciphertext(coeff, hm), hm), hm))
    record("tower", got, ev.transform_to_ntt(coeff), census, launches, rows=L // hm.tp)
    if hm.dp * hm.tp > 1:
        _pp_leg(hm, ctx, ev, rk, (batch1, batch2), cfg, records, mode)


def _pp_leg(hm, ctx, ev, rk, batches, cfg, records, mode):
    """world real Evaluator stages on payloads [4, L, n] (rows a0, a1, b0,
    b1 of two members of the batches): multiply + relinearize, then one
    rescale per further stage, each output padded back to [4, L, n] with
    zero rows; the spec's microbatches through pipeline_apply and
    pipeline_apply_sharded against the sequential composition."""
    comm = hm.world_comm
    P, M = comm.size, cfg["microbatches"]
    cd = ctx.first_context_data()
    L, n = cd.coeff_modulus_size, cfg["n"]
    if P > L:
        raise ValueError(f"{P} stages need {P} data primes, the tower has {L}")
    # levels[s]: the level stage s + 1 rescales from; scales[s]: its scale
    levels, scales = [cd], [batches[0].scale * batches[1].scale]
    for _ in range(P - 2):
        scales.append(scales[-1] / levels[-1].key_moduli()[-1])
        levels.append(levels[-1].next_context_data)
    proto = batches[0].unbind()[0]

    def pad(data):
        out = torch.zeros((4, L, n), dtype=torch.int64, device=data.device)
        out[:2, :data.shape[-2]] = data
        return out

    def mult_relin(x):
        a, b = proto.copy(), proto.copy()
        a.data, b.data = x[:2], x[2:]
        return pad(ev.relinearize(ev.multiply(a, b), rk).data)

    def rescale(s):
        def stage(x):
            Ls = levels[s].coeff_modulus_size
            c = type(proto)(x[:2, :Ls], tuple(levels[s].parms_id), True, scales[s])
            return pad(ev.rescale_to_next(c).data)
        return stage

    stages = [mult_relin] + [rescale(s) for s in range(P - 1)]
    xs = torch.cat([batches[0].data[:M], batches[1].data[:M]], dim=1)     # [M, 4, L, n]
    want = torch.stack(pipeline.interleave_microbatches(stages, list(xs.unbind(0))))
    got, census, launches = _counted(hm, hm.device,
                                     lambda: pipeline.pipeline_apply(stages, xs, comm))
    records[f"{mode}/pp"] = dict(bit_exact=bool(torch.equal(got, want)), census=census,
                                 launches=launches, stages=P, microbatches=M)
    got, census, launches = _counted(hm, hm.device, lambda: pipeline.pipeline_apply_sharded(
        stages, pipeline.cyclic_feed(xs, comm), comm))
    records[f"{mode}/pp_sharded"] = dict(
        bit_exact=bool(torch.equal(pipeline.gather_cyclic(got, comm), want)), census=census,
        launches=launches, stages=P, microbatches=M)


def _sp_leg(hm: HEMesh, cfg: dict, records: dict):
    """The four-step NTT of [sp_rows, n] over every rank, both routes."""
    from seal_tpu_torch.ops import ntt as ntt_mod
    from seal_tpu_torch.utils import numth

    comm = hm.world_comm
    n, P = cfg["n"], comm.size
    log_n = n.bit_length() - 1
    moduli = numth.get_primes(2 * n, 50, cfg["sp_rows"])
    rng = np.random.default_rng(cfg["seed"] + 2)
    x = torch.from_numpy(np.stack([rng.integers(0, q, n, dtype=np.int64) for q in moduli]))
    x = x.to(hm.device)
    ntt_tables = ntt_mod.make_ntt_tables(log_n, moduli, hm.device)
    want = ntt_mod.ntt_forward(x, ntt_tables)
    t4 = fourstep.build_fourstep_tables(log_n, moduli, P, hm.device)
    M = n // P
    block = slice(comm.rank * M, (comm.rank + 1) * M)
    for route in ("gather", "a2a"):
        fwd, census, launches = _counted(
            hm, hm.device, lambda: fourstep.ntt_forward_sharded(x[:, block], t4, comm, route))
        back, census_inv, _ = _counted(
            hm, hm.device, lambda: fourstep.ntt_inverse_sharded(fwd, t4, comm, route))
        records[f"sp/{route}"] = dict(
            bit_exact=bool(torch.equal(fwd, want[:, block]) and torch.equal(back, x[:, block])),
            census=census, census_inverse=census_inv, launches=launches,
            route=fourstep.pick_route(t4, route), shape=[cfg["sp_rows"], n], shards=P)


def run_legs(rank: launch.Rank, cfg: dict, dp: int, tp: int):
    """Every leg on this rank of a (dp, tp) grid, its contexts on the rank's
    device; returns its records and where it ran."""
    hm = HEMesh(dp, tp, device=rank.device)
    records: dict = {}
    t0 = time.perf_counter()
    for mode, spec in cfg["modes"].items():
        _mode_legs(hm, spec, cfg, records, mode)
    if dp * tp > 1:
        _sp_leg(hm, cfg, records)
    return dict(rank=rank.rank, world=rank.world, backend=rank.backend,
                device=str(hm.device), dp=dp, tp=tp, records=records,
                seconds=time.perf_counter() - t0)


def dryrun_multichip(world: int, backend: str, device: str, cfg: dict = FULL,
                     dp: int = 1, timeout_s: float = 600.0) -> list[dict]:
    """run_legs on `world` ranks as a (dp, world/dp) grid; raises unless
    every record of every rank is bit-exact and every split key switch
    issued the census model's one all_reduce. Returns each rank's result."""
    results = launch.run(run_legs, world, backend, device, timeout_s,
                         args=(cfg, dp, world // dp))
    for res in results:
        check(res)
    return results


def check(res: dict):
    """Raise unless every record of a rank's result is bit-exact and every
    key switch's census is ONE all_reduce of its model's bytes."""
    for name, rec in res["records"].items():
        if not rec["bit_exact"]:
            raise RuntimeError(f"rank {res['rank']}: {name} differs from the unsharded port")
        if "model_bytes" in rec:
            ar = rec["census"].get("all_reduce", {})
            if ar.get("calls") != 1 or ar.get("bytes") != rec["model_bytes"]:
                raise RuntimeError(f"rank {res['rank']}: {name} census {rec['census']} is not "
                                   f"one all_reduce of {rec['model_bytes']} bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: one per card on cuda, 2 on the CPU)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="nccl: one rank per card (default); gloo: CPU ranks, or several "
                         "ranks on one card staged through the host")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks' contexts live (default cuda; raises without it)")
    ap.add_argument("--n", type=int, default=None, help="ring degree (default 16384)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    cfg = dict(FULL)
    if args.n:
        cfg.update(n=args.n, sec_level="none")
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 2)
    for res in dryrun_multichip(world, args.backend, args.device, cfg, args.dp,
                                args.timeout):
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
