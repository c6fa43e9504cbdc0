"""The port's threshold (multiparty) layer on the CPU, bit for bit
(tolerance 0; CKKS decodes within 1e-3 of the input).

(a) The fork's own run, tests/vectors/multiparty_bfv_n64.json, from the
    parties' random seeds alone: every one of its 54 arrays (the parties'
    secret keys, their shared-c1 public keys, the common public and secret
    keys, a ciphertext under the common key, each partial decryption, the
    parties' Galois keys for elts 3 and 127 under party 0's c1 and their
    aggregate, the threshold rotation and the aggregated plaintexts).
(b) seal_tpu's multiparty flow against the port at n = 1024: BFV, BGV (a
    mod-switched ciphertext, correction factor != 1) and CKKS, at α = 1 and
    2, with 3 and 5 parties: party keys and public keys, the common keys,
    Galois key shares and their aggregate, encryption under the common
    key, partials and their aggregate, against the direct decryption under
    the common secret key.
(c) Smudged partials and CKKS flood_bits, with both packages' unseeded
    factories patched to one seed here so that their bits can be compared,
    over smudging widths that take both of the port's draw paths.
(d) The refusals: a ciphertext of size != 2, save_seed with c1 overrides,
    flood_bits on BFV and BGV.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu.dtypes import to_device, to_host

V = json.loads((pathlib.Path(__file__).parent / "vectors" / "multiparty_bfv_n64.json")
               .read_text())
PARTIES = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def u64(t):
    return t.numpy().view(np.uint64)


def party_seed(i):
    return (10 + i, 2, 3, 4, 5, 6, 7, 8)


# -- (a) the fork's vectors -------------------------------------------------------------

@pytest.fixture(scope="module")
def fork():
    ctxs = []
    for i in range(PARTIES):
        parms = st.EncryptionParameters(st.SchemeType.BFV)
        parms.set_poly_modulus_degree(64)
        parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40]))
        parms.set_plain_modulus(257)
        parms.set_random_seed(party_seed(i))
        ctxs.append(st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu"))
    kgs = [st.KeyGenerator(c) for c in ctxs]
    sks = [kg.generate_secret_key() for kg in kgs]
    pks = [kgs[0].create_public_key_with_sk(sks[0])]
    pks += [kgs[i].create_public_key_with_same_c1(sks[i], pks[0]) for i in range(1, PARTIES)]
    cpk = kgs[0].create_common_public_key(pks)
    csk = kgs[0].create_common_secret_key(sks)
    ct = st.Encryptor(ctxs[0], cpk).encrypt(st.Plaintext.from_hex_string("2Ax^5 + 6",
                                                                         device="cpu"))
    partials = [st.Decryptor(ctxs[i], sks[i]).distributed_decrypt(ct) for i in range(PARTIES)]
    agg = st.Decryptor(ctxs[0], sks[0]).aggregate_partial_decryption(ct, partials)
    # the fork's wrappers make every party's keys over get_elts_all, with party
    # 0's key-switching c1s as the common reference string
    elts = ctxs[0].key_context_data().galois_tool.get_elts_all()
    gks = [kgs[0].create_galois_keys(elts, secret_key=sks[0])]
    refs = [gks[0].key(elt)[:, 1] for elt in elts]
    gks += [kgs[i].create_galois_keys(elts, secret_key=sks[i], c1_refs_per_elt=refs)
            for i in range(1, PARTIES)]
    common = kgs[0].aggregate_galois_keys(elts, gks)
    rot = st.Evaluator(ctxs[0]).rotate_rows(ct, 1, common)
    rot_partials = [st.Decryptor(ctxs[i], sks[i]).distributed_decrypt(rot)
                    for i in range(PARTIES)]
    rot_agg = st.Decryptor(ctxs[0], sks[0]).aggregate_partial_decryption(rot, rot_partials)
    out = {"cpk_c0": cpk.to_numpy()[0], "cpk_c1": cpk.to_numpy()[1], "csk": csk.to_numpy(),
           "ct_c0": ct.to_numpy()[0], "ct_c1": ct.to_numpy()[1],
           "aggregated_plain": agg.to_numpy(),
           "csk_plain": st.Decryptor(ctxs[0], csk).decrypt(ct).to_numpy(),
           "ct_rot_c0": rot.to_numpy()[0], "ct_rot_c1": rot.to_numpy()[1],
           "rot_aggregated_plain": rot_agg.to_numpy()}
    for i in range(PARTIES):
        out[f"sk{i}"] = sks[i].to_numpy()
        out[f"pk{i}_c0"], out[f"pk{i}_c1"] = pks[i].to_numpy()
        # the fork writes the share into the ciphertext's second polynomial
        out[f"partial{i}"] = partials[i].to_numpy()[1]
    for prefix, keys in [(f"gk{i}", gks[i]) for i in range(PARTIES)] + [("common_gk", common)]:
        for elt in (3, 127):
            k = u64(keys.key(elt))
            for j in range(k.shape[0]):
                for c in range(2):
                    out[f"{prefix}_elt{elt}_k{j}_c{c}"] = k[j, c]
    return out


def test_fork_vectors_all_covered(fork):
    assert sorted(fork) == sorted(V) and len(V) == 54


@pytest.mark.parametrize("name", sorted(V))
def test_fork_vector(fork, name):
    np.testing.assert_array_equal(fork[name].reshape(-1), np.array(V[name], dtype=np.uint64),
                                  err_msg=name)


def test_fork_aggregate_decodes(fork):
    assert st.Plaintext(torch.from_numpy(fork["aggregated_plain"].view(np.int64))) \
        .to_hex_string() == "2Ax^5 + 6"


# -- (b) seal_tpu's flow against the port at n = 1024 -------------------------------------

N = 1024
SCALE = 2.0 ** 30
BITS = {("BFV", 1): [30, 30, 30], ("BFV", 2): [30, 30, 30, 30],
        ("BGV", 1): [30, 30, 30], ("BGV", 2): [30, 30, 30, 30],
        ("CKKS", 1): [40, 30, 30, 40], ("CKKS", 2): [40, 30, 30, 40, 40]}
CASES = [(s, a, p) for s in ("BFV", "BGV", "CKKS") for a in (1, 2) for p in (3, 5)]


def contexts(lib, scheme, alpha, parties, **kw):
    out = []
    for i in range(parties):
        parms = lib.EncryptionParameters(getattr(lib.SchemeType, scheme))
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(lib.CoeffModulus.create(N, BITS[scheme, alpha]))
        if scheme != "CKKS":
            parms.set_plain_modulus(lib.PlainModulus.batching(N, 17))
        parms.set_special_modulus_size(alpha)
        parms.set_random_seed(party_seed(i))
        out.append(lib.SEALContext(parms, sec_level=lib.SecLevelType.NONE, **kw))
    return out


def run_flow(lib, scheme, alpha, parties, values, **kw):
    """Party keys -> shared-c1 public keys -> common keys -> Galois shares
    under party 0's c1 and their aggregate -> encode and encrypt under the
    common key (BGV: then one mod switch, made by the port for both) ->
    each party's partial -> the aggregate and the common key's decrypt."""
    ctxs = contexts(lib, scheme, alpha, parties, **kw)
    kgs = [lib.KeyGenerator(c) for c in ctxs]
    sks = [kg.generate_secret_key() for kg in kgs]
    pks = [kgs[0].create_public_key_with_sk(sks[0])]
    pks += [kgs[i].create_public_key_with_same_c1(sks[i], pks[0]) for i in range(1, parties)]
    cpk, csk = kgs[0].create_common_public_key(pks), kgs[0].create_common_secret_key(sks)
    gt = ctxs[0].key_context_data().galois_tool
    elts = [gt.get_elt_from_step(1)] + ([2 * N - 1] if scheme != "CKKS" else [])
    gks = [kgs[0].create_galois_keys(elts, secret_key=sks[0])]
    if lib is st:
        refs = [gks[0].key(e)[:, 1] for e in elts]
    else:
        refs = [[(k[0][j, 1], k[1][j, 1]) for j in range(k[0].shape[0])]
                for k in (gks[0].keys[(e - 1) // 2] for e in elts)]
    gks += [kgs[i].create_galois_keys(elts, secret_key=sks[i], c1_refs_per_elt=refs)
            for i in range(1, parties)]
    common = kgs[0].aggregate_galois_keys(elts, gks)
    if scheme == "CKKS":
        plain = lib.CKKSEncoder(ctxs[0]).encode(values, SCALE)
    else:
        plain = lib.BatchEncoder(ctxs[0]).encode(values)
    ct = lib.Encryptor(ctxs[0], cpk).encrypt(plain)
    return dict(ctxs=ctxs, sks=sks, pks=pks, cpk=cpk, csk=csk, elts=elts, gks=gks,
                common=common, ct=ct)


def carry_to_ref(ct, parms_id):
    return seal_tpu.Ciphertext(to_device(ct.to_numpy()), parms_id=tuple(parms_id),
                               is_ntt_form=ct.is_ntt_form, scale=ct.scale,
                               correction_factor=ct.correction_factor)


def decrypt_side(lib, flow, ct):
    parties = len(flow["sks"])
    partials = [lib.Decryptor(flow["ctxs"][i], flow["sks"][i]).distributed_decrypt(ct)
                for i in range(parties)]
    agg = lib.Decryptor(flow["ctxs"][0], flow["sks"][0]).aggregate_partial_decryption(
        ct, partials)
    direct = lib.Decryptor(flow["ctxs"][0], flow["csk"]).decrypt(ct)
    return partials, agg, direct


def plain_words(p):
    if isinstance(p, st.Plaintext):
        return p.to_numpy()
    return p.data if p.rns_data is None else to_host(p.rns_data)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-alpha{c[1]}-{c[2]}p")
def flows(request):
    scheme, alpha, parties = request.param
    rng = np.random.default_rng(alpha * 10 + parties)
    if scheme == "CKKS":
        values = rng.uniform(-1, 1, N // 2)
    else:
        t = seal_tpu.PlainModulus.batching(N, 17).value
        values = rng.integers(0, t, N, dtype=np.int64)
    mine = run_flow(st, scheme, alpha, parties, values, device="cpu")
    ref = run_flow(seal_tpu, scheme, alpha, parties, values)
    ct, ref_ct = mine["ct"], ref["ct"]
    if scheme == "BGV":
        ct = st.Evaluator(mine["ctxs"][0]).mod_switch_to_next(ct)
        assert ct.correction_factor != 1
        ref_ct = carry_to_ref(ct, ct.parms_id)
    return scheme, values, mine, ref, ct, ref_ct


def test_flow_keys(flows):
    _, _, mine, ref, _, _ = flows
    for a, b in zip(mine["sks"] + [mine["csk"]], ref["sks"] + [ref["csk"]]):
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    for a, b in zip(mine["pks"] + [mine["cpk"]], ref["pks"] + [ref["cpk"]]):
        np.testing.assert_array_equal(a.to_numpy(), b.data.to_numpy())
    c1 = mine["pks"][0].to_numpy()[1]
    assert all(np.array_equal(pk.to_numpy()[1], c1) for pk in mine["pks"])


def test_flow_galois_shares_and_aggregate(flows):
    _, _, mine, ref, _, _ = flows
    for a, b in zip(mine["gks"] + [mine["common"]], ref["gks"] + [ref["common"]]):
        assert len(a.keys) == len(b.keys) == N
        for elt in mine["elts"]:
            np.testing.assert_array_equal(u64(a.key(elt)), to_host(b.keys[(elt - 1) // 2]))
        assert sum(k is not None for k in a.keys) == len(mine["elts"])
    for share in mine["gks"][1:]:
        for elt in mine["elts"]:
            assert torch.equal(share.key(elt)[:, 1], mine["gks"][0].key(elt)[:, 1])


def test_flow_partials_and_aggregate(flows):
    scheme, values, mine, ref, ct, ref_ct = flows
    if scheme != "BGV":
        np.testing.assert_array_equal(ct.to_numpy(), ref_ct.to_numpy())
    partials, agg, direct = decrypt_side(st, mine, ct)
    ref_partials, ref_agg, ref_direct = decrypt_side(seal_tpu, ref, ref_ct)
    for p, q in zip(partials, ref_partials):
        np.testing.assert_array_equal(p.to_numpy(), q.to_numpy())
        assert (p.parms_id, p.is_ntt_form, p.scale, p.correction_factor) == \
            (ct.parms_id, ct.is_ntt_form, ct.scale, ct.correction_factor)
    np.testing.assert_array_equal(plain_words(agg), plain_words(ref_agg))
    np.testing.assert_array_equal(plain_words(agg), plain_words(direct))
    np.testing.assert_array_equal(plain_words(direct), plain_words(ref_direct))
    # the phase under the common key, in the ciphertext's domain
    phase = st.Decryptor(mine["ctxs"][0], mine["csk"]).dot_product_ct_sk(ct)
    ref_phase = seal_tpu.Decryptor(ref["ctxs"][0], ref["csk"]).dot_product_ct_sk(ref_ct)
    np.testing.assert_array_equal(u64(phase), to_host(ref_phase))
    if scheme == "CKKS":
        assert agg.parms_id == ct.parms_id and agg.scale == ct.scale
        got = st.CKKSEncoder(mine["ctxs"][0]).decode(agg).numpy()
        assert np.abs(got - values).max() < 1e-3
    else:
        got = st.BatchEncoder(mine["ctxs"][0]).decode(agg).numpy()
        np.testing.assert_array_equal(got, values)


def test_flow_threshold_rotation(flows):
    """A rotation under the aggregated keys, made by the port, decrypts by
    threshold to the rotated slots."""
    scheme, values, mine, _, ct, _ = flows
    ev = st.Evaluator(mine["ctxs"][0])
    if scheme == "CKKS":
        rot = ev.rotate_vector(ct, 1, mine["common"])
        _, agg, _ = decrypt_side(st, mine, rot)
        got = st.CKKSEncoder(mine["ctxs"][0]).decode(agg).numpy()
        assert np.abs(got - np.roll(values, -1)).max() < 1e-3
    else:
        rot = ev.rotate_columns(ev.rotate_rows(ct, 1, mine["common"]), mine["common"])
        _, agg, direct = decrypt_side(st, mine, rot)
        got = st.BatchEncoder(mine["ctxs"][0]).decode(agg).numpy()
        rows = values.reshape(2, N // 2)
        np.testing.assert_array_equal(got, np.roll(rows, -1, axis=1)[::-1].reshape(-1))
        np.testing.assert_array_equal(plain_words(agg), plain_words(direct))


# -- (c) smudging, with the unseeded factories patched ----------------------------------

FIXED = (99, 98, 97, 96, 95, 94, 93, 92)


@pytest.fixture()
def fixed_unseeded(monkeypatch):
    monkeypatch.setattr(seal_tpu.randomgen, "random_seed", lambda: FIXED)
    monkeypatch.setattr(st.randomgen, "random_seed", lambda: FIXED)


@pytest.fixture(scope="module")
def small():
    """Three BFV and CKKS parties at n = 64 in both packages."""
    out = {}
    for scheme, bits in (("BFV", [40, 40, 40]), ("CKKS", [40, 40, 40])):
        for lib, kw in ((st, {"device": "cpu"}), (seal_tpu, {})):
            ctxs = []
            for i in range(PARTIES):
                parms = lib.EncryptionParameters(getattr(lib.SchemeType, scheme))
                parms.set_poly_modulus_degree(64)
                parms.set_coeff_modulus(lib.CoeffModulus.create(64, bits))
                if scheme == "BFV":
                    parms.set_plain_modulus(257)
                parms.set_random_seed(party_seed(i))
                ctxs.append(lib.SEALContext(parms, sec_level=lib.SecLevelType.NONE, **kw))
            kgs = [lib.KeyGenerator(c) for c in ctxs]
            sks = [kg.generate_secret_key() for kg in kgs]
            pks = [kgs[0].create_public_key_with_sk(sks[0])]
            pks += [kgs[i].create_public_key_with_same_c1(sks[i], pks[0])
                    for i in range(1, PARTIES)]
            cpk = kgs[0].create_common_public_key(pks)
            if scheme == "BFV":
                plain = lib.Plaintext.from_hex_string("7x^3 + 5", **(
                    {"device": "cpu"} if lib is st else {}))
            else:
                plain = lib.CKKSEncoder(ctxs[0]).encode(np.linspace(-1, 1, 32), 2.0 ** 30)
            ct = lib.Encryptor(ctxs[0], cpk).encrypt(plain)
            out[scheme, lib] = dict(ctxs=ctxs, sks=sks, ct=ct)
    return out


@pytest.mark.parametrize("bits", [8, 20, 40, 61, 70])
@pytest.mark.parametrize("scheme", ["BFV", "CKKS"])
def test_smudged_partials_match_seal_tpu(small, fixed_unseeded, scheme, bits):
    mine, ref = small[scheme, st], small[scheme, seal_tpu]
    np.testing.assert_array_equal(mine["ct"].to_numpy(), ref["ct"].to_numpy())
    parts = [st.Decryptor(c, sk).distributed_decrypt(mine["ct"], smudging_bits=bits)
             for c, sk in zip(mine["ctxs"], mine["sks"])]
    ref_parts = [seal_tpu.Decryptor(c, sk).distributed_decrypt(ref["ct"], smudging_bits=bits)
                 for c, sk in zip(ref["ctxs"], ref["sks"])]
    for p, q in zip(parts, ref_parts):
        np.testing.assert_array_equal(p.to_numpy(), q.to_numpy())
    # each smudged share minus its unsmudged twin is a centred value below 2^bits
    dec = st.Decryptor(mine["ctxs"][0], mine["sks"][0])
    clean = dec.distributed_decrypt(mine["ct"])
    cd = mine["ctxs"][0].get_context_data(mine["ct"].parms_id)
    diff = (parts[0].poly(0) - clean.poly(0)) % cd.mod_consts.q
    if mine["ct"].is_ntt_form:
        diff = st.ops.ntt.ntt_inverse(diff, cd.ntt_tables)
    rows = [[v - q if v > q // 2 else v for v in row]
            for row, q in zip(diff.tolist(), cd.key_moduli())]
    if bits < 40:
        assert all(row == rows[0] for row in rows)
        assert max(abs(v) for v in rows[0]) <= 1 << bits
    if scheme == "BFV" and bits <= 20:
        agg = dec.aggregate_partial_decryption(mine["ct"], parts)
        assert agg.to_hex_string() == "7x^3 + 5"


@pytest.mark.parametrize("bits", [0, 10, 25, 70])
def test_ckks_flood_bits_match_seal_tpu(small, fixed_unseeded, bits):
    mine, ref = small["CKKS", st], small["CKKS", seal_tpu]
    got = st.Decryptor(mine["ctxs"][0], mine["sks"][0]).decrypt(mine["ct"], flood_bits=bits)
    want = seal_tpu.Decryptor(ref["ctxs"][0], ref["sks"][0]).decrypt(ref["ct"],
                                                                   flood_bits=bits)
    np.testing.assert_array_equal(got.to_numpy(), plain_words(want))
    assert got.scale == want.scale and got.parms_id == tuple(want.parms_id)


# -- (d) the refusals ---------------------------------------------------------------------

def test_refusals(small):
    mine = small["BFV", st]
    ctx, sk, ct = mine["ctxs"][0], mine["sks"][0], mine["ct"]
    size3 = st.Evaluator(ctx).multiply(ct, ct)
    with pytest.raises(ValueError, match="size-2"):
        st.Decryptor(ctx, sk).distributed_decrypt(size3)
    with pytest.raises(ValueError, match="flood_bits"):
        st.Decryptor(ctx, sk).decrypt(ct, flood_bits=20)
    kg = st.KeyGenerator(ctx)
    gk0 = kg.create_galois_keys([3], secret_key=sk)
    with pytest.raises(ValueError, match="save_seed"):
        kg.create_galois_keys([3], save_seed=True, secret_key=mine["sks"][1],
                              c1_refs_per_elt=[gk0.key(3)[:, 1]])
    ckks = small["CKKS", st]
    batch = st.dtypes.stack_ciphertexts([ckks["ct"], ckks["ct"]])
    with pytest.raises(ValueError, match="batch"):
        st.Decryptor(ckks["ctxs"][0], ckks["sks"][0]).distributed_decrypt(batch)
    with pytest.raises(ValueError, match="batch"):
        st.Decryptor(ckks["ctxs"][0], ckks["sks"][0]).decrypt(batch, flood_bits=8)


def test_shared_c1_key_of_a_seeded_reference_saves_unseeded(small):
    """A party key takes the reference's c1 but not its seed, in both
    packages, so it crosses the wire whole and in the same bytes."""
    saved = []
    for lib in (st, seal_tpu):
        ctxs, sks = small["BFV", lib]["ctxs"], small["BFV", lib]["sks"]
        ref = lib.KeyGenerator(ctxs[0]).create_public_key_with_sk(sks[0], save_seed=True)
        assert ref.data.seed_info is not None
        pk = lib.KeyGenerator(ctxs[1]).create_public_key_with_same_c1(sks[1], ref)
        assert pk.data.seed_info is None
        saved.append(lib.serialization.save_public_key(pk))
    assert saved[0] == saved[1]
    back = st.serialization.load_public_key(small["BFV", st]["ctxs"][1], saved[0])
    assert st.serialization.save_public_key(back) == saved[0]


def test_bgv_flood_bits_refused():
    parms = st.EncryptionParameters(st.SchemeType.BGV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(
        st.Plaintext.from_hex_string("3", device="cpu"))
    with pytest.raises(ValueError, match="flood_bits"):
        st.Decryptor(ctx, kg.secret_key()).decrypt(ct, flood_bits=8)
    assert st.Decryptor(ctx, kg.secret_key()).decrypt(ct).to_hex_string() == "3"
