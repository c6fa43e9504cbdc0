"""SEAL's n = 4096 golden pipeline on the port, on the CPU (tolerance 0).

tests/vectors/pipeline_n4096.json holds blake2b-256 hashes of every
intermediate of SEAL's own run (tools/oracle/dump_pipeline_n4096.cpp):
keygen -> encode -> encrypt -> multiply -> relinearize -> (rescale |
mod switch) -> rotate -> decrypt -> decode for BFV, CKKS and BGV, and the
fork's three-party flow. tests/test_pipeline_n4096.py holds seal_tpu to
them; this file holds the port to every hash that file asserts, from the
parameters' random seeds alone (no seal_tpu object is carried across).

The flows are chip_smoke.py's (`VECTOR_FLOWS`), so the same code that
phase 14 runs on the card is pinned here on the CPU. The key-switching
flows run a second time with config.keyswitch_shoup on (the Shoup-quotient
route of the inner product): the same hashes.
"""

import json
import pathlib

import pytest
import torch

import chip_smoke
from seal_tpu_torch.config import config

V = json.loads((pathlib.Path(__file__).parent / "vectors" / "pipeline_n4096.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hold(flow):
    got = chip_smoke.VECTOR_FLOWS[flow]("cpu")
    assert chip_smoke.first_vector_mismatch(got, V) is None
    return got


def test_bfv_pipeline():
    got = _hold("bfv")
    assert got["bfv_plain_modulus"] == V["bfv_plain_modulus"]
    assert got["bfv_noise_budget"] == V["bfv_noise_budget"] == 53


def test_ckks_pipeline():
    assert _hold("ckks")["ckks_rescale_scale"] == V["ckks_rescale_scale"]


def test_bgv_pipeline():
    _hold("bgv")


def test_multiparty_pipeline():
    _hold("multiparty")


@pytest.mark.parametrize("flow", ["bfv", "ckks", "bgv"])
def test_keyswitch_flows_with_the_shoup_route(flow):
    config.keyswitch_shoup = True
    try:
        _hold(flow)
    finally:
        config.keyswitch_shoup = False


def test_flows_cover_every_entry():
    """Every hash and number of the file is held by one flow, and each
    flow's entries are all in the file."""
    names = []
    for flow in chip_smoke.VECTOR_FLOWS.values():
        names += list(flow("cpu"))
    assert sorted(names) == sorted(set(V) - {"n", "seed"})
    assert V["n"] == chip_smoke.VECTOR_N and tuple(V["seed"]) == chip_smoke.VECTOR_SEED


def test_a_changed_bit_is_named():
    got = dict(_hold("bgv"))
    got["bgv_relin"] = "0" * 64
    assert chip_smoke.first_vector_mismatch(got, V).startswith("bgv_relin:")
