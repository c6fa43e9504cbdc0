"""The port's hybrid key switching (α = 2 special primes) against
seal_tpu.Evaluator at n = 1024, bit for bit: multiply, relinearize,
rescale_to_next and the fused relinearize_rescale, with keys and
ciphertexts that each makes from the same seed (the port's public-key
encryption at the first level divides by both special primes). Also the
fast base conversion's dot product, both of its routes, against exact
integers."""

import numpy as np
import pytest
import torch

from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import hybrid_keyswitch as hyb
from seal_tpu_torch.ops.modring import make_mod_consts, shoup_pair
from tests.test_torch_evaluator import assert_pipeline_matches_seal_tpu


@pytest.mark.parametrize("bits", [
    [40] * 6,       # 4 data primes in 2 full digits, 2 special
    [40] * 5,       # 3 data primes: a partial last digit
], ids=["even_digits", "partial_digit"])
def test_pipeline_matches_seal_tpu_alpha2(bits):
    assert_pipeline_matches_seal_tpu(2, bits)


@pytest.mark.parametrize("a", [1, 2, 4, 5, 6])
def test_shoup_dot_both_routes_exact(a):
    """Σ_t w_t·hat_t mod q: the Shoup-lazy route (a <= 4) and the 128-bit
    route (a > 4) against exact Python ints, with 60-bit moduli."""
    rng = np.random.default_rng(a)
    src = [m.value for m in CoeffModulus.create(64, [60] * a)]
    out = [m.value for m in CoeffModulus.create(64, [58, 59, 60])]
    w = np.stack([rng.integers(0, q, 64, dtype=np.int64) for q in src])
    w[:, 0] = [q - 1 for q in src]
    hats = [[int(rng.integers(0, p, dtype=np.int64)) for p in out] for _ in range(a)]
    hat_op, hat_qt = shoup_pair(hats, [out] * a, "cpu")
    got = hyb.shoup_dot(torch.from_numpy(w), hat_op, hat_qt, make_mod_consts(out, "cpu"))
    want = [[sum(int(w[t, x]) * hats[t][i] for t in range(a)) % p for x in range(64)]
            for i, p in enumerate(out)]
    assert got.tolist() == want
