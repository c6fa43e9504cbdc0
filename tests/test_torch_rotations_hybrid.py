"""The port's CKKS rotations with hybrid key switching (α = 2 special
primes) against seal_tpu.Evaluator at n = 1024, bit for bit: the cases of
test_torch_rotations.py, with 3 data primes in 2 digits (a partial last
digit)."""

from tests.test_torch_rotations import assert_rotations_match_seal_tpu


def test_rotations_match_seal_tpu_alpha2():
    assert_rotations_match_seal_tpu(2, [40] * 5)
