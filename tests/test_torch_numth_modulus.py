"""SEAL's number-theory and modulus golden values on the port: every test
of tests/test_numth.py and tests/test_modulus.py, run with the port's
modules in place of seal_tpu's (seal_tpu_torch/utils/numth.py and
seal_tpu_torch/modulus.py, the port's own copies of those host modules).
The assertions are the originals', unchanged: SEAL's primes, roots,
inverses, NAFs, default coefficient moduli at every level, bit-count
limits and the factories' order. test_modulus_value_comparisons imports
seal_tpu's Modulus inside its body; the port's comparisons are held by
tests/test_torch_object_api.py."""

import pytest

import seal_tpu_torch.modulus as port_modulus
import tests.test_modulus as modulus_suite
import tests.test_numth as numth_suite
from seal_tpu_torch.utils import numth as port_numth


def _tests(module, skip=()):
    return sorted(name for name in vars(module) if name.startswith("test_") and name not in skip)


@pytest.mark.parametrize("name", _tests(numth_suite))
def test_numth_suite_on_the_port(name, monkeypatch):
    monkeypatch.setattr(numth_suite, "numth", port_numth)
    getattr(numth_suite, name)()


@pytest.mark.parametrize("name", _tests(modulus_suite, skip={"test_modulus_value_comparisons"}))
def test_modulus_suite_on_the_port(name, monkeypatch):
    for cls in ("CoeffModulus", "Modulus", "PlainModulus", "SecLevelType"):
        monkeypatch.setattr(modulus_suite, cls, getattr(port_modulus, cls))
    getattr(modulus_suite, name)()
