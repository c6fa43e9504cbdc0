"""The examples ported to seal_tpu_torch (examples_torch/) run on the CPU
at a tiny size: each holds its own results (the captured pipelines bit for
bit against the eager Evaluator, the streamed products against numpy, and
every assertion of the original in examples/) and ends with `<name> OK`.
Examples 2 and 7 have no size parameter and run at the originals' sizes
(BFV n=4096, CKKS n=8192)."""

import importlib.util
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples_torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(name[:-3], EXAMPLES / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_performance_example(capsys):
    _load("8_performance.py").main(n_bfv=256, n_ckks=256, device="cpu")
    out = capsys.readouterr().out
    assert "multiply+relin+rescale" in out and out.rstrip().endswith("8_performance OK")


def test_streaming_pipeline_example(capsys):
    _load("13_streaming_pipeline.py").main(n=256, total=8, B=4, device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("13_streaming_pipeline OK")


# each script at the tiny size its original accepts: n = 256 where the
# original's reduced branch allows it, n = 1024 for 3 and 10, B = 4 for 14
TINY = {
    "1_bfv_basics.py": dict(n=256),
    "2_encoders.py": {},
    "3_levels.py": dict(n=1024),
    "4_bgv_basics.py": dict(n=256),
    "5_ckks_basics.py": dict(n=256),
    "6_rotation.py": dict(n_bfv=256, n_ckks=256),
    "7_serialization.py": {},
    "9_encrypted_matvec.py": dict(n=256),
    "10_encrypted_logreg.py": dict(n=1024),
    "11_hybrid_keyswitch.py": dict(n=256),
    "12_threshold_ckks.py": dict(n=256),
    "14_batch_api.py": dict(n=256, B=4),
}


@pytest.mark.parametrize("name", list(TINY))
def test_example_runs_to_ok(name, capsys):
    _load(name).main(device="cpu", **TINY[name])
    assert capsys.readouterr().out.rstrip().splitlines()[-1] == f"{name[:-3]} OK"


def test_every_original_example_has_a_port():
    originals = sorted(p.name for p in (EXAMPLES.parent / "examples").glob("*.py"))
    assert sorted(p.name for p in EXAMPLES.glob("*.py")) == originals
    assert set(TINY) | {"8_performance.py", "13_streaming_pipeline.py"} == set(originals)
