"""The examples ported to seal_tpu_torch (examples_torch/) run on the CPU
at a tiny size: each holds its own results (the captured pipelines bit for
bit against the eager Evaluator, the streamed products against numpy)."""

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
