"""The port stands alone: importing seal_tpu_torch (every module) or
chip_smoke.py loads neither JAX nor any module of seal_tpu, and a context
never moves to the CPU by itself."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

import seal_tpu_torch as st

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(
    "seal_tpu_torch." + ".".join(p.relative_to(ROOT / "seal_tpu_torch").with_suffix("").parts)
    for p in (ROOT / "seal_tpu_torch").rglob("*.py") if p.name != "__init__.py")


def _loaded_after(imports: str) -> list[str]:
    code = (f"import sys, json\n{imports}\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("what", ["package", "chip_smoke"])
def test_no_jax_no_seal_tpu(what):
    imports = ("import chip_smoke" if what == "chip_smoke"
               else "\n".join(["import seal_tpu_torch"] + [f"import {m}" for m in MODULES]))
    loaded = _loaded_after(imports)
    assert "seal_tpu_torch.evaluator" in loaded or what == "chip_smoke"
    bad = [m for m in loaded
           if m == "jax" or m.startswith(("jax.", "jaxlib", "seal_tpu.")) or m == "seal_tpu"]
    assert bad == []


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "seal_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_import_statement_names_jax_or_seal_tpu(path):
    """Imports inside functions too, which an import at load time misses."""
    import ast

    names = []
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "seal_tpu")] == []


def test_every_module_listed():
    assert {"seal_tpu_torch.evaluator", "seal_tpu_torch.ops.ntt",
            "seal_tpu_torch.ops.keyswitch", "seal_tpu_torch.interop",
            "seal_tpu_torch.config", "seal_tpu_torch.ops.galois"} <= set(MODULES)


def _parms():
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40]))
    return parms


def test_context_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the context lives there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.SEALContext(_parms(), sec_level=st.SecLevelType.NONE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.SEALContext(_parms(), sec_level=st.SecLevelType.NONE, device="cuda")


def test_cpu_context_keeps_everything_on_the_cpu():
    ctx = st.SEALContext(_parms(), sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx, torch.Generator().manual_seed(0))
    rk = kg.create_relin_keys()
    tables = ctx.first_context_data().ntt_tables
    for t in (kg.secret_key().data, rk.keys[0], tables.fwd_op, tables.mc.q):
        assert t.device.type == "cpu" and t.dtype == torch.int64


def test_non_ckks_parameters_are_refused():
    parms = st.EncryptionParameters(st.SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40]))
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    assert not ctx.parameters_set
    assert "CKKS" in ctx.parameter_error_message()
    with pytest.raises(ValueError):
        st.Evaluator(ctx)
