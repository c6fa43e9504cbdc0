"""The port stands alone: importing seal_tpu_torch (every module), the
examples ported to it (examples_torch/) or chip_smoke.py loads neither JAX
nor any module of seal_tpu, and a context never moves to the CPU by
itself."""

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
EXAMPLES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples_torch").glob("*.py"))


def _loaded_after(imports: str) -> list[str]:
    code = (f"import sys, json\n{imports}\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    return json.loads(out.stdout.splitlines()[-1])


def _load_examples() -> str:
    return "import runpy\n" + "\n".join(f"runpy.run_path({p!r})" for p in EXAMPLES)


@pytest.mark.parametrize("what", ["package", "chip_smoke", "examples"])
def test_no_jax_no_seal_tpu(what):
    imports = {"chip_smoke": "import chip_smoke", "examples": _load_examples(),
               "package": "\n".join(["import seal_tpu_torch"]
                                    + [f"import {m}" for m in MODULES])}[what]
    loaded = _loaded_after(imports)
    assert "seal_tpu_torch.evaluator" in loaded or what == "chip_smoke"
    bad = [m for m in loaded
           if m == "jax" or m.startswith(("jax.", "jaxlib", "seal_tpu.")) or m == "seal_tpu"]
    assert bad == []


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "seal_tpu_torch").rglob("*.py")]
    + EXAMPLES + ["chip_smoke.py"]))
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
            "seal_tpu_torch.config", "seal_tpu_torch.ops.galois",
            "seal_tpu_torch.encoders", "seal_tpu_torch.ops.rns",
            "seal_tpu_torch.dtypes", "seal_tpu_torch.ckks", "seal_tpu_torch.encryptor",
            "seal_tpu_torch.decryptor", "seal_tpu_torch.rlwe", "seal_tpu_torch.plain_lift",
            "seal_tpu_torch.ops.hybrid_keyswitch", "seal_tpu_torch.ops.compose",
            "seal_tpu_torch.utils.dwt", "seal_tpu_torch.serialization",
            "seal_tpu_torch.valcheck", "seal_tpu_torch.keygenerator",
            "seal_tpu_torch.modulus", "seal_tpu_torch.encryption_params",
            "seal_tpu_torch.jit", "seal_tpu_torch.native"} <= set(MODULES)
    originals = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert EXAMPLES == [f"examples_torch/{name}" for name in originals]
    assert len(EXAMPLES) == 14


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
    kg = st.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    tables = ctx.first_context_data().ntt_tables
    for t in (kg.secret_key().data, rk.keys[0], tables.fwd_op, tables.mc.q):
        assert t.device.type == "cpu" and t.dtype == torch.int64


def test_non_ckks_parameters_are_refused():
    """BFV and BGV parameters without a plain modulus are refused, with
    SEAL's message, and so are parameters of no scheme."""
    for scheme in (st.SchemeType.BFV, st.SchemeType.BGV):
        parms = st.EncryptionParameters(scheme)
        parms.set_poly_modulus_degree(64)
        parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40]))
        ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
        assert not ctx.parameters_set
        assert ctx.parameter_error_message() == (
            "plain_modulus's bit count is not bounded by SEAL_PLAIN_MOD_BIT_COUNT_MIN(MAX)")
        with pytest.raises(ValueError):
            st.Evaluator(ctx)
    ctx = st.SEALContext(st.EncryptionParameters(st.SchemeType.NONE),
                         sec_level=st.SecLevelType.NONE, device="cpu")
    assert ctx.parameter_error_message() == "scheme must be BFV or CKKS or BGV"
