"""Every flag and public function of seal_tpu/config.py is ported to
seal_tpu_torch/config.py or retired there with a reason."""

import dataclasses
import inspect

from seal_tpu import config as jconfig
from seal_tpu_torch import config as tconfig


def _public_functions(module):
    return {name for name, obj in vars(module).items()
            if inspect.isfunction(obj) and obj.__module__ == module.__name__
            and not name.startswith("_")}


def test_every_flag_and_function_is_ported_or_retired():
    ported = {f.name for f in dataclasses.fields(tconfig.GlobalConfig)}
    ported |= _public_functions(tconfig)
    names = {f.name for f in dataclasses.fields(jconfig.GlobalConfig)}
    names |= _public_functions(jconfig)
    assert names - ported == set(tconfig.RETIRED)
    assert ported & set(tconfig.RETIRED) == set()
    assert all(isinstance(why, str) and why for why in tconfig.RETIRED.values())


def test_ported_flags_keep_seal_tpus_defaults():
    for field in dataclasses.fields(tconfig.GlobalConfig):
        assert getattr(tconfig.config, field.name) == getattr(jconfig.config, field.name)


def test_package_root_exports_what_seal_tpus_does():
    """JitEvaluator, config and parms_id_zero import from the package root,
    as from seal_tpu's, and the root holds every public name of seal_tpu's."""
    import seal_tpu
    import seal_tpu_torch
    from seal_tpu_torch import JitEvaluator, config, jit, parms_id_zero

    assert JitEvaluator is jit.JitEvaluator
    assert config is tconfig and config.config.keyswitch_shoup is False
    assert parms_id_zero == (0, 0, 0, 0) == seal_tpu.parms_id_zero
    assert {"JitEvaluator", "config", "parms_id_zero"} <= set(seal_tpu_torch.__all__)
    # names bound by seal_tpu/__init__.py (submodules appear in dir() only
    # once something imports them)
    public = {name for name, obj in vars(seal_tpu).items()
              if not name.startswith("_") and not inspect.ismodule(obj)} | {"config"}
    assert public - set(dir(seal_tpu_torch)) == set()
