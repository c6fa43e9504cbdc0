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
