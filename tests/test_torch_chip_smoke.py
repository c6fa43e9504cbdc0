"""chip_smoke.py's phase 16 recorder on the CPU (no card needed).

`PathShapes` wraps the four *_cuda kernel wrappers while the paths run and
notes each (kernel, input shape, moduli) launched, so that phase 16 can
hold every such configuration against the plain version. Here each wrapper
is called with CPU tensors: it is noted, then raises (no kernel without a
card), and no launch is counted. The bound helpers of phases 3, 4 and 16
are checked against the byte and multiply counts written out by hand.
"""

import pytest
import torch

import chip_smoke
from seal_tpu_torch import CoeffModulus, cuda
from seal_tpu_torch.ops import keyswitch, ntt

N = 256


@pytest.fixture
def not_capturing(monkeypatch):
    # the CPU build of torch has no CUDA graph state to ask
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def _call_every_wrapper(moduli, tables, consts):
    x = torch.zeros(2, len(moduli), N, dtype=torch.int64)
    keys = torch.zeros(2, 2, len(moduli), N, dtype=torch.int64)
    calls = ((ntt.ntt_forward_cuda, (x, tables)),
             (ntt.ntt_inverse_cuda, (x, tables, True)),
             (ntt.ntt_inverse_cuda, (x, tables.rows([0, 1, 2]))),   # the same moduli
             (ntt.ntt_forward_cuda, (x[:, :2].contiguous(), tables.rows(slice(0, 2)))),
             (ntt.ntt_forward_cuda, (x[:0], tables)),                # no rows: no launch
             (keyswitch.keyswitch_inner_cuda, (x, keys, consts)),
             (keyswitch.keyswitch_inner_shoup_cuda, (x, keys, keys, consts, max(moduli))))
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_path_shapes_notes_each_configuration_once(not_capturing):
    moduli = [m.value for m in CoeffModulus.create(N, [40, 40, 50])]
    tables = ntt.make_ntt_tables(N.bit_length() - 1, moduli, "cpu")
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    wrappers = (ntt.ntt_forward_cuda, ntt.ntt_inverse_cuda,
                keyswitch.keyswitch_inner_cuda, keyswitch.keyswitch_inner_shoup_cuda)
    cuda.reset_launches()
    with chip_smoke.PathShapes() as shapes:
        _call_every_wrapper(moduli, tables, consts)
        # the dispatching entry points on CPU tensors run the plain version
        ntt.ntt_forward(torch.zeros(2, 3, N, dtype=torch.int64), tables)
    assert (ntt.ntt_forward_cuda, ntt.ntt_inverse_cuda, keyswitch.keyswitch_inner_cuda,
            keyswitch.keyswitch_inner_shoup_cuda) == wrappers
    assert all(v == 0 for v in cuda.launches.values())
    q = tuple(moduli)
    assert sorted(shapes.configs()) == sorted([
        ("ntt_forward", (2, 3, N), q, None),
        ("ntt_forward", (2, 2, N), q[:2], None),
        ("ntt_inverse", (2, 3, N), q, None),
        ("keyswitch_inner", (2, 3, N), q, None),
        ("keyswitch_inner_shoup", (2, 3, N), q, max(moduli)),
    ])


def test_keyswitch_bounds_count_the_work():
    J, I, B = 8, 9, 16
    n = chip_smoke.N
    # t and the output once per target, the key (K3: and its quotients) once
    assert chip_smoke.keyswitch_bytes(1, J, I, False) == (J * I * n + 2 * J * I * n
                                                          + 2 * I * n) * 8
    assert chip_smoke.keyswitch_bytes(B, J, I, True, 4096) == (
        B * J * I * 4096 + 4 * J * I * 4096 + 2 * B * I * 4096) * 8
    lo, hi = chip_smoke.MUL_LO, chip_smoke.MUL_HI
    assert chip_smoke.keyswitch_muls(J, I, False) == I * n * (2 * J * (lo + hi)
                                                            + 2 * (4 * lo + 3 * hi))
    assert chip_smoke.keyswitch_muls(J, I, True, 4096) == I * 4096 * 2 * J * (2 * lo + hi)
