"""The port's roofline (``repro_torch/utils/roofline.py``) against JAX's
(``repro/utils/roofline.py``) with JAX's ``H100`` spec on the same inputs:
every field of ``row()`` equal within 1e-12 relative (the same float
arithmetic in the same order gives the same bits), the analytic model
FLOPs exact, and the markdown table identical.
"""
import math

import pytest

from repro.utils import roofline as jroof
from repro_torch.utils import roofline

# (name, chips, flops, bytes, collective bytes, model flops, peak bytes,
# collectives, ring size): compute-, memory- and collective-bound cases,
# and a program with no FLOPs (ratio 0)
CASES = [
    ("compute", 256, 3.6e15, 2.1e11, 1.9e9, 6 * 0.5e9 * 1.05e6, 1.6e11, 96,
     16),
    ("memory", 1, 2.8e11, 3.9e9, 0.0, 2 * 0.5e9 * 384, 1.1e9, 0, 1),
    ("collective", 512, 1.2e9, 3.0e8, 7.5e10, 2 * 4.05e11 * 128, 2.0e10,
     4032, 16),
    ("no-flops", 8, 0.0, 1.0e6, 4096.0, 0.0, 0.0, 1, 2),
]


def _both(case):
    name, chips, flops, nbytes, coll, mf, peak, count, ring = case
    kw = dict(chips=chips, cost_analysis={"flops": flops,
                                          "bytes accessed": nbytes},
              collective_bytes=coll, model_flops=mf, peak_memory_bytes=peak,
              collective_count=count, ring_size=ring)
    return (roofline.analyze(name, **kw),
            jroof.analyze(name, hw=jroof.H100, **kw))


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_analyze_equals_jax_on_every_field(case):
    mine, theirs = _both(case)
    a, b = mine.row(), theirs.row()
    hw_a, hw_b = a.pop("hw"), b.pop("hw")
    assert set(a) == set(b)
    for k in a:
        assert _close(a[k], b[k]), (k, a[k], b[k])
    # the port's spec is JAX's H100 plus the f32 peak chip_smoke.py uses
    assert {k: v for k, v in hw_a.items() if k != "f32_flops"} == hw_b
    assert hw_a["f32_flops"] == 67e12


def test_default_hardware_is_the_h100():
    rep = roofline.analyze("x", chips=1, cost_analysis={"flops": 989e12},
                           collective_bytes=0.0, model_flops=0.0)
    assert rep.hw is roofline.H100 and rep.compute_s == 1.0
    assert rep.bottleneck == "compute" and rep.step_time_s == 1.0


def test_model_flops_equal_jax():
    for n, d in ((0.5e9, 4096 * 256), (405e9, 32768 * 32), (3.0, 7.0)):
        assert roofline.model_flops_train(n, d) == jroof.model_flops_train(
            n, d)
        assert (roofline.model_flops_forward(n, d)
                == jroof.model_flops_forward(n, d))


def test_format_table_equals_jax():
    pairs = [_both(c) for c in CASES]
    assert (roofline.format_table([m for m, _ in pairs])
            == jroof.format_table([t for _, t in pairs]))


@pytest.mark.parametrize("nbytes,flops,f32,by", [
    (3.35e9, 1e9, False, "bytes"),         # 1 ms of HBM, 1 us of bf16
    (1e6, 989e9, False, "operations"),     # 1 ms of bf16 tensor cores
    (1e6, 67e9, True, "operations"),       # 1 ms of f32 outside them
])
def test_kernel_bound_ms(nbytes, flops, f32, by):
    ms, got = roofline.kernel_bound_ms(nbytes, flops, f32=f32)
    assert math.isclose(ms, 1.0, rel_tol=1e-12) and got == by
