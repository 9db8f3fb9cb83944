"""The roofline counts reproduce the bounds the program's smoke run
reported (PERF.md's kernel table): K3' 0.923 ms a 128-observation chunk of
config 1, K1' 0.411 ms at 128 x 64 x 40960 and 0.1182 ms in chi2_sel mode
at 184 x 64 x 8192."""

import pytest

from benchmark import rooflines


@pytest.mark.parametrize("fn,args,ms", [
    (rooflines.k3_fold_quantize, (128, 64, 20, 2048), 0.923),
    (rooflines.k1_field, (128, 64, 40960), 0.411),
    (rooflines.k1_field, (184, 64, 8192), 0.1182),
])
def test_bound_matches_the_kernel_table(fn, args, ms):
    s, by = fn(*args)
    assert by == "operations"
    assert s * 1e3 == pytest.approx(ms, abs=5e-4)


def test_bytes_bound_wins_for_a_memory_bound_shape():
    # one sample a row and a long int-free copy: bytes dominate
    s, by = rooflines.bound_s({"int32": 0.0}, 1, 3.35e12)
    assert by == "bytes" and s == pytest.approx(1.0)
