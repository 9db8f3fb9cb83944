"""Each cell on the card at its own size for a short window: the run comes
out correct, with its end-to-end metrics.  Needs an NVIDIA GPU; decided
inside the test, so every test process collects the same tests."""

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    r = harness.run_cell(name, 2**31 + 7, 2.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert "setup_s" in r["metrics"]
