"""The plain reference against the served program's CPU path (its plain
kernels) at a small float32 Mamba2: the program's prefill and decode logits
and tokens, as the output check reads them."""
import pytest

from bench import harness
from bench.testing import small_cell


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill-2k",
                                      "mamba2-2.7b.decode-b256"])
def test_reference_matches_program(workload):
    c = small_cell(workload, d=64, layers=3)
    b = harness.Bench(c, "cpu")
    b.load(2**31 + 11)
    calls = [b.call(2**31 + 11, k) for k in range(2)]
    nums = harness.judge(c.conf, calls, b.weights(2**31 + 11), "cpu",
                         control=True)
    # float32 on both sides: sums in other orders only
    assert nums["logit_err"] < 1e-5 and nums["logit_dev"] < 1e-4
    assert nums["token_mismatch"] == 0 and nums["token_gap"] == 0
    # float8 matmuls move the logits by far more
    assert nums["control_logit_err"] > 1000 * nums["logit_err"]


def test_weights_repeat_from_seed():
    c = small_cell("mamba2-2.7b.prefill-2k")
    b = harness.Bench(c, "cpu")
    w1, w2, w3 = b.weights(5), b.weights(5), b.weights(6)
    assert all((w1[n] == w2[n]).all() for n in w1)
    assert not (w1["embed"] == w3["embed"]).all()
    assert set(w1) == set(b.shapes)
