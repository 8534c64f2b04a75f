"""The comparison that decides ``correct`` has to fail what is wrong: the
control (the reference in float8 products in the program's place) on
three seeds, and a run with the timed path broken underneath, once for
each fault a prefill cell can have (the prefill loop's ``FAULTS``).  At
a reduced size on the CPU, against each cell's own limits."""
import json
import time

import pytest

from portbench_small import CELLS, ROOT, run_small, small_tree, one_thread  # noqa: F401
from portbench import check, harness

LOOP = harness.load_loop("prefill")


@pytest.fixture(scope="module", params=["qwen3-moe-30b-a3b"])
def tree(request, tmp_path_factory):
    return request.param, small_tree(tmp_path_factory.mktemp("c"),
                                     request.param)


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 4_000_000_003])
def test_the_control_fails(tree, seed):
    config, t = tree
    ctx = harness.Context(CELLS[config], seed, 0.0, False, "cpu",
                          time.time(), t, t / "portbench")
    _, params, pool, _ = LOOP.setup(ctx)
    numbers = LOOP.judge_control(ctx, params, pool[0])
    numbers["rerun_mismatch"] = 0.0
    limits = json.loads((ROOT / "portbench" / "limits" /
                         f"{CELLS[config]}.json").read_text())
    assert not check.verdict(numbers, limits), numbers


@pytest.mark.parametrize("fault", sorted(LOOP.FAULTS))
def test_a_broken_timed_path_is_not_correct(tree, fault):
    config, t = tree
    with LOOP.FAULTS[fault]():
        out = run_small(t, CELLS[config])
    assert out["correct"] is False, out["checks"]


def test_the_sound_path_is_correct(tree):
    config, t = tree
    out = run_small(t, CELLS[config])
    assert out["correct"] is True, out["checks"]
