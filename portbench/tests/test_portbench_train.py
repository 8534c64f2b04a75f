"""The training cells at a reduced size on the CPU, in float32 with
limits for that size (`portbench_small.TRAIN_SMALL`): a sound run is
correct, and the comparison fails the control (the reference in float8
products in the program's place) and a run with the train step broken
underneath, once for each fault a one-chip training cell can have (the
train loop's ``FAULTS``), and a change of the right size in the wrong
direction."""
import json
import time

import pytest

from portbench_small import CELLS, run_small, small_tree, one_thread  # noqa: F401
from portbench import check, harness

CONFIGS = ["qwen3-moe-30b-a3b.stage4"]
LOOP = harness.load_loop("train")


@pytest.fixture(scope="module", params=CONFIGS)
def tree(request, tmp_path_factory):
    return request.param, small_tree(tmp_path_factory.mktemp("t"),
                                     request.param)


def limits(tree):
    config, t = tree
    return json.loads((t / "portbench" / "limits" /
                       f"{CELLS[config]}.json").read_text())


def test_the_sound_step_is_correct(tree):
    config, t = tree
    out = run_small(t, CELLS[config])
    assert out["correct"] is True, out["checks"]
    assert list(out["metrics"]) == ["train_tokens_per_s", "setup_s"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9, 4_000_000_007])
def test_the_control_fails(tree, seed):
    config, t = tree
    ctx = harness.Context(CELLS[config], seed, 0.0, False, "cpu",
                          time.time(), t, t / "portbench")
    numbers = LOOP.judge_control(ctx)
    assert not check.verdict(numbers, limits(tree)), numbers


@pytest.mark.parametrize("fault", sorted(LOOP.FAULTS))
def test_a_broken_step_is_not_correct(tree, fault):
    config, t = tree
    with LOOP.FAULTS[fault]():
        out = run_small(t, CELLS[config])
    assert out["correct"] is False, out["checks"]


def readings_of(change: dict, grads: dict) -> dict:
    return {"losses": [1.0], "grads": grads,
            "change": check.leaf_norms(change)}


@pytest.mark.parametrize("flip", ["none", "one_leaf", "all"])
def test_the_direction_of_a_change_is_judged(flip):
    """A change of the right norm in the wrong direction: the gap of the
    norms reads 0, the share moved the wrong way 1 where a leaf is
    flipped."""
    import torch
    gen = torch.Generator().manual_seed(5)
    ref = {p: torch.randn(40, 3, generator=gen) for p in "abc"}
    prog = {p: -v if flip == "all" or (flip == "one_leaf" and p == "b")
            else v.clone() for p, v in ref.items()}
    grads = {"a": 1.0, "b": 2.0, "c": 3.0}
    want = readings_of(ref, grads)
    want["wrong_way"] = {p: check.wrong_way_share(
        check.pack_signs(prog[p]), ref[p], ref[p].abs()) for p in ref}
    got = check.judge_train(readings_of(prog, grads), want)
    assert got["update_err"] == pytest.approx(0.0, abs=1e-12)
    assert got["update_dir_err"] == (0.0 if flip == "none" else 1.0)


def test_the_share_moved_the_wrong_way_in_blocks():
    import torch
    gen = torch.Generator().manual_seed(6)
    a, b = torch.randn(1003, generator=gen), torch.randn(1003, generator=gen)
    w = torch.rand(1003, generator=gen)
    packed = check.pack_signs(a)
    assert packed.dtype == torch.uint8 and packed.numel() == 126
    assert torch.equal(check.unpack_signs(packed, 1003, "cpu"), a > 0)
    share = check.wrong_way_share(packed, b, w, block=64)
    diff = (a > 0) != (b > 0)
    assert share == pytest.approx(float(w[diff].sum() / w.sum()), rel=1e-6)
    assert check.wrong_way_share(check.pack_signs(b), b, w) == 0.0
