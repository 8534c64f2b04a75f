"""The frozen counts of `portbench/counts` and of the reference module's
``param_count`` / ``model_flops`` against the numbers the card printed
(`chip_smoke.py`'s kernel lines), against the program's own counting
functions, and against the values they had when they lived in
`counts/flops.py`."""
import pytest

from portbench_small import run_as, small_run_as, one_thread  # noqa: F401
from portbench.counts import flops
from portbench.reference import ops


def test_scan_counts_match_the_card():
    # B=4 S=2048 H=112 P=64 G=1 N=64 chunk 256, bf16
    assert flops.ssd_ops(4, 2048, 112, 64, 64, 256) == 45_214_597_120
    assert flops.ssd_bytes(4, 2048, 112, 64, 1, 64) == 247_988_672


@pytest.mark.parametrize("B,Hq,Hkv,D,ops,nbytes", [
    (4, 32, 32, 112, 120_317_804_544, 235_929_600),    # zamba2
    (4, 32, 4, 128, 137_506_062_336, 152_043_520),     # qwen3-moe
])
def test_flash_counts_match_the_card(B, Hq, Hkv, D, ops, nbytes):
    assert flops.flash_flops(B, 2048, 2048, Hq, D, True) == ops
    assert flops.flash_bytes(B, 2048, Hq, Hkv, D) == nbytes


@pytest.mark.parametrize("config", ["zamba2-7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("small", [False, True])
def test_model_flops_match_the_program(config, small):
    from portbench import harness
    from repro_torch.launch.roofline import model_flops_of
    from repro_torch.models.model import count_params
    m = small_run_as(config) if small else run_as(config)
    cfg = harness.program_config({"run_as": m}, "cpu")
    assert ops.param_count(m) == count_params(cfg)
    assert ops.param_count(m, active=True) == count_params(
        cfg, active_only=True)
    for kind in ("prefill", "train"):
        assert ops.model_flops(m, 4, 2048, kind) == pytest.approx(
            model_flops_of(cfg, 4, 2048, kind), rel=1e-12)


def test_model_sizes():
    assert ops.param_count(run_as("zamba2-7b")) == pytest.approx(
        6.60e9, rel=0.01)
    assert ops.param_count(run_as("qwen3-moe-30b-a3b")) == pytest.approx(
        30.5e9, rel=0.01)


# (parameters, active parameters, {(B, kind): model FLOP at S=2048}) as
# `counts.flops` gave them before the counts moved into the reference
# module; B 8 is the prefill cell's batch, 2 the train cell's.
PINNED = {
    "qwen3-moe-30b-a3b": (30532122624, 3353032704, {
        (8, "prefill"): 112870062817280.0, (8, "train"): 338610188451840.0,
        (2, "prefill"): 28217515704320.0, (2, "train"): 84652547112960.0}),
    "qwen3-moe-30b-a3b.stage4": (3114814464, 849890304, {
        (8, "prefill"): 18752464748544.0, (8, "train"): 56257394245632.0,
        (2, "prefill"): 4688116187136.0, (2, "train"): 14064348561408.0}),
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_model_flops_are_pinned(config):
    """The ``mfu.*`` readers divide by what they divided by before: the
    configuration's own reference module gives the same numbers to the
    last digit."""
    from portbench import harness
    conf = harness.config_file(harness.manifest(harness.BENCH.parent),
                               config)
    ref = harness.reference_module(config, conf)
    n, active, steps = PINNED[config]
    m = conf["run_as"]
    assert ref.param_count(m) == n
    assert ref.param_count(m, active=True) == active
    for (B, kind), f in steps.items():
        assert ref.model_flops(m, B, 2048, kind) == f


@pytest.mark.parametrize("args", [(2, 2048, 112, 64, 64, 256),
                                  (1, 300, 2, 128, 128, 128),
                                  (2, 320, 4, 32, 16, 64)])
def test_scan_ops_match_the_program(args):
    from repro_torch.kernels.ssd.kernel import ssd_ops
    assert flops.ssd_ops(*args) == ssd_ops(*args)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (2048, 2048, True, 0), (300, 300, False, 0), (2048, 2048, True, 1024),
    (1, 4096, True, 0), (17, 33, True, 5)])
def test_live_pairs_match_the_program(Sq, Skv, causal, window):
    from repro_torch.kernels.flash_attention.kernel import live_pairs
    assert flops.live_pairs(Sq, Skv, causal, window) == \
        live_pairs(Sq, Skv, causal, window)
