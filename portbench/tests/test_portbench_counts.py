"""The frozen counts of `portbench/counts` against the numbers the card
printed (`chip_smoke.py`'s kernel lines) and against the program's own
counting functions."""
import pytest

from portbench_small import run_as, small_run_as, one_thread  # noqa: F401
from portbench.counts import flops


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
    assert flops.param_count(m) == count_params(cfg)
    assert flops.param_count(m, active=True) == count_params(
        cfg, active_only=True)
    for kind in ("prefill", "train"):
        assert flops.model_flops(m, 4, 2048, kind) == pytest.approx(
            model_flops_of(cfg, 4, 2048, kind), rel=1e-12)


def test_model_sizes():
    assert flops.param_count(run_as("zamba2-7b")) == pytest.approx(
        6.60e9, rel=0.01)
    assert flops.param_count(run_as("qwen3-moe-30b-a3b")) == pytest.approx(
        30.5e9, rel=0.01)


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
