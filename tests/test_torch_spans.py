"""The port's own spans and MoE slot counter (`repro_torch.spans`, and
its ``RECORDS["moe.slots"]``) on the CPU, on a reduced qwen3-moe.

With no profiler recording, a prefill step and a train step enter no
profiler range and record nothing; under ``torch.profiler`` the spans nest
as the benchmark's readers expect (each span's parent the range around
it; the MoE block's range is the benchmark's, hooked from outside); and
the slot counter equals a recount from the router's experts and
`moe.capacity`, in a dropless batch and in one past 512 tokens whose
skewed router drops assignments.
"""
import collections

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.parallel.sharding import init_params  # noqa: E402
from repro_torch.training.train_state import (init_train_state,  # noqa: E402
                                              make_prefill_step,
                                              make_train_step)

B, S = 2, 16
MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def small_cfg():
    return reduced_config(get_config("qwen3-moe-30b-a3b")).replace(
        dtype="float32", remat="full")


def n_layers(cfg):
    return sum(g.repeat * len(g.layers) for g in cfg.groups)


@pytest.fixture(autouse=True)
def empty_totals():
    spans.clear()
    yield
    spans.clear()


def run_prefill(cfg):
    params = init_params(0, M.model_param_specs(cfg), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(cfg)
    step(params, {"tokens": tokens}, M.init_caches(cfg, B, S, device="cpu"))


def run_train(cfg):
    state = init_train_state(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    step = make_train_step(cfg, AdamWConfig())
    step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})


STEPS = {"prefill": run_prefill, "train": run_train}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_no_profiler_enters_no_range_and_records_nothing(kind, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler range was entered with no "
                             "profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.recording()
    STEPS[kind](small_cfg())
    assert not spans.COUNTS and not spans.SECONDS and not spans.RECORDS


def chain(evt):
    """The names of the CPU ranges around ``evt``, innermost first."""
    out = []
    evt = evt.cpu_parent
    while evt is not None:
        out.append(evt.name)
        evt = evt.cpu_parent
    return out


def traced(kind, monkeypatch):
    """The step's spans under a CPU profiler, with `moe.moe_block` in a
    range of that name opened from outside, as the benchmark's hook
    does (the program opens none there)."""
    cfg = small_cfg()
    inner = moe.moe_block

    def block(*args, **kw):
        with torch.profiler.record_function("moe_block"):
            return inner(*args, **kw)
    monkeypatch.setattr(moe, "moe_block", block)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        STEPS[kind](cfg)
    assert not spans.recording()
    names = set(spans.COUNTS) | {"moe_block"}
    return cfg, [e for e in prof.events() if e.name in names]


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_spans_nest_under_a_profiler(kind, monkeypatch):
    cfg, events = traced(kind, monkeypatch)
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e.name].append(e)
    blocks = by_name.pop("moe_block")
    n = n_layers(cfg)
    # every span counted once a call, its host time with it; the MoE
    # block is in one range, the hook's
    assert {k: len(v) for k, v in by_name.items()} == dict(spans.COUNTS)
    assert all(spans.SECONDS[k] > 0 for k in spans.COUNTS)
    assert "moe_block" not in spans.COUNTS
    top = "serve.prefill" if kind == "prefill" else "train.step"
    assert spans.COUNTS[top] == 1
    assert all(top in chain(e) for e in blocks)
    for part in MOE_PARTS:
        # the route's second span: the aux statistics, after the combine
        once = 2 if part == "moe.route" else 1
        assert spans.COUNTS[part] == once * len(blocks), part
        assert all(chain(e)[0] == "moe_block" for e in by_name[part]), part
    if kind == "prefill":
        assert spans.COUNTS["attention_block"] == n
        assert len(blocks) == n
        assert all(top in chain(e) for e in by_name["attention_block"])
    else:
        # the forward and remat "full"'s recompute each run every layer
        assert len(blocks) == 2 * n
        for name in ("remat_forward", "train.backward", "adamw_update"):
            assert by_name[name], name
            assert all(top in chain(e) for e in by_name[name]), name
        assert spans.COUNTS["remat_recompute"] == \
            spans.COUNTS["remat_forward"]
        # the forward's MoE blocks sit inside its checkpointed repeats
        fwd = [e for e in blocks if "remat_forward" in chain(e)]
        assert len(fwd) == n


class AtenOps(TorchDispatchMode):
    """The aten ops dispatched that are not views (what can launch a
    kernel on a card), by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten" and not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_the_spans_and_the_counter_launch_nothing(kind):
    """A step dispatches the same non-view aten ops with a profiler
    recording (spans and slot counter on) as without."""
    cfg = small_cfg()
    with AtenOps() as off:
        STEPS[kind](cfg)
    with profile(activities=[ProfilerActivity.CPU]), AtenOps() as on:
        STEPS[kind](cfg)
    assert spans.COUNTS["moe.experts"] and spans.RECORDS["moe.slots"]
    assert on.ops == off.ops


def skewed_router(cfg, gen):
    """A router that sends most tokens to expert 0: x carries a common
    direction that only expert 0's column reads."""
    d, E = cfg.d_model, cfg.num_experts
    w = 0.1 * torch.randn(d, E, generator=gen)
    w[:, 0] += 1.0
    return w


@pytest.mark.parametrize("case", ["dropless", "skewed_drops"])
def test_slot_counter_matches_a_recount(case, monkeypatch):
    cfg = small_cfg()
    gen = torch.Generator().manual_seed(5)
    params = init_params(3, moe.moe_specs(cfg), device="cpu")
    Bx, Sx = (2, 64) if case == "dropless" else (2, 320)
    x = torch.randn(Bx, Sx, cfg.d_model, generator=gen)
    if case == "skewed_drops":
        params["router"] = skewed_router(cfg, gen)
        x = x + 1.0
    routed = []
    inner = moe._route

    def route(*args):
        out = inner(*args)
        routed.append(out[1])
        return out
    monkeypatch.setattr(moe, "_route", route)
    with profile(activities=[ProfilerActivity.CPU]):
        moe.moe_block(params, x, cfg)
    (experts,) = routed
    N, k, E = Bx * Sx, cfg.experts_per_token, cfg.num_experts
    cap = moe.capacity(cfg, N)
    counts = torch.bincount(experts.reshape(-1), minlength=E)
    kept = int(torch.clamp(counts, max=cap).sum())
    ((got, got_cap),) = spans.RECORDS["moe.slots"]
    assert got_cap == cap and torch.equal(got, counts)
    keep, _ = moe._dispatch_plan(experts, cap, 0, E)
    assert int(keep.sum()) == kept
    dropped = N * k - kept
    if case == "dropless":
        assert N <= 512 and cap == N and dropped == 0
    else:
        assert N > 512 and dropped > 0 and kept < E * cap


def n_moe_layers(cfg):
    return sum(g.repeat * sum(ls.mlp == "moe" for ls in g.layers)
               for g in cfg.groups)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_moe_backward_counts_two_a_moe_layer_in_training(kind, monkeypatch):
    """A train step under a profiler enters ``moe.backward`` twice a MoE
    layer (the dispatch's and the combine's backward), each inside the
    autograd node of its read; a prefill step, which runs no backward,
    never (and without a profiler nothing counts: the test above)."""
    cfg, events = traced(kind, monkeypatch)
    n = n_moe_layers(cfg)
    assert n > 0
    got = [e for e in events if e.name == "moe.backward"]
    if kind == "prefill":
        assert spans.COUNTS["moe.backward"] == 0 and not got
        return
    assert spans.COUNTS["moe.backward"] == 2 * n == len(got)
    nodes = collections.Counter(
        next(a for a in chain(e) if "Backward" in a).rsplit(" ", 1)[-1]
        for e in got)
    assert nodes == {"_DispatchBackward": n, "_CombineBackward": n}
