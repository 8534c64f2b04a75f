"""The loop of the traffic kind "prefill": a prefill pool, closed loop.

Set-up draws the weights on the card from the seed and a pool of
``pool`` distinct batches of ``batch`` prompts of ``seq`` tokens, and
warms the program's prefill step (`training.train_state.
make_prefill_step`, with the last logits) up on that one shape.  The
window calls it back to back, one batch in flight, the next batch's
tokens already on the card; a batch is done when its B first tokens are
on the host.  After the window a sample of the window's batches, drawn
from the seed, is run again with every layer recorded and judged layer
by layer against the reference (`check.judge_prefill`).

The traffic file's keys: ``batch``, ``seq``, ``pool``, ``warmup_calls``,
``profile_steps``, ``check_batches``.  End-to-end metrics:
``prefill_tokens_per_s``, ``prefill_ms_p95``."""
from __future__ import annotations

import random
import statistics
import time
from typing import Dict

import torch

from portbench import check, weights
from portbench import harness as H
from portbench import tracing as tr
from portbench.reference.ops import exact_matmuls


def capture(step, params, batch, caches):
    """One call of ``step`` with each layer's residual input (the
    argument named ``x``) and output recorded (`models.model.apply_layer`
    wrapped from outside), and each MoE block's input and routing
    (`models.moe.moe_block`, `_route`)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    layers, moe_in, experts = [], [], []
    with tr.hooked(M, "apply_layer",
                   after=lambda a, out: layers.append((a["x"], out[0]))), \
            tr.hooked(moe_lib, "moe_block",
                      after=lambda a, out: moe_in.append(a["x"])), \
            tr.hooked(moe_lib, "_route",
                      after=lambda a, out: experts.append(out[1])):
        tok, caches, logits = step(params, batch, caches)
    return tok, caches, logits, layers, (moe_in, experts)


def layer_states(m: dict, caches: dict, moe) -> list:
    """Each layer's cache entries, in layer order, with an MoE layer's
    input and routing (``moe`` = the lists `capture` recorded)."""
    out, moe_at = [], 0
    for at in check.places(m):
        c = caches["decoder"][f"g{at.group}"][f"L{at.position}"]
        st = {k: v[at.repeat] for k, v in c.items()}
        if at.spec["mlp"] == "moe":
            st["moe_in"], st["experts"] = moe[0][moe_at], moe[1][moe_at]
            moe_at += 1
        out.append(st)
    return out


def setup(ctx: H.Context):
    """(step, params, pool, caches): the prefill step of the program,
    weights drawn on the device, ``pool`` distinct batches of prompts and
    one cache tree, the step warmed up on the cell's one shape."""
    from repro_torch.models import model as M
    from repro_torch.training.train_state import make_prefill_step
    t, dev, cfg = ctx.traffic, ctx.device, ctx.cfg
    B, S, P = t["batch"], t["seq"], t["pool"]
    params = weights.draw(ctx.seed, M.model_param_specs(cfg), cfg.act_dtype,
                          dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed + (1 << 40))
    pool = torch.randint(0, cfg.vocab_size, (P, B, S), generator=gen,
                         dtype=torch.int32, device=dev)
    step = make_prefill_step(cfg, return_logits=True)
    caches = M.init_caches(cfg, B, S, device=dev)
    for i in range(t["warmup_calls"]):
        step(params, {"tokens": pool[i % P]}, caches)
    H.sync(dev)
    return step, params, pool, caches


def picks(ctx: H.Context, batches) -> list:
    """The batches of the pool that the comparison checks, drawn from
    the seed out of ``batches`` (those the window served)."""
    batches = sorted(batches)
    return random.Random(ctx.seed).sample(
        batches, min(ctx.traffic["check_batches"], len(batches)))


def judge_program(ctx: H.Context, step, params, batch, caches):
    """The comparison's numbers for one batch of the timed path: the
    step run again on it with every layer's residual recorded, then
    judged against the reference.  Returns (numbers, served tokens)."""
    with torch.no_grad():
        tok, caches, logits, layers, moe = capture(
            step, params, {"tokens": batch}, caches)
    H.free_memory(ctx.device)
    with torch.no_grad(), exact_matmuls():
        got = check.judge_prefill(ctx.ref, ctx.m, params, batch, logits,
                                  layers, layer_states(ctx.m, caches, moe))
        gap = check.token_gap(ctx.ref, ctx.m, params, layers[-1][1][:, -1],
                              tok)
        ctx.note(f"served tokens' widest gap below the reference's best {gap}"
                 " (reported, not compared)")
    return got, tok.cpu()


def judge_control(ctx: H.Context, params, batch) -> dict:
    """The comparison's numbers of the control in the program's place."""
    with torch.no_grad(), exact_matmuls():
        logits, layers, states = check.control_prefill(
            ctx.ref, ctx.m, params, batch, ctx.cfg.act_dtype)
        return check.judge_prefill(ctx.ref, ctx.m, params, batch, logits,
                                   layers, states)


def worst(into: Dict[str, float], got: Dict[str, float]) -> None:
    for k, v in got.items():
        into[k] = max(into.get(k, 0.0), v)


def run(ctx: H.Context) -> Dict[str, float]:
    t = ctx.traffic
    B, S, P = t["batch"], t["seq"], t["pool"]
    step, params, pool, caches = setup(ctx)
    ctx.setup_done()

    lat, kept, n0 = [], [], H.model_launches()
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        tok, caches, logits = step(params, {"tokens": pool[len(lat) % P]},
                                   caches)
        tok = tok.cpu()                       # the first tokens on the host
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        kept.append((tok, logits))
        if t1 - start >= ctx.seconds:
            break
    elapsed = time.perf_counter() - start
    ctx.window_closed(H.model_launches(), n0, len(lat))
    n = len(lat)
    ctx.attempted = n * B
    ctx.e2e = {"prefill_tokens_per_s": n * B * S / elapsed,
               "prefill_ms_p95": H.quantile(lat, 0.95) * 1e3}
    ctx.note(f"window {elapsed:.3f} s, {n} batches of {B} x {S} tokens; "
             f"batch ms median {statistics.median(lat) * 1e3:.3f}, p95 "
             f"{ctx.e2e['prefill_ms_p95']:.3f} over {n} samples, max "
             f"{max(lat) * 1e3:.3f} (batch {lat.index(max(lat))}), sum "
             f"{sum(lat):.3f} s; every batch's ms "
             f"{[round(x * 1e3, 1) for x in lat]}")
    ctx.step_s = elapsed / n
    # every row: the served token is the first of the logits served with it
    ctx.failed = sum(int((tok != lg.float().argmax(-1).int().cpu()).sum())
                     + int(B * (~torch.isfinite(lg)).any().item())
                     for tok, lg in kept)
    served = {}
    for i, (tok, _) in enumerate(kept):
        served.setdefault(i % P, []).append(tok)
    del kept

    if ctx.trace:
        with ctx.spans():
            ctx.profile(lambda i: step(params, {"tokens": pool[i % P]},
                                       caches))

    # ---- the comparison: a sample of the window's batches, from the seed
    numbers: Dict[str, float] = {"rerun_mismatch": 0.0}
    for j in picks(ctx, served):
        got, tok = judge_program(ctx, step, params, pool[j], caches)
        numbers["rerun_mismatch"] += sum(int((tok != s).sum())
                                         for s in served[j])
        worst(numbers, got)
    return numbers


def readings(ctx: H.Context, who: str) -> Dict[str, float]:
    """The comparison's numbers of the batches that a run of this seed
    checks (`picks` of the whole pool, which every window serves), of
    the program (``who`` "program") or of the control; no window."""
    step, params, pool, caches = setup(ctx)
    numbers: Dict[str, float] = {}
    for j in picks(ctx, range(ctx.traffic["pool"])):
        if who == "program":
            got, _ = judge_program(ctx, step, params, pool[j], caches)
        else:
            got = judge_control(ctx, params, pool[j])
        worst(numbers, got)
    return numbers


# ------------------------------------------------------------------ faults
def _wrapped_step(after):
    from repro_torch.training import train_state
    inner = train_state.make_prefill_step

    def make(cfg, *a, **kw):
        step = inner(cfg, *a, **kw)

        def faulty(params, batch, caches):
            return after(caches, lambda: step(params, batch, caches))
        return faulty
    return tr.patched(train_state, "make_prefill_step", make)


def state_unchanged():
    """Every call leaves the cache as it found it."""
    def after(caches, call):
        from repro_torch.parallel.sharding import tree_leaves_with_path
        saved = [(t, t.clone()) for _, t in tree_leaves_with_path(caches)
                 if torch.is_tensor(t)]
        out = call()
        for t, s in saved:
            t.copy_(s)
        return out
    return _wrapped_step(after)


def token_altered():
    """The served token is not the one its logits give."""
    def after(caches, call):
        tok, caches, logits = call()
        return (tok + 1) % logits.shape[-1], caches, logits
    return _wrapped_step(after)


def half_batch():
    """Every layer leaves the second half of the batch as it came in."""
    from repro_torch.models import model as M
    inner = M.apply_layer

    def apply_layer(cfg, ls, p, x, aux, **kw):
        y, a, c = inner(cfg, ls, p, x, aux, **kw)
        h = x.shape[0] // 2
        return torch.cat([y[:h], x[h:]]), a, c
    return tr.patched(M, "apply_layer", apply_layer)


# Faults planted underneath the timed path, which the comparison has to
# fail; a one-chip cell has no exchange between chips to leave out.
FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
