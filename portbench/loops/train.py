"""The loop of the traffic kind "train": a training work unit, closed loop.

Set-up builds the program's train step (`training.train_state.
make_train_step`, with the traffic's ``remat`` and ``optimizer``) and its
state (float32 masters drawn on the card from the seed, zero moments),
and drives that same state through its first ``check_steps`` steps by
the window's own call, on distinct batches of the pool.  The window
goes on from there, one optimizer step a batch, the next batch already
on the card; a step is done when its loss is on the host.  After the
window the reference follows the first steps from the same weights and
batches (`check.reference_steps`), and the program's readings of those
steps are judged against it (`check.judge_train`), with its first
forward layer by layer.

The traffic file's keys: ``batch``, ``seq``, ``pool``, ``remat``,
``optimizer``, ``check_steps``, ``profile_steps``.  End-to-end metric:
``train_tokens_per_s``."""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import torch

from portbench import check, weights
from portbench import harness as H
from portbench import tracing as tr
from portbench.reference.ops import exact_matmuls


def batches(ctx: H.Context) -> list:
    """The pool of distinct batches of a training cell, drawn on the
    device from the seed: token rows and their next tokens as labels."""
    t, dev = ctx.traffic, ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed + (1 << 40))
    seqs = torch.randint(0, ctx.cfg.vocab_size,
                         (t["pool"], t["batch"], t["seq"] + 1),
                         generator=gen, dtype=torch.int32, device=dev)
    return [{"tokens": s[:, :-1].contiguous(), "labels": s[:, 1:].contiguous()}
            for s in seqs]


def masters(ctx: H.Context) -> dict:
    """The float32 masters that the seed draws on the device."""
    from repro_torch.models import model as M
    return weights.draw(ctx.seed, M.model_param_specs(ctx.cfg),
                        torch.float32, ctx.device)


@contextlib.contextmanager
def forward_capture(m: dict):
    """Within the block, the first forward's residual input (the argument
    named ``x``) and output of every layer, and each MoE layer's input
    and routing, recorded from outside the program (a recompute's calls
    come later and are left out): yields ``(layers, states)`` as
    `check.judge_layers` takes them, filled when the block ends."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    specs = [at.spec for at in check.places(m)]
    n_moe = sum(ls["mlp"] == "moe" for ls in specs)
    layers, moe_in, experts, states = [], [], [], []

    def keep(seq, limit, item):
        if len(seq) < limit:
            seq.append(item)
    with tr.hooked(M, "apply_layer", after=lambda a, o: keep(
            layers, len(specs), (a["x"].detach(), o[0].detach()))), \
            tr.hooked(moe_lib, "moe_block", after=lambda a, o: keep(
                moe_in, n_moe, a["x"].detach())), \
            tr.hooked(moe_lib, "_route", after=lambda a, o: keep(
                experts, n_moe, o[1])):
        yield layers, states
    at = 0
    for ls in specs:
        states.append({})
        if ls["mlp"] == "moe":
            states[-1] = {"moe_in": moe_in[at], "experts": experts[at]}
            at += 1


def setup(ctx: H.Context):
    """(step, state, batches, readings): the program's train step with
    its state, driven through its first ``check_steps`` steps on
    distinct batches of the pool by the same call the window makes;
    ``readings`` holds what the comparison reads of those steps: each
    loss, each leaf's first gradient as the optimizer received it (from
    the first moment after step 1), each leaf's change over the steps
    (its norm, and its elements' signs on the host, for its direction)
    and the first forward layer by layer."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_state import make_train_step
    t, dev = ctx.traffic, ctx.device
    P = t["pool"]
    params = masters(ctx)

    def zeros():
        return check.unflat({p: torch.zeros_like(v)
                             for p, v in check.flat(params).items()})
    state = {"params": params, "opt": {"m": zeros(), "v": zeros()},
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    pool = batches(ctx)
    step = make_train_step(ctx.cfg, AdamWConfig(**t["optimizer"]))
    readings = {"losses": []}
    for i in range(t["check_steps"]):
        if i == 0:      # the first step's forward, layer by layer
            with forward_capture(ctx.m) as readings["forward"]:
                state, met = step(state, pool[0])
        else:
            state, met = step(state, pool[i % P])
        readings["losses"].append(float(met["loss"]))
        if i == 0:
            readings["grads"] = {
                p: float(v.double().norm()) / (1 - t["optimizer"]["b1"])
                for p, v in check.flat(state["opt"]["m"]).items()}
    start = check.flat(masters(ctx))
    readings["change"], readings["signs"] = {}, {}
    for p, v in check.flat(state["params"]).items():
        d = v - start.pop(p)
        readings["change"][p] = float(d.double().norm())
        readings["signs"][p] = check.pack_signs(d)
        del d
    H.free_memory(dev)
    return step, state, pool, readings


def compute_weights(params: dict, cfg) -> dict:
    """The float32 masters as a step computes with them: every matrix
    rounded to the compute dtype, as the configuration states (bfloat16
    compute on float32 masters); worked out here from the benchmark's own
    weights.  The router's float64 product then sees the same weights on
    both sides, so that a routing decision is compared exactly."""
    return {k: compute_weights(v, cfg) if isinstance(v, dict) else
            (v.to(cfg.act_dtype).float() if v.ndim >= 2 else v)
            for k, v in params.items()}


def judge_program(ctx: H.Context, readings: dict) -> dict:
    """The reference follows the first steps from the same weights and
    batches; the program's readings are judged against it, and its first
    forward layer by layer."""
    t = ctx.traffic
    first = batches(ctx)[:t["check_steps"]]
    with torch.no_grad(), exact_matmuls():
        layers = check.judge_layers(ctx.ref, ctx.m,
                                    compute_weights(masters(ctx), ctx.cfg),
                                    first[0]["tokens"],
                                    *readings.pop("forward"), caches=False)
    H.free_memory(ctx.device)
    with exact_matmuls():
        ref = check.reference_steps(ctx.ref, ctx.m, t["optimizer"],
                                    lambda: masters(ctx), first,
                                    against=readings.pop("signs"))
    for key in ("grads", "change"):
        ctx.note(f"widest {key} gaps {check.leaf_gaps(readings, ref, key)[:4]}")
    ctx.note(f"most moved the wrong way {check.most_wrong_way(ref)[:4]}")
    return {**check.judge_train(readings, ref), **layers}


def judge_control(ctx: H.Context) -> dict:
    """The control in the program's place: the reference in float8
    products, judged against the float32 reference."""
    t = ctx.traffic
    first = batches(ctx)[:t["check_steps"]]
    params = compute_weights(masters(ctx), ctx.cfg)
    tokens = first[0]["tokens"]
    with torch.no_grad(), exact_matmuls():
        layers, states, _ = check.control_forward(
            ctx.ref, ctx.m, params, tokens, ctx.cfg.act_dtype)
        layers = check.judge_layers(ctx.ref, ctx.m, params, tokens, layers,
                                    states, caches=False)
    del params, states
    with exact_matmuls():
        got = check.reference_steps(ctx.ref, ctx.m, t["optimizer"],
                                    lambda: masters(ctx), first, "fp8",
                                    keep_signs=True)
        H.free_memory(ctx.device)
        ref = check.reference_steps(ctx.ref, ctx.m, t["optimizer"],
                                    lambda: masters(ctx), first,
                                    against=got.pop("signs"))
    for key in ("grads", "change"):
        ctx.note(f"control: widest {key} gaps "
                 f"{check.leaf_gaps(got, ref, key)[:4]}")
    ctx.note(f"control: most moved the wrong way "
             f"{check.most_wrong_way(ref)[:4]}")
    return {**check.judge_train(got, ref), **layers}


def run(ctx: H.Context) -> Dict[str, float]:
    t = ctx.traffic
    B, S, P = t["batch"], t["seq"], t["pool"]
    step, state, pool, readings = setup(ctx)
    ctx.setup_done()

    losses, n0 = [], H.model_launches()
    i = t["check_steps"]
    start = time.perf_counter()
    while True:
        state, met = step(state, pool[i % P])
        losses.append(met["loss"].item())      # the step's loss on the host
        i += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    elapsed = time.perf_counter() - start
    n = len(losses)
    ctx.window_closed(H.model_launches(), n0, n)
    ctx.attempted = n
    ctx.failed = sum(not math.isfinite(x) for x in losses)
    ctx.e2e = {"train_tokens_per_s": n * B * S / elapsed}
    ctx.step_s = elapsed / n
    ctx.note(f"window {elapsed:.3f} s, {n} steps of {B} x {S} tokens, "
             f"{ctx.e2e['train_tokens_per_s']:.1f} tokens/s; losses "
             f"{losses[0]:.5f} .. {losses[-1]:.5f}")
    if ctx.trace:
        holder = {"state": state}

        def call(j):
            holder["state"], _ = step(holder["state"], pool[j % P])
        with ctx.spans():
            ctx.profile(call)
        del holder
    del state, step
    H.free_memory(ctx.device)
    return judge_program(ctx, readings)


def readings(ctx: H.Context, who: str) -> Dict[str, float]:
    """The comparison's numbers of a run's first steps, of the program
    (``who`` "program") or of the control; no window."""
    if who == "control":
        return judge_control(ctx)
    step, state, pool, got = setup(ctx)
    del step, state, pool
    H.free_memory(ctx.device)
    return judge_program(ctx, got)


# ------------------------------------------------------------------ faults
def state_unchanged():
    """The optimizer returns the state it was given."""
    from repro_torch.training import train_state

    def adamw_update(cfg, params, grads, opt, step, **kw):
        return params, opt, {"grad_norm": torch.zeros(()),
                             "lr": torch.zeros(())}
    return tr.patched(train_state, "adamw_update", adamw_update)


def sign_flipped():
    """The optimizer moves every parameter the wrong way: its learning
    rate negated, so that each update is added where it should be
    subtracted."""
    from repro_torch.optim import adamw
    inner = adamw.lr_schedule
    return tr.patched(adamw, "lr_schedule",
                      lambda cfg, step: -inner(cfg, step))


def half_batch():
    """The loss is the mean over the first half of the batch alone."""
    from repro_torch.models import model as M
    inner = M.loss_fn

    def loss_fn(cfg, params, batch):
        h = batch["tokens"].shape[0] // 2
        return inner(cfg, params, {k: v[:h] for k, v in batch.items()})
    return tr.patched(M, "loss_fn", loss_fn)


def loss_altered():
    """The loss a step reports is one part in a hundred off the loss it
    took."""
    from repro_torch.training import train_state
    inner = train_state.make_train_step

    def make(cfg, opt, *a, **kw):
        step = inner(cfg, opt, *a, **kw)

        def faulty(state, batch):
            state, met = step(state, batch)
            return state, dict(met, loss=met["loss"] * 1.01)
        return faulty
    return tr.patched(train_state, "make_train_step", make)


# Faults planted underneath the timed path, which the comparison has to
# fail; a one-chip cell has no exchange between chips to leave out.
FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "loss_altered": loss_altered, "sign_flipped": sign_flipped}
