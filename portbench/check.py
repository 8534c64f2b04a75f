"""What decides ``correct``: the outputs of the timed path held to the
plain reference, each number against its limit
(`portbench/limits/<cell>.json`).

The reference is the configuration's own model of its architecture, the
module ``reference/<name>.py`` that its file names (``ref`` below,
`harness.reference_module`; the contract is in `reference/ops.py`).  No
function here knows an architecture: each takes the module and walks the
layers of the configuration's ``run_as`` (`places`).

A served prefill is judged layer by layer from the program's own state
(and an MoE layer's routing from the tokens the program routed, so that a
near-tie of the router decided by rounding is not counted as a fault of
the experts):
the random deep stacks amplify any rounding, so that the whole model in
bfloat16 cannot be told from a wrong one at its last logits, while each
layer can.  For every layer the reference takes the program's input to
it, and its own embedding of the batch's tokens as the stack's input,
and computes, in float32, what the layer should add to the residual and
the states it should leave in the cache; the program's output and cache
are measured against that.  The start (the embedding) and the end (the
head's logits and the served token) are judged by themselves.

The control stands in for the program: the same reference in float8
e4m3 products, its residual kept in bfloat16 between layers as the
program keeps it (`control_prefill`).  Judged by the same code it has to
fail."""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch


class Place(NamedTuple):
    """Where a layer sits in the stack: its running index, its group,
    the group's repeat and the layer's position in the group, and its
    layer dict."""
    index: int
    group: int
    repeat: int
    position: int
    spec: dict


def places(m: dict) -> Iterator[Place]:
    """The `Place` of every layer of ``m["groups"]``, in order."""
    i = 0
    for gi, g in enumerate(m["groups"]):
        for r in range(g["repeat"]):
            for pi, ls in enumerate(g["layers"]):
                yield Place(i, gi, r, pi, ls)
                i += 1


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| over the whole tensor, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


STATE_NUMBER = {"ssm": "state_err", "conv_x": "conv_err",
                "conv_b": "conv_err", "conv_c": "conv_err", "k": "kv_err",
                "v": "kv_err", "shared_k": "kv_err", "shared_v": "kv_err"}


def judge_layers(ref, m: dict, params: dict, tokens: torch.Tensor,
                 layers: list, states: list, caches: bool = True) -> dict:
    """The worst layer's numbers.  ``layers[i]`` is (input, output) of
    layer i's residual as the program ran it, ``states[i]`` the cache
    entries that layer left (with ``caches``) and an MoE layer's input
    and routing; ``tokens`` the batch, whose embedding by ``ref`` is the
    stack's input each layer is handed.

    layer_err: rel. L2 error of what the layer added to the residual;
    route_err: the share of an MoE layer's (token, choice) assignments
    whose expert differs from the reference's routing of the tokens the
    program routed (``states[i]["moe_in"]``; exact: the router's product
    is float64 on both sides); state_err / conv_err / kv_err: rel. L2
    error of the SSM states, the convolutions' states and K / V."""
    worst: dict = {}
    x0 = ref.embed(params, tokens)
    for at in places(m):
        x_in, x_out = layers[at.index]
        want, want_states = ref.layer(at, params, x_in, x0, m, "f32",
                                      moe_in=states[at.index].get("moe_in"))
        x_in = x_in.float()
        errs = {"layer_err": rel_l2(x_out.float() - x_in, want - x_in)}
        if "experts" in want_states:
            errs["route_err"] = float(
                (states[at.index]["experts"] != want_states["experts"])
                .double().mean())
        for name, w in want_states.items():
            if name in STATE_NUMBER and caches:
                key = STATE_NUMBER[name]
                errs[key] = max(errs.get(key, 0.0),
                                rel_l2(states[at.index][name], w))
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want, want_states
    return worst


def judge_prefill(ref, m: dict, params: dict, tokens: torch.Tensor,
                  logits: torch.Tensor, layers: list, states: list) -> dict:
    """The numbers of one prefill batch: `judge_layers`' with the cache,
    and embed_err, max |program's first residual - embedding row|
    (exact), and logits_err, the rel. L2 error of the last logits
    ``logits`` (B, V), from the program's last residual."""
    out = {"embed_err": float((layers[0][0].float() - ref.embed(
        params, tokens)).abs().max())}
    out.update(judge_layers(ref, m, params, tokens, layers, states))
    want = ref.logits(params, layers[-1][1][:, -1].float(), m, "f32")
    out["logits_err"] = rel_l2(logits.float(), want)
    return out


def token_gap(ref, m: dict, params: dict, last: torch.Tensor,
              served: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit, from the
    program's last residual ``last`` (B, d), lies below the reference's
    best.  Reported, not compared: on sound runs it reads a near-tie's
    rounding and the control reads no more (see PERF.md)."""
    want = ref.logits(params, last.float(), m, "f32")
    best = want.max(dim=-1).values
    return float((best - want.gather(1, served.long()[:, None])[:, 0]).max())


@torch.no_grad()
def control_forward(ref, m: dict, params: dict, tokens: torch.Tensor,
                    act_dtype=torch.bfloat16):
    """The reference in the program's place, its products in float8 and
    its residual kept in ``act_dtype`` (its embedding, the stack's input,
    too): (layers, states) as `judge_layers` takes them, and the last
    residual."""
    x0 = ref.embed(params, tokens).to(act_dtype)
    x = x0
    layers, states = [], []
    for at in places(m):
        y, st = ref.layer(at, params, x, x0, m, "fp8", act_dtype=act_dtype)
        y = y.to(act_dtype)
        layers.append((x, y))
        states.append(st)
        x = y
    return layers, states, x


@torch.no_grad()
def control_prefill(ref, m: dict, params: dict, tokens: torch.Tensor,
                    act_dtype=torch.bfloat16):
    """`control_forward` with the head's logits, also in float8:
    (logits, layers, states) as `judge_prefill` takes them."""
    layers, states, x = control_forward(ref, m, params, tokens, act_dtype)
    return ref.logits(params, x[:, -1].float(), m, "fp8"), layers, states


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a limit of None marks a number
    that is reported and not compared (it has no upper reading: see
    PERF.md).  A number with no entry, or an entry with no number,
    fails."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= v for k, v in limits.items() if v is not None)


# ------------------------------------------------------------------ training
def flat(tree: dict, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}.{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def unflat(leaves: dict) -> dict:
    out: dict = {}
    for path, v in leaves.items():
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def leaf_norms(leaves: dict) -> dict:
    return {p: float(t.double().norm()) for p, t in leaves.items()}


def reference_steps(ref, m: dict, opt: dict, draw, batches: list,
                    prec: str = "f32", against: dict | None = None,
                    keep_signs: bool = False) -> dict:
    """The first ``len(batches)`` AdamW steps of the reference (``ref``'s
    loss, `reference.train.adamw`) from the float32 tree that ``draw()``
    gives (drawn again at the end to measure the change, rather than
    held as a copy): each step's loss, each
    leaf's gradient norm at step 1 as the optimizer receives it (after
    clipping), and each leaf's change over the steps: its norm
    ("change"), with ``keep_signs`` the signs of its elements packed on
    the host ("signs", `pack_signs`), and with ``against`` (another
    side's "signs") the share of the leaf's first gradient, by magnitude,
    on elements that the two sides moved in different directions
    ("wrong_way", `wrong_way_share`)."""
    from portbench.reference import train
    leaves = flat(draw())
    state = {"m": {p: torch.zeros_like(t) for p, t in leaves.items()},
             "v": {p: torch.zeros_like(t) for p, t in leaves.items()}}
    losses, grads_at_1, weight = [], None, {}
    for i, batch in enumerate(batches):
        for t in leaves.values():
            t.requires_grad_(True)
        loss = ref.loss(m, unflat(leaves), batch["tokens"], batch["labels"],
                        prec)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {p: torch.zeros_like(t) if g is None else g.detach()
                 for (p, t), g in zip(leaves.items(), grads)}
        for t in leaves.values():
            t.requires_grad_(False)
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            train.adamw(leaves, grads, state, i, opt)
            if i == 0:
                grads_at_1 = {p: float(v.double().norm()) / (1 - opt["b1"])
                              for p, v in state["m"].items()}
                if against is not None:     # |first gradient|, as weights
                    weight = {p: v.abs().bfloat16()
                              for p, v in state["m"].items()}
        del grads
    del state
    start = flat(draw())
    out = {"losses": losses, "grads": grads_at_1, "change": {}}
    if against is not None:
        out["wrong_way"] = {}
    if keep_signs:
        out["signs"] = {}
    with torch.no_grad():
        for p, t in leaves.items():
            d = t - start[p]
            del start[p]
            out["change"][p] = float(d.double().norm())
            if against is not None:
                out["wrong_way"][p] = wrong_way_share(against[p], d,
                                                      weight.pop(p))
            if keep_signs:
                out["signs"][p] = pack_signs(d)
            del d
    return out


BITS = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)


def pack_signs(d: torch.Tensor) -> torch.Tensor:
    """Whether each element of ``d`` is above zero, eight to a byte, on
    the host."""
    up = (d.reshape(-1) > 0).to(torch.uint8)
    up = torch.nn.functional.pad(up, (0, -up.numel() % 8)).view(-1, 8)
    return (up * BITS.to(up.device)).sum(-1, dtype=torch.uint8).cpu()


def unpack_signs(packed: torch.Tensor, n: int, device) -> torch.Tensor:
    """The first ``n`` elements' `pack_signs` bits, as booleans."""
    bits = packed.to(device)[:, None] & BITS.to(device)
    return (bits != 0).reshape(-1)[:n]


def wrong_way_share(signs: torch.Tensor, d: torch.Tensor, w: torch.Tensor,
                    block: int = 1 << 24):
    """The share of ``w`` (|first gradient|) on the elements of the leaf
    that one side moved up and the other did not, summed a block at a
    time: ``signs`` are the other side's `pack_signs`, ``d`` this side's
    change."""
    d, w = d.reshape(-1), w.reshape(-1)
    wrong = total = 0.0
    for i in range(0, d.numel(), block):
        n = min(block, d.numel() - i)
        other = unpack_signs(signs[i // 8:(i + n + 7) // 8], n, d.device)
        diff = other != (d[i:i + n] > 0)
        wi = w[i:i + n].float()
        wrong += float(wi[diff].double().sum())
        total += float(wi.double().sum())
    return wrong / total if total > 0 else 0.0


def judge_train(prog: dict, ref: dict) -> dict:
    """The numbers of the first steps of a training run: loss_err, the
    worst step's |loss - reference| / reference; grad_err, the median
    leaf's gap between the program's and the reference's norm of its
    first gradient (as the optimizer received it), each over the larger
    of that leaf's reference norm and the median leaf's; update_err, the
    worst leaf's gap of its change over the steps, by the same measure;
    update_dir_err, the worst leaf's share of its first gradient, by
    magnitude, on elements that the program moved in another direction
    than the reference (``ref["wrong_way"]``): a change of the right size
    in the wrong direction, which a norm cannot see.  (Weighted, since
    AdamW's first steps move every element by about the learning rate:
    the elements whose gradient lies under bfloat16's rounding would
    count as much as any; see PERF.md.)  Leaves whose reference gradient
    is under a thousandth of the median leaf's move by Adam's round-off
    alone and are left out of all three, by that rule.  (The gradient's
    worst leaf reads as much on sound runs as in float8, a small leaf's
    noise and not a fault; see PERF.md.)"""
    import statistics
    out = {"loss_err": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"]))}
    out["grad_err"] = statistics.median(
        g for _, g in leaf_gaps(prog, ref, "grads"))
    out["update_err"] = leaf_gaps(prog, ref, "change")[0][1]
    out["update_dir_err"] = most_wrong_way(ref)[0][1]
    return out


def kept_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's."""
    import statistics
    med_g = statistics.median(ref["grads"].values())
    return [p for p, g in ref["grads"].items() if g >= 1e-3 * med_g]


def most_wrong_way(ref: dict) -> list:
    """(leaf, `wrong_way_share`) of the kept leaves, the largest first."""
    return sorted(((p, ref["wrong_way"][p]) for p in kept_leaves(ref)),
                  key=lambda pw: -pw[1])


def leaf_gaps(prog: dict, ref: dict, key: str) -> list:
    """(leaf, gap) of `judge_train`'s ``key`` ("grads" or "change"),
    the widest first."""
    import statistics
    kept = kept_leaves(ref)
    med = statistics.median(ref[key][p] for p in kept)
    return sorted(((p, abs(prog[key][p] - ref[key][p])
                    / max(ref[key][p], med)) for p in kept),
                  key=lambda pg: -pg[1])
