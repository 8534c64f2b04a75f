"""Serving over a (data, model) mesh: the port's sharded layers, prefill,
decode and engine on gloo ranks of this CPU, held against the
reference's own sharded paths.

One module-scoped subprocess runs the reference (`repro`) under an
**Auto** mesh of 8 forced host devices (jax 0.9's `jax.make_mesh` makes
Explicit axes by default, under which `shard_act`'s
`with_sharding_constraint` raises; the reference is left as it is) and
writes its outputs to an npz file:

  * the vocab-sharded embedding lookup and the sequence-sharded
    flash-decode (the reference mesh checks' inputs, (2, 4) mesh);
  * reduced zamba2 (the hybrid: SSD and shared attention) prefill and
    decode on a (2, 2) mesh at B=1 (the cache's sequence over both axes)
    and a (1, 4) mesh at B=2;
  * reduced qwen3-moe on (2, 2): the ``a2a`` dispatch in prefill (1024
    tokens a row, past the 256-token dropless bound, capacity factor 1:
    drops) and ``replicated`` in decode, with every MoE call's routing on
    every shard (a debug callback on the reference's `_route` inside its
    shard_map);
  * the MoE block alone with the exact and the int8 all-to-all (the
    reference check's inputs, (2, 4));
  * reduced qwen3-14b with 6 query heads over ``model`` = 4 under
    ``tp_sp`` and ``pad_attn_heads`` ((2, 4)).

Spawned gloo ranks of the port run the same cases (weights from
`init_params_numpy`, shared by both), joined under a time limit, and are
held to f32 bounds: 1e-6 for the embedding, 1e-5 for decode attention,
1e-3 for the MoE block, 2e-3 of max|logit| for a whole model's logits
(the serve slice's bound); tokens, expert counts and drops equal; the
int8 all-to-all within rel 5e-2 of exact.  The same ranks hold the
collectives against whole tensors, `shard_params` / `gather_params`,
the sharded `ServingEngine` against the port's single-device engine,
and `ServingEngine.from_swarm` on a (2 pod, 2 model) mesh.
"""
import datetime
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TOL_EMBED, TOL_DECODE, TOL_MOE = 1e-6, 1e-5, 1e-3
# a whole model's f32 logits, of max|logit|: the serve slice's bound
# (tests/test_torch_models.py TOL); the reduced random models amplify
# rounding layer by layer (~1e-4 here)
TOL_MODEL = 2e-3


# ----------------------------- rank harness ------------------------------- #
def _rank_main(fn, rank, world, init_file, args, results):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        results.put((rank, "ok", fn(rank, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, limit=240.0):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks; their results
    in rank order.  Kills every rank and fails when one raises, dies, or
    they outlast ``limit`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = tmp_path / f"pg_{fn.__name__}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(init_file), args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    got, errors = {}, []
    try:
        while len(got) < world and not errors:
            try:
                rank, status, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    errors.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"timed out after {limit} s")
                continue
            if status == "error":
                errors.append(f"rank {rank}:\n{out}")
            got[rank] = out
        for p in procs if not errors else ():
            p.join(timeout=max(0.0, deadline - time.monotonic()) + 5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not errors, "\n".join(errors)
    return [got[r] for r in range(world)]


# ------------------------------- the cases -------------------------------- #
# name -> (arch, config overrides, mesh, batch, prompt length, decode steps)
MODELS = {
    "hybrid_2x2": ("zamba2-7b", {"attn_impl": "flash"}, (2, 2), 1, 40, 4),
    "hybrid_1x4": ("zamba2-7b", {}, (1, 4), 2, 40, 4),
    "moe_2x2": ("qwen3-moe-30b-a3b", {"capacity_factor": 1.0}, (2, 2), 2,
                1024, 4),
    "tp_sp_pad_2x4": ("qwen3-14b", {"num_heads": 6, "num_kv_heads": 2,
                                    "head_dim": 16, "tp_sp": True,
                                    "pad_attn_heads": True}, (2, 4), 2, 32,
                      4),
}
SEED = 5


def model_cfg(name, pkg="repro_torch"):
    arch, kw, *_ = MODELS[name]
    if pkg == "repro_torch":
        from repro_torch.configs.base import get_config, reduced_config
    else:
        from repro.configs.base import get_config, reduced_config
    return reduced_config(get_config(arch)).replace(dtype="float32", **kw)


def model_inputs(name):
    """(numpy weights, prompt (B, S) int32) of a case, from SEED."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    cfg = model_cfg(name)
    _, _, _, B, S, _ = MODELS[name]
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return init_params_numpy(SEED, M.model_param_specs(cfg)), prompt


def block_inputs():
    """The reference mesh checks' small inputs: the embedding (vocab 64,
    d 32) and its (4, 8) tokens, the flash-decode's q / caches / t, and
    the MoE block's (4, 16, 32) input."""
    rng = np.random.default_rng(SEED)
    f = np.float32
    return {"emb": rng.standard_normal((64, 32)).astype(f),
            "toks": rng.integers(0, 64, (4, 8)).astype(np.int32),
            "q": rng.standard_normal((4, 1, 8, 16)).astype(f),
            "kc": rng.standard_normal((4, 64, 4, 16)).astype(f),
            "vc": rng.standard_normal((4, 64, 4, 16)).astype(f),
            "t": np.array([10, 20, 30, 63], np.int32),
            "x": rng.standard_normal((4, 16, 32)).astype(f)}


def moe_block_cfg(pkg="repro_torch", int8=False):
    if pkg == "repro_torch":
        from repro_torch.configs.base import get_config, reduced_config
    else:
        from repro.configs.base import get_config, reduced_config
    return reduced_config(get_config("qwen3-moe-30b-a3b")).replace(
        dtype="float32", d_model=32, num_experts=8, experts_per_token=2,
        moe_d_ff=16, moe_a2a_int8=int8)


def moe_block_params():
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel.sharding import init_params_numpy
    return init_params_numpy(SEED, moe_lib.moe_specs(moe_block_cfg()))


def reference_capacity(cfg, N):
    """The reference's sharded capacity (`repro/models/moe.py:188-190`)."""
    cap = (N if N <= 256 else
           int(np.ceil(N * cfg.experts_per_token / cfg.num_experts
                       * cfg.capacity_factor)))
    return max(cap, 1)


def routing_summary(calls, n_experts):
    """Each recorded MoE call, (experts (N, k), capacity), as (tokens,
    capacity, per-expert counts, dropped assignments)."""
    out = []
    for e, cap in calls:
        counts = np.bincount(np.asarray(e).reshape(-1), minlength=n_experts)
        out.append((int(e.shape[0]), int(cap), counts.tolist(),
                    int(np.maximum(counts - cap, 0).sum())))
    return out


# ------------------------------ reference --------------------------------- #
_REFERENCE = r"""
import sys, threading
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, sys.argv[2])
import test_torch_mesh_serve as T
from repro.models import attention as JA, layers as JL, model as JM
from repro.models import moe as jmoe
from repro.parallel import sharding as JS
out = {}

def mesh_of(shape, names=("data", "model")):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

def tree(a):
    if isinstance(a, dict):
        return {k: tree(v) for k, v in a.items()}
    return jnp.asarray(a)

b = T.block_inputs()
m24 = mesh_of((2, 4))
cfg_e = T.moe_block_cfg("repro").replace(vocab_size=64)
with m24, JS.sharding_ctx(m24, JS.INFERENCE_RULES):
    out["embed"] = np.asarray(jax.jit(lambda e, t: JL.embed_tokens(
        {"embedding": e}, t, cfg_e))(b["emb"], b["toks"]))
    out["decode"] = np.asarray(jax.jit(lambda q, k, v, t: JA.decode_attention(
        q, k, v, t))(b["q"], b["kc"], b["vc"], b["t"]))
mp = T.moe_block_params()
for tag, int8 in (("exact", False), ("int8", True)):
    c = T.moe_block_cfg("repro", int8)
    rules = JS.infer_rules(c)
    with m24, JS.sharding_ctx(m24, rules):
        o, aux = jax.jit(lambda p, x: jmoe.moe_block(p, x, c))(tree(mp), b["x"])
    out[f"moe_{tag}_out"], out[f"moe_{tag}_aux"] = np.asarray(o), np.asarray(aux)

calls, lock = [], threading.Lock()
def record(d, m, e):
    with lock:
        calls.append((int(d), int(m), np.asarray(e)))
inner = jmoe._route
def route(xf, w, k):
    g, e, p = inner(xf, w, k)
    jax.debug.callback(record, jax.lax.axis_index("data"),
                       jax.lax.axis_index("model"), e)
    return g, e, p
jmoe._route = route

for name, (arch, kw, shape, B, S, nd) in T.MODELS.items():
    cfg = T.model_cfg(name, "repro")
    params, prompt = T.model_inputs(name)
    mesh = mesh_of(shape)
    rules = JS.infer_rules(cfg)
    shard = JS.specs_to_shardings(JM.model_param_specs(cfg), mesh, rules)
    params = jax.device_put(tree(params), shard)
    caches = JS.init_params(jax.random.PRNGKey(0),
                            JM.cache_specs_tree(cfg, B, S + nd))
    def run(fn):
        def f(p, bt, c):
            with JS.sharding_ctx(mesh, rules):
                return fn(cfg, p, bt, c)
        return jax.jit(f)
    pre, dec = run(JM.prefill), run(JM.decode_step)
    del calls[:]
    toks, logits = [], []
    with mesh:
        lg, caches = pre(params, {"tokens": jnp.asarray(prompt)}, caches)
        for i in range(nd + 1):
            lg = np.asarray(lg, np.float32)
            logits.append(lg)
            toks.append(lg.argmax(-1).astype(np.int32))
            if i == nd:
                break
            lg, caches = dec(params, {"tokens": jnp.asarray(toks[-1][:, None])},
                             caches)
    jax.effects_barrier()
    out[f"{name}_tokens"] = np.stack(toks)
    out[f"{name}_logits"] = np.stack(logits)
    routing = {}
    for d, m, e in calls:
        routing.setdefault(f"{d},{m}", []).append(e)
    if routing:
        import json
        c = T.model_cfg(name)
        out[f"{name}_routing"] = np.array(json.dumps(
            {k: T.routing_summary([(e, T.reference_capacity(c, e.shape[0]))
                                   for e in v], c.num_experts)
             for k, v in routing.items()}))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        str(ROOT / "tests")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


# ------------------------------- the port --------------------------------- #
def _mesh(shape, names=("data", "model")):
    if names == ("data", "model"):
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(*shape)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _serve(name, mesh):
    """A model case through the port's mesh steps: tokens (n+1, B),
    logits (n+1, B, V) and the routing of every MoE call on this rank."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import infer_rules
    from repro_torch.training.train_state import (make_decode_step,
                                                  make_prefill_step)
    _, _, _, B, S, nd = MODELS[name]
    cfg = model_cfg(name)
    full, prompt = model_inputs(name)
    rules = infer_rules(cfg)
    params = shard_params(full, M.model_param_specs(cfg), mesh, rules,
                          device="cpu")
    caches = M.init_caches(cfg, B, S + nd, mesh=mesh, rules=rules,
                           device="cpu")
    pre = make_prefill_step(cfg, mesh, rules, return_logits=True)
    dec = make_decode_step(cfg, mesh, rules, return_logits=True)
    calls, caps = [], []
    inner, inner_cap = moe_lib._route, moe_lib.local_capacity

    def route(xf, w, k):
        out = inner(xf, w, k)
        calls.append(out[1].numpy().copy())
        return out

    def capacity(c, n):
        caps.append(inner_cap(c, n))
        return caps[-1]
    moe_lib._route, moe_lib.local_capacity = route, capacity
    try:
        tok, caches, lg = pre(params, {"tokens": torch.as_tensor(prompt)},
                              caches)
        toks, logits = [tok.numpy()], [lg.numpy()]
        for _ in range(nd):
            tok, caches, lg = dec(params, {"tokens": tok[:, None]}, caches)
            toks.append(tok.numpy())
            logits.append(lg.numpy())
    finally:
        moe_lib._route, moe_lib.local_capacity = inner, inner_cap
    return (np.stack(toks), np.stack(logits),
            routing_summary(list(zip(calls, caps)), cfg.num_experts))


def _blocks(mesh):
    """The embedding, the flash-decode and the MoE block (exact and int8)
    on this rank of a (2, 4) mesh, under the inference rules."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S
    from repro_torch.training.train_state import local_batch
    b = {k: torch.as_tensor(v) for k, v in block_inputs().items()}
    rules = S.INFERENCE_RULES
    out = {}
    cfg_e = moe_block_cfg().replace(vocab_size=64)
    emb = S.local_shard(b["emb"], S.logical_to_mesh_axes(
        mesh, (64, 32), ("vocab", "embed"), rules), mesh)
    with S.sharding_ctx(mesh, rules, batch=4):
        x = L.embed_tokens({"embedding": emb},
                           local_batch({"t": b["toks"]}, 4, mesh,
                                       rules)["t"], cfg_e)
        out["embed"] = C.all_gather(x, "data", mesh).numpy()
        c_spec = S.act_spec((4, 64, 4, 16), "batch", "kv_seq", "kv_heads",
                            None)
        kc = S.local_shard(b["kc"], c_spec, mesh)
        vc = S.local_shard(b["vc"], c_spec, mesh)
        q = S.local_shard(b["q"], (c_spec[0], None, None, None), mesh)
        t = S.local_shard(b["t"], (c_spec[0],), mesh)
        o = A.decode_attention(q, kc, vc, t, seq_axes=S.entry_axes(
            c_spec[1]), Sc=64)
        out["decode"] = C.all_gather(o, "data", mesh).numpy()
        out["decode_layout"] = c_spec
    specs = moe_lib.moe_specs(moe_block_cfg())
    for tag, int8 in (("exact", False), ("int8", True)):
        cfg = moe_block_cfg(int8=int8)
        r = S.infer_rules(cfg)
        p = shard_params(moe_block_params(), specs, mesh, r, device="cpu")
        # the experts' FSDP blocks, gathered as a layer's are
        p = {k: C.relayout(v, S.param_sharding(mesh, specs[k], r),
                           S.logical_to_mesh_axes(mesh, specs[k].shape,
                                                  specs[k].logical, r), mesh)
             for k, v in p.items()}
        with S.sharding_ctx(mesh, r, batch=4):
            xl = local_batch({"x": b["x"]}, 4, mesh, r)["x"]
            o, aux = moe_lib.moe_block(p, xl, cfg)
            out[f"moe_{tag}_out"] = C.all_gather(o, "data", mesh).numpy()
            out[f"moe_{tag}_aux"] = float(aux)
    return out


RELAYOUTS = [
    # (src, dst) specs of an (8, 8, 4) tensor
    (("data", None, None), (None, "model", None)),
    ((None, "model", None), (None, None, "model")),     # one all-to-all
    ((("data", "model"), None, None), (None, ("model", "data"), None)),
    (("model", "data", None), (None, None, None)),
    ((None, None, None), (("data", "model"), None, None)),
]


def _collectives(mesh):
    """Each collective and relayout on this rank against the same
    operation on the whole tensor: a list of (case, equal)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S
    g = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    out = []
    for src, dst in RELAYOUTS:
        got = C.relayout(S.local_shard(g, src, mesh), src, dst, mesh)
        out.append((f"relayout {src} -> {dst}",
                    torch.equal(got, S.local_shard(g, dst, mesh))))
    i = C.axis_index(("model", "data"), mesh)
    x = torch.full((8, 2), float(i))
    got = C.all_to_all(x, ("model", "data"), mesh, split_axis=0,
                       concat_axis=1)
    want = torch.arange(8, dtype=torch.float32).repeat_interleave(2)
    out.append(("all_to_all over (model, data)",
                torch.equal(got, want.expand(1, 16))))
    d = C.axis_index("data", mesh)
    v = torch.tensor([float(i), -float(i)])     # i = model * 2 + data
    out.append(("psum", torch.equal(C.psum(v, ("data", "model"), mesh),
                                    torch.tensor([28.0, -28.0]))))
    out.append(("pmax", float(C.pmax(v, "model", mesh)[0]) == 6 + d))
    out.append(("pmean", float(C.pmean(v, ("model", "data"), mesh)[0])
                == 3.5))
    y = torch.arange(8.0)[None].expand(2, 8) * (i + 1)
    got = C.psum_scatter(y, "model", mesh, scatter_dimension=1)
    tot = sum(torch.arange(8.0) * (k * 2 + d + 1) for k in range(4))
    m = C.axis_index("model", mesh)
    out.append(("psum_scatter", torch.equal(got[0],
                                            tot[m * 2:(m + 1) * 2])))
    return out


def _case_2x4(rank):
    mesh = _mesh((2, 4))
    out = _blocks(mesh)
    out["collectives"] = _collectives(mesh)
    out["tp_sp_pad_2x4"] = _serve("tp_sp_pad_2x4", mesh)
    out["coords"] = mesh.get_coordinate()
    from repro_torch.launch.mesh import make_production_mesh
    prod = make_production_mesh()
    out["production"] = (prod.mesh_dim_names, tuple(prod.shape),
                         prod.device_type)
    return out


def _engine(cfg, params, mesh, prompts, max_new):
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(slots=2, max_len=32),
                        mesh=mesh, device="cpu")
    for p in prompts:
        eng.submit(p, max_new=max_new)
    reqs = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
    return [r.out_tokens for r in reqs]


ENGINE_PROMPTS = [np.array(p, np.int32) for p in
                  ([5, 17, 3, 250, 9], [7, 7, 100], [200, 1, 2, 3, 4, 5, 6],
                   [42])]


def _swarm_case(rank, mesh, root):
    """Ranks (0, m) fetch the checkpoint through the scalar protocol (one
    replica each); every rank cold-starts with `from_swarm` on the (pod,
    model) mesh, which builds the sharded engine."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.checkpoint.swarm_restore import checkpoint_application
    from repro_torch.core import (Agent, AgentConfig, SimRuntime,
                                  TrackerConfig, TrackerServer)
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = model_cfg("hybrid_1x4")
    specs = M.model_param_specs(cfg)
    agent = app_id = None
    if mesh.get_coordinate()[0] == 0:
        app = checkpoint_application(CheckpointStore(root),
                                     host_id="origin")
        app_id = app.app_id
        rt = SimRuntime()
        rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=1.0)))
        acfg = dict(work_timeout_s=60.0, status_interval_s=0.5,
                    replicate_completed=True)
        origin = Agent("origin", config=AgentConfig(**acfg))
        rt.add_node(origin)
        origin.host_app(app)
        agent = Agent("R0", config=AgentConfig(**acfg))
        rt.add_node(agent)
        rt.run(until=3600, stop_when=lambda: app_id in agent.images)
    eng = ServingEngine.from_swarm(
        cfg, specs, ServeConfig(slots=2, max_len=32), agent=agent,
        app_id=app_id, workdir=os.path.join(root, f"unpack{rank}"),
        mesh=mesh, device="cpu")
    for p in ENGINE_PROMPTS[:2]:
        eng.submit(p, max_new=4)
    reqs = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
    leaf = eng.params["decoder"]["g0"]["L0"]["ssd"]["wz"]
    return [r.out_tokens for r in reqs], eng.mesh is mesh, tuple(leaf.shape)


def _case_2x2(rank, root):
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    out = {}
    mesh = _mesh((2, 2))
    for name in ("hybrid_2x2", "moe_2x2"):
        out[name] = _serve(name, mesh)
    out["hybrid_1x4"] = _serve("hybrid_1x4", _mesh((1, 4)))
    cfg = model_cfg("hybrid_1x4")
    full = init_params_numpy(SEED, M.model_param_specs(cfg))
    out["engine"] = _engine(cfg, full, mesh, ENGINE_PROMPTS, 4)
    out["swarm"] = _swarm_case(rank, _mesh((2, 2), ("pod", "model")), root)
    out["coords"] = mesh.get_coordinate()
    out["round_trip"] = _round_trip(mesh)
    return out


def _round_trip(mesh):
    """`shard_params` then `gather_params` on the reduced zamba2 (TP) and
    qwen3-moe (TP + FSDP over data) give back every whole leaf, and each
    block has its `param_sharding` shape."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.parallel import sharding as S
    out = {}
    for name in ("hybrid_1x4", "moe_2x2"):
        cfg = model_cfg(name)
        specs = M.model_param_specs(cfg)
        rules = S.infer_rules(cfg)
        full, _ = model_inputs(name)
        blocks = shard_params(full, specs, mesh, rules, device="cpu")
        back = gather_params(blocks, specs, mesh, rules)
        flat = dict(S.tree_leaves_with_path(full))
        spec = dict(S.tree_leaves_with_path(specs))
        out[name] = (
            all(np.array_equal(t.numpy(), flat[p]) for p, t in
                S.tree_leaves_with_path(back)),
            all(tuple(t.shape) == S.local_shape(
                spec[p].shape, S.param_sharding(mesh, spec[p], rules), mesh)
                for p, t in S.tree_leaves_with_path(blocks)),
            sum(t.numel() for _, t in S.tree_leaves_with_path(blocks)),
            sum(a.size for a in flat.values()))
    return out


@pytest.fixture(scope="module")
def ranks_2x4(tmp_path_factory):
    return run_ranks(_case_2x4, 8, tmp_path_factory.mktemp("r24"))


@pytest.fixture(scope="module")
def ranks_2x2(tmp_path_factory):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    tmp = tmp_path_factory.mktemp("r22")
    root = str(tmp / "store")
    cfg = model_cfg("hybrid_1x4")
    CheckpointStore(root, swarm_piece_bytes=64 << 10).save(
        1, init_params_numpy(SEED, M.model_param_specs(cfg)))
    return run_ranks(_case_2x2, 4, tmp, root)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# -------------------------------- tests ----------------------------------- #
def test_collectives_and_relayouts_match_the_whole_tensor(ranks_2x4):
    for out in ranks_2x4:
        bad = [case for case, ok in out["collectives"] if not ok]
        assert not bad, bad
    assert len(ranks_2x4[0]["collectives"]) == len(RELAYOUTS) + 5


def test_production_mesh_puts_model_inside_a_node(ranks_2x4):
    # 8 ranks = one node of 8 cards: data 1, model 8; gloo: a CPU mesh
    assert ranks_2x4[0]["production"] == (("data", "model"), (1, 8), "cpu")


def test_embedding_matches_the_reference(reference, ranks_2x4):
    for out in ranks_2x4:
        assert _err(out["embed"], reference["embed"]) <= TOL_EMBED


def test_sequence_sharded_flash_decode_matches_the_reference(reference,
                                                             ranks_2x4):
    # the batch over data, the cache's sequence over model
    assert ranks_2x4[0]["decode_layout"] == ("data", "model", None, None)
    for out in ranks_2x4:
        assert _err(out["decode"], reference["decode"]) <= TOL_DECODE


def test_moe_block_matches_the_reference(reference, ranks_2x4):
    for out in ranks_2x4:
        assert _err(out["moe_exact_out"], reference["moe_exact_out"]) \
            <= TOL_MOE
        assert abs(out["moe_exact_aux"] - float(reference["moe_exact_aux"])) \
            <= TOL_MOE


def test_int8_all_to_all_stays_close_to_exact(reference, ranks_2x4):
    def f(o, aux):
        o = np.asarray(o, np.float64)
        return float(np.sum(o * np.cos(o)) + aux)
    want = f(reference["moe_exact_out"], float(reference["moe_exact_aux"]))
    for out in ranks_2x4:
        got = f(out["moe_int8_out"], out["moe_int8_aux"])
        assert abs(got - want) / max(abs(want), 1e-9) < 5e-2
        assert _err(out["moe_int8_out"], out["moe_exact_out"]) > 0


def check_model(reference, outs, name):
    want_t = reference[f"{name}_tokens"]
    want_l = reference[f"{name}_logits"]
    for out in outs:
        toks, logits, routing = out[name]
        np.testing.assert_array_equal(toks, want_t)
        for step in range(len(want_l)):
            scale = float(np.max(np.abs(want_l[step])))
            assert _err(logits[step], want_l[step]) <= TOL_MODEL * scale, \
                (name, step)
    return outs


@pytest.mark.parametrize("name", ["hybrid_2x2", "hybrid_1x4"])
def test_hybrid_prefill_and_decode_match_the_reference(reference, ranks_2x2,
                                                       name):
    check_model(reference, ranks_2x2, name)


def test_tp_sp_and_padded_heads_match_the_reference(reference, ranks_2x4):
    check_model(reference, ranks_2x4, "tp_sp_pad_2x4")


def test_moe_model_matches_the_reference_with_its_drops(reference,
                                                        ranks_2x2):
    check_model(reference, ranks_2x2, "moe_2x2")
    want = json.loads(str(reference["moe_2x2_routing"]))
    _, _, _, B, S, nd = MODELS["moe_2x2"]
    drops = 0
    for out in ranks_2x2:
        d, m = out["coords"]
        got = [list(c) for c in out["moe_2x2"][2]]
        assert got == [list(c) for c in want[f"{d},{m}"]], (d, m)
        # 2 layers of prefill (a2a: the sequence over model), then 2 a
        # decode step (replicated: one row of the batch)
        assert [c[0] for c in got] == [B * S // 4] * 2 + [1] * 2 * nd
        drops += sum(c[3] for c in got)
    assert drops > 0


def test_shard_and_gather_params_round_trip(ranks_2x2):
    for out in ranks_2x2:
        for name, (equal, shapes, n_local, n_full) in \
                out["round_trip"].items():
            assert equal and shapes, name
        # TP over model = 2 halves the attention / SSD weights; FSDP over
        # data = 2 halves the MoE model's again
        assert out["round_trip"]["moe_2x2"][2] * 3 < \
            out["round_trip"]["moe_2x2"][3]


def test_sharded_engine_matches_the_single_device_engine(ranks_2x2):
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import init_params_numpy
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = model_cfg("hybrid_1x4")
    params = params_from_reference(
        init_params_numpy(SEED, M.model_param_specs(cfg)), device="cpu")
    eng = ServingEngine(cfg, params, ServeConfig(slots=2, max_len=32),
                        device="cpu")
    for p in ENGINE_PROMPTS:
        eng.submit(p, max_new=4)
    reqs = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
    want = [r.out_tokens for r in reqs]
    for out in ranks_2x2:
        assert out["engine"] == want
    for out in ranks_2x2:
        tokens, on_mesh, shape = out["swarm"]
        assert tokens == want[:2] and on_mesh
        # wz's d_inner columns split over model
        assert shape[-1] == cfg.d_inner // 2


# ----- reference_serve_mesh.json (qwen3-moe-30b-a3b, full width, mesh) ---- #
MESH_FILE = ROOT / "src" / "repro_torch" / "reference_serve_mesh.json"
MESH_SEED, MESH_LAYERS, MESH_PROMPT, MESH_DECODE = 2024, 2, 1280, 4


def write_reference_serve_mesh(path=MESH_FILE, reduced=False,
                               prompt_len=MESH_PROMPT):
    """qwen3-moe-30b-a3b at full width, 2 layers, f32, through the
    reference's sharded prefill and decode on an Auto (2, 2) (data,
    model) mesh of forced host devices under `infer_rules` (TP over model,
    FSDP over data): two 1280-token prompts (one row a data shard; the
    a2a dispatch, 640 tokens a shard: capacity 50, drops), then 4 greedy
    decode steps (replicated dispatch), with every MoE call's routing on
    every shard (a debug callback on `_route` inside the shard_map)."""
    import threading
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs.base import GroupSpec, LayerSpec
    from repro.configs.base import get_config as jax_get_config
    from repro.models import model as JM
    from repro.models import moe as jmoe
    from repro.parallel import sharding as JS
    from repro_torch.configs.base import GroupSpec as TG, LayerSpec as TL
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import (init_params_numpy,
                                               tree_leaves_with_path)
    from repro.configs.base import reduced_config as jax_reduced
    from repro_torch.configs.base import reduced_config
    groups = [[[("attn", "moe", False)], MESH_LAYERS]]

    def gs(G, Lc):
        return tuple(G(tuple(Lc(*l) for l in ls), r) for ls, r in groups)
    jcfg = jax_get_config("qwen3-moe-30b-a3b")
    cfg = get_config("qwen3-moe-30b-a3b")
    if reduced:     # a small file of the same form, for rehearsals
        jcfg, cfg = jax_reduced(jcfg), reduced_config(cfg)
    jcfg = jcfg.replace(dtype="float32", use_pallas=False,
                        groups=gs(GroupSpec, LayerSpec))
    cfg = cfg.replace(dtype="float32", use_pallas=False, groups=gs(TG, TL))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = JS.infer_rules(jcfg)
    tree = init_params_numpy(MESH_SEED, M.model_param_specs(cfg))
    shard = dict(tree_leaves_with_path(JS.specs_to_shardings(
        JM.model_param_specs(jcfg), mesh, rules)))
    flat = {}
    for p, a in list(tree_leaves_with_path(tree)):
        flat[p] = jax.device_put(a, shard[p])
    del tree, a
    params = {}
    for p, v in flat.items():
        node = params
        *heads, last = p.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    rng = np.random.default_rng(MESH_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (2, prompt_len)).astype(
        np.int32)
    idx = np.sort(rng.choice(cfg.vocab_size, 64, replace=False))
    caches = JS.init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
        jcfg, 2, prompt_len + MESH_DECODE))
    calls, lock = [], threading.Lock()

    def record(d, m, e):
        with lock:
            calls.append((int(d), int(m), np.asarray(e)))
    inner = jmoe._route

    def route(xf, w, k):
        g, e, p = inner(xf, w, k)
        jax.debug.callback(record, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"), e)
        return g, e, p
    jmoe._route = route

    def run(fn):
        def f(p, bt, c):
            with JS.sharding_ctx(mesh, rules):
                return fn(jcfg, p, bt, c)
        return jax.jit(f)
    pre, dec = run(JM.prefill), run(JM.decode_step)
    steps = []
    try:
        with mesh:
            lg, caches = pre(params, {"tokens": jnp.asarray(prompts)},
                             caches)
            for i in range(MESH_DECODE + 1):
                lg = np.asarray(lg, np.float32)
                tok = lg.argmax(-1).astype(np.int32)
                steps.append({"tokens": tok.tolist(),
                              "max_abs": np.abs(lg).max(-1).tolist(),
                              "values": lg[:, idx].tolist()})
                print(f"step {i}: tokens {tok.tolist()}", flush=True)
                if i == MESH_DECODE:
                    break
                lg, caches = dec(params, {"tokens": jnp.asarray(
                    tok[:, None])}, caches)
        jax.effects_barrier()
    finally:
        jmoe._route = inner
    by_shard = {}
    for d, m, e in calls:
        by_shard.setdefault(f"{d},{m}", []).append(e)
    routing = {k: routing_summary([(e, reference_capacity(cfg, e.shape[0]))
                                   for e in v], cfg.num_experts)
               for k, v in sorted(by_shard.items())}
    print("drops by shard:", {k: [c[3] for c in v]
                              for k, v in routing.items()})
    out = {
        "about": "reference package (repro), CPU, f32, use_pallas=False, "
                 "on an Auto (2, 2) (data, model) mesh of 4 forced host "
                 "devices under infer_rules (TP over model, FSDP over "
                 "data), PYTHONHASHSEED=0: prefill of two prompts, then "
                 "greedy decode steps; routing: per shard 'data,model', "
                 "each MoE call in order (prefill layers, then each decode "
                 "step's) as [tokens, capacity, per-expert counts, "
                 "dropped]; written by tests/test_torch_mesh_serve.py "
                 "--write-reference-serve-mesh",
        "arch": "qwen3-moe-30b-a3b", "groups": groups, "dtype": "float32",
        "seed": MESH_SEED, "mesh": [2, 2], "prompts": prompts.tolist(),
        "decode_steps": MESH_DECODE, "logit_index": idx.tolist(),
        "tolerance": TOL_MODEL, "steps": steps, "routing": routing,
    }
    Path(path).write_text(json.dumps(out) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    if sys.argv[1] == "--write-reference-serve-mesh":
        if os.environ.get("PYTHONHASHSEED") != "0":
            os.execve(sys.executable, [sys.executable, *sys.argv],
                      dict(os.environ, PYTHONHASHSEED="0"))
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["JAX_PLATFORMS"] = "cpu"
        if sys.argv[2:]:        # PATH: the reduced model, for rehearsals
            write_reference_serve_mesh(sys.argv[2], reduced=True,
                                       prompt_len=600)
        else:
            write_reference_serve_mesh()
