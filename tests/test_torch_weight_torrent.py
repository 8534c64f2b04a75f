"""The torrent ring across ranks: `repro_torch.parallel.weight_torrent`,
`parallel.pipeline`, `CheckpointStore.restore_distributed` and the pod
fan-out of `ServingEngine.from_swarm`, on gloo ranks of this CPU.

Each case spawns 3-4 ranks (`run_ranks`: one gloo process group through
a file in the test's tmp_path, a `DeviceMesh` over it) and joins them
under its own time limit: on a timeout or a rank's error every rank is
killed and the test fails, so a deadlocked ring cannot hang the suite.

Held against the reference: `torrent_broadcast_pieces` at the reference
mesh check's input (n=4 pods, P=8, L=32 from RandomState(0), seeder 2)
and `pipeline_apply` at its shapes (L=4 stages, M=6, B=2, D=16) against
the reference's own functions on a 4-pod host mesh, run in a subprocess
with 8 forced host devices as `tests/test_parallel.py` runs its checks.
The ring carries raw bytes, so a mixed-dtype tree round-trips exactly,
where the reference's f32 route turns an int32 of 2^24 + 1 into 2^24.
"""
import datetime
import hashlib
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


# ----------------------------- rank harness ------------------------------- #
def _rank_main(fn, rank, world, init_file, mesh_shape, names, args, results):
    """A spawned rank: join the gloo group, build the mesh, run
    ``fn(rank, mesh, *args)`` and report its result or traceback."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
        results.put((rank, "ok", fn(rank, mesh, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, tmp_path, *args, mesh_shape=(4,), names=("pod",),
              limit=150.0):
    """Run ``fn(rank, mesh, *args)`` on one spawned process per rank and
    return the results in rank order.  Fails, after killing every rank,
    when a rank raises, dies or the ranks outlast ``limit`` seconds."""
    world = int(np.prod(mesh_shape))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = tmp_path / f"pg_{fn.__name__}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(init_file), mesh_shape,
                               names, args, results))
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
                    errors.append(f"timed out after {limit} s; ranks "
                                  f"{sorted(set(range(world)) - set(got))} "
                                  f"never finished")
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
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [got[r] for r in range(world)]


def _hung_case(rank, mesh):
    """A deadlocked ring: every rank waits for its successor, which sends
    nothing."""
    import torch.distributed as dist
    dist.recv(torch.empty(1), src=(rank + 1) % dist.get_world_size())
    return rank


def test_a_hung_ring_is_killed_and_fails(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="timed out"):
        run_ranks(_hung_case, tmp_path, mesh_shape=(3,), limit=8.0)
    assert time.monotonic() - t0 < 40


# ------------------------------ reference --------------------------------- #
N_PODS, N_PIECES, PIECE_LEN, SEEDER = 4, 8, 32, 2
STAGES, MICRO, B, D = 4, 6, 2, 16


def _inputs():
    views = np.random.RandomState(0).randn(
        N_PODS, N_PIECES, PIECE_LEN).astype(np.float32)
    rng = np.random.RandomState(1)
    ws = (rng.randn(STAGES, D, D) * 0.3).astype(np.float32)
    xs = rng.randn(MICRO, B, D).astype(np.float32)
    return views, ws, xs


_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.weight_torrent import torrent_broadcast_pieces
data = np.load(sys.argv[1])
mesh = jax.make_mesh((4, 2), ("pod", "data"))
arr = jax.device_put(jnp.asarray(data["views"]),
                     NamedSharding(mesh, P("pod", None, None)))
pieces = np.asarray(torrent_broadcast_pieces(arr, mesh, axis="pod",
                                             seeder=int(data["seeder"])))
def stage(w, x):
    return jnp.tanh(x @ w)
with mesh:
    pipe = np.asarray(jax.jit(lambda w, x: pipeline_apply(
        stage, w, x, mesh, axis="pod"))(jnp.asarray(data["ws"]),
                                        jnp.asarray(data["xs"])))
np.savez(sys.argv[2], pieces=pieces, pipe=pipe)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ring and pipeline outputs on a (4 pod, 2 data)
    host mesh, for `_inputs()`."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("reference")
    views, ws, xs = _inputs()
    np.savez(d / "in.npz", views=views, ws=ws, xs=xs, seeder=SEEDER)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          str(d / "in.npz"), str(d / "out.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


# ------------------------------- the ring --------------------------------- #
def _pieces_case(rank, mesh, views, seeder):
    from repro_torch.parallel import weight_torrent as wt
    # a buffer off the group's device is refused before any message
    try:
        wt.torrent_broadcast_pieces(torch.empty(2, 2, device="meta"), mesh)
        raise AssertionError("a meta buffer crossed a gloo group")
    except ValueError as e:
        assert "gloo" in str(e)
    # ranks that disagree on the pieces' shape all raise
    bad = torch.zeros((3 if rank == 1 else 2, 4))
    try:
        wt.torrent_broadcast_pieces(bad, mesh)
        raise AssertionError("ranks with other shapes were not refused")
    except ValueError as e:
        assert "disagree" in str(e)
    local = torch.from_numpy(views[rank].copy())
    wt.reset_stats()
    out = wt.torrent_broadcast_pieces(local, mesh, "pod", seeder)
    return out.numpy(), dict(wt.STATS), out is local


def test_pieces_match_reference_bit_for_bit(tmp_path, reference):
    views, _, _ = _inputs()
    outs = run_ranks(_pieces_case, tmp_path, views, SEEDER)
    piece_bytes = PIECE_LEN * 4
    for rank, (got, stats, same) in enumerate(outs):
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32),
                              reference["pieces"][rank].view(np.uint32))
        assert np.array_equal(got, views[SEEDER])
        d = (rank - SEEDER) % N_PODS
        assert same == (d == 0)
        # the seeder uploads each piece once, each rank but the last of
        # the ring forwards each piece once, the last uploads nothing
        assert stats.get("sent_bytes", 0) == (
            0 if d == N_PODS - 1 else N_PIECES * piece_bytes), rank
        assert stats.get("received_bytes", 0) == (0 if d == 0
                                           else N_PIECES * piece_bytes)
        assert stats["ring_steps"] == N_PIECES + N_PODS - 2


def _group_ring_case(rank, mesh, views):
    """A (2 data, 2 pod) mesh: the pod groups are {0, 1} and {2, 3}, and
    group rank 1 seeds; a mesh without the axis returns the tree."""
    from repro_torch.parallel import weight_torrent as wt
    tree = {"w": torch.from_numpy(views[rank].copy())}
    assert wt.torrent_broadcast(tree, mesh, axis="nope") is tree
    out = wt.torrent_broadcast_pieces(tree["w"], mesh, "pod", seeder=1)
    return out.numpy()


def test_ring_follows_the_axis_group_ranks(tmp_path):
    views, _, _ = _inputs()
    outs = run_ranks(_group_ring_case, tmp_path, views, mesh_shape=(2, 2),
                     names=("data", "pod"))
    for rank, got in enumerate(outs):
        seeder_global = 2 * (rank // 2) + 1
        assert np.array_equal(got, views[seeder_global]), rank


def _mixed_tree(fill: bool):
    g = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn((5, 7), generator=g),
            "b": {"c": torch.randn((3,), generator=g).to(torch.bfloat16),
                  "d": torch.tensor([2 ** 24 + 1, -3, 7], dtype=torch.int32),
                  "e": torch.tensor(2 ** 40 + 1, dtype=torch.int64)},
            "f": torch.tensor([True, False, True]),
            "g": torch.randn((2, 1), generator=g).to(torch.float16)}
    if not fill:
        tree = {k: ({kk: torch.zeros_like(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else torch.zeros_like(v))
                for k, v in tree.items()}
    return tree


def _tree_case(rank, mesh, n_pieces):
    from repro_torch.parallel import weight_torrent as wt
    from repro_torch.parallel.sharding import tree_leaves_with_path
    tree = _mixed_tree(fill=rank == 0)
    out = wt.torrent_broadcast(tree, mesh, "pod", seeder=0,
                               n_pieces=n_pieces)
    return {p: (str(t.dtype), tuple(t.shape), t.view(-1).clone()
                .view(torch.uint8).numpy().tobytes())
            for p, t in tree_leaves_with_path(out)}


def test_tree_roundtrips_every_dtype_exactly(tmp_path):
    """f32, bf16, int32 above 2^24, int64 above 2^40, bool and f16 leaves
    (87 bytes: 5 pieces pad it) reach every rank bit for bit."""
    from repro_torch.parallel.sharding import tree_leaves_with_path
    want = {p: (str(t.dtype), tuple(t.shape),
                t.view(-1).clone().view(torch.uint8).numpy().tobytes())
            for p, t in tree_leaves_with_path(_mixed_tree(fill=True))}
    outs = run_ranks(_tree_case, tmp_path, 5, mesh_shape=(3,))
    for rank, got in enumerate(outs):
        assert got == want, rank


def test_reference_f32_route_loses_large_integers():
    """What the port does not copy: the reference flattens every leaf
    through f32, so an int32 of 2^24 + 1 comes back as 2^24."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.parallel import weight_torrent as ref
    tree = {"d": jnp.asarray([2 ** 24 + 1, -3, 7], jnp.int32),
            "w": jnp.asarray([0.5, -1.25], jnp.float32)}
    back = ref._unflatten(*ref._flatten_to_pieces(tree, 4))
    assert np.asarray(back["d"]).tolist() == [2 ** 24, -3, 7]
    assert np.array_equal(np.asarray(back["w"]), np.asarray(tree["w"]))


def test_cost_models_match_reference():
    pytest.importorskip("jax")
    from repro.parallel import pipeline as ref_pipe
    from repro.parallel import weight_torrent as ref
    from repro_torch.parallel import pipeline as port_pipe
    from repro_torch.parallel import weight_torrent as port
    for args in ((3.3e9, 4), (1e6, 2, 1e9), (7e10, 16)):
        assert port.broadcast_cost_model(*args) \
            == ref.broadcast_cost_model(*args)
    for args in ((2.048e9, 50), (2.56e8, 8, 25e6, 32)):
        assert port.cold_start_cost_model(*args) \
            == ref.cold_start_cost_model(*args)
    for L, M in ((4, 6), (1, 3), (8, 32)):
        assert port_pipe.pipeline_bubble_fraction(L, M) \
            == ref_pipe.pipeline_bubble_fraction(L, M)


# ------------------------------ the pipeline ------------------------------ #
def _stage(w, x):
    return torch.tanh(x @ w)


def _pipeline_case(rank, mesh, ws, xs):
    from repro_torch.parallel.pipeline import pipeline_apply
    return pipeline_apply(_stage, torch.from_numpy(ws), torch.from_numpy(xs),
                          mesh, axis="pod").numpy()


def test_pipeline_matches_reference(tmp_path, reference):
    _, ws, xs = _inputs()
    outs = run_ranks(_pipeline_case, tmp_path, ws, xs)
    seq = []
    for m in range(MICRO):
        h = torch.from_numpy(xs[m])
        for s in range(STAGES):
            h = _stage(torch.from_numpy(ws[s]), h)
        seq.append(h)
    seq = torch.stack(seq).numpy()
    for got in outs:
        assert got.shape == (MICRO, B, D)
        assert np.array_equal(got, outs[0])       # replicated
        assert np.abs(got - reference["pipe"]).max() < 1e-5
        assert np.abs(got - seq).max() < 1e-5


# -------------------- restore_distributed and from_swarm ------------------ #
def _zamba2_cfg():
    from repro_torch.configs.base import get_config, reduced_config
    return reduced_config(get_config("zamba2-7b")).replace(dtype="float32")


def _digests(tree):
    from repro_torch.parallel.sharding import tree_leaves_with_path
    return {p: (str(t.dtype), tuple(t.shape), t.device.type,
                hashlib.sha256(t.detach().cpu().contiguous().view(-1)
                               .view(torch.uint8).numpy()).hexdigest())
            for p, t in tree_leaves_with_path(tree)}


def _seeder_only_store(root, rank):
    """A store whose reads raise on every rank but the seeder."""
    from repro_torch.checkpoint.store import CheckpointStore

    class SeederOnly(CheckpointStore):
        def restore(self, *a, **kw):
            assert rank == 0, f"rank {rank} read the store"
            return super().restore(*a, **kw)

        def steps(self):
            assert rank == 0, f"rank {rank} listed the store"
            return super().steps()

    return SeederOnly(root)


PROMPT = np.array([5, 17, 3, 250, 9], np.int32)


def _serve(cfg, params):
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(slots=1, max_len=16),
                        device="cpu")
    return _greedy(eng)


def _greedy(eng):
    eng.submit(PROMPT, max_new=4)
    (req,) = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
    return req.out_tokens


def _restore_case(rank, mesh, root):
    """Rank 0 fetches the checkpoint Application from the origin through
    the scalar protocol; every rank cold-starts an engine with
    `from_swarm(mesh=...)`, then restores straight from the store with
    `restore_distributed` (reads raise off the seeder)."""
    from repro_torch.checkpoint.swarm_restore import checkpoint_application
    from repro_torch.core import (Agent, AgentConfig, SimRuntime,
                                  TrackerConfig, TrackerServer)
    from repro_torch.models import model as M
    from repro_torch.parallel import weight_torrent as wt
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = _zamba2_cfg()
    specs = M.model_param_specs(cfg)
    store = _seeder_only_store(root, rank)
    agent = app_id = None
    if rank == 0:
        app = checkpoint_application(store, host_id="origin")
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
    wt.reset_stats()
    eng = ServingEngine.from_swarm(
        cfg, specs, ServeConfig(slots=1, max_len=16), agent=agent,
        app_id=app_id, workdir=os.path.join(root, f"unpack{rank}"),
        mesh=mesh, device="cpu")
    ring = dict(wt.STATS)
    tokens = _greedy(eng)
    tree, extra = store.restore_distributed(specs, mesh, device="cpu")
    return (_digests(eng.params), eng.restore_extra, tokens, ring,
            _digests(tree), extra)


def test_restore_distributed_and_from_swarm_give_every_rank_the_leaves(
        tmp_path):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import (init_params_numpy,
                                               tree_leaves_with_path)
    cfg = _zamba2_cfg()
    specs = M.model_param_specs(cfg)
    root = str(tmp_path / "store")
    store = CheckpointStore(root, swarm_piece_bytes=64 << 10)
    store.save(3, init_params_numpy(7, specs), extra={"step": 3})
    want_tree, _ = store.restore(specs, device="cpu")
    want = _digests(want_tree)
    want_tokens = _serve(cfg, want_tree)
    outs = run_ranks(_restore_case, tmp_path, root)
    # 1.7 MB of f32 leaves: one ring piece (RING_PIECE_BYTES), no padding
    image_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves_with_path(want_tree))
    for rank, (swarm, extra, tokens, ring, direct, extra2) in \
            enumerate(outs):
        assert swarm == want and direct == want, rank
        assert extra == extra2 == {"step": 3}
        assert tokens == want_tokens, rank
        # the swarm fan-out's ring: the seeder uploads the image once
        sent = ring.get("sent_bytes", 0)
        assert sent == (0 if rank == N_PODS - 1 else image_bytes), rank
        assert ring.get("received_bytes", 0) == (0 if rank == 0
                                                 else image_bytes)
