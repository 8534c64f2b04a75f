"""The port's checkpoint store and swarm restore on the CPU, and against the
reference package.

The 8 tests of `tests/test_checkpoint_swarm.py` and the 3 checkpoint tests
of `tests/test_infra.py`, on trees of tensors through `repro_torch`; then
the two packages against each other: a step saved by either restores
equal in the other, the same f32 / int32 tree gives byte-identical images
and `swarm.json` piece hashes, bf16 leaves cross both ways, and the
port's `ServingEngine.from_swarm` serves the reference engine's tokens.
`async_save` must snapshot: a CPU tensor updated in place while the
writer runs must not reach the checkpoint.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402

from repro_torch.checkpoint import store as store_mod  # noqa: E402
from repro_torch.checkpoint.store import (IMAGE_MAGIC,  # noqa: E402
                                          CheckpointStore, async_save,
                                          unpack_step_image)
from repro_torch.checkpoint.swarm_restore import (  # noqa: E402
    checkpoint_application, restore_from_agent, restore_image, verify_image)
from repro_torch.core import (Agent, AgentConfig, LinkModel,  # noqa: E402
                              PieceInventory, PieceManifest, SimRuntime,
                              TrackerConfig, TrackerServer)
from repro_torch.parallel.sharding import (ParamSpec,  # noqa: E402
                                           tree_leaves_with_path)


def _np_tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "wte": rng.standard_normal((64, 16)).astype(np.float32),
        "block": {"w1": rng.standard_normal((16, 32)).astype(np.float32),
                  "b1": np.zeros((32,), np.float32),
                  "scale": rng.standard_normal((16,)).astype(np.float16)},
        "step_count": np.asarray(7, np.int32),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _tree(seed: int = 0):
    return _as_torch(_np_tree(seed))


def _leaves(tree):
    return [v for _, v in tree_leaves_with_path(tree)]


def _trees_equal(a, b) -> bool:
    fa, fb = _leaves(a), _leaves(b)
    if len(fa) != len(fb):
        return False
    for x, y in zip(fa, fb):
        if not isinstance(x, torch.Tensor) or not isinstance(y, torch.Tensor):
            return False
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if not torch.equal(x, y):
            return False
    return True


# ------------------------- image codec ---------------------------------- #
def test_step_image_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path / "src"), swarm_piece_bytes=4096)
    tree = _tree()
    store.save(3, tree, extra={"lr": 0.1})
    image = store.pack_image(3)
    assert image.startswith(IMAGE_MAGIC)
    dest = str(tmp_path / "dst" / "step_00000003")
    files = unpack_step_image(image, dest)
    assert "manifest.json" in files
    restored, extra = CheckpointStore(str(tmp_path / "dst")).restore(
        tree, step=3)
    assert extra["lr"] == 0.1
    assert _trees_equal(tree, restored)


def test_unpack_rejects_malformed_images(tmp_path):
    store = CheckpointStore(str(tmp_path / "s"))
    store.save(0, _tree())
    image = store.pack_image(0)
    with pytest.raises(ValueError):
        unpack_step_image(b"NOTMAGIC" + image, str(tmp_path / "a"))
    with pytest.raises(ValueError):
        unpack_step_image(image[:-10], str(tmp_path / "b"))
    with pytest.raises(ValueError):
        unpack_step_image(image + b"junk", str(tmp_path / "c"))


def test_save_emits_swarm_manifest(tmp_path):
    store = CheckpointStore(str(tmp_path), swarm_piece_bytes=2048)
    store.save(5, _tree())
    assert os.path.exists(os.path.join(store.step_dir(5), "swarm.json"))
    pm = store.swarm_manifest(5)
    assert pm.content_hashed and pm.piece_bytes == 2048
    re = PieceManifest.from_bytes(pm.app_id, store.pack_image(5), 2048)
    assert re.manifest_hash == pm.manifest_hash
    assert verify_image(store.pack_image(5), pm)


def test_async_save_then_swarm_manifest(tmp_path):
    store = CheckpointStore(str(tmp_path), swarm_piece_bytes=4096)
    tree = _tree(seed=2)
    th = async_save(store, 9, tree)
    th.join(30)
    assert not th.is_alive()
    pm = store.swarm_manifest(9)
    params, _ = restore_image(store.pack_image(9), pm, tree,
                              workdir=str(tmp_path / "w"))
    assert _trees_equal(tree, params)


# ---------------------- corruption rejection ----------------------------- #
def test_corrupt_piece_rejected_by_inventory(tmp_path):
    store = CheckpointStore(str(tmp_path), swarm_piece_bytes=1024)
    store.save(0, _tree())
    image = store.pack_image(0)
    pm = store.swarm_manifest(0)
    inv = PieceInventory(pm)
    good = bytes(image[:pm.piece_size(0)])
    bad = bytes([good[0] ^ 0xFF]) + good[1:]
    assert not inv.add(0, data=bad)
    assert not inv.add(0, proof=pm.piece_hashes[0])
    assert inv.add(0, data=good)
    assert inv.has(0)


def test_restore_rejects_tampered_image(tmp_path):
    store = CheckpointStore(str(tmp_path), swarm_piece_bytes=1024)
    tree = _tree()
    store.save(0, tree)
    image = bytearray(store.pack_image(0))
    pm = store.swarm_manifest(0)
    image[len(image) // 2] ^= 0x01
    assert not verify_image(bytes(image), pm)
    with pytest.raises(ValueError, match="content verification"):
        restore_image(bytes(image), pm, tree, workdir=str(tmp_path / "w"))


# ------------------- fidelity through a real swarm ----------------------- #
def _swarm_fetch(app, n_replicas=2):
    """Origin hosts the committed step; replicas leech it. Returns the
    ready replica agents."""
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6, downlink_Bps=12.5e6))
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=1.0)))
    cfg = dict(work_timeout_s=60.0, status_interval_s=0.5,
               piece_timeout_s=3.0, replicate_completed=True)
    origin = Agent("origin", config=AgentConfig(**cfg))
    rt.add_node(origin)
    origin.host_app(app)
    replicas = [Agent(f"R{i}", config=AgentConfig(**cfg))
                for i in range(n_replicas)]
    for a in replicas:
        rt.add_node(a)
    rt.run(until=600,
           stop_when=lambda: all(app.app_id in a.images for a in replicas))
    assert all(app.app_id in a.images for a in replicas)
    return replicas


def test_swarm_restore_identical_to_origin_restore(tmp_path):
    store = CheckpointStore(str(tmp_path / "origin_store"),
                            swarm_piece_bytes=8192)
    tree = _tree(seed=3)
    store.save(12, tree, extra={"tokens_seen": 1 << 20})
    app = checkpoint_application(store, host_id="origin")
    replicas = _swarm_fetch(app)
    origin_params, origin_extra = store.restore(tree, step=12)
    for i, rep in enumerate(replicas):
        params, extra = restore_from_agent(
            rep, app.app_id, tree, workdir=str(tmp_path / f"rep{i}"))
        assert extra == origin_extra
        assert _trees_equal(origin_params, params)
    fresh = Agent("late", config=AgentConfig())
    with pytest.raises(RuntimeError, match="ready gate"):
        restore_from_agent(fresh, app.app_id, tree)


def serving_cfgs():
    """The model of the reference's `test_serving_engine_from_swarm`, in
    both packages."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduced_config as jreduced
    from repro_torch.configs.base import get_config, reduced_config
    kw = dict(dtype="float32", vocab_size=128, d_model=32, num_heads=4,
              num_kv_heads=2, head_dim=8, d_ff=64)
    return (jreduced(jget("granite-8b")).replace(**kw),
            reduced_config(get_config("granite-8b")).replace(**kw))


def test_serving_engine_from_swarm(tmp_path):
    """A checkpoint saved by the reference, fetched through the port's
    swarm, cold-starts the port's engine on the CPU: its params equal the
    saved ones and it serves the reference engine's tokens."""
    from repro.models import model as JM
    from repro.parallel.sharding import init_params as jinit
    from repro.serving.engine import ServeConfig as JServeConfig
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    jcfg, cfg = serving_cfgs()
    jparams = jinit(jax.random.PRNGKey(0), JM.model_param_specs(jcfg))
    jstore = JStore(str(tmp_path / "store"), swarm_piece_bytes=16 << 10)
    jstore.save(1, jparams, extra={"step": 1})
    store = CheckpointStore(str(tmp_path / "store"),
                            swarm_piece_bytes=16 << 10)
    app = checkpoint_application(store, host_id="origin")
    (replica,) = _swarm_fetch(app, n_replicas=1)
    eng = ServingEngine.from_swarm(
        cfg, M.model_param_specs(cfg), ServeConfig(slots=2, max_len=64),
        agent=replica, app_id=app.app_id, workdir=str(tmp_path / "restore"),
        device="cpu")
    assert eng.restore_extra == {"step": 1}
    got = dict(tree_leaves_with_path(eng.params))
    for path, a in tree_leaves_with_path(jax.device_get(jparams)):
        assert got[path].device.type == "cpu"
        assert np.array_equal(np.asarray(a), got[path].numpy()), path
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=rng.randint(2, 9)).astype(np.int32)
               for _ in range(4)]
    jeng = JServingEngine(jcfg, jparams, JServeConfig(slots=2, max_len=64))
    outs = []
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, max_new=4)
        reqs = list(e.queue)
        while e.queue or e.active:
            e.step()
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    # a mesh whose non-pod axes have several ranks builds the sharded
    # engine (tests/test_torch_mesh_serve.py, on gloo ranks); the torrent
    # fan-out over the pod axis is tests/test_torch_weight_torrent.py's
    from types import SimpleNamespace
    # no mesh, or no pod axis: restore_distributed is restore
    want, _ = store.restore(M.model_param_specs(cfg), device="cpu")
    for mesh in (None, SimpleNamespace(mesh_dim_names=("data",), shape=(1,))):
        got, extra = store.restore_distributed(M.model_param_specs(cfg), mesh,
                                               device="cpu")
        assert extra == {"step": 1} and _trees_equal(got, want)


# ------------------------------ store ------------------------------------ #
def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), piece_bytes=1024)
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((100,), dtype=torch.int32),
                  "d": torch.tensor(3.5)}}
    store.save(3, tree, extra={"note": "hi"})
    assert len(store.swarm_manifest(3).piece_hashes) >= 1
    out, extra = store.restore(tree)
    assert extra["note"] == "hi"
    assert _trees_equal(tree, out)


def test_checkpoint_gc_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=2)
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        store.save(s, tree)
    assert store.steps() == [3, 4]
    assert store.latest_step() == 4


def test_checkpoint_async_and_uncommitted_ignored(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"x": torch.ones(8)}
    th = async_save(store, 7, tree)
    th.join(30)
    assert not th.is_alive()
    assert store.latest_step() == 7
    os.makedirs(tmp_path / "step_00000009")
    assert store.latest_step() == 7


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The writer is held until the CPU tensors were updated in place;
    the checkpoint still holds the values at the call."""
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(6, dtype=torch.float32), "step":
            torch.tensor(3, dtype=torch.int32)}
    before = {k: v.clone() for k, v in tree.items()}
    go = threading.Event()
    save = store.save

    def held(*a, **kw):
        assert go.wait(30)
        return save(*a, **kw)
    monkeypatch.setattr(store, "save", held)
    th = async_save(store, 3, tree)
    tree["w"].mul_(-2.0).add_(1.0)       # an in-place optimizer step
    tree["step"].add_(1)
    go.set()
    th.join(30)
    assert not th.is_alive()
    out, _ = CheckpointStore(str(tmp_path)).restore(tree, step=3)
    assert _trees_equal(before, out)


def test_restore_onto_specs_and_checks_shapes(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _tree(1)
    store.save(2, tree)
    specs = {"wte": ParamSpec((64, 16), (None, None)),
             "block": {"w1": ParamSpec((16, 32), (None, None)),
                       "b1": ParamSpec((32,), (None,)),
                       "scale": ParamSpec((16,), (None,), torch.float32)},
             "step_count": ParamSpec((), (), torch.int32)}
    out, _ = store.restore(specs, device="cpu")
    assert out["block"]["scale"].dtype == torch.float32
    assert torch.equal(out["block"]["scale"], tree["block"]["scale"].float())
    assert torch.equal(out["wte"], tree["wte"])
    if not torch.cuda.is_available():       # specs land on "cuda" by default
        with pytest.raises(RuntimeError, match="cuda"):
            store.restore(specs)
    bad = dict(specs, wte=ParamSpec((16, 64), (None, None)))
    with pytest.raises(ValueError, match="shape"):
        store.restore(bad, device="cpu")


# ------------------------- across the packages -------------------------- #
def test_reference_step_restores_in_port_and_back(tmp_path):
    np_tree = _np_tree(4)
    JStore(str(tmp_path / "j")).save(
        5, jax.tree_util.tree_map(jnp.asarray, np_tree), extra={"k": 1})
    out, extra = CheckpointStore(str(tmp_path / "j")).restore(_tree(4))
    assert extra == {"k": 1}
    assert _trees_equal(_tree(4), out)
    CheckpointStore(str(tmp_path / "t")).save(6, _tree(5), extra={"k": 2})
    jout, jextra = JStore(str(tmp_path / "t")).restore(_np_tree(5))
    assert jextra == {"k": 2}
    for (p, a), (_, b) in zip(tree_leaves_with_path(_np_tree(5)),
                              tree_leaves_with_path(jout)):
        assert a.dtype == b.dtype and np.array_equal(a, b), p


def test_same_tree_gives_byte_identical_images(tmp_path):
    """f32 / int32 / f16 leaves: the same bytes, piece for piece, and the
    same swarm metainfo (the app id names the store's directory, so both
    stores sit in a directory of one name)."""
    np_tree = _np_tree(6)
    for piece_bytes in (1024, 64 << 20):
        j = JStore(str(tmp_path / f"j{piece_bytes}" / "ckpt"),
                   piece_bytes=piece_bytes, swarm_piece_bytes=2048)
        t = CheckpointStore(str(tmp_path / f"t{piece_bytes}" / "ckpt"),
                            piece_bytes=piece_bytes, swarm_piece_bytes=2048)
        for s in (1, 2):          # a revision chain: version 2 binds to 1
            j.save(s, jax.tree_util.tree_map(jnp.asarray, np_tree),
                   extra={"pipeline": {"next_piece": s}})
            t.save(s, _as_torch(np_tree),
                   extra={"pipeline": {"next_piece": s}})
            assert t.pack_image(s) == j.pack_image(s)
            jm, tm = j.swarm_manifest(s), t.swarm_manifest(s)
            assert tm.piece_hashes == jm.piece_hashes
            assert tm.manifest_hash == jm.manifest_hash
            assert tm.version == jm.version == s
            for fn in os.listdir(j.step_dir(s)):
                if fn != "COMMITTED":
                    with open(os.path.join(j.step_dir(s), fn), "rb") as a, \
                            open(os.path.join(t.step_dir(s), fn), "rb") as b:
                        assert a.read() == b.read(), fn


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 is written as the reference writes it (16-bit words, manifest
    dtype "bfloat16").  The reference cannot cast those words back itself
    (its restore into a bf16 template raises "No cast function
    available"), so on its side the words are taken raw, through a ``V2``
    template, and compared bit for bit."""
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((5, 3)).astype(np.float32)
    words = f32.astype(ml_dtypes.bfloat16).view(np.uint16)
    bf = torch.from_numpy(f32).to(torch.bfloat16)
    assert np.array_equal(bf.view(torch.int16).numpy().view(np.uint16), words)
    # reference -> port
    JStore(str(tmp_path / "j")).save(
        1, {"w": jnp.asarray(f32, jnp.bfloat16)})
    out, _ = CheckpointStore(str(tmp_path / "j")).restore(
        {"w": torch.zeros((5, 3), dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], bf)
    with pytest.raises(ValueError, match="cast"):
        JStore(str(tmp_path / "j")).restore(
            {"w": jnp.zeros((5, 3), jnp.bfloat16)})
    # port -> reference
    CheckpointStore(str(tmp_path / "t")).save(1, {"w": bf})
    jout, _ = JStore(str(tmp_path / "t")).restore(
        {"w": np.zeros((5, 3), np.dtype("V2"))})
    assert np.array_equal(np.asarray(jout["w"]).view(np.uint16), words)
    assert np.array_equal(
        np.asarray(jout["w"]).view(ml_dtypes.bfloat16).astype(np.float32),
        bf.float().numpy())
    assert store_mod.BF16 == "bfloat16"
