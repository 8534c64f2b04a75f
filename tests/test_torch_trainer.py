"""The port's `Trainer` on the CPU: the 8 tests of `tests/test_trainer.py`
on `repro_torch`, and a resume across the packages — the reference's
`Trainer` checkpoints step 5, the port's resumes from the same directory
to step 10 and ends where the reference's straight 10 steps end."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.cluster.elastic import plan_resize  # noqa: E402
from repro_torch.cluster.sdc import (SDCValidator,  # noqa: E402
                                     gradient_fingerprint)
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.parallel.sharding import tree_leaves_with_path  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402


def tiny_cfg(**kw):
    return reduced_config(get_config("granite-8b")).replace(
        vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
        d_ff=64, **kw)


def trainer(cfg, opt, **tc):
    return Trainer(cfg, opt, TrainerConfig(log_every=0, **tc), device="cpu")


def leaves(tree):
    return [v for _, v in tree_leaves_with_path(tree)]


def test_loss_decreases():
    tr = trainer(tiny_cfg(), AdamWConfig(lr=3e-3, warmup_steps=5), batch=8,
                 seq=32, steps=30, ckpt_every=1000)
    tr.init()
    hist = tr.run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)
    assert all(h["w_s"] > 0 for h in hist)


def test_checkpoint_restart_resumes_exactly(tmp_path):
    cfg = tiny_cfg()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    tr1 = trainer(cfg, opt, batch=4, seq=16, steps=10, ckpt_every=5,
                  ckpt_dir=str(tmp_path / "ckpt"))
    tr1.init(seed=7)
    tr1.run()
    state_10 = {k: v for k, v in tree_leaves_with_path(tr1.state)}
    tr2 = trainer(cfg, opt, batch=4, seq=16, steps=15, ckpt_every=5,
                  ckpt_dir=str(tmp_path / "ckpt"))
    tr2.init(seed=999)               # seed ignored on resume
    assert int(tr2.state["step"]) == 10
    for path, b in tree_leaves_with_path(tr2.state):
        assert b.dtype == state_10[path].dtype, path
        assert torch.equal(state_10[path], b), path
    # pipeline state resumed (no batch replay)
    assert tr2.pipeline.state.next_piece == tr1.pipeline.state.next_piece
    tr2.run()
    assert int(tr2.state["step"]) == 15


def test_deterministic_resume_equals_straight_run(tmp_path):
    """ckpt@5 -> resume -> 10 gives the same params as straight 10 steps."""
    cfg = tiny_cfg()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    straight = trainer(cfg, opt, batch=4, seq=16, steps=10, ckpt_every=1000)
    straight.init(seed=3)
    straight.run()
    d = str(tmp_path / "c2")
    a = trainer(cfg, opt, batch=4, seq=16, steps=5, ckpt_every=5,
                ckpt_dir=d)
    a.init(seed=3)
    a.run()
    b = trainer(cfg, opt, batch=4, seq=16, steps=10, ckpt_every=5,
                ckpt_dir=d)
    b.init(seed=3)
    b.run()
    for x, y in zip(leaves(straight.state["params"]),
                    leaves(b.state["params"])):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=1e-6)


def test_dead_member_triggers_redispatch_and_resize():
    tr = trainer(tiny_cfg(), AdamWConfig(), batch=4, seq=16, steps=3)
    tr.init()
    tr.run()
    plan = tr.on_member_dead("pod7", alive_pods=3)
    assert plan.new_pods == 2                 # largest pow2 <= 3
    assert plan.needs_restart and plan.reshard == "torrent"
    assert plan.mesh_shape == (2, 16, 16)


def test_sdc_flags_minority_replica():
    v = SDCValidator(m_min=3, m_max=3, every_steps=1)
    good = {"w": torch.ones((4, 4))}
    bad = {"w": torch.ones((4, 4)) * 1.001}  # bitflip-ish
    assert v.offer(1, "podA", good) is None
    assert v.offer(1, "podB", good) is None
    rep = v.offer(1, "podC", bad)
    assert rep is not None and rep.agree
    assert rep.flagged == ["podC"]


def test_gradient_fingerprint_sensitivity():
    g = {"a": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    f1 = gradient_fingerprint(g)
    g2 = {"a": g["a"].clone()}
    g2["a"][2, 3] += 1e-3
    assert f1 != gradient_fingerprint(g2)
    assert f1 == gradient_fingerprint({"a": g["a"].clone()})


def test_elastic_plan_shapes():
    p1 = plan_resize(1)
    assert p1.mesh_shape == (16, 16) and p1.mesh_axes == ("data", "model")
    p8 = plan_resize(8, old_pods=8)
    assert p8.mesh_shape == (8, 16, 16) and not p8.needs_restart
    p5 = plan_resize(5, old_pods=8)
    assert p5.new_pods == 4 and p5.needs_restart
    assert p5.batch_scale == pytest.approx(0.5)


def test_grad_compression_trains_and_keeps_error_state():
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training.train_state import (init_train_state,
                                                  make_train_step)
    cfg = tiny_cfg()
    state = init_train_state(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=gen, dtype=torch.int32)}
    batch["labels"] = batch["tokens"].clone()
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2),
                           compress=CompressionConfig(scheme="int8"))
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert "err" in state
    assert any(float(x.abs().max()) > 0 for x in leaves(state["err"]))
    assert losses[-1] < losses[0], losses


def test_port_resumes_a_reference_checkpoint(tmp_path):
    """The reference's Trainer saves step 5 (and its pipeline state); the
    port's resumes from that directory to 10 and ends within 1e-5 (L2,
    relative, per leaf) of the reference's straight 10 steps, f32."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduced_config as jreduced
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.training.trainer import Trainer as JTrainer
    from repro.training.trainer import TrainerConfig as JTC
    kw = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
              head_dim=8, d_ff=64, dtype="float32")
    jcfg = jreduced(jget("granite-8b")).replace(**kw)
    cfg = reduced_config(get_config("granite-8b")).replace(**kw)
    d = str(tmp_path / "ckpt")
    straight = JTrainer(jcfg, JAdamW(lr=1e-3, warmup_steps=2),
                        JTC(batch=4, seq=16, steps=10, ckpt_every=1000,
                            log_every=0))
    straight.init(seed=3)
    straight.run()
    first = JTrainer(jcfg, JAdamW(lr=1e-3, warmup_steps=2),
                     JTC(batch=4, seq=16, steps=5, ckpt_every=5, ckpt_dir=d,
                         log_every=0))
    first.init(seed=3)
    first.run()
    port = trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2), batch=4,
                   seq=16, steps=10, ckpt_every=5, ckpt_dir=d)
    port.init(seed=0)
    assert int(port.state["step"]) == 5
    assert port.pipeline.state.next_piece == first.pipeline.state.next_piece
    port.run()
    assert int(port.state["step"]) == 10
    got = dict(tree_leaves_with_path(port.state["params"]))
    for path, a in tree_leaves_with_path(
            jax.device_get(straight.state["params"])):
        a = np.asarray(a, np.float64)
        err = np.linalg.norm(a - got[path].double().numpy())
        assert err <= 1e-5 * np.linalg.norm(a), (path, err)
