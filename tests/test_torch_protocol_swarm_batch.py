"""Mixed-mode event-heap determinism of the batched driver (run vs
run_batched).

The two cases of the reference's `tests/test_swarm_batch.py` that no
other port test covers, run on `repro_torch.core` on the CPU.  Its
other cases have counterparts in the port's `test_torch_swarm_kernels`,
`test_torch_swarm_arrays`, `test_torch_swarm_v2`, `test_torch_chaos`
(`test_hub_retire_detaches_row_and_prunes_empty_state` among them) and
`test_torch_scenarios` files."""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

from repro_torch.core import (Agent, AgentConfig, LinkModel,  # noqa: E402
                              SimRuntime, TrackerConfig, TrackerServer,
                              make_prime_app)


def _mini_flash(n_leechers=4):
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6,
                                   downlink_Bps=12.5e6))
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
    host = Agent("host", config=AgentConfig(work_timeout_s=600.0))
    rt.add_node(host)
    app = make_prime_app("mm-app", "host", 3, 6_000, n_parts=6,
                         sim_time_per_number=1e-4, swarm=True,
                         app_bytes=262_144, piece_bytes=32_768)
    host.host_app(app)
    leech = [Agent(f"L{i}", config=AgentConfig(work_timeout_s=600.0))
             for i in range(n_leechers)]
    for a in leech:
        rt.add_node(a)
    done = lambda: all("mm-app" in a.images for a in leech)  # noqa: E731
    return rt, host, leech, done


def test_run_batched_without_ticks_is_event_identical_to_run():
    """`run_batched` shares the heap, the monotonic `_seq` counter and
    `events_processed` with `run`; with no tick callback it must drain
    the same scenario pop-for-pop: same event count, same sequence
    watermark, same virtual clock, same per-node traffic."""
    a_rt, a_host, a_leech, a_done = _mini_flash()
    b_rt, b_host, b_leech, b_done = _mini_flash()
    a_rt.run(until=3_600, stop_when=a_done)
    b_rt.run_batched(until=3_600, stop_when=b_done, tick_s=0.25)
    assert a_done() and b_done()
    assert a_rt.events_processed == b_rt.events_processed
    assert repr(a_rt._seq) == repr(b_rt._seq)   # same push watermark
    assert a_rt.now() == b_rt.now()
    assert a_rt.tx_bytes == b_rt.tx_bytes
    assert a_host.completed_at == b_host.completed_at


def test_run_batched_resumes_mixed_with_run():
    """Mixed-mode regression: a scenario driven part-way by `run`, then
    finished by `run_batched` (and vice versa) lands in the same final
    state — the shared seq counter keeps FIFO order across the seam."""
    final = []
    for order in ((0, 1), (1, 0)):
        rt, host, leech, done = _mini_flash()
        runners = [lambda u: rt.run(until=u, stop_when=done),
                   lambda u: rt.run_batched(until=u, stop_when=done,
                                            tick_s=0.5)]
        runners[order[0]](1.5)
        assert not done()
        runners[order[1]](3_600)
        assert done()
        final.append((rt.events_processed, repr(rt._seq), rt.now(),
                      dict(rt.tx_bytes)))
    assert final[0] == final[1]
