"""The reference's end-to-end protocol cases (`tests/test_system.py`: the
paper's tracker/agent system, its 23 procedures among them), run as one
test parametrised over both packages: each case builds its cloud from
`repro.core` or from `repro_torch.core` and must pass in both."""
import importlib

import pytest

pytest.importorskip("torch")

PACKAGES = ("repro", "repro_torch")


def build_cloud(core, n_leechers=2, parts=24, m_min=1, val_hook=None,
                timeout=200.0, overhead=0.0):
    rt = core.SimRuntime()
    server = core.TrackerServer(config=core.TrackerConfig(ping_interval_s=2.0))
    rt.add_node(server)
    host = core.Agent("host", config=core.AgentConfig(
        work_timeout_s=timeout, cycle_overhead_s=overhead),
        val_hook=val_hook)
    rt.add_node(host, speed=1.0)
    app = core.make_prime_app("app", "host", 3, 24_000, n_parts=parts,
                              m_min=m_min, sim_time_per_number=1e-4)
    host.host_app(app)
    leechers = []
    for i in range(n_leechers):
        a = core.Agent(f"L{i}", config=core.AgentConfig(
            work_timeout_s=timeout, cycle_overhead_s=overhead))
        rt.add_node(a, speed=1.0)
        leechers.append(a)
    return rt, server, host, app, leechers


def case_application_completes_and_validates(core, tmp_path):
    rt, server, host, app, leechers = build_cloud(core)
    rt.run(until=3600, stop_when=lambda: app.done)
    assert app.done
    # every part validated exactly once, results are actual primes
    assert all(len(p.results) >= 1 for p in app.parts)
    total = sum(l.completed_cycles["app"] for l in leechers)
    assert total >= len(app.parts)
    # the winning results really are primes
    r0 = app.parts[0].results[0][1]
    assert 3 in r0 and 4 not in r0 and 5 in r0


def case_work_splits_roughly_evenly(core, tmp_path):
    rt, server, host, app, leechers = build_cloud(core, n_leechers=2,
                                                  parts=40)
    rt.run(until=3600, stop_when=lambda: app.done)
    c = [l.completed_cycles["app"] for l in leechers]
    assert abs(c[0] - c[1]) <= 6, c


def case_metrics_published_to_server(core, tmp_path):
    rt, server, host, app, _ = build_cloud(core)
    rt.run(until=3600, stop_when=lambda: app.done)
    rt.run(until=rt.now() + 10)
    row = server.app_list.get("app")
    assert row is not None
    m = host.metrics["app"]
    assert row.p == m.p == len(app.parts)
    assert row.d == m.d > 0
    assert row.w == pytest.approx(m.w)


def case_host_death_drops_application(core, tmp_path):
    rt, server, host, app, leechers = build_cloud(core, parts=400)
    rt.run(until=20)              # some progress
    # kill the host: stop answering pings
    del rt.nodes["host"]
    rt.run(until=rt.now() + 60)
    assert "app" not in server.app_list
    # leechers eventually STOP the app (dropped from their lists)
    assert all("app" in l.stopped_apps for l in leechers)


def case_tail_timeout_redistributes_leases(core, tmp_path):
    rt, server, host, app, leechers = build_cloud(core, parts=30,
                                                  timeout=30.0)
    rt.run(until=10)
    # one leecher dies mid-work
    dead = leechers[0]
    del rt.nodes[dead.node_id]
    rt.run(until=3600 * 5, stop_when=lambda: app.done)
    assert app.done  # survivor finished everything despite lost leases


def case_majority_voting_rejects_malicious(core, tmp_path):
    # m_min=2: every part must be computed twice and agree
    rt, server, host, app, leechers = build_cloud(core, n_leechers=3,
                                                  parts=12, m_min=2)
    rt.run(until=3600 * 5, stop_when=lambda: app.done)
    assert app.done
    assert all(len(p.results) >= 2 for p in app.parts)
    # m_min scaling of eq (4): p counts every replicated execution
    assert host.metrics["app"].m_min >= 2


def case_val_hook_discards_bad_results(core, tmp_path):
    calls = {}

    def val_hook(part_id, result):
        # reject the first submission of part 0 (simulated corruption)
        if part_id == 0 and "seen" not in calls:
            calls["seen"] = True
            return False
        return True

    rt, server, host, app, leechers = build_cloud(core, val_hook=val_hook,
                                                  parts=8)
    rt.run(until=3600 * 2, stop_when=lambda: app.done)
    assert app.done
    assert calls.get("seen")
    # part 0 required a re-execution
    assert len(app.parts[0].results) >= 1


def case_all_23_procedures_exist(core, tmp_path):
    server_procs = ["PING", "PUSH", "RECV", "VAL", "INIT", "INFO", "WRITE",
                    "READ"]
    agent_procs = ["RECV", "SEND", "EVAL", "DIST", "STAT", "VAL", "TAIL",
                   "REQ", "SCAN", "RUN", "TIME", "COLLECT", "SAVE", "LOAD",
                   "STOP"]
    assert len(server_procs) + len(agent_procs) == 23
    for p in server_procs:
        assert callable(getattr(core.TrackerServer, p)), p
    for p in agent_procs:
        assert callable(getattr(core.Agent, p)), p


def case_agent_directory_layout(core, tmp_path):
    rt = core.SimRuntime()
    rt.add_node(core.TrackerServer())
    host = core.Agent("h", config=core.AgentConfig(root_dir=str(tmp_path)))
    rt.add_node(host)
    app = core.make_prime_app("a1", "h", 3, 4000, n_parts=4,
                              sim_time_per_number=1e-4)
    host.host_app(app)
    leech = core.Agent("l", config=core.AgentConfig(root_dir=str(tmp_path)))
    rt.add_node(leech)
    rt.run(until=3600, stop_when=lambda: app.done)
    assert app.done
    assert (tmp_path / "h" / "Seed" / "App" / "a1" / "app.bin").exists()
    assert (tmp_path / "h" / "Seed" / "App" / "a1" / "Data" / "Tracker"
            ).exists()
    assert (tmp_path / "h" / "Seed" / "App" / "a1" / "Result" / "0.res"
            ).exists()
    assert (tmp_path / "l" / "Leech" / "App" / "a1" / "Data" / "Time"
            ).exists()


def case_thread_runtime_runs_real_primes(core, tmp_path):
    rt = core.ThreadRuntime(n_workers=2)
    rt.add_node(core.TrackerServer(
        config=core.TrackerConfig(ping_interval_s=0.2)))
    host = core.Agent("h", config=core.AgentConfig(
        work_timeout_s=10.0, status_interval_s=0.2, retry_s=0.1))
    rt.add_node(host)
    app = core.make_prime_app("a1", "h", 3, 3000, n_parts=6)
    host.host_app(app)
    for i in range(2):
        rt.add_node(core.Agent(f"l{i}", config=core.AgentConfig(
            work_timeout_s=10.0, status_interval_s=0.2, retry_s=0.1)))
    rt.run(until_s=30.0, stop_when=lambda: app.done)
    assert app.done
    primes = sorted(set(sum((r for _, r, _ in
                             (res for p in app.parts for res in [p.results[0]]
                              )), [])))
    assert primes[:5] == [3, 5, 7, 11, 13]


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_system(case, package, tmp_path):
    CASES[case](importlib.import_module(f"{package}.core"), tmp_path)
