"""The paper, live, on the PyTorch port: a P2P torrent-like volunteer
cloud finding primes.

The counterpart of `examples/volunteer_cloud.py` on `repro_torch.core`.
One tracking server, one seeder agent publishing a prime-search
application (exhaustion method, as in the paper), and three leecher
agents that REQ parts, RUN them for real (threads), and return results
for majority-vote validation.  Seed/Leech directories (Fig. 3) are
materialised on disk.  Host-only: the thread runtime runs no device
code, so the script takes no ``--device``.

  PYTHONPATH=src python examples/port_volunteer_cloud.py
"""
import tempfile

from repro_torch.core import (Agent, AgentConfig, ThreadRuntime,
                              TrackerConfig, TrackerServer, make_prime_app)


def main():
    root = tempfile.mkdtemp(prefix="volunteer_cloud_")
    rt = ThreadRuntime(n_workers=3)
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=0.25)))

    host = Agent("seederY", config=AgentConfig(
        work_timeout_s=20.0, status_interval_s=0.25, retry_s=0.1,
        root_dir=root))
    rt.add_node(host)
    app = make_prime_app("primes_3_to_60k", "seederY", 3, 60_000, n_parts=24)
    host.host_app(app)

    for name in ("leecherX", "leecherZ", "leecherW"):
        rt.add_node(Agent(name, config=AgentConfig(
            work_timeout_s=20.0, status_interval_s=0.25, retry_s=0.1,
            root_dir=root)))

    print(f"cloud up (dirs under {root}); crunching ...")
    rt.run(until_s=60.0, stop_when=lambda: app.done)

    assert app.done, "application did not finish"
    n_primes = sum(len(p.results[0][1]) for p in app.parts)
    m = host.metrics[app.app_id]
    print(f"done: {n_primes} primes <= 60000 found "
          f"(primes in [3, 60000]: 6056)")
    print(f"published units: d={m.d / 1e6:.2f}MB p={m.p} w={m.w * 1e3:.1f}ms")
    for nid in ("leecherX", "leecherZ", "leecherW"):
        a = rt.nodes[nid]
        print(f"  {nid}: cycles={a.completed_cycles[app.app_id]} "
              f"time={a.leech_time[app.app_id]:.2f}s")


if __name__ == "__main__":
    main()
