"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--fault <name>] [--out chiprun_out/c.jsonl]

For each of ``--seeds`` it reads the comparison's numbers of the
program as a run of that seed would check them, and for each of
``--control-seeds`` those of the control, the reference in float8
products in the program's place: both through the cell's own loop
(``loops/<kind>.py``: its ``readings``), with no window.  With
``--fault`` the program's readings are taken with that fault of the
loop's ``FAULTS`` planted.  Each reading is a JSON line; the last line
holds, for every number, the largest program reading (the lower one)
and the smallest control reading (the upper one).  The benchmark's own
runs never run the control."""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(cell: str, seed: int, who: str, fault=None, *,
             device: str = "cuda", root: Path = ROOT, bench: Path = BENCH
             ) -> dict:
    """The comparison's numbers of ``who`` ("program" or "control") in
    one set-up of ``cell`` from ``seed``, with ``fault`` planted under
    the program."""
    from portbench import harness
    ctx = harness.Context(cell, seed, 0.0, False, device, time.time(), root,
                          bench)
    planted = ctx.loop.FAULTS[fault]() if fault and who == "program" \
        else contextlib.nullcontext()
    with planted:
        return ctx.loop.readings(ctx, who)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None,
                    help="a fault of the loop's FAULTS planted under the "
                         "program for its seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    lower, upper = {}, {}

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for who, seed in [("program", s) for s in seeds] + \
            [("control", s) for s in controls]:
        t0 = time.perf_counter()
        numbers = readings(args.workload, seed, who, args.fault)
        emit({"who": who, "seed": seed, "fault": args.fault,
              "numbers": numbers, "seconds": time.perf_counter() - t0})
        side = lower if who == "program" else upper
        pick = max if who == "program" else min
        for k, v in numbers.items():
            side[k] = pick(side.get(k, v), v)
        harness.free_memory("cuda")
    emit({"lower": lower, "upper": upper,
          "device": torch.cuda.get_device_name(0)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
