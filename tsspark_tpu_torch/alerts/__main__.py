"""CLI: ``python -m tsspark_tpu_torch.alerts`` — the killable alert scorer.

Two modes:

* ``--bench RUNG`` — the land→alert freshness bench
  (:mod:`tsspark_tpu_torch.alerts.bench`).
* drive mode (``--data/--registry/--alerts-dir``) — run the scorer as
  its own process over an existing plane dataset + registry, the unit a
  kill drill ends mid-publish and mid-delivery.  ``--poll-once`` runs
  exactly one cycle and exits; otherwise the loop polls until
  ``--duration`` elapses or it is killed.

Both run on the card unless ``--device cpu`` asks for the CPU (then the
bench's fits take the virtual host mesh).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

from tsspark_tpu_torch.obs import context as obs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tsspark_tpu_torch.alerts")
    ap.add_argument("--bench", default=None, metavar="RUNG",
                    help="run the land→alert freshness bench at a "
                         "scale rung instead of the scorer")
    ap.add_argument("--reuse-cold", default=None, metavar="DIR")
    ap.add_argument("--churn", type=float, default=None)
    ap.add_argument("--deltas", type=int, default=None)
    ap.add_argument("--data", help="plane dataset dir")
    ap.add_argument("--registry", help="serve registry root")
    ap.add_argument("--alerts-dir", help="durable alert log dir")
    ap.add_argument("--sink", default=None,
                    help="sink spec (jsonl:<path>); defaults to "
                         "$TSSPARK_ALERTS_SINK")
    ap.add_argument("--horizon", type=int, default=1)
    ap.add_argument("--z", type=float, default=None,
                    help="z-score threshold override (fallback mode)")
    ap.add_argument("--overdue-k", type=float, default=None,
                    help="data-liveness overdue multiple of the EWMA "
                         "inter-arrival (default sched.OVERDUE_K)")
    ap.add_argument("--poll-once", action="store_true",
                    help="run one score/deliver cycle and exit")
    ap.add_argument("--poll", type=float, default=0.1)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        from tsspark_tpu_torch.parallel.mesh import force_virtual_host_mesh

        force_virtual_host_mesh()
    obs.adopt_env()
    if args.bench:
        from tsspark_tpu_torch import refit
        from tsspark_tpu_torch.alerts import bench

        kw = {}
        if args.churn is not None:
            kw["churn"] = args.churn
        if args.deltas is not None:
            kw["n_deltas"] = args.deltas
        reports = bench.run_alerts_bench(args.bench,
                                         reuse_cold=args.reuse_cold,
                                         device=args.device, **kw)
        return 0 if refit.sweep_ok(reports) else 1
    if not (args.data and args.registry and args.alerts_dir):
        ap.error("--data, --registry and --alerts-dir are required "
                 "for the scorer")
    sink_spec = args.sink or os.environ.get("TSSPARK_ALERTS_SINK")
    if not sink_spec:
        ap.error("--sink (or TSSPARK_ALERTS_SINK) is required")
    from tsspark_tpu_torch import sched
    from tsspark_tpu_torch.alerts.sink import build_sink
    from tsspark_tpu_torch.alerts.stream import AlertStream
    from tsspark_tpu_torch.serve.cache import ForecastCache
    from tsspark_tpu_torch.serve.engine import PredictionEngine
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    registry = ParamRegistry.open(args.registry)
    engine = PredictionEngine(registry, cache=ForecastCache(256),
                              device=args.device)
    stream = AlertStream(
        args.alerts_dir, args.data, engine, build_sink(sink_spec),
        horizon=args.horizon, z=args.z,
        overdue_k=(sched.OVERDUE_K if args.overdue_k is None
                   else args.overdue_k),
    )
    if args.poll_once:
        res = stream.poll_once()
        res["snapshot"] = stream.snapshot()
        print(json.dumps(res), flush=True)
        return 0 if not res["stalled"] else 1
    t_end = None if args.duration is None else \
        time.monotonic() + args.duration
    last = {}
    while t_end is None or time.monotonic() < t_end:
        last = stream.poll_once()
        time.sleep(args.poll)
    last["snapshot"] = stream.snapshot()
    print(json.dumps(last), flush=True)
    return 0 if not last.get("stalled") else 1


if __name__ == "__main__":
    sys.exit(main())
