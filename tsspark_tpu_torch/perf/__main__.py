"""``python -m tsspark_tpu_torch.perf`` — print a fit's perf telemetry
(the port's copy of the JAX package's ``perf/__main__.py``).

Accepts a BENCH summary JSON (one with an ``extra.perf`` block), an
orchestrate scratch/out directory (reads ``times.jsonl`` +
``autotune.json`` directly), or a ``RUNLEDGER_*.json`` run ledger
(``tsspark_tpu_torch.obs`` — reads its embedded ``perf`` block).
Device-free: imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tsspark_tpu_torch.perf.recorder import summarize_times


def _load(target: str) -> dict:
    if os.path.isdir(target):
        times = []
        tpath = os.path.join(target, "times.jsonl")
        if os.path.exists(tpath):
            with open(tpath) as fh:
                for line in fh:
                    if line.strip():
                        try:
                            times.append(json.loads(line))
                        except ValueError:
                            pass  # torn tail line of a killed worker
        autotune = None
        apath = os.path.join(target, "autotune.json")
        if os.path.exists(apath):
            try:
                with open(apath) as fh:
                    autotune = json.load(fh)
            except ValueError:
                pass
        return summarize_times(times, autotune)
    with open(target) as fh:
        summary = json.load(fh)
    if summary.get("kind") == "run-ledger":
        perf = summary.get("perf")
        if perf is None:
            raise SystemExit(
                f"{target}: run ledger carries no perf block (no "
                "times.jsonl rows were found when it was built)"
            )
        return perf
    perf = summary.get("extra", {}).get("perf")
    if perf is None:
        raise SystemExit(
            f"{target}: no extra.perf block (pre-telemetry BENCH artifact?)"
        )
    return perf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tsspark_tpu_torch.perf",
        description="perf telemetry summary",
    )
    ap.add_argument("target",
                    help="BENCH summary JSON file or orchestrate out dir")
    ap.add_argument("--json", action="store_true",
                    help="print the raw perf dict instead of the table")
    args = ap.parse_args(argv)
    perf = _load(args.target)
    if args.json:
        print(json.dumps(perf, indent=2))
        return 0

    print(f"chunks fitted:     {perf.get('n_chunks', 0)}")
    ff = perf.get("first_flush_s")
    print(f"first chunk flush: {ff if ff is not None else 'n/a'} s")
    print(f"compile misses:    {perf.get('compile_misses', 0)}")
    by_size = perf.get("series_per_s_by_size", {})
    if by_size:
        print("series/s by chunk size:")
        for size, sps in by_size.items():
            print(f"  {size:>6}: {sps}")
    at = perf.get("autotune")
    if at:
        print(f"autotuned chunk:   {at.get('chunk')}")
    segs = perf.get("segments", [])
    if segs:
        print(f"dispatches ({len(segs)}):")
        for s in segs[:40]:
            width = s.get("width", s.get("chunk", "?"))
            live = s.get("live", "")
            live_txt = f" live={live}" if live != "" else ""
            miss = " [compile]" if s.get("compile_miss") else ""
            sps = s.get("series_per_s")
            sps_txt = f" {sps} series/s" if sps is not None else ""
            print(f"  [{s.get('lo', '?')}:{s.get('hi', '?')}] "
                  f"w={width}{live_txt} {s.get('fit_s', '?')}s"
                  f"{sps_txt}{miss}")
        if len(segs) > 40:
            print(f"  ... {len(segs) - 40} more")
    return 0


if __name__ == "__main__":
    sys.exit(main())
