#!/usr/bin/env python3
"""The scale ladder (``bench_scale.run_ladder``: 30k -> 100k -> 1m) on one
card, on an explicit one-device mesh of cuda:0 and fresh roots.

    python3 scripts/torch_ladder.py [--rungs 30k,100k,1m] [--out DIR]

Each rung ingests its ``demo_weekly`` plane, fits it resident in this
process, publishes the snapshot plane and the npz, and serves it through a
``ReplicaPool`` of four replica processes on the card (the mid-run flip),
then the npz pool's RSS comparison.  After each rung, K3 (both modes)
and K4 are held against their plain versions on the rung's first
resident wave at its fitted theta moved off the optimum (GAP_RULE; one
dropped cell a row must fail it; ``hold_wave``), with both gaps to the
plain versions in float64, and K1 at the pool's dispatch shapes
(``chip_smoke.bn_forward``): the rungs' 128, 96 and 64 days are row
lengths no other path runs.  A rung whose wave breaks GAP_RULE is printed
and the ladder goes on; the exit code is then 1.  Per rung one JSON line: fit_s,
series/s, publish_s, snapshot MB, time to first request, aggregate req/s,
flip p99, RSS and Pss per replica, ``rss_reduction_x``, the pool's
outcomes and wrong-version count, this process's peak device memory over
the rung (``torch.cuda.max_memory_allocated``), and the rung's wall.  The
reports (``SCALE_<rung>_*.json``) and the run history land in a temporary
working directory, copied to ``--out`` when given.  The last line is
``nvidia-smi``'s name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hold_wave(cs, theta, d, data, cfg) -> dict:
    """K3 (both modes) and K4 against their plain versions on one wave,
    as ``chip_smoke.hold_kernels`` does (GAP_RULE; one dropped cell a row
    must fail it), reported rather than raised so every rung prints; and
    the kernels' and the float32 plain versions' gaps to the plain
    versions in float64, which say whether a gap beyond GAP_RULE is the
    kernel's or float32's own at this row length."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = data.t.shape
    f_k, g_k = lk.loss(theta, data, cfg)
    v_k, _ = lk.loss(theta, data, cfg, grad=False)
    f_p, g_p = lk.loss_plain(theta, data, cfg)
    ladder = cs._ladder(b, data.t.device)
    fan_got = fan_k.fan(theta, d, ladder, data, cfg)
    fan_want = fan_k.fan_plain(theta, d, ladder, data, cfg)
    fan_sc = cs.fan_scale(theta, d, ladder, data, cfg)
    gaps = cs.loss_gaps(theta, data, cfg, {
        "f": (f_k, f_p), "g": (g_k, g_p), "value": (v_k, f_p)})
    gaps["fan"] = cs._gap(fan_got, fan_want, fan_sc, t_len)
    mask = data.mask.clone()
    mask[torch.arange(b, device=mask.device), mask.argmax(-1)] = 0.0
    dropped = data._replace(mask=mask)
    planted = cs.loss_gaps(theta, data, cfg, {
        "f": (lk.loss(theta, dropped, cfg, grad=False)[0], f_p)})
    planted["fan"] = cs._gap(fan_k.fan(theta, d, ladder, dropped, cfg),
                             fan_want, fan_sc, t_len)
    d64 = data._replace(**{
        k: v.double() for k, v in data._asdict().items()
        if torch.is_tensor(v) and v.is_floating_point()})
    f_64, g_64 = lk.loss_plain(theta.double(), d64, cfg)
    fan_64 = fan_k.fan_plain(theta.double(), d.double(), ladder.double(),
                             d64, cfg)
    vs64 = {}
    for who, f, g, fan in (("kernel", f_k, g_k, fan_got),
                           ("plain", f_p, g_p, fan_want)):
        vs64[who] = cs.loss_gaps(theta, data, cfg, {
            "f": (f.double(), f_64), "g": (g.double(), g_64)})
        vs64[who]["fan"] = cs._gap(fan.double(), fan_64, fan_sc.double(),
                                   t_len)
    return {"shape": [b, t_len, cfg.num_params], "gap": gaps,
            "tolerance": cs.GAP_RULE,
            "within_gap_rule": cs.within_gap_rule(gaps),
            "planted_dropped_cell": planted,
            "dropped_fails": min(planted.values()) > cs.GAP_TOL,
            "gap_to_float64": vs64}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rungs", default="30k,100k,1m")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_ladder: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from tsspark_tpu_torch import bench_scale, orchestrate
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.parallel.mesh import make_mesh
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    mesh = make_mesh(1, 1, devices=[torch.device("cuda", 0)])
    root = tempfile.mkdtemp(prefix="ladder_")
    cwd = os.getcwd()
    out = os.path.abspath(args.out) if args.out else None
    os.chdir(root)
    ok = True
    try:
        for name in args.rungs.split(","):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rep = bench_scale.run_rung(
                name, data_root=os.path.join(root, f"data_{name}"),
                scratch_root=os.path.join(root, f"scratch_{name}"),
                device=None, mesh=mesh)
            wall = time.perf_counter() - t0
            peak_mb = round(torch.cuda.max_memory_allocated() / 1e6, 1)
            checks = None
            if rep.get("complete"):
                rung = bench_scale.RUNGS[name]
                cfg = bench_scale._config()
                dset = plane.dataset_dir(plane.DatasetSpec(
                    "demo_weekly", rung.series, rung.timesteps, seed=2),
                    os.path.join(root, f"data_{name}"))
                scratch = os.path.join(
                    root, f"scratch_{name}",
                    f"tsscale_{name}_{rung.series}x{rung.timesteps}"
                    f"_{plane.dataset_fingerprint()}")
                state = orchestrate.load_fit_state(
                    os.path.join(scratch, "out"), rung.series)
                dev = torch.device("cuda", 0)
                data = cs.bn_wave(dset, cfg, rung.chunk, dev)
                theta = torch.as_tensor(np.asarray(
                    state.theta[:rung.chunk], np.float32), device=dev)
                theta_h, d_h = cs.off_optimum(theta, cs.BN_SEED)
                wave = hold_wave(cs, theta_h, d_h, data, cfg)
                ok = ok and wave["within_gap_rule"] and wave["dropped_fails"]
                snap = ParamRegistry.open(os.path.join(
                    scratch, "registry")).load(1, fallback=False)
                checks = {"wave": wave,
                          "forward": cs.bn_forward(snap, cfg, dev)["rel_err"]}
                del data, theta, theta_h, d_h
            fit, pub = rep.get("fit") or {}, rep.get("publish") or {}
            serve = rep.get("serve") or {}
            mem = serve.get("mem") or {}
            print(json.dumps({
                "rung": name, "series": rep.get("series"),
                "timesteps": rep.get("timesteps"),
                "complete": rep.get("complete"),
                "device": rep.get("device"),
                "ingest_s": (rep.get("ingest") or {}).get("ingest_s"),
                "fit_s": fit.get("fit_s"), "fit_path": fit.get("fit_path"),
                "series_per_s": fit.get("series_per_s"),
                "publish_s": pub.get("publish_s"),
                "snapshot_mb": pub.get("snapshot_mb"),
                "ttfr_s": serve.get("time_to_first_request_s"),
                "agg_requests_per_s": serve.get("agg_requests_per_s"),
                "latency_ms": serve.get("latency_ms"),
                "flip_p99_ms": (serve.get("flip") or {}).get("p99_ms"),
                "rss_mb_per_replica": mem.get("rss_mb_per_replica"),
                "pss_mb_per_replica": mem.get("pss_mb_per_replica"),
                "rss_anon_mb_per_replica": mem.get("rss_anon_mb_per_replica"),
                "rss_compare": {k: v for k, v in (
                    serve.get("rss_compare") or {}).items() if k != "npz"},
                "outcomes": serve.get("outcomes"),
                "wrong_version": serve.get("wrong_version"),
                "peak_device_mb": peak_mb,
                "kernel_checks": checks,
                "sentinel_ok": rep.get("sentinel_ok"),
                "wall_s": round(wall, 3),
            }), flush=True)
            if out:
                os.makedirs(out, exist_ok=True)
                for f in os.listdir(root):
                    if f.startswith(("SCALE_", "RUNHISTORY", "REGRESSION_")):
                        shutil.copy(os.path.join(root, f), out)
            if not rep.get("complete"):
                ok = False
                break
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
