#!/usr/bin/env python3
"""Where ``chip_smoke.py`` can find room, measured on one card in one call:
a parent checkout against this one, in turns, on one host.

    python3 scripts/torch_fit_room.py PARENT [--steps LIST] [--out DIR]

PARENT is another checkout of this repository (for example the parent
commit, ``git archive``d into a git-ignored directory).  The kernel
library is built once (``kernels/build.py``'s flags) and every child
loads it.  Then, in turn for PARENT, this checkout, this checkout, PARENT,
a child process a tree runs the steps named in ``--steps``:

* **setup**: ``chip_smoke.py``'s set-up before the first card phase (phase
  serve's registry and every phase's generated data): the tree's
  ``chip_smoke.setup_data`` where it has one, else the sequence the
  parent's ``main`` runs (``serve_registry`` with its own ``m5_like``,
  then each generator one after another).  Its wall, each part's, and a
  digest of the products (arrays, frames with their index, the
  registry's column files): the bits must agree across the trees.  Run
  alone here; in ``chip_smoke.py`` the kernels' build runs beside it.
* **prep**: the whole config-3 batch (30,490 x 1,746) through the tree's
  ``design.prepare_fit_data_blocks`` where it has one (row blocks on
  threads, as ``fit_mcmc`` and the full-fleet preps take it), else
  ``prepare_fit_data``: its wall and a digest (the bits must agree).
* **fit**: eval config 3 (``m5_like(30490, 1941, seed=2)``, days
  [0, 1746), ``CudaBackend`` with the rescue pass, as phase fit) through
  ``CudaBackend.fit``, then the same batch through ``fit_twophase``
  (phase 1 at 12 iterations, as phase dataplane's fleet fit): each fit's
  wall, stages and state digest (the bits must agree).
* **extra**: ``fit_advi`` repeatability on every 10th row and
  ``chip_smoke.rd_time_split`` (this checkout only).
* **build**: every ``csrc/*.cu`` compiled without, then with,
  ``--split-compile=0``, each ``nvcc`` process's wall.
* **rhat**: ``hmc.split_rhat_ess`` on (300, 30,490, 53) float32 draws on
  the card (AR(1) chains from a seeded generator, ``fit_mcmc``'s shape):
  its wall, and every tree's R-hat and ESS against the first PARENT
  run's at float64 tolerance (the card's float64 arithmetic is not the
  host's bits).

Each step prints a JSON line (also appended to ``--out``/room.jsonl when
``--out`` names a directory), then ``nvidia-smi``'s name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The steps in argv[4] (comma-separated) on the checkout in argv[1] (first
# on sys.path), the kernel library in argv[2], the batch in argv[3].
CHILD = r"""
import argparse, dataclasses, hashlib, json, os, sys, tempfile, time
tree, lib_dir, batch_path, steps = sys.argv[1:5]
steps = steps.split(",")
sys.path.insert(0, tree)
sys.modules["jax"] = None
import numpy as np
import torch
import glob, shutil
from tsspark_tpu_torch.kernels import build
build.use_dir(lib_dir)
if not os.path.exists(os.path.join(lib_dir, build.lib_name())):
    shutil.copy(glob.glob(os.path.join(lib_dir, "*.so"))[0],
                os.path.join(lib_dir, build.lib_name()))
build.library()
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.eval import configs


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def frame_digest(df):
    import pandas as pd
    return digest(pd.util.hash_pandas_object(df, index=True).to_numpy())


if "setup" in steps:
    import chip_smoke as cs
    from tsspark_tpu_torch.data.datasets import m5_like, wiki_logistic_like
    args = argparse.Namespace(seed=0)
    root = tempfile.mkdtemp(prefix="serve_")
    t0 = time.perf_counter()
    if hasattr(cs, "setup_data"):
        made = cs.setup_data(args, root)
        parts = dict(made["setup_s"], **{"gen_" + k: v
                                         for k, v in made["gen_s"].items()})
    else:
        parts, made = {}, {}
        t1 = time.perf_counter()
        made["serve"] = cs.serve_registry(args, root)
        parts["serve_registry"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        made["batch3"] = m5_like(cs.FULL_SERIES, cs.FULL_DAYS, seed=2)
        made["batch4"] = wiki_logistic_like(cs.C4_SERIES, cs.C4_DAYS)
        n5, days5 = configs.config5_size(1.0)
        made["stream5_df"] = configs.config5_frame(n5, days5)
        f = configs.config5_frame(cs.FLEET_SERIES, days5)
        f = f[f.series_id.isin({f"s{i}" for i in cs.fleet_rows()})]
        made["fleet_df"] = f
        made["fleet_sub"] = f[f.series_id.isin(
            {f"s{i}" for i in cs.fleet_subset()})]
        m5_df, m5_ids = cs.m5_fleet_frame()
        made["m5_sub"] = m5_df[m5_df.series_id.isin(
            set(m5_ids[cs.fleet_subset()]))]
        made["m5_ids"] = m5_ids[cs.fleet_rows()]
        made["m5_df"] = m5_df[m5_df.series_id.isin(set(made["m5_ids"]))]
        made["batches12"] = cs.eval12_batches()
        parts["data"] = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    b3, b4, sb = made["batch3"], made["batch4"], made["serve"]["batch"]
    reg_files = sorted(glob.glob(os.path.join(root, "**", "*.npy"),
                                 recursive=True))
    dig = {"batch3": digest(b3.ds, b3.y, b3.mask, b3.regressors,
                            b3.series_ids),
           "batch4": digest(b4.ds, b4.y, b4.mask, b4.cap),
           "serve_batch": digest(sb.ds, sb.y, sb.mask, sb.series_ids),
           "registry": digest(*[np.load(f) for f in reg_files]),
           "m5_ids": digest(made["m5_ids"]),
           "batches12": digest(*[a for b in made["batches12"].values()
                                  for a in (b.ds, b.y, b.mask)])}
    for k in ("stream5_df", "fleet_df", "fleet_sub", "m5_df", "m5_sub"):
        dig[k] = frame_digest(made[k])
    print(json.dumps({"step": "setup", "tree": tree, "wall_s": wall,
                      "parts_s": parts, "digest": digest(*[
                          np.frombuffer(v.encode(), np.uint8)
                          for _, v in sorted(dig.items())]),
                      "digests": dig}), flush=True)
    del made, b3, b4, sb
    shutil.rmtree(root, ignore_errors=True)
if "rhat" in steps:
    from tsspark_tpu_torch.ops import hmc
    g = torch.Generator(device="cuda").manual_seed(3)
    e = torch.randn((300, 30490, 53), generator=g, device="cuda")
    phi = 0.95 * torch.rand((30490, 53), generator=g, device="cuda")
    x = torch.empty_like(e)
    x[0] = e[0]
    for t in range(1, 300):
        x[t] = phi * x[t - 1] + e[t]
    del e
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rhat, ess = hmc.split_rhat_ess(x)
    wall = time.perf_counter() - t0
    path = os.path.join(lib_dir, f"rhat_{os.getpid()}.npz")
    np.savez(path, rhat=rhat, ess=ess)
    print(json.dumps({"step": "rhat", "tree": tree, "wall_s": wall,
                      "out": path}), flush=True)
    del x
if not {"prep", "fit", "extra"} & set(steps):
    sys.exit(0)
z = np.load(batch_path)
ds, y, mask, reg = z["ds"], z["y"], z["mask"], z["reg"]
cfg, solver = configs.CONFIG3, configs.SOLVER3
split = configs.split_point(len(ds))
if "prep" in steps:
    from tsspark_tpu_torch.models.prophet import design
    fn = getattr(design, "prepare_fit_data_blocks", design.prepare_fit_data)
    t0 = time.perf_counter()
    data, meta = fn(ds[:split], np.nan_to_num(y[:, :split]), cfg,
                    mask=mask[:, :split], regressors=reg[:, :split])
    print(json.dumps({"step": "prep", "tree": tree, "fn": fn.__name__,
                      "wall_s": time.perf_counter() - t0,
                      "digest": digest(*data, *meta)}), flush=True)
    del data, meta
if not {"fit", "extra"} & set(steps):
    sys.exit(0)
bk = get_backend("cuda", cfg, solver)
torch.cuda.synchronize()
t0 = time.perf_counter()
st = bk.fit(ds[:split], np.nan_to_num(y[:, :split]), mask=mask[:, :split],
            regressors=reg[:, :split])
wall = time.perf_counter() - t0
status = np.asarray(st.status)
out = {"step": "rescue_ab", "tree": tree, "fit_s": wall,
       "stages_s": dict(bk.stages.seconds),
       "status_counts": {int(k): int(v) for k, v in
                         zip(*np.unique(status, return_counts=True))},
       "digest": digest(st.theta.numpy(), st.loss, st.status, st.n_iters)}
print(json.dumps(out), flush=True)
bk2 = get_backend("cuda", cfg, solver)
torch.cuda.synchronize()
t0 = time.perf_counter()
st2 = bk2.fit_twophase(ds[:split], np.nan_to_num(y[:, :split]),
                       mask=mask[:, :split], regressors=reg[:, :split],
                       phase1_iters=12)
print(json.dumps({"step": "twophase", "tree": tree,
                  "fit_s": time.perf_counter() - t0,
                  "stages_s": dict(bk2.stages.seconds),
                  "twophase": {k: v for k, v in bk2.twophase.items()
                               if k != "order"},
                  "digest": digest(st2.theta.numpy(), st2.loss, st2.status,
                                   st2.n_iters)}), flush=True)
del st2, bk2
if "extra" not in steps:
    sys.exit(0)
import chip_smoke as cs
from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.backends.cuda import phase1_dynamic_args
from tsspark_tpu_torch.config import AdviConfig
from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
from tsspark_tpu_torch.uncertainty import advi
rows = np.arange(5, y.shape[0], 10)
cfg0 = dataclasses.replace(cfg, regressors=())
theta = cs.rf_state_v1(st, cfg.num_regressors).theta.numpy()[rows]
data, _ = prepare_fit_data(ds[:split], np.nan_to_num(y[rows, :split]), cfg0,
                           mask=mask[rows, :split])
posts = []
for _ in range(2):
    t0 = time.perf_counter()
    p = advi.fit_advi(theta, data, torch.Generator(device="cuda").manual_seed(7),
                      cfg0, AdviConfig(), device=torch.device("cuda"))
    posts.append(({f: getattr(p, f).cpu().numpy() for f in ("mu", "rho", "elbo")},
                  time.perf_counter() - t0))
print(json.dumps({"step": "advi_repeat", "rows": int(len(rows)),
                  "walls_s": [w for _, w in posts],
                  "same_bits": {f: bool(np.array_equal(posts[0][0][f], posts[1][0][f]))
                                for f in ("mu", "rho", "elbo")}}), flush=True)
import tempfile
d = tempfile.mkdtemp()
n = cs.RS_CHUNK
orchestrate.spill_data(d, ds[:split], np.nan_to_num(y[:n, :split]),
                       mask=mask[:n, :split], regressors=reg[:n, :split])
packed, u8 = cs.rd_chunk(d, cfg, n)
for name, sv in (("phase1", phase1_dynamic_args(cs.DP_PHASE1, False, solver)["solver_config"]),
                 ("full", solver)):
    try:
        r = cs.rd_time_split(packed, u8, cfg, sv, torch.device("cuda", 0))
        r = {k: v for k, v in r.items()}
        ok = True
    except Exception as e:
        r, ok = {"error": repr(e)[:3000]}, False
    print(json.dumps({"step": "time_split", "solver": name, "ok": ok, **r}), flush=True)
"""


def build_times(extra_flags, tag) -> tuple:
    """Each csrc source compiled in parallel with ``build.NVCC_FLAGS``
    less ``--split-compile`` plus ``extra_flags``, each process's wall:
    (the objects' directory, the record)."""
    sys.path.insert(0, HERE)
    from tsspark_tpu_torch.kernels import build

    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS
             if not f.startswith("--split-compile")] + list(extra_flags)
    outdir = tempfile.mkdtemp(prefix=f"build_{tag}_")
    procs, t0 = {}, time.perf_counter()
    for src in build._sources():
        obj = os.path.join(outdir, os.path.basename(src) + ".o")
        # Output to a file: ptxas's report would fill a pipe nobody reads.
        with open(obj + ".log", "w") as fh:
            procs[os.path.basename(src)] = subprocess.Popen(
                [nvcc, *flags, "-c", src, "-o", obj], stdout=fh,
                stderr=subprocess.STDOUT)
    walls, rcs = {}, {}
    pending = dict(procs)
    while pending:
        for name, p in list(pending.items()):
            if p.poll() is not None:
                walls[name] = time.perf_counter() - t0
                rcs[name] = p.returncode
                if p.returncode:
                    with open(os.path.join(outdir, name + ".o.log")) as fh:
                        rcs[name] = (p.returncode, fh.read()[-800:])
                del pending[name]
        time.sleep(0.05)
    return outdir, {"step": "build", "flags": extra_flags,
                    "total_s": max(walls.values()), "walls_s": walls,
                    "rcs": rcs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--steps", default="setup,prep,fit",
                    help="comma-separated: setup, rhat, prep, fit, extra, "
                         "build")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    steps = args.steps.split(",")
    log = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        log = open(os.path.join(args.out, "room.jsonl"), "a")

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if log is not None:
            log.write(line + "\n")
            log.flush()

    import numpy as np

    sys.path.insert(0, HERE)
    from tsspark_tpu_torch.data.datasets import m5_like
    from tsspark_tpu_torch.kernels import build

    # The library every child loads, built once as kernels/build.py builds.
    lib_dir = tempfile.mkdtemp(prefix="lib_")
    build.use_dir(lib_dir)
    t0 = time.perf_counter()
    build.library()
    emit({"step": "library", "build_s": time.perf_counter() - t0})
    if "build" in steps:
        emit(build_times([], "plain")[1])
        emit(build_times(["--split-compile=0"], "split")[1])
    batch_path = os.path.join(tempfile.mkdtemp(prefix="batch_"), "b.npz")
    if {"prep", "fit", "extra"} & set(steps):
        b = m5_like(30490, 1941, seed=2)
        np.savez(batch_path, ds=b.ds, y=b.y, mask=b.mask, reg=b.regressors)
        del b
    parent = os.path.abspath(args.parent)
    digests, rhat_out = {}, {}
    for i, tree in enumerate((parent, HERE, HERE, parent)):
        todo = [st for st in steps if st in ("setup", "rhat", "prep", "fit")]
        if "extra" in steps and i == 1:
            todo.append("extra")
        if not todo:
            break
        p = subprocess.run([sys.executable, "-c", CHILD, tree, lib_dir,
                            batch_path, ",".join(todo)], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
        for line in p.stdout.splitlines():
            if line.startswith("{"):
                d = json.loads(line)
                d["which"] = "parent" if tree == parent else "change"
                if "digest" in d:
                    digests.setdefault(d["step"], []).append(d["digest"])
                if d["step"] == "rhat":
                    rhat_out.setdefault(d["which"], []).append(d["out"])
                emit(d)
        if p.returncode:
            emit({"step": "child_failed", "tree": tree, "rc": p.returncode,
                  "stderr": p.stderr[-3000:]})
    emit({"step": "bits", "same": {k: len(set(v)) == 1
                                   for k, v in digests.items()},
          "n": {k: len(v) for k, v in digests.items()}})
    if rhat_out.get("parent") and rhat_out.get("change"):
        # The card's float64 R-hat / ESS against the host's: a tolerance,
        # not bits (the FFT's and the sums' order are the device's).
        ref = np.load(rhat_out["parent"][0])
        err = {}
        for path in rhat_out["parent"][1:] + rhat_out["change"]:
            z = np.load(path)
            for k in ("rhat", "ess"):
                e = float(np.max(np.abs(z[k] - ref[k])
                                 / np.maximum(np.abs(ref[k]), 1.0)))
                err[k] = max(err.get(k, 0.0), e)
        emit({"step": "rhat_vs_parent", "max_rel_err": err})
    for f in glob.glob(os.path.join(os.path.dirname(batch_path), "*")):
        os.remove(f)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"step": "card", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
