#!/usr/bin/env python3
"""Where ``chip_smoke.py`` can find room, measured on one card in one call.

    python3 scripts/torch_fit_room.py PARENT [--out DIR]

PARENT is another checkout of this repository (for example the parent
commit, ``git archive``d into a git-ignored directory).  In turn:

1. **build**: every ``csrc/*.cu`` of this checkout compiled by ``nvcc``
   as ``kernels/build.py`` compiles them (one process a source, all
   started together) but without ``--split-compile=0``, each process's
   wall recorded; then again with it (the compiler's optimizer on every
   core).
2. **rescue A/B**: eval config 3 (``m5_like(30490, 1941, seed=2)``, days
   [0, 1746), ``CudaBackend`` with the rescue pass, as ``chip_smoke.py``'s
   phase fit) fitted by PARENT, this checkout, this checkout, PARENT, each
   in a child process on the one kernel library built in step 1 (the
   sources are the same; a checkout whose flags name the library
   otherwise loads a copy under its own name): the fit's wall, its stages, its status counts
   and a digest of its state (the bits must agree).
3. **ADVI repeatability**: ``fit_advi`` at ``AdviConfig()`` on every 10th
   row of the batch (3,049, config 3 without regressors) from the fit's
   theta, twice with one seed: the same bits or not.
4. **time split**: ``chip_smoke.rd_time_split`` (``fit_sharded_packed``
   on a 1 x 2 mesh of cuda:0) on the first 8,192 rows, under phase 1's
   program (12 iterations, no metric) and under config 3's full solver.

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

# One config-3 fit in a child process, on the checkout in argv[1] (first
# on sys.path), the kernel library in argv[2], the batch in argv[3]; with
# argv[4] == "extra" it also runs steps 3 and 4.
CHILD = r"""
import dataclasses, hashlib, json, os, sys, time
tree, lib_dir, batch_path, extra = sys.argv[1:5]
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
z = np.load(batch_path)
ds, y, mask, reg = z["ds"], z["y"], z["mask"], z["reg"]
cfg, solver = configs.CONFIG3, configs.SOLVER3
split = configs.split_point(len(ds))
bk = get_backend("cuda", cfg, solver)
torch.cuda.synchronize()
t0 = time.perf_counter()
st = bk.fit(ds[:split], np.nan_to_num(y[:, :split]), mask=mask[:, :split],
            regressors=reg[:, :split])
wall = time.perf_counter() - t0
h = hashlib.sha256()
for a in (st.theta.numpy(), st.loss, st.status, st.n_iters):
    h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
status = np.asarray(st.status)
out = {"step": "rescue_ab", "tree": tree, "fit_s": wall,
       "stages_s": dict(bk.stages.seconds),
       "status_counts": {int(k): int(v) for k, v in
                         zip(*np.unique(status, return_counts=True))},
       "digest": h.hexdigest()}
print(json.dumps(out), flush=True)
if extra != "extra":
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
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

    objs, rec = build_times([], "plain")
    emit(rec)
    # The plain build's objects linked as build.py links them: the
    # library every child loads.
    lib_dir = tempfile.mkdtemp(prefix="lib_")
    t0 = time.perf_counter()
    subprocess.run([build._nvcc(), "-shared",
                    "-gencode=arch=compute_90a,code=sm_90a",
                    *sorted(glob.glob(os.path.join(objs, "*.o"))), "-o",
                    os.path.join(lib_dir, build.lib_name())], check=True)
    build.use_dir(lib_dir)
    build.library()
    emit({"step": "library", "link_s": time.perf_counter() - t0,
          "built_again": build.builds > 0})
    emit(build_times(["--split-compile=0"], "split")[1])
    b = m5_like(30490, 1941, seed=2)
    batch_path = os.path.join(tempfile.mkdtemp(prefix="batch_"), "b.npz")
    np.savez(batch_path, ds=b.ds, y=b.y, mask=b.mask, reg=b.regressors)
    del b
    parent = os.path.abspath(args.parent)
    digests = []
    for i, tree in enumerate((parent, HERE, HERE, parent)):
        extra = "extra" if i == 1 else "-"
        p = subprocess.run([sys.executable, "-c", CHILD, tree, lib_dir,
                            batch_path, extra], cwd=tree,
                           capture_output=True, text=True, timeout=900)
        for line in p.stdout.splitlines():
            if line.startswith("{"):
                d = json.loads(line)
                d["which"] = "parent" if tree == parent else "change"
                if d["step"] == "rescue_ab":
                    digests.append(d["digest"])
                emit(d)
        if p.returncode:
            emit({"step": "child_failed", "tree": tree, "rc": p.returncode,
                  "stderr": p.stderr[-3000:]})
    emit({"step": "rescue_ab_bits", "same": len(set(digests)) == 1,
          "n": len(digests)})
    for f in glob.glob(os.path.join(os.path.dirname(batch_path), "*")):
        os.remove(f)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"step": "card", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
