#!/usr/bin/env python3
"""Time the port's kernels of several checkouts on one card, in turns.

    python3 scripts/torch_kernel_ab.py DIR [DIR ...] [--out DIR]

Each DIR is a checkout of this repository (for example another commit,
``git archive``d into a git-ignored directory).  For each DIR in the
order given, a child process imports that checkout's
``tsspark_tpu_torch`` (building its kernels), prepares the fit path's
first chunk of eval config 3 — 8,192 series of ``m5_like(8192, 1941,
seed=2)`` over the first 1,746 days, packed and unpacked as the fit does,
the solver's ridge init and first preconditioned direction — and:

* times K3 ``loss`` in gradient and in value mode and K4 ``fan`` (a
  20-rung ladder) at that shape by CUDA events, each beside its bound
  (``chip_smoke.loss_bound_ms`` / ``fan_bound_ms`` of the same checkout);
* runs one chunk's L-BFGS solve under ``torch.profiler``: device-busy ms
  by kernel, the device-idle share, and host ms per solver iteration;
* times the serve path's kernels on the same 8,192 series under the
  default ``ProphetConfig`` (random parameters from a fixed seed): K1
  ``forward`` at the in-sample + 28-day chunk (8192 x 1969, shared
  seasonal matrix) and at the engine's 32-step chunk (8192 x 32,
  per-series matrix), both mapped to data units, and K2 ``bands`` at
  8192 x 32 x 256 with its own Philox draws, each beside its bound;
* times K3's logistic branch at eval config 4's chunk (8,192 series of
  ``wiki_logistic_like(8192, 1200)`` over the first 1,080 days) in both
  modes, and in value mode on the line search's first trial stack there
  (21 x 8192 rows: 20 rungs and the fallback row around the ridge init)
  and on one of flat growth over config 3's chunk (keys ``k3_stack_*``);
* times K6 ``draws`` at the MCMC path's chunk (512 series of
  ``m5_like(512, 1941, seed=2)`` under config 3, S = 300 draws around
  random parameters from a fixed seed) with its own Philox draws and on
  given draws (keys ``k6_*``);
* times the ADVI step's two kernels at the uncertainty tier's shape
  (``m5_like(30490, 1941, seed=2, with_regressors=False)`` under the
  default ``ProphetConfig``, the last 28 days withheld: T = 1,913, K = 4
  draws, P = 54, random parameters from a fixed seed): K3 in gradient
  mode on the (K B, P) draw stack and K7 ``advi`` (keys ``k3_draw_stack``,
  ``k7_advi``), each beside its bound, and five ``elbo_step`` calls under
  ``torch.profiler``: device ms by kernel, the wall a step, the idle share.

``--only advi`` runs the last item alone (each child then skips the fit
chunk, serving, the stacks and K6).

Give the checkouts as A B B A to see the spread.  Each child prints one
JSON line; the outputs of K1-K4 go to ``--out`` (a temporary directory,
removed at the end, unless given: K1's are ~0.5 GB a child) and the last
lines compare every child's outputs with the first child's (max
|difference| and whether they are the same bits) and print
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

FULL_DAYS = 1941
CHUNK = 8192


def child(out_dir: str, tag: str, only: str = "") -> dict:
    if only == "advi":
        import torch

        from tsspark_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.library()
        build_s = time.perf_counter() - t0
        advi, advi_out = advi_kernels(torch.device("cuda"))
        torch.save(advi_out, os.path.join(out_dir, f"{tag}.pt"))
        return {"tag": tag, "tree": os.getcwd(), "build_s": build_s,
                "advi_kernels": advi}
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tsspark_tpu_torch.data.datasets import m5_like
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import build
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.init import (
        curvature_diag,
        initial_theta,
    )
    from tsspark_tpu_torch.models.prophet.model import _objective
    from tsspark_tpu_torch.ops import lbfgs

    device = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    cfg, solver = configs.CONFIG3, configs.SOLVER3
    batch = m5_like(CHUNK, FULL_DAYS, seed=2)
    split = configs.split_point(FULL_DAYS)
    ds = batch.ds[:split]
    y = np.nan_to_num(batch.y[:, :split])
    m = batch.mask[:, :split]
    r = batch.regressors[:, :split]
    u8 = design._indicator_reg_cols(r)
    data_np, meta = design.prepare_fit_data(ds, y, cfg, mask=m, regressors=r)
    packed, _ = design.pack_fit_data(data_np, meta, ds, reg_u8_cols=u8,
                                     collapse_cap=True)
    data = design.unpack_fit_data(design.packed_to_device(packed, device), u8)
    theta = initial_theta(data, cfg, solver)
    precond = curvature_diag(data, cfg, theta)
    fun, fval, fan = _objective(data, cfg)
    d = (-precond * fun(theta)[1]).contiguous()
    ladder = cs._ladder(CHUNK, device)
    b, t_len = data.t.shape

    f, g = lk.loss(theta, data, cfg)
    v, _ = lk.loss(theta, data, cfg, grad=False)
    fo = fan_k.fan(theta, d, ladder, data, cfg)
    torch.save({"f": f.cpu(), "g": g.cpu(), "v": v.cpu(), "fan": fo.cpu()},
               os.path.join(out_dir, f"{tag}.pt"))
    kernels = {
        "loss_grad": {"ms": cs.cuda_ms(lambda: lk.loss(theta, data, cfg)),
                      **cs.loss_bound_ms(b, b, t_len, cfg, True)},
        "loss_value": {"ms": cs.cuda_ms(lambda: lk.loss(theta, data, cfg,
                                                        grad=False)),
                       **cs.loss_bound_ms(b, b, t_len, cfg, False)},
        "fan": {"ms": cs.cuda_ms(lambda: fan_k.fan(theta, d, ladder, data,
                                                   cfg)),
                **cs.fan_bound_ms(b, t_len, 20, cfg)},
    }
    for k in kernels.values():
        k["share_of_bound"] = k["bound_ms"] / k["ms"]

    theta0 = initial_theta(data, cfg, solver)
    torch.cuda.synchronize()
    lbfgs.timing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res = lbfgs.minimize(fun, theta0, solver, fun_value=fval,
                             precond=precond, fan_value=fan)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = cs._device_events(prof)
    busy = sum(ms for _, ms in top)
    iters = lbfgs.timing.iters
    serve, serve_out = serve_kernels(batch, device)
    stack, stack_out = stack_kernels(data, device)
    draws, draws_out = draws_kernel(device)
    advi, advi_out = advi_kernels(device)
    saved = torch.load(os.path.join(out_dir, f"{tag}.pt"))
    saved.update(serve_out)
    saved.update(stack_out)
    saved.update(draws_out)
    saved.update(advi_out)
    torch.save(saved, os.path.join(out_dir, f"{tag}.pt"))
    return {
        "tag": tag, "tree": os.getcwd(), "build_s": build_s,
        "shape": [b, t_len, cfg.num_params], "kernels": kernels,
        "serve_kernels": serve, "stack_kernels": stack,
        "draws_kernel": draws, "advi_kernels": advi,
        "chunk_solve": {
            "iterations": int(res.n_iters.max()), "traced_wall_s": traced,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / 1e3 / traced,
            "host_ms_per_iteration": 1e3 * lbfgs.timing.body_s / max(iters, 1),
            "top_device_ms": [(k[:60], ms) for k, ms in top[:6]],
        },
    }


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms from ``torch.profiler`` (the host's
    launch cost between back-to-back calls left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms in cs._device_events(prof)) / iters


def _trial_stack(data, cfg, solver, device, k_steps=20):
    """The ridge init and the line search's (K + 1) B trial stack there
    (``chip_smoke.line_search_stack``, which older checkouts' chip_smoke
    lacks)."""
    import torch

    from tsspark_tpu_torch.models.prophet.init import (
        curvature_diag,
        initial_theta,
    )
    from tsspark_tpu_torch.models.prophet.model import _objective

    theta0 = initial_theta(data, cfg, solver)
    precond = curvature_diag(data, cfg, theta0)
    fun, _, _ = _objective(data, cfg)
    d = (-precond * fun(theta0)[1]).contiguous()
    steps = 0.5 ** torch.arange(k_steps, dtype=torch.float32, device=device)
    return theta0, torch.cat([
        (theta0[None] + steps[:, None, None] * d[None])
        .reshape(-1, cfg.num_params), theta0]).contiguous()


def stack_kernels(data3, device):
    """K3's logistic branch at config 4's chunk (both modes) and its value
    mode on the line search's trial stacks of config 4 and of flat growth
    over config 3's chunk ``data3``: times beside bounds, and outputs."""
    import dataclasses

    import chip_smoke as cs
    from tsspark_tpu_torch.data.datasets import wiki_logistic_like
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design

    batch = wiki_logistic_like(CHUNK, 1200, seed=3)
    cfg, solver = configs.CONFIG4, configs.SOLVER4
    split = configs.split_point(1200)
    data_np, meta = design.prepare_fit_data(
        batch.ds[:split], batch.y[:, :split], cfg,
        mask=batch.mask[:, :split], cap=batch.cap[:, :split])
    packed, _ = design.pack_fit_data(data_np, meta, batch.ds[:split])
    data = design.unpack_fit_data(design.packed_to_device(packed, device))
    theta0, trials = _trial_stack(data, cfg, solver, device)
    fcfg = dataclasses.replace(configs.CONFIG3, growth="flat")
    _, ftrials = _trial_stack(data3, fcfg, configs.SOLVER3, device)
    b, t_len = data.t.shape
    b3, t3 = data3.t.shape
    f, g = lk.loss(theta0, data, cfg)
    out = {"k3_logistic_f": f.cpu(), "k3_logistic_g": g.cpu(),
           "k3_logistic_v": lk.loss(theta0, data, cfg, grad=False)[0].cpu(),
           "k3_stack_logistic": lk.loss(trials, data, cfg,
                                        grad=False)[0].cpu(),
           "k3_stack_flat": lk.loss(ftrials, data3, fcfg,
                                    grad=False)[0].cpu()}
    times = {
        "k3_logistic_grad": {
            "ms": cs.cuda_ms(lambda: lk.loss(theta0, data, cfg)),
            **cs.loss_bound_ms(b, b, t_len, cfg, True)},
        "k3_logistic_value": {
            "ms": cs.cuda_ms(lambda: lk.loss(theta0, data, cfg,
                                             grad=False)),
            **cs.loss_bound_ms(b, b, t_len, cfg, False)},
        "k3_stack_logistic": {
            "shape": list(trials.shape) + [t_len],
            "ms": cs.cuda_ms(lambda: lk.loss(trials, data, cfg, grad=False)),
            "device_ms": device_ms(lambda: lk.loss(trials, data, cfg,
                                                   grad=False)),
            **cs.loss_bound_ms(trials.shape[0], b, t_len, cfg, False)},
        "k3_stack_flat": {
            "shape": list(ftrials.shape) + [t3],
            "ms": cs.cuda_ms(lambda: lk.loss(ftrials, data3, fcfg,
                                             grad=False)),
            **cs.loss_bound_ms(ftrials.shape[0], b3, t3, fcfg, False)},
    }
    for k in times.values():
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    return times, out


def draws_kernel(device):
    """K6 at the MCMC path's chunk, on its own Philox draws and on given
    draws: times beside its bound, and outputs."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tsspark_tpu_torch.data.datasets import m5_like
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import draws as dk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data

    cfg = configs.CONFIG3
    b, s = 512, 300
    batch = m5_like(b, FULL_DAYS, seed=2)
    split = configs.split_point(FULL_DAYS)
    _, meta = design.prepare_fit_data(
        batch.ds[:split], np.nan_to_num(batch.y[:, :split]), cfg,
        mask=batch.mask[:, :split], regressors=batch.regressors[:, :split])
    rng = np.random.default_rng(0)
    base = cs.random_theta(rng, b, cfg)
    samples = torch.from_numpy((base[None] + 0.02 * rng.normal(
        0.0, 1.0, (s,) + base.shape)).astype(np.float32)).to(device)
    pdata = prepare_predict_data(batch.ds, meta, cfg, device,
                                 regressors=batch.regressors)
    sc = torch.as_tensor(meta.y_scale, dtype=torch.float32, device=device)
    fl = torch.as_tensor(meta.floor, dtype=torch.float32, device=device)
    variates = bk.sample_draws((s, b, FULL_DAYS), torch.Generator(
        device=device).manual_seed(23), device)
    out = {}
    for name, kw in (("k6_philox", {"seed": 1}),
                     ("k6_given", {"variates": variates})):
        got = dk.draws(samples, pdata, sc, fl, cfg, **kw)
        out.update({f"{name}_{k}": v.cpu() for k, v in got.items()})
    times = {
        "k6_philox": {
            "shape": [b, FULL_DAYS, s],
            "ms": cs.cuda_ms(lambda: dk.draws(samples, pdata, sc, fl, cfg,
                                              seed=1), iters=10),
            **cs.draws_bound_ms(b, FULL_DAYS, s, cfg)},
        "k6_given": {
            "ms": cs.cuda_ms(lambda: dk.draws(samples, pdata, sc, fl, cfg,
                                              variates=variates), iters=10)},
    }
    times["k6_philox"]["share_of_bound"] = \
        times["k6_philox"]["bound_ms"] / times["k6_philox"]["ms"]
    return times, out


def advi_kernels(device):
    """K3 on the ADVI draw stack and K7 at the uncertainty tier's shape,
    and five ADVI steps under the profiler: times beside bounds, and
    outputs (K3's f and g on the stack, K7's loss and updated state)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tsspark_tpu_torch.config import AdviConfig, ProphetConfig
    from tsspark_tpu_torch.data.datasets import m5_like
    from tsspark_tpu_torch.kernels import advi as advi_k
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.uncertainty import advi as advi_mod

    cfg, advi = ProphetConfig(), AdviConfig()
    batch = m5_like(30490, FULL_DAYS, seed=2, with_regressors=False)
    cut = FULL_DAYS - 28
    data_np, _ = design.prepare_fit_data(
        batch.ds[:cut], np.nan_to_num(batch.y[:, :cut]), cfg,
        mask=batch.mask[:, :cut])
    data = design.fitdata_to_device(data_np, device)
    del data_np
    b, t_len = data.t.shape
    k_draws, p = advi.num_elbo_samples, cfg.num_params
    theta = torch.from_numpy(cs.random_theta(np.random.default_rng(0), b,
                                             cfg)).to(device)
    state = advi_mod.init_state(theta, advi)
    eps = torch.randn((k_draws, b, p), device=device,
                      generator=torch.Generator(device=device)
                      .manual_seed(0))
    sd, stack = advi_mod._stack(state.mu, state.rho, eps)
    f, g = lk.loss(stack, data, cfg)
    sc = advi_k.adam_scalars(advi, 0)
    after = [x.clone() for x in state]
    loss = advi_k.advi_step(g, f, eps, sd, *after, sc)
    out = {"k3_draw_stack_f": f.cpu(), "k3_draw_stack_g": g.cpu(),
           "k7_loss": loss.cpu()}
    out.update({f"k7_{name}": x.cpu() for name, x in
                zip(advi_mod.AdviState._fields, after)})
    tmp = [x.clone() for x in state]
    times = {
        "k3_draw_stack": {
            "shape": [k_draws * b, t_len, p],
            "ms": cs.cuda_ms(lambda: lk.loss(stack, data, cfg), iters=10),
            **cs.loss_bound_ms(k_draws * b, b, t_len, cfg, True)},
        "k7_advi": {
            "shape": [k_draws, b, p],
            "ms": cs.cuda_ms(lambda: advi_k.advi_step(g, f, eps, sd, *tmp,
                                                      sc)),
            **cs.advi_bound_ms(k_draws, b, p)},
    }
    for k in times.values():
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    # The step's other device work, event-timed: the draws and the stack.
    rest_ms = cs.cuda_ms(lambda: torch.randn(
        (k_draws, b, p), generator=torch.Generator(device=device),
        device=device)) + cs.cuda_ms(
            lambda: advi_mod._stack(state.mu, state.rho, eps))
    cp = advi_mod.AdviState(*[x.clone() for x in state])
    gen = torch.Generator(device=device).manual_seed(1)
    for i in range(2):
        advi_mod.elbo_step(cp, data, cfg, torch.randn(
            (k_draws, b, p), generator=gen, device=device), i, advi)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(2, 7):
            advi_mod.elbo_step(cp, data, cfg, torch.randn(
                (k_draws, b, p), generator=gen, device=device), i, advi)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = cs._device_events(prof)
    busy = sum(ms for _, ms in top)
    t1 = time.perf_counter()
    for i in range(7, 27):
        advi_mod.elbo_step(cp, data, cfg, torch.randn(
            (k_draws, b, p), generator=gen, device=device), i, advi)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t1) / 20
    times["step"] = {
        "wall_ms": wall_ms,
        "event_timed_parts_ms": times["k3_draw_stack"]["ms"]
        + times["k7_advi"]["ms"] + rest_ms,
        "rest_event_timed_ms": rest_ms,
        "profiled_steps": 5, "traced_wall_ms_per_step": 1e3 * traced / 5,
        "device_busy_ms_per_step": busy / 5 if top else "not measured",
        "device_idle_share": (1.0 - busy / 1e3 / traced if top else
                              "not measured: no device event recorded"),
        "top_device_ms_per_step": [(k[:60], ms / 5) for k, ms in top[:8]]}
    return times, out


def serve_kernels(batch, device):
    """K1 at both serve shapes and K2 at the sampled chunk: times beside
    their bounds, and the outputs on the host."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data

    cfg = ProphetConfig()
    _, meta = prepare_fit_data(batch.ds, batch.y, cfg)
    theta = torch.from_numpy(
        cs.random_theta(np.random.default_rng(0), CHUNK, cfg)).to(device)
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32, device=device)
    floor = torch.as_tensor(meta.floor, dtype=torch.float32, device=device)
    ds_full = np.concatenate([batch.ds, batch.ds[-1] + np.arange(1, 29)])
    full = prepare_predict_data(ds_full, meta, cfg, device)
    last = meta.ds_start + meta.ds_span
    eng = prepare_predict_data(last[:, None] + np.arange(1, 33)[None, :],
                               meta, cfg, device)
    out, times = {}, {}
    for name, data in (("k1_shared", full), ("k1_per_series", eng)):
        b, t_len = data.t.shape
        got = fk.forward(theta, data, cfg, scale, floor)
        out.update({f"{name}_{k}": v.cpu() for k, v in zip(
            ("yhat", "trend", "add", "mult"), got)})
        times[name] = {
            "shape": [b, t_len],
            "ms": cs.cuda_ms(lambda: fk.forward(theta, data, cfg, scale,
                                                floor)),
            "device_ms": device_ms(lambda: fk.forward(theta, data, cfg,
                                                      scale, floor)),
            **cs.forward_bound_ms(b, t_len, cfg, data.X_season.ndim == 3,
                                  True)}
    _, det, add, mult = fk.forward(theta, eng, cfg)
    kargs = (theta, eng, det, add, mult, scale, floor, cfg, 256)
    got = bk.bands(*kargs, seed=1)
    out.update({f"k2_{k}": v.cpu() for k, v in got.items()})
    times["k2_philox"] = {
        "shape": [CHUNK, 32, 256],
        "ms": cs.cuda_ms(lambda: bk.bands(*kargs, seed=1)),
        "device_ms": device_ms(lambda: bk.bands(*kargs, seed=1)),
        **cs.bands_bound_ms(CHUNK, 32, 256, cfg)}
    for k in times.values():
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    return times, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="", choices=("", "advi"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        out_dir = os.path.abspath(args.out)
        print(json.dumps(child(out_dir, args.child, args.only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    out_dir = (os.path.abspath(args.out) if args.out
               else tempfile.mkdtemp(prefix="kernel_ab_"))
    os.makedirs(out_dir, exist_ok=True)
    try:
        return compare(args.trees, out_dir, args.only)
    finally:
        if not args.out:
            shutil.rmtree(out_dir, ignore_errors=True)


def compare(trees, out_dir, only: str = "") -> int:
    import torch

    tags = []
    for n, tree in enumerate(trees):
        tree = os.path.abspath(tree)
        tag = f"{n}_{os.path.basename(tree.rstrip('/'))}"
        env = dict(os.environ, PYTHONPATH=tree)
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tag,
             "--out", out_dir, "--only", only], cwd=tree, env=env,
            capture_output=True,
            text=True)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-4000:])
            return run.returncode
        tags.append(tag)
    ref = torch.load(os.path.join(out_dir, f"{tags[0]}.pt"))
    diffs, same = {}, {}
    for tag in tags[1:]:
        got = torch.load(os.path.join(out_dir, f"{tag}.pt"))
        diffs[tag] = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
        same[tag] = {k: bool(torch.equal(got[k].view(torch.int32),
                                         ref[k].view(torch.int32)))
                     for k in ref}
    print(json.dumps({"max_abs_diff_vs": tags[0], "diffs": diffs}))
    print(json.dumps({"same_bits_as": tags[0], "same_bits": same}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
