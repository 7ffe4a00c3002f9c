#!/usr/bin/env python3
"""Where config 4's card fit parts from the plain CPU fit: which piece of K3.

    python3 scripts/torch_fit4_gap.py [--probe] [--out DIR]

Eval config 4 at 8,192 series (``wiki_logistic_like(8192, 1200)``, the
batch ``chip_smoke.py``'s ``fit_logistic`` phase fits on its first 1,080
days), and its 64-series parity subset (``chip_smoke.fit4_subset``).
The subset is fitted on the CPU with the plain loss (the reference of
``chip_smoke.LIMITS4``) and then on the card through ``CudaBackend.fit``
in five ways, the objective swapped in this script only (the package
has no switch for it):

* ``card_8192``: K3 for values and gradients, the whole batch, the
  subset's rows read out (what ``chip_smoke.py`` holds);
* ``card``: the same on the 64 series alone;
* ``a_plain``: ``loss_plain`` on the card's tensors for both;
* ``b_k3_grad``: K3's gradients beside the plain values (the gradient
  mode's value and every value-mode call plain);
* ``c_k3_value``: the plain gradients beside K3's values.

Each prints the loss gap to the plain CPU fit per series (mean, min,
max, counts past +-0.05: ``chip_smoke.loss_parity``'s readings), status
counts and the fit's seconds; a JSON line each, all of them also in
``DIR/fit4_gap.json`` with ``--out DIR``.

``--probe`` runs none of those fits; it asks where a subset row's card
fit first depends on the batch around it: the subset's rows prepared,
warm-started (ridge init and curvature metric), solved without the
rescue pass, and solved with it, alone and within the 8,192-row batch,
compared stage by stage (same bits, and the largest difference).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _swapped(kind, kernel):
    """A stand-in for ``kernels.loss.loss`` (``kernel``) mixing K3 and its
    plain version on the card's tensors by ``kind``."""
    from tsspark_tpu_torch.kernels import loss as lk

    def objective(theta, data, config, grad=True):
        if kind == "a_plain":
            return lk.loss_plain(theta, data, config, grad)
        if kind == "b_k3_grad":
            f_p, _ = lk.loss_plain(theta, data, config, grad=False)
            if not grad:
                return f_p, None
            return f_p, kernel(theta, data, config, grad=True)[1]
        if kind == "c_k3_value":
            if not grad:
                return kernel(theta, data, config, grad=False)
            f_k, _ = kernel(theta, data, config, grad=False)
            return f_k, lk.loss_plain(theta, data, config, grad=True)[1]
        raise ValueError(kind)

    return objective


def probe() -> int:
    """See the module docstring (``--probe``)."""
    import torch

    import chip_smoke as cs
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.data.datasets import wiki_logistic_like
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.init import (
        curvature_diag,
        initial_theta,
    )

    cfg, solver = configs.CONFIG4, configs.SOLVER4
    batch = wiki_logistic_like(cs.C4_SERIES, cs.C4_DAYS)
    split = configs.split_point(cs.C4_DAYS)
    ds = batch.ds[:split]
    y, m, cap = batch.y[:, :split], batch.mask[:, :split], \
        batch.cap[:, :split]
    idx = cs.fit4_subset()
    dev = torch.device("cuda")
    stages = {}

    def warm(rows):
        data_np, meta = design.prepare_fit_data(ds, y[rows], cfg,
                                                mask=m[rows], cap=cap[rows])
        data = design.fitdata_to_device(data_np, dev)
        theta0 = initial_theta(data, cfg, solver)
        return (data_np, meta, theta0, curvature_diag(data, cfg, theta0))

    full, alone = warm(np.arange(cs.C4_SERIES)), warm(idx)
    pairs = {
        "prep_t": (full[0].t[idx], alone[0].t),
        "prep_y": (full[0].y[idx], alone[0].y),
        "changepoints": (full[1].changepoints[idx], alone[1].changepoints),
        "ridge_init": (full[2][idx].cpu().numpy(), alone[2].cpu().numpy()),
        "curvature": (full[3][idx].cpu().numpy(), alone[3].cpu().numpy()),
    }
    for rescue in (False, True):
        a = get_backend("cuda", cfg, solver, rescue=rescue).fit(
            ds, y, mask=m, cap=cap)
        b = get_backend("cuda", cfg, solver, rescue=rescue).fit(
            ds, y[idx], mask=m[idx], cap=cap[idx])
        tag = "with_rescue" if rescue else "main_solve"
        pairs[f"{tag}_theta"] = (a.theta[idx].numpy(), b.theta.numpy())
        pairs[f"{tag}_loss"] = (a.loss[idx], b.loss)
    for name, (a, b) in pairs.items():
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        stages[name] = {"same_bits": bool(np.array_equal(a, b)),
                        "max_abs_diff": float(np.nanmax(np.abs(a - b))),
                        "rows_differing": int(np.any(
                            a.reshape(len(idx), -1) != b.reshape(len(idx), -1),
                            axis=1).sum())}
    print(json.dumps({"probe": stages}), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.data.datasets import wiki_logistic_like
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import loss as lk

    if not torch.cuda.is_available():
        print("torch_fit4_gap: no CUDA device is available", file=sys.stderr)
        return 2
    if args.probe:
        return probe()
    cfg, solver = configs.CONFIG4, configs.SOLVER4
    batch = wiki_logistic_like(cs.C4_SERIES, cs.C4_DAYS)
    split = configs.split_point(cs.C4_DAYS)
    ds = batch.ds[:split]
    y, m, cap = batch.y[:, :split], batch.mask[:, :split], \
        batch.cap[:, :split]
    idx = cs.fit4_subset()
    sub = dict(mask=m[idx], cap=cap[idx])
    results = []

    def record(name, state, seconds, rows=None):
        loss = state.loss if rows is None else state.loss[rows]
        readings, _ = cs.loss_parity(loss, plain.loss, plain.loss)
        status = np.bincount(np.asarray(state.status if rows is None
                                        else state.status[rows]),
                             minlength=5)
        out = {"fit": name, "seconds": seconds,
               **{k: v for k, v in readings.items() if "oracle" not in k},
               "status_counts": status.tolist()}
        results.append(out)
        print(json.dumps(out), flush=True)

    t0 = time.perf_counter()
    plain = get_backend("cuda", cfg, solver, device="cpu").fit(
        ds, y[idx], **sub)
    plain_s = time.perf_counter() - t0
    print(json.dumps({"fit": "plain_cpu", "seconds": plain_s,
                      "status_counts": np.bincount(
                          np.asarray(plain.status), minlength=5).tolist()}),
          flush=True)

    bk = get_backend("cuda", cfg, solver)
    t0 = time.perf_counter()
    full = bk.fit(ds, y, mask=m, cap=cap)
    record("card_8192", full, time.perf_counter() - t0, rows=idx)
    kernel = lk.loss
    for kind in ("card", "a_plain", "b_k3_grad", "c_k3_value"):
        if kind != "card":
            lk.loss = _swapped(kind, kernel)
        try:
            t0 = time.perf_counter()
            st = get_backend("cuda", cfg, solver).fit(ds, y[idx], **sub)
            torch.cuda.synchronize()
            record(kind, st, time.perf_counter() - t0)
        finally:
            lk.loss = kernel
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fit4_gap.json"), "w") as fh:
            json.dump({"plain_cpu_s": plain_s, "subset": len(idx),
                       "fits": results, "nvidia_smi": cs.smi_line()}, fh,
                      indent=1)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
