"""CPU-vs-card parity audit over the evaluation configs.

The baseline's criterion is "sMAPE parity vs CPU" (BASELINE.json:2): the
batched solver must reproduce the per-series scipy oracle's accuracy, not
just run fast.  This module fits eval configs 1-4 (``eval/configs.py``)
through BOTH backends on identical data and reports per-config in-sample
and holdout sMAPE for each backend plus the per-series worst deviation.

The record keeps the JAX package's keys, so the two packages' audits
compare key by key: the ``*_tpu`` keys hold the batched leg, which here
is the ``cuda`` backend on ``device`` (the card by default; ``"cpu"``
runs its plain PyTorch path).

The CPU oracle is a per-series Python loop, so ``scale`` keeps its cost
bounded; parity is a per-series property, so a representative subsample
is as informative as the full batch.

Usage:  python -m tsspark_tpu_torch.eval.parity [--scale S] [--out FILE]
            [--configs NAME ...] [--device D]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np

from tsspark_tpu_torch.backends.cuda import _concat_states, _take_rows
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.eval import configs, metrics


def _case_configs(scale: float):
    """The four fit configs (5 is streaming; its parity is covered by the
    warm-start tests) with datasets sized for a tractable scipy oracle."""
    return {
        "config1_peyton": (
            datasets.peyton_manning_like(n_days=max(400, int(2905 * scale))),
            configs.CONFIG1,
            configs.SOLVER1,
        ),
        "config2_m4_hourly": (
            datasets.m4_hourly_like(n_series=max(8, int(414 * scale))),
            configs.CONFIG2,
            configs.SOLVER2,
        ),
        "config3_m5": (
            datasets.m5_like(n_series=max(16, int(30490 * scale))),
            configs.CONFIG3,
            configs.SOLVER3,
        ),
        "config4_wiki_logistic": (
            datasets.wiki_logistic_like(n_series=max(4, int(8 * scale * 8))),
            configs.CONFIG4,
            configs.SOLVER4,
        ),
    }


def _smape_per_series(cfg, solver, batch, backend: str, holdout_frac=0.1,
                      transfer_chunk: int = 2048, **backend_kwargs):
    """Fit on the train window, score per-series sMAPE on train + holdout.

    Both legs stream through host-side series chunks of
    ``transfer_chunk``.  The batched leg wrap-pads its tail chunk with
    duplicate rows, as the JAX package's audit does (one program shape
    for every chunk there; here it keeps a series' batch the same in
    both packages' audits), and slices them away; the CPU oracle is a
    per-series loop and takes the exact tail.  Returns (train sMAPE,
    holdout sMAPE, fit seconds)."""
    t_len = batch.y.shape[1]
    split = int(t_len * (1 - holdout_frac))
    bk = get_backend(backend, cfg, solver, **backend_kwargs)
    b = batch.y.shape[0]
    chunk = min(transfer_chunk, b)
    wrap_tail = backend != "cpu"

    def tail_idx(lo):
        hi = min(lo + chunk, b)
        if wrap_tail and hi - lo < chunk:
            return np.arange(lo, lo + chunk) % b, hi - lo
        return np.arange(lo, hi), hi - lo

    ds_train = batch.ds[:split]
    t0 = time.time()
    states = []
    for lo in range(0, b, chunk):
        idx, n_real = tail_idx(lo)
        kw = {}
        if batch.cap is not None:
            kw["cap"] = batch.cap[idx][:, :split]
        if batch.regressors is not None:
            kw["regressors"] = batch.regressors[idx][:, :split]
        st = bk.fit(ds_train, np.nan_to_num(batch.y[idx][:, :split]),
                    mask=batch.mask[idx][:, :split], **kw)
        states.append(_take_rows(st, slice(0, n_real)))
    state = states[0] if len(states) == 1 else _concat_states(states)
    fit_s = time.time() - t0

    tr, ho = [], []
    for lo in range(0, b, chunk):
        idx, n_real = tail_idx(lo)
        st = _take_rows(state, idx)
        pkw = {}
        if batch.cap is not None:
            pkw["cap"] = batch.cap[idx]
        if batch.regressors is not None:
            pkw["regressors"] = batch.regressors[idx]
        fc = bk.predict(st, batch.ds, num_samples=0, **pkw)
        y = np.nan_to_num(batch.y[idx])
        m_tr = batch.mask[idx].copy()
        m_tr[:, split:] = 0.0
        m_ho = batch.mask[idx].copy()
        m_ho[:, :split] = 0.0
        tr.append(metrics.smape(y, fc["yhat"], m_tr)[:n_real])
        ho.append(metrics.smape(y, fc["yhat"], m_ho)[:n_real])
    return np.concatenate(tr), np.concatenate(ho), fit_s


def _delta_dist(deltas: np.ndarray) -> Dict:
    """Per-series |delta sMAPE| distribution (the parity gate statistic)."""
    a = np.abs(deltas)
    return {
        "p50": round(float(np.percentile(a, 50)), 4),
        "p95": round(float(np.percentile(a, 95)), 4),
        "max": round(float(a.max()), 4),
    }


def parity_record(tr_cpu, ho_cpu, s_cpu, tr_dev, ho_dev, s_dev) -> Dict:
    """One config's audit record from the two legs' per-series sMAPE."""
    return {
        "n_series": int(len(tr_cpu)),
        "smape_train_cpu": round(float(tr_cpu.mean()), 4),
        "smape_train_tpu": round(float(tr_dev.mean()), 4),
        "delta_train_mean": round(float((tr_dev - tr_cpu).mean()), 4),
        "delta_train_max_abs": round(float(np.abs(tr_dev - tr_cpu).max()),
                                     4),
        "smape_holdout_cpu": round(float(ho_cpu.mean()), 4),
        "smape_holdout_tpu": round(float(ho_dev.mean()), 4),
        "delta_holdout_mean": round(float((ho_dev - ho_cpu).mean()), 4),
        "delta_holdout_max_abs": round(
            float(np.abs(ho_dev - ho_cpu).max()), 4
        ),
        "delta_holdout_dist": _delta_dist(ho_dev - ho_cpu),
        "delta_train_dist": _delta_dist(tr_dev - tr_cpu),
        "fit_seconds_cpu": round(s_cpu, 2),
        "fit_seconds_tpu": round(s_dev, 2),
    }


def run_parity(scale: float = 0.01, configs=None,
               device: Optional[str] = None) -> Dict:
    """``configs``: optional iterable of case names (run_parity's keys)
    to restrict to.  ``device``: the batched leg's device (None: the
    card, which raises without one)."""
    out = {}
    for name, (batch, cfg, solver) in _case_configs(scale).items():
        if configs and name not in configs:
            continue
        cpu = _smape_per_series(cfg, solver, batch, "cpu")
        dev = _smape_per_series(cfg, solver, batch, "cuda", device=device)
        out[name] = parity_record(*cpu, *dev)
    return out


def run_config3_at_scale(
    n_series: int = 30490, oracle_n: int = 512, seed: int = 0,
    chunk_size: int = 2048, iter_segment: int = 24,
    device: Optional[str] = None,
) -> Dict:
    """Bench-scale parity for eval config 3: the batched solver fits the
    FULL series batch; the scipy oracle runs on a random subsample, and
    the per-series holdout |delta sMAPE| distribution over that subsample
    is the gate statistic."""
    cfg, solver = configs.CONFIG3, configs.SOLVER3
    batch = datasets.m5_like(n_series=n_series)
    tr_dev, ho_dev, s_dev = _smape_per_series(
        cfg, solver, batch, "cuda", transfer_chunk=chunk_size,
        chunk_size=chunk_size, iter_segment=iter_segment, device=device,
    )
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n_series, size=min(oracle_n, n_series),
                             replace=False))
    sub = batch._replace(
        y=batch.y[idx], mask=batch.mask[idx],
        series_ids=batch.series_ids[idx],
        cap=None if batch.cap is None else batch.cap[idx],
        regressors=None if batch.regressors is None
        else batch.regressors[idx],
    )
    tr_cpu, ho_cpu, s_cpu = _smape_per_series(cfg, solver, sub, "cpu")
    return {
        "n_series_tpu": n_series,
        "n_series_oracle": int(idx.size),
        "smape_holdout_tpu_full": round(float(ho_dev.mean()), 4),
        "smape_holdout_tpu_sub": round(float(ho_dev[idx].mean()), 4),
        "smape_holdout_cpu_sub": round(float(ho_cpu.mean()), 4),
        "delta_holdout_dist": _delta_dist(ho_dev[idx] - ho_cpu),
        "delta_train_dist": _delta_dist(tr_dev[idx] - tr_cpu),
        "fit_seconds_tpu_full": round(s_dev, 2),
        "fit_seconds_cpu_sub": round(s_cpu, 2),
    }


def platform_name(device: Optional[str]) -> str:
    """The batched leg's device, named as the record's ``platform``."""
    import torch

    from tsspark_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--out", default=None)
    ap.add_argument("--configs", action="append", default=None,
                    help="restrict to these config names (repeatable; "
                         "default: all four)")
    ap.add_argument("--config3-full", action="store_true",
                    help="additionally run the bench-scale config-3 parity "
                         "(full batch vs oracle subsample)")
    ap.add_argument("--oracle-n", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="the batched leg's device (default: "
                         "$TSSPARK_DEVICE, else the card)")
    args = ap.parse_args(argv)
    if args.device is None:
        from tsspark_tpu_torch.utils.platform import honor_env_platforms

        args.device = str(honor_env_platforms())

    from tsspark_tpu_torch.config import NUMERICS_REV
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.history import git_rev

    result = {
        "kind": "eval-parity",
        "unix": round(time.time(), 3),
        "trace_id": obs.trace_id() or obs.new_id(),
        "git_rev": git_rev(),
        "numerics_rev": NUMERICS_REV,
        "platform": platform_name(args.device),
        "scale": args.scale,
        "configs": run_parity(args.scale, configs=args.configs,
                              device=args.device),
    }
    if args.config3_full:
        result["config3_bench_scale"] = run_config3_at_scale(
            oracle_n=args.oracle_n, device=args.device,
        )
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
