"""Command-line interface: fit / predict / backtest over CSV or Parquet.

The port's copy of the JAX package's CLI, over the port's Forecaster:

  python -m tsspark_tpu_torch fit      --input sales.csv --model model.npz
  python -m tsspark_tpu_torch predict  --model model.npz --horizon 28 --output fc.csv
  python -m tsspark_tpu_torch forecast --input sales.csv --horizon 28 --output fc.csv
  python -m tsspark_tpu_torch backtest --input sales.csv --horizon 14 --output pm.csv

Input is a long frame (series_id, ds, y [, regressors...]).  Model files are
portable .npz checkpoints (utils/checkpoint.py) that either package reads.

Every command runs on the card; ``--device cpu`` runs the plain PyTorch
path instead (the one option the JAX package's CLI lacks: it picks its
platform from the ``JAX_PLATFORMS`` variable).  Without a card and
without ``--device cpu`` the command raises.
"""

from __future__ import annotations

import argparse
import json
import sys


def _read_frame(path: str):
    import pandas as pd

    if path.endswith((".parquet", ".pq")):
        return pd.read_parquet(path)
    return pd.read_csv(path, parse_dates=["ds"])


def _write_frame(df, path: str) -> None:
    if path == "-":
        df.to_csv(sys.stdout, index=False)
    elif path.endswith((".parquet", ".pq")):
        df.to_parquet(path, index=False)
    else:
        df.to_csv(path, index=False)


def _build_forecaster(args, df=None):
    from tsspark_tpu_torch import (
        DAILY,
        Forecaster,
        ProphetConfig,
        SeasonalityConfig,
        SolverConfig,
        WEEKLY,
        YEARLY,
        country_holidays,
    )

    named = {"yearly": YEARLY, "weekly": WEEKLY, "daily": DAILY}
    seas = []
    for spec in args.seasonality:
        if spec in named:
            seas.append(named[spec])
        else:  # name:period:order
            name, period, order = spec.split(":")
            seas.append(SeasonalityConfig(name, float(period), int(order)))
    holidays = ()
    if args.country_holidays:
        import pandas as pd

        if df is not None:
            years = range(
                pd.to_datetime(df["ds"]).dt.year.min(),
                pd.to_datetime(df["ds"]).dt.year.max() + 2,
            )
        else:
            years = range(2015, 2031)
        holidays = country_holidays(args.country_holidays, years=years)
    cfg = ProphetConfig(
        growth=args.growth,
        n_changepoints=args.n_changepoints,
        changepoint_prior_scale=args.changepoint_prior_scale,
        seasonalities=tuple(seas),
        seasonality_mode=args.seasonality_mode,
        interval_width=args.interval_width,
    )
    return Forecaster(
        cfg,
        backend=args.backend,
        holidays=holidays,
        regressor_cols=tuple(args.regressor),
        cap_col="cap" if args.growth == "logistic" else None,
        solver_config=SolverConfig(max_iters=args.max_iters),
        auto_seasonality=args.auto_seasonality,
        device=args.device,
    )


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", default="cuda", help="forecast backend name")
    p.add_argument("--growth", default="linear",
                   choices=["linear", "logistic", "flat"])
    p.add_argument("--seasonality", action="append",
                   default=None, metavar="NAME[:PERIOD:ORDER]",
                   help="repeatable; yearly/weekly/daily or custom "
                        "name:period_days:fourier_order")
    p.add_argument("--seasonality-mode", default="additive",
                   choices=["additive", "multiplicative"])
    p.add_argument("--n-changepoints", type=int, default=25)
    p.add_argument("--changepoint-prior-scale", type=float, default=0.05)
    p.add_argument("--interval-width", type=float, default=0.8)
    p.add_argument("--regressor", action="append", default=[],
                   help="repeatable external regressor column name")
    p.add_argument("--country-holidays", default=None, metavar="CC",
                   help="ISO country code for a computed holiday calendar")
    p.add_argument("--auto-seasonality", action="store_true",
                   help="choose yearly/weekly/daily from the observed "
                        "calendar at fit time (overrides --seasonality)")
    p.add_argument("--max-iters", type=int, default=200)
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the model runs (default: the card; cpu runs "
                        "the plain PyTorch path)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tsspark_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_fit = sub.add_parser("fit", help="fit and save a model checkpoint")
    p_fit.add_argument("--input", required=True)
    p_fit.add_argument("--model", required=True, help="output .npz path")
    _add_model_args(p_fit)

    p_pred = sub.add_parser("predict", help="forecast from a checkpoint")
    p_pred.add_argument("--model", required=True)
    p_pred.add_argument("--horizon", type=int, required=True)
    p_pred.add_argument("--output", default="-")
    p_pred.add_argument("--include-history", action="store_true")
    _add_device_arg(p_pred)

    p_fc = sub.add_parser("forecast", help="fit + predict in one go")
    p_fc.add_argument("--input", required=True)
    p_fc.add_argument("--horizon", type=int, required=True)
    p_fc.add_argument("--output", default="-")
    p_fc.add_argument("--include-history", action="store_true")
    p_fc.add_argument("--future", default=None,
                      help="future frame with ds + regressor/cap columns")
    _add_model_args(p_fc)

    p_bt = sub.add_parser("backtest",
                          help="rolling-origin CV + performance metrics")
    p_bt.add_argument("--input", required=True)
    p_bt.add_argument("--horizon", type=float, required=True)
    p_bt.add_argument("--period", type=float, default=None)
    p_bt.add_argument("--initial", type=float, default=None)
    p_bt.add_argument("--output", default="-",
                      help="performance-metrics table destination")
    p_bt.add_argument("--cv-output", default=None,
                      help="optionally also write the raw CV frame")
    _add_model_args(p_bt)

    args = ap.parse_args(argv)
    if getattr(args, "seasonality", None) is None:
        args.seasonality = ["yearly", "weekly"]

    if args.cmd == "fit":
        from tsspark_tpu_torch.utils import checkpoint

        df = _read_frame(args.input)
        fc = _build_forecaster(args, df)
        fc.fit(df)
        checkpoint.save_forecaster(args.model, fc)
        print(json.dumps({"saved": args.model,
                          "n_series": len(fc.series_ids)}))
        return 0

    if args.cmd == "predict":
        from tsspark_tpu_torch.utils import checkpoint

        fc = checkpoint.load_forecaster(args.model, device=args.device)
        out = fc.predict(horizon=args.horizon,
                         include_history=args.include_history)
        _write_frame(out, args.output)
        return 0

    if args.cmd == "forecast":
        df = _read_frame(args.input)
        fc = _build_forecaster(args, df)
        fc.fit(df)
        future = _read_frame(args.future) if args.future else None
        out = fc.predict(horizon=args.horizon, future_df=future,
                         include_history=args.include_history)
        _write_frame(out, args.output)
        return 0

    if args.cmd == "backtest":
        from tsspark_tpu_torch.eval import diagnostics

        df = _read_frame(args.input)
        fc = _build_forecaster(args, df)
        cv = diagnostics.cross_validation(
            fc, df, horizon=args.horizon,
            period=args.period, initial=args.initial,
        )
        if args.cv_output:
            _write_frame(cv, args.cv_output)
        _write_frame(diagnostics.performance_metrics(cv), args.output)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
