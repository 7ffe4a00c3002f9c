"""The port's streaming refit (eval config 5's driver) against the JAX
package's, on the CPU: ``median_steps``, ``transfer_theta``,
``ParamStore`` (and checkpoints across the two packages),
``StreamingForecaster`` on the same micro-batches, and the sources.

Tolerances, with their reasons:
  * ``median_steps``: bitwise (the same float64 numpy);
  * ``transfer_theta``: rtol/atol 1e-6 — the same float32 operations in
    the same order, the affine maps taken in float64 in both;
  * a micro-batch refit: no series' final loss more than
    ``KEEP_BEST_MARGIN`` (0.05 nats) above the JAX package's — two
    float32 lockstep solvers of another reduction order stop apart by
    float32 noise, and the port may stop lower — and the 7-day forecast
    within 2e-3 of y's scale;
  * warm and cold start counts: equal.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from tsspark_tpu.config import ProphetConfig as JConfig  # noqa: E402
from tsspark_tpu.config import SeasonalityConfig as JSeason  # noqa: E402
from tsspark_tpu.config import SolverConfig as JSolver  # noqa: E402
from tsspark_tpu.models.prophet import design as jdesign  # noqa: E402
from tsspark_tpu.models.prophet import loss as jloss  # noqa: E402
from tsspark_tpu.models.prophet.model import ProphetModel as JModel  # noqa: E402
from tsspark_tpu.streaming import driver as jdriver  # noqa: E402
from tsspark_tpu.streaming import state as jstate  # noqa: E402
from tsspark_tpu.streaming import warmstart as jwarm  # noqa: E402
from tsspark_tpu_torch.backends.registry import get_backend  # noqa: E402
from tsspark_tpu_torch.config import ProphetConfig  # noqa: E402
from tsspark_tpu_torch.config import SeasonalityConfig, SolverConfig  # noqa: E402
from tsspark_tpu_torch.models.prophet.design import prepare_fit_data  # noqa: E402
from tsspark_tpu_torch.models.prophet.model import (  # noqa: E402
    KEEP_BEST_MARGIN,
    ProphetModel,
)
from tsspark_tpu_torch.obs import context as obs  # noqa: E402
from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS  # noqa: E402
from tsspark_tpu_torch.resilience import faults  # noqa: E402
from tsspark_tpu_torch.resilience.policy import (  # noqa: E402
    CircuitBreaker,
    CircuitOpen,
    RetryPolicy,
)
from tsspark_tpu_torch.streaming.driver import (  # noqa: E402
    StreamingForecaster,
    median_steps,
)
from tsspark_tpu_torch.streaming.source import (  # noqa: E402
    InMemorySource,
    KafkaSource,
    ResilientSource,
)
from tsspark_tpu_torch.streaming.state import ParamStore  # noqa: E402
from tsspark_tpu_torch.streaming.warmstart import transfer_theta  # noqa: E402

pytestmark = pytest.mark.filterwarnings("error::RuntimeWarning")

CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=5)
JCFG = JConfig(seasonalities=(JSeason("weekly", 7.0, 2),), n_changepoints=5)
SOLVER = SolverConfig(max_iters=40)
JSOLVER = JSolver(max_iters=40)
FORECAST_TOL = 2e-3  # of y's scale
# A package's reported loss against the JAX objective at its theta: the
# same float32 sums in another order (the losses here are -300 to -700).
REPORT_RTOL = 1e-5


def _series_df(n_days, sid="s0", seed=0, start_day=0, level=10.0):
    rng = np.random.default_rng(seed)
    t = np.arange(start_day, start_day + n_days, dtype=float)
    y = (level + 0.02 * t + 1.5 * np.sin(2 * np.pi * t / 7)
         + rng.normal(0, 0.1, n_days))
    return pd.DataFrame({"series_id": sid, "ds": t, "y": y})


def _batches():
    """a, b from day 0; then a's next 30 days and c new midstream; then
    30 more days of all three."""
    return [
        pd.concat([_series_df(150, "a", 1), _series_df(150, "b", 2,
                                                       level=40.0)]),
        pd.concat([_series_df(30, "a", 1, 150),
                   _series_df(160, "c", 4, level=25.0)]),
        pd.concat([_series_df(30, "a", 1, 180),
                   _series_df(30, "b", 2, 150, level=40.0),
                   _series_df(30, "c", 4, 160, level=25.0)]),
    ]


def _capture(sf):
    """Record every fit the driver's backend makes: ((grid, y), FitState)."""
    states, fit = [], sf.backend.fit

    def wrapped(*a, **k):
        states.append((a[:2], fit(*a, **k)))
        return states[-1][1]

    sf.backend.fit = wrapped
    return states


@pytest.fixture(scope="module")
def streams():
    """The same three micro-batches through both packages' drivers."""
    jsf = jdriver.StreamingForecaster(JCFG, JSOLVER, backend="tpu")
    tsf = StreamingForecaster(CFG, SOLVER, device="cpu")
    js, ts = _capture(jsf), _capture(tsf)
    counts = []
    for b in _batches():
        jsf.process(b)
        tsf.process(b)
        counts.append(((jsf.stats.warm_starts, jsf.stats.cold_starts),
                       (tsf.stats.warm_starts, tsf.stats.cold_starts)))
    ids = ["a", "b", "c"]
    return dict(jsf=jsf, tsf=tsf, js=js, ts=ts, counts=counts,
                fj=jsf.forecast(ids, horizon=7, num_samples=0),
                ft=tsf.forecast(ids, horizon=7, num_samples=0))


# -- median_steps, transfer_theta -------------------------------------------


def test_median_steps_bitwise():
    rng = np.random.default_rng(0)
    grid = np.cumsum(rng.choice([1.0, 1.0 / 24, 7.0], 90)) + 18000.0
    y = rng.normal(size=(6, 90))
    y[rng.uniform(size=y.shape) < 0.4] = np.nan
    y[4] = np.nan
    y[5, 1:] = np.nan  # one observation: the daily default
    got = median_steps(grid, y)
    assert np.array_equal(got, jdriver.median_steps(grid, y))
    assert got[4] == 1.0 and got[5] == 1.0


def _metas(growth, b=8, seed=0):
    """Two metas of the same series: an old window and a new one that
    slides forward and extends (more changepoints pass, scales move), and
    zero-filled rows (series the store does not know)."""
    cfg = ProphetConfig(growth=growth, n_changepoints=6,
                        changepoint_placement="quantile" if seed else
                        "uniform",
                        seasonalities=(SeasonalityConfig("weekly", 7.0, 2),
                                       SeasonalityConfig("monthly", 30.5, 2,
                                                         mode="multiplicative")))
    rng = np.random.default_rng(seed)
    ds = 19000.0 + np.arange(400, dtype=np.float64)
    y = 30 + 0.05 * np.arange(400) + rng.normal(0, 2, (b, 400)) \
        + rng.uniform(0, 20, (b, 1))
    y[:, :40][rng.uniform(size=(b, 40)) < 0.5] = np.nan
    kw = lambda lo, hi: {"cap": np.full((b, hi - lo), 120.0)} \
        if growth == "logistic" else {}  # noqa: E731
    _, old = prepare_fit_data(ds[:300], y[:, :300], cfg, **kw(0, 300))
    _, new = prepare_fit_data(ds[120:], y[:, 120:] * 1.3, cfg, **kw(120, 400))
    theta = rng.normal(0, 0.2, (b, cfg.num_params)).astype(np.float32)
    theta[:, 0] = rng.uniform(0.2, 1.5, b)
    theta[:, 1] = rng.uniform(0.1, 0.6, b)
    unknown = [1, 5]
    theta[unknown] = 0.0
    old = old._replace(**{f: np.where(
        np.isin(np.arange(b), unknown).reshape((b,) + (1,) * (
            np.ndim(getattr(old, f)) - 1)), 0.0, getattr(old, f))
        for f in old._fields})
    return cfg, theta, old, new


@pytest.mark.parametrize("growth", ["linear", "logistic"])
@pytest.mark.parametrize("seed", [0, 3])
def test_transfer_theta_matches_jax(growth, seed):
    cfg, theta, old, new = _metas(growth, seed=seed)
    jc = JConfig(growth=growth, n_changepoints=6,
                 changepoint_placement=cfg.changepoint_placement,
                 seasonalities=(JSeason("weekly", 7.0, 2),
                                JSeason("monthly", 30.5, 2,
                                        mode="multiplicative")))
    got = transfer_theta(torch.from_numpy(theta), old, new, cfg)
    want = np.asarray(jwarm.transfer_theta(jnp.asarray(theta), old, new, jc))
    assert got.dtype == torch.float32 and got.shape == theta.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_transfer_theta_runs_on_the_requested_device():
    cfg, theta, old, new = _metas("linear")
    on = transfer_theta(torch.from_numpy(theta), old, new, cfg,
                        device="cpu")
    assert on.device.type == "cpu"
    assert torch.equal(on, transfer_theta(torch.from_numpy(theta), old, new,
                                          cfg))


# -- ParamStore ----------------------------------------------------------------


def _fit_one(n=100, sid_seed=0):
    df = _series_df(n, seed=sid_seed)
    return ProphetModel(CFG, SolverConfig(max_iters=30), device="cpu").fit(
        df.ds.to_numpy(), df.y.to_numpy()[None, :])


def test_param_store_lookup_mask():
    store = ParamStore(CFG)
    state = _fit_one()
    store.update(["s0"], state)
    theta, meta, found = store.lookup(["s0", "unknown"])
    assert found.tolist() == [True, False]
    assert theta.dtype == torch.float32
    assert torch.equal(theta[0], state.theta[0])
    assert torch.equal(theta[1], torch.zeros_like(theta[1]))
    assert meta.ds_start.dtype == np.float64 and meta.ds_start[1] == 0.0
    assert "s0" in store and "unknown" not in store
    assert store.lookup(["nope"])[0] is None


def test_param_store_meta_float64_hourly_precision(tmp_path):
    """ds_start is absolute epoch days (~2e4); at hourly cadence float32
    would move it by minutes.  The store and its checkpoint keep float64
    exactly (the counterpart of the JAX package's test)."""
    ds_start = 20650.0 + 1.0 / 24.0
    ds_span = 30.0 + 1.0 / 24.0
    t = ds_start + np.arange(24 * 30, dtype=np.float64) / 24.0
    state = ProphetModel(CFG, SolverConfig(max_iters=5), device="cpu").fit(
        t, (5 + np.sin(2 * np.pi * t))[None, :])
    state = state._replace(meta=state.meta._replace(
        ds_start=np.asarray([ds_start]), ds_span=np.asarray([ds_span])))
    store = ParamStore(CFG)
    store.update(["h0"], state)
    _, meta, found = store.lookup(["h0"])
    assert found.all() and meta.ds_start.dtype == np.float64
    assert float(meta.ds_start[0]) == ds_start
    assert float(np.float32(ds_start)) != ds_start
    store.save(str(tmp_path / "ps"))
    _, meta2, _ = ParamStore.load(str(tmp_path / "ps"), CFG).lookup(["h0"])
    assert float(meta2.ds_start[0]) == ds_start


def _rows_equal(store_a, store_b, ids, p):
    ta, ma, fa = store_a.lookup(ids)
    tb, mb, fb = store_b.lookup(ids)
    assert np.array_equal(fa, fb) and fa.all()
    assert np.array_equal(np.asarray(ta, np.float32),
                          np.asarray(tb, np.float32))
    for f in ma._fields:
        assert np.array_equal(np.asarray(getattr(ma, f)),
                              np.asarray(getattr(mb, f))), f
    assert np.array_equal(store_a.lookup_step(ids), store_b.lookup_step(ids))


def test_checkpoint_carries_across_packages(tmp_path):
    """A store saved by the JAX package loads in the port's, and the
    reverse: the same theta, float64 meta and cadence rows."""
    df = _series_df(120, "x", 3)
    jstate_ = JModel(JCFG, JSolver(max_iters=20)).fit(
        df.ds.to_numpy(), jnp.asarray(df.y.to_numpy()[None, :]))
    js = jstate.ParamStore(JCFG)
    js.update(["x"], jstate_, step=np.asarray([1.0 / 24.0]))
    js.update(["y"], jstate_)
    js.save(str(tmp_path / "jax"))
    ts = ParamStore.load(str(tmp_path / "jax"), CFG)
    _rows_equal(ts, js, ["x", "y"], CFG.num_params)

    tstate = _fit_one(90, 5)
    ts2 = ParamStore(CFG)
    ts2.update(["p"], tstate, step=np.asarray([7.0]))
    ts2.update(["q"], tstate)
    ts2.save(str(tmp_path / "port"))
    js2 = jstate.ParamStore.load(str(tmp_path / "port"), JCFG)
    _rows_equal(ts2, js2, ["p", "q"], CFG.num_params)


def test_publish_into_the_ports_registry(tmp_path):
    from tsspark_tpu_torch.serve import ParamRegistry

    store = ParamStore(CFG)
    st = _fit_one()
    store.update(["b"], st, step=np.asarray([0.5]))
    store.update(["a"], st)
    reg = ParamRegistry(str(tmp_path / "reg"), CFG)
    v = store.publish(reg)
    assert v == 1 and reg.active_version() == 1
    snap = reg.load(1)
    assert list(snap.series_ids) == ["a", "b"]
    assert np.array_equal(np.asarray(snap.step), [1.0, 0.5])
    assert torch.equal(torch.as_tensor(snap.state.theta[1]), st.theta[0])


# -- the driver against the JAX package's ----------------------------------


def test_stream_counts_match_jax(streams):
    for (jc, tc) in streams["counts"]:
        assert jc == tc
    assert streams["counts"][-1][1] == (4, 3)  # a twice, b, c warm
    assert len(streams["tsf"].store) == 3


def test_stream_losses_within_keep_best_margin(streams):
    """After every micro-batch both packages' final thetas are scored by
    one objective, the JAX package's loss on the JAX package's FitData
    of that micro-batch: no series' port theta scores more than
    ``KEEP_BEST_MARGIN`` above the JAX package's theta.  Below is no
    fault: the port may stop lower (series a of the second micro-batch:
    0.067 nats lower, where the JAX package's solver stops at its float32
    floor after 28 iterations and the port's after 52).  The loss each
    package reports is held to that objective at its own theta, so a
    port that under-reports its loss fails here too."""
    for (jargs, js), (_, ts) in zip(streams["js"], streams["ts"]):
        jdata, _ = jdesign.prepare_fit_data(*jargs, JCFG)

        def score(theta):
            return np.asarray(jloss.value_batch(
                jnp.asarray(np.asarray(theta, np.float32)), jdata, JCFG),
                np.float64)

        j_at_js, j_at_ts = score(js.theta), score(ts.theta)
        for reported, scored in ((js.loss, j_at_js), (ts.loss, j_at_ts)):
            np.testing.assert_allclose(np.asarray(reported, np.float64),
                                       scored, rtol=REPORT_RTOL)
        gap = j_at_ts - j_at_js
        assert np.all(gap <= KEEP_BEST_MARGIN), gap


def test_stream_forecast_matches_jax(streams):
    fj, ft = streams["fj"], streams["ft"]
    assert set(ft.columns) == set(fj.columns)
    assert np.array_equal(ft.ds.to_numpy(), fj.ds.to_numpy())
    assert (ft.series_id.to_numpy() == fj.series_id.to_numpy()).all()
    scale = np.repeat([16.0, 46.0, 31.0], 7)  # each series' |y| max
    err = np.abs(ft.yhat.to_numpy() - fj.yhat.to_numpy()) / scale
    assert err.max() <= FORECAST_TOL, err.max()


def test_streaming_chunk_kernel_rule(streams):
    """The rule ``chip_smoke`` holds K3 and K4 to on a streaming chunk:
    off the optimum the plain float32 loss, gradient and fan lie well
    inside GAP_RULE of float64 (so the rule is sound there), and one
    dropped cell a row fails it."""
    import chip_smoke
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    tsf = streams["tsf"]
    _, theta_ws, data = chip_smoke.stream_chunk(tsf, _batches()[-1], "cpu")
    held = chip_smoke.hold_stream_kernels(theta_ws, data, CFG, seed=4)
    assert min(held["planted_dropped_cell"].values()) > chip_smoke.GAP_TOL
    theta, d = chip_smoke.off_optimum(theta_ws, 4)
    d64 = data._replace(**{f: getattr(data, f).double()
                           for f in data._fields})
    f32, g32 = lk.loss_plain(theta, data, CFG)
    f64, g64 = lk.loss_plain(theta.double(), d64, CFG)
    gaps = chip_smoke.loss_gaps(theta, data, CFG, {"f": (f32.double(), f64),
                                                   "g": (g32.double(), g64)})
    ladder = chip_smoke._ladder(theta.shape[0], "cpu")
    gaps["fan"] = chip_smoke._gap(
        fan_k.fan_plain(theta, d, ladder, data, CFG).double(),
        fan_k.fan_plain(theta.double(), d.double(), ladder.double(), d64,
                        CFG),
        chip_smoke.fan_scale(theta, d, ladder, data, CFG).double(),
        data.t.shape[-1])
    assert max(gaps.values()) <= chip_smoke.GAP_TOL / 5, gaps


def test_stream_records_stages_per_micro_batch(streams):
    stats = streams["tsf"].stats
    assert len(stats.batch_stages) == stats.micro_batches == 3
    first, last = stats.batch_stages[0], stats.batch_stages[-1]
    for k in ("absorb", "union_grid", "materialize", "prep",
              "initial_theta", "update", "backend.solve"):
        assert k in last
    assert "transfer_theta" not in first  # nothing stored yet
    assert "transfer_theta" in last


def test_unknown_series_raise(streams):
    with pytest.raises(KeyError):
        streams["tsf"].forecast(["nope"], horizon=3)


def test_crash_replay_is_idempotent():
    """The last micro-batch redelivered before its commit: rows are
    deduplicated (history length unchanged) and the forecast does not
    move beyond float32 solver noise."""
    batches = _batches()
    sf = StreamingForecaster(CFG, SOLVER, device="cpu")
    sf.run(InMemorySource(batches))
    code = sf._codes(["a"])
    n_hist = len(sf._hist.union_grid(code))
    fc = sf.forecast(["a", "b", "c"], horizon=14, num_samples=0)
    sf.process(batches[-1])
    assert len(sf._hist.union_grid(code)) == n_hist == 210
    fc2 = sf.forecast(["a", "b", "c"], horizon=14, num_samples=0)
    np.testing.assert_allclose(fc2.yhat.to_numpy(), fc.yhat.to_numpy(),
                               rtol=0, atol=0.05)


def test_cold_mode_and_latencies():
    sf = StreamingForecaster(CFG, SOLVER, device="cpu", warm_start=False)
    stats = sf.run(InMemorySource(_batches()))
    assert stats.cold_starts == 7 and stats.warm_starts == 0
    assert len(stats.batch_seconds) == 3
    assert abs(sum(stats.batch_seconds) - stats.fit_seconds) < 1e-6
    assert sf.perf_report() is None


def test_resilient_poll_retries_an_injected_fault(tmp_path, monkeypatch):
    plan = faults.FaultPlan(state_dir=str(tmp_path / "f")).fail(
        "stream_poll", attempts=2)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    sf = StreamingForecaster(CFG, SOLVER, device="cpu")
    stats = sf.run(InMemorySource(_batches()[:1]),
                   poll_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    assert stats.micro_batches == 1
    # A fault that outlives the policy re-raises.
    plan2 = faults.FaultPlan(state_dir=str(tmp_path / "g")).fail(
        "stream_poll", attempts=5)
    monkeypatch.setenv(faults.ENV_VAR, plan2.to_env())
    with pytest.raises(faults.FaultInjected):
        sf.run(InMemorySource(_batches()[1:2]),
               poll_policy=RetryPolicy(max_attempts=2, base_delay_s=0.0))


def test_breaker_sheds_polls_once_open(tmp_path, monkeypatch):
    """A breaker shared across polls opens after its threshold of
    failures; the next poll raises ``CircuitOpen`` without polling."""
    plan = faults.FaultPlan(state_dir=str(tmp_path / "f")).fail(
        "stream_poll", attempts=10)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    src = InMemorySource(_batches())
    breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=60.0)
    res = ResilientSource(src, RetryPolicy(max_attempts=5, base_delay_s=0.0),
                          breaker)
    with pytest.raises(faults.FaultInjected):
        res.poll()
    assert breaker.state == CircuitBreaker.OPEN
    with pytest.raises(CircuitOpen):
        res.poll()
    assert len(os.listdir(tmp_path / "f")) == 2  # no third attempt


@pytest.mark.parametrize("rule", [{"mode": "hang"}, {"mode": "kill"},
                                  {"mode": "tear"}])
def test_fault_plan_refuses_what_the_port_does_not_inject(tmp_path,
                                                          monkeypatch, rule):
    """A plan that arms a mode the harness does not know is refused when
    the point is reached, never silently ignored (the JAX package's
    exit, flag and corrupt modes are injected since the orchestrator's
    port: ``tests/test_torch_resilience.py``; a series scope is honoured:
    ``test_series_scoped_rule_fires_on_its_range``)."""
    plan = faults.FaultPlan(state_dir=str(tmp_path / "f")).fail(
        "stream_poll")
    plan.rules[0].update(rule)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    with pytest.raises(ValueError, match="not one the harness injects"):
        faults.inject("stream_poll")


def test_series_scoped_rule_fires_on_its_range(tmp_path, monkeypatch):
    """A rule scoped to series 3 fires on calls whose ``(lo, hi)`` range
    covers row 3 (and on calls with no range), as in the JAX package."""
    plan = faults.FaultPlan(state_dir=str(tmp_path / "f")).fail(
        "stream_poll", series=3, attempts=3)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    faults.inject("stream_poll", lo=4, hi=8)
    faults.inject("stream_poll", lo=0, hi=3)
    with pytest.raises(faults.FaultInjected):
        faults.inject("stream_poll", lo=0, hi=4)
    with pytest.raises(faults.FaultInjected):
        faults.inject("stream_poll")


def test_kafka_source_gated():
    with pytest.raises(ImportError):
        KafkaSource("topic")


class _FakeMsg:
    def __init__(self, value):
        self.value = value


class _FakeConsumer:
    def __init__(self, batches):
        self._batches = list(batches)
        self.events = []

    def poll(self, timeout_ms=None, max_records=None):
        self.events.append("poll")
        if not self._batches:
            return {}
        return {("topic", 0): [_FakeMsg(r) for r in self._batches.pop(0)]}

    def commit(self):
        self.events.append("commit")


def test_kafka_fake_consumer_commits_after_each_refit():
    rows = _series_df(180, "k0", seed=5).to_dict("records")
    consumer = _FakeConsumer([rows[:150], rows[150:], []])
    sf = StreamingForecaster(CFG, SOLVER, device="cpu")
    stats = sf.run(KafkaSource(consumer=consumer, max_records=500))
    assert stats.micro_batches == 2
    assert consumer.events == ["poll", "commit", "poll", "commit", "poll"]


def test_obs_records_each_batch(tmp_path):
    path = str(tmp_path / obs.SPANS_FILE)
    prev = obs.start_run(path)
    before = METRICS.counter("tsspark_stream_batches_total").value
    try:
        sf = StreamingForecaster(CFG, SOLVER, device="cpu")
        sf.run(InMemorySource(_batches()[:2]))
    finally:
        obs.end_run(prev)
    recs = [r for r in obs.read_records(path) if r["name"] == "stream.batch"]
    assert [(r["attrs"]["warm"], r["attrs"]["cold"]) for r in recs] == \
        [(0, 2), (1, 1)]
    assert METRICS.counter("tsspark_stream_batches_total").value \
        == before + 2


def test_engine_route_matches_the_direct_read(tmp_path):
    from tsspark_tpu_torch.serve import ParamRegistry, PredictionEngine

    sf = StreamingForecaster(CFG, SOLVER, device="cpu")
    sf.run(InMemorySource(_batches()[:2]))
    direct = sf.forecast(["a", "c"], horizon=5, num_samples=0)
    reg = ParamRegistry(str(tmp_path / "reg"), CFG)
    assert sf.publish(reg) == 1
    sf.attach_engine(PredictionEngine(reg, device="cpu"))
    routed = sf.forecast(["a", "c"], horizon=5, num_samples=0)
    np.testing.assert_array_equal(routed.ds.to_numpy(), direct.ds.to_numpy())
    np.testing.assert_allclose(routed.yhat.to_numpy(),
                               direct.yhat.to_numpy(), rtol=1e-6)
    with pytest.raises(KeyError, match="publish"):
        sf.forecast(["nope"], horizon=5)


def test_autotune_state_sets_the_chunk(tmp_path):
    path = tmp_path / "autotune.json"
    path.write_text('{"chunk": 64}')
    sf = StreamingForecaster(CFG, SOLVER, device="cpu",
                             autotune_state=str(path))
    assert sf.backend.chunk_size == 64
    sf = StreamingForecaster(CFG, SOLVER, device="cpu",
                             autotune_state=str(tmp_path / "missing"))
    assert sf.backend.chunk_size == 8192


def test_datetime_ds_round_trips():
    df = _series_df(120, "d", 2)
    df["ds"] = pd.Timestamp("2024-01-01") + pd.to_timedelta(df.ds, unit="D")
    sf = StreamingForecaster(CFG, SOLVER, device="cpu")
    sf.process(df)
    fc = sf.forecast(["d"], horizon=3, num_samples=0)
    assert list(fc.ds) == list(pd.date_range("2024-04-30", periods=3))


def test_hourly_grid_stays_float64_where_the_reference_quantizes():
    """Both drivers fit an hourly frame on the union grid rounded through
    float32, as the JAX package's driver hands it over (``jnp.asarray``
    with x64 off moves hourly epoch-day timestamps by up to ~1.4
    minutes): the port's stored ds_start and span are the reference's
    (the rounded first timestamp, not the float64 one), and its fitted
    loss agrees.  (The name is the test's older one, from when the port
    kept the float64 grid.)"""
    t = 20650.0 + np.arange(24 * 20, dtype=np.float64) / 24.0 + 1.0 / 24.0
    df = pd.DataFrame({"series_id": "h", "ds": t,
                       "y": 5 + np.sin(2 * np.pi * t)})
    tsf = StreamingForecaster(CFG, SolverConfig(max_iters=5), device="cpu")
    jsf = jdriver.StreamingForecaster(JCFG, JSolver(max_iters=5),
                                      backend="tpu")
    ts, js = _capture(tsf), _capture(jsf)
    tsf.process(df)
    jsf.process(df)
    _, t_meta, _ = tsf.store.lookup(["h"])
    _, j_meta, _ = jsf.store.lookup(["h"])
    assert t_meta.ds_start[0] == j_meta.ds_start[0] \
        == float(np.float32(t[0])) != t[0]
    assert t_meta.ds_span[0] == j_meta.ds_span[0]
    moved = np.abs(np.float32(t).astype(np.float64) - t).max() * 1440.0
    assert 0.5 < moved < 1.5  # minutes
    # The fitted loss: both thetas scored by the JAX objective on the
    # reference's FitData of the frame, as test_stream_losses_within_
    # keep_best_margin scores a micro-batch.
    (jargs, jstate_), (targs, tstate) = js[0], ts[0]
    assert np.array_equal(np.asarray(targs[0]), np.asarray(jargs[0]))
    jdata, _ = jdesign.prepare_fit_data(*jargs, JCFG)

    def score(theta):
        return np.asarray(jloss.value_batch(
            jnp.asarray(np.asarray(theta, np.float32)), jdata, JCFG),
            np.float64)

    j_at_js, j_at_ts = score(jstate_.theta), score(tstate.theta)
    np.testing.assert_allclose(np.asarray(tstate.loss, np.float64),
                               j_at_ts, rtol=REPORT_RTOL)
    assert np.all(j_at_ts - j_at_js <= KEEP_BEST_MARGIN), (j_at_ts, j_at_js)


def test_cuda_backend_takes_a_tensor_init_as_numpy():
    """A warm start passed as a tensor (as the driver passes it) and as
    numpy give the same state bits, in a batch narrower than its chunk."""
    rng = np.random.default_rng(0)
    ds = np.arange(120, dtype=np.float64)
    y = 5 + 0.01 * ds + rng.normal(0, 0.2, (5, 120))
    init = rng.normal(0, 0.05, (5, CFG.num_params)).astype(np.float32)
    bk = get_backend("cuda", CFG, SolverConfig(max_iters=15), device="cpu")
    a = bk.fit(ds, y, init=torch.from_numpy(init))
    b = bk.fit(ds, y, init=init)
    assert torch.equal(a.theta, b.theta)
    assert np.array_equal(a.loss, b.loss)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def test_cuda_warm_start_fits_a_narrow_batch_on_the_card(card):
    """50 rows (narrower than the 64-row chunk) fitted with a warm start
    that lives on the card: the same bits as the same start from the
    host."""
    rng = np.random.default_rng(1)
    ds = np.arange(200, dtype=np.float64)
    y = 5 + 0.01 * ds + rng.normal(0, 0.2, (50, 200))
    init = rng.normal(0, 0.05, (50, CFG.num_params)).astype(np.float32)
    bk = get_backend("cuda", CFG, SolverConfig(max_iters=20))
    on = bk.fit(ds, y, init=torch.from_numpy(init).to(card))
    host = bk.fit(ds, y, init=init)
    assert torch.isfinite(on.theta).all()
    assert torch.equal(on.theta, host.theta)



@pytest.mark.parametrize("b,t_len,chunks", [
    (50, 510, [(50, 64)]),
    (30490, 583, [(8192, 8192)] * 3 + [(5914, 8192)]),
])
def test_micro_batch_widths_take_the_backend_ladder(monkeypatch, b, t_len,
                                                    chunks):
    """Each micro-batch brings a new (B, T): config 5's 50 rows pad to one
    64-row chunk; the fleet's 30,490 x 583 to four 8,192-row chunks, the
    last padded.  Every series spans the same window, so no length
    buckets.  (The plan only: no solve runs.)"""
    from tsspark_tpu_torch.backends.cuda import CudaBackend

    bk = get_backend("cuda", CFG, SOLVER, device="cpu")
    y = np.ones((b, t_len), np.float32)
    assert bk._plan_length_buckets(y, None) is None
    seen = []

    def record(self, ds, y_, mask, cap, floor, regressors, init, conditions,
               c, u8=None, starts=(), host=None):
        seen.append((y_.shape[0], c))
        return None

    monkeypatch.setattr(CudaBackend, "_fit_padded", record)
    monkeypatch.setattr("tsspark_tpu_torch.backends.cuda._concat_states",
                        lambda states: states)
    bk._fit_main(np.arange(t_len, dtype=np.float64), y)
    assert seen == chunks
