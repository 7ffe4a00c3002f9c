"""The port's data plane (``tsspark_tpu_torch.data.{datasets,plane,ingest}``)
against the JAX package's.

The 14 tests of ``tests/test_plane.py`` run against the port (block
parity, manifest lifecycle, torn-shard rejection and repair, scenario
packs, coverage gating and self-healing, ingest resume, a consumer that
starts before the ingest ends, the replay source, the datagen counters
and spans, the calendar, the create race, unknown generators, the export
surface), and beside them the cross-package checks: the generators'
bytes, a dataset's columns, sentinels and manifest, the deltas and the
replay source's frames equal the JAX package's, each package's
``open_batch`` reads the other's directory, and the ingest's child
process runs with torch and jax blocked.  All on the CPU, at small
sizes, under ``tmp_path`` roots.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tsspark_tpu.data import datasets as jdatasets
from tsspark_tpu.data import plane as jplane
from tsspark_tpu_torch.data import datasets, ingest, plane

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("base", "irregular", "missing_windows", "cold_start", "hier")


def _spec(**kw):
    base = dict(generator="m5", n_series=300, n_timesteps=48, seed=3,
                shard_rows=128)
    base.update(kw)
    return plane.DatasetSpec(**base)


def _jspec(spec):
    return jplane.DatasetSpec(**spec.to_dict())


def _same_batch(a, b):
    for f in ("ds", "y", "mask", "regressors", "cap"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert np.asarray(a.series_ids).dtype == np.asarray(b.series_ids).dtype
    np.testing.assert_array_equal(a.series_ids, b.series_ids)
    assert tuple(a.regressor_names) == tuple(b.regressor_names)


# ---------------------------------------------------------------------------
# the repair: dataset ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("generator", sorted(plane.GENERATORS))
def test_dataset_ids_equal_the_jax_package_past_the_pad_width(generator):
    """Every generator's ids equal the JAX package's, on rows crossing
    10,000 (the 4- and 5-wide schemes' own digits past their pad width)
    and 100,000; ``m5_hier`` is ``S<store>_D<dept>_I<item>``."""
    for lo, hi in ((0, 12), (9_990, 10_010), (99_995, 100_003)):
        got = datasets.dataset_ids(generator, lo, hi)
        want = jdatasets.dataset_ids(generator, lo, hi)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if generator == "m5_hier":
        assert datasets.dataset_ids(generator, 0, 11)[10] == "S0_D1_I00000"


# ---------------------------------------------------------------------------
# block-seeded generation
# ---------------------------------------------------------------------------


def test_row_slices_are_bitwise_stable():
    """m5_rows(lo, hi) == m5_rows(0, N)[lo:hi]."""
    full = datasets.m5_rows(0, 2100, n_days=40, seed=2)
    part = datasets.m5_rows(1000, 1500, n_days=40, seed=2)
    np.testing.assert_array_equal(full.y[1000:1500], part.y)
    np.testing.assert_array_equal(full.mask[1000:1500], part.mask)
    np.testing.assert_array_equal(
        full.regressors[1000:1500], part.regressors
    )
    longer = datasets.m5_rows(1000, 1500, n_days=40, seed=2)
    np.testing.assert_array_equal(part.y, longer.y)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_m5_rows_are_the_jax_packages_bytes(scenario):
    """Every scenario's rows, ids and calendar are the JAX package's
    bytes, on a range that crosses a seed block."""
    for lo, hi, t_len, seed in ((1000, 2100, 50, 3), (0, 7, 9, 0)):
        got = datasets.m5_rows(lo, hi, n_days=t_len, seed=seed,
                               scenario=scenario)
        want = jdatasets.m5_rows(lo, hi, n_days=t_len, seed=seed,
                                 scenario=scenario)
        _same_batch(got, want)
    got = datasets.m5_rows(3, 9, n_days=20, scenario=scenario,
                           with_regressors=False)
    assert got.regressors is None and got.regressor_names == ()


def test_demo_weekly_rows_are_the_jax_packages_bytes():
    for lo, hi, t_len, seed in ((0, 24, 180, 0), (1000, 1100, 40, 7)):
        _same_batch(datasets.demo_weekly_rows(lo, hi, n_steps=t_len,
                                              seed=seed),
                    jdatasets.demo_weekly_rows(lo, hi, n_steps=t_len,
                                               seed=seed))


def test_scenario_packs():
    t_len = 120
    base = datasets.m5_rows(0, 256, n_days=t_len, seed=1)
    irr = datasets.m5_rows(0, 256, n_days=t_len, seed=1,
                           scenario="irregular")
    cold = datasets.m5_rows(0, 256, n_days=t_len, seed=1,
                            scenario="cold_start")
    wins = datasets.m5_rows(0, 256, n_days=t_len, seed=1,
                            scenario="missing_windows")
    hier = datasets.m5_rows(0, 256, n_days=t_len, seed=1,
                            scenario="hier")
    for b in (base, irr, cold, wins, hier):
        assert b.y.shape == (256, t_len)
        assert ((b.mask > 0) == np.isfinite(b.y)).all()
    assert irr.mask.sum() < 0.95 * base.mask.sum()
    obs_len = cold.mask.sum(axis=1)
    assert (obs_len < 0.35 * t_len).mean() > 0.3
    inner_gap = 0
    for row in wins.mask[:64]:
        on = np.flatnonzero(row > 0)
        if on.size and (row[on[0]:on[-1] + 1] == 0).any():
            inner_gap += 1
    assert inner_gap > 0
    assert hier.series_ids[0] == "S0_D0_I00000"
    assert hier.series_ids[10] == "S0_D1_I00000"
    assert not np.array_equal(hier.y, base.y)


# ---------------------------------------------------------------------------
# cache lifecycle
# ---------------------------------------------------------------------------


def test_cache_bitwise_parity_and_warm_hit(tmp_path):
    spec = _spec()
    root = str(tmp_path)
    d = plane.ensure(spec, root=root, processes=2)
    assert plane.is_complete(d)

    batch = plane.open_batch(d)
    ref = plane.batch_columns(plane.generate_rows(spec, 0, spec.n_series))
    np.testing.assert_array_equal(
        np.asarray(batch.ds), plane.generate_rows(spec, 0, 1).ds
    )
    np.testing.assert_array_equal(np.asarray(batch.y), ref["y"])
    np.testing.assert_array_equal(np.asarray(batch.mask), ref["mask"])
    np.testing.assert_array_equal(np.asarray(batch.regressors),
                                  ref["reg"])
    np.testing.assert_array_equal(
        batch.series_ids, datasets.dataset_ids("m5", 0, spec.n_series)
    )

    mtime = os.path.getmtime(os.path.join(d, "y.npy"))
    assert plane.ensure(spec, root=root) == d
    assert os.path.getmtime(os.path.join(d, "y.npy")) == mtime

    # A complete plane dir is a plain directory of column files: the
    # calendar and every column load as .npy arrays of the batch's bytes.
    np.testing.assert_array_equal(np.load(os.path.join(d, "ds.npy")),
                                  np.asarray(batch.ds))
    for f, want in ref.items():
        np.testing.assert_array_equal(
            np.load(os.path.join(d, f"{f}.npy"), mmap_mode="r"), want)


def test_manifest_key_rotates_with_identity(tmp_path):
    root = str(tmp_path)
    a = plane.dataset_dir(_spec(seed=3), root)
    assert a != plane.dataset_dir(_spec(seed=4), root)
    assert a != plane.dataset_dir(_spec(n_series=301), root)
    assert plane.dataset_fingerprint() in os.path.basename(a)
    # The port's key is the JAX package's but for the fingerprint (each
    # hashes its own data package).
    j = jplane.dataset_dir(_jspec(_spec(seed=3)), root)
    assert a.rsplit("_", 1)[0] == j.rsplit("_", 1)[0]


def test_torn_shard_rejected_and_repaired(tmp_path):
    spec = _spec()
    root = str(tmp_path)
    d = plane.ensure(spec, root=root)
    ref = np.array(np.asarray(plane.open_batch(d).y))

    mm = np.lib.format.open_memmap(os.path.join(d, "y.npy"), mode="r+")
    mm[5, :7] = 1e9  # silent corruption inside shard 0
    mm.flush()
    del mm
    assert not plane.verify_shard(d, 0, spec.shard_rows)
    assert plane.verify_shard(d, spec.shard_rows, 2 * spec.shard_rows)
    # The JAX package's verifier refuses the same torn shard.
    assert not jplane.verify_shard(d, 0, spec.shard_rows)

    rewritten = plane.repair(spec, root=root)
    assert rewritten == [(0, spec.shard_rows)]
    assert plane.verify_shard(d, 0, spec.shard_rows)
    assert plane.is_complete(d)
    np.testing.assert_array_equal(np.asarray(plane.open_batch(d).y), ref)


def test_ready_coverage_and_self_heal(tmp_path):
    spec = _spec()
    root = str(tmp_path)
    d = plane.create_columns(spec, root)
    assert plane.ready_coverage(d, spec.n_series) == []
    assert plane.ready_coverage(str(tmp_path)) is None
    assert plane.ingest_pending(d, spec.n_series)

    plane.write_shard(spec, 0, root=root)
    assert plane.ready_coverage(d, spec.n_series) == [(0, 128)]
    assert plane.covers(plane.ready_coverage(d), 0, 128)
    assert not plane.covers(plane.ready_coverage(d), 64, 192)

    assert plane.produce_next_missing(d)
    assert plane.ready_coverage(d, spec.n_series) == [(0, 256)]
    assert plane.produce_next_missing(d)
    assert not plane.ingest_pending(d, spec.n_series)
    assert not plane.is_complete(d)
    ingest.run_ingest(spec, root=root)
    assert plane.is_complete(d)


def test_ingest_resumes_missing_shards_only(tmp_path):
    spec = _spec()
    root = str(tmp_path)
    plane.create_columns(spec, root)
    plane.write_shard(spec, 1, root=root)
    d = plane.dataset_dir(spec, root)
    mtime = os.path.getmtime(plane._sentinel_path(d, 128, 256))
    ingest.run_ingest(spec, root=root)
    assert plane.is_complete(d)
    assert os.path.getmtime(plane._sentinel_path(d, 128, 256)) == mtime
    rep = ingest.read_ingest_report(d)
    assert rep["shards_produced"] == 2 and rep["shards_total"] == 3


def test_series_scoped_fault_fires_on_the_covering_shard(tmp_path,
                                                         monkeypatch):
    """``write_shard`` passes its rows to the io layer: a fault rule
    scoped to series 200 fires on shard 1's write alone (a call with no
    range, as the columns' creation, matches any series)."""
    from tsspark_tpu_torch.resilience import faults

    spec = _spec()
    root = str(tmp_path / "plane")
    plane.create_columns(spec, root)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "io_mmap", series=200, attempts=5)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    plane.write_shard(spec, 0, root=root)
    with pytest.raises(faults.FaultInjected):
        plane.write_shard(spec, 1, root=root)
    plane.write_shard(spec, 2, root=root)
    assert plane.missing_shards(spec, root) == [1]


# ---------------------------------------------------------------------------
# cross-package: the same bytes, each reading the other's directories
# ---------------------------------------------------------------------------


def _json(path):
    with open(path) as fh:
        return json.load(fh)


@pytest.mark.parametrize("generator", ["m5_cold_start", "m5_hier",
                                       "demo_weekly"])
def test_dataset_bytes_equal_across_packages(tmp_path, generator):
    """One spec ingested by each package: the calendar and columns are
    byte-equal files, the sentinels' CRCs and the spec and manifest
    fields equal (fingerprint and times aside), and each package's
    ``open_batch`` reads the other's directory to the same batch."""
    spec = _spec(generator=generator, n_series=260, n_timesteps=40)
    a = plane.ensure(spec, root=str(tmp_path / "port"), processes=2)
    b = jplane.ensure(_jspec(spec), root=str(tmp_path / "jax"))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    cols = [n for n in names if n.endswith(".npy")]
    assert "ds.npy" in cols and "y.npy" in cols and "mask.npy" in cols
    for n in cols:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    for n in names:
        if not n.endswith(".json") or n == ingest.INGEST_REPORT:
            continue
        ja, jb = _json(os.path.join(a, n)), _json(os.path.join(b, n))
        differ = {k for k in set(ja) | set(jb) if ja.get(k) != jb.get(k)}
        assert differ <= {"fingerprint", "unix", "pid"}, (n, differ)
        if n.startswith("shardok_"):
            assert ja["crc"] == jb["crc"]
    _same_batch(plane.open_batch(b), jplane.open_batch(a))
    _same_batch(plane.open_batch(a), jplane.open_batch(b))


def test_import_batch_equal_across_packages(tmp_path):
    batch = datasets.m5_rows(0, 40, n_days=30, seed=5,
                             scenario="missing_windows")
    a = plane.import_batch(batch, "csv", root=str(tmp_path / "p"),
                           shard_rows=16)
    b = jplane.import_batch(batch, "csv", root=str(tmp_path / "j"),
                            shard_rows=16)
    assert os.path.basename(a).rsplit("_", 1)[0] \
        == os.path.basename(b).rsplit("_", 1)[0]
    _same_batch(plane.open_batch(b), jplane.open_batch(a))


def _delta_records(d):
    return [{k: v for k, v in r.items() if k not in ("unix", "pid")}
            for r in plane.delta_records(d)]


def test_deltas_equal_across_packages(tmp_path):
    """land_delta / land_synthetic_delta give the same records, patch
    payloads and column bytes in both packages; advanced_since,
    delta_rows and delta_seq read the same; and a repaired shard of an
    advanced dataset replays its deltas to the same bytes."""
    spec = _spec(n_series=260, n_timesteps=32)
    a = plane.ensure(spec, root=str(tmp_path / "port"))
    b = jplane.ensure(_jspec(spec), root=str(tmp_path / "jax"))
    rows = np.array([3, 140, 259])
    tail = np.arange(12, dtype=np.float32).reshape(3, 4)
    ra = plane.land_delta(a, rows, tail)
    rb = jplane.land_delta(b, rows, tail)
    assert {k: ra[k] for k in ra if k not in ("unix", "pid")} \
        == {k: rb[k] for k in rb if k not in ("unix", "pid")}
    for k in (1, 2):
        plane.land_synthetic_delta(a, 0.05, seed=k)
        jplane.land_synthetic_delta(b, 0.05, seed=k)
    plane.land_synthetic_delta(a, 0.0, rows=[7, 8, 200], seed=9)
    jplane.land_synthetic_delta(b, 0.0, rows=[7, 8, 200], seed=9)
    assert _delta_records(a) == _delta_records(b)
    assert plane.delta_seq(a) == jplane.delta_seq(b) == 4
    assert plane.delta_seq_since(a, 1) == 4
    for stamp in (0, 1, 3, 4):
        np.testing.assert_array_equal(plane.advanced_since(a, stamp),
                                      jplane.advanced_since(b, stamp))
    for seq in (1, 2, 3, 4):
        np.testing.assert_array_equal(plane.delta_rows(a, seq),
                                      jplane.delta_rows(b, seq))
        pa, pb = plane.delta_patch(a, seq), jplane.delta_patch(b, seq)
        for k in ("rows", "y", "mask"):
            assert pa[k].tobytes() == pb[k].tobytes()
    for f in ("y", "mask"):
        with open(os.path.join(a, f"{f}.npy"), "rb") as fa, \
                open(os.path.join(b, f"{f}.npy"), "rb") as fb:
            assert fa.read() == fb.read()
    # Each package verifies the other's advanced shards.
    for lo, hi in plane.shard_ranges(spec):
        assert plane.verify_shard(b, lo, hi)
        assert jplane.verify_shard(a, lo, hi)
    # Tear an advanced shard: repair regenerates the base bytes and
    # replays the landed deltas, back to the JAX package's bytes.
    mm = np.lib.format.open_memmap(os.path.join(a, "y.npy"), mode="r+")
    mm[140, :] = -1.0
    mm.flush()
    del mm
    assert not plane.verify_shard(a, 128, 256)
    assert plane.repair(spec, root=str(tmp_path / "port")) == [(128, 256)]
    with open(os.path.join(a, "y.npy"), "rb") as fa, \
            open(os.path.join(b, "y.npy"), "rb") as fb:
        assert fa.read() == fb.read()


def test_torn_shard_repaired_to_the_jax_packages_bytes(tmp_path):
    spec = _spec(generator="m5_irregular", n_series=200)
    a = plane.ensure(spec, root=str(tmp_path / "port"))
    b = jplane.ensure(_jspec(spec), root=str(tmp_path / "jax"))
    with open(os.path.join(a, "mask.npy"), "r+b") as fh:
        fh.seek(os.path.getsize(os.path.join(a, "mask.npy")) - 64)
        fh.write(b"\x7f" * 64)  # tear the last shard's tail bytes
    assert not plane.verify_shard(a, 128, 200)
    assert plane.verify_shard(a, 0, 128)
    assert plane.repair(spec, root=str(tmp_path / "port")) == [(128, 200)]
    with open(os.path.join(a, "mask.npy"), "rb") as fa, \
            open(os.path.join(b, "mask.npy"), "rb") as fb:
        assert fa.read() == fb.read()


_LEAN_INGEST = r"""
import sys
sys.modules["torch"] = None        # any `import torch` now raises
sys.modules["jax"] = None
from tsspark_tpu_torch.data import ingest
rc = ingest.main(sys.argv[1:])
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split(".")[0] in ("torch", "jax", "tsspark_tpu")]
assert not bad, bad
sys.exit(rc)
"""


def test_ingest_child_runs_with_torch_and_jax_blocked(tmp_path):
    spec = _spec(n_series=140, n_timesteps=20)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _LEAN_INGEST, "--generator", "m5",
         "--series", "140", "--timesteps", "20", "--seed", "3",
         "--shard-rows", "128", "--processes", "2",
         "--root", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    d = plane.dataset_dir(spec, str(tmp_path))
    assert plane.is_complete(d)
    assert ingest.read_ingest_report(d)["processes"] == 2


def test_ingest_driver_overlaps_and_a_dead_child_fails(tmp_path):
    """The background driver lands the dataset (its columns exist the
    moment ``start`` returns); a child that dies reports a non-zero exit
    and leaves the dataset incomplete."""
    spec = _spec(n_series=260, n_timesteps=24)
    drv = ingest.IngestDriver.start(spec, root=str(tmp_path), processes=2,
                                    log_stream=subprocess.DEVNULL)
    try:
        assert plane.read_spec(drv.dataset_dir) is not None
        assert drv.wait(timeout=240) == 0
    finally:
        drv.kill()
    assert plane.is_complete(drv.dataset_dir)
    _same_batch(plane.open_batch(drv.dataset_dir),
                jplane.open_batch(jplane.ensure(
                    _jspec(spec), root=str(tmp_path / "jax"))))

    dead = ingest.IngestDriver.start(
        _spec(n_series=130, n_timesteps=24, seed=8), root=str(tmp_path),
        processes=1, log_stream=subprocess.DEVNULL)
    dead.kill()
    assert dead.wait(timeout=60) != 0
    assert not plane.is_complete(dead.dataset_dir)


# ---------------------------------------------------------------------------
# overlap: work starts before ingestion finishes
# ---------------------------------------------------------------------------


def test_fit_overlaps_ingestion(tmp_path):
    """A consumer gated on ``ready_coverage`` fits each shard as it
    lands (the port's ``CudaBackend`` on the CPU): its first fit ends
    before the last shard lands, and the spans of one trace tell it."""
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import (
        ProphetConfig,
        SeasonalityConfig,
        SolverConfig,
    )
    from tsspark_tpu_torch.obs import context as obs

    spec = plane.DatasetSpec(generator="m5", n_series=512, n_timesteps=40,
                             seed=5, shard_rows=128)
    root = str(tmp_path / "plane")
    data_dir = plane.create_columns(spec, root)
    first_fit = threading.Event()

    def produce():
        plane.write_shard(spec, 0, root=root)
        first_fit.wait(timeout=120)
        for i in range(1, 4):
            plane.write_shard(spec, i, root=root)
        plane.finalize(spec, root)

    bk = get_backend(
        "cuda",
        ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                      n_changepoints=3),
        SolverConfig(max_iters=30), device="cpu")
    spans = str(tmp_path / "spans.jsonl")
    prev = obs.start_run(spans)
    producer = threading.Thread(target=produce)
    producer.start()
    fitted, fit_ends = [], []
    try:
        deadline = time.time() + 240
        while len(fitted) < 4 and time.time() < deadline:
            ready = plane.ready_coverage(data_dir, spec.n_series)
            for lo, hi in plane.shard_ranges(spec):
                if (lo, hi) in fitted or not (
                        ready is None or plane.covers(ready, lo, hi)):
                    continue
                ds = np.load(os.path.join(data_dir, "ds.npy"))
                cols = {f: np.load(os.path.join(data_dir, f"{f}.npy"),
                                   mmap_mode="r")[lo:hi]
                        for f in ("y", "mask")}
                with obs.span("chunk.fit", lo=lo, hi=hi):
                    state = bk.fit(ds, np.asarray(cols["y"]),
                                   mask=np.asarray(cols["mask"]))
                assert np.isfinite(state.loss).all()
                fitted.append((lo, hi))
                fit_ends.append(time.time())
                first_fit.set()
            time.sleep(0.02)
    finally:
        first_fit.set()
        producer.join(timeout=120)
        obs.end_run(prev)
    assert sorted(fitted) == plane.shard_ranges(spec)
    assert plane.is_complete(data_dir)
    last_shard = max(
        os.path.getmtime(os.path.join(data_dir, n))
        for n in os.listdir(data_dir) if n.startswith("shardok_"))
    assert fit_ends[0] < last_shard
    recs = obs.read_records(spans)
    names = {r.get("name") for r in recs}
    assert "datagen.shard" in names and "chunk.fit" in names
    fit_starts = [r["t0"] for r in recs if r.get("name") == "chunk.fit"]
    shard_ends = [r["t0"] + r["dur_s"] for r in recs
                  if r.get("name") == "datagen.shard"]
    assert min(fit_starts) < max(shard_ends)


# ---------------------------------------------------------------------------
# shared consumers
# ---------------------------------------------------------------------------


def test_replay_source_reads_the_plane(tmp_path):
    from tsspark_tpu_torch.streaming.source import PlaneReplaySource

    spec = plane.DatasetSpec("demo_weekly", 8, 40, seed=7, shard_rows=8)
    src = PlaneReplaySource(spec=spec, root=str(tmp_path), window=16,
                            max_series=5)
    frames = []
    while True:
        f = src.poll()
        if f is None:
            break
        frames.append(f)
        src.commit()
    assert len(frames) == 3
    assert list(frames[0].columns) == ["series_id", "ds", "y"]
    assert len(frames[0]) == 5 * 16
    batch = plane.open_batch(plane.dataset_dir(spec, str(tmp_path)))
    np.testing.assert_allclose(
        frames[0]["y"].to_numpy()[:16], np.asarray(batch.y[0, :16]),
    )


def test_replay_source_frames_equal_the_jax_packages(tmp_path):
    """Both packages' replay sources give the same frames off the same
    directory (a cold-start dataset: fully masked windows skipped)."""
    from tsspark_tpu.streaming.source import PlaneReplaySource as JSource
    from tsspark_tpu_torch.streaming.source import PlaneReplaySource

    spec = plane.DatasetSpec("m5_cold_start", 20, 60, seed=4, shard_rows=8)
    d = plane.ensure(spec, root=str(tmp_path))
    mine, theirs = PlaneReplaySource(d, window=7), JSource(d, window=7)
    n = 0
    while True:
        a, b = mine.poll(), theirs.poll()
        if a is None or b is None:
            assert a is None and b is None
            break
        assert list(a.columns) == list(b.columns)
        for c in a.columns:
            np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy())
        n += 1
    assert n >= 2


def test_datagen_metrics_and_spans(tmp_path):
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

    names = ("tsspark_datagen_cache_misses_total",
             "tsspark_datagen_cache_hits_total",
             "tsspark_datagen_shards_total", "tsspark_datagen_rows_total")
    before = {n: METRICS.counter(n).value for n in names}
    spans = str(tmp_path / "spans.jsonl")
    prev = obs.start_run(spans)
    try:
        spec = _spec(n_series=200, seed=9)
        plane.ensure(spec, root=str(tmp_path))  # miss -> ingest
        plane.ensure(spec, root=str(tmp_path))  # hit
        got = {n: METRICS.counter(n).value - before[n] for n in names}
        assert got == {"tsspark_datagen_cache_misses_total": 1,
                       "tsspark_datagen_cache_hits_total": 1,
                       "tsspark_datagen_shards_total": 2,
                       "tsspark_datagen_rows_total": 200}
    finally:
        obs.end_run(prev)
    recs = obs.read_records(spans)
    assert sum(1 for r in recs if r.get("name") == "datagen.shard") == 2
    ingest_recs = [r for r in recs if r.get("name") == "datagen.ingest"]
    # The long span: an open record, then its completion, one span id.
    assert [r["status"] for r in ingest_recs] == ["open", "ok"]
    assert len({r["span_id"] for r in ingest_recs}) == 1


def test_calendar_matches_every_generator():
    for gen in plane.GENERATORS:
        got = plane.generate_rows(
            plane.DatasetSpec(gen, 4, 24, seed=1), 0, 1
        ).ds
        np.testing.assert_array_equal(
            datasets.dataset_calendar(gen, 24), got
        )
        np.testing.assert_array_equal(
            jdatasets.dataset_calendar(gen, 24), got)


def test_concurrent_create_never_clobbers_landed_rows(tmp_path):
    spec = _spec()
    root = str(tmp_path)
    d = plane.create_columns(spec, root)
    plane.write_shard(spec, 0, root=root)
    ref = np.array(np.load(os.path.join(d, "y.npy"), mmap_mode="r")[:128])
    os.remove(os.path.join(d, "spec.json"))
    plane.create_columns(spec, root)
    np.testing.assert_array_equal(
        np.load(os.path.join(d, "y.npy"), mmap_mode="r")[:128], ref
    )
    assert plane.verify_shard(d, 0, 128)


def test_unknown_generator_rejected():
    with pytest.raises(ValueError, match="unknown generator"):
        plane.DatasetSpec("nope", 8, 8)


def test_package_export_surface():
    from tsspark_tpu_torch import data

    for name in ("SeriesBatch", "m5_like", "m5_rows", "demo_weekly_rows",
                 "DatasetSpec", "ensure", "open_batch", "import_batch",
                 "load_m5", "load_m4", "dataset_fingerprint"):
        assert callable(getattr(data, name)) or name == "SeriesBatch"
    from tsspark_tpu import data as jdata

    assert set(data.__all__) == set(jdata.__all__)
