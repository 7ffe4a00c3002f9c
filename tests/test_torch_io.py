"""The port's storage fault domain (``tsspark_tpu_torch.io``), case for
case as the JAX package's ``tests/test_io.py``: the durable-I/O choke
point, typed storage errors, the injectable io_* fault points, the
DiskBudget accountant, the disk-pressure degradation ladder and the
plane protocol library."""

import errno
import json
import os

import numpy as np
import pytest

from tsspark_tpu_torch.io import (
    BackpressureError,
    DiskFullError,
    DiskIOError,
    ReadOnlyError,
    ShortWriteError,
    StorageError,
    append_line,
    atomic_write,
    atomic_write_text,
    attach_array,
    classify_os_error,
    current_state,
    gate_ingest,
    hardlink,
    is_missing,
    link_or_copy,
    open_memmap,
    reraise_classified,
    stale_serving,
)
from tsspark_tpu_torch.io import budget as iobudget
from tsspark_tpu_torch.io.ladder import (
    LADDER_STATES,
    DegradationLadder,
)
from tsspark_tpu_torch.plane import protocol as planeproto
from tsspark_tpu_torch.resilience import faults


# ---------------------------------------------------------------------------
# typed storage errors
# ---------------------------------------------------------------------------


def test_classify_os_error_maps_errnos_to_typed_subclasses():
    """A failing disk must never read as a missing file: each storage
    errno maps to a typed subclass that is STILL an OSError (existing
    except-OSError sites keep working), and unknown errnos pass
    through unwrapped."""
    cases = [
        (errno.ENOSPC, DiskFullError),
        (errno.EDQUOT, DiskFullError),
        (errno.EIO, DiskIOError),
        (errno.EROFS, ReadOnlyError),
    ]
    for num, cls in cases:
        e = OSError(num, "x")
        ce = classify_os_error(e)
        assert type(ce) is cls
        assert isinstance(ce, StorageError) and isinstance(ce, OSError)
        assert ce.errno == num
    plain = OSError(errno.EACCES, "x")
    assert classify_os_error(plain) is plain


def test_is_missing_is_narrow():
    assert is_missing(OSError(errno.ENOENT, "x"))
    assert is_missing(OSError(errno.ENOTDIR, "x"))
    assert not is_missing(OSError(errno.EIO, "x"))
    assert not is_missing(OSError(errno.ENOSPC, "x"))


def test_reraise_classified_chains_cause():
    with pytest.raises(DiskIOError) as ei:
        try:
            raise OSError(errno.EIO, "the disk is lying")
        except OSError as e:
            reraise_classified(e)
    assert isinstance(ei.value.__cause__, OSError)
    with pytest.raises(OSError) as ei2:
        try:
            raise OSError(errno.EACCES, "not a storage errno")
        except OSError as e:
            reraise_classified(e)
    assert type(ei2.value) is PermissionError  # unwrapped, not StorageError


def test_backpressure_error_is_not_a_storage_error():
    """Backpressure is flow control, not disk failure: an upstream
    catching OSError to classify disk trouble must NOT swallow the
    pause signal."""
    e = BackpressureError("pause_ingest", 0.07)
    assert not isinstance(e, OSError)
    assert e.state == "pause_ingest" and e.headroom == 0.07


# ---------------------------------------------------------------------------
# durable atomic writes + injected storage faults
# ---------------------------------------------------------------------------


def test_atomic_write_roundtrip_and_no_temp_residue(tmp_path):
    p = str(tmp_path / "a.json")
    atomic_write(p, lambda fh: json.dump({"v": 1}, fh), mode="w")
    with open(p) as fh:
        assert json.load(fh) == {"v": 1}
    atomic_write_text(p, "plain")
    with open(p) as fh:
        assert fh.read() == "plain"
    assert os.listdir(tmp_path) == ["a.json"]  # no stray temps


def test_injected_enospc_raises_typed_and_cleans_temp(tmp_path,
                                                      monkeypatch):
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("io_write", mode="enospc", path="victim")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    p = str(tmp_path / "victim.json")
    with pytest.raises(DiskFullError) as ei:
        atomic_write_text(p, "never lands")
    assert ei.value.errno == errno.ENOSPC
    assert not os.path.exists(p)
    assert not [n for n in os.listdir(tmp_path) if "victim" in n]
    # Path scoping: an unscoped sibling write is untouched.
    atomic_write_text(str(tmp_path / "other.json"), "lands")


def test_injected_eio_on_rename_fails_before_publish(tmp_path,
                                                     monkeypatch):
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("io_rename", mode="eio")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    p = str(tmp_path / "b.json")
    with pytest.raises(DiskIOError):
        atomic_write_text(p, "x")
    assert not os.path.exists(p)  # the rename never happened


def test_short_write_lands_torn_and_only_crc_catches_it(tmp_path,
                                                        monkeypatch):
    """The nastiest storage fault: the truncated payload PUBLISHES as
    success (an unchecked write(2) return), so only the CRC-sentinel
    read path stands between it and a served forecast."""
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("io_write", mode="shortwrite", path="col_x",
              fraction=0.4)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    arr = np.arange(256, dtype=np.float32).reshape(16, 16)
    d = str(tmp_path / "plane")
    os.makedirs(d)
    sent = {"shards": [[0, 16, planeproto.shard_crcs({"x": arr})]]}
    planeproto.publish_plane(
        d, "spec.json", {"n": 16}, {"x": arr},
        lambda vd, name: os.path.join(vd, f"col_{name}.npy"),
        "ok.json", sent,
    )  # reports success — the tear is silent
    monkeypatch.delenv(faults.ENV_VAR)
    assert os.path.getsize(os.path.join(d, "col_x.npy")) < arr.nbytes
    caught = False
    try:
        col = planeproto.attach_column(os.path.join(d, "col_x.npy"))
        caught = planeproto.verify_crcs(
            {"x": np.asarray(col)}, sent["shards"]) is not None
    except (ValueError, OSError):
        caught = True  # the attach itself refused the torn payload
    assert caught


def test_lost_fsync_records_and_replays_pre_write_state(tmp_path,
                                                        monkeypatch):
    """A rename that lived only in the page cache: the caller saw
    success, the crash (exit-mode firing) rolls the file back to its
    pre-write bytes before dying."""
    p = str(tmp_path / "m.json")
    atomic_write_text(p, "old")  # lands before any fault is armed
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("io_fsync", mode="lost_fsync", path="m.json")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    atomic_write_text(p, "new")  # caller sees success
    with open(p) as fh:
        assert fh.read() == "new"
    replayed = faults._replay_lost_fsyncs(plan.state_dir)
    assert replayed == 1
    with open(p) as fh:
        assert fh.read() == "old"  # the crash lost the rename


def test_link_or_copy_degrades_only_for_capability_errnos(tmp_path,
                                                          monkeypatch):
    src = str(tmp_path / "src")
    atomic_write_text(src, "payload")
    dst = str(tmp_path / "dst")
    link_or_copy(src, dst)
    assert os.path.samefile(src, dst)
    # An injected EIO at io_link must PROPAGATE (typed), never be
    # silently healed by the copy fallback.
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("io_link", mode="eio")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    with pytest.raises(DiskIOError):
        link_or_copy(src, str(tmp_path / "dst2"))
    assert not os.path.exists(str(tmp_path / "dst2"))


def test_append_line_and_memmap_helpers(tmp_path):
    log = str(tmp_path / "log.jsonl")
    append_line(log, json.dumps({"i": 1}))
    append_line(log, json.dumps({"i": 2}))
    with open(log) as fh:
        assert [json.loads(x)["i"] for x in fh] == [1, 2]
    p = str(tmp_path / "c.npy")
    mm = open_memmap(p, mode="w+", dtype=np.float32, shape=(4, 3))
    mm[...] = 7.0
    mm.flush()
    del mm
    back = attach_array(p)
    assert back.shape == (4, 3) and float(back[0, 0]) == 7.0
    hardlink(p, str(tmp_path / "c2.npy"))
    assert os.path.samefile(p, str(tmp_path / "c2.npy"))


# ---------------------------------------------------------------------------
# DiskBudget
# ---------------------------------------------------------------------------


def test_disk_budget_check_refuses_overrun_with_enospc(tmp_path):
    root = str(tmp_path / "root")
    os.makedirs(root)
    atomic_write_text(os.path.join(root, "f"), "x" * 4096)
    b = iobudget.DiskBudget(root, budget_bytes=5000)
    assert b.governs(os.path.join(root, "sub", "g"))
    assert not b.governs(str(tmp_path / "elsewhere"))
    b.check(0)  # under budget: fine
    with pytest.raises(DiskFullError) as ei:
        b.check(10_000, what="next-version")
    assert ei.value.errno == errno.ENOSPC
    assert "next-version" in str(ei.value)
    assert 0.0 <= b.headroom() <= 1.0


def test_env_armed_budget_gates_atomic_write(tmp_path, monkeypatch):
    root = str(tmp_path / "gov")
    os.makedirs(root)
    atomic_write_text(os.path.join(root, "seed"), "x" * 2048)
    monkeypatch.setenv(iobudget.ENV_BUDGET_ROOT, root)
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, "1024")
    with pytest.raises(DiskFullError):
        atomic_write_text(os.path.join(root, "more"), "y")
    # Outside the governed root the gate does not apply.
    atomic_write_text(str(tmp_path / "outside"), "y")


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------


class _FakeBudget:
    """Duck-typed budget with a settable headroom dial."""

    root = "/fake"
    budget_bytes = 1

    def __init__(self, h=1.0):
        self.h = h

    def headroom(self):
        return self.h


def test_ladder_descends_in_order_and_improves_with_hysteresis():
    b = _FakeBudget(1.0)
    lad = DegradationLadder(b, hysteresis=0.02)
    assert lad.state() == "normal"
    assert lad.allows("speculate") and lad.allows("ingest")
    for h, want in ((0.39, "shed_spec"), (0.24, "reap"),
                    (0.09, "pause_ingest"), (0.04, "stale_serve")):
        b.h = h
        assert lad.state() == want
    assert not lad.allows("speculate") and not lad.allows("ingest")
    assert lad.should_reap() and lad.stale_serve()
    # Improving: clearing the ENTRY threshold is not enough...
    b.h = 0.051
    assert lad.state() == "stale_serve"  # within hysteresis: hold
    # ...until the margin clears; then the state re-ranks from headroom.
    b.h = 0.20
    assert lad.state() == "reap"
    b.h = 0.45
    assert lad.state() == "normal"
    with pytest.raises(ValueError):
        lad.allows("dance")


def test_ladder_constructor_validates_thresholds():
    with pytest.raises(ValueError):
        DegradationLadder(_FakeBudget(), thresholds=(0.4, 0.25))
    with pytest.raises(ValueError):
        DegradationLadder(_FakeBudget(),
                          thresholds=(0.05, 0.10, 0.25, 0.40))


def test_module_helpers_unarmed_are_normal_and_free(monkeypatch):
    monkeypatch.delenv(iobudget.ENV_BUDGET_BYTES, raising=False)
    monkeypatch.delenv(iobudget.ENV_BUDGET_ROOT, raising=False)
    assert current_state("/anywhere") == "normal"
    gate_ingest("/anywhere")  # no-op, no raise
    assert stale_serving("/anywhere") is False


def test_gate_ingest_raises_backpressure_under_pressure(tmp_path,
                                                        monkeypatch):
    root = str(tmp_path / "press")
    os.makedirs(root)
    atomic_write_text(os.path.join(root, "bulk"), "z" * 8192)
    monkeypatch.setenv(iobudget.ENV_BUDGET_ROOT, root)
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, "8300")
    assert current_state(root) == "stale_serve"
    with pytest.raises(BackpressureError) as ei:
        gate_ingest(root)
    assert ei.value.state in LADDER_STATES
    assert ei.value.headroom < 0.10
    assert stale_serving(root) is True
    # An UNGOVERNED root is untouched: pressure on one storage root
    # must not pause an unrelated one.
    assert current_state(str(tmp_path / "other")) == "normal"
    gate_ingest(str(tmp_path / "other"))


# ---------------------------------------------------------------------------
# plane protocol library
# ---------------------------------------------------------------------------


def test_publish_plane_roundtrip_spec_columns_sentinel(tmp_path):
    d = str(tmp_path / "v1")
    os.makedirs(d)
    cols = {"theta": np.arange(12, dtype=np.float32).reshape(4, 3),
            "step": np.ones(4, np.float64)}
    shards = [[lo, hi, planeproto.shard_crcs(cols, lo, hi)]
              for lo, hi in planeproto.shard_ranges(4, 2)]
    planeproto.publish_plane(
        d, "spec.json", {"n_series": 4}, cols,
        lambda vd, name: os.path.join(vd, f"col_{name}.npy"),
        "ok.json", {"shards": shards},
    )
    spec = planeproto.read_json(os.path.join(d, "spec.json"))
    sent = planeproto.read_json(os.path.join(d, "ok.json"))
    assert spec["n_series"] == 4 and sent["shards"]
    back = {k: np.asarray(planeproto.attach_column(
        os.path.join(d, f"col_{k}.npy"))) for k in cols}
    assert planeproto.verify_crcs(back, sent["shards"]) is None
    back["theta"] = back["theta"].copy()
    back["theta"][1, 1] += 1.0
    bad = planeproto.verify_crcs(back, sent["shards"])
    assert bad is not None and bad[0] == "theta" and bad[1:] == (0, 2)


def test_read_json_absent_and_torn_read_as_none(tmp_path):
    assert planeproto.read_json(str(tmp_path / "nope.json")) is None
    torn = str(tmp_path / "torn.json")
    with open(torn, "w") as fh:
        fh.write('{"half":')
    assert planeproto.read_json(torn) is None


def test_a_jax_plan_fires_the_same_way_in_the_port(tmp_path, monkeypatch):
    """A storage plan the JAX package's harness writes arms the port's
    io layer the same way (same layout, same claim files)."""
    from tsspark_tpu.resilience import faults as jfaults

    plan = jfaults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("io_write", mode="eio", path="victim", after=1)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    atomic_write_text(str(tmp_path / "victim_a.json"), "first lands")
    with pytest.raises(DiskIOError):
        atomic_write_text(str(tmp_path / "victim_b.json"), "x")
    assert not os.path.exists(str(tmp_path / "victim_b.json"))
