"""The kernel bank (``serve/aotbank.py``): its shape ladder is the JAX
package's, its manifest is idempotent across flips of one shape, a bank
with nothing to copy builds the library into itself, and a missing or
stale bank leaves the kernel library where it was with an event instead
of breaking a replica.  On the CPU no library is built or
loaded: a stand-in file of the current digest's name plays the built
library, which is all the bank moves."""

import json
import os

import numpy as np
import pytest
import torch

from tsspark_tpu.serve import aotbank as jaotbank
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig
from tsspark_tpu_torch.kernels import build
from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.serve import ParamRegistry, aotbank

torch.set_num_threads(2)

CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)


@pytest.mark.parametrize("n_series,horizons,widths", [
    (6, (7, 14, 28), jaotbank.DEFAULT_WIDTHS),
    (48, (7,), jaotbank.DEFAULT_WIDTHS),
    (30490, (7, 14, 28), jaotbank.DEFAULT_WIDTHS),
    (1000, (1, 9, 33, 100), (8, 64, 512, 4096)),
    (0, (3,), (16, 32)),
])
def test_shape_ladder_is_the_jax_packages(n_series, horizons, widths):
    assert aotbank.shape_ladder(n_series, horizons, widths) == \
        jaotbank.shape_ladder(n_series, horizons, widths)


@pytest.fixture
def snap(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(120.0)
    y = 10 + rng.normal(0, 1, (12, 120))
    _, meta = prepare_fit_data(t, y, CFG)
    p = 2 + CFG.n_changepoints + 2 * 2 + 1
    arrays = {
        "theta": rng.normal(0, 0.1, (12, p)).astype(np.float32),
        "loss": np.zeros(12, np.float32),
        "grad_norm": np.zeros(12, np.float32),
        "converged": np.ones(12, bool), "n_iters": np.zeros(12, np.int32),
        "status": np.zeros(12, np.int32), **meta._asdict(),
    }
    reg = ParamRegistry(str(tmp_path / "registry"), CFG)
    reg.publish(fitstate_from_numpy(arrays, "cpu"),
                [f"s{i}" for i in range(12)], step=np.ones(12))
    return reg.load()


@pytest.fixture
def built(tmp_path, monkeypatch):
    """This process's build directory, holding a stand-in library of the
    current digest (the pointer restored afterwards)."""
    d = tmp_path / "build"
    d.mkdir()
    (d / build.lib_name()).write_bytes(b"stand-in library")
    monkeypatch.setattr(build, "_dir", str(d))
    return str(d)


class _Backend:
    config = CFG


def _events(spans_path):
    return [r for r in obs.read_records(spans_path)
            if r.get("kind") == "event"]


@pytest.fixture
def run(tmp_path):
    """An obs run bound for the test's events, the previous binding
    restored afterwards."""
    path = str(tmp_path / "spans.jsonl")
    prev = obs.start_run(path)
    yield path
    obs.end_run(prev)


def test_build_bank_is_idempotent_across_flips(tmp_path, snap, built, run):
    bank = str(tmp_path / "bank")
    first = aotbank.build_bank(snap, _Backend(), dirpath=bank,
                               horizons=(7, 14, 28))
    assert first["status"] == "built" and first["how"] == "copied"
    with open(os.path.join(bank, first["library"]), "rb") as fh:
        assert fh.read() == b"stand-in library"
    man = aotbank.read_manifest(bank)
    assert man["digest"] == build.digest()
    assert man["ladder"] == [list(p) for p in
                             aotbank.shape_ladder(12, (7, 14, 28))]
    mtime = os.path.getmtime(os.path.join(bank, aotbank.AOT_MANIFEST))
    again = aotbank.build_bank(snap, _Backend(), dirpath=bank,
                               horizons=(7, 14, 28))
    assert again["status"] == "present"
    assert os.path.getmtime(
        os.path.join(bank, aotbank.AOT_MANIFEST)) == mtime
    # Another ladder is another bank manifest (the library stays).
    other = aotbank.build_bank(snap, _Backend(), dirpath=bank,
                               horizons=(7,))
    assert other["status"] == "built" and other["how"] == "present"
    # No directory configured: a no-op.
    assert aotbank.build_bank(snap, _Backend(), dirpath=None) is None
    assert [e["name"] for e in _events(run)].count("aotbank.built") == 2


def test_empty_bank_builds_the_library(tmp_path, snap, run, monkeypatch):
    """Where neither the bank nor this process's build directory holds the
    current digest's library, the publish compiles it into the bank (a
    stand-in compiler writes the file), counted as a build; a second
    publish finds it, and a replica armed there loads it."""
    empty = tmp_path / "empty_build"
    empty.mkdir()
    monkeypatch.setattr(build, "_dir", str(empty))
    compiled = []

    def compile_stand_in(nvcc, sources, lib_path):
        compiled.append(lib_path)
        with open(lib_path, "wb") as fh:
            fh.write(b"compiled stand-in")

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_compile", compile_stand_in)
    monkeypatch.setattr(build, "builds", build.builds)
    builds = build.builds
    bank = str(tmp_path / "bank")
    got = aotbank.build_bank(snap, _Backend(), dirpath=bank)
    assert got["status"] == "built" and got["how"] == "built"
    assert compiled == [os.path.join(os.path.abspath(bank),
                                     build.lib_name())]
    assert build.builds == builds + 1
    assert os.listdir(empty) == []
    assert aotbank.build_bank(snap, _Backend(), dirpath=bank)[
        "status"] == "present"
    assert len(compiled) == 1
    assert aotbank.arm(bank)["armed"]
    assert build.build_dir() == os.path.abspath(bank)


def test_arm_points_the_library_at_a_current_bank(tmp_path, snap, built,
                                                  run):
    bank = str(tmp_path / "bank")
    aotbank.build_bank(snap, _Backend(), dirpath=bank)
    got = aotbank.arm(bank)
    assert got == {"armed": True, "dir": os.path.abspath(bank),
                   "reason": None}
    assert build.build_dir() == os.path.abspath(bank)
    assert "aotbank.armed" in [e["name"] for e in _events(run)]


def test_missing_bank_degrades_with_an_event(tmp_path, built, run,
                                             monkeypatch):
    monkeypatch.setenv(aotbank.AOT_CACHE_ENV, str(tmp_path / "nothing"))
    got = aotbank.arm_from_env()
    assert not got["armed"] and got["reason"] == "no manifest"
    assert build.build_dir() == built
    ev = [e for e in _events(run) if e["name"] == "aotbank.stale"]
    assert ev and ev[0]["attrs"]["reason"] == "no manifest"
    monkeypatch.delenv(aotbank.AOT_CACHE_ENV)
    assert aotbank.arm_from_env() is None


@pytest.mark.parametrize("fault", ["digest", "library"])
def test_stale_bank_degrades_with_an_event(tmp_path, snap, built, run,
                                           fault):
    bank = str(tmp_path / "bank")
    man = aotbank.build_bank(snap, _Backend(), dirpath=bank)
    if fault == "digest":
        path = os.path.join(bank, aotbank.AOT_MANIFEST)
        with open(path) as fh:
            m = json.load(fh)
        m["digest"] = "0" * 16
        with open(path, "w") as fh:
            json.dump(m, fh)
    else:
        os.remove(os.path.join(bank, man["library"]))
    got = aotbank.arm(bank)
    assert not got["armed"]
    assert got["reason"].startswith(
        "stale" if fault == "digest" else "library file missing")
    assert build.build_dir() == built
    assert [e["name"] for e in _events(run)][-1] == "aotbank.stale"
    # A later publish repairs the bank.
    assert aotbank.build_bank(snap, _Backend(), dirpath=bank)[
        "status"] == "built"
    assert aotbank.arm(bank)["armed"]


def test_warm_ladder_launches_each_shape_once(snap):
    from tsspark_tpu_torch.backends.registry import get_backend

    calls = []
    backend = get_backend("cuda", CFG, device="cpu")
    real = backend.predict

    def spy(state, grid, **kw):
        calls.append(np.asarray(grid).shape)
        return real(state, grid, **kw)

    backend.predict = spy
    ladder = aotbank.shape_ladder(12, (7, 14))
    out = aotbank.warm_ladder(snap, backend, ladder)
    assert out["shapes"] == [list(p) for p in ladder]
    assert calls == [(w, hb) for w, hb in ladder]
