"""Mesh-resident single-program fit path (``orchestrate --_resident``; the
port's copy of the JAX package's ``resident.py``).

The chunk-file protocol (``tsspark_tpu_torch.orchestrate``) is correct
and crash-safe, but every chunk pays a process spawn, a CUDA context and
a kernel-library load.  When a device mesh is available (``parallel.mesh``:
two or more CUDA devices, or the virtual host mesh of CPU entries that
tests and CPU runs force), the whole fleet instead runs as ONE in-process
stream of waves:

* **same program, sharded**: every wave runs
  ``parallel.sharding.fit_resident_core``, which on each series shard is
  exactly ``fit_core_packed`` (the chunk workers' program) over that
  shard's rows, with inputs laid out by the resident partition rules
  (``resident_partition_rules`` -> ``match_partition_rules`` ->
  ``make_shard_and_gather_fns``).  Time is never split.
* **plane-fed**: claims gate on the data plane's landed coverage
  (``data.plane.ready_coverage``) and read the column memmaps directly;
  there are no per-chunk prep files.
* **checkpointed through the same protocol**: every wave lands through
  ``save_chunk_atomic`` under the same lease fencing, so crash-resume,
  exactly-once coverage and ``publish_fit_state`` hold unchanged; a
  killed resident run resumes from its last landed flush, here or
  through the file protocol (the two paths' files are interchangeable).
* **fallback**: a box without a usable mesh (one device) warns ONCE and
  runs the chunk-file protocol (``run_resilient``), cold, as the
  reference does on a one-device host.  An explicit ``mesh=`` of one
  device is accepted (``_shards_for_width(w, 1)`` is 1) and runs the
  resident program itself.

**What the port owes, bit for bit** (measured; tests/test_torch_resident.py):

* N = 1: a wave of width W is one ``fit_core_packed`` call over W rows,
  as a chunk worker's chunk is, so the assembled FitState (solver outputs
  and scaling meta) is bitwise the file protocol's at chunk W, on the
  card and on the CPU.
* N > 1 (the CPU's virtual host mesh): a shard is a batch of W/k rows.
  On the CPU a row's fit is the same bits at W/k rows as at W (the plain
  path's per-row reductions and the ridge init's batched float32
  factorizations do not mix rows there), so N > 1 also owes the file
  protocol's bits at chunk W, as in the reference.  On the card a row's
  fit depends on its batch's width through the ridge init's batched
  ``torch.linalg`` rounding (ROADMAP Queue 3), so a multi-card mesh would
  owe the file protocol's bits at chunk W/k instead.

Throughput levers carried over from the file protocol: the online width
autotuner (``perf.ChunkAutotuner``, here tuning the per-wave width with
the shard count as its multiple), the adaptive phase-1 depth
(``backends.cuda.tune_phase1_depth``) and a prep lookahead.  The port's
solver waits for the device at every segment's convergence check, so a
wave's device work ends when its dispatch returns: each wave is flushed
(one checkpoint) right after it, and the overlap is host prep (a
two-thread pool, ``pipeline_depth`` waves prepared ahead of the one
dispatching) with the solve and the flush.  Every wave gets fresh inputs: nothing a wave reads is a cached or reused
buffer another wave writes (the reference reverted ``theta0`` donation
because shards were corrupted under overlapped waves).
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings
from collections import deque
from typing import Callable, Optional

from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.io import (
    atomic_write,
    atomic_write_text,
    sweep_stale_temps,
)
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.resilience import faults, integrity

#: The resident flush-state artifact: one small JSON replaced atomically
#: per flush (wave index, coverage, mesh shape, path), field for field
#: the JAX package's.
RESIDENT_STATE_FILE = "resident.json"

#: Minimum series rows per shard for a resident dispatch (the reference's
#: measured parity floor, kept so both packages take the same sub-mesh
#: decisions): a wave narrower than ``2 * n_shards`` runs on a sub-mesh
#: (``_shards_for_width``), never padded.
MIN_ROWS_PER_SHARD = 2

# One-shot flag for the meshless degradation warning.
_MESHLESS_WARNED = False


def usable_mesh(min_devices: int = 2, device=None):
    """A 1-D series mesh over every default device
    (``parallel.mesh.default_devices``: the CUDA devices, or the forced
    virtual host mesh's CPU entries), or None when there are fewer than
    ``min_devices``.  ``device`` keeps only entries of its type (a CPU
    request never meshes the card).  None means: use the file protocol."""
    import torch

    from tsspark_tpu_torch.parallel import mesh as mesh_mod

    try:
        devices = mesh_mod.default_devices()
    except Exception:
        return None
    if device is not None:
        kind = torch.device(device).type
        devices = [d for d in devices if d.type == kind]
    if len(devices) < min_devices:
        return None
    return mesh_mod.make_mesh(
        n_series_shards=len(devices), n_time_shards=1, devices=devices
    )


def _shards_for_width(width: int, n_devices: int) -> int:
    """Series-shard count for one resident wave: the largest power of two
    that divides ``width``, fits the device count, and keeps at least
    :data:`MIN_ROWS_PER_SHARD` rows on every shard."""
    k = 1
    while (k * 2 <= n_devices and width % (k * 2) == 0
           and width // (k * 2) >= MIN_ROWS_PER_SHARD):
        k *= 2
    return k


def _write_resident_state(out_dir: str, payload: dict) -> None:
    """Replace the resident flush-state artifact atomically."""
    atomic_write(
        os.path.join(out_dir, RESIDENT_STATE_FILE),
        lambda fh: json.dump(payload, fh), mode="w",
    )


def _times_row(out_dir: str, row: dict) -> None:
    """One times.jsonl row (the chunk workers' append-only log)."""
    with open(os.path.join(out_dir, "times.jsonl"), "a") as fh:
        fh.write(json.dumps(row) + "\n")


def run_resident(
    *,
    data_dir: str,
    out_dir: str,
    series: int,
    chunk: int = 1024,
    phase1_iters: int = 12,
    no_phase1_tune: bool = False,
    autotune: bool = False,
    pipeline_depth: int = 2,
    deadline: Optional[float] = None,
    reserve: Callable[[], float] = lambda: 10.0,
    mesh=None,
    state: Optional[dict] = None,
    fallback_opts: Optional[dict] = None,
    theta0_fn: Optional[Callable[[int, int], "object"]] = None,
    device=None,
) -> dict:
    """Run the whole fit as one mesh-resident sharded wave stream.

    Drop-in peer of ``orchestrate.run_resilient`` over the same scratch
    protocol: ``data_dir`` is a spill dir or plane dataset, ``out_dir``
    accumulates the same ``chunk_*.npz`` coverage.  Returns the mutated
    ``state`` dict with ``complete`` and ``fit_path`` (``"resident"``, or
    ``"fileproto"`` after the meshless fallback).

    ``chunk`` is the claim width (the autotuner's cap with
    ``autotune=True``); ``pipeline_depth``: the waves prepared ahead of
    the one dispatching.  ``mesh``: a ``parallel.mesh.Mesh`` (its series axis first);
    None takes ``usable_mesh(device=device)``, and without one the run
    falls back (one warning a process) to ``run_resilient`` with
    ``device`` and ``fallback_opts``.

    ``theta0_fn``: optional warm start, ``fn(lo, hi)`` -> host ``(hi -
    lo, n_params)`` float32 rows for the wave's REAL rows (pad rows are
    zeros); phase 1 then runs from them instead of the ridge init.
    ``theta0_fn=None`` leaves the cold path bit for bit untouched.  The
    meshless fallback runs COLD (the chunk workers have no warm-start
    input), as the reference's does.
    """
    global _MESHLESS_WARNED
    if state is None:
        state = {}
    state.setdefault("retries", 0)
    mesh = mesh if mesh is not None else usable_mesh(device=device)
    if mesh is None:
        if not _MESHLESS_WARNED:
            _MESHLESS_WARNED = True
            warnings.warn(
                "run_resident: no usable device mesh on this box (one "
                "device); degrading to the chunk-file protocol "
                "(orchestrate.run_resilient), the fault-domain fallback.  "
                "Results are identical; the resident path's per-wave "
                "speedup is not.",
                RuntimeWarning, stacklevel=2,
            )
        kwargs = dict(
            data_dir=data_dir, out_dir=out_dir, series=series, chunk=chunk,
            min_chunk=min(orchestrate.MIN_CHUNK, chunk), segment=0,
            phase1_iters=phase1_iters, no_phase1_tune=no_phase1_tune,
            autotune=autotune, deadline=deadline, reserve=reserve,
            state=state, device=device,
        )
        kwargs.update(fallback_opts or {})
        out = orchestrate.run_resilient(**kwargs)
        out["fit_path"] = "fileproto"
        return out
    # Bounded recovery loop: a round that ends with coverage incomplete (a
    # torn chunk re-queued, a fenced wave discarded, a drained ingest) is
    # re-entered as long as it LANDED something (the landed range set
    # changed); a zero-progress round means the blocker is external.
    rounds = 0
    while True:
        before = tuple(sorted(orchestrate.completed_ranges(out_dir)))
        rc = _resident_body(
            data_dir=data_dir, out_dir=out_dir, series=series, chunk=chunk,
            phase1_iters=phase1_iters, no_phase1_tune=no_phase1_tune,
            autotune=autotune, pipeline_depth=pipeline_depth,
            deadline=deadline, reserve=reserve, mesh=mesh, state=state,
            theta0_fn=theta0_fn,
        )
        complete = (rc == 0 and not orchestrate.missing_ranges(
            orchestrate.completed_ranges(out_dir), series
        ) and os.path.exists(os.path.join(out_dir, "phase2_done")))
        if complete or rc != 0:
            break
        rounds += 1
        state["retries"] = rounds
        changed = tuple(sorted(
            orchestrate.completed_ranges(out_dir)
        )) != before
        if not changed or rounds > 8:
            break
    state["fit_path"] = "resident"
    state["complete"] = complete
    return state


def _resident_body(*, data_dir, out_dir, series, chunk, phase1_iters,
                   no_phase1_tune, autotune, pipeline_depth, deadline,
                   reserve, mesh, state, theta0_fn=None) -> int:
    import numpy as np

    from tsspark_tpu_torch.backends.cuda import (
        _concat_states,
        _take_rows,
        difficulty_order,
        patch_state,
        phase1_dynamic_args,
        phase2_dynamic_args,
        tune_phase1_depth,
    )
    from tsspark_tpu_torch.data import plane as data_plane
    from tsspark_tpu_torch.device import set_precision
    from tsspark_tpu_torch.models.prophet.design import (
        ScalingMeta,
        pack_fit_data,
        prepare_fit_data,
    )
    from tsspark_tpu_torch.models.prophet.model import fitstate_from_packed
    from tsspark_tpu_torch.parallel import sharding as sharding_mod
    from tsspark_tpu_torch.parallel.mesh import Mesh
    from tsspark_tpu_torch.perf import ChunkAutotuner, CompileWatch
    from tsspark_tpu_torch.resilience.report import STATUS_QUARANTINED

    t_run0 = time.time()
    set_precision()
    os.makedirs(out_dir, exist_ok=True)
    sweep_stale_temps(out_dir)
    integrity.sweep_chunks(out_dir)
    model_config, solver_config = orchestrate.load_run_config(out_dir)
    ds, d = orchestrate._load_data(data_dir)
    y, mask, reg = d["y"], d["mask"], d["reg"]
    cap, floor = d["cap"], d["floor"]
    n_params = model_config.num_params
    collapse_cap = model_config.growth != "logistic"
    max_iters = solver_config.max_iters
    two_phase = 0 < phase1_iters < max_iters
    series_axis = mesh.axis_names[0]
    n_shards = int(mesh.shape[series_axis])
    mesh_devices = list(mesh.devices[:, 0])
    dev0 = mesh_devices[0]
    ingest_stall_s = float(os.environ.get("TSSPARK_INGEST_STALL_S", "30"))

    hb_path = os.path.join(out_dir, "heartbeat")

    def heartbeat():
        atomic_write_text(hb_path, str(time.time()))

    kernels = orchestrate._load_kernels(dev0, heartbeat)
    # The u8 indicator split: decide_u8_split is THE shared decision, so
    # resident and file-protocol runs of the same data always agree.
    u8_cols = orchestrate.decide_u8_split(
        data_dir, reg, series, heartbeat=heartbeat,
        stall_s=ingest_stall_s,
    )
    _times_row(out_dir, {
        "resident": os.getpid(), "kernels": kernels,
        "mesh": [n_shards, 1], "ready_unix": round(time.time(), 3),
        "start_unix": round(t_run0, 3), **orchestrate._device_row(dev0),
    })

    # Wave-width autotuner: the chunk workers' pow-2 hill climber in the
    # same autotune.json, floored at the shard count (``multiple``) so
    # steady-state waves span the whole mesh.
    tuner = None
    if autotune:
        tuner = ChunkAutotuner.load(
            os.path.join(out_dir, "autotune.json"),
            cap=chunk, floor=min(chunk, 128), multiple=n_shards,
        )
    compile_watch = CompileWatch.default()

    # Sub-mesh ladder: a wave narrower than 2 * n_shards runs on fewer
    # devices (MIN_ROWS_PER_SHARD), never padded.  Shard functions are
    # cached per (shard count, X_season rank); each call still places
    # fresh tensors.
    _meshes = {n_shards: Mesh(np.asarray(mesh_devices, dtype=object)
                              .reshape(n_shards, 1), mesh.axis_names)}
    shard_fns_cache: dict = {}

    def mesh_for(k: int):
        if k not in _meshes:
            _meshes[k] = Mesh(
                np.asarray(mesh_devices[:k], dtype=object).reshape(k, 1),
                mesh.axis_names,
            )
        return _meshes[k]

    def theta_placed(host, k: int):
        return sharding_mod.shard_array(
            mesh_for(k), sharding_mod.P(series_axis, None), host)

    def shard_payload(packed, k: int):
        per_series = packed.X_season.ndim == 3
        key = (k, per_series)
        if key not in shard_fns_cache:
            specs = sharding_mod.match_partition_rules(
                sharding_mod.resident_partition_rules(
                    series_axis, per_series
                ),
                packed,
            )
            shard_fns_cache[key] = sharding_mod.make_shard_and_gather_fns(
                mesh_for(k), specs
            )[0]
        return sharding_mod.apply_fns(shard_fns_cache[key], packed)

    def theta_init(lo, hi, width, k):
        """The wave's init buffer, fresh every wave: zeros (ridge init,
        the cold path) or the caller's warm rows padded with zeros."""
        host = np.zeros((width, n_params), np.float32)
        if theta0_fn is not None:
            host[:hi - lo] = np.asarray(theta0_fn(lo, hi), np.float32)
        return theta_placed(host, k)

    def prep(lo, hi, width):
        """Pack rows [lo, hi) padded to ``width``: the chunk workers'
        exact prep (shared ``_pad_chunk_rows`` / ``_chunk_mask``), read
        off the memmaps directly."""
        rows = lambda a, fill=0.0: orchestrate._pad_chunk_rows(  # noqa: E731
            a, lo, hi, width, fill
        )
        y_c = rows(y)
        data, meta = prepare_fit_data(
            ds, y_c, model_config,
            mask=orchestrate._chunk_mask(y_c, mask, lo, hi, width),
            regressors=rows(reg), cap=rows(cap, fill=1.0),
            floor=rows(floor),
        )
        packed, _ = pack_fit_data(data, meta, ds, reg_u8_cols=u8_cols,
                                  collapse_cap=collapse_cap)
        return lo, hi, width, hi - lo, packed, meta

    # ---- claims: the chunk-file protocol's plan/lease machinery.  Mirrors
    # ---- fit_worker's next_claim (orchestrate.py) minus the stolen-span
    # ---- bookkeeping; the claim invariants are THE SAME — change both. ---
    claimed: list = []
    held_leases: set = set()
    lease_token = f"resident.{os.getpid()}.{int(t_run0 * 1e3)}"
    claim_spans: dict = {}

    def next_claim(block: bool = True):
        waited = 0.0
        while True:
            width = tuner.next_size() if tuner is not None else chunk
            ready = data_plane.ready_coverage(data_dir, series)
            todo = orchestrate.plan_chunks(
                orchestrate.completed_ranges(out_dir) + claimed,
                0, series, width,
            )
            if ready is not None:
                todo = [(l2, h2) for l2, h2 in todo
                        if data_plane.covers(ready, l2, h2)]
            for lo2, hi2 in todo:
                claim_sid = obs.new_id() if obs.active() else None
                if not orchestrate.claim_lease(out_dir, lo2, hi2,
                                               lease_token,
                                               span_id=claim_sid):
                    continue
                claimed.append((lo2, hi2))
                held_leases.add((lo2, hi2))
                if claim_sid is not None:
                    claim_spans[(lo2, hi2)] = claim_sid
                    obs.record("chunk.claim", time.time(), 0.0,
                               span_id=claim_sid, lo=lo2, hi=hi2,
                               width=width, resident=True)
                return lo2, hi2, width
            if ready is None or not data_plane.ingest_pending(
                data_dir, series
            ):
                return None
            if not block:
                return None
            if deadline is not None and \
                    deadline - time.time() < reserve():
                # This wait runs in the caller's process: it must not
                # sleep out an ingest stall past the reserve.
                return None
            heartbeat()
            time.sleep(0.5)
            waited += 0.5
            if waited >= ingest_stall_s:
                waited = 0.0
                if not data_plane.produce_next_missing(data_dir):
                    return None

    # ---- phase 1: pipelined resident waves ------------------------------
    depth = {"v": phase1_iters if two_phase else max_iters,
             "tuned": not two_phase or bool(no_phase1_tune)}
    crash_after = int(os.environ.get("TSSPARK_TEST_CRASH_AFTER", "0"))
    n_flushed = 0
    last_flush_t = {"t": t_run0}
    device_str = str(dev0)

    def flush_wave(wave):
        """Land one computed wave through the chunk protocol: lease fence
        -> save_chunk_atomic -> release, plus the chunk workers'
        spans / metrics / times.jsonl telemetry."""
        nonlocal n_flushed
        (lo, hi, width, b_real, meta, theta, stats, compiled, t_sub,
         k_sh) = wave
        theta = np.asarray(theta)[:b_real]
        stats = np.asarray(stats)[:, :b_real]
        heartbeat()
        state_w = fitstate_from_packed(
            theta, stats,
            ScalingMeta(*(np.asarray(a)[:b_real] for a in meta)),
        )
        now = time.time()
        wall = max(now - last_flush_t["t"], 1e-9)
        last_flush_t["t"] = now
        if not orchestrate.holds_lease(out_dir, lo, hi, lease_token):
            print(
                f"[resident] lease on [{lo}, {hi}) lost; discarding this "
                f"wave's result (fenced)", file=sys.stderr,
            )
            obs.event("fenced", lo=lo, hi=hi, resident=True)
            return None
        t_save0 = time.time()
        corrupted = orchestrate.save_chunk_atomic(out_dir, lo, hi, state_w)
        orchestrate.release_lease(out_dir, lo, hi, lease_token)
        held_leases.discard((lo, hi))
        if obs.active():
            fit_sid = obs.record(
                "chunk.fit", t_sub, t_save0 - t_sub,
                parent_id=claim_spans.get((lo, hi)),
                lo=lo, hi=hi, width=width, live=hi - lo,
                compile_miss=bool(compiled), resident=True,
            )
            obs.record("chunk.land", t_save0, time.time() - t_save0,
                       parent_id=fit_sid, lo=lo, hi=hi,
                       **({"corrupted": True} if corrupted else {}))
            orchestrate._metrics_chunk(hi - lo, wall)
        if tuner is not None and hi - lo == width:
            tuner.record(width, hi - lo, wall, compile_miss=compiled)
        n_flushed += 1
        done_now = orchestrate.completed_ranges(out_dir)
        _write_resident_state(out_dir, {
            "unix": round(time.time(), 3), "wave": n_flushed,
            "landed": sum(h - l for l, h in done_now),
            "series": series, "mesh": [n_shards, 1],
            "width": width, "path": "resident",
        })
        _times_row(out_dir, {
            "lo": lo, "hi": hi, "fit_s": round(wall, 3),
            "chunk": chunk, "width": width, "live": hi - lo,
            "series_per_s": round((hi - lo) / wall, 2),
            "compile_miss": bool(compiled),
            "t": round(time.time() - t_run0, 2),
            "device": device_str, "path": "resident",
            "shards": k_sh, "pid": os.getpid(), "depth": depth["v"],
            "launches": orchestrate._launch_counts(),
            **{k: v for k, v in orchestrate._device_row(dev0).items()
               if k != "device"},
        })
        # Chaos hook: the resident-kill fault class arms this point.
        faults.inject("resident_flush", lo=lo, hi=hi)
        if crash_after and n_flushed >= crash_after:
            os._exit(17)  # simulated mid-run resident death
        return state_w

    from concurrent.futures import ThreadPoolExecutor

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            pending: deque = deque()    # prep futures

            def submit_prep(block=False) -> bool:
                c = next_claim(block=block)
                if c is None:
                    return False
                lo2, hi2, w2 = c
                pending.append(pool.submit(prep, lo2, hi2, w2))
                return True

            def dispatch(fut):
                lo, hi, width, b_real, packed, meta = fut.result()
                faults.inject("fit_chunk", lo=lo, hi=hi)
                t_sub = time.time()
                k = _shards_for_width(width, n_shards)
                snap = compile_watch.size()
                p1 = phase1_dynamic_args(depth["v"], theta0_fn is not None,
                                         solver_config)
                theta, stats = sharding_mod.fit_resident_core(
                    shard_payload(packed, k), theta_init(lo, hi, width, k),
                    model_config, p1["solver_config"],
                    reg_u8_cols=u8_cols,
                    use_theta0_dynamic=p1["use_init"],
                )
                compiled = compile_watch.size() > snap
                return (lo, hi, width, b_real, meta, theta, stats,
                        compiled, t_sub, k)

            for i in range(pipeline_depth + 1):
                if not submit_prep(block=(i == 0)):
                    break
            while pending:
                if deadline is not None and \
                        deadline - time.time() < reserve():
                    return 1  # budget reached; landed coverage persists
                wave = dispatch(pending.popleft())
                submit_prep()
                st0 = flush_wave(wave)
                if not depth["tuned"]:
                    # Depth settles before wave 1 dispatches (the chunk
                    # workers' policy point:
                    # backends.cuda.tune_phase1_depth).
                    if st0 is not None:
                        frac = float((~np.asarray(st0.converged)).mean())
                        depth["v"] = tune_phase1_depth(
                            depth["v"], frac, max_iters
                        )
                    depth["tuned"] = True
                if not pending:
                    submit_prep(block=True)
    finally:
        # Unflushed claims must not leave LIVE leases behind: a successor
        # in this same process would be locked out until expiry.
        for lo_h, hi_h in sorted(held_leases):
            orchestrate.release_lease(out_dir, lo_h, hi_h, lease_token)
        held_leases.clear()

    # ---- phase 2: compacted stragglers through the same resident program
    # ---- (host gather off the memmaps, sharded dispatch).  Mirrors the
    # ---- chunk workers' "host" phase-2 branch (orchestrate.
    # ---- _fit_worker_body); change the gather/pad/patch logic in BOTH. --
    marker = os.path.join(out_dir, "phase2_done")
    if integrity.sweep_chunks(out_dir):
        return 0  # corrupt ranges re-queued; the caller's rescan refits
    done = orchestrate.completed_ranges(out_dir)
    if orchestrate.missing_ranges(done, series):
        return 0
    if not two_phase:
        if not os.path.exists(marker):
            atomic_write_text(marker, "ok\n")
            obs.record("phase2.done", time.time(), 0.0)
        return 0
    if os.path.exists(marker):
        return 0

    t_p2 = time.time()
    straggler_idx, straggler_theta, straggler_gn = [], [], []
    files = {}
    for lo, hi in done:
        z = dict(np.load(orchestrate._chunk_path(out_dir, lo, hi)))
        files[(lo, hi)] = z
        if z.get("phase2") is not None:
            continue
        bad = np.flatnonzero(
            ~z["converged"] & (z["status"] != STATUS_QUARANTINED)
        )
        straggler_idx.extend(int(lo + i) for i in bad)
        straggler_theta.append(z["theta"][bad])
        straggler_gn.append(z["grad_norm"][bad])
    if straggler_idx:
        heartbeat()
        idx = np.asarray(straggler_idx)
        order = difficulty_order(np.concatenate(straggler_gn))
        idx = idx[order]
        theta_cat = np.concatenate(straggler_theta, axis=0)[order]
        n_s = len(straggler_idx)
        p2_chunk = tuner.best_size if tuner is not None else chunk
        pad = (-n_s) % p2_chunk
        pad_rows = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]
        ) if pad else a
        g = lambda a: None if a is None else pad_rows(  # noqa: E731
            np.ascontiguousarray(a[idx], np.float32)
        )
        y_s = g(y)
        if mask is not None:
            m_s = g(mask)
        else:
            m_s = np.zeros_like(y_s)
            m_s[:idx.size] = np.isfinite(y_s[:idx.size])
        r_s, c_s, f_s = g(reg), g(cap), g(floor)
        init_s = pad_rows(theta_cat.astype(np.float32))
        k2 = _shards_for_width(p2_chunk, n_shards)
        p2 = phase2_dynamic_args(solver_config)
        subs = []
        for lo2 in range(0, n_s + pad, p2_chunk):
            hi2 = lo2 + p2_chunk
            sl = lambda a: None if a is None else a[lo2:hi2]  # noqa: E731
            data2, meta2 = prepare_fit_data(
                ds, y_s[lo2:hi2], model_config, mask=sl(m_s),
                regressors=sl(r_s), cap=sl(c_s), floor=sl(f_s),
            )
            packed2, _ = pack_fit_data(
                data2, meta2, ds, reg_u8_cols=u8_cols,
                collapse_cap=collapse_cap,
            )
            th2, st2 = sharding_mod.fit_resident_core(
                shard_payload(packed2, k2),
                theta_placed(np.array(init_s[lo2:hi2], np.float32), k2),
                model_config, p2["solver_config"], reg_u8_cols=u8_cols,
                use_theta0_dynamic=p2["use_init"],
            )
            heartbeat()
            subs.append(fitstate_from_packed(
                np.asarray(th2), np.asarray(st2), meta2,
            ))
        state2 = _take_rows(_concat_states(subs), slice(0, n_s))
        for (lo, hi), z in files.items():
            if z.get("phase2") is not None:
                continue
            in_chunk = np.flatnonzero((idx >= lo) & (idx < hi))
            local = idx[in_chunk] - lo
            chunk_state = orchestrate._state_from_chunk(z)
            sub = _take_rows(state2, in_chunk)
            patched = patch_state(chunk_state, local, sub)
            t_patch0 = time.time()
            corrupted = orchestrate.save_chunk_atomic(
                out_dir, lo, hi, patched,
                extra_arrays={"phase2": np.asarray(1)},
            )
            obs.record("chunk.land", t_patch0, time.time() - t_patch0,
                       lo=lo, hi=hi, phase2=True,
                       **({"corrupted": True} if corrupted else {}))
    _times_row(out_dir, {
        "phase2_s": round(time.time() - t_p2, 3),
        "stragglers": len(straggler_idx),
        "phase2_mode": "resident-sharded", "pid": os.getpid(),
        "launches": orchestrate._launch_counts(),
        **{k: v for k, v in orchestrate._device_row(dev0).items()
           if k != "device"}, "device": device_str,
    })
    atomic_write_text(marker, "ok\n")
    obs.record("fit.phase2", t_p2, time.time() - t_p2,
               stragglers=len(straggler_idx), mode="resident-sharded")
    obs.record("phase2.done", time.time(), 0.0)
    return 0


def resident_worker(args) -> int:
    """Child entry point (``python -m tsspark_tpu_torch.orchestrate
    --_resident``): the resident run as a process the chaos harness can
    kill mid-flush.  Adopts the spawner's trace like the chunk workers;
    a meshless child (one card, or ``--device cpu`` without a forced
    host mesh) runs the chunk-worker body in THIS process instead (the
    same coverage protocol), as the reference's does."""
    obs.adopt_env()
    t0 = time.time()
    wspan = obs.open_span("resident.worker", make_current=True,
                          series=args.series, chunk=args.chunk)
    try:
        device = getattr(args, "device", None)
        mesh = usable_mesh(device=device)
        if mesh is None:
            args.hi = args.hi or args.series
            rc = orchestrate.fit_worker(args)
        else:
            st = run_resident(
                data_dir=args.data, out_dir=args.out, series=args.series,
                chunk=args.chunk, phase1_iters=args.phase1_iters,
                no_phase1_tune=args.no_phase1_tune,
                autotune=getattr(args, "autotune", False), mesh=mesh,
            )
            rc = 0 if st.get("complete") else 1
    except BaseException:
        obs.close_span(wspan, "resident.worker", t0, status="err")
        raise
    obs.close_span(wspan, "resident.worker", t0, rc=rc)
    if obs.active():
        from tsspark_tpu_torch.obs.metrics import DEFAULT

        try:
            DEFAULT.export(
                os.path.join(args.out,
                             f"metrics_resident_{os.getpid()}.json"),
                trace_id=obs.trace_id(),
            )
        except OSError:
            pass
    return rc
