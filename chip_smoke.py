#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Every phase runs, each printing one JSON line; any failure raises and
the script exits non-zero without printing the final line:

1. device  — card name, ``nvidia-smi`` name and power limit, kernel
   build time (every CUDA source built from ``tsspark_tpu_torch/csrc``,
   while the host generates the phases' data).
2. forward — kernel K1 against its plain PyTorch version on the card
   (B=2048, T=1969, 25 changepoints, 26 Fourier columns; shared and
   per-series features, 3 regressors; linear, flat and logistic growth).
3. bands   — kernel K2 against its plain version: first on given draws
   (B=1024, T=32, S=256, and S of 1,000 to 65,536 on a few rows, past
   one block into the device-memory scratch path; equal to float32
   tolerance), then on its own Philox draws against the plain version's
   generator (Monte-Carlo bounds on the yhat bands, where the normal
   draws dominate, and on the trend bands of a horizon where simulated
   changepoints dominate), and lo <= hi everywhere; then its own draws at
   S=65,536 on 1,024 rows x 32 steps (finite, ordered, the yhat bands
   against the plain version on 16 rows on the CPU, rows bitwise
   invariant).  Then K2's logistic branch (its offset recursion carried
   along the steps) against the plain scan: on given draws at config
   4's forecast shape (1,024 rows x 1,200 steps, S=256), there again
   with rates near 0 (``rates_near_zero``: the offset recursion's
   ill-conditioned case), and at S=65,536 on a few rows, and on its
   Philox draws against the plain version's generator (Monte-Carlo
   bounds on the yhat and the trend bands).
4. loss    — kernel K3 against its plain version (B=1024, T=1746, config
   3's widths, and config 4's): value and gradient modes, linear, flat
   and logistic growth (rates clear of 0, ``logistic_theta``, and on
   config 4 also near 0, ``rates_near_zero``), additive and
   multiplicative features, shared and per-series seasonal matrices,
   with and without regressors, a stack of trial points, and a 21-trial
   stack (the trial-stack layout) whose every trial holds the bits of
   its launch alone; near 0 also K3's and the plain float32 gradient's
   distances from the plain version in float64.
5. fan     — kernel K4 against its plain version on the same cases
   (linear growth, a 20-rung ladder).
6. serve   — the serving path at full width: ``m5_like(30490, 1941)``
   prepared under the default ``ProphetConfig`` (26 Fourier columns, 25
   changepoints, 256 samples), parameters drawn from ``--seed``,
   published into a parameter registry at the top of the run
   (``serve_registry``, from phase fit's generated series without their
   regressors, the same bits; beside the kernels' build, as every
   generator is, on ``setup_data``'s threads; the registry lives until
   phase serve_scale) and served by a
   ``PredictionEngine`` on the card: four requests (all series
   deterministic, 4,096 sampled, all sampled, a cached repeat) and one
   in-sample + 28-day ``backend.predict`` over the shared calendar.
   Kernel launch counts are set to 0 just before and read just after.
   Then a profile of requests (a) and (c) on a cacheless engine: device
   busy time from ``torch.profiler``, host time per stage from the
   engine's and the backend's own stage clocks.
7. fit     — the fit path at full width: eval config 3
   (``eval/configs.py``: ``m5_like(30490, 1941)`` with its holiday,
   price and promo regressors, yearly order 8 + weekly order 3, 25
   changepoints, ``SolverConfig(max_iters=120)``) fitted on the first
   1,746 days of every series through ``CudaBackend.fit`` on the card,
   then forecast over all 1,941 days through K1 and scored (sMAPE on
   train and holdout).  Launch counts (K3 per mode) set to 0 just
   before, read just after.  Stage split, iterations, status counts, host time per solver
   iteration, peak memory, and the device-idle share of one chunk's solve
   under ``torch.profiler``.  Then parity on a 128-series subset: sMAPE
   against the port's scipy oracle (``backends/cpu.py``), and the loss
   against that oracle and the port's own plain fit on the CPU, on
   average and per series (``loss_parity``).
8. mcmc    — the full-posterior path on config 3's batch (phase fit's)
   at full width: ``ProphetModel.fit_mcmc`` with ``McmcConfig()`` (the
   MAP fit, then 300 warmup and 300 kept transitions of 24 leapfrog
   steps, one chain a series, K3 under every step), then
   ``predict_mcmc`` over all 1,941 days (K6, a launch per 512 rows).
   Launch counts set to 0 just before, read just after; stage split,
   wall a leapfrog, acceptance, divergences, split-R-hat and ESS, sMAPE
   of the posterior mean, the band's holdout coverage, peak memory.
   Then K3 and its plain version give a non-finite loss at the same
   points far from the MAP; the sampler on 64 series against the same
   sampler driven by the plain loss (other seeds; z rule, ``Z_LIMIT``);
   K6 against its plain version on given draws (small shapes of linear,
   flat and logistic growth, both thread caps, one draw, no feature and
   more than 32; the path's first 512-row chunk) and its rows bitwise
   invariant; eight full-width transitions under the
   profiler (the card's idle share).
9. fit_logistic — logistic growth's path: eval config 4 at 8,192
   series (``config4_wiki_logistic(scale=1024)``'s batch: 1,200 days,
   capacity, weekly multiplicative order 3, 15 changepoints,
   ``SolverConfig(max_iters=200)``) fitted on its first 1,080 days
   through ``CudaBackend.fit`` (K3's logistic branch, its line search a
   stacked value pass through K3's trial-stack layout, whose own launch
   count must be non-zero), then ``predict(..., cap=, num_samples=256)``
   over all 1,200 days (K1, K2's logistic branch).  Launch counts set to
   0 just before, read just after; stage split, status counts, sMAPE on
   train and holdout, bands ordered; loss parity on 64 series against
   the scipy oracle and the plain CPU fit (``LIMITS4``).
10. stream5 — continuous refit, eval config 5 at its published scale
   (``eval/configs.py`` ``config5_run``: 50 daily series x 730 days, a
   510-day base batch and three 73-day micro-batches, weekly order 3,
   10 changepoints, ``SolverConfig(max_iters=60)``) through
   ``StreamingForecaster`` on the card: the runner's throwaway pass,
   the warm run, the cold run and a replay of the last micro-batch; the
   runner's whole dict.  Held against the port's plain CPU run of the
   same schedule: equal counts, each series' forecast sMAPE within
   ``STREAM_SMAPE_TOL``, which a planted fault fails; the replay
   idempotent.  K3 (both modes) and K4 on its 50-series chunk by
   GAP_RULE, off the optimum (``hold_stream_kernels``: one dropped cell
   must fail there), and K1 on its 50 x 14 forecast chunk, against their
   plain versions.  The JAX package's recorded CPU reading beside it.
11. stream_fleet — the same generator, model and schedule at the M5
   fleet's scale, cut to the first 8,192 of its 30,490 series and the
   subset's (``FLEET_CUT``: 8,239 series): the warm run, a replay of its
   last micro-batch, the cold run; per micro-batch its wall, the driver's and
   the backend's stages, warm and cold starts and K3/K4 launches (counts
   set to 0 just before each, read just after); the forecasts' sMAPE
   (K1), one 256-sample forecast (K2), K3 (both modes), K4, K1 and K2
   against their plain versions at the path's shapes (K3 and K4 as in
   stream5, on the fleet's 8,192-row chunk), one warm chunk's solve
   under the profiler; the 64-series subset's forecasts against the same
   series streamed on the CPU plain path, and the replay's against the
   warm run's, per series in units of the noise (``FLEET_NOISE_TOL``,
   which a planted fault fails).
12. uncertainty — the uncertainty tier at the M5 fleet's width (the JAX
   package's calibration recipe): serve's ``m5_like(30490, 1941)`` batch
   under ``ProphetConfig()`` with the last 28 days withheld, the MAP fit
   (``CudaBackend.fit``, ``SolverConfig(max_iters=25)``), ``publish``,
   ``fit_advi`` at ``AdviConfig()`` (200 steps: K3's gradient on the
   121,960-row draw stack in its draw-stack layout, required on every
   step, and K7), ``save_posterior``, the ADVI-mode
   quantile plane (``qplane.maybe_publish``), ``evaluate_version`` on the
   held-out days, 200 reads through ``PredictionEngine.quantiles``, 512
   MAP-mode reads of a version without a posterior (K1), and
   ``gold.audit_version`` (8 rows, ``McmcConfig()``).  Launch counts set
   to 0 just before, read just after.  Then the path's ADVI loop replayed
   step by step (the same bits): K3 on the first and last steps' whole
   draw stacks, each draw the bits of its rows' row-layout launch alone,
   and on their first 512 series x 4 draws by GAP_RULE against the plain
   version (a dropped cell must fail), K7 bitwise against its plain
   version at both steps; the plane bitwise
   against ``compute_rows`` on 512 rows and ordered and finite over all;
   the card's ADVI against the plain CPU path on 64 series with the same
   MAP theta and draws (``ADVI_PARITY``, which two planted faults fail);
   walls, ms a step (K3, K7, the rest), the idle share of five steps,
   coverage per bucket, read latency, the audit's qdiv, R-hat and ESS.
13. planes — on phase uncertainty's registry and ADVI version: the
   forecast plane's publish (``fplane.maybe_publish``: K1 over 30,490
   rows at buckets 8/16/32 in 256-row chunks), the snapshot and forecast
   planes' CRC sweeps, 200 requests served from the plane (on 512 rows x
   three horizons bitwise the engine's compute path, K1), a delta version
   (305 rows refitted warm through ``CudaBackend.fit``, ADVI on them,
   ``publish_delta``, the forecast and quantile planes' deltas: unchanged
   rows bitwise the base's, changed rows bitwise a full publish of the
   delta version), and a torn forecast-plane publish refused at attach
   and served by compute.
14. stream_fleet_m5 — a retail-conditioned fleet cell beside
   stream_fleet: ``m5_like(30490, 730, seed=2, with_regressors=False)`` as
   a long frame (unobserved cells dropped), cut as stream_fleet is
   (``FLEET_CUT``), config 5's model and schedule,
   the warm run only (each micro-batch's wall, stages, starts and
   launches), one deterministic forecast (K1); K3 (both modes) and K4 on
   every 8,192-row chunk of the last micro-batch at the warm optimum
   itself by GAP_RULE (a dropped cell must fail); the 64-series subset's
   forecasts against the same series streamed on the CPU plain path per
   series in units of its noise (``M5_NOISE_TOL``, which a forecast served
   one row off must fail; the rolled warm start reported).
15. eval12 — eval configs 1 (one series of 2,905 days, P = 54) and 2
   (414 hourly series of 700-960 hours, P = 27) at their published sizes
   through ``CudaBackend.fit`` and ``predict`` (launch counts set to 0
   just before, read just after; the length-bucket plan config 2 took),
   K3/K4 at the fitted parameters by GAP_RULE at the fit shapes (and each
   length bucket's), their rows bitwise invariant, K1 on the forecast
   shapes; every series against the port's scipy oracle in the parity
   workers (train sMAPE per series <= 0.1, |mean| <= 0.05; holdout
   reported), and a ``run_parity``-shaped record.
16. dataplane — the data plane and the plane-fed two-phase fit: the M5
   fleet ``DatasetSpec("m5", 30490, 1941, seed=2)`` (y, mask and three
   regressors, ~1.18 GB of float32 columns) and the 8,192-row cold-start
   plane, ingested by ``data.ingest.IngestDriver`` children (2 shard
   workers each) into a temporary root from the top of the run, beside
   the other phases; the oracle subsets (64 fleet rows, 32 cold-start rows
   half of them late launches) read off landed shards and handed to the
   parity workers as they land.  The ingest's wall, first and last
   shard and bytes; every shard verified; three shards bitwise against
   ``m5_rows`` (the first, a middle one, the partial last); a warm
   ``ensure``; a torn shard refused and repaired bitwise.  Then
   ``CudaBackend.fit_twophase`` (config 3's model, 120 iterations, phase
   1 at 12) of the 30,490 memmapped rows on days [0, 1746) (launch
   counts set to 0 just before, read just after): the wall, stages,
   phase 1's converged count, the stragglers, phase 2's wall, status,
   peak memory; the forecast over 1,941 days (K1) with its holdout
   sMAPE (no limit: another fleet than config 3's ``m5_like``); the
   subset's train sMAPE against the scipy oracle (mean 0.05, per series
   ``DP_SERIES_TOL``, the two-phase policy's), which stragglers patched
   back in phase 2's order instead of by row must fail; K3/K4 by GAP_RULE on phase 2's
   chunk at each of its length buckets' shapes.  Then the cold-start
   plane's two-phase fit: its length-bucket plan, K3/K4 at each bucket's
   shape, the rows where the float64 ridge fallback fired, its subset
   within the same budget.
17. resilient — the process-isolated, crash-resumable fit of the same
   fleet: ``orchestrate.fit_resilient`` of the 30,490 memmapped rows on
   days [0, 1746) (config 3's model, 8,192-row chunks, phase 1 at 12,
   ``no_phase1_tune``; fit workers in fresh interpreters on the card, a
   fresh scratch dir, ``quarantine=True``, a 1 s respawn delay), faulted
   through ``TSSPARK_FAULTS``: the first worker exits right after landing
   its first chunk, and the save of the chunk holding row 8,192 is torn.
   The card's compute mode (not ``Exclusive_Process``); the run's wall,
   spill, probes, spawns and retries; each worker's device, spawn to
   first dispatch, chunks, phase 1 and 2, peak memory, kernel-library
   load and K3/K4 launches (from its ``times.jsonl`` rows).  Required:
   a retry, exactly one quarantined ``*.corrupt`` file refitted, coverage
   exactly once, no CPU degradation and no ``ResilienceWarning``, every
   worker that landed a chunk on the card with K3 and K4 launched; the
   result bitwise phase dataplane's ``fit_twophase`` on the rows its
   phase 1 converged and each straggler's loss within ``RS_LOSS_TOL``
   (which one chunk assembled one row off must fail), and the fleet
   subset's forecasts within the dataplane budget of the scipy oracle.
18. resident — the mesh-resident fit (``resident.run_resident``) on an
   explicit one-device mesh of cuda:0 over phase resilient's clean spill
   (30,490 rows x days [0, 1746), config 3, 8,192-row waves, phase 1 at
   12, ``pipeline_depth`` 2): a child process (``RD_CHILD``, the port
   only) killed after two flushes (rc 17, partial coverage), resumed in
   this process on the same mesh.  Required: the assembled state bitwise
   phase resilient's clean run (solver outputs and scaling meta),
   coverage exactly once, ``resident.json`` path "resident" on mesh
   [1, 1], K3 (both modes) and K4 launched by the resume.  Printed: the
   child's and the resume's walls, their launches, peak memory and one
   wave's device idle share under the profiler.  The time axis: the
   first wave's rows fitted by ``fit_sharded_packed`` on a 1 x 2 (series
   x time) mesh of cuda:0 (K3 and K4 on (8,192, 873) blocks, block 1
   with its prior scales at +inf), each block's K3 (both modes) and K4
   held against their plain versions by the gap rule, the losses within
   rtol / atol 2e-3 of the one-device fit's.  Then a warm run
   (``theta0_fn`` from the clean theta) over every 10th row (3,049), its
   in-sample sMAPE within 0.05 (median gap) of the clean rows'.
19. refit — the delta-refit cycle (``refit.run_refit``) at 10% churn on
   a plane dataset of the same fleet days (``plane.import_batch``),
   registry version 1 the clean run's fit without its regressor
   coefficients (the serving tier reads no regressor values) with its
   snapshot plane, forecast plane (K1), ADVI posterior (``fit_advi``:
   K3's draw stack and K7) and quantile plane at horizon 7, an engine
   caching 256 series at horizon 14.  A delta advances 3,049 rows by the
   fleet's next 7 days (``plane.land_delta``); the cycle runs with no
   mesh: the one-card fallback to the file protocol (one warning).
   Required: the detected set is the delta's rows; unchanged rows'
   snapshot, forecast and quantile bytes the base's, the id column a
   hard link; the refit rows bitwise the chunk worker's cold fit of the
   cycle's spill; the posterior moved on the changed rows only, and
   there bitwise ``fit_advi`` run directly on their v2 theta, their
   spill rows and ``posterior_seed(seed, v2)``; the engine serving v2,
   v1's entries carried for unchanged series (the same bits from cache),
   changed ones recomputed.  Then a 1% cycle's child (``python -m
   tsspark_tpu_torch.refit``, run beside cycle 1's checks) killed at the
   delta publish and resumed here with no new fit, landing the child's
   bits.  Its plane and registry (version 3 active) go on to phase sched.
20. sched — the always-on refit loop and the alert stream on phase
   refit's plane and registry (config 3 without regressors, planes at
   horizon 7, the ADVI posterior): (a) six deltas of 5% churn (1,525 rows
   each, ``plane.land_synthetic_delta``) landed 1 s apart by a thread,
   through ``sched.RefitScheduler(pipeline=True, speculate=True)`` in
   this process on an explicit one-device mesh of cuda:0, its flips
   through a ``PredictionEngine`` on the card (prefetch, the 256 hot
   series materialized, activate), freshness probed by served requests;
   launch counts set to 0 just before, read just after; each refit
   stage's walls, the loop's busy union, freshness p50 / p95,
   speculation, ``fit_path``.  Required: the final version covers every
   delta, zero wrong-version answers, nothing pending, on every hop the
   unchanged rows' snapshot, forecast and quantile bytes the base's, K1,
   K3 (gradient, value, draw stack), K4 and K7 launched.  (b) The same
   deltas on a copy taken first, ``RefitScheduler(pipeline=False)`` run
   to each stamp (a) published at: the same plans and versions, the
   final snapshot, forecast and quantile planes and the posterior
   bitwise (a)'s; on the last cycle's wave (8,192 rows) K3 (both modes)
   and K4 by GAP_RULE (a dropped cell must fail), K1 on its forecast
   plane chunk against the plain version, its changed rows' posterior
   bitwise ``fit_advi`` run directly.  (c) Beside (b): ``python -m
   tsspark_tpu_torch.sched`` on the card (the one-card default, the file
   protocol) over (a)'s world after one more delta, killed at an armed
   ``sched_flip`` exit, a successor resuming its pinned plan with zero
   fit dispatches and one cycle, the child's bits; then an
   ``AlertStream`` at horizon 1 over (a)'s plane and engine (interval
   mode off the quantile plane, every delta), a second stream's bytes, a
   scorer killed at each ``alert_publish`` point healed to the same
   bytes, the sink's keys each once, and ``python -m
   tsspark_tpu_torch.alerts --poll-once`` on the card writing the same
   records.
21. benches — the JAX package's bench family as the port runs it, in a
   child process (``python3 chip_smoke.py --_benches ROOT``,
   ``BenchesChild``) started before phase dataplane and joined after
   phase sched, beside those host-bound phases; its working directory,
   data and scratch roots and ``$TMPDIR`` its own.  On a one-device mesh
   of cuda:0: (a) ``bench_scale.run_rung("30k")`` on a fresh data root
   (30,490 x 128 ``demo_weekly`` ingested, the resident fit in 2,048-row
   waves, the snapshot plane and npz published, a ``ReplicaPool`` of 4
   replica processes answering 320 requests with the mid-run flip to
   v2, the npz pool's RSS comparison, the sentinel row under
   ``scale_30k`` with the card's device class), then K3 (both modes) and
   K4 by GAP_RULE on the rung's first 2,048 x 128 wave off the optimum
   (a dropped cell must fail) and K1 at the pool's dispatch shapes; (b)
   ``refit.run_delta_bench`` (churns 0.01, 0.1, 0.3), then
   ``sched.run_freshness_bench`` (serialized, pipelined) and
   ``alerts.bench.run_alerts_bench`` on the one cold base they share
   (``reuse_cold``): ``sweep_ok``, each delta's ``n_changed`` the landed
   rows, zero wrong-version answers, every alert delivered, each
   report's keys the JAX package's (copied here, not imported); (c)
   ``serve.planebench.run_serveplane_bench`` at 48 series and 2,000
   requests (plane hit rate 1.0, a cold and a bank-armed replica each
   answering); (d) ``calibrate.run_uncertainty_bench`` at 24 series (its
   ``calibration`` row on the card's device class); (e) the run ledger
   over the phase's scratch, in process and through ``python -m
   tsspark_tpu_torch.obs ledger`` (the same ledger, no orphan span).
   (c) and (d) run at the reference's bench sizes: serving, the planes
   and the calibration recipe run at the fleet's width in other phases.
   Launch counts set to 0 before each leg and read after it (the
   replicas' at each pool's stop): ``launches_benches``.
22. frontend — the user front end on phase fit's batch, config 3's
   model as a user builds it for a long frame (the holiday a ``Holiday``
   from a holidays frame, after the price and promo columns): (a)
   ``Forecaster.fit`` of a long frame of the first 8,192 series (one
   chunk) on days [0, 1746), ``predict(future_df=)`` over the 195
   holdout days, ``components`` over 28 of them, ``make_future_frame``;
   the pivot bitwise the generator's arrays; what the Forecaster hands
   ``CudaBackend.fit``, ``predict`` and ``components`` (recorded by
   ``BackendCalls``) the generator's arrays bitwise, on the backend a
   user of the array path builds, and its state, forecast frame and
   components those calls' returns bitwise; the same Forecaster on 64
   series on the plain CPU path (a ``ParityFits`` worker) within the fit
   budget; (b) ``diagnostics.cross_validation`` of 1,024 series x 1,941
   days at three cutoffs (3,072 rows, the card's length buckets) and
   ``performance_metrics``: its ``backtest.cross_validation`` call handed
   the generator's arrays, the frame that call's result bitwise, and K3
   (both modes) and K4 held against their plain versions on each length
   bucket of the CV's fit at its fitted theta (``dp_held``: observed rows
   by ``hold_observed``, rows with nothing observed before their cutoff
   by ``hold_inert``); (c) ``mcmc_samples=300``
   on 256 series: ``predict``, ``predictive_samples(num_samples=100)``,
   ``mcmc_diagnostics`` (finite, lower <= yhat <= upper); (d) ``python -m
   tsspark_tpu_torch`` forecast, fit, predict (from the checkpoint) and
   backtest on a CSV of 256 series in child processes on the card, beside
   legs (b) and (c), each output bitwise the same command run in this
   process, each child loading the built kernel library (no rebuild).
   Launch counts (K1, K2, K3 per mode, K4, K6) set to 0 before each leg,
   read after; walls (pivot, fit, predict, scatter to long), peak memory.
23. serve_scale — serving at scale on phase serve's registry (30,490
   series x 1,941 days): (a) the in-process loadgen (``python -m
   tsspark_tpu_torch.serve --loadgen``'s ``_loadgen``), 10,000 requests of
   the JAX package's mix (Zipf over series, 1-8 series a request,
   horizons 7/14/28, 10% at 20 samples, 2% hopeless deadlines), its
   report (p50/p95/p99, shed, cache, per-dispatch telemetry) and the
   regression sentinel with its history in a temporary directory; (b)
   ``ReplicaPool`` with two replica processes on the card (spawned at
   once) taking 10,000 requests of the same mix in pipelined waves from
   four client threads, with a mid-run flip to a delta version that
   refits 1% of the rows (``CudaBackend(perf=)``, its per-dispatch report
   printed) through ``activate``'s materializer (the hot set at 7/14/28
   and at 56, a bucket the forecast plane does not hold) and a SIGKILL of
   replica 1 at 10% of the requests, respawned by the pool's watch (the
   respawn timed from the pool's own spawn stamps): zero non-shed
   failures, zero wrong-version answers, the respawned process holding
   slot 1's lease, the hot set answered from cache after the flip in
   every replica the flip warmed, the delta flip's cache carry-forward
   in replica 0 (the 256 series warmed at 56 before the replay: the
   unrefitted ones answered from cache with the engine's bits, the
   refitted ones recomputed), 512 series on both shards bitwise the
   in-process engine's and a direct ``CudaBackend.predict``'s at
   horizons 28 (the forecast plane) and 56 (K1), K1 and K2 launched in
   every replica during the replay (each replica's counters read before
   and after it, and replica 1's also just before its kill; the checks'
   own launches apart); K1 and K2 at the pool's dispatch shapes (widths
   8-256, buckets 8/16/32) against their plain versions (K2 on given
   draws at S = 20, and in distribution on its own draws at S = 256);
   (c) the kernel bank (``aotbank.build_bank`` at publish, idempotent):
   a cold replica armed with it loads the library from the bank, builds
   nothing and launches the bank's shape ladder at ``warm``; then one
   without it loads the library this run built at its top: each one's
   time to its first request, beside what that build took;
   (d) ``python -m tsspark_tpu_torch.serve --registry`` as a child
   process beside (c): three requests bitwise the engine's, stats,
   activate, rollback.
24. kernels — each kernel at its main path's shapes, on the main path's
   inputs (K3 and K4 at 8192x1746 on config 3's first chunk; K3's
   logistic branch at 8192x1080; K3's trial-stack layout on config 4's
   21 x 8192 line-search stack and on one of flat growth over config 3's
   chunk, each trial the bits of its launch alone; K1's and
   K2's (S=256) on the forecast's 512-row chunks of 1,200 steps and over
   all 8,192 rows, on config 4's), held against its plain version, and
   its time against its bound, its plain version and (where one exists)
   one PyTorch call; K3 (both modes, both growths) and K4 give a row the
   same bits alone, permuted and in a trial stack; K1 (all three shapes) and
   K2 (its own Philox draws, each row keeping its Philox coordinate, both
   growths) alone and permuted; K6 from phase mcmc.  K1-K4 gain their
   launches on the two streaming paths; K3 the ADVI draw stack's time,
   bound and gaps, and K7's entry joins from phase uncertainty; K1, K3
   and K4 their launches and checks on phases stream_fleet_m5, eval12,
   planes and dataplane; K3 and K4 their launches in phase resilient's
   worker processes and on phase resident's resume, K1, K3 and K7 theirs
   in phase refit's process, K1, K3, K4 and K7 theirs on phase sched's
   stream (``launches_sched``) with its wave's and chunk's checks; K1,
   K3, K4 and K7 theirs on phase benches (``launches_benches``) with the
   rung's wave and pool-shape checks; K1-K4 and K6 their launches on phase frontend, and
   K3 and K4 their checks on its CV buckets; K1 and K2 their launches on
   phase serve_scale's loadgen and replicas, their checks and times at
   the pool's shapes.

The CPU parity fits of phases fit and fit_logistic (the scipy oracle and
the port's plain fit on their subsets), the CPU streaming runs of phases
stream5, stream_fleet and stream_fleet_m5 and phase eval12's scipy fits
run in three worker processes (``ParityFits``), started with the data
before phase forward, beside the card's phases; each phase waits for its
own (phase frontend's CPU leg is submitted right after them).  Phase
dataplane's ingest (``DataplaneIngest``) starts there too,
and hands the pool its oracle fits as their shards land.  Phase uncertainty hands the
pool its CPU ADVI fit once its MAP fit is done.

The last lines: the run's wall time, the kernels JSON object,
``nvidia-smi``'s ``name, power.limit`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory
# bandwidth, and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Its 132 multiprocessors at the 1.98 GHz boost clock of that float32 peak
# (132 x 128 lanes x 2 x 1.98e9), at the CUDA programming guide's rates a
# multiprocessor for compute capability 9.0: 64 32-bit integer multiplies
# and 16 special-function operations (log2, rsqrt, sin, cos) a clock.
PEAK_INT32_MUL_PER_S = 132 * 64 * 1.98e9
PEAK_SFU_PER_S = 132 * 16 * 1.98e9

FULL_SERIES = 30490
FULL_DAYS = 1941
HORIZON = 28


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms, the host's launch cost left out:
    the card first sleeps (~30 ms of its clock) while the host enqueues
    ``iters`` calls between two events, which then bracket the calls run
    back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def random_theta(rng, b: int, config) -> np.ndarray:
    """Parameters at fitted-like magnitudes, in scaled units."""
    theta = np.empty((b, config.num_params), np.float32)
    ncp = config.n_changepoints
    theta[:, 0] = rng.normal(0.3, 0.3, b)
    theta[:, 1] = rng.uniform(0.2, 0.6, b)
    theta[:, 2] = np.log(rng.uniform(0.03, 0.1, b))
    theta[:, 3:3 + ncp] = rng.laplace(0.0, 0.05, (b, ncp))
    theta[:, 3 + ncp:] = rng.normal(0.0, 0.05, (b, config.num_features))
    return theta


def logistic_theta(rng, b: int, config) -> np.ndarray:
    """``random_theta`` with k in [1, 2], so every rate k_j = k + delta_0
    + ... + delta_j is clear of 0: a growing logistic trend, as fitted
    series have.  ``rates_near_zero`` holds the other case."""
    theta = random_theta(rng, b, config)
    theta[:, 0] = rng.uniform(1.0, 2.0, b)
    return theta


def rates_near_zero(rng, b: int, config) -> np.ndarray:
    """``random_theta`` with k ~ N(0, 0.05), so the rates k_j cross 0 on
    most rows, where the logistic offset recursion is ill-conditioned in
    float32 (ROADMAP, Queue 3); row 0 has k and every delta 0."""
    theta = random_theta(rng, b, config)
    theta[:, 0] = rng.normal(0.0, 0.05, b)
    theta[0, 0] = 0.0
    theta[0, 3:3 + config.n_changepoints] = 0.0
    return theta


def synthetic_data(rng, config, b: int, t_len: int, per_series: bool,
                   device):
    """FitData at a given shape: t over [0, 1.2], sorted changepoints in
    [0, 0.8], Fourier-like features, capacity above the trend."""
    import torch

    from tsspark_tpu_torch.models.prophet.design import FitData

    f32 = np.float32
    t = np.broadcast_to(np.linspace(0.0, 1.2, t_len, dtype=f32),
                        (b, t_len))
    s = np.sort(rng.uniform(0.0, 0.8, (b, config.n_changepoints)),
                axis=1).astype(f32)
    fs = config.num_seasonal_features
    xs_shape = (b, t_len, fs) if per_series else (t_len, fs)
    xs = rng.uniform(-1.0, 1.0, xs_shape).astype(f32)
    xr = rng.normal(0.0, 1.0, (b, t_len, config.num_regressors)).astype(f32)
    cap = rng.uniform(1.5, 3.0, (b, 1)).astype(f32) * np.ones((1, t_len), f32)
    mm = np.asarray([1.0 if m else 0.0 for m in config.feature_modes()], f32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    zeros = torch.zeros((b, t_len), device=device)
    return FitData(
        t=dev(t), y=zeros, mask=zeros, s=dev(s), cap=dev(cap),
        X_season=dev(xs), X_reg=dev(xr),
        prior_scales=dev(np.ones(config.num_features, f32)),
        mult_mask=dev(mm),
    )


def trend_ops(config) -> tuple:
    """Float32 operations of the trend, (a cell, a row).  t rises along a
    row, so a cell takes its segment's line (linear: one multiply-add) or
    its rate and offset (logistic: rate (t - off), the sigmoid's
    exponential, add and reciprocal, the capacity) in O(1); the prefix
    sums over the changepoints (linear) or the offset recursion
    (logistic, ~8 a step) are taken once a row.  Flat growth's trend is
    m: none."""
    ncp = config.n_changepoints
    return {"flat": (0, 0), "linear": (2, 3 * ncp),
            "logistic": (6, 8 * ncp)}[config.growth]


def forward_bound_ms(b, t_len, config, per_series, rescale) -> dict:
    """Least time for one forward launch: each input read once, each
    output written once, against the float32 operation count."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f = fs + r
    floats = b * config.num_params + b * t_len + b * ncp + f \
        + (b if per_series else 1) * t_len * fs + b * t_len * r \
        + 4 * b * t_len
    if config.growth == "logistic":
        floats += b * t_len
    if rescale:
        floats += 2 * b
    trend_cell, trend_row = trend_ops(config)
    ops_cell = 4 * f + 3 + (5 if rescale else 0) + trend_cell
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = b * (t_len * ops_cell + trend_row) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bands_bound_ms(b, t_len, s, config, given_draws=False) -> dict:
    """Least time for one bands launch: bytes of the (B, T) inputs and
    outputs (and of the (S, B, T) draws when given), against the float32
    operations the function needs at each cell: ~20 per sample for the
    simulation (variate generation not counted; logistic growth ~30: the
    offset recursion's step and the sigmoid) and a selection of the
    two order statistics of each column, O(S) — counted as 2 per sample
    per column.  The kernel's bitonic sort is its design's cost, not the
    function's, and is not counted."""
    logistic = config.growth == "logistic"
    floats = 8 * b * t_len + b * config.num_params + 2 * b
    if logistic:
        floats += b * t_len + b * config.n_changepoints  # cap, s
    if given_draws:
        floats += 3 * s * b * t_len
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    sim = 30 if logistic else 20
    t_ops = b * t_len * s * (sim + 2 * 2) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bands_variates_bound_ms(b, t_len, s, config) -> dict:
    """``bands_bound_ms`` with the variates K2 must draw counted too: one
    Philox4x32-10 draw a sample-cell, 10 rounds of two 32x32-bit products
    each taken as a low and a high multiply (40 integer multiplies), at
    the integer multiply rate; and four transcendentals a sample-cell (the
    Laplace draw's log, Box-Muller's log, square root and cosine) at the
    special-function rate (five under logistic growth: the sigmoid's
    exponential).  The units run side by side, so the least time is the
    largest of the bytes, float32, integer and special-function times."""
    base = bands_bound_ms(b, t_len, s, config)
    cells = b * t_len * s
    sfu = 5 if config.growth == "logistic" else 4
    times = {
        "bytes_or_float32": base["bound_ms"],
        "integer_multiplies": cells * 40 / PEAK_INT32_MUL_PER_S * 1e3,
        "transcendentals": cells * sfu / PEAK_SFU_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return {"bound_with_variates_ms": times[by],
            "bound_with_variates_by": by,
            "bound_with_variates_parts_ms": times}


def lbfgs_bound_ms(m, b, p) -> dict:
    """Least time for one L-BFGS iteration body over an (m, b, p) history
    ring (``ops/lbfgs.py``): the s, y and rho ring, theta and the gradient
    read once, the direction, the new (s, y) pair and its rho written
    once; against the two-loop recursion's float32 operations (a dot and
    an axpy over p in each of 2 m passes: 4 p each a row)."""
    floats = 2 * m * b * p + m * b + 2 * b * p + 3 * b * p + b
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * b * 4 * p / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": [m, b, p]}


def loss_bound_ms(n_rows, b, t_len, config, grad) -> dict:
    """Least time for one K3 launch: t, y, mask (and cap under logistic
    growth) and the regressor columns of every cell, the shared seasonal
    matrix, changepoints and parameters read once, f (and g) written once;
    against the float32 operations of the loss (``trend_ops``, features,
    residual, sums; the priors once a row) and, in gradient mode, of the
    2 + n_cp + F gradient sums: the changepoints' as suffix sums of the
    trend's own (linear: sum u, sum u t; logistic: the sigmoid's slope
    and two sums a cell), taken once a row at the boundaries (logistic:
    then the recursion's pull-back).  A stack of trial rows (n_rows =
    N * b) reads the data once."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f, p = fs + r, config.num_params
    logistic = config.growth == "logistic"
    floats = (3 + r + logistic) * b * t_len + t_len * fs + b * ncp + 2 * f \
        + n_rows * p + n_rows * (1 + (p if grad else 0))
    trend_cell, trend_row = trend_ops(config)
    ops_cell = trend_cell + 4 * f + 3 + 4
    ops_row = trend_row + 5 * ncp + 3 * f
    if grad:
        ops_cell += 5 + 3 + 5 * f + (8 if logistic else 0)
        ops_row += {"flat": 0, "linear": 3, "logistic": 15}[
            config.growth] * ncp
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = n_rows * (t_len * ops_cell + ops_row) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fan_bound_ms(b, t_len, k_steps, config) -> dict:
    """Least time for one K4 launch: the row data as K3 reads it, theta,
    the direction and the (K, B) ladder read once, (K, B) written once;
    against the float32 operations of two forward passes (``trend_ops``)
    and the six sums per cell, and O(n_cp) per rung."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f, p = fs + r, config.num_params
    floats = (3 + r) * b * t_len + t_len * fs + b * ncp + 2 * f \
        + 2 * b * p + 2 * k_steps * b
    trend_cell, trend_row = trend_ops(config)
    ops_cell = 2 * trend_cell + 2 * 4 * f + 26
    ops = b * (t_len * ops_cell + 2 * trend_row) \
        + k_steps * b * (30 + 4 * ncp)
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _xmax(data):
    """(B, T) largest |feature| of each cell (shared or per-series)."""
    import torch

    xs = data.X_season.abs()
    xs = xs.amax(-1) if xs.shape[-1] else xs.new_zeros(xs.shape[:-1])
    xs = xs if xs.ndim == 2 else xs[None].expand(data.t.shape)
    if data.X_reg.shape[-1]:
        xs = torch.maximum(xs, data.X_reg.abs().amax(-1))
    return xs


def _pullback_gain(p, s):
    """(B,) first-order gain of logistic growth's pull-back through the
    offset recursion (kernels/loss.py ``_logistic_pullback``): it adds
    sum_j ggamma_j dgamma_j/d(k, m, delta) to the gradient, so an error e
    in each of its sums ggamma_j moves the gradient by at most
    e * sum_j,i |dgamma_j/dtheta_i|, taken by float64 autograd of the
    plain recursion (``trend._logistic_gamma``)."""
    import torch

    from tsspark_tpu_torch.models.prophet import trend as tr

    k, m, delta = (x.detach().double().requires_grad_()
                   for x in (p.k, p.m, p.delta))
    gamma = tr._logistic_gamma(k, m, delta, s.double())
    gain = torch.zeros_like(k)
    for j in range(gamma.shape[-1]):
        gk, gm, gd = torch.autograd.grad(gamma[:, j].sum(), (k, m, delta),
                                         retain_graph=True)
        gain = gain + gk.abs() + gm.abs() + gd.abs().sum(-1)
    return gain.to(p.k.dtype)


def loss_scales(theta, data, config):
    """Per row, the sums of |terms| that K3's sums add: (f scale, g scale).
    A float32 sum of T terms in any order is within T * eps of its
    |terms| sum, so T * eps * scale bounds a kernel-vs-plain gap.  Under
    logistic growth the gradient adds the sums of |v (t - off)| and
    |v rate| (v = df/dx), carried through the offset recursion's
    pull-back at its first-order gain."""
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels.loss import SIGMA_FLOOR

    yhat, g, _, mult = fk.forward_plain(theta, data, config)
    sigma = SIGMA_FLOOR + (theta[:, 2]).exp()
    r = (data.y - yhat) * data.mask
    ssr = (r * r).sum(-1) / (sigma * sigma)
    w = (r * data.mask).abs() / (sigma * sigma)[:, None]
    n_log = (data.mask.sum(-1) * sigma.log()).abs()
    f_scale = 1.0 + 0.5 * ssr + n_log
    g_scale = 1.0 + ssr + n_log \
        + (w * (1.0 + mult.abs()) * (1.0 + data.t.abs())).sum(-1) \
        + (w * (1.0 + g.abs()) * _xmax(data)).sum(-1)
    if config.growth == "logistic":
        from tsspark_tpu_torch.models.prophet import trend as tr
        from tsspark_tpu_torch.models.prophet.params import unpack

        p = unpack(theta, config)
        rate = p.k[:, None] + tr.step_weighted_sum(p.delta, data.t, data.s)
        gamma = tr._logistic_gamma(p.k, p.m, p.delta, data.s)
        off = p.m[:, None] + tr.step_weighted_sum(gamma, data.t, data.s)
        sig = (rate * (data.t - off)).sigmoid()
        v = w * (1.0 + mult.abs()) * data.cap.abs() * sig * (1.0 - sig)
        terms = (v * ((data.t - off).abs() + rate.abs())).sum(-1)
        g_scale = g_scale + terms * (
            1.0 + _pullback_gain(p, data.s))
    return f_scale, g_scale


def fan_scale(theta, direction, ladder, data, config):
    """(K, B) sums of |terms| of the fan's expanded loss at each rung (see
    ``loss_scales``), from the plain version's own per-cell terms."""
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels.loss import SIGMA_FLOOR

    r0, c1, c2, p0, pd = fan_k.ray_terms(theta, direction, data, config)
    s = ladder.abs()
    sums = [(a * b).abs().sum(-1)[None] for a, b in (
        (r0, r0), (r0, c1), (r0, c2), (c1, c1), (c1, c2), (c2, c2))]
    poly = sums[0] + 2 * s * sums[1] + s * s * (sums[3] + 2 * sums[2]) \
        + 2 * s ** 3 * sums[4] + s ** 4 * sums[5]
    sigma = SIGMA_FLOOR + (p0.log_sigma[None]
                           + ladder * pd.log_sigma[None]).exp()
    n_log = (data.mask.sum(-1)[None] * sigma.log()).abs()
    return 1.0 + 0.5 * poly / (sigma * sigma) + n_log


# K3 and K4 against their plain versions: T * eps * sum|terms| is the
# worst-case float32 error of a T-term sum taken in another order; the two
# stay within 0.2% of it on the card (PERF.md), so 5% leaves margin and
# still catches one wrong cell of a row.
GAP_TOL = 0.05
GAP_RULE = f"|k-p| <= {GAP_TOL} * T*eps*sum|terms| per row"


def _gap(got, want, scale, t_len) -> float:
    """max |k - p| / (T * eps * scale): 1 is the float32 worst case."""
    eps = float(np.finfo(np.float32).eps)
    if got.ndim > scale.ndim:
        scale = scale[..., None]
    return float(((got - want).abs() / (t_len * eps * scale)).max())


def loss_gaps(theta, data, config, pairs) -> dict:
    """K3 against its plain version by ``GAP_RULE``, on ``theta``'s rows
    of ``data``: ``pairs`` maps a name to (kernel output, plain output)
    on one device.  A (B, P) output is a gradient, held to the rows'
    gradient scale; a (n B,) output is a loss, or a stack of n trials on
    those rows, held to the rows' loss scale repeated n times.  Returns
    {name: gap}; K3 is right where every gap is at most ``GAP_TOL``
    (``within_gap_rule``)."""
    f_scale, g_scale = loss_scales(theta, data, config)
    t_len = data.t.shape[-1]
    out = {}
    for name, (got, want) in pairs.items():
        scale = g_scale if got.ndim == 2 else f_scale.repeat(
            got.shape[0] // f_scale.shape[0])
        out[name] = _gap(got, want, scale.to(got.device), t_len)
    return out


def within_gap_rule(gaps: dict) -> bool:
    return max(gaps.values()) <= GAP_TOL


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|)."""
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def phase_forward(rng, device) -> dict:
    import dataclasses

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import forward as fk

    import torch

    tol = 2e-5  # float32: 25 hinge + 26 feature terms, FMA contraction
    base = ProphetConfig()
    cases = [
        ("linear/shared", base, False),
        ("linear/per-series", base, True),
        ("flat/shared", dataclasses.replace(base, growth="flat"), False),
        ("logistic/per-series",
         dataclasses.replace(base, growth="logistic"), True),
    ]
    with_reg = base
    for name in ("promo", "price", "holiday"):
        with_reg = with_reg.with_regressor(name)
    cases.append(("linear/3-regressors", with_reg, False))
    results = []
    for name, cfg, per_series in cases:
        b, t_len = 2048, 1969
        data = synthetic_data(rng, cfg, b, t_len, per_series, device)
        theta = torch.from_numpy(random_theta(rng, b, cfg)).to(device)
        scale = torch.from_numpy(
            rng.uniform(1.0, 50.0, b).astype(np.float32)).to(device)
        floor = torch.zeros(b, device=device)
        for rescale in (False, True):
            kw = dict(y_scale=scale, floor=floor) if rescale else {}
            got = fk.forward(theta, data, cfg, **kw)
            want = fk.forward_plain(theta, data, cfg, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            for g in got:
                require(bool(torch.isfinite(g).all()), f"{name} finite")
            require(max(errs) <= tol, f"forward {name} rescale={rescale}: "
                    f"{max(errs)} > {tol}")
            results.append({"case": name, "rescale": rescale,
                            "max_rel_err": max(errs),
                            "max_abs_err": max(abs_errs)})
        ms = cuda_ms(lambda: fk.forward(theta, data, cfg))
        plain_ms = cuda_ms(lambda: fk.forward_plain(theta, data, cfg),
                           iters=3, warmup=1)
        results[-1].update(ms=ms, plain_ms=plain_ms)
    worst = max(r["max_abs_err"] for r in results if not r["rescale"])
    out = {"phase": "forward", "tolerance": f"|k-p|/(1+|p|) <= {tol}",
           "cases": results, "max_abs_err_scaled": worst}
    emit(out)
    return out


def _band_err(got, want, scale) -> float:
    """max over keys and cells of |k - p| / (y_scale + |p|)."""
    return max(float(((got[k] - want[k]).abs()
                      / (scale[:, None] + want[k].abs())).max())
               for k in want)


def _mc_compare(own, ref, lo_key, hi_key, unit) -> dict:
    """Two Monte-Carlo estimates of the same (lo, hi) band, cell by cell,
    in ``unit`` (the spread of what is sampled): the median signed and
    absolute differences, and the median ratio of the band widths."""
    out = {}
    for k in (lo_key, hi_key):
        d = (own[k] - ref[k]) / unit
        out[k] = {"median": float(d.median()),
                  "median_abs": float(d.abs().median())}
    width = own[hi_key] - own[lo_key]
    out["width_ratio_median"] = float(
        (width / (ref[hi_key] - ref[lo_key])).median())
    return out


def _require_mc(mc, lo_key, hi_key, what) -> None:
    for k in (lo_key, hi_key):
        require(abs(mc[k]["median"]) <= 0.05, f"{what} MC bias {k}")
        require(mc[k]["median_abs"] <= 0.3, f"{what} MC spread {k}")
    require(abs(mc["width_ratio_median"] - 1.0) <= 0.03,
            f"{what} MC band width ratio {mc['width_ratio_median']}")


def phase_bands(rng, device) -> dict:
    import torch

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk

    cfg = ProphetConfig()
    tol = 1e-5

    def inputs(b, t_np, c=cfg, theta_fn=random_theta):
        t_len = t_np.shape[0]
        data = synthetic_data(rng, c, b, t_len, True, device)
        data = data._replace(t=torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(t_np.astype(np.float32), (b, t_len)))).to(device))
        theta = torch.from_numpy(theta_fn(rng, b, c)).to(device)
        scale = torch.from_numpy(
            rng.uniform(1.0, 50.0, b).astype(np.float32)).to(device)
        floor = torch.zeros(b, device=device)
        _, det, add, mult = fk.forward(theta, data, c)
        return theta, data, det, add, mult, scale, floor

    def on_cpu(args):
        theta, data, *rest = args
        return (theta.cpu(), data._replace(
            **{f: getattr(data, f).cpu() for f in data._fields}),
            *(x.cpu() for x in rest))

    # Engine-like grid: the horizon steps just past the history.
    b, t_len, s = 1024, 32, 256
    eng_t = 1.0 + np.arange(1, t_len + 1) / 1940.0
    args = inputs(b, eng_t)
    theta, data, det, add, mult, scale, floor = args
    gen = torch.Generator(device=device).manual_seed(7)
    draws = bk.sample_draws((s, b, t_len), gen, device)
    got = bk.bands(*args, cfg, s, draws=draws)
    want = bk.bands_plain(*args, cfg, draws)
    torch.cuda.synchronize()
    given = {k: float(((got[k] - want[k]).abs()
                       / (scale[:, None] + want[k].abs())).max())
             for k in want}
    require(max(given.values()) <= tol, f"bands given-draws: {given}")
    # Sample counts past one thread per sample (several per thread), past
    # one block (the device-memory scratch path) and past the 16,384 one
    # block held before, on a few rows.
    wide = {}
    for n_s in (1000, 3000, 16384, 16385, 65536):
        wargs = inputs(16, eng_t[:8])
        wdraws = bk.sample_draws((n_s, 16, 8), gen, device)
        e = _band_err(bk.bands(*wargs, cfg, n_s, draws=wdraws),
                      bk.bands_plain(*wargs, cfg, wdraws), wargs[5])
        wide[n_s] = e
        require(e <= tol, f"bands given-draws S={n_s}: {e} > {tol}")
    # Own Philox draws against the plain version's generator: two
    # Monte-Carlo estimates of the same quantiles.  In units of the
    # spread of what is sampled, the standard error of one 10% / 90%
    # quantile estimate at S=256 is ~0.11 and of a difference of two
    # ~0.15; the median signed difference over cells must be near 0, the
    # median absolute one near 0.1, and the median ratio of band widths
    # near 1 (its standard error over 1,024 rows is ~0.004).
    #   yhat bands on the engine grid: the normal draws dominate, unit
    #   sigma * y_scale.
    own = bk.bands(*args, cfg, s, seed=11)
    ref = {k: v.to(device) for k, v in
           bk.bands(*on_cpu(args), cfg, s, seed=11).items()}
    sigma = torch.exp(theta[:, 2])[:, None] * scale[:, None]
    mc_yhat = _mc_compare(own, ref, "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc_yhat, "yhat_lower", "yhat_upper", "bands yhat")
    for lo, hi in (("yhat_lower", "yhat_upper"),
                   ("trend_lower", "trend_upper")):
        require(bool((own[lo] <= own[hi]).all()), f"{lo} <= {hi}")
        require(bool(torch.isfinite(own[lo]).all()), f"{lo} finite")
    #   trend bands on a horizon of 64 steps of 0.01 (cp_prob ~0.25):
    #   only the Bernoulli and Laplace draws move them.  Unit: the sd of
    #   the simulated trend, sqrt(2 p lam^2 sum_j (t - t_j)^2) * y_scale,
    #   over the later 32 steps (8 or more changepoints expected).
    cp_t = 1.0 + 0.01 * np.arange(1, 65)
    cargs = inputs(b, cp_t)
    own_c = bk.bands(*cargs, cfg, s, seed=12)
    ref_c = {k: v.to(device) for k, v in
             bk.bands(*on_cpu(cargs), cfg, s, seed=12).items()}
    c_theta, c_scale = cargs[0], cargs[5]
    lam = c_theta[:, 3:3 + cfg.n_changepoints].abs().mean(-1)
    tt = torch.from_numpy(cp_t.astype(np.float32)).to(device)
    dt = torch.diff(tt, prepend=tt[:1])
    p_cp = min(max(cfg.n_changepoints * float(dt.mean()), 0.0), 1.0)
    lag2 = torch.clamp(tt[:, None] - tt[None, :], min=0.0) ** 2
    sd = torch.sqrt(2.0 * p_cp * lam[:, None] ** 2 * lag2.sum(-1)[None])
    half = slice(32, None)
    late = lambda d: {k: v[:, half] for k, v in d.items()}  # noqa: E731
    mc_trend = _mc_compare(late(own_c), late(ref_c), "trend_lower",
                           "trend_upper", (sd * c_scale[:, None])[:, half])
    _require_mc(mc_trend, "trend_lower", "trend_upper", "bands trend")
    require(bool((own_c["trend_lower"] <= own_c["trend_upper"]).all()),
            "trend_lower <= trend_upper (changepoint horizon)")
    big = big_sample_run(inputs, on_cpu, cfg, eng_t, device)
    ms = cuda_ms(lambda: bk.bands(*args, cfg, s, seed=3))
    plain_ms = cuda_ms(lambda: bk.bands_plain(*args, cfg, draws),
                       iters=3, warmup=1)
    sim = bk.bands_plain(*args, cfg, draws,
                         return_samples=True)["yhat_samples"]
    qs = torch.tensor([float(q) for q in bk.quantile_points(0.8)],
                      device=device)
    quantile_ms = cuda_ms(lambda: torch.quantile(sim, qs, dim=0))
    del sim
    logistic = bands_logistic(inputs, on_cpu, eng_t, device)
    out = {"phase": "bands", "shape": [b, t_len, s],
           "given_draws_err": given, "given_draws_err_wide_S": wide,
           "tolerance": f"|k-p|/(y_scale+|p|) <= {tol}",
           "monte_carlo_yhat": mc_yhat,
           "monte_carlo_trend": {"cp_prob": p_cp, **mc_trend},
           "philox_65536": big,
           "ms": ms, "plain_ms": plain_ms,
           "torch_quantile_ms": quantile_ms, "logistic": logistic}
    emit(out)
    return out


def fit_grid(days: int, split: int) -> np.ndarray:
    """Scaled times of a fit's calendar forecast whole: the first
    ``split`` days span [0, 1], the rest step on past 1."""
    return np.concatenate([np.linspace(0.0, 1.0, split),
                           1.0 + np.arange(1, days - split + 1)
                           / (split - 1.0)])


def bands_logistic(inputs, on_cpu, eng_t, device) -> dict:
    """K2's logistic branch against its plain version (the scan of
    ``predict._logistic_paths``): on given draws at config 4's forecast
    shape (1,024 rows x 1,200 steps, 120 of them future, S = 256) and at
    S = 65,536 on a few rows (the scratch path), and at the first shape
    with rates near 0 (``rates_near_zero``), within 1e-5; then its
    own Philox draws against the plain version's generator, Monte-Carlo
    bounds as for linear growth: the yhat bands on the engine grid (unit
    sigma * y_scale) and the trend bands over the later half of a 64-step
    changepoint horizon (unit: the plain version's band width over
    2.5631, the width of a normal's 10%-90% band in its sd)."""
    import dataclasses

    import torch

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import bands as bk

    cfg = dataclasses.replace(ProphetConfig(), growth="logistic")
    tol = 1e-5
    gen = torch.Generator(device=device).manual_seed(17)
    b, s = 1024, 256
    args = inputs(b, fit_grid(C4_DAYS, 1080), cfg, logistic_theta)
    draws = bk.sample_draws((s, b, C4_DAYS), gen, device)
    given = _band_err(bk.bands(*args, cfg, s, draws=draws),
                      bk.bands_plain(*args, cfg, draws), args[5])
    require(given <= tol, f"bands logistic given-draws: {given} > {tol}")
    del draws
    wargs = inputs(4, fit_grid(1100, 1080)[-40:], cfg, logistic_theta)
    wdraws = bk.sample_draws((65536, 4, 40), gen, device)
    wide = _band_err(bk.bands(*wargs, cfg, 65536, draws=wdraws),
                     bk.bands_plain(*wargs, cfg, wdraws), wargs[5])
    require(wide <= tol, f"bands logistic given-draws S=65536: {wide}")
    del wdraws
    zargs = inputs(b, fit_grid(C4_DAYS, 1080), cfg, rates_near_zero)
    zdraws = bk.sample_draws((s, b, C4_DAYS), gen, device)
    near_zero = _band_err(bk.bands(*zargs, cfg, s, draws=zdraws),
                          bk.bands_plain(*zargs, cfg, zdraws), zargs[5])
    require(near_zero <= tol,
            f"bands logistic given-draws, rates near 0: {near_zero}")
    del zdraws
    eargs = inputs(b, eng_t, cfg, logistic_theta)
    own = bk.bands(*eargs, cfg, s, seed=11)
    ref = {k: v.to(device) for k, v in
           bk.bands(*on_cpu(eargs), cfg, s, seed=11).items()}
    sigma = torch.exp(eargs[0][:, 2])[:, None] * eargs[5][:, None]
    mc_yhat = _mc_compare(own, ref, "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc_yhat, "yhat_lower", "yhat_upper", "bands logistic yhat")
    cargs = inputs(b, 1.0 + 0.01 * np.arange(1, 65), cfg, logistic_theta)
    own_c = bk.bands(*cargs, cfg, s, seed=12)
    ref_c = {k: v.to(device) for k, v in
             bk.bands(*on_cpu(cargs), cfg, s, seed=12).items()}
    late = lambda d: {k: v[:, 32:] for k, v in d.items()}  # noqa: E731
    unit = (ref_c["trend_upper"] - ref_c["trend_lower"])[:, 32:] / 2.5631
    mc_trend = _mc_compare(late(own_c), late(ref_c), "trend_lower",
                           "trend_upper", unit)
    _require_mc(mc_trend, "trend_lower", "trend_upper",
                "bands logistic trend")
    for d in (own, own_c):
        require(bool((d["yhat_lower"] <= d["yhat_upper"]).all()),
                "logistic yhat_lower <= yhat_upper")
        require(ordered(d["trend_lower"], d["trend_upper"], True),
                "logistic trend_lower <= trend_upper")
        require(all(bool(torch.isfinite(v).all()) for v in d.values()),
                "logistic bands finite")
    return {"shape": [b, C4_DAYS, s], "given_draws_err": given,
            "given_draws_err_S65536": wide,
            "given_draws_err_rates_near_0": near_zero,
            "tolerance": f"|k-p|/(y_scale+|p|) <= {tol}",
            "monte_carlo_yhat": mc_yhat, "monte_carlo_trend": mc_trend}


# Where most trend paths tie (no simulated changepoint yet), both trend
# quantiles are that one value, each rounded by its own float32 weights
# (q * (S - 1) is not exact for every S): they may part by an ulp.
TIE_ULPS = 4


def ordered(lo, hi, ties: bool) -> bool:
    """lo <= hi, or within TIE_ULPS of it where a column may tie."""
    import torch

    if not ties:
        return bool((lo <= hi).all())
    eps = float(np.finfo(np.float32).eps)
    return bool((lo <= hi + TIE_ULPS * eps * hi.abs()).all())


def _band_rows(args, idx):
    """K2's inputs (theta, data, det, add, mult, scale, floor) of rows
    ``idx``."""
    theta, data, *rest = args
    return (theta[idx].contiguous(), _rows(data, idx),
            *(x[idx].contiguous() for x in rest))


def band_row_invariance(args, cfg, s, device) -> dict:
    """K2 with its own Philox draws gives a row the same bits wherever it
    sits, the row keeping its Philox coordinate (``rows``): a slice of the
    batch launched alone, and the batch permuted."""
    import torch

    from tsspark_tpu_torch.kernels import bands as bk

    b = args[0].shape[0]
    full = bk.bands(*args, cfg, s, seed=21)
    lo, hi = b // 8, b // 8 + max(1, b // 16)
    ids = torch.arange(b, dtype=torch.int32, device=device)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(1))
    perm = perm.to(device)
    for name, idx in (("slice", slice(lo, hi)), ("permuted", perm)):
        got = bk.bands(*_band_rows(args, idx), cfg, s, seed=21,
                       rows=ids[idx].contiguous())
        require(all(torch.equal(got[k], full[k][idx]) for k in full),
                f"bands S={s}: a {name} batch differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [lo, hi], "permuted": b, "S": s}


def big_sample_run(inputs, on_cpu, cfg, eng_t, device) -> dict:
    """K2 with its own draws at 65,536 samples (the scratch path) on
    1,024 rows of the engine grid: finite, ordered bands; the yhat bands
    against the plain version's generator on 16 rows on the CPU (at this
    S a quantile's standard error is ~0.007 of the noise's sd); rows
    bitwise invariant."""
    import torch

    from tsspark_tpu_torch.kernels import bands as bk

    s, b, sub = 65536, 1024, 16
    args = inputs(b, eng_t)
    t0 = time.perf_counter()
    own = bk.bands(*args, cfg, s, seed=13)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for lo, hi in (("yhat_lower", "yhat_upper"),
                   ("trend_lower", "trend_upper")):
        require(bool(torch.isfinite(own[lo]).all()
                     & torch.isfinite(own[hi]).all()), f"S={s} {lo} finite")
        require(ordered(own[lo], own[hi], lo.startswith("trend")),
                f"S={s} {lo} <= {hi}")
    part = _band_rows(args, slice(0, sub))
    ref = {k: v.to(device) for k, v in
           bk.bands(*on_cpu(part), cfg, s, seed=13).items()}
    theta, scale = part[0], part[5]
    sigma = torch.exp(theta[:, 2])[:, None] * scale[:, None]
    mc = _mc_compare({k: v[:sub] for k, v in own.items()}, ref,
                     "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc, "yhat_lower", "yhat_upper", f"bands S={s} yhat")
    return {"shape": [b, len(eng_t), s], "wall_s": wall,
            "monte_carlo_yhat_16_rows": mc,
            "row_invariance": band_row_invariance(
                _band_rows(args, slice(0, 128)), cfg, s, device)}


def synthetic_fit_data(rng, config, b, t_len, per_series, device):
    """A fit-shaped FitData: ``synthetic_data``'s grid and features, y
    from the model at random parameters plus noise, and an onset mask
    (leading unobserved days, as in M5) with scattered gaps."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk

    data = synthetic_data(rng, config, b, t_len, per_series, device)
    truth = torch.from_numpy(random_theta(rng, b, config)).to(device)
    yhat, *_ = fk.forward_plain(truth, data, config)
    onset = rng.integers(0, t_len // 3, b)
    mask = (np.arange(t_len)[None, :] >= onset[:, None]) \
        & (rng.uniform(size=(b, t_len)) > 0.02)
    mask_t = torch.from_numpy(mask.astype(np.float32)).to(device)
    noise = torch.from_numpy(
        rng.normal(0.0, 0.05, (b, t_len)).astype(np.float32)).to(device)
    return data._replace(y=((yhat + noise) * mask_t).contiguous(),
                         mask=mask_t)


def _model_cases(growths):
    import dataclasses

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.eval.configs import CONFIG3

    mult = dataclasses.replace(
        CONFIG3, seasonalities=tuple(
            dataclasses.replace(sz, mode="multiplicative")
            for sz in CONFIG3.seasonalities),
        regressors=tuple(dataclasses.replace(rc, mode="multiplicative")
                         if rc.name == "price" else rc
                         for rc in CONFIG3.regressors))
    out = []
    for growth in growths:
        out += [
            (f"{growth}/additive/shared", dataclasses.replace(
                CONFIG3, growth=growth), False),
            (f"{growth}/multiplicative/shared", dataclasses.replace(
                mult, growth=growth), False),
            (f"{growth}/additive/per-series", dataclasses.replace(
                CONFIG3, growth=growth), True),
            (f"{growth}/no-regressors", dataclasses.replace(
                ProphetConfig(), growth=growth), False),
        ]
    return out


def f64_distance(theta, data, cfg, grads) -> dict:
    """Per row, max |g - g64| / (1 + max |g64|) of each named float32
    gradient in ``grads``, g64 the plain version's in float64: the median
    and the worst row."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    data64 = data._replace(**{f: getattr(data, f).double()
                              for f in data._fields})
    g64 = lk.loss_plain(theta.double(), data64, cfg)[1]
    scale = 1.0 + g64.abs().amax(-1)
    out = {}
    for name, g in grads.items():
        d = ((g.double() - g64).abs().amax(-1) / scale).cpu()
        out[name] = {"median": float(d.median()), "max": float(d.max()),
                     "max_abs": float((g.double() - g64).abs().max())}
    torch.cuda.synchronize()
    return out


def stack_past_its_plan(device, b=64, t_len=400) -> dict:
    """A 21-trial value stack whose trial-stack plan passes the card's
    shared memory (logistic, 300 changepoints, 64 seasonal columns) goes
    through K3's row layout: no stack launch, every trial its own
    launch's bits, within ``GAP_TOL`` of the plain version."""
    import torch

    from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig
    from tsspark_tpu_torch.kernels import loss as lk

    rng = np.random.default_rng(7)
    cfg = ProphetConfig(growth="logistic", n_changepoints=300, seasonalities=(
        SeasonalityConfig("yearly", 365.25, 32),))
    data = synthetic_fit_data(rng, cfg, b, t_len, False, device)
    theta = logistic_theta(rng, b, cfg)
    # 300 steps: keep every rate clear of 0.
    theta[:, 3:3 + cfg.n_changepoints] *= 0.1
    theta = torch.from_numpy(theta).to(device)
    trials = [theta * (1.0 + 0.005 * n) for n in range(21)]
    stack = torch.cat(trials).contiguous()
    before = lk.stack_launches
    s_k, _ = lk.loss(stack, data, cfg, grad=False)
    require(lk.stack_launches == before,
            "loss: a stack past the trial-stack plan launched that layout")
    require(all(torch.equal(s_k[n * b:(n + 1) * b],
                            lk.loss(p.contiguous(), data, cfg, grad=False)[0])
                for n, p in enumerate(trials)),
            "loss: a stack past its plan differs from its trials alone")
    s_p, _ = lk.loss_plain(stack, data, cfg, grad=False)
    f_scale, _ = loss_scales(theta, data, cfg)
    gap = _gap(s_k, s_p, f_scale.repeat(21), t_len)
    require(gap <= GAP_TOL, f"loss: a stack past its plan, gap {gap}")
    return {"case": "logistic/ncp-300/fs-64/stack21-row-layout",
            "gap": {"stack": gap}, "stack21_bitwise": True}


def phase_loss(rng, device) -> dict:
    """K3 against its plain version on synthetic fit data; at rates near
    0, both against the plain version in float64 (ROADMAP Queue 3)."""
    import torch

    from tsspark_tpu_torch.eval.configs import CONFIG4
    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = 1024, 1746
    results = []
    cases = [(*c, logistic_theta if c[1].growth == "logistic" else
              random_theta) for c in _model_cases(("linear", "flat",
                                                   "logistic"))] + [
        ("logistic/config-4", CONFIG4, False, logistic_theta),
        ("logistic/config-4/rates-near-0", CONFIG4, False, rates_near_zero)]
    for name, cfg, per_series, theta_fn in cases:
        data = synthetic_fit_data(rng, cfg, b, t_len, per_series, device)
        theta = torch.from_numpy(theta_fn(rng, b, cfg)).to(device)
        f_k, g_k = lk.loss(theta, data, cfg)
        f_p, g_p = lk.loss_plain(theta, data, cfg)
        v_k, _ = lk.loss(theta, data, cfg, grad=False)
        # A stack of 3 trial points on the same data rows, and one of 21
        # (the line search's) whose every trial holds its row-layout bits.
        stack = torch.cat([theta, theta * 1.01, theta * 0.99]).contiguous()
        s_k, _ = lk.loss(stack, data, cfg, grad=False)
        s_p, _ = lk.loss_plain(stack, data, cfg, grad=False)
        trials = [theta * (1.0 + 0.005 * n) for n in range(21)]
        s21, _ = lk.loss(torch.cat(trials).contiguous(), data, cfg,
                         grad=False)
        require(all(torch.equal(s21[n * b:(n + 1) * b],
                                lk.loss(p.contiguous(), data, cfg,
                                        grad=False)[0])
                    for n, p in enumerate(trials)),
                f"loss {name}: a 21-trial stack differs from its trials "
                f"launched alone")
        torch.cuda.synchronize()
        gaps = loss_gaps(theta, data, cfg, {
            "f": (f_k, f_p), "g": (g_k, g_p), "value_mode": (v_k, f_p),
            "stack": (s_k, s_p)})
        require(bool(torch.isfinite(f_k).all() & torch.isfinite(g_k).all()),
                f"loss {name} finite")
        require(torch.equal(v_k, f_k), f"loss {name}: value mode == f")
        require(within_gap_rule(gaps), f"loss {name}: {gaps}")
        results.append({"case": name, "gap": gaps,
                        "max_abs_err_f": float((f_k - f_p).abs().max()),
                        "max_abs_err_g": float((g_k - g_p).abs().max()),
                        "stack21_bitwise": True})
        if theta_fn is rates_near_zero:
            # Which float32 gradient is nearer the float64 one.
            results[-1]["f64_distance"] = f64_distance(
                theta, data, cfg, {"k3": g_k, "plain_f32": g_p})
    results.append(stack_past_its_plan(device))
    out = {"phase": "loss", "shape": [b, t_len],
           "tolerance": GAP_RULE,
           "cases": results}
    emit(out)
    return out


def _ladder(b, device, k_steps=20):
    import torch

    return (0.5 ** torch.arange(k_steps, dtype=torch.float32,
                                device=device))[:, None].expand(
        k_steps, b).contiguous()


def phase_fan(rng, device) -> dict:
    """K4 against its plain version on synthetic fit data."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k

    b, t_len = 1024, 1746
    results = []
    for name, cfg, per_series in _model_cases(("linear",)):
        data = synthetic_fit_data(rng, cfg, b, t_len, per_series, device)
        theta = torch.from_numpy(random_theta(rng, b, cfg)).to(device)
        d = torch.from_numpy(rng.normal(0.0, 0.02, theta.shape).astype(
            np.float32)).to(device)
        ladder = _ladder(b, device)
        got = fan_k.fan(theta, d, ladder, data, cfg)
        want = fan_k.fan_plain(theta, d, ladder, data, cfg)
        torch.cuda.synchronize()
        gap = _gap(got, want, fan_scale(theta, d, ladder, data, cfg), t_len)
        require(bool(torch.isfinite(got).all()), f"fan {name} finite")
        require(gap <= GAP_TOL, f"fan {name}: gap {gap}")
        results.append({"case": name, "gap": gap,
                        "max_abs_err": float((got - want).abs().max())})
    out = {"phase": "fan", "shape": [20, b, t_len],
           "tolerance": GAP_RULE.replace("row", "rung"),
           "cases": results}
    emit(out)
    return out


def serve_registry(args, root: str, batch3) -> dict:
    """The serving path's registry at the M5 shape, published as version 1
    into ``root`` at the top of the run (host work beside the kernels'
    build): ``m5_like(30490, 1941, with_regressors=False)`` prepared under
    the default ``ProphetConfig``, parameters drawn from ``--seed``.  That
    batch is ``batch3`` (``m5_like(30490, 1941)``) without its regressors:
    the generator draws the regressors' values either way, so its series
    are the same bits (``tests/test_torch_room.py``); they are copied, not
    drawn again.  Phase serve serves it, phase serve_scale serves it
    again; ``root`` lives until serve_scale ends."""
    from tsspark_tpu_torch.carry import fitstate_from_numpy
    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.data.datasets import SeriesBatch
    from tsspark_tpu_torch.models.prophet.design import (
        prepare_fit_data_blocks)
    from tsspark_tpu_torch.serve import ParamRegistry

    cfg = ProphetConfig()
    t0 = time.perf_counter()
    batch = SeriesBatch(ds=batch3.ds.copy(), y=batch3.y.copy(),
                        mask=batch3.mask.copy(),
                        series_ids=batch3.series_ids.copy())
    _, meta = prepare_fit_data_blocks(batch.ds, batch.y, cfg)
    prep_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    n = FULL_SERIES
    arrays = {
        "theta": random_theta(rng, n, cfg),
        "loss": np.zeros(n, np.float32),
        "grad_norm": np.zeros(n, np.float32),
        "converged": np.ones(n, bool),
        "n_iters": np.zeros(n, np.int32),
        "status": np.zeros(n, np.int32),
        **meta._asdict(),
    }
    state = fitstate_from_numpy(arrays, "cpu")
    reg = ParamRegistry(root, cfg)
    reg.publish(state, batch.series_ids, step=np.ones(n))
    return {"root": root, "cfg": cfg, "batch": batch, "prep_s": prep_s}


def phase_serve(args, device, made) -> dict:
    import torch

    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
    )

    cfg, batch, root = made["cfg"], made["batch"], made["root"]
    prep_s = made["prep_s"]
    n = FULL_SERIES
    ids = batch.series_ids
    reg = ParamRegistry.open(root)
    engine = PredictionEngine(ParamRegistry.open(root),
                              cache=ForecastCache(4 * n), device=device)
    ds_full = np.concatenate(
        [batch.ds, batch.ds[-1] + np.arange(1, HORIZON + 1)])
    torch.cuda.reset_peak_memory_stats()
    # The main path: counts to 0 just before, read just after.
    fk.launches = 0
    bk.launches = 0
    reqs = [
        ("a: all series, deterministic", list(ids), 0),
        ("b: 4096 series, 256 samples", list(ids[:4096]), 256),
        ("c: all series, 256 samples", list(ids), 256),
        ("d: repeat of a", list(ids), 0),
    ]
    served = {}
    latency = {}
    for name, sids, n_s in reqs:
        t1 = time.perf_counter()
        res = engine.forecast(sids, HORIZON, num_samples=n_s, seed=0,
                              timeout_s=600.0)
        torch.cuda.synchronize()
        latency[name] = time.perf_counter() - t1
        served[name] = res
    t1 = time.perf_counter()
    full = engine.backend.predict(reg.load().state, ds_full,
                                  num_samples=0)
    torch.cuda.synchronize()
    latency["in-sample+28 backend.predict"] = time.perf_counter() - t1
    launches = {"forward": fk.launches, "bands": bk.launches}
    peak = torch.cuda.max_memory_allocated()

    require(launches["forward"] > 0 and launches["bands"] > 0,
            f"kernels launched on the main path: {launches}")
    require(engine.stats.dispatches == 3,
            f"dispatches {engine.stats.dispatches} != 3")
    require(served["d: repeat of a"].from_cache == n, "d from cache")
    for name, res in served.items():
        for k, v in res.values.items():
            require(v.shape == (len(res.series_ids), HORIZON),
                    f"{name} {k} shape")
            require(bool(np.isfinite(v).all()), f"{name} {k} finite")
        if "yhat_lower" in res.values:
            require(bool((res.values["yhat_lower"]
                          <= res.values["yhat_upper"]).all()),
                    f"{name} lower <= upper")
    for k, v in full.items():
        require(v.shape == (n, FULL_DAYS + HORIZON), f"full {k} shape")
        require(bool(np.isfinite(v).all()), f"full {k} finite")
    require(np.array_equal(served["a: all series, deterministic"]
                           .values["yhat"],
                           served["d: repeat of a"].values["yhat"]),
            "cached repeat equals the first answer")
    # Agreement with a reference on a small input: the port's plain
    # path on the CPU for 64 series of request (a).
    from tsspark_tpu_torch.backends.registry import get_backend

    cpu = get_backend("cuda", cfg, device="cpu")
    snap = engine.refresh()
    idx, _ = snap.rows(ids[:64])
    sub, step = snap.take(idx)
    last = sub.meta.ds_start + sub.meta.ds_span
    grid = last[:, None] + step[:, None] * np.arange(1, HORIZON + 1)
    ref = cpu.predict(sub, grid, num_samples=0)
    got = served["a: all series, deterministic"].values
    scale = sub.meta.y_scale[:, None]
    ref_err = max(float(np.max(np.abs(got[k][:64] - ref[k])
                               / (scale + np.abs(ref[k]))))
                  for k in ref)
    require(ref_err <= 1e-5, f"engine vs CPU reference: {ref_err}")
    out = {
        "phase": "serve", "series": n, "days": FULL_DAYS,
        "horizon": HORIZON, "prep_s": prep_s,
        "latency_s": latency, "launches": launches,
        "dispatches": engine.stats.dispatches,
        "from_cache_d": served["d: repeat of a"].from_cache,
        "peak_device_bytes": peak,
        "engine_vs_cpu_reference_err": ref_err,
    }
    emit(out)
    emit(phase_profile(root, list(ids), device))
    kernel_inputs = {
        "state": snap.state, "ds_full": ds_full, "cfg": cfg,
        "step": snap.step, "batch": batch, "root": root,
    }
    return {"out": out, "inputs": kernel_inputs}


FIT_SUBSET = 128


def fit_subset() -> np.ndarray:
    """The parity subset: 128 series spread over config 3's 30,490."""
    return np.linspace(0, FULL_SERIES - 1, FIT_SUBSET).astype(np.int64)


# The CPU parity fits (the scipy oracle and the port's plain fit on each
# fit phase's subset) run in PARITY_WORKERS spawned processes of
# PARITY_THREADS threads each, submitted with the data before the first
# phase; the card's phases run meanwhile, and each fit phase collects its
# own.  (One after another they took ~385 s of an 8-core host before
# phase eval12's scipy fits of 415 series, ~360 s more, and the M5 fleet
# cell's two subset runs joined them.)
PARITY_WORKERS = 3
PARITY_THREADS = 2
_THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def fit_config(no: int):
    """(ProphetConfig, SolverConfig) of eval config ``no`` (1 to 4)."""
    from tsspark_tpu_torch.eval import configs

    return {1: (configs.CONFIG1, configs.SOLVER1),
            2: (configs.CONFIG2, configs.SOLVER2),
            3: (configs.CONFIG3, configs.SOLVER3),
            4: (configs.CONFIG4, configs.SOLVER4)}[no]


def parity_job(kind: str, config_no: int, ds_fit, y, sub: dict,
               ds_full=None, regs_full=None) -> dict:
    """One CPU parity fit of eval config ``config_no`` on a subset (``y``
    and the ``sub`` keywords): ``kind`` "oracle" is the scipy per-series
    fit (with its forecast's yhat over ``ds_full`` when given), "plain"
    the port's plain fit.  Runs in a ``ParityFits`` worker."""
    import torch

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs

    torch.set_num_threads(PARITY_THREADS)
    cfg, solver = fit_config(config_no)
    t0 = time.perf_counter()
    bk = (get_backend("cpu", cfg, solver) if kind == "oracle"
          else get_backend("cuda", cfg, solver, device="cpu"))
    state = bk.fit(ds_fit, y, **sub)
    out = {"seconds": time.perf_counter() - t0,
           "loss": np.asarray(state.loss),
           "status": None if state.status is None
           else np.asarray(state.status),
           "n_iters": np.asarray(state.n_iters)}
    if ds_full is not None:
        out["yhat"] = np.asarray(bk.predict(state, ds_full,
                                            regressors=regs_full,
                                            num_samples=0)["yhat"])
    return out


class ParityFits:
    """The four CPU parity fits of phases fit and fit_logistic, the CPU
    streaming runs of phases stream5 and stream_fleet (``stream_job``:
    config 5's 50 series, plain and with each planted fault; the fleet's
    64-series subset, plain and rolled) and of phase stream_fleet_m5
    (``stream_m5_job``: the M5 subset, plain and rolled), and phase
    eval12's scipy fits (``eval12_oracle_jobs``), in a pool of spawned
    processes beside the card's phases (see PARITY_WORKERS)."""

    def __init__(self, batch3, batch4, stream5_df, fleet_subset_df,
                 m5_subset_df, batches12):
        import multiprocessing as mp
        import os

        from tsspark_tpu_torch.eval import configs

        saved = {k: os.environ.get(k) for k in _THREAD_ENV}
        os.environ.update({k: str(PARITY_THREADS) for k in _THREAD_ENV})
        try:
            self.pool = mp.get_context("spawn").Pool(PARITY_WORKERS)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        split3 = configs.split_point(FULL_DAYS)
        i3 = fit_subset()
        fit3 = (batch3.ds[:split3], np.nan_to_num(batch3.y[i3, :split3]),
                dict(mask=batch3.mask[i3, :split3],
                     regressors=batch3.regressors[i3, :split3]))
        split4 = configs.split_point(C4_DAYS)
        i4 = fit4_subset()
        fit4 = (batch4.ds[:split4], batch4.y[i4, :split4],
                dict(mask=batch4.mask[i4, :split4],
                     cap=batch4.cap[i4, :split4]))
        run = self.pool.apply_async
        self.jobs = {
            ("plain", 3): run(parity_job, ("plain", 3) + fit3),
            ("oracle", 3): run(parity_job, ("oracle", 3) + fit3
                               + (batch3.ds, batch3.regressors[i3])),
            ("plain", 4): run(parity_job, ("plain", 4) + fit4),
            ("oracle", 4): run(parity_job, ("oracle", 4) + fit4),
            ("plain", "stream5"): run(stream_job, ("plain", stream5_df)),
            ("plain", "fleet"): run(stream_job, ("plain", fleet_subset_df)),
            ("rolled", "fleet"): run(stream_job,
                                     ("rolled", fleet_subset_df)),
        }
        for k in STREAM_FAULTS:
            self.jobs[(k, "stream5")] = run(stream_job, (k, stream5_df))
        for k in ("plain", "rolled"):
            self.jobs[(k, "m5")] = run(stream_m5_job, (k, m5_subset_df))
        self.eval12 = eval12_oracle_jobs(run, batches12)

    def get(self, kind: str, config_no: int) -> dict:
        return self.jobs[(kind, config_no)].get()

    def submit(self, fn, *args):
        """A job handed to the pool during the run (``.get()`` waits)."""
        return self.pool.apply_async(fn, args)

    def get_stream(self, kind: str, which: str) -> dict:
        return self.jobs[(kind, which)].get()

    def close(self, finished: bool) -> None:
        """Join the workers after a finished run, else stop them."""
        if finished:
            self.pool.close()
        else:
            self.pool.terminate()
        self.pool.join()


# Loss parity of a fit, per series, in nats.  Two correct float32
# lockstep solvers part after a few iterations and stop at the noise
# floor at different points: on the parity subset at 1,746 days, the JAX
# package and the port's plain fit, both on the CPU, differ by |mean| <=
# 0.011 and per series by up to 1.39 nats, both ways, over data seeds 2
# and 3; against the scipy oracle both batched solvers are 0.32-0.33 nats
# worse on average and up to 2.10 per series (tests/test_torch_fit.py,
# ``-m slow``).  The limits below leave margin over those readings, and
# the same test holds planted faults of the fit to failing them.  A
# gradient off by a few percent is not seen here (it moves the fit less
# than float32 does): the kernel checks at GAP_TOL hold K3 and K4 far
# tighter.
PLAIN_MEAN_TOL = 0.05   # |mean| against the plain fit: KEEP_BEST_MARGIN
PLAIN_SERIES_TOL = 2.0  # |gap| of any series against the plain fit
ORACLE_MEAN_TOL = 0.5   # mean excess over the scipy oracle
ORACLE_SERIES_TOL = 3.0  # excess of any series over the scipy oracle
LIMITS3 = (PLAIN_MEAN_TOL, PLAIN_SERIES_TOL, ORACLE_MEAN_TOL,
           ORACLE_SERIES_TOL)


def loss_parity(loss, plain_loss, oracle_loss, limits=LIMITS3):
    """(readings, failed checks) of a fit's per-series ``loss`` against a
    plain fit's and the scipy oracle's on the same series; ``limits``:
    (|mean| and per-series |gap| to the plain fit, mean and per-series
    excess over the oracle; None: not held), config 3's by default."""
    plain_mean, plain_series, oracle_mean, oracle_series = limits
    gap = np.asarray(loss, np.float64) - np.asarray(plain_loss, np.float64)
    over = np.asarray(loss, np.float64) - np.asarray(oracle_loss, np.float64)
    readings = {
        "loss_minus_plain_mean": float(gap.mean()),
        "loss_minus_plain_min": float(gap.min()),
        "loss_minus_plain_max": float(gap.max()),
        "loss_minus_plain_over_+0.05": int((gap > 0.05).sum()),
        "loss_minus_plain_under_-0.05": int((gap < -0.05).sum()),
        "loss_minus_oracle_mean": float(over.mean()),
        "loss_minus_oracle_max": float(over.max()),
    }
    failed = [what for what, bad in (
        (f"|mean gap to the plain fit| > {plain_mean}",
         abs(gap.mean()) > plain_mean),
        (f"a series' |gap to the plain fit| > {plain_series}",
         not np.all(np.abs(gap) <= plain_series)),
        (f"mean excess over the oracle > {oracle_mean}",
         oracle_mean is not None and not over.mean() <= oracle_mean),
        (f"a series' excess over the oracle > {oracle_series}",
         not np.all(over <= oracle_series)),
    ) if bad]
    return readings, failed


# Eval config 4 at 8,192 series: ``config4_wiki_logistic(scale=1024)``,
# one full chunk of ``CudaBackend``; its parity subset, spread over them:
# 64 series, where config 3 takes 128, because the scipy oracle and the
# plain fit of a logistic series take several times a linear one's (~6
# minutes for 128 on the card's host), and the run's time requires it.
C4_SERIES = 8192
C4_DAYS = 1200
FIT4_SUBSET = 64


def fit4_subset() -> np.ndarray:
    return np.linspace(0, C4_SERIES - 1, FIT4_SUBSET).astype(np.int64)


# Config 4's loss-parity limits, in nats.  Its losses are ~3e3 nats a
# series at 1,080 days, and after 200 iterations more than a quarter of
# the series are still moving, so two correct float32 lockstep solvers
# end them at points far apart.  Each limit lies between the largest
# reading of a sound fit (the JAX package against the port's plain fit
# on the CPU, data seeds 2 and 3, and the card's fit) and the smallest
# reading of a planted fault (stuck at its init; cut at 40 iterations),
# near their geometric mean (PERF.md's config-4 limits table;
# tests/test_torch_logistic.py ``-m slow`` prints them):
#   |mean gap to the plain fit|     sound <= 0.289, faults >= 11.8  -> 0.5
#   a series' |gap to the plain fit| sound <= 10.42, faults >= 48.5 -> 20
#   a series' excess over the oracle sound <= 26.6, faults >= 58.8  -> 40
# The mean excess over the oracle is not held (None): the oracle stalls
# above the batched fits on many logistic series, so sound fits read
# -3.8 to -18 and the 40-iteration cut -5.4; it could catch only a fit
# stuck at its init, which the other three catch.
LIMITS4 = (0.5, 20.0, None, 40.0)


def phase_fit(device, batch, gen_s, parity) -> dict:
    """Eval config 3 (``batch``, generated in ``gen_s``) fitted at full
    width through ``CudaBackend.fit``, scored, profiled, and held against
    the scipy oracle and the plain CPU fit on a subset (``parity``'s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.init import (
        curvature_diag,
        initial_theta,
    )
    from tsspark_tpu_torch.models.prophet.model import _objective
    from tsspark_tpu_torch.ops import lbfgs

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    split = configs.split_point(FULL_DAYS)
    ds_fit = batch.ds[:split]
    y_fit = np.nan_to_num(batch.y[:, :split])
    m_fit = batch.mask[:, :split]
    r_fit = batch.regressors[:, :split]
    bk = get_backend("cuda", cfg, solver, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lbfgs.timing.reset()
    # The main path: counts to 0 just before, read just after.
    lk.launches = lk.grad_launches = fan_k.launches = fk.launches = 0
    t0 = time.perf_counter()
    state = bk.fit(ds_fit, y_fit, mask=m_fit, regressors=r_fit)
    fit_s = time.perf_counter() - t0
    stages = dict(bk.stages.seconds)
    bk.stages.reset()
    t0 = time.perf_counter()
    fc = bk.predict(state, batch.ds, regressors=batch.regressors,
                    num_samples=0)
    predict_s = time.perf_counter() - t0
    launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                "loss_value": lk.launches - lk.grad_launches,
                "fan": fan_k.launches, "forward": fk.launches}
    peak = torch.cuda.max_memory_allocated()
    iters, body_s = lbfgs.timing.iters, lbfgs.timing.body_s

    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["fan"] > 0 and launches["forward"] > 0,
            f"kernels launched on the fit path: {launches}")
    require(tuple(state.theta.shape) == (FULL_SERIES, cfg.num_params),
            "fitted theta shape")
    require(bool(torch.isfinite(state.theta).all()), "theta finite")
    require(bool(np.isfinite(state.loss).all()), "loss finite")
    require(fc["yhat"].shape == (FULL_SERIES, FULL_DAYS), "forecast shape")
    require(bool(np.isfinite(fc["yhat"]).all()), "forecast finite")
    sc = configs.score(batch, fc)

    # One chunk's solve under the profiler: the first 8,192 series,
    # packed and unpacked as the fit does, init outside the window.
    c = bk.chunk_size
    u8 = design._indicator_reg_cols(r_fit)
    data_np, meta = design.prepare_fit_data(
        ds_fit, y_fit[:c], cfg, mask=m_fit[:c], regressors=r_fit[:c])
    packed, _ = design.pack_fit_data(data_np, meta, ds_fit, reg_u8_cols=u8,
                                     collapse_cap=True)
    data = design.unpack_fit_data(design.packed_to_device(packed, device),
                                  u8)
    theta0 = initial_theta(data, cfg, solver)
    precond = curvature_diag(data, cfg, theta0)
    fun, fval, fan = _objective(data, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res = lbfgs.minimize(fun, theta0, solver, fun_value=fval,
                             precond=precond, fan_value=fan)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    chunk_iters = int(res.n_iters.max())

    # Parity on a subset spread over the batch.
    idx = fit_subset()
    t1 = time.perf_counter()
    oracle, plain = parity.get("oracle", 3), parity.get("plain", 3)
    wait_s = time.perf_counter() - t1
    sub_batch = batch._replace(y=batch.y[idx], mask=batch.mask[idx],
                               regressors=batch.regressors[idx],
                               series_ids=batch.series_ids[idx])
    o_sc = configs.score(sub_batch, {"yhat": oracle["yhat"]})
    d_train = sc["smape_train"][idx] - o_sc["smape_train"]
    d_hold = sc["smape_holdout"][idx] - o_sc["smape_holdout"]
    loss_readings, loss_failed = loss_parity(state.loss[idx], plain["loss"],
                                             oracle["loss"])
    loss_gap = state.loss[idx] - plain["loss"]
    worst = np.argsort(-np.abs(loss_gap))[:5]
    parity = {
        "subset": FIT_SUBSET,
        "oracle_s": oracle["seconds"], "plain_cpu_fit_s": plain["seconds"],
        "parity_wait_s": wait_s,
        "smape_train_max_abs_delta": float(np.abs(d_train).max()),
        "smape_train_mean_delta": float(d_train.mean()),
        "smape_holdout_max_abs_delta": float(np.abs(d_hold).max()),
        "smape_holdout_mean_delta": float(d_hold.mean()),
        **loss_readings,
        "loss_checks_failed": loss_failed,
        "worst_rows": [
            {"series": int(idx[w]), "gap": float(loss_gap[w]),
             "status": [int(state.status[idx[w]]), int(plain["status"][w])],
             "n_iters": [int(state.n_iters[idx[w]]),
                         int(plain["n_iters"][w])]}
            for w in worst],
    }
    status = np.bincount(np.asarray(state.status), minlength=5)
    out = {
        "phase": "fit", "series": FULL_SERIES, "days_fit": split,
        "days_forecast": FULL_DAYS, "params": cfg.num_params,
        "m5_like_s": gen_s, "fit_s": fit_s, "predict_s": predict_s,
        "stages_s": stages,
        "launches": launches,
        "iterations": {"mean": float(np.mean(state.n_iters)),
                       "max": int(np.max(state.n_iters)),
                       "solver_bodies": iters},
        "host_ms_per_iteration": 1e3 * body_s / max(iters, 1),
        "status_counts": {"running": int(status[0]), "gtol": int(status[1]),
                          "ftol": int(status[2]), "floor": int(status[3]),
                          "stalled": int(status[4])},
        "converged_frac": float(np.mean(state.converged)),
        "smape_train": float(sc["smape_train"].mean()),
        "smape_holdout": float(sc["smape_holdout"].mean()),
        "peak_device_bytes": peak,
        "chunk_solve_profile": {
            "rows": c, "iterations": chunk_iters, "traced_wall_s": traced,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
            "top_device_ms": [(k[:60], ms) for k, ms in top[:6]],
        },
        "parity": parity,
    }
    emit(out)
    require(parity["smape_train_max_abs_delta"] <= 0.1,
            f"per-series train sMAPE vs the scipy oracle: {parity}")
    require(abs(parity["smape_train_mean_delta"]) <= 0.05,
            f"mean train sMAPE vs the scipy oracle: {parity}")
    require(not loss_failed, f"loss parity: {loss_failed}: {parity}")
    d = -precond * fun(theta0)[1]
    return {"out": out, "inputs": {
        "data": data, "theta0": theta0, "direction": d.contiguous(),
        "theta_fit": state.theta[:c].to(device).contiguous(), "cfg": cfg,
        "batch": batch}}


def phase_fit_logistic(device, batch, gen_s, parity) -> dict:
    """Eval config 4 at 8,192 series (``config4_wiki_logistic(scale=1024)``'s
    batch, ``batch``, generated in ``gen_s``) fitted on its first 1,080
    days through ``CudaBackend.fit``, then forecast with 256-sample bands
    over all 1,200 days through ``predict``; scored, and held against the
    scipy oracle and the plain CPU fit on a subset (``parity``'s;
    ``loss_parity`` at ``LIMITS4``)."""
    import torch

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.init import initial_theta
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data
    from tsspark_tpu_torch.ops import lbfgs

    cfg, solver = configs.CONFIG4, configs.SOLVER4
    split = configs.split_point(C4_DAYS)
    ds_fit = batch.ds[:split]
    y_fit, m_fit = batch.y[:, :split], batch.mask[:, :split]
    cap_fit = batch.cap[:, :split]
    bk = get_backend("cuda", cfg, solver, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lbfgs.timing.reset()
    # The main path: counts to 0 just before, read just after.
    lk.launches = lk.grad_launches = lk.stack_launches = fan_k.launches = 0
    fk.launches = bands_k.launches = 0
    t0 = time.perf_counter()
    state = bk.fit(ds_fit, y_fit, mask=m_fit, cap=cap_fit)
    fit_s = time.perf_counter() - t0
    stages = dict(bk.stages.seconds)
    bk.stages.reset()
    t0 = time.perf_counter()
    fc = bk.predict(state, batch.ds, cap=batch.cap, num_samples=256)
    predict_s = time.perf_counter() - t0
    launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                "loss_value": lk.launches - lk.grad_launches,
                "loss_stack": lk.stack_launches,
                "fan": fan_k.launches, "forward": fk.launches,
                "bands": bands_k.launches}
    peak = torch.cuda.max_memory_allocated()
    iters, body_s = lbfgs.timing.iters, lbfgs.timing.body_s

    # The line search's trial stacks went through the trial-stack layout.
    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["loss_stack"] > 0
            and launches["forward"] > 0 and launches["bands"] > 0,
            f"kernels launched on the config-4 path: {launches}")
    require(tuple(state.theta.shape) == (C4_SERIES, cfg.num_params),
            "fitted theta shape")
    require(bool(torch.isfinite(state.theta).all()), "theta finite")
    require(bool(np.isfinite(state.loss).all()), "loss finite")
    for k, v in fc.items():
        require(v.shape == (C4_SERIES, C4_DAYS), f"forecast {k} shape")
        require(bool(np.isfinite(v).all()), f"forecast {k} finite")
    require(bool((fc["yhat_lower"] <= fc["yhat_upper"]).all()),
            "yhat_lower <= yhat_upper")
    require(ordered(torch.from_numpy(fc["trend_lower"]),
                    torch.from_numpy(fc["trend_upper"]), True),
            "trend_lower <= trend_upper")
    sc = configs.score(batch, fc)

    # Parity on a subset spread over the batch.
    idx = fit4_subset()
    t1 = time.perf_counter()
    oracle, plain = parity.get("oracle", 4), parity.get("plain", 4)
    wait_s = time.perf_counter() - t1
    loss_readings, loss_failed = loss_parity(state.loss[idx], plain["loss"],
                                             oracle["loss"], LIMITS4)
    loss_gap = state.loss[idx] - plain["loss"]
    worst = np.argsort(-np.abs(loss_gap))[:5]
    parity = {
        "subset": FIT4_SUBSET, "limits": LIMITS4,
        "oracle_s": oracle["seconds"], "plain_cpu_fit_s": plain["seconds"],
        "parity_wait_s": wait_s,
        **loss_readings,
        "loss_checks_failed": loss_failed,
        "worst_rows": [
            {"series": int(idx[w]), "gap": float(loss_gap[w]),
             "status": [int(state.status[idx[w]]), int(plain["status"][w])],
             "n_iters": [int(state.n_iters[idx[w]]),
                         int(plain["n_iters"][w])]}
            for w in worst],
    }
    status = np.bincount(np.asarray(state.status), minlength=5)
    out = {
        "phase": "fit_logistic", "series": C4_SERIES, "days_fit": split,
        "days_forecast": C4_DAYS, "params": cfg.num_params,
        "samples": 256,
        "wiki_logistic_like_s": gen_s, "fit_s": fit_s,
        "predict_s": predict_s, "stages_s": stages,
        "launches": launches,
        "iterations": {"mean": float(np.mean(state.n_iters)),
                       "max": int(np.max(state.n_iters)),
                       "solver_bodies": iters},
        "host_ms_per_iteration": 1e3 * body_s / max(iters, 1),
        "status_counts": {"running": int(status[0]), "gtol": int(status[1]),
                          "ftol": int(status[2]), "floor": int(status[3]),
                          "stalled": int(status[4])},
        "converged_frac": float(np.mean(state.converged)),
        "smape_train": float(sc["smape_train"].mean()),
        "smape_holdout": float(sc["smape_holdout"].mean()),
        "peak_device_bytes": peak,
        "parity": parity,
    }
    emit(out)
    require(not loss_failed, f"config-4 loss parity: {loss_failed}: "
            f"{parity}")

    # The kernels' inputs at this path's shapes: the fit's chunk as the
    # fit packs it, its ridge init, a line search's 21-row trial stack,
    # and the forecast's chunk.
    data_np, meta = design.prepare_fit_data(ds_fit, y_fit, cfg, mask=m_fit,
                                            cap=cap_fit)
    packed, _ = design.pack_fit_data(data_np, meta, ds_fit)
    data = design.unpack_fit_data(design.packed_to_device(packed, device))
    theta0 = initial_theta(data, cfg, solver)
    trials = line_search_stack(data, cfg, solver, device)
    theta_fit = state.theta.to(device).contiguous()
    pdata = prepare_predict_data(batch.ds, meta, cfg, device, cap=batch.cap)
    return {"out": out, "inputs": {
        "data": data, "theta0": theta0, "theta_fit": theta_fit,
        "trials": trials, "pdata": pdata, "cfg": cfg,
        "predict_chunk": bk._chunk(C4_SERIES, 256 * C4_DAYS, 1),
        "y_scale": torch.as_tensor(meta.y_scale, dtype=torch.float32,
                                   device=device),
        "floor": torch.as_tensor(meta.floor, dtype=torch.float32,
                                 device=device)}}


# Eval configs 1 and 2 at their published sizes (phase eval12): config 1
# one daily series of 2,905 days (yearly order 10 + weekly order 3, 25
# changepoints, P = 54), config 2 414 hourly series of 700-960 hours
# right-aligned on one grid (daily order 4 + weekly order 3, 10
# changepoints, P = 27), each fitted on the first 90% of its calendar
# through ``CudaBackend.fit`` and forecast over all of it.  Every series of
# both is fitted by the port's scipy oracle in the parity workers, and the
# card's per-series train sMAPE is held to it by the budget of
# tests/test_backends.py:77-78 (per series EVAL12_SERIES_TOL, the mean
# EVAL12_MEAN_TOL).  Holdout deltas are reported (``_delta_dist``), not
# held: no limit for them has been measured against the JAX package's own
# batched-vs-oracle deltas at these sizes (its config 1 record reads 0.348,
# EVAL_r03.json).
EVAL12_SERIES_TOL = 0.1
EVAL12_MEAN_TOL = 0.05
EVAL12_ORACLE_JOBS = 6  # config 2's oracle fits, split over the pool
EVAL12_CASES = {1: "config1_peyton", 2: "config2_m4_hourly"}


def eval12_batches() -> dict:
    """Eval configs 1 and 2's datasets at their published sizes."""
    from tsspark_tpu_torch.data.datasets import (
        m4_hourly_like,
        peyton_manning_like,
    )

    return {1: peyton_manning_like(), 2: m4_hourly_like()}


def eval12_oracle_jobs(run, batches) -> dict:
    """Submit the scipy oracle's fits of every series of configs 1 and 2
    (``parity_job``, with each forecast's yhat over the whole calendar):
    {config: [(rows, job)]}."""
    from tsspark_tpu_torch.eval import configs

    jobs = {}
    for no, b in batches.items():
        split = configs.split_point(b.y.shape[1])
        parts = np.array_split(np.arange(b.y.shape[0]),
                               EVAL12_ORACLE_JOBS if no == 2 else 1)
        jobs[no] = [(rows, run(parity_job, (
            "oracle", no, b.ds[:split], np.nan_to_num(b.y[rows, :split]),
            dict(mask=b.mask[rows, :split]), b.ds))) for rows in parts]
    return jobs


def eval12_kernels(state, batch, cfg, plan, device) -> dict:
    """K3 (both modes) and K4 by GAP_RULE at the fitted parameters on the
    config's fit shape (and each length bucket's, when the fit took
    buckets), K3/K4 rows bitwise invariant, K1 against its plain version
    on the forecast's shape; each timed against its bound and its plain
    version."""
    import torch

    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.design import (
        fitdata_to_device,
        prepare_fit_data,
    )
    from tsspark_tpu_torch.models.prophet.predict import (
        prepare_predict_data,
    )

    split = configs.split_point(batch.y.shape[1])
    y = np.nan_to_num(batch.y[:, :split])
    m = batch.mask[:, :split]
    theta = state.theta.to(device).contiguous()
    gen = torch.Generator(device=device).manual_seed(12)

    def held_at(rows, lo, hi, what):
        data = fitdata_to_device(prepare_fit_data(
            batch.ds[lo:hi], y[rows, lo:hi], cfg, mask=m[rows, lo:hi])[0],
            device)
        th = theta[torch.as_tensor(rows, device=device)].contiguous()
        d = (0.02 * torch.randn(th.shape, generator=gen, device=device))
        return data, th, d, hold_kernels(th, d, data, cfg, what)

    rows = np.arange(batch.y.shape[0])
    data, th, d, held = held_at(rows, 0, split, "the fit's shape")
    b, t_len = data.t.shape
    ladder = _ladder(b, device)
    sl = slice(0, 1) if b == 1 else slice(100, 300)
    inv = row_invariance(data, cfg, th, d, ladder, device, sl)
    out = {"loss": {**held, "row_invariance": inv,
                    "ms": cuda_ms(lambda: lk.loss(th, data, cfg)),
                    "plain_ms": cuda_ms(lambda: lk.loss_plain(th, data, cfg),
                                        iters=3, warmup=1),
                    **loss_bound_ms(b, b, t_len, cfg, True),
                    "value_mode": {
                        "ms": cuda_ms(lambda: lk.loss(th, data, cfg,
                                                      grad=False)),
                        **loss_bound_ms(b, b, t_len, cfg, False)}},
           "fan": {"shape": [20, b, t_len], "gap": held["gap"]["fan"],
                   "max_abs_err": held["fan_max_abs_err"],
                   "ms": cuda_ms(lambda: fan_k.fan(th, d, ladder, data,
                                                   cfg)),
                   "plain_ms": cuda_ms(lambda: fan_k.fan_plain(
                       th, d, ladder, data, cfg), iters=3, warmup=1),
                   **fan_bound_ms(b, t_len, 20, cfg)}}
    if plan is not None:
        out["loss"]["buckets"] = [
            {"rows": int(len(idx)), "window": [int(lo), int(hi)],
             "gap": held_at(np.asarray(idx), lo, hi,
                            f"length bucket [{lo}, {hi})")[3]["gap"]}
            for idx, lo, hi in plan]
    pdata = prepare_predict_data(batch.ds, state.meta, cfg, device)
    scale = torch.as_tensor(state.meta.y_scale, dtype=torch.float32,
                            device=device)
    floor = torch.as_tensor(state.meta.floor, dtype=torch.float32,
                            device=device)
    got = fk.forward(theta, pdata, cfg, scale, floor)
    want = fk.forward_plain(theta, pdata, cfg, scale, floor)
    err = _forward_err(got, want, scale)
    require(err <= 2e-5, f"forward at the config's forecast shape: {err}")
    out["forward"] = {
        "shape": list(pdata.t.shape) if pdata.t.ndim == 2
        else [b] + list(pdata.t.shape),
        "max_rel_err": err,
        "max_abs_err": max(float((g - w).abs().max())
                           for g, w in zip(got, want)),
        "ms": cuda_ms(lambda: fk.forward(theta, pdata, cfg, scale, floor)),
        "plain_ms": cuda_ms(lambda: fk.forward_plain(
            theta, pdata, cfg, scale, floor), iters=3, warmup=1),
        **forward_bound_ms(b, batch.y.shape[1], cfg, False, True)}
    return out


def phase_eval12(device, batches, gen_s, parity) -> dict:
    """Eval configs 1 and 2 at their published sizes through
    ``CudaBackend.fit`` and ``predict`` on the card (launch counts set to
    0 just before each, read just after): sMAPE, the length-bucket plan,
    the kernels at the configs' shapes against their plain versions, and
    every series against the scipy oracle (the parity budget; a
    ``run_parity``-shaped record)."""
    import torch

    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.eval.parity import parity_record

    res = {"phase": "eval12", "data_s": gen_s, "configs": {}}
    records = {}
    for no, batch in batches.items():
        t0 = time.perf_counter()
        cfg, solver = fit_config(no)
        split = configs.split_point(batch.y.shape[1])
        torch.cuda.synchronize()
        _zero_counts()
        bk, state, fc, fit_s = configs.fit_and_forecast(
            cfg, batch, "cuda", solver, device=device)
        torch.cuda.synchronize()
        launches = _stream_counts()
        sc = configs.score(batch, fc)
        plan = bk._plan_length_buckets(np.nan_to_num(batch.y[:, :split]),
                                       batch.mask[:, :split])
        kern = eval12_kernels(state, batch, cfg, plan, device)
        t1 = time.perf_counter()
        yhat = np.full(batch.y.shape, np.nan)
        cpu_s = 0.0
        for rows, job in parity.eval12[no]:
            got = job.get()
            yhat[rows] = got["yhat"]
            cpu_s += got["seconds"]
        wait_s = time.perf_counter() - t1
        oracle = configs.score(batch, {"yhat": yhat})
        rec = parity_record(oracle["smape_train"], oracle["smape_holdout"],
                            cpu_s, sc["smape_train"], sc["smape_holdout"],
                            fit_s)
        records[EVAL12_CASES[no]] = rec
        res["configs"][EVAL12_CASES[no]] = {
            "series": int(batch.y.shape[0]), "days_fit": split,
            "days": int(batch.y.shape[1]), "params": cfg.num_params,
            "fit_s": fit_s, "launches": launches,
            "backend_stages_s": dict(bk.stages.seconds),
            "status_counts": np.unique(np.asarray(state.status),
                                       return_counts=True)[1].tolist(),
            "converged_frac": float(np.asarray(state.converged).mean()),
            "length_buckets": None if plan is None else [
                {"rows": int(len(i)), "window": [int(lo), int(hi)]}
                for i, lo, hi in plan],
            "smape_train": float(sc["smape_train"].mean()),
            "smape_holdout": float(sc["smape_holdout"].mean()),
            "kernels": kern, "oracle_wait_s": wait_s,
            "phase_s": time.perf_counter() - t0}
        require(np.isfinite(fc["yhat"]).all(), f"config {no} finite")
        require(launches["loss_grad"] > 0 and launches["fan"] > 0
                and launches["forward"] > 0,
                f"config {no} ran K3, K4 and K1: {launches}")
        require(rec["delta_train_max_abs"] <= EVAL12_SERIES_TOL
                and abs(rec["delta_train_mean"]) <= EVAL12_MEAN_TOL,
                f"config {no} against the scipy oracle: {rec}")
    res["parity"] = {"kind": "eval-parity", "scale": 1.0,
                     "platform": "cuda:" + torch.cuda.get_device_name(0),
                     "configs": records,
                     "train_limits": {"series": EVAL12_SERIES_TOL,
                                      "mean": EVAL12_MEAN_TOL}}
    emit(res)
    return res


# Continuous refit (eval config 5): ``StreamingForecaster`` over a 510-day
# base batch and three 73-day micro-batches, at config 5's published 50
# series (phase stream5) and at the M5 fleet's scale (phase
# stream_fleet, cut to FLEET_CUT's rows).  At config 5's scale a series'
# forecast sMAPE (percent,
# 14 days against the noise-free generator) is held per series against
# the port's plain CPU run of the same series at STREAM_SMAPE_TOL.  Readings at config 5's 50
# series on the CPU (tests/test_torch_stream5.py ``-m slow`` prints them):
# sound runs part by at most 0.0089 (the JAX package's warm against cold
# run; the port's plain run against the JAX package's: 0.0072 warm, 0.0044
# cold and replayed); the planted faults against the sound port run: the
# warm start taken from the neighbouring series' row ("rolled") 4.78, the
# stored theta passed on untransferred ("raw_theta") 0.0129 — within two
# of the sound spread, so no sMAPE limit can see that one (60 iterations
# and the rescue pass recover from it; tests/test_torch_streaming.py holds
# transfer_theta itself to the JAX package at 1e-6).  The limit sits 5.6x
# above the sound readings and ~100x below the rolled fault.
STREAM_SMAPE_TOL = 0.05
STREAM_FAULTS = ("rolled", "raw_theta")
REPLAY_TOL = 1e-3       # |delta mean sMAPE| after the replay: the reference's
# At the fleet's width the same generator puts levels up to 6.1e5 under
# the same noise, and a forecast's sMAPE there is ~1e-4: no sMAPE limit
# can fail a wrong fleet forecast.  The fleet's forecasts are held per
# series in units of the noise instead: the largest |yhat_a - yhat_b|
# over the 14 days, / NOISE5.  There float32 resolves a series to a few
# ulps of its level, ~1e-7 x 6e5 = 0.07 at the top, and two sound runs
# part by more than the noise.  Readings (the 64-series subset; an H100,
# PERF.md §6): the card against the CPU plain path at most 6.75 warm,
# 2.5 replayed, 20.1 cold (cold rows start from a ridge init taken over
# the card's 8,192-row chunk); the card's replay against its warm run at
# most 10.5 over all 30,490 series; on the CPU the subset's warm and cold
# runs part by up to 9.7.  The rolled fault on the subset reads 150.5
# against the sound CPU run (series 0, warm-started from the top
# series' row), and must fail the limit.  The limit sits 2x above the
# largest sound reading and 3.8x below the fault.
NOISE5 = 0.5
FLEET_NOISE_TOL = 40.0
FLEET_SERIES = 30490
FLEET_SUBSET = 64
# Continuous refit at the fleet's scale (its two cells, phases
# stream_fleet and stream_fleet_m5) is the one path run at a smaller
# depth than the fleet's FLEET_SERIES, room for phases resilient and
# frontend within the script's time (the whole script read 982.6 s on an
# H100 with the cold run alone cut, and 1,144.5 s with phase frontend
# added and both cells whole, against the 1,000 s aim and the 1,200 s
# limit): the first FLEET_CUT series and the fleet subset's (8,239), so
# every chunk keeps the fleet's 8,192-row shape and the subset's checks
# stay whole, on the same series.  Every other phase runs at its path's
# full depth.
FLEET_CUT = 8192


def fleet_subset() -> np.ndarray:
    return np.linspace(0, FLEET_SERIES - 1, FLEET_SUBSET).astype(np.int64)


def fleet_rows() -> np.ndarray:
    """The rows the fleet cells run: the first FLEET_CUT series and the
    fleet subset's, ascending."""
    return np.union1d(np.arange(FLEET_CUT), fleet_subset())


def planted_transfer(name: str):
    """The streaming driver's ``transfer_theta`` with a planted fault:
    "rolled" (each series warm-started from its neighbour's transferred
    row), "raw_theta" (the stored theta passed on untransferred)."""
    from tsspark_tpu_torch.streaming import driver

    sound = driver.transfer_theta

    def rolled(th, mo, mn, cfg, device=None):
        import torch

        return torch.roll(sound(th, mo, mn, cfg, device=device), 1, 0)

    def raw_theta(th, mo, mn, cfg, device=None):
        return th.to(device)

    return {"rolled": rolled, "raw_theta": raw_theta}[name]


def stream5_fault_run(name: str, df) -> dict:
    """Config 5's schedule over ``df`` on the CPU plain path with a
    planted fault in the warm start: "rolled" (each series warm-started
    from its neighbour's transferred row), "raw_theta" (the stored theta
    passed on untransferred); ``config5_run``'s detail."""
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.streaming import driver

    sound = driver.transfer_theta
    driver.transfer_theta = planted_transfer(name)
    try:
        _, det = configs.config5_run("cuda", 1.0, "cpu", frame=df,
                                     warmup=False)
    finally:
        driver.transfer_theta = sound
    return det


def stream_job(kind: str, df) -> dict:
    """One CPU run of config 5's schedule over ``df`` in a ``ParityFits``
    worker: "plain" the port's plain path (warm, cold, replayed), else a
    planted fault (``stream5_fault_run``, warm): per-series sMAPE and
    yhat of each."""
    import torch

    from tsspark_tpu_torch.eval import configs

    torch.set_num_threads(PARITY_THREADS)
    t0 = time.perf_counter()
    if kind == "plain":
        out, det = configs.config5_run("cuda", 1.0, "cpu", frame=df,
                                       warmup=False)
        keys = ("warm", "cold", "replay")
        res = {"out": out}
    else:
        det, keys, res = stream5_fault_run(kind, df), ("warm",), {}
    for k in keys:
        res[k], res[f"yhat_{k}"] = det[f"smape_{k}"], det[f"yhat_{k}"]
    res["seconds"] = time.perf_counter() - t0
    return res


def _stream_counts():
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    return {"loss_grad": lk.grad_launches,
            "loss_value": lk.launches - lk.grad_launches,
            "loss_stack": lk.stack_launches, "fan": fan_k.launches,
            "forward": fk.launches, "bands": bands_k.launches}


def _zero_counts() -> None:
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    lk.launches = lk.grad_launches = lk.stack_launches = fan_k.launches = 0
    fk.launches = bands_k.launches = 0


def _sum_counts(rows) -> dict:
    out = {}
    for r in rows:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _smape_gap(got, want) -> dict:
    d = np.abs(np.asarray(got) - np.asarray(want))
    return {"max": float(d.max()), "mean": float(d.mean()),
            "series_over_tol": int((d > STREAM_SMAPE_TOL).sum())}


def phase_stream5(device, parity) -> dict:
    """Eval config 5 at its published scale through ``config5_run`` on
    the card (the runner's throwaway pass, the warm run, the cold run,
    the replay), held against the port's plain CPU run per series and
    against the planted faults; K3 (both modes) and K4 on its 50-series
    chunk of the last micro-batch (``hold_stream_kernels``) and K1 on its
    50 x 14 forecast chunk, against their plain versions."""
    import json
    import os

    import torch

    from tsspark_tpu_torch import native
    from tsspark_tpu_torch.eval import configs

    require(native.available(), "the native ingest library builds here")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out, det = configs.config5_run("cuda", 1.0, device)
    wall = time.perf_counter() - t0
    launches = _stream_counts()
    sf = det["forecaster"]
    ids, theta, data = stream_chunk(sf, det["batches"][-1], device)
    kern = {"loss_fan": hold_stream_kernels(theta, data, sf.config, seed=4),
            "forward": stream_forward(sf, ids, device)[0]}
    plain = parity.get_stream("plain", "stream5")
    faults = {k: parity.get_stream(k, "stream5")["warm"]
              for k in STREAM_FAULTS}
    gaps = {k: _smape_gap(det[f"smape_{k}"], plain[k])
            for k in ("warm", "cold", "replay")}
    fault_gaps = {k: _smape_gap(v, det["smape_warm"])
                  for k, v in faults.items()}
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "EVAL_builder_r05_cpu.json")
    with open(ref_path) as fh:
        jax_cpu = json.load(fh)["config5_streaming"]
    po = plain["out"]
    res = {"phase": "stream5", "wall_s": wall, "native": native.available(),
           "config5": out, "launches": launches,
           "warm_batches": [{"wall_s": w, "stages_s": s} for w, s in zip(
               det["warm"]["batch_seconds"], det["warm"]["batch_stages"])],
           "plain_cpu": {"config5": po, "seconds": plain["seconds"]},
           "smape_vs_plain_cpu": gaps, "tolerance": STREAM_SMAPE_TOL,
           "planted_faults_vs_card": fault_gaps, "kernels": kern,
           "jax_package_cpu_record": {
               "source": "EVAL_builder_r05_cpu.json",
               "smape_warm": jax_cpu["warm_vs_cold"]["smape_warm"],
               "smape_cold": jax_cpu["warm_vs_cold"]["smape_cold"],
               "warm_starts": jax_cpu["warm_starts"],
               "cold_starts": jax_cpu["cold_starts"],
               "replay_delta": jax_cpu["crash_replay"][
                   "smape_delta_after_replay"]}}
    emit(res)
    for k in ("micro_batches", "warm_starts", "cold_starts", "n_series"):
        require(out[k] == po[k], f"stream5 {k}: {out[k]} != {po[k]}")
    require(out["warm_vs_cold"]["cold_starts_forced"]
            == po["warm_vs_cold"]["cold_starts_forced"],
            "stream5 forced cold starts")
    require((out["warm_starts"], out["cold_starts"]) == (150, 50),
            f"stream5 counts {out['warm_starts']}, {out['cold_starts']}")
    require(out["crash_replay"]["smape_delta_after_replay"] < REPLAY_TOL,
            f"stream5 replay: {out['crash_replay']}")
    require(all(np.isfinite(det[f"smape_{k}"]).all()
                for k in ("warm", "cold", "replay")), "stream5 finite")
    require(all(g["max"] <= STREAM_SMAPE_TOL for g in gaps.values()),
            f"stream5 sMAPE against the plain CPU run: {gaps}")
    require(fault_gaps["rolled"]["max"] > STREAM_SMAPE_TOL,
            f"stream5: the rolled fault passes the limit: {fault_gaps}")
    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["fan"] > 0 and launches["forward"] > 0,
            f"stream5 kernels launched: {launches}")
    return res


def _stream_drive(sf, batches) -> list:
    """Each micro-batch through ``sf.process``, kernel counts set to 0
    just before and read just after: per micro-batch its wall, stages,
    warm and cold starts and launches."""
    import torch

    rows = []
    for i, b in enumerate(batches):
        w0, c0 = sf.stats.warm_starts, sf.stats.cold_starts
        torch.cuda.synchronize()
        _zero_counts()
        sf.process(b)
        torch.cuda.synchronize()
        rows.append({"batch": i, "rows": int(len(b)),
                     "wall_s": sf.stats.batch_seconds[-1],
                     "warm": sf.stats.warm_starts - w0,
                     "cold": sf.stats.cold_starts - c0,
                     "launches": _stream_counts(),
                     "stages_s": sf.stats.batch_stages[-1]})
        require(rows[-1]["launches"]["loss_grad"] > 0
                and rows[-1]["launches"]["fan"] > 0,
                f"a fleet micro-batch launched K3 and K4: {rows[-1]}")
    return rows


def _stream_forecast(sf, sids) -> tuple:
    """The deterministic 14-day forecast of every series (counts set to 0
    just before, read just after): yhat, per-series sMAPE, the wall and
    the launches."""
    import torch

    from tsspark_tpu_torch.eval import configs

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    yhat, sm = configs.config5_forecast(sf, sids)
    torch.cuda.synchronize()
    return yhat, sm, time.perf_counter() - t0, _stream_counts()


# K3 and K4 on a streaming chunk.  At its warm start a chunk's residual
# y - yhat is the noise, 0.5 on levels of 20 to 6e5: from 5e-4 down to
# 8e-7 of the scaled series, a few float32 ulps of yhat at the fleet's
# top.  There float32 cannot resolve the loss, and GAP_RULE, which counts
# the sums' terms and not the residual's cancellation, cannot hold for any
# two float32 orders: the plain float32 gradient is 0.11 of the rule's
# unit from float64 on config 5's 50 series and 15.3 on every 32nd of the
# fleet's first 8,192 (PERF.md §6).  Off the optimum as below, the plain
# float32 loss, gradient and fan are all within 0.005 of it on both.
# So the kernels are held by GAP_RULE on the
# chunk's own data with the warm start moved off its optimum
# (``off_optimum``), where residuals are of the data's own size, and one
# observed cell dropped from the kernel's input there (a planted fault)
# must fail the rule.  Their gap at the warm start itself is reported.
STREAM_THETA_SD = 0.05


def off_optimum(theta, seed: int) -> tuple:
    """The warm start moved off its optimum: every parameter moved by
    N(0, STREAM_THETA_SD) and the noise scale set to 0.05 of the series'
    scale (``random_theta``'s magnitudes); and a ray's direction for K4,
    N(0, 0.02) as phase fan's (the path's own direction, the
    preconditioned gradient, leads back to the optimum)."""
    import torch

    gen = torch.Generator(device=theta.device).manual_seed(seed)
    out = theta + STREAM_THETA_SD * torch.randn(
        theta.shape, generator=gen, device=theta.device)
    out[:, 2] = float(np.log(0.05))
    d = 0.02 * torch.randn(theta.shape, generator=gen, device=theta.device)
    return out.contiguous(), d


def stream_chunk(sf, batch, device, width=None, ids=None):
    """The refit chunk of ``batch``'s first ``width`` series (default the
    backend's chunk width), or of ``ids``, as the driver builds it: (ids,
    the warm start transferred from the store, the device data)."""
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.streaming.warmstart import transfer_theta

    cfg = sf.config
    if ids is None:
        ids = list(dict.fromkeys(batch.series_id.astype(str)))[
            :width or sf.backend.chunk_size]
    codes = sf._codes(ids)
    grid = sf._hist.union_grid(codes)
    y32 = sf._hist.materialize(codes, grid).astype(np.float32)
    data_np, meta = design.prepare_fit_data(grid, y32, cfg)
    packed, u8 = design.pack_fit_data(data_np, meta, grid,
                                      collapse_cap=True)
    data = design.unpack_fit_data(design.packed_to_device(packed, device),
                                  u8)
    old_theta, old_meta, _ = sf.store.lookup(ids)
    theta = transfer_theta(old_theta, old_meta, meta, cfg,
                           device=device).contiguous()
    return ids, theta, data


def hold_kernels(theta, d, data, cfg, what: str) -> dict:
    """K3 (both modes) and K4 (along ``d``) against their plain versions
    at ``theta`` on ``data``: by GAP_RULE (required), and with one
    observed cell a row dropped from the kernels' input (required to
    fail the rule)."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = data.t.shape
    f_k, g_k = lk.loss(theta, data, cfg)
    v_k, _ = lk.loss(theta, data, cfg, grad=False)
    f_p, g_p = lk.loss_plain(theta, data, cfg)
    ladder = _ladder(b, data.t.device)
    fan_got = fan_k.fan(theta, d, ladder, data, cfg)
    fan_want = fan_k.fan_plain(theta, d, ladder, data, cfg)
    fan_sc = fan_scale(theta, d, ladder, data, cfg)
    gaps = loss_gaps(theta, data, cfg, {"f": (f_k, f_p), "g": (g_k, g_p),
                                        "value": (v_k, f_p)})
    gaps["fan"] = _gap(fan_got, fan_want, fan_sc, t_len)

    mask = data.mask.clone()
    mask[torch.arange(b, device=mask.device), mask.argmax(-1)] = 0.0
    dropped = data._replace(mask=mask)
    planted = loss_gaps(theta, data, cfg, {
        "f": (lk.loss(theta, dropped, cfg, grad=False)[0], f_p)})
    planted["fan"] = _gap(fan_k.fan(theta, d, ladder, dropped, cfg),
                          fan_want, fan_sc, t_len)
    out = {"shape": [b, t_len, cfg.num_params], "gap": gaps,
           "tolerance": GAP_RULE,
           "max_abs_err": max(float((f_k - f_p).abs().max()),
                              float((g_k - g_p).abs().max()),
                              float((v_k - f_p).abs().max())),
           "fan_max_abs_err": float((fan_got - fan_want).abs().max()),
           "planted_dropped_cell": planted}
    require(within_gap_rule(gaps), f"K3/K4 on {what}: {out}")
    require(min(planted.values()) > GAP_TOL,
            f"a dropped cell passes GAP_RULE on {what}: {out}")
    return out


def hold_stream_kernels(theta_ws, data, cfg, seed: int) -> dict:
    """K3 (both modes) and K4 against their plain versions on a streaming
    chunk: by GAP_RULE off the optimum (required), the same with one
    observed cell a row dropped from the kernels' input (required to
    fail), and at the warm start (reported)."""
    from tsspark_tpu_torch.kernels import loss as lk

    theta, d = off_optimum(theta_ws, seed)
    out = hold_kernels(theta, d, data, cfg, "a streaming chunk")
    fw_k, gw_k = lk.loss(theta_ws, data, cfg)
    fw_p, gw_p = lk.loss_plain(theta_ws, data, cfg)
    out["warm_start_gap_reported"] = loss_gaps(theta_ws, data, cfg, {
        "f": (fw_k, fw_p), "g": (gw_k, gw_p)})
    return out


def stream_forward(sf, ids, device) -> tuple:
    """K1 against its plain version on the forecast's chunk of ``ids``:
    (readings, the chunk's inputs)."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import (
        prepare_predict_data,
    )

    cfg = sf.config
    theta, meta, _ = sf.store.lookup(ids)
    theta = theta.to(device)
    last = meta.ds_start + meta.ds_span
    fgrid = last[:, None] + sf.store.lookup_step(ids)[:, None] \
        * np.arange(1, 15)
    pdata = prepare_predict_data(fgrid, meta, cfg, device)
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32,
                            device=device)
    floor = torch.as_tensor(meta.floor, dtype=torch.float32, device=device)
    got = fk.forward(theta, pdata, cfg, scale, floor)
    want = fk.forward_plain(theta, pdata, cfg, scale, floor)
    err = _forward_err(got, want, scale)
    require(err <= 2e-5, f"forward on a streaming forecast chunk: {err}")
    return ({"shape": list(pdata.t.shape), "max_rel_err": err,
             "max_abs_err": max(float((g - w).abs().max())
                                for g, w in zip(got, want))},
            (theta, pdata, scale, floor))


def stream_kernels(sf, batch, device) -> dict:
    """K3 (both modes), K4, K1 and K2 at the fleet path's shapes, on its
    inputs, against their plain versions: the first 8,192 series of the
    last micro-batch's union grid (K3/K4, ``hold_stream_kernels``, and
    timed at the warm start), and the forecast's 8,192 x 14 chunk (K1; K2
    at S = 256 on given draws).  Also one warm chunk's solve under the
    profiler (the card's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.init import curvature_diag
    from tsspark_tpu_torch.models.prophet.model import _objective
    from tsspark_tpu_torch.ops import lbfgs

    cfg, solver = sf.config, sf.backend.solver_config
    ids, theta, data = stream_chunk(sf, batch, device)
    b, t_len = data.t.shape
    held = hold_stream_kernels(theta, data, cfg, seed=5)
    _, g_k = lk.loss(theta, data, cfg)
    precond = curvature_diag(data, cfg, theta)
    d = (-precond * g_k).contiguous()
    ladder = _ladder(b, device)
    out = {"loss": {**held,
                    "ms": cuda_ms(lambda: lk.loss(theta, data, cfg)),
                    "plain_ms": cuda_ms(lambda: lk.loss_plain(
                        theta, data, cfg), iters=3, warmup=1),
                    **loss_bound_ms(b, b, t_len, cfg, True),
                    "value_mode": {
                        "ms": cuda_ms(lambda: lk.loss(theta, data, cfg,
                                                      grad=False)),
                        **loss_bound_ms(b, b, t_len, cfg, False)}},
           "fan": {"shape": [20, b, t_len],
                   "gap": held["gap"]["fan"],
                   "max_abs_err": held["fan_max_abs_err"],
                   "ms": cuda_ms(lambda: fan_k.fan(theta, d, ladder, data,
                                                   cfg)),
                   "plain_ms": cuda_ms(lambda: fan_k.fan_plain(
                       theta, d, ladder, data, cfg), iters=3, warmup=1),
                   **fan_bound_ms(b, t_len, 20, cfg)}}

    # One warm chunk's solve under the profiler.
    fun, fval, fan = _objective(data, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res = lbfgs.minimize(fun, theta, solver, fun_value=fval,
                             precond=precond, fan_value=fan)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    out["warm_chunk_solve_profile"] = {
        "rows": b, "days": t_len, "iterations": int(res.n_iters.max()),
        "traced_wall_s": traced, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
        "top_device_ms": [(k[:60], ms) for k, ms in top[:6]]}

    # K1 and K2 on the forecast's chunk.
    k1, (theta_s, pdata, scale, floor) = stream_forward(sf, ids, device)
    out["forward"] = {**k1,
                      "ms": cuda_ms(lambda: fk.forward(theta_s, pdata, cfg,
                                                       scale, floor)),
                      "device_ms": device_ms(lambda: fk.forward(
                          theta_s, pdata, cfg, scale, floor)),
                      **forward_bound_ms(b, 14, cfg, True, True)}
    _, det, add, mult = fk.forward(theta_s, pdata, cfg)
    s = 256
    gen = torch.Generator(device=device).manual_seed(9)
    draws = bk.sample_draws((s,) + tuple(pdata.t.shape), gen, device)
    kargs = (theta_s, pdata, det, add, mult, scale, floor, cfg)
    got = bk.bands(*kargs, s, draws=draws)
    want = bk.bands_plain(*kargs, draws)
    k2_err = _band_err(got, want, scale)
    require(k2_err <= 1e-5, f"bands on the fleet's forecast chunk: {k2_err}")
    out["bands"] = {"shape": list(pdata.t.shape) + [s], "max_rel_err": k2_err,
                    "max_abs_err": max(float((got[k] - want[k]).abs().max())
                                       for k in want),
                    "ms": cuda_ms(lambda: bk.bands(*kargs, s, seed=1)),
                    **bands_bound_ms(b, 14, s, cfg)}
    return out


def _noise_gap(a, b) -> np.ndarray:
    """Per series, the largest |a - b| of two (n, 14) forecasts over the
    horizon, in units of config 5's noise."""
    return np.abs(np.asarray(a) - np.asarray(b)).max(-1) / NOISE5


def _noise_summary(d) -> dict:
    """Max, median and count over the limit of per-series noise units,
    and the max of each tenth of the series (levels rise with the
    series' index)."""
    return {"max": float(d.max()), "median": float(np.median(d)),
            "series_over_tol": int((d > FLEET_NOISE_TOL).sum()),
            "max_by_tenth": [float(x.max()) for x in np.array_split(d, 10)
                             if x.size]}


def phase_stream_fleet(device, frame, gen_s, parity) -> dict:
    """Config 5's generator and model at the M5 fleet's scale, on the
    first FLEET_CUT series and the subset's (``frame``, built in
    ``gen_s``): the warm run, a replay of its last micro-batch, the cold
    run, each micro-batch's wall, stages, starts
    and launches; the forecasts' sMAPE, one S = 256 forecast, the path's
    kernels against their plain versions, and the 64-series subset's
    forecasts against the same series streamed on the CPU plain path, in
    units of the noise (``FLEET_NOISE_TOL``, which the rolled fault on
    that subset must fail)."""
    import torch

    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.streaming.driver import StreamingForecaster

    t_phase = time.perf_counter()
    n_days = configs.config5_size(1.0)[1]
    batches = configs.config5_batches(frame, n_days)
    rows = fleet_rows()
    sids = [f"s{i}" for i in rows]
    torch.cuda.reset_peak_memory_stats()

    sf = StreamingForecaster(configs.CONFIG5, configs.SOLVER5, device=device)
    t0 = time.perf_counter()
    warm_rows = _stream_drive(sf, batches)
    warm_wall = time.perf_counter() - t0
    yh_warm, sm_warm, fc_s, fc_launch = _stream_forecast(sf, sids)
    n_warm, n_cold = sf.stats.warm_starts, sf.stats.cold_starts
    # One forecast with 256-sample bands (K2).
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    fcb = sf.forecast(sids, horizon=configs.HORIZON5, num_samples=256)
    torch.cuda.synchronize()
    bands = {"wall_s": time.perf_counter() - t0, "launches": _stream_counts()}
    lo, hi = fcb.yhat_lower.to_numpy(), fcb.yhat_upper.to_numpy()
    require(np.isfinite(lo).all() and np.isfinite(hi).all()
            and bool((lo <= hi).all()), "fleet bands finite and ordered")
    del fcb, lo, hi
    kern = stream_kernels(sf, batches[-1], device)

    replay_rows = _stream_drive(sf, batches[-1:])
    yh_replay, sm_replay, _, _ = _stream_forecast(sf, sids)
    replay_delta = abs(float(sm_replay.mean()) - float(sm_warm.mean()))

    pos = np.searchsorted(rows, fleet_subset())
    cold_sids, cold_batches = sids, batches
    sf_cold = StreamingForecaster(configs.CONFIG5, configs.SOLVER5,
                                  device=device, warm_start=False)
    t0 = time.perf_counter()
    cold_rows = _stream_drive(sf_cold, cold_batches)
    cold_wall = time.perf_counter() - t0
    yh_cold, sm_cold, _, _ = _stream_forecast(sf_cold, cold_sids)

    # The 64-series subset against the same series streamed alone on the
    # CPU plain path, and the rolled fault there against the sound run.
    plain = parity.get_stream("plain", "fleet")
    rolled = parity.get_stream("rolled", "fleet")
    noise = {"warm": _noise_gap(yh_warm[pos], plain["yhat_warm"]),
             "replay": _noise_gap(yh_replay[pos], plain["yhat_replay"]),
             "cold": _noise_gap(yh_cold[pos], plain["yhat_cold"])}
    replay_noise = _noise_gap(yh_replay, yh_warm)
    fault_noise = _noise_gap(rolled["yhat_warm"], plain["yhat_warm"])
    levels = configs.config5_truth(fleet_subset(), 0.0)
    res = {
        "phase": "stream_fleet", "series": len(sids), "days": n_days,
        "cut": f"the first {FLEET_CUT} of {FLEET_SERIES} series and the "
               "subset's (FLEET_CUT)",
        "frame_s": gen_s,
        "warm": {"wall_s": warm_wall, "micro_batches": warm_rows,
                 "warm_starts": n_warm, "cold_starts": n_cold,
                 "launches": _sum_counts(warm_rows),
                 "smape_mean": float(sm_warm.mean()),
                 "smape_max": float(sm_warm.max()),
                 "forecast": {"wall_s": fc_s, "launches": fc_launch},
                 "forecast_s256": bands},
        "replay": {"micro_batch": replay_rows[0],
                   "smape_mean": float(sm_replay.mean()),
                   "smape_delta": replay_delta,
                   "vs_warm_noise_units": _noise_summary(replay_noise)},
        "cold": {"series": len(cold_sids), "wall_s": cold_wall,
                 "micro_batches": cold_rows,
                 "warm_starts": sf_cold.stats.warm_starts,
                 "cold_starts": sf_cold.stats.cold_starts,
                 "smape_mean": float(sm_cold.mean())},
        "kernels": kern,
        "subset_vs_plain_cpu": {
            "subset": FLEET_SUBSET, "tolerance_noise_units": FLEET_NOISE_TOL,
            "noise_units": {k: _noise_summary(v) for k, v in noise.items()},
            "rolled_fault_noise_units": _noise_summary(fault_noise),
            "per_series": {"level": levels.tolist(),
                           **{k: v.tolist() for k, v in noise.items()},
                           "rolled": fault_noise.tolist()},
            "plain_cpu_s": plain["seconds"]},
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    require((n_warm, n_cold) == (3 * len(sids), len(sids)),
            f"fleet warm run starts: {n_warm}, {n_cold}")
    require(sf_cold.stats.warm_starts == 0
            and sf_cold.stats.cold_starts == 4 * len(cold_sids),
            "fleet cold run starts")
    require(all(np.isfinite(a).all() for a in (yh_warm, yh_replay,
                                                yh_cold)),
            "fleet forecasts finite")
    require(replay_delta < REPLAY_TOL, f"fleet replay: {replay_delta}")
    require(replay_noise.max() <= FLEET_NOISE_TOL,
            f"fleet replay per series: {_noise_summary(replay_noise)}")
    require(replay_rows[0]["warm"] == len(sids), "fleet replay warm")
    require(fc_launch["forward"] > 0, f"fleet forecast K1: {fc_launch}")
    require(bands["launches"]["bands"] > 0, f"fleet bands K2: {bands}")
    require(all(v.max() <= FLEET_NOISE_TOL for v in noise.values()),
            "fleet subset against the plain CPU run: "
            f"{res['subset_vs_plain_cpu']['noise_units']}")
    require(fault_noise.max() > FLEET_NOISE_TOL,
            f"fleet: the rolled fault passes the limit: {fault_noise.max()}")
    return res


# A second fleet cell with a retail fleet's conditioning (phase
# stream_fleet_m5): ``m5_like(30490, 730, seed=2, with_regressors=False)``
# as a long frame (the unobserved cells dropped: M5's onset pattern; its
# first FLEET_CUT series and the subset's run), day
# index as ``ds``, through config 5's model and schedule (a 510-day base
# batch, three 73-day micro-batches), the warm run only, then one
# deterministic 14-day forecast.  Here the residual at a warm start is
# M5's noise, level x N(0, 0.15): a few percent of the series' scale, so
# float32 resolves it (the plain float32 loss and gradient sit within
# 0.0013 of GAP_RULE's unit from float64 at the warm optimum on 256
# series, where config 5's fleet reads 15.3), and K3/K4 are held by
# GAP_RULE on every chunk of the last micro-batch at the warm optimum
# itself.  The 64-series subset's forecasts are held against the same
# series streamed on the CPU plain path per series in units of that
# series' noise (0.15 x its level) at M5_NOISE_TOL.  Readings (an H100,
# PERF.md §5): the card against the CPU plain path at most 0.246 noise
# units (median 0.046); on the CPU the 8-series subset of a 256-series
# run against the same series streamed alone, 0.284.  The limit sits 4x
# above the largest sound reading.  The rolled warm start (stream5's
# planted fault) is reported, not required to fail: on this cell 60
# iterations and the rescue pass heal it (0.409 noise units on the card's
# subset, 0.196 on the CPU's 8 series), so no forecast limit above the
# sound spread can see it.  What the limit must catch is a forecast
# served for the wrong series: the subset's forecasts taken one fleet
# row off, as an id->row index off by one would serve them
# ("row_off_by_one": up to 77 noise units, 62 of 64 series past the
# limit on the card).
M5_FLEET_DAYS = 730
M5_NOISE = 0.15
M5_NOISE_TOL = 1.0


def m5_fleet_frame(n: int = FLEET_SERIES):
    """The cell's long frame (series_id, ds = day index, y) and its ids."""
    import pandas as pd

    from tsspark_tpu_torch.data.datasets import m5_like

    b = m5_like(n, M5_FLEET_DAYS, seed=2, with_regressors=False)
    rows, days = np.nonzero(b.mask > 0)
    return pd.DataFrame({"series_id": b.series_ids[rows].astype(object),
                         "ds": days.astype(np.float64),
                         "y": b.y[rows, days]}), b.series_ids


def m5_noise_unit(n: int = FLEET_SERIES) -> np.ndarray:
    """Each series' noise sd in data units: ``m5_like``'s first draw is
    the series' level, and its noise is level x N(0, M5_NOISE)."""
    return M5_NOISE * np.random.default_rng(2).lognormal(1.0, 1.0, n)


def m5_forecast(sf, ids) -> np.ndarray:
    """The deterministic 14-day forecast of ``ids``: yhat (n, 14)."""
    from tsspark_tpu_torch.eval import configs

    fc = sf.forecast(ids, horizon=configs.HORIZON5, num_samples=0)
    return fc.yhat.to_numpy().reshape(len(ids), configs.HORIZON5)


def stream_m5_job(kind: str, df) -> dict:
    """The warm run of config 5's schedule over the M5 subset ``df`` on
    the CPU plain path in a ``ParityFits`` worker, sound ("plain") or with
    the rolled fault: the forecast's yhat."""
    import torch

    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.streaming import driver
    from tsspark_tpu_torch.streaming.source import InMemorySource

    torch.set_num_threads(PARITY_THREADS)
    t0 = time.perf_counter()
    ids = list(dict.fromkeys(df.series_id.astype(str)))
    sound = driver.transfer_theta
    if kind != "plain":
        driver.transfer_theta = planted_transfer(kind)
    try:
        sf = driver.StreamingForecaster(configs.CONFIG5, configs.SOLVER5,
                                        device="cpu")
        sf.run(InMemorySource(configs.config5_batches(df, M5_FLEET_DAYS)))
        yhat = m5_forecast(sf, ids)
    finally:
        driver.transfer_theta = sound
    return {"yhat_warm": yhat, "seconds": time.perf_counter() - t0}


def phase_stream_fleet_m5(device, frame, ids, gen_s, parity) -> dict:
    """The M5-conditioned fleet cell: the warm run of config 5's schedule
    over ``frame`` (each micro-batch's wall, stages, starts and launches),
    one deterministic forecast (K1), K3/K4 on every chunk of the last
    micro-batch at the warm optimum by GAP_RULE, and the 64-series
    subset's forecasts against the CPU plain path in noise units."""
    import torch

    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.streaming.driver import StreamingForecaster

    t_phase = time.perf_counter()
    batches = configs.config5_batches(frame, M5_FLEET_DAYS)
    ids = [str(s) for s in ids]
    torch.cuda.reset_peak_memory_stats()
    sf = StreamingForecaster(configs.CONFIG5, configs.SOLVER5, device=device)
    t0 = time.perf_counter()
    warm_rows = _stream_drive(sf, batches)
    warm_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    yhat = m5_forecast(sf, ids)
    torch.cuda.synchronize()
    fc = {"wall_s": time.perf_counter() - t0, "launches": _stream_counts()}

    # K3/K4 at the warm optimum on each 8,192-row chunk of the last
    # micro-batch (every series has rows there).
    cfg = sf.config
    last = list(dict.fromkeys(batches[-1].series_id.astype(str)))
    width = sf.backend.chunk_size
    gen = torch.Generator(device=device).manual_seed(11)
    chunks = []
    for lo in range(0, len(last), width):
        _, theta, data = stream_chunk(sf, batches[-1], device,
                                      ids=last[lo:lo + width])
        d = 0.02 * torch.randn(theta.shape, generator=gen, device=device)
        held = hold_kernels(theta, d, data, cfg,
                            f"the M5 fleet's chunk at row {lo} at its "
                            "warm optimum")
        if lo == 0:
            b, t_len = data.t.shape
            held.update(
                ms=cuda_ms(lambda: lk.loss(theta, data, cfg)),
                plain_ms=cuda_ms(lambda: lk.loss_plain(theta, data, cfg),
                                 iters=3, warmup=1),
                **loss_bound_ms(b, b, t_len, cfg, True))
        chunks.append(held)
        del theta, data

    noise = m5_noise_unit()[fleet_subset()]
    plain = parity.get_stream("plain", "m5")
    rolled = parity.get_stream("rolled", "m5")
    idx = np.searchsorted(fleet_rows(), fleet_subset())  # rows of ``ids``
    sound = np.abs(yhat[idx] - plain["yhat_warm"]).max(-1) / noise
    warm_fault = np.abs(rolled["yhat_warm"]
                        - plain["yhat_warm"]).max(-1) / noise
    off = np.minimum(idx + 1, len(ids) - 1)
    off[off == idx] = idx[off == idx] - 1
    fault = np.abs(yhat[off] - plain["yhat_warm"]).max(-1) / noise
    summary = lambda d: {  # noqa: E731
        "max": float(d.max()), "median": float(np.median(d)),
        "series_over_tol": int((d > M5_NOISE_TOL).sum())}
    res = {
        "phase": "stream_fleet_m5", "series": len(ids),
        "cut": f"the first {FLEET_CUT} of {FLEET_SERIES} series and the "
               "subset's (FLEET_CUT)",
        "days": M5_FLEET_DAYS, "rows": int(len(frame)), "frame_s": gen_s,
        "warm": {"wall_s": warm_wall, "micro_batches": warm_rows,
                 "warm_starts": sf.stats.warm_starts,
                 "cold_starts": sf.stats.cold_starts,
                 "launches": _sum_counts(warm_rows)},
        "forecast": fc,
        "kernels_at_warm_optimum": {
            "tolerance": GAP_RULE, "chunks": len(chunks),
            "gap_max": {k: max(c["gap"][k] for c in chunks)
                        for k in chunks[0]["gap"]},
            "planted_dropped_cell_min": {
                k: min(c["planted_dropped_cell"][k] for c in chunks)
                for k in chunks[0]["planted_dropped_cell"]},
            "first_chunk": chunks[0]},
        "subset_vs_plain_cpu": {
            "subset": FLEET_SUBSET, "noise_unit": "0.15 x the level",
            "tolerance_noise_units": M5_NOISE_TOL,
            "sound": summary(sound),
            "row_off_by_one_fault": summary(fault),
            "rolled_warm_start_fault_reported": summary(warm_fault),
            "per_series": {"sound": sound.tolist(),
                           "row_off_by_one": fault.tolist(),
                           "rolled_warm_start": warm_fault.tolist()},
            "plain_cpu_s": plain["seconds"]},
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    require(np.isfinite(yhat).all(), "M5 fleet forecast finite")
    require(fc["launches"]["forward"] > 0, f"M5 fleet forecast K1: {fc}")
    require(sound.max() <= M5_NOISE_TOL,
            f"M5 fleet subset against the plain CPU run: {summary(sound)}")
    require(fault.max() > M5_NOISE_TOL,
            "M5 fleet: a forecast one row off passes the limit: "
            f"{summary(fault)}")
    return res


# The full-posterior path: config 3's batch through fit_mcmc with the
# default sampler (300 warmup and 300 kept transitions of 24 leapfrog
# steps), then predict_mcmc over every day.  Its sampler is held in
# distribution against the same sampler driven by the plain loss on a
# subset of MCMC_SUBSET series: per (series, parameter), z = |mean_1 -
# mean_2| / sqrt(var_1/ESS_1 + var_2/ESS_2) from two chains of other
# seeds is a standard normal's absolute value when both sample one
# posterior, so more than Z_FRAC of z past Z_LIMIT (a standard normal puts
# 6e-5 there) or a median past Z_MEDIAN (its median is 0.674) is a fault.
MCMC_SUBSET = 64
RHAT_BLOCKS = 8       # 128-row blocks of the batch the card's R-hat is held on
RHAT_TOL = 1e-9       # |card - numpy| / max(|numpy|, 1), float64
Z_LIMIT, Z_FRAC, Z_MEDIAN = 4.0, 0.01, 1.0
DRAWS_TOL = 1e-5


def z_scores(a, b) -> np.ndarray:
    """Per (series, parameter) z of two (S, B, P) draw sets (see
    MCMC_SUBSET), ESS from ``hmc.split_rhat_ess``."""
    from tsspark_tpu_torch.ops import hmc

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    se2 = (a.var(0, ddof=1) / hmc.split_rhat_ess(a)[1]
           + b.var(0, ddof=1) / hmc.split_rhat_ess(b)[1])
    return np.abs(a.mean(0) - b.mean(0)) / np.sqrt(np.maximum(se2, 1e-30))


def plain_logdensity(data, cfg, example):
    """``model.mcmc_logdensity`` on K3's plain version (torch ops on the
    card's tensors) for parameters shaped as ``example``, replayed from a
    CUDA graph: its ~400 small launches a call captured once, so the
    reference sampler's 14,401 calls take seconds, not minutes.  Each call
    copies its argument into the graph's input and returns copies of its
    outputs; the arithmetic is the plain version's own kernels."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    def logdensity(th):
        f, g = lk.loss_plain(th, data, cfg)
        lp = -f + th[:, 2]
        grad = -g
        grad[:, 2] += 1.0
        return lp, grad

    static_in = example.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            logdensity(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = logdensity(static_in)

    def replay(th):
        static_in.copy_(th)
        graph.replay()
        return tuple(o.clone() for o in static_out)

    return replay


def draws_bound_ms(b, t_len, s, config) -> dict:
    """Least time for the posterior-draws function over (B, T) with S
    draws: the draws, the per-row inputs and the eight (B, T) outputs
    moved once; per sample-cell ~4F + 36 float32 operations (the feature
    totals' two multiply-adds a feature, the trend, the deterministic
    yhat, a simulated path step, the noise, the four means' adds and the
    two selections' O(1) share; ~4F + 46 under logistic growth), one
    Philox4x32-10 draw (40 integer multiplies) and four transcendentals
    (six under logistic growth: two sigmoids).  The units run side by
    side, so the least time is the largest of the four."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f = fs + r
    logistic = config.growth == "logistic"
    floats = (s * b * config.num_params + (1 + r + logistic) * b * t_len
              + t_len * fs + b * ncp + b * (s + 3) + 8 * b * t_len)
    cells = b * t_len * s
    times = {
        "bytes": 4 * floats / PEAK_BYTES_PER_S * 1e3,
        "float32": cells * (4 * f + (46 if logistic else 36))
        / PEAK_F32_PER_S * 1e3,
        "integer_multiplies": cells * 40 / PEAK_INT32_MUL_PER_S * 1e3,
        "transcendentals": cells * (6 if logistic else 4)
        / PEAK_SFU_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return {"bound_ms": times[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_parts_ms": times}


def _draw_case(rng, growth, b, t_len, s, per_series, device,
               features="mixed"):
    """Small K6 inputs: a config of every feature kind (``features``
    "mixed": 12 seasonal columns and 2 regressors; "none": no feature;
    "wide": 36 seasonal columns and 2 regressors, past 32), draws around
    a fitted-like point, synthetic data with a future (t up to 1.2), data
    scales and given variates."""
    import torch

    from tsspark_tpu_torch.config import (
        ProphetConfig,
        RegressorConfig,
        SeasonalityConfig,
    )
    from tsspark_tpu_torch.kernels import bands as bk

    weekly = SeasonalityConfig("weekly", 7.0, 3, mode="multiplicative")
    regs = (RegressorConfig("r0"),
            RegressorConfig("r1", mode="multiplicative"))
    seas, regs = {
        "mixed": ((SeasonalityConfig("yearly", 365.25, 3), weekly), regs),
        "none": ((), ()),
        "wide": ((SeasonalityConfig("yearly", 365.25, 15), weekly), regs),
    }[features]
    cfg = ProphetConfig(growth=growth, n_changepoints=10,
                        seasonalities=seas, regressors=regs)
    make = logistic_theta if growth == "logistic" else random_theta
    base = make(rng, b, cfg)
    samples = torch.from_numpy(
        (base[None] + 0.02 * rng.normal(0.0, 1.0, (s,) + base.shape))
        .astype(np.float32)).to(device)
    data = synthetic_data(rng, cfg, b, t_len, per_series, device)
    sc = torch.from_numpy(rng.uniform(1.0, 50.0, b).astype(np.float32))
    fl = torch.from_numpy(rng.uniform(0.0, 5.0, b).astype(np.float32))
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1_000_000)))
    variates = bk.sample_draws((s, b, t_len), gen, device)
    return cfg, samples, data, sc.to(device), fl.to(device), variates


def _draws_vs_plain(cfg, samples, data, sc, fl, variates) -> tuple:
    """(max |k - p| / (y_scale + |p|), max |k - p|, plain seconds) of K6
    against its plain version on the same given variates."""
    import torch

    from tsspark_tpu_torch.kernels import draws as dk

    got = dk.draws(samples, data, sc, fl, cfg, variates=variates)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dk.draws_plain(samples, data, sc, fl, cfg, variates)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for k, v in got.items():
        require(bool(torch.isfinite(v).all()), f"draws {k} finite")
    return (_band_err(got, want, sc),
            max(float((got[k] - want[k]).abs().max()) for k in want),
            plain_s)


# K6's small shapes: (growth, S, per-series features, feature set).
DRAW_CASES = (("linear", 128, False, "mixed"), ("linear", 1024, True, "mixed"),
              ("flat", 128, False, "mixed"), ("logistic", 64, False, "mixed"),
              ("linear", 300, False, "mixed"), ("logistic", 300, True, "mixed"),
              ("linear", 1, False, "mixed"), ("linear", 128, False, "none"),
              ("linear", 300, False, "wide"), ("linear", 1024, False, "wide"))


def draws_small_cases(device) -> dict:
    """K6 against its plain version on given draws at ``DRAW_CASES``, and
    each case's rows bitwise invariant on its own Philox draws."""
    rng = np.random.default_rng(17)
    small = {}
    for growth, s, per_series, features in DRAW_CASES:
        cfg, samples, data, sc, fl, variates = _draw_case(
            rng, growth, 48, 160, s, per_series, device, features)
        err, abs_err, _ = _draws_vs_plain(cfg, samples, data, sc, fl,
                                          variates)
        name = (f"{growth}_S{s}{'_per_series' if per_series else ''}"
                f"_F{cfg.num_features}")
        small[name] = {"max_rel_err": err, "max_abs_err": abs_err,
                       "rows_bitwise": draws_row_invariance(
                           samples, data, sc, fl, cfg, device)["bitwise"]}
        require(err <= DRAWS_TOL, f"draws {name}: {err}")
    return small


def draws_row_invariance(samples, data, sc, fl, cfg, device) -> dict:
    """K6 with its own Philox draws gives a row the same bits wherever it
    sits, the row keeping its Philox coordinate: a slice launched alone,
    and the batch permuted."""
    import torch

    from tsspark_tpu_torch.kernels import draws as dk

    b = samples.shape[1]
    full = dk.draws(samples, data, sc, fl, cfg, seed=31)
    ids = torch.arange(b, dtype=torch.int32, device=device)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(3))
    perm = perm.to(device)
    lo, hi = b // 8, b // 8 + max(1, b // 4)
    for name, idx in (("slice", slice(lo, hi)), ("permuted", perm)):
        got = dk.draws(samples[:, idx].contiguous(), _rows(data, idx),
                       sc[idx].contiguous(), fl[idx].contiguous(), cfg,
                       seed=31, rows=ids[idx].contiguous())
        require(all(torch.equal(got[k], full[k][idx]) for k in full),
                f"draws: a {name} batch differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [lo, hi], "permuted": b}


def nonfinite_agreement(theta, data, cfg) -> dict:
    """K3 gives a non-finite loss exactly where its plain version does, at
    points the sampler's trajectories can reach and the line search never
    priced: log_sigma at +-60, k or a changepoint's delta at 1e20, m NaN;
    each a stack of the batch's rows (a trial stack: row i on data row
    i % B)."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b = theta.shape[0]
    ncp = cfg.n_changepoints
    parts = [theta.clone() for _ in range(6)]
    parts[1][:, 2] = 60.0
    parts[2][:, 2] = -60.0
    parts[3][:, 0] = 1e20
    parts[4][:, 1] = float("nan")
    parts[5][:, 3 + ncp // 2] = 1e20
    stack = torch.cat(parts).contiguous()
    f_k, g_k = lk.loss(stack, data, cfg)
    f_p, g_p = lk.loss_plain(stack, data, cfg)
    fin_k, fin_p = torch.isfinite(f_k), torch.isfinite(f_p)
    gfin_k = torch.isfinite(g_k).all(1)
    gfin_p = torch.isfinite(g_p).all(1)
    out = {"rows": int(stack.shape[0]),
           "f_nonfinite": [int((~fin_k[i * b:(i + 1) * b]).sum())
                           for i in range(6)],
           "f_masks_equal": bool(torch.equal(fin_k, fin_p)),
           "g_nonfinite_rows": [int((~gfin_k).sum()), int((~gfin_p).sum())],
           "g_masks_equal": bool(torch.equal(gfin_k, gfin_p))}
    require(out["f_masks_equal"],
            f"K3 and its plain version disagree on where f is finite: {out}")
    return out


def phase_mcmc(fit, device) -> dict:
    """Config 3's batch (``phase_fit``'s) through ``ProphetModel.fit_mcmc``
    with ``McmcConfig()`` on its first 1,746 days, then ``predict_mcmc``
    over all 1,941 through K6; the sampler held in distribution against
    the plain loss's, K3 against its plain version where the loss is not
    finite, K6 against its plain version on given draws (small shapes of
    the three growths, and the path's first chunk) and for bitwise row
    invariance; one short full-width sample under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.config import McmcConfig
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import draws as dk
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.model import (
        ProphetModel,
        mcmc_core,
    )
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data
    from tsspark_tpu_torch.ops import hmc

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    batch = fit["inputs"]["batch"]
    n_ser, n_days = batch.y.shape
    split = configs.split_point(n_days)
    ds_fit = batch.ds[:split]
    y_fit = np.nan_to_num(batch.y[:, :split])
    m_fit = batch.mask[:, :split]
    r_fit = batch.regressors[:, :split]
    mcfg = McmcConfig()
    model = ProphetModel(cfg, solver, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hmc.timing.reset()
    # The main path: counts to 0 just before, read just after.
    lk.launches = lk.grad_launches = fan_k.launches = fk.launches = 0
    bands_k.launches = dk.launches = 0
    t0 = time.perf_counter()
    state = model.fit_mcmc(ds_fit, y_fit, mask=m_fit, regressors=r_fit,
                           mcmc_config=mcfg, seed=0)
    fit_s = time.perf_counter() - t0
    fit_stages = dict(model.stages.seconds)
    model.stages.reset()
    t0 = time.perf_counter()
    fc = model.predict_mcmc(state, batch.ds, regressors=batch.regressors,
                            seed=0)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                "loss_value": lk.launches - lk.grad_launches,
                "fan": fan_k.launches, "forward": fk.launches,
                "bands": bands_k.launches, "draws": dk.launches}
    leapfrogs, host_s = hmc.timing.leapfrogs, hmc.timing.host_s
    peak = torch.cuda.max_memory_allocated()

    n_s = mcfg.num_samples
    hmc_grad = 1 + (mcfg.num_warmup + n_s) * mcfg.num_leapfrog
    require(launches["loss_grad"] >= hmc_grad and launches["fan"] > 0
            and launches["draws"] == -(-n_ser // dk.CHUNK_ROWS),
            f"kernels launched on the MCMC path: {launches}")
    require(tuple(state.samples.shape) == (n_s, n_ser, cfg.num_params),
            "draws shape")
    require(bool(torch.isfinite(state.samples).all()), "draws finite")
    require(state.rhat.shape == state.ess.shape == (n_ser, cfg.num_params)
            and np.isfinite(state.rhat).all() and np.isfinite(state.ess).all(),
            "split-R-hat and ESS finite, one a (series, parameter)")
    # The card's split-R-hat and ESS against the host's numpy version on
    # the rows of RHAT_ROWS blocks spread over the batch: float64 tolerance.
    rhat_rows = np.concatenate([np.arange(lo, min(lo + 128, n_ser))
                                for lo in np.linspace(0, n_ser - 1,
                                                      RHAT_BLOCKS,
                                                      dtype=np.int64)])
    host = hmc.split_rhat_ess(state.samples[:, rhat_rows].cpu().numpy())
    rhat_err = [float(np.max(np.abs(c[rhat_rows] - h) / np.maximum(
        np.abs(h), 1.0))) for c, h in zip((state.rhat, state.ess), host)]
    require(max(rhat_err) <= RHAT_TOL,
            f"split-R-hat / ESS on the card against numpy: {rhat_err}")
    for k in dk.OUTPUTS:
        require(tuple(fc[k].shape) == (n_ser, n_days), f"forecast {k} shape")
        require(bool(torch.isfinite(fc[k]).all()), f"forecast {k} finite")
    require(ordered(fc["yhat_lower"], fc["yhat_upper"], False),
            "yhat_lower <= yhat_upper")
    require(ordered(fc["trend_lower"], fc["trend_upper"], True),
            "trend_lower <= trend_upper")
    fc_np = {k: v.cpu().numpy() for k, v in fc.items()}
    sc = configs.score(batch, fc_np)
    y_hold = batch.y[:, split:]
    m_hold = batch.mask[:, split:] > 0
    inside = ((y_hold >= fc_np["yhat_lower"][:, split:])
              & (y_hold <= fc_np["yhat_upper"][:, split:]))
    acc = state.accept_rate
    out = {
        "phase": "mcmc", "series": n_ser, "days_fit": split,
        "days_forecast": n_days, "params": cfg.num_params,
        "mcmc_config": {"num_warmup": mcfg.num_warmup, "num_samples": n_s,
                        "num_leapfrog": mcfg.num_leapfrog},
        "fit_mcmc_s": fit_s, "predict_mcmc_s": predict_s,
        "stages_s": fit_stages,
        "predict_stages_s": dict(model.stages.seconds),
        "launches": launches, "loss_grad_in_hmc": hmc_grad,
        "leapfrogs": leapfrogs,
        "hmc_wall_ms_per_leapfrog": 1e3 * host_s / max(leapfrogs, 1),
        "accept_rate": {"mean": float(acc.mean()), "min": float(acc.min()),
                        "p01": float(np.quantile(acc, 0.01)),
                        "median": float(np.median(acc))},
        "divergences": {"total": int(state.divergences.sum()),
                        "chains_with_any": int((state.divergences > 0).sum())},
        "step_size_median": float(np.median(state.step_size)),
        "rhat_max": float(state.rhat.max()),
        "rhat_over_1.1_frac": float((state.rhat > 1.1).mean()),
        "rhat_ess_vs_numpy": {"rows": int(len(rhat_rows)),
                              "rhat_rel_err": rhat_err[0],
                              "ess_rel_err": rhat_err[1],
                              "tolerance": RHAT_TOL},
        "ess_min": float(state.ess.min()),
        "ess_median": float(np.median(state.ess)),
        "smape_train": float(sc["smape_train"].mean()),
        "smape_holdout": float(sc["smape_holdout"].mean()),
        "holdout_coverage_80": float(inside[m_hold].mean()),
        "peak_device_bytes": peak,
    }
    emit(out)

    # The sampler in distribution: K3's chains against the plain loss's on
    # a subset, each from the MAP point with its own seed.
    idx = np.linspace(0, n_ser - 1, MCMC_SUBSET).astype(np.int64)
    data_np, _ = design.prepare_fit_data(ds_fit, y_fit[idx], cfg,
                                         mask=m_fit[idx],
                                         regressors=r_fit[idx])
    sub = design.fitdata_to_device(data_np, device)
    theta_map = state.map_state.theta[idx].to(device).contiguous()
    nonfinite = nonfinite_agreement(theta_map, sub, cfg)
    hmc.timing.reset()
    t0 = time.perf_counter()
    res_k = mcmc_core(sub, theta_map, torch.Generator(device=device)
                      .manual_seed(1), cfg, mcfg)
    torch.cuda.synchronize()
    k3_s = time.perf_counter() - t0
    sub_ms_leapfrog = 1e3 * hmc.timing.host_s / max(hmc.timing.leapfrogs, 1)
    gen = torch.Generator(device=device).manual_seed(2)
    theta0 = theta_map + mcfg.init_jitter * torch.randn(
        theta_map.shape, generator=gen, device=device)
    t0 = time.perf_counter()
    res_p = hmc.sample(plain_logdensity(sub, cfg, theta0), theta0, gen, mcfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    draws_k = res_k.samples.cpu().numpy()
    draws_p = res_p.samples.cpu().numpy()
    z = z_scores(draws_k, draws_p)
    rhat_k = hmc.split_rhat_ess(draws_k)[0]
    rhat_p = hmc.split_rhat_ess(draws_p)[0]
    over = z > Z_LIMIT
    sampler = {
        "subset": MCMC_SUBSET, "k3_s": k3_s, "plain_s": plain_s,
        "host_ms_per_leapfrog_k3": sub_ms_leapfrog,
        "z_median": float(np.median(z)), "z_max": float(z.max()),
        "z_over_limit_frac": float((z > Z_LIMIT).mean()),
        "limits": {"z": Z_LIMIT, "frac": Z_FRAC, "median": Z_MEDIAN},
        # Where z passes its limit: the series (subset rows) and how many
        # of their parameters, and the two chains' split-R-hat there.
        "z_over_limit_rows": {int(r): int(n) for r, n in zip(
            *np.unique(np.nonzero(over)[0], return_counts=True))},
        "rhat_max_where_over": [float(rhat_k[over].max(initial=0.0)),
                                float(rhat_p[over].max(initial=0.0))],
        "rhat_over_1.1_frac": [float((rhat_k > 1.1).mean()),
                               float((rhat_p > 1.1).mean())],
        "accept_mean": [float(res_k.accept_rate.mean()),
                        float(res_p.accept_rate.mean())],
        "divergences": [int(res_k.divergences.sum()),
                        int(res_p.divergences.sum())],
        "k3_nonfinite": nonfinite,
    }
    emit({"phase": "mcmc_sampler", **sampler})
    require(sampler["z_over_limit_frac"] <= Z_FRAC
            and sampler["z_median"] < Z_MEDIAN,
            f"K3's sampler against the plain loss's: {sampler}")
    del res_k, res_p, sub

    # K6 against its plain version on given draws: small shapes (both
    # thread caps, one draw, no feature and more than 32, a coefficient
    # table too large for shared memory at S = 1,024), then the path's
    # first chunk of rows; its rows bitwise invariant.
    small = draws_small_cases(device)
    rows = min(dk.CHUNK_ROWS, n_ser)
    meta_c = state.meta._replace(**{
        f: np.asarray(v)[:rows] for f, v in state.meta._asdict().items()})
    pdata = prepare_predict_data(batch.ds, meta_c, cfg, device,
                                 regressors=batch.regressors[:rows])
    samples_c = state.samples[:, :rows].contiguous()
    sc_c = torch.as_tensor(meta_c.y_scale, dtype=torch.float32,
                           device=device)
    fl_c = torch.as_tensor(meta_c.floor, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(23)
    variates = bands_k.sample_draws((n_s, rows, n_days), gen, device)
    err, abs_err, plain_chunk_s = _draws_vs_plain(cfg, samples_c, pdata,
                                                  sc_c, fl_c, variates)
    require(err <= DRAWS_TOL, f"draws at the path's chunk: {err}")
    del variates
    k6 = {"name": "draws", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/draws.cu",
          "replaces": "tsspark_tpu/models/prophet/predict.py:209",
          "launches": launches["draws"],
          "max_abs_err": abs_err, "max_rel_err": err,
          "tolerance": f"|k-p|/(y_scale+|p|) <= {DRAWS_TOL} (given draws)",
          "ms": cuda_ms(lambda: dk.draws(samples_c, pdata, sc_c, fl_c, cfg,
                                         seed=1), iters=10),
          "plain_ms": 1e3 * plain_chunk_s,
          "plain_ms_note": "the plain version on given draws, one call",
          **draws_bound_ms(rows, n_days, n_s, cfg),
          # No single PyTorch call computes the posterior predictive; the
          # quantiles alone (torch.quantile) refuse the chunk's 3e8
          # samples (past 2**24).
          "library_ms": None, "shape": [rows, n_days, n_s],
          "small_shapes": small,
          "row_invariance": draws_row_invariance(samples_c, pdata, sc_c,
                                                 fl_c, cfg, device),
          "whole_batch": {"shape": [n_ser, n_days, n_s],
                          **draws_bound_ms(n_ser, n_days, n_s, cfg)}}
    del pdata, samples_c

    # Where a full-width sampler's time goes: eight transitions from the
    # MAP point under the profiler.
    data_np, _ = design.prepare_fit_data(ds_fit, y_fit, cfg, mask=m_fit,
                                         regressors=r_fit)
    data = design.fitdata_to_device(data_np, device)
    del data_np
    theta_map = state.map_state.theta.to(device).contiguous()
    short = McmcConfig(num_warmup=4, num_samples=4)
    gen = torch.Generator(device=device).manual_seed(3)
    torch.cuda.synchronize()
    hmc.timing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        mcmc_core(data, theta_map, gen, cfg, short)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    profile_out = {
        "phase": "mcmc_profile", "rows": n_ser,
        "leapfrogs": hmc.timing.leapfrogs, "traced_wall_s": traced,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
        "wall_ms_per_leapfrog": 1e3 * traced / max(hmc.timing.leapfrogs, 1),
        "top_device_ms": [(k[:60], ms) for k, ms in top[:6]],
    }
    emit(profile_out)
    k6["sampler"] = {"profile": profile_out, "subset": sampler}
    return {"out": out, "kernel": k6}


def _device_events(prof):
    """(name, device ms) of the events that ran ON the card — kernels and
    copies — in a profile, longest first.  Host ops carry their children's
    device time too, so only device-side events are summed."""
    from torch.autograd import DeviceType

    evs = [(ev.key, ev.self_device_time_total / 1e3)
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    return sorted(evs, key=lambda kv: -kv[1])


def phase_profile(root: str, ids, device) -> dict:
    """Where a full-width request's time goes, on a fresh engine with no
    cache (every request dispatches): each request once under the torch
    profiler for the device's busy time, and once without it for the
    wall time and the host stages, read from the engine's and the
    backend's own stage clocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
    )

    engine = PredictionEngine(ParamRegistry.open(root),
                              cache=ForecastCache(0), device=device)
    engine.forecast(ids[:64], HORIZON)  # load the snapshot, warm up
    out = {"phase": "profile"}
    for name, n_s in (("a: all series, deterministic", 0),
                      ("c: all series, 256 samples", 256)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.forecast(ids, HORIZON, num_samples=n_s, seed=1,
                            timeout_s=600.0)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        top = _device_events(prof)
        dev_ms = sum(ms for _, ms in top)
        engine.stats.stages.reset()
        engine.backend.stages.reset()
        t0 = time.perf_counter()
        engine.forecast(ids, HORIZON, num_samples=n_s, seed=1,
                        timeout_s=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {
            "wall_s": wall, "traced_wall_s": traced_wall,
            "device_busy_ms": dev_ms,
            "device_idle_share": 1.0 - dev_ms / 1e3 / traced_wall,
            "top_device_ms": [(k[:60], ms) for k, ms in top[:5]],
            "engine_stages_s": dict(engine.stats.stages.seconds),
            "backend_stages_s": dict(engine.backend.stages.seconds),
            "backend_stage_calls": dict(engine.backend.stages.calls),
        }
    return out


def _forward_err(got, want, scale) -> float:
    """K1's rule on data-unit outputs: |k - p| / (y_scale + |p|) for
    yhat, trend and additive, |k - p| / (1 + |p|) for multiplicative."""
    units = (scale[:, None],) * 3 + (1.0,)
    return max(float(((g - w).abs() / (u + w.abs())).max())
               for g, w, u in zip(got, want, units))


def logistic_kernels(fit4, fit, device) -> list:
    """K3's, K1's and K2's logistic branches at the config-4 path's
    shapes, on its inputs: K3 (gradient and value modes) at 8192x1080 at
    the ridge init and at the fitted parameters; K3's trial-stack layout
    on a line search's 21 x 8192 trial stack (and on one of flat growth
    over config 3's first chunk, ``fit``'s); K1 and K2 on the forecast of
    the fitted batch over 1,200 days, at the forecast's chunk of rows (K2
    with 256 samples) and over the whole batch.  Each against its plain
    version, timed, its rows bitwise invariant."""
    import dataclasses

    import torch

    from tsspark_tpu_torch.eval.configs import SOLVER3
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    inp = fit4["inputs"]
    data, cfg = inp["data"], inp["cfg"]
    b, t_len = data.t.shape
    launches = fit4["out"]["launches"]
    gaps, abs_err = {}, 0.0
    for where in ("theta0", "theta_fit"):
        theta = inp[where]
        f_k, g_k = lk.loss(theta, data, cfg)
        v_k, _ = lk.loss(theta, data, cfg, grad=False)
        f_p, g_p = lk.loss_plain(theta, data, cfg)
        gaps[where] = loss_gaps(theta, data, cfg, {
            "f": (f_k, f_p), "g": (g_k, g_p), "value_mode": (v_k, f_p)})
        abs_err = max(abs_err, float((f_k - f_p).abs().max()),
                      float((v_k - f_p).abs().max()),
                      float((g_k - g_p).abs().max()))
        require(within_gap_rule(gaps[where]),
                f"logistic loss at {b}x{t_len} ({where}): {gaps[where]}")
    stack = {"config4": trial_stack(inp["trials"], data, cfg)}
    theta = inp["theta0"]
    k3 = {"name": "loss_logistic", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/loss.cu",
          "replaces": "tsspark_tpu/models/prophet/trend.py:97",
          "launches": launches["loss"],
          "launches_grad": launches["loss_grad"],
          "launches_value": launches["loss_value"],
          "max_abs_err": abs_err,
          "gap": gaps, "tolerance": GAP_RULE,
          "ms": cuda_ms(lambda: lk.loss(theta, data, cfg)),
          "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg),
                              iters=3, warmup=1),
          **loss_bound_ms(b, b, t_len, cfg, True),
          "library_ms": None, "shape": [b, t_len, cfg.num_params],
          "value_mode": {
              "ms": cuda_ms(lambda: lk.loss(theta, data, cfg, grad=False)),
              "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg,
                                                        grad=False),
                                  iters=3, warmup=1),
              **loss_bound_ms(b, b, t_len, cfg, False)},
          "row_invariance": loss_row_invariance(data, cfg, theta, device)}
    # Flat growth's stack: config 3's first chunk, the same line search
    # around its ridge init under flat growth.
    finp = fit["inputs"]
    fcfg = dataclasses.replace(finp["cfg"], growth="flat")
    stack["flat_config3"] = trial_stack(
        line_search_stack(finp["data"], fcfg, SOLVER3, device),
        finp["data"], fcfg)
    k3s = {"name": "loss_stack", "route": "cuda",
           "source": "tsspark_tpu_torch/csrc/loss.cu",
           "replaces": "tsspark_tpu/models/prophet/loss.py:88",
           "launches": launches["loss_stack"],
           "max_abs_err": max(v["max_abs_err"] for v in stack.values()),
           "tolerance": GAP_RULE + "; each trial the row layout's bits",
           **{k: stack["config4"][k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "shape")},
           "library_ms": None, "cases": stack}
    # K1 on the forecast of the fitted batch: at the launch shape of the
    # path (``predict`` takes rows in chunks whose (S, rows, T) samples
    # stay under 2**28; a sampled forecast takes K1's outputs in scaled
    # units) chunk by chunk over all 8,192 rows, and over the whole batch
    # in data units, against its plain version at phase ``forward``'s
    # tolerance.
    theta = inp["theta_fit"]
    pdata, scale, floor = inp["pdata"], inp["y_scale"], inp["floor"]
    s, rows = 256, inp["predict_chunk"]
    pb, pt = pdata.t.shape
    f_tol, f_err, f_abs = 2e-5, 0.0, 0.0
    for r0 in range(0, pb, rows):
        idx = slice(r0, min(r0 + rows, pb))
        part = (theta[idx].contiguous(), _rows(pdata, idx))
        got = fk.forward(*part, cfg)
        want = fk.forward_plain(*part, cfg)
        f_err = max(f_err, *(rel_err(g, w) for g, w in zip(got, want)))
        f_abs = max(f_abs, *(float((g - w).abs().max())
                             for g, w in zip(got, want)))
    got = fk.forward(theta, pdata, cfg, scale, floor)
    want = fk.forward_plain(theta, pdata, cfg, scale, floor)
    f_err_data = _forward_err(got, want, scale)
    for g in got:
        require(bool(torch.isfinite(g).all()), "logistic forward finite")
    del got, want
    require(max(f_err, f_err_data) <= f_tol,
            f"logistic forward at {pb}x{pt}: {f_err}, data units "
            f"{f_err_data} > {f_tol}")
    fchunk = (theta[:rows].contiguous(), _rows(pdata, slice(0, rows)))
    k1 = {"name": "forward_logistic", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/forward.cu",
          "replaces": "tsspark_tpu/models/prophet/trend.py:132",
          "launches": launches["forward"],
          "max_abs_err": f_abs, "max_rel_err": f_err,
          "max_rel_err_data_units": f_err_data,
          "tolerance": f"|k-p|/(1+|p|) <= {f_tol} (scaled units); "
                       f"|k-p|/(y_scale+|p|) <= {f_tol} (data units)",
          "ms": cuda_ms(lambda: fk.forward(*fchunk, cfg)),
          "plain_ms": cuda_ms(lambda: fk.forward_plain(*fchunk, cfg),
                              iters=3, warmup=1),
          **forward_bound_ms(rows, pt, cfg, False, False),
          "library_ms": None, "shape": [rows, pt, "shared X"],
          "whole_batch": {
              "shape": [pb, pt],
              "ms": cuda_ms(lambda: fk.forward(theta, pdata, cfg, scale,
                                               floor)),
              **forward_bound_ms(pb, pt, cfg, False, True)},
          "row_invariance": forward_row_invariance(theta, pdata, cfg, scale,
                                                   floor, device)}
    # K2 on the same forecast, 256 samples, at the path's chunk: against
    # the plain scan on given draws, chunk by chunk over all 8,192 rows;
    # timed per chunk and over the whole batch at once.
    _, det, add, mult = fk.forward(theta, pdata, cfg)
    gen = torch.Generator(device=device).manual_seed(9)
    err, abs_b, plain_s = 0.0, 0.0, 0.0
    for r0 in range(0, pb, rows):
        idx = slice(r0, min(r0 + rows, pb))
        part = _band_rows((theta, pdata, det, add, mult, scale, floor), idx)
        draws = bk.sample_draws((s, idx.stop - r0, pt), gen, device)
        got = bk.bands(*part, cfg, s, draws=draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = bk.bands_plain(*part, cfg, draws)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t1
        err = max(err, _band_err(got, want, part[5]))
        abs_b = max(abs_b, max(float((got[k] - want[k]).abs().max())
                               for k in want))
        del draws, got, want
    require(err <= 1e-5, f"logistic bands at {pb}x{pt}x{s}: {err}")
    kargs = (theta, pdata, det, add, mult, scale, floor)
    chunk = _band_rows(kargs, slice(0, rows))
    n_chunks = -(-pb // rows)
    k2 = {"name": "bands_logistic", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/bands.cu",
          "replaces": "tsspark_tpu/models/prophet/predict.py:185",
          "launches": launches["bands"],
          "max_abs_err": abs_b, "max_rel_err": err,
          "tolerance": "|k-p|/(y_scale+|p|) <= 1e-05 (given draws)",
          "ms": cuda_ms(lambda: bk.bands(*chunk, cfg, s, seed=1), iters=10),
          "plain_ms": 1e3 * plain_s / n_chunks,
          "plain_ms_note": f"the plain scan on given draws, mean of "
                           f"{n_chunks} chunks",
          **bands_bound_ms(rows, pt, s, cfg),
          **bands_variates_bound_ms(rows, pt, s, cfg),
          # One torch.quantile of the sampled paths would be the closest
          # library call; it refuses inputs above 2**24 elements and one
          # chunk's (256, 512, 1200) samples hold 1.6e8.
          "library_ms": None, "shape": [rows, pt, s],
          "whole_batch": {
              "shape": [pb, pt, s],
              "ms": cuda_ms(lambda: bk.bands(*kargs, cfg, s, seed=1),
                            iters=5, warmup=1),
              **bands_bound_ms(pb, pt, s, cfg),
              **bands_variates_bound_ms(pb, pt, s, cfg)},
          "row_invariance": band_row_invariance(kargs, cfg, s, device)}
    return [k3, k3s, k1, k2]


def line_search_stack(data, cfg, solver, device, k_steps=20):
    """The line search's (K + 1) B trial stack at the ridge init: K rungs
    along the preconditioned steepest-descent direction and the fallback
    row (``ops.lbfgs``'s first iteration, without the closed-form fan)."""
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
    return torch.cat([(theta0[None] + steps[:, None, None] * d[None])
                      .reshape(-1, cfg.num_params), theta0]).contiguous()


def trial_stack(trials, data, cfg) -> dict:
    """K3's trial-stack layout on an (n B, P) stack: within ``GAP_TOL``
    of its plain version, each trial's values the same bits as the row
    layout's launch of that trial alone, timed beside its bound."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = data.t.shape
    n = trials.shape[0] // b
    s_k, _ = lk.loss(trials, data, cfg, grad=False)
    s_p, _ = lk.loss_plain(trials, data, cfg, grad=False)
    f_scale = torch.cat([loss_scales(trials[i * b:(i + 1) * b], data, cfg)[0]
                         for i in range(n)])
    gap = _gap(s_k, s_p, f_scale, t_len)
    require(gap <= GAP_TOL, f"loss on the {n}x{b} trial stack ({cfg.growth})"
            f": gap {gap}")
    require(bool(torch.isfinite(s_k).all()), "trial stack finite")
    for i in range(n):
        rows = slice(i * b, (i + 1) * b)
        alone, _ = lk.loss(trials[rows].contiguous(), data, cfg, grad=False)
        require(torch.equal(s_k[rows], alone),
                f"trial {i} of the {n}x{b} stack ({cfg.growth}) differs from "
                f"its row-layout launch")
    out = {"shape": [n * b, t_len, cfg.num_params], "gap": gap,
           "max_abs_err": float((s_k - s_p).abs().max()),
           "trials_bitwise": True,
           "ms": cuda_ms(lambda: lk.loss(trials, data, cfg, grad=False)),
           "one_trial_ms": cuda_ms(lambda: lk.loss(trials[:b].contiguous(),
                                                   data, cfg, grad=False)),
           "plain_ms": cuda_ms(lambda: lk.loss_plain(trials, data, cfg,
                                                     grad=False),
                               iters=2, warmup=1),
           **loss_bound_ms(n * b, b, t_len, cfg, False)}
    del s_k, s_p
    return out


def phase_kernels(serve, fwd, bnd, fit, fit4, mcmc, device) -> dict:
    """Each kernel at the main path's largest launch shapes, on the main
    path's inputs: held against its plain version, then timed."""
    import torch

    from tsspark_tpu_torch.backends.cuda import _slice_repeat_pad, _slice_state
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data

    inp = serve["inputs"]
    cfg = inp["cfg"]
    c = min(8192, int(inp["state"].theta.shape[0]))  # the backend's chunk
    sub = _slice_state(inp["state"], 0, c, c)
    theta = sub.theta.to(device)
    scale = torch.as_tensor(sub.meta.y_scale, dtype=torch.float32,
                            device=device)
    floor = torch.as_tensor(sub.meta.floor, dtype=torch.float32,
                            device=device)
    f_tol, b_tol = 2e-5, 1e-5
    # K1: the in-sample + 28-day chunk over the shared calendar.
    data = prepare_predict_data(inp["ds_full"], sub.meta, cfg, device)
    b, t_len = data.t.shape
    got = fk.forward(theta, data, cfg, scale, floor)
    want = fk.forward_plain(theta, data, cfg, scale, floor)
    k1_err = _forward_err(got, want, scale)
    k1_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(k1_err <= f_tol, f"forward at {b}x{t_len}: {k1_err} > {f_tol}")
    del got, want
    k1_ms = cuda_ms(lambda: fk.forward(theta, data, cfg, scale, floor))
    k1_plain = cuda_ms(lambda: fk.forward_plain(theta, data, cfg, scale,
                                                floor), iters=3, warmup=1)
    # The engine's per-series chunk (horizon bucket 32).
    last = sub.meta.ds_start + sub.meta.ds_span
    step = _slice_repeat_pad(inp["step"], 0, c, c)
    grid = last[:, None] + step[:, None] * np.arange(1, 33)
    eng = prepare_predict_data(grid, sub.meta, cfg, device)
    got = fk.forward(theta, eng, cfg, scale, floor)
    want = fk.forward_plain(theta, eng, cfg, scale, floor)
    k1e_err = _forward_err(got, want, scale)
    k1e_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(k1e_err <= f_tol, f"forward at the engine chunk: {k1e_err}")
    k1_rows = {"in_sample": forward_row_invariance(theta, data, cfg, scale,
                                                   floor, device),
               "engine_chunk": forward_row_invariance(theta, eng, cfg, scale,
                                                      floor, device)}
    k1 = {"name": "forward", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/forward.cu",
          "replaces": "tsspark_tpu/models/prophet/design.py:377",
          "launches": serve["out"]["launches"]["forward"],
          "max_abs_err": max(k1_abs, k1e_abs),
          "max_rel_err": max(k1_err, k1e_err),
          "tolerance": f"|k-p|/(y_scale+|p|) <= {f_tol} (data units)",
          "ms": k1_ms, "plain_ms": k1_plain,
          **forward_bound_ms(b, t_len, cfg, False, True),
          "library_ms": None, "shape": [b, t_len, "shared X"],
          "per_series": {
              "shape": list(eng.t.shape),
              "ms": cuda_ms(lambda: fk.forward(theta, eng, cfg, scale,
                                               floor)),
              "device_ms": device_ms(lambda: fk.forward(theta, eng, cfg,
                                                        scale, floor)),
              **forward_bound_ms(c, 32, cfg, True, True)},
          "at_2048": {"max_abs_err_scaled": fwd["max_abs_err_scaled"]},
          "row_invariance": k1_rows}
    # K2: the engine's sampled chunk, S=256, on the engine chunk's own
    # forward outputs, with given draws so both versions see one set.
    _, det, add, mult = fk.forward(theta, eng, cfg)
    s = 256
    gen = torch.Generator(device=device).manual_seed(5)
    draws = bk.sample_draws((s, c, 32), gen, device)
    kargs = (theta, eng, det, add, mult, scale, floor, cfg)
    got = bk.bands(*kargs, s, draws=draws)
    want = bk.bands_plain(*kargs, draws)
    k2_err = _band_err(got, want, scale)
    k2_abs = max(float((got[k] - want[k]).abs().max()) for k in want)
    require(k2_err <= b_tol, f"bands at {c}x32x{s}: {k2_err} > {b_tol}")
    del got, want
    k2_ms = cuda_ms(lambda: bk.bands(*kargs, s, seed=1))
    k2_plain = cuda_ms(lambda: bk.bands_plain(*kargs, draws),
                       iters=3, warmup=1)
    del draws
    k2 = {"name": "bands", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/bands.cu",
          "replaces": "tsspark_tpu/models/prophet/predict.py:273",
          "launches": serve["out"]["launches"]["bands"],
          "max_abs_err": k2_abs, "max_rel_err": k2_err,
          "tolerance": f"|k-p|/(y_scale+|p|) <= {b_tol} (given draws)",
          "ms": k2_ms, "plain_ms": k2_plain,
          **bands_bound_ms(c, 32, s, cfg),
          **bands_variates_bound_ms(c, 32, s, cfg),
          "row_invariance": band_row_invariance(kargs[:7], cfg, s, device),
          # torch.quantile refuses inputs above 2**24 elements; the main
          # path's (256, 8192, 32) sample tensor holds 2**26.
          "library_ms": None,
          "shape": [c, 32, s],
          "at_1024": {"ms": bnd["ms"],
                      "torch_quantile_ms": bnd["torch_quantile_ms"]}}
    k1["launches_fit"] = fit["out"]["launches"]["forward"]
    kernels = [k1, k2] + fit_kernels(fit, device) \
        + logistic_kernels(fit4, fit, device) + [mcmc["kernel"]]
    # K3's gradient launches on the MCMC path (its MAP fit and sampler).
    kernels[2]["launches_mcmc_path"] = mcmc["out"]["launches"]["loss_grad"]
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    return {"kernels": kernels}


def add_stream_launches(kernels, stream5, fleet) -> None:
    """Each streaming-path kernel's entry gains its launches on the two
    streaming paths (phase stream5's whole run; the fleet's warm run, its
    replay and its cold run, its forecasts) and its checks against the
    plain version at stream5's and the fleet's shapes
    (``hold_stream_kernels``, ``stream_forward``, ``stream_kernels``)."""
    fl = {k: _sum_counts(fleet[k]["micro_batches"]) for k in ("warm",
                                                               "cold")}
    fl["replay"] = fleet["replay"]["micro_batch"]["launches"]
    refit = {k: sum(fl[r][k] for r in fl) for k in fl["warm"]}
    fc = fleet["warm"]["forecast"]["launches"]
    s256 = fleet["warm"]["forecast_s256"]["launches"]
    s5 = stream5["launches"]
    fleet_launches = {
        "loss": refit["loss_grad"] + refit["loss_value"],
        "fan": refit["fan"],
        "forward": fc["forward"] + s256["forward"],
        "bands": s256["bands"]}
    stream5_launches = {"loss": s5["loss_grad"] + s5["loss_value"],
                        "fan": s5["fan"], "forward": s5["forward"],
                        "bands": s5["bands"]}
    s5k = stream5["kernels"]
    stream5_checks = {"loss": s5k["loss_fan"]["gap"],
                      "fan": s5k["loss_fan"]["gap"]["fan"],
                      "forward": s5k["forward"]}
    for k in kernels:
        if k["name"] in fleet_launches:
            if k["name"] in stream5_checks:
                k["stream5_check"] = stream5_checks[k["name"]]
            k["launches_stream5"] = stream5_launches[k["name"]]
            k["launches_stream_fleet"] = fleet_launches[k["name"]]
            k["stream_fleet_check"] = fleet["kernels"][k["name"]]
            if k["name"] == "loss":
                k["launches_stream_fleet_grad"] = refit["loss_grad"]
                k["launches_stream_fleet_value"] = refit["loss_value"]


def fit_kernels(fit, device) -> list:
    """K3 (both modes) and K4 at the fit path's shapes, on config 3's first
    chunk: at the ridge init (the solve's first calls) and at the fitted
    parameters; K4 on the first direction of the solve."""
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    inp = fit["inputs"]
    data, cfg = inp["data"], inp["cfg"]
    b, t_len = data.t.shape
    tol = GAP_RULE
    gaps, abs_f, abs_g = {}, 0.0, 0.0
    for where in ("theta0", "theta_fit"):
        theta = inp[where]
        f_k, g_k = lk.loss(theta, data, cfg)
        v_k, _ = lk.loss(theta, data, cfg, grad=False)
        f_p, g_p = lk.loss_plain(theta, data, cfg)
        gaps[where] = loss_gaps(theta, data, cfg, {
            "f": (f_k, f_p), "g": (g_k, g_p), "value_mode": (v_k, f_p)})
        abs_f = max(abs_f, float((f_k - f_p).abs().max()),
                    float((v_k - f_p).abs().max()))
        abs_g = max(abs_g, float((g_k - g_p).abs().max()))
        require(within_gap_rule(gaps[where]),
                f"loss at {b}x{t_len} ({where}): {gaps[where]}")
    theta = inp["theta0"]
    launches = fit["out"]["launches"]
    k3 = {"name": "loss", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/loss.cu",
          "replaces": "tsspark_tpu/models/prophet/loss.py:196",
          "launches": launches["loss"],
          "launches_grad": launches["loss_grad"],
          "launches_value": launches["loss_value"],
          "max_abs_err": max(abs_f, abs_g), "max_abs_err_f": abs_f,
          "gap": gaps, "tolerance": tol,
          "ms": cuda_ms(lambda: lk.loss(theta, data, cfg)),
          "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg),
                              iters=3, warmup=1),
          **loss_bound_ms(b, b, t_len, cfg, True),
          "library_ms": None, "shape": [b, t_len, cfg.num_params],
          "value_mode": {
              "launches": launches["loss_value"],
              "ms": cuda_ms(lambda: lk.loss(theta, data, cfg, grad=False)),
              "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg,
                                                        grad=False),
                                  iters=3, warmup=1),
              **loss_bound_ms(b, b, t_len, cfg, False)}}
    d = inp["direction"]
    ladder = _ladder(b, device)
    got = fan_k.fan(theta, d, ladder, data, cfg)
    want = fan_k.fan_plain(theta, d, ladder, data, cfg)
    gap = _gap(got, want, fan_scale(theta, d, ladder, data, cfg), t_len)
    require(gap <= GAP_TOL, f"fan at 20x{b}x{t_len}: gap {gap}")
    k4 = {"name": "fan", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/fan.cu",
          "replaces": "tsspark_tpu/models/prophet/loss.py:106",
          "launches": launches["fan"],
          "max_abs_err": float((got - want).abs().max()), "gap": gap,
          "tolerance": tol.replace("row", "rung"),
          "ms": cuda_ms(lambda: fan_k.fan(theta, d, ladder, data, cfg)),
          "plain_ms": cuda_ms(lambda: fan_k.fan_plain(theta, d, ladder,
                                                      data, cfg),
                              iters=3, warmup=1),
          **fan_bound_ms(b, t_len, 20, cfg),
          "library_ms": None, "shape": [20, b, t_len]}
    k3["row_invariance"] = k4["row_invariance"] = row_invariance(
        data, cfg, theta, d, ladder, device)
    return [k3, k4]


def forward_row_invariance(theta, data, cfg, scale, floor, device) -> dict:
    """K1 gives a row the same bits wherever it sits: rows 1000:1500 as a
    batch of their own, and the batch permuted."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk

    b = theta.shape[0]
    full = fk.forward(theta, data, cfg, scale, floor)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(2))
    perm = perm.to(device)
    for name, idx in (("rows 1000:1500", slice(1000, 1500)),
                      ("a permuted batch", perm)):
        got = fk.forward(theta[idx].contiguous(), _rows(data, idx), cfg,
                         scale[idx].contiguous(), floor[idx].contiguous())
        require(all(torch.equal(g, w[idx]) for g, w in zip(got, full)),
                f"forward at {tuple(data.t.shape)}: {name} differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [1000, 1500], "permuted": b}


def _rows(data, idx):
    """FitData of the rows ``idx`` (a slice or an index tensor)."""
    per_row = ["t", "y", "mask", "s", "cap", "X_reg"]
    if data.X_season.ndim == 3:
        per_row.append("X_season")
    return data._replace(**{f: getattr(data, f)[idx].contiguous()
                            for f in per_row})


def row_invariance(data, cfg, theta, d, ladder, device,
                   sl=slice(1000, 1500)) -> dict:
    """K3 (both modes) and K4 give a row the same bits wherever it sits:
    rows ``sl`` launched as a batch of their own, the batch permuted, and
    (K3) a trial stack of 3B rows against three separate launches."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k

    out = loss_row_invariance(data, cfg, theta, device, sl)
    b = theta.shape[0]
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(device)
    sub, permuted = _rows(data, sl), _rows(data, perm)
    fan = fan_k.fan(theta, d, ladder, data, cfg)
    require(torch.equal(fan_k.fan(theta[sl].contiguous(), d[sl].contiguous(),
                                  ladder[:, sl].contiguous(), sub, cfg),
                        fan[:, sl]), f"fan: rows {sl} alone differ")
    require(torch.equal(fan_k.fan(theta[perm].contiguous(),
                                  d[perm].contiguous(),
                                  ladder[:, perm].contiguous(), permuted, cfg),
                        fan[:, perm]), "fan: a permuted batch differs")
    torch.cuda.synchronize()
    return out


def loss_row_invariance(data, cfg, theta, device,
                        sl=slice(1000, 1500)) -> dict:
    """K3 (both modes) gives a row the same bits wherever it sits: rows
    ``sl`` launched as a batch of their own, the batch permuted, and a
    trial stack of 3B rows against three separate launches."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b = theta.shape[0]
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(device)
    sub, permuted = _rows(data, sl), _rows(data, perm)
    same = lambda a, c: a is None or torch.equal(a, c)  # noqa: E731
    for grad in (True, False):
        mode = "gradient" if grad else "value"
        f, g = lk.loss(theta, data, cfg, grad)
        fs, gs = lk.loss(theta[sl].contiguous(), sub, cfg, grad)
        require(same(fs, f[sl]) and (g is None or same(gs, g[sl])),
                f"loss ({mode}): rows {sl} alone differ")
        fp, gp = lk.loss(theta[perm].contiguous(), permuted, cfg, grad)
        require(same(fp, f[perm]) and (g is None or same(gp, g[perm])),
                f"loss ({mode}): a permuted batch differs")
        parts = [theta, theta * 1.01, theta * 0.99]
        fst, gst = lk.loss(torch.cat(parts).contiguous(), data, cfg, grad)
        for n, part in enumerate(parts):
            fn, gn = lk.loss(part.contiguous(), data, cfg, grad)
            rows = slice(n * b, (n + 1) * b)
            require(same(fst[rows], fn) and (gn is None
                                             or same(gst[rows], gn)),
                    f"loss ({mode}): trial stack part {n} differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [sl.start, sl.stop], "permuted": b,
            "loss_trial_stack": 3 * b}


# ---------------------------------------------------------------------------
# phase uncertainty: ADVI (K3 on the draw stack, K7), the quantile plane,
# interval reads, coverage and the gold audit at the M5 fleet's width
# ---------------------------------------------------------------------------

UNC_SUBSET = 64         # the ADVI parity subset (card against CPU)
UNC_CHECK_ROWS = 512    # K3's draw-stack gaps, the plane's bitwise checks
UNC_PROBES = 200
UNC_SEED = 0
# The card's ADVI against the plain CPU path on the same MAP theta and the
# same draws, per series: max over parameters of |d mu| / sd (the CPU
# posterior's) and of |d log sd|.  Read on the card (PERF.md §6):
# 2.3e-4 and 6.0e-6 (K3's sums against the plain loss's, carried through
# 200 steps); the planted faults (``ADVI_FAULTS``) 1.66 / 1.08 (the
# entropy's -1 dropped) and 80.7 / 5.73 (eps left out of the rho
# gradient).  The limits sit ~40x and ~170x above the sound readings and
# 100x below the faults.
ADVI_PARITY = {"dmu_sd": 0.01, "dlog_sd": 0.001}
ADVI_FAULTS = ("no_entropy", "no_eps_in_rho_grad")
# K7 against its plain version on the path's tensors: both take every
# operation in the same order, each rounded on its own (no FMA), so the
# same bits are required.
K7_TOL = 0.0


def advi_parity_job(ds_fit, y, mask, theta0, seed: int) -> dict:
    """The plain CPU ADVI fit of the parity subset from the card's MAP
    theta, on ``advi_draws(seed)``.  Runs in a ``ParityFits`` worker."""
    import torch

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.uncertainty import advi

    torch.set_num_threads(PARITY_THREADS)
    cfg = ProphetConfig()
    data, _ = prepare_fit_data(ds_fit, y, cfg, mask=mask)
    t0 = time.perf_counter()
    post = advi.fit_advi(theta0, data, None, cfg, device="cpu",
                         draws=advi_draws(seed, theta0.shape, "cpu"))
    return {"seconds": time.perf_counter() - t0, "mu": post.mu.numpy(),
            "rho": post.rho.numpy()}


def advi_draws(seed: int, shape, device):
    """The parity fits' draws: (K, B, P) standard normals a step from one
    host generator, the same sequence on both sides."""
    import torch

    from tsspark_tpu_torch.config import AdviConfig

    gen = torch.Generator().manual_seed(seed)
    k = AdviConfig().num_elbo_samples
    return lambda _i: torch.randn((k,) + tuple(shape), generator=gen) \
        .to(device)


def advi_distance(mu, rho, ref_mu, ref_rho) -> dict:
    """Per series max over parameters of |d mu| / sd_ref and |d log sd|:
    their max and median over series."""
    dmu = (np.abs(mu - ref_mu) / np.exp(ref_rho)).max(-1)
    dsd = np.abs(rho - ref_rho).max(-1)
    return {"dmu_sd": float(dmu.max()), "dmu_sd_median": float(np.median(dmu)),
            "dlog_sd": float(dsd.max()),
            "dlog_sd_median": float(np.median(dsd))}


def within_advi_parity(d: dict) -> bool:
    return all(d[k] <= v for k, v in ADVI_PARITY.items())


def planted_advi_fault(kind: str):
    """A K7 step with one planted fault, as the plain version on the card:
    the entropy's -1 dropped from g_rho, or eps left out of it."""
    import torch

    from tsspark_tpu_torch.kernels import advi as advi_k

    real = advi_k.elbo_grads

    def grads(g, eps, sd, inv_k):
        g_mu, g_rho = real(g, eps, sd, inv_k)
        if kind == "no_entropy":
            return g_mu, g_rho + 1.0
        return g_mu, real(g, torch.ones_like(eps), sd, inv_k)[1]

    def step(*args):
        saved = advi_k.elbo_grads
        advi_k.elbo_grads = grads
        try:
            return advi_k.advi_plain(*args)
        finally:
            advi_k.elbo_grads = saved
    return step


def advi_bound_ms(k_draws, b, p) -> dict:
    """Least time for one K7 launch: g and eps (K B P each), f (K B), mu,
    rho and the four moments read once, the six states and the loss
    written once; against ~4K + 20 float32 operations a (b, p).  K7 also
    reads sd, but sd = exp(rho) is not work the function needs."""
    floats = 2 * k_draws * b * p + k_draws * b + 6 * b * p + 6 * b * p + b
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = b * p * (4 * k_draws + 20) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def stack_gaps(mu, rho, eps, data, cfg) -> dict:
    """K3 (both modes) on a draw stack against its plain version by
    GAP_RULE, each draw held to its own rows' scale; the same with one
    observed cell a row dropped (required to fail); the plain float32
    version against float64 by the same rule (the rule holds K3 only where
    float32 itself is within it)."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.uncertainty.advi import _stack

    k_draws, b, p = eps.shape
    _, stack = _stack(mu, rho, eps)
    f_k, g_k = lk.loss(stack, data, cfg)
    v_k, _ = lk.loss(stack, data, cfg, grad=False)
    f_p, g_p = lk.loss_plain(stack, data, cfg)
    mask = data.mask.clone()
    mask[torch.arange(b, device=mask.device), mask.argmax(-1)] = 0.0
    dropped = data._replace(mask=mask)
    f_drop, _ = lk.loss(stack, dropped, cfg, grad=False)
    data64 = data._replace(**{f: getattr(data, f).double()
                              for f in data._fields})
    f64, g64 = lk.loss_plain(stack.double(), data64, cfg)
    gaps, planted, plain64 = {}, [], {}
    rows = lambda x, k: x[k * b:(k + 1) * b]  # noqa: E731
    for k in range(k_draws):
        th = rows(stack, k)
        gk = loss_gaps(th, data, cfg, {
            "f": (rows(f_k, k), rows(f_p, k)),
            "g": (rows(g_k, k), rows(g_p, k)),
            "value_mode": (rows(v_k, k), rows(f_p, k))})
        for name, v in gk.items():
            gaps[name] = max(gaps.get(name, 0.0), v)
        planted.append(loss_gaps(th, data, cfg, {
            "f": (rows(f_drop, k), rows(f_p, k))})["f"])
        pk = loss_gaps(th, data, cfg, {
            "f": (rows(f_p, k).double(), rows(f64, k)),
            "g": (rows(g_p, k).double(), rows(g64, k))})
        for name, v in pk.items():
            plain64[name] = max(plain64.get(name, 0.0), v)
    torch.cuda.synchronize()
    return {"gap": gaps, "planted_dropped_cell": min(planted),
            "plain_f32_vs_f64": plain64,
            "max_abs_err": max(float((f_k - f_p).abs().max()),
                               float((g_k - g_p).abs().max()),
                               float((v_k - f_p).abs().max()))}


def draw_stack_bits(stack, data, cfg, k_draws, f, g) -> dict:
    """K3's draw-stack launch (``f``, ``g`` on the (K B, P) ``stack``)
    against each draw's rows launched alone (the row layout, N = B): the
    same bits are required."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b = stack.shape[0] // k_draws
    same, err = True, 0.0
    for k in range(k_draws):
        rows = slice(k * b, (k + 1) * b)
        fk, gk = lk.loss(stack[rows].contiguous(), data, cfg)
        same = same and torch.equal(f[rows], fk) and torch.equal(g[rows], gk)
        err = max(err, float((f[rows] - fk).abs().max()),
                  float((g[rows] - gk).abs().max()))
    torch.cuda.synchronize()
    return {"bitwise": bool(same), "max_abs_err": err}


def k7_check(state, g, f, eps, sd, step, advi) -> dict:
    """K7 against its plain version on clones of the path's tensors."""
    import torch

    from tsspark_tpu_torch.kernels import advi as advi_k

    sc = advi_k.adam_scalars(advi, step)
    mine = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    got = advi_k.advi_step(g, f, eps, sd, *mine, sc)
    want = advi_k.advi_plain(g, f, eps, sd, *plain, sc)
    torch.cuda.synchronize()
    pairs = [(got, want)] + list(zip(mine, plain))
    err = max(float((a - c).abs().max()) for a, c in pairs)
    same = all(torch.equal(a, c) for a, c in pairs)
    require(same and err <= K7_TOL,
            f"advi at step {step}: max |k-p| {err}, bitwise {same}")
    return {"bitwise": same, "max_abs_err": err}


def phase_uncertainty(serve, device, parity, root=None) -> dict:
    """The uncertainty tier at the M5 fleet's width (``run_calibration_
    smoke``'s recipe): serve's ``m5_like(30490, 1941)`` batch under
    ``ProphetConfig()``, the last 28 days withheld; the MAP fit through
    ``CudaBackend.fit`` (``SolverConfig(max_iters=25)``), ``publish``,
    ``fit_advi`` at ``AdviConfig()`` (K3 on the 121,960-row draw stack,
    K7), ``save_posterior``, ``qplane.maybe_publish`` (ADVI mode),
    ``evaluate_version``, 200 reads through ``PredictionEngine.quantiles``,
    512 reads of a version without a posterior (MAP mode: K1), and
    ``gold.audit_version`` (8 rows, ``McmcConfig()``).  Then the checks:
    K3 on the draw stack by GAP_RULE, K7 against its plain version, the
    card's ADVI against the plain CPU path on 64 series (with planted
    faults), the plane against ``compute_rows``.  ``root``: the
    registry's directory, kept for phase planes (``handoff``); None: a
    temporary one, removed at the end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import (
        AdviConfig,
        ProphetConfig,
        SolverConfig,
    )
    from tsspark_tpu_torch.kernels import advi as advi_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.design import (
        fitdata_to_device,
        prepare_fit_data,
        prepare_fit_data_blocks,
    )
    from tsspark_tpu_torch.ops import hmc
    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
    )
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import calibrate, gold, qplane

    cfg, advi = ProphetConfig(), AdviConfig()
    batch = serve["inputs"]["batch"]
    n, days = batch.y.shape
    cut = days - calibrate.DEFAULT_HOLDOUT
    ds_fit = batch.ds[:cut]
    y_fit = np.nan_to_num(batch.y[:, :cut])
    m_fit = batch.mask[:, :cut]
    ids = batch.series_ids
    stages = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    own_root = root is None
    if own_root:
        root = tempfile.mkdtemp(prefix="uncertainty_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hmc.timing.reset()
        # The main path: counts to 0 just before, read just after.
        lk.launches = lk.grad_launches = lk.stack_launches = 0
        fk.launches = advi_k.launches = fan_k.launches = 0
        bk = get_backend("cuda", cfg, SolverConfig(max_iters=25),
                         device=device)
        state = stage("map_fit", bk.fit, ds_fit, y_fit, mask=m_fit)
        reg = ParamRegistry(root, cfg)
        v = stage("publish", reg.publish, state, ids, step=np.ones(n))
        data_np, _ = stage("advi_prep", prepare_fit_data_blocks, ds_fit,
                           y_fit, cfg, mask=m_fit)
        theta0 = np.nan_to_num(state.theta.cpu().numpy().astype(np.float32))
        # The CPU ADVI parity fit (64 series, held below) runs on a
        # parity worker beside the card's ADVI and the plane's publish.
        sub_rows = np.linspace(0, n - 1, UNC_SUBSET).astype(np.int64)
        th_sub = theta0[sub_rows]
        job = parity.submit(advi_parity_job, ds_fit, y_fit[sub_rows],
                            m_fit[sub_rows], th_sub, UNC_SEED + 1)
        before = (lk.stack_launches, lk.grad_launches)
        t0 = time.perf_counter()
        post = advi_mod.fit_advi(
            theta0, data_np, torch.Generator(device=device)
            .manual_seed(UNC_SEED), cfg, advi, device=device)
        torch.cuda.synchronize()
        stages["fit_advi"] = time.perf_counter() - t0
        k7_path = advi_k.launches
        # K3's draw-stack launches in fit_advi (gradient mode, all of them).
        k3_draw_path = lk.stack_launches - before[0]
        k3_grad_path = lk.grad_launches - before[1]
        stage("save_posterior", advi_mod.save_posterior,
              reg.version_dir(v), post, seed=UNC_SEED,
              num_steps=advi.num_steps)
        pub = stage("qplane_publish", qplane.maybe_publish, reg, v, bk,
                    horizons=(7, 14, 28))
        calib = stage("evaluate", calibrate.evaluate_version, reg, v,
                      batch.ds[cut:], batch.y[:, cut:],
                      mask_future=batch.mask[:, cut:])
        eng = PredictionEngine(reg, cache=ForecastCache(0), device=device)
        rng = np.random.default_rng(UNC_SEED)
        walls = []
        t0 = time.perf_counter()
        for _ in range(UNC_PROBES):
            k = int(rng.integers(1, 9))
            sel = [ids[i] for i in np.sort(rng.choice(n, k, replace=False))]
            h = int(rng.choice((7, 14, 28)))
            t1 = time.perf_counter()
            eng.quantiles(sel, h)
            walls.append((time.perf_counter() - t1) * 1e3)
        stages["reads"] = time.perf_counter() - t0
        reads = {"probes": UNC_PROBES,
                 "p50_ms": float(np.percentile(walls, 50)),
                 "p99_ms": float(np.percentile(walls, 99)),
                 "qplane_hits": eng.stats.qplane_hits,
                 "qplane_misses": eng.stats.qplane_misses}
        plane_view = qplane.attach(reg.version_dir(v))
        n_chk = min(UNC_CHECK_ROWS, n)
        sel512 = list(ids[:n_chk])
        eng_advi = {h: eng.quantiles(sel512, h) for h in (7, 14, 28)}
        # A version without a posterior: MAP-mode intervals (K1).
        v_map = reg.publish(state, ids, step=np.ones(n))
        eng_map = PredictionEngine(reg, cache=ForecastCache(0),
                                   device=device)
        k1_before = fk.launches
        map_res = stage("reads_map_mode", eng_map.quantiles, sel512, 28)
        k1_map = fk.launches - k1_before
        require(map_res.version == v_map
                and eng_map.stats.qplane_misses == n_chk,
                "MAP-mode reads: served by the version without a posterior")
        hmc.timing.reset()
        audit = stage("gold", gold.audit_version, reg, version=v,
                      arrays=(ds_fit, y_fit, m_fit, None), device=device)
        launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                    "loss_value": lk.launches - lk.grad_launches,
                    "loss_stack": lk.stack_launches,
                    "loss_draw_stack_in_fit_advi": k3_draw_path,
                    "fan": fan_k.launches, "forward": fk.launches,
                    "advi": advi_k.launches}
        gold_leapfrogs, gold_host_s = hmc.timing.leapfrogs, hmc.timing.host_s
        peak = torch.cuda.max_memory_allocated()

        require(k7_path == advi.num_steps and launches["advi"] == k7_path,
                f"K7 launches on the path: {launches}")
        require(k3_draw_path >= advi.num_steps
                and k3_grad_path == k3_draw_path,
                f"K3's draw-stack layout on fit_advi's path: {launches}")
        require(launches["loss_grad"] >= advi.num_steps
                and launches["fan"] > 0 and launches["forward"] > 0
                and k1_map > 0,
                f"kernels launched on the uncertainty path: {launches}")
        mu, rho = post.mu.cpu().numpy(), post.rho.cpu().numpy()
        elbo = post.elbo.cpu().numpy()
        require(mu.shape == rho.shape == (n, cfg.num_params)
                and elbo.shape == (n,), "posterior shapes")
        finite = {"mu": bool(np.isfinite(mu).all()),
                  "rho": bool(np.isfinite(rho).all()),
                  "elbo": bool(np.isfinite(elbo).all())}
        require(all(finite.values()), f"posterior finite: {finite}")
        require(pub is not None and pub["status"] == "published"
                and pub["mode"] == "advi", f"qplane publish: {pub}")
        require(calib is not None and calib["mode"] == "advi",
                f"evaluate_version: {calib}")
        # The plane: finite, ordered, its columns the compute path's bits
        # on 512 rows, the engine's reads the plane's and compute's bits.
        plane_checks = {}
        for hb in plane_view.buckets:
            cols = {pm: np.asarray(c) for pm, c in
                    plane_view.columns[hb].items()}
            require(all(np.isfinite(c).all() for c in cols.values()),
                    f"plane bucket {hb} finite")
            require(bool((cols[100] <= cols[500]).all()
                         and (cols[500] <= cols[900]).all()),
                    f"plane bucket {hb}: q100 <= q500 <= q900")
            idx = np.arange(n_chk)
            ref = qplane.compute_rows(reg.load(v), cfg, bk, idx, hb,
                                      posterior=post)
            require(all(np.array_equal(cols[pm][idx], ref[pm])
                        for pm in ref),
                    f"plane bucket {hb} != compute_rows on 512 rows")
            h = {8: 7, 16: 14, 32: 28}[hb]
            res = eng_advi[h]
            require(all(np.array_equal(res.values[f"q{pm:03d}"],
                                       ref[pm][:, :h]) for pm in ref),
                    f"engine.quantiles(h={h}) != compute_rows")
            plane_checks[str(hb)] = "bitwise (512 rows), finite, ordered"
        for k, val in map_res.values.items():
            require(np.isfinite(val).all(), f"MAP-mode {k} finite")
        require(bool((map_res.values["q100"] <= map_res.values["q500"])
                     .all() and (map_res.values["q500"]
                                 <= map_res.values["q900"]).all()),
                "MAP-mode quantiles ordered")
        require(audit is not None and np.isfinite(audit["qdiv_max"])
                and np.isfinite(audit["rhat_max"])
                and np.isfinite(audit["ess_min"]), f"gold audit: {audit}")

        # The path's loop replayed step by step from the same generator
        # (it must land on fit_advi's bits): the first and the last step's
        # tensors for the kernel checks, the first step's for the times.
        data = fitdata_to_device(data_np, device)
        del data_np
        gen = torch.Generator(device=device).manual_seed(UNC_SEED)
        shape = (advi.num_elbo_samples, n, cfg.num_params)
        st = advi_mod.init_state(torch.from_numpy(theta0).to(device), advi)
        eps0 = torch.randn(shape, generator=gen, device=device)
        state0 = [x.clone() for x in st]
        sd0, stack0 = advi_mod._stack(st.mu, st.rho, eps0)
        f0, g0 = lk.loss(stack0, data, cfg)
        bits_first = draw_stack_bits(stack0, data, cfg,
                                     advi.num_elbo_samples, f0, g0)
        require(bits_first["bitwise"],
                f"K3's draw stack at the first step: each draw against "
                f"its row-layout launch: {bits_first}")
        k3_ms = cuda_ms(lambda: lk.loss(stack0, data, cfg), iters=10)
        k3_row_ms = cuda_ms(lambda: [
            lk.loss(stack0[k * n:(k + 1) * n], data, cfg)
            for k in range(advi.num_elbo_samples)], iters=5)
        k3_plain_ms = cuda_ms(lambda: lk.loss_plain(stack0, data, cfg),
                              iters=1, warmup=1)
        sc0 = advi_k.adam_scalars(advi, 0)
        tmp = [x.clone() for x in state0]
        k7_ms = cuda_ms(lambda: advi_k.advi_step(g0, f0, eps0, sd0, *tmp,
                                                 sc0))
        tmp = [x.clone() for x in state0]
        k7_plain_ms = cuda_ms(lambda: advi_k.advi_plain(
            g0, f0, eps0, sd0, *tmp, sc0), iters=3, warmup=1)
        tmp = [x.clone().requires_grad_() for x in state0[:2]]
        for x, gr in zip(tmp, (g0[:n], g0[n:2 * n])):
            x.grad = gr.clone()
        adam = torch.optim.Adam(tmp, lr=advi.learning_rate,
                                betas=(advi.adam_b1, advi.adam_b2),
                                eps=advi.adam_eps, fused=True)
        adam_ms = cuda_ms(adam.step)
        del tmp, adam
        step_ms = 1e3 * stages["fit_advi"] / advi.num_steps
        # Five steps under the profiler, on a copy: the card's idle share.
        cp = advi_mod.AdviState(*[x.clone() for x in state0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(5):
                advi_mod.elbo_step(cp, data, cfg, eps0, i, advi)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t1
        top = _device_events(prof)
        busy_ms = sum(ms for _, ms in top)
        del cp
        # The step's device work by CUDA events, part by part (the draws,
        # the stack, K3, K7): the idle share where the profiler records
        # no device event.
        parts_ms = k3_ms + k7_ms + cuda_ms(lambda: torch.randn(
            shape, generator=torch.Generator(device=device), device=device)) \
            + cuda_ms(lambda: advi_mod._stack(state0[0], state0[1], eps0))
        k7_first = k7_check(state0, g0, f0, eps0, sd0, 0, advi)
        advi_mod.elbo_step(st, data, cfg, eps0, 0, advi)
        for i in range(1, advi.num_steps - 1):
            advi_mod.elbo_step(st, data, cfg, torch.randn(
                shape, generator=gen, device=device), i, advi)
        eps_last = torch.randn(shape, generator=gen, device=device)
        state_last = [x.clone() for x in st]
        sd_l, stack_l = advi_mod._stack(st.mu, st.rho, eps_last)
        f_l, g_l = lk.loss(stack_l, data, cfg)
        bits_last = draw_stack_bits(stack_l, data, cfg,
                                    advi.num_elbo_samples, f_l, g_l)
        require(bits_last["bitwise"],
                f"K3's draw stack at the last step: each draw against "
                f"its row-layout launch: {bits_last}")
        k7_last = k7_check(state_last, g_l, f_l, eps_last, sd_l,
                           advi.num_steps - 1, advi)
        advi_mod.elbo_step(st, data, cfg, eps_last, advi.num_steps - 1, advi)
        require(torch.equal(st.mu, post.mu) and torch.equal(st.rho, post.rho),
                "the replayed ADVI loop differs from fit_advi's bits")

        # K3 on the draw stack (first 512 series x 4 draws) by GAP_RULE at
        # the first and the last step.
        r = slice(0, n_chk)
        sub = _rows(data, r)
        first = stack_gaps(state0[0][r].contiguous(),
                           state0[1][r].contiguous(),
                           eps0[:, r].contiguous(), sub, cfg)
        require(within_gap_rule(first["gap"]),
                f"K3 on the first-step draw stack: {first}")
        require(first["planted_dropped_cell"] > GAP_TOL,
                f"a dropped cell passes GAP_RULE on the draw stack: {first}")
        last = stack_gaps(state_last[0][r].contiguous(),
                          state_last[1][r].contiguous(),
                          eps_last[:, r].contiguous(), sub, cfg)
        last["held"] = within_gap_rule(last["plain_f32_vs_f64"])
        if last["held"]:
            require(within_gap_rule(last["gap"]),
                    f"K3 on the last-step draw stack: {last}")
        del data, sub, st, stack_l, g_l, f_l, stack0, g0, f0

        # The card's ADVI against the plain CPU path on 64 series (its
        # job submitted after the MAP fit): the card's MAP theta, the same
        # host draws.
        sub_np, _ = prepare_fit_data(ds_fit, y_fit[sub_rows], cfg,
                                     mask=m_fit[sub_rows])
        card = advi_mod.fit_advi(th_sub, sub_np, None, cfg, device=device,
                                 draws=advi_draws(UNC_SEED + 1,
                                                  th_sub.shape, device))
        faults = {}
        for kind in ADVI_FAULTS:
            saved = advi_k.advi_step
            advi_k.advi_step = planted_advi_fault(kind)
            try:
                bad = advi_mod.fit_advi(
                    th_sub, sub_np, None, cfg, device=device,
                    draws=advi_draws(UNC_SEED + 1, th_sub.shape, device))
            finally:
                advi_k.advi_step = saved
            faults[kind] = (bad.mu.cpu().numpy(), bad.rho.cpu().numpy())
        t1 = time.perf_counter()
        cpu = job.get()
        wait_s = time.perf_counter() - t1
        sound = advi_distance(card.mu.cpu().numpy(), card.rho.cpu().numpy(),
                              cpu["mu"], cpu["rho"])
        planted = {k: advi_distance(m, rr, cpu["mu"], cpu["rho"])
                   for k, (m, rr) in faults.items()}
        advi_parity = {"subset": UNC_SUBSET, "cpu_s": cpu["seconds"],
                       "wait_s": wait_s, "limits": ADVI_PARITY,
                       "card_vs_cpu": sound, "planted": planted}
        emit({"phase": "uncertainty_parity", **advi_parity})
        require(within_advi_parity(sound),
                f"the card's ADVI against the CPU's: {advi_parity}")
        require(not any(within_advi_parity(d) for d in planted.values()),
                f"a planted ADVI fault passes the parity limits: "
                f"{advi_parity}")
    finally:
        if own_root:
            import shutil

            shutil.rmtree(root, ignore_errors=True)

    sd = np.exp(rho)
    out = {
        "phase": "uncertainty", "series": n, "days_fit": cut,
        "holdout": calibrate.DEFAULT_HOLDOUT, "params": cfg.num_params,
        "advi": {"num_steps": advi.num_steps,
                 "num_elbo_samples": advi.num_elbo_samples,
                 "stack_rows": advi.num_elbo_samples * n},
        "stages_s": stages,
        "map_fit_backend_stages_s": dict(bk.stages.seconds),
        "launches": launches, "launches_k1_map_mode_reads": k1_map,
        "ms_per_advi_step": {
            "wall": step_ms, "k3": k3_ms, "k7": k7_ms,
            "rest_torch_ops_and_host": step_ms - k3_ms - k7_ms},
        "advi_profile_5_steps": {
            "traced_wall_s": traced,
            "device_busy_ms": busy_ms if top else "not measured",
            "device_idle_share": (1.0 - busy_ms / 1e3 / traced if top
                                  else "not measured: the profiler "
                                  "recorded no device event"),
            "top_device_ms": [(k[:60], ms) for k, ms in top[:6]]},
        "device_ms_per_step_event_timed_parts": parts_ms,
        "idle_share_from_event_timed_parts": 1.0 - parts_ms / step_ms,
        "peak_device_bytes": peak,
        "posterior_sd": {
            "quantiles_all": {str(q): float(np.quantile(sd, q))
                              for q in (0.01, 0.1, 0.5, 0.9, 0.99)},
            "median_by_block": {
                "k": float(np.median(sd[:, 0])),
                "m": float(np.median(sd[:, 1])),
                "log_sigma": float(np.median(sd[:, 2])),
                "delta": float(np.median(sd[:, 3:3 + cfg.n_changepoints])),
                "beta": float(np.median(sd[:, 3 + cfg.n_changepoints:]))}},
        "elbo_median": float(np.median(elbo)),
        "qplane": {k: pub[k] for k in ("mode", "buckets", "nbytes",
                                       "publish_s")},
        "coverage_abs_gap": calib["coverage_abs_gap"],
        "coverage": {hb: {"interval_empirical": r["interval_empirical"],
                          "coverage_abs_gap": r["coverage_abs_gap"],
                          "n_cells": r["n_cells"],
                          "quantile_empirical": {
                              str(pm): g["empirical"] for pm, g in
                              r["quantile_gaps"].items()}}
                     for hb, r in calib["buckets"].items()},
        "reads": reads, "plane_checks": plane_checks,
        "gold": {k: audit[k] for k in ("rows", "qdiv_max", "qdiv_mean",
                                       "rhat_max", "ess_min", "accept_mean",
                                       "hmc_divergences")},
        "gold_host_ms_per_leapfrog": 1e3 * gold_host_s
        / max(gold_leapfrogs, 1),
        "gold_leapfrogs": gold_leapfrogs,
        "k3_draw_stack": {"first_step": first, "last_step": last,
                          "row_layout_bits": {"first_step": bits_first,
                                              "last_step": bits_last}},
        "k7": {"first_step": k7_first, "last_step": k7_last},
    }
    emit(out)
    kb = advi.num_elbo_samples * n
    k7 = {"name": "advi", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/advi.cu",
          "replaces": "tsspark_tpu/uncertainty/advi.py:87",
          "launches": launches["advi"],
          "max_abs_err": max(k7_first["max_abs_err"],
                             k7_last["max_abs_err"]),
          "tolerance": "bitwise (the plain version's operation order)",
          "ms": k7_ms, "plain_ms": k7_plain_ms,
          **advi_bound_ms(advi.num_elbo_samples, n, cfg.num_params),
          # No single PyTorch call computes the ELBO's reduction over the
          # draws and the Adam step; torch.optim.Adam(fused=True) on the
          # same (B, P) parameters, the update alone, as a yardstick.
          "library_ms": None, "adam_fused_update_only_ms": adam_ms,
          "shape": [advi.num_elbo_samples, n, cfg.num_params]}
    k3_stack = {"shape": [kb, cut, cfg.num_params],
                "source": "tsspark_tpu_torch/csrc/loss_draws.cuh",
                "layout": "draw stack (csrc/loss_draws.cuh draw_kernel: a warp "
                          "a series' 4 draws)",
                "ms": k3_ms, "plain_ms": k3_plain_ms,
                "row_layout_ms": k3_row_ms,
                "launches": launches["loss_draw_stack_in_fit_advi"],
                "max_abs_err": max(first["max_abs_err"],
                                   last["max_abs_err"]),
                "tolerance": GAP_RULE + " (512 series x 4 draws)",
                "max_abs_err_vs_row_layout": max(
                    bits_first["max_abs_err"], bits_last["max_abs_err"]),
                "tolerance_vs_row_layout": "bitwise",
                "library_ms": None,
                **loss_bound_ms(kb, n, cut, cfg, True),
                "gap": {"first_step": first["gap"],
                        "last_step": last["gap"]}}
    handoff = {"root": root, "registry": reg, "version": v, "backend": bk,
               "cfg": cfg, "ids": ids, "ds_fit": ds_fit, "y_fit": y_fit,
               "m_fit": m_fit, "posterior": (mu, rho, elbo),
               "advi_steps": advi.num_steps}
    return {"out": out, "kernel": k7, "k3_stack": k3_stack,
            "handoff": handoff}


def add_uncertainty(kernels, unc) -> None:
    """K7's entry joins the kernels line; K3's gains the ADVI draw stack
    (gradient, the draw-stack layout: each data row read once for a
    series' four draws)."""
    for k in kernels:
        if k["name"] == "loss":
            k["advi_draw_stack"] = unc["k3_stack"]
    kernels.append(unc["kernel"])


# ---------------------------------------------------------------------------
# phase planes: the storage layer's snapshot and forecast planes, full and
# delta publish, on phase uncertainty's 30,490-row registry
# ---------------------------------------------------------------------------

PLANES_PROBES = 200
PLANES_CHECK_ROWS = 512
PLANES_DELTA_FRAC = 0.01   # the delta version refits 1% of the rows
PLANES_HOT = (7, 14, 28)


def _plane_cols(prefix: str, vdir) -> dict:
    """Every column file ``<prefix>*.npy`` of a plane in ``vdir``, by its
    name, as host arrays."""
    import os

    return {n[len(prefix):-4]: np.load(os.path.join(vdir, n))
            for n in sorted(os.listdir(vdir))
            if n.startswith(prefix) and n.endswith(".npy")}


def _same_rows(got: dict, want: dict, rows) -> bool:
    return set(got) == set(want) and all(
        np.array_equal(got[k][rows], want[k][rows]) for k in want)


def phase_planes(unc, device) -> dict:
    """The storage layer on phase uncertainty's registry (``unc``: its
    registry, ADVI version, backend, fit inputs and posterior):
    ``fplane.maybe_publish`` of the version (K1 over every row at buckets
    8/16/32, counts set to 0 just before and read just after), both planes
    attached with their CRC sweeps, 200 requests served (plane hits; on
    512 rows x three horizons bitwise the engine's compute path, K1), a
    delta version (1% of the rows refitted warm through
    ``CudaBackend.fit``, ADVI on them, ``publish_delta``, the forecast and
    quantile planes' deltas): unchanged rows bitwise the base's, changed
    rows bitwise a full publish of the delta version; and a torn
    forecast-plane publish refused at attach and served by compute."""
    import os

    import torch

    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.resilience import faults
    from tsspark_tpu_torch.serve import (
        ForecastCache,
        PredictionEngine,
        fplane,
        snapplane,
    )
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import qplane

    t_phase = time.perf_counter()
    reg, v, bk, cfg = unc["registry"], unc["version"], unc["backend"], \
        unc["cfg"]
    ids = np.asarray(unc["ids"])
    n = len(ids)
    stages = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    reg.activate(v)
    vdir = reg.version_dir(v)
    require(snapplane.has_plane(vdir), "publish landed a snapshot plane")
    snap_bytes = snapplane.snapshot_nbytes(vdir)
    sdir = os.path.join(unc["root"], "scratch_snapshot_plane")
    os.makedirs(sdir)
    stage("snapshot_plane_write", snapplane.write_plane, sdir,
          reg.load(v).state, ids, extras={"step": np.ones(n)})
    torch.cuda.synchronize()
    fk.launches = 0
    pub = stage("fplane_publish", fplane.maybe_publish, reg, v, bk,
                horizons=PLANES_HOT)
    k1_publish = fk.launches
    require(pub is not None and pub["status"] == "published"
            and pub["buckets"] == [8, 16, 32], f"fplane publish: {pub}")
    require(k1_publish > 0, "the forecast plane's publish ran K1")
    snap_ok = stage("snapshot_plane_crc_sweep", snapplane.verify_plane, vdir)
    f_ok = stage("fplane_crc_sweep", fplane.verify_plane, vdir)
    require(snap_ok and f_ok, "both planes pass their CRC sweeps")

    # 200 requests through the engine: plane hits.
    eng = PredictionEngine(reg, cache=ForecastCache(0), device=device)
    rng = np.random.default_rng(UNC_SEED)
    walls = []
    fk.launches = 0
    t0 = time.perf_counter()
    for _ in range(PLANES_PROBES):
        k = int(rng.integers(1, 9))
        sel = list(ids[np.sort(rng.choice(n, k, replace=False))])
        h = int(rng.choice(PLANES_HOT))
        t1 = time.perf_counter()
        res = eng.forecast(sel, h)
        walls.append((time.perf_counter() - t1) * 1e3)
        require(res.version == v and res.from_cache == len(sel),
                "a hot request served from the plane")
    stages["reads"] = time.perf_counter() - t0
    reads = {"probes": PLANES_PROBES,
             "p50_ms": float(np.percentile(walls, 50)),
             "p99_ms": float(np.percentile(walls, 99)),
             "plane_hits": eng.stats.plane_hits,
             "plane_misses": eng.stats.plane_misses,
             "k1_launches": fk.launches}
    require(eng.stats.dispatches == 0 and fk.launches == 0,
            f"plane hits need no dispatch: {reads}")
    # On 512 rows the plane hits are the compute path's bits (K1).
    sel = list(ids[:PLANES_CHECK_ROWS])
    eng_c = PredictionEngine(reg, cache=ForecastCache(0), device=device)
    eng_c._planes = {v: None}
    fk.launches = 0
    for h in PLANES_HOT:
        hit, comp = eng.forecast(sel, h), eng_c.forecast(sel, h)
        require(np.array_equal(hit.ds, comp.ds) and set(hit.values)
                == set(comp.values) and all(
                    np.array_equal(hit.values[k], comp.values[k])
                    for k in comp.values),
                f"plane hits != the compute path at h={h}")
    k1_compute = fk.launches
    require(k1_compute > 0, "the compute path ran K1")

    # The delta version: 1% of the rows refitted warm on the same history.
    changed = np.linspace(0, n - 1, int(round(n * PLANES_DELTA_FRAC))) \
        .astype(np.int64)
    snap1 = reg.load(v)
    theta1 = snap1.state.theta
    ds_fit, y_fit, m_fit = unc["ds_fit"], unc["y_fit"], unc["m_fit"]
    sub = stage("delta_refit", bk.fit, ds_fit, y_fit[changed],
                mask=m_fit[changed],
                init=theta1[torch.as_tensor(changed)].clone())
    sub_np, _ = prepare_fit_data(ds_fit, y_fit[changed], cfg,
                                 mask=m_fit[changed])
    th_sub = np.nan_to_num(sub.theta.cpu().numpy().astype(np.float32))
    post_sub = stage("delta_advi", advi_mod.fit_advi, th_sub, sub_np,
                     torch.Generator(device=device).manual_seed(UNC_SEED + 2),
                     cfg, device=device)
    v2 = stage("publish_delta", reg.publish_delta, sub, changed,
               step_sub=np.ones(len(changed)))
    post = unc["posterior"]
    mu, rho, elbo = (np.array(x) for x in post)
    mu[changed] = post_sub.mu.cpu().numpy()
    rho[changed] = post_sub.rho.cpu().numpy()
    elbo[changed] = post_sub.elbo.cpu().numpy()
    post2 = advi_mod.AdviPosterior(mu=mu, rho=rho, elbo=elbo)
    advi_mod.save_posterior(reg.version_dir(v2), post2, seed=UNC_SEED,
                            num_steps=unc["advi_steps"])
    fk.launches = 0
    fpub2 = stage("fplane_publish_delta", fplane.maybe_publish, reg, v2, bk)
    k1_delta = fk.launches
    qpub2 = stage("qplane_publish_delta", qplane.maybe_publish, reg, v2, bk)
    require(fpub2 is not None and fpub2["status"] == "published-delta",
            f"fplane delta: {fpub2}")
    require(qpub2 is not None and qpub2["status"] == "published-delta"
            and qpub2["mode"] == "advi", f"qplane delta: {qpub2}")
    vdir2 = reg.version_dir(v2)
    keep = np.setdiff1d(np.arange(n), changed)
    snap2 = reg.load()
    require(snap2.version == v2 and snap2.source == "mmap",
            "the delta version is active and served from its plane")
    # A full publish of the delta version's state, beside it.
    full_dir = os.path.join(unc["root"], "full_delta")
    os.makedirs(full_dir)
    state2 = snap2.state._replace(theta=snap2.state.theta.clone())
    stage("snapshot_plane_full_of_delta", snapplane.write_plane, full_dir,
          state2, ids, extras={"step": np.ones(n)})
    stage("fplane_full_of_delta", fplane.write_plane, full_dir, snap2, bk)
    checks = {}
    for name, prefix in (("snapshot", snapplane.COL_PREFIX),
                         ("forecast", fplane.FCOL_PREFIX)):
        base, delta, full = (_plane_cols(prefix, d)
                             for d in (vdir, vdir2, full_dir))
        checks[name] = {
            "unchanged_rows_bitwise_base": _same_rows(delta, base, keep),
            "changed_rows_bitwise_full": _same_rows(delta, full, changed),
            "columns": len(delta)}
        require(checks[name]["unchanged_rows_bitwise_base"]
                and checks[name]["changed_rows_bitwise_full"],
                f"{name} plane delta: {checks[name]}")
    links = [nm for nm in os.listdir(vdir2)
             if nm.startswith(snapplane.COL_PREFIX)
             and os.path.samefile(os.path.join(vdir, nm),
                                  os.path.join(vdir2, nm))]
    require({"snapcol_ids.npy", "snapcol_ids_sorted.npy",
             "snapcol_id_order.npy"} <= set(links),
            f"the id index hardlinked from the base: {links}")
    # The quantile plane: unchanged rows the base's bytes, changed rows
    # the full publish's per-row function (compute_rows on those rows,
    # keyed on (seed, row)).
    qb, qd = qplane.attach(vdir), qplane.attach(vdir2)
    q_ok = {"unchanged_rows_bitwise_base": True,
            "changed_rows_bitwise_full": True}
    for hb in qd.buckets:
        ref = qplane.compute_rows(snap2, cfg, bk, changed, hb,
                                  posterior=post2)
        for pm, col in qd.columns[hb].items():
            col = np.asarray(col)
            q_ok["unchanged_rows_bitwise_base"] &= bool(np.array_equal(
                col[keep], np.asarray(qb.columns[hb][pm])[keep]))
            q_ok["changed_rows_bitwise_full"] &= bool(np.array_equal(
                col[changed], ref[pm]))
    checks["quantile"] = q_ok
    require(all(q_ok.values()), f"quantile plane delta: {q_ok}")
    eng2 = PredictionEngine(reg, cache=ForecastCache(0), device=device)
    sel2 = list(ids[changed[:64]])
    res2 = eng2.forecast(sel2, 14)
    require(res2.version == v2 and eng2.stats.plane_hits == len(sel2),
            "the delta version served from its forecast plane")

    # A torn forecast-plane publish: refused at attach, served by compute.
    v3 = reg.publish_delta(None, [])
    vdir3 = reg.version_dir(v3)
    plan = faults.FaultPlan(state_dir=os.path.join(unc["root"], "faults"))
    plan.fail("fplane_publish", after=5)
    os.environ[faults.ENV_VAR] = plan.to_env()
    try:
        fplane.write_plane(vdir3, reg.load(v3), bk)
        torn = False
    except faults.FaultInjected:
        torn = True
    finally:
        os.environ.pop(faults.ENV_VAR, None)
    refused = False
    try:
        fplane.attach(vdir3)
    except fplane.ForecastPlaneError as e:
        refused = e.reason == "corrupt"
    eng3 = PredictionEngine(reg, cache=ForecastCache(0), device=device)
    fk.launches = 0
    sel3 = list(ids[changed[:64]])
    res3 = eng3.forecast(sel3, 14)
    k1_torn = fk.launches
    hit2 = eng2.forecast(sel3, 14)
    require(torn and refused, f"torn forecast plane: raised {torn}, "
            f"refused at attach {refused}")
    require(res3.version == v3 and eng3.stats.plane_hits == 0
            and eng3.stats.plane_misses == len(sel3) and k1_torn > 0,
            "the torn version served through the compute path")
    require(all(np.array_equal(res3.values[k], hit2.values[k])
                for k in hit2.values),
            "compute over the torn version != the same rows' plane hits")
    out = {
        "phase": "planes", "series": n, "version": v,
        "stages_s": stages,
        "snapshot_plane": {"nbytes": snap_bytes, "crc_ok": snap_ok},
        "fplane": {"publish_s": pub["publish_s"], "nbytes": pub["nbytes"],
                   "buckets": pub["buckets"], "k1_launches": k1_publish,
                   "crc_ok": f_ok},
        "reads": reads,
        "plane_vs_compute": {"rows": PLANES_CHECK_ROWS,
                             "horizons": list(PLANES_HOT),
                             "bitwise": True, "k1_launches": k1_compute},
        "delta": {"version": v2, "changed": int(len(changed)),
                  "fplane": {k: fpub2[k] for k in ("publish_s", "nbytes")},
                  "fplane_k1_launches": k1_delta,
                  "qplane": {k: qpub2[k] for k in ("publish_s", "nbytes",
                                                   "mode")},
                  "hardlinked_snapshot_columns": len(links),
                  "checks": checks},
        "torn": {"version": v3, "raised": torn, "refused_at_attach": refused,
                 "served_by_compute_k1_launches": k1_torn,
                 "bitwise_the_planes_rows": True},
        "launches_forward": k1_publish + k1_compute + k1_delta + k1_torn,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


# The data plane (phase dataplane): the M5 fleet the JAX package's bench
# reads for BASELINE.json:2 (``DatasetSpec("m5", 30490, 1941, seed=2)``,
# y, mask and three regressors as float32 columns, ~1.18 GB) and an
# 8,192-row cold-start fleet, ingested by ``data.ingest.IngestDriver``
# child processes (DP_PROCESSES shard workers each) into a temporary root
# from the top of ``main``, beside the card's phases and the parity
# workers.  The oracle subsets are read off landed shards (``ready_coverage``
# / ``covers``) and handed to the parity workers as their shards land: 64
# fleet rows (``fleet_subset``) and DP_COLD_SUBSET cold-start rows, half of
# them late launches with at least DP_LATE_MIN_DAYS observed training days
# (a late launch with fewer has no train sMAPE to hold).  Both fits are
# ``CudaBackend.fit_twophase`` at DP_PHASE1 phase-1 iterations on days
# [0, 1746), config 3's model, held against the scipy oracle: train
# sMAPE mean within 0.05 (the phase fit's budget) and per series within
# DP_SERIES_TOL = 0.25, the JAX package's own train-parity gate for config
# 3 on this shape (tests/test_backends.py:128-139, there a p95; here every
# series).  The phase fit's 0.1 per series does not hold for the
# two-phase policy itself: it has no rescue pass (the speed-first entry
# point, tsspark_tpu/backends/tpu.py:774-780), and on the 64-row subset
# series 16938 ends 0.1627 above the oracle in the JAX package's own
# ``fit_twophase`` (the CPU) as in the port's (0.1628 on the CPU, 0.1627
# on the card), where ``fit`` with its rescue pass reads 0.046
# (tests/test_torch_twophase.py ``-m slow`` prints them).  Other rows:
# <= 0.047 on the fleet, <= 0.044 on the cold start; stragglers patched
# back in phase 2's order read 28.0.
DP_PROCESSES = 2
DP_PHASE1 = 12
DP_COLD_SERIES = 8192
DP_COLD_SUBSET = 32
DP_LATE_MIN_DAYS = 100
DP_SERIES_TOL = 0.25
DP_MEAN_TOL = 0.05


def dp_specs() -> dict:
    from tsspark_tpu_torch.data import plane

    return {"fleet": plane.DatasetSpec("m5", FULL_SERIES, FULL_DAYS, seed=2),
            "cold": plane.DatasetSpec("m5_cold_start", DP_COLD_SERIES,
                                      FULL_DAYS, seed=2)}


def dp_cold_rows(mask, lo: int, per_shard: int) -> np.ndarray:
    """The cold-start oracle rows of one landed shard (``mask`` its rows,
    starting at row ``lo``): ``per_shard // 2`` late launches (first
    observed day at 70% of the calendar or later, with at least
    DP_LATE_MIN_DAYS observed training days) and as many early ones (first
    observed day in the first third), each spread over the shard."""
    from tsspark_tpu_torch.eval import configs

    split = configs.split_point(FULL_DAYS)
    obs = np.asarray(mask)[:, :split] > 0
    first = np.where(obs.any(1), obs.argmax(1), FULL_DAYS)
    late = np.flatnonzero((first >= int(0.70 * FULL_DAYS))
                          & (obs.sum(1) >= DP_LATE_MIN_DAYS))
    early = np.flatnonzero(first < FULL_DAYS // 3)
    k = per_shard // 2
    pick = lambda a: a[np.linspace(0, len(a) - 1, k).astype(int)]  # noqa: E731
    require(len(late) >= k and len(early) >= k,
            f"cold-start shard at {lo}: {len(late)} late, {len(early)} early")
    return lo + np.sort(np.concatenate([pick(late), pick(early)]))


def dp_oracle_job(run, dset_dir, rows) -> object:
    """Submit the scipy oracle's config-3 fit of ``rows`` (read off the
    landed columns) on days [0, 1746), with its yhat over 1,941 days."""
    from tsspark_tpu_torch.eval import configs

    split = configs.split_point(FULL_DAYS)
    col = lambda f: np.load(os.path.join(dset_dir, f"{f}.npy"),  # noqa: E731
                            mmap_mode="r")
    ds = np.load(os.path.join(dset_dir, "ds.npy"))
    y, m, r = (np.array(col(f)[rows]) for f in ("y", "mask", "reg"))
    return run(parity_job, ("oracle", 3, ds[:split], y[:, :split],
                            dict(mask=m[:, :split], regressors=r[:, :split]),
                            ds, r))


class DataplaneIngest:
    """Phase dataplane's ingest, started at the top of ``main``: an
    ``IngestDriver`` child for the fleet, then one for the cold-start
    fleet, under a temporary root; a watcher thread reads each oracle
    subset's rows off landed shards and submits them to the parity pool
    as they land.  A child that exits non-zero fails the phase (``wait``
    raises it); ``close`` kills the children and removes the root."""

    def __init__(self, parity):
        import threading

        from tsspark_tpu_torch.data import plane

        self.root = tempfile.mkdtemp(prefix="dataplane_")
        self.specs = dp_specs()
        self.dirs = {k: plane.dataset_dir(s, self.root)
                     for k, s in self.specs.items()}
        self.jobs = {"fleet": [], "cold": []}
        self.events = {}
        self.error = None
        self._drivers = []
        self._parity = parity
        self._stop = threading.Event()
        self.t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            fleet = fleet_subset()
            self._ingest("fleet", lambda mask, lo, hi: fleet[
                (fleet >= lo) & (fleet < hi)])
            per = DP_COLD_SUBSET * self.specs["cold"].shard_rows \
                // DP_COLD_SERIES
            self._ingest("cold", lambda mask, lo, hi: dp_cold_rows(
                mask, lo, per))
        except Exception as e:  # re-raised in the phase by wait()
            self.error = e

    def _ingest(self, which: str, rows_of) -> None:
        from tsspark_tpu_torch.data import ingest, plane

        spec, d = self.specs[which], self.dirs[which]
        drv = ingest.IngestDriver.start(spec, root=self.root,
                                        processes=DP_PROCESSES)
        self._drivers.append(drv)
        self.events[f"{which}_started_s"] = time.perf_counter() - self.t0
        pending = list(plane.shard_ranges(spec))
        while pending and not self._stop.is_set():
            rc = drv.proc.poll()
            ready = plane.ready_coverage(d, spec.n_series)
            landed = [(lo, hi) for lo, hi in pending
                      if ready is None or plane.covers(ready, lo, hi)]
            for lo, hi in landed:
                pending.remove((lo, hi))
                mask = np.load(os.path.join(d, "mask.npy"),
                               mmap_mode="r")[lo:hi]
                rows = rows_of(mask, lo, hi)
                if len(rows):
                    self.jobs[which].append((rows, dp_oracle_job(
                        self._parity.pool.apply_async, d, rows)))
            if rc is not None and pending and not landed:
                raise RuntimeError(
                    f"ingest of {spec.cache_key()} exited {rc} with "
                    f"{len(pending)} shards missing")
            if pending:
                time.sleep(0.2)
        rc = drv.wait()
        if rc != 0:
            raise RuntimeError(f"ingest of {spec.cache_key()} exited {rc}")
        self.events[f"{which}_done_s"] = time.perf_counter() - self.t0

    def wait(self) -> float:
        """Join the ingest (both children); raises what failed there.
        Returns the seconds waited."""
        t0 = time.perf_counter()
        self._thread.join()
        if self.error is not None:
            raise RuntimeError(f"dataplane ingest failed: {self.error!r}") \
                from self.error
        return time.perf_counter() - t0

    def close(self) -> None:
        import shutil

        self._stop.set()
        for drv in self._drivers:
            drv.kill()
            drv.wait(timeout=30)
        self._thread.join(timeout=30)
        shutil.rmtree(self.root, ignore_errors=True)


def dp_oracle(jobs) -> tuple:
    """(rows, oracle yhat over 1,941 days, oracle seconds) of a subset's
    jobs, in row order."""
    rows, yhat, secs = [], [], 0.0
    for r, job in jobs:
        got = job.get()
        rows.append(r)
        yhat.append(got["yhat"])
        secs += got["seconds"]
    order = np.argsort(np.concatenate(rows))
    return (np.concatenate(rows)[order], np.concatenate(yhat)[order], secs)


def dp_budget(batch, yhat, rows, oracle_yhat) -> dict:
    """Per-series train (and holdout, reported) sMAPE of ``yhat`` on
    ``rows`` against the oracle's, and the budget's verdict."""
    from tsspark_tpu_torch.eval import configs

    sub = batch._replace(y=np.asarray(batch.y[rows]),
                         mask=np.asarray(batch.mask[rows]))
    got = configs.score(sub, {"yhat": yhat})
    want = configs.score(sub, {"yhat": oracle_yhat})
    d_train = got["smape_train"] - want["smape_train"]
    d_hold = got["smape_holdout"] - want["smape_holdout"]
    return {"rows": int(len(rows)),
            "smape_train_max_abs_delta": float(np.abs(d_train).max()),
            "series_over_0.1": [int(r) for r in rows[np.abs(d_train) > 0.1]],
            "smape_train_mean_delta": float(d_train.mean()),
            "smape_holdout_max_abs_delta": float(np.nanmax(np.abs(d_hold))),
            "smape_holdout_mean_delta": float(np.nanmean(d_hold)),
            "within_budget": bool(
                np.all(np.abs(d_train) <= DP_SERIES_TOL)
                and abs(d_train.mean()) <= DP_MEAN_TOL)}


def dp_forecast_rows(bk, state, batch, rows) -> np.ndarray:
    """Deterministic yhat over 1,941 days of ``state``'s ``rows``."""
    from tsspark_tpu_torch.backends.cuda import _take_rows

    return bk.predict(_take_rows(state, rows), batch.ds,
                      regressors=np.asarray(batch.regressors[rows]),
                      num_samples=0)["yhat"]


def dp_held(bk, cfg, theta, ds, y, m, r, device, what: str) -> tuple:
    """K3 (both modes) and K4 by GAP_RULE (``hold_kernels``) at ``theta``
    on a batch cut the way ``bk.fit`` cuts it: each length bucket's
    rows on its window (the whole when the plan declines), a chunk of at
    most ``bk.chunk_size`` rows at a time, observed rows by
    ``hold_observed``, rows with no observed cell (phase 2's inert
    padding, late launches outside the window) by ``hold_inert``; each
    shape timed whole against its bound and its plain version.  Returns
    (plan, [per shape])."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.design import (
        fitdata_to_device,
        prepare_fit_data,
    )

    plan = bk._plan_length_buckets(y, m)
    parts = plan or [(np.arange(y.shape[0]), 0, len(ds))]
    gen = torch.Generator(device=device).manual_seed(16)
    out = []
    for idx, lo, hi in parts:
        for c0 in range(0, len(idx), bk.chunk_size):
            rows = np.asarray(idx[c0:c0 + bk.chunk_size])
            data = fitdata_to_device(prepare_fit_data(
                ds[lo:hi], y[rows, lo:hi], cfg, mask=m[rows, lo:hi],
                regressors=r[rows, lo:hi])[0], device)
            th = theta[torch.as_tensor(rows)].to(device).contiguous()
            d = 0.02 * torch.randn(th.shape, generator=gen, device=device)
            seen = np.asarray(m[rows, lo:hi]).any(axis=1)
            part = f"{what}, rows {len(rows)}, [{lo}, {hi})"
            obs_i = torch.as_tensor(np.flatnonzero(seen), device=device)
            held = hold_observed(th[obs_i], d[obs_i], _rows(data, obs_i),
                                 cfg, part) if seen.any() else None
            inert = hold_inert(
                th[~torch.as_tensor(seen, device=device)],
                d[~torch.as_tensor(seen, device=device)],
                _rows(data, torch.as_tensor(np.flatnonzero(~seen),
                                            device=device)),
                cfg, part) if not seen.all() else None
            b, t_len = data.t.shape
            ladder = _ladder(b, device)
            out.append({
                "rows": int(b), "window": [int(lo), int(hi)],
                "observed_rows": int(seen.sum()),
                "gap": None if held is None else held["gap"],
                "planted_dropped_cell": None if held is None
                else held["planted_dropped_cell"],
                "vs_f64": None if held is None else held["vs_f64"],
                "inert_rows": int((~seen).sum()), "inert": inert,
                "loss_ms": cuda_ms(lambda: lk.loss(th, data, cfg)),
                "loss_plain_ms": cuda_ms(lambda: lk.loss_plain(th, data, cfg),
                                         iters=3, warmup=1),
                **loss_bound_ms(b, b, t_len, cfg, True),
                "loss_value_ms": cuda_ms(lambda: lk.loss(th, data, cfg,
                                                         grad=False)),
                "fan_ms": cuda_ms(lambda: fan_k.fan(th, d, ladder, data,
                                                    cfg)),
                "fan_plain_ms": cuda_ms(lambda: fan_k.fan_plain(
                    th, d, ladder, data, cfg), iters=3, warmup=1),
                "fan_bound_ms": fan_bound_ms(b, t_len, 20, cfg)["bound_ms"]})
            del data
    return plan, out


def _row_gaps(got, want, scale, t_len):
    """Per row (the last axis of a (K, B) fan, the first of (B,) and
    (B, P)), max |got - want| / (T * eps * scale) in float64."""
    eps = float(np.finfo(np.float32).eps)
    e = (got.double() - want.double()).abs()
    if e.ndim == 2 and scale.ndim == 1:  # (B, P) gradient
        return (e / (t_len * eps * scale.double()[:, None])).amax(-1)
    e = e / (t_len * eps * scale.double())
    return e.amax(0) if e.ndim == 2 else e  # (K, B) fan, or (B,)


# Rows whose residuals float32 cannot resolve: a late launch with a few
# observed cells in its window is interpolated exactly (sigma at its
# floor), so y - yhat is float32 noise of |y| that 1/sigma^2 amplifies,
# and GAP_RULE's scale (which counts |y - yhat|, not |y| + |yhat|) no
# longer bounds two float32 evaluations' distance.  There K3/K4 are held
# to the plain version in float64: no farther from it than GAP_TOL or
# DP_F64_FACTOR times the plain float32 version's own distance (card,
# the cold-start plane's [1490, 1746) bucket: 78 rows of at most 15
# observed cells, plain float32 up to 427 units off float64, the kernels
# up to 2.76 times that).  Rows float32 resolves with room (the plain
# version within GAP_TOL / 10 of float64) are also held by GAP_RULE
# against the plain version, with the dropped-cell check.
DP_F64_FACTOR = 4.0


def hold_observed(theta, d, data, cfg, what: str) -> dict:
    """K3 (both modes) and K4 against their plain version in float64 on
    rows with observed cells (every row: within max(GAP_TOL,
    DP_F64_FACTOR x the plain float32 version's distance), in GAP_RULE's
    unit), and by ``hold_kernels`` (GAP_RULE against the plain float32
    version, the dropped cell) on the rows float32 resolves with room."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = data.t.shape
    ladder = _ladder(b, data.t.device)
    data64 = data._replace(**{f: getattr(data, f).double()
                              for f in data._fields})
    f64, g64 = lk.loss_plain(theta.double(), data64, cfg)
    fan64 = fan_k.fan_plain(theta.double(), d.double(), ladder.double(),
                            data64, cfg)
    del data64
    f_p, g_p = lk.loss_plain(theta, data, cfg)
    fan_p = fan_k.fan_plain(theta, d, ladder, data, cfg)
    f_k, g_k = lk.loss(theta, data, cfg)
    v_k, _ = lk.loss(theta, data, cfg, grad=False)
    fan_g = fan_k.fan(theta, d, ladder, data, cfg)
    f_sc, g_sc = loss_scales(theta, data, cfg)
    fan_sc = fan_scale(theta, d, ladder, data, cfg)
    plain64 = torch.stack([_row_gaps(f_p, f64, f_sc, t_len),
                           _row_gaps(g_p, g64, g_sc, t_len),
                           _row_gaps(fan_p, fan64, fan_sc, t_len)]).amax(0)
    k64 = torch.stack([_row_gaps(f_k, f64, f_sc, t_len),
                       _row_gaps(g_k, g64, g_sc, t_len),
                       _row_gaps(v_k, f64, f_sc, t_len),
                       _row_gaps(fan_g, fan64, fan_sc, t_len)]).amax(0)
    limit = torch.clamp(DP_F64_FACTOR * plain64, min=GAP_TOL)
    well = plain64 <= GAP_TOL / 10
    out = {"rows": int(b), "resolved_rows": int(well.sum()),
           "gap": None, "planted_dropped_cell": None,
           "vs_f64": {"kernels_max": float(k64.max()),
                      "plain_f32_max": float(plain64.max()),
                      "kernels_over_limit_max": float((k64 / limit).max()),
                      "unresolved_rows": int((~well).sum()),
                      "unresolved_observed_cells_max": float(
                          data.mask[~well].sum(-1).max())
                      if bool((~well).any()) else 0.0,
                      "tolerance": f"kernel vs float64 <= max(GAP_TOL, "
                                   f"{DP_F64_FACTOR} x plain float32 vs "
                                   f"float64) per row"}}
    require(bool((k64 <= limit).all()),
            f"K3/K4 on {what} against float64: {out['vs_f64']}")
    if bool(well.any()):
        idx = torch.nonzero(well)[:, 0]
        held = hold_kernels(theta[idx].contiguous(), d[idx].contiguous(),
                            _rows(data, idx), cfg, what)
        out["gap"] = held["gap"]
        out["planted_dropped_cell"] = held["planted_dropped_cell"]
    return out


# Rows with no observed cell (phase 2's padding): their loss is the P
# prior terms alone, which GAP_RULE's data-term scale does not count, so
# K3 and K4 are held there to a float32 P-term sum's relative error.
INERT_TOL = 1e-5
INERT_RULE = f"|k-p| <= {INERT_TOL} * (1 + |p|) per row (priors only)"


def hold_inert(theta, d, data, cfg, what: str) -> dict:
    """K3 (both modes) and K4 (along ``d``) against their plain versions
    on rows with no observed cell, by INERT_RULE (required)."""
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    b = data.t.shape[0]
    f_k, g_k = lk.loss(theta, data, cfg)
    v_k, _ = lk.loss(theta, data, cfg, grad=False)
    f_p, g_p = lk.loss_plain(theta, data, cfg)
    ladder = _ladder(b, data.t.device)
    rel = lambda k, p: float(((k - p).abs() / (1.0 + p.abs())).max())  # noqa: E731,E501
    out = {"rows": int(b), "tolerance": INERT_RULE,
           "rel": {"f": rel(f_k, f_p), "g": rel(g_k, g_p),
                   "value": rel(v_k, f_p),
                   "fan": rel(fan_k.fan(theta, d, ladder, data, cfg),
                              fan_k.fan_plain(theta, d, ladder, data,
                                              cfg))}}
    require(max(out["rel"].values()) <= INERT_TOL,
            f"K3/K4 on {what}'s inert rows: {out}")
    return out


def _plan_json(plan):
    return None if plan is None else [
        {"rows": int(len(i)), "window": [int(lo), int(hi)]}
        for i, lo, hi in plan]


def dp_fit(device, batch, what: str) -> dict:
    """``CudaBackend.fit_twophase`` of config 3 on ``batch``'s days [0,
    1746) (launch counts set to 0 just before, read just after), then the
    forecast over 1,941 days (K1; counted on its own)."""
    import torch

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.models.prophet import init as init_mod

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    split = configs.split_point(FULL_DAYS)
    ds_fit = np.asarray(batch.ds)[:split]
    y_fit, m_fit = batch.y[:, :split], batch.mask[:, :split]
    r_fit = batch.regressors[:, :split]
    bk = get_backend("cuda", cfg, solver, device=device)
    plan = bk._plan_length_buckets(y_fit, m_fit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    init_mod.float64_rows = 0
    _zero_counts()
    t0 = time.perf_counter()
    state = bk.fit_twophase(ds_fit, y_fit, mask=m_fit, regressors=r_fit,
                            phase1_iters=DP_PHASE1)
    fit_s = time.perf_counter() - t0
    launches = _stream_counts()
    f64_rows = init_mod.float64_rows
    stages = dict(bk.stages.seconds)
    peak = torch.cuda.max_memory_allocated()
    two = dict(bk.twophase)
    bk.stages.reset()
    _zero_counts()
    t0 = time.perf_counter()
    fc = bk.predict(state, batch.ds, regressors=batch.regressors,
                    num_samples=0)
    predict_s = time.perf_counter() - t0
    forecast_launches = _stream_counts()["forward"]
    n = batch.y.shape[0]
    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["fan"] > 0 and forecast_launches > 0,
            f"{what}: K3, K4 and K1 launched: {launches}, "
            f"forward {forecast_launches}")
    require(tuple(state.theta.shape) == (n, cfg.num_params)
            and bool(torch.isfinite(state.theta).all())
            and bool(np.isfinite(state.loss).all()), f"{what}: fit finite")
    require(fc["yhat"].shape == (n, FULL_DAYS)
            and bool(np.isfinite(fc["yhat"]).all()), f"{what}: forecast")
    sc = configs.score(batch, fc)
    status = np.bincount(np.asarray(state.status), minlength=5)
    out = {"series": int(n), "days_fit": split, "fit_s": fit_s,
           "stages_s": stages, "phase1_iters": DP_PHASE1,
           "phase1_converged": two["phase1_converged"],
           "stragglers": two["stragglers"],
           "phase2_rows": two["phase2_rows"],
           "phase2_s": stages.get("phase2", 0.0),
           "length_buckets": _plan_json(plan),
           "launches": launches, "forecast_launches_forward":
           forecast_launches,
           "ridge_float64_rows": f64_rows,
           "status_counts": {"running": int(status[0]), "gtol": int(status[1]),
                             "ftol": int(status[2]), "floor": int(status[3]),
                             "stalled": int(status[4])},
           "iterations": {"mean": float(np.mean(state.n_iters)),
                          "max": int(np.max(state.n_iters))},
           "peak_device_bytes": peak, "predict_s": predict_s,
           "smape_train": float(np.nanmean(sc["smape_train"])),
           "smape_holdout": float(np.nanmean(sc["smape_holdout"]))}
    return {"out": out, "bk": bk, "state": state, "order": two.get("order"),
            "fc": fc, "plan": plan}


def phase_dataplane(device, ing) -> dict:
    """The data plane and the plane-fed two-phase fit (see DataplaneIngest
    and the comment above DP_PROCESSES): the ingest's report; every fleet
    shard verified; three shards bitwise against direct generation; a
    warm ``ensure``; a torn shard refused and repaired bitwise; the
    two-phase fit of the 30,490 rows off the memmaps, its forecast, the
    subset within the budget of the oracle, a planted fault (stragglers
    patched back in phase 2's order, not by row) failing it, K3/K4 by
    GAP_RULE on phase 2's chunk; then the cold-start plane's two-phase fit
    through its length buckets, K3/K4 at each bucket's shape, its subset
    held the same way."""
    import torch

    from tsspark_tpu_torch.data import datasets, ingest, plane
    from tsspark_tpu_torch.eval import configs

    wait_s = ing.wait()
    spec, d = ing.specs["fleet"], ing.dirs["fleet"]
    res = {"phase": "dataplane", "root_wait_s": wait_s,
           "ingest_processes": DP_PROCESSES, "ingest_events_s": ing.events}
    for which in ("fleet", "cold"):
        rep = ingest.read_ingest_report(ing.dirs[which])
        nbytes = sum(os.path.getsize(os.path.join(ing.dirs[which], n))
                     for n in os.listdir(ing.dirs[which])
                     if n.endswith(".npy"))
        res[f"ingest_{which}"] = {
            k: rep[k] for k in ("wall_s", "first_shard_s", "last_shard_s",
                                "shards_produced", "shards_total",
                                "processes")}
        res[f"ingest_{which}"]["bytes"] = nbytes
    ranges = plane.shard_ranges(spec)
    t0 = time.perf_counter()
    bad = [r for r in ranges if not plane.verify_shard(d, *r)]
    res["verify"] = {"shards": len(ranges), "bad": bad,
                     "seconds": time.perf_counter() - t0}
    require(len(ranges) == -(-spec.n_series // spec.shard_rows) and not bad,
            f"shards verified: {res}")

    batch = plane.open_batch(d)
    picks = (0, len(ranges) // 2, len(ranges) - 1)
    direct = {}
    for i in picks:
        lo, hi = ranges[i]
        want = plane.batch_columns(datasets.m5_rows(lo, hi, FULL_DAYS,
                                                    seed=spec.seed))
        same = {f: np.asarray(batch.y if f == "y" else batch.mask
                              if f == "mask" else batch.regressors)[lo:hi]
                .tobytes() == want[f].tobytes() for f in ("y", "mask", "reg")}
        direct[f"{lo}:{hi}"] = same
        require(all(same.values()), f"shard [{lo}, {hi}) vs m5_rows: {same}")
    require(ranges[-1][1] - ranges[-1][0] == FULL_SERIES % spec.shard_rows,
            f"the last shard is partial: {ranges[-1]}")
    res["shards_bitwise_direct"] = direct
    t0 = time.perf_counter()
    hit = plane.ensure(spec, root=ing.root)
    res["warm_ensure_ms"] = 1e3 * (time.perf_counter() - t0)
    require(hit == d, "warm ensure hit")

    # A torn shard: refused, then repaired to its bytes.
    lo, hi = ranges[len(ranges) // 4]
    before = np.array(batch.y[lo:hi])
    mm = np.lib.format.open_memmap(os.path.join(d, "y.npy"), mode="r+")
    mm[lo + 5, 100:140] = -7.0
    mm.flush()
    del mm
    refused = not plane.verify_shard(d, lo, hi)
    t0 = time.perf_counter()
    repaired = plane.repair(spec, root=ing.root)
    repair_s = time.perf_counter() - t0
    batch = plane.open_batch(d)
    restored = np.asarray(batch.y[lo:hi]).tobytes() == before.tobytes()
    res["torn_shard"] = {"shard": [lo, hi], "refused": refused,
                         "repaired": [list(r) for r in repaired],
                         "repair_s": repair_s, "restored_bitwise": restored,
                         "complete": plane.is_complete(d)}
    require(refused and repaired == [(lo, hi)] and restored
            and plane.is_complete(d) and plane.verify_shard(d, lo, hi),
            f"torn shard: {res['torn_shard']}")
    del before

    # The two-phase fit of the fleet off the memmaps.
    fit = dp_fit(device, batch, "the fleet")
    rows, o_yhat, o_secs = dp_oracle(ing.jobs["fleet"])
    require(rows.tolist() == fleet_subset().tolist(), "the fleet subset")
    budget = dp_budget(batch, fit["fc"]["yhat"][rows], rows, o_yhat)
    budget["oracle_s"] = o_secs
    # Planted fault: phase 2's rows patched back in its own (difficulty)
    # order, not by their row index.
    order = fit["order"]
    wrong = fit["state"]
    if order is not None and len(order):
        from tsspark_tpu_torch.backends.cuda import _take_rows, patch_state

        wrong = patch_state(fit["state"], np.sort(order),
                            _take_rows(fit["state"], order))
    fault_rows = np.intersect1d(rows, order if order is not None else [])
    planted = dp_budget(batch, dp_forecast_rows(fit["bk"], wrong, batch, rows),
                        rows, o_yhat)
    planted["straggler_rows_in_subset"] = int(len(fault_rows))
    cfg = configs.CONFIG3
    split = configs.split_point(FULL_DAYS)
    held = None
    if order is not None and len(order):
        # Phase 2's first chunk: the hardest stragglers, padded with inert
        # all-masked rows to the chunk's width, as fit_twophase builds it.
        c = min(fit["bk"].chunk_size, fit["out"]["phase2_rows"])
        p2 = order[:c]
        pad = c - len(p2)
        padf = lambda a: np.concatenate(  # noqa: E731
            [np.asarray(a), np.zeros((pad,) + a.shape[1:], a.dtype)])
        th = fit["state"].theta[torch.as_tensor(p2)]
        th = torch.cat([th, th.new_zeros((pad, th.shape[1]))])
        plan2, held = dp_held(
            fit["bk"], cfg, th, batch.ds[:split],
            padf(batch.y[p2, :split]), padf(batch.mask[p2, :split]),
            padf(batch.regressors[p2, :split]), device, "phase 2's chunk")
        held = {"rows": int(c), "stragglers": int(len(p2)),
                "length_buckets": _plan_json(plan2), "shapes": held}
    res["fit"] = {**fit["out"], "parity": budget, "planted_fault": planted,
                  "kernels_phase2_chunk": held}
    handoff = {"state": fit["state"], "order": order, "rows": rows,
               "oracle_yhat": o_yhat}
    del fit, wrong

    # The cold-start plane through length buckets.
    cbatch = plane.open_batch(ing.dirs["cold"])
    cold = dp_fit(device, cbatch, "the cold-start fleet")
    crows, co_yhat, co_secs = dp_oracle(ing.jobs["cold"])
    cbudget = dp_budget(cbatch, cold["fc"]["yhat"][crows], crows, co_yhat)
    cbudget["oracle_s"] = co_secs
    first = np.argmax(np.asarray(cbatch.mask[crows]) > 0, axis=1)
    cbudget["late_launches"] = int((first >= int(0.70 * FULL_DAYS)).sum())
    plan_c, cheld = (None, None)
    if cold["plan"] is not None:
        plan_c, cheld = dp_held(
            cold["bk"], cfg, cold["state"].theta, cbatch.ds[:split],
            cbatch.y[:, :split], cbatch.mask[:, :split],
            cbatch.regressors[:, :split], device, "a cold-start bucket")
    res["cold_start"] = {**cold["out"], "parity": cbudget,
                         "kernels_buckets": cheld}
    emit(res)
    require(budget["within_budget"],
            f"the fleet subset against the oracle: {budget}")
    require(len(fault_rows) > 0 and not planted["within_budget"],
            f"the planted fault passes the budget: {planted}")
    require(held is not None, "phase 2 ran")
    require(cbudget["within_budget"] and cbudget["rows"] == DP_COLD_SUBSET
            and cbudget["late_launches"] == DP_COLD_SUBSET // 2,
            f"the cold-start subset against the oracle: {cbudget}")
    res["handoff"] = handoff  # phase resilient's reference (not printed)
    return res


def _held_checks(name: str, shapes) -> list:
    """K3's (``name`` "loss") or K4's ("fan") entries of ``dp_held``'s
    per-shape holds, as the kernels line lists them."""
    key = "loss" if name == "loss" else "fan"
    return [{"rows": s["rows"], "window": s["window"],
             "gap": s["gap"] if name == "loss" or s["gap"] is None
             else s["gap"]["fan"],
             "vs_f64_over_limit": None if s["vs_f64"] is None
             else s["vs_f64"]["kernels_over_limit_max"],
             "inert_rel": None if s["inert"] is None else s["inert"]["rel"],
             "ms": s[f"{key}_ms"], "plain_ms": s[f"{key}_plain_ms"],
             "bound_ms": s["bound_ms"] if name == "loss"
             else s["fan_bound_ms"]}
            for s in shapes]


def add_dataplane(kernels, dp) -> None:
    """K1, K3 and K4's entries gain their launches on phase dataplane's
    two-phase fits and forecasts, and K3/K4 their GAP_RULE checks and
    event-timed ms on phase 2's chunk and the cold-start buckets."""
    fit, cold = dp["fit"], dp["cold_start"]

    def shapes(held):
        return [] if held is None else held if isinstance(held, list) \
            else held["shapes"]

    for k in kernels:
        name = k["name"]
        if name not in ("loss", "fan", "forward"):
            continue
        if name == "forward":
            k["launches_dataplane"] = fit["forecast_launches_forward"]
            k["launches_dataplane_cold"] = cold["forecast_launches_forward"]
            continue
        for tag, run, held in (
                ("dataplane", fit, fit["kernels_phase2_chunk"]),
                ("dataplane_cold", cold, cold["kernels_buckets"])):
            launch = run["launches"]
            k[f"launches_{tag}"] = (
                launch["loss_grad"] + launch["loss_value"]
                if name == "loss" else launch["fan"])
            k[f"{tag}_check"] = _held_checks(name, shapes(held))


# Phase resilient: the process-isolated two-phase fit of phase dataplane's
# fleet (orchestrate.fit_resilient), faulted twice through the fault plan
# in TSSPARK_FAULTS: the first worker exits right after landing its first
# chunk (RS_EXIT_RC), and the save of the chunk holding row RS_TORN_SERIES
# is torn.  Its rows that phase 1 converged must be fit_twophase's bits
# (the same 8,192-row chunks, the same phase-1 solver); its stragglers
# part from fit_twophase's by phase 2's batch composition (fit_twophase
# buckets them by length, the worker never does), so each is held on its
# loss to RS_LOSS_TOL, with the mean to PLAIN_MEAN_TOL.  RS_LOSS_TOL is
# loss_parity's limit for two float32 lockstep solvers (PLAIN_SERIES_TOL),
# measured here on the card (H100 80GB HBM3, 700 W): the 4,915 stragglers
# part by at most 1.148 nats (p99 0.358, median 0, mean -0.0014); the
# planted one-row-off assembly reads 2,196.8 on 1,307 of them, and fails
# the bitwise rows first.  Then a clean run of the same fit (no faults)
# in a fresh scratch dir: its one worker keeps every chunk's payload on
# the card, so phase 2 gathers the stragglers there (phase2_mode
# "resident", within TSSPARK_RESIDENT_MB) instead of re-prepping them on
# the host, and must land the faulted run's bits on every row.
RS_CHUNK = 8192
RS_EXIT_RC = 31
RS_TORN_SERIES = 8192
RS_RETRY_DELAY_S = 1.0
RS_LOSS_TOL = PLAIN_SERIES_TOL


def smi_compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _jsonl(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def rs_workers(out_dir: str) -> list:
    """One record per fit worker of a resilient run, from its
    ``times.jsonl`` rows and the parent's ``spawns.jsonl``: device,
    kernel-library load, spawn -> ready and -> first dispatch, the chunks
    it landed, its phase 1 (first dispatch -> last save) and phase 2,
    peak memory and K3/K4 launches."""
    rows = _jsonl(os.path.join(out_dir, "times.jsonl"))
    spawns = {s["pid"]: s for s in _jsonl(os.path.join(out_dir,
                                                        "spawns.jsonl"))}
    out = []
    for w in (r for r in rows if "worker" in r):
        pid = w["worker"]
        mine = [r for r in rows if r.get("pid") == pid]
        chunks = [r for r in mine if "fit_s" in r]
        p2 = [r for r in mine if "phase2_s" in r]
        sp = spawns.get(pid, {})
        first = min((r["dispatch_unix"] for r in chunks), default=None)
        last = max((w["start_unix"] + r["t"] for r in chunks), default=None)
        launches = [r["launches"] for r in mine if "launches" in r]
        out.append({
            "pid": pid, "rc": sp.get("rc"), "device": w["device"],
            "devices_of_rows": sorted({r["device"] for r in mine}),
            "kernels": w["kernels"],
            "spawn_to_ready_s": (w["ready_unix"] - sp["spawn_unix"]
                                 if sp else None),
            "spawn_to_first_dispatch_s": (first - sp["spawn_unix"]
                                          if sp and first else None),
            "chunks": [[r["lo"], r["hi"]] for r in chunks],
            "phase1_s": last - first if chunks else None,
            "phase2_s": p2[0]["phase2_s"] if p2 else None,
            "phase2_mode": p2[0]["phase2_mode"] if p2 else None,
            "resident_bytes": p2[0]["resident_bytes"] if p2 else None,
            "stragglers": p2[0]["stragglers"] if p2 else None,
            "peak_bytes": max((r.get("peak_bytes", 0) for r in mine),
                              default=0),
            "k3": max((c["k3"] for c in launches), default=0),
            "k4": max((c["k4"] for c in launches), default=0),
        })
    return out


def rs_hold(got, two, order) -> dict:
    """The resilient fit ``got`` against the dataplane phase's
    ``fit_twophase`` state ``two``: bitwise on the rows its phase 1
    converged (not in ``order``, phase 2's rows), each straggler's loss
    within RS_LOSS_TOL and their mean gap within PLAIN_MEAN_TOL."""
    n = len(np.asarray(two.loss))
    strag = np.zeros(n, bool)
    strag[np.asarray(order, np.int64)] = True
    conv = ~strag
    bits = {f: bool(np.array_equal(np.asarray(getattr(got, f))[conv],
                                   np.asarray(getattr(two, f))[conv]))
            for f in ("theta", "loss", "grad_norm", "converged", "n_iters",
                      "status")}
    gap = (np.asarray(got.loss, np.float64)[strag]
           - np.asarray(two.loss, np.float64)[strag])
    finite = bool(np.isfinite(gap).all())
    a = np.abs(gap)
    out = {"bitwise_rows": int(conv.sum()), "bitwise": bits,
           "stragglers": int(strag.sum()),
           "straggler_loss_gap": {
               "max_abs": float(a.max()) if a.size else 0.0,
               "p99_abs": float(np.quantile(a, 0.99)) if a.size else 0.0,
               "median_abs": float(np.median(a)) if a.size else 0.0,
               "mean": float(gap.mean()) if a.size else 0.0,
               "over_tol": int((a > RS_LOSS_TOL).sum()),
               "finite": finite},
           "stragglers_converged_both": int(
               (np.asarray(got.converged)[strag]
                & np.asarray(two.converged)[strag]).sum()),
           "limits": {"series": RS_LOSS_TOL, "mean": PLAIN_MEAN_TOL}}
    out["ok"] = bool(all(bits.values()) and finite
                     and out["straggler_loss_gap"]["over_tol"] == 0
                     and abs(out["straggler_loss_gap"]["mean"])
                     <= PLAIN_MEAN_TOL)
    return out


def rs_one_row_off(state, lo: int, hi: int):
    """The planted fault: chunk [lo, hi)'s rows assembled one row off
    (each row takes its successor's results), the assembly error the
    numeric sort of ``completed_ranges`` exists to prevent."""
    import torch

    from tsspark_tpu_torch.orchestrate import _numpy_state

    st = _numpy_state(state)

    def shift(a):
        a = a.copy()
        a[lo:hi] = a[lo + 1:hi + 1]
        return a

    return st._replace(
        theta=torch.from_numpy(shift(st.theta)),
        meta=type(st.meta)(*(shift(a) for a in st.meta)),
        **{f: shift(getattr(st, f)) for f in
           ("loss", "grad_norm", "converged", "n_iters", "status")})


RS_STATE_FIELDS = ("theta", "loss", "grad_norm", "converged", "n_iters",
                   "status")


def rs_same(a, b) -> dict:
    """Field by field (the scaling meta's too): are two fit states the
    same bits on every row?"""
    out = {f: bool(np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))))
           for f in RS_STATE_FIELDS}
    out["meta"] = all(np.array_equal(np.asarray(x), np.asarray(y))
                      for x, y in zip(a.meta, b.meta))
    return out


def rs_fit(batch, split, run_dir, retry):
    """``orchestrate.fit_resilient`` of the fleet plane's rows on days
    [0, split) as phase resilient runs it (see RS_CHUNK), with the
    ResilienceWarnings it raised and its wall."""
    import warnings

    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.resilience.report import ResilienceWarning

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0_unix = time.time()
        t0 = time.perf_counter()
        state = orchestrate.fit_resilient(
            configs.CONFIG3, configs.SOLVER3, np.asarray(batch.ds)[:split],
            batch.y[:, :split], mask=batch.mask[:, :split],
            regressors=batch.regressors[:, :split], chunk=RS_CHUNK,
            phase1_iters=DP_PHASE1, no_phase1_tune=True,
            scratch_dir=run_dir, quarantine=True, retry_policy=retry,
        )
        wall = time.perf_counter() - t0
    warned = [str(w.message) for w in caught
              if issubclass(w.category, ResilienceWarning)]
    return state, warned, wall, t0_unix


def phase_resilient(device, ing, hand) -> dict:
    """The resilient scale-out fit (see RS_CHUNK): ``fit_resilient`` of
    the dataplane phase's 30,490 memmapped rows on days [0, 1746) with
    config 3's model, 8,192-row chunks, phase 1 at DP_PHASE1, worker
    processes on the card, a fresh scratch dir and the two faults; then
    the run's report and files (retries, probes, the quarantined file,
    coverage exactly once, no CPU degradation, no ResilienceWarning),
    each worker's device, launches, peak memory and times, the hold
    against ``fit_twophase`` (which the planted one-row-off assembly
    must fail) and the fleet subset's forecasts against the scipy
    oracle within the dataplane budget.  Last the clean run, whose
    phase 2 gathers from the card-resident payloads and must land the
    faulted run's bits."""
    import glob
    import shutil

    import torch

    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.resilience import faults
    from tsspark_tpu_torch.resilience.policy import RetryPolicy
    from tsspark_tpu_torch.resilience.report import get_report

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    split = configs.split_point(FULL_DAYS)
    batch = plane.open_batch(ing.dirs["fleet"])
    n = FULL_SERIES
    res = {"phase": "resilient", "compute_mode": smi_compute_mode(),
           "chunk": RS_CHUNK, "phase1_iters": DP_PHASE1}
    require(res["compute_mode"] != "Exclusive_Process",
            f"the card's compute mode lets worker processes open a "
            f"context: {res['compute_mode']}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["parent_reserved_bytes"] = int(torch.cuda.memory_reserved())
    scratch = tempfile.mkdtemp(prefix="resilient_")
    run_dir = os.path.join(scratch, "run")
    out_dir = os.path.join(run_dir, "out")
    plan = (faults.FaultPlan(state_dir=os.path.join(scratch, "faults"))
            .fail("fit_worker_chunk", after=0, attempts=1, mode="exit",
                  rc=RS_EXIT_RC)
            .fail("chunk_save", series=RS_TORN_SERIES, attempts=1,
                  mode="corrupt"))
    retry = RetryPolicy(max_attempts=9, base_delay_s=RS_RETRY_DELAY_S,
                        backoff=1.0, max_delay_s=RS_RETRY_DELAY_S)
    try:
        os.environ[faults.ENV_VAR] = plan.to_env()
        state, rs_warn, wall, t0_unix = rs_fit(batch, split, run_dir, retry)
    finally:
        os.environ.pop(faults.ENV_VAR, None)
    try:
        report = get_report(state)
        workers = rs_workers(out_dir)
        data_dir = os.path.join(run_dir, "data")
        mt = {f: os.path.getmtime(os.path.join(data_dir, f"{f}.npy"))
              for f in ("ds", "y", "mask", "reg")}
        spawns = _jsonl(os.path.join(out_dir, "spawns.jsonl"))
        probes = _jsonl(os.path.join(out_dir, "probes.jsonl"))
        corrupt = sorted(os.path.basename(p) for p in
                         glob.glob(os.path.join(out_dir, "*.corrupt")))
        done = orchestrate.completed_ranges(out_dir)
        cur, tiles = 0, True
        for lo, hi in done:
            tiles = tiles and lo == cur
            cur = hi
        tiles = tiles and cur == n
        res.update({
            "wall_s": wall,
            "before_spill_s": mt["ds"] - t0_unix,
            "spill_s": max(mt.values()) - mt["ds"],
            "spill_bytes": sum(os.path.getsize(os.path.join(data_dir, f))
                               for f in os.listdir(data_dir)),
            "first_spawn_after_s": (spawns[0]["spawn_unix"] - t0_unix
                                    if spawns else None),
            "spawns": [{k: s[k] for k in ("pid", "rc")} for s in spawns],
            "probes": probes, "retries": report.retries,
            "degraded_to_cpu": report.degraded_to_cpu,
            "report_warnings": list(report.warnings),
            "resilience_warnings": rs_warn,
            "corrupt_files": corrupt, "chunks": [list(r) for r in done],
            "coverage_exactly_once": bool(tiles),
            "workers": workers,
            "worker_peak_bytes": max((w["peak_bytes"] for w in workers),
                                     default=0),
            "worker_built_library": any(w["kernels"]["builds"] > 0
                                        for w in workers),
            "launches": {"k3": sum(w["k3"] for w in workers),
                         "k4": sum(w["k4"] for w in workers)},
        })
        two = hand["state"]
        hold = rs_hold(state, two, hand["order"])
        planted = rs_one_row_off(state, RS_CHUNK, 2 * RS_CHUNK)
        planted_hold = rs_hold(planted, two, hand["order"])
        bk = get_backend("cuda", cfg, solver, device=device)
        rows = hand["rows"]
        budget = dp_budget(batch, dp_forecast_rows(bk, state, batch, rows),
                           rows, hand["oracle_yhat"])
        res.update({"hold": hold, "planted_one_row_off": {
            k: planted_hold[k] for k in ("bitwise", "straggler_loss_gap",
                                         "ok")}, "parity": budget,
            "status_counts": np.bincount(np.asarray(state.status),
                                         minlength=5).tolist()})
        clean_dir = os.path.join(scratch, "clean")
        clean, clean_warn, clean_wall, _ = rs_fit(batch, split, clean_dir,
                                                  retry)
        clean_report = get_report(clean)
        cworkers = rs_workers(os.path.join(clean_dir, "out"))
        res["clean"] = {
            "wall_s": clean_wall, "retries": clean_report.retries,
            "degraded_to_cpu": clean_report.degraded_to_cpu,
            "resilience_warnings": clean_warn, "workers": cworkers,
            "same_bits_as_faulted": rs_same(clean, state),
            "launches": {"k3": sum(w["k3"] for w in cworkers),
                         "k4": sum(w["k4"] for w in cworkers)},
        }
        emit(res)
        landed = [w for w in workers if w["chunks"]]
        require(report.retries >= 1 and spawns
                and spawns[0]["rc"] == RS_EXIT_RC,
                f"the first worker exited and was respawned: {spawns}")
        require(len(corrupt) == 1 and tiles and not
                orchestrate.missing_ranges(done, n),
                f"one torn chunk quarantined and refitted, coverage "
                f"exactly once: {corrupt} {done}")
        require(not report.degraded_to_cpu and not rs_warn
                and all(not w["device"].startswith("cpu")
                        for w in workers),
                "no CPU degradation and no ResilienceWarning")
        require(landed and all(
            w["devices_of_rows"] == [w["device"]]
            and w["device"].startswith("cuda") and w["k3"] > 0
            and w["k4"] > 0 for w in landed),
            f"every worker that landed a chunk ran on the card through K3 "
            f"and K4: {workers}")
        require(tuple(state.theta.shape) == (n, cfg.num_params)
                and bool(torch.isfinite(state.theta).all())
                and bool(np.isfinite(state.loss).all()),
                "the resilient fit is finite and complete")
        require(hold["ok"], f"the resilient fit against fit_twophase: "
                            f"{hold}")
        require(not planted_hold["ok"],
                f"the one-row-off assembly passes the hold: {planted_hold}")
        require(budget["within_budget"],
                f"the fleet subset against the oracle: {budget}")
        cl = res["clean"]
        require(cl["retries"] == 0 and not cl["degraded_to_cpu"]
                and not clean_warn and len(cworkers) == 1,
                f"the clean run: one worker, no retry, no degradation: "
                f"{cl}")
        w = cworkers[0]
        require(w["phase2_mode"] == "resident" and w["resident_bytes"] > 0
                and w["device"].startswith("cuda") and w["k3"] > 0
                and w["k4"] > 0,
                f"the clean run's phase 2 gathered on the card: {w}")
        require(all(cl["same_bits_as_faulted"].values()),
                f"the clean run against the faulted run: "
                f"{cl['same_bits_as_faulted']}")
        # Phases resident and refit start from the clean run: its state,
        # its spill of days [0, split) and the fleet's ids; main removes
        # the scratch dir after them.
        res["handoff"] = {"state": clean, "data": os.path.join(clean_dir,
                                                               "data"),
                          "scratch": scratch, "ids": batch.series_ids,
                          "fleet": ing.dirs["fleet"], "split": split}
    finally:
        if "handoff" not in res:
            shutil.rmtree(scratch, ignore_errors=True)
    return res


def add_resilient(kernels, rs) -> None:
    """K3's and K4's entries gain their launches in phase resilient's
    worker processes (summed over the workers, read from their rows):
    the faulted run's and the clean run's."""
    for k in kernels:
        key = {"loss": "k3", "fan": "k4"}.get(k["name"])
        if key is not None:
            k["launches_resilient"] = rs["launches"][key]
            k["launches_resilient_clean"] = rs["clean"]["launches"][key]


RD_CRASH_AFTER = 2        # the resident child dies after this many flushes
RD_PIPELINE = 2           # waves computed but not yet flushed, at most
RD_WARM_EVERY = 10        # the warm run's rows: every 10th (3,049)
RD_SMAPE_TOL = 0.05       # the warm rows' median |sMAPE gap| to the cold

# The resident child: ``run_resident`` on an explicit one-device mesh (the
# device argv[2], cuda:0 on the card), its keywords from argv[1]; it
# imports the port only.
RD_CHILD = r"""
import json, sys
sys.modules["jax"] = None
import torch
from tsspark_tpu_torch import resident
from tsspark_tpu_torch.parallel.mesh import make_mesh
kw = json.loads(sys.argv[1])
mesh = make_mesh(1, 1, devices=[torch.device(sys.argv[2])])
st = resident.run_resident(mesh=mesh, **kw)
sys.exit(0 if st.get("complete") else 1)
"""


def _kernel_counts() -> dict:
    """K1, K3 (per mode and its stack layouts), K4 and K7 launches."""
    from tsspark_tpu_torch.kernels import advi as advi_k

    return {**_stream_counts(), "advi": advi_k.launches}


def _zero_kernel_counts() -> None:
    from tsspark_tpu_torch.kernels import advi as advi_k

    _zero_counts()
    advi_k.launches = 0


def _tiles(done, n) -> bool:
    """Do the landed ranges tile [0, n) exactly once?"""
    cur = 0
    for lo, hi in done:
        if lo != cur:
            return False
        cur = hi
    return cur == n


def _in_sample_smape(bk, state, ds, y, mask, reg) -> np.ndarray:
    """Per-series in-sample sMAPE of ``state``'s deterministic forecast."""
    from tsspark_tpu_torch.eval import metrics

    yhat = bk.predict(state, ds, regressors=reg, num_samples=0)["yhat"]
    return np.asarray(metrics.smape(np.nan_to_num(y), yhat, mask=mask))


def rd_chunk(data_dir, cfg, n) -> tuple:
    """The first resident wave's packed rows ([0, RS_CHUNK) of the spill
    in ``data_dir``, as the resident program packs them) and its indicator
    columns: (packed, u8)."""
    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.models.prophet.design import (
        pack_fit_data, prepare_fit_data)

    ds, d = orchestrate._load_data(data_dir)
    u8 = orchestrate.decide_u8_split(data_dir, d["reg"], n)
    rows = lambda a: orchestrate._pad_chunk_rows(  # noqa: E731
        a, 0, RS_CHUNK, RS_CHUNK)
    y_c = rows(d["y"])
    data, meta = prepare_fit_data(
        ds, y_c, cfg, regressors=rows(d["reg"]),
        mask=orchestrate._chunk_mask(y_c, d["mask"], 0, RS_CHUNK, RS_CHUNK))
    packed, _ = pack_fit_data(data, meta, ds, reg_u8_cols=u8,
                              collapse_cap=True)
    return packed, u8


# The time split's fit against the one-device fit: the bound of
# tests/test_torch_mesh.py::test_backend_time_mesh_against_the_meshless_fit
# (the JAX package's mesh-routing bound, tests/test_sharding.py).
TS_RTOL = TS_ATOL = 2e-3


def rd_time_split(packed, u8, cfg, solver, dev, seed: int = 17) -> dict:
    """The time axis on the card: ``fit_sharded_packed`` on a 1 x 2
    (series x time) mesh whose two entries are both ``dev``, over one
    packed config-3 chunk with ``solver``, from the ridge init.  Each time
    block is a (B, T/2) problem with its own time offset: block 0's K3
    (both modes) and K4 with the priors, block 1's with every prior scale
    at +inf, each held against its plain version by GAP_RULE (and a
    dropped cell required to fail it) at an off-optimum theta.  The split
    fit's launches are counted, and its losses held against the
    one-device program's (``fit_core_packed`` on the same rows) at
    TS_RTOL / TS_ATOL."""
    import math

    import torch

    from tsspark_tpu_torch.config import ShardingConfig
    from tsspark_tpu_torch.models.prophet.design import (
        packed_to_device, unpack_fit_data)
    from tsspark_tpu_torch.models.prophet.model import fit_core_packed
    from tsspark_tpu_torch.parallel import sharding as sh
    from tsspark_tpu_torch.parallel.mesh import make_mesh

    th_m, st_m = fit_core_packed(packed_to_device(packed, dev), None, cfg,
                                 solver, reg_u8_cols=u8)
    loss_m = st_m[0].cpu().numpy()
    mesh = make_mesh(1, 2, devices=[dev, dev])
    _zero_kernel_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = sh.fit_sharded_packed(packed, u8, None, cfg, solver, mesh)
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    loss_t = split.f.numpy()
    over = np.abs(loss_t - loss_m) - (TS_ATOL + TS_RTOL * np.abs(loss_m))
    data = unpack_fit_data(packed_to_device(packed, dev), u8)
    blocks = sh._time_blocks(data, mesh, ShardingConfig())[0]
    theta, d = off_optimum(th_m, seed)
    held = []
    for j, b in enumerate(blocks):
        c = cfg if j == 0 else sh._priorless(cfg)
        if j:
            b = b._replace(prior_scales=torch.full_like(b.prior_scales,
                                                        math.inf))
        held.append(hold_kernels(theta, d, b, c, f"time block {j}"))
    out = {"mesh": [1, 2], "shape": list(data.y.shape),
           "blocks_t": [int(b.t.shape[-1]) for b in blocks],
           "max_iters": int(solver.max_iters), "wall_s": wall,
           "launches": launches, "blocks": held,
           "loss_vs_one_device": {
               "max_abs": float(np.abs(loss_t - loss_m).max()),
               "max_rel": float((np.abs(loss_t - loss_m)
                                 / np.abs(loss_m)).max()),
               "rows_over": int((over > 0).sum()),
               "tolerance": f"rtol {TS_RTOL}, atol {TS_ATOL}"},
           "finite": bool(np.isfinite(split.theta.numpy()).all())}
    require(dev.type != "cuda" or (launches["loss_grad"] > 0
                                   and launches["loss_value"] > 0
                                   and launches["fan"] > 0),
            f"the time-split fit launched K3 (both modes) and K4: "
            f"{launches}")
    require(out["finite"] and out["loss_vs_one_device"]["rows_over"] == 0,
            f"the time-split fit against the one-device fit: "
            f"{out['loss_vs_one_device']}")
    return out


def rd_wave_profile(mesh, data_dir, cfg, solver, n) -> dict:
    """One resident wave (rows [0, RS_CHUNK), phase 1's program) under the
    profiler: its wall, the card's busy time and idle share."""
    import torch

    from tsspark_tpu_torch.backends.cuda import phase1_dynamic_args
    from tsspark_tpu_torch.parallel import sharding as sh

    packed, u8 = rd_chunk(data_dir, cfg, n)
    specs = sh.match_partition_rules(
        sh.resident_partition_rules("series", False), packed)
    shard = sh.make_shard_and_gather_fns(mesh, specs)[0]
    p1 = phase1_dynamic_args(DP_PHASE1, False, solver)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if mesh.devices[0, 0].type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        th, _st = sh.fit_resident_core(
            sh.apply_fns(shard, packed),
            sh.shard_array(mesh, sh.P("series", None),
                           np.zeros((RS_CHUNK, cfg.num_params), np.float32)),
            cfg, p1["solver_config"], reg_u8_cols=u8,
            use_theta0_dynamic=False)
        np.asarray(th)
        traced = time.perf_counter() - t0
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    return {"rows": RS_CHUNK, "traced_wall_s": traced,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
            "top_device_ms": [(k[:60], ms) for k, ms in top[:4]]}


def rd_warm_run(mesh, data_dir, clean, cfg, solver, scratch,
                device) -> dict:
    """The warm run: ``run_resident`` on ``mesh`` over every
    RD_WARM_EVERY-th row of the spill in ``data_dir``, ``theta0_fn`` from
    the clean run's theta; its in-sample sMAPE against the clean rows'."""
    from tsspark_tpu_torch import orchestrate, resident
    from tsspark_tpu_torch.backends.cuda import _take_rows
    from tsspark_tpu_torch.backends.registry import get_backend

    n = int(clean.theta.shape[0])
    rows_w = np.arange(0, n, RD_WARM_EVERY)
    ds, d = orchestrate._load_data(data_dir)
    sub = lambda a: np.ascontiguousarray(a[rows_w])  # noqa: E731
    warm_data = os.path.join(scratch, "warm_data")
    warm_out = os.path.join(scratch, "warm_out")
    orchestrate.spill_data(warm_data, ds, sub(d["y"]),
                           mask=sub(d["mask"]), regressors=sub(d["reg"]))
    os.makedirs(warm_out)
    orchestrate.save_run_config(warm_out, cfg, solver)
    theta_c = clean.theta.numpy()
    t0 = time.perf_counter()
    wst = resident.run_resident(
        data_dir=warm_data, out_dir=warm_out, series=len(rows_w),
        chunk=RS_CHUNK, phase1_iters=DP_PHASE1, no_phase1_tune=True,
        mesh=mesh, theta0_fn=lambda lo, hi: theta_c[rows_w[lo:hi]])
    warm_s = time.perf_counter() - t0
    warm = orchestrate.load_fit_state(warm_out, len(rows_w))
    bk = get_backend("cuda", cfg, solver, device=device)
    args = (ds, sub(d["y"]), sub(d["mask"]), sub(d["reg"]))
    s_warm = _in_sample_smape(bk, warm, *args)
    s_cold = _in_sample_smape(bk, _take_rows(clean, rows_w), *args)
    gap = np.abs(s_warm - s_cold)
    return {
        "rows": int(len(rows_w)), "wall_s": warm_s,
        "fit_path": wst.get("fit_path"), "complete": wst.get("complete"),
        "finite": bool(np.isfinite(np.asarray(warm.loss)).all()),
        "iterations_mean": float(np.mean(warm.n_iters)),
        "cold_iterations_mean": float(np.mean(
            np.asarray(clean.n_iters)[rows_w])),
        "smape_gap": {"median": float(np.median(gap)),
                      "mean": float(gap.mean()),
                      "max": float(gap.max())},
        "limit_median": RD_SMAPE_TOL,
    }


def phase_resident(device, hand) -> dict:
    """The mesh-resident fit on an explicit one-device mesh of cuda:0 over
    phase resilient's clean spill (30,490 rows x days [0, 1746), config
    3, RS_CHUNK waves, phase 1 at DP_PHASE1, ``pipeline_depth`` 2): a
    child process killed after RD_CRASH_AFTER flushes (rc 17, partial
    coverage), resumed in this process on the same mesh; the assembled
    state bitwise the clean run's, coverage exactly once, ``resident.json``
    path "resident" on mesh [1, 1].  Its wall, K3/K4 launches (counts set
    to 0 before the resume), peak memory and one wave's idle share under
    the profiler; the time split's check (``rd_time_split``).  While the
    child runs, the warm run (``rd_warm_run``: ``theta0_fn`` from the
    clean run's theta) over every RD_WARM_EVERY-th row, its in-sample
    sMAPE against the clean rows' within RD_SMAPE_TOL (median gap)."""
    import shutil

    import torch

    from tsspark_tpu_torch import orchestrate, resident
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.parallel.mesh import make_mesh

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    clean, data_dir, n = hand["state"], hand["data"], FULL_SERIES
    scratch = tempfile.mkdtemp(prefix="resident_")
    res = {"phase": "resident", "chunk": RS_CHUNK,
           "phase1_iters": DP_PHASE1, "pipeline_depth": RD_PIPELINE,
           "lbfgs_iteration_bound": lbfgs_bound_ms(
               solver.history, RS_CHUNK, cfg.num_params)}
    try:
        out_dir = os.path.join(scratch, "out")
        os.makedirs(out_dir)
        orchestrate.save_run_config(out_dir, cfg, solver)
        kw = dict(data_dir=data_dir, out_dir=out_dir, series=n,
                  chunk=RS_CHUNK, phase1_iters=DP_PHASE1,
                  no_phase1_tune=True, pipeline_depth=RD_PIPELINE)
        env = dict(os.environ,
                   TSSPARK_TEST_CRASH_AFTER=str(RD_CRASH_AFTER))
        here = os.path.dirname(os.path.abspath(__file__))
        mesh_dev = (torch.device("cuda", 0) if device.type == "cuda"
                    else device)
        mesh = make_mesh(1, 1, devices=[mesh_dev])
        # The child's start and waves beside the warm run (its own out
        # dir, nothing the child reads); the resume, the profile and the
        # time split wait for it.
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", RD_CHILD,
                                  json.dumps(kw), str(mesh_dev)],
                                 cwd=here, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            res["warm"] = rd_warm_run(mesh, data_dir, clean, cfg, solver,
                                      scratch, device)
            t_wait = time.perf_counter()
            _out, child_err = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        res["child_s"] = time.perf_counter() - t0
        res["child_wait_s"] = time.perf_counter() - t_wait
        res["child_rc"] = child.returncode
        landed = orchestrate.completed_ranges(out_dir)
        res["child_landed"] = [list(r) for r in landed]
        require(child.returncode == 17 and landed
                and orchestrate.missing_ranges(landed, n),
                f"the resident child died after {RD_CRASH_AFTER} flushes "
                f"with partial coverage: rc {child.returncode} {landed} "
                f"{child_err[-1500:]}")
        _zero_kernel_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = resident.run_resident(mesh=mesh, **kw)
        res["resume_s"] = time.perf_counter() - t0
        res["resume_launches"] = _kernel_counts()
        res["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
        got = orchestrate.load_fit_state(out_dir, n)
        done = orchestrate.completed_ranges(out_dir)
        with open(os.path.join(out_dir, resident.RESIDENT_STATE_FILE)) as fh:
            rstate = json.load(fh)
        rows = _jsonl(os.path.join(out_dir, "times.jsonl"))
        waves = [r for r in rows if r.get("path") == "resident"]
        p2 = [r for r in rows if "phase2_mode" in r]
        res.update({
            "fit_path": st.get("fit_path"), "complete": st.get("complete"),
            "resident_json": rstate,
            "coverage_exactly_once": _tiles(done, n),
            "same_bits_as_clean": rs_same(got, clean),
            "waves": [{k: r.get(k) for k in ("lo", "hi", "fit_s", "shards",
                                             "pid", "peak_bytes")}
                      for r in waves],
            "phase2": p2,
        })
        res["wave_profile"] = rd_wave_profile(mesh, data_dir, cfg, solver,
                                              n)
        packed, u8 = rd_chunk(data_dir, cfg, n)
        res["time_split"] = rd_time_split(packed, u8, cfg, solver, mesh_dev)
        del packed
        emit(res)
        require(st.get("complete") and st.get("fit_path") == "resident",
                f"the resumed resident run completed: {st}")
        require(rstate.get("path") == "resident"
                and rstate.get("mesh") == [1, 1]
                and rstate.get("landed") == n,
                f"resident.json: {rstate}")
        require(res["coverage_exactly_once"] and not
                orchestrate.missing_ranges(done, n),
                f"coverage exactly once: {done}")
        require(all(res["same_bits_as_clean"].values()),
                f"the resident run against the clean resilient run: "
                f"{res['same_bits_as_clean']}")
        require(waves and all(w["shards"] == 1 for w in waves)
                and p2 and p2[-1]["phase2_mode"] == "resident-sharded",
                f"the times rows: {waves} {p2}")
        rl = res["resume_launches"]
        require(rl["loss_grad"] > 0 and rl["loss_value"] > 0
                and rl["fan"] > 0,
                f"the resumed run launched K3 (both modes) and K4: {rl}")
        require(res["warm"]["complete"]
                and res["warm"]["fit_path"] == "resident"
                and res["warm"]["finite"],
                f"the warm run: {res['warm']}")
        require(res["warm"]["smape_gap"]["median"] < RD_SMAPE_TOL,
                f"the warm rows against the cold rows: {res['warm']}")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return res


RF_EVERY = 10             # cycle 1's delta: every 10th row from row 5 (3,049)
RF_KILL_EVERY = 100       # cycle 2's delta: every 100th row from row 7 (305)
RF_WINDOW = 7             # the days each delta advances
RF_HORIZONS = (7,)        # the planes' hot horizons (bucket 8)
RF_HOT = 256              # hot series cached at v1 in the engine
RF_CACHE_H = 14           # their horizon: bucket 16, past the planes (8)
RF_KILL_RC = 23


def rf_state_v1(clean, n_reg: int):
    """The clean run's fit without its regressor coefficients (the last
    ``n_reg`` parameters and the regressor scalings): the serving tier
    reads no regressor values (``qplane._advi_eligible``), so the cycle
    runs config 3's model without regressors over the same rows."""
    meta = clean.meta._replace(
        reg_mean=np.asarray(clean.meta.reg_mean)[:, :0],
        reg_std=np.asarray(clean.meta.reg_std)[:, :0])
    return clean._replace(theta=clean.theta[:, :-n_reg].contiguous(),
                          meta=meta)


def _cols_rows_equal(base_vdir, new_vdir, prefix, rows) -> dict:
    """Per column file of ``prefix``: are ``rows`` the base's bytes, and
    is the file a hard link of the base's?"""
    out = {}
    for name in sorted(os.listdir(new_vdir)):
        if not name.startswith(prefix):
            continue
        a = np.load(os.path.join(base_vdir, name), mmap_mode="r")
        b = np.load(os.path.join(new_vdir, name), mmap_mode="r")
        out[name] = {
            "rows_same": bool(np.array_equal(np.asarray(a[rows]),
                                             np.asarray(b[rows]))),
            "hardlink": os.stat(os.path.join(base_vdir, name)).st_ino
            == os.stat(os.path.join(new_vdir, name)).st_ino}
    return out


def phase_refit(device, hand) -> dict:
    """One delta-refit cycle at 10% churn on the card, then a killed and
    resumed one.  The base: a plane dataset of the fleet's days [0, 1746)
    (``plane.import_batch`` of phase resilient's clean spill, no
    regressors) and registry version 1 = the clean run's fit minus its
    regressor coefficients (``rf_state_v1``) with its snapshot plane, a
    forecast plane (K1), an ADVI posterior (``fit_advi`` at
    ``AdviConfig()``: K3's draw stack and K7) and the ADVI-mode quantile
    plane (both planes at RF_HORIZONS), and an engine holding RF_HOT
    series in its cache at v1 (at RF_CACHE_H, a bucket no plane holds).
    Cycle 1: a delta advances every RF_EVERY-th row by the fleet's next
    RF_WINDOW days (``plane.land_delta``) and ``run_refit`` runs with no
    mesh: the one-card fallback to the file protocol (one warning), the
    changed rows refitted cold by a worker process, the copy-forward
    publish of the three planes and the posterior, the flip.  Required:
    the detected set is the delta's rows, ``fit_path`` "fileproto" with
    one fallback warning, unchanged rows' snapshot, forecast and
    quantile bytes the base's, the columns no refit row touches hard
    links, the refit rows bitwise the chunk worker's cold fit of the
    cycle's spill (the body ``run_resilient`` spawns, here in process),
    the changed rows' posterior bitwise ``fit_advi`` run directly on their
    v2 theta, their spill rows and ``posterior_seed(seed, v2)``, the
    engine serving v2 with v1's entries carried for unchanged series.
    Cycle 2: a 1% delta, ``python -m tsspark_tpu_torch.refit`` (started
    once the spill of cycle 1's reference is rebuilt, beside cycle 1's
    checks) killed at the delta publish (rc RF_KILL_RC, the active
    version untouched), resumed here with no new fit, landing the
    child's bits.  The plane dataset and the registry (version 3 active)
    are handed on to phase sched (``res["handoff"]``: its ``scratch``
    is the caller's to remove); a failed phase removes them."""
    import dataclasses
    import shutil
    import warnings

    import torch

    from tsspark_tpu_torch import orchestrate, refit
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import AdviConfig, SolverConfig
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.data.datasets import SeriesBatch
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.models.prophet.design import (
        prepare_fit_data, prepare_fit_data_blocks)
    from tsspark_tpu_torch.resilience import faults
    from tsspark_tpu_torch.serve import ForecastCache, ParamRegistry
    from tsspark_tpu_torch.serve import fplane, snapplane
    from tsspark_tpu_torch.serve.engine import PredictionEngine
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import qplane

    cfg = dataclasses.replace(configs.CONFIG3, regressors=())
    solver = configs.SOLVER3
    n, split = FULL_SERIES, hand["split"]
    # The card by default; the CPU only when this phase is driven there.
    dev_kw = {} if device.type == "cuda" else {"device": "cpu"}
    ids = np.asarray(hand["ids"])
    scratch = tempfile.mkdtemp(prefix="refit_")
    res = {"phase": "refit", "series": n, "days": split,
           "horizons": list(RF_HORIZONS)}
    walls = res["walls_s"] = {}

    def clock(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    try:
        ds, d = orchestrate._load_data(hand["data"])
        dset = clock("import", plane.import_batch, SeriesBatch(
            ds=ds, y=d["y"], mask=d["mask"], series_ids=ids),
            "refit_fleet", root=os.path.join(scratch, "plane"))
        reg = ParamRegistry(os.path.join(scratch, "registry"), cfg)
        v1_state = rf_state_v1(hand["state"], configs.CONFIG3.num_regressors)
        v1 = clock("publish_v1", reg.publish, v1_state, ids,
                   step=np.ones(n), data_stamp=plane.delta_seq(dset))
        bk = get_backend("cuda", cfg, SolverConfig(), device=device)
        fp1 = clock("fplane_v1", fplane.maybe_publish, reg, v1, bk,
                    horizons=RF_HORIZONS)
        data1, _ = clock("advi_v1_prep", prepare_fit_data_blocks, ds,
                         d["y"], cfg, mask=d["mask"])
        advi_cfg = AdviConfig()
        _zero_kernel_counts()
        post = clock("advi_v1", advi_mod.fit_advi, v1_state.theta, data1,
                     torch.Generator(device=device).manual_seed(UNC_SEED),
                     cfg, advi_cfg, device=device)
        res["advi_v1_launches"] = _kernel_counts()
        del data1
        advi_mod.save_posterior(reg.version_dir(v1), post, seed=UNC_SEED,
                                num_steps=advi_cfg.num_steps)
        del post
        qp1 = clock("qplane_v1", qplane.maybe_publish, reg, v1, bk,
                    horizons=RF_HORIZONS)
        res["v1"] = {"version": v1, "fplane": (fp1 or {}).get("status"),
                     "qplane": (qp1 or {}).get("status")}
        eng = PredictionEngine(reg, cache=ForecastCache(4 * RF_HOT),
                               device=device)
        hot = [str(s) for s in ids[:RF_HOT]]
        clock("materialize", eng.materialize, hot, (RF_CACHE_H,))
        before = {s: eng.forecast([s], RF_CACHE_H) for s in hot}

        fleet = plane.open_batch(hand["fleet"])
        rows1 = np.arange(5, n, RF_EVERY)
        win = slice(split, split + RF_WINDOW)
        clock("delta", plane.land_delta, dset, rows1,
              np.nan_to_num(np.asarray(fleet.y[rows1, win], np.float32)),
              np.asarray(fleet.mask[rows1, win], np.float32))
        _zero_kernel_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cyc = clock("cycle1", refit.run_refit, data_dir=dset,
                        registry=reg,
                        scratch=os.path.join(scratch, "refit"),
                        chunk=RS_CHUNK, solver_config=solver,
                        phase1_iters=DP_PHASE1, no_phase1_tune=True,
                        horizons=RF_HORIZONS, **dev_kw)
        res["cycle1_launches_in_process"] = _kernel_counts()
        fallback = [str(w.message) for w in caught
                    if "no usable device mesh" in str(w.message)]
        v2 = cyc.get("version")
        info = reg.delta_info(v2) if v2 else {}
        changed = np.asarray(info.get("changed_rows", []), np.int64)
        keep = np.setdiff1d(np.arange(n), rows1)
        v1d, v2d = reg.version_dir(v1), reg.version_dir(v2)
        cols = {p: _cols_rows_equal(v1d, v2d, p, keep) for p in
                (snapplane.COL_PREFIX, fplane.FCOL_PREFIX,
                 qplane.QCOL_PREFIX)}
        # The refit rows against the chunk worker's cold fit of the
        # cycle's spill (the gather rebuilt here: the cycle reaped its own).
        batch2 = plane.open_batch(dset)
        ref_data = os.path.join(scratch, "ref_data")
        ref_out = os.path.join(scratch, "ref_out")
        take = lambda a: np.ascontiguousarray(a[rows1])  # noqa: E731
        orchestrate.spill_data(ref_data, np.asarray(batch2.ds),
                               take(batch2.y), mask=take(batch2.mask))
        orchestrate.save_run_config(ref_out, cfg, solver)
        wargs = argparse.Namespace(
            data=ref_data, out=ref_out, lo=0, hi=len(rows1),
            chunk=RS_CHUNK, segment=0, series=len(rows1),
            phase1_iters=DP_PHASE1, no_phase1_tune=True, max_ahead=6,
            autotune=False, device=dev_kw.get("device"))
        # Cycle 2's delta lands (after the spill above was rebuilt from
        # the plane) and its child, killed at the delta publish, runs
        # beside cycle 1's checks: it publishes no version it activates,
        # and nothing below reads the rows it advances.
        rows2 = np.arange(7, n, RF_KILL_EVERY)
        win2 = slice(split + RF_WINDOW, split + 2 * RF_WINDOW)
        plane.land_delta(dset, rows2,
                         np.nan_to_num(np.asarray(fleet.y[rows2, win2],
                                                  np.float32)),
                         np.asarray(fleet.mask[rows2, win2], np.float32))
        scratch2 = os.path.join(scratch, "refit2")
        fplan = faults.FaultPlan(state_dir=os.path.join(scratch, "faults"))
        fplan.fail("delta_publish", attempts=1, after=2, mode="exit",
                   rc=RF_KILL_RC, tag="refit-kill")
        env = dict(os.environ)
        env[faults.ENV_VAR] = fplan.to_env()
        here = os.path.dirname(os.path.abspath(__file__))
        kid_log = os.path.join(scratch, "killed_child.log")
        t_kid = time.perf_counter()
        with open(kid_log, "w") as kid_fh:
            kid = subprocess.Popen(
                [sys.executable, "-m", "tsspark_tpu_torch.refit", "--data",
                 dset, "--registry", reg.root, "--scratch", scratch2,
                 "--chunk", str(RS_CHUNK), "--max-iters",
                 str(solver.max_iters), "--phase1-iters", str(DP_PHASE1),
                 "--no-activate",
                 *(["--device", "cpu"] if dev_kw else [])],
                cwd=here, env=env, stdout=kid_fh, stderr=subprocess.STDOUT)
        try:
            _zero_kernel_counts()
            clock("reference_fit", orchestrate.fit_worker, wargs)
            res["reference_fit_launches"] = _kernel_counts()
            ref = orchestrate.load_fit_state(ref_out, len(rows1))
            snap2 = reg.load(v2, fallback=False)
            got_rows, _ = snap2.take(rows1)
            # After the flip: the engine answers v2, unchanged hot series
            # from v1's carried entries (the same bits), changed ones
            # recomputed.
            stats = eng.cache.stats()
            after = {s: eng.forecast([s], RF_CACHE_H) for s in hot}
            changed_ids = set(info.get("changed_ids", []))
            same = {s: all(np.array_equal(np.asarray(before[s].values[k]),
                                          np.asarray(after[s].values[k]))
                           for k in before[s].values) for s in hot}
            eng_ok = {
                "version_v2": all(after[s].version == v2 for s in hot),
                "unchanged_same_from_cache": all(
                    same[s] and after[s].from_cache == 1
                    for s in hot if s not in changed_ids),
                "changed_recomputed": all(not same[s] for s in hot
                                          if s in changed_ids),
                "carried": int(stats.get("carried", 0)),
                "hot_changed": int(sum(s in changed_ids for s in hot)),
            }
            p1, _h1 = advi_mod.load_posterior(v1d)
            p2, _h2 = advi_mod.load_posterior(v2d)
            # The changed rows' posterior against ``fit_advi`` run directly
            # on the cycle's theta of those rows, their spill rows and the
            # generator at posterior_seed(seed, v2): a wrong row map, theta
            # or seed gives other bits.
            load = lambda f: np.load(  # noqa: E731
                os.path.join(ref_data, f))
            data_s, _ = prepare_fit_data(load("ds.npy"), load("y.npy"),
                                         cfg, mask=load("mask.npy"))
            direct = advi_mod.fit_advi(
                np.asarray(got_rows.theta, np.float32), data_s,
                torch.Generator(device=device).manual_seed(
                    refit.posterior_seed(UNC_SEED, v2)),
                cfg, advi_cfg, device=device)
            del data_s
            direct_same = {f: bool(np.array_equal(
                np.asarray(getattr(p2, f))[rows1],
                getattr(direct, f).detach().cpu().numpy()))
                for f in ("mu", "rho", "elbo")}
            res["cycle1"] = {
                **{k: cyc.get(k) for k in ("n_changed", "fit_path", "fit_s",
                                           "fit_dispatches", "publish_s",
                                           "flip_s", "fplane", "qplane",
                                           "wall_s", "version")},
                "fallback_warnings": len(fallback),
                "detected_is_delta": bool(np.array_equal(changed, rows1)),
                "columns": cols,
                "same_bits_as_reference_fit": rs_same(got_rows, ref),
                "engine": eng_ok,
                "posterior_unchanged_rows_same": all(
                    np.array_equal(np.asarray(getattr(p2, f))[keep],
                                   np.asarray(getattr(p1, f))[keep])
                    for f in ("mu", "rho", "elbo")),
                "posterior_changed_rows_moved": not np.array_equal(
                    np.asarray(p2.mu)[rows1], np.asarray(p1.mu)[rows1]),
                "posterior_changed_rows_direct_fit": direct_same,
            }
            eng.stop()
            t_wait = time.perf_counter()
            kid.wait(timeout=600)
        finally:
            if kid.poll() is None:
                kid.kill()
                kid.wait()
        walls["killed_child"] = time.perf_counter() - t_kid
        walls["killed_child_wait"] = time.perf_counter() - t_wait
        with open(kid_log) as fh:
            kid_tail = fh.read()[-1500:]
        plan2 = refit.read_refit_plan(scratch2)
        active_after_kill = reg.active_version()
        _c, _dd, out2 = refit.cycle_paths(scratch2, plan2)
        landed2 = orchestrate.load_fit_state(out2, plan2["n_changed"])
        cyc2 = clock("resume", refit.run_refit, data_dir=dset, registry=reg,
                     scratch=scratch2, chunk=RS_CHUNK,
                     solver_config=SolverConfig(max_iters=solver.max_iters),
                     phase1_iters=DP_PHASE1, no_phase1_tune=True,
                     horizons=RF_HORIZONS, **dev_kw)
        v3 = cyc2.get("version")
        got3, _ = reg.load(v3, fallback=False).take(rows2)
        handoff = {"scratch": scratch, "dset": dset, "registry": reg.root,
                   "cfg": cfg, "ids": ids, "advi_cfg": advi_cfg,
                   "version": v3}
        res["cycle2"] = {
            "rows": int(len(rows2)), "child_rc": kid.returncode,
            "active_after_kill": active_after_kill,
            "plan_incomplete_after_kill": not plan2.get("complete"),
            **{k: cyc2.get(k) for k in ("resumed", "complete",
                                        "fit_dispatches", "version",
                                        "wall_s")},
            "same_bits_as_child": rs_same(got3, landed2),
            "unchanged_same": {p: all(v["rows_same"] for v in
                                      _cols_rows_equal(
                                          v2d, reg.version_dir(v3), p,
                                          np.setdiff1d(np.arange(n),
                                                       rows2)).values())
                               for p in (snapplane.COL_PREFIX,
                                         fplane.FCOL_PREFIX,
                                         qplane.QCOL_PREFIX)},
        }
        emit(res)
        c1 = res["cycle1"]
        require(res["v1"]["fplane"] == "published"
                and res["v1"]["qplane"] == "published",
                f"version 1's planes: {res['v1']}")
        require(c1["detected_is_delta"] and c1["n_changed"] == len(rows1),
                f"the detected set is the delta's rows: {c1['n_changed']}")
        require(c1["fit_path"] == "fileproto"
                and c1["fallback_warnings"] == 1,
                f"the one-card fallback, one warning: {c1['fit_path']} "
                f"{fallback}")
        require(c1["fplane"] == "published-delta"
                and c1["qplane"] == "published-delta",
                f"the planes published as deltas: {c1}")
        bad = {p: [k for k, v in c.items() if not v["rows_same"]]
               for p, c in cols.items()}
        require(all(c for c in cols.values())
                and not any(bad.values()),
                f"unchanged rows' snapshot, forecast and quantile bytes are "
                f"the base's: {bad}")
        require(cols[snapplane.COL_PREFIX].get(
            f"{snapplane.COL_PREFIX}ids.npy", {}).get("hardlink"),
                "the id column (no refit row touches it) is a hard link")
        require(all(c1["same_bits_as_reference_fit"].values()),
                f"the refit rows against the cold fit of the spill: "
                f"{c1['same_bits_as_reference_fit']}")
        require(eng_ok["version_v2"] and eng_ok["unchanged_same_from_cache"]
                and eng_ok["changed_recomputed"] and eng_ok["carried"] > 0
                and eng_ok["hot_changed"] > 0,
                f"the engine after the flip: {eng_ok}")
        require(c1["posterior_unchanged_rows_same"]
                and c1["posterior_changed_rows_moved"],
                "the posterior advanced on the changed rows only")
        require(all(direct_same.values()),
                f"the changed rows' posterior is fit_advi's on the cycle's "
                f"theta, spill rows and seed: {direct_same}")
        lc = res["cycle1_launches_in_process"]
        require(lc["forward"] > 0 and lc["advi"] > 0
                and lc["loss_grad"] > 0,
                f"the cycle launched K1, K3 (the posterior's draws) and K7: "
                f"{lc}")
        c2 = res["cycle2"]
        require(c2["child_rc"] == RF_KILL_RC and c2["active_after_kill"] == v2
                and c2["plan_incomplete_after_kill"],
                f"the killed cycle: rc {kid.returncode} {kid_tail}")
        require(c2["resumed"] and c2["complete"]
                and c2["fit_dispatches"] == 0
                and all(c2["same_bits_as_child"].values())
                and all(c2["unchanged_same"].values()),
                f"the resumed cycle: {c2}")
        res["handoff"] = handoff
    finally:
        if "handoff" not in res:
            shutil.rmtree(scratch, ignore_errors=True)
    return res


def add_resident_refit(kernels, rd, rf) -> None:
    """K3's and K4's entries gain their launches on phase resident's
    resumed run, and the time split's launches and block checks; K1, K3
    and K7 theirs on phase refit (version 1's ADVI fit and cycle 1 in
    this process; cycle 1's fit ran in a worker)."""
    ts = rd["time_split"]
    for k in kernels:
        name = k["name"]
        if name in ("loss", "fan"):
            k["time_split_check"] = [b["gap"] for b in ts["blocks"]]
        if name == "loss":
            k["launches_resident"] = (rd["resume_launches"]["loss_grad"]
                                      + rd["resume_launches"]["loss_value"])
            k["launches_time_split"] = (ts["launches"]["loss_grad"]
                                        + ts["launches"]["loss_value"])
            c1 = rf["cycle1_launches_in_process"]
            k["launches_refit"] = c1["loss_grad"] + c1["loss_value"]
            k["launches_refit_stack"] = \
                rf["cycle1_launches_in_process"]["loss_stack"]
        elif name == "fan":
            k["launches_resident"] = rd["resume_launches"]["fan"]
            k["launches_time_split"] = ts["launches"]["fan"]
        elif name == "forward":
            k["launches_refit"] = rf["cycle1_launches_in_process"]["forward"]
        elif name == "advi":
            k["launches_refit"] = rf["cycle1_launches_in_process"]["advi"]


SC_DELTAS = 6             # the stream's deltas (DEFAULT_FRESHNESS_DELTAS)
SC_CHURN = 0.05           # each delta's churn (DEFAULT_FRESHNESS_CHURN)
SC_GAP_S = 1.0            # between two landings
SC_FLIP_RC = 29           # the daemon child's exit at sched_flip
SC_ALERT_H = 1            # the alert stream's horizon
SC_QUIET_K = 1e9          # the data-liveness multiple: quiet (CPU-tested)
SC_RUN_S = 600.0          # every loop's bound
SC_SEED = 23              # off_optimum's seed for the wave's K3/K4 check

SC_CHILD_TIMEOUT_S = 600.0


class _StageWalls:
    """Per-call walls of the refit stages the scheduler drives (detect =
    ``draft_plan``, ``ensure_spill``, ``fit_changed``, ``publish_plan``),
    recorded by wrapping the ``refit`` module's functions while a loop
    runs (the scheduler calls them through the module)."""

    NAMES = {"draft_plan": "detect", "ensure_spill": "spill",
             "fit_changed": "fit", "publish_plan": "publish"}

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()
        self._saved = {}

    def __enter__(self):
        from tsspark_tpu_torch import refit

        for fn, stage in self.NAMES.items():
            real = getattr(refit, fn)
            self._saved[fn] = real

            def timed(*a, _real=real, _stage=stage, **k):
                t0 = time.time()
                try:
                    return _real(*a, **k)
                finally:
                    with self._lock:
                        self.calls.append(
                            {"stage": _stage, "t0": t0, "s": time.time() - t0,
                             "thread": threading.current_thread().name})
            setattr(refit, fn, timed)
        return self

    def __exit__(self, *exc):
        from tsspark_tpu_torch import refit

        for fn, real in self._saved.items():
            setattr(refit, fn, real)
        return False


def _version_bytes(vdir, prefixes) -> dict:
    out = {}
    for name in sorted(os.listdir(vdir)):
        if name.startswith(prefixes) and name.endswith(".npy"):
            with open(os.path.join(vdir, name), "rb") as fh:
                out[name] = fh.read()
    return out


def _sched_versions(reg, after: int) -> list:
    """The versions published after ``after``: (version, base, stamp,
    changed rows), ascending."""
    out = []
    for v in sorted(reg.versions()):
        if v <= after:
            continue
        info = reg.delta_info(v) or {}
        out.append({"version": int(v), "base": info.get("base_version"),
                    "stamp": int(reg.version_stamp(v)),
                    "changed": np.asarray(info.get("changed_rows", []),
                                          np.int64)})
    return out


def sc_alerts(dset, eng, root, cli_env, cpu: bool = False) -> dict:
    """Phase sched's leg (c) alerts: an ``AlertStream`` at SC_ALERT_H over
    the stream's plane and engine scoring every landed delta (interval
    mode); a second stream in a fresh directory; a scorer killed at each
    ``alert_publish`` point and healed; the sink's keys; and the CLI
    (``python -m tsspark_tpu_torch.alerts --poll-once``, started first, on
    the card) scoring the same deltas into a directory of its own."""
    from tsspark_tpu_torch.alerts import JsonlSink
    from tsspark_tpu_torch.alerts import stream as stream_mod
    from tsspark_tpu_torch.alerts.stream import AlertStream
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.resilience import faults

    n_seq = plane.delta_seq(dset)
    here = os.path.dirname(os.path.abspath(__file__))
    cli_dir = os.path.join(root, "alerts_cli")
    cli_log = os.path.join(root, "alerts_cli.log")
    t_cli = time.perf_counter()
    with open(cli_log, "w") as fh:
        cli = subprocess.Popen(
            [sys.executable, "-m", "tsspark_tpu_torch.alerts", "--data",
             dset, "--registry", eng.registry.root, "--alerts-dir", cli_dir,
             "--sink", "jsonl:" + os.path.join(root, "alerts_cli.jsonl"),
             "--horizon", str(SC_ALERT_H), "--overdue-k", str(SC_QUIET_K),
             "--poll-once", *(["--device", "cpu"] if cpu else [])],
            cwd=here, env=cli_env, stdout=fh,
            stderr=subprocess.STDOUT)
    try:
        def stream(name, sink=None):
            d = os.path.join(root, name)
            return AlertStream(
                d, dset, eng, sink or JsonlSink(d + "_sink.jsonl"),
                horizon=SC_ALERT_H, overdue_k=SC_QUIET_K)

        def records(name):
            d = os.path.join(root, name)
            out = {}
            for q in range(1, n_seq + 1):
                with open(os.path.join(d, f"alertrec_{q:06d}.json"),
                          "rb") as fh:
                    out[q] = fh.read()
            return out

        t0 = time.perf_counter()
        first = stream("log")
        polled = first.poll_once()
        score_s = time.perf_counter() - t0
        recs = [first.record_ok(q) for q in range(1, n_seq + 1)]
        want = records("log")
        stream("again").poll_once()
        kills = {}
        for k in range(3):
            plan = faults.FaultPlan(
                state_dir=os.path.join(root, f"faults{k}"))
            plan.fail(stream_mod.ALERT_PUBLISH, after=k, mode="raise",
                      tag=f"alerts-kill-{k}")
            os.environ[faults.ENV_VAR] = plan.to_env()
            try:
                stream(f"kill{k}").poll_once()
                raised = False
            except faults.FaultInjected:
                raised = True
            finally:
                os.environ.pop(faults.ENV_VAR, None)
            healed = stream(f"kill{k}")
            healed.poll_once()
            kills[k] = {"raised": raised,
                        "scored_seq": healed.scored_seq(),
                        "delivered_seq": healed.delivered_seq(),
                        "same_bytes": records(f"kill{k}") == want}
        sink_keys = [a["key"] for a in
                     JsonlSink(os.path.join(root, "log_sink.jsonl")).alerts()]
        fired = [a["key"] for r in recs for a in r["alerts"]]
        cli.wait(timeout=SC_CHILD_TIMEOUT_S)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    with open(cli_log) as fh:
        cli_out = fh.read()
    cli_same = (cli.returncode == 0
                and records("alerts_cli") == want)
    out = {
        "deltas": n_seq, "polled": polled, "score_s": score_s,
        "modes": sorted({r["mode"] for r in recs}),
        "versions": sorted({r["version"] for r in recs}),
        "scored_rows": int(sum(r["n_scored"] for r in recs)),
        "fired": len(fired),
        "second_stream_same_bytes": records("again") == want,
        "kills": kills,
        "sink_each_key_once": (len(sink_keys) == len(set(sink_keys))
                               and set(sink_keys) == set(fired)),
        "cli": {"rc": cli.returncode, "same_bytes": cli_same,
                "wall_s": time.perf_counter() - t_cli,
                "tail": cli_out[-400:]},
    }
    require(out["modes"] == ["interval"] and polled["scored"] == n_seq
            and polled["watermark"] == n_seq and not polled["stalled"],
            f"every delta scored in interval mode and delivered: {out}")
    require(out["second_stream_same_bytes"],
            "a second stream gives the same canonical bytes")
    require(all(v["raised"] and v["same_bytes"]
                and v["scored_seq"] == v["delivered_seq"] == n_seq
                for v in kills.values()),
            f"a scorer killed at each alert_publish point heals to the "
            f"same bytes: {kills}")
    require(out["sink_each_key_once"] and out["fired"] > 0,
            "the sink holds each fired key exactly once")
    require(cli_same, f"the alerts CLI's log: {out['cli']}")
    return out


def sc_wave(data_dir, cfg, n: int):
    """A cycle's one resident wave as ``resident.run_resident`` packs it:
    the spill's ``n`` rows padded to RS_CHUNK with inert rows (no
    regressors: phase refit's model)."""
    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.models.prophet.design import (
        pack_fit_data, prepare_fit_data)

    ds, d = orchestrate._load_data(data_dir)
    y_c = orchestrate._pad_chunk_rows(d["y"], 0, n, RS_CHUNK)
    data, meta = prepare_fit_data(
        ds, y_c, cfg,
        mask=orchestrate._chunk_mask(y_c, d["mask"], 0, n, RS_CHUNK))
    return pack_fit_data(data, meta, ds, reg_u8_cols=(),
                         collapse_cap=True)[0]


def phase_sched(device, hand) -> dict:
    """The always-on refit loop and the alert stream on phase refit's
    plane (30,490 series, days [0, 1746) and its two deltas) and registry
    (version 3 active: snapshot, forecast and ADVI-mode quantile planes
    at RF_HORIZONS, the ADVI posterior), config 3 without regressors.

    (a) A copy of both is taken; a lander thread lands SC_DELTAS deltas
    of SC_CHURN churn (``plane.land_synthetic_delta``) SC_GAP_S apart
    through ``RefitScheduler(pipeline=True, speculate=True)`` in this
    process on an explicit one-device mesh of cuda:0 (the loop's fit
    resident), flips through a ``PredictionEngine`` on the card
    (prefetch, materialize the RF_HOT hot series, activate), freshness
    probed by served requests.  Launch counts set to 0 just before, read
    just after.  Required: the final version covers every delta, zero
    wrong-version answers, nothing pending; on every hop the unchanged
    rows' snapshot, forecast and quantile bytes are the base's.
    (b) The same deltas landed on the copy, ``RefitScheduler(
    pipeline=False)`` run to each stamp (a) published at: the same
    versions, and the final snapshot, forecast plane, quantile plane and
    posterior bitwise (a)'s (the check on two threads launching on one
    card); on the last cycle's wave K3 (both modes) and K4 against their
    plain versions by GAP_RULE (a dropped cell must fail), K1 on its
    forecast-plane chunk against its plain version, and its changed
    rows' posterior bitwise ``fit_advi`` run directly.
    (c) Beside (b): ``python -m tsspark_tpu_torch.sched`` on the card over
    (a)'s world after one more delta, killed at an armed ``sched_flip``
    exit (its rc, the active version untouched, its ``fit_path``: the
    one-card default), resumed by a successor with zero fit dispatches
    and one cycle, landing the child's bits; then the alert stream
    (``sc_alerts``)."""
    import shutil

    import torch

    from tsspark_tpu_torch import orchestrate, refit, sched
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.design import (
        packed_to_device, prepare_fit_data, unpack_fit_data)
    from tsspark_tpu_torch.models.prophet.predict import (
        prepare_predict_data)
    from tsspark_tpu_torch.parallel.mesh import make_mesh
    from tsspark_tpu_torch.resilience import faults
    from tsspark_tpu_torch.serve import ForecastCache, ParamRegistry
    from tsspark_tpu_torch.serve import fplane, snapplane
    from tsspark_tpu_torch.serve.engine import PredictionEngine
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import qplane

    t_phase = time.perf_counter()
    cfg, ids, v0 = hand["cfg"], hand["ids"], int(hand["version"])
    solver = configs.SOLVER3
    n = len(ids)
    root = tempfile.mkdtemp(prefix="sched_", dir=hand["scratch"])
    mesh_dev = (torch.device("cuda", 0) if device.type == "cuda"
                else torch.device("cpu"))
    mesh = make_mesh(1, 1, devices=[mesh_dev])
    dev_kw = {} if device.type == "cuda" else {"device": "cpu"}
    res = {"phase": "sched", "series": n, "base_version": v0,
           "deltas": SC_DELTAS, "churn": SC_CHURN, "gap_s": SC_GAP_S}
    walls = res["walls_s"] = {}
    # (b)'s world: copies taken before (a) lands anything.
    t0 = time.perf_counter()
    dset, reg = hand["dset"], ParamRegistry(hand["registry"], cfg)
    dset_b = os.path.join(root, "plane_b", os.path.basename(dset))
    shutil.copytree(dset, dset_b)
    shutil.copytree(reg.root, os.path.join(root, "registry_b"))
    reg_b = ParamRegistry(os.path.join(root, "registry_b"), cfg)
    walls["copy"] = time.perf_counter() - t0
    stamp0 = plane.delta_seq(dset)

    # (a) the stream.
    eng = PredictionEngine(reg, cache=ForecastCache(4 * RF_HOT),
                           device=device)
    hot = [str(s) for s in ids[:RF_HOT]]
    eng.materialize(hot, RF_HORIZONS)

    def flip_fn(v):
        eng.prefetch(v)
        eng.materialize(hot, RF_HORIZONS, version=v)
        reg.activate(v)

    def probe(v):
        return eng.forecast([hot[0]], RF_HORIZONS[0]).version

    common = dict(chunk=RS_CHUNK, solver_config=solver,
                  horizons=RF_HORIZONS, mesh=mesh, **dev_kw)
    loop = sched.RefitScheduler(
        dset, reg, os.path.join(root, "sched_a"), pipeline=True,
        speculate=True, flip_fn=flip_fn, freshness_probe=probe, **common)
    landed = []

    def lander():
        for _ in range(SC_DELTAS):
            landed.append(plane.land_synthetic_delta(dset, SC_CHURN))
            time.sleep(SC_GAP_S)

    lt = threading.Thread(target=lander, name="sched-lander", daemon=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    with _StageWalls() as sw:
        lt.start()
        summary = loop.run(until_stamp=stamp0 + SC_DELTAS,
                           duration_s=SC_RUN_S)
    if device.type == "cuda":
        torch.cuda.synchronize()
    walls["stream"] = time.perf_counter() - t0
    res["launches_sched"] = _kernel_counts()
    lt.join(timeout=60)
    hops = _sched_versions(reg, v0)
    v_final = summary["head_version"]
    hop_checks = {}
    for h in hops:
        keep = np.setdiff1d(np.arange(n), h["changed"])
        cols = {p: _cols_rows_equal(reg.version_dir(h["base"]),
                                    reg.version_dir(h["version"]), p, keep)
                for p in (snapplane.COL_PREFIX, fplane.FCOL_PREFIX,
                          qplane.QCOL_PREFIX)}
        hop_checks[h["version"]] = {
            p: bool(c) and all(v["rows_same"] for v in c.values())
            for p, c in cols.items()}
    stage_s = {}
    for c in sw.calls:
        stage_s.setdefault(c["stage"], []).append(round(c["s"], 4))
    res["a"] = {
        "summary": {k: summary[k] for k in (
            "cycles", "failures", "head_version", "head_stamp",
            "pending_deltas", "wall_s", "busy_s", "cycle_overhead_frac",
            "freshness", "spec", "wrong_version", "probe_failures",
            "fit_path", "ok")},
        "landed_rows": [int(r["n_changed"]) for r in landed],
        "versions": [{k: (int(len(v)) if k == "changed" else v)
                      for k, v in h.items()} for h in hops],
        "stage_walls_s": stage_s,
        "stage_sum_s": float(sum(c["s"] for c in sw.calls)),
        "publisher_thread_s": float(sum(
            c["s"] for c in sw.calls if c["thread"] == "sched-publish")),
        "unchanged_rows_same": hop_checks,
    }
    emit({"phase": "sched", "leg": "a", **res["a"],
          "launches_sched": res["launches_sched"]})
    require(summary["ok"] and summary["pending_deltas"] == 0
            and summary["wrong_version"] == 0
            and summary["head_stamp"] == stamp0 + SC_DELTAS
            and reg.version_stamp(v_final) == stamp0 + SC_DELTAS
            and reg.active_version() == v_final
            and summary["freshness"]["n"] == SC_DELTAS,
            f"the stream: every delta covered, none pending, no wrong "
            f"version: {res['a']['summary']}")
    require(summary["fit_path"] == "resident",
            f"the loop's fit ran resident: {summary['fit_path']}")
    require(hops and all(all(c.values()) for c in hop_checks.values()),
            f"unchanged rows keep their base bytes on every hop: "
            f"{hop_checks}")
    lc = res["launches_sched"]
    require(all(lc[k] > 0 for k in ("forward", "loss_grad", "loss_value",
                                     "loss_stack", "fan", "advi")),
            f"the loop launched K1, K3 (gradient, value, draw stack), K4 "
            f"and K7: {lc}")

    # (c)'s daemon child, beside (b): one more delta on (a)'s plane.
    plane.land_synthetic_delta(dset, SC_CHURN)
    stamp_c = plane.delta_seq(dset)
    scratch_c = os.path.join(root, "sched_c")
    fplan = faults.FaultPlan(state_dir=os.path.join(root, "faults_c"))
    fplan.fail("sched_flip", attempts=1, after=0, mode="exit",
               rc=SC_FLIP_RC, tag="loop-storm")
    env = dict(os.environ)
    env.pop(faults.ENV_VAR, None)
    cli_env = dict(env)
    env[faults.ENV_VAR] = fplan.to_env()
    here = os.path.dirname(os.path.abspath(__file__))
    kid_log = os.path.join(root, "sched_child.log")
    t_kid = time.perf_counter()
    with open(kid_log, "w") as kid_fh:
        kid = subprocess.Popen(
            [sys.executable, "-m", "tsspark_tpu_torch.sched", "--data", dset,
             "--registry", reg.root, "--scratch", scratch_c, "--chunk",
             str(RS_CHUNK), "--max-iters", str(solver.max_iters),
             "--until-stamp", str(stamp_c), "--duration",
             str(SC_CHILD_TIMEOUT_S), *(["--device", "cpu"] if dev_kw
                                       else [])],
            cwd=here, env=env, stdout=kid_fh, stderr=subprocess.STDOUT)
    try:
        # (b) the serialized replay on the copy.
        t0 = time.perf_counter()
        loop_b = sched.RefitScheduler(
            dset_b, reg_b, os.path.join(root, "sched_b"), pipeline=False,
            **common)
        seq = stamp0
        sums_b = []
        for h in hops:
            while seq < h["stamp"]:
                plane.land_synthetic_delta(dset_b, SC_CHURN)
                seq += 1
            sums_b.append(loop_b.run(until_stamp=h["stamp"],
                                     duration_s=SC_RUN_S))
        walls["replay"] = time.perf_counter() - t0
        hops_b = _sched_versions(reg_b, v0)
        same_plans = [
            (a["version"], a["base"], a["stamp"]) == (b["version"], b["base"],
                                                      b["stamp"])
            and np.array_equal(a["changed"], b["changed"])
            for a, b in zip(hops, hops_b)] + [len(hops) == len(hops_b)]
        vdir_a, vdir_b = reg.version_dir(v_final), reg_b.version_dir(v_final)
        prefixes = (snapplane.COL_PREFIX, fplane.FCOL_PREFIX,
                    qplane.QCOL_PREFIX)
        bytes_a = _version_bytes(vdir_a, prefixes)
        bytes_b = _version_bytes(vdir_b, prefixes)
        post_a, _ = advi_mod.load_posterior(vdir_a)
        post_b, head_b = advi_mod.load_posterior(vdir_b)
        replay = {
            "cycles": [s["cycles"] for s in sums_b],
            "ok": all(s["ok"] for s in sums_b),
            "same_plans": all(same_plans),
            "same_columns": bool(bytes_a) and bytes_a == bytes_b,
            "differing_columns": sorted(k for k in bytes_a
                                        if bytes_a[k] != bytes_b.get(k)),
            "same_posterior": all(np.array_equal(
                np.asarray(getattr(post_a, f)),
                np.asarray(getattr(post_b, f)))
                for f in ("mu", "rho", "elbo")),
        }
        # The last cycle's wave, its forecast-plane chunk and posterior.
        last = hops_b[-1]
        rows = last["changed"]
        plan = {"base_version": last["base"],
                "base_stamp": int(reg_b.version_stamp(last["base"])),
                "plan_stamp": last["stamp"], "n_changed": int(len(rows)),
                "changed_rows": rows.tolist(), "complete": False}
        ddir = refit.ensure_spill(dset_b, plan, os.path.join(root, "spill"))
        packed = sc_wave(ddir, cfg, len(rows))
        data = unpack_fit_data(packed_to_device(packed, device), ())
        snap = reg_b.load(v_final, fallback=False)
        st_rows, _ = snap.take(rows)
        th = st_rows.theta.to(device, torch.float32)
        b_w = data.t.shape[0]
        th = torch.cat([th, th[:1].expand(b_w - len(rows), -1)])
        theta_h, d_h = off_optimum(th, SC_SEED)
        wave = hold_kernels(theta_h, d_h, data, cfg, "a refit cycle's wave")
        del data, packed
        part = rows[:fplane._PUBLISH_CHUNK]
        st_p, step_p = snap.take(part)
        grid = fplane.future_grid(st_p, step_p, 8)
        pdata = prepare_predict_data(grid, st_p.meta, cfg, device)
        scale = torch.as_tensor(st_p.meta.y_scale, dtype=torch.float32,
                                device=device)
        floor = torch.as_tensor(st_p.meta.floor, dtype=torch.float32,
                                device=device)
        th_p = st_p.theta.to(device, torch.float32)
        got = fk.forward(th_p, pdata, cfg, scale, floor)
        want = fk.forward_plain(th_p, pdata, cfg, scale, floor)
        k1 = {"shape": list(pdata.t.shape),
              "max_rel_err": _forward_err(got, want, scale),
              "max_abs_err": max(float((g - w).abs().max())
                                 for g, w in zip(got, want))}
        load = lambda f: np.load(os.path.join(ddir, f))  # noqa: E731
        data_s, _ = prepare_fit_data(load("ds.npy"), load("y.npy"), cfg,
                                     mask=load("mask.npy"))
        direct = advi_mod.fit_advi(
            np.asarray(st_rows.theta, np.float32), data_s,
            torch.Generator(device=device).manual_seed(
                refit.posterior_seed(int(head_b["seed"]), v_final)),
            cfg, hand["advi_cfg"], device=device)
        del data_s
        replay["posterior_direct_fit"] = {f: bool(np.array_equal(
            np.asarray(getattr(post_b, f))[rows],
            getattr(direct, f).detach().cpu().numpy()))
            for f in ("mu", "rho", "elbo")}
        replay["wave"] = wave
        replay["forward"] = k1
        walls["replay_checks"] = time.perf_counter() - t0 - walls["replay"]
        res["b"] = replay
        emit({"phase": "sched", "leg": "b", **replay})
        require(replay["ok"] and replay["same_plans"],
                f"the replay's plans are the stream's: {replay}")
        require(replay["same_columns"] and replay["same_posterior"],
                f"the serialized replay is bitwise the pipelined stream: "
                f"{replay['differing_columns']}")
        require(all(replay["posterior_direct_fit"].values()),
                f"the last cycle's posterior is fit_advi's: "
                f"{replay['posterior_direct_fit']}")
        require(k1["max_rel_err"] <= 2e-5,
                f"K1 on the forecast plane's delta chunk: {k1}")

        # (c) the daemon child, its successor, the alerts.
        t_wait = time.perf_counter()
        kid.wait(timeout=SC_CHILD_TIMEOUT_S)
    finally:
        if kid.poll() is None:
            kid.kill()
            kid.wait()
    walls["child"] = time.perf_counter() - t_kid
    walls["child_wait"] = time.perf_counter() - t_wait
    with open(kid_log) as fh:
        kid_tail = fh.read()[-1500:]
    active_after_kill = reg.active_version()
    plan_c = refit.read_refit_plan(scratch_c)
    _cd, _dd, out_c = refit.cycle_paths(scratch_c, plan_c)
    landed_c = orchestrate.load_fit_state(out_c, plan_c["n_changed"])
    resumes = []
    real_run_refit = refit.run_refit

    def recording(**kw):
        out = real_run_refit(**kw)
        resumes.append(out)
        return out

    refit.run_refit = recording
    try:
        t0 = time.perf_counter()
        succ = sched.RefitScheduler(
            dset, reg, scratch_c, chunk=RS_CHUNK,
            solver_config=SolverConfig(max_iters=solver.max_iters),
            flip_fn=flip_fn, **dev_kw).run(until_stamp=stamp_c,
                                           duration_s=SC_RUN_S)
        walls["resume"] = time.perf_counter() - t0
    finally:
        refit.run_refit = real_run_refit
    v_c = succ["head_version"]
    got_c, _ = reg.load(v_c, fallback=False).take(
        np.asarray(plan_c["changed_rows"], np.int64))
    res["c"] = {
        "child_rc": kid.returncode, "active_after_kill": active_after_kill,
        "plan_incomplete_after_kill": not plan_c.get("complete"),
        "successor": {k: succ[k] for k in ("cycles", "resumed_cycles",
                                           "head_version", "head_stamp",
                                           "fit_path", "ok")},
        "resume_fit_dispatches": [r.get("fit_dispatches") for r in resumes],
        "resume_fit_path": [r.get("fit_path") for r in resumes],
        "child_fell_back": "no usable device mesh" in kid_tail,
        "same_bits_as_child": rs_same(got_c, landed_c),
    }
    t0 = time.perf_counter()
    res["c"]["alerts"] = sc_alerts(dset, eng, root, cli_env,
                                   cpu=bool(dev_kw))
    walls["alerts"] = time.perf_counter() - t0
    eng.stop()
    c = res["c"]
    require(c["child_rc"] == SC_FLIP_RC and active_after_kill == v_final
            and c["plan_incomplete_after_kill"],
            f"the daemon child killed at sched_flip: rc {kid.returncode} "
            f"{kid_tail}")
    require(succ["ok"] and succ["cycles"] == 1 and succ["resumed_cycles"] == 1
            and c["resume_fit_dispatches"] == [0]
            and reg.active_version() == v_c and v_c != v_final
            and reg.version_stamp(v_c) == stamp_c
            and all(c["same_bits_as_child"].values()),
            f"the successor resumed the pinned plan: {c}")
    res["phase_s"] = time.perf_counter() - t_phase
    emit({k: v for k, v in res.items() if k not in ("a", "b")})
    return res


def add_sched(kernels, sc) -> None:
    """K1, K3, K4 and K7's entries gain their launches on phase sched's
    stream (counts set to 0 just before it, read just after), and K3/K4
    and K1 the replay's checks on the last cycle's wave and forecast-plane
    chunk."""
    lc, b = sc["launches_sched"], sc["b"]
    for k in kernels:
        name = k["name"]
        if name == "loss":
            k["launches_sched"] = lc["loss_grad"] + lc["loss_value"]
            k["launches_sched_stack"] = lc["loss_stack"]
            k["sched_wave_check"] = b["wave"]["gap"]
        elif name == "fan":
            k["launches_sched"] = lc["fan"]
            k["sched_wave_check"] = b["wave"]["gap"]["fan"]
        elif name == "forward":
            k["launches_sched"] = lc["forward"]
            k["sched_chunk_check"] = b["forward"]
        elif name == "advi":
            k["launches_sched"] = lc["advi"]


def add_new_paths(kernels, fleet_m5, eval12, planes) -> None:
    """K1, K3 and K4's entries gain their launches and checks on phase
    stream_fleet_m5's warm run (K3/K4 at the warm optimum), on eval
    configs 1 and 2 (the fits, forecasts and their shapes' checks) and
    on phase planes' paths (K1: the forecast plane's full and delta
    publish, the compute path's reads)."""
    m5 = fleet_m5["warm"]["launches"]
    e12 = {name: c for name, c in eval12["configs"].items()}
    for k in kernels:
        name = k["name"]
        if name not in ("loss", "fan", "forward"):
            continue
        if name in ("loss", "fan"):
            m5_n = (m5["loss_grad"] + m5["loss_value"] if name == "loss"
                    else m5["fan"])
            k["launches_stream_fleet_m5"] = m5_n
            k["stream_fleet_m5_check_at_warm_optimum"] = {
                "gap_max": fleet_m5["kernels_at_warm_optimum"]["gap_max"],
                "chunks": fleet_m5["kernels_at_warm_optimum"]["chunks"]}
        else:
            k["launches_stream_fleet_m5"] = \
                fleet_m5["forecast"]["launches"]["forward"]
            k["launches_planes"] = planes["launches_forward"]
            k["planes_check"] = "plane hits bitwise the compute path"
        for cname, c in e12.items():
            launch = c["launches"]
            k[f"launches_{cname}"] = (
                launch["loss_grad"] + launch["loss_value"] if name == "loss"
                else launch[name])
            k[f"{cname}_check"] = c["kernels"][name]


# Phase frontend: the user front end on config 3's model and phase fit's
# batch (``m5_like(30490, 1941, seed=2)``, nothing generated anew at fleet
# size): ``frame.Forecaster`` over a long DataFrame, cross-validation, the
# ``mcmc_samples`` route, and the ``python -m tsspark_tpu_torch`` CLI with
# the forecaster checkpoint.  Each leg is cut to fit the run's time, never
# in width: config 3's widths throughout.
FE_SERIES = 8192          # (a): one CudaBackend chunk of the 30,490
FE_CPU_SUBSET = 64        # (a): the plain CPU leg, in a ParityFits worker
FE_CV_SERIES = 1024       # (b)
# Three cutoffs (days 512, 1212, 1912): 3,072 rows whose masks the card's
# length-bucket plan cuts into three windows (with 420 / 700 days it
# declines: < 20% saved).
FE_CV = {"horizon": "28D", "period": "700D", "initial": "300D"}
FE_MCMC_SERIES = 256      # (c)
FE_MCMC_SAMPLES = 300
FE_PREDICTIVE_SAMPLES = 100
FE_CLI_SERIES = 256       # (d)
FE_CLI_ARGS = ("--seasonality", "yearly:365.25:8", "--seasonality",
               "weekly", "--country-holidays", "US", "--max-iters", "120")
# ``python -m tsspark_tpu_torch`` by ``runpy.run_module`` (what ``-m``
# does), then one JSON line on stderr: the exit code, the kernel
# library's loads and builds in the child, and its launch counts.
FE_CLI_CHILD = r"""
import json, runpy, sys, time
t0 = time.perf_counter()
rc = 0
try:
    runpy.run_module("tsspark_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
import chip_smoke
from tsspark_tpu_torch.kernels import build
print(json.dumps({"rc": rc, "wall_s": time.perf_counter() - t0,
                  "loads": build.loads, "builds": build.builds,
                  "build_s": build.build_seconds,
                  "launches": chip_smoke._fe_counts()}), file=sys.stderr)
sys.exit(rc)
"""


def fe_long_frame(batch, n: int, lo: int, hi: int, with_y: bool = True):
    """Rows [0, n) and days [lo, hi) of ``m5_like``'s batch as a long
    frame: ``series_id`` (``datasets.dataset_ids``, a categorical column),
    ``ds`` datetimes (day 13514 = 2007-01-01), ``y`` (NaN before a
    series' launch), ``price`` and ``promo``."""
    import pandas as pd

    from tsspark_tpu_torch.data.datasets import dataset_ids

    t_len = hi - lo
    days = pd.to_datetime(batch.ds[lo:hi], unit="D").values
    cols = {"series_id": pd.Categorical.from_codes(
                np.repeat(np.arange(n), t_len),
                categories=dataset_ids("m5", 0, n)),
            "ds": np.tile(days, n)}
    if with_y:
        cols["y"] = batch.y[:n, lo:hi].reshape(-1)
    for j, name in ((1, "price"), (2, "promo")):
        cols[name] = batch.regressors[:n, lo:hi, j].reshape(-1)
    return pd.DataFrame(cols)


def fe_holiday(batch):
    """The generator's holiday calendar as a ``Holiday`` (from a Prophet
    holidays frame): the days its shared indicator column marks."""
    import pandas as pd

    from tsspark_tpu_torch.models.holidays import holidays_from_df

    days = batch.ds[batch.regressors[0, :, 0] > 0]
    return holidays_from_df(pd.DataFrame(
        {"holiday": "holiday", "ds": pd.to_datetime(days, unit="D")}))


def fe_forecaster(holidays, device_kw: dict, **kw):
    """Config 3's model as a user builds it for a long frame: yearly 8 +
    weekly 3, 25 changepoints, the price and promo columns, the holiday
    as a ``Holiday`` (its indicator column appended after them), 120
    iterations; ``backend="cuda"`` on the card (``device_kw`` empty)."""
    import dataclasses

    from tsspark_tpu_torch import Forecaster
    from tsspark_tpu_torch.eval import configs

    cfg = dataclasses.replace(configs.CONFIG3, regressors=tuple(
        r for r in configs.CONFIG3.regressors if r.name != "holiday"))
    return Forecaster(cfg, configs.SOLVER3, backend="cuda",
                      regressor_cols=("price", "promo"), holidays=holidays,
                      **device_kw, **kw)


def fe_regressors(batch, n: int) -> np.ndarray:
    """The generator's regressors in the Forecaster's column order
    (price, promo, holiday), rows [0, n)."""
    r = batch.regressors[:n]
    return np.concatenate([r[..., 1:3], r[..., :1]], axis=-1)


def frontend_cpu_job(train_df, holidays) -> dict:
    """Phase frontend's CPU leg in a ``ParityFits`` worker: the same
    Forecaster on the port's plain path (``device="cpu"``), its train
    yhat (no sampling)."""
    import torch

    torch.set_num_threads(PARITY_THREADS)
    fc = fe_forecaster(holidays, {"device": "cpu"})
    t0 = time.perf_counter()
    fc.fit(train_df)
    secs = time.perf_counter() - t0
    out = fc.predict(future_df=train_df.drop(columns="y"), num_samples=0)
    return {"seconds": secs, "loss": np.asarray(fc.state.loss),
            "yhat": out.yhat.to_numpy().reshape(len(fc.series_ids), -1)}


def _fe_counts() -> dict:
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import draws as dk
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    return {"forward": fk.launches, "bands": bands_k.launches,
            "loss_grad": lk.grad_launches,
            "loss_value": lk.launches - lk.grad_launches,
            "fan": fan_k.launches, "draws": dk.launches}


def _fe_zero() -> None:
    from tsspark_tpu_torch.kernels import draws as dk

    _zero_counts()
    dk.launches = 0


def _fe_sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


class BackendCalls:
    """While active, ``CudaBackend``'s fit, predict and components record
    each outermost call: the backend, what it was handed and what it
    returned.  Phase frontend holds what the front end hands the array
    path against the generator's arrays, and what it gives the user
    against these returns: the same arrays in and the answers passed on
    unchanged are the array path's bits."""

    NAMES = ("fit", "predict", "components")

    def __init__(self):
        self.calls = []
        self._depth = 0
        self._orig = {}

    def __enter__(self):
        from tsspark_tpu_torch.backends.cuda import CudaBackend

        self._orig = {n: CudaBackend.__dict__[n] for n in self.NAMES}
        for n, f in self._orig.items():
            setattr(CudaBackend, n, self._wrap(n, f))
        return self

    def __exit__(self, *exc) -> None:
        from tsspark_tpu_torch.backends.cuda import CudaBackend

        for n, f in self._orig.items():
            setattr(CudaBackend, n, f)

    def _wrap(self, name, f):
        def call(bk, *args, **kwargs):
            self._depth += 1
            try:
                out = f(bk, *args, **kwargs)
            finally:
                self._depth -= 1
            if self._depth == 0:
                self.calls.append({"name": name, "backend": bk,
                                   "args": args, "kwargs": kwargs,
                                   "out": out})
            return out
        return call

    def only(self, name: str) -> dict:
        got = [c for c in self.calls if c["name"] == name]
        require(len(got) == 1, f"one CudaBackend.{name} call: {len(got)}")
        return got[0]


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def fe_handed(got, want, dtype) -> bool:
    """``got`` is ``want`` in ``dtype``: that dtype, the same shape, the
    same values (NaN where NaN)."""
    if got is None or want is None:
        return got is None and want is None
    got = np.asarray(got)
    return (got.dtype == dtype and got.shape == np.shape(want)
            and bool(np.array_equal(got, np.asarray(want, dtype),
                                    equal_nan=True)))


def fe_backend_as_user_builds(bk, config, dev_kw) -> bool:
    """``bk`` is the backend a user of the array path builds for
    ``config``: ``get_backend("cuda", config, SOLVER3)`` with the device
    (the same class, solver, device, chunk and options)."""
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs

    ref = get_backend("cuda", config, configs.SOLVER3, **dev_kw)
    keys = ("solver_config", "device", "resilient", "chunk_size",
            "iter_segment", "length_buckets", "rescue", "compact")
    return (type(bk) is type(ref) and bk.config == config
            and all(getattr(bk, k) == getattr(ref, k) for k in keys))


def fe_cli_start(args, cwd, device_kw) -> subprocess.Popen:
    """A CLI child of phase frontend (``FE_CLI_CHILD``, with ``--device
    cpu`` off the card)."""
    args = [*args, *(["--device", "cpu"] if device_kw else [])]
    return subprocess.Popen([sys.executable, "-c", FE_CLI_CHILD, *args],
                            cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def fe_finish(proc, what: str) -> dict:
    """Wait for a child of phase frontend; its last stderr line (JSON)."""
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    lines = err.strip().splitlines()
    require(proc.returncode == 0 and bool(lines),
            f"{what}: rc {proc.returncode}: {err[-2000:]}")
    return json.loads(lines[-1])


def _file_bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def phase_frontend(device, batch, cpu_leg) -> dict:
    """The user front end on phase fit's batch: (a) ``Forecaster.fit`` of
    a long frame of the first 8,192 series on days [0, 1746),
    ``predict(future_df=)``, ``components``, ``make_future_frame`` (the
    pivot bitwise the generator's arrays; what the Forecaster hands
    ``CudaBackend.fit``, ``predict`` and ``components`` the generator's
    arrays bitwise, on the backend a user of the array path builds, and
    its state, forecast frame and components those calls' returns
    bitwise; the plain CPU leg on 64 series within the fit budget); (b)
    ``diagnostics.cross_validation`` of 1,024 series (its
    ``backtest.cross_validation`` call handed the generator's arrays,
    the frame that call's result bitwise; K3 in both modes and K4 held
    against their plain versions on each length bucket of the CV's fit,
    at its fitted theta, observed and inert rows apart); (c) the
    ``mcmc_samples`` route on 256 series; (d) the CLI's four commands in
    child processes on the card, each output bitwise the same command run
    in this process, the kernel library loaded, not rebuilt.  The
    children start after (a)'s timed stages and run beside (b)-(d); the
    kernel holds of (b) run once they are done."""
    import contextlib
    import io
    import shutil

    import pandas as pd
    import torch

    from tsspark_tpu_torch import frame as frame_mod
    from tsspark_tpu_torch import __main__ as cli
    from tsspark_tpu_torch.backends.cuda import _take_rows
    from tsspark_tpu_torch.eval import backtest, configs, diagnostics, metrics

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    dev_kw = {} if on_card else {"device": "cpu"}
    t_len = batch.y.shape[1]
    split = configs.split_point(t_len)
    h = t_len - split
    n = min(FE_SERIES, batch.y.shape[0])
    m = min(FE_CV_SERIES, batch.y.shape[0])
    k = FE_CPU_SUBSET
    hol = fe_holiday(batch)
    out = {"phase": "frontend", "cuts": {
        "a": f"series {n} of {batch.y.shape[0]} (one chunk), days [0, "
             f"{split}) fitted, {h} forecast; CPU leg {k} series",
        "b": f"{m} series x {t_len} days, {FE_CV}",
        "c": f"{FE_MCMC_SERIES} series x {split} days, mcmc_samples="
             f"{FE_MCMC_SAMPLES}, 28-day forecast",
        "d": f"{FE_CLI_SERIES} series x {split} days, "
             f"{' '.join(FE_CLI_ARGS)}"}}

    # -- (a) the long-frame fit, timed alone --------------------------------
    t0 = time.perf_counter()
    train_df = fe_long_frame(batch, n, 0, split)
    hold_df = fe_long_frame(batch, n, split, t_len, with_y=False)
    frame_s = time.perf_counter() - t0
    frame_bytes = int(train_df.memory_usage(deep=True).sum())
    t0 = time.perf_counter()
    pv = frame_mod.pivot_long(train_df, regressor_cols=("price", "promo"))
    pivot_s = time.perf_counter() - t0
    reg = fe_regressors(batch, n)
    pivot_same = {
        "ds": bool(np.array_equal(pv.ds, batch.ds[:split])),
        "y": bool(np.array_equal(pv.y, batch.y[:n, :split],
                                 equal_nan=True)),
        "regressors": bool(np.array_equal(pv.regressors,
                                          reg[:, :split, :2])),
        "series_ids": bool(np.array_equal(pv.series_ids.astype(str),
                                          batch.series_ids[:n])),
    }
    del pv
    fc = fe_forecaster(hol, dev_kw)
    _fe_sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with BackendCalls() as rec:
        _fe_zero()
        t0 = time.perf_counter()
        fc.fit(train_df)
        _fe_sync(device)
        fit_s = time.perf_counter() - t0
        fit_launches = _fe_counts()
        stages = dict(fc.backend.stages.seconds)
        fc.backend.stages.reset()
        _fe_zero()
        t0 = time.perf_counter()
        pred = fc.predict(future_df=hold_df)
        _fe_sync(device)
        predict_s = time.perf_counter() - t0
        predict_stages = dict(fc.backend.stages.seconds)
        predict_launches = _fe_counts()
        hold28 = hold_df[hold_df.ds < hold_df.ds.min()
                         + pd.Timedelta(days=HORIZON)]
        c_ds, comps = fc.components(future_df=hold28)
    fut = fc.make_future_frame(HORIZON)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del train_df, hold_df, hold28

    # What the Forecaster handed the array path, and what it passed on.
    f_c, p_c, c_c = (rec.only(x) for x in ("fit", "predict", "components"))
    h28 = slice(split, split + HORIZON)
    f32 = np.dtype(np.float32)
    handed = {
        "backend": fe_backend_as_user_builds(f_c["backend"], fc.config,
                                             dev_kw),
        "fit.ds": fe_handed(f_c["args"][0], batch.ds[:split], batch.ds.dtype),
        "fit.y": fe_handed(f_c["args"][1], batch.y[:n, :split], f32),
        "fit.regressors": fe_handed(f_c["kwargs"]["regressors"],
                                    reg[:, :split], f32),
        "fit.no_other_input": all(f_c["kwargs"].get(x) is None for x in (
            "mask", "cap", "floor", "conditions", "init")),
        "predict.ds": fe_handed(p_c["args"][1], batch.ds[split:],
                                batch.ds.dtype),
        "predict.regressors": fe_handed(p_c["kwargs"]["regressors"],
                                        reg[:, split:], f32),
        "components.ds": fe_handed(c_c["args"][1], batch.ds[h28],
                                   batch.ds.dtype),
        "components.regressors": fe_handed(c_c["kwargs"]["regressors"],
                                           reg[:, h28], f32),
        "predict_and_components.fitted_state": (
            p_c["args"][0] is f_c["out"] and c_c["args"][0] is f_c["out"]
            and all(c["backend"] is f_c["backend"] for c in (p_c, c_c))),
    }
    fcd = {k2: _np(v) for k2, v in p_c["out"].items()}
    passed_on = {
        "state": fc.state is f_c["out"],
        "forecast_keys_differing": [
            k2 for k2, v in fcd.items() if not np.array_equal(
                pred[k2].to_numpy().reshape(n, h), v)],
        "component_keys_differing": [
            k2 for k2, v in c_c["out"].items()
            if not np.array_equal(comps[k2], _np(v))],
    }
    t0 = time.perf_counter()
    fc._to_long(batch.ds[split:], fcd)
    scatter_s = time.perf_counter() - t0
    want_ds = frame_mod._days_to_ts(
        np.tile(batch.ds[split:split + HORIZON], n)).to_numpy()
    future_ok = (len(fut) == n * HORIZON
                 and bool(np.array_equal(fut.ds.to_numpy(), want_ds))
                 and bool(np.array_equal(c_ds.to_numpy(),
                                         want_ds[:HORIZON])))
    s_hold = metrics.smape(np.nan_to_num(batch.y[:n, split:]),
                           fcd["yhat"], batch.mask[:n, split:])
    # The card's train forecast of the CPU leg's rows (not a counted leg).
    train_yhat = _np(fc.backend.predict(
        _take_rows(fc.state, slice(0, k)), batch.ds[:split],
        regressors=reg[:k, :split].astype(np.float32),
        num_samples=0)["yhat"])
    del pred, fcd, rec, f_c, p_c, c_c

    # -- the CLI children ----------------------------------------------------
    work = tempfile.mkdtemp(prefix="frontend_")
    root = os.path.dirname(os.path.abspath(__file__))
    p = lambda name: os.path.join(work, name)  # noqa: E731
    cv_days = {k2: float(pd.Timedelta(v) / pd.Timedelta(days=1))
               for k2, v in FE_CV.items()}
    t0 = time.perf_counter()
    cli_df = fe_long_frame(batch, FE_CLI_SERIES, 0, split)
    csv = p("in.csv")
    cli_df[["series_id", "ds", "y"]].dropna(subset=["y"]).to_csv(
        csv, index=False)
    inputs_s = time.perf_counter() - t0
    del cli_df
    bt = [a for k2, v in cv_days.items() for a in (f"--{k2}", f"{v:g}")]

    def commands(tag):
        return {
            "forecast": ["forecast", "--input", csv, "--horizon", "28",
                         "--output", p(f"{tag}_forecast.csv"),
                         *FE_CLI_ARGS],
            "fit": ["fit", "--input", csv, "--model", p(f"{tag}_m.npz"),
                    *FE_CLI_ARGS],
            "predict": ["predict", "--model", p(f"{tag}_m.npz"),
                        "--horizon", "28", "--output",
                        p(f"{tag}_predict.csv")],
            "backtest": ["backtest", "--input", csv, *bt, "--output",
                         p(f"{tag}_pm.csv"), "--cv-output",
                         p(f"{tag}_cv.csv"), *FE_CLI_ARGS],
        }

    sub_cmds = commands("sub")
    t_children = time.perf_counter()
    children = {c: fe_cli_start(sub_cmds[c], root, dev_kw)
                for c in ("forecast", "fit", "backtest")}
    stop = threading.Event()

    def chain_predict():
        # predict reads the checkpoint the fit child writes.
        children["fit"].wait()
        if children["fit"].returncode == 0 and not stop.is_set():
            children["predict"] = fe_cli_start(sub_cmds["predict"], root,
                                               dev_kw)

    chained = threading.Thread(target=chain_predict, daemon=True)
    chained.start()
    bt_calls = []
    cv_run = backtest.cross_validation

    def recorded_cv(*args, **kwargs):
        res = cv_run(*args, **kwargs)
        bt_calls.append({"args": args, "kwargs": kwargs, "out": res})
        return res

    try:
        # -- (b) cross-validation -------------------------------------------
        cv_df = fe_long_frame(batch, m, 0, t_len)
        backtest.cross_validation = recorded_cv
        try:
            with BackendCalls() as rec_cv:
                _fe_zero()
                t0 = time.perf_counter()
                cv = diagnostics.cross_validation(fc, cv_df, **FE_CV)
                pm = diagnostics.performance_metrics(cv)
                _fe_sync(device)
                cv_s = time.perf_counter() - t0
                cv_launches = _fe_counts()
        finally:
            backtest.cross_validation = cv_run
        del cv_df

        # -- (c) the mcmc_samples route -------------------------------------
        nm = min(FE_MCMC_SERIES, batch.y.shape[0])
        mc_train = fe_long_frame(batch, nm, 0, split)
        mc_fut = fe_long_frame(batch, nm, split, split + HORIZON,
                               with_y=False)
        fcm = fe_forecaster(hol, dev_kw, mcmc_samples=FE_MCMC_SAMPLES)
        _fe_zero()
        t0 = time.perf_counter()
        fcm.fit(mc_train)
        _fe_sync(device)
        mc_fit_s = time.perf_counter() - t0
        mc_fit_launches = _fe_counts()
        _fe_zero()
        t0 = time.perf_counter()
        mp = fcm.predict(future_df=mc_fut)
        _fe_sync(device)
        mc_pred_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ps = fcm.predictive_samples(future_df=mc_fut,
                                    num_samples=FE_PREDICTIVE_SAMPLES)
        mc_ps_s = time.perf_counter() - t0
        mc_pred_launches = _fe_counts()
        diag = fcm.mcmc_diagnostics()
        lo_, yh, hi_ = (mp[c].to_numpy()
                        for c in ("yhat_lower", "yhat", "yhat_upper"))
        out["c"] = {
            "series": nm, "fit_s": mc_fit_s, "predict_s": mc_pred_s,
            "predictive_samples_s": mc_ps_s,
            "launches": {"fit": mc_fit_launches,
                         "predict": mc_pred_launches},
            "samples_shape": list(ps["yhat_samples"].shape),
            "accept_rate_mean": float(diag.accept_rate.mean()),
            "rhat_over_1.1_share": float((diag.rhat_max > 1.1).mean()),
            "divergences": int(diag.divergences.sum()),
            "finite": bool(np.isfinite(
                mp.select_dtypes("number").to_numpy()).all()
                and np.isfinite(ps["yhat_samples"]).all()),
            "lower_le_yhat": bool((lo_ <= yh).all()),
            "yhat_le_upper": bool((yh <= hi_).all()),
            "diagnostics_columns": list(diag.columns),
        }
        del fcm, mc_train, mp, ps

        # -- (d) the same commands in this process --------------------------
        in_cmds = commands("in")
        extra = [] if on_card else ["--device", "cpu"]
        _fe_zero()
        t0 = time.perf_counter()
        for c in ("forecast", "fit", "predict", "backtest"):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(in_cmds[c] + extra)
            require(rc == 0, f"in-process CLI {c}")
        _fe_sync(device)
        cli_in_s = time.perf_counter() - t0
        cli_in_launches = _fe_counts()

        # -- the children's results ------------------------------------------
        t0 = time.perf_counter()
        reps = {c: fe_finish(children[c], f"child {c}")
                for c in ("forecast", "fit", "backtest")}
        chained.join()
        reps["predict"] = fe_finish(children["predict"], "child predict")
        children_s = time.perf_counter() - t_children
        wait_s = time.perf_counter() - t0
        cli_diff = [f for f in ("forecast.csv", "predict.csv", "pm.csv",
                                "cv.csv")
                    if _file_bytes(p(f"sub_{f}")) != _file_bytes(p(f"in_{f}"))]
        with np.load(p("sub_m.npz")) as zs, np.load(p("in_m.npz")) as zi:
            cli_diff += [f"m.npz:{k2}" for k2 in zi.files
                         if not np.array_equal(zs[k2], zi[k2])]
        sub_pred = pd.read_csv(p("sub_predict.csv"))
    finally:
        stop.set()
        for c in ("forecast", "fit", "backtest"):
            if children[c].poll() is None:
                children[c].kill()
        chained.join()
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    # (a) the CPU leg.
    t0 = time.perf_counter()
    cpu = cpu_leg.get()
    cpu_wait_s = time.perf_counter() - t0
    m_train = batch.mask[:k, :split]
    y_train = np.nan_to_num(batch.y[:k, :split])
    d_train = (metrics.smape(y_train, train_yhat, m_train)
               - metrics.smape(y_train, cpu["yhat"], m_train))
    out["a"] = {
        "series": n, "days_fit": split, "days_forecast": h,
        "frame_build_s": frame_s, "rows_train": n * split,
        "frame_bytes": frame_bytes,
        "pivot_s": pivot_s, "fit_s": fit_s, "fit_stages_s": stages,
        "fit_front_end_s": fit_s - sum(stages.values()),
        "predict_s": predict_s, "predict_stages_s": predict_stages,
        "scatter_to_long_s": scatter_s,
        "launches": {"fit": fit_launches, "predict": predict_launches},
        "peak_device_bytes": peak,
        "smape_holdout": float(s_hold.mean()),
        "pivot_bitwise_generator": pivot_same,
        "handed_the_generator_arrays": handed,
        "passed_on_bitwise": passed_on,
        "future_frame_ok": future_ok,
        "cpu_leg": {"series": k, "seconds": cpu["seconds"],
                    "wait_s": cpu_wait_s,
                    "smape_train_max_abs_delta": float(
                        np.abs(d_train).max()),
                    "smape_train_mean_delta": float(d_train.mean()),
                    "loss_minus_cpu_mean": float(np.mean(
                        np.asarray(fc.state.loss)[:k] - cpu["loss"]))},
    }

    # (b): backtest handed the generator's arrays, the frame its result,
    # and K3/K4 on each length bucket of its fit (the card quiet again).
    require(len(bt_calls) == 1, f"one backtest call: {len(bt_calls)}")
    bt_c, cf_c = bt_calls[0], rec_cv.only("fit")
    cva = bt_c["out"]
    cv_handed = {
        "ds": fe_handed(bt_c["args"][0], batch.ds, batch.ds.dtype),
        "y": fe_handed(bt_c["args"][1], batch.y[:m],
                       np.asarray(bt_c["args"][1]).dtype),
        "regressors": fe_handed(bt_c["kwargs"]["regressors"],
                                fe_regressors(batch, m),
                                np.asarray(bt_c["kwargs"]["regressors"])
                                .dtype),
        "windows": {k2: bt_c["kwargs"][k2] for k2 in
                    ("horizon", "period", "initial")} == cv_days,
        "no_cap": bt_c["kwargs"].get("cap") is None,
        "backend": fe_backend_as_user_builds(cf_c["backend"], fc.config,
                                             dev_kw),
    }
    sel = cva["eval_mask"] > 0
    i, j, kk = np.nonzero(sel)
    order = np.lexsort((kk, j, i))  # the frame's series, cutoff, ds
    cv_diff = [c for c in ("yhat", "yhat_lower", "yhat_upper")
               if not np.array_equal(cv[c].to_numpy(), cva[c][sel][order])]
    if not np.array_equal(cv["y"].to_numpy(), batch.y[:m][i, kk][order]):
        cv_diff.append("y")
    n_cut = len(cva["cutoffs"])
    t0 = time.perf_counter()
    plan, cv_held = dp_held(
        cf_c["backend"], fc.config, cf_c["out"].theta, cf_c["args"][0],
        cf_c["args"][1], cf_c["kwargs"]["mask"],
        cf_c["kwargs"]["regressors"], device, "a CV bucket")
    held_s = time.perf_counter() - t0
    del rec_cv, cf_c, bt_calls, bt_c
    out["b"] = {
        "series": m, "cutoffs": n_cut, "rows_fitted": m * n_cut,
        "frame_rows": len(cv), "wall_s": cv_s,
        "launches": cv_launches,
        "length_buckets": _plan_json(plan),
        "backtest_handed_the_generator_arrays": cv_handed,
        "columns_not_bitwise_backtest": cv_diff,
        "kernels_buckets": cv_held, "kernels_held_s": held_s,
        "performance_metrics_head": pm.head(3).assign(
            horizon=pm.horizon.head(3).astype(str)).to_dict("list"),
    }
    out["d"] = {
        "series": FE_CLI_SERIES, "inputs_write_s": inputs_s,
        "children_wall_s": children_s, "children_wait_s": wait_s,
        "in_process_s": cli_in_s, "in_process_launches": cli_in_launches,
        "children": {c: {k2: r[k2] for k2 in ("rc", "wall_s", "loads",
                                               "builds", "build_s",
                                               "launches")}
                     for c, r in reps.items()},
        "outputs_not_bitwise_in_process": cli_diff,
        "predict_rows": len(sub_pred),
        "predict_finite": bool(np.isfinite(
            sub_pred.select_dtypes("number").to_numpy()).all()),
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)

    a, c, d = out["a"], out["c"], out["d"]
    require(all(pivot_same.values()),
            f"pivot bitwise the generator's arrays: {pivot_same}")
    require(all(handed.values()),
            f"the Forecaster hands CudaBackend the generator's arrays: "
            f"{handed}")
    require(passed_on["state"] and not passed_on["forecast_keys_differing"]
            and not passed_on["component_keys_differing"],
            f"the Forecaster passes the array path's results on: "
            f"{passed_on}")
    require(future_ok, "make_future_frame / components grid")
    require(bool(np.isfinite(s_hold).all()), "holdout sMAPE finite")
    require(a["cpu_leg"]["smape_train_max_abs_delta"] <= 0.1
            and abs(a["cpu_leg"]["smape_train_mean_delta"]) <= 0.05,
            f"CPU leg within the fit budget: {a['cpu_leg']}")
    require(all(cv_handed.values()),
            f"the CV hands backtest the generator's arrays: {cv_handed}")
    require(n_cut >= 3 and not cv_diff,
            f"CV frame bitwise backtest ({n_cut} cutoffs): {cv_diff}")
    require(plan is not None and len(cv_held) >= len(plan),
            f"the CV's rows in length buckets, K3/K4 held on each: "
            f"{_plan_json(plan)}")
    require(c["finite"] and c["lower_le_yhat"] and c["yhat_le_upper"]
            and c["samples_shape"] == [FE_PREDICTIVE_SAMPLES, nm, HORIZON],
            f"mcmc_samples route: {c}")
    require(not cli_diff, f"CLI outputs bitwise in-process: {cli_diff}")
    require(d["predict_rows"] == FE_CLI_SERIES * HORIZON
            and d["predict_finite"], "CLI predict output")
    if on_card:
        # (``components`` is torch ops: no kernel on its route.)
        fl, pl_ = fit_launches, predict_launches
        require(fl["loss_grad"] > 0 and fl["loss_value"] > 0
                and fl["fan"] > 0 and pl_["forward"] > 0
                and pl_["bands"] > 0, f"K1-K4 on leg (a): {a['launches']}")
        cl = cv_launches
        require(cl["loss_grad"] > 0 and cl["loss_value"] > 0
                and cl["fan"] > 0 and cl["forward"] > 0 and cl["bands"] > 0,
                f"K1-K4 on leg (b): {cl}")
        require(mc_fit_launches["loss_grad"] > 0
                and mc_pred_launches["draws"] > 0,
                f"K3 and K6 on leg (c): {c['launches']}")
        ran = {"forecast": ("loss_grad", "fan", "forward", "bands"),
               "fit": ("loss_grad", "fan"),
               "predict": ("forward", "bands"),
               "backtest": ("loss_grad", "fan", "forward", "bands")}
        for cmd, r in d["children"].items():
            require(r["loads"] == 1 and r["builds"] == 0,
                    f"CLI {cmd} loaded the built library: {r}")
            require(all(r["launches"][x] > 0 for x in ran[cmd]),
                    f"CLI {cmd} launches: {r['launches']}")
    return out


def add_frontend(kernels, fe) -> None:
    """K1, K2, K3, K4 and K6's entries gain their launches on phase
    frontend's legs (the CLI's summed over its four child processes), and
    K3/K4 their checks and event-timed ms on the CV's length buckets."""
    a, b, c, d = fe["a"], fe["b"], fe["c"], fe["d"]
    kids = [r["launches"] for r in d["children"].values()]
    for k in kernels:
        keys = {"forward": ("forward",), "bands": ("bands",),
                "loss": ("loss_grad", "loss_value"), "fan": ("fan",),
                "draws": ("draws",)}.get(k["name"])
        if keys is None:
            continue
        count = lambda row: sum(row[x] for x in keys)  # noqa: E731
        k["launches_frontend"] = {
            "forecaster": sum(count(r) for r in a["launches"].values()),
            "cross_validation": count(b["launches"]),
            "mcmc_samples": sum(count(r) for r in c["launches"].values()),
            "cli_in_process": count(d["in_process_launches"]),
            "cli_children": sum(count(r) for r in kids),
        }
        if k["name"] in ("loss", "fan"):
            k["frontend_cv_check"] = _held_checks(k["name"],
                                                  b["kernels_buckets"])


# Phase serve_scale: serving at scale on phase serve's registry (the M5
# shape, 30,490 series x 1,941 days, ``ProphetConfig()``), through the
# entry points a user calls: the in-process loadgen, the replica pool, the
# kernel bank and the JSONL daemon.  The loadgen's request mix is the JAX
# package's (``serve/__main__.py``).
SS_REQUESTS = 10_000
SS_REPLICAS = 2
SS_CLIENTS = 4            # the pool loadgen's min(8, 2 R)
SS_WAVE = 64              # max_batch // 2, as the pool loadgen pipelines
SS_CHECK_SERIES = 512     # asked through the pool after the flip
SS_WARM_SERIES = 256      # warmed into each replica's cache at v1
SS_LONG_HORIZON = 56      # bucket 64: past the forecast plane, K1 per call
SS_KILL_AT = 0.1          # the SIGKILL of replica 1, as a share of requests
SS_RESPAWN_S = 180.0
SS_POOL_WIDTHS = (8, 16, 32, 64, 128, 256)
SS_BANDS_SAMPLES = 20     # the mix's sampled requests
SS_MC_SAMPLES = 256       # K2's in-distribution check at the pool's shape


_POINT_KEYS = ("yhat", "trend", "additive", "multiplicative")


def _replica_counters(pool, slot) -> dict:
    """Replica ``slot``'s K1 / K2 launches, dispatch widths and cache
    rows carried forward so far, from its ``stats``."""
    r = pool._request_slot(slot, {"cmd": "stats"}, timeout_s=30.0)
    require(bool(r.get("ok")), f"replica {slot}'s stats: {r}")
    k = r["kernels"]
    return {"pid": r["pid"], "forward": k["forward"], "bands": k["bands"],
            "carried": r["cache"]["carried"],
            "dispatch_widths": dict(k["dispatch_widths"])}


def _counters_diff(after, before) -> dict:
    """``after`` less ``before`` (None: a process's start, all zero)."""
    before = before or {"forward": 0, "bands": 0, "carried": 0,
                        "dispatch_widths": {}}
    bw = before["dispatch_widths"]
    return {**{k: after[k] - before[k]
               for k in ("forward", "bands", "carried")},
            "dispatch_widths": {w: c - bw.get(w, 0) for w, c in
                                after["dispatch_widths"].items()
                                if c - bw.get(w, 0)}}


def _counters_add(a, b) -> dict:
    widths = dict(a["dispatch_widths"])
    for w, c in b["dispatch_widths"].items():
        widths[w] = widths.get(w, 0) + c
    return {**{k: a[k] + b[k] for k in ("forward", "bands", "carried")},
            "dispatch_widths": widths}


def cold_pool(root, pool_dir, env):
    """A one-replica pool whose replica gets ``env`` on top of this
    process's environment."""
    from tsspark_tpu_torch.serve import ReplicaPool

    return ReplicaPool(pool_dir, root, n_replicas=1, env=env,
                       spawn_timeout_s=900.0)


def cold_replica(pool, series, warm=False) -> dict:
    """``pool``'s replica spawned cold (one attempt, the pool's own
    spawn); ``time_to_first_request_s`` from the spawn to its first
    forecast answered.  The replica's own counters say whether it built
    the kernel library, where it loaded it from, and whether its first
    request saw a build (``CompileWatch`` over the builds only).  The
    caller stops the pool."""
    t0 = time.perf_counter()
    require(pool._spawn(0), "the cold replica started")
    t_up = time.perf_counter()
    resp = pool.forecast(series, HORIZON)
    t1 = time.perf_counter()
    require(bool(resp.get("ok")),
            f"cold replica's first request: {resp.get('error')}")
    ladder = None
    if warm:
        w = pool._request_slot(0, {
            "cmd": "warm", "version": resp["version"],
            "series_ids": list(series), "horizons": [7, 14, 28],
        }, timeout_s=300.0)
        require(bool(w.get("ok")), f"warm: {w}")
        ladder = w.get("ladder")
    st = pool._request_slot(0, {"cmd": "stats"}, timeout_s=30.0)
    k = st["kernels"]
    return {"time_to_first_request_s": t1 - t0, "spawn_to_ready_s": t_up - t0,
            "first_request_s": t1 - t_up,
            "library_builds": k["library_builds"],
            "library_loads": k["library_loads"], "build_s": k["build_s"],
            "first_request_builds": k["first_request_builds"],
            "build_dir": k["build_dir"], "bank": k["bank"],
            "forward": k["forward"], "ladder": ladder,
            "version": resp["version"], "from_cache": resp["from_cache"]}


def pool_kernel_checks(snap, cfg, rows, device) -> dict:
    """K1 and K2 at the pool's dispatch shapes (the engine's pow-2 widths
    for 1-8-series requests coalesced up to a pump's batch, at horizon
    buckets 8 / 16 / 32), on the served version's rows: K1 against its
    plain version (f32 rule) and each row the same bits in a reversed
    batch; K2 on given draws against its plain version at S = 20, and on
    its own Philox draws in distribution against the plain version's
    generator at the 128-row, bucket-32 shape replicated to 4,096 rows,
    at S = 256 where ``_require_mc``'s limits were set; both timed at
    128 x 32 against their bounds."""
    import torch

    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data
    from tsspark_tpu_torch.serve.fplane import future_grid

    f_tol, b_tol, s = 2e-5, 1e-5, SS_BANDS_SAMPLES
    gen = torch.Generator(device=device).manual_seed(21)

    def inputs(idx, hb):
        state, step = snap.take(np.asarray(idx))
        data = prepare_predict_data(future_grid(state, step, hb),
                                    state.meta, cfg, device)
        theta = state.theta.to(device)
        scale = torch.as_tensor(state.meta.y_scale, dtype=torch.float32,
                                device=device)
        floor = torch.as_tensor(state.meta.floor, dtype=torch.float32,
                                device=device)
        return theta, data, scale, floor

    shapes = {}
    for w in SS_POOL_WIDTHS:
        for hb in (8, 16, 32):
            theta, data, scale, floor = inputs(rows[:w], hb)
            got = fk.forward(theta, data, cfg, scale, floor)
            want = fk.forward_plain(theta, data, cfg, scale, floor)
            f_err = _forward_err(got, want, scale)
            require(f_err <= f_tol, f"K1 at {w}x{hb}: {f_err}")
            rev = torch.arange(w - 1, -1, -1, device=device)
            flip = fk.forward(theta[rev].contiguous(), _rows(data, rev),
                              cfg, scale[rev].contiguous(),
                              floor[rev].contiguous())
            require(all(torch.equal(g, x[rev]) for g, x in zip(flip, got)),
                    f"K1 at {w}x{hb}: a reversed batch differs")
            _, det, add, mult = fk.forward(theta, data, cfg)
            kargs = (theta, data, det, add, mult, scale, floor, cfg)
            draws = bk.sample_draws((s, w, hb), gen, device)
            b_err = _band_err(bk.bands(*kargs, s, draws=draws),
                              bk.bands_plain(*kargs, draws), scale)
            require(b_err <= b_tol, f"K2 at {w}x{hb}x{s}: {b_err}")
            shapes[f"{w}x{hb}"] = {"forward_rel_err": f_err,
                                   "bands_rel_err": b_err}
    # K2's own draws in distribution: the 128-row, bucket-32 shape's rows
    # 32 times over (each copy its own Philox row coordinate), at S = 256.
    big = np.tile(np.asarray(rows[:128]), 32)
    theta, data, scale, floor = inputs(big, 32)
    _, det, add, mult = fk.forward(theta, data, cfg)
    kargs = (theta, data, det, add, mult, scale, floor, cfg)
    own = bk.bands(*kargs, SS_MC_SAMPLES, seed=11)
    cpu = (theta.cpu(), data._replace(**{f: getattr(data, f).cpu()
                                         for f in data._fields}),
           *(x.cpu() for x in kargs[2:7]), cfg)
    ref = {k: v.to(device)
           for k, v in bk.bands(*cpu, SS_MC_SAMPLES, seed=11).items()}
    sigma = torch.exp(theta[:, 2])[:, None] * scale[:, None]
    mc = _mc_compare(own, ref, "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc, "yhat_lower", "yhat_upper", "pool-shape bands")
    # Times at the mix's typical dispatch, 128 rows x bucket 32.
    tw = min(128, len(rows))
    theta, data, scale, floor = inputs(rows[:tw], 32)
    _, det, add, mult = fk.forward(theta, data, cfg)
    kargs = (theta, data, det, add, mult, scale, floor, cfg)
    draws = bk.sample_draws((s, tw, 32), gen, device)
    timing = {
        "forward": {"shape": [tw, 32, "per-series X"],
                    "ms": cuda_ms(lambda: fk.forward(theta, data, cfg,
                                                     scale, floor)),
                    "plain_ms": cuda_ms(lambda: fk.forward_plain(
                        theta, data, cfg, scale, floor), iters=5),
                    **forward_bound_ms(tw, 32, cfg, True, True)},
        "bands": {"shape": [tw, 32, s],
                  "ms": cuda_ms(lambda: bk.bands(*kargs, s, seed=3)),
                  "plain_ms": cuda_ms(lambda: bk.bands_plain(*kargs, draws),
                                      iters=5),
                  **bands_bound_ms(tw, 32, s, cfg),
                  **bands_variates_bound_ms(tw, 32, s, cfg)},
    }
    return {"shapes": shapes, "monte_carlo_yhat_s256": mc,
            "tolerance": {"forward": f"|k-p|/(y_scale+|p|) <= {f_tol}",
                          "bands": f"|k-p|/(y_scale+|p|) <= {b_tol} "
                                   "(given draws)"},
            "timing": timing}


def phase_serve_scale(device, serve) -> dict:
    """(a) the in-process loadgen, (b) the replica pool with a delta flip
    and a replica SIGKILL, (c) cold replicas with and without the kernel
    bank, (d) the JSONL daemon as a child process (beside (c))."""
    import shutil
    import signal

    import torch

    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import build
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.obs import history
    from tsspark_tpu_torch.perf import PerfRecorder, get_perf
    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
        ReplicaPool,
        aotbank,
        shard_of,
    )
    from tsspark_tpu_torch.serve import __main__ as cli
    from tsspark_tpu_torch.serve import fplane
    from tsspark_tpu_torch.serve.fplane import future_grid

    inp = serve["inputs"]
    root, batch, cfg = inp["root"], inp["batch"], inp["cfg"]
    reg = ParamRegistry.open(root)
    v1 = reg.active_version()
    snap1 = reg.load()
    sids = [str(x) for x in snap1.series_ids]
    n = len(sids)
    scratch = tempfile.mkdtemp(prefix="serve_scale_")
    walls = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        return out

    q_env = os.environ.get("TSSPARK_QPLANE")
    pool = None
    cold_pools = {}
    daemon = None
    try:
        # (a) The in-process loadgen, ending in the sentinel (its history
        # in this phase's scratch).
        args = cli.build_parser().parse_args([
            "--loadgen", str(SS_REQUESTS), "--registry", root,
            "--dir", os.path.join(scratch, "a"),
            "--report", os.path.join(scratch, "SERVE_a.json"),
            "--history", os.path.join(scratch, "history",
                                      "RUNHISTORY.jsonl")])
        args.device = device
        _zero_counts()
        rc = stage("a_loadgen", cli._loadgen, args)
        a_launches = {"forward": fk.launches, "bands": bk.launches}
        require(rc == 0, f"the loadgen's sentinel exit code {rc}")
        with open(args.report) as fh:
            rep_a = json.load(fh)
        eng_a = rep_a["engine"]
        require(a_launches["forward"] > 0 and a_launches["bands"] > 0,
                f"K1 and K2 launched on the loadgen: {a_launches}")
        require(eng_a["failed"] == 0 and eng_a["rejected"] == 0,
                f"loadgen failures {eng_a}")
        require(eng_a["completed"] + eng_a["shed"] == SS_REQUESTS,
                "every loadgen request answered or shed")
        require(rep_a["dispatch"]["n_dispatches"] == eng_a["dispatches"],
                "one perf record a dispatch")
        rows = history.read_history(args.history)
        require(len(rows) == 1 and rows[0]["device_class"] == "gpu",
                f"the sentinel's row: {rows}")
        a_out = {
            "wall_s": rep_a["wall_s"],
            "requests_per_s": rep_a["requests_per_s"],
            "latency_ms": eng_a["latency_ms"], "shed": eng_a["shed"],
            "dispatches": eng_a["dispatches"],
            "batch_occupancy": eng_a["batch_occupancy"],
            "cache": rep_a["cache"],
            "dispatch": {k: v for k, v in rep_a["dispatch"].items()
                         if k != "segments"},
            "launches": a_launches, "device": rep_a["device"],
            "sentinel_row": {k: rows[0].get(k) for k in
                             ("kind", "device_class", "workload")},
        }
        emit({"phase": "serve_scale", "leg": "a", **a_out})

        # (b) The flip target: a delta version refitting 1% of the rows
        # through CudaBackend with a perf recorder (warm from v1).
        changed = np.linspace(0, n - 1, int(round(n * PLANES_DELTA_FRAC))) \
            .astype(np.int64)
        rec = PerfRecorder()
        bkd = get_backend("cuda", cfg, SolverConfig(max_iters=25),
                          device=device, perf=rec)
        _zero_counts()
        sub = stage("b_delta_refit", bkd.fit, batch.ds, batch.y[changed],
                    mask=batch.mask[changed],
                    init=snap1.state.theta[torch.as_tensor(changed)].clone())
        refit_counts = _stream_counts()
        perf_rep = get_perf(sub)
        require(perf_rep is not None and perf_rep.segments,
                "CudaBackend(perf=) attached its per-dispatch report")
        v2 = reg.publish_delta(sub, changed, step_sub=np.ones(len(changed)),
                               activate=False)
        # (c)'s kernel bank, built at publish (a copy of this process's
        # build), idempotent across a second build.
        bank = os.path.join(scratch, "bank")
        snap2 = reg.load(v2, fallback=False)
        built = stage("c_build_bank", aotbank.build_bank, snap2, bkd,
                      dirpath=bank)
        again = aotbank.build_bank(snap2, bkd, dirpath=bank)
        require(built["status"] == "built" and again["status"] == "present",
                f"the bank's manifest is idempotent: {built} {again}")
        # v1's forecast plane at the hot horizons, as a pool that had
        # activated v1 holds it: the flip then publishes v2's as a delta
        # of it, and bucket 64 stays the materializer's and the cache's.
        direct_bk = get_backend("cuda", cfg, device=device)
        v1_plane = stage("b_v1_plane", fplane.maybe_publish, reg, v1,
                         direct_bk, horizons=cli.HORIZONS)
        # The quantile plane is not part of this mix (no interval
        # reads); its publish is measured in phase uncertainty.
        os.environ["TSSPARK_QPLANE"] = "0"
        pool = ReplicaPool(os.path.join(scratch, "pool"), root,
                           n_replicas=SS_REPLICAS, max_queue=4096,
                           max_batch=128, device=device.type)
        stage("b_spawn", pool.start)
        pool.start_watch(0.3)
        # Each replica warmed at v1: the hot buckets (the forecast plane's)
        # and, at bucket 64 past the plane, SS_WARM_SERIES series into its
        # cache, whose unrefitted rows the delta flip must carry forward.
        warm_ids = sids[:SS_WARM_SERIES]
        warmed = {}
        for slot in range(SS_REPLICAS):
            w = pool._request_slot(slot, {
                "cmd": "warm", "version": v1, "series_ids": warm_ids,
                "horizons": [*cli.HORIZONS, SS_LONG_HORIZON]},
                timeout_s=300.0)
            require(bool(w.get("ok")), f"warm replica {slot}: {w}")
            warmed[slot] = w.get("warmed")
        # Each replica's counters just before the replay (and replica 1's
        # just before its kill: its process goes with them).
        before = {s: _replica_counters(pool, s) for s in range(SS_REPLICAS)}
        killed = {}

        def kill_replica_1(p):
            info = p.replicas[1]
            killed["counts"] = _replica_counters(p, 1)
            killed.update(pid=info.pid, t=time.monotonic())
            os.kill(info.pid, signal.SIGKILL)

        fk.launches = 0
        replay = stage("b_replay", cli._pool_replay, pool, sids,
                       SS_REQUESTS, 0, SS_WAVE, SS_CLIENTS, v2,
                       [(SS_KILL_AT, kill_replica_1)],
                       flip_horizons=(*cli.HORIZONS, SS_LONG_HORIZON))
        front_k1 = fk.launches  # the flip's forecast-plane publish
        v2_buckets = fplane.attach(reg.version_dir(v2)).buckets
        require(tuple(v2_buckets) == fplane.bucket_ladder(cli.HORIZONS),
                f"v2's forecast plane holds buckets {v2_buckets}")
        chk = sids[::n // SS_CHECK_SERIES][:SS_CHECK_SERIES]
        # (c) and (d) start now, beside (b)'s checks, which time nothing:
        # a cold replica armed with the bank, then one without it (on
        # this install the library built at the top of the run is in the
        # package's build directory), one at a time; and the daemon as a
        # child process (its requests now, its control lines at the end).
        cold_pools = {
            "with_bank": cold_pool(root, os.path.join(scratch, "bank_r"),
                                   {aotbank.AOT_CACHE_ENV: bank}),
            "without_bank": cold_pool(root, os.path.join(scratch, "plain_r"),
                                      {}),
        }
        cold_box = {}

        def cold_legs():
            try:
                for name, p in cold_pools.items():
                    t0 = time.perf_counter()
                    cold_box[name] = cold_replica(
                        p, sids[:16], warm=name == "with_bank")
                    p.stop()
                    walls[f"c_{name}"] = time.perf_counter() - t0
            except BaseException as e:  # raised below
                cold_box["error"] = e

        cold_thread = threading.Thread(target=cold_legs, daemon=True)
        cold_thread.start()
        lines = [{"id": f"r{i}", "series_ids": chk[i * 3:i * 3 + 3],
                  "horizon": h} for i, h in enumerate(cli.HORIZONS)]
        d_err = open(os.path.join(scratch, "daemon.err"), "w")
        t_d0 = time.perf_counter()
        daemon = subprocess.Popen(
            [sys.executable, "-m", "tsspark_tpu_torch.serve",
             "--registry", root],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=d_err,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        daemon.stdin.write("".join(json.dumps(x) + "\n" for x in lines)
                           + '{"id": "st", "cmd": "stats"}\n')
        daemon.stdin.flush()
        # Replica 1 back (the pool's watch respawns it); no request goes
        # to the pool until the counters below are read.
        info1 = pool.replicas[1]
        deadline = time.monotonic() + SS_RESPAWN_S
        while time.monotonic() < deadline and not (
                info1.pid != killed["pid"] and info1.ready_t is not None
                and pool.ping(1) is not None):
            time.sleep(0.2)
        pid1 = info1.pid
        require(pid1 != killed["pid"] and info1.ready_t is not None
                and pool.ping(1) is not None, "replica 1 respawned")
        after = {s: _replica_counters(pool, s) for s in range(SS_REPLICAS)}
        require(after[0]["pid"] == before[0]["pid"]
                and after[1]["pid"] == pid1,
                "replica 0 lived through the replay, replica 1 respawned")
        # The replay's launches: replica 0's counters across it; replica
        # 1's killed process's up to its kill plus the respawned one's.
        in_replay = {
            0: _counters_diff(after[0], before[0]),
            1: _counters_add(_counters_diff(killed["counts"], before[1]),
                             _counters_diff(after[1], None)),
        }
        for slot, k in in_replay.items():
            require(k["forward"] > 0 and k["bands"] > 0,
                    f"K1 and K2 launched in replica {slot} during the "
                    f"replay: {k}")
        flip = replay["flip"]
        respawn = {
            "detect_s": info1.spawn_t - killed["t"],
            "respawn_s": info1.ready_t - killed["t"],
            "spawn_s": info1.ready_t - info1.spawn_t,
            "up_at_flip": info1.ready_t <= flip["t0"],
            "warmed_at_flip": flip["warmed"].get(1) is not None,
        }
        outcomes = replay["outcomes"]
        require(outcomes["failed"] == 0 and outcomes["rejected"] == 0,
                f"non-shed failures: {outcomes} {replay['failures'][:3]}")
        require(outcomes["ok"] + outcomes["shed"] == SS_REQUESTS,
                "every pool request answered or shed")
        require(pool.wrong_version == 0,
                f"wrong-version answers: {pool.wrong_version}")
        require(reg.active_version() == v2 and pool.expected_version == v2,
                "the pool flipped to the delta version")
        lease = orchestrate.read_lease(pool.pool_dir, 1, 2)
        require(lease is not None
                and str(lease.get("token")).startswith(f"pool1.{pid1}."),
                f"the respawned process holds slot 1's lease: {lease}")
        eng = PredictionEngine(ParamRegistry.open(root),
                               cache=ForecastCache(0), device=device)

        def ask_slot(slot, ids, h):
            """``ids`` at horizon ``h`` from replica ``slot`` itself, in
            requests of 64: the rows served from cache, and the values."""
            from_cache, vals = 0, {k: [] for k in _POINT_KEYS}
            for i in range(0, len(ids), 64):
                r = pool._try_slot(slot, {
                    "id": pool._next_rid(), "series_ids": ids[i:i + 64],
                    "horizon": int(h), "num_samples": 0, "seed": 0})
                require(r is not None and r.get("ok")
                        and r["version"] == v2 and r["replica"] == slot,
                        f"replica {slot} h={h}: {r}")
                from_cache += r["from_cache"]
                for k in _POINT_KEYS:
                    vals[k].extend(np.asarray(r[k], np.float32))
            return from_cache, {k: np.stack(v) for k, v in vals.items()}

        # After the flip the materialized hot set is answered from cache
        # in every replica the flip warmed (replica 1 only if it was back
        # by then): at the plane's buckets and at 56, which only the
        # materializer filled.
        hot = flip["hot"]
        hot_checked = {}
        require(flip["warmed"].get(0) is not None, "the flip warmed replica 0")
        for slot in range(SS_REPLICAS):
            if flip["warmed"].get(slot) is None:
                continue
            for h in (*cli.HORIZONS, SS_LONG_HORIZON):
                got, _ = ask_slot(slot, hot, h)
                require(got == len(hot),
                        f"replica {slot}'s hot set at h={h}: {got} of "
                        f"{len(hot)} from cache")
            hot_checked[slot] = len(hot) * (len(cli.HORIZONS) + 1)
        # The delta flip's cache carry-forward in replica 0: of the series
        # warmed at 56 before the replay, the unrefitted ones are answered
        # from cache with the engine's bits, the refitted ones recomputed.
        changed_ids = {sids[i] for i in changed}
        keep = [s for s in warm_ids if s not in changed_ids and s not in hot]
        refit = [s for s in warm_ids if s in changed_ids and s not in hot]
        carried = in_replay[0]["carried"]
        n_carry = sum(s not in changed_ids for s in warm_ids)
        require(carried >= n_carry > 0,
                f"replica 0 carried {carried} cache rows forward, "
                f"{n_carry} warmed unrefitted")
        carry = {"warmed": len(warm_ids), "warmed_unrefitted": n_carry,
                 "carried_keys": carried}
        for ids, want in ((keep, len(keep)), (refit, 0)):
            if not ids:
                continue
            got, vals = ask_slot(0, ids, SS_LONG_HORIZON)
            require(got == want, f"carry-forward at h={SS_LONG_HORIZON}: "
                                 f"{got} of {len(ids)} from cache, want {want}")
            e = eng.forecast(ids, SS_LONG_HORIZON)
            for k in _POINT_KEYS:
                require(np.array_equal(vals[k], e.values[k]),
                        f"carried or recomputed rows != engine: {k}")
        carry.update(asked_kept=len(keep), asked_refit=len(refit))
        # 512 series on both shards, deterministic, bitwise the in-process
        # engine's and a direct CudaBackend.predict's.
        by_shard = {}
        for sid in chk:
            by_shard.setdefault(shard_of(sid, SS_REPLICAS), []).append(sid)
        require(len(by_shard) == SS_REPLICAS, "both shards asked")
        idx, _ = snap2.rows(chk)
        sub2, step2 = snap2.take(idx)
        bitwise = {}
        for h in (HORIZON, SS_LONG_HORIZON):
            got = {}
            for shard, ss in sorted(by_shard.items()):
                for i in range(0, len(ss), 64):
                    part = ss[i:i + 64]
                    r = pool.forecast(part, h)
                    require(r.get("ok") and r["version"] == v2
                            and r["replica"] == shard,
                            f"check request: {r.get('error')}")
                    for j, sid in enumerate(part):
                        got[sid] = {k: np.asarray(r[k][j], np.float32)
                                    for k in _POINT_KEYS}
            e = eng.forecast(chk, h)
            require(e.version == v2, "the in-process engine at v2")
            d = direct_bk.predict(sub2, future_grid(sub2, step2, h),
                                  num_samples=0)
            for k in _POINT_KEYS:
                pooled = np.stack([got[sid][k] for sid in chk])
                require(np.array_equal(pooled, e.values[k]),
                        f"pool != engine: {k} h={h}")
                require(np.array_equal(e.values[k], d[k][:, :h]),
                        f"engine != CudaBackend.predict: {k} h={h}")
            bitwise[h] = {"series": len(chk),
                          "per_shard": {str(k): len(v)
                                        for k, v in by_shard.items()},
                          "plane_served": h <= 32}
        # A sampled request on each shard after the respawn (K2 in every
        # live replica, the respawned process included).
        for shard, ss in sorted(by_shard.items()):
            r = pool.forecast(ss[:8], HORIZON, num_samples=SS_BANDS_SAMPLES,
                              seed=1)
            require(r.get("ok") and r["replica"] == shard,
                    f"sampled check: {r.get('error')}")
        in_checks = {s: _counters_diff(_replica_counters(pool, s), after[s])
                     for s in range(SS_REPLICAS)}
        for slot, k in in_checks.items():
            require(k["bands"] > 0, f"K2 in replica {slot}'s checks: {k}")
        stats = pool.stats()
        prom = pool.prometheus()
        require("tsspark_pool_replica_shed" in prom
                and "tsspark_pool_failovers_total" in prom,
                "the pool's Prometheus text")
        rep_b = cli.pool_report(reg, pool, replay, SS_REQUESTS, 0,
                                SS_CLIENTS, SS_WAVE, walls["b_spawn"],
                                device)
        pool.stop()
        pool = None
        held = stage("b_kernel_checks", pool_kernel_checks, snap2, cfg,
                     np.asarray(idx), device)
        b_out = {
            "delta": {"changed_rows": int(len(changed)), "version": v2,
                      "refit_s": walls["b_delta_refit"],
                      "launches": refit_counts,
                      "perf": perf_rep.to_dict(n_series=len(changed))},
            "v1_plane": v1_plane, "v2_plane_buckets": list(v2_buckets),
            "spawn_s": walls["b_spawn"], "warmed": warmed,
            "replay_wall_s": replay["wall_s"],
            "requests_per_s": rep_b["requests_per_s"],
            "outcomes": outcomes, "latency_ms": replay["latency_ms"],
            "flip": rep_b["pool"]["flip"],
            "flip_warmed": {str(k): v for k, v in flip["warmed"].items()},
            "front_k1_launches_at_flip": front_k1,
            "kill": {"at_share": SS_KILL_AT, "pid": killed["pid"],
                     "respawned_pid": pid1, **respawn},
            "failovers": stats["failovers"], "respawns": stats["respawns"],
            "spawn_exits": stats["spawn_exits"],
            "wrong_version": stats["wrong_version"],
            "fenced_seen": stats["fenced_seen"],
            "per_replica": {
                k: {f: (r or {}).get(f) for f in
                    ("shed", "completed", "failed", "latency_ms",
                     "plane_hits", "dispatches", "cache")}
                for k, r in stats["replicas"].items()},
            "launches_replay": {str(k): v for k, v in in_replay.items()},
            "launches_checks": {str(k): v for k, v in in_checks.items()},
            "hot_from_cache": hot_checked,
            "carry_forward": carry,
            "bitwise_after_flip": bitwise,
            "kernels_at_pool_shapes": held,
        }
        emit({"phase": "serve_scale", "leg": "b", **b_out})

        # (c) The bank's replica against the one without it: each one's
        # time to its first request and its builds (none), beside what
        # this run's own build of the library took at its top (the cost
        # the bank spares a replica whose install has no built library).
        cold_thread.join()
        for p in cold_pools.values():
            p.stop()
        cold_pools = {}
        if "error" in cold_box:
            raise cold_box["error"]
        with_bank, without = cold_box["with_bank"], cold_box["without_bank"]
        require((with_bank["bank"] or {}).get("armed") is True
                and with_bank["library_builds"] == 0
                and with_bank["first_request_builds"] == 0
                and with_bank["build_dir"] == os.path.abspath(bank),
                f"the armed replica built nothing: {with_bank}")
        require(with_bank["ladder"] is not None
                and len(with_bank["ladder"]["shapes"]) ==
                len(aotbank.shape_ladder(n, (7, 14, 28))),
                "warm launched the bank's ladder")
        require(without["bank"] is None and without["library_builds"] == 0
                and without["first_request_builds"] == 0
                and without["build_dir"] == build.build_dir(),
                f"the replica without the bank loaded the built library: "
                f"{without}")
        c_out = {"bank": {k: built.get(k) for k in
                          ("how", "built_s", "digest", "library")},
                 "bank_entries": len(built["ladder"]),
                 "with_bank": with_bank, "without_bank": without,
                 "run_build": {"build_s": build.build_seconds,
                               "builds": build.builds}}
        emit({"phase": "serve_scale", "leg": "c", **c_out})

        # (d) The daemon's answers, then its control lines.
        ref = {ln["id"]: eng.forecast(ln["series_ids"], ln["horizon"])
               for ln in lines}
        daemon.stdin.write(
            f'{{"id": "act", "cmd": "activate", "version": {v1}}}\n'
            '{"id": "rb", "cmd": "rollback"}\n'
            '{"id": "st2", "cmd": "stats"}\n')
        daemon.stdin.close()
        out_lines = [json.loads(x) for x in daemon.stdout.read().splitlines()]
        rc_d = daemon.wait(timeout=120)
        daemon = None
        d_wall = time.perf_counter() - t_d0
        d_err.close()
        require(rc_d == 0, f"the daemon's exit code {rc_d}")
        by_id = {o.get("id"): o for o in out_lines}
        for ln in lines:
            o = by_id.get(ln["id"]) or {}
            require(bool(o.get("ok")) and o["version"] == v2,
                    f"daemon {ln['id']}: {o.get('error')}")
            for k, v in ref[ln["id"]].values.items():
                require(np.array_equal(np.asarray(o[k], np.float32), v),
                        f"daemon {ln['id']} {k} != the engine's")
        require(by_id["st"]["stats"]["completed"] == len(lines),
                "daemon stats")
        require(by_id["act"]["active_version"] == v1
                and by_id["rb"]["active_version"] == v2
                and by_id["st2"]["active_version"] == v2,
                "daemon activate / rollback")
        d_out = {"wall_s": d_wall, "lines": len(out_lines),
                 "latency_ms": [by_id[ln["id"]]["latency_ms"]
                                for ln in lines],
                 "bitwise_engine": True}
        emit({"phase": "serve_scale", "leg": "d", **d_out})
    finally:
        if q_env is None:
            os.environ.pop("TSSPARK_QPLANE", None)
        else:
            os.environ["TSSPARK_QPLANE"] = q_env
        if pool is not None:
            pool.stop()
        for p in cold_pools.values():
            p.stop()
        if daemon is not None:
            daemon.kill()
            daemon.wait()
        shutil.rmtree(scratch, ignore_errors=True)
    out = {"phase": "serve_scale", "walls": walls,
           "a": a_out, "b": b_out, "c": c_out, "d": d_out}
    emit({"phase": "serve_scale", "walls": walls})
    return out


def add_serve_scale(kernels, ss) -> None:
    """K1 and K2's entries gain their launches on phase serve_scale: the
    in-process loadgen's, each replica's during the pool's replay (from
    its ``stats`` before and after it; replica 1's killed process up to
    its kill plus its respawned one) and, apart, during the checks after
    it; and their checks and times at the pool's dispatch shapes."""
    b = ss["b"]
    held = b["kernels_at_pool_shapes"]
    replay, checks = b["launches_replay"], b["launches_checks"]
    for k in kernels:
        if k["name"] not in ("forward", "bands"):
            continue
        name = k["name"]
        k["launches_loadgen"] = ss["a"]["launches"][name]
        k["launches_pool"] = {slot: c[name] for slot, c in replay.items()}
        k["launches_pool_checks"] = {slot: c[name]
                                     for slot, c in checks.items()}
        k["pool_dispatch_widths"] = {slot: c["dispatch_widths"]
                                     for slot, c in replay.items()}
        k["pool_check"] = {
            "shapes": sorted(held["shapes"]),
            "max_rel_err": max(v[f"{name}_rel_err"]
                               for v in held["shapes"].values()),
            "tolerance": held["tolerance"][name]}
        if name == "bands":
            k["pool_check"]["monte_carlo_s256"] = held["monte_carlo_yhat_s256"]
        k["at_pool_shape"] = held["timing"][name]


#: Host threads generating the run's data beside the kernels' build.
BN_RUNG = "30k"           # (a) and (b): the ladder's 30,490 x 128 rung
BN_WAVE = 2048            # the rung's resident wave (its chunk)
BN_SEED = 29              # off_optimum's seed for the wave's K3/K4 check
BN_PLANE_SERIES = 48      # (c): ``bench.py --serveplane``'s defaults
BN_PLANE_REQUESTS = 2000
BN_UNC_SERIES = 24        # (d): ``bench.py --uncertainty``'s default
BN_POOL_WIDTHS = (8, 16, 32, 64)   # the rung's pool dispatches (1-8 series
BN_POOL_BUCKETS = (8, 16)          # a request, horizons 7 / 14)
BN_TIMEOUT_S = 900.0

#: The JAX package's report keys of each stream bench (key paths; its
#: ``run_delta_bench`` / ``run_freshness_bench`` / ``run_alerts_bench``
#: reports at the smoke rung, without the in-memory ``path``).
BN_DELTA_KEYS = (
    "extra", "extra.cache_carried", "extra.cold_fit_s", "extra.cold_publish_s",
    "extra.cold_reused", "extra.cold_wall_s", "extra.complete",
    "extra.config_fingerprint", "extra.delta_churn", "extra.delta_seq",
    "extra.delta_series_per_s", "extra.delta_wall_frac", "extra.detect_s",
    "extra.device", "extra.fit_dispatches", "extra.fit_path", "extra.fit_s",
    "extra.flip_hit_rate", "extra.flip_requests", "extra.flip_s",
    "extra.git_rev", "extra.hot_changed", "extra.land_s", "extra.n_changed",
    "extra.numerics_rev", "extra.publish_s", "extra.series_done",
    "extra.series_total", "extra.trace_id", "extra.version",
    "extra.warm_start", "metric", "unit", "unix", "value", "vs_baseline")
BN_FRESHNESS_KEYS = (
    "churn", "cold_fit_s", "cold_publish_s", "cold_reused", "cold_wall_s",
    "complete", "config_fingerprint", "cycle_overhead_frac", "cycles",
    "deltas", "device", "freshness_max_s", "freshness_mean_s", "freshness_n",
    "freshness_p50_s", "freshness_p95_s", "freshness_vs_cold_frac",
    "git_rev", "interval_s", "kind", "mode", "numerics_rev",
    "probe_failures", "rung", "series", "spec_hit_rate", "spec_predicted",
    "stream_wall_s", "timesteps", "trace_id", "unix", "wall_s",
    "wrong_version")
BN_ALERTS_KEYS = (
    "alerts_max_s", "alerts_mean_s", "alerts_n", "alerts_p50_s",
    "alerts_p95_s", "breaker_opens", "churn", "cold_fit_s", "cold_publish_s",
    "cold_reused", "cold_wall_s", "complete", "config_fingerprint",
    "deduped", "degraded", "delivered", "delivered_frac", "deltas", "device",
    "fired", "git_rev", "interval_s", "kind", "mode", "numerics_rev",
    "queued", "rung", "series", "suppressed", "timesteps", "trace_id",
    "unix", "wall_s")


#: Keys a bench adds in memory beside its written report: the report's
#: path and the sentinel's verdict (the JAX package's do the same).
BN_OWN_KEYS = {"path", "sentinel_ok"}


def _key_paths(d, pre="") -> set:
    out = set()
    for k, v in d.items():
        out.add(pre + k)
        if isinstance(v, dict):
            out |= _key_paths(v, pre + k + ".")
    return out


def _device_class(device) -> str:
    """The run history's device class of a run on ``device``."""
    return "gpu" if device.type == "cuda" else "cpu"


def _capture_replica_stops(sink: list):
    """Wrap ``ReplicaPool.stop`` so every pool a bench starts (inside the
    bench's own functions) first hands each replica's K1 / K2 launch
    counters to ``sink``; returns the original to restore."""
    from tsspark_tpu_torch.serve import pool as pool_mod

    orig = pool_mod.ReplicaPool.stop

    def stop(self):
        for slot in range(self.n_replicas):
            try:
                sink.append(_replica_counters(self, slot))
            except Exception as e:  # required empty by the caller
                sink.append({"error": repr(e), "slot": slot})
        orig(self)

    pool_mod.ReplicaPool.stop = stop
    return orig


def _replica_sum(rows) -> dict:
    bad = [r for r in rows if "error" in r]
    require(not bad, f"a replica's counters at its pool's stop: {bad}")
    return {"replicas": len(rows),
            "forward": sum(r["forward"] for r in rows),
            "bands": sum(r["bands"] for r in rows)}


def bn_wave(dset_dir, cfg, n, device):
    """The rung's first resident wave (rows [0, n)) as the resident fit
    packs it, on the card."""
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.models.prophet.design import (
        pack_fit_data, packed_to_device, prepare_fit_data, unpack_fit_data)

    batch = plane.open_batch(dset_dir)
    ds = np.asarray(batch.ds, np.float64)
    y = np.asarray(batch.y[:n], np.float32)
    mask = None if batch.mask is None else np.asarray(batch.mask[:n])
    data, meta = prepare_fit_data(ds, y, cfg, mask=mask)
    packed, u8 = pack_fit_data(data, meta, ds, reg_u8_cols=(),
                               collapse_cap=True)
    return unpack_fit_data(packed_to_device(packed, device), u8)


def bn_forward(snap, cfg, device) -> dict:
    """K1 against its plain version at the rung's pool dispatch shapes
    (widths 8-64 at horizon buckets 8 and 16) on the served version's
    rows, and each row the same bits in a reversed batch."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data
    from tsspark_tpu_torch.serve.fplane import future_grid

    tol, rows, out = 2e-5, np.arange(max(BN_POOL_WIDTHS)), {}
    for w in BN_POOL_WIDTHS:
        for hb in BN_POOL_BUCKETS:
            state, step = snap.take(rows[:w])
            data = prepare_predict_data(future_grid(state, step, hb),
                                        state.meta, cfg, device)
            theta = state.theta.to(device)
            scale = torch.as_tensor(state.meta.y_scale, dtype=torch.float32,
                                    device=device)
            floor = torch.as_tensor(state.meta.floor, dtype=torch.float32,
                                    device=device)
            got = fk.forward(theta, data, cfg, scale, floor)
            want = fk.forward_plain(theta, data, cfg, scale, floor)
            err = _forward_err(got, want, scale)
            require(err <= tol, f"K1 at the rung's {w}x{hb}: {err}")
            rev = torch.arange(w - 1, -1, -1, device=device)
            flip = fk.forward(theta[rev].contiguous(), _rows(data, rev), cfg,
                              scale[rev].contiguous(), floor[rev].contiguous())
            require(all(torch.equal(g, x[rev]) for g, x in zip(flip, got)),
                    f"K1 at the rung's {w}x{hb}: a reversed batch differs")
            out[f"{w}x{hb}"] = err
    return {"rel_err": out,
            "tolerance": f"|k-p|/(y_scale+|p|) <= {tol}",
            "max_abs_err": max(out.values())}


def bn_scale(root, device, mesh) -> dict:
    """(a) ``bench_scale.run_rung(BN_RUNG)`` on a fresh data root: ingest,
    the resident fit on ``mesh``, the publish, a ReplicaPool of the
    rung's replicas with the mid-run flip, the npz pool's RSS comparison,
    the sentinel row; then K3 / K4 on the rung's first wave by GAP_RULE
    off the optimum (a dropped cell must fail) and K1 at the pool's
    dispatch shapes."""
    import torch

    from tsspark_tpu_torch import bench_scale, orchestrate
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.obs import history
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    rung = bench_scale.RUNGS[BN_RUNG]
    replicas = []
    _zero_kernel_counts()
    orig = _capture_replica_stops(replicas)
    t0 = time.perf_counter()
    try:
        rep = bench_scale.run_rung(
            BN_RUNG, data_root=os.path.join(root, "a_data"),
            scratch_root=os.path.join(root, "a"), sentinel=True,
            device=device, mesh=mesh)
    finally:
        from tsspark_tpu_torch.serve import pool as pool_mod

        pool_mod.ReplicaPool.stop = orig
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    fit, serve = rep.get("fit") or {}, rep.get("serve") or {}
    require(bool(rep.get("complete")), f"the {BN_RUNG} rung: {rep}")
    require(rep["ingest"]["warm"] is False, "the rung's ingest was fresh")
    require(fit["fit_path"] == "resident"
            and fit["series_done"] == rung.series,
            f"the rung's fit: {fit}")
    require(serve["outcomes"]["failed"] == 0
            and serve["wrong_version"] == 0
            and serve["flip"]["version"] == 2
            and serve["replicas"] == rung.pool_replicas,
            f"the rung's pool: {serve['outcomes']}, "
            f"{serve['wrong_version']}, {serve['flip']}")
    # ``rss_reduction_x`` needs each replica's anonymous resident bytes
    # (``RssAnon``, or ``Anonymous`` summed over smaps where the status
    # file lacks it: ``utils.procmem``) and the snapshot mappings' Pss.
    rss = serve["rss_compare"]
    require(rss.get("rss_reduction_x") is not None,
            f"the rung's RSS comparison: {rss}")
    rows = [r for r in history.read_history(history.HISTORY_FILE)
            if r["kind"] == "scale"]
    require(len(rows) == 1 and rows[0]["workload"] == f"scale_{BN_RUNG}"
            and rows[0]["device_class"] == _device_class(device),
            f"the rung's sentinel row: {rows}")
    require(counts["loss_grad"] > 0 and counts["loss_value"] > 0
            and counts["fan"] > 0, f"K3 / K4 on the rung's fit: {counts}")
    in_replicas = _replica_sum(replicas)
    require(in_replicas["replicas"] == 2 * rung.pool_replicas
            and in_replicas["forward"] > 0,
            f"K1 in the rung's replicas: {in_replicas}")
    # The checks' own launches come after the counts were read.
    cfg = bench_scale._config()
    dset = plane.dataset_dir(plane.DatasetSpec(
        "demo_weekly", rung.series, rung.timesteps, seed=2),
        os.path.join(root, "a_data"))
    scratch = os.path.join(
        root, "a", f"tsscale_{rung.name}_{rung.series}x{rung.timesteps}"
        f"_{plane.dataset_fingerprint()}")
    state = orchestrate.load_fit_state(os.path.join(scratch, "out"),
                                       rung.series)
    data = bn_wave(dset, cfg, BN_WAVE, device)
    theta = torch.as_tensor(np.asarray(state.theta[:BN_WAVE], np.float32),
                            device=device)
    theta_h, d_h = off_optimum(theta, BN_SEED)
    wave = hold_kernels(theta_h, d_h, data, cfg, "the rung's wave")
    snap = ParamRegistry.open(os.path.join(scratch, "registry")).load(
        1, fallback=False)
    k1 = bn_forward(snap, cfg, device)
    return {"wall_s": wall, "report": rep, "launches": counts,
            "replica_launches": in_replicas, "wave": wave, "forward": k1}


def bn_streams(root, device, mesh) -> dict:
    """(b) One cold base (``reuse_cold``), then three streams: the delta
    bench's churns, the freshness bench (serialized, pipelined), the
    alert bench; each report against the JAX package's keys."""
    from tsspark_tpu_torch import bench_scale, refit, sched
    from tsspark_tpu_torch.alerts import bench as alerts_bench
    from tsspark_tpu_torch.data import plane

    cold = os.path.join(root, "b_cold")
    kw = dict(scratch_root=os.path.join(root, "b"), reuse_cold=cold,
              device=device, mesh=mesh, sentinel=True)
    out = {}
    legs = (("delta", lambda: refit.run_delta_bench(
                 BN_RUNG, churns=refit.DEFAULT_CHURNS, **kw)),
            ("freshness", lambda: sched.run_freshness_bench(BN_RUNG, **kw)),
            ("alerts", lambda: alerts_bench.run_alerts_bench(BN_RUNG, **kw)))
    for name, run in legs:
        _zero_kernel_counts()
        t0 = time.perf_counter()
        reports = run()
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "launches": _kernel_counts(), "reports": reports}
        require(refit.sweep_ok(reports), f"{name} bench: {reports}")
    rung = bench_scale.RUNGS[BN_RUNG]
    dset = plane.dataset_dir(plane.DatasetSpec(
        "demo_weekly", rung.series, rung.timesteps, seed=2),
        os.path.join(cold, "plane"))
    for rep in out["delta"]["reports"]:
        x = rep["extra"]
        landed = len(plane.delta_rows(dset, x["delta_seq"]))
        require(x["complete"] and x["n_changed"] == landed
                and x["fit_path"] == "resident",
                f"delta churn {x['delta_churn']}: n_changed "
                f"{x['n_changed']}, landed {landed}, {x['fit_path']}")
        require(_key_paths(rep) - BN_OWN_KEYS == set(BN_DELTA_KEYS),
                f"delta report keys: {sorted(_key_paths(rep))}")
    require([r["mode"] for r in out["freshness"]["reports"]]
            == ["serialized", "pipelined"], "the freshness modes")
    for rep in out["freshness"]["reports"]:
        require(rep["complete"] and rep["wrong_version"] == 0
                and rep["probe_failures"] == 0
                and rep["freshness_n"] >= rep["deltas"],
                f"freshness {rep['mode']}: {rep}")
        require(_key_paths(rep) - BN_OWN_KEYS == set(BN_FRESHNESS_KEYS),
                f"freshness report keys: {sorted(_key_paths(rep))}")
    rep = out["alerts"]["reports"][0]
    require(rep["complete"] and rep["delivered_frac"] == 1.0,
            f"alerts bench: {rep}")
    require(_key_paths(rep) - BN_OWN_KEYS == set(BN_ALERTS_KEYS),
            f"alerts report keys: {sorted(_key_paths(rep))}")
    for name in out:
        c = out[name]["launches"]
        require(c["loss_grad"] > 0 and c["fan"] > 0 and c["forward"] > 0,
                f"the {name} bench's K3 / K4 / K1 launches: {c}")
    return out


def bn_plane(root, device) -> dict:
    """(c) ``planebench.run_serveplane_bench`` at its reference defaults:
    the plane engine's hit rate 1.0, the cold and the bank-armed replicas
    each answering their first request."""
    import types

    from tsspark_tpu_torch.serve import planebench

    replicas = []
    _zero_kernel_counts()
    orig = _capture_replica_stops(replicas)
    t0 = time.perf_counter()
    try:
        rc = planebench.run_serveplane_bench(types.SimpleNamespace(
            series=BN_PLANE_SERIES, requests=BN_PLANE_REQUESTS, seed=0,
            dir=os.path.join(root, "c"), report=os.path.join(root, "c.json"),
            data_root=os.path.join(root, "c_data"), device=device))
    finally:
        from tsspark_tpu_torch.serve import pool as pool_mod

        pool_mod.ReplicaPool.stop = orig
    wall = time.perf_counter() - t0
    with open(os.path.join(root, "c.json")) as fh:
        rep = json.load(fh)
    p = rep["plane"]
    require(rc == 0, f"the plane bench's exit code {rc}")
    require(p["plane_hit_rate"] == 1.0, f"plane hit rate: {p}")
    require(p["ttfr"]["cold"]["ok"] and p["ttfr"]["aot_warm"]["ok"],
            f"the cold and bank-armed replicas: {p['ttfr']}")
    in_replicas = _replica_sum(replicas)
    counts = _kernel_counts()
    require(counts["forward"] > 0 and in_replicas["forward"] > 0,
            f"K1 in the plane bench: {counts}, {in_replicas}")
    return {"wall_s": wall, "report": rep, "launches": counts,
            "replica_launches": in_replicas}


def bn_calibration(root, device) -> dict:
    """(d) ``calibrate.run_uncertainty_bench`` at its reference default:
    the report and its ``calibration`` history row on the card's device
    class."""
    import types

    from tsspark_tpu_torch.obs import history
    from tsspark_tpu_torch.uncertainty import calibrate

    _zero_kernel_counts()
    t0 = time.perf_counter()
    rc = calibrate.run_uncertainty_bench(types.SimpleNamespace(
        series=BN_UNC_SERIES, seed=0, dir=os.path.join(root, "d"),
        report=os.path.join(root, "d.json"),
        data_root=os.path.join(root, "d_data"), device=device))
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    with open(os.path.join(root, "d.json")) as fh:
        rep = json.load(fh)
    require(rc == 0 and rep["kind"] == "calibration-eval",
            f"the calibration bench: rc {rc}")
    rows = [r for r in history.read_history(history.HISTORY_FILE)
            if r["kind"] == "calibration"]
    require(len(rows) == 1
            and rows[0]["device_class"] == _device_class(device),
            f"the calibration row: {rows}")
    require(counts["loss_grad"] > 0 and counts["loss_stack"] > 0
            and counts["advi"] > 0,
            f"K3 (its draw stack) and K7 in the calibration bench: {counts}")
    return {"wall_s": wall, "report": rep, "launches": counts}


def bn_ledger(root) -> dict:
    """(e) The run ledger over the phase's scratch, in this process and as
    ``python -m tsspark_tpu_torch.obs ledger`` in a child: the same
    ledger (stamps aside), no orphan span."""
    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.obs import ledger

    led = ledger.build_ledger(root)
    out = os.path.join(root, "RUNLEDGER_cli.json")
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.obs", "ledger", root,
         "-o", out], env=orchestrate._child_env(), capture_output=True,
        text=True, timeout=300)
    require(proc.returncode == 0, f"the obs ledger CLI: {proc.stderr[-2000:]}")
    with open(out) as fh:
        cli = json.load(fh)
    same = ({k: v for k, v in cli.items() if k != "unix"}
            == json.loads(json.dumps({k: v for k, v in led.items()
                                      if k != "unix"})))
    require(same, "the obs ledger CLI's ledger differs from build_ledger's")
    require(led["orphan_spans"] == [], f"orphan spans: {led['orphan_spans']}")
    return {"trace_id": led["trace_id"], "spans": len(led["spans"]),
            "events": len(led["events"]), "processes": len(led["processes"]),
            "orphan_spans": 0, "red": led["red"],
            "milestones": led["milestones"], "cli_same": True}


def phase_benches(device, root) -> dict:
    """The bench family (see ``--_benches``): (a) the scale rung, (b) the
    stream benches on one cold base, (c) the plane bench, (d) the
    calibration bench, (e) the run ledger; launch counts set to 0 before
    each leg and read after it (the replicas' read at each pool's stop).
    Runs with ``root`` as its working directory: every report and the run
    history land there."""
    import torch

    from tsspark_tpu_torch.parallel.mesh import make_mesh

    mesh_dev = (torch.device("cuda", 0) if device.type == "cuda"
                else device)
    mesh = make_mesh(1, 1, devices=[mesh_dev])
    t0 = time.perf_counter()
    a = bn_scale(root, device, mesh)
    b = bn_streams(root, device, mesh)
    c = bn_plane(root, device)
    d = bn_calibration(root, device)
    e = bn_ledger(root)
    rep, serve = a["report"], a["report"]["serve"]
    mem = serve["mem"]
    plane = c["report"]["plane"]
    cal = d["report"]["calibration"]
    res = {
        "phase": "benches",
        "note": ("(c) and (d) at the reference's bench sizes: serving, the "
                 "planes and the calibration recipe already run at the "
                 "fleet's 30,490 series in phases serve_scale, planes and "
                 "uncertainty"),
        "wall_s": time.perf_counter() - t0,
        "legs_s": {"scale": a["wall_s"],
                   **{k: v["wall_s"] for k, v in b.items()},
                   "plane": c["wall_s"], "calibration": d["wall_s"]},
        "scale": {"rung": BN_RUNG, "fit_s": rep["fit"]["fit_s"],
                  "series_per_s": rep["fit"]["series_per_s"],
                  "publish_s": rep["publish"]["publish_s"],
                  "snapshot_mb": rep["publish"]["snapshot_mb"],
                  "ttfr_s": serve["time_to_first_request_s"],
                  "agg_requests_per_s": serve["agg_requests_per_s"],
                  "flip_p99_ms": serve["flip"]["p99_ms"],
                  "rss_mb_per_replica": mem["rss_mb_per_replica"],
                  "pss_mb_per_replica": mem["pss_mb_per_replica"],
                  "rss_reduction_x": serve["rss_compare"].get(
                      "rss_reduction_x"),
                  "rss_anon_mb_per_replica": mem["rss_anon_mb_per_replica"],
                  "snap_pss_total_mb": mem["snap_pss_total_mb"],
                  "outcomes": serve["outcomes"],
                  "wrong_version": serve["wrong_version"],
                  "wave_check": a["wave"], "forward_check": a["forward"]},
        "delta": [{"churn": r["extra"]["delta_churn"],
                   "n_changed": r["extra"]["n_changed"],
                   "delta_series_per_s": r["extra"]["delta_series_per_s"],
                   "delta_wall_s": r["value"],
                   "cold_reused": r["extra"]["cold_reused"]}
                  for r in b["delta"]["reports"]],
        "freshness": {r["mode"]: {"p50_s": r["freshness_p50_s"],
                                  "p95_s": r["freshness_p95_s"],
                                  "cycles": r["cycles"],
                                  "wrong_version": r["wrong_version"]}
                      for r in b["freshness"]["reports"]},
        "alerts": {k: b["alerts"]["reports"][0][k] for k in (
            "alerts_p50_s", "alerts_p95_s", "fired", "delivered_frac",
            "mode")},
        "plane": {"plane_rps": plane["hot_read"]["plane_rps"],
                  "dispatch_rps": plane["hot_read"]["dispatch_rps"],
                  "read_p99_ms": plane["read_latency_ms"]["p99"],
                  "ttfr": {k: plane["ttfr"][k] for k in (
                      "cold_arm", "cold_s", "aot_warm_s")}},
        "calibration": {"mode": cal["mode"],
                        "coverage_abs_gap": cal["coverage_abs_gap"],
                        "qread_p99_ms": cal["qread_p99_ms"]},
        "ledger": e,
        "launches_benches": {
            "scale": a["launches"], "scale_replicas": a["replica_launches"],
            **{k: v["launches"] for k, v in b.items()},
            "plane": c["launches"], "plane_replicas": c["replica_launches"],
            "calibration": d["launches"]},
    }
    return res


def add_benches(kernels, bn) -> None:
    """K1, K2, K3, K4 and K7's entries gain their launches on phase
    benches (in its process and in its replicas), and K3 / K4 and K1 the
    rung's wave and pool-shape checks."""
    lb = bn["launches_benches"]
    own = [v for k, v in lb.items() if not k.endswith("_replicas")]
    reps = [v for k, v in lb.items() if k.endswith("_replicas")]

    def total(key):
        return sum(v.get(key, 0) for v in own)

    for k in kernels:
        name = k["name"]
        if name == "loss":
            k["launches_benches"] = total("loss_grad") + total("loss_value")
            k["launches_benches_stack"] = total("loss_stack")
            k["benches_wave_check"] = bn["scale"]["wave_check"]["gap"]
        elif name == "fan":
            k["launches_benches"] = total("fan")
            k["benches_wave_check"] = bn["scale"]["wave_check"]["gap"]["fan"]
        elif name == "forward":
            k["launches_benches"] = total("forward") + sum(
                r["forward"] for r in reps)
            k["benches_pool_check"] = bn["scale"]["forward_check"]["rel_err"]
        elif name == "bands":
            k["launches_benches"] = total("bands") + sum(
                r["bands"] for r in reps)
        elif name == "advi":
            k["launches_benches"] = total("advi")


def benches_child(root: str) -> int:
    """``python3 chip_smoke.py --_benches ROOT``: phase benches in a
    process of its own, working directory ``ROOT``; its result goes to
    ``ROOT/result.json``.  The main process starts it beside the host-bound
    phases (``BenchesChild``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --_benches: no CUDA device is available",
              file=sys.stderr)
        return 2
    from tsspark_tpu_torch.device import resolve_device

    os.chdir(root)
    res = phase_benches(resolve_device(None), root)
    with open(os.path.join(root, "result.json"), "w") as fh:
        json.dump(res, fh, default=str)
    return 0


class BenchesChild:
    """Phase benches in a child process (``benches_child``), started
    beside the host-bound phases and joined before phase frontend: the
    benches wait mostly on process starts (their replicas), as those
    phases do.  ``join`` returns the phase's result, or raises with the
    child's last output if it failed."""

    def __init__(self):
        self.root = tempfile.mkdtemp(prefix="benches_")
        env = dict(os.environ, TMPDIR=os.path.join(self.root, "tmp"))
        os.makedirs(env["TMPDIR"])
        self.log = open(os.path.join(self.root, "child.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--_benches",
             self.root], cwd=self.root, env=env, stdout=self.log,
            stderr=subprocess.STDOUT)

    def join(self) -> dict:
        t_wait = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=BN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        wait_s = time.perf_counter() - t_wait
        self.log.flush()
        if rc != 0:
            with open(self.log.name) as fh:
                tail = fh.read()[-6000:]
            raise RuntimeError(f"check failed: phase benches (rc {rc}):\n"
                               f"{tail}")
        with open(os.path.join(self.root, "result.json")) as fh:
            res = json.load(fh)
        res["child_s"] = time.perf_counter() - self.t0
        res["join_wait_s"] = wait_s
        return res

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.root, ignore_errors=True)


SETUP_WORKERS = 4


def setup_data(args, serve_root: str, workers: int = SETUP_WORKERS) -> dict:
    """Every phase's generated data and phase serve's registry, made at the
    top of the run beside the kernels' build: ``batch3``
    (``m5_like(30490, 1941)``) then ``serve_registry`` from it; eval config
    4's batch and configs 1-2's; config 5's frames (the cell's and the
    fleet's, cut to ``fleet_rows()``); the M5 fleet frame (cut the same
    way).  The four run on ``workers`` threads (each generator is seeded
    and reads nothing another writes, so the products are the bits of one
    after another: ``tests/test_torch_room.py``; numpy releases the
    interpreter lock for its array work); ``workers`` 0 runs them one
    after another on this thread.  Returns the products, each one's
    seconds (``gen_s``) and the walls of ``serve_registry`` and of the
    whole set-up (``setup_s``)."""
    from concurrent.futures import ThreadPoolExecutor

    from tsspark_tpu_torch.data.datasets import m5_like, wiki_logistic_like
    from tsspark_tpu_torch.eval import configs

    gen_s, setup_s = {}, {}

    def fleet3():
        t0 = time.perf_counter()
        batch3 = m5_like(FULL_SERIES, FULL_DAYS, seed=2)
        gen_s["3"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = serve_registry(args, serve_root, batch3)
        setup_s["serve_registry"] = time.perf_counter() - t0
        return {"batch3": batch3, "serve": serve}

    def small():
        t0 = time.perf_counter()
        batch4 = wiki_logistic_like(C4_SERIES, C4_DAYS)
        gen_s["4"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches12 = eval12_batches()
        gen_s["12"] = time.perf_counter() - t0
        return {"batch4": batch4, "batches12": batches12}

    def frames5():
        t0 = time.perf_counter()
        n5, days5 = configs.config5_size(1.0)
        stream5_df = configs.config5_frame(n5, days5)
        fleet_df = configs.config5_frame(FLEET_SERIES, days5)
        fleet_df = fleet_df[fleet_df.series_id.isin(
            {f"s{i}" for i in fleet_rows()})]
        fleet_sub = fleet_df[fleet_df.series_id.isin(
            {f"s{i}" for i in fleet_subset()})]
        gen_s["5"] = time.perf_counter() - t0
        return {"stream5_df": stream5_df, "fleet_df": fleet_df,
                "fleet_sub": fleet_sub}

    def frame_m5():
        t0 = time.perf_counter()
        m5_df, m5_ids = m5_fleet_frame()
        m5_sub = m5_df[m5_df.series_id.isin(set(m5_ids[fleet_subset()]))]
        m5_ids = m5_ids[fleet_rows()]
        m5_df = m5_df[m5_df.series_id.isin(set(m5_ids))]
        gen_s["m5"] = time.perf_counter() - t0
        return {"m5_df": m5_df, "m5_ids": m5_ids, "m5_sub": m5_sub}

    jobs = (fleet3, frames5, frame_m5, small)
    t0 = time.perf_counter()
    out = {}
    if workers:
        with ThreadPoolExecutor(workers, thread_name_prefix="setup") as ex:
            for part in [ex.submit(job) for job in jobs]:
                out.update(part.result())
    else:
        for job in jobs:
            out.update(job())
    setup_s["data"] = time.perf_counter() - t0
    return dict(out, gen_s=gen_s, setup_s=setup_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--_benches", default=None, metavar="ROOT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args._benches:
        return benches_child(args._benches)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from tsspark_tpu_torch.device import resolve_device
    from tsspark_tpu_torch.kernels import build

    t_start = time.perf_counter()
    device = resolve_device(None)
    smi = smi_line()
    # The kernels build (nvcc processes) while the host generates the
    # phases' data; a failed build raises here once both are done.
    built = {}

    def build_all():
        try:
            build.library()
        except Exception as e:  # re-raised below
            built["error"] = e

    build_thread = threading.Thread(target=build_all, daemon=True)
    build_thread.start()
    rng = np.random.default_rng(args.seed)
    phases_s = {}
    serve_root = tempfile.mkdtemp(prefix="serve_")
    made = setup_data(args, serve_root)
    phases_s.update(made["setup_s"])
    serve_made, batch3, batch4 = made["serve"], made["batch3"], made["batch4"]
    stream5_df, fleet_df, fleet_sub = (made["stream5_df"], made["fleet_df"],
                                       made["fleet_sub"])
    m5_df, m5_ids, m5_sub = made["m5_df"], made["m5_ids"], made["m5_sub"]
    batches12 = made["batches12"]
    gen3_s, gen4_s, gen5_s, gen_m5_s, gen12_s = (
        made["gen_s"][k] for k in ("3", "4", "5", "m5", "12"))
    del made

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases_s[name] = time.perf_counter() - t0
        return out

    from tsspark_tpu_torch.eval import configs

    build_thread.join()
    if "error" in built:
        raise built["error"]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build.build_seconds,
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in build.ptxas_log.items()}})
    phases_s["device"] = time.perf_counter() - t_start
    parity = ParityFits(batch3, batch4, stream5_df, fleet_sub, m5_sub,
                        batches12)
    fe_cpu = parity.submit(frontend_cpu_job, fe_long_frame(
        batch3, FE_CPU_SUBSET, 0, configs.split_point(FULL_DAYS)),
        fe_holiday(batch3))
    dp_ingest = DataplaneIngest(parity)
    unc_root = tempfile.mkdtemp(prefix="uncertainty_")
    benches = None
    finished = False
    import shutil

    try:
        fwd = timed("forward", phase_forward, rng, device)
        bnd = timed("bands", phase_bands, rng, device)
        timed("loss", phase_loss, rng, device)
        timed("fan", phase_fan, rng, device)
        serve = timed("serve", phase_serve, args, device, serve_made)
        fit = timed("fit", phase_fit, device, batch3, gen3_s, parity)
        mcmc = timed("mcmc", phase_mcmc, fit, device)
        fit4 = timed("fit_logistic", phase_fit_logistic, device, batch4,
                     gen4_s, parity)
        stream5 = timed("stream5", phase_stream5, device, parity)
        fleet = timed("stream_fleet", phase_stream_fleet, device, fleet_df,
                      gen5_s, parity)
        del fleet_df
        unc = timed("uncertainty", phase_uncertainty, serve, device, parity,
                    unc_root)
        planes = timed("planes", phase_planes, unc["handoff"], device)
        del unc["handoff"]
        fleet_m5 = timed("stream_fleet_m5", phase_stream_fleet_m5, device,
                         m5_df, m5_ids, gen_m5_s, parity)
        del m5_df
        eval12 = timed("eval12", phase_eval12, device, batches12, gen12_s,
                       parity)
        # Phase benches runs in a child beside the host-bound phases
        # dataplane, resilient, resident, refit and sched
        # (``BenchesChild``).
        benches = BenchesChild()
        dp = timed("dataplane", phase_dataplane, device, dp_ingest)
        rs = timed("resilient", phase_resilient, device, dp_ingest,
                   dp.pop("handoff"))
        rs_hand = rs.pop("handoff")
        rd = timed("resident", phase_resident, device, rs_hand)
        rf = timed("refit", phase_refit, device, rs_hand)
        shutil.rmtree(rs_hand.pop("scratch"), ignore_errors=True)
        del rs_hand
        rf_hand = rf.pop("handoff")
        try:
            sc = timed("sched", phase_sched, device, rf_hand)
        finally:
            shutil.rmtree(rf_hand["scratch"], ignore_errors=True)
        del rf_hand
        bn = timed("benches", benches.join)
        emit(bn)
        fe = timed("frontend", phase_frontend, device, batch3, fe_cpu)
        scale = timed("serve_scale", phase_serve_scale, device, serve)
        kernels = timed("kernels", phase_kernels, serve, fwd, bnd, fit,
                        fit4, mcmc, device)
        add_stream_launches(kernels["kernels"], stream5, fleet)
        add_uncertainty(kernels["kernels"], unc)
        add_new_paths(kernels["kernels"], fleet_m5, eval12, planes)
        add_dataplane(kernels["kernels"], dp)
        add_resilient(kernels["kernels"], rs)
        add_resident_refit(kernels["kernels"], rd, rf)
        add_sched(kernels["kernels"], sc)
        add_benches(kernels["kernels"], bn)
        add_frontend(kernels["kernels"], fe)
        add_serve_scale(kernels["kernels"], scale)
        finished = True
    finally:
        import shutil

        dp_ingest.close()
        if benches is not None:
            benches.close()
        shutil.rmtree(unc_root, ignore_errors=True)
        shutil.rmtree(serve_root, ignore_errors=True)
        parity.close(finished)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "phases_s": phases_s})
    emit(kernels)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
