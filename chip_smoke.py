#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``comapreduce_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no result is printed:

1. environment: torch / CUDA / nvcc versions, the card, its power limit;
2. build: every kernel under ``comapreduce_tpu_torch/csrc`` with nvcc
   for sm_90a;
3. kernel parity: K1 (masked fill), K2 (rolling median), K3 (binned
   window sum) and K4 (windowed gather) against their plain PyTorch
   versions on the card, at the shapes the full-width paths give them —
   K3 at its three sites on the flagship plan (4 bands) and on the field
   plan (one band), K4 with the ground solve's two coefficient rows
   (R = 2) and with one (R = 1), K3 at the polarized solve's new sites
   on the field plan (the stacked pair sum at R = 10, the rank sums at
   R = 7 and R = 3), both of K3's bodies at every site (the one-pass
   body, which the main path takes on the plans' ascending ids, and the
   two-pass body), and the two-pass body once more with its ids
   shuffled inside each chunk — (K1, K2 and K4 bitwise; K3 bitwise on
   integer-valued sums and, on real values, within the f32 summation
   bound of the exact sum, and three launches on the same inputs the
   same bits), each timed on the device with CUDA events
   (``cuda_ms``) beside its plain version, its bound and the one PyTorch
   call that computes the same function where there is one
   (``torch.quantile`` on an unfold view for K2, ``index_add_`` and, a
   fixed-order yardstick, ``segment_reduce`` for K3, K3's bodies and
   these two timed in turns; ``index_select`` for K4), with the launch
   floor (a one-element
   ``zero_``) beside K2's and K4's bounds, K2 at four block sizes and K4
   also as the two R = 1 launches one matvec took before; K1 on rows at
   the edges of its selection (``fill_edge_rows``), K2 on tied, -0/+0
   and NaN rows (``median_edge_rows``), K4 on every lane kind and in its
   scalar body (``gather_lane_case``), with each kernel's resident
   blocks per SM; then what the main path's shapes do not take: K1's
   second body (keys in device scratch), K2's (window 20 000) and K3 on
   a layout that stresses both bodies (``window_sum_stress_case``: the
   two-pass body with ids shuffled in a chunk, the one-pass body with
   them sorted back);
4. small-shape chain: the BENCH_SMALL observation through the port on
   the card and, with the same inputs, on the CPU (plain versions);
5. full-width chain: F=19 feeds x B=4 bands x C=1024 channels x 10 CES
   scans of 13 500 samples, window 6000, a 480x480 field, offset length
   50 — one warm-up run, then one timed run with every kernel's launch
   counter set to 0 just before it and read just after (K1 and K2 once
   per scan batch of each feed: 95);
6. profile: one more full-width run under ``torch.profiler`` (the
   device's activity only) for the device time per kernel (K1, K2 and
   K3 per launch and as a share of device time; K3 is one kernel a
   launch, ``K3_SYMBOL``) and the device's busy share;
7. field run (``comapreduce_tpu_torch/fieldrun.py``): the band solve
   ``cli.run_destriper.solve_band`` with the ground template and the
   two-level preconditioner (block 8), 100 iterations, threshold 1e-6 —
   first at FIELD_SMALL on the card and on the CPU (null-space-invariant
   products compared), then at full width: 4 observations x 19 feeds x
   135 700 samples (10 313 200 per band, 76 ground groups) on the
   480x480 field, bands 0 and 1 (``FIELD_7_BANDS``), each with the K3
   and K4 launch
   counters set to 0 just before its solve and read just after (K4 once
   per CG iteration: 100); then one
   more band under ``torch.profiler`` (K3 and K4 per launch and as a
   share of device time). Phase 3 holds K3 and K4 at this
   path's shapes against their plain versions, and K4 on every lane
   kind; K3 also at R = 4 on the field plan (the joint four-band solve);
8. the multigrid V-cycle, the banded noise prior and compensated CG
   dots: at FIELD_SMALL, card against CPU, the ground + multigrid solve,
   the banded + multigrid offsets-only solve on the matched-1/f variant
   and a compensated solve, and ``precise_dot`` against a float64 dot at
   the field's offset and sample counts; at full width, phase A — the
   first two bands (``FIELD_MG_BANDS``) through ``solve_band`` with the
   ground template and ``fieldrun.MG_KW``, each with the K3 and K4
   counters set to 0 just
   before its solve and read just after (K4 once per CG iteration, K3 as
   ``k3_launches`` derives; phase C, one more such band under
   ``torch.profiler``, was cut to make room for phase P), and phase B —
   the
   first two matched-1/f bands (``FIELD_B_BANDS``)
   offsets-only, band 0 through ``solve_band`` with the banded prior
   (its fallback warning must name the two planted groups) and then both
   as one multi-RHS ``destripe_planned`` with ``stack_multigrid`` and
   ``stack_banded``, counters likewise;
9. phase D, the map-maker's path below the reader on phase B's two
   bands with the field's WCS (``fieldrun.field_wcs``) attached: the
   joint entry point ``cli.run_destriper.solve_bands_joint`` (K3 launches
   as ``k3_launches`` derives, none of K4, maps and iterations against
   phase B's hand-written joint solve), ``write_band_map`` of the two
   WCS images into ``chiprun_out/maps/`` read back bitwise, the deadline
   (``solve_band(watchdog=)`` on band 0 under a generous budget and
   under a hard one below its synchronised wall, which must warn), the
   checkpointed solve (``solve_band_checkpointed``, uninterrupted and
   resumed from a snapshot saved after 50 iterations: only the remaining
   chunks run, counted from K3's launches and the telemetry stream) and
   band 0 on a compacted HEALPix space written as a partial map and read
   back;
10. phase E, the Level-1 -> Level-2 stage chain of the shipped field
   reduction (``examples/configs/configuration.toml`` as shipped: the
   quarantine ledger, retries, heartbeats, elastic lease claiming and the
   quality ledger on), the Level-2 store kept in memory (the card's
   machine has no h5py; the CPU tests hold the file write). First the
   reference pipeline test's observation (F=2, B=2, C=32, 3 scans of 600)
   through the stages on the card and on the CPU, every Level-2 dataset
   compared (``level2_diffs``); then full width through
   ``Runner.run_tod``, the observation served from memory to the loader
   (``ServedLevel1``): F=19, B=4, C=1024, the flagship's 10 CES scans of
   13 500 samples, the TOD a lazy dataset generated on the card at each
   read (``make_device_tod_class``). The products must be finite, the
   vane must recover the generator's truth, the averaged TOD must be zero
   outside scans, the spike share < 0.5, the white levels > 0, and K1 and
   K2 must launch as the code derives (once per feed and scan chunk, K2
   once more in ``Spikes``); the run machinery must leave an empty
   quarantine ledger, 76 finite quality records, the lease committed and
   the longest gap between heartbeat writes below the lease TTL
   (``check_chain_machinery``); per-stage walls with the reads apart, the
   planner's choice and estimate beside the reduction's measured peak,
   and K1 and K2 at the chain's shapes against their plain versions
   (bitwise), bounds and ``torch.median``;
11. phase F, the map-maker's Level-2 reader and its INI entry point over
   phase E's Level-2 stores, served from memory to the port's
   ``load_level2`` (``ServedLevel2``: no h5py on the card's machine; the
   CPU tests hold the file read). First the small store: both bands
   through ``read_comap_data`` on the card and on the CPU (bitwise equal
   ``DestriperData``), then ``cli.run_destriper.main`` on the card and
   with ``--device=cpu`` over the shipped ``examples/configs/
   parameters.ini`` cut to two bands (maps within MAP_ATOL of scale, hits
   equal). Then the full-width store as a one-line filelist through
   ``main`` on the shipped INI as shipped (only the paths changed, its
   ``[Resilience]`` on): the joint route (four bands, two-level, K3 at
   R = 4), the ``ground : true`` route (per band, K3 at R = 1 and K4) and
   the ``noise_weight = banded`` route over phase E's quality ledger
   keyed by the Level-2 file (``BandedReport`` records each band's
   banded and white groups; the route over the ledger as written was cut
   to make room for phase P), with K2 launched once per band read, K3 as
   ``k3_launches`` derives from each solve's iterations and K4 once per
   ground CG iteration; the written maps read back bitwise, hits at the
   field centre, finite maps on hit pixels, per band the read, solve and
   write walls, iterations and residual, and the peak device memory; and
   K2 at the reader's window-400 site against its plain version
   (bitwise), bound and ``torch.median``;
12. phase G, the chaos drill (``phase_drill``): four small observations
   (the pipeline test's shape, seeds 7-10) through ``run_tod`` with the
   shipped config plus a read error, a NaN burst and a first-read flake
   aimed one a file, on the card and on the CPU port: the same ledger
   dispositions, quality records and results, Level-2 stores within
   ``level2_diffs``' limits; a rerun skips the quarantined observation
   without a read, ``retry_quarantined`` re-admits it; then ``main`` over
   each device's Level-2 stores with ``[Slo] exclude_flagged`` and a NaN
   burst in one Level-2 read: the same files mapped, the same masked
   events, maps within MAP_ATOL of scale;
13. phase H, astronomical calibration (run after phase F, on phase E's
   full-width field store): first the reference test's TauA observation
   (F=1, B=2, C=32, 5 scans of 1 500) through ``Runner.run_tod`` on the
   shipped ``configuration.toml`` plus ``FitSource`` and then
   ``run_astro_cal``, on the card and on the CPU port (fits, errors,
   chi2, factors and good masks within ``calibration_diffs``' limits, the
   rest of the Level-2 store within ``level2_diffs``', K1 1 and K2 3
   launches); then a full-width TauA calibrator (F=19, B=4, C=1024, 5
   scans of 6 000: T = 30 896, one scan over the source) with the
   source in the card-made TOD's sky load, through the same chain and
   ``run_astro_cal`` onto itself and phase E's field store, the
   ``.npz`` cache written and read back, then ``run_destriper.main``'s
   joint route on the shipped ``parameters.ini`` over the calibrated
   field store (``calibration : true`` acting): the fits within the
   reference test's limits, ``calibration_good`` for at least 90% of
   (feed, band), K1 and K2 launched as derived in the chain (K2 once
   more in ``FitSource``) and in the map run, the maps finite on hit
   pixels with phase F's hits and other values; FitSource's bin, LM,
   bootstrap and chain walls on its 76 maps (the two error estimates
   finite, within ``CAL_ERR_RATIO`` of the analytic ones), and K2 at
   FitSource's window-401 site and K1/K2 at the calibrator's single-scan
   length against their plain versions, bounds and ``torch.median``;
14. phase I, the ingest tier and bf16 TOD streaming (on phases F's and
   H's observations; its first check, phase E's chain again with
   ``[ingest] prefetch = 1``, was cut to make room for phase O: the
   prefetch path runs in phase L.2 and, held to the serial chain, in the
   CPU tests), after phase H (``phase_ingest``): phase H's calibrator with ``cache_mb`` over its TOD
   (``run_astro_cal``'s pass served from the cache: 1 miss, 1 hit; fits
   and factors against phase H's), phase F's joint route with
   ``prefetch``, ``cache_mb``, ``writeback = 2`` and ``tod_dtype = bf16``
   (one decode, three hits, the maps written on the writer read back
   bitwise and within the reference's bf16 tolerance of phase F's), the
   pipeline test's observation under bf16 card against CPU (the narrowed
   bits equal), and ``ingest.prefetch_to_device`` over eight 445 MB
   feed-batch blocks (bitwise, ``ingest.h2d.bytes`` the bytes shipped,
   half under a bf16 cast; the copies' wall with and without K1 on the
   current stream), with the walls, reads, cache statistics, bytes and
   peak RSS of each;
15. phase J, the last stages and stage options of ``run_average``
   (``phase_last_stages``): J.1 ``SkyDip`` at full width (F=19, B=4,
   C=1024, one scan sweeping the elevation over 40-55 deg, T = 15 040,
   the TOD made on the card) in the shipped chain through
   ``Runner.run_tod`` (K1 19 and K2 20 launches), its slope over the
   generator's gain against the generator's zenith atmosphere, the stage
   run again bitwise, and its sky-nod mode on a prior observation served
   from memory (the stage reads it through ``ingest.loaders``), with the
   walls and peak device memory; J.2 the numpy oracle (``backend =
   "numpy"``, f64 on the host) against the card on the pipeline test's
   observation at the reference's backend tolerances (``oracle_diffs``),
   K1 2 and K2 3 launches on the card and none in the oracle's run; J.3
   ``SkyDip`` at the pipeline test's shape, card against CPU
   (``level2_diffs``);
16. phase K, the incremental map server and the tile read tier
   (``phase_serving``): phase E's Level-2 store served as two files,
   committed through a lease-file state directory; ``MapServer`` on the
   card publishes a cold epoch over one file, a warm epoch over both
   (strictly fewer CG iterations than a cold one-shot server over both,
   the same map modulo the offsets' constant), a ``downdated`` epoch
   after evicting the second file (every tile epoch 1's, byte for byte),
   each cut into tiles; the cold one-shot against a batch
   ``read_comap_data`` + ``solve_band``; a loopback ``TileServer``
   cutout bit-identical to the epoch FITS and revalidated (304) across a
   rollback; ``coadd_fits_files`` over the epochs root; K2 once per file
   read, K3 as derived from each solve, K1 and K4 never; per epoch the
   read, assemble, solve, publish and tile walls, iterations, residual
   and peak; K3 at the census plan's shapes against its plain version;
17. phase L, the synthetic campaign engine (``phase_synthetic``): L.1
   the transfer closure of ``synthetic.transfer`` at its shipped gate
   scenario (seed 0: two injected files and a blind one, F=2, B=1, C=64,
   4 scans of 600), the Level-1 stores made on the host
   (``transfer._level1_stores``: the generator, then the sky injected
   through ``simulations.skymodel``), reduced by the transfer's chain,
   read, destriped and compared through the port's own steps with memory
   I/O (``transfer_in_memory``) on the card and then on the CPU: both
   artifacts pass ``check_transfer`` and agree within
   ``transfer_diffs``' limits; K1 and K2 launched as derived, K3 in the
   solve as derived from its iterations, K4 never; K1 and K2 at each of
   the path's inputs (kept by ``KernelInputs``) and K3 at the 64 x 64
   solve's three sites against their plain versions, bounds and library
   calls; L.2 a ``synth://`` campaign
   at the instrument's width (``SYNTH_FULL``: F=19, B=4, C=1024, two
   files of 2 scans of ~1 500 samples with spikes and NaNs) registered
   in ``synthetic.memsource`` and reduced from its virtual filelist by
   the shipped chain with ``[ingest] prefetch = 1`` (each member
   generated on the prefetcher's worker): both files reduced, none
   quarantined, finite products, positive scan weights, ``probe_virtual``
   against the members, K1 and K2 launched as derived and held against
   their plain versions at each of the run's inputs; per file the
   generation wall, the chain's wait, the stage walls and the peak. L.2
   runs as a campaign: ``[campaign]`` with the documented quanta (4096,
   4, 1024; its two jittered members in one bucket) and ``warm_compile``,
   ``[ingest] compile_cache_dir`` on a fresh directory under
   ``chiprun_out/synthetic/full/``, ``[tuning]`` over phase N.3's winners
   and ``[telemetry]`` on: the warm-up builds K1's and K2's libraries
   once each on its thread and nothing is built while the files run,
   ``AtmosphereRemoval``'s planner consults the stage winner, and one
   program record a stage program and bucket carries its temporaries.
18. phase M, the observability plane (``phase_observability``, run
   after phase K on phase E's store and phase F's joint maps): M.1 band 0
   of that store on the ground route (K3, K4), untraced twice and traced
   once with telemetry on: an ``iteration`` record per reported CG
   iteration and one ``solve`` record with the result's ``n_iter`` and
   residual, the traced and untraced solves the same bits (offsets,
   ground, hits, weights and maps), then a checkpointed solve in two
   chunks
   numbered on one iteration axis; M.2 phase F's joint route through
   ``main`` with ``[Telemetry] enabled`` and ``--live-port=0`` while a
   scraper thread polls ``/metrics`` and ``/healthz`` (a mid-run scrape
   with the reads' span family and the ``solver.*`` gauges), then a
   healthy ``/v1/campaign``, phase F's hits, NAIVE and DESTRIPED maps
   bitwise phase F's, and ``campaign_report`` over the state dir; M.3
   ``[telemetry] jax_profiler`` through ``Runner.run_tod`` over two
   ``synth://`` members at L.1's widths: one ``torch.profiler`` trace
   under ``<log_dir>/jax_trace/`` naming K1's and K2's CUDA symbols as
   often as the counters moved in it, and the reference's span names.
19. phase N, polarized destriping and the autotuner
   (``phase_pol_tuning``, run after phase M and before phase L, while
   the field plan is in scope): N.1 ``destripe_pol_planned`` and
   ``destripe_pol`` at FIELD_SMALL with an I/Q/U sky seen through the
   demo's polarization angle, card against CPU (within ``POL_ATOL``:
   the reference test's tolerances for the scatter oracle, measured ones
   for the planned solve; hits equal), then the reference test's hard
   polarized problem on the card, 300 iterations survived and landing
   under its 5e-3; N.2
   ``destripe_pol_planned`` on the full field's band-0 pointing (4 x 19
   x 135 700 samples, the 480 x 480 plan) with I, Q, U and 1/f offsets,
   150 iterations, twice and bitwise, K3 launched ``7 + 2 k`` times,
   the recovered Q and U against the injection; N.3 ``tuning.Tuner``
   over the solver group (mg_block x mg_smooth) on the full field's band
   0, multigrid, 60 iterations, 6 candidates, 2 repeats, over the plan
   group (pair_batch 1, 2, 4, 8, each plan built on the host outside the
   timed solves) on band 0's bucket, and over the stage group
   (feed_batch) at L.2's bucket, a second tuner on the same cache taking
   0 measurements, the auto plan under ``[tuning]`` the winner's layout
   and its solve the untuned one's bits, then ``run_destriper.main`` on
   phase F's
   small store with ``[Tuning]`` logging the applied winners, its maps
   held to the untuned run's. (Phase E runs no ``SkyDip`` after its
   chain: phase J.1 runs it at the full F, B and C.)
20. phase O, several shards and several ranks (``phase_sharded``, run
   after phase N and before phase L, while phase F's small store is in
   scope): O.1 ``solve_band(sharded=True)`` on a mesh of four shards on
   the card (``feed_time_mesh(["cuda:0"] * 4)``, each shard a thread,
   ``parallel.spmd.psum`` adding in shard order) at full field width,
   band 0 on the two-level route, band 1 on the multigrid route, band 2
   on the ground route, each held to its one-shard twin on the
   invariant products (FIELD_ATOL; the stalled ground route
   SHARD_GROUND_ATOL), K3 and K4 launched per shard as derived, the
   ground route rerun bitwise; K3 and K4 on one shard's plan built with
   ``pair_batch`` 8 (merged chunks of 8 x 4 096 pairs, their wider
   windows) against their plain versions; O.2 the reduce stage's
   ``reduce_feeds_sharded`` over two shards on a full-width two-feed
   batch, bitwise against the one-device reduction, K1 and K2 per shard;
   O.3 ``parallel.ObservationStep`` on a (2, 2) mesh at the flagship
   shape against ``run_flagship`` (the Level-2 TOD and weights bitwise,
   hits B times, the naive map) and its destriped map against the same
   solve on one device; O.4 ``run_destriper.main`` as ranks 0 and 1 of 2
   in turn (the barrier off; two processes are the CPU test's) over
   phase F's small store served as two files, each ``_rank{r}`` map
   bitwise the one-rank map over that rank's file alone, and their hits,
   weights and naive maps co-added through ``mapmaking.coadd`` against
   the one-rank map over both files.
21. phase P, the last reference modules (``phase_last_modules``, run
   last): P.1 ``ops.gain.solve_gain_cg`` with the 1/f prior (50
   iterations) on one feed's stacked channels, f32[4096, 136 216] made
   on the card, with the templates built as the stage chain builds them,
   then ``subtract_gain``: finite, the same bits on a rerun, card
   against CPU at 4096 x 2 048 (``GAIN_CG_ATOL`` of scale); P.2
   ``ops.filtering.background_estimate`` with a source mask on one
   calibrator feed at phase H's length (4096 x 30 896),
   ``ops.stats.correlation_matrix`` of one feed-band (1024 x 136 216),
   and ``normalise``, ``downsample``, ``mad`` and ``tsys_rms`` on one
   feed, each card against CPU at a small shape; P.3
   ``rrls.stack_spectra`` of 19 x 4 x 1024 spectra over every Hn-alpha
   line in 26-34 GHz onto 60 velocity bins, the same bits over two runs
   and within ``RRL_RTOL`` of the CPU's, then ``fit_line`` recovering the
   injected line; P.4 ``astro.coordinates.h2e_full`` then ``e2h_full``
   on the native library (built with g++) over 19 x 136 216 samples: the
   round trip within ``ROUND_TRIP_ARCSEC``, native against the NumPy
   oracle on one feed within ``NATIVE_ARCSEC``; the walls of each.

Every phase's wall is logged (``wall <phase> <s>``) beside the calls
each K3 body took in it (``k3_bodies``): a phase in which the two-pass
body ran outside the script's own checks fails, and so does a phase that
solves (``K3_SOLVING_LAPS``) without the one-pass body.

The last lines are the ``kernels`` JSON line (K3's entry lists both
bodies), the card's name and power limit, and ``{"ok": true, "device":
{...}}``. A longer report goes to
``chiprun_out/chip_smoke_report.json``. The script imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# f32 rate outside the tensor cores, which also bounds the kernels'
# i32 compares and f32 adds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# cuda_ms: flush more than the H100's 50 MB L2 before each timed run (the
# main path streams other full-width arrays between two calls of one
# kernel), and spin the card ~10 ms at its 1.98 GHz boost clock ahead of
# each batch
L2_FLUSH_BYTES = 64 << 20
SPIN_CYCLES = 20_000_000

# tolerances of the card-vs-CPU comparison of the small chain: those of
# tests/test_torch_flagship.py (the port against the reference). The
# reduced TOD and weights are f32-conditioned by the gain solve's
# ``zpp = p^T Z p`` (~400x below ``|p|^2``): reductions summed in another
# order (cuBLAS / CUB on the card) move them by a few 1e-4 of scale;
# the maps inherit less, and K3's fixed order (not the CPU's) adds f32
# summation order
TOD_RTOL = 2e-3
MAP_ATOL = 5e-4
# f32 unit roundoff, for K3's summation bound (check_window_sum)
F32_U = 2.0 ** -24
# K5 against its plain version on the card, relative 2-norm gaps: each
# row's sums (n <= L terms) add in the kernel's fixed order, not
# PyTorch's, and two f32 orders of n terms differ by ~sqrt(n) u of the
# sum (7e-6 at L = 13 568); offset, slope and norm are ratios of such
# sums. ``clean`` is ``(d - model) / norm`` with the model ~99% of the
# counts at production scale, so the cancellation multiplies the
# offset's gap by ~100
PREFILTER_RTOL = {"clean": 1e-3, "offset": 1e-5, "slope": 1e-5,
                  "norm": 1e-5}
# card vs CPU on the small field run: the tolerance of the CPU port
# against the reference there (tests/test_torch_solve_band.py), the
# converged ground solve's null-space-invariant products
FIELD_ATOL = 5e-4
# phase D's checkpointed solve: iterations a chunk (each chunk rebuilds
# the multigrid hierarchy on the host; the solve takes about 60)
CHECKPOINT_EVERY = 50
# the laps in which the main path solves with K3 (``main`` fails one in
# which K3's one-pass body never ran)
K3_SOLVING_LAPS = ("full_chain", "field_7", "field_A",
                   "field_B_D", "reader_F", "calibration_H", "ingest_I",
                   "serving_K", "observability_M", "pol_tuning_N",
                   "sharded_O", "synthetic_L")
# the longest window K2 serves: its bisection body's 128-output block
# stages 128 + w - 1 i32 keys in the 232 448 bytes of shared memory an
# H100 block may use
K2_LONGEST_WINDOW = 57_985


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs: CUDA events around
    each run, the L2 cache flushed before each, and the whole batch
    enqueued while the card spins ahead of it.

    Without the spin the card waits on the host between the events (a
    wrapper's ctypes call and allocations take longer than a small
    kernel), and the events time the host. The first start event still
    pending once the batch is enqueued shows that the spin covered the
    host's work; otherwise the spin grows and the batch runs again."""
    import torch

    for _ in range(warm):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    spin = SPIN_CYCLES
    for _ in range(3):
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(spin)
        for s, e in events:
            flush.zero_()
            s.record()
            fn()
            e.record()
        covered = not events[0][0].query()
        torch.cuda.synchronize()
        if covered:
            break
        spin *= 4
    else:
        log(f"cuda_ms: the host outran a {spin // 4}-cycle spin; the time "
            "includes host work")
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bits_equal(a, b) -> bool:
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    return bool(torch.equal(a[~na].view(torch.int32),
                            b[~nb].view(torch.int32)))


def check_window_sum(label, vals, ids, base, window, chunk, out_size,
                     ids_sorted: bool = False):
    """Hold a K3 body (the one-pass body where ``ids_sorted``, else the
    two-pass body) against its plain version on the card in the two ways
    no order of f32 adds can blur, and against itself over three
    launches; return max |kernel - plain| and the most terms any bin sums.

    The kernel adds in its own fixed order (the one-pass body: runs in
    tile order; the two-pass body: per chunk, then chunks in order) and
    the plain version in ``index_add_``'s (atomics on the card), so they
    differ in the last bits, and more so in a bin of many terms (the
    plan's padding samples all land on one padded pair): no fixed share
    of the output's scale bounds that. Instead:

    - routing, exactly: with integer values of magnitude at most k, where
      k * (the most terms any bin sums) < 2**24 (k = 2 where that allows),
      every partial sum is an integer below 2**24 in magnitude, so every
      order of f32 adds gives the exact sum, and the kernel must equal the
      plain version bitwise — a dropped, doubled or misplaced value shows;
    - values, to a bound that holds for every order: a bin's f32 sum of
      n terms lies within gamma(n-1) * sum|x| of the exact sum, with
      gamma(k) = k u / (1 - k u) (Higham, *Accuracy and Stability of
      Numerical Algorithms*, eq. 4.6). The exact sum is taken in f64,
      whose own error is 2**29 times smaller;
    - itself, exactly: three launches on the same inputs give the same
      bits (its order is fixed by the inputs and the launch).
    """
    import torch

    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, binned_window_sum_plain)

    M = vals.shape[-1]
    args = (ids, base, window, chunk, out_size)
    kw = {"ids_sorted": ids_sorted}
    n = binned_window_sum_plain(
        torch.ones((1, M), dtype=torch.float64, device=vals.device),
        *args)[0]
    k = min(2, (2 ** 24 - 1) // max(int(n.max()), 1))
    if k < 1:
        raise SystemExit(f"K3 {label}: a bin of {int(n.max())} terms is too "
                         "long for exact integer sums")
    g = torch.Generator(device=vals.device)
    g.manual_seed(17)
    ints = torch.randint(-k, k + 1, tuple(vals.shape), generator=g,
                         device=vals.device).float()
    if not torch.equal(binned_window_sum(ints, *args, **kw),
                       binned_window_sum_plain(ints, *args)):
        raise SystemExit(f"K3 {label}: integer-valued sums differ from "
                         "the plain version")
    got = binned_window_sum(vals, *args, **kw)
    for i in (2, 3):
        if not bits_equal(binned_window_sum(vals, *args, **kw), got):
            raise SystemExit(f"K3 {label}: launch {i} on the same inputs "
                             "gave other bits than launch 1")
    want = binned_window_sum_plain(vals, *args)
    exact = binned_window_sum_plain(vals.double(), *args)
    abs_sum = binned_window_sum_plain(vals.abs().double(), *args)
    ku = (n - 1).clamp(min=0) * F32_U
    lim = ku / (1 - ku) * abs_sum
    for who, s in (("kernel", got), ("plain version", want)):
        over = float(((s.double() - exact).abs() - lim).max())
        if over > 0:
            raise SystemExit(f"K3 {label}: {who} beyond the f32 summation "
                             f"bound of the exact sum by {over}")
    return float((got - want).abs().max()), int(n.max())


#: two-pass K3 launches made by this script's own checks and timings
#: (:func:`k3_two_pass_checks`), not by the main path
K3_CHECK_TWO_PASS = [0]


@contextlib.contextmanager
def k3_two_pass_checks():
    """Inside the block, count K3's two-pass launches as this script's
    checks: ``main`` fails a phase in which the two-pass body ran
    otherwise (every K3 call of the main path takes the one-pass body)."""
    from comapreduce_tpu_torch.mapmaking.cuda_binning import \
        binned_window_sum

    n0 = binned_window_sum.bodies["two_pass"]
    try:
        yield
    finally:
        K3_CHECK_TWO_PASS[0] += binned_window_sum.bodies["two_pass"] - n0


def window_sum_stress_case(seed: int = 21, sorted_ids: bool = False):
    """A K3 layout that stresses both bodies (numpy; R = 4 values go
    with it): ``(ids, base, window, chunk, out_size)`` over 64 chunks of
    8192 sorted ids in [0, 2**21), so the window is wider than 32 768,
    with a run of 5000 equal ids across a chunk boundary and a run of 3000
    inside a chunk (both longer than a warp's 256 elements and the
    one-pass body's 2 048-element tile, and across their boundaries),
    1000 shuffled ids, a window start clipped at 0, one raised past its
    chunk's first ids, one clipped at ``out_size`` and a last chunk of
    sentinel ids. ``sorted_ids``: chunk 40's shuffled ids sorted back, so
    the ids ascend over the whole array (the one-pass body's contract)."""
    rng = np.random.default_rng(seed)
    chunk, n_chunks, out_size = 8192, 64, 1 << 21
    ids = np.sort(rng.integers(0, out_size, chunk * n_chunks))
    a = 3 * chunk - 3000
    ids[a:a + 5000] = ids[a]
    b = 10 * chunk + 1500
    ids[b:b + 3000] = ids[b]
    c = 40 * chunk + 100
    ids[c:c + 1000] = rng.permutation(ids[c:c + 1000])
    if sorted_ids:
        ids[c:c + 1000] = np.sort(ids[c:c + 1000])
    ids[-chunk:] = out_size + 3
    blocks = ids.reshape(n_chunks, chunk)
    base = blocks.min(axis=1)
    span = int((blocks[:-1].max(axis=1) - base[:-1] + 1).max())
    window = -(-span // 128) * 128
    if window <= 32768:
        raise SystemExit(f"K3 stress case: window {window} is not past "
                         "32 768")
    base[0] = -7                        # clips to 0
    base[20] += 100                     # ids below the window drop
    base[62] = out_size + 5             # clips to out_size: all drop
    base[-1] = out_size + 3             # the sentinel chunk
    return ids, base, window, chunk, out_size


def fill_edge_rows(L: int, seed: int = 23):
    """K1 rows at the edges of its selection (numpy, ``tod`` and ``mask``
    f32[10, L]): all keys equal; one valid stride-4 sample; -0.0 and +0.0
    as the middles, ±inf beside them; NaN of both signs and the sentinel-colliding NaN
    pattern among masked-in samples; ±inf as the two middles (a NaN
    fill); tied middles; middles parting in the first digit; nothing
    valid; and two rows of production-scale counts. Every row takes the
    stride-4 median or has nothing valid, so K1 is bitwise there."""
    rng = np.random.default_rng(seed)
    rows = 10
    tod = (4.5e7 * (1 + 0.01 * rng.standard_normal((rows, L)))).astype(
        np.float32)
    mask = (rng.random((rows, L)) > 0.05).astype(np.float32)
    grid = np.arange(0, L, 4)
    tod[0] = np.float32(4.5e7)
    mask[0] = 1.0
    mask[0, 1::4] = 0.0
    mask[1, grid] = 0.0
    mask[1, grid[17]] = 1.0
    half = grid.size // 2
    tod[2, grid[:half]] = -0.0                   # middles -0.0 and +0.0
    tod[2, grid[half:]] = 0.0
    tod[2, grid[:100]] = -np.inf
    tod[2, grid[-100:]] = np.inf
    mask[2, grid] = 1.0
    bits = tod[3].view(np.int32)
    bits[grid[::7]] = 0x7FC00000                 # +NaN
    bits[grid[3::7]] = np.int32(-0x400000)       # -NaN (0xFFC00000)
    bits[grid[5::97]] = 0x7FFFFFFF               # the sentinel's pattern
    bits[1::9] = 0x7FC00001                      # masked-in, off the grid
    mask[3, 1::9] = 1.0
    mask[3, grid[::7]] = 1.0
    mask[3, grid[3::7]] = 1.0
    tod[4, grid] = np.float32(np.inf)
    tod[4, grid[:half]] = -np.inf
    mask[4, grid] = 1.0
    tod[5, grid] = rng.choice(np.array([1.0, 2.0, 2.0, 3.0], np.float32),
                              grid.size)
    mask[5, grid] = 0.0
    mask[5, grid[:400]] = 1.0
    mask[6, grid] = 0.0
    mask[6, grid[[4, 9]]] = 1.0
    tod[6, grid[4]], tod[6, grid[9]] = -1e30, 1e30
    mask[7] = 0.0
    return tod, mask


def prefilter_edge_rows(L: int, seed: int = 29):
    """K5 inputs at the edges of its arithmetic (numpy ``d``, ``m``
    f32[2, 1, 8, L] and ``a`` f32[2, L]): scan 0 under a varying
    airmass, scan 1 under a constant one (1.5: its masked mean is exact,
    so ``saa`` is 0 and the slope 0). In each scan: production-scale
    counts with 1% masked out; every sample masked out (``cnt`` 0: slope
    and norm 0, clean 0); one valid sample (``cnt`` 1: slope 0, no pair:
    norm 0); only the odd samples valid (a fitted row with no pair: norm
    0, clean 0); a NaN masked in off the pair grid (the offset NaN; under
    the varying airmass the slope and norm NaN too and clean 0, under
    the constant one the slope 0, norm finite and clean NaN); mask
    weights drawn from {0, 0.5, 1, 1.5, 2} (sums of weights and of
    weights x 1.5 stay exact, so the constant airmass's fit stays
    degenerate); counts near zero of both signs; the padded tail masked
    out past 3/4 of the row."""
    rng = np.random.default_rng(seed)
    S, C = 2, 8
    t = np.arange(L)
    a = np.stack([1.2 + 0.05 * np.sin(t / 150.0),
                  np.full(L, 1.5)]).astype(np.float32)
    d = (4.5e7 * (1 + 0.01 * rng.standard_normal((S, 1, C, L)))
         + 3e5 * a[:, None, None, :]).astype(np.float32)
    m = (rng.random((S, 1, C, L)) > 0.01).astype(np.float32)
    m[:, 0, 1] = 0.0
    m[:, 0, 2] = 0.0
    m[:, 0, 2, L // 3] = 1.0
    m[:, 0, 3] = 0.0
    m[:, 0, 3, 1::2] = 1.0
    d[:, 0, 4, min(17, L - 1)] = np.nan
    m[:, 0, 4, min(17, L - 1)] = 1.0
    m[:, 0, 5] = rng.choice(np.array([0.0, 0.5, 1.0, 1.5, 2.0], np.float32),
                            (S, L))
    d[:, 0, 6] = rng.standard_normal((S, L)).astype(np.float32)
    m[:, 0, 7, 3 * L // 4:] = 0.0
    return d, m, a


def prefilter_gaps(got, want) -> dict:
    """Relative 2-norm gaps of K5's outputs (``clean`` and ``stats``'s
    offset, slope and norm) to another computation of them: where NaN
    falls must agree (a disagreement reads inf), and the gap is taken
    over the rest."""
    import torch

    gaps = {}
    for k, g, w in (("clean", got[0], want[0]),
                    *((n, got[1][i], want[1][i]) for i, n in
                      enumerate(("offset", "slope", "norm")))):
        g, w = g.double(), w.double()
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            gaps[k] = float("inf")
            continue
        num = float(torch.linalg.vector_norm(g[~nan] - w[~nan]))
        den = float(torch.linalg.vector_norm(w[~nan]))
        gaps[k] = num / den if den else num
    return gaps


def host_mem_total() -> str:
    """The host's ``MemTotal`` line of ``/proc/meminfo`` (phase E holds
    a feed batch of 2.2 GB feeds on the host)."""
    with open("/proc/meminfo") as fh:
        return next((ln.split(":", 1)[1].strip() for ln in fh
                     if ln.startswith("MemTotal")), "not reported")


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this "
                         "script runs on the card only")
    import comapreduce_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from comapreduce_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": nvcc,
           "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(),
           "nvidia_smi": smi_line(),
           "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "host_mem_total": host_mem_total()}
    if env["allow_tf32_matmul"] or env["allow_tf32_cudnn"]:
        raise SystemExit("chip_smoke: TF32 must be off for f32 parity")
    log("env", json.dumps(env))
    return env


def phase_build():
    from comapreduce_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    dt = time.perf_counter() - t0
    for name, text in _build.build_logs.items():
        log(f"ptxas {name}:", " | ".join(
            ln.strip() for ln in text.splitlines() if "Used" in ln
            or "spill" in ln))
    log(f"build {dt:.2f} s")
    return dt


def _k3_layouts(plan, dev):
    """The three binned_window_sum call sites of the planned destriper."""
    import torch

    dv = plan.device(dev)
    perm_off = dv["pair_perm_off"].to(torch.int64)
    P_pad = int(dv["pair_rank"].shape[0])
    return {
        "pair_sum": (dv["sample_pair"], dv["sample_base"],
                     plan.sample_window, plan.sample_chunk, P_pad,
                     int(dv["sample_perm"].shape[0])),
        "rank_sum": (dv["pair_rank"], dv["rank_base"], plan.rank_window,
                     plan.pair_chunk, plan.n_rank, P_pad),
        "off_sum": (dv["pair_offset"][perm_off], dv["off_base"],
                    plan.off_window, plan.pair_chunk, plan.n_offsets,
                    P_pad),
    }


def k3_sites(plan, R: int, g, prefix: str = "", only=None) -> dict:
    """K3 at the planned destriper's three call sites of ``plan`` (those
    named in ``only``, default all) with ``R`` right-hand sides of random
    values: both bodies held to the plain version and to themselves over
    three launches (``check_window_sum``), then timed in turns on the same
    inputs (one-pass, two-pass, ``index_add_``, ``segment_reduce``, and
    back; each figure the mean of its two turns) beside the plain version
    and the bound. ``index_add_`` adds into a staging column on ids
    pre-masked to the plan's windows; ``segment_reduce`` sums the values
    by each bin's run length, made outside the timing (a fixed-order
    PyTorch call: a plan's kept ids ascend and its sentinels come last,
    so each bin's terms are one run). ``bound_ms`` counts the bytes the
    function must move (the one-pass body's); ``partial_bound_ms`` adds
    the two-pass body's partial buffer (R x n_chunks x window f32,
    written by its first pass and read by its second)."""
    import torch

    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        _window_dest, binned_window_sum, binned_window_sum_plain)

    dev = torch.device("cuda")
    sites = {}
    for site, (ids, base, window, chunk, out_size, M) in _k3_layouts(
            plan, dev).items():
        if only is not None and site not in only:
            continue
        site = prefix + site
        vals = torch.randn((R, M), generator=g, device=dev)
        err, n_max = check_window_sum(site, vals, ids, base, window,
                                      chunk, out_size, ids_sorted=True)
        with k3_two_pass_checks():
            err2, _ = check_window_sum(site + " (two-pass)", vals, ids,
                                       base, window, chunk, out_size)
        dest = _window_dest(ids, base, window, chunk, out_size)
        n_valid = int((dest < out_size).sum())
        stage = torch.zeros((R, out_size + 1), device=dev)
        lens = torch.bincount(dest, minlength=out_size + 1).expand(
            R, -1).contiguous()
        args = (vals, ids, base, window, chunk, out_size)
        timers = [
            ("ms", lambda: binned_window_sum(*args, ids_sorted=True)),
            ("two_pass_ms", lambda: binned_window_sum(*args)),
            ("library_ms", lambda: stage.index_add_(1, dest, vals)),
            ("segment_reduce_ms", lambda: torch.segment_reduce(
                vals, "sum", lengths=lens, axis=1, unsafe=True))]
        turns = {name: [] for name, _ in timers}
        with k3_two_pass_checks():
            for name, fn in timers + timers[::-1]:
                turns[name].append(cuda_ms(fn, reps=20))
        sites[site] = dict(
            R=R, M=M, out_size=out_size, window=window, chunk=chunk,
            max_abs_err=err, two_pass_max_abs_err=err2,
            max_terms_per_bin=n_max, turns_ms=turns,
            plain_ms=cuda_ms(lambda: binned_window_sum_plain(*args),
                             reps=5))
        sites[site].update({name: statistics.mean(t)
                            for name, t in turns.items()})
        n_bytes = (R * M + M + M // chunk + R * out_size) * 4
        sites[site]["bound_ms"], sites[site]["bound_by"] = bound(
            n_bytes, R * n_valid)
        sites[site]["partial_bound_ms"] = bound(
            n_bytes + 2 * R * (M // chunk) * window * 4, R * n_valid)[0]
        del vals, dest, stage, lens
    return sites


def k4_site(plan, g, floor_ms: float) -> dict:
    """K4 at the ground solve's one call site on ``plan``: the
    offset-order gather of the two per-offset coefficient rows c0, c1 in
    one launch (R = 2, S = n_off, M = P_pad), bitwise against its plain
    version, timed beside it, its bound and ``index_select`` on the
    source padded with a zero slot, ids pre-mapped to that slot; beside
    it one row (R = 1) and two R = 1 launches (the parent's form of one
    matvec)."""
    import torch

    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        _window_dest, windowed_gather, windowed_gather_plain)

    dev = torch.device("cuda")
    dv = plan.device(dev)
    perm_off = dv["pair_perm_off"].to(torch.int64)
    ids = dv["pair_offset"][perm_off]
    base = dv["off_base"]
    window, chunk = plan.off_window, plan.pair_chunk
    S, M = plan.n_offsets, int(ids.shape[0])
    src = torch.randn((2, S), generator=g, device=dev)
    c0, c1 = src[0], src[1]
    errs = {}
    for R, s_r in ((1, c0), (2, src)):
        got = windowed_gather(s_r, ids, base, window, chunk)
        want = windowed_gather_plain(s_r, ids, base, window, chunk)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise SystemExit(f"K4 windowed_gather disagrees with its plain "
                             f"version at {S} offsets, R={R}")
        errs[R] = float((got - want).abs().max())
    dest = _window_dest(ids, base, window, chunk, S)
    keep = dest < S
    padded = torch.cat([src, torch.zeros((2, 1), device=dev)], dim=1)
    padded0 = padded[0].contiguous()
    n_read = int(torch.unique(dest[keep]).numel())

    def gather_bound(R):
        return bound(4 * (M + M // chunk + R * M + R * n_read), 3 * M)

    b_ms, by = gather_bound(2)
    return dict(
        shape=[2, S, M, window, chunk], max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: windowed_gather(src, ids, base, window, chunk),
                   reps=50),
        plain_ms=cuda_ms(lambda: windowed_gather_plain(src, ids, base,
                                                       window, chunk),
                         reps=20),
        bound_ms=b_ms, bound_by=by, launch_floor_ms=floor_ms,
        library_ms=cuda_ms(lambda: torch.index_select(padded, 1, dest),
                           reps=50),
        r1=dict(ms=cuda_ms(lambda: windowed_gather(c0, ids, base, window,
                                                   chunk), reps=50),
                bound_ms=gather_bound(1)[0],
                library_ms=cuda_ms(lambda: torch.index_select(
                    padded0, 0, dest), reps=50)),
        r1_pair_ms=cuda_ms(lambda: (
            windowed_gather(c0, ids, base, window, chunk),
            windowed_gather(c1, ids, base, window, chunk)), reps=50),
        in_window_lanes=int(keep.sum()))


def gather_lane_case(R: int, chunk: int = 256, seed: int = 12):
    """A K4 case with every lane kind (numpy): an R-row source over
    S = 5000, 24 chunks of sorted ids, ids below and at the end of their
    window and >= S, a chunk of sentinel ids, and window starts clipped at
    0 and at S. Returns ``(src, ids, base, window, chunk)``; a ``chunk``
    that is not a multiple of 4 takes the kernel's scalar body."""
    rng = np.random.default_rng(seed)
    S, n_chunks = 5000, 24
    ids = np.sort(rng.integers(0, S, chunk * n_chunks))
    blocks = ids.reshape(n_chunks, chunk)
    base = blocks[:, 0].copy()
    window = -(-int((blocks[:, -1] - base + 1).max()) // 128) * 128
    ids[3] = S + 1                        # >= S
    base[1] += 1                          # ids[chunk] below its window
    ids[chunk + 5] = base[1] + window     # at its window's end
    ids[-chunk:] = S + 3                  # a sentinel chunk ...
    base[-1] = S + 3                      # ... whose start clips to S
    base[2] = -7                          # clips to 0
    src = rng.normal(size=(R, S)).astype(np.float32)
    return src, ids, base, window, chunk


def median_edge_rows(P: int, window: int, seed: int = 29):
    """K2 rows at the edges of its selection (numpy, name -> f32[4, P]):
    ``tied``, values drawn from 5 levels; ``block_median``, medians of
    12 such values (levels and midpoints, heavily tied) padded
    symmetrically by the window as ``median_filter`` pads its block
    series; ``signed_zero_nan``, -0.0 and +0.0 mixed (middles of both
    signs, and windows of zeros only) with ±1 beside them, and NaNs of
    both signs, the sentinel-colliding NaN pattern and a run of NaNs, so
    that some windows hold a NaN and the others none."""
    rng = np.random.default_rng(seed)
    rows = 4
    levels = np.array([-2.5, -1.0, 0.0, 1.0, 3.5], np.float32)
    tied = rng.choice(levels, size=(rows, P))
    n_core = P - window + 1
    core = np.median(rng.choice(levels, size=(rows, n_core, 12)),
                     axis=-1).astype(np.float32)
    lo = window // 2
    block = np.pad(core, ((0, 0), (lo, window - 1 - lo)), mode="symmetric")
    zeros = np.where(rng.random((rows, P)) < 0.5, np.float32(-0.0),
                     np.float32(0.0)).astype(np.float32)
    zeros[2:, ::5] = rng.choice(np.array([-1.0, 1.0], np.float32),
                                size=(rows - 2, len(range(0, P, 5))))
    bits = zeros.view(np.int32)
    bits[0, P // 2] = 0x7FC00000                 # +NaN
    bits[1, 3:8] = np.int32(-0x400000)           # a run of -NaN
    bits[2, P - 7] = 0x7FFFFFFF                  # the sentinel's pattern
    return {"tied": tied, "block_median": block, "signed_zero_nan": zeros}


def check_gather_lanes(dev):
    """K4 on every lane kind against its plain version, bitwise: two and
    three source rows in the four-element body, and the scalar body on a
    chunk that is not a multiple of 4 and on ids that are not 16-byte
    aligned."""
    import torch

    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        windowed_gather, windowed_gather_plain)

    for R, chunk, shift in ((2, 256, 0), (3, 256, 0), (2, 255, 0),
                            (2, 256, 1)):
        src, ids, base, window, chunk = gather_lane_case(R, chunk)
        s = torch.as_tensor(src, device=dev)
        # shift: ids start one word into their buffer (not 16-byte aligned)
        buf = torch.zeros(ids.size + shift, dtype=torch.int32, device=dev)
        buf[shift:] = torch.as_tensor(ids, dtype=torch.int32)
        it = buf[shift:]
        bt = torch.as_tensor(base, dtype=torch.int32, device=dev)
        got = windowed_gather(s, it, bt, window, chunk)
        want = windowed_gather_plain(s, it, bt, window, chunk)
        torch.cuda.synchronize()
        if (not bits_equal(got, want) or bool(got[:, -chunk:].any())
                or bool(got[:, [3, chunk, chunk + 5]].any())):
            raise SystemExit(f"K4 windowed_gather disagrees with its plain "
                             f"version on the lane-kind case (R={R}, "
                             f"chunk={chunk}, ids offset {shift})")


def phase_kernel_parity(plan, full, field_plan):
    import torch

    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, binned_window_sum_occupancy,
        windowed_gather_occupancy)
    from comapreduce_tpu_torch.ops.cuda_median import (
        RM_OUT, fill_row_on_chip, masked_fill, masked_fill_occupancy,
        masked_fill_plain, rolling_median_occupancy, rolling_median_sorts,
        rolling_median_windows, rolling_median_windows_plain)
    from comapreduce_tpu_torch.ops.reduce import scan_starts_lengths

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    B, C = full.n_bands, full.n_channels
    _, lengths, L = scan_starts_lengths(
        [(0, full.scan_samples)] * full.n_scans)
    rows = full.scan_batch * B * C
    entries = {}
    # the launch floor: the device time of the smallest launch PyTorch
    # makes (a one-element zero_), against which K2's and K4's bounds,
    # far below any launch, are read
    one = torch.empty(1, device=dev)
    floor_ms = cuda_ms(lambda: one.zero_(), reps=50)
    log(f"launch floor {floor_ms:.6f} ms")

    # K1 at the scan-batch block: (2 scans x 4 bands x 1024 channels) rows
    # of L = 13568, counts ~4.5e7, the scan's padded tail masked out and
    # 1% of samples masked out at random
    tod = 4.5e7 * (1 + 0.01 * torch.randn((rows, L), generator=g,
                                          device=dev))
    mask = (torch.rand((rows, L), generator=g, device=dev) > 0.01).float()
    mask[:, int(lengths[0]):] = 0.0
    got = masked_fill(tod, mask)
    want = masked_fill_plain(tod, mask)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise SystemExit("K1 masked_fill disagrees with its plain version")
    k_ms = cuda_ms(lambda: masked_fill(tod, mask))
    p_ms = cuda_ms(lambda: masked_fill_plain(tod, mask), reps=3, warm=1)
    # the function's own work, not this kernel's: read tod and mask and
    # write out once; per row one add per sample for the mean and at most
    # one linear selection (a compare per key) over the L/4 stride-4 keys
    b_ms, by = bound(3 * rows * L * 4, rows * (L + L // 4))
    entries["masked_fill"] = dict(
        name="masked_fill", route="cuda",
        source="comapreduce_tpu_torch/csrc/masked_fill.cu",
        replaces="comapreduce_tpu/ops/pallas_median.py:306",
        shape=[rows, L], max_abs_err=float((got - want).abs().max()),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
        library_ms=None, row_on_chip=fill_row_on_chip(L),
        blocks_per_sm=masked_fill_occupancy(L),
        # not the same function: one PyTorch pass that reads two arrays of
        # K1's shape and writes a third, the rate a streaming kernel
        # reaches on this card
        stream_floor_ms=cuda_ms(lambda: torch.add(tod, mask, out=got)))
    del tod, mask, got, want
    # K1 at the edges of its selection, at the main path's L and at an
    # odd L (the scalar loads), bitwise
    for n in (L, L - 1):
        t_e, m_e = (torch.as_tensor(a, device=dev)
                    for a in fill_edge_rows(n))
        got = masked_fill(t_e, m_e)
        torch.cuda.synchronize()
        if not bits_equal(got, masked_fill_plain(t_e, m_e)):
            raise SystemExit(f"K1 masked_fill disagrees with its plain "
                             f"version on the edge rows at L={n}")
    entries["prefilter"] = prefilter_site(full, g)

    # K2 at the exact level of the two-level 6000 filter: 2 scans x 4
    # bands rows of the block-median series, window 500
    stride = -(-full.window // 512)
    P0 = L + full.window - 1
    nblocks = -(-P0 // stride)
    wb = full.window // stride
    P = nblocks + wb - 1
    x = torch.randn((full.scan_batch * B, P), generator=g, device=dev)
    got = rolling_median_windows(x, wb)
    want = rolling_median_windows_plain(x, wb)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise SystemExit("K2 rolling_median_windows disagrees with its "
                         "plain version")
    # the same at the edges of its selection (ties, -0/+0 middles, NaN
    # windows), and the second body on windows too long to sort in shared
    # memory up to the longest it serves, bitwise
    for name, xe in median_edge_rows(P, wb).items():
        xe = torch.as_tensor(xe, device=dev)
        if not bits_equal(rolling_median_windows(xe, wb),
                          rolling_median_windows_plain(xe, wb)):
            raise SystemExit(f"K2 rolling_median_windows disagrees with its "
                             f"plain version on the {name} rows")
    for w_long in (20_000, K2_LONGEST_WINDOW):
        if rolling_median_sorts(w_long):
            raise SystemExit(f"K2 at window {w_long} would take its sorted "
                             "body")
        x_long = torch.randn((2, w_long + 299), generator=g, device=dev)
        if not bits_equal(rolling_median_windows(x_long, w_long),
                          rolling_median_windows_plain(x_long, w_long)):
            raise SystemExit(f"K2's second body at window {w_long} "
                             "disagrees with its plain version")
    del x_long
    T2 = P - wb + 1
    k_ms = cuda_ms(lambda: rolling_median_windows(x, wb), reps=20)
    p_ms = cuda_ms(lambda: rolling_median_windows_plain(x, wb), reps=3,
                   warm=1)
    # an exact median per output needs at most one linear selection over
    # its window (wb compares); the kernel's sort and walks are its own
    # cost, not the function's
    b_ms, by = bound((x.numel() + got.numel()) * 4, x.shape[0] * T2 * wb)
    # the one PyTorch call computing the same function: the 0.5 quantile
    # of each window (linear interpolation: the midpoint of the two
    # middles, NaN for a window holding NaN) on an unfold view
    lib = torch.quantile(x.unfold(-1, wb, 1), 0.5, dim=-1)
    entries["rolling_median_windows"] = dict(
        name="rolling_median_windows", route="cuda",
        source="comapreduce_tpu_torch/csrc/rolling_median.cu",
        replaces="comapreduce_tpu/ops/pallas_median.py:174",
        shape=[x.shape[0], P, wb], max_abs_err=float(
            (got - want).nan_to_num().abs().max()),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
        launch_floor_ms=floor_ms,
        library_ms=cuda_ms(lambda: torch.quantile(
            x.unfold(-1, wb, 1), 0.5, dim=-1), reps=20),
        library_max_abs_err=float((lib - got).abs().max()),
        outputs_per_block=RM_OUT,
        sorted_body=rolling_median_sorts(wb),
        blocks_per_sm=rolling_median_occupancy(wb))
    del lib

    # K3 at its three call sites on each full-width path: the flagship
    # plan with its 4 bands as right-hand sides, the field plan one band
    # at a time (R = 1; pair_sum there sums the band's 10.3M samples) and
    # the field plan's joint four-band solve (R = 4)
    sites = {}
    for prefix, pl, R in (("", plan, B), ("field_", field_plan, 1),
                          ("field4_", field_plan, B)):
        sites.update(k3_sites(pl, R, g, prefix))
    # the polarized planned solve's new sites on the field plan (phase
    # N.2): the ten stacked pair rows once, the seven rank rows once,
    # then three rank rows in each CG iteration (its R = 1 offset sums
    # are the field_ sites')
    for prefix, R, site in (("pol10_", 10, "pair_sum"),
                            ("pol7_", 7, "rank_sum"),
                            ("pol3_", 3, "rank_sum")):
        sites.update(k3_sites(field_plan, R, g, prefix, only=(site,)))
    # the two-pass body's contract holds for ids in any order inside a
    # chunk: the flagship's pair sum with its ids (and values) shuffled
    # per chunk
    ids, base, window, chunk, out_size, M = _k3_layouts(
        plan, dev)["pair_sum"]
    perm = (torch.argsort(torch.rand((M // chunk, chunk), generator=g,
                                     device=dev), dim=1)
            + torch.arange(0, M, chunk, device=dev)[:, None]).reshape(-1)
    vals = torch.randn((B, M), generator=g, device=dev)
    with k3_two_pass_checks():
        err, n_max = check_window_sum("shuffled pair_sum", vals[:, perm],
                                      ids[perm].contiguous(), base, window,
                                      chunk, out_size)
        sites["pair_sum_shuffled"] = dict(
            R=B, M=M, out_size=out_size, window=window, chunk=chunk,
            two_pass_max_abs_err=err, max_terms_per_bin=n_max,
            two_pass_ms=cuda_ms(lambda: binned_window_sum(
                vals[:, perm].contiguous(), ids[perm].contiguous(), base,
                window, chunk, out_size), reps=10))
    del vals, perm
    plan_sites = [v for k, v in sites.items() if k != "pair_sum_shuffled"]
    head = sites["rank_sum"]
    one_blocks, tile = binned_window_sum_occupancy(B, ids_sorted=True)
    two_blocks, per_pass = binned_window_sum_occupancy(B, plan.rank_window)
    entries["binned_window_sum"] = dict(
        name="binned_window_sum", route="cuda",
        source="comapreduce_tpu_torch/csrc/binned_window_sum.cu",
        replaces="comapreduce_tpu/mapmaking/pallas_binning.py:204",
        max_abs_err=max(s["max_abs_err"] for s in plan_sites),
        ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"],
        segment_reduce_ms=head["segment_reduce_ms"],
        headline_site="rank_sum",
        # both bodies, each held to the plain version at every site (the
        # two-pass body also on the shuffled ids); ``launches`` is filled
        # in from the main path's run
        bodies=[
            {"body": "one_pass", "max_abs_err": max(
                s["max_abs_err"] for s in plan_sites),
             "ms": head["ms"], "bound_ms": head["bound_ms"],
             "blocks_per_sm": one_blocks, "tile_elements": tile},
            {"body": "two_pass", "max_abs_err": max(
                s["two_pass_max_abs_err"] for s in sites.values()),
             "ms": head["two_pass_ms"],
             "bound_ms": head["partial_bound_ms"],
             "blocks_per_sm": two_blocks, "elements_per_pass": per_pass}],
        blocks_per_sm=one_blocks, tile_elements=tile,
        sites=sites)
    # K4 at its one call site, the ground solve's offset-order gather of
    # its two per-offset coefficient rows c0, c1 in one launch (R = 2,
    # S = n_off, M = P_pad) on the full field plan; beside it one row
    # (R = 1) and the parent's form of one matvec, two R = 1 launches
    check_gather_lanes(dev)
    entries["windowed_gather"] = dict(
        name="windowed_gather", route="cuda",
        source="comapreduce_tpu_torch/csrc/windowed_gather.cu",
        replaces="comapreduce_tpu/mapmaking/pallas_binning.py:285",
        **k4_site(field_plan, g, floor_ms),
        blocks_per_sm=windowed_gather_occupancy(True),
        scalar_blocks_per_sm=windowed_gather_occupancy(False))
    for k, v in entries.items():
        log("parity", k, json.dumps(v))
    return entries


def prefilter_site(full, g) -> dict:
    """K5 at the scan-batch block (2 scans x 4 bands x 1024 channels rows
    of L = 13 568; counts ~4.5e7 over an airmass slope, 1% masked out,
    the padded tail masked out): against its plain version within
    ``PREFILTER_RTOL``, both against the plain version in float64, one
    scan launched alone bitwise its rows of the whole block, and the
    edge rows (``prefilter_edge_rows``) at L, L - 1 and L - 3 (the pair
    grid's tail); then timed (L2 flushed) beside its bytes bound and the
    plain version. ``launches_derived`` is what the flagship run derives
    (one a scan batch of each feed; the stage chain's and phase O's are
    checked in their phases)."""
    import torch

    from comapreduce_tpu_torch.ops.prefilter import (
        prefilter, prefilter_occupancy, prefilter_plain,
        prefilter_row_on_chip)
    from comapreduce_tpu_torch.ops.reduce import (ReduceConfig,
                                                  scan_starts_lengths)

    dev = torch.device("cuda")
    B, C, S = full.n_bands, full.n_channels, full.scan_batch
    _, lengths, L = scan_starts_lengths(
        [(0, full.scan_samples)] * full.n_scans)
    cfg = ReduceConfig(C)
    bt = cfg.bandwidth * cfg.tau
    t = torch.arange(L, device=dev, dtype=torch.float32)
    a = torch.stack([1.2 + 0.05 * torch.sin(t / 150.0 + s)
                     for s in range(S)])
    d = (4.5e7 * (1 + 0.01 * torch.randn((S, B, C, L), generator=g,
                                         device=dev))
         + 3e5 * a[:, None, None, :])
    m = (torch.rand((S, B, C, L), generator=g, device=dev) > 0.01).float()
    m[..., int(lengths[0]):] = 0.0
    got = prefilter(d, m, a, bt)
    want = prefilter_plain(d, m, a, bt)
    f64 = prefilter_plain(d.double(), m.double(), a.double(), bt)
    one = prefilter(d[:1].contiguous(), m[:1].contiguous(), a[:1], bt)
    torch.cuda.synchronize()
    gaps = prefilter_gaps(got, want)
    if any(gaps[k] > PREFILTER_RTOL[k] for k in gaps):
        raise SystemExit(f"K5 prefilter disagrees with its plain version: "
                         f"{gaps}")
    if not (bits_equal(one[0], got[0][:1])
            and bits_equal(one[1], got[1][:, :1])):
        raise SystemExit("K5 prefilter: one scan launched alone differs "
                         "from its rows of the whole block")
    edge = {}
    for n in (L, L - 1, L - 3):
        de, me, ae = (torch.as_tensor(x, device=dev)
                      for x in prefilter_edge_rows(n))
        edge[n] = prefilter_gaps(prefilter(de, me, ae, bt),
                                 prefilter_plain(de, me, ae, bt))
        if any(edge[n][k] > PREFILTER_RTOL[k] for k in edge[n]):
            raise SystemExit(f"K5 prefilter disagrees with its plain "
                             f"version on the edge rows at L={n}: "
                             f"{edge[n]}")
    rows = S * B * C
    k_ms = cuda_ms(lambda: prefilter(d, m, a, bt))
    p_ms = cuda_ms(lambda: prefilter_plain(d, m, a, bt), reps=3, warm=1)
    # the function's own work: d and m read and clean written once, the
    # airmass rows read and offset, slope, norm written once; per sample
    # 16 operations (the fit's two passes, the write), per pair 15 (the
    # std's two passes)
    b_ms, by = bound(4 * (3 * rows * L + S * L + 3 * rows),
                     rows * (16 * L + 15 * (L // 4)))
    line = dict(
        name="prefilter", route="cuda",
        source="comapreduce_tpu_torch/csrc/prefilter.cu",
        replaces="XLA's fusion of comapreduce_tpu/ops/reduce.py:550 "
                 "_prefilter_chain (no Pallas kernel)",
        shape=[rows, L], gaps=gaps,
        gaps_f64={"kernel": prefilter_gaps(got, f64),
                  "plain": prefilter_gaps(want, f64)},
        edge_gaps={str(k): v for k, v in edge.items()},
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
        roofline_pct=100.0 * b_ms / k_ms, library_ms=None,
        row_on_chip=prefilter_row_on_chip(L),
        blocks_per_sm=prefilter_occupancy(L),
        launches_derived={"flagship": full.n_feeds * -(-full.n_scans // S)})
    log("k5_site", json.dumps(line))
    return line


def phase_large_paths():
    """What the main path's shapes never take, each against its plain
    version: K1's second body, its keys in device scratch and its row read
    twice (L = 300 000 and 300 001, the float4 and the scalar loads),
    bitwise (every row takes the stride-4 median); K5's second body
    (its passes over device memory) on the edge rows at the calibrator's
    scan length, L = 30 336 and 30 337, within ``PREFILTER_RTOL``; K3 on
    ``window_sum_stress_case`` (4 rows), as ``check_window_sum`` holds
    it: the two-pass body with chunk 40's ids shuffled, the one-pass body
    with them sorted back."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (
        fill_row_on_chip, masked_fill, masked_fill_plain)
    from comapreduce_tpu_torch.ops.prefilter import (
        prefilter, prefilter_plain, prefilter_row_on_chip)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    out = {}
    for L in (300_000, 300_001):
        if fill_row_on_chip(L):
            raise SystemExit(f"K1 at L={L} would keep its row on chip")
        tod = 10.0 + torch.randn((16, L), generator=g, device=dev)
        mask = (torch.rand((16, L), generator=g, device=dev) > 0.05).float()
        tod[0, 7] = float("nan")
        mask[0, 7] = 0.0
        got = masked_fill(tod, mask)
        want = masked_fill_plain(tod, mask)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise SystemExit(f"K1's second body at L={L} disagrees with "
                             "its plain version")
        out[f"masked_fill_L{L}"] = float((got - want).abs().max())
    for L in (30_336, 30_337):
        if prefilter_row_on_chip(L):
            raise SystemExit(f"K5 at L={L} would keep its row on chip")
        d, m, a = (torch.as_tensor(x, device=dev)
                   for x in prefilter_edge_rows(L))
        gaps = prefilter_gaps(prefilter(d, m, a, 0.04),
                              prefilter_plain(d, m, a, 0.04))
        if any(gaps[k] > PREFILTER_RTOL[k] for k in gaps):
            raise SystemExit(f"K5's second body at L={L} disagrees with "
                             f"its plain version: {gaps}")
        out[f"prefilter_L{L}"] = gaps
    # K3's two-pass body on the stress case as it is (ids shuffled in
    # chunk 40), its one-pass body with those ids sorted back
    for sorted_ids, key in ((False, "binned_window_sum_two_pass"),
                            (True, "binned_window_sum")):
        ids, base, window, chunk, out_size = window_sum_stress_case(
            sorted_ids=sorted_ids)
        vals = torch.randn((4, ids.size), generator=g, device=dev)
        with k3_two_pass_checks():
            err, n_max = check_window_sum(
                "stress case" + (" (ids sorted)" if sorted_ids else ""),
                vals, torch.as_tensor(ids, dtype=torch.int32, device=dev),
                torch.as_tensor(base, dtype=torch.int32, device=dev),
                window, chunk, out_size, ids_sorted=sorted_ids)
        out[key] = err
    out["binned_window_sum_window"] = window
    out["binned_window_sum_max_terms"] = n_max
    log("large_paths", json.dumps(out))
    return out


def _inputs_as_numpy(shape, seed):
    """One set of inputs both devices can take: drawn on the CPU."""
    import torch

    from comapreduce_tpu_torch.flagship import (flagship_inputs_from_arrays,
                                                make_flagship_inputs)

    gen = make_flagship_inputs(shape, seed=seed, device="cpu")
    feeds = []
    for f in range(shape.n_feeds):
        x = gen.feed(f, torch.device("cpu"))
        feeds.append({k: v.numpy() for k, v in x.items()})
    return flagship_inputs_from_arrays(shape, feeds)


def phase_small_chain():
    import torch

    from comapreduce_tpu_torch.flagship import SMALL, run_flagship

    inputs = _inputs_as_numpy(SMALL, seed=3)
    gpu = run_flagship(inputs, device="cuda")
    cpu = run_flagship(inputs, device="cpu")
    rg, rc = gpu["result"], cpu["result"]
    diffs = {}

    def scaled(name, a, b):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        d = float(np.abs(a - b).max())
        lim = TOD_RTOL * max(float(np.abs(b).max()), 1e-30)
        diffs[name] = d
        if not d <= lim:
            raise SystemExit(f"small chain {name}: card vs CPU {d} > {lim}")

    def absolute(name, a, b):
        d = float((a.cpu() - b.cpu()).abs().max())
        diffs[name] = d
        if not d <= MAP_ATOL:
            raise SystemExit(f"small chain {name}: card vs CPU {d} > "
                             f"{MAP_ATOL}")

    scaled("band_tod", gpu["band_tod"], cpu["band_tod"])
    scaled("band_w", gpu["band_w"], cpu["band_w"])
    scaled("weight_map", rg.weight_map, rc.weight_map)
    for name in ("offsets", "destriped_map", "naive_map"):
        absolute(name, getattr(rg, name), getattr(rc, name))
    if not torch.equal(rg.hit_map.cpu(), rc.hit_map):
        raise SystemExit("small chain hit_map: card vs CPU differ")
    if abs(int(rg.n_iter) - int(rc.n_iter)) > 1:
        raise SystemExit(f"small chain CG iterations {int(rg.n_iter)} vs "
                         f"{int(rc.n_iter)}")
    out = {"max_diff": diffs, "cg_iters_card": int(rg.n_iter),
           "cg_iters_cpu": int(rc.n_iter)}
    log("small_chain", json.dumps(out))
    return out


def phase_full_chain(full, plan):
    import torch

    from comapreduce_tpu_torch.flagship import (make_flagship_inputs,
                                                run_flagship)
    from comapreduce_tpu_torch.mapmaking.cuda_binning import \
        binned_window_sum
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.ops.prefilter import prefilter

    counters = {"masked_fill": masked_fill,
                "rolling_median_windows": rolling_median_windows,
                "binned_window_sum": binned_window_sum,
                "prefilter": prefilter}
    inputs = make_flagship_inputs(full, seed=7, device="cuda")
    warm = run_flagship(inputs, device="cuda", plan=plan)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    bodies0 = dict(binned_window_sum.bodies)
    out = run_flagship(inputs, device="cuda", plan=plan)
    launches = {k: fn.launches for k, fn in counters.items()}
    k3_bodies = {k: n - bodies0[k]
                 for k, n in binned_window_sum.bodies.items()}
    if k3_bodies != {"one_pass": launches["binned_window_sum"],
                     "two_pass": 0}:
        raise SystemExit(f"full chain: K3's bodies {k3_bodies}; every "
                         "call must take the one-pass body")
    res = out["result"]
    for k, n in launches.items():
        if n <= 0:
            raise SystemExit(f"full chain never launched kernel {k}")
    # K1, K2 and K5 run once per scan batch of each feed
    per_feed = -(-full.n_scans // full.scan_batch)
    for k in ("masked_fill", "rolling_median_windows", "prefilter"):
        if launches[k] != full.n_feeds * per_feed:
            raise SystemExit(f"full chain launched {k} {launches[k]} times, "
                             f"not {full.n_feeds * per_feed}")
    for name in ("destriped_map", "naive_map", "weight_map", "hit_map",
                 "offsets"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise SystemExit(f"full chain: non-finite values in {name}")
    F, B, C, T = (full.n_feeds, full.n_bands, full.n_channels,
                  full.n_samples)
    npix = full.nx * full.ny
    n_hit = int((res.hit_map > 0).sum())
    if n_hit != plan.n_rank:
        raise SystemExit(f"{n_hit} hit pixels in the map but n_rank "
                         f"{plan.n_rank} in the plan")
    hit_fraction = n_hit / npix
    resid = [float(r) for r in res.residual.cpu()]
    converged = all(r <= full.threshold for r in resid)
    line = {
        "tod_samples_per_sec": F * B * C * T / out["wall_s"],
        "shape": [F, B, C, T], "medfilt_window": full.window,
        "wall_s": out["wall_s"], "reduce_wall_s": out["reduce_s"],
        "destripe_wall_s": out["destripe_s"],
        "warmup_wall_s": warm["wall_s"],
        "cg_iters": int(res.n_iter), "cg_residual": resid,
        "cg_iters_to_tol": int(res.n_iter) if converged else None,
        "N_pad": int(plan.sample_perm.shape[0]),
        "P_pad": int(plan.pair_rank.shape[0]), "n_rank": plan.n_rank,
        "n_offsets": plan.n_offsets, "sample_window": plan.sample_window,
        "rank_window": plan.rank_window, "off_window": plan.off_window,
        "map_hit_fraction": hit_fraction, "launches": launches,
        "k3_bodies": k3_bodies,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("full_chain", json.dumps(line))
    return line, launches, inputs


# K3's one-pass body, the one the main path takes: one kernel a launch
# (the two-pass body's two kernels, its partial pass and its output pass,
# are ``binned_window_partial_kernel`` and ``binned_window_out_kernel``)
K3_SYMBOL = "binned_window_sorted_kernel"


def kernel_share(kernels, name: str, busy_ms: float) -> dict:
    """In-loop device time of one kernel from a profile's CUDA events:
    total ms, launches, ms per launch and share of all kernel time."""
    hit = [e for e in kernels if name in e.key]
    ms = sum(e.self_device_time_total for e in hit) / 1e3
    n = sum(e.count for e in hit)
    return {"ms": ms, "count": n, "ms_per_launch": ms / n if n else None,
            "share_of_device_time": ms / busy_ms if busy_ms else None}


class StageLog(logging.Handler):
    """Collects what ``solve_band`` logs: the host set-up stages (plan and
    coarse builds, with their seconds) and its warnings."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages, self.warnings = [], []

    def emit(self, record):
        if hasattr(record, "stage"):
            self.stages.append((record.stage, float(record.seconds)))
        elif record.levelno >= logging.WARNING:
            self.warnings.append(record.getMessage())

    def clear(self):
        self.stages, self.warnings = [], []

    def seconds(self, stage: str) -> float:
        return sum(t for name, t in self.stages if name == stage)


def residual_trajectory(res) -> dict:
    """The CG recurrence's relative residual ``sqrt(rr / |b|^2)`` of a
    solve run with ``trace_iters``: at iterations 10, 25, 50, 75 and 100
    and its least value (the reported residual is the last one)."""
    rr, _, _, b_norm = res.trace
    k = int(res.n_iter)
    rel = (rr[:k] / b_norm.clamp(min=1e-30)).sqrt().cpu().numpy()
    return {"at": {str(i): float(rel[i - 1]) for i in (10, 25, 50, 75, 100)
                   if i <= k},
            "min": float(rel.min()), "argmin": int(rel.argmin()) + 1}


def _synced() -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


def _field_checks(label, res, plan, npix):
    """Finite products and hit coverage equal to the plan's n_rank;
    returns the hit fraction."""
    import torch

    for name in ("offsets", "ground", "destriped_map", "naive_map",
                 "weight_map", "hit_map"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise SystemExit(f"{label}: non-finite {name}")
    n_hit = int((res.hit_map > 0).sum())
    if n_hit != plan.n_rank:
        raise SystemExit(f"{label}: {n_hit} hit pixels, the plan has "
                         f"n_rank {plan.n_rank}")
    return n_hit / npix


def phase_small_field():
    """The field path at FIELD_SMALL on the card and on the CPU: the
    converged ground solves' null-space-invariant products agree."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, OFFSET_LENGTH,
                                                SOLVE_KW, field_geometry,
                                                invariants, make_field_band)

    sh = FIELD_SMALL
    geo = field_geometry(sh)
    out = []
    for band in range(sh.n_bands):
        data, _ = make_field_band(sh, geo, band)
        res = {dev: solve_band(data, device=dev, **SOLVE_KW)
               for dev in ("cuda", "cpu")}
        inv = {dev: invariants(r, data, OFFSET_LENGTH)
               for dev, r in res.items()}
        diffs = {k: float(np.abs(inv["cuda"][k] - inv["cpu"][k]).max())
                 for k in inv["cpu"]}
        for k, d in diffs.items():
            if not d <= FIELD_ATOL:
                raise SystemExit(f"small field band {band} {k}: card vs "
                                 f"CPU {d} > {FIELD_ATOL}")
        if not torch.equal(res["cuda"].hit_map.cpu(), res["cpu"].hit_map):
            raise SystemExit(f"small field band {band}: hit maps differ")
        out.append({"band": band, "max_diff": diffs,
                    "cg_iters": {d: int(r.n_iter) for d, r in res.items()},
                    "residual": {d: float(r.residual)
                                 for d, r in res.items()},
                    "diverged": {d: int(r.diverged)
                                 for d, r in res.items()}})
    log("small_field", json.dumps(out))
    return out


def phase_field_setup(stage_log):
    """The full field run's geometry and its pointing plan, built on the
    host through ``solve_band``'s own memo (so the bands hit it)."""
    from comapreduce_tpu_torch.cli.run_destriper import pointing_plan
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, OFFSET_LENGTH,
                                                field_geometry)

    sh = FIELD_FULL
    t0 = time.perf_counter()
    geo = field_geometry(sh)
    geo_s = time.perf_counter() - t0
    stage_log.clear()
    plan = pointing_plan(geo[0], sh.nx * sh.ny, OFFSET_LENGTH)
    out = {"samples_per_band": int(geo[0].size), "n_groups": sh.n_groups,
           "geometry_s": geo_s, "plan_build_s": stage_log.seconds(
               "plan_build"), "n_offsets": plan.n_offsets,
           "n_rank": plan.n_rank, "P_pad": int(plan.pair_rank.shape[0]),
           "off_window": plan.off_window, "rank_window": plan.rank_window,
           "sample_window": plan.sample_window}
    log("field_setup", json.dumps(out))
    return geo, plan, out


#: phase 7's bands (cut from four, as phases A and B: every band runs the
#: same code on the same pointing)
FIELD_7_BANDS = 2


def phase_field(geo, plan, stage_log):
    """The first ``FIELD_7_BANDS`` bands of the full field run through
    ``solve_band`` on the card, each with the K3 and K4 counters set to 0
    just before its solve and read just after. Checks: finite products, the hit map's coverage
    equal to the plan's ``n_rank / npix``, every group's az slope within
    ``fieldrun.SLOPE_ATOL`` of the injected one (less the shift a sky
    gradient makes indistinguishable per scan orientation), the plan
    taken from the memo in every band and the coarse pattern in every band
    after the first."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, SLOPE_ATOL,
                                                SOLVE_KW, make_field_band,
                                                slope_errors)
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)

    sh = FIELD_FULL
    npix = sh.nx * sh.ny
    counters = {"binned_window_sum": binned_window_sum,
                "windowed_gather": windowed_gather}
    bands, total = [], {k: 0 for k in counters}
    keep = None
    for band in range(FIELD_7_BANDS):
        t0 = time.perf_counter()
        data, truth = make_field_band(sh, geo, band)
        gen_s = time.perf_counter() - t0
        if keep is None:
            keep = data
        stage_log.clear()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t1 = _synced()
        res = solve_band(data, trace_iters=SOLVE_KW["n_iter"], **SOLVE_KW)
        wall = _synced() - t1
        launches = {k: fn.launches for k, fn in counters.items()}
        for k, n in launches.items():
            if n <= 0:
                raise SystemExit(f"field band {band} never launched {k}")
            total[k] += n
        re_solved = any("re-solving" in w for w in stage_log.warnings)
        # K4: one launch (both coefficient rows) per CG iteration
        if not re_solved and launches["windowed_gather"] != int(res.n_iter):
            raise SystemExit(f"field band {band} launched windowed_gather "
                             f"{launches['windowed_gather']} times in "
                             f"{int(res.n_iter)} CG iterations")
        cover = _field_checks(f"field band {band}", res, plan, npix)
        err = slope_errors(res, truth, sh)
        raw = res.ground[:, 1].cpu().numpy() - truth["ground"][:, 1]
        orient = (np.arange(sh.n_groups) // sh.n_feeds) % 2
        if not float(np.abs(err).max()) < SLOPE_ATOL:
            raise SystemExit(f"field band {band}: az slope off the injected "
                             f"one by {float(np.abs(err).max())} >= "
                             f"{SLOPE_ATOL}")
        if stage_log.seconds("plan_build") > 0:
            raise SystemExit(f"field band {band} rebuilt the pointing plan")
        pattern_s = stage_log.seconds("coarse_pattern")
        if band > 0 and pattern_s > 0:
            raise SystemExit(f"field band {band} rebuilt the coarse pattern")
        coarse_s = stage_log.seconds("coarse_build")
        line = {"band": band, "wall_s": wall, "coarse_pattern_s": pattern_s,
                "coarse_build_s": coarse_s,
                "solve_s": wall - pattern_s - coarse_s, "data_gen_s": gen_s,
                "cg_iters": int(res.n_iter),
                "residual": float(res.residual),
                "diverged": int(res.diverged),
                "re_solved": re_solved,
                "residual_trajectory": residual_trajectory(res),
                "slope_err_max": float(np.abs(err).max()),
                "slope_err_rms": float(np.sqrt(np.mean(err ** 2))),
                "slope_raw_err_max": float(np.abs(raw).max()),
                "slope_orientation_shift": [float(raw[orient == o].mean())
                                            for o in (0, 1)],
                "map_hit_fraction": cover, "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log("field_band", json.dumps(line))
        bands.append(line)
    return bands, total, keep


def phase_field_profile(data, stage_log, top: int = 12):
    """One more full-width band under ``torch.profiler``: K3's and K4's
    device time, per launch and as a share of device time, and the
    device's busy share of the solve (the host's coarse build
    excluded); the device's activity only (the host's op events, which
    nothing here reads, cost seconds of host time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import SOLVE_KW

    stage_log.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = _synced()
        res = solve_band(data, **SOLVE_KW)
        wall = _synced() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k3 = kernel_share(kernels, K3_SYMBOL, busy_ms)
    # the one-pass body's kernels against the launches the code derives
    # for a two-level ground solve (a re-solve adds more)
    k3["launches_derived"] = k3_launches(int(res.n_iter), ground=True,
                                         nu=0)
    k4 = kernel_share(kernels, "windowed_gather_kernel", busy_ms)
    solve_s = wall - stage_log.seconds("coarse_pattern") - stage_log.seconds(
        "coarse_build")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    out = {"profiled_wall_s": wall, "profiled_solve_s": solve_s,
           "cg_iters": int(res.n_iter), "device_kernel_ms": busy_ms,
           "device_busy_share_of_solve": busy_ms / 1e3 / solve_s,
           "k3": k3, "k4": k4,
           "top_kernels": [{"kernel": e.key[:120],
                            "ms": e.self_device_time_total / 1e3,
                            "count": e.count} for e in kernels[:top]]}
    log("field_profile", json.dumps({k: v for k, v in out.items()
                                     if k != "top_kernels"}))
    for r in out["top_kernels"]:
        log("field_profile_kernel", json.dumps(r))
    return out


def k3_launches(n_iter: int, ground: bool, nu: int = 1) -> int:
    """K3 launches of one cold ``destripe_planned`` solve under the
    multigrid V-cycle, from the code:

    - set-up: ``pair_sum`` of the weights, the weighted TOD and the
      sample counts, ``rank_sum`` of the pair weights, ``off_sum`` of the
      diagonal, ``to_map`` of the weighted TOD, ``off_sum`` of the
      right-hand side and of the Jacobi correction: 8; the ground solve
      adds ``pair_sum`` of w az, w az^2 and w az d and ``off_sum`` of the
      az right-hand side: 12;
    - one V-cycle application: 2 nu fine matvecs (the residual after the
      pre-smooth from zero, which takes none, nu - 1 more pre-smooths and
      nu post-smooths), each a ``rank_sum`` and an ``off_sum``: 4 nu —
      the coarser levels use ``index_add_``, not K3;
    - the CG: one application before the loop, then per iteration one
      matvec (offsets-only 2, the ground solve's joint matvec 3) and one
      application;
    - the products: ``to_map`` of the residual pairs and ``rank_sum`` of
      the counts: 2.

    So 14 + 6 k offsets-only and 18 + 7 k with the ground template at
    nu = 1 (the two-level ground solve, without the V-cycle: 14 + 3 k)."""
    setup = 12 if ground else 8
    per_matvec = 3 if ground else 2
    vc = 4 * nu
    return setup + vc + n_iter * (per_matvec + vc) + 2


def precise_dot_case(n: int, seed: int):
    """Two f32 vectors of ``n`` normal values (numpy) and their float64
    dot, which ``precise_dot`` is held to."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return x, y, float(np.dot(x.astype(np.float64), y.astype(np.float64)))


def phase_small_mg_banded():
    """The new solver options at FIELD_SMALL on the card and on the CPU:
    the ground + multigrid band solve (null-space-invariant products),
    the banded + multigrid offsets-only solve on the matched-1/f variant
    (mean-removed offsets and maps) and the ground + multigrid solve with
    compensated CG dots, each converged, at FIELD_ATOL; then
    ``precise_dot`` on the card against a float64 dot at the field's
    offset count and sample count, and its time per call beside the f32
    ``torch.dot``."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, FIELD_SMALL,
                                                MG_KW, OFFSET_LENGTH,
                                                field_geometry, invariants,
                                                make_field_band,
                                                make_field_band_1f)
    from comapreduce_tpu_torch.ops.precision import precise_dot

    sh = FIELD_SMALL
    geo = field_geometry(sh)
    ground_kw = dict(offset_length=OFFSET_LENGTH, use_ground=True,
                     n_iter=100, threshold=1e-6, mg=MG_KW)
    data, _ = make_field_band(sh, geo, 0)
    data_1f, _, quality = make_field_band_1f(sh, geo, 0)
    cases = {
        "ground_mg": (data, ground_kw),
        "banded_mg": (data_1f, dict(offset_length=OFFSET_LENGTH, n_iter=100,
                                    threshold=1e-6, mg=MG_KW,
                                    noise_weight={"bandwidth": 4},
                                    quality=quality, band=0)),
        "ground_mg_compensated": (data, dict(ground_kw, cg_dot="compensated")),
    }
    out = {}
    for name, (d, kw) in cases.items():
        res = {dev: solve_band(d, device=dev, **kw) for dev in ("cuda", "cpu")}
        if kw.get("use_ground"):
            inv = {dev: invariants(r, d, OFFSET_LENGTH)
                   for dev, r in res.items()}
        else:
            inv = {}
            for dev, r in res.items():
                hit = r.hit_map.cpu().numpy() > 0
                a = r.offsets.cpu().numpy()
                m = r.destriped_map.cpu().numpy()[hit]
                inv[dev] = {"offsets": a - a.mean(), "map": m - m.mean()}
        diffs = {k: float(np.abs(inv["cuda"][k] - inv["cpu"][k]).max())
                 for k in inv["cpu"]}
        for k, dd in diffs.items():
            if not dd <= FIELD_ATOL:
                raise SystemExit(f"small {name} {k}: card vs CPU {dd} > "
                                 f"{FIELD_ATOL}")
        for dev, r in res.items():
            if not (float(r.residual) < 1e-6 and int(r.diverged) == 0):
                raise SystemExit(f"small {name} on {dev}: residual "
                                 f"{float(r.residual)}, diverged "
                                 f"{int(r.diverged)}")
        if not torch.equal(res["cuda"].hit_map.cpu(), res["cpu"].hit_map):
            raise SystemExit(f"small {name}: hit maps differ")
        out[name] = {"max_diff": diffs,
                     "cg_iters": {dv: int(r.n_iter) for dv, r in res.items()},
                     "residual": {dv: float(r.residual)
                                  for dv, r in res.items()}}
    # precise_dot on the card: the f32 rounding of a sum kept to ~48 bits,
    # so within u |exact| plus the float-float tree's own error, at most
    # (depth + 2)^2 u^2 sum|x y| (Ogita, Rump and Oishi 2005, dot2)
    dots = {}
    n_samples = FIELD_FULL.n_groups * FIELD_FULL.stream_samples
    for n in (n_samples // OFFSET_LENGTH, n_samples):
        x, y, exact = precise_dot_case(n, seed=n % 1000)
        xt = torch.as_tensor(x, device="cuda")
        yt = torch.as_tensor(y, device="cuda")
        got = float(precise_dot(xt, yt))
        f32 = float(torch.dot(xt, yt))
        abs_sum = float(np.dot(np.abs(x).astype(np.float64),
                               np.abs(y).astype(np.float64)))
        depth = int(np.ceil(np.log2(n)))
        lim = F32_U * abs(exact) + (depth + 2) ** 2 * F32_U ** 2 * abs_sum
        if not abs(got - exact) <= lim:
            raise SystemExit(f"precise_dot at n={n}: {got} vs float64 "
                             f"{exact}, off by {abs(got - exact)} > {lim}")
        dots[str(n)] = {
            "err": abs(got - exact), "limit": lim,
            "f32_dot_err": abs(f32 - exact),
            "ms": cuda_ms(lambda: precise_dot(xt, yt), reps=10),
            "f32_dot_ms": cuda_ms(lambda: torch.dot(xt, yt), reps=20)}
    out["precise_dot"] = dots
    log("small_mg_banded", json.dumps(out))
    return out


# phase A's depth: the first bands of the full field run under the
# V-cycle (phase 7 solves all four with the two-level preconditioner),
# so the script keeps to its budget
FIELD_MG_BANDS = 2


def phase_field_mg(geo, plan, stage_log, twolevel_bands):
    """Phase A: the first ``FIELD_MG_BANDS`` bands of the full field run
    through ``solve_band``
    with the ground template and the multigrid V-cycle (``fieldrun.MG_KW``),
    100 iterations, threshold 1e-6, each with the K3 and K4 counters set
    to 0 just before its solve and read just after. Checks those of the
    two-level field phase (finite products, hit coverage, slopes within
    ``SLOPE_ATOL``, the plan from the memo), the multigrid patterns built
    in band 0 only, K4 once per CG iteration and K3 as
    :func:`k3_launches` derives. Reports each band's wall split into the
    host stages and the solve, beside the two-level band's residual."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, MG_KW,
                                                OFFSET_LENGTH, SLOPE_ATOL,
                                                make_field_band,
                                                slope_errors)
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)

    sh = FIELD_FULL
    kw = dict(offset_length=OFFSET_LENGTH, use_ground=True, n_iter=100,
              threshold=1e-6, mg=MG_KW, trace_iters=100)
    counters = {"binned_window_sum": binned_window_sum,
                "windowed_gather": windowed_gather}
    bands, total = [], {k: 0 for k in counters}
    keep = None
    for band in range(FIELD_MG_BANDS):
        t0 = time.perf_counter()
        data, truth = make_field_band(sh, geo, band)
        gen_s = time.perf_counter() - t0
        if keep is None:
            keep = data
        stage_log.clear()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t1 = _synced()
        res = solve_band(data, **kw)
        wall = _synced() - t1
        launches = {k: fn.launches for k, fn in counters.items()}
        for k, n in launches.items():
            if n <= 0:
                raise SystemExit(f"mg field band {band} never launched {k}")
            total[k] += n
        k_it = int(res.n_iter)
        re_solved = any("re-solving" in w for w in stage_log.warnings)
        if not re_solved:
            if launches["windowed_gather"] != k_it:
                raise SystemExit(
                    f"mg field band {band} launched windowed_gather "
                    f"{launches['windowed_gather']} times in {k_it} CG "
                    "iterations")
            want = k3_launches(k_it, ground=True, nu=MG_KW["smooth"])
            if launches["binned_window_sum"] != want:
                raise SystemExit(f"mg field band {band} launched "
                                 f"binned_window_sum "
                                 f"{launches['binned_window_sum']} times, "
                                 f"not {want}")
        cover = _field_checks(f"mg field band {band}", res, plan,
                              sh.nx * sh.ny)
        err = slope_errors(res, truth, sh)
        if not float(np.abs(err).max()) < SLOPE_ATOL:
            raise SystemExit(f"mg field band {band}: az slope off the "
                             f"injected one by {float(np.abs(err).max())}")
        if stage_log.seconds("plan_build") > 0:
            raise SystemExit(f"mg field band {band} rebuilt the pointing "
                             "plan")
        pat_s = stage_log.seconds("mg_patterns")
        if (band == 0) != (pat_s > 0):
            raise SystemExit(f"mg field band {band}: multigrid patterns "
                             f"{'not ' if band == 0 else ''}built")
        build_s = stage_log.seconds("mg_build")
        line = {"band": band, "wall_s": wall, "mg_patterns_s": pat_s,
                "mg_build_s": build_s, "solve_s": wall - pat_s - build_s,
                "data_gen_s": gen_s, "cg_iters": k_it,
                "residual": float(res.residual),
                "diverged": int(res.diverged), "re_solved": re_solved,
                "residual_trajectory": residual_trajectory(res),
                "twolevel_residual": twolevel_bands[band]["residual"],
                "twolevel_residual_trajectory":
                    twolevel_bands[band]["residual_trajectory"],
                "twolevel_cg_iters": twolevel_bands[band]["cg_iters"],
                "slope_err_max": float(np.abs(err).max()),
                "map_hit_fraction": cover, "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log("mg_field_band", json.dumps(line))
        bands.append(line)
    return bands, total, keep


#: phase B's matched-1/f bands (cut from four to two, as phase A's: the
#: multi-RHS solve and phase D's joint route run the same code on two)
FIELD_B_BANDS = 2


def phase_field_banded(geo, plan, stage_log):
    """Phase B: the first ``FIELD_B_BANDS`` matched-1/f bands of the full
    field, offsets only. Band 0 through ``solve_band`` with the multigrid
    V-cycle and the banded noise prior (bandwidth 4): its fallback
    warning must name exactly the two planted groups. Then the bands as
    one multi-RHS ``destripe_planned`` with ``stack_multigrid`` and
    ``stack_banded``, the joint route's sequence. Checks finite products, no divergence,
    hit coverage and the K3 launches :func:`k3_launches` derives (the
    offsets-only solve launches no K4)."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import (_mg_patterns,
                                                         solve_band)
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, MG_KW,
                                                OFFSET_LENGTH, field_groups,
                                                make_field_band_1f)
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.mapmaking.destriper import (
        build_multigrid_hierarchy, destripe_planned, stack_multigrid)
    from comapreduce_tpu_torch.mapmaking.noise_weight import (
        build_banded_weight, stack_banded)

    sh = FIELD_FULL
    L = OFFSET_LENGTH
    npix = sh.nx * sh.ny
    nw = {"bandwidth": 4}
    t0 = time.perf_counter()
    bands = [make_field_band_1f(sh, geo, b) for b in range(FIELD_B_BANDS)]
    gen_s = time.perf_counter() - t0

    def map_rms_err(m, sky, hit):
        d = m[hit] - sky[hit]
        return float(np.sqrt(np.mean((d - d.mean()) ** 2)))

    def k3_check(label, k_it):
        want = k3_launches(k_it, ground=False, nu=MG_KW["smooth"])
        if binned_window_sum.launches != want:
            raise SystemExit(f"{label} launched binned_window_sum "
                             f"{binned_window_sum.launches} times, not "
                             f"{want}")
        if windowed_gather.launches:
            raise SystemExit(f"{label} launched windowed_gather")

    # band 0 through the band solve
    data0, truth0, quality0 = bands[0]
    stage_log.clear()
    binned_window_sum.launches = windowed_gather.launches = 0
    t1 = _synced()
    res0 = solve_band(data0, offset_length=L, n_iter=100, threshold=1e-6,
                      mg=MG_KW, noise_weight=nw, quality=quality0, band=0)
    wall0 = _synced() - t1
    groups = field_groups(sh)
    planted = [groups[1], groups[sh.n_groups - 2]]
    want_msg = (f"2 group(s) kept white weighting ({planted[0]['file']}/"
                f"feed{planted[0]['feed']}:absent, {planted[1]['file']}/"
                f"feed{planted[1]['feed']}:flagged)")
    if not any(want_msg in w for w in stage_log.warnings):
        raise SystemExit(f"banded band 0: no warning naming the planted "
                         f"fallbacks ({want_msg}); warnings: "
                         f"{stage_log.warnings}")
    if any("re-solving" in w for w in stage_log.warnings):
        raise SystemExit("banded band 0 diverged and was re-solved")
    k3_check("banded band 0", int(res0.n_iter))
    cover = _field_checks("banded band 0", res0, plan, npix)
    if stage_log.seconds("mg_patterns") > 0 or stage_log.seconds(
            "plan_build") > 0:
        raise SystemExit("banded band 0 rebuilt a memoised stage")
    hit = res0.hit_map.cpu().numpy() > 0
    band0 = {"wall_s": wall0, "mg_build_s": stage_log.seconds("mg_build"),
             "cg_iters": int(res0.n_iter), "residual": float(res0.residual),
             "diverged": int(res0.diverged), "map_hit_fraction": cover,
             "map_rms_err": map_rms_err(res0.destriped_map.cpu().numpy(),
                                        truth0["sky"], hit),
             "launches": binned_window_sum.launches,
             "fallback_warning": want_msg}
    log("banded_band0", json.dumps(band0))

    # the bands as one multi-RHS solve
    pix = geo[0]
    n = (pix.size // L) * L
    t2 = time.perf_counter()
    pats = _mg_patterns(pix[:n], npix, L, MG_KW["block"], MG_KW["levels"])
    mg = stack_multigrid([build_multigrid_hierarchy(
        pix[:n], d.weights[:n], npix, L, patterns=pats)
        for d, _, _ in bands])
    banded = stack_banded([build_banded_weight(
        d.groups, q, n // L, L, band=b, bandwidth=nw["bandwidth"])[0]
        for b, (d, _, q) in enumerate(bands)])
    build_s = time.perf_counter() - t2
    tod = torch.as_tensor(np.stack([d.tod[:n] for d, _, _ in bands]),
                          device="cuda")
    w = torch.as_tensor(np.stack([d.weights[:n] for d, _, _ in bands]),
                        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    binned_window_sum.launches = windowed_gather.launches = 0
    t3 = _synced()
    res = destripe_planned(tod, w, plan, n_iter=100, threshold=1e-6, mg=mg,
                           mg_smooth=MG_KW["smooth"], banded=banded)
    solve_s = _synced() - t3
    k3_check("joint banded solve", int(res.n_iter))
    cover = _field_checks("joint banded solve", res, plan, npix)
    div = res.diverged.cpu().numpy()
    if div.any():
        raise SystemExit(f"joint banded solve diverged: {div.tolist()}")
    hit = res.hit_map.cpu().numpy() > 0
    maps = res.destriped_map.cpu().numpy()
    joint = {"data_gen_s": gen_s, "host_build_s": build_s,
             "solve_s": solve_s, "cg_iters": int(res.n_iter),
             "residual": [float(r) for r in res.residual.cpu()],
             "diverged": div.tolist(), "map_hit_fraction": cover,
             "map_rms_err": [map_rms_err(maps[b], bands[b][1]["sky"], hit)
                             for b in range(len(bands))],
             "launches": binned_window_sum.launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("banded_joint", json.dumps(joint))
    return {"band0": band0, "joint": joint}, bands, res


def _telemetry_chunks(log_dir: str) -> list:
    """The ``destriper.cg_chunk`` spans the checkpointed solve wrote to the
    telemetry stream under ``log_dir``: ``(iters, n_done, residual)``."""
    from comapreduce_tpu_torch.telemetry.core import TELEMETRY

    TELEMETRY.flush()
    out = []
    with open(os.path.join(log_dir, "events.rank0.jsonl")) as fh:
        for line in fh:
            ev = json.loads(line)
            if ev.get("kind") == "span" and ev["name"] == "destriper.cg_chunk":
                a = ev["attrs"]
                out.append((int(a["iters"]), int(a["n_done"]),
                            float(a["residual"])))
    return out


def phase_joint_products(stage_log, bands, hand):
    """Phase D: the map-maker's path below the reader on phase B's
    matched-1/f bands (``FIELD_B_BANDS``) at full width, through the
    port's entry points.

    1. ``solve_bands_joint`` (``MG_KW``, banded prior of bandwidth 4, 100
       iterations, threshold 1e-6) with the field's WCS attached: K3
       launches equal to :func:`k3_launches` and none of K4, no
       divergence, the memoised plan and multigrid patterns reused, and
       the maps (mean-removed on hit pixels) and iteration count against
       phase B's hand-written joint solve ``hand`` (FIELD_ATOL of scale,
       3 iterations: the two solves sum in other orders). The solve
       wall is the one the watchdog recorded (synchronised), beside the
       host build wall and the peak device memory.
    2. ``write_band_map`` of the bands' WCS products into
       ``chiprun_out/maps/``, read back with ``read_fits_image``: one
       file of four 480 x 480 HDUs a band, bitwise equal to the result arrays and the WCS's
       header cards (at the 12 significant digits a card carries).
    3. ``solve_band(watchdog=)`` on band 0, under a generous budget (no
       warning, the hard deadline not expired, the recorded wall covering
       the synchronised solve) and under a hard budget of half that wall
       (the "blew its wall budget" warning naming ``band0``).
    4. ``solve_band_checkpointed`` on band 0 (``MG_KW``, banded,
       ``checkpoint_every`` CHECKPOINT_EVERY): once uninterrupted, then a
       run of one chunk (the uninterrupted run must take more)
       whose state is saved with ``save_solver_checkpoint`` and resumed
       by the 100-iteration solve. The resumed run must run only the
       chunks after that point (its K3 launches those chunks'
       :func:`k3_launches` plus the two of each warm start), report the
       uninterrupted run's cumulative ``n_iter`` and match its offsets
       (mean-removed) within FIELD_ATOL of scale, and leave no snapshot.
       The chunks are read back from the telemetry stream.
    5. Band 0 pixelised onto HEALPix (the WCS pixel centres through
       ``ang2pix_lonlat`` at the nside whose resolution is nearest the
       field's pixel), compacted with ``PixelSpace.from_pixels``, solved
       with ``solve_band`` and written as a partial map, read back with
       ``PIXELS`` equal to the dictionary and the products bitwise."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import (
        checkpoint_id, solve_band, solve_band_checkpointed,
        solve_bands_joint, write_band_map)
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, MG_KW,
                                                OFFSET_LENGTH, field_wcs)
    from comapreduce_tpu_torch.mapmaking import healpix as hp
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.mapmaking.destriper import (
        load_solver_checkpoint, save_solver_checkpoint)
    from comapreduce_tpu_torch.mapmaking.fits_io import (read_fits_image,
                                                         read_healpix_map)
    from comapreduce_tpu_torch.mapmaking.leveldata import DestriperData
    from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace
    from comapreduce_tpu_torch.resilience.watchdog import (Watchdog,
                                                           parse_deadlines)
    from comapreduce_tpu_torch.telemetry.core import TELEMETRY

    sh = FIELD_FULL
    L = OFFSET_LENGTH
    npix = sh.nx * sh.ny
    nw = {"bandwidth": 4}
    datas = [d for d, _, _ in bands]
    quality = [r for _, _, q in bands for r in q]
    wcs = field_wcs(sh)
    for d in datas:
        d.wcs = wcs
    out_dir = os.path.join(ROOT, "chiprun_out")

    def k3_want(chunks):
        # chunks: (iterations, warm start) of each destripe_planned call;
        # a warm start adds one matvec (2 K3 launches) for b - A x0
        return sum(k3_launches(k, ground=False, nu=MG_KW["smooth"])
                   + (2 if warm else 0) for k, warm in chunks)

    def hit_mean_removed(m, hit):
        v = np.asarray(m, np.float64)[hit]
        return v - v.mean()

    # 1. the joint entry point
    wd = Watchdog(deadlines=parse_deadlines("mapmaking.cg_solve=600/1200"))
    stage_log.clear()
    torch.cuda.reset_peak_memory_stats()
    binned_window_sum.launches = windowed_gather.launches = 0
    t0 = _synced()
    res = solve_bands_joint(datas, list(range(len(datas))), offset_length=L,
                            n_iter=100, threshold=1e-6, mg=MG_KW,
                            noise_weight=nw, quality=quality, watchdog=wd)
    wall = _synced() - t0
    if res is None:
        raise SystemExit("joint route: the bands' streams differ")
    k_it = int(res[0].n_iter)
    if binned_window_sum.launches != k3_want([(k_it, False)]) \
            or windowed_gather.launches:
        raise SystemExit(f"joint route launched K3 "
                         f"{binned_window_sum.launches} times (want "
                         f"{k3_want([(k_it, False)])}) and K4 "
                         f"{windowed_gather.launches} times (want 0)")
    if stage_log.seconds("plan_build") or stage_log.seconds("mg_patterns"):
        raise SystemExit("joint route rebuilt the memoised plan or patterns")
    if any(int(r.diverged) for r in res) or any(
            "diverged" in w for w in stage_log.warnings):
        raise SystemExit("joint route diverged")
    hit = hand.hit_map.cpu().numpy() > 0
    hand_maps = hand.destriped_map.cpu().numpy()
    map_diff = []
    for b, r in enumerate(res):
        if not (np.isfinite(r.destriped_map).all()
                and np.isfinite(r.naive_map).all()):
            raise SystemExit(f"joint route band {b}: non-finite maps")
        if not np.array_equal(r.hit_map > 0, hit):
            raise SystemExit(f"joint route band {b}: hit pixels differ "
                             f"from phase B's")
        want = hit_mean_removed(hand_maps[b], hit)
        scale = max(float(want.std()), 1.0)
        d = float(np.abs(hit_mean_removed(r.destriped_map, hit)
                         - want).max())
        if not d <= FIELD_ATOL * scale:
            raise SystemExit(f"joint route band {b}: map differs from "
                             f"phase B's by {d} > {FIELD_ATOL * scale}")
        map_diff.append(d / scale)
    if abs(k_it - int(hand.n_iter)) > 3:
        raise SystemExit(f"joint route took {k_it} iterations, phase B "
                         f"{int(hand.n_iter)}")
    solve_s = wd.history["mapmaking.cg_solve"][-1]
    host_s = stage_log.seconds("mg_build")
    joint = {"wall_s": wall, "solve_s": solve_s, "mg_build_s": host_s,
             "other_host_s": wall - solve_s - host_s, "cg_iters": k_it,
             "hand_cg_iters": int(hand.n_iter),
             "residual": [float(r.residual) for r in res],
             "map_diff_vs_hand_of_scale": map_diff,
             "launches": binned_window_sum.launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("joint_route", json.dumps(joint))

    # 2. the WCS writers
    map_dir = os.path.join(out_dir, "maps")
    os.makedirs(map_dir, exist_ok=True)
    cards = {k: float(f"{v:.12G}") if isinstance(v, float) else v
             for k, v in wcs.header_cards().items()}
    t1 = time.perf_counter()
    paths = []
    for b, (d, r) in enumerate(zip(datas, res)):
        paths.append(os.path.join(map_dir, f"band{b}.fits"))
        write_band_map(paths[-1], d, r)
    write_s = time.perf_counter() - t1
    for b, (path, r) in enumerate(zip(paths, res)):
        hdus = read_fits_image(path)
        want = {"DESTRIPED": r.destriped_map, "NAIVE": r.naive_map,
                "WEIGHTS": r.weight_map, "HITS": r.hit_map}
        if [h[0] for h in hdus] != list(want):
            raise SystemExit(f"{path}: HDUs {[h[0] for h in hdus]}")
        for name, hdr, data in hdus:
            if data.shape != (sh.ny, sh.nx) or not np.array_equal(
                    data, np.asarray(want[name], np.float32).reshape(
                        sh.ny, sh.nx)):
                raise SystemExit(f"{path}: {name} does not read back")
            if {k: hdr.get(k) for k in cards} != cards:
                raise SystemExit(f"{path}: {name} header cards "
                                 f"{ {k: hdr.get(k) for k in cards} }")
    writers = {"wcs_write_s": write_s, "files": [os.path.relpath(p, ROOT)
                                                 for p in paths],
               "bytes": [os.path.getsize(p) for p in paths]}
    del res
    log("joint_writers", json.dumps(writers))

    # 3. the deadline
    data0, _, quality0 = bands[0]
    solve0 = dict(offset_length=L, n_iter=100, threshold=1e-6, mg=MG_KW,
                  noise_weight=nw, quality=quality0, band=0, unit="band0")
    stage_log.clear()
    wd = Watchdog(deadlines=parse_deadlines("mapmaking.cg_solve=600/1200"))
    t2 = _synced()
    solve_band(data0, watchdog=wd, **solve0)
    synced_s = _synced() - t2
    generous_s = wd.history["mapmaking.cg_solve"][-1]
    if any("blew its wall budget" in w for w in stage_log.warnings) \
            or wd.events or not generous_s >= 0.95 * synced_s:
        raise SystemExit(f"deadline, generous budget: warnings "
                         f"{stage_log.warnings}, events {wd.events}, "
                         f"watched {generous_s} s of {synced_s} s")
    hard = 0.5 * generous_s
    stage_log.clear()
    wd = Watchdog(deadlines=parse_deadlines(f"mapmaking.cg_solve=/{hard}"))
    solve_band(data0, watchdog=wd, **solve0)
    late = [w for w in stage_log.warnings if "blew its wall budget" in w]
    if not (late and "band0" in late[0]):
        raise SystemExit(f"deadline: a {hard:.3f} s hard budget on a "
                         f"{generous_s:.3f} s solve gave no warning naming "
                         f"band0 — the watch closed before the card "
                         f"finished; warnings: {stage_log.warnings}")
    deadline = {"generous_watched_s": generous_s, "synced_wall_s": synced_s,
                "hard_budget_s": hard, "warning": late[0],
                "events": [list(e) for e in wd.events]}
    log("deadline", json.dumps(deadline))

    # 4. the checkpoint
    ck_dir = os.path.join(out_dir, "checkpoint")
    tel_dir = os.path.join(out_dir, "telemetry")
    os.makedirs(ck_dir, exist_ok=True)
    ck = dict(offset_length=L, threshold=1e-6, mg=MG_KW, noise_weight=nw,
              quality=quality0, band=0, unit="band0")
    TELEMETRY.configure(tel_dir, rank=0)
    try:
        n0 = len(_telemetry_chunks(tel_dir))
        path = os.path.join(ck_dir, "full.npz")
        binned_window_sum.launches = 0
        t3 = _synced()
        full = solve_band_checkpointed(data0, path, CHECKPOINT_EVERY,
                                       n_iter=100, **ck)
        full_s = _synced() - t3
        chunks = _telemetry_chunks(tel_dir)[n0:]
        if binned_window_sum.launches != k3_want(
                [(k, i > 0) for i, (k, _, _) in enumerate(chunks)]):
            raise SystemExit(f"checkpointed run launched K3 "
                             f"{binned_window_sum.launches} times for "
                             f"chunks {chunks}")
        # the snapshot is left after the first chunk
        split = CHECKPOINT_EVERY
        if int(full.n_iter) <= split:
            raise SystemExit(f"checkpointed run converged in "
                             f"{int(full.n_iter)} iterations: no chunk is "
                             f"left to resume")
        path = os.path.join(ck_dir, "resume.npz")
        n1 = len(_telemetry_chunks(tel_dir))
        half = solve_band_checkpointed(data0, path, CHECKPOINT_EVERY,
                                       n_iter=split, **ck)
        residuals = [c[2] for c in _telemetry_chunks(tel_dir)[n1:]]
        pid = checkpoint_id(data0, L, 1e-6, mg=MG_KW, noise_weight=nw)
        t4 = time.perf_counter()
        save_solver_checkpoint(path, half.offsets, int(half.n_iter),
                               residuals, pid)
        save_s = time.perf_counter() - t4
        t5 = time.perf_counter()
        snap = load_solver_checkpoint(path, precond_id=pid)
        load_s = time.perf_counter() - t5
        if snap is None or snap["n_done"] != split:
            raise SystemExit(f"checkpoint: the {split}-iteration snapshot "
                             f"did not load ({snap})")
        n2 = len(_telemetry_chunks(tel_dir))
        binned_window_sum.launches = windowed_gather.launches = 0
        t6 = _synced()
        resumed = solve_band_checkpointed(data0, path, CHECKPOINT_EVERY,
                                          n_iter=100, **ck)
        resumed_s = _synced() - t6
        rchunks = _telemetry_chunks(tel_dir)[n2:]
    finally:
        TELEMETRY.close()
    want_chunks = [c for c in chunks if c[1] > split]
    if [c[1] for c in rchunks] != [c[1] for c in want_chunks] \
            or binned_window_sum.launches != k3_want(
                [(k, True) for k, _, _ in rchunks]):
        raise SystemExit(f"resumed run: chunks {rchunks} (want those of "
                         f"{want_chunks}), K3 launched "
                         f"{binned_window_sum.launches} times")
    if int(resumed.n_iter) != int(full.n_iter):
        raise SystemExit(f"resumed run reports {int(resumed.n_iter)} "
                         f"iterations, the uninterrupted {int(full.n_iter)}")
    a = full.offsets.cpu().numpy().astype(np.float64)
    b = resumed.offsets.cpu().numpy().astype(np.float64)
    a, b = a - a.mean(), b - b.mean()
    scale = max(float(np.abs(a).max()), 1e-6)
    off_diff = float(np.abs(a - b).max())
    if not off_diff <= FIELD_ATOL * scale:
        raise SystemExit(f"resumed offsets differ by {off_diff} > "
                         f"{FIELD_ATOL * scale}")
    left = [f for f in os.listdir(ck_dir) if f.endswith(".npz")]
    if left:
        raise SystemExit(f"checkpoint: snapshots left behind: {left}")
    checkpoint = {"split": split, "chunks": chunks,
                  "resumed_chunks": rchunks,
                  "cg_iters": int(full.n_iter),
                  "residual": float(full.residual),
                  "uninterrupted_wall_s": full_s,
                  "resumed_wall_s": resumed_s,
                  "resumed_k3_launches": binned_window_sum.launches,
                  "snapshot_save_s": save_s, "snapshot_load_s": load_s,
                  "offsets_diff_of_scale": off_diff / scale}
    log("checkpoint", json.dumps(checkpoint))

    # 5. band 0 on a compacted HEALPix space
    cdelt = abs(wcs.cdelt[1]) * np.pi / 180.0
    nside = min((2 ** k for k in range(4, 14)),
                key=lambda ns: abs(hp.nside2resol(ns) - cdelt))
    lon, lat = wcs.pixel_centers()
    raster = hp.ang2pix_lonlat(nside, lon.ravel(), lat.ravel())
    space = PixelSpace.from_pixels(raster[data0.pixels],
                                   hp.nside2npix(nside))
    data_hp = DestriperData(
        tod=data0.tod, pixels=space.remap(raster[data0.pixels]).astype(
            np.int32), weights=data0.weights, ground_ids=data0.ground_ids,
        az=data0.az, n_groups=data0.n_groups, npix=space.n_compact,
        nside=nside, pixel_space=space, groups=data0.groups)
    t7 = _synced()
    res_hp = solve_band(data_hp, **solve0)
    hp_solve_s = _synced() - t7
    if int(res_hp.diverged) or not bool(
            torch.isfinite(res_hp.destriped_map).all()):
        raise SystemExit("HEALPix band 0: diverged or non-finite")
    hp_path = os.path.join(map_dir, "band0_healpix.fits")
    t8 = time.perf_counter()
    write_band_map(hp_path, data_hp, res_hp)
    hp_write_s = time.perf_counter() - t8
    maps, pixels, nside_back, nest = read_healpix_map(hp_path)
    if nside_back != nside or nest or not np.array_equal(pixels,
                                                         space.pixels):
        raise SystemExit(f"{hp_path}: PIXELS or nside do not read back")
    for name, field in (("DESTRIPED", "destriped_map"),
                        ("NAIVE", "naive_map"), ("WEIGHTS", "weight_map"),
                        ("HITS", "hit_map")):
        if not np.array_equal(maps[name],
                              getattr(res_hp, field).cpu().numpy()):
            raise SystemExit(f"{hp_path}: {name} does not read back")
    healpix = {"nside": nside, "resol_arcmin": hp.nside2resol(nside)
               * 180 / np.pi * 60, "n_compact": space.n_compact,
               "cg_iters": int(res_hp.n_iter),
               "residual": float(res_hp.residual),
               "solve_wall_s": hp_solve_s, "write_s": hp_write_s,
               "bytes": os.path.getsize(hp_path)}
    log("healpix_band0", json.dumps(healpix))
    return {"joint": joint, "writers": writers, "deadline": deadline,
            "checkpoint": checkpoint, "healpix": healpix}


# ---------------------------------------------------------------------------
# Phase E: the Level-1 -> Level-2 stage chain of the shipped configuration
# ---------------------------------------------------------------------------

SHIPPED_CONFIG = os.path.join("examples", "configs", "configuration.toml")

# How two Level-2 stores of one observation are held to each other, the
# port against the reference on the CPU (tests/test_torch_stages.py,
# tests/test_torch_runner.py) and the card against the CPU (phase E):
# - spectrometer/*, scan edges and every integer dataset: equal (copied
#   or computed on the host);
# - vane/*: rtol 2e-5 plus 1e-6 of scale, the reference's vane tolerance
#   (tests/test_torch_reduce.py; measured 3.5e-7 of scale);
# - atmosphere/fit_values: the fitted model offset + slope * airmass at
#   each scan's lowest and highest airmass within 2e-4 of scale, the
#   pre-filter's tolerance in tests/test_torch_reduce.py (measured 0 on
#   the CPU). The coefficients themselves are not compared: at constant
#   elevation (the synthetic observation's) the airmass variance is f32
#   round-off, so the slope is round-off too (~1e7, ROADMAP §3) and the
#   card's summation order moves it by more than its own size, while the
#   model stays right;
# - averaged_tod/* and */auto_rms: TOD_RTOL (2e-3) of scale, the chain's
#   tolerance (the gain solve's zpp conditioning; measured 1.2e-4);
# - spikes/spike_mask: at most SPIKE_FLIP_FRACTION of samples differ: a
#   sample whose high-passed value lies within f32 rounding of 10 rms may
#   flag in one run and not the other, and each flag widens to 2 pad + 1
#   samples (measured: equal);
# - */fnoise_fit_parameters: the same NaN pattern, and the fitted models
#   (not the parameters) agree at every log bin the fit used to within
#   that bin's own standard error, 1/sqrt(k) relative for a mean of k
#   exponentially distributed PSD samples: two fits that close are fits
#   the data cannot tell apart. On white data (the synthetic
#   observation's averaged TOD) the 1/f parameters are degenerate: inputs
#   1e-5 apart send the f32 LM paths to different minima of one flat
#   surface, sigma^2 up to 20x apart, and the models differ by up to
#   0.43 of a standard error (measured on the CPU, port against the
#   reference, on the reference pipeline test's observation at seed 8,
#   where the reference's knee fit tilts across the band and the port's
#   is flat; 0.02 at seed 7).
VANE_RTOL = 2e-5
ATMOS_RTOL = 2e-4
SPIKE_FLIP_FRACTION = 1e-3
NOISE_BIN_SIGMAS = 1.0
# check_level2(fit_loss=...): a noise fit past NOISE_BIN_SIGMAS on a scan
# whose ``want`` fit is degenerate passes when the models lie within
# DEGENERATE_FIT_SIGMAS standard errors (measured 2.7) and its log-chi^2
# is within FIT_LOSS_RTOL of the other fit's or lower
DEGENERATE_FIT_SIGMAS = 3.0
FIT_LOSS_RTOL = 1e-3
# the shipped config's fit binning and the stage's scan-length buckets
NOISE_NBINS = 12
NOISE_QUANTUM = 128
NOISE_MAX_BUCKETS = 16


def atmosphere_model(fit_values, el, edges):
    """The fitted atmosphere model ``offset + slope * airmass`` at each
    scan's lowest and highest airmass, f64[S, F, B, 2, C], from
    ``atmosphere/fit_values`` (S, F, B, 2, C), the pointing's elevation
    (F, T) in degrees and the scan edges."""
    fv = np.asarray(fit_values, np.float64)
    am = 1.0 / np.sin(np.radians(np.asarray(el, np.float64)))
    ends = np.stack([np.stack([am[:, s:e].min(axis=1), am[:, s:e].max(axis=1)],
                              axis=-1) for s, e in np.asarray(edges)])
    # (S, F, 2) airmass ends -> (S, F, 1, 2, 1) against (S, F, B, 1, C)
    return fv[..., 0:1, :] + fv[..., 1:2, :] * ends[:, :, None, :, None]


def noise_bins(lq: int, nbins: int = NOISE_NBINS, fs: float = 50.0):
    """Centre frequencies and sample counts of the non-empty log bins a
    fit over ``lq`` samples uses (``ops/power.log_bin_psd``'s binning, in
    numpy)."""
    freqs = np.fft.rfftfreq(lq, d=1.0 / fs).astype(np.float32)
    lo, hi = np.log10(freqs[1]), np.log10(freqs[-1])
    step = np.arange(nbins, dtype=np.float32) / nbins
    edges = 10.0 ** np.append(lo * (1 - step) + hi * step, hi)
    ids = np.clip(np.searchsorted(edges, freqs, side="right") - 1, 0,
                  nbins - 1)
    valid = freqs >= freqs[1]
    k = np.bincount(ids, weights=valid, minlength=nbins)
    nu = np.bincount(ids, weights=freqs * valid, minlength=nbins)
    keep = k > 0
    return nu[keep] / k[keep], k[keep]


def noise_model(params, nu, knee: bool):
    """The fitted noise model of ``params`` (..., 3) at ``nu``, f64."""
    p = np.asarray(params, np.float64)
    s, b, a = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    if knee:
        return s * (1.0 + np.abs(nu / b) ** a)
    return s + b * np.abs(nu) ** a


def noise_fit_measure(got, want, knee: bool, edges) -> float:
    """How far two noise fits (F, B, S, 3) lie apart, in units of their
    limit (1 = at it): max |m_got / m_want - 1| sqrt(k) / NOISE_BIN_SIGMAS
    over each scan's log bins of k samples."""
    from comapreduce_tpu_torch.pipeline.stages import bucket_scan_lengths

    worst = 0.0
    for lq, sids in bucket_scan_lengths(edges, NOISE_QUANTUM,
                                        NOISE_MAX_BUCKETS).items():
        nu, k = noise_bins(lq)
        for si in sids:
            ok = ~np.isnan(want[..., si, 0])
            mg = noise_model(got[..., si, :][ok], nu, knee)
            mw = noise_model(want[..., si, :][ok], nu, knee)
            rel = np.abs(mg / mw - 1.0) * np.sqrt(k) / NOISE_BIN_SIGMAS
            worst = max(worst, float(rel.max(initial=0.0)))
    return worst


def level2_diffs(got, want) -> dict:
    """Compare two Level-2 stores dataset by dataset under the rules
    above. Returns ``{name: (measure, limit)}`` for every dataset of
    ``want``; a dataset missing from ``got`` or with another shape or
    dtype raises."""
    out = {}
    for name in sorted(want.keys()):
        b = np.asarray(want[name])
        if name not in got:
            raise KeyError(f"{name} missing")
        a = np.asarray(got[name])
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
        if name == "spikes/spike_mask":
            out[name] = (float((a != b).mean()), SPIKE_FLIP_FRACTION)
        elif b.dtype.kind != "f" or name.startswith("spectrometer/"):
            same = np.array_equal(a, b, equal_nan=b.dtype.kind == "f")
            out[name] = (0.0 if same else 1.0, 0.0)
        elif name.startswith("vane/"):
            d = np.abs(a - b) - VANE_RTOL * np.abs(b)
            out[name] = (float(d.max() / max(np.abs(b).max(), 1e-30)),
                         1e-6)
        elif name == "atmosphere/fit_values":
            el = want.get("spectrometer/pixel_pointing/pixel_el")
            edges = want.get("averaged_tod/scan_edges")
            if el is not None and edges is not None:
                a = atmosphere_model(a, el, edges)
                b = atmosphere_model(b, el, edges)
            out[name] = (float(np.abs(a - b).max()
                               / max(np.abs(b).max(), 1e-30)), ATMOS_RTOL)
        elif name.endswith("fnoise_fit_parameters"):
            edges = want.get("averaged_tod/scan_edges")
            if not np.array_equal(np.isnan(a), np.isnan(b)) or \
                    edges is None:
                out[name] = (np.inf, 1.0)
                continue
            out[name] = (noise_fit_measure(
                a, b, name.startswith("noise_statistics"), edges), 1.0)
        else:
            ok = ~np.isnan(b)
            if not np.array_equal(np.isnan(a), ~ok):
                out[name] = (np.inf, TOD_RTOL)
                continue
            out[name] = (float(np.abs(a[ok] - b[ok]).max(initial=0.0)
                               / max(np.abs(b[ok]).max(initial=0.0),
                                     1e-30)), TOD_RTOL)
    return out


def check_level2(got, want, label: str, fit_loss=None) -> dict:
    """:func:`level2_diffs`, raising on the first dataset past its limit.

    ``fit_loss(store, params, knee)``, f64[F, B, S]: the log-chi^2 the
    noise-fit stages minimise, of ``params`` on ``store``'s averaged TOD
    (:func:`noise_fit_losses` is the port's). When given, a noise-fit
    dataset past its limit still passes when every scan past it
    (:func:`noise_fit_rows`) is one whose ``want`` fit leaves its 1/f
    part unmeasured (:func:`noise_fit_degenerate`), lies within
    DEGENERATE_FIT_SIGMAS of ``want``'s model, and is fitted by ``got``'s
    parameters at least as well as by ``want``'s, both judged by
    ``fit_loss`` on ``want``'s TOD (within FIT_LOSS_RTOL). On such a scan
    two fits of one PSD that differ only in summation order end in
    different basins of a flat surface: measured on the CPU, port
    against the reference, a filled NaN burst's knee fit (the reference's
    knee at 1.7e-14 Hz, below the band) at a log-chi^2 of 153.5 against
    177.1, the models 2.7 standard errors apart, and a white scan's
    red-noise fit (the reference's red term under 1e-6 of the white) at
    8.86 against 10.46, 1.06 apart.
    """
    diffs = level2_diffs(got, want)
    bad = {k: v for k, v in diffs.items() if not v[0] <= v[1]}
    if fit_loss is not None:
        for name in [k for k in bad if k.endswith("fnoise_fit_parameters")
                     and bad[k][0] <= DEGENERATE_FIT_SIGMAS]:
            knee = name.startswith("noise_statistics")
            a, b = np.asarray(got[name]), np.asarray(want[name])
            edges = want["averaged_tod/scan_edges"]
            far = np.argwhere(noise_fit_rows(a, b, knee, edges) > 1.0)
            flat = noise_fit_degenerate(b, knee, edges)
            la = fit_loss(want, a, knee)
            lb = fit_loss(want, b, knee)
            worse = [tuple(int(i) for i in r) for r in far
                     if not (flat[tuple(r)] and la[tuple(r)] <=
                             lb[tuple(r)] * (1 + FIT_LOSS_RTOL))]
            if not worse:
                del bad[name]
    if bad:
        raise AssertionError(f"{label}: Level-2 datasets past their limits "
                             f"(measure, limit): {bad}")
    return {k: v[0] for k, v in diffs.items()}


# FitSource's fits and ApplyCalibration's factors, one run against another
# (card against CPU, or the port against the reference). The fits start
# at the moment guess, where a circular beam leaves theta undetermined
# (sx == sy), so the LM path rests on rounding and a run may stop at
# another point of a flat valley (measured on the CPU, port against
# reference on the reference test's TauA observation with two feeds: on
# feed 0 band 0 the reference stops at a chi2 1.3% above the port's, theta
# 1.05 against 1.36 rad, the amplitude 0.17% apart; the other maps agree
# to 1e-5). So the fits are held through the model they give, on the
# source's own grid of +-3 beam sigmas: within FIT_MODEL_RTOL of the peak
# (measured 1.5e-2: the two thetas of a beam 6% elongated), the flux
# they give through the factors, positions within FIT_POS_ATOL deg
# (1.4e-4), chi2
# within FIT_CHI2_RTOL (1.3e-2), errors but theta's within FIT_ERR_RTOL
# (5.0e-2), factors within FACTOR_RTOL (2.0e-3); calibration_good and
# the attributes exact
FIT_MODEL_RTOL = 3e-2
FIT_POS_ATOL = 5e-4
FIT_CHI2_RTOL = 2e-2
FIT_ERR_RTOL = 0.1
FACTOR_RTOL = 3e-3


def gauss_model_np(p, x, y):
    """``gauss2d_rot`` in f64 numpy: p[..., 7] over x, y[m]."""
    A, x0, sx, y0, sy, th, off = (p[..., i, None] for i in range(7))
    ct, st = np.cos(th), np.sin(th)
    xp = (x - x0) * ct + (y - y0) * st
    yp = -(x - x0) * st + (y - y0) * ct
    return A * np.exp(-0.5 * ((xp / sx) ** 2 + (yp / sy) ** 2)) + off


def calibration_diffs(got, want, beam_fwhm_deg: float = 0.075) -> dict:
    """Every ``*_source_fit`` and ``astro_calibration`` dataset and
    attribute of ``want`` against ``got``'s: ``{name: (measure, limit)}``
    under the limits above. A dataset missing from ``got`` raises."""
    out = {}
    groups = sorted({k.split("/")[0] for k in want.keys()
                     if k.endswith("_source_fit/fits")
                     or k.startswith("astro_calibration/")})
    for g in groups:
        for key, value in want.attrs(g).items():
            same = got.attrs(g).get(key) == value
            out[f"{g}@{key}"] = (0.0 if same else 1.0, 0.0)
    sig = beam_fwhm_deg / 2.355
    grid = np.linspace(-3 * sig, 3 * sig, 41)
    gx, gy = (v.ravel() for v in np.meshgrid(grid, grid))
    for name in sorted(k for k in want.keys() if k.split("/")[0] in groups):
        a = np.asarray(got[name], np.float64)
        b = np.asarray(want[name], np.float64)
        if a.shape != b.shape:
            raise ValueError(f"{name}: {a.shape} vs {b.shape}")
        if name.endswith("/fits"):
            # each model on the grid about its own fitted centre
            ma = gauss_model_np(a, gx + b[..., 1, None], gy + b[..., 3, None])
            mb = gauss_model_np(b, gx + b[..., 1, None], gy + b[..., 3, None])
            peak = np.abs(b[..., 0, None])
            out[f"{name}[model]"] = (float((np.abs(ma - mb) / peak).max()),
                                     FIT_MODEL_RTOL)
            out[f"{name}[position]"] = (float(np.abs(
                a[..., [1, 3]] - b[..., [1, 3]]).max()), FIT_POS_ATOL)
        elif name.endswith("/errors"):
            keep = [i for i in range(b.shape[-1]) if i != 5]
            ea, eb = a[..., keep], b[..., keep]
            ok = ~np.isnan(eb)
            same_nan = np.array_equal(np.isnan(ea), ~ok)
            out[name] = (float(np.abs(ea[ok] / eb[ok] - 1).max(initial=0))
                         if same_nan else np.inf, FIT_ERR_RTOL)
        elif name.endswith("/chi2"):
            out[name] = (float(np.abs(a / b - 1).max()), FIT_CHI2_RTOL)
        elif name.endswith("calibration_factors"):
            out[name] = (float(np.abs(a / b - 1).max()), FACTOR_RTOL)
        else:
            out[name] = (0.0 if np.array_equal(a, b) else 1.0, 0.0)
    return out


def check_calibration(got, want, label: str) -> dict:
    """:func:`calibration_diffs`, raising on the first past its limit."""
    diffs = calibration_diffs(got, want)
    bad = {k: v for k, v in diffs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"{label}: calibration products past their "
                             f"limits (measure, limit): {bad}")
    return {k: v[0] for k, v in diffs.items()}


def noise_fit_rows(got, want, knee: bool, edges) -> np.ndarray:
    """:func:`noise_fit_measure` per scan: f64[F, B, S] (0 where the
    scan is unfitted)."""
    from comapreduce_tpu_torch.pipeline.stages import bucket_scan_lengths

    out = np.zeros(want.shape[:-1])
    for lq, sids in bucket_scan_lengths(edges, NOISE_QUANTUM,
                                        NOISE_MAX_BUCKETS).items():
        nu, k = noise_bins(lq)
        for si in sids:
            ok = ~np.isnan(want[..., si, 0])
            mg = noise_model(got[..., si, :][ok], nu, knee)
            mw = noise_model(want[..., si, :][ok], nu, knee)
            rel = np.abs(mg / mw - 1.0) * np.sqrt(k) / NOISE_BIN_SIGMAS
            out[..., si][ok] = rel.max(axis=-1)
    return out


def noise_fit_degenerate(params, knee: bool, edges) -> np.ndarray:
    """Which fits (F, B, S, 3) leave their 1/f part unmeasured, bool[F, B,
    S]: a knee model whose knee lies outside the fitted log bins' centre
    frequencies (the data do not bracket it, so the white level trades
    against it), or a red-noise model whose red term stays under one
    standard error of the white at every bin (the red parameters then
    move nothing the data can see)."""
    from comapreduce_tpu_torch.pipeline.stages import bucket_scan_lengths

    p = np.asarray(params, np.float64)
    out = np.zeros(p.shape[:-1], bool)
    for lq, sids in bucket_scan_lengths(edges, NOISE_QUANTUM,
                                        NOISE_MAX_BUCKETS).items():
        nu, k = noise_bins(lq)
        for si in sids:
            s, b, a = (p[..., si, i:i + 1] for i in range(3))
            if knee:
                flat = (b[..., 0] < nu[0]) | (b[..., 0] > nu[-1])
            else:
                red = b * np.abs(nu) ** a / s * np.sqrt(k)
                flat = (red < NOISE_BIN_SIGMAS).all(axis=-1)
            out[..., si] = flat & np.isfinite(s[..., 0])
    return out


def noise_fit_losses(store, params, knee: bool) -> np.ndarray:
    """The log-chi^2 the noise-fit stages minimise, of ``params`` (F, B,
    S, 3) on ``store``'s averaged TOD, f64[F, B, S] (NaN where unfitted):
    the stages' binned PSD (peak-masked, NOISE_NBINS log bins over each
    scan's quantised length), the port's loss, on the CPU."""
    import torch

    from comapreduce_tpu_torch.ops import power
    from comapreduce_tpu_torch.pipeline.stages import bucket_scan_lengths

    tod = np.asarray(store["averaged_tod/tod"], np.float32)
    edges = np.asarray(store["averaged_tod/scan_edges"])
    model = power.knee_model if knee else power.red_noise_model
    loss = power._log_chi2(model)
    out = np.full(params.shape[:-1], np.nan)
    for lq, sids in bucket_scan_lengths(edges, NOISE_QUANTUM,
                                        NOISE_MAX_BUCKETS).items():
        for si in sids:
            x = torch.as_tensor(tod[..., edges[si, 0]:edges[si, 0] + lq])
            freqs, ps = power.psd(x)
            d = x[..., 1:] - x[..., :-1]
            mask = power.psd_peak_mask(freqs, ps, torch.var(
                d, dim=-1, unbiased=False) / 2.0)
            nu, pb, cnt = power.log_bin_psd(freqs, ps, nbins=NOISE_NBINS,
                                            sample_mask=mask)
            good = (cnt > 0) & (pb > 0) & (nu > 0)
            logp = torch.where(good, torch.log(torch.clamp(pb, min=1e-30)),
                               torch.zeros(()))
            wgt = torch.sqrt(cnt) * good
            p = torch.as_tensor(params[..., si, :], dtype=torch.float64)
            q = torch.stack([torch.log(p[..., 0]), torch.log(p[..., 1]),
                             p[..., 2]], -1)
            for idx in np.ndindex(*tod.shape[:-1]):
                if np.isfinite(params[idx + (si, 0)]):
                    out[idx + (si,)] = float(loss(
                        q[idx], nu.double(), logp[idx].double(),
                        wgt[idx].double()))
    return out


def shipped_chain_config(root: str = ROOT) -> dict:
    """The shipped field-reduction config as shipped (its ``[resilience]``
    table, and the reference's defaults for the rest: the quarantine
    ledger, retries, heartbeats, elastic claiming and the quality
    ledger); callers set only paths."""
    from comapreduce_tpu_torch.pipeline import load_toml

    return load_toml(os.path.join(root, SHIPPED_CONFIG))


def pipeline_test_params():
    """The observation of the reference's pipeline test
    (``tests/test_pipeline.py:73-78``)."""
    from comapreduce_tpu_torch.data.synthetic import SyntheticObsParams

    return SyntheticObsParams(n_feeds=2, n_bands=2, n_channels=32,
                              n_scans=3, scan_samples=600, vane_samples=250,
                              seed=7)


def level1_view(store):
    """A :class:`COMAPLevel1` over an in-memory store's arrays."""
    from comapreduce_tpu_torch.data.level import COMAPLevel1

    return COMAPLevel1().adopt_payload({
        "data": dict(store.items()),
        "attrs": {k: dict(v) for k, v in store.attr_items()},
        "source": ""})


def memory_runner(device, config=None, on_stage=None, run_dir=None,
                  level2=None):
    """``Runner.from_config`` on the shipped config whose stage checkpoint
    keeps the Level-2 store in memory (the card's machine has no h5py);
    ``on_stage(lvl2)`` runs where the checkpoint would. The run's outputs
    (the quarantine ledger) go to ``<run_dir>/level2`` and its state
    (heartbeat, leases, queue manifest, quality ledger) to
    ``<run_dir>/logs``, ``run_dir`` defaulting to ``chiprun_out/chain``;
    a config that already names its ``log_dir`` keeps it. Given a dict
    ``level2`` (Level-2 path -> store), each file's checkpoint is the
    store there, made empty on first use, so a later pass of the same
    runner or of its ``run_astro_cal`` finds it (as it would the file)."""
    from comapreduce_tpu_torch.data.level import COMAPLevel2
    from comapreduce_tpu_torch.pipeline import Runner

    class MemoryRunner(Runner):
        def _checkpoint(self, lvl2):
            if on_stage is not None:
                on_stage(lvl2)

        def _open_level2(self, l2path, filename):
            if level2 is None:
                return super()._open_level2(l2path, filename)
            if l2path not in level2:
                level2[l2path] = COMAPLevel2(filename="")
                level2[l2path].filename = l2path
            return level2[l2path]

    cfg = config or shipped_chain_config()
    run_dir = run_dir or os.path.join(ROOT, "chiprun_out", "chain")
    cfg["Global"]["output_dir"] = os.path.join(run_dir, "level2")
    cfg["Global"].setdefault("log_dir", "logs")
    if not os.path.isabs(cfg["Global"]["log_dir"]):
        cfg["Global"]["log_dir"] = os.path.join(run_dir,
                                                cfg["Global"]["log_dir"])
    return MemoryRunner.from_config(cfg, device=device)


class ServedLevel1:
    """Serves Level-1 stores to the port's ``ingest.loaders.load_level1``
    by file name, for the ``with`` block, so ``Runner.run_tod`` reads from
    memory (the card's machine has no h5py). ``stores`` maps a name to a
    ``COMAPLevel1`` (served as it is: a lazy card-generated TOD stays
    lazy) or to an ``HDF5Store`` (each read gets a fresh
    :func:`level1_view`, so a chaos NaN burst never outlives its read).
    An eager read (``eager_tod``: prefetching or a cache) goes through the
    port's own ``ingest.loaders.eager_payload`` on a fresh view, so the
    port's ``materialise`` and ``cast_payload_tod`` (``tod_dtype``) run
    and the served store stays lazy. ``calls`` counts reads by name; a
    name not served raises ``OSError``."""

    def __init__(self, stores: dict):
        self.stores = dict(stores)
        self.calls: dict[str, int] = {}

    def load(self, filename, eager_tod=True, tod_dtype="f32"):
        from comapreduce_tpu_torch.data.level import COMAPLevel1
        from comapreduce_tpu_torch.ingest.loaders import eager_payload

        self.calls[filename] = self.calls.get(filename, 0) + 1
        if filename not in self.stores:
            raise OSError(f"{filename}: no Level-1 store served")
        store = self.stores[filename]
        if eager_tod:
            return eager_payload(level1_view(store), tod_dtype)
        return store if isinstance(store, COMAPLevel1) else \
            level1_view(store)

    def __enter__(self):
        from comapreduce_tpu_torch.ingest import loaders

        self._loaders, self._saved = loaders, loaders.load_level1
        loaders.load_level1 = self.load
        return self

    def __exit__(self, *exc):
        self._loaders.load_level1 = self._saved


def heartbeat_gaps(runner):
    """Wraps the runner's heartbeat so each write's monotonic time is
    kept; returns the list the times go to (the runtime is built here, as
    ``run_tod`` would)."""
    hb = runner._resilience_runtime().heartbeat
    times = []
    write = hb.write

    def timed():
        write()
        times.append(time.monotonic())

    hb.write = timed
    return times


def run_state(runner, files) -> dict:
    """What a run left in its state and output directories: the ledger's
    entries by (file, feed, band, disposition, failure class, retries,
    stage), the quality records, the lease states of ``files`` and the
    scheduler's stats."""
    from comapreduce_tpu_torch.resilience.lease import LeaseBoard
    from comapreduce_tpu_torch.telemetry.quality import read_quality

    res = runner._resilience_runtime()
    ledger = [] if res.ledger is None else sorted(
        (os.path.basename(e.unit["file"]), e.unit["feed"], e.unit["band"],
         e.disposition, e.failure_class, e.retries, e.stage)
        for e in res.ledger.entries)
    board = LeaseBoard(runner.state_dir)
    leases = {os.path.basename(f): (board.state(f) or {}).get("state")
              for f in files}
    return {"ledger": ledger, "quality": read_quality(runner.state_dir),
            "leases": leases, "scheduler": dict(runner.scheduler_stats),
            "state_files": sorted(os.listdir(runner.state_dir))}


def make_device_tod_class():
    """The lazy full-width ``spectrometer/tod`` (a class built here, so the
    module imports nothing of the port at import)."""
    import torch

    from comapreduce_tpu_torch.data.hdf5io import LazyDataset
    from comapreduce_tpu_torch.data.synthetic import SAMPLE_RATE

    class DeviceLevel1Tod(LazyDataset):
        """``spectrometer/tod`` f32[F, B, C, T] of a synthetic observation
        that no host could hold, generated on the card feed by feed from
        ``(seed, feed)`` by the generator's physical model
        (``data/synthetic.py``): ``G T_total (1 + dg) (1 + rms n)`` with the
        vane load at the vane-flagged samples, the airmass term of each
        feed's elevation plus ``sky`` (f64[F, T] K on the host: a source's
        brightness along each feed's pointing, or None), a 1/f gain stream
        ``dg`` and radiometer noise.
        Reads ``[feed]``, ``[..., s:e]`` and ``[...]`` (the eager loader's
        whole array) copy to the host as numpy, like an h5py dataset's,
        each feed straight into one preallocated host array;
        ``read_s`` sums their walls."""

        def __init__(self, p, el, vane_flag, n_channels, device, sky=None):
            self.p = p
            self.el = np.asarray(el)
            self.sky = sky
            self.vane = torch.as_tensor(np.asarray(vane_flag), device=device)
            self.dev = torch.device(device)
            self.shape = (p.n_feeds, p.n_bands, n_channels, self.el.shape[1])
            self.dtype = np.dtype(np.float32)
            self.read_s = 0.0
            self.reads = 0

        def _draws(self, f: int):
            p = self.p
            _, B, C, _ = self.shape
            g = torch.Generator(device=self.dev)
            g.manual_seed(p.seed * 1_000_003 + f)
            gain = (p.gain_mean * (1.0 + p.gain_spread * torch.randn(
                (B, C), generator=g, device=self.dev))).abs()
            chan = torch.linspace(-1.0, 1.0, C, device=self.dev)
            t_rx = p.t_rx * (1.0 + p.passband_curvature * chan ** 2
                             + p.t_rx_scatter * torch.randn(
                                 (B, C), generator=g, device=self.dev))
            return g, gain, torch.clamp(t_rx, min=0.2 * p.t_rx)

        def airmass(self, f: int) -> np.ndarray:
            return 1.0 / np.sin(np.radians(self.el[f]))

        def truth(self, f: int):
            """(gain, tsys) f64[B, C] of feed ``f``."""
            _, gain, t_rx = self._draws(f)
            p = self.p
            tsys = t_rx + p.t_cmb + p.t_atm_zenith * float(
                self.airmass(f).mean())
            return (gain.double().cpu().numpy(),
                    tsys.double().cpu().numpy())

        def feed(self, f: int):
            """Feed ``f``'s counts f32[B, C, T] on the card."""
            p = self.p
            _, B, C, T = self.shape
            g, gain, t_rx = self._draws(f)
            w = torch.randn(T, generator=g, device=self.dev,
                            dtype=torch.float64)
            nu = torch.fft.rfftfreq(T, d=1.0 / SAMPLE_RATE, device=self.dev,
                                    dtype=torch.float64)
            shape = torch.sqrt(1.0 + (p.fknee / nu[1:]) ** p.alpha)
            shape = torch.cat([shape.new_zeros(1), shape])
            dg = (torch.fft.irfft(torch.fft.rfft(w) * shape, n=T)
                  * p.sigma_g).float()
            am = torch.as_tensor(self.airmass(f), device=self.dev).float()
            t_sky = p.t_cmb + p.t_atm_zenith * am
            if self.sky is not None:
                t_sky = t_sky + torch.as_tensor(self.sky[f],
                                                device=self.dev).float()
            load = torch.where(self.vane, torch.full_like(t_sky, p.t_vane),
                               t_sky)
            tod = t_rx[..., None] + load                # (B, C, T)
            tod.mul_(gain[..., None]).mul_(1.0 + dg)
            noise = torch.randn((B, C, T), generator=g, device=self.dev)
            rms_frac = 1.0 / np.sqrt(2.0e9 / C / SAMPLE_RATE)
            return tod.mul_(noise.mul_(rms_frac).add_(1.0))

        def _all_feeds(self, cut: slice):
            """Every feed's ``[..., cut]``, each copied from the card
            into its slot of one host array."""
            F, B, C, T = self.shape
            n = len(range(*cut.indices(T)))
            out = np.empty((F, B, C, n), np.float32)
            for f in range(F):
                torch.from_numpy(out[f]).copy_(self.feed(f)[..., cut])
            return out

        def __getitem__(self, key):
            t0 = time.perf_counter()
            if isinstance(key, (int, np.integer)):
                out = self.feed(int(key)).cpu().numpy()
            elif key is Ellipsis or key == (Ellipsis,):
                out = self._all_feeds(slice(None))
            elif (isinstance(key, tuple) and len(key) == 2
                  and key[0] is Ellipsis and isinstance(key[1], slice)):
                out = self._all_feeds(key[1])
            else:
                raise IndexError(f"DeviceLevel1Tod reads [feed], [...] and "
                                 f"[..., s:e], not {key!r}")
            self.read_s += time.perf_counter() - t0
            self.reads += 1
            return out

    return DeviceLevel1Tod


def full_width_level1(seed: int = 7, C: int = 1024, device: str = "cuda",
                      **params):
    """The full-width observation: F=19, B=4, C=1024, the flagship's 10 CES
    scans of 13 500 samples (vane 256 at each end, gaps 64); ``params``
    override the generator's knobs (the calibrator's scans and source).
    The metadata (features, pointing, MJD, housekeeping and the vane
    temperature) comes from ``generate_level1_store`` at the full F and T
    with 2 channels; ``frequency`` is rebuilt for ``C`` channels and
    ``spectrometer/tod`` is a :func:`make_device_tod_class` dataset on
    ``device``, the generator's source brightness along each feed's
    pointing in its sky load."""
    from comapreduce_tpu_torch.data.synthetic import (SyntheticObsParams,
                                                      _band_frequencies,
                                                      generate_level1_store)

    knobs = dict(n_feeds=19, n_bands=4, n_channels=2, n_scans=10,
                 scan_samples=13_500, vane_samples=256, gap_samples=64,
                 seed=seed)
    p, meta = generate_level1_store(SyntheticObsParams(**dict(knobs,
                                                              **params)))
    data = level1_view(meta)
    data["spectrometer/frequency"] = _band_frequencies(p.n_bands, C)
    tod = make_device_tod_class()(
        p, meta["spectrometer/pixel_pointing/pixel_el"],
        p.truth["vane_flag"], C, device,
        sky=p.truth["sky"] if p.source_amplitude_k > 0 else None)
    data["spectrometer/tod"] = tod
    return p, data, tod


def phase_chain_small():
    """Phase E, small: the reference pipeline test's observation through
    the shipped chain on the card and on the CPU, every Level-2 dataset
    compared (:func:`level2_diffs`). Returns the report line and the
    card's Level-2 store."""
    from comapreduce_tpu_torch.data.synthetic import generate_level1_store
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)

    _, store = generate_level1_store(pipeline_test_params())
    out = {}
    for dev in ("cuda", "cpu"):
        masked_fill.launches = rolling_median_windows.launches = 0
        runner = memory_runner(dev)
        out[dev] = runner._run_file("comap-0000007.hd5",
                                    data=level1_view(store))
        if dev == "cuda":
            launches = {"masked_fill": masked_fill.launches,
                        "rolling_median_windows":
                            rolling_median_windows.launches}
    names = [n for n in ("spectrometer", "vane", "atmosphere",
                         "averaged_tod", "spikes", "fnoise_fits",
                         "noise_statistics")
             if not out["cuda"].contains_groups([n])]
    if names:
        raise SystemExit(f"chain small: card run lacks groups {names}")
    try:
        diffs = check_level2(out["cuda"], out["cpu"], "chain small")
    except AssertionError as err:
        raise SystemExit(str(err))
    # one scan chunk per feed (3 scans of 640 fit any budget): K1 and K2
    # once per feed in the reduction, K2 once more in Spikes
    F = 2
    want = {"masked_fill": F, "rolling_median_windows": F + 1}
    if launches != want:
        raise SystemExit(f"chain small launches {launches}, not {want}")
    line = {"max_diff": diffs, "launches": launches}
    log("chain_small", json.dumps(line))
    return line, out["cuda"]


def k1_site(tod, mask, label: str) -> dict:
    """K1 on one input (``tod``, ``mask``: f32[..., L]) bitwise against its
    plain version on the card, timed beside its bound (bytes: the TOD and
    the mask read, the output written; operations: a selection over the
    stride-4 subsample and a compare a sample, per row) and its plain
    version; no one library call computes it. ``masked_share`` is the
    share of samples the kernel fills."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (masked_fill,
                                                       masked_fill_plain)

    L = tod.shape[-1]
    rows = tod.numel() // L
    got = masked_fill(tod, mask)
    want = masked_fill_plain(tod, mask)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise SystemExit(f"K1 at {label} disagrees with its plain version")
    finite = ~torch.isnan(want)
    b_ms, by = bound(3 * rows * L * 4, rows * (L + L // 4))
    line = dict(
        site=label, shape=[rows, L],
        masked_share=float((mask == 0).float().mean()),
        max_abs_err=float((got[finite] - want[finite]).abs().max()),
        ms=cuda_ms(lambda: masked_fill(tod, mask)),
        plain_ms=cuda_ms(lambda: masked_fill_plain(tod, mask), reps=3,
                         warm=1),
        bound_ms=b_ms, bound_by=by, library_ms=None)
    log("k1_site", json.dumps(line))
    return line


def k2_site(padded, w: int, floor_ms: float, label: str) -> dict:
    """K2 on one input (``padded``, f32[..., T + w - 1]) at window ``w``:
    bitwise against its plain version on the card (and, at an odd window,
    ``torch.median`` bitwise against both), timed beside its bound (bytes:
    the padded rows read, the outputs written; operations: at most one
    linear selection, a compare per window entry, per output), its plain
    version and ``torch.median`` on an unfold view (the same function at
    an odd window; the lower middle at an even one, the nearest library
    call)."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (
        rolling_median_sorts, rolling_median_windows,
        rolling_median_windows_plain)

    x = padded.reshape(-1, padded.shape[-1]).contiguous()
    rows, P = x.shape
    T = P - w + 1
    got = rolling_median_windows(x, w)
    want = rolling_median_windows_plain(x, w)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise SystemExit(f"K2 at {label} disagrees with its plain version")
    if w % 2:
        lib = torch.median(x.unfold(-1, w, 1), dim=-1).values
        if not bits_equal(lib, want):
            raise SystemExit(f"K2 at {label}: torch.median disagrees")
        del lib
    b_ms, by = bound(rows * (P + T) * 4, rows * T * w)
    line = dict(
        site=label, shape=[rows, P], window=w,
        sorted_body=rolling_median_sorts(w),
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: rolling_median_windows(x, w)),
        plain_ms=cuda_ms(lambda: rolling_median_windows_plain(x, w),
                         reps=3, warm=1),
        bound_ms=b_ms, bound_by=by, launch_floor_ms=floor_ms,
        library_ms=cuda_ms(lambda: torch.median(x.unfold(-1, w, 1), dim=-1),
                           reps=3, warm=1),
        library="torch.median on an unfold view" + (
            "" if w % 2 else " (the lower middle: an even window's "
            "midpoint has no one-call library form)"))
    log("k2_site", json.dumps(line))
    return line


def _site_kernels(k_rows: int, L: int, mf_rows: int, window: int,
                  spikes_shape, spikes_window: int):
    """K1 and K2 at the stage chain's new sites, each bitwise against its
    plain version on inputs drawn on the card, timed beside its bound and
    the library call: K1 at the reduction's scan block (k B C rows of L),
    K2 at the exact window-501 filter over the band means (k B rows of
    L + 500) and at Spikes' window 101 over the averaged TOD (F B rows)."""
    import torch

    dev = torch.device("cuda")
    one = torch.empty(1, device=dev)
    floor_ms = cuda_ms(lambda: one.zero_(), reps=50)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    tod = 4.5e7 * (1 + 0.01 * torch.randn((k_rows, L), generator=g,
                                          device=dev))
    mask = (torch.rand((k_rows, L), generator=g, device=dev) > 0.01).float()
    mask[:, L - 68:] = 0.0          # the scan's padded tail
    sites = {"masked_fill@reduce": k1_site(tod, mask, "the stage chain's "
                                                      "scan block")}
    del tod, mask

    def k2_site_at(name, rows, T, w, seed):
        g.manual_seed(seed)
        t = torch.arange(T + w - 1, device=dev, dtype=torch.float32)
        x = (torch.sin(t / 300.0)[None, :] + 0.1 * torch.randn(
            (rows, T + w - 1), generator=g, device=dev)).contiguous()
        sites[name] = k2_site(x, w, floor_ms, name)

    k2_site_at("rolling_median_windows@medfilt501", mf_rows, L, window, 19)
    k2_site_at("rolling_median_windows@spikes101", spikes_shape[0],
               spikes_shape[1], spikes_window, 23)
    log("chain_sites", json.dumps(sites))
    return sites


def check_chain_machinery(runner, files, beats, n_records) -> dict:
    """The run machinery of one clean ``run_tod`` as shipped: the
    quarantine ledger empty, ``n_records`` quality records with finite
    vane and noise fields, every file's lease committed (the scheduler's
    stats), the state files written, and the longest gap between two
    heartbeat writes (``beats``) below the lease TTL."""
    state = run_state(runner, files)
    res = runner._resilience_runtime()
    fields = ("tsys_k", "gain", "white_sigma", "fknee_hz", "alpha")
    bad = [(r["feed"], r["band"]) for r in state["quality"]
           if not all(r[k] is not None and np.isfinite(r[k])
                      for k in fields)]
    gaps = np.diff(beats) if len(beats) > 1 else np.zeros(1)
    out = {"ledger": state["ledger"], "n_quality": len(state["quality"]),
           "quality_flagged": sum(r["flagged"] for r in state["quality"]),
           "quality_nonfinite": bad, "leases": state["leases"],
           "scheduler": state["scheduler"],
           "state_files": state["state_files"], "heartbeats": len(beats),
           "heartbeat_max_gap_s": float(gaps.max()),
           "lease_ttl_s": res.lease_ttl_s,
           "heartbeat_s": res.heartbeat.period_s}
    want_files = {"heartbeat.rank0.json", "queue.json",
                  "quality.rank0.jsonl"}
    if state["ledger"] or len(state["quality"]) != n_records or bad or \
            set(state["leases"].values()) != {"done"} or \
            state["scheduler"].get("committed") != len(files) or \
            not want_files <= set(state["state_files"]) or \
            not out["heartbeat_max_gap_s"] < res.lease_ttl_s or \
            len(beats) < 2:
        raise SystemExit(f"run machinery: {out}")
    return out


# the shipped chain's run machinery off: no quarantine ledger, leases,
# heartbeats or quality ledger (chain_ab.py's "off" runs)
MACHINERY_OFF = {"resilience": {"quarantine": "off", "lease_ttl_s": 0,
                                "heartbeat_s": 0},
                 "quality": {"enabled": False}}


def phase_chain_full(machinery: bool = True):
    """Phase E, full width: the shipped chain over the full-width
    observation on the card, with every product checked, the launches of
    K1 and K2 counted against the code's derivation, the run machinery
    checked (:func:`check_chain_machinery`), per-stage walls (reads
    apart), the planner's choice and estimate beside the measured peak,
    and K1 and K2 timed at the chain's shapes. ``machinery=False`` runs
    the chain with ``MACHINERY_OFF`` and checks no machinery. Returns the
    report line and the Level-2 store."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.ops.prefilter import prefilter
    from comapreduce_tpu_torch.ops.reduce import (device_hbm_bytes,
                                                  estimate_reduce_hbm,
                                                  plan_reduce_memory,
                                                  scan_starts_lengths)
    from comapreduce_tpu_torch.pipeline.stages import mean_vane_tsys_gain

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p, data, tod = full_width_level1()
    setup_s = time.perf_counter() - t0
    # two reads of one feed give the same bytes
    a, b = tod[3], tod[3]
    if not np.array_equal(a.view(np.int32), b.view(np.int32)):
        raise SystemExit("chain full: two reads of feed 3 differ")
    del a, b
    tod.read_s, tod.reads = 0.0, 0
    F, B, C, T = tod.shape
    edges = np.asarray(data.scan_edges)
    S = len(edges)
    _, _, L = scan_starts_lengths(edges)
    cfg = shipped_chain_config()
    if not machinery:
        cfg.update({k: dict(v) for k, v in MACHINERY_OFF.items()})
    fb = int(cfg["Level1AveragingGainCorrection"]["feed_batch"])
    hbm = device_hbm_bytes(device="cuda")
    k = plan_reduce_memory(fb, B, C, T, S, L, None, hbm_bytes=hbm)
    k_eff = S if k is None else k
    estimate = estimate_reduce_hbm(fb, B, C, T, S, L, scan_batch=k)

    stages = []
    counters = (masked_fill, rolling_median_windows, prefilter)

    def on_stage(lvl2):
        torch.cuda.synchronize()
        name = list(runner.timings)[-1]
        prev = stages[-1] if stages else {"read_s": 0.0, "reads": 0,
                                          "k1": 0, "k2": 0}
        done = {"read_s": tod.read_s, "reads": tod.reads,
                "k1": masked_fill.launches,
                "k2": rolling_median_windows.launches}
        stages.append(dict(
            done, stage=name, wall_s=runner.timings[name][-1],
            stage_read_s=done["read_s"] - prev["read_s"],
            stage_reads=done["reads"] - prev["reads"],
            k1_launches=done["k1"] - prev["k1"],
            k2_launches=done["k2"] - prev["k2"],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            base_gib=base[0] / 2**30))
        base[0] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    name = "comap-fullwidth.hd5"
    run_dir = os.path.join(ROOT, "chiprun_out", "chain_full")
    shutil.rmtree(run_dir, ignore_errors=True)
    runner = memory_runner("cuda", cfg, on_stage, run_dir=run_dir)
    beats = heartbeat_gaps(runner) if machinery else None
    base = [torch.cuda.memory_allocated()]
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    with ServedLevel1({name: data}):
        results = runner.run_tod([name])
    chain_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    if len(results) != 1 or results[0] is None:
        raise SystemExit(f"chain full: run_tod gave {results}")
    lvl2 = results[0]
    machinery = (check_chain_machinery(runner, [name], beats, F * B)
                 if machinery else None)
    walls = {s["stage"]: s for s in stages}
    want_groups = ("spectrometer", "vane", "atmosphere", "averaged_tod",
                   "spikes", "fnoise_fits", "noise_statistics")
    missing = [g for g in want_groups if not lvl2.contains_groups([g])]
    if missing:
        raise SystemExit(f"chain full: no {missing} (stages run: "
                         f"{list(walls)})")
    for name in lvl2.keys():
        v = np.asarray(lvl2[name])
        if name.endswith("fnoise_fit_parameters"):
            v = v[~np.isnan(v[..., 0])]
            if not v.size:
                raise SystemExit(f"chain full: no fitted scan in {name}")
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise SystemExit(f"chain full: non-finite values in {name}")
    # the vane recovers the generator's truth (tests/test_pipeline.py)
    tsys, gain = mean_vane_tsys_gain(lvl2)
    truth = [tod.truth(f) for f in range(F)]
    g_true = np.stack([t[0] for t in truth])
    t_true = np.stack([t[1] for t in truth])
    ok = tsys > 0
    rel_g = float(np.median(np.abs(gain - g_true)[ok] / g_true[ok]))
    rel_t = float(np.median(np.abs(tsys - t_true)[ok] / t_true[ok]))
    if not (ok.mean() > 0.9 and rel_g < 0.05 and rel_t < 0.10):
        raise SystemExit(f"chain full: vane calibrated {ok.mean():.3f} of "
                         f"channels, median gain error {rel_g}, Tsys "
                         f"error {rel_t}")
    avg = np.asarray(lvl2["averaged_tod/tod"])
    in_scan = np.zeros(T, bool)
    for s, e in edges:
        in_scan[s:e] = True
    if np.abs(avg[..., ~in_scan]).max() != 0.0 or \
            not (avg[..., in_scan] != 0).mean() > 0.99:
        raise SystemExit("chain full: averaged TOD not zero outside scans "
                         "and non-zero inside them")
    spike_share = float(np.asarray(lvl2["spikes/spike_mask"]).mean())
    if not spike_share < 0.5:
        raise SystemExit(f"chain full: {spike_share} of samples flagged")
    for grp in ("fnoise_fits", "noise_statistics"):
        par = np.asarray(lvl2[f"{grp}/fnoise_fit_parameters"])
        sig2 = par[..., 0][~np.isnan(par[..., 0])]
        if not (sig2 > 0).all():
            raise SystemExit(f"chain full: {grp} white levels not > 0")
    # K1, K2 and K5 once per scan chunk of each feed in the reduction, K2
    # once more in Spikes
    chunks = -(-S // k_eff)
    want = {"masked_fill": F * chunks,
            "rolling_median_windows": F * chunks + 1,
            "prefilter": F * chunks}
    if launches != want:
        raise SystemExit(f"chain full launches {launches}, not {want}")
    red = walls["Level1AveragingGainCorrection"]
    window = min(int(cfg["Level1AveragingGainCorrection"]["medfilt_window"]),
                 L)
    spikes_w = int(cfg["Spikes"]["window"])
    sites = _site_kernels(k_eff * B * C, L, k_eff * B, window, (F * B, T),
                          spikes_w)
    line = {
        "shape": [F, B, C, T], "n_scans": S, "L": L,
        "setup_s": setup_s, "chain_s": chain_s, "machinery": machinery,
        "read_s": tod.read_s, "reads": tod.reads,
        "stages": [{k: s[k] for k in ("stage", "wall_s", "stage_read_s",
                                      "stage_reads", "k1_launches",
                                      "k2_launches", "peak_gib",
                                      "base_gib")} for s in stages],
        "launches": launches, "device_hbm_bytes": hbm,
        "feed_batch": fb, "scan_batch_planned": k,
        "estimate_reduce_hbm_gib": estimate / 2**30,
        "reduce_peak_gib": red["peak_gib"],
        "reduce_peak_above_base_gib": red["peak_gib"] - red["base_gib"],
        "peak_above_base_gib": max(s["peak_gib"] - s["base_gib"]
                                   for s in stages),
        "vane_median_rel_err": {"gain": rel_g, "tsys": rel_t},
        "spike_share": spike_share, "sites": sites,
    }
    log("chain_full", json.dumps({k: v for k, v in line.items()
                                  if k != "sites"}))
    return line, lvl2


# Phase F: the map-maker's Level-2 reader and its INI entry point over
# phase E's Level-2 stores
SHIPPED_INI = os.path.join("examples", "configs", "parameters.ini")
# the shipped INI's pixelisation: 240 x 240 pixels of 2' at the synthetic
# field's centre
SHIPPED_FIELD = ((170.0, 52.0), (0.0333333, 0.0333333), (240, 240))
# phase F's small card-vs-CPU run: 80 x 80 pixels of 6'. At the shipped 2'
# the small store's 3 600 samples a band hit 935 pixels a median 3 times:
# the two-level solve diverges, its Jacobi re-solve stops unconverged (at
# 3e-6), and two unconverged iterates of this near-singular system, summed
# in another order on the card, differed by 1.07e-2 of scale. At 6' (186
# pixels, a median 20 hits) both bands converge below 1e-6
SMALL_FIELD = ((170.0, 52.0), (0.1, 0.1), (80, 80))
READER_WINDOW = 400


class ServedLevel2:
    """Serves Level-2 stores to the port's ``ingest.loaders.load_level2``
    by file name, for the ``with`` block: the card's machine has no h5py,
    so phase F reads phase E's stores from memory (each read gets the
    store's payload dict, which ``level2_stream`` rebuilds into a fresh
    ``COMAPLevel2``), its TOD narrowed by the port's ``cast_payload_tod``
    under ``tod_dtype``. ``calls`` counts reads by name; a name not
    served raises ``OSError``, as a missing file would."""

    def __init__(self, stores: dict):
        self.stores = dict(stores)
        self.calls: dict[str, int] = {}

    def load(self, filename, tod_dtype="f32"):
        from comapreduce_tpu_torch.ops.precision import cast_payload_tod

        self.calls[filename] = self.calls.get(filename, 0) + 1
        if filename not in self.stores:
            raise OSError(f"{filename}: no Level-2 store served")
        return cast_payload_tod(self.stores[filename].export_payload(),
                                tod_dtype)

    def __enter__(self):
        from comapreduce_tpu_torch.ingest import loaders

        self._loaders, self._saved = loaders, loaders.load_level2
        loaders.load_level2 = self.load
        return self

    def __exit__(self, *exc):
        self._loaders.load_level2 = self._saved


def write_ini(path: str, sections: dict) -> str:
    """An INI file of ``{section: {key: value}}`` that the port's
    ``IniConfig`` reads back to the same values (lists comma-joined)."""
    with open(path, "w") as fh:
        for name, kv in sections.items():
            fh.write(f"[{name}]\n")
            for k, v in kv.items():
                v = ", ".join(str(x) for x in v) if isinstance(v, list) \
                    else str(v)
                fh.write(f"{k} : {v}\n")
            fh.write("\n")
    return path


def shipped_destriper_ini(filelist: str, out_dir: str, path: str,
                          field=None, root: str = ROOT, sections=None,
                          **inputs) -> str:
    """``examples/configs/parameters.ini`` as shipped (its ``[Resilience]``
    too) with ``[Inputs] filelist`` / ``output_dir`` pointed at
    ``filelist`` / ``out_dir`` (``inputs`` adds or overrides [Inputs]
    knobs, e.g. ``log_dir``, the state directory), ``sections`` merged
    into their sections and, given a WCS ``field`` (crval, cdelt, shape),
    ``[Pixelization]`` set to it."""
    from comapreduce_tpu_torch.pipeline.config import IniConfig

    ini = IniConfig(os.path.join(root, SHIPPED_INI))
    ini["Inputs"].update(filelist=filelist, output_dir=out_dir, **inputs)
    for name, kv in (sections or {}).items():
        ini.setdefault(name, {}).update(kv)
    if field is not None:
        crval, cdelt, shape = field
        ini["Pixelization"] = {"type": "wcs", "crval": list(crval),
                               "cdelt": list(cdelt), "shape": list(shape)}
    return write_ini(path, ini)


class MainProbe:
    """Wraps the port's map-maker entry points for one ``main`` run:
    each ``read_comap_data`` call's wall (timed from outside), each
    ``solve_band`` / ``solve_bands_joint`` call's synchronised wall, each
    ``destripe_planned`` call's iterations (K3's launches follow from
    them, :func:`k3_launches`), and each ``write_band_map`` call's wall
    with the maps it wrote (host f32, as the writer casts them), or under
    ``[Inputs] writeback`` each ``band_map_writer``'s maps and the wall
    of its write on the background writer. A read given a block cache
    records the cache's statistics after it (``cache_stats``)."""

    def __init__(self, device: str):
        self.device = device
        self.reads, self.solves, self.cg, self.writes = [], [], [], []
        self.last_data = None
        # each band's DestriperData, by band
        self.datas = {}
        self.cache_stats = []
        self.cache_bytes = []
        self._writing = False

    def _sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        return time.perf_counter()

    def __enter__(self):
        import comapreduce_tpu_torch.cli.run_destriper as rd
        import comapreduce_tpu_torch.mapmaking.leveldata as ld

        self._saved = [(ld, "read_comap_data", ld.read_comap_data)] + [
            (rd, n, getattr(rd, n)) for n in (
                "solve_band", "solve_bands_joint", "destripe_planned",
                "write_band_map", "band_map_writer")]
        read, solve, joint, planned, write, writer = (
            f for _, _, f in self._saved)

        def timed_read(*a, **kw):
            t0 = time.perf_counter()
            data = self.last_data = read(*a, **kw)
            self.datas[kw.get("band", 0)] = data
            files = a[0] if a else kw.get("filenames", ())
            self.reads.append({"band": kw.get("band", 0),
                               "read_s": time.perf_counter() - t0,
                               "samples": int(data.tod.size),
                               "files": len(files)})
            cache = kw.get("cache")
            if cache is not None:
                self.cache_stats.append(dict(cache.stats))
                self.cache_bytes.append(cache.current_bytes)
            return data

        def timed(fn, kind):
            def call(*a, **kw):
                t0 = self._sync()
                out = fn(*a, **kw)
                self.solves.append({"kind": kind,
                                    "solve_s": self._sync() - t0})
                return out
            return call

        def counted(*a, **kw):
            res = planned(*a, **kw)
            self.cg.append((int(res.n_iter), bool(kw.get("n_groups")),
                            kw.get("x0") is not None))
            return res

        def entry(path, result):
            maps = {"DESTRIPED": result.destriped_map,
                    "NAIVE": result.naive_map, "WEIGHTS": result.weight_map,
                    "HITS": result.hit_map}
            return {"path": path, "n_iter": int(result.n_iter),
                    "residual": float(result.residual),
                    "maps": {k: np.array(np.asarray(
                        v.cpu() if hasattr(v, "cpu") else v), np.float32)
                        for k, v in maps.items()}}

        def recorded(path, data, result):
            t0 = time.perf_counter()
            # write_band_map builds its writer through band_map_writer:
            # that call is this write, not a queued one
            self._writing = True
            try:
                write(path, data, result)
            finally:
                self._writing = False
            self.writes.append(dict(entry(path, result),
                                    write_s=time.perf_counter() - t0))

        def queued(path, data, result):
            fn = writer(path, data, result)
            if self._writing:
                return fn
            rec = dict(entry(path, result), write_s=None, queued=True)
            self.writes.append(rec)

            def timed():
                t0 = time.perf_counter()
                fn()
                rec["write_s"] = time.perf_counter() - t0
            return timed

        ld.read_comap_data = timed_read
        rd.solve_band = timed(solve, "solve_band")
        rd.solve_bands_joint = timed(joint, "solve_bands_joint")
        rd.destripe_planned = counted
        rd.write_band_map = recorded
        rd.band_map_writer = queued
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def k3_want(self) -> int:
        """K3 launches of this run's planned solves (two-level or Jacobi:
        no V-cycle; a warm start adds one matvec, 2 launches)."""
        return sum(k3_launches(k, ground=g, nu=0) + (2 if warm else 0)
                   for k, g, warm in self.cg)


def check_written(probe: MainProbe, wcs_shape=None) -> list:
    """Every map ``main`` wrote reads back through ``fits_io`` bitwise
    equal to the maps it was given (WCS images reshaped to the field)."""
    from comapreduce_tpu_torch.mapmaking.fits_io import read_fits_image

    for w in probe.writes:
        hdus = read_fits_image(w["path"])
        if [h[0] for h in hdus] != list(w["maps"]):
            raise SystemExit(f"{w['path']}: HDUs {[h[0] for h in hdus]}")
        for name, _, data in hdus:
            want = w["maps"][name]
            if wcs_shape is not None:
                want = want.reshape(wcs_shape)
            if data.dtype != np.float32 or data.shape != want.shape or \
                    data.tobytes() != want.tobytes():
                raise SystemExit(f"{w['path']}: {name} does not read back "
                                 "bitwise")
    return [os.path.relpath(w["path"], ROOT) for w in probe.writes]


def phase_reader_small(store, stage_log):
    """Phase F, small: phase E's small Level-2 store (the reference
    pipeline test's observation, F=2, B=2, 3 scans of 600) through the
    reader and ``main`` on the card and on the CPU. ``read_comap_data`` of
    both bands gives bitwise-equal ``DestriperData`` (K2 is bitwise to its
    plain version, the rest is host numpy); ``main`` over the shipped INI
    cut to two bands on ``SMALL_FIELD`` (``[Resilience]`` off) writes maps
    that agree within MAP_ATOL of scale (the weight map of its own
    largest value), hits equal, and read back bitwise, both solves
    converged; K2 launches once per band read on the card."""
    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.ops.cuda_median import rolling_median_windows

    name = "Level2_comap-0000007.hd5"
    out = os.path.join(ROOT, "chiprun_out", "reader_small")
    os.makedirs(out, exist_ok=True)
    filelist = os.path.join(out, "l2list.txt")
    with open(filelist, "w") as fh:
        fh.write(name + "\n")
    wcs = WCS.from_field(*SMALL_FIELD)
    line = {}
    with ServedLevel2({name: store}):
        for band in (0, 1):
            rolling_median_windows.launches = 0
            got = read_comap_data([name], band=band, wcs=wcs, device="cuda")
            k2 = rolling_median_windows.launches
            want = read_comap_data([name], band=band, wcs=wcs, device="cpu")
            for f in ("tod", "pixels", "weights", "ground_ids", "az"):
                a, b = getattr(got, f), getattr(want, f)
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    raise SystemExit(f"reader small band {band}: {f} differs "
                                     "between the card and the CPU")
            if (got.n_groups, got.npix, got.groups) != \
                    (want.n_groups, want.npix, want.groups) or k2 != 1:
                raise SystemExit(f"reader small band {band}: groups or npix "
                                 f"differ, or K2 launched {k2} times")
            line[f"band{band}_samples"] = int(got.tod.size)
        maps, runs = {}, {}
        for dev in ("cuda", "cpu"):
            ini = shipped_destriper_ini(
                filelist, os.path.join(out, dev),
                os.path.join(out, f"{dev}.ini"), SMALL_FIELD, bands=[0, 1])
            rolling_median_windows.launches = 0
            stage_log.clear()
            with MainProbe(dev) as probe:
                if rd_main([ini, f"--device={dev}"]) != 0:
                    raise SystemExit(f"reader small: main on {dev} failed")
            check_written(probe, SMALL_FIELD[2][::-1])
            maps[dev] = [w["maps"] for w in probe.writes]
            runs[dev] = {"cg_iters": [w["n_iter"] for w in probe.writes],
                         "residual": [w["residual"] for w in probe.writes],
                         "k2_launches": rolling_median_windows.launches}
    if runs["cuda"]["k2_launches"] != 2 or runs["cpu"]["k2_launches"] or \
            max(runs["cuda"]["residual"] + runs["cpu"]["residual"]) > 1e-6:
        raise SystemExit(f"reader small: K2 launches or residuals {runs}")
    diff = {"DESTRIPED": 0.0, "NAIVE": 0.0, "WEIGHTS": 0.0}
    for b, (g, w) in enumerate(zip(maps["cuda"], maps["cpu"])):
        if not np.array_equal(g["HITS"], w["HITS"]) or not \
                (w["HITS"] > 0).any():
            raise SystemExit(f"reader small band {b}: hit maps differ")
        # the sky maps against the destriped map's scale; the weight map
        # (sums of 1/sigma^2, thousands) against its own largest value:
        # K3 adds its terms in another order than the CPU, a few ulp of it
        scale = max(float(np.nanstd(w["DESTRIPED"])), 1.0)
        for k in diff:
            ref = float(np.abs(w[k]).max()) if k == "WEIGHTS" else scale
            d = float(np.abs(g[k] - w[k]).max()) / ref
            if not d <= MAP_ATOL:
                raise SystemExit(f"reader small band {b}: {k} differs by "
                                 f"{d} of scale > {MAP_ATOL}")
            diff[k] = max(diff[k], d)
    line.update(runs=runs, max_map_diff_of_scale=diff)
    log("reader_small", json.dumps(line))
    return line


def reader_k2_site(store, floor_ms: float, band: int = 0) -> dict:
    """K2 at the reader's high-pass (:func:`k2_site`): one band's (F, T)
    averaged TOD, edge padded by (w - 1) / 2 and w / 2 at window 400
    (exact, even: each output the midpoint of the two middles)."""
    import torch

    from comapreduce_tpu_torch.ops.median_filter import _pad

    w = READER_WINDOW
    tod = torch.as_tensor(np.asarray(store["averaged_tod/tod"],
                                     np.float32)[:, band], device="cuda")
    return k2_site(_pad(tod, (w - 1) // 2, w // 2, "edge"), w, floor_ms,
                   "reader high-pass")


class BandedReport:
    """Records, for the ``with`` block, what each call of the port's
    ``build_banded_weight`` reported: groups weighted banded, groups kept
    white, and the white groups' reasons."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import comapreduce_tpu_torch.cli.run_destriper as rd

        self._rd, self._saved = rd, rd.build_banded_weight

        def recorded(*a, **kw):
            banded, report = self._saved(*a, **kw)
            reasons = {}
            for f in report["fallbacks"]:
                reasons[f["reason"]] = reasons.get(f["reason"], 0) + 1
            self.calls.append({"band": kw.get("band"),
                               "banded": report["banded"],
                               "white": report["white"],
                               "reasons": reasons})
            return banded, report

        rd.build_banded_weight = recorded
        return self

    def __exit__(self, *exc):
        self._rd.build_banded_weight = self._saved


def level2_quality(src_dir: str, dst_dir: str, flag=()) -> list:
    """``run_average``'s quality ledger in ``src_dir`` keyed as the
    map-maker matches it, written to ``dst_dir``'s rank-0 ledger: each
    record renamed to its Level-2 file (``Level2_`` + the Level-1 name),
    and the records of the files in ``flag`` (Level-2 names) flagged
    ``tsys_high``. ``run_average`` names each record by its Level-1 file
    and the map-maker's groups carry the Level-2 name, in the reference
    too, so over the ledger as written no record matches. Returns the
    records."""
    from comapreduce_tpu_torch.telemetry.quality import (append_quality,
                                                         quality_path,
                                                         read_quality)

    recs = []
    for r in read_quality(src_dir):
        r = {k: v for k, v in r.items() if k != "_sha256"}
        r["file"] = "Level2_" + r["file"]
        if r["file"] in flag:
            r["flags"] = sorted(set(r["flags"]) | {"tsys_high"})
            r["flagged"] = True
        recs.append(r)
    append_quality(quality_path(dst_dir, 0), recs)
    return recs


def phase_reader_full(store, stage_log, quality_dir):
    """Phase F, full width: phase E's full-width Level-2 store (F=19, B=4,
    T = 136 216, the 10 CES scans) as a one-line filelist through ``main``
    on the shipped ``examples/configs/parameters.ini`` (only the filelist,
    the output directory and ``[Resilience]`` changed): the default joint
    route (four bands, two-level block 8, K3 at R = 4; its maps are
    returned beside the report line, phase H's reference), then again with
    ``ground : true`` (per band through ``make_band_map``: K3 at R = 1 and
    K4). K2 launches once per band read (4 a run), K3 as
    :func:`k3_launches` derives from each solve's iterations, K4 once per
    CG iteration of the ground solves and never on the joint route. Both
    runs' four maps read back bitwise, with hits at the field centre and
    finite destriped and naive maps on hit pixels; per band the read wall
    (timed from outside), the solve and write walls, iterations and
    residual, and the peak device memory. Then ``noise_weight =
    banded`` over phase E's quality ledger keyed by the Level-2 file
    (:func:`level2_quality`), where some groups must be weighted banded
    and every band's CG must leave its start. (The banded route over the
    ledger as ``run_average`` wrote it, whose Level-1 records leave every
    group white, was cut to make room for phase P: the CPU tests hold
    that matching.) Then the kernels at this path's
    shapes, each against its plain version: K2 at the reader's site
    (:func:`reader_k2_site`), K3 at the INI's plan with R = 4 (the joint
    route) and R = 1 (per band) and K4 at its ground gather."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.cli.run_destriper import pointing_plan
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.pipeline.config import IniConfig

    name = "Level2_comap-fullwidth.hd5"
    out = os.path.join(ROOT, "chiprun_out", "reader_full")
    filelist = os.path.join(out, "l2list.txt")
    counters = {"masked_fill": masked_fill,
                "rolling_median_windows": rolling_median_windows,
                "binned_window_sum": binned_window_sum,
                "windowed_gather": windowed_gather}
    runs = {}
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with open(filelist, "w") as fh:
        fh.write(name + "\n")
    # the banded route reads phase E's quality ledger keyed by the
    # Level-2 file, in a state directory of its own
    banded_ini = {"Destriper": {"noise_weight": "banded"}}
    level2_dir = os.path.join(out, "banded_l2_state")
    level2_quality(quality_dir, level2_dir)
    routes = (("joint", {}), ("ground", {"ground": True}),
              ("banded_l2", {"log_dir": level2_dir,
                             "sections": banded_ini}))
    with ServedLevel2({name: store}):
        for route, extra in routes:
            ini = shipped_destriper_ini(
                filelist, os.path.join(out, route),
                os.path.join(out, f"{route}.ini"), **extra)
            stage_log.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            t0 = _synced()
            with MainProbe("cuda") as probe, BandedReport() as banded:
                if rd_main([ini]) != 0:
                    raise SystemExit(f"reader full {route}: main failed")
            wall = _synced() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            nx, ny = SHIPPED_FIELD[2]
            files = check_written(probe, (ny, nx))
            n_band = len(probe.writes)
            if route == "joint":
                joint_maps = [w["maps"] for w in probe.writes]
            want = {"masked_fill": 0, "rolling_median_windows": n_band,
                    "binned_window_sum": probe.k3_want(),
                    "windowed_gather": sum(k for k, g, _ in probe.cg if g)}
            ground_ran = want["windowed_gather"] > 0
            if launches != want or n_band != 4 or \
                    ground_ran != (route == "ground"):
                raise SystemExit(f"reader full {route}: launches "
                                 f"{launches}, derived {want} over "
                                 f"{n_band} bands")
            bands = []
            for b, w in enumerate(probe.writes):
                m, hits = w["maps"], w["maps"]["HITS"].reshape(ny, nx)
                hit = m["HITS"] > 0
                if not hits[ny // 2 - 1:ny // 2 + 1,
                            nx // 2 - 1:nx // 2 + 1].all() or not (
                        np.isfinite(m["DESTRIPED"][hit]).all()
                        and np.isfinite(m["NAIVE"][hit]).all()):
                    raise SystemExit(f"reader full {route} band {b}: no hits "
                                     "at the field centre, or non-finite "
                                     "maps on hit pixels")
                bands.append({"band": b, "n_iter": w["n_iter"],
                              "residual": w["residual"],
                              "write_s": w["write_s"],
                              "hit_pixels": int(hit.sum())})
            for b, r in zip(bands, probe.reads):
                b.update(read_s=r["read_s"], samples=r["samples"])
            solves = [s["solve_s"] for s in probe.solves]
            if route == "ground":
                for b, s in zip(bands, solves):
                    b["solve_s"] = s
            runs[route] = {
                "wall_s": wall, "bands": bands, "solve_s": solves,
                "cg_solves": probe.cg, "launches": launches,
                "coarse_build_s": stage_log.seconds("coarse_build"),
                "plan_build_s": stage_log.seconds("plan_build"),
                "warnings": stage_log.warnings[:8],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "files": files, "nvidia_smi": smi_line()}
            if route == "banded_l2":
                # one prior a band, each over the 19 feeds' groups, some
                # weighted banded; a band whose CG never left its start
                # (residual 1) is the NaN of a subnormal prior diagonal
                n_groups = sum(c["banded"] + c["white"]
                               for c in banded.calls)
                n_banded = sum(c["banded"] for c in banded.calls)
                absent = sum(c["reasons"].get("absent", 0)
                             for c in banded.calls)
                stuck = [b["band"] for b in bands
                         if not b["residual"] < 1.0]
                if len(banded.calls) != 4 or n_groups != 4 * 19 or \
                        absent or stuck or not n_banded:
                    raise SystemExit(f"reader full {route}: priors "
                                     f"{banded.calls}, bands stuck at "
                                     f"their start {stuck}")
                runs[route]["banded"] = banded.calls
            elif banded.calls:
                raise SystemExit(f"reader full {route}: a banded prior "
                                 "was built")
            log(f"reader_full_{route}", json.dumps(runs[route]))
    one = torch.empty(1, device="cuda")
    floor_ms = cuda_ms(lambda: one.zero_(), reps=50)
    runs["k2_site"] = reader_k2_site(store, floor_ms)
    data = probe.last_data
    L = int(IniConfig(ini)["Inputs"]["offset_length"])
    n = (data.tod.size // L) * L
    plan = pointing_plan(np.asarray(data.pixels[:n]), data.npix, L)
    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    runs["k3_sites"] = dict(k3_sites(plan, 4, g, "ini4_"),
                            **k3_sites(plan, 1, g, "ini1_"))
    runs["k4_site"] = k4_site(plan, g, floor_ms)
    log("reader_kernel_sites", json.dumps({k: runs[k] for k in (
        "k3_sites", "k4_site")}))
    return runs, joint_maps


# Phase H: astronomical calibration. The calibrator is the generator's
# TauA observation (its catalogue position, a 7 K source of 0.075 deg
# FWHM, a 1-degree azimuth throw): one scan spans the on-source extent
CAL_SOURCE = dict(source="TauA", source_amplitude_k=7.0,
                  source_fwhm_deg=0.075, az_throw=1.0, ra0=83.6331,
                  dec0=22.0145)
# the reference's end-to-end calibrator test (tests/test_calibration.py:184)
CAL_SMALL = dict(CAL_SOURCE, n_feeds=1, n_bands=2, n_channels=32, n_scans=5,
                 scan_samples=1500, vane_samples=250, seed=21)
# at full width, full_width_level1's F, B, C, vane and gaps with 5 scans of
# 6 000: T = 30 896 samples, about 10.3 min at 50 Hz
CAL_FULL = dict(CAL_SOURCE, n_scans=5, scan_samples=6000)
CAL_SEED = 21
# the bootstrap's and the chains' errors against the analytic ones on
# the full-width maps, the median ratio over the maps of the amplitude's
# and the centre's: the reference's own ratios on these maps (a fifth of
# the 120 x 120 pixels hit) are 18.5-19.8 for its bootstrap (which
# resamples hit and unhit pixels alike) and 1.8-1.9 for its chains
# (measured on the CPU, both packages, two maps of this calibrator at 16
# channels: the port's 18.8-20.0 and 1.8-2.0; over all 76 maps the
# port's 11.9-20.8 and 1.9-2.4). Held within a factor 3 of the
# reference's, as the noise falls with 1 024 channels
CAL_ERR_RATIO = {"bootstrap": (6.0, 60.0), "posterior": (0.6, 6.0)}


def calibration_config(root: str = ROOT) -> dict:
    """The shipped ``configuration.toml`` as shipped with ``"FitSource"``
    appended to its processes (the calibrator filelist and the cache are
    given to ``run_astro_cal`` as ``run_average`` gives them)."""
    cfg = shipped_chain_config(root)
    cfg["Global"]["processes"] = list(cfg["Global"]["processes"]) + [
        "FitSource"]
    return cfg


def check_source_fits(fits, amp_k: float, fwhm_deg: float, label: str):
    """The reference test's limits on every (feed, band) fit: amplitude
    within 0.5-1.5 of the injected ``amp_k``, the centre within 0.05 deg
    of the source, both widths within half a beam sigma of it."""
    fits = np.asarray(fits)
    sig = fwhm_deg / 2.355
    amp = fits[..., 0]
    bad = ~((amp > 0.5 * amp_k) & (amp < 1.5 * amp_k)
            & (np.abs(fits[..., 1]) < 0.05) & (np.abs(fits[..., 3]) < 0.05)
            & (np.abs(np.abs(fits[..., 2]) - sig) < 0.5 * sig)
            & (np.abs(np.abs(fits[..., 4]) - sig) < 0.5 * sig))
    if bad.any():
        raise SystemExit(f"{label}: fits outside the reference test's "
                         f"limits at (feed, band) {np.argwhere(bad).tolist()}"
                         f": {fits[bad].tolist()}")
    return {"amplitude": [float(amp.min()), float(amp.max())],
            "centre_max_deg": float(np.abs(fits[..., [1, 3]]).max()),
            "width_deg": [float(np.abs(fits[..., [2, 4]]).min()),
                          float(np.abs(fits[..., [2, 4]]).max())]}


def without_groups(store, prefixes):
    """An ``HDF5Store`` of ``store``'s datasets and attributes outside the
    groups that start with ``prefixes`` (arrays shared)."""
    from comapreduce_tpu_torch.data.hdf5io import HDF5Store

    out = HDF5Store()
    for k, v in store.items():
        if not k.split("/")[0].startswith(tuple(prefixes)):
            out[k] = v
    for g, kv in store.attr_items():
        for k, v in kv.items():
            out.set_attrs(g, k, v)
    return out


CAL_GROUPS = ("TauA_source_fit", "astro_calibration")


def calibration_runner(device, run_dir, on_stage=None, level2=None):
    """A :func:`memory_runner` on :func:`calibration_config` whose Level-2
    stores live in ``level2`` (path -> store), its run state under a
    fresh ``run_dir``."""
    shutil.rmtree(run_dir, ignore_errors=True)
    return memory_runner(device, calibration_config(), on_stage,
                         run_dir=run_dir,
                         level2={} if level2 is None else level2)


def calibration_passes(runner, level1: dict, calibrators, level2: dict,
                       targets=()):
    """``run_average``'s two passes with ``[Global] calibrator_filelist``,
    through memory: ``run_tod`` over ``level1`` (name -> Level-1 store,
    served), then ``run_astro_cal`` over the same files and ``targets``
    (name -> Level-1 store of a file whose Level-2 store ``level2``
    already holds) with the ``calibrators``' Level-2 paths, the database
    cached at ``<run dir>/cal.npz``. Returns the reduction's and the
    apply pass's results and the cache path."""
    from comapreduce_tpu_torch.pipeline.runner import level2_path

    cache = os.path.join(os.path.dirname(runner.output_dir), "cal.npz")
    served = dict(level1, **dict(targets))
    with ServedLevel1(served):
        reduced = runner.run_tod(list(level1))
        cal_l2 = [level2_path(runner.output_dir, f, runner.prefix)
                  for f in calibrators]
        with ServedLevel2(level2):
            applied = runner.run_astro_cal(list(served), cal_l2,
                                           cache_path=cache)
    return reduced, applied, cache


def phase_calibration_small(devices=("cuda", "cpu"), base=None):
    """Phase H, small: the reference test's TauA observation (F=1, B=2,
    C=32, 5 scans of 1 500) through the shipped chain plus ``FitSource``
    and then ``run_astro_cal``, on the card and on the CPU port: the fits
    within the reference test's limits on both, card against CPU within
    :func:`calibration_diffs`' limits and every other Level-2 dataset
    within :func:`level2_diffs`', K1 and K2 launched as derived (one scan
    chunk of the one feed: K1 once, K2 once in the reduction, once in
    Spikes and once in FitSource). Run state under ``base`` (default
    ``chiprun_out/calibration_small``), one directory a device."""
    from comapreduce_tpu_torch.data.synthetic import (SyntheticObsParams,
                                                      generate_level1_store)
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)

    p, store = generate_level1_store(SyntheticObsParams(**CAL_SMALL))
    name = "comap-0000021-taua.hd5"
    base = base or os.path.join(ROOT, "chiprun_out", "calibration_small")
    out, launches = {}, {}
    for i, dev in enumerate(devices):
        level2 = {}
        runner = calibration_runner(dev, os.path.join(base, f"{i}_{dev}"),
                                    level2=level2)
        masked_fill.launches = rolling_median_windows.launches = 0
        (lvl2,), (applied,), _ = calibration_passes(runner, {name: store},
                                                    [name], level2)
        launches[dev] = {"masked_fill": masked_fill.launches,
                         "rolling_median_windows":
                             rolling_median_windows.launches}
        if lvl2 is None or applied is not lvl2:
            raise SystemExit(f"calibration small {dev}: the passes gave "
                             f"{lvl2}, {applied}")
        out[dev] = lvl2
        check_source_fits(lvl2["TauA_source_fit/fits"], p.source_amplitude_k,
                          p.source_fwhm_deg, f"calibration small {dev}")
    want = {"masked_fill": 1, "rolling_median_windows": 3}
    if devices[0] == "cuda" and launches["cuda"] != want:
        raise SystemExit(f"calibration small launches {launches['cuda']}, "
                         f"not {want}")
    card, cpu = out[devices[0]], out[devices[1]]
    try:
        cal = check_calibration(card, cpu, "calibration small")
        rest = check_level2(without_groups(card, CAL_GROUPS),
                            without_groups(cpu, CAL_GROUPS),
                            "calibration small", fit_loss=noise_fit_losses)
    except AssertionError as err:
        raise SystemExit(str(err))
    good = np.asarray(card["astro_calibration/calibration_good"])
    line = {"launches": launches[devices[0]], "calibration": cal,
            "level2_max_diff": rest, "good": good.tolist(),
            "factors": np.asarray(
                card["astro_calibration/calibration_factors"]).tolist()}
    log("calibration_small", json.dumps(line))
    return line


def fitsource_walls(stage, data, lvl2, device) -> dict:
    """``FitSource``'s binning and its three error estimates on the stage's
    own maps, each wall synchronised: the bin (K2's high-pass and the
    ``index_add_`` of every map), the analytic LM fit of all maps, the
    bootstrap (64 replicas a map, one batch) and the Metropolis chains (8
    walkers a map, 1 500 steps). The bootstrap's and the chains' errors
    must be finite and, as a median over the maps, within CAL_ERR_RATIO
    of the analytic ones for the amplitude and the centre."""
    import torch

    from comapreduce_tpu_torch.calibration.source_fit import fit_source_maps

    def synced():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = synced()
    maps, wmaps, wcs, _ = stage.source_maps(data, lvl2)
    walls = {"bin_s": synced() - t0}
    errors = {}
    for ef in ("analytic", "bootstrap", "posterior"):
        t0 = synced()
        _, errors[ef], _ = fit_source_maps(maps, wmaps, wcs,
                                           stage.beam_fwhm_deg,
                                           error_func=ef)
        walls[f"{ef}_s"] = synced() - t0
    ratios = {}
    for ef in ("bootstrap", "posterior"):
        e = errors[ef]
        if not np.isfinite(e).all():
            raise SystemExit(f"FitSource {ef}: non-finite errors at "
                             f"{np.argwhere(~np.isfinite(e)).tolist()[:8]}")
        r = np.median(e[..., [0, 1, 3]].reshape(-1, 3)
                      / errors["analytic"][..., [0, 1, 3]].reshape(-1, 3),
                      axis=0)
        ratios[ef] = r.tolist()
        lo, hi = CAL_ERR_RATIO[ef]
        if not ((r > lo) & (r < hi)).all():
            raise SystemExit(f"FitSource {ef}: errors {r} of the analytic")
    return {"maps": list(maps.shape), "walls": walls,
            "error_ratio_median": ratios}


def fitsource_k2_site(lvl2, floor_ms: float, window: int = 401) -> dict:
    """K2 at FitSource's high-pass (:func:`k2_site`): every (feed, band)
    row of the calibrator's averaged TOD, edge padded by (w - 1) / 2 on
    each side at window 401 (exact, odd)."""
    import torch

    from comapreduce_tpu_torch.ops.median_filter import _pad

    tod = torch.as_tensor(np.asarray(lvl2["averaged_tod/tod"], np.float32),
                          device="cuda")
    F, B, T = tod.shape
    w = min(window, max(3, T // 2 * 2 - 1))
    return k2_site(_pad(tod.reshape(F * B, T), (w - 1) // 2, w // 2,
                        "edge"), w, floor_ms, "FitSource high-pass")


def phase_calibration_full(field_store, field_name: str, joint_maps,
                           stage_log, device: str = "cuda", C: int = 1024,
                           field_level1=None):
    """Phase H, full width: a TauA calibrator at phase E's F=19, B=4,
    C=1024 (5 scans of 6 000, T = 30 896, one scan over the source), its
    TOD generated on the card per read with the source in its sky load,
    through ``Runner.run_tod`` on the shipped config plus ``FitSource``,
    then ``run_astro_cal`` onto itself and onto phase E's full-width field
    store (``field_store``, Level-1 name ``field_name``), then
    ``run_destriper.main``'s joint route on the shipped INI over the
    calibrated field store, where ``calibration : true`` acts.

    Checks: every product finite; the fits within the reference test's
    limits; factors finite and ``calibration_good`` for at least 90% of
    (feed, band); the ``.npz`` cache written and read back equal; the
    field store's ``astro_calibration/*`` present with TauA the nearest
    source; K1 and K2 launched as derived in the calibrator chain (one
    scan chunk a feed: K1 F, K2 F + 1 in Spikes + 1 in FitSource) and in
    the map run (K2 once a band, K3 as derived, no K1 or K4); the
    calibrated maps finite on hit pixels, hits equal to phase F's joint
    route's (``joint_maps``) where every feed is good (no more than them
    otherwise), the destriped maps not equal to phase F's; the bootstrap
    and chain errors (:func:`fitsource_walls`); K2 at FitSource's site and
    K1/K2 at the calibrator's single-scan length against their plain
    versions. ``device``/``C``/``field_level1`` let the same phase run on
    the CPU at fewer channels (no kernel sites or memory peaks there)."""
    import torch

    from comapreduce_tpu_torch.calibration.apply_cal import \
        CalibratorDatabase
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.ops.reduce import (device_hbm_bytes,
                                                  plan_reduce_memory,
                                                  scan_starts_lengths)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p, data, tod = full_width_level1(seed=CAL_SEED, C=C, device=device,
                                     **CAL_FULL)
    if field_level1 is None:
        # the apply pass reads the field's Level-1 file again (its MJD)
        _, field_level1, _ = full_width_level1(C=C, device=device)
    setup_s = time.perf_counter() - t0
    F, B, _, T = tod.shape
    edges = np.asarray(data.scan_edges)
    S = len(edges)
    _, _, L = scan_starts_lengths(edges)
    cfg = calibration_config()
    fb = int(cfg["Level1AveragingGainCorrection"]["feed_batch"])
    k = plan_reduce_memory(fb, B, C, T, S, L, None,
                           hbm_bytes=device_hbm_bytes(device=device))
    k_eff = S if k is None else k
    name = "comap-taua-fullwidth.hd5"
    stages = []

    def on_stage(lvl2):
        if on_card:
            torch.cuda.synchronize()
        sname = list(runner.timings)[-1]
        prev = stages[-1] if stages else {"read_s": 0.0, "k1": 0, "k2": 0}
        done = {"read_s": tod.read_s, "k1": masked_fill.launches,
                "k2": rolling_median_windows.launches}
        stages.append(dict(
            done, stage=sname, wall_s=runner.timings[sname][-1],
            stage_read_s=done["read_s"] - prev["read_s"],
            k1_launches=done["k1"] - prev["k1"],
            k2_launches=done["k2"] - prev["k2"],
            peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if on_card else None)))
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    from comapreduce_tpu_torch.pipeline.runner import level2_path

    level2 = {}
    runner = calibration_runner(device, os.path.join(
        ROOT, "chiprun_out", "calibration_full"), on_stage, level2)
    field_l2 = level2_path(runner.output_dir, field_name, runner.prefix)
    level2[field_l2] = field_store
    for fn in (masked_fill, rolling_median_windows):
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (lvl2,), applied, cache = calibration_passes(
        runner, {name: data}, [name], level2, {field_name: field_level1})
    passes_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches
                for fn in (masked_fill, rolling_median_windows)}
    if lvl2 is None or len(applied) != 2 or any(a is None for a in applied):
        raise SystemExit(f"calibration full: the passes gave {lvl2}, "
                         f"{applied}")
    for key in lvl2.keys():
        v = np.asarray(lvl2[key])
        if key.endswith("fnoise_fit_parameters"):
            v = v[~np.isnan(v[..., 0])]
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise SystemExit(f"calibration full: non-finite {key}")
    fits = check_source_fits(lvl2["TauA_source_fit/fits"],
                             p.source_amplitude_k, p.source_fwhm_deg,
                             "calibration full")
    want = {"masked_fill": F * -(-S // k_eff),
            "rolling_median_windows": F * -(-S // k_eff) + 2}
    if on_card and launches != want:
        raise SystemExit(f"calibration full launches {launches}, not "
                         f"{want}")
    factors = np.asarray(lvl2["astro_calibration/calibration_factors"])
    good = np.asarray(lvl2["astro_calibration/calibration_good"]) > 0
    if not (np.isfinite(factors).all() and good.mean() >= 0.9):
        raise SystemExit(f"calibration full: factors {factors.tolist()}, "
                         f"good {good.tolist()}")
    # the cache holds what a fresh harvest of the calibrator store gives
    db = CalibratorDatabase()
    db.add_level2(lvl2)
    back = CalibratorDatabase.load(cache)
    if [e[:2] for e in back.entries] != [e[:2] for e in db.entries] or \
            not all(np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
                    for a, b in zip(back.entries, db.entries)):
        raise SystemExit("calibration full: the cache does not read back")
    if not field_store.contains_groups(["astro_calibration"]) or \
            field_store.attrs("astro_calibration", "source") != "TauA" or \
            np.asarray(field_store[
                "astro_calibration/calibration_factors"]).shape != (F, B):
        raise SystemExit("calibration full: the field store was not "
                         "calibrated by TauA")
    line = {"shape": [F, B, C, T], "n_scans": S, "L": L,
            "scan_batch_planned": k, "setup_s": setup_s,
            "passes_s": passes_s, "read_s": tod.read_s, "reads": tod.reads,
            "stages": stages, "launches": launches, "fits": fits,
            "good_share": float(good.mean()),
            "factor_range": [float(factors.min()), float(factors.max())],
            "cache_entries": len(back.entries)}
    log("calibration_full", json.dumps(line))
    fit_stage = runner.processes[-1]
    line["fitsource"] = fitsource_walls(fit_stage, data, lvl2, device)
    log("calibration_fitsource", json.dumps(line["fitsource"]))
    line["map"] = calibrated_map_run(field_store, field_name, joint_maps,
                                     good, stage_log, device)
    if on_card:
        one = torch.empty(1, device="cuda")
        floor_ms = cuda_ms(lambda: one.zero_(), reps=50)
        line["k2_fitsource_site"] = fitsource_k2_site(lvl2, floor_ms)
        window = min(int(cfg["Level1AveragingGainCorrection"][
            "medfilt_window"]), L)
        line["sites"] = _site_kernels(k_eff * B * C, L, k_eff * B, window,
                                      (F * B, T), int(cfg["Spikes"][
                                          "window"]))
    return line, lvl2


def calibrated_map_run(field_store, field_name: str, joint_maps, good,
                       stage_log, device: str = "cuda") -> dict:
    """``run_destriper.main``'s joint route on the shipped INI as shipped
    (``calibration : true``) over the calibrated field store, served as
    phase F serves it: the four maps read back bitwise, finite on hit
    pixels, hits equal to phase F's joint route's (``joint_maps``) when
    every (feed, band) is ``calibration_good`` (``good``) and no more than
    them otherwise, the destriped maps unlike phase F's; K2 once a band,
    K3 as :func:`k3_launches` derives, no K1 or K4; per band the read,
    solve and write walls, iterations and residual."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)

    on_card = torch.device(device).type == "cuda"
    name = "Level2_" + field_name
    out = os.path.join(ROOT, "chiprun_out", "calibrated_map")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    filelist = os.path.join(out, "l2list.txt")
    with open(filelist, "w") as fh:
        fh.write(name + "\n")
    ini = shipped_destriper_ini(filelist, os.path.join(out, "joint"),
                                os.path.join(out, "joint.ini"),
                                log_dir=os.path.join(out, "logs"))
    counters = (masked_fill, rolling_median_windows, binned_window_sum,
                windowed_gather)
    stage_log.clear()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    with ServedLevel2({name: field_store}), MainProbe(device) as probe:
        if rd_main([ini] + ([] if on_card else ["--device=cpu"])) != 0:
            raise SystemExit("calibrated map: main failed")
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    nx, ny = SHIPPED_FIELD[2]
    files = check_written(probe, (ny, nx))
    n_band = len(probe.writes)
    want = {"masked_fill": 0, "rolling_median_windows": n_band,
            "binned_window_sum": probe.k3_want(), "windowed_gather": 0}
    if n_band != 4 or (on_card and launches != want):
        raise SystemExit(f"calibrated map: launches {launches}, derived "
                         f"{want} over {n_band} bands")
    bands = []
    for b, w in enumerate(probe.writes):
        m = w["maps"]
        hit = m["HITS"] > 0
        ref = joint_maps[b]
        same_hits = np.array_equal(m["HITS"], ref["HITS"]) if good.all() \
            else bool((m["HITS"] <= ref["HITS"]).all())
        moved = float(np.abs(m["DESTRIPED"][hit]
                             - ref["DESTRIPED"][hit]).max())
        if not (hit.any() and same_hits and moved > 0
                and np.isfinite(m["DESTRIPED"][hit]).all()
                and np.isfinite(m["NAIVE"][hit]).all()):
            raise SystemExit(f"calibrated map band {b}: hits as phase F's "
                             f"{same_hits}, moved {moved}, or non-finite "
                             "maps on hit pixels")
        bands.append({"band": b, "n_iter": w["n_iter"],
                      "residual": w["residual"], "write_s": w["write_s"],
                      "hit_pixels": int(hit.sum()),
                      "max_change_from_phase_f": moved})
    for b, r in zip(bands, probe.reads):
        b.update(read_s=r["read_s"], samples=r["samples"])
    line = {"wall_s": wall, "bands": bands,
            "solve_s": [s["solve_s"] for s in probe.solves],
            "cg_solves": probe.cg, "launches": launches, "files": files,
            "warnings": stage_log.warnings[:8],
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                             if on_card else None),
            "nvidia_smi": smi_line() if on_card else None}
    log("calibrated_map", json.dumps(line))
    return line


# Phase I: the ingest tier and bf16 TOD streaming, on phase E's, F's and
# H's observations and served stores. The served names are real
# placeholder files of a fixed mtime: the block cache keys a file on its
# path and mtime (``ingest.cache.file_key``)
INGEST_DIR = os.path.join(ROOT, "chiprun_out", "ingest")
# the reference's bf16 stream tolerance (tests/test_precision.py:36-37):
# one bf16 rounding per sample (eps 7.8e-3)
BF16_RTOL = BF16_ATOL = 2e-2
# the eight feed-batch blocks of check 5: 2 feeds x 4 bands x 1024
# channels x 13 568 samples, f32 (445 MB each)
H2D_BLOCK = (2, 4, 1024, 13_568)
H2D_BLOCKS = 8
# K1 launches on each received block while the next one copies (about
# 20 ms of K1 at 0.5 ms a launch, comparable to one block's copy)
H2D_K1_REPS = 40


class RssPeak:
    """The process's resident set, sampled every ``period_s`` on a thread
    for the ``with`` block: ``start_gib`` and ``peak_gib``."""

    def __init__(self, period_s: float = 0.05):
        self.period_s = period_s
        self.start_gib = self.peak_gib = 0.0

    @staticmethod
    def rss_gib() -> float:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30

    def _sample(self):
        while not self._stop.wait(self.period_s):
            self.peak_gib = max(self.peak_gib, self.rss_gib())

    def __enter__(self):
        import threading

        self.start_gib = self.peak_gib = self.rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, self.rss_gib())


def served_paths(names, directory: str = INGEST_DIR) -> dict:
    """name -> a placeholder file ``<directory>/served/<name>`` with a
    fixed mtime, for each served name."""
    d = os.path.join(directory, "served")
    os.makedirs(d, exist_ok=True)
    out = {}
    for n in names:
        path = os.path.join(d, os.path.basename(n))
        with open(path, "wb") as fh:
            fh.write(b"served from memory\n")
        os.utime(path, ns=(10**18, 10**18))
        out[n] = path
    return out


def run_diffs(got, want, label: str, bitwise: bool = False) -> dict:
    """Two runs of one chain, their Level-2 stores with the same datasets:
    those not bitwise equal, each held within :func:`level2_diffs`'
    limits, the noise fits within DEGENERATE_FIT_SIGMAS (the limit of a
    fit on a flat surface). ``bitwise=True`` (phase I's run against phase
    E's: one card, the same inputs) allows no dataset to differ: the
    chain's binnings add in a fixed order (``ops/segment.py``), so its
    products are the same bits from run to run. The card against the CPU
    (``bitwise=False``) sums in other orders, and on these white TOD the
    noise fits move with the order alone: bf16 TOD (its rounding the size
    of the per-sample fluctuation) gave 0.955 standard errors card against
    CPU on the pipeline test's observation (measured on one H100 80GB
    HBM3 at 700 W). Returns ``{name: measure}`` of the datasets that are
    not bitwise; raises ``SystemExit`` naming them past a limit."""
    if sorted(got.keys()) != sorted(want.keys()):
        raise SystemExit(f"{label}: datasets {sorted(got.keys())} against "
                         f"{sorted(want.keys())}")
    loose = [name for name in sorted(want.keys())
             if np.asarray(got[name]).tobytes() !=
             np.asarray(want[name]).tobytes()
             or np.asarray(got[name]).dtype != np.asarray(want[name]).dtype]
    diffs = level2_diffs(got, want)
    limits = {k: DEGENERATE_FIT_SIGMAS if k.endswith("fnoise_fit_parameters")
              else diffs[k][1] for k in loose}
    bad = {k: (diffs[k][0], limits[k]) for k in loose
           if bitwise or not diffs[k][0] <= limits[k]}
    if bad:
        raise SystemExit(f"{label}: Level-2 datasets past their limits "
                         f"(measure, limit): {bad}")
    return {k: diffs[k][0] for k in loose}


def phase_ingest_calibration(cal_store, device: str = "cuda", **obs):
    """Phase I.2, H-cache: phase H's full-width TauA calibrator (T =
    30 896) through ``run_average``'s two passes with ``[ingest] cache_mb``
    large enough to hold its TOD, the apply pass (``run_astro_cal``) over
    the calibrator alone. Pass 1 must read the served TOD once (eagerly:
    a cache is set); the apply pass must be served from the cache (1 miss,
    1 hit, no read). FitSource's fits and the factors must equal phase H's
    uncached run's (``cal_store``) bitwise, else be held within
    :func:`calibration_diffs`' limits and reported. Records both passes'
    walls and reads, and the host's peak RSS. ``device`` and ``obs``
    (:func:`full_width_level1`'s knobs) let the check run on the CPU at
    a smaller shape."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.pipeline.runner import level2_path

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    p, data, tod = full_width_level1(device=device,
                                     **dict(CAL_FULL, seed=CAL_SEED, **obs))
    counters = (masked_fill, rolling_median_windows)
    for fn in counters:
        fn.launches = 0
    (path,) = served_paths(["comap-taua-fullwidth.hd5"]).values()
    cfg = calibration_config()
    tod_bytes = int(np.prod(tod.shape)) * 4
    cfg["ingest"] = {"cache_mb": (tod_bytes >> 20) + 1024}
    run_dir = os.path.join(INGEST_DIR, "calibration")
    shutil.rmtree(run_dir, ignore_errors=True)
    level2 = {}
    runner = memory_runner(device, cfg, run_dir=run_dir, level2=level2)
    cal_l2 = level2_path(runner.output_dir, path, runner.prefix)
    with ServedLevel1({path: data}) as served, RssPeak() as rss:
        t0 = time.perf_counter()
        (lvl2,) = runner.run_tod([path])
        if on_card:
            torch.cuda.synchronize()
        pass1_s = time.perf_counter() - t0
        stats1 = dict(runner._ingest_cache.stats)
        cached_bytes = runner._ingest_cache.current_bytes
        with ServedLevel2(level2):
            t0 = time.perf_counter()
            (applied,) = runner.run_astro_cal(
                [path], [cal_l2], cache_path=os.path.join(run_dir, "cal.npz"))
            if on_card:
                torch.cuda.synchronize()
            apply_s = time.perf_counter() - t0
    stats = dict(runner._ingest_cache.stats)
    launches = {fn.__name__: fn.launches for fn in counters}
    reads = runner.timings["ingest.read"]
    if lvl2 is None or applied is None:
        raise SystemExit(f"ingest calibration: the passes gave {lvl2}, "
                         f"{applied}")
    if served.calls != {path: 1} or tod.reads != 1 or \
            stats["misses"] != 1 or stats["hits"] != 1 or \
            stats1["misses"] != 1 or stats1["hits"] != 0:
        raise SystemExit(f"ingest calibration: served reads "
                         f"{served.calls}, TOD reads {tod.reads}, cache "
                         f"after pass 1 {stats1}, after the apply pass "
                         f"{stats}")
    bitwise = all(np.asarray(lvl2[k]).tobytes() ==
                  np.asarray(cal_store[k]).tobytes()
                  for k in cal_store.keys()
                  if k.split("/")[0] in CAL_GROUPS)
    diffs = None if bitwise else check_calibration(lvl2, cal_store,
                                                   "ingest calibration")
    line = {"shape": list(tod.shape), "pass1_s": pass1_s,
            "apply_s": apply_s, "pass1_read_s": reads[-2],
            "apply_read_s": reads[-1], "tod_read_s": tod.read_s,
            "tod_reads": tod.reads, "cache_after_pass1": stats1,
            "cache": stats, "cached_bytes": cached_bytes,
            "tod_bytes": tod_bytes,
            "fits_bitwise": bitwise, "calibration_diffs": diffs,
            "launches": launches, "rss_peak_gib": rss.peak_gib,
            "nvidia_smi": smi_line() if on_card else None}
    runner._ingest_cache.clear()
    log("ingest_calibration", json.dumps(line))
    return line


def phase_ingest_reader(store, joint_maps, stage_log, device: str = "cuda"):
    """Phase I.3, F-ingest: phase F's joint route (``main`` on the shipped
    INI over phase E's full-width Level-2 store) with ``[Inputs] prefetch
    = 1``, ``cache_mb`` large enough for the store, ``writeback = 2`` and
    ``[Precision] tod_dtype = bf16``. The file must be decoded once and
    hit three times (four band reads); the maps written on the writeback
    must read back bitwise; the maps must lie within the reference's bf16
    tolerance (``BF16_RTOL``/``BF16_ATOL``) of phase F's f32 joint maps
    (``joint_maps``) on hit pixels, with the same hits; K2 once a band,
    K3 as derived, no K1 or K4. The store is served without the
    calibration groups phase H added to it, as phase F read it. Records
    the cached bytes beside the f32 payload's. ``device="cpu"`` runs
    ``main`` with ``--device=cpu`` (no launches counted)."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.ingest.cache import payload_nbytes
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)

    store = without_groups(store, CAL_GROUPS)
    out = os.path.join(INGEST_DIR, "reader")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    (path,) = served_paths(["Level2_comap-fullwidth.hd5"]).values()
    filelist = os.path.join(out, "l2list.txt")
    with open(filelist, "w") as fh:
        fh.write(path + "\n")
    f32_bytes = payload_nbytes(store.export_payload())
    ini = shipped_destriper_ini(
        filelist, os.path.join(out, "joint"), os.path.join(out, "joint.ini"),
        log_dir=os.path.join(out, "logs"), prefetch=1,
        cache_mb=(f32_bytes >> 20) + 256, writeback=2,
        sections={"Precision": {"tod_dtype": "bf16"}})
    counters = (masked_fill, rolling_median_windows, binned_window_sum,
                windowed_gather)
    on_card = torch.device(device).type == "cuda"
    stage_log.clear()
    if on_card:
        torch.cuda.empty_cache()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    with ServedLevel2({path: store}) as served, MainProbe(device) as probe:
        if rd_main([ini] + ([] if on_card else ["--device=cpu"])) != 0:
            raise SystemExit("ingest reader: main failed")
    wall = (_synced() if on_card else time.perf_counter()) - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    nx, ny = SHIPPED_FIELD[2]
    files = check_written(probe, (ny, nx))
    n_band = len(probe.writes)
    want = {"masked_fill": 0, "rolling_median_windows": n_band,
            "binned_window_sum": probe.k3_want(), "windowed_gather": 0}
    stats = probe.cache_stats[-1] if probe.cache_stats else {}
    if n_band != 4 or (on_card and launches != want) or \
            served.calls != {path: 1} or \
            stats.get("misses") != 1 or stats.get("hits") != 3 or \
            not all(w.get("queued") and w["write_s"] is not None
                    for w in probe.writes):
        raise SystemExit(f"ingest reader: launches {launches}, derived "
                         f"{want} over {n_band} bands; decoded "
                         f"{served.calls}, cache {stats}; writes "
                         f"{[w.get('write_s') for w in probe.writes]}")
    bands = []
    for b, w in enumerate(probe.writes):
        m, ref = w["maps"], joint_maps[b]
        hit = ref["HITS"] > 0
        if not np.array_equal(m["HITS"], ref["HITS"]):
            raise SystemExit(f"ingest reader band {b}: hits differ from "
                             "phase F's")
        worst = {}
        for k in ("DESTRIPED", "NAIVE"):
            a, r = m[k][hit], ref[k][hit]
            excess = np.abs(a - r) - (BF16_ATOL + BF16_RTOL * np.abs(r))
            worst[k] = {"max_abs_diff": float(np.abs(a - r).max()),
                        "scale": float(np.abs(r).max()),
                        "max_excess": float(excess.max())}
            if not (np.isfinite(a).all() and excess.max() <= 0):
                raise SystemExit(f"ingest reader band {b}: {k} past the "
                                 f"bf16 tolerance of phase F's: {worst[k]}")
        bands.append({"band": b, "n_iter": w["n_iter"],
                      "residual": w["residual"], "write_s": w["write_s"],
                      "vs_phase_f": worst})
    for b, r in zip(bands, probe.reads):
        b.update(read_s=r["read_s"])
    line = {"wall_s": wall, "bands": bands,
            "solve_s": [s["solve_s"] for s in probe.solves],
            "launches": launches, "cache": stats,
            "cached_bytes": probe.cache_bytes[-1], "f32_payload_bytes":
                f32_bytes, "cached_share_of_f32":
                probe.cache_bytes[-1] / f32_bytes,
            "files": files, "warnings": stage_log.warnings[:8],
            "nvidia_smi": smi_line() if on_card else None}
    log("ingest_reader", json.dumps(line))
    return line


def phase_ingest_small(devices=("cuda", "cpu")):
    """Phase I.4: the pipeline test's observation (F=2, B=2, C=32) through
    the shipped chain with ``prefetch = 2``, ``cache_mb`` and ``tod_dtype
    = bf16`` on the card and on the CPU: the narrowed payload bits (the
    cached Level-1 TOD) equal on both, the Level-2 stores held by
    :func:`run_diffs`, K1 and K2 launched as in phase E's small run. ``devices`` (card, CPU) may name the CPU twice."""
    from comapreduce_tpu_torch.data.synthetic import generate_level1_store
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.ops.precision import BF16Array

    _, store = generate_level1_store(pipeline_test_params())
    (path,) = served_paths(["comap-0000007.hd5"]).values()
    out, bits = {}, {}
    launches = None
    for i, dev in enumerate(devices):
        cfg = shipped_chain_config()
        cfg["ingest"] = {"prefetch": 2, "cache_mb": 64}
        cfg["precision"] = {"tod_dtype": "bf16"}
        run_dir = os.path.join(INGEST_DIR, f"small_{i}_{dev}")
        shutil.rmtree(run_dir, ignore_errors=True)
        runner = memory_runner(dev, cfg, run_dir=run_dir)
        masked_fill.launches = rolling_median_windows.launches = 0
        with ServedLevel1({path: store}):
            (out[i],) = runner.run_tod([path])
        if dev == "cuda":
            launches = {"masked_fill": masked_fill.launches,
                        "rolling_median_windows":
                            rolling_median_windows.launches}
        (payload, _), = runner._ingest_cache._entries.values()
        carrier = payload["data"]["spectrometer/tod"]
        if not isinstance(carrier, BF16Array):
            raise SystemExit(f"ingest small: the cached TOD is "
                             f"{type(carrier)}, not bf16")
        bits[i] = carrier.bits
    if out[0] is None or out[1] is None or \
            not np.array_equal(bits[0], bits[1]):
        raise SystemExit("ingest small: a run failed, or the narrowed "
                         "payloads differ between the card and the CPU")
    diffs = run_diffs(out[0], out[1], "ingest small")
    F = 2
    want = {"masked_fill": F, "rolling_median_windows": F + 1}
    if devices[0] == "cuda" and launches != want:
        raise SystemExit(f"ingest small launches {launches}, not {want}")
    line = {"max_diff": diffs, "launches": launches,
            "payload_bytes": int(bits[0].nbytes)}
    log("ingest_small", json.dumps(line))
    return line


def phase_ingest_h2d():
    """Phase I.5, ``ingest.prefetch_to_device``: eight feed-batch blocks
    (``H2D_BLOCK`` f32) from pinned buffers on a side stream, bitwise
    equal to ``.to("cuda")``, ``ingest.h2d.bytes`` (the telemetry stream)
    the bytes shipped; then two blocks under a bf16 ``cast`` (half the
    bytes, the carrier's bits). Walls of the copies alone, of
    ``H2D_K1_REPS`` K1 launches a block on the current stream alone, and
    of both together (what the side stream overlaps), and the host's and
    the card's widening of one bf16 block to f32."""
    import torch

    from comapreduce_tpu_torch.ingest import prefetch_to_device
    from comapreduce_tpu_torch.ops.cuda_median import masked_fill
    from comapreduce_tpu_torch.ops.precision import BF16Array
    from comapreduce_tpu_torch.telemetry.core import TELEMETRY

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    base = (40.0 + torch.randn(H2D_BLOCK, generator=g, device=dev)).cpu()
    blocks = [(base + float(i)).numpy() for i in range(H2D_BLOCKS)]
    rows = int(np.prod(H2D_BLOCK[:-1]))
    mask = torch.ones((rows, H2D_BLOCK[-1]), device=dev)
    tdir = os.path.join(INGEST_DIR, "h2d_telemetry")
    shutil.rmtree(tdir, ignore_errors=True)

    def shipped_bytes():
        with open(os.path.join(tdir, "events.rank0.jsonl")) as fh:
            events = [json.loads(x) for x in fh]
        return [e["value"] for e in events if e.get("kind") == "counter"
                and e.get("name") == "ingest.h2d.bytes"]

    def copies(work: bool, cast=None, n=H2D_BLOCKS):
        got = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in prefetch_to_device(blocks[:n], size=2, device=dev,
                                      cast=cast):
            if work:
                x = blk.view(rows, -1)
                for _ in range(H2D_K1_REPS):
                    masked_fill(x, mask)
            got.append(blk)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    copies(False, n=2)                  # the pinned buffers' first use
    TELEMETRY.configure(tdir, rank=0)
    try:
        got, copy_s = copies(False)
    finally:
        TELEMETRY.close()
    counted = shipped_bytes()
    for i, blk in enumerate(got):
        if not torch.equal(blk.view(torch.int32), torch.from_numpy(
                blocks[i]).to(dev).view(torch.int32)):
            raise SystemExit(f"ingest h2d: block {i} differs from .to()")
    if counted != [blocks[0].nbytes] * H2D_BLOCKS:
        raise SystemExit(f"ingest h2d: ingest.h2d.bytes {counted}")
    x = got[0].view(rows, -1)
    masked_fill.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(H2D_BLOCKS * H2D_K1_REPS):
        masked_fill(x, mask)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    del got
    _, both_s = copies(True)
    k1_launches = masked_fill.launches
    shutil.rmtree(tdir, ignore_errors=True)
    copies(False, cast=BF16Array.from_float, n=1)
    TELEMETRY.configure(tdir, rank=0)
    try:
        narrowed, bf16_s = copies(False, cast=BF16Array.from_float, n=2)
    finally:
        TELEMETRY.close()
    counted_bf16 = shipped_bytes()
    carriers = [BF16Array.from_float(b) for b in blocks[:2]]
    for blk, c in zip(narrowed, carriers):
        if blk.dtype != torch.bfloat16 or not torch.equal(
                blk.view(torch.int16).cpu(),
                torch.from_numpy(c.bits.view(np.int16))):
            raise SystemExit("ingest h2d: a bf16 block differs from its "
                             "carrier's bits")
    if counted_bf16 != [blocks[0].nbytes // 2] * 2:
        raise SystemExit(f"ingest h2d: bf16 ingest.h2d.bytes "
                         f"{counted_bf16}")
    t0 = time.perf_counter()
    np.asarray(carriers[0])
    widen_host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    BF16Array.from_float(blocks[0])
    narrow_host_ms = (time.perf_counter() - t0) * 1e3
    widen_card_ms = cuda_ms(lambda: narrowed[0].float(), reps=5)
    gb = blocks[0].nbytes * H2D_BLOCKS / 1e9
    line = {"block": list(H2D_BLOCK), "blocks": H2D_BLOCKS,
            "block_bytes": int(blocks[0].nbytes), "copy_s": copy_s,
            "copy_gb_per_s": gb / copy_s, "k1_alone_s": k1_s,
            "copy_with_k1_s": both_s,
            "overlap_share": (copy_s + k1_s - both_s) / min(copy_s, k1_s),
            "k1_launches": k1_launches, "h2d_bytes": counted,
            "bf16_h2d_bytes": counted_bf16, "bf16_copy_s_2_blocks": bf16_s,
            "narrow_host_ms": narrow_host_ms,
            "widen_host_ms": widen_host_ms, "widen_card_ms": widen_card_ms,
            "nvidia_smi": smi_line()}
    log("ingest_h2d", json.dumps(line))
    return line


def phase_ingest(serial_store, cal_store, joint_maps, stage_log) -> dict:
    """Phase I on the card: checks 2-5 (the functions above), each
    check's wall in its line."""
    out = {}
    for key, fn, args in (
            ("small", phase_ingest_small, ()),
            ("h2d", phase_ingest_h2d, ()),
            ("reader", phase_ingest_reader, (serial_store, joint_maps,
                                             stage_log)),
            ("calibration", phase_ingest_calibration, (cal_store,))):
        t0 = time.perf_counter()
        out[key] = fn(*args)
        out[key]["phase_s"] = time.perf_counter() - t0
    return out


# Phase G: the chaos drill over small observations, the card against the
# CPU port. A read error, a NaN burst in the Level-1 TOD and a first-read
# flake, each aimed at one observation by its name, with a fixed seed and
# a short backoff (the shipped 0.5 s base would only add waiting)
DRILL_SEEDS = (7, 8, 9, 10)
DRILL_INJECT = "read_error@0000008:1,nan_burst@0000009:1,flaky@0000010:1"
DRILL_KNOBS = {"inject": DRILL_INJECT, "inject_seed": 3,
               "retry_base_s": 0.01}
# the map-maker's drill: a NaN burst poured into one Level-2 read
DRILL_L2_INJECT = "nan_burst@0000009:1"


def drill_stores() -> dict:
    """The drill's Level-1 stores, each built as the reference pipeline
    test's observation (F=2, B=2, C=32, 3 scans of 600) from its seed."""
    from comapreduce_tpu_torch.data.synthetic import generate_level1_store

    p = pipeline_test_params()
    kw = {k: getattr(p, k) for k in ("n_feeds", "n_bands", "n_channels",
                                     "n_scans", "scan_samples",
                                     "vane_samples")}
    return {f"comap-{seed:07d}-000000.hd5": generate_level1_store(
        type(p)(**kw, seed=seed))[1] for seed in DRILL_SEEDS}


def drill_run(device, stores, run_dir, log_dir="logs", **resilience):
    """One ``run_tod`` over the drill's stores served from memory, the
    shipped config with ``resilience`` knobs added. Returns the results,
    the run's state (:func:`run_state`), the served loader's calls and
    the faults the chaos monkey fired."""
    cfg = shipped_chain_config()
    cfg["resilience"].update(resilience)
    cfg["Global"]["log_dir"] = log_dir
    runner = memory_runner(device, cfg, run_dir=run_dir)
    names = list(stores)
    with ServedLevel1(stores) as served:
        results = runner.run_tod(names)
    chaos = runner._resilience_runtime().chaos
    injected = sorted({(os.path.basename(f), k) for f, k in
                       (chaos.injected if chaos is not None else [])})
    return results, run_state(runner, names), served.calls, injected


def _quality_key(r):
    return (r["file"], r["feed"], r["band"], tuple(r["flags"]),
            tuple(sorted(r)))


def phase_drill(base=None, devices=("cuda", "cpu")):
    """Phase G: the chaos drill on the card and on the CPU port, then the
    map-maker over its Level-2 stores.

    1. ``run_tod`` over the four observations with ``DRILL_KNOBS`` on each
       device: the same ledger dispositions (the read error quarantined
       after 2 retries, the flake recovered after 1), the same quality
       records by (file, feed, band, flags, keys), the same results, and
       each Level-2 store within ``level2_diffs``' limits of the CPU's
       (noise fits held as ``check_level2(fit_loss=noise_fit_losses)``
       holds them);
       K1 and K2 launched on the card once per feed of each processed
       file (K2 once more in Spikes), none on the CPU.
    2. On the card, the same output directory again (its quarantine
       ledger) with a fresh state directory: the quarantined observation
       gets no loader call and no injected fault, and no result slot.
    3. On the card, the drill off and ``retry_quarantined``: the
       observation is re-admitted (a ``readmitted`` event) and reduced.
    4. ``run_destriper.main`` on the shipped INI over each device's
       Level-2 stores (of step 1), with ``[Slo] exclude_flagged = true``
       over that device's quality ledger keyed by the Level-2 files
       (:func:`level2_quality`) with seed 10's file flagged, and a NaN
       burst poured into one Level-2 read (``DRILL_L2_INJECT``): the
       flagged file dropped, the same files mapped, the
       same masked events (one a band read of the poisoned feed, the
       same sample count), maps within MAP_ATOL of scale and equal hits.
    ``devices`` are the device under test and the reference device
    (``("cpu", "cpu")`` checks the drill's logic without a card). Returns
    the report line."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger

    base = base or os.path.join(ROOT, "chiprun_out", "drill")
    shutil.rmtree(base, ignore_errors=True)
    stores = drill_stores()
    names = list(stores)
    quarantined = names[DRILL_SEEDS.index(8)]
    card, host = devices

    def synced():
        if card == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    runs, line = [], {}
    for i, dev in enumerate(devices):
        masked_fill.launches = rolling_median_windows.launches = 0
        t0 = synced()
        runs.append(drill_run(dev, stores, os.path.join(base, f"run{i}"),
                              **DRILL_KNOBS))
        line[f"run{i}_{dev}_wall_s"] = synced() - t0
        line[f"run{i}_{dev}_launches"] = {
            "masked_fill": masked_fill.launches,
            "rolling_median_windows": rolling_median_windows.launches}
    (res_c, st_c, calls_c, inj_c), (res_p, st_p, _, inj_p) = runs
    ok = [r is not None for r in res_c]
    want_ledger = [(quarantined, None, None, "quarantined", "transient",
                    2, "ingest.read"),
                   (names[3], None, None, "recovered", "transient", 1,
                    "ingest.read")]
    F = pipeline_test_params().n_feeds
    n_ok = sum(ok)
    launches = (line[f"run0_{card}_launches"],
                 line[f"run1_{host}_launches"])
    want_launches = ({"masked_fill": F * n_ok,
                      "rolling_median_windows": (F + 1) * n_ok}
                     if card == "cuda" else launches[1])
    if ok != [True, False, True, True] or \
            ok != [r is not None for r in res_p] or \
            st_c["ledger"] != st_p["ledger"] or \
            st_c["ledger"] != want_ledger or inj_c != inj_p or \
            launches[0] != want_launches or any(launches[1].values()):
        raise SystemExit(f"drill: results {ok}, ledgers {st_c['ledger']} "
                         f"/ {st_p['ledger']}, faults {inj_c} / {inj_p}, "
                         f"launches {line}")
    qc = sorted(map(_quality_key, st_c["quality"]))
    qp = sorted(map(_quality_key, st_p["quality"]))
    if qc != qp or len(qc) != n_ok * F * 2:
        raise SystemExit(f"drill: quality records differ: {qc} / {qp}")
    diffs = {}
    for name, a, b in zip(names, res_c, res_p):
        if a is not None:
            try:
                diffs[name] = check_level2(a, b, f"drill {name}",
                                           fit_loss=noise_fit_losses)
            except AssertionError as err:
                raise SystemExit(str(err))
    line.update(ledger=st_c["ledger"], injected=inj_c,
                quality_records=len(qc),
                quality_flagged=sum(r["flagged"] for r in st_c["quality"]),
                scheduler=st_c["scheduler"], loader_calls=calls_c,
                max_diff={n: {k: v for k, v in d.items() if v > 0}
                          for n, d in diffs.items()})
    # 2: the rerun skips the quarantined observation without a read
    res2, st2, calls2, inj2 = drill_run(
        card, stores, os.path.join(base, "run0"), log_dir="logs_rerun",
        **DRILL_KNOBS)
    if quarantined in calls2 or any(f == quarantined for f, _ in inj2) \
            or len(res2) != 3:
        raise SystemExit(f"drill rerun: calls {calls2}, faults {inj2}, "
                         f"{len(res2)} results")
    # 3: re-admitted with the drill off
    res3, st3, calls3, _ = drill_run(
        card, stores, os.path.join(base, "run0"), log_dir="logs_readmit",
        retry_quarantined=True)
    led = QuarantineLedger(os.path.join(base, "run0", "level2",
                                        "quarantine.jsonl"))
    readmitted = [e for e in led.entries if e.disposition == "readmitted"]
    if calls3.get(quarantined) != 1 or len(res3) != 4 or \
            any(r is None for r in res3) or len(readmitted) != 1 or \
            led.is_quarantined(quarantined):
        raise SystemExit(f"drill readmit: calls {calls3}, results "
                         f"{[r is None for r in res3]}, {readmitted}")
    line.update(rerun_loader_calls=calls2, readmit_loader_calls=calls3)
    # 4: the map-maker over each device's Level-2 stores
    maps, mapped = {}, {}
    excluded = f"Level2_{names[DRILL_SEEDS.index(10)]}"
    for i, (dev, results) in enumerate(((card, res_c), (host, res_p))):
        l2 = {f"Level2_{n}": r for n, r in zip(names, results)
              if r is not None}
        out = os.path.join(base, f"maps{i}")
        os.makedirs(out)
        filelist = os.path.join(out, "l2list.txt")
        with open(filelist, "w") as fh:
            fh.write("\n".join(sorted(l2)) + "\n")
        state = os.path.join(out, "state")
        level2_quality(os.path.join(base, f"run{i}", "logs"), state,
                       flag={excluded})
        ini = shipped_destriper_ini(
            filelist, out, os.path.join(out, "params.ini"), SMALL_FIELD,
            bands=[0, 1], log_dir=state,
            sections={"Slo": {"exclude_flagged": "true"},
                      "Resilience": {"inject": DRILL_L2_INJECT,
                                     "inject_seed": 3}})
        t0 = synced()
        with ServedLevel2(l2), MainProbe(dev) as probe:
            if rd_main([ini, f"--device={dev}"]) != 0:
                raise SystemExit(f"drill maps on {dev}: main failed")
        line[f"maps{i}_{dev}_wall_s"] = synced() - t0
        led = QuarantineLedger(os.path.join(out, "quarantine.jsonl"))
        mapped[i] = {
            "files": sorted(os.path.basename(f)
                            for f in probe.last_data.files),
            "masked": sorted((os.path.basename(e.unit["file"]),
                              e.unit["feed"], e.unit["band"], e.message)
                             for e in led.entries
                             if e.disposition == "masked"),
            "ledger": sorted((os.path.basename(e.unit["file"]),
                              e.disposition) for e in led.entries),
            "residual": [w["residual"] for w in probe.writes]}
        maps[i] = [w["maps"] for w in probe.writes]
    mc, mp = mapped[0], mapped[1]
    want_files = sorted(f"Level2_{n}" for n, r in zip(names, res_c)
                        if r is not None and f"Level2_{n}" != excluded)
    if mc["files"] != mp["files"] or mc["files"] != want_files or \
            mc["masked"] != mp["masked"] or \
            mc["ledger"] != mp["ledger"] or len(mc["masked"]) != 2 or \
            len(maps[0]) != 2:
        raise SystemExit(f"drill maps: card {mc} / CPU {mp}")
    diff = {"DESTRIPED": 0.0, "NAIVE": 0.0, "WEIGHTS": 0.0}
    for b, (g, w) in enumerate(zip(maps[0], maps[1])):
        if not np.array_equal(g["HITS"], w["HITS"]):
            raise SystemExit(f"drill maps band {b}: hit maps differ")
        scale = max(float(np.nanstd(w["DESTRIPED"])), 1.0)
        for k in diff:
            ref = float(np.abs(w[k]).max()) if k == "WEIGHTS" else scale
            d = float(np.abs(g[k] - w[k]).max()) / ref
            if not d <= MAP_ATOL:
                raise SystemExit(f"drill maps band {b}: {k} differs by "
                                 f"{d} of scale > {MAP_ATOL}")
            diff[k] = max(diff[k], d)
    line.update(mapped=mc, max_map_diff_of_scale=diff)
    synced()
    log("drill", json.dumps(line))
    return line


# Phase J: the last stages and stage options of run_average. SkyDip's
# observation: full width, one scan sweeping the elevation across 40-55
# deg (T = 15 040 samples, about 5 min at 50 Hz); its prior sky-nod
# (the same seed, so the same gains, an obsid before it, "sky nod" in
# its comment) without the 1/f gain stream, as the reference test's
# sky-nod is (tests/test_level1_averaging_skydip.py)
SKYDIP_OBS = dict(n_scans=1, scan_samples=14_400, elevation=47.5,
                  el_sweep=15.0)
SKYNOD_OBS = dict(SKYDIP_OBS, obsid=1_000_000, comment="sky nod",
                  sigma_g=0.0)
SKYDIP_DIR = os.path.join(ROOT, "chiprun_out", "skydip")
# the default mode's slope over the generator's gain against its
# t_atm_zenith, the median over every (feed, band, channel): the file's
# own 1/f gain stream (common to a feed's channels) correlates with the
# sweep and tilts each feed's slopes; SKYDIP_SLOPE_RTOL holds the median
# and SKYDIP_FEED_RTOL each feed's (measured on the CPU at 16 channels:
# the median 2.2e-3 off, the worst feed's median 1.1e-2)
SKYDIP_SLOPE_RTOL = 0.02
SKYDIP_FEED_RTOL = 0.05
# the sky-nod mode's slope (K per airmass, counts over the vane's gain)
# against t_atm_zenith, the median over every channel, within the
# reference test's 0.15: the vane's gain is (T_vane - T_sky) over
# (T_vane - 2.73) of the generator's, T_sky holding the atmosphere, so the
# slope in kelvin runs ~5% high (measured on the CPU at 16 channels:
# 5.7e-2)
SKYNOD_SLOPE_RTOL = 0.15
# the numpy oracle's stages (the reference registers no numpy
# AtmosphereRemoval; that stage runs on the oracle's device, the CPU)
ORACLE_STAGES = ("MeasureSystemTemperature", "Level1AveragingGainCorrection",
                 "Spikes", "Level2FitPowerSpectrum", "NoiseStatistics")


def skydip_config(root: str = ROOT) -> dict:
    """The shipped ``configuration.toml`` with ``"SkyDip"`` after the vane
    (its default mode: the file's own elevation coverage)."""
    cfg = shipped_chain_config(root)
    procs = list(cfg["Global"]["processes"])
    procs.insert(procs.index("MeasureSystemTemperature") + 1, "SkyDip")
    cfg["Global"]["processes"] = procs
    return cfg


def phase_skydip_full(device: str = "cuda", **obs):
    """Phase J.1: SkyDip at full width (F=19, B=4, C=1024, the TOD made
    on the card at each read) through ``Runner.run_tod`` in the shipped
    chain, with K1 and K2 counted as phase E counts them; the fits finite,
    their slope over the generator's gain within SKYDIP_SLOPE_RTOL of its
    ``t_atm_zenith`` (each feed's within SKYDIP_FEED_RTOL); the stage run
    again, its fits bitwise the chain's; then the sky-nod mode on the
    prior observation served from memory, its slope (in K) within
    SKYNOD_SLOPE_RTOL. Records the stage's walls and peak device memory.
    ``device`` and ``obs`` (:func:`full_width_level1`'s knobs) rehearse
    it on the CPU at a smaller shape."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.pipeline.stages import SkyDip

    on_card = torch.device(device).type == "cuda"

    def synced():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p, data, tod = full_width_level1(device=device, **dict(SKYDIP_OBS,
                                                          **obs))
    pn, nod, _ = full_width_level1(device=device, **dict(SKYNOD_OBS, **obs))
    setup_s = time.perf_counter() - t0
    F, B, C, T = tod.shape
    walls = {}

    def on_stage(lvl2):
        t = synced()
        name = list(runner.timings)[-1]
        walls[name] = {"wall_s": runner.timings[name][-1], "at": t}
        if on_card:
            walls[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()

    shutil.rmtree(SKYDIP_DIR, ignore_errors=True)
    runner = memory_runner(device, skydip_config(), on_stage,
                           run_dir=SKYDIP_DIR)
    name, nod_name = "comap-skydip.hd5", "comap-skynod.hd5"
    counters = (masked_fill, rolling_median_windows)
    for fn in counters:
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ServedLevel1({name: data}):
        results = runner.run_tod([name])
    chain_s = synced() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    if len(results) != 1 or results[0] is None:
        raise SystemExit(f"skydip full: run_tod gave {results}")
    lvl2 = results[0]
    if "SkyDip" not in walls or not lvl2.contains_groups(["skydip"]):
        raise SystemExit(f"skydip full: no skydip group (stages run: "
                         f"{list(walls)})")
    fits = np.asarray(lvl2["skydip/fits"])
    if fits.shape != (F, B, 2, C) or not np.isfinite(fits).all():
        raise SystemExit(f"skydip full: fits {fits.shape}, finite "
                         f"{np.isfinite(fits).mean()}")
    g_true = np.stack([tod.truth(f)[0] for f in range(F)])   # (F, B, C)
    ratio = fits[:, :, 1, :] / g_true / p.t_atm_zenith
    slope_err = float(abs(np.median(ratio) - 1.0))
    feed_err = float(np.abs(np.median(ratio, axis=(1, 2)) - 1.0).max())
    if not (slope_err < SKYDIP_SLOPE_RTOL and feed_err < SKYDIP_FEED_RTOL):
        raise SystemExit(f"skydip full: slope / gain off t_atm_zenith by "
                         f"{slope_err} (median), {feed_err} (worst feed)")
    want = {"masked_fill": F, "rolling_median_windows": F + 1}
    if on_card and launches != want:
        raise SystemExit(f"skydip full launches {launches}, not {want}")
    # the stage again on the same data: the same bits
    again = SkyDip(device=device)
    t0 = synced()
    if not again(data, lvl2):
        raise SystemExit("skydip full: the second run failed")
    again_s = synced() - t0
    fits2 = again.save_data[0]["skydip/fits"]
    if fits2.tobytes() != fits.tobytes():
        raise SystemExit(f"skydip full: two runs differ, max "
                         f"{np.abs(fits2 - fits).max()}")
    # the sky-nod mode: the prior observation through the loader
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    nod_stage = SkyDip(device=device, sky_nod_file=nod_name)
    t0 = synced()
    with ServedLevel1({nod_name: nod}) as served:
        ok = nod_stage(data, lvl2)
    nod_s = synced() - t0
    nod_peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    nod_fits, nod_attrs = nod_stage.save_data
    if not ok or served.calls != {nod_name: 1} or \
            nod_attrs.get("skydip", {}).get("sky_nod_obsid") != pn.obsid:
        raise SystemExit(f"skydip full: sky-nod mode gave {ok}, reads "
                         f"{served.calls}, attrs {nod_attrs}")
    nod_fits = nod_fits["skydip/fits"]
    nod_err = float(abs(np.median(nod_fits[:, :, 1, :]) / pn.t_atm_zenith
                        - 1.0))
    if not (np.isfinite(nod_fits).all() and nod_err < SKYNOD_SLOPE_RTOL):
        raise SystemExit(f"skydip full: sky-nod slope off t_atm_zenith by "
                         f"{nod_err}")
    line = {"shape": [F, B, C, T], "setup_s": setup_s, "chain_s": chain_s,
            "stages": {k: {kk: vv for kk, vv in v.items() if kk != "at"}
                       for k, v in walls.items()},
            "skydip_again_s": again_s, "skynod_s": nod_s,
            "skynod_peak_gib": nod_peak, "launches": launches,
            "slope_median_err": slope_err, "slope_worst_feed_err": feed_err,
            "skynod_slope_err": nod_err, "bitwise_rerun": True,
            "nvidia_smi": smi_line() if on_card else None}
    log("skydip_full", json.dumps(line))
    return line


def oracle_config(root: str = ROOT) -> dict:
    """The shipped chain with ``backend = "numpy"`` on every stage that
    has the f64 host oracle (``ORACLE_STAGES``), less the options only
    the device stage takes (the reduction's ``feed_batch``: the numpy
    stage, as the reference's, streams feed by feed and has none)."""
    from comapreduce_tpu_torch.pipeline.registry import resolve

    cfg = shipped_chain_config(root)
    for name in ORACLE_STAGES:
        fields = type(resolve(name, backend="numpy")).__dataclass_fields__
        cfg[name] = dict({k: v for k, v in cfg.get(name, {}).items()
                          if k in fields}, backend="numpy")
    return cfg


def oracle_diffs(got, want) -> dict:
    """A device run's Level-2 store against the numpy oracle's at the
    reference's backend tolerances (``tests/test_numpy_backend.py:78``,
    ``:167``, ``:178``): the vane's validity equal and its Tsys within
    rtol 1e-3; the averaged TOD within 2% of its scale at the median and
    50% at worst; spike masks differing on under 2% of samples; auto_rms
    within rtol 1e-3; each noise fit's model at 1, 3, 8 and 20 Hz within
    rtol 0.35. Returns ``{check: (measure, limit)}``."""
    out = {}
    tt = np.asarray(got["vane/system_temperature"], np.float64)
    tn = np.asarray(want["vane/system_temperature"], np.float64)
    ok = tn > 0
    out["vane_validity"] = (float(((tt > 0) != ok).mean()), 0.0)
    out["vane_tsys_rtol"] = (float((np.abs(tt - tn)[ok] / tn[ok]).max()),
                             1e-3)
    a = np.asarray(got["averaged_tod/tod"], np.float64)
    b = np.asarray(want["averaged_tod/tod"], np.float64)
    err = np.abs(a - b) / max(b.std(), 1e-12)
    out["tod_median"] = (float(np.median(err)), 0.02)
    out["tod_max"] = (float(err.max()), 0.5)
    out["spike_flips"] = (float((np.asarray(got["spikes/spike_mask"]) !=
                                 np.asarray(want["spikes/spike_mask"]))
                                .mean()), 0.02)
    nu = np.array([1.0, 3.0, 8.0, 20.0])
    for grp in ("fnoise_fits", "noise_statistics"):
        ra = np.asarray(got[f"{grp}/auto_rms"], np.float64)
        rb = np.asarray(want[f"{grp}/auto_rms"], np.float64)
        out[f"{grp}_auto_rms_rtol"] = (float((np.abs(ra - rb) / rb).max()),
                                       1e-3)
        knee = grp == "noise_statistics"
        ma = noise_model(got[f"{grp}/fnoise_fit_parameters"], nu, knee)
        mb = noise_model(want[f"{grp}/fnoise_fit_parameters"], nu, knee)
        out[f"{grp}_curve_rtol"] = (float((np.abs(ma - mb) / mb).max()),
                                    0.35)
    return out


def phase_oracle(devices=("cuda", "cpu")):
    """Phase J.2: the pipeline test's observation through the shipped
    chain with ``backend = "numpy"`` (the f64 host oracle, on
    ``devices[1]``) and on the card (``devices[0]``), held by
    :func:`oracle_diffs`; K1 and K2 launched once per feed (K2 once more
    in Spikes) on the card, none in the oracle run."""
    from comapreduce_tpu_torch.backends import stages_numpy
    from comapreduce_tpu_torch.data.synthetic import generate_level1_store
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)

    _, store = generate_level1_store(pipeline_test_params())
    out, launches, walls = {}, {}, {}
    for run, dev, cfg in (("oracle", devices[1], oracle_config()),
                          ("card", devices[0], shipped_chain_config())):
        runner = memory_runner(dev, cfg, run_dir=os.path.join(
            ROOT, "chiprun_out", f"oracle_{run}"))
        numpy_stages = [type(s).__name__ for s in runner.processes
                        if type(s).__module__ == stages_numpy.__name__]
        if (run == "oracle") != bool(numpy_stages):
            raise SystemExit(f"oracle: the {run} run has numpy stages "
                             f"{numpy_stages}")
        masked_fill.launches = rolling_median_windows.launches = 0
        t0 = time.perf_counter()
        out[run] = runner._run_file("comap-0000007.hd5",
                                    data=level1_view(store))
        walls[run] = time.perf_counter() - t0
        launches[run] = {"masked_fill": masked_fill.launches,
                         "rolling_median_windows":
                             rolling_median_windows.launches}
    F = 2
    want = {"oracle": {"masked_fill": 0, "rolling_median_windows": 0},
            "card": {"masked_fill": F, "rolling_median_windows": F + 1}}
    if devices[0] != "cuda":
        want["card"] = want["oracle"]
    if launches != want:
        raise SystemExit(f"oracle launches {launches}, not {want}")
    diffs = oracle_diffs(out["card"], out["oracle"])
    bad = {k: v for k, v in diffs.items() if not v[0] <= v[1]}
    if bad:
        raise SystemExit(f"oracle: the card past the numpy oracle's "
                         f"tolerances (measure, limit): {bad}")
    line = {"diffs": {k: v[0] for k, v in diffs.items()},
            "walls_s": walls, "launches": launches}
    log("oracle", json.dumps(line))
    return line


def phase_skydip_small(devices=("cuda", "cpu")):
    """Phase J.3: the pipeline test's observation with SkyDip's elevation
    sweep, the vane and SkyDip (no fleet mask) on the card and on the
    CPU, held by :func:`level2_diffs` (``skydip/fits`` under its last
    rule: TOD_RTOL of scale)."""
    from comapreduce_tpu_torch.data.level import COMAPLevel2
    from comapreduce_tpu_torch.data.synthetic import generate_level1_store
    from comapreduce_tpu_torch.pipeline.stages import (
        MeasureSystemTemperature, SkyDip)

    params = pipeline_test_params()
    params.elevation, params.el_sweep = 47.5, 15.0
    _, store = generate_level1_store(params)
    out = {}
    for dev in devices:
        lvl2 = COMAPLevel2(filename="")
        for stage in (MeasureSystemTemperature(device=dev),
                      SkyDip(device=dev)):
            if not stage(level1_view(store), lvl2):
                raise SystemExit(f"skydip small: {stage.name} failed on "
                                 f"{dev}")
            lvl2.update(stage)
        out[dev] = lvl2
    try:
        diffs = check_level2(out[devices[0]], out[devices[1]],
                             "skydip small")
    except AssertionError as err:
        raise SystemExit(str(err))
    line = {"max_diff": diffs}
    log("skydip_small", json.dumps(line))
    return line


def phase_last_stages():
    """Phase J: J.1, J.2 and J.3, with their walls."""
    t0 = time.perf_counter()
    line = {"skydip_full": phase_skydip_full(),
            "oracle": phase_oracle(), "skydip_small": phase_skydip_small()}
    line["wall_s"] = time.perf_counter() - t0
    return line


# Phase K: the incremental map server and the tile read tier. Phase E's
# full-width Level-2 store is served under two names (files A and B) and
# committed through a lease-file state directory, as a campaign commits
# its files; the server solves band 0 on the shipped parameters.ini's
# field (240 x 240 of 2'), offset length, iterations, threshold and
# two-level block 8, with the reader's window-400 high-pass
SERVING_DIR = os.path.join(ROOT, "chiprun_out", "serving")
SERVE_NAMES = ("Level2_serve-A.hd5", "Level2_serve-B.hd5")
SERVE_KW = dict(band=0, offset_length=50, n_iter=100, threshold=1e-6,
                coarse_block=8, medfilt_window=READER_WINDOW, tile_px=64)
# two maps of one census solved to that threshold by different routes
# (the cold one-shot against the batch solve, assembled from per-file
# aggregates against one read; the warm epoch against the cold one,
# modulo the offsets' constant): phase F's map tolerance, MAP_ATOL of
# max(nanstd, 1). The CPU rehearsal at SMALL_FIELD measured 4.1e-4 warm
# against cold there
SERVE_ATOL = MAP_ATOL


class _Walls:
    """For the ``with`` block, wraps ``obj.name`` for each ``name=obj`` so
    every call's wall (synchronised on the card) adds to ``self.s[name]``;
    the attributes are restored on exit."""

    def __init__(self, on_card: bool, **targets):
        self.on_card, self.targets, self.s = on_card, targets, {}

    def __enter__(self):
        for name, obj in self.targets.items():
            setattr(obj, name, self._wrap(name, getattr(obj, name)))
        return self

    def __exit__(self, *exc):
        for name, obj in self.targets.items():
            delattr(obj, name)

    def _wrap(self, name, fn):
        def call(*a, **kw):
            t0 = self.now()
            try:
                return fn(*a, **kw)
            finally:
                self.s[name] = self.s.get(name, 0.0) + self.now() - t0
        return call

    def now(self) -> float:
        if self.on_card:
            import torch

            torch.cuda.synchronize()
        return time.perf_counter()


def _epoch_maps(epoch_dir: str, name: str = "map_band0.fits") -> dict:
    from comapreduce_tpu_torch.mapmaking.fits_io import read_fits_image

    return {n: np.asarray(a) for n, _, a in read_fits_image(
        os.path.join(epoch_dir, name))}


def _map_gap(got: dict, want: dict, null_mode: bool = False) -> float:
    """Largest destriped difference on hit pixels over ``max(nanstd, 1)``
    of ``want`` (phase F's scale), after the weighted mean difference when
    ``null_mode`` (the offsets' global constant)."""
    hit = want["WEIGHTS"] > 0
    diff = got["DESTRIPED"][hit].astype(np.float64) - \
        want["DESTRIPED"][hit]
    if null_mode:
        w = want["WEIGHTS"][hit].astype(np.float64)
        diff = diff - np.sum(diff * w) / np.sum(w)
    scale = max(float(np.nanstd(want["DESTRIPED"])), 1.0)
    return float(np.max(np.abs(diff))) / scale if diff.size else 0.0


def component_gap(got: dict, want: dict, data, offset_length: int) -> float:
    """:func:`_map_gap` with the offsets' whole null space taken out: one
    constant for each connected component of the graph that joins an
    offset to the pixels its weighted samples hit (two preconditioners
    leave different constants in different components). ``data``: the
    band's ``DestriperData``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    pix = np.asarray(data.pixels).astype(np.int64)
    npix = int(data.npix)
    off = np.arange(pix.size) // offset_length
    n_off = int(off.max()) + 1
    ok = (pix >= 0) & (pix < npix) & (np.asarray(data.weights) > 0)
    graph = sp.coo_matrix((np.ones(int(ok.sum())), (off[ok],
                                                     n_off + pix[ok])),
                          shape=(n_off + npix,) * 2)
    _, label = connected_components(graph, directed=False)
    hit = np.flatnonzero(np.bincount(pix[ok], minlength=npix) > 0)
    sky = hit if data.sky_pixels is None else \
        np.asarray(data.sky_pixels)[hit]
    g = got["DESTRIPED"].reshape(-1)[sky].astype(np.float64)
    w = want["DESTRIPED"].reshape(-1)[sky].astype(np.float64)
    wt = want["WEIGHTS"].reshape(-1)[sky].astype(np.float64)
    diff = g - w
    comp = label[n_off + hit]
    for c in np.unique(comp):
        sel = comp == c
        diff[sel] -= np.sum(diff[sel] * wt[sel]) / max(np.sum(wt[sel]),
                                                         1e-30)
    scale = max(float(np.nanstd(want["DESTRIPED"])), 1.0)
    return float(np.max(np.abs(diff))) / scale if diff.size else 0.0


def phase_serving(store, stage_log=None, device: str = "cuda",
                  field=SHIPPED_FIELD):
    """Phase K: ``MapServer`` over ``store`` served as files A and B.

    Epoch 1 is cold over A; B is committed and epoch 2 is warm over A + B
    (the previous epoch's offsets re-expanded, B's started against epoch
    1's sky); a second server publishes the cold one-shot over A + B in a
    root of its own; a batch ``read_comap_data`` + ``solve_band`` over the
    same census and knobs is held against it; a third server (cold
    starts, as the reference drill evicts) evicts B, publishing the
    ``downdated`` epoch 3. Each epoch is tiled (64-pixel tiles); a
    loopback ``TileServer`` serves a cutout of epoch 1, revalidated (304)
    across a rollback of both pointers to epoch 1; ``coadd_fits_files``
    co-adds the epochs root (its ``current``: epoch 1).

    Checks: every file in exactly one epoch's ``new_files`` (both roots);
    the cold one-shot against the batch solve within ``SERVE_ATOL`` of
    phase F's scale (bitwise on the CPU); the warm epoch strictly fewer
    CG iterations than the cold one-shot and the same map modulo the
    offsets' constant within
    ``SERVE_ATOL``; epoch 3's tiles byte-identical to epoch 1's, all of
    them (its census is epoch 1's, and the card's sums keep one order);
    the cutout bit-identical to
    a slice of the epoch FITS; the evicted file not re-admitted; the
    co-add finite, its hits epoch 1's. Launches: K1 and K4 none, K2 one
    per file read, K3 as :func:`k3_launches` derives from each planned
    solve (:class:`MainProbe`). Per epoch: the read wall per file, the
    assemble, solve and publish walls (the publish includes the tiling),
    the solve's host builds (``stage_log``, a :class:`StageLog` on the
    port's logger, when given), the tile wall, iterations, residual and
    peak device memory above its base, and the manifest's freshness
    (publish less commit). Then K3 at the census plan's shapes (R = 1)
    and K2 at the server's reads (:func:`reader_k2_site`), each against
    its plain version. ``device="cpu"`` rehearses the phase (no launches, no
    kernel sites). Returns the report line."""
    import urllib.error
    import urllib.request

    import torch

    import comapreduce_tpu_torch.cli.run_destriper as rd
    import comapreduce_tpu_torch.mapmaking.leveldata as ld
    from comapreduce_tpu_torch.mapmaking.coadd import coadd_fits_files
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.resilience.lease import LeaseBoard
    from comapreduce_tpu_torch.serving import EpochStore, ServedLedger
    from comapreduce_tpu_torch.serving.server import MapServer
    from comapreduce_tpu_torch.tiles.blob import decode_tile
    from comapreduce_tpu_torch.tiles.http import TileServer
    from comapreduce_tpu_torch.tiles.tiler import TileSet

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    dirs = {k: os.path.join(SERVING_DIR, k)
            for k in ("state", "epochs", "cold", "tiles")}
    os.makedirs(dirs["state"])
    paths = served_paths(SERVE_NAMES, SERVING_DIR)
    pa, pb = (paths[n] for n in SERVE_NAMES)
    wcs = WCS.from_field(*field)
    kw = dict(SERVE_KW, wcs=wcs, device=device)
    counters = {"masked_fill": masked_fill,
                "rolling_median_windows": rolling_median_windows,
                "binned_window_sum": binned_window_sum,
                "windowed_gather": windowed_gather}
    for fn in counters.values():
        fn.launches = 0
    board = LeaseBoard(dirs["state"], rank=0, lease_ttl_s=60.0)
    reads, k3_want = [], 0

    def commit(path):
        if not board.commit(board.claim(path)):
            raise SystemExit(f"serving: could not commit {path}")

    def run(label, server, fn):
        nonlocal k3_want
        if stage_log is not None:
            stage_log.clear()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        with _Walls(on_card, _assemble=server, publish=server.store) as \
                walls, MainProbe(device) as probe:
            t0 = walls.now()
            n = fn()
            wall = walls.now() - t0
        if n is None:
            raise SystemExit(f"serving {label}: nothing published")
        reads.extend(probe.reads)
        k3_want += probe.k3_want()
        man = server.store.manifest(n)
        tiles = server.stats.get("tiles") or [{}]
        return {
            "label": label, "epoch": n, "census": man["census"],
            "new_files": man["new_files"], "x0": man["cg"]["x0"],
            "n_iter": man["cg"]["n_iter"], "residual": man["cg"]["residual"],
            "wall_s": wall, "freshness_s": man.get("freshness_s"),
            "read_s": [r["read_s"] for r in probe.reads],
            "assemble_s": walls.s.get("_assemble", 0.0),
            "solve_s": sum(s["solve_s"] for s in probe.solves),
            "publish_s": walls.s.get("publish", 0.0),
            "host_builds_s": {k: stage_log.seconds(k) for k in (
                "plan_build", "coarse_pattern", "coarse_build")}
            if stage_log is not None else None,
            "tile_s": tiles[-1].get("t_tile_s") if server.tiles_root
            else None,
            "peak_above_base_gib": (torch.cuda.max_memory_allocated()
                                    - base) / 2**30 if on_card else None}

    epochs = []
    with ServedLevel2({pa: store, pb: store}):
        commit(pa)
        warm = MapServer(dirs["state"], dirs["epochs"],
                         tiles_root=dirs["tiles"], **kw)
        epochs.append(run("cold A", warm, warm.poll_once))
        commit(pb)
        epochs.append(run("warm A+B", warm, warm.poll_once))
        cold = MapServer(dirs["state"], dirs["cold"], **kw)
        epochs.append(run("cold one-shot A+B", cold, cold.poll_once))
        evict = MapServer(dirs["state"], dirs["epochs"], warm_start=False,
                          tiles_root=dirs["tiles"], **kw)
        epochs.append(run("downdated A", evict,
                          lambda: evict.evict(SERVE_NAMES[1])))
        readmitted = evict.admit_new()
        # the batch read + solve over the cold one-shot's census (through
        # the modules, which the probe wraps)
        with MainProbe(device) as probe:
            t0 = time.perf_counter()
            data = ld.read_comap_data(
                [pa, pb], band=0, wcs=wcs,
                offset_length=SERVE_KW["offset_length"],
                medfilt_window=READER_WINDOW, device=device)
            res = rd.solve_band(data, offset_length=SERVE_KW["offset_length"],
                                n_iter=SERVE_KW["n_iter"],
                                threshold=SERVE_KW["threshold"],
                                coarse_block=SERVE_KW["coarse_block"],
                                device=device)
            rd.write_band_map(os.path.join(SERVING_DIR, "batch_band0.fits"),
                              data, res)
            batch_s = time.perf_counter() - t0
        reads.extend(probe.reads)
        k3_want += probe.k3_want()
    launches = {k: fn.launches for k, fn in counters.items()}
    names = sorted(SERVE_NAMES)
    store_w, store_c = EpochStore(dirs["epochs"]), EpochStore(dirs["cold"])
    for root, st, want_n in ((dirs["epochs"], store_w, 3),
                             (dirs["cold"], store_c, 1)):
        folded = sorted(f for n in st.list_epochs()
                        for f in st.manifest(n)["new_files"])
        if folded != names or st.list_epochs() != list(
                range(1, want_n + 1)):
            raise SystemExit(f"serving: {root} folded {folded} over epochs "
                             f"{st.list_epochs()}")
    e1, e2, e_cold, e3 = epochs
    if e1["x0"] != "cold" or e2["x0"] != "epoch-000001" or \
            e_cold["x0"] != "cold" or e3["census"] != [SERVE_NAMES[0]] or \
            not store_w.manifest(3).get("downdated"):
        raise SystemExit(f"serving: epochs {epochs}")
    if readmitted or SERVE_NAMES[1] not in ServedLedger(os.path.join(
            dirs["epochs"], "served.jsonl")).retracted:
        raise SystemExit(f"serving: the evicted file was re-admitted "
                         f"({readmitted})")
    m1 = _epoch_maps(store_w.epoch_dir(1))
    m2 = _epoch_maps(store_w.epoch_dir(2))
    m3 = _epoch_maps(store_w.epoch_dir(3))
    m_cold = _epoch_maps(store_c.epoch_dir(1))
    batch = _epoch_maps(SERVING_DIR, "batch_band0.fits")
    cold_vs_batch = _map_gap(m_cold, batch)
    cold_bitwise = all(m_cold[k].tobytes() == batch[k].tobytes()
                       for k in batch)
    warm_vs_cold = _map_gap(m2, m_cold, null_mode=True)
    if not (cold_vs_batch <= SERVE_ATOL and (on_card or cold_bitwise)):
        raise SystemExit(f"serving: the cold one-shot epoch is "
                         f"{cold_vs_batch} of scale from the batch solve "
                         f"(bitwise {cold_bitwise})")
    if not (e2["n_iter"] < e_cold["n_iter"] and warm_vs_cold <= SERVE_ATOL):
        raise SystemExit(f"serving: warm epoch {e2['n_iter']} iterations "
                         f"against the cold one-shot's {e_cold['n_iter']}, "
                         f"{warm_vs_cold} of scale apart after the "
                         f"offsets' constant")
    if not (np.array_equal(m1["HITS"], m2["HITS"] / 2)
            and np.array_equal(m1["HITS"], m3["HITS"])):
        raise SystemExit("serving: hits do not add over the census")
    ts = TileSet(dirs["tiles"])
    t1, t3 = ts.manifest(1)["tiles"], ts.manifest(3)["tiles"]
    map3_bitwise = all(m1[k].tobytes() == m3[k].tobytes() for k in m1)
    same_tiles = sum(t1[k][0] == t3.get(k, [None])[0] for k in t1)
    # unchanged tiles keep their content hash (tiles/tiler.py): epoch 3
    # solves epoch 1's census again, and every sum adds in a fixed order
    if sorted(t1) != sorted(t3) or same_tiles != len(t1):
        raise SystemExit(f"serving: epoch 3's tiles {same_tiles} of "
                         f"{len(t1)} epoch 1's (map bitwise {map3_bitwise})")
    tile_gap = _map_gap(m3, m1)
    if tile_gap > SERVE_ATOL:
        raise SystemExit(f"serving: epoch 3 is {tile_gap} of scale from "
                         "epoch 1")
    # the HTTP read tier over the tiles, across a rollback to epoch 1
    srv = TileServer(dirs["tiles"], epochs_root=dirs["epochs"],
                     device=device).start()
    base_url = f"http://{srv.host}:{srv.port}"

    def fetch(url, etag=None):
        rq = urllib.request.Request(base_url + url)
        if etag:
            rq.add_header("If-None-Match", etag)
        try:
            with urllib.request.urlopen(rq, timeout=30) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), b""

    try:
        t0 = time.perf_counter()
        # a box crossing tile boundaries (48, 60, 120, 80 at 240 x 240)
        nx, ny = field[2]
        x0, y0, w, h = nx // 5, ny // 4, nx // 2, ny // 3
        cut_url = f"/v1/epochs/1/cutout?x0={x0}&y0={y0}&w={w}&h={h}"
        cur = fetch("/v1/current")
        st, hdrs, blob = fetch(cut_url)
        cut_s = time.perf_counter() - t0
        cut = decode_tile(blob)["products"] if st == 200 else {}
        cut_ok = st == 200 and json.loads(cur[2])["epoch"] == 3 and all(
            np.array_equal(cut[k], m1[k][y0:y0 + h, x0:x0 + w])
            for k in m1)
        store_w.rollback(1)
        ts.set_current(1, force=True)
        after = fetch("/v1/current", cur[1].get("ETag"))
        revalidated = fetch(cut_url, hdrs.get("ETag"))[0]
        http_stats = srv.status()["http"]
    finally:
        srv.stop()
    if not cut_ok or after[0] != 200 or \
            json.loads(after[2])["epoch"] != 1 or revalidated != 304:
        raise SystemExit(f"serving: HTTP cutout {st} (bit-identical "
                         f"{cut_ok}), /v1/current after the rollback "
                         f"{after[0]} {after[2][:80]!r}, revalidation "
                         f"{revalidated}")
    t0 = time.perf_counter()
    coadd = coadd_fits_files([dirs["epochs"]],
                             os.path.join(SERVING_DIR, "coadd.fits"))
    coadd_s = time.perf_counter() - t0
    hit = m1["WEIGHTS"] > 0
    if not (np.array_equal(coadd["HITS"], m1["HITS"])
            and np.isfinite(coadd["DESTRIPED"]).all()
            and np.allclose(coadd["DESTRIPED"][hit], m1["DESTRIPED"][hit],
                            rtol=1e-6, atol=0)):
        raise SystemExit("serving: the co-add of epoch 1 is not epoch 1")
    # K2 once per file a read call reads (the high-pass runs file by file)
    want = {"masked_fill": 0,
            "rolling_median_windows": sum(r["files"] for r in reads),
            "binned_window_sum": k3_want, "windowed_gather": 0}
    line = {
        "field": list(field), "knobs": SERVE_KW,
        "samples_a_file": int(data.tod.size) // 2,
        "epochs": epochs, "batch_s": batch_s,
        "cold_vs_batch": cold_vs_batch, "cold_bitwise": cold_bitwise,
        "warm_vs_cold_null_mode": warm_vs_cold,
        "epoch3_map_bitwise": map3_bitwise,
        "epoch3_tiles_identical": [same_tiles, len(t1)],
        "epoch3_vs_epoch1": tile_gap,
        "http": {"cutout": [x0, y0, w, h], "cutout_s": cut_s,
                 "bytes": len(blob), "revalidated": revalidated,
                 "requests": http_stats["n_requests"]},
        "coadd_s": coadd_s, "launches": launches, "launches_derived": want,
        "host_aggregate_mib": sum(
            a.tod.nbytes + a.weights.nbytes + a.az.nbytes + a.gids.nbytes
            + a.global_pixels.nbytes for a in warm._agg.values()) / 2**20}
    if on_card:
        L = SERVE_KW["offset_length"]
        n = (data.tod.size // L) * L
        plan = rd.pointing_plan(np.asarray(data.pixels[:n]), data.npix, L)
        g = torch.Generator(device="cuda")
        g.manual_seed(37)
        line["k3_sites"] = k3_sites(plan, 1, g, "serve1_")
        # K2 at the server's reads: a file's band 0, the reader's site
        one = torch.empty(1, device="cuda")
        line["k2_site"] = reader_k2_site(store, cuda_ms(one.zero_, reps=50))
        line["nvidia_smi"] = smi_line()
    line["wall_s"] = time.perf_counter() - t_phase
    log("serving", json.dumps(line))
    if on_card and launches != want:
        raise SystemExit(f"serving: launches {launches}, derived {want}")
    return line


# ---------------------------------------------------------------------------
# phase L: the synthetic campaign engine (synthetic/, simulations/)
# ---------------------------------------------------------------------------

SYNTH_DIR = os.path.join(ROOT, "chiprun_out", "synthetic")
# L.1, the transfer artifact on the card against the CPU's: the chain's
# reductions and K3 sum in other orders on the card than on the CPU, so
# the artifact moves in its last digits. Limits, about
# ten times the largest gap measured on an H100 (two runs of the phase,
# the same gaps in both): the gated low-k bins within TRANSFER_GATED_ATOL
# (measured 1.09e-5) and the map gain too (8.5e-6); every bin within
# TRANSFER_BIN_ATOL (1.70e-4: the high-k bins divide the noise by
# near-zero truth power); the quality medians within TRANSFER_FIT_RTOL
# (4.9e-6 relative; the blind file's 1/f at 0.08 K keeps its fits well
# posed); the hit fraction, k bins, mode counts and record counts exact.
# On the CPU the port against the reference (tests/test_torch_transfer.py)
# measures low-k 3.8e-6, map gain 1.5e-6, any bin 9.6e-5, medians 7e-7.
TRANSFER_GATED_ATOL = 1e-4
TRANSFER_BIN_ATOL = 2e-3
TRANSFER_FIT_RTOL = 1e-4
# L.2: a synth:// campaign at the instrument's width (phase E's F, B and
# C), cut in length to two scans of 1 500 samples: the reference's numpy
# generator makes every byte on the host (~65 ns a sample)
SYNTH_FULL = dict(name="chip_full", n_files=2, source="co2", n_feeds=19,
                  n_bands=4, n_channels=1024, n_scans=2, scan_samples=1500,
                  vane_samples=120, gap_samples=64, shape_jitter=16,
                  t_atm_sigma=0.02, spike_rate=0.002, nan_rate=0.001)
def kernel_counters():
    """The four kernel wrappers, whose ``launches`` count their launches."""
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)

    return (masked_fill, rolling_median_windows, binned_window_sum,
            windowed_gather)


class KernelInputs:
    """For the ``with`` block, keeps a copy of the first input of each
    distinct shape that the port hands K1 on the card (``ops/reduce``'s
    ``_fill_bad``) and of each distinct (shape, window) it hands K2 (every
    stage and the reader reach it through ``ops.median_filter``), so a
    site is held and timed on the main path's own data. It only watches:
    the launches are the wrappers', and the copies wait in host memory,
    off the card's peak."""

    def __init__(self):
        self.k1, self.k2 = {}, {}

    def __enter__(self):
        from comapreduce_tpu_torch.ops import median_filter, reduce

        self._saved = [(reduce, "_fill_bad", reduce._fill_bad),
                       (median_filter, "rolling_median_windows",
                        median_filter.rolling_median_windows)]
        fill, windows = reduce._fill_bad, median_filter.rolling_median_windows

        def keep_k1(tod, mask):
            key = tuple(tod.shape)
            if tod.is_cuda and key not in self.k1:
                self.k1[key] = (tod.detach().cpu(), mask.detach().cpu())
            return fill(tod, mask)

        def keep_k2(padded, window):
            key = (tuple(padded.shape), int(window))
            if padded.is_cuda and key not in self.k2:
                self.k2[key] = padded.detach().cpu()
            return windows(padded, window)

        reduce._fill_bad = keep_k1
        median_filter.rolling_median_windows = keep_k2
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def sites(self, label: str) -> dict:
        """K1 (:func:`k1_site`) and K2 (:func:`k2_site`) at every kept
        input, each bitwise against its plain version, timed."""
        import torch

        one = torch.empty(1, device="cuda")
        floor_ms = cuda_ms(one.zero_, reps=50)
        return {"k1_sites": [k1_site(t.cuda(), m.cuda(),
                                     f"{label} {list(shape)}")
                             for shape, (t, m) in sorted(self.k1.items())],
                "k2_sites": [k2_site(x.cuda(), w, floor_ms,
                                     f"{label} w {w} {list(shape)}")
                             for (shape, w), x in sorted(self.k2.items())]}


def transfer_in_memory(device, run_dir: str, seed: int = 0,
                       level1=None) -> tuple:
    """``synthetic.transfer.run_transfer``'s steps (b)-(d) with memory I/O
    (the card's machine has no h5py): the gate scenario's injected and
    blind observations (step (a) in memory, ``transfer._level1_stores``,
    or ``level1`` as that returns it) served to the loader
    (``ServedLevel1``), reduced by the transfer's own chain with the
    Level-2 stores kept in memory (``memory_runner``), read back through
    ``ServedLevel2``, destriped and compared on ``device``. Returns
    ``(artifact, walls, {Level-2 path: store})`` (the injected files'
    stores, as the map read them)."""
    from comapreduce_tpu_torch.synthetic import transfer as xfer

    cfg = xfer.transfer_scenario(seed)
    stores, ref_base = level1 or xfer._level1_stores(cfg)
    walls = {}
    shutil.rmtree(run_dir, ignore_errors=True)
    level2 = {}
    runner = memory_runner(device, xfer._reduce_config(
        os.path.join(run_dir, "level2")), run_dir=run_dir, level2=level2)
    t0 = time.perf_counter()
    with ServedLevel1(stores):
        l2files = xfer._reduce(runner, list(stores), cfg,
                               listing=lambda: list(level2))
    walls["reduce_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = {p: level2[p] for p in l2files}
    with ServedLevel2(served):
        bands = xfer._compare_bands(cfg, l2files, device=device)
    walls["map_s"] = time.perf_counter() - t0
    quality = xfer._quality_closure(runner.state_dir, cfg, ref_base)
    return xfer._artifact(cfg, seed, bands, quality), walls, served


def transfer_diffs(got: dict, want: dict) -> dict:
    """Two transfer artifacts field by field: ``{field: (gap, limit)}``
    under the limits stated at TRANSFER_GATED_ATOL (exact fields: 0 or
    inf). Raises ``SystemExit`` on a field past its limit."""
    out = {}
    for bg, bw in zip(got["bands"], want["bands"]):
        b = bw["band"]
        tg, tw = np.asarray(bg["transfer"]), np.asarray(bw["transfer"])
        out[f"band{b}.low_k"] = (float(np.abs(tg[:2] - tw[:2]).max()),
                                 TRANSFER_GATED_ATOL)
        out[f"band{b}.transfer"] = (float(np.abs(tg - tw).max()),
                                    TRANSFER_BIN_ATOL)
        out[f"band{b}.map_gain"] = (abs(bg["map_gain"] - bw["map_gain"]),
                                    TRANSFER_GATED_ATOL)
        for k in ("hit_fraction", "k_bins", "n_modes", "freq_ghz"):
            out[f"band{b}.{k}"] = (0.0 if bg[k] == bw[k] else np.inf, 0.0)
    qg, qw = got["quality"], want["quality"]
    for k in ("alpha_median", "white_sigma_median", "fknee_median",
              "fknee_expected"):
        out[f"quality.{k}"] = (abs(qg[k] - qw[k]) / abs(qw[k]),
                               TRANSFER_FIT_RTOL)
    for k in ("n_records", "n_fitted", "alpha_expected"):
        out[f"quality.{k}"] = (0.0 if qg[k] == qw[k] else np.inf, 0.0)
    if len(got["bands"]) != len(want["bands"]):
        out["n_bands"] = (np.inf, 0.0)
    bad = {k: v for k, v in out.items() if not v[0] <= v[1]}
    if bad:
        raise SystemExit(f"transfer: card against CPU past the limits "
                         f"(gap, limit): {bad}")
    return out


def phase_transfer(devices=("cuda", "cpu"), base=None) -> dict:
    """Phase L.1: the transfer closure at its shipped scenario (seed 0: 2
    injected files and a blind one, 2 feeds x 1 band x 64 channels x 4
    scans of 600) through :func:`transfer_in_memory` on ``devices[0]``,
    with every kernel counter set to 0 just before and read just after,
    then on ``devices[1]`` on the same Level-1 stores. Both artifacts
    must pass ``check_transfer``, and agree field by field
    (:func:`transfer_diffs`). On the card, launches as the code derives
    them: K1 once a feed of each file, K2 once a feed in the reduction
    and once a file in ``Spikes`` (the reader's high-pass skips the
    calibrator files), K3 as ``k3_launches`` derives from each solve's
    iterations (Jacobi, no V-cycle), K4 never; then K1 and K2 at each of
    the path's inputs (:class:`KernelInputs`) and K3 at the 64 x 64
    solve's three sites against their plain versions. Run state goes
    under ``base`` (default ``chiprun_out/synthetic``)."""
    import torch

    from comapreduce_tpu_torch.cli import run_destriper as rd
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.synthetic import transfer as xfer

    t_phase = time.perf_counter()
    cfg = xfer.transfer_scenario(0)
    level1 = xfer._level1_stores(cfg)
    level1_s = time.perf_counter() - t_phase
    on_card = torch.device(devices[0]).type == "cuda"
    counters = kernel_counters()
    artifacts, walls, iters = {}, {}, []    # iters: each run's solves
    solve = rd.solve_band

    def counted(*args, **kwargs):
        res = solve(*args, **kwargs)
        iters[-1].append(int(res.n_iter))
        return res

    rd.solve_band = counted
    try:
        for i, dev in enumerate(devices):
            run_dir = os.path.join(base or SYNTH_DIR, f"transfer_{i}_{dev}")
            iters.append([])
            for fn in counters:
                fn.launches = 0
            with KernelInputs() as inputs:
                t0 = time.perf_counter()
                artifacts[i], walls[i], served = transfer_in_memory(
                    dev, run_dir, level1=level1)
                if torch.device(dev).type == "cuda":
                    torch.cuda.synchronize()
                walls[i]["total_s"] = time.perf_counter() - t0
            if i == 0:
                launches = {fn.__name__: fn.launches for fn in counters}
                card_inputs, served_card = inputs, served
            try:
                xfer.check_transfer(artifacts[i])
            except AssertionError as err:
                raise SystemExit(f"transfer on {dev}: {err}")
    finally:
        rd.solve_band = solve
    gaps = transfer_diffs(artifacts[0], artifacts[1])
    n_files, F = cfg.n_files + 1, cfg.n_feeds
    cg_iters = iters[0]
    want = {"masked_fill": n_files * F,
            "rolling_median_windows": n_files * (F + 1),
            "binned_window_sum": sum(k3_launches(k, ground=False, nu=0)
                                     for k in cg_iters),
            "windowed_gather": 0}
    line = {"scenario": xfer.TRANSFER_SCENARIO, "devices": list(devices),
            "level1_s": level1_s, "walls": [walls[i] for i in walls],
            "artifact": artifacts[0], "gaps": gaps, "cg_iters": cg_iters,
            "launches": launches, "launches_derived": want}
    if len(cg_iters) != cfg.n_bands:
        raise SystemExit(f"transfer: {len(cg_iters)} solves for "
                         f"{cfg.n_bands} bands")
    if on_card:
        if launches != want:
            raise SystemExit(f"transfer: launches {launches}, derived "
                             f"{want}")
        line.update(card_inputs.sites("transfer"))
        # K3 at the 64 x 64 solve's three sites, on the plan of the
        # injected files' pointing (the solve's, memoised)
        with ServedLevel2(served_card):
            data = read_comap_data(
                list(served_card), band=0, device="cuda",
                wcs=WCS.from_field((cfg.ra0, cfg.dec0), xfer.CDELT,
                                   xfer.MAP_SHAPE), **xfer.READ_KW)
        L = xfer.SOLVE_KW["offset_length"]
        n = (data.tod.size // L) * L
        g = torch.Generator(device="cuda")
        g.manual_seed(41)
        line["k3_sites"] = k3_sites(rd.pointing_plan(
            np.asarray(data.pixels[:n]), data.npix, L), 1, g, "xfer1_")
        line["nvidia_smi"] = smi_line()
    line["phase_s"] = time.perf_counter() - t_phase
    log("transfer", json.dumps({k: v for k, v in line.items()
                                if k != "artifact"}))
    return line


def phase_synth_full(device: str = "cuda", base=None, tuning_src=None,
                     **overrides) -> dict:
    """Phase L.2: a ``synth://`` campaign at the instrument's width
    (:data:`SYNTH_FULL`, ``validate_vane_pad`` under the shipped chain's
    pad), registered in ``synthetic.memsource`` and reduced from its
    ``virtual_filelist`` by the shipped ``configuration.toml`` chain with
    ``[ingest] prefetch = 1``, so the host generation of file 2 (on the
    prefetcher's worker, through the port's ``ingest.loaders``) overlaps
    the chain of file 1. The run is a campaign: ``[campaign]`` with the
    documented quanta (:data:`CAMPAIGN`) and ``warm_compile``, ``[ingest]
    compile_cache_dir`` on a fresh directory (the kernel libraries), the
    jittered members in one bucket; ``[tuning]`` over the winners file
    ``tuning_src`` (phase N.3's, copied into the run's state directory);
    ``[telemetry]`` on (the program records). Campaign checks: the
    warm-up probed both members, warmed each hooked stage once (one
    bucket) and recorded no error; on the card it built (or found) the
    reduction's libraries (K1's and K2's) once each, all on the warm-up
    thread, and nothing was built while the files ran; ``AtmosphereRemoval``'s
    feed-batch planner consulted the winners cache (a hit); one program
    record per stage program and shape bucket, each with its temporaries
    on the card. Checks: both files reduced and none quarantined;
    the averaged TOD and every Level-2 weight finite, the weights positive
    on every scan sample (the pad trap zeroes them all); on the card K1
    (the scenario's spikes and NaNs masked and filled) and K2 launched as
    the code derives: once a feed of each file, K2 once more a file in
    ``Spikes``, K3 and K4 never, then K1 and K2 at each of the run's
    inputs (:class:`KernelInputs`) against their plain versions;
    ``probe_virtual``'s F, B, C, T and S equal to each generated member's
    TOD shape and scan count, and S to the Level-2 scans. Reports per
    file the generation wall (on the worker), the chain's wait on the
    prefetcher, the stage walls and the
    peak device memory above base. Run state goes under ``base``
    (default ``chiprun_out/synthetic``); ``overrides`` (scenario knobs)
    let the phase run on the CPU at a smaller shape."""
    import threading

    import torch

    from comapreduce_tpu_torch.pipeline.registry import resolve
    from comapreduce_tpu_torch.synthetic import memsource
    from comapreduce_tpu_torch.synthetic.generator import virtual_filelist
    from comapreduce_tpu_torch.synthetic.scenario import ScenarioConfig

    from comapreduce_tpu_torch import _build
    from comapreduce_tpu_torch.pipeline import campaign
    from comapreduce_tpu_torch.telemetry import TELEMETRY
    from comapreduce_tpu_torch.telemetry.programs import read_programs
    from comapreduce_tpu_torch.tuning import TUNING, tuning_path

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    run_dir = os.path.join(base or SYNTH_DIR, "full")
    shutil.rmtree(run_dir, ignore_errors=True)
    state_dir = os.path.join(run_dir, "logs")
    os.makedirs(state_dir)
    if tuning_src:
        shutil.copy(tuning_src, tuning_path(state_dir))
    run_cfg = shipped_chain_config()
    run_cfg["ingest"] = {"prefetch": 1, "compile_cache_dir": os.path.join(
        run_dir, "compile_cache")}
    run_cfg["campaign"] = dict(CAMPAIGN, warm_compile=True)
    run_cfg["tuning"] = {"enabled": True}
    run_cfg["telemetry"] = {"enabled": True}
    # the vane window pad of the chain that consumes the scenario
    pad = resolve("MeasureSystemTemperature",
                  **run_cfg.get("MeasureSystemTemperature", {})).pad
    cfg = ScenarioConfig.coerce(dict(SYNTH_FULL, **overrides))
    cfg.validate_vane_pad(pad)
    memsource.register_scenario(cfg)
    files = virtual_filelist(cfg)
    made = {}
    virtual_store = memsource.virtual_store

    def timed_store(path):
        t0 = time.perf_counter()
        p, store = virtual_store(path)
        made[path] = {"generate_s": time.perf_counter() - t0,
                      "thread": threading.current_thread().name,
                      "tod_shape": list(np.shape(store["spectrometer/tod"])),
                      "n_scans": len(p.truth["scan_edges"])}
        return p, store

    if on_card:
        torch.cuda.empty_cache()
        mem_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    peaks = {}

    def on_stage(lvl2):
        # the peak since the last checkpoint goes to the file checkpointed
        if on_card:
            name = os.path.basename(lvl2.filename)
            peaks[name] = max(peaks.get(name, 0.0), (
                torch.cuda.max_memory_allocated() - mem_base) / 2**30)
            torch.cuda.reset_peak_memory_stats()

    level2 = {}
    runner = memory_runner(device, run_cfg, on_stage=on_stage,
                           run_dir=run_dir, level2=level2)
    waits = []
    consume = runner._consume_stream

    def timed_consume(stream, results, res=None):
        def items():
            t = time.perf_counter()
            for item in stream:
                waits.append(time.perf_counter() - t)
                yield item
                t = time.perf_counter()

        return consume(items(), results, res)

    runner._consume_stream = timed_consume
    counters = kernel_counters()
    for fn in counters:
        fn.launches = 0
    memsource.virtual_store = timed_store
    # the run opens its own telemetry stream and winners cache
    TELEMETRY.close()
    TUNING.close()
    compiles = campaign.CompileCounter().install()
    try:
        with KernelInputs() as inputs:
            t0 = time.perf_counter()
            results = runner.run_tod(list(files))
            if on_card:
                torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
        runner.warmup.join(timeout=60)
        tuning_hits = TUNING.cache.hits
    finally:
        memsource.virtual_store = virtual_store
        compiles.remove()
        TELEMETRY.close()
        TUNING.close()
        # back to the default library directory, where every library of
        # the process is already loaded
        _build.set_build_dir(None)
        campaign._CACHE_DIR_ENABLED = None
    launches = {fn.__name__: fn.launches for fn in counters}
    warm = runner.warmup
    programs = read_programs(state_dir)
    keys = [(r["name"], r["shape_bucket"]) for r in programs]
    built = sorted(e[1] for e in compiles.events)
    camp = {"warmed": [x["stage"] for x in warm.warmed],
            "errors": warm.errors, "probed": len(warm.shapes),
            "compile_counts": compiles.snapshot(),
            "compile_events": compiles.events,
            "tuning_cache_hits": tuning_hits,
            "programs": [{k: r.get(k) for k in (
                "name", "shape_bucket", "argument_bytes", "output_bytes",
                "temp_bytes")} for r in programs]}
    want_built = sorted(("masked_fill", "rolling_median", "prefilter")) \
        if on_card \
        else []
    bad = []
    if warm.errors or not warm.done or len(warm.shapes) != len(files):
        bad.append("warm-up")
    if sorted(camp["warmed"]) != ["AtmosphereRemoval",
                                  "Level1AveragingGainCorrection"]:
        bad.append("warmed stages")
    if built != want_built or any(e[2] != "campaign-warmup"
                                  for e in compiles.events):
        bad.append("library builds")
    if tuning_src and not tuning_hits:
        bad.append("tuning consult")
    if len(set(keys)) != len(keys) or {k[0] for k in keys} != {
            "atmosphere.scan_fit", "level1.reduce_feeds"} or (
            on_card and any(r.get("temp_bytes") is None for r in programs)):
        bad.append("program records")
    if bad:
        raise SystemExit(f"synth full campaign: {bad}: {camp}")
    state = run_state(runner, files)
    probes = {f: memsource.probe_virtual(f) for f in files}
    memsource.clear_registry()
    if len(results) != len(files) or any(r is None for r in results) or \
            state["ledger"]:
        raise SystemExit(f"synth full: results {results}, ledger "
                         f"{state['ledger']}")
    per_file = []
    for i, (path, lvl2) in enumerate(zip(files, results)):
        tod = np.asarray(lvl2["averaged_tod/tod"])
        w = np.asarray(lvl2["averaged_tod/weights"])
        edges = np.asarray(lvl2["averaged_tod/scan_edges"])
        in_scan = np.zeros(w.shape[-1], bool)
        for s, e in edges:
            in_scan[s:e] = True
        p, m = probes[path], made[path]
        if not (np.isfinite(tod).all() and np.isfinite(w).all()
                and (w[..., in_scan] > 0).all()):
            raise SystemExit(f"synth full: {path}: averaged TOD or weights "
                             f"not finite, or a scan weight not positive "
                             f"({float((w[..., in_scan] > 0).mean())} of "
                             f"the scan weights positive)")
        if [p["F"], p["B"], p["C"], p["T"]] != m["tod_shape"] or \
                p["S"] != m["n_scans"] or p["S"] != len(edges):
            raise SystemExit(f"synth full: {path}: probe {p} against the "
                             f"member's {m} and {len(edges)} Level-2 scans")
        per_file.append(dict(
            m, file=os.path.basename(path), probe=p,
            wait_s=waits[i], read_s=runner.timings["ingest.read"][i],
            stages={k: v[i] for k, v in runner.timings.items()
                    if not k.startswith("ingest.")},
            peak_above_base_gib=peaks.get(os.path.basename(
                lvl2.filename))))
    n_files, F = cfg.n_files, cfg.n_feeds
    want = {"masked_fill": n_files * F,
            "rolling_median_windows": n_files * (F + 1),
            "binned_window_sum": 0, "windowed_gather": 0}
    line = {"scenario": dataclasses.asdict(cfg), "vane_pad": pad,
            "chain_s": chain_s, "campaign": camp,
            "files": per_file, "leases": state["leases"],
            "launches": launches, "launches_derived": want,
            "samples_a_file": [int(np.prod(m["tod_shape"]))
                               for m in made.values()]}
    if on_card:
        line["nvidia_smi"] = smi_line()
        if launches != want:
            log("synth_full", json.dumps(line))
            raise SystemExit(f"synth full: launches {launches}, derived "
                             f"{want}")
        line.update(inputs.sites("synth full"))
    line["phase_s"] = time.perf_counter() - t_phase
    log("synth_full", json.dumps(line))
    return line


def phase_synthetic(tuning_src=None) -> dict:
    """Phase L: L.1 (:func:`phase_transfer`) then L.2
    (:func:`phase_synth_full`, over the winners file ``tuning_src``) on
    the card."""
    t0 = time.perf_counter()
    out = {"transfer": phase_transfer(),
           "full": phase_synth_full(tuning_src=tuning_src)}
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase L {out['phase_s']:.1f} s")
    return out


# Phase M: the observability plane on the card. M.1 traces the ground
# route of band 0; the trace only writes three history entries an
# iteration and computes nothing the solve reads, and every sum of the
# solve (K3, the ground groups, the coarse restriction) adds in an order
# fixed by its inputs, so the traced and untraced solves are the same
# bits, on the card as on the CPU.
OBS_DIR = os.path.join(ROOT, "chiprun_out", "observability")
TRACE_UNTRACED = 2
# M.1's checkpointed solve: two chunks of this many Jacobi iterations at
# an unreachable threshold, so both chunks run whole
TRACE_CHUNK = 10
# M.2: the scraper's period and every request's timeout; the first map
# write waits at most GAUGE_WAIT_S for a scrape that carries the solve's
# gauges (they are flushed every TRACE_FLUSH_S by the telemetry thread)
SCRAPE_PERIOD_S = 0.1
SCRAPE_TIMEOUT_S = 5.0
GAUGE_WAIT_S = 30.0
TRACE_FLUSH_S = 0.25
# the families a mid-run /metrics scrape must carry: the reads' spans and
# the solve's progress, its solver.* gauges (the joint route has no solve
# span in either package, and its bands all end on one iteration, so the
# live plane's slope ETA, which needs two iterations, has no line there)
READ_FAMILY = "comap_ingest_read_seconds_count"
SOLVE_FAMILY = ("comap_solver_band", "comap_solver_iteration",
                "comap_solver_log10_residual")
# M.3: two synth:// members at phase L.1's widths through the shipped
# chain (the second, steady one under torch.profiler)
TRACE_SCENARIO = dict(SYNTH_FULL, name="device_trace", n_feeds=2,
                      n_bands=1, n_channels=64, n_scans=4, scan_samples=600,
                      vane_samples=120)
# the CUDA symbols K1 and K2 carry in a profiler trace
K1_SYMBOL = "masked_fill_kernel"
K2_SYMBOL = "rolling_median_kernel"


def _now(device) -> float:
    return _synced() if str(device) == "cuda" else time.perf_counter()


def http_get(host, port, route: str, timeout: float = SCRAPE_TIMEOUT_S):
    """``(status, body, ms)`` of one GET with a timeout; an HTTP error
    status is an answer, not a failure."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{route}",
                                    timeout=timeout) as r:
            status, body = r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read().decode("utf-8")
    return status, body, 1e3 * (time.perf_counter() - t0)


def metric_families(body: str) -> dict:
    """Which of M.2's families a ``/metrics`` page carries."""
    names = {ln.split("{")[0].split(" ")[0] for ln in body.splitlines()
             if ln and not ln.startswith("#")}
    return {"read": READ_FAMILY in names,
            "solve": all(n in names for n in SOLVE_FAMILY)}


class LiveScraper:
    """For the ``with`` block: finds the ``LiveServer`` that ``main``
    starts (``LiveServer.start`` wrapped) and polls its ``/metrics`` and
    ``/healthz`` from a thread every ``SCRAPE_PERIOD_S``, each request
    under ``SCRAPE_TIMEOUT_S``, until ``main`` stops the server (its
    ``stop`` wrapped: the thread is joined first). Each scrape records
    its route, status, latency and families; :meth:`wait_for_solve`
    blocks until a ``/metrics`` scrape carried both families. An error
    in the thread is raised again when the block exits."""

    def __init__(self):
        import threading

        self.scrapes, self.server, self.error = [], None, None
        self._stop = threading.Event()
        self._solve_seen = threading.Event()
        self._thread = None

    def __enter__(self):
        import threading

        from comapreduce_tpu_torch.telemetry import live

        cls = live.LiveServer
        self._saved = (cls, cls.start, cls.stop)
        start, stop = cls.start, cls.stop

        def started(srv):
            out = start(srv)
            self.server = srv
            self._thread = threading.Thread(target=self._poll,
                                            name="live-scraper",
                                            daemon=True)
            self._thread.start()
            return out

        def stopped(srv):
            self._halt()
            return stop(srv)

        cls.start, cls.stop = started, stopped
        return self

    def _poll(self):
        srv = self.server
        try:
            while not self._stop.is_set():
                for route in ("/metrics", "/healthz"):
                    status, body, ms = http_get(srv.host, srv.port, route)
                    rec = {"route": route, "status": status, "ms": ms,
                           "t": time.perf_counter()}
                    if route == "/metrics" and status == 200:
                        rec.update(metric_families(body))
                        if rec["read"] and rec["solve"]:
                            self._solve_seen.set()
                    self.scrapes.append(rec)
                self._stop.wait(SCRAPE_PERIOD_S)
        except Exception as exc:  # raised again in the main thread
            self.error = exc

    def _halt(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=4 * SCRAPE_TIMEOUT_S)

    def wait_for_solve(self, timeout: float) -> bool:
        return self._solve_seen.wait(timeout)

    def __exit__(self, *exc):
        self._halt()
        cls, cls.start, cls.stop = self._saved
        if self.error is not None and exc[0] is None:
            raise self.error


SOLVE_PRODUCTS = ("offsets", "ground", "hit_map", "weight_map",
                  "naive_map", "destriped_map")


def _same_solve(a, b) -> dict:
    """Whether two band solves gave the same bits, product by product
    (offsets, ground template, hits and maps)."""
    return {k: bits_equal(getattr(a, k).float(), getattr(b, k).float())
            for k in SOLVE_PRODUCTS}


def phase_solver_trace(store, device: str = "cuda", field=SHIPPED_FIELD,
                       name: str = "Level2_comap-fullwidth.hd5",
                       base=None) -> dict:
    """Phase M.1: band 0 of ``store`` read as phase F reads it (the
    shipped INI's offset length, iterations, threshold and two-level
    block, ``field`` its pixelisation) and solved on the ground route
    (K3 and K4): untraced ``TRACE_UNTRACED`` times (``trace_iters=0``),
    then traced with telemetry on (``trace_iters=None``: depth
    ``niter``). The trace: one ``iteration`` record per iteration the
    result reports and one ``solve`` record with its ``n_iter`` and
    residual. The untraced solves are the same bits, and the traced solve
    the same bits as them (offsets, ground, hits and maps), and every
    solve launches K3 and K4 as the ground solve derives
    (:func:`k3_launches`). Then a
    checkpointed Jacobi solve in two chunks of ``TRACE_CHUNK``: its
    records number iterations 0..2 x TRACE_CHUNK - 1 on one axis, bases
    0 and TRACE_CHUNK, with a ``destriper.cg_chunk`` span a chunk."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import (
        solve_band, solve_band_checkpointed)
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.pipeline.config import IniConfig
    from comapreduce_tpu_torch.telemetry import TELEMETRY, merge_streams
    from comapreduce_tpu_torch.telemetry.solver_trace import read_solver

    on_card = torch.device(device).type == "cuda"
    out = os.path.join(base or OBS_DIR, "solver_trace")
    shutil.rmtree(out, ignore_errors=True)
    inputs = IniConfig(os.path.join(ROOT, SHIPPED_INI))["Inputs"]
    L = int(inputs["offset_length"])
    kw = dict(offset_length=L, n_iter=int(inputs["niter"]),
              threshold=float(inputs["threshold"]), use_ground=True,
              coarse_block=int(inputs.get("coarse_precond", 8)),
              unit="band0", device=device)
    counters = kernel_counters()
    for fn in counters:
        fn.launches = 0
    with ServedLevel2({name: store}):
        data = read_comap_data([name], band=0, wcs=WCS.from_field(*field),
                               offset_length=L,
                               medfilt_window=READER_WINDOW, device=device)
    read_n = {fn.__name__: fn.launches for fn in counters}

    def solve(**extra):
        for fn in counters:
            fn.launches = 0
        t0 = _now(device)
        res = solve_band(data, **kw, **extra)
        wall = _now(device) - t0
        return res, wall, {fn.__name__: fn.launches for fn in counters}

    TELEMETRY.close()
    untraced = [solve(trace_iters=0) for _ in range(TRACE_UNTRACED)]
    TELEMETRY.configure(out, rank=0, flush_s=60.0)
    try:
        tr, tr_s, tr_n = solve()
        for fn in counters:
            fn.launches = 0
        ck = solve_band_checkpointed(
            data, os.path.join(out, "chunks.npz"), TRACE_CHUNK,
            offset_length=L, n_iter=2 * TRACE_CHUNK, threshold=1e-30,
            unit="band0_chunks", device=device)
        ck_n = {fn.__name__: fn.launches for fn in counters}
    finally:
        TELEMETRY.close()
    records = read_solver(out)
    chunks = merge_streams(out).spans_named("destriper.cg_chunk")
    ground = [r for r in records if r["band"] == "band0"]
    chunked = [r for r in records if r["band"] == "band0_chunks"]
    k = int(tr.n_iter)
    its = [r for r in ground if r["kind"] == "iteration"]
    solves = [r for r in ground if r["kind"] == "solve"]
    if any(u[0].trace is not None for u in untraced) or tr.trace is None \
            or len(its) != k or [r["iter"] for r in its] != list(range(k)) \
            or len(solves) != 1 or solves[0]["n_iter"] != k or \
            solves[0]["residual"] != float(tr.residual):
        raise SystemExit(f"solver trace: {len(its)} iteration records for "
                         f"{k} iterations, summaries {solves}, residual "
                         f"{float(tr.residual)}")
    want = {"masked_fill": 0, "rolling_median_windows": 0,
            "binned_window_sum": k3_launches(k, ground=True, nu=0),
            "windowed_gather": k}
    for i, (res, _, n) in enumerate(untraced + [(tr, tr_s, tr_n)]):
        if int(res.n_iter) != k or (on_card and n != want):
            raise SystemExit(f"solver trace solve {i}: {int(res.n_iter)} "
                             f"iterations, launches {n}, derived {want}")
    same = {"untraced": [_same_solve(a[0], b[0])
                         for i, a in enumerate(untraced)
                         for b in untraced[i + 1:]],
            "traced": [_same_solve(tr, u[0]) for u in untraced]}
    if not all(all(d.values()) for v in same.values() for d in v):
        raise SystemExit(f"solver trace: solves of one band not the same "
                         f"bits: {same}")
    c_its = [r["iter"] for r in chunked if r["kind"] == "iteration"]
    c_bases = [r["base"] for r in chunked if r["kind"] == "solve"]
    if c_its != list(range(2 * TRACE_CHUNK)) or \
            c_bases != [0, TRACE_CHUNK] or len(chunks) != 2 or \
            int(ck.n_iter) != 2 * TRACE_CHUNK:
        raise SystemExit(f"solver trace chunks: iterations {c_its}, bases "
                         f"{c_bases}, {len(chunks)} chunk spans")
    u_walls = [u[1] for u in untraced]
    line = {"n_iter": k, "residual": float(tr.residual),
            "walls_s": {"untraced": u_walls, "traced": tr_s},
            "trace_overhead_s": tr_s - float(np.median(u_walls)),
            "bitwise": same,
            "launches": {"read": read_n,
                         "untraced": {fn: sum(u[2][fn] for u in untraced)
                                      for fn in want},
                         "traced": tr_n, "chunks": ck_n,
                         "derived": want},
            "chunk_iterations": len(c_its), "chunk_bases": c_bases,
            "records": len(records),
            "nvidia_smi": smi_line() if on_card else None}
    log("solver_trace", json.dumps(line))
    return line


def naive_limit(data, L: int) -> np.ndarray:
    """Per pixel, how far two runs' NAIVE maps may lie apart under K3's
    rule. A NAIVE pixel is S_d / S_w, S_d the sum of the pixel's N
    products x = w d (f32, formed alike in both runs) and S_w of its
    weights; each sum, in any order and any nesting of f32 adds, lies
    within g = gamma(N - 1) of sum|x| (resp. sum w) of the exact sum, so
    one run's quotient lies within E = g (sum|x| + |q| sum w) / (sum w
    (1 - g)) of the exact q, plus its division's rounding u (|q| + E);
    two runs lie within twice that. Zero off the hit pixels."""
    import torch

    n = (int(np.size(data.tod)) // L) * L
    pix = torch.as_tensor(np.asarray(data.pixels[:n]), dtype=torch.int64)
    w = torch.as_tensor(np.asarray(data.weights[:n], np.float32))
    x = (w * torch.as_tensor(np.asarray(data.tod[:n], np.float32))).double()
    w = w.double()
    ok = (pix >= 0) & (pix < data.npix)
    pix, w, x = pix[ok], w[ok], x[ok]

    def per_pixel(v):
        return torch.zeros(data.npix, dtype=torch.float64).index_add_(
            0, pix, v).numpy()

    N = per_pixel(torch.ones_like(w))
    A, W, S = per_pixel(x.abs()), per_pixel(w), per_pixel(x)
    ku = np.clip(N - 1, 0, None) * F32_U
    g = ku / (1 - ku)
    hit = W > 0
    q = np.where(hit, S / np.where(hit, W, 1.0), 0.0)
    E = np.where(hit, g * (A + np.abs(q) * W)
                 / (np.where(hit, W, 1.0) * (1 - g)), 0.0)
    return np.where(hit, 2 * (E + F32_U * (np.abs(q) + E)), 0.0)


def phase_live_plane(store, joint_maps=None, untraced_wall=None,
                     device: str = "cuda", field=None,
                     name: str = "Level2_comap-fullwidth.hd5",
                     base=None) -> dict:
    """Phase M.2: phase F's joint route (``store`` one file, the shipped
    ``parameters.ini``, ``field`` its pixelisation when given) through
    ``main`` with ``[Telemetry] enabled = true`` and ``--live-port=0``
    while :class:`LiveScraper` polls the sidecar; the first map write
    waits for a ``/metrics`` scrape carrying the reads' span family and
    the solve's ``solver.*`` gauges, so the run is provably still
    going when it lands. Then: a fresh sidecar over the state dir answers
    ``/v1/campaign`` healthy and ``/healthz`` 200; one trace stream per
    band with an iteration record per reported iteration; the maps have
    ``joint_maps``' hits (phase F's untraced run; computed here, untraced,
    when ``None``), and their NAIVE and DESTRIPED maps are the same bits
    (the trace computes nothing the solve reads and the card's sums keep
    one order; the NAIVE maps' gap against :func:`naive_limit`, the
    bound an order-free sum would need, is reported); ``campaign_report``
    merges the
    state dir into its summary, Chrome trace and Prometheus file. Prints
    the traced and untraced walls and their ratio (not gated: host walls
    spread 30-60% between runs)."""
    import contextlib
    import io

    import torch

    import comapreduce_tpu_torch.cli.run_destriper as rd
    import comapreduce_tpu_torch.mapmaking.leveldata as ld
    from comapreduce_tpu_torch.cli import campaign_report
    from comapreduce_tpu_torch.pipeline.config import IniConfig
    from comapreduce_tpu_torch.resilience.status import report_healthy
    from comapreduce_tpu_torch.telemetry import TELEMETRY
    from comapreduce_tpu_torch.telemetry.live import LiveServer
    from comapreduce_tpu_torch.telemetry.solver_trace import read_solver

    on_card = torch.device(device).type == "cuda"
    out = os.path.join(base or OBS_DIR, "live")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    filelist = os.path.join(out, "l2list.txt")
    with open(filelist, "w") as fh:
        fh.write(name + "\n")
    counters = kernel_counters()
    argv_dev = [] if on_card else ["--device=cpu"]

    def run(route, sections, argv):
        ini = shipped_destriper_ini(
            filelist, os.path.join(out, route),
            os.path.join(out, f"{route}.ini"), field=field,
            log_dir=os.path.join(out, route, "logs"), sections=sections)
        for fn in counters:
            fn.launches = 0
        t0 = _now(device)
        with MainProbe(device) as probe:
            if rd.main([ini] + argv + argv_dev) != 0:
                raise SystemExit(f"live plane {route}: main failed")
        return probe, _now(device) - t0, {fn.__name__: fn.launches
                                          for fn in counters}

    with ServedLevel2({name: store}):
        if joint_maps is None:
            base_probe, untraced_wall, _ = run("untraced", {}, [])
            joint_maps = [w["maps"] for w in base_probe.writes]
        datas = []
        read = ld.read_comap_data
        write = rd.write_band_map

        def kept_read(*a, **kw):
            datas.append(read(*a, **kw))
            return datas[-1]

        def gated_write(path, data, result):
            if not scraper.wait_for_solve(GAUGE_WAIT_S):
                raise SystemExit(
                    f"live plane: no /metrics scrape carried the read and "
                    f"solve families within {GAUGE_WAIT_S} s of the solve "
                    f"({len(scraper.scrapes)} scrapes)")
            return write(path, data, result)

        TELEMETRY.close()
        ld.read_comap_data, rd.write_band_map = kept_read, gated_write
        try:
            with LiveScraper() as scraper:
                probe, wall, launches = run(
                    "traced", {"Telemetry": {"enabled": "true",
                                             "flush_s": TRACE_FLUSH_S}},
                    ["--live-port=0"])
        finally:
            ld.read_comap_data, rd.write_band_map = read, write
            TELEMETRY.close()
    state_dir = os.path.join(out, "traced", "logs")
    L = int(IniConfig(os.path.join(ROOT, SHIPPED_INI))["Inputs"]
            ["offset_length"])
    metrics = [s for s in scraper.scrapes if s["route"] == "/metrics"]
    health = [s for s in scraper.scrapes if s["route"] == "/healthz"]
    mid = [s for s in metrics if s["status"] == 200 and s.get("read")
           and s.get("solve")]
    if not mid or not any(s["status"] == 200 for s in health):
        raise SystemExit(f"live plane: {len(metrics)} /metrics scrapes, "
                         f"{len(mid)} with both families; /healthz "
                         f"{[s['status'] for s in health]}")
    srv = LiveServer(state_dir, port=0).start()
    try:
        c_status, c_body, _ = http_get(srv.host, srv.port, "/v1/campaign")
        h_status, _, _ = http_get(srv.host, srv.port, "/healthz")
    finally:
        srv.stop()
    campaign = json.loads(c_body)
    if c_status != 200 or not report_healthy(campaign) or h_status != 200:
        raise SystemExit(f"live plane: after the run /v1/campaign "
                         f"{c_status} healthy {report_healthy(campaign)}, "
                         f"/healthz {h_status}")
    records = read_solver(state_dir)
    bands = []
    for b, w in enumerate(probe.writes):
        ref, m = joint_maps[b], w["maps"]
        hit = ref["HITS"] > 0
        its = [r for r in records if r["band"] == f"band{b}"
               and r["kind"] == "iteration"]
        naive_gap = np.abs(m["NAIVE"] - ref["NAIVE"])
        naive_lim = naive_limit(datas[b], L)
        d = m["DESTRIPED"][hit]
        same = {k: m[k].tobytes() == ref[k].tobytes()
                for k in ("NAIVE", "DESTRIPED")}
        row = {"band": b, "n_iter": w["n_iter"], "records": len(its),
               "naive_max_gap": float(naive_gap[hit].max()),
               "naive_max_excess": float((naive_gap - naive_lim)[hit].max()),
               "bitwise": same}
        bands.append(row)
        if not np.array_equal(m["HITS"], ref["HITS"]) or \
                len(its) != w["n_iter"] or row["naive_max_excess"] > 0 \
                or not all(same.values()) or not np.isfinite(d).all():
            raise SystemExit(f"live plane band {b}: {row}; hits equal "
                             f"{np.array_equal(m['HITS'], ref['HITS'])}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = campaign_report.run_report(
            state_dir, os.path.join(out, "trace.json"),
            os.path.join(out, "metrics.prom"), as_json=True)
    summary = json.loads(buf.getvalue())["summary"] if rc == 0 else None
    with open(os.path.join(out, "metrics.prom")) as fh:
        prom = fh.read()
    if rc != 0 or "ingest.read" not in summary["stages"] or \
            "comap_solver_iteration" not in prom:
        raise SystemExit(f"live plane: campaign_report rc {rc}, summary "
                         f"{summary}")
    ms = sorted(s["ms"] for s in metrics)
    line = {"wall_s": wall, "untraced_wall_s": untraced_wall,
            "wall_ratio": wall / untraced_wall if untraced_wall else None,
            "scrapes": {"metrics": len(metrics), "healthz": len(health),
                        "mid_run_with_families": len(mid),
                        "healthz_status": sorted({s["status"]
                                                  for s in health}),
                        "metrics_ms_p50": ms[len(ms) // 2],
                        "metrics_ms_max": ms[-1]},
            "bands": bands, "launches": launches,
            "k3_derived": probe.k3_want(),
            "report_stages": sorted(summary["stages"]),
            "nvidia_smi": smi_line() if on_card else None}
    if on_card and (launches["binned_window_sum"] != probe.k3_want() or
                    launches["rolling_median_windows"] != 4):
        raise SystemExit(f"live plane: launches {launches}, K3 derived "
                         f"{probe.k3_want()}")
    log("live_plane", json.dumps(line))
    log(f"live plane: traced wall {wall:.3f} s, untraced "
        f"{untraced_wall:.3f} s, ratio {line['wall_ratio']:.3f}")
    return line


#: the reduction's sub-stage spans (``ops/reduce.py``), one set a scan
#: batch
REDUCE_SUBSTAGES = ("reduce.batch", "reduce.extract", "reduce.fill",
                    "reduce.atmosphere", "reduce.normalise",
                    "reduce.medfilt", "reduce.gain", "reduce.average",
                    "reduce.scatter")


def phase_device_trace(device: str = "cuda", base=None, **overrides):
    """Phase M.3: ``[telemetry] enabled = true, jax_profiler = true``
    through ``Runner.run_tod`` (the shipped chain, Level-2 in memory as
    phase L.2 runs it) over two ``synth://`` members at phase L.1's
    widths (:data:`TRACE_SCENARIO`). Exactly one trace lands under
    ``<log_dir>/jax_trace/``, bracketing the second (steady) file; on
    the card it names K1's and K2's CUDA symbols as many times as the
    launch counters moved inside that bracket (K1 once a feed, K2 once a
    feed and once in ``Spikes``). The events stream carries the
    reference's spans: ``ingest.read`` and ``ingest.compute`` a file
    (unit: the file) and one span per stage run a file (the stage's
    name, unit: the file's base name), and the reduction's sub-stages
    (:data:`REDUCE_SUBSTAGES`, one set a scan batch), which the Chrome
    trace names too. Reports each file's compute span, the second's under
    the profiler. The trace is kept gzipped. On the
    card K1 and K2 are then held against their plain versions at each
    input shape the run gave them (:class:`KernelInputs`)."""
    import gzip

    import torch

    from comapreduce_tpu_torch.synthetic import memsource
    from comapreduce_tpu_torch.synthetic.generator import virtual_filelist
    from comapreduce_tpu_torch.synthetic.scenario import ScenarioConfig
    from comapreduce_tpu_torch.telemetry import TELEMETRY, merge_streams

    on_card = torch.device(device).type == "cuda"
    cfg = ScenarioConfig.coerce(dict(TRACE_SCENARIO, **overrides))
    memsource.register_scenario(cfg)
    files = list(virtual_filelist(cfg))
    run_cfg = shipped_chain_config()
    run_cfg["telemetry"] = {"enabled": True, "flush_s": 60.0,
                            "jax_profiler": True}
    run_dir = os.path.join(base or OBS_DIR, "device_trace")
    shutil.rmtree(run_dir, ignore_errors=True)
    runner = memory_runner(device, run_cfg, run_dir=run_dir, level2={})
    counters = kernel_counters()
    for fn in counters:
        fn.launches = 0
    bracket = {}
    maybe = TELEMETRY.maybe_jax_profile

    class Counted:
        """The profiler's context, with the counters read at its ends."""

        def __init__(self, ctx):
            self.ctx = ctx

        def __enter__(self):
            bracket["before"] = {fn.__name__: fn.launches for fn in counters}
            return self.ctx.__enter__()

        def __exit__(self, *exc):
            if on_card:
                torch.cuda.synchronize()
            bracket["after"] = {fn.__name__: fn.launches for fn in counters}
            t0 = time.perf_counter()
            try:
                return self.ctx.__exit__(*exc)
            finally:
                bracket["export_s"] = time.perf_counter() - t0

    def watched(steady):
        ctx = maybe(steady)
        return None if ctx is None else Counted(ctx)

    TELEMETRY.close()
    TELEMETRY.maybe_jax_profile = watched
    try:
        with KernelInputs() as inputs:
            t0 = _now(device)
            results = runner.run_tod(files)
            chain_s = _now(device) - t0
    finally:
        del TELEMETRY.maybe_jax_profile
        TELEMETRY.close()
        memsource.clear_registry()
    if len(results) != 2 or any(r is None for r in results):
        raise SystemExit(f"device trace: results {results}")
    trace_dir = os.path.join(runner.state_dir, "jax_trace")
    traces = sorted(os.listdir(trace_dir))
    if len(traces) != 1 or set(bracket) != {"before", "after",
                                            "export_s"}:
        raise SystemExit(f"device trace: traces {traces}, bracket "
                         f"{bracket}")
    t0 = time.perf_counter()
    path = os.path.join(trace_dir, traces[0])
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    # kept gzipped: the profiler's JSON runs to tens of MB
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.unlink(path)
    check_s = time.perf_counter() - t0
    region = {k: bracket["after"][k] - bracket["before"][k]
              for k in bracket["after"]}
    named = {sym: sum(1 for e in events if e.get("cat") == "kernel"
                      and sym in str(e.get("name", "")))
             for sym in (K1_SYMBOL, K2_SYMBOL)}
    want_region = {"masked_fill": cfg.n_feeds,
                   "rolling_median_windows": cfg.n_feeds + 1,
                   "binned_window_sum": 0, "windowed_gather": 0}
    if on_card and (region != want_region or
                    named[K1_SYMBOL] != region["masked_fill"] or
                    named[K2_SYMBOL] != region["rolling_median_windows"]):
        raise SystemExit(f"device trace: launches in the bracket {region} "
                         f"(derived {want_region}), kernels named in the "
                         f"trace {named}")
    merged = merge_streams(runner.state_dir)
    stages = [getattr(p, "name", type(p).__name__)
              for p in runner.processes]
    spans, sub = {}, {}
    for s in merged.spans:
        if s["name"].startswith("reduce."):
            sub[s["name"]] = sub.get(s["name"], 0) + 1
        else:
            spans.setdefault(s["name"], []).append(s["unit"])
    # the reduction's sub-stages, one set a scan batch, and, in the
    # Chrome trace, the program's spans opened under the profiler
    annotated = {str(e.get("name")) for e in events
                 if e.get("cat") == "user_annotation"}
    if (set(sub) != set(REDUCE_SUBSTAGES) or len(set(sub.values())) != 1
            or not set(REDUCE_SUBSTAGES) <= annotated):
        raise SystemExit(f"device trace: reduction spans {sub}, in the "
                         f"trace {sorted(annotated)}")
    want_spans = {"ingest.read": files, "ingest.compute": files}
    ran = {k: v for k, v in runner.timings.items()
           if not k.startswith("ingest.")}
    for st in ran:
        want_spans[st] = [os.path.basename(f) for f in files][
            :len(ran[st])]
    if {k: sorted(v) for k, v in spans.items()} != \
            {k: sorted(v) for k, v in want_spans.items()} or \
            not set(ran) <= set(stages):
        raise SystemExit(f"device trace: spans {spans}, want {want_spans}")
    compute = [s["dur"] for s in merged.spans_named("ingest.compute")]
    line = {"chain_s": chain_s, "trace_file": traces[0],
            "trace_events": len(events), "kernels_named": named,
            "launches_in_bracket": region,
            "launches": {fn.__name__: fn.launches for fn in counters},
            "compute_s": compute,
            "profiled_minus_unprofiled_s": compute[1] - compute[0],
            "trace_export_s": bracket["export_s"],
            "trace_read_and_gzip_s": check_s,
            "span_names": sorted(spans),
            "reduce_spans": sub, "spans_in_trace": sorted(annotated),
            "nvidia_smi": smi_line() if on_card else None}
    if on_card:
        line.update(inputs.sites("device trace"))
    log("device_trace", json.dumps(line))
    return line


def phase_observability(store, joint_maps, untraced_wall,
                        device: str = "cuda") -> dict:
    """Phase M: M.1 (:func:`phase_solver_trace`), M.2
    (:func:`phase_live_plane`), M.3 (:func:`phase_device_trace`) on the
    card. ``store`` is served
    without the calibration groups phase H added to it, as phase F read
    it, so M.2's maps are comparable with phase F's ``joint_maps``."""
    t0 = time.perf_counter()
    # phase F's reads: without the calibration groups phase H added
    store = without_groups(store, CAL_GROUPS)
    out = {"solver_trace": phase_solver_trace(store, device)}
    out["live"] = phase_live_plane(store, joint_maps, untraced_wall,
                                   device)
    out["device_trace"] = phase_device_trace(device)
    # every launch of the phase, its checks' own kernel calls aside
    runs = [out["solver_trace"]["launches"][k] for k in (
        "read", "untraced", "traced", "chunks")] + [
        out["live"]["launches"], out["device_trace"]["launches"]]
    out["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase M {out['phase_s']:.1f} s")
    return out


# Phase N: polarized destriping and the autotuner on the card. N.1 holds
# the card to the CPU at FIELD_SMALL, N.2 runs the production polarized
# solve at full width (K3 at R = 10, 7, 3 and 1), N.3 the tuner: a
# solver sweep on the full field's band 0, a stage sweep at phase L.2's
# bucket (which L.2 then consults) and the map-maker's [Tuning] consult.
POL_DIR = os.path.join(ROOT, "chiprun_out", "pol_tuning")
# N.1's card-against-CPU limits (offsets, destriped maps, naive maps).
# The scatter oracle takes the reference test's planned-against-scatter
# tolerances (tests/test_polarization.py:105-114). The planned solve is
# held wider, as set when its 3 x 3 inverses were f32: then rounding its
# K3 sums once in f64 moved its offsets 0.7e-3 to 0.9e-3, its destriped
# maps 3.7e-3 and its naive maps 3.1e-4 at 40 to 100 iterations, and the
# card against the CPU gave 2.0e-3, 6.1e-3 and 2.0e-4 (on an H100).
# With the inverses in f64 the same rounding moves them 1.9e-4 (6.2e-6
# from 60 iterations), 5.3e-4 and 2.5e-4 (tests/torch_pol_spread.py, on
# the CPU), and the card against the CPU gave 9.5e-6, 1.4e-4 and
# 1.1e-4 (on an H100); the limits are kept.
POL_ATOL = {"scatter": (2e-3, 2e-3, 1e-3), "planned": (5e-3, 2e-2, 1e-3)}
# the production budget of the planned solve's docstring
POL_N_ITER = 150
POL_SMALL_ITER = 100
# the reference test's hard problem (tests/test_polarization.py:140): its
# budget, and the landing level it holds the floored Jacobi to
POL_HARD_ITER = 300
POL_HARD_BOUND = 5e-3
# the bench's sweep settings (bench.py:2625-2690), two repeats to fit
# the phase's budget: a candidate's best of two timed solves, not three
TUNE_N_ITER = 60
TUNE_MAX_CANDIDATES = 6
TUNE_REPEATS = 2
# the documented campaign quanta (docs/OPERATIONS.md §9) L.2 runs under
CAMPAIGN = {"t_quantum": 4096, "scan_quantum": 4, "l_quantum": 1024}


def pol_psi(n: int) -> np.ndarray:
    """The demo's polarization angle over ``n`` samples
    (``examples/polarization_demo.py:29``): ``linspace(0, pi)`` plus
    ``0.3 sin(i / 77)``."""
    return (np.linspace(0, np.pi, n)
            + 0.3 * np.sin(np.arange(n) / 77.0)).astype(np.float32)


def pol_band(pixels, npix: int, n_groups: int, seed: int) -> dict:
    """A polarized TOD over ``pixels`` (numpy, from ``seed``): I of rms 1,
    Q and U of rms 0.3 seen through ``pol_psi``, 1/f offsets (a random
    walk of 0.05 an offset in each of the ``n_groups`` equal streams, as
    the field run's), white noise of 0.1, unit weights."""
    from comapreduce_tpu_torch.fieldrun import OFFSET_LENGTH

    rng = np.random.default_rng([seed, 0])
    n = pixels.size
    I = rng.normal(0.0, 1.0, npix)
    Q = 0.3 * rng.normal(size=npix)
    U = 0.3 * rng.normal(size=npix)
    psi = pol_psi(n)
    offsets = np.cumsum(rng.normal(0.0, 0.05, (
        n_groups, n // OFFSET_LENGTH // n_groups)), axis=1).reshape(-1)
    tod = (I[pixels] + Q[pixels] * np.cos(2 * psi)
           + U[pixels] * np.sin(2 * psi)
           + np.repeat(offsets, OFFSET_LENGTH)
           + rng.normal(0.0, 0.1, n)).astype(np.float32)
    return {"tod": tod, "weights": np.ones(n, np.float32), "psi": psi,
            "I": I, "Q": Q, "U": U}


def pol_hard_problem() -> tuple:
    """The reference test's hard polarized problem
    (``tests/test_polarization.py:140``): CES pointing of two feeds
    (``flagship.ces_pixels``) over 64 x 64 pixels, a random walk of 0.3
    an offset of 50 samples, I of rms 1 and white noise of 1 through an
    angle sweeping 20 turns, unit weights. ``(tod, weights, psi, pixels,
    npix, offset_length)``, numpy."""
    from comapreduce_tpu_torch.flagship import ces_pixels

    F, T, nx, L = 2, 10_000, 64, 50
    rng = np.random.default_rng(0)
    pix = np.concatenate([ces_pixels(T, nx, nx, f, F) for f in range(F)])
    n = (pix.size // L) * L
    pix = pix[:n]
    toff = np.cumsum(rng.normal(0, 0.3, n // L)).astype(np.float32)
    I = rng.normal(0, 1.0, nx * nx)
    psi = (np.linspace(0, 40 * np.pi, n)
           + rng.normal(0, 0.2, n)).astype(np.float32)
    tod = (I[pix] + np.repeat(toff, L)
           + rng.normal(0, 1.0, n)).astype(np.float32)
    return tod, np.ones(n, np.float32), psi, pix, nx * nx, L


def pol_gaps(got, want) -> dict:
    """Largest card-against-CPU gaps of two polarized results (offsets,
    destriped and naive maps on the pixels solvable in both), and the
    solvable and hit maps' agreement."""
    g = {k: getattr(got, k).cpu().numpy() for k in got._fields}
    w = {k: getattr(want, k).cpu().numpy() for k in want._fields}
    both = g["solvable"] & w["solvable"]
    return {"offsets": float(np.abs(g["offsets"] - w["offsets"]).max()),
            "iqu_destriped": float(np.abs(
                g["iqu_destriped"][both] - w["iqu_destriped"][both]).max()),
            "iqu_naive": float(np.abs(
                g["iqu_naive"][both] - w["iqu_naive"][both]).max()),
            "hits_equal": bool(np.array_equal(g["hit_map"], w["hit_map"])),
            "solvable_differ": int((g["solvable"] != w["solvable"]).sum()),
            "n_solvable": int(w["solvable"].sum()),
            "n_iter": [int(g["n_iter"]), int(w["n_iter"])],
            "residual": [float(g["residual"]), float(w["residual"])]}


def phase_pol_small(devices=("cuda", "cpu")) -> dict:
    """N.1: ``destripe_pol_planned`` and ``destripe_pol`` on FIELD_SMALL's
    band-0 pointing with a polarized TOD (:func:`pol_band`), on
    ``devices`` (the card, then the CPU): offsets, destriped and naive
    maps (on the pixels solvable in both) within ``POL_ATOL``, hit maps
    equal (the solvable masks' differences reported: a pixel at the
    ``det > 1e-6`` threshold may flip); on the card the planned solve
    launches K3 ``7 + 2 k`` times. Then :func:`pol_hard_problem` on the
    first device: ``POL_HARD_ITER`` iterations with no early stop (or
    convergence), landing below ``POL_HARD_BOUND``."""
    import torch

    from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, OFFSET_LENGTH,
                                                field_geometry)
    from comapreduce_tpu_torch.mapmaking.cuda_binning import \
        binned_window_sum
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan
    from comapreduce_tpu_torch.mapmaking.polarization import (
        destripe_pol, destripe_pol_planned)

    pix = field_geometry(FIELD_SMALL)[0]
    npix = FIELD_SMALL.nx * FIELD_SMALL.ny
    d = pol_band(pix, npix, FIELD_SMALL.n_groups, 11)
    plan = build_pointing_plan(pix, npix, OFFSET_LENGTH)
    out = {}
    for path in ("planned", "scatter"):
        res = {}
        for dev in devices:
            binned_window_sum.launches = 0
            if path == "planned":
                res[dev] = destripe_pol_planned(
                    d["tod"], d["weights"], d["psi"], plan,
                    n_iter=POL_SMALL_ITER, device=dev)
            else:
                res[dev] = destripe_pol(
                    d["tod"], pix, d["weights"], d["psi"], npix,
                    offset_length=OFFSET_LENGTH, n_iter=POL_SMALL_ITER,
                    device=dev)
            if dev == devices[0]:
                first = res[dev]
                if dev == "cuda":
                    torch.cuda.synchronize()
                k3 = binned_window_sum.launches
        gaps = pol_gaps(first, res[devices[1]])
        gaps["k3_launches"] = k3
        out[path] = gaps
        want_k3 = 7 + 2 * gaps["n_iter"][0] if (
            path == "planned" and devices[0] == "cuda") else 0
        off_atol, map_atol, naive_atol = POL_ATOL[path]
        if (gaps["offsets"] > off_atol or gaps["iqu_destriped"] > map_atol
                or gaps["iqu_naive"] > naive_atol
                or not gaps["hits_equal"] or k3 != want_k3
                or not gaps["n_solvable"]):
            raise SystemExit(f"pol small {path}: card against CPU {gaps}, "
                             f"K3 {k3} launches, derived {want_k3}")
    # the hard problem on the first device: K3's sums in its order there
    tod, w, psi, hpix, hnpix, L = pol_hard_problem()
    hard = destripe_pol_planned(tod, w, psi,
                                build_pointing_plan(hpix, hnpix, L),
                                n_iter=POL_HARD_ITER, threshold=1e-6,
                                device=devices[0])
    out["hard"] = {"device": devices[0], "n_iter": int(hard.n_iter),
                   "residual": float(hard.residual),
                   "bound": POL_HARD_BOUND}
    log("pol_small", json.dumps(out))
    if not ((int(hard.n_iter) == POL_HARD_ITER
             or float(hard.residual) < 1e-6)
            and float(hard.residual) < POL_HARD_BOUND
            and bool(torch.isfinite(hard.iqu_destriped).all())):
        raise SystemExit(f"pol hard problem: {out['hard']}")
    return out


def phase_pol_full(field_plan, geo, device: str = "cuda") -> tuple:
    """N.2: ``destripe_pol_planned`` on the full field's band-0 pointing
    (4 observations x 19 feeds x 135 700 samples, the 480 x 480 plan) with
    I, Q, U and 1/f offsets injected (:func:`pol_band`), POL_N_ITER
    iterations, twice: the second run the first's bits; the outputs
    finite, the solvable mask not empty, K3's launches of the first run
    ``7 + 2 k`` (R = 10 once, R = 7 once, R = 3 ``k + 2`` times, R = 1
    ``k + 3`` times). Reports the recovered Q and U error against the
    injection, the walls and the peak, and on the card the 3 x 3 work's
    device times in f64 and f32 (:func:`pol_3x3_ms`). Returns the line
    and the launches. (``device="cpu"`` rehearses it on a small plan.)"""
    import torch

    from comapreduce_tpu_torch.mapmaking.polarization import \
        destripe_pol_planned

    on_card = device == "cuda"
    t0 = time.perf_counter()
    d = pol_band(geo[0], field_plan.npix, int(geo[1].max()) + 1, 13)
    gen_s = time.perf_counter() - t0
    args = [torch.as_tensor(d[k], device=device)
            for k in ("tod", "weights", "psi")]
    counters = kernel_counters()
    runs, launches, walls = [], None, []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        for fn in counters:
            fn.launches = 0
        t1 = _now(device)
        res = destripe_pol_planned(*args, field_plan, n_iter=POL_N_ITER,
                                   device=device)
        walls.append(_now(device) - t1)
        if launches is None:
            launches = {fn.__name__: fn.launches for fn in counters}
        runs.append(res)
    k = int(runs[0].n_iter)
    want = {"masked_fill": 0, "rolling_median_windows": 0,
            "binned_window_sum": 7 + 2 * k if on_card else 0,
            "windowed_gather": 0}
    same = all(bits_equal(getattr(runs[0], f), getattr(runs[1], f))
               for f in ("offsets", "iqu_destriped", "iqu_naive",
                         "hit_map")) and \
        torch.equal(runs[0].solvable, runs[1].solvable)
    r = runs[0]
    ok = r.solvable.cpu().numpy()
    m = r.iqu_destriped.cpu().numpy()
    finite = all(bool(torch.isfinite(getattr(r, f)).all()) for f in (
        "offsets", "iqu_destriped", "iqu_naive", "hit_map", "residual"))
    line = {"samples": int(geo[0].size), "n_rank": field_plan.n_rank,
            "n_iter": k, "residual": float(r.residual),
            "data_gen_s": gen_s, "solve_s": walls, "launches": launches,
            "launches_derived": want, "bitwise_rerun": bool(same),
            "n_solvable": int(ok.sum()),
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                             if on_card else None)}
    for j, s in enumerate("IQU"):
        line[f"{s}_median_abs_err"] = float(np.median(np.abs(
            m[ok, j] - d[s][ok])))
        line[f"{s}_rms_injected"] = float(np.std(d[s][ok]))
    if on_card:
        line["three_by_three_ms"] = pol_3x3_ms(geo[0], field_plan.npix, d)
    log("pol_full", json.dumps(line))
    if not (same and finite and ok.any() and launches == want):
        raise SystemExit(f"pol full: bitwise {same}, finite {finite}, "
                         f"solvable {int(ok.sum())}, launches {launches} "
                         f"against {want}")
    return line, launches


def pol_3x3_ms(pixels, npix: int, d: dict) -> dict:
    """Device ms (:func:`cuda_ms`) of the planned polarized solve's
    per-pixel 3 x 3 work at N.2's hit pixels: the masked prefactor (once
    a solve) and one map solve (``k + 2`` a solve of ``k`` iterations),
    in float64 as the solve runs them and in float32 (the reference's
    arithmetic), on the normal matrices of N.2's pointing and weights."""
    import torch

    from comapreduce_tpu_torch.mapmaking import polarization as pol

    dev = torch.device("cuda")
    psi = torch.as_tensor(d["psi"], device=dev)
    state = pol._pol_accumulate(
        torch.as_tensor(pixels, device=dev).long(),
        torch.as_tensor(d["weights"], device=dev), torch.cos(2.0 * psi),
        torch.sin(2.0 * psi), npix)
    hit = state.hits > 0
    ata, ok = state.ata[hit].contiguous(), state.rcond_ok[hit]
    scale = pol._ata_scale(ata)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    b = torch.randn((3, ata.shape[0]), generator=g, device=dev)
    zero = torch.zeros((), device=dev)

    def prefactor_f32():
        return torch.where(ok[:, None, None],
                           torch.linalg.inv(pol._tikhonov(ata, scale)), zero)

    inv64, inv32 = pol._masked_inverse(ata, scale, ok), prefactor_f32()
    return {"pixels": int(ata.shape[0]),
            "prefactor_f64": cuda_ms(
                lambda: pol._masked_inverse(ata, scale, ok)),
            "prefactor_f32": cuda_ms(prefactor_f32),
            "map_solve_f64": cuda_ms(lambda: pol._apply_inverse(inv64, b)),
            "map_solve_f32": cuda_ms(lambda: pol._apply_inverse(inv32, b))}


def stage_sweep_bucket(**overrides) -> tuple:
    """Phase L.2's stage bucket ``(F, B, C, Tb, Sb, Lb)``: its members
    probed (``probe_virtual``) and canonicalised under CAMPAIGN; they
    must fall in one bucket."""
    from comapreduce_tpu_torch.ops.reduce import ShapeBuckets
    from comapreduce_tpu_torch.pipeline.campaign import campaign_bucket_set
    from comapreduce_tpu_torch.synthetic import memsource
    from comapreduce_tpu_torch.synthetic.generator import virtual_filelist
    from comapreduce_tpu_torch.synthetic.scenario import ScenarioConfig

    cfg = memsource.register_scenario(ScenarioConfig.coerce(
        dict(SYNTH_FULL, **overrides)))
    try:
        shapes = [memsource.probe_virtual(p) for p in virtual_filelist(cfg)]
    finally:
        memsource.clear_registry()
    buckets = campaign_bucket_set(shapes, ShapeBuckets(**CAMPAIGN))
    if len(buckets) != 1:
        raise SystemExit(f"L.2's members fall in {len(buckets)} buckets: "
                         f"{sorted(buckets)}")
    return next(iter(buckets))[:6], shapes


def multigrid_builds(data, blocks=(8, 16, 32)) -> dict:
    """``{block: future}`` of the two-level multigrid hierarchies of
    ``data`` (patterns and build on the host, ``offset_length`` 50), each
    on a thread of its own, started at once: the solver sweep's
    candidates, built while the card works on N.1 and N.2."""
    from concurrent.futures import ThreadPoolExecutor

    from comapreduce_tpu_torch.fieldrun import OFFSET_LENGTH
    from comapreduce_tpu_torch.mapmaking.destriper import (
        build_multigrid_hierarchy, multigrid_patterns)

    def build(b):
        t0 = time.perf_counter()
        pats = multigrid_patterns(data.pixels, data.npix, OFFSET_LENGTH,
                                  block=b, levels=2)
        hier = build_multigrid_hierarchy(
            data.pixels, data.weights, data.npix, OFFSET_LENGTH, block=b,
            levels=2, patterns=pats)
        return hier, time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=len(blocks),
                              thread_name_prefix="mg-build")
    futures = {b: pool.submit(build, b) for b in blocks}
    pool.shutdown(wait=False)
    return futures


def plan_builds(data, batches=(2, 4, 8)) -> dict:
    """``{pair_batch: future}`` of the pointing plans of ``data`` with
    merged pair chunks (host, ``offset_length`` 50), each on a thread of
    its own, started at once: the plan sweep's candidates, built while
    the card works on N.1 and N.2."""
    from concurrent.futures import ThreadPoolExecutor

    from comapreduce_tpu_torch.fieldrun import OFFSET_LENGTH
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    def build(pb):
        t0 = time.perf_counter()
        plan = build_pointing_plan(data.pixels, data.npix, OFFSET_LENGTH,
                                   pair_batch=pb)
        return plan, time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=len(batches),
                              thread_name_prefix="plan-build")
    futures = {pb: pool.submit(build, pb) for pb in batches}
    pool.shutdown(wait=False)
    return futures


def same_plan(a, b) -> bool:
    """Two pointing plans byte for byte: every array and static field."""
    for f in dataclasses.fields(a):
        if f.name == "_device":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and np.array_equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def phase_tuning(band0, field_plan, store_small, stage_log,
                 device: str = "cuda", mg_builds=None, merged_plans=None,
                 **scenario) -> dict:
    """N.3: the autotuner on the card, its winners in
    ``chiprun_out/pol_tuning/tuning.jsonl``.

    - the ``solver`` group (mg_block x mg_smooth) on the full field's
      band 0, offsets only, multigrid ``destripe_planned`` at TUNE_N_ITER
      iterations (the bench's sweep): each candidate's hierarchy built on
      the host outside the timed solves, each thunk synchronised;
    - the ``plan`` group (pair_batch) at band 0's ``(N, L)`` bucket:
      the same multigrid solve (``mg_block`` 8, ``mg_smooth`` 1, as
      ``bench.py:2645-2680`` sweeps it) on each candidate's plan, built
      on the host outside the timed solves (``merged_plans``, the
      ``field_plan`` at 1);
    - the ``stage`` group (feed_batch) at L.2's bucket: the atmosphere
      fit of ``AtmosphereRemoval`` over its 19 feeds in the candidate's
      chunks, on one card-made feed block;
    - a second ``Tuner`` on the same cache: 0 measurements, every sweep a
      hit; ``invalid_proposed`` 0 in both;
    - under ``[tuning]`` over the winners, ``build_pointing_plan`` with
      the auto ``pair_batch`` gives the plan winner's layout byte for
      byte, and a solve on it the untuned solve's bits: merged chunks
      change only the plan's padding, and K3's one-pass body sums in the
      order of the plan's ascending ids whatever the chunks (the
      reference allows rounding, ``pointing_plan.py:224-226``: its MXU
      groups the sums by chunk). Every candidate's solve is held the
      same way;
    - ``cli.run_destriper.main`` on phase F's small store with
      ``[Destriper] preconditioner = multigrid``, untuned and then with
      ``[Tuning] enabled`` over the winners: the tuned run logs the
      applied winners, and its maps agree with the untuned run's, each
      pointing component's constant aside (:func:`component_gap`),
      within 10 times the larger residual the two solves reached (of the
      map's scale).

    ``mg_builds``: :func:`multigrid_builds` of ``band0`` started earlier,
    ``merged_plans`` its :func:`plan_builds` (default: started here).
    ``device="cpu"`` with a small band, plan and ``scenario`` (knobs of
    L.2's scenario) rehearses the phase on the CPU."""
    import torch

    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.fieldrun import OFFSET_LENGTH
    from comapreduce_tpu_torch.mapmaking.destriper import destripe_planned
    from comapreduce_tpu_torch.ops.atmosphere import fit_atmosphere_segments
    from comapreduce_tpu_torch.ops.reduce import (device_hbm_bytes,
                                                  stage_feed_batches)
    from comapreduce_tpu_torch.ops.segment import plan_segments
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan
    from comapreduce_tpu_torch.tuning import (TUNING, SpaceContext, Tuner,
                                              TuningCache, plan_bucket,
                                              solver_bucket, stage_bucket,
                                              tuning_path)
    from comapreduce_tpu_torch.tuning.cache import _backend_identity

    t_phase = time.perf_counter()
    shutil.rmtree(POL_DIR, ignore_errors=True)
    os.makedirs(POL_DIR)
    platform, kind = _backend_identity()
    L = OFFSET_LENGTH
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    hbm = device_hbm_bytes(device=dev)
    tod = torch.as_tensor(band0.tod, device=dev)
    w = torch.as_tensor(band0.weights, device=dev)
    mg_builds = mg_builds or multigrid_builds(band0)
    merged_plans = merged_plans or plan_builds(band0)
    hier, host_s = {}, {}
    plans, plan_s, plan_solves = {1: field_plan}, {}, {}

    def hierarchy(b):
        if b not in hier:
            hier[b], host_s[b] = mg_builds[b].result()
        return hier[b]

    def plan_solve(plan):
        return destripe_planned(tod, w, plan, n_iter=TUNE_N_ITER,
                                threshold=1e-6, mg=hierarchy(8),
                                mg_smooth=1)

    def plan_thunk(combo):
        pb = int(combo["pair_batch"])
        if pb not in plans:
            plans[pb], plan_s[pb] = merged_plans[pb].result()

        def thunk():
            plan_solves[pb] = plan_solve(plans[pb])
            if on_card:
                torch.cuda.synchronize()
        return thunk

    def solver_thunk(combo):
        b = int(combo["mg_block"])
        hierarchy(b)

        def thunk():
            destripe_planned(tod, w, field_plan, n_iter=TUNE_N_ITER,
                             threshold=1e-6, mg=hier[b],
                             mg_smooth=int(combo["mg_smooth"]))
            if on_card:
                torch.cuda.synchronize()
        return thunk

    (F, B, C, Tb, Sb, Lb), _ = stage_sweep_bucket(**scenario)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    raw = 1e7 * (1 + 0.01 * torch.randn((B, C, Tb), generator=g,
                                        device=dev))
    am = 1.0 + torch.rand(Tb, generator=g, device=dev)
    seg = np.repeat(np.arange(Sb, dtype=np.int32), -(-Tb // Sb))[:Tb]
    seg_plan = plan_segments(seg, Sb)
    seg_t = torch.as_tensor(seg, device=dev)
    mask = torch.ones_like(raw)

    def stage_thunk(combo):
        def thunk():
            # AtmosphereRemoval's loop over the planner's chunks: the
            # stage fits one feed at a time whatever the chunk
            for idx in stage_feed_batches(F, B, C, Tb,
                                          int(combo["feed_batch"]),
                                          hbm_bytes=hbm):
                for _ in idx:
                    fit_atmosphere_segments(raw, am, seg_t, mask,
                                            n_scans=Sb, plan=seg_plan)
            if on_card:
                torch.cuda.synchronize()
        return thunk

    cache_path = tuning_path(POL_DIR)
    sweeps = [
        ("solver", solver_bucket(L),
         SpaceContext(n_samples=int(band0.tod.size), offset_length=L,
                      platform=platform, hbm_bytes=hbm),
         solver_thunk, {"mg_block": 8, "mg_smooth": 1}),
        ("plan", plan_bucket(int(band0.tod.size), L),
         SpaceContext(n_samples=int(band0.tod.size), offset_length=L,
                      platform=platform, hbm_bytes=hbm),
         plan_thunk, {"pair_batch": 1}),
        ("stage", stage_bucket(F, B, C, Tb, 1),
         SpaceContext(F=F, B=B, C=C, T=Tb, S=Sb, L=Lb, platform=platform,
                      hbm_bytes=hbm),
         stage_thunk, {"feed_batch": F}),
    ]
    tuners, recs = [], {}
    for round_ in range(2):
        tuner = Tuner(TuningCache(cache_path), platform, kind,
                      max_candidates=TUNE_MAX_CANDIDATES,
                      repeats=TUNE_REPEATS)
        t0 = time.perf_counter()
        for group, bucket, ctx, build, default in sweeps:
            recs[(group, round_)] = tuner.tune(group, bucket, ctx, build,
                                               default)
        tuners.append({"wall_s": time.perf_counter() - t0,
                       "measurements": tuner.measurements,
                       "cache_hits": tuner.cache_hits,
                       "cache_misses": tuner.cache_misses,
                       "invalid_proposed": tuner.invalid_proposed,
                       "pruned": tuner.pruned})
    cold, warm = tuners
    if (cold["invalid_proposed"] or warm["invalid_proposed"]
            or warm["measurements"] or warm["cache_hits"] != len(sweeps)
            or cold["cache_misses"] != len(sweeps)):
        raise SystemExit(f"tuning: cold sweep {cold}, warm {warm}")
    winners = {group: recs[(group, 0)] for group, *_ in sweeps}
    # the auto plan under [tuning], its solve, and every candidate's
    # solve, against the untuned plan's solve
    win_pb = int(winners["plan"]["winner"]["pair_batch"])
    TUNING.configure(POL_DIR, {"enabled": True})
    try:
        t0 = time.perf_counter()
        tuned_plan = build_pointing_plan(band0.pixels, band0.npix, L)
        tuned_build_s = time.perf_counter() - t0
    finally:
        TUNING.close()
    tuned_layout = (tuned_plan.pair_batch == win_pb
                    and same_plan(tuned_plan, plans[win_pb]))
    plan_solves["tuned"] = plan_solve(tuned_plan)
    base = plan_solves[1]
    plan_bits = {str(k): all(bits_equal(getattr(r, f), getattr(base, f))
                             for f in ("offsets", "destriped_map",
                                       "naive_map", "residual"))
                 for k, r in plan_solves.items()}
    walls = winners["plan"]["walls_ms"]
    plan_line = {
        "candidates_ms": walls, "winner": win_pb,
        "default_ms": winners["plan"]["default_ms"],
        "best_ms": winners["plan"]["best_ms"],
        # the winner's margin over the default (0 when it is the
        # default) and the fastest challenger's (negative: slower)
        "margin": (1.0 - winners["plan"]["best_ms"]
                   / winners["plan"]["default_ms"]),
        "best_challenger_margin": 1.0 - min(
            v for k, v in walls.items() if k != "pair_batch=1")
        / winners["plan"]["default_ms"],
        "build_s": plan_s, "tuned_build_s": tuned_build_s,
        "tuned_pair_batch": tuned_plan.pair_batch,
        "tuned_layout_equal": bool(tuned_layout),
        "P_pad": {str(pb): int(p.pair_rank.shape[0])
                  for pb, p in plans.items()},
        "solve_bits_equal": plan_bits,
        "n_iter": int(base.n_iter), "residual": float(base.residual)}
    log("plan_sweep", json.dumps(plan_line))
    if not (tuned_layout and all(plan_bits.values())
            and set(plans) == {1, 2, 4, 8}):
        raise SystemExit(f"tuning: the plan sweep {plan_line}")
    del hier, tod, w, raw, mask, plans, plan_solves, tuned_plan
    if on_card:
        torch.cuda.empty_cache()

    # the map-maker's [Tuning] consult on phase F's small store
    name = "Level2_comap-0000007.hd5"
    filelist = os.path.join(POL_DIR, "l2list.txt")
    with open(filelist, "w") as fh:
        fh.write(name + "\n")
    maps, runs, datas = {}, {}, {}
    for tag in ("untuned", "tuned"):
        out = os.path.join(POL_DIR, tag)
        logs = os.path.join(out, "logs")
        os.makedirs(logs)
        sections = {"Destriper": {"preconditioner": "multigrid"}}
        if tag == "tuned":
            shutil.copy(cache_path, tuning_path(logs))
            sections["Tuning"] = {"enabled": "true"}
        ini = shipped_destriper_ini(filelist, out,
                                    os.path.join(POL_DIR, f"{tag}.ini"),
                                    SMALL_FIELD, sections=sections,
                                    bands=[0, 1], log_dir=logs)
        stage_log.clear()
        try:
            with ServedLevel2({name: store_small}), \
                    MainProbe(device) as probe:
                if rd_main([ini, f"--device={device}"]) != 0:
                    raise SystemExit(f"tuning: main ({tag}) failed")
        finally:
            TUNING.close()
        maps[tag] = [wr["maps"] for wr in probe.writes]
        datas[tag] = [probe.datas[b] for b in sorted(probe.datas)]
        runs[tag] = {"cg_iters": [wr["n_iter"] for wr in probe.writes],
                     "residual": [wr["residual"] for wr in probe.writes],
                     "applied": [x for x in stage_log.warnings
                                 if "applying measured winners" in x]}
    res_max = max(runs["tuned"]["residual"] + runs["untuned"]["residual"])
    gap = max(component_gap(t, u, d, L) for t, u, d in zip(
        maps["tuned"], maps["untuned"], datas["untuned"]))
    win = winners["solver"]["winner"]
    want_log = (f"mg_block={win['mg_block']}, "
                f"mg_smooth={win['mg_smooth']}")
    line = {"cold": cold, "warm": warm, "hierarchy_host_s": host_s,
            "winners": {k: {f: v.get(f) for f in (
                "winner", "default", "best_ms", "default_ms", "candidates",
                "measurements", "walls_ms")} for k, v in winners.items()},
            "stage_bucket": [F, B, C, Tb, Sb, Lb], "plan": plan_line,
            "consult": runs,
            "map_gap_of_scale": gap, "gap_limit": 10 * res_max,
            "cache": cache_path}
    line["phase_s"] = time.perf_counter() - t_phase
    log("tuning", json.dumps(line))
    if not (runs["tuned"]["applied"] and
            want_log in runs["tuned"]["applied"][0]
            and not runs["untuned"]["applied"]
            and gap <= 10 * res_max):
        raise SystemExit(f"tuning: the [Tuning] consult {runs}, map gap "
                         f"{gap} against 10 x residual {res_max}")
    return line


def phase_pol_tuning(field_plan, geo, band0, store_small,
                     stage_log) -> dict:
    """Phase N: N.1 (:func:`phase_pol_small`), N.2
    (:func:`phase_pol_full`), N.3 (:func:`phase_tuning`) on the card."""
    t0 = time.perf_counter()
    # N.3's host builds run on threads while N.1 and N.2 use the card
    builds = multigrid_builds(band0)
    merged = plan_builds(band0)
    out = {"small": phase_pol_small()}
    out["full"], out["launches"] = phase_pol_full(field_plan, geo)
    out["tuning"] = phase_tuning(band0, field_plan, store_small, stage_log,
                                 mg_builds=builds, merged_plans=merged)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase N {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase O: several shards and several ranks
# ---------------------------------------------------------------------------

#: the sharded field solve's mesh: four shards of the flat time axis, a
#: 2 x 2 ('feed', 'time') mesh, all on the one card
SHARDS = 4
#: the sharded solves against their one-shard twins on the card, on the
#: null-space-invariant products (mean-removed offsets or baselines,
#: slopes, the mean-removed hit-pixel map), of the map's scale. A
#: converged route (two-level, multigrid: residual < 1e-6) is held to
#: FIELD_ATOL, the solve_band parity bound (measured 1.7e-5 and 3.4e-5);
#: the ground route's Jacobi solve stops at its 100-iteration cap at a
#: residual near 4e-5, where the shards' sums, added in another order
#: than the one-shard solve's, move the iterate along the weak slope <->
#: sky-gradient mode: 5.9e-4 of scale on the slopes and the map
#: (measured on an H100, PERF.md), held to SHARD_GROUND_ATOL
SHARD_GROUND_ATOL = 2e-3


def _sync_on(dev) -> float:
    """``time.perf_counter()`` after the card's queue drains (on the CPU
    at once): the phase O parts take a device to rehearse on the CPU."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def _on_card(dev) -> bool:
    import torch

    return torch.device(dev).type == "cuda"


def _same_bits(a, b) -> bool:
    """:func:`bits_equal` of two results' fields, tensors or host numpy."""
    import torch

    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))

    a, b = t(a), t(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        bits_equal(a.cpu().float(), b.cpu().float())


def _shard_invariants(res, data, L, ground: bool) -> dict:
    """Null-space-invariant products of a band solve whose maps may be
    host numpy (the sharded route expands them on the host)."""
    from comapreduce_tpu_torch.mapmaking.destriper import \
        ground_ids_per_offset

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") \
            else np.asarray(x)

    a = host(res.offsets).astype(np.float64)
    m = host(res.destriped_map).astype(np.float64)
    hit = host(res.hit_map) > 0
    out = {}
    if ground:
        g = host(res.ground).astype(np.float64)
        gid = ground_ids_per_offset(np.asarray(data.ground_ids), L)
        a = a[:gid.size] + g[gid, 0]
        out["slopes"] = g[:, 1]
    out["offsets"] = a - a.mean()
    out["map"] = m[hit] - m[hit].mean()
    return out, hit


def phase_sharded_field(geo, stage_log, device: str = "cuda",
                        shape=None) -> dict:
    """O.1: ``solve_band(sharded=True)`` on the full field run
    (``FIELD_FULL``: 4 observations x 19 feeds x 135 700 samples a band)
    on a mesh of four shards on the card, one band a route: the
    two-level route (band 0, offsets only, ``coarse_block`` 8), the
    multigrid route (band 1, ``MG_KW``) and the ground route (band 2,
    the sharded ground program's Jacobi). Each is held to its one-shard
    twin (``solve_band`` on the card, the same knobs) on the invariant
    products; per shard, K3 launches as :func:`k3_launches` derives and
    K4 once per ground CG iteration (``spmd.last_run_launches``); the
    ground route run twice, the same bits. ``device="cpu"`` and
    ``shape=fieldrun.FIELD_SMALL`` rehearse it on the CPU (no launches
    there)."""
    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, MG_KW,
                                                OFFSET_LENGTH,
                                                make_field_band)
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, windowed_gather)
    from comapreduce_tpu_torch.parallel import feed_time_mesh, spmd

    L = OFFSET_LENGTH
    sh = FIELD_FULL if shape is None else shape
    dev = "cuda:0" if _on_card(device) else "cpu"
    mesh = feed_time_mesh([dev] * SHARDS)
    routes = {"twolevel": (0, {"coarse_block": 8}),
              "multigrid": (1, {"mg": MG_KW}),
              "ground": (2, {"use_ground": True})}
    out, launches = {}, {"binned_window_sum": 0, "windowed_gather": 0}
    for name, (band, knobs) in routes.items():
        data, _ = make_field_band(sh, geo, band % sh.n_bands)
        ground = bool(knobs.get("use_ground"))
        kw = dict(offset_length=L, n_iter=100, threshold=1e-6, **knobs)
        stage_log.clear()
        binned_window_sum.launches = windowed_gather.launches = 0
        t0 = _sync_on(dev)
        res = solve_band(data, sharded=True, mesh=mesh, **kw)
        wall = _sync_on(dev) - t0
        per_shard = [dict(c) for c in spmd.last_run_launches()]
        k = int(res.n_iter)
        nu = MG_KW["smooth"] if "mg" in knobs else 0
        want3 = k3_launches(k, ground=ground, nu=nu)
        want4 = k if ground else 0
        if not _on_card(dev):
            want3 = want4 = 0
        if len(per_shard) != SHARDS or any(
                c.get("binned_window_sum", 0) != want3
                or c.get("windowed_gather", 0) != want4
                for c in per_shard):
            raise SystemExit(f"sharded {name}: launches per shard "
                             f"{per_shard}, want K3 {want3} and K4 {want4}")
        if binned_window_sum.launches != SHARDS * want3:
            raise SystemExit(f"sharded {name}: K3 counted "
                             f"{binned_window_sum.launches} times")
        launches["binned_window_sum"] += binned_window_sum.launches
        launches["windowed_gather"] += windowed_gather.launches
        host_s = sum(stage_log.seconds(s) for s in
                     ("plan_build", "coarse_build", "mg_build",
                      "coarse_pattern", "mg_patterns"))
        t1 = _sync_on(dev)
        one = solve_band(data, device=dev, **kw)
        one_wall = _sync_on(dev) - t1
        a, hit = _shard_invariants(res, data, L, ground)
        b, hit1 = _shard_invariants(one, data, L, ground)
        if not np.array_equal(hit, hit1) or not np.isfinite(
                a["map"]).all():
            raise SystemExit(f"sharded {name}: hit pixels differ from the "
                             "one-shard solve's, or non-finite maps")
        scale = max(float(b["map"].std()), 1.0)
        diff = {kk: float(np.abs(a[kk] - b[kk]).max()) / scale for kk in a}
        atol = SHARD_GROUND_ATOL if ground else FIELD_ATOL
        if not max(diff.values()) <= atol:
            raise SystemExit(f"sharded {name}: differs from the one-shard "
                             f"solve by {diff} of scale > {atol}")
        line = {"band": band, "wall_s": wall, "host_build_s": host_s,
                "one_shard_wall_s": one_wall, "cg_iters": k,
                "one_shard_cg_iters": int(one.n_iter),
                "residual": float(res.residual),
                "one_shard_residual": float(one.residual),
                "diff_of_scale": diff, "atol": atol,
                "launches_per_shard": per_shard}
        if ground:
            again = solve_band(data, sharded=True, mesh=mesh, **kw)
            same = all(_same_bits(getattr(again, f), getattr(res, f))
                       for f in ("offsets", "ground", "destriped_map",
                                 "naive_map", "weight_map", "hit_map"))
            if not same:
                raise SystemExit("sharded ground route: a second run is "
                                 "not the same bits")
            line["rerun_bitwise"] = True
        log(f"sharded_{name}", json.dumps(line))
        out[name] = line
        del data, res, one
    return out, launches


def merged_chunk_check(geo, device: str = "cuda", shape=None,
                       pair_batch: int = 8) -> dict:
    """K3 and K4 on merged pair chunks: one shard's plan of the full
    field's band pointing (a quarter of it, as O.1's shards hold) built
    with ``pair_batch`` 8, so its rank and offset windows come from
    chunks of 8 x 4 096 pairs. K3 at the rank and offset sites through
    :func:`check_window_sum` (routing exact, values within the f32 bound,
    three launches the same bits) and K4 on a two-row source against its
    plain version (bitwise); no gate refuses the wide windows (K3's
    one-pass body keeps no window on chip)."""
    import torch

    from comapreduce_tpu_torch.fieldrun import FIELD_FULL, OFFSET_LENGTH
    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        windowed_gather, windowed_gather_plain)
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    sh = FIELD_FULL if shape is None else shape
    dev = torch.device("cuda:0" if _on_card(device) else "cpu")
    L = OFFSET_LENGTH
    pix = geo[0][:(geo[0].size // (SHARDS * L)) * L]
    t0 = time.perf_counter()
    p = build_pointing_plan(pix, sh.nx * sh.ny, L, pair_batch=pair_batch)
    build_s = time.perf_counter() - t0
    dv = p.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    perm = dv["pair_perm_off"].long()
    po_off = dv["pair_offset"][perm]
    P = int(dv["pair_rank"].shape[0])
    vals = torch.randn((1, P), generator=g, device=dev)
    rank = check_window_sum("merged rank", vals, dv["pair_rank"],
                            dv["rank_base"], p.rank_window, p.pair_chunk,
                            p.n_rank, ids_sorted=True)
    off = check_window_sum("merged off", vals, po_off, dv["off_base"],
                           p.off_window, p.pair_chunk, p.n_offsets,
                           ids_sorted=True)
    src = torch.randn((2, p.n_offsets), generator=g, device=dev)
    args = (po_off, dv["off_base"], p.off_window, p.pair_chunk)
    if not bits_equal(windowed_gather(src, *args),
                      windowed_gather_plain(src, *args)):
        raise SystemExit("K4 on merged pair chunks differs from its plain "
                         "version")
    line = {"pair_batch": p.pair_batch, "pair_chunk": p.pair_chunk,
            "rank_window": p.rank_window, "off_window": p.off_window,
            "pairs": P, "plan_build_s": build_s,
            "k3_rank_max_abs_err": rank[0], "k3_off_max_abs_err": off[0],
            "k4_bitwise": True}
    log("merged_chunks", json.dumps(line))
    return line


def phase_sharded_reduce(n_feeds: int = 2, device: str = "cuda",
                         shape=None) -> dict:
    """O.2: the reduce stage's ``parallel.sharded.reduce_feeds_sharded``
    over a two-shard mesh on the card, one full-width feed batch (the
    stage's ``feed_batch`` 2 of the flagship's feeds: 4 x 1024 x 135 704
    counts a feed, made on the card, NaN outside the scans, ``mask=None``
    as the stage passes it), against the one-device reduction (a
    one-shard mesh, ``reduce_feeds``' bits): every product bitwise, K1,
    K2 and K5 launched per shard once per feed and scan batch. ``device``
    and ``shape`` (``flagship.SMALL``) rehearse it on the CPU."""
    import torch

    from comapreduce_tpu_torch.flagship import (FULL, VANE_TEMPERATURE,
                                                make_flagship_inputs)
    from comapreduce_tpu_torch.ops.reduce import (ReduceConfig,
                                                  scan_starts_lengths)
    from comapreduce_tpu_torch.ops.vane import _event_kernel
    from comapreduce_tpu_torch.parallel import (feed_time_mesh, local_mesh,
                                                reduce_feeds_sharded, spmd)

    dev = torch.device("cuda:0" if _on_card(device) else "cpu")
    sh = FULL if shape is None else shape
    inputs = make_flagship_inputs(sh, seed=11, device=dev)
    starts, lengths, L = scan_starts_lengths(inputs.edges)
    feeds = [inputs.feed(f, dev) for f in range(n_feeds)]
    tod = torch.stack([x["tod"] for x in feeds])
    am = torch.stack([x["airmass"] for x in feeds])
    cal = [_event_kernel(x["vane_tod"][None], VANE_TEMPERATURE)
           for x in feeds]
    tsys = torch.cat([c[0] for c in cal])
    gain = torch.cat([c[1] for c in cal])
    del feeds
    # the stage's branch: samples outside the scans NaN in the counts,
    # validity from isfinite and the NaN fill on the device (mask=None)
    tod.masked_fill_(torch.as_tensor(inputs.scan_mask, device=dev) == 0,
                     float("nan"))
    freq = torch.as_tensor(inputs.freq, device=dev)
    cfg = ReduceConfig(sh.n_channels, medfilt_window=sh.window,
                       scan_batch=sh.scan_batch)
    outs, walls, per_shard = {}, {}, {}
    for label, mesh in (("two_shards", feed_time_mesh([dev] * 2,
                                                       n_feed=2)),
                        ("one_device", local_mesh(dev))):
        t0 = _sync_on(dev)
        outs[label] = reduce_feeds_sharded(mesh, tod, None, am, starts,
                                           lengths, tsys, gain, freq, cfg,
                                           L=L)
        walls[label] = _sync_on(dev) - t0
        per_shard[label] = [dict(c) for c in spmd.last_run_launches()]
    n_batches = -(-len(starts) // (sh.scan_batch or len(starts)))
    for c in per_shard["two_shards"]:
        want = n_batches * (n_feeds // 2) if _on_card(dev) else 0
        if c.get("masked_fill", 0) != want or \
                c.get("rolling_median_windows", 0) != want or \
                c.get("prefilter", 0) != want:
            raise SystemExit(f"sharded reduction: launches per shard "
                             f"{per_shard['two_shards']}, want {want} each")
    diff = {}
    for k in outs["one_device"]:
        a, b = outs["two_shards"][k], outs["one_device"][k]
        diff[k] = 0.0 if bits_equal(a, b) else float(
            (a - b).abs().max())
    if any(diff.values()) or not bool(
            torch.isfinite(outs["two_shards"]["tod"]).all()):
        raise SystemExit(f"sharded reduction differs from the one-device "
                         f"reduction: {diff}")
    line = {"feeds": n_feeds, "walls_s": walls, "bitwise": True,
            "max_abs_diff": diff, "launches_per_shard": per_shard}
    log("sharded_reduce", json.dumps(line))
    del tod, outs
    return line


def phase_observation_step(plan, device: str = "cuda",
                           shape=None) -> dict:
    """O.3: ``parallel.ObservationStep`` on a (2, 2) mesh on the card at
    the flagship shape (F=19, B=4, C=1024, 10 CES scans of 13 500, the
    480 x 480 field, 100 Jacobi iterations): its four feed-shard
    reductions against ``flagship.run_flagship``'s single-device chain on
    the same generated observation (the reduced TOD and weights bitwise,
    one feed at a time on both), its hits B times the flagship's (the
    step maps every band into one map), its naive map against the
    flagship's weight-combined band maps (MAP_ATOL of scale), and its
    destriped map against the same flat solve on a one-device mesh
    (MAP_ATOL of scale; the step's offsets never straddle a (feed, band)
    row, the flagship's do, so those two maps differ by construction).
    ``device`` and ``shape`` (``flagship.SMALL``) rehearse it on the
    CPU."""
    import torch

    from comapreduce_tpu_torch.flagship import (FULL, ces_pixels,
                                                make_flagship_inputs,
                                                run_flagship)
    from comapreduce_tpu_torch.ops.cuda_median import (
        masked_fill, rolling_median_windows)
    from comapreduce_tpu_torch.ops.prefilter import prefilter
    from comapreduce_tpu_torch.parallel import (ObservationStep,
                                                feed_time_mesh, local_mesh)
    from comapreduce_tpu_torch.parallel.sharded import destripe_sharded

    dev = torch.device("cuda:0" if _on_card(device) else "cpu")
    sh = FULL if shape is None else shape
    F, B, C = sh.n_feeds, sh.n_bands, sh.n_channels
    inputs = make_flagship_inputs(sh, seed=13, device=dev)
    T = inputs.scan_mask.shape[0]
    npix = sh.nx * sh.ny
    t0 = _sync_on(dev)
    flag = run_flagship(inputs, device=dev, plan=plan)
    flag_wall = _sync_on(dev) - t0
    ref_tod = flag["band_tod"][:, :F * T].reshape(B, F, T).transpose(0, 1)
    ref_w = flag["band_w"][:, :F * T].reshape(B, F, T).transpose(0, 1)
    fres = flag["result"]
    del flag
    t1 = _sync_on(dev)
    tod = torch.empty((F, B, C, T), dtype=torch.float32, device=dev)
    vane = torch.empty((F, B, C, sh.vane_samples), dtype=torch.float32,
                       device=dev)
    am = torch.empty((F, T), dtype=torch.float32, device=dev)
    for f in range(F):
        x = inputs.feed(f, dev)
        tod[f], vane[f], am[f] = x["tod"], x["vane_tod"], x["airmass"]
        del x
    pixels = np.stack([ces_pixels(T, sh.nx, sh.ny, f, F) for f in range(F)])
    gen_s = _sync_on(dev) - t1
    mesh = feed_time_mesh([str(dev)] * 4, n_feed=2)
    step = ObservationStep(mesh, inputs.edges, T, npix,
                           offset_length=sh.offset_length, n_iter=sh.n_iter,
                           threshold=sh.threshold, n_channels=C,
                           medfilt_window=sh.window,
                           scan_batch=sh.scan_batch)
    masked_fill.launches = rolling_median_windows.launches = 0
    prefilter.launches = 0
    t2 = _sync_on(dev)
    red, res = step(tod, torch.as_tensor(inputs.scan_mask, device=dev),
                    vane, am, pixels, torch.as_tensor(inputs.freq,
                                                      device=dev))
    step_wall = _sync_on(dev) - t2
    k12 = (masked_fill.launches, rolling_median_windows.launches,
           prefilter.launches)
    del tod, vane
    if not (bits_equal(red["tod"], ref_tod)
            and bits_equal(red["weights"], ref_w)):
        raise SystemExit("observation step: the reduced TOD or weights "
                         "differ from the flagship chain's")
    n_k = F * -(-sh.n_scans // (sh.scan_batch or sh.n_scans)) \
        if _on_card(dev) else 0
    if k12 != (n_k, n_k, n_k):
        raise SystemExit(f"observation step: K1, K2, K5 launched {k12}, "
                         f"not ({n_k}, {n_k}, {n_k})")
    hits = res.hit_map.cpu().numpy()
    if not np.array_equal(hits, B * fres.hit_map.cpu().numpy()):
        raise SystemExit("observation step: hits are not B x the "
                         "flagship's")
    w_b = fres.weight_map.double()
    comb = ((fres.naive_map.double() * w_b).sum(0)
            / w_b.sum(0).clamp(min=1e-30)).cpu().numpy()
    hit = hits > 0
    naive = res.naive_map.cpu().numpy()
    scale = max(float(np.nanstd(naive[hit])), 1.0)
    naive_d = float(np.abs(naive[hit] - comb[hit]).max()) / scale
    flat = step.flatten(red, pixels)
    t3 = _sync_on(dev)
    one = destripe_sharded(local_mesh(dev), *flat, npix,
                           offset_length=sh.offset_length, n_iter=sh.n_iter,
                           threshold=sh.threshold)
    one_wall = _sync_on(dev) - t3
    m, m1 = (r.destriped_map.cpu().numpy()[hit] for r in (res, one))
    dest_d = float(np.abs((m - m.mean()) - (m1 - m1.mean())).max()) / scale
    if not (naive_d <= MAP_ATOL and dest_d <= MAP_ATOL
            and np.isfinite(m).all()):
        raise SystemExit(f"observation step: naive map {naive_d}, "
                         f"destriped map {dest_d} of scale > {MAP_ATOL}")
    line = {"flagship_wall_s": flag_wall, "tod_gen_s": gen_s,
            "step_wall_s": step_wall, "one_device_destripe_s": one_wall,
            "cg_iters": int(res.n_iter), "one_device_cg_iters":
            int(one.n_iter), "residual": float(res.residual),
            "level2_bitwise": True, "naive_diff_of_scale": naive_d,
            "destriped_diff_of_scale": dest_d, "k1_k2_k5": k12}
    log("observation_step", json.dumps(line))
    return line


def phase_two_ranks(store, stage_log, device: str = "cuda") -> dict:
    """O.4: ``run_destriper.main`` as ranks 0 and 1 of 2
    (``COMAP_RANK`` / ``COMAP_NRANKS``) on the card, over phase F's small
    store served as two files, one a rank: run in turn in this process
    (a second process would have to rebuild the served store), so the
    straggler barrier is off here (``straggler_timeout_s : 0``; the two-
    process barrier is ``tests/test_torch_multihost.py``'s on the CPU).
    Each rank writes its ``_rank{r}`` maps, every image bitwise the map
    ``main`` writes as one rank over that rank's file alone (the
    fixed-order K3 gives the same bits). Their co-add through
    ``mapmaking.coadd`` is held to the one-rank map over both files on
    what adds across files: hits exact, weights and naive maps within
    MAP_ATOL. (The destriped maps are not compared there: two files
    destriped apart share no sky constraint, so their co-add is another
    solution than the joint solve's.) ``device="cpu"`` rehearses it on
    the CPU."""
    from comapreduce_tpu_torch.cli.run_destriper import main as rd_main
    from comapreduce_tpu_torch.mapmaking.coadd import coadd_maps
    from comapreduce_tpu_torch.mapmaking.fits_io import read_fits_image

    names = ["Level2_rank-a.hd5", "Level2_rank-b.hd5"]
    out = os.path.join(ROOT, "chiprun_out", "ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    lists = {}
    for tag, files in (("both", names), ("a", names[:1]),
                       ("b", names[1:])):
        lists[tag] = os.path.join(out, f"l2list_{tag}.txt")
        with open(lists[tag], "w") as fh:
            fh.write("\n".join(files) + "\n")
    res = {"quarantine": "off", "lease_ttl_s": 0, "straggler_timeout_s": 0}
    saved = {k: os.environ.get(k) for k in ("COMAP_RANK", "COMAP_NRANKS")}
    # (tag, rank or None for one rank, filelist, map folder)
    runs = [("rank0", 0, "both", "maps"), ("rank1", 1, "both", "maps"),
            ("one", None, "both", "one"), ("solo_a", None, "a", "solo_a"),
            ("solo_b", None, "b", "solo_b")]
    walls = {}
    try:
        with ServedLevel2({n: store for n in names}) as served:
            for tag, r, files, folder in runs:
                if r is None:
                    os.environ.pop("COMAP_RANK", None)
                    os.environ.pop("COMAP_NRANKS", None)
                else:
                    os.environ["COMAP_RANK"] = str(r)
                    os.environ["COMAP_NRANKS"] = "2"
                ini = shipped_destriper_ini(
                    lists[files], os.path.join(out, folder),
                    os.path.join(out, f"{tag}.ini"), SMALL_FIELD,
                    bands=[0, 1], sections={"Resilience": res})
                t0 = _sync_on(device)
                if rd_main([ini, f"--device={device}"]) != 0:
                    raise SystemExit(f"two ranks: main as {tag} failed")
                walls[tag] = _sync_on(device) - t0
            reads = dict(served.calls)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    written = sorted(f for f in os.listdir(os.path.join(out, "maps"))
                     if f.endswith(".fits"))
    want = [f"map_band{b}_rank{r}.fits" for b in (0, 1) for r in (0, 1)]
    prefix = written[0].split("_band")[0] if written else ""
    if [w.replace(prefix, "map", 1) for w in written] != want:
        raise SystemExit(f"two ranks wrote {written}")

    def maps(*path):
        return {n: d for n, _, d in read_fits_image(os.path.join(out,
                                                                 *path))}

    diff = {}
    for b in (0, 1):
        ranks = [maps("maps", f"{prefix}_band{b}_rank{r}.fits")
                 for r in (0, 1)]
        for r, solo in ((0, "solo_a"), (1, "solo_b")):
            alone = maps(solo, f"{prefix}_band{b}.fits")
            same = sorted(ranks[r]) == sorted(alone) and all(
                np.array_equal(ranks[r][k], alone[k], equal_nan=True)
                for k in alone)
            if not same:
                raise SystemExit(f"two ranks band {b}: rank {r}'s map is "
                                 f"not the bits of {solo}'s one-rank map")
        co = coadd_maps(ranks)
        one = maps("one", f"{prefix}_band{b}.fits")
        if not (np.array_equal(co["HITS"], one["HITS"])
                and (one["HITS"] > 0).any()):
            raise SystemExit(f"two ranks band {b}: co-added hits differ")
        hit = one["HITS"] > 0
        scale = max(float(np.nanstd(one["DESTRIPED"][hit])), 1.0)
        d = {}
        for k in ("NAIVE", "WEIGHTS"):
            ref = float(np.abs(one[k]).max()) if k == "WEIGHTS" else scale
            d[k] = float(np.abs(co[k][hit] - one[k][hit]).max()) / ref
        if not (d["NAIVE"] <= MAP_ATOL and d["WEIGHTS"] <= MAP_ATOL):
            raise SystemExit(f"two ranks band {b}: the co-add differs from "
                             f"the one-rank map by {d} (limit {MAP_ATOL})")
        diff[f"band{b}"] = d
    line = {"walls_s": walls, "files": written, "reads": reads,
            "rank_maps_bitwise_solo": True, "coadd_diff_of_scale": diff,
            "barrier": "off (in turn)"}
    log("two_ranks", json.dumps(line))
    return line


def phase_sharded(geo, plan, store_small, stage_log, device: str = "cuda",
                  field=None, flagship=None) -> dict:
    """Phase O: O.1 (:func:`phase_sharded_field`), O.2
    (:func:`phase_sharded_reduce`), O.3 (:func:`phase_observation_step`),
    O.4 (:func:`phase_two_ranks`), each with its wall. ``device="cpu"``
    with ``field=fieldrun.FIELD_SMALL`` (``geo`` its geometry) and
    ``flagship=flagship.SMALL`` (``plan`` its plan) rehearses it on the
    CPU."""
    out, walls = {}, {}
    t0 = time.perf_counter()
    out["field"], launches = phase_sharded_field(geo, stage_log, device,
                                                 field)
    out["merged_chunks"] = merged_chunk_check(geo, device, field)
    walls["field"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["reduce"] = phase_sharded_reduce(device=device, shape=flagship)
    walls["reduce"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    out["step"] = phase_observation_step(plan, device, flagship)
    walls["step"] = time.perf_counter() - t2
    t3 = time.perf_counter()
    out["ranks"] = phase_two_ranks(store_small, stage_log, device)
    walls["ranks"] = time.perf_counter() - t3
    k12 = out["reduce"]["launches_per_shard"]["two_shards"]
    launches["masked_fill"] = sum(c.get("masked_fill", 0) for c in k12)
    launches["rolling_median_windows"] = sum(
        c.get("rolling_median_windows", 0) for c in k12)
    launches["prefilter"] = sum(c.get("prefilter", 0) for c in k12)
    out["launches"] = launches
    out["walls_s"] = walls
    log(f"phase O {json.dumps(walls)}")
    return out


# ---------------------------------------------------------------------------
# Phase P: the last reference modules — the gain CG solve, filtering and
# statistics, radio recombination lines, apparent-place astrometry
# ---------------------------------------------------------------------------

#: the stage chain's widths (phase E) and phase H's calibrator length
P_FULL = dict(F=19, B=4, C=1024, T=136_216, T_cal=30_896)
#: the 1/f prior of P.1: the solve converges in about 23 iterations of
#: its 50 on these inputs (measured on the CPU at 4096 x 8 192)
GAIN_PRIOR = dict(white_noise=0.1, fknee=1.0, alpha=-1.0, n_iter=50)
#: card against CPU on the same inputs, as a share of the largest |value|
#: (or relative): cuBLAS / cuFFT and the CPU's f32 dots and FFTs add in
#: other orders; the CPU tests hold the port to the reference within
#: 5e-6 (the CG), 2e-6 (the low-pass), 1e-6 (the sums)
GAIN_CG_ATOL = 1e-4
FILTER_ATOL = 2e-5
STATS_RTOL = 1e-5
RRL_RTOL = 1e-5
#: the reference's astrometry bounds (tests/test_astro.py): the strided
#: h2e -> e2h round trip of feed streams, native against NumPy
ROUND_TRIP_ARCSEC = 3.0
NATIVE_ARCSEC = 0.2


def _gap(got, want, scale=None) -> float:
    """max |got - want| (tensors on any device) over ``scale`` (default
    max |want|)."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    den = scale if scale is not None else float(want.abs().max())
    return float((got - want).abs().max()) / max(den, 1e-300)


def _gain_inputs(g, device, B, C, T):
    """One feed's stacked channels ``y`` f32[B C, T] (white noise on a
    common gain drift, made on ``device`` from the generator ``g``), the
    templates ``(T2, p)`` as the stage chain builds them (Tsys, the
    scaled frequencies and ``ReduceConfig``'s template mask, as
    ``pipeline/stages.py`` and ``ops/reduce.py`` do) and a time mask with
    ten 200-sample gaps."""
    import torch

    from comapreduce_tpu_torch.ops.gain import build_templates
    from comapreduce_tpu_torch.ops.reduce import ReduceConfig

    tsys = 30.0 + 30.0 * torch.rand((B, C), generator=g, device=device)
    freq = (26.0 + 2.0 * torch.arange(B, device=device)[:, None]
            + 2.0 * (torch.arange(C, device=device)[None, :] + 0.5) / C)
    f0 = freq.mean(dim=1, keepdim=True)
    cm = ReduceConfig(C).mask_templates.to(device)[None, :] * torch.ones(
        (B, 1), device=device)
    T2, p = build_templates(tsys, (freq - f0) / f0, cm)
    drift = torch.cumsum(torch.randn(T, generator=g, device=device), 0)
    y = torch.randn((B * C, T), generator=g, device=device)
    y.mul_(0.1).add_(drift * 1e-3)
    tmask = torch.ones(T, device=device)
    for k in range(10):
        tmask[k * (T // 10):k * (T // 10) + 200] = 0.0
    return y, T2, p, tmask


def gain_residual(y, T2, p, dg, tmask, white_noise, fknee, alpha,
                  **_) -> float:
    """||b - A dg|| / ||b|| of ``solve_gain_cg``'s system (its operator
    written out again), the stop rule's measure."""
    import torch

    from comapreduce_tpu_torch.ops.gain import _prior_inv_ps, gain_projector

    _, zp, zpp = gain_projector(T2, p)
    n = y.shape[-1]
    b = (zp @ y) * tmask
    inv_ps = _prior_inv_ps(n, white_noise, fknee, alpha, device=y.device)
    Ad = (zpp * dg + torch.fft.irfft(torch.fft.rfft(dg) * inv_ps, n=n)) \
        * tmask
    return float(torch.linalg.vector_norm(b - Ad)
                 / torch.linalg.vector_norm(b))


def phase_gain_cg(g, device: str, B: int, C: int, T: int,
                  check_T: int = 2048) -> tuple:
    """P.1: ``solve_gain_cg`` with the prior on one feed, ``subtract_gain``
    after it; a rerun bitwise; card against CPU on the first ``check_T``
    samples. Returns the report line and ``y`` (P.2 reuses it)."""
    import torch

    from comapreduce_tpu_torch.ops.gain import solve_gain_cg, subtract_gain

    t0 = _sync_on(device)
    y, T2, p, tmask = _gain_inputs(g, device, B, C, T)
    gen_s = _sync_on(device) - t0
    t0 = _sync_on(device)
    dg = solve_gain_cg(y, T2, p, time_mask=tmask, **GAIN_PRIOR)
    solve_s = _sync_on(device) - t0
    t0 = _sync_on(device)
    again = solve_gain_cg(y, T2, p, time_mask=tmask, **GAIN_PRIOR)
    rerun_s = _sync_on(device) - t0
    t0 = _sync_on(device)
    clean = subtract_gain(y, dg, p)
    subtract_s = _sync_on(device) - t0
    finite = bool(torch.isfinite(dg).all()) and \
        bool(torch.isfinite(clean).all())
    del clean
    ys, ms = y[:, :check_T].contiguous(), tmask[:check_T]
    d_dev = solve_gain_cg(ys, T2, p, time_mask=ms, **GAIN_PRIOR)
    cpu = [t.cpu() for t in (ys, T2, p, ms)]
    d_cpu = solve_gain_cg(cpu[0], cpu[1], cpu[2], time_mask=cpu[3],
                          **GAIN_PRIOR)
    sub_same = _same_bits(subtract_gain(ys, d_dev, p).cpu(),
                          subtract_gain(cpu[0], d_dev.cpu(), cpu[2]))
    out = {"shape": [B * C, T], "gen_s": gen_s, "solve_s": solve_s,
           "solve_rerun_s": rerun_s, "subtract_s": subtract_s, "finite": finite,
           "rerun_same_bits": _same_bits(dg, again),
           "residual": gain_residual(y, T2, p, dg, tmask, **GAIN_PRIOR),
           "card_vs_cpu_gap": _gap(d_dev, d_cpu),
           "subtract_card_vs_cpu_same_bits": sub_same,
           "dg_rms": float(dg.std())}
    log("last_modules_gain_cg", json.dumps(out))
    if not finite or not out["rerun_same_bits"] or not sub_same or \
            out["card_vs_cpu_gap"] > GAIN_CG_ATOL or \
            not out["residual"] < 1e-3:
        raise SystemExit(f"phase P.1 (gain CG) failed: {out}")
    return out, y


def phase_filter_stats(g, y, device: str, C: int, T_cal: int,
                       small=(64, 4096)) -> dict:
    """P.2: ``background_estimate`` with a source mask on a calibrator
    feed's rows (f32[4 C, T_cal]), ``correlation_matrix`` of one
    feed-band (the first ``C`` rows of ``y``), and ``normalise``,
    ``downsample``, ``mad`` and ``tsys_rms`` on ``y``; each wall
    synchronised, each function card against CPU on ``small`` rows x
    samples (``mad`` bitwise)."""
    import torch

    from comapreduce_tpu_torch.ops import filtering, stats

    out = {}
    rows = y.shape[0]
    t = torch.arange(T_cal, device=device, dtype=torch.float32) / 50.0
    bg = 0.5 * torch.sin(2 * np.pi * 0.03 * t)
    cal = torch.randn((rows, T_cal), generator=g, device=device)
    cal.mul_(0.05).add_(bg)
    src = torch.zeros(T_cal, device=device)
    for k in range(3):          # three crossings of the source
        a = (2 * k + 1) * T_cal // 6
        src[a - 100:a + 100] = 1.0
    cal.add_(10.0 * src)
    mask = src.expand(rows, T_cal).contiguous()
    t0 = _sync_on(device)
    est = filtering.background_estimate(cal, mask, cutoff=0.2)
    out["background_s"] = _sync_on(device) - t0
    on = src > 0
    out["background_under_source"] = float(
        (est[:, on] - bg[on]).abs().mean())
    out["background_finite"] = bool(torch.isfinite(est).all())
    r, n = small
    want = filtering.background_estimate(cal[:r].cpu(), mask[:r].cpu(),
                                         cutoff=0.2)
    out["background_card_vs_cpu"] = _gap(est[:r], want)
    del est, cal, mask

    band = y[:C]
    t0 = _sync_on(device)
    corr = stats.correlation_matrix(band)
    out["correlation_s"] = _sync_on(device) - t0
    diag = torch.diagonal(corr)
    out["correlation_diag_gap"] = float((diag - 1.0).abs().max())
    out["correlation_symmetric_gap"] = float((corr - corr.T).abs().max())
    out["correlation_finite"] = bool(torch.isfinite(corr).all())
    cs = band[:r, :n * 10]
    out["correlation_card_vs_cpu"] = _gap(stats.correlation_matrix(cs),
                                          stats.correlation_matrix(cs.cpu()),
                                          scale=1.0)
    del corr

    calls = {"normalise": lambda x: stats.normalise(x),
             "downsample": lambda x: stats.downsample(x, 50),
             "mad": lambda x: stats.mad(x),
             "tsys_rms": lambda x: stats.tsys_rms(x, 50.0, 2e9 / C)}
    sub = y[:r, :n].contiguous()
    for name, fn in calls.items():
        t0 = _sync_on(device)
        res = fn(y)
        out[f"{name}_s"] = _sync_on(device) - t0
        out[f"{name}_finite"] = bool(torch.isfinite(res).all())
        del res
        got, want = fn(sub), fn(sub.cpu())
        out[f"{name}_card_vs_cpu"] = (
            _same_bits(got.cpu(), want) if name == "mad"
            else _gap(got, want))
    log("last_modules_filter_stats", json.dumps(out))
    bad = [k for k, v in out.items() if v is False]
    gaps = [k for k in ("background_card_vs_cpu",)
            if out[k] > FILTER_ATOL]
    gaps += [k for k in ("correlation_card_vs_cpu",
                         "normalise_card_vs_cpu", "downsample_card_vs_cpu",
                         "tsys_rms_card_vs_cpu") if out[k] > STATS_RTOL]
    if bad or gaps or out["background_under_source"] > 0.15 or \
            out["correlation_diag_gap"] > 5e-3:
        raise SystemExit(f"phase P.2 (filtering, statistics) failed: "
                         f"{bad} {gaps} {out}")
    return out


def rrl_spectra(g, device: str, F: int, B: int, C: int, noise=0.01):
    """f32[F, B, C] spectra with one Gaussian line (10 km/s, FWHM 80
    km/s, 0.05 K) at every Hn-alpha line of the band, on each band's
    channel grid (26-34 GHz), plus white noise; the grid f64[B, C]."""
    import torch

    from comapreduce_tpu_torch.rrls import channel_velocity, lines_in_band

    freq = 26.0 + 2.0 * np.arange(B)[:, None] + 2.0 * (
        np.arange(C)[None, :] + 0.5) / C
    lines = list(lines_in_band(26.0, 34.0).values())
    line = np.zeros((B, C))
    for f0 in lines:
        v = channel_velocity(freq, f0)
        line += 0.05 * np.exp(-0.5 * ((v - 10.0) / (80.0 / 2.355)) ** 2)
    spectra = torch.randn((F, B, C), generator=g, device=device) * noise
    spectra += torch.as_tensor(line, dtype=torch.float32, device=device)
    return spectra, freq, lines


def phase_rrl(g, device: str, F: int, B: int, C: int) -> dict:
    """P.3: ``stack_spectra`` of F x B x C spectra over every Hn-alpha
    line in 26-34 GHz onto 60 velocity bins (twice, the same bits; the
    CPU's within ``RRL_RTOL``, its hits equal), then ``fit_line`` on the
    hit-weighted stack of every feed and band."""
    import torch

    from comapreduce_tpu_torch.rrls import fit_line, stack_spectra

    spectra, freq, lines = rrl_spectra(g, device, F, B, C)
    v_grid = np.linspace(-300.0, 300.0, 61)
    t0 = _sync_on(device)
    st, hits = stack_spectra(spectra, freq, lines, v_grid)
    stack_s = _sync_on(device) - t0
    st2, hits2 = stack_spectra(spectra, freq, lines, v_grid)
    st_c, hits_c = stack_spectra(spectra.cpu(), freq, lines, v_grid)
    h = hits.sum(dim=(0, 1))
    combined = (st * hits).sum(dim=(0, 1)) / torch.clamp(h, min=1e-30)
    t0 = time.perf_counter()
    amp, v0, fwhm, off = fit_line(0.5 * (v_grid[:-1] + v_grid[1:]),
                                  combined, weights=h)
    fit_s = time.perf_counter() - t0
    out = {"lines": len(lines), "spectra": [F, B, C], "stack_s": stack_s,
           "fit_s": fit_s, "same_bits": _same_bits(st, st2)
           and _same_bits(hits, hits2),
           "card_vs_cpu": _gap(st, st_c),
           "hits_equal": _same_bits(hits.cpu(), hits_c),
           "fit": {"amp_k": amp, "v0_kms": v0, "fwhm_kms": fwhm,
                   "offset_k": off}}
    log("last_modules_rrl", json.dumps(out))
    if not (out["same_bits"] and out["hits_equal"]
            and out["card_vs_cpu"] <= RRL_RTOL and abs(v0 - 10.0) < 5.0
            and 60.0 < fwhm < 100.0 and abs(amp - 0.05) < 0.01):
        raise SystemExit(f"phase P.3 (radio recombination lines) failed: "
                         f"{out}")
    return out


def phase_astrometry(F: int, T: int) -> dict:
    """P.4: ``h2e_full`` then ``e2h_full`` on the native library (the
    default backend, built with g++ from ``csrc/astrometry.cpp``) over F
    feed streams of T samples of a 2-degree azimuth scan at 55 deg, dUT1
    from the bundled table: the round trip within ``ROUND_TRIP_ARCSEC``;
    one feed native against the NumPy oracle within ``NATIVE_ARCSEC``;
    the walls of each (host work, as in the reference)."""
    from comapreduce_tpu_torch import _build
    from comapreduce_tpu_torch.astro import coordinates, native

    t0 = time.perf_counter()
    native.load()
    load_s = time.perf_counter() - t0
    k = np.arange(T)
    mjd = 59620.0 + k / 50.0 / 86400.0
    off = np.linspace(-0.4, 0.4, F)[:, None]
    az = 180.0 + 2.0 * np.sin(k / 70.0)[None, :] + off
    el = 55.0 + np.zeros(T)[None, :] - off
    t0 = time.perf_counter()
    ra, dec = coordinates.h2e_full(az, el, mjd)
    h2e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    az_b, el_b = coordinates.e2h_full(ra, dec, mjd)
    e2h_s = time.perf_counter() - t0
    d_az = (az_b - az + 180.0) % 360.0 - 180.0
    trip = 3600.0 * max(float(np.abs(d_az).max()),
                        float(np.abs(el_b - el).max()))
    t0 = time.perf_counter()
    ra_n, dec_n = coordinates.h2e_full(az[0], el[0], mjd, backend="numpy")
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ra_1, dec_1 = coordinates.h2e_full(az[0], el[0], mjd)
    native_one_s = time.perf_counter() - t0
    gap = 3600.0 * max(float(np.abs(ra_1 - ra_n).max()),
                       float(np.abs(dec_1 - dec_n).max()))
    out = {"samples": [F, T], "library_s": load_s,
           "library": sorted(p.name for p in
                             _build.build_dir().glob("libastrometry-*")),
           "h2e_s": h2e_s, "e2h_s": e2h_s, "round_trip_arcsec": trip,
           "native_one_feed_s": native_one_s, "numpy_one_feed_s": numpy_s,
           "native_vs_numpy_arcsec": gap,
           "rows_equal_native": bool(np.array_equal(ra[0], ra_1))}
    log("last_modules_astrometry", json.dumps(out))
    if not (trip < ROUND_TRIP_ARCSEC and gap < NATIVE_ARCSEC
            and out["rows_equal_native"] and np.isfinite(ra).all()):
        raise SystemExit(f"phase P.4 (astrometry) failed: {out}")
    return out


def phase_last_modules(device: str = "cuda", shape=None) -> dict:
    """Phase P (see the module docstring) at ``shape`` (default
    ``P_FULL``); each part's line is logged and a failure exits
    non-zero."""
    import torch

    sh = dict(P_FULL, **(shape or {}))
    g = torch.Generator(device=device)
    g.manual_seed(19)
    t0 = time.perf_counter()
    out = {}
    out["gain_cg"], y = phase_gain_cg(g, device, sh["B"], sh["C"], sh["T"])
    out["filter_stats"] = phase_filter_stats(g, y, device, sh["C"],
                                             sh["T_cal"])
    del y
    out["rrl"] = phase_rrl(g, device, sh["F"], sh["B"], sh["C"])
    out["astrometry"] = phase_astrometry(sh["F"], sh["T"])
    out["wall_s"] = time.perf_counter() - t0
    return out



def main() -> int:
    sys.path.insert(0, ROOT)
    env = phase_environment()
    import torch

    from comapreduce_tpu_torch.flagship import FULL, observation_geometry
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    report = {"env": env, "build_s": phase_build()}
    t0 = time.perf_counter()
    plan = build_pointing_plan(observation_geometry(FULL)[3],
                               FULL.nx * FULL.ny, FULL.offset_length)
    report["plan_build_s"] = time.perf_counter() - t0
    log(f"full-width plan built on the host in "
        f"{report['plan_build_s']:.2f} s: windows sample "
        f"{plan.sample_window} rank {plan.rank_window} off "
        f"{plan.off_window}")
    stage_log = StageLog()
    port_log = logging.getLogger("comapreduce_tpu_torch")
    port_log.setLevel(logging.INFO)
    port_log.addHandler(stage_log)
    # each phase's wall, lap by lap (a report key and a log line each),
    # and the calls each K3 body took in it: the two-pass body only in
    # this script's checks, the one-pass body in every phase that solves
    from comapreduce_tpu_torch.mapmaking.cuda_binning import \
        binned_window_sum
    walls, t_lap = {}, [time.perf_counter()]
    report["k3_bodies"] = {}
    k3_seen = [dict(binned_window_sum.bodies), K3_CHECK_TWO_PASS[0]]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_lap[0]
        t_lap[0] = now
        log(f"wall {name} {walls[name]:.1f} s")
        bodies = dict(binned_window_sum.bodies)
        checks = K3_CHECK_TWO_PASS[0] - k3_seen[1]
        n = {"one_pass": bodies["one_pass"] - k3_seen[0]["one_pass"],
             "two_pass": bodies["two_pass"] - k3_seen[0]["two_pass"]
             - checks, "two_pass_checks": checks}
        k3_seen[:] = [bodies, K3_CHECK_TWO_PASS[0]]
        report["k3_bodies"][name] = n
        log(f"k3_bodies {name} {json.dumps(n)}")
        if n["two_pass"]:
            raise SystemExit(f"phase {name}: K3's two-pass body ran "
                             f"{n['two_pass']} times outside the checks")
        if name in K3_SOLVING_LAPS and n["one_pass"] <= 0:
            raise SystemExit(f"phase {name} never took K3's one-pass body")

    # the small field runs first: solve_band's plan memo holds one
    # pointing, and the full field's plan must stay in it for its bands
    report["small_field"] = phase_small_field()
    lap("small_field")
    report["small_mg_banded"] = phase_small_mg_banded()
    lap("small_mg_banded")
    geo, field_plan, report["field_setup"] = phase_field_setup(stage_log)
    kernels = phase_kernel_parity(plan, FULL, field_plan)
    lap("kernel_parity")
    report["large_paths"] = phase_large_paths()
    lap("large_paths")
    report["small_chain"] = phase_small_chain()
    lap("small_chain")
    report["full_chain"], launches, inputs = phase_full_chain(FULL, plan)
    lap("full_chain")
    del inputs
    report["field"], field_launches, band0 = phase_field(geo, field_plan,
                                                         stage_log)
    report["field_profile"] = phase_field_profile(band0, stage_log)
    lap("field_7")
    del band0
    report["mg_field"], mg_launches, band0 = phase_field_mg(
        geo, field_plan, stage_log, report["field"])
    lap("field_A")
    report["banded_field"], bands_1f, hand_joint = phase_field_banded(
        geo, field_plan, stage_log)
    report["joint_products"] = phase_joint_products(stage_log, bands_1f,
                                                    hand_joint)
    lap("field_B_D")
    del bands_1f, hand_joint
    report["chain_small"], store_small = phase_chain_small()
    report["chain_full"], store_full = phase_chain_full()
    lap("chain_E")
    t0 = time.perf_counter()
    report["reader_small"] = phase_reader_small(store_small, stage_log)
    report["reader_full"], joint_maps = phase_reader_full(
        store_full, stage_log, os.path.join(ROOT, "chiprun_out",
                                            "chain_full", "logs"))
    report["reader_s"] = time.perf_counter() - t0
    lap("reader_F")
    t0 = time.perf_counter()
    report["calibration_small"] = phase_calibration_small()
    report["calibration_full"], cal_store = phase_calibration_full(
        store_full, "comap-fullwidth.hd5", joint_maps, stage_log)
    report["calibration_s"] = time.perf_counter() - t0
    lap("calibration_H")
    t0 = time.perf_counter()
    report["ingest"] = phase_ingest(store_full, cal_store, joint_maps,
                                    stage_log)
    report["ingest_s"] = time.perf_counter() - t0
    lap("ingest_I")
    del cal_store
    t0 = time.perf_counter()
    report["drill"] = phase_drill()
    report["drill_s"] = time.perf_counter() - t0
    lap("drill_G")
    report["last_stages"] = phase_last_stages()
    lap("last_stages_J")
    report["serving"] = phase_serving(store_full, stage_log)
    lap("serving_K")
    report["observability"] = phase_observability(
        store_full, joint_maps, report["reader_full"]["joint"]["wall_s"])
    del store_full, joint_maps
    lap("observability_M")
    # phase N while the field plan is in scope, before L.2 consults its
    # stage winner
    report["pol_tuning"] = phase_pol_tuning(field_plan, geo, band0,
                                            store_small, stage_log)
    del band0
    lap("pol_tuning_N")
    report["sharded"] = phase_sharded(geo, plan, store_small, stage_log)
    del store_small
    lap("sharded_O")
    report["synthetic"] = phase_synthetic(
        tuning_src=report["pol_tuning"]["tuning"]["cache"])
    lap("synthetic_L")
    report["last_modules"] = phase_last_modules()
    lap("last_modules_P")
    launches["windowed_gather"] = field_launches["windowed_gather"]
    report["field_launches"] = field_launches
    report["mg_field_launches"] = mg_launches
    for body in kernels["binned_window_sum"]["bodies"]:
        body["launches"] = report["full_chain"]["k3_bodies"][body["body"]]
    for k, v in kernels.items():
        v["launches"] = launches[k]
        v["phase_m_launches"] = report["observability"]["launches"].get(k)
        v["phase_n_launches"] = report["pol_tuning"]["launches"].get(k)
        v["phase_o_launches"] = report["sharded"]["launches"][k]
    report["kernels"] = list(kernels.values())
    report["phase_walls_s"] = walls
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json"),
              "w") as fh:
        json.dump(report, fh, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "phase_m_launches", "phase_n_launches", "phase_o_launches")
    print(json.dumps({"kernels": [{k: v[k] for k in keys + ("bodies",)
                                   if k in v}
                                  for v in kernels.values()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
