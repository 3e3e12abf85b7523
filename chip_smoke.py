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
   (R = 2) and with one (R = 1) — (K1, K2 and K4 bitwise; K3 bitwise on
   integer-valued sums and, on real values, within the f32 summation
   bound of the exact sum), each timed on the device with CUDA events
   (``cuda_ms``) beside its plain version, its bound and the one PyTorch
   call that computes the same function where there is one
   (``torch.quantile`` on an unfold view for K2, ``index_add_`` for K3,
   ``index_select`` for K4), with the launch floor (a one-element
   ``zero_``) beside K2's and K4's bounds, K2 at four block sizes and K4
   also as the two R = 1 launches one matvec took before; K1 on rows at
   the edges of its selection (``fill_edge_rows``), K2 on tied, -0/+0
   and NaN rows (``median_edge_rows``), K4 on every lane kind and in its
   scalar body (``gather_lane_case``), with each kernel's resident
   blocks per SM; then what the main path's shapes do not take: K1's
   second body (keys in device scratch), K2's (window 20 000) and K3 on
   a layout that stresses its one body (``window_sum_stress_case``);
4. small-shape chain: the BENCH_SMALL observation through the port on
   the card and, with the same inputs, on the CPU (plain versions);
5. full-width chain: F=19 feeds x B=4 bands x C=1024 channels x 10 CES
   scans of 13 500 samples, window 6000, a 480x480 field, offset length
   50 — one warm-up run, then one timed run with every kernel's launch
   counter set to 0 just before it and read just after (K1 and K2 once
   per scan batch of each feed: 95);
6. profile: one more full-width run under ``torch.profiler`` for the
   device time per kernel (K1, K2 and K3 per launch and as a share of
   device time) and the device's busy share;
7. field run (``comapreduce_tpu_torch/fieldrun.py``): the band solve
   ``cli.run_destriper.solve_band`` with the ground template and the
   two-level preconditioner (block 8), 100 iterations, threshold 1e-6 —
   first at FIELD_SMALL on the card and on the CPU (null-space-invariant
   products compared), then at full width: 4 observations x 19 feeds x
   135 700 samples (10 313 200 per band, 76 ground groups) on the
   480x480 field, all four bands, each with the K3 and K4 launch
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
   four bands through ``solve_band`` with the ground template and
   ``fieldrun.MG_KW``, each with the K3 and K4 counters set to 0 just
   before its solve and read just after (K4 once per CG iteration, K3 as
   ``k3_launches`` derives), phase C — one more such band under
   ``torch.profiler`` (K3, K4, ``index_add_``, ``index_select`` and the
   coarsest ``einsum``, and the solve's busy share), and phase B — the
   four matched-1/f bands offsets-only, band 0 through ``solve_band``
   with the banded prior (its fallback warning must name the two planted
   groups) and then all four as one multi-RHS ``destripe_planned`` with
   ``stack_multigrid`` and ``stack_banded``, counters likewise.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. A longer report goes to
``chiprun_out/chip_smoke_report.json``. The script imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
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
# the maps inherit less, and K3's atomics add f32 summation order
TOD_RTOL = 2e-3
MAP_ATOL = 5e-4
# f32 unit roundoff, for K3's summation bound (check_window_sum)
F32_U = 2.0 ** -24
# card vs CPU on the small field run: the tolerance of the CPU port
# against the reference there (tests/test_torch_solve_band.py), the
# converged ground solve's null-space-invariant products
FIELD_ATOL = 5e-4
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


def check_window_sum(label, vals, ids, base, window, chunk, out_size):
    """Hold K3 against its plain version on the card in the two ways a
    float atomic order cannot blur; return max |kernel - plain| and the
    most terms any bin sums.

    Both run atomics on the card (``index_add_`` too), so their sums move
    in the last bits from run to run, and more so in a bin of many terms
    (the plan's padding samples all land on one padded pair): no fixed
    share of the output's scale bounds that. Instead:

    - routing, exactly: with integer values of magnitude at most k, where
      k * (the most terms any bin sums) < 2**24 (k = 2 where that allows),
      every partial sum is an integer below 2**24 in magnitude, so every
      order of f32 adds gives the exact sum, and the kernel must equal the
      plain version bitwise — a dropped, doubled or misplaced value shows;
    - values, to a bound that holds for every order: a bin's f32 sum of
      n terms lies within gamma(n-1) * sum|x| of the exact sum, with
      gamma(k) = k u / (1 - k u) (Higham, *Accuracy and Stability of
      Numerical Algorithms*, eq. 4.6). The exact sum is taken in f64,
      whose own error is 2**29 times smaller.
    """
    import torch

    from comapreduce_tpu_torch.mapmaking.cuda_binning import (
        binned_window_sum, binned_window_sum_plain)

    M = vals.shape[-1]
    args = (ids, base, window, chunk, out_size)
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
    if not torch.equal(binned_window_sum(ints, *args),
                       binned_window_sum_plain(ints, *args)):
        raise SystemExit(f"K3 {label}: integer-valued sums differ from "
                         "the plain version")
    got = binned_window_sum(vals, *args)
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


def window_sum_stress_case(seed: int = 21):
    """A K3 layout that stresses its one body (numpy; R = 4 values go
    with it): ``(ids, base, window, chunk, out_size)`` over 64 chunks of
    8192 sorted ids in [0, 2**21), so the window is wider than 32 768,
    with a run of 5000 equal ids across a chunk boundary and a run of 3000
    inside a chunk (both longer than a warp's 256 and a block's 1024
    elements, and across their boundaries), 1000 shuffled ids, a window
    start clipped at 0, one raised past its chunk's first ids, one clipped
    at ``out_size`` and a last chunk of sentinel ids."""
    rng = np.random.default_rng(seed)
    chunk, n_chunks, out_size = 8192, 64, 1 << 21
    ids = np.sort(rng.integers(0, out_size, chunk * n_chunks))
    a = 3 * chunk - 3000
    ids[a:a + 5000] = ids[a]
    b = 10 * chunk + 1500
    ids[b:b + 3000] = ids[b]
    c = 40 * chunk + 100
    ids[c:c + 1000] = rng.permutation(ids[c:c + 1000])
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
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}
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
        _window_dest, binned_window_sum, binned_window_sum_occupancy,
        binned_window_sum_plain, windowed_gather, windowed_gather_occupancy,
        windowed_gather_plain)
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
        for site, (ids, base, window, chunk, out_size, M) in _k3_layouts(
                pl, dev).items():
            site = prefix + site
            vals = torch.randn((R, M), generator=g, device=dev)
            err, n_max = check_window_sum(site, vals, ids, base, window,
                                          chunk, out_size)
            # the one PyTorch call computing the same function:
            # index_add_ into a staging column on ids pre-masked to the
            # plan's windows
            dest = _window_dest(ids, base, window, chunk, out_size)
            n_valid = int((dest < out_size).sum())
            stage = torch.zeros((R, out_size + 1), device=dev)
            sites[site] = dict(
                R=R, M=M, out_size=out_size, window=window, chunk=chunk,
                max_abs_err=err, max_terms_per_bin=n_max,
                ms=cuda_ms(lambda: binned_window_sum(
                    vals, ids, base, window, chunk, out_size), reps=20),
                plain_ms=cuda_ms(lambda: binned_window_sum_plain(
                    vals, ids, base, window, chunk, out_size), reps=5),
                library_ms=cuda_ms(lambda: stage.index_add_(1, dest, vals),
                                   reps=20))
            sites[site]["bound_ms"], sites[site]["bound_by"] = bound(
                (R * M + M + M // chunk + R * out_size) * 4, R * n_valid)
            del vals, dest, stage
    head = sites["rank_sum"]
    entries["binned_window_sum"] = dict(
        name="binned_window_sum", route="cuda",
        source="comapreduce_tpu_torch/csrc/binned_window_sum.cu",
        replaces="comapreduce_tpu/mapmaking/pallas_binning.py:204",
        max_abs_err=max(s["max_abs_err"] for s in sites.values()),
        ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"], headline_site="rank_sum",
        sites=sites)
    (entries["binned_window_sum"]["blocks_per_sm"],
     entries["binned_window_sum"]["elements_per_block"]) = \
        binned_window_sum_occupancy()
    # K4 at its one call site, the ground solve's offset-order gather of
    # its two per-offset coefficient rows c0, c1 in one launch (R = 2,
    # S = n_off, M = P_pad) on the full field plan; beside it one row
    # (R = 1) and the parent's form of one matvec, two R = 1 launches
    fdv = field_plan.device(dev)
    perm_off = fdv["pair_perm_off"].to(torch.int64)
    ids = fdv["pair_offset"][perm_off]
    base = fdv["off_base"]
    window, chunk = field_plan.off_window, field_plan.pair_chunk
    S, M = field_plan.n_offsets, int(ids.shape[0])
    src = torch.randn((2, S), generator=g, device=dev)
    c0, c1 = src[0], src[1]
    errs = {}
    for R, s_r in ((1, c0), (2, src)):
        got = windowed_gather(s_r, ids, base, window, chunk)
        want = windowed_gather_plain(s_r, ids, base, window, chunk)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise SystemExit(f"K4 windowed_gather disagrees with its plain "
                             f"version at the field path's shape, R={R}")
        errs[R] = float((got - want).abs().max())
    check_gather_lanes(dev)
    # the one PyTorch call computing the same function: index_select on
    # the source padded with a zero slot, ids pre-mapped to that slot
    dest = _window_dest(ids, base, window, chunk, S)
    keep = dest < S
    padded = torch.cat([src, torch.zeros((2, 1), device=dev)], dim=1)
    padded0 = padded[0].contiguous()
    n_read = int(torch.unique(dest[keep]).numel())

    def gather_bound(R):
        return bound(4 * (M + M // chunk + R * M + R * n_read), 3 * M)

    b_ms, by = gather_bound(2)
    entries["windowed_gather"] = dict(
        name="windowed_gather", route="cuda",
        source="comapreduce_tpu_torch/csrc/windowed_gather.cu",
        replaces="comapreduce_tpu/mapmaking/pallas_binning.py:285",
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
        in_window_lanes=int(keep.sum()),
        blocks_per_sm=windowed_gather_occupancy(True),
        scalar_blocks_per_sm=windowed_gather_occupancy(False))
    for k, v in entries.items():
        log("parity", k, json.dumps(v))
    return entries


def phase_large_paths():
    """What the main path's shapes never take, each against its plain
    version: K1's second body, its keys in device scratch and its row read
    twice (L = 300 000 and 300 001, the float4 and the scalar loads),
    bitwise (every row takes the stride-4 median); K3's one body on
    ``window_sum_stress_case`` (4 rows), as ``check_window_sum`` holds
    it."""
    import torch

    from comapreduce_tpu_torch.ops.cuda_median import (
        fill_row_on_chip, masked_fill, masked_fill_plain)

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
    ids, base, window, chunk, out_size = window_sum_stress_case()
    vals = torch.randn((4, ids.size), generator=g, device=dev)
    err, n_max = check_window_sum(
        "stress case", vals, torch.as_tensor(ids, dtype=torch.int32,
                                             device=dev),
        torch.as_tensor(base, dtype=torch.int32, device=dev), window,
        chunk, out_size)
    out["binned_window_sum_window"] = window
    out["binned_window_sum_max_terms"] = n_max
    out["binned_window_sum"] = err
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

    counters = {"masked_fill": masked_fill,
                "rolling_median_windows": rolling_median_windows,
                "binned_window_sum": binned_window_sum}
    inputs = make_flagship_inputs(full, seed=7, device="cuda")
    warm = run_flagship(inputs, device="cuda", plan=plan)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    out = run_flagship(inputs, device="cuda", plan=plan)
    launches = {k: fn.launches for k, fn in counters.items()}
    res = out["result"]
    for k, n in launches.items():
        if n <= 0:
            raise SystemExit(f"full chain never launched kernel {k}")
    # K1 and K2 run once per scan batch of each feed
    per_feed = -(-full.n_scans // full.scan_batch)
    for k in ("masked_fill", "rolling_median_windows"):
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
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("full_chain", json.dumps(line))
    return line, launches, inputs


def kernel_share(kernels, name: str, busy_ms: float) -> dict:
    """In-loop device time of one kernel from a profile's CUDA events:
    total ms, launches, ms per launch and share of all kernel time."""
    hit = [e for e in kernels if name in e.key]
    ms = sum(e.self_device_time_total for e in hit) / 1e3
    n = sum(e.count for e in hit)
    return {"ms": ms, "count": n, "ms_per_launch": ms / n if n else None,
            "share_of_device_time": ms / busy_ms if busy_ms else None}


def phase_profile(inputs, plan, top: int = 15):
    """One more full-width run under ``torch.profiler`` (after the timed
    run, so the profiler's cost never lands in the headline wall): device
    time per kernel, K1's, K2's and K3's time per launch and share of
    device time, and the device's busy share of the profiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from comapreduce_tpu_torch.flagship import run_flagship

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run_flagship(inputs, device="cuda", plan=plan)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"kernel": e.key[:120], "ms": e.self_device_time_total / 1e3,
             "count": e.count} for e in kernels[:top]]
    prof_line = {"profiled_wall_s": out["wall_s"],
                 "device_kernel_ms": busy_ms,
                 "device_busy_share": (busy_ms / 1e3 / out["wall_s"]
                                       if busy_ms else None),
                 "k1": kernel_share(kernels, "masked_fill_kernel", busy_ms),
                 "k2": kernel_share(kernels, "rolling_median_kernel",
                                    busy_ms),
                 "k3": kernel_share(kernels, "binned_window_sum_kernel",
                                    busy_ms),
                 "top_kernels": rows}
    log("profile", json.dumps({k: v for k, v in prof_line.items()
                               if k != "top_kernels"}))
    for r in rows:
        log("profile_kernel", json.dumps(r))
    return prof_line


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


def phase_field(geo, plan, stage_log):
    """All four bands of the full field run through ``solve_band`` on the
    card, each with the K3 and K4 counters set to 0 just before its solve
    and read just after. Checks: finite products, the hit map's coverage
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
    for band in range(sh.n_bands):
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
    excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import SOLVE_KW

    stage_log.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _synced()
        res = solve_band(data, **SOLVE_KW)
        wall = _synced() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k3 = kernel_share(kernels, "binned_window_sum_kernel", busy_ms)
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


def phase_field_mg(geo, plan, stage_log, twolevel_bands):
    """Phase A: all four bands of the full field run through ``solve_band``
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
    for band in range(sh.n_bands):
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


def phase_field_banded(geo, plan, stage_log):
    """Phase B: the four matched-1/f bands of the full field, offsets
    only. Band 0 through ``solve_band`` with the multigrid V-cycle and
    the banded noise prior (bandwidth 4): its fallback warning must name
    exactly the two planted groups. Then all four bands as one multi-RHS
    ``destripe_planned`` with ``stack_multigrid`` and ``stack_banded``,
    the joint route's sequence. Checks finite products, no divergence,
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
    bands = [make_field_band_1f(sh, geo, b) for b in range(sh.n_bands)]
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

    # all four bands as one multi-RHS solve
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
                             for b in range(sh.n_bands)],
             "launches": binned_window_sum.launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("banded_joint", json.dumps(joint))
    return {"band0": band0, "joint": joint}


def phase_field_mg_profile(data, stage_log, top: int = 15):
    """Phase C: one band of phase A under ``torch.profiler``: K3 and K4
    per launch and as a share of device time, the device time under
    ``index_add_`` (the V-cycle's restrictions and COO applies and the
    group sums), ``index_select`` and ``einsum`` (the coarsest solve),
    and the device's busy share of the solve (the host builds
    excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.fieldrun import MG_KW, OFFSET_LENGTH

    stage_log.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _synced()
        res = solve_band(data, offset_length=OFFSET_LENGTH, use_ground=True,
                         n_iter=100, threshold=1e-6, mg=MG_KW)
        wall = _synced() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = {}
    for e in events:
        if e.key in ("aten::index_add_", "aten::einsum",
                     "aten::index_select"):
            ops[e.key] = {"device_ms": e.device_time_total / 1e3,
                          "calls": e.count,
                          "share_of_device_time": (e.device_time_total / 1e3
                                                   / busy_ms)}
    solve_s = wall - stage_log.seconds("mg_patterns") - stage_log.seconds(
        "mg_build")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    out = {"profiled_wall_s": wall, "profiled_solve_s": solve_s,
           "cg_iters": int(res.n_iter), "device_kernel_ms": busy_ms,
           "device_busy_share_of_solve": busy_ms / 1e3 / solve_s,
           "k3": kernel_share(kernels, "binned_window_sum_kernel", busy_ms),
           "k4": kernel_share(kernels, "windowed_gather_kernel", busy_ms),
           "ops": ops,
           "top_kernels": [{"kernel": e.key[:120],
                            "ms": e.self_device_time_total / 1e3,
                            "count": e.count} for e in kernels[:top]]}
    log("mg_field_profile", json.dumps({k: v for k, v in out.items()
                                        if k != "top_kernels"}))
    for r in out["top_kernels"]:
        log("mg_field_profile_kernel", json.dumps(r))
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
    # the small field runs first: solve_band's plan memo holds one
    # pointing, and the full field's plan must stay in it for its bands
    report["small_field"] = phase_small_field()
    report["small_mg_banded"] = phase_small_mg_banded()
    geo, field_plan, report["field_setup"] = phase_field_setup(stage_log)
    kernels = phase_kernel_parity(plan, FULL, field_plan)
    report["large_paths"] = phase_large_paths()
    report["small_chain"] = phase_small_chain()
    report["full_chain"], launches, inputs = phase_full_chain(FULL, plan)
    report["profile"] = phase_profile(inputs, plan)
    del inputs
    report["field"], field_launches, band0 = phase_field(geo, field_plan,
                                                         stage_log)
    report["field_profile"] = phase_field_profile(band0, stage_log)
    del band0
    report["mg_field"], mg_launches, band0 = phase_field_mg(
        geo, field_plan, stage_log, report["field"])
    report["mg_field_profile"] = phase_field_mg_profile(band0, stage_log)
    del band0
    report["banded_field"] = phase_field_banded(geo, field_plan, stage_log)
    launches["windowed_gather"] = field_launches["windowed_gather"]
    report["field_launches"] = field_launches
    report["mg_field_launches"] = mg_launches
    for k, v in kernels.items():
        v["launches"] = launches[k]
    report["kernels"] = list(kernels.values())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json"),
              "w") as fh:
        json.dump(report, fh, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: v[k] for k in keys}
                                  for v in kernels.values()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
