"""Phase M of ``chip_smoke.py`` (the observability plane) at a small
size: its three parts on the CPU here, and on the card where there is
one (``cuda``-marked, skipped with a reason elsewhere).

- M.1 (``phase_solver_trace``): the ground route on band 0 of a raster
  store, untraced twice and traced once: one record per iteration and a
  summary with the result's ``n_iter`` and residual; the traced and
  untraced solves the same bits (every sum of the solve keeps one order,
  on the card as on the CPU); a checkpointed solve numbered on one
  axis.
- M.2 (``phase_live_plane``): the joint route through ``main`` with
  ``[Telemetry]`` on and ``--live-port=0`` under the scraper, a mid-run
  scrape with the read and solve families, the maps the untraced run's
  bit for bit, ``campaign_report`` over the state dir.
- M.3 (``phase_device_trace``): ``jax_profiler`` through ``run_tod``
  over two ``synth://`` members: one trace, the reference's spans (on
  the card the trace names K1 and K2 as often as they launched in it).
- ``naive_limit``: two summation orders of one NAIVE map lie within it.

This file imports neither ``jax`` nor the JAX package, so it runs on a
machine with a card and no JAX.
"""

import os
import signal

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_level2_data import level2_store

FIELD = ((170.0, 52.0), (0.2, 0.2), (12, 12))
NAME = "Level2_obs.hd5"
TIME_LIMIT_S = 300


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded {TIME_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cs.phase_build()
    return "cuda"


@pytest.fixture(scope="module")
def store():
    return level2_store(11, n_bands=4, raster=True)


def _m1(store, device, base):
    line = cs.phase_solver_trace(store, device=device, field=FIELD,
                                 name=NAME, base=str(base))
    assert line["records"] == line["n_iter"] + 1 + 2 * cs.TRACE_CHUNK + 2
    assert line["chunk_bases"] == [0, cs.TRACE_CHUNK]
    # the sums keep one order: the three solves agree bit for bit
    pairs = line["bitwise"]["untraced"] + line["bitwise"]["traced"]
    assert len(pairs) == 3
    assert all(all(p.values()) for p in pairs)
    return line


def test_solver_trace_on_the_cpu(store, tmp_path):
    line = _m1(store, "cpu", tmp_path)
    assert set(line["bitwise"]["traced"][0]) == set(cs.SOLVE_PRODUCTS)


@pytest.mark.cuda
def test_cuda_solver_trace(store, tmp_path, cuda_device):
    line = _m1(store, cuda_device, tmp_path)
    assert line["launches"]["traced"] == line["launches"]["derived"]


def _m2(store, device, base):
    line = cs.phase_live_plane(store, None, None, device=device,
                               field=FIELD, name=NAME, base=str(base))
    assert line["scrapes"]["mid_run_with_families"] >= 1
    assert 200 in line["scrapes"]["healthz_status"]
    assert all(b["records"] == b["n_iter"] for b in line["bands"])
    assert "ingest.read" in line["report_stages"]
    for f in ("trace.json", "metrics.prom"):
        assert os.path.getsize(os.path.join(base, "live", f)) > 0
    return line


def test_live_plane_on_the_cpu(store, tmp_path):
    line = _m2(store, "cpu", tmp_path)
    # one summation order on the CPU: the traced run's maps are the
    # untraced run's bit for bit
    assert all(b["naive_max_gap"] == 0.0 and all(b["bitwise"].values())
               for b in line["bands"])


@pytest.mark.cuda
def test_cuda_live_plane(store, tmp_path, cuda_device):
    line = _m2(store, cuda_device, tmp_path)
    assert line["launches"]["rolling_median_windows"] == 4


def test_device_trace_on_the_cpu(tmp_path):
    line = cs.phase_device_trace(device="cpu", base=str(tmp_path))
    assert len(line["compute_s"]) == 2
    assert {"ingest.read", "ingest.compute",
            "Level1AveragingGainCorrection"} <= set(line["span_names"])
    traces = os.listdir(tmp_path / "device_trace" / "logs" / "jax_trace")
    assert traces == [line["trace_file"] + ".gz"]


@pytest.mark.cuda
def test_cuda_device_trace(tmp_path, cuda_device):
    line = cs.phase_device_trace(device=cuda_device, base=str(tmp_path))
    assert line["kernels_named"][cs.K1_SYMBOL] == \
        line["launches_in_bracket"]["masked_fill"] > 0
    assert line["kernels_named"][cs.K2_SYMBOL] == \
        line["launches_in_bracket"]["rolling_median_windows"] > 0


@pytest.mark.parametrize("seed", range(3))
def test_naive_limit_bounds_two_summation_orders(seed):
    """The NAIVE map summed in two random orders (f32 ``index_add_`` over
    permuted samples) stays within ``naive_limit`` pixel by pixel, and
    the limit is not vacuous: under 1e-3 of the map's scale at ~540
    samples a pixel (the worst case grows with the count, gamma(N - 1)
    = 3.2e-5 here)."""
    rng = np.random.default_rng(seed)
    n, npix, L = 50 * 400, 37, 50
    data = type("D", (), {})()
    data.pixels = rng.integers(-1, npix, n)
    data.weights = rng.uniform(0.0, 3.0, n).astype(np.float32)
    data.tod = (rng.standard_normal(n) * 10.0 + 3.0).astype(np.float32)
    data.npix = npix
    lim = cs.naive_limit(data, L)
    pix = torch.as_tensor(data.pixels)
    w = torch.as_tensor(data.weights)
    x = w * torch.as_tensor(data.tod)
    ok = pix >= 0
    maps = []
    for order in (rng.permutation(n), rng.permutation(n)):
        o = torch.as_tensor(order)
        o = o[ok[o]]
        sw = torch.zeros(npix).index_add_(0, pix[o], w[o])
        sd = torch.zeros(npix).index_add_(0, pix[o], x[o])
        maps.append(torch.where(sw > 0, sd / sw.clamp(min=1e-30),
                                torch.zeros(())).numpy())
    gap = np.abs(maps[0] - maps[1])
    assert (gap <= lim).all()
    assert lim.max() < 1e-3 * np.abs(maps[0]).max()
