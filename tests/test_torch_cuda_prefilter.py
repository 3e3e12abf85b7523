"""K5 (``csrc/prefilter.cu``: the reduction's atmosphere fit and
radiometer normalisation, fused) on the card against its plain version:
at the flagship's scan-batch block, on the edge rows of
``chip_smoke.prefilter_edge_rows`` at L = 13 568, 13 567 and 13 565 (the
pair grid's tail), in its second body (rows past the shared-memory
budget), and for the same bits launch to launch, in either body, with
either load path, and whatever the scan batch a row is launched in.

This file imports neither ``jax`` nor the JAX package, so it runs on a
machine with a card and no JAX: ``python -m pytest
tests/test_torch_cuda_prefilter.py``. Everywhere else every test skips
with a reason.

Tolerances (``chip_smoke.PREFILTER_RTOL``, relative 2-norm gaps): the
kernel adds each row's sums in its own fixed order, not PyTorch's. Two
f32 orders of n terms differ by ~sqrt(n) u of the sum (7e-6 at
n = 13 568), and offset, slope and norm are ratios of such sums: 1e-5.
``clean`` is ``(d - model) / norm`` with the model ~99% of the counts,
so the cancellation multiplies the offset's gap by ~100: 1e-3. What the
arithmetic fixes exactly (slope 0 on a degenerate fit, norm 0 and clean
0 without pairs, where NaN falls) is held bitwise.
"""

import numpy as np
import pytest
import torch

import comapreduce_tpu_torch.ops.prefilter as pf
from chip_smoke import PREFILTER_RTOL, prefilter_edge_rows, prefilter_gaps
from comapreduce_tpu_torch.ops.cuda_median import masked_fill
from comapreduce_tpu_torch.ops.prefilter import (prefilter, prefilter_plain,
                                                 prefilter_row_on_chip)
from comapreduce_tpu_torch.ops.reduce import ReduceConfig, _prefilter_chain

BT = ReduceConfig(1024).bandwidth * ReduceConfig(1024).tau


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _within(got, want):
    gaps = prefilter_gaps(got, want)
    assert all(gaps[k] <= PREFILTER_RTOL[k] for k in gaps), gaps


def _same_bits(x, y):
    x, y = x.cpu().numpy(), y.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
    np.testing.assert_array_equal(np.nan_to_num(x).view(np.int32),
                                  np.nan_to_num(y).view(np.int32))


def _block(dev, S, B, C, L, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    t = torch.arange(L, device=dev, dtype=torch.float32)
    a = torch.stack([1.2 + 0.05 * torch.sin(t / 150.0 + s)
                     for s in range(S)])
    d = (4.5e7 * (1 + 0.01 * torch.randn((S, B, C, L), generator=g,
                                         device=dev))
         + 3e5 * a[:, None, None, :])
    m = (torch.rand((S, B, C, L), generator=g, device=dev) > 0.01).float()
    m[..., 13_500:] = 0.0
    return d, m, a


@pytest.mark.cuda
def test_cuda_prefilter_flagship_block(cuda_device):
    d, m, a = _block(cuda_device, 2, 4, 1024, 13_568, seed=31)
    n, on_chip = prefilter.launches, prefilter.bodies["on_chip"]
    got = prefilter(d, m, a, BT)
    assert (prefilter.launches, prefilter.bodies["on_chip"]) == (
        n + 1, on_chip + 1)
    _within(got, prefilter_plain(d, m, a, BT))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [13_568, 13_567, 13_565])
def test_cuda_prefilter_edge_rows(cuda_device, L):
    d, m, a = (torch.as_tensor(x, device=cuda_device)
               for x in prefilter_edge_rows(L))
    got = prefilter(d, m, a, BT)
    want = prefilter_plain(d, m, a, BT)
    _within(got, want)
    clean, (offset, slope, norm) = got[0].cpu(), got[1].cpu()
    # no valid sample, one valid sample, no pair: norm 0 and clean 0
    for c in (1, 2, 3):
        assert bool((norm[:, 0, c] == 0).all())
        assert bool((clean[:, 0, c] == 0).all())
    assert bool((slope[:, 0, 1:3] == 0).all())
    # the constant airmass: saa is 0, so every slope is 0
    assert bool((slope[1] == 0).all())
    # a NaN masked in: the offset NaN; the varying airmass's slope and
    # norm NaN and clean 0, the constant one's norm finite and clean NaN
    assert bool(torch.isnan(offset[:, 0, 4]).all())
    assert bool(torch.isnan(norm[0, 0, 4]) and (clean[0, 0, 4] == 0).all())
    assert bool(torch.isfinite(norm[1, 0, 4])
                and torch.isnan(clean[1, 0, 4]).all())
    # rows 1-2 are fixed whole, row 3's norm and clean too
    _same_bits(got[0][:, 0, 1:4], want[0][:, 0, 1:4])
    _same_bits(got[1][..., 1:3], want[1][..., 1:3])
    _same_bits(got[1][2, ..., 3], want[1][2, ..., 3])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [30_336, 30_337])
def test_cuda_prefilter_second_body(cuda_device, L):
    assert not prefilter_row_on_chip(L)
    d, m, a = (torch.as_tensor(x, device=cuda_device)
               for x in prefilter_edge_rows(L))
    n = prefilter.bodies["streamed"]
    got = prefilter(d, m, a, BT)
    assert prefilter.bodies["streamed"] == n + 1
    _within(got, prefilter_plain(d, m, a, BT))


@pytest.mark.cuda
def test_cuda_prefilter_bodies_and_loads_same_bits(cuda_device,
                                                   monkeypatch):
    """The on-chip body, the second body and the scalar loads (a view one
    float off 16-byte alignment) give the same bits."""
    d, m, a = _block(cuda_device, 2, 2, 64, 13_568, seed=37)
    ref = prefilter(d, m, a, BT)
    buf = torch.empty(2 * d.numel() + 1, device=cuda_device)
    d_off = buf[1:1 + d.numel()].view(d.shape).copy_(d)
    m_off = buf[1 + d.numel():].view(m.shape).copy_(m)
    assert d_off.data_ptr() % 16
    unaligned = prefilter(d_off, m_off, a, BT)
    monkeypatch.setattr(pf, "PREFILTER_SMEM_BUDGET", 0)
    n = prefilter.bodies["streamed"]
    streamed = prefilter(d, m, a, BT)
    assert prefilter.bodies["streamed"] == n + 1
    for k in range(2):
        _same_bits(unaligned[k], ref[k])
        _same_bits(streamed[k], ref[k])


@pytest.mark.cuda
def test_cuda_prefilter_same_bits_launch_to_launch(cuda_device):
    d, m, a = _block(cuda_device, 2, 4, 128, 13_568, seed=41)
    first = prefilter(d, m, a, BT)
    for _ in range(2):
        again = prefilter(d, m, a, BT)
        for k in range(2):
            _same_bits(again[k], first[k])


@pytest.mark.cuda
def test_cuda_prefilter_same_bits_any_scan_batch(cuda_device):
    """A row's result depends on that row alone: scan batches of 1, 2 and
    all 4 scans give the same bits."""
    d, m, a = _block(cuda_device, 4, 2, 64, 13_568, seed=43)
    whole = prefilter(d, m, a, BT)
    for k in (1, 2):
        parts = [prefilter(d[s:s + k].contiguous(), m[s:s + k].contiguous(),
                           a[s:s + k], BT) for s in range(0, 4, k)]
        _same_bits(torch.cat([p[0] for p in parts]), whole[0])
        _same_bits(torch.cat([p[1] for p in parts], dim=1), whole[1])


@pytest.mark.cuda
def test_cuda_prefilter_chain_routes(cuda_device):
    """``_prefilter_chain`` launches K5 once on a field block, none on a
    calibrator's, and its outputs are the kernel's."""
    d, m, a = _block(cuda_device, 2, 2, 64, 13_568, seed=47)
    for calibrator, want in ((False, 1), (True, 0)):
        cfg = ReduceConfig(64, medfilt_window=101, is_calibrator=calibrator)
        n = prefilter.launches
        clean, norm, fit = _prefilter_chain(d, m, a, cfg)
        assert prefilter.launches == n + want
        assert fit.shape == (2, 2, 2, 64) and norm.shape == (2, 2, 64, 1)
    cfg = ReduceConfig(64, medfilt_window=101)
    clean, norm, fit = _prefilter_chain(d, m, a, cfg)
    k_clean, stats = prefilter(masked_fill(d, m), m, a,
                               cfg.bandwidth * cfg.tau)
    _same_bits(clean, k_clean)
    _same_bits(norm[..., 0], stats[2])
    _same_bits(fit, torch.stack([stats[0], stats[1]], dim=-2))


@pytest.mark.cuda
def test_cuda_prefilter_refuses_what_it_does_not_take(cuda_device):
    d, m, a = _block(cuda_device, 1, 1, 8, 1_024, seed=53)
    with pytest.raises(TypeError):
        prefilter(d.double(), m.double(), a.double(), BT)
    with pytest.raises(ValueError):
        prefilter(d, m, a.cpu(), BT)
    with pytest.raises(ValueError):
        prefilter(d, m[..., :512], a, BT)
    with pytest.raises(ValueError):
        prefilter(d.transpose(-1, -2).contiguous().transpose(-1, -2), m, a,
                  BT)
