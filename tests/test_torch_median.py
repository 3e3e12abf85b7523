"""Kernels K1 (masked fill) and K2 (rolling median) of
``comapreduce_tpu_torch.ops.cuda_median`` and the median filter built on
them, against the reference on the same numpy inputs.

On the CPU the wrappers take their plain versions; those are held
BITWISE to the reference's XLA paths (``_fill_bad_xla``,
``_rolling_median_xla``) and to the Pallas kernels run by the Pallas
interpreter, for every selection output. The one carve-out is the
reference's own (``tests/test_pallas_median.py``): the masked-MEAN
fallback of K1 is a sum, summed in another order than XLA's. Its
summands are O(1) while the mean is ~0.01, so it is held to rtol 6e-7
plus atol 1e-7 — about one ulp of the summands.

The CUDA kernels themselves are compared with these plain versions on
the card (tests marked ``cuda``, skipped without a card; and
``chip_smoke.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import median_edge_rows
from comapreduce_tpu.ops import median_filter as ref_mf
from comapreduce_tpu.ops.pallas_median import (masked_fill_pallas,
                                               rolling_median_windows_pallas)
from comapreduce_tpu.ops.reduce import _fill_bad_xla
from comapreduce_tpu_torch.ops import median_filter as port_mf
from comapreduce_tpu_torch.ops.cuda_median import (
    FILL_SMEM_BUDGET, RM_OUT, RM_SORT_SMEM, fill_row_on_chip, masked_fill,
    masked_fill_plain, rolling_median_sorts, rolling_median_windows,
    rolling_median_windows_plain)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return np.where(np.isnan(a), np.uint32(0x7FC00000), a.view(np.uint32))


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# K1: masked fill
# ---------------------------------------------------------------------------

def _fill_fixture(B, C, L, seed=1):
    """tests/test_pallas_median.py::_fill_fixture: random masks, an
    all-masked channel, a channel valid only off the stride-4 grid (the
    mean fallback), a masked-out NaN and a masked-in NaN."""
    rng = np.random.default_rng(seed)
    tod = rng.normal(size=(B, C, L)).astype(np.float32)
    mask = (rng.random((B, C, L)) > 0.2).astype(np.float32)
    mask[0, 0] = 0.0
    if L >= 8 and C >= 2:
        mask[0, 1] = 0.0
        mask[0, 1, 1::4] = 1.0
    tod[0, C - 1, 0] = np.nan
    mask[0, C - 1, 0] = 0.0
    if C >= 4:
        tod[0, 3, 5] = np.nan
        mask[0, 3, 5] = 1.0
    return tod, mask


def _check_fill(got, want, mask):
    mean_rows = (mask[..., ::4].sum(-1) == 0) & (mask.sum(-1) > 0)
    fb = mean_rows[..., None] & (mask == 0)
    _assert_bitwise(got[~fb], want[~fb])
    np.testing.assert_allclose(got[fb], want[fb], rtol=6e-7, atol=1e-7)


# (1, 5, 4096): rows long enough (L/4 = 1024) for the radix branch of
# the stride-4 median; the others take the sort branch; L = 13 leaves a
# ragged stride-4 tail
@pytest.mark.parametrize("shape", [(2, 3, 1024), (1, 5, 1000),
                                   (1, 5, 4096), (2, 4, 13)])
def test_masked_fill_matches_xla_and_pallas(shape):
    tod, mask = _fill_fixture(*shape)
    got = masked_fill(torch.as_tensor(tod), torch.as_tensor(mask)).numpy()
    _check_fill(got, np.asarray(_fill_bad_xla(jnp.asarray(tod),
                                              jnp.asarray(mask))), mask)
    _check_fill(got, np.asarray(masked_fill_pallas(
        jnp.asarray(tod), jnp.asarray(mask), interpret=True)), mask)


def test_masked_fill_keeps_rows_on_chip_within_budget():
    """K1 keeps a whole row on chip while row, mask bits and keys (21
    bytes per 4 samples) fit its shared-memory budget — the main path's
    L = 13 568 does; longer rows take its second body."""
    assert fill_row_on_chip(13568)
    assert fill_row_on_chip(4 * (FILL_SMEM_BUDGET // 21))
    assert not fill_row_on_chip(4 * (FILL_SMEM_BUDGET // 21) + 1)
    assert not fill_row_on_chip(300_000)


def test_masked_fill_scan_mask_rows():
    """The main path's mask: a time mask broadcast over channels with a
    padded tail, on counts of production magnitude."""
    rng = np.random.default_rng(4)
    tod = (4.5e7 * (1 + 0.01 * rng.normal(size=(2, 3, 1280)))).astype(
        np.float32)
    mask = np.ones_like(tod)
    mask[..., 1000:] = 0.0
    got = masked_fill_plain(torch.as_tensor(tod), torch.as_tensor(mask))
    _assert_bitwise(got.numpy(), np.asarray(
        _fill_bad_xla(jnp.asarray(tod), jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# K2: rolling median over pre-padded rows
# ---------------------------------------------------------------------------

def _oracle(x2, w):
    T = x2.shape[-1] - w + 1
    return np.stack([[np.median(x2[r, i:i + w]) for i in range(T)]
                     for r in range(x2.shape[0])])


@pytest.mark.parametrize("shape,w", [((3, 700), 37), ((8, 900), 64),
                                     ((2, 4, 500), 129), ((9, 1300), 500),
                                     ((2, 300), 5)])
def test_rolling_windows_match_pallas_and_xla(shape, w):
    rng = np.random.default_rng(int(w))
    x = (rng.normal(size=shape) * rng.choice([1e-5, 1.0, 1e4],
                                             size=shape)).astype(np.float32)
    got = rolling_median_windows(torch.as_tensor(x), w).numpy()
    _assert_bitwise(got, np.asarray(rolling_median_windows_pallas(
        jnp.asarray(x), w, chunk=128, interpret=True)))
    T = shape[-1] - w + 1
    _assert_bitwise(got, np.asarray(ref_mf._rolling_median_xla(
        jnp.asarray(x), window=w, chunk=128, T=T)))


def test_rolling_windows_negative_tied_and_nan():
    rng = np.random.default_rng(0)
    x = rng.choice([-2.5, -1.0, 0.0, 1.0, 3.5], size=(4, 640)).astype(
        np.float32)
    x[0, 300] = np.nan
    x[1, 10:15] = np.nan
    w = 100
    got = rolling_median_windows(torch.as_tensor(x), w).numpy()
    _assert_bitwise(got, np.asarray(rolling_median_windows_pallas(
        jnp.asarray(x), w, interpret=True)))
    T = x.shape[-1] - w + 1
    nan_windows = np.array([[np.isnan(x[r, i:i + w]).any()
                             for i in range(T)] for r in range(4)])
    assert (np.isnan(got) == nan_windows).all()
    clean = ~nan_windows
    _assert_bitwise(got[clean], _oracle(x, w)[clean])


# chip_smoke.py's K2 edge rows (ties, -0/+0 middles, NaN windows of
# both signs and of the sentinel's bit pattern), at an odd and an even
# window
@pytest.mark.parametrize("name", ["tied", "block_median", "signed_zero_nan"])
@pytest.mark.parametrize("w", [101, 64])
def test_rolling_windows_edge_rows_match_pallas(name, w):
    x = median_edge_rows(700, w)[name]
    got = rolling_median_windows(torch.as_tensor(x), w).numpy()
    _assert_bitwise(got, np.asarray(rolling_median_windows_pallas(
        jnp.asarray(x), w, chunk=128, interpret=True)))
    if name == "signed_zero_nan":
        assert np.isnan(got).any() and not np.isnan(got).all()


@pytest.mark.parametrize("shape,w", [((8, 2130), 500), ((3, 700), 37),
                                     ((4, 640), 100)])
def test_quantile_on_unfold_is_the_rolling_median(shape, w):
    """K2's library yardstick, ``torch.quantile`` of each window at 0.5
    on an unfold view, computes the same function as its plain version:
    linear interpolation at 0.5 is the midpoint of the two middles
    (``lo + 0.5 (hi - lo)`` against ``0.5 (lo + hi)``: within one ulp of
    the scale), and a window holding NaN gives NaN."""
    rng = np.random.default_rng(w)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 3] = np.nan
    x[-1, shape[-1] // 2] = np.nan
    xt = torch.as_tensor(x)
    want = rolling_median_windows_plain(xt, w).numpy()
    got = torch.quantile(xt.unfold(-1, w, 1), 0.5, dim=-1).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = float(np.nanmax(np.abs(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=float(np.spacing(np.float32(scale))))


def test_rolling_median_sorts_within_budget():
    """K2 sorts a block's ``RM_OUT + window - 1`` (key, position) pairs,
    8 bytes each and padded to a power of two, while they fit
    ``RM_SORT_SMEM`` — the main path's window 500 does; longer windows
    take its bisection body."""
    n_max = RM_SORT_SMEM // 8
    assert rolling_median_sorts(500)
    assert rolling_median_sorts(n_max - RM_OUT + 1)
    assert not rolling_median_sorts(n_max - RM_OUT + 2)
    assert not rolling_median_sorts(20_000)
    assert rolling_median_sorts(1)


def test_rolling_windows_rejects_short_rows():
    with pytest.raises(ValueError):
        rolling_median_windows(torch.zeros((2, 100)), 200)


# ---------------------------------------------------------------------------
# the median filter on top of K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_mode,w,stride", [
    ("edge", 37, 1), ("symmetric", 101, None), ("edge", 64, 1),
    ("symmetric", 1100, None), ("edge", 1100, None), ("symmetric", 900, 2)])
def test_rolling_median_matches_reference(pad_mode, w, stride):
    """Exact windows and the two-level filter (window > 512: block
    medians, then an exact rolling median of the block series) — every
    output an order statistic of the same input, so bitwise."""
    rng = np.random.default_rng(w)
    x = rng.normal(size=(2, 3, 1500)).astype(np.float32)
    want = np.asarray(ref_mf.rolling_median(jnp.asarray(x), w,
                                            stride=stride,
                                            pad_mode=pad_mode))
    got = port_mf.rolling_median(torch.as_tensor(x), w, stride=stride,
                                 pad_mode=pad_mode)
    _assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("fold_len", [1500, 700])
def test_rolling_median_dynamic_fold(fold_len):
    """``fold_len``: the symmetric reflection at a dynamic boundary
    (multi-reflection included when the window exceeds it)."""
    rng = np.random.default_rng(fold_len)
    x = rng.normal(size=(2, 1500)).astype(np.float32)
    for w in (101, 1100):
        want = np.asarray(ref_mf.rolling_median(
            jnp.asarray(x), w, pad_mode="symmetric",
            fold_len=jnp.int32(fold_len)))
        got = port_mf.rolling_median(torch.as_tensor(x), w,
                                     pad_mode="symmetric",
                                     fold_len=fold_len)
        _assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("w", [101, 1100, 3000])
def test_medfilt_highpass_matches_reference(w):
    """The high-pass: the band mean (a channel sum, f32 order) feeds the
    median, so the filter output and the per-channel affine fit are held
    to summation-order tolerance: rtol 1e-5 of scale on the filtered
    block, 1e-5 of scale on the median series. ``w = 3000 >= 2T`` takes
    the 3x-reflect branch."""
    rng = np.random.default_rng(w)
    B, C, T = 2, 16, 1300
    tod = rng.normal(size=(B, C, T)).astype(np.float32)
    tod += np.linspace(0, 3, T, dtype=np.float32)
    cm = (rng.random((B, C)) > 0.2).astype(np.float32)
    tm = np.ones(T, np.float32)
    tm[1200:] = 0.0
    fr, mr = ref_mf.medfilt_highpass(jnp.asarray(tod), jnp.asarray(cm), w,
                                     time_mask=jnp.asarray(tm))
    ft, mt = port_mf.medfilt_highpass(torch.as_tensor(tod),
                                      torch.as_tensor(cm), w,
                                      time_mask=torch.as_tensor(tm))
    for got, want in ((ft, fr), (mt, mr)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_reflect3():
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    np.testing.assert_array_equal(
        port_mf._reflect3(torch.as_tensor(x)).numpy(),
        np.asarray(ref_mf._reflect3(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    tod, mask = _fill_fixture(2, 8, 4096)
    t = torch.as_tensor(tod, device=cuda_device)
    m = torch.as_tensor(mask, device=cuda_device)
    before = masked_fill.launches
    got = masked_fill(t, m).cpu().numpy()
    assert masked_fill.launches == before + 1
    _check_fill(got, masked_fill_plain(t.cpu(), m.cpu()).numpy(), mask)
    x = torch.randn((8, 2130), device=cuda_device)
    before = rolling_median_windows.launches
    got = rolling_median_windows(x, 500).cpu().numpy()
    assert rolling_median_windows.launches == before + 1
    _assert_bitwise(got, rolling_median_windows_plain(x.cpu(), 500).numpy())
