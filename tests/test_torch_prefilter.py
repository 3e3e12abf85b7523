"""K5's CPU route (``ops/prefilter.py``): a CPU tensor takes the plain
version and launches nothing; the plain version's fit is
``fit_airmass_block``'s, bit for bit; the field branch of
``_prefilter_chain`` is the plain version after the fill, bit for bit;
and the edge rows the card tests use (``chip_smoke.prefilter_edge_rows``)
read as their docstring says under the plain arithmetic. The reference
comparison of both routes of ``_prefilter_chain`` is
``tests/test_torch_reduce.py::test_prefilter_chain``."""

import numpy as np
import pytest
import torch

from chip_smoke import prefilter_edge_rows
from comapreduce_tpu_torch.ops.atmosphere import fit_airmass_block
from comapreduce_tpu_torch.ops.cuda_median import masked_fill_plain
from comapreduce_tpu_torch.ops.prefilter import (PREFILTER_SMEM_BUDGET,
                                                 prefilter, prefilter_plain,
                                                 prefilter_row_on_chip)
from comapreduce_tpu_torch.ops.reduce import ReduceConfig, _prefilter_chain


def _block(S=2, B=2, C=16, L=1024, seed=5):
    rng = np.random.default_rng(seed)
    a = np.stack([1.2 + 0.05 * np.sin(np.arange(L) / 150.0 + s)
                  for s in range(S)]).astype(np.float32)
    d = (4.5e7 * (1 + 0.01 * rng.standard_normal((S, B, C, L)))
         + 3e5 * a[:, None, None, :]).astype(np.float32)
    m = (rng.random((S, B, C, L)) > 0.05).astype(np.float32)
    d[0, 1, 3, 17] = np.nan
    m[0, 1, 3, 17] = 0.0
    m[..., 1000:] = 0.0
    return torch.as_tensor(d), torch.as_tensor(m), torch.as_tensor(a)


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_cpu_route_launches_nothing():
    d, m, a = _block()
    before = (prefilter.launches, dict(prefilter.bodies))
    for calibrator in (False, True):
        _prefilter_chain(d, m, a, ReduceConfig(16, medfilt_window=101,
                                               is_calibrator=calibrator))
    prefilter(masked_fill_plain(d, m), m, a, 0.04)
    prefilter_plain(masked_fill_plain(d, m), m, a, 0.04)
    assert (prefilter.launches, prefilter.bodies) == before


def test_plain_fit_is_fit_airmass_block_bitwise():
    d, m, a = _block()
    d = masked_fill_plain(d, m)
    offset, slope = fit_airmass_block(d, a[:, None, None, :], m)
    _, stats = prefilter_plain(d, m, a, 0.04)
    assert torch.equal(_bits(stats[0]), _bits(offset))
    assert torch.equal(_bits(stats[1]), _bits(slope))
    cfg = ReduceConfig(16, medfilt_window=101)
    _, _, fit = _prefilter_chain(d, m, a, cfg)
    assert torch.equal(_bits(fit), _bits(torch.stack([offset, slope], -2)))


def test_prefilter_chain_field_is_plain_after_the_fill_bitwise():
    d, m, a = _block(seed=6)
    cfg = ReduceConfig(16, medfilt_window=101)
    clean, norm, fit = _prefilter_chain(d, m, a, cfg)
    p_clean, stats = prefilter_plain(masked_fill_plain(d, m), m, a,
                                     cfg.bandwidth * cfg.tau)
    assert norm.shape == (2, 2, 16, 1) and fit.shape == (2, 2, 2, 16)
    assert torch.equal(_bits(clean), _bits(p_clean))
    assert torch.equal(_bits(norm[..., 0]), _bits(stats[2]))


@pytest.mark.parametrize("L", [13_568, 13_567, 13_565, 30_337])
def test_edge_rows_read_as_documented(L):
    d, m, a = (torch.as_tensor(x) for x in prefilter_edge_rows(L))
    clean, (offset, slope, norm) = prefilter_plain(d, m, a, 0.04)
    for c in (1, 2, 3):
        assert bool((norm[:, 0, c] == 0).all())
        assert bool((clean[:, 0, c] == 0).all())
    assert bool((slope[:, 0, 1:3] == 0).all())
    assert bool(slope[0, 0, 3] != 0)
    assert bool((slope[1] == 0).all())
    assert bool(torch.isnan(offset[:, 0, 4]).all())
    assert bool(torch.isnan(norm[0, 0, 4]) and (clean[0, 0, 4] == 0).all())
    assert bool(torch.isfinite(norm[1, 0, 4])
                and torch.isnan(clean[1, 0, 4]).all())
    for c in (0, 5, 6, 7):
        assert bool(torch.isfinite(clean[:, 0, c]).all())
        assert bool((norm[:, 0, c] > 0).all())
    assert bool((slope[0, 0, [0, 5, 6, 7]] != 0).all())


def test_row_on_chip_by_length():
    edge = PREFILTER_SMEM_BUDGET // 32 * 4
    assert prefilter_row_on_chip(13_568)
    assert prefilter_row_on_chip(edge)
    assert not prefilter_row_on_chip(edge + 1)
    assert not prefilter_row_on_chip(30_336)
