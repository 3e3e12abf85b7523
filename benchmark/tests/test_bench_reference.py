"""The plain references against hand values at tiny sizes."""

import pytest
import torch

from benchmark.reference import destriper, reduction


def test_destriper_recovers_offsets_and_sky():
    # two offsets of two samples over two pixels: sky (1, 2), offsets
    # (0.5, -0.5), no noise
    tod = torch.tensor([[1.5, 2.5, 0.5, 1.5]], dtype=torch.float64)
    w = torch.ones_like(tod)
    pix = torch.tensor([0, 1, 0, 1])
    out = destriper.destripe(tod, w, pix, 2, 2, 100, 1e-10)
    off = out["offsets"][0] - out["offsets"][0].mean()
    assert off.tolist() == pytest.approx([0.5, -0.5], abs=1e-12)
    m = out["map"][0]
    assert (m - m.mean()).tolist() == pytest.approx([-0.5, 0.5], abs=1e-12)
    assert out["naive"][0].tolist() == pytest.approx([1.0, 2.0])
    assert out["hits"].tolist() == [2, 2]
    assert out["weight"][0].tolist() == [2.0, 2.0]
    assert out["n_iter"] <= 2


def test_destriper_drops_samples_without_a_pixel():
    tod = torch.tensor([[1.0, 2.0, 7.0, 9.0]], dtype=torch.float64)
    w = torch.ones_like(tod)
    pix = torch.tensor([0, 1, 2, -1])          # 2 and -1: no pixel
    out = destriper.destripe(tod, w, pix, 2, 2, 10, 1e-8)
    assert out["hits"].tolist() == [1, 1]
    assert out["naive"][0].tolist() == pytest.approx([1.0, 2.0])


def test_running_median_with_symmetric_edges():
    x = torch.tensor([[1.0, 5.0, 2.0, 8.0, 3.0]], dtype=torch.float64)
    # padded [1 | 1 5 2 8 3 | 3]
    assert reduction.median_filter(x, 3)[0].tolist() == [1, 2, 5, 3, 3]
    # even window (one before, two after): the mean of the two middles;
    # padded [1 | 1 5 2 8 3 | 3 8]
    assert reduction.median_filter(x, 4)[0].tolist() == [
        1.5, 3.5, 4.0, 3.0, 5.5]


def test_two_level_median_of_a_constant_and_of_a_step():
    x = torch.full((1, 3000), 4.0, dtype=torch.float64)
    assert torch.equal(reduction.median_filter(x, 1030), x)
    step = torch.cat([torch.zeros(1, 3000), torch.ones(1, 3000)], -1)
    out = reduction.median_filter(step.double(), 1030)
    assert out[0, :2000].eq(0).all() and out[0, -2000:].eq(1).all()


def test_masked_median():
    x = torch.tensor([[3.0, 1.0, 2.0, 100.0], [4.0, 1.0, 0.0, 0.0]])
    m = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 0.0]])
    assert reduction._masked_median(x, m).tolist() == [2.0, 2.5]
    assert reduction._masked_median(x, torch.zeros_like(m)).tolist() == [
        0.0, 0.0]


def test_vane_on_a_clean_step():
    # first half sees the 290 K load: counts = gain (tsys + 290), then
    # gain tsys; the formula divides by 290 - 2.73
    gain = torch.tensor([[2.0, 3.0]], dtype=torch.float64)
    tsys = torch.tensor([[40.0, 50.0]], dtype=torch.float64)
    load = torch.where(torch.arange(64) < 32, 290.0, 0.0).double()
    v = gain[..., None] * (tsys[..., None] + load)
    t, g = reduction.vane(v, 290.0)
    assert g.tolist()[0] == pytest.approx((gain * 290 / 287.27).tolist()[0])
    assert t.tolist()[0] == pytest.approx((tsys * 287.27 / 290).tolist()[0])


def test_vane_without_a_hot_half_gives_zeros():
    v = torch.full((1, 3, 64), 5.0, dtype=torch.float64)
    t, g = reduction.vane(v, 290.0)
    assert t.abs().sum() == 0 and g.abs().sum() == 0


def test_channel_masks_at_1024():
    m = reduction.channel_masks(1024)
    assert m["weights"][:10].sum() == 0 and m["weights"][10] == 1
    assert m["weights"][510:515].sum() == 0 and m["weights"][509] == 1
    assert m["band_avg"][:50].sum() == 0 and m["band_avg"][512] == 0
    assert m["band_avg"][511] == 1


def test_bf16_storage_rounds():
    tod = torch.tensor([[1.0 + 2 ** -10, 1.0, 1.0, 1.0]])
    w = torch.ones_like(tod)
    out = destriper.destripe(tod, w, torch.tensor([0, 0, 0, 0]), 1, 2, 5,
                             1e-8, prec="bf16")
    assert out["naive"][0].item() == 1.0
