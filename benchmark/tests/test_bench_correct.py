"""``correct`` at a small size on the CPU: the program passes, the
control fails, and each fault a cell can have, planted under a whole
run, turns ``correct`` false."""

import pytest
import torch

from benchmark import calibrate, harness
from conftest import SMALL, manifest

CELLS = sorted(SMALL)
M = manifest()


def _driver(cell):
    c = harness.load_cell(cell, M)
    c.sizes.update(SMALL[cell])
    drv = harness.load_driver(c.traffic["driver"]).Driver(
        c.sizes, c.traffic, 2**31 + 77, torch.device("cpu"))
    return c, drv


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    c, drv = _driver(cell)
    limits = c.traffic["limits"]
    prog = drv.compare([drv.step()])[0]
    assert all(prog[k] <= limits[k] for k in limits), prog
    ctrl = drv.compare([calibrate.control_record(drv.reference("bf16"),
                                                limits)])[0]
    assert any(ctrl[k] > limits[k] for k in limits), ctrl


def _run(cell):
    return harness.run(cell, 12345678901, 0.2, False, device="cpu",
                       manifest=M, sizes=SMALL[cell])


def test_a_sound_run_is_correct():
    for cell in CELLS:
        out = _run(cell)
        assert out["correct"] and out["failed"] == 0
        assert list(out)[-1] == "compared"


def _unchanged_state(monkeypatch, module):
    orig = module.destripe_planned

    def no_steps(*args, **kwargs):
        kwargs["n_iter"] = 0
        return orig(*args, **kwargs)
    monkeypatch.setattr(module, "destripe_planned", no_steps)


def _ces_half_channels(monkeypatch):
    from comapreduce_tpu_torch import flagship
    from comapreduce_tpu_torch.ops.reduce import ReduceConfig
    orig = flagship.reduce_feed_scans

    def half(tod, mask, airmass, starts, lengths, tsys, sys_gain, freq,
             cfg, **kw):
        h = tod.shape[1] // 2
        cfg2 = ReduceConfig(h, medfilt_window=cfg.medfilt_window,
                            scan_batch=cfg.scan_batch)
        return orig(tod[:, :h].contiguous(), mask, airmass, starts, lengths,
                    tsys[:, :h], sys_gain[:, :h], freq[:, :h], cfg=cfg2,
                    **kw)
    monkeypatch.setattr(flagship, "reduce_feed_scans", half)


def _ces_altered(monkeypatch):
    from comapreduce_tpu_torch import flagship
    orig = flagship.make_bands

    def altered(tods, weis, n_pad):
        t, w = orig(tods, weis, n_pad)
        t[0, 100] += 10.0 * t[0].abs().max()
        return t, w
    monkeypatch.setattr(flagship, "make_bands", altered)


def _field_half_bands(monkeypatch):
    from comapreduce_tpu_torch.cli import run_destriper
    orig = run_destriper.solve_bands_joint

    def half(datas, bands, **kw):
        n = len(bands) // 2
        res = orig(datas[:n], bands[:n], **kw)
        mean = res[0]._replace(
            offsets=sum(r.offsets for r in res) / n,
            destriped_map=sum(r.destriped_map for r in res) / n,
            naive_map=sum(r.naive_map for r in res) / n)
        return res + [mean] * (len(bands) - n)
    monkeypatch.setattr(run_destriper, "solve_bands_joint", half)


def _field_altered(monkeypatch):
    from comapreduce_tpu_torch.cli import run_destriper
    orig = run_destriper._expand_joint_results

    def altered(res, uniq, npix, nb):
        out = orig(res, uniq, npix, nb)
        out[0].destriped_map[uniq[0]] += 1.0
        return out
    monkeypatch.setattr(run_destriper, "_expand_joint_results", altered)


def _ces_unchanged(monkeypatch):
    from comapreduce_tpu_torch import flagship
    _unchanged_state(monkeypatch, flagship)


def _field_unchanged(monkeypatch):
    from comapreduce_tpu_torch.cli import run_destriper
    _unchanged_state(monkeypatch, run_destriper)


@pytest.mark.parametrize("cell,fault", [
    ("ces_obs.full", _ces_unchanged),
    ("ces_obs.full", _ces_half_channels),
    ("ces_obs.full", _ces_altered),
    ("field32.joint", _field_unchanged),
    ("field32.joint", _field_half_bands),
    ("field32.joint", _field_altered)],
    ids=["ces-state-unchanged", "ces-half-the-channels",
         "ces-answer-altered", "field-state-unchanged",
         "field-half-the-bands", "field-answer-altered"])
def test_a_fault_turns_correct_false(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"]
    assert out["failed"] == out["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card_reads_every_metric(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the traced run reads the "
                    "device's profile")
    out = harness.run(cell, 5, 0.5, True, device="cuda", manifest=M,
                      sizes=SMALL[cell])
    assert out["correct"]
    names = {m["name"] for m in harness.load_cell(cell, M).per_layer}
    assert set(out["metrics"]) == names
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
