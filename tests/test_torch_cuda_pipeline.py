"""The Level-1 -> Level-2 stage chain's kernel sites and the chain itself on
the card: K1 (masked fill) over the reduction's full-width scan block
(10 scans x 4 bands x 1024 channels rows of 13 568 samples), K2 (rolling
median) at the exact window-501 filter over the band means (40 rows of
13 568 + 500) and at ``Spikes``' window 101 over the averaged TOD (76
rows of 136 216 + 100), each bitwise against its plain version; then the
shipped chain (``Runner.from_config`` on ``examples/configs/
configuration.toml``, the Level-2 store held in memory) over the
reference pipeline test's observation on the card and on the CPU, every
Level-2 dataset held by ``chip_smoke.check_level2`` (its rules and
measured margins are stated there), with K1 and K2 launched once per
feed and K2 once more in ``Spikes``; then ``chip_smoke.phase_drill``,
the chaos drill of the shipped run machinery (quarantine ledger, retry,
heartbeats, leases, the quality ledger) over four small observations on
the card against the CPU port, and the map-maker over its Level-2 stores
(its checks and limits are stated there). The drill's logic also runs
here on the CPU alone (the CPU as both devices).

Beside them, the chain's two fixed-order binnings (``ops/segment.py``:
the atmosphere fit's scan sums and the noise fits' log bins) give the same
bits in two runs on the card.

This file imports neither ``jax`` nor the JAX package, so it runs on a
machine with a card and no JAX: ``python -m pytest
tests/test_torch_cuda_pipeline.py``. Everywhere else every test skips
with a reason.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (bits_equal, check_level2, level1_view,
                        memory_runner, phase_drill, pipeline_test_params)
from comapreduce_tpu_torch.data.synthetic import generate_level1_store
from comapreduce_tpu_torch.ops.cuda_median import (
    masked_fill, masked_fill_plain, rolling_median_sorts,
    rolling_median_windows, rolling_median_windows_plain)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the whole module: its many small ops gain
    nothing from more on the CPU, and the suite's parallel workers
    oversubscribe the cores (the old count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_masked_fill_at_the_chain_scan_block(cuda_device):
    rows, L = 10 * 4 * 1024, 13_568
    g = torch.Generator(device=cuda_device).manual_seed(5)
    tod = 4.5e7 * (1 + 0.01 * torch.randn((rows, L), generator=g,
                                          device=cuda_device))
    mask = (torch.rand((rows, L), generator=g, device=cuda_device)
            > 0.01).float()
    mask[:, 13_500:] = 0.0                 # the scans' padded tails
    mask[7, ::4] = 0.0                     # a row taking the mean fallback
    got = masked_fill(tod, mask)
    want = masked_fill_plain(tod, mask)
    torch.cuda.synchronize()
    ok = torch.ones(rows, dtype=torch.bool, device=cuda_device)
    ok[7] = False
    assert bits_equal(got[ok], want[ok])
    # the mean fallback sums ~10 000 samples in another order
    torch.testing.assert_close(got[7], want[7], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,T,window", [(40, 13_568, 501),
                                           (76, 136_216, 101)])
def test_cuda_rolling_median_at_the_chain_sites(cuda_device, rows, T,
                                                window):
    assert rolling_median_sorts(window)
    g = torch.Generator(device=cuda_device).manual_seed(window)
    t = torch.arange(T + window - 1, device=cuda_device,
                     dtype=torch.float32)
    x = (torch.sin(t / 300.0)[None, :] + 0.1 * torch.randn(
        (rows, T + window - 1), generator=g, device=cuda_device))
    x[3, 1000:1040] = 0.0                  # ties, and -0/+0
    x[3, 1040:1050] = -0.0
    got = rolling_median_windows(x, window)
    want = rolling_median_windows_plain(x, window)
    torch.cuda.synchronize()
    assert got.shape == (rows, T)
    assert bits_equal(got, want)


@pytest.mark.cuda
def test_cuda_shipped_chain_matches_cpu(cuda_device):
    _, store = generate_level1_store(pipeline_test_params())
    out = {}
    for dev in ("cuda", "cpu"):
        masked_fill.launches = rolling_median_windows.launches = 0
        out[dev] = memory_runner(dev)._run_file(
            "comap-0000007.hd5", data=level1_view(store))
        if dev == "cuda":
            launches = (masked_fill.launches,
                        rolling_median_windows.launches)
    assert launches == (2, 3)
    for group in ("vane", "atmosphere", "averaged_tod", "spikes",
                  "fnoise_fits", "noise_statistics"):
        assert out["cuda"].contains_groups([group])
    diffs = check_level2(out["cuda"], out["cpu"], "card vs CPU")
    assert np.isfinite(list(diffs.values())).all()


@pytest.mark.cuda
def test_cuda_chaos_drill_matches_cpu(cuda_device, tmp_path):
    line = phase_drill(base=str(tmp_path / "drill"))
    assert line["run0_cuda_launches"] == {"masked_fill": 6,
                                          "rolling_median_windows": 9}
    assert len(line["mapped"]["masked"]) == 2


def test_drill_logic_on_the_cpu(tmp_path):
    """``phase_drill`` with the CPU as both devices: the ledger, the
    rerun's skip, the re-admission, the map-maker's ``[Slo]
    exclude_flagged`` dropping the file flagged under its Level-2 name,
    and its masked events."""
    line = phase_drill(base=str(tmp_path / "drill"), devices=("cpu", "cpu"))
    assert [e[3] for e in line["ledger"]] == ["quarantined", "recovered"]
    assert "comap-0000008-000000.hd5" not in line["rerun_loader_calls"]
    assert line["readmit_loader_calls"]["comap-0000008-000000.hd5"] == 1
    assert line["mapped"]["files"] == [
        "Level2_comap-0000007-000000.hd5",
        "Level2_comap-0000009-000000.hd5"]


@pytest.mark.cuda
def test_cuda_fixed_order_binning_is_bitwise_run_to_run(cuda_device):
    """``fit_atmosphere_segments`` on AtmosphereRemoval's layout (ten
    scans, gaps, the padded tail in scan 0) and ``log_bin_psd`` at the
    noise stages' shape: two runs, the same bits."""
    from comapreduce_tpu_torch.ops.atmosphere import fit_atmosphere_segments
    from comapreduce_tpu_torch.ops.power import (log_bin_plan, log_bin_psd,
                                                 psd)
    from comapreduce_tpu_torch.ops.segment import plan_segments

    T, Tb = 136_216, 137_000
    g = torch.Generator(device=cuda_device).manual_seed(11)
    tod = 4.5e7 * (1 + 0.01 * torch.randn((4, 1024, Tb), generator=g,
                                          device=cuda_device))
    mask = (torch.rand((4, 1024, Tb), generator=g, device=cuda_device)
            > 0.01).float()
    mask[..., T:] = 0.0
    am = 1.3 + 0.1 * torch.rand(Tb, generator=g, device=cuda_device)
    ids = np.full(Tb, -1, np.int32)
    for s in range(10):
        ids[300 + 13_564 * s:300 + 13_564 * s + 13_500] = s
    ids[T:] = 0
    runs = [fit_atmosphere_segments(tod, am, ids, mask, n_scans=10)
            for _ in range(2)]
    assert all(bits_equal(a, b) for a, b in zip(*runs))
    # the stage's call: the plan made once, the ids on the card
    plan = plan_segments(ids, 10)
    ids_t = torch.as_tensor(ids, device=cuda_device)
    runs = [fit_atmosphere_segments(tod, am, ids_t, mask, n_scans=10,
                                    plan=plan) for _ in range(2)]
    assert all(bits_equal(a, b) for a, b in zip(*runs))
    blocks = torch.randn((19, 4, 10, 13_440), generator=g,
                         device=cuda_device)
    freqs, ps = psd(blocks)
    for plan in (None, log_bin_plan(13_440, 50.0, 12)):
        runs = [log_bin_psd(freqs, ps, nbins=12,
                            sample_mask=(ps < ps.mean()).float(),
                            plan=plan) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(bits_equal(a, b) for a, b in zip(*runs))
