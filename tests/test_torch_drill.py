"""The port's chaos drills (``comapreduce_tpu_torch/resilience/drill.py``)
against the reference's (``comapreduce_tpu/resilience/drill.py``) on the
CPU.

- The drill fixtures (``_write_level2``) hold the reference's arrays bit
  for bit.
- ``run_drill`` (criteria 1-6: every fault class ledgered, the chaos map
  byte-identical to the clean one, resume and re-admission, the
  watchdog's and the writeback's deadlines), ``run_elastic_drill``
  (criterion 7: three real ranks, one SIGKILLed, one zombie) and
  ``run_live_drill`` (the live plane over a real SIGKILL) run in both
  packages with the same seed: each package's own criteria hold (a
  broken one raises inside the drill), and the evidence that does not
  depend on the machine — counts, dispositions, lease states, the
  faults injected and ledgered, the steals, the fence rejects, the
  commit counters — is equal.
- The chaos run's map agrees between packages within the destriper
  CLI's tolerances (``tests/test_torch_run_destriper_cli.py``).
- ``python -m comapreduce_tpu_torch.cli.check_resilience --device=cpu``
  exits 0 with ``{"ok": true, ...}`` as its last line, and takes every
  flag of ``tools/check_resilience.py`` plus ``--device``.

The serving and tiles drills are in ``tests/test_torch_drill_serving.py``,
the integrity drill in ``tests/test_torch_fsck.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from comapreduce_tpu.resilience import drill as ref_drill
from comapreduce_tpu_torch.resilience import drill as port_drill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (the suite's workers share the
    cores); the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tmp_path, name, **kw):
    """``name`` run in each package in its own workdir."""
    ref = getattr(ref_drill, name)(str(tmp_path / "ref"), **kw)
    port = getattr(port_drill, name)(str(tmp_path / "port"),
                                     device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("kw", [{}, {"drift": 6.0, "rw": 0.3,
                                     "raster": True}],
                         ids=["white", "drift_raster"])
def test_write_level2_matches_reference(tmp_path, kw):
    from comapreduce_tpu.data.hdf5io import HDF5Store as RefStore
    from comapreduce_tpu_torch.data.hdf5io import HDF5Store

    ref_drill._write_level2(str(tmp_path / "r.hd5"), 1003, **kw)
    port_drill._write_level2(str(tmp_path / "p.hd5"), 1003, **kw)
    a = HDF5Store().read(str(tmp_path / "p.hd5"))
    b = RefStore().read(str(tmp_path / "r.hd5"))
    keys = ("averaged_tod/tod", "averaged_tod/weights",
            "averaged_tod/scan_edges",
            "spectrometer/pixel_pointing/pixel_ra",
            "spectrometer/pixel_pointing/pixel_dec")
    for k in keys:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_run_drill_matches_reference(tmp_path):
    """Criteria 1-6 in both packages: the same faults injected, ledgered
    and triaged, the same quarantined set and masked samples, both
    chaos maps byte-identical to their clean runs, two cancelled hang
    attempts within hard + grace, the writeback's stalled write
    cancelled and its late commit skipped."""
    ref, port = _both(tmp_path, "run_drill", seed=0)
    for key in ("n_files", "injected", "quarantined", "ledger_summary",
                "n_masked_samples", "map_byte_identical",
                "writeback_writes", "writeback_late_skips",
                "hard_deadline_s", "hang_grace_s"):
        assert port[key] == ref[key], key
    assert port["map_byte_identical"] is True
    assert len(port["hang_cancel_s"]) == len(ref["hang_cancel_s"]) == 2
    budget = port["hard_deadline_s"] + port["hang_grace_s"]
    assert all(dt <= budget for dt in port["hang_cancel_s"])
    assert len(port["writeback_hang_cancel_s"]) == 1
    assert [e[0] for e in port["watchdog_events"]] == \
        [e[0] for e in ref["watchdog_events"]]


def test_chaos_map_agrees_with_the_reference(tmp_path):
    """The drill's survivors read and solved by each package's ``_read``
    and ``_solve`` (medfilt 51, 50 iterations, threshold 1e-5): the
    naive maps within 1e-4 and the destriped maps within 5e-4, the
    destriper CLI test's limits (``NAIVE_ATOL``, ``DESTRIPED_ATOL``)."""
    from comapreduce_tpu.mapmaking.wcs import WCS as RefWCS
    from comapreduce_tpu_torch.mapmaking.wcs import WCS

    files = []
    for i in (0, 3, 4, 6):
        path = str(tmp_path / f"Level2_comap-{i:04d}.hd5")
        port_drill._write_level2(path, seed=1000 + i)
        files.append(path)
    geo = ((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))
    ref = ref_drill._solve(ref_drill._read(files, RefWCS.from_field(*geo)))
    port = port_drill._solve(port_drill._read(files, WCS.from_field(*geo),
                                              device="cpu"), "cpu")
    assert int(port.n_iter) > 0
    for name, tol in (("naive_map", 1e-4), ("destriped_map", 5e-4)):
        got = np.asarray(getattr(port, name))
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)


def test_elastic_drill_matches_reference(tmp_path):
    """Criterion 7 in both packages: the killer died by SIGKILL, the
    zombie's late commit was fenced once, the survivor stole and
    recovered the same two units and committed all seven exactly once,
    and each map over the committed set is byte-identical to its clean
    run."""
    ref, port = _both(tmp_path, "run_elastic_drill", seed=0)
    for key in ("elastic_returncodes", "elastic_stolen",
                "elastic_recovered", "elastic_fence_rejects",
                "elastic_map_byte_identical"):
        assert port[key] == ref[key], key
    assert sorted(port["elastic_committed"]["survivor"]) == \
        sorted(ref["elastic_committed"]["survivor"])
    assert port["elastic_committed"]["zombie"] == []
    for who in ("survivor", "zombie"):
        for stat in ("stolen", "recovered", "committed", "fence_rejects"):
            assert port["elastic_stats"][who].get(stat) == \
                ref["elastic_stats"][who].get(stat), (who, stat)


def test_live_drill_matches_reference(tmp_path):
    """The live plane over a real SIGKILL in both packages: ``/healthz``
    flips 503 within a TTL of the kill and back after the restart, and
    the ``/metrics`` commit counter equals the scheduler's commits."""
    ref, port = _both(tmp_path, "run_live_drill", seed=0)
    for key in ("live_ttl_s", "live_committed_metric",
                "live_committed_true"):
        assert port[key] == ref[key], key
    assert port["live_t_503_after_kill_s"] <= port["live_ttl_s"] + 2.0


def _flags(argv) -> set:
    """The option names of a CLI's ``--help`` (its options section)."""
    out = subprocess.run(argv + ["--help"], capture_output=True, text=True,
                         cwd=REPO, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    opts = out.stdout.split("options:", 1)[1]
    return {ln.split()[0].rstrip(",") for ln in opts.splitlines()
            if ln.strip().startswith("--")}


def test_check_resilience_runs_the_drill_and_takes_the_reference_flags(
        tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "comapreduce_tpu_torch.cli.check_resilience",
         "--device=cpu", f"--workdir={tmp_path}"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["map_byte_identical"] is True
    ref = _flags([sys.executable, "tools/check_resilience.py"])
    port = _flags([sys.executable, "-m",
                   "comapreduce_tpu_torch.cli.check_resilience"])
    assert port - ref == {"--device"}
    assert ref <= port


def test_drills_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drill would run on it")
    for name in ("run_drill", "run_elastic_drill", "run_live_drill"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(port_drill, name)(str(tmp_path / name))
