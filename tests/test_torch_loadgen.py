"""The port's scale drill (``comapreduce_tpu_torch/synthetic/loadgen.py``
and ``cli/run_synthetic drill``) against the reference's
(``comapreduce_tpu/synthetic/loadgen.py``) on the CPU.

- ``SCALE_SCENARIO``, ``scale_scenario``, ``write_scenario_toml`` (the
  same bytes), ``_reduce_config`` and ``_scan_leases`` equal the
  reference's.
- ``run_synthetic_drill`` at a tier-1 size (12 files: three elastic
  worker processes running the real stage chain over ``synth://``
  members, rank 1 SIGKILLed holding a lease and rejoined, a map server
  with a tile root and a live sidecar under load) in both packages, the
  port's through ``python -m comapreduce_tpu_torch.cli.run_synthetic
  drill --device cpu``: each package's own criteria hold (exactly-once
  leases, one Level-2 product a unit, the leaked unit stolen and done,
  ``/healthz`` 503 after the kill and 200 after the rejoin, the final
  epoch's census the whole campaign with current tiles, the ``/metrics``
  commit counters of the cleanly drained ranks equal to their
  schedulers'), and the machine-independent evidence is equal. Which
  rank commits which unit, and so the mid-run epoch's census, is the
  race of three processes and is not compared.
- The 200-file drill is ``slow`` in the reference and here.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from comapreduce_tpu.synthetic import loadgen as ref_lg
from comapreduce_tpu_torch.synthetic import loadgen as port_lg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (the suite's workers share the
    cores); the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,n_files", [(0, 200), (3, 12)])
def test_scenario_and_toml_match_the_reference(tmp_path, seed, n_files):
    assert port_lg.SCALE_SCENARIO == ref_lg.SCALE_SCENARIO
    port = port_lg.scale_scenario(seed, n_files)
    ref = ref_lg.scale_scenario(seed, n_files)
    assert {k: getattr(port, k) for k in type(port).KNOBS} == \
        {k: getattr(ref, k) for k in type(ref).KNOBS}
    a = port_lg.write_scenario_toml(port, str(tmp_path / "p.toml"))
    b = ref_lg.write_scenario_toml(ref, str(tmp_path / "r.toml"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert port_lg._reduce_config("o", "s", 2.0) == \
        ref_lg._reduce_config("o", "s", 2.0)


def test_scan_leases_reads_the_reference_layout(tmp_path):
    from comapreduce_tpu.resilience.lease import LeaseBoard

    board = LeaseBoard(str(tmp_path), rank=0, lease_ttl_s=60.0)
    for name in ("synth://scale/0/a.hd5", "synth://scale/0/b.hd5"):
        lease = board.claim(name)
        if name.endswith("a.hd5"):
            board.commit(lease)
    got = port_lg._scan_leases(str(tmp_path))
    assert got == ref_lg._scan_leases(str(tmp_path))
    assert {k: v["state"] for k, v in got.items()} == \
        {"a.hd5": "done", "b.hd5": "claimed"}


_SAME = ("n_files", "seed", "returncodes", "leaked_units", "final_epoch",
         "final_published", "n_tiles")


def test_scale_drill_matches_reference(tmp_path):
    ref = ref_lg.run_synthetic_drill(str(tmp_path / "ref"), seed=0,
                                     n_files=12)
    proc = subprocess.run(
        [sys.executable, "-m", "comapreduce_tpu_torch.cli.run_synthetic",
         "drill", f"--workdir={tmp_path / 'port'}", "--n-files=12",
         "--seed=0", "--device=cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert port.pop("ok") is True
    for key in _SAME:
        assert port[key] == ref[key], key
    assert port["stolen"] >= 1 and ref["stolen"] >= 1
    assert sum(port["commits_by_rank"].values()) \
        + port["dead_rank_commits"] == 12
    assert port["epochs"][-1] == port["final_epoch"]


def test_scale_drill_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drill would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_lg.run_synthetic_drill(str(tmp_path), n_files=12)
    assert not os.listdir(tmp_path)


@pytest.mark.slow
def test_full_scale_drill_200_files(tmp_path):
    """The reference's slow acceptance drill, on the port: a 200-file
    ``synth://`` campaign through three elastic ranks, the map server
    and the tile tier, with the mid-run SIGKILL and rejoin."""
    ev = port_lg.run_synthetic_drill(str(tmp_path), seed=1, n_files=200,
                                     device="cpu")
    assert sum(ev["commits_by_rank"].values()) + ev["stolen"] >= 200
    assert ev["rejoin_commits"] >= 1
    assert len(ev["epochs"]) >= 2
