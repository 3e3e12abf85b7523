"""The port's serving and tiles drills (``run_serving_drill``,
``run_tiles_drill`` of ``comapreduce_tpu_torch/resilience/drill.py``)
against the reference's on the CPU.

Each runs in both packages with the same seed, each with real server
subprocesses (``python -m <package>.resilience.drill --serving``) and,
for the tiles drill, a real tile server; each package's own criteria
hold (a broken one raises inside the drill: exactly-once folding, a
SIGKILL mid-publish leaving ``current`` whole, the resumed run
byte-identical to an uninterrupted twin, a cold epoch byte-identical to
a batch solve, warm start cheaper than cold, tiles old-or-new across a
kill, deterministic re-tiling, HTTP cutouts bit-identical, one
telemetry lane a process, eviction reproducing epoch 1's tile hashes).
The machine-independent evidence is equal between packages, and the
final warm epoch's map agrees with the reference's modulo the offset
null mode within the drill's own limit (1e-4).
"""

import numpy as np
import pytest
import torch

from comapreduce_tpu.resilience import drill as ref_drill
from comapreduce_tpu_torch.resilience import drill as port_drill


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (the suite's workers share the
    cores); the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_drill_matches_reference(tmp_path):
    ref = ref_drill.run_serving_drill(str(tmp_path / "ref"), seed=0)
    port = port_drill.run_serving_drill(str(tmp_path / "port"), seed=0,
                                        device="cpu")
    for key in ("serving_epochs", "serving_folded", "serving_kill_rc",
                "serving_twin_byte_identical", "serving_cold_parity"):
        assert port[key] == ref[key], key
    assert port["serving_warm_iters"] < port["serving_cold_iters"]
    assert port["serving_null_mode_resid"] < 1e-4
    # the warm epoch-2 maps of the two packages, modulo the null mode
    got = port_drill._read_epoch_map(str(tmp_path / "port" /
                                         "serving-epochs"), 2)
    want = ref_drill._read_epoch_map(str(tmp_path / "ref" /
                                         "serving-epochs"), 2)
    w = ref_drill._read_epoch_map(str(tmp_path / "ref" / "serving-epochs"),
                                  2, "WEIGHTS")
    hit = w > 0
    diff = got[hit] - want[hit]
    null = float(np.sum(diff * w[hit]) / np.sum(w[hit]))
    assert float(np.max(np.abs(diff - null))) < 1e-4


def test_tiles_drill_matches_reference(tmp_path):
    ref = ref_drill.run_tiles_drill(str(tmp_path / "ref"), seed=0)
    port = port_drill.run_tiles_drill(str(tmp_path / "port"), seed=0,
                                      device="cpu")
    for key in ("tiles_epochs", "tiles_n_tiles", "tiles_kill_rc",
                "tiles_delta_changed", "tiles_delta_unchanged",
                "tiles_retile_byte_identical", "tiles_cutout_bit_identical",
                "tiles_evict_epoch", "tiles_census"):
        assert port[key] == ref[key], key
    assert len(port["tiles_serving_lanes"]) == \
        len(ref["tiles_serving_lanes"]) >= 3
    assert min(port["tiles_serving_lanes"]) >= 1000


def test_serving_drills_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drill would run on it")
    for name in ("run_serving_drill", "run_tiles_drill"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(port_drill, name)(str(tmp_path / name))
