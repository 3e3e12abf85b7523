"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``
from the checkout root (CPU; the one test marked ``cuda`` skips where
torch sees no card)."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: entries of cells whose files are built and calibrated but that are
#: held out of BENCHMARK.json (``staged.json`` says why)
STAGED = json.loads((Path(__file__).parent / "staged.json").read_text())
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def manifest() -> dict:
    """BENCHMARK.json with the staged entries it does not name."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for g in GROUPS:
        have = {e["name"] for e in m[g]}
        m[g] += [e for e in STAGED[g] if e["name"] not in have]
    return m


#: the cells at a size the CPU holds: every width and knob as configured,
#: fewer feeds, bands, channels, samples, observations and pixels
SMALL = {
    "ces_obs.full": {"n_feeds": 2, "n_bands": 2, "n_channels": 64,
                     "n_scans": 2, "scan_samples": 1000,
                     "vane_samples": 128, "window": 101, "nx": 8,
                     "ny": 8},
    "field32.joint": {"n_obs": 2, "n_feeds": 2, "raw_samples": 4000,
                      "nx": 16, "ny": 16},
}
