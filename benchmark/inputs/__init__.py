"""The benchmark's own input generators, made from ``--seed``."""

import numpy as np


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for one stream of ``seed`` (any whole
    number, large ones included), split by ``tags``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *map(int, tags)])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)
