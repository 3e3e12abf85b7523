"""Plain references: straightforward PyTorch from the published
equations, with no kernel, plan or cache. They import nothing of the
program under test and take nothing it made: every input comes from the
benchmark's own generators.

Each reference takes a ``prec``: ``"f64"`` computes in float64 (the
reference proper); ``"bf16"`` computes in float32 but rounds every array
it stores (inputs, each stage's output, the solver's vectors) to
bfloat16 — the control, the lower-precision path a later change could
be tempted to take.
"""

import torch


def precision(prec: str):
    """``(dtype, q)``: the compute dtype and the storage rounding."""
    if prec == "f64":
        return torch.float64, (lambda x: x)
    if prec == "bf16":
        return torch.float32, (lambda x: x.to(torch.bfloat16).to(
            torch.float32))
    raise ValueError(f"prec must be 'f64' or 'bf16', got {prec!r}")
