"""Compensated (float-float) dots for the CG recurrences (port of the
float-float half of ``comapreduce_tpu/ops/precision.py:207-309``).

Knuth's two-sum and the Dekker split / two-product carried through a
pairwise tree reduction: the dot2 algorithm of Ogita, Rump and Oishi
(2005), vectorised. Each value is an unevaluated ``(hi, lo)`` pair with
``|lo| <= ulp(hi) / 2``, about twice the f32 mantissa, so a dot of f32
vectors comes out with near-f64 accuracy without f64 arithmetic.

Every reference op is one PyTorch call here, evaluated eagerly, so no
compiler can reassociate the error terms or contract the Dekker split
``c - (c - a)`` into a fused multiply-add: each product and sum is
rounded to f32 on its own, which is what the error-free transformations
need. There is no fusion and no kernel: on the card each call is one
elementwise or slicing launch, and a dot of ``n`` elements takes about
ten of them for each of its ``ceil(log2 n)`` halvings.

``PrecisionPolicy`` and the bf16 TOD policy of the reference module are
not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["two_sum", "two_prod", "precise_sum", "precise_dot",
           "precise_norm"]


def two_sum(a, b):
    """Knuth's error-free sum: ``(s, err)`` with ``s = fl(a + b)`` and
    ``a + b = s + err`` exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    # Dekker split for binary32: C = 2^12 + 1 halves the 24-bit mantissa
    # into two 12-bit pieces whose products are exact in f32
    c = a * 4097.0
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker/Veltkamp error-free product: ``(p, err)`` with
    ``p = fl(a * b)`` and ``a * b = p + err`` exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _ff_add(xh, xl, yh, yl):
    # add two float-float values, renormalised so |lo| <= ulp(hi)/2
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    hi = s + e
    return hi, e - (hi - s)


def _ff_tree_sum(hi, lo):
    """Pairwise (log-depth) float-float sum over the LAST axis: pads to a
    power of two with exact zeros and halves repeatedly, vectorised over
    the leading axes (the multi-RHS band axis)."""
    n = hi.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        hi = F.pad(hi, (0, p - n))
        lo = F.pad(lo, (0, p - n))
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        hi, lo = _ff_add(hi[..., :h], lo[..., :h], hi[..., h:], lo[..., h:])
    return hi[..., 0], lo[..., 0]


def _last_axis(x, axis, name):
    if axis is None:
        return x.reshape(-1)
    if axis not in (-1, x.ndim - 1):
        raise ValueError(f"{name} supports axis=None|-1, got {axis}")
    return x


def precise_sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Compensated sum of ``x`` (f32 in, f32 out, ~f64 inside).
    ``axis=None`` sums everything; otherwise the axis must be the last."""
    x = _last_axis(torch.as_tensor(x, dtype=torch.float32), axis,
                   "precise_sum")
    hi, lo = _ff_tree_sum(x, torch.zeros_like(x))
    return hi + lo


def precise_dot(x: torch.Tensor, y: torch.Tensor, axis=None) -> torch.Tensor:
    """Compensated dot product (dot2, pairwise form): every elementwise
    product is split exactly (``two_prod``) and the (value, error) stream
    is tree-summed in float-float. ``axis=None`` contracts all axes (the
    scalar CG dots); ``axis=-1`` the last axis only, per leading index
    (the multi-RHS solver's per-band dots)."""
    x = _last_axis(torch.as_tensor(x, dtype=torch.float32), axis,
                   "precise_dot")
    y = _last_axis(torch.as_tensor(y, dtype=torch.float32), axis,
                   "precise_dot")
    p, e = two_prod(x, y)
    hi, lo = _ff_tree_sum(p, e)
    return hi + lo


def precise_norm(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Compensated squared norm: ``precise_dot(x, x)``."""
    return precise_dot(x, x, axis=axis)
