"""Spike detection: median-filter high-pass and a thresholded, dilated
mask (port of ``comapreduce_tpu/ops/spikes.py``).

The TOD is high-passed with the exact rolling median (kernel K2 on a
CUDA tensor, its plain version on a CPU tensor), samples beyond
``threshold * auto_rms`` flag, and each flagged run widens by ±``pad``
samples: a max-pool over ``2 pad + 1`` samples, as the reference's
``reduce_window`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from comapreduce_tpu_torch.ops.median_filter import rolling_median
from comapreduce_tpu_torch.ops.stats import auto_rms

__all__ = ["dilate_mask", "spike_mask"]

DEFAULT_WINDOW = 501
DEFAULT_THRESHOLD = 10.0
DEFAULT_PAD = 100


def dilate_mask(mask: torch.Tensor, pad: int) -> torch.Tensor:
    """Dilate a boolean/0-1 mask by ±``pad`` samples along the last axis
    (``spikes.py:29``); returns a boolean mask for ``pad > 0``."""
    if pad <= 0:
        return mask
    flat = mask.to(torch.float32).reshape(-1, 1, mask.shape[-1])
    out = F.max_pool1d(flat, kernel_size=2 * pad + 1, stride=1, padding=pad)
    return (out > 0).reshape(mask.shape)


def spike_mask(tod: torch.Tensor, window: int = DEFAULT_WINDOW,
               threshold: float = DEFAULT_THRESHOLD, pad: int = DEFAULT_PAD,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean spike mask (True = spike) of ``tod`` f32[..., T]
    (``spikes.py:44``); ``valid`` f32[..., T] marks the samples that may
    flag. The rms is the adjacent-pair ``auto_rms`` of the high-passed
    stream, so slow drifts do not raise the threshold."""
    hp = tod - rolling_median(tod, window)
    rms = auto_rms(hp, valid).unsqueeze(-1)
    hits = hp.abs() > threshold * torch.clamp(rms, min=1e-30)
    if valid is not None:
        hits = hits & (valid > 0)
    return dilate_mask(hits, pad)
