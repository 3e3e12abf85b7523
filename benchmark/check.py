"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and the plain reference, held against the limit the
cell's file gives it (``workloads/<cell>.json``, ``limits``)."""

from __future__ import annotations

import math

import torch


def rel_gap(prog, ref) -> float:
    """``|prog - ref| / |ref|`` in the 2-norm, in float64."""
    p = torch.as_tensor(prog).to(torch.float64)
    r = torch.as_tensor(ref).to(device=p.device, dtype=torch.float64)
    den = float(torch.linalg.vector_norm(r))
    num = float(torch.linalg.vector_norm(p - r))
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def centred(x, axis=-1):
    """``x`` less its mean along ``axis`` (a solve's null space: a
    constant traded between the offsets and the map)."""
    x = torch.as_tensor(x).to(torch.float64)
    return x - x.mean(dim=axis, keepdim=True)


def hit_map_values(m, hits):
    """Each band's map on its hit pixels, less its mean there: [R, H]."""
    m = torch.as_tensor(m).to(torch.float64)
    h = torch.as_tensor(hits).to(m.device) > 0
    return centred(m[..., h])


def judge(per_unit: list[dict], limits: dict):
    """``(numbers, failed)``: each number's largest reading over the
    units beside its limit, and how many units read above a limit. A
    number that is not finite, or has no limit, fails."""
    names = list(limits)
    numbers, failed = [], 0
    for unit in per_unit:
        if any(not (unit.get(n, math.inf) <= limits[n]) for n in names):
            failed += 1
    for n in names:
        vals = [u.get(n, math.inf) for u in per_unit] or [math.inf]
        numbers.append({"name": n, "value": max(vals),
                        "limit": limits[n]})
    return numbers, failed
