"""How far f32 rounding moves the polarized destriper, on the CPU, in the
port (``comapreduce_tpu_torch/mapmaking/polarization.py``) and the
reference (``comapreduce_tpu/mapmaking/polarization.py``); the numbers
behind the tolerances of ``tests/test_torch_polarization.py`` and of
``chip_smoke.POL_ATOL``::

    JAX_PLATFORMS=cpu python tests/torch_pol_spread.py

Prints one JSON object:

- ``hard``: the reference test's hard problem
  (``tests/test_polarization.py:140``, 300 iterations) landing residual
  in each package on its TOD and on six TODs perturbed by 1e-6 normal
  noise, the port also with its pair sums rounded once from f64;
- ``jacobi``: the largest gap between the packages' floored Jacobi
  numerators ``diag - off_sum(quad)`` there, over ``sum w``;
- ``small``: phase N.1's FIELD_SMALL problem, the port's planned solve
  against itself with its K3 sums rounded once from f64, at 40, 60 and
  100 iterations (offsets, destriped and naive maps);
- ``det``: on the graded angle-diversity pixels of the mask test, the
  largest gap between the packages' normalised determinants among the
  pixels within 25% of the 1e-6 threshold, and how many lie there.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import comapreduce_tpu.mapmaking.polarization as ref_pol  # noqa: E402
import comapreduce_tpu_torch.mapmaking.polarization as pol  # noqa: E402
from bench import ces_pixels  # noqa: E402
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_plan  # noqa: E402
from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL,  # noqa: E402
                                            OFFSET_LENGTH, field_geometry)
from comapreduce_tpu_torch.mapmaking.pointing_plan import \
    build_pointing_plan  # noqa: E402
from test_torch_polarization import _graded_diversity  # noqa: E402

F64_SUMS = [False]


def _k3(values, *args, **kw):
    """The port's K3 plain version, its sums rounded once from f64 when
    ``F64_SUMS[0]``."""
    if F64_SUMS[0]:
        return _PLAIN(values.double(), *args, **kw).float()
    return _PLAIN(values, *args, **kw)


_PLAIN = pol.binned_window_sum
pol.binned_window_sum = _k3


def hard_problem():
    F, T, nx, L = 2, 10_000, 64, 50
    rng = np.random.default_rng(0)
    pix = np.concatenate([ces_pixels(T, nx, nx, f, F) for f in range(F)])
    n = (pix.size // L) * L
    pix = pix[:n]
    toff = np.cumsum(rng.normal(0, 0.3, n // L)).astype(np.float32)
    I = rng.normal(0, 1.0, nx * nx)
    psi = (np.linspace(0, 40 * np.pi, n)
           + rng.normal(0, 0.2, n)).astype(np.float32)
    tod = (I[pix] + np.repeat(toff, L)
           + rng.normal(0, 1.0, n)).astype(np.float32)
    return tod, np.ones(n, np.float32), psi, pix, nx * nx, L


def main() -> int:
    tod, w, psi, pix, npix, L = hard_problem()
    plan, rplan = build_pointing_plan(pix, npix, L), ref_plan(pix, npix, L)
    hard = {"ref": [], "port": [], "port_f64_pair_sums": []}
    for s in [None] + list(range(100, 106)):
        t = tod if s is None else tod + np.random.default_rng(s).normal(
            0, 1e-6, tod.size).astype(np.float32)
        hard["ref"].append(float(ref_pol.destripe_pol_planned(
            jnp.asarray(t), jnp.asarray(w), jnp.asarray(psi), rplan,
            n_iter=300).residual))
        for key, f64 in (("port", False), ("port_f64_pair_sums", True)):
            F64_SUMS[0] = f64
            hard[key].append(float(pol.destripe_pol_planned(
                t, w, psi, plan, n_iter=300, device="cpu").residual))
        F64_SUMS[0] = False

    seen = {}
    for name, mod in (("port", pol), ("ref", ref_pol)):
        real = mod._jacobi_inverse

        def spy(a, d, floor, name=name, real=real):
            seen[name] = (np.asarray(a), np.asarray(d))
            return real(a, d, floor=floor)

        mod._jacobi_inverse = spy
    pol.destripe_pol_planned(tod, w, psi, plan, n_iter=1, device="cpu")
    ref_pol.destripe_pol_planned(jnp.asarray(tod), jnp.asarray(w),
                                 jnp.asarray(psi), rplan, n_iter=1)
    jacobi = float(np.max(np.abs(seen["port"][0] - seen["ref"][0])
                          / seen["ref"][1]))

    spix = field_geometry(FIELD_SMALL)[0]
    snpix = FIELD_SMALL.nx * FIELD_SMALL.ny
    d = chip_smoke.pol_band(spix, snpix, FIELD_SMALL.n_groups, 11)
    splan = build_pointing_plan(spix, snpix, OFFSET_LENGTH)
    small = {}
    for it in (40, 60, 100):
        res = []
        for f64 in (False, True):
            F64_SUMS[0] = f64
            res.append(pol.destripe_pol_planned(
                d["tod"], d["weights"], d["psi"], splan, n_iter=it,
                device="cpu"))
        F64_SUMS[0] = False
        small[it] = {f: float((getattr(res[0], f) - getattr(res[1], f))
                              .abs().max())
                     for f in ("offsets", "iqu_destriped", "iqu_naive")}

    gpix, gpsi, gw, gnpix = _graded_diversity()
    c2, s2 = np.cos(2 * gpsi), np.sin(2 * gpsi)
    want = ref_pol._pol_accumulate(jnp.asarray(gpix), jnp.asarray(gw),
                                   jnp.asarray(c2), jnp.asarray(s2), gnpix,
                                   None)
    ata = np.asarray(want.ata)
    scale = np.maximum(np.trace(ata, axis1=-2, axis2=-1) / 3.0, 1e-30)
    det_ref = np.asarray(jnp.linalg.det(jnp.asarray(
        ata / scale[:, None, None])))
    det_port = torch.linalg.det(torch.as_tensor(
        ata / scale[:, None, None])).numpy()
    near = np.abs(det_ref - 1e-6) <= 0.25e-6
    det = {"n_near": int(near.sum()),
           "max_gap_near": float(np.abs(det_port - det_ref)[near].max())}
    print(json.dumps({"hard": hard, "jacobi": jacobi, "small": small,
                      "det": det}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
