"""How f32 rounding moves the polarized destriper, on the CPU, in the
port (``comapreduce_tpu_torch/mapmaking/polarization.py``) and the
reference (``comapreduce_tpu/mapmaking/polarization.py``); the numbers
behind the tolerances of ``tests/test_torch_polarization.py`` and of
``chip_smoke.POL_ATOL``::

    JAX_PLATFORMS=cpu python tests/torch_pol_spread.py

Prints one JSON object:

- ``hard``: the reference test's hard problem
  (``tests/test_polarization.py:140``, 300 iterations): ``[landing
  residual, iterations]`` on its TOD and on six TODs perturbed by 1e-6
  normal noise (seeds 100-105), for the reference and for the port
  under each of :data:`CANDIDATES` (each a change of the port's 3 x 3 /
  Jacobi arithmetic or of its sums, made here by replacing module
  functions; ``port`` is the port as it is);
- ``jacobi``: the largest gap between the packages' floored Jacobi
  numerators ``diag - off_sum(quad)`` there, over ``sum w``;
- ``small``: phase N.1's FIELD_SMALL problem, the port's planned solve
  against itself with its K3 sums rounded once from f64, at 40, 60 and
  100 iterations (offsets, destriped and naive maps);
- ``det``: on the graded angle-diversity pixels of the mask test, the
  largest gap between the packages' normalised determinants among the
  pixels within 25% of the 1e-6 threshold, and how many lie there.

Measured (on the CPU; residual ranges over the seven TODs, 300
iterations each unless said): the reference 0.94e-3 to 2.75e-3; the
port 1.80e-4 to 2.07e-4. With f32 3 x 3 arithmetic (``f32_3x3``, the
reference's and the port's until it held its inverses in f64) 1.97e-3
to 5.83e-3 (5.008e-3 on the TOD). That is the cause: the f32 inverse of
a near-singular block, stored or applied. An f64 inverse of the
f32-regularised block stored in f32 (the first probe of the fault)
lands at 1.9e-4 to 0.133 and stops early (298, 290, 294 iterations) on
three TODs; of the f64-regularised one, 0.47e-3 to 1.94e-3; stored in
f32 and applied in f64, 0.84e-3 to 1.24e-3; held in f64 either way,
1.7e-4 to 2.2e-4. The f64 numerator (1.93e-3 to 5.91e-3) and a mask
from the f64 determinant (unchanged bits) move nothing; f64 K3 sums
move the f32 arithmetic to 0.59e-3 to 2.2e-3 and the port not at all
(1.86e-4 to 2.22e-4). At FIELD_SMALL, rounding the K3 sums once from f64
moves the port's offsets 1.9e-4 at 40 iterations and 6.2e-6 at 60 and
100, its destriped maps 5.3e-4 and 1.6e-4, its naive maps 2.5e-4.
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
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_plan  # noqa: E402
from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL,  # noqa: E402
                                            OFFSET_LENGTH, field_geometry)
from comapreduce_tpu_torch.mapmaking.pointing_plan import \
    build_pointing_plan  # noqa: E402
from test_torch_polarization import (HARD_SEEDS,  # noqa: E402
                                     _graded_diversity, f32_prefactor,
                                     hard_problem)

F64_SUMS = [False]


def _k3(values, *args, **kw):
    """The port's K3 plain version, its sums rounded once from f64 when
    ``F64_SUMS[0]``."""
    if F64_SUMS[0]:
        return _PLAIN(values.double(), *args, **kw).to(values.dtype)
    return _PLAIN(values, *args, **kw)


_PLAIN = pol.binned_window_sum
pol.binned_window_sum = _k3
PORT = {k: getattr(pol, k) for k in ("_masked_inverse", "_pair_quadratic",
                                     "_jacobi_inverse",
                                     "_ata_scale_solvable")}


def _f64_stored_f32(ata, scale, rcond_ok):
    """The f64 inverse rounded to f32 (then applied in f32)."""
    return PORT["_masked_inverse"](ata, scale, rcond_ok).float()


def _f64_stored_f32_applied_f64(ata, scale, rcond_ok):
    """The f64 inverse rounded to f32, applied in f64."""
    return _f64_stored_f32(ata, scale, rcond_ok).double()


def _f64_inverse_of_f32_tikhonov(ata, scale, rcond_ok):
    """The f32-regularised block (the reference's ``_tikhonov``), inverted
    and held in f64."""
    inv = torch.linalg.inv(pol._tikhonov(ata, scale).double())
    return torch.where(rcond_ok[:, None, None], inv,
                       torch.zeros((), dtype=inv.dtype))


def _f64_inverse_of_f32_tikhonov_stored_f32(ata, scale, rcond_ok):
    """The same rounded to f32 (then applied in f32)."""
    return _f64_inverse_of_f32_tikhonov(ata, scale, rcond_ok).float()


def _f64_quadratic(inv_a_off, pws_off):
    """Each pair's quadratic in f64, not rounded: its offset sums (the
    plain K3) and the numerator stay f64 until ``_jacobi_inverse``."""
    pws = pws_off.double()
    return torch.einsum("pij,ip,jp->p", inv_a_off.double(), pws, pws)


def _f32_jacobi(num, diag, floor):
    return PORT["_jacobi_inverse"](num.float(), diag.float(), floor=floor)


def _f64_det_mask(ata, hits):
    """The solvable mask from the f64 determinant of the f32 ``A_p``."""
    scale = pol._ata_scale(ata)
    det_n = torch.linalg.det(ata.double() / scale.double()[:, None, None])
    return scale, (hits >= 3) & (det_n > 1e-6)


#: candidate -> (module functions replaced, K3 sums rounded from f64)
CANDIDATES = {
    "port": ({}, False),
    "port_f64_sums": ({}, True),
    "f32_3x3": ({"_masked_inverse": f32_prefactor}, False),
    "f32_3x3_f64_sums": ({"_masked_inverse": f32_prefactor}, True),
    "f32_3x3_f64_numerator": ({"_masked_inverse": f32_prefactor,
                               "_pair_quadratic": _f64_quadratic,
                               "_jacobi_inverse": _f32_jacobi}, False),
    "f32_3x3_f64_det_mask": ({"_masked_inverse": f32_prefactor,
                              "_ata_scale_solvable": _f64_det_mask}, False),
    "f64_inverse_stored_f32": ({"_masked_inverse": _f64_stored_f32},
                               False),
    "f64_inverse_stored_f32_applied_f64": (
        {"_masked_inverse": _f64_stored_f32_applied_f64}, False),
    "f64_inverse_of_f32_tikhonov": (
        {"_masked_inverse": _f64_inverse_of_f32_tikhonov}, False),
    "f64_inverse_of_f32_tikhonov_stored_f32": (
        {"_masked_inverse": _f64_inverse_of_f32_tikhonov_stored_f32},
        False),
}


def hard_spread() -> dict:
    """``{"ref" | candidate: [[residual, iterations], ...]}`` over
    :data:`HARD_SEEDS`."""
    tod, w, psi, pix, npix, L = hard_problem()
    plan, rplan = build_pointing_plan(pix, npix, L), ref_plan(pix, npix, L)
    out = {"ref": []}
    for s in HARD_SEEDS:
        t = hard_problem(s)[0]
        r = ref_pol.destripe_pol_planned(
            jnp.asarray(t), jnp.asarray(w), jnp.asarray(psi), rplan,
            n_iter=300)
        out["ref"].append([float(r.residual), int(r.n_iter)])
    for name, (patch, f64) in CANDIDATES.items():
        for k, fn in dict(PORT, **patch).items():
            setattr(pol, k, fn)
        F64_SUMS[0] = f64
        try:
            out[name] = []
            for s in HARD_SEEDS:
                r = pol.destripe_pol_planned(hard_problem(s)[0], w, psi,
                                             plan, n_iter=300, device="cpu")
                out[name].append([float(r.residual), int(r.n_iter)])
        finally:
            F64_SUMS[0] = False
            for k, fn in PORT.items():
                setattr(pol, k, fn)
    return out


def main() -> int:
    hard = hard_spread()
    tod, w, psi, pix, npix, L = hard_problem()
    plan, rplan = build_pointing_plan(pix, npix, L), ref_plan(pix, npix, L)
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
    pol._jacobi_inverse = PORT["_jacobi_inverse"]
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
