"""The field deployment's joint solve (:mod:`benchmark.drivers.joint_solve`:
set-up, one ``solve_bands_joint`` a unit, the reference and the check,
all unchanged), reported as the Level-2 samples destriped a second."""

from __future__ import annotations

from benchmark.drivers import joint_solve


class Driver(joint_solve.Driver):

    def samples_a_solve(self) -> int:
        """nb * n: every band's samples in whole offsets."""
        L = self.sizes["offset_length"]
        return len(self.bands) * ((self.pixels.size // L) * L)

    def end_to_end(self, records, window_s: float) -> dict:
        return {"tod_samples_per_sec":
                self.samples_a_solve() * len(records) / window_s}
