"""A field's bands through the map-maker's joint route: one unit is
``comapreduce_tpu_torch.cli.run_destriper.solve_bands_joint`` over every
band, from the host numpy band data the Level-2 reader hands over to the
maps returned on the host (one multi-RHS planned CG)."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check
from benchmark.inputs import field as gen
from benchmark.reference import destriper as ref_destriper


class Driver:
    unit = "solve"

    def __init__(self, sizes: dict, traffic: dict, seed: int, device):
        from comapreduce_tpu_torch.cli.run_destriper import \
            solve_bands_joint
        from comapreduce_tpu_torch.mapmaking.leveldata import DestriperData

        self.sizes, self.traffic = sizes, traffic
        self.device = torch.device(device)
        z = sizes
        self.npix = z["nx"] * z["ny"]
        t0 = time.perf_counter()
        pix, gid, az = gen.geometry(z, self.device)
        t1 = time.perf_counter()
        self.pixels = pix
        dev = self.device
        pix_d = torch.as_tensor(pix, device=dev).to(torch.int64)
        gid_d = torch.as_tensor(gid, device=dev).to(torch.int64)
        az_d = torch.as_tensor(az, device=dev)
        self.bands = list(traffic["bands"])
        self.datas = []
        for b in self.bands:
            tod, w = gen.make_band(z, traffic["model"], pix_d, gid_d, az_d,
                                   seed, b)
            self.datas.append(DestriperData(
                tod=tod.cpu().numpy(), pixels=pix, weights=w.cpu().numpy(),
                ground_ids=gid, az=az, n_groups=z["n_obs"] * z["n_feeds"],
                npix=self.npix))
            del tod, w
        del pix_d, gid_d, az_d
        self._solve = solve_bands_joint
        t2 = time.perf_counter()
        self.step()                                     # warm-up
        self.timings = {"geometry_s": t1 - t0, "inputs_s": t2 - t1,
                        "warm_unit_s": time.perf_counter() - t2}

    def step(self) -> dict:
        z = self.sizes
        res = self._solve(self.datas, self.bands,
                          offset_length=z["offset_length"],
                          n_iter=z["n_iter"], threshold=z["threshold"],
                          precond=self.traffic["precond"],
                          device=self.device)
        if res is None:
            raise RuntimeError("solve_bands_joint refused the bands: "
                               "they share one pointing")
        return {"offsets": torch.stack([r.offsets for r in res]),
                "map": np.stack([np.asarray(r.destriped_map) for r in res]),
                "naive": np.stack([np.asarray(r.naive_map) for r in res]),
                "n_iter": int(res[0].n_iter)}

    def end_to_end(self, records, window_s: float) -> dict:
        return {"field_solve_s": window_s / len(records)}

    def release(self) -> None:
        # the plan lives in the entry's memo (keyed on the pixels), not
        # in anything this driver holds
        from comapreduce_tpu_torch.cli import run_destriper
        run_destriper._PLAN_MEMO.clear()

    def reference(self, prec: str) -> dict:
        z = self.sizes
        dev = self.device
        n = (self.pixels.size // z["offset_length"]) * z["offset_length"]
        tod = torch.stack([torch.as_tensor(d.tod[:n], device=dev)
                           for d in self.datas])
        w = torch.stack([torch.as_tensor(d.weights[:n], device=dev)
                         for d in self.datas])
        pix = torch.as_tensor(self.pixels[:n], device=dev).to(torch.int64)
        return ref_destriper.destripe(tod, w, pix, self.npix,
                                      z["offset_length"], z["n_iter"],
                                      z["threshold"], prec)

    def compare(self, records, prec: str = "f64") -> list[dict]:
        ref = self.reference(prec)
        hits = ref["hits"]
        r_map = check.hit_map_values(ref["map"], hits)
        r_naive = ref["naive"][..., hits > 0]
        r_off = check.centred(ref["offsets"])
        hits_c = hits.cpu()
        out = []
        for rec in records:
            out.append({
                "offsets": check.rel_gap(check.centred(rec["offsets"]),
                                         r_off),
                "map": check.rel_gap(check.hit_map_values(
                    torch.as_tensor(rec["map"]), hits_c), r_map.cpu()),
                "naive": check.rel_gap(
                    torch.as_tensor(rec["naive"])[..., hits_c > 0],
                    r_naive.cpu())})
        return out
