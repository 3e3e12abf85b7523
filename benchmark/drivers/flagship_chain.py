"""The flagship chain: one observation a unit through
``comapreduce_tpu_torch.flagship.run_flagship`` (vane -> per-feed
reduction -> pointing plan -> planned multi-RHS Jacobi CG), on raw
counts held resident on the card. Each observation builds its own
pointing plan, as a stream of observations, each with its own pointing,
does."""

from __future__ import annotations

import sys
import time

import torch

from benchmark import check
from benchmark.inputs import flagship as gen
from benchmark.reference import destriper as ref_destriper
from benchmark.reference import reduction as ref_reduction


def _checksums(feeds):
    return [float(x["tod"].sum(dtype=torch.float64))
            + float(x["vane_tod"].sum(dtype=torch.float64))
            for x in feeds]


class Driver:
    unit = "observation"

    def __init__(self, sizes: dict, traffic: dict, seed: int, device):
        from comapreduce_tpu_torch import flagship

        self.sizes, self.device = sizes, torch.device(device)
        z = sizes
        self.n_samples = gen.n_samples(z)
        self.shape = flagship.FlagshipShape(
            z["n_feeds"], z["n_bands"], z["n_channels"], z["scan_samples"],
            z["n_scans"], z["window"], z["nx"], z["ny"], z["vane_samples"],
            # how many scans the program reduces at once is the
            # program's choice: take its production preset's
            flagship.FULL.scan_batch, gap=z["gap"],
            offset_length=z["offset_length"], n_iter=z["n_iter"],
            threshold=z["threshold"])
        t0 = time.perf_counter()
        self.edges, self.scan_mask, self.freq, self.pixels = gen.geometry(
            z, seed, traffic["flag_fraction"])
        t1 = time.perf_counter()
        self.feeds = gen.make_feeds(z, seed, self.device)
        self._sums = _checksums(self.feeds)
        t2 = time.perf_counter()
        feeds = self.feeds
        self.inputs = flagship.FlagshipInputs(
            self.shape, self.edges, self.scan_mask, self.freq, self.pixels,
            lambda f, dev: feeds[f])
        self._run = flagship.run_flagship
        self.step()                                     # warm-up
        self.timings = {"geometry_s": t1 - t0, "inputs_s": t2 - t1,
                        "warm_unit_s": time.perf_counter() - t2}

    def step(self) -> dict:
        out = self._run(self.inputs, device=self.device)
        res = out["result"]
        return {"reduce_s": out["reduce_s"], "plan_s": out["plan_s"],
                "destripe_s": out["destripe_s"],
                "band_tod": out["band_tod"], "band_w": out["band_w"],
                "offsets": res.offsets, "map": res.destriped_map,
                "naive": res.naive_map,
                "n_iter": int(res.n_iter)}

    def end_to_end(self, records, window_s: float) -> dict:
        z = self.sizes
        samples = z["n_feeds"] * z["n_bands"] * z["n_channels"] \
            * self.n_samples
        return {"tod_samples_per_sec": samples * len(records) / window_s}

    def release(self) -> None:
        self.inputs = None

    def reference(self, prec: str) -> dict:
        """The whole observation through the plain reference."""
        z = self.sizes
        F, B, T = z["n_feeds"], z["n_bands"], self.n_samples
        dev = self.device
        mask = torch.as_tensor(self.scan_mask, device=dev)
        freq = torch.as_tensor(self.freq, device=dev)
        L = _block_length(self.edges)
        tods, weis = [], []
        for f in range(F):
            x = self.feeds[f]
            tsys, gain = ref_reduction.vane(x["vane_tod"], gen.VANE_LOAD_K,
                                            prec)
            t, w = ref_reduction.reduce_feed(
                x["tod"], mask, x["airmass"], freq, tsys, gain, self.edges,
                L, z, prec)
            tods.append(t)
            weis.append(w)
        n_pad = self.pixels.size - F * T
        band_tod = torch.stack(tods, 1).reshape(B, F * T)
        band_w = torch.stack(weis, 1).reshape(B, F * T)
        pad = torch.zeros((B, n_pad), dtype=band_tod.dtype, device=dev)
        band_tod = torch.cat([band_tod, pad], 1)
        band_w = torch.cat([band_w, pad], 1)
        ds = ref_destriper.destripe(
            band_tod, band_w, torch.as_tensor(self.pixels, device=dev),
            z["nx"] * z["ny"], z["offset_length"], z["n_iter"],
            z["threshold"], prec)
        ds.update(band_tod=band_tod, band_w=band_w)
        return ds

    def compare(self, records, prec: str = "f64") -> list[dict]:
        ref = self.reference(prec)
        changed = sum(a != b for a, b in zip(self._sums,
                                             _checksums(self.feeds)))
        hits = ref["hits"]
        r_map = check.hit_map_values(ref["map"], hits)
        r_naive = torch.as_tensor(ref["naive"])[..., hits > 0]
        r_off = check.centred(ref["offsets"])
        out = []
        for rec in records:
            out.append({
                "band_tod": check.rel_gap(rec["band_tod"], ref["band_tod"]),
                "band_w": check.rel_gap(rec["band_w"], ref["band_w"]),
                "offsets": check.rel_gap(check.centred(rec["offsets"]),
                                         r_off),
                "map": check.rel_gap(check.hit_map_values(rec["map"], hits),
                                     r_map),
                "naive": check.rel_gap(
                    torch.as_tensor(rec["naive"])[..., hits > 0], r_naive)})
        print(f"inputs unchanged by the window: {changed == 0} "
              f"({changed} of {len(self._sums)} feeds' checksums moved)",
              file=sys.stderr)
        return out


def _block_length(edges, pad_to: int = 128) -> int:
    """The chain's scan block: the longest scan rounded up to 128
    samples (its padding is part of the median filter's definition)."""
    longest = int((edges[:, 1] - edges[:, 0]).max())
    return -(-longest // pad_to) * pad_to
