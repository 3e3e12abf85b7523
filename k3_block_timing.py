#!/usr/bin/env python3
"""Where a block of K3's one-pass body spends its time, on the card.

Builds a copy of ``comapreduce_tpu_torch/csrc/binned_window_sum.cu``
with four ``%globaltimer`` stamps a block (thread 0: at its start, once
its ids have arrived, after the first barrier of its scan, at its end),
launches it once after an L2 flush at the planned destriper's three K3
sites of the full flagship plan (R = 4 and R = 1) and of the full field
plan (R = 1), and reports per site: the kernel's span from the first
block's start to the last block's end, how far apart the blocks start,
a block's median life and its median phases (load: start to ids
arrived; scan: to the first barrier; rest: the other band groups, the
writes, the read-ahead), beside ``chip_smoke.cuda_ms`` of the unstamped
kernel through ``binned_window_sum(..., ids_sorted=True)``. The stamps
add a few instructions a block, so read the phases, not the span, as
the stamped kernel's.

Run from the root of a checkout on a machine with a card:

    python3 k3_block_timing.py

The lines go to standard output and ``chiprun_out/k3_block_timing.json``.
Without a card it exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "comapreduce_tpu_torch", "csrc",
                   "binned_window_sum.cu")

PRELUDE = """__device__ unsigned long long* bw_dbg;
__device__ __forceinline__ unsigned long long bw_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int cr_bw_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(bw_dbg, &p, sizeof(p));
}
"""

# (anchor in the source, text inserted after it); each anchor occurs once
STAMPS = [
    ("  __shared__ BwShared<NB> sh;\n  BwTileIn<NB> in;\n",
     "  if (threadIdx.x == 0) bw_dbg[blockIdx.x * 4] = bw_now();\n"),
    ('  assert(up && "binned_window_sum: ids_sorted=True but the ids '
     'descend");\n',
     "  if (threadIdx.x == 0) bw_dbg[blockIdx.x * 4 + 1] = bw_now();\n"),
    ("      sh.tile_tail[q] = a;\n    }\n    __syncthreads();\n",
     "    if (threadIdx.x == 0 && r0 == 0)\n"
     "      bw_dbg[blockIdx.x * 4 + 2] = bw_now();\n"),
    ("  bw_tile<NB>(in, blockIdx.x, sh, values, ids, base, out, M, R, "
     "window,\n              chunk, out_size, vec);\n",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) bw_dbg[blockIdx.x * 4 + 3] = bw_now();\n"),
]


def stamped_source(src: str) -> str:
    """The kernel source with the four stamps (raises if an anchor moved)."""
    anchor = "template <int NB>\nstruct BwTileIn"
    if src.count(anchor) != 1:
        raise SystemExit("k3_block_timing: the kernel source changed; "
                         "update its anchors")
    src = src.replace(anchor, PRELUDE + anchor)
    for at, add in STAMPS:
        if src.count(at) != 1:
            raise SystemExit(f"k3_block_timing: anchor not found once: "
                             f"{at.strip()[:60]}")
        src = src.replace(at, at + add)
    return src


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_block_timing: torch sees no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from comapreduce_tpu_torch import _build
    from comapreduce_tpu_torch.fieldrun import (FIELD_FULL, OFFSET_LENGTH,
                                                field_geometry)
    from comapreduce_tpu_torch.flagship import FULL, observation_geometry
    from comapreduce_tpu_torch.mapmaking.cuda_binning import \
        binned_window_sum
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    out_dir = os.path.join(ROOT, "build", "k3_block_timing")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "stamped.cu")
    with open(SRC) as fh, open(cu, "w") as out:
        out.write(stamped_source(fh.read()))
    lib_path = os.path.join(out_dir, "libstamped.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                        os.path.dirname(SRC), "-o", lib_path, cu],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    fn = lib.cr_binned_window_sum_sorted
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.cr_bw_set_stamps.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    card = cs.smi_line()
    plans = {
        "flagship": build_pointing_plan(observation_geometry(FULL)[3],
                                        FULL.nx * FULL.ny,
                                        FULL.offset_length),
        "field": build_pointing_plan(field_geometry(FIELD_FULL)[0],
                                     FIELD_FULL.nx * FIELD_FULL.ny,
                                     OFFSET_LENGTH),
    }
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device=dev)
    lines = []
    for name, R in (("flagship", 4), ("flagship", 1), ("field", 1)):
        for site, (ids, base, window, chunk, out_size, M) in \
                cs._k3_layouts(plans[name], dev).items():
            vals = torch.randn((R, M), generator=g, device=dev)
            out = torch.empty((R, out_size), device=dev)
            n_tiles = -(-M // 2048)
            stamps = torch.zeros(n_tiles * 4, dtype=torch.int64, device=dev)
            if lib.cr_bw_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
                raise SystemExit("k3_block_timing: cannot set the stamps")
            args = (vals, ids, base, window, chunk, out_size)
            ms = cs.cuda_ms(lambda: binned_window_sum(*args,
                                                      ids_sorted=True),
                            reps=20)
            flush.zero_()
            torch.cuda.synchronize()
            rc = fn(vals.data_ptr(), ids.data_ptr(), base.data_ptr(),
                    out.data_ptr(), M, R, window, chunk, out_size, 1,
                    torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            _build.check(rc, "stamped binned_window_sum")
            want = binned_window_sum(*args, ids_sorted=True)
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"{name} {site}: the stamped kernel's bits "
                                 "differ from the kernel's")
            d = stamps.view(n_tiles, 4).cpu().numpy().astype(np.float64)
            t0 = d[:, 0].min()
            life = d[:, 3] - d[:, 0]
            line = {"plan": name, "site": site, "R": R, "M": M,
                    "tiles": n_tiles, "ms": ms,
                    "span_us": (d[:, 3].max() - t0) / 1e3,
                    "start_spread_us": (d[:, 0].max() - t0) / 1e3,
                    "life_us_median": float(np.median(life)) / 1e3,
                    "life_us_max": float(life.max()) / 1e3,
                    "load_us_median":
                        float(np.median(d[:, 1] - d[:, 0])) / 1e3,
                    "scan_us_median":
                        float(np.median(d[:, 2] - d[:, 1])) / 1e3,
                    "rest_us_median":
                        float(np.median(d[:, 3] - d[:, 2])) / 1e3,
                    "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k3_block_timing.json"),
              "w") as fh:
        json.dump(lines, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
