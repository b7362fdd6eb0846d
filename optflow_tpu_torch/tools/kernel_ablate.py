"""Kernel ablation experiment: where does the TV-L1 iteration's time go on
this card?

    python -m optflow_tpu_torch.tools.kernel_ablate \\
        [--n 16 --h 256 --w 1024 --lo 50 --hi 600 --device cuda]

Counterpart of the JAX package's ``tools_kernel_ablate.py``, with its six
variants under the same names. Each variant is the chunk kernel's iteration
with one class of cost compiled out (``ops/tvl1_ablate_cuda.py``):

  full     the production iteration
  no_err   the error sum and its reduction removed
  no_sqrt  the two dual-norm square roots replaced by the squared norm
  no_div   the five divisions replaced by multiplications
  no_roll  the eight neighbour reads replaced by the pixel itself
  min_body none of the four: the update arithmetic only

Per variant the tool times a call of ``lo`` and a call of ``hi`` fixed
iterations (CUDA events, median of 3 after a warm-up) and prints the slope
``(t_hi - t_lo) / (hi - lo)`` in microseconds per iteration, the pixel
iterations per second that makes, and both raw times. The slope cancels what
a call costs whatever its iteration count. It does NOT cancel the cost of a
launch here: a call makes one launch per 8 iterations, so launches grow with
the count, and the launches of both calls are printed beside the times.

Inputs come from ``numpy.random.default_rng(0)`` as the JAX tool makes them
(state scaled by 0.1). ``--device cpu`` runs the plain version: a check of
the tool at a small size, not a measurement.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from optflow_tpu_torch.ops.tvl1_ablate_cuda import (
    VARIANTS,
    launches_per_call,
    tvl1_ablate_chunks,
)


def card_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else ""


def make_inputs(n: int, h: int, w: int, device) -> tuple:
    """``(ro, state)`` as tools_kernel_ablate.py:204-208 makes them."""
    rng = np.random.default_rng(0)
    ro = rng.standard_normal((n, 3, h, w)).astype(np.float32)
    state = (rng.standard_normal((n, 6, h, w)) * 0.1).astype(np.float32)
    return (torch.from_numpy(ro).to(device),
            torch.from_numpy(state).to(device))


def time_m(ro, state, m: int, h: int, w: int, flags: Dict[str, bool],
           reps: int = 3) -> float:
    """Median seconds of ``reps`` calls with ``m`` iterations, after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    tvl1_ablate_chunks(ro, state, m, h, w, **flags)
    times = []
    if state.is_cuda:
        torch.cuda.synchronize(state.device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tvl1_ablate_chunks(ro, state, m, h, w, **flags)
            end.record()
            torch.cuda.synchronize(state.device)
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            tvl1_ablate_chunks(ro, state, m, h, w, **flags)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run_ablation(n: int = 16, h: int = 256, w: int = 1024, lo: int = 50,
                 hi: int = 600, device="cuda") -> List[dict]:
    """One record per variant: ``name``, ``t_lo_ms``, ``t_hi_ms``,
    ``slope_us_per_iter``, ``g_px_iter_per_s``, ``launches_lo``,
    ``launches_hi``."""
    if not lo < hi:
        raise ValueError(f"need lo < hi, got {lo} and {hi}")
    ro, state = make_inputs(n, h, w, torch.device(device))
    px = n * h * w
    rows = []
    for name, flags in VARIANTS.items():
        t_lo = time_m(ro, state, lo, h, w, flags)
        t_hi = time_m(ro, state, hi, h, w, flags)
        per_iter = (t_hi - t_lo) / (hi - lo)
        rows.append({
            "name": name, "t_lo_ms": t_lo * 1e3, "t_hi_ms": t_hi * 1e3,
            "slope_us_per_iter": per_iter * 1e6,
            "g_px_iter_per_s": px / per_iter / 1e9 if per_iter > 0 else None,
            "launches_lo": launches_per_call(lo),
            "launches_hi": launches_per_call(hi),
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Time the TV-L1 iteration with one cost class removed "
        "per variant (slope method).")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--lo", type=int, default=50)
    ap.add_argument("--hi", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    dev = torch.device(ns.device)
    if dev.type == "cuda":
        print("card:", card_name_and_limit())
        print("device:", torch.cuda.get_device_name(dev))
    else:
        print("device: cpu (plain version; no measurement of the kernel)")
    print(f"shape: ({ns.n}, {ns.h}, {ns.w})  lo={ns.lo} hi={ns.hi}")
    for r in run_ablation(ns.n, ns.h, ns.w, ns.lo, ns.hi, dev):
        rate = r["g_px_iter_per_s"]
        print(
            f"{r['name']:9s} t({ns.lo})={r['t_lo_ms']:8.3f}ms "
            f"t({ns.hi})={r['t_hi_ms']:8.3f}ms "
            f"slope={r['slope_us_per_iter']:8.3f}us/iter  "
            f"{rate if rate is not None else float('nan'):8.2f} G px-iter/s  "
            f"launches {r['launches_lo']}/{r['launches_hi']}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
