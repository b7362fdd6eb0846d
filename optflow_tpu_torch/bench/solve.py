"""The headline solve on the card: megapixel image-pairs a second of the
coarse-to-fine TV-L1 solve at the reference defaults (tau .25, lambda .05,
theta .3; 10 scales, 5 warps, 300 iterations, epsilon .01, scale step .8:
src/optflow.cpp:503-512), with its EPE gates. The port's counterpart of the
root ``bench.py``.

    python -m optflow_tpu_torch.bench.solve [--device cuda] [--quick]

16 pairs of 256x1024 (:func:`synth.make_pair`, seeds 0-15, true flow
(2.0, -1.25)) go through ``ops.tvl1.tvl1_flow_batched``, on the card the
level kernel at every level. Gates: the mean EPE against the truth over the
interior (16 px margin) and pair 0's against the committed IPOL-oracle flow,
each <= 0.5 px. Latency is the median of 5 calls, each synchronised; the
steady state 5 calls enqueued back to back and one synchronisation, the
regime of a job that streams its groups. ``mfu`` is the share of the
card's float32 peak that the counted work (:mod:`.roofline`: the iterations
each level counted to its exit) takes in the steady-state time; ``bound``
says which bound, operations or bytes, sets the least time. A CPU run
reports no share (the peaks are the card's).

One JSON line, the keys of ``bench.py``'s, without
``shift_warp_fallback_sweeps`` (the port has no shift warp), with
``device`` (the card's name and power limit) and ``bound``. A failed gate
exits non-zero; nothing is retried.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from optflow_tpu_torch.bench import (
    device_label,
    emit,
    open_device,
    platform,
    roofline,
    sync,
)
from optflow_tpu_torch.bench.synth import (
    BATCH,
    DX,
    DY,
    H,
    W,
    make_pair,
    oracle_flow,
)
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops.tvl1 import (
    get_last_iteration_stats,
    tvl1_flow_batched,
)

REPS = 5
EPE_TARGET_PX = 0.5
MARGIN = 16


def solve_inputs(batch: int, h: int, w: int):
    """``(i0s, i1s)``, ``(batch, h, w)`` float32: make_pair seeds 0 ..
    batch - 1 with the true flow (DX, DY)."""
    pairs = [make_pair(h, w, DX, DY, seed=s) for s in range(batch)]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def interior_epe(flow: torch.Tensor, dx, dy, margin=MARGIN) -> torch.Tensor:
    """Mean end-point error of ``(..., H, W, 2)`` flows against the constant
    (dx, dy), ``margin`` px from every border; a scalar on flow's device."""
    inner = flow[..., margin:-margin, margin:-margin, :]
    return torch.hypot(inner[..., 0] - dx, inner[..., 1] - dy).mean()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="2 pairs of 48x128 at 3 scales, one timed call "
                         "each way: a check of the bench, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    batch, h, w, params, reps = BATCH, H, W, TVL1Params(), REPS
    if ns.quick:
        batch, h, w, params, reps = 2, 48, 128, TVL1Params(nscales=3), 1

    i0_np, i1_np = solve_inputs(batch, h, w)
    i0 = torch.from_numpy(i0_np).to(dev)
    i1 = torch.from_numpy(i1_np).to(dev)

    def solve_and_epe():
        flow = tvl1_flow_batched(i0, i1, params)
        return flow, interior_epe(flow, DX, DY)

    flow, epe = solve_and_epe()  # the first call, also the checked one
    epe = float(epe)
    epe_oracle = None
    if (h, w) == (H, W):  # the oracle's shape: pair 0 of this batch
        orc = torch.from_numpy(oracle_flow()).to(dev)
        epe_oracle = float(interior_epe(flow[0] - orc, 0.0, 0.0))

    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        solve_and_epe()
        sync(dev)
        times.append(time.perf_counter() - t0)
    dt_lat = statistics.median(times)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        solve_and_epe()
    sync(dev)
    dt = (time.perf_counter() - t0) / reps

    work = roofline.pyramid_work(get_last_iteration_stats(), params.warps)
    if dev.type == "cuda":
        _, bound = roofline.share(work, dt)
        mfu = work.flops / dt / roofline.PEAK_F32_FLOPS
    else:
        bound, mfu = roofline.bound_seconds(work)[1], None
    mp_pairs_per_s = batch * (h * w / 1e6) / dt
    rec = {
        "metric": "megapixel image-pairs/s per card (TV-L1, ref defaults)",
        "value": mp_pairs_per_s,
        "unit": "MP-pairs/s",
        "vs_baseline": mp_pairs_per_s / 1.0,
        "epe_px": epe,
        "epe_target_px": EPE_TARGET_PX,
        "epe_ok": epe <= EPE_TARGET_PX,
        "epe_vs_oracle_px": epe_oracle,
        "oracle_epe_ok": (None if epe_oracle is None
                          else epe_oracle <= EPE_TARGET_PX),
        "platform": platform(dev),
        "kernel": "cuda" if dev.type == "cuda" else "plain",
        "shape": [batch, h, w],
        "seconds_per_batch": dt,
        "latency_s_per_batch": dt_lat,
        "mfu": mfu,
        "gpx_iters_per_batch": work.px_iterations / 1e9,
        "device": device_label(dev),
        "bound": bound,
    }
    emit(rec)
    if not rec["epe_ok"] or rec["oracle_epe_ok"] is False:
        raise SystemExit(f"solve: EPE {epe} px (oracle {epe_oracle} px) "
                         f"above {EPE_TARGET_PX} px")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
