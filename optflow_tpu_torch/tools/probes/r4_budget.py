"""The headline solve's time budget on the card: where the 16 x 256x1024
solve's time goes. The port's counterpart of the portable rows of the root
probes ``tools/probes/r4_budget.py``, ``r4_warp_vs_iter.py``,
``r4_where_time.py`` and ``r4_dispatch_cost.py``.

    python -m optflow_tpu_torch.tools.probes.r4_budget [--device cuda]
        [--out FILE] [--quick]

The ``bench.solve`` inputs (16 pairs of 256x1024, ``solve_inputs``) through
``ops.tvl1.tvl1_flow_batched`` under five replacements of the reference
defaults (:data:`SOLVE_ROWS`): ``full``, ``full_eps0`` (no exit: every sweep
runs all its iterations), ``iterations_1``, ``warps_1`` and
``warps_1_iterations_1``; each row carries its counted pixel-iterations
(``bench/roofline.py: pyramid_work``). Then ``pyramid``, ``build_pyramid`` of
the stacked frames alone, and the cost of a launch: ``tick_pipelined`` (50
launches of one elementwise kernel, one synchronisation) and ``tick_synced``
(each launch synchronised), per launch. Every row is the median of ``REPS``
after a warm call, each started on an idle card: the solve and pyramid rows
give ``device_ms`` (CUDA events), ``wall_ms`` and ``enqueue_ms``
(``bench.timed``), the tick rows ``wall_ms`` (the host clock: the cost of a
launch is the host's). Derived: ``pyramid_share`` = pyramid / full and
``no_iteration_share`` = iterations_1 / full, the floor of sweeps, launches
and pyramid under the iterations.

Not ported, TPU-only: the canvas-group rows (``_group_fn``,
``_assign_canvases``, ``_select_geometry``: the port solves a level a launch,
at its own shape), the shift-warp row (the port has the exact gather warp
only) and ``OPTFLOW_TPU_SINGLETON_LEVELS`` (every level is its own launch).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from optflow_tpu_torch.bench import (
    device_label,
    elapsed_ms,
    emit,
    open_device,
    platform,
    roofline,
    sync,
    timed,
)
from optflow_tpu_torch.bench.solve import solve_inputs
from optflow_tpu_torch.bench.synth import BATCH, H, W
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from optflow_tpu_torch.ops.tvl1 import (
    get_last_iteration_stats,
    tvl1_flow_batched,
)

REPS = 3
TICKS = 50
# row -> its replacement of the reference defaults
SOLVE_ROWS = {
    "full": {},
    "full_eps0": {"epsilon": 0.0},
    "iterations_1": {"iterations": 1},
    "warps_1": {"warps": 1},
    "warps_1_iterations_1": {"warps": 1, "iterations": 1},
}


def row_params(base: TVL1Params, row: str) -> TVL1Params:
    return dataclasses.replace(base, **SOLVE_ROWS[row])


def tick_rows(dev: torch.device) -> dict:
    """Milliseconds a launch of one elementwise kernel on a 256x1024 plane
    takes the host: pipelined (``TICKS`` launches, one synchronisation) and
    synchronised after each (the median launch)."""
    x = torch.ones((256, 1024), device=dev)

    def pipelined():
        z = x
        for _ in range(TICKS):
            z = z.mul(1.0001)
        return z

    _, t = timed(dev, pipelined, REPS)
    synced = []
    for _ in range(TICKS):
        sync(dev)
        t0 = time.perf_counter()
        x.mul(1.0001)
        sync(dev)
        synced.append((time.perf_counter() - t0) * 1e3)
    return {"tick_pipelined": {"wall_ms": t["wall_ms"] / TICKS},
            "tick_synced": {"wall_ms": statistics.median(synced)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the line to this file")
    ap.add_argument("--quick", action="store_true",
                    help="2 pairs of 48x128 at 3 scales, one timed call a "
                         "row: a check of the probe, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    batch, h, w, base, reps = BATCH, H, W, TVL1Params(), REPS
    if ns.quick:
        batch, h, w, base, reps = 2, 48, 128, TVL1Params(nscales=3), 1
    i0_np, i1_np = solve_inputs(batch, h, w)
    i0 = torch.from_numpy(i0_np).to(dev)
    i1 = torch.from_numpy(i1_np).to(dev)

    rows = {}
    for name in SOLVE_ROWS:
        p = row_params(base, name)
        _, t = timed(dev, lambda p=p: tvl1_flow_batched(i0, i1, p), reps)
        stats = get_last_iteration_stats()
        rows[name] = {**t, "px_iterations": roofline.pyramid_work(
                          stats, p.warps).px_iterations,
                      "iters_per_level": [it.tolist() for _, it in stats],
                      "params": SOLVE_ROWS[name]}
    shapes = pyramid_shapes(h, w, base.nscales, base.scale_step)
    stacked = torch.cat([i0, i1], dim=0)
    _, t = timed(dev, lambda: build_pyramid(stacked, shapes), reps)
    rows["pyramid"] = t
    rows.update(tick_rows(dev))

    full = elapsed_ms(rows["full"])
    emit({
        "probe": "r4_budget",
        "platform": platform(dev),
        "device": device_label(dev),
        "shape": [batch, h, w],
        "full_mp_pairs_per_s": batch * h * w / 1e6 / (full / 1e3),
        "pyramid_share": elapsed_ms(rows["pyramid"]) / full,
        "no_iteration_share": elapsed_ms(rows["iterations_1"]) / full,
        "rows": rows,
    }, ns.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
