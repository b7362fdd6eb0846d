"""Host<->device copies at a job's shapes on the card, and whether an upload
overlaps a solve. The port's counterpart of the root probe
``tools/probes/r5_transfer_cost.py``.

    python -m optflow_tpu_torch.tools.probes.r5_transfer_cost
        [--device cuda] [--out FILE] [--quick]

The probe's three shapes: an f32 16x256x1024 ROI stack, u8 16x512x1024
frames and f32 16x25x4 samples. For each, host to device and device to host,
from and to pageable memory and pinned memory (``h2d_pageable``,
``h2d_pinned``, ``d2h_pageable``, ``d2h_pinned``): ``device_ms`` by CUDA
events, ``wall_ms`` and ``enqueue_ms`` (``bench.timed``: the median of
``REPS`` after a warm copy, each started on an idle card) and ``gb_per_s``
on the card's time; every copy is read back and must equal its source bit
for bit. Then the root's last question, does an upload overlap a solve,
on the ``bench.solve`` inputs: ``solve`` and ``upload`` (the ROI stack from
pinned memory) alone, and ``streams``: the upload enqueued on a second
stream right after the solve, its start and end against the solve's end by
CUDA events (``upload_inside_solve``: it ended first, every time). The root
compared sums of times; on the card the upload is ~1 % of the solve, inside
the solve's own spread, so the events say it instead.

Off the card (``--device cpu``) a copy is a host copy and there is no pinned
memory or second stream: the pinned rows and ``streams`` are None. A copy that
differs from its source exits non-zero after the line.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from optflow_tpu_torch.bench import (
    device_label,
    elapsed_ms,
    emit,
    open_device,
    platform,
    timed,
)
from optflow_tpu_torch.bench.solve import solve_inputs
from optflow_tpu_torch.bench.synth import BATCH, H, W
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched

REPS = 3
# name -> (dtype, shape)
SHAPES = {
    "f32 16x256x1024 (ROI stack)": (torch.float32, (16, 256, 1024)),
    "u8 16x512x1024 (frames)": (torch.uint8, (16, 512, 1024)),
    "f32 16x25x4 (samples)": (torch.float32, (16, 25, 4)),
}
QUICK_SHAPES = {
    "f32 2x32x128": (torch.float32, (2, 32, 128)),
    "u8 2x64x128": (torch.uint8, (2, 64, 128)),
    "f32 2x25x4": (torch.float32, (2, 25, 4)),
}


def source(dtype, shape, seed=0) -> torch.Tensor:
    """A host tensor of random values, made from ``seed``."""
    rng = np.random.default_rng(seed)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def copy_rows(dev: torch.device, x: torch.Tensor, reps: int):
    """The four copies of ``x``: (rows, every copy equal to ``x``)."""
    cuda = dev.type == "cuda"
    on_dev = x.to(dev, copy=True)
    rows, equal = {}, True

    def row(name, fn):
        nonlocal equal
        out, t = timed(dev, fn, reps)
        ms = elapsed_ms(t)
        t["gb_per_s"] = x.nbytes / (ms / 1e3) / 1e9
        rows[name] = t
        equal = equal and torch.equal(out.cpu(), x)

    row("h2d_pageable", lambda: x.to(dev, copy=True))
    row("d2h_pageable", lambda: on_dev.to("cpu", copy=True))
    if cuda:
        pinned = x.pin_memory()
        host = torch.empty_like(x, pin_memory=True)
        row("h2d_pinned", lambda: pinned.to(dev, non_blocking=True))
        row("d2h_pinned", lambda: host.copy_(on_dev, non_blocking=True))
    else:
        rows["h2d_pinned"] = rows["d2h_pinned"] = None
    return rows, equal


def overlap_rows(dev: torch.device, params: TVL1Params, reps: int, batch,
                 h, w):
    """``solve`` and ``upload`` (the ROI stack from pinned memory) timed
    alone, and, on the card, where the upload runs when it is enqueued on a
    second stream right after the solve: the medians over ``reps`` calls
    (after a warm one) of the solve's end and the upload's start and end,
    ms after the solve's start by CUDA events, and whether every upload
    ended before its solve (``None`` off the card). Returns (rows, overlap,
    every upload equal to its source)."""
    cuda = dev.type == "cuda"
    i0, i1 = (torch.from_numpy(a).to(dev) for a in solve_inputs(batch, h, w))
    up = source(torch.float32, (batch, h, w), seed=1)
    if cuda:
        up = up.pin_memory()
    rows = {}
    _, rows["solve"] = timed(dev, lambda: tvl1_flow_batched(i0, i1, params),
                             reps)
    out, rows["upload"] = timed(
        dev, lambda: up.to(dev, non_blocking=cuda, copy=True), reps)
    equal = torch.equal(out.cpu(), up)
    if not cuda:
        return rows, None, equal
    side = torch.cuda.Stream(dev)
    spans = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize(dev)
        ev[0].record()
        tvl1_flow_batched(i0, i1, params)
        ev[1].record()
        with torch.cuda.stream(side):
            ev[2].record()
            out = up.to(dev, non_blocking=True)
            ev[3].record()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        spans.append([ev[0].elapsed_time(e) for e in ev[1:]])
        equal = equal and torch.equal(out.cpu(), up)
    spans = spans[1:]  # the first warms
    solve_end, up_start, up_end = (statistics.median(c) for c in zip(*spans))
    return rows, {"solve_end_ms": solve_end, "upload_start_ms": up_start,
                  "upload_end_ms": up_end,
                  "upload_inside_solve": all(s[2] < s[0] for s in spans)}, \
        equal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the line to this file")
    ap.add_argument("--quick", action="store_true",
                    help="three small shapes, the solve 2 pairs of 48x128 at "
                         "3 scales, one timed copy each: a check of the "
                         "probe, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    shapes, reps, params, (batch, h, w) = (SHAPES, REPS, TVL1Params(),
                                           (BATCH, H, W))
    if ns.quick:
        shapes, reps, params, (batch, h, w) = (QUICK_SHAPES, 1,
                                               TVL1Params(nscales=3),
                                               (2, 48, 128))
    copies, equal = {}, True
    for name, (dtype, shape) in shapes.items():
        x = source(dtype, shape)
        rows, same = copy_rows(dev, x, reps)
        copies[name] = {"mb": x.nbytes / 1e6, **rows, "equal": same}
        equal = equal and same
    rows, overlap, same = overlap_rows(dev, params, reps, batch, h, w)
    equal = equal and same
    emit({
        "probe": "r5_transfer_cost",
        "platform": platform(dev),
        "device": device_label(dev),
        "copies": copies,
        "overlap": {"shape": [batch, h, w], **rows, "streams": overlap},
        "readback_equal": equal,
    }, ns.out)
    if not equal:
        raise SystemExit("r5_transfer_cost: a copy read back differs from "
                         "its source")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
