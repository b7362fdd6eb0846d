"""Full sections on the card: megapixel image-pairs a second of the
coarse-to-fine TV-L1 solve of whole sections, and each pyramid level's time.
The port's counterpart of the root probes ``tools/probes/r5_blocked.py`` and
``r5_blocked_levels.py`` (with ``_level_timing.py``).

    python -m optflow_tpu_torch.bench.section [NxHxW ...] [--device cuda]
        [--out FILE] [--quick]

Default shapes, the probe's own (``r5_blocked.py:79``): 4x512x1024 (four
1024x2048 sections at scale 0.5, a custom-ROI ``map`` / ``flow`` job's
group), 1x1024x1024 and 16x256x1024 (the headline solve's). Per shape, n
pairs of :func:`synth.make_pair` (seeds 0 .. n - 1, true flow (2.0, -1.25))
at the reference defaults go through ``ops.tvl1.tvl1_flow_batched``, on the
card the level kernel at every level. Per shape the line gives:

- ``first_call_s``: the first call, host clock from an idle card to a
  synchronisation;
- the steady state: ``REPS`` calls enqueued back to back and one
  synchronisation (``r5_blocked.py:53-57``) after a warm run of the same,
  timed by CUDA events: ``seconds_per_batch``, ``ms_per_batch``,
  ``mp_pairs_per_s``;
- ``epe_px``, the first call's mean end-point error against the truth 16 px
  from every border, and ``epe_ok`` (<= 0.5 px, the probe's assert);
- ``gpx_iters_per_batch``, the pixel-iterations each level counted to its
  exit, with ``mfu`` and ``bound`` of :mod:`.roofline`, the one work count;
- ``levels``: the solve once more through ``solve_pyramid`` with CUDA events
  around each level's kernel call: shape, ``ms``, iterations counted and
  computed (speculation and replays included: ``tvl1_level_solve.last_work``),
  G pixel-iterations a second on counted work, the level's share of the sum
  and its ``bound_ms``; ``levels_ms`` is the sum.

One JSON line: ``metric``, ``value`` (the first shape's ``mp_pairs_per_s``,
the number a benchmark cell reads), ``unit``, ``vs_baseline``, ``platform``,
``kernel``, ``device`` (the card's name and power limit), ``clock``,
``epe_target_px``, ``epe_ok`` (every shape's gate) and ``sections``, one
record a shape with the keys of ``bench.solve`` that mean the same there
(``shape``, ``epe_px``, ``epe_ok``, ``seconds_per_batch``, ``mfu``,
``gpx_iters_per_batch``, ``bound``) and the ones above. A failed gate exits
non-zero after the line; nothing is retried. Off the card (``--device
cpu``) the times are the host clock's and no share is given.

Not ported: the probe's ``blocked`` rows, a TPU routing by on-chip memory
(``_FUSED_PX_BUDGET``) that the port does not have.
"""

from __future__ import annotations

import argparse
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
from optflow_tpu_torch.bench.solve import (
    EPE_TARGET_PX,
    interior_epe,
    solve_inputs,
)
from optflow_tpu_torch.bench.synth import DX, DY
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import tvl1_cuda
from optflow_tpu_torch.ops.tvl1 import (
    get_last_iteration_stats,
    solve_pyramid,
    tvl1_flow_batched,
)

REPS = 5
SHAPES = ((4, 512, 1024), (1, 1024, 1024), (16, 256, 1024))
QUICK_SHAPES = ((2, 64, 128), (1, 96, 96))


def parse_shape(text: str):
    """``"4x512x1024"`` -> ``(4, 512, 1024)``."""
    n, h, w = (int(x) for x in text.lower().split("x"))
    return n, h, w


def level_rows(i0: torch.Tensor, i1: torch.Tensor, params: TVL1Params):
    """The solve through ``solve_pyramid`` with the level kernel's wrapper
    at every level (``tvl1_flow_batched``'s on the card), each level's call
    timed: by CUDA events on the card (no synchronisation inside the solve),
    by the host clock off it. Returns the flow and one row a level, coarsest
    first."""
    cuda = i0.is_cuda
    calls = []

    def timed_level(a, b, u1, u2, p, u3):
        if cuda:
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
        t0 = time.perf_counter()
        out = tvl1_cuda._level_solver(a, b, u1, u2, p, u3)
        if cuda:
            span[1].record()
        else:
            span = (time.perf_counter() - t0) * 1e3
        work = tvl1_cuda.tvl1_level_solve.last_work if cuda else None
        calls.append((tuple(a.shape), span, out[3], work))
        return out

    sync(i0.device)
    flow = solve_pyramid(i0, i1, params, None, timed_level)
    sync(i0.device)
    rows = []
    for (n, h, w), span, iters, work in calls:
        ms = span[0].elapsed_time(span[1]) if cuda else span
        counted = int(iters.sum())
        bound_ms, bound_by = roofline.level_bound_ms(n, h, w, params.warps,
                                                     counted)
        rows.append({
            "shape": [n, h, w], "ms": ms, "iters_counted": counted,
            "iters_computed": None if work is None else int(work[0].sum()),
            "gpx_iters_per_s": h * w * counted / (ms / 1e3) / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by})
    total = sum(r["ms"] for r in rows)
    for r in rows:
        r["share"] = r["ms"] / total
    return flow, rows


def measure(dev: torch.device, shape, params: TVL1Params, reps: int) -> dict:
    """One shape's record (see the module's docstring)."""
    n, h, w = shape
    i0_np, i1_np = solve_inputs(n, h, w)
    i0 = torch.from_numpy(i0_np).to(dev)
    i1 = torch.from_numpy(i1_np).to(dev)
    sync(dev)
    t0 = time.perf_counter()
    flow = tvl1_flow_batched(i0, i1, params)
    epe = float(interior_epe(flow, DX, DY))
    sync(dev)
    first_call_s = time.perf_counter() - t0
    work = roofline.pyramid_work(get_last_iteration_stats(), params.warps)

    _, t = timed(dev, lambda: [tvl1_flow_batched(i0, i1, params)
                               for _ in range(reps)], 1)
    dt = elapsed_ms(t) / 1e3 / reps
    if dev.type == "cuda":
        _, bound = roofline.share(work, dt)
        mfu = work.flops / dt / roofline.PEAK_F32_FLOPS
    else:
        bound, mfu = roofline.bound_seconds(work)[1], None
    _, levels = level_rows(i0, i1, params)
    return {
        "shape": [n, h, w],
        "first_call_s": first_call_s,
        "seconds_per_batch": dt,
        "ms_per_batch": dt * 1e3,
        "mp_pairs_per_s": n * h * w / 1e6 / dt,
        "epe_px": epe,
        "epe_ok": epe <= EPE_TARGET_PX,
        "gpx_iters_per_batch": work.px_iterations / 1e9,
        "mfu": mfu,
        "bound": bound,
        "levels_ms": sum(r["ms"] for r in levels),
        "levels": levels,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shapes", nargs="*", type=parse_shape, metavar="NxHxW",
                    help="shapes to solve (default: "
                         + " ".join("x".join(map(str, s)) for s in SHAPES)
                         + ")")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the line to this file")
    ap.add_argument("--quick", action="store_true",
                    help="2x64x128 and 1x96x96 at 3 scales, one timed call: "
                         "a check of the bench, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    shapes, params, reps = SHAPES, TVL1Params(), REPS
    if ns.quick:
        shapes, params, reps = QUICK_SHAPES, TVL1Params(nscales=3), 1
    shapes = ns.shapes or shapes

    sections = [measure(dev, s, params, reps) for s in shapes]
    value = sections[0]["mp_pairs_per_s"]
    rec = {
        "metric": "full-section MP-pairs/s per card (TV-L1, ref defaults)",
        "value": value,
        "unit": "MP-pairs/s",
        "vs_baseline": value / 1.0,
        "platform": platform(dev),
        "kernel": "cuda" if dev.type == "cuda" else "plain",
        "device": device_label(dev),
        "clock": "CUDA events" if dev.type == "cuda" else "host",
        "epe_target_px": EPE_TARGET_PX,
        "epe_ok": all(s["epe_ok"] for s in sections),
        "sections": sections,
    }
    emit(rec, ns.out)
    if not rec["epe_ok"]:
        raise SystemExit("section: EPE above {} px at {}".format(
            EPE_TARGET_PX, [s["shape"] for s in sections if not s["epe_ok"]]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
