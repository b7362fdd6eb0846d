"""A job's device group by piece on the card: where a group's time goes
between the uploads and the packed readback. The port's counterpart of the
root probe ``tools/probes/r5_sample_stage.py``.

    python -m optflow_tpu_torch.tools.probes.r5_sample_stage
        [--device cuda] [--out FILE] [--quick]

The probe's group: 20 frames of 512x1024 (:func:`synth.make_pair` seeds
0-19, frame 0 of each) uploaded as float16 through the job's
``DeviceFrameCache``, 16 pairs (frame i with frame i + 1 mod 20), two strip
ROIs (rows 0-255 and 256-511), 25 points, ``displacement`` output at the
reference defaults. The pieces as ``engine/device_group.py`` has them:

  stack_frames   the frame handles stacked and widened to float32
  gather_rois    the (2 x 16, 256, 1024) i0 / i1 stacks
  solve          ``tvl1_flow_batched`` of the 32 strips
  post_sample    ``engine/pair.py: postprocess_flow`` and ``sample_points``
                 (a generator seeded 0, as a job's ``debug`` seeds it)
  readback       the packed samples copied to the host

and beside them ``whole``: ``solve_group_on_device`` on the same group with
its packed readback. The probe's pairs are frames of unrelated textures (no
true flow), so the solve runs far more iterations than a job's strips do: its
row carries the counted pixel-iterations. Each row is the median of ``REPS``
after a warm call, each started on an idle card (``bench.timed``:
``device_ms`` by CUDA events, ``wall_ms``, ``enqueue_ms``). ``mp_pairs_per_s``
divides the group's strip megapixels by the pieces' sum.

Gate: the pieces composed give the packed samples of the whole call, bit
for bit (the same operations on the same inputs, the sampler's generator
seeded alike). A failed gate exits non-zero after the line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from optflow_tpu_torch.bench import (
    device_label,
    elapsed_ms,
    emit,
    open_device,
    platform,
    roofline,
    timed,
)
from optflow_tpu_torch.bench.synth import make_pair
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.engine.device_group import (
    DeviceFrameCache,
    gather_rois,
    sample_points,
    solve_group_on_device,
    stack_frames,
)
from optflow_tpu_torch.engine.pair import postprocess_flow
from optflow_tpu_torch.engine.rois import Roi
from optflow_tpu_torch.ops.tvl1 import (
    get_last_iteration_stats,
    tvl1_flow_batched,
)

REPS = 4
FH, FW, PAIRS, UPLOADS, NPOINTS = 512, 1024, 16, 20, 25
MODE = "displacement"
SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the line to this file")
    ap.add_argument("--quick", action="store_true",
                    help="4 pairs of 64x128 frames over 5 uploads, the solve "
                         "at 3 scales, one timed call a piece: a check of "
                         "the probe, not a measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    fh, fw, n_pairs, n_up, params, reps = (FH, FW, PAIRS, UPLOADS,
                                           TVL1Params(), REPS)
    if ns.quick:
        fh, fw, n_pairs, n_up, params, reps = (64, 128, 4, 5,
                                               TVL1Params(nscales=3), 1)
    frames = [make_pair(fh, fw, 0, 0, seed=i)[0] for i in range(n_up)]
    handles = DeviceFrameCache(dev).get_many(frames, np.float16)
    f0_idx = np.arange(n_pairs) % n_up
    f1_idx = (np.arange(n_pairs) + 1) % n_up
    strip = fh // 2
    rois = [("top", Roi(0, 0, fw, strip)),
            ("bottom", Roi(0, strip, fw, strip))]
    f0 = torch.as_tensor(f0_idx, dtype=torch.int64, device=dev)
    f1 = torch.as_tensor(f1_idx, dtype=torch.int64, device=dev)

    rows = {}
    with torch.no_grad():
        stacked, rows["stack_frames"] = timed(
            dev, lambda: stack_frames(handles), reps)
        (i0s, i1s), rows["gather_rois"] = timed(
            dev, lambda: gather_rois(stacked, f0, f1, [r for _, r in rois]),
            reps)
        flow, rows["solve"] = timed(
            dev, lambda: tvl1_flow_batched(i0s, i1s, params), reps)
        rows["solve"]["px_iterations"] = roofline.pyramid_work(
            get_last_iteration_stats(), params.warps).px_iterations

        def post_sample():
            fx, fy, valid = postprocess_flow(flow, i0s, i1s, MODE)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            return sample_points(fx, fy, valid, NPOINTS, gen)

        packed, rows["post_sample"] = timed(dev, post_sample, reps)
        pieces, rows["readback"] = timed(dev, packed.cpu, reps)

        def whole_call():
            out = solve_group_on_device(stacked, f0_idx, f1_idx, rois, params,
                                        MODE, NPOINTS, seed=SEED)
            return out[0].cpu()

        whole, rows["whole"] = timed(dev, whole_call, reps)
    pieces_ms = sum(elapsed_ms(t) for k, t in rows.items() if k != "whole")
    ok = torch.equal(pieces, whole)
    emit({
        "probe": "r5_sample_stage",
        "platform": platform(dev),
        "device": device_label(dev),
        "frames": [n_up, fh, fw],
        "pairs": n_pairs,
        "strips": [len(rois) * n_pairs, strip, fw],
        "npoints": NPOINTS,
        "rows": rows,
        "pieces_ms": pieces_ms,
        "mp_pairs_per_s": len(rois) * n_pairs * strip * fw / 1e6
        / (pieces_ms / 1e3),
        "pieces_equal_whole": ok,
    }, ns.out)
    if not ok:
        raise SystemExit("r5_sample_stage: the pieces' packed samples differ "
                         "from solve_group_on_device's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
