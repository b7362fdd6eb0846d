"""Pre-alignment by stage on the card, and the solve it feeds. The port's
counterpart of the root probe ``tools/probes/r4_feature_stages.py``.

    python -m optflow_tpu_torch.tools.probes.r4_feature_stages
        [--device cuda] [--out FILE] [--quick]

Four pairs of 256x1024 misaligned by a small rigid motion
(:func:`synth.affine_pairs`, the pairs of ``bench.matrix features``),
SURF-class at the job defaults, in the order of the job's call
``find_alignment(frame1, frame0)``: frame 1's keypoints are set 0, and the
affine maps frame 1's coordinates into frame 0's. Stages, in the root's
order:

  detect_describe  both frames' keypoints and descriptors
                   (``features/align.py: _detect_describe_device``)
  knn_match        ``features/match.py: knn_match2``
  ratio_filter     ``ratio_filter``
  ransac           ``matched_points``, ``ransac.find_homography`` and the
                   reference's gates (``gate_homography``)
  prealign         the whole: ``find_alignment_batched_device``
  warp             frame 1 warped by the prealign's affine (``affine_warp``)
  solve            ``tvl1_flow_batched`` of frame 0 and the warped frame 1

Each row is the median of ``REPS`` after a warm call, each started on an
idle card (``bench.timed``): ``device_ms`` by CUDA events, ``wall_ms`` and
``enqueue_ms`` by the host clock, and ``bound_by``: ``host`` where the host
took half the wall or more to enqueue the stage (the card waited on it),
else ``card``. ``prealign_mp_pairs_per_s`` divides by the prealign's time,
``combined_mp_pairs_per_s`` by prealign + warp + solve.

Gate: the affine composed from the stages equals the prealign's at the
frame's four corners within :data:`COMPOSED_GATE_PX`, 0.0: the stages are
the prealign's own calls in its order on the same inputs, and RANSAC draws
its hypotheses from a generator seeded alike (``find_homography``'s seed 0
on the tensors' device), so the same operations give the same bits. A
failed gate exits non-zero after the line.
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
    timed,
)
from optflow_tpu_torch.bench.synth import affine_pairs
from optflow_tpu_torch.core.config import (
    SURF_TYPE,
    MatchParams,
    OrbParams,
    SurfParams,
    TVL1Params,
)
from optflow_tpu_torch.features.align import (
    _detect_describe_device,
    find_alignment_batched_device,
    gate_homography,
    matched_points,
)
from optflow_tpu_torch.features.match import knn_match2, ratio_filter
from optflow_tpu_torch.features.ransac import find_homography
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
from optflow_tpu_torch.ops.warp import affine_warp

REPS = 3
BATCH, H, W = 4, 256, 1024
COMPOSED_GATE_PX = 0.0


def corner_gap_px(a: torch.Tensor, b: torch.Tensor, h: int, w: int) -> float:
    """The largest distance between where two ``(N, 2, 3)`` affines put the
    four corners of an ``h x w`` frame, px."""
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                        [w - 1, h - 1, 1]], np.float64).T
    pa = a.double().cpu().numpy() @ corners
    pb = b.double().cpu().numpy() @ corners
    return float(np.abs(pa - pb).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the line to this file")
    ap.add_argument("--quick", action="store_true",
                    help="2 pairs of 128x256, the solve at 3 scales, one "
                         "timed call a stage: a check of the probe, not a "
                         "measurement")
    ns = ap.parse_args(argv)
    dev = open_device(ns.device)
    batch, h, w, params, reps = BATCH, H, W, TVL1Params(), REPS
    if ns.quick:
        batch, h, w, params, reps = 2, 128, 256, TVL1Params(nscales=3), 1
    orb, surf, mp = OrbParams(), SurfParams(), MatchParams()
    i0_np, i1_np, _ = affine_pairs(batch, h, w)
    i0 = torch.from_numpy(i0_np).to(dev)
    i1 = torch.from_numpy(i1_np).to(dev)

    rows = {}
    with torch.no_grad():
        def detect_describe():
            return (_detect_describe_device(i1, SURF_TYPE, orb, surf),
                    _detect_describe_device(i0, SURF_TYPE, orb, surf))

        ((k0, d0, binary), (k1, d1, _)), rows["detect_describe"] = timed(
            dev, detect_describe, reps)
        matches, rows["knn_match"] = timed(
            dev, lambda: knn_match2(d0, k0.valid, d1, k1.valid,
                                    binary=binary), reps)
        good, rows["ratio_filter"] = timed(
            dev, lambda: ratio_filter(matches, mp.ratio), reps)

        def ransac():
            p0, p1 = matched_points(k0, k1, matches.idx)
            res = find_homography(p0, p1, good, thresh=float(mp.ransac),
                                  method=int(mp.homo))
            return gate_homography(res, good, mp)

        composed, rows["ransac"] = timed(dev, ransac, reps)
        whole, rows["prealign"] = timed(
            dev, lambda: find_alignment_batched_device(
                i1, i0, SURF_TYPE, orb, surf, mp), reps)
        warped, rows["warp"] = timed(
            dev, lambda: affine_warp(i1, whole.affine), reps)
        _, rows["solve"] = timed(
            dev, lambda: tvl1_flow_batched(i0, warped, params), reps)
    for t in rows.values():
        t["bound_by"] = ("host" if t["enqueue_ms"] >= 0.5 * t["wall_ms"]
                         else "card")

    gap = corner_gap_px(composed.affine, whole.affine, h, w)
    mp_pairs = batch * h * w / 1e6
    pre_s = elapsed_ms(rows["prealign"]) / 1e3
    chain_s = pre_s + sum(elapsed_ms(rows[k]) for k in ("warp", "solve")) / 1e3
    ok = gap <= COMPOSED_GATE_PX and torch.equal(composed.n_good, whole.n_good)
    emit({
        "probe": "r4_feature_stages",
        "platform": platform(dev),
        "device": device_label(dev),
        "shape": [batch, h, w],
        "rows": rows,
        "prealign_mp_pairs_per_s": mp_pairs / pre_s,
        "combined_mp_pairs_per_s": mp_pairs / chain_s,
        "good_matches": whole.n_good.tolist(),
        "composed_vs_prealign_corner_px": gap,
        "composed_gate_px": COMPOSED_GATE_PX,
        "gate_ok": ok,
    }, ns.out)
    if not ok:
        raise SystemExit(
            f"r4_feature_stages: the affine composed from the stages is {gap}"
            f" px from the prealign's at the corners (gate "
            f"{COMPOSED_GATE_PX}), good matches {composed.n_good.tolist()} "
            f"against {whole.n_good.tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
