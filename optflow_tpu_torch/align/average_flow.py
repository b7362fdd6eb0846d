"""Average-flow temporal stack aligner — the reference's dormant style 2.

The reference carries this mode as commented-out code it intended to revive
(src/optflow.cpp:67-70,180-226,263-300; prototypes kept in
src/optflow.h:17-19): align each section against a Gaussian-weighted
average of its +/-3 neighbors, then resample the section onto the average's
frame. With JSON job support:

- neighbor weights e^{-x^2/4} for |dz| in {1,2,3}, renormalized to sum to 1
  over the 6 neighbors (src/optflow.cpp:189-191)
- TV-L1 from the section to the blurred target at ``scale``, flow rescaled
  by 1/scale and upsampled to full resolution (src/optflow.cpp:273-276)
- inverse-map resampling: map(x) = x - flow(x), border-padded, bilinear
  remap, written as <index>.tiff (src/optflow.cpp:278-299)

Every section's solve goes through ``ops.tvl1.tvl1_flow_batched``, as a
style-1 pair's does: on a CUDA device the level kernel at every pyramid
level with the exact epsilon exit, on the CPU the plain solver, which
computes the same function. The frames of the +/-3 window stay on the
device, one decode and upload per section.

Job keys (style 2): ``file_list`` (ordered section paths) or ``images``
with ``p`` entries, ``output_dir``, ``scale`` (default 0.5), ``border``
(default 0), plus the standard TV-L1 keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from optflow_tpu_torch.core.config import JobConfig, TVL1Params
from optflow_tpu_torch.core.imgio import read_gray, write_float_tiff
from optflow_tpu_torch.ops.pyramid import resize_bilinear
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
from optflow_tpu_torch.ops.warp import bilinear_sample
from optflow_tpu_torch.utils.metrics import StageTimer

# e^{-x^2/4} at |dz| = 3, 2, 1, 1, 2, 3 — renormalized so the six weights
# sum to 1 (ref: src/optflow.cpp:189-191).
_RAW = [math.exp(-9.0 / 4.0), math.exp(-1.0), math.exp(-1.0 / 4.0)]
_NORM = 0.5 / sum(_RAW)
WEIGHTS = [w * _NORM for w in (_RAW + _RAW[::-1])]


def _remap_inverse(frame: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Resample ``frame`` (H, W) at map(x) = x - flow(x), ``flow`` (2, H, W)
    with ``flow[0]`` = x (ref: src/optflow.cpp:286-298)."""
    h, w = frame.shape
    xs = torch.arange(w, dtype=torch.float32, device=frame.device)
    ys = torch.arange(h, dtype=torch.float32, device=frame.device)[:, None]
    return bilinear_sample(frame, xs - flow[0], ys - flow[1])


def _solve_flow(frame, blur, scale: float, params: TVL1Params) -> torch.Tensor:
    """Flow (2, H, W) from ``frame`` to ``blur`` solved at ``scale``, in
    full-resolution px, upsampled bilinearly with half-pixel centres and
    clamped edges."""
    h, w = frame.shape
    sh = (int(round(h * scale)), int(round(w * scale)))
    f_s = resize_bilinear(frame, sh)[None]
    b_s = resize_bilinear(blur, sh)[None]
    flow_s = tvl1_flow_batched(f_s, b_s, params)[0]
    flow_s = flow_s.permute(2, 0, 1) * (1.0 / scale)
    return resize_bilinear(flow_s, (h, w))


def average_flow_job(
    args: Dict,
    device="cuda",
    timer: Optional[StageTimer] = None,
) -> List[str]:
    """Run the style-2 aligner over a job dict on ``device``; returns the
    written paths. ``timer`` collects the stages: ``decode`` (read and
    upload a section), ``blur``, ``solve`` and ``remap`` (device stages) and
    ``write`` (download and TIFF)."""
    cfg = JobConfig(args)
    if "file_list" in args:
        paths = [str(p) for p in args["file_list"]]
    else:
        paths = [str(im["p"]) for im in cfg.images]
    if len(paths) < 7:
        raise ValueError(
            f"average_flow needs at least 7 sections, got {len(paths)}"
        )
    out_dir = str(args.get("output_dir", "."))
    scale = float(args.get("scale", 0.5))
    border = int(args.get("border", 0))
    params = TVL1Params.from_config({}, args)
    dev = torch.device(device)
    timer = timer if timer is not None else StageTimer()

    def load(path):
        with timer.stage("decode"):
            im = read_gray(path).astype(np.float32)
            return torch.from_numpy(im).to(dev)

    frames = [load(p) for p in paths[:7]]
    written: List[str] = []
    with torch.no_grad():
        for i in range(3, len(paths) - 3):
            # frames holds sections [i-3 .. i+3]
            with timer.device_stage("blur", dev):
                blur = sum(
                    w * f for w, f in zip(WEIGHTS, frames[:3] + frames[4:])
                )
            frame = frames[3]
            with timer.device_stage("solve", dev):
                flow = _solve_flow(frame, blur, scale, params)
            with timer.device_stage("remap", dev):
                if border:
                    frame = F.pad(frame, (border,) * 4)
                    flow = F.pad(flow, (border,) * 4)
                aligned = _remap_inverse(frame, flow)
            out_path = f"{out_dir}/{i}.tiff"
            with timer.stage("write"):
                write_float_tiff(out_path, aligned.cpu().numpy())
            written.append(out_path)
            print(f"N: {i} {paths[i]}")

            if i + 4 < len(paths):
                frames.pop(0)
                frames.append(load(paths[i + 4]))
    return written
