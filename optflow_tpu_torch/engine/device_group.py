"""Device-resident group pipeline for ``random_points`` jobs.

For ``random_points`` output nothing full-sized is ever needed on the host
(the reference downloads the flow and runs findNonZero per pair,
src/optflow.cpp:475-494), so this pipeline keeps a whole pair group on the
device:

- unique frames upload ONCE per job (not per group) through a device frame
  cache, as float16 where that is LOSSLESS (scales 1.0/0.5: quarter-integer
  intensities <= 255.75 are exactly representable) and float32 otherwise —
  see :func:`frame_upload_dtype`;
- ROI slicing, pair gathering, flow post-processing (map and
  feature-affine composition, background zero-mask, union valid mask —
  src/optflow.cpp:411-493 semantics) and POINT SAMPLING all run on the
  device; a feature group's frame 1 is the pre-aligned, warped frame of
  each pair, which never leaves the device either;
- sampling is a top-k over per-pixel random priorities: exactly a uniform
  draw of ``npoints`` valid pixels without replacement (the reference's
  findNonZero + shuffle + take-front, src/optflow.cpp:522-572),
  deterministic under ``debug`` via a fixed generator seed;
- ONE packed readback per group carries the samples and the valid counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.engine.pair import postprocess_flow
from optflow_tpu_torch.engine.rois import Roi
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched


def frame_upload_dtype(scale: float) -> np.dtype:
    """Upload dtype for decoded frames at a given job scale.

    float16 is LOSSLESS exactly when the decode produces quarter-integer
    intensities <= 255.75 (scale 1.0: integers; scale 0.5: 2x2
    area-averages of uint8). Other scales produce finer fractions that
    f16 would round near bright pixels (ulp 0.125 above 128), silently
    diverging from the host path — those upload as float32."""
    return np.dtype(
        np.float16 if float(scale) in (1.0, 0.5) else np.float32
    )


class DeviceFrameCache:
    """id(ndarray) -> frame tensor on the device (f16/f32 per the upload
    dtype rule), bounded FIFO.

    The host FrameCache hands the SAME ndarray object to every pair that
    reuses a (path, scale), so array identity keys device residency; the
    host array is retained alongside so its id can't be recycled."""

    def __init__(self, device, capacity: int = 256):
        self.device = torch.device(device)
        self._cap = capacity
        self._entries: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
        self._order: List[int] = []

    def get_many(self, arrs: Sequence[np.ndarray],
                 dtype=np.float16) -> List[torch.Tensor]:
        """Handles for a batch of frames; the misses upload as ONE stacked
        copy and are sliced apart on the device."""
        handles: List[Optional[torch.Tensor]] = [None] * len(arrs)
        miss: List[int] = []
        for j, arr in enumerate(arrs):
            hit = self._entries.get(id(arr))
            if hit is not None:
                handles[j] = hit[1]
            else:
                miss.append(j)
        if miss:
            stacked = torch.from_numpy(
                np.stack([np.asarray(arrs[j], dtype) for j in miss])
            ).to(self.device)
            for pos, j in enumerate(miss):
                handles[j] = stacked[pos]
                self._insert(id(arrs[j]), arrs[j], stacked[pos])
        return handles  # type: ignore[return-value]

    def _insert(self, key: int, arr: np.ndarray, dev: torch.Tensor) -> None:
        self._entries[key] = (arr, dev)
        self._order.append(key)
        if len(self._order) > self._cap:
            old = self._order.pop(0)
            self._entries.pop(old, None)


def stack_frames(handles: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack per-frame device tensors into one (U, fh, fw) float32 tensor on
    the device (no host roundtrip; mixed stored dtypes all widen to f32)."""
    return torch.stack([h.to(torch.float32) for h in handles])


def gather_rois(
    frames: torch.Tensor,  # (U, fh, fw) f32
    f0_idx: torch.Tensor,  # (n,) int64
    f1_idx: torch.Tensor,
    rois: Sequence[Roi],  # same-shape ROIs
    warped: Optional[torch.Tensor] = None,  # (n, fh, fw) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROI stacks for every (roi, pair) from the device frame stack.

    Returns (R*n, h, w) f32 i0/i1 stacks ordered ROI-major (roi r's pairs
    are rows [r*n, (r+1)*n)). With ``warped`` (feature groups), frame 1
    comes from the pre-warped per-pair frames instead of the frame stack."""
    if any(r.shape != rois[0].shape for r in rois):
        raise ValueError("gather_rois takes ROIs of one shape")
    f0 = frames[f0_idx]  # (n, fh, fw)
    f1 = frames[f1_idx] if warped is None else warped
    i0 = torch.cat([f0[(slice(None), *r.slices())] for r in rois])
    i1 = torch.cat([f1[(slice(None), *r.slices())] for r in rois])
    return i0.contiguous(), i1.contiguous()


def sample_points(
    fx: torch.Tensor,  # (n, h, w) post-processed outputs
    fy: torch.Tensor,
    valid: torch.Tensor,  # (n, h, w) bool
    npoints: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Uniform valid-pixel sampling + the packed readback payload.

    Per-pixel U(0,1) priorities, invalid pixels sent to -1, top-k of
    ``npoints`` -> a uniform draw without replacement;
    count = min(npoints, n_valid).

    Output: (n, npoints * 4 + 1) f32 rows of
    [px, py, out_x, out_y] * npoints + [count]."""
    n, h, w = valid.shape
    k = min(npoints, h * w)
    pri = torch.rand(valid.shape, generator=generator, device=valid.device)
    pri = torch.where(valid, pri, torch.full_like(pri, -1.0))
    _top, idx = torch.topk(pri.reshape(n, h * w), k, dim=1)
    px = (idx % w).to(torch.float32)
    py = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    fxv = torch.gather(fx.reshape(n, h * w), 1, idx)
    fyv = torch.gather(fy.reshape(n, h * w), 1, idx)
    count = torch.clamp(valid.sum(dim=(1, 2)), max=k).to(torch.float32)
    samples = torch.stack([px, py, fxv, fyv], dim=2)  # (n, k, 4)
    if k < npoints:
        pad = torch.zeros((n, npoints - k, 4), device=samples.device)
        samples = torch.cat([samples, pad], dim=1)
    return torch.cat([samples.reshape(n, -1), count[:, None]], dim=1)


def solve_group_on_device(
    frames_dev: torch.Tensor,  # (U, fh, fw) f32 device stack
    f0_idx: np.ndarray,
    f1_idx: np.ndarray,
    rois: Sequence[Tuple[str, Roi]],  # same-shape ROIs, ordered
    params: TVL1Params,
    mode: str,
    npoints: int,
    affines_dev: Optional[torch.Tensor] = None,  # (n, 2, 3) f32, features
    warped_dev: Optional[torch.Tensor] = None,  # (n, fh, fw) f32, features
    debug: bool = False,
    seed: int = 0,
):
    """Solve all same-shape ROIs of a pair group fully on the device. A
    feature group passes its pairs' affines and pre-warped frames 1; the
    map composition resamples with the exact affine warp.

    Returns (packed, i0s, i1s, flow): ``packed`` is the
    (R*n, npoints*4+1) payload of :func:`sample_points` (``.cpu()`` it: ONE
    transfer), the rest are the device tensors it was made from."""
    dev = frames_dev.device
    with torch.no_grad():
        i0s, i1s = gather_rois(
            frames_dev,
            torch.as_tensor(f0_idx, dtype=torch.int64, device=dev),
            torch.as_tensor(f1_idx, dtype=torch.int64, device=dev),
            [r for _name, r in rois],
            warped=warped_dev,
        )
        flow = tvl1_flow_batched(i0s, i1s, params)
        affs = None
        if mode.startswith("features"):
            if affines_dev is None or warped_dev is None:
                raise ValueError(f"mode {mode!r} needs affines and warped frames")
            affs = torch.cat([affines_dev] * len(rois))
        fx, fy, valid = postprocess_flow(flow, i0s, i1s, mode, affs)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0 if debug else int(seed))
        packed = sample_points(fx, fy, valid, npoints, gen)
    return packed, i0s, i1s, flow


def unpack_samples(
    packed_np: np.ndarray,  # (R*n, npoints*4+1)
    n: int,
    npoints: int,
):
    """Split the packed payload back into per-(roi, pair) sample arrays:
    returns (samples (R, n, npoints, 4), counts (R, n) int)."""
    rn = packed_np.shape[0]
    r = rn // n
    samples = packed_np[:, : npoints * 4].reshape(r, n, npoints, 4)
    counts = packed_np[:, npoints * 4].reshape(r, n).astype(np.int64)
    return samples, counts


def matches_from_samples(
    samples: np.ndarray,  # (npoints, 4): px, py, out_x, out_y
    count: int,
    roi: Roi,
    inv_scale: float,
    features: bool,
    point_matches: Optional[Dict] = None,
) -> Dict:
    """Host-side assembly of one (pair, roi)'s matches from the device
    samples — the coordinate math of engine.sampler.random_points
    (src/optflow.cpp:522-572 semantics), including the dummy match for
    an empty valid mask."""
    if point_matches is None or not point_matches:
        point_matches = {"p": [[], []], "q": [[], []], "w": []}
    if count == 0:
        point_matches["p"][0].append(-1)
        point_matches["p"][1].append(-1)
        point_matches["q"][0].append(-1)
        point_matches["q"][1].append(-1)
        point_matches["w"].append(0)
        return point_matches
    for px, py, fx, fy in samples[:count]:
        point_matches["w"].append(1)
        point_matches["p"][0].append((float(px) + roi.x) * inv_scale)
        point_matches["p"][1].append((float(py) + roi.y) * inv_scale)
        if features:
            point_matches["q"][0].append((float(fx) + roi.x) * inv_scale)
            point_matches["q"][1].append((float(fy) + roi.y) * inv_scale)
        else:
            point_matches["q"][0].append(
                (float(px) + roi.x + float(fx)) * inv_scale
            )
            point_matches["q"][1].append(
                (float(py) + roi.y + float(fy)) * inv_scale
            )
    return point_matches
