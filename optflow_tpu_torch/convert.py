"""Carrying solver parameters and state across from the JAX package.

The system has no weights; what moves between the two packages is the
solver's parameters and per-level state. The functions here take plain
Python / numpy values (``dataclasses.asdict`` of the JAX package's
``TVL1Params``, ``np.asarray`` of its arrays), so this package imports
nothing of the other, and return this package's types and layouts:

- flow: ``(N, H, W, 2)`` float32, ``[..., 0]`` = x
- level state: ``(N, 6, H, W)`` float32 in the order
  u1, u2, p11, p12, p21, p22
- warped arrays of a sweep: ``(N, 3, H, W)`` float32 in the order
  i1wx, i1wy, rho_c
- keypoints: the six fields x, y, sigma, angle, response, valid, each
  ``(K,)`` (or ``(F, K)`` for a stack of frames); descriptors ``(K, D)``
- affines: ``(2, 3)`` or ``(N, 2, 3)`` float32, the forward matrix
- feature parameters: the detector type and the three parameter dataclasses

The JAX package's level kernels take the last two zero-padded to a canvas
``(N, C, Hp, Wp)`` (rows to a multiple of 8 or of the row block, columns to
a multiple of 128) with the real ``h, w`` beside it; this package's kernels
take them unpadded. :func:`canvas_to_tensor` and :func:`tensor_to_canvas`
go between the two.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from optflow_tpu_torch.core.config import (
    MatchParams,
    OrbParams,
    SurfParams,
    TVL1Params,
)
from optflow_tpu_torch.features.detect import Keypoints

STATE_ORDER = ("u1", "u2", "p11", "p12", "p21", "p22")


def _dataclass_from_fields(cls, fields: Mapping):
    names = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != names:
        raise ValueError(
            f"{cls.__name__} fields differ: {sorted(set(fields) ^ names)}"
        )
    return cls(**{k: fields[k] for k in names})


def params_from_reference(fields: Mapping) -> TVL1Params:
    """``TVL1Params`` from the field dict of the JAX package's dataclass.
    Unknown or missing fields raise: the two classes must stay in step."""
    return _dataclass_from_fields(TVL1Params, fields)


def feature_params_from_reference(
    ftype: int, orb: Mapping, surf: Mapping, match: Mapping
) -> Tuple[int, OrbParams, SurfParams, MatchParams]:
    """The bundle ``features.align.resolve_feature_params`` returns, from
    the detector type and the field dicts of the JAX package's three
    parameter dataclasses. Unknown or missing fields raise."""
    return (
        int(ftype),
        _dataclass_from_fields(OrbParams, orb),
        _dataclass_from_fields(SurfParams, surf),
        _dataclass_from_fields(MatchParams, match),
    )


def keypoints_from_numpy(
    x, y, sigma, angle, response, valid, device="cuda"
) -> Keypoints:
    """``Keypoints`` from the six arrays of the JAX package's keypoints
    (``np.asarray`` of each field, in its order)."""
    fields = [
        torch.as_tensor(np.array(a, np.float32), device=device)
        for a in (x, y, sigma, angle, response)
    ]
    ok = torch.as_tensor(np.array(valid, bool), device=device)
    if any(f.shape != ok.shape for f in fields):
        raise ValueError("keypoint fields differ in shape")
    return Keypoints(*fields, ok)


def keypoints_to_numpy(kps: Keypoints) -> Tuple[np.ndarray, ...]:
    """The six fields as numpy arrays, in ``Keypoints`` order."""
    return tuple(a.detach().cpu().numpy() for a in kps)


def affine_from_numpy(affine: np.ndarray, device="cuda") -> torch.Tensor:
    """``(2, 3)`` or ``(N, 2, 3)`` forward affine -> float32 tensor."""
    affine = np.ascontiguousarray(affine, dtype=np.float32)
    if affine.shape[-2:] != (2, 3):
        raise ValueError(f"affine must end in (2, 3), got {affine.shape}")
    return torch.as_tensor(affine, device=device)


def level_state_from_numpy(
    u1: np.ndarray,
    u2: np.ndarray,
    duals: Optional[Sequence[np.ndarray]] = None,
    device="cuda",
) -> torch.Tensor:
    """``(N, H, W)`` flow components (and optionally the four dual arrays
    p11, p12, p21, p22) -> one ``(N, 6, H, W)`` state tensor. Duals default
    to zero, their value at level entry."""
    u1 = np.asarray(u1, np.float32)
    if duals is None:
        duals = [np.zeros_like(u1)] * 4
    if len(duals) != 4:
        raise ValueError("duals must be (p11, p12, p21, p22)")
    planes = [u1, np.asarray(u2, np.float32)] + [
        np.asarray(p, np.float32) for p in duals
    ]
    return torch.as_tensor(np.stack(planes, axis=1), device=device)


def canvas_to_tensor(
    canvas: np.ndarray, h: int, w: int, device="cuda"
) -> torch.Tensor:
    """A padded ``(N, C, Hp, Wp)`` canvas of the JAX package (level state,
    C = 6, or warped arrays, C = 3) -> this package's contiguous
    ``(N, C, h, w)`` float32 tensor: the padding is cut off."""
    canvas = np.asarray(canvas, np.float32)
    if canvas.ndim != 4 or canvas.shape[1] not in (3, 6):
        raise ValueError(f"expected (N, 3 or 6, Hp, Wp), got {canvas.shape}")
    if canvas.shape[2] < h or canvas.shape[3] < w:
        raise ValueError(f"canvas {canvas.shape} is smaller than {(h, w)}")
    return torch.as_tensor(
        np.ascontiguousarray(canvas[:, :, :h, :w]), device=device
    )


def tensor_to_canvas(t: torch.Tensor, hp: int, wp: int) -> np.ndarray:
    """This package's ``(N, C, h, w)`` tensor -> the JAX package's
    ``(N, C, hp, wp)`` float32 canvas, zero-padded below and to the right."""
    arr = t.detach().to("cpu", torch.float32).numpy()
    n, c, h, w = arr.shape
    if hp < h or wp < w:
        raise ValueError(f"canvas {(hp, wp)} is smaller than {(h, w)}")
    out = np.zeros((n, c, hp, wp), np.float32)
    out[:, :, :h, :w] = arr
    return out


def flow_from_numpy(flow: np.ndarray, device="cuda") -> torch.Tensor:
    """``(N, H, W, 2)`` flow array -> float32 tensor of the same layout."""
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    if flow.shape[-1] != 2:
        raise ValueError(f"flow must end in 2 components, got {flow.shape}")
    return torch.as_tensor(flow, device=device)


def flow_to_numpy(flow: torch.Tensor) -> np.ndarray:
    """Flow tensor ``(..., 2)`` (or a ``(u1, u2)`` pair of ``(N, H, W)``
    tensors) -> ``(..., 2)`` float32 numpy array."""
    if isinstance(flow, (tuple, list)):
        flow = torch.stack(list(flow), dim=-1)
    return flow.detach().to("cpu", torch.float32).numpy()
