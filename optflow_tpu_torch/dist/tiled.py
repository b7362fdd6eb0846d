"""Tiled large-section TV-L1 over the ``rows`` mesh axis.

Capability beyond the reference, which handles large sections only by
downscaling (scale=0.5, src/optflow.cpp:92) or strip ROIs: here a section
is partitioned into row blocks across devices. Each device solves a
halo-extended window that is a TRUE SLICE of the global image — windows
are clamped at the image edges (shifted inward), so boundary devices see
the real image boundary and apply exactly the monolithic solver's boundary
conditions. Away from the image edges the halo bounds the information reach
of the coarse-to-fine solve (:func:`default_halo`), making the stitched
field match the monolithic solve to the numerical level at every row
including seams.

Exchange: one process drives the rows-axis devices, and block ``d`` of the
section lives on device ``d``. The NEIGHBOUR RING copies the last ``2*halo``
rows of block ``d-1`` and the first ``2*halo`` rows of block ``d+1`` onto
device ``d`` (``Tensor.to(dev, non_blocking=True)``), O(halo * W) per
device instead of the O(H * W) of the gather fallback, which copies the
whole frame to every device. The window a device assembles is a true slice
of the global image either way: boundary devices' clamped windows reach
``2*halo`` rows into their single neighbour, which is exactly what the ring
provides. When blocks are too thin for one-hop assembly (2*halo > block),
the solve takes the gather path. Each window is then solved on its device
by ``ops.tvl1.tvl1_flow`` (on CUDA tensors the level kernels), one host
thread per device.

Flow-magnitude contract: the halo is sized for |flow| <= max_flow; a
solved flow beyond it could legitimately depend on pixels outside the
halo. Such pixels are clamped to +/-max_flow AND counted —
:func:`get_last_clip_fraction` reports the clipped fraction of the last
solve on the calling thread, and ``strict=True`` raises instead of silently
degrading.
"""

from __future__ import annotations

import threading
import warnings
from typing import Optional

import numpy as np
import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.dist.mesh import PairMesh, on_devices, rows_axis_devices
from optflow_tpu_torch.ops.pyramid import pyramid_shapes
from optflow_tpu_torch.ops.tvl1 import tvl1_flow


def default_halo(
    params: TVL1Params, max_flow: float = 8.0, h: int = 1 << 30,
    w: int = 1 << 30,
) -> int:
    """Halo rows needed for the extended-window solve to match the
    monolithic solve away from seams.

    Each device solves its own coarse-to-fine problem on a halo-extended
    window; the halo must stay informative at the COARSEST level, where
    its width has shrunk by scale_step^(L-1). Two effects bound the
    required finest-level width:

    - backward warping samples up to |flow_level| = max_flow * s^l pixels
      outside a pixel's position — in finest-level units that is max_flow
      at every level;
    - the primal-dual stencils propagate one pixel per iteration but the
      dual field is strongly damped (p <- p / (1 + taut |grad u|)); an
      effective reach of ~4 px covers it to well under 0.1 px of seam
      error — in finest-level units 4 / s^(L-1) at the coarsest level.

    halo = ceil(max_flow + 4 / scale_step^(L-1)), rounded up to 8 rows.
    For the reference's 10-level/0.8 pyramid and FIB-SEM-scale flows
    (<= 8 px) this gives 40 rows.
    """
    levels = len(pyramid_shapes(h, w, params.nscales, params.scale_step))
    reach = 4.0 / (params.scale_step ** max(levels - 1, 0))
    need = int(np.ceil(max_flow + reach))
    return -(-need // 8) * 8


class _ClipTelemetry(threading.local):
    """What the last tiled solve on this thread clamped (a scalar tensor on
    the first rows device: reading it waits for the solve) and how many
    rows its halo was shrunk by."""

    def __init__(self):
        self.fraction = None
        self.halo_shortfall = 0


_clip_telemetry = _ClipTelemetry()


def get_last_halo_shortfall() -> int:
    """Rows by which the last :func:`tiled_tvl1_flow` on this thread had
    to SHRINK the halo below the requested/derived size because the
    extended window must fit inside the image (short images with many
    row shards). Non-zero means seam quality is no longer covered by the
    :func:`default_halo` correctness argument."""
    return int(_clip_telemetry.halo_shortfall)


def get_last_clip_fraction() -> float:
    """Fraction of flow values the last :func:`tiled_tvl1_flow` on this
    thread clamped to +/-max_flow (0.0 when the contract held everywhere,
    or when no tiled solve ran yet). Reading waits for that solve."""
    if _clip_telemetry.fraction is None:
        return 0.0
    return float(_clip_telemetry.fraction)


def tiled_tvl1_flow(
    i0,
    i1,
    params: TVL1Params,
    mesh: PairMesh,
    halo: Optional[int] = None,
    max_flow: Optional[float] = 8.0,
    strict: bool = False,
    neighbor_exchange: Optional[bool] = None,
) -> torch.Tensor:
    """Solve TV-L1 over a section sharded by rows across the mesh's ``rows``
    axis.

    i0, i1: (H, W) float32 arrays or tensors, H divisible by the rows-axis
      size.
    halo: extended-window rows per side; default :func:`default_halo`
      (derived from scale_step and ``max_flow``).
    max_flow: when set, the solved flow is clamped to this magnitude —
      the halo-validity contract (a flow exceeding it could legitimately
      depend on pixels beyond the halo). None disables the clamp.
    strict: raise ValueError when any flow value violates the max_flow
      contract, instead of silently clamping (waits for the solve).
    neighbor_exchange: force the neighbour ring (True) or the gather
      fallback (False); default picks the ring whenever one-hop assembly
      is possible (2 * halo <= block and > 1 device).
    Returns the stitched (H, W, 2) flow on the first rows-axis device.
    """
    devices = rows_axis_devices(mesh)
    n_rows = len(devices)
    i0 = torch.as_tensor(i0, dtype=torch.float32)
    i1 = torch.as_tensor(i1, dtype=torch.float32)
    h, w = i0.shape
    if h % n_rows:
        raise ValueError(f"H={h} must divide by rows axis {n_rows}")
    block = h // n_rows
    if halo is None:
        halo = default_halo(params, max_flow or 8.0, h, w)
    # The extended window must fit inside the image; on short images
    # with many row shards this SHRINKS the halo below the
    # correctness-derived size — the seam-error argument of
    # default_halo no longer covers the solve, so surface it
    # (warn; raise under strict) instead of degrading silently.
    halo_fit = min(halo, (h - block) // 2)
    _clip_telemetry.halo_shortfall = halo - halo_fit
    if halo_fit < halo:
        msg = (
            f"tiled_tvl1_flow: halo shrunk {halo} -> {halo_fit} rows so "
            f"the extended window fits H={h} with {n_rows} row shards; "
            f"seam accuracy is no longer covered by the halo contract. "
            f"Use fewer row shards or a shorter pyramid."
        )
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    halo = halo_fit
    win = block + 2 * halo
    # halo == 0 must NOT take the ring (a tail of 0 rows is no exchange),
    # and 2*halo > block must not either: the ring brings only 2*halo rows
    # of each neighbour, fewer than a clamped window can need.
    if neighbor_exchange is None:
        neighbor_exchange = n_rows > 1 and 0 < 2 * halo <= block
    elif neighbor_exchange and not (0 < 2 * halo <= block):
        warnings.warn(
            f"tiled_tvl1_flow: neighbor_exchange=True demoted to "
            f"all_gather (halo={halo}, block={block}: one-hop ring "
            f"assembly needs 0 < 2*halo <= block)",
            RuntimeWarning,
            stacklevel=2,
        )
        neighbor_exchange = False

    # window start of device d, clamped into the image; its own block
    # lies at offset d*block - start of the window (halo for interior
    # devices, 0 / 2*halo at the clamped edges)
    starts = [min(max(d * block - halo, 0), h - win) for d in range(n_rows)]

    def window_ring(blocks, d):
        # [prev_tail | own | next_head] covers global rows
        # [d*block - 2h, (d+1)*block + 2h), a superset of every clamped
        # window position; an edge device's missing neighbour is zeros
        # that its clamped window never reads
        e = 2 * halo
        dev = devices[d]
        own = blocks[d]
        prev_tail = (blocks[d - 1][-e:].to(dev, non_blocking=True) if d > 0
                     else own.new_zeros((e, w)))
        next_head = (blocks[d + 1][:e].to(dev, non_blocking=True)
                     if d < n_rows - 1 else own.new_zeros((e, w)))
        ext = torch.cat([prev_tail, own, next_head])
        off = starts[d] - (d * block - e)
        return ext[off: off + win]

    def window_gather(blocks, d):
        full = torch.cat([b.to(devices[d], non_blocking=True)
                          for b in blocks])
        return full[starts[d]: starts[d] + win]

    window = window_ring if neighbor_exchange else window_gather
    blocks0 = [i0[d * block: (d + 1) * block].to(dev)
               for d, dev in enumerate(devices)]
    blocks1 = [i1[d * block: (d + 1) * block].to(dev)
               for d, dev in enumerate(devices)]
    ext0 = [window(blocks0, d).contiguous() for d in range(n_rows)]
    ext1 = [window(blocks1, d).contiguous() for d in range(n_rows)]

    def solve_window(dev, d, a, b):
        flow = tvl1_flow(a, b, params)
        off = d * block - starts[d]
        out = flow[off: off + block]
        # clip telemetry + clamp on the device's OWN block rows only —
        # clamped values living in discarded halo rows neither reach the
        # stitched output nor should trip strict mode
        if max_flow is None:
            return out, None
        clipped = (out.abs() > max_flow).to(torch.float32).mean()
        return out.clamp(-max_flow, max_flow), clipped

    parts = on_devices(solve_window, devices, range(n_rows), ext0, ext1)
    first = devices[0]
    flow = torch.cat([p[0].to(first) for p in parts])
    if max_flow is None:
        clip_frac = torch.zeros((), dtype=torch.float32, device=first)
    else:
        # the pmean over the rows axis: every block has block x w x 2 values
        clip_frac = torch.stack([p[1].to(first) for p in parts]).mean()
    _clip_telemetry.fraction = clip_frac
    if strict and max_flow is not None:
        frac = float(clip_frac)
        if frac > 0.0:
            raise ValueError(
                f"tiled_tvl1_flow: {frac:.2%} of flow values exceed the "
                f"max_flow={max_flow} halo contract; re-run with a larger "
                f"halo/max_flow or strict=False to clamp"
            )
    return flow
