from optflow_tpu_torch.ops.warp import (
    centered_gradient,
    divergence,
    forward_gradient,
    warp_backward,
)
from optflow_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes, resize_bilinear
from optflow_tpu_torch.ops.tvl1 import (
    default_level_solver,
    tvl1_flow,
    tvl1_flow_batched,
    tvl1_flow_level,
)

__all__ = [
    "centered_gradient",
    "divergence",
    "forward_gradient",
    "warp_backward",
    "build_pyramid",
    "pyramid_shapes",
    "resize_bilinear",
    "default_level_solver",
    "tvl1_flow",
    "tvl1_flow_batched",
    "tvl1_flow_level",
]
