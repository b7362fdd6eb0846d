"""Distribution over devices: the pair scheduler (data parallelism over
pairs) and the row-tiled halo solve of one section."""

from optflow_tpu_torch.dist.mesh import make_pair_mesh
from optflow_tpu_torch.dist.scheduler import PairScheduler
from optflow_tpu_torch.dist.tiled import tiled_tvl1_flow

__all__ = ["make_pair_mesh", "PairScheduler", "tiled_tvl1_flow"]
