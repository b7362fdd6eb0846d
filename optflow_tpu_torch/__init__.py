"""optflow_tpu_torch — the PyTorch/CUDA port of the dense optical-flow and
section-alignment engine, for NVIDIA Hopper GPUs.

Same sub-package layout and module names as the JAX package it is ported
from, so a reader finds each counterpart (``core``, ``ops``, ``engine``,
``sinks``, ``utils``, ``cli``), plus ``csrc`` for the CUDA sources. Plain
tensor code is PyTorch; the TV-L1 level solve is hand-written CUDA: the
level kernel (``ops/tvl1_cuda.py``, ``csrc/tvl1_level.cu``), the blocked
kernel for the large levels of full sections (``ops/tvl1_blocked_cuda.py``,
``csrc/tvl1_blocked.cu``) and the chunk kernel behind the per-level API
(``ops/tvl1_chunk_cuda.py``, ``csrc/tvl1_chunk.cu``). Entry points take an
explicit ``device`` that defaults to ``"cuda"``.
"""

__version__ = "0.1.0"

from optflow_tpu_torch.core.config import JobConfig, TVL1Params, cfg_get, load_job
from optflow_tpu_torch.ops.tvl1 import (
    default_level_solver,
    tvl1_flow,
    tvl1_flow_batched,
)

__all__ = [
    "JobConfig",
    "TVL1Params",
    "cfg_get",
    "load_job",
    "default_level_solver",
    "tvl1_flow",
    "tvl1_flow_batched",
    "__version__",
]
