from optflow_tpu_torch.align.global_solve import (
    AlignmentResult,
    solve_affine_alignment,
    solve_translation_alignment,
)
from optflow_tpu_torch.align.average_flow import average_flow_job

__all__ = [
    "AlignmentResult",
    "solve_affine_alignment",
    "solve_translation_alignment",
    "average_flow_job",
]
