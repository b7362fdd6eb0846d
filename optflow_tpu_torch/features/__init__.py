from optflow_tpu_torch.features.align import find_alignment
from optflow_tpu_torch.features.detect import fast_keypoints, hessian_keypoints
from optflow_tpu_torch.features.descriptors import orb_descriptors, surf_descriptors
from optflow_tpu_torch.features.match import knn_match2, ratio_filter
from optflow_tpu_torch.features.ransac import find_homography

__all__ = [
    "find_alignment",
    "fast_keypoints",
    "hessian_keypoints",
    "orb_descriptors",
    "surf_descriptors",
    "knn_match2",
    "ratio_filter",
    "find_homography",
]
