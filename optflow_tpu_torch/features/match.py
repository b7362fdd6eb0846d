"""Descriptor matching as one matrix product.

Replaces cv::cuda::DescriptorMatcher::knnMatch(k=2)
(src/features.cpp:98-101): the full distance matrix is one matmul
(``torch.matmul``, full float32), top-2 nearest neighbors come from two
masked max-reductions, and Lowe's ratio test (src/features.cpp:107-113) is a
vectorized filter. Counterpart of the JAX package's ``features/match.py``.

- float descriptors (SURF-class, L2-normalized): dist^2 = 2 - 2 a.b
- binary descriptors as +/-1 floats (ORB-class): hamming = (D - a.b) / 2

Both are monotone in -a.b, so matching minimizes the negative dot product
and converts for reporting. All functions take ``(K, D)`` descriptor sets or
``(N, K, D)`` batches of pairs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Knn2(NamedTuple):
    idx: torch.Tensor  # (K,) best-match index into descriptor set 1
    dist1: torch.Tensor  # (K,) best distance
    dist2: torch.Tensor  # (K,) second-best distance
    valid: torch.Tensor  # (K,) both rows valid


def knn_match2(
    desc0: torch.Tensor,
    valid0: torch.Tensor,
    desc1: torch.Tensor,
    valid1: torch.Tensor,
    binary: bool = False,
) -> Knn2:
    """k=2 nearest-neighbor match from set 0 into set 1."""
    d = desc0.shape[-1]
    with torch.no_grad():
        dots = torch.matmul(desc0, desc1.transpose(-1, -2))  # (..., K0, K1)
        # invalid columns must never win
        neg = dots.masked_fill(~valid1[..., None, :], -math.inf)

        best, idx = neg.max(dim=-1)  # the first index among equal maxima
        # mask out the best column, find the runner-up
        second = neg.scatter(-1, idx[..., None], -math.inf).amax(dim=-1)

        if binary:
            dist1 = (d - best) * 0.5
            dist2 = (d - second) * 0.5
        else:
            dist1 = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
            dist2 = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0))

        valid = valid0 & torch.isfinite(best) & torch.isfinite(second)
        inf = torch.full_like(dist1, math.inf)
        dist1 = torch.where(valid, dist1, inf)
        dist2 = torch.where(valid, dist2, inf)
    return Knn2(idx=idx, dist1=dist1, dist2=dist2, valid=valid)


def ratio_filter(matches: Knn2, ratio: float) -> torch.Tensor:
    """Lowe ratio test mask: best < ratio * second (ref default 0.8,
    src/features.cpp:109)."""
    return matches.valid & (matches.dist1 < ratio * matches.dist2)
