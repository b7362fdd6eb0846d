"""Sharded pair scheduler: data parallelism over image pairs.

The in-process equivalent of the reference's job-file sharding (5000 pairs
per file across cluster nodes, gen_cross_file_list.py:26-27): pairs of the
same shape are bucketed, padded to a multiple of the mesh's ``pairs`` axis
with zero frames, batched with a leading dimension, and each pairs-axis
device solves its sub-batch with the batched solver
(``ops.tvl1.tvl1_flow_batched``: on CUDA tensors the level kernels). The
padding's flows are dropped.

Pure data parallelism needs no collective: each device gets its sub-batch
copied onto it and the solve enqueued from a thread of its own
(``dist.mesh.on_devices``). Dispatch is pipelined: every chunk is enqueued
before any result is read back, so the host prepares chunk k+1 while the
devices solve chunk k.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.dist.mesh import PairMesh, on_shares, pairs_axis_devices
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched


# Per-device memory the chunk sizing plans for, as the JAX scheduler's
# default budget (optflow_tpu/dist/scheduler.py)
HBM_BUDGET_BYTES = 8 << 30


class PairScheduler:
    """Batches same-shape pairs and solves them data-parallel over the
    mesh's ``pairs`` axis."""

    def __init__(self, mesh: PairMesh, params: TVL1Params = TVL1Params()):
        self.mesh = mesh
        self.params = params

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["pairs"]

    def _chunk_pairs(self, shape: Tuple[int, int]) -> int:
        """Pairs per dispatch: what fits the per-device memory budget (~40
        level-state arrays per pair is a safe envelope for the
        coarse-to-fine solve + pipelining headroom), at most 256, rounded
        up to a multiple of the pairs axis."""
        per_pair = 40 * shape[0] * shape[1] * 4
        n = max(1, int(HBM_BUDGET_BYTES // per_pair)) * self.n_shards
        n = min(n, 256)
        return -(-n // self.n_shards) * self.n_shards

    def _dispatch(self, i0s: np.ndarray, i1s: np.ndarray) -> List[torch.Tensor]:
        """Enqueue the solve of a padded chunk, an equal share on each
        pairs-axis device; returns each device's flows, not waited for."""
        return on_shares(
            lambda dev, a, b: tvl1_flow_batched(a, b, self.params),
            pairs_axis_devices(self.mesh), torch.from_numpy(i0s),
            torch.from_numpy(i1s),
        )

    def solve_pairs(
        self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
    ) -> List[np.ndarray]:
        """Solve a list of (i0, i1) pairs; returns ``(H, W, 2)`` flows in
        input order.

        Pairs are grouped by shape; each group is padded up to a multiple
        of the pairs-axis size (zero frames solve to zero flow and are
        dropped). Every chunk is enqueued before any result is read back."""
        by_shape: Dict[Tuple[int, int], List[int]] = collections.defaultdict(
            list
        )
        for i, (a, b) in enumerate(pairs):
            if a.shape != b.shape:
                raise ValueError(
                    f"pair {i}: frames of shapes {a.shape} and {b.shape}"
                )
            by_shape[a.shape].append(i)

        results: List[Optional[np.ndarray]] = [None] * len(pairs)
        n_sh = self.n_shards
        in_flight = []
        for shape, idxs in by_shape.items():
            chunk_size = self._chunk_pairs(shape)
            for start in range(0, len(idxs), chunk_size):
                chunk = idxs[start: start + chunk_size]
                padded = -(-len(chunk) // n_sh) * n_sh
                i0s = np.zeros((padded,) + shape, np.float32)
                i1s = np.zeros((padded,) + shape, np.float32)
                for j, k in enumerate(chunk):
                    i0s[j] = pairs[k][0]
                    i1s[j] = pairs[k][1]
                in_flight.append((chunk, self._dispatch(i0s, i1s)))

        for chunk, parts in in_flight:
            flows = np.concatenate([p.cpu().numpy() for p in parts])
            for j, k in enumerate(chunk):
                results[k] = flows[j]
        return results
