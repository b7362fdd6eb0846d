"""Device meshes for the distributed solves.

The reference has no in-process distribution: it scales by sharding the
pair list into job files run as independent cluster containers
(support_scripts/gen_cross_file_list.py:26-27, singularity/janelia_run.sh).
Here distribution is first-class: a :class:`PairMesh` of torch devices with

- a ``pairs`` axis — data parallelism over image pairs (the reference's
  inter-job parallelism, brought in-process), and
- a ``rows`` axis — spatial partitioning of large sections with a halo
  exchange (capability the reference lacks; it downscales instead).

One process drives its local devices, one host thread per device
(:func:`on_devices`). Devices may repeat: ``[torch.device("cpu")] * 8`` is an
8-way mesh on the CPU, ``[torch.device("cuda:0")] * 4`` a 4-way mesh on one
card. Several hosts join with :func:`initialize_multihost` and each solves
its own share of a job on a mesh over its local devices
(``optflow_tpu_torch/cli/run_pod.py``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

AXIS_NAMES = ("pairs", "rows")


class PairMesh:
    """A ``(pairs, rows)`` grid of torch devices: ``devices`` is a 2-D numpy
    array of :class:`torch.device`, ``shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a PairMesh is 2-D, got {devices.ndim}-D")
        self.devices = devices
        self.shape = dict(zip(AXIS_NAMES, devices.shape))


def make_pair_mesh(
    n_pairs_axis: Optional[int] = None,
    n_rows_axis: int = 1,
    devices: Optional[Sequence] = None,
) -> PairMesh:
    """Build a (pairs, rows) mesh over ``devices``, by default every visible
    CUDA device; raises where there is none (a CPU mesh is asked for by
    passing CPU devices). Default layout: all devices on the pairs axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_pair_mesh: no CUDA device is visible; pass devices= "
                "(e.g. [torch.device('cpu')] * n) for a mesh on the CPU"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_pairs_axis is None:
        n_pairs_axis = n // n_rows_axis
    if n_pairs_axis < 1 or n_rows_axis < 1 or n_pairs_axis * n_rows_axis > n:
        raise ValueError(
            f"mesh {n_pairs_axis}x{n_rows_axis} needs more than {n} devices"
        )
    grid = np.empty(n_pairs_axis * n_rows_axis, dtype=object)
    grid[:] = devices[: n_pairs_axis * n_rows_axis]
    return PairMesh(grid.reshape(n_pairs_axis, n_rows_axis))


def pairs_axis_devices(mesh: PairMesh) -> List[torch.device]:
    """One device per index of the ``pairs`` axis (row 0 of the rows axis)."""
    return list(mesh.devices[:, 0])


def rows_axis_devices(mesh: PairMesh) -> List[torch.device]:
    """One device per index of the ``rows`` axis (pairs index 0)."""
    return list(mesh.devices[0, :])


def on_devices(fn: Callable, devices: Sequence[torch.device], *per_device):
    """``[fn(dev, *args_i) for i, dev in enumerate(devices)]`` with one host
    thread per entry; ``per_device`` are sequences with one argument per
    entry. Each call runs with its device current and, on a CUDA device, on
    the stream the calling thread has current there: entries that repeat a
    card share its stream and run on it in the order they enqueue, so two
    whole-card cooperative grids never run at once, while distinct cards
    overlap. An exception in a call re-raises here. CUDA work is enqueued,
    not waited for."""
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
               for d in devices]

    def run(i):
        with _device_context(devices[i], streams[i]):
            return fn(devices[i], *(a[i] for a in per_device))

    if len(devices) == 1:
        return [run(0)]
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=len(devices), thread_name_prefix="device-dispatch"
    ) as pool:
        return list(pool.map(run, range(len(devices))))


def on_shares(fn: Callable, devices: Sequence[torch.device], *batched):
    """Split ``batched`` tensors along their first axis into equal
    contiguous shares, one a device (a batch smaller than the device count
    leaves the last devices out), and return ``[fn(dev, *shares_i)]`` from
    :func:`on_devices`. Each share is copied onto its device in its own
    thread; ``None`` passes through as ``None``."""
    n = batched[0].shape[0]
    per = -(-n // len(devices))
    used = devices[: -(-n // per)]

    def run(dev, d):
        share = slice(d * per, (d + 1) * per)
        return fn(dev, *(None if x is None else x[share].to(dev)
                         for x in batched))

    return on_devices(run, used, range(len(used)))


def _device_context(dev: torch.device, stream):
    if dev.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(dev))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of ``parts`` on the first one's device, added in list order:
    the deterministic counterpart of a ``psum`` over a mesh axis."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join a multi-host job: ``torch.distributed`` on the ``gloo`` backend,
    rendezvous at ``tcp://<coordinator_address>``. No-op when both the
    address and the process count are absent. The hosts exchange only the
    rendezvous and a final barrier (each solves its own pairs), and gloo,
    unlike NCCL, takes several processes on one card."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_multihost needs coordinator_address, num_processes "
            "and process_id together"
        )
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )
