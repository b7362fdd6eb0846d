"""The shared-memory capacity probe on the GPU: wrapper of the hand-written
CUDA kernel (``csrc/smem_cap.cu``) and its plain PyTorch version.

:func:`smem_fill_mean` asks for ``n_bytes`` of a thread block's dynamic
shared memory, fills it with a value read from device memory, sums it in a
fixed order and returns the mean, with the CUDA status of the request and of
the launch. A size the card refuses is the probe's RESULT (a non-zero
status), not an exception; every other failure raises. The kernel's own
time, by two CUDA events around the launch, is :func:`last_kernel_ms`. The
tool ``python -m optflow_tpu_torch.tools.smem_cap`` walks the sizes.

On a CUDA device the wrapper launches the kernel or raises; on the CPU it
takes :func:`smem_fill_mean_plain`. The library is compiled at the first CUDA
call (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from optflow_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None


class ProbeStatus(NamedTuple):
    """CUDA status codes of one probe (0 = success, -1 = step not reached):
    the request for the shared memory, the launch, the wait for the kernel."""

    attribute: int
    launch: int
    sync: int

    @property
    def ok(self) -> bool:
        return self.attribute == 0 and self.launch == 0 and self.sync == 0


class DeviceSharedMemory(NamedTuple):
    optin_per_block: int  # cudaDevAttrMaxSharedMemoryPerBlockOptin
    per_multiprocessor: int  # cudaDevAttrMaxSharedMemoryPerMultiprocessor
    multiprocessors: int  # cudaDevAttrMultiProcessorCount
    default_per_block: int  # cudaDevAttrMaxSharedMemoryPerBlock
    clock_khz: int  # cudaDevAttrClockRate


def _library() -> ctypes.CDLL:
    global _lib
    with _build.lock:
        if _lib is None:
            lib = _build.load_library("smem_cap")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.smem_fill_mean.argtypes = [ctypes.c_longlong, ptr, ptr, i32,
                                           i32, i32, ptr, ptr, ptr]
            lib.smem_fill_mean.restype = i32
            lib.smem_occupancy.argtypes = [ctypes.c_longlong, i32]
            lib.smem_occupancy.restype = i32
            lib.smem_device_attrs.argtypes = [ptr]
            lib.smem_device_attrs.restype = i32
            lib.smem_cap_error_string.argtypes = [i32]
            lib.smem_cap_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    """The CUDA runtime's name for a status code of :class:`ProbeStatus`."""
    if code == 0:
        return "no error"
    if code < 0:
        return "not reached"
    return _library().smem_cap_error_string(code).decode()


def _check(n_bytes: int, blocks: int, threads: int) -> None:
    if n_bytes % 4 != 0 or n_bytes < 128:
        raise ValueError(f"n_bytes must be a multiple of 4, >= 128: {n_bytes}")
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"threads must be a multiple of 32 up to 1024: {threads}")


def smem_fill_mean_plain(
    n_bytes: int, x: Union[float, torch.Tensor], blocks: int = 1
) -> Tuple[ProbeStatus, torch.Tensor]:
    """Plain PyTorch version of :func:`smem_fill_mean`: the mean of
    ``n_bytes // 4`` copies of ``x``, once per block, on ``x``'s device (the
    CPU for a float). Nothing can be refused: the status is all zeros."""
    _check(n_bytes, blocks, 32)
    x = torch.as_tensor(x, dtype=torch.float32).reshape(())
    count = n_bytes // 4
    mean = torch.full((count,), float(x), dtype=torch.float32,
                      device=x.device).sum() / count
    return ProbeStatus(0, 0, 0), mean.repeat(blocks)


@_build.counted_launches
def smem_fill_mean(
    n_bytes: int,
    x: Union[float, torch.Tensor],
    blocks: int = 1,
    *,
    threads: int = 1024,
    cooperative: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Tuple[ProbeStatus, Optional[torch.Tensor]]:
    """Fill ``n_bytes`` of a block's dynamic shared memory with ``x`` and
    return ``(status, means)``: ``means`` is ``(blocks,)`` float32, each
    block's mean of what it filled, or None when the card refused the size
    (``status.ok`` false; the codes say where).

    ``x`` is a float (placed on ``device``, default ``"cuda"``) or a one-
    element float32 tensor, whose device decides. ``cooperative`` launches
    the grid so that the runtime refuses it unless all ``blocks`` can be
    resident at once.

    On a CUDA device this launches the kernel and waits for it
    (``smem_fill_mean.launches`` counts the launches that ran; the
    kernel's milliseconds are :func:`last_kernel_ms`) or raises; on the CPU
    it takes the plain version. The size attribute is only set when the size
    differs from the last one granted."""
    if isinstance(x, torch.Tensor):
        xt = x.to(torch.float32).reshape(1).contiguous()
    else:
        xt = torch.full((1,), float(x), dtype=torch.float32,
                        device=torch.device(device or "cuda"))
    if not xt.is_cuda:
        return smem_fill_mean_plain(n_bytes, xt, blocks)
    _check(n_bytes, blocks, threads)
    lib = _library()
    dev = xt.device
    status = (ctypes.c_int * 3)(-1, -1, -1)
    kernel_ms = ctypes.c_float(float("nan"))
    with torch.cuda.device(dev):
        means = torch.empty(blocks, dtype=torch.float32, device=dev)
        code = lib.smem_fill_mean(
            n_bytes, xt.data_ptr(), means.data_ptr(), blocks, threads,
            int(cooperative), ctypes.addressof(status),
            ctypes.addressof(kernel_ms),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"smem_fill_mean: CUDA error {code}: {error_string(code)}"
        )
    result = ProbeStatus(*status)
    if result.launch == 0:
        smem_fill_mean.count_launch(work=kernel_ms.value)
    if result.launch == 0 and result.sync != 0:
        # the kernel started and failed: a fault, not a refusal
        raise RuntimeError(
            f"smem_fill_mean: the kernel failed: {error_string(result.sync)}"
        )
    return result, (means if result.ok else None)


def last_kernel_ms() -> Optional[float]:
    """Milliseconds between the CUDA events recorded on the stream before
    and after the kernel of this thread's last :func:`smem_fill_mean` that
    launched one (NaN where it did not finish; None before the first): the
    kernel with its launch latency on the card, not the call's host round
    trip."""
    return smem_fill_mean.last_work


def occupancy(n_bytes: int, threads: int = 1024,
              device: Union[str, torch.device] = "cuda") -> int:
    """Blocks of ``threads`` threads with ``n_bytes`` of dynamic shared
    memory that the CUDA runtime says fit one multiprocessor at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    with torch.cuda.device(torch.device(device)):
        got = _library().smem_occupancy(n_bytes, threads)
    if got < 0:
        raise RuntimeError(
            f"smem_occupancy: CUDA error {-1 - got}: {error_string(-1 - got)}"
        )
    return got


def device_shared_memory(
    device: Union[str, torch.device] = "cuda"
) -> DeviceSharedMemory:
    """The shared-memory limits, the multiprocessor count and the clock the
    CUDA runtime reports for ``device``."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(torch.device(device)):
        code = _library().smem_device_attrs(ctypes.addressof(out))
    if code != 0:
        raise RuntimeError(
            f"smem_device_attrs: CUDA error {code}: {error_string(code)}"
        )
    return DeviceSharedMemory(*out)
