"""Host-side image I/O: grayscale decode, scaling, float TIFF read/write.

The reference decodes on the CPU with ``cv::imread(IMREAD_GRAYSCALE)`` and
scales with ``cv::resize`` (src/optflow.cpp:106-125) before uploading to the
GPU; flow/map outputs are written as one float32 TIFF per component
(src/optflow.cpp:478-484). Here decode/resize stay on the host and the
device side consumes float32 arrays in the 0..255 intensity range (OpenCV
convention, no normalization).

Neither decoder is imported when this module is: ``cv2`` is tried first and
``PIL`` second at the first call that needs one, so the package imports on a
machine that has neither (jobs whose frames come from a caller's ``loader=``
never decode).
"""

from __future__ import annotations

import os

import numpy as np

_UNSET = object()
_cv2 = _UNSET
_pil_image = _UNSET


def _get_cv2():
    """The ``cv2`` module, or None when it is not installed."""
    global _cv2
    if _cv2 is _UNSET:
        try:
            import cv2

            _cv2 = cv2
        except ImportError:
            _cv2 = None
    return _cv2


def _get_pil():
    """The ``PIL.Image`` module, or None when it is not installed."""
    global _pil_image
    if _pil_image is _UNSET:
        try:
            from PIL import Image

            _pil_image = Image
        except ImportError:
            _pil_image = None
    return _pil_image


def decoder_name() -> str | None:
    """Which image library the I/O functions will use: "cv2", "PIL" or None."""
    if _get_cv2() is not None:
        return "cv2"
    if _get_pil() is not None:
        return "PIL"
    return None


def _require_pil():
    pil = _get_pil()
    if pil is None:
        raise ImportError(
            "image I/O needs cv2 or PIL; neither is installed (pass loader= "
            "to the runner to serve frames from memory)"
        )
    return pil


class ImageReadError(RuntimeError):
    """Raised when an image fails to decode (bad/missing file).

    The reference logs and skips the pair (src/optflow.cpp:108-112,120-124);
    the engine catches this and does the same.
    """


def read_gray(path: str) -> np.ndarray:
    """Read an image as uint8 grayscale (ref: cv::imread IMREAD_GRAYSCALE)."""
    cv2 = _get_cv2()
    if cv2 is not None:
        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if im is None or im.size == 0:
            raise ImageReadError(path)
        return im
    pil = _require_pil()
    try:
        with pil.open(path) as pim:
            return np.asarray(pim.convert("L"))
    except (OSError, ValueError) as e:
        raise ImageReadError(path) from e


def resize_scale(im: np.ndarray, scale: float) -> np.ndarray:
    """Uniform rescale with bilinear sampling (ref: cv::resize default
    INTER_LINEAR, src/optflow.cpp:113,125). ``scale == 1`` is a no-op."""
    if scale == 1:
        return im
    cv2 = _get_cv2()
    if cv2 is not None:
        return cv2.resize(im, None, fx=scale, fy=scale)
    pil = _require_pil()
    h, w = im.shape[:2]
    new_w = int(round(w * scale))
    new_h = int(round(h * scale))
    with pil.fromarray(im) as pim:
        return np.asarray(pim.resize((new_w, new_h), pil.BILINEAR))


def read_gray_scaled(path: str, scale: float) -> np.ndarray:
    """Decode + rescale, returned as float32 (0..255): the Python decoder's
    frame, what a job decodes where no native route runs."""
    return resize_scale(read_gray(path), scale).astype(np.float32)


def write_float_tiff(path: str, arr: np.ndarray) -> None:
    """Write a float32 single-channel TIFF (ref: cv::imwrite of CV_32FC1,
    src/optflow.cpp:482-483)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2 = _get_cv2()
    if cv2 is not None:
        ok = cv2.imwrite(path, arr)
        if not ok:
            raise OSError(f"failed to write {path}")
        return
    _require_pil().fromarray(arr, mode="F").save(path)


def read_float_tiff(path: str) -> np.ndarray:
    """Read a float32 TIFF written by :func:`write_float_tiff` (or the
    reference binary)."""
    cv2 = _get_cv2()
    if cv2 is not None:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise ImageReadError(path)
        return arr.astype(np.float32)
    with _require_pil().open(path) as pim:
        return np.asarray(pim, dtype=np.float32)
