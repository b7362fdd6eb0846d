"""The image loader's frames on a machine without the image libraries.

``frame.cpp`` (stem ``frame``) holds the resize and the TIFF luma of
``loader.cpp`` statement for statement and includes no image header, so it
builds wherever the host compiler does. :func:`load` decodes a file with cv2
and hands the samples over: PNG and JPEG through cv2's gray decode (which
equals libpng's and libjpeg's gray in the loader; EXIF orientation ignored,
as the loader ignores it), TIFF as its samples, which the library reduces
by libtiff's rules and the loader's luma. So its frames, shapes included, are
the loader's bit for bit. The prefetch loader takes this route where the
loader itself cannot be built (``PrefetchLoader.decoder ==
"native-resize"``).

:func:`available` is False only where there is no host compiler or no cv2.
Where the compiler is there and the library does not build or load, it
raises with the compiler's message: such a machine never drops to cv2's
resize.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from optflow_tpu_torch.core.imgio import ImageReadError, _get_cv2

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_no_compiler = False
_lock = threading.Lock()

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built if it is not yet; None when it cannot be
    (the reason stays in :func:`build_error`). A library on disk that does
    not load (one built on another machine) is built once more first
    (``_build.load_library``). Not retried within the process."""
    global _lib, _error, _no_compiler
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        from optflow_tpu_torch.ops import _build

        try:
            _build.find_cxx()
        except RuntimeError as e:
            _error, _no_compiler = str(e), True
            return None
        try:
            lib = _build.load_library("frame")
        except (RuntimeError, OSError) as e:
            _error = str(e)
            return None
        lib.ofr_scaled_size.restype = None
        lib.ofr_scaled_size.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ofr_gray_u8.restype = ctypes.c_int
        lib.ofr_gray_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.ofr_tiff.restype = ctypes.c_int
        lib.ofr_tiff.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether this route runs here: cv2 is installed and the library builds
    and loads. False where cv2 or the host compiler is missing; raises
    ``RuntimeError`` with the compiler's (or the dynamic loader's) message
    where the compiler is there and the library fails."""
    if _get_cv2() is None:
        return False
    if _load() is not None:
        return True
    if _no_compiler:
        return False
    raise RuntimeError(f"the frame library did not build: {_error}")


def build_error() -> Optional[str]:
    """Why the library is not loaded, else None."""
    _load()
    return _error


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the frame library did not build: {_error}")
    return lib


def scaled_shape(h: int, w: int, scale: float) -> Tuple[int, int]:
    """The frame's shape at ``scale``: each side's float product rounded
    half away from zero (``std::lround``), as the loader sizes it."""
    oh, ow = ctypes.c_int(), ctypes.c_int()
    _library().ofr_scaled_size(h, w, scale, ctypes.byref(oh),
                               ctypes.byref(ow))
    return oh.value, ow.value


def _resize(fn, samples: np.ndarray, scale: float, *args) -> np.ndarray:
    samples = np.ascontiguousarray(samples)
    h, w = samples.shape[:2]
    out = np.empty(scaled_shape(h, w, scale), np.float32)
    if fn(samples.ctypes.data, h, w, *args, scale, out.ctypes.data) != 0:
        raise ImageReadError(
            f"samples the loader does not take: {samples.dtype}, "
            f"shape {samples.shape}")
    return out


def _gray_frame(gray: np.ndarray, scale: float) -> np.ndarray:
    """A uint8 gray image resized as the loader resizes, float32."""
    return _resize(_library().ofr_gray_u8, gray.astype(np.uint8, copy=False),
                   scale)


def _tiff_frame(samples: np.ndarray, scale: float) -> np.ndarray:
    """A TIFF's samples as cv2 reads them unchanged (gray, BGR or BGRA; 8 or
    16 bits), reduced to the loader's gray and resized, float32."""
    bits = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(samples.dtype)
    channels = 1 if samples.ndim == 2 else samples.shape[2]
    if bits is None:
        raise ImageReadError(f"TIFF samples of {samples.dtype}: the loader "
                             "reads 8 and 16 bits only")
    return _resize(_library().ofr_tiff, samples, scale, channels, bits)


def _png_header(f) -> Tuple[int, int, Optional[bytes]]:
    """(colour type, bit depth, tRNS payload or None) from the chunks before
    the first IDAT."""
    color = depth = -1
    trns = None
    f.seek(len(_PNG_MAGIC))
    while True:
        head = f.read(8)
        if len(head) < 8:
            break
        length, kind = struct.unpack(">I4s", head)
        if kind == b"IDAT":
            break
        data = f.read(length)
        f.seek(4, 1)  # the chunk's CRC
        if kind == b"IHDR" and length >= 10:
            depth, color = data[8], data[9]
        elif kind == b"tRNS":
            trns = data
    # libpng keeps a tRNS chunk only for these colour types and lengths
    if not ((color == 0 and len(trns or b"") == 2)
            or (color == 2 and len(trns or b"") == 6)
            or (color == 3 and trns)):
        trns = None
    return color, depth, trns


def _png_with_trns(cv2, path: str, gray: np.ndarray, color: int, depth: int,
                   trns: bytes) -> np.ndarray:
    """The loader's frame of a PNG with a tRNS chunk. ``loader.cpp:78-79``
    turns tRNS into an alpha channel but strips alpha only where the file's
    colour type has one, so that alpha stays: its rows are gray, alpha,
    gray, alpha ... and it reads their first ``w`` bytes as the row."""
    h, w = gray.shape
    samples = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if samples is None:
        raise ImageReadError(path)
    if color == 0:  # transparent where the sample equals the tRNS gray
        key = struct.unpack(">H", trns)[0]
        if depth < 8:  # cv2 expands 1-, 2- and 4-bit samples to 0..255
            key *= 255 // (2 ** depth - 1)
        alpha = np.where(samples == key, 0, 255).astype(np.uint8)
    elif samples.ndim == 3 and samples.shape[2] == 4:
        alpha = samples[..., 3]
        if alpha.dtype == np.uint16:  # the loader strips 16 bits to 8
            alpha = (alpha >> 8).astype(np.uint8)
    else:
        raise ImageReadError(f"{path}: no alpha decoded for its tRNS chunk")
    rows = np.empty((h, 2 * w), np.uint8)
    rows[:, 0::2] = gray
    rows[:, 1::2] = alpha
    return rows[:, :w]


def load(path: str, scale: float) -> np.ndarray:
    """The loader's float32 frame of a PNG, JPEG or TIFF file at ``scale``.
    Raises ``ImageReadError`` for a file cv2 cannot read, for another format
    and for samples the loader does not take (the prefetch loader then
    decodes it with the Python decoder, as it does for the loader)."""
    cv2 = _get_cv2()
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
            png = magic[:2] == _PNG_MAGIC[:2]
            color, depth, trns = _png_header(f) if png else (-1, -1, None)
    except OSError as e:
        raise ImageReadError(path) from e
    if magic[:3] == b"II*" or (magic[:2] == b"MM" and magic[3:] == b"*"):
        samples = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if samples is None or samples.size == 0:
            raise ImageReadError(path)
        return _tiff_frame(samples, scale)
    if not (png or magic[:2] == b"\xff\xd8"):
        raise ImageReadError(f"{path}: not a PNG, JPEG or TIFF file")
    gray = cv2.imread(path,
                      cv2.IMREAD_GRAYSCALE | cv2.IMREAD_IGNORE_ORIENTATION)
    if gray is None or gray.size == 0:
        raise ImageReadError(path)
    if trns is not None:
        gray = _png_with_trns(cv2, path, gray, color, depth, trns)
    return _gray_frame(gray, scale)
