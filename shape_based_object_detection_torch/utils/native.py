"""Build and load the port's native libraries from ``csrc/``.

The CUDA kernels (``*.cu``) are compiled with ``nvcc``, the host C++ of the
eval and data paths (``ap_matcher.cpp``, the AP matcher; ``jpeg_decoder.cpp``,
the fused JPEG decode and resize) with ``g++``; each into a shared library
with a plain C interface, bound with ctypes. A build runs at first use into
``_build/`` beside this package (git-ignored). A library's file name carries
a hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded. A failed build raises: there is no fallback. (Only
``utils.image.effective_decode_backend("auto")`` resolves to PIL when the
JPEG decoder does not build, as the reference's ``"auto"`` does.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false: the kernels must reproduce the plain versions' float rounding
# bit for bit, and nvcc would otherwise contract a*b+c into one FMA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

# the reference's g++ command for its host libraries
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# host sources and the libraries each links
HOST_SOURCES = {"ap_matcher": (), "jpeg_decoder": ("-ljpeg",)}

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels are built from source at "
        "first use and need the CUDA toolkit")


def _source(name: str) -> Tuple[Path, list]:
    """``csrc/<name>.cpp`` (g++) or ``csrc/<name>.cu`` (nvcc), and the
    compiler's command before its output and source."""
    if name in HOST_SOURCES:
        return CSRC_DIR / f"{name}.cpp", ["g++", *GXX_FLAGS]
    return CSRC_DIR / f"{name}.cu", [find_nvcc(), *NVCC_FLAGS]


def library_path(name: str) -> Path:
    """Where library ``name`` is built: keyed by a hash of the source and
    the flags."""
    flags = GXX_FLAGS + HOST_SOURCES[name] if name in HOST_SOURCES else NVCC_FLAGS
    suffix = ".cpp" if name in HOST_SOURCES else ".cu"
    src = (CSRC_DIR / f"{name}{suffix}").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless it is already built. Returns the
    library's path; raises with the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src, compiler = _source(name)
    cmd = [*compiler, "-o", str(tmp), str(src), *HOST_SOURCES.get(name, ())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:  # no compiler, or a hang
        raise RuntimeError(f"building {src.name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    """Argument types of the host libraries' entry points."""
    f32, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    if name == "ap_matcher":
        lib.sbd_match_class_full.restype = None
        lib.sbd_match_class_full.argtypes = [
            f32, i32, u8, ctypes.c_int32, f32, i32, u8, u8, ctypes.c_int32,
            f32, ctypes.c_int32, u8, u8]
        lib.sbd_match_class_strata.restype = None
        lib.sbd_match_class_strata.argtypes = [
            f32, i32, u8, ctypes.c_int32, f32, i32, u8, u8, ctypes.c_int32,
            ctypes.c_int32, f32, ctypes.c_int32, u8, u8]
    elif name == "jpeg_decoder":
        lib.sbd_decode_jpeg_resize.restype = ctypes.c_int
        lib.sbd_decode_jpeg_resize.argtypes = [
            u8, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8, i32, i32]


# ---------------------------------------------------------------------------
# The AP matcher (csrc/ap_matcher.cpp): eval/ap.py's greedy matching of one
# class's detections to its ground truth, every IoU threshold in one call.


def load_ap_matcher() -> ctypes.CDLL:
    """The AP matcher's library, built on first use; raises if it does not
    build."""
    return load("ap_matcher")


def _contiguous(det_boxes, det_img_ids, det_oob, gt_boxes, gt_img_ids, gt_crowd,
                gt_ignore, thresholds, strata: int = 0):
    """The matcher's arguments as contiguous arrays of its C types, their
    shapes checked: ``strata`` K > 0 gives (K, N) and (K, M) flags."""
    out = (np.ascontiguousarray(det_boxes, np.float32),
           np.ascontiguousarray(det_img_ids, np.int32),
           np.ascontiguousarray(det_oob, np.uint8),
           np.ascontiguousarray(gt_boxes, np.float32),
           np.ascontiguousarray(gt_img_ids, np.int32),
           np.ascontiguousarray(gt_crowd, np.uint8),
           np.ascontiguousarray(gt_ignore, np.uint8),
           np.ascontiguousarray(thresholds, np.float32))
    n, m = len(out[1]), len(out[4])
    k = (strata,) if strata else ()
    want = ((n, 4), (n,), (*k, n), (m, 4), (m,), (m,), (*k, m), (len(out[7]),))
    got = tuple(a.shape for a in out)
    if got != want:
        raise ValueError(f"AP matcher arguments have shapes {got}, expected {want}")
    return out


def _ptr(a: np.ndarray):
    ctype = {np.float32: ctypes.c_float, np.int32: ctypes.c_int32,
             np.uint8: ctypes.c_uint8}[a.dtype.type]
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def match_class_native(det_boxes, det_img_ids, det_oob, gt_boxes, gt_img_ids,
                       gt_crowd, gt_ignore, thresholds) -> Tuple[np.ndarray, np.ndarray]:
    """One class, one area range: detections (N, 4) float32 sorted by score
    (descending), their image ids (N,) and out-of-area flags (N,); ground
    truth (M, 4), image ids (M,), crowd (M,) and ignore (M,) flags; IoU
    thresholds (T,). Returns ((T, N) uint8 tp, (T, N) uint8 ignore), the
    semantics of ``eval/ap.py::_match_class``."""
    db, di, do, gb, gi, gc, gig, th = _contiguous(
        det_boxes, det_img_ids, det_oob, gt_boxes, gt_img_ids, gt_crowd, gt_ignore,
        thresholds)
    n, m, t = len(di), len(gi), len(th)
    tp = np.zeros((t, n), np.uint8)
    ig = np.zeros((t, n), np.uint8)
    load_ap_matcher().sbd_match_class_full(
        _ptr(db), _ptr(di), _ptr(do), n, _ptr(gb), _ptr(gi), _ptr(gc), _ptr(gig), m,
        _ptr(th), t, _ptr(tp), _ptr(ig))
    return tp, ig


def match_class_strata_native(det_boxes, det_img_ids, det_oob, gt_boxes, gt_img_ids,
                              gt_crowd, gt_ignore,
                              thresholds) -> Tuple[np.ndarray, np.ndarray]:
    """Every area stratum of one class in one call: ``det_oob`` (K, N) and
    ``gt_ignore`` (K, M) per stratum. Returns ((K, T, N) uint8 tp, (K, T, N)
    uint8 ignore)."""
    k = np.shape(det_oob)[0]
    db, di, do, gb, gi, gc, gig, th = _contiguous(
        det_boxes, det_img_ids, det_oob, gt_boxes, gt_img_ids, gt_crowd, gt_ignore,
        thresholds, strata=k)
    n, m, t = len(di), len(gi), len(th)
    tp = np.zeros((k, t, n), np.uint8)
    ig = np.zeros((k, t, n), np.uint8)
    load_ap_matcher().sbd_match_class_strata(
        _ptr(db), _ptr(di), _ptr(do), n, _ptr(gb), _ptr(gi), _ptr(gc), _ptr(gig), m,
        k, _ptr(th), t, _ptr(tp), _ptr(ig))
    return tp, ig


# ---------------------------------------------------------------------------
# The fused JPEG decode and resize (csrc/jpeg_decoder.cpp): libjpeg's
# DCT-domain prescale and a triangle resample (PIL's BILINEAR) in one call
# that releases the GIL, so the Loader's threads decode in parallel.


def load_image_lib() -> ctypes.CDLL:
    """The JPEG decoder's library, built on first use (needs g++ and
    libjpeg); raises if it does not build."""
    return load("jpeg_decoder")


def decode_jpeg_resize_native(data: bytes, out_size: int,
                              letterbox: bool) -> Optional[tuple]:
    """JPEG bytes -> ((S, S, 3) uint8, original h, original w): a square
    BILINEAR resize, or ``letterbox_image_host``'s top-left content with
    zero padding. None when the bytes do not decode as a JPEG (the caller
    then decodes them with PIL, as the reference does)."""
    lib = load_image_lib()
    out = np.empty((out_size, out_size, 3), np.uint8)
    ow, oh = ctypes.c_int32(0), ctypes.c_int32(0)
    # the C side only reads: pass the immutable bytes without a copy
    buf = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    rc = lib.sbd_decode_jpeg_resize(buf, len(data), out_size, 1 if letterbox else 0,
                                    _ptr(out), ctypes.byref(ow), ctypes.byref(oh))
    if rc != 0:
        return None
    return out, int(oh.value), int(ow.value)
