"""Build and load the native AP matcher (``csrc/ap_matcher.c``).

The C file is compiled with the host C compiler (``$CC``, else ``cc``) into
a shared library under ``build/native/`` at the root of the checkout (listed
in ``.gitignore``) at first use, and loaded with ``ctypes``. The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises: the
evaluator does not fall back to its Python matcher, which runs only when a
caller asks for it (``use_native=False``).

The C signatures are tpu3d's (``long`` is int64 on Linux): every count and
offset array is int64, every score, alpha and overlap array float64, each
C-contiguous; ``_ptr`` checks that before it hands a pointer over.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ap_matcher.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O3", "-fPIC", "-shared"]

P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_long
SIGNATURES = {
    # (restype, argtypes)
    "collect_tp_scores": (L, [I, P, P, P, P, P, P, P, P, P, D, P]),
    "fused_statistics": (None, [I, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                I, D, P, I, I, P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"ap_matcher-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", str(tmp), str(SOURCE),
           "-lm"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C compiler {cmd[0]!r} to build "
                           f"the native AP matcher: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building the native AP matcher failed "
                           f"({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def ap_matcher() -> ctypes.CDLL:
    """The loaded matcher library, built at first use; raises if it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray, dtype) -> int:
    if arr.dtype != dtype or not arr.flags.c_contiguous:
        raise TypeError(f"the native AP matcher takes C-contiguous {dtype} "
                        f"arrays, got {arr.dtype} (contiguous: "
                        f"{arr.flags.c_contiguous})")
    return arr.ctypes.data


def collect_tp_scores(dt_nums, gt_nums, ov_flat, ov_off, dt_scores, dt_off,
                      ig_gt, gt_off, ig_dt, min_overlap: float) -> np.ndarray:
    """Pass 1 over every image (compute_fp off): the matched detections'
    scores, in image and gt order."""
    i64, f64 = np.int64, np.float64
    out = np.zeros(max(int(gt_nums.sum()), 1), dtype=f64)
    count = ap_matcher().collect_tp_scores(
        len(dt_nums), _ptr(dt_nums, i64), _ptr(gt_nums, i64),
        _ptr(ov_flat, f64), _ptr(ov_off, i64), _ptr(dt_scores, f64),
        _ptr(dt_off, i64), _ptr(ig_gt, i64), _ptr(gt_off, i64),
        _ptr(ig_dt, i64), float(min_overlap), _ptr(out, f64))
    return out[:count]


def fused_statistics(dt_nums, gt_nums, dc_nums, ov_flat, ov_off, dt_scores,
                     dt_alphas, dt_off, gt_alphas, ig_gt, gt_off, ig_dt,
                     dc_flat, dc_off, metric: int, min_overlap: float,
                     thresholds: np.ndarray, compute_aos: bool) -> np.ndarray:
    """Pass 2 over every image and threshold (compute_fp on) -> (T, 4)
    sums of tp, fp, fn and similarity."""
    i64, f64 = np.int64, np.float64
    thresholds = np.ascontiguousarray(thresholds, dtype=f64)
    pr = np.zeros((len(thresholds), 4), dtype=f64)
    ap_matcher().fused_statistics(
        len(dt_nums), _ptr(dt_nums, i64), _ptr(gt_nums, i64),
        _ptr(dc_nums, i64), _ptr(ov_flat, f64), _ptr(ov_off, i64),
        _ptr(dt_scores, f64), _ptr(dt_alphas, f64), _ptr(dt_off, i64),
        _ptr(gt_alphas, f64), _ptr(ig_gt, i64), _ptr(gt_off, i64),
        _ptr(ig_dt, i64), _ptr(dc_flat, f64), _ptr(dc_off, i64), int(metric),
        float(min_overlap), _ptr(thresholds, f64), len(thresholds),
        int(compute_aos), _ptr(pr, f64))
    return pr
