"""ctypes binding for the native median-cut quantizer (quantizer.cpp),
with lazy on-first-use compilation and a NumPy fallback.

Parity target: `quantize_median_cut` (svox_t/csrc/quantizer.cpp:130-157)
— offline CPU tooling for PlenOctrees color compression; the natural
native layer is host C++ (no device involvement).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "quantizer.cpp")
# Build into a user cache dir, not the source tree (read-only installs,
# parallel test workers, VCS hygiene).
_SO_PATH = os.path.join(
    os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
    "svox_t_tpu",
    "libsvoxt_native.so",
)

_lib = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not os.path.exists(_SO_PATH) or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC):
            os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
            # Compile to a process-unique temp path, then rename into
            # place: os.rename is atomic, so concurrent workers never
            # CDLL a partially linked file.
            tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
            subprocess.check_call(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC]
            )
            os.rename(tmp, _SO_PATH)
        lib = ctypes.CDLL(_SO_PATH)
        lib.svoxt_quantize_median_cut.restype = ctypes.c_int32
        lib.svoxt_quantize_median_cut.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain issues
        warnings.warn(f"native quantizer unavailable ({e}); using NumPy fallback")
        _lib_failed = True
    return _lib


def _quantize_numpy(data: np.ndarray, weights: Optional[np.ndarray],
                    order: int) -> Tuple[np.ndarray, np.ndarray]:
    n, k = data.shape
    colors = np.zeros((1 << order, k), np.float32)
    id_map = np.zeros((n,), np.int32)
    next_color = [0]

    def rec(idx: np.ndarray, depth: int):
        if depth <= 0 or idx.size <= 1:
            w = weights[idx] if weights is not None else np.ones(idx.size, np.float32)
            tw = w.sum()
            if tw > 0:
                colors[next_color[0]] = (w[:, None] * data[idx]).sum(0) / tw
            id_map[idx] = next_color[0]
            next_color[0] += 1
            return
        rows = data[idx]
        dim = int(np.argmax(rows.max(0) - rows.min(0)))
        srt = idx[np.argsort(rows[:, dim], kind="stable")]
        if weights is None:
            m = idx.size // 2
        else:
            # First index whose inclusive prefix weight strictly exceeds
            # half the total goes to the RIGHT cluster (matches the C++
            # `break` semantics in quantizer.cpp).
            pfx = np.cumsum(weights[srt])
            m = int(np.searchsorted(pfx, 0.5 * pfx[-1], side="right"))
            m = min(m, idx.size - 1)
        rec(srt[:m], depth - 1)
        rec(srt[m:], depth - 1)

    rec(np.arange(n, dtype=np.int64), order)
    return colors, id_map


def quantize_median_cut(
    data, weights=None, order: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Median-cut quantization of (n, k) rows into 2^order colors.

    :param data: (n, k) float array
    :param weights: optional (n,) row weights
    :param order: number of splits; produces 2^order colors
    :return: (colors (2^order, k) float32, color_id_map (n,) int32)
    """
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    n, k = data.shape
    assert order < 31 and (1 << order) <= n
    w = None
    if weights is not None:
        w = np.ascontiguousarray(np.asarray(weights, np.float32))
        assert w.shape == (n,)

    lib = _load()
    if lib is None:
        return _quantize_numpy(data, w, order)

    colors = np.zeros((1 << order, k), np.float32)
    id_map = np.zeros((n,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.svoxt_quantize_median_cut(
        data.ctypes.data_as(fp),
        w.ctypes.data_as(fp) if w is not None else None,
        n,
        k,
        order,
        colors.ctypes.data_as(fp),
        id_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return colors, id_map
