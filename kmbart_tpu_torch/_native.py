"""ctypes bindings for the C++ host kernels (native/kmbart_native.cpp).

Auto-builds with g++ on first use when the shared object is missing
(source-tree installs), into ``kmbart_tpu_torch/_build/``; every entry
point has a pure-Python fallback, so the port works without a toolchain
too. These are host-side helpers (NMS, METEOR matching, BLEU counts, row
gathers), not device kernels.
"""

import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_PKG, "_build", "kmbart_native.so")
_SRC = os.path.join(os.path.dirname(_PKG), "native", "kmbart_native.cpp")

_lib = None


def _try_build():
    if not os.path.exists(_SRC):
        return False
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded shared library, or None when unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    stale = (os.path.exists(_SO) and os.path.exists(_SRC)
             and os.path.getmtime(_SRC) > os.path.getmtime(_SO))
    if (not os.path.exists(_SO) or stale) and not _try_build():
        if not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.nms.restype = ctypes.c_int
        lib.meteor_resolve.restype = ctypes.c_int
        lib.bleu_counts.restype = None
        lib.gather_pad_rows.restype = None
    except (OSError, AttributeError):  # missing or outdated shared object
        return None
    _lib = lib
    return _lib


def available():
    return get_lib() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def nms(boxes, scores, iou_threshold):
    """C++ NMS; returns kept indices sorted by descending score."""
    lib = get_lib()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(boxes)
    keep = np.zeros(n, np.uint8)
    lib.nms(_ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
            ctypes.c_int(n), ctypes.c_float(float(iou_threshold)),
            _ptr(keep, ctypes.c_uint8))
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-scores[idx], kind="stable")]


def meteor_resolve(cands, rn, beam=40):
    """Beam-resolve METEOR candidate span matches.

    cands: int32 [n, 5] rows (h_start, h_len, r_start, r_len, stage);
    returns the selected row indices (list), or None when the native path
    cannot handle the input (rn > 63)."""
    lib = get_lib()
    cands = np.ascontiguousarray(cands, np.int32)
    n = len(cands)
    out = np.empty(max(n, 1), np.int32)
    got = lib.meteor_resolve(
        _ptr(cands, ctypes.c_int32), ctypes.c_int(n), ctypes.c_int(rn),
        ctypes.c_int(beam), _ptr(out, ctypes.c_int32))
    if got < 0:
        return None
    return out[:got].tolist()


def bleu_counts(hyp_tokens, ref_token_lists, max_n=4):
    """Clipped n-gram counts: (correct [max_n], guess [max_n])."""
    lib = get_lib()
    hyp = np.ascontiguousarray(hyp_tokens, np.int32)
    refs = np.ascontiguousarray(
        np.concatenate([np.asarray(r, np.int32) for r in ref_token_lists])
        if ref_token_lists else np.zeros(0, np.int32))
    ref_lens = np.asarray([len(r) for r in ref_token_lists], np.int32)
    correct = np.zeros(max_n, np.int64)
    guess = np.zeros(max_n, np.int64)
    lib.bleu_counts(_ptr(hyp, ctypes.c_int32), ctypes.c_int(len(hyp)),
                    _ptr(refs, ctypes.c_int32), _ptr(ref_lens, ctypes.c_int32),
                    ctypes.c_int(len(ref_lens)), ctypes.c_int(max_n),
                    _ptr(correct, ctypes.c_int64), _ptr(guess, ctypes.c_int64))
    return correct, guess


def gather_pad_rows(src, offsets, counts, max_rows):
    """Packed rows -> [batch, max_rows, feat] zero-padded batch."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    counts = np.ascontiguousarray(counts, np.int32)
    batch = len(offsets)
    feat = src.shape[1]
    dst = np.empty((batch, max_rows, feat), np.float32)
    lib.gather_pad_rows(_ptr(src, ctypes.c_float),
                        _ptr(offsets, ctypes.c_int64),
                        _ptr(counts, ctypes.c_int32), ctypes.c_int(batch),
                        ctypes.c_int(max_rows), ctypes.c_int(feat),
                        _ptr(dst, ctypes.c_float))
    return dst
