"""Build and bind the hand-written Hopper kernels in ``kmbart_tpu_torch/csrc``.

The CUDA C++ sources expose a plain C interface, so they build without
PyTorch's headers: one ``nvcc`` per source, all started together, then one
link into a shared library, bound with ``ctypes``. The build runs at first
use, from the sources in the package, into ``kmbart_tpu_torch/_build/``
(ignored by git); the library's name carries a digest of the sources and
flags, so an edit rebuilds.

Nothing here runs at import time: a machine without ``nvcc`` or a card
imports the package and uses the kernels' plain PyTorch versions on CPU
tensors.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# element-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "kmb_train_attention_fwd": (_I, [_P] * 5 + [_I] * 9 + [_F, _I, _P]),
    "kmb_train_attention_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I]),
    "kmb_train_attention_bwd": (_I, [_P] * 8 + [_I] * 9 + [_F, _F, _I, _P]),
    "kmb_train_attention_bwd_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I]),
    "kmb_train_attention_wg_fwd": (_I, [_P] * 5 + [_I] * 9 + [_F, _I, _I, _P]),
    "kmb_train_attention_wg_bwd": (_I, [_P] * 8 + [_I] * 9 + [_F, _F, _I, _I, _P]),
    "kmb_train_attention_wg_resident": (_I, [_I, _I, _I]),
    "kmb_ffn_fwd": (_I, [_P] * 9 + [_I] * 8 + [_P]),
    "kmb_ffn_bwd": (_I, [_P] * 7 + [_I] * 8 + [_P]),
    "kmb_ffn_infer": (_I, [_P] * 7 + [_I] * 12 + [_P]),
    "kmb_ffn_cluster_slots": (_I, [_I, _I]),
    "kmb_lm_ce_fwd": (_I, [_P] * 9 + [_I] * 5 + [_P]),
    "kmb_lm_ce_bwd": (_I, [_P] * 9 + [_I] * 8 + [_P]),
    "kmb_lm_ce_dh": (_I, [_P] * 4 + [_I] * 7 + [_P]),
    "kmb_lm_ce_recompute_dlogits": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "kmb_beam_attention": (_I, [_P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 7 + [_P]),
    "kmb_beam_attention_occupancy": (_I, [_I] * 6 + [_P]),
    "kmb_flash_attention": (_I, [_P] * 5 + [_I] * 9 + [_F, _I, _P]),
    "kmb_vocab_stats_topk": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    "kmb_topk_merge": (_I, [_P] * 4 + [_I] * 4 + [_P]),
    "kmb_adamw_table_bytes": (ctypes.c_size_t, []),
    "kmb_adamw_used": (_I, [_P, _I, _I, _P, _I, _I, _P]),
    "kmb_adamw_steps": (_I, [_P] * 5 + [_I] * 3 + [_F] * 3 + [_P]),
    "kmb_adamw_update": (_I, [_P, _I, _I, _P, _P] + [_F] * 6 + [_I, _P]),
    "kmb_error_string": (ctypes.c_char_p, [_I]),
    "kmb_set_device": (_I, [_I]),
}

_lib = None
last_build_seconds = None


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def build():
    """Compile csrc/*.cu into the shared library unless an up-to-date one
    exists; returns its path."""
    global last_build_seconds
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libkmbart_kernels-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(work, os.path.basename(s)[:-3] + ".o") for s in cus]
        start = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(cus, objs)]
        errors = []
        for src, proc in zip(cus, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        last_build_seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def lib():
    """The bound kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = handle
    return _lib


def prepare(device):
    """Bind the library and point its runtime at ``device``; returns
    (library, stream handle) for a launch on PyTorch's current stream."""
    handle = lib()
    check(handle.kmb_set_device(device.index or 0), "cudaSetDevice")
    return handle, torch.cuda.current_stream(device).cuda_stream


def check(err, what):
    if err != 0:
        msg = lib().kmb_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(t):
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") from None


def require_cuda(name, *tensors, contiguous=True):
    """Wrapper guard: every tensor on one CUDA device and, unless the kernel
    reads by stride (``contiguous=False``), contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev
