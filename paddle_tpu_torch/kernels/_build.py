"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object file, and the objects are
linked into one shared library with a plain C interface.  The library
lands in ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name keyed by the sources and flags, so an unchanged tree builds once.

Nothing here runs at import time: the first call of :func:`lib` builds
and loads.  The CPU tests import every module of the package on machines
with no ``nvcc`` and never reach this.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the first on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch need the CUDA toolkit")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the shared library.
    The compiler's output, including ``-Xptxas -v``'s register and
    shared-memory report, is kept in ``_build/build-<digest>.log``."""
    digest = _digest()
    so_path = os.path.join(BUILD_DIR, f"libpaddle_tpu_torch-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = nvcc_path()
    obj_dir = os.path.join(BUILD_DIR, f"obj-{digest}")
    os.makedirs(obj_dir, exist_ok=True)
    jobs = []
    for src in _sources():
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)} (rc {proc.returncode})\n"
                   f"{out}")
        if proc.returncode:
            failed.append(os.path.basename(src))
    with open(os.path.join(BUILD_DIR, f"build-{digest}.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = f"{so_path}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", tmp, *[obj for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so_path)
    return so_path


def build_log() -> str:
    """The compiler output of the current sources' build ('' if none)."""
    path = os.path.join(BUILD_DIR, f"build-{_digest()}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double
_U = ctypes.c_uint32
#: a dropout site's (rate, seed, threshold) after the other arguments
_DROP = [_D, _U, _U]

#: C signature of every entry point: (restype, argtypes)
_SIGNATURES = {
    "ptt_error_string": (ctypes.c_char_p, [_I]),
    "ptt_gemm_partials": (_L, [_I] * 4),
    "ptt_gemm_slab": (_I, [_I] * 4),
    "ptt_gemm_smem": (_L, []),
    "ptt_gemm_tc_smem": (_L, [_I] * 4),
    "ptt_gemm": (_I, [_P, _I, _I, _P, _I, _I, _P] + [_I] * 4
                 + [_P, _I, _I, _P]),
    "ptt_qkv_fwd_scratch": (_L, [_I] * 6),
    "ptt_qkv_attention_fwd": (
        _I, [_P] * 4 + [_L] * 4 + [_P] * 4 + [_I] * 7 + [_F, _I] + _DROP
        + [_P]),
    "ptt_qkv_cluster_occupancy": (_I, [_I] * 3),
    "ptt_qkv_cluster_smem": (_L, [_I] * 3),
    "ptt_qkv_bwd_scratch": (_L, [_I] * 7),
    "ptt_qkv_bwd_walk_smem": (_L, [_I] * 2),
    "ptt_qkv_bwd": (_I, [_I] + [_P] * 4 + [_L] * 4 + [_P] * 7 + [_I] * 6
                    + [_F, _I] + _DROP + [_P]),
    "ptt_megastep_scratch": (_L, [_I] * 6),
    "ptt_megastep_occupancy": (_I, [_I] * 3),
    "ptt_megastep": (
        _I, [_P] * 19 + [_I] * 17 + [_F, _F, _P]),
    "ptt_megastep_paged": (
        _I, [_P] * 21 + [_I] * 21 + [_F, _F, _P]),
    "ptt_flash_decode_occupancy": (_I, [_I] * 4),
    "ptt_flash_decode": (_I, [_P] * 6 + [_I] * 8 + [_F, _P]),
    "ptt_flash_decode_paged": (_I, [_P] * 7 + [_I] * 10 + [_F, _P]),
    "ptt_ffn_occupancy": (_I, [_I]),
    "ptt_ffn": (_I, [_P] * 9 + [_I] * 11 + [_F, _P]),
    "ptt_flash_fwd": (_I, [_P] * 4 + [_L] * 4 + [_P] * 2 + [_I] * 5
                      + [_F, _I] + _DROP + [_P]),
    "ptt_flash_bwd_dq": (_I, [_P] * 4 + [_L] * 4 + [_P] * 4 + [_I] * 5
                         + [_F, _I] + _DROP + [_P]),
    "ptt_flash_bwd_dkv": (_I, [_P] * 4 + [_L] * 4 + [_P] * 5 + [_I] * 5
                          + [_F, _I] + _DROP + [_P]),
    "ptt_flash_fwd_bhtd": (_I, [_P] * 4 + [_L] * 4 + [_P] * 2 + [_I] * 5
                           + [_F, _I] + _DROP + [_P]),
    "ptt_flash_walk_smem": (_L, [_I] * 2),
    "ptt_flash_bwd_dq_bhtd": (_I, [_P] * 4 + [_L] * 4 + [_P] * 4 + [_I] * 5
                              + [_F, _I] + _DROP + [_P]),
    "ptt_flash_bwd_dkv_bhtd": (_I, [_P] * 4 + [_L] * 4 + [_P] * 5
                               + [_I] * 5 + [_F, _I] + _DROP + [_P]),
    "ptt_dropout_add": (_I, [_P] * 3 + [_L] + _DROP + [_P]),
    "ptt_dropout_add_bwd": (_I, [_P] * 2 + [_L] + _DROP + [_P]),

    "ptt_stats_partials": (_L, [_L, _I]),
    "ptt_dot_stats_partials": (_L, [_I, _I]),
    "ptt_dot_stats_smem": (_L, []),
    "ptt_channel_stats": (_I, [_P] * 4 + [_L, _I, _P]),
    "ptt_dot_col_stats": (_I, [_P] * 6 + [_I] * 3 + [_P]),
    "ptt_ssa_fwd": (_I, [_P] * 5 + [_L, _I, _I, _P]),
    "ptt_ssa_bwd": (_I, [_P] * 9 + [_L, _I, _I, _P]),
    "ptt_table_gather": (_I, [_P, _I, _L, _I, _P, _I, _P, _P]),
    "ptt_table_apply_occupancy": (_I, [_I, _I]),
    "ptt_table_apply": (_I, [_I] + [_P] * 3 + [_I] * 3 + [_P] * 3
                        + [_I, _P] + [_I] * 3 + [_F, _P] + [_F] * 5
                        + [_P]),
}
#: the bf16 instantiations (amp) take their f32 twin's arguments
_SIGNATURES.update({
    name + "_bf16": _SIGNATURES[name]
    for name in ("ptt_qkv_attention_fwd", "ptt_qkv_bwd", "ptt_flash_fwd",
                 "ptt_flash_bwd_dq", "ptt_flash_bwd_dkv", "ptt_flash_fwd_bhtd",
                 "ptt_flash_bwd_dq_bhtd", "ptt_flash_bwd_dkv_bhtd",
                 "ptt_dropout_add", "ptt_dropout_add_bwd", "ptt_stats_partials",
                 "ptt_channel_stats", "ptt_dot_col_stats", "ptt_ssa_fwd",
                 "ptt_ssa_bwd")})
_SIGNATURES["ptt_gemm_typed"] = (
    _I, [_I, _P, _I, _I, _L, _P, _I, _I, _L, _P] + [_I] * 4 + [_P, _I, _I, _P])


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = lib().ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require(tensors, device, what) -> None:
    """Raise unless every ``name: (tensor, dtype, shape)`` is a contiguous
    tensor of that dtype and shape on ``device``: the kernels index raw
    pointers and check nothing themselves."""
    for name, (a, dtype, shape) in tensors.items():
        if (a.device != device or a.dtype != dtype
                or tuple(a.shape) != tuple(shape) or not a.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {device}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
