"""The f32 GEMM tile of ``csrc/gemm.cuh`` on its own.

The fused-projection kernels (#1's y = ctx W_out, the pair #2 + #3) and
#19 run this tile inside their own entry points.  :func:`gemm` launches it
alone (``csrc/gemm.cu`` ``ptt_gemm``: the same tile, split-K choice and
summation order), so that its rate can be measured at their shapes beside
cuBLAS; the port's paths never call it.  CPU tensors take the plain twin
:func:`reference_gemm`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build, launches


def reference_gemm(a, b):
    """Plain twin of :func:`gemm`: ``a @ b``."""
    return a @ b


def _row_major(t, what):
    """(True, row stride) for a row-major 2-D ``t``, (False, column
    stride) for a column-major one (a transposed view); raises otherwise:
    the kernel reads one of the two."""
    if t.dim() != 2:
        raise ValueError(f"gemm: {what} must be 2-D, got {tuple(t.shape)}")
    if t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return True, t.stride(0)
    if t.stride(0) == 1 and t.stride(1) >= t.shape[0]:
        return False, t.stride(1)
    raise ValueError(f"gemm: {what} is neither row- nor column-major "
                     f"(strides {t.stride()})")


def operands(a, b):
    """(m, n, k, (lda, A k-major), (ldb, B k-major)) of a [m, k] @ b [k,
    n] as ``ptt_gemm`` takes them: A(i, k) = a[i, k] is i-major when a is
    row-major, B(k, j) = b[k, j] k-major when b is.  Raises on a shape
    mismatch and on a transposed pair (A k-major with B not), for which
    no kernel is compiled."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    a_rows, lda = _row_major(a, "a")
    b_rows, ldb = _row_major(b, "b")
    if not a_rows and not b_rows:
        raise ValueError("gemm: a transposed with b transposed is not "
                         "compiled")
    return a.shape[0], b.shape[1], a.shape[1], (lda, not a_rows), (ldb,
                                                                  b_rows)


def _require_card(a, b):
    """Raise unless a and b are f32 tensors on one CUDA device."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device or (
                t.dtype != torch.float32):
            raise ValueError(f"gemm: {name} must be an f32 CUDA tensor on "
                             f"{a.device}, got {t.dtype} on {t.device}")


def gemm(a, b):
    """c [M, N] = a [M, K] @ b [K, N] in f32 on ``gemm.cuh``'s tile, each
    element summed in increasing k (split-K partials added in slab order).
    Each operand is row-major or a transposed view of one (see
    :func:`operands`)."""
    if a.device.type == "cpu":
        return reference_gemm(a, b)
    from .attention import sm_count

    _require_card(a, b)
    m, n, k, (lda, a_kmajor), (ldb, b_kmajor) = operands(a, b)
    sms = sm_count(a.device)
    lib = _build.lib()
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    partials = torch.empty(lib.ptt_gemm_partials(m, n, k, sms),
                           dtype=torch.float32, device=a.device)
    err = lib.ptt_gemm(a.data_ptr(), lda, int(a_kmajor), b.data_ptr(), ldb,
                       int(b_kmajor), c.data_ptr(), n, m, n, k,
                       partials.data_ptr(), sms, _build.stream_of(a))
    _build.check(err, "gemm")
    launches["gemm"] += 1
    return c
