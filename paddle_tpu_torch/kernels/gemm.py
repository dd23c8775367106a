"""The f32 GEMM tile of ``csrc/gemm.cuh`` on its own.

The fused-projection kernels (#1's y = ctx W_out, the pair #2 + #3) and
#19 run this tile inside their own entry points.  :func:`gemm` launches it
alone (``csrc/gemm.cu`` ``ptt_gemm``: the same tile, split-K choice and
summation order), so that its rate can be measured at their shapes beside
cuBLAS; the port's paths never call it.  CPU tensors take the plain twin
:func:`reference_gemm`; CUDA tensors launch the kernel or raise.  Its amp
instantiations take bf16 operands or give a bf16 C (``out_dtype``), with
f32 arithmetic, in the element types the bf16 kernels use
(``ptt_gemm_typed``).
"""

from __future__ import annotations

import torch

from . import _build, launches


_F32, _BF16 = torch.float32, torch.bfloat16
#: (A, B, C) element types -> the ``dtypes`` code of ``ptt_gemm_typed``
#: (bit 0 A, bit 1 B, bit 2 C in bf16); 0 is f32 throughout, ``ptt_gemm``
TYPED = {(_F32, _F32, _F32): 0, (_BF16, _BF16, _F32): 3,
         (_BF16, _F32, _BF16): 5, (_F32, _BF16, _BF16): 6,
         (_BF16, _BF16, _BF16): 7}


def _out_dtype(a, b, out_dtype):
    """C's dtype: ``out_dtype``, else the operands' common dtype, else (f32
    with bf16) bf16."""
    return out_dtype or (a.dtype if a.dtype == b.dtype else _BF16)


def reference_gemm(a, b, out_dtype=None):
    """Plain twin of :func:`gemm`: ``a @ b`` in f32 or wider (bf16
    operands multiplied in f32), in C's dtype (:func:`_out_dtype`)."""
    wide = torch.promote_types(torch.promote_types(a.dtype, b.dtype), _F32)
    return (a.to(wide) @ b.to(wide)).to(_out_dtype(a, b, out_dtype))


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
    """Raise unless a and b are f32 or bf16 tensors on one CUDA device."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device or (
                t.dtype not in (_F32, _BF16)):
            raise ValueError(f"gemm: {name} must be an f32 or bf16 CUDA "
                             f"tensor on {a.device}, got {t.dtype} on "
                             f"{t.device}")


def gemm(a, b, split=True, out_dtype=None):
    """c [M, N] = a [M, K] @ b [K, N] in f32 on ``gemm.cuh``'s tile, each
    element summed in increasing k; with ``split`` over K in slabs of at
    most 1024 (partials added in slab order), as the pair sums its dW
    products, else in one sum, as it does its projections and dx.  Each
    operand is row-major or a transposed view of one (see
    :func:`operands`).  f32 operands give an f32 c; bf16 operands, or a
    bf16 ``out_dtype`` (the default for mixed operands), take the amp
    instantiations of :data:`TYPED`."""
    out_dtype = _out_dtype(a, b, out_dtype)
    if a.device.type == "cpu":
        return reference_gemm(a, b, out_dtype)
    from .attention import sm_count

    _require_card(a, b)
    code = TYPED.get((a.dtype, b.dtype, out_dtype))
    if code is None:
        raise ValueError(f"gemm: no kernel for {a.dtype} x {b.dtype} -> "
                         f"{out_dtype}")
    m, n, k, (lda, a_kmajor), (ldb, b_kmajor) = operands(a, b)
    sms = sm_count(a.device)
    lib = _build.lib()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    partials = torch.empty(lib.ptt_gemm_partials(m, n, k, sms) if split
                           else 0, dtype=torch.float32, device=a.device)
    args = (a.data_ptr(), lda, int(a_kmajor), b.data_ptr(), ldb,
            int(b_kmajor), c.data_ptr(), n, m, n, k, partials.data_ptr(),
            sms, int(split), _build.stream_of(a))
    err = lib.ptt_gemm_typed(code, *args) if code else lib.ptt_gemm(*args)
    _build.check(err, "gemm")
    launches["gemm"] += 1
    return c
