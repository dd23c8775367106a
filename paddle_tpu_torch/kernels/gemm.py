"""The GEMM tiles of ``csrc/gemm.cuh`` on their own.

The fused-projection kernels (#1's y = ctx W_out, the pair #2 + #3) and
#19 run these tiles inside their own entry points.  :func:`gemm` launches
one alone (``csrc/gemm.cu``: the same tile, split-K choice and summation
order), so that its rate can be measured at their shapes beside cuBLAS;
the port's paths never call it.  CPU tensors take the plain twin
:func:`reference_gemm`; CUDA tensors launch the kernel or raise.  f32
throughout runs the f32 tile (``ptt_gemm``); bf16 operands or a bf16 C
(``out_dtype``) run the tensor-core tile (``ptt_gemm_typed``) in the
element types of amp's products, where an f32 operand is held as hi/lo
bf16 planes (:class:`HiLo`), as the pair holds its f32 intermediates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, launches


_F32, _BF16 = torch.float32, torch.bfloat16
#: (A, B, C) element types -> the ``dtypes`` code of ``ptt_gemm_typed``
#: (bit 0 A, bit 1 B, bit 2 C in bf16; an f32 operand as hi/lo planes);
#: 0 is f32 throughout, ``ptt_gemm``
TYPED = {(_F32, _F32, _F32): 0, (_BF16, _BF16, _F32): 3,
         (_BF16, _F32, _BF16): 5, (_F32, _BF16, _BF16): 6,
         (_BF16, _BF16, _BF16): 7}


class HiLo(NamedTuple):
    """An f32 matrix held as two bf16 planes of one layout, its value hi +
    lo to 2^-16 of itself (``csrc/mma.cuh``'s split)."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return _F32

    @property
    def device(self):
        return self.hi.device

    def value(self):
        """hi + lo in f32."""
        return self.hi.float() + self.lo.float()


def hi_lo(a):
    """The f32 matrix ``a`` (row-major or a transposed view of one) as hi
    = bf16(a) and lo = bf16(a - hi) planes of one [2, ...] buffer, laid out
    as ``a`` is."""
    rows = a if a.stride(-1) == 1 else a.t()
    planes = torch.empty((2,) + tuple(rows.shape), dtype=_BF16,
                         device=a.device)
    planes[0] = rows
    planes[1] = rows - planes[0].float()
    hi, lo = planes[0], planes[1]
    return HiLo(hi, lo) if rows is a else HiLo(hi.t(), lo.t())


def _value(a):
    return a.value() if isinstance(a, HiLo) else a


def _out_dtype(a, b, out_dtype):
    """C's dtype: ``out_dtype``, else the operands' common dtype, else (f32
    with bf16) bf16."""
    return out_dtype or (a.dtype if a.dtype == b.dtype else _BF16)


def reference_gemm(a, b, out_dtype=None):
    """Plain twin of :func:`gemm`: ``a @ b`` in f32 or wider (bf16
    operands multiplied in f32, a :class:`HiLo` as hi + lo), in C's dtype
    (:func:`_out_dtype`)."""
    wide = torch.promote_types(torch.promote_types(a.dtype, b.dtype), _F32)
    return (_value(a).to(wide) @ _value(b).to(wide)).to(
        _out_dtype(a, b, out_dtype))


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


def _lo_offset(a):
    """Elements from a :class:`HiLo`'s hi plane to its lo plane (0 for a
    tensor)."""
    if not isinstance(a, HiLo):
        return 0
    return (a.lo.data_ptr() - a.hi.data_ptr()) // a.hi.element_size()


def gemm(a, b, split=True, out_dtype=None):
    """c [M, N] = a [M, K] @ b [K, N] on a ``gemm.cuh`` tile, each element
    summed in increasing k; with ``split`` over K in slabs of at most 1024
    (partials added in slab order), as the pair sums its dW products, else
    in one sum, as it does its projections and dx.  Each operand is
    row-major or a transposed view of one (see :func:`operands`).  f32
    operands give an f32 c on the f32 tile; bf16 operands, or a bf16
    ``out_dtype`` (the default for mixed operands), take the tensor-core
    tile in the types of :data:`TYPED`, an f32 operand of such a product
    as hi/lo planes (a :class:`HiLo`, or split here by :func:`hi_lo`)."""
    out_dtype = _out_dtype(a, b, out_dtype)
    if a.device.type == "cpu":
        return reference_gemm(a, b, out_dtype)
    from .attention import sm_count

    code = TYPED.get((a.dtype, b.dtype, out_dtype))
    if code is None:
        raise ValueError(f"gemm: no kernel for {a.dtype} x {b.dtype} -> "
                         f"{out_dtype}")
    if code:  # the tensor-core tile: an f32 operand as hi/lo planes
        a, b = (x if x.dtype == _BF16 or isinstance(x, HiLo) else hi_lo(x)
                for x in (a, b))
    _require_card(*(x.hi if isinstance(x, HiLo) else x for x in (a, b)))
    m, n, k, (lda, a_kmajor), (ldb, b_kmajor) = operands(
        *(x.hi if isinstance(x, HiLo) else x for x in (a, b)))
    sms = sm_count(a.device)
    lib = _build.lib()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    partials = torch.empty(lib.ptt_gemm_partials(m, n, k, sms) if split
                           else 0, dtype=torch.float32, device=a.device)
    tail = (c.data_ptr(), n, m, n, k, partials.data_ptr(), sms, int(split),
            _build.stream_of(c))
    if code:
        err = lib.ptt_gemm_typed(
            code, (a.hi if isinstance(a, HiLo) else a).data_ptr(), lda,
            int(a_kmajor), _lo_offset(a),
            (b.hi if isinstance(b, HiLo) else b).data_ptr(), ldb,
            int(b_kmajor), _lo_offset(b), *tail)
    else:
        err = lib.ptt_gemm(a.data_ptr(), lda, int(a_kmajor), b.data_ptr(),
                           ldb, int(b_kmajor), *tail)
    _build.check(err, "gemm")
    launches["gemm"] += 1
    return c
