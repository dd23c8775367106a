"""Fused dropout + residual add: kernels #16 and #17.

Counterpart of ``paddle_tpu/kernels/dropout_epilogue.py``.
:func:`dropout_add` computes ``keep ? x / (1 - rate) : 0, + residual``
(upscale_in_train) through a ``torch.autograd.Function`` whose forward is
:func:`dropout_add_fwd` (``_kernel``, #16) and whose backward is
:func:`dropout_add_bwd` (``_bwd_kernel``, #17) for x and the cotangent
itself for the residual.  The keep mask is ``hash_rng.keep_mask`` of the
site's uint32 seed over the flat element index, the reference's bits; the
backward regenerates it from the seed, the only thing the forward saves.
:func:`dropout` is the same kernel without a residual, the embedding
sites' ``dropout(upscale_in_train)``.

The plain twins are :func:`reference_dropout_add` and
:func:`reference_dropout_add_bwd`.  CPU tensors take them; CUDA tensors
launch ``csrc/dropout_add.cu`` or raise.  f32 and bf16 (amp) tensors each
have their kernel; in bf16 the arithmetic is the reference's in x's dtype
(inv_keep, each product and each sum rounded to bf16; the kernel's packed
bf16x2 operations round the exact product and sum once, the same bits),
counted under ``dropout_add_fwd_bf16`` and ``dropout_add_bwd_bf16``.
"""

from __future__ import annotations

import torch

from . import KERNEL_DTYPES, _build, hash_rng, launches


def _check(x, rate):
    if not 0.0 < float(rate) < 1.0:
        raise ValueError(f"dropout_add: rate {rate!r} outside (0, 1)")
    if x.numel() >= 2 ** 32:
        raise ValueError(
            f"dropout_add: {x.numel()} elements >= 2^32 wraps the uint32 "
            "mask index and correlates dropout bits; split the tensor into "
            "< 2^32-element dropout sites")


def _inv_keep(rate):
    return 1.0 / (1.0 - float(rate))


def _scale(rate, dtype):
    """inv_keep as the reference multiplies by it: in x's dtype (a bf16
    0-dim tensor for bf16, 1.109375 at rate 0.1), else the Python float."""
    if dtype == torch.bfloat16:
        return torch.tensor(_inv_keep(rate), dtype=dtype)
    return _inv_keep(rate)


def reference_dropout_add(x, residual, rate, seed):
    """Plain twin of #16: ``keep ? x * inv_keep : 0`` plus the residual
    (cast to x's dtype) when one is given, each operation in x's dtype."""
    keep = hash_rng.keep_mask(seed, x.shape, rate, device=x.device)
    out = torch.where(keep, x * _scale(rate, x.dtype),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return out if residual is None else out + residual.to(x.dtype)


def reference_dropout_add_bwd(g, rate, seed):
    """Plain twin of #17: dx = ``keep ? g * inv_keep : 0``."""
    return reference_dropout_add(g, None, rate, seed)


def _launch(entry, what, *ptrs, n, rate, seed, like):
    suffix = KERNEL_DTYPES[like.dtype]
    err = getattr(_build.lib(), entry + suffix)(
        *ptrs, n, float(rate), int(seed) & 0xFFFFFFFF,
        hash_rng.keep_threshold(rate), _build.stream_of(like))
    _build.check(err, what + suffix)
    launches[what + suffix] += 1


def _kernel_dtype(x, what):
    """x's dtype where a kernel takes it (f32, bf16); raises otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: no kernel for {x.dtype}")
    return x.dtype


def dropout_add_fwd(x, residual, rate, seed):
    """#16: :func:`reference_dropout_add`'s result (CPU: the twin; CUDA:
    the kernel of x's dtype, f32 or bf16, on contiguous tensors of that
    dtype, or an error)."""
    _check(x, rate)
    if x.device.type == "cpu":
        return reference_dropout_add(x, residual, rate, seed)
    dtype = _kernel_dtype(x, "dropout_add_fwd")
    tensors = {"x": (x, dtype, x.shape)}
    if residual is not None:
        tensors["residual"] = (residual, dtype, x.shape)
    _build.require(tensors, x.device, "dropout_add_fwd")
    out = torch.empty_like(x)
    _launch("ptt_dropout_add", "dropout_add_fwd", x.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            n=x.numel(), rate=rate, seed=seed, like=x)
    return out


def dropout_add_bwd(g, rate, seed):
    """#17: dx as :func:`reference_dropout_add_bwd` computes it (CPU: the
    twin; CUDA: the kernel of g's dtype or an error)."""
    _check(g, rate)
    if g.device.type == "cpu":
        return reference_dropout_add_bwd(g, rate, seed)
    dtype = _kernel_dtype(g, "dropout_add_bwd")
    _build.require({"g": (g, dtype, g.shape)}, g.device, "dropout_add_bwd")
    dx = torch.empty_like(g)
    _launch("ptt_dropout_add_bwd", "dropout_add_bwd", g.data_ptr(),
            dx.data_ptr(), n=g.numel(), rate=rate, seed=seed, like=g)
    return dx


class _DropoutAdd(torch.autograd.Function):
    """out = dropout_add(x, residual); saves the rate and the seed (Python
    numbers) and no tensor.  Its backward runs #17 for x and passes the
    cotangent, cast to the residual's dtype, to the residual."""

    @staticmethod
    def forward(ctx, x, residual, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        ctx.res_dtype = None if residual is None else residual.dtype
        return dropout_add_fwd(x, residual, rate, seed)

    @staticmethod
    def backward(ctx, g):
        dx = dropout_add_bwd(g.contiguous(), ctx.rate, ctx.seed)
        dres = None if ctx.res_dtype is None else g.to(ctx.res_dtype)
        return dx, dres, None, None


def dropout_add(x, residual, rate, seed):
    """``dropout(x) + residual`` with upscale_in_train semantics: x and the
    residual of one shape, rate in [0, 1), seed the site's uint32 stream
    seed for this step.  Rate 0 is a plain add (no kernel, no seed).
    Differentiable in x and in the residual."""
    if not rate:
        return x + residual.to(x.dtype)
    if tuple(x.shape) != tuple(residual.shape):
        raise ValueError(
            f"dropout_add: x {tuple(x.shape)} vs residual "
            f"{tuple(residual.shape)} must match")
    return _DropoutAdd.apply(x.contiguous(),
                             residual.to(x.dtype).contiguous(), float(rate),
                             int(seed))


def dropout(x, rate, seed):
    """``dropout(x)`` with upscale_in_train semantics through #16 without
    a residual (its backward through #17): the reference's ``keep_mask``
    bits.  Rate 0 returns x."""
    if not rate:
        return x
    return _DropoutAdd.apply(x.contiguous(), None, float(rate), int(seed))
