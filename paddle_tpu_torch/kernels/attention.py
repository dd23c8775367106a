"""Flash attention: the fused-projection kernels and the bthd kernels.

Counterparts of ``paddle_tpu/kernels/attention.py``:

* :func:`flash_qkv_attention`: the q/k/v projections, the online-softmax
  attention and the output projection fused, differentiable through a
  ``torch.autograd.Function`` whose passes are the kernels of
  ``csrc/qkv_attention.cu`` and ``csrc/qkv_attention_bwd.cu``:
  :func:`qkv_attention_fwd` (``_qkv_fwd_kernel``, #1: y and the residuals
  ctx, lse) and :func:`qkv_bwd` (``_qkv_bwd_dq_kernel`` and
  ``_qkv_bwd_dkv_kernel``, the pair #2 + #3 in one entry: dx, the packed
  dW_qkv, dW_out).  :func:`qkv_bwd_dq` (#2: dx_q, dW_q, dW_out) and
  :func:`qkv_bwd_dkv` (#3: dx_kv, dW_k, dW_v) run one walk of the same
  entry each.  Their plain versions are :func:`reference_qkv_fwd`,
  :func:`reference_qkv_bwd`, :func:`reference_qkv_bwd_dq` and
  :func:`reference_qkv_bwd_dkv`; under ``torch.no_grad()`` (serving) #1's
  residuals are dropped.
* :func:`flash_attention` with ``fmt="bthd"``: q, k, v [b, t, h, d] with
  an additive bias, differentiable through a ``torch.autograd.Function``
  whose passes are three kernels of ``csrc/flash_attention.cu``:
  :func:`flash_fwd` (``_fwd_kernel_bthd``, #4), :func:`flash_bwd_dq`
  (``_bwd_dq_kernel_bthd``, #6) and :func:`flash_bwd_dkv`
  (``_bwd_dkv_kernel_bthd``, #7).  Their plain versions are
  :func:`reference_flash_fwd`, :func:`reference_flash_bwd_dq` and
  :func:`reference_flash_bwd_dkv`.
* :func:`flash_attention` with ``fmt="bhtd"`` (the reference's default):
  q, k, v [b, h, t, d], through the same Function and three more kernels
  of that file, the same walks on the other layout: :func:`flash_fwd_bhtd`
  (``_fwd_kernel``, #5), :func:`flash_bwd_dq_bhtd` (``_bwd_dq_kernel``,
  #8) and :func:`flash_bwd_dkv_bhtd` (``_bwd_dkv_kernel``, #9), with the
  plain versions :func:`reference_flash_fwd_bhtd`,
  :func:`reference_flash_bwd_dq_bhtd` and
  :func:`reference_flash_bwd_dkv_bhtd`.

Both take the reference's weights dropout: with ``dropout_rate`` > 0 and a
site's uint32 ``dropout_seed``, the kernels drop the softmax weights that
multiply v (the normalizer sums the undropped ones) and scale the context
by 1 / (1 - rate), keyed on (seed, b * h + head, q * tk + k) as
``hash_rng.keep_mask_attn`` is, so both routes draw the reference's mask
for the same seed.  The backward kernels regenerate it; no mask is stored.

bf16 (amp): #1, the pair #2 + #3 and the flash kernels of both layouts
(#4, #6, #7 in bthd; #5, #8, #9 in bhtd) have bf16 instantiations (entry
points ``ptt_*_bf16``, counted under the kernel's name + "_bf16", e.g.
``flash_fwd_bhtd_bf16``), compiled for head widths 64 and 128 (counted at
128 under ``flash_fwd_bhtd_bf16_dh128``); the f32 pair and the f32 flash
kernels take 64, and #1 in f32 64 and 128.  Their tensors are bf16 (x,
the weights, the
bias, y, ctx, dx, the dW in the fused kernels; q, k, v, the bias, o, dO,
dq, dk, dv in the flash ones), lse and delta f32.  The reference computes
on the bf16 operands in f32 and stores in the operands' dtype, and so do
the twins (the projections of bf16 operands in f32, #1's ctx rounded to
bf16 before the y product).  Every bf16 kernel runs on tensor cores:
exact bf16 products summed in f32, the f32 intermediates (p and ds; #1's
q, k, v; the pair's q, k, v, dctx and dq | dk | dv) split into hi/lo bf16
pairs (``csrc/mma.cuh``); #5, #8 and #9 are #4's, #6's and #7's kernels
instantiated on the bhtd row layout.
"""

from __future__ import annotations

import torch

from . import (KERNEL_DTYPES, _build, compiled_widths, composes, hash_rng,
               head_route, launches, width_suffix)

#: score given to causally hidden keys (the reference kernel's value)
MASK_VALUE = -1e30


def _wide(a):
    """a in f32 or wider (bf16 -> f32; f32 and f64 as they are)."""
    return a.to(torch.promote_types(a.dtype, torch.float32))


def _kernel_dtype(a, what, dtypes=KERNEL_DTYPES):
    """(a's dtype, its entry-point suffix) where a kernel takes it; raises
    otherwise."""
    if a.dtype not in dtypes:
        raise ValueError(f"{what}: no kernel for {a.dtype} (compiled for "
                         f"{', '.join(str(d) for d in dtypes)})")
    return a.dtype, dtypes[a.dtype]


def _require_aligned(what, **tensors):
    """The kernels load 16 bytes at a time from each row: every tensor's
    data must start 16-byte aligned."""
    for name, a in tensors.items():
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _bias_4d(bias, b, n_head, tq, tk, what):
    """The bias with leading 1s up to 4 dims (a view); raises unless it
    broadcasts to [b, h, tq, tk]."""
    while bias.dim() < 4:
        bias = bias.unsqueeze(0)
    bb, hb, tqb, tkb = bias.shape
    if (bb not in (1, b) or hb not in (1, n_head) or tqb not in (1, tq)
            or tkb not in (1, tk)):
        raise ValueError(
            f"{what}: bias {tuple(bias.shape)} does not broadcast to "
            f"[{b}, {n_head}, {tq}, {tk}]")
    return bias


def _bias_view(bias, b, n_head, tq, tk, what):
    """Broadcast an additive bias to a [b, h, tq, tk] view (no copy), so a
    kernel reads it through strides that are 0 on the broadcast dims."""
    return _bias_4d(bias, b, n_head, tq, tk, what).expand(b, n_head, tq, tk)


def _dropout_args(rate, seed, tq, tk, what):
    """(rate, seed, keep threshold) as the kernels take them, (0, 0, 0)
    without dropout.  Raises where the in-plane index q * tk + k would
    wrap its uint32 (tq * tk > 2^32), as the reference does."""
    if not rate:
        return 0.0, 0, 0
    if seed is None:
        raise ValueError(f"{what}: dropout_rate > 0 needs dropout_seed")
    if tq * tk > 2 ** 32:
        raise ValueError(
            f"{what}: weights-dropout mask plane Tq*Tk = {tq}*{tk} > 2^32 "
            "would wrap the uint32 hash index and correlate mask bits")
    return float(rate), int(seed) & 0xFFFFFFFF, hash_rng.keep_threshold(rate)


def _bias_strides(bias, device, what, dtype=torch.float32):
    """(the bias's four strides, its data pointer) for a kernel; zeros and
    None without a bias.  The bias must be of the kernel's dtype."""
    if bias is None:
        return (0, 0, 0, 0), None
    if bias.device != device or bias.dtype != dtype:
        raise ValueError(f"{what}: bias must be {dtype} on {device}, got "
                         f"{bias.dtype} on {bias.device}")
    return bias.stride(), bias.data_ptr()


# ---------------------------------------------------------------------------
# flash_qkv_attention: kernels #1, #2, #3
# ---------------------------------------------------------------------------


def _project(x, w_qkv, n_head):
    """q, k, v [b, t, h, dh] of x [b, t, dm] by the packed w_qkv, in f32
    or wider (bf16 operands multiplied in f32, as the reference's kernels
    do)."""
    b, t, _ = x.shape
    hd = w_qkv.shape[1] // 3
    return (a.reshape(b, t, n_head, hd // n_head)
            for a in torch.split(_wide(x) @ _wide(w_qkv), hd, dim=-1))


def reference_qkv_fwd(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                      causal=False, dropout_rate=0.0, dropout_seed=0):
    """Plain twin of #1 with its residuals: (y [b, t, dm], ctx [b, t, h,
    dh], lse [b, h, t]) where ctx is each head's normalized context,
    ``softmax((x Wq)(x Wk)^T * scale + bias) (x Wv)`` (its weights dropped
    as :func:`reference_flash_fwd` drops them), and y = ctx @ w_out over
    the merged heads.  A row whose scores are all masked (max <= -1e29)
    gets a zero context and lse = +inf, as in the kernel.  ctx and y are
    in x's dtype; under bf16 ctx is rounded before the y product, which
    runs in f32."""
    b, t, _ = x.shape
    q, k, v = _project(x, w_qkv, n_head)
    ctx, lse = reference_flash_fwd(q, k, v, bias, scale, causal,
                                   dropout_rate, dropout_seed)
    ctx = ctx.to(x.dtype)
    y = _wide(ctx).reshape(b, t, -1) @ _wide(w_out)
    return y.to(x.dtype), ctx, lse


def reference_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1,
                            scale=1.0, causal=False, dropout_rate=0.0,
                            dropout_seed=0):
    """y of :func:`reference_qkv_fwd`: the math of the reference's
    ``_composed_qkv``."""
    return reference_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                             dropout_rate, dropout_seed)[0]


def _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head):
    """What both backward kernels rebuild from their inputs: q, k, v,
    dctx = g w_out^T (each [b, t, h, dh]) and delta = rowsum(dctx * ctx)
    [b, h, t]."""
    q, k, v = _project(x, w_qkv, n_head)
    dctx = (_wide(g) @ _wide(w_out).transpose(0, 1)).reshape(ctx.shape)
    delta = (dctx * _wide(ctx)).sum(-1).transpose(1, 2)
    return q, k, v, dctx, delta


def _rows(a):
    """[b, t, h, dh] -> [b*t, h*dh]."""
    return a.reshape(a.shape[0] * a.shape[1], -1)


def reference_qkv_bwd_dq(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1,
                         scale=1.0, causal=False, dropout_rate=0.0,
                         dropout_seed=0):
    """Plain twin of #2: (dx_q [b, t, dm], dW_q [dm, hd], dW_out [hd, dm])
    from g = dL/dy and #1's residuals: dq = ds k as the bthd twin of #6
    computes it over the recomputed q, k, v and dctx, then dx_q = dq
    Wq^T, dW_q = x^T dq and dW_out = ctx^T g (each in its operand's
    dtype, the products in f32 or wider)."""
    hd = w_qkv.shape[1] // 3
    q, k, v, dctx, delta = _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head)
    dq = _rows(reference_flash_bwd_dq(q, k, v, bias, dctx, lse, delta,
                                      scale, causal, dropout_rate,
                                      dropout_seed))
    dx = (dq @ _wide(w_qkv)[:, :hd].transpose(0, 1)).reshape(x.shape)
    return (dx.to(x.dtype),
            (_rows(_wide(x)).transpose(0, 1) @ dq).to(w_qkv.dtype),
            (_rows(_wide(ctx)).transpose(0, 1) @ _rows(_wide(g))).to(
                w_out.dtype))


def reference_qkv_bwd_dkv(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1,
                          scale=1.0, causal=False, dropout_rate=0.0,
                          dropout_seed=0):
    """Plain twin of #3: (dx_kv [b, t, dm], dW_k, dW_v [dm, hd]) with dk =
    ds^T q and dv = p^T dctx as the twin of #7 computes them, dx_kv = dk
    Wk^T + dv Wv^T, dW_k = x^T dk and dW_v = x^T dv."""
    hd = w_qkv.shape[1] // 3
    q, k, v, dctx, delta = _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head)
    dk, dv = (_rows(a) for a in reference_flash_bwd_dkv(
        q, k, v, bias, dctx, lse, delta, scale, causal, dropout_rate,
        dropout_seed))
    w = _wide(w_qkv)
    dx = (dk @ w[:, hd:2 * hd].transpose(0, 1)
          + dv @ w[:, 2 * hd:].transpose(0, 1)).reshape(x.shape)
    xt = _rows(_wide(x)).transpose(0, 1)
    return (dx.to(x.dtype), (xt @ dk).to(w_qkv.dtype),
            (xt @ dv).to(w_qkv.dtype))


def _d_head(w_qkv, n_head):
    return w_qkv.shape[1] // 3 // n_head


def _qkv_args(what, x, w_qkv, w_out, bias, n_head, **more):
    """Check the operands of a fused-projection kernel and return (b, t,
    dm, hd, bias strides, bias pointer).  x (and g)
    [b, t, dm], w_qkv [dm, 3hd], w_out [hd, dm], ctx [b, t, h, dh] and the
    bias must be contiguous (the bias a broadcast view) tensors of x's
    dtype, f32 or bf16, and lse [b, h, t] f32, on x's CUDA device, 16-byte
    aligned, with a head width the kernel is compiled for
    (``compiled_widths``: 64; #1, and the pair in bf16, also 128) and
    d_model % 32 == 0: the kernels index raw pointers."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    dtype, _ = _kernel_dtype(x, what)
    b, t, dm = x.shape
    hd = w_qkv.shape[1] // 3
    dh = hd // n_head
    widths = compiled_widths("qkv_bwd_dq" if what == "qkv_bwd" else what,
                             dtype)
    if dh not in widths or dm % 32:
        raise ValueError(
            f"{what}: the CUDA kernel takes d_head in {widths} and d_model "
            f"% 32 == 0, got d_head {dh}, d_model {dm}")
    shapes = {"x": (b, t, dm), "w_qkv": (dm, 3 * hd), "w_out": (hd, dm),
              "g": (b, t, dm), "ctx": (b, t, n_head, dh),
              "lse": (b, n_head, t)}
    tensors = dict(x=x, w_qkv=w_qkv, w_out=w_out, **more)
    _build.require({name: (a, torch.float32 if name == "lse" else dtype,
                           shapes[name]) for name, a in tensors.items()},
                   x.device, what)
    _require_aligned(what, **tensors)
    if bias is not None:
        bias = _bias_view(bias, b, n_head, t, t, what)
    return (b, t, dm, hd) + _bias_strides(bias, x.device, what, dtype)


#: the most blocks a thread-block cluster may hold on every Hopper card
#: (the portable cluster size)
CLUSTER_MAX = 8


def qkv_fwd_plan(b, t, n_head, sms):
    """The route of #1 for x [b, t, d_model] with ``n_head`` heads on a
    card of ``sms`` streaming multiprocessors, chosen from the shape
    before any launch:

    * ``("cluster", C, R)`` for t <= 512: one thread-block cluster of C =
      ceil(t / R) blocks per (sequence, head), block r projecting rows
      [r R, r R + R) of q, k and v once and reading its peers' k and v
      from their shared memory.  R = 32 where the 64-row grid,
      b * n_head * ceil(t / 64) blocks, would leave SMs idle and ceil(t /
      32) still fits a cluster; otherwise R = 64.
    * ``("tiles",)`` for t > 512, where one cluster cannot hold a whole
      sequence: 64-row query tiles that each project the k and v tiles
      they walk.

    The same plan holds at head width 128: there a block of either R
    takes one SM (f32: 187 KB at R = 64, 135 KB at R = 32; bf16: 190.5
    and 132 KB, against two an SM at 64), so the choice still turns on how
    many blocks the 64-row grid gives.
    """
    if t > CLUSTER_MAX * 64:
        return ("tiles",)
    rows = 64
    if b * n_head * -(-t // 64) < sms and -(-t // 32) <= CLUSTER_MAX:
        rows = 32
    return ("cluster", -(-t // rows), rows)


def sm_count(device):
    """Streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                    dropout_rate, dropout_seed):
    """Launch #1 on the route of :func:`qkv_fwd_plan`: (y, ctx, lse)."""
    b, t, dm, hd, strides, bias_ptr = _qkv_args(
        "qkv_attention_fwd", x, w_qkv, w_out, bias, n_head)
    dh = hd // n_head
    suffix = KERNEL_DTYPES[x.dtype]
    sms = sm_count(x.device)
    plan = qkv_fwd_plan(b, t, n_head, sms)
    rows = plan[2] if plan[0] == "cluster" else 0
    drop = _dropout_args(dropout_rate, dropout_seed, t, t,
                         "qkv_attention_fwd")
    lib = _build.lib()
    y = torch.empty_like(x)
    ctx = torch.empty((b, t, n_head, dh), dtype=x.dtype, device=x.device)
    lse = torch.empty((b, n_head, t), dtype=torch.float32, device=x.device)
    partials = torch.empty(
        lib.ptt_qkv_fwd_scratch(b, t, dm, n_head, dh, sms),
        dtype=torch.float32, device=x.device)
    err = getattr(lib, "ptt_qkv_attention_fwd" + suffix)(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), bias_ptr,
        *strides, y.data_ptr(), ctx.data_ptr(), lse.data_ptr(),
        partials.data_ptr(), b, t, dm, n_head, dh, rows, sms, float(scale),
        int(bool(causal)), *drop, _build.stream_of(x))
    _build.check(err, "qkv_attention_fwd" + suffix)
    launches["qkv_attention_fwd" + suffix + width_suffix(dh)] += 1
    return y, ctx, lse


def qkv_attention_fwd(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                      causal=False, dropout_rate=0.0, dropout_seed=0):
    """#1 with residuals: (y, ctx, lse) as :func:`reference_qkv_fwd`
    computes them.  CPU tensors take the plain twin; CUDA tensors launch
    the kernel or raise; at a head width the kernel does not take
    (``composes``) they take the twin too, as the reference's plan does."""
    if x.device.type == "cpu" or composes("qkv_attention_fwd",
                                          _d_head(w_qkv, n_head), x.dtype):
        return reference_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale,
                                 causal, dropout_rate, dropout_seed)
    return _launch_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                           dropout_rate, dropout_seed)


#: the walks of ``ptt_qkv_bwd``'s mask: bit 0 the dq walk (#2), bit 1 the
#: dkv walk (#3); the pair runs both
WALK_DQ, WALK_DKV = 1, 2


def _launch_qkv_bwd(walks, x, w_qkv, w_out, bias, g, ctx, lse, n_head,
                    scale, causal, dropout_rate, dropout_seed):
    """Launch ``ptt_qkv_bwd`` with the ``walks`` mask: one projection
    stage, the selected walks and one set of output GEMMs.  Returns (dx,
    dW [dm, w] over the selected walks' columns of the packed q|k|v, dW_out
    or None without the dq walk); one more launch of each selected walk's
    kernel (``qkv_bwd_dq``, ``qkv_bwd_dkv``)."""
    what = {WALK_DQ: "qkv_bwd_dq", WALK_DKV: "qkv_bwd_dkv",
            WALK_DQ | WALK_DKV: "qkv_bwd"}[walks]
    b, t, dm, hd, strides, bias_ptr = _qkv_args(
        what, x, w_qkv, w_out, bias, n_head, g=g, ctx=ctx, lse=lse)
    suffix = KERNEL_DTYPES[x.dtype]
    dh = hd // n_head
    drop = _dropout_args(dropout_rate, dropout_seed, t, t, what)
    sms = sm_count(x.device)
    lib = _build.lib()
    scratch = torch.empty(
        lib.ptt_qkv_bwd_scratch(walks, b, t, dm, n_head, dh, sms),
        dtype=torch.float32, device=x.device)
    cols = hd * ((1 if walks & WALK_DQ else 0) + (2 if walks & WALK_DKV
                                                  else 0))
    dx = torch.empty_like(x)
    dw = torch.empty((dm, cols), dtype=x.dtype, device=x.device)
    dw_out = (torch.empty((hd, dm), dtype=x.dtype, device=x.device)
              if walks & WALK_DQ else None)
    err = getattr(lib, "ptt_qkv_bwd" + suffix)(
        walks, x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), bias_ptr,
        *strides, g.data_ptr(), ctx.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        None if dw_out is None else dw_out.data_ptr(), b, t, dm, n_head, dh,
        sms, float(scale), int(bool(causal)), *drop, _build.stream_of(x))
    _build.check(err, what + suffix)
    for bit, name in ((WALK_DQ, "qkv_bwd_dq"), (WALK_DKV, "qkv_bwd_dkv")):
        if walks & bit:
            launches[name + suffix + width_suffix(dh)] += 1
    return dx, dw, dw_out


def reference_qkv_bwd(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1,
                      scale=1.0, causal=False, dropout_rate=0.0,
                      dropout_seed=0):
    """Plain twin of the pair #2 + #3: (dx [b, t, dm], dW_qkv [dm, 3hd]
    packed q|k|v, dW_out [hd, dm]) from g = dL/dy and #1's residuals: dq,
    dk and dv as the twins of #6 and #7 compute them over the recomputed
    q, k, v and dctx, then dx = [dq | dk | dv] w_qkv^T as one product,
    dW_qkv = x^T [dq | dk | dv] and dW_out = ctx^T g."""
    q, k, v, dctx, delta = _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head)
    dq = reference_flash_bwd_dq(q, k, v, bias, dctx, lse, delta, scale,
                                causal, dropout_rate, dropout_seed)
    dk, dv = reference_flash_bwd_dkv(q, k, v, bias, dctx, lse, delta, scale,
                                     causal, dropout_rate, dropout_seed)
    dqkv = torch.cat([_rows(dq), _rows(dk), _rows(dv)], dim=1)
    dx = (dqkv @ _wide(w_qkv).transpose(0, 1)).reshape(x.shape)
    return (dx.to(x.dtype),
            (_rows(_wide(x)).transpose(0, 1) @ dqkv).to(w_qkv.dtype),
            (_rows(_wide(ctx)).transpose(0, 1) @ _rows(_wide(g))).to(
                w_out.dtype))


def qkv_bwd(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1, scale=1.0,
            causal=False, dropout_rate=0.0, dropout_seed=0):
    """The pair #2 + #3: (dx, dW_qkv packed [dm, 3hd], dW_out) as
    :func:`reference_qkv_bwd` computes them, through one ``ptt_qkv_bwd``
    call with both walks (CPU: the twin; CUDA: the kernels, the twin at a
    composed head width, or an error).  Counts one launch, or one composed
    call, of each of ``qkv_bwd_dq`` and ``qkv_bwd_dkv``."""
    d_head = _d_head(w_qkv, n_head)
    # on the card both names are counted as composed, or neither is
    if x.device.type == "cpu" or (composes("qkv_bwd_dq", d_head, x.dtype)
                                  and composes("qkv_bwd_dkv", d_head,
                                               x.dtype)):
        return reference_qkv_bwd(x, w_qkv, w_out, bias, g, ctx, lse, n_head,
                                 scale, causal, dropout_rate, dropout_seed)
    return _launch_qkv_bwd(WALK_DQ | WALK_DKV, x, w_qkv, w_out, bias, g,
                           ctx, lse, n_head, scale, causal, dropout_rate,
                           dropout_seed)


def qkv_bwd_dq(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1, scale=1.0,
               causal=False, dropout_rate=0.0, dropout_seed=0):
    """#2: (dx_q, dW_q, dW_out) as :func:`reference_qkv_bwd_dq` computes
    them (CPU: the twin; CUDA: ``ptt_qkv_bwd`` with the dq walk alone, the
    twin at a composed head width, or an error)."""
    if x.device.type == "cpu" or composes("qkv_bwd_dq",
                                          _d_head(w_qkv, n_head), x.dtype):
        return reference_qkv_bwd_dq(x, w_qkv, w_out, bias, g, ctx, lse,
                                    n_head, scale, causal, dropout_rate,
                                    dropout_seed)
    return _launch_qkv_bwd(WALK_DQ, x, w_qkv, w_out, bias, g, ctx, lse,
                           n_head, scale, causal, dropout_rate, dropout_seed)


def qkv_bwd_dkv(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1, scale=1.0,
                causal=False, dropout_rate=0.0, dropout_seed=0):
    """#3: (dx_kv, dW_k, dW_v) as :func:`reference_qkv_bwd_dkv` computes
    them (CPU: the twin; CUDA: ``ptt_qkv_bwd`` with the dkv walk alone,
    dW_k and dW_v as views of its [dm, 2hd] output, the twin at a composed
    head width, or an error)."""
    if x.device.type == "cpu" or composes("qkv_bwd_dkv",
                                          _d_head(w_qkv, n_head), x.dtype):
        return reference_qkv_bwd_dkv(x, w_qkv, w_out, bias, g, ctx, lse,
                                     n_head, scale, causal, dropout_rate,
                                     dropout_seed)
    dx, dw, _ = _launch_qkv_bwd(WALK_DKV, x, w_qkv, w_out, bias, g, ctx,
                                lse, n_head, scale, causal, dropout_rate,
                                dropout_seed)
    hd = dw.shape[1] // 2
    return dx, dw[:, :hd], dw[:, hd:]


class _FlashQKVAttention(torch.autograd.Function):
    """y = flash_qkv_attention(x, w_qkv, w_out, bias); saves x, the
    weights, the bias and #1's residuals ctx and lse.  Its backward runs
    the pair #2 + #3 once (:func:`qkv_bwd`), which returns dx whole and
    dW_qkv packed as [dW_q | dW_k | dW_v] (the reference sums dx and
    packs dW outside its kernels, ``_unpack_dw_qkv``).
    A bias that requires grad gets a plain recompute of ds reduced to its
    shape (the reference's ``_dbias_xla``, under the same dropout mask);
    attention masks do not, and get None.  Under dropout only the rate and
    the seed are saved beside the tensors: the backward kernels regenerate
    the mask."""

    @staticmethod
    def forward(fn, x, w_qkv, w_out, bias, n_head, scale, causal, rate,
                seed):
        y, ctx, lse = qkv_attention_fwd(x, w_qkv, w_out, bias, n_head,
                                        scale, causal, rate, seed)
        fn.save_for_backward(x, w_qkv, w_out, bias, ctx, lse)
        fn.kw = dict(n_head=n_head, scale=scale, causal=causal,
                     dropout_rate=rate, dropout_seed=seed)
        return y

    @staticmethod
    def backward(fn, g):
        x, w_qkv, w_out, bias, ctx, lse = fn.saved_tensors
        kw = fn.kw
        args = (x, w_qkv, w_out, bias, g.contiguous(), ctx, lse)
        dx, dw_qkv, dw_out = qkv_bwd(*args, **kw)
        dbias = None
        if fn.needs_input_grad[3]:
            q, k, v, dctx, delta = _qkv_recompute(
                x, w_qkv, w_out, args[4], ctx, kw["n_head"])
            _, ds = _dscores(q, k, v, bias, dctx, lse, delta, kw["scale"],
                             kw["causal"], kw["dropout_rate"],
                             kw["dropout_seed"])
            dbias = _reduce_to(ds, bias.shape).to(bias.dtype)
        return (dx, dw_qkv, dw_out, dbias, None, None, None, None, None)


def flash_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                        causal=False, dropout_rate=0.0, dropout_seed=None):
    """Self-attention with the q/k/v and output projections fused in.

    x [b, t, d_model] f32; w_qkv [d_model, 3*h*dh] packed q|k|v, head-major
    within each third (the ``layers.fc`` layout); w_out [h*dh, d_model];
    bias broadcastable to [b, 1|h, 1|t, t] (the key-padding bias is
    [b, 1, 1, t], the decoder's [b, 1, t, t]).  Returns [b, t, d_model].

    Where autograd wants a gradient of any input it runs #1 with residuals
    and, in the backward, the pair #2 + #3 in one call (gradients of x, w_qkv, w_out, and of
    the bias when it requires grad); otherwise #1 alone, as serving runs
    it under ``torch.no_grad()``.  CPU tensors take the plain twins; CUDA
    tensors launch the kernels, which take dh == 64 or, in bf16 (amp), 128
    (#1 in f32 also 128, so f32 serving runs at 128; the f32 pair #2 + #3
    does not, so an f32 gradient at 128 raises before #1 launches) and
    d_model % 32 == 0 and raise on anything else, except at dh % 64 != 0,
    where the reference's plan
    runs its composition and so does the port (the twins, counted in
    ``kernels.composed``).  ``dropout_rate`` > 0 drops
    the attention weights inside the kernels under the site's uint32
    ``dropout_seed``
    (the mask of :func:`flash_attention` for the same seed); the caller
    passes 0 at inference.
    """
    b, t, _ = x.shape
    rate, seed = _dropout_args(dropout_rate, dropout_seed, t, t,
                               "flash_qkv_attention")[:2]
    if w_qkv.shape[1] % (3 * n_head):
        raise ValueError(
            f"flash_qkv_attention: packed dim {w_qkv.shape[1]} not "
            f"divisible by 3*n_head={3 * n_head}")
    if bias is not None:
        bias = _bias_4d(bias, b, n_head, t, t, "flash_qkv_attention")
    d_head = _d_head(w_qkv, n_head)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, w_qkv, w_out, bias)):
        if x.device.type != "cpu":
            # the backward's kernels must take this width before the
            # forward launches (raises where they do not)
            for name in ("qkv_bwd_dq", "qkv_bwd_dkv"):
                head_route(name, d_head, x.dtype)
        return _FlashQKVAttention.apply(
            x.contiguous(), w_qkv.contiguous(), w_out.contiguous(), bias,
            n_head, float(scale), bool(causal), rate, seed)
    if x.device.type == "cpu" or composes("qkv_attention_fwd", d_head,
                                          x.dtype):
        return reference_qkv_attention(x, w_qkv, w_out, bias, n_head,
                                       scale, causal, rate, seed)
    return _launch_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                           rate, seed)[0]


# ---------------------------------------------------------------------------
# flash_attention: kernels #4, #6, #7 (bthd) and #5, #8, #9 (bhtd)
# ---------------------------------------------------------------------------


def _causal_keep(tq, tk, device):
    """[tq, tk] bool: query i sees key j when j <= i + tk - tq (the
    reference's bottom-right-aligned causal mask)."""
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril(tk - tq)


def _heads_first(a):
    """[b, t, h, d] -> [b, h, t, d], in f32 (f64 stays f64)."""
    return a.transpose(1, 2).to(torch.promote_types(a.dtype, torch.float32))


def reference_flash_fwd(q, k, v, bias=None, scale=1.0, causal=False,
                        dropout_rate=0.0, dropout_seed=0):
    """Plain PyTorch twin of #4: q [b, tq, h, d], k/v [b, tk, h, d], bias
    broadcastable to [b, h, tq, tk].  Returns (out [b, tq, h, d], lse
    [b, h, tq] f32).  A row whose max score is <= -1e29 gets a zero
    output and lse = +inf, as in the kernel.  Under dropout the weights
    multiplying v are dropped by :func:`hash_rng.keep_mask_attn` and the
    output scaled by 1 / (1 - rate); the normalizer and lse keep the
    undropped weights."""
    qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
    s = (qh * scale) @ kh.transpose(-1, -2)
    if bias is not None:
        s = s + bias.to(s.dtype)
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device),
                          MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    masked = m <= -1e29
    if dropout_rate:
        keep = hash_rng.keep_mask_attn(dropout_seed, p.shape, dropout_rate,
                                       device=p.device)
        out = ((torch.where(keep, p, 0.0) @ vh) * (1.0 / (1.0 - dropout_rate))
               / l).masked_fill(masked, 0.0)
    else:
        out = ((p @ vh) / l).masked_fill(masked, 0.0)
    lse = (m + torch.log(l)).masked_fill(masked, float("inf"))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def _probs(q, k, bias, lse, scale, causal):
    """p = exp(q k^T * scale + bias - lse) [b, h, tq, tk], causally hidden
    keys 0: the probabilities both backward kernels recompute."""
    s = (_heads_first(q) @ _heads_first(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(p.shape[-2], p.shape[-1], p.device),
                          0.0)
    return p


def _dscores(q, k, v, bias, dout, lse, delta, scale, causal,
             dropout_rate=0.0, dropout_seed=0):
    """(pv, p * (dp - delta)), both [b, h, tq, tk], with dp = dO v^T: the
    gradient of the loss with respect to the biased scores is the second.
    Under dropout dp is dropped and scaled (keep ? dp * inv_keep : 0) and
    pv, the weights dv sums, is keep ? p * inv_keep : 0; otherwise pv is
    p."""
    p = _probs(q, k, bias, lse, scale, causal)
    dp = _heads_first(dout) @ _heads_first(v).transpose(-1, -2)
    pv = p
    if dropout_rate:
        keep = hash_rng.keep_mask_attn(dropout_seed, p.shape, dropout_rate,
                                       device=p.device)
        inv_keep = 1.0 / (1.0 - dropout_rate)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        pv = torch.where(keep, p * inv_keep, 0.0)
    return pv, p * (dp - delta[..., None])


def reference_flash_bwd_dq(q, k, v, bias, dout, lse, delta, scale=1.0,
                           causal=False, dropout_rate=0.0, dropout_seed=0):
    """Plain twin of #6: dq [b, tq, h, d] = ds k, with delta [b, h, tq] =
    rowsum(dout * out) of the (dropped) output."""
    _, ds = _dscores(q, k, v, bias, dout, lse, delta, scale, causal,
                     dropout_rate, dropout_seed)
    return ((ds * scale) @ _heads_first(k)).transpose(1, 2).to(q.dtype)


def reference_flash_bwd_dkv(q, k, v, bias, dout, lse, delta, scale=1.0,
                            causal=False, dropout_rate=0.0, dropout_seed=0):
    """Plain twin of #7: (dk = ds^T q, dv = pv^T dout), each [b, tk, h,
    d]."""
    p, ds = _dscores(q, k, v, bias, dout, lse, delta, scale, causal,
                     dropout_rate, dropout_seed)
    dk = (ds * scale).transpose(-1, -2) @ _heads_first(q)
    dv = p.transpose(-1, -2) @ _heads_first(dout)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _bthd(a):
    """[b, h, t, d] <-> [b, t, h, d] (a view)."""
    return a.transpose(1, 2)


def reference_flash_fwd_bhtd(q, k, v, bias=None, scale=1.0, causal=False,
                             dropout_rate=0.0, dropout_seed=0):
    """Plain twin of #5: :func:`reference_flash_fwd` over q [b, h, tq, d],
    k/v [b, h, tk, d].  Returns (out [b, h, tq, d], lse [b, h, tq])."""
    out, lse = reference_flash_fwd(_bthd(q), _bthd(k), _bthd(v), bias, scale,
                                   causal, dropout_rate, dropout_seed)
    return _bthd(out).contiguous(), lse


def reference_flash_bwd_dq_bhtd(q, k, v, bias, dout, lse, delta, scale=1.0,
                                causal=False, dropout_rate=0.0,
                                dropout_seed=0):
    """Plain twin of #8: :func:`reference_flash_bwd_dq` in [b, h, t, d]."""
    return _bthd(reference_flash_bwd_dq(
        _bthd(q), _bthd(k), _bthd(v), bias, _bthd(dout), lse, delta, scale,
        causal, dropout_rate, dropout_seed)).contiguous()


def reference_flash_bwd_dkv_bhtd(q, k, v, bias, dout, lse, delta, scale=1.0,
                                 causal=False, dropout_rate=0.0,
                                 dropout_seed=0):
    """Plain twin of #9: :func:`reference_flash_bwd_dkv` in [b, h, t, d]."""
    dk, dv = reference_flash_bwd_dkv(
        _bthd(q), _bthd(k), _bthd(v), bias, _bthd(dout), lse, delta, scale,
        causal, dropout_rate, dropout_seed)
    return _bthd(dk).contiguous(), _bthd(dv).contiguous()


def _dims(a, fmt):
    """(b, h, t, d) of a q/k/v tensor in ``fmt``."""
    if fmt == "bthd":
        b, t, h, d = a.shape
    else:
        b, h, t, d = a.shape
    return b, h, t, d


def _kernel_args(what, fmt, q, k, bias, **more):
    """Check the operands of a flash kernel and return (b, tq, tk, h, d,
    bias strides, bias pointer, entry-point suffix).  Each tensor must be a
    contiguous [b, t, h, d] (``fmt`` "bthd") or [b, h, t, d] ("bhtd")
    tensor of q's dtype (f32 or bf16), at a head width d the kernel is
    compiled for (64; bf16 also 128), the bias of that dtype too, or, for
    lse and delta, an f32 [b, h, tq], on q's CUDA device and 16-byte
    aligned; the kernels index raw pointers."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {q.device}")
    dtype, suffix = _kernel_dtype(q, what)
    b, h, tq, d = _dims(q, fmt)
    tk = _dims(k, fmt)[2]
    if d not in compiled_widths(what, dtype):
        raise ValueError(f"{what}: the CUDA kernel takes head width "
                         f"{compiled_widths(what, dtype)}, got {d}")

    def rows(t):
        return (b, t, h, d) if fmt == "bthd" else (b, h, t, d)

    shapes = {"q": rows(tq), "k": rows(tk), "v": rows(tk), "dout": rows(tq),
              "lse": (b, h, tq), "delta": (b, h, tq)}
    tensors = dict(q=q, k=k, **more)
    _build.require({name: (a, torch.float32 if name in ("lse", "delta")
                           else dtype, shapes[name])
                    for name, a in tensors.items()}, q.device, what)
    _require_aligned(what, **tensors)
    if bias is not None:
        bias = _bias_view(bias, b, h, tq, tk, what)
    return ((b, tq, tk, h, d) + _bias_strides(bias, q.device, what, dtype)
            + (suffix,))


#: fmt -> (suffix of the kernels' names and entry points, the plain twins
#: of the forward, dq and dkv kernels)
_LAYOUTS = {
    "bthd": ("", (reference_flash_fwd, reference_flash_bwd_dq,
                  reference_flash_bwd_dkv)),
    "bhtd": ("_bhtd", (reference_flash_fwd_bhtd, reference_flash_bwd_dq_bhtd,
                       reference_flash_bwd_dkv_bhtd)),
}


def _fwd(fmt, q, k, v, bias, scale, causal, dropout_rate, dropout_seed):
    suffix, (twin, _, _) = _LAYOUTS[fmt]
    what = "flash_fwd" + suffix
    if q.device.type == "cpu" or composes(what, q.shape[-1], q.dtype):
        return twin(q, k, v, bias, scale, causal, dropout_rate, dropout_seed)
    b, tq, tk, h, d, strides, bias_ptr, suffix = _kernel_args(
        what, fmt, q, k, bias, v=v)
    what += suffix
    drop = _dropout_args(dropout_rate, dropout_seed, tq, tk, what)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    err = getattr(_build.lib(), "ptt_" + what)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
        out.data_ptr(), lse.data_ptr(), b, tq, tk, h, d, float(scale),
        int(bool(causal)), *drop, _build.stream_of(q))
    _build.check(err, what)
    launches[what + width_suffix(d)] += 1
    return out, lse


def _bwd_dq(fmt, q, k, v, bias, dout, lse, delta, scale, causal,
            dropout_rate, dropout_seed):
    suffix, (_, twin, _) = _LAYOUTS[fmt]
    what = "flash_bwd_dq" + suffix
    if q.device.type == "cpu" or composes(what, q.shape[-1], q.dtype):
        return twin(q, k, v, bias, dout, lse, delta, scale, causal,
                    dropout_rate, dropout_seed)
    b, tq, tk, h, d, strides, bias_ptr, suffix = _kernel_args(
        what, fmt, q, k, bias, v=v, dout=dout, lse=lse, delta=delta)
    what += suffix
    drop = _dropout_args(dropout_rate, dropout_seed, tq, tk, what)
    dq = torch.empty_like(q)
    err = getattr(_build.lib(), "ptt_" + what)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b,
        tq, tk, h, d, float(scale), int(bool(causal)), *drop,
        _build.stream_of(q))
    _build.check(err, what)
    launches[what + width_suffix(d)] += 1
    return dq


def _bwd_dkv(fmt, q, k, v, bias, dout, lse, delta, scale, causal,
             dropout_rate, dropout_seed):
    suffix, (_, _, twin) = _LAYOUTS[fmt]
    what = "flash_bwd_dkv" + suffix
    if q.device.type == "cpu" or composes(what, q.shape[-1], q.dtype):
        return twin(q, k, v, bias, dout, lse, delta, scale, causal,
                    dropout_rate, dropout_seed)
    b, tq, tk, h, d, strides, bias_ptr, suffix = _kernel_args(
        what, fmt, q, k, bias, v=v, dout=dout, lse=lse, delta=delta)
    what += suffix
    drop = _dropout_args(dropout_rate, dropout_seed, tq, tk, what)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = getattr(_build.lib(), "ptt_" + what)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, tq, tk, h, d, float(scale), int(bool(causal)),
        *drop, _build.stream_of(q))
    _build.check(err, what)
    launches[what + width_suffix(d)] += 1
    return dk, dv


def flash_fwd(q, k, v, bias=None, scale=1.0, causal=False, dropout_rate=0.0,
              dropout_seed=0):
    """#4: (out, lse) as :func:`reference_flash_fwd` computes them.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel or raise."""
    return _fwd("bthd", q, k, v, bias, scale, causal, dropout_rate,
                dropout_seed)


def flash_bwd_dq(q, k, v, bias, dout, lse, delta, scale=1.0, causal=False,
                 dropout_rate=0.0, dropout_seed=0):
    """#6: dq as :func:`reference_flash_bwd_dq` computes it (CPU: the
    twin; CUDA: the kernel or an error)."""
    return _bwd_dq("bthd", q, k, v, bias, dout, lse, delta, scale, causal,
                   dropout_rate, dropout_seed)


def flash_bwd_dkv(q, k, v, bias, dout, lse, delta, scale=1.0, causal=False,
                  dropout_rate=0.0, dropout_seed=0):
    """#7: (dk, dv) as :func:`reference_flash_bwd_dkv` computes them (CPU:
    the twin; CUDA: the kernel or an error)."""
    return _bwd_dkv("bthd", q, k, v, bias, dout, lse, delta, scale, causal,
                    dropout_rate, dropout_seed)


def flash_fwd_bhtd(q, k, v, bias=None, scale=1.0, causal=False,
                   dropout_rate=0.0, dropout_seed=0):
    """#5: (out [b, h, tq, d], lse [b, h, tq]) of q [b, h, tq, d], k/v
    [b, h, tk, d] as :func:`reference_flash_fwd_bhtd` computes them.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel or
    raise."""
    return _fwd("bhtd", q, k, v, bias, scale, causal, dropout_rate,
                dropout_seed)


def flash_bwd_dq_bhtd(q, k, v, bias, dout, lse, delta, scale=1.0,
                      causal=False, dropout_rate=0.0, dropout_seed=0):
    """#8: dq as :func:`reference_flash_bwd_dq_bhtd` computes it (CPU: the
    twin; CUDA: the kernel or an error)."""
    return _bwd_dq("bhtd", q, k, v, bias, dout, lse, delta, scale, causal,
                   dropout_rate, dropout_seed)


def flash_bwd_dkv_bhtd(q, k, v, bias, dout, lse, delta, scale=1.0,
                       causal=False, dropout_rate=0.0, dropout_seed=0):
    """#9: (dk, dv) as :func:`reference_flash_bwd_dkv_bhtd` computes them
    (CPU: the twin; CUDA: the kernel or an error)."""
    return _bwd_dkv("bhtd", q, k, v, bias, dout, lse, delta, scale, causal,
                    dropout_rate, dropout_seed)


def _reduce_to(ds, shape):
    """Sum ds [b, h, tq, tk] over the dims a bias of ``shape`` broadcast."""
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and ds.shape[i] != 1)
    return ds.sum(dim=dims, keepdim=True) if dims else ds


class _FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v, bias) in layout ``fmt``; saves (q,
    k, v, bias, out, lse).  Its backward takes delta = rowsum(dO * out) in
    f32, then the layout's dq kernel and dkv kernel (#6 and #7 in bthd, #8
    and #9 in bhtd).  A bias that requires grad gets a plain recompute of
    ds reduced to its shape (the reference's ``_dbias_xla``, under the
    same dropout mask); attention masks do not, and get None.  Under
    dropout only the rate and the seed are saved beside the tensors: the
    backward kernels regenerate the mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, rate, seed, fmt):
        out, lse = _fwd(fmt, q, k, v, bias, scale, causal, rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.fmt = fmt
        ctx.kw = dict(scale=scale, causal=causal, dropout_rate=rate,
                      dropout_seed=seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        fmt = ctx.fmt
        dout = dout.contiguous()
        wide = torch.promote_types(out.dtype, torch.float32)
        delta = (dout.to(wide) * out.to(wide)).sum(-1)
        if fmt == "bthd":
            delta = delta.transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, bias, dout, lse, delta)
        kw = ctx.kw
        dq = _bwd_dq(fmt, *args, **kw)
        dk, dv = _bwd_dkv(fmt, *args, **kw)
        dbias = None
        if ctx.needs_input_grad[3]:
            if fmt == "bhtd":
                args = (_bthd(q), _bthd(k), _bthd(v), bias, _bthd(dout), lse,
                        delta)
            _, ds = _dscores(*args, **kw)
            dbias = _reduce_to(ds, bias.shape).to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None


def flash_attention(q, k, v, bias=None, scale=1.0, causal=False,
                    fmt="bhtd", dropout_rate=0.0, dropout_seed=None):
    """softmax(q k^T * scale + bias) v per head, differentiable in q, k, v
    (and in bias when it requires grad).

    ``fmt`` is the reference's: ``"bhtd"`` (its default) takes q
    [b, h, tq, d] and k/v [b, h, tk, d] and returns [b, h, tq, d], through
    the kernels #5, #8 and #9; ``"bthd"`` takes q [b, tq, h, d] and k/v
    [b, tk, h, d] (the layout the projections give for free) and returns
    [b, tq, h, d], through #4, #6 and #7.  A caller's transposed view
    (split heads) is copied to a contiguous tensor first, as the
    reference's ``transpose2`` copies it.  The bias broadcasts to
    [b, 1|h, 1|tq, tk] in both layouts (the key-padding [b, 1, 1, tk] and
    decoder [b, 1, tq, tk] biases are read in place, never expanded);
    ``causal`` masks keys past query + tk - tq.  f32, or bf16 (amp: q, k,
    v and the bias bf16, the output and the gradients bf16, each layout's
    ``*_bf16`` kernels on the card).  On the CPU every
    pass runs its plain twin; on CUDA the kernels (head width 64, and 128
    in bf16; at a width % 64 != 0 the twins, as the reference's plan
    composes there, counted in ``kernels.composed``).  ``dropout_rate`` >
    0 drops the
    attention weights inside the kernels under the site's uint32
    ``dropout_seed`` (the same mask in both layouts); the caller passes 0
    at inference."""
    if fmt not in _LAYOUTS:
        raise ValueError(f"flash_attention: unknown fmt {fmt!r}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            _dims(q, fmt)[:2], q.shape[-1]) != (_dims(k, fmt)[:2],
                                                k.shape[-1]):
        want = ("[b, tq, h, d] and [b, tk, h, d]" if fmt == "bthd"
                else "[b, h, tq, d] and [b, h, tk, d]")
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not {want} (fmt={fmt!r})")
    b, h, tq, _ = _dims(q, fmt)
    tk = _dims(k, fmt)[2]
    rate, seed = _dropout_args(dropout_rate, dropout_seed, tq, tk,
                               "flash_attention")[:2]
    if bias is not None:
        bias = _bias_4d(bias, b, h, tq, tk, "flash_attention")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bias, float(scale),
                                 bool(causal), rate, seed, fmt)
