"""paddle_tpu_torch at head width 128 (the serving path's kernels and the
route table), on the CPU, against the JAX package.

The reference launches its decode kernels at any d_head % 64 == 0; the
port compiles #1's f32 forward, the megasteps (#10, #12), the FFN and
flash-decode (#14, #15) for 128 too, and the bf16 training kernels (#1 to
#9, amp's).  On CPU tensors each wrapper runs its plain version, held here
against the reference's Pallas kernels in interpret mode at 8 heads of
128 (d_model 256, which passes the reference's % 128 gate).  The
wrappers' launches at 128 are held with a recording stand-in for the
library: the plan at the width, the width passed to the entry point, and
the ``_dh128`` launch counters (``_bf16_dh128`` for the bf16 kernels).
The whole-slice generation tests are in ``test_torch_head128_serving.py``,
the bf16 kernels against the reference and amp training at 128 in
``test_torch_head128_amp.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import decode_attention as jax_decode_attention
from paddle_tpu.kernels import decode_step as jax_decode_step
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as ka
from paddle_tpu_torch.kernels import decode_attention as kda
from paddle_tpu_torch.kernels import decode_step as kds

#: f32 on both sides; the packages sum in other orders (the same
#: tolerance as the head-width-64 tests of test_torch_kernels.py)
TOL = 1e-4

H, DH = 8, 128
DM, DI = 256, 512
LAYERS, LAYER = 2, 1


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash-decode (#14, #15)
# ---------------------------------------------------------------------------

#: lane 0 empty, a partial chunk, a split's edge, a full cache of 64
LENS = np.array([0, 5, 33, 64], np.int32)


def _decode_inputs(seed, rows):
    rng = np.random.RandomState(seed)
    q = rng.randn(4, H, DH).astype(np.float32)
    k = rng.randn(4, rows, H, DH).astype(np.float32)
    v = rng.randn(4, rows, H, DH).astype(np.float32)
    return rng, q, k, v


def test_flash_decode_at_128_matches_jax_interpret_kernel():
    """The ring walk at 8 heads of 128 against the interpret-mode Pallas
    kernel; the empty lane gets 0 on both."""
    _, q, k, v = _decode_inputs(0, 64)
    scale = DH ** -0.5
    ok = jax_decode_attention._decode_plan(jnp.asarray(q), jnp.asarray(k),
                                           16, True)[0]
    assert ok  # the reference launches its kernel at this width
    want = jax_decode_attention.flash_decode(
        *(jnp.asarray(a) for a in (q, k, v, LENS)), scale=scale,
        block_t=16, interpret=True)
    got = kda.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, LENS)),
                           scale=scale)
    _close(got, want)
    assert torch.count_nonzero(got[0]) == 0


def test_flash_decode_paged_at_128_matches_jax_interpret_kernel():
    """The paged walk at 8 heads of 128 on a shuffled table over a pool
    with holes, against the interpret-mode Pallas kernel, and the ring
    walk over the same rows."""
    rng, q, _, _ = _decode_inputs(1, 64)
    pool_k = rng.randn(32, 16, H, DH).astype(np.float32)
    pool_v = rng.randn(32, 16, H, DH).astype(np.float32)
    table = rng.permutation(32)[:16].reshape(4, 4).astype(np.int32)
    args = (q, pool_k, pool_v, table, LENS)
    scale = DH ** -0.5
    want = jax_decode_attention.flash_decode_paged(
        *(jnp.asarray(a) for a in args), scale=scale, interpret=True)
    got = kda.flash_decode_paged(*(torch.from_numpy(a) for a in args),
                                 scale=scale)
    _close(got, want)
    ring = kda.reference_decode(
        torch.from_numpy(q),
        torch.from_numpy(pool_k[table].reshape(4, 64, H, DH)),
        torch.from_numpy(pool_v[table].reshape(4, 64, H, DH)),
        torch.from_numpy(LENS), scale)
    _close(got, ring, 0.0)


# ---------------------------------------------------------------------------
# the fused decoder step (#10 + #11, #12 + #13)
# ---------------------------------------------------------------------------


def _weights(rng, b):
    hd = H * DH

    def f(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return [f(b, 1, DM, scale=1.0), f(DM, 3 * hd, scale=0.05),
            f(hd, DM, scale=0.05), f(DM) + 1, f(DM), f(DM, hd, scale=0.05),
            f(hd, DM, scale=0.05), f(DM) + 1, f(DM), f(DM, DI), f(DI),
            f(DI, DM), f(DM), f(DM) + 1, f(DM)]


def _ring_step_inputs(seed=0):
    """A 4-lane ring step at layer 1: ragged self lengths (mid-chunk and a
    full buffer), lane 2 inactive, lane 3 with an empty cross cache."""
    rng = np.random.RandomState(seed)
    weights = _weights(rng, 4)
    caches = [rng.randn(LAYERS, 4, 64, H, DH).astype(np.float32)
              for _ in range(4)]
    pos = np.array([0, 4, 36, 63], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    ints = [pos, pos + active, np.array([3, 64, 60, 0], np.int32), active]
    return weights, caches, ints


def test_fused_decode_step_at_128_matches_jax_interpret_kernel():
    """The ring step at 8 heads of 128, d_model 256: the output and both
    self caches after the in-place write against the reference's fused
    step in interpret mode (its plan takes this width)."""
    plan = jax_decode_step._megastep_plan(DM, H, DH, DI, 64, 64, "float32")
    assert plan.ok
    weights, caches, ints = _ring_step_inputs()
    t = [torch.from_numpy(a.copy()) for a in weights + caches + ints]
    kw = dict(layer=LAYER, n_head=H, scale=DH ** -0.5)
    got = kds.fused_decode_step(*t, **kw)
    assert got[1] is t[15] and got[2] is t[16]  # written in place
    want = jax_decode_step.fused_decode_step(
        *(jnp.asarray(a) for a in weights + caches + ints), interpret=True,
        **kw)
    for g, w in zip(got, want):
        _close(g, w)
    # the inactive lane kept its rows; the others wrote one each
    changed = (got[1][LAYER].numpy() != caches[0][LAYER]).any(axis=(2, 3))
    assert changed.sum() == 3 and not changed[2].any()


def test_fused_decode_step_paged_at_128_matches_jax_interpret_kernel():
    """The paged step at 8 heads of 128: pools of 16-row blocks behind
    shuffled disjoint tables, ragged lengths, one inactive lane, against
    the reference's paged fused step in interpret mode."""
    rng = np.random.RandomState(1)
    bt, mb = 16, 4
    weights = _weights(rng, 4)
    pools = [rng.randn(LAYERS, 24, bt, H, DH).astype(np.float32)
             for _ in range(4)]
    tables = [rng.permutation(24)[:4 * mb].reshape(4, mb).astype(np.int32)
              for _ in range(2)]
    pos = np.array([0, 17, 40, 63], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    ints = [pos, pos + active, np.array([3, 64, 30, 17], np.int32)]
    plan = jax_decode_step._paged_megastep_plan(
        DM, H, DH, DI, bt, bt, 4, mb, mb, "float32", True)
    assert plan.ok
    t = [torch.from_numpy(a.copy())
         for a in weights + pools + ints + tables + [active]]
    kw = dict(layer=LAYER, n_head=H, scale=DH ** -0.5)
    got = kds.fused_decode_step_paged(*t, **kw)
    want = jax_decode_step.fused_decode_step_paged(
        *(jnp.asarray(a) for a in weights + pools + ints + tables),
        jnp.asarray(active), interpret=True, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_array_equal(got[1][:, tables[0][2]].numpy(),
                                  pools[0][:, tables[0][2]])


# ---------------------------------------------------------------------------
# the wrappers' launches at 128 (a recording stand-in for the library)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 33, 64])
def test_megastep_launch_at_128_passes_the_width(monkeypatch, b):
    """#10 at 8 heads of 128, d_model 1024 (Transformer-big's widths):
    the wrapper plans at the width (a 4-head walk group), passes 128 to
    the occupancy query, the scratch size and the entry point, and counts
    the launch under ``megastep_dh128``."""
    n_head, dm, max_t, cross_t = H, 1024, 128, 256
    seen = {}

    class Lib:
        def ptt_megastep_occupancy(self, *args):
            seen["occupancy"] = args
            return 1

        def ptt_megastep_scratch(self, *args):
            seen["scratch"] = args
            return 40

        def ptt_megastep(self, *args):
            seen["entry"] = args
            return 0

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 7)
    monkeypatch.setattr(kds, "sm_count", lambda device: 132)
    kds._device_launch.cache_clear()
    kernels.reset_launches()
    x = torch.zeros(b, 1, dm)
    args = [x] + [torch.zeros(1)] * 16
    try:
        kds._launch_megastep("megastep", False, x, args, (max_t, cross_t),
                             (max_t, cross_t), 2, n_head, DH, 0.125, 1e-5)
    finally:
        kds._device_launch.cache_clear()
    plan = kds.megastep_plan(b, n_head, dm, 132, 1, max_t, cross_t, DH)
    assert plan.smem <= kds.MEGASTEP_SMEM_CAP
    assert seen["occupancy"] == (0, DH, plan.smem)
    assert seen["scratch"] == (b, dm, n_head, DH, plan.self_splits,
                               plan.cross_splits)
    entry = seen["entry"]
    assert entry[19:26] == (2, b, dm, n_head, DH, max_t, cross_t)
    assert entry[26:36] == plan.ints()
    assert kernels.launches["megastep_dh128"] == 1
    assert kernels.launches["megastep"] == 0


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_launch_at_128_passes_the_width(monkeypatch, b, paged):
    """#14/#15 at 8 heads of 128: a group of at most 4 heads (8 heads'
    ring does not fit a block), the width passed to the occupancy query
    and after the heads in the entry point's geometry, the launch counted
    under the ``_dh128`` name."""
    nb, bt, mb = 70, 16, 16
    seen = {}

    class Lib:
        def ptt_flash_decode_occupancy(self, *args):
            seen["occupancy"] = args
            return 8

        def ptt_flash_decode(self, *args):
            seen["entry"] = args
            return 0

        ptt_flash_decode_paged = ptt_flash_decode

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 7)
    monkeypatch.setattr(kda, "sm_count", lambda device: 132)
    kda._device_plan.cache_clear()
    kernels.reset_launches()
    q = torch.zeros(b, H, DH)
    what = "flash_decode_paged" if paged else "flash_decode"
    n_args = 5 if paged else 4
    args = [q] + [torch.zeros(1) for _ in range(n_args - 1)]
    geometry = (H, DH, nb, bt, mb) if paged else (mb * bt, H, DH)
    try:
        kda._launch_decode(what, paged, q, args, geometry, mb * bt, 0.125)
    finally:
        kda._device_plan.cache_clear()
    plan = kda.decode_plan(b, H, mb * bt, 132, kda.DECODE_BLOCKS_PER_SM, DH)
    assert plan.group <= 4 and plan.smem <= kda.SMEM_CAP
    assert seen["occupancy"] == (int(paged), DH, plan.group, plan.smem)
    rest = seen["entry"][n_args + 2:]
    assert rest[:1 + len(geometry)] == (b, *geometry)
    assert rest[1 + len(geometry):-2] == plan.ints()
    assert kernels.launches[what + "_dh128"] == 1
    assert kernels.launches[what] == 0


@pytest.mark.parametrize("b,t,rows", [(1, 256, 32), (64, 256, 64),
                                      (2, 640, 0)])
def test_qkv_launch_at_128_passes_the_width(monkeypatch, b, t, rows):
    """#1 in f32 at 8 heads of 128 under no_grad (serving): the plan's
    route (clusters of 32 or 64 rows, tiles beyond 512), the width after
    the heads in the entry point and in the scratch size, the launch
    counted under ``qkv_attention_fwd_dh128``."""
    n_head, dm = H, 1024
    seen = []

    class Lib:
        def ptt_qkv_fwd_scratch(self, *args):
            seen.append(("scratch", args))
            return 1

        def ptt_qkv_attention_fwd(self, *args):
            seen.append(("entry", args))
            return 0

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(ka, "sm_count", lambda device: 132)
    monkeypatch.setattr(ka, "_qkv_args", lambda what, x, w_qkv, w_out,
                        bias, n_head: (b, t, dm, n_head * DH, (0,) * 4,
                                       None))
    kernels.reset_launches()
    x = torch.zeros(b, t, dm)
    ka._launch_qkv_fwd(x, torch.zeros(dm, 3 * n_head * DH),
                       torch.zeros(n_head * DH, dm), None, n_head,
                       DH ** -0.5, False, 0.0, 0)
    assert seen[0] == ("scratch", (b, t, dm, n_head, DH, 132))
    assert seen[1][1][12:18] == (b, t, dm, n_head, DH, rows)
    assert kernels.launches["qkv_attention_fwd_dh128"] == 1
    assert kernels.launches["qkv_attention_fwd"] == 0


# ---------------------------------------------------------------------------
# what raises at 128 before any launch
# ---------------------------------------------------------------------------


def _meta_qkv(dh, requires_grad):
    x = torch.zeros(2, 16, 256, device="meta", requires_grad=requires_grad)
    w_qkv = torch.zeros(256, 3 * 2 * dh, device="meta")
    w_out = torch.zeros(2 * dh, 256, device="meta")
    return x, w_qkv, w_out


def test_qkv_attention_with_a_gradient_at_128_raises_before_any_launch():
    """#1 in f32 is compiled for 128 but the f32 pair #2 + #3 is not: an
    f32 call on non-CPU tensors that autograd would differentiate raises,
    naming the backward kernel and the width, before #1 runs (no launch
    counter or composition counter moves); without a gradient the same
    call reaches #1's launch (here refused for the meta device, after the
    route)."""
    kernels.reset_launches()
    x, w_qkv, w_out = _meta_qkv(128, True)
    with pytest.raises(ValueError, match="qkv_bwd_dq: .*head width 128"):
        ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, scale=0.1)
    assert not any(kernels.launches.values())
    assert not any(kernels.composed.values())
    with torch.no_grad():
        with pytest.raises(ValueError, match="no kernel for meta"):
            ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, scale=0.1)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("dh", [64, 96])
def test_qkv_attention_with_a_gradient_below_128_takes_its_route(dh):
    """At 64 (the pair is compiled) and 96 (the composition) the gradient
    check passes: 64 reaches the forward's launch (refused for the meta
    device), 96 composes."""
    kernels.reset_launches()
    x, w_qkv, w_out = _meta_qkv(dh, True)
    if dh == 64:
        with pytest.raises(ValueError, match="no kernel for meta"):
            ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, scale=0.1)
    else:
        ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, scale=0.1)
        assert kernels.composed["qkv_attention_fwd"] == 1
    kernels.reset_launches()


@pytest.mark.parametrize("what", ["bf16 qkv", "flash bthd", "flash bhtd",
                                  "bf16 flash"])
def test_training_and_bf16_routes_raise_at_128(what):
    """What no kernel takes raises, naming the kernel and the width,
    before any launch or composition: the f32 training kernels at 128
    (the bthd and bhtd flash kernels, #4-#9; "bf16 qkv": the f32 pair #2 +
    #3 called itself) and the bf16 instantiations, compiled for 64 and
    128, at 192 ("bf16 qkv": #1 and the pair; "bf16 flash": #4 in both
    layouts)."""
    kernels.reset_launches()
    q = torch.zeros(2, 16, 2, 128, device="meta")
    if what == "bf16 qkv":
        x, w_qkv, w_out = _meta_qkv(128, False)
        g, ctx = torch.zeros_like(x), torch.zeros(2, 16, 2, 128,
                                                  device="meta")
        lse = torch.zeros(2, 2, 16, device="meta")
        with pytest.raises(ValueError, match="qkv_bwd_dq: .*head width 128"):
            ka.qkv_bwd(x, w_qkv, w_out, None, g, ctx, lse, n_head=2)
        for grad in (False, True):
            x, w_qkv, w_out = (a.to(torch.bfloat16)
                               for a in _meta_qkv(192, grad))
            with torch.set_grad_enabled(grad), pytest.raises(
                    ValueError, match="bfloat16: .*head width 192"):
                ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, scale=0.1)
    elif what == "bf16 flash":
        qb = torch.zeros(2, 16, 2, 192, device="meta", dtype=torch.bfloat16)
        for fmt in ("bthd", "bhtd"):
            with pytest.raises(ValueError, match="head width 192"):
                ka.flash_attention(qb, qb, qb, scale=0.1, fmt=fmt)
    else:
        fmt = what.split()[1]
        with pytest.raises(ValueError, match="head width 128"):
            ka.flash_attention(q, q, q, scale=0.1, fmt=fmt)
    assert not any(kernels.launches.values())
    assert not any(kernels.composed.values())


def _stand_in(monkeypatch, b, t, dm, dh):
    """A recording stand-in for the kernel library, with the operand
    checks stubbed for meta tensors (whose data pointers are 0): returns
    the list of (entry, args) calls it sees."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 1 if name.endswith("scratch") else 0
            return entry

    def flash_args(what, fmt, q, k, bias, **more):
        bq, hq, tq, d = ka._dims(q, fmt)
        return (bq, tq, ka._dims(k, fmt)[2], hq, d, (0,) * 4, None,
                "_bf16")

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(ka, "sm_count", lambda device: 132)
    monkeypatch.setattr(ka, "_qkv_args", lambda what, x, w_qkv, w_out,
                        bias, n_head, **more: (b, t, dm, n_head * dh,
                                               (0,) * 4, None))
    monkeypatch.setattr(ka, "_kernel_args", flash_args)
    return calls


#: the bf16 wrappers compiled for 128: (wrapper, layout or None for the
#: fused kernels, its entry point, the counters it moves)
BF16_LAUNCHES = [
    ("flash_fwd", "bthd", "ptt_flash_fwd_bf16", ["flash_fwd"]),
    ("flash_bwd_dq", "bthd", "ptt_flash_bwd_dq_bf16", ["flash_bwd_dq"]),
    ("flash_bwd_dkv", "bthd", "ptt_flash_bwd_dkv_bf16", ["flash_bwd_dkv"]),
    ("flash_fwd_bhtd", "bhtd", "ptt_flash_fwd_bhtd_bf16",
     ["flash_fwd_bhtd"]),
    ("flash_bwd_dq_bhtd", "bhtd", "ptt_flash_bwd_dq_bhtd_bf16",
     ["flash_bwd_dq_bhtd"]),
    ("flash_bwd_dkv_bhtd", "bhtd", "ptt_flash_bwd_dkv_bhtd_bf16",
     ["flash_bwd_dkv_bhtd"]),
    ("qkv_attention_fwd", None, "ptt_qkv_attention_fwd_bf16",
     ["qkv_attention_fwd"]),
    ("qkv_bwd", None, "ptt_qkv_bwd_bf16", ["qkv_bwd_dq", "qkv_bwd_dkv"]),
    ("qkv_bwd_dq", None, "ptt_qkv_bwd_bf16", ["qkv_bwd_dq"]),
    ("qkv_bwd_dkv", None, "ptt_qkv_bwd_bf16", ["qkv_bwd_dkv"])]


@pytest.mark.parametrize("name,fmt,entry,counters", BF16_LAUNCHES,
                         ids=[c[0] for c in BF16_LAUNCHES])
def test_bf16_wrappers_launch_at_128(monkeypatch, name, fmt, entry,
                                     counters):
    """Each bf16 training wrapper on non-CPU tensors at 2 heads of 128
    launches its kernel: its entry point takes the width 128 after the
    heads, and each of its kernels counts one launch under its
    ``_bf16_dh128`` counter, nothing else moving."""
    b, t, h, dh = 2, 16, 2, 128
    dm = h * dh
    calls = _stand_in(monkeypatch, b, t, dm, dh)
    kernels.reset_launches()
    meta = dict(device="meta", dtype=torch.bfloat16)
    if fmt is not None:
        shape = (b, t, h, dh) if fmt == "bthd" else (b, h, t, dh)
        q = torch.zeros(shape, **meta)
        stats = torch.zeros(b, h, t, device="meta")
        args = (q, q, q, None) if "fwd" in name else (q, q, q, None, q,
                                                      stats, stats)
        getattr(ka, name)(*args, scale=0.1)
        # the arguments before b: the tensors' pointers and the bias's
        # four strides
        at = 10 if "fwd" in name else 12 if "dq" in name else 13
        assert calls[-1][0] == entry
        assert calls[-1][1][at:at + 5] == (b, t, t, h, dh)
    else:
        x = torch.zeros(b, t, dm, **meta)
        w_qkv = torch.zeros(dm, 3 * dm, **meta)
        w_out = torch.zeros(dm, dm, **meta)
        if name == "qkv_attention_fwd":
            ka.qkv_attention_fwd(x, w_qkv, w_out, None, n_head=h)
            assert calls[-1][0] == entry
            assert calls[-1][1][12:17] == (b, t, dm, h, dh)
        else:
            ctx = torch.zeros(b, t, h, dh, **meta)
            lse = torch.zeros(b, h, t, device="meta")
            getattr(ka, name)(x, w_qkv, w_out, None, x, ctx, lse, n_head=h)
            assert [c[0] for c in calls] == ["ptt_qkv_bwd_scratch", entry]
            assert calls[0][1][1:7] == (b, t, dm, h, dh, 132)
            assert calls[1][1][16:22] == (b, t, dm, h, dh, 132)
    assert {k: n for k, n in kernels.launches.items() if n} == {
        c + "_bf16_dh128": 1 for c in counters}
    assert not any(kernels.composed.values())
    kernels.reset_launches()


def test_qkv_attention_bf16_with_a_gradient_at_128_launches_the_pair(
        monkeypatch):
    """In bf16 (amp) the pair #2 + #3 is compiled for 128: a call that
    autograd differentiates runs #1 forward and, in the backward, the pair
    in one ``ptt_qkv_bwd_bf16`` call with both walks at width 128, counted
    once each under ``qkv_attention_fwd_bf16_dh128``,
    ``qkv_bwd_dq_bf16_dh128`` and ``qkv_bwd_dkv_bf16_dh128``."""
    b, t, h, dh = 2, 16, 2, 128
    dm = h * dh
    calls = _stand_in(monkeypatch, b, t, dm, dh)
    kernels.reset_launches()
    meta = dict(device="meta", dtype=torch.bfloat16, requires_grad=True)
    x = torch.zeros(b, t, dm, **meta)
    w_qkv = torch.zeros(dm, 3 * dm, **meta)
    w_out = torch.zeros(dm, dm, **meta)
    y = ka.flash_qkv_attention(x, w_qkv, w_out, n_head=h, scale=dh ** -0.5)
    y.backward(torch.zeros_like(y))
    entries = [name for name, _ in calls if not name.endswith("scratch")]
    assert entries == ["ptt_qkv_attention_fwd_bf16", "ptt_qkv_bwd_bf16"]
    pair = [args for name, args in calls if name == "ptt_qkv_bwd_bf16"][0]
    assert pair[0] == ka.WALK_DQ | ka.WALK_DKV
    assert pair[16:22] == (b, t, dm, h, dh, 132)
    assert {k: n for k, n in kernels.launches.items() if n} == {
        "qkv_attention_fwd_bf16_dh128": 1, "qkv_bwd_dq_bf16_dh128": 1,
        "qkv_bwd_dkv_bf16_dh128": 1}
    assert x.grad.shape == x.shape and w_qkv.grad.shape == w_qkv.shape
    kernels.reset_launches()
