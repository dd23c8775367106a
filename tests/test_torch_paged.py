"""paddle_tpu_torch's paged KV cache and unfused decoder step against the
JAX package, on the CPU.

The block allocator and the cache's host choreography (fork, copy-on-
write) follow the reference's step for step; the paged megastep's plain
path is held against the interpret-mode Pallas kernel and, where the
kernel and the reference's composition differ (a row past the logical
window), against the composition; whole generation paths (paged fused,
ring unfused, paged unfused) against the reference's programs built with
the matching flags, weights carried over by load_paddle_tpu_params.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor as ex
from paddle_tpu.flags import FLAGS
from paddle_tpu.generation import GenerationSession as JaxSession
from paddle_tpu.generation import kv_cache as jax_kv_cache
from paddle_tpu.kernels import decode_step as jax_decode_step
from paddle_tpu.models import transformer as T
from paddle_tpu_torch import (BlockAllocator, GenerationSession,
                              PagedKVCache, Transformer)
from paddle_tpu_torch.interop import (load_paddle_tpu_params,
                                      paddle_tpu_param_names)
from paddle_tpu_torch.kernels import decode_step as kds

#: f32 on both sides; the packages sum in different orders
TOL = 1e-4

WIDTHS = dict(src_vocab_size=64, trg_vocab_size=64, max_length=20,
              n_head=2, d_key=64, d_value=64, d_model=128, d_inner_hid=256)
BATCH, SRC_LEN, MAX_OUT, BLOCK_T = 2, 16, 10, 8


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the allocator and the cache's host choreography
# ---------------------------------------------------------------------------


def _allocator_script(alloc):
    """One scripted alloc/share/free sequence; returns what it observed."""
    seen = []

    def note(value=None):
        seen.append((value, alloc.free_count, alloc.used_count,
                     [alloc.refcount(b) for b in range(alloc.num_blocks)]))

    a = alloc.alloc(3)
    note(a)
    b = alloc.alloc(2)
    note(b)
    alloc.share(a[:2])
    alloc.share(a[:1])
    note()
    alloc.free(a)
    note()
    for bad in (lambda: alloc.alloc(alloc.free_count + 1),
                lambda: alloc.share([alloc.num_blocks - 1]),
                lambda: alloc.free([alloc.num_blocks - 1])):
        with pytest.raises((MemoryError, ValueError)) as err:
            bad()
        note(err.type.__name__)
    alloc.free(a[:2])
    alloc.free(b)
    note(alloc.alloc(alloc.free_count))
    return seen


@pytest.mark.parametrize("reserve", [0, 1])
def test_block_allocator_matches_reference(reserve):
    got = _allocator_script(BlockAllocator(8, reserve=reserve))
    want = _allocator_script(jax_kv_cache.BlockAllocator(8, reserve=reserve))
    assert got == want
    assert got[0][0] == list(range(reserve, reserve + 3))  # lowest first


def _cache_pair():
    """The reference's and the port's dynamic paged caches over the same
    pool contents: 1 layer, 2 slots, 32 rows, 8-row blocks, 8 blocks."""
    geo = dict(num_layers=1, batch=2, max_t=32, n_head=2, d_head=64,
               block_t=8, num_blocks=8)
    jax_cache = jax_kv_cache.PagedKVCache("t", **geo)
    scope = ex.Scope()
    jax_cache.reset_dynamic(scope)
    port = PagedKVCache(**geo, device="cpu")
    port.reset_dynamic()
    pool = np.random.RandomState(0).randn(*port.shape).astype(np.float32)
    scope.set_var(jax_cache.k_name, jnp.asarray(pool))
    scope.set_var(jax_cache.v_name, jnp.asarray(-pool))
    port.k.copy_(torch.from_numpy(pool))
    port.v.copy_(torch.from_numpy(-pool))
    return jax_cache, scope, port


def test_fork_and_copy_on_write_match_reference():
    """fork_slot shares slot 0's blocks into slot 1; an append into a
    shared block copies it first (tables, refcounts and pools as the
    reference's), and an unshared append copies nothing."""
    jax_cache, scope, port = _cache_pair()
    for cache_args, cache in (((scope,), jax_cache), ((), port)):
        blocks = cache.allocator.alloc(2)
        cache.set_table_row(*cache_args, 0, blocks)
    scope.set_var(jax_cache.len_name, jnp.asarray([12, 0], jnp.int32))
    port.lengths.copy_(torch.tensor([12, 0], dtype=torch.int32))

    jax_cache.fork_slot(scope, 1, 0, 12)
    port.fork_slot(1, 0, 12)
    assert jax_cache.cow_if_shared(scope, 0, 12)
    assert port.cow_if_shared(0, 12)
    assert not port.cow_if_shared(0, 13)
    np.testing.assert_array_equal(port.host_table,
                                  jax_cache.host_table(scope))
    np.testing.assert_array_equal(port.table.numpy(), port.host_table)
    assert ([port.allocator.refcount(b) for b in range(8)]
            == [jax_cache.allocator.refcount(b) for b in range(8)])
    np.testing.assert_array_equal(port.k.numpy(),
                                  np.asarray(scope.find_var(
                                      jax_cache.k_name)))
    np.testing.assert_array_equal(port.v.numpy(),
                                  np.asarray(scope.find_var(
                                      jax_cache.v_name)))


def test_static_tables_and_geometry_match_reference():
    geo = dict(num_layers=2, batch=3, max_t=40, n_head=2, d_head=64,
               block_t=16)
    ref = jax_kv_cache.PagedKVCache("t", **geo)
    port = PagedKVCache(**geo, device="cpu")
    scope = ex.Scope()
    ref.allocate(scope)
    port.allocate()
    np.testing.assert_array_equal(port.table.numpy(), ref.host_table(scope))
    assert port.allocator is None
    for name in ("max_blocks", "num_blocks", "logical_max_t", "block_bytes",
                 "hbm_bytes"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.blocks_for(17) == ref.blocks_for(17) == 2
    with pytest.raises(ValueError):
        PagedKVCache(**dict(geo, block_t=12), device="cpu")
    with pytest.raises(ValueError):
        PagedKVCache(**geo, num_blocks=4, device="cpu").allocate()


# ---------------------------------------------------------------------------
# fused_decode_step_paged
# ---------------------------------------------------------------------------

_DM, _H, _DH, _DI, _BT, _MB = 128, 8, 64, 256, 16, 4


def _paged_step_inputs(pos, active, cross_lengths, seed=0):
    """Weights, pools ([2, 24, 16, 8, 64], half of them unreferenced),
    shuffled disjoint tables and the int vectors of a 4-lane paged step
    at layer 1."""
    rng = np.random.RandomState(seed)
    hd = _H * _DH

    def f(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    weights = [f(4, 1, _DM, scale=1.0), f(_DM, 3 * hd), f(hd, _DM),
               f(_DM) + 1, f(_DM), f(_DM, hd), f(hd, _DM), f(_DM) + 1,
               f(_DM), f(_DM, _DI), f(_DI), f(_DI, _DM), f(_DM),
               f(_DM) + 1, f(_DM)]
    pools = [f(2, 24, _BT, _H, _DH, scale=1.0) for _ in range(4)]
    tables = [rng.permutation(24)[:4 * _MB].reshape(4, _MB).astype(np.int32)
              for _ in range(2)]
    pos = np.asarray(pos, np.int32)
    active = np.asarray(active, np.int32)
    ints = [pos, pos + active, np.asarray(cross_lengths, np.int32)]
    return weights, pools, ints, tables, active


def _run_port_paged(weights, pools, ints, tables, active):
    t = [torch.from_numpy(a.copy())
         for a in weights + pools + ints + tables + [active]]
    out, ck, cv = kds.fused_decode_step_paged(*t, layer=1, n_head=_H,
                                              scale=_DH ** -0.5)
    assert ck is t[15] and cv is t[16]  # the self pools are written in place
    return out, ck, cv


def test_fused_decode_step_paged_matches_jax_interpret_kernel():
    """On-contract shape (dm 128, h 8, dh 64, di 256, bt 16): output and
    both pools after the in-place write, ragged lengths over shuffled
    tables, one inactive lane."""
    args = _paged_step_inputs(pos=[0, 17, 40, 63], active=[1, 1, 0, 1],
                              cross_lengths=[3, 64, 30, 17])
    plan = jax_decode_step._paged_megastep_plan(
        _DM, _H, _DH, _DI, _BT, _BT, 4, _MB, _MB, "float32", True)
    assert plan.ok
    got = _run_port_paged(*args)
    weights, pools, ints, tables, active = args
    want = jax_decode_step.fused_decode_step_paged(
        *(jnp.asarray(a) for a in weights + pools + ints + tables),
        jnp.asarray(active), layer=1, n_head=_H, scale=_DH ** -0.5,
        interpret=True)
    for g, w in zip(got, want):
        _close(g, w)
    # the inactive lane wrote nothing
    np.testing.assert_array_equal(got[1][:, tables[0][2]].numpy(),
                                  pools[0][:, tables[0][2]])


def test_fused_decode_step_paged_drops_a_row_past_the_window():
    """Lane 3 writes at pos 64 = max_blocks * block_t: the reference's
    composition drops the row (its Pallas kernel would index the next
    lane's table row instead); the port follows the composition."""
    args = _paged_step_inputs(pos=[5, 17, 40, 64], active=[1, 1, 1, 1],
                              cross_lengths=[3, 64, 30, 17], seed=1)
    got = _run_port_paged(*args)
    weights, pools, ints, tables, active = args
    want = jax_decode_step.reference_decode_step_paged(
        *(jnp.asarray(a) for a in weights + pools + ints + tables),
        jnp.asarray(active), layer=1, n_head=_H, scale=_DH ** -0.5)
    for g, w in zip(got, want):
        _close(g, w)
    changed = (got[1].numpy() != pools[0]).any(axis=(2, 3, 4))
    assert changed.sum() == 3  # one row for each of lanes 0-2


def test_megastep_paged_refuses_non_cpu_tensors():
    weights, pools, ints, tables, active = _paged_step_inputs(
        [0, 1, 2, 3], [1, 1, 1, 1], [1, 1, 1, 1])
    t = [torch.from_numpy(a).to("meta")
         for a in weights + pools + ints + tables + [active]]
    with pytest.raises(ValueError):
        kds.fused_decode_step_paged(*t, layer=1, n_head=_H, scale=0.125)


@pytest.mark.parametrize("b", [1, 33, 64])
def test_launch_passes_the_plan_to_the_entry_point(monkeypatch, b):
    """#12's wrapper makes the plan from the shape, the card's SM count
    and the kernel's occupancy before the launch, sizes the scratch by
    the plan's splits and hands the plan's integers to the C entry point
    after the pools' geometry: a recording stand-in for the library sees
    them, and the launch is counted once."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build

    n_head, dm, nb, bt, mb, cnb, cmb = 8, 512, 70, 16, 8, 140, 16
    seen = {}

    class Lib:
        def ptt_megastep_occupancy(self, paged, dh, smem):
            seen["occupancy"] = (paged, dh, smem)
            return 1

        def ptt_megastep_scratch(self, *args):
            seen["scratch"] = args
            return 40

        def ptt_megastep_paged(self, *args):
            seen["entry"] = args
            return 0

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 7)
    monkeypatch.setattr(kds, "sm_count", lambda device: 132)
    kds._device_launch.cache_clear()
    kernels.reset_launches()
    x = torch.zeros(b, 1, dm)
    args = [x] + [torch.zeros(1)] * 18
    try:
        out = kds._launch_megastep("megastep_paged", True, x, args,
                                   (nb, bt, mb, cnb, bt, cmb),
                                   (mb * bt, cmb * bt), 3, n_head, 64,
                                   0.125, 1e-5)
    finally:
        kds._device_launch.cache_clear()
    plan = kds.megastep_plan(b, n_head, dm, 132, 1, mb * bt, cmb * bt)
    assert seen["occupancy"] == (1, 64, plan.smem)
    assert seen["scratch"] == (b, dm, n_head, 64, plan.self_splits,
                               plan.cross_splits)
    entry = seen["entry"]
    assert len(entry) == 21 + 21 + 3
    assert entry[20] - entry[19] == 4 * b * dm  # out, then the scratch
    assert entry[21:32] == (3, b, dm, n_head, 64, nb, bt, mb, cnb, bt, cmb)
    assert entry[32:42] == plan.ints() and plan.grid == 132
    assert entry[42:] == (0.125, 1e-5, 7)
    assert out.shape == x.shape and kernels.launches["megastep_paged"] == 1


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_launch_passes_the_plan_to_the_entry_point(monkeypatch, b,
                                                          paged):
    """#14's and #15's wrappers make the flash-decode plan from the shape,
    the card's SM count and the kernel's occupancy before the launch,
    size the scratch by the plan and hand the output, the scratch behind
    it, the cache geometry and the plan's integers to the C entry point:
    a recording stand-in for the library sees them, and the launch is
    counted once."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_attention as kda

    h, dh, nb, bt, mb = 8, 64, 70, 16, 16
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
    q = torch.zeros(b, h, dh)
    what = "flash_decode_paged" if paged else "flash_decode"
    n_args = 5 if paged else 4
    args = [q] + [torch.zeros(1) for _ in range(n_args - 1)]
    geometry = (h, dh, nb, bt, mb) if paged else (mb * bt, h, dh)
    try:
        out = kda._launch_decode(what, paged, q, args, geometry, mb * bt,
                                 0.125)
    finally:
        kda._device_plan.cache_clear()
    plan = kda.decode_plan(b, h, mb * bt, 132, kda.DECODE_BLOCKS_PER_SM)
    assert seen["occupancy"] == (int(paged), dh, plan.group, plan.smem)
    entry = seen["entry"]
    assert len(entry) == n_args + 3 + len(geometry) + 4 + 2
    assert entry[:n_args] == tuple(a.data_ptr() for a in args)
    assert out.data_ptr() == entry[n_args]
    assert entry[n_args + 1] - entry[n_args] == 4 * b * h * dh
    assert out.untyped_storage().nbytes() == 4 * (b * h * dh + plan.scratch)
    rest = entry[n_args + 2:]
    assert rest[:1 + len(geometry)] == (b, *geometry)
    assert rest[1 + len(geometry):-2] == plan.ints()
    assert rest[-2:] == (0.125, 7)
    assert plan.group == (1 if b == 1 else 8)
    assert out.shape == q.shape and kernels.launches[what] == 1


@pytest.mark.parametrize("b", [1, 33, 64])
def test_ffn_launch_passes_the_plan_to_the_entry_point(monkeypatch, b):
    """#11/#13's wrapper makes the FFN plan from the shape, the card's SM
    count and the kernel's occupancy before the launch, sizes the scratch
    by the plan and hands the output, the scratch behind it and the
    plan's integers to the C entry point after the widths: a recording
    stand-in for the library sees them, and the launch is counted once."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build

    dm, di = 512, 2048
    seen = {}

    class Lib:
        def ptt_ffn_occupancy(self, smem):
            seen["occupancy"] = smem
            return 1

        def ptt_ffn(self, *args):
            seen["entry"] = args
            return 0

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 7)
    monkeypatch.setattr(kds, "sm_count", lambda device: 132)
    kds._device_ffn.cache_clear()
    kernels.reset_launches()
    x = torch.zeros(b, 1, dm)
    weights = [torch.zeros(1) for _ in range(6)]
    try:
        out = kds._launch_ffn(x, weights, di, 1e-5)
    finally:
        kds._device_ffn.cache_clear()
    plan = kds.ffn_plan(b, dm, di, 132, 1)
    assert seen["occupancy"] == plan.smem
    entry = seen["entry"]
    assert len(entry) == 9 + 3 + 8 + 2
    assert entry[0] == x.data_ptr()
    assert entry[1:7] == tuple(w.data_ptr() for w in weights)
    assert entry[8] - entry[7] == 4 * b * dm  # out, then the scratch
    assert out.data_ptr() == entry[7]
    assert out.untyped_storage().nbytes() == 4 * (b * dm + plan.scratch)
    assert entry[9:12] == (b, dm, di)
    assert entry[12:20] == plan.ints() and plan.grid == 132
    assert entry[20:] == (1e-5, 7)
    assert plan.fused == (b == 1)
    assert out.shape == x.shape and kernels.launches["ffn"] == 1


# ---------------------------------------------------------------------------
# whole paths against the reference's programs
# ---------------------------------------------------------------------------


def _source(seed):
    """[2, 16] ids in [2, 64); lane 1 has a padded tail."""
    src = np.random.RandomState(seed).randint(2, 64, (BATCH, SRC_LEN))
    src[1, 11:] = 0
    return src.astype(np.int64)


#: route -> (reference flags, port session and model keywords)
ROUTES = {
    "paged_fused": ({"paged_kv_cache": True}, dict(paged=True), {}),
    "ring_unfused": ({"fused_decode_step": False}, {},
                     dict(fused_decode_step=False)),
    "paged_unfused": ({"paged_kv_cache": True, "fused_decode_step": False},
                      dict(paged=True), dict(fused_decode_step=False)),
}


class _Route:
    """The reference's programs built under ``flags`` with its own
    parameters, and the port's session on the same weights."""

    def __init__(self, flags, session_kw, model_kw):
        try:
            for name, value in flags.items():
                FLAGS.set(name, value)
            FLAGS.set("kv_block_t", BLOCK_T)
            programs = T.build_generation_programs(
                **WIDTHS, n_layer=2, batch_size=BATCH, src_seq_len=SRC_LEN,
                max_out_len=MAX_OUT, bos_id=0, eos_id=1, use_flash=True)
        finally:
            for name in (*flags, "kv_block_t"):
                FLAGS.reset(name)
        assert programs.paged == bool(session_kw.get("paged"))
        self.jax = JaxSession(programs)
        self.jax.init_params()
        scope = self.jax.scope
        params = {n: scope.find_var(n)
                  for n, _ in paddle_tpu_param_names(2)}
        op = next(o for o in programs.decode.global_block().ops
                  if o.type == "sample_token")
        self.logits_name = op.input("Logits")[0]
        self.self_feed = programs.self_feed_token
        model = Transformer(**WIDTHS, n_layer=2, device="cpu", **model_kw)
        load_paddle_tpu_params(model, params)
        self.port = GenerationSession(model, BATCH, SRC_LEN, MAX_OUT,
                                      bos_id=0, eos_id=1,
                                      block_t=BLOCK_T, **session_kw)

    def step(self):
        p = self.jax.p
        feed = {"gen_active": np.ones((BATCH, 1), np.float32)}
        if not self.self_feed:
            # the flag-off decode program takes the token as a feed
            feed["gen_token"] = self.port.last_tok.numpy().reshape(BATCH, 1)
        tok, logits = self.jax.exe.run(
            p.decode, feed=feed, fetch_list=p.decode_fetch + [
                self.logits_name], scope=self.jax.scope)
        got = self.port.decode_step()
        _close(self.port.last_logits.numpy(), np.asarray(logits))
        np.testing.assert_array_equal(got, np.asarray(tok).reshape(BATCH))

    def check_caches(self):
        scope = self.jax.scope
        for side, cache in (("self", self.port.self_cache),
                            ("cross", self.port.cross_cache)):
            for name in ("k", "v"):
                _close(getattr(cache, name).numpy(),
                       np.asarray(scope.find_var(f"gen_{side}_{name}")))
            np.testing.assert_array_equal(
                cache.lengths.numpy(),
                np.asarray(scope.find_var(f"gen_{side}_len")))
            if hasattr(cache, "table"):
                np.testing.assert_array_equal(
                    cache.table.numpy(),
                    np.asarray(scope.find_var(f"gen_{side}_btab")))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_generation_route_matches_reference_step_by_step(route):
    """Prefill, 4 steps, a late join of lane 1, then the rest: logits and
    tokens every step, caches (pools and tables on the paged routes) at
    the end."""
    r = _Route(*ROUTES[route])
    np.testing.assert_array_equal(r.port.prefill(_source(1)),
                                  r.jax.prefill(_source(1)))
    for _ in range(4):
        r.step()
    join = np.array([0, 1])
    np.testing.assert_array_equal(r.port.prefill(_source(2), active=join),
                                  r.jax.prefill(_source(2), active=join))
    for _ in range(MAX_OUT - 4):
        r.step()
    r.check_caches()


def test_small_pool_arms_dynamic_mode_and_refuses_generate():
    model = Transformer(**WIDTHS, n_layer=2, device="cpu").init_params()
    sess = GenerationSession(model, BATCH, SRC_LEN, MAX_OUT, paged=True,
                             block_t=BLOCK_T, num_blocks=4)
    assert sess.dynamic_only
    assert sess.self_cache.allocator.free_count == 3  # block 0 is the trap
    assert not sess.cross_cache.table.any()
    with pytest.raises(RuntimeError, match="ContinuousBatcher"):
        sess.generate(_source(0))
    full = GenerationSession(model, BATCH, SRC_LEN, MAX_OUT, paged=True,
                             block_t=BLOCK_T)
    assert not full.dynamic_only and full.self_cache.allocator is None
