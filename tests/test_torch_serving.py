"""paddle_tpu_torch's continuous batcher against the JAX package's, on the
CPU.

The reference's GenerationServingModel is built with the matching flags
and its parameters carried into the port's session; both batchers are
then driven synchronously through _admit/_step (as the reference's own
paged serving tests drive theirs) and must give every request the same
tokens, with the same prefill and prefix-hit counts.  The port's block
budget, copy-on-write, admission control and threaded scheduler are
exercised on a small seeded model.
"""

import sys
import threading
import types

import pytest
import torch

from paddle_tpu import monitor
from paddle_tpu.flags import FLAGS
from paddle_tpu.serving import generation as jax_generation
from paddle_tpu_torch import GenerationSession, Transformer, kernels
from paddle_tpu_torch.interop import (load_paddle_tpu_params,
                                      paddle_tpu_param_names)
from paddle_tpu_torch.kernels import decode_step as kds
from paddle_tpu_torch.serving import (ContinuousBatcher, GenerationConfig,
                                      GenerationServingModel, Overloaded,
                                      Unavailable,
                                      build_demo_generation_model)
from paddle_tpu_torch.serving.generation import _GenRequest

WIDTHS = dict(src_vocab_size=64, trg_vocab_size=64, max_length=20,
              n_head=2, d_key=64, d_value=64, d_model=128, d_inner_hid=256)
GEOMETRY = dict(src_seq_len=8, max_out_len=12, bos_id=0, eos_id=1)
PROMPTS = [[5, 9, 3], [5, 9, 3], [5, 9, 3], [7, 2]]

#: a bound on every wait of the threaded tests
WAIT_S = 60.0


def _drive(batcher, reqs, max_iters=300):
    """Synchronous admit/step loop (no scheduler thread) until every
    request's event is set."""
    for r in reqs:
        batcher._pending_join.append(r)
    it = 0
    while not all(r.event.is_set() for r in reqs):
        batcher._admit()
        batcher._step()
        it += 1
        assert it < max_iters, "batcher made no progress"


def _reference_run(name, paged):
    """The reference's batcher over PROMPTS: (tokens per request,
    prefills, prefix hits, the model's parameters)."""
    try:
        FLAGS.set("monitor", True)
        if paged:
            FLAGS.set("paged_kv_cache", True)
        cfg = jax_generation.GenerationConfig(name, slots=4, **WIDTHS,
                                              n_layer=2, **GEOMETRY)
        model = jax_generation.GenerationServingModel(cfg)
        model.init_params()
        model.warmup()
        batcher = jax_generation.ContinuousBatcher(model)
        pre0 = monitor.counter(f"serving.gen.{name}.prefills").value
        hit0 = monitor.counter(f"generation.{name}.prefix_hits_total").value
        reqs = [jax_generation._GenRequest(list(p), 12) for p in PROMPTS]
        _drive(batcher, reqs)
        pre = monitor.counter(f"serving.gen.{name}.prefills").value - pre0
        hit = (monitor.counter(f"generation.{name}.prefix_hits_total")
               .value - hit0)
    finally:
        FLAGS.reset("monitor")
        FLAGS.reset("paged_kv_cache")
    scope = model.session.scope
    params = {n: scope.find_var(n) for n, _ in paddle_tpu_param_names(2)}
    return [list(r.tokens) for r in reqs], pre, hit, params


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_matches_reference_tokens_and_prefix_reuse(paged):
    """Four requests, three with one prompt: the port's batcher gives each
    the reference's tokens; on the paged cache the three share one
    prefill (2 prefills, 2 prefix hits, against 4 prefills on the ring),
    and the pools and the prefix registry drain."""
    name = f"gen_{'paged' if paged else 'ring'}"
    want, want_pre, want_hits, params = _reference_run(name, paged)
    model = Transformer(**WIDTHS, n_layer=2, device="cpu")
    load_paddle_tpu_params(model, params)
    sess = GenerationSession(model, 4, **GEOMETRY, paged=paged)
    served = GenerationServingModel(GenerationConfig(name, max_tokens=12),
                                    session=sess)
    served.warmup()
    batcher = ContinuousBatcher(served)
    reqs = [_GenRequest(list(p), 12) for p in PROMPTS]
    _drive(batcher, reqs)
    assert [list(r.tokens) for r in reqs] == want
    c = batcher.counters
    assert c[f"serving.gen.{name}.prefills"] == want_pre == (2 if paged
                                                             else 4)
    assert c[f"generation.{name}.prefix_hits_total"] == want_hits
    assert want_hits == (2 if paged else 0)
    assert c[f"serving.gen.{name}.tokens"] == sum(len(t) for t in want)
    if paged:
        assert sess.self_cache.allocator.used_count == 0
        assert sess.cross_cache.allocator.used_count == 0
        assert c[f"generation.{name}.blocks_used_peak"] > 0
    assert not batcher._prefix_map


def test_demo_at_reference_widths_matches_reference_tokens():
    """The demo model has the reference demo's widths (head width 16):
    with the reference demo's weights carried across, the port's batcher
    gives PROMPTS the reference demo batcher's tokens."""
    ref = jax_generation.build_demo_generation_model("gendemo_ref", slots=4)
    ref.warmup()
    reqs = [jax_generation._GenRequest(list(p), 12) for p in PROMPTS]
    _drive(jax_generation.ContinuousBatcher(ref), reqs)
    want = [list(r.tokens) for r in reqs]
    scope = ref.session.scope
    params = {n: scope.find_var(n) for n, _ in paddle_tpu_param_names(2)}

    served = build_demo_generation_model(device="cpu")
    model = served.session.model
    assert (model.n_head, model.d_key, model.d_model) == (2, 16, 32)
    load_paddle_tpu_params(model, params)
    served.warmup()
    reqs = [_GenRequest(list(p), 12) for p in PROMPTS]
    _drive(ContinuousBatcher(served), reqs)
    assert [list(r.tokens) for r in reqs] == want


#: every attention and decode kernel the route table names (the FFN has no
#: head axis: test_ffn_route_follows_the_step), with the dtypes it has
#: instantiations of
_HEAD_AXIS = [name for name in kernels.composed if name != "ffn"]
_ROUTED = [(name, torch.float32) for name in _HEAD_AXIS] + [
    (name, torch.bfloat16) for name in _HEAD_AXIS
    if name in kernels.BF16_KERNELS]
#: the serving path's f32 kernels, compiled for head width 128 too
_SERVING = ("qkv_attention_fwd", "megastep", "megastep_paged",
            "flash_decode", "flash_decode_paged")
#: the bf16 training kernels (amp's #1-#9), compiled for head width 128 too
_AMP_TRAINING = ("qkv_attention_fwd", "qkv_bwd_dq", "qkv_bwd_dkv",
                 "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_fwd_bhtd", "flash_bwd_dq_bhtd", "flash_bwd_dkv_bhtd")


def _at_128(name, dtype):
    """Whether (kernel, dtype) is compiled for head width 128."""
    return (name in _SERVING if dtype == torch.float32
            else name in _AMP_TRAINING)
#: (d_head, route, kernel, dtype): the first four are flash_fwd's cases at
#: 16, 32, 64 and 128; then every kernel and dtype at 64 (kernel), 96
#: (composed), 128 (kernel where compiled, else an error) and 192 (an
#: error everywhere)
_ROUTE_CASES = [(16, "composed", "flash_fwd", torch.float32),
                (32, "composed", "flash_fwd", torch.float32),
                (64, "kernel", "flash_fwd", torch.float32),
                (128, None, "flash_fwd", torch.float32)] + [
    (d_head, route, name, dtype) for name, dtype in _ROUTED
    for d_head, route in (
        (64, "kernel"), (96, "composed"),
        (128, "kernel" if _at_128(name, dtype) else None),
        (192, None))]
_ROUTE_IDS = ["16-composed", "32-composed", "64-kernel", "128-None"] + [
    f"{name}-{str(dtype)[6:]}-{d_head}-{route}"
    for d_head, route, name, dtype in _ROUTE_CASES[4:]]


@pytest.mark.parametrize("d_head,route,name,dtype", _ROUTE_CASES,
                         ids=_ROUTE_IDS)
def test_head_width_route_mirrors_reference_plans(d_head, route, name,
                                                  dtype):
    """The route the CUDA wrappers take by kernel, dtype and head width,
    as the reference's plans decide: the composition below a multiple of
    64, the kernel at 64, and at 128 the kernel where the port compiles
    it (the serving path's f32 kernels: #1's forward, the megasteps and
    flash-decode; the bf16 training kernels #1-#9), an error naming the
    kernel and the width elsewhere (the f32 training kernels); 192 is
    compiled nowhere.  A composed call is counted; a kernel route counts
    nothing here."""
    assert kernels.compiled_widths(name, dtype) == (
        (64, 128) if _at_128(name, dtype) else (64,))
    kernels.reset_launches()
    if route is None:
        with pytest.raises(ValueError, match=f"{name}.*head width {d_head}"):
            kernels.head_route(name, d_head, dtype)
        with pytest.raises(ValueError, match=f"head width {d_head}"):
            kernels.composes(name, d_head, dtype)
        assert not any(kernels.composed.values())
        return
    assert kernels.head_route(name, d_head, dtype) == route
    assert kernels.composes(name, d_head, dtype) == (route == "composed")
    assert kernels.composed[name] == (route == "composed")
    kernels.reset_launches()
    assert not any(kernels.composed.values())


@pytest.mark.parametrize("d_head,composed", [(64, False), (96, True),
                                             (128, False), (192, False)])
def test_ffn_route_follows_the_step(d_head, composed):
    """The FFN half of a decoder step on CUDA tensors: its plain version
    (counted) where the step composes (d_head % 64 != 0), else its kernel
    at every width, as it has no head axis (at a width with no megastep
    the step raises before it).  CPU tensors always take the plain
    version, uncounted."""
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    kernels.reset_launches()
    route = kds._ffn_route(cuda, d_head)
    assert route is (kds.reference_ffn if composed else kds.ffn_epilogue)
    assert kernels.composed["ffn"] == composed
    kernels.reset_launches()
    assert kds._ffn_route(torch.zeros(1), d_head) is kds.ffn_epilogue
    assert not any(kernels.composed.values())


def _demo(**kw):
    model = build_demo_generation_model(device="cpu", **kw)
    model.warmup()
    return model


def test_admission_is_by_block_budget_not_slots():
    """One non-trap block per pool: a second distinct prompt stays pending
    despite free slots and admits once the first retires."""
    model = _demo(paged=True, num_blocks=2)
    b = ContinuousBatcher(model)
    sess = model.session
    assert sess.self_cache.allocator.free_count == 1
    r1, r2 = _GenRequest([5, 9, 3], 12), _GenRequest([7, 2, 4], 12)
    b._pending_join.extend([r1, r2])
    b._admit()
    assert b._slot_req.count(None) == model.slots - 1
    assert list(b._pending_join) == [r2]          # held back, FIFO head
    assert b.counters["generation.gendemo.admission_holds_total"] == 1
    assert sess.self_cache.allocator.free_count == 0
    it = 0
    while not r2.event.is_set():
        b._admit()
        b._step()
        it += 1
        assert it < 200
    assert len(r1.tokens) == len(r2.tokens) == 12
    assert sess.self_cache.allocator.used_count == 0
    assert sess.cross_cache.allocator.used_count == 0


def _fork_run(fork):
    """Decode one request 4 steps, optionally fork it into a spare slot,
    then finish it: (tokens, copies, whether the sharer's rows held)."""
    model = _demo(paged=True)
    b = ContinuousBatcher(model)
    req = _GenRequest([5, 9, 3], 16)
    b._pending_join.append(req)
    b._admit()
    slot = b._slot_req.index(req)
    spare = b._slot_req.index(None)
    for _ in range(4):
        b._step()
    cache = model.session.self_cache
    if fork:
        model.fork_slot(spare, slot)
        shared = cache.slot_blocks(spare, int(cache.lengths[spare]))
        frozen = cache.k[:, shared].clone()
    it = 0
    while not req.event.is_set():
        b._admit()
        b._step()
        it += 1
        assert it < 200
    held = not fork or bool((cache.k[:, shared] == frozen).all())
    return (list(req.tokens),
            b.counters["generation.gendemo.cow_copies_total"], held)


def test_fork_then_diverge_copy_on_write_keeps_sharer_tokens():
    base, no_copies, _ = _fork_run(fork=False)
    forked, copies, held = _fork_run(fork=True)
    assert forked == base
    assert no_copies == 0 and copies >= 1
    assert held


def test_fork_slot_needs_the_paged_cache():
    with pytest.raises(ValueError, match="paged"):
        _demo().fork_slot(1, 0)


def test_submit_validation_and_admission_control():
    model = _demo()
    b = ContinuousBatcher(model, max_queue_depth=1, breaker_threshold=1,
                          breaker_cooldown_s=60.0)
    for prompt, mt in (([], None), ([3, 0, 4], None), ([3] * 9, None),
                       ([3, 40], None), ([3], 0)):
        with pytest.raises(ValueError):
            b.submit(prompt, max_tokens=mt, timeout=1.0)
    b._pending_join.append(_GenRequest([3], 4))   # the queue is full
    with pytest.raises(Overloaded) as shed:
        b.submit([3], timeout=1.0)
    assert shed.value.reason == "gen_queue_depth"
    assert b.counters["serving.gen.gendemo.shed_total"] == 1
    b._pending_join.clear()
    b.breaker.record_failure()                    # threshold 1: open
    with pytest.raises(Unavailable) as err:
        b.submit([3], timeout=1.0)
    assert err.value.reason == "breaker_open"
    b.breaker.record_success()
    b.begin_drain()
    with pytest.raises(Unavailable) as err:
        b.submit([3], timeout=1.0)
    assert err.value.reason == "draining"
    readiness = model.readiness_detail()
    assert readiness["ready"] and readiness["ladder_size"] == 2
    assert model.info()["slots"] == 4


@pytest.mark.parametrize("clients", [2, 8])
def test_threaded_batcher_serves_concurrent_clients(clients):
    """start(), client threads submitting concurrently (late joins into a
    running decode) with a shortened thread switch interval, stop() in
    finally; every wait is bounded, and the shared counters lose no
    update."""
    model = _demo()
    b = ContinuousBatcher(model)
    results, errors = {}, []

    def client(cid, prompts):
        try:
            for i, p in enumerate(prompts):
                results[(cid, i)] = b.submit(p, max_tokens=6 + i,
                                             timeout=WAIT_S)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(c, [[3 + c, 4], [5, 6 + c, 7]]))
               for c in range(clients)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    b.start()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert b.drain(timeout=WAIT_S)
    finally:
        b.stop(timeout=WAIT_S)
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert sorted(results) == [(c, i) for c in range(clients)
                               for i in range(2)]
    for (_, i), (tokens, meta) in results.items():
        assert len(tokens) <= 6 + i and meta["tokens"] == len(tokens)
        assert meta["ttft_ms"] <= meta["total_ms"]
    assert b.counters["serving.gen.gendemo.requests"] == 2 * clients
    assert (b.counters["serving.gen.gendemo.tokens"]
            == sum(len(t) for t, _ in results.values()))
    assert b._thread is None


def test_stop_fails_queued_requests_with_unavailable():
    b = ContinuousBatcher(_demo())
    req = _GenRequest([3], 4)
    b._queue.put(req)
    b.stop()
    assert req.event.is_set() and isinstance(req.error, Unavailable)
