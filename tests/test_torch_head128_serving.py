"""paddle_tpu_torch serving at head width 128, on the CPU, against the JAX
package.

A 2+2-layer encoder-decoder of 8 heads of 128 (d_model 256, d_inner 512,
vocab 64) is built and initialized by the reference's generation programs
under each route's flags (ring or paged caches, the fused decoder step or
its unfused chain); its scope is carried into the port with
load_paddle_tpu_params.  Both packages then generate greedily from the
same sources: every step's logits within TOL, the tokens identical, the
caches at the end.  The port's batcher is held to the reference's batcher
on the same weights.  On the card the same paths launch the head-width-128
kernels (chip_smoke.py phase 3 (m)); here each wrapper runs its plain
version.
"""

import numpy as np
import pytest

from paddle_tpu import monitor
from paddle_tpu.flags import FLAGS
from paddle_tpu.generation import GenerationSession as JaxSession
from paddle_tpu.models import transformer as T
from paddle_tpu.serving import generation as jax_generation
from paddle_tpu_torch import GenerationSession, Transformer
from paddle_tpu_torch.interop import (load_paddle_tpu_params,
                                      paddle_tpu_param_names)
from paddle_tpu_torch.serving import (ContinuousBatcher, GenerationConfig,
                                      GenerationServingModel)
from paddle_tpu_torch.serving.generation import _GenRequest

#: f32 logits and caches two layers deep against XLA on the CPU (the
#: head-width-64 generation tests' tolerance)
TOL = 1e-4

WIDTHS = dict(src_vocab_size=64, trg_vocab_size=64, max_length=20,
              n_head=8, d_key=128, d_value=128, d_model=256,
              d_inner_hid=512)
BATCH, SRC_LEN, MAX_OUT, BLOCK_T = 2, 16, 10, 8


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _source(seed):
    """[2, 16] ids in [2, 64); lane 1 has a padded tail."""
    src = np.random.RandomState(seed).randint(2, 64, (BATCH, SRC_LEN))
    src[1, 11:] = 0
    return src.astype(np.int64)


#: route -> (reference flags, port session and model keywords)
ROUTES = {
    "ring_fused": ({}, {}, {}),
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
        assert (model.n_head, model.d_key) == (8, 128)
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
        return got

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


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_generation_at_head_width_128_matches_reference(route):
    """Prefill, 4 steps, a late join of lane 1, then the rest, at 8 heads
    of 128: the same greedy tokens and logits within TOL every step, the
    caches within TOL at the end, on each route."""
    r = _Route(*ROUTES[route])
    np.testing.assert_array_equal(r.port.prefill(_source(1)),
                                  r.jax.prefill(_source(1)))
    tokens = [r.step() for _ in range(4)]
    join = np.array([0, 1])
    np.testing.assert_array_equal(r.port.prefill(_source(2), active=join),
                                  r.jax.prefill(_source(2), active=join))
    tokens += [r.step() for _ in range(MAX_OUT - 4)]
    r.check_caches()
    assert len(tokens) == MAX_OUT


GEOMETRY = dict(src_seq_len=8, max_out_len=12, bos_id=0, eos_id=1)
PROMPTS = [[5, 9, 3], [5, 9, 3], [7, 2], [11, 4, 8, 1, 6]]
SERVE_WIDTHS = dict(WIDTHS)


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


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_at_head_width_128_matches_reference(paged):
    """Four requests, two with one prompt, at 8 heads of 128: the port's
    batcher gives each the reference batcher's tokens, with the same
    prefill and prefix-hit counts."""
    name = f"gen128_{'paged' if paged else 'ring'}"
    try:
        FLAGS.set("monitor", True)
        if paged:
            FLAGS.set("paged_kv_cache", True)
        cfg = jax_generation.GenerationConfig(name, slots=4, **SERVE_WIDTHS,
                                              n_layer=2, **GEOMETRY)
        ref = jax_generation.GenerationServingModel(cfg)
        ref.init_params()
        ref.warmup()
        pre0 = monitor.counter(f"serving.gen.{name}.prefills").value
        hit0 = monitor.counter(f"generation.{name}.prefix_hits_total").value
        reqs = [jax_generation._GenRequest(list(p), 12) for p in PROMPTS]
        _drive(jax_generation.ContinuousBatcher(ref), reqs)
        want_pre = monitor.counter(f"serving.gen.{name}.prefills").value - pre0
        want_hits = (monitor.counter(f"generation.{name}.prefix_hits_total")
                     .value - hit0)
    finally:
        FLAGS.reset("monitor")
        FLAGS.reset("paged_kv_cache")
    want = [list(r.tokens) for r in reqs]
    scope = ref.session.scope
    params = {n: scope.find_var(n) for n, _ in paddle_tpu_param_names(2)}

    model = Transformer(**SERVE_WIDTHS, n_layer=2, device="cpu")
    load_paddle_tpu_params(model, params)
    sess = GenerationSession(model, 4, **GEOMETRY, paged=paged)
    served = GenerationServingModel(GenerationConfig(name, max_tokens=12),
                                    session=sess)
    served.warmup()
    batcher = ContinuousBatcher(served)
    got = [_GenRequest(list(p), 12) for p in PROMPTS]
    _drive(batcher, got)
    assert [list(r.tokens) for r in got] == want
    assert all(len(t) == 12 for t in want)
    c = batcher.counters
    assert c[f"serving.gen.{name}.prefills"] == want_pre
    assert c[f"generation.{name}.prefix_hits_total"] == want_hits
    assert want_hits == (1 if paged else 0)
