"""Continuous token-level batching: the decode-aware serving model.

Counterpart of ``paddle_tpu/serving/generation.py``.  The unit of
batching is the decode step (Orca-style iteration-level scheduling):

* a :class:`GenerationServingModel` owns one ``GenerationSession`` with a
  fixed number of SLOTS (the decode batch); each slot is one cache lane;
* the :class:`ContinuousBatcher` scheduler thread runs one decode step per
  iteration for all occupied slots (an active mask), so in-flight
  sequences share every step;
* new requests join between steps through a prefill masked to the joining
  slots; finished sequences (eos or token budget) retire their slot at the
  end of the step, and the slot is reusable at once.

On the paged cache (``paged=True`` in the model's keywords) the batcher
serves by HBM bytes, not slot count: a request is admitted only when the
pools have the blocks it needs (FIFO hold-back otherwise), requests with
the same prompt share the leader's cross blocks and skip the prefill, and
a forked sequence's shared self blocks are copied before a divergent
write.

The reference's monitor counters and gauges become one plain dict,
``ContinuousBatcher.counters``, under the same names, with three of the
port's own: the high-water marks ``serving.gen.<m>.occupancy_peak`` and
``generation.<m>.blocks_used_peak``, and
``generation.<m>.admission_holds_total``, the admission rounds that held
the queue's head back for lack of blocks.  Its histograms,
request tracing, SLO accounting and chaos hooks wait for the monitor port
(ROADMAP A10); a request's time to first token is in its ``meta``.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from ..generation import GenerationSession
from ..models.transformer import Transformer
from .batcher import (_STOP, _fail_waiters, CircuitBreaker, Overloaded,
                      Unavailable)

#: keywords of a GenerationConfig that go to the GenerationSession; the
#: rest build the Transformer
_SESSION_KEYS = ("src_seq_len", "max_out_len", "bos_id", "eos_id", "paged",
                 "block_t", "num_blocks")


class GenerationConfig:
    """Policy and model geometry of one generation serving model.
    ``model_kw`` holds the Transformer's keywords (widths, ``device``,
    ``fused_decode_step``) and the session's (``src_seq_len``,
    ``max_out_len``, ``bos_id``, ``eos_id``, ``paged``, ``block_t``,
    ``num_blocks``)."""

    __slots__ = ("name", "slots", "max_tokens", "model_kw")

    def __init__(self, name: str, slots: int = 4,
                 max_tokens: Optional[int] = None, **model_kw):
        if not name or "/" in name or ":" in name:
            raise ValueError(f"model name {name!r} must be URL-path safe")
        self.name = name
        self.slots = int(slots)
        self.model_kw = dict(model_kw)
        self.max_tokens = int(max_tokens if max_tokens is not None
                              else self.model_kw.get("max_out_len", 16))


class _GenRequest:
    __slots__ = ("prompt", "max_tokens", "t_enqueue", "deadline",
                 "t_first_token", "event", "tokens", "error", "meta",
                 "cancelled")

    def __init__(self, prompt, max_tokens, timeout=None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.t_enqueue = time.perf_counter()
        # the scheduler-side mirror of the client timeout: an expired
        # request never admits, and an expired slot retires at the next
        # iteration boundary
        self.deadline = (None if timeout is None
                         else self.t_enqueue + float(timeout))
        self.t_first_token = None
        self.event = threading.Event()
        self.tokens: List[int] = []
        self.error = None
        self.meta = None
        # set by a timed-out client: the scheduler retires the slot at the
        # next step instead of decoding the abandoned sequence on
        self.cancelled = False


class GenerationServingModel:
    """One model and its session's cache state, servable through the
    continuous batcher.  ``session`` takes an existing GenerationSession
    (its model's weights as they are); otherwise the config builds one,
    with weights uninitialized until :meth:`init_params`."""

    def __init__(self, config: GenerationConfig, session=None):
        self.config = config
        self.name = config.name
        if session is None:
            kw = dict(config.model_kw)
            skw = {k: kw.pop(k) for k in _SESSION_KEYS if k in kw}
            model = Transformer(**kw)
            skw.setdefault("src_seq_len", model.max_length)
            skw.setdefault("max_out_len", 16)
            session = GenerationSession(model, config.slots, **skw)
        self.session = session
        self.slots = session.batch_size
        self.max_prompt_len = session.src_seq_len
        self.max_tokens = min(config.max_tokens, session.max_out_len)
        self.bos_id, self.eos_id = session.bos_id, session.eos_id
        self.vocab = session.model.src_word_emb.shape[0]
        # resident KV footprint of the self and cross caches
        self.kv_cache_bytes = (session.self_cache.hbm_bytes
                               + session.cross_cache.hbm_bytes)
        self.paged = session.paged
        # slots whose self blocks may be shared (fork_slot): the per-step
        # copy-on-write guard walks only this set
        self._shared_self_slots: set = set()
        self.ready = False

    @property
    def device(self):
        return self.session.device

    def init_params(self, seed: int = 0):
        self.session.model.init_params(seed)

    def fork_slot(self, dst_slot: int, src_slot: int) -> None:
        """Clone src_slot's sequence into dst_slot by sharing its self
        blocks (ref++): the speculative-decode skeleton on the paged
        cache.  Counters and the self-feed state are copied on the device;
        the first divergent append on either slot goes through the
        batcher's copy-on-write guard."""
        if not self.paged:
            raise ValueError("fork_slot requires the paged KV cache")
        sess = self.session
        rows = int(sess.self_cache.lengths[src_slot])
        sess.self_cache.fork_slot(dst_slot, src_slot, rows)
        for t in (sess.self_cache.lengths, sess.cross_cache.lengths,
                  sess.last_tok, sess.finished):
            t[dst_slot] = t[src_slot]
        self._shared_self_slots.update((dst_slot, src_slot))

    def warmup(self) -> int:
        """One prefill and one decode step with an all-inactive mask: no
        slot state is touched.  Returns the number of warmed calls."""
        inactive = np.zeros((self.slots,), np.float32)
        self.session.prefill(
            np.zeros((self.slots, self.max_prompt_len), np.int64),
            active=inactive)
        self.session.decode_step(active=inactive)
        self.ready = True
        return 2

    def readiness_detail(self) -> dict:
        """Structured readiness for a health probe: generation's 'ladder'
        is the prefill and decode pair warmed by :meth:`warmup`."""
        return {
            "ready": self.ready,
            "state": "ready" if self.ready else "warming",
            "type": "generation",
            "warm_buckets": 2 if self.ready else 0,
            "ladder_size": 2,
        }

    def info(self) -> dict:
        """The model's static description (its batcher's ``counters``
        carry the running totals)."""
        return {
            "name": self.name,
            "type": "generation",
            "ready": self.ready,
            "slots": self.slots,
            "max_prompt_len": self.max_prompt_len,
            "max_tokens": self.max_tokens,
            "vocab_size": self.vocab,
            "bos_id": self.bos_id,
            "eos_id": self.eos_id,
            "paged": self.paged,
            "kv_cache_bytes": self.kv_cache_bytes,
        }


class ContinuousBatcher:
    """One scheduler thread per generation model: admits requests into
    free cache slots at prefill and coalesces every occupied slot's next
    token into one decode step.  ``max_queue_depth``, ``breaker_threshold``
    and ``breaker_cooldown_s`` take the reference's flag defaults
    (``FLAGS_serving_max_queue_depth`` and the breaker flags)."""

    def __init__(self, model: GenerationServingModel,
                 max_queue_depth: int = 128, breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0):
        self.model = model
        self.max_queue_depth = int(max_queue_depth)
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        # admission-wait EWMA (scheduler-written, submit-read): the
        # Retry-After basis for a shed request
        self._wait_ewma_s = 0.0
        self.breaker = CircuitBreaker(f"gen.{model.name}",
                                      threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s)
        self.counters: dict = collections.defaultdict(int)
        self._counters_lock = threading.Lock()
        # slot state (scheduler-thread-private once started)
        self._slot_req: List[Optional[_GenRequest]] = [None] * model.slots
        self._pending_join: collections.deque = collections.deque()
        # paged bookkeeping (scheduler-thread-private): the blocks each
        # slot owns, and the shared-prefix registry mapping a prompt to
        # the cross blocks its leader's prefill populated
        self._slot_blocks: List[Optional[dict]] = [None] * model.slots
        self._prefix_map: dict = {}
        if model.paged:
            model.session.self_cache.reset_dynamic()
            model.session.cross_cache.reset_dynamic()

    def _count(self, name: str, n: int = 1) -> None:
        with self._counters_lock:
            self.counters[name] += n

    def _gauge(self, name: str, value: int, peak: bool = False) -> None:
        """Set gauge ``name``; with ``peak``, also raise its
        ``<name>_peak`` high-water mark."""
        with self._counters_lock:
            self.counters[name] = value
            if peak:
                self.counters[name + "_peak"] = max(
                    self.counters[name + "_peak"], value)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._draining = False
        self._thread = threading.Thread(
            target=self._loop,
            name=f"serving-genbatcher-{self.model.name}", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        if self._running:
            self._running = False
            self._queue.put(_STOP)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        # a dead or never-started scheduler cannot run its finally-drain
        self._fail_queued()

    def begin_drain(self) -> None:
        """Stop admitting (submit raises Unavailable); in-flight sequences
        and admitted joins still run to completion."""
        self._draining = True

    def drain(self, timeout: float) -> bool:
        """begin_drain(), then wait (bounded) for every occupied slot and
        queued join to finish; True when fully drained in time."""
        self.begin_drain()
        t_end = time.monotonic() + max(0.0, timeout)
        while True:
            idle = self._idle()
            if idle:
                time.sleep(0.02)  # re-confirm across the join hand-off
                idle = self._idle()
            if idle or time.monotonic() >= t_end:
                return idle
            time.sleep(0.02)

    def _idle(self) -> bool:
        return (self._queue.qsize() == 0 and not self._pending_join
                and not any(r is not None for r in self._slot_req))

    @property
    def scheduler_alive(self) -> bool:
        """False only when the batcher should be running but its scheduler
        thread died."""
        if not self._running:
            return True
        return self._thread is not None and self._thread.is_alive()

    def _fail_queued(self) -> None:
        _fail_waiters(
            self._queue, self._pending_join,
            f"generation batcher for {self.model.name!r} stopped")

    # -- client side -----------------------------------------------------
    def submit(self, prompt, max_tokens: Optional[int] = None,
               timeout: float = 60.0):
        """Block until the sequence finishes; returns (tokens, meta)."""
        model = self.model
        m = model.name
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > model.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the model's "
                f"max_prompt_len {model.max_prompt_len}")
        # id 0 is the pad id: the cross length mask assumes padding is
        # trailing, so a 0 inside a prompt is refused
        bad = [t for t in prompt if not 0 < t < model.vocab]
        if bad:
            raise ValueError(
                f"prompt ids must be in (0, {model.vocab}); 0 is the "
                f"pad id: {bad[:5]}")
        mt = (model.max_tokens if max_tokens is None
              else min(int(max_tokens), model.max_tokens))
        if mt <= 0:
            raise ValueError(f"max_tokens must be positive, got {mt}")
        # admission control (validated requests only)
        if self._draining:
            raise Unavailable(f"generation model {m!r} is draining",
                              reason="draining")
        depth = self.max_queue_depth
        if (depth > 0
                and self._queue.qsize() + len(self._pending_join) >= depth):
            self._count(f"serving.gen.{m}.shed_total")
            raise Overloaded(
                f"generation model {m!r}: slot wait-queue full "
                f"({depth} waiting)", retry_after_s=self.retry_after(),
                reason="gen_queue_depth")
        if not self.breaker.allow():
            self._count(f"serving.gen.{m}.breaker_rejected_total")
            raise Unavailable(
                f"generation model {m!r}: circuit breaker open "
                f"({self.breaker.threshold} consecutive prefill/decode "
                "failures; half-open probe pending)",
                retry_after_s=self.breaker.cooldown_s,
                reason="breaker_open")
        req = _GenRequest(prompt, mt, timeout=timeout)
        self._queue.put(req)
        if not req.event.wait(timeout):
            req.cancelled = True  # the scheduler retires the slot next step
            req.error = TimeoutError(
                f"generation not finished within {timeout}s (model {m!r})")
            self._count(f"serving.gen.{m}.timeouts")
            raise req.error
        if req.error is not None:
            raise req.error
        self._count(f"serving.gen.{m}.requests")
        return req.tokens, req.meta

    def retry_after(self) -> float:
        """Suggested back-off for a shed request: about twice the observed
        admission wait, capped at 30 s."""
        return min(30.0, max(0.05, 2.0 * self._wait_ewma_s))

    # -- scheduler side --------------------------------------------------
    def _drain_queue(self, block: bool) -> bool:
        """Move arrivals into the pending-join deque; False on STOP."""
        while True:
            try:
                item = (self._queue.get(timeout=0.05) if block
                        else self._queue.get_nowait())
            except queue.Empty:
                return True
            if item is _STOP:
                return False
            self._pending_join.append(item)
            block = False

    def _publish_blocks(self) -> None:
        """Block-pool occupancy gauges, self and cross pools summed."""
        sess = self.model.session
        used = free = 0
        for cache in (sess.self_cache, sess.cross_cache):
            used += cache.allocator.used_count
            free += cache.allocator.free_count
        m = self.model.name
        self._gauge(f"generation.{m}.blocks_used", used, peak=True)
        self._gauge(f"generation.{m}.blocks_free", free)

    def _patch_sharer_state(self, slot: int, src_len: int) -> None:
        """A shared-prefix joiner skips the prefill, so the state the
        masked prefill would have reset is set here on the device, in
        stream order before the next decode step: cross length = the
        shared prefix's, self length 0, BOS and a cleared eos latch."""
        sess = self.model.session
        sess.cross_cache.lengths[slot] = src_len
        sess.self_cache.lengths[slot] = 0
        sess.last_tok[slot] = self.model.bos_id
        sess.finished[slot] = 0

    def _release_slot(self, slot: int) -> None:
        """Return a retired slot's blocks: self blocks are freed, cross
        blocks deref'd (sharers keep them alive), and the prefix registry
        entry dropped when its last user leaves."""
        info = self._slot_blocks[slot]
        if info is None:
            return
        self._slot_blocks[slot] = None
        sess = self.model.session
        if info["self"]:
            sess.self_cache.allocator.free(info["self"])
        if info["cross"]:
            sess.cross_cache.allocator.free(info["cross"])
        ent = self._prefix_map.get(info["key"])
        if ent is not None:
            ent["users"] -= 1
            if ent["users"] <= 0:
                del self._prefix_map[info["key"]]
        self.model._shared_self_slots.discard(slot)
        self._publish_blocks()

    def _admit(self) -> None:
        """Prefill every pending request that fits a free slot (and, on
        the paged cache, the pools' block budget): one masked prefill
        however many join this round."""
        model = self.model
        m = model.name
        sess = model.session
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        if not free or not self._pending_join:
            return
        now = time.perf_counter()
        joining = []
        while free and self._pending_join:
            req = self._pending_join.popleft()
            if req.cancelled:  # timed out while still queued
                continue
            if req.deadline is not None and now >= req.deadline:
                # expired while waiting for a slot: never prefilled
                req.error = TimeoutError(
                    f"request expired before a cache slot freed (model "
                    f"{m!r})")
                req.event.set()
                self._count(f"serving.gen.{m}.expired_dropped_total")
                continue
            if model.paged:
                key = tuple(req.prompt)
                ent = self._prefix_map.get(key)
                need_self = sess.self_cache.blocks_for(req.max_tokens)
                need_cross = (0 if ent is not None else
                              sess.cross_cache.blocks_for(len(req.prompt)))
                if (sess.self_cache.allocator.free_count < need_self
                        or sess.cross_cache.allocator.free_count
                        < need_cross):
                    # a free slot without block budget keeps the request
                    # at the head of the queue until a retirement frees
                    # blocks (counted: the port's own counter)
                    self._pending_join.appendleft(req)
                    self._count(f"generation.{m}.admission_holds_total")
                    break
            self._wait_ewma_s += 0.2 * (
                (now - req.t_enqueue) - self._wait_ewma_s)
            slot = free.pop(0)
            self._slot_req[slot] = req
            if not model.paged:
                joining.append((slot, req, False))
                continue
            # map the slot's blocks before the masked prefill.  A prefix
            # hit shares the registered cross blocks and skips the
            # prefill; a miss allocates fresh cross blocks, registers
            # them and prefills as the prefix's leader.  Same-round
            # sharers see the leader's entry at once.
            self_blocks = sess.self_cache.allocator.alloc(need_self)
            sess.self_cache.set_table_row(slot, self_blocks)
            if ent is not None:
                sess.cross_cache.allocator.share(ent["blocks"])
                sess.cross_cache.set_table_row(slot, ent["blocks"])
                ent["users"] += 1
                self._slot_blocks[slot] = {
                    "self": self_blocks, "cross": list(ent["blocks"]),
                    "key": key}
                self._patch_sharer_state(slot, ent["src_len"])
                joining.append((slot, req, True))
                self._count(f"generation.{m}.prefix_hits_total")
            else:
                cross_blocks = sess.cross_cache.allocator.alloc(need_cross)
                sess.cross_cache.set_table_row(slot, cross_blocks)
                # prompt ids are nonzero (submit refuses the pad id), so
                # the prefill's trailing-pad length is len(prompt)
                self._prefix_map[key] = {"blocks": cross_blocks,
                                         "src_len": len(req.prompt),
                                         "users": 1}
                self._slot_blocks[slot] = {"self": self_blocks,
                                           "cross": cross_blocks,
                                           "key": key}
                joining.append((slot, req, False))
        if not joining:
            return
        if model.paged:
            self._publish_blocks()
        prefilling = [(slot, req) for slot, req, shared in joining
                      if not shared]
        if prefilling:
            src = np.zeros((model.slots, model.max_prompt_len), np.int64)
            active = np.zeros((model.slots,), np.float32)
            for slot, req in prefilling:
                src[slot, :len(req.prompt)] = req.prompt
                active[slot] = 1.0
            sess.prefill(src, active=active)
            # counts prefilled lanes: N same-prefix joiners move it by 1
            self._count(f"serving.gen.{m}.prefills", len(prefilling))

    def _step(self) -> bool:
        """One coalesced decode step for every occupied slot; True when a
        decode ran."""
        model = self.model
        m = model.name
        sess = model.session
        active = np.asarray(
            [1.0 if r is not None else 0.0 for r in self._slot_req],
            np.float32)
        if not active.any():
            return False
        if model.paged and model._shared_self_slots:
            # copy-on-write guard for forked sequences: a slot about to
            # append into a self block it shares gets a private copy
            # first.  Unforked serving never enters here.
            lens = sess.self_cache.lengths.cpu().numpy()
            copies = 0
            for slot in sorted(model._shared_self_slots):
                if active[slot] and sess.self_cache.cow_if_shared(
                        slot, int(lens[slot])):
                    copies += 1
                    info = self._slot_blocks[slot]
                    if info is not None:
                        info["self"] = sess.self_cache.slot_blocks(
                            slot, int(lens[slot]) + 1)
            if copies:
                self._count(f"generation.{m}.cow_copies_total", copies)
        nxt = sess.decode_step(active=active)
        now = time.perf_counter()
        emitted = 0
        finished: List[_GenRequest] = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            expired = req.deadline is not None and now >= req.deadline
            if req.cancelled or expired:
                # abandoned by a timed-out client, or past its deadline:
                # free the slot at this iteration boundary
                self._slot_req[slot] = None
                self._release_slot(slot)
                if expired and not req.cancelled:
                    req.error = TimeoutError(
                        f"generation deadline passed mid-decode (model "
                        f"{m!r}, slot {slot})")
                    req.event.set()
                    self._count(f"serving.gen.{m}.expired_slots_total")
                continue
            tok = int(nxt[slot])
            if req.t_first_token is None:
                req.t_first_token = now
            req.tokens.append(tok)
            emitted += 1
            if tok == model.eos_id or len(req.tokens) >= req.max_tokens:
                req.meta = {
                    "slot": slot,
                    "tokens": len(req.tokens),
                    "ttft_ms": (req.t_first_token - req.t_enqueue) * 1e3,
                    "total_ms": (now - req.t_enqueue) * 1e3,
                    "finished": ("eos" if tok == model.eos_id
                                 else "max_tokens"),
                }
                self._slot_req[slot] = None  # retire the slot
                self._release_slot(slot)
                finished.append(req)
        for req in finished:
            req.event.set()
        self._count(f"serving.gen.{m}.tokens", emitted)
        self._count(f"serving.gen.{m}.decode_steps")
        self._gauge(f"serving.gen.{m}.occupancy", int(active.sum()),
                    peak=True)
        return True

    def _fail_slots(self, exc: Exception) -> None:
        """A prefill or decode raised: fail every occupied slot (the shared
        step leaves their state suspect) but keep the scheduler alive."""
        self.breaker.record_failure()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._slot_req[slot] = None
            self._release_slot(slot)
            req.error = exc
            req.event.set()
        self._count(f"serving.gen.{self.model.name}.step_errors")

    def _loop(self) -> None:
        # the model's device is current in this thread, so its launches
        # run on this thread's current stream of that device
        dev = self.model.device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
        try:
            with ctx:
                while self._running:
                    idle = not any(r is not None for r in self._slot_req)
                    if not self._drain_queue(block=idle):
                        break
                    try:
                        self._admit()
                        if self._step():
                            self.breaker.record_success()
                    except Exception as e:  # noqa: BLE001 - fail the
                        # in-flight slots, not the scheduler (a dead loop
                        # would hang every current and future caller)
                        self._fail_slots(e)
        finally:
            # fail whatever is still in flight or queued so no caller
            # hangs, even after an unexpected scheduler crash
            slotted = [r for r in self._slot_req if r is not None]
            self._slot_req = [None] * self.model.slots
            for slot in range(self.model.slots):
                self._release_slot(slot)
            for r in slotted:
                r.error = Unavailable(
                    f"generation batcher for {self.model.name!r} stopped",
                    reason="stopped")
                r.event.set()
            self._fail_queued()


def build_demo_generation_model(name: str = "gendemo",
                                slots: int = 4, seed: int = 11,
                                device=None,
                                **kw) -> GenerationServingModel:
    """A small deterministic generation model with seeded random weights,
    at the reference demo's widths: 2 layers of 2 heads of 16, d_model 32,
    d_inner 64.  At head width 16 the attention and decode wrappers take
    their plain composition on the card, as the reference's plans do
    (``kernels.composes``).  ``kw`` adds GenerationConfig keywords
    (``paged``, ``num_blocks``, ``fused_decode_step``, ...)."""
    cfg = GenerationConfig(
        name, slots=slots,
        src_vocab_size=32, trg_vocab_size=32, max_length=72,
        n_layer=2, n_head=2, d_key=16, d_value=16, d_model=32,
        d_inner_hid=64, src_seq_len=8, max_out_len=64,
        bos_id=0, eos_id=1, device=device, **kw)
    model = GenerationServingModel(cfg)
    model.init_params(seed)
    return model
