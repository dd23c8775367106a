"""paddle_tpu_torch generation against the JAX package, on the CPU.

A small encoder-decoder (2 layers, d_model 128, 2 heads of 64, d_inner
256, vocab 64, source 16) is built and initialized by the reference's
generation programs (use_flash=True, default flags); its scope is carried
into the port with load_paddle_tpu_params, and both packages then generate
greedily from the same sources.  The cross cache after prefill, the logits
of every step and the tokens must agree.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.core import executor as ex
from paddle_tpu.generation import GenerationSession as JaxSession
from paddle_tpu.models import transformer as T
import paddle_tpu_torch
from paddle_tpu_torch import GenerationSession, Transformer
from paddle_tpu_torch.interop import (load_paddle_tpu_params,
                                      paddle_tpu_param_names)

#: f32 logits and caches, two layers deep, against XLA on the CPU
TOL = 1e-4

WIDTHS = dict(src_vocab_size=64, trg_vocab_size=64, max_length=20,
              n_head=2, d_key=64, d_value=64, d_model=128, d_inner_hid=256)
BATCH, SRC_LEN, MAX_OUT = 2, 16, 10


def _programs(n_layer=2, **kw):
    dims = dict(WIDTHS, n_layer=n_layer, batch_size=BATCH,
                src_seq_len=SRC_LEN, max_out_len=MAX_OUT, bos_id=0,
                eos_id=1, use_flash=True)
    dims.update(kw)
    return T.build_generation_programs(**dims)


def _source(seed):
    """[2, 16, 1] ids in [2, 64); lane 1 has a padded tail."""
    src = np.random.RandomState(seed).randint(2, 64, (BATCH, SRC_LEN, 1))
    src[1, 11:] = 0
    return src.astype(np.int64)


class _Reference:
    """The reference's programs, one executor (so each program compiles
    once) and the initialized parameters."""

    def __init__(self, **kw):
        self.programs = _programs(**kw)
        self.exe = ex.Executor(ex.default_place())
        sess = JaxSession(self.programs, executor=self.exe)
        sess.init_params()
        self.params = {n: sess.scope.find_var(n)
                       for n, _ in paddle_tpu_param_names(2)}


class _Pair:
    """A fresh reference session and the port's session (CPU) on the same
    weights."""

    def __init__(self, ref):
        scope = ex.Scope()
        for name, value in ref.params.items():
            scope.set_var(name, value)
        self.jax = JaxSession(ref.programs, scope=scope, executor=ref.exe)
        p = ref.programs
        op = next(o for o in p.decode.global_block().ops
                  if o.type == "sample_token")
        self.logits_name = op.input("Logits")[0]
        model = Transformer(**WIDTHS, n_layer=2, device="cpu")
        load_paddle_tpu_params(model, ref.params)
        self.port = GenerationSession(model, BATCH, SRC_LEN, MAX_OUT,
                                      bos_id=p.bos_id, eos_id=p.eos_id)

    def prefill(self, src, active=None):
        got = self.port.prefill(src, active=active)
        want = self.jax.prefill(src, active=active)
        np.testing.assert_array_equal(got, want)

    def step(self):
        """One decode step on both; returns the reference's tokens."""
        feed = {"gen_active": np.ones((BATCH, 1), np.float32)}
        tok, logits = self.jax.exe.run(
            self.jax.p.decode, feed=feed,
            fetch_list=self.jax.p.decode_fetch + [self.logits_name],
            scope=self.jax.scope)
        got = self.port.decode_step()
        np.testing.assert_allclose(self.port.last_logits.numpy(),
                                   np.asarray(logits), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(got, np.asarray(tok).reshape(BATCH))
        return got

    def check_caches(self):
        scope = self.jax.scope
        for side, cache in (("self", self.port.self_cache),
                            ("cross", self.port.cross_cache)):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(cache, name).numpy(),
                    np.asarray(scope.find_var(f"gen_{side}_{name}")),
                    atol=TOL, rtol=TOL)
            np.testing.assert_array_equal(
                cache.lengths.numpy(),
                np.asarray(scope.find_var(f"gen_{side}_len")))


@pytest.fixture(scope="module")
def ref():
    return _Reference()


@pytest.mark.parametrize("n_layer", [2, 3])
def test_param_names_match_reference_programs(n_layer):
    """The name map is the reference's draw order, and every name lands on
    a port parameter of the reference's shape."""
    p = _programs(n_layer=n_layer)
    want = [(v.name, tuple(v.shape)) for prog in (p.prefill, p.decode)
            for v in prog.all_parameters()]
    pairs = paddle_tpu_param_names(n_layer)
    assert [n for n, _ in pairs] == [n for n, _ in want]
    model = Transformer(**WIDTHS, n_layer=n_layer, device="cpu")
    shapes = dict(want)
    for name, path in pairs:
        assert tuple(model.get_parameter(path).shape) == shapes[name], name
    assert len(pairs) == len(list(model.parameters()))


def test_prefill_cross_cache_matches_reference(ref):
    pair = _Pair(ref)
    src = _source(0)
    pair.prefill(src)
    pair.check_caches()
    np.testing.assert_array_equal(pair.port.cross_cache.lengths.numpy(),
                                  [16, 11])


def test_greedy_decode_matches_reference_step_by_step(ref):
    pair = _Pair(ref)
    pair.prefill(_source(1))
    for _ in range(MAX_OUT):
        pair.step()
    pair.check_caches()


def test_late_join_matches_reference(ref):
    """prefill(active=[0, 1]) mid-stream: lane 1 restarts on a new source
    (BOS, self length 0, fresh cross length); lane 0 keeps its state."""
    pair = _Pair(ref)
    pair.prefill(_source(2))
    for _ in range(4):
        pair.step()
    lane0 = pair.port.self_cache.lengths[0].item()
    pair.prefill(_source(3), active=np.array([0, 1]))
    assert pair.port.self_cache.lengths.tolist() == [lane0, 0]
    assert pair.port.last_tok[1].item() == pair.port.bos_id
    pair.check_caches()
    for _ in range(4):
        pair.step()
    pair.check_caches()


def test_generate_matches_reference_with_eos_latch(ref):
    """generate(): identical eos-padded tokens and step counts, with an
    eos the model really emits so the latch and early exit are driven."""
    src = _source(4)
    toks, _ = _Pair(ref).jax.generate(src, max_tokens=3)
    eos = int(toks[0, -1])
    eos_ref = _Reference(eos_id=eos)
    eos_ref.params = ref.params  # the weights that emitted eos
    pair = _Pair(eos_ref)
    got, steps = pair.port.generate(src)
    want, want_steps = pair.jax.generate(src)
    assert steps == want_steps
    np.testing.assert_array_equal(got, want)
    assert (got == eos).any()


def test_port_imports_no_jax():
    """Every module of the package, found by walking it, imports without
    pulling in JAX or the JAX package."""
    code = ("import importlib, pkgutil, sys, paddle_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'paddle_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "assert {'paddle_tpu_torch.serving.generation', "
            "'paddle_tpu_torch.kernels.decode_attention'} <= set(mods)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or "
            "m.startswith(('jax.', 'paddle_tpu.'))]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_default_device_is_cuda(monkeypatch):
    """Without device=..., the entry points run on CUDA and raise when
    there is none; they never fall back to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(**WIDTHS, n_layer=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle_tpu_torch.resolve_device()
    assert paddle_tpu_torch.resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert paddle_tpu_torch.resolve_device().type == "cuda"
