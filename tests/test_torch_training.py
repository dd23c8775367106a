"""paddle_tpu_torch training against the JAX package, on the CPU.

The reference's training program is built twice, once per attention route:
``transformer(use_flash=True, dropout_rate=0.0)`` and
``Adam(1e-3).minimize``, at 2 layers, 2 heads of 64, d_model 128, d_inner
256, vocab 64, source 32 and target 16, batch 2 with padded tails; once
with ``FLAGS_fused_qkv_attention`` off (every attention site is the q/k/v
``mul``, ``fused_attention`` in the bthd layout and the output ``mul``)
and once with the flag at its default, on (every self-attention site is
one ``fused_qkv_attention``, the cross-attention stays ``fused_attention``).
Its startup scope is carried into the port with
``load_paddle_tpu_params``, and both take the same steps on the same
batch: losses, gradients, updated parameters and a resume from the
reference's Adam state must agree, on each route.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.flags import FLAGS
from paddle_tpu.models import transformer as T
from paddle_tpu_torch import (Adam, GenerationSession, Transformer,
                              export_paddle_tpu_adam_state,
                              export_paddle_tpu_params,
                              load_paddle_tpu_adam_state,
                              load_paddle_tpu_params, make_batch)
from paddle_tpu_torch.interop import paddle_tpu_param_names

WIDTHS = dict(src_vocab_size=64, trg_vocab_size=64, max_length=32,
              n_layer=2, n_head=2, d_key=64, d_value=64, d_model=128,
              d_inner_hid=256)
BATCH, SRC_LEN, TRG_LEN, LR, STEPS = 2, 32, 16, 1e-3, 3
#: f32 losses, one step against XLA on the CPU
TOL_LOSS = 1e-5
#: per-tensor relative gradient error ||port - ref|| / ||ref||: the
#: backward sums 2 layers of attention, layer norm and a 64-way softmax in
#: other orders than XLA
TOL_GRAD = 1e-4
#: parameters after 3 Adam steps, abs.  Adam's step lr * m1 / (sqrt(m2) +
#: eps) is about lr * g / (|g| + 3e-7) at step 1, so where |g| is within a
#: few eps-widths of 0 it turns the gradients' last-bit differences into a
#: visible fraction of lr (1e-3).  Measured: 47 of 692,288 elements beyond
#: 1e-6, the worst 1.7e-5.  So: every element within a tenth of one step's
#: lr, and all but 1e-4 of them within 1e-6.
TOL_PARAM = 1e-4
TOL_PARAM_MOST, SHARE_BEYOND = 1e-6, 1e-4


def _batch():
    """make_batch's ids with padded tails (pad id 0): source lane 1 from
    position 25, target lane 0 from 12, whose label weights are 0."""
    batch = T.make_batch(BATCH, SRC_LEN, TRG_LEN, 2, 64, 64,
                         np.random.RandomState(0))
    batch["src_word"][1, 25:] = 0
    batch["trg_word"][0, 12:] = 0
    batch["lbl_weight"][0, 12:] = 0.0
    return batch


class _Reference:
    """The reference's training program, its startup parameters, and the
    state of each of its steps on the batch: the loss, the step-1
    gradients, and the parameters and Adam state after steps 2 and 3.
    ``fused`` leaves ``FLAGS_fused_qkv_attention`` at its default (on);
    otherwise the flag is off while the program is built."""

    def __init__(self, fused=False):
        if not fused:
            FLAGS.set("fused_qkv_attention", False)
        try:
            self.prog, startup = pt.Program(), pt.Program()
            with pt.program_guard(self.prog, startup):
                with pt.core.framework.guard_unique_name():
                    avg_cost, _, _ = T.transformer(
                        **WIDTHS, dropout_rate=0.0, src_seq_len=SRC_LEN,
                        trg_seq_len=TRG_LEN, use_flash=True)
                    _, params_grads = pt.optimizer.Adam(
                        learning_rate=LR).minimize(avg_cost)
        finally:
            FLAGS.reset("fused_qkv_attention")
        ops = [op.type for op in self.prog.global_block().ops]
        # 2 encoder and 2 decoder self sites, 2 cross sites
        assert ops.count("fused_qkv_attention") == (4 if fused else 0)
        assert ops.count("fused_attention") == (2 if fused else 6)
        self.trained = [p.name for p, g in params_grads if g is not None]
        self.scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=self.scope)
        names = [n for n, _ in paddle_tpu_param_names(2)]
        self.start = self.snapshot(names)
        self.accumulators = [v.name for v in self.prog.list_vars()
                             if v.persistable and ("_pow_acc" in v.name
                                                   or "_moment" in v.name)]
        self.losses, self.after = [], []
        for step in range(STEPS):
            fetch = [avg_cost.name]
            if step == 0:
                fetch += [f"{n}@GRAD" for n in self.trained]
            out = exe.run(self.prog, feed=_batch(), fetch_list=fetch,
                          scope=self.scope)
            self.losses.append(float(np.asarray(out[0])))
            if step == 0:
                self.grads = {n: np.asarray(g)
                              for n, g in zip(self.trained, out[1:])}
            self.after.append(self.snapshot(names + self.accumulators))

    def snapshot(self, names):
        return {n: np.array(self.scope.find_var(n)) for n in names}


@pytest.fixture(scope="module")
def ref():
    return _Reference()


@pytest.fixture(scope="module")
def ref_fused():
    return _Reference(fused=True)


def _port(params, fused_qkv_attention=False, **kw):
    model = Transformer(**WIDTHS, device="cpu",
                        fused_qkv_attention=fused_qkv_attention, **kw)
    return load_paddle_tpu_params(model, params)


def _feed():
    return {k: torch.from_numpy(v) for k, v in make_batch(
        BATCH, SRC_LEN, TRG_LEN, 2, 64, 64, np.random.RandomState(0)).items()}


def _padded_feed():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _rel(got, want):
    return (np.linalg.norm(np.asarray(got) - want)
            / max(np.linalg.norm(want), 1e-30))


def test_make_batch_is_the_reference_batch():
    want = T.make_batch(BATCH, SRC_LEN, TRG_LEN, 2, 64, 64,
                        np.random.RandomState(0))
    got = make_batch(BATCH, SRC_LEN, TRG_LEN, 2, 64, 64,
                     np.random.RandomState(0))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_three_adam_steps_match_reference(ref):
    """Loss of each step within 1e-5 relative; every trained parameter's
    step-1 gradient within 1e-4 relative (norm); the parameters after 3
    steps within TOL_PARAM; the position tables never move."""
    _three_adam_steps(ref, fused_qkv_attention=False)


def test_fused_route_three_adam_steps_match_reference(ref_fused):
    """The port's default route (fused_qkv_attention=True: #1 forward, #2
    and #3 backward at every self-attention site) against the reference's
    default-flag program, under the same tolerances."""
    _three_adam_steps(ref_fused, fused_qkv_attention=True)


def _three_adam_steps(ref, fused_qkv_attention):
    model = _port(ref.start, fused_qkv_attention=fused_qkv_attention)
    opt = Adam(model.parameters(), learning_rate=LR)
    names = dict(paddle_tpu_param_names(2))
    assert sorted(names[n] for n in ref.trained) == sorted(
        n for n, p in model.named_parameters() if p.requires_grad)
    for step in range(STEPS):
        loss, predict = model(**_padded_feed())
        assert predict.shape == (BATCH, TRG_LEN, 64)
        assert abs(loss.item() - ref.losses[step]) <= TOL_LOSS * abs(
            ref.losses[step]), (step, loss.item(), ref.losses[step])
        params_grads = opt.minimize(loss)
        if step == 0:
            got = {p: g for p, g in params_grads}
            assert len(got) == len(ref.trained)
            for n in ref.trained:
                g = got[model.get_parameter(names[n])]
                assert _rel(g, ref.grads[n]) <= TOL_GRAD, n
        assert all(p.grad is None for p in model.parameters())
    assert ref.losses[-1] < ref.losses[0]
    exported = export_paddle_tpu_params(model)
    beyond = total = 0
    for n, got in exported.items():
        want = ref.after[-1][n]
        np.testing.assert_allclose(got, want, atol=TOL_PARAM, rtol=0,
                                   err_msg=n)
        beyond += int((np.abs(got - want) > TOL_PARAM_MOST).sum())
        total += got.size
    assert beyond <= SHARE_BEYOND * total, (beyond, total)
    for n in ("src_pos_enc_table", "trg_pos_enc_table"):
        np.testing.assert_array_equal(exported[n], ref.start[n])


def test_resume_from_reference_adam_state(ref):
    """The reference takes 2 steps; its parameters and Adam state (moments
    and beta powers under its accumulator names) carried into the port
    give the reference's step 3: loss within 1e-5 relative, parameters
    within 1e-6 (one step from the same state: no eps-regime drift yet)
    and each accumulator within 1e-4 relative (norm)."""
    _resume(ref, fused_qkv_attention=False)


def test_fused_route_resume_from_reference_adam_state(ref_fused):
    """The same resume on the default (fused) route, from the reference's
    default-flag program: both routes have the same parameter names, so
    the same interop carries them."""
    _resume(ref_fused, fused_qkv_attention=True)


def _resume(ref, fused_qkv_attention):
    state = ref.after[1]
    model = _port(state, fused_qkv_attention=fused_qkv_attention)
    opt = Adam(model.parameters(), learning_rate=LR)
    load_paddle_tpu_adam_state(opt, model, state)
    exported = export_paddle_tpu_adam_state(opt, model)
    assert len(exported) == 4 * len(ref.trained)
    for n, v in exported.items():
        np.testing.assert_array_equal(v.reshape(state[n].shape), state[n])
    loss, _ = model(**_padded_feed())
    assert abs(loss.item() - ref.losses[2]) <= TOL_LOSS * ref.losses[2]
    opt.minimize(loss)
    params = export_paddle_tpu_params(model)
    for n, got in params.items():
        np.testing.assert_allclose(got, ref.after[2][n],
                                   atol=TOL_PARAM_MOST, rtol=0, err_msg=n)
    for n, got in export_paddle_tpu_adam_state(opt, model).items():
        assert _rel(got.reshape(ref.after[2][n].shape),
                    ref.after[2][n]) <= TOL_GRAD, n


def test_training_guards_and_serving_on_the_same_model(ref):
    """Dropout raises in training; the fused-qkv route trains (its loss has
    a backward); the same model objects still serve, under no_grad, the
    tokens of the default model."""
    fused = _port(ref.start, fused_qkv_attention=True)
    loss, _ = fused(**_feed())
    assert loss.grad_fn is not None and torch.isfinite(loss)
    dropout = _port(ref.start, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="dropout slice"):
        dropout(**_feed())
    with torch.no_grad():  # inference: dropout is off, as in the reference
        loss, _ = dropout(**_feed())
    assert torch.isfinite(loss)
    src = _feed()["src_word"][..., 0].numpy()
    tokens = []
    for model in (fused, dropout, _port(ref.start, fused_qkv_attention=True,
                                        dropout_rate=0.0)):
        sess = GenerationSession(model, BATCH, SRC_LEN, 8, bos_id=0,
                                 eos_id=-1)
        tokens.append(sess.generate(src)[0])
    assert tokens[0].shape == (BATCH, 8)
    np.testing.assert_array_equal(tokens[0], tokens[2])
    np.testing.assert_array_equal(tokens[1], tokens[2])


def test_plain_path_runs_float64(ref):
    """A float64 copy of the model trains through the plain path in
    float64 (the exact reference chip_smoke.py holds the card's f32
    gradients against); f32 is within TOL_GRAD of it here."""
    model = _port(ref.start)
    exact = _port(ref.start).double()
    grads = []
    for m in (model, exact):
        loss, _ = m(**_padded_feed())
        loss.backward()
        grads.append({n: p.grad for n, p in m.named_parameters()
                      if p.grad is not None})
        assert loss.dtype == next(m.parameters()).dtype
    assert exact.src_word_emb.grad.dtype == torch.float64
    for n, g in grads[0].items():
        assert _rel(g.double().numpy(), grads[1][n].numpy()) <= TOL_GRAD, n


def test_fused_and_flag_off_routes_agree(ref):
    """On the same weights and batch the port's two attention routes give
    the same loss (1e-6 relative) and the same step-1 gradients (1e-5
    relative, per tensor): #1-#3 compute the flag-off composition's
    function."""
    results = []
    for fused in (True, False):
        model = _port(ref.start, fused_qkv_attention=fused)
        loss, _ = model(**_padded_feed())
        loss.backward()
        results.append((loss.item(), {n: p.grad.numpy() for n, p in
                                      model.named_parameters()
                                      if p.grad is not None}))
    (loss_f, grads_f), (loss_u, grads_u) = results
    assert abs(loss_f - loss_u) <= 1e-6 * abs(loss_u)
    assert grads_f.keys() == grads_u.keys()
    for n, g in grads_f.items():
        assert _rel(g, grads_u[n]) <= 1e-5, n
