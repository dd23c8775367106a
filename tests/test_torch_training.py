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
reference's Adam state must agree, on each route.  Both routes are built
once more at ``dropout_rate=0.1`` (the reference's default): each step's
run id is forced, so its base key, and with the program's ``rng_id``s
every site's seed, is known; the port takes those seeds
(``interop.dropout_seeds``) and must follow the reference's 3 steps under
the same tolerances, its masks being the reference's bit for bit.  The
fused route at dropout 0.1 is built once more under ``pt.amp.enable`` (bf16
amp): the port, ``amp.enable``d, follows its 3 steps at bf16 tolerances,
every gradient reaching Adam f32; and ``softmax_with_cross_entropy`` on
bf16 logits is held against the reference's lowering.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import framework
from paddle_tpu.core.executor import prng_key
from paddle_tpu.flags import FLAGS
from paddle_tpu.models import transformer as T
from paddle_tpu_torch import (Adam, GenerationSession, Transformer, amp,
                              export_paddle_tpu_adam_state,
                              export_paddle_tpu_params,
                              load_paddle_tpu_adam_state,
                              load_paddle_tpu_params, make_batch)
from paddle_tpu_torch.interop import dropout_seeds, paddle_tpu_param_names
from paddle_tpu_torch.models import transformer as port_transformer
from paddle_tpu_torch.ops.nn_ops import softmax_with_cross_entropy

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
#: the reference's default dropout rate (``transformer()``)
DROPOUT = 0.1
#: bf16 amp against the reference's bf16 program on XLA's CPU.  Both round
#: every matmul output, residual sum and layer-norm output to bf16 (8
#: significant bits, a relative step of 2^-8 = 3.9e-3), in other orders
#: and not always at the same points (XLA may keep a fused chain in f32,
#: the reference rounds the fused attention's dx in two halves), so
#: single roundings differ by a bf16 step.  For scale: on the same
#: weights the port's bf16 step-1 gradients are 4-7% (norm) from its own
#: f32 ones.  Measured against the reference: the loss within 1.1e-4 at
#: step 1 and 1.05e-3 at step 3 (after two updates from bf16 gradients);
#: gradients within 3.7% per tensor (the FFN input weights of the second
#: decoder layer, the far end of the backward); the parameters after 3
#: steps within 5.1e-3, 1.4% of the elements beyond lr / 2.
TOL_AMP_LOSS = 3e-3
#: The program's dropout sites draw their rng_ids from the process-wide
#: counter (``framework._rng_id_counter``), so the masks follow its value
#: k when the program is built.  The test builds the reference at
#: AMP_RNG_BASES: k 0 (a fresh process) and k 61 (the widest reading of
#: 40 values of k).
AMP_RNG_BASES = (0, 61)
#: The two sides run free from the same start, and a bf16 matmul or
#: attention output that differs by one bf16 step in one element (XLA
#: and the port sum the f32 products in other orders: 1 to 12 elements
#: of a layer's output, k 0, 1, 43, 61) moves later pre-activations; where
#: one sits within a step of 0 its relu mask flips, and the flipped
#: elements carry most of a step's gradient error (k 61: 24 flips in the
#: last FFN against float64 on the port, 21 on the reference; the FFN
#: input bias's gradient 0.095 from float64 on the port, 0.070 on the
#: reference, with dHidden 0.006 on both).  Free-running, each side's
#: step-1 gradients against the port's float64 step sit 0.058-0.107
#: (port) and 0.056-0.087 (reference) at the worst tensor, 0.032-0.064
#: and 0.034-0.052 over all gradients (12 masks, k 0-3, 7, 20, 33, 43,
#: 50, 61, 90, 120), the port 0.80-1.35 times the reference's.
TOL_AMP_GRAD_F64 = 0.12
TOL_AMP_GRAD_F64_ALL = 0.08
#: So the port's gradients are held to the reference's on a replayed
#: step: each op of REPLAY_OPS returns the reference's forward value and
#: passes its gradient to the port's own backward of that op, so both
#: backwards see the same values and the same masks.  Measured over k 0,
#: 1, 43, 61: each port op's own output within 1.6e-4 (norm) of the
#: reference's on the reference's inputs; the step-1 gradients within
#: 0.0097 per tensor, 0.0052 over all; the port's distance to float64
#: over all gradients 0.9967-1.0035 times the reference's.
TOL_AMP_OP = 1e-3
TOL_AMP_GRAD = 0.06
#: 1 plus the replayed step's measured spread (0.35%), rounded up
AMP_F64_RATIO = 1.01
#: Adam moves an element by about lr times sign(g) a step wherever |g| >>
#: eps, so where the two sides' bf16 gradients differ in sign (|g| within
#: a few bf16 steps of 0) an element can end up to 2 lr apart a step: 3
#: steps bound it by 6 lr.  All but 5% of the elements stay within half of
#: one step's lr.
TOL_AMP_PARAM = 2 * STEPS * LR
TOL_AMP_PARAM_MOST, AMP_SHARE_BEYOND = 0.5 * LR, 5e-2
#: the op types that draw a dropout seed, as the reference lowers them
DROPOUT_OPS = ("dropout", "dropout_add", "fused_attention",
               "fused_qkv_attention")
#: the reference's forward op types whose outputs the replayed step takes,
#: by the function of ``paddle_tpu_torch.models.transformer`` that
#: computes each on the port (``elementwise_add`` only as a bias after a
#: ``mul``: the port adds the embeddings and builds the biases with ``+``)
REPLAY_OPS = {"dropout": "dropout", "fused_qkv_attention": "self_attention",
              "dropout_add": "dropout_add", "layer_norm": "layer_norm",
              "mul": "mul", "elementwise_add": "elementwise_add"}


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
    otherwise the flag is off while the program is built.  With
    ``dropout_rate`` each step runs under a forced run id and ``seeds``
    holds the port's dropout seeds of each step; with ``amp`` the program
    runs under ``pt.amp.enable`` (bf16).  ``rng_base`` sets the
    process-wide rng-id counter while the program is built (its dropout
    sites' ids follow it) and restores it after."""

    def __init__(self, fused=False, dropout_rate=0.0, amp=False,
                 rng_base=None):
        if not fused:
            FLAGS.set("fused_qkv_attention", False)
        counter = framework._rng_id_counter[0]
        if rng_base is not None:
            framework._rng_id_counter[0] = rng_base
        try:
            self.prog, startup = pt.Program(), pt.Program()
            with pt.program_guard(self.prog, startup):
                with pt.core.framework.guard_unique_name():
                    avg_cost, _, _ = T.transformer(
                        **WIDTHS, dropout_rate=dropout_rate,
                        src_seq_len=SRC_LEN, trg_seq_len=TRG_LEN,
                        use_flash=True)
                    _, params_grads = pt.optimizer.Adam(
                        learning_rate=LR).minimize(avg_cost)
        finally:
            FLAGS.reset("fused_qkv_attention")
            if rng_base is not None:
                framework._rng_id_counter[0] = counter
        if amp:
            pt.amp.enable(self.prog)
        ops = [op.type for op in self.prog.global_block().ops]
        # 2 encoder and 2 decoder self sites, 2 cross sites
        assert ops.count("fused_qkv_attention") == (4 if fused else 0)
        assert ops.count("fused_attention") == (2 if fused else 6)
        rng_ids = [op.attrs["rng_id"] for op in self.prog.global_block().ops
                   if op.type in DROPOUT_OPS and dropout_rate]
        # 2 embedding sites, 3 per encoder and 5 per decoder layer
        assert len(rng_ids) == (18 if dropout_rate else 0)
        assert all(rng_ids) and len(set(rng_ids)) == len(rng_ids)
        self.seeds = []
        self.trained = [p.name for p, g in params_grads if g is not None]
        self.replayed = _replayed_outputs(self.prog) if amp else []
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
                fetch += [f"{n}@GRAD" for n in self.trained] + self.replayed
            if dropout_rate:
                # the step's base key: fold_in(prng_key(random_seed), run
                # id), as Executor.run derives it
                run_id = 101 + step
                exe._forced_run_id = run_id
                key = jax.random.fold_in(
                    prng_key(self.prog.random_seed or 0), run_id)
                self.seeds.append(dropout_seeds(
                    np.asarray(jax.random.key_data(key)), rng_ids))
            out = exe.run(self.prog, feed=_batch(), fetch_list=fetch,
                          scope=self.scope)
            self.losses.append(float(np.asarray(out[0])))
            if step == 0:
                grads = out[1:1 + len(self.trained)]
                self.grads = {n: np.asarray(g, np.float64)
                              for n, g in zip(self.trained, grads)}
                self.forward = [np.asarray(v).astype(np.float32)
                                for v in out[1 + len(self.trained):]]
            self.after.append(self.snapshot(names + self.accumulators))

    def snapshot(self, names):
        return {n: np.array(self.scope.find_var(n)) for n in names}


def _replayed_outputs(prog):
    """The outputs of the forward ops of REPLAY_OPS, in program order."""
    made_by, names = {}, []
    for op in prog.global_block().ops:
        if op.type.endswith("_grad"):
            break
        taken = op.type in REPLAY_OPS and (
            op.type != "elementwise_add"
            or made_by.get(op.inputs["X"][0]) == "mul")
        if taken:
            names.append((op.outputs.get("Out") or op.outputs["Y"])[0])
        for vals in op.outputs.values():
            made_by.update(dict.fromkeys(vals, op.type))
    return names


@pytest.fixture(scope="module")
def ref():
    return _Reference()


@pytest.fixture(scope="module")
def ref_fused():
    return _Reference(fused=True)


@pytest.fixture(scope="module")
def ref_dropout():
    return _Reference(dropout_rate=DROPOUT)


@pytest.fixture(scope="module")
def ref_fused_dropout():
    return _Reference(fused=True, dropout_rate=DROPOUT)


@pytest.fixture(scope="module", params=AMP_RNG_BASES)
def ref_amp(request):
    """The default-flag dropout program under ``pt.amp.enable`` (bf16),
    built at the rng-id counter's value ``request.param``."""
    return _Reference(fused=True, dropout_rate=DROPOUT, amp=True,
                      rng_base=request.param)


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


def test_dropout_three_adam_steps_match_reference(ref_dropout):
    """The flag-off route at dropout 0.1 against the reference's dropout
    program, each step under the reference step's seeds: losses, step-1
    gradients and the parameters after 3 steps under the same tolerances
    (embedding dropout, 12 dropout-adds and the weights dropout of 6
    attention sites, their masks bit for bit)."""
    _three_adam_steps(ref_dropout, fused_qkv_attention=False,
                      dropout_rate=DROPOUT)


def test_fused_route_dropout_three_adam_steps_match_reference(
        ref_fused_dropout):
    """The default (fused) route at dropout 0.1 against the reference's
    default-flag dropout program, as above: #1-#3's twins drop the
    reference's fused kernels' mask."""
    _three_adam_steps(ref_fused_dropout, fused_qkv_attention=True,
                      dropout_rate=DROPOUT)


def _three_adam_steps(ref, fused_qkv_attention, dropout_rate=0.0):
    model = _port(ref.start, fused_qkv_attention=fused_qkv_attention,
                  dropout_rate=dropout_rate)
    opt = Adam(model.parameters(), learning_rate=LR)
    names = dict(paddle_tpu_param_names(2))
    assert sorted(names[n] for n in ref.trained) == sorted(
        n for n, p in model.named_parameters() if p.requires_grad)
    for step in range(STEPS):
        seeds = ref.seeds[step] if dropout_rate else None
        loss, predict = model(**_padded_feed(), dropout_seeds=seeds)
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
    """Dropout trains (in training mode the loss has a backward and moves
    off the undropped loss) and is off in eval mode (the reference's
    is_test: the undropped loss); a wrong number of seeds raises; the
    fused-qkv route trains; the same model objects still serve, under
    no_grad, the tokens of the default model."""
    fused = _port(ref.start, fused_qkv_attention=True)
    loss, _ = fused(**_feed())
    assert loss.grad_fn is not None and torch.isfinite(loss)
    dropout = _port(ref.start, dropout_rate=0.1)
    dropped, _ = dropout(**_feed(), generator=torch.Generator().manual_seed(0))
    assert dropped.grad_fn is not None and torch.isfinite(dropped)
    assert abs(dropped.item() - loss.item()) > 1e-4
    with pytest.raises(ValueError, match="dropout seeds"):
        dropout(**_feed(), dropout_seeds=[1, 2, 3])
    dropout.eval()  # inference: dropout is off, as in the reference
    with torch.no_grad():
        undropped, _ = dropout(**_feed())
    assert abs(undropped.item() - loss.item()) <= 1e-6 * abs(loss.item())
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


def _f64_grads(ref, names):
    """The port's float64 step-1 gradients (the f32 path in float64) on
    the reference's start under its step-1 seeds: {reference name:
    gradient}."""
    model = _port(ref.start, fused_qkv_attention=True,
                  dropout_rate=DROPOUT).to(torch.float64)
    loss, _ = model(**_padded_feed(), dropout_seeds=ref.seeds[0])
    loss.backward()
    return {n: model.get_parameter(names[n]).grad.numpy()
            for n in ref.trained}


class _Replayed(torch.autograd.Function):
    """The reference's value in place of a port op's output; the gradient
    goes on to that op's own backward."""

    @staticmethod
    def forward(ctx, mine, theirs):
        return theirs.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _replayed_grads(ref, names, monkeypatch, fused=True):
    """The port's amp step-1 gradients on the reference's replayed forward:
    each call of a REPLAY_OPS function returns the reference's output of
    that op, after its own output is held within TOL_AMP_OP of it on the
    same inputs.  ``fused`` is the route of the port and of ``ref``: on the
    flag-off route the self-attention's q/k/v and output ``mul``s are
    replayed, as that program has no ``fused_qkv_attention``.  {reference
    name: gradient}."""
    values = iter(ref.forward)
    drift = []

    def replay(fn):
        def replayed(*args, **kwargs):
            mine = fn(*args, **kwargs)
            want = torch.from_numpy(next(values)).to(mine.dtype).reshape(
                mine.shape)
            drift.append(_rel(mine.detach().double().numpy(),
                              want.double().numpy()))
            return _Replayed.apply(mine, want)
        return replayed

    model = _port(ref.start, fused_qkv_attention=fused, dropout_rate=DROPOUT)
    amp.enable(model)
    with monkeypatch.context() as patch:
        for name in set(REPLAY_OPS.values()) - (
                set() if fused else {"self_attention"}):
            patch.setattr(port_transformer, name,
                          replay(getattr(port_transformer, name)))
        loss, _ = model(**_padded_feed(), dropout_seeds=ref.seeds[0])
    assert len(drift) == len(ref.forward), (len(drift), len(ref.forward))
    assert max(drift) <= TOL_AMP_OP, max(drift)
    loss.backward()
    return {n: model.get_parameter(names[n]).grad.numpy().astype(np.float64)
            for n in ref.trained}


def test_amp_three_adam_steps_match_reference(ref_amp, monkeypatch):
    """The default (fused) route at dropout 0.1 under ``amp.enable`` against
    the reference's program under ``pt.amp.enable``, each step under the
    reference step's seeds, at each of AMP_RNG_BASES: losses within
    TOL_AMP_LOSS; every trained parameter's step-1 gradient f32, and each
    side's within TOL_AMP_GRAD_F64 of the float64 step a tensor and
    TOL_AMP_GRAD_F64_ALL over all of them; on the replayed step (see
    _replayed_grads) every gradient within TOL_AMP_GRAD of the
    reference's, and the port's distance to float64 over all of them at
    most AMP_F64_RATIO times the reference's; the parameters after 3
    steps within TOL_AMP_PARAM (all but AMP_SHARE_BEYOND of them within
    TOL_AMP_PARAM_MOST); the bf16 step is not the f32 one (the policy
    took effect) and the position tables never move."""
    names = dict(paddle_tpu_param_names(2))
    exact = _f64_grads(ref_amp, names)
    replayed = _replayed_grads(ref_amp, names, monkeypatch)
    model = _port(ref_amp.start, fused_qkv_attention=True,
                  dropout_rate=DROPOUT)
    amp.enable(model)
    f32 = _port(ref_amp.start, fused_qkv_attention=True,
                dropout_rate=DROPOUT)
    opt = Adam(model.parameters(), learning_rate=LR)
    for step in range(STEPS):
        seeds = ref_amp.seeds[step]
        loss, predict = model(**_padded_feed(), dropout_seeds=seeds)
        assert predict.dtype == torch.bfloat16 and loss.dtype == torch.float32
        want = ref_amp.losses[step]
        assert abs(loss.item() - want) <= TOL_AMP_LOSS * abs(want), (
            step, loss.item(), want)
        if step == 0:
            loss32, _ = f32(**_padded_feed(), dropout_seeds=seeds)
            assert loss32.item() != loss.item()
        params_grads = opt.minimize(loss)
        if step == 0:
            got = {p: g for p, g in params_grads}
            assert len(got) == len(ref_amp.trained)
            port = {}
            for n in ref_amp.trained:
                p = model.get_parameter(names[n])
                assert p.dtype == got[p].dtype == torch.float32, n
                port[n] = got[p].numpy().astype(np.float64)
                for side in (port[n], ref_amp.grads[n]):
                    assert _rel(side, exact[n]) <= TOL_AMP_GRAD_F64, n
                assert _rel(replayed[n], ref_amp.grads[n]) <= TOL_AMP_GRAD, n

            def whole(grads):
                return np.concatenate([np.ravel(grads[n])
                                       for n in ref_amp.trained])

            far = [_rel(whole(g), whole(exact))
                   for g in (port, ref_amp.grads, replayed)]
            assert max(far[:2]) <= TOL_AMP_GRAD_F64_ALL, far
            assert far[2] <= AMP_F64_RATIO * far[1], far
    exported = export_paddle_tpu_params(model)
    beyond = total = 0
    for n, got in exported.items():
        want = ref_amp.after[-1][n]
        np.testing.assert_allclose(got, want, atol=TOL_AMP_PARAM, rtol=0,
                                   err_msg=n)
        beyond += int((np.abs(got - want) > TOL_AMP_PARAM_MOST).sum())
        total += got.size
    assert beyond <= AMP_SHARE_BEYOND * total, (beyond, total)
    for n in ("src_pos_enc_table", "trg_pos_enc_table"):
        np.testing.assert_array_equal(exported[n], ref_amp.start[n])


class _Attrs:
    """The lowering context's attributes at their defaults."""

    def attr(self, name, default=None):
        return default


def _ref_softmax_ce(logits, label):
    from paddle_tpu.ops.nn_ops import lower_softmax_with_ce

    return lower_softmax_with_ce(_Attrs(), {"Logits": [logits],
                                            "Label": [label]})["Loss"][0]


def test_softmax_with_cross_entropy_bf16_matches_reference_lowering():
    """bf16 logits [N, V]: the loss is f32 and within 1e-6 relative of the
    reference's lowering (the shift in bf16, both exact here, the f32 sums
    in other orders); its gradient is bf16 and within one bf16 step of
    jax.vjp's, which rounds the same two parts."""
    rng = np.random.RandomState(3)
    x = (rng.randn(48, 64) * 4).astype(np.float32)
    label = rng.randint(0, 64, (48, 1)).astype(np.int64)
    g = rng.rand(48, 1).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda a: _ref_softmax_ce(a, jnp.asarray(label)), xj)
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    got = softmax_with_cross_entropy(xt, torch.from_numpy(label))
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(want_dx.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-6)


def test_softmax_with_cross_entropy_f32_bits_unchanged():
    """f32 logits keep the f32 formula's bits: log sum exp(shifted) -
    shifted[label] with the shift and every sum in f32."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(40, 64) * 3).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 64, (40, 1)))
    shifted = x - x.amax(-1, keepdim=True)
    want = (torch.log(torch.exp(shifted).sum(-1, keepdim=True))
            - torch.gather(shifted, -1, label))
    got = softmax_with_cross_entropy(x, label)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
