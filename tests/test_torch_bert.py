"""paddle_tpu_torch BERT pretraining against the JAX package, on the CPU.

The reference's ``build_pretrain_net`` is built at 2 layers, 2 heads of
64, d_model 128, d_ff 256, vocab 1000, seq 32, batch 4 (lane 1 padded from
position 25 through its input mask, its label weights 0 there), with
``Adam(1e-3)``, on each attention route: its default build (the
hand-written matmul / softmax / dropout / matmul composition), the same
after ``passes.apply_pass("attention_fuse")`` (``fused_attention`` in
bhtd, kernels #5, #8, #9), and ``use_flash=True`` with
``FLAGS_fused_qkv_attention`` on (#1-#3) and off (bthd, #4, #6, #7); each
at rate 0 and at 0.1.  Every program is built once per module.  Its
startup scope is carried into the port with
``load_paddle_tpu_bert_params``; with dropout each step runs under a
forced run id, so its base key and, with the program's ``rng_id``s, every
site's seed is known (``interop.dropout_seeds`` over the ids in their
order, which is ``BertPretrain.dropout_sites()``'s).  Both take 2 steps on
the same batch: losses, step 1's gradients, the parameters and the Adam
moments must agree.  Each route and rate is built once more under
``pt.amp.enable`` (bf16 amp): the port, ``amp.enable``d, follows its 2
steps at bf16 tolerances, and the hand-written attention takes the
reference's policy op by op.
"""

import functools

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as pt
from paddle_tpu import passes
from paddle_tpu.core.executor import prng_key
from paddle_tpu.flags import FLAGS
from paddle_tpu.models import bert as jax_bert
from paddle_tpu_torch import (Adam, BertPretrain, amp, attention_fuse,
                              export_paddle_tpu_adam_state,
                              export_paddle_tpu_bert_params,
                              load_paddle_tpu_bert_params, make_bert_batch)
from paddle_tpu_torch.interop import bert_param_names, dropout_seeds

WIDTHS = dict(vocab_size=1000, seq_len=32, n_layer=2, n_head=2, d_model=128,
              d_ff=256)
BATCH, LR, STEPS, RATE = 4, 1e-3, 2, 0.1
#: f32 losses, relative: the same function summed in other orders
TOL_LOSS = 1e-5
#: step 1's gradients, per tensor, ||port - ref|| / ||ref||: 2 layers of
#: attention, layer norm, gelu and a 1000-way softmax summed in other
#: orders than XLA's; measured worst 6.1e-7 over the 8 programs
TOL_GRAD = 1e-5
#: parameters after 2 Adam steps, abs: Adam's first steps are about lr *
#: g / (|g| + 3e-7), so where |g| is within a few eps-widths of 0 the
#: gradients' last-bit differences become a visible fraction of lr
#: (1e-3): every element within a tenth of lr, all but 1e-4 of them within
#: 1e-6 (measured worst 3.0e-5).  The Adam moments after step 2, per
#: tensor, relative: step 2's gradients are taken at parameters those
#: eps-regime elements moved apart (measured worst 1.2e-5)
TOL_PARAM, TOL_PARAM_MOST, SHARE_BEYOND = 1e-4, 1e-6, 1e-4
TOL_MOMENTS = 1e-4
#: bf16 amp against the reference's program under ``pt.amp.enable`` on
#: XLA's CPU.  Both round every matmul output, residual sum, layer-norm
#: output and gelu to bf16 (a relative step of 2^-8 = 3.9e-3), in other
#: orders and not always at the same points (XLA keeps some fused chains
#: in f32), so single roundings differ by a bf16 step.  Measured over the
#: 8 programs: the losses within 2.4e-4 relative, the step-1 gradients
#: within 1.7% per tensor (norm).
TOL_AMP_LOSS = 3e-3
TOL_AMP_GRAD = 0.06
#: Adam moves an element by at most lr a step (by about lr sign(g) where
#: |g| >> eps), so where the two sides' bf16 gradients differ in sign an
#: element can end up 2 lr apart a step: 2 steps bound it by 4 lr
#: (measured worst 3.9e-3: an element whose gradients flip sign at both
#: steps).  All but 5% of the elements stay within half of one step's lr
#: (measured: all but 0.19%).
TOL_AMP_PARAM = 2 * STEPS * LR
TOL_AMP_PARAM_MOST, AMP_SHARE_BEYOND = 0.5 * LR, 5e-2
#: the op types that draw a dropout seed in the reference's forward
DROPOUT_OPS = ("dropout", "dropout_add", "fused_attention",
               "fused_qkv_attention")
#: route -> (use_flash, FLAGS_fused_qkv_attention, attention_fuse)
ROUTES = {"composed": (False, True, False), "fused": (False, True, True),
          "flash_qkv": (True, True, False), "flash_bthd": (True, False, False)}
#: the attention op each route leaves in the reference's program
ROUTE_OPS = {"composed": "softmax", "fused": "fused_attention",
             "flash_qkv": "fused_qkv_attention",
             "flash_bthd": "fused_attention"}


def _batch():
    """make_batch's arrays with lane 1 padded from position 25 (input mask
    and label weights 0), so the attention bias matters."""
    batch = jax_bert.make_batch(BATCH, WIDTHS["seq_len"],
                                WIDTHS["vocab_size"],
                                np.random.RandomState(0))
    batch["input_mask"][1, 25:] = 0.0
    batch["mask_weights"][1, 25:] = 0.0
    return batch


class _Reference:
    """The reference's program on one route and rate, its startup
    parameters, and each step's loss, step 1's gradients, and the
    parameters and Adam state after the last step."""

    def __init__(self, route, rate, amp=False):
        use_flash, flag, fuse = ROUTES[route]
        if not flag:
            FLAGS.set("fused_qkv_attention", False)
        try:
            self.prog, startup = pt.Program(), pt.Program()
            with pt.program_guard(self.prog, startup):
                with pt.core.framework.guard_unique_name():
                    avg_loss, _ = jax_bert.build_pretrain_net(
                        **WIDTHS, dropout_rate=rate, use_flash=use_flash,
                        with_optimizer=False)
                    self.fused = (passes.apply_pass("attention_fuse",
                                                    self.prog)
                                  if fuse else None)
                    _, params_grads = pt.optimizer.Adam(
                        learning_rate=LR).minimize(avg_loss)
        finally:
            FLAGS.reset("fused_qkv_attention")
        if amp:
            pt.amp.enable(self.prog)
        ops = self.prog.global_block().ops
        types = [op.type for op in ops]
        n = WIDTHS["n_layer"]
        assert types.count(ROUTE_OPS[route]) == n
        if route == "fused":
            assert all(op.attrs["fmt"] == "bhtd" for op in ops
                       if op.type == "fused_attention")
        # the forward's seed-drawing ops, in op order
        self.rng_ids = [op.attrs["rng_id"] for op in ops
                        if op.type in DROPOUT_OPS and rate]
        assert len(self.rng_ids) == (1 + 3 * n if rate else 0)
        self.trained = [p.name for p, g in params_grads if g is not None]
        self.names = [name for name, _ in bert_param_names(n)]
        self.scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=self.scope)
        self.start = self.snapshot(self.names)
        self.accumulators = [v.name for v in self.prog.list_vars()
                             if v.persistable and ("_pow_acc" in v.name
                                                   or "_moment" in v.name)]
        self.losses, self.seeds = [], []
        # one fetch list for every step: one compiled step
        fetch = [avg_loss.name] + [f"{name}@GRAD" for name in self.trained]
        for step in range(STEPS):
            if rate:
                run_id = 11 + step
                exe._forced_run_id = run_id
                key = jax.random.fold_in(
                    prng_key(self.prog.random_seed or 0), run_id)
                self.seeds.append(dropout_seeds(
                    np.asarray(jax.random.key_data(key)),
                    sorted(self.rng_ids)))
            out = exe.run(self.prog, feed=_batch(), fetch_list=fetch,
                          scope=self.scope)
            self.losses.append(float(np.asarray(out[0])))
            if step == 0:
                self.grads = {name: np.asarray(g)
                              for name, g in zip(self.trained, out[1:])}
        self.after = self.snapshot(self.names + self.accumulators)

    def snapshot(self, names):
        return {n: np.array(self.scope.find_var(n)) for n in names}


@functools.lru_cache(maxsize=None)
def _reference(route, rate, amp=False):
    return _Reference(route, rate, amp)


def _port(route, rate, params):
    use_flash, flag, fuse = ROUTES[route]
    model = BertPretrain(**WIDTHS, dropout_rate=rate, use_flash=use_flash,
                         fused_qkv_attention=flag, device="cpu")
    load_paddle_tpu_bert_params(model, params)
    if fuse:
        assert attention_fuse(model) == WIDTHS["n_layer"]
    return model


def _feed():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _rel(got, want):
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


def test_make_batch_is_the_reference_batch():
    want = jax_bert.make_batch(BATCH, 32, 1000, np.random.RandomState(0))
    got = make_bert_batch(BATCH, 32, 1000, np.random.RandomState(0))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_param_names_are_the_reference_scope():
    """The 27 names of 2 layers are the reference's parameters in its draw
    order, with the reference's shapes, and the same on every route."""
    ref = _reference("composed", 0.0)
    params = [p.name for p in ref.prog.global_block().all_parameters()]
    assert len(ref.names) == 27 and ref.names == params
    model = _port("composed", 0.0, ref.start)
    for name, p in model.paddle_tpu_named_parameters():
        assert tuple(p.shape) == ref.start[name].shape, name
    assert sorted(ref.trained) == sorted(ref.names)
    for route in ROUTES:
        assert [n for n, _ in _port(route, 0.0, ref.start)
                .paddle_tpu_named_parameters()] == ref.names


def test_attention_fuse_counts_as_the_reference():
    """The port's pass switches as many sites as the reference's rewrites
    (n_layer) and a second call switches none, in the reference too; it
    leaves the flash routes alone, which the reference's pattern does not
    match either."""
    ref = _reference("fused", RATE)
    assert ref.fused == WIDTHS["n_layer"]
    assert passes.apply_pass("attention_fuse", ref.prog) == 0
    model = _port("fused", RATE, ref.start)
    assert attention_fuse(model) == 0
    assert attention_fuse(_port("flash_qkv", RATE, ref.start)) == 0


def test_dropout_sites_follow_the_reference_rng_ids():
    """Each route's sites in the order of the reference's ids: after the
    pass the two fused attention sites drew theirs last, by layer."""
    n = WIDTHS["n_layer"]
    in_order = ["emb_dropout"] + [f"layers.{i}.{s}" for i in range(n) for s
                                  in ("attn", "attn_dropout_add",
                                      "ffn_dropout_add")]
    for route in ROUTES:
        ref = _reference(route, RATE)
        sites = _port(route, RATE, ref.start).dropout_sites()
        assert sorted(sites) == sorted(in_order)
        # op order and id order agree except for the fused sites
        by_id = [in_order[ref.rng_ids.index(r)] for r in sorted(ref.rng_ids)]
        assert sites == by_id, route
    assert _port("fused", RATE, ref.start).dropout_sites()[-n:] == [
        f"layers.{i}.attn" for i in range(n)]


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("route", list(ROUTES))
def test_two_adam_steps_match_reference(route, rate):
    """Each step's loss within 1e-5 relative; every parameter's step-1
    gradient within TOL_GRAD relative (norm); the parameters after 2
    steps within TOL_PARAM (TOL_PARAM_MOST for all but SHARE_BEYOND of the
    elements) and each Adam accumulator within TOL_MOMENTS relative.  Under
    dropout each step takes the reference step's seeds."""
    ref = _reference(route, rate)
    model = _port(route, rate, ref.start)
    opt = Adam(model.parameters(), learning_rate=LR)
    params = dict(model.paddle_tpu_named_parameters())
    for step in range(STEPS):
        seeds = ref.seeds[step] if rate else None
        loss, enc = model(**_feed(), dropout_seeds=seeds)
        assert enc.shape == (BATCH, WIDTHS["seq_len"], WIDTHS["d_model"])
        want = ref.losses[step]
        assert abs(loss.item() - want) <= TOL_LOSS * abs(want), (
            step, loss.item(), want)
        params_grads = opt.minimize(loss)
        if step == 0:
            got = {p: g for p, g in params_grads}
            assert len(got) == len(ref.trained)
            for name in ref.trained:
                assert _rel(got[params[name]], ref.grads[name]) <= TOL_GRAD, \
                    name
    exported = export_paddle_tpu_bert_params(model)
    beyond = total = 0
    for name, got in exported.items():
        want = ref.after[name]
        np.testing.assert_allclose(got, want, atol=TOL_PARAM, rtol=0,
                                   err_msg=name)
        beyond += int((np.abs(got - want) > TOL_PARAM_MOST).sum())
        total += got.size
    assert beyond <= SHARE_BEYOND * total, (beyond, total)
    state = export_paddle_tpu_adam_state(opt, model)
    assert len(state) == len(ref.accumulators) == 4 * len(ref.trained)
    for name, got in state.items():
        want = ref.after[name]
        assert _rel(got.reshape(want.shape), want) <= TOL_MOMENTS, name


def test_routes_agree_at_rate_0():
    """On the same weights and batch the fused route (#5, #8, #9's twins)
    and the hand-written composition give the same loss (1e-6 relative)
    and step-1 gradients (1e-5 relative, per tensor), as do the flash
    routes: the reference's routes compute one function."""
    ref = _reference("composed", 0.0)
    results = []
    for route in ROUTES:
        model = _port(route, 0.0, ref.start)
        loss, _ = model(**_feed())
        loss.backward()
        results.append((loss.item(), {n: p.grad.numpy() for n, p in
                                      model.named_parameters()}))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
        for n, g in grads.items():
            assert _rel(g, base_grads[n]) <= 1e-5, n


def test_dropout_trains_and_eval_turns_it_off():
    """In training mode the rate-0.1 loss has a backward and moves off the
    undropped loss; a wrong number of seeds raises; ``eval()`` gives the
    undropped loss; a float64 copy trains through the plain path in
    float64 (the exact step chip_smoke.py holds the card against), the
    f32 gradients within TOL_GRAD of it."""
    ref = _reference("fused", 0.0)
    plain, _ = _port("fused", 0.0, ref.start)(**_feed())
    model = _port("fused", RATE, ref.start)
    dropped, _ = model(**_feed(), generator=torch.Generator().manual_seed(0))
    assert dropped.grad_fn is not None and torch.isfinite(dropped)
    assert abs(dropped.item() - plain.item()) > 1e-4
    with pytest.raises(ValueError, match="dropout seeds"):
        model(**_feed(), dropout_seeds=[1, 2, 3])
    model.eval()
    with torch.no_grad():
        assert abs(model(**_feed())[0].item() - plain.item()) <= 1e-6 * abs(
            plain.item())
    exact = _port("fused", RATE, ref.start).double()
    seeds = list(range(1, 8))
    grads = []
    for m in (_port("fused", RATE, ref.start), exact):
        loss, _ = m(**_feed(), dropout_seeds=seeds)
        loss.backward()
        assert loss.dtype == next(m.parameters()).dtype
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        assert _rel(g.double().numpy(), grads[1][n].numpy()) <= TOL_GRAD, n


# ---------------------------------------------------------------------------
# bf16 amp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("route", list(ROUTES))
def test_amp_two_adam_steps_match_reference(route, rate):
    """Each route under ``amp.enable`` against the reference's program under
    ``pt.amp.enable`` (the fused route after its ``attention_fuse``), each
    step under the reference step's seeds: the encoder output bf16 and the
    loss f32, each loss within TOL_AMP_LOSS, every step-1 gradient f32 and
    within TOL_AMP_GRAD (norm), the parameters after 2 steps within
    TOL_AMP_PARAM (all but AMP_SHARE_BEYOND of them within
    TOL_AMP_PARAM_MOST); the amp step is not the f32 one."""
    ref = _reference(route, rate, amp=True)
    model = _port(route, rate, ref.start)
    amp.enable(model)
    opt = Adam(model.parameters(), learning_rate=LR)
    params = dict(model.paddle_tpu_named_parameters())
    for step in range(STEPS):
        seeds = ref.seeds[step] if rate else None
        loss, enc = model(**_feed(), dropout_seeds=seeds)
        assert enc.dtype == torch.bfloat16 and loss.dtype == torch.float32
        want = ref.losses[step]
        assert abs(loss.item() - want) <= TOL_AMP_LOSS * abs(want), (
            step, loss.item(), want)
        if step == 0:
            f32, _ = _port(route, rate, ref.start)(**_feed(),
                                                  dropout_seeds=seeds)
            assert f32.item() != loss.item()
        params_grads = opt.minimize(loss)
        if step == 0:
            got = {p: g for p, g in params_grads}
            assert len(got) == len(ref.trained)
            for name in ref.trained:
                p = params[name]
                assert p.dtype == got[p].dtype == torch.float32, name
                assert _rel(got[p], ref.grads[name]) <= TOL_AMP_GRAD, name
    exported = export_paddle_tpu_bert_params(model)
    beyond = total = 0
    for name, got in exported.items():
        want = ref.after[name]
        np.testing.assert_allclose(got, want, atol=TOL_AMP_PARAM, rtol=0,
                                   err_msg=name)
        beyond += int((np.abs(got - want) > TOL_AMP_PARAM_MOST).sum())
        total += got.size
    assert beyond <= AMP_SHARE_BEYOND * total, (beyond, total)


def test_hand_written_attention_takes_the_reference_policy(monkeypatch):
    """The hand-written attention under amp, op by op: each op's inputs as
    the port casts them are the reference's ``apply_cast_policy`` of the
    same op on the same input dtypes, in the reference's op order (the
    qkv ``mul``, ``matmul(q, k^T)``, the bias ``elementwise_add``,
    ``softmax``, ``matmul`` with v, the output ``mul``): both matmuls take
    bf16 (the f32 weights cast down), the f32 bias is cast down to the
    bf16 product, softmax runs in f32, and the output is bf16."""
    import jax.numpy as jnp

    from paddle_tpu import amp as ref_amp
    from paddle_tpu_torch.models.transformer import MultiHeadAttention

    calls = []
    cast = amp.cast

    def recording(op, *tensors):
        out = cast(op, *tensors)
        calls.append((op, [t.dtype for t in tensors],
                      [t.dtype for t in out]))
        return out

    monkeypatch.setattr(amp, "cast", recording)
    d_model, n_head, t = 64, 2, 8
    site = MultiHeadAttention(d_model, n_head, d_model // n_head, "cpu")
    gen = torch.Generator().manual_seed(0)
    for p in site.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.1
    x = torch.randn(2, t, d_model, generator=gen).bfloat16()
    bias = torch.zeros(2, 1, 1, t)
    bias[1, ..., t - 2:] = -1e9
    holder = torch.nn.Module()
    amp.enable(holder)
    with amp.policy_scope(holder):
        out = site(x, bias)
    assert out.dtype == torch.bfloat16
    assert [op for op, _, _ in calls] == [
        "mul", "matmul", "elementwise_add", "softmax", "matmul", "mul"]
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for op, ins, outs in calls:
        want = ref_amp.apply_cast_policy(
            op, {i: [jnp.zeros((1,), jdtype[d])] for i, d in enumerate(ins)})
        assert outs == [torch.bfloat16 if want[i][0].dtype == jnp.bfloat16
                        else torch.float32 for i in range(len(ins))], op
    # the f32 bias cast down to the bf16 product
    assert calls[2][1:] == ([torch.bfloat16, torch.float32],
                            [torch.bfloat16] * 2)
    assert calls[3][2] == [torch.float32]  # softmax in f32
    # the f32 weights cast down for the product with v
    assert calls[4][1:] == ([torch.float32, torch.bfloat16],
                            [torch.bfloat16] * 2)


def test_gelu_bf16_follows_reference_arithmetic():
    """``gelu`` on bf16 against the reference's (``jax.nn.gelu`` with
    approximate=False, jitted on XLA's CPU) on every finite bf16 input:
    the same bits, except where XLA flushes a subnormal intermediate to
    zero and returns +-0 for a result below 2^-123 in magnitude.
    ``F.gelu`` in bf16 (f32 arithmetic, one rounding) is not the
    reference's: it differs on over a thousand inputs; f32 inputs keep
    ``F.gelu``."""
    import jax.numpy as jnp
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.nn_ops import gelu

    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    want = np.asarray(jax.jit(lambda a: jax.nn.gelu(a, approximate=False))(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)).astype(
            jnp.float32))
    got = gelu(x)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert (~same).sum() < 600
    assert (want[~same] == 0).all()
    assert (np.abs(got[~same]) < 2.0 ** -123).all()
    lib = F.gelu(x, approximate="none").float().numpy()
    assert ((lib != want) & ~np.isnan(want)).sum() > 1000
    x32 = torch.linspace(-6, 6, 101)
    assert torch.equal(gelu(x32), F.gelu(x32, approximate="none"))
