"""paddle_tpu_torch f32 training at head width 128, on the CPU, against the
JAX package.

The reference launches its fused (#1-#3) and flash (#4-#9) kernels at any
d_head % 64 == 0, and the port compiles their f32 instantiations for 128
(``kernels.HEAD_WIDTHS``).  The kernels' twins at 128 are held against
the reference's interpret-mode kernels in ``test_torch_flash_attention.py``
and ``test_torch_qkv_attention.py``; here the whole slice: a 2 + 2-layer
Transformer of 2 heads of 128 (d_model 256, ``test_torch_head128_amp``'s
WIDTHS_128) in f32 at dropout 0.1, its weights carried across by
``load_paddle_tpu_params``, takes 3 Adam steps on each attention route
(the default fused one: #1-#3 at the self-attention sites, #4, #6, #7 at
the cross sites; ``fused_qkv_attention=False``: #4, #6, #7 at every site)
against the reference's f32 program, each step under the reference step's
dropout seeds, held by ``test_torch_training``'s bounds for the 64-wide
model but the share of parameters past TOL_PARAM_MOST (SHARE_BEYOND_128).
The CUDA kernels are held against the same twins on the card by
chip_smoke.py (phase 2's ``check_head128_train_kernels`` in f32, phase 3
(o)).
"""

import pytest

import test_torch_training as tt
from test_torch_head128_amp import widths_128  # noqa: F401 (a fixture)

#: After 3 Adam steps all but a share of the parameters must sit within
#: TOL_PARAM_MOST (1e-6) of the reference's: Adam's first steps turn last-
#: bit gradient differences into a fraction of lr where |g| is near 0
#: (test_torch_training's TOL_PARAM), and at these widths more elements
#: do.  Measured against a float64 run of the same 3 steps (the port's
#: flag-off route): the reference's own f32 parameters 245 (flag-off
#: program) and 252 (fused) of 2,695,232 elements beyond 1e-6 (9.1e-5,
#: 9.4e-5), the port's 289 on either route (1.07e-4), every one within
#: TOL_PARAM (the worst 3.9e-5 and 2.8e-5); the port and the reference 295
#: apart on the flag-off route (1.09e-4) and 306 on the fused one
#: (1.14e-4), with step-1 gradients within 1.3e-6 of each other (norm).
#: Two f32 runs each about 1e-4 off float64 in their own elements: 1.3
#: times test_torch_training's SHARE_BEYOND (350 elements), just above the
#: worst route's 306.
SHARE_BEYOND_128 = 1.3 * tt.SHARE_BEYOND


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused", "flag_off"])
def ref_dropout_128(request, widths_128):  # noqa: F811
    """The reference's f32 dropout program at WIDTHS_128 on the default
    route (``fused``) or with ``FLAGS_fused_qkv_attention`` off."""
    return request.param, tt._Reference(fused=request.param,
                                        dropout_rate=tt.DROPOUT)


def test_f32_three_adam_steps_at_128_match_reference(ref_dropout_128,
                                                     monkeypatch):
    """Each step's loss within TOL_LOSS relative, every trained parameter's
    step-1 gradient within TOL_GRAD relative (norm), the parameters after
    3 steps within TOL_PARAM (all but SHARE_BEYOND_128 within
    TOL_PARAM_MOST), the position tables unmoved: the embedding dropout,
    the dropout-adds and every attention site's weights dropout under the
    reference's masks, bit for bit."""
    fused, ref = ref_dropout_128
    monkeypatch.setattr(tt, "SHARE_BEYOND", SHARE_BEYOND_128)
    assert tt.WIDTHS["d_key"] == tt.WIDTHS["d_value"] == 128
    tt._three_adam_steps(ref, fused_qkv_attention=fused,
                         dropout_rate=tt.DROPOUT)
