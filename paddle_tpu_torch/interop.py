"""Weights and Adam state to and from the JAX package's scopes.

The reference names its parameters through ``unique_name`` draws.  The
generation programs (``build_generation_programs``) and the training
program (``transformer(...)`` + ``Adam.minimize``) draw the same names in
different orders, so one map serves both: :func:`paddle_tpu_param_names`
lists each name with the attribute of the port's
:class:`~paddle_tpu_torch.models.transformer.Transformer` it fills.
:func:`load_paddle_tpu_params` and :func:`export_paddle_tpu_params` carry
the weights; :func:`load_paddle_tpu_adam_state` and
:func:`export_paddle_tpu_adam_state` carry the port's
:class:`~paddle_tpu_torch.optimizer.Adam` state under the names the
reference's optimizer gives its accumulators, ``<param>_moment1_0`` and
the like (``paddle_tpu/optimizer.py`` ``_add_accumulator``).
"""

from __future__ import annotations

import numpy as np
import torch


def paddle_tpu_param_names(n_layer: int):
    """[(reference parameter name, port parameter path)] in the generation
    programs' draw order: the prefill program's, then the decode
    program's."""
    pairs = [("src_word_emb_table", "src_word_emb"),
             ("src_pos_enc_table", "src_pos_enc")]

    def ln(index, path):
        return [(f"layer_norm_{index}.w_0", f"{path}_scale"),
                (f"layer_norm_{index}.b_0", f"{path}_bias")]

    for i in range(n_layer):
        enc = f"encoder.{i}."
        pairs += [(f"attn_qkv_w_{i}", enc + "attn_qkv_w"),
                  (f"attn_out_w_{i}", enc + "attn_out_w"),
                  *ln(2 * i, enc + "ln1"),
                  (f"ffn_in_w_{i}", enc + "ffn_in_w"),
                  (f"ffn_in_b_{i}", enc + "ffn_in_b"),
                  (f"ffn_out_w_{i}", enc + "ffn_out_w"),
                  (f"ffn_out_b_{i}", enc + "ffn_out_b"),
                  *ln(2 * i + 1, enc + "ln2")]
    for i in range(n_layer):
        pairs += [(f"attn_k_w_{i}", f"decoder.{i}.cross_k_w"),
                  (f"attn_v_w_{i}", f"decoder.{i}.cross_v_w")]
    pairs += [("trg_word_emb_table", "trg_word_emb"),
              ("trg_pos_enc_table", "trg_pos_enc")]
    L = n_layer
    for i in range(n_layer):
        dec = f"decoder.{i}."
        pairs += [(f"attn_qkv_w_{L + i}", dec + "attn_qkv_w"),
                  (f"attn_out_w_{L + 2 * i}", dec + "attn_out_w"),
                  *ln(2 * L + 3 * i, dec + "ln1"),
                  (f"attn_q_w_{i}", dec + "cross_q_w"),
                  (f"attn_out_w_{L + 2 * i + 1}", dec + "cross_out_w"),
                  *ln(2 * L + 3 * i + 1, dec + "ln2"),
                  (f"ffn_in_w_{L + i}", dec + "ffn_in_w"),
                  (f"ffn_in_b_{L + i}", dec + "ffn_in_b"),
                  (f"ffn_out_w_{L + i}", dec + "ffn_out_w"),
                  (f"ffn_out_b_{L + i}", dec + "ffn_out_b"),
                  *ln(2 * L + 3 * i + 2, dec + "ln3")]
    pairs += [("predict_w", "predict_w"), ("predict_b", "predict_b")]
    return pairs


@torch.no_grad()
def load_paddle_tpu_params(model, params):
    """Fill ``model`` from ``params``, a ``{name: array}`` mapping as a
    JAX scope of the reference holds it.  Raises on a missing name or a
    shape that differs; returns the model."""
    pairs = paddle_tpu_param_names(model.n_layer)
    missing = [name for name, _ in pairs if name not in params]
    if missing:
        raise KeyError(f"load_paddle_tpu_params: missing {missing}")
    for name, path in pairs:
        value = torch.from_numpy(np.array(params[name], np.float32))
        target = model.get_parameter(path)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"load_paddle_tpu_params: {name} has shape "
                f"{tuple(value.shape)}, {path} wants "
                f"{tuple(target.shape)}")
        target.copy_(value)
    return model


def export_paddle_tpu_params(model):
    """{reference parameter name: f32 numpy array} of ``model``'s weights,
    which :func:`load_paddle_tpu_params` (or a reference scope) takes."""
    return {name: model.get_parameter(path).detach().cpu().numpy().copy()
            for name, path in paddle_tpu_param_names(model.n_layer)}


#: the reference's Adam accumulators, in the order it creates them
ADAM_ACCUMULATORS = ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")


def _adam_pairs(optimizer, model):
    """[(reference accumulator name, state tensor)] of every parameter
    ``optimizer`` trains."""
    pairs = []
    for name, path in paddle_tpu_param_names(model.n_layer):
        state = optimizer.state.get(model.get_parameter(path))
        if state is not None:
            pairs += [(f"{name}_{acc}_0", state[acc])
                      for acc in ADAM_ACCUMULATORS]
    return pairs


@torch.no_grad()
def load_paddle_tpu_adam_state(optimizer, model, state):
    """Fill the Adam state of ``optimizer`` (training ``model``'s
    parameters) from ``state``, a ``{name: array}`` mapping as the
    reference's scope holds its accumulators.  Raises on a missing name or
    a shape that differs; returns the optimizer."""
    pairs = _adam_pairs(optimizer, model)
    missing = [name for name, _ in pairs if name not in state]
    if missing:
        raise KeyError(f"load_paddle_tpu_adam_state: missing {missing}")
    for name, target in pairs:
        value = torch.from_numpy(np.array(state[name], np.float32))
        if value.numel() != target.numel():
            raise ValueError(
                f"load_paddle_tpu_adam_state: {name} has shape "
                f"{tuple(value.shape)}, the port's is {tuple(target.shape)}")
        target.copy_(value.reshape(target.shape))
    return optimizer


def export_paddle_tpu_adam_state(optimizer, model):
    """{reference accumulator name: f32 numpy array} of ``optimizer``'s
    state, under the names :func:`load_paddle_tpu_adam_state` reads."""
    return {name: t.detach().cpu().numpy().copy()
            for name, t in _adam_pairs(optimizer, model)}
