"""Weights and Adam state to and from the JAX package's scopes.

The reference names its parameters through ``unique_name`` draws.  The
generation programs (``build_generation_programs``) and the training
program (``transformer(...)`` + ``Adam.minimize``) draw the same names in
different orders, so one map serves both:
:func:`~paddle_tpu_torch.models.transformer.paddle_tpu_param_names`
lists each name with the attribute of the port's
:class:`~paddle_tpu_torch.models.transformer.Transformer` it fills.
:func:`load_paddle_tpu_params` and :func:`export_paddle_tpu_params` carry
the weights; :func:`load_paddle_tpu_adam_state` and
:func:`export_paddle_tpu_adam_state` carry the port's
:class:`~paddle_tpu_torch.optimizer.Adam` state under the names the
reference's optimizer gives its accumulators, ``<param>_moment1_0`` and
the like (``paddle_tpu/optimizer.py`` ``_add_accumulator``).
:func:`dropout_seeds` turns a reference step's key and its program's
dropout ``rng_id``s into the seeds of ``Transformer.forward``.

ResNet has maps of its own.  :func:`resnet_param_names` lists the
persistable names ``build_train_net`` draws (``conv2d_<i>.w_0``,
``batch_norm_<i>.{w_0,b_0,mean_0,var_0}``, ``fc_0.{w_0,b_0}``) with the
parameter or running-statistic buffer of the port's
:class:`~paddle_tpu_torch.models.resnet.ResNet` each fills;
:func:`load_paddle_tpu_resnet_params` and
:func:`export_paddle_tpu_resnet_params` carry the parameters and the
running statistics, and :func:`load_paddle_tpu_momentum_state` the
:class:`~paddle_tpu_torch.optimizer.Momentum` velocities,
``<param>_velocity_0``.

BERT's names come from :func:`~paddle_tpu_torch.models.bert.
bert_param_names` (the same on every attention route):
:func:`load_paddle_tpu_bert_params` and
:func:`export_paddle_tpu_bert_params` carry them, and the Adam state
functions the optimizer's state.

DeepFM's parameters carry the reference's names as they are
(``deepfm_emb_<i>``, ``deepfm_w1_<i>``, ``deepfm_fc<i>_w`` ...):
:func:`load_paddle_tpu_deepfm_params` and
:func:`export_paddle_tpu_deepfm_params` carry them, and the Adam state
functions above its lazy-Adam state, per table ``<table>_moment1_0``,
``<table>_moment2_0``, ``<table>_beta1_pow_acc_0`` and
``<table>_beta2_pow_acc_0``.  The Adam state functions read the names from
the model's ``paddle_tpu_named_parameters()``.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.hash_rng import seed_from_key_data
from .models.bert import bert_param_names  # noqa: F401
from .models.resnet import DEPTHS
from .models.transformer import paddle_tpu_param_names  # noqa: F401


@torch.no_grad()
def _load_pairs(model, pairs, params, what):
    """Copy ``params[name]`` into ``model``'s parameter at ``path`` for
    every (name, path) of ``pairs``; raises on a missing name or a shape
    that differs."""
    missing = [name for name, _ in pairs if name not in params]
    if missing:
        raise KeyError(f"{what}: missing {missing}")
    for name, path in pairs:
        value = torch.from_numpy(np.array(params[name], np.float32))
        target = model.get_parameter(path)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{what}: {name} has shape {tuple(value.shape)}, {path} "
                f"wants {tuple(target.shape)}")
        target.copy_(value)
    return model


def _export_pairs(model, pairs):
    return {name: model.get_parameter(path).detach().cpu().numpy().copy()
            for name, path in pairs}


def load_paddle_tpu_params(model, params):
    """Fill ``model`` from ``params``, a ``{name: array}`` mapping as a
    JAX scope of the reference holds it.  Raises on a missing name or a
    shape that differs; returns the model."""
    return _load_pairs(model, paddle_tpu_param_names(model.n_layer), params,
                       "load_paddle_tpu_params")


def export_paddle_tpu_params(model):
    """{reference parameter name: f32 numpy array} of ``model``'s weights,
    which :func:`load_paddle_tpu_params` (or a reference scope) takes."""
    return _export_pairs(model, paddle_tpu_param_names(model.n_layer))


def load_paddle_tpu_bert_params(model, params):
    """Fill ``model`` (a BertPretrain) from ``params``, ``{name: array}``
    as the reference's scope holds ``build_pretrain_net``'s parameters
    (:func:`bert_param_names`).  Raises on a missing name or a shape that
    differs; returns the model."""
    return _load_pairs(model, bert_param_names(model.n_layer), params,
                       "load_paddle_tpu_bert_params")


def export_paddle_tpu_bert_params(model):
    """{reference parameter name: f32 numpy array} of a BertPretrain's
    weights, which :func:`load_paddle_tpu_bert_params` (or a reference
    scope) takes."""
    return _export_pairs(model, bert_param_names(model.n_layer))


#: the reference's Adam accumulators, in the order it creates them
ADAM_ACCUMULATORS = ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")


def _adam_pairs(optimizer, model):
    """[(reference accumulator name, state tensor)] of every parameter
    ``optimizer`` trains, by the names of ``model.paddle_tpu_named_
    parameters()``."""
    pairs = []
    for name, param in model.paddle_tpu_named_parameters():
        state = optimizer.state.get(param)
        if state is not None:
            pairs += [(f"{name}_{acc}_0", state[acc])
                      for acc in ADAM_ACCUMULATORS]
    return pairs


@torch.no_grad()
def load_paddle_tpu_adam_state(optimizer, model, state):
    """Fill the Adam state of ``optimizer`` (training the parameters of
    ``model``, a Transformer, a BertPretrain or a DeepFM) from ``state``,
    a ``{name: array}`` mapping as the reference's scope holds its
    accumulators.  Raises on a missing name or a shape that differs;
    returns the optimizer."""
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


def dropout_seeds(key_data, rng_ids):
    """The uint32 seeds of one training step of a reference program: one
    per dropout site, ``seed_from_key(base_key, rng_id)`` as the reference
    derives it (``ops/nn_ops.py`` ``_dropout_keep_mask``,
    ``lower_dropout_add``; ``ops/fused_ops.py`` ``_attn_dropout_seed``).

    key_data: the uint32 data of the step's base key
    (``jax.random.key_data(fold_in(prng_key(program.random_seed),
    run_id))``, as a numpy array).  rng_ids: the ``rng_id`` attributes of
    the program's ``dropout``, ``dropout_add``, ``fused_attention`` and
    ``fused_qkv_attention`` ops in op order, which for ``transformer()``
    is the order of ``Transformer.dropout_sites()``; for
    ``build_pretrain_net`` ``BertPretrain.dropout_sites()`` follows the
    ids' order (``sorted(rng_ids)``), which differs from the op order
    after ``attention_fuse``.  Numpy only."""
    return [seed_from_key_data(key_data, r or 1) for r in rng_ids]


def resnet_param_names(depth: int):
    """[(reference name, port path)] of ResNet-``depth``'s parameters and
    running statistics, in the order ``build_train_net`` draws them: per
    ``conv_bn_layer`` its filter, the batch norm's scale and bias and its
    running mean and variance; in the first block of a stage whose width
    changes the shortcut's layer comes before conv1 (``basicblock``,
    ``bottleneck``); the fc last."""
    stages, kind = DEPTHS[depth]
    expansion = 4 if kind == "bottleneck" else 1
    convs = ["conv2", "conv3"] if kind == "bottleneck" else ["conv2"]
    paths, ch_in = ["conv1"], 64
    for i, (count, width) in enumerate(zip(stages, (64, 128, 256, 512))):
        for j in range(count):
            block = f"stages.{i}.{j}."
            if j == 0 and ch_in != width * expansion:
                paths.append(block + "shortcut")
            paths += [block + c for c in ["conv1"] + convs]
        ch_in = width * expansion
    pairs = []
    for i, path in enumerate(paths):
        pairs += [(f"conv2d_{i}.w_0", f"{path}.weight"),
                  (f"batch_norm_{i}.w_0", f"{path}.scale"),
                  (f"batch_norm_{i}.b_0", f"{path}.bias"),
                  (f"batch_norm_{i}.mean_0", f"{path}.mean"),
                  (f"batch_norm_{i}.var_0", f"{path}.var")]
    return pairs + [("fc_0.w_0", "fc_w"), ("fc_0.b_0", "fc_b")]


def _resnet_tensor(model, path):
    """The parameter or buffer of ``model`` at ``path``."""
    params = dict(model.named_parameters())
    return params[path] if path in params else model.get_buffer(path)


@torch.no_grad()
def load_paddle_tpu_resnet_params(model, params):
    """Fill ``model`` (a ResNet) from ``params``, a ``{name: array}``
    mapping as the reference's scope holds it: every parameter and running
    statistic of :func:`resnet_param_names`.  Raises on a missing name or
    a shape that differs; returns the model."""
    pairs = resnet_param_names(model.depth)
    missing = [name for name, _ in pairs if name not in params]
    if missing:
        raise KeyError(f"load_paddle_tpu_resnet_params: missing {missing}")
    for name, path in pairs:
        value = torch.from_numpy(np.array(params[name], np.float32))
        target = _resnet_tensor(model, path)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"load_paddle_tpu_resnet_params: {name} has shape "
                f"{tuple(value.shape)}, {path} wants {tuple(target.shape)}")
        target.copy_(value)
    return model


def export_paddle_tpu_resnet_params(model):
    """{reference name: f32 numpy array} of ``model``'s parameters and
    running statistics, which :func:`load_paddle_tpu_resnet_params` (or
    a reference scope) takes."""
    return {name: _resnet_tensor(model, path).detach().cpu().numpy().copy()
            for name, path in resnet_param_names(model.depth)}


@torch.no_grad()
def load_paddle_tpu_momentum_state(optimizer, model, state):
    """Fill the velocities of ``optimizer`` (a Momentum training the
    ResNet ``model``) from ``state``, ``{name: array}`` as the reference's
    scope holds its ``<param>_velocity_0`` accumulators.  Raises on a
    missing name or a shape that differs; returns the optimizer."""
    pairs = []
    for name, path in resnet_param_names(model.depth):
        st = optimizer.state.get(_resnet_tensor(model, path))
        if st is not None:
            pairs.append((f"{name}_velocity_0", st["velocity"]))
    missing = [name for name, _ in pairs if name not in state]
    if missing:
        raise KeyError(f"load_paddle_tpu_momentum_state: missing {missing}")
    for name, target in pairs:
        value = torch.from_numpy(np.array(state[name], np.float32))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"load_paddle_tpu_momentum_state: {name} has shape "
                f"{tuple(value.shape)}, the port's is {tuple(target.shape)}")
        target.copy_(value)
    return optimizer


def load_paddle_tpu_deepfm_params(model, params):
    """Fill ``model`` (a DeepFM) from ``params``, ``{name: array}`` as the
    reference's scope holds ``build_train_net``'s parameters (the port's
    parameter names are the reference's).  Raises on a missing name or a
    shape that differs; returns the model."""
    return _load_pairs(model, [(n, n) for n, _ in model.named_parameters()],
                       params, "load_paddle_tpu_deepfm_params")


def export_paddle_tpu_deepfm_params(model):
    """{reference name: f32 numpy array} of a DeepFM's parameters, which
    :func:`load_paddle_tpu_deepfm_params` (or a reference scope) takes."""
    return _export_pairs(model, [(n, n) for n, _ in
                                 model.named_parameters()])
