"""Carry flax weights into a port model's state dict.

``from_flax(params, batch_stats)`` takes the two variable trees that
vtpu.models.train.init_model returns (nested dicts of arrays, converted to
numpy by the caller) and returns a ``state_dict`` for the port model of the
same architecture: module paths join with ".", and each leaf maps by name:

- Conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw];
- Dense ``kernel`` [in, out] -> ``weight`` [out, in]; ``bias`` -> ``bias``;
- BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``, and from
  ``batch_stats`` ``mean`` -> ``running_mean``, ``var`` -> ``running_var``.

Every model of the registry carries across by this map alone: VGG's
``fc1`` rows are in flax's (h, w, c) order because the port flattens NHWC
(models/vgg.py), and the LSTM's scan-lifted cells broadcast their
parameters over time, so ``lstm{i}/gates`` is one Dense kernel and bias.

``serving_params_from_jax(w1, b1, w2)`` carries the serving MLP's weights
(vtpu/models/serving.py) into the port's ``ShardedServingModel``.

``momentum_from_optax(opt_state, model)`` carries the momentum of
``optax.sgd(lr, momentum)`` (the ``trace`` of its TraceState, a tree shaped
like the parameters) across with the same map, and
``momentum_to_optax(optimizer, model)`` takes a torch optimizer's momentum
buffers the other way, into a trace tree of numpy arrays in flax's layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix: str, leaf_fn, out: Dict[str, torch.Tensor]):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, _key(prefix, name), leaf_fn, out)
        else:
            key, arr = leaf_fn(prefix, name, np.asarray(value))
            out[key] = torch.from_numpy(np.array(arr, order="C"))


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _param(prefix: str, name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 4:
            return _key(prefix, "weight"), arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return _key(prefix, "weight"), arr.T
        raise ValueError(f"{prefix}.kernel: unsupported rank {arr.ndim}")
    if name == "scale":
        return _key(prefix, "weight"), arr
    if name == "bias":
        return _key(prefix, "bias"), arr
    raise ValueError(f"{_key(prefix, name)}: unknown flax parameter")


def _stat(prefix: str, name: str, arr: np.ndarray):
    if name not in _STAT_NAMES:
        raise ValueError(f"{_key(prefix, name)}: unknown batch statistic")
    return _key(prefix, _STAT_NAMES[name]), arr


def from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str,
                                                             torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", _param, out)
    _walk(batch_stats or {}, "", _stat, out)
    return out


def _trace_of(opt_state) -> Any:
    """The ``trace`` tree inside an optax state (TraceState, alone or in the
    tuple of a chain), or None."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            trace = _trace_of(sub)
            if trace is not None:
                return trace
    return None


def momentum_from_optax(opt_state, model: torch.nn.Module) -> Dict[
        str, torch.Tensor]:
    """Momentum of an ``optax.sgd(..., momentum=m)`` state by the port
    model's parameter names, in torch's layout."""
    trace = _trace_of(opt_state)
    if trace is None:
        raise ValueError("the optax state holds no momentum trace")
    out: Dict[str, torch.Tensor] = {}
    _walk(trace, "", _param, out)
    names = {name for name, _ in model.named_parameters()}
    if set(out) != names:
        raise ValueError(f"trace leaves {sorted(set(out) ^ names)} do not "
                         f"match the model's parameters")
    return out


def _flax_leaf(name: str, arr: np.ndarray):
    """(flax leaf name, array in flax's layout) of a torch parameter."""
    if name == "bias":
        return "bias", arr
    if name != "weight":
        raise ValueError(f"{name}: unknown torch parameter")
    if arr.ndim == 4:
        return "kernel", arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:
        return "kernel", arr.T
    return "scale", arr


def momentum_to_optax(optimizer: torch.optim.Optimizer,
                      model: torch.nn.Module) -> Dict[str, Any]:
    """The optimizer's momentum buffers as a flax-layout trace tree of numpy
    arrays (zeros where a buffer is not made yet, as optax's init)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        buf = torch.zeros_like(p) if buf is None else buf
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        key, arr = _flax_leaf(leaf, buf.detach().float().cpu().numpy())
        node[key] = np.ascontiguousarray(arr)
    return tree


def serving_params_from_jax(w1, b1, w2) -> Tuple[torch.Tensor, ...]:
    """The serving MLP's full weights (``vtpu/models/serving.py``
    ``_full_params()``: W1 [dim, hidden], b1 [hidden], W2 [hidden,
    classes], numpy in) as f32 host tensors in the same layout: the
    port's matmuls take ``x @ W1`` as the reference's do, so nothing is
    transposed. Load them with ``ShardedServingModel.setup(params=...)``
    (each member takes its own slice) or ``reference_logits(...,
    params=...)``."""
    return tuple(torch.from_numpy(np.array(a, dtype=np.float32))
                 for a in (w1, b1, w2))
