"""Carry flax weights into a port model's state dict.

``from_flax(params, batch_stats)`` takes the two variable trees that
vtpu.models.train.init_model returns (nested dicts of arrays, converted to
numpy by the caller) and returns a ``state_dict`` for the port model of the
same architecture: module paths join with ".", and each leaf maps by name:

- Conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw];
- Dense ``kernel`` [in, out] -> ``weight`` [out, in]; ``bias`` -> ``bias``;
- BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``, and from
  ``batch_stats`` ``mean`` -> ``running_mean``, ``var`` -> ``running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
