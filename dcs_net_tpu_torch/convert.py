"""Weights between the JAX package's variable tree and the port's state dict.

The JAX tree is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
arrays (module name -> ... -> leaf). The port keeps the same module names, so
a leaf's path becomes its state-dict key, with these layout changes:

=====================  ==========================  =============================
JAX leaf               port key                    layout
=====================  ==========================  =============================
conv ``kernel_r``      ``weight_r``                HWIO -> (Cout, Cin, kh, kw)
convT ``kernel_r``     ``weight_r``                HWIO -> (Cin, Cout, kh, kw)
linear ``kernel_r``    ``weight_r``                (in, out) -> (out, in)
LSTM ``w_ih_l0``       ``weight_ih_l0``            (in, 4H) -> (4H, in)
LSTM ``b_ih_l0``       ``bias_ih_l0``              unchanged
BN / bias leaves       same name                   unchanged
=====================  ==========================  =============================

(the same for ``kernel_i``, ``w_hh``, ``b_hh`` and ``_reverse`` suffixes,
and for the real family's ``kernel`` -> ``weight``, whose BN keeps
``scale`` and ``bias`` as parameters and ``mean`` and ``var`` as
statistics). A convT is any module whose name ends in ``_convt``; a linear
kernel is 2-D.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_CONV_TO_TORCH = (3, 2, 0, 1)   # (kh, kw, cin, cout) -> (cout, cin, kh, kw)
_CONV_TO_JAX = (2, 3, 1, 0)
_CONVT_PERM = (2, 3, 0, 1)      # its own inverse: (kh,kw,cin,cout) <-> (cin,cout,kh,kw)
_STAT_NAMES = ("mean_r", "mean_i", "vrr", "vii", "vri", "mean", "var")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _is_convt(path: Tuple[str, ...]) -> bool:
    return any(p.endswith("_convt") for p in path[:-1])


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> state dict for
    ``DCSNet.load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(col, {})):
            a = np.asarray(leaf, dtype=np.float32)
            name = path[-1]
            if name == "kernel" or name.startswith("kernel_"):
                name = "weight" + name[len("kernel"):]
                if a.ndim == 2:
                    a = a.T
                else:
                    a = a.transpose(_CONVT_PERM if _is_convt(path) else _CONV_TO_TORCH)
            elif name.startswith(("w_ih_", "w_hh_")):
                name = "weight_" + name[2:]
                a = a.T
            elif name.startswith(("b_ih_", "b_hh_")):
                name = "bias_" + name[2:]
            key = ".".join(path[:-1] + (name,))
            out[key] = torch.tensor(a)  # a copy: JAX buffers are read-only
    return out


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def jax_from_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: state dict -> JAX
    ``{"params", "batch_stats"}`` tree of numpy arrays."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        a = t.detach().cpu().numpy().astype(np.float32)
        name = path[-1]
        col = "batch_stats" if name in _STAT_NAMES else "params"
        if name.startswith("weight_ih_") or name.startswith("weight_hh_"):
            name = "w_" + name[len("weight_"):]
            a = a.T
        elif name.startswith("bias_ih_") or name.startswith("bias_hh_"):
            name = "b_" + name[len("bias_"):]
        elif name == "weight" or name.startswith("weight_"):
            name = "kernel" + name[len("weight"):]
            if a.ndim == 2:
                a = a.T
            else:
                a = a.transpose(_CONVT_PERM if _is_convt(path) else _CONV_TO_JAX)
        _set(tree[col], path[:-1] + (name,), np.ascontiguousarray(a))
    return tree
