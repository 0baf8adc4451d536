"""Weights from the JAX package's parameter tree into the port's state dict.

The JAX models keep their parameters as a nested dict with the layers
stacked on a leading L axis: ``layers/attn/wq`` is ``[L, D, H, hd]`` in the
dense ``TransformerLM``, ``layers/mamba/in_x`` is ``[L, D, di]`` and
``layers/ln/scale`` ``[L, D]`` in ``MambaLM``.  The hybrid ``Zamba2LM``
stacks its Mamba layers on two axes, ``[groups, attn_every, ...]``, and
keeps its one ``shared_attn`` block unstacked; layer j of group g becomes
the port's layer ``g * attn_every + j``.  The vlm ``TransformerLM`` stacks
``layers`` the same way, [groups, cross_attn_every, ...], and its gated
cross-attention layers ``cross`` on [groups]: ``cross.<g>.*``.  ``params_from_jax`` takes
that tree with numpy arrays at the leaves (``jax.tree.map(np.asarray,
params)``) and returns the port's ``{name: array}``, one entry per layer
(``layers.<i>.attn.wq``, ``layers.<i>.mamba.in_x``, ...).  Leaves keep
their dtype (the JAX init's float32); ``load_params`` casts each once to
the dtype the port stores it in.  ``jax.random`` and ``torch.Generator``
draw different numbers from one seed, so this is how both packages are
made to compute the same function.
"""
from __future__ import annotations

import numpy as np


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(tree: dict) -> dict:
    """JAX param tree (numpy leaves) -> port state dict (numpy arrays)."""
    grouped = "shared_attn" in tree or "cross" in tree     # [g, per]
    axes = {"layers": 2 if grouped else 1, "cross": 1}
    state = {}
    for name, arr in _flatten(tree).items():
        top, _, rest = name.partition(".")
        if top in axes:
            arr = arr.reshape(-1, *arr.shape[axes[top]:])
            for i in range(arr.shape[0]):
                state[f"{top}.{i}.{rest}"] = arr[i]
        else:
            state[name] = arr
    return state
