"""Sharding specs: logical activation axes and path-matched parameter
specs, the port of the JAX package's ``parallel/sharding.py``.

A :class:`Spec` is the counterpart of JAX's ``PartitionSpec``: one entry a
dim, each None (replicated), a mesh axis name, or a tuple of names (the
dim split over their product, the first name the slowest); a one-name
tuple reads as the name, as ``PartitionSpec`` normalises it.  Default
mapping (Megatron-style TP on ``model``, DP over ``pod`` + ``data``):
batch -> (pod, data); heads, kv_heads, ff, experts, vocab -> model; seq ->
None (or model with sequence parallelism).

Stacked axes.  The reference's specs are taken on its parameter tree,
whose layers are stacked on leading axes (``layers/attn/wq`` [L, D, H, hd];
the vlm's and zamba2's ``layers`` on [groups, per, ...], the vlm's
``cross`` on [groups]); the port keeps one tensor a layer
(``layers.<i>.attn.wq`` [D, H, hd]).  ``sanitize_spec`` never relocates
onto index 0, which is the stacked axis there and would be D here, and
``zero_spec`` picks the first free dim, which there can be L.  So every
function here that takes the port's parameters and a ``cfg`` computes each
spec on the reference's stacked shape (:func:`stack_dims`) and then drops
the stacked entries (:func:`per_layer`).  A mesh axis that the reference
places on a stacked axis has no per-layer counterpart and is dropped with
it: at published width ``zero_spec`` puts ``data`` on the layer axis of
llama3.2-1b, mamba2-780m, musicgen-large and qwen2-72b, whose L a data
extent of 16 divides.

:func:`local_shape` is a tensor's per-device shard shape under a spec;
:class:`Named` (the counterpart of JAX's ``NamedSharding``), :func:`named`
and :func:`shaped_with_sharding` give the dry-run's inputs: meta tensors
of their per-device shard shapes that carry their spec and global shape.

The port has no ``constrain`` hook: eager PyTorch has no GSPMD layout
hint, so :class:`MeshRules` gives the spec and its cleaning
(:meth:`MeshRules.cleaned`) and nothing applies it to an activation.
:func:`shard` cuts a rank's block of a tensor by a spec,
:func:`gather` puts the blocks back together over the mesh's subgroups,
and :func:`reduce_scatter` sums every rank's tensor into the blocks.
:func:`sum_replicated` is the gradient convention's sum (see
``parallel/collectives.py``): a tensor's gradient summed over the mesh
axes its spec leaves it whole on; :func:`replicas` counts the ranks that
hold one such tensor, which is also what a replicated loss is seeded
with the inverse of.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.parallel.collectives import (combine_counters,
                                              ring_all_gather_local,
                                              ring_all_reduce,
                                              ring_reduce_scatter_local)
from repro_torch.parallel.mesh import dp_axes


class Spec(tuple):
    """A partition spec: ``Spec(None, "model")``, ``Spec(("pod", "data"),
    None)``; equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass
class MeshRules:
    """Binds logical activation axes to mesh axes (the reference's model
    ``constrain``; here :meth:`cleaned` gives the spec it would apply)."""

    mesh: object
    sequence_parallel: bool = False
    rules: dict = field(default_factory=dict)

    def __post_init__(self):
        dp = dp_axes(self.mesh)
        defaults = {
            "batch": dp,
            "seq": "model" if self.sequence_parallel else None,
            "embed": None,
            "heads": "model",
            "kv_heads": "model",
            "ff": "model",
            "vocab": "model",
            "experts": "model",
        }
        defaults.update(self.rules)
        self.rules = defaults

    def spec(self, axes: tuple) -> Spec:
        return Spec(*(self.rules.get(a) if a is not None else None
                      for a in axes))

    def cleaned(self, shape: tuple, axes: tuple) -> Optional[Spec]:
        """The spec the reference's ``MeshRules.__call__`` constrains an
        activation of ``shape`` to, None where it leaves the tensor alone
        (rank other than ``len(axes)``).  A dim that its axes do not divide,
        or that is smaller than their extent, is replicated; a mesh axis
        may appear once, so with sequence parallelism the later (more
        specific) dim keeps it."""
        if len(shape) != len(axes):
            return None
        cleaned = []
        for dim, entry in zip(shape, self.spec(axes)):
            if entry is None:
                cleaned.append(None)
                continue
            n = math.prod(self.mesh.shape[a] for a in _names(entry))
            cleaned.append(entry if (dim >= n and dim % n == 0) else None)
        seen: set = set()
        for i in range(len(cleaned) - 1, -1, -1):
            e = cleaned[i]
            if e is None:
                continue
            names = set(_names(e))
            if names & seen:
                cleaned[i] = None
            else:
                seen |= names
        return Spec(*cleaned)


# --------------------------------------------------------------------------- #
# Parameter specs by (parent, leaf) path matching
# --------------------------------------------------------------------------- #
# trailing-dim specs; leading stacked scan dims are padded with None
_PARAM_RULES: dict = {
    ("embed", "embedding"): ("model", None),
    ("head", "w"): (None, "model"),
    ("attn", "wq"): (None, "model", None),
    ("attn", "wk"): (None, "model", None),
    ("attn", "wv"): (None, "model", None),
    ("attn", "wo"): ("model", None, None),
    ("attn", "bq"): ("model", None),
    ("attn", "bk"): ("model", None),
    ("attn", "bv"): ("model", None),
    ("attn", "gate"): (),
    ("mlp", "wi_gate"): (None, "model"),
    ("mlp", "wi_up"): (None, "model"),
    ("mlp", "wo"): ("model", None),
    ("moe", "router"): (None, None),
    ("moe", "wi_gate"): ("model", None, None),
    ("moe", "wi_up"): ("model", None, None),
    ("moe", "wo"): ("model", None, None),
    ("mamba", "in_z"): (None, "model"),
    ("mamba", "in_x"): (None, "model"),
    ("mamba", "in_B"): (None, None),
    ("mamba", "in_C"): (None, None),
    ("mamba", "in_dt"): (None, "model"),
    ("mamba", "conv_w"): (None, None),
    ("mamba", "conv_b"): (None,),
    ("mamba", "dt_bias"): ("model",),
    ("mamba", "A_log"): ("model",),
    ("mamba", "D"): ("model",),
    ("mamba", "out"): ("model", None),
    ("cross", "kv_proj"): (None, None),
    (None, "gate_mlp"): (),
    (None, "scale"): (None,),  # all norm scales, incl. mamba gated norm
}


def _match(path_names: list, leaf_ndim: int) -> tuple:
    leaf = path_names[-1]
    parent = path_names[-2] if len(path_names) > 1 else None
    for key in ((parent, leaf), (None, leaf)):
        if key in _PARAM_RULES:
            trailing = _PARAM_RULES[key]
            pad = leaf_ndim - len(trailing)
            if pad < 0:
                continue
            return (None,) * pad + tuple(trailing)
    # mamba norm scale lives at ('mamba','norm','scale'): parent='norm'
    if leaf == "scale":
        return (None,) * (leaf_ndim - 1) + (None,)
    return (None,) * leaf_ndim


def stack_dims(name: str, cfg) -> tuple:
    """The leading axes the reference stacks the port's parameter ``name``
    on: ``layers.<i>.*`` on [L] (the vlm's and zamba2's on [groups, per]),
    the vlm's ``cross.<g>.*`` on [groups]; () for the rest (embeddings,
    head, final norm, zamba2's ``shared_attn``) or without a ``cfg``."""
    if cfg is None:
        return ()
    top = name.split(".", 1)[0]
    if top == "layers":
        if cfg.family == "vlm":
            return (cfg.n_cross, cfg.cross_attn_every)
        if cfg.family == "hybrid":
            return (cfg.num_layers // cfg.attn_every, cfg.attn_every)
        return (cfg.num_layers,)
    if top == "cross":
        return (cfg.n_cross,)
    return ()


def _ref_path(name: str) -> list:
    """The reference's tree path of a port name (the layer index gone)."""
    parts = name.split(".")
    if parts[0] in ("layers", "cross") and len(parts) > 1 \
            and parts[1].isdigit():
        del parts[1]
    return parts


def _shapes(params) -> dict:
    """{name: shape} of a module's parameters or of a {name: tensor |
    shape} dict."""
    if isinstance(params, torch.nn.Module):
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(getattr(v, "shape", v)) for n, v in params.items()}


def _cfg(params, cfg):
    return cfg if cfg is not None else getattr(params, "cfg", None)


def per_layer(spec, n_stack: int) -> Spec:
    """``spec`` of a stacked shape without its ``n_stack`` stacked
    entries."""
    return Spec(*tuple(spec)[n_stack:])


def _stacked(spec, n_stack: int) -> Spec:
    """A per-layer spec padded with None for the stacked dims."""
    return Spec(*((None,) * n_stack + tuple(spec)))


def param_specs(params, cfg=None, stacked: bool = False) -> dict:
    """{name: Spec} for a model's parameters or a {name: tensor | shape}
    dict (the reference's ``param_specs`` on its tree).  With a ``cfg`` (a
    model's own by default) each spec is the reference's on the stacked
    shape, its stacked entries dropped (kept with ``stacked``: the spec of
    ``stack_dims(name, cfg) + shape``)."""
    cfg = _cfg(params, cfg)
    out = {}
    for name, shape in _shapes(params).items():
        k = len(stack_dims(name, cfg))
        spec = _match(_ref_path(name), k + len(shape))
        out[name] = Spec(*spec) if stacked else per_layer(spec, k)
    return out


def ref_leaf(name: str) -> str:
    """The reference's tree path of a port parameter, "/"-joined: every
    layer's ``layers.<i>.attn.wq`` is the one stacked leaf
    ``layers/attn/wq``."""
    return "/".join(_ref_path(name))


def sanitize_spec(spec, shape: tuple, mesh) -> Spec:
    """Make a spec legal for ``shape`` on ``mesh``: any sharded dim must
    divide.

    If the preferred dim doesn't divide (e.g. kv_heads=2 on a 16-way model
    axis), relocate the axis to the LAST other dim that divides (head_dim,
    then d_model) — the Megatron GQA-replication fallback — else
    replicate.  Index 0 is never a target: on the reference's stacked
    shapes it is the stacked (scan) axis."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None:
            continue
        n = math.prod(mesh.shape[a] for a in _names(e)
                      if a in mesh.axis_names)
        if n <= 1:
            continue
        if d % n == 0 and d >= n:
            continue
        entries[i] = None
        for j in range(len(shape) - 1, 0, -1):  # never the leading scan dim
            if j == i or entries[j] is not None:
                continue
            if shape[j] % n == 0 and shape[j] >= n:
                entries[j] = e
                break
    return Spec(*entries)


def sanitize_specs(specs: dict, params, mesh, cfg=None) -> dict:
    """``sanitize_spec`` of each parameter's (per-layer) spec on its shape;
    with a ``cfg``, on the reference's stacked shape, the stacked entries
    dropped."""
    cfg = _cfg(params, cfg)
    out = {}
    for name, shape in _shapes(params).items():
        dims = stack_dims(name, cfg)
        s = sanitize_spec(_stacked(specs[name], len(dims)), dims + shape,
                          mesh)
        out[name] = per_layer(s, len(dims))
    return out


def zero_spec(spec, shape: tuple, mesh, axes: tuple = ("data",)) -> Spec:
    """ZeRO: additionally shard an (optimizer-state) tensor over data axes.

    Picks the first dimension that is currently unsharded and divisible by
    the data-axis extent; falls back to the original spec."""
    usable = tuple(a for a in axes if a in mesh.axis_names)
    if not usable:
        return Spec(*spec)
    n = math.prod(mesh.shape[a] for a in usable)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # already ZeRO/FSDP-sharded over (any of) these axes -> no-op
    used = set()
    for e in entries:
        if e is not None:
            used |= set(_names(e))
    if used & set(usable):
        return Spec(*entries)
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if entry is None and dim % n == 0 and dim >= n:
            entries[i] = usable if len(usable) > 1 else usable[0]
            return Spec(*entries)
    return Spec(*spec)


# --------------------------------------------------------------------------- #
# Per-device shard shapes, and the dry-run's inputs
# --------------------------------------------------------------------------- #
def local_shape(shape: tuple, spec, mesh) -> tuple:
    """The per-device shard shape of a tensor of ``shape`` under ``spec``
    on ``mesh`` (JAX's ``NamedSharding.shard_shape``): a dim under axes of
    extent n is cut in n equal parts, which must divide it."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = 1 if entry is None else math.prod(mesh.shape[a]
                                              for a in _names(entry))
        if dim % n:
            raise ValueError(f"local_shape: dim {dim} of {tuple(shape)} is "
                             f"not a multiple of {n} ({entry!r})")
        out.append(dim // n)
    return tuple(out)


@dataclass(frozen=True)
class Named:
    """A spec on a mesh, the counterpart of JAX's ``NamedSharding``."""

    mesh: object
    spec: Spec

    def shard_shape(self, shape: tuple) -> tuple:
        return local_shape(shape, self.spec, self.mesh)


def named(mesh, specs: dict) -> dict:
    """{name: Named} of a {name: Spec} dict (the reference's ``named``)."""
    return {k: Named(mesh, s) for k, s in specs.items()}


def shaped_with_sharding(shapes: dict, specs: dict, mesh,
                         dtypes: Optional[dict] = None) -> dict:
    """The dry-run's inputs (the reference's ``shaped_with_sharding``):
    {name: a meta tensor of the per-device shard shape}, each carrying
    ``.sharding`` (a :class:`Named`) and ``.global_shape``.  ``shapes``
    maps names to tensors or shapes; ``dtypes`` (default: each tensor's,
    else float32) their dtypes."""
    out = {}
    for name, v in shapes.items():
        shape = tuple(getattr(v, "shape", v))
        dtype = (dtypes or {}).get(name, getattr(v, "dtype", torch.float32))
        sharding = Named(mesh, Spec(*specs[name]))
        t = torch.empty(sharding.shard_shape(shape), dtype=dtype,
                        device="meta")
        t.sharding, t.global_shape = sharding, shape
        out[name] = t
    return out


# --------------------------------------------------------------------------- #
# A rank's block of a tensor, and back
# --------------------------------------------------------------------------- #
def _split(entry, mesh, coords) -> tuple:
    """(parts, index) of a dim under ``entry`` at mesh ``coords``: the
    product of its axes' sizes and the row-major index over them."""
    parts, index = 1, 0
    for a in _names(entry):
        n = mesh.shape[a]
        parts, index = parts * n, index * n + coords[mesh.axis_names.index(a)]
    return parts, index


def shard(t: torch.Tensor, spec, mesh, coords) -> torch.Tensor:
    """The block of ``t`` that the rank at mesh ``coords`` holds under
    ``spec`` (a dim under axes of extent n is cut in n equal parts; it must
    divide), as a tensor of its own, so that ``t`` can be freed."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts, index = _split(entry, mesh, coords)
        size = t.shape[dim]
        if size % parts:
            raise ValueError(f"shard: dim {dim} of {tuple(t.shape)} is not "
                             f"a multiple of {parts} ({entry!r})")
        out = out.narrow(dim, index * (size // parts), size // parts)
    return out.clone(memory_format=torch.contiguous_format)


def gather(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` block: for each sharded
    dim, a ring all-gather over the subgroup of each of its axes, the
    fastest axis first (``parallel/collectives.py``).  Every rank calls it
    with its own block; every rank gets the whole tensor."""
    out = block
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed(_names(entry)):
            moved = out.movedim(dim, 0).contiguous()
            full, _ = ring_all_gather_local(moved, mesh.group(a))
            out = full.movedim(0, dim)
    return out.contiguous()


def reduce_scatter(t: torch.Tensor, spec, mesh, watch=None) -> torch.Tensor:
    """The inverse of :func:`gather`: every rank's ``t`` (one shape for
    all) summed, and this rank's ``shard`` block of the sum under ``spec``
    kept.  For each sharded dim, a ring reduce-scatter over the subgroup of
    each of its axes, the slowest axis first, each rank keeping the chunk
    of its own coordinate.  ``watch(axis, progress, counters)``, if given,
    gets each ring's progress and combine counters before the ring starts
    (a hang callback reads them while it runs)."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in _names(entry):
            n = mesh.shape[a]
            if n == 1:
                continue
            moved = out.movedim(dim, 0).contiguous()
            progress = torch.zeros(max(n - 1, 1), dtype=torch.int32)
            counters = combine_counters(moved, n)
            if watch is not None:
                watch(a, progress, counters)
            chunk, _ = ring_reduce_scatter_local(
                moved, mesh.group(a), progress=progress, counters=counters,
                slot_offset=0)
            out = chunk.movedim(0, dim)
    return out.contiguous()


# --------------------------------------------------------------------------- #
# The gradient convention: seeds and the replicated-axis sum
# --------------------------------------------------------------------------- #
def _replicated(spec, mesh) -> tuple:
    """The axes of ``mesh`` that no entry of ``spec`` names, in mesh
    order: the axes a tensor under ``spec`` is held whole on."""
    named: set = set()
    for entry in spec:
        if entry is not None:
            named |= set(_names(entry))
    return tuple(a for a in mesh.axis_names if a not in named)


def replicas(spec, mesh) -> int:
    """How many ranks of ``mesh`` hold one tensor under ``spec`` whole: a
    loss of this spec is seeded with 1 / replicas on each of them."""
    return math.prod(mesh.shape[a] for a in _replicated(spec, mesh))


def sum_replicated(grad: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``grad`` of a tensor under ``spec``, summed over every mesh axis the
    tensor is replicated on (an axis of one rank adds nothing), each by the
    ring all-reduce over this rank's subgroup of it.  Every rank of the
    mesh calls it, for the same tensors in the same order; each gets the
    one global loss's gradient of its block."""
    with torch.no_grad():
        for a in _replicated(spec, mesh):
            if mesh.shape[a] > 1:
                grad = ring_all_reduce(grad, mesh.group(a))[0]
    return grad
