"""ZeRO-sharded AdamW over a mesh: the optimizer of the mesh training step
(``runtime/train.py::make_train_step(mesh=)``), the JAX package's AdamW
state under ``opt_state_specs`` (ZeRO over the data axes) as the port's
ranks hold it.

Leaves.  The reference's state is a tree of stacked leaves
(``layers/attn/wq`` [L, D, H, hd]); the port's model keeps one tensor a
layer.  A :class:`Leaf` is one reference leaf: the port's parameters
stacked on it in the reference's order (``sharding.stack_dims``), its
global stacked shape, the layout a rank holds those parameters in (whole,
or under expert parallelism its experts' block) and its moments' spec
(``opt_state_specs(..., stacked=True)`` of the sanitised parameter specs).
A rank's moments are its block of each leaf under that spec
(``sharding.local_shape``) and nothing more: where the spec puts ``data``
on the stacked layer axis, the rank owns the moments of its block of
layers, as the reference's device does.

One update (:meth:`ZeroAdamW.update`): each leaf's gradient, accumulated
in a stacked buffer of the held layout, is reduce-scattered over the axes
the moment spec shards it on beyond that layout
(``sharding.reduce_scatter``, the ring-combine kernel) and summed over the
axes the moment is replicated on (``ring_all_reduce``): ZeRO-2, each rank
keeping only its block of the summed gradient.  The global norm sums each
block's squares over the axes its spec shards it on and no others, so that
every element counts once.  ``adamw_update`` runs on the blocks, and the
updated parameter blocks are all-gathered back into the held layout
(``sharding.gather``).

int8 moments.  ``_q_enc`` quantises along the last axis in blocks of
``QBLOCK``; where the spec cuts the last axis at a width that is not a
multiple of it, a rank's columns are not whole blocks.  The codec here
takes each block's absmax over the ranks that hold a part of it (a ring
all-gather of the partial maxima), so that the codes and scales are the
whole tensor's, bit for bit; a rank stores its block of the scales under
the scale's own spec (sanitised on its ``[..., n_blocks]`` shape), which
may cut the scales' rows where the codes' are whole.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import (QBLOCK, AdamWConfig, _nblocks,
                                     adamw_update, opt_state_specs)
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.collectives import (ring_all_gather_local,
                                              ring_all_reduce)


def _entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _axes(spec) -> set:
    return {a for e in spec if e is not None for a in sh._names(e)}


def _minus(spec, held) -> sh.Spec:
    """``spec`` within a tensor already cut by ``held``: each dim's axes
    past the held ones (which must lead them)."""
    out = []
    for e, h in zip(spec, _entries(held, len(spec))):
        en = sh._names(e) if e is not None else ()
        hn = sh._names(h) if h is not None else ()
        if en[:len(hn)] != hn:
            raise ValueError(f"zero: spec {spec} does not refine the held "
                             f"layout {held}")
        rest = en[len(hn):]
        out.append(rest if rest else None)
    return sh.Spec(*out)


def _layer(name: str) -> int:
    parts = name.split(".")
    if parts[0] in ("layers", "cross") and len(parts) > 1 \
            and parts[1].isdigit():
        return int(parts[1])
    return 0


@dataclass(frozen=True)
class Leaf:
    """One reference leaf and its layout on this rank's mesh."""

    name: str              # the reference's path, "layers/attn/wq"
    names: tuple           # the port's parameters on it, in stacked order
    stack: tuple           # the stacked dims
    shape: tuple           # the global stacked shape
    spec: sh.Spec          # the moments' (int8: the codes')
    scale: Optional[sh.Spec]   # int8: the scales', on [..., n_blocks]
    rel: sh.Spec           # the gradient's scatter: spec less the held
    sharded: tuple         # axes the spec cuts (the norm's sum)
    scale_rel: Optional[sh.Spec]   # the scales' cut of the codes' rows


class ZeroAdamW:
    """AdamW over ``mesh`` for ``model``'s parameters (its own, updated in
    place), the state ZeRO-sharded under the reference's specs.  Every rank
    of the (connected) mesh builds one, for the same model config, and
    calls its methods in one order."""

    def __init__(self, model, mesh, cfg: AdamWConfig):
        self.mesh, self.cfg = mesh, cfg
        self.coords = mesh.coords(dist.get_rank())
        self.device = model.device
        # the rings of the last gradient reduce-scatter, in order
        self.rings: list = []
        mcfg = model.cfg
        params = dict(model.named_parameters())
        whole = sh._shapes(build_model(mcfg, device="meta"))
        stacked = {n: sh.stack_dims(n, mcfg) + whole[n] for n in whole}
        raw = sh.param_specs(whole, mcfg, stacked=True)
        pspecs = {n: sh.sanitize_spec(raw[n], stacked[n], mesh)
                  for n in whole}
        ospecs = opt_state_specs(pspecs, whole, mesh, cfg, model_cfg=mcfg,
                                 stacked=True)["mu_nu"]
        groups: dict = {}
        for n in params:
            groups.setdefault(sh.ref_leaf(n), []).append(n)
        self.leaves = []
        for leaf, names in groups.items():
            names = tuple(sorted(names, key=_layer))
            n0 = names[0]
            stack = sh.stack_dims(n0, mcfg)
            if len(names) != math.prod(stack):
                raise ValueError(f"zero: {leaf} stacks {len(names)} "
                                 f"parameters on {stack}")
            held = [None] * len(stacked[n0])
            k = len(stack)
            for d, (loc, glob) in enumerate(zip(params[n0].shape, whole[n0])):
                if loc != glob:
                    e = _entries(pspecs[n0], len(held))[k + d]
                    parts = 1 if e is None else math.prod(
                        mesh.shape[a] for a in sh._names(e))
                    if loc * parts != glob:
                        raise ValueError(f"zero: {n0} holds {loc} of {glob} "
                                         f"on dim {d}, not its spec's {e}")
                    held[k + d] = e
            held = sh.Spec(*held)
            m = ospecs[n0]["m"]
            spec, scale = (m["q"], m["scale"]) if isinstance(m, dict) \
                else (m, None)
            nd = len(stacked[n0])
            spec = sh.Spec(*_entries(spec, nd))
            scale_rel = None
            if scale is not None:
                scale = sh.Spec(*_entries(scale, nd))
                rel = []
                for i in range(nd - 1):
                    if spec[i] is None:
                        rel.append(scale[i])
                    elif scale[i] != spec[i]:
                        raise ValueError(f"zero: {leaf}'s scale spec {scale} "
                                         f"moves its codes' {spec}")
                    else:
                        rel.append(None)
                scale_rel = sh.Spec(*rel, scale[-1])
            cut = _axes(spec)
            self.leaves.append(Leaf(
                name=leaf, names=names, stack=stack, shape=stacked[n0],
                spec=spec, scale=scale, rel=_minus(spec, held),
                sharded=tuple(a for a in mesh.axis_names
                              if a in cut and mesh.shape[a] > 1),
                scale_rel=scale_rel))

    # ------------------------------------------------------------------ #
    # the state
    # ------------------------------------------------------------------ #
    def _block_shape(self, leaf: Leaf) -> tuple:
        return sh.local_shape(leaf.shape, leaf.spec, self.mesh)

    def _scale_shape(self, leaf: Leaf) -> tuple:
        return leaf.shape[:-1] + (_nblocks(leaf.shape[-1]),)

    def init(self) -> dict:
        """Zero moments, each rank's blocks only: ``{"mu_nu": {leaf:
        {"m": block, "v": block}}, "count": 0}``, an int8 moment a
        ``{"q": codes, "scale": scales}`` of blocks."""
        kw = dict(device=self.device)

        def one(leaf):
            shape = self._block_shape(leaf)
            if self.cfg.state_dtype == "int8":
                scale = sh.local_shape(self._scale_shape(leaf), leaf.scale,
                                       self.mesh)
                return {"q": torch.zeros(shape, dtype=torch.int8, **kw),
                        "scale": torch.zeros(scale, dtype=torch.float32,
                                             **kw)}
            dt = (torch.bfloat16 if self.cfg.state_dtype == "bfloat16"
                  else torch.float32)
            return torch.zeros(shape, dtype=dt, **kw)

        return {"mu_nu": {leaf.name: {"m": one(leaf), "v": one(leaf)}
                          for leaf in self.leaves},
                "count": torch.zeros((), dtype=torch.int32, **kw)}

    @staticmethod
    def resident_bytes(state: dict) -> int:
        """The bytes a rank's state holds (m and v, codes and scales)."""
        def size(t):
            if isinstance(t, dict):
                return sum(size(v) for v in t.values())
            return t.numel() * t.element_size()
        return size(state["mu_nu"])

    # ------------------------------------------------------------------ #
    # gradients
    # ------------------------------------------------------------------ #
    def _held_shape(self, leaf: Leaf, params: dict) -> tuple:
        return tuple(params[leaf.names[0]].shape)

    def zeros(self, params: dict, dtype) -> dict:
        """The accumulators of a step: a stacked buffer a leaf, in the held
        layout."""
        return {leaf.name: torch.zeros(
            leaf.stack + self._held_shape(leaf, params), dtype=dtype,
            device=self.device) for leaf in self.leaves}

    def sink(self, acc: dict, params: dict) -> list:
        """Hooks that add each parameter's gradient into its row of the
        stacked buffers ``acc`` (cast to the buffer's dtype first) as soon
        as a backward has summed it, and drop it, so that no microbatch's
        gradients are ever held beside the buffers; returns the hooks'
        handles (``remove()`` each after the step)."""
        handles = []
        for leaf in self.leaves:
            buf = acc[leaf.name]
            rows = buf.view((-1,) + tuple(buf.shape[len(leaf.stack):]))
            for row, n in zip(rows, leaf.names):
                def add(p, row=row):
                    row.add_(p.grad.to(row.dtype))
                    p.grad = None
                handles.append(params[n].register_post_accumulate_grad_hook(
                    add))
        return handles

    def _watch(self, leaf: Leaf):
        def watch(axis, progress, counters):
            self.rings.append(dict(leaf=leaf.name, axis=axis,
                                   progress=progress, counters=counters))
        return watch

    def scatter(self, acc: dict) -> dict:
        """Each leaf's summed gradient, this rank's block of it
        ({leaf: block}); the buffers are taken out of ``acc`` as they go,
        so that each is freed once reduced.  ``rings`` gets each ring's
        leaf, axis, progress and combine counters as it starts (a hang
        callback reads them while it runs)."""
        self.rings = []
        out = {}
        for leaf in self.leaves:
            g = sh.reduce_scatter(acc.pop(leaf.name), leaf.rel, self.mesh,
                                  self._watch(leaf))
            out[leaf.name] = sh.sum_replicated(g, leaf.spec, self.mesh)
        return out

    def global_norm(self, blocks: dict) -> torch.Tensor:
        """sqrt of the sum of every block's squares, each summed over the
        axes its spec cuts: every element of the global gradient once."""
        groups: dict = {}
        for leaf in self.leaves:
            s = torch.sum(torch.square(blocks[leaf.name].float()))
            groups[leaf.sharded] = groups.get(leaf.sharded, 0) + s
        total = 0
        for axes, s in groups.items():
            s = s.reshape(1)
            for a in axes:
                s = ring_all_reduce(s, self.mesh.group(a))[0]
            total = total + s[0]
        return torch.sqrt(total)

    # ------------------------------------------------------------------ #
    # parameter blocks
    # ------------------------------------------------------------------ #
    def _ranges(self, leaf: Leaf, held_shape: tuple) -> list:
        """(start, size) on each dim of the stacked held tensor of this
        rank's block under ``leaf.rel``."""
        out = []
        for size, e in zip(leaf.stack + held_shape, leaf.rel):
            if e is None:
                out.append((0, size))
                continue
            parts, index = sh._split(e, self.mesh, self.coords)
            out.append((index * (size // parts), size // parts))
        return out

    def param_block(self, leaf: Leaf, params: dict) -> torch.Tensor:
        """This rank's block of the leaf's stacked parameters, a tensor of
        its own."""
        held = self._held_shape(leaf, params)
        rng = self._ranges(leaf, held)
        k = len(leaf.stack)
        parts = []
        for ii in itertools.product(*(range(s, s + z) for s, z in rng[:k])):
            flat = 0
            for i, n in zip(ii, leaf.stack):
                flat = flat * n + i
            t = params[leaf.names[flat]].detach()
            for d, (s, z) in enumerate(rng[k:]):
                t = t.narrow(d, s, z)
            parts.append(t)
        block = torch.stack(parts)
        return block.reshape(tuple(z for _, z in rng))

    def put_back(self, leaf: Leaf, block: torch.Tensor, params: dict):
        """All-gather an updated block into the held layout and copy it
        into the model's parameters."""
        full = sh.gather(block, leaf.rel, self.mesh) if _axes(leaf.rel) \
            else block
        held = self._held_shape(leaf, params)
        for n, t in zip(leaf.names, full.reshape((-1,) + held)):
            params[n].detach().copy_(t)

    # ------------------------------------------------------------------ #
    # the int8 codec on blocks
    # ------------------------------------------------------------------ #
    def _columns(self, leaf: Leaf, width: int) -> torch.Tensor:
        """The global block index of each of this rank's columns."""
        e = leaf.spec[-1]
        offset = 0
        if e is not None:
            parts, index = sh._split(e, self.mesh, self.coords)
            offset = index * (leaf.shape[-1] // parts)
        return (torch.arange(width, device=self.device) + offset) // QBLOCK

    def encode(self, leaf: Leaf, x: torch.Tensor) -> dict:
        """``_q_enc`` of the whole tensor, on this rank's block ``x``."""
        cols = self._columns(leaf, x.shape[-1])
        lead = tuple(x.shape[:-1])
        amax = torch.zeros(lead + (_nblocks(leaf.shape[-1]),),
                           dtype=torch.float32, device=x.device)
        amax.scatter_reduce_(-1, cols.expand(lead + (x.shape[-1],)),
                             x.float().abs(), "amax")
        e = leaf.spec[-1]
        for a in (sh._names(e) if e is not None else ()):
            if self.mesh.shape[a] > 1:
                every, _ = ring_all_gather_local(amax[None].contiguous(),
                                                 self.mesh.group(a))
                amax = every.amax(0)
        scale = torch.clamp(amax / 127.0, min=1e-20)
        q = torch.clamp(torch.round(x.float() / scale[..., cols]), -127, 127)
        return {"q": q.to(torch.int8),
                "scale": sh.shard(scale, leaf.scale_rel, self.mesh,
                                  self.coords)}

    def decode(self, leaf: Leaf, s: dict) -> torch.Tensor:
        """``_q_dec`` of the whole tensor, on this rank's block."""
        scale = s["scale"]
        if _axes(leaf.scale_rel):
            scale = sh.gather(scale, leaf.scale_rel, self.mesh)
        cols = self._columns(leaf, s["q"].shape[-1])
        return s["q"].float() * scale[..., cols]

    # ------------------------------------------------------------------ #
    # the update
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def update(self, acc: dict, state: dict, params: dict, lr,
               microbatches: int = 1) -> dict:
        """One AdamW step from the accumulated gradients ``acc`` (the sum
        over ``microbatches``), in place on ``state`` and on the model's
        ``params``; returns ``{"grad_norm": fp32 scalar}``."""
        blocks = {k: g / microbatches for k, g in self.scatter(acc).items()}
        gnorm = self.global_norm(blocks)
        pblocks = {leaf.name: self.param_block(leaf, params)
                   for leaf in self.leaves}
        int8 = self.cfg.state_dtype == "int8"
        cfg = self.cfg
        mu_nu = state["mu_nu"]
        if int8:
            mu_nu = {leaf.name: {k: self.decode(leaf, mu_nu[leaf.name][k])
                                 for k in ("m", "v")}
                     for leaf in self.leaves}
            cfg = dataclasses.replace(cfg, state_dtype="float32")
        adamw_update(blocks, {"mu_nu": mu_nu, "count": state["count"]},
                     pblocks, cfg, lr, gnorm=gnorm)
        del blocks
        for leaf in self.leaves:
            if int8:
                state["mu_nu"][leaf.name] = {
                    k: self.encode(leaf, mu_nu[leaf.name][k])
                    for k in ("m", "v")}
            self.put_back(leaf, pblocks.pop(leaf.name), params)
        return {"grad_norm": gnorm}

    # ------------------------------------------------------------------ #
    # whole tensors, for checks
    # ------------------------------------------------------------------ #
    def gather_state(self, state: dict) -> dict:
        """Every leaf's whole stacked moments ({leaf: {"m", "v"}}, int8 as
        whole codes and scales); every rank calls it."""
        def whole(leaf, t):
            if isinstance(t, dict):
                return {"q": sh.gather(t["q"], leaf.spec, self.mesh),
                        "scale": sh.gather(t["scale"], leaf.scale,
                                           self.mesh)}
            return sh.gather(t, leaf.spec, self.mesh)
        return {leaf.name: {k: whole(leaf, state["mu_nu"][leaf.name][k])
                            for k in ("m", "v")} for leaf in self.leaves}
