"""Op-level cost analysis: the counterpart of the JAX package's
``launch/hlo_analysis.py``, read off the aten ops a function runs (the
port has no HLO).

    stats = analyze(fn, *args, **kwargs)

runs ``fn`` under a ``TorchDispatchMode`` on meta tensors (a model built
with ``device="meta"``: nothing is computed or allocated; an op given a
tensor on a device, but for a 0-d one, raises), and returns ``analyze_hlo``'s keys, ``flops``, ``traffic_bytes``,
``collectives`` and ``total_wire_bytes``, with ``traffic_by_op``, the
port kernels' calls (``kernels``), the peak of the bytes the run's own
tensors held at once (``peak_live_bytes``) and ``fn``'s ``result``.

* flops: the products only, as ``_dot_flops`` counts them: 2 · output
  elements · contracted extent for ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` and convolutions.
* The port's kernels are charged by their own work: each wrapper's meta
  route (``kernels/__init__.py``) charges its ``ops.py``'s ``work`` (the
  formula the card's bounds use), products as flops and its bytes as
  traffic; the plain versions' ops never run here.
* Traffic, the eager model: every top-level aten op reads its operands and
  writes its result in device memory (on the H100 the counterpart of the
  reference's "top-level fusion" model).  Views and reshapes (an output on
  an input's storage, nothing written) are free, and so are ``empty``
  allocations; copies cost 2 × the result, ``index_put`` and the scatters
  2 × the update.
* Collectives: under an analysis the port's ring collectives
  (``parallel/collectives.py``) record their kind, result bytes and group
  size, with wire bytes by the reference's ring formulas (``wire_bytes``),
  and move nothing.
"""
from __future__ import annotations

import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

aten = torch.ops.aten

# products: flops = 2 * output elements * the contracted extent
_PRODUCTS = {aten.mm.default: lambda a: a[0].shape[-1],
             aten.bmm.default: lambda a: a[0].shape[-1],
             aten.addmm.default: lambda a: a[1].shape[-1],
             aten.baddbmm.default: lambda a: a[1].shape[-1],
             aten.convolution.default:
                 lambda a: math.prod(a[1].shape[1:])}
# allocations that write nothing
_EMPTY = {aten.empty.memory_format, aten.empty_like.default,
          aten.empty_strided.default, aten.new_empty.default,
          aten.new_empty_strided.default}
# copies: read and write the result
_COPIES = {aten.clone.default, aten._to_copy.default, aten.copy_.default,
           aten.copy.default, aten.index.Tensor, aten.gather.default,
           aten.embedding.default, aten.index_select.default}
# scatters: read-modify-write of the update (the operand at this index)
_SCATTERS = {aten.index_put.default: 2, aten.index_put_.default: 2,
             aten._index_put_impl_.default: 2,
             aten.scatter.src: 3, aten.scatter_.src: 3,
             aten.scatter_add.default: 3, aten.scatter_add_.default: 3,
             aten.index_copy.default: 3, aten.index_copy_.default: 3,
             aten.index_add.default: 3, aten.index_add_.default: 3}


def wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Ring-schedule wire traffic per device from the RESULT size (the
    reference's ``hlo_analysis._wire_bytes``)."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "all-gather":
        return result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(result_bytes * (n - 1))
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    return float(result_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors in ``x`` (an op's arguments or results: tensors, lists,
    tuples, dicts of them and scalars), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


class OpAnalysis(TorchDispatchMode):
    """The counters of one analysis; ``analyze`` runs a function under
    it.  Entering it also registers it with ``kernels.ANALYSES``, where
    the meta routes charge their work."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.traffic_by_op = defaultdict(float)
        self.coll = {}                  # kind -> [count, result_b, wire_b]
        self.kernels = {}               # name -> {"calls", "flops", "bytes"}
        self.live = 0
        self.peak_live = 0

    def __enter__(self):
        kernels.ANALYSES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.ANALYSES.remove(self)
        return super().__exit__(*exc)

    # ---------------------------------------------------------------- seams
    def charge(self, name: str, work: dict):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work["flops"]
        k["bytes"] += work["bytes"]
        self.flops += work["flops"]
        self.traffic += work["bytes"]
        self.traffic_by_op[name] += work["bytes"]

    def collective(self, kind: str, result_bytes: float, n: int,
                   times: int = 1):
        c = self.coll.setdefault(kind, [0, 0.0, 0.0])
        c[0] += times
        c[1] += times * result_bytes
        c[2] += times * wire_bytes(kind, result_bytes, n)

    def snapshot(self) -> dict:
        """The additive counters, for ``add``."""
        return {"flops": self.flops, "traffic": self.traffic,
                "traffic_by_op": dict(self.traffic_by_op),
                "coll": {k: list(v) for k, v in self.coll.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}

    def add(self, before: dict, after: dict, times: int = 1):
        """Count ``times`` more of what ran between two snapshots (a
        microbatch that runs as the one before it)."""
        self.flops += times * (after["flops"] - before["flops"])
        self.traffic += times * (after["traffic"] - before["traffic"])
        for k, v in after["traffic_by_op"].items():
            self.traffic_by_op[k] += times * (v - before["traffic_by_op"]
                                              .get(k, 0.0))
        for k, v in after["coll"].items():
            old = before["coll"].get(k, [0, 0.0, 0.0])
            c = self.coll.setdefault(k, [0, 0.0, 0.0])
            for i in range(3):
                c[i] += times * (v[i] - old[i])
        for k, v in after["kernels"].items():
            old = before["kernels"].get(k, {})
            c = self.kernels.setdefault(k, {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0})
            for f in c:
                c[f] += times * (v[f] - old.get(f, 0))

    # ------------------------------------------------------------- counting
    def _free(self, nbytes: int):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(kwargs, _tensors(args, []))
        for t in ins:
            if not t.is_meta and t.dim():
                raise ValueError(f"op analysis: {func} takes a tensor on "
                                 f"{t.device}; the analysis counts meta "
                                 f"tensors only")
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        held = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in held]
        for t in fresh:                 # the run's own tensors, while alive
            st = t.untyped_storage()
            if id(st) in held:
                continue
            held.add(id(st))
            self.live += st.nbytes()
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._free, st.nbytes())
        if func in _PRODUCTS:
            self.flops += 2.0 * outs[0].numel() * _PRODUCTS[func](args)
        if func in _EMPTY or (not fresh and outs
                              and not func._schema.is_mutable):
            return out                  # an allocation, or a view
        if func in _COPIES:
            t = 2.0 * sum(_nbytes(o) for o in outs)
        elif func in _SCATTERS:
            t = 2.0 * _nbytes(args[_SCATTERS[func]])
        else:
            t = float(sum(_nbytes(i) for i in ins)
                      + sum(_nbytes(o) for o in outs))
        name = func.overloadpacket.__name__
        self.traffic += t
        self.traffic_by_op[name] += t
        return out

    def stats(self) -> dict:
        coll = {k: {"count": v[0], "result_bytes": v[1], "wire_bytes": v[2]}
                for k, v in self.coll.items()}
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "collectives": coll,
                "total_wire_bytes": sum(v["wire_bytes"]
                                        for v in coll.values()),
                "traffic_by_op": dict(self.traffic_by_op),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_live_bytes": self.peak_live}


def current():
    """The innermost analysis in progress, or None."""
    return kernels.ANALYSES[-1] if kernels.ANALYSES else None


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` on meta tensors under a fresh
    ``OpAnalysis``; returns its ``stats()`` and, under ``result``, what
    ``fn`` returned.  A tensor argument on a device raises."""
    for t in _tensors(kwargs, _tensors(list(args), [])):
        if not t.is_meta:
            raise ValueError(f"op analysis counts meta tensors only, not a "
                             f"tensor on {t.device}")
    with OpAnalysis() as an:
        result = fn(*args, **kwargs)
    return {**an.stats(), "result": result}
