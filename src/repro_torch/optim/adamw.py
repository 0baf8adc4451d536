"""AdamW with a global-norm clip and optional compressed optimizer state,
the port of the JAX package's ``optim/adamw.py``.

``state_dtype``:
  float32  — classic m/v
  bfloat16 — halves the optimizer's memory
  int8     — block-wise absmax-quantized m/v (8-bit-Adam style): an int8
             payload of the parameter's shape, fp32 scales on a
             ``[..., n_blocks]`` tail (blocks of ``QBLOCK`` along the last
             axis)

Parameters, gradients and state are dicts keyed by parameter name.
``opt_state_specs`` gives the state's partition specs: each moment takes
its parameter's spec plus ZeRO sharding over the data axes
(``parallel/sharding.py::zero_spec``), computed on the reference's stacked
shapes.  The
update is plain tensor code under ``no_grad`` (the JAX package leaves it to
XLA, outside any Pallas kernel) and writes the parameters and the state in
place, where the JAX arrays are replaced: at full width that saves a copy
of every parameter and moment.  The arithmetic is the JAX update's, in its
order, in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

QBLOCK = 256
UPDATE_SLICE = 1 << 26     # most elements of one slice of the update


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"  # float32 | bfloat16 | int8
    grad_clip: float = 1.0


# ---------------------------------------------------------------- int8 state
def _nblocks(last: int) -> int:
    return max((last + QBLOCK - 1) // QBLOCK, 1)


def _q_init(x: torch.Tensor) -> dict:
    last = x.shape[-1] if x.dim() else 1
    lead = tuple(x.shape[:-1]) if x.dim() else ()
    return {"q": torch.zeros(tuple(x.shape) if x.dim() else (1,),
                             dtype=torch.int8, device=x.device),
            "scale": torch.zeros(lead + (_nblocks(last),),
                                 dtype=torch.float32, device=x.device)}


def _blocked(x: torch.Tensor, nb: int) -> torch.Tensor:
    """x [..., last] float32, zero-padded to nb * QBLOCK -> [..., nb, QBLOCK]."""
    pad = nb * QBLOCK - x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, pad))
    return xp.reshape(tuple(x.shape[:-1]) + (nb, QBLOCK))


def _q_enc(x: torch.Tensor) -> dict:
    if x.dim() == 0:
        x = x[None]
    last = x.shape[-1]
    blocks = _blocked(x.float(), _nblocks(last))
    scale = torch.clamp(blocks.abs().amax(dim=-1) / 127.0, min=1e-20)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    q = q.reshape(tuple(x.shape[:-1]) + (-1,))[..., :last].to(torch.int8)
    return {"q": q, "scale": scale}


def _q_dec(s: dict, shape) -> torch.Tensor:
    q = s["q"]
    last = q.shape[-1]
    blocks = _blocked(q.float(), s["scale"].shape[-1])
    x = (blocks * s["scale"][..., None]).reshape(tuple(q.shape[:-1]) + (-1,))
    return x[..., :last].reshape(shape)


def _leaf(name: str) -> str:
    """The reference's leaf of a port parameter: the layer index gone
    (``parallel/sharding.py::ref_leaf``)."""
    from repro_torch.parallel.sharding import ref_leaf
    return ref_leaf(name)


def _q_enc_stacked(group: list):
    """Encode the int8 moments of 0-d parameters that the reference stacks
    into one leaf (the vlm's per-layer gates), as that leaf: ``group`` is
    [(state, m, v)] in layer order, and the 256-blocks and their absmax
    run across the layers."""
    for k, i in (("m", 1), ("v", 2)):
        enc = _q_enc(torch.stack([g[i] for g in group]))
        for j, g in enumerate(group):
            g[0][k]["q"].copy_(enc["q"][j:j + 1])
            g[0][k]["scale"].copy_(enc["scale"][j // QBLOCK:j // QBLOCK + 1])


# --------------------------------------------------------------------- AdamW
def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    def one(p):
        if cfg.state_dtype == "int8":
            return {"m": _q_init(p), "v": _q_init(p)}
        dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
        return {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
                "v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    with torch.no_grad():
        dev = next(iter(params.values())).device if params else "cpu"
        return {"mu_nu": {k: one(p) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def _step(p, g, m, v, cfg: AdamWConfig, clip, b1c, b2c, lr):
    """The update of ``p`` (a parameter or a slice of one) in place from
    its gradient and float32 moments; returns the new moments."""
    g = g.float() * clip
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
    mhat = m / b1c
    vhat = v / b2c
    upd = mhat / (torch.sqrt(vhat) + cfg.eps)
    pf = p.float()
    p.copy_(pf - lr * (upd + cfg.weight_decay * pf))
    return m, v


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig,
                 lr, gnorm=None) -> tuple[dict, dict, dict]:
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, {"grad_norm": fp32 scalar}).  ``gnorm`` is the global
    gradient norm the clip takes, ``global_norm`` of ``grads`` unless given
    (the mesh step's ``params`` are a rank's blocks, whose norm is summed
    over the ranks: ``optim/zero.py``).  A parameter of more than
    ``UPDATE_SLICE`` elements (the MoE experts' [E, D, F], the largest
    models' embeddings) is updated a slice of its leading axis at a time,
    so its float32 temporaries stay that small; each element's arithmetic
    is the same, and so are the int8 moments' blocks, which run along the
    last axis.  The int8 moments of 0-d parameters are encoded as the
    reference's stacked leaf of them (one absmax a 256-block across the
    layers), ``params`` giving each leaf's parameters in layer order."""
    count = state["count"] + 1
    if gnorm is None:
        gnorm = global_norm(grads[k] for k in params)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    cf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)
    consts = (cfg, clip, b1c, b2c, lr)
    int8 = cfg.state_dtype == "int8"
    scalars: dict = {}      # int8: the 0-d parameters' moments by leaf
    for name, p in params.items():
        s = state["mu_nu"][name]
        moments = ([s[k][f] for k in ("m", "v") for f in ("q", "scale")]
                   if int8 else [s["m"], s["v"]])
        parts = (p, grads[name], *moments)
        if p.numel() > UPDATE_SLICE:
            n = max(1, UPDATE_SLICE // (p.numel() // len(p)))
            parts = (t.split(n) for t in parts)
        else:
            parts = ((t,) for t in parts)
        for pp, gg, *ms in zip(*parts):
            if int8:
                mq, mscale, vq, vscale = ms
                m, v = _step(pp, gg, _q_dec({"q": mq, "scale": mscale},
                                            pp.shape),
                             _q_dec({"q": vq, "scale": vscale}, pp.shape),
                             *consts)
                if p.dim() == 0:
                    scalars.setdefault(_leaf(name), []).append((s, m, v))
                    continue
                for (q, sc), val in (((mq, mscale), m), ((vq, vscale), v)):
                    enc = _q_enc(val)
                    q.copy_(enc["q"])
                    sc.copy_(enc["scale"])
                continue
            sm, sv = ms
            m, v = _step(pp, gg, sm.float(), sv.float(), *consts)
            sm.copy_(m)
            sv.copy_(v)
    for group in scalars.values():
        _q_enc_stacked(group)
    state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm}


# --------------------------------------------------------------- state specs
def opt_state_specs(p_specs: dict, params, mesh, cfg: AdamWConfig,
                    zero: bool = True, model_cfg=None,
                    stacked: bool = False) -> dict:
    """Partition specs of ``adamw_init``'s state (ZeRO over the data axes):
    ``{"mu_nu": {name: {"m": spec, "v": spec}}, "count": Spec()}``, where
    an int8 moment's spec is ``{"q": spec, "scale": spec}``, the scale's
    sanitised on its ``[..., nblocks]`` shape.  ``params`` is a model or a
    {name: tensor | shape} dict and ``p_specs`` its per-layer specs; with
    ``model_cfg`` (a model's own by default) each spec is computed on the
    reference's stacked shape, as ``sanitize_specs`` does, and its stacked
    entries dropped; with ``stacked`` ``p_specs`` are stacked specs
    (``param_specs(..., stacked=True)``) and so are the results."""
    from repro_torch.parallel import sharding as sh

    model_cfg = sh._cfg(params, model_cfg)

    def one(name, shape):
        dims = sh.stack_dims(name, model_cfg)
        k, shape = len(dims), dims + shape
        spec = (sh.Spec(*p_specs[name]) if stacked
                else sh._stacked(p_specs[name], k))
        base = sh.zero_spec(spec, shape, mesh) if zero else spec
        cut = (lambda s: sh.Spec(*s)) if stacked else (
            lambda s: sh.per_layer(s, k))
        if cfg.state_dtype == "int8":
            last = shape[-1] if shape else 1
            scale_shape = shape[:-1] + ((last + QBLOCK - 1) // QBLOCK,)
            scale = sh.sanitize_spec(base, scale_shape, mesh)
            return {"q": cut(base), "scale": cut(scale)}
        return cut(base)

    mu_nu = {}
    for name, shape in sh._shapes(params).items():
        s = one(name, shape)
        mu_nu[name] = {"m": s, "v": s}
    return {"mu_nu": mu_nu, "count": sh.Spec()}
