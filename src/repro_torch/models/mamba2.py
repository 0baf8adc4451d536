"""Mamba2 / SSD (state-space duality) blocks, the port of the JAX package's
``models/mamba2.py``.

The full-sequence path (prefill and training) sends the SSD scan to the
``ssd_scan`` op (the CUDA kernels on CUDA tensors, the plain versions on
the CPU; differentiable), which also returns the final state for the
decode cache.  Decode is the one-token recurrence ``ssd_decode_step`` in
plain PyTorch, as in the JAX package.  The conv, the gated norm and
``softplus`` stay plain PyTorch under autograd: the JAX package has no
kernel for them either.

Dtypes follow the JAX policy: ``A_log``, ``dt_bias`` and the norm scale
stay float32 (``A = -exp(A_log)`` and ``softplus(dt + dt_bias)`` are
float32, and a 256-step cumulative decay amplifies any rounding of them);
the projections, ``conv_w``, ``conv_b`` and ``D`` are stored in the
policy's ``param_dtype`` and cast to the activations' dtype at use, as the
JAX ``.astype(u.dtype)`` does.  Training keeps them float32; serving stores
them in the compute dtype, where the cast is the weight itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import gated_rmsnorm
from repro_torch.models.lm import RMSNorm, param


# --------------------------------------------------------------------------- #
# Core SSD math (head-dim P, state N), fp32 inside
# --------------------------------------------------------------------------- #
def ssd_sequential(x, dt, A, Bm, Cm, initial_state=None):
    """Step-recurrence oracle: S_t = exp(dt_t A) S_{t-1} + dt_t B_t ⊗ x_t,
    y_t = C_t . S_t.  Returns (y [B,L,H,P] in x's dtype, state fp32)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    S = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(L):
        y, S = ssd_decode_step(S, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y.float())
    return torch.stack(ys, dim=1).to(x.dtype), S


def ssd_decode_step(state, xt, dtt, A, Bt, Ct):
    """One-token recurrence.  state [B,H,P,N] fp32; xt [B,H,P]; dtt [B,H];
    Bt/Ct [B,N].  Returns (y [B,H,P] in xt's dtype, new state)."""
    dtt = dtt.float()
    decay = torch.exp(dtt * A.float()[None, :])
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtt, Bt.float(), xt.float())
    y = torch.einsum("bn,bhpn->bhp", Ct.float(), state)
    return y.to(xt.dtype), state


# --------------------------------------------------------------------------- #
# Depthwise causal conv (width W, small) via shifts
# --------------------------------------------------------------------------- #
def causal_conv(x, w, b, history=None):
    """x [B,L,C]; w [W,C]; b [C]; history [B,W-1,C] or None (zeros).
    Depthwise, causal, then SiLU; each op rounds to x's dtype, as the JAX
    package's does."""
    W, L = w.shape[0], x.shape[1]
    if history is None:
        history = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    w = w.to(x.dtype)
    y = xp[:, 0:L] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + L] * w[i]
    return F.silu(y + b.to(x.dtype))


# --------------------------------------------------------------------------- #
# Full Mamba2 block
# --------------------------------------------------------------------------- #
class Mamba2Block(nn.Module):
    """The JAX ``mamba_init`` tree: ``in_z, in_x, in_B, in_C, in_dt,
    conv_w, conv_b, dt_bias, A_log, D, norm.scale, out``; ``dtype`` is the
    stored dtype of the projections, ``conv_w``, ``conv_b`` and ``D``."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 norm_dtype=torch.float32):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = torch.float32
        self.in_z = param((d, di), dtype, device)
        self.in_x = param((d, di), dtype, device)
        self.in_B = param((d, n), dtype, device)
        self.in_C = param((d, n), dtype, device)
        self.in_dt = param((d, h), dtype, device)
        self.conv_w = param((cfg.conv_width, di + 2 * n), dtype, device)
        self.conv_b = param((di + 2 * n,), dtype, device)
        self.dt_bias = param((h,), f32, device)
        self.A_log = param((h,), f32, device)
        self.D = param((h,), dtype, device)
        self.norm = RMSNorm(di, device, norm_dtype)
        self.out = param((di, d), dtype, device)


def _project(p: Mamba2Block, u):
    return tuple(u @ w.to(u.dtype)
                 for w in (p.in_z, p.in_x, p.in_B, p.in_C, p.in_dt))


def _dt_and_A(p: Mamba2Block, dt):
    """softplus(dt + dt_bias) and A = -exp(A_log), both float32."""
    return (F.softplus(dt.float() + p.dt_bias.float()),
            -torch.exp(p.A_log.float()))


def _finish(p: Mamba2Block, y, xh, z, cfg: ModelConfig):
    """y + D x, gated norm, output projection.  y, xh [..., H, P]."""
    y = y + xh * p.D.to(y.dtype)[:, None]
    y = y.reshape(*y.shape[:-2], cfg.d_inner)
    y = gated_rmsnorm(p.norm.scale, y, z, cfg.norm_eps)
    return y @ p.out.to(y.dtype)


def mamba_apply(p: Mamba2Block, u, cfg: ModelConfig, return_state=False):
    """u [B,L,D] -> [B,L,D]: the full-sequence (prefill and training)
    path, from a zero state.  With ``return_state`` also the cache
    ``{"state": [B,H,P,N] fp32, "conv": [B,W-1,di+2N]}``."""
    B, L, _ = u.shape
    di, n, h, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xp, Bp, Cp, dt = _project(p, u)
    xBC_pre = torch.cat([xp, Bp, Cp], dim=-1)
    xBC = causal_conv(xBC_pre, p.conv_w, p.conv_b)
    xp, Bp, Cp = torch.split(xBC, [di, n, n], dim=-1)
    dt, A = _dt_and_A(p, dt)
    xh = xp.reshape(B, L, h, P).contiguous()
    y, state = ssd_scan(xh, dt, A, Bp.contiguous(), Cp.contiguous(),
                        chunk=cfg.ssm_chunk)
    out = _finish(p, y, xh, z, cfg)
    if not return_state:
        return out
    # conv history: the last W-1 PRE-activation xBC columns (zeros before
    # the first token when L < W-1)
    W1 = cfg.conv_width - 1
    if L < W1:
        xBC_pre = torch.cat([xBC_pre.new_zeros(
            (B, W1 - L, xBC_pre.shape[-1])), xBC_pre], dim=1)
    return out, {"state": state, "conv": xBC_pre[:, -W1:]}


def mamba_decode_step(p: Mamba2Block, u, state, conv, cfg: ModelConfig):
    """u [B,1,D]; ``state`` [B,H,P,N] fp32 and ``conv`` [B,W-1,di+2N] of
    one layer.  Returns (out [B,1,D], new state, new conv)."""
    B = u.shape[0]
    di, n, h, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xp, Bp, Cp, dt = _project(p, u)
    xBC = torch.cat([xp, Bp, Cp], dim=-1)                 # [B,1,C]
    window = torch.cat([conv.to(xBC.dtype), xBC], dim=1)  # [B,W,C]
    conv_out = (torch.einsum("bwc,wc->bc", window, p.conv_w.to(u.dtype))
                + p.conv_b.to(u.dtype))
    conv_out = F.silu(conv_out)
    xp, Bp, Cp = torch.split(conv_out, [di, n, n], dim=-1)
    dt, A = _dt_and_A(p, dt)
    xh = xp.reshape(B, h, P)
    y, state = ssd_decode_step(state, xh, dt[:, 0], A, Bp, Cp)
    out = _finish(p, y, xh, z[:, 0], cfg)[:, None]
    return out, state, window[:, 1:]
