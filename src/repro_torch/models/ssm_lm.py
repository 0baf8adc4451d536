"""Pure-SSM (Mamba2) language model: embed -> L x (norm + SSD block) ->
final norm -> head, with the decode cache of the SSM state and the conv
history.

Parameters follow the JAX package's tree, one module per layer instead of a
leading stacked axis: ``embed.embedding``, ``final_norm.scale``,
``layers.<i>.ln.scale``, ``layers.<i>.mamba.{in_z,in_x,in_B,in_C,in_dt,
conv_w,conv_b,dt_bias,A_log,D,norm.scale,out}`` and ``head.w`` (untied).

Every residual add is fused with the norm that follows it
(``fused_residual_rmsnorm``): ``x + mamba_out`` -> the next layer's ``ln``,
or ``final_norm`` after the last layer.  That is L launches per forward;
only the first layer's ``ln`` is a plain ``rmsnorm``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.lm import LM, RMSNorm, fused, remat


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device,
                 norm_dtype=torch.float32):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device, norm_dtype)
        self.mamba = M.Mamba2Block(cfg, dtype, device, norm_dtype)


def init_std(cfg: ModelConfig, name: str) -> Optional[float]:
    """The JAX init's normal stddev of the embedding, the head or a Mamba
    layer's parameter; None for the ones it sets to a constant."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "embed.embedding":
        return 1.0
    if name == "head.w" or leaf.startswith("in_"):
        return cfg.d_model ** -0.5
    if leaf == "conv_w":
        return cfg.conv_width ** -0.5
    if leaf == "out":
        return cfg.d_inner ** -0.5
    return None   # scales, conv_b, dt_bias, A_log, D


def init_const(cfg: ModelConfig, name: str, device):
    """The JAX init's constant of a Mamba layer's undrawn parameter."""
    leaf = name.rsplit(".", 1)[-1]
    h = cfg.ssm_heads
    lin = dict(dtype=torch.float32, device=device)
    if leaf == "dt_bias":   # softplus^-1 of dt in [1e-3, 1e-1]
        return torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h, **lin)))
    if leaf == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, h, **lin))
    return 0.0 if leaf == "conv_b" else 1.0   # D, norm scales


def init_cache(cfg: ModelConfig, layers: int, batch: int, dtype,
               device) -> dict:
    """``state`` [layers,B,H,P,N] fp32 and ``conv`` [layers,B,W-1,di+2N]
    in ``dtype``; neither has a length."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "state": torch.zeros(
            (layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device),
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def layer_apply(lyr: MambaLayer, h, cfg: ModelConfig, i: int, cache=None,
                caches=None):
    """Layer ``i``'s Mamba block on its normed input ``h``.  ``cache``
    given: one decode token, layer ``i``'s cache updated in place (where
    the JAX model returns a new cache); ``caches`` given: the full sequence,
    its prefill cache appended; neither: the full sequence."""
    if cache is not None:
        out, st, cv = M.mamba_decode_step(
            lyr.mamba, h, cache["state"][i], cache["conv"][i], cfg)
        cache["state"][i].copy_(st)
        cache["conv"][i].copy_(cv)
        return out
    if caches is not None:
        out, c = M.mamba_apply(lyr.mamba, h, cfg, return_state=True)
        caches.append(c)
        return out
    return M.mamba_apply(lyr.mamba, h, cfg)


class MambaLM(LM):
    """Projections, ``conv_w``, ``conv_b`` and ``D`` live in
    ``policy.param_dtype`` and are cast to the compute dtype at use (serving
    stores them in the compute dtype); ``A_log`` and ``dt_bias`` stay
    float32, the norm scales are stored in ``policy.norm_dtype``.
    ``loss`` trains: its forward and backward go through the SSD-scan and
    fused-norm kernels on CUDA tensors."""

    def __init__(self, cfg: ModelConfig, policy: L.Policy = L.Policy(),
                 device="cuda", remat: str = "none"):
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"MambaLM serves the ssm family, not {cfg.family!r}")
        super().__init__(cfg, policy, device, remat)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, policy.param_dtype, self.device,
                       policy.norm_dtype)
            for _ in range(cfg.num_layers))

    def _init_std(self, name: str) -> Optional[float]:
        return init_std(self.cfg, name)

    def _init_const(self, name: str, p: torch.Tensor):
        return init_const(self.cfg, name, self.device)

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _layers(self, x, cache=None, collect=False):
        """Runs every layer; returns the final-normed hidden state and, with
        ``collect``, each layer's prefill cache.  ``cache`` given: one
        decode token, the cache updated in place.  Under remat each layer
        is one recomputed unit from (h, x) to the next (h, x), as the JAX
        model remats each layer (serving, which collects or updates a
        cache, runs no remat)."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        h = L.rmsnorm(self.layers[0].ln.scale, x, eps)
        caches = [] if collect else None
        n = len(self.layers)
        for i, lyr in enumerate(self.layers):
            nxt = (self.layers[i + 1].ln if i + 1 < n
                   else self.final_norm).scale

            def unit(h, x, lyr=lyr, i=i, nxt=nxt):
                return fused(layer_apply(lyr, h, cfg, i, cache, caches), x,
                             nxt, eps)
            h, x = remat(self.remat, unit, h, x)
        return h, caches

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V], recording autograd's graph
        where grad mode is on (training)."""
        h, _ = self._layers(self._embed(tokens))
        return self._head(h)

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V]."""
        return self.logits(tokens)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` against ``labels``
        (the JAX ``MambaLM.loss``)."""
        return L.cross_entropy(self.logits(tokens), labels)

    # ------------------------------------------------------------------ #
    # Recurrent-state serving
    # ------------------------------------------------------------------ #
    def max_tokens(self, max_seq: int) -> Optional[int]:
        return None                     # the recurrent state has no length

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """``state`` [L,B,H,P,N] fp32 and ``conv`` [L,B,W-1,di+2N]; neither
        depends on ``max_seq``."""
        return init_cache(self.cfg, self.cfg.num_layers, batch,
                          self.policy.compute_dtype, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Full-sequence forward that fills ``cache`` in place; returns the
        last position's logits [B,V]."""
        h, caches = self._layers(self._embed(tokens), collect=True)
        for i, c in enumerate(caches):
            cache["state"][i].copy_(c["state"])
            cache["conv"][i].copy_(c["conv"])
        return self._head(h[:, -1])

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: int) -> torch.Tensor:
        """token [B,1] -> logits [B,V]; updates ``cache`` in place.  ``pos``
        is unused: the recurrent state carries the position."""
        h, _ = self._layers(self._embed(token), cache)
        return self._head(h[:, 0])
