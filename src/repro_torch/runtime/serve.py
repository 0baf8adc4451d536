"""Serving runtime: batched prefill + greedy decode with KV caches (dense,
audio; vlm, with the cross layers' K/V of the vision embeddings), recurrent
SSM state (ssm) or both (hybrid), FLARE daemon attached.

Runs on the CUDA card unless the caller asks for ``device="cpu"``; with no
card and no explicit CPU, ``Server`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.daemon import DaemonConfig, TracingDaemon
from repro_torch.models.layers import Policy
from repro_torch.models.registry import build_model, modality_inputs


@dataclass
class ServeConfig:
    model: ModelConfig
    batch: int = 4
    max_seq: int = 256
    compute_dtype: str = "bfloat16"
    seed: int = 0
    device: str = "cuda"
    # the daemon's spill; its extension picks the codec: .jsonl, .fcs (FCS
    # v1) or .fcs2 (FCS v2)
    log_path: Optional[str] = None

    def policy(self) -> Policy:
        return Policy(getattr(torch, self.compute_dtype))


class Server:
    """``params``: a state dict (see ``LM.load_params``); without one the
    weights are drawn from ``cfg.seed``.  The model is the config family's
    (``build_model``): ``TransformerLM``, ``MambaLM`` or ``Zamba2LM``."""

    def __init__(self, cfg: ServeConfig, params: Optional[dict] = None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Server: no CUDA device; pass ServeConfig(device='cpu') to "
                "serve on the CPU")
        self.model = build_model(cfg.model, cfg.policy(), self.device)
        if params is not None:
            self.model.load_params(params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.model.init(gen)
        self.daemon = TracingDaemon(DaemonConfig(
            rank=0, backend=f"{cfg.model.family}-serve",
            hang_timeout=300.0, log_path=cfg.log_path)).attach()

    def close(self):
        """Detach the daemon (final spill); later calls run untraced."""
        if self.daemon:
            self.daemon.detach()
            self.daemon = None

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def generate(self, prompts: np.ndarray, new_tokens: int = 16,
                 vision_embeds=None) -> np.ndarray:
        """prompts [B, S0] int -> [B, S0+new_tokens] greedy tokens.  The vlm
        family takes ``vision_embeds`` [B, vision_tokens, vision_d] (a
        tensor or an array), ones by default, as the JAX server."""
        B, S0 = prompts.shape
        limit = self.model.max_tokens(self.cfg.max_seq)
        if limit is not None and S0 + new_tokens > limit:
            raise ValueError(f"prompt {S0} + {new_tokens} new tokens exceeds "
                             f"the cache's {limit} positions (max_seq "
                             f"{self.cfg.max_seq})")
        d = self.daemon
        cache = self.model.init_cache(B, self.cfg.max_seq)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        shape = modality_inputs(self.cfg.model, B).get("vision_embeds")
        kw = {}
        if shape is not None:
            kw["vision_embeds"] = (
                torch.ones(shape, dtype=self.model.policy.compute_dtype,
                           device=self.device) if vision_embeds is None
                else torch.as_tensor(vision_embeds, device=self.device))
        if d:
            d.step_begin(0)
        logits = self.model.prefill(toks, cache, **kw)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [np.asarray(prompts)]
        # each step ends after its token reaches the host, so the step span
        # covers its device work
        tok_host = tok.cpu().numpy()
        if d:
            # the JAX server leaves step 0 open (step_begin(1) overwrites
            # it), so its prefill kernels nest under no step span
            d.step_end(tokens=B * S0)
        # as in the JAX server, the last decode's token goes unused
        for i in range(new_tokens):
            if d:
                d.step_begin(i + 1)
            out.append(tok_host)
            logits = self.model.decode_step(tok, cache, S0 + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
            tok_host = tok.cpu().numpy()
            if d:
                d.step_end(tokens=B)
        return np.concatenate(out, axis=1).astype(prompts.dtype)
