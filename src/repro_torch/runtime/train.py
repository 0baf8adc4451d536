"""Training runtime: the train step and the FLARE-instrumented training
loop, the port of the JAX package's ``runtime/train.py``.

``make_train_step`` builds the step (microbatched gradient accumulation,
AdamW with compressed state, LR schedule).  ``Trainer`` runs the loop: it
owns the dataloader, attaches the FLARE daemon, emits step/dataloader
events, checkpoints, and exposes fault hooks for the supervisor.  Its
trace carries the JAX Trainer's span names and meta keys.

Runs on the CUDA card unless the caller asks for ``device="cpu"``; with no
card and no explicit CPU, ``Trainer`` raises.  On the card the forward and
backward of causal self-attention (every family but ssm), of the SSD scan
(ssm and hybrid) and of the fused residual + RMSNorm are the port's
kernels.  The vlm family trains on a stub of its vision frontend, ones
[B, vision_tokens, vision_d], as the JAX Trainer does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.daemon import DaemonConfig, TracingDaemon
from repro_torch.core.events import EventKind
from repro_torch.data import DataConfig, ShardedLoader
from repro_torch.models.layers import Policy
from repro_torch.models.registry import build_model, modality_inputs
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.zero import ZeroAdamW
from repro_torch.parallel.collectives import ring_all_reduce
from repro_torch.parallel.mesh import dp_axes
from repro_torch.parallel.sharding import Spec, shard


@dataclass
class RunConfig:
    model: ModelConfig
    global_batch: int = 8
    seq_len: int = 128
    num_microbatches: int = 1
    steps: int = 50
    warmup_steps: int = 20
    peak_lr: float = 3e-4
    remat: str = "none"       # none | dots | full (models/lm.py ``remat``)
    attn_impl: str = "auto"   # auto | direct | chunked | folded | cp
    grad_accum_dtype: str = "float32"  # float32 | bfloat16 (microbatching)
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    flare: bool = True
    flare_log: Optional[str] = None  # spill: .jsonl, .fcs or .fcs2
    mask_mode: str = "none"   # none | naive | fast (Case-3)
    data_prefetch: bool = True  # False = synchronous dataloader (Case-3)
    device: str = "cuda"

    def policy(self) -> Policy:
        return Policy(getattr(torch, self.compute_dtype),
                      getattr(torch, self.param_dtype))


def loss_and_grads(model, batch: dict,
                   params: dict) -> tuple[torch.Tensor, dict]:
    """The mean cross-entropy of one batch (``tokens``, ``labels`` and the
    model's modality inputs, ``vision_embeds`` for the vlm family) and its
    gradient for each of ``params`` (name -> parameter)."""
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    loss = model.loss(batch["tokens"], batch["labels"], **extra)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def make_train_step(model, cfg: RunConfig, grads=loss_and_grads,
                    update=adamw_update, mesh=None):
    """Returns step_fn(opt_state, batch, step) -> (opt_state, metrics).

    The parameters are the model's own and are updated in place; ``batch``
    holds ``tokens`` and ``labels`` [B, S] on the model's device (and the
    vlm family's ``vision_embeds`` [B, T, vision_d]), each split on B into
    the microbatches; the metrics (``loss``, ``lr``, ``grad_norm``) are
    device scalars.  ``grads(model, batch, params)`` gives a microbatch's
    loss and gradients and ``update`` applies them (``loss_and_grads`` and
    ``adamw_update``; the dry-run counts one microbatch for all, and one
    parameter's update for each of the same shape).

    With a ``mesh`` (connected, ``parallel/mesh.py``) the step is the
    reference's mesh step (:func:`_mesh_step`)."""
    if mesh is not None:
        if grads is not loss_and_grads or update is not adamw_update:
            raise ValueError("make_train_step: a mesh step takes no grads= "
                             "or update=")
        return _mesh_step(model, cfg, mesh)
    params = dict(model.named_parameters())
    M = cfg.num_microbatches
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def step_fn(opt_state, batch, step):
        lr = warmup_cosine(step, peak_lr=cfg.peak_lr,
                           warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.steps).to(model.device)
        if M <= 1:
            loss, g = grads(model, batch, params)
        else:
            B = batch["tokens"].shape[0]
            if B % M:
                raise ValueError(f"batch {B} does not split into {M} "
                                 f"microbatches")
            gacc = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            parts = {k: v.chunk(M) for k, v in batch.items()}
            for i in range(M):
                lm, gm = grads(
                    model, {k: v[i] for k, v in parts.items()}, params)
                for k in gacc:
                    gacc[k] += gm[k].to(acc_dt)
                loss = loss + lm
            g = {k: a / M for k, a in gacc.items()}
            loss = loss / M
        _, opt_state, om = update(g, opt_state, params, cfg.opt, lr)
        return opt_state, {"loss": loss, "lr": lr, **om}

    return step_fn


def _mesh_step(model, cfg: RunConfig, mesh):
    """The mesh step: every rank of ``mesh`` calls ``step_fn(opt_state,
    batch, step)`` with the same global batch, and gets the reference's
    ``make_train_step(model, cfg, mesh)`` step (``src/repro/runtime/
    train.py``).  ``model`` is this rank's (``build_model(..., mesh=mesh)``:
    whole, its experts' block under expert parallelism); ``opt_state`` is
    ``step_fn.zero.init()``'s, the rank's ZeRO blocks (``optim/zero.py``).

    * The batch is split into the M microbatches first, and each rank takes
      its rows of each over the dp axes (``Spec(dp)``, the reference's
      layout of a microbatch), or all of them where the dp extent does not
      divide B / M (the reference replicates).
    * A rank's loss is the mean over its rows; the global loss is the mean
      over the dp ranks, held whole by every rank of the other axes, so
      each rank seeds its backward with 1 / (the mesh's ranks)
      (``parallel/collectives.py``'s convention); the MoE aux loss, held
      by every rank, takes the same seed.
    * Gradients are accumulated in ``grad_accum_dtype`` across the
      microbatches, each parameter's as soon as the backward has it
      (``ZeroAdamW.sink``), then reduced to each rank's block of its
      moments and the update runs there (``ZeroAdamW.update``); the
      parameters are gathered back whole.
    * The metrics are the global ones on every rank."""
    if model.cfg.num_experts and getattr(model, "mesh", None) is not mesh:
        raise ValueError("make_train_step: build the moe model with the "
                         "step's mesh (its experts' block and the aux "
                         "loss's mean over the data shards)")
    zero = ZeroAdamW(model, mesh, cfg.opt)
    params = dict(model.named_parameters())
    M = max(cfg.num_microbatches, 1)
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    dp = tuple(a for a in dp_axes(mesh) if mesh.shape[a] > 1)
    n_dp = int(np.prod([mesh.shape[a] for a in dp]))
    seed = 1.0 / mesh.size

    def rows(v):
        if n_dp > 1 and v.shape[0] % n_dp == 0:
            return shard(v, Spec(dp), mesh, zero.coords)
        return v

    def step_fn(opt_state, batch, step):
        lr = warmup_cosine(step, peak_lr=cfg.peak_lr,
                           warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.steps).to(model.device)
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        parts = {k: v.chunk(M) for k, v in batch.items()}
        acc = zero.zeros(params, acc_dt)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        hooks = zero.sink(acc, params)
        try:
            for i in range(M):
                mb = {k: rows(v[i]) for k, v in parts.items()}
                extra = {k: v for k, v in mb.items()
                         if k not in ("tokens", "labels")}
                lm = model.loss(mb["tokens"], mb["labels"], **extra)
                (lm * seed).backward()
                loss = loss + lm.detach()
        finally:
            for h in hooks:
                h.remove()
        if M > 1:
            loss = loss / M
        om = zero.update(acc, opt_state, params, lr, M)
        if dp:
            loss = loss.reshape(1)
            for a in dp:
                loss = ring_all_reduce(loss, mesh.group(a))[0]
            loss = loss[0] / n_dp
        return opt_state, {"loss": loss, "lr": lr, **om}

    step_fn.zero = zero
    return step_fn


class Trainer:
    """FLARE-instrumented training loop with checkpoint/restart support."""

    def __init__(self, cfg: RunConfig, fault_hook: Optional[Callable] = None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device; pass RunConfig(device='cpu') to "
                "train on the CPU")
        self.model = build_model(cfg.model, cfg.policy(), self.device,
                                 cfg.remat, attn_impl=cfg.attn_impl)
        self.step_fn = make_train_step(self.model, cfg)
        self.vision = self._vision_stub()
        self.fault_hook = fault_hook
        # built here and attached by ``train``, so that a caller can add
        # its sinks before the first event
        self.daemon = None
        if cfg.flare:
            self.daemon = TracingDaemon(DaemonConfig(
                rank=0, backend=f"{cfg.model.family}-train",
                log_path=cfg.flare_log, hang_timeout=300.0))
        self.ckpt = None
        if cfg.checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager
            self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        self.history: list[dict] = []

    # ------------------------------------------------------------------ #
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.model.init(gen)
        opt_state = adamw_init(self.params(), self.cfg.opt)
        return self.params(), opt_state, 0

    def restore_or_init(self):
        params, opt_state, start = self.init_state()
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.ckpt.restore({"params": params, "opt": opt_state})
            start = self.ckpt.latest_step() + 1
        return params, opt_state, start

    def _loader(self, start: int = 0) -> ShardedLoader:
        c = self.cfg
        return ShardedLoader(DataConfig(
            vocab_size=c.model.vocab_size, batch=c.global_batch,
            seq_len=c.seq_len, seed=c.seed, mask_mode=c.mask_mode),
            start_step=start)

    def _vision_stub(self) -> Optional[torch.Tensor]:
        """The vlm family's stubbed frontend: ones [B, vision_tokens,
        vision_d] in the compute dtype; None for the other families."""
        shape = modality_inputs(self.cfg.model,
                                self.cfg.global_batch).get("vision_embeds")
        if shape is None:
            return None
        return torch.ones(shape, dtype=self.cfg.policy().compute_dtype,
                          device=self.device)

    def _to_device(self, batch: dict) -> dict:
        """A loader batch on the device, with the vision stub where the
        model takes one."""
        out = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.long,
                                  device=self.device)
               for k in ("tokens", "labels")}
        if self.vision is not None:
            out["vision_embeds"] = self.vision
        return out

    # ------------------------------------------------------------------ #
    def train(self, steps: Optional[int] = None) -> list[dict]:
        cfg = self.cfg
        steps = steps if steps is not None else cfg.steps
        if self.daemon:
            self.daemon.attach()
        params, opt_state, start = self.restore_or_init()
        loader = self._loader(start)
        if cfg.data_prefetch:
            loader.start()
        tokens_per_step = cfg.global_batch * cfg.seq_len
        try:
            for step in range(start, steps):
                if self.daemon:
                    self.daemon.step_begin(step)
                    self.daemon.set_stack(["Trainer.train", "next_batch"])
                t0 = time.perf_counter()
                batch = loader.next_batch()
                t_data = time.perf_counter()
                if self.daemon:
                    self.daemon.record_span(
                        EventKind.DATALOADER, "dataloader.next_batch",
                        t0, t_data, tokens=tokens_per_step)
                    self.daemon.set_stack(["Trainer.train", "train_step"])
                tb = self._to_device(batch)
                if self.fault_hook:
                    self.fault_hook(step)
                t_dispatch = time.perf_counter()
                opt_state, metrics = self.step_fn(opt_state, tb, step)
                loss = float(metrics["loss"])  # sync point
                t_done = time.perf_counter()
                if self.daemon:
                    # whole-step device occupancy, from dispatch to the
                    # loss read, as the JAX Trainer's jitted step
                    self.daemon.record_span(
                        EventKind.KERNEL_COMPUTE, "train_step_exec",
                        t_dispatch, t_done,
                        flops=6.0 * cfg.model.active_param_count()
                        * tokens_per_step)
                    self.daemon.step_end(tokens=tokens_per_step, loss=loss)
                rec = {"step": step, "loss": loss,
                       "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_time_s": time.perf_counter() - t0,
                       "tokens_per_s": tokens_per_step
                       / max(time.perf_counter() - t0, 1e-9)}
                self.history.append(rec)
                if self.ckpt and (step + 1) % cfg.checkpoint_every == 0:
                    self.ckpt.save(step, {"params": params, "opt": opt_state},
                                   {"loss": loss})
        finally:
            loader.stop()
            if self.daemon:
                self.daemon.detach()
        self.final_state = (params, opt_state)
        return self.history
