"""Fault-tolerant checkpointing in the JAX package's on-disk layout.

Layout:  <dir>/step_<N>/   one .npy per array, keyed by its path in the
         tree (``params/<state-dict name>``, ``opt/mu_nu/<name>/m``, ...;
         the file name is the key with ``/`` -> ``__``), and manifest.json
         with ``step``, ``time``, ``metadata`` and ``arrays`` {key: {file,
         shape, dtype}}.  A checkpoint is written under a ``.tmp`` name and
         published by rename, so a crash mid-save never corrupts the latest
         one; the newest ``keep`` are kept.  The JAX package's
         ``CheckpointManager`` lists these steps and reads their manifests.

numpy has no bfloat16 here: a bf16 tensor is saved as its uint16 bits, with
``"dtype": "bfloat16"`` in the manifest, and viewed back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: dict, metadata: Optional[dict] = None):
        """Write every tensor of the nested dict ``tree``; returns the
        step's directory."""
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(),
                    "metadata": metadata or {}, "arrays": {}}
        for key, leaf in _flatten(tree).items():
            arr, dtype = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, tree: dict, step: Optional[int] = None) -> Any:
        """Copy the checkpoint of ``step`` (default: the latest) into the
        tensors of ``tree`` in place, each on its own device; returns
        ``tree``.  Every key, shape and dtype must match the manifest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        arrays = self.metadata(step)["arrays"]
        flat = _flatten(tree)
        if set(flat) != set(arrays):
            raise KeyError(f"checkpoint {d} holds other arrays: missing "
                           f"{sorted(set(flat) - set(arrays))}, unexpected "
                           f"{sorted(set(arrays) - set(flat))}")
        for key, dst in flat.items():
            info = arrays[key]
            src = _from_numpy(np.load(os.path.join(d, info["file"])),
                              info["dtype"])
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{key}: checkpoint {tuple(src.shape)} "
                                 f"{src.dtype} != {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src)
        return tree

    def metadata(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "manifest.json")) as f:
            return json.load(f)
