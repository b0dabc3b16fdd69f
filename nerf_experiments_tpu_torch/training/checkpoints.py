"""Checkpoint/resume with `torch.save` / `torch.load(weights_only=True)`.

Reference behaviour (SURVEY.md §5.4): a checkpoint every N epochs with
save_top_k=-1 (`barf/run_barf.py:142-146`), hyperparameters alongside. Each
checkpoint is `ckpt_<step>.pt` holding `{"params": state_dict, "step": step}`
and, when a training state was saved, `"opt_state"`: the optimizer's state
(Adam moments, its step counts and the schedules' count), so a resumed run
continues bit for bit. An optional JSON sidecar `meta_<step>.json` holds
metadata. A params-only file restores into parameters or into a training
state's parameters alike.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch
from torch import nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, target, metadata: Optional[Dict[str, Any]] = None) -> None:
        """`target`: parameters (an nn.Module), or a training state with
        `.params`, `.optimizer` and `.step`."""
        blob = {"step": int(step)}
        if isinstance(target, nn.Module):
            blob["params"] = _to_cpu(target.state_dict())
        else:
            blob["params"] = _to_cpu(target.params.state_dict())
            blob["opt_state"] = _to_cpu(target.optimizer.state_dict())
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        if metadata is not None:
            with open(os.path.join(self.directory, f"meta_{step}.json"), "w") as f:
                json.dump(metadata, f, default=str)
        if self.keep is not None:
            for old in self.all_steps()[:-self.keep]:
                os.remove(self._path(old))

    def restore(self, target, step: Optional[int] = None):
        """Load a checkpoint into `target` (parameters, or a training state
        of the same structure: its parameters, optimizer state when the file
        has one, and step) and return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if isinstance(target, nn.Module):
            target.load_state_dict(blob["params"])
            return target
        target.params.load_state_dict(blob["params"])
        if "opt_state" in blob:
            target.optimizer.load_state_dict(blob["opt_state"])
        target.step = int(blob["step"])
        return target

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
