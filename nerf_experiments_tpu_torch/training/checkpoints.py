"""Checkpoint/resume with `torch.save` / `torch.load(weights_only=True)`.

Reference behaviour (SURVEY.md §5.4): a checkpoint every N epochs with
save_top_k=-1 (`barf/run_barf.py:142-146`), hyperparameters alongside. Each
checkpoint is `ckpt_<step>.pt` holding `{"params": state_dict, "step": step}`,
plus an optional JSON sidecar `meta_<step>.json`. The optimizer state joins
the file with the training slice.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch
from torch import nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, params: nn.Module,
             metadata: Optional[Dict[str, Any]] = None) -> None:
        state = {k: v.detach().cpu() for k, v in params.state_dict().items()}
        tmp = self._path(step) + ".tmp"
        torch.save({"params": state, "step": int(step)}, tmp)
        os.replace(tmp, self._path(step))
        if metadata is not None:
            with open(os.path.join(self.directory, f"meta_{step}.json"), "w") as f:
                json.dump(metadata, f, default=str)
        if self.keep is not None:
            for old in self.all_steps()[:-self.keep]:
                os.remove(self._path(old))

    def restore(self, params: nn.Module, step: Optional[int] = None) -> nn.Module:
        """Load a checkpoint into `params` (same structure) and return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        params.load_state_dict(blob["params"])
        return params

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
