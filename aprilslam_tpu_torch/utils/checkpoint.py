"""Checkpoint/resume for the SLAM state (port of
``aprilslam_tpu/utils/checkpoint.py``).

Saves and restores the step state in any of its three forms: a lone
``GraphState`` (chain and joint estimators), ``(GraphState, BAState)``, and
the pgo 4-tuple ``(GraphState, BAState, PgoState, TagGraphState)``. Each
state is kept as its fields by name (a nested dataclass as a nested dict),
as CPU tensors written with ``torch.save``, one directory per step, the
oldest removed beyond ``max_to_keep``.

The JAX package writes its checkpoints with orbax; this module does not
read them (carry a JAX state across with ``convert.state_from_jax_numpy``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import torch

_STATE_FILE = "state.pt"
_META_FILE = "metadata.json"
_PREFIX = "step_"


def _fields_to_cpu(state) -> dict:
    return {
        f.name: (_fields_to_cpu(v) if dataclasses.is_dataclass(v := getattr(state, f.name))
                 else v.detach().cpu().clone())
        for f in dataclasses.fields(state)
    }


def _fields_onto(template, saved: dict):
    """A state of ``template``'s type with the saved fields, each on the
    device of the template's field and checked against its shape and dtype."""
    out = {}
    for f in dataclasses.fields(template):
        tv, sv = getattr(template, f.name), saved[f.name]
        if dataclasses.is_dataclass(tv):
            out[f.name] = _fields_onto(tv, sv)
            continue
        if sv.shape != tv.shape or sv.dtype != tv.dtype:
            raise ValueError(
                f"{type(template).__name__}.{f.name}: checkpoint holds {tuple(sv.shape)} {sv.dtype}, "
                f"the template {tuple(tv.shape)} {tv.dtype}")
        out[f.name] = sv.to(tv.device)
    return type(template)(**out)


class CheckpointManager:
    """Step-numbered checkpoints of a SLAM state under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and name[len(_PREFIX):].isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _STATE_FILE)):
                steps.append(int(name[len(_PREFIX):]))
        return sorted(steps)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step}")

    def save(self, step: int, state: Any, metadata: dict | None = None) -> None:
        single = dataclasses.is_dataclass(state)
        payload = {"single": single,
                   "states": [_fields_to_cpu(s) for s in ([state] if single else state)]}
        # Written in a scratch directory and renamed into place, so a
        # checkpoint is either whole or absent.
        tmp = tempfile.mkdtemp(prefix=".tmp_", dir=self.directory)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        if metadata is not None:
            with open(os.path.join(tmp, _META_FILE), "w") as f:
                json.dump(metadata, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> Any:
        """The saved state rebuilt with ``template``'s structure, each field
        on the template's device. Raises FileNotFoundError when there is no
        checkpoint (at ``step``, or at all)."""
        step = step if step is not None else self.latest_step()
        if step is None or step not in self._steps():
            raise FileNotFoundError(f"no checkpoint{'' if step is None else f' at step {step}'} "
                                    f"under {self.directory}")
        payload = torch.load(os.path.join(self._step_dir(step), _STATE_FILE), weights_only=True)
        single = dataclasses.is_dataclass(template)
        templates = [template] if single else list(template)
        if payload["single"] != single or len(payload["states"]) != len(templates):
            raise ValueError(f"checkpoint at step {step} holds another state form than the template")
        states = [_fields_onto(t, s) for t, s in zip(templates, payload["states"])]
        return states[0] if single else tuple(states)

    def close(self) -> None:
        """Nothing is left open between calls; kept for the JAX API."""
