"""Checkpoints of the trainers' whole state, and the diffusers-layout export.

Counterpart of ``diffute_tpu/train/checkpoint.py``, without orbax:

- ``{output_dir}/checkpoint-{step}/state/`` holds a trainer's
  ``state_dict()`` (masters, AdamW moments and count, EMA, step, the draw
  generator): every tensor in ``state.safetensors`` under its path in the
  nested dict (``params/conv_in.weight``, ``opt/mu/...``), the scalars in
  ``state.json``.
- Beside it, the diffusers-layout export: ``unet/``, ``unet_ema/``,
  ``vae/`` and ``trocr/``, each a safetensors file plus ``config.json`` in
  fp32, with the JAX package's file names and keys, so a checkpoint is a
  self-contained pipeline directory.
- A checkpoint is finalized when ``state/`` exists.  The state is written
  under ``state.tmp/``, the export next, and ``state.tmp/`` is renamed to
  ``state/`` last, so a finalized checkpoint is a complete one; an
  unfinished directory is never "latest", and rotation never keeps it.

:class:`AsyncCheckpointManager` keeps JAX's ordering: the snapshot of the
state to host memory is synchronous (the next step updates the tensors in
place); the write, the export and the rotation run on one background
thread; a new save joins the previous one first, and ``wait()`` makes the
last one durable.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from diffute_tpu_torch.compat.diffusers import (
    TROCR_FILE,
    UNET_FILE,
    VAE_FILE,
    save_component,
    save_safetensors,
)

STATE = "state"
TENSORS = "state.safetensors"
SCALARS = "state.json"

ExportFn = Callable[[str, Dict[str, Any]], None]


# ---------------------------------------------------------------------------
# nested state <-> files
# ---------------------------------------------------------------------------


def _flatten(tree: Mapping, prefix: str = "") -> Tuple[Dict[str, torch.Tensor],
                                                       Dict[str, Any]]:
    tensors, scalars = {}, {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            t, s = _flatten(value, path + "/")
            tensors.update(t)
            scalars.update(s)
        elif isinstance(value, torch.Tensor):
            tensors[path] = value
        else:
            scalars[path] = value
    return tensors, scalars


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def snapshot(tree: Any) -> Any:
    """A copy of ``tree`` (nested dicts) with every tensor copied to host
    memory: later in-place updates of the originals do not reach it."""
    if isinstance(tree, Mapping):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if t.device.type == "cpu" else t.to("cpu")
    return tree


def _write_state(directory: str, host_state: Mapping) -> None:
    os.makedirs(directory, exist_ok=True)
    tensors, scalars = _flatten(host_state)
    save_safetensors(tensors, os.path.join(directory, TENSORS))
    with open(os.path.join(directory, SCALARS), "w") as f:
        json.dump(scalars, f, indent=1)


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The nested state saved under ``path`` (a checkpoint directory), its
    tensors in host memory; a trainer's ``load_state_dict`` copies them
    into its own."""
    from safetensors import safe_open

    directory = os.path.join(os.path.abspath(path), STATE)
    with open(os.path.join(directory, SCALARS)) as f:
        flat = json.load(f)
    with safe_open(os.path.join(directory, TENSORS), framework="pt") as f:
        for key in f.keys():
            flat[key] = f.get_tensor(key)
    return _unflatten(flat)


# ---------------------------------------------------------------------------
# checkpoint directories
# ---------------------------------------------------------------------------


def list_checkpoints(output_dir: str, finalized_only: bool = False):
    if not os.path.isdir(output_dir):
        return []
    dirs = [d for d in os.listdir(output_dir)
            if re.fullmatch(r"checkpoint-\d+", d)]
    if finalized_only:
        dirs = [d for d in dirs if _is_finalized(output_dir, d)]
    return sorted(dirs, key=lambda d: int(d.split("-")[1]))


def _is_finalized(output_dir: str, name: str) -> bool:
    """Restorable only once ``state.tmp/`` has been renamed to ``state/``."""
    return os.path.isdir(os.path.join(output_dir, name, STATE))


def latest_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(output_dir, finalized_only=True)
    return os.path.join(output_dir, ckpts[-1]) if ckpts else None


def checkpoint_step(path: str) -> int:
    """Step encoded in a checkpoint directory name (``.../checkpoint-N``);
    -1 when the basename is not ``checkpoint-N`` (a renamed copy, still
    restorable through its ``state/``)."""
    m = re.fullmatch(r"checkpoint-(\d+)", os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else -1


def resolve_resume(output_dir: str, resume: Optional[str]) -> Optional[str]:
    """'latest' -> the newest finalized checkpoint of ``output_dir``; a
    path -> itself when it is a directory."""
    if not resume:
        return None
    if resume == "latest":
        return latest_checkpoint(output_dir)
    return resume if os.path.isdir(resume) else None


def _rotate(output_dir: str, keep: int) -> None:
    """Keep the newest ``keep`` finalized checkpoints; remove the rest and
    any unfinished leftovers (nothing is in flight when this runs)."""
    finalized = list_checkpoints(output_dir, finalized_only=True)
    retain = set(finalized[-keep:]) if keep else set()
    for old in list_checkpoints(output_dir):
        if old not in retain:
            shutil.rmtree(os.path.join(output_dir, old), ignore_errors=True)


def _prepare(output_dir: str, step: int) -> str:
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    # the leftovers of a save at this step that never finished
    shutil.rmtree(os.path.join(path, STATE + ".tmp"), ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    return path


def _write(path: str, host_state: Mapping, export_fn: Optional[ExportFn],
           total_limit: Optional[int], times: Dict[str, float]) -> None:
    t0 = time.perf_counter()
    tmp = os.path.join(path, STATE + ".tmp")
    _write_state(tmp, host_state)
    t1 = time.perf_counter()
    if export_fn is not None:
        export_fn(path, host_state)
    t2 = time.perf_counter()
    final = os.path.join(path, STATE)
    shutil.rmtree(final, ignore_errors=True)  # an older save of this step
    os.replace(tmp, final)  # finalized
    if total_limit:
        _rotate(os.path.dirname(path), total_limit)
    times.update(write_seconds=t1 - t0, export_seconds=t2 - t1)


def save_checkpoint(output_dir: str, step: int, state: Mapping,
                    total_limit: Optional[int] = None,
                    export_fn: Optional[ExportFn] = None) -> str:
    """Save ``state`` (a trainer's ``state_dict()``) under
    ``{output_dir}/checkpoint-{step}`` and wait until it is finalized;
    ``export_fn(path, host_state)`` writes the diffusers layout beside it.
    Rotation keeps the newest ``total_limit`` finalized checkpoints."""
    path = _prepare(output_dir, step)
    _write(path, snapshot(state), export_fn, total_limit, {})
    return path


class AsyncCheckpointManager:
    """Checkpointing off the step loop: :meth:`save` snapshots the state to
    host memory and returns; one background thread writes it, runs the
    export and rotates.  A new save joins the previous one first (and
    re-raises its error), so rotation only ever runs with nothing in
    flight, and :meth:`wait` makes the last checkpoint durable.  Rotation
    runs once the new checkpoint is finalized and always keeps the newest
    finalized one.

    ``times`` holds the last save's seconds: ``snapshot_seconds`` (the
    synchronous part) and, once it is done, ``write_seconds`` and
    ``export_seconds``."""

    def __init__(self, output_dir: str, total_limit: Optional[int] = None):
        self.output_dir = os.path.abspath(output_dir)
        self.total_limit = total_limit
        self.times: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: list = []

    def save(self, step: int, state: Mapping,
             export_fn: Optional[ExportFn] = None) -> str:
        """Start saving ``state`` (a trainer's ``state_dict()``) under
        ``checkpoint-{step}``; ``export_fn(path, host_state)`` runs on the
        background thread with the host snapshot.  Returns the path."""
        self.wait()
        path = _prepare(self.output_dir, step)
        t0 = time.perf_counter()
        host_state = snapshot(state)
        self.times = {"snapshot_seconds": time.perf_counter() - t0}

        def run():
            try:
                _write(path, host_state, export_fn, self.total_limit,
                       self.times)
            except BaseException as e:  # re-raised by the next join
                self._error.append(e)

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()


# ---------------------------------------------------------------------------
# diffusers-layout export
# ---------------------------------------------------------------------------


def export_diffusers_layout(
    path: str,
    unet_params: Optional[Mapping[str, torch.Tensor]] = None,
    unet_ema_params: Optional[Mapping[str, torch.Tensor]] = None,
    vae_params: Optional[Mapping[str, torch.Tensor]] = None,
    unet_config: Optional[dict] = None,
    vae_config: Optional[dict] = None,
    trocr_params: Optional[Mapping[str, torch.Tensor]] = None,
    trocr_config: Optional[dict] = None,
) -> None:
    """Write ``unet/``, ``unet_ema/``, ``vae/`` and ``trocr/`` (those given)
    under ``path``: each ``diffusion_pytorch_model.safetensors`` (the
    TrOCR encoder's ``model.safetensors``) in fp32 and ``config.json``."""
    for sub, params, cfg, fname in (
            ("unet", unet_params, unet_config, UNET_FILE),
            ("unet_ema", unet_ema_params, unet_config, UNET_FILE),
            ("vae", vae_params, vae_config, VAE_FILE),
            ("trocr", trocr_params, trocr_config, TROCR_FILE)):
        if params is not None:
            save_component(os.path.join(path, sub), fname, params, cfg)
