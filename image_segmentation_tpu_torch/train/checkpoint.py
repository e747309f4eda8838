"""Checkpoint and resume, with write-behind saves.

Counterpart of image_segmentation_tpu/train/checkpoint.py (the
reference's contract, utils/training.py:453-618):
  * a full checkpoint directory holds `state.pt` (the model's parameters
    and BatchNorm statistics, the optimizer's and LR schedule's state,
    the step; `torch.save`) and `meta.json` (epoch, best metrics, the
    metrics history, notes);
  * the weights-only `MO_<name>` directory holds `weights.pt`, the
    model's state_dict (parameters and BN statistics), for serving;
  * a missing or unreadable meta degrades to a fresh history.
JSON replaces JAX's msgpack and torch.save replaces orbax: neither
msgpack nor orbax is on the card's machine.

Saves are write-behind with latest-wins slots (JAX checkpoint.py:39-120):
`save_checkpoint_async` copies every tensor on the device — at once, on
the caller's stream, before the caller's next optimizer step changes the
parameters in place — and a `CheckpointWriter` thread fetches the copies
to the host and writes them while training goes on. A newer save to the
same slot replaces an older one that has not started; `wait()` returns
once every save is on disk and raises the first error.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional

import torch

from image_segmentation_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"
WEIGHTS_FILE = "weights.pt"


def _map_tensors(fn, tree):
    """`fn` applied to every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def state_payload(state: TrainState) -> dict:
    """The live state's tensors and counters (references, not copies)."""
    return {
        "model": state.model.state_dict(),
        "optimizer": None if state.optimizer is None else state.optimizer.state_dict(),
        "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
        "step": int(state.step),
    }


def _write(path: str, payload: dict, meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save(payload, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f)


def save_params_only(path: str, model_state: dict) -> None:
    """The weights-only copy (the reference's MO_<name>): parameters and BN
    running statistics, so that a restored model evaluates with its
    trained statistics."""
    os.makedirs(path, exist_ok=True)
    torch.save(_map_tensors(torch.Tensor.cpu, model_state), os.path.join(path, WEIGHTS_FILE))


def _meta(epoch, best, history, notes) -> dict:
    return {"epoch": int(epoch), "best": dict(best or {}),
            "history": _jsonable(history or {}), "notes": notes}


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "tolist"):  # numpy arrays and scalars
        return v.tolist()
    return v


def load_model_state(path: str, device="cpu") -> dict:
    """The model state_dict of a full checkpoint or a weights-only `MO_`
    directory."""
    weights = os.path.join(path, WEIGHTS_FILE)
    if os.path.exists(weights):
        return torch.load(weights, map_location=device, weights_only=True)
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)["model"]


def restore_checkpoint(path: str, state: TrainState):
    """Restore a full checkpoint into `state` in place. Returns (state,
    meta); a missing or unreadable meta.json gives a fresh one."""
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    if state.optimizer is not None and payload.get("optimizer") is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    if state.scheduler is not None and payload.get("scheduler") is not None:
        state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload.get("step", 0))
    meta = {"epoch": 0, "best": {}, "history": {}, "notes": ""}
    try:
        with open(os.path.join(path, META_FILE)) as f:
            meta.update(json.load(f))
    except (OSError, ValueError) as e:  # keep the weights, start a fresh history
        print(f"Warning: could not read checkpoint meta ({e}); resuming with fresh history.")
    return state, meta


class CheckpointWriter:
    """One background thread that runs submitted saves in order; a newer
    save in a slot replaces an unstarted older one (latest wins). Memory in
    flight is one running and one pending snapshot per slot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[str, Callable[[], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None], slot: str = "default") -> None:
        with self._lock:
            # pop then insert, so a replaced slot moves to the queue's tail
            self._pending.pop(slot, None)
            self._pending[slot] = fn
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._run, name="ckpt-save", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._thread = None
                    return
                fn = self._pending.pop(next(iter(self._pending)))
            try:
                fn()
            except Exception as e:  # raised by the next wait()
                with self._lock:
                    if self._error is None:
                        self._error = e

    def wait(self) -> None:
        """Block until every submitted save is on disk; raise the first error."""
        while True:
            with self._lock:
                t = self._thread
            if t is None:
                break
            t.join()
            with self._lock:
                if self._thread is t:  # it died without clearing itself
                    self._thread = None
                    self._pending.clear()
                    self._error = self._error or RuntimeError("checkpoint writer died")
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err


def save_checkpoint_async(writer: CheckpointWriter, path: str, state: TrainState, *,
                          epoch: int, best: Optional[Dict[str, float]] = None,
                          history: Optional[Dict[str, Any]] = None, notes: str = "",
                          params_only_path: Optional[str] = None, extra_paths: tuple = (),
                          slot: str = "default") -> None:
    """Snapshot the state on the device now; fetch it once and write it at
    `path`, each of `extra_paths` and, if given, the weights-only copy at
    `params_only_path`, on the writer's thread."""
    snap = _map_tensors(lambda t: t.detach().clone(), state_payload(state))
    done = None
    if torch.cuda.is_available() and next(state.model.parameters()).is_cuda:
        # the writer thread fetches on its own stream: wait for the copies
        done = torch.cuda.Event()
        done.record()
    meta = _meta(epoch, best, history, notes)

    def do_save():
        if done is not None:
            done.synchronize()
        host = _map_tensors(torch.Tensor.cpu, snap)  # the one device → host fetch
        for p in (path,) + tuple(extra_paths):
            _write(p, host, meta)
        if params_only_path is not None:
            save_params_only(params_only_path, host["model"])

    writer.submit(do_save, slot=slot)
