"""Checkpoint / resume for the training loop, in PyTorch.

Counterpart of ``kind_tpu_sim/models/checkpoint.py`` without orbax:

* the state saved is a train state of ``transformer.make_train_step``
  -- the parameters, the AdamW state and the step -- written with
  ``torch.save`` into one directory per step;
* a step directory is written under a hidden temporary name and then
  renamed with ``os.replace``, so a crash mid-write leaves nothing that
  ``latest_step`` would return;
* the newest ``max_to_keep`` (3) steps are kept;
* ``restore`` loads into a train state made by the same ``init_state``
  (the template), in place, on that state's device; ``abstract_like``
  makes a fresh template with another state's shapes and placement.

Over a mesh (a state of ``make_train_step(cfg, mesh=...)``) ``save`` is
collective: the shards of every parameter and AdamW moment are gathered
into whole tensors and rank 0 writes them, so the file is the one an
unsharded run writes. ``restore`` cuts each whole tensor for the
template's own mesh, which may differ from the one that saved it.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import pathlib
import shutil
import signal as _signal
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from kind_tpu_sim_torch.device import resolve
from kind_tpu_sim_torch.models import transformer as tf
from kind_tpu_sim_torch.parallel import tp

STATE_FILE = "state.pt"


class Preempted(RuntimeError):
    """Raised when a preemption signal interrupted training AFTER the
    in-flight step finished and a checkpoint was written; carries
    everything a supervisor needs to resume."""

    def __init__(self, step: int, losses: dict):
        self.step = step
        self.losses = dict(losses)
        super().__init__(
            f"training preempted at step {step} "
            f"(checkpoint saved; resume from latest_step)")


class PreemptionGuard:
    """SIGTERM-to-flag adapter.

    A machine about to be preempted gets SIGTERM shortly before; dying
    mid-step loses the step and risks a torn save. The guard converts
    the signal into a flag the train loop polls at step boundaries, so
    the loop finishes its step, checkpoints, and exits loudly. Signal
    handlers only install on the main thread; elsewhere the guard still
    works through ``trip()``."""

    def __init__(self):
        self._tripped = threading.Event()

    def trip(self, *_args) -> None:
        self._tripped.set()

    @property
    def preempted(self) -> bool:
        return self._tripped.is_set()


@contextlib.contextmanager
def preemption_guard(signals=(getattr(_signal, "SIGTERM", None),)):
    """Install a PreemptionGuard over ``signals`` for the block,
    restoring prior handlers on exit. Off the main thread (where
    signal.signal raises), the guard degrades to trip()-only."""
    guard = PreemptionGuard()
    previous = []
    for sig in signals:
        if sig is None:
            continue
        try:
            previous.append((sig, _signal.signal(sig, guard.trip)))
        except ValueError:  # not the main thread
            pass
    try:
        yield guard
    finally:
        for sig, handler in previous:
            _signal.signal(sig, handler)


def _steps(path: pathlib.Path) -> list:
    """The complete step directories under ``path``, in step order."""
    if not path.exists():
        return []
    steps = []
    for child in path.iterdir():
        if child.is_dir() and not child.name.startswith("."):
            try:
                steps.append(int(child.name))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory) -> Optional[int]:
    """Newest complete checkpoint step, or None when none exists. A pure
    query: it creates nothing."""
    steps = _steps(pathlib.Path(directory))
    return steps[-1] if steps else None


def save(directory, step: int, state: Dict[str, Any], *,
         max_to_keep: int = 3) -> None:
    """Write the train state ``state`` (``{"params", "opt"}``, as
    ``make_train_step``'s ``init_state`` returns it) for ``step``, then
    drop all but the newest ``max_to_keep`` steps.

    Atomic: the step directory appears only once its file is complete
    and flushed to disk. A step already saved is refused
    (FileExistsError), as orbax refuses it."""
    path = pathlib.Path(directory)
    final = path / str(step)
    if final.exists():
        raise FileExistsError(f"checkpoint {final} already exists")
    params = [p.detach() for p in tf._leaves(state["params"])]
    opt = None if state["opt"] is None else state["opt"].state_dict()
    mesh = state.get("mesh")
    if mesh is not None:
        params, opt = _whole(state, params, opt)
        if mesh.rank != 0:
            dist.barrier()
            return
    path.mkdir(parents=True, exist_ok=True)
    payload = {"step": int(step), "params": params, "opt": opt}
    tmp = path / f".{step}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    with open(tmp / STATE_FILE, "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    for stale in _steps(path)[:-max_to_keep]:
        shutil.rmtree(path / str(stale))
    if mesh is not None:
        dist.barrier()


def _moments(opt_state, placements, fn):
    """``fn(tensor, placement)`` over the AdamW moments of an optimizer
    state dict (a moment has its parameter's shape and placement); the
    step counts and hyperparameters are kept."""
    out = {"state": {}, "param_groups": opt_state["param_groups"]}
    for i, per in opt_state["state"].items():
        out["state"][i] = {k: (fn(v, placements[i]) if v.dim() > 0 else v)
                           for k, v in per.items()}
    return out


def _whole(state, params, opt):
    """The whole parameters and optimizer state of a meshed state, on
    every rank (collective)."""
    mesh = state["mesh"]
    placements = tf.leaf_placements(state["cfg"], mesh)

    def gather(t, placement):
        return tp.gather_tensor(t, placement[0], mesh, placement[1])

    params = [gather(p, pl) for p, pl in zip(params, placements)]
    if opt is not None:
        opt = _moments(opt, placements, gather)
    return params, opt


def _cut(state, params, opt):
    """Whole parameters and optimizer state cut for a meshed state's
    own mesh."""
    mesh = state["mesh"]
    placements = tf.leaf_placements(state["cfg"], mesh)

    def cut(t, placement):
        return tp.shard_tensor(t, placement[0], mesh, placement[1])

    params = [cut(p, pl) for p, pl in zip(params, placements)]
    if opt is not None:
        opt = _moments(opt, placements, cut)
    return params, opt


def abstract_like(state: Dict[str, Any]) -> Dict[str, Any]:
    """A fresh template of ``state`` to ``restore`` into: parameters of
    the same shapes, dtypes, devices and placement (zeros), an optimizer
    of the same kind and hyperparameters with no state yet, the same
    mesh. The reference's abstract tree of shapes and shardings."""
    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        if isinstance(node, list):
            return [zeros(v) for v in node]
        return torch.zeros_like(node.detach()).requires_grad_(
            node.requires_grad)

    out = dict(state)
    out["params"] = zeros(state["params"])
    if state["opt"] is not None:
        opt = state["opt"]
        takes = inspect.signature(type(opt)).parameters
        out["opt"] = type(opt)(tf._leaves(out["params"]),
                               **{k: v for k, v in opt.defaults.items()
                                  if k in takes})
    return out


def restore(directory, state: Dict[str, Any],
            step: Optional[int] = None) -> Dict[str, Any]:
    """Load checkpoint ``step`` (the newest when None) into ``state``, a
    train state made by the same ``init_state`` as the saved one: the
    parameters are overwritten in place and the optimizer's state
    replaced. Returns ``state``; raises FileNotFoundError when there is
    no such checkpoint."""
    if step is None:
        step = latest_step(directory)
    file = pathlib.Path(directory) / str(step) / STATE_FILE
    if step is None or not file.is_file():
        raise FileNotFoundError(
            f"no checkpoint{'' if step is None else f' {step}'} under "
            f"{directory}")
    leaves = tf._leaves(state["params"])
    meshed = state.get("mesh") is not None
    payload = torch.load(file, map_location="cpu" if meshed
                         else leaves[0].device, weights_only=True)
    if meshed and len(payload["params"]) == len(leaves):
        payload["params"], payload["opt"] = _cut(state, payload["params"],
                                                 payload["opt"])
    if len(payload["params"]) != len(leaves) or any(
            saved.shape != p.shape
            for saved, p in zip(payload["params"], leaves)):
        raise ValueError(
            f"checkpoint {file} does not match the state's parameters")
    with torch.no_grad():
        for saved, p in zip(payload["params"], leaves):
            p.copy_(saved)
    if (payload["opt"] is None) != (state["opt"] is None):
        raise ValueError(
            f"checkpoint {file} and the state disagree on the optimizer")
    if state["opt"] is not None:
        state["opt"].load_state_dict(payload["opt"])
    return state


def batch_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s batch: seeded from ``seed`` and
    ``step`` alone, so a resumed run draws the batches the uninterrupted
    run drew."""
    value = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(value[0]))


def train_with_checkpointing(cfg, directory, *, total_steps: int,
                             checkpoint_every: int, batch: int = 4,
                             seed: int = 0, learning_rate: float = 1e-2,
                             on_step: Optional[Callable[[int], None]] = None,
                             handle_preemption: bool = True,
                             device="cuda", mesh=None):
    """Run (or resume) the training loop with periodic saves.

    Picks up from ``latest_step(directory)`` when present; the
    interrupted and uninterrupted trajectories are identical because
    step i's batch is drawn from ``batch_generator(seed, i)``, not from
    loop state. Returns (final_state, {step: loss}).

    With ``handle_preemption`` a SIGTERM arriving mid-run is turned into
    a flag: the in-flight step finishes, a checkpoint is written at that
    exact step, and :class:`Preempted` is raised. ``on_step(i)`` is
    called after step ``i``'s loss is recorded and before the preemption
    check and the checkpoint decision.

    With ``mesh`` every rank runs the loop: the state is sharded, each
    rank trains on its rows of step i's batch, and the saves are
    collective (``save``)."""
    dev = resolve(device)
    step_fn, init_state = tf.make_train_step(
        cfg, mesh=mesh, learning_rate=learning_rate, device=dev)
    state = init_state(torch.Generator(device=dev).manual_seed(seed))
    guard_cm = (preemption_guard() if handle_preemption
                else contextlib.nullcontext(PreemptionGuard()))
    with guard_cm as guard:
        start = 0
        resumed = latest_step(directory)
        if resumed is not None:
            state = restore(directory, state, resumed)
            start = resumed
        losses = {}
        for i in range(start, total_steps):
            tokens = tf.sample_batch(batch_generator(seed, i, dev), cfg,
                                     batch, cfg.max_seq, device=dev)
            state, loss = step_fn(state, tf.shard_batch(tokens, mesh))
            losses[i] = float(loss)
            if on_step is not None:
                on_step(i)
            done = i + 1
            if guard.preempted:
                # the reference also records a recovery-log entry here;
                # that log belongs to the simulator layer, not this port
                save(directory, done, state)
                raise Preempted(done, losses)
            if done % checkpoint_every == 0 or done == total_steps:
                save(directory, done, state)
    return state, losses
