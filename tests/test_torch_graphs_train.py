"""PyTorch port: the train step as a compiled program
(``transformer.make_train_step`` on a card, the reference's
``jax.jit(step)``), pinned on the CPU.

On a card the step's first call runs eagerly (AdamW's moments are
created) and captures a CUDA graph that every later call replays; on
the CPU the same step function runs eagerly through the same runner
attribute (``step_fn._round``). So the CPU shows what capture needs, on
the tiny fp32 models of ``test_torch_training.py``, with and without
remat:

* every step after the first runs the same aten operations on the same
  shapes, dtypes and non-tensor arguments, whatever its tokens, and
  copies nothing from the host;
* the key changes with the batch's shape and with the state, not with
  the tokens;
* three steps with AdamW built ``capturable`` (as the card builds it:
  the step count and bias correction on the device) equal the JAX
  package's ``make_train_step`` at ``test_torch_training.py``'s
  tolerance;
* a restore keeps the optimizer's moments at their addresses (a graph
  reads them there), and the steps after it equal an uninterrupted run.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
import torch.optim.adam as torch_adam
from torch.utils._python_dispatch import TorchDispatchMode

from kind_tpu_sim_torch import device as pdevice
from kind_tpu_sim_torch.models import checkpoint as ckpt
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.weights import params_from_numpy

import test_torch_training as training
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GQA = training.GQA_FLASH
CASES = {"plain": GQA, "remat": dataclasses.replace(GQA, remat=True)}


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if isinstance(x, (int, float, bool, str, type(None), torch.dtype,
                      torch.device, torch.layout, torch.memory_format)):
        return x
    # an opaque argument (the optimizer's profiler record)
    return type(x).__name__


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _sig(args), _sig(kwargs)))
        return func(*args, **kwargs)


def _refuse_host(real):
    def guarded(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise AssertionError("a host copy inside a compiled step")
        return real(data, *args, **kwargs)

    return guarded


def _to_device(*args, **kwargs):
    raise AssertionError("to_device inside a compiled step")


class Recorder:
    """A step runner recording (key, operations) a call; every call
    after the first (the eager warm-up that creates AdamW's moments, on
    a card) runs with host copies refused."""

    def __init__(self, monkeypatch):
        self.mp, self.calls = monkeypatch, []

    def __call__(self, key, fn):
        with self.mp.context() as m:
            if self.calls:
                m.setattr(pdevice, "to_device", _to_device)
                for name in ("as_tensor", "tensor", "from_numpy"):
                    m.setattr(torch, name,
                              _refuse_host(getattr(torch, name)))
            with OpLog() as log:
                out = fn()
        self.calls.append((key, log.ops))
        return out


@pytest.fixture
def capturable(monkeypatch):
    """AdamW built ``capturable`` allowed on the CPU, for these tests:
    ``rebuild(state)`` gives the state that optimizer (as the card
    builds it, the step count and bias correction on the device; the
    CPU's default AdamW bakes each step's bias correction into its
    operations as host numbers, which a graph could not replay)."""
    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: supported(supports_xla)
                        + ["cpu"])

    def rebuild(state):
        opt = state["opt"]
        takes = inspect.signature(type(opt)).parameters
        kwargs = {k: v for k, v in opt.defaults.items() if k in takes}
        kwargs["capturable"] = True
        state["opt"] = type(opt)(ptf._leaves(state["params"]), **kwargs)
        return state

    return rebuild


def _batches(cfg, n, seed=0):
    return [torch.as_tensor(b).long()
            for b in training._batches(cfg, seed=seed)[:n]]


@pytest.mark.parametrize("name", list(CASES))
def test_steps_of_one_key_run_the_same_operations(name, monkeypatch,
                                                  capturable):
    cfg = CASES[name]
    step, init = ptf.make_train_step(cfg, device="cpu")
    state = capturable(init(torch.Generator().manual_seed(0)))
    rec = step._round = Recorder(monkeypatch)
    for tokens in _batches(cfg, 4):
        state, loss = step(state, tokens)
        assert torch.isfinite(loss) and not loss.requires_grad
    keys = [k for k, _ in rec.calls]
    assert len(set(keys)) == 1
    ops = [o for _, o in rec.calls[1:]]
    assert ops[0] and all(o == ops[0] for o in ops)
    if name == "remat":
        # the backward runs each block's forward again
        plain = Recorder(monkeypatch)
        step2, init2 = ptf.make_train_step(CASES["plain"], device="cpu")
        step2._round = plain
        s2 = capturable(init2(torch.Generator().manual_seed(0)))
        for tokens in _batches(cfg, 2):
            s2, _ = step2(s2, tokens)
        assert len(ops[0]) > len(plain.calls[1][1])


def test_key_changes_with_batch_shape_and_state_not_tokens():
    cfg = CASES["plain"]
    step, init = ptf.make_train_step(cfg, device="cpu")
    keys = []

    def record(key, fn):
        keys.append(key)
        return fn()

    step._round = record
    a = init(torch.Generator().manual_seed(0))
    b = init(torch.Generator().manual_seed(1))
    batches = _batches(cfg, 3)
    for tokens in batches:
        a, _ = step(a, tokens)
    step(a, batches[0][:2])
    step(b, batches[0])
    assert keys[0] == keys[1] == keys[2]
    assert len({keys[0], keys[3], keys[4]}) == 3


def test_capturable_adamw_steps_match_jax(capturable):
    """Three steps of the capturable AdamW against the JAX package's
    ``make_train_step``: the losses and parameters at
    ``test_torch_training.py``'s AdamW tolerance."""
    cfg = GQA
    tree = training._tree(cfg)
    batches = training._batches(cfg)[:3]
    want_losses, want = training._jax_run(cfg, tree, batches, True)
    step, init = ptf.make_train_step(cfg, device="cpu")
    state = capturable(init(params_from_numpy(tree, cfg, device="cpu")))
    got_losses = []
    for tokens in batches:
        state, loss = step(state, torch.as_tensor(tokens).long())
        got_losses.append(float(loss))
    assert state["opt"].defaults["capturable"]
    loss_tol, param_tol = training.FP32_TOL[True]
    np.testing.assert_allclose(got_losses, want_losses, atol=loss_tol,
                               rtol=0)
    for j, p in training._leaf_pairs(want, state["params"]):
        np.testing.assert_allclose(p, j, atol=param_tol, rtol=0)


def _moment_ptrs(opt):
    return [t.data_ptr() for s in opt.state.values() for t in s.values()
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("name", list(CASES))
def test_restore_then_step_equals_an_uninterrupted_run(name, tmp_path,
                                                       capturable):
    """Two steps (capturable AdamW), a checkpoint, two steps on other
    batches, the restore and two steps more equal four uninterrupted
    steps bitwise; the restore copies the saved moments and step counts
    into the tensors the optimizer held."""
    cfg = CASES[name]
    batches = _batches(cfg, 4)
    other = _batches(cfg, 2, seed=9)
    step, init = ptf.make_train_step(cfg, device="cpu")
    straight = capturable(init(torch.Generator().manual_seed(0)))
    want = [float(step(straight, t)[1]) for t in batches]

    step, init = ptf.make_train_step(cfg, device="cpu")
    state = capturable(init(torch.Generator().manual_seed(0)))
    got = [float(step(state, t)[1]) for t in batches[:2]]
    ckpt.save(tmp_path, 2, state)
    for t in other:
        step(state, t)
    ptrs = _moment_ptrs(state["opt"])
    state = ckpt.restore(tmp_path, state)
    assert _moment_ptrs(state["opt"]) == ptrs
    got += [float(step(state, t)[1]) for t in batches[2:]]
    assert got == want
    for x, y in zip(ptf._leaves(state["params"]),
                    ptf._leaves(straight["params"])):
        assert torch.equal(x, y)
