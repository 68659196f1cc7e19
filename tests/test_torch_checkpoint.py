"""PyTorch port: checkpoint / resume (models/checkpoint.py).

The cases of ``tests/test_checkpoint.py:24-111`` that need no mesh, on
the CPU with the reference's fp32 model: an interrupted and resumed run
must reproduce the uninterrupted loss trajectory exactly (fp32, the
same operations in the same order on the same inputs). Preemption goes
through ``on_step`` tripping the guard, as a SIGTERM would.
"""

import contextlib
import os
import signal
import threading

import numpy as np
import pytest
import torch

from kind_tpu_sim_torch.models import checkpoint as ckpt
from kind_tpu_sim_torch.models import transformer as ptf

CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=16, dtype="float32")


def _state(seed=0, steps=0):
    """A train state after ``steps`` AdamW steps (AdamW's moments exist
    only after the first)."""
    step, init = ptf.make_train_step(CFG, device="cpu")
    state = init(torch.Generator().manual_seed(seed))
    for i in range(steps):
        tokens = ptf.sample_batch(torch.Generator().manual_seed(100 + i),
                                  CFG, 2, device="cpu")
        state, _ = step(state, tokens)
    return state


def _assert_states_equal(a, b):
    for x, y in zip(ptf._leaves(a["params"]), ptf._leaves(b["params"])):
        assert torch.equal(x, y)
    sa, sb = a["opt"].state_dict(), b["opt"].state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for key in sa["state"]:
        for name, value in sa["state"][key].items():
            assert torch.equal(value, sb["state"][key][name]), name


def test_latest_step_empty(tmp_path):
    assert ckpt.latest_step(tmp_path / "never-written") is None
    assert not (tmp_path / "never-written").exists()


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", _state())
    ckpt.save(tmp_path / "one", 3, _state())
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "one", _state(), step=2)


def test_save_restore_roundtrip(tmp_path):
    state = _state(seed=0, steps=2)
    ckpt.save(tmp_path, 7, state)
    assert ckpt.latest_step(tmp_path) == 7
    fresh = _state(seed=1)  # other values, no AdamW moments yet
    params = ptf._leaves(fresh["params"])
    restored = ckpt.restore(tmp_path, fresh)
    assert restored is fresh
    assert all(p is q for p, q in zip(params, ptf._leaves(fresh["params"])))
    _assert_states_equal(restored, state)


def test_resume_matches_uninterrupted(tmp_path):
    straight_dir = tmp_path / "straight"
    interrupted_dir = tmp_path / "interrupted"
    _, straight = ckpt.train_with_checkpointing(
        CFG, straight_dir, total_steps=4, checkpoint_every=2, device="cpu")
    # interrupted run: stop after 2 steps...
    _, first = ckpt.train_with_checkpointing(
        CFG, interrupted_dir, total_steps=2, checkpoint_every=2,
        device="cpu")
    assert ckpt.latest_step(interrupted_dir) == 2
    # ...then resume to 4 in a fresh call (fresh state and optimizer)
    final, second = ckpt.train_with_checkpointing(
        CFG, interrupted_dir, total_steps=4, checkpoint_every=2,
        device="cpu")
    assert set(first) == {0, 1}
    assert set(second) == {2, 3}, "resume must skip completed steps"
    assert {**first, **second} == straight
    again = ckpt.restore(straight_dir, _state(seed=3))
    _assert_states_equal(final, again)


def test_preemption_checkpoints_and_resumes(tmp_path, monkeypatch):
    """A preemption mid-run finishes the in-flight step, writes a
    checkpoint at that exact step and raises Preempted; resuming
    completes the run with the uninterrupted trajectory."""
    _, straight = ckpt.train_with_checkpointing(
        CFG, tmp_path / "straight", total_steps=4, checkpoint_every=4,
        device="cpu")
    guard = ckpt.PreemptionGuard()

    @contextlib.contextmanager
    def this_guard():
        yield guard

    monkeypatch.setattr(ckpt, "preemption_guard", this_guard)
    chaos_dir = tmp_path / "chaos"
    with pytest.raises(ckpt.Preempted) as err:
        ckpt.train_with_checkpointing(
            CFG, chaos_dir, total_steps=4, checkpoint_every=4,
            on_step=lambda i: i == 1 and guard.trip(), device="cpu")
    assert err.value.step == 2
    assert set(err.value.losses) == {0, 1}
    assert ckpt.latest_step(chaos_dir) == 2

    monkeypatch.undo()
    _, resumed = ckpt.train_with_checkpointing(
        CFG, chaos_dir, total_steps=4, checkpoint_every=4, device="cpu")
    assert {**err.value.losses, **resumed} == straight


def test_preemption_guard_turns_sigterm_into_a_flag():
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install only on the main thread")
    before = signal.getsignal(signal.SIGTERM)
    with ckpt.preemption_guard() as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    assert signal.getsignal(signal.SIGTERM) == before


def test_retention_max_to_keep(tmp_path):
    state = _state()
    for step in range(5):
        ckpt.save(tmp_path, step, state, max_to_keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, _state(), step=0)


def test_a_torn_write_is_never_visible(tmp_path, monkeypatch):
    state = _state()
    ckpt.save(tmp_path, 1, state)

    def crash(obj, fh):
        fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(tmp_path, 2, state)
    assert ckpt.latest_step(tmp_path) == 1
    monkeypatch.undo()
    ckpt.restore(tmp_path, _state(seed=2))


def test_saving_a_step_again_is_refused(tmp_path):
    first = _state(seed=0)
    ckpt.save(tmp_path, 5, first)
    with pytest.raises(FileExistsError):
        ckpt.save(tmp_path, 5, _state(seed=1))
    assert [p.name for p in tmp_path.iterdir()] == ["5"]
    _assert_states_equal(ckpt.restore(tmp_path, _state(seed=2)), first)


def test_batches_depend_on_seed_and_step_alone():
    def batch(seed, i):
        return ptf.sample_batch(ckpt.batch_generator(seed, i, "cpu"), CFG,
                                4, device="cpu")

    assert torch.equal(batch(0, 3), batch(0, 3))
    assert not torch.equal(batch(0, 3), batch(0, 4))
    assert not torch.equal(batch(0, 3), batch(1, 3))


# tests/test_checkpoint.py:113-160 on the port: kv heads divisible by a
# model axis of 4
MESH_CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, max_seq=16, dtype="float32")


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    import torch_parity
    from kind_tpu_sim_torch.parallel import launch

    root = tmp_path_factory.mktemp("meshed")
    return launch.spawn(torch_parity.mesh_rank_checkpoint, 8, MESH_CFG,
                        str(root), backend="gloo", device="cpu", timeout_s=150)


def test_meshed_train_and_resume(meshed, tmp_path):
    """The train / checkpoint / resume loop over a (data 2, model 4)
    mesh: 2 steps, then a resume to 4, the losses those of the
    unsharded loop."""
    first, more = meshed[0], meshed[1]
    assert set(first) == {0, 1} and set(more) == {2, 3}
    _, plain = ckpt.train_with_checkpointing(
        MESH_CFG, tmp_path, total_steps=4, checkpoint_every=2,
        device="cpu")
    for i, loss in {**first, **more}.items():
        assert abs(loss - plain[i]) < 1e-4, (i, loss, plain[i])


def test_cross_mesh_restore(meshed):
    """A state sharded over (data 4, model 2) restores onto (data 2,
    model 4), exactly: every parameter and AdamW moment, gathered, is
    the saved one; wqkv holds a quarter of the heads."""
    (params_a, moments_a), (params_b, moments_b) = meshed[2], meshed[3]
    assert len(params_a) == len(params_b)
    for a, b in zip(params_a, params_b):
        np.testing.assert_array_equal(a, b)
    assert moments_a.keys() == moments_b.keys()
    for i in moments_a:
        for name in moments_a[i]:
            np.testing.assert_array_equal(moments_a[i][name],
                                          moments_b[i][name])
    assert meshed[4] == (32, 3 * 32 // 4)
