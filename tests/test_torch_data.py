"""PyTorch port parity: the input pipeline (data.py) and train-smoke.

``pack`` and ``synthetic_documents`` must give the reference's token
streams exactly (both are numpy). The prefetcher cases are those of
``tests/test_data.py:36-63``. The train-smoke model (bf16 activations,
AdamW at lr 1e-2) trains through both frameworks from the same JAX
parameters on the same packed batches; every activation rounds to bf16
(2^-8 relative) at different places in the two backwards, so the
losses (22 falling to 4 over 10 steps) are held at 2e-2, the port's
bf16 bar (``tests/test_torch_training.py``).
"""

import itertools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kind_tpu_sim import data as jdata
from kind_tpu_sim.models import transformer as jtf
from kind_tpu_sim_torch import cli
from kind_tpu_sim_torch import data as pdata
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import jax_cfg

CFG = cli.smoke_config()


def test_pack_exact_windows_no_padding_waste():
    docs = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12]]
    got = list(itertools.islice(pdata.pack(iter(docs), batch=2, seq=3), 2))
    want = list(itertools.islice(jdata.pack(iter(docs), batch=2, seq=3), 2))
    assert got[0].shape == (2, 3) and got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], [[1, 2, 3], [0, 4, 5]])
    np.testing.assert_array_equal(got[1], [[0, 6, 7], [8, 9, 10]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,vocab,batch,seq",
                         [(7, 64, 2, 16), (0, 64, 8, 16), (3, 1000, 4, 33)])
def test_streams_equal_the_reference(seed, vocab, batch, seq):
    n = 6
    got = itertools.islice(
        pdata.pack(pdata.synthetic_documents(seed, vocab), batch, seq), n)
    want = itertools.islice(
        jdata.pack(jdata.synthetic_documents(seed, vocab), batch, seq), n)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    docs = zip(range(50), pdata.synthetic_documents(seed, vocab),
               jdata.synthetic_documents(seed, vocab))
    for _, g, w in docs:
        assert g == w


def test_pack_finite_stream_ends_cleanly():
    out = list(pdata.pack(iter([[1, 2, 3], [4, 5]]), 1, 4))
    assert len(out) == 1  # partial tail window dropped
    np.testing.assert_array_equal(out[0], [[1, 2, 3, 0]])


def test_prefetcher_context_manager_closes():
    with pdata.Prefetcher(iter(range(1000)), depth=1) as pf:
        assert next(pf) == 0
    assert not pf._thread.is_alive()


def test_prefetcher_order_and_termination():
    pf = pdata.Prefetcher(iter(range(10)), depth=3)
    assert list(pf) == list(range(10))


def test_prefetcher_propagates_errors():
    def bad():
        yield 1
        raise RuntimeError("boom")

    pf = pdata.Prefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)


def test_prefetcher_close_unblocks_producer():
    pf = pdata.Prefetcher(iter(range(1000)), depth=1)
    assert next(pf) == 0
    pf.close()  # must not hang on the producer's blocked put
    assert not pf._thread.is_alive()


def test_prefetcher_rejects_zero_depth():
    with pytest.raises(ValueError, match="depth"):
        pdata.Prefetcher(iter(()), depth=0)


def test_input_pipeline_matches_the_reference():
    with pdata.input_pipeline(CFG, batch=8, seed=5, steps=3,
                              device="cpu") as pipe:
        got = list(pipe)
    want = list(jdata.input_pipeline(jax_cfg(CFG), batch=8, seed=5,
                                     steps=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.long and g.device.type == "cpu"
        assert g.shape == (8, CFG.max_seq)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_train_smoke_cli_on_the_cpu(capsys):
    rc = cli.main(["train-smoke", "--steps", "10", "--json",
                   "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["ok"]
    assert report["steps"] == 10
    assert report["loss_last5"] < report["loss_first5"]
    assert set(report) == {"steps", "loss_first5", "loss_last5",
                           "tokens_per_s", "ok"}


def test_train_smoke_cli_checkpoint_round_trip(capsys, tmp_path):
    rc = cli.main(["train-smoke", "--steps", "10", "--device", "cpu",
                   "--checkpoint-dir", str(tmp_path / "ckpt")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert lines[-1] == "TRAIN SMOKE OK"
    assert "checkpoint/resume drift 0.00e+00 OK" in lines


def test_train_smoke_needs_ten_steps():
    with pytest.raises(SystemExit, match="steps >= 10"):
        cli.main(["train-smoke", "--steps", "9", "--device", "cpu"])


def test_smoke_training_matches_jax_through_the_pipeline():
    """The smoke's model, parameters and AdamW trained 10 steps in both
    frameworks on the pipeline's packed batches."""
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jtf.init_params(jax.random.PRNGKey(0), jax_cfg(CFG)))
    with pdata.input_pipeline(CFG, batch=8, steps=10, device="cpu") as pipe:
        batches = list(pipe)

    jstep, _ = jtf.make_train_step(jax_cfg(CFG), learning_rate=1e-2)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = {"params": params, "opt": optax.adamw(1e-2).init(params)}
    want = []
    for tokens in batches:
        state, loss = jstep(state, jnp.asarray(tokens.numpy()))
        want.append(float(loss))

    step, init = ptf.make_train_step(CFG, learning_rate=1e-2, device="cpu")
    pstate = init(params_from_numpy(tree, CFG, device="cpu"))
    got = []
    for tokens in batches:
        pstate, loss = step(pstate, tokens)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.mean(got[-5:]) < np.mean(got[:5])


def test_pipeline_places_shards_on_mesh():
    """tests/test_data.py:65-82 on the port: over training_mesh(4, 2)
    (8 gloo ranks) each rank gets its 2 rows of the 8-row global batch
    (the batch over 'data', replicated over 'model'), and the rows in
    mesh order are the reference's batch."""
    import torch_parity
    from kind_tpu_sim_torch.parallel import launch

    cfg = dataclasses.replace(CFG, max_seq=16) if CFG.max_seq != 16 else CFG
    got = launch.spawn(torch_parity.mesh_rank_pipeline, 8, cfg, (4, 2),
                       ("data", "model"), 8, 2, backend="gloo",
                       timeout_s=120)
    want = list(jdata.input_pipeline(jax_cfg(cfg), batch=8, steps=2))
    assert {p.shape for p in got} == {(2, 2, cfg.max_seq)}
    for step, w in enumerate(want):
        rows = np.concatenate([got[2 * d][step] for d in range(4)])
        np.testing.assert_array_equal(rows, np.asarray(w))
        for d in range(4):  # the model axis holds the same rows
            np.testing.assert_array_equal(got[2 * d][step],
                                          got[2 * d + 1][step])
