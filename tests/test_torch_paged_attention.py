"""PyTorch port parity: paged attention (ops/paged_attention.py).

``paged_attention_ref`` — the plain version of the CUDA kernel, which
the port's wrapper runs for CPU tensors — against the JAX package's
Pallas ``paged_attention`` (interpret mode) on the same numpy inputs,
at the tests/test_pallas.py bars: m 1e-5 abs, l 1e-5 rel, acc 1e-4.
Covers masked tails, padding entries aimed at the garbage block and at
live blocks of other slots, and zero-length slots (exactly l = 0,
acc = 0, m = -1e30). ``paged_attention_split_ref`` — the plain version
of the split kernel's split-and-combine arithmetic — is held to the
Pallas kernel at the same bars and to ``paged_attention_ref`` in fp32
at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kind_tpu_sim.ops import pallas_kernels as pk
from kind_tpu_sim_torch.ops import paged_attention as pa

# lengths mix empty, sub-block, exactly-one-block, block+1 and longer
CASES = {
    "mixed": dict(slots=5, kv=2, g=4, hd=64, bsz=8, nblocks=16, width=4,
                  lengths=[20, 0, 32, 8, 9]),
    "gqa8": dict(slots=3, kv=1, g=8, hd=32, bsz=16, nblocks=10, width=3,
                 lengths=[1, 47, 0]),
    "mha": dict(slots=2, kv=4, g=1, hd=16, bsz=4, nblocks=12, width=5,
                lengths=[17, 3]),
}


def _inputs(slots, kv, g, hd, bsz, nblocks, width, lengths, seed=0):
    rng = np.random.RandomState(seed)
    qg = rng.randn(slots, kv, g, hd).astype(np.float32)
    k_pool = rng.randn(nblocks, bsz, kv, hd).astype(np.float32)
    v_pool = rng.randn(nblocks, bsz, kv, hd).astype(np.float32)
    # distinct live blocks per slot; padding entries point at garbage
    # block 0 or at random (possibly other slots') blocks
    tables = rng.randint(0, nblocks, size=(slots, width)).astype(np.int32)
    perm = rng.permutation(np.arange(1, nblocks))
    for s, n in enumerate(lengths):
        live = -(-n // bsz)
        tables[s, :live] = perm[:live]
        perm = perm[live:]
        tables[s, live::2] = 0
    return qg, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


def _jax(*arrs):
    acc, m, l = pk.paged_attention(*(jnp.asarray(a) for a in arrs))
    return np.asarray(acc), np.asarray(m), np.asarray(l)


def _port(*arrs, dtype=torch.float32):
    qg, kp, vp, tables, lengths = (torch.as_tensor(a) for a in arrs)
    return pa.paged_attention_ref(qg.to(dtype), kp.to(dtype), vp.to(dtype),
                                  tables, lengths)


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_ref_matches_pallas(case):
    arrs = _inputs(**CASES[case])
    acc_j, m_j, l_j = _jax(*arrs)
    acc, m, l = (x.numpy() for x in _port(*arrs))
    lengths = arrs[-1]
    live = lengths > 0
    np.testing.assert_allclose(m[live], m_j[live], atol=1e-5)
    np.testing.assert_allclose(l, l_j, rtol=1e-5)
    np.testing.assert_allclose(acc, acc_j, rtol=1e-4, atol=1e-4)
    # the zero-length trap: exact, not approximately empty
    assert (l[~live] == 0).all() and (acc[~live] == 0).all()
    assert (m[~live] == np.float32(-1e30)).all()
    assert (m_j[~live] == m[~live]).all()


def test_paged_ref_matches_gathered_softmax():
    """The partials normalise to plain softmax attention over each
    slot's gathered prefix."""
    qg, kp, vp, tables, lengths = _inputs(**CASES["mixed"])
    acc, m, l = (x.numpy() for x in _port(qg, kp, vp, tables, lengths))
    hd = qg.shape[-1]
    for s, n in enumerate(lengths):
        if n == 0:
            continue
        kview = np.concatenate([kp[b] for b in tables[s]], 0)[:n]
        vview = np.concatenate([vp[b] for b in tables[s]], 0)[:n]
        for h in range(qg.shape[1]):
            sc = qg[s, h] @ kview[:, h].T * hd ** -0.5
            p = np.exp(sc - sc.max(1, keepdims=True))
            want = (p / p.sum(1, keepdims=True)) @ vview[:, h]
            np.testing.assert_allclose(acc[s, h] / l[s, h][:, None], want,
                                       rtol=1e-4, atol=1e-5)


def test_paged_ref_bf16_pools():
    """bf16 pools and query (the serving path's types): the JAX kernel
    casts both to fp32 before its dots; so does the port."""
    arrs = _inputs(**CASES["mixed"])
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) for a in arrs[:3]]
    acc_j, m_j, l_j = _jax(*bf, *arrs[3:])
    acc, m, l = (x.numpy() for x in _port(*arrs, dtype=torch.bfloat16))
    np.testing.assert_allclose(l, l_j, rtol=1e-5)
    np.testing.assert_allclose(acc, acc_j, rtol=1e-4, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    arrs = [torch.as_tensor(a) for a in _inputs(**CASES["gqa8"])]
    before = pa.paged_attention.launches
    got = pa.paged_attention(*arrs)
    want = pa.paged_attention_ref(*arrs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pa.paged_attention.launches == before


@pytest.mark.parametrize("case", ["table_dtype", "pool_dtype", "group",
                                  "lengths_shape", "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    qg, kp, vp, tables, lengths = (
        torch.as_tensor(a) for a in _inputs(**CASES["mixed"]))
    if case == "table_dtype":
        tables = tables.long()
    elif case == "pool_dtype":
        vp = vp.bfloat16()
    elif case == "group":
        qg = torch.zeros(5, 2, 9, 64)
    elif case == "lengths_shape":
        lengths = lengths[:3]
    else:
        qg = qg.transpose(0, 1).contiguous().transpose(0, 1)
        assert not qg.is_contiguous()
    with pytest.raises(ValueError):
        pa.paged_attention(qg, kp, vp, tables, lengths)


def _split(arrs, bps, dtype=torch.float32):
    qg, kp, vp, tables, lengths = (torch.as_tensor(a) for a in arrs)
    return pa.paged_attention_split_ref(qg.to(dtype), kp.to(dtype),
                                        vp.to(dtype), tables, lengths, bps)


def _split_sizes(case):
    return {"1": 1, "2": 2, "width": CASES[case]["width"]}


@pytest.mark.parametrize("bps", ["1", "2", "width"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_ref_matches_pallas(case, bps):
    arrs = _inputs(**CASES[case])
    acc_j, m_j, l_j = _jax(*arrs)
    acc, m, l = (x.numpy() for x in _split(arrs, _split_sizes(case)[bps]))
    live = arrs[-1] > 0
    np.testing.assert_allclose(m[live], m_j[live], atol=1e-5)
    np.testing.assert_allclose(l, l_j, rtol=1e-5)
    np.testing.assert_allclose(acc, acc_j, rtol=1e-4, atol=1e-4)
    assert (l[~live] == 0).all() and (acc[~live] == 0).all()
    assert (m[~live] == np.float32(-1e30)).all()


@pytest.mark.parametrize("bps", ["1", "2", "width"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_ref_matches_the_one_pass_ref_in_fp32(case, bps):
    arrs = _inputs(**CASES[case])
    got = _split(arrs, _split_sizes(case)[bps])
    want = _port(*arrs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _edge_inputs(bsz=8, width=6, seed=3):
    """Lengths against the split edges of 2 blocks a split (16
    positions): empty, inside a split's first block, one short of a
    split edge, on it, one past it, on a block edge inside a split, and
    the whole table. Every padding entry points at another slot's live
    block."""
    lengths = [0, 5, 15, 16, 17, 24, width * bsz]
    slots, kv, g, hd = len(lengths), 2, 2, 16
    nblocks = 1 + sum(-(-n // bsz) for n in lengths)
    rng = np.random.RandomState(seed)
    qg = rng.randn(slots, kv, g, hd).astype(np.float32)
    k_pool = rng.randn(nblocks, bsz, kv, hd).astype(np.float32)
    v_pool = rng.randn(nblocks, bsz, kv, hd).astype(np.float32)
    tables = np.zeros((slots, width), np.int32)
    nxt, owned = 1, []
    for s, n in enumerate(lengths):
        live = -(-n // bsz)
        tables[s, :live] = np.arange(nxt, nxt + live)
        owned.append(list(range(nxt, nxt + live)))
        nxt += live
    for s, n in enumerate(lengths):
        others = [b for t, bl in enumerate(owned) if t != s for b in bl]
        for j in range(-(-n // bsz), width):
            tables[s, j] = rng.choice(others)
    return qg, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("bps", [1, 2, 4, 6])
def test_split_ref_at_split_edges(bps):
    """Split edges every ``bps`` blocks (4: the last split is short):
    every length class agrees with the one-pass plain version, and the
    empty slot and the splits past each slot's length add nothing."""
    arrs = _edge_inputs()
    acc, m, l = _split(arrs, bps)
    want = _port(*arrs)
    for a, b in zip((acc, m, l), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert (acc[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == np.float32(-1e30)).all()


def test_split_ref_reads_nothing_past_the_table_width():
    """A length past width x bsz attends only the table's positions,
    as the one-pass kernel does."""
    qg, kp, vp, tables, lengths = _edge_inputs()
    lengths = lengths.copy()
    lengths[-1] += 9
    arrs = (qg, kp, vp, tables, lengths)
    for a, b in zip(_split(arrs, 4), _port(*arrs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_split_ref_bf16_pools():
    """bf16 pools and query, as the split kernel reads them: against
    the Pallas kernel fed the same bf16-rounded values."""
    arrs = _inputs(**CASES["mixed"])
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) for a in arrs[:3]]
    acc_j, m_j, l_j = _jax(*bf, *arrs[3:])
    acc, m, l = (x.numpy() for x in _split(arrs, 1, dtype=torch.bfloat16))
    np.testing.assert_allclose(l, l_j, rtol=1e-5)
    np.testing.assert_allclose(acc, acc_j, rtol=1e-4, atol=1e-4)
