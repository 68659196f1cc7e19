"""PyTorch port: the routes of the exact int8 product (ops/int8_matmul.py)
and the K-major W8A8 weights they read.

``int8_route`` picks ``wgmma`` (tensor cores), ``gemv`` (few rows) or
``dp4a`` (the first kernel) from shapes, layouts, strides and alignment
alone, so it is held here on CPU tensors of the flagship's shapes (d_model
2048, d_ff 8192, 16 query heads over 4 KV heads of 128, vocab 32768; the
storage is allocated, never filled). The kernels themselves run only on
the card (chip_smoke.py phase 2 holds each route bitwise to
``int8_matmul_ref``); here a CPU call takes the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kind_tpu_sim.models import quant as jquant
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import quant as pquant
from kind_tpu_sim_torch.models import speculative as pspec
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.ops import int8_matmul as im
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import jax_cfg, make_params

BF16_TOL = 2e-2   # tests/test_torch_quant.py's bar for bf16 outputs


def _i8(*shape):
    return torch.empty(shape, dtype=torch.int8)


def _k_major(n, k):
    """A (K, N) weight held K-major, as ``quant.quantize_params`` holds
    the W8A8 block weights."""
    return _i8(n, k).t()


def _cache():
    return _i8(8, 1536, 4, 128)


# name: (a, b, the route int8_matmul launches, every route that takes it)
ALL, NO_TC = ("dp4a", "gemv", "wgmma"), ("dp4a", "gemv")
CASES = {
    "decode wqkv": (lambda: (_i8(8, 2048), _k_major(3072, 2048)), "gemv",
                    ALL),
    "decode wo": (lambda: (_i8(8, 2048), _k_major(2048, 2048)), "gemv", ALL),
    "decode w_up": (lambda: (_i8(8, 2048), _k_major(8192, 2048)), "gemv",
                    ALL),
    "decode w_down": (lambda: (_i8(8, 8192), _k_major(2048, 8192)), "gemv",
                      ALL),
    "decode readout": (lambda: (_i8(8, 2048), _i8(32768, 2048).t()), "gemv",
                       ALL),
    "verify window w_up": (lambda: (_i8(40, 2048), _k_major(8192, 2048)),
                           "gemv", ALL),
    "one row past the cut-off": (
        lambda: (_i8(41, 2048), _k_major(8192, 2048)), "wgmma",
        ("dp4a", "wgmma")),
    "cache scores": (lambda: (_i8(8, 4, 4, 128), _cache().permute(0, 2, 3, 1)),
                     "gemv", ALL),
    "cache values": (lambda: (_i8(8, 4, 4, 1536),
                              _cache().permute(0, 2, 1, 3)), "gemv", NO_TC),
    "verify window cache values": (
        lambda: (_i8(8, 4, 20, 1536), _cache().permute(0, 2, 1, 3)), "gemv",
        NO_TC),
    "chunked prefill cache scores": (
        lambda: (_i8(1, 4, 256, 128), _i8(1, 1024, 4, 128).permute(0, 2, 3, 1)),
        "wgmma", ("dp4a", "wgmma")),
    "chunked prefill cache values": (
        lambda: (_i8(1, 4, 256, 1024), _i8(1, 1024, 4, 128).permute(0, 2, 1, 3)),
        "dp4a", ("dp4a",)),
    "admission wave w_up": (lambda: (_i8(2048, 2048), _k_major(8192, 2048)),
                            "wgmma", ("dp4a", "wgmma")),
    "prefill w_up": (lambda: (_i8(8192, 2048), _k_major(8192, 2048)), "wgmma",
                     ("dp4a", "wgmma")),
    "prefill w_up, N contiguous": (
        lambda: (_i8(8192, 2048), _i8(2048, 8192)), "dp4a", ("dp4a",)),
    "decode w_up, N contiguous": (lambda: (_i8(8, 2048), _i8(2048, 8192)),
                                  "gemv", NO_TC),
    "ragged": (lambda: (_i8(37, 1027), _i8(1027, 301)), "dp4a", ("dp4a",)),
    "K not a multiple of 16": (lambda: (_i8(8, 1032), _k_major(64, 1032)),
                               "dp4a", ("dp4a",)),
    "N contiguous, N not a multiple of 16": (
        lambda: (_i8(8, 2048), _i8(2048, 200)), "dp4a", ("dp4a",)),
    "b off a 16-byte boundary": (
        lambda: (_i8(8, 2048), _i8(64 * 2048 + 1)[1:].view(64, 2048).t()),
        "dp4a", ("dp4a",)),
    "a off a 16-byte boundary": (
        lambda: (_i8(8 * 2048 + 1)[1:].view(8, 2048), _k_major(64, 2048)),
        "dp4a", ("dp4a",)),
    "b row stride not a multiple of 16": (
        lambda: (_i8(8, 2048), _i8(64, 2056)[:, :2048].t()), "dp4a",
        ("dp4a",)),
    "an aligned view": (
        lambda: (_i8(8, 2064)[:, 16:], _i8(64, 2064)[:, 16:].t()), "gemv",
        ALL),
}


@pytest.mark.parametrize("name", list(CASES))
def test_int8_route_from_the_inputs_alone(name):
    make, route, takes = CASES[name]
    a, b = make()
    assert im.int8_route(a, b) == route
    assert im.int8_routes(a, b) == takes
    assert route in takes


def test_int8_route_rules_at_the_edges():
    """gemv takes at most ``GEMV_MAX_M`` rows (a verify window's 8 slots x
    5); a "kn" b with more rows has only dp4a; the cut-off reads M alone,
    not the batch."""
    assert im.GEMV_MAX_M >= 40
    for m in (1, 4, 8, 20, 39, 40):
        assert im.int8_route(_i8(m, 256), _k_major(64, 256)) == "gemv"
        assert im.int8_route(_i8(m, 256), _i8(256, 64)) == "gemv"
    for m in (41, 64, 4096):
        assert im.int8_route(_i8(m, 256), _k_major(64, 256)) == "wgmma"
        assert im.int8_route(_i8(m, 256), _i8(256, 64)) == "dp4a"
    assert im.int8_route(_i8(64, 3, 40, 256),
                         _i8(64, 3, 64, 256).transpose(-1, -2)) == "gemv"
    with pytest.raises(ValueError, match="does not take"):
        im._launch("gemv", _i8(41, 256), _k_major(64, 256))
    with pytest.raises(ValueError, match="does not take"):
        im._launch("wgmma", _i8(64, 256), _i8(256, 64))


GEMV_SHAPES = [
    # (batch, m, n, k, b_kn): the flagship's decode and verify products,
    # and small and ragged ones
    (1, 8, 3072, 2048, False), (1, 8, 2048, 2048, False),
    (1, 8, 8192, 2048, False), (1, 8, 2048, 8192, False),
    (1, 8, 32768, 2048, False), (1, 40, 8192, 2048, False),
    (1, 40, 2048, 8192, False), (1, 16, 2048, 8192, False),
    (1, 24, 300, 4096, False), (32, 4, 1536, 128, False),
    (32, 20, 1536, 128, False), (32, 4, 128, 1536, True),
    (32, 20, 128, 1536, True), (1, 8, 8192, 2048, True),
    (4, 3, 48, 64, True), (2, 1, 7, 16, False), (1, 40, 16, 65536, True),
]


@pytest.mark.parametrize("shape", GEMV_SHAPES, ids=str)
def test_gemv_plan_covers_the_product(shape):
    """The plan (csrc/int8_gemv.cu's arguments): its rows hold M, its
    tiles cover N, its slabs are whole 16-byte chunks of K and the
    block's shared memory fits the kernel's 96 KB."""
    batch, m, n, k, b_kn = shape
    rows, lanes, warps_k, slab, tiles, smem = im.gemv_plan(*shape)
    assert rows >= m or (b_kn and rows == im.KN_ROWS)
    assert lanes & (lanes - 1) == 0 and warps_k & (warps_k - 1) == 0
    assert slab % 16 == 0 and 16 <= slab <= k
    assert smem <= 96 * 1024
    if b_kn:
        assert lanes <= 16 and tiles * im.KN_COLS * lanes >= n
        assert rows * slab <= im.GEMV_SLAB
    else:
        cw = dict(im.GEMV_ROWS)[rows]
        cols = im.GEMV_WARPS // warps_k * (32 // lanes) * cw
        assert tiles * cols >= n and m * slab <= im.GEMV_SLAB
        assert lanes * 16 <= k


def _record_routes(monkeypatch):
    """Route every int8 product of the port's models through a recorder
    of ``int8_route`` (the CPU call still takes the plain version)."""
    seen = []

    def recording(a, b):
        seen.append((tuple(a.shape), im.int8_route(a, b)))
        return im.int8_matmul(a, b)

    for mod in (pquant, pdecode):
        monkeypatch.setattr(mod, "int8_matmul", recording)
    return seen


def test_decode_path_takes_gemv_and_prefill_takes_wgmma(monkeypatch):
    """W8A8 with the int8 KV cache at a head_dim of 16 and a cache of 48
    (both whole 16-byte chunks, as the flagship's 128 and 1536 are): the
    prefill linears over 2 x 32 tokens go to the tensor cores, the
    prefill readout (the last position) and every product of a decode
    step (4 linears, the cache's scores and values a layer, the readout)
    to gemv."""
    cfg = ptf.ModelConfig(vocab_size=64, d_model=64, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=128, max_seq=64,
                          dtype="float32", int8_kv=True, int8_native=True)
    _, pparams = make_params(cfg)
    qp = pquant.quantize_params(pparams, cfg)
    prompt = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 32))).long()
    seen = _record_routes(monkeypatch)
    logits, cache = pdecode.prefill(qp, cfg, prompt, 48)
    prefill = list(seen)
    assert [r for _, r in prefill] == ["wgmma"] * (4 * cfg.n_layers) + [
        "gemv"]
    seen.clear()
    pdecode.decode_step(qp, cfg, logits.argmax(-1), cache, 32)
    assert len(seen) == 6 * cfg.n_layers + 1
    assert {r for _, r in seen} == {"gemv"}, seen


def test_verify_windows_take_gemv(monkeypatch):
    """Solo speculative decoding (k 3) on the same geometry, its cache of
    t_p + new + k + 1 = 32 positions a whole number of 16-byte chunks:
    every int8 product of a verify window (2 slots x 4 rows, the cache's
    scores and values with the window folded into M) takes gemv."""
    cfg = ptf.ModelConfig(vocab_size=64, d_model=64, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=128, max_seq=64,
                          dtype="float32", int8_kv=True, int8_native=True)
    _, pparams = make_params(cfg, embed_scale=0.5, block_scale=6.0)
    qp = pquant.quantize_params(pparams, cfg)
    batch = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    seen = _record_routes(monkeypatch)
    pspec.speculative_generate(qp, cfg, batch, 16, draft_k=3, device="cpu")
    window = [(s, r) for s, r in seen if s[-2] == 2 * 4]
    assert window and {r for _, r in window} == {"gemv"}, window


def _same_quant(pq, jq):
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("source", ["quantize_params", "params_from_numpy"])
def test_w8a8_weights_are_k_major_with_the_references_values(source):
    """The block matmul weights of an int8 snapshot have the reference's
    (K, N) shape and bitwise values, held K-major (strides (1, K)); the
    embedding keeps its contiguous (V, D) rows."""
    cfg = dataclasses.replace(
        ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                        d_ff=64, max_seq=32), int8_native=True)
    jparams, pparams = make_params(cfg)
    jq = jquant.quantize_params(jparams, jax_cfg(cfg))
    if source == "quantize_params":
        pq = pquant.quantize_params(pparams, cfg)
    else:
        import jax

        pq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), cfg,
                               device="cpu")
    _same_quant(pq["embed"], jq["embed"])
    assert pq["embed"].q.is_contiguous()
    for jb, pb in zip(jq["blocks"], pq["blocks"]):
        assert sorted(pb) == sorted(jb)
        for name in pquant.K_MAJOR:
            q = pb[name].q
            assert tuple(q.shape) == jb[name].q.shape
            assert q.stride() == (1, q.shape[0])
            _same_quant(pb[name], jb[name])


@pytest.mark.parametrize("native", [False, True], ids=["dequant", "native"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_on_k_major_weights_matches_jax(native, dtype):
    """``linear`` on a K-major weight (the layout ``quantize_params`` now
    returns) equals the JAX package's on the same values, at
    tests/test_torch_quant.py's bars."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64, 48).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    px = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jw = jquant.quantize(jnp.asarray(w))
    pw = pquant.k_major(pquant.quantize(torch.tensor(w)))
    assert pw.q.stride() == (1, 64)
    want = np.asarray(jquant.linear(jx, jw, native=native).astype(
        jnp.float32))
    got = pquant.linear(px, pw, native=native)
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
