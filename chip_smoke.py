#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

The main path is paged continuous-batching serving of the flagship
configuration (``bench_config_large`` with ``flash=True``: d_model 2048,
16 query heads over 4 KV heads, head_dim 128, 8 layers, 32768-token
vocab, bf16 weights and activations), random weights from seed 0.
Phases, each of which exits non-zero when it fails (nothing is caught
and ignored):

1. build  -- compile every ``kind_tpu_sim_torch/csrc/*.cu`` with nvcc
   for sm_90a into ``build/kind_tpu_sim_torch/``;
2. kernels -- each CUDA kernel at the serving path's shapes against its
   plain PyTorch version on the same bf16 inputs (computed in fp32),
   then timed with CUDA events (median of 30 launches after warm-up,
   L2 flushed before each) beside the plain version and, where one
   PyTorch call computes the same function, that call;
3. small  -- a tiny fp32 model served on the card (kernel tier) must
   emit the streams the CPU plain path emits;
4. serve  -- 16 greedy requests (prompts of 192/224/256 tokens, 128
   new tokens each) through ``PagedServingEngine(paged_kernel=True)``
   at full width, with the kernels' launch counters zeroed just before
   and read just after; then the same stream on the gather tier.

Standard output ends with a ``{"kernels": [...]}`` line, the card's
name and power limit as nvidia-smi prints them, and the result line
``{"ok": true, "device": {...}}``. TF32 is off for every fp32 product.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLASH_TOL = 2e-2        # bf16 output rounding + P rounded to bf16 for PV
LSE_TOL = 1e-3          # fp32 running max and denominator; sum order only
PAGED_RTOL, PAGED_ATOL = 1e-3, 1e-4   # fp32 partials; summation order
SMALL_MARGIN = 1e-3     # a stream split below this top-2 margin is a tie


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------
# timing


_L2_FLUSH = None


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call in ms, CUDA events around
    each call, with the 50 MB L2 overwritten before every call (the
    serving path's pools and weights are far larger than L2)."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _L2_FLUSH.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    """(least time in ms, "bytes" or "operations") on the card."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------
# phase 2: the kernels against their plain versions


def flash_phase(fa) -> dict:
    """flash_attention at the prefill shape of the serving path: one
    256-token prompt (the 192/224/256 prompts' bucket), 16 q heads over
    4 kv heads, head_dim 128, bf16, causal, q/k/v read as views of the
    fused qkv projection (the model's layout). Plus a ragged causal
    case (t = s = 200) and a non-causal one."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    h, kv, d = 16, 4, 128

    def fused(t):
        qkv = torch.randn((1, t, (h + 2 * kv) * d), generator=gen,
                          device="cuda").bfloat16()
        return (qkv[..., :h * d].reshape(1, t, h, d),
                qkv[..., h * d:(h + kv) * d].reshape(1, t, kv, d),
                qkv[..., (h + kv) * d:].reshape(1, t, kv, d))

    cases = [("main 256 causal", fused(256), True),
             ("ragged 200 causal", fused(200), True),
             ("full 256", fused(256), False)]
    worst = 0.0
    for name, (q, k, v), causal in cases:
        out = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and out.shape == q.shape,
              f"flash_attention {name}: output {out.dtype} {out.shape}")
        err = float((out.float() - ref).abs().max())
        log(f"flash_attention {name}: max_abs_err {err:.3e} "
            f"(tolerance {FLASH_TOL})")
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash_attention {name}: max_abs_err {err} > {FLASH_TOL}")
        worst = max(worst, err)

    q, k, v = cases[0][1]
    # the logsumexp output (the training slice's backward reads it)
    _, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    _, lse_ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=True, return_lse=True)
    lse_err = float((lse - lse_ref).abs().max())
    log(f"flash_attention main 256 causal lse: max_abs_err {lse_err:.3e} "
        f"(tolerance {LSE_TOL})")
    check(lse.shape == lse_ref.shape and lse_err <= LSE_TOL,
          f"flash_attention lse: max_abs_err {lse_err} > {LSE_TOL}")

    b, t, _, _ = q.shape
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
    # each input read once, the output written once; causal QK^T and PV
    # over the t(t+1)/2 live (row, col) pairs, 2 flops per multiply-add
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    pairs = b * h * t * (t + 1) // 2
    bound_ms, bound_by = bound(nbytes, 4 * pairs * d, torch.bfloat16)
    log(f"flash_attention timing (1,256,16,128) causal: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": fa.SOURCE, "replaces": fa.REPLACES,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def paged_phase(pa) -> dict:
    """paged_attention at the decode shape of the serving path: 8 slots,
    4 kv heads x group 4, head_dim 128, bf16 pools of 129 blocks x 64
    positions, table width 8. Lengths mix an empty slot, sub-block,
    one block, block+1 and the longest slot (448); padding entries
    point at the garbage block or at other slots' live blocks."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    slots, kv, g, hd, nblocks, bsz, width = 8, 4, 4, 128, 129, 64, 8
    lengths_h = np.asarray([0, 1, 63, 64, 65, 448, 300, 129], np.int32)
    rng = np.random.RandomState(2)
    perm = list(rng.permutation(np.arange(1, nblocks)))
    tables_h = np.zeros((slots, width), np.int32)
    live_blocks = []
    for s, n in enumerate(lengths_h):
        live = -(-int(n) // bsz)
        tables_h[s, :live] = perm[:live]
        live_blocks += perm[:live]
        perm = perm[live:]
    for s, n in enumerate(lengths_h):
        for j in range(-(-int(n) // bsz), width):
            tables_h[s, j] = 0 if j % 2 else int(rng.choice(live_blocks))
    qg = torch.randn((slots, kv, g, hd), generator=gen,
                     device="cuda").bfloat16()
    k_pool = torch.randn((nblocks, bsz, kv, hd), generator=gen,
                         device="cuda").bfloat16()
    v_pool = torch.randn((nblocks, bsz, kv, hd), generator=gen,
                         device="cuda").bfloat16()
    tables = torch.as_tensor(tables_h, device="cuda")
    lengths = torch.as_tensor(lengths_h, device="cuda")

    got = pa.paged_attention(qg, k_pool, v_pool, tables, lengths)
    want = pa.paged_attention_ref(qg, k_pool, v_pool, tables, lengths)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, r in zip(("acc", "m", "l"), got, want):
        check(a.dtype == torch.float32 and a.shape == r.shape,
              f"paged_attention {name}: {a.dtype} {tuple(a.shape)}")
        live = lengths_h > 0
        a_l, r_l = a[torch.as_tensor(live)], r[torch.as_tensor(live)]
        err = float((a_l - r_l).abs().max())
        ok = bool(((a_l - r_l).abs()
                   <= PAGED_ATOL + PAGED_RTOL * r_l.abs()).all())
        log(f"paged_attention {name}: max_abs_err {err:.3e} "
            f"(rtol {PAGED_RTOL}, atol {PAGED_ATOL})")
        check(ok, f"paged_attention {name} outside tolerance ({err})")
        worst = max(worst, err)
    acc0, m0, l0 = (x[0] for x in got)
    check(bool((acc0 == 0).all() and (l0 == 0).all()
               and (m0 == np.float32(-1e30)).all()),
          "paged_attention: the zero-length slot is not exactly "
          "acc = 0, l = 0, m = -1e30")

    ms = time_ms(lambda: pa.paged_attention(qg, k_pool, v_pool, tables,
                                            lengths))
    plain_ms = time_ms(lambda: pa.paged_attention_ref(qg, k_pool, v_pool,
                                                      tables, lengths))
    total = int(lengths_h.sum())
    # live k and v rows read once, q, tables and lengths read once, the
    # fp32 partials written once; QK and PV over every live position
    nbytes = (2 * total * kv * hd * 2 + qg.numel() * 2 + tables.numel() * 4
              + lengths.numel() * 4 + 4 * sum(x.numel() for x in got))
    bound_ms, bound_by = bound(nbytes, 4 * total * kv * g * hd,
                               torch.bfloat16)
    log(f"paged_attention timing (8 slots, {total} live positions): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    return {"name": "paged_attention", "route": "cuda",
            "source": pa.SOURCE, "replaces": pa.REPLACES,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# ---------------------------------------------------------------------
# phase 3: a tiny model on the card against the CPU plain path


def small_phase(tf, serving) -> None:
    cfg = tf.ModelConfig(vocab_size=256, d_model=128, n_heads=4,
                         n_kv_heads=2, n_layers=2, d_ff=256, max_seq=128,
                         dtype="float32", flash=True)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                            "cuda")
    cpu_params = {"embed": params["embed"].cpu(),
                  "final_norm": params["final_norm"].cpu(),
                  "blocks": [{k: v.cpu() for k, v in b.items()}
                             for b in params["blocks"]]}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 17, 30, 41, 12, 26)]
    # 8 usable blocks of 16 for 4 slots: admission waits and preempts
    sc = serving.ServingConfig(max_slots=4, max_len=80, chunk=8,
                               paged_blocks=9, block_size=16,
                               paged_kernel=True)

    def run(p, device):
        eng = serving.PagedServingEngine(p, cfg, sc, device=device)
        for i, pr in enumerate(prompts):
            eng.submit(serving.Request(f"s{i}", pr, max_new=24))
        done = {c.request_id: c.tokens for c in eng.run()}
        check(eng.report()["paged"]["blocks_in_use"] == 0,
              f"small phase ({device}): blocks left in use")
        return done, eng.preemptions

    card, card_pre = run(params, "cuda")
    plain, plain_pre = run(cpu_params, "cpu")
    ties = 0
    for rid in sorted(plain):
        a, b = card[rid], plain[rid]
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        prompt = prompts[int(rid[1:])]
        seq = torch.tensor([prompt + b[:i]])
        logits = tf.forward(cpu_params, seq, cfg)[0, -1]
        top2 = logits.topk(2).values
        margin = float(top2[0] - top2[1])
        check(margin < SMALL_MARGIN,
              f"small phase: {rid} splits at token {i} with top-2 margin "
              f"{margin} (card {a[i]}, plain {b[i]})")
        ties += 1
    log(f"small model: {len(plain)} streams, card kernel tier vs CPU plain "
        f"path: {len(plain) - ties} equal, {ties} split at a near tie; "
        f"preemptions card {card_pre}, plain {plain_pre}")


# ---------------------------------------------------------------------
# phase 4: serving at full width


def serve(serving, params, cfg, sc, reqs):
    eng = serving.PagedServingEngine(params, cfg, sc, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    done = {c.request_id: c for c in eng.run()}
    torch.cuda.synchronize()
    return eng, done, time.perf_counter() - t0


def serve_phase(flagship, serving, fa, pa) -> dict:
    """The flagship workload of ``kind_tpu_sim_torch.profile_serving``
    (the same stream, configuration and seed)."""
    cfg = flagship.flagship_config()
    t0 = time.perf_counter()
    sp = flagship.flagship_params(cfg)
    n_params = sum(x.numel() for x in [sp["embed"], sp["final_norm"]]
                   + [w for b in sp["blocks"] for w in b.values()])
    log(f"flagship params: {n_params} (bf16 serving snapshot), set up in "
        f"{time.perf_counter() - t0:.2f} s")
    pool_blocks = flagship.POOL_BLOCKS
    kernel_sc = flagship.flagship_serving(paged_kernel=True)
    reqs = flagship.flagship_requests(cfg.vocab_size, logprobs=True)

    # warm-up: one request through prefill and one decode round
    serve(serving, sp, cfg, kernel_sc,
          [dataclasses.replace(reqs[0], request_id="warm", max_new=65)])

    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    eng, done, wall = serve(serving, sp, cfg, kernel_sc, reqs)
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches}

    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} completed")
    for r in reqs:
        c = done[r.request_id]
        check(len(c.tokens) == r.max_new and c.finish_reason == "length",
              f"{r.request_id}: {len(c.tokens)} tokens, {c.finish_reason}")
        check(all(math.isfinite(x) for x in c.logprobs),
              f"{r.request_id}: non-finite logprobs (NaN logits)")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"{r.request_id}: token out of range")
    rep = eng.report()
    check(rep["paged"]["blocks_in_use"] == 0,
          f"{rep['paged']['blocks_in_use']} blocks still in use")
    want_flash = cfg.n_layers * rep["prefills"]
    want_paged = cfg.n_layers * kernel_sc.chunk * rep["decode_rounds"]
    log(f"launches: flash_attention {launches['flash_attention']} "
        f"(expected n_layers x admissions = {want_flash}), paged_attention "
        f"{launches['paged_attention']} (expected n_layers x chunk x "
        f"decode rounds = {want_paged})")
    check(launches["flash_attention"] == want_flash > 0,
          "flash_attention launch count")
    check(launches["paged_attention"] == want_paged > 0,
          "paged_attention launch count")

    gen_tokens = sum(len(c.tokens) for c in done.values())
    ttft = float(np.mean([c.ttft_s for c in done.values()]))
    e2e = float(np.mean([c.e2e_s for c in done.values()]))
    log(f"serving kernel tier: {len(done)} requests, {gen_tokens} tokens in "
        f"{wall:.3f} s = {gen_tokens / wall:.1f} generated tok/s; mean TTFT "
        f"{ttft:.3f} s, mean e2e {e2e:.3f} s; prefills {rep['prefills']}, "
        f"decode rounds {rep['decode_rounds']}, preemptions "
        f"{rep['paged']['preemptions']}, peak blocks "
        f"{rep['paged']['peak_in_use']} of {pool_blocks - 1}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same stream on the gather tier (no paged kernel); reported,
    # not gated: bf16 argmax near ties at full width may split
    _, gdone, gwall = serve(serving, sp, cfg,
                            flagship.flagship_serving(paged_kernel=False),
                            reqs)
    agree, first = 0, None
    for r in reqs:
        a, b = done[r.request_id].tokens, gdone[r.request_id].tokens
        if a == b:
            agree += 1
        elif first is None:
            i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            first = f"{r.request_id} at token {i} ({a[i]} vs {b[i]})"
    log(f"serving gather tier: {gen_tokens} tokens in {gwall:.3f} s = "
        f"{gen_tokens / gwall:.1f} generated tok/s; streams equal to the "
        f"kernel tier: {agree} of {len(reqs)}; first divergence: {first}")
    return launches


# ---------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (HERE / "kind_tpu_sim_torch" / "__init__.py").is_file():
        fail(f"the kind_tpu_sim_torch package is not beside {__file__}")
    sys.path.insert(0, str(HERE))
    from kind_tpu_sim_torch import profile_serving as flagship
    from kind_tpu_sim_torch.models import serving
    from kind_tpu_sim_torch.models import transformer as tf
    from kind_tpu_sim_torch.ops import _build
    from kind_tpu_sim_torch.ops import flash_attention as fa
    from kind_tpu_sim_torch.ops import paged_attention as pa

    check(Path(fa.__file__).resolve().is_relative_to(HERE),
          f"kind_tpu_sim_torch imported from {fa.__file__}, not {HERE}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} ({smi}); TF32 off for matmul "
        "and cuDNN")

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s, {lib}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    kernels = [flash_phase(fa), paged_phase(pa)]
    small_phase(tf, serving)
    launches = serve_phase(flagship, serving, fa, pa)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in order}
                                for k in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
