"""The flagship model's throughput on the card: the port's counterpart of
the reference bench's model block (``bench.py:model_throughput``).

    python3 -m kind_tpu_sim_torch.bench --model-only [--out PATH]
        [--device cuda|cpu]

``model_throughput(emit=None, device="cuda")`` measures the flagship
(``bench_config_large``: d_model 2048, 16 query heads over 4 KV heads, 8
layers, vocab 32768; random weights from seed 0) on one card, section by
section, each with its roofline from ``models/flops.py``:

* the forward (``loss_fn`` over 8 x 1024 tokens, 10 steps): tokens/s and
  MFU;
* the train step (fwd + bwd + AdamW, 5 steps), dense and flash
  attention, the better one the headline: tokens/s and MFU;
* the 4k-token forward and forward+backward, dense and flash;
* prefill (4 prefills of 8 x 1024 tokens a timed call) and greedy decode
  (512 new tokens after a 1024-token prompt, a 1536-position cache) in
  bf16, in W8A8 with an int8 KV cache and in dequant with an int8 KV
  cache, each decode with its memory roofline;
* the serving matrix: the reference's engine entries, in the order the
  simulator's calibration needs them first (``serving`` first: the
  calibration reads its ``slots``).

On the CPU (``device="cpu"``) it takes the reference's branch for a host
without a TPU: the tiny ``ModelConfig()``, batch 2, 2 steps, 8 new
tokens, no chip spec and so no MFU or roofline, no 4k sections and no
serving matrix.

Timed windows end in a synchronize, as the reference's end in a
readback. The decode loop is a compiled program, as the reference jits
its decode: ``graphs.DecodeProgram`` captures a CUDA graph a chunk size
outside the timed runs, and the timed runs replay them. The serving
engines replay their rounds as CUDA graphs, captured by each entry's
warm-up requests. The forward, the train step and the prefills run
eagerly; their busy shares on the card are recorded
(``device_busy_pct``).

A section that fails records ``<key>_error`` and the sections after it
still run; one skipped by arithmetic (its estimated peak memory over 70%
of the card's) records ``<key>_skipped``. An out-of-memory error trips
``device_poisoned``, after which the device sections skip, as the
reference trips it on ``RESOURCE_EXHAUSTED``. ``emit``, when given, is
called with the result so far after each section.

The reference's remote-tunnel child and probe machinery and its
simulator smokes have no counterpart here; nor, yet, its
``paged_tier_micro``, ``serving_realistic`` and solo ``speculative``
entries.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kind_tpu_sim_torch import profiling
from kind_tpu_sim_torch.device import resolve

REPO = pathlib.Path(__file__).resolve().parents[1]

# Wall-clock seconds per bench section (warm-ups and captures included).
SECTION_S: dict = {}

# The model-block keys, and the keys of each decode roofline, without
# which the fleet simulator's ``costmodel.calibrate`` refuses a bench
# artifact: the port's own copies of the reference's lists.
REQUIRED_MODEL_KEYS = (
    "backend", "chip", "decode_roofline", "decode_tokens_per_s",
    "decode_int8_roofline", "decode_int8_tokens_per_s",
    "fwd_tokens_per_s", "model", "prefill_tokens_per_s", "serving",
)
REQUIRED_ROOFLINE_KEYS = (
    "achieved_gbps", "bytes_per_step_mb", "kv_mb", "roof_gbps",
    "weight_mb",
)


def stopwatch(name: str):
    return profiling.stopwatch(name, SECTION_S)


def model_throughput(emit=None, device="cuda") -> dict:
    """Flagship model throughput on ``device`` (the card unless the
    caller asks for the CPU; without a card this raises); see the module
    docstring. Returns the result dict, every section measured before a
    failure included."""
    dev = resolve(device)
    result: dict = {}
    SECTION_S.clear()
    try:
        from kind_tpu_sim_torch.models import decode, graphs, quant
        from kind_tpu_sim_torch.models import flops as F
        from kind_tpu_sim_torch.models import transformer as tf

        on_card = dev.type == "cuda"
        # the name jax.default_backend() gives a CUDA host
        backend = "gpu" if on_card else dev.type
        # MFU and roofline numbers are only meaningful against a card's
        # data sheet: none on the CPU
        spec = (F.chip_spec(torch.cuda.get_device_name(dev))
                if on_card else None)
        cfg = tf.bench_config_large() if on_card else tf.ModelConfig()
        batch = 8 if on_card else 2
        steps = 10 if on_card else 2

        def gen(seed):
            return torch.Generator(device=dev).manual_seed(seed)

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        params = tf.init_params(cfg, gen(0), dev)
        tokens = tf.sample_batch(gen(1), cfg, batch, cfg.max_seq, device=dev)
        busy: dict = {}
        if on_card:
            result["device_busy_pct"] = busy

        @torch.no_grad()
        def run(params, tokens):
            total = torch.zeros((), device=dev)
            for i in range(steps):
                # each step sees other data, as the reference's scan
                # carries its step into the tokens
                shifted = (tokens + i) % cfg.vocab_size
                total = total + tf.loss_fn(params, shifted, cfg)
            return total

        with stopwatch("fwd"):
            float(run(params, tokens))  # kernel builds + warm
        t0 = time.monotonic()
        total = float(run(params, tokens))
        dt = (time.monotonic() - t0) / steps
        if total != total:
            raise FloatingPointError("NaN loss in the forward section")
        if on_card:
            busy["fwd"] = profiling.device_busy(run, params, tokens)[
                "busy_pct"]
        # loss_fn's next-token shift processes max_seq-1 positions;
        # count those for both the rate and the MFU so they agree
        fwd_seq = cfg.max_seq - 1
        fwd_tps = batch * fwd_seq / dt
        result.update({
            "backend": backend,
            "model": (f"d{cfg.d_model}xL{cfg.n_layers}"
                      + (f"-gqa{cfg.kv_heads}"
                         if cfg.kv_heads != cfg.n_heads else "")),
            "fwd_tokens_per_s": round(fwd_tps),
        })

        def _note():
            if emit is not None:
                emit(dict(result, section_seconds=dict(SECTION_S)))

        if spec is not None:
            result["chip"] = spec.name
            result["fwd_mfu_pct"] = round(
                F.mfu(fwd_tps, F.fwd_flops_per_token(cfg, fwd_seq), spec),
                1)
        _note()

        # ---- out-of-memory discipline, shared by every section below:
        # fits() skips by arithmetic what step_peak_bytes predicts will
        # not fit in 70% of the card's memory, and note_exc() trips the
        # breaker the moment an out-of-memory error is seen, so the
        # remaining device sections skip fast
        hbm = (spec.hbm_gib * 2**30 if spec is not None else float("inf"))

        def fits(key, run_cfg, b, seq, flash, backward=True,
                 optimizer=True):
            if result.get("device_poisoned"):
                result[key + "_skipped"] = "device poisoned"
                return False
            est = F.step_peak_bytes(run_cfg, b, seq, flash=flash,
                                    backward=backward, optimizer=optimizer)
            if est < 0.7 * hbm:
                return True
            result[key + "_skipped"] = (
                f"estimated peak {est / 2**30:.1f} GiB > 70% "
                f"of {spec.hbm_gib:.0f} GiB device memory (skipped by "
                "arithmetic)")
            return False

        def note_exc(exc) -> str:
            if isinstance(exc, torch.cuda.OutOfMemoryError):
                result["device_poisoned"] = True
            return str(exc)[:100]

        def release():
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()

        # Full train step (fwd + bwd + AdamW update), the flagship
        # number. On a card both attention paths are measured and the
        # better one is the headline.
        try:
            train_steps = 5 if on_card else 2

            def measure_train(run_cfg, label, run_tokens, seq_count):
                step_fn, init_state = tf.make_train_step(run_cfg, device=dev)
                state = init_state(gen(3))

                def run_train():
                    losses = []
                    for i in range(train_steps):
                        shifted = (run_tokens + i) % run_cfg.vocab_size
                        losses.append(step_fn(state, shifted)[1])
                    return torch.stack(losses)

                with stopwatch(label):
                    run_train().cpu()  # kernel builds + warm
                t0 = time.monotonic()
                last = float(run_train()[-1])
                dt = (time.monotonic() - t0) / train_steps
                if last != last:
                    raise FloatingPointError(f"NaN loss in {label}")
                if on_card:
                    busy[label] = profiling.device_busy(run_train)[
                        "busy_pct"]
                del state  # free the optimizer tree
                release()
                return batch * seq_count / dt

            variants = {}
            if fits("train_dense", cfg, batch, cfg.max_seq, flash=False):
                try:
                    variants["dense"] = measure_train(cfg, "train", tokens,
                                                      fwd_seq)
                except Exception as exc:
                    result["train_dense_error"] = note_exc(exc)
            if on_card and fits("train_flash", cfg, batch, cfg.max_seq,
                                flash=True):
                try:
                    # max_seq + 1 tokens, so the flash variant trains on
                    # exactly max_seq positions after the shift
                    flash_tokens = tf.sample_batch(gen(1), cfg, batch,
                                                   cfg.max_seq + 1,
                                                   device=dev)
                    variants["flash"] = measure_train(
                        dataclasses.replace(cfg, flash=True),
                        "train_flash", flash_tokens, cfg.max_seq)
                except Exception as exc:
                    result["train_flash_error"] = note_exc(exc)
            if variants:
                best = max(variants, key=variants.get)
                train_tps = variants[best]
                result["train_step_tokens_per_s"] = round(train_tps)
                result["train_variant"] = best
                for name, tps in variants.items():
                    result[f"train_{name}_tokens_per_s"] = round(tps)
                if spec is not None:
                    result["train_mfu_pct"] = round(
                        F.mfu(train_tps,
                              F.train_flops_per_token(cfg, fwd_seq), spec),
                        1)
        except Exception as exc:
            result["train_step_error"] = str(exc)[:100]
        _note()

        if on_card and not result.get("device_poisoned"):
            _long_context(result, params, cfg, dev, gen, sync, fits,
                          note_exc, release, _note)

        # Shared by the decode and serving sections, outside any one
        # section's try: med() and the per-call overhead null_dt.
        def med(fn, n):
            samples = []
            for _ in range(n):
                t0 = time.monotonic()
                fn()
                samples.append(time.monotonic() - t0)
            samples.sort()
            return samples[len(samples) // 2]

        try:
            if result.get("device_poisoned"):
                raise RuntimeError(
                    "device poisoned by an earlier out-of-memory error")

            def null():
                torch.zeros((), device=dev)
                sync()

            null()
            null_dt = med(null, 5)
            null_ok = True
            if on_card:
                # the per-call overhead the rates below subtract
                result["null_dt_s"] = round(null_dt, 6)
        except Exception as exc:
            result["null_dt_error"] = note_exc(exc)
            null_dt, null_ok = 0.0, False

        # Greedy decode throughput on the bf16 serving snapshot, prefill
        # timed separately so the decode number measures steady-state
        # generation only. Best effort: a decode failure must not
        # discard the forward number.
        sparams = qparams = None
        try:
            if result.get("device_poisoned"):
                raise RuntimeError(
                    "device poisoned by an earlier out-of-memory error")
            sparams = decode.serving_params(params, cfg)
            new_tokens = 512 if on_card else 8
            prompt = tokens if on_card else tokens[:, :16]
            total = prompt.shape[1] + new_tokens
            # K sequential prefills a timed call, so the per-call
            # overhead is amortized K-fold
            K = 4 if on_card else 1
            prompts = torch.stack([(prompt + i) % cfg.vocab_size
                                   for i in range(K)])

            @torch.no_grad()
            def pre(p, t):
                return decode.prefill(p, cfg, t, total)

            @torch.no_grad()
            def pre_k(p, ts):
                return [pre(p, t) for t in ts]

            def first_of(logits):
                return torch.argmax(logits, -1).to(prompt.dtype)

            with stopwatch("decode_bf16_compile"):
                logits, cache = pre(sparams, prompt)
                dec = graphs.DecodeProgram(sparams, cfg, cache)
                dec(first_of(logits), prompt.shape[1], new_tokens).cpu()

            state = {}
            with stopwatch("prefill_k_compile"):
                pre_k(sparams, prompts)  # warm
                sync()

            def run_prefill():
                state["pre_k"] = pre_k(sparams, prompts)
                sync()

            raw_prefill = med(run_prefill, 3)
            if on_card:
                busy["prefill_k"] = profiling.device_busy(run_prefill)[
                    "busy_pct"]
            state.pop("pre_k")

            def run_decode():
                state["out"] = dec(first_of(logits), prompt.shape[1],
                                   new_tokens).cpu().numpy()

            raw_decode = med(run_decode, 3)
            if state["out"].shape[1] != new_tokens:
                raise RuntimeError(
                    f"decode emitted {state['out'].shape[1]} tokens, "
                    f"expected {new_tokens}")
            if on_card:
                result["decode_graph_check"] = _graph_check(
                    decode, sparams, cfg, prompt, total, state["out"])

            residual = raw_prefill - null_dt
            if null_ok and residual > 0.3 * raw_prefill:
                prefill_dt = residual / K
                result["prefill_tokens_per_s"] = round(
                    batch * prompt.shape[1] / prefill_dt)
            decode_dt = raw_decode - null_dt
            if null_ok and decode_dt > 0.3 * raw_decode:
                dec_tps = batch * new_tokens / decode_dt
                result["decode_tokens_per_s"] = round(dec_tps)
                # decode re-reads every weight and the full allocated KV
                # cache (length `total`) each step
                if spec is not None:
                    roof = F.decode_roofline(cfg, batch, total, dec_tps,
                                             spec)
                    result["decode_gbps"] = roof["achieved_gbps"]
                    result["decode_roofline"] = roof
            del dec, cache, logits
            release()
            _note()

            # int8 serving snapshot: int8 weights and an int8 KV cache.
            # decode_int8_* is W8A8 (exact int8 x int8 -> int32
            # products); decode_int8_dequant_* casts at the product.
            try:
                # the int8 snapshot is the same for both variants
                # (quantize_params never reads int8_native)
                qparams = quant.quantize_params(
                    params, dataclasses.replace(cfg, int8_kv=True))

                def int8_decode_tps(native: bool):
                    cfg_q = dataclasses.replace(cfg, int8_kv=True,
                                                int8_native=native)
                    with torch.no_grad():
                        logits_q, cache_q = decode.prefill(
                            qparams, cfg_q, prompt, total)
                    dec_q = graphs.DecodeProgram(qparams, cfg_q, cache_q)
                    dec_q(first_of(logits_q), prompt.shape[1],
                          new_tokens).cpu()

                    def run_decode_q():
                        state["out_q"] = dec_q(
                            first_of(logits_q), prompt.shape[1],
                            new_tokens).cpu().numpy()

                    raw_q = med(run_decode_q, 3)
                    del dec_q, cache_q
                    release()
                    dt_q = raw_q - null_dt
                    if not null_ok or dt_q <= 0.3 * raw_q:
                        return None
                    return batch * new_tokens / dt_q

                with stopwatch("decode_int8_native"):
                    q_tps = int8_decode_tps(native=True)
                if q_tps is not None:
                    result["decode_int8_tokens_per_s"] = round(q_tps)
                    if spec is not None:
                        roof_q = F.decode_roofline(
                            cfg, batch, total, q_tps, spec,
                            weight_bytes=1, kv_bytes=1)
                        result["decode_int8_gbps"] = roof_q["achieved_gbps"]
                        result["decode_int8_roofline"] = roof_q
                with stopwatch("decode_int8_dequant"):
                    dq_tps = int8_decode_tps(native=False)
                if dq_tps is not None:
                    result["decode_int8_dequant_tokens_per_s"] = round(
                        dq_tps)
                    if spec is not None:
                        result["decode_int8_dequant_gbps"] = \
                            F.decode_roofline(
                                cfg, batch, total, dq_tps, spec,
                                weight_bytes=1, kv_bytes=1,
                            )["achieved_gbps"]
            except Exception as exc:
                result["decode_int8_error"] = note_exc(exc)
        except Exception as exc:
            result["decode_error"] = note_exc(exc)
        _note()

        if on_card:
            Serving(result, params, sparams, qparams, cfg, tokens, batch,
                    null_dt, null_ok, note_exc, release, _note).run_all()
        return result
    except Exception as exc:
        result["error"] = str(exc)[:100]
        return result


def _graph_check(decode, sparams, cfg, prompt, total, graphed) -> dict:
    """The graphed decode's first chunk against the eager loop's, from
    a prefill of its own: the tokens must be equal, or this raises."""
    with torch.no_grad():
        logits, cache = decode.prefill(sparams, cfg, prompt, total)
        first = torch.argmax(logits, -1).to(prompt.dtype)
        n = 65  # the first token and the first chunk of 64 steps
        eager = decode.generate_from_cache(sparams, cfg, first, cache,
                                           prompt.shape[1], n)
    eager = eager.cpu().numpy()
    equal = bool(np.array_equal(eager, graphed[:, :n]))
    if not equal:
        raise RuntimeError("the graphed decode's first chunk differs from "
                           "the eager loop's")
    return {"tokens": n, "equal": equal}


def _long_context(result, params, cfg, dev, gen, sync, fits, note_exc,
                  release, note):
    """Long-context sections (card only): the 4k-token forward and
    forward+backward, flash attention against the dense path."""
    from kind_tpu_sim_torch.models import transformer as tf

    try:
        long_cfg = dataclasses.replace(cfg, max_seq=4096)
        long_tokens = tf.sample_batch(gen(2), long_cfg, 2, 4096, device=dev)

        def best_time(f, toks=None):
            toks = long_tokens if toks is None else toks
            f(params, toks)
            sync()
            best = None
            for _ in range(3):
                t0 = time.monotonic()
                f(params, toks)
                sync()
                dt = time.monotonic() - t0
                best = dt if best is None else min(best, dt)
            return best

        def fwd_time(use_flash):
            run_cfg = dataclasses.replace(long_cfg, flash=use_flash)

            @torch.no_grad()
            def f(p, t):
                # forward, not loss_fn: the shift would leave 4095 tokens
                return tf.forward(p, t, run_cfg).sum()

            return best_time(f)

        def fwdbwd_time(use_flash, toks=None):
            run_cfg = dataclasses.replace(long_cfg, flash=use_flash)

            def f(p, t):
                leaves = tf._leaves(p)
                for leaf in leaves:
                    leaf.requires_grad_(True)
                try:
                    out = tf.forward(p, t, run_cfg).float().sum()
                    return torch.autograd.grad(out, leaves)
                finally:
                    for leaf in leaves:
                        leaf.requires_grad_(False)

            return best_time(f, toks)

        if fits("fwd_4k_xla", long_cfg, 2, 4096, flash=False,
                backward=False, optimizer=False):
            try:
                with stopwatch("fwd_4k_xla"):
                    result["fwd_4k_tokens_per_s"] = round(
                        2 * 4096 / fwd_time(False))
            except Exception as exc:
                result["fwd_4k_error"] = note_exc(exc)
            release()
        note()
        if fits("fwd_4k_flash", long_cfg, 2, 4096, flash=True,
                backward=False, optimizer=False):
            try:
                with stopwatch("fwd_4k_flash"):
                    result["fwd_4k_flash_tokens_per_s"] = round(
                        2 * 4096 / fwd_time(True))
            except Exception as exc:
                result["fwd_4k_flash_error"] = note_exc(exc)
            release()
        note()

        def fwdbwd_dense_b1():
            # the dense comparison point at half width
            if not fits("fwdbwd_4k_xla_b1", long_cfg, 1, 4096, flash=False,
                        optimizer=False):
                return
            try:
                with stopwatch("fwdbwd_4k_xla_b1"):
                    result["fwdbwd_4k_b1_tokens_per_s"] = round(
                        4096 / fwdbwd_time(False, long_tokens[:1]))
            except Exception as exc2:
                result["fwdbwd_4k_b1_error"] = note_exc(exc2)
            release()

        if fits("fwdbwd_4k_xla", long_cfg, 2, 4096, flash=False,
                optimizer=False):
            try:
                with stopwatch("fwdbwd_4k_xla"):
                    result["fwdbwd_4k_tokens_per_s"] = round(
                        2 * 4096 / fwdbwd_time(False))
            except Exception as exc:
                result["fwdbwd_4k_error"] = note_exc(exc)
                release()
                fwdbwd_dense_b1()
            release()
        else:
            fwdbwd_dense_b1()
        note()
        if fits("fwdbwd_4k_flash", long_cfg, 2, 4096, flash=True,
                optimizer=False):
            try:
                with stopwatch("fwdbwd_4k_flash"):
                    result["fwdbwd_4k_flash_tokens_per_s"] = round(
                        2 * 4096 / fwdbwd_time(True))
            except Exception as exc:
                result["fwdbwd_4k_flash_error"] = note_exc(exc)
            release()
        note()
    except Exception as exc:
        result["fwd_4k_error"] = note_exc(exc)
        note()


# ---------------------------------------------------------------------
# the serving matrix

# (port method, reference phase label): the method that does the work
# the reference's jitted dispatch or host step of that label does. The
# rounds (decode_chunk, verify_scan) are the engine's round runner,
# labelled by the round's key; prefill and suffix_window are one
# method, labelled by where its window starts.
_PHASE_ATTRS = (
    ("_prefill_group", "prefill"),
    ("_first_group", "first_sample"),
    ("_first_read_many", "first_readback"),
    ("_round_retire", "retire_fetch"),
    ("_claim_pending", "claim_host"),
    ("_preempt_youngest", "preempt_host"),
    ("_activate_with_first", "activate_host"),
)
# readback phases wait for the card; their wall absorbs the device time
# of the dispatches in flight and is excluded from the per-call
# overhead correction
_READBACK_PHASES = ("retire_fetch", "first_readback")
# host-side phases: neither dispatches nor readbacks
_HOST_PHASES = ("activate_host", "claim_host", "preempt_host")
_NON_DISPATCH_PHASES = _READBACK_PHASES + _HOST_PHASES


def instrument_phases(eng) -> dict:
    """Wrap the engine's dispatch, fetch and host-step methods with
    counting wall timers; returns the live phase dict {label: [n_calls,
    wall_s]}. ``activate_host`` counts admissions (one a slot activated,
    however many a wave's one first-token sample covered)."""
    phases: dict = {}

    def record(label, t0):
        st = phases.setdefault(label, [0, 0.0])
        st[0] += 1
        st[1] += time.monotonic() - t0

    def timed(fn, label):
        def wrapped(*a, **k):
            t0 = time.monotonic()
            out = fn(*a, **k)
            record(label, t0)
            return out
        return wrapped

    for attr, label in _PHASE_ATTRS:
        if hasattr(eng, attr):
            setattr(eng, attr, timed(getattr(eng, attr), label))

    window = eng._prefill_window

    def prefill_window(slot, req, win, w, done):
        t0 = time.monotonic()
        out = window(slot, req, win, w, done)
        record("prefill" if done == 0 else "suffix_window", t0)
        return out

    runner = eng._round

    def round_(key, fn):
        t0 = time.monotonic()
        out = runner(key, fn)
        record("verify_scan" if "verify" in key[0] else "decode_chunk", t0)
        return out

    eng._prefill_window = prefill_window
    eng._round = round_
    return phases


class Serving:
    """The reference's serving matrix on the card, over one bf16 serving
    snapshot and one request-token source for every entry."""

    BLOCK = 64

    def __init__(self, result, params, sparams, qparams, cfg, tokens,
                 batch, null_dt, null_ok, note_exc, release, note):
        from kind_tpu_sim_torch.models import decode, serving

        self.serving = serving
        self.result, self.cfg, self.batch = result, cfg, batch
        self.params, self.qparams = params, qparams
        self.device = params["embed"].device
        self.null_dt, self.null_ok = null_dt, null_ok
        self.note_exc, self.release, self.note = note_exc, release, note
        # one snapshot for every engine entry; a failure here (memory
        # pressure) must skip the serving matrix, not what comes after
        try:
            self.sp = (sparams if sparams is not None
                       else decode.serving_params(params, cfg))
            self.tokens_h = tokens.cpu().numpy()
        except Exception as exc:
            result["serving_snapshot_error"] = note_exc(exc)
            self.sp = None
        # pool sized to the workload (256-token prompts + 192 new, 16
        # slots' worth), not slots x max_len
        self.pool_blocks = 1 + 2 * batch * ((256 + 192) // self.BLOCK + 1)

    def require_serving(self):
        """The gate every entry runs first."""
        if self.sp is None:
            raise RuntimeError("serving snapshot unavailable "
                               "(serving_snapshot_error has the cause)")
        if self.result.get("device_poisoned"):
            raise RuntimeError(
                "device poisoned by an earlier out-of-memory error")

    def canonical_stream(self, key: str, n_req: int, lens=(192, 224, 256),
                         news=(64, 128, 192)):
        """The shared request stream: the same RandomState(0) draw for
        every engine, so entries compare the engine, not the
        workload."""
        rng = np.random.RandomState(0)
        reqs = []
        for i in range(n_req):
            p_len = int(rng.choice(lens))
            max_new = int(rng.choice(news))
            reqs.append(self.serving.Request(
                f"{key}{i}", self.tokens_h[0, :p_len].tolist(), max_new))
        return reqs

    def uniform_stream(self, key: str, n_req: int, p_len: int,
                       max_new: int):
        """Every request the same shape, so slots retire in lockstep and
        the grid stays full: the saturation workload."""
        return [self.serving.Request(
            f"{key}{i}",
            ((self.tokens_h[0, :p_len] + i) % self.cfg.vocab_size).tolist(),
            max_new) for i in range(n_req)]

    def motif_stream(self, key: str, n_req: int):
        """Repetitive prompts whose continuations the prompt-lookup draft
        predicts: the high-acceptance stream."""
        motif = self.tokens_h[0, :8]
        return [self.serving.Request(
            f"{key}{i}",
            ((np.resize(motif, 192) + i) % self.cfg.vocab_size).tolist(),
            512) for i in range(n_req)]

    def measure_engine(self, key: str, eng, reqs, warm_lens=(256,)):
        """Warm the engine (its admission dispatches, and one request a
        prompt bucket, whose rounds capture the engine's graphs), then
        run ``reqs`` with per-phase accounting. Returns the (live) entry
        dict stored at result[key]."""
        return measure_engine(self.result, key, eng, reqs, self.tokens_h,
                              self.null_dt, self.null_ok, warm_lens)

    def run_serving(self, key: str, reqs=None, params_override=None,
                    cfg_override=None, **cfg_extra):
        """One dense-grid engine measurement (the canonical stream by
        default)."""
        self.require_serving()
        sp = params_override if params_override is not None else self.sp
        mcfg = cfg_override if cfg_override is not None else self.cfg
        cfg_extra.setdefault("chunk", 64)
        sc = self.serving.ServingConfig(max_slots=self.batch, max_len=1024,
                                        **cfg_extra)
        eng = self.serving.ServingEngine(sp, mcfg, sc, device=self.device)
        self.measure_engine(key, eng, reqs if reqs is not None
                            else self.canonical_stream(key, 2 * self.batch))

    def run_longprompt(self, key: str, LONG: int = 768, max_len: int = 1024,
                       **cfg_extra):
        """Short co-tenants decode while one LONG-token prompt admits:
        the short requests' e2e latency is the number that moves."""
        self.require_serving()
        serving, th, batch = self.serving, self.tokens_h, self.batch
        t_sec = time.monotonic()
        sc = serving.ServingConfig(max_slots=batch, max_len=max_len,
                                   chunk=64, **cfg_extra)
        eng = serving.ServingEngine(self.sp, self.cfg, sc,
                                    device=self.device)
        long_prompt = np.resize(th[0], LONG).tolist()
        eng.warm_admission((224,))
        eng.warm_admission((LONG,), sizes=(1,))
        eng.submit(serving.Request("warm", th[0, :256].tolist(), 2))
        eng.submit(serving.Request(
            "warmL", [(t + 1) % self.cfg.vocab_size for t in long_prompt],
            2))
        eng.run()
        eng.reset_latency()
        for i in range(batch):
            eng.submit(serving.Request(f"{key}s{i}", th[0, :224].tolist(),
                                       96))
        eng.submit(serving.Request(f"{key}L", list(long_prompt), 64))
        profiling.synchronize()
        t0 = time.monotonic()
        done = {c.request_id: c for c in eng.run()}
        profiling.synchronize()
        wall = time.monotonic() - t0
        shorts = [c for rid, c in done.items() if rid != f"{key}L"]
        e2es = sorted(c.e2e_s for c in shorts)
        self.result[key] = {
            "short_requests": len(shorts),
            "long_prompt": LONG,
            "wall_s": round(wall, 2),
            "short_e2e_p50_s": round(e2es[len(e2es) // 2], 3),
            "short_e2e_max_s": round(e2es[-1], 3),
            "long_ttft_s": round(done[f"{key}L"].ttft_s, 3),
        }
        SECTION_S[key] = round(time.monotonic() - t_sec, 1)

    def run_paged(self, key: str, **cfg_extra):
        """One paged-engine measurement over the canonical stream."""
        self.require_serving()
        cfg_extra.setdefault("paged_width", 8)
        sc = self.serving.ServingConfig(
            max_slots=self.batch, max_len=1024, chunk=64,
            paged_blocks=self.pool_blocks, block_size=self.BLOCK,
            **cfg_extra)
        eng = self.serving.PagedServingEngine(self.sp, self.cfg, sc,
                                              device=self.device)
        entry = self.measure_engine(
            key, eng, self.canonical_stream(key, 2 * self.batch,
                                            lens=[192, 224, 256]))
        entry.update({
            "pool_blocks": self.pool_blocks,
            "block_size": self.BLOCK,
            "preemptions": eng.preemptions,
            "kv_positions_vs_grid": round(
                self.pool_blocks * self.BLOCK
                / (self.batch * sc.max_len), 3),
        })

    def run_spec(self, key: str, engine_cls, reqs=None, **cfg_extra):
        """One speculative-engine measurement (k 4; the canonical stream
        by default)."""
        self.require_serving()
        sc = self.serving.ServingConfig(max_slots=self.batch, max_len=1024,
                                        speculative_k=4, **cfg_extra)
        eng = engine_cls(self.sp, self.cfg, sc, device=self.device)
        self.measure_engine(key, eng, reqs if reqs is not None
                            else self.canonical_stream(key, 2 * self.batch))

    def run_latency(self, key: str, **sc_extra):
        """Two slots, a latency-bound stream: the dense grid at a small
        chunk against the speculative grid at a small W."""
        self.require_serving()
        serving = self.serving
        sc = serving.ServingConfig(max_slots=2, max_len=1024, **sc_extra)
        eng_cls = (serving.SpeculativeServingEngine
                   if sc_extra.get("speculative_k")
                   else serving.ServingEngine)
        eng = eng_cls(self.sp, self.cfg, sc, device=self.device)
        self.measure_engine(key, eng, self.canonical_stream(
            key, 2, lens=(224,), news=(128,)))

    def entries(self):
        """(key, measurement) in the order they run."""
        serving, b = self.serving, self.batch
        uni = self.uniform_stream
        return (
            ("serving", lambda k: self.run_serving(k)),
            ("serving_chunked_prefill",
             lambda k: self.run_serving(k, prefill_chunk=64)),
            ("serving_paged", lambda k: self.run_paged(k)),
            ("serving_paged_kernel",
             lambda k: self.run_paged(k, paged_kernel=True)),
            ("serving_speculative",
             lambda k: self.run_spec(k, serving.SpeculativeServingEngine)),
            ("serving_paged_spec",
             lambda k: self.run_spec(
                 k, serving.PagedSpeculativeServingEngine,
                 paged_blocks=self.pool_blocks, block_size=self.BLOCK,
                 paged_width=8)),
            ("serving_longprompt", lambda k: self.run_longprompt(k)),
            ("serving_longprompt_chunked",
             lambda k: self.run_longprompt(k, prefill_chunk=64)),
            ("serving_saturated",
             lambda k: self.run_serving(k, chunk=256,
                                        reqs=uni(k, 2 * b, 192, 512))),
            ("serving_saturated_512",
             lambda k: self.run_serving(k, chunk=512,
                                        reqs=uni(k, 2 * b, 192, 512))),
            ("serving_overlap",
             lambda k: self.run_serving(k, overlap_rounds=True)),
            ("serving_saturated_overlap",
             lambda k: self.run_serving(k, chunk=256, overlap_rounds=True,
                                        reqs=uni(k, 2 * b, 192, 512))),
            ("serving_rtt_bound",
             lambda k: self.run_serving(k, chunk=8,
                                        reqs=uni(k, 2 * b, 192, 128))),
            ("serving_rtt_bound_overlap",
             lambda k: self.run_serving(k, chunk=8, overlap_rounds=True,
                                        reqs=uni(k, 2 * b, 192, 128))),
            ("serving_saturated_int8", self.run_saturated_int8),
            ("serving_speculative_long",
             lambda k: self.run_spec(k, serving.SpeculativeServingEngine,
                                     reqs=uni(k, 2 * b, 192, 512),
                                     spec_windows=16)),
            ("serving_speculative_w16",
             lambda k: self.run_spec(k, serving.SpeculativeServingEngine,
                                     spec_windows=16)),
            ("serving_latency_dense",
             lambda k: self.run_latency(k, chunk=8)),
            ("serving_latency_spec",
             lambda k: self.run_latency(k, speculative_k=4,
                                        spec_windows=2)),
            ("serving_speculative_flip",
             lambda k: self.run_spec(k, serving.SpeculativeServingEngine,
                                     reqs=self.motif_stream(k, 2 * b),
                                     spec_windows=64)),
            ("serving_dense_flip_twin",
             lambda k: self.run_serving(k, chunk=256, overlap_rounds=True,
                                        reqs=self.motif_stream(k, 2 * b))),
            ("serving_longprompt_4k",
             lambda k: self.run_longprompt(k, LONG=4096, max_len=4224)),
            ("serving_longprompt_4k_chunked",
             lambda k: self.run_longprompt(k, LONG=4096, max_len=4224,
                                           prefill_chunk=64)),
        )

    def run_saturated_int8(self, key: str):
        """W8A8 + int8 KV through the saturated pipelined schedule (a
        rate, not a stream-equality check)."""
        from kind_tpu_sim_torch.models import quant

        cfg_q = dataclasses.replace(self.cfg, int8_kv=True,
                                    int8_native=True)
        qp = (self.qparams if self.qparams is not None
              else quant.quantize_params(self.params, cfg_q))
        self.run_serving(key, params_override=qp, cfg_override=cfg_q,
                         chunk=256, overlap_rounds=True,
                         reqs=self.uniform_stream(key, 2 * self.batch, 192,
                                                  512))

    def run_all(self) -> None:
        for key, measure in self.entries():
            try:
                measure(key)
            except Exception as exc:
                self.result[key + "_error"] = self.note_exc(exc)
            self.release()
            self.note()


def measure_engine(result: dict, key: str, eng, reqs, tokens_h,
                   null_dt: float, null_ok: bool, warm_lens=(256,)) -> dict:
    """The shared engine measurement: warm the engine's admission
    dispatches and one request a prompt bucket (on a card its rounds
    capture the engine's graphs), then run ``reqs`` with per-phase
    accounting (``instrument_phases``). Stores the entry at
    ``result[key]`` and returns it."""
    from kind_tpu_sim_torch.models import graphs, serving

    t_sec = time.monotonic()
    eng.warm_admission(warm_lens)
    for j, wl in enumerate(warm_lens):
        eng.submit(serving.Request(
            f"warm{j}", np.resize(tokens_h[0], wl).tolist(), 2))
    eng.run()
    runner = eng._round
    phases = instrument_phases(eng)
    if hasattr(eng, "verify_steps"):
        eng.verify_steps = 0  # warm-up windows are not serving
    eng.reset_latency()
    for r in reqs:
        eng.submit(r)
    profiling.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    profiling.synchronize()
    wall = time.monotonic() - t0
    gen = sum(len(c.tokens) for c in done)
    if len(done) != len(reqs):
        raise RuntimeError(f"{key}: {len(done)} of {len(reqs)} requests "
                           "completed")
    jit_calls = sum(st[0] for lbl, st in phases.items()
                    if lbl not in _NON_DISPATCH_PHASES)
    device = wall - jit_calls * null_dt if null_ok else 0.0
    entry = {
        "requests": len(done),
        "generated_tokens": gen,
        "slots": eng.serving.max_slots,
        "wall_tokens_per_s": round(gen / wall),
        "dispatches": jit_calls,
        # sync readbacks (first tokens and retire fetches)
        "readbacks": sum(st[0] for lbl, st in phases.items()
                         if lbl in _READBACK_PHASES),
    }
    if device > 0.2 * wall:
        entry["device_tokens_per_s"] = round(gen / device)
    entry["phases"] = {lbl: {"n": st[0], "wall_s": round(st[1], 3)}
                       for lbl, st in sorted(phases.items())}
    entry["host_other_s"] = round(
        wall - sum(st[1] for st in phases.values()), 3)
    dc = phases.get("decode_chunk")
    if dc and dc[0]:
        # every chunk computes max_slots * chunk token rows whether or
        # not slots are live; each admission's first token came from
        # its prefill, not from a decode row
        rows = dc[0] * eng.serving.max_slots * eng.serving.chunk
        admits = phases.get("activate_host", [0, 0.0])[0]
        entry["decode_rows_computed"] = rows
        entry["decode_occupancy_pct"] = round(
            100.0 * max(gen - admits, 0) / rows, 1)
    if phases.get("verify_scan") and hasattr(eng, "verify_steps"):
        entry["draft_k"] = eng.serving.speculative_k
        entry["spec_windows"] = eng.serving.spec_windows
        entry["verify_steps"] = eng.verify_steps
        entry["tokens_per_window"] = round(
            gen / max(eng.verify_steps, 1), 2)
    lat = eng.report().get("latency")
    if lat:
        entry["latency"] = lat
    if isinstance(runner, graphs.RoundGraphs):
        entry["graphs"] = {"captured": runner.captured,
                           "capture_s": round(runner.capture_s, 3),
                           "replays": runner.replays}
    result[key] = entry
    SECTION_S[key] = round(time.monotonic() - t_sec, 1)
    return entry


# ---------------------------------------------------------------------
# the artifact


def headline_numbers(model) -> dict:
    """One scalar per model-bench section, small by construction.

    Dict-valued sections (serving engines) contribute their wall rate;
    scalar roofline/MFU keys pass through; errors are clipped to 60
    chars so a failed section is visible without bloating the
    summary."""
    if not isinstance(model, dict):
        return {}
    h: dict = {}
    for k in ("fwd_tokens_per_s", "fwd_mfu_pct", "train_mfu_pct",
              "train_step_tokens_per_s", "train_variant",
              "prefill_tokens_per_s", "decode_tokens_per_s",
              "decode_gbps", "decode_int8_tokens_per_s",
              "fwd_4k_flash_tokens_per_s", "fwdbwd_4k_flash_tokens_per_s",
              "fwdbwd_4k_tokens_per_s"):
        if k in model:
            h[k] = model[k]
    for k, v in model.items():
        if isinstance(v, dict):
            if "wall_tokens_per_s" in v:
                h[k] = v["wall_tokens_per_s"]
                if "device_tokens_per_s" in v:
                    h[k + "_dev"] = v["device_tokens_per_s"]
            elif "short_e2e_p50_s" in v:
                h[k] = v["short_e2e_p50_s"]
        elif k.endswith("_error"):
            h[k] = str(v)[:60]
    return h


def emit_result(out: dict, out_path: str | None,
                compact_extra: dict | None = None,
                default_name: str = "BENCH_FULL_MODEL.json") -> None:
    """Write the full record to a file, print it, then print the compact
    summary as the last line."""
    full_line = json.dumps(out)
    full_path = (pathlib.Path(out_path) if out_path
                 else REPO / default_name)
    wrote = True
    try:
        full_path.write_text(full_line + "\n")
    except OSError as exc:
        wrote = False  # a pointer to a missing or stale file would read
        #                as this capture's evidence
        print(f"warning: could not write {full_path}: {exc}",
              file=sys.stderr)
    print(full_line)
    compact = {
        "metric": out.get("metric"),
        "value": out.get("value"),
        "unit": out.get("unit"),
        "vs_baseline": out.get("vs_baseline"),
        "mode": out.get("mode"),
        "full": full_path.name if wrote else None,
    }
    if compact_extra:
        compact.update(compact_extra)
    print(json.dumps(compact), flush=True)


def card_identity(device) -> dict:
    """The card's name and power limit, as nvidia-smi prints them."""
    dev = resolve(device)
    if dev.type != "cuda":
        return {"device": dev.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    index = dev.index if dev.index is not None else 0
    return {"device": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi[index]}


def bench_model_only(out_path: str | None, device="cuda") -> int:
    """``--model-only``: capture the flagship model numbers and write
    them to an artifact with the reference's shape. The status names the
    outcome: "ok" (clean), "partial" (some sections recorded errors) or
    "capture-failed" (a whole-pass error or a poisoned device)."""
    identity = card_identity(device)
    m = model_throughput(device=device)
    ok = "error" not in m and not m.get("device_poisoned")
    errs = [k for k in m if k.endswith("_error")]
    status = ("capture-failed" if not ok
              else ("partial" if errs else "ok"))
    artifact = {
        "metric": "gpu_model_throughput",
        "mode": "model-only",
        "status": status,
        **identity,
        "model": m,
        "section_seconds": dict(SECTION_S),
        "captured_unix": int(time.time()),
    }
    emit_result(artifact, out_path, {"status": status,
                                     "headline": headline_numbers(m)})
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m kind_tpu_sim_torch.bench",
        description="the flagship model block of the bench on one card")
    ap.add_argument("--model-only", action="store_true", required=True,
                    help="the model block (the one mode of this bench)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default BENCH_FULL_MODEL.json "
                    "at the repository root)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return bench_model_only(args.out, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
