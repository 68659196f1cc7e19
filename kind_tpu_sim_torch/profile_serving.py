"""Where the time of flagship paged serving goes on the card.

    python3 -m kind_tpu_sim_torch.profile_serving [--gather | --speculative]
        [--out FILE]

Serves the flagship workload (``bench_config_large`` with ``flash=True``,
random bf16 weights from seed 0; 16 greedy requests with 192/224/256-
token prompts and 128 new tokens each, on 8 slots, chunk 64, a pool of
129 blocks x 64 positions, table width 8) through
``PagedServingEngine`` on the paged-kernel tier (``--gather``: the
gather tier), after one short request through the same engine (the
kernels build and the engine captures its round's CUDA graph), then
serves it again with ``torch.profiler`` tracing one pure decode round
(the second round: the first wave's 8 slots, 64 tokens each, no
admission). Prints one JSON object:

* ``wall_s``, ``tok_per_s``, ``ttft_mean_s``, ``e2e_mean_s`` -- the
  untraced run, host clock around work that ends in a synchronize;
* ``round_wall_ms`` and ``step_wall_ms`` -- the traced round on the
  host clock, and per decode step (one token for every slot);
* ``device_busy_ms`` and ``device_busy_share`` -- the sum of the
  round's kernel times (one stream, so kernels do not overlap) and its
  share of the round's wall time;
* ``device_ops_per_step`` -- kernels and copies the device ran per
  decode step: the kernel nodes of the round's CUDA graph, over its
  steps;
* ``kernels`` -- device time by kernel name, largest first, and
  ``host_syncs`` -- the round's stream/device synchronisations and
  blocking host-to-device copies, by CUDA runtime call;
* ``graphs`` -- the engine's graphs captured, the seconds spent
  capturing them and the replays.

The traced round is a replay: the engine captures its round's CUDA
graph in the round before (``models/graphs.py``).

With ``--speculative`` the stream goes through
``SpeculativeServingEngine`` instead (k 4, 4 verify windows a round, the
bench's ``serving_speculative``), and the traced round is one scanned
verify dispatch (four windows in one graph) and its readback;
``step_wall_ms`` and ``device_ops_per_step`` are then per window.

Run it on the card (it raises without one).

``realistic_serving`` and ``realistic_requests`` define the realistic
stream (prompt admission under pool pressure: prefix families, mixed
prompt lengths, admission waves) that ``chip_smoke.py`` serves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from kind_tpu_sim_torch.models import decode, serving
from kind_tpu_sim_torch.models import transformer as tf

SLOTS, BLOCK, CHUNK = 8, 64, 64
PROMPT_LENS = (192, 224, 256)
# pool sized to the workload: 2 x slots worth of 448-position sequences
POOL_BLOCKS = 1 + 2 * SLOTS * ((256 + 192) // BLOCK + 1)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def flagship_config() -> tf.ModelConfig:
    return dataclasses.replace(tf.bench_config_large(), flash=True)


def flagship_serving(paged_kernel: bool) -> serving.ServingConfig:
    return serving.ServingConfig(
        max_slots=SLOTS, max_len=1024, chunk=CHUNK, paged_blocks=POOL_BLOCKS,
        block_size=BLOCK, paged_width=8, paged_kernel=paged_kernel)


def flagship_requests(vocab: int, n: int = 16, max_new: int = 128,
                      logprobs: bool = False):
    """``n`` greedy requests; prompt lengths and tokens drawn from
    ``np.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    lens = rng.choice(PROMPT_LENS, size=n)
    return [serving.Request(f"q{i}", rng.randint(0, vocab, size=int(p))
                            .tolist(), max_new, logprobs=logprobs)
            for i, p in enumerate(lens)]


REALISTIC_LENS = (224, 1024, 2048, 3072)   # bench.py:1279
# The realistic stream's sizes; the bench's own in brackets, where this
# stream cuts it for card time:
REALISTIC_INDEPENDENT = 16      # independent requests (40, bench.py:1277)
REALISTIC_FAMILIES = 4          # prefix families (8, bench.py:1292)
REALISTIC_MAX_NEW = 128         # new tokens a request (512, bench.py:1291)
REALISTIC_HEAD = 1024           # a family's head (bench.py:1293)
REALISTIC_SUFFIXES = (96, 128)  # its members' suffixes (bench.py:1302)
LONG = 768                      # the long prompt (bench.py:1057)


def realistic_serving(pool_blocks: int = 192) -> serving.ServingConfig:
    """The reference bench's realistic engine (``bench.py:1256-1274``) on
    the paged-kernel tier: 8 slots, ``max_len`` 3648, chunk 64, blocks
    of 64 positions, a fixed table width of 64, 8 prefix-cache entries,
    admission waves of (1, 4, 8). The pool is 192 blocks by default (the
    bench passes its 272), far under the 8 x 50 blocks that eight
    3072-token prompts with their outputs would take, so growth
    preempts."""
    return serving.ServingConfig(
        max_slots=8, max_len=3648, chunk=64, paged_blocks=pool_blocks,
        block_size=64, paged_width=64, paged_kernel=True,
        prefix_cache_entries=8, admission_wave_sizes=(1, 4, 8))


def realistic_requests(vocab: int, logprobs: bool = False, *,
                       independents: int = REALISTIC_INDEPENDENT,
                       families: int = REALISTIC_FAMILIES,
                       max_new: int = REALISTIC_MAX_NEW, base=None,
                       key: str = "r"):
    """The reference bench's realistic stream (``bench.py:1276-1338``),
    cut for card time by default (the ``REALISTIC_*`` constants above;
    the bench passes its own sizes): ``independents`` requests with
    prompts of ``REALISTIC_LENS`` tokens drawn with ``RandomState(7)``,
    and ``families`` prefix families, each a 1024-token head with
    ``cache_prefix=True`` and one member per suffix length extending it;
    ``max_new`` new tokens a request. Prompt tokens tile ``base`` (by
    default one 1024-token row from ``RandomState(0)``; the bench passes
    its token batch's first row, as the reference's does), shifted per
    request. Request ids are the reference's with ``key`` as their
    prefix. The order is the bench's: a seeded permutation with each
    family's head ahead of its members."""
    rng = np.random.RandomState(7)
    if base is None:
        base = np.random.RandomState(0).randint(0, vocab, size=1024)
    reqs = []
    for i in range(independents):
        p_len = int(rng.choice(REALISTIC_LENS))
        reqs.append(serving.Request(
            f"{key}{i}", ((np.resize(base, p_len) + i) % vocab).tolist(),
            max_new, logprobs=logprobs))
    fam_of = {}
    for f in range(families):
        shared = ((np.resize(base, REALISTIC_HEAD) + 1000 + f)
                  % vocab).tolist()
        reqs.append(serving.Request(f"{key}f{f}h", shared, max_new,
                                    cache_prefix=True, logprobs=logprobs))
        fam_of[f"{key}f{f}h"] = f
        for m, n in enumerate(REALISTIC_SUFFIXES):
            sfx = ((np.resize(base, n) + 7 * f + m) % vocab).tolist()
            reqs.append(serving.Request(f"{key}f{f}m{m}", shared + sfx,
                                        max_new, logprobs=logprobs))
            fam_of[f"{key}f{f}m{m}"] = f
    heads = {f"{key}f{f}h" for f in range(families)}
    seen_head, order, deferred = set(), [], {}
    for idx in rng.permutation(len(reqs)).tolist():
        r = reqs[idx]
        f = fam_of.get(r.request_id)
        if f is None or r.request_id in heads:
            order.append(r)
            if f is not None:
                seen_head.add(f)
                order.extend(deferred.pop(f, []))
        elif f in seen_head:
            order.append(r)
        else:
            deferred.setdefault(f, []).append(r)
    for rs in deferred.values():
        order.extend(rs)
    return order


def longprompt_serving(prefill_chunk: int = 0) -> serving.ServingConfig:
    """The reference bench's long-prompt engine (``bench.py:1056-1075``):
    the dense grid of 8 slots, ``max_len`` 1024, chunk 64, optionally
    with chunked prefill."""
    return serving.ServingConfig(max_slots=SLOTS, max_len=1024, chunk=CHUNK,
                                 prefill_chunk=prefill_chunk)


def longprompt_requests(vocab: int):
    """The bench's long-prompt stream (``bench.py:1094-1100``): 8 requests
    of 224 tokens with 96 new, then one ``LONG``-token request with 64
    new behind them (prompt tokens from ``RandomState(0)``)."""
    base = np.random.RandomState(0).randint(0, vocab, size=1024)
    reqs = [serving.Request(f"s{i}", base[:224].tolist(), 96)
            for i in range(SLOTS)]
    return reqs + [serving.Request("L", np.resize(base, LONG).tolist(), 64)]


def flagship_params(cfg: tf.ModelConfig):
    """The bf16 serving snapshot of random weights from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return decode.serving_params(tf.init_params(cfg, gen, "cuda"), cfg)


def _profile_round(eng) -> dict:
    """Trace one step_round of ``eng``: a pure decode round (a chunk of
    decode steps, or a speculative engine's verify windows) and its
    readback. On a card that round is one CUDA graph replay once the
    engine has captured its key."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    steps = (eng.serving.spec_windows if eng.serving.speculative_k
             else eng.serving.chunk)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, syncs, launches = {}, {}, 0
    # the raw events: building the profiler's event tree
    # (``key_averages``) takes seconds for each 10,000 operations
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.duration_ns() > 0 and not ev.is_user_annotation():
                kernels[name] = kernels.get(name, 0.0) + ev.duration_ns() / 1e6
                launches += 1
        elif name.startswith(SYNC_CALLS):
            syncs[name] = syncs.get(name, 0) + 1
    busy = sum(kernels.values())
    return {"round_wall_ms": wall * 1e3,
            "step_wall_ms": wall * 1e3 / steps,
            "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "device_ops_per_step": launches / steps,
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
            "host_syncs": syncs}


def run(paged_kernel: bool = True, speculative: bool = False) -> dict:
    cfg = flagship_config()
    params = flagship_params(cfg)
    reqs = flagship_requests(cfg.vocab_size)

    def new_engine():
        if speculative:
            return serving.SpeculativeServingEngine(
                params, cfg, serving.ServingConfig(
                    max_slots=SLOTS, max_len=1024, speculative_k=4,
                    spec_windows=4))
        return serving.PagedServingEngine(params, cfg,
                                          flagship_serving(paged_kernel))

    def submit(eng):
        for r in reqs:
            eng.submit(dataclasses.replace(r))

    eng = new_engine()
    # the kernels build and the engine captures its round's graph
    eng.submit(dataclasses.replace(reqs[0], request_id="warm", max_new=65))
    eng.run()
    windows0 = getattr(eng, "verify_steps", 0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    submit(eng)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in done)
    windows = getattr(eng, "verify_steps", 0) - windows0

    submit(eng)
    eng.step_round()  # admits the first wave, decodes its first round
    prof = _profile_round(eng)  # a pure decode round: a graph replay
    tier = ("speculative" if speculative
            else "kernel" if paged_kernel else "gather")
    if speculative:
        prof.update(verify_steps=windows, tokens_per_window=tokens / windows)
    prof["graphs"] = {"captured": eng._round.captured,
                      "capture_s": eng._round.capture_s,
                      "replays": eng._round.replays}
    return {"tier": tier,
            "device": torch.cuda.get_device_name(0),
            "requests": len(done), "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "ttft_mean_s": float(np.mean([c.ttft_s for c in done])),
            "e2e_mean_s": float(np.mean([c.e2e_s for c in done])),
            **prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    tier = ap.add_mutually_exclusive_group()
    tier.add_argument("--gather", action="store_true",
                      help="the gather tier instead of the paged kernel")
    tier.add_argument("--speculative", action="store_true",
                      help="SpeculativeServingEngine, one verify round "
                      "traced")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(paged_kernel=not args.gather, speculative=args.speculative)
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
