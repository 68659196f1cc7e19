"""Speculative decoding, in PyTorch: prompt-lookup or draft-model
drafts, exact greedy verify, rejection-sampled acceptance.

Counterpart of ``kind_tpu_sim/models/speculative.py``. A verify window
runs the row's last emitted token and k drafted tokens through the
model in one forward (weights read once for up to k+1 tokens) and
keeps the longest prefix the model itself would have produced, plus
one bonus token. Drafts come from prompt lookup (``propose_ngram``: the
tokens that followed the most recent earlier occurrence of the row's
current bigram) or from a small draft model (``_draft_propose``).

Per-row accept counts are ragged, as the serving grid's lengths are:
every row carries its own ``total`` (tokens in its ``out`` buffer) and
its window attends the cache masked at its own base. The window's k/v
is written for the whole window each step; entries past the accepted
prefix are stale, masked from later windows by ``total`` and
overwritten by the next window, which starts at or before them.

The JAX package's ``lax.scan`` over windows is a Python loop here that
never reads the device: ``out``, ``total`` and the accept counts stay
on the card until the caller's one readback of the round. Sampled
rows need random draws inside that loop, at generation indices only
the device knows, so their draws come from a counter-based hash of
(request seed, generation index, stream) computed on the device
(``decode._counter_uniform``, the same hash the plain decode steps
draw from): the acceptance uniform is stream 0, the bonus token's
Gumbel noise stream 1. A sampled stream is thereby a pure
function of (request, seed), whatever the window count, the slot or
the co-tenants; it is not the JAX package's stream (``jax.random``),
while its law is the same. Greedy streams equal the JAX package's.

The window attention (``_window_block``) is plain PyTorch, as the
reference's is plain XLA: fp32 scores from the stored values, one
softmax over the cache and window groups, probabilities rounded to the
value dtype before each PV product and each product rounded to it. An
int8 cache is read as ``decode._cache_scores`` / ``_cache_values`` read
it (the window's positions folded into one product a (slot, kv head);
with ``int8_native`` the exact int8 kernel), its window rows quantized
at the write; an MoE routes each window position over the slots.
Prompt admission uses it too: a prefix-cache hit runs its prompt's
suffix through it, and so does every chunked-prefill window after the
first (``serving._suffix_into_slot``, ``paged.paged_suffix``).
"""

from __future__ import annotations

from typing import Dict

import torch

from kind_tpu_sim_torch.device import resolve, torch_dtype
from kind_tpu_sim_torch.models.decode import (
    NEG,
    _cache_scores,
    _cache_values,
    _counter_gumbel,
    _counter_uniform,
    _filtered_scaled,
    _finish_block,
    _write,
    prefill,
)
from kind_tpu_sim_torch.models.quant import embed_lookup, linear
from kind_tpu_sim_torch.models.transformer import (
    ModelConfig,
    Params,
    _readout,
    _rms_norm,
    _rotary,
    _split_qkv,
    local_heads,
)

def _at(out, pos):
    """out[r, pos[r]] for each row, the position clamped into the row
    (a row that ran past its buffer's end, whose results are discarded,
    reads its last entry)."""
    pos = torch.clamp(pos, 0, out.shape[1] - 1).long()
    return out.gather(1, pos[:, None])[:, 0]


def propose_ngram(out, total, k: int):
    """Prompt-lookup draft: (b, k) guesses from the most recent earlier
    occurrence of each row's current bigram. ``out`` (b, L) holds the
    emitted tokens, ``total`` (b,) how many are real. A row whose
    bigram never occurred before repeats its last token."""
    b, L = out.shape
    dev = out.device
    idx = torch.arange(L, device=dev)[None, :]
    last = _at(out, total - 1)[:, None]
    prev = _at(out, total - 2)[:, None]
    # out[p-1] for each p (p = 0 reads out[0])
    shifted = torch.cat([out[:, :1], out[:, :-1]], dim=1)
    match = ((out == last) & (shifted == prev)
             & (idx < (total - 1)[:, None]) & (idx >= 1))
    p = torch.where(match, idx, torch.full_like(idx, -1)).amax(dim=1)
    start = torch.clamp(p + 1, 0, L - k)
    draft = out.gather(1, start[:, None] + torch.arange(k, device=dev))
    return torch.where((p >= 0)[:, None], draft, last)


def _window_block(x, bparams, cfg: ModelConfig, layer_cache, base):
    """One block over a (b, w, d) window attending to ``layer_cache``
    (per-layer {"k", "v"} of (b, s, kv, hd); row r masked at its own
    ``base[r]``, a (b,) integer tensor) plus causal attention within
    the window, whose position j sits at base + j. Returns (x_out,
    k, v): the window's rotated k/v (b, w, kv, hd) for the caller to
    write."""
    b, w, _ = x.shape
    dtype = torch_dtype(cfg.dtype)
    native = cfg.int8_native
    h = _rms_norm(x, bparams["attn_norm"])
    q, kk, vv = _split_qkv(linear(h, bparams["wqkv"], native=native,
                                  parallel="column"), cfg, b, w)
    positions = base[:, None] + torch.arange(w, device=x.device)[None, :]
    q = _rotary(q, positions)
    kk = _rotary(kk, positions)

    heads, kv = local_heads(cfg)
    scale = cfg.head_dim ** -0.5
    s_big = layer_cache["k"].shape[1]
    qg = q.reshape(b, w, kv, heads // kv, cfg.head_dim)
    sc_big = _cache_scores(qg, layer_cache["k"], scale, native)
    big_mask = (torch.arange(s_big, device=x.device)[None, :]
                < base[:, None])                               # (b, s)
    sc_big = sc_big.masked_fill(~big_mask[:, None, None, None, :], NEG)
    sc_win = torch.einsum("bwkgd,bvkd->bwkgv", qg.float(),
                          kk.float()) * scale
    causal = torch.tril(torch.ones((w, w), dtype=torch.bool,
                                   device=x.device))
    sc_win = sc_win.masked_fill(~causal[None, :, None, None, :], NEG)

    probs = torch.softmax(torch.cat([sc_big, sc_win], dim=-1), dim=-1)
    attn_big = _cache_values(probs[..., :s_big], layer_cache["v"], dtype,
                             native)
    attn_win = torch.einsum(
        "bwkgv,bvkd->bwkgd", probs[..., s_big:].to(dtype).float(),
        vv.float()).to(dtype)
    attn = (attn_big + attn_win).reshape(b, w, -1)
    return _finish_block(x, attn, bparams, cfg), kk, vv


def _write_window(cache_arr, upd, starts, active=None) -> None:
    """Write ``upd`` (b, w, kv, hd) into ``cache_arr`` (b, s, kv, hd) at
    per-row offsets ``starts`` (b,), in place: one indexed write,
    quantized per row into an int8 cache. A start is clamped so the
    window fits, as the reference's ``dynamic_update_slice`` clamps it.
    Rows where ``active`` (b,) is False rewrite their current bytes."""
    b, w = upd.shape[:2]
    dev = upd.device
    starts = torch.clamp(starts, 0, cache_arr.shape[1] - w).long()
    rows = torch.arange(b, device=dev)[:, None]
    cols = starts[:, None] + torch.arange(w, device=dev)[None, :]
    keep = None if active is None else active[:, None, None, None]
    _write(cache_arr, (rows, cols), upd, keep)


def _write_rows(cache, rows, base, active=None) -> None:
    """Each layer's window k/v (``_window_forward``'s rows) into the
    cache grid at each row's ``base``; inactive rows keep their bytes.
    The reference writes inactive rows too, which overwrites the first
    rows of a slot whose prompt is still streaming in by chunked
    prefill (its total is stale, its base clamps to 0); masking keeps
    them."""
    for lc, r in zip(cache, rows):
        _write_window(lc["k"], r["k"], base, active)
        _write_window(lc["v"], r["v"], base, active)


def _verify_step(params, cache, out, total, *, cfg: ModelConfig, k: int):
    """One speculative step: draft k, verify k+1, accept the longest
    model-agreeing prefix (>= 1 token emitted per row per step). The
    cache and ``out`` are written in place. Returns (out, total, m)."""
    draft, base, logits, rows = _window_forward(params, cache, out, total,
                                                cfg=cfg, k=k)
    _write_rows(cache, rows, base)
    active = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
    out, total, _, m, _ = _accept_and_emit(logits, draft, out, total, active,
                                           None, k=k)
    return out, total, m


def _pad_draft(draft, k: int):
    """draft (b, k) widened to (b, k+1) so emit-index selects apply."""
    return torch.cat([draft, draft[:, -1:]], dim=1)


def _rejection_select(probs, draft, u, seeds, gidx):
    """Modified rejection sampling for a deterministic proposal (the
    vLLM scheme for n-gram and argmax-draft proposals under sampling):
    accept draft d_j with probability p_j(d_j) (u_j < p); at the first
    rejection m emit a token from the residual p_m with d_m zeroed;
    with every draft accepted (m == k) a plain sample from position
    k's distribution. The emitted token's law at every position is
    exactly p.

    probs (b, k+1, vocab) per-request filtered target distributions,
    draft (b, k), u (b, k+1) uniforms, seeds (b, 2) and gidx (b, k+1)
    each position's generation index: the bonus token is the Gumbel-max
    draw over the residual with noise ``_counter_gumbel(seeds,
    gidx[m], vocab)``, the noise a plain decode step draws at that
    index. Returns (m, bonus)."""
    b, k1, vocab = probs.shape
    k = k1 - 1
    p_draft = probs[:, :k].gather(-1, draft[..., None].long())[..., 0]
    accept = u[:, :k] < p_draft
    m = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    probs_m = probs.gather(1, m[:, None, None].expand(b, 1, vocab))[:, 0]
    draft_m = _pad_draft(draft, k).gather(1, m[:, None])[:, 0]
    is_draft = (torch.arange(vocab, device=probs.device)[None, :]
                == draft_m[:, None])
    resid = torch.where(is_draft & (m < k)[:, None],
                        torch.zeros_like(probs_m), probs_m)
    gumbel = _counter_gumbel(seeds, gidx.gather(1, m[:, None])[:, 0], vocab)
    bonus = torch.argmax(torch.log(resid + 1e-30) + gumbel, dim=-1)
    return m, bonus


def _grid_verify_step(params, cache, out, total, active, sampling=None, *,
                      cfg: ModelConfig, k: int, draft=None):
    """One speculative step over the serving grid: like ``_verify_step``
    with an ``active`` mask (inactive slots compute too; their state,
    ``out`` row and cache rows are left as they are) and, when
    ``sampling`` (``graphs.RoundInputs.sampling``'s device tuple) is
    given, rejection-sampled acceptance for temp > 0 rows. Returns (out,
    total, emit (b, k+1), m, lp (b, k+1)): row b's new tokens are
    emit[b, :m[b]+1], lp their raw-model logprobs."""
    draft, base, logits, rows = _window_forward(params, cache, out, total,
                                                cfg=cfg, k=k, draft=draft)
    _write_rows(cache, rows, base, active)
    return _accept_and_emit(logits, draft, out, total, active, sampling, k=k)


def _window_forward(params, cache_like, out, total, *, cfg: ModelConfig,
                    k: int, draft=None):
    """Shared front half of every verify step: propose the draft
    (prompt lookup unless ``draft`` (b, k) is given), build the (last,
    draft) window and run it through the blocks against any big-cache
    representation (grid rows or a paged gather view). Returns (draft,
    base, fp32 logits (b, k+1, vocab), rows), rows[layer] = {"k", "v"}
    the window's k/v; writing them is the caller's (grid: per-row
    window write; paged: block scatter)."""
    if draft is None:
        draft = propose_ngram(out, total, k)
    base = total - 1
    window = torch.cat([_at(out, base)[:, None], draft], dim=1)
    x = embed_lookup(params["embed"], window, torch_dtype(cfg.dtype))
    rows = []
    for bparams, layer_cache in zip(params["blocks"], cache_like):
        x, kk, vv = _window_block(x, bparams, cfg, layer_cache, base)
        rows.append({"k": kk, "v": vv})
    x = _rms_norm(x, params["final_norm"])
    return (draft, base,
            _readout(x, params["embed"], cfg.int8_native).float(), rows)


def _accept_and_emit(logits, draft, out, total, active, sampling, *, k: int):
    """Shared back half of every verify step (grid and paged storage):
    greedy argmax acceptance, rejection-sampled acceptance for temp > 0
    rows when ``sampling`` is given, the emit window, and the in-place
    ``out`` write and the ``total`` update (active-masked). Returns
    (out, total, emit (b, k+1), m, lp (b, k+1)); lp is the raw-model
    log_softmax at each emitted token (positions past m are junk, as
    emit's are)."""
    from kind_tpu_sim_torch.models.serving import _raw_token_lp

    b, L = out.shape
    dev = out.device
    preds = torch.argmax(logits, dim=-1)
    agree = draft == preds[:, :-1]
    m = torch.cumprod(agree.long(), dim=1).sum(dim=1)
    bonus = preds.gather(1, m[:, None])[:, 0]
    if sampling is not None:
        # rep_pen is 1.0 on every row: the speculative engines refuse
        # penalties at submit
        temp, top_k, top_p, min_p, _rep_pen, seeds, prompt_len = sampling
        vocab = logits.shape[-1]

        def tile(v):
            return v.repeat_interleave(k + 1)

        probs = torch.softmax(_filtered_scaled(
            logits.reshape(b * (k + 1), vocab).float(), tile(temp),
            tile(top_k), tile(top_p), tile(min_p)), dim=-1).reshape(
                b, k + 1, vocab)
        # generation index of window position j: the window's first
        # token continues generation (total - prompt_len), the index
        # the chunk engine would fold the request key by
        gidx = ((total - prompt_len)[:, None]
                + torch.arange(k + 1, device=dev)[None, :])
        m_s, bonus_s = _rejection_select(
            probs, draft, _counter_uniform(seeds, gidx, 0), seeds, gidx)
        sampled = temp > 0.0
        m = torch.where(sampled, m_s, m)
        bonus = torch.where(sampled, bonus_s, bonus)

    m = torch.where(active, m, torch.zeros_like(m))
    emit_idx = torch.arange(k + 1, device=dev)[None, :]
    emit = torch.where(
        emit_idx < m[:, None], _pad_draft(draft, k),
        torch.where(emit_idx == m[:, None], bonus[:, None],
                    torch.zeros_like(bonus)[:, None]))
    rows = torch.arange(b, device=dev)[:, None]
    cols = torch.clamp(total, 0, L - (k + 1)).long()[:, None] + emit_idx
    out[rows, cols] = torch.where(active[:, None], emit.to(out.dtype),
                                  out[rows, cols])
    total = torch.where(active, total + m + 1, total)
    return out, total, emit, m, _raw_token_lp(logits, emit)


def _grid_verify_scan(params, cache, out, total, active, sampling=None,
                      *, cfg: ModelConfig, k: int, windows: int):
    """``windows`` verify windows in one dispatch (the JAX package's
    ``lax.scan`` over ``_grid_verify_step``; a loop here that never
    reads the device). Every input is a device tensor: ``active`` (b,)
    bool, ``sampling`` None (no row samples) or the tuple of
    ``graphs.RoundInputs.sampling``. Drafts for window i+1 come from the
    carried (out, total) exactly as from the engine's state; a slot
    that finishes mid-scan keeps computing until the scan ends and the
    host discards its surplus. ``out`` and ``total`` are updated in
    place. Returns (emits (W, b, k+1), ms (W, b), lps (W, b, k+1))."""
    def step(out, total):
        return _grid_verify_step(params, cache, out, total, active, sampling,
                                 cfg=cfg, k=k)

    return _scan_windows(step, out, total, windows)


def _scan_windows(step, out, total, windows: int):
    """``windows`` calls of ``step(out, total) -> (out, total, emit, m,
    lp)``, each fed the last one's buffer and totals (``step`` writes
    ``out`` in place); the last totals are written into ``total``.
    Returns (emits (W, b, k+1), ms (W, b), lps (W, b, k+1))."""
    emits, ms, lps = [], [], []
    totals = total
    for _ in range(windows):
        out, totals, emit, m, lp = step(out, totals)
        emits.append(emit)
        ms.append(m)
        lps.append(lp)
    total.copy_(totals)
    return torch.stack(emits), torch.stack(ms), torch.stack(lps)


def _grid_draft_verify_scan(params, draft_params, cache, draft_cache, out,
                            total, active, sampling=None, *,
                            cfg: ModelConfig, dcfg: ModelConfig, k: int,
                            windows: int):
    """``_grid_verify_scan`` with the n-gram proposer swapped for a
    draft model: each window first runs k+1 greedy steps of the small
    model over its own per-slot cache (``_draft_propose``), then the
    target verifies the proposed window. Acceptance is unchanged (the
    argmax draft is deterministic given state), so the exactness
    contracts carry over. Returns (emits, ms, lps)."""
    def step(out, total):
        draft = _draft_propose(draft_params, draft_cache, out, total,
                               dcfg=dcfg, k=k)
        return _grid_verify_step(params, cache, out, total, active, sampling,
                                 cfg=cfg, k=k, draft=draft)

    return _scan_windows(step, out, total, windows)


def _new_buffer(prompt, first, length: int):
    """(b, length) token buffer holding the prompt and the first token,
    and its per-row count of real entries."""
    b, t_p = prompt.shape
    out = torch.zeros((b, length), dtype=torch.long, device=prompt.device)
    out[:, :t_p] = prompt
    out[:, t_p] = first
    return out, torch.full((b,), t_p + 1, dtype=torch.long,
                           device=prompt.device)


def _host_loop(step, out, total, t_p: int, num_new: int, return_stats):
    """The solo generators' loop: one verify step an iteration until
    the slowest row holds t_p + num_new tokens (one readback of
    min(total) an iteration, as the reference's)."""
    steps = 0
    for _ in range(num_new - 1):
        out, total = step(out, total)
        steps += 1
        if int(total.min()) >= t_p + num_new:
            break
    result = out[:, :t_p + num_new]
    return (result, {"steps": steps}) if return_stats else result


@torch.no_grad()
def speculative_generate(params: Params, cfg: ModelConfig, prompt,
                         num_new: int, draft_k: int = 4,
                         return_stats: bool = False, device="cuda"):
    """prompt (b, t_p) integer -> (b, t_p + num_new), greedy-exact, on
    ``device`` (the card unless the caller asks for the CPU). Every
    iteration emits between 1 and draft_k+1 tokens per row; with
    ``return_stats`` also returns {"steps": verify steps}."""
    dev = resolve(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, t_p = prompt.shape
    if num_new <= 0:
        return (prompt, {"steps": 0}) if return_stats else prompt
    # room for the final window write: total + k + 1
    length = t_p + num_new + draft_k + 1
    logits, cache = prefill(params, cfg, prompt, length)
    out, total = _new_buffer(prompt, torch.argmax(logits, dim=-1), length)

    def step(out, total):
        out, total, _ = _verify_step(params, cache, out, total, cfg=cfg,
                                     k=draft_k)
        return out, total

    return _host_loop(step, out, total, t_p, num_new, return_stats)


def _draft_propose(draft_params, draft_cache, out, total, *,
                   dcfg: ModelConfig, k: int):
    """Autoregressive k-token proposal from a draft model: k+1 greedy
    single-token steps over its own KV cache (written in place). Step
    i consumes token t_i (t_0 the row's last emitted token) at per-row
    position base+i, writes its k/v and proposes t_{i+1}; step k
    consumes the final proposal only for its k/v write, so a fully
    accepted window leaves no hole in the draft cache. Rows past
    base+m are stale afterwards and overwritten by the next round,
    which starts at base+m+1. Returns the draft (b, k)."""
    dtype = torch_dtype(dcfg.dtype)
    base0 = total - 1
    tok = _at(out, base0)
    drafts = []
    for i in range(k + 1):
        x = embed_lookup(draft_params["embed"], tok[:, None], dtype)
        for bparams, lc in zip(draft_params["blocks"], draft_cache):
            x, kk, vv = _window_block(x, bparams, dcfg, lc, base0 + i)
            _write_window(lc["k"], kk, base0 + i)
            _write_window(lc["v"], vv, base0 + i)
        h = _rms_norm(x[:, 0, :], draft_params["final_norm"])
        tok = torch.argmax(_readout(h, draft_params["embed"],
                                    dcfg.int8_native), dim=-1)
        drafts.append(tok)
    return torch.stack(drafts[:k], dim=1)


def _draft_verify_step(params, draft_params, cache, draft_cache, out, total,
                       *, cfg: ModelConfig, dcfg: ModelConfig, k: int):
    """One draft-model speculative step: ``_verify_step`` with the
    n-gram proposer swapped for the draft model. Returns (out, total,
    m)."""
    draft = _draft_propose(draft_params, draft_cache, out, total, dcfg=dcfg,
                           k=k)
    _, base, logits, rows = _window_forward(params, cache, out, total,
                                            cfg=cfg, k=k, draft=draft)
    _write_rows(cache, rows, base)
    active = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
    out, total, _, m, _ = _accept_and_emit(logits, draft, out, total, active,
                                           None, k=k)
    return out, total, m


@torch.no_grad()
def draft_model_generate(params: Params, cfg: ModelConfig,
                         draft_params: Params, dcfg: ModelConfig, prompt,
                         num_new: int, draft_k: int = 4,
                         return_stats: bool = False, device="cuda"):
    """Draft-model speculative decoding: prompt (b, t_p) integer ->
    (b, t_p + num_new), greedy-exact against the target's own greedy
    stream however bad the draft model is. ``dcfg`` must share the
    target's vocab; depth, width and dtype are free."""
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {dcfg.vocab_size} != target vocab "
            f"{cfg.vocab_size}")
    dev = resolve(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, t_p = prompt.shape
    if num_new <= 0:
        return (prompt, {"steps": 0}) if return_stats else prompt
    length = t_p + num_new + draft_k + 1
    logits, cache = prefill(params, cfg, prompt, length)
    # the draft's own prompt k/v; its first proposal step consumes the
    # first emitted token at base t_p
    _, draft_cache = prefill(draft_params, dcfg, prompt, length)
    out, total = _new_buffer(prompt, torch.argmax(logits, dim=-1), length)

    def step(out, total):
        out, total, _ = _draft_verify_step(
            params, draft_params, cache, draft_cache, out, total, cfg=cfg,
            dcfg=dcfg, k=draft_k)
        return out, total

    return _host_loop(step, out, total, t_p, num_new, return_stats)


def speculative_report(cfg: ModelConfig = None, batch: int = 2,
                       prompt_len: int = 12, num_new: int = 12,
                       device="cuda") -> Dict[str, object]:
    """Smoke and greedy-equivalence check: random weights and a prompt
    from seeded ``torch.Generator``s, ``speculative_generate`` against
    ``decode.greedy_generate``."""
    from kind_tpu_sim_torch.models import decode, transformer as tf

    dev = resolve(device)
    cfg = cfg or tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_seq=64)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    prompt = tf.sample_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                             batch, prompt_len, device=dev)
    spec = speculative_generate(params, cfg, prompt, num_new, device=dev)
    ref = decode.greedy_generate(params, cfg, prompt, num_new, device=dev)
    ok = bool(torch.equal(spec, ref))
    return {"greedy_exact": ok, "ok": ok, "generated": int(num_new)}
