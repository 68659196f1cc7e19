"""The flash backward's kernels at odd and ragged lengths, on one card.

    python3 tools/flash_bwd_lengths.py [--root DIR] [--check]

``DIR`` is a checkout of this repository (default: the one that holds
this script); the kernels are built and loaded from it. With
``--check``, dq and dk/dv (through the wrappers, q/k/v views of a fused
qkv tensor, 16 query heads over 4 KV heads of 128, bf16) are held to
the plain backward at lengths that are odd, ragged against the 64-row
tiles, or whole (``LENGTHS``), causal and not, each relative to the
plain result's largest magnitude (bar 1e-2, ``chip_smoke.py``'s). Then
dk/dv at the training shape (8, 1024) is timed by ``chip_smoke.time_ms``
(median of 30 after warm-up, L2 flushed) and printed as ``TREE <name>
dkv (8,1024) ms <t>``. Compare two trees in one call, in turns: base,
change, change, base. Run it on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# (batch, t): odd, one past and one short of a tile, whole tiles
LENGTHS = ((8, 1023), (8, 1024), (2, 2), (2, 63), (2, 65), (2, 1025),
           (1, 2047), (3, 1001), (2, 200))
TOL = 1e-2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as cs
    from kind_tpu_sim_torch.ops import _build
    from kind_tpu_sim_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"kind_tpu_sim_torch imported from {fa.__file__}")
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, t):
        x = torch.randn(b, t, 24 * 128, generator=gen,
                        device="cuda").bfloat16()
        return (x[..., :2048].unflatten(-1, (16, 128)),
                x[..., 2048:2560].unflatten(-1, (4, 128)),
                x[..., 2560:].unflatten(-1, (4, 128)))

    if args.check:
        for b, t in LENGTHS:
            q, k, v = qkv(b, t)
            for causal in (True, False):
                out, lse = fa.flash_attention(q, k, v, causal=causal,
                                              return_lse=True)
                g = torch.randn(q.shape, generator=gen,
                                device="cuda").bfloat16()
                dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, causal)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, g,
                                                    causal)
                ref = fa.flash_attention_bwd_ref(
                    q.float(), k.float(), v.float(), out.float(), lse,
                    g.float(), causal)
                rel = [float((a.float() - r).abs().max() / r.abs().max())
                       for a, r in zip((dq, dk, dv), ref)]
                print((b, t), causal, fa.backward_route(q, k, v, g), rel,
                      flush=True)
                if max(rel) > TOL:
                    raise SystemExit(f"({b}, {t}) causal={causal}: {rel}")
    q, k, v = qkv(8, 1024)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    ms = cs.time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, out, lse, g,
                                                       True))
    print(f"TREE {root.name} dkv (8,1024) ms {ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
