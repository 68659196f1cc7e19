"""PyTorch + CUDA port of kind_tpu_sim's model path, for NVIDIA Hopper.

The JAX package (``kind_tpu_sim``) is the reference; this package keeps
its module names (``models/transformer``, ``models/quant``,
``models/moe``, ``models/decode``, ``models/serving``, ``models/paged``,
``models/speculative``, ``models/checkpoint``, ``data``, ``cli``,
``ops/``) so each piece has an obvious counterpart, and its tensor layouts at every public function
(q ``(b, t, h, d)``, caches ``(b, s, kv, hd)``, pools ``(num_blocks,
block_size, kv, hd)``).

It imports torch, numpy and the standard library only — never jax and
nothing of ``kind_tpu_sim``. Entry points run on the CUDA device unless
the caller passes ``device="cpu"``; without a CUDA device they raise
instead of carrying on on the CPU. Every Pallas kernel of the JAX
package has a hand-written CUDA C++ counterpart for ``sm_90a`` under
``csrc/``, built by ``ops/_build.py``, and so has the reference's exact
int8 product, an XLA operation there (``csrc/int8_matmul.cu``). ``python -m kind_tpu_sim_torch
train-smoke`` is the command line's entry point.
"""
