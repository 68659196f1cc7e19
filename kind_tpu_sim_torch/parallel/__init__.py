"""The parallel layer over ``torch.distributed``.

Counterpart of ``kind_tpu_sim/parallel/`` (``mesh``, ``collectives``,
``ring_attention``, ``pipeline``, ``multihost``) plus what the reference
gets from GSPMD: one process per rank, each holding its own shard of
every tensor as a plain tensor, the collectives written out on the
mesh's groups (``tp``), and ``launch``, which starts a world of ranks on
one host (the counterpart of the reference's virtual devices).
"""
