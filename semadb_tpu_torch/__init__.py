"""semadb_tpu_torch — the PyTorch/CUDA port of semadb_tpu.

A second package beside ``semadb_tpu`` (the JAX reference, which it is
tested against). It mirrors that package's layout and names: ``ops/``,
``vectorstore/``, ``index/``, ``shard/``, ``cluster/``, ``httpapi/``,
``utils/``, ``main.py``. Engines hold their state as tensors on an explicit
``torch.device`` passed down from the entry point; nothing picks a device by
itself.

Ported so far: the single-server v2 path over a flat index (plain or
binary-quantized) — HTTP v2 → cluster node → shard → flat index — with the
binary scan in a hand-written CUDA kernel (``csrc/hamming.cu``), and the row
gather with its microbenchmark (``csrc/gather.cu``, ``tools/gatherbench.py``).

The port imports neither ``jax`` nor anything of ``semadb_tpu``. The host
modules it needs keep their own copies, with only their imports changed:
``models/``, ``store/`` (its native engine ``csrc/kvstore.cpp`` is built into
``_build/``, never into the JAX package's ``native/build/``) and
``utils/{compare,grow}.py``. Data on disk keeps one format, so a shard
written by either package opens in the other.
"""

__version__ = "0.1.0"
