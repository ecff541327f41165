"""Roomy on PyTorch and CUDA: the Hopper port of the ``repro`` package.

Slice 1 carries the implicit 2-bit BFS (the paper's pancake computation)
end to end: ``core.ranking`` (permutation rank/unrank on int64),
``core.bitarray`` (packed 2-bit arrays, 16 fields per 32-bit word),
``core.constructs.implicit_bfs`` and ``apps.pancake_bits``.  The three
bit-pack kernels of that path are CUDA C++ for ``sm_90a``
(``kernels/csrc/bitpack.cu``), each with a plain PyTorch version beside it
(``kernels/ref.py``).

Rules the package keeps:

* it imports torch, numpy and the standard library only — never jax and
  never the ``repro`` package; what it needs from there it keeps a copy of;
* every entry point takes ``device=`` and defaults to ``"cuda"``; without a
  card that default raises (``device.resolve``), it never falls back to
  the CPU.  The CPU runs only when the caller passes ``device="cpu"``;
* packed words are ``torch.int32`` tensors holding the same bits as the
  JAX package's uint32 words; ranks are ``torch.int64``.
"""
