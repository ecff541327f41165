"""The port's own copy of the numpy disk tier (``repro/core/disk``): the
distance oracle's chunks and the block owner map, and the root of the rest
of Tier D — the chunked row store (``store.ChunkStore``), its codecs
(``codec``: the sorted-key, rle2 and wire formats) and the fault-injection
and I/O-retry layer (``faults``).  ``data.pipeline.DiskTokenStream``
streams a training corpus from a ``ChunkStore``."""
