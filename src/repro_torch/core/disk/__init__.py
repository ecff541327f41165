"""The port's own copy of the parts of the numpy disk tier
(``repro/core/disk``) that meet the device: the distance oracle's chunks,
their codec and the block owner map."""
