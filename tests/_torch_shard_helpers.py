"""Picklable helpers that the sharded-runtime tests ship to spawned shard
workers (a test module would carry the reference's imports into every
worker)."""
import torch


class FailOn:
    """A neighbour function that fails as a kernel that cannot launch does
    (a ``RuntimeError`` from the chunk pass) when it is asked to expand
    any of ``ranks``, and is ``inner`` otherwise."""

    def __init__(self, inner, ranks):
        self.inner = inner
        self.ranks = torch.as_tensor(ranks, dtype=torch.int64)

    def __call__(self, states: torch.Tensor) -> torch.Tensor:
        if torch.isin(states, self.ranks.to(states.device)).any():
            raise RuntimeError("mark_rotate_count: CUDA error 719: "
                               "unspecified launch failure")
        return self.inner(states)
