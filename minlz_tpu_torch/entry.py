"""One forward step of the encode compute path, for a quick check.

The counterpart of ``entry()`` in the JAX package's ``__graft_entry__.py``:
the same 64 KiB of seeded input through the full-block match finder and the
greedy parse.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.encode_kernel import find_matches_dyn
from .ops.greedy import greedy_parse


def entry(device="cuda"):
    """Returns (fn, args): ``fn(*args)`` runs match finding and the greedy
    parse on ``device`` and returns (take.sum(), tok_len.sum())."""
    n = 64 * 1024
    seg = 4096
    dev = resolve_device(device)

    def step(data_flat):
        dist, length = find_matches_dyn(data_flat, [n], seg)
        nseg = n // seg
        take, _, tok_len, _ = greedy_parse(
            dist.to(torch.int32).reshape(nseg, seg),
            length.to(torch.int32).reshape(nseg, seg), seg)
        return take.sum(), tok_len.sum()

    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 64, (1, n)).astype(np.int32)).to(dev)
    return step, (data,)
