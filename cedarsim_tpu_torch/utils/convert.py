"""Conversions between the JAX package's data and the port's."""

from __future__ import annotations

import numpy as np
import torch

from cedarsim_tpu_torch.config import resolve_device


def params_from_numpy(tree, device=None, dtype=torch.float64):
    """A JAX ``CompiledCircuit.params0`` (or per-lane params) tree, given as
    ``{group_key: {param: numpy array}}``, as the port's params: the same
    keys, each leaf a tensor of ``dtype`` on ``device`` (by default the
    CUDA card; without one, pass ``device="cpu"``).  The port compiles the
    same group keys and dynamic leaves for the same netlist (the built-in
    groups' ``$given`` flags, as ``Mos1``'s ``kp$given``, and the
    behavioral sources' ``BSource[...]`` keys included), so the result feeds
    the port's solvers index by index."""
    device = resolve_device(device)
    return {key: {pn: torch.tensor(np.asarray(v, np.float64), dtype=dtype,
                                   device=device)
                  for pn, v in grp.items()}
            for key, grp in tree.items()}
