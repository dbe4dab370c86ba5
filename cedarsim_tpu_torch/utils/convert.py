"""Conversions between the JAX package's data and the port's."""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype=torch.float64):
    """A JAX ``CompiledCircuit.params0`` (or per-lane params) tree, given as
    ``{group_key: {param: numpy array}}``, as the port's params: the same
    keys, each leaf a tensor of ``dtype`` on ``device``.  The port compiles
    the same group keys and dynamic leaves for the same netlist, so the
    result feeds the port's solvers index by index."""
    return {key: {pn: torch.tensor(np.asarray(v, np.float64), dtype=dtype,
                                   device=device)
                  for pn, v in grp.items()}
            for key, grp in tree.items()}
