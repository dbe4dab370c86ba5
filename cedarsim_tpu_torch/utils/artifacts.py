"""DC operating-point cache (counterpart of the op cache of
``cedarsim_tpu/utils/artifacts.py``): operating points stored under a
content hash of the elaborated circuit, the param values (torch tensors
read as numpy), the simulation context and the mode, and replayed as warm
starts.  A warm start is a hint, never an answer: the Newton solve still
verifies convergence, so a stale or corrupt entry costs iterations, not
correctness.

One deliberate difference from the JAX package: the cache is off unless
asked for.  ``solve_dc`` consults it only with ``artifact_cache=True`` or
when the environment variable ``CEDARSIM_TPU_TORCH_ARTIFACTS`` names a
directory (``True`` without it uses ``~/.cache/cedarsim_tpu_torch/
artifacts``).  A warm start moves an operating point's last bits, and a
latch's state can follow them (the BSIM-CMG DFF's does, ROADMAP C9): a
cache on by default would make a run's counts depend on what ran before
it under the same home directory.  The JAX package's plan-core cache is
not ported: the port's fused plan builds in under a second.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

ENV = "CEDARSIM_TPU_TORCH_ARTIFACTS"


def cache_dir(enabled=None):
    """The cache's directory, made if missing, or None when the cache is
    off: ``enabled`` True or False decides, None leaves it to ``ENV`` (a
    directory turns it on; unset, empty or "0" leaves it off)."""
    d = os.environ.get(ENV, "")
    if enabled is None:
        enabled = bool(d) and d != "0"
    if not enabled:
        return None
    if not d or d == "0":
        d = os.path.join(os.path.expanduser("~"), ".cache",
                         "cedarsim_tpu_torch", "artifacts")
    os.makedirs(d, exist_ok=True)
    return d


def _update_tree(h, tree):
    """Hash a nest of dicts, tuples and lists whose leaves are tensors,
    arrays or numbers, in key order; a leaf that carries a gradient or a
    forward tangent is refused (TypeError)."""
    if isinstance(tree, dict):
        h.update(b"{")
        for k in sorted(tree):
            h.update(repr(k).encode())
            _update_tree(h, tree[k])
        h.update(b"}")
        return
    if isinstance(tree, (tuple, list)):
        h.update(b"(")
        for v in tree:
            _update_tree(h, v)
        h.update(b")")
        return
    if isinstance(tree, torch.Tensor):
        from torch.autograd.forward_ad import unpack_dual
        if tree.requires_grad or unpack_dual(tree).tangent is not None:
            raise TypeError("a value with a derivative")
        tree = tree.detach().cpu().numpy()
    a = np.asarray(tree)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())


def op_key(compiled, params, ctx, mode) -> str | None:
    """Content hash of (elaborated structure, param values, context,
    mode); None for values that carry a derivative."""
    try:
        h = hashlib.sha256()
        h.update(f"op/torch/{compiled.dtype}/{mode}".encode())
        if compiled.mixed:
            # the eval dtype, as the JAX package's key carries it (a
            # float64 circuit's key is the one it always was)
            h.update(f"/eval/{compiled.eval_dtype}".encode())
        h.update("|".join(compiled.node_names).encode())
        for key in compiled.group_order:
            g = compiled.groups[key]
            h.update(key.encode())
            h.update(repr(sorted(g.static_params.items(),
                                 key=lambda kv: kv[0])).encode())
            h.update(np.ascontiguousarray(g.row_idx).tobytes())
            h.update(np.ascontiguousarray(g.var_idx).tobytes())
        _update_tree(h, params)
        _update_tree(h, (ctx.gmin, ctx.temp, ctx.sourcefac))
        return h.hexdigest()
    except TypeError:
        return None


def load_op(key, enabled=None):
    """The operating point stored under ``key`` (numpy), or None."""
    d = cache_dir(enabled)
    if d is None or key is None:
        return None
    path = os.path.join(d, f"{key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return z["x"]
    except Exception:
        return None


def store_op(key, x, enabled=None):
    """Store ``x`` under ``key`` (not when any entry is non-finite); the
    file is written beside its place and renamed into it."""
    d = cache_dir(enabled)
    if d is None or key is None:
        return
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if not np.all(np.isfinite(x)):
        return
    path = os.path.join(d, f"{key}.npz")
    # np.savez appends .npz to a name without it: keep the suffix on the
    # temporary file so that os.replace finds what was written
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, x=x)
    os.replace(tmp, path)
