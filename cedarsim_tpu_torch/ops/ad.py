"""Which tensors carry automatic-differentiation state.

The port's analyses that differentiate (``analysis/sensitivity.py``,
``analysis/pss.py``) run the eager solvers with forward-mode tangents
(``torch.autograd.forward_ad``) or with leaves that require grad.  The
hand-written kernels (B1-B5, S1/S2) have no derivative rule: a tensor that
reaches one with a tangent would come back without it, so each wrapper
calls :func:`refuse_tangent` first, and the transient routes such inputs
to the exact ``torch.linalg`` solve (``analysis/tran.py::resolve_impl``).
:class:`ForwardTangents` makes forward mode through the eager model walk
cost about its arithmetic.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD
from torch.overrides import TorchFunctionMode


#: the ``torch.func`` level probe, bound once: the kernels' wrappers call
#: :func:`refuse_tangent` on every launch
_functorch_level = torch._C._functorch.maybe_current_level


def _ad_active():
    """(a forward-AD dual level is open, a ``torch.func`` transform is
    active): outside both no tensor can hold a tangent, so the kernels'
    wrappers, which check every launch, skip those tests."""
    return fwAD._current_level >= 0, _functorch_level() is not None


def _carries(t, fw, ft):
    """Whether ``t`` is a tensor that requires grad, holds a forward-mode
    tangent (``fw``: a dual level is open) or is wrapped by a
    ``torch.func`` transform (``ft``: one is active)."""
    return isinstance(t, torch.Tensor) and (
        t.requires_grad
        or (ft and torch._C._functorch.is_functorch_wrapped_tensor(t))
        or (fw and fwAD.unpack_dual(t).tangent is not None))


def any_tangent(*objs) -> bool:
    """Whether any tensor nested in ``objs`` (dicts, lists and tuples: a
    params tree, a checkpoint) requires grad, holds a forward tangent or
    is wrapped by a ``torch.func`` transform."""
    state = _ad_active()

    def walk(o):
        if isinstance(o, dict):
            return any(walk(v) for v in o.values())
        if isinstance(o, (list, tuple)):
            return any(walk(v) for v in o)
        return _carries(o, *state)
    return any(walk(o) for o in objs)


def ad_state(*objs):
    """False when no tensor nested in ``objs`` carries AD state (see
    :func:`any_tangent`), "grad" when one requires grad (reverse mode),
    else "forward" (forward tangents or a ``torch.func`` transform)."""
    if not any_tangent(*objs):
        return False

    def grad(o):
        if isinstance(o, dict):
            return any(grad(v) for v in o.values())
        if isinstance(o, (list, tuple)):
            return any(grad(v) for v in o)
        return isinstance(o, torch.Tensor) and o.requires_grad
    return "grad" if any(grad(o) for o in objs) else "forward"


def refuse_tangent(what: str, *tensors):
    """Raise when any of ``tensors`` carries AD state: ``what`` has no
    derivative rule and would drop the tangent.  With no dual level open
    and no ``torch.func`` transform active (every launch on a main path)
    this is one ``requires_grad`` test a tensor."""
    if fwAD._current_level < 0 and _functorch_level() is None:
        for t in tensors:
            if t.requires_grad:
                break
        else:
            return
    else:
        fw, ft = _ad_active()
        for t in tensors:
            if _carries(t, fw, ft):
                break
        else:
            return
    raise ValueError(
        f"{what}: an input carries an autograd tangent, and this "
        "hand-written kernel has no derivative rule (its result would "
        "silently drop the tangent); differentiate through the exact "
        "float64 torch.linalg path instead (the transient takes it "
        "under dense_lu='auto', newton_impl='auto')")


#: out-of-place arithmetic whose forward-mode rule, given one operand
#: without a tangent, builds a ZeroTensor for it: PyTorch computes each op
#: on a ZeroTensor through a Python meta kernel (``torch._refs``), ~0.1-0.3
#: ms a call, which made a model walk under forward AD ~18× its plain time
#: (``ForwardTangents``).  Each rule here stays finite with a zero tangent
#: wherever the primals are finite (``pow`` with a tensor exponent would
#: not: its rule has log(base))
_MIXED_ARITH = frozenset({
    torch.Tensor.__mul__, torch.Tensor.__rmul__, torch.Tensor.__add__,
    torch.Tensor.__radd__, torch.Tensor.__sub__, torch.Tensor.__rsub__,
    torch.Tensor.__truediv__, torch.Tensor.__rtruediv__, torch.mul,
    torch.add, torch.sub, torch.div, torch.Tensor.mul, torch.Tensor.add,
    torch.Tensor.sub, torch.Tensor.div, torch.addcmul, torch.Tensor.addcmul,
    torch.maximum, torch.minimum, torch.where})


class ForwardTangents(TorchFunctionMode):
    """Forward-mode AD at the cost of its arithmetic: inside this mode an
    out-of-place arithmetic op (``_MIXED_ARITH``) that meets an operand
    with a forward tangent gives every other floating operand an explicit
    zero tangent (a Python number becomes a 0-d tensor of the tangent's
    dtype first), so PyTorch takes its dual-dual rule instead of building
    ZeroTensors.  The primal values are the same bits (the same op on the
    same values, the same type promotion) and so are the tangents, but
    where a primal is infinite: there a zero tangent times it is NaN where
    the ZeroTensor gave 0.  In-place ops and the rest pass through
    unchanged."""

    def __init__(self):
        super().__init__()
        # one zero scalar a (dtype, device): every explicit zero tangent is
        # a view of it (no operation writes to it: the duals made here are
        # operands of out-of-place ops only)
        self._zeros = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        level = fwAD._current_level
        if func in _MIXED_ARITH and level >= 0:
            # torch._unpack_dual and torch._make_dual are what
            # forward_ad's unpack_dual and make_dual call, without their
            # checks and export hooks (half and two thirds of their cost)
            has = [isinstance(a, torch.Tensor)
                   and torch._unpack_dual(a, level)[1] is not None
                   for a in args]
            if True in has:
                ref = args[has.index(True)]
                args = tuple(a if h else self._zero_dual(a, ref, level)
                             for a, h in zip(args, has))
        return func(*args, **kwargs)

    def _zero(self, dtype, device):
        z = self._zeros.get((dtype, device))
        if z is None:
            z = self._zeros[dtype, device] = torch.zeros((), dtype=dtype,
                                                         device=device)
        return z

    def _zero_dual(self, a, ref, level):
        """``a`` with a zero tangent at ``level``: a Python number as a 0-d
        tensor of ``ref``'s dtype, a floating tensor as itself; anything
        else unchanged."""
        if isinstance(a, (float, int)) and not isinstance(a, bool):
            return torch._make_dual(
                torch.full((), a, dtype=ref.dtype, device=ref.device),
                self._zero(ref.dtype, ref.device), level=level)
        if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
            return a
        try:
            return torch._make_dual(
                a, self._zero(a.dtype, a.device).expand(a.shape), level=level)
        except RuntimeError:
            # a primal whose elements share memory (an expanded view)
            return torch._make_dual(a.clone(), torch.zeros_like(a),
                                    level=level)
