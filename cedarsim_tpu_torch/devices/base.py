"""Batched device stamp protocol (counterpart of
``cedarsim_tpu/devices/base.py``).

Every device class defines one function ``eval(lv, p, ctx, eps)``.  The
compiler (``core/compile.py``) evaluates it ONCE for all instances of a
class and all lanes of a batched run: ``lv`` is a list of ``n_lvar`` local
unknowns, each a tensor of shape ``[B]`` (B = lanes × instances) or, when the
compiler wants Jacobians, a :class:`~cedarsim_tpu_torch.core.dual.Dual`
carrying tangents.  ``p`` maps parameter names to Python floats (uniform
over the group) or ``[B]`` tensors.  ``eval`` returns ``(static, dynamic)``
as two lists of ``n_lrow`` row contributions (float, tensor or Dual) such
that the global residual is ``F(x, t) = S(x, t) + d/dt Q(x)``.

Local unknown layout (length ``n_lvar``)::

    [ V(terminal_0..k), V(internal_0..m), I(branch_0..b), control_0..c ]

Local equation rows (length ``n_lrow``)::

    [ KCL(terminal_0..k), KCL(internal_0..m), branch-eq_0..b ]

Sign convention as in the JAX package: a KCL contribution is the current
flowing out of the net into the device; branch current flows p→n through
the device.

Noise and AC (the JAX protocol): a device declares ``n_noise`` independent
noise sources.  ``eps`` is None in every analysis but noise, and the evals
then take exactly the path they take without noise.  The noise analysis
passes a list of ``n_noise`` inputs (zeros with unit tangents, Duals), and
``eval`` adds ``eps[k]`` times a unit current into the rows the k-th source
drives, so the walk yields ∂S/∂eps.  ``noise`` returns the sources' PSD
``(power, exponent)`` at the operating point: a current PSD of ``power ·
f**(−exponent)`` A²/Hz.  ``ac_rhs`` returns a source's complex AC drive per
local row, or None for a device that drives nothing.
"""

from __future__ import annotations


class DeviceModel:
    """Base class for batched device models."""

    #: terminal names in port order
    terminals: tuple = ()
    #: number of internal nodes (allocated per instance by the compiler)
    n_internal: int = 0
    #: number of branch-current unknowns
    n_branch: int = 0
    #: number of extra gathered control unknowns
    n_control: int = 0
    #: number of noise sources (entries of ``eps``)
    n_noise: int = 0
    #: parameter defaults: dict name -> float
    params: dict = {}
    #: params that also get a ``name + "$given"`` flag
    given_params: tuple = ()

    @classmethod
    def n_terms(cls):
        return len(cls.terminals)

    @classmethod
    def n_lvar(cls):
        return (len(cls.terminals) + cls.n_internal + cls.n_branch
                + cls.n_control)

    @classmethod
    def n_lrow(cls):
        return len(cls.terminals) + cls.n_internal + cls.n_branch

    @classmethod
    def group_key(cls, inst_params):
        """Instances whose key matches are evaluated together."""
        return cls.__name__

    @staticmethod
    def eval(lv, p, ctx, eps):
        raise NotImplementedError

    @classmethod
    def noise(cls, lv, p, ctx):
        """Per-source noise PSD at the operating point ``lv``: two lists of
        ``n_noise`` entries (float or [B] tensor), the power and the
        exponent of ``power · f**(−exponent)`` A²/Hz."""
        z = [0.0] * cls.n_noise
        return z, list(z)

    @classmethod
    def ac_rhs(cls, p):
        """Complex AC drive per local row (``n_lrow`` entries, complex or
        complex tensor), or None: only the independent sources drive."""
        return None

    @classmethod
    def prepare(cls, raw: dict) -> dict:
        """Normalize a parameter dict (defaults filled, given-flags added)."""
        p = {}
        for name, default in cls.params.items():
            if name in cls.given_params:
                p[name + "$given"] = float(name in raw
                                           and raw[name] is not None)
            v = raw.get(name)
            p[name] = default if v is None else v
        unknown = set(raw) - set(cls.params)
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown parameter(s) {sorted(unknown)}")
        return p
