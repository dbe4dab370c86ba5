"""Circuit graph IR — the builder that replaces the reference's trace-time
Net/branch!/Named runtime (reference/src/simulate_ir.jl:28-91).

A ``Circuit`` is plain data: a set of named nets and a list of device
instances (model class + prepared parameter dict + terminal nets + multiplier).
Hierarchy from subcircuit elaboration is flattened into dotted instance names
("x1.r1") and dotted net names ("x1.mid"), mirroring the reference's
Named/DScope debug-name tree used for ``sys.x1.r1.I`` access
(reference/src/simulate_ir.jl:79-91).

Copy of ``cedarsim_tpu/core/circuit.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from cedarsim_tpu_torch.devices.base import DeviceModel


@dataclasses.dataclass(frozen=True)
class Net:
    name: str
    index: int  # -1 = ground

    @property
    def is_ground(self):
        return self.index < 0


GROUND = Net("0", -1)


@dataclasses.dataclass
class Instance:
    name: str
    model: type  # DeviceModel subclass
    nets: tuple  # tuple[Net]
    params: dict
    mult: float = 1.0
    ctrl: Optional[str] = None  # controlling instance name (CCVS/CCCS)
    #: general control-variable refs filling the model's n_control slots:
    #: ("net", Net) for a node voltage, ("branch", instname) for a branch
    #: current (behavioral sources read arbitrary circuit quantities)
    extras: tuple = ()


class Circuit:
    def __init__(self, title: str = ""):
        self.title = title
        self._nets: dict[str, Net] = {"0": GROUND, "gnd!": GROUND}
        self._order: list[str] = []  # non-ground net names in creation order
        self.instances: list[Instance] = []
        self._names: set[str] = set()
        #: user initial conditions: net name -> voltage (SPICE .ic)
        self.ics: dict[str, float] = {}
        #: initial guesses only (SPICE .nodeset)
        self.nodesets: dict[str, float] = {}
        #: analysis directives collected by the frontend (.tran/.ac/.dc/.option)
        self.directives: list = []
        self.options: dict = {}
        #: S-parameter multiport blocks (frontend/touchstone.py): entries of
        #: (name, [Net per port; port k = (net, ground)], freqs [m] Hz,
        #:  Y [m, p, p] complex port admittances).  Applied as
        #: frequency-dependent stamps by the AC/noise analyses; open at DC.
        self.sparam_blocks: list = []

    @property
    def gnd(self) -> Net:
        return GROUND

    def net(self, name: Optional[str] = None) -> Net:
        """Get-or-create a named net (ground aliases: '0', 'gnd!')."""
        if name is None:
            name = f"__n{len(self._order)}"
        if name in self._nets:
            return self._nets[name]
        n = Net(name, len(self._order))
        self._nets[name] = n
        self._order.append(name)
        return n

    @property
    def net_names(self) -> list[str]:
        return list(self._order)

    @property
    def n_nodes(self) -> int:
        return len(self._order)

    def add(self, model: type, name: str, nets, params: Optional[dict] = None,
            m: float = 1.0, ctrl: Optional[str] = None,
            kw_extras=None) -> Instance:
        if not (isinstance(model, type) and issubclass(model, DeviceModel)):
            raise TypeError(f"model must be a DeviceModel subclass, got {model!r}")
        if len(nets) != model.n_terms():
            raise ValueError(
                f"{name}: {model.__name__} has {model.n_terms()} terminals "
                f"({model.terminals}), got {len(nets)} nets")
        if name in self._names:
            raise ValueError(f"duplicate instance name {name!r}")
        extras = tuple(kw_extras or ())
        if ctrl is not None and not extras:
            extras = (("branch", ctrl),)
        if model.n_control and len(extras) != model.n_control:
            raise ValueError(
                f"{name}: {model.__name__} needs {model.n_control} control "
                f"refs (got {len(extras)}); pass ctrl= or extras=")
        self._names.add(name)
        inst = Instance(name, model, tuple(nets), model.prepare(params or {}),
                        float(m), ctrl, extras)
        self.instances.append(inst)
        return inst

    def ic(self, net_name: str, v: float):
        """Set an initial node voltage (SPICE .ic semantics)."""
        self.ics[net_name] = float(v)
