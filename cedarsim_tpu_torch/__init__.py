"""cedarsim_tpu_torch — the PyTorch/CUDA port of cedarsim_tpu.

The JAX package ``cedarsim_tpu`` is the reference this package is held
against; the port imports ``torch`` and never ``jax``.  It covers the main
path of the gf180 DFF benchmark so far: SPICE netlist → elaborated circuit →
compiled batched residuals and Jacobians (through the Verilog-A BSIM4-class
model) → DC operating point → transient over an explicit lane axis, with
the mixed-precision chord solves on the hand-written CUDA GESP LU kernels
(``ops/gesp_lu.py``).  What is still to be ported is listed in ROADMAP.md.
"""

from cedarsim_tpu_torch.core.circuit import Circuit
from cedarsim_tpu_torch.core.context import SimSpec, Modes
from cedarsim_tpu_torch.core.compile import (CompiledCircuit,
                                             compile_circuit)
from cedarsim_tpu_torch.devices import (
    Resistor, Capacitor, VSource, VSourcePWL, VSourcePULSE,
)
from cedarsim_tpu_torch.frontend.parser import parse_spice
from cedarsim_tpu_torch.frontend.elaborate import elaborate, load_spice
from cedarsim_tpu_torch.analysis.dc import (NewtonOptions, solve_dc,
                                            dc_core, default_newton_options)
from cedarsim_tpu_torch.analysis.tran import (TranOptions, TranSolution,
                                              tran)

__all__ = [
    "Circuit", "SimSpec", "Modes", "CompiledCircuit", "compile_circuit",
    "Resistor", "Capacitor", "VSource", "VSourcePWL", "VSourcePULSE",
    "parse_spice", "elaborate", "load_spice", "NewtonOptions", "solve_dc",
    "dc_core", "default_newton_options", "TranOptions", "TranSolution",
    "tran",
]
