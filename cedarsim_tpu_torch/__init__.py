"""cedarsim_tpu_torch — the PyTorch/CUDA port of cedarsim_tpu.

The JAX package ``cedarsim_tpu`` is the reference this package is held
against; the port imports ``torch`` and never ``jax``.  It covers the main
path of the gf180 DFF benchmark and the built-in device library so far:
SPICE netlist → elaborated circuit (R, C, L, K, V/I sources with every
waveform, E/F/G/H, S/W, D, MOS level 1, Gummel-Poon Q, J, Z, B, or
Verilog-A) → compiled batched residuals and Jacobians → DC operating point
→ transient over an explicit lane axis, AC and noise analyses as batched
complex solves over the frequencies (``ac``, ``noise``; S-parameter
blocks), batched DC sweeps over parameters and temperature and
Monte-Carlo DC (``dc_sweep``, ``mc_dc``, ``mc_statistics``);
``simulate`` runs a SPICE or Spectre netlist's own ``.op``/``.tran``/
``.dc``/``.ac``/``.noise``/``.meas``/``.four``, its ``alter`` segments,
``.save`` projections and ``statistics`` draws (``.data`` tables through
``data_sweep``); periodic steady state by shooting
(``pss``, its monodromy by forward-mode AD through the transient) and by
harmonic balance (``hb``, ``hb_autonomous``) with periodic AC, periodic
noise and oscillator phase noise around the orbit; parameter sensitivities
and ``.TF`` (``analysis/sensitivity.py``) and the DC-initialisation probe
(``analysis/fragility.py``).  ``utils/`` holds the CSV/HTML export, the
parameter-tree inspection, the slider-grid ``explore`` (one lane-batched
transient), ``profiling`` and the opt-in operating-point cache;
``tools/convert.py`` converts between SPICE, Spectre and Verilog-A;
``va/reload.py`` reloads a ``.va`` file that changed.  The transient runs
the mixed-precision chord solves on the hand-written CUDA GESP LU kernels
(``ops/gesp_lu.py``), or with every chord iteration of a step attempt in one
launch of the fused chord kernel (``ops/fused_chord.py``, the BSIM4 walk
emitted as CUDA device code by ``va/emit.py``).  What is still to be ported
is listed in ROADMAP.md.
"""

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core.circuit import Circuit, Net, GROUND
from cedarsim_tpu_torch.core.context import SimSpec, Modes
from cedarsim_tpu_torch.core.compile import (CompiledCircuit,
                                             compile_circuit, ensure_dynamic)
from cedarsim_tpu_torch.devices import (
    Resistor, Capacitor, Inductor, CoupledInductors,
    VSource, VSourcePWL, VSourcePULSE, VSourceSIN, VSourceEXP,
    ISource, ISourcePWL, ISourcePULSE, ISourceSIN, ISourceEXP,
    VCVS, VCCS, CCVS, CCCS, VSwitch, ISwitch, Diode,
    OpenCircuit, ShortCircuit, TLine, LTRALine, nonlinear_resistor,
    nonlinear_capacitor,
    Mos1, Bjt, Jfet, Mesfet,
)
from cedarsim_tpu_torch.frontend.parser import parse_spice
from cedarsim_tpu_torch.frontend.elaborate import elaborate, load_spice
from cedarsim_tpu_torch.analysis.dc import (NewtonOptions, solve_dc,
                                            dc_core, default_newton_options)
from cedarsim_tpu_torch.analysis.tran import (TranOptions, TranSolution,
                                              tran, save_checkpoint,
                                              load_checkpoint)
from cedarsim_tpu_torch.analysis.sweeps import (
    Sweep, ProductSweep, TandemSweep, SerialSweep, sweepify, dc_sweep,
    data_sweep)
from cedarsim_tpu_torch.analysis.montecarlo import mc_dc, mc_statistics
from cedarsim_tpu_torch.analysis.ac import (ac, acdec, noise, ACSolution,
                                            NoiseSolution)
from cedarsim_tpu_torch.analysis.pss import pss
from cedarsim_tpu_torch.analysis.hb import (hb, hb_autonomous, pac, pnoise,
                                            oscillator_phase_noise)
from cedarsim_tpu_torch.ops.fused_chord import (FusedEnvelopeError,
                                                get_fused_plan)
from cedarsim_tpu_torch.api import (simulate, find_tran_directive,
                                    find_ac_directive)

__all__ = [
    "config", "Circuit", "Net", "GROUND", "SimSpec", "Modes",
    "CompiledCircuit", "compile_circuit",
    "ensure_dynamic",
    "Resistor", "Capacitor", "Inductor", "CoupledInductors", "VSource",
    "VSourcePWL", "VSourcePULSE", "VSourceSIN", "VSourceEXP", "ISource",
    "ISourcePWL", "ISourcePULSE", "ISourceSIN", "ISourceEXP", "VCVS", "VCCS",
    "CCVS", "CCCS", "VSwitch", "ISwitch", "Diode", "OpenCircuit",
    "ShortCircuit", "TLine", "LTRALine", "nonlinear_resistor",
    "nonlinear_capacitor", "Mos1",
    "Bjt", "Jfet", "Mesfet",
    "parse_spice", "elaborate", "load_spice", "NewtonOptions", "solve_dc",
    "dc_core", "default_newton_options", "TranOptions", "TranSolution",
    "tran", "save_checkpoint", "load_checkpoint", "Sweep", "ProductSweep",
    "TandemSweep", "SerialSweep", "sweepify", "dc_sweep", "data_sweep",
    "mc_dc",
    "mc_statistics", "ac", "acdec", "noise", "ACSolution", "NoiseSolution",
    "pss", "hb", "hb_autonomous", "pac", "pnoise", "oscillator_phase_noise",
    "FusedEnvelopeError", "get_fused_plan", "simulate",
    "find_tran_directive", "find_ac_directive",
]
