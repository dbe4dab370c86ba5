"""Global numeric configuration of the PyTorch port.

Counterpart of ``cedarsim_tpu/config.py``, its dtypes and Verilog-A
lowering modes: circuit state, model evaluation and the exact solves are
float64 (conductances span ~15 decades), the AC and noise solves
complex128.  The port never calls
``torch.set_default_dtype``; every tensor it makes names its dtype.  The
JAX package's XLA-cache settings have no counterpart here (PyTorch runs
eagerly).
"""

import torch

#: dtype of simulator state, model evaluation and exact solves
real_dtype = torch.float64
#: dtype of the AC and noise solves (G + jωC)·v = b
complex_dtype = torch.complex128

#: how Verilog-A ``absdelay`` lowers by default: "pade" (Padé(3,3) all-pass
#: companion states, every analysis) or "history" (exact interpolation in
#: the integrator's ring of accepted samples).  Per model:
#: ``va.codegen.make_device(module, delay_mode=...)``.
va_delay_mode = "pade"

#: how Verilog-A ``transition()`` lowers by default: "smooth" (exponential
#: edge shaping through one companion state, every analysis) or "latch"
#: (the LRM's linear ramps, latched at accepted steps).  Per model:
#: ``va.codegen.make_device(module, transition_mode=...)``.
va_transition_mode = "smooth"


def resolve_device(device=None):
    """The device a circuit lives on: ``device`` if given, else the current
    CUDA card.  With no card and no device given it raises: the port runs
    on the card unless the caller asks for the CPU.  ``"cuda"`` becomes the
    indexed current card, so that it compares equal to a tensor's device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device=\"cpu\" to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

#: Boltzmann constant (J/K)
K_BOLTZMANN = 1.380649e-23
#: elementary charge (C)
Q_CHARGE = 1.602176634e-19
#: 0 Celsius in Kelvin
T_ZERO_C = 273.15
