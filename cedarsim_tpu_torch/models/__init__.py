"""Compact models compiled through the port's Verilog-A interpreter
(counterpart of ``cedarsim_tpu/models/__init__.py``).

``bsim4.va`` here is a byte-for-byte copy of ``cedarsim_tpu/models/
bsim4.va``, the JAX package's original BSIM4-class model (a test holds the
two equal, so a fix goes into both).  The port reads no file of the JAX
package.  Only the BSIM4-class model is ported so far; BSIM-CMG is ROADMAP
A12 and VBIC is part of A14: their sources come across with those slices.
"""

from __future__ import annotations

import os

#: the port's own model directory (``cedarsim_tpu_torch/models``)
MODELS_DIR = os.path.dirname(os.path.abspath(__file__))

#: implicit include-path tail searched by the elaborator for model files
MODEL_SEARCH_PATHS = (MODELS_DIR,)

_CACHE: dict = {}


def bsim4_class(rdsmod: int = 0):
    """Compile (once per process per variant) and return the BSIM4
    DeviceModel class.  ``rdsmod=1`` compiles the external-S/D-resistance
    variant (internal diffusion nodes, preprocessor define BSIM4_RDSMOD1)."""
    if rdsmod not in (0, 1):
        raise ValueError(f"bsim4: RDSMOD must be 0 or 1, got {rdsmod}")
    defines = ("BSIM4_RDSMOD1",) if rdsmod else ()
    key = ("bsim4", defines)
    if key not in _CACHE:
        from cedarsim_tpu_torch.va.codegen import load_va
        path = os.path.join(MODELS_DIR, "bsim4.va")
        with open(path) as f:
            _CACHE[key] = load_va(f.read(), path, defines=defines)["bsim4"]
    return _CACHE[key]
