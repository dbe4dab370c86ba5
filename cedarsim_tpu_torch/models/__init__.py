"""Compact models compiled through the port's Verilog-A interpreter
(counterpart of ``cedarsim_tpu/models/__init__.py``).

``bsim4.va``, ``vbic.va`` and the CMC BSIM-CMG 107 sources in
``bsimcmg107/`` (third party, with their own README) are byte-for-byte
copies of the JAX package's files (a test holds each pair equal, so a fix
goes into both).  The port reads no file of the JAX package.
"""

from __future__ import annotations

import os

#: the port's own model directory (``cedarsim_tpu_torch/models``)
MODELS_DIR = os.path.dirname(os.path.abspath(__file__))

#: the CMC BSIM-CMG 107 sources: netlists reach them with
#: ``.hdl "bsimcmg.va"``, which the elaborator's file resolution finds on
#: ``MODEL_SEARCH_PATHS``
BSIMCMG107_DIR = os.path.join(MODELS_DIR, "bsimcmg107")

#: implicit include-path tail searched by the elaborator for model files
MODEL_SEARCH_PATHS = (MODELS_DIR, BSIMCMG107_DIR)

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


def vbic_class():
    """Compile (once per process) and return the VBIC DeviceModel class:
    the target of BJT ``.model`` cards at level 4 or 9 and of Spectre
    ``vbic`` masters."""
    key = ("vbic", ())
    if key not in _CACHE:
        from cedarsim_tpu_torch.va.codegen import load_va
        path = os.path.join(MODELS_DIR, "vbic.va")
        with open(path) as f:
            _CACHE[key] = load_va(f.read(), path)["vbic"]
    return _CACHE[key]


def bsimcmg_class():
    """Compile (once per process) and return the CMC BSIM-CMG 107
    DeviceModel class: the target of ``.model ... level=17/72`` cards and
    of Spectre ``bsimcmg`` masters (the ASAP7 decks use this path)."""
    key = ("bsimcmg", ())
    if key not in _CACHE:
        from cedarsim_tpu_torch.va.codegen import load_va
        path = os.path.join(BSIMCMG107_DIR, "bsimcmg.va")
        with open(path) as f:
            _CACHE[key] = load_va(f.read(), path,
                                  include_paths=(BSIMCMG107_DIR,))["bsimcmg"]
    return _CACHE[key]
