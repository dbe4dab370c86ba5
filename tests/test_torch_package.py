"""The port as a package: the card is its default device, and it reads its
own model files, never the JAX package's.

- ``compile_circuit`` and ``params_from_numpy`` without a device raise
  where no CUDA card is present (the message names ``device="cpu"``); with
  ``device="cpu"`` they run on the CPU; ``device="cuda"`` becomes the
  indexed current card.
- ``cedarsim_tpu_torch.models.MODELS_DIR`` and every entry of
  ``MODEL_SEARCH_PATHS`` lie inside ``cedarsim_tpu_torch/``, and its
  ``bsim4.va`` is byte for byte the JAX package's (a fix goes into both).
"""

import os

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch import config, models
from cedarsim_tpu_torch.utils.convert import params_from_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "cedarsim_tpu_torch")


def _rc():
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=1.0))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return ckt


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["compile_circuit", "CompiledCircuit",
                                   "params_from_numpy"])
def test_no_device_and_no_card_raises(no_card, entry):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "params_from_numpy":
            params_from_numpy({"g": {"r": np.ones(2)}})
        else:
            getattr(T, entry)(_rc())


def test_cpu_when_asked():
    comp = T.compile_circuit(_rc(), device="cpu")
    assert comp.device == torch.device("cpu")
    op = T.solve_dc(comp)
    assert bool(op.converged) and op.x.device == torch.device("cpu")
    # the capacitor is open at DC: vout follows vin
    assert abs(float(op["vout"]) - 1.0) < 1e-6
    p = params_from_numpy({"g": {"r": np.ones(2)}}, device="cpu")
    assert p["g"]["r"].device == torch.device("cpu")
    assert p["g"]["r"].dtype == torch.float64


def test_cuda_resolves_to_the_indexed_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert config.resolve_device(None) == torch.device("cuda", 0)
    assert config.resolve_device("cuda") == torch.device("cuda", 0)
    assert config.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_model_paths_are_the_ports_own():
    def inside(path):
        return os.path.commonpath([os.path.realpath(path),
                                   os.path.realpath(PKG)]) == \
            os.path.realpath(PKG)
    assert inside(models.MODELS_DIR)
    assert models.MODEL_SEARCH_PATHS
    assert all(inside(p) for p in models.MODEL_SEARCH_PATHS)
    assert os.path.isfile(os.path.join(models.MODELS_DIR, "bsim4.va"))


def test_bsim4_copy_equals_the_jax_packages():
    with open(os.path.join(PKG, "models", "bsim4.va"), "rb") as f:
        mine = f.read()
    with open(os.path.join(REPO, "cedarsim_tpu", "models", "bsim4.va"),
              "rb") as f:
        ref = f.read()
    assert mine == ref
