"""The port's operating-point cache (``utils/artifacts.py``) against the
JAX package's (``tests/test_artifacts.py``), through the port's own
switch: it stays off unless ``CEDARSIM_TPU_TORCH_ARTIFACTS`` names a
directory (or ``artifact_cache=True`` is passed), unlike the JAX
package's.  Off: two solves give the same bits and iteration count, and
nothing is written.  On, in ``tmp_path``: the stored point is the first
solve's, the second solve starts from it (fewer Newton iterations) and
lands within 1e-9 V; the key follows the params, the structure and the
context.
"""

import os

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.utils import artifacts


def _ckt(r=1000.0):
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=2.0))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=r))
    ckt.add(T.Diode, "D1", (vout, ckt.gnd), {"is": 1e-14, "n": 1.0})
    return T.compile_circuit(ckt, device="cpu")


CTX = T.SimSpec.make(gmin=1e-12)


@pytest.mark.parametrize("env", [None, "", "0"])
def test_cache_is_off_by_default(tmp_path, monkeypatch, env):
    if env is None:
        monkeypatch.delenv(artifacts.ENV, raising=False)
    else:
        monkeypatch.setenv(artifacts.ENV, env)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert artifacts.cache_dir() is None
    c = _ckt()
    r1, r2 = T.solve_dc(c, ctx=CTX), T.solve_dc(c, ctx=CTX)
    assert bool(r1.converged) and torch.equal(r1.x, r2.x)
    assert int(r1.iters) == int(r2.iters)
    assert not os.listdir(tmp_path)


def test_op_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv(artifacts.ENV, str(tmp_path))
    c = _ckt()
    r1 = T.solve_dc(c, ctx=CTX)
    key = artifacts.op_key(c, c.params0, CTX.with_mode("dcop"), "dcop")
    stored = artifacts.load_op(key)
    assert stored is not None and np.array_equal(stored, r1.x.numpy())
    r2 = T.solve_dc(c, ctx=CTX)
    assert bool(r2.converged) and int(r2.iters) < int(r1.iters)
    assert float((r2.x - r1.x).abs().max()) < 1e-9
    # an explicit artifact_cache=False neither reads nor writes
    r3 = T.solve_dc(c, ctx=CTX, artifact_cache=False)
    assert int(r3.iters) == int(r1.iters)


def test_op_cache_explicit_switch(tmp_path, monkeypatch):
    monkeypatch.delenv(artifacts.ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    c = _ckt()
    r1 = T.solve_dc(c, ctx=CTX, artifact_cache=True)
    r2 = T.solve_dc(c, ctx=CTX, artifact_cache=True)
    assert int(r2.iters) < int(r1.iters)
    assert os.listdir(os.path.join(tmp_path, ".cache", "cedarsim_tpu_torch",
                                   "artifacts"))


def test_op_cache_key_tracks_params_structure_and_context():
    ctx = CTX.with_mode("dcop")
    a, b = _ckt(r=1000.0), _ckt(r=2000.0)
    ka = artifacts.op_key(a, a.params0, ctx, "dcop")
    assert ka == artifacts.op_key(_ckt(), _ckt().params0, ctx, "dcop")
    assert ka != artifacts.op_key(b, b.params0, ctx, "dcop")
    ctx2 = T.SimSpec.make(gmin=1e-9).with_mode("dcop")
    assert artifacts.op_key(a, a.params0, ctx2, "dcop") != ka
    assert artifacts.op_key(a, a.params0, ctx, "tranop") != ka
    grad = {k: {p: v.clone().requires_grad_(True) for p, v in g.items()}
            for k, g in a.params0.items()}
    assert artifacts.op_key(a, grad, ctx, "dcop") is None
