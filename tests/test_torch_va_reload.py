"""``cedarsim_tpu_torch.va.reload``: a ``.va`` file edited on disk is
compiled again through the port's VA pipeline and its new default takes
effect (``tests/test_va_reload.py``), with the same operating points as
the JAX package's ``VAWatch`` classes.
"""

import os
import time

import numpy as np

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.va.reload import VAWatch as JWatch
from cedarsim_tpu_torch.va.reload import VAWatch

_RES = """
`include "disciplines.vams"
module myres(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = {rval};
  analog I(p, n) <+ V(p, n) / r;
endmodule
"""


def _mid_voltage(M, cls, **kw):
    """2 V over [the VA resistor at its default r] + 1 kOhm: the mid."""
    ckt = M.Circuit()
    vin, mid = ckt.net("vin"), ckt.net("mid")
    ckt.add(M.VSource, "V1", (vin, ckt.gnd), dict(dc=2.0))
    ckt.add(cls, "R1", (vin, mid), {})
    ckt.add(M.Resistor, "R2", (mid, ckt.gnd), dict(r=1000.0))
    res = M.solve_dc(M.compile_circuit(ckt, **kw))
    assert bool(res.converged)
    return float(np.asarray(res.x)[ckt._nets["mid"].index])


def test_watch_reload(tmp_path):
    path = tmp_path / "myres.va"
    path.write_text(_RES.format(rval="1000.0"))
    w, wj = VAWatch(str(path)), JWatch(str(path))
    assert "myres" in w.classes and not w.reload()
    v = _mid_voltage(T, w.classes["myres"], device="cpu")
    assert abs(v - 1.0) < 1e-6                          # 1k/1k
    assert v == _mid_voltage(J, wj.classes["myres"])
    time.sleep(0.02)
    path.write_text(_RES.format(rval="3000.0"))
    os.utime(path)
    assert w.changed() and w.reload() and wj.reload()
    v = _mid_voltage(T, w.classes["myres"], device="cpu")
    assert abs(v - 0.5) < 1e-6                          # 3k/1k
    assert abs(v - _mid_voltage(J, wj.classes["myres"])) < 1e-12
    assert not w.reload()
