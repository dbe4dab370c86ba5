"""``cedarsim_tpu_torch.utils.explore``: the slider grid as one lane-
batched transient of the port, against the JAX package's ``explore`` on
``tests/test_explore.py``'s RC: the same HTML payload (slider grids, the
time grid, every lane's sampled series within 1e-9 V), the JAX test's
physics, and on the CPU the lanes take the kernels' plain versions under
``dense_lu="mixed"`` with the same series.
"""

import json
import re

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.utils.explore import explore as jexplore
from cedarsim_tpu_torch.utils.explore import explore as texplore

GRID = {"R1.r": [1000.0, 4000.0], "C1.c": [1e-9, 2e-9]}


def _rc(M, **kw):
    ckt = M.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(M.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=1.0, td=1e-7, tr=1e-9, tf=1e-9, pw=1e-5,
                 per=2e-5))
    ckt.add(M.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(M.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return M.compile_circuit(ckt, dynamic_params=["r"], **kw)


def _payload(path):
    text = path.read_text()
    assert 'input type="range"' in text
    return json.loads(re.search(r"const D = (\{.*?\});\n", text,
                                re.S).group(1))


@pytest.mark.parametrize("dense_lu", ["auto", "mixed"])
def test_explore_grid_matches_jax(tmp_path, dense_lu):
    tj, tt = tmp_path / "j.html", tmp_path / "t.html"
    jexplore(_rc(J), (0.0, 8e-6), GRID, ["vout"], path=str(tj),
             n_samples=200)
    texplore(_rc(T, device="cpu"), (0.0, 8e-6), GRID, ["vout"],
             path=str(tt), n_samples=200,
             opts=T.TranOptions(dense_lu=dense_lu))
    pj, pt = _payload(tj), _payload(tt)
    assert (pt["names"], pt["grids"], pt["t"]) == \
        (pj["names"], pj["grids"], pj["t"])
    v = np.asarray(pt["series"]["vout"])             # [4 lanes, 200]
    assert v.shape == (4, 200)
    np.testing.assert_allclose(v, np.asarray(pj["series"]["vout"]),
                               rtol=0, atol=1e-9)
    t = np.asarray(pt["t"])
    # lane 0: R 1k, C 1n (tau 1 us); lane 2: R 4k, C 1n (tau 4 us)
    i2us, i11 = int(np.searchsorted(t, 2e-6)), int(np.searchsorted(t, 1.1e-6))
    assert v[0, -1] > 0.95 and v[2, -1] > 0.8
    assert v[0, i2us] > v[2, i2us] + 0.2
    assert abs(v[0, i11] - (1 - np.exp(-1.0))) < 0.05
