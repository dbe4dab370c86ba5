"""``cedarsim_tpu_torch.utils.export`` and ``utils.inspect`` (copies of
the JAX package's modules) on the port's own results, against the JAX
package's on the same netlists (``tests/test_utils.py``): the CSV holds
the same rows (times and values within 1e-9 V of the JAX package's),
the HTML plot the same polyline count, and the parameter trees, their
flat and nested forms and the alias map are equal.
"""

import warnings

import numpy as np

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.utils import export as jexport
from cedarsim_tpu.utils import inspect as jinspect
from cedarsim_tpu_torch.utils import export as texport
from cedarsim_tpu_torch.utils import inspect as tinspect

RC = """* rc
V1 vin 0 PULSE(0 1 1m 1u 1u 10m 20m)
R1 vin vout 1k
C1 vout 0 1u
.tran 0.1m 5m
"""
TREE = """* tree
.subckt div a b rr=2k
R1 a b {rr}
R2 b 0 {rr}
.ends
V1 vin 0 1
X1 vin vmid div rr=5k
.op
"""
ALIAS = """* alias
V1 a 0 1
R1 a gnd! 1k
.op
"""


def _both(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return J.simulate(text), T.simulate(text, device="cpu")


def test_csv_and_html_export(tmp_path):
    rj, rt = _both(RC)
    st = rt["tran"]
    p = texport.write_csv(tmp_path / "t.csv", st)
    q = jexport.write_csv(tmp_path / "j.csv", rj["tran"])
    lines = open(p).read().splitlines()
    assert lines[0] == open(q).read().splitlines()[0]
    assert lines[0].startswith("time,") and len(lines) == len(st.ts) + 1
    got = np.loadtxt(p, delimiter=",", skiprows=1)
    want = np.loadtxt(q, delimiter=",", skiprows=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert set(texport.default_name_map(st)) == \
        set(jexport.default_name_map(rj["tran"]))
    h = open(texport.save_html(tmp_path / "t.html", st)).read()
    assert "<svg" in h and h.count("<polyline") == len(
        texport.default_name_map(st))


def test_param_tree_flatten_nest_and_aliases():
    (tj, tt), (aj, at) = _both(TREE), _both(ALIAS)
    tree = tinspect.param_tree(tt["circuit"])
    assert tree == jinspect.param_tree(tj["circuit"])
    assert tree["x1"]["r1"]["r"] == 5000.0
    flat = tinspect.flatten_param_list(tree)
    assert flat == jinspect.flatten_param_list(tree)
    assert flat["x1.r2.r"] == 5000.0
    assert tinspect.nest_param_list(flat) == tree
    am = tinspect.alias_map(at["circuit"])
    assert am == jinspect.alias_map(aj["circuit"]) and am.get("gnd!") == "0"
