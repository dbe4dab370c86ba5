"""The reference's binned BSIM4 library (``tests/data/binning/bins.cir``,
16 bins with L/W bounds and binning corrections) through the port's
elaborator and DC, against the JAX package's (``tests/test_binning_lib.
py``): at the reference's (l, w) the port selects bins .0 and .1, its
VTH0 and K1 equal the closed-form binning equation (VTH0 0.50637 and
0.56378 V) and the JAX package's values exactly; a length outside every
bin is the same ``ElabError``; the operating points on and off (100 kΩ
pull-up, vg 3.3 and 0 V) agree with the JAX package's within 1e-9 V.
"""

import os
import warnings

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.frontend.elaborate import ElabError as JElabError
from cedarsim_tpu_torch.frontend.elaborate import ElabError as TElabError

BINS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "binning", "bins.cir")
#: the cards' values (bins.cir: bin .0 at :7ff, bin .1 at :251ff); both
#: bins binunit=2, wint=1e-8, every other geometry term 0
BIN0 = dict(vth0=0.70837662, lvth0=-3.8715455e-8, wvth0=-1.430587e-8,
            pvth0=4.3636364e-16,
            k1=0.95938091, lk1=-9.9985454e-8, wk1=0.0, pk1=0.0)
BIN1 = dict(vth0=0.67781184, lvth0=-2.3433061e-8, wvth0=-1.2304653e-8,
            pvth0=-5.642449e-16,
            k1=0.74639857, lk1=6.5057143e-9, wk1=0.0, pk1=0.0)


def _code(l, w, vg):
    with open(BINS) as f:
        lib = "\n".join(f.read().splitlines()[1:])   # a stray first line
    return ("* real binned BSIM4 library DC\n" + lib + "\nvd vdd 0 3.3\n"
            + f"vg g 0 {vg}\nrd vdd d 100k\n"
            + f"m1 d g 0 0 nmos_3p3 l={l} w={w}\n.op\n.end\n")


def _m1(M, l, w, vg=0.0):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ckt = M.elaborate(M.parse_spice(_code(l, w, vg),
                                        file="bins_wrap.cir"))
    inst = next(i for i in ckt.instances if i.name == "m1")
    return {k: float(np.asarray(v)) for k, v in inst.params.items()}


def _eff(card, base, L, W):
    lb, wb = L, W - 2e-8           # lint = xl = 0; wint = 1e-8, xw = 0
    return (card[base] + card["l" + base] / lb + card["w" + base] / wb
            + card["p" + base] / (lb * wb))


@pytest.mark.parametrize("l, card, vth0", [(2.8e-7, BIN0, 0.50637),
                                           (5.0e-7, BIN1, 0.56378)])
def test_bin_selection_and_denormalization(l, card, vth0):
    p = _m1(T, l, 2.2e-7)
    assert p == _m1(J, l, 2.2e-7)
    assert abs(p["VTH0"] - _eff(card, "vth0", l, 2.2e-7)) < 1e-9
    assert abs(p["K1"] - _eff(card, "k1", l, 2.2e-7)) < 1e-9
    assert round(p["VTH0"], 5) == vth0
    assert abs(p["VTH0"] - card["vth0"]) > 0.1     # the correction counts


def test_bin_out_of_range_rejected():
    with pytest.raises(TElabError, match="no bin") as te:
        _m1(T, 1e-4, 2.2e-7)
    with pytest.raises(JElabError, match="no bin") as je:
        _m1(J, 1e-4, 2.2e-7)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("vg", [3.3, 0.0])
def test_binned_lib_dc_matches_jax(vg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rt = T.simulate(_code(2.8e-7, 2.2e-7, vg), device="cpu")
        rj = J.simulate(_code(2.8e-7, 2.2e-7, vg))
    assert bool(rt["op"].converged)
    np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                               rtol=0, atol=1e-9)
    vd = float(rt["op"].x[rt["compiled"].node_names.index("d")])
    # on: deep in the linear region (~0.19 V); off: ~281 nA of leakage
    assert (vd < 0.5) if vg else (vd > 3.2)
