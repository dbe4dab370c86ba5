"""The noise inputs (eps) leave every analysis but noise exactly as it was.

- The CUDA source that ``va/emit.py`` records from the model walk, for the
  fused plans of the BSIM4 DFF (W per lane), the level-1 DFF (``Mos1``,
  vto per lane) and the PVT sweep (W and the supply per lane), hashes to
  the SHA-256 it had before eps entered the walk (the constants below, of
  the sources emitted by the tree without the noise channel).  Emitted on
  the CPU, no nvcc.
- ``CompiledCircuit.res_jacs_fwd`` (``evaluate`` without eps) gives the
  (S, Q, G, C) bytes it gave before, on the 2-lane DFF state of
  ``tests/test_torch_c2.py`` (the W·0.99 lane's warm DC at t = 1 fs).
- On that state ``residuals(eps=0)`` equals ``residuals()``: a noise
  input of 0 adds 0.

The BSIM4 sources and bytes were taken before ROADMAP C17 and C18
changed two rules of the walk: ``abs``'s derivative at 0 (sign(0) = 0
then, the JAX package's +1 now) and a number over a float64 tensor (two
roundings then, one now).  Each test rebuilds the plan and the state
under the former rules (``_former_rules``) and holds them to ``BEFORE``,
and under the rules of the tree to ``AFTER``: the two rules are the
only change since, and the current bytes are pinned too.  The level-1
plan meets neither rule.
"""

import hashlib

import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis.tran import fused_plan_for
from cedarsim_tpu_torch.benchmarks import kernel_times as kt
from cedarsim_tpu_torch.benchmarks import pvt_sweep
from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.va import codegen

#: SHA-256 of each plan's emitted header, and of the DFF state's (S, Q, G,
#: C) bytes, before the noise channel entered the walk
BEFORE = {
    "dff": "5558c39dbc180acd07f9556d4de4f50c6a705d2a7600611478b260e4a0038ee9",
    "eval": "b9368996f909e9186a2ac2bfb203c1f54356d22bb7e6a923dfcb1828f8d63bcc",
    "lv1": "f76185197c8c2aba2d045ced78825da5f594d2854ccaa5c70589970bfcf379bc",
    "pvt": "229ac0302dfc905a4561cb78023c583eee6e43270b1c9821739288c0bdffd07f",
}
#: the same under ROADMAP C17's and C18's rules (the BSIM4 plans' headers
#: differ from BEFORE's at the one ``abs`` site, a select for cs_sign)
AFTER = {
    "dff": "e41534d5d5858e42f88c8ec34223bbe45abf6f53ccb9751260b33e5f92bb2aea",
    "eval": "5131b50da002cf635a4560565a5d5014533b48a0ea8bb77ec24d73896a225f39",
    "pvt": "198f7c97b8441011e14e468b086db1dcefe193259b34cb8073d83b186fc00b38",
}


def _sha(text):
    return hashlib.sha256(text.encode()).hexdigest()


def _sign_rule(x):
    """``abs`` with sign(0) = 0 at the kink, the rule before C17."""
    v = D.val(x)
    return D._chain(torch.abs(v), x, torch.sign(v))


@pytest.fixture
def former_rules(monkeypatch):
    """The walk's rules before C17 and C18, inside one test."""
    def apply():
        monkeypatch.setitem(codegen._MATH1, "abs", _sign_rule)
        monkeypatch.setattr(D, "rdiv", lambda b, v: b / v)
    return apply


def _dff_hashes():
    comp, ctx, pb, x0 = kt.dff_lanes(torch, T, "cpu", lanes=2)
    c = T.SimSpec.make(gmin=1e-15).with_mode("tran").at_time(1e-15)
    p0 = {k: {pn: v[0] for pn, v in g.items()} for k, g in pb.items()}
    h = hashlib.sha256()
    for a in comp.res_jacs_fwd(x0[0], c, p0):
        h.update(a.contiguous().numpy().tobytes())
    return (_sha(fused_plan_for(comp, ctx, pb).header()), h.hexdigest(),
            comp, x0, c, p0)


def test_dff_plan_and_eval_unchanged(former_rules):
    header, ev, comp, x0, c, p0 = _dff_hashes()
    assert (header, ev) == (AFTER["dff"], AFTER["eval"])
    # a zero noise input adds zero: the residual of the noise walk at eps=0
    s0, q0 = comp.residuals(x0[0], c, p0)
    s1, q1 = comp.residuals(x0[0], c, p0, eps=torch.zeros(comp.n_eps,
                                                          dtype=s0.dtype))
    assert comp.n_eps == 60
    assert torch.equal(s0, s1) and torch.equal(q0, q1)
    former_rules()
    assert _dff_hashes()[:2] == (BEFORE["dff"], BEFORE["eval"])


def test_level1_plan_unchanged():
    comp, ctx, pb, _ = kt.lv1_lanes(torch, T, "cpu", lanes=2)
    assert comp.n_eps == 0
    assert _sha(fused_plan_for(comp, ctx, pb).header()) == BEFORE["lv1"]


def _pvt_header():
    pvt = pvt_sweep.PVT("cpu")
    vdds, wscs = pvt_sweep.grid(4)
    pb = pvt.chunk_params(vdds, wscs)
    return _sha(fused_plan_for(pvt.comp, pvt.ctx, pb).header())


def test_pvt_plan_unchanged(former_rules):
    assert _pvt_header() == AFTER["pvt"]
    former_rules()
    assert _pvt_header() == BEFORE["pvt"]
