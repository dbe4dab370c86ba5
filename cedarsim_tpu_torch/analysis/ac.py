"""AC small-signal and noise analyses as batched complex solves
(counterpart of ``cedarsim_tpu/analysis/ac.py``).

At the DC operating point the MNA Jacobians G = ∂S/∂x and C = ∂Q/∂x give
(G + jωC)·v = b per frequency, b the sources' AC drive.  The frequency axis
is the batch axis of one ``torch.linalg.solve`` over [n_f, n_x, n_x]
complex128 on the compiled circuit's device: the JAX package solves the
same systems in complex128 with ``ops/linalg.py::solve`` (LAPACK on the
CPU, its pure-JAX LU on the TPU), outside any Pallas kernel.

Noise: each source's PSD ``pwr·f^(−exp)`` reaches the output through one
adjoint solve per frequency, (G + jωC)ᴴ·y = e_out with e_out = ∂out/∂x,
H = yᴴ·(∂S/∂eps); the same y gives the AC drive's gain to the output,
|yᴴ·b|², for the input-referred spectrum.

S-parameter blocks (touchstone files, ``frontend/touchstone.py``) add their
port admittance Y(f), interpolated linearly on their grid and clamped at
both ends.  The delay and latch stamps of the JAX package's ``_delay_ac``
serve devices the port does not elaborate yet: a circuit with ring or
latch sites raises, naming ROADMAP A14b part 3.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.analysis.dc import NewtonOptions, solve_dc
from cedarsim_tpu_torch.analysis.sweeps import as_compiled
from cedarsim_tpu_torch.core.compile import CompiledCircuit, default_ctx
from cedarsim_tpu_torch.core.context import Modes, SimSpec
from cedarsim_tpu_torch.ops import linalg

_A14B = "ROADMAP A14b part 3 (the delay ring and the latch channel)"


def _check_no_delay(compiled):
    """AC and noise have no delay or latch stamps yet (the JAX package's
    ``_delay_ac``/``_apply_delay_ac``)."""
    for key in compiled.group_order:
        m = compiled.groups[key].model
        if (getattr(m, "n_delay", 0) or getattr(m, "n_latch", 0)
                or getattr(m, "lat_sites", ())):
            raise NotImplementedError(
                f"AC/noise of a circuit with delay or latch sites "
                f"({key}) — {_A14B}")


def _freq_stamps(compiled):
    """Frequency-dependent admittance stamps: (a) the circuit's touchstone
    blocks as (node indices [p] with −1 for ground, f grid [m], Y [m, p,
    p]) on the circuit's device; (b) analytic stamps of model classes with
    ``ac_admittance(params) -> yfun``, ``yfun(f [n_f]) -> Y [n_f, p, p]``,
    as (node indices, yfun, multiplier)."""
    dev = compiled.device
    tables = []
    for _name, nets, fgrid, Y in compiled.circuit.sparam_blocks:
        idx = np.asarray([(-1 if n.is_ground else n.index) for n in nets],
                         np.int64)
        tables.append((idx,
                       torch.as_tensor(np.asarray(fgrid), dtype=compiled.dtype,
                                       device=dev),
                       torch.as_tensor(np.asarray(Y),
                                       dtype=config.complex_dtype,
                                       device=dev)))
    funs = []
    for key in compiled.group_order:
        g = compiled.groups[key]
        mk = getattr(g.model, "ac_admittance", None)
        if mk is None:
            continue
        nt = g.model.n_terms()
        for j, inst in enumerate(g.instances):
            funs.append((g.var_idx[j, :nt].astype(np.int64),
                         mk(inst.params), float(inst.mult)))
    return tables, funs


def _apply_freq_stamps(A, f_hz, stamps, n):
    """A [n_f, n, n] + Σ Y_k(f) stamped at the port nodes (ground rows and
    columns dropped through a pad slot).  Tables interpolate linearly on
    their grid, clamped at the ends (``searchsorted`` left-sided, as
    ``jnp.searchsorted``); analytic stamps evaluate their yfun at f."""
    tables, funs = stamps
    if not tables and not funs:
        return A
    nf = A.shape[0]
    Ap = torch.zeros((nf, n + 1, n + 1), dtype=A.dtype, device=A.device)
    Ap[:, :n, :n] = A
    for idx, fg, Yg in tables:
        i = torch.clamp(torch.searchsorted(fg, f_hz, right=False), 1,
                        fg.shape[0] - 1)
        w = torch.clamp((f_hz - fg[i - 1])
                        / torch.clamp(fg[i] - fg[i - 1], min=1e-300),
                        0.0, 1.0)[:, None, None]
        Yf = Yg[i - 1] * (1 - w) + Yg[i] * w
        ii = np.where(idx < 0, n, idx)
        for a in range(len(ii)):
            for b in range(len(ii)):
                Ap[:, ii[a], ii[b]] += Yf[:, a, b]
    for idx, yfun, mult in funs:
        # the device's var_idx maps a ground terminal to the pad slot n
        ii = np.minimum(idx, n)
        Y = mult * yfun(f_hz).to(Ap.dtype)
        for a in range(len(ii)):
            for b in range(len(ii)):
                Ap[:, ii[a], ii[b]] += Y[:, a, b]
    return Ap[:, :n, :n]


def acdec(n_per_decade, fstart, fstop):
    """Log frequency grid of ``.ac dec``."""
    ndec = np.log10(fstop / fstart)
    n = int(np.ceil(n_per_decade * ndec)) + 1
    return np.logspace(np.log10(fstart), np.log10(fstop), n)


def _system(compiled, x, ctx_ac, params, freqs):
    """(A [n_f, n_x, n_x] complex, f [n_f]) at the operating point ``x``:
    G + jωC with the frequency stamps."""
    _check_no_delay(compiled)
    G, C = compiled.jacobians(x, ctx_ac, params)
    cd = config.complex_dtype
    f = torch.as_tensor(freqs, dtype=compiled.dtype, device=compiled.device)
    w = 2.0 * np.pi * f
    A = G.to(cd)[None] + (1j * w.to(cd))[:, None, None] * C.to(cd)[None]
    A = _apply_freq_stamps(A, f, _freq_stamps(compiled), compiled.n_x)
    return A, f


def _obs_grads(compiled, name, x, ctx, params):
    """(∂obs/∂x, ∂obs/∂ẋ) [n_x] of an observable at (x, ẋ = 0): the
    observable is linear in ẋ there, so its small-signal value at ω is
    g_x·v + jω·g_ẋ·v (the JAX package's two jvps)."""
    fn = compiled.observe(name)
    xx = x.detach().clone().requires_grad_(True)
    xd = torch.zeros_like(xx, requires_grad=True)
    with torch.enable_grad():
        y = fn(xx, xd, ctx, params)
        if not y.requires_grad:
            return torch.zeros_like(x), torch.zeros_like(x)
        gx, gxd = torch.autograd.grad(y, (xx, xd), allow_unused=True)
    gx = torch.zeros_like(x) if gx is None else gx
    gxd = torch.zeros_like(x) if gxd is None else gxd
    return gx.detach(), gxd.detach()


@dataclasses.dataclass
class ACSolution:
    freqs: np.ndarray
    v: torch.Tensor           # [n_f, n_x] complex small-signal solution
    op_x: torch.Tensor
    compiled: CompiledCircuit
    ctx: SimSpec
    params: dict

    def __getitem__(self, name):
        """Complex small-signal value [n_f] (numpy) of an observable across
        the frequencies: by linearity δobs = (∂obs/∂x)·v + jω·(∂obs/∂ẋ)·v."""
        gx, gxd = _obs_grads(self.compiled, name, self.op_x, self.ctx,
                             self.params)
        w = 2.0 * np.pi * torch.as_tensor(self.freqs, dtype=gx.dtype,
                                          device=gx.device)
        vr, vi = self.v.real, self.v.imag
        d_re = vr @ gx - w * (vi @ gxd)
        d_im = vi @ gx + w * (vr @ gxd)
        return torch.complex(d_re, d_im).cpu().numpy()


def _bias(compiled, params, ctx, dc_opts, x_op):
    """The operating point ``x_op``, or the DC solve in ``Modes.DCOP``
    (SPICE's AC op)."""
    if x_op is not None:
        return torch.as_tensor(x_op, dtype=compiled.dtype,
                               device=compiled.device)
    return solve_dc(compiled, params, ctx, opts=dc_opts, mode=Modes.DCOP).x


def ac(compiled, freqs, params=None, ctx: SimSpec = None,
       dc_opts: NewtonOptions = None, device=None,
       x_op=None) -> ACSolution:
    """AC analysis over ``freqs`` (Hz) on the compiled circuit's device
    (``compiled`` may be a ``Circuit``, compiled here on ``device``, by
    default the CUDA card).  The bias point is the DC operating point
    (``Modes.DCOP``), or ``x_op`` where the caller has solved it; the
    linearisation evaluates in ``Modes.AC``."""
    compiled = as_compiled(compiled, device)
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    x = _bias(compiled, params, ctx, dc_opts, x_op)
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    c = ctx.with_mode(Modes.AC)
    A, _ = _system(compiled, x, c, params, freqs)
    b = compiled.ac_rhs(params)
    v = linalg.solve(A, b.expand(A.shape[0], compiled.n_x))
    return ACSolution(freqs=freqs, v=v, op_x=x, compiled=compiled, ctx=c,
                      params=params)


@dataclasses.dataclass
class NoiseSolution:
    freqs: np.ndarray
    psd: np.ndarray            # [n_f] output noise PSD (V²/Hz at the output)
    per_source: np.ndarray     # [n_f, n_eps]
    eps_names: list
    compiled: CompiledCircuit
    #: |H(f)|² of the AC drive (the circuit's ac= sources) to the output:
    #: the ngspice ``.noise V(out) VSRC`` input-referral gain
    gain2: np.ndarray = None

    def __getitem__(self, _name="out"):
        return self.psd

    def inoise(self):
        """Input-referred PSD [n_f]: output PSD / |H(f)|² of the AC drive
        (ngspice ``inoise_spectrum``)."""
        if self.gain2 is None or float(np.max(self.gain2)) <= 0.0:
            raise ValueError(
                "input-referred noise needs an AC drive: no source in the "
                "circuit has a nonzero ac= value, so |H(f)| = 0 and "
                "onoise/|H|^2 is undefined")
        return self.psd / np.maximum(self.gain2, 1e-300)

    def total(self, f1=None, f2=None, input_referred=False):
        """RMS noise integrated over [f1, f2] (defaults: the whole grid) by
        the trapezoid rule on the computed grid (ngspice ``onoise_total`` /
        ``inoise_total``)."""
        f = self.freqs
        s = self.inoise() if input_referred else self.psd
        lo = f[0] if f1 is None else f1
        hi = f[-1] if f2 is None else f2
        m = (f >= lo) & (f <= hi)
        tz = getattr(np, "trapezoid", None) or np.trapz
        return float(np.sqrt(tz(s[m], f[m])))

    def source(self, name):
        """PSD contribution [n_f] of one noise source, by its eps name
        (``"x1.m1#n0"``) or by instance name (its sources summed)."""
        if name in self.eps_names:
            return self.per_source[:, self.eps_names.index(name)]
        cols = [k for k, n in enumerate(self.eps_names)
                if n.rsplit("#", 1)[0] == name]
        if not cols:
            raise KeyError(f"no noise source {name!r}; have {self.eps_names}")
        return self.per_source[:, cols].sum(axis=1)

    def by_source(self):
        """{eps name: PSD [n_f]} for every contributor."""
        return {n: self.per_source[:, k]
                for k, n in enumerate(self.eps_names)}


def _eps_names(compiled):
    """The noise sources' names in the order of the noise inputs:
    ``"<instance>#n<k>"``."""
    out = []
    for key in compiled.group_order:
        g = compiled.groups[key]
        for inst in g.instances:
            for k in range(g.model.n_noise):
                out.append(f"{inst.name}#n{k}")
    return out


def noise(compiled, out: str, freqs, params=None, ctx: SimSpec = None,
          dc_opts: NewtonOptions = None, device=None,
          x_op=None) -> NoiseSolution:
    """Output-referred noise PSD at observable ``out`` over ``freqs``:
    PSD(f) = Σₖ |Hₖ(f)|²·pwrₖ·f^(−expₖ), on the compiled circuit's device
    (a ``Circuit`` is compiled here on ``device``; the bias point as in
    :func:`ac`)."""
    compiled = as_compiled(compiled, device)
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    if compiled.n_eps == 0:
        f = np.atleast_1d(np.asarray(freqs))
        # gain2 = ones: a noiseless circuit's input-referred noise is zero
        return NoiseSolution(f, np.zeros_like(f), np.zeros((len(f), 0)), [],
                             compiled, gain2=np.ones_like(f))
    x = _bias(compiled, params, ctx, dc_opts, x_op)
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    c = ctx.with_mode(Modes.AC)
    A, f = _system(compiled, x, c, params, freqs)
    cd = config.complex_dtype
    Jeps = compiled.eps_jacobian(x, c, params).to(cd)      # [n_x, n_eps]
    pwr, ex = compiled.noise_sources(x, c, params)
    e_out, _ = _obs_grads(compiled, out, x, c, params)
    b_ac = compiled.ac_rhs(params)
    nf = A.shape[0]
    y = linalg.solve(A.mH, e_out.to(cd).expand(nf, compiled.n_x))
    yc = y.conj()
    H = yc @ Jeps                                           # [n_f, n_eps]
    s = pwr[None] * torch.pow(f[:, None], -ex[None])
    per = (H.abs() ** 2) * s
    g2 = (yc @ b_ac).abs() ** 2
    per = per.cpu().numpy()
    return NoiseSolution(freqs=freqs, psd=per.sum(axis=1), per_source=per,
                         eps_names=_eps_names(compiled), compiled=compiled,
                         gain2=g2.cpu().numpy())
