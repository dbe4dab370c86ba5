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
both ends, and the transmission lines their exact two-port Y(f)
(``ac_admittance``).

Delay and latch sites (:func:`_delay_ac`, the JAX package's stamps): the
circuit is linearised with its aux slots held at the operating point's
values, and each ring slot adds (∂S/∂d + jω·∂Q/∂d)·e^{−jωtd}·∂u/∂x, the
exact delay; each zi_* site adds its sampled transfer H(e^{jωT}), whose
coefficients come from the Jacobians of its latch update.  The JAX
package's sparse path skips both stamps and linearises at aux = 0 without
a word (``cedarsim_tpu/analysis/ac.py:107-109``); here that case raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.analysis.dc import NewtonOptions, solve_dc
from cedarsim_tpu_torch.analysis.sweeps import as_compiled
from cedarsim_tpu_torch.core.compile import (CompiledCircuit, default_ctx,
                                             use_sparse_solver)
from cedarsim_tpu_torch.core.context import Modes, SimSpec
from cedarsim_tpu_torch.ops import linalg

def _zi_site_meta(compiled):
    """Each zi_* site of each instance: (y slot, nb, n_yh, first u_hist
    slot or None) in aux-vector indices, from the device's ``lat_sites``
    (kind, offset, n_slots) with the layout [y_held, t_next, u_hist(nb −
    1), y_hist(na − 2)] and its ``zi_meta`` (nb, na)."""
    meta = []
    for key in compiled.group_order:
        g = compiled.groups[key]
        nd = getattr(g.model, "n_delay", 0)
        sites = getattr(g.model, "lat_sites", ())
        zim = getattr(g.model, "zi_meta", {})
        for j in range(len(g.instances)):
            for kind, loff, nsl in sites:
                if not kind.startswith("zi"):
                    continue
                nb, _na = zim[loff]
                base = int(g.dly_idx[j, nd + loff])
                meta.append((base, nb, nsl - 2 - (nb - 1),
                             base + 2 if nb > 1 else None))
    return meta


def _jacobian(f, x):
    """∂f/∂x of a tensor function of one tensor (reverse mode)."""
    return torch.autograd.functional.jacobian(f, x, vectorize=False)


def _delay_ac(compiled, x, ctx_ac, params):
    """The frequency-dependent stamps of the aux channel at the operating
    point ``x`` [n_x], or None for a circuit with neither ring slots nor
    zi_* sites:

    - a ring slot (a delay line, a history-mode absdelay): δd =
      e^{−jωtd}·(∂u/∂x)·δx exactly, so A(ω) += (∂S/∂d + jω·∂Q/∂d)·
      e^{−jωtd}·∂u/∂x;
    - a zi_* site: δy = H(e^{jωT})·(∂u/∂x)·δx, H's taps read from the
      Jacobians of the latch update (∂y_new/∂u_hist the numerator,
      −∂y_new/∂y_hist the denominator, ∂y_new/∂x the sampled input).

    Returns {"dly0": the aux vector at the op (latches settled, ring
    slots at u), "ring": (∂S/∂d, ∂Q/∂d, ∂u/∂x, td) or None, "lat": per zi
    site (y slot, T, denominator taps, numerator taps, β0·∂u/∂x, ∂u/∂x
    of the first input sample or None, ∂S/∂y, ∂Q/∂y)}.  On the sparse
    path it raises: the JAX package's returns None there and linearises at
    aux = 0 without the stamps."""
    zi_meta = _zi_site_meta(compiled)
    if compiled.n_ring == 0 and not zi_meta:
        return None
    if use_sparse_solver(compiled):
        raise NotImplementedError(
            "AC/noise of a circuit with ring or zi_* sites on the sparse "
            "path: the JAX package linearises it at aux = 0 without the "
            "delay stamps (a known fault of the reference, "
            "cedarsim_tpu/analysis/ac.py:107-109), and the port stamps the "
            "dense path only; compile with sparse=False")
    dt = compiled.dtype
    dly0 = compiled.latch_init(x, ctx_ac, params)
    rs = torch.as_tensor(compiled.ring_slots, device=compiled.device)
    if compiled.n_ring:
        u0, td0 = compiled.delay_sources(x, ctx_ac, params)
        dly0 = dly0.clone()
        dly0[rs] = u0
    JdS, JdQ = _jacobian(
        lambda d: compiled.residuals(x, ctx_ac, params, dly=d), dly0)
    ring = None
    if compiled.n_ring:
        Ux = _jacobian(lambda xx: compiled.delay_sources(
            xx, ctx_ac, params)[0], x)
        ring = (JdS[:, rs], JdQ[:, rs], Ux, td0)
    lat = []
    if zi_meta:
        # every site fires once: a time beyond every settled t_next
        tn = torch.stack([dly0[b + 1] for b, _, _, _ in zi_meta])
        ctx_f = ctx_ac.at_time(2.0 * float(tn.max()) + 1e-12)

        def up(w_, x_):
            return compiled.latch_update(x_, ctx_f, w_, params)

        wnew = up(dly0, x)
        Ju = _jacobian(lambda w_: up(w_, x), dly0)
        Jxl = _jacobian(lambda x_: up(dly0, x_), x)
        for base, nb, n_yh, uh0 in zi_meta:
            T = wnew[base + 1] - dly0[base + 1]
            yh0 = base + 2 + (nb - 1)
            alphas = torch.cat([(-Ju[base, base])[None],
                                -Ju[base, yh0:yh0 + n_yh]])
            betas = Ju[base, base + 2:base + 2 + (nb - 1)]
            ux = Jxl[uh0, :] if uh0 is not None else None
            lat.append((base, T, alphas, betas, Jxl[base, :], ux,
                        JdS[:, base], JdQ[:, base]))
    return dict(dly0=dly0.to(dt), ring=ring, lat=lat)


def _apply_delay_ac(A, w, dstamp):
    """A [n_f, n, n] + the stamps of :func:`_delay_ac` at ω = ``w`` [n_f]
    (the JAX package's ``_apply_delay_ac`` over the frequency axis)."""
    if dstamp is None:
        return A
    cd = A.dtype
    wc = w.to(cd)[:, None, None]
    if dstamp["ring"] is not None:
        JdS, JdQ, Ux, td0 = dstamp["ring"]
        ph = torch.exp(-1j * wc[:, :, 0] * td0.to(cd)[None])   # [n_f, R]
        A = A + (JdS.to(cd)[None] + 1j * wc * JdQ.to(cd)[None]) \
            @ (ph[:, :, None] * Ux.to(cd)[None])
    for _base, T, alphas, betas, num0, ux, colS, colQ in dstamp["lat"]:
        zinv = torch.exp(-1j * w.to(cd) * T.to(cd))              # [n_f]
        na = alphas.shape[0]
        pw = torch.arange(1, na + 1, device=A.device)
        den = 1.0 + (alphas.to(cd)[None] * zinv[:, None] ** pw).sum(-1)
        num_row = num0.to(cd)[None].expand(w.shape[0], -1)
        if ux is not None and betas.shape[0]:
            pb = torch.arange(1, betas.shape[0] + 1, device=A.device)
            taps = (betas.to(cd)[None] * zinv[:, None] ** pb).sum(-1)
            num_row = num_row + taps[:, None] * ux.to(cd)[None]
        r = num_row / den[:, None]
        A = A + (colS.to(cd)[None] + 1j * wc[:, :, 0] * colQ.to(cd)[None]
                 )[:, :, None] * r[:, None, :]
    return A


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
    """(A [n_f, n_x, n_x] complex, f [n_f], the aux vector the
    linearisation held, or None) at the operating point ``x``: G + jωC
    with the delay, latch and frequency stamps."""
    dstamp = _delay_ac(compiled, x, ctx_ac, params)
    dly0 = None if dstamp is None else dstamp["dly0"]
    G, C = compiled.jacobians(x, ctx_ac, params, dly=dly0)
    cd = config.complex_dtype
    f = torch.as_tensor(freqs, dtype=compiled.dtype, device=compiled.device)
    w = 2.0 * np.pi * f
    A = G.to(cd)[None] + (1j * w.to(cd))[:, None, None] * C.to(cd)[None]
    A = _apply_delay_ac(A, w, dstamp)
    A = _apply_freq_stamps(A, f, _freq_stamps(compiled), compiled.n_x)
    return A, f, dly0


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
    A, _, _ = _system(compiled, x, c, params, freqs)
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
    A, f, dly0 = _system(compiled, x, c, params, freqs)
    cd = config.complex_dtype
    Jeps = compiled.eps_jacobian(x, c, params, dly=dly0).to(cd)
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
