"""Harmonic balance: periodic steady state by Fourier spectral collocation
(counterpart of ``cedarsim_tpu/analysis/hb.py``).

The orbit is its values on an odd-N uniform grid over one period (N =
2·n_harmonics + 1: the real trigonometric interpolant through those samples
is the K-harmonic Fourier series), and the DAE residual d/dt Q(x) + S(x, t)
= 0 is collocated at the grid points with the time derivative taken
spectrally:

    r_j = S(x_j, t_j) + Σ_l D[j,l]·Q(x_l) = 0,   j = 0..N−1

D the periodic Fourier differentiation matrix (Trefethen, "Spectral Methods
in MATLAB", ch. 3).  The JAX package evaluates the N samples as one
``jax.vmap``; here they are N lanes of one model walk, each lane with its
own time (``SimSpec.time`` [N]).  The Newton matrix J[(j,a),(l,b)] =
δ_jl·G_j + D_jl·C_l is dense (N·n)² and solved with the exact float64
``torch.linalg`` solve, as the JAX package solves it with its exact
``ops/linalg.py::solve`` (no Pallas kernel); so are PAC's and PNOISE's
complex systems.

Entry points: ``hb`` (driven, known period) and ``hb_autonomous``
(oscillators: ω joins the unknowns, r = S + ω·D̂Q with D̂ the unit-period
matrix, the phase pinned by ẋ_anchor(θ=0) = 0), and around an orbit
``pac`` (periodic AC), ``pnoise`` (cyclostationary noise) and
``oscillator_phase_noise`` (the perturbation projection vector).  Both
orbits start from a short transient warm-up (``tran``: on a card, one
stream through the fused chord kernel B1 where the options select it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.analysis.ac import _eps_names
from cedarsim_tpu_torch.analysis.dc import solve_dc
from cedarsim_tpu_torch.analysis.tran import TranOptions, tran
from cedarsim_tpu_torch.core.compile import CompiledCircuit, default_ctx
from cedarsim_tpu_torch.core.context import Modes, SimSpec
from cedarsim_tpu_torch.ops import linalg


def _diff_matrix(n_samples: int) -> np.ndarray:
    """Periodic spectral differentiation matrix (float64) for an odd number
    of uniform samples over period 2π (scale by 2π/T for period T)."""
    N = n_samples
    if N % 2 == 0:
        raise ValueError("harmonic balance uses an odd sample count")
    j = np.arange(N)
    diff = j[:, None] - j[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        Dhat = np.where(diff == 0, 0.0,
                        0.5 * (-1.0) ** diff / np.sin(np.pi * diff / N))
    return Dhat.astype(np.float64)  # d/dθ on [0, 2π)


def _reject_aux_channels(compiled, what):
    if getattr(compiled, "n_dly", 0):
        raise NotImplementedError(
            f"{what} does not support integrator-carried aux state "
            "(exact-history delays / latched transition / zi_*): the "
            "collocation unknowns are the state samples only.  Use the "
            "state-based lowerings (delay_mode='pade', "
            "transition_mode='smooth') for harmonic balance.")


def _t(compiled, a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype or compiled.dtype,
                           device=compiled.device)


def _block_matrix(Dm, C, G=None):
    """(N·n)² matrix [(j,a),(l,b)] = Dm[j,l]·C_l[a,b] (+ δ_jl·G_j[a,b]):
    Dm [N, N], C and G [N, n, n]."""
    N, n = C.shape[0], C.shape[1]
    J = torch.einsum("jl,lab->jalb", Dm, C)
    if G is not None:
        idx = torch.arange(N, device=C.device)
        J[idx, :, idx, :] += G
    return J.reshape(N * n, N * n)


def _block_diag(C):
    """blockdiag(C_j) [(N·n)²] of C [N, n, n]."""
    N, n = C.shape[0], C.shape[1]
    out = torch.zeros(N, n, N, n, dtype=C.dtype, device=C.device)
    idx = torch.arange(N, device=C.device)
    out[idx, :, idx, :] = C
    return out.reshape(N * n, N * n)


@dataclasses.dataclass
class HBResult:
    """One period of the steady state on the collocation grid.

    ``x_samples[j]`` is the state at ``t_samples[j]``; any signal is
    available as exact trigonometric interpolation through its samples
    (``interp``) or as complex harmonic coefficients (``spectrum``, with
    ``spectrum(name)[k]`` multiplying ``exp(+i k ω t)``; coefficient 0 is
    the DC term and |X_k| is half the peak amplitude of harmonic k>0).
    """
    compiled: CompiledCircuit
    params: object
    ctx: SimSpec
    t_samples: np.ndarray      # [N]
    x_samples: np.ndarray      # [N, n_x]
    xdot_samples: np.ndarray   # [N, n_x] spectral derivative
    period: float
    converged: bool
    iters: int
    resnorm: float             # max |r| at the solution
    n_harmonics: int

    @property
    def freq(self) -> float:
        return 1.0 / self.period

    def samples(self, name: str) -> np.ndarray:
        """Signal values at the collocation times."""
        c = self.compiled
        fn = c.observe(name)
        ctx = self.ctx.with_mode(Modes.TRAN).at_time(
            _t(c, self.t_samples))
        out = fn(_t(c, self.x_samples), _t(c, self.xdot_samples), ctx,
                 self.params)
        return out.detach().cpu().numpy()

    def spectrum(self, name: str) -> np.ndarray:
        """Complex harmonic coefficients X_k, k = 0..n_harmonics, such that
        signal(t) = X_0 + 2·Re Σ_{k≥1} X_k exp(i k ω t)."""
        y = self.samples(name)
        X = np.fft.fft(y) / len(y)
        return X[: self.n_harmonics + 1]

    def interp(self, name: str, t) -> np.ndarray:
        """Exact trigonometric interpolation of a signal at time(s) t."""
        X = self.spectrum(name)
        t = np.asarray(t, dtype=float)
        w = 2.0 * np.pi / self.period
        k = np.arange(1, self.n_harmonics + 1)
        y = X[0].real + 2.0 * np.real(
            np.exp(1j * np.outer(t, k * w)) @ X[1:])
        return y if t.ndim else float(y.reshape(-1)[0])

    def thd(self, name: str) -> float:
        """Total harmonic distortion of a signal: sqrt(Σ_{k≥2}|X_k|²)/|X_1|
        (the .four definition, analysis/measure.py::fourier)."""
        X = self.spectrum(name)
        return float(np.sqrt(np.sum(np.abs(X[2:]) ** 2)) /
                     max(np.abs(X[1]), 1e-300))


def _max_abs(z):
    if isinstance(z, tuple):
        return max(float(v.abs().max()) for v in z)
    return float(z.abs().max())


def _finite(z):
    parts = z if isinstance(z, tuple) else (z,)
    return all(bool(torch.isfinite(v).all()) for v in parts)


def _axpy(z, lam, dz):
    if isinstance(z, tuple):
        return tuple(a + lam * b for a, b in zip(z, dz))
    return z + lam * dz


def _newton(r_fn, step_fn, z0, tol, max_iter, damping):
    """Damped Newton with residual-norm backtracking (a host loop, as in
    the JAX package: the iteration counts are small)."""
    z = z0
    rn = _max_abs(r_fn(z))
    converged = rn <= tol
    it = 0
    for it in range(1, max_iter + 1):
        if converged:
            break
        dz = step_fn(z)
        if not _finite(dz):
            break
        lam = damping
        improved = False
        for _ in range(8):
            z_try = _axpy(z, lam, dz)
            rn_try = _max_abs(r_fn(z_try))
            if np.isfinite(rn_try) and (rn_try < rn or rn_try <= tol):
                z, rn, improved = z_try, rn_try, True
                break
            lam *= 0.5
        if not improved:
            break
        converged = rn <= tol
    return z, converged, it, rn


def _warmup_samples(compiled, period, params, ctx, opts, warmup_periods,
                    ts_in_period, x0=None):
    """Integrate ``warmup_periods`` of transient and sample the last period
    at the collocation phases: the standard HB initial guess."""
    T = float(period)
    t_end = warmup_periods * T
    sol = tran(compiled, (0.0, t_end + T), params=params, ctx=ctx,
               opts=opts, x0=x0)
    ts = t_end + np.asarray(ts_in_period)
    return sol.interp_state(ts), sol


def hb(compiled: CompiledCircuit, period: float, params=None,
       ctx: SimSpec = None, n_harmonics: int = 15, max_iter: int = 30,
       tol: float = 1e-9, damping: float = 1.0, init: str = "transient",
       warmup_periods: int = 2, tran_opts: TranOptions = None) -> HBResult:
    """Harmonic-balance PSS of a circuit driven at a known ``period``.

    ``init``: "transient" (default: integrate ``warmup_periods`` periods
    and sample; robust for strongly nonlinear circuits) or "dc" (flat
    operating-point start; fine for mildly nonlinear ones).
    """
    _reject_aux_channels(compiled, "harmonic balance")
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    T = float(period)
    N = 2 * int(n_harmonics) + 1
    n = compiled.n_x
    ts = np.arange(N) * (T / N)
    D = _t(compiled, (2.0 * np.pi / T) * _diff_matrix(N))
    ctx_t = ctx.with_mode(Modes.TRAN).at_time(_t(compiled, ts))

    def r_fn(xs):
        S, Q = compiled.residuals(xs, ctx_t, params)
        return S + D @ Q

    def step_fn(xs):
        S, Q, G, C = compiled.res_jacs_fwd(xs, ctx_t, params)
        r = S + D @ Q
        # J[(j,a),(l,b)] = δ_jl G_j[a,b] + D[j,l] C_l[a,b]
        J = _block_matrix(D, C, G)
        return linalg.solve(J, -r.reshape(N * n)).reshape(N, n)

    if init == "transient":
        xs0, _ = _warmup_samples(compiled, T, params, ctx, tran_opts,
                                 warmup_periods, ts)
        xs0 = _t(compiled, xs0)
    else:
        op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
        xs0 = op.x[None, :].expand(N, n).clone()

    scale = float(xs0.abs().max()) + 1.0
    xs, converged, it, rn = _newton(r_fn, step_fn, xs0, tol * scale,
                                    max_iter, damping)
    return HBResult(compiled=compiled, params=params, ctx=ctx,
                    t_samples=ts, x_samples=xs.cpu().numpy(),
                    xdot_samples=(D @ xs).cpu().numpy(), period=T,
                    converged=bool(converged), iters=it, resnorm=rn,
                    n_harmonics=int(n_harmonics))


def _orbit_jacobians(res: HBResult):
    """(D, ctx at the sample times, x samples, G, C [N, n, n]) of an HB
    orbit."""
    compiled, params = res.compiled, res.params
    N = res.x_samples.shape[0]
    D = _t(compiled, (2.0 * np.pi / res.period) * _diff_matrix(N))
    ctx_t = res.ctx.with_mode(Modes.TRAN).at_time(_t(compiled,
                                                     res.t_samples))
    xs = _t(compiled, res.x_samples)
    G, C = compiled.jacobians(xs, ctx_t, params)
    return D, ctx_t, xs, G, C


@dataclasses.dataclass
class PACSolution:
    """Periodic AC: small-signal transfer from the circuit's ``ac=``
    sources to every sideband ``f_in + k·f0`` around the periodic orbit.

    ``u[i, j, :]`` is the complex periodic envelope of the small-signal
    response at input frequency ``freqs[i]``, collocation sample ``j``:
    the full small-signal waveform is ``Re[(Σ_k U_k e^{i k ω0 t})
    e^{i 2π f_in t}]``.  ``sidebands(name)[i, k]`` is the complex gain to
    the output component at ``freqs[i] + k·f0`` (k from ``k_values``).
    """
    hbres: HBResult
    freqs: np.ndarray          # [nf] input frequencies (Hz)
    u: np.ndarray              # [nf, N, n_x] complex envelope samples

    @property
    def k_values(self) -> np.ndarray:
        N = self.u.shape[1]
        K = (N - 1) // 2
        return np.arange(-K, K + 1)

    def _obs_envelope(self, name) -> np.ndarray:
        """The observable's complex envelope at every (freq, sample): its
        forward-mode derivative along the real and imaginary parts of
        (u, u̇ + iωu), the JAX package's two jvps."""
        res = self.hbres
        compiled, params = res.compiled, res.params
        fn = compiled.observe(name)
        N = self.u.shape[1]
        nf = len(self.freqs)
        D = _t(compiled, (2.0 * np.pi / res.period) * _diff_matrix(N))
        ts = np.tile(res.t_samples, nf)
        ctx = res.ctx.with_mode(Modes.TRAN).at_time(_t(compiled, ts))
        xs = _t(compiled, np.tile(res.x_samples, (nf, 1)))
        xds = _t(compiled, np.tile(res.xdot_samples, (nf, 1)))
        u = torch.as_tensor(self.u, dtype=config.complex_dtype,
                            device=compiled.device)
        w = 2.0 * np.pi * _t(compiled, self.freqs)
        # tangent of xdot: d/dt(u e^{iωt}) envelope = u̇ + iω u
        ud = torch.einsum("jl,fla->fja", D.to(u.dtype), u) \
            + 1j * w.to(u.dtype)[:, None, None] * u
        out = []
        for part in (torch.real, torch.imag):
            with fwAD.dual_level():
                x = fwAD.make_dual(xs, part(u).reshape(nf * N, -1))
                xd = fwAD.make_dual(xds, part(ud).reshape(nf * N, -1))
                dy = fwAD.unpack_dual(fn(x, xd, ctx, params)).tangent
            out.append(torch.zeros(nf * N, dtype=compiled.dtype,
                                   device=compiled.device)
                       if dy is None else dy)
        return torch.complex(out[0], out[1]).reshape(nf, N).cpu().numpy()

    def sidebands(self, name: str) -> np.ndarray:
        """[nf, N] complex gains to output components at
        ``freqs[i] + k_values·f0``."""
        env = self._obs_envelope(name)          # [nf, N]
        N = env.shape[1]
        K = (N - 1) // 2
        Uk = np.fft.fft(env, axis=1) / N        # e^{+ikω0t} coefficients
        return np.concatenate([Uk[:, N - K:], Uk[:, : K + 1]], axis=1)

    def gain(self, name: str, k: int = 0) -> np.ndarray:
        """Complex gain [nf] to the sideband ``f_in + k·f0``."""
        sb = self.sidebands(name)
        K = (sb.shape[1] - 1) // 2
        return sb[:, K + k]


def pac(res: HBResult, freqs) -> PACSolution:
    """Periodic AC analysis around a harmonic-balance orbit.

    For an input tone at ``f_in`` through the circuit's ``ac=`` sources,
    the response is ``u(t)·e^{i 2π f_in t}`` with ``u`` T-periodic and
    G(t)u + d/dt(C(t)u) + iω_in·C(t)u = b (b = ``ac_rhs``).  Collocated on
    the HB grid, one dense complex solve per input frequency, batched over
    the frequencies:

        [blockdiag(G_j + iω_in C_j) + D·blockdiag(C_j)] U = B
    """
    compiled, params = res.compiled, res.params
    _reject_aux_channels(compiled, "periodic AC")
    if compiled.circuit.sparam_blocks:
        raise NotImplementedError(
            "periodic AC does not support S-parameter frequency stamps")
    cd = config.complex_dtype
    N, n = res.x_samples.shape
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    D, _, _, G, C = _orbit_jacobians(res)
    A0 = _block_matrix(D.to(cd), C.to(cd), G.to(cd))
    Cblk = _block_diag(C.to(cd))
    B = compiled.ac_rhs(params).repeat(N)
    ws = 2.0 * np.pi * _t(compiled, freqs)
    A = A0[None] + 1j * ws.to(cd)[:, None, None] * Cblk[None]
    u = linalg.solve(A, B.expand(len(freqs), N * n).contiguous())
    return PACSolution(hbres=res, freqs=freqs,
                       u=u.reshape(len(freqs), N, n).cpu().numpy())


@dataclasses.dataclass
class PNoiseSolution:
    """Cyclostationary (periodic) noise at an output around an HB orbit.

    ``psd[i]`` is the output noise PSD at ``freqs[i]`` with noise folded in
    from every sideband ``freqs[i] − k·f0``; ``per_source[i, s]`` splits it
    by noise source (already sideband-summed)."""
    freqs: np.ndarray
    psd: np.ndarray            # [nf]
    per_source: np.ndarray     # [nf, n_eps]
    eps_names: list
    hbres: HBResult
    k_sidebands: int

    def __getitem__(self, _name="out"):
        return self.psd

    def total(self, f1=None, f2=None):
        f = self.freqs
        lo = f[0] if f1 is None else f1
        hi = f[-1] if f2 is None else f2
        m = (f >= lo) & (f <= hi)
        return float(np.sqrt(np.trapezoid(self.psd[m], f[m])))

    def source(self, name):
        if name in self.eps_names:
            return self.per_source[:, self.eps_names.index(name)]
        cols = [k for k, n in enumerate(self.eps_names)
                if n.rsplit("#", 1)[0] == name]
        if not cols:
            raise KeyError(f"no noise source {name!r}; have {self.eps_names}")
        return self.per_source[:, cols].sum(axis=1)


def _noise_columns(compiled, xs, ctx_t, params):
    """(∂S/∂eps [N, n, n_eps], pwr [N, n_eps], exp [N, n_eps]) along the
    orbit samples."""
    Jeps = compiled.eps_jacobian(xs, ctx_t, params)
    pwr, ex = compiled.noise_sources(xs, ctx_t, params)
    return Jeps, pwr, ex


def pnoise(res: HBResult, out: str, freqs, k_sidebands: int = None
           ) -> PNoiseSolution:
    """Periodic noise analysis (PSS/PNOISE).

    Each device noise source is a unit stationary process amplitude-
    modulated along the orbit, entering the linearised system through the
    periodic column ``c_s(t) = ∂F/∂ε_s(t)·sqrt(pwr_s(t))``.  The output
    PSD at f folds every input sideband through the periodic small-signal
    operator:

        S(f) = Σ_s Σ_{|k|≤K} |L_k[A(ω_k)⁻¹ c_s]|² · |f − k·f0|^(−exp_s)

    ω_k = 2π(f − k·f0), L_k the k-th output-envelope harmonic at the
    output observable, A the collocation operator of ``pac``.  One
    transposed solve per (f, k) gives the transfers from every source at
    once, the (f × k) grid one batched solve.  ``k_sidebands`` defaults to
    the orbit's harmonic truncation."""
    compiled, params = res.compiled, res.params
    _reject_aux_channels(compiled, "periodic noise")
    if compiled.circuit.sparam_blocks:
        raise NotImplementedError(
            "periodic noise does not support S-parameter frequency stamps")
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    if compiled.n_eps == 0:
        return PNoiseSolution(freqs, np.zeros_like(freqs),
                              np.zeros((len(freqs), 0)), [], res, 0)
    cd = config.complex_dtype
    N, n = res.x_samples.shape
    f0 = 1.0 / res.period
    K = res.n_harmonics if k_sidebands is None else int(k_sidebands)
    ks = np.arange(-K, K + 1)
    D, ctx_t, xs, G, C = _orbit_jacobians(res)

    # (f, k) product grid, flattened into one batch
    fg, kg = np.meshgrid(freqs, ks, indexing="ij")
    nu = fg - kg * f0                     # signed input frequency per pair
    w_in = _t(compiled, 2.0 * np.pi * nu.reshape(-1))
    k_flat = _t(compiled, kg.reshape(-1))

    Jeps, pwr, ex = _noise_columns(compiled, xs, ctx_t, params)
    Cmod = Jeps * torch.sqrt(pwr.clamp(min=0.0))[:, None, :]
    Cfull = Cmod.reshape(N * n, compiled.n_eps).to(cd)
    # output linearisation along the orbit (∂obs/∂x per sample; the
    # stationary noise() makes the same ẋ-independence assumption)
    obs = compiled.observe(out)
    xx = xs.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        y = obs(xx, _t(compiled, res.xdot_samples), ctx_t, params)
        e_j = (torch.autograd.grad(y.sum(), xx, allow_unused=True)[0]
               if y.requires_grad else None)
    if e_j is None:
        e_j = torch.zeros_like(xs)
    A0 = _block_matrix(D.to(cd), C.to(cd), G.to(cd))
    Cblk = _block_diag(C.to(cd))
    jgrid = torch.arange(N, device=compiled.device, dtype=compiled.dtype)
    A = A0[None] + 1j * w_in.to(cd)[:, None, None] * Cblk[None]
    # L_k functional: (1/N)·Σ_j e^{−i2πjk/N}·e_j·u_j
    ph = torch.exp(-2j * np.pi * (k_flat[:, None] * jgrid[None, :]).to(cd)
                   / N) / N                               # [nfk, N]
    ev = (ph[:, :, None] * e_j.to(cd)[None]).reshape(-1, N * n)
    v = linalg.solve(A.transpose(-1, -2), ev)
    Tmat = (v @ Cfull).cpu().numpy().reshape(len(freqs), len(ks),
                                             compiled.n_eps)
    ex0 = ex[0].cpu().numpy()
    # flicker weight at the folded input frequency (clamped away from the
    # k·f0 = f singularity)
    nu_abs = np.maximum(np.abs(nu), 1e-12)
    wgt = nu_abs[:, :, None] ** (-ex0[None, None, :])
    per = (np.abs(Tmat) ** 2 * wgt).sum(axis=1)           # [nf, n_eps]
    return PNoiseSolution(freqs=freqs, psd=per.sum(axis=1), per_source=per,
                          eps_names=_eps_names(compiled), hbres=res,
                          k_sidebands=K)


@dataclasses.dataclass
class PhaseNoiseResult:
    """Oscillator phase noise via the perturbation projection vector
    (Demir/Mehrotra/Roychowdhury, "Phase noise in oscillators: a unifying
    theory", TCAS-I 2000).

    ``c`` is the time-shift diffusion constant (seconds): the variance of
    the oscillator's accumulated time jitter grows as ``c·t``, so the RMS
    jitter after n periods is ``sqrt(c·n·T)``.  The carrier-normalised
    spectrum is the Lorentzian  L(Δf) = f0²c / (π²f0⁴c² + Δf²).
    """
    c: float                   # phase (time-shift) diffusion constant [s]
    ppv: np.ndarray            # [N, n_x] PPV samples (time-shift normalised)
    per_source: np.ndarray     # [n_eps] contribution of each source to c
    eps_names: list
    hbres: HBResult
    #: quality metrics: relative spread of the biorthogonality product
    #: v(t)·C(t)·ẋ(t) across samples (≪1 for a trustworthy PPV), and the
    #: relative residual of the right null vector ẋ
    norm_spread: float
    null_resid: float

    def jitter(self, n_periods: float = 1.0) -> float:
        """RMS accumulated jitter after ``n_periods`` [s]."""
        return float(np.sqrt(self.c * n_periods * self.hbres.period))

    def ldbc(self, offsets) -> np.ndarray:
        """Phase noise L(Δf) in dBc/Hz at offset frequencies [Hz]."""
        df = np.atleast_1d(np.asarray(offsets, float))
        f0 = self.hbres.freq
        s = f0 ** 2 * self.c / (np.pi ** 2 * f0 ** 4 * self.c ** 2
                                + df ** 2)
        return 10.0 * np.log10(np.maximum(s, 1e-300))


def oscillator_phase_noise(res: HBResult, inv_iters: int = 3
                           ) -> PhaseNoiseResult:
    """Phase noise of an autonomous oscillator from its HB orbit.

    ẋ(t) is the right null function of the linearised periodic operator A
    (the collocation Jacobian Newton used); the PPV v(t) is the left null
    function, normalised by the Floquet biorthogonality v(t)ᵀC(t)ẋ(t) = 1,
    by inverse iteration on Aᵀ.  Each white noise source s, entering
    through c_s(t) = ∂F/∂ε_s·sqrt(pwr_s(t)) with double-sided PSD ½,
    contributes

        c = (1/2N) Σ_j Σ_s (v_jᵀ c_{s,j})²   [seconds]

    to the time-shift diffusion.  Flicker sources are excluded."""
    compiled, params = res.compiled, res.params
    d = compiled.dtype
    N, n = res.x_samples.shape
    D, ctx_t, xs, G, C = _orbit_jacobians(res)
    A = _block_matrix(D, C, G)
    # right null vector: the orbit derivative (a check only)
    xd = _t(compiled, res.xdot_samples)
    r0 = xd.reshape(N * n)
    null_resid = (torch.linalg.norm(A @ r0)
                  / (torch.linalg.norm(A) * torch.linalg.norm(r0) / (N * n)
                     + 1e-300))
    # left null vector by inverse iteration on Aᵀ
    v = torch.ones(N * n, dtype=d, device=compiled.device)
    for _ in range(inv_iters):
        v = linalg.solve(A.T, v)
        v = v / torch.linalg.norm(v)
    V = v.reshape(N, n)
    # biorthogonality normalisation v_jᵀ C_j ẋ_j = 1
    s = torch.einsum("ja,jab,jb->j", V, C, xd)
    V = V / s.mean()
    spread = s.std(correction=0) / s.mean().abs()
    if compiled.n_eps:
        Jeps, pwr, ex = _noise_columns(compiled, xs, ctx_t, params)
        white = (ex[0] == 0.0).to(d)
        Cmod = Jeps * (torch.sqrt(pwr.clamp(min=0.0))
                       * white[None, :])[:, None, :]
        proj = torch.einsum("ja,jas->js", V, Cmod)        # [N, n_eps]
        per = (proj ** 2).sum(0) / (2.0 * N)               # [n_eps]
    else:
        per = torch.zeros(0, dtype=d, device=compiled.device)
    per = per.cpu().numpy()
    return PhaseNoiseResult(c=float(per.sum()), ppv=V.cpu().numpy(),
                            per_source=per, eps_names=_eps_names(compiled),
                            hbres=res, norm_spread=float(spread),
                            null_resid=float(null_resid))


def hb_autonomous(compiled: CompiledCircuit, period_guess: float,
                  anchor: str, params=None, ctx: SimSpec = None,
                  n_harmonics: int = 15, max_iter: int = 40,
                  tol: float = 1e-9, damping: float = 1.0,
                  warmup_periods: float = 8.0, kick: float = 0.0,
                  tran_opts: TranOptions = None) -> HBResult:
    """Harmonic-balance PSS of an autonomous oscillator: the period is a
    Newton unknown.

    ``anchor`` names a net whose spectral derivative is pinned to zero at
    sample 0 (the phase gauge: pick a node that oscillates).
    ``period_guess`` seeds both ω and the transient warm-up used for the
    waveform guess; the warm-up's last upswing of the anchor node is
    phase-aligned so the anchor condition starts near-satisfied.

    ``kick``: startup perturbation added to the anchor state before the
    warm-up transient (an oscillator's operating point is an often exactly
    metastable equilibrium the integrator would sit on).
    """
    _reject_aux_channels(compiled, "harmonic balance")
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    d, dev = compiled.dtype, compiled.device
    N = 2 * int(n_harmonics) + 1
    n = compiled.n_x
    Dhat = _t(compiled, _diff_matrix(N))                  # d/dθ, θ∈[0,2π)
    net = compiled.circuit._nets.get(anchor)
    if net is None or net.is_ground:
        raise ValueError(f"anchor {anchor!r} must be a non-ground net")
    sel = net.index
    theta = np.arange(N) * (2.0 * np.pi / N)
    # the sources of an autonomous circuit are constant in TRAN mode, so
    # every sample is evaluated at time 0
    ctx_t = ctx.with_mode(Modes.TRAN).at_time(0.0)

    def r_fn(z):
        xs, w = z
        S, Q = compiled.residuals(xs, ctx_t, params)
        r = S + w * (Dhat @ Q)
        a = (Dhat @ xs)[0, sel]            # phase anchor: ẋ_sel(θ=0) = 0
        return torch.cat([r.reshape(-1), a[None]])

    def step_fn(z):
        xs, w = z
        S, Q, G, C = compiled.res_jacs_fwd(xs, ctx_t, params)
        DQ = Dhat @ Q
        r = S + w * DQ
        J = _block_matrix(w * Dhat, C, G)
        A = torch.zeros(N * n + 1, N * n + 1, dtype=d, device=dev)
        A[:-1, :-1] = J
        A[:-1, -1] = DQ.reshape(-1)
        A[-1, torch.arange(N, device=dev) * n + sel] = Dhat[0, :]
        rhs = -torch.cat([r.reshape(-1), (Dhat @ xs)[0, sel][None]])
        dz = linalg.solve(A, rhs)
        return dz[:-1].reshape(N, n), dz[-1]

    # --- initial guess: transient warm-up, phase-aligned on the anchor ---
    T0 = float(period_guess)
    x0w = None
    if kick:
        op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
        x0w = op.x.detach().clone()
        x0w[sel] += kick
    t_total = (warmup_periods + 2.0) * T0
    sol = tran(compiled, (0.0, t_total), params=params, ctx=ctx,
               opts=tran_opts, x0=x0w)
    # the period from the mean spacing of the anchor's rising midlevel
    # crossings over the settled tail, a window several guessed periods
    # long (a stale guess can steer Newton onto a higher-mode orbit)
    t_lo = max(0.0, t_total - max(5.0 * T0, 0.5 * t_total))
    tq = np.linspace(t_lo, t_total, 8192)
    y = np.interp(tq, sol.ts, np.asarray(sol[anchor]))
    mid = 0.5 * (y.max() + y.min())
    up = np.where((y[:-1] < mid) & (y[1:] >= mid))[0]
    T_est = T0
    if len(up) >= 3:
        tc = tq[up] + (mid - y[up]) / (y[up + 1] - y[up]) * (tq[1] - tq[0])
        T_est = float(np.mean(np.diff(tc)[-4:]))
    elif len(up) == 2:
        T_est = float(up[1] - up[0]) * (tq[1] - tq[0])
    # start the grid at the anchor's maximum (ẋ_sel ≈ 0 there), placed so
    # the whole grid period lies inside the integrated span
    w_lo = max(t_lo, t_total - 2.0 * T_est)
    w_hi = max(w_lo + 1e-300, t_total - T_est)
    tq2 = np.linspace(w_lo, w_hi, 1024, endpoint=False)
    y2 = np.interp(tq2, sol.ts, np.asarray(sol[anchor]))
    t_start = tq2[int(np.argmax(y2))]
    ts0 = t_start + theta / (2.0 * np.pi) * T_est
    xs0 = _t(compiled, sol.interp_state(ts0))
    w0 = torch.as_tensor(2.0 * np.pi / T_est, dtype=d, device=dev)

    scale = float(xs0.abs().max()) + 1.0
    z, converged, it, rn = _newton(r_fn, step_fn, (xs0, w0), tol * scale,
                                   max_iter, damping)
    xs, w = z
    T = float(2.0 * np.pi / float(w))
    ts = theta / (2.0 * np.pi) * T
    return HBResult(compiled=compiled, params=params, ctx=ctx,
                    t_samples=ts, x_samples=xs.cpu().numpy(),
                    xdot_samples=(float(w) * (Dhat @ xs)).cpu().numpy(),
                    period=T, converged=bool(converged), iters=it,
                    resnorm=rn, n_harmonics=int(n_harmonics))
