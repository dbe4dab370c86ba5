"""Static-pattern sparse LU over a lane axis (counterpart of
``cedarsim_tpu/ops/sparse_lu.py``): the host plan, and the numeric factor
and solve with their two hand-written CUDA kernels.

**Plan (host, once per circuit).**  ``SparsePlan``, ``_pack_runs``,
``_structural_matching`` (the MC64-style max-product matching through
scipy, with the greedy matching as its fallback) and ``build_plan`` are a
copy of the JAX package's numpy code: that module imports JAX, so the port
keeps its own.  Only the import of ``ops/sparse.py`` differs, and the
plan is compared by identity (``eq=False``) instead of by its arrays, so
that it keys the per-device schedules below.

**Numeric (per solve).**  Values live in the filled pattern with a leading
lane axis, ``[L, nnz_f]`` (or ``[nnz_f]`` for one system): every lane
shares the plan.  :func:`factor` and :func:`solve_factored` take their
plain PyTorch versions (:func:`factor_plain`, :func:`solve_factored_plain`)
for a tensor on the CPU and launch their kernel for a CUDA tensor, raising
on a failed build or launch; there is no other path.

- S1, ``sparse_factor_f64`` (``csrc/sparse_lu.cu``), runs the level
  schedule of ``cedarsim_tpu/ops/sparse_lu.py::factor`` in one launch:
  per level, the pivots boosted to ±τ (``_boosted``) and written back, the
  L entries divided by them, then every trailing entry minus its L·U
  products; at the end every pivot boosted once more.
- S2, ``sparse_solve_f64``, runs ``solve_factored`` in one launch: y =
  b[rperm], the forward sweep over unit L, the backward sweep (``x -= Σ
  f·x``, then ``x /= f[diag]``), out[cperm] = x.

The JAX package runs each as one compiled program over the levels
(``jax.lax.fori_loop`` over packed bands); the port's counterpart of that
program is one kernel launch, since an eager loop would launch several
kernels a level (32 factor levels on the 40-cell BSIM4 chain).

**Summation order.**  Several updates of one level can add into one
position.  Each level's updates are grouped by destination once per plan
(a CSR: destinations, offsets, and the (l, u) pairs in list order).  The
kernels form every product of a level at once, then one thread owns a
destination and subtracts its products in list order (destinations dealt
longest first, :func:`_longest_first`); the plain versions sum the same
terms in the same order, as an explicit padded ``[m, k_max]`` gather and
a sequential loop over k (the padding reads a trash slot that holds 0, and
``a - 0·0`` is ``a``).  A product rounds on its own in both (the kernels
are built without fused multiply-adds), so where it is formed changes no
bit.  The backward sweep sums its terms from zero, then subtracts the sum,
as ``segment_sum`` does; the forward sweep subtracts term by term.  So
each kernel is bitwise its plain version, and both take the order of a
serial scatter over the JAX plan's update lists.  The wrappers count their
kernel launches in ``factor.launches`` and ``solve_factored.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import weakref

import numpy as np
import torch

from cedarsim_tpu_torch.ops import cuda_lib


# ---------------------------------------------------------------- host plan

@dataclasses.dataclass(frozen=True, eq=False)
class SparsePlan:
    n: int
    #: row/col of each stored position (original matrix indices, pre-perm)
    nnz: int                   # input pattern nonzeros
    nnz_f: int                 # filled pattern nonzeros
    #: input pattern → filled-value-vector position
    in_pos: np.ndarray         # [nnz] int32
    #: original (row, col) of each input-pattern entry, for assembly maps
    in_rows: np.ndarray
    in_cols: np.ndarray
    #: permutations: factorized M[i,j] = A[rperm[i], cperm[j]]
    rperm: np.ndarray          # [n] row of A supplying permuted row i
    cperm: np.ndarray          # [n] col of A supplying permuted col j
    #: value-vector position of each diagonal M[k,k]
    diag_pos: np.ndarray       # [n] int32
    #: position of A[i,i] in the value vector, -1 where absent
    a_diag_pos: np.ndarray     # [n] int32
    #: A-space row / col of every stored position
    pos_arow: np.ndarray       # [nnz_f] int32
    pos_acol: np.ndarray       # [nnz_f] int32
    #: per-level schedules (static python lists of index arrays)
    div_dst: tuple             # each [m_l] positions of L entries to scale
    div_piv: tuple             # each [m_l] positions of their pivots
    upd_dst: tuple             # each [u_l] positions receiving -L*U
    upd_l: tuple
    upd_u: tuple
    #: forward/backward substitution schedules (leveled)
    f_lev: tuple               # each level: (dst_rows [m], src_cols [m], pos [m])
    b_lev: tuple
    n_levels: int
    #: packed level schedules for the fori_loop numeric path (empty when
    #: n_levels <= UNROLL_LEVELS: small plans stay unrolled).  Each "run"
    #: is a contiguous band of levels padded to the band's max width, so
    #: the compiled program is O(#runs) instead of O(#levels) — the
    #: unrolled sweep made XLA compile time scale with circuit depth
    #: (measured: 452-unknown chain 67.9k HLO lines / 112 s XLA unrolled).
    fact_runs: tuple = ()      # (DD, DP, UD, UL, UU) per run, [L, w*] each
    fwd_runs: tuple = ()       # (ROWS, COLS, POS) per run
    bwd_runs: tuple = ()       # (ROWS, COLS, POS, DIAG_I, DIAG_P) per run


#: level-count threshold below which the numeric phase stays unrolled
#: (small circuits: unrolling compiles fast anyway and avoids loop
#: dispatch overhead per level)
UNROLL_LEVELS = 40

#: padded-size/true-size budget when packing contiguous level bands — a
#: new level joins the current band only while total padding stays below
#: this factor (wide early levels and narrow late levels land in
#: different bands)
_PACK_WASTE = 2.0


def _pack_runs(levels, slot_groups):
    """Pack a list of per-level tuples-of-index-arrays into contiguous
    padded bands.  ``slot_groups``: [(slot_indices, pad_value), ...] —
    slots in one group share their natural length and are padded to the
    group's per-band max.  Returns a tuple of runs, each a tuple of
    [n_lev_in_run, w_group] int32 arrays in original slot order."""
    if not levels:
        return ()

    def cost(lv):
        return sum(len(lv[g[0][0]]) for g in slot_groups)

    widths = [cost(lv) for lv in levels]
    runs = []
    start = 0
    while start < len(levels):
        end = start + 1
        wmax = widths[start]
        tot = widths[start]
        while end < len(levels):
            w2 = max(wmax, widths[end])
            if w2 * (end - start + 1) > _PACK_WASTE * (tot + widths[end]) \
                    + 8 * (end - start + 1):
                break
            wmax = w2
            tot += widths[end]
            end += 1
        band = levels[start:end]
        n_slots = max(max(g[0]) for g in slot_groups) + 1
        packed = [None] * n_slots
        for slots, pads in slot_groups:
            gw = max(len(lv[slots[0]]) for lv in band)
            for slot, pad in zip(slots, pads):
                arrs = []
                for lv in band:
                    a = np.asarray(lv[slot], np.int32)
                    if len(a) < gw:
                        a = np.concatenate(
                            [a, np.full(gw - len(a), int(pad), np.int32)])
                    arrs.append(a)
                packed[slot] = np.stack(arrs)
        runs.append(tuple(packed))
        start = end
    return tuple(runs)


def _structural_matching(n, rows, cols, weights=None):
    """Kuhn's bipartite matching row->col so the permuted diagonal is
    structurally nonzero (static replacement for partial pivoting; KLU uses
    BTF+numeric pivoting, MNA + a weight-guided matching makes static
    pivoting sufficient).  ``weights``: representative |A| entries — rows
    greedily take their largest entry first, and entries below 1e-12 of
    their row max are used only as a last resort.

    With weights, an MC64-style max-product assignment (maximize
    Σ log|a_{i,σ(i)}| — the HSL MC64 objective Duff & Koster 2001, via
    scipy's sparse Jonker-Volgenant) replaces the greedy matching: static
    pivoting's element growth is governed by how large the matched
    diagonal is, and greedy-by-row leaves late rows stuck with tiny
    pivots (observed: BSIM4 DFF-chain Jacobians factor to NaN/1e16
    residuals under greedy, converge under max-product)."""
    if weights is not None:
        try:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import (
                min_weight_full_bipartite_matching)
            w = np.maximum(np.asarray(weights, np.float64), 1e-300)
            rowmax = np.zeros(n)
            np.maximum.at(rowmax, np.asarray(rows, np.int64), w)
            cost = 1.0 + np.log(np.maximum(rowmax[rows], 1e-300) / w)
            A = csr_matrix((cost, (rows, cols)), shape=(n, n))
            rr, cc = min_weight_full_bipartite_matching(A)
            match_row = np.full(n, -1, np.int64)
            match_row[rr] = cc
            if (match_row >= 0).all():
                return match_row
        except Exception:
            pass     # structurally-deficient or scipy absent → greedy path
    adj = [[] for _ in range(n)]
    went = [[] for _ in range(n)]
    for t, (r, c) in enumerate(zip(rows, cols)):
        adj[int(r)].append(int(c))
        went[int(r)].append(1.0 if weights is None else float(weights[t]))
    for r in range(n):
        order = np.argsort(went[r])[::-1]
        rowmax = went[r][order[0]] if len(order) else 0.0
        # deprioritize structurally-present-but-numerically-tiny entries
        good = [adj[r][i] for i in order
                if went[r][i] > 1e-12 * rowmax]
        rest = [adj[r][i] for i in order
                if went[r][i] <= 1e-12 * rowmax]
        adj[r] = good + rest
    match_col = np.full(n, -1, np.int64)   # col -> row
    match_row = np.full(n, -1, np.int64)   # row -> col
    # greedy pass: each row takes its best unclaimed column
    for r in range(n):
        for c in adj[r][:1]:
            if match_col[c] < 0:
                match_row[r] = c
                match_col[c] = r

    def try_augment(r, seen):
        for c in adj[r]:
            if seen[c]:
                continue
            seen[c] = True
            if match_col[c] < 0 or try_augment(match_col[c], seen):
                match_col[c] = r
                match_row[r] = c
                return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 2 * n + 100))
    try:
        for r in range(n):
            if match_row[r] < 0:
                if not try_augment(r, np.zeros(n, bool)):
                    raise ValueError(
                        f"structurally singular matrix: row {r} cannot be "
                        "matched to any column")
    finally:
        sys.setrecursionlimit(old)
    return match_row  # row r of A goes with col match_row[r]


def build_plan(n, rows, cols, perm=None, weights=None,
               order="auto") -> SparsePlan:
    """Symbolic factorization. ``rows``/``cols``: the exact structural
    pattern of A (duplicates allowed).  Include diagonal entries only where
    they are numerically present (gmin shunts / integrator terms) — a forced
    full diagonal would let the pivot matching sit on numerically-zero
    positions (V-source branch rows).  ``weights``: representative |A[r,c]|
    per input entry to guide the static pivot matching.

    ``order``: fill-reducing ordering — "md" (minimum degree: best fill,
    long elimination path; the CPU/KLU-style choice), "nd" (nested
    dissection: O(log n)-depth elimination tree so the leveled on-device
    sweeps dispatch far fewer sequential steps; the TPU choice), or "auto"
    (nd when the default JAX backend is a TPU, else md)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    key0 = rows * n + cols
    key, first, inv = np.unique(key0, return_index=True,
                                return_inverse=True)
    if weights is not None:
        w = np.zeros(len(key), np.float64)
        np.add.at(w, inv, np.abs(np.asarray(weights, np.float64)))
        weights = w
    rows, cols = rows[first], cols[first]

    # structural pivoting: row r supplies column match[r]; we want
    # M[i,j] = A[rperm[i], cperm[j]] with M diag nonzero.
    match_row = _structural_matching(n, rows, cols, weights)
    # choose cperm = identity on matched labels: permuted column j is A's
    # column j; permuted row holding its pivot is the row matched to col j.
    row_of_col = np.empty(n, np.int64)
    row_of_col[match_row] = np.arange(n)

    # pattern in "matched" space: Mrow i = A row row_of_col[i] → M[i, j]
    inv_row = np.empty(n, np.int64)
    inv_row[row_of_col] = np.arange(n)
    m_rows = inv_row[rows]
    m_cols = cols

    # fill-reducing ordering on symmetrized matched pattern
    if perm is None:
        from cedarsim_tpu_torch.ops.sparse import md_order, nd_order
        sym_r = np.concatenate([m_rows, m_cols])
        sym_c = np.concatenate([m_cols, m_rows])
        kk = sym_r * n + sym_c
        kk, fi = np.unique(kk, return_index=True)
        if order == "auto":
            import os
            env = os.environ.get("CEDARSIM_SPARSE_ORDER")
            if env in ("md", "nd"):
                order = env
            else:
                # md everywhere: nd's O(log n) level count does NOT pay on
                # the real chip — the packed fori_loop already amortizes
                # level dispatch on-device, so per-solve cost follows FILL,
                # and nd's ~1.26x fill premium loses (measured 2026-08-19,
                # 1992 unknowns, TPU v5e: md 35.9 ms/solve at 380 levels vs
                # nd 52.7 ms at 46 levels; benchmarks/compile_latency.md).
                # nd stays available for genuinely dispatch-bound setups.
                order = "md"
        fn = nd_order if order == "nd" else md_order
        perm = fn(n, sym_r[fi].astype(np.int32),
                  sym_c[fi].astype(np.int32))
    perm = np.asarray(perm, np.int64)
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)

    # final permutations back to A indices
    rperm = row_of_col[perm]           # A-row supplying permuted row i
    cperm = perm.copy()                # A-col supplying permuted col j

    p_rows = iperm[m_rows]
    p_cols = iperm[m_cols]

    # symbolic LU with fill on the permuted pattern (set-based left-looking)
    up_cols = [set() for _ in range(n)]   # U row k: columns j > k
    lo_rows = [set() for _ in range(n)]   # L col k: rows i > k
    diag_ok = np.zeros(n, bool)
    for r, c in zip(p_rows, p_cols):
        if r < c:
            up_cols[r].add(int(c))
        elif r > c:
            lo_rows[c].add(int(r))
        else:
            diag_ok[r] = True
    assert diag_ok.all(), "matching failed to produce a zero-free diagonal"
    for k in range(n):
        li = sorted(lo_rows[k])
        ui = sorted(up_cols[k])
        for i in li:
            for j in ui:
                if i == j:
                    continue
                if i > j:
                    lo_rows[j].add(i)
                else:
                    up_cols[i].add(j)

    # final filled pattern
    fr, fc = [], []
    for k in range(n):
        fr.append(k); fc.append(k)
        for j in up_cols[k]:
            fr.append(k); fc.append(j)
        for i in lo_rows[k]:
            fr.append(i); fc.append(k)
    fr = np.asarray(fr, np.int64)
    fc = np.asarray(fc, np.int64)
    fkey = fr * n + fc
    order = np.argsort(fkey)
    fr, fc, fkey = fr[order], fc[order], fkey[order]
    nnz_f = len(fr)
    pos_of = {int(k): i for i, k in enumerate(fkey)}

    # levels: pivot k's stage comes after every pivot j<k with L[k,j]≠0 or
    # U[j,k]≠0; compute depths from the filled pattern
    level = np.zeros(n, np.int64)
    for idx in range(nnz_f):
        i, j = int(fr[idx]), int(fc[idx])
        if i > j:        # L[i,j]: pivot j updates row i → stage i after j
            if level[j] + 1 > level[i]:
                level[i] = level[j] + 1
        elif i < j:      # U[i,j]: pivot i updates col j → stage j after i
            if level[i] + 1 > level[j]:
                level[j] = level[i] + 1
    # NOTE: single forward sweep is valid because updates only flow from
    # lower-numbered pivots to higher ones, and the pattern scan above visits
    # (i, j) in row-major order... which does NOT guarantee topological
    # order for L entries (i > j seen when scanning row i: level[j] is final
    # since j < i only for L; for U entries (i < j), level[i] final since
    # i < j).  Row-major scan visits row i after all rows < i, so for L[i,j]
    # (j < i) level[j] is final, and for U[i,j] (i < j) level[i] is final
    # within row i's scan — both final. OK.

    n_levels = int(level.max()) + 1 if n else 0

    # per-level div/update schedules
    div_dst, div_piv, upd_dst, upd_l, upd_u = [], [], [], [], []
    for lv in range(n_levels):
        dd, dp, ud, ul, uu = [], [], [], [], []
        for k in np.nonzero(level == lv)[0]:
            k = int(k)
            kpiv = pos_of[k * n + k]
            li = sorted(lo_rows[k])
            ui = sorted(up_cols[k])
            for i in li:
                dd.append(pos_of[i * n + k])
                dp.append(kpiv)
            for i in li:
                pl = pos_of[i * n + k]
                for j in ui:
                    ud.append(pos_of[i * n + j])
                    ul.append(pl)
                    uu.append(pos_of[k * n + j])
        div_dst.append(np.asarray(dd, np.int32))
        div_piv.append(np.asarray(dp, np.int32))
        upd_dst.append(np.asarray(ud, np.int32))
        upd_l.append(np.asarray(ul, np.int32))
        upd_u.append(np.asarray(uu, np.int32))

    # substitution levels (forward: y[i] -= L[i,j] y[j]; depth over L-dag)
    flev = np.zeros(n, np.int64)
    for idx in range(nnz_f):
        i, j = int(fr[idx]), int(fc[idx])
        if i > j and flev[j] + 1 > flev[i]:
            flev[i] = flev[j] + 1
    f_lev = []
    for lv in range(1, int(flev.max()) + 1 if n else 0):
        rows_l, cols_l, pos_l = [], [], []
        for idx in range(nnz_f):
            i, j = int(fr[idx]), int(fc[idx])
            if i > j and flev[i] == lv:
                rows_l.append(i); cols_l.append(j); pos_l.append(idx)
        f_lev.append((np.asarray(rows_l, np.int32),
                      np.asarray(cols_l, np.int32),
                      np.asarray(pos_l, np.int32)))
    # backward-substitution levels: x[i] needs x[j] for U[i,j]≠0 (j > i) —
    # depth over the U-dag, computed in reverse row order (topological)
    blev = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        for j in sorted(up_cols[i]):
            if blev[j] + 1 > blev[i]:
                blev[i] = blev[j] + 1
    b_lev = []
    maxb = int(blev.max()) if n else 0
    for lv in range(0, maxb + 1):
        rows_l, cols_l, pos_l = [], [], []
        for i in np.nonzero(blev == lv)[0]:
            i = int(i)
            for j in sorted(up_cols[i]):
                rows_l.append(i); cols_l.append(j)
                pos_l.append(pos_of[i * n + j])
        b_lev.append((np.asarray(rows_l, np.int32),
                      np.asarray(cols_l, np.int32),
                      np.asarray(pos_l, np.int32),
                      np.asarray([int(i) for i in np.nonzero(blev == lv)[0]],
                                 np.int32)))

    # input-pattern positions in the filled vector (for assembly)
    p_in_r = iperm[inv_row[rows]]
    p_in_c = iperm[cols]
    in_pos = np.asarray([pos_of[int(r) * n + int(c)]
                         for r, c in zip(p_in_r, p_in_c)], np.int32)
    diag_pos = np.asarray([pos_of[k * n + k] for k in range(n)], np.int32)

    # A-space helpers for solver-side matrix edits:
    # position of A[i,i] (−1 where structurally absent) and the A-row of
    # every stored position (for row masking, e.g. .ic row overwrites)
    irperm = np.empty(n, np.int64)
    irperm[rperm] = np.arange(n)
    icperm = np.empty(n, np.int64)
    icperm[cperm] = np.arange(n)
    a_diag_pos = np.full(n, -1, np.int64)
    for i in range(n):
        kk = int(irperm[i]) * n + int(icperm[i])
        if kk in pos_of:
            a_diag_pos[i] = pos_of[kk]
    pos_arow = rperm[fr]

    # packed fori_loop schedules for deep plans (program size O(#runs))
    fact_runs = fwd_runs = bwd_runs = ()
    if n_levels > UNROLL_LEVELS:
        pad_piv = int(diag_pos[0])
        fact_runs = _pack_runs(
            [(div_dst[lv], div_piv[lv], upd_dst[lv], upd_l[lv], upd_u[lv])
             for lv in range(n_levels)],
            [((0, 1), (nnz_f, pad_piv)),
             ((2, 3, 4), (nnz_f, nnz_f, nnz_f))])
        fwd_runs = _pack_runs(
            list(f_lev), [((0, 1, 2), (n, n, nnz_f))])
        bwd_runs = _pack_runs(
            [(r, c, p, d, diag_pos[d]) for r, c, p, d in b_lev],
            [((0, 1, 2), (n, n, nnz_f)), ((3, 4), (n, pad_piv))])

    return SparsePlan(
        n=n, nnz=len(rows), nnz_f=nnz_f,
        in_pos=in_pos, in_rows=rows.astype(np.int32),
        in_cols=cols.astype(np.int32),
        rperm=rperm.astype(np.int32), cperm=cperm.astype(np.int32),
        diag_pos=diag_pos,
        a_diag_pos=a_diag_pos.astype(np.int32),
        pos_arow=np.asarray(pos_arow, np.int32),
        pos_acol=np.asarray(cperm[fc], np.int32),
        div_dst=tuple(div_dst), div_piv=tuple(div_piv),
        upd_dst=tuple(upd_dst), upd_l=tuple(upd_l), upd_u=tuple(upd_u),
        f_lev=tuple(f_lev), b_lev=tuple(b_lev), n_levels=n_levels,
        fact_runs=fact_runs, fwd_runs=fwd_runs, bwd_runs=bwd_runs)



# ------------------------------------------------------ level schedules

def _grouped(dst, *terms):
    """A term list grouped by destination: the distinct destinations
    (ascending), each one's term offsets [m + 1] and the term arrays, each
    destination's terms in list order (a stable sort)."""
    dst = np.asarray(dst, np.int64)
    order = np.argsort(dst, kind="stable")
    d = dst[order]
    uniq, start = np.unique(d, return_index=True)
    off = np.append(start, len(d)).astype(np.int64)
    return uniq, off, [np.asarray(t, np.int64)[order] for t in terms]


def _padded(off, pads, *terms):
    """Each destination's terms (offsets ``off``) padded to the level's
    k_max with ``pads`` (one per term array): a [k_max, m] array, flat
    (term j of every destination, then term j + 1), then m and k_max."""
    m = len(off) - 1
    cnt = np.diff(off)
    k = int(cnt.max()) if m else 0
    out = []
    for t, pad in zip(terms, pads):
        a = np.full((k, m), pad, np.int64)
        for j in range(k):
            has = cnt > j
            a[j, has] = t[off[:-1][has] + j]
        out.append(a.reshape(-1))
    return (*out, m, k)


def _backward_rows(rows_l, cols_l, pos_l, diag_i):
    """A backward level's rows (``diag_i``: every row of the level, with or
    without terms), their term offsets and the (pos, col) terms."""
    uniq, off, (pos, col) = _grouped(rows_l, pos_l, cols_l)
    rows = np.asarray(diag_i, np.int64)
    if not np.isin(uniq, rows).all():
        raise AssertionError("a backward term outside its level's rows")
    cnt = np.zeros(len(rows), np.int64)
    cnt[np.searchsorted(rows, uniq)] = np.diff(off)
    return rows, np.concatenate([[0], np.cumsum(cnt)]), pos, col


#: the kernels' int32 schedule arrays, in their C argument order
FACTOR_ARRAYS = ("div_off", "div_dst", "div_piv", "piv_off", "piv",
                 "dst_off", "dst", "term_off", "term_l", "term_u",
                 "lev_term", "diag")
SOLVE_ARRAYS = ("rperm", "cperm", "fw_off", "fw_row", "fw_term_off",
                "fw_pos", "fw_col", "fw_lev_term", "bw_off", "bw_row",
                "bw_diag", "bw_term_off", "bw_pos", "bw_col", "bw_lev_term")
#: threads per block of S1 and S2 (``kThreads`` in ``csrc/sparse_lu.cu``):
#: a level's destinations are dealt to them round-robin
THREADS = 512


def _longest_first(off):
    """How a level's destinations (their term offsets ``off``) are dealt:
    longest first (ties in their order), so that round-robin gives the
    busiest thread at most the longest destination plus the level's terms
    over the threads.  Returns the order of the destinations, their new
    term offsets (from 0) and the gather of their terms, each destination's
    still in list order."""
    off = np.asarray(off, np.int64)
    cnt = np.diff(off)
    order = np.argsort(-cnt, kind="stable")
    lens = cnt[order]
    new = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = (np.arange(new[-1]) - np.repeat(new[:-1], lens)
           + np.repeat(off[:-1][order], lens))
    return order, new, idx


def build_schedule(plan: SparsePlan):
    """A plan's level schedule on the host (numpy, once per plan): the
    kernels' arrays (``FACTOR_ARRAYS``, ``SOLVE_ARRAYS``) and the plain
    versions' padded levels.  Each level groups its terms by destination
    (:func:`_grouped`): the factor's updates by the position they write,
    the forward sweep's by row, the backward sweep's by row over every row
    of the level.  The kernels take each level's destinations longest
    first (:func:`_longest_first`) and each level's first term
    (``lev_term``, ``fw_lev_term``, ``bw_lev_term``: the products of a
    level sit at their term index minus it); the plain versions take them
    in ascending order.  The order of destinations changes no bit: each
    destination's terms keep their order, and destinations are disjoint."""
    nnz_f, n = plan.nnz_f, plan.n
    k = {name: [] for name in FACTOR_ARRAYS + SOLVE_ARRAYS}
    for name in ("div_off", "piv_off", "dst_off", "term_off", "lev_term",
                 "fw_off", "fw_term_off", "fw_lev_term", "bw_off",
                 "bw_term_off", "bw_lev_term"):
        k[name].append(0)

    def level(names, off, dests, terms):
        # one level's destinations (longest first), their term offsets,
        # where the level's terms end, and the arrays
        off_name, term_off_name, lev_name = names
        order, off, idx = _longest_first(off)
        k[off_name].append(k[off_name][-1] + len(order))
        k[term_off_name].extend((k[term_off_name][-1] + off[1:]).tolist())
        k[lev_name].append(k[term_off_name][-1])
        for name, a in dests.items():
            k[name].extend(np.asarray(a)[order].tolist())
        for name, a in terms.items():
            k[name].extend(np.asarray(a)[idx].tolist())

    fact, fwd, bwd = [], [], []
    for lv in range(plan.n_levels):
        dd = np.asarray(plan.div_dst[lv], np.int64)
        dp = np.asarray(plan.div_piv[lv], np.int64)
        piv = np.unique(dp)
        dst, off, (ul, uu) = _grouped(plan.upd_dst[lv], plan.upd_l[lv],
                                      plan.upd_u[lv])
        k["div_dst"].extend(dd.tolist())
        k["div_piv"].extend(dp.tolist())
        k["div_off"].append(len(k["div_dst"]))
        k["piv"].extend(piv.tolist())
        k["piv_off"].append(len(k["piv"]))
        level(("dst_off", "term_off", "lev_term"), off, dict(dst=dst),
              dict(term_l=ul, term_u=uu))
        fact.append((piv, dd, dp, dst,
                     *_padded(off, (nnz_f, nnz_f), ul, uu)))
    for rows_l, cols_l, pos_l in plan.f_lev:
        rows, off, (pos, col) = _grouped(rows_l, pos_l, cols_l)
        level(("fw_off", "fw_term_off", "fw_lev_term"), off,
              dict(fw_row=rows), dict(fw_pos=pos, fw_col=col))
        fwd.append((rows, *_padded(off, (nnz_f, n), pos, col)))
    for rows_l, cols_l, pos_l, diag_i in plan.b_lev:
        rows, off, pos, col = _backward_rows(rows_l, cols_l, pos_l, diag_i)
        diag = np.asarray(plan.diag_pos, np.int64)[rows]
        level(("bw_off", "bw_term_off", "bw_lev_term"), off,
              dict(bw_row=rows, bw_diag=diag), dict(bw_pos=pos, bw_col=col))
        bwd.append((rows, diag, *_padded(off, (nnz_f, n), pos, col)))
    k["diag"] = plan.diag_pos
    k["rperm"] = plan.rperm
    k["cperm"] = plan.cperm
    kernel = {name: np.asarray(v, np.int64).astype(np.int32)
              for name, v in k.items()}
    return kernel, fact, fwd, bwd


def widths(kernel):
    """The most terms of any factor level and of any solve level (the
    products a level forms at once) of a schedule's kernel arrays."""
    def most(*names):
        return max([int(np.diff(kernel[a]).max(initial=0)) for a in names])
    return most("lev_term"), most("fw_lev_term", "bw_lev_term")


def smem_bytes(plan: SparsePlan, kernel):
    """The shared memory (bytes per block) S1 and S2 take in their shared
    regimes: S1 a lane's values, the products of its widest level (float64)
    and four level offsets (int32, levels + 1 each); S2 a lane's values,
    its unknowns, the products of its widest level and two level offsets of
    each sweep (``csrc/sparse_lu.cu``)."""
    wf, ws = widths(kernel)
    n_f, n_b = len(kernel["fw_off"]) - 1, len(kernel["bw_off"]) - 1
    return (8 * (plan.nnz_f + wf) + 16 * (plan.n_levels + 1),
            8 * (plan.nnz_f + plan.n + ws) + 8 * (n_f + n_b + 2))


@dataclasses.dataclass
class Schedule:
    """A plan's level schedule on one device: the kernels' int32 arrays
    (``kernel``), the plain versions' int64 gathers per level (``fact``:
    (pivots, div_dst, div_piv, destinations, l, u, m, k); ``fwd``: (rows,
    pos, col, m, k); ``bwd``: (rows, diagonal positions, pos, col, m, k);
    the terms of the m destinations padded to k each with the trash slots
    ``nnz_f`` and ``n``, :func:`_padded`), each stored position's A-space
    row and column (``matvec``), the widest factor and solve levels
    (:func:`widths`) and S1's and S2's shared memory (:func:`smem_bytes`)."""
    kernel: dict
    fact: list
    fwd: list
    bwd: list
    rperm: torch.Tensor
    cperm: torch.Tensor
    diag_pos: torch.Tensor
    pos_arow: torch.Tensor
    pos_acol: torch.Tensor
    factor_width: int
    solve_width: int
    factor_smem: int
    solve_smem: int


#: each plan's host schedule and its copies per device (plans are keyed by
#: identity and dropped with their plan)
_SCHEDULES = weakref.WeakKeyDictionary()


def schedule(plan: SparsePlan, device) -> Schedule:
    """``plan``'s schedule with its arrays on ``device``, made once per
    plan and device."""
    device = torch.device(device)
    per_plan = _SCHEDULES.setdefault(plan, {})
    if "host" not in per_plan:
        per_plan["host"] = build_schedule(plan)
    key = str(device)
    if key not in per_plan:
        kernel, fact, fwd, bwd = per_plan["host"]

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        def level(lv):
            return tuple(a if isinstance(a, int) else t(a) for a in lv)
        wf, ws = widths(kernel)
        smem_f, smem_s = smem_bytes(plan, kernel)
        per_plan[key] = Schedule(
            kernel={name: t(a, torch.int32) for name, a in kernel.items()},
            fact=[level(lv) for lv in fact],
            fwd=[level(lv) for lv in fwd],
            bwd=[level(lv) for lv in bwd],
            rperm=t(plan.rperm), cperm=t(plan.cperm),
            diag_pos=t(plan.diag_pos), pos_arow=t(plan.pos_arow),
            pos_acol=t(plan.pos_acol), factor_width=wf, solve_width=ws,
            factor_smem=smem_f, solve_smem=smem_s)
    return per_plan[key]


# ------------------------------------------------------------- numerics

def _lanes(v):
    """``v`` with a lane axis, and whether it came without one."""
    return (v[None], True) if v.dim() == 1 else (v, False)


def vals_from_dense(plan: SparsePlan, A):
    """The filled-pattern values [..., nnz_f] of dense A [..., n, n]
    (testing and small systems; the circuit assembles into the pattern
    directly)."""
    dev = A.device
    pos = torch.as_tensor(plan.in_pos, dtype=torch.int64, device=dev)
    r = torch.as_tensor(plan.in_rows, dtype=torch.int64, device=dev)
    c = torch.as_tensor(plan.in_cols, dtype=torch.int64, device=dev)
    v = torch.zeros(A.shape[:-2] + (plan.nnz_f,), dtype=A.dtype, device=dev)
    v[..., pos] += A[..., r, c]
    return v


def matvec(plan: SparsePlan, vals, x):
    """A·x from unfactored filled values (fill positions hold 0): vals [L,
    nnz_f] and x [L, n] (or one system each) → [L, n], each row summed in
    position order (``core/compile.py::_scatter_add``)."""
    from cedarsim_tpu_torch.core.compile import _scatter_add
    vals, single = _lanes(vals)
    x = x[None] if x.dim() == 1 else x
    L, n, dev = vals.shape[0], plan.n, vals.device
    sch = schedule(plan, dev)
    idx = sch.pos_arow
    if L > 1:
        idx = (torch.arange(L, device=dev)[:, None] * n + idx).reshape(-1)
    out = torch.zeros(L * n, dtype=vals.dtype, device=dev)
    _scatter_add(out, idx,
                 (vals * x.index_select(1, sch.pos_acol)).reshape(-1))
    out = out.view(L, n)
    return out[0] if single else out


def _boosted(p, tau):
    # τ as a tensor of p's dtype: a where() of two Python floats would be
    # the default dtype, float32
    t = p.new_full((), tau)
    return torch.where(p.abs() < t, torch.where(p < 0, -t, t), p)


def _terms(prod, acc, m, k, add=False):
    """``acc`` minus (or plus) each of the k term columns of ``prod`` [L,
    k·m] (k-major), in order."""
    for j in range(k):
        t = prod.narrow(1, j * m, m)
        acc = acc + t if add else acc - t
    return acc


def factor_plain(plan: SparsePlan, vals, boost: float = 0.0):
    """Plain PyTorch leveled factor of vals [L, nnz_f] float64, in S1's
    order (see the module docstring); ``boost`` τ: a pivot with |p| < τ
    becomes ±τ (0 boosts none)."""
    vals, single = _lanes(vals)
    sch = schedule(plan, vals.device)
    tau = float(boost)
    L = vals.shape[0]
    v = torch.cat([vals, torch.zeros(L, 1, dtype=vals.dtype,
                                     device=vals.device)], 1)
    for piv, dd, dp, dst, ul, uu, m, k in sch.fact:
        if dd.numel():
            v.index_copy_(1, dd, v.index_select(1, dd) / _boosted(
                v.index_select(1, dp), tau))
            v.index_copy_(1, piv, _boosted(v.index_select(1, piv), tau))
        if m:
            prod = v.index_select(1, ul) * v.index_select(1, uu)
            v.index_copy_(1, dst, _terms(prod, v.index_select(1, dst), m, k))
    d = sch.diag_pos
    v.index_copy_(1, d, _boosted(v.index_select(1, d), tau))
    out = v[:, :-1]
    return out[0] if single else out


def solve_factored_plain(plan: SparsePlan, f, b):
    """Plain PyTorch leveled solve of A x = b from factored values f [L,
    nnz_f] (unit-diagonal L) and b [L, n] float64, in S2's order."""
    f, single = _lanes(f)
    b = b[None] if b.dim() == 1 else b
    sch = schedule(plan, f.device)
    L, n = f.shape[0], plan.n
    z = torch.zeros(L, 1, dtype=f.dtype, device=f.device)
    fe = torch.cat([f, z], 1)
    y = torch.cat([b.index_select(1, sch.rperm), z], 1)
    for rows, pos, col, m, k in sch.fwd:
        prod = fe.index_select(1, pos) * y.index_select(1, col)
        y.index_copy_(1, rows, _terms(prod, y.index_select(1, rows), m, k))
    for rows, diag, pos, col, m, k in sch.bwd:
        acc = torch.zeros(L, m, dtype=f.dtype, device=f.device)
        if k:
            prod = fe.index_select(1, pos) * y.index_select(1, col)
            acc = _terms(prod, acc, m, k, add=True)
        y.index_copy_(1, rows, (y.index_select(1, rows) - acc)
                      / fe.index_select(1, diag))
    out = torch.empty(L, n, dtype=f.dtype, device=f.device)
    out[:, sch.cperm] = y[:, :n]
    return out[0] if single else out


# ----------------------------------------------------------- the kernels

SOURCE = os.path.join(cuda_lib.CSRC, "sparse_lu.cu")
#: ``--fmad=false``: every product and difference rounds on its own, as in
#: the plain versions (PyTorch's separate multiply and subtract)
NVCC_FLAGS = cuda_lib.NVCC_FLAGS + ("--fmad=false",)

_LIB = {}


def build():
    """Compile (if not built yet for this source) and load S1 and S2: a
    dict with ``lib``, ``path``, nvcc's ``seconds`` (0.0 when it was
    already built) and its ``log``."""
    if "lib" in _LIB:
        return _LIB
    b = cuda_lib.build_library("sparse_lu", SOURCE, NVCC_FLAGS)
    lib = b["lib"]
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sparse_factor_f64.argtypes = ([p, p, p, i, i, i, i, i, d]
                                      + [p] * len(FACTOR_ARRAYS) + [i, p])
    lib.sparse_factor_f64.restype = i
    lib.sparse_solve_f64.argtypes = ([p, p, p, p, i, i, i, i, i, i]
                                     + [p] * len(SOLVE_ARRAYS) + [i, p])
    lib.sparse_solve_f64.restype = i
    if lib.sparse_lu_threads() != THREADS:
        raise RuntimeError(f"sparse_lu: the kernels run "
                           f"{lib.sparse_lu_threads()} threads a block, "
                           f"the schedule is dealt for {THREADS}")
    _LIB.update(b)
    return _LIB


def _check(what, t, shape):
    if t.dtype != torch.float64:
        raise TypeError(f"{what}: expected float64, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _ptrs(arrays, names):
    return [arrays[k].data_ptr() if arrays[k].numel() else None
            for k in names]


def shared_regime(nbytes, device) -> bool:
    """Whether what S1 or S2 keeps in shared memory (``nbytes`` per block,
    ``Schedule.factor_smem`` or ``solve_smem``) fits a block's opt-in
    shared memory on ``device``; else the same kernel runs on device
    memory."""
    return nbytes <= cuda_lib.smem_per_block(torch.device(device))


def _device_of(what, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def factor(plan: SparsePlan, vals, boost: float = 0.0):
    """Leveled numeric LU of vals [L, nnz_f] (or [nnz_f]) float64 in the
    plan's filled pattern, pivots with |p| < ``boost`` replaced by ±boost
    (GESP: SuperLU-DIST's static-pivoting recipe; the boosted pivot is
    written back, so factor and solve agree, and refinement recovers the
    perturbed digits).  CPU tensors take :func:`factor_plain`; CUDA tensors
    launch S1 (its regime from :func:`shared_regime`) or raise."""
    if _device_of("factor", vals) == "cpu":
        return factor_plain(plan, vals, boost)
    vals, single = _lanes(vals)
    L = vals.shape[0]
    _check("vals", vals, (L, plan.nnz_f))
    vals = vals.contiguous()
    out = torch.empty_like(vals)
    if L and plan.nnz_f:
        sch = schedule(plan, vals.device)
        shared = shared_regime(sch.factor_smem, vals.device)
        work = out if shared else vals.new_empty(
            (L, max(sch.factor_width, 1)))
        err = build()["lib"].sparse_factor_f64(
            vals.data_ptr(), out.data_ptr(), work.data_ptr(), L, plan.nnz_f,
            plan.n, plan.n_levels, sch.factor_width, float(boost),
            *_ptrs(sch.kernel, FACTOR_ARRAYS), int(shared),
            cuda_lib.current_stream(vals.device))
        cuda_lib.raise_on(err, "sparse_factor_f64")
        factor.launches += 1
    return out[0] if single else out


factor.launches = 0


def solve_factored(plan: SparsePlan, f, b):
    """Solve A x = b given factored values f [L, nnz_f] (or [nnz_f]) and b
    [L, n] float64 (L unit-diagonal).  CPU tensors take
    :func:`solve_factored_plain`; CUDA tensors launch S2 (its regime from
    :func:`shared_regime`) or raise."""
    if _device_of("solve_factored", f) == "cpu":
        return solve_factored_plain(plan, f, b)
    f, single = _lanes(f)
    b = b[None] if b.dim() == 1 else b
    L, n = f.shape[0], plan.n
    _check("f", f, (L, plan.nnz_f))
    _check("b", b, (L, n))
    if b.device != f.device:
        raise ValueError(f"solve_factored: f on {f.device}, b on "
                         f"{b.device}")
    f, b = f.contiguous(), b.contiguous()
    out = torch.empty_like(b)
    if L and n:
        sch = schedule(plan, f.device)
        shared = shared_regime(sch.solve_smem, f.device)
        work = out if shared else b.new_empty((L, n + sch.solve_width))
        err = build()["lib"].sparse_solve_f64(
            f.data_ptr(), b.data_ptr(), out.data_ptr(), work.data_ptr(), L,
            plan.nnz_f, n, len(plan.f_lev), len(plan.b_lev),
            sch.solve_width, *_ptrs(sch.kernel, SOLVE_ARRAYS), int(shared),
            cuda_lib.current_stream(f.device))
        cuda_lib.raise_on(err, "sparse_solve_f64")
        solve_factored.launches += 1
    return out[0] if single else out


solve_factored.launches = 0


def solve(plan: SparsePlan, vals, b, refine: int = 0, matvec=None,
          boost: float = 0.0):
    """Factor and solve.  ``refine`` iterative-refinement passes need a
    ``matvec(x)`` computing A·x (for instance from the unfactored vals);
    ``boost``: GESP's small-pivot threshold (see :func:`factor`)."""
    f = factor(plan, vals, boost=boost)
    x = solve_factored(plan, f, b)
    for _ in range(refine):
        r = b - matvec(x)
        x = x + solve_factored(plan, f, r)
    return x
