"""Pure-NumPy float64 oracles re-deriving the reference algorithms.

These are *independent re-implementations written in the reference's
per-element style* (HiCHap/matrixBuilding.py), used only to validate the
batched/jitted device ops at tight tolerances.  Slow on purpose — clarity over
speed.
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------- correction
def oracle_gap(M):
    """matrixBuilding.py:915-929."""
    N = M.shape[0]
    cover = np.array([1 - (row == 0).sum() / len(row) for row in M])
    thr = np.percentile(cover[np.nonzero(cover)], 25) if cover.any() else 0.0
    thr = min(thr, 0.2)
    return np.array([i for i in range(N) if cover[i] < thr], dtype=int)


def oracle_gap_lowres(M):
    """matrixBuilding.py:742-753."""
    return np.array(
        [i for i, row in enumerate(M) if 1 - (row == 0).sum() / len(row) < 0.1],
        dtype=int,
    )


def oracle_trans2symmetry(M, gap):
    """matrixBuilding.py:945-979 (loop order semantics preserved)."""
    if gap.size == 0:
        upper = np.triu(M) + np.tril(M, -1).T
        return np.triu(upper, 1).T + upper
    N = M.shape[0]
    out = np.zeros_like(M, dtype=float)
    nongap = np.array([i for i in range(N) if i not in set(gap)], dtype=int)
    for i in gap:
        for j in range(N):
            if i == j:
                out[i, j] = M[i, j]
            else:
                v = max(M[i, j], M[j, i])
                out[i, j] = v
                out[j, i] = v
    for i in nongap:
        for j in range(N):
            if i == j:
                out[i, j] = M[i, j]
            else:
                v = (M[i, j] + M[j, i]) / 2.0
                out[i, j] = v
                out[j, i] = v
    return out


def oracle_vc(X, alpha=2.0 / 3.0):
    """matrixBuilding.py:780-790."""
    x = np.array(X, float)
    s1 = np.sum(x, axis=1) ** alpha
    s1[s1 == 0] = 1
    s2 = np.sum(x, axis=0) ** alpha
    s2[s2 == 0] = 1
    return x / (s2[None, :] * s1[:, None])


def oracle_two_step(TM, MM, PM):
    """matrixBuilding.py:984-1023."""
    N = TM.shape[0]
    gm = oracle_gap(MM)
    gp = oracle_gap(PM)
    ngm = [i for i in range(N) if i not in set(gm)]
    ngp = [i for i in range(N) if i not in set(gp)]
    alpha = np.array(
        [(MM[i].sum() + PM[i].sum()) / (TM[i].sum() + 1) for i in range(N)]
    )
    nong = sorted(set(ngm) | set(ngp))
    alpha /= np.max(alpha[nong])
    alpha[alpha == 0] = 1
    thr = np.percentile(alpha[nong], 20)
    alpha[alpha < thr] = thr
    s_mm = MM / alpha[:, None]
    s_pm = PM / alpha[:, None]
    sym_mm = oracle_trans2symmetry(s_mm, gm)
    sym_pm = oracle_trans2symmetry(s_pm, gp)
    cor_mm = oracle_vc(sym_mm)
    cor_pm = oracle_vc(sym_pm)
    nor_mm = (MM.mean() / cor_mm.mean()) * cor_mm
    nor_pm = (PM.mean() / cor_pm.mean()) * cor_pm
    return nor_mm, nor_pm, gm, gp


def oracle_genomewide(bins_tra, bins_hap, T_M, H_M, chroms):
    """matrixBuilding.py:857-901."""
    beta = {}
    for chro in chroms:
        s, e = bins_tra[chro]
        tra = T_M[s : e + 1, s : e + 1]
        ms, me = bins_hap["M" + chro]
        ps, pe = bins_hap["P" + chro]
        mm = H_M[ms : me + 1, ms : me + 1]
        pp = H_M[ps : pe + 1, ps : pe + 1]
        gap = oracle_gap_lowres(tra)
        N = tra.shape[0]
        nongap = np.array([i for i in range(N) if i not in set(gap)], dtype=int)
        alpha = np.array(
            [(mm[i].sum() + pp[i].sum()) / (tra[i].sum() + 1) for i in range(N)]
        )
        alpha /= np.max(alpha[nongap])
        alpha[alpha == 0] = 1
        thr = np.percentile(alpha[nongap], 20)
        alpha[alpha < thr] = thr
        beta[chro] = alpha
    al = []
    for c in chroms:
        al.extend(beta[c])
    al = np.array(al + al)
    s = H_M / al[:, None]
    upper = np.triu(s) + np.tril(s, -1).T
    sym = np.triu(upper, 1).T + upper
    cor = oracle_vc(sym)
    return (H_M.mean() / cor.mean()) * cor


# ------------------------------------------------------------------- ICE
def oracle_ice(M, ignore_diags=1, mad_max=5, min_nnz=10, min_count=0,
               tol=1e-5, max_iters=200):
    """cooler-balance-style iterative correction, straight-line numpy."""
    M = np.array(M, dtype=float)
    N = M.shape[0]
    for d in range(ignore_diags):
        idx = np.arange(N - d)
        M[idx, idx + d] = 0
        M[idx + d, idx] = 0
    nnz = (M != 0).sum(axis=1)
    marg0 = M.sum(axis=1)
    keep = (nnz >= min_nnz) & (marg0 >= min_count)
    if mad_max > 0:
        sel = keep & (marg0 > 0)
        logm = np.log(marg0[sel])
        med = np.median(logm)
        dev = np.median(np.abs(logm - med))
        cutoff = np.exp(med - mad_max * dev)
        keep &= marg0 >= cutoff
    b = keep.astype(float)
    scale = 1.0
    var = np.inf
    it = 0
    while var >= tol and it < max_iters:
        marg = (M @ b) * b
        nz = marg != 0
        scale = marg[nz].mean() if nz.any() else 1.0
        var = marg[nz].var() if nz.any() else 0.0
        margn = marg / (scale if scale != 0 else 1.0)
        margn[margn == 0] = 1
        b = b / margn
        it += 1
    w = b / np.sqrt(scale if scale > 0 else 1.0)
    w[~(keep & (b != 0))] = np.nan
    return w


# ------------------------------------------------------------- synthetic
def synthetic_contact_matrix(rng, n, decay=1.0, gap_frac=0.1, scale=50.0):
    """A plausible symmetric integer Hi-C matrix with distance decay + gaps."""
    i = np.arange(n)
    d = np.abs(i[:, None] - i[None, :]).astype(float)
    lam = scale / (1.0 + d) ** decay
    M = rng.poisson(lam).astype(float)
    M = np.triu(M)
    M = M + np.triu(M, 1).T
    n_gap = int(gap_frac * n)
    if n_gap:
        gaps = rng.choice(n, size=n_gap, replace=False)
        M[gaps, :] = 0
        M[:, gaps] = 0
    return M


# ----------------------------------------------------------- compartments
def oracle_distance_decay(M, G):
    """StructureFind.py:201-271 re-derived in numpy: mean contact per
    distance, excluding gap columns ``G`` from numerator and pair count."""
    size = M.shape[0]
    b1, b2 = np.nonzero(M)
    IF = M[b1, b2]
    keep = ~np.isin(b2, G)
    w = np.hstack([IF[keep], [0]])
    d = np.hstack([np.abs(b2[keep] - b1[keep]), [size]])
    db = np.bincount(d, w)
    for i in range(size):
        if i == 0:
            gap_num = ((G >= 0) & (G <= size - 1)).sum()
            bn = size - gap_num
        else:
            gs = ((G >= 0) & (G <= size - 1 - i)).sum()
            ge = ((G >= i) & (G <= size - 1)).sum()
            bn = 2.0 * (size - i) - gs - ge
        if bn > 0:
            db[i] = db[i] / bn
    return db[:size]


def oracle_compartment(M, k=3):
    """Gap rule, O/E, correlation and top-``k`` PCs of one raw matrix in
    float64 (StructureFind.py:201-341): returns (gap bool [n], oe [n, n],
    cor [g, g], pcs [k, g]) with PCs as unit eigenvectors, largest first."""
    n = M.shape[0]
    gap = (M != 0).sum(0) / n <= 0.05
    decline = oracle_distance_decay(M, np.flatnonzero(gap)).copy()
    decline[decline == 0] = decline[np.nonzero(decline)].min()
    i = np.arange(n)
    oe = np.where(M != 0, M / decline[np.abs(i[:, None] - i[None, :])], 0.0)
    ng = np.flatnonzero(~gap)
    with np.errstate(divide="ignore", invalid="ignore"):
        cor = np.corrcoef(oe[:, ng], rowvar=False)
    cor[np.isnan(cor)] = 0
    cor[np.isinf(cor)] = 1
    w, V = np.linalg.eigh(cor)
    pcs = V[:, np.argsort(-w)[:k]].T
    return gap, oe, cor, pcs


# -------------------------------------------------------------------- HMM
def oracle_gmmhmm_loglik(seqs, A, pi, means, varis, weights):
    """log P(seqs) under a Gaussian-mixture HMM: the forward algorithm in
    log space, float64, one time step at a time."""
    def lse(x, axis=None):
        m = np.max(x, axis=axis, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        return np.squeeze(m, axis) + np.log(np.sum(np.exp(x - m), axis))

    with np.errstate(divide="ignore"):
        logA, logpi = np.log(A), np.log(pi)
    total = 0.0
    for x in seqs:
        x = np.asarray(x, float)
        lp = (-0.5 * (x[:, None, None] - means) ** 2 / varis
              - 0.5 * np.log(varis) - 0.5 * np.log(2 * np.pi)
              + np.log(weights))
        logb = lse(lp, axis=2)
        la = logpi + logb[0]
        for t in range(1, len(x)):
            la = lse(la[:, None] + logA, axis=0) + logb[t]
        total += lse(la)
    return float(total)
