"""Compartment calling (A/B) — PCA of the gap-filtered O/E correlation map.

Behavioral spec: HiCHap/StructureFind.py:197-703.  The heavy math (distance
decay, O/E, correlation, top-3 PCA) runs jitted on padded tensors; the small
PC-selection heuristics stay host-side numpy:

* unsupervised (traditional) selection ``select_pc_new``
  (StructureFind.py:374-423): pick the component maximizing
  within-A/B-minus-cross correlation contrast, then orient so the A side
  (higher intra-O/E mean) is positive;
* supervised (allelic) selection ``select_allelic_pc``
  (StructureFind.py:446-460): pick the component best correlated with the
  traditional PC of the same chromosome, warn when |r| < 0.7.

Uses RAW (unbalanced) matrices as the reference does (StructureFind.py:513).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..core.contacts import pad_to_shape
from ..io.cooler import CoolerReader
from ..ops.expected import (
    correlation_matrix,
    default_compartment_gap,
    distance_decay,
    oe_matrix,
    oe_matrix_sliding,
)
from ..ops.pca import pca_components
from ..utils.logging import get_logger

log = get_logger(__name__)


# ----------------------------------------------------------- pc selection
def select_pc_new(cor: np.ndarray, oe_ng: np.ndarray,
                  pcs: np.ndarray) -> np.ndarray:
    """Unsupervised PC pick + A/B orientation (StructureFind.py:374-423)."""

    def means_minus(matrix, pc, eps=1e-5):
        locis = np.arange(len(pc))
        mask_a = pc > 0
        mask_b = pc < 0
        la, lb = locis[mask_a], locis[mask_b]
        if la.size == 0 or lb.size == 0:
            return 0.0
        size_a = la.max() - la.min()
        size_b = lb.max() - lb.min()
        lens = max(la.max(), lb.max()) - min(la.min(), lb.min())
        ma = matrix[mask_a][:, mask_a]
        mb = matrix[mask_b][:, mask_b]
        mab = matrix[mask_a][:, mask_b]
        va = ma[(ma > -1) & (ma < 1 - eps)]
        vb = mb[(mb > -1) & (mb < 1 - eps)]
        vab = mab[(mab > -1) & (mab < 1)]
        vsame = np.hstack((va, vb))
        if (vab.shape[0] == 0 or vab.mean() == 0 or vab.mean() == -1
                or size_a <= lens / 2 or size_b <= lens / 2):
            return 0.0
        return vsame.mean() - vab.mean()

    def select_ab(oe, pc):
        mask_a = pc > 0
        mask_b = pc < 0
        sub_a = oe[mask_a][:, mask_a]
        sub_b = oe[mask_b][:, mask_b]
        va = sub_a[sub_a != 0]
        vb = sub_b[sub_b != 0]
        mean_a = va.mean() if va.size else np.nan
        mean_b = vb.mean() if vb.size else np.nan
        if np.isfinite(mean_a) and np.isfinite(mean_b) and mean_b > mean_a:
            return -pc
        return pc

    best, best_val = 0, 0.0
    for i in range(len(pcs)):
        v = means_minus(cor, pcs[i])
        if v > best_val:
            best_val = v
            best = i
    return select_ab(oe_ng, pcs[best].copy())


def select_pc_legacy(cor: np.ndarray, pcs: np.ndarray) -> np.ndarray:
    """Legacy unsupervised selector (StructureFind.py:345-372): pick the PC
    maximizing Σ|corr(pc, cor-row)|, signed by the un-absed sum.  The
    per-row np.corrcoef loop is evaluated as one centered matvec."""
    select_k, best, direction = 0, 0.0, 1
    rows_c = cor - cor.mean(axis=1, keepdims=True)   # PC-independent
    rows_ss = (rows_c ** 2).sum(axis=1)
    for i in range(len(pcs)):
        pc_c = pcs[i] - pcs[i].mean()
        num = rows_c @ pc_c
        den = np.sqrt(rows_ss * (pc_c ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            coef = num / den
        coef[np.isnan(coef)] = 0
        coef[np.isinf(coef)] = 1  # reference's inf guard
        if np.abs(coef).sum() > best:
            best = np.abs(coef).sum()
            select_k = i
            direction = -1 if coef.sum() < 0 else 1
    return pcs[select_k] * direction


def select_allelic_pc(pcs_full: np.ndarray, traditional_pc: np.ndarray,
                      eps: float = 0.7) -> np.ndarray:
    """Supervised pick by |corr| with the traditional PC (StructureFind.py:446).

    The chosen component is ORIENTED so it correlates positively with the
    traditional track — the reference returns it unflipped, leaving the
    allelic A/B sign to the PCA solver's arbitrary initialization, so a
    maternal track could be globally inverted relative to the traditional
    one it was matched against (DIVERGENCES.md D15)."""
    pcc = []
    for pc in pcs_full:
        r = np.corrcoef(pc, traditional_pc)[0][1]
        pcc.append(r if np.isfinite(r) else 0.0)
    if np.max(np.abs(pcc)) < eps:
        log.warning("PCC too low for this chromosome, check it if possible!")
    best = int(np.argmax(np.abs(pcc)))
    pc = pcs_full[best]
    return -pc if pcc[best] < 0 else pc


def load_pc_track(path: str) -> Dict[str, np.ndarray]:
    """Read a 2-column (chrom, value) PC text file (StructureFind.py:426-443)."""
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.setdefault(parts[0], []).append(float(parts[-1]))
    return {k: np.asarray(v) for k, v in out.items()}


# ------------------------------------------------- device-resident path
import functools as _functools

import jax as _jax


@_functools.partial(_jax.jit,
                    static_argnames=("step", "pca_method", "with_selection"))
def _compartment_fused(Mj, gapj, nj, ngj, gj, step: int, pca_method: str,
                       with_selection: bool = True):
    """One compiled graph per (shape, step): decay → O/E → correlation →
    PCA → signed PC selection, everything device-resident.

    ``with_selection=False`` drops the Select_PC_new stage (three full
    correlation-matrix reductions) — the allelic path discards it and
    re-selects host-side against the traditional track."""
    import jax.numpy as jnp

    from ..ops.pc_select import select_pc_new_device

    N = Mj.shape[0]
    decay = distance_decay(Mj, gapj, nj)
    if step > 0:
        oe = oe_matrix_sliding(Mj, decay, nj, step)
    else:
        oe = oe_matrix(Mj, decay, nj)
    col_valid = jnp.arange(N) < gj
    Xp = oe[:, ngj] * col_valid[None, :]
    cor = correlation_matrix(Xp, nj)
    cor = cor * (col_valid[:, None] & col_valid[None, :])
    pcs, _ = pca_components(cor, gj, k=3, method=pca_method)
    if not with_selection:
        return oe, cor, pcs, pcs[0]
    oe_ng = Xp[ngj, :] * col_valid[:, None]
    pc_signed = select_pc_new_device(cor, oe_ng, pcs, gj)
    return oe, cor, pcs, pc_signed


def single_chrom_compartment_device(reader: CoolerReader, chro: str,
                                    res: int, sliding: bool = False,
                                    pca_method: str = "subspace",
                                    want_matrices: bool = False):
    """Compartment math with all big intermediates staying on device.

    Host↔device transfers: COO pixels up, gap mask + non-gap index vector
    (tiny) round trip, and the 3 components down — the O(N²) O/E and
    correlation maps never cross the link unless ``want_matrices``.
    """
    import jax.numpy as jnp

    Mj, n = reader.matrix_device(chro)
    N = Mj.shape[0]
    nj = jnp.asarray(n)

    gapj = default_compartment_gap(Mj, nj)
    gap = np.asarray(gapj)[:n]

    nongap = np.flatnonzero(~gap)
    g = len(nongap)
    ng_pad = np.zeros(N, np.int32)
    ng_pad[:g] = nongap

    step = (600_000 // res // 2) if sliding else 0
    oe, cor, pcs, pc_signed = _compartment_fused(
        Mj, gapj, nj, jnp.asarray(ng_pad), jnp.asarray(g), step, pca_method)

    out = {
        "n": n,
        "gap": gap,
        "nongap": nongap,
        "pcs": np.asarray(pcs)[:, :g],
        "pc_signed": np.asarray(pc_signed)[:g],
    }
    if want_matrices:
        out["oe"] = np.asarray(oe)[:n, :n]
        out["cor"] = np.asarray(cor)[:g, :g]
    return out


# ------------------------------------------------------------- per-chrom
def single_chrom_compartment(M: np.ndarray, res: int, sliding: bool = False,
                             pca_method: str = "subspace"):
    """Gap/decay/OE/correlation/PCA for one raw matrix.

    Returns dict with 'gap' (bool [n]), 'nongap' (index array), 'decay',
    'oe' ([n, n]), 'cor' ([g, g] over non-gap columns), 'pcs' ([3, g]).
    """
    n = M.shape[0]
    N = pad_to_shape(n)
    Mp = np.zeros((N, N), np.float32)
    Mp[:n, :n] = M
    Mj = jnp.asarray(Mp)
    nj = jnp.asarray(n)

    gap = np.asarray(default_compartment_gap(Mj, nj))[:n]
    gapj = jnp.asarray(np.pad(gap, (0, N - n), constant_values=True))
    decay = distance_decay(Mj, gapj, nj)
    if sliding:
        step = 600_000 // res // 2
        oe = oe_matrix_sliding(Mj, decay, nj, step)
    else:
        oe = oe_matrix(Mj, decay, nj)

    nongap = np.flatnonzero(~gap)
    g = len(nongap)
    oe_host = np.asarray(oe)[:n, :n]

    # correlation over non-gap columns, all rows (reference slices cols only)
    Xp = np.zeros((N, N), np.float32)
    Xp[:n, :g] = oe_host[:, nongap]
    cor = correlation_matrix(jnp.asarray(Xp), nj)
    cor_host = np.asarray(cor)[:g, :g]

    Cp = np.zeros((N, N), np.float32)
    Cp[:g, :g] = cor_host
    pcs, _ = pca_components(jnp.asarray(Cp), jnp.asarray(g), k=3,
                            method=pca_method)
    pcs_host = np.asarray(pcs)[:, :g]

    return {
        "gap": gap,
        "nongap": nongap,
        "decay": np.asarray(decay)[:n],
        "oe": oe_host,
        "cor": cor_host,
        "pcs": pcs_host,
    }


# ---------------------------------------------------------------- driver
_BATCH_MAX_BYTES = 2 << 30  # cap a compartment batch at ~2 GB of matrices


def _compartment_batched(reader, chroms, res, sliding, pca_method,
                         with_selection: bool = True):
    """Batch chromosomes of equal padded size through one vmapped fused
    graph (per-dispatch latency dominates at coarse resolutions)."""
    import jax

    from ..core.contacts import pad_to_shape

    sizes = {}
    for c in chroms:
        ci = reader.chromnames.index(c)
        sizes[c] = int(reader.chrom_offset[ci + 1] - reader.chrom_offset[ci])
    by_pad: Dict[int, List[str]] = {}
    for c in chroms:
        by_pad.setdefault(pad_to_shape(sizes[c]), []).append(c)

    fused_v = jax.jit(
        jax.vmap(_compartment_fused.__wrapped__,
                 in_axes=(0, 0, 0, 0, 0, None, None, None)),
        static_argnums=(5, 6, 7))
    step = (600_000 // res // 2) if sliding else 0

    results = {}
    for N, group in sorted(by_pad.items()):
        max_b = max(1, _BATCH_MAX_BYTES // (N * N * 4))
        for s in range(0, len(group), max_b):
            sub = group[s : s + max_b]
            mats, gaps, ngps, gs = [], [], [], []
            for c in sub:
                Mj, n = reader.matrix_device(c, padded=N)
                gapj = default_compartment_gap(Mj, jnp.asarray(n))
                gap = np.asarray(gapj)[:n]
                nongap = np.flatnonzero(~gap)
                ng_pad = np.zeros(N, np.int32)
                ng_pad[: len(nongap)] = nongap
                mats.append(Mj)
                gaps.append(np.pad(gap, (0, N - n), constant_values=True))
                ngps.append(ng_pad)
                gs.append(len(nongap))
                results[c] = {"n": n, "gap": gap, "nongap": nongap}
            Mb = jnp.stack(mats)
            _, _, pcs, pc_signed = fused_v(
                Mb, jnp.asarray(np.stack(gaps)),
                jnp.asarray(np.asarray([sizes[c] for c in sub])),
                jnp.asarray(np.stack(ngps)), jnp.asarray(np.asarray(gs)),
                step, pca_method, with_selection)
            pcs_h = np.asarray(pcs)
            sig_h = np.asarray(pc_signed)
            for k, c in enumerate(sub):
                g = gs[k]
                results[c]["pcs"] = pcs_h[k, :, :g]
                results[c]["pc_signed"] = sig_h[k, :g]
    return results


def run_compartment(cooler_path: str, res: int, allelic,
                    out_path: str, sliding: bool = False,
                    traditional_pc_file: Optional[str] = None,
                    pca_method: str = "subspace",
                    plot: bool = False, ms: str = "IF",
                    batched: bool = True,
                    selector: str = "new") -> Dict[str, np.ndarray]:
    """Full compartment run; writes ``<prefix>_Compartment_<res>.txt``.

    ``allelic`` is False / 'Maternal' / 'Paternal' (reference API).
    ``selector``: 'new' (Select_PC_new, the reference default) or 'legacy'
    (Select_PC, StructureFind.py:345-372) for traditional mode.
    Returns {chrom: full-length signed PC track}.
    """
    if selector not in ("new", "legacy"):
        raise ValueError(f"unknown selector {selector!r}")
    if selector == "legacy" and allelic:
        # allelic runs use the supervised selector (Select_Allelic_PC);
        # silently ignoring 'legacy' would misrepresent what ran
        raise ValueError("selector='legacy' applies to traditional mode "
                         "only; allelic runs use the supervised selector")
    use_legacy = selector == "legacy"
    reader = CoolerReader(cooler_path, res)
    if allelic is False or allelic is None:
        chroms = reader.chromnames
    elif allelic == "Maternal":
        chroms = [c for c in reader.chromnames if c.startswith("M")]
    elif allelic == "Paternal":
        chroms = [c for c in reader.chromnames if c.startswith("P")]
    else:
        raise ValueError(f"Unknown allelic key {allelic!r}")

    trad_pc = None
    if allelic:
        if traditional_pc_file is None:
            raise ValueError("allelic compartment calling needs the "
                             "traditional PC file for supervised selection")
        trad_pc = load_pc_track(traditional_pc_file)

    tracks: Dict[str, np.ndarray] = {}
    extras = {}
    want_mats = (plot and ms in ("OE", "Cor")) or use_legacy
    pre = (_compartment_batched(reader, chroms, res, sliding, pca_method,
                                with_selection=not allelic)
           if batched and not want_mats else None)
    for chro in chroms:
        if pre is not None:
            r = pre[chro]
        else:
            r = single_chrom_compartment_device(reader, chro, res, sliding,
                                                pca_method,
                                                want_matrices=want_mats)
        n = r["n"]
        full = np.zeros(n)
        if use_legacy:
            full[r["nongap"]] = select_pc_legacy(r["cor"], r["pcs"])
        elif not allelic:
            full[r["nongap"]] = r["pc_signed"]
        else:
            pcs_full = np.zeros((len(r["pcs"]), n))
            for i in range(len(r["pcs"])):
                pcs_full[i, r["nongap"]] = r["pcs"][i]
            pc_sel = select_allelic_pc(pcs_full, trad_pc[chro[1:]])
            full[r["nongap"]] = pc_sel[r["nongap"]]
        tracks[chro] = full
        extras[chro] = r
        log.log(21, "compartment %s done (%d bins, %d gaps)", chro, n,
                int(r["gap"].sum()))

    os.makedirs(out_path, exist_ok=True)
    prefix = os.path.basename(out_path.rstrip("/"))
    unit = _proper_unit(res)
    txt = os.path.join(out_path, f"{prefix}_Compartment_{unit}.txt")
    with open(txt, "w") as f:
        for chro, pc in tracks.items():
            name = chro[1:] if allelic else chro
            for v in pc:
                f.write(f"{name}\t{v}\n")
    if plot:
        pdf = os.path.join(out_path, f"{prefix}_Compartment_{ms}_{unit}.pdf")
        _plot_compartment(pdf, reader, tracks, res, allelic, ms, extras)
    return tracks


def _proper_unit(pos: int) -> str:
    """Genomic position pretty-printer (StructureFind.py:159-172)."""
    i_part = int(pos) // 1_000_000
    d_part = (int(pos) % 1_000_000) // 1_000
    if i_part > 0 and d_part > 0:
        return f"{i_part}M{d_part}K"
    if i_part == 0:
        return f"{d_part}K"
    return f"{i_part}M"


def _refill_gap(n: int, sub: np.ndarray, nongap: np.ndarray) -> np.ndarray:
    """Re-insert gap rows/cols as zeros into a non-gap submatrix
    (StructureFind.py:463-489 intent, without its OE-branch transpose bug)."""
    out = np.zeros((n, n))
    out[np.ix_(nongap, nongap)] = sub
    return out


def _plot_compartment(pdf_path, reader, tracks, res, allelic, ms="IF",
                      extras=None):
    """PDF heatmap + PC track; MS selects the matrix (IF raw / OE / Cor),
    matching StructureFind.py:579-674."""
    from ..utils.optional import require_matplotlib

    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    if ms == "IF":
        cmap = LinearSegmentedColormap.from_list("interactions",
                                                 ["#FFFFFF", "#CD0000"])
    else:
        cmap = LinearSegmentedColormap.from_list(
            "interactions", ["#0000FF", "#FFFFFF", "#CD0000"])
    with PdfPages(pdf_path) as pp:
        for chro, sig in tracks.items():
            if ms == "IF" or extras is None:
                M = reader.matrix(chro, balance=False)
            else:
                r = extras[chro]
                n = len(sig)
                if ms == "OE":
                    # reference plots the gap-REFILLED O/E (gap stripes
                    # blank, vmax over non-gap values only) — the raw O/E
                    # keeps values in gap columns
                    oe = np.asarray(r["oe"])[:n, :n]
                    M = _refill_gap(
                        n, oe[np.ix_(r["nongap"], r["nongap"])], r["nongap"])
                else:  # Cor
                    M = _refill_gap(n, r["cor"], r["nongap"])
            nz = M[np.nonzero(M)]
            if ms == "IF":
                vmax = np.percentile(nz, 95) if nz.size else 1.0
                vmin = 0
            elif ms == "OE":
                vmax = np.percentile(nz, 90) if nz.size else 1.0
                vmin = 2 - vmax
            else:
                vmax = np.percentile(nz, 90) if nz.size else 1.0
                vmin = -vmax
            fig, (ax_sig, ax) = plt.subplots(
                2, 1, figsize=(10, 9),
                gridspec_kw={"height_ratios": [1, 6]})
            ax.imshow(M, cmap=cmap, aspect="auto", interpolation="none",
                      vmin=vmin, vmax=vmax, origin="lower")
            label = chro[1:] if allelic else chro
            ax.set_xlabel(f"Chr{label}", size=14)
            x = np.arange(len(sig))
            ax_sig.fill_between(x, sig, where=sig <= 0, color="#7093DB")
            ax_sig.fill_between(x, sig, where=sig >= 0, color="#E47833")
            ax_sig.set_xlim(0, len(sig))
            ax_sig.set_ylabel("PC", size=12)
            ax_sig.set_xticks([])
            pp.savefig(fig)
            plt.close(fig)
