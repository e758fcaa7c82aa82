"""TAD / boundary calling: DI + Gaussian-mixture HMM + domain assembly.

Behavioral spec: HiCHap/StructureFind.py:705-1569.  The DI computation and
HMM training/decoding run jitted (ops/di.py, ops/hmm.py); segmenting,
boundary-pattern extraction, gap-proximity filtering and the
boundary→domain rules are host-side (tiny data).

Traditional mode consumes *balanced* matrices (nan→0), allelic mode the raw
corrected matrices (StructureFind.py:850-865).  The reference trains GHMM
three times in a row, each to convergence, with shuffled sequence order
(StructureFind.py:1106-1108); our batched EM is order-invariant, so a single
run to convergence is the equivalent fixed point.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.contacts import pad_to_shape
from ..io.cooler import CoolerReader
from ..ops.di import (directionality_index, directionality_index_band,
                      tad_gap_mask, tad_gap_mask_counts)
from ..ops.hmm import GMMHMM, viterbi
from ..utils.logging import get_logger
from .compartment import _proper_unit

log = get_logger(__name__)

SEGMENT_MIN_WIDTH = 7  # StructureFind.py:870 ("width")


# ----------------------------------------------------------------- priors
def init_parameters(state_num: int) -> GMMHMM:
    """Hand-tuned priors (StructureFind.py:918-1049), reproduced verbatim."""
    if state_num == 3:
        A = [[0.85, 0.15, 0.00],
             [0.05, 0.80, 0.15],
             [0.19, 0.01, 0.80]]
        pi = [0.40, 0.30, 0.30]
        numdists = 3
        var = 6.0 / (numdists - 1)
        shifts = [1, -1, -2]
    elif state_num == 5:
        A = [[0.00, 1.00, 0.00, 0.00, 0.00],
             [0.00, 0.50, 0.50, 0.00, 0.00],
             [0.33, 0.00, 0.34, 0.33, 0.00],
             [0.00, 0.00, 0.00, 0.50, 0.50],
             [0.50, 0.00, 0.50, 0.00, 0.00]]
        pi = [0.05, 0.3, 0.3, 0.3, 0.05]
        numdists = 3
        var = 6.0 / (numdists - 1)
        shifts = [1, 0, -1, -2, -3]
    elif state_num == 6:
        A = [[0.00, 1.00, 0.00, 0.00, 0.00, 0.00],
             [0.00, 0.75, 0.20, 0.00, 0.00, 0.05],
             [0.00, 0.00, 0.60, 0.35, 0.00, 0.05],
             [0.00, 0.00, 0.00, 0.93, 0.02, 0.05],
             [0.20, 0.60, 0.20, 0.00, 0.00, 0.00],
             [0.00, 0.22, 0.06, 0.22, 0.00, 0.50]]
        pi = [0.01, 0.29, 0.20, 0.10, 0.05, 0.35]
        numdists = 3
        var = 4.2 / (numdists - 1)
        shifts = [-3, -2, -1, 0, 1, None]  # state 5 ("gap") has zero means
    else:
        raise ValueError("Only 3, 5, 6 states are supported")

    S = len(pi)
    means = np.zeros((S, numdists))
    for s in range(S):
        for i in range(numdists):
            means[s, i] = 0.0 if shifts[s] is None else (i + shifts[s]) * var
    varis = np.full((S, numdists), var)
    if state_num == 6:
        varis[5] = 1e-4  # StructureFind.py:1047
    weights = np.full((S, numdists), 1.0 / numdists)
    return GMMHMM(np.asarray(A, float), np.asarray(pi, float), means, varis,
                  weights)


# ------------------------------------------------------------- gap logic
def gap_filter(gap: np.ndarray, N: int) -> List[int]:
    """Run-length gap filtering (StructureFind.py:753-802), loop semantics
    preserved (including the dropped trailing non-consecutive run)."""
    gap = np.asarray(gap)
    if gap.shape[0] <= 1:
        return []
    runs: Dict[Tuple[int, int], int] = {}
    cs, ce = int(gap[0]), int(gap[0])
    L = gap.shape[0]
    for i in range(1, L):
        if gap[i] - gap[i - 1] == 1 and i == L - 1:
            ce = int(gap[i]) + 1
            runs[(cs, ce)] = ce - cs
        elif gap[i] - gap[i - 1] == 1:
            ce = int(gap[i]) + 1
        else:
            runs[(cs, ce)] = ce - cs
            cs = int(gap[i])
            ce = int(gap[i]) + 1
    keys = sorted(runs)
    lens = [runs[k] for k in keys]
    gmean = float(np.mean(lens)) if lens else 0.0
    out: List[int] = []
    for k in keys:
        if runs[k] >= min(10, gmean):
            out.extend(range(k[0], k[1]))
    if 0 not in out:
        out.insert(0, 0)
    if N - 1 not in out:
        out.append(N - 1)
    return out


# ------------------------------------------------------------- per-chrom
def chrom_di_segments(M: np.ndarray, res: int, min_tad: int, window: int,
                      test_type: str):
    """Gap detection + DI + training-segment extraction for one host matrix."""
    n = M.shape[0]
    N = pad_to_shape(n)
    Mp = np.zeros((N, N), np.float32)
    Mp[:n, :n] = M
    return chrom_di_segments_device(jnp.asarray(Mp), n, res, min_tad, window,
                                    test_type)


def chrom_di_segments_device(Mj, n: int, res: int, min_tad: int, window: int,
                             test_type: str):
    """Device-matrix variant: only the gap mask and DI track (O(N)) cross
    the host↔device link."""
    local_bin = int(min_tad / res)
    w = int(window / res)
    N = Mj.shape[0]

    gapm = np.asarray(tad_gap_mask(Mj, jnp.asarray(n), local_bin))[:n]
    gap = np.flatnonzero(gapm)
    tmp = list(gap)
    if 0 not in tmp:
        tmp.insert(0, 0)
    if n - 1 not in tmp:
        tmp.append(n - 1)
    gap = np.array(sorted(set(tmp)))

    gap_mask_full = np.zeros(N, bool)
    gap_mask_full[gap] = True
    gap_mask_full[n:] = True
    di = np.asarray(directionality_index(
        Mj, jnp.asarray(gap_mask_full), jnp.asarray(n), w,
        test_type))[:n]

    gap_density_t = gap.size / n / 2.0
    gf = gap_filter(gap, n)
    segments: Dict[Tuple[int, int], np.ndarray] = {}
    for i in range(1, len(gf)):
        a, b = gf[i - 1], gf[i]
        if b - a <= SEGMENT_MIN_WIDTH:
            continue
        inner = ((gap > a) & (gap < b)).sum()
        if inner / float(b - a - 1) > gap_density_t:
            continue
        segments[(a + 1, b)] = di[a + 1 : b]
    return di, gap, segments


# ------------------------------------------------- boundary extraction
_MASK_STR = {
    3: [("220", 2, 2), ("200", 1, 1), ("2221", 3, 3), ("1000", 1, 1)],
    5: [("40", 1, 1)],
    6: [("40", 1, 1)],
}


def boundary_call(paths: Dict[Tuple[int, int], Tuple[np.ndarray, float]],
                  di_len: int, state_num: int, res: int):
    """State-pattern boundary extraction (StructureFind.py:1126-1188).

    Returns structured array with fields boundary (bp), state, raw_state.
    """
    raw = np.full(di_len, "5", dtype="U1")
    state = np.full(di_len, "none", dtype="U5")
    for (a, b), (path, _lp) in paths.items():
        raw[a:b] = [str(int(s)) for s in path]

    s = "".join(raw)
    for pattern, off_s, off_e in _MASK_STR[state_num]:
        start_end = off_s == off_e
        start = 0
        while True:
            i = s.find(pattern, start)
            if i < 0:
                break
            if start_end:
                state[i + off_s] = "both"
            else:
                if off_s >= 0:
                    state[i + off_s] = ("both" if state[i + off_s] == "end"
                                        else "start")
                if off_e >= 0:
                    state[i + off_e] = ("both" if state[i + off_e] == "start"
                                        else "end")
            start = i + 1
    mask = state != "none"
    idx = np.flatnonzero(mask)
    return {
        "boundary": idx * res,
        "state": state[idx].copy(),
        "index_all": np.arange(di_len) * res,
        "state_all_mask": mask,
    }


def boundary_filter(boundaries, gap: np.ndarray, res: int,
                    width: int = SEGMENT_MIN_WIDTH):
    """Gap-proximity reclassification (StructureFind.py:1232-1268)."""
    b = boundaries["boundary"]
    st = boundaries["state"].copy()
    half = (width - 1) / 2.0
    for i in range(len(b)):
        bb = b[i] / res
        left = ((gap >= bb - width) & (gap <= bb)).sum()
        right = ((gap >= bb) & (gap <= bb + width)).sum()
        if left >= half and right >= half:
            st[i] = "none"
        elif left >= half and st[i] != "end":
            st[i] = "start"
        elif left >= half and st[i] == "end":
            st[i] = "none"
        elif right >= half and st[i] != "start":
            st[i] = "end"
        elif right >= half and st[i] == "start":
            st[i] = "none"
    boundaries["state"] = st
    return b[st != "none"]


def boundaries_to_domains(boundaries, segments, di: np.ndarray, res: int,
                          min_tad: int, max_tad: int):
    """Boundary pairs → domains with gap-run rules (StructureFind.py:1271-1342)."""
    b = boundaries["boundary"]
    st = boundaries["state"]
    seg_keys = sorted(segments.keys())
    cand_start = np.array([k[0] * res for k in seg_keys])
    cand_end = np.array([k[1] * res for k in seg_keys])
    starts, ends = [], []
    for ind in range(len(b) - 1):
        in1 = np.flatnonzero((cand_start <= b[ind]) & (b[ind] <= cand_end))
        in2 = np.flatnonzero((cand_start <= b[ind + 1]) & (b[ind + 1] <= cand_end))
        if in1.size == 0 or in2.size == 0:
            continue
        if (in1[0] != in2[0]
                or st[ind] in ("none", "end")
                or st[ind + 1] in ("none", "start")):
            continue
        four = three = two = 0
        for jnd in range(int(b[ind] / res), int(b[ind + 1] / res - 3)):
            if (di[jnd : jnd + 4] == 0).sum() == 4:
                four += 1
                break
            elif (di[jnd : jnd + 3] == 0).sum() == 3:
                three += 1
                break
            elif (di[jnd : jnd + 2] == 0).sum() == 2:
                two += 1
        if four >= 1 or three >= 2 or two >= 3:
            continue
        lo, hi = int(b[ind] / res), int(b[ind + 1] / res)
        if (di[lo:hi] == 0).sum() > (b[ind + 1] - b[ind]) / res / 3.0:
            continue
        if b[ind + 1] - b[ind] < min_tad:
            continue
        if b[ind + 1] - b[ind] > max_tad:
            continue
        starts.append(int(b[ind]))
        ends.append(int(b[ind + 1]))
    return np.array(starts), np.array(ends)


_DI_BATCH_MAX_BYTES = 2 << 30


def _bands_from_coo(rows, cols, vals, N: int, w: int, local_bin: int):
    """Host: diagonal bands (ops/di._diag_bands layout) + the gap rule's
    per-column nonzero counts, straight from upper-triangle COO — the dense
    matrix never exists on either side of the link."""
    d = cols - rows
    up = np.zeros((w, N), np.float32)
    down = np.zeros((w, N), np.float32)
    for k in range(1, w + 1):
        m = d == k
        up[k - 1, cols[m]] = vals[m]
        down[k - 1, rows[m]] = vals[m]
    nz = vals != 0
    cnt = np.bincount(cols[nz & (d >= 1) & (d <= local_bin)],
                      minlength=N).astype(np.float32)
    cnt += np.bincount(rows[nz & (d >= 1) & (d <= local_bin - 1)],
                       minlength=N)
    cnt += np.bincount(rows[nz & (d == 0)], minlength=N)
    return up, down, cnt


@functools.partial(jax.jit, static_argnames=("local_bin", "test_type"))
def _gap_di_batch(upb, downb, cntb, ns, *, local_bin: int, test_type: str):
    """Batched gap mask + DI.  Module-level jit: defining this as a closure
    inside _di_batched created a fresh wrapper per run_tads call, which
    recompiled every size bucket on every call (~8.7 s of the 22 s warm
    TAD stage at full hg19 scale)."""
    gaps = jax.vmap(lambda c, n: tad_gap_mask_counts(c, n, local_bin))(
        cntb, ns)
    # Data_preprocess forces bins 0 and n-1 into the gap set before DI
    N = cntb.shape[-1]
    idx = jnp.arange(N)[None, :]
    forced = gaps | (idx == 0) | (idx == ns[:, None] - 1)
    di = jax.vmap(lambda u, dn, g, n: directionality_index_band(
        u, dn, g, n, test_type))(upb, downb, forced, ns)
    return forced, di


def _di_batched(reader: CoolerReader, chroms, balance: bool, res: int,
                min_tad: int, window: int, test_type: str):
    """Gap + DI for all chromosomes in one vmapped dispatch per size group
    (segment extraction stays host-side)."""
    local_bin = int(min_tad / res)
    w = int(window / res)

    sizes = {}
    for c in chroms:
        ci = reader.chromnames.index(c)
        sizes[c] = int(reader.chrom_offset[ci + 1] - reader.chrom_offset[ci])
    by_pad: Dict[int, List[str]] = {}
    for c in chroms:
        by_pad.setdefault(pad_to_shape(sizes[c]), []).append(c)

    out = {}
    for N, group in sorted(by_pad.items()):
        max_b = max(1, _DI_BATCH_MAX_BYTES // ((2 * w + 1) * N * 4))
        for s in range(0, len(group), max_b):
            sub = group[s : s + max_b]
            ups, downs, cnts, ns = [], [], [], []
            for c in sub:
                rows, cols, vals = reader.fetch_coo(c)
                vals = vals.astype(np.float64)
                if balance:
                    bw = np.asarray(reader.bins_weight(c), np.float64)
                    vals = np.nan_to_num(vals * bw[rows] * bw[cols])
                u, dn, cnt = _bands_from_coo(rows, cols, vals, N, w,
                                             local_bin)
                ups.append(u)
                downs.append(dn)
                cnts.append(cnt)
                ns.append(sizes[c])
            gaps_b, di_b = _gap_di_batch(
                jnp.asarray(np.stack(ups)), jnp.asarray(np.stack(downs)),
                jnp.asarray(np.stack(cnts)), jnp.asarray(np.asarray(ns)),
                local_bin=local_bin, test_type=test_type)
            # one round trip for both (latency is per transfer)
            gaps_h, di_h = jax.device_get((gaps_b, di_b))
            for k, c in enumerate(sub):
                n = ns[k]
                gap = np.flatnonzero(gaps_h[k, :n])
                di = di_h[k, :n]
                out[c] = _segments_from_di(di, gap, n)
    return out


def _segments_from_di(di: np.ndarray, gap: np.ndarray, n: int):
    """Training-segment extraction (the host tail of chrom_di_segments)."""
    gap_density_t = gap.size / n / 2.0
    gf = gap_filter(gap, n)
    segments: Dict[Tuple[int, int], np.ndarray] = {}
    for i in range(1, len(gf)):
        a, b = gf[i - 1], gf[i]
        if b - a <= SEGMENT_MIN_WIDTH:
            continue
        inner = ((gap > a) & (gap < b)).sum()
        if inner / float(b - a - 1) > gap_density_t:
            continue
        segments[(a + 1, b)] = di[a + 1 : b]
    return di, gap, segments


# ----------------------------------------------------------------- driver
def run_tads(cooler_path: str, res: int, allelic, out_path: str,
             min_tad: int = 200_000, max_tad: int = 4_000_000,
             state_num: int = 3, window: int = 600_000,
             test_type: str = "ttest", plot: bool = False):
    """Full TAD run; writes DI / All_Boundary / Filtered_Boundary / Domain
    text files (StructureFind.py:1438-1569 output contract)."""
    reader = CoolerReader(cooler_path, res)
    if allelic is False or allelic is None:
        chroms = reader.chromnames
        balance = True
        fetch = lambda c: np.nan_to_num(reader.matrix(c, balance=True))
    elif allelic in ("Maternal", "Paternal"):
        pre = allelic[0]
        chroms = [c for c in reader.chromnames if c.startswith(pre)]
        balance = False
        fetch = lambda c: reader.matrix(c, balance=False)
    else:
        raise ValueError(f"Unknown allelic key {allelic!r}")

    di_dict, gap_dict, seg_dict = {}, {}, {}
    train_seqs: List[np.ndarray] = []
    batched = _di_batched(reader, chroms, balance, res, min_tad, window,
                          test_type)
    for c in chroms:
        di, gap, segs = batched[c]
        di_dict[c], gap_dict[c], seg_dict[c] = di, gap, segs
        train_seqs.extend(segs[k] for k in sorted(segs))
        log.log(21, "TAD prep %s: %d bins, %d segments", c, len(di), len(segs))

    if not train_seqs:
        raise ValueError("no trainable DI segments — matrices too sparse?")
    from ..ops.hmm import baum_welch_fused
    from ..utils.profiling import stage
    model = init_parameters(state_num)
    with stage("tads.baum_welch"):
        model, iters, ll = baum_welch_fused(model, train_seqs)
    log.log(21, "HMM trained: %d EM iters, loglik %.3f", iters, ll)

    # one Viterbi dispatch over every chromosome's segments (padding to the
    # global max length once beats 23 per-chromosome pads + dispatches)
    all_keys = [(c, k) for c in chroms for k in sorted(seg_dict[c])]
    if all_keys:
        all_decoded = viterbi(model, [seg_dict[c][k] for c, k in all_keys])
    else:
        all_decoded = []
    decoded_by = {ck: d for ck, d in zip(all_keys, all_decoded)}

    results = {}
    for c in chroms:
        segs = seg_dict[c]
        paths = {k: decoded_by[(c, k)] for k in sorted(segs)}
        bd = boundary_call(paths, len(di_dict[c]), state_num, res)
        filtered = boundary_filter(bd, gap_dict[c], res)
        dstart, dend = boundaries_to_domains(bd, segs, di_dict[c], res,
                                             min_tad, max_tad)
        results[c] = {"di": di_dict[c], "boundaries": bd,
                      "filtered": filtered, "domains": (dstart, dend)}

    os.makedirs(out_path, exist_ok=True)
    prefix = os.path.basename(out_path.rstrip("/"))
    unit = _proper_unit(res)

    def outname(tag):
        return os.path.join(out_path, f"{prefix}_{tag}_{unit}.txt")

    strip = (lambda c: c[1:]) if allelic else (lambda c: c)
    with open(outname("DI"), "w") as f:
        for c in chroms:
            for v in results[c]["di"]:
                f.write(f"{strip(c)}\t{v}\n")
    with open(outname("All_Boundary"), "w") as f:
        for c in chroms:
            for bpos in results[c]["boundaries"]["boundary"]:
                f.write(f"{strip(c)}\t{bpos}\n")
    with open(outname("Filtered_Boundary"), "w") as f:
        for c in chroms:
            for bpos in results[c]["filtered"]:
                f.write(f"{strip(c)}\t{bpos}\n")
    with open(outname("Domain"), "w") as f:
        for c in chroms:
            ds, de = results[c]["domains"]
            for s, e in zip(ds, de):
                f.write(f"{strip(c)}\t{s}\t{e}\n")
    if plot:
        _plot_tads(os.path.join(out_path, f"{prefix}_TADs_Plot_{unit}.pdf"),
                   reader, chroms, results, res, allelic, fetch)
    return results


def _plot_tads(pdf_path, reader, chroms, results, res, allelic, fetch,
               length: int = 4_000_000):
    from ..utils.optional import require_matplotlib

    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    from ..models.compartment import _proper_unit  # reference properU

    cmap = LinearSegmentedColormap.from_list("interactions",
                                             ["#FFFFFF", "#CD0000"])
    interval = max(length // res, 1)
    with PdfPages(pdf_path) as pp:
        for c in chroms:
            M = fetch(c)
            di = results[c]["di"]
            ds, de = results[c]["domains"]
            N = M.shape[0]
            # reference tiles full 4 Mb windows and drops the tail
            # (StructureFind.py:1345-1434); chromosomes SHORTER than one
            # window get a single whole-chromosome page here instead of
            # no page at all
            n_win = N // interval
            windows = ([(k * interval, (k + 1) * interval)
                        for k in range(n_win)] if n_win else [(0, N)])
            for start, end in windows:
                W = M[start:end, start:end]
                nz = W[np.nonzero(W)]
                if nz.size <= 100:
                    continue
                vmax = np.percentile(nz, 95)
                fig, (ax_di, ax) = plt.subplots(
                    2, 1, figsize=(10, 9),
                    gridspec_kw={"height_ratios": [1, 6]})
                ax.imshow(W, cmap=cmap, aspect="auto", interpolation="none",
                          vmin=0, vmax=vmax, origin="lower")
                # domains with a start OR end strictly inside the window
                # (the reference mask; crossing domains draw clipped)
                for s, e in zip(ds, de):
                    if not ((start * res < s < end * res)
                            or (start * res < e < end * res)):
                        continue
                    sb, eb = s // res - start, e // res - start
                    ax.plot([sb, eb, eb, sb, sb], [sb, sb, eb, eb, sb],
                            color="#0000FF", lw=0.5)
                ax.set_xlim(0, end - start)
                ax.set_ylim(0, end - start)
                ticks = list(np.linspace(0, end - start, 5).astype(int))
                ax.set_xticks(ticks)
                ax.set_xticklabels(
                    [_proper_unit((start + t) * res) for t in ticks])
                seg = di[start:end]
                x = np.arange(len(seg))
                ax_di.fill_between(x, seg, where=seg <= 0, color="#7093DB")
                ax_di.fill_between(x, seg, where=seg >= 0, color="#E47833")
                ax_di.set_xlim(0, len(seg))
                ax_di.set_ylabel("DI")
                ax_di.set_xticks([])
                label = c[1:] if allelic else c
                ax.set_xlabel(f"Chr{label}", size=14)
                pp.savefig(fig)
                plt.close(fig)
