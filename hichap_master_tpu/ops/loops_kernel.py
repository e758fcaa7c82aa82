"""HICCUPS donut / lower-left background sums as summed-area-table stencils.

The reference assembles each background as hundreds of shifted sparse
diagonal matrices per window width (HiCHap/StructureFind.py:1645-1800) — an
O(window²) pass over the band per width.  Here the same sums are rectangle
queries on a summed-area table (two cumsums), so every width costs a handful
of O(N²) slice-adds and the whole escalation ladder is a single jitted call.

Region definitions preserved exactly (StructureFind.py:1786-1800), in
offsets relative to the pixel:

  K (donut)     = full (2w+1)² window − center row − center column
                  − peak box [−pw..pw]² (+ its row/col strips back in)
  Y (lower-left)= rows [1..w] × cols [−w..−1]  minus  rows [1..pw] × cols [−pw..−1]

applied to band-limited matrices: raw M keeps diagonals d∈(0, num) —
the reference zeroes the main diagonal before banding
(``H - np.diag(H.diagonal())``, StructureFind.py:2020) — and
expected/balanced keep d∈[ww, num); everything outside a band counts
zero, exactly like the reference's ``sparse.diags`` construction
(StructureFind.py:2024-2034).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def band_limit(M: jnp.ndarray, lo: int, hi: int) -> jnp.ndarray:
    """Zero everything except diagonals lo <= (col-row) < hi."""
    N = M.shape[0]
    i = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    d = j - i
    return jnp.where((d >= lo) & (d < hi), M, 0.0)


@jax.jit
def sat(M: jnp.ndarray) -> jnp.ndarray:
    """Summed-area table with zero guard row/col: S[i, j] = sum(M[:i, :j])."""
    return jnp.pad(jnp.cumsum(jnp.cumsum(M, axis=0), axis=1), ((1, 0), (1, 0)))


def _shift(S: jnp.ndarray, a: int, b: int, N: int) -> jnp.ndarray:
    """T[x, y] = S[clip(x + a), clip(y + b)] for x, y in [0, N)."""
    r = jnp.clip(jnp.arange(N) + a, 0, N)
    c = jnp.clip(jnp.arange(N) + b, 0, N)
    return S[r][:, c]


def rect_sum(S: jnp.ndarray, r0: int, r1: int, c0: int, c1: int) -> jnp.ndarray:
    """For every pixel (x, y): sum over rows [x+r0, x+r1], cols [y+c0, y+c1]
    (inclusive offsets); regions outside the matrix contribute zero."""
    N = S.shape[0] - 1
    return (_shift(S, r1 + 1, c1 + 1, N) - _shift(S, r0, c1 + 1, N)
            - _shift(S, r1 + 1, c0, N) + _shift(S, r0, c0, N))


@functools.partial(jax.jit, static_argnames=("w", "pw"))
def donut_sums(S: jnp.ndarray, w: int, pw: int) -> jnp.ndarray:
    """K (donut) region sum for every pixel, from a SAT."""
    window = rect_sum(S, -w, w, -w, w)
    row = rect_sum(S, 0, 0, -w, w)
    col = rect_sum(S, -w, w, 0, 0)
    p1 = rect_sum(S, -pw, pw, -pw, pw)
    p1row = rect_sum(S, 0, 0, -pw, pw)
    p1col = rect_sum(S, -pw, pw, 0, 0)
    return window - row - col - p1 + p1row + p1col


@functools.partial(jax.jit, static_argnames=("w", "pw"))
def lowerleft_sums(S: jnp.ndarray, w: int, pw: int) -> jnp.ndarray:
    """Y (lower-left) region sum for every pixel, from a SAT."""
    quad = rect_sum(S, 1, w, -w, -1)
    sub = rect_sum(S, 1, pw, -pw, -1)
    return quad - sub


# -------------------------------------------------- stable formulation
#
# A single global SAT accumulates to the full matrix total (~1e8 counts at
# 10 kb), so float32 rectangle differences of ~1e2-sized donut regions lose
# ~10 significant bits — unacceptable.  The stable form splits the 2D prefix:
#   S1 = row prefix of M                  (magnitude ≤ one row's total)
#   D  = S1[:, y+c1+1] - S1[:, y+c0]      (magnitude ≤ a window row sum)
#   C  = column prefix of D               (magnitude ≤ a column *stripe* total)
#   rect(x, y) = C[x+r1+1, y] - C[x+r0, y]
# keeping every accumulation bounded by a stripe rather than the matrix.


@jax.jit
def row_prefix(M: jnp.ndarray) -> jnp.ndarray:
    """S1[i, j] = sum(M[i, :j]); shape [N, N+1]."""
    return jnp.pad(jnp.cumsum(M, axis=1), ((0, 0), (1, 0)))


def _col_diff(S1: jnp.ndarray, c0: int, c1: int) -> jnp.ndarray:
    """D[i, y] = sum over columns y+c0..y+c1 of row i (zero outside)."""
    N = S1.shape[0]
    cols = jnp.arange(N)
    hi = jnp.clip(cols + c1 + 1, 0, N)
    lo = jnp.clip(cols + c0, 0, N)
    return S1[:, hi] - S1[:, lo]


def _rect_stable_at(S1, xi, yi, r0, r1, c0, c1):
    """Rectangle sums at pixel lists, numerically stable."""
    N = S1.shape[0]
    D = _col_diff(S1, c0, c1)
    if r0 == 0 and r1 == 0:
        return D[xi, yi]
    C = jnp.pad(jnp.cumsum(D, axis=0), ((1, 0), (0, 0)))
    a0 = jnp.clip(xi + r0, 0, N)
    a1 = jnp.clip(xi + r1 + 1, 0, N)
    return C[a1, yi] - C[a0, yi]


def donut_at_stable(S1, xi, yi, w: int, pw: int):
    return (_rect_stable_at(S1, xi, yi, -w, w, -w, w)
            - _rect_stable_at(S1, xi, yi, 0, 0, -w, w)
            - _rect_stable_at(S1, xi, yi, -w, w, 0, 0)
            - _rect_stable_at(S1, xi, yi, -pw, pw, -pw, pw)
            + _rect_stable_at(S1, xi, yi, 0, 0, -pw, pw)
            + _rect_stable_at(S1, xi, yi, -pw, pw, 0, 0))


def lowerleft_at_stable(S1, xi, yi, w: int, pw: int):
    return (_rect_stable_at(S1, xi, yi, 1, w, -w, -1)
            - _rect_stable_at(S1, xi, yi, 1, pw, -pw, -1))


def oracle_region_sums(M: np.ndarray, x: int, y: int, w: int, pw: int
                       ) -> Tuple[float, float]:
    """Brute-force K and Y sums at one pixel (test oracle), replicating the
    reference's key-set definitions literally (StructureFind.py:1786-1800)."""
    ws = 2 * w + 1
    ps = 2 * pw + 1
    N = M.shape[0]
    P1 = {(i, j) for i in range(w - pw, ps + w - pw)
          for j in range(w - pw, ps + w - pw)}
    P_1 = {(i, j) for i in range(w + 1, ws) for j in range(w)}
    P_2 = {(i, j) for i in range(w + 1, ps + w - pw)
           for j in range(w - pw, w)}
    P2 = P_1 - P_2
    K = Y = 0.0
    for i in range(ws):
        for j in range(ws):
            xi, yj = x + i - w, y + j - w
            if not (0 <= xi < N and 0 <= yj < N):
                continue
            v = M[xi, yj]
            key = (i, j)
            if key in P2:
                K += v
                Y += v
            elif key[0] != w and key[1] != w and key not in P1:
                K += v
    return K, Y
