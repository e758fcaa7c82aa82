"""Gaussian-mixture HMM: Baum-Welch + Viterbi as jitted scans.

Replaces the reference's dependency on the unmaintained GHMM C library
(HiCHap/StructureFind.py:21, 1052-1123).  Emissions are K-component Gaussian
mixtures per state; training is standard EM with scaled forward-backward,
batched over padded sequences with ``jax.vmap`` and scanned over time with
``jax.lax.scan`` — so one compiled program trains on all DI segments of all
chromosomes simultaneously.

Structural zeros in the transition matrix and initial distribution are
preserved exactly (EM keeps them zero), matching GHMM's behavior on the
hand-tuned HiCHap priors (StructureFind.py:918-1049).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_LOG_2PI = float(np.log(2.0 * np.pi))
VAR_FLOOR = 1e-6


@dataclass
class GMMHMM:
    """Parameter container (host-side numpy)."""

    A: np.ndarray       # [S, S] transition probabilities
    pi: np.ndarray      # [S]
    means: np.ndarray   # [S, K]
    varis: np.ndarray   # [S, K]
    weights: np.ndarray  # [S, K]

    @classmethod
    def from_reference_B(cls, A, B, pi) -> "GMMHMM":
        """Build from the reference's (A, B, pi) layout where
        ``B[s] = [means, vars, weights]`` (StructureFind.py:953-954)."""
        S = len(pi)
        means = np.asarray([B[s][0] for s in range(S)], float)
        varis = np.asarray([B[s][1] for s in range(S)], float)
        weights = np.asarray([B[s][2] for s in range(S)], float)
        return cls(np.asarray(A, float), np.asarray(pi, float), means, varis,
                   weights)


def _pad_sequences(seqs: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    T = max(len(s) for s in seqs)
    # Round T up to a power of two so repeated calls reuse compiled programs.
    T = 1 << (T - 1).bit_length() if T > 1 else 1
    X = np.zeros((len(seqs), T), np.float64)
    L = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        X[i, : len(s)] = s
        L[i] = len(s)
    return X, L


def _log_mix(x, means, varis, weights):
    """log emission prob per state.  x: scalar per time; returns [S] and the
    per-component posteriors [S, K]."""
    lp = (
        -0.5 * ((x[..., None, None] - means) ** 2 / varis)
        - 0.5 * jnp.log(varis)
        - 0.5 * _LOG_2PI
        + jnp.log(weights)
    )  # [..., S, K]
    m = jnp.max(lp, axis=-1, keepdims=True)
    lse = m[..., 0] + jnp.log(jnp.sum(jnp.exp(lp - m), axis=-1))
    comp_post = jnp.exp(lp - lse[..., None])
    return lse, comp_post


# The HMM's products are S x S (S <= 6 states) or reductions over the
# sequence; at default precision a float32 product may run in TF32 on a
# GPU (~1e-3 relative), which would move the log-likelihood that EM's
# stopping rule compares.  Full precision costs nothing at these sizes.
_HP = jax.lax.Precision.HIGHEST


@jax.jit
def _e_step(X, L, A, pi, means, varis, weights):
    """Batched scaled forward-backward.  Returns sufficient statistics."""
    B, T = X.shape
    S = A.shape[0]

    logb, comp_post = _log_mix(X, means, varis, weights)  # [B,T,S], [B,T,S,K]
    tmask = (jnp.arange(T)[None, :] < L[:, None]).astype(X.dtype)  # [B,T]

    def fwd_step(carry, inp):
        alpha_prev = carry
        b_t, m_t = inp
        raw = jnp.dot(alpha_prev, A, precision=_HP) * b_t
        c = jnp.sum(raw)
        c = jnp.where(c > 0, c, 1.0)
        alpha = raw / c
        # masked steps: carry through unchanged, scale 1
        alpha = jnp.where(m_t > 0, alpha, alpha_prev)
        c = jnp.where(m_t > 0, c, 1.0)
        return alpha, (alpha, c)

    def one_seq(x_b, logb_b, mask_b):
        # per-timestep emission normalization: exp(logb) underflows to 0
        # below logb ~ -87 in float32 (chitest DI statistics reach
        # hundreds), which zeroed alpha for the rest of the scan and
        # silently truncated EM.  Scaled forward-backward is invariant to
        # a per-t emission scale — the shift folds into the scaling
        # constants and returns via the log-likelihood.
        mx = jnp.max(logb_b, axis=-1)
        b_b = jnp.exp(logb_b - mx[:, None])  # argmax state = 1, no underflow
        raw0 = pi * b_b[0]
        c0 = jnp.sum(raw0)
        c0 = jnp.where(c0 > 0, c0, 1.0)
        alpha0 = raw0 / c0
        _, (alphas, cs) = jax.lax.scan(
            fwd_step, alpha0, (b_b[1:], mask_b[1:]))
        alphas = jnp.concatenate([alpha0[None], alphas], 0)
        cs = jnp.concatenate([jnp.array([c0]), cs], 0)

        def bwd_step(carry, inp):
            beta_next = carry
            b_next, c_next, m_next = inp
            beta = jnp.dot(A, b_next * beta_next, precision=_HP) / c_next
            beta = jnp.where(m_next > 0, beta, jnp.ones_like(beta))
            return beta, beta

        betaT = jnp.ones(S, X.dtype)
        _, betas_rev = jax.lax.scan(
            bwd_step, betaT,
            (b_b[1:][::-1], cs[1:][::-1], mask_b[1:][::-1]))
        betas = jnp.concatenate([betas_rev[::-1], betaT[None]], 0)

        gamma = alphas * betas
        gamma = gamma / jnp.maximum(jnp.sum(gamma, -1, keepdims=True), 1e-300)
        gamma = gamma * mask_b[:, None]

        # xi_t = alpha_t (A * b_{t+1} beta_{t+1}) / c_{t+1}
        pair_mask = mask_b[1:] * mask_b[:-1]
        xi = (alphas[:-1][:, :, None] * A[None] *
              (b_b[1:] * betas[1:])[:, None, :] / cs[1:][:, None, None])
        xi = xi * pair_mask[:, None, None]
        loglik = jnp.sum((jnp.log(cs) + mx) * mask_b)
        return gamma, xi.sum(0), loglik

    gamma, xi_sum, loglik = jax.vmap(one_seq)(X, logb, tmask)

    # sufficient stats
    gsum = jnp.einsum("bts->s", gamma)
    gsum_nolast = gsum - gamma[jnp.arange(B), jnp.maximum(L - 1, 0)].sum(0)
    A_num = xi_sum.sum(0)
    pi_new = gamma[:, 0, :].mean(0)
    gk = gamma[..., None] * comp_post  # [B,T,S,K]
    gk_sum = jnp.einsum("btsk->sk", gk)
    x_sum = jnp.einsum("btsk,bt->sk", gk, X, precision=_HP)
    x2_sum = jnp.einsum("btsk,bt->sk", gk, X * X, precision=_HP)
    return dict(A_num=A_num, gsum_nolast=gsum_nolast, pi_new=pi_new,
                gk_sum=gk_sum, x_sum=x_sum, x2_sum=x2_sum,
                loglik=jnp.sum(loglik))


def _m_step(st, zero_A, zero_pi):
    A_new = st["A_num"] / jnp.maximum(st["gsum_nolast"][:, None], 1e-300)
    A_new = jnp.where(zero_A, 0.0, A_new)
    A_new = A_new / jnp.maximum(A_new.sum(1, keepdims=True), 1e-300)
    pi_new = jnp.where(zero_pi, 0.0, st["pi_new"])
    pi_new = pi_new / jnp.maximum(pi_new.sum(), 1e-300)
    gk = jnp.maximum(st["gk_sum"], 1e-300)
    w_new = gk / gk.sum(1, keepdims=True)
    mu_new = st["x_sum"] / gk
    var_new = jnp.maximum(st["x2_sum"] / gk - mu_new**2, VAR_FLOOR)
    return A_new, pi_new, mu_new, var_new, w_new


@functools.partial(jax.jit, static_argnames=("tol", "max_iters"))
def _baum_welch_device(X, L, A0, pi0, means0, varis0, weights0, zero_A,
                       zero_pi, tol: float, max_iters: int):
    """Whole EM loop as one on-device while_loop (single dispatch — host
    round trips per iteration cost ~0.3 s each over a remote link)."""

    def body2(state):
        it, params, prev, done = state
        A, pi, means, varis, weights = params
        st = _e_step(X, L, A, pi, means, varis, weights)
        ll = st["loglik"]
        new_params = _m_step(st, zero_A, zero_pi)
        converged = jnp.abs(ll - prev) < tol * (jnp.abs(prev) + 1.0)
        return it + 1, new_params, ll, converged

    def cond2(state):
        it, params, prev, done = state
        return (~done) & (it < max_iters)

    init = (jnp.zeros((), jnp.int32), (A0, pi0, means0, varis0, weights0),
            jnp.asarray(-jnp.inf, X.dtype), jnp.asarray(False))
    it, params, ll, _ = jax.lax.while_loop(cond2, body2, init)
    return it, params, ll


def baum_welch_fused(model: GMMHMM, seqs: Sequence[np.ndarray],
                     tol: float = 1e-6, max_iters: int = 500
                     ) -> Tuple[GMMHMM, int, float]:
    """Single-dispatch EM (production path).  Returns (model, iters, ll)."""
    X, L = _pad_sequences(seqs)
    zero_A = jnp.asarray(model.A <= 0)
    zero_pi = jnp.asarray(model.pi <= 0)
    it, params, ll = _baum_welch_device(
        jnp.asarray(X), jnp.asarray(L), jnp.asarray(model.A),
        jnp.asarray(model.pi), jnp.asarray(model.means),
        jnp.asarray(model.varis), jnp.asarray(model.weights), zero_A,
        zero_pi, tol, max_iters)
    A, pi, means, varis, weights = params
    out = GMMHMM(np.asarray(A), np.asarray(pi), np.asarray(means),
                 np.asarray(varis), np.asarray(weights))
    return out, int(it), float(ll)


def baum_welch(model: GMMHMM, seqs: Sequence[np.ndarray], tol: float = 1e-6,
               max_iters: int = 500) -> Tuple[GMMHMM, List[float]]:
    """EM to convergence (relative log-likelihood change < tol)."""
    X, L = _pad_sequences(seqs)
    Xj, Lj = jnp.asarray(X), jnp.asarray(L)
    A = jnp.asarray(model.A)
    pi = jnp.asarray(model.pi)
    means = jnp.asarray(model.means)
    varis = jnp.asarray(model.varis)
    weights = jnp.asarray(model.weights)
    zero_A = model.A <= 0
    zero_pi = model.pi <= 0

    hist: List[float] = []
    prev = -np.inf
    for _ in range(max_iters):
        st = _e_step(Xj, Lj, A, pi, means, varis, weights)
        ll = float(st["loglik"])
        hist.append(ll)
        A, pi, means, varis, weights = _m_step(
            st, jnp.asarray(zero_A), jnp.asarray(zero_pi))
        if np.isfinite(prev) and abs(ll - prev) < tol * (abs(prev) + 1.0):
            break
        prev = ll
    out = GMMHMM(np.asarray(A), np.asarray(pi), np.asarray(means),
                 np.asarray(varis), np.asarray(weights))
    return out, hist


@jax.jit
def _viterbi_padded(X, L, logA, logpi, means, varis, weights):
    B, T = X.shape
    S = logA.shape[0]
    logb, _ = _log_mix(X, means, varis, weights)  # [B,T,S]
    tmask = jnp.arange(T)[None, :] < L[:, None]

    def one(x_logb, mask):
        def step(carry, inp):
            delta_prev = carry
            lb_t, m_t = inp
            cand = delta_prev[:, None] + logA  # [S,S]
            best = jnp.max(cand, 0)
            arg = jnp.argmax(cand, 0)
            delta = best + lb_t
            delta = jnp.where(m_t, delta, delta_prev)
            arg = jnp.where(m_t, arg, jnp.arange(S))
            return delta, (delta, arg)

        delta0 = logpi + x_logb[0]
        _, (deltas, args) = jax.lax.scan(step, delta0, (x_logb[1:], mask[1:]))
        deltas = jnp.concatenate([delta0[None], deltas], 0)
        args = jnp.concatenate([jnp.tile(jnp.arange(S)[None], (1, 1)), args], 0)

        last = jnp.sum(mask) - 1
        end_state = jnp.argmax(deltas[last])
        logprob = deltas[last, end_state]

        # Backtrace: state at t = args[t+1, state at t+1] for t+1 <= last;
        # padded positions carry end_state (sliced away by the caller).
        def bt(s, t):
            s_prev = jnp.where(t + 1 <= last, args[t + 1, s], s)
            return s_prev, s_prev

        ts = jnp.arange(T - 1)[::-1]  # t = T-2 .. 0
        _, path_rev = jax.lax.scan(bt, end_state, ts)
        path = jnp.concatenate([path_rev[::-1], end_state[None]])
        return path, logprob

    return jax.vmap(one)(logb, tmask)


def viterbi(model: GMMHMM, seqs: Sequence[np.ndarray]):
    """Most-likely state paths.  Returns list of (path ndarray, logprob)."""
    X, L = _pad_sequences(seqs)
    with np.errstate(divide="ignore"):
        logA = np.where(model.A > 0, np.log(np.maximum(model.A, 1e-300)),
                        -np.inf)
        logpi = np.where(model.pi > 0, np.log(np.maximum(model.pi, 1e-300)),
                         -np.inf)
    paths, lps = _viterbi_padded(
        jnp.asarray(X), jnp.asarray(L), jnp.asarray(logA), jnp.asarray(logpi),
        jnp.asarray(model.means), jnp.asarray(model.varis),
        jnp.asarray(model.weights))
    paths = np.asarray(paths)
    lps = np.asarray(lps)
    return [(paths[i, : L[i]], float(lps[i])) for i in range(len(seqs))]
