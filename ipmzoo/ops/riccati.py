"""Block-tridiagonal KKT factor/solve via Riccati recursion.

The Newton system of an optimal-control (MPC) QP is block-tridiagonal:
eliminating it stage-by-stage from the terminal cost backwards is the
discrete-time Riccati recursion, an O(T (ns+nu)^3) direct factorisation
of a system the dense path would treat as O((T nu)^3).  This is the
structured counterpart of the symbolic Gaussian elimination the
framework performs on the formulation's augmented system
(/root/reference/src/SymbolicOptimization.cpp:529-567): the same
last-row-first elimination, executed at the block level over the time
axis with a ``lax.scan`` — the idiomatic device mapping (static shapes, a
batched small-matrix chain the compiler pipelines; ``vmap`` adds the
instance batch axis).

System solved (Deltas of the IPM Newton step; ``x0`` is fixed so
``dx_0 = 0``):

    minimize  sum_k 1/2 dx_k' Qt_k dx_k + rx_k' dx_k
                  + 1/2 du_k' Rt_k du_k + ru_k' du_k      (k = 0..T-1,
    subject to dx_{k+1} = A_k dx_k + B_k du_k + d_k        x-index 1..T)

with value function V_k(dx) = 1/2 dx' P_k dx + p_k' dx:

    P_T = Qt_T,                 p_T = rx_T
    F_k = Rt_k + B_k' P_{k+1} B_k          (Cholesky; SPD for the
    K_k = -F_k^{-1} B_k' P_{k+1} A_k        quasi-definite IPM systems)
    P_k = Qt_k + A_k' P_{k+1} A_k + A_k' P_{k+1} B_k K_k
    k_k = -F_k^{-1} (ru_k + B_k' (P_{k+1} d_k + p_{k+1}))
    p_k = rx_k + A_k' (P_{k+1} (B_k k_k + d_k) + p_{k+1})

``factor`` computes the rhs-independent (P, chol F, K) chain once per
IPM iteration; predictor and corrector both reuse it through ``solve``
(mirroring the factor-once/solve-twice structure of the dense path,
/root/reference/src/NumericalOptimization/Optimizer.cpp:137-212).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular


class RiccatiFactors(NamedTuple):
    """Rhs-independent elimination chain (leading axis = stage k)."""
    chol_F: jnp.ndarray   # (T, nu, nu) lower Cholesky of Rt + B'P'B
    K: jnp.ndarray        # (T, nu, ns) feedback gains
    P_next: jnp.ndarray   # (T, ns, ns) P_{k+1} used at stage k


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def riccati_factor(Qt: jnp.ndarray, Rt: jnp.ndarray, A: jnp.ndarray,
                   B: jnp.ndarray) -> RiccatiFactors:
    """Backward elimination of the block-tridiagonal KKT matrix.

    Qt: (T, ns, ns) cost Hessians of x_1..x_T (Qt[-1] is terminal).
    Rt: (T, nu, nu) cost Hessians of u_0..u_{T-1}.
    A, B: (T, ns, ns), (T, ns, nu) dynamics of stages 0..T-1.
    """
    T = Rt.shape[0]
    P_T = _sym(Qt[T - 1])

    # Stage k consumes Qt of x_k: zero for k = 0 (x_0 fixed), Qt[k-1] else.
    Qt_stage = jnp.concatenate([jnp.zeros_like(Qt[:1]), Qt[:T - 1]], axis=0)

    def body(P_next, inputs):
        Qk, Rk, Ak, Bk = inputs
        M = P_next @ Bk                                   # (ns, nu)
        F = Rk + Bk.T @ M                                 # (nu, nu) SPD
        Lf = jnp.linalg.cholesky(F)
        K = -cho_solve((Lf, True), M.T @ Ak)              # (nu, ns)
        P = _sym(Qk + Ak.T @ P_next @ Ak + (Ak.T @ M) @ K)
        return P, (Lf, K, P_next)

    inputs = (Qt_stage[::-1], Rt[::-1], A[::-1], B[::-1])
    _, (Lf, K, P_next) = jax.lax.scan(body, P_T, inputs)
    return RiccatiFactors(chol_F=Lf[::-1], K=K[::-1], P_next=P_next[::-1])


def riccati_solve(factors: RiccatiFactors, A: jnp.ndarray, B: jnp.ndarray,
                  rx: jnp.ndarray, ru: jnp.ndarray, d: jnp.ndarray):
    """Solve for one right-hand side using a precomputed factor chain.

    rx: (T, ns) linear residuals of x_1..x_T; ru: (T, nu) of u_0..u_{T-1};
    d: (T, ns) dynamics-constraint offsets (dx_{k+1} = A dx + B du + d).

    Returns (dx, du, dy): dx (T, ns) for x_1..x_T, du (T, nu),
    dy (T, ns) dynamics duals, with dy_k = -(P_{k+1} dx_{k+1} + p_{k+1}).
    """
    T = ru.shape[0]
    p_T = rx[T - 1]
    rx_stage = jnp.concatenate([jnp.zeros_like(rx[:1]), rx[:T - 1]], axis=0)

    def backward(p_next, inputs):
        rxk, ruk, dk, Ak, Bk, Lf, P_next = inputs
        w = P_next @ dk + p_next                       # (ns,)
        kk = -cho_solve((Lf, True), ruk + Bk.T @ w)    # (nu,)
        p = rxk + Ak.T @ (P_next @ (Bk @ kk + dk) + p_next)
        return p, (kk, p_next)

    inputs = (rx_stage[::-1], ru[::-1], d[::-1], A[::-1], B[::-1],
              factors.chol_F[::-1], factors.P_next[::-1])
    _, (kk, p_next) = jax.lax.scan(backward, p_T, inputs)
    kk, p_next = kk[::-1], p_next[::-1]

    def forward(dx, inputs):
        Ak, Bk, Kk, kk_k, dk, P_next, p_next_k = inputs
        du = Kk @ dx + kk_k
        dx_next = Ak @ dx + Bk @ du + dk
        dy = -(P_next @ dx_next + p_next_k)
        return dx_next, (dx_next, du, dy)

    dx0 = jnp.zeros_like(rx[0])
    _, (dx, du, dy) = jax.lax.scan(
        forward, dx0, (A, B, factors.K, kk, d, factors.P_next, p_next))
    return dx, du, dy


def riccati_kkt_dense(Qt, Rt, A, B):
    """Materialise the block-tridiagonal KKT matrix densely (testing).

    Variable order: (dx_1..dx_T, du_0..du_{T-1}, dy_0..dy_{T-1}); rows are
    (x-stationarity, u-stationarity, dynamics).  Solving the dense system
    with [rx; ru; -d] as the negated rhs must match ``riccati_solve``.
    """
    T, ns = A.shape[0], A.shape[1]
    nu = B.shape[2]
    nx, nU, nY = T * ns, T * nu, T * ns
    N = nx + nU + nY
    Kmat = jnp.zeros((N, N), Qt.dtype)

    def X(k):   # slice of dx_k, k = 1..T
        return slice((k - 1) * ns, k * ns)

    def U(k):
        return slice(nx + k * nu, nx + (k + 1) * nu)

    def Y(k):
        return slice(nx + nU + k * ns, nx + nU + (k + 1) * ns)

    for k in range(1, T + 1):
        Kmat = Kmat.at[X(k), X(k)].set(Qt[k - 1])
        Kmat = Kmat.at[X(k), Y(k - 1)].set(jnp.eye(ns, dtype=Qt.dtype))
        if k <= T - 1:
            Kmat = Kmat.at[X(k), Y(k)].set(-A[k].T)
    for k in range(T):
        Kmat = Kmat.at[U(k), U(k)].set(Rt[k])
        Kmat = Kmat.at[U(k), Y(k)].set(-B[k].T)
    for k in range(T):
        Kmat = Kmat.at[Y(k), X(k + 1)].set(jnp.eye(ns, dtype=Qt.dtype))
        if k >= 1:
            Kmat = Kmat.at[Y(k), X(k)].set(-A[k])
        Kmat = Kmat.at[Y(k), U(k)].set(-B[k])
    return Kmat
