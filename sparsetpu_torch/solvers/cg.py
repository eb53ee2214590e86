"""Iterative solvers built on the SpMV (counterpart of
``sparsetpu/solvers/cg.py``).

Each solver takes ``spmv``, any callable y = A @ v on tensors:
``SparseMatrix.spmv``, ``BSRDevice.spmv``, or a user's own.  A tensor ``b``
keeps its device; anything else is placed on ``device`` (the card unless
the caller asks for the CPU).  The JAX package's ``lax.while_loop`` is a
Python loop here with the same condition, tested before each body, so the
iteration counts agree; reading that condition on the host costs one
scalar sync an iteration (a CUDA graph or a check every few iterations
would remove it, later work).  ``fori_loop`` is ``range``.

``cg_df64`` and ``pcg_df64`` open spans (``utils/timing.py:span``) while a
profiler runs: ``sparsetpu.cg`` (``pcg``) over the solve,
``sparsetpu.cg.iter`` over each pass of the loop, and inside it
``sparsetpu.cg.check`` over the host's read of the convergence test (its
``bool``), where the device drains; the SpMV's own spans nest in the
pass.  A solve that converges ends with a pass that holds its test alone.

Real types follow the reference: ``cg`` and ``bicgstab`` run in b's float
type (float32 or float64), ``pcg``, ``gmres``, ``power_iteration`` and
``jacobi_iteration`` in float32, and ``cg_df64``/``pcg_df64`` in float64,
the port's counterpart of the reference's DF64 pairs (there is no DF64
type here), with the reference's float32 convergence test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import require_device
from ..utils.timing import span


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor


def _vector(v, device, dtype=None) -> torch.Tensor:
    """``v`` as a 1-D tensor: a tensor keeps its device, anything else goes
    to ``device``; the real type is ``dtype``, else v's own float type
    (float32 for other types)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), device=require_device(device))
    if dtype is None:
        dtype = v.dtype if v.dtype in (torch.float32, torch.float64) \
            else torch.float32
    return v.to(dtype)


def _typed(f, dtype):
    """``f`` with its result in ``dtype`` (an operator of another real type
    still runs in its own)."""
    return lambda v: f(v).to(dtype)


def _start(b, x0) -> torch.Tensor:
    return torch.zeros_like(b) if x0 is None else \
        _vector(x0, b.device, b.dtype).to(b.device)


def _tol2(tol, b) -> torch.Tensor:
    """tol^2 * max(b.b, 1e-30) in b's real type."""
    return torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * \
        torch.clamp_min(torch.dot(b, b), 1e-30)


def _tol2_f32(tol, b) -> torch.Tensor:
    """The reference's df64 test: float32(tol)^2 * max(f32(b.b), 1e-30),
    in float32 (``cg.py:78-83``)."""
    return torch.tensor(tol, dtype=torch.float32, device=b.device) ** 2 * \
        torch.clamp_min(torch.dot(b, b).float(), 1e-30)


def cg(spmv: Callable[[torch.Tensor], torch.Tensor], b,
       x0=None, tol: float = 1e-6, maxiter: int = 1000, *,
       device="cuda") -> CGResult:
    """Conjugate gradients for SPD A."""
    b = _vector(b, device)
    x = _start(b, x0)
    spmv = _typed(spmv, b.dtype)
    r = b - spmv(x)
    p = r
    rs = torch.dot(r, r)
    tol2 = _tol2(tol, b)
    k = 0
    while k < maxiter and bool(rs > tol2):
        ap = spmv(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return CGResult(x, k, torch.sqrt(rs))


def cg_df64(spmv, b, x0=None, tol: float = 1e-12, maxiter: int = 1000, *,
            device="cuda") -> CGResult:
    """Conjugate gradients in float64 (the reference's df64 CG, its DOUBLE=1
    solve): x, r, p and every dot in float64, ``spmv`` an f64 matvec (e.g.
    ``SparseMatrix.spmv`` of an f64 config; a float32 result is widened).
    The stopping test is the reference's, in float32; ``residual_norm`` is
    float32."""
    with span("cg"):
        b = _vector(b, device, torch.float64)
        x = _start(b, x0)
        mv = _typed(spmv, torch.float64)
        r = b - mv(x)
        p = r
        rs = torch.dot(r, r)
        tol2 = _tol2_f32(tol, b)
        k = 0
        while k < maxiter:
            with span("cg.iter"):
                going = rs.float() > tol2
                with span("cg.check"):
                    if not bool(going):
                        break
                ap = mv(p)
                alpha = rs / torch.dot(p, ap)
                x = x + alpha * p
                r = r - alpha * ap
                rs_new = torch.dot(r, r)
                p = r + (rs_new / rs) * p
                rs = rs_new
                k += 1
        return CGResult(x, k, torch.sqrt(rs.float()))


def pcg_df64(spmv, b, m_inv, x0=None, tol: float = 1e-12,
             maxiter: int = 1000, *, device="cuda") -> CGResult:
    """Preconditioned CG in float64: ``cg_df64`` with ``m_inv`` applied to
    the residual each step (its result is widened to float64)."""
    with span("pcg"):
        b = _vector(b, device, torch.float64)
        x = _start(b, x0)
        spmv, m_inv = _typed(spmv, b.dtype), _typed(m_inv, b.dtype)
        r = b - spmv(x)
        z = m_inv(r)
        p = z
        rz = torch.dot(r, z)
        tol2 = _tol2_f32(tol, b)
        k = 0
        while k < maxiter:
            with span("pcg.iter"):
                going = torch.dot(r, r).float() > tol2
                with span("pcg.check"):
                    if not bool(going):
                        break
                ap = spmv(p)
                alpha = rz / torch.dot(p, ap)
                x = x + alpha * p
                r = r - alpha * ap
                z = m_inv(r)
                rz_new = torch.dot(r, z)
                p = z + (rz_new / rz) * p
                rz = rz_new
                k += 1
        return CGResult(x, k, torch.sqrt(torch.dot(r, r).float()))


def cg_step(spmv: Callable[[torch.Tensor], torch.Tensor]):
    """One CG iteration as a standalone step function."""

    def step(x, r, p, rs):
        ap = spmv(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new

    return step


def bicgstab(spmv: Callable[[torch.Tensor], torch.Tensor], b,
             x0=None, tol: float = 1e-6, maxiter: int = 1000, *,
             device="cuda") -> CGResult:
    """BiCGSTAB for general (non-symmetric) A."""
    b = _vector(b, device)
    x = _start(b, x0)
    spmv = _typed(spmv, b.dtype)
    r = b - spmv(x)
    rhat = r
    rho = alpha = omega = torch.tensor(1.0, dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    tol2 = _tol2(tol, b)
    k = 0
    while k < maxiter and bool(torch.dot(r, r) > tol2):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = spmv(p)
        alpha = rho_new / torch.dot(rhat, v)
        s = r - alpha * v
        t = spmv(s)
        omega = torch.dot(t, s) / torch.clamp_min(torch.dot(t, t), 1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        k += 1
    return CGResult(x, k, torch.linalg.norm(r))


def gmres(spmv: Callable[[torch.Tensor], torch.Tensor], b,
          x0=None, restart: int = 30, tol: float = 1e-6,
          maxiter: int = 1000, *, device="cuda") -> CGResult:
    """Restarted GMRES(m) for general A, in float32.  The small (m+1, m)
    least-squares solve is the reference's ``jnp.linalg.lstsq``: a
    min-norm solve through the SVD, singular values below eps * (m+1)
    times the largest dropped, so a cycle whose Krylov space breaks down
    (a zero ``hnext``) still solves.  ``iterations`` counts Arnoldi steps,
    m a cycle."""
    b = _vector(b, device, torch.float32)
    n, m = b.shape[0], int(restart)
    x = _start(b, x0)
    spmv = _typed(spmv, torch.float32)
    bnorm = torch.clamp_min(torch.linalg.norm(b), 1e-30)
    rcond = float(torch.finfo(torch.float32).eps) * (m + 1)

    def cycle(x):
        r = b - spmv(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros(m + 1, n, dtype=torch.float32, device=b.device)
        V[0] = r / torch.clamp_min(beta, 1e-30)
        H = torch.zeros(m + 1, m, dtype=torch.float32, device=b.device)
        for j in range(m):
            w = spmv(V[j])
            # modified Gram-Schmidt against the basis so far (the
            # reference's rows past j are zero: its extra dots are no-ops)
            for i in range(j + 1):
                h = torch.dot(V[i], w)
                w = w - h * V[i]
                H[i, j] = h
            hnext = torch.linalg.norm(w)
            H[j + 1, j] = hnext
            V[j + 1] = w / torch.clamp_min(hnext, 1e-30)
        u, s, vh = torch.linalg.svd(H, full_matrices=False)
        keep = (s > 0) & (s >= rcond * s[0])
        s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
        y = vh.T @ (s_inv * (u[0] * beta))      # u.T @ (beta * e1)
        return x + V[:m].T @ y

    k = 0
    while k < maxiter and bool(
            torch.linalg.norm(b - spmv(x)) / bnorm > tol):
        x = cycle(x)
        k += m
    return CGResult(x, k, torch.linalg.norm(b - spmv(x)))


def power_iteration(spmv, n, iters: int = 50, seed: int = 0, *,
                    device="cuda"):
    """Dominant eigenvalue estimate: (v.A v, v) after ``iters`` normalised
    products.  v0 is drawn from a ``torch.Generator`` seeded with ``seed``
    (not the reference's ``jax.random`` draw)."""
    dev = require_device(device)
    spmv = _typed(spmv, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    v = torch.randn(n, generator=gen, device=dev)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = spmv(v)
        v = w / torch.linalg.norm(w)
    return torch.dot(v, spmv(v)), v


def pcg(spmv: Callable[[torch.Tensor], torch.Tensor], b,
        m_inv: Callable[[torch.Tensor], torch.Tensor],
        x0=None, tol: float = 1e-6, maxiter: int = 1000, *,
        device="cuda") -> CGResult:
    """Preconditioned CG in float32: ``m_inv`` applies the preconditioner
    inverse (e.g. ``jacobi_preconditioner(A)``); stops at ||r|| / ||b|| <=
    tol."""
    b = _vector(b, device, torch.float32)
    x = _start(b, x0)
    spmv, m_inv = _typed(spmv, b.dtype), _typed(m_inv, b.dtype)
    r = b - spmv(x)
    z = m_inv(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.clamp_min(torch.linalg.norm(b), 1e-30)
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) / bnorm > tol):
        ap = spmv(p)
        alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x, k, torch.linalg.norm(r))


def jacobi_preconditioner(matrix, *, device="cuda") -> Callable:
    """Diagonal (Jacobi) preconditioner from a CSRMatrix: z = r / diag(A).

    Zero / missing diagonal entries fall back to 1 (identity on those
    rows).  The inverse diagonal is rounded to float32, as the reference
    keeps it, and applied in r's real type."""
    n = matrix.nr_rows
    diag = np.zeros(n, dtype=np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(matrix.row_ptr).astype(np.int64))
    on_diag = rows == matrix.col_ind
    np.add.at(diag, rows[on_diag], matrix.values[on_diag])
    diag = np.where(diag == 0.0, 1.0, diag)
    inv = torch.as_tensor((1.0 / diag).astype(np.float32),
                          device=require_device(device))
    return lambda r: r * inv.to(r.dtype)


def jacobi_iteration(spmv, matrix, b, iters: int = 100, omega: float = 1.0,
                     *, device="cuda") -> torch.Tensor:
    """Weighted Jacobi relaxation x_{k+1} = x_k + omega D^-1 (b - A x_k),
    float32, from x_0 = 0."""
    b = _vector(b, device, torch.float32)
    spmv = _typed(spmv, b.dtype)
    m_inv = jacobi_preconditioner(matrix, device=b.device)
    x = torch.zeros_like(b)
    for _ in range(iters):
        x = x + omega * m_inv(b - spmv(x))
    return x
