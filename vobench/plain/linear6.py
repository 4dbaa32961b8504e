"""Unrolled 6x6 SPD solve by Cholesky (port of ``solvers/linear6.py``).

Kept as the reference's straight-line code, operation for operation, so the
solve rounds exactly as the reference's does. Batched over leading dims: one
(B, 6, 6) solve is the same operations, each over the batch.
"""

from __future__ import annotations

import torch


def solve_spd6(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Solve A x = b for 6x6 SPD A (..., 6, 6), b (..., 6) via fully
    unrolled Cholesky.

    Singular/indefinite inputs produce non-finite outputs; callers guard
    with isfinite.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
