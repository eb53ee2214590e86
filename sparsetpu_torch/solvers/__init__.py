from .cg import (CGResult, bicgstab, cg, cg_df64, cg_step, gmres,
                 jacobi_iteration, jacobi_preconditioner, pcg, pcg_df64,
                 power_iteration)

__all__ = [
    "CGResult", "bicgstab", "cg", "cg_df64", "cg_step", "gmres",
    "jacobi_iteration", "jacobi_preconditioner", "pcg", "pcg_df64",
    "power_iteration",
]
