"""The work of K2 (``kl_dual_fused_cert``): its operations and bytes for one
launch, from the shapes and the fixed schedule.

Frozen copy of ``k1_ops_per_coord`` and ``k2_ops64_per_coord`` in
``cvx_tpu_torch/_bench.py`` at commit
61015afd76d76d8ead80eef8352088353340c2cc.  The counts were read off the
plain version of the kernels: a fixed schedule of ``n_steps`` f32 Newton
steps, each evaluating all ``n_ls`` line-search candidates and one
fallback candidate, then ``polish_steps`` f64 Newton steps and the f64
certificate.  Nothing in the schedule depends on the data, so the count is
exact for any inputs.  An exp or log counts as one operation at the float
peak (a libm expf is some ten instructions), so the count errs low and the
share it gives errs low.
"""

from .peaks import least_seconds

# the certified route's schedule (``DistKL.solve_certified_batch``
# defaults, which ``kl_dual_fused_cert`` runs)
N_STEPS, POLISH_STEPS, N_LS = 16, 2, 5
F32, F64 = 4, 8


def k1_ops_per_coord(dim, n_steps, n_ls=N_LS):
    step = dim * dim + 7 * dim + 8 + 3 * n_ls
    if dim > 8:                      # the projected full-step candidate
        step += 2 * dim + 4
    return n_steps * step + 2 * dim + 9   # + the epilogue (x, gap)


def k2_ops64_per_coord(dim, k, m_eq, polish_steps=POLISH_STEPS):
    polish = dim * dim + 3 * dim + 2
    cert = 2 * dim + 8 + 2 * k + 2 * m_eq
    return polish_steps * polish + cert


def k2_launch(B, n, k, m_eq=0):
    """(ops32, ops64, bytes) of one K2 launch over B instances of n
    coordinates, k shared inequality rows and m_eq extra equality rows:
    the shared rows (f32) and the f64 log prior read once, the per-instance
    bounds read once, x (f64), z and the three certificate leaves written
    once."""
    dim = k + 1 + m_eq
    ops32 = B * n * k1_ops_per_coord(dim, N_STEPS)
    ops64 = B * n * k2_ops64_per_coord(dim, k, m_eq)
    nbytes = ((k + m_eq) * n * F32 + B * (k + m_eq) * F32 + n * F64
              + B * n * F64 + B * dim * F64 + 3 * B * F64)
    return ops32, ops64, nbytes


def k2_least_seconds(B, n, k, m_eq=0):
    ops32, ops64, nbytes = k2_launch(B, n, k, m_eq)
    return least_seconds(nbytes, ops32=ops32, ops64=ops64)
