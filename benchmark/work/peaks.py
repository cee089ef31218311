"""The card's published peaks and the least time a piece of work can take.

Frozen copy of the peak table and of ``bound`` in
``cvx_tpu_torch/_bench.py`` at commit 61015afd76d76d8ead80eef8352088353340c2cc,
kept here so that the yardstick does not move with the program.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit.  f32 and f64 outside the tensor cores, f64 on them for work shaped
like a matrix product.  A card set below 700 W runs slower; the run
records the card's power limit beside every share.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
F64_TC_OPS_PER_S = 67e12


def least_seconds(nbytes, ops32=0.0, ops64=0.0, ops64_tc=0.0):
    """(least seconds, what sets it): the bytes at the HBM rate against the
    operations at the peak for their type, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops32 / F32_OPS_PER_S + ops64 / F64_OPS_PER_S
             + ops64_tc / F64_TC_OPS_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
