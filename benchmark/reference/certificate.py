"""The f64 host certificate of a batch of KL iterates.

Frozen copy of ``kl_gap_certificate_np`` in
``cvx_tpu_torch/diagnostics.py`` at commit
61015afd76d76d8ead80eef8352088353340c2cc (NumPy only).  The harness holds
the reference's own optimum to it: a certified gap of the reference's x
near rounding says the enumeration found the optimum.
"""

import numpy as np


def kl_gap_certificate(X, H, u, steps: int = 10, prior=None):
    """Batched HOST-side (numpy f64) duality-gap certificate for KL
    instances — the honesty check, outside any timed region.

    ``X`` (batch, n) returned iterates; ``H`` (k, n) shared scenario rows;
    ``u`` (batch, k) per-instance bounds.  The sum-to-one equality row is
    implied.  Least-squares dual fit + active-set projected-Newton polish
    on the closed-form dual -g(z) (each accepted step improves a valid
    bound), then gap_i = f(x_i) - g(z_i) <= f(x_i) - p*_i.  Returns (batch,)
    gaps.
    """
    X = np.asarray(X, np.float64)
    # coordinates that underflowed to exactly 0 would give log(0) = -inf
    # and NaN-poison the whole instance; x log(n x) -> 0 as x -> 0+, so
    # clamping to a tiny positive value changes f(x) by < 1e-28
    X = np.maximum(X, 1e-30)
    Hf = np.asarray(H, np.float64)
    batch, n = X.shape
    # general prior (None = the reference's uniform): R = p/e and
    # log(n x) becomes log x - log p throughout
    if prior is None:
        logp = np.full(n, -np.log(n))
        R = np.full(n, 1.0 / n) / np.e
    else:
        p = np.asarray(prior, np.float64)
        logp = np.log(p)
        R = p / np.e
    k = Hf.shape[0]
    dim = k + 1
    B = np.vstack([Hf, np.ones((1, n))])           # (k+1, n)
    W = np.column_stack([np.asarray(u, np.float64),
                         np.ones(batch)])          # (batch, k+1)
    C = -(1.0 + np.log(X) - logp[None, :])
    Z = C @ np.linalg.pinv(B.T).T                  # lstsq fit
    Z[:, :k] = np.clip(Z[:, :k], 0.0, None)

    def neg_g(Z_):
        return (np.sum(W * Z_, axis=1)
                + np.sum(np.exp(-(Z_ @ B)) * R[None, :], axis=1))

    def project(Z_):
        out = Z_.copy()
        out[:, :k] = np.clip(out[:, :k], 0.0, None)
        return out

    f0 = neg_g(Z)
    eye = np.eye(dim)
    eps = np.finfo(np.float64).eps
    for _ in range(steps):
        # pre-snap positive-but-below-rounding lam to exactly 0 so the
        # active-set freeze can see it
        tiny = 64.0 * eps * (1.0 + np.max(np.abs(Z), axis=1, keepdims=True))
        Z[:, :k] = np.where(Z[:, :k] <= tiny, 0.0, Z[:, :k])
        Y = np.exp(-(Z @ B)) * R[None, :]
        grad = W - Y @ B.T
        at_bound = np.zeros((batch, dim), bool)
        at_bound[:, :k] = (Z[:, :k] <= 0.0) & (grad[:, :k] > 0.0)
        freef = (~at_bound).astype(np.float64)
        gf = np.where(at_bound, 0.0, grad)
        Hd = np.einsum("bn,in,jn->bij", Y, B, B)
        Hd = (Hd * freef[:, :, None] * freef[:, None, :]
              + np.einsum("bi,ij->bij", 1.0 - freef, eye))
        Hd += (1e-12 * np.trace(Hd, axis1=1, axis2=2)[:, None, None] / dim
               + 1e-300) * eye
        dZ = -np.linalg.solve(Hd, gf[..., None])[..., 0]
        neg = np.zeros((batch, dim), bool)
        neg[:, :k] = dZ[:, :k] < 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            t_bd = np.min(np.where(neg, -Z / np.where(neg, dZ, -1.0),
                                   np.inf), axis=1)
        t_bd = np.clip(np.nan_to_num(t_bd, nan=1.0, posinf=1.0), 0.0, 1.0)
        took = np.zeros(batch, bool)
        for tc in [None, 1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125]:
            t_arr = t_bd[:, None] if tc is None else tc
            Zt = project(Z + t_arr * dZ)
            ft = neg_g(Zt)
            acc = ~took & np.isfinite(ft) & (ft < f0)
            Z[acc] = Zt[acc]
            f0[acc] = ft[acc]
            took |= acc
    primal = np.sum(X * (np.log(X) - logp[None, :]), axis=1)
    return primal - (-f0)
