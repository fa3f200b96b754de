"""Non-linear QoI post-processing: the XGC Lagrange optimizer.

A JAX counterpart of the reference's lambda example
(reference: examples/lambda/LagrangeOptimizer.cpp:142-540 —
computeLagrangeParameters): after lossy reconstruction of an XGC ion
distribution f(plane, node, vx, vy), enforce EXACT preservation of the
four velocity-space moments the physics cares about — density D,
parallel velocity U, perpendicular temperature Tperp and parallel
energy Rpara — by a multiplicative Bregman correction

    f_breg = f_rec * exp(-(l0*V1 + l1*V2 + l2*V3 + l3*V4))

with one lambda in R^4 per (plane, node), found by Newton's method on
the moment-matching equations (gradient = target moments - breg
moments, Hessian H[a,b] = sum f_rec * V_a * V_b * exp(-K); reference
loop at LagrangeOptimizer.cpp:312-515, maxIter=50, unconverged nodes
fall back to lambda=0).

The translation replaces the reference's OpenMP-parallel per-node
while(1) loop with ONE jitted program: all (plane, node) systems run as
a vmapped batch, the Newton iteration is a lax.fori_loop with per-node
convergence freezing (compiler-friendly fixed trip count instead of
data-dependent exit), and the 4x4 solves are a batched
jnp.linalg.solve. The moment reductions contract the vx*vy axis of the
whole batch at once.
"""

import numpy as np

import mgard_tpu


def make_xgc4d(planes=4, nodes=192, nvx=33, nvy=33, seed=7):
    """Synthetic ion distribution + velocity-mesh tables (stand-ins for
    the reference's readF0Params mesh file: volume, vth, vp, mu)."""
    rng = np.random.default_rng(seed)
    vp = np.linspace(-3, 3, nvy)                      # parallel velocity
    mu = np.linspace(0, 3, nvx) ** 2                  # magnetic moment
    temp = 1.0 + 0.3 * np.sin(np.linspace(0, 3, nodes))
    vth = np.sqrt(temp)
    MU, VP = np.meshgrid(mu, vp, indexing="ij")       # (nvx, nvy)
    maxw = np.exp(-(0.5 * VP**2 + 0.5 * MU)[None] / temp[:, None, None])
    f = np.empty((planes, nodes, nvx, nvy))
    for p in range(planes):
        turb = 1.0 + 0.05 * np.sin(
            2 * np.pi * (2 * p / planes) + np.linspace(0, 6, nodes)
        )
        f[p] = maxw * turb[:, None, None]
    f += np.abs(rng.normal(0, 1e-4, f.shape))
    vol = np.broadcast_to(
        (0.5 + 0.5 * np.cos(np.linspace(0, 1, nodes)))[:, None],
        (nodes, nvx * nvy),
    ).copy()
    return f, vol, vth, vp, mu


def lagrange_optimize(f_rec, f_orig, vol, vth, vp, mu,
                      mass=1.0, charge=1.0, max_iter=50):
    """Return (f_breg, lambdas (P, N, 4), qoi_err_before, qoi_err_after).

    Moment definitions follow LagrangeOptimizer.cpp:184-247 (V2/V3/V4
    tables and the D/U/Tperp/Rpara accumulations)."""
    import jax
    import jax.numpy as jnp

    P, N, nvx, nvy = f_rec.shape
    nv = nvx * nvy
    eps = float(np.finfo(np.float64).tiny)
    # reference clamps non-positive reconstructed values to epsilon
    # (LagrangeOptimizer.cpp:149-153)
    rec = jnp.maximum(jnp.asarray(f_rec, jnp.float64).reshape(P * N, nv), 1e-300)
    org = jnp.asarray(f_orig, jnp.float64).reshape(P * N, nv)

    # per-node integration tables V1..V4 (LagrangeOptimizer.cpp:184-192)
    volj = jnp.asarray(np.tile(vol, (P, 1)), jnp.float64)        # (P*N, nv)
    vthj = jnp.asarray(np.tile(vth, P), jnp.float64)[:, None]    # (P*N, 1)
    vpj = jnp.asarray(np.tile(vp[None, :], (nvx, 1)).ravel())    # (nv,)
    muj = jnp.asarray(np.tile(mu[:, None], (1, nvy)).ravel())    # (nv,)
    V1 = volj
    V2 = volj * vthj * vpj[None, :]
    V3 = volj * 0.5 * muj[None, :] * vthj**2 * mass
    V4 = volj * vpj[None, :] ** 2 * vthj**2 * mass
    V = jnp.stack([V1, V2, V3, V4], axis=1)  # (P*N, 4, nv)

    def moments(g):
        """(P*N, nv) -> (P*N, 4) raw moment integrals."""
        return jnp.einsum("bkv,bv->bk", V, g)

    target = moments(org)  # the conserved quantities (unnormalized)
    # Per-moment magnitude scale for convergence/reporting, like the
    # reference's test against (max-moment * 1e-9)^2 rather than the
    # per-node value (U integrates an odd function and can be ~0).
    scale = jnp.maximum(jnp.max(jnp.abs(target), axis=0), eps)  # (4,)

    @jax.jit
    def solve():
        lam0 = jnp.zeros((P * N, 4), jnp.float64)
        done0 = jnp.zeros((P * N,), bool)

        def step(_, carry):
            lam, done = carry
            K = jnp.einsum("bk,bkv->bv", lam, V)
            w = rec * jnp.exp(-K)
            g = target - moments(w)                       # (P*N, 4)
            H = jnp.einsum("bkv,blv,bv->bkl", V, V, w)    # (P*N, 4, 4)
            # Newton on F(lam) = moments(w) - target: dF/dlam = -H, so
            # the update is lam <- lam - H^{-1} g with g = target - F.
            delta = -jnp.linalg.solve(
                H + 1e-300 * jnp.eye(4)[None], g[:, :, None]
            )[:, :, 0]
            # singular/overflowed systems abandon the node with lambda=0,
            # like the reference's determinant==0 bailout
            # (LagrangeOptimizer.cpp:484-495)
            bad = ~(jnp.abs(jnp.linalg.det(H)) > 1e-300) | ~jnp.all(
                jnp.isfinite(delta), axis=1
            )
            # moment residual against the per-moment scale (the reference
            # tests squared moment errors against (max*1e-9)^2)
            res = jnp.max(jnp.abs(g) / scale[None, :], axis=1)
            conv = res < 1e-9
            lam = jnp.where(bad[:, None] & ~done[:, None], 0.0, lam)
            lam = jnp.where(
                (done | conv | bad)[:, None], lam, lam + delta
            )
            return lam, done | conv | bad

        lam, done = jax.lax.fori_loop(0, max_iter, step, (lam0, done0))
        # nodes that never converged keep the plain reconstruction
        # (lambda = 0), mirroring LagrangeOptimizer.cpp:393-414
        lam = jnp.where(done[:, None], lam, 0.0)
        K = jnp.einsum("bk,bkv->bv", lam, V)
        breg = rec * jnp.exp(-K)
        err_b = jnp.max(jnp.abs(moments(rec) - target) / scale[None, :])
        err_a = jnp.max(jnp.abs(moments(breg) - target) / scale[None, :])
        return breg, lam, done, err_b, err_a

    breg, lam, done, err_b, err_a = solve()
    return (
        np.asarray(breg).reshape(P, N, nvx, nvy),
        np.asarray(lam).reshape(P, N, 4),
        int(np.asarray(done).sum()),
        float(err_b),
        float(err_a),
    )


if __name__ == "__main__":
    f, vol, vth, vp, mu = make_xgc4d()
    v = f.astype(np.float32)
    blob, st = mgard_tpu.compress(v, tol=1e-3, s=np.inf)
    rec, _ = mgard_tpu.decompress(blob)
    breg, lam, n_conv, err_b, err_a = lagrange_optimize(
        rec.astype(np.float64), f, vol, vth, vp, mu
    )
    P, N = f.shape[:2]
    pd_rmse_rec = float(np.sqrt(np.mean((rec - f) ** 2)))
    pd_rmse_breg = float(np.sqrt(np.mean((breg - f) ** 2)))
    print(f"ratio {v.nbytes/len(blob):.1f}, nodes converged {n_conv}/{P*N}")
    print(f"max relative moment error: before {err_b:.2e} -> after {err_a:.2e}")
    print(f"pointwise RMSE: recon {pd_rmse_rec:.2e}, breg {pd_rmse_breg:.2e}")
    print(f"side-channel size: {lam.nbytes} bytes "
          f"({lam.nbytes / v.nbytes * 100:.2f}% of the field)")
