"""The batched factorization primitives of the structured KKT backend
(solvers/block_tridiag.py) against numpy float64 references, at the block
sizes the transcribed problems produce (8, 24 = stochastic OPF scenario
blocks, 64 = the quadrotor band), in float64 and float32.

The same checks run on the card at the full quad-1000 / opf-1000 geometry
as phase 1 of ``chip_smoke.py``; the tolerances are the ones defined there.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from chip_smoke import PRIM_RTOL, band_solve_ref, spd_band, _rel
from infiniteexamodels_jax.solvers.block_tridiag import (
    _apply_inv, _bcr_factor, _bcr_solve, _chol_linv, _lsolve)

BS = [8, 24, 64]
DTYPES = [jnp.float64, jnp.float32]


def _nb(bs):
    # several BCR levels, an odd count (the uneven split), small enough
    # for a quick CPU run
    return 13 if bs < 64 else 9


@pytest.mark.parametrize("dt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("bs", BS)
def test_chol_linv_matches_numpy(bs, dt):
    D, _ = spd_band(_nb(bs), bs, seed=bs)
    L, Linv, ok = _chol_linv(jnp.asarray(D, dt))
    assert bool(ok)
    assert L.dtype == dt and Linv.dtype == dt
    L_ref = np.linalg.cholesky(D)
    tol = PRIM_RTOL[jnp.dtype(dt).name]
    assert _rel(L, L_ref) <= tol
    assert _rel(Linv, np.linalg.inv(L_ref)) <= tol
    assert np.allclose(np.triu(np.asarray(Linv), 1), 0.0)


@pytest.mark.parametrize("dt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("bs", BS)
def test_lsolve_matches_numpy(bs, dt):
    nb = _nb(bs)
    D, _ = spd_band(nb, bs, seed=bs + 1)
    X = np.random.default_rng(bs).standard_normal((nb, bs, 5))
    L, _, _ = _chol_linv(jnp.asarray(D, dt))
    W = _lsolve(L, jnp.asarray(X, dt))
    W_ref = np.linalg.solve(np.linalg.cholesky(D), X)
    assert _rel(W, W_ref) <= PRIM_RTOL[jnp.dtype(dt).name]


@pytest.mark.parametrize("dt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("bs", BS)
def test_bcr_factor_solve_matches_block_thomas(bs, dt):
    nb = _nb(bs)
    D, E = spd_band(nb, bs, seed=bs + 2)
    rng = np.random.default_rng(bs + 3)
    b = rng.standard_normal((nb, bs))
    B = rng.standard_normal((nb, bs, 3))
    levels, root, ok = _bcr_factor(jnp.asarray(D, dt), jnp.asarray(E, dt))
    assert bool(ok)
    tol = PRIM_RTOL[jnp.dtype(dt).name]
    x = _bcr_solve(levels, root, jnp.asarray(b, dt))
    assert x.shape == (nb, bs)
    assert _rel(x, band_solve_ref(D, E, b)) <= tol
    # matrix right-hand side (the arrowhead border's Z = T^-1 B)
    X = _bcr_solve(levels, root, jnp.asarray(B, dt))
    X_ref = np.stack([band_solve_ref(D, E, B[..., j]) for j in range(3)],
                     axis=-1)
    assert _rel(X, X_ref) <= tol


@pytest.mark.parametrize("dt", DTYPES, ids=["f64", "f32"])
def test_indefinite_block_reports_not_ok(dt):
    """The inertia-correction ladder reads a failed factorization from
    non-finite output: one indefinite block must flip ``ok`` in both the
    batched Cholesky and the band BCR, and leave the other blocks
    finite."""
    D, E = spd_band(11, 24, seed=5)
    D[6] = -np.eye(24)
    L, Linv, ok = _chol_linv(jnp.asarray(D, dt))
    assert not bool(ok)
    Linv = np.asarray(Linv)
    assert not np.isfinite(Linv[6]).all()
    assert np.isfinite(np.delete(Linv, 6, axis=0)).all()
    _, _, okb = _bcr_factor(jnp.asarray(D, dt), jnp.asarray(E, dt))
    assert not bool(okb)


@pytest.mark.parametrize("dt", DTYPES, ids=["f64", "f32"])
def test_block_diag_factor_solve(dt):
    """Scenario mode: batched Cholesky + explicit inverse, then D^-1 B as
    two batched matmuls (the arrowhead's Z)."""
    D, _ = spd_band(40, 24, seed=7)
    B = np.random.default_rng(8).standard_normal((40, 24, 6))
    _, Linv, ok = _chol_linv(jnp.asarray(D, dt))
    assert bool(ok)
    Z = _apply_inv(Linv, jnp.asarray(B, dt))
    assert _rel(Z, np.linalg.solve(D, B)) <= PRIM_RTOL[jnp.dtype(dt).name]
