"""Structured (block-tridiagonal + arrowhead) KKT backend tests: parity with
the dense backend and correctness of factor/solve/matvec."""
import numpy as np
import jax.numpy as jnp
import pytest

from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.solvers import IpmSolver, DenseKKT
from infiniteexamodels_jax.solvers.block_tridiag import (
    BlockTridiagKKT, make_structured_kkt)
from infiniteexamodels_jax.models import hovercraft, farmer
from infiniteexamodels_jax.transcribe import transcribe


def _linear_system_parity(model):
    """assemble/factor/solve of both backends must agree."""
    dense = DenseKKT(model)
    bt = BlockTridiagKKT(model, min_blocks=2, max_block=2048)
    assert bt.usable
    x = model.x0 + 0.01
    lam = jnp.ones(model.ncon) * 0.1
    d = jnp.ones(model.ncon) * 2.0
    diag = jnp.ones(model.nvar) * 3.0
    Kd = dense.assemble(x, model.theta, lam, 1.0, d, diag)
    Kb = bt.assemble(x, model.theta, lam, 1.0, d, diag)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=model.nvar))
    # matvec parity
    np.testing.assert_allclose(np.asarray(bt.matvec(Kb, v)),
                               np.asarray(Kd @ v), rtol=1e-10, atol=1e-8)
    # solve parity (dense K is SPD thanks to the diagonal shift)
    fd, okd = dense.factor(Kd)
    fb, okb = bt.factor(Kb)
    assert bool(okd) and bool(okb)
    rhs = jnp.asarray(rng.normal(size=model.nvar))
    np.testing.assert_allclose(np.asarray(bt.solve(fb, rhs)),
                               np.asarray(dense.solve(fd, rhs)),
                               rtol=1e-8, atol=1e-8)


def test_block_kkt_parity_hovercraft():
    m = hovercraft(num_supports=41)
    simd, _ = transcribe(m)
    _linear_system_parity(simd)


def test_block_kkt_parity_farmer():
    # scenario block-diagonal + first-stage arrowhead border
    m = farmer(num_scenarios=64)
    simd, _ = transcribe(m)
    _linear_system_parity(simd)


def test_ipm_with_block_kkt_matches_dense():
    m = hovercraft(num_supports=41)
    m.set_transformation_backend(ExaTranscriptionBackend(IpmSolver))
    m.set_silent()
    res_dense = m.optimize()
    assert res_dense.status == "first_order"

    m2 = hovercraft(num_supports=41)
    m2.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, linear_solver="auto"))
    m2.set_silent()
    res_bt = m2.optimize()
    assert res_bt.status == "first_order"
    # both runs are tol=1e-8 first_order certificates of *different*
    # factorization routes; their objectives agree only to O(tol)
    assert res_bt.objective == pytest.approx(res_dense.objective, abs=1e-7)
    np.testing.assert_allclose(res_bt.solution, res_dense.solution,
                               atol=1e-6)


def test_ipm_with_native_ldl_matches_dense():
    """The native C++ sparse LDL^T path (the reference's MA27-role CPU
    factorization) reproduces the device path."""
    m = hovercraft(num_supports=31)
    m.set_transformation_backend(ExaTranscriptionBackend(IpmSolver))
    m.set_silent()
    res_dense = m.optimize()

    m2 = hovercraft(num_supports=31)
    m2.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, linear_solver="ldl_cpp"))
    m2.set_silent()
    res_ldl = m2.optimize()
    assert res_ldl.status == "first_order"
    assert res_ldl.objective == pytest.approx(res_dense.objective, abs=1e-9)
    np.testing.assert_allclose(res_ldl.solution, res_dense.solution,
                               atol=1e-7)


# -- mixed / low-precision factorization convergence ----------------------
# factor_dtype="mixed": native-f32 factorization while mu is hot, f64
# endgame -- must certify first_order at tol=1e-8 with the same objective
# as the all-f64 path (the f32 path must actually converge, not diverge
# at small mu).  "float32": no mu threshold at all --
# the f32 factorization runs until its f64 refinement stops contracting,
# then DEMOTE_F32 hands the unchanged state to the f64 step set; without
# that residual-driven handover this configuration stalled.  Split into one test per (problem, dtype) so the compile
# inventories run in parallel under xdist.
def _low_precision_case(build, fdtype, **approx_kw):
    from infiniteexamodels_jax.solvers.ipm import IpmSolver as S

    simd, _ = transcribe(build())
    r64 = S(simd, print_level=0, linear_solver="auto", tol=1e-8).solve()
    assert r64.status == "first_order"
    s = S(simd, print_level=0, linear_solver="auto", tol=1e-8,
          factor_dtype=fdtype)
    assert s.kkt32 is not None
    r = s.solve()
    assert r.status == "first_order"
    assert r.objective == pytest.approx(r64.objective, **approx_kw)


@pytest.mark.slow
def test_mixed_precision_quad():
    from infiniteexamodels_jax.models import quad

    _low_precision_case(lambda: quad(num_supports=50), "mixed", abs=1e-7)


def test_mixed_precision_farmer():
    _low_precision_case(lambda: farmer(num_scenarios=32), "mixed", rel=1e-9)


@pytest.mark.slow
def test_float32_demotion_quad():
    from infiniteexamodels_jax.models import quad

    _low_precision_case(lambda: quad(num_supports=50), "float32", abs=1e-7)


def test_float32_demotion_farmer():
    _low_precision_case(lambda: farmer(num_scenarios=32), "float32",
                        rel=1e-9)


# "ir32": f32 assembly + f32 factorization, refined MATRIX-FREE against the
# exact f64 operator (hvp_lag + COO jprod/jtprod -- classical
# factor-low/refine-high IR without materializing an f64 K) -- f64-quality
# steps, so it must certify at tol=1e-8 without ever demoting on these
# well-conditioned problems.
@pytest.mark.slow
def test_ir32_quad():
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.solvers.ipm import IpmSolver as S

    simd, _ = transcribe(quad(num_supports=50))
    r64 = S(simd, print_level=0, linear_solver="auto", tol=1e-8).solve()
    si = S(simd, print_level=0, linear_solver="auto", tol=1e-8,
           factor_dtype="ir32")
    assert si.kkt32 is not None
    assert si.kkt32.assemble_dtype == jnp.float32  # K feeds only factor
    ri = si.solve()
    assert ri.status == "first_order"
    assert ri.objective == pytest.approx(r64.objective, abs=1e-7)


def test_ir32_farmer():
    from infiniteexamodels_jax.solvers.ipm import IpmSolver as S

    simd2, _ = transcribe(farmer(num_scenarios=32))
    r64b = S(simd2, print_level=0, linear_solver="auto", tol=1e-8).solve()
    rib = S(simd2, print_level=0, linear_solver="auto", tol=1e-8,
            factor_dtype="ir32").solve()
    assert rib.status == "first_order"
    assert rib.objective == pytest.approx(r64b.objective, rel=1e-9)


def _dense_from_blocks(kkt, K):
    """The n x n matrix the block representation (D, L, B, C) stands for,
    in the model's variable order."""
    D, L, B, C = (np.asarray(a) for a in K)
    nb, bs, mB = kkt.nb, kkt.bs, kkt.mB
    nT = nb * bs
    M = np.zeros((nT + mB, nT + mB))
    for b in range(nb):
        M[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs] = D[b]
    if not kkt.block_diag:
        for b in range(nb - 1):
            blk = L[b]          # couples row block b+1 to column block b
            M[(b + 1) * bs:(b + 2) * bs, b * bs:(b + 1) * bs] = blk
            M[b * bs:(b + 1) * bs, (b + 1) * bs:(b + 2) * bs] = blk.T
    if mB:
        M[:nT, nT:] = B.reshape(nT, mB)
        M[nT:, :nT] = B.reshape(nT, mB).T
        M[nT:, nT:] = C
    P = np.asarray(kkt.out_perm)
    return M[np.ix_(P, P)]


@pytest.mark.parametrize("case", ["quad_band", "farmer_arrowhead"])
def test_assembled_blocks_match_dense_reference(case):
    """The structured assembly (block scatter of the per-family COO value
    stream) reproduces the dense backend's K entry for entry: band blocks
    + couplings on the quadrotor, scenario blocks + border + corner on
    the farmer."""
    import jax
    from infiniteexamodels_jax.models import quad

    build = {"quad_band": lambda: quad(num_supports=30),
             "farmer_arrowhead": lambda: farmer(num_scenarios=64)}[case]
    simd, _ = transcribe(build())
    kkt = BlockTridiagKKT(simd, min_blocks=2)
    assert kkt.usable
    assert kkt.block_diag == (case == "farmer_arrowhead")
    assert (kkt.mB > 0) == (case == "farmer_arrowhead")
    x = jnp.asarray(simd.x0) + 0.01
    lam = jnp.linspace(0.5, 1.5, simd.ncon)
    d = jnp.full(simd.ncon, 0.7)
    de = jnp.linspace(0.1, 0.3, simd.nvar)
    Kb = jax.jit(lambda xx: kkt.assemble(xx, simd.theta, lam, 1.0, d,
                                         de))(x)
    Kd = np.asarray(jax.jit(lambda xx: DenseKKT(simd).assemble(
        xx, simd.theta, lam, 1.0, d, de))(x))
    got = _dense_from_blocks(kkt, Kb)
    np.testing.assert_allclose(got, Kd, rtol=0,
                               atol=1e-12 * np.abs(Kd).max())
