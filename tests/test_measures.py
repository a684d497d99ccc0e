"""Measure semantics tests: trapezoid/expectation/support-sum coefficients,
weight functions, nested measures (reference measure API surface,
transform.jl:617-703)."""
import numpy as np
import pytest

from infiniteexamodels_jax.modeling import (
    InfiniteModel, integral, expect, support_sum, uniform)
from infiniteexamodels_jax.transcribe import transcribe


def eval_objective(m):
    simd, data = transcribe(m)
    return float(simd.obj(simd.x0, simd.theta))


def test_trapezoid_weights():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 2), num_supports=5)
    y = m.variable("y", deps=(t,), start=lambda tv: tv**2)
    m.minimize(integral(y, t))
    # trapezoid of t^2 over [0,2] with 5 points: h=0.5
    tg = np.linspace(0, 2, 5)
    expected = np.trapezoid(tg**2, tg)
    assert eval_objective(m) == pytest.approx(expected)


def test_integral_weight_function():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=9)
    y = m.variable("y", deps=(t,), start=1.0)
    m.minimize(integral(y, t, weight_fn=lambda tv: tv))
    tg = np.linspace(0, 1, 9)
    assert eval_objective(m) == pytest.approx(np.trapezoid(tg, tg))


def test_expectation_weights():
    m = InfiniteModel(seed=3)
    xi = m.infinite_parameter("xi", dist=uniform(0, 1), num_supports=50)
    y = m.variable("y", deps=(xi,), start=lambda v: v)
    m.minimize(expect(y, xi))
    samples = xi.group.supports()
    assert eval_objective(m) == pytest.approx(float(samples.mean()))


def test_support_sum():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=4)
    y = m.variable("y", deps=(t,), start=2.0)
    m.minimize(support_sum(y, t))
    assert eval_objective(m) == pytest.approx(8.0)


def test_nested_measures_value():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    s = m.infinite_parameter("s", domain=(0, 2), num_supports=7)
    y = m.variable("y", deps=(t, s), start=lambda tv, sv: tv * sv)
    m.minimize(integral(integral(y, t), s))
    tg = np.linspace(0, 1, 5)
    sg = np.linspace(0, 2, 7)
    inner = np.trapezoid(tg[:, None] * sg[None, :], tg, axis=0)
    expected = np.trapezoid(inner, sg)
    assert eval_objective(m) == pytest.approx(float(expected))


def test_bound_mutation_sugar():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    y = m.variable("y", deps=(t,), lb=0.0, ub=5.0)
    y.set_upper_bound(3.0)
    y.delete_lower_bound()
    y.set_start_value(1.5)
    simd, data = transcribe(m)
    var = data.lookup(y)
    core = simd.core
    assert np.all(core.uvar[var.offset:var.offset + 3] == 3.0)
    assert np.all(np.isinf(core.lvar[var.offset:var.offset + 3]))
    assert np.all(core.x0[var.offset:var.offset + 3] == 1.5)


def test_variables_helper():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    xs = m.variables(3, name="x", deps=(t,), lb=[0.0, 1.0, 2.0])
    simd, data = transcribe(m)
    for i, v in enumerate(xs):
        var = data.lookup(v)
        assert np.all(simd.core.lvar[var.offset:var.offset + 3] == float(i))


def test_gauss_legendre_integral_exactness():
    """integral(..., method="gauss_legendre", num_nodes=k) adds k internal
    quadrature supports and is exact for polynomials of degree 2k-1 --
    where the same grid's trapezoid rule is visibly inexact (reference
    measure-data generality: quadrature coefficients drive the SIMD sum,
    transform.jl:618-633)."""
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    y = m.variable("y", deps=(t,), start=lambda tv: tv**6)
    m.minimize(integral(y, t, method="gauss_legendre", num_nodes=4))
    # start values evaluate y = t^6 at EVERY support incl. the quadrature
    # nodes; the 4-point GL rule integrates degree-7 exactly: 1/7
    assert eval_objective(m) == pytest.approx(1.0 / 7.0, abs=1e-12)
    # the quadrature nodes are internal: public queries don't see them
    g = t.group
    assert g.num_supports() == 5 + 4
    assert g.public_mask().sum() == 5

    # same integrand through trapezoid on 5 supports: error ~1e-2
    m2 = InfiniteModel()
    t2 = m2.infinite_parameter("t", domain=(0, 1), num_supports=5)
    y2 = m2.variable("y", deps=(t2,), start=lambda tv: tv**6)
    m2.minimize(integral(y2, t2))
    assert abs(eval_objective(m2) - 1.0 / 7.0) > 1e-3


def test_gauss_legendre_weight_fn():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    y = m.variable("y", deps=(t,), start=1.0)
    # integral of w(t)*1 with w = 3 t^2 -> exactly 1
    m.minimize(integral(y, t, weight_fn=lambda tv: 3 * tv**2,
                        method="gauss_legendre", num_nodes=6))
    assert eval_objective(m) == pytest.approx(1.0, abs=1e-12)
