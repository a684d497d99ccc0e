"""Transcription unit tests (mirroring the reference's white-box suite
/root/reference/test/transcription.jl: exact x0/lvar/uvar contents incl.
function bounds, fix semantics, point/semi-infinite overrides, finite params
in theta, parameter-function grids, objective measure structures,
domain-restriction filtering)."""
import numpy as np
import pytest

from infiniteexamodels_jax.modeling import (
    InfiniteModel, OrthogonalCollocation, integral, deriv, sin, cos,
    DomainRestriction,
)
from infiniteexamodels_jax.transcribe import (
    transcribe, OBJ_MEASURE_WARN, CON_MEASURE_WARN)


def build_mapping_model():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=3,
                             derivative_method=OrthogonalCollocation(3))
    y = m.variable("y", deps=(t,), lb=np.cos, ub=1.0)
    q = m.variable("q", deps=(t, x), fix=42.0)
    w = m.variable("w", deps=(x,), lb=2.0, ub=np.sin, start=np.cos)
    z = m.variable("z", start=10.0)
    return m, t, x, y, q, w, z


def test_base_iterators_and_internal_supports():
    m, t, x, *_ = build_mapping_model()
    simd, data = transcribe(m)
    assert len(data.base_itrs) == 2
    assert sum(data.has_internal) == 1
    # OC(3) adds 1 internal node per interval: 3 public -> 2 intervals -> 5
    assert len(data.base_itrs[1]) == 5
    assert len(data.base_itrs[0]) == 5


def test_variable_mapping_and_function_bounds():
    m, t, x, y, q, w, z = build_mapping_model()
    y0 = y(0)
    y1 = y(1)
    y0.info.start = 0.5
    y1.info.lb = -np.inf
    y1.info.ub = 0.8
    q0 = q(0, x)
    q1 = q(1, x)
    q0.info.start = 10.0
    q1.info.fix = 5.0
    d1 = deriv(y, t)
    d2 = deriv(q, x, 2)
    simd, data = transcribe(m)
    core = simd.core
    # finite variable z
    zv = data.lookup(z)
    assert core.x0[zv.i] == 10.0
    assert core.lvar[zv.i] == -np.inf
    # y: function lower bound cos over supports; note point restrictions at
    # t=0,1 override the entries below
    yvar = data.lookup(y)
    assert yvar.length == 5
    tgrid = np.linspace(0, 1, 5)
    np.testing.assert_allclose(
        core.lvar[yvar.offset + 1:yvar.offset + 4], np.cos(tgrid)[1:4])
    np.testing.assert_allclose(core.uvar[yvar.offset + 1:yvar.offset + 4], 1.0)
    # q fixed => lvar == uvar == 42 away from overrides
    qvar = data.lookup(q)
    nx = 5  # x supports incl. internal
    assert qvar.length == 5 * nx
    assert qvar.shape == (5, nx)
    inner = core.lvar[qvar.offset + nx:qvar.offset + 4 * nx]
    np.testing.assert_allclose(inner, 42.0)
    # w function upper bound + function start over x supports (incl internal)
    wvar = data.lookup(w)
    xg = m.groups[1].supports()
    np.testing.assert_allclose(core.lvar[wvar.offset:wvar.offset + 5], 2.0)
    np.testing.assert_allclose(core.uvar[wvar.offset:wvar.offset + 5],
                               np.sin(xg))
    np.testing.assert_allclose(core.x0[wvar.offset:wvar.offset + 5],
                               np.cos(xg))
    # derivative tensors
    assert data.lookup(d1).length == 5
    assert data.lookup(d2).length == 5 * nx
    assert len(m.all_derivatives()) == 3  # d2 lowered adds the chain deriv
    # point-variable overrides (transcription.jl:78-87)
    y0e = data.lookup(y0)
    assert core.x0[y0e.i] == 0.5
    assert core.lvar[y0e.i] == np.cos(0.0)
    y1e = data.lookup(y1)
    assert core.lvar[y1e.i] == -np.inf
    assert core.uvar[y1e.i] == 0.8
    # semi-infinite overrides on slices (transcription.jl:66-74)
    q0v, q0idx = data.semivar_info[id(q0)]
    assert q0idx[0] == 0 and isinstance(q0idx[1], str)
    assert core.x0[qvar[0, 1].i] == 10.0
    assert core.lvar[qvar[4, 2].i] == 5.0
    assert core.uvar[qvar[4, 3].i] == 5.0


def test_finite_parameters_in_theta():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    xp = m.finite_parameter("x", 42.0)
    y1 = m.finite_parameter("y1", 20.0)
    y2 = m.finite_parameter("y2", 30.0)
    v = m.variable("v", deps=(t,), lb=0, ub=100)
    m.constraint(v >= xp * 0 + y1 - y1)  # keep params used
    simd, data = transcribe(m)
    assert len([k for k in (xp, y1, y2) if data._get(data.param_map, k)]) == 3
    th = np.asarray(simd.theta)
    vals = sorted([
        th[data.lookup(xp).offset], th[data.lookup(y1).offset],
        th[data.lookup(y2).offset]])
    assert vals == [20.0, 30.0, 42.0]


def test_parameter_function_grid():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    s = m.infinite_parameter("s", domain=(2, 3), num_supports=3)
    pf = m.parameter_function(lambda tv, sv: np.sin(tv) * sv, (t, s))
    v = m.variable("v", deps=(t, s))
    m.constraint(v >= pf)
    simd, data = transcribe(m)
    par = data.lookup(pf)
    assert par.shape == (3, 3)
    grid = np.asarray(simd.theta)[par.offset:par.offset + 9].reshape(3, 3)
    tg = np.linspace(0, 1, 3)
    sg = np.linspace(2, 3, 3)
    expected = np.sin(tg)[:, None] * sg[None, :]
    np.testing.assert_allclose(grid, expected)


def test_domain_restriction_filters_iterator():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z")
    cref = m.constraint(y + z <= 42 + t,
                        restriction=DomainRestriction(
                            lambda sv: 0 <= sv <= 0.5, t))
    simd, data = transcribe(m)
    fam = data.lookup_constraint(cref)
    # t in {0,.25,.5} pass the restriction -> 3 * 5 rows
    assert len(fam) == 15


def test_objective_measure_structures_no_warn():
    """The 'good' objective structures must transcribe without the expansion
    warning (reference transcription.jl:177-209)."""
    import warnings as W

    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z", start=10)
    inner = integral(y**2, t)
    good = [
        integral(inner, x) + 2 * y(0, 1),
        integral(inner + 2 * z, x),
        integral(inner + 2 * z**2, x) + 2 * y(0, 1),
        integral(inner + sin(z**2), x),
        integral(inner * cos(z), x),
        integral(z * (inner + z**3), x),
    ]
    for obj in good:
        m.minimize(obj)
        with W.catch_warnings():
            W.simplefilter("error")
            transcribe(m)


def test_objective_measure_fallback_warns():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=3)
    y = m.variable("y", deps=(t, x), lb=0)
    inner = integral(y**2, t)
    bad = [
        integral(inner**2, x),             # measure squared inside
        integral(inner, x)**2,             # nonlinear in a measure
        integral(inner * inner, x),        # product of measure occurrences
    ]
    for obj in bad:
        m.minimize(obj)
        with pytest.warns(UserWarning, match="heuristics"):
            transcribe(m)


def test_constraint_measure_warns_and_expands():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    y = m.variable("y", deps=(t,), lb=0)
    z = m.variable("z")
    cref = m.constraint(integral(y, t) + z <= 1)
    with pytest.warns(UserWarning, match="Constrained measures"):
        simd, data = transcribe(m)
    fam = data.lookup_constraint(cref)
    assert len(fam) == 1   # finite constraint after expansion


def test_template_count_independent_of_supports():
    """The SIMD invariant: family count must not grow with support count
    (reference design invariant, SURVEY.md §3.4)."""

    def nfam(ns):
        m = InfiniteModel()
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=ns)
        y = m.variable("y", deps=(t,), lb=0)
        u = m.variable("u", deps=(t,))
        m.constraint(deriv(y, t) == -y + u)
        m.constraint(y(0) == 1)
        m.minimize(integral(u**2 + y**2, t))
        simd, _ = transcribe(m)
        return len(simd.con_fams) + len(simd.obj_fams)

    assert nfam(5) == nfam(50) == nfam(500)
