"""Unit tests of the SIMD core: templates, iterators, families, AD."""
import numpy as np
import jax.numpy as jnp
import pytest

from infiniteexamodels_jax.ops import Core, Iterator, SRC, sin, abs2


def build_toy():
    """min sum_i (x[i] - t_i)^2  s.t.  x[i] - x[i-1] == 0.1, x[0] free,
    plus a finite var z with  z * x[2] >= 1."""
    core = Core()
    n = 5
    t = np.linspace(0.0, 1.0, n)
    x = core.add_var((n,), start=1.0, name="x")
    z = core.add_var((), lvar=0.5, name="z")
    itr = Iterator({"i": np.arange(n), "t": t})
    core.add_obj(abs2(x[SRC.i] - SRC.t), itr)
    step = Iterator({"i": np.arange(1, n)})
    core.add_con(x[SRC.i] - x[SRC.i - 1], step, lcon=0.1, ucon=0.1)
    core.add_con(z.entry() * x[2], lcon=1.0, ucon=np.inf)
    return core, x, z, t


def test_shapes_and_offsets():
    core, x, z, t = build_toy()
    assert core.nvar == 6
    assert x.offset == 0 and z.offset == 5
    assert core.ncon == 5
    m = core.build()
    assert m.lcon.shape == (5,)
    np.testing.assert_allclose(np.asarray(m.lcon), [0.1] * 4 + [1.0])
    np.testing.assert_allclose(np.asarray(m.x0), [1.0] * 5 + [0.0])
    np.testing.assert_allclose(np.asarray(m.lvar)[5], 0.5)


def test_eval_and_ad():
    core, x, z, t = build_toy()
    m = core.build()
    xv = jnp.asarray(np.concatenate([np.arange(5.0) * 0.1, [2.0]]))
    th = m.theta
    obj = float(m.obj(xv, th))
    assert obj == pytest.approx(float(np.sum((np.arange(5) * 0.1 - t) ** 2)))
    c = np.asarray(m.cons(xv, th))
    np.testing.assert_allclose(c[:4], 0.1)
    assert c[4] == pytest.approx(2.0 * 0.2)
    # gradient vs finite check
    g = np.asarray(m.grad(xv, th))
    np.testing.assert_allclose(g[:5], 2 * (np.arange(5) * 0.1 - t), atol=1e-12)
    assert g[5] == 0.0
    # jacobian: dense reconstruction
    jv = np.asarray(m.jac_vals(xv, th))
    J = np.zeros((m.ncon, m.nvar))
    np.add.at(J, (m.jac_rows_np, m.jac_cols_np), jv)
    Jtrue = np.zeros_like(J)
    for r, i in enumerate(range(1, 5)):
        Jtrue[r, i] = 1.0
        Jtrue[r, i - 1] = -1.0
    Jtrue[4, 2] = 2.0   # z * x[2], z = 2
    Jtrue[4, 5] = 0.2   # x[2] = 0.2
    np.testing.assert_allclose(J, Jtrue, atol=1e-12)


def test_hessian_assembly():
    core, x, z, t = build_toy()
    m = core.build()
    xv = jnp.asarray(np.concatenate([np.arange(5.0) * 0.1, [2.0]]))
    lam = jnp.asarray(np.array([0.0, 0.0, 0.0, 0.0, 3.0]))
    hv = np.asarray(m.hess_vals(xv, m.theta, lam, 1.0))
    H = np.zeros((m.nvar, m.nvar))
    np.add.at(H, (m.hess_rows_np, m.hess_cols_np), hv)
    Htrue = np.zeros_like(H)
    Htrue[np.arange(5), np.arange(5)] = 2.0        # objective sum (x-t)^2
    Htrue[2, 5] = Htrue[5, 2] = 3.0                # lam * d2(z*x2)
    np.testing.assert_allclose(H, Htrue, atol=1e-12)


def test_slot_aliasing_hessian():
    """x[i] and x[0] alias at row 0: the cross Hessian terms must land on the
    diagonal with multiplicity 2."""
    core = Core()
    x = core.add_var((3,), name="x")
    itr = Iterator({"i": np.arange(3)})
    core.add_con(x[SRC.i] * x[0], itr, lcon=0, ucon=0)
    m = core.build()
    xv = jnp.asarray([2.0, 3.0, 4.0])
    lam = jnp.ones(3)
    hv = np.asarray(m.hess_vals(xv, m.theta, lam, 1.0))
    H = np.zeros((3, 3))
    np.add.at(H, (m.hess_rows_np, m.hess_cols_np), hv)
    # c0 = x0^2 -> d2/dx0^2 = 2; c1 = x1 x0, c2 = x2 x0
    Htrue = np.array([[2.0, 1.0, 1.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(H, Htrue, atol=1e-12)


def test_parameters_and_update():
    core = Core()
    x = core.add_var((), name="x")
    p = core.add_par([3.0], name="p")
    core.add_obj(abs2(x.entry() - p[0]))
    m = core.build()
    xv = jnp.asarray([1.0])
    assert float(m.obj(xv, m.theta)) == pytest.approx(4.0)
    m.set_parameter(p, [5.0])
    assert float(m.obj(xv, m.theta)) == pytest.approx(16.0)


def test_nonlinear_ops_and_fields():
    core = Core()
    n = 4
    x = core.add_var((n,), name="x")
    itr = Iterator({"i": np.arange(n), "c": np.full(n, 0.25),
                    "t": np.linspace(0, 1, n)})
    core.add_obj(SRC.c * sin(x[SRC.i]) * SRC.t, itr)
    m = core.build()
    xv = jnp.asarray(np.linspace(0.5, 2.0, n))
    expected = np.sum(0.25 * np.sin(np.asarray(xv)) * np.linspace(0, 1, n))
    assert float(m.obj(xv, m.theta)) == pytest.approx(float(expected))


def test_iterator_product_order():
    a = Iterator({"i": np.arange(2), "t": np.array([0.0, 1.0])})
    b = Iterator({"j": np.arange(3), "s": np.array([5.0, 6.0, 7.0])})
    p = Iterator.product(a, b)
    assert len(p) == 6
    # C-order: last iterator varies fastest
    np.testing.assert_array_equal(p["i"], [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(p["j"], [0, 1, 2, 0, 1, 2])
    np.testing.assert_array_equal(p["s"], [5, 6, 7, 5, 6, 7])


def test_maximize_sense():
    core = Core(minimize=False)
    x = core.add_var((), name="x")
    core.add_obj(-abs2(x.entry() - 2.0))
    m = core.build()
    assert m.sense == -1.0


def test_hvp_lag_matches_dense_hessian():
    """The matrix-free Lagrangian Hessian-vector product (the ir32
    refinement's exact-f64 reference, SimdModel.hvp_lag) must equal the
    densified hess_vals COO Hessian applied to the same vector, on a model
    with constraint AND objective curvature and slot aliasing."""
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.transcribe import transcribe

    m, _ = transcribe(quad(num_supports=7))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0.5, 0.2, m.nvar))
    v = jnp.asarray(rng.normal(size=m.nvar))
    lam = jnp.asarray(rng.normal(size=m.ncon))
    sigma = 1.3

    hv = np.asarray(m.hvp_lag(x, m.theta, lam, sigma, v))

    vals = np.asarray(m.hess_vals(x, m.theta, lam, sigma))
    H = np.zeros((m.nvar, m.nvar))
    np.add.at(H, (np.asarray(m.hess_rows_np), np.asarray(m.hess_cols_np)),
              vals)
    np.testing.assert_allclose(hv, H @ np.asarray(v), rtol=1e-10, atol=1e-10)
