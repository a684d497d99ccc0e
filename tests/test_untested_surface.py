"""Coverage for previously-untested surface: Forward/Central FD schemes,
the MadNLP-flavored solver alias, the "ma27" linear_solver alias, and
checkpoint-resume across a regularized stretch of the solve."""
import numpy as np
import pytest

from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.modeling import (
    InfiniteModel, FiniteDifference, Forward, Central, integral, deriv)
from infiniteexamodels_jax.solvers import IpmSolver
from infiniteexamodels_jax.solvers.ipm import MadIpmSolver


def _exp_decay_model(scheme):
    """dy/dt = -y, y(0)=1 on [0,1]: solution exp(-t), objective integrates
    y^2 -> (1-exp(-2))/2."""
    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver))
    t = m.infinite_parameter(
        "t", domain=(0, 1), num_supports=201,
        derivative_method=FiniteDifference(scheme))
    y = m.variable("y", deps=(t,), start=1.0)
    m.constraint(deriv(y, t) == -y)
    m.constraint(y(0) == 1)
    m.minimize(integral(y**2, t))
    m.set_silent()
    return m, y, t


def test_forward_fd_solves_exp_decay():
    m, y, t = _exp_decay_model(Forward)
    res = m.optimize()
    assert res.status == "first_order"
    tg = np.asarray(m.supports(y))
    yv = np.asarray(m.value(y))
    np.testing.assert_allclose(yv, np.exp(-tg), atol=1e-2)  # O(h)
    exact = (1 - np.exp(-2)) / 2
    assert m.objective_value() == pytest.approx(exact, abs=5e-2)


def test_central_fd_stencil_relation_holds():
    """Central differencing leaves one odd-even degree of freedom in pure
    initial-value transcriptions (a known property of the scheme, shared
    with the reference's InfiniteOpt central FD), so instead of pointwise
    accuracy we pin the discretization itself: at the solution the
    defining equations enforce d[i] == (y[i+1]-y[i-1])/(t[i+1]-t[i-1])
    exactly at every interior support."""
    m, y, t = _exp_decay_model(Central)
    res = m.optimize()
    assert res.status == "first_order"
    tg = np.asarray(m.supports(y))
    yv = np.asarray(m.value(y))
    dv = np.asarray(m.value(deriv(y, t)))
    lhs = dv[1:-1] * (tg[2:] - tg[:-2])
    rhs = yv[2:] - yv[:-2]
    np.testing.assert_allclose(lhs, rhs, atol=1e-7)
    # the algebraic constraint pins d == -y everywhere
    np.testing.assert_allclose(dv, -yv, atol=1e-7)


def test_mad_ipm_solver_alias():
    """MadIpmSolver (the reference's MadNLP-role entry point,
    ext/InfiniteExaModelsMadNLP.jl) defaults to the structured KKT and
    reproduces the IpmSolver result."""
    from infiniteexamodels_jax.models import hovercraft

    m = hovercraft(num_supports=41)
    m.set_transformation_backend(ExaTranscriptionBackend(MadIpmSolver))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(0.04245763849025232,
                                                abs=1e-6)
    from infiniteexamodels_jax.solvers.block_tridiag import (
        BlockTridiagKKT)
    from infiniteexamodels_jax.solvers import DenseKKT

    assert isinstance(m.backend.solver.kkt, (BlockTridiagKKT, DenseKKT))


def test_ma27_linear_solver_alias():
    """linear_solver="ma27" routes to the native C++ LDL^T host path (the
    role MA27 plays under Ipopt in the reference stack)."""
    from infiniteexamodels_jax.models import hovercraft
    from infiniteexamodels_jax.solvers.cpp_ldl import CppLdlKKT

    m = hovercraft(num_supports=31)
    m.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, linear_solver="ma27"))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert isinstance(m.backend.solver.kkt, CppLdlKKT)


def test_timers_split_compile_from_warm_steps():
    """ExecutionStats.timers reports the first jitted dispatch (compile +
    cache-miss cost) separately from the accumulated step time so callers
    can report compile_s and warm iter/s as distinct metrics (solve_time
    must not conflate compile and solve)."""
    from infiniteexamodels_jax.models import hovercraft
    from infiniteexamodels_jax.transcribe import transcribe

    model, _ = transcribe(hovercraft(num_supports=31))
    res = IpmSolver(model, print_level=0, linear_solver="auto").solve()
    t = res.timers
    assert np.isfinite(t["first_chunk"]) and t["first_chunk"] > 0
    assert t["step_total"] >= t["first_chunk"]


def test_checkpoint_without_log_fields_loads(tmp_path):
    """Checkpoints written before a diagnostic log field existed still
    load (missing fields default to zero)."""
    from infiniteexamodels_jax.models import hovercraft
    from infiniteexamodels_jax.transcribe import transcribe

    model, _ = transcribe(hovercraft(num_supports=31))
    s = IpmSolver(model, print_level=0, linear_solver="auto")
    ckpt = str(tmp_path / "st.npz")
    s.solve(checkpoint_path=ckpt, checkpoint_every=2, max_iter=4)
    data = dict(np.load(ckpt))
    data.pop("log_rr")
    np.savez(ckpt, **data)
    st = s.load_checkpoint(ckpt)
    assert float(st.log_rr) == 0.0
    res = s.solve(resume_from=ckpt)
    assert res.status == "first_order"


@pytest.mark.slow
def test_checkpoint_resume_mid_regularization(tmp_path):
    """Checkpoint taken while the solver is actively regularizing
    (delta_w_last > 0 in the saved state) resumes to the same optimum."""
    from infiniteexamodels_jax.models import kinetic_control
    from infiniteexamodels_jax.transcribe import transcribe

    model, _ = transcribe(kinetic_control(num_supports=20))
    ref = IpmSolver(model, print_level=0, linear_solver="auto",
                    tol=1e-8).solve()
    assert ref.status == "first_order"

    s = IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-8)
    ckpt = str(tmp_path / "mid.npz")
    # stop early somewhere inside the nonconvex phase
    s.solve(checkpoint_path=ckpt, checkpoint_every=2, max_iter=9)
    st = s.load_checkpoint(ckpt)
    assert int(st.iter) > 0
    s2 = IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-8)
    res = s2.solve(resume_from=ckpt, max_iter=3000)
    assert res.status == "first_order"
    assert res.objective == pytest.approx(ref.objective, abs=1e-7)
