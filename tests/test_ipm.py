"""IPM correctness on classic NLPs (oracle values from the literature)."""
import numpy as np
import pytest

from infiniteexamodels_jax.ops import Core, Iterator, SRC, abs2
from infiniteexamodels_jax.solvers import IpmSolver


def solve(core, **opts):
    m = core.build()
    opts.setdefault("print_level", 0)
    return IpmSolver(m, **opts).solve(), m


def test_bound_qp():
    core = Core()
    x = core.add_var((), uvar=1.0, name="x")
    core.add_obj(abs2(x.entry() - 2.0))
    res, m = solve(core)
    assert res.status == "first_order"
    assert res.solution[0] == pytest.approx(1.0, abs=1e-7)
    assert res.objective == pytest.approx(1.0, abs=1e-7)


def test_rosenbrock_unconstrained():
    core = Core()
    v = core.add_var((2,), start=np.array([-1.2, 1.0]), name="v")
    core.add_obj(100.0 * abs2(v[1] - abs2(v[0])) + abs2(1.0 - v[0]))
    res, m = solve(core)
    assert res.status == "first_order"
    np.testing.assert_allclose(res.solution, [1.0, 1.0], atol=1e-6)


def test_hs071():
    core = Core()
    x = core.add_var((4,), lvar=1.0, uvar=5.0,
                     start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
    core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
    core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
    core.add_con(abs2(x[0]) + abs2(x[1]) + abs2(x[2]) + abs2(x[3]),
                 lcon=40.0, ucon=40.0)
    res, m = solve(core)
    assert res.status == "first_order"
    assert res.objective == pytest.approx(17.0140173, abs=1e-5)
    np.testing.assert_allclose(
        res.solution, [1.0, 4.7429994, 3.8211503, 1.3794082], atol=1e-5)


def test_maximize():
    core = Core(minimize=False)
    x = core.add_var((), lvar=0.0, uvar=4.0, name="x")
    core.add_obj(x.entry() * (4.0 - x.entry()))
    res, m = solve(core)
    assert res.status == "first_order"
    assert res.solution[0] == pytest.approx(2.0, abs=1e-6)
    assert res.objective == pytest.approx(4.0, abs=1e-6)


def test_equality_lp():
    # min x + y  s.t.  x + 2y == 3, x >= 0, y >= 0
    core = Core()
    x = core.add_var((), lvar=0.0, name="x")
    y = core.add_var((), lvar=0.0, name="y")
    core.add_obj(x.entry() + y.entry())
    core.add_con(x.entry() + 2.0 * y.entry(), lcon=3.0, ucon=3.0)
    res, m = solve(core)
    assert res.status == "first_order"
    assert res.objective == pytest.approx(1.5, abs=1e-6)
    np.testing.assert_allclose(res.solution, [0.0, 1.5], atol=1e-6)


def test_simd_family_problem():
    # a small OCP-like batched problem:
    # min sum_i (x_i - 1)^2  s.t. x_i - x_{i-1} <= 0.3, x_0 == 0
    core = Core()
    n = 8
    x = core.add_var((n,), name="x")
    itr = Iterator({"i": np.arange(1, n)})
    core.add_con(x[SRC.i] - x[SRC.i - 1], itr, lcon=-np.inf, ucon=0.3)
    core.add_con(x[0], lcon=0.0, ucon=0.0)
    obj_itr = Iterator({"i": np.arange(n)})
    core.add_obj(abs2(x[SRC.i] - 1.0), obj_itr)
    res, m = solve(core)
    assert res.status == "first_order"
    expected = np.minimum(np.arange(n) * 0.3, 1.0)
    np.testing.assert_allclose(res.solution, expected, atol=1e-6)


def test_warmstart_fewer_iters():
    def build():
        core = Core()
        x = core.add_var((4,), lvar=1.0, uvar=5.0,
                         start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
        core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
        core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
        core.add_con(abs2(x[0]) + abs2(x[1]) + abs2(x[2]) + abs2(x[3]),
                     lcon=40.0, ucon=40.0)
        return core.build()

    m = build()
    s = IpmSolver(m, print_level=0)
    cold = s.solve()
    m.set_x0(cold.solution)
    m.set_y0(cold.multipliers)
    warm = s.reset().solve(mu_init=1e-7)
    assert warm.status == "first_order"
    assert warm.iter < cold.iter
    assert warm.objective == pytest.approx(cold.objective, abs=1e-6)


def test_max_iter_status():
    core = Core()
    x = core.add_var((4,), lvar=1.0, uvar=5.0,
                     start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
    core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
    core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
    m = core.build()
    res = IpmSolver(m, print_level=0, max_iter=2).solve()
    assert res.status == "max_iter"
    assert res.iter == 2


def test_max_wall_time_status():
    core = Core()
    n = 50
    x = core.add_var((n,), name="x")
    itr = Iterator({"i": np.arange(1, n)})
    core.add_con(x[SRC.i] - x[SRC.i - 1] * x[SRC.i - 1], itr,
                 lcon=0.1, ucon=0.1)
    core.add_obj(abs2(x[SRC.i] - 2.0), Iterator({"i": np.arange(n)}))
    m = core.build()
    res = IpmSolver(m, print_level=0, max_wall_time=1e-9).solve()
    assert res.status == "max_time"


def test_unbounded_detection():
    core = Core()
    x = core.add_var((), name="x")
    core.add_obj(x.entry())          # min x, unbounded below
    m = core.build()
    res = IpmSolver(m, print_level=0, max_iter=500).solve()
    assert res.status in ("unbounded", "max_iter", "stalled")
    if res.status == "unbounded":
        assert res.objective < -1e19


def test_restoration_reduces_violation_and_resumes():
    """The feasibility-restoration phase (Ipopt §3.3 role): from a
    violated state it drives the constraint violation down by orders of
    magnitude, recenters slacks/duals, and returns a RUNNING state."""
    import jax

    core = Core()
    x = core.add_var((4,), start=5.0)
    itr = Iterator({"i": np.arange(3)})
    core.add_con(x[SRC.i] * x[SRC.i + 1] - 1.0, itr, 0.0, 0.0)
    core.add_obj(abs2(x[SRC.i] - 2.0), Iterator({"i": np.arange(4)}))
    m = core.build()
    s = IpmSolver(m, print_level=0, tol=1e-8)
    consts = s._compute_consts(m.theta, m)
    st = s._init_jit(m.x0, m.y0, consts)
    viol0 = float(np.abs(np.asarray(s._ceval(st.x, consts))).max())
    st2 = jax.jit(s._restore)(st, consts)
    viol1 = float(np.abs(np.asarray(s._ceval(st2.x, consts))).max())
    assert viol0 > 1.0
    assert viol1 < 1e-4 * viol0
    assert int(st2.status) == 0          # RUNNING: main loop resumes
    assert int(st2.ls_fail_count) == 0
    # and the full solve still certifies
    res = s.solve()
    assert res.status == "first_order"


def test_restoration_disabled_falls_back_to_stalled():
    """With restoration off, repeated line-search failures terminate with
    the round-1 dual-reset/stalled behavior (no NEED_RESTORATION escapes
    to the user)."""
    core = Core()
    x = core.add_var((2,), start=0.0)
    # infeasible pair: x0 == 1 and x0 == -1
    core.add_con(x[0], lcon=1.0, ucon=1.0)
    core.add_con(x[0], lcon=-1.0, ucon=-1.0)
    core.add_obj(abs2(x[0]) + abs2(x[1]))
    m = core.build()
    res = IpmSolver(m, print_level=0, restoration=False,
                    max_iter=200).solve()
    assert res.status in ("stalled", "infeasible", "max_iter", "acceptable")
    res2 = IpmSolver(m, print_level=0, restoration=True,
                     max_iter=200).solve()
    assert res2.status in ("stalled", "infeasible", "max_iter",
                           "acceptable")


@pytest.mark.slow
def test_second_order_correction():
    """SOC (Ipopt A-5.7..5.9 role): a rejected full step with growing
    infeasibility triggers one extra solve of the already-factorized KKT
    with the post-step violation as rhs.  Both settings must converge to
    the same point; the kappa_soc guard keeps SOC from displacing the
    endgame polish (regression: farmer-300 returned ``acceptable`` when an
    accepted SOC step pinned theta at the equality-relaxation window)."""
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.transcribe import transcribe

    simd, _ = transcribe(quad(num_supports=40))
    r_on = IpmSolver(simd, print_level=0, linear_solver="auto",
                     tol=1e-8, soc=True).solve()
    r_off = IpmSolver(simd, print_level=0, linear_solver="auto",
                      tol=1e-8, soc=False).solve()
    assert r_on.status == "first_order"
    assert r_off.status == "first_order"
    assert r_on.objective == pytest.approx(r_off.objective, rel=1e-9)


def test_sticky_regularization_streak():
    """Sticky delta_w: a nonconvex problem fails the delta_w = 0 probe for
    several consecutive iterations; the streak must be recorded (the skip
    policy keys off it) and the solve must land on the same optimum with
    the policy effectively disabled (huge skip threshold) -- skipping the
    doomed probe only removes a wasted factorization, never changes the
    accepted step."""
    from infiniteexamodels_jax.solvers.ipm import IpmSolver as S

    def make():
        core = Core()
        x = core.add_var((2,), lvar=-1.0, uvar=2.0,
                         start=np.array([0.3, 0.4]), name="x")
        core.add_obj(-abs2(x[0]) - abs2(x[1]))
        return core.build()

    m = make()
    res = S(m, print_level=0).solve()
    assert res.status == "first_order"
    assert res.objective == pytest.approx(-8.0, abs=1e-6)

    res_noskip = S(m, print_level=0, reg_zero_skip_streak=10**6).solve()
    assert res_noskip.status == "first_order"
    assert res_noskip.objective == pytest.approx(res.objective, abs=1e-9)

    # step manually: the indefinite Hessian (-2I) defeats the zero probe
    # early on, so the streak must accrue and delta_w stay positive
    s = S(m, print_level=0)
    consts = s._compute_consts(m.theta, m)
    st = s._init_jit(m.x0, m.y0, consts)
    streaks, dws = [], []
    for _ in range(5):
        st = s._step_jit(st, consts)
        streaks.append(int(st.zero_fail_streak))
        dws.append(float(st.log_delta_w))
    assert streaks[0] >= 1
    assert max(streaks) >= 2
    assert all(d > 0.0 for d in dws[:2])


def test_profiler_trace_dir(tmp_path):
    """trace_dir captures a jax profiler trace of the solve (SURVEY §5)."""
    import os

    core = Core()
    x = core.add_var((), uvar=1.0, name="x")
    core.add_obj(abs2(x.entry() - 2.0))
    m = core.build()
    res = IpmSolver(m, print_level=0).solve(trace_dir=str(tmp_path))
    assert res.status == "first_order"
    found = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path)
             for f in fs]
    assert any(f.endswith((".pb", ".json.gz", ".trace.json.gz"))
               for f in found), found


def test_ray_damping_noninterference():
    """Opt-in dual-ray proximal damping (ray_damping: pulls multiplier
    excess beyond ray_y_cap toward zero) must leave healthy endgames
    untouched -- its gate (|y| beyond the cap AND primal converged AND
    capped dual error far from stationary) never fires on a regular NLP,
    so the hs071 trajectory is bit-identical.  The feature itself is
    measured on pandemic (100,8): du 3.4e-4 -> 2.0e-4 at the acceptable
    gate with the oracle objective preserved to 2e-5 (see the ray_*
    option comments in solvers/ipm.py)."""
    def build():
        core = Core()
        x = core.add_var((4,), lvar=1.0, uvar=5.0,
                         start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
        core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
        core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
        core.add_con(abs2(x[0]) + abs2(x[1]) + abs2(x[2]) + abs2(x[3]),
                     lcon=40.0, ucon=40.0)
        return core

    r0, _ = solve(build())
    r1, _ = solve(build(), ray_damping=True)
    assert r1.status == "first_order"
    assert r1.iter == r0.iter
    np.testing.assert_array_equal(np.asarray(r1.solution),
                                  np.asarray(r0.solution))


def test_adaptive_barrier():
    """barrier="adaptive" (LOQO centrality-clipped mu, the reference's
    MadNLP barrier-strategy option, test/madnlp.jl:32-34) converges to the
    same hs071 optimum as the monotone default."""
    core = Core()
    x = core.add_var((4,), lvar=1.0, uvar=5.0,
                     start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
    core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
    core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
    core.add_con(abs2(x[0]) + abs2(x[1]) + abs2(x[2]) + abs2(x[3]),
                 lcon=40.0, ucon=40.0)
    res, m = solve(core, barrier="adaptive")
    assert res.status == "first_order"
    assert res.objective == pytest.approx(17.0140173, abs=1e-5)


def test_lsq_dual_init():
    """dual_init="lsq" (Ipopt least_square_init_duals role): hs071 still
    certifies at the oracle optimum, and on the degenerate pandemic family
    the bounded stationarity-consistent start beats y0=0 decisively
    (measured (51,4): 701 -> 288 iterations; pinned here at (25,4))."""
    core = Core()
    x = core.add_var((4,), lvar=1.0, uvar=5.0,
                     start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
    core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
    core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
    core.add_con(abs2(x[0]) + abs2(x[1]) + abs2(x[2]) + abs2(x[3]),
                 lcon=40.0, ucon=40.0)
    res, m = solve(core, dual_init="lsq")
    assert res.status == "first_order"
    assert res.objective == pytest.approx(17.0140173, abs=1e-5)

    from infiniteexamodels_jax import models as M
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend

    runs = {}
    for di in ("zero", "lsq"):
        mdl = M.pandemic(num_supports=25, num_scenarios=4)
        b = ExaTranscriptionBackend(IpmSolver, linear_solver="auto",
                                    print_level=0, tol=1e-6, max_iter=900,
                                    dual_init=di)
        mdl.set_transformation_backend(b)
        b.build(mdl)
        runs[di] = b.optimize(mdl)
    # (25,4) is the most degenerate grid (even (51,4) certifies
    # first_order): both runs end at the acceptable gate, but the LSQ
    # start cuts the iteration count (measured 900-cap -> 531)
    assert runs["lsq"].status in ("first_order", "acceptable")
    assert runs["lsq"].objective == pytest.approx(
        runs["zero"].objective, abs=1e-3)
    assert runs["lsq"].iter < runs["zero"].iter


def test_consts_cache_invalidation():
    """The solver's cached problem-constants dict must be invalidated by
    start/parameter/bound mutations (it is keyed on a content fingerprint
    of theta/x0/bounds): a warmstarted re-solve from the previous optimum
    must still converge to the same objective in fewer iterations."""
    from infiniteexamodels_jax import models as M
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend

    mdl = M.farmer(num_scenarios=16)
    b = ExaTranscriptionBackend(IpmSolver, linear_solver="auto",
                                print_level=0, tol=1e-6)
    mdl.set_transformation_backend(b)
    b.build(mdl)
    r0 = b.optimize(mdl)
    assert r0.status == "first_order"
    solver = b.solver
    assert getattr(solver, "_consts_cache", None) is not None
    fp0 = solver._consts_cache[0]
    # unchanged data -> fingerprint stable (cache hit on plain re-solve)
    b.model.refresh_from_core()
    assert solver._compute_consts(b.model.theta, b.model) is \
        solver._consts_cache[1]
    # mutate starts through the core (the backend warmstart path):
    # fingerprint must change
    b.model.core.set_x0_flat(np.asarray(r0.solution))
    b.model.refresh_from_core()
    solver._compute_consts(b.model.theta, b.model)
    assert solver._consts_cache[0] != fp0
    r1 = b.optimize(mdl)
    assert r1.status == "first_order"
    assert r1.objective == pytest.approx(r0.objective, rel=1e-6)


def test_restore_objective_guard():
    """Best-iterate tracker objective sanity: a
    near-KKT iterate whose objective sits far above the best feasible-ish
    objective seen must neither be stored for restore nor counted as a
    near-optimal visit -- on the degenerate pandemic grids such points are
    spurious stationary points on an unbounded multiplier ray."""
    import jax.numpy as jnp

    core = Core()
    x = core.add_var((2,), start=np.array([3.0, 1.0]), lvar=0.0)
    core.add_obj(abs2(x[0] - 1.0) + abs2(x[1] - 2.0))
    core.add_con(x[0] + x[1], lcon=1.0, ucon=np.inf)
    m = core.build()
    s = IpmSolver(m, print_level=0, tol=1e-8)
    consts = s._compute_consts(m.theta, m)
    st = s._init_jit(m.x0, m.y0, consts)
    for _ in range(12):
        st = s._step_jit(st, consts)
    assert int(st.status) == 1            # converged: iterate is near-KKT
    # accept branch: at convergence the stored best is the real optimum
    # and respects the evolving objective bound
    assert float(st.best_E) < 1e-6
    bound = float(st.feas_fobj) + 0.1 * max(1.0, abs(float(st.feas_fobj)))
    assert float(st.best_fobj) <= bound

    # reject branch: replay the final (near-KKT) step against a sabotaged
    # state claiming a far lower feasible objective was already seen; the
    # same iterate must now be rejected -- stale best dropped (E -> inf),
    # no new best stored, and the visit counter frozen
    sab = st._replace(status=jnp.asarray(0, jnp.int32),
                      feas_fobj=jnp.asarray(-1e3, st.feas_fobj.dtype),
                      acc_visits=jnp.asarray(0, jnp.int32))
    st2 = s._step_jit(sab, consts)
    assert not np.isfinite(float(st2.best_E))
    assert int(st2.acc_visits) == 0
