"""Filter line-search interior-point method, fully jittable per iteration.

A from-scratch JAX implementation of the algorithm family the reference
delegates to Ipopt (CPU) and MadNLP (GPU) (reference ext/ glue:
/root/reference/ext/InfiniteExaModelsIpopt.jl:42-61,
/root/reference/ext/InfiniteExaModelsMadNLP.jl:43-65).  Design follows the
condensed-space GPU IPM literature (PAPERS.md): all inequality constraints are
slacked, equalities are lifted with a tiny bound relaxation, and each Newton
step reduces to one SPD "condensed" system in x factorized on the device.

Algorithm skeleton (Waechter-Biegler filter line search, monotone barrier):

  - gradient-based objective/constraint scaling at x0 (gmax = 100)
  - primal-dual Newton steps from the condensed system
    K = W + Sigma_x + delta_w + J^T D J
  - inertia-free regularization: Cholesky retry with delta_w bumping
  - fraction-to-boundary + filter backtracking line search
  - Fiacco-McCormick barrier decrease, acceptable-point termination

One IPM iteration is a single jitted function of the solver state; iterations
run device-side in chunks (lax.while_loop) so the host loop pays one dispatch
round-trip per ~32 iterations.  Extra robustness machinery: Ipopt-style
uniform bound relaxation, kappa_d bound damping (degenerate multiplier rays),
dynamic tiny-slack bound correction, iterative refinement of the condensed
solve, and a dual-reset fallback on line-search failure (a lightweight stand-
in for a full feasibility-restoration phase -- roadmap item).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .kkt import DenseKKT
from .results import ExecutionStats

# status codes inside jit
RUNNING, FIRST_ORDER, ACCEPTABLE, INFEASIBLE, STALLED, DIVERGED, INVALID = \
    0, 1, 2, 3, 4, 5, 6
NEED_RESTORATION = 7     # host-visible: enter the feasibility restoration
                         # phase, then resume (never escapes to the user)
DEMOTE_F32 = 8           # host-visible: the f32 factorization path can no
                         # longer deliver refinable steps -- the host hands
                         # the UNCHANGED state to the f64 step set (never
                         # escapes to the user)

_STATUS_NAMES = {
    FIRST_ORDER: "first_order",
    ACCEPTABLE: "acceptable",
    INFEASIBLE: "infeasible",
    STALLED: "stalled",
    DIVERGED: "unbounded",
    INVALID: "invalid_number",
}

FILTER_SIZE = 128


def _kkt_tables(kkt, t):
    """Rebind a KKT backend's static tables to traced jit arguments
    (multi-process safe; no-op for backends without sharded tables)."""
    bind = getattr(kkt, "bound_tables", None)
    if bind is None:
        from contextlib import nullcontext

        return nullcontext()
    return bind(t)


class IpmState(NamedTuple):
    x: jnp.ndarray          # (n,)
    s: jnp.ndarray          # (m,)
    y: jnp.ndarray          # (m,)
    zl: jnp.ndarray         # (n+m,)
    zu: jnp.ndarray         # (n+m,)
    # bounds are STATE: tiny-slack correction moves them outward by machine-
    # level amounts when a lifted equality pins its slack (Ipopt's
    # slack-correction mechanism); initialized from the relaxed bounds
    lz: jnp.ndarray         # (n+m,)
    uz: jnp.ndarray         # (n+m,)
    mu: jnp.ndarray
    tau: jnp.ndarray
    delta_w_last: jnp.ndarray
    # consecutive iterations where the delta_w = 0 first attempt was probed
    # and FAILED: drives the sticky-regularization policy (skip the doomed
    # zero probe while the streak persists -- where the factorization is
    # the dominant per-iteration cost, a zero probe failing 5+ iterations
    # straight doubles step time)
    zero_fail_streak: jnp.ndarray
    filter_theta: jnp.ndarray   # (FILTER_SIZE,)
    filter_phi: jnp.ndarray
    filter_len: jnp.ndarray
    iter: jnp.ndarray
    status: jnp.ndarray
    acceptable_count: jnp.ndarray
    small_step_count: jnp.ndarray
    ls_fail_count: jnp.ndarray
    # best-iterate tracker + cumulative count of near-optimal VISITS
    # (E0 within acceptable_visit_tol_factor*tol, primal within 10*tol):
    # the signature of a degenerate-endgame limit cycle is REVISITING the
    # solution repeatedly without certifying (dual overshoot along an
    # unbounded multiplier ray -> recovery reset -> repeat).  At
    # acceptable_visit_limit visits the solve returns "acceptable" with
    # the best iterate restored (Ipopt: SOLVED_TO_ACCEPTABLE_LEVEL).
    acc_visits: jnp.ndarray
    best_E: jnp.ndarray
    best_inf_pr: jnp.ndarray
    best_inf_du: jnp.ndarray
    # objective (scaled, minimization sense) at the stored best iterate,
    # and the lowest objective seen at any feasible-ish iterate
    # (inf_pr <= 1e2*tol).  Any feasible-ish objective upper-bounds the
    # optimum, so a near-KKT candidate far above it is a spurious
    # stationary point on a degenerate multiplier ray and must not be
    # stored/restored.
    best_fobj: jnp.ndarray
    feas_fobj: jnp.ndarray
    best_x: jnp.ndarray
    best_s: jnp.ndarray
    best_y: jnp.ndarray
    best_zl: jnp.ndarray
    best_zu: jnp.ndarray
    # logging scalars from the last step
    log_obj: jnp.ndarray
    log_inf_pr: jnp.ndarray
    log_inf_du: jnp.ndarray
    log_alpha: jnp.ndarray
    log_alpha_z: jnp.ndarray
    log_ls: jnp.ndarray
    log_delta_w: jnp.ndarray
    # relative residual of the condensed solve after iterative refinement
    # (0 for exact backends); the precision diagnostic behind DEMOTE_F32
    log_rr: jnp.ndarray
    # scaled overall KKT error at the step's start (the convergence E);
    # drives the best-iterate tracker and the stagnation diagnostics
    log_E0: jnp.ndarray
    # cumulative work counters: KKT factorizations (regularization-ladder
    # attempts) and iterative-refinement rounds since the solve started
    n_factor: jnp.ndarray
    n_refine: jnp.ndarray


DEFAULTS = dict(
    tol=1e-8,
    acceptable_tol=1e-6,
    acceptable_iter=15,
    acceptable_constr_viol_tol=1e-2,
    acceptable_dual_inf_tol=1e10,
    acceptable_compl_inf_tol=1e-2,
    max_iter=3000,
    mu_init="auto",   # "auto": 0.1*max(1, theta0), clipped to [0.1, 100]
    s_max=100.0,
    kappa_epsilon=10.0,
    kappa_mu=0.2,
    theta_mu=1.5,
    barrier="monotone",     # "monotone" (MadNLP MonotoneUpdate role) or
                            # "adaptive" (LOQO centrality-clipped schedule;
                            # reference test/madnlp.jl:32-34 barrier option)
    tau_min=0.99,
    gamma_theta=1e-5,
    gamma_phi=1e-5,
    delta=1.0,
    s_theta=1.1,
    s_phi=2.3,
    eta_phi=1e-4,
    kappa_sigma=1e10,
    kappa_relax=1e-8,       # equality-lifting relaxation (LiftedKKT style)
    bound_push=1e-2,        # kappa_1/kappa_2
    bound_frac=1e-2,
    delta_w_init=1e-4,
    delta_w_min=1e-20,
    delta_w_max=1e40,
    kappa_w_plus_init=100.0,
    kappa_w_plus=8.0,
    kappa_w_minus=1.0 / 3.0,
    delta_c_bar=1e-8,
    delta_c_mu_floor=0.0,    # optional mu floor inside the delta_c schedule
    # dual-ray proximal damping (degenerate multiplier rays, e.g. the
    # pandemic singular-arc path constraint): when the ray signature is
    # live -- primal converged, capped-scaled dual error far from
    # stationary, and some multiplier beyond ray_y_cap -- the primal row
    # is regularized as  J dx - ds - delta_c (dy) - ray_delta (y+dy -
    # clip(y)) = -rp,  i.e. a proximal pull of the multiplier EXCESS
    # beyond the cap toward zero.  Along a dual null-space ray the pull is
    # the only force acting (J^T y_ray = 0 leaves rx/rp untouched), so the
    # ray component decays geometrically; duals within the cap feel
    # nothing, and the gate disengages for a clean Newton endgame once the
    # dual error re-enters the near-optimal band (hysteresis-free: each
    # engagement strictly shrinks the excess).
    # OFF by default (measured round 3): with delta=1e-8/cap=1e4 the pull
    # keeps the pandemic (100,8) oracle objective to 2e-5 while cutting
    # the returned dual error ~10x (du 3.4e-4 -> 2.0e-4 at the gate,
    # 3e-5 best; delta=1e-9/cap=1e3 reaches du 2.2e-5), but the same
    # setting degrades the CONVERGING (51,4) endgame from first_order to
    # acceptable (transient mega-multipliers trip the gate), and stronger
    # pulls bias the objective by ~6e-3 via the primal fixed-point shift
    # c = -ray_delta * excess(y).  Opt in per solve on ray-dominated
    # problems where a clean dual certificate matters more than the last
    # objective digits.
    ray_damping=False,
    ray_delta=1e-8,
    ray_y_cap=1e4,
    # structural primal-dual proximal regularization (see delta_pd in the
    # step): dual-step damping of strength kappa*mu, engaged only once
    # mu <= prox_dual_mu_max.  0 = off.  The gate matters: ungated
    # damping from iteration 0 changes the GLOBAL phase's basin --
    # measured on pandemic (51,4), kappa=1 ungated converges to a
    # spurious backward-Euler root branch (u~0, obj 4e-6, feasible to
    # 9e-7: the implicit step's quadratic nonlinearity admits a
    # no-epidemic shadow trajectory) instead of the physical 29.138
    # solution; gated at mu<=1e-3 the early trajectory is untouched.
    prox_dual_kappa=0.0,
    prox_dual_mu_max=1e-3,
    # Ipopt ``recalc_y`` role: when the constraint multipliers blow past
    # recalc_y_cap (the degenerate-ray signature), recompute y by the
    # same matrix-free least-squares solve as dual_init="lsq" at the
    # CURRENT iterate -- the minimal-norm stationarity fit removes the
    # null-space ray component outright instead of damping it.  Checked
    # once per host chunk (one extra tiny dispatch when enabled).
    recalc_y=False,
    recalc_y_cap=1e3,
    # "stall" trigger for the same least-squares recalc: fire when the
    # iterate is primal-feasible (pr <= 1e2*tol), the dual error is
    # large (du > 1e4*tol), and the step length is crawling (alpha <=
    # 0.25) -- the measured pandemic crawl signature (pr 7.8e-7, du
    # ~4.8e2, alpha 1/8, mu frozen: the filter caps the coupled step
    # while the dual residual, LINEAR in y, could be closed directly by
    # the minimal-norm fit).  Checked at chunk boundaries; see
    # recalc_y_obj_gate for the optional objective-direction condition.
    recalc_y_stall=False,
    # require the objective to have failed to decrease before the stall
    # recalc may fire.  Measured tradeoff: OFF, (100,32) reaches obj
    # 31.155 / du 6.4e-3 (the early recalcs pull the duals down while
    # the iterate parks near the optimum) but (100,128)'s longer
    # productive crawl is destroyed (obj 76.6 at 3000); ON, (100,128)'s
    # descent is preserved and accelerated (obj 36.4 at 3000 vs 41.8 at
    # 6000 with no recalc) but (100,32) loses the early-recalc gain
    # (obj 33.6 / du 1.1e-2).  Default OFF: the mid-size grids are the
    # certified surface, and (100,128) does not certify either way yet.
    recalc_y_obj_gate=False,
    max_backtracks=40,
    soc=True,                # second-order correction: when the full step
                             # is rejected with growing infeasibility,
                             # re-solve the factorized KKT with the
                             # post-step violation as rhs (Maratos-effect
                             # remedy; Ipopt A-5.7..5.9 role)
    refine_max=10,           # iterative-refinement round cap
    refine_tol=1e-9,         # stop refining below this relative residual
    # Acceptance: a final relative residual above it rejects the step.  A
    # rejection escalates the delta_w ladder, which treats the miss as an
    # INERTIA problem -- the right medicine when float64 refinement stalls
    # on a degenerate endgame (observed: farmer needs the dw bump or it
    # drifts to "acceptable").  Convergence tests use the iterate's TRUE
    # residuals, so acceptance looseness never falsely certifies.
    refine_accept=1e-6,
    # f32 step set: the refinement reference is the f32-assembled K (a
    # ~1e-7-relative model), so refining past ~1e-6 is meaningless and
    # every round costs a solve+matvec -- cap the loop tighter and let a
    # miss demote to f64 rather than bump delta_w
    refine_max_f32=4,
    refine_tol_f32=1e-6,
    refine_accept_f32=1e-4,
    # ir32 step set: the refinement reference is the exact f64 K, so the
    # loop can actually reach f64 quality -- but its contraction rate is
    # ~kappa(K)*eps_f32, which drifts toward 1 as mu shrinks.  Each round
    # costs only an f32 triangular solve + f64 matvec (cheap next to an
    # f64 factorization), so run MANY rounds and keep going at modest
    # contraction instead of bailing at the 0.3-rate cutoff the f64 sets
    # use.  A step that lands within refine_accept_f32 of the true system
    # is at least as good as a pure-f32 step, so accept it rather than
    # demote; demote only below that.
    refine_max_ir=25,
    refine_contract=0.3,     # stop refining when rate exceeds this
    refine_contract_ir=0.95,
    # ir32 acceptance is mu-scaled (inexact-IPM: the tolerable step error
    # scales with the barrier parameter): accept rr <= clamp(factor*mu,
    # refine_accept_f32, 1e-2).  Observed on quad-1000: the f32+IR
    # residual floors at ~1e-3 relative through the mu=1.8e-5 barrier
    # phase -- steps the filter line search takes at full alpha and no
    # worse than the pure-f32 mode's (which certifies first_order) --
    # then demotion fires at mu~1e-7 for the f64 endgame polish, exactly
    # where f32 factors genuinely run out of precision.
    refine_mu_factor_ir=100.0,
    # cap on the mu-scaled refinement TARGET (see refine_tol selection in
    # the step): the loosest residual the hot-phase loop is allowed to
    # stop at.  1e-4-and-looser caps measurably inflate the IPM iteration
    # count (quad-200: 8 -> 23); 1e-6 keeps the full-refinement trajectory
    # while still skipping the 1e-9 polish rounds in the hot phase.
    refine_tol_cap_ir=1e-6,
    # degenerate-endgame limit-cycle escape (see IpmState.acc_visits):
    # gate on the scaled KKT error (factor*tol) and primal feasibility
    # (10*tol) for what counts as a near-optimal visit, and the cumulative
    # visit count at which the solve settles for "acceptable".  Measured
    # separation on pandemic tol=1e-6: converging runs make 2-3 gated
    # visits before certifying; the (100,8)/(100,128) limit cycles make
    # 10+ and would otherwise burn max_iter (observed: 600 iterations,
    # primal at ~tol throughout, dual ray oscillating 1e-3 <-> 1e+3).
    acceptable_visit_tol_factor=1e3,
    acceptable_visit_limit=25,
    # objective sanity guard on the best-iterate tracker: near-KKT
    # candidates whose objective exceeds the best
    # feasible-ish objective seen by more than this fraction (of
    # max(1, |obj|)) are rejected -- on pandemic (100,128) the spurious
    # near-KKT points sit >100% above the incumbent (67.9 vs ~31.5-35),
    # while converging runs' genuine visits sit within tolerance of it.
    restore_obj_guard=0.1,
    # sticky regularization: after this many CONSECUTIVE failures of the
    # delta_w = 0 first attempt, start the ladder at the warm value
    # max(delta_w_min, kappa_w_minus * delta_w_last) instead -- the exact
    # value the failed probe would have retried with, so the trajectory is
    # unchanged whenever zero would have failed again, and one factorization
    # per iteration is saved.  Every reg_zero_reprobe-th iteration probes
    # zero regardless so the exact Newton step returns as soon as it works
    # (and kappa_w_minus decay drives the warm value to ~0 meanwhile, so
    # local superlinear convergence survives even without a lucky reprobe).
    # Motivation: quadrotor runs were seen failing the zero probe 7
    # iterations straight (2 factorizations per step where 1 suffices).
    # Defaults tuned on CPU quad-1000: skip=2/reprobe=8 inflated 10 -> 13
    # iterations (early-phase damped steps); skip=3/reprobe=3 reproduces
    # the no-skip trajectory exactly while still skipping ~2/3 of the
    # doomed probes inside such a streak.
    reg_zero_skip_streak=3,
    reg_zero_reprobe=3,
    max_reg_tries=30,
    y_reset_cap=1e3,
    kappa_d=1e-5,
    max_ls_failures=4,
    nlp_scaling_max_gradient=100.0,
    print_level=5,
    max_wall_time=1e20,
    mu_min_fraction=0.1,     # mu floor = tol * this
    # "float64": f64 factorization throughout.
    # "ir32":    f64 assembly + f32 factorization, refined
    #            against the exact f64 system (classical factor-low/
    #            refine-high IR): f64-quality steps at f32 factor cost for
    #            as long as the refinement contracts, then a residual-
    #            driven demotion to the all-f64 step set.
    # "float32": the whole step set low-precision -- assembly AND
    #            factorization in f32 (cheapest per step; the refinement
    #            reference is the f32 K, so steps carry ~1e-7 model error)
    #            until refinement failure demotes to f64.
    # "mixed":   like "float32" while mu > mu_switch_f32, then f64 --
    #            plus the same residual-driven demotion as a safety net.
    factor_dtype="float64",
    mu_switch_f32=1e-4,
    # ir32 barrier handover: below this mu the f32 factorization of the
    # condensed KKT is typically past its viability wall (lambda_min of
    # the equilibrated system under n*eps32, so the regularization ladder
    # needs dw ~ 1e2-1e3 that ruins Newton quality -- measured quad-1000:
    # iterations 4-17 crawl with inf_du frozen at 0.139 before the
    # residual demotion fires).  0.0 keeps the pure residual-driven
    # behavior; set ~1e-4 to hand over to the f64 endgame proactively.
    mu_switch_ir=0.0,
    linear_solver="dense",   # "dense" | "block_tridiag" | "auto" | "ldl_cpp"
    # feasibility restoration (Ipopt §3.3 role): Levenberg-Marquardt
    # Gauss-Newton descent on the (proximally damped) constraint violation,
    # reusing the condensed-KKT machinery; entered after repeated
    # line-search failures, compiled lazily only if ever triggered
    restoration=True,
    resto_max_iter=30,
    resto_max_entries=5,     # restoration rounds before giving up (stalled)
    resto_zeta=1e-6,         # proximal weight on ||x - x_entry||_{D_R}
    resto_delta_init=1e-8,   # initial LM damping
    # equality-multiplier initialization (Ipopt least_square_init_duals
    # role, which the reference can reach through its Ipopt glue):
    # "zero" starts y at the user/warmstart value (default 0);
    # "lsq" solves  min_y ||g - zl + zu + J^T y||^2 + ||y + zl_s - zu_s||^2
    # matrix-free (CG on J J^T + I, one extra device dispatch) at the
    # pushed-inside initial point.  The result is bounded by ~||J^+ r||
    # regardless of how degenerate the constraint set is -- the designed
    # entry point for families whose duals otherwise start far from the
    # stationary manifold (pandemic staged scenario growth).
    dual_init="zero",
)


class IpmSolver:
    """Interior-point solver over a :class:`SimdModel`.

    ``IpmSolver(model, **options)`` then ``solve()``; ``reset(model)`` +
    ``solve()`` re-solves reusing compiled kernels (the reference's
    SolverCore.reset!/resolve pattern, ext/InfiniteExaModelsIpopt.jl:53-61).
    """

    def __init__(self, model, kkt=None, **options):
        self.model = model
        self.opts = dict(DEFAULTS)
        self.set_options(**options)
        if kkt is None:
            kind = self.opts["linear_solver"]
            if kind in ("dense",):
                kkt = DenseKKT(model)
            elif kind in ("block_tridiag", "auto"):
                from .block_tridiag import make_structured_kkt

                kkt = make_structured_kkt(model, fallback=(kind == "auto"))
            elif kind in ("ldl_cpp", "ma27"):
                # "ma27" accepted as an alias: it names the role this path
                # plays in the reference stack (Ipopt's CPU factorization)
                # native sparse LDL^T on the host (the reference's
                # Ipopt/MA27-style CPU path)
                from .cpp_ldl import CppLdlKKT

                kkt = CppLdlKKT(model)
            else:
                raise ValueError(f"unknown linear_solver {kind!r}")
        self.kkt = kkt
        # mixed precision: a second KKT view sharing all the structure
        # analysis, factoring in native f32.  "mixed" uses it while
        # mu > mu_switch_f32; "float32" uses it for as long as the f64
        # iterative refinement keeps contracting (residual-driven demotion
        # is the only handover).  The f64 view is always retained: an
        # f32-only factorization stalls once kappa(K)*eps_f32 ~ 1.
        self.kkt32 = None
        if (self.opts["factor_dtype"] in ("mixed", "float32", "ir32")
                and hasattr(kkt, "factor_dtype")):
            import copy

            self.kkt32 = copy.copy(kkt)
            self.kkt32.factor_dtype = jnp.float32
            # ALL low-precision step sets assemble in f32: the ir32
            # refinement no longer reads the assembled K at all -- its
            # residual is measured matrix-free against the exact f64
            # operator (hvp_lag + COO jprod/jtprod), so paying an f64
            # Hessian sweep + block scatter per step for a matrix the
            # factorization immediately casts down would be pure waste.
            self.kkt32.assemble_dtype = jnp.float32
        self._build_jits()
        self._consts_cache = None

    def _build_jits(self):
        # every jitted entry rebinds the model's static family tables to
        # the copies travelling inside ``consts``: on a multi-process mesh,
        # sharded buffers must be jit ARGUMENTS (closures over
        # non-addressable arrays are rejected); single-process runs pass
        # the same committed buffers with zero overhead
        def stepw(st, c, kkt):
            with self.model.bound_tables(c.get("fam"), c.get("jac_rows"),
                                         c.get("jac_cols")), \
                    _kkt_tables(kkt, c.get("kkt")):
                return self._step(st, c, kkt)

        def initw(x0, y0, c, zl0=None, zu0=None):
            with self.model.bound_tables(c.get("fam"), c.get("jac_rows"),
                                         c.get("jac_cols")):
                return self._init_state(x0, y0, c, zl0, zu0)

        self._step_jit = jax.jit(
            lambda st, c: stepw(st, c, self.kkt), donate_argnums=(0,))
        self._init_jit = jax.jit(initw, static_argnames=())
        self._consts_jit = jax.jit(self._make_consts)
        self._restore_jit = None     # compiled lazily on first breakdown
        self._extract_jit = None     # single-dispatch result extraction
        self._lsq_jit = None         # lazily built for dual_init="lsq"
        self._du_jit = None          # lazily built for the dual polish
        self._stepw = stepw
        # device-side multi-iteration driver: one host round-trip per chunk
        # (per-iteration dispatch and readback latency dominates otherwise)

        def probe_of(s):
            # the host's control scalars ride back WITH the chunk result:
            # one extra tiny array in an existing dispatch instead of
            # three separate device->host fetches
            return jnp.stack([s.status.astype(self.model.dtype),
                              s.iter.astype(self.model.dtype), s.mu])

        def run_chunk(st, consts, iter_cap):
            def cond(s):
                return (s.status == RUNNING) & (s.iter < iter_cap)

            st = jax.lax.while_loop(
                cond, lambda s: stepw(s, consts, self.kkt), st)
            return st, probe_of(st)

        self._run_jit = jax.jit(run_chunk, donate_argnums=(0,))
        self._probe_of = probe_of

        # f32-phase drivers (compiled lazily): identical step, f32 KKT;
        # the chunk loop additionally exits once mu crosses the switch so
        # the host can hand the state to the f64 endgame
        self._step32_jit = None
        self._run32_jit = None
        if getattr(self, "kkt32", None) is not None:
            self._step32_jit = jax.jit(
                lambda st, c: stepw(st, c, self.kkt32),
                donate_argnums=(0,))

            def run_chunk32(st, consts, iter_cap, mu_switch):
                def cond(s):
                    return ((s.status == RUNNING) & (s.iter < iter_cap)
                            & (s.mu > mu_switch))

                st = jax.lax.while_loop(
                    cond, lambda s: stepw(s, consts, self.kkt32), st)
                return st, probe_of(st)

            self._run32_jit = jax.jit(run_chunk32, donate_argnums=(0,))

    # options that are runtime values (changing them never retraces)
    _RUNTIME_OPTS = frozenset({
        "tol", "acceptable_tol", "acceptable_iter", "mu_init", "max_iter",
        "max_wall_time", "print_level",
        "dual_init",   # host-side init decision; own lazily-built jit
    })

    def set_options(self, **options):
        rebuild = False
        for k, v in options.items():
            if k not in DEFAULTS:
                raise ValueError(f"unknown IPM option {k!r}")
            if self.opts.get(k) != v and k not in self._RUNTIME_OPTS:
                rebuild = True
            self.opts[k] = v
        if rebuild and hasattr(self, "_step_jit"):
            # algorithmic constants are baked into the trace; re-jit
            self._build_jits()

    def reset(self, model=None):
        """Prepare for a re-solve; model shape must be unchanged so compiled
        kernels stay valid."""
        if model is not None and model is not self.model:
            if (model.nvar != self.model.nvar
                    or model.ncon != self.model.ncon):
                raise ValueError("reset with a different-shaped model")
            self.model = model
        return self

    # ------------------------------------------------------------------
    # problem-constant data for one solve
    # ------------------------------------------------------------------
    def _make_consts(self, theta, x0=None, lvar=None, uvar=None):
        m = self.model
        o = self.opts
        dt = m.dtype
        # mutable model data comes in as ARGUMENTS so the jitted version
        # never bakes stale warm-start/bound values
        x0 = m.x0 if x0 is None else x0
        lvar = m.lvar if lvar is None else lvar
        uvar = m.uvar if uvar is None else uvar
        # gradient-based scaling at x0 (Ipopt nlp_scaling_method=gradient-based)
        gmax = o["nlp_scaling_max_gradient"]
        g0 = m.grad(x0, theta) * m.sense
        sf = jnp.minimum(1.0, gmax / jnp.maximum(jnp.max(jnp.abs(g0)), 1e-8))
        jv0 = m.jac_vals(x0, theta)
        # per-constraint-row max |J|
        rowmax = jnp.zeros(m.ncon, dt).at[m.jac_rows].max(jnp.abs(jv0))
        sc = jnp.minimum(1.0, gmax / jnp.maximum(rowmax, 1e-8))

        lcon = m.lcon * sc
        ucon = m.ucon * sc
        lz = jnp.concatenate([lvar, lcon])
        uz = jnp.concatenate([uvar, ucon])
        # Ipopt-style bound_relax_factor: every finite bound is relaxed
        # outward by kr*max(1,|b|).  This both lifts equalities/fixed
        # variables (LiftedKKT-style, so the condensed system stays regular)
        # and reproduces the solver-reported objectives of the reference
        # oracle values, which embed exactly this perturbation.
        kr = o["kappa_relax"]
        lz = jnp.where(jnp.isfinite(lz),
                       lz - kr * jnp.maximum(1.0, jnp.abs(lz)), lz)
        uz = jnp.where(jnp.isfinite(uz),
                       uz + kr * jnp.maximum(1.0, jnp.abs(uz)), uz)
        has_l = jnp.isfinite(lz)
        has_u = jnp.isfinite(uz)
        return dict(
            theta=theta, sf=sf, sc=sc, lz=lz, uz=uz,
            has_l=has_l, has_u=has_u,
            # runtime (non-baked) options so option changes between resolves
            # never retrace (the reference exercises exactly this:
            # test/madnlp.jl tol/mu_init transitions)
            tol=jnp.asarray(o["tol"], dt),
            acceptable_tol=jnp.asarray(o["acceptable_tol"], dt),
            acceptable_iter=jnp.asarray(o["acceptable_iter"], jnp.int32),
            mu_init=jnp.asarray(
                -1.0 if o["mu_init"] == "auto" else o["mu_init"], dt),
        )

    # -- scaled model evaluations ---------------------------------------
    def _feval(self, x, c):
        return self.model.obj(x, c["theta"]) * self.model.sense * c["sf"]

    def _geval(self, x, c):
        return self.model.grad(x, c["theta"]) * self.model.sense * c["sf"]

    def _ceval(self, x, c):
        return self.model.cons(x, c["theta"]) * c["sc"]

    def _jvals(self, x, c):
        return self.model.jac_vals(x, c["theta"]) * c["sc"][self.model.jac_rows]

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _init_state(self, x0, y0, consts, zl0=None, zu0=None):
        m = self.model
        o = self.opts
        dt = m.dtype
        n, mm = m.nvar, m.ncon
        lz, uz = consts["lz"], consts["uz"]
        has_l, has_u = consts["has_l"], consts["has_u"]
        k1, k2 = o["bound_push"], o["bound_frac"]

        def push_inside(z, lo, hi, hl, hu):
            both = hl & hu
            span = jnp.where(both, hi - lo, 1.0)
            pl = jnp.where(
                both,
                jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(lo)), k2 * span),
                k1 * jnp.maximum(1.0, jnp.abs(lo)))
            pu = jnp.where(
                both,
                jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(hi)), k2 * span),
                k1 * jnp.maximum(1.0, jnp.abs(hi)))
            z = jnp.where(hl, jnp.maximum(z, lo + pl), z)
            z = jnp.where(hu, jnp.minimum(z, hi - pu), z)
            return z

        x = push_inside(x0, lz[:n], uz[:n], has_l[:n], has_u[:n])
        c0 = self._ceval(x, consts)
        s = push_inside(c0, lz[n:], uz[n:], has_l[n:], has_u[n:])
        z = jnp.concatenate([x, s])
        # warm bound duals (Ipopt warm_start_init_point role): clipped to
        # a strictly interior band so complementarity products stay sane
        if zl0 is None:
            zl = jnp.where(has_l, 1.0, 0.0).astype(dt)
        else:
            zl = jnp.where(has_l, jnp.clip(zl0.astype(dt), 1e-8, 1e10), 0.0)
        if zu0 is None:
            zu = jnp.where(has_u, 1.0, 0.0).astype(dt)
        else:
            zu = jnp.where(has_u, jnp.clip(zu0.astype(dt), 1e-8, 1e10), 0.0)
        theta0 = jnp.sum(jnp.abs(c0 - s))
        # scale-aware automatic initial barrier: far-infeasible starts need
        # a hot barrier or fraction-to-boundary crawls (observed 527 -> 41
        # iterations on the farmer LP family); the MAX-norm keeps the
        # heuristic size-independent
        theta_inf = jnp.max(jnp.abs(c0 - s), initial=0.0)
        mu_auto = jnp.clip(0.1 * jnp.maximum(1.0, theta_inf), 0.1, 100.0)
        mu = jnp.where(consts["mu_init"] < 0, mu_auto, consts["mu_init"])
        theta_max = 1e4 * jnp.maximum(1.0, theta0)
        ft = jnp.full((FILTER_SIZE,), jnp.inf, dt).at[0].set(theta_max)
        fp = jnp.full((FILTER_SIZE,), -jnp.inf, dt)
        return IpmState(
            x=x, s=s, y=y0, zl=zl, zu=zu, lz=lz, uz=uz, mu=mu,
            tau=jnp.maximum(o["tau_min"], 1.0 - mu),
            delta_w_last=jnp.zeros((), dt),
            zero_fail_streak=jnp.asarray(0, jnp.int32),
            filter_theta=ft, filter_phi=fp,
            filter_len=jnp.asarray(1, jnp.int32),
            iter=jnp.asarray(0, jnp.int32),
            status=jnp.asarray(RUNNING, jnp.int32),
            acceptable_count=jnp.asarray(0, jnp.int32),
            small_step_count=jnp.asarray(0, jnp.int32),
            ls_fail_count=jnp.asarray(0, jnp.int32),
            acc_visits=jnp.asarray(0, jnp.int32),
            best_E=jnp.asarray(jnp.inf, dt),
            best_inf_pr=jnp.asarray(jnp.inf, dt),
            best_inf_du=jnp.asarray(jnp.inf, dt),
            best_fobj=jnp.asarray(jnp.inf, dt),
            feas_fobj=jnp.asarray(jnp.inf, dt),
            best_x=x, best_s=s, best_y=y0, best_zl=zl, best_zu=zu,
            log_obj=jnp.zeros((), dt), log_inf_pr=theta0,
            log_inf_du=jnp.zeros((), dt),
            log_alpha=jnp.zeros((), dt), log_alpha_z=jnp.zeros((), dt),
            log_ls=jnp.asarray(0, jnp.int32), log_delta_w=jnp.zeros((), dt),
            log_rr=jnp.zeros((), dt),
            log_E0=jnp.asarray(jnp.inf, dt),
            n_factor=jnp.asarray(0, jnp.int32),
            n_refine=jnp.asarray(0, jnp.int32),
        )

    # ------------------------------------------------------------------
    # residuals
    # ------------------------------------------------------------------
    def _kkt_error(self, st, consts, grad, jvals, cval, mu):
        """(E, inf_pr, inf_du, inf_comp) with Ipopt's s_d/s_c scalings."""
        m = self.model
        o = self.opts
        n = m.nvar
        z = jnp.concatenate([st.x, st.s])
        lz, uz = st.lz, st.uz
        has_l, has_u = consts["has_l"], consts["has_u"]
        jty = m.jtprod(jvals, st.y)
        rd = jnp.concatenate([grad + jty, -st.y]) - st.zl + st.zu
        rp = cval - st.s
        compl_l = jnp.where(has_l, (z - lz) * st.zl - mu, 0.0)
        compl_u = jnp.where(has_u, (uz - z) * st.zu - mu, 0.0)
        nb = jnp.sum(has_l) + jnp.sum(has_u)
        ny = m.ncon
        smax = o["s_max"]
        ssum = jnp.sum(jnp.abs(st.y)) + jnp.sum(jnp.abs(st.zl)) + \
            jnp.sum(jnp.abs(st.zu))
        sd = jnp.maximum(smax, ssum / jnp.maximum(1, ny + nb)) / smax
        sc_ = jnp.maximum(smax,
                          (jnp.sum(jnp.abs(st.zl)) + jnp.sum(jnp.abs(st.zu)))
                          / jnp.maximum(1, nb)) / smax
        inf_du = jnp.max(jnp.abs(rd)) if rd.size else jnp.zeros((), z.dtype)
        inf_pr = (jnp.max(jnp.abs(rp)) if rp.size
                  else jnp.zeros((), z.dtype))
        inf_comp = jnp.maximum(
            jnp.max(jnp.abs(compl_l), initial=0.0),
            jnp.max(jnp.abs(compl_u), initial=0.0))
        E = jnp.maximum(jnp.maximum(inf_du / sd, inf_pr), inf_comp / sc_)
        return E, inf_pr, inf_du, inf_comp, sd, sc_

    # ------------------------------------------------------------------
    # merit pieces
    # ------------------------------------------------------------------
    def _phi(self, x, s, fval, lz, uz, consts, mu):
        z = jnp.concatenate([x, s])
        has_l, has_u = consts["has_l"], consts["has_u"]
        dl = jnp.where(has_l, z - lz, 1.0)
        du = jnp.where(has_u, uz - z, 1.0)
        # log of nonpositive slack -> +inf barrier (trial point rejected)
        bl = jnp.where(has_l, -jnp.log(dl), 0.0)
        bu = jnp.where(has_u, -jnp.log(du), 0.0)
        phi = fval + mu * (jnp.sum(bl) + jnp.sum(bu))
        # Waechter-Biegler bound damping (§3.7, Ipopt kappa_d): linear terms
        # on one-sided-bounded variables keep degenerate multipliers bounded
        kd = self.opts["kappa_d"]
        damp_l = has_l & ~has_u
        damp_u = has_u & ~has_l
        phi = phi + kd * mu * (jnp.sum(jnp.where(damp_l, dl, 0.0))
                               + jnp.sum(jnp.where(damp_u, du, 0.0)))
        return phi

    # ------------------------------------------------------------------
    # one IPM iteration
    # ------------------------------------------------------------------
    def _step(self, st: IpmState, consts, kkt=None):
        kkt = kkt if kkt is not None else self.kkt
        m = self.model
        o = self.opts
        dt = m.dtype
        n, mm = m.nvar, m.ncon
        has_l, has_u = consts["has_l"], consts["has_u"]
        tol = consts["tol"]

        # tiny-slack correction: if a bound distance has collapsed to the
        # floating-point cancellation level (lifted equality slacks do this
        # when c(x) sits outside the relaxation window), move the bound
        # outward by eps^(3/4)*max(1,|b|) so Sigma stays representable
        eps = jnp.finfo(dt).eps
        z_all = jnp.concatenate([st.x, st.s])
        maxl = jnp.maximum(1.0, jnp.abs(st.lz))
        maxu = jnp.maximum(1.0, jnp.abs(st.uz))
        lz = jnp.where(has_l & (z_all - st.lz < 10 * eps * maxl),
                       st.lz - eps ** 0.75 * maxl, st.lz)
        uz = jnp.where(has_u & (st.uz - z_all < 10 * eps * maxu),
                       st.uz + eps ** 0.75 * maxu, st.uz)
        st = st._replace(lz=lz, uz=uz)

        # fused sweeps: one vmapped trace per family for (f, grad) and
        # (c, J) instead of two -- halves the family-kernel count of the
        # compiled step (compile time grows with module size)
        fval_u, grad_u = m.obj_and_grad(st.x, consts["theta"])
        fval = fval_u * m.sense * consts["sf"]
        grad = grad_u * m.sense * consts["sf"]
        cval_u, jvals_u = m.cons_and_jac(st.x, consts["theta"])
        cval = cval_u * consts["sc"]
        jvals = jvals_u * consts["sc"][m.jac_rows]

        # -- convergence -------------------------------------------------
        E0, inf_pr, inf_du, inf_comp, sd, sc_ = self._kkt_error(
            st, consts, grad, jvals, cval, jnp.zeros((), dt))
        converged = E0 <= tol
        # Ipopt-style acceptable criteria: scaled overall error within
        # acceptable_tol AND the component-wise guards (whose loose dual
        # default 1e10 tolerates degenerate multiplier rays)
        acc_now = ((E0 <= consts["acceptable_tol"])
                   & (inf_pr <= o["acceptable_constr_viol_tol"])
                   & (inf_du / sd <= o["acceptable_dual_inf_tol"])
                   & (inf_comp / sc_ <= o["acceptable_compl_inf_tol"]))
        acceptable_count = jnp.where(acc_now, st.acceptable_count + 1, 0)
        acc_done = acceptable_count >= consts["acceptable_iter"]
        bad = ~jnp.isfinite(E0)
        diverged = (jnp.abs(fval) > 1e20) | (jnp.max(jnp.abs(st.x)) > 1e20)

        # best-iterate tracker + near-optimal VISIT counter (degenerate-
        # endgame limit-cycle escape).  On problems whose multiplier set is
        # unbounded (pandemic's singular-arc state constraint), the endgame
        # cycles: the iterate touches the solution (E0 ~ 1e-4), the next
        # dual step overshoots along the ray (E0 ~ 1e+3), recovery resets,
        # repeat -- certification never happens and max_iter burns.  The
        # NON-consecutive count of near-optimal visits separates this cleanly
        # from slow-but-converging runs (measured, pandemic tol=1e-6:
        # (51,4) makes 2 sub-1e-3 visits before certifying at iter 302;
        # (100,8) makes 10+ in its cycle and never certifies in 600).  At
        # ``acceptable_visit_limit`` visits the solve terminates
        # "acceptable" and RESTORES the best iterate seen (the Ipopt role:
        # SOLVED_TO_ACCEPTABLE_LEVEL).
        # The visit/best metric is the KKT error with the W-B scalings
        # CAPPED at s_max: the raw scaled E0 divides inf_du by the average
        # multiplier size, so a degenerate ray with |y| ~ 1e5 makes a
        # far-from-optimal point look stationary (measured, pandemic
        # (100,128): a feasible iterate at objective 67.9 vs optimum ~31.5
        # scored E0=7.9e-4).  Capping the leniency keeps "near-optimal"
        # meaning near-optimal while still tolerating moderately large
        # multipliers.  Primal gate 1e2*tol: the degenerate primal floor
        # grows with grid size (measured 7.6e-7 at (51,4), 1.2e-6 at
        # (100,8), 2.2e-5 at (100,128)); still two orders tighter than
        # Ipopt's acceptable_constr_viol_tol default of 1e-2.
        E_cap = jnp.maximum(
            jnp.maximum(inf_du / jnp.minimum(sd, o["s_max"]), inf_pr),
            inf_comp / jnp.minimum(sc_, o["s_max"]))
        # objective sanity guard: the bound evolves
        # as better feasible-ish objectives appear; a stored best that the
        # evolving bound now rejects is dropped (its E reset to inf so any
        # sane candidate replaces it and the restore gates skip it).
        feasish = inf_pr <= 1e2 * tol
        feas_fobj = jnp.where(feasish, jnp.minimum(st.feas_fobj, fval),
                              st.feas_fobj)
        obj_bound = feas_fobj + o["restore_obj_guard"] * jnp.maximum(
            1.0, jnp.abs(feas_fobj))
        obj_ok = fval <= obj_bound
        stale = jnp.isfinite(st.best_fobj) & (st.best_fobj > obj_bound)
        prev_best_E = jnp.where(stale, jnp.inf, st.best_E)
        visit = ((E_cap <= o["acceptable_visit_tol_factor"] * tol)
                 & (inf_pr <= 1e2 * tol) & obj_ok)
        acc_visits = st.acc_visits + visit.astype(jnp.int32)
        better = (E_cap < prev_best_E) & obj_ok
        best_E = jnp.where(better, E_cap, prev_best_E)
        best_fobj = jnp.where(better, fval, st.best_fobj)
        best_inf_pr = jnp.where(better, inf_pr, st.best_inf_pr)
        best_inf_du = jnp.where(better, inf_du, st.best_inf_du)
        best_x = jnp.where(better, st.x, st.best_x)
        best_s = jnp.where(better, st.s, st.best_s)
        best_y = jnp.where(better, st.y, st.best_y)
        best_zl = jnp.where(better, st.zl, st.best_zl)
        best_zu = jnp.where(better, st.zu, st.best_zu)
        cycle_stop = ((acc_visits >= o["acceptable_visit_limit"])
                      & ~converged & jnp.isfinite(best_E))

        status = jnp.where(
            converged, FIRST_ORDER,
            jnp.where(bad, INVALID,
                      jnp.where(diverged, DIVERGED,
                                jnp.where(acc_done | cycle_stop,
                                          ACCEPTABLE, RUNNING))))

        # -- barrier update (may fire repeatedly) -------------------------
        # adaptive mode ("barrier" option, the MadNLP AdaptiveUpdate /
        # Ipopt adaptive-mu role, reference test/madnlp.jl:32-34 barrier
        # strategies): when the monotone trigger fires, the next mu is the
        # LOQO centrality rule sigma = 0.1*min(0.05*(1-xi)/xi, 2)^3 applied
        # to the average complementarity (Vanderbei/LOQO; Ipopt
        # mu_oracle="loqo"), CLIPPED into [monotone schedule, 0.8*mu] so a
        # badly-centered iterate slows the barrier descent instead of
        # overshooting it -- mu still decreases strictly, so the
        # Waechter-Biegler filter globalization is untouched.
        if o["barrier"] == "adaptive":
            z0 = jnp.concatenate([st.x, st.s])
            dl0 = jnp.where(has_l, z0 - lz, 1.0)
            du0 = jnp.where(has_u, uz - z0, 1.0)
            cp = jnp.concatenate([
                jnp.where(has_l, dl0 * st.zl, 0.0),
                jnp.where(has_u, du0 * st.zu, 0.0)])
            cmask = jnp.concatenate([has_l, has_u])
            ncomp = jnp.maximum(jnp.sum(cmask), 1)
            avg_c = jnp.sum(jnp.where(cmask, cp, 0.0)) / ncomp
            min_c = jnp.min(jnp.where(cmask, cp, jnp.inf))
            xi = min_c / jnp.maximum(avg_c, jnp.finfo(dt).tiny)
            sig_c = 0.1 * jnp.minimum(
                0.05 * (1.0 - xi) / jnp.maximum(xi, 1e-12), 2.0) ** 3
            mu_loqo = sig_c * avg_c
        else:
            mu_loqo = None

        def mu_cond(val):
            mu, tau, flen, ftheta, fphi = val
            E_mu = self._kkt_error(st, consts, grad, jvals, cval, mu)[0]
            mu_floor = tol * o["mu_min_fraction"]
            return (E_mu <= o["kappa_epsilon"] * mu) & (mu > mu_floor)

        def mu_body(val):
            mu, tau, flen, ftheta, fphi = val
            mu_new = jnp.maximum(
                tol * o["mu_min_fraction"],
                jnp.minimum(o["kappa_mu"] * mu, mu ** o["theta_mu"]))
            if mu_loqo is not None:
                mu_new = jnp.clip(mu_loqo, mu_new, 0.8 * mu)
            tau_new = jnp.maximum(o["tau_min"], 1.0 - mu_new)
            # reset filter to the theta_max entry only
            ftheta_new = jnp.full_like(ftheta, jnp.inf).at[0].set(ftheta[0])
            fphi_new = jnp.full_like(fphi, -jnp.inf)
            return (mu_new, tau_new, jnp.asarray(1, jnp.int32),
                    ftheta_new, fphi_new)

        mu, tau, filter_len, filter_theta, filter_phi = jax.lax.while_loop(
            mu_cond, mu_body,
            (st.mu, st.tau, st.filter_len, st.filter_theta, st.filter_phi))

        # -- barrier-scaled quantities ------------------------------------
        z = jnp.concatenate([st.x, st.s])
        dl = jnp.where(has_l, z - lz, 1.0)
        du = jnp.where(has_u, uz - z, 1.0)
        sig_l = jnp.where(has_l, st.zl / dl, 0.0)
        sig_u = jnp.where(has_u, st.zu / du, 0.0)
        sigma = sig_l + sig_u                       # (n+m,)
        mu_dl = jnp.where(has_l, mu / dl, 0.0)
        mu_du = jnp.where(has_u, mu / du, 0.0)

        # bound-damping gradient contribution (one-sided bounds only)
        kd = o["kappa_d"]
        damp = kd * mu * (jnp.where(has_l & ~has_u, 1.0, 0.0)
                          - jnp.where(has_u & ~has_l, 1.0, 0.0))
        jty = m.jtprod(jvals, st.y)
        rx = grad + jty - mu_dl[:n] + mu_du[:n] + damp[:n]
        rs = -st.y - mu_dl[n:] + mu_du[n:] + damp[n:]
        rp = cval - st.s

        # -- condensed system with inertia-free regularization ------------
        sigma_x, sigma_s = sigma[:n], sigma[n:]

        # dual regularization is ALWAYS on: it caps D = 1/(1/Sigma_s+dc) for
        # the lifted equality rows, keeping the condensed system factorizable
        # in f64 (the conditioning tradeoff of condensed-space IPMs; cf.
        # PAPERS.md condensed-space papers' use of regularization+refinement)
        # mu-floored dual regularization: letting delta_c follow mu all the
        # way down makes D ~ 1/delta_c blow past what any factorization can
        # carry on degenerate problems (multiplier rays); the floor keeps
        # the endgame system factorable while the full-space refinement
        # keeps the step exact for the TRUE (regularized) system
        delta_c_floor = o["delta_c_bar"] * \
            jnp.maximum(mu, o["delta_c_mu_floor"]) ** 0.25

        # dual-ray proximal damping (see the ray_* options): traced scalar
        # switch, zero everywhere except inside a live ray signature
        if o["ray_damping"]:
            ray_live = ((jnp.max(jnp.abs(st.y), initial=0.0)
                         > o["ray_y_cap"])
                        & (inf_pr <= 1e2 * tol)
                        & (inf_du / jnp.minimum(sd, o["s_max"])
                           > o["acceptable_visit_tol_factor"] * tol))
            delta_prox = jnp.where(ray_live, o["ray_delta"], 0.0)
        else:
            delta_prox = jnp.zeros((), dt)
        y_excess = st.y - jnp.clip(st.y, -o["ray_y_cap"], o["ray_y_cap"])

        # structural primal-dual proximal regularization (Friedlander-
        # Orban-style): an ALWAYS-ON mu-scaled dual damping
        # -delta_pd*dy in the constraint rows, i.e. the proximal center is
        # the CURRENT multiplier (y_ref = y_k), so the rhs is untouched and
        # the fixed point is the unregularized KKT point -- only the dual
        # STEP is damped.  On the pandemic dynamics-adjoint chain the
        # near-null-space dual directions otherwise produce the overshoot/
        # recovery limit cycle; damping by 1/(1+delta_pd*||row||) decays
        # the ray component geometrically per iteration while mu-scaling
        # makes the damping vanish in the endgame (healthy problems keep
        # their superlinear tail).  Off by default (prox_dual_kappa=0);
        # pandemic builds opt in.
        if o["prox_dual_kappa"]:
            delta_pd = jnp.where(mu <= o["prox_dual_mu_max"],
                                 o["prox_dual_kappa"] * mu, 0.0)
        else:
            delta_pd = jnp.zeros((), dt)

        # the f32 step set demotes on refinement failure instead of walking
        # the regularization ladder: a precision failure is not an inertia
        # failure, and bumping delta_w for it damps the Newton direction
        # into a crawl (the observed pure-f32 stall mode).  Static at trace
        # time: True only for the kkt32-bound step functions.
        can_demote = kkt is getattr(self, "kkt32", None) and kkt is not None
        # the fully-low-precision step set computes the refinement residual
        # itself in f32, whose noise floor sits just above the f64
        # acceptance (observed rr ~ 1e-6 at the f32 floor); hold it to the
        # f32 thresholds instead or every step demotes instantly.  The
        # "ir32" step set refines MATRIX-FREE against the exact f64
        # operator (hvp_lag + COO jprod/jtprod -- the assembled K is f32
        # and only feeds the factorization): aim for the f64
        # target with the long/loose ir loop, but ACCEPT anything at least
        # as good as a pure-f32 step (refine_accept_f32 vs the true
        # system) -- demoting the whole solve because one iterate only
        # reached f32 quality throws away the cheap factorization exactly
        # when the barrier phase tolerates inexact steps (observed:
        # quad-1000 certifies first_order on pure-f32 steps).
        ir_ref = can_demote and o["factor_dtype"] == "ir32"
        lowprec_ref = can_demote and not ir_ref
        sfx = "_f32" if lowprec_ref else ""
        refine_tol = o["refine_tol" if ir_ref else "refine_tol" + sfx]
        refine_accept = o["refine_accept_f32" if ir_ref
                          else "refine_accept" + sfx]
        refine_max = o["refine_max_ir" if ir_ref else "refine_max" + sfx]
        refine_contract = o["refine_contract_ir" if ir_ref
                            else "refine_contract"]
        if ir_ref:
            # mu-scaled acceptance (traced: mu is this iteration's barrier
            # parameter, already updated above) -- see refine_mu_factor_ir
            refine_accept = jnp.clip(o["refine_mu_factor_ir"] * mu,
                                     refine_accept, 1e-2)
            # mu-scaled refinement TARGET as well: chasing the f64 target
            # (refine_tol) in the hot barrier phase costs extra f64-matvec
            # + f32-solve rounds per step for accuracy the filter never
            # uses (observed on quad-1000: rr columns reach
            # 1e-10..1e-13 while acceptance sits at 1e-4..1e-2).  Unlike
            # the acceptance, the target is NOT floored at f32 quality --
            # it tightens with mu all the way to refine_tol so the endgame
            # Newton steps stay near-exact and the superlinear tail is
            # preserved (floor-at-5e-6 variant measured +8..11 IPM
            # iterations on quad-200)
            refine_tol = jnp.clip(0.05 * o["refine_mu_factor_ir"] * mu,
                                  refine_tol, o["refine_tol_cap_ir"])

        def make_step(delta_w, delta_c):
            inv_ss = 1.0 / (sigma_s + delta_w)
            D = 1.0 / (inv_ss + delta_c + delta_prox + delta_pd)
            diag_extra = sigma_x + delta_w
            # model-side values are for UNSCALED f and c: fold scalings in
            # (internal y multiplies scaled c_i = sc_i*c_i; scaled J = sc*J)
            sc = consts["sc"]
            K = kkt.assemble(st.x, consts["theta"],
                                  st.y * sc,
                                  consts["sf"] * m.sense,
                                  D * sc * sc, diag_extra)
            fac, ok = kkt.factor(K)

            rhs2 = rp + inv_ss * rs - delta_prox * y_excess
            rhs = -(rx + m.jtprod(jvals, D * rhs2))
            # sharded-iterate fast path: on the
            # shard_map-aligned backends the solve AND the whole refinement
            # loop below run in T-layout (per-device block slots + a
            # replicated border) with zero O(n) collectives; the one O(n)
            # all-gather per step direction is the final tl_scatter that
            # hands dx back to the replicated iterate.  ir32 is excluded:
            # its exact-f64 operator is model-side (hvp_lag) and needs the
            # replicated vector each round anyway.
            use_tl = (getattr(kkt, "tlayout", False) and not ir_ref
                      and not getattr(kkt, "exact_solve", False))
            if use_tl:
                r_tl = kkt.tl_gather(rhs)
                dx_tl = kkt.solve_tl(fac, r_tl)
                dx = None
            else:
                dx = kkt.solve(fac, rhs)
            # Residual-driven iterative refinement of the CONDENSED solve.
            # (Full-space refinement of (dx, ds, dy) jointly was tried and
            # reverted: the slack-dual row (Sigma_s)*ds carries a rounding
            # floor of eps*Sigma_s ~ 1e-5*|ds| through the huge lifted-
            # equality Sigma entries, so a full-space acceptance gate can
            # never be satisfied on degenerate problems and the step gets
            # spuriously regularized into a crawl.)  The loop body is
            # traced ONCE (while_loop); it exits early when the relative
            # residual is small or stops contracting, and a final residual
            # above ``refine_accept`` marks the step failed so the
            # regularization ladder escalates -- the analogue of MadNLP's
            # refinement-failure handling.  For the BCR backend
            # each round is a handful of batched matmuls.
            if not getattr(kkt, "exact_solve", False):
                rhs_norm = jnp.linalg.norm(rhs) + jnp.finfo(dt).tiny

                if ir_ref:
                    # exact f64 residual operator, MATRIX-FREE: one
                    # jvp-of-grad sweep (hvp_lag) + two COO J products +
                    # the condensed diagonal.  The f32-assembled K feeds
                    # only the factorization, so no f64 Hessian sweep or
                    # block scatter is paid anywhere in the step.
                    lam_s = st.y * sc

                    def Kmv(w):
                        return (m.hvp_lag(st.x, consts["theta"], lam_s,
                                          consts["sf"] * m.sense, w)
                                + m.jtprod(jvals, D * m.jprod(jvals, w))
                                + diag_extra * w)
                else:
                    def Kmv(w):
                        return kkt.matvec(K, w)

                if ir_ref:
                    # f32-factor-PRECONDITIONED CG in f64 (instead of plain
                    # IR): plain refinement contracts at rho ~ kappa*eps of
                    # the f32-assembled factor per round, while PCG's
                    # polynomial acceleration converges in O(sqrt) of the
                    # rounds at IDENTICAL per-round cost (one exact matvec
                    # + one preconditioner solve).  The condensed K is SPD
                    # whenever the f32 Cholesky succeeded, which the
                    # regularization ladder already guarantees before this
                    # step direction can be accepted.
                    resid0 = rhs - Kmv(dx)

                    def pcg_cond(val):
                        _, _, _, _, _, _, best_rr, prev_best, i = val
                        # continue while above target, still improving the
                        # best iterate by >=(1-contract) per round, and
                        # under the round cap
                        return ((best_rr > refine_tol)
                                & (best_rr < refine_contract * prev_best)
                                & (i < refine_max))

                    def pcg_body(val):
                        xc, r, z, p, rz, best_x, best_rr, _, i = val
                        Kp = Kmv(p)
                        pKp = jnp.vdot(p, Kp)
                        # guard: non-SPD curvature or breakdown -> freeze
                        # (alpha=0 keeps the iterate; cond exits on stall)
                        good = pKp > 0
                        alpha = jnp.where(good, rz / jnp.where(good, pKp, 1.0),
                                          0.0)
                        xn = xc + alpha * p
                        rn = r - alpha * Kp
                        zn = kkt.solve(fac, rn)
                        rzn = jnp.vdot(rn, zn)
                        beta = jnp.where(good & (rz != 0), rzn / rz, 0.0)
                        pn = zn + beta * p
                        rrn = jnp.linalg.norm(rn) / rhs_norm
                        better = rrn < best_rr
                        best_xn = jnp.where(better, xn, best_x)
                        best_rrn = jnp.where(better, rrn, best_rr)
                        return (xn, rn, zn, pn, rzn, best_xn, best_rrn,
                                best_rr, i + 1)

                    z0 = kkt.solve(fac, resid0)
                    rr0 = jnp.linalg.norm(resid0) / rhs_norm
                    init = (dx, resid0, z0, z0, jnp.vdot(resid0, z0),
                            dx, rr0, jnp.asarray(jnp.inf, dt),
                            jnp.asarray(0, jnp.int32))
                    (_, _, _, _, _, dx, rr_final, _, rounds) = \
                        jax.lax.while_loop(pcg_cond, pcg_body, init)
                    ref_ok = rr_final <= refine_accept
                else:
                    # generic refinement over either layout: replicated
                    # vectors (single-device / GSPMD backends) or T-layout
                    # pairs (aligned sharded backends -- zero O(n)
                    # collectives per round)
                    if use_tl:
                        vnorm, vsub, vadd = (kkt.tl_norm, kkt.tl_sub,
                                             kkt.tl_add)
                        vsel = kkt.tl_where
                        ksolve = lambda r: kkt.solve_tl(fac, r)
                        kmv = lambda w: kkt.matvec_tl(K, w)
                        rhs_v, dx_v = r_tl, dx_tl
                    else:
                        vnorm, vsub, vadd = (jnp.linalg.norm, jnp.subtract,
                                             jnp.add)
                        vsel = lambda p, a, b: jnp.where(p, a, b)
                        ksolve = lambda r: kkt.solve(fac, r)
                        kmv = Kmv
                        rhs_v, dx_v = rhs, dx

                    def ref_cond(val):
                        _, resid, prev, i = val
                        rr = vnorm(resid) / rhs_norm
                        return ((rr > refine_tol)
                                & (rr < refine_contract * prev)
                                & (i < refine_max))

                    def ref_body(val):
                        dxc, resid, prev, i = val
                        dxn = vadd(dxc, ksolve(resid))
                        residn = vsub(rhs_v, kmv(dxn))
                        rr = vnorm(resid) / rhs_norm
                        rrn = vnorm(residn) / rhs_norm
                        # keep the better iterate if refinement diverges
                        worse = rrn > rr
                        dxn = vsel(worse, dxc, dxn)
                        residn = vsel(worse, resid, residn)
                        return dxn, residn, rr, i + 1

                    resid0 = vsub(rhs_v, kmv(dx_v))
                    dx_v, resid, _, rounds = jax.lax.while_loop(
                        ref_cond, ref_body,
                        (dx_v, resid0, jnp.asarray(jnp.inf, dt),
                         jnp.asarray(0, jnp.int32)))
                    rr_final = vnorm(resid) / rhs_norm
                    ref_ok = rr_final <= refine_accept
                    dx = kkt.tl_scatter(dx_v) if use_tl else dx_v
            else:
                rr_final = jnp.zeros((), dt)
                ref_ok = jnp.asarray(True)
                rounds = jnp.asarray(0, jnp.int32)
            dy = D * (m.jprod(jvals, dx) + rhs2)
            ds = inv_ss * (dy - rs)
            ok = ok & jnp.all(jnp.isfinite(dx)) & \
                jnp.all(jnp.isfinite(dy)) & jnp.all(jnp.isfinite(ds))
            # the factorization travels out of the regularization ladder so
            # the second-order correction can reuse it (one extra solve,
            # no refactorization)
            return dx, ds, dy, ok, ref_ok, rr_final.astype(dt), fac, rounds

        # the FIRST attempt (delta_w = 0) runs as iteration 0 of the same
        # while_loop so make_step -- the assemble+factor+solve subgraph, by
        # far the largest in the module -- is traced exactly once.
        # (Escalating delta_c in this ladder was tried and reverted: the
        # inconsistent dual regularization across retries destabilizes
        # degenerate-multiplier problems more than the delta_w damping it
        # was meant to avoid.)
        def reg_cond(val):
            _, _, ok, tries, _, demote, _, _, _ = val
            return (~ok) & (~demote) & (tries < o["max_reg_tries"])

        # sticky regularization: while the zero probe has a live failure
        # streak, start the ladder directly at the warm value it would have
        # retried with (identical trajectory when zero would fail; one
        # factorization per iteration saved); reprobe zero periodically
        warm_dw = jnp.maximum(o["delta_w_min"],
                              o["kappa_w_minus"] * st.delta_w_last)
        skip_zero = ((st.zero_fail_streak >= o["reg_zero_skip_streak"])
                     & (st.iter % o["reg_zero_reprobe"] != 0)
                     & (st.delta_w_last > 0.0))
        first_dw = jnp.where(skip_zero, warm_dw, 0.0)

        def reg_body(val):
            _, dw, ok, tries, dw_used, _, _, _, nref = val
            bump_from_zero = jnp.where(
                st.delta_w_last == 0.0, o["delta_w_init"],
                warm_dw)
            dw_new = jnp.where(
                tries == 0, first_dw,
                jnp.where(dw == 0.0, bump_from_zero,
                          dw * jnp.where(st.delta_w_last == 0.0,
                                         o["kappa_w_plus_init"],
                                         o["kappa_w_plus"])))
            dx, ds, dy, fac_ok, ref_ok, rr, fac, rounds = make_step(
                dw_new, delta_c_floor)
            # precision failure (factorization fine, refinement cannot
            # contract): hand over to the f64 step set rather than damping
            demote = (jnp.asarray(bool(can_demote)) & fac_ok & ~ref_ok)
            return ((dx, ds, dy), dw_new, fac_ok & ref_ok, tries + 1,
                    dw_new, demote, rr, fac, nref + rounds)

        zero_dir = (jnp.zeros(n, dt), jnp.zeros(mm, dt), jnp.zeros(mm, dt))
        # zero-valued pytree with the factorization's structure (shapes come
        # from an abstract trace of make_step -- no FLOPs at runtime)
        fac_sd = jax.eval_shape(make_step, jnp.zeros((), dt),
                                jnp.zeros((), dt))[6]
        fac0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), fac_sd)
        ((dx, ds, dy), dw_f, ok_f, n_tries, dw_used, need_demote, rr_f,
         fac_f, n_rounds) = jax.lax.while_loop(
            reg_cond, reg_body,
            (zero_dir, jnp.zeros((), dt), jnp.asarray(False),
             jnp.asarray(0, jnp.int32), jnp.zeros((), dt),
             jnp.asarray(False), jnp.zeros((), dt), fac0,
             jnp.asarray(0, jnp.int32)))
        if can_demote:
            status = jnp.where((status == RUNNING) & need_demote,
                               DEMOTE_F32, status)

        def ftb_primal(dza):
            """Fraction-to-boundary step cap for a primal direction."""
            neg = dza < 0
            pos = dza > 0
            a_l = jnp.where(has_l & neg,
                            -tau * dl / jnp.where(neg, dza, -1.0), jnp.inf)
            a_u = jnp.where(has_u & pos,
                            tau * du / jnp.where(pos, dza, 1.0), jnp.inf)
            return jnp.minimum(1.0, jnp.minimum(
                jnp.min(a_l, initial=jnp.inf),
                jnp.min(a_u, initial=jnp.inf)))

        alpha_max = ftb_primal(jnp.concatenate([dx, ds]))

        # -- filter line search ------------------------------------------
        theta_c = jnp.sum(jnp.abs(rp))
        phi_c = self._phi(st.x, st.s, fval, lz, uz, consts, mu)
        gphi_x = grad - mu_dl[:n] + mu_du[:n] + damp[:n]
        gphi_s = -mu_dl[n:] + mu_du[n:] + damp[n:]
        dphi = jnp.dot(gphi_x, dx) + jnp.dot(gphi_s, ds)

        gt, gp = o["gamma_theta"], o["gamma_phi"]

        def trial_at(dxa, dsa, alpha):
            xt = st.x + alpha * dxa
            stt = st.s + alpha * dsa
            ft = self._feval(xt, consts)
            ct = self._ceval(xt, consts)
            theta_t = jnp.sum(jnp.abs(ct - stt))
            phi_t = self._phi(xt, stt, ft, lz, uz, consts, mu)
            return theta_t, phi_t

        def acceptable_to_filter(theta_t, phi_t):
            # filter entries are stored WITH their margins applied
            # ((1-gt)*theta_k, phi_k - gp*theta_k), so the test is raw
            idx = jnp.arange(FILTER_SIZE)
            active = idx < filter_len
            dominated = active & (theta_t >= filter_theta) & \
                (phi_t >= filter_phi)
            return ~jnp.any(dominated)

        def accept_test(alpha, theta_t, phi_t):
            finite = jnp.isfinite(theta_t) & jnp.isfinite(phi_t)
            in_filter = acceptable_to_filter(theta_t, phi_t)
            switching = (dphi < 0) & \
                (alpha * (-dphi) ** o["s_phi"] >
                 o["delta"] * theta_c ** o["s_theta"])
            armijo = phi_t <= phi_c + o["eta_phi"] * alpha * dphi
            progress = (theta_t <= (1 - gt) * theta_c) | \
                (phi_t <= phi_c - gp * theta_c)
            acc = finite & in_filter & \
                jnp.where(switching, armijo, progress)
            return acc, switching & armijo

        # first trial at alpha_max with the uncorrected direction
        theta_t0, phi_t0 = trial_at(dx, ds, alpha_max)
        acc0, ftype0 = accept_test(alpha_max, theta_t0, phi_t0)

        if o["soc"]:
            # -- second-order correction (Ipopt A-5.7..5.9 role) ---------
            # when the full step is rejected with theta not improving, the
            # rejection is typically curvature of the active constraint
            # surface (Maratos effect): solve the SAME factorized KKT once
            # more with the post-step constraint violation as rhs and test
            # the corrected step before falling back to backtracking.
            inv_ss_f = 1.0 / (sigma_s + dw_used)
            D_f = 1.0 / (inv_ss_f + delta_c_floor + delta_prox + delta_pd)
            need_soc = ok_f & (~acc0) & (theta_t0 >= theta_c)

            def soc_branch(_):
                stt = st.s + alpha_max * ds
                ct = self._ceval(st.x + alpha_max * dx, consts)
                rp_soc = alpha_max * rp + (ct - stt)
                rhs2s = rp_soc + inv_ss_f * rs - delta_prox * y_excess
                rhs_s = -(rx + m.jtprod(jvals, D_f * rhs2s))
                dxs = kkt.solve(fac_f, rhs_s)
                dys = D_f * (m.jprod(jvals, dxs) + rhs2s)
                dss = inv_ss_f * (dys - rs)
                good = (jnp.all(jnp.isfinite(dxs))
                        & jnp.all(jnp.isfinite(dss))
                        & jnp.all(jnp.isfinite(dys)))
                a_soc = ftb_primal(jnp.concatenate([dxs, dss]))
                th_s, ph_s = trial_at(dxs, dss, a_soc)
                # W-B tests the corrected point against the ORIGINAL
                # step's alpha_max (model decrease of the uncorrected
                # direction)
                acc_s, ftype_s = accept_test(alpha_max, th_s, ph_s)
                # kappa_soc guard (W-B A-5.9): the correction exists to
                # REDUCE infeasibility -- a corrected step that merely
                # passes the filter without shrinking theta (e.g. noise-
                # level theta near convergence) must not displace the
                # plain backtracking polish
                use = good & acc_s & (th_s <= 0.99 * theta_c)
                return dxs, dss, dys, a_soc, th_s, ph_s, use, ftype_s

            def no_soc(_):
                return (dx, ds, dy, alpha_max, theta_t0, phi_t0,
                        jnp.asarray(False), ftype0)

            dx_s, ds_s, dy_s, a_soc, th_s, ph_s, use_soc, ftype_s = \
                jax.lax.cond(need_soc, soc_branch, no_soc, None)
            pick = lambda a, b: jnp.where(use_soc, a, b)
            dx = jax.tree.map(pick, dx_s, dx)
            ds = jax.tree.map(pick, ds_s, ds)
            dy = jax.tree.map(pick, dy_s, dy)
            start_alpha = pick(a_soc, jnp.where(acc0, alpha_max,
                                                0.5 * alpha_max))
            start_acc = acc0 | use_soc
            theta_init = pick(th_s, theta_t0)
            phi_init = pick(ph_s, phi_t0)
            ftype_init = pick(ftype_s, ftype0)
        else:
            start_alpha = jnp.where(acc0, alpha_max, 0.5 * alpha_max)
            start_acc = acc0
            theta_init, phi_init, ftype_init = theta_t0, phi_t0, ftype0

        def ls_cond(val):
            alpha, accepted, ls_iters, *_ = val
            return (~accepted) & (ls_iters < o["max_backtracks"])

        def ls_body(val):
            alpha, accepted, ls_iters, _, _, _ = val
            theta_t, phi_t = trial_at(dx, ds, alpha)
            acc, ftype = accept_test(alpha, theta_t, phi_t)
            return (jnp.where(acc, alpha, alpha * 0.5), acc, ls_iters + 1,
                    theta_t, phi_t, ftype)

        alpha, accepted, ls_iters, theta_t, phi_t, f_type = \
            jax.lax.while_loop(
                ls_cond, ls_body,
                (start_alpha, start_acc, jnp.asarray(1, jnp.int32),
                 theta_init, phi_init, ftype_init))

        # dual directions from complementarity linearization (for the
        # FINAL direction, post-SOC) + their fraction-to-boundary cap
        dz = jnp.concatenate([dx, ds])
        acl = jnp.where(has_l, dl * st.zl - mu, 0.0)
        acu = jnp.where(has_u, du * st.zu - mu, 0.0)
        dzl = jnp.where(has_l, -sig_l * dz - acl / dl, 0.0)
        dzu = jnp.where(has_u, sig_u * dz - acu / du, 0.0)
        negl = dzl < 0
        negu = dzu < 0
        a_zl = jnp.where(has_l & negl,
                         -tau * st.zl / jnp.where(negl, dzl, -1.0), jnp.inf)
        a_zu = jnp.where(has_u & negu,
                         -tau * st.zu / jnp.where(negu, dzu, -1.0), jnp.inf)
        alpha_z = jnp.minimum(1.0, jnp.minimum(jnp.min(a_zl, initial=jnp.inf),
                                               jnp.min(a_zu, initial=jnp.inf)))

        # augment filter unless the accepted step was an f-type (Armijo) step
        add_to_filter = accepted & ~f_type
        slot = jnp.minimum(filter_len, FILTER_SIZE - 1)
        filter_theta = jnp.where(
            add_to_filter,
            filter_theta.at[slot].set((1 - gt) * theta_c), filter_theta)
        filter_phi = jnp.where(
            add_to_filter,
            filter_phi.at[slot].set(phi_c - gp * theta_c), filter_phi)
        filter_len = jnp.where(add_to_filter,
                               jnp.minimum(filter_len + 1, FILTER_SIZE),
                               filter_len)

        # -- updates ------------------------------------------------------
        # Line-search failure fallback (in place of a full feasibility
        # restoration phase): keep the primal point, damp the multipliers
        # and recenter the bound duals on the current barrier target, reset
        # the filter, and try again; repeated failures stall out.  This is
        # the escape hatch Ipopt reaches via its restoration's multiplier
        # re-estimation.
        failed = ~accepted
        if can_demote:
            # a REPEATED 40-backtrack line-search failure in the f32 phase
            # is far more likely a precision-poisoned direction than a
            # genuinely unusable Newton step: hand the unchanged state to
            # the f64 step set instead of burning a destructive
            # multiplier-reset / restoration entry on it.  The first
            # failure gets the same recovery the f64 path uses -- iteration
            # 1 routinely fails its line search from the pushed initial
            # point on every backend, and demoting on it would kill the
            # f32 phase before it starts.
            demote_ls = failed & (st.ls_fail_count >= 1)
            status = jnp.where((status == RUNNING) & demote_ls, DEMOTE_F32,
                               status)
            failed = failed & ~demote_ls
        alpha = jnp.where(failed, 0.0, alpha)
        cap = o["y_reset_cap"]
        # reheat the barrier on failure: the monotone schedule can plunge mu
        # while the iterate is still infeasible (then primal infeasibility
        # regrows with no way back); restoration-style recovery re-centers
        # at a mu matched to the current infeasibility
        mu = jnp.where(failed,
                       jnp.minimum(0.1, jnp.maximum(mu, 10.0 * inf_pr)), mu)
        tau = jnp.where(failed,
                        jnp.maximum(o["tau_min"], 1.0 - mu), tau)
        x_new = st.x + alpha * dx
        s_new = st.s + alpha * ds
        y_new = jnp.where(failed, jnp.clip(st.y, -cap, cap),
                          st.y + alpha * dy)
        zl_reset = jnp.where(has_l, mu / dl, 0.0)
        zu_reset = jnp.where(has_u, mu / du, 0.0)
        zl_new = jnp.where(failed, zl_reset, st.zl + alpha_z * dzl)
        zu_new = jnp.where(failed, zu_reset, st.zu + alpha_z * dzu)
        filter_theta = jnp.where(
            failed, jnp.full_like(filter_theta, jnp.inf).at[0].set(
                filter_theta[0]), filter_theta)
        filter_phi = jnp.where(failed,
                               jnp.full_like(filter_phi, -jnp.inf),
                               filter_phi)
        filter_len = jnp.where(failed, jnp.asarray(1, jnp.int32), filter_len)
        ls_fail_count = jnp.where(failed, st.ls_fail_count + 1,
                                  jnp.asarray(0, jnp.int32))
        z_new = jnp.concatenate([x_new, s_new])
        dln = jnp.where(has_l, z_new - lz, 1.0)
        dun = jnp.where(has_u, uz - z_new, 1.0)
        ks = o["kappa_sigma"]
        zl_new = jnp.where(has_l,
                           jnp.clip(zl_new, mu / (ks * dln), ks * mu / dln),
                           0.0)
        zu_new = jnp.where(has_u,
                           jnp.clip(zu_new, mu / (ks * dun), ks * mu / dun),
                           0.0)

        # small-step detection
        step_sz = alpha * jnp.max(jnp.abs(dz) / (1.0 + jnp.abs(z)),
                                  initial=0.0)
        small = (step_sz < 10 * jnp.finfo(dt).eps) & accepted
        small_count = jnp.where(small, st.small_step_count + 1, 0)
        status = jnp.where(
            (status == RUNNING) & (ls_fail_count >= o["max_ls_failures"]),
            NEED_RESTORATION if o["restoration"] else STALLED, status)
        status = jnp.where((status == RUNNING) & (small_count >= 3),
                           STALLED, status)

        stop = status != RUNNING
        keep = lambda new, old: jnp.where(stop, old, new)
        # limit-cycle stop: hand back the BEST iterate seen, not wherever
        # in the overshoot cycle the visit counter happened to fire
        restore = cycle_stop & (status == ACCEPTABLE)
        pick_b = lambda best, cur: jnp.where(restore, best, cur)

        return IpmState(
            x=pick_b(best_x, keep(x_new, st.x)),
            s=pick_b(best_s, keep(s_new, st.s)),
            y=pick_b(best_y, keep(y_new, st.y)),
            zl=pick_b(best_zl, keep(zl_new, st.zl)),
            zu=pick_b(best_zu, keep(zu_new, st.zu)),
            lz=lz, uz=uz,
            mu=mu, tau=tau,
            delta_w_last=jnp.where(dw_used > 0, dw_used, st.delta_w_last),
            # streak bookkeeping: only iterations that actually PROBED zero
            # update it (failure -> +1, success -> reset); skipped probes
            # leave it until the next reprobe iteration settles the question
            zero_fail_streak=jnp.where(
                skip_zero, st.zero_fail_streak,
                jnp.where(dw_used > 0, st.zero_fail_streak + 1,
                          jnp.asarray(0, jnp.int32))).astype(jnp.int32),
            filter_theta=filter_theta, filter_phi=filter_phi,
            filter_len=filter_len.astype(jnp.int32),
            iter=(st.iter + jnp.where(stop, 0, 1)).astype(jnp.int32),
            status=status.astype(jnp.int32),
            acceptable_count=acceptable_count.astype(jnp.int32),
            small_step_count=small_count.astype(jnp.int32),
            ls_fail_count=ls_fail_count.astype(jnp.int32),
            acc_visits=acc_visits.astype(jnp.int32),
            best_E=best_E, best_inf_pr=best_inf_pr,
            best_inf_du=best_inf_du,
            best_fobj=best_fobj, feas_fobj=feas_fobj,
            best_x=best_x, best_s=best_s, best_y=best_y,
            best_zl=best_zl, best_zu=best_zu,
            log_obj=fval,
            log_inf_pr=pick_b(best_inf_pr, inf_pr),
            log_inf_du=pick_b(best_inf_du, inf_du),
            log_alpha=alpha, log_alpha_z=alpha_z, log_ls=ls_iters,
            log_delta_w=dw_used, log_rr=rr_f, log_E0=E0,
            n_factor=st.n_factor + n_tries,
            n_refine=st.n_refine + n_rounds,
        )

    def _lsq_duals(self, st, consts):
        """Least-squares equality multipliers at the initial point (Ipopt
        ``least_square_init_duals`` role).  With the lifted slack rows the
        stationarity residual is ``[g - zl_x + zu_x + J^T y;
        -(y + zl_s - zu_s)]``, whose normal equations are
        ``(J J^T + I) y = -J r_x - zl_s + zu_s`` -- the ``+ I`` from the
        slack rows makes plain CG well-conditioned.  Matrix-free: two COO
        J-products per CG round, no factorization, one device dispatch.

        The solution is bounded by ``~||J^+|| ||r||`` no matter how
        degenerate the active set is, which is the point: on families with
        an unbounded multiplier ray (pandemic singular arc) a bounded,
        stationarity-consistent y start replaces the zero/transferred
        duals that otherwise have to grow their near-singular profile at
        crawling step sizes (README known-limits record)."""
        m = self.model
        n = m.nvar
        dt = m.dtype
        tiny = jnp.finfo(dt).tiny
        jvals = self._jvals(st.x, consts)
        rx = self._geval(st.x, consts) - st.zl[:n] + st.zu[:n]
        b = -m.jprod(jvals, rx) - st.zl[n:] + st.zu[n:]

        def Amv(y):
            return m.jprod(jvals, m.jtprod(jvals, y)) + y

        bb = jnp.vdot(b, b)
        y0 = jnp.zeros(m.ncon, dt)

        def cond(c):
            _, _, _, rs, k = c
            return (k < 200) & (rs > 1e-24 * bb)

        def body(c):
            y, p, r, rs, k = c
            Ap = Amv(p)
            alpha = rs / (jnp.vdot(p, Ap) + tiny)
            y = y + alpha * p
            r = r - alpha * Ap
            rs_new = jnp.vdot(r, r)
            p = r + (rs_new / (rs + tiny)) * p
            return y, p, r, rs_new, k + 1

        y, *_ = jax.lax.while_loop(
            cond, body, (y0, b, b, bb, jnp.asarray(0, jnp.int32)))
        return y

    def _ensure_lsq_jit(self):
        if self._lsq_jit is None:
            def lsqw(s, c):
                with self.model.bound_tables(
                        c.get("fam"), c.get("jac_rows"),
                        c.get("jac_cols")):
                    return self._lsq_duals(s, c)

            self._lsq_jit = jax.jit(lsqw)
        return self._lsq_jit

    def _compute_consts(self, theta, m):
        """One-shot problem constants.

        The device-resident result is CACHED across solves, keyed on a
        content fingerprint of (theta, x0, bounds) plus the option values
        that feed the dict, so a warm re-solve uploads nothing.

        With a device mesh on the model the constants are placed
        replicated on that mesh, next to the row-sharded family tables.
        In a multi-process run the module is traced on the host CPU
        backend against the numpy twins of the static family arrays
        (``host_data``): a trace against the sharded device buffers would
        close over arrays this process cannot address."""
        o = self.opts
        multiproc = jax.process_count() > 1
        key = None
        try:
            key = (m.consts_fingerprint(), o["nlp_scaling_max_gradient"],
                   o["kappa_relax"], o["tol"], o["acceptable_tol"],
                   o["acceptable_iter"], o["mu_init"], multiproc)
            cached = getattr(self, "_consts_cache", None)
            if cached is not None and cached[0] == key:
                return cached[1]
        except Exception:
            key = None
        mesh = getattr(m, "mesh", None)
        if multiproc:
            # local_devices: jax.devices() enumerates every process's
            # devices; committing to another process's device makes the
            # result unfetchable here
            cpu = jax.local_devices(backend="cpu")[0]
            x0_np = m._x0_np if getattr(m, "_x0_np", None) is not None \
                else np.asarray(m.core.x0)
            with m.host_data(), jax.default_device(cpu):
                out = jax.jit(self._make_consts)(
                    np.asarray(m.core.theta), x0_np,
                    np.asarray(m.core.lvar), np.asarray(m.core.uvar))
            out = {k: np.asarray(v) for k, v in out.items()}
            if mesh is None:
                out = {k: jax.device_put(v, jax.local_devices()[0])
                       for k, v in out.items()}
        else:
            out = self._consts_jit(theta, m.x0, m.lvar, m.uvar)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            repl = NamedSharding(mesh, PartitionSpec())
            out = {k: jax.device_put(v, repl) for k, v in out.items()}
        if key is not None:
            self._consts_cache = (key, out)
        return out

    # ------------------------------------------------------------------
    # feasibility restoration (role of Ipopt §3.3, which the reference
    # inherits through its ext glue at
    # reference ext/InfiniteExaModelsIpopt.jl:48-50).  Formulation:
    # damped Gauss-Newton (Levenberg-Marquardt) descent on
    #     theta(x) = 1/2 ||c(x) - mid(c(x))||^2 + zeta/2 ||D_R (x-x_R)||^2
    # where mid() clips onto the slack bounds, reusing the SAME condensed
    # assemble/factor/solve path (lam=0, sigma=0, d=sc^2 gives exactly
    # J^T J on the Hessian sparsity pattern).  Entered from the host loop
    # on NEED_RESTORATION, so the module compiles lazily only when a
    # line-search breakdown actually happens.
    # ------------------------------------------------------------------
    def _restore(self, st: IpmState, consts):
        m = self.model
        o = self.opts
        dt = m.dtype
        n = m.nvar
        has_l, has_u = consts["has_l"], consts["has_u"]
        lzx, uzx = st.lz[:n], st.uz[:n]
        lzs, uzs = st.lz[n:], st.uz[n:]
        hl_x, hu_x = has_l[:n], has_u[:n]
        hl_s, hu_s = has_l[n:], has_u[n:]
        sc = consts["sc"]
        x_ref = st.x
        # Ipopt-style proximal scaling D_R = min(1, 1/|x_R|)
        DR = jnp.minimum(1.0, 1.0 / jnp.maximum(jnp.abs(x_ref), 1e-8))
        zeta = o["resto_zeta"] * jnp.sqrt(jnp.maximum(st.mu, 1e-12))

        def violation(c):
            mid = jnp.clip(c, jnp.where(hl_s, lzs, -jnp.inf),
                           jnp.where(hu_s, uzs, jnp.inf))
            return c - mid

        def theta_of(x):
            r = violation(self._ceval(x, consts))
            prox = x - x_ref
            th = 0.5 * (jnp.vdot(r, r) + zeta * jnp.vdot(DR * prox, prox))
            return th, jnp.vdot(r, r)

        # exit once the raw violation is far below the tolerance the main
        # loop needs (the proximal term keeps theta itself > 0)
        r2_exit = (0.01 * consts["tol"]) ** 2

        def cond(val):
            x, delta, th, r2, it = val
            return (r2 > r2_exit) & (it < o["resto_max_iter"])

        def body(val):
            x, delta, th, r2, it = val
            cval, jvals = m.cons_and_jac(x, consts["theta"])
            cval = cval * sc
            jvals = jvals * sc[m.jac_rows]
            r = violation(cval)
            grad_phi = m.jtprod(jvals, r) + zeta * DR * (x - x_ref)
            zero_y = jnp.zeros(m.ncon, dt)
            K = self.kkt.assemble(x, consts["theta"], zero_y,
                                  jnp.zeros((), dt), sc * sc,
                                  zeta * DR + delta)
            fac, okf = self.kkt.factor(K)
            dx = self.kkt.solve(fac, -grad_phi)
            okf = okf & jnp.all(jnp.isfinite(dx))
            # fraction-to-boundary on the variable box
            neg, pos = dx < 0, dx > 0
            a_l = jnp.where(hl_x & neg,
                            -0.99 * (x - lzx) / jnp.where(neg, dx, -1.0),
                            jnp.inf)
            a_u = jnp.where(hu_x & pos,
                            0.99 * (uzx - x) / jnp.where(pos, dx, 1.0),
                            jnp.inf)
            alpha = jnp.minimum(1.0, jnp.minimum(
                jnp.min(a_l, initial=jnp.inf),
                jnp.min(a_u, initial=jnp.inf)))
            xt = x + alpha * dx
            th_t, r2_t = theta_of(xt)
            accept = okf & jnp.isfinite(th_t) & (th_t < th)
            x = jnp.where(accept, xt, x)
            delta = jnp.where(accept,
                              jnp.maximum(delta * 0.25,
                                          o["resto_delta_init"]),
                              jnp.maximum(delta * 10.0, 1e-6))
            return (x, delta, jnp.where(accept, th_t, th),
                    jnp.where(accept, r2_t, r2), it + 1)

        th0, r20 = theta_of(st.x)
        x, _, th, _, _ = jax.lax.while_loop(
            cond, body,
            (st.x, jnp.asarray(o["resto_delta_init"], dt), th0, r20,
             jnp.asarray(0, jnp.int32)))

        # re-enter the main IPM: slacks recentred inside their bounds,
        # multipliers re-estimated conservatively, filter reset
        c = self._ceval(x, consts)
        k1, k2 = self.opts["bound_push"], self.opts["bound_frac"]
        both = hl_s & hu_s
        span = jnp.where(both, uzs - lzs, 1.0)
        pl = jnp.where(both,
                       jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(lzs)),
                                   k2 * span),
                       k1 * jnp.maximum(1.0, jnp.abs(lzs)))
        pu = jnp.where(both,
                       jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(uzs)),
                                   k2 * span),
                       k1 * jnp.maximum(1.0, jnp.abs(uzs)))
        s = c
        s = jnp.where(hl_s, jnp.maximum(s, lzs + pl), s)
        s = jnp.where(hu_s, jnp.minimum(s, uzs - pu), s)
        mu = jnp.maximum(st.mu, 1e-6)
        z_all = jnp.concatenate([x, s])
        dl = jnp.where(has_l, z_all - st.lz, 1.0)
        du = jnp.where(has_u, st.uz - z_all, 1.0)
        zl = jnp.where(has_l, mu / dl, 0.0)
        zu = jnp.where(has_u, mu / du, 0.0)
        ft = jnp.full_like(st.filter_theta, jnp.inf).at[0].set(
            st.filter_theta[0])
        fp = jnp.full_like(st.filter_phi, -jnp.inf)
        return st._replace(
            x=x, s=s, y=jnp.zeros_like(st.y), zl=zl, zu=zu,
            mu=mu, tau=jnp.maximum(self.opts["tau_min"], 1.0 - mu),
            filter_theta=ft, filter_phi=fp,
            filter_len=jnp.asarray(1, jnp.int32),
            status=jnp.asarray(RUNNING, jnp.int32),
            ls_fail_count=jnp.asarray(0, jnp.int32),
            zero_fail_streak=jnp.asarray(0, jnp.int32),
            acc_visits=jnp.asarray(0, jnp.int32),
            best_E=jnp.asarray(jnp.inf, dt),
            best_inf_pr=jnp.asarray(jnp.inf, dt),
            best_inf_du=jnp.asarray(jnp.inf, dt),
            best_fobj=jnp.asarray(jnp.inf, dt),
            feas_fobj=jnp.asarray(jnp.inf, dt),
            best_x=x, best_s=s, best_y=jnp.zeros_like(st.y),
            best_zl=zl, best_zu=zu,
            small_step_count=jnp.asarray(0, jnp.int32),
            acceptable_count=jnp.asarray(0, jnp.int32))

    # ------------------------------------------------------------------
    # per-phase profiling (SURVEY.md §5: the reference parses solver text
    # logs post-hoc; here the split is measured directly on device)
    # ------------------------------------------------------------------
    def profile_phases(self, state=None, consts=None, reps=3):
        """Wall-time the IPM step's phases separately at the given state
        (default: the initial point): model evaluations (fused value+grad
        and cons+jac sweeps), KKT assemble, factor, solve, and one full
        step.  Each phase is jitted on its own and timed warm over
        ``reps`` repetitions; returns seconds per call."""
        m = self.model
        if consts is None:
            consts = self._compute_consts(m.theta, m)
        if state is None:
            state = self._init_jit(m.x0, m.y0, consts)
        x, theta = state.x, consts["theta"]
        lam = state.y * consts["sc"]
        d = jnp.ones(m.ncon, m.dtype)
        de = jnp.ones(m.nvar, m.dtype)
        rhs = jnp.ones(m.nvar, m.dtype)

        def timed(fn, *args):
            out = fn(*args)          # compile
            jax.block_until_ready(out)
            t0 = time.time()
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
            return (time.time() - t0) / reps

        prof = {}
        prof["eval_obj_grad"] = timed(jax.jit(m.obj_and_grad), x, theta)
        prof["eval_cons_jac"] = timed(jax.jit(m.cons_and_jac), x, theta)
        # the Hessian AD sweep alone (assemble = this + the block scatter):
        # splits the assemble cost into AD and scatter shares
        prof["kkt_vals"] = timed(
            jax.jit(lambda xx, ll, dd: m.kkt_vals(
                xx, theta, ll, consts["sf"] * m.sense, dd)), x, lam, d)
        if self.kkt32 is not None and \
                getattr(self.kkt32, "assemble_dtype", None) is not None:
            prof["kkt_vals_f32"] = timed(
                jax.jit(lambda xx, ll, dd: m.kkt_vals(
                    xx, theta, ll, consts["sf"] * m.sense, dd,
                    dtype=self.kkt32.assemble_dtype)), x, lam, d)
        asm = jax.jit(lambda xx, ll, dd, ee: self.kkt.assemble(
            xx, theta, ll, consts["sf"] * m.sense, dd, ee))
        K = asm(x, lam, d, de)
        prof["assemble"] = timed(asm, x, lam, d, de)
        fac_fn = jax.jit(self.kkt.factor)
        fac, _ = fac_fn(K)
        prof["factor"] = timed(lambda KK: fac_fn(KK)[0], K)
        prof["solve"] = timed(jax.jit(self.kkt.solve), fac, rhs)
        if self.kkt32 is not None:
            fac32_fn = jax.jit(self.kkt32.factor)
            fac32, _ = fac32_fn(K)
            prof["factor_f32"] = timed(lambda KK: fac32_fn(KK)[0], K)
            prof["solve_f32"] = timed(jax.jit(self.kkt32.solve), fac32, rhs)
        prof["full_step"] = timed(
            lambda s: self._step_jit(jax.tree.map(jnp.copy, s), consts),
            state)
        if self._step32_jit is not None:
            prof["full_step_f32"] = timed(
                lambda s: self._step32_jit(jax.tree.map(jnp.copy, s),
                                           consts),
                state)
        return prof

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY.md §5: the reference has only in-memory
    # warm restart; long IPM runs need preemption-safe state)
    # ------------------------------------------------------------------
    def save_checkpoint(self, path, state):
        np.savez(path, **{k: np.asarray(v)
                          for k, v in state._asdict().items()})

    def load_checkpoint(self, path):
        data = np.load(path)
        vals = {k: jnp.asarray(data[k]) for k in data.files}
        # checkpoints written before a log field existed load fine
        vals.setdefault("log_rr", jnp.zeros(()))
        vals.setdefault("acc_visits", jnp.zeros((), jnp.int32))
        vals.setdefault("best_E", jnp.asarray(jnp.inf))
        vals.setdefault("best_inf_pr", jnp.asarray(jnp.inf))
        vals.setdefault("best_inf_du", jnp.asarray(jnp.inf))
        vals.setdefault("best_fobj", jnp.asarray(jnp.inf))
        vals.setdefault("feas_fobj", jnp.asarray(jnp.inf))
        vals.setdefault("best_x", vals["x"])
        vals.setdefault("best_s", vals["s"])
        vals.setdefault("best_y", vals["y"])
        vals.setdefault("best_zl", vals["zl"])
        vals.setdefault("best_zu", vals["zu"])
        vals.setdefault("log_E0", jnp.asarray(jnp.inf))
        vals.setdefault("zero_fail_streak", jnp.zeros((), jnp.int32))
        vals.setdefault("n_factor", jnp.zeros((), jnp.int32))
        vals.setdefault("n_refine", jnp.zeros((), jnp.int32))
        return IpmState(**vals)

    # ------------------------------------------------------------------
    # host driver
    # ------------------------------------------------------------------
    def solve(self, x0=None, y0=None, stats=None, resume_from=None,
              checkpoint_path=None, checkpoint_every=0, trace_dir=None,
              zl0=None, zu0=None,
              **options):
        """Run the IPM.  With ``trace_dir`` set, the whole solve is
        captured as a jax profiler trace (XLA op-level timeline viewable
        in TensorBoard/Perfetto) -- the structured complement to the
        host-side ``timers`` split (SURVEY.md §5: the reference only
        parses solver text logs post-hoc)."""
        if trace_dir is None:
            return self._solve_impl(x0, y0, stats, resume_from,
                                    checkpoint_path, checkpoint_every,
                                    zl0=zl0, zu0=zu0, **options)
        with jax.profiler.trace(str(trace_dir)):
            return self._solve_impl(x0, y0, stats, resume_from,
                                    checkpoint_path, checkpoint_every,
                                    zl0=zl0, zu0=zu0, **options)

    def _solve_impl(self, x0=None, y0=None, stats=None, resume_from=None,
                    checkpoint_path=None, checkpoint_every=0,
                    zl0=None, zu0=None, **options):
        if options:
            self.set_options(**options)
        o = self.opts
        m = self.model
        t_start = time.time()
        theta = m.theta
        consts = dict(self._compute_consts(theta, m))
        # static tables travel as jit arguments (multi-process safe)
        consts["fam"] = m.fam_tables()
        consts["jac_rows"] = m.jac_rows
        consts["jac_cols"] = m.jac_cols
        kt = getattr(self.kkt, "tables", None)
        if kt is not None and kt() is not None:
            consts["kkt"] = kt()
        x0 = m.x0 if x0 is None else jnp.asarray(x0, m.dtype)
        y0 = m.y0 if y0 is None else jnp.asarray(y0, m.dtype)
        # internal y is for the scaled problem: y_scaled = y_user*sf/sc*sense
        y0s = y0 * m.sense * consts["sf"] / consts["sc"]
        if resume_from is not None:
            st = self.load_checkpoint(resume_from)
        elif zl0 is not None or zu0 is not None:
            # warm bound duals (Ipopt warm_start_init_point role).
            # ``zl0``/``zu0`` are user-scale VARIABLE bound duals (length
            # nvar); the slack halves are recovered from y0 through the
            # s-row stationarity y = zu_s - zl_s of this solver's KKT.
            def full(z_var, y_part):
                zv = (jnp.zeros(m.nvar, m.dtype) if z_var is None
                      else jnp.asarray(z_var, m.dtype) * consts["sf"]
                      * m.sense)
                return jnp.concatenate([zv, y_part])
            zl_full = full(zl0, jnp.maximum(-y0s, 0.0))
            zu_full = full(zu0, jnp.maximum(y0s, 0.0))
            st = self._init_jit(x0, y0s, consts, zl_full, zu_full)
        else:
            st = self._init_jit(x0, y0s, consts)
        if o["dual_init"] == "lsq" and resume_from is None:
            y_lsq = self._ensure_lsq_jit()(st, consts)
            # distinct buffer for best_y: the chunk jits donate the whole
            # state, and aliased leaves trip XLA's double-donation check
            st = st._replace(y=y_lsq, best_y=jnp.array(y_lsq, copy=True))
        # first_chunk isolates the first jitted dispatch (compile +
        # cache-miss cost) from the warm steps so
        # callers can report compile_s and warm iter/s as separate
        # first-class metrics instead of conflating them into solve_time
        timers = {"build": np.nan, "step_total": 0.0, "first_chunk": np.nan}
        status = "max_iter"
        verbose = o["print_level"] >= 5
        if verbose:
            print("iter    objective    inf_pr   inf_du     mu    "
                  "alpha  alpha_z  ls   dw      rr      E0")
        it = 0
        resto_entries = 0
        prev_chunk_obj = None      # recalc_y_stall objective-stall gate
        chunk = 1 if verbose else 32
        # "float32": no mu-based handover -- the low-precision path runs
        # until its refinement stops contracting (DEMOTE_F32).  "ir32"
        # optionally hands over at mu_switch_ir (see option docs); the
        # residual-driven demotion stays armed as the safety net.
        if o["factor_dtype"] == "float32":
            mu_switch = 0.0
        elif o["factor_dtype"] == "ir32":
            mu_switch = o["mu_switch_ir"]
        else:
            mu_switch = o["mu_switch_f32"]
        f32_demoted = False
        mu_host = float(st.mu)
        while it < o["max_iter"]:
            t0 = time.time()
            # mixed precision: run the f32-factorization step set while the
            # barrier is hot; its chunk loop self-exits when mu crosses the
            # switch (or a step demotes on refinement failure) and the f64
            # endgame takes over
            use32 = (self._step32_jit is not None and not f32_demoted
                     and mu_host > mu_switch)
            if chunk == 1:
                st = (self._step32_jit if use32 else self._step_jit)(
                    st, consts)
                probe = np.asarray(self._probe_of(st))
            else:
                # device-side multi-iteration driver: one host round-trip
                # per chunk (dispatch latency dominates a per-iteration
                # loop); the control scalars come back in the same
                # dispatch (see probe_of)
                cap = jnp.asarray(min(it + chunk, o["max_iter"]), jnp.int32)
                if use32:
                    st, probe = self._run32_jit(
                        st, consts, cap, jnp.asarray(mu_switch, m.dtype))
                else:
                    st, probe = self._run_jit(st, consts, cap)
                probe = np.asarray(probe)
            code = int(probe[0])
            it = int(probe[1])
            mu_host = float(probe[2])
            dt_chunk = time.time() - t0
            timers["step_total"] += dt_chunk
            if np.isnan(timers["first_chunk"]):
                timers["first_chunk"] = dt_chunk
            if code == DEMOTE_F32:
                # precision handover: same state, f64 step set from here on
                f32_demoted = True
                st = st._replace(status=jnp.asarray(RUNNING, jnp.int32))
                if verbose:
                    print(f"{it:4d}  -- f32 factorization demoted to f64 "
                          f"(mu={float(st.mu):.1e}, rr={float(st.log_rr):.1e},"
                          f" ls={int(st.log_ls)}) --")
                continue
            if code == NEED_RESTORATION:
                if resto_entries < o["resto_max_entries"]:
                    resto_entries += 1
                    if verbose:
                        print(f"{it:4d}  -- feasibility restoration phase "
                              f"(entry {resto_entries}) --")
                    if self._restore_jit is None:
                        def restw(s, c):
                            with self.model.bound_tables(
                                    c.get("fam"), c.get("jac_rows"),
                                    c.get("jac_cols")), \
                                    _kkt_tables(self.kkt, c.get("kkt")):
                                return self._restore(s, c)

                        self._restore_jit = jax.jit(restw)
                    t0 = time.time()
                    st = self._restore_jit(st, consts)
                    timers["step_total"] += time.time() - t0
                    continue
                code = STALLED
                st = st._replace(status=jnp.asarray(STALLED, jnp.int32))
            if verbose:
                print(f"{it:4d} {float(st.log_obj)/float(consts['sf'])* m.sense: .7e} "
                      f"{float(st.log_inf_pr):8.2e} {float(st.log_inf_du):8.2e} "
                      f"{float(st.mu):7.1e} {float(st.log_alpha):6.4f} "
                      f"{float(st.log_alpha_z):6.4f} {int(st.log_ls):3d} "
                      f"{float(st.log_delta_w):7.1e} {float(st.log_rr):7.1e}"
                      f" {float(st.log_E0):7.1e}")
            if code == RUNNING and (o["recalc_y"] or o["recalc_y_stall"]):
                # degenerate-ray dual reset (Ipopt recalc_y role):
                # replace multipliers riding a near-null-space ray with
                # the minimal-norm stationarity fit at the current
                # iterate.  Triggers: |y| past the cap (recalc_y), or
                # the feasible-but-dual-stalled crawl (recalc_y_stall).
                tol_h = float(consts["tol"])
                fire = False
                if o["recalc_y"]:
                    maxy = float(jnp.max(jnp.abs(st.y)))
                    fire = maxy > o["recalc_y_cap"]
                if not fire and o["recalc_y_stall"]:
                    # the terminal crawl CREEPS the objective upward
                    # (measured (100,32): +2.3e-3/chunk relative) while
                    # the productive feasible crawl still DESCENDS at a
                    # similar magnitude -- the separator is the sign of
                    # the change, not its size
                    obj_now = float(st.log_obj)
                    obj_stalled = (prev_chunk_obj is not None
                                   and obj_now >= prev_chunk_obj
                                   - 1e-5 * max(1.0, abs(obj_now)))
                    prev_chunk_obj = obj_now
                    fire = ((obj_stalled or not o["recalc_y_obj_gate"])
                            and float(st.log_inf_pr) <= 1e2 * tol_h
                            and float(st.log_inf_du) > 1e4 * tol_h
                            and float(st.log_alpha) <= 0.25)
                if fire:
                    y_new = self._ensure_lsq_jit()(st, consts)
                    st = st._replace(y=y_new)
                    if verbose:
                        print(f"{it:4d}  -- least-squares dual recalc "
                              f"(du={float(st.log_inf_du):.1e}) --")
            if checkpoint_path and checkpoint_every and \
                    it // checkpoint_every != \
                    (it - chunk) // checkpoint_every:
                self.save_checkpoint(checkpoint_path, st)
            if code != RUNNING:
                status = _STATUS_NAMES[code]
                break
            if time.time() - t_start > o["max_wall_time"]:
                status = "max_time"
                break
        solve_time = time.time() - t_start
        # never hand back a WORSE iterate than the best one seen: an
        # iteration/time-limited or stalled run may end mid-overshoot on a
        # degenerate dual ray (observed pandemic (100,128): final du ~1e+3
        # while iterate 253 held E0=7.9e-4).  If the best iterate passes
        # the near-optimal visit gate, report it as "acceptable"
        # (Ipopt: SOLVED_TO_ACCEPTABLE_LEVEL at the iteration limit).
        if status in ("max_iter", "max_time", "stalled"):
            best_E = float(st.best_E)
            gate = (o["acceptable_visit_tol_factor"]
                    * float(consts["tol"]))
            # restore ONLY when the capped gate passes: below it "best"
            # provably means near-optimal, above it the tracker can
            # prefer a feasible-but-far point whose mega-multipliers make
            # the dual test lenient (measured: pandemic (100,128) holds a
            # pr=6e-5 iterate at objective 67.9 vs ~31.5 near the end)
            if np.isfinite(best_E) and best_E <= gate \
                    and best_E < float(st.log_E0):
                st = st._replace(x=st.best_x, s=st.best_s, y=st.best_y,
                                 zl=st.best_zl, zu=st.best_zu,
                                 log_inf_pr=st.best_inf_pr,
                                 log_inf_du=st.best_inf_du)
                status = "acceptable"
                if verbose:
                    print(f"{it:4d}  -- limit hit: best iterate restored "
                          f"(E={best_E:.1e}) => acceptable --")

        # final dual polish on degenerate-geometry "acceptable" exits:
        # one least-squares recalc of the multipliers at the returned
        # iterate, kept only if the TRUE dual infeasibility improves
        # (measured pandemic (100,32): restored du 3.0e-2 with obj 33.6
        # -> stall-recalc trajectory returns du 1.2e-2 at obj 31.16; the
        # polish makes the minimal-norm certificate unconditional).
        if status == "acceptable" and (o["recalc_y"] or o["recalc_y_stall"]):
            if self._du_jit is None:
                def duw(s, c):
                    with self.model.bound_tables(
                            c.get("fam"), c.get("jac_rows"),
                            c.get("jac_cols")):
                        grad = self._geval(s.x, c)
                        jv = self._jvals(s.x, c)
                        cval = self._ceval(s.x, c)
                        _, _, idu, _, _, _ = self._kkt_error(
                            s, c, grad, jv, cval, s.mu)
                        return idu
                self._du_jit = jax.jit(duw)
            y_pol = self._ensure_lsq_jit()(st, consts)
            st_pol = st._replace(y=y_pol)
            du_pol = float(self._du_jit(st_pol, consts))
            if du_pol < float(st.log_inf_du):
                st = st_pol._replace(
                    log_inf_du=jnp.asarray(du_pol, m.dtype))
                if verbose:
                    print(f"{it:4d}  -- dual polish: du -> "
                          f"{du_pol:.2e} --")

        def to_host(a):
            # multi-host: arrays whose shards span other processes cannot
            # be fetched directly; allgather the global value first
            if getattr(a, "is_fully_addressable", True):
                return np.asarray(a)
            from jax.experimental import multihost_utils

            return np.asarray(
                multihost_utils.process_allgather(a, tiled=True))

        # single-dispatch, single-transfer result extraction: each
        # dispatch and each device->host fetch costs a round trip, and the
        # naive sequence (obj eval + 4 array pulls + 2 scalar floats) adds
        # seven of them to every solve
        n = m.nvar
        if self._extract_jit is None:
            def _extract(stt, c):
                yu = stt.y * c["sc"] / c["sf"] * m.sense
                return jnp.concatenate([
                    stt.x,
                    yu,
                    stt.zl[:n] / c["sf"] * m.sense,
                    stt.zu[:n] / c["sf"] * m.sense,
                    jnp.stack([m.obj(stt.x, c["theta"]),
                               stt.log_inf_pr, stt.log_inf_du,
                               stt.n_factor.astype(m.dtype),
                               stt.n_refine.astype(m.dtype)]),
                ])
            self._extract_jit = jax.jit(_extract)
        packed = to_host(self._extract_jit(st, consts))
        x = packed[:n]
        y_user = packed[n:n + m.ncon]
        zl = packed[n + m.ncon:2 * n + m.ncon]
        zu = packed[2 * n + m.ncon:3 * n + m.ncon]
        fobj = float(packed[-5])
        st = st._replace(log_inf_pr=jnp.asarray(packed[-4]),
                         log_inf_du=jnp.asarray(packed[-3]))
        # work counts of this solve (the state carries them cumulatively)
        timers["factorizations"] = int(packed[-2])
        timers["refine_rounds"] = int(packed[-1])
        res = ExecutionStats(
            status=status,
            objective=fobj,
            solution=x,
            multipliers=y_user,
            multipliers_L=zl,
            multipliers_U=zu,
            iter=it,
            solve_time=solve_time,
            primal_feas=float(st.log_inf_pr),
            dual_feas=float(st.log_inf_du),
            timers=timers,
        )
        self.results = res
        return res


# MadNLP-flavored alias: the GPU-style solver entry point the backend exposes
# (reference ext/InfiniteExaModelsMadNLP.jl); identical algorithm, structured
# KKT by default.
class MadIpmSolver(IpmSolver):
    def __init__(self, model, kkt=None, **options):
        options.setdefault("linear_solver", "auto")
        super().__init__(model, kkt=kkt, **options)
