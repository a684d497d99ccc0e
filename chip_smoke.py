"""Proof that the main path runs on one NVIDIA GPU: transcription, the
interior-point solver and the structured KKT factorization, end to end,
through the entry points a user calls.

    python chip_smoke.py            # one card: phases 0-5
    python chip_smoke.py --four     # four cards: sharded KKT solves vs one card

Phases (one process; any failure prints its traceback and exits 1 before
the last line is printed):

0. device: the first JAX device must be a GPU, never the CPU.
1. factorization primitives at the real quad-1000 / opf-1000 block
   geometry, float64 and float32, against a numpy float64 reference; the
   indefinite-block certificate; the assembled KKT against the CPU backend.
2. quad-1000 (ESCAPE34 OrthogonalCollocation(3)), float64, band KKT: cold
   solve + warm re-solve at tol=1e-8 against a pinned CPU oracle.
3. opf-1000 (stochastic AC-OPF, 1000 scenarios), scenario KKT, likewise.
4. ``factor_dtype="mixed"`` on quad-1000, against the phase-2 oracle.
5. the hot parameter-update pair of the reference's solve tests.

``--four`` runs only the sharded solves (farmer-1000 scenario-sharded,
quad-1000 band-sharded) on a flat 4-device mesh, each against the same
problem on one card.

Every result line is one JSON object that names the card.  The line before
the last is the card's name and power limit as ``nvidia-smi`` reports them;
the last line is ``{"ok": true, "device": {...}}``.  Every phase function
takes its size as an argument so the CPU tests can run it small.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# Pinned objectives, each produced off the device path on the JAX CPU
# backend (jax_platforms="cpu") at tol=1e-9:
#   quad-1000, quad-40, hovercraft-41: the native sparse LDL^T backend
#     (linear_solver="ldl_cpp": exact host factorization, no iterative
#     refinement); quad-1000 took 15 iterations, quad-40 14, hovercraft-41 6;
#   opf-1000: linear_solver="auto" (scenario block-diagonal KKT) on the CPU
#     backend, 20 iterations -- the LDL path needs hundreds of iterations on
#     this model (837 at opf-10), too slow to pin at 1000 scenarios;
#   opf-10: the pinned oracle of tests/test_models.py.
# The parameter pair is the reference's Ipopt oracle
# (tests/test_solve_parity.py).
ORACLES = {
    "quad-1000": 568.8399562866356,
    "opf-1000": 5744.482274480745,
    "quad-40": 573.0254900864335,
    "opf-10": 5744.482274475477,
    "hovercraft-41": 0.04245763849025232,
}
PARAM_PAIR = (306.4999755050365, 276.26497794903645)
# objective vs oracle: |obj - oracle| / max(1, |oracle|) -- relative for
# the ESCAPE34 cases (|oracle| in the hundreds and thousands), the
# reference's absolute 1e-6 parity bar for objectives below one
OBJ_RTOL = 1e-6
FOUR_RTOL = 1e-8         # four cards vs one card, same problem and solver

# Primitive tolerances, max-abs error relative to the largest reference
# entry.  The test matrices have cond(D_k) <= 1e2 and a diagonally
# dominant band, so a backward-stable float64 factor errs by ~1e-14 and
# 1e-10 leaves room for the ceil(log2 nb) explicit-inverse levels of BCR.
# float32 (unit roundoff 6e-8) lands near 1e-6..1e-5; 1e-4 holds only if
# the float32 products are true float32: TF32 (10-bit mantissa, ~5e-4 per
# product), which the card uses for float32 matmuls unless a precision is
# requested, fails it.  The package sets jax_default_matmul_precision to
# "highest", which this bound checks.
PRIM_RTOL = {"float64": 1e-10, "float32": 1e-4}
ASSEMBLE_RTOL = 1e-12    # card vs CPU backend: only the summation order of
                         # the scatter-adds differs (atomics on the card)

CARD = "unknown card"


def card_info():
    """``name, power.limit`` from nvidia-smi (a child that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def report(**fields):
    print(json.dumps({**fields, "card": CARD}), flush=True)


def ok_line(devices):
    """The contract's last line, from the JAX device list."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _check(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:.0e}")


def _timed_ms(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ----------------------------------------------------------------------
# numpy float64 references
# ----------------------------------------------------------------------
def spd_band(nb, bs, seed=0):
    """Block-tridiagonal SPD test system: blocks D_k with eigenvalues in
    [1, 100], couplings E_k (E_k couples block k+1 to block k) scaled to a
    quarter of the smallest eigenvalue, so the band is diagonally
    dominant."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((nb, bs, bs)))
    ev = np.exp(rng.uniform(0.0, np.log(100.0), (nb, bs)))
    D = np.einsum("kij,kj,klj->kil", Q, ev, Q)
    D = 0.5 * (D + np.swapaxes(D, -1, -2))
    E = rng.standard_normal((max(nb - 1, 0), bs, bs))
    E *= 0.25 / np.linalg.norm(E, ord=2, axis=(-2, -1))[:, None, None]
    return D, E


def band_solve_ref(D, E, b):
    """Block Thomas algorithm in float64 (sequential block LU)."""
    nb = D.shape[0]
    S, y = [D[0]], [b[0]]
    for i in range(1, nb):
        G = np.linalg.solve(S[i - 1], E[i - 1].T).T   # E S^{-1}
        S.append(D[i] - G @ E[i - 1].T)
        y.append(b[i] - G @ y[i - 1])
    x = [None] * nb
    x[-1] = np.linalg.solve(S[-1], y[-1])
    for i in range(nb - 2, -1, -1):
        x[i] = np.linalg.solve(S[i], y[i] - E[i].T @ x[i + 1])
    return np.stack(x)


# ----------------------------------------------------------------------
# phase 0
# ----------------------------------------------------------------------
def phase0():
    import jax

    devs = jax.devices()
    d = devs[0]
    report(phase=0, platform=d.platform, device_kind=d.device_kind,
           count=len(devs), jax=jax.__version__,
           jax_enable_x64=bool(jax.config.jax_enable_x64),
           jax_default_matmul_precision=str(
               jax.config.jax_default_matmul_precision))
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: the first JAX device is {d.platform!r}; this script "
            "never carries on without the card")
    return devs


# ----------------------------------------------------------------------
# phase 1: factorization primitives + assembly
# ----------------------------------------------------------------------
def phase1(quad_n=1000, opf_n=1000, seed=0, reps=5):
    import jax
    import jax.numpy as jnp
    from infiniteexamodels_jax import models as M
    from infiniteexamodels_jax.transcribe import transcribe
    from infiniteexamodels_jax.solvers.block_tridiag import (
        BlockTridiagKKT, _chol_linv, _lsolve, _bcr_factor, _bcr_solve,
        _apply_inv)

    qsimd, _ = transcribe(M.quad(num_supports=quad_n))
    qkkt = BlockTridiagKKT(qsimd)
    osimd, _ = transcribe(M.opf(num_supports=opf_n))
    okkt = BlockTridiagKKT(osimd)
    assert qkkt.usable and qkkt.mode == "band", "quad KKT is not band"
    assert okkt.usable and okkt.block_diag, "opf KKT is not block-diagonal"
    nb, bs = qkkt.nb, qkkt.bs
    snb, sbs, smB = okkt.nb, okkt.bs, okkt.mB
    report(phase=1, geometry={"quad": {"nb": nb, "bs": bs},
                              "opf": {"nb": snb, "bs": sbs, "mB": smB}})

    D, E = spd_band(nb, bs, seed)
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal((nb, bs))
    X = rng.standard_normal((nb, bs, bs))
    L_ref = np.linalg.cholesky(D)
    Linv_ref = np.linalg.inv(L_ref)
    W_ref = np.linalg.solve(L_ref, X)
    x_ref = band_solve_ref(D, E, b)
    Dbad = D.copy()
    Dbad[nb // 2] = -np.eye(bs)
    Ds, _ = spd_band(snb, sbs, seed + 2)
    Bs = rng.standard_normal((snb, sbs, max(smB, 1)))
    Z_ref = np.linalg.solve(Ds, Bs)

    chol = jax.jit(_chol_linv)
    lsolve = jax.jit(_lsolve)
    bfac = jax.jit(_bcr_factor)
    bsol = jax.jit(_bcr_solve)
    bdiag = jax.jit(lambda d_, b_: _apply_inv(_chol_linv(d_)[1], b_))
    for dt in (jnp.float64, jnp.float32):
        name = jnp.dtype(dt).name
        tol = PRIM_RTOL[name]
        Dj, Ej, bj, Xj = (jnp.asarray(a, dt) for a in (D, E, b, X))
        L, Linv, ok = chol(Dj)
        assert bool(ok), f"_chol_linv {name}: SPD batch reported not ok"
        errs = {"chol_L": _rel(L, L_ref), "chol_Linv": _rel(Linv, Linv_ref),
                "lsolve": _rel(lsolve(L, Xj), W_ref)}
        levels, root, okb = bfac(Dj, Ej)
        assert bool(okb), f"_bcr_factor {name}: SPD band reported not ok"
        errs["bcr_solve"] = _rel(bsol(levels, root, bj), x_ref)
        errs["block_diag_solve"] = _rel(
            bdiag(jnp.asarray(Ds, dt), jnp.asarray(Bs, dt)), Z_ref)
        for k, v in errs.items():
            _check(f"{k} {name}", v, tol)
        # the inertia-correction ladder reads a failed factorization from
        # non-finite output: one indefinite block must flip ok
        bad_chol = bool(chol(jnp.asarray(Dbad, dt))[2])
        bad_bcr = bool(bfac(jnp.asarray(Dbad, dt), Ej)[2])
        assert not bad_chol and not bad_bcr, \
            f"{name}: indefinite block not detected"
        ms = {"chol_linv": _timed_ms(chol, Dj, reps=reps),
              "bcr_factor": _timed_ms(bfac, Dj, Ej, reps=reps),
              "bcr_solve": _timed_ms(bsol, levels, root, bj, reps=reps)}
        report(phase=1, dtype=name, rel_err=errs, tol=tol,
               indefinite_detected=True, ms=ms)

    # assembled K on the card vs the same call on the CPU backend
    cpu = jax.devices("cpu")[0]
    x = qsimd.x0 + 0.01
    lam = jnp.linspace(0.5, 1.5, qsimd.ncon)
    d = jnp.full(qsimd.ncon, 0.7)
    de = jnp.full(qsimd.nvar, 0.3)
    asm = jax.jit(lambda x_, l_, d_, e_: qkkt.assemble(
        x_, qsimd.theta, l_, 1.0, d_, e_))
    K_dev = asm(x, lam, d, de)
    with jax.default_device(cpu):
        args = [jax.device_put(a, cpu) for a in (x, lam, d, de)]
        K_cpu = jax.jit(lambda x_, l_, d_, e_: qkkt.assemble(
            x_, jax.device_put(qsimd.theta, cpu), l_, 1.0, d_, e_))(*args)
    asm_err = max(_rel(a, c) for a, c in zip(K_dev, K_cpu) if c.size)
    _check("assemble vs CPU backend", asm_err, ASSEMBLE_RTOL)
    report(phase=1, assemble_rel_err_vs_cpu=asm_err, tol=ASSEMBLE_RTOL,
           assemble_ms=_timed_ms(asm, x, lam, d, de, reps=reps))
    report(phase=1, passed=True)


# ----------------------------------------------------------------------
# phases 2-4: a model through optimize(), cold + warm
# ----------------------------------------------------------------------
def solve_phase(phase, case, build, oracle, **options):
    """Build ``case`` with ``build()``, solve it cold and warm through
    ``InfiniteModel.optimize()`` at tol=1e-8, check both against
    ``oracle``; returns the warm result."""
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend
    from infiniteexamodels_jax.solvers import IpmSolver

    t0 = time.time()
    m = build()
    backend = ExaTranscriptionBackend(
        IpmSolver, linear_solver="auto", print_level=0, tol=1e-8, **options)
    m.set_transformation_backend(backend)
    backend.build(m)
    build_s = time.time() - t0
    t0 = time.time()
    cold = m.optimize()
    cold_s = time.time() - t0
    t0 = time.time()
    warm = m.optimize()
    warm_s = time.time() - t0
    errs = [abs(r.objective - oracle) / max(1.0, abs(oracle))
            for r in (cold, warm)]
    report(phase=phase, case=case, options=options,
           kkt=type(backend.solver.kkt).__name__,
           nvar=backend.model.nvar, ncon=backend.model.ncon,
           status=[cold.status, warm.status],
           objective=[cold.objective, warm.objective], oracle=oracle,
           rel_err=errs, iters_cold=cold.iter, iters_warm=warm.iter,
           iters_differ=cold.iter != warm.iter,
           factorizations=[r.timers["factorizations"] for r in (cold, warm)],
           refine_rounds=[r.timers["refine_rounds"] for r in (cold, warm)],
           build_s=build_s, cold_s=cold_s, warm_s=warm_s,
           compile_s=cold_s - warm_s,
           warm_it_per_s=warm.iter / warm_s)
    for r, e in zip((cold, warm), errs):
        assert r.status == "first_order", f"{case}: status {r.status}"
        assert e <= OBJ_RTOL, f"{case}: objective off by {e:.2e} relative"
    return warm


def phase2(n=1000, oracle=None):
    from infiniteexamodels_jax import models as M

    return solve_phase(2, f"quad-{n}", lambda: M.quad(num_supports=n),
                       oracle or ORACLES[f"quad-{n}"])


def phase3(n=1000, oracle=None):
    from infiniteexamodels_jax import models as M

    return solve_phase(3, f"opf-{n}", lambda: M.opf(num_supports=n),
                       oracle or ORACLES[f"opf-{n}"])


def phase4(n=1000, oracle=None):
    from infiniteexamodels_jax import models as M

    return solve_phase(4, f"quad-{n}", lambda: M.quad(num_supports=n),
                       oracle or ORACLES[f"quad-{n}"], factor_dtype="mixed")


def phase5():
    """Hot parameter update + re-solve (reference test/solve.jl:134-162)."""
    from infiniteexamodels_jax.modeling import InfiniteModel, integral
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend
    from infiniteexamodels_jax.solvers import IpmSolver

    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    p1 = m.finite_parameter("p1", 100.0)
    p2 = m.finite_parameter("p2", 1.0)
    x = [m.variable(f"x{i}", deps=(t,)) for i in range(2)]
    m.minimize(p1 * integral((x[1] - x[0]**2)**2, t)
               + integral((p2 - x[0])**2, t))
    for i, ub in enumerate([0.5, 3.0]):
        m.constraint(x[i] <= ub)
    m.constraint(x[0] * x[1] >= 1.0)
    m.constraint(x[0] + x[1]**2 >= 0.0)
    m.set_silent()
    t0 = time.time()
    r1 = m.optimize()
    obj1, s1 = m.objective_value(), time.time() - t0
    m.set_parameter_value(p1, 90.0)
    m.set_parameter_value(p2, 1.3)
    assert m.transformation_backend_ready(), "parameter update rebuilt"
    t0 = time.time()
    r2 = m.optimize()
    obj2, s2 = m.objective_value(), time.time() - t0
    report(phase=5, objective=[obj1, obj2], oracle=list(PARAM_PAIR),
           status=[r1.status, r2.status], iters=[r1.iter, r2.iter],
           first_s=s1, update_s=s2)
    for got, want in zip((obj1, obj2), PARAM_PAIR):
        assert abs(got - want) <= 1e-6, f"parameter pair: {got} vs {want}"


# ----------------------------------------------------------------------
# --four: the sharded structured KKT over a flat 4-device mesh
# ----------------------------------------------------------------------
def phase_four(farmer_n=1000, quad_n=1000, ndev=4):
    import jax
    from infiniteexamodels_jax import models as M
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend
    from infiniteexamodels_jax.solvers import IpmSolver
    from infiniteexamodels_jax.parallel import make_mesh

    if len(jax.devices()) < ndev:
        raise RuntimeError(f"--four needs {ndev} devices, "
                           f"found {len(jax.devices())}")
    mesh = make_mesh(ndev)
    # the stochastic OPF's scenario KKT has one block more than it has
    # scenarios (1001 at opf-1000), so it cannot split evenly over four
    # cards; the farmer two-stage LP (__graft_entry__.dryrun_multichip)
    # carries the scenario-sharded path instead
    cases = [("farmer", farmer_n,
              lambda: M.farmer(num_scenarios=farmer_n),
              "ShardedScenarioKKT"),
             ("quad", quad_n, lambda: M.quad(num_supports=quad_n),
              "ShardedBandKKT")]
    for kind, n, build, want in cases:
        res = {}
        for label, mesh_ in (("one_card", None), ("mesh", mesh)):
            m = build()
            backend = ExaTranscriptionBackend(
                IpmSolver, mesh=mesh_, linear_solver="auto", print_level=0,
                tol=1e-8)
            m.set_transformation_backend(backend)
            backend.build(m)
            t0 = time.time()
            r = m.optimize()
            cold_s = time.time() - t0
            t0 = time.time()
            r2 = m.optimize()
            warm_s = time.time() - t0
            kkt = backend.solver.kkt
            res[label] = dict(status=r2.status, objective=r2.objective,
                              iters_cold=r.iter, iters_warm=r2.iter,
                              cold_s=cold_s, warm_s=warm_s,
                              kkt=type(kkt).__name__,
                              aligned=bool(getattr(kkt, "aligned", False)))
        rel = abs(res["mesh"]["objective"] - res["one_card"]["objective"]) \
            / abs(res["one_card"]["objective"])
        report(phase="four", case=f"{kind}-{n}", devices=ndev,
               rel_err=rel, tol=FOUR_RTOL, **res)
        assert res["mesh"]["kkt"] == want and res["mesh"]["aligned"], \
            f"{kind}-{n}: {want} did not engage on the mesh"
        for v in res.values():
            assert v["status"] == "first_order", f"{kind}-{n}: {v}"
        assert rel <= FOUR_RTOL, f"{kind}-{n}: four cards off by {rel:.2e}"


# ----------------------------------------------------------------------
def main(argv=None):
    global CARD
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    try:
        import jax
        import infiniteexamodels_jax  # noqa: F401  (x64, precision)
        from infiniteexamodels_jax.utils.compile_cache import (
            use_compile_cache)

        use_compile_cache()
        CARD = card_info()
        devices = phase0()
        t_all = time.time()
        if four:
            phase_four()
        else:
            for fn in (phase1, phase2, phase3, phase4, phase5):
                t0 = time.time()
                fn()
                report(phase=fn.__name__, seconds=time.time() - t0)
        report(phases="all passed", seconds=time.time() - t_all,
               peak_bytes_in_use=(devices[0].memory_stats() or {}).get(
                   "peak_bytes_in_use"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    print(CARD, flush=True)
    print(ok_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
