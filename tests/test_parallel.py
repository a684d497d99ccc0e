"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.solvers import IpmSolver
from infiniteexamodels_jax.parallel import (
    make_mesh, shard_model, sharded_fraction)
from infiniteexamodels_jax.models import pandemic, farmer
from infiniteexamodels_jax.transcribe import transcribe


def test_sharded_evals_match_replicated():
    m = farmer(num_scenarios=80)
    simd, _ = transcribe(m)
    x = simd.x0 + 0.1
    ref_obj = float(simd.obj(x, simd.theta))
    ref_grad = np.asarray(simd.grad(x, simd.theta))
    ref_cons = np.asarray(simd.cons(x, simd.theta))

    mesh = make_mesh(8)
    shard_model(simd, mesh)
    assert sharded_fraction(simd, mesh) > 0.5
    obj_j = jax.jit(simd.obj)
    assert float(obj_j(x, simd.theta)) == pytest.approx(ref_obj, rel=1e-12)
    np.testing.assert_allclose(np.asarray(jax.jit(simd.grad)(x, simd.theta)),
                               ref_grad, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(jax.jit(simd.cons)(x, simd.theta)),
                               ref_cons, rtol=1e-10)


@pytest.mark.slow
def test_sharded_ipm_steps_match():
    """IPM iterations over a sharded model match the single-device
    trajectory bit-for-bit-ish (scenario-parallel data distribution).
    A handful of steps keeps the 8-virtual-device CPU run fast; the full
    sharded solve is exercised by __graft_entry__.dryrun_multichip and the
    bench harness."""
    def build():
        m = farmer(num_scenarios=40)
        m.set_transformation_backend(ExaTranscriptionBackend(IpmSolver))
        m.set_silent()
        m.backend.build(m)
        return m

    def run_steps(m, nsteps=4):
        model = m.backend.model
        s = IpmSolver(model, print_level=0)
        consts = s._make_consts(model.theta)
        st = s._init_jit(model.x0, model.y0, consts)
        for _ in range(nsteps):
            st = s._step_jit(st, consts)
        return st

    st1 = run_steps(build())
    m2 = build()
    shard_model(m2.backend.model, make_mesh(8))
    st2 = run_steps(m2)
    np.testing.assert_allclose(np.asarray(st2.x), np.asarray(st1.x),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st2.y), np.asarray(st1.y),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.slow
def test_pad_and_shard_full_fraction():
    """Row padding removes the n % n_devices == 0 restriction: families
    with awkward row counts (hovercraft's 101 supports) still shard 100%,
    and evaluations match the unpadded model exactly."""
    from infiniteexamodels_jax.models import hovercraft

    m = hovercraft(num_supports=101)
    ref, _ = transcribe(m)
    x = ref.x0 + 0.05
    ref_obj = float(ref.obj(x, ref.theta))
    ref_grad = np.asarray(ref.grad(x, ref.theta))
    ref_cons = np.asarray(ref.cons(x, ref.theta))
    ref_jac = np.asarray(ref.jac_vals(x, ref.theta))

    m2 = hovercraft(num_supports=101)
    simd, _ = transcribe(m2, row_pad=8)
    mesh = make_mesh(8)
    shard_model(simd, mesh)
    assert sharded_fraction(simd, mesh) == pytest.approx(1.0)
    assert float(jax.jit(simd.obj)(x, simd.theta)) == \
        pytest.approx(ref_obj, rel=1e-12)
    np.testing.assert_allclose(np.asarray(jax.jit(simd.grad)(x, simd.theta)),
                               ref_grad, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jax.jit(simd.cons)(x, simd.theta)),
                               ref_cons, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(jax.jit(simd.jac_vals)(x, simd.theta)),
        ref_jac, rtol=1e-10, atol=1e-12)
    lam = jnp.asarray(np.linspace(0.1, 1.0, simd.ncon))
    d = jnp.full(simd.ncon, 2.0)
    np.testing.assert_allclose(
        np.asarray(simd.kkt_vals(x, simd.theta, lam, 1.0, d)),
        np.asarray(ref.kkt_vals(x, ref.theta, lam, 1.0, d)),
        rtol=1e-10, atol=1e-12)


@pytest.mark.slow
def test_mesh_distributed_factorization_solve():
    """End-to-end: backend built with a mesh pads+shards the model, the
    block-diagonal scenario factorization carries mesh sharding
    constraints (kkt._mesh_ok), and the solve matches the single-device
    trajectory."""
    m1 = farmer(num_scenarios=64)
    m1.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, linear_solver="auto"))
    m1.set_silent()
    res1 = m1.optimize()
    assert res1.status == "first_order"

    mesh = make_mesh(8)
    m2 = farmer(num_scenarios=64)
    m2.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, mesh=mesh,
                                linear_solver="auto"))
    m2.set_silent()
    res2 = m2.optimize()
    assert res2.status == "first_order"
    kkt = m2.backend.solver.kkt
    from infiniteexamodels_jax.solvers.scenario_shard import (
        ShardedScenarioKKT)
    assert isinstance(kkt, ShardedScenarioKKT) and kkt.block_diag
    assert kkt.aligned, "shard_map-aligned factorization did not engage"
    assert res2.objective == pytest.approx(res1.objective, abs=1e-7)
    np.testing.assert_allclose(res2.solution, res1.solution, atol=1e-6)


def test_aligned_kkt_matches_replicated():
    """The shard_map-aligned scenario KKT (local assembly + local factor +
    psum'd Schur corner) reproduces the replicated backend's assemble/
    factor/solve/matvec exactly."""
    from infiniteexamodels_jax.solvers.block_tridiag import (
        BlockTridiagKKT)
    from infiniteexamodels_jax.solvers.scenario_shard import (
        ShardedScenarioKKT)

    m = pandemic(num_supports=10, num_scenarios=16)
    model, _ = transcribe(m, row_pad=8)
    mesh = make_mesh(8)
    shard_model(model, mesh)
    ref = BlockTridiagKKT(model, mesh=None)
    al = ShardedScenarioKKT(model, mesh=mesh)
    assert al.aligned and al.block_diag

    rng = np.random.default_rng(3)
    n, mm = model.nvar, model.ncon
    x = jnp.asarray(model.x0)
    lam = jnp.zeros(mm)
    d = jnp.asarray(np.abs(rng.standard_normal(mm)) * 0.1)
    de = jnp.asarray(np.abs(rng.standard_normal(n)) + 5.0)
    rhs = jnp.asarray(rng.standard_normal(n))
    th = model.theta

    K0 = jax.jit(lambda: ref.assemble(x, th, lam, 1.0, d, de))()
    f0, ok0 = jax.jit(ref.factor)(K0)
    K1 = jax.jit(lambda: al.assemble(x, th, lam, 1.0, d, de))()
    f1, ok1 = jax.jit(al.factor)(K1)
    assert bool(ok0) and bool(ok1)
    np.testing.assert_allclose(
        np.asarray(jax.jit(al.matvec)(K1, rhs)),
        np.asarray(jax.jit(ref.matvec)(K0, rhs)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(jax.jit(al.solve)(f1, rhs)),
        np.asarray(jax.jit(ref.solve)(f0, rhs)), rtol=1e-9, atol=1e-11)


def test_aligned_kkt_communication_is_border_only():
    """Hardware-independent scaling evidence for the SHARDED-ITERATE path:
    the compiled aligned assemble + factor +
    T-layout solve/matvec/refinement-round step contains NO all-gather/
    all-to-all and every all-reduce is O(border) sized -- the arrowhead's
    Schur-corner psum, the border rhs psum, and scalar norm reductions.
    ZERO O(n) collectives: the solution stays sharded by scenario block.
    An O(nnz) collective appearing here would mean assembly communicates
    again."""
    import re
    from infiniteexamodels_jax.solvers.scenario_shard import (
        ShardedScenarioKKT)

    m = pandemic(num_supports=10, num_scenarios=16)
    model, _ = transcribe(m, row_pad=8)
    mesh = make_mesh(8)
    shard_model(model, mesh)
    kkt = ShardedScenarioKKT(model, mesh=mesh)
    assert kkt.aligned and kkt.tlayout

    n, mm = model.nvar, model.ncon
    lam = jnp.zeros(mm)
    d = jnp.ones(mm)
    de = jnp.ones(n)
    rhs = jnp.ones(n)

    def step_tl(x, th):
        # one full solve + one refinement round, all in T-layout
        K = kkt.assemble(x, th, lam, 1.0, d, de)
        fac, _ = kkt.factor(K)
        r = kkt.tl_gather(rhs)
        dx = kkt.solve_tl(fac, r)
        resid = kkt.tl_sub(r, kkt.matvec_tl(K, dx))
        dx = kkt.tl_add(dx, kkt.solve_tl(fac, resid))
        return dx, kkt.tl_norm(resid)

    hlo = jax.jit(step_tl).lower(model.x0, model.theta).compile().as_text()
    assert not re.search(r"(all-gather|all-to-all)\(", hlo)
    # every all-reduce shape must be <= O(mB^2) elements -- strictly less
    # than n: the iterate never re-replicates inside the solve
    cap = kkt.mB * kkt.mB + kkt.mB + 64
    assert cap < n
    for ln in hlo.splitlines():
        if "all-reduce(" not in ln:
            continue
        for s in re.findall(r"f(?:32|64)\[([\d,]*)\]", ln.split("(")[0]):
            dims = [int(x) for x in s.split(",") if x] or [1]
            el = int(np.prod(dims))
            assert el <= cap, f"oversized collective ({el} elems): {ln[:120]}"

    # the replicated-vector wrapper pays exactly ONE O(nTpad) all-gather
    # (the tl_scatter hand-back) and nothing larger
    hlo_w = jax.jit(
        lambda x, th: kkt.solve(kkt.factor(
            kkt.assemble(x, th, lam, 1.0, d, de))[0], rhs)
    ).lower(model.x0, model.theta).compile().as_text()
    n_ag = len(re.findall(r"all-gather\(", hlo_w))
    assert n_ag <= 1


def test_band_shard_communication_is_halo_sized():
    """Scaling evidence for the band-segment backend: the compiled
    assemble+factor+solve step's collectives are halo/tail-sized --
    permutes are O(bs^2), all-gathers are the O(nd*bs^2) BCR tail, and no
    all-reduce exceeds the O(n) solution replication.  An O(nnz)
    collective appearing here would mean assembly communicates again."""
    import re
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.solvers.band_shard import ShardedBandKKT

    m = quad(num_supports=50)
    model, _ = transcribe(m, row_pad=8)
    mesh = make_mesh(8)
    shard_model(model, mesh)
    kkt = ShardedBandKKT(model, mesh=mesh)
    assert kkt.aligned

    n, mm = model.nvar, model.ncon
    lam = jnp.zeros(mm)
    d = jnp.ones(mm)
    de = jnp.ones(n)
    rhs = jnp.ones(n)

    def step_tl(x, th):
        # one full T-layout solve + one refinement round: the iterate
        # never re-replicates
        K = kkt.assemble(x, th, lam, 1.0, d, de)
        fac, _ = kkt.factor(K)
        r = kkt.tl_gather(rhs)
        dx = kkt.solve_tl(fac, r)
        resid = kkt.tl_sub(r, kkt.matvec_tl(K, dx))
        dx = kkt.tl_add(dx, kkt.solve_tl(fac, resid))
        return dx, kkt.tl_norm(resid)

    hlo = jax.jit(step_tl).lower(model.x0, model.theta).compile().as_text()
    bs, nd = kkt.bs, kkt.nd
    # per-collective element caps: permute = halo (D+E+B blocks), gather =
    # BCR tail, reduce = border corner (NOT n: no solution replication)
    caps = {"collective-permute": 3 * bs * bs + bs * max(kkt.mB, 1) + 64,
            "all-gather": nd * bs * bs + 64,
            "all-reduce": kkt.mB * kkt.mB + kkt.mB + 64}
    assert caps["all-reduce"] < n
    assert not re.search(r"all-to-all\(", hlo)
    for ln in hlo.splitlines():
        for op, cap in caps.items():
            if f"{op}(" not in ln:
                continue
            for s in re.findall(r"f(?:32|64)\[([\d,]*)\]",
                                ln.split("(")[0]):
                dims = [int(x) for x in s.split(",") if x] or [1]
                el = int(np.prod(dims))
                assert el <= cap, \
                    f"oversized {op} ({el} elems): {ln[:120]}"


def test_tlayout_roundtrip_and_norm():
    """T-layout conversion invariants on both aligned backends:
    tl_scatter(tl_gather(v)) == v exactly (the layouts partition the
    variables), and tl_norm matches the replicated 2-norm (padding slots
    stay identically zero)."""
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.solvers.scenario_shard import (
        ShardedScenarioKKT)
    from infiniteexamodels_jax.solvers.band_shard import ShardedBandKKT

    mesh = make_mesh(8)
    rng = np.random.default_rng(11)

    def check(kkt, n):
        v = jnp.asarray(rng.standard_normal(n))
        rt = jax.jit(lambda u: kkt.tl_scatter(kkt.tl_gather(u)))(v)
        np.testing.assert_array_equal(np.asarray(rt), np.asarray(v))
        nrm = float(jax.jit(lambda u: kkt.tl_norm(kkt.tl_gather(u)))(v))
        assert nrm == pytest.approx(float(jnp.linalg.norm(v)), rel=1e-12)

    m = pandemic(num_supports=10, num_scenarios=16)
    model, _ = transcribe(m, row_pad=8)
    shard_model(model, mesh)
    sc = ShardedScenarioKKT(model, mesh=mesh)
    assert sc.aligned and sc.tlayout
    check(sc, model.nvar)

    m2 = quad(num_supports=50)
    model2, _ = transcribe(m2, row_pad=8)
    shard_model(model2, mesh)
    bd = ShardedBandKKT(model2, mesh=mesh)
    assert bd.aligned and bd.tlayout
    check(bd, model2.nvar)


def test_band_shard_kkt_matches_replicated():
    """The time-segment band KKT (ShardedBandKKT: distributed BCR with
    per-level halo ppermutes + all-gathered cross-device tail + halo'd
    assembly) reproduces the single-device band backend's assemble/factor/
    solve/matvec (time-block partitioning so quadrotor-class OCPs use
    multiple devices)."""
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.solvers.block_tridiag import (
        BlockTridiagKKT)
    from infiniteexamodels_jax.solvers.band_shard import ShardedBandKKT

    m = quad(num_supports=50)
    model, _ = transcribe(m, row_pad=8)
    mesh = make_mesh(8)
    shard_model(model, mesh)
    al = ShardedBandKKT(model, mesh=mesh)
    assert al.usable and al.aligned and al.mode == "band"
    # reference on the SAME padded block grid
    ref = BlockTridiagKKT(model, mesh=None, nb_round=lambda _: al.nb)
    assert ref.nb == al.nb and ref.bs == al.bs

    rng = np.random.default_rng(7)
    n, mm = model.nvar, model.ncon
    x = jnp.asarray(model.x0) + 0.01
    lam = jnp.asarray(rng.standard_normal(mm) * 0.1)
    d = jnp.asarray(np.abs(rng.standard_normal(mm)) * 0.1)
    de = jnp.asarray(np.abs(rng.standard_normal(n)) + 5.0)
    rhs = jnp.asarray(rng.standard_normal(n))
    th = model.theta

    K0 = jax.jit(lambda: ref.assemble(x, th, lam, 1.0, d, de))()
    f0, ok0 = jax.jit(ref.factor)(K0)
    K1 = jax.jit(lambda: al.assemble(x, th, lam, 1.0, d, de))()
    f1, ok1 = jax.jit(al.factor)(K1)
    assert bool(ok0) and bool(ok1)
    np.testing.assert_allclose(
        np.asarray(jax.jit(al.matvec)(K1, rhs)),
        np.asarray(jax.jit(ref.matvec)(K0, rhs)), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(jax.jit(al.solve)(f1, rhs)),
        np.asarray(jax.jit(ref.solve)(f0, rhs)), rtol=1e-8, atol=1e-9)


@pytest.mark.slow
def test_band_shard_ipm_solve_matches():
    """Full IPM solve through the band-segment KKT on the 8-device mesh
    matches the single-device objective (quadrotor, tol 1e-8)."""
    from infiniteexamodels_jax.models import quad
    from infiniteexamodels_jax.solvers.ipm import IpmSolver as S
    from infiniteexamodels_jax.solvers.band_shard import ShardedBandKKT

    m = quad(num_supports=50)
    model, _ = transcribe(m)
    r_ref = S(model, print_level=0, linear_solver="auto", tol=1e-8).solve()
    assert r_ref.status == "first_order"

    m2 = quad(num_supports=50)
    model2, _ = transcribe(m2, row_pad=8)
    mesh = make_mesh(8)
    shard_model(model2, mesh)
    kkt = ShardedBandKKT(model2, mesh=mesh)
    assert kkt.aligned
    r = S(model2, kkt=kkt, print_level=0, tol=1e-8).solve()
    assert r.status == "first_order"
    assert r.objective == pytest.approx(r_ref.objective, rel=1e-9)
