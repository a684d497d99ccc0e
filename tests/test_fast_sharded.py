"""Fast-lane (non-slow) coverage of the headline distributed paths.

The per-commit lane must exercise a full IPM solve
through BOTH sharded KKT backends (scenario-block and time-band) and the
mixed-precision step set, so regressions there are visible per-commit
rather than only in the nightly slow lane.  Problems are kept tiny so the
8-virtual-device shard_map compiles stay cheap.
"""
import numpy as np
import pytest

from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.models import farmer, quad
from infiniteexamodels_jax.parallel import make_mesh, shard_model
from infiniteexamodels_jax.solvers import IpmSolver
from infiniteexamodels_jax.transcribe import transcribe


def test_scenario_shard_full_solve_tiny():
    """ShardedScenarioKKT end-to-end on farmer-16 (8-device mesh) matches
    the single-device objective."""
    m1 = farmer(num_scenarios=16)
    m1.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, linear_solver="auto"))
    m1.set_silent()
    res1 = m1.optimize()
    assert res1.status == "first_order"

    m2 = farmer(num_scenarios=16)
    m2.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, mesh=make_mesh(8),
                                linear_solver="auto"))
    m2.set_silent()
    res2 = m2.optimize()
    assert res2.status == "first_order"
    assert res2.objective == pytest.approx(res1.objective, rel=1e-8)


def test_band_shard_full_solve_tiny():
    """ShardedBandKKT (distributed BCR over time blocks) end-to-end on a
    small quadrotor matches the single-device objective."""
    from infiniteexamodels_jax.solvers.band_shard import ShardedBandKKT

    m = quad(num_supports=24)
    model, _ = transcribe(m)
    r_ref = IpmSolver(model, print_level=0, linear_solver="auto",
                      tol=1e-8).solve()
    assert r_ref.status == "first_order"

    m2 = quad(num_supports=24)
    model2, _ = transcribe(m2, row_pad=8)
    mesh = make_mesh(8)
    shard_model(model2, mesh)
    kkt = ShardedBandKKT(model2, mesh=mesh)
    assert kkt.aligned
    r = IpmSolver(model2, kkt=kkt, print_level=0, tol=1e-8).solve()
    assert r.status == "first_order"
    assert r.objective == pytest.approx(r_ref.objective, rel=1e-8)
