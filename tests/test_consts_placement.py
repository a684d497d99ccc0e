"""Placement of the solver's problem constants (IpmSolver._compute_consts).

On a single-process mesh the constants must be replicated over the model's
mesh, next to the row-sharded family tables; committing them to one device
makes the step's jit reject the mix of device sets on a real multi-GPU
mesh."""
import jax
import numpy as np
from jax.sharding import NamedSharding

from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.models import farmer
from infiniteexamodels_jax.parallel import make_mesh
from infiniteexamodels_jax.solvers import IpmSolver


def _solver(mesh):
    m = farmer(num_scenarios=16)
    backend = ExaTranscriptionBackend(IpmSolver, mesh=mesh,
                                      linear_solver="auto", print_level=0)
    m.set_transformation_backend(backend)
    backend.build(m)
    model = backend.model
    return IpmSolver(model, print_level=0, linear_solver="auto"), model


def _consts(mesh):
    solver, model = _solver(mesh)
    return solver._compute_consts(model.theta, model)


def test_consts_replicated_on_mesh():
    mesh = make_mesh(8)
    consts = _consts(mesh)
    assert consts
    for k, v in consts.items():
        assert isinstance(v.sharding, NamedSharding), k
        assert v.sharding.mesh == mesh, k
        assert v.sharding.is_fully_replicated, k
        assert v.sharding.device_set == set(mesh.devices.flat), k


def test_consts_on_default_device_without_mesh():
    consts = _consts(None)
    for k, v in consts.items():
        assert v.sharding.device_set == {jax.devices()[0]}, k


def test_host_traced_consts_replicated_on_mesh(monkeypatch):
    """The multi-process path traces the constants on the host CPU backend
    against the numpy twins; they must still land replicated on the whole
    mesh and agree with the single-process values."""
    mesh = make_mesh(8)
    solver, model = _solver(mesh)
    ref = solver._compute_consts(model.theta, model)
    solver._consts_cache = None
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    consts = solver._compute_consts(model.theta, model)
    assert consts.keys() == ref.keys()
    for k, v in consts.items():
        assert v.sharding.is_fully_replicated, k
        assert v.sharding.device_set == set(mesh.devices.flat), k
        np.testing.assert_array_equal(np.asarray(v), np.asarray(ref[k]))
