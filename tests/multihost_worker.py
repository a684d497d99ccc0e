"""Worker script for the 2-process multi-host CPU test.

Each process contributes 4 virtual CPU devices to an 8-device global mesh;
the farmer model is built with the mesh-aware backend (rows padded+sharded,
scenario KKT blocks mesh-distributed) and solved.  Process 0 prints the
objective for the parent test to check.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from infiniteexamodels_jax.parallel import distributed  # noqa: E402

distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=nproc, process_id=pid)
assert jax.device_count() == 4 * nproc, jax.device_count()

from infiniteexamodels_jax.models import farmer  # noqa: E402
from infiniteexamodels_jax.backend import ExaTranscriptionBackend  # noqa: E402
from infiniteexamodels_jax.solvers import IpmSolver  # noqa: E402

mesh = distributed.global_mesh()
m = farmer(num_scenarios=64)
backend = ExaTranscriptionBackend(IpmSolver, mesh=mesh,
                                  linear_solver="auto", print_level=0,
                                  tol=1e-8)
m.set_transformation_backend(backend)
res = m.optimize()
if jax.process_index() == 0:
    print(f"MULTIHOST_RESULT {res.status} {res.objective!r}", flush=True)
