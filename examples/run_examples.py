"""Run every example model family end-to-end at moderate sizes
(the reference's examples/runexamples.jl).

Runs on the host CPU by default: these are correctness demos.  Pass
``--device`` to run on JAX's default device (the GPU where there is one).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--device" not in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from infiniteexamodels_jax.backend import ExaTranscriptionBackend
from infiniteexamodels_jax.solvers import IpmSolver
from infiniteexamodels_jax import models as M

CASES = [
    ("hovercraft", lambda: M.hovercraft(num_supports=101)),
    ("quadrotor", lambda: M.quad(num_supports=50)),
    ("kinetics", lambda: M.kinetic_control(num_supports=50)),
    ("pandemic", lambda: M.pandemic(num_supports=51, num_scenarios=4)),
    ("farmer", lambda: M.farmer(num_scenarios=1000)),
    ("3node_design", lambda: M.design_3node(num_scenarios=1000)),
    ("opf", lambda: M.opf(num_supports=100)),
]


def main():
    for name, build in CASES:
        t0 = time.time()
        m = build()
        m.set_transformation_backend(ExaTranscriptionBackend(
            IpmSolver, linear_solver="auto", print_level=0, tol=1e-6,
            max_iter=600))
        res = m.optimize()
        print(f"{name:14s} {res.status:12s} iters={res.iter:4d} "
              f"obj={m.objective_value(): .6e} "
              f"pf={res.primal_feas:.1e} [{time.time()-t0:.1f}s]")


if __name__ == "__main__":
    main()
