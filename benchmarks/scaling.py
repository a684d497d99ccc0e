"""Scenario-parallel scaling of the mesh-distributed KKT factorization.

Compares three pipelines on an N-device mesh for a scenario-structured
(block-diagonal + arrowhead) problem:

- ``replicated``: single-device semantics (the mesh is ignored),
- ``gspmd``: sharding *constraints* on the block axis
  (:class:`BlockTridiagKKT`) -- XLA shards the factorization but silently
  REPLICATES the per-row assembly compute on every device,
- ``aligned``: the :class:`ShardedScenarioKKT` shard_map pipeline -- every
  device evaluates only the rows of its own scenario blocks and factors
  only its own blocks; communication is exactly the arrowhead's psums
  (Schur corner mB x mB, border rhs mB, solution vector n).

Two kinds of evidence are printed:

1. An HLO collective audit of the jitted assemble+factor+solve step —
   hardware-independent: lists every collective op and its shape.  The
   aligned pipeline must show only the O(border + n) all-reduces; any
   all-gather/all-to-all of COO-stream-sized buffers would mean assembly
   communicates.
2. Wall-clock per phase.  CAVEAT: on a virtual CPU mesh
   (``--xla_force_host_platform_device_count``) all "devices" share the
   host's cores, and XLA:CPU already parallelizes the *replicated* batched
   factorization across those cores — so sharded-vs-replicated wall time on
   CPU under-reports the gain real chips would see (each real chip adds
   compute; a virtual device does not).  The assembly column is still
   meaningful: aligned assembly does 1/N of the per-device work.

Usage:
    python benchmarks/scaling.py [n_devices] [n_scenarios] [--cpu]
"""
import os
import re
import sys
import time

_pos = [a for a in sys.argv[1:] if not a.startswith("-")]
N_DEV = int(_pos[0]) if len(_pos) > 0 else 4
N_SCEN = int(_pos[1]) if len(_pos) > 1 else 512

if "--cpu" in sys.argv:
    os.environ.setdefault(
        "XLA_FLAGS",
        f"--xla_force_host_platform_device_count={N_DEV}")

import jax  # noqa: E402

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from infiniteexamodels_jax.models import pandemic  # noqa: E402
from infiniteexamodels_jax.transcribe import transcribe  # noqa: E402
from infiniteexamodels_jax.parallel import (  # noqa: E402
    make_mesh, shard_model, sharded_fraction)
from infiniteexamodels_jax.solvers.block_tridiag import (  # noqa: E402
    BlockTridiagKKT)
from infiniteexamodels_jax.solvers.scenario_shard import (  # noqa: E402
    ShardedScenarioKKT)
from infiniteexamodels_jax.utils.compile_cache import (  # noqa: E402
    use_compile_cache)

use_compile_cache()

COLL = r"(all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter)"


def pipelines(kkt, model):
    n, mm = model.nvar, model.ncon
    lam = jnp.zeros(mm)
    d = jnp.ones(mm)
    de = jnp.ones(n)
    rhs = jnp.ones(n)

    def step(x, th):
        K = kkt.assemble(x, th, lam, 1.0, d, de)
        fac, _ = kkt.factor(K)
        return kkt.solve(fac, rhs)

    step_tl = None
    if getattr(kkt, "tlayout", False):
        # the sharded-iterate step the IPM actually runs on the aligned
        # backends: solve + one refinement round entirely in T-layout; the
        # iterate never re-replicates (ZERO O(n) collectives -- audited)
        def step_tl(x, th):  # noqa: F811
            K = kkt.assemble(x, th, lam, 1.0, d, de)
            fac, _ = kkt.factor(K)
            r = kkt.tl_gather(rhs)
            dx = kkt.solve_tl(fac, r)
            resid = kkt.tl_sub(r, kkt.matvec_tl(K, dx))
            dx = kkt.tl_add(dx, kkt.solve_tl(fac, resid))
            return dx, kkt.tl_norm(resid)

        step_tl = jax.jit(step_tl)

    asm = jax.jit(lambda x, th: kkt.assemble(x, th, lam, 1.0, d, de))
    fac = jax.jit(lambda K: kkt.factor(K)[0])
    return jax.jit(step), asm, fac, step_tl


def timed(fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps * 1e3


def audit(step, model):
    hlo = step.lower(model.x0, model.theta).compile().as_text()
    lines = [ln.strip().split(" metadata=")[0]
             for ln in hlo.splitlines() if re.search(COLL + r"\(", ln)]
    bad = [ln for ln in lines
           if re.search(r"(all-gather|all-to-all)\(", ln)]
    return lines, bad


def run(kkt, model, label, do_audit=False):
    step, asm, fac, step_tl = pipelines(kkt, model)
    K = asm(model.x0, model.theta)
    t_a = timed(asm, model.x0, model.theta)
    t_f = timed(fac, K, reps=5)
    t_s = timed(step, model.x0, model.theta, reps=5)
    print(f"{label:12s} assemble {t_a:8.1f}  factor {t_f:8.1f}  "
          f"step {t_s:8.1f} ms")
    t_tl = None
    if step_tl is not None:
        t_tl = timed(step_tl, model.x0, model.theta, reps=5)
        print(f"{label + '/tl':12s} sharded-iterate step (solve + 1 "
              f"refinement round, no re-replication) {t_tl:8.1f} ms")
    if do_audit:
        lines, bad = audit(step, model)
        print(f"  HLO collectives in the {label} step "
              f"({len(lines)} total):")
        for ln in lines:
            print("   ", ln[:150])
        n_exp = 1 if getattr(kkt, "tlayout", False) else 0
        print("  gather/all-to-all collectives:",
              "NONE (assembly is communication-free)" if not bad else
              (f"{len(bad)} (the solution hand-back all-gather -- expected)"
               if len(bad) <= n_exp else f"{len(bad)} FOUND (UNEXPECTED)"))
        if step_tl is not None:
            hlo = step_tl.lower(model.x0,
                                model.theta).compile().as_text()
            colls = [ln.strip().split(" metadata=")[0]
                     for ln in hlo.splitlines()
                     if re.search(COLL + r"\(", ln)]
            # every collective must be strictly smaller than n elements
            n = model.nvar
            big = []
            for ln in colls:
                for s in re.findall(r"f(?:32|64)\[([\d,]*)\]",
                                    ln.split("(")[0]):
                    dims = [int(x) for x in s.split(",") if x] or [1]
                    el = 1
                    for v in dims:
                        el *= v
                    if el >= n:
                        big.append(ln)
            print(f"  T-layout step collectives: {len(colls)} total, "
                  + ("ZERO of size >= n (iterate stays sharded)"
                     if not big else f"{len(big)} of size >= n FOUND"))
    return t_a, t_f, t_s, t_tl


def main():
    m = pandemic(num_supports=25, num_scenarios=N_SCEN)
    model, _ = transcribe(m, row_pad=N_DEV)
    mesh = make_mesh(N_DEV)
    shard_model(model, mesh)
    assert sharded_fraction(model, mesh) == 1.0

    rep = run(BlockTridiagKKT(model, mesh=None), model, "replicated")
    kkt_al = ShardedScenarioKKT(model, mesh=mesh)
    assert kkt_al.aligned, "shard_map-aligned backend did not engage"
    print(f"(nb={kkt_al.nb}, bs={kkt_al.bs}, mB={kkt_al.mB}, "
          f"nb_loc={kkt_al.nb_loc} per device)")
    al = run(kkt_al, model, "aligned", do_audit=True)
    print(f"aligned assemble speedup vs replicated: {rep[0]/al[0]:5.2f}x "
          f"(per-device row work is 1/{N_DEV})")
    print(f"full step: {rep[2]/al[2]:5.2f}x vs replicated "
          "(CPU-mesh caveat above; on real chips each device adds compute)")
    if al[3] is not None:
        print(f"sharded-iterate (T-layout) step: {rep[2]/al[3]:5.2f}x vs "
              f"replicated, {al[2]/al[3]:5.2f}x vs the replicated-solution "
              "wrapper -- includes a refinement round the wrapper doesn't")


if __name__ == "__main__":
    main()
