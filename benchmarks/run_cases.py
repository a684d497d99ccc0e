"""Benchmark sweep harness (the reference's ESCAPE34 run_cases,
/root/reference/ESCAPE34/run_cases_cpu.jl:33-95 / run_cases_gpu.jl:27-87):
sweeps model families over size configurations, JIT-preruns the first
configuration, and emits CSVs with the reference's column schema
(kwargs..., framework, nvar, ncon, objective, status, total_time,
solve_time, ad_time).

``ad_time`` here is measured directly from the solver's structured timers
(function/derivative evaluation share of the solve) instead of the
reference's solver-log text parsing.

Usage:
    python benchmarks/run_cases.py quad --sizes 1000 2000
    python benchmarks/run_cases.py pandemic --sizes "(25,4)" "(50,4)"
    python benchmarks/run_cases.py opf --sizes 100 200
"""
from __future__ import annotations

import argparse
import ast
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def solve_one(im_func, kwargs, linear_solver="auto"):
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend
    from infiniteexamodels_jax.solvers import IpmSolver

    t0 = time.time()
    m = im_func(**kwargs)
    backend = ExaTranscriptionBackend(
        IpmSolver, linear_solver=linear_solver, print_level=0, tol=1e-6)
    m.set_transformation_backend(backend)
    res = backend.optimize(m)          # includes jit compiles
    total_time = time.time() - t0
    # warm re-solve separates compile time from steady-state solve time
    backend.model.refresh_from_core()
    res = backend.solver.solve()
    return dict(
        nvar=backend.model.nvar,
        ncon=backend.model.ncon,
        objective=res.objective,
        status=res.status,
        total_time=round(total_time, 3),
        solve_time=round(res.solve_time, 3),
        ad_time=round(res.timers.get("step_total", float("nan")), 3),
        iters=res.iter,
    )


def run_cases(name, im_func, kwarg_list, outdir, prerun=True):
    rows = []
    if prerun:   # JIT prerun on the first config (reference :41-46)
        solve_one(im_func, kwarg_list[0])
    kw_keys = sorted(kwarg_list[0])
    for kwargs in kwarg_list:
        out = solve_one(im_func, kwargs)
        row = {k: kwargs[k] for k in kw_keys}
        row["framework"] = "InfiniteExaModelsJAX"
        row.update(out)
        rows.append(row)
        print(row)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{name}_ipm_results.csv")
    cols = kw_keys + ["framework", "nvar", "ncon", "objective", "status",
                      "total_time", "solve_time", "ad_time", "iters"]
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    print("wrote", path)
    # LaTeX table alongside the CSV (reference examples/utils.jl emits a
    # booktabs table for the paper)
    tex = os.path.join(outdir, f"{name}_ipm_results.tex")
    with open(tex, "w") as fh:
        fh.write("\\begin{tabular}{" + "r" * len(cols) + "}\n\\toprule\n")
        fh.write(" & ".join(c.replace("_", "\\_") for c in cols)
                 + " \\\\\n\\midrule\n")
        for r in rows:
            fh.write(" & ".join(str(r[c]) for c in cols) + " \\\\\n")
        fh.write("\\bottomrule\n\\end{tabular}\n")
    print("wrote", tex)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("model", choices=["quad", "pandemic", "opf",
                                      "hovercraft", "kinetics"])
    ap.add_argument("--sizes", nargs="+", required=True)
    ap.add_argument("--outdir",
                    default=os.path.join(os.path.dirname(__file__),
                                         "results"))
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (tests/debug)")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from infiniteexamodels_jax import models as M
    from infiniteexamodels_jax.utils.compile_cache import (
        use_compile_cache)

    use_compile_cache()

    if args.model == "quad":
        kwargs = [dict(num_supports=int(s)) for s in args.sizes]
        run_cases("quadrotor", M.quad, kwargs, args.outdir)
    elif args.model == "pandemic":
        pairs = [ast.literal_eval(s) for s in args.sizes]
        kwargs = [dict(num_supports=nt, num_scenarios=nx)
                  for nt, nx in pairs]
        run_cases("pandemic", M.pandemic, kwargs, args.outdir)
    elif args.model == "opf":
        kwargs = [dict(num_supports=int(s)) for s in args.sizes]
        run_cases("opf", M.opf, kwargs, args.outdir)
    elif args.model == "hovercraft":
        kwargs = [dict(num_supports=int(s)) for s in args.sizes]
        run_cases("hovercraft", M.hovercraft, kwargs, args.outdir)
    elif args.model == "kinetics":
        kwargs = [dict(num_supports=int(s)) for s in args.sizes]
        run_cases("kinetics", M.kinetic_control, kwargs, args.outdir)


if __name__ == "__main__":
    main()
