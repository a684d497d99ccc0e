"""Benchmark entry: prints driver-parseable JSON lines; the LAST line is
the result.

Primary metric: warm IPM iterations/s on the quadrotor OCP (band-structured
KKT, block-cyclic-reduction factorization) on one GPU.  Delivery is
continuous, not final-only:

- a provisional result line is printed immediately at startup and
  re-printed (upgraded) after every completed stage, so a kill at any
  point leaves the best banked result as the last complete line;
- SIGTERM/SIGINT handlers + atexit salvage milestones from any running
  child, emit the best-so-far line, and exit cleanly;
- every candidate runs in a timeboxed subprocess that appends milestone
  JSON lines to a progress file (built / first_solve / resolved / final);
  a timeout kills the child but the parent keeps the last milestone;
- the host-CPU reference (quad-1000 on the JAX CPU backend, one process
  pinned to ``jax_platforms="cpu"`` before any backend starts) runs
  concurrently with the GPU children; it never touches the card;
- a GPU check runs in a subprocess that exits before any device child
  starts (one JAX process per card); without a GPU the run fails;
- warm iter/s comes from a full warm re-solve (all modules compiled), or
  the solver's first_chunk/step_total timer split when the child deadline
  cuts the re-solve.

``vs_baseline`` is measured, not invented: each certified device size is
re-solved by the same solver on the host CPU backend and the ratio is GPU
iter/s over CPU iter/s.  The HEADLINE is the certified device result with
the best vs_baseline (reference-role: ESCAPE34/utils.jl:3-33 compact
per-run stats); every certified size is reported under detail["metrics"].
Every line names the card and its power limit (``nvidia-smi``).

Output contract: each emitted line is scalars-only, error strings
truncated, hard-capped at 1500 chars; the untruncated detail always goes to
BENCH_DETAIL.json next to this file.  The compile cache follows
utils/compile_cache.py.

Set IXM_BENCH_OPF=0 to skip the budget-gated 1000-scenario stochastic
AC-OPF stage (batched scenario KKT, runs when budget remains).
"""
import atexit
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import jax

from infiniteexamodels_jax.utils.compile_cache import use_compile_cache
from chip_smoke import card_info

_cache = use_compile_cache()

RUN_OPF = os.environ.get("IXM_BENCH_OPF", "1") != "0"
# the budget only bounds *clean* completion; kills at any time are safe
# because the best-so-far line is already on stdout
BUDGET_S = int(os.environ.get("IXM_BENCH_BUDGET", "2400"))
# stage timeouts (each additionally clipped to the remaining global
# budget).  They must exceed the cold compile time of their stage: a child
# killed mid-compile banks nothing and leaves nothing in the persistent
# cache.
BANK_TIMEOUT_S = int(os.environ.get("IXM_BENCH_BANK_TIMEOUT", "1200"))
QUAD_TIMEOUT_S = int(os.environ.get("IXM_BENCH_QUAD_TIMEOUT", "1800"))
BIG_TIMEOUT_S = int(os.environ.get("IXM_BENCH_BIG_TIMEOUT", "1200"))
OPF_TIMEOUT_S = int(os.environ.get("IXM_BENCH_OPF_TIMEOUT", "900"))
CPU_TIMEOUT_S = int(os.environ.get("IXM_BENCH_CPU_TIMEOUT", "500"))

T0 = time.time()


def remaining():
    return BUDGET_S - (time.time() - T0)


def certified(r):
    return r.get("status") in ("first_order", "acceptable")


# ----------------------------------------------------------------------
# child: one (model, size, platform, fdtype) measurement with milestones
# ----------------------------------------------------------------------
def _emit(progress_path, payload):
    if progress_path:
        with open(progress_path, "a") as f:
            f.write(json.dumps(payload) + "\n")


def child(kind, size, platform, fdtype):
    progress = os.environ.get("IXM_BENCH_PROGRESS", "")
    deadline = float(os.environ.get("IXM_BENCH_CHILD_DEADLINE", "0")) or None
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        fdtype = "float64"
    from infiniteexamodels_jax import models as M
    from infiniteexamodels_jax.backend import ExaTranscriptionBackend
    from infiniteexamodels_jax.solvers import IpmSolver

    build = {
        "quad": lambda: M.quad(num_supports=size),
        "hovercraft": lambda: M.hovercraft(num_supports=size),
        "opf": lambda: M.opf(num_supports=size),
    }[kind]
    base = {"kind": kind, "size": size, "platform": platform,
            "factor_dtype": fdtype}

    t0 = time.time()
    m = build()
    opts = {} if fdtype == "float64" else {"factor_dtype": fdtype}
    if fdtype == "ir32":
        # barrier handover to the f64 endgame once the f32 factorization
        # passes its viability wall (ipm.py mu_switch_ir option docs)
        opts["mu_switch_ir"] = float(
            os.environ.get("IXM_MU_SWITCH_IR", "1e-4"))
    if deadline:
        # non-converging solves must end as max_time (milestone written)
        # just before the parent's kill would hit
        opts["max_wall_time"] = max(deadline - time.time() - 60.0, 60.0)
    backend = ExaTranscriptionBackend(
        IpmSolver, linear_solver="auto", print_level=0, tol=1e-6, **opts)
    m.set_transformation_backend(backend)
    backend.build(m)
    build_s = time.time() - t0
    base.update(nvar=backend.model.nvar, ncon=backend.model.ncon,
                build_s=round(build_s, 2))
    _emit(progress, {**base, "milestone": "built"})

    t0 = time.time()
    res = backend.optimize(m)
    first_solve = time.time() - t0
    timers = res.timers or {}
    # warm rate from the first CONVERGED solve: everything after the first
    # 32-iteration chunk runs from compiled code (ipm.py first_chunk split)
    warm = None
    fc, st_total = timers.get("first_chunk"), timers.get("step_total")
    if fc and st_total and res.iter > 32 and st_total > fc:
        warm = round((res.iter - 32) / (st_total - fc), 3)
    base.update(status=res.status, iters=int(res.iter),
                objective=float(res.objective),
                first_solve_s=round(first_solve, 2),
                first_chunk_s=round(fc, 2) if fc else None,
                iters_per_s=warm)
    _emit(progress, {**base, "milestone": "first_solve"})

    # clean warm measurement: full re-solve, all modules compiled -- only
    # when the projected time fits the child's deadline
    projected = st_total - fc if (fc and st_total) else first_solve
    if deadline is None or time.time() + 1.3 * projected + 20 < deadline:
        backend.model.refresh_from_core()
        t0 = time.time()
        res2 = backend.solver.solve()
        resolve_s = time.time() - t0
        base.update(status=res2.status, iters=int(res2.iter),
                    objective=float(res2.objective),
                    resolve_s=round(resolve_s, 2),
                    iters_per_s=round(max(res2.iter, 1) / resolve_s, 3))
        # bank the clean warm rate BEFORE the profiling pass below: the
        # profiler jits each phase separately (fresh compiles), and a
        # timeout there must not lose the resolve measurement
        _emit(progress, {**base, "milestone": "resolved"})
    phases = None
    if platform != "cpu" and os.environ.get("IXM_BENCH_PROFILE", "0") != "0":
        try:
            phases = {k: round(v * 1e3, 3)
                      for k, v in backend.solver.profile_phases().items()}
        except Exception as e:
            phases = {"error": str(e)[:120]}
    if phases:
        base["phase_ms"] = phases
    _emit(progress, {**base, "milestone": "final"})
    print(json.dumps(base))


# ----------------------------------------------------------------------
# parent: async child management with milestone recovery
# ----------------------------------------------------------------------
ACTIVE_RUNS = []     # Run objects whose child may still be alive


class Run:
    def __init__(self, kind, size, timeout, platform="device",
                 fdtype="float64"):
        self.kind, self.size, self.platform = kind, size, platform
        self.spec = f"{kind}{size}_{platform}_{fdtype}"
        self.timeout = min(timeout, max(remaining() - 20, 60))
        self.deadline = time.time() + self.timeout
        fd, self.progress = tempfile.mkstemp(suffix=".jsonl",
                                             prefix="ixm_bench_")
        os.close(fd)
        env = os.environ.copy()
        env["IXM_BENCH_PROGRESS"] = self.progress
        env["IXM_BENCH_CHILD_DEADLINE"] = str(self.deadline)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             kind, str(size), platform, fdtype],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, env=env)
        self._result = None
        ACTIVE_RUNS.append(self)

    def _read_milestones(self):
        last = None
        try:
            with open(self.progress) as f:
                for ln in f:
                    ln = ln.strip()
                    if ln:
                        last = json.loads(ln)
        except Exception:
            pass
        return last

    def wait(self):
        if self._result is not None:
            return self._result
        try:
            _, err = self.proc.communicate(
                timeout=max(self.deadline - time.time(), 1))
            timed_out = False
        except subprocess.TimeoutExpired:
            self.proc.kill()
            try:
                _, err = self.proc.communicate(timeout=30)
            except Exception:
                err = ""
            timed_out = True
        r = self._read_milestones()
        if r is None:
            r = {"error": f"timeout>{self.timeout:.0f}s" if timed_out
                 else ("crash: " + (err or "no output")[-300:])}
        else:
            if timed_out:
                r["timed_out_after_s"] = round(self.timeout)
            if self.proc.returncode not in (0, None) and not timed_out \
                    and r.get("milestone") != "final":
                r["child_error"] = (err or "")[-600:]
            if r.get("iters_per_s") is None:
                r = {"error": "no warm rate before "
                     + ("timeout" if timed_out else "exit"), **r}
        try:
            os.unlink(self.progress)
        except OSError:
            pass
        self._result = r
        if self in ACTIVE_RUNS:
            ACTIVE_RUNS.remove(self)
        return r

    def poll(self):
        """Non-blocking: result if the child has exited, else None."""
        if self._result is not None:
            return self._result
        if self.proc.poll() is None and time.time() < self.deadline:
            return None
        return self.wait()


def run_sync(kind, size, timeout, platform="device", fdtype="float64"):
    return Run(kind, size, timeout, platform, fdtype).wait()


def gpu_device_kind(timeout=300):
    """``device_kind`` of the first JAX device, read in a subprocess that
    exits before any device child starts; None unless it is a GPU."""
    code = ("import jax\n"
            "d = jax.devices()[0]\n"
            "assert d.platform == 'gpu', d.platform\n"
            "print('gpu_ok', d.device_kind, flush=True)\n")
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout).stdout
    except subprocess.TimeoutExpired:
        return None
    for ln in out.splitlines():
        if ln.startswith("gpu_ok "):
            return ln[len("gpu_ok "):]
    return None


# ----------------------------------------------------------------------
# continuous emission: the driver parses the LAST complete stdout line,
# so the current best result is (re-)printed after every state change and
# on SIGTERM/exit.  Lines are compact, capped at 1500 chars; full detail
# goes to BENCH_DETAIL.json.
# ----------------------------------------------------------------------
_KEEP_KEYS = ("kind", "size", "platform", "factor_dtype", "nvar",
              "ncon", "build_s", "status", "iters", "objective",
              "first_solve_s", "first_chunk_s", "iters_per_s", "resolve_s",
              "milestone", "vs_baseline", "timed_out_after_s")
_MINI_KEYS = ("status", "iters_per_s", "vs_baseline")

DETAIL = {}          # label -> stage result dict (everything attempted)
CERTIFIED = {}       # label -> certified device result with a warm rate
CPU_RATES = {}       # (kind, size) -> certified host-CPU iter/s
CARD = card_info()   # "name, power limit" of the card, on every line


def _compact(r, keys=_KEEP_KEYS, errors=True):
    """Scalars-only stage summary with short error strings."""
    out = {}
    for k in keys:
        v = r.get(k)
        if v is None:
            continue
        if isinstance(v, float):
            v = round(v, 6)
        out[k] = v
    if errors:
        for k in ("error", "child_error"):
            if r.get(k) and "error" not in out:
                msg = " ".join(str(r[k]).split())
                out["error"] = msg[-120:]
    return out


def _print_line(metric, value, vs, detail):
    """One capped driver line to stdout (flushed: kills must not eat it)."""
    side = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BENCH_DETAIL.json")
    try:
        with open(side, "w") as f:
            json.dump(detail, f, indent=1)
    except Exception:
        pass
    head = {"metric": metric, "value": value, "unit": "iter/s",
            "vs_baseline": vs, "card": CARD}
    metrics = detail.get("metrics")
    stages = {k: v for k, v in detail.items() if k != "metrics"}

    def level(keys, errors):
        d = {k: (_compact(v, keys, errors) if isinstance(v, dict) else v)
             for k, v in stages.items()}
        if metrics:
            d["metrics"] = metrics
        return d

    for shrink in (level(_KEEP_KEYS, True), level(_MINI_KEYS, False),
                   {"metrics": metrics} if metrics else None, None):
        payload = dict(head) if shrink is None else {**head,
                                                     "detail": shrink}
        line = json.dumps(payload)
        if len(line) < 1500:
            break
    print(line[:1499], flush=True)


def emit_best():
    """Recompute the headline from current global state and print it.

    Preference order: certified device run with best vs_baseline (ties ->
    larger size) > uncertified device rate (flagged) > zero.  A host-CPU
    rate is never printed under the device metric.
    """
    metrics = {}
    for label, r in CERTIFIED.items():
        ref = CPU_RATES.get((r["kind"], r["size"]))
        r["vs_baseline"] = round(r["iters_per_s"] / ref, 3) if ref else 0.0
        metrics[label] = {"value": r["iters_per_s"],
                          "vs_baseline": r["vs_baseline"]}
    if metrics:
        DETAIL["metrics"] = metrics
    if CERTIFIED:
        label = max(CERTIFIED,
                    key=lambda k: (CERTIFIED[k]["vs_baseline"],
                                   CERTIFIED[k]["size"]))
        best = CERTIFIED[label]
        _print_line(f"{best['kind']}{best['size']}_ipm_iterations_per_s",
                    best["iters_per_s"], best["vs_baseline"], DETAIL)
        return
    cand = [r for r in DETAIL.values()
            if isinstance(r, dict) and r.get("iters_per_s")
            and r.get("platform") == "device"]
    if cand:
        best = max(cand, key=lambda r: r["iters_per_s"])
        _print_line(f"{best['kind']}{best['size']}"
                    "_ipm_iterations_per_s_UNCERTIFIED",
                    best["iters_per_s"], 0.0, DETAIL)
        return
    _print_line("ipm_iterations_per_s", 0.0, 0.0,
                DETAIL or {"note": "provisional: bench starting"})


def _absorb_cpu(key, r):
    """Record a finished host-CPU reference run."""
    DETAIL[f"cpu_{key[0]}{key[1]}"] = r
    if certified(r) and r.get("iters_per_s"):
        CPU_RATES[key] = r["iters_per_s"]


_DYING = False


def _salvage_and_exit(signum=None, frame=None):
    """SIGTERM/SIGINT: bank whatever running children have milestoned,
    print the best line, kill children, exit 0.  A wall-clock kill lands
    here instead of silencing the whole run."""
    global _DYING
    if _DYING:
        os._exit(0)
    _DYING = True
    for run in list(ACTIVE_RUNS):
        try:
            r = run._read_milestones()
            if r and r.get("iters_per_s"):
                if run.platform == "cpu":
                    _absorb_cpu((run.kind, run.size), r)
                else:
                    DETAIL[run.spec + "_salvaged"] = r
                    if certified(r):
                        CERTIFIED[run.spec + "_salvaged"] = r
            run.proc.kill()
        except Exception:
            pass
    try:
        emit_best()
    finally:
        os._exit(0)


def main():
    signal.signal(signal.SIGTERM, _salvage_and_exit)
    signal.signal(signal.SIGINT, _salvage_and_exit)
    # unhandled exceptions / normal return both re-print the best line
    atexit.register(emit_best)
    # a complete (zero) line exists from the first seconds; every later
    # emission upgrades it
    emit_best()

    kind = gpu_device_kind()
    if kind is None:
        DETAIL["error"] = "no GPU: the first JAX device is not a GPU"
        emit_best()
        sys.exit(1)
    DETAIL["device_kind"] = kind
    cpu_refs = {}           # (kind, size) -> Run
    # the host-CPU reference runs concurrently with the GPU children
    cpu_refs[("quad", 1000)] = Run("quad", 1000, CPU_TIMEOUT_S,
                                   platform="cpu")

    def join_cpu(block=False):
        for key, run in list(cpu_refs.items()):
            r = run.wait() if block else run.poll()
            if r is not None:
                del cpu_refs[key]
                _absorb_cpu(key, r)

    join_cpu()
    emit_best()

    def bank(r, label):
        DETAIL[label] = r
        ok = ("error" not in r and certified(r)
              and bool(r.get("iters_per_s")))
        if ok:
            key = (r["kind"], r["size"])
            if key not in cpu_refs and key not in CPU_RATES:
                cpu_refs[key] = Run(r["kind"], r["size"], CPU_TIMEOUT_S,
                                    platform="cpu")
            CERTIFIED[label] = r
        join_cpu()
        emit_best()
        return ok

    def ladder(kind, size, timeout, label, rungs):
        """Retry ladder: first certifying rung wins the size."""
        for suffix, fdtype in rungs:
            if remaining() < 240:
                return False
            if bank(run_sync(kind, size, timeout, fdtype=fdtype),
                    f"{label}_{suffix}"):
                return True
        return False

    # Stage order is cache-aware: on a warm persistent cache the cheap
    # quad-200 insurance goes first; on a cold one the headline quad-1000
    # gets the runway first.
    try:
        warm_cache = len(os.listdir(_cache)) >= 20
    except OSError:
        warm_cache = False

    def stage_a():
        # cheapest certifiable config, f64-only step set
        bank(run_sync("quad", 200, BANK_TIMEOUT_S), "quad200_f64")

    def stage_b():
        # the headline size, down a retry ladder of step sets
        ladder("quad", 1000, QUAD_TIMEOUT_S, "quad1000",
               [("f64", "float64"), ("mixed", "mixed"), ("ir32", "ir32")])

    if warm_cache:
        stage_a()
        stage_b()
    else:
        stage_b()
        if remaining() > 300:
            stage_a()

    # insurance if nothing banked yet
    if not CERTIFIED and remaining() > 180:
        bank(run_sync("hovercraft", 201, BANK_TIMEOUT_S),
             "hovercraft201_f64")

    # stochastic AC-OPF, 1000 scenarios (batched scenario-block KKT)
    if RUN_OPF and CERTIFIED and remaining() > 300:
        bank(run_sync("opf", 1000, OPF_TIMEOUT_S), "opf1000_f64")

    # reference-scale attempt (the reference sweeps quadrotor to 16k,
    # run_cases_cpu.jl:103-105); quad-2000 is the fallback size
    if CERTIFIED and remaining() > 420:
        big = ladder("quad", 4000, BIG_TIMEOUT_S, "quad4000",
                     [("f64", "float64"), ("mixed", "mixed")])
        if not big and remaining() > 420:
            ladder("quad", 2000, BIG_TIMEOUT_S, "quad2000",
                   [("f64", "float64"), ("mixed", "mixed")])

    join_cpu(block=True)
    emit_best()


if __name__ == "__main__":
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        plat = sys.argv[i + 3] if len(sys.argv) > i + 3 else "device"
        fdt = sys.argv[i + 4] if len(sys.argv) > i + 4 else \
            os.environ.get("IXM_BENCH_FDTYPE", "float64")
        child(sys.argv[i + 1], int(sys.argv[i + 2]), plat, fdt)
    else:
        main()
