"""Infinite-dimensional optimization framework on JAX.

A from-scratch JAX/XLA re-design of the capability surface of
infiniteopt/InfiniteExaModels.jl (reference: /root/reference):

- ``modeling``  -- infinite-dimensional modeling DSL (InfiniteOpt-equivalent,
  reference src/transform.jl call sites of InfiniteOpt's API).
- ``transcribe`` -- direct transcription compiler: InfiniteModel -> SIMD core
  (reference src/transform.jl `build_exa_core!`).
- ``ops``       -- SIMD NLP abstraction: per-family expression templates
  vmapped over support/scenario iterators (reference upstream ExaModels.jl).
- ``solvers``   -- filter line-search interior-point method with condensed
  KKT systems factorized on the accelerator (reference upstream
  MadNLP/Ipopt).
- ``backend``   -- transformation-backend lifecycle: build/solve/resolve,
  warm start, value/dual queries (reference src/infiniteopt_backend.jl).
- ``parallel``  -- device-mesh sharding of scenario/time axes with XLA
  collectives (new layer; the reference is single-device).
- ``models``    -- the example/benchmark model families (reference examples/,
  ESCAPE34/).

Everything runs in float64 by default (IPM accuracy); set
``IXM_X32=1`` to experiment with float32.
"""
import os

import jax

if not os.environ.get("IXM_X32"):
    jax.config.update("jax_enable_x64", True)
# On the GPU a float32 matmul defaults to TF32 (a 10-bit mantissa); the
# solver's mixed-precision factorization needs true float32 or the f64
# iterative refinement cannot recover the digits.  float64 products are
# unaffected.
jax.config.update("jax_default_matmul_precision", "highest")

from .ops import Core, SimdModel  # noqa: E402,F401

try:  # layers under construction in round 1; guard removed once complete
    from .modeling import (  # noqa: E402,F401
        InfiniteModel,
        Infinite,
        FiniteDifference,
        OrthogonalCollocation,
        Forward,
        Central,
        Backward,
        deriv,
        integral,
        expect,
        support_sum,
        uniform,
        normal,
        mvnormal,
        constant_over_collocation,
        DomainRestriction,
        All,
        PublicLabel,
        InternalLabel,
    )
    from .backend import ExaTranscriptionBackend, TranscriptionData  # noqa: E402,F401
    from .solvers import IpmSolver, MadIpmSolver  # noqa: E402,F401
except ImportError:  # pragma: no cover
    pass

__version__ = "0.1.0"
