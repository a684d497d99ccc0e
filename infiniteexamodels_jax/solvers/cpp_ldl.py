"""ctypes bindings + KKT backend for the native sparse LDL^T library.

The CPU analogue of the reference's Ipopt/MA27 path (in-process Fortran/C++
sparse symmetric factorization, reference README.md:36-41): the condensed
KKT system is scattered into a CSC upper-triangle pattern once (static),
then each IPM step factorizes/solves host-side through `jax.pure_callback`
while all AD evaluation stays in XLA.  Also reports exact inertia.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

_LIB = None


def _native_dir():
    return os.path.join(os.path.dirname(__file__), "..", "..", "native")


def load_library(build=True):
    """Load the native LDL library, (re)building it first when it is
    missing or older than ``native/ldl.cpp``, so what runs is always built
    from the committed source."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.join(_native_dir(), "libixmldl.so")
    src = os.path.join(_native_dir(), "ldl.cpp")
    stale = (not os.path.exists(so)
             or os.path.getmtime(so) < os.path.getmtime(src))
    if stale and build:
        subprocess.run(["make", "-B", "-C", _native_dir()], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(so)
    I = ctypes.POINTER(ctypes.c_int64)
    Dp = ctypes.POINTER(ctypes.c_double)
    lib.ldl_symbolic.restype = ctypes.c_int64
    lib.ldl_symbolic.argtypes = [ctypes.c_int64, I, I, I, I, I]
    lib.ldl_numeric.restype = ctypes.c_int64
    lib.ldl_numeric.argtypes = [ctypes.c_int64, I, I, Dp, I, I, I, Dp, Dp,
                                I, Dp]
    lib.ldl_solve.restype = None
    lib.ldl_solve.argtypes = [ctypes.c_int64, I, I, Dp, Dp, Dp]
    _LIB = lib
    return lib


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class SparseLDL:
    """Symbolic+numeric LDL^T over a fixed sparsity pattern.

    A reverse-Cuthill-McKee fill-reducing permutation is applied to the
    pattern before the symbolic analysis (the role MA27's minimum-degree
    ordering plays in the reference's Ipopt path): the etree-based
    up-looking factorization fills within the profile, so natural
    (transcription) order can explode on non-banded condensed KKTs."""

    def __init__(self, n, rows, cols, order="rcm"):
        self.lib = load_library()
        self.n = n
        if order == "rcm" and n > 1:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                              shape=(n, n)).tocsr()
            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                              dtype=np.int64)
        else:
            perm = np.arange(n, dtype=np.int64)
        self.perm = perm
        self.iperm = np.empty(n, np.int64)
        self.iperm[perm] = np.arange(n)
        rows = self.iperm[np.asarray(rows)]
        cols = self.iperm[np.asarray(cols)]
        # build upper-triangle CSC pattern (cols are CSC columns)
        r = np.minimum(rows, cols)
        c = np.maximum(rows, cols)
        order = np.lexsort((r, c))
        r, c = r[order], c[order]
        keep = np.ones(len(r), bool)
        keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        self.ur, self.uc = r[keep], c[keep]
        # map every COO entry to its deduped slot
        slot_of = np.cumsum(keep) - 1
        self.entry_slot = np.empty(len(rows), np.int64)
        self.entry_slot[order] = slot_of
        self.nnz = len(self.ur)
        self.Ap = np.zeros(n + 1, np.int64)
        np.add.at(self.Ap, self.uc + 1, 1)
        self.Ap = np.cumsum(self.Ap)
        self.Ai = self.ur.copy()
        # symbolic
        self.Lp = np.zeros(n + 1, np.int64)
        self.parent = np.zeros(n, np.int64)
        work = np.zeros(n, np.int64)
        lnz = self.lib.ldl_symbolic(n, _ptr_i(self.Ap), _ptr_i(self.Ai),
                                    _ptr_i(self.Lp), _ptr_i(self.parent),
                                    _ptr_i(work))
        self.Li = np.zeros(max(lnz, 1), np.int64)
        self.Lx = np.zeros(max(lnz, 1), np.float64)
        self.D = np.zeros(n, np.float64)
        self._wi = np.zeros(3 * n, np.int64)
        self._wx = np.zeros(n, np.float64)
        self.diag_slots = None  # filled by caller for diagonal additions

    def factor(self, coo_vals, diag):
        Ax = np.zeros(self.nnz)
        np.add.at(Ax, self.entry_slot, coo_vals)
        # the COO stream carries the FULL symmetric matrix: each strictly-
        # off-diagonal value arrives twice ((i,j) and (j,i)) and both land on
        # the same canonical upper slot -- halve those
        Ax[self.ur != self.uc] *= 0.5
        if self.diag_slots is not None:
            Ax[self.diag_slots] += diag
        info = self.lib.ldl_numeric(
            self.n, _ptr_i(self.Ap), _ptr_i(self.Ai), _ptr_d(Ax),
            _ptr_i(self.Lp), _ptr_i(self.parent), _ptr_i(self.Li),
            _ptr_d(self.Lx), _ptr_d(self.D), _ptr_i(self._wi),
            _ptr_d(self._wx))
        return int(info)

    def solve(self, b):
        # permuted system: K_p = P K P^T, solve K x = b as
        # K_p (P x) = P b
        x = np.ascontiguousarray(
            np.asarray(b, np.float64)[self.perm]).copy()
        self.lib.ldl_solve(self.n, _ptr_i(self.Lp), _ptr_i(self.Li),
                           _ptr_d(self.Lx), _ptr_d(self.D), _ptr_d(x))
        out = np.empty(self.n, np.float64)
        out[self.perm] = x
        return out


class CppLdlKKT:
    """Condensed-KKT backend routed through the native LDL (host callback).

    factor/solve are fused into a single callback per Newton attempt; a
    nonpositive-pivot count > 0 signals wrong inertia and triggers the IPM's
    regularization retry exactly like a failed Cholesky does on device.
    """

    exact_solve = True

    def __init__(self, model):
        self.model = model
        self.n = model.nvar
        rows, cols = model.hess_rows_np, model.hess_cols_np
        # ensure every diagonal entry exists in the pattern (Sigma_x+delta)
        diag = np.arange(self.n, dtype=np.int64)
        allr = np.concatenate([rows, diag])
        allc = np.concatenate([cols, diag])
        self.ldl = SparseLDL(self.n, allr, allc)
        self.nentries = len(rows)
        # find the slots of the diagonal entries
        self.ldl.diag_slots = self.ldl.entry_slot[self.nentries:]

    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        vals = self.model.kkt_vals(x, theta, lam, sigma, d)
        return (vals, diag_extra)

    def factor(self, K):
        # deferred to solve(); report ok here so the retry loop is driven by
        # the solve result (NaN on bad inertia)
        return K, jnp.asarray(True)

    def solve(self, fac, rhs):
        vals, diag = fac

        def host_solve(vals_h, diag_h, rhs_h):
            info = self.ldl.factor(
                np.concatenate([np.asarray(vals_h),
                                np.zeros(self.n)]),
                np.asarray(diag_h))
            if info != 0:   # nonpositive pivots or breakdown
                return np.full(self.n, np.nan)
            return self.ldl.solve(np.asarray(rhs_h))

        return jax.pure_callback(
            host_solve,
            jax.ShapeDtypeStruct((self.n,), rhs.dtype),
            vals, diag, rhs)

    def matvec(self, K, v):
        vals, diag = K
        m = self.model
        out = jnp.zeros(self.n, v.dtype)
        out = out.at[jnp.asarray(m.hess_rows_np)].add(
            vals * v[jnp.asarray(m.hess_cols_np)])
        return out + diag * v
