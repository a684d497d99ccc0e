"""SimdModel: the frozen NLP with batched JAX evaluation kernels.

JAX ExaModel analogue (observed interface of the reference's upstream:
ExaModel fields theta/x0/lvar/uvar and the solution/multipliers API at
/root/reference/src/infiniteopt_backend.jl:464-527).  All evaluation methods
are pure functions of ``(x, theta)`` so solvers can jit over them; each
objective/constraint family contributes one vmapped template trace plus
static-index gathers/scatters, which XLA fuses into a handful of kernels.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import jax
import jax.numpy as jnp

from .compile import CompiledFamily


class SimdModel:
    def __init__(self, core, dtype=None, device=None, row_pad=1):
        self.core = core
        self.dtype = dtype or jnp.float64
        self.device = device
        self.sense = 1.0 if core.minimize else -1.0
        self.nvar = core.nvar
        self.ncon = core.ncon
        self.ntheta = core.ntheta
        # family rows are padded up to a multiple of ``row_pad`` (repeating
        # row 0's static indices -- no new sparsity-pattern entries) so
        # every family can be sharded over a device mesh regardless of its
        # logical row count; padded rows are masked out of scatter-adds and
        # sliced off value outputs
        self.row_pad = max(int(row_pad), 1)

        self.con_fams = [
            CompiledFamily(f.expr, f.itr, offset=f.offset, name=f.name)
            for f in core.con_families
        ]
        self.obj_fams = [
            CompiledFamily(f.expr, f.itr, name=f.name)
            for f in core.obj_families
        ]

        if core.con_families:
            self._lcon_np = np.concatenate(
                [f.lcon for f in core.con_families])
            self._ucon_np = np.concatenate(
                [f.ucon for f in core.con_families])
        else:
            self._lcon_np = np.zeros(0)
            self._ucon_np = np.zeros(0)
        self.lcon = jnp.asarray(self._lcon_np, self.dtype)
        self.ucon = jnp.asarray(self._ucon_np, self.dtype)

        # device copies of per-family static data (padded), plus a row mask
        # (None when no padding was needed).  Host (numpy) twins are kept so
        # host-side compilations (one-shot problem constants) never pull
        # buffers back from the device.
        self._fam_dev = {}
        self._fam_host = {}
        for fam in self.con_fams + self.obj_fams:
            vidx, pidx, fdata = fam.vidx, fam.pidx, fam.fdata
            mask_np = None
            rp = self.row_pad
            if rp > 1 and fam.n > 0 and fam.n % rp:
                n_pad = ((fam.n + rp - 1) // rp) * rp
                extra = n_pad - fam.n
                vidx = np.concatenate([vidx, np.repeat(vidx[:1], extra, 0)])
                pidx = np.concatenate([pidx, np.repeat(pidx[:1], extra, 0)])
                fdata = np.concatenate(
                    [fdata, np.repeat(fdata[:1], extra, 0)])
                mask_np = np.ones(n_pad)
                mask_np[fam.n:] = 0.0
            self._fam_host[id(fam)] = (vidx, pidx, fdata, mask_np)
            self._fam_dev[id(fam)] = (
                jnp.asarray(vidx), jnp.asarray(pidx),
                jnp.asarray(fdata, self.dtype),
                None if mask_np is None else jnp.asarray(mask_np,
                                                         self.dtype),
            )
        # static sparsity patterns (numpy + device copies)
        self.jac_rows_np = (np.concatenate([f.jac_rows() for f in self.con_fams])
                            if self.con_fams else np.zeros(0, np.int64))
        self.jac_cols_np = (np.concatenate([f.jac_cols() for f in self.con_fams])
                            if self.con_fams else np.zeros(0, np.int64))
        hp = [f.hess_rows_cols() for f in self.con_fams + self.obj_fams]
        self.hess_rows_np = (np.concatenate([p[0] for p in hp]) if hp
                             else np.zeros(0, np.int64))
        self.hess_cols_np = (np.concatenate([p[1] for p in hp]) if hp
                             else np.zeros(0, np.int64))
        self.jac_rows = jnp.asarray(self.jac_rows_np)
        self.jac_cols = jnp.asarray(self.jac_cols_np)

        self.refresh_from_core()

        # jitted entry points (shared across solves)
        self.obj_j = jax.jit(self.obj)
        self.cons_j = jax.jit(self.cons)
        self.grad_j = jax.jit(self.grad)

    # -- mutable data ----------------------------------------------------
    def refresh_from_core(self):
        """Re-materialize x0/bounds/theta device arrays after host-side
        mutation of the core (start-value updates, parameter updates)."""
        c = self.core
        self._x0_np = None           # x0 == core.x0 again (see set_x0)
        self.x0 = jnp.asarray(c.x0, self.dtype)
        self.lvar = jnp.asarray(c.lvar, self.dtype)
        self.uvar = jnp.asarray(c.uvar, self.dtype)
        self.theta = jnp.asarray(c.theta, self.dtype)
        # warm-start multiplier storage (NLPModels get_y0 analogue,
        # reference /root/reference/src/infiniteopt_backend.jl:600-601)
        if not hasattr(self, "y0") or self.y0.shape[0] != self.ncon:
            self.y0 = jnp.zeros(self.ncon, self.dtype)

    def set_parameter(self, par, values):
        """In-place theta update without rebuild (reference
        ExaModels.set_parameter! at infiniteopt_backend.jl:522-527)."""
        self.core.set_parameter(par, values)
        self.theta = jnp.asarray(self.core.theta, self.dtype)

    def set_x0(self, x0):
        # host twin kept for consts_fingerprint (np.asarray of a device
        # array would cost a device->host pull on every fingerprint)
        self._x0_np = np.asarray(x0, self.dtype)
        self.x0 = jnp.asarray(x0, self.dtype)

    def set_y0(self, y0):
        self.y0 = jnp.asarray(y0, self.dtype)

    def consts_fingerprint(self):
        """Content hash of the mutable model data that enters the solver's
        problem-constants module (theta, x0, bounds).  Solvers key a cache
        of the device-resident consts dict on this, so a warm re-solve
        uploads none of the ~20 constant arrays again.  Hashes only host
        twins -- never pulls device buffers."""
        import hashlib

        c = self.core
        x0 = self._x0_np if getattr(self, "_x0_np", None) is not None \
            else c.x0
        h = hashlib.blake2b(digest_size=16)
        for a in (c.theta, x0, c.lvar, c.uvar):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()

    # -- host-data view ---------------------------------------------------
    @contextmanager
    def host_data(self):
        """Temporarily rebind the static gather/pattern/bound arrays to
        their host (numpy) twins, so a CPU-backend trace of the evaluation
        methods never copies device buffers back to the host."""
        saved = (self._fam_dev, self.jac_rows, self.jac_cols,
                 self.lcon, self.ucon)
        self._fam_dev = self._fam_host
        self.jac_rows, self.jac_cols = self.jac_rows_np, self.jac_cols_np
        self.lcon, self.ucon = self._lcon_np, self._ucon_np
        try:
            yield self
        finally:
            (self._fam_dev, self.jac_rows, self.jac_cols,
             self.lcon, self.ucon) = saved

    def fam_tables(self):
        """The per-family static device tables as one pytree, in family
        order.  Multi-process meshes require sharded arrays to enter jitted
        functions as ARGUMENTS (closures over non-addressable buffers are
        rejected); solvers put this pytree into their consts argument and
        rebind it around tracing with :meth:`bound_tables`."""
        return tuple(self._fam_dev[id(f)]
                     for f in self.con_fams + self.obj_fams)

    @contextmanager
    def bound_tables(self, tables, jac_rows=None, jac_cols=None):
        """Temporarily rebind family tables (and optionally the Jacobian
        COO pattern vectors) to traced values; no-op when ``tables`` is
        None."""
        if tables is None:
            yield self
            return
        saved = (self._fam_dev, self.jac_rows, self.jac_cols)
        self._fam_dev = {
            id(f): t
            for f, t in zip(self.con_fams + self.obj_fams, tables)}
        if jac_rows is not None:
            self.jac_rows, self.jac_cols = jac_rows, jac_cols
        try:
            yield self
        finally:
            self._fam_dev, self.jac_rows, self.jac_cols = saved

    # -- family building block ------------------------------------------
    def _gather(self, fam, x, theta):
        vidx, pidx, fdata, mask = self._fam_dev[id(fam)]
        return x[vidx], theta[pidx], fdata

    def _fam_mask(self, fam):
        return self._fam_dev[id(fam)][3]

    def _fam_vals(self, fam, x, theta):
        """Template values over the LOGICAL rows (padding sliced off)."""
        xg, pg, fv = self._gather(fam, x, theta)
        return jax.vmap(fam.fn)(xg, pg, fv)[:fam.n]

    def _fam_grads(self, fam, x, theta):
        xg, pg, fv = self._gather(fam, x, theta)
        return jax.vmap(jax.grad(fam.fn))(xg, pg, fv)[:fam.n]  # (n, kx)

    def _fam_hess(self, fam, x, theta):
        xg, pg, fv = self._gather(fam, x, theta)
        return jax.vmap(jax.hessian(fam.fn))(xg, pg, fv)  # (n_pad, kx, kx)

    # -- evaluations (user sense; solvers fold in self.sense) ------------
    def obj(self, x, theta):
        total = jnp.zeros((), self.dtype)
        for fam in self.obj_fams:
            xg, pg, fv = self._gather(fam, x, theta)
            v = jax.vmap(fam.fn)(xg, pg, fv)
            mask = self._fam_mask(fam)
            total = total + (jnp.vdot(mask, v) if mask is not None
                             else jnp.sum(v))
        return total

    def grad(self, x, theta):
        g = jnp.zeros(self.nvar, self.dtype)
        for fam in self.obj_fams:
            if fam.kx == 0:
                continue
            xg, pg, fv = self._gather(fam, x, theta)
            gv = jax.vmap(jax.grad(fam.fn))(xg, pg, fv)
            mask = self._fam_mask(fam)
            if mask is not None:
                gv = gv * mask[:, None]
            vidx = self._fam_dev[id(fam)][0]
            g = g.at[vidx.reshape(-1)].add(gv.reshape(-1))
        return g

    def cons(self, x, theta):
        if not self.con_fams:
            return jnp.zeros(0, self.dtype)
        return jnp.concatenate(
            [self._fam_vals(f, x, theta) for f in self.con_fams])

    # -- fused value+derivative sweeps (one trace per family instead of
    # two; halves the per-family kernel count in the jitted IPM step) -----
    def obj_and_grad(self, x, theta):
        total = jnp.zeros((), self.dtype)
        g = jnp.zeros(self.nvar, self.dtype)
        for fam in self.obj_fams:
            xg, pg, fv = self._gather(fam, x, theta)
            mask = self._fam_mask(fam)
            if fam.kx == 0:
                v = jax.vmap(fam.fn)(xg, pg, fv)
                total = total + (jnp.vdot(mask, v) if mask is not None
                                 else jnp.sum(v))
                continue
            v, gv = jax.vmap(jax.value_and_grad(fam.fn))(xg, pg, fv)
            if mask is not None:
                total = total + jnp.vdot(mask, v)
                gv = gv * mask[:, None]
            else:
                total = total + jnp.sum(v)
            vidx = self._fam_dev[id(fam)][0]
            g = g.at[vidx.reshape(-1)].add(gv.reshape(-1))
        return total, g

    def cons_and_jac(self, x, theta):
        vals, jparts = [], []
        for fam in self.con_fams:
            xg, pg, fv = self._gather(fam, x, theta)
            if fam.kx == 0:
                vals.append(jax.vmap(fam.fn)(xg, pg, fv)[:fam.n])
                continue
            v, gv = jax.vmap(jax.value_and_grad(fam.fn))(xg, pg, fv)
            vals.append(v[:fam.n])
            jparts.append(gv[:fam.n].reshape(-1))
        cval = (jnp.concatenate(vals) if vals
                else jnp.zeros(0, self.dtype))
        jvals = (jnp.concatenate(jparts) if jparts
                 else jnp.zeros(0, self.dtype))
        return cval, jvals

    def jac_vals(self, x, theta):
        """Values matching (jac_rows, jac_cols)."""
        parts = []
        for fam in self.con_fams:
            if fam.kx == 0:
                continue
            parts.append(self._fam_grads(fam, x, theta).reshape(-1))
        if not parts:
            return jnp.zeros(0, self.dtype)
        return jnp.concatenate(parts)

    def _obj_hess_parts(self, x, theta, sigma):
        for fam in self.obj_fams:
            if fam.kx == 0:
                continue
            H = self._fam_hess(fam, x, theta)[:fam.n]
            yield fam, sigma * H

    def _con_hess_parts(self, x, theta, lam):
        for fam in self.con_fams:
            if fam.kx == 0:
                continue
            H = self._fam_hess(fam, x, theta)[:fam.n]
            w = jax.lax.dynamic_slice_in_dim(lam, fam.offset, fam.n)
            yield fam, w[:, None, None] * H

    def hess_vals(self, x, theta, lam, sigma):
        """Lagrangian Hessian COO values (full symmetric pattern
        hess_rows/cols): sigma * H(obj) + sum_i lam_i * H(c_i).

        NOTE the concat order is con families then obj families, matching
        the pattern construction in __init__.
        """
        parts = []
        for fam, Hw in self._con_hess_parts(x, theta, lam):
            parts.append(Hw.reshape(fam.n, -1)[:, self._sq(fam)].reshape(-1))
        for fam, Hw in self._obj_hess_parts(x, theta, sigma):
            parts.append(Hw.reshape(fam.n, -1)[:, self._sq(fam)].reshape(-1))
        if not parts:
            return jnp.zeros(0, self.dtype)
        return jnp.concatenate(parts)

    @staticmethod
    def _sq(fam):
        # (kx,kx) Hessian flattened in C order == pairs (a,b) meshgrid order
        return slice(None)

    def hvp_lag(self, x, theta, lam, sigma, v):
        """Lagrangian Hessian-vector product
        ``(sigma * H_f + sum_i lam_i * H_{c_i}) @ v`` without materializing
        any Hessian values: per family one vmapped jvp-of-grad sweep over
        the row-gathered slices of ``v`` (cost ~2 gradient sweeps).

        This is the matrix-free half of the ir32 refinement reference: the
        f32-assembled K feeds the factorization while the refinement
        residual is measured against the TRUE f64 operator via this + the
        COO ``jprod``/``jtprod`` (classical factor-low/refine-high IR
        without paying for an f64 Hessian scatter)."""
        out = jnp.zeros(self.nvar, v.dtype)
        for fam in self.con_fams + self.obj_fams:
            if fam.kx == 0:
                continue
            xg, pg, fv = self._gather(fam, x, theta)
            vidx = self._fam_dev[id(fam)][0]
            vg = v[vidx]                                  # (n_pad, kx)

            def hvp_row(xr, vr, pr, fr, fn=fam.fn):
                g = lambda z: jax.grad(fn)(z, pr, fr)
                return jax.jvp(g, (xr,), (vr,))[1]

            Hv = jax.vmap(hvp_row)(xg, vg, pg, fv)        # (n_pad, kx)
            if fam in self.obj_fams:
                w = jnp.full(Hv.shape[0], sigma, Hv.dtype)
            else:
                w = jnp.zeros(Hv.shape[0], Hv.dtype)
                w = jax.lax.dynamic_update_slice_in_dim(
                    w, jax.lax.dynamic_slice_in_dim(
                        lam, fam.offset, fam.n).astype(Hv.dtype), 0, axis=0)
            mask = self._fam_mask(fam)
            if mask is not None:
                w = w * mask
            out = out.at[vidx.reshape(-1)].add((w[:, None] * Hv).reshape(-1))
        return out

    def kkt_vals(self, x, theta, lam, sigma, d, dtype=None):
        """COO values of the condensed-KKT sparse part
        ``sigma*H_f + sum lam_i H_ci + J^T diag(d) J`` on the Hessian
        pattern: per con family the rank-1 ``d_r g_r g_r^T`` has exactly the
        family's square slot pattern, so it fuses into the same scatter.

        ``dtype`` runs the whole Hessian AD sweep in that precision (inputs
        cast once, template functions follow their operand dtype): the
        low-precision KKT step evaluates in f32 the values that feed an
        f32 factorization."""
        if dtype is not None:
            x, theta, lam, sigma, d = (jnp.asarray(a).astype(dtype)
                                       for a in (x, theta, lam, sigma, d))
        parts = []
        for fam in self.con_fams:
            if fam.kx == 0:
                continue
            xg, pg, fv = self._gather(fam, x, theta)
            if dtype is not None:
                fv = fv.astype(dtype)
            H = jax.vmap(jax.hessian(fam.fn))(xg, pg, fv)[:fam.n]
            g = jax.vmap(jax.grad(fam.fn))(xg, pg, fv)[:fam.n]
            w = jax.lax.dynamic_slice_in_dim(lam, fam.offset, fam.n)
            dr = jax.lax.dynamic_slice_in_dim(d, fam.offset, fam.n)
            M = w[:, None, None] * H + dr[:, None, None] * (
                g[:, :, None] * g[:, None, :])
            parts.append(M.reshape(-1))
        for fam in self.obj_fams:
            if fam.kx == 0:
                continue
            xg, pg, fv = self._gather(fam, x, theta)
            if dtype is not None:
                fv = fv.astype(dtype)
            H = jax.vmap(jax.hessian(fam.fn))(xg, pg, fv)[:fam.n]
            parts.append((sigma * H).reshape(-1))
        if not parts:
            return jnp.zeros(0, dtype or self.dtype)
        return jnp.concatenate(parts)

    # -- COO matvec helpers ----------------------------------------------
    def jprod(self, jvals, v):
        out = jnp.zeros(self.ncon, self.dtype)
        return out.at[self.jac_rows].add(jvals * v[self.jac_cols])

    def jtprod(self, jvals, w):
        out = jnp.zeros(self.nvar, self.dtype)
        return out.at[self.jac_cols].add(jvals * w[self.jac_rows])

    # -- solution extraction ---------------------------------------------
    def solution(self, xflat, var):
        """Reshape a flat solution slice to a variable's support grid
        (ExaModels.solution analogue, infiniteopt_backend.jl:464)."""
        seg = np.asarray(xflat)[var.offset:var.offset + var.length]
        return seg.reshape(var.shape) if var.shape else float(seg[0])

    def theta_view(self, par):
        seg = np.asarray(self.theta)[par.offset:par.offset + par.length]
        return seg.reshape(par.shape) if par.shape else float(seg[0])

    def multipliers(self, yflat, fam):
        return np.asarray(yflat)[fam.offset:fam.offset + len(fam)]
