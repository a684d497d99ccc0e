"""Mesh-aligned scenario-parallel condensed-KKT backend (shard_map).

The GSPMD path in :mod:`block_tridiag` shards the *factorization* of the
block-diagonal scenario KKT but leaves assembly to the partitioner: family
rows are sharded by row index (time-major from transcription) while blocks
are sharded by scenario, so every per-iteration COO scatter-add crosses the
mesh.  Measured on a 4-device mesh the factor scales at ~110% efficiency
while the full assemble+factor+solve step runs at ~17% (benchmarks/
scaling.py) -- assembly communication eats the win.

This backend removes the communication *by construction* instead of asking
the compiler to discover locality it cannot prove:

- build time: every family row is mapped to the (unique) scenario block its
  variables live in -- rows only touch one block, else the blocks would have
  been merged by the connected-component analysis.  Rows are re-grouped per
  device (blocks are dealt contiguously, ``nb_loc = nb / n_devices`` each),
  padded to a common per-device row count, and every COO entry's target is
  precomputed as a flat index into a per-device buffer
  ``[D_local | B_local | C_partial | trash]``.
- run time: assemble/factor/solve/matvec run under :func:`jax.shard_map`.
  Each device evaluates ONLY its own rows (gathers from the replicated
  iterate), scatter-adds into ONLY its own blocks, and factors ONLY its own
  blocks.  The only collectives left are the ones the arrowhead actually
  requires: a psum of the dense Schur corner ``S = C - sum_b B_b^T T_b^-1
  B_b`` (mB x mB), a psum of the border right-hand side (mB), and a psum
  that re-assembles the replicated solution vector (n) -- all O(border),
  none O(nnz).

This is the mesh-parallel analogue of the reference stack's scenario
decomposition role (SURVEY.md §7.6; the reference itself hands the whole
KKT to CUDSS on one GPU -- multi-device scenario parallelism is new
capability, not translation).

The constraint/variable ordering visible to users is untouched: the
re-grouped tables are private copies used only for KKT assembly; function,
gradient and Jacobian evaluation keep the transcription row order.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax.sharding import NamedSharding, PartitionSpec as P

from .block_tridiag import BlockTridiagKKT, _chol_linv, _apply_inv


class TLayoutOps:
    """T-layout vector interface shared by the shard_map-aligned backends.

    A *T-layout* vector is the pair ``(xT, xB)`` where ``xT`` has global
    shape ``(nd, nb_loc*bs)`` sharded one row per device (each device's own
    padded block slots; padding entries are identically zero) and ``xB`` is
    the replicated ``(mB,)`` border part.  ``solve_tl``/``matvec_tl``
    operate natively in this layout with only O(border)+O(halo)
    collectives, so the IPM's iterative-refinement loop pays ZERO O(n)
    communication per round; the single O(n)
    collective left per step direction is the one :meth:`tl_scatter` that
    hands the finished step back to the replicated iterate -- an
    all-gather, which moves half the bytes of the psum it replaces.
    """

    tlayout = False     # set True by the aligned builders

    def tl_gather(self, rhs):
        """Replicated ``(n,)`` vector -> T-layout pair.  Collective-free:
        each device gathers its own slots from the replicated input."""
        b_ids = self._b_ids_np

        def local(rhs, src, smask):
            return (rhs[src[0]] * smask[0])[None], rhs[b_ids]

        sp, rep = self._sp(), jax.sharding.PartitionSpec()
        fn = self._smap(local, in_specs=(rep, sp, sp),
                        out_specs=(sp, rep))
        return fn(rhs, *self._rT_src)

    def tl_scatter(self, x):
        """T-layout pair -> replicated ``(n,)`` vector.  ONE all-gather of
        the T part (the only O(n) collective in the whole step path)."""
        xT, xB = x
        n, mB, ax = self.n, self.mB, self.mesh_axis
        src_flat = self._src_full_np.reshape(-1)
        mask_flat = self._smask_full_np.reshape(-1)
        b_ids = self._b_ids_np

        def local(xT, xB):
            g = jax.lax.all_gather(xT[0], ax)          # (nd, L) replicated
            out = jnp.zeros(n, xT.dtype).at[src_flat].add(
                g.reshape(-1) * jnp.asarray(mask_flat, xT.dtype))
            if mB:
                out = out.at[b_ids].set(xB)
            return out

        sp, rep = self._sp(), jax.sharding.PartitionSpec()
        fn = self._smap(local, in_specs=(sp, rep), out_specs=rep)
        return fn(xT, xB)

    def tl_add(self, a, b):
        return jax.tree.map(jnp.add, a, b)

    def tl_sub(self, a, b):
        return jax.tree.map(jnp.subtract, a, b)

    def tl_where(self, pred, a, b):
        return jax.tree.map(lambda u, v: jnp.where(pred, u, v), a, b)

    def tl_norm(self, a):
        """2-norm of a T-layout vector; equals the replicated norm because
        padding slots are identically zero and the border is replicated.
        Lowers to per-device partial sums + a scalar psum."""
        xT, xB = a
        return jnp.sqrt(jnp.sum(xT * xT) + jnp.sum(xB * xB))


class ShardedScenarioKKT(TLayoutOps, BlockTridiagKKT):
    """Block-diagonal scenario KKT with shard_map-aligned assembly.

    Falls back to the parent's behavior (GSPMD sharding constraints, or
    plain single-device) whenever the aligned layout does not apply; check
    :attr:`aligned`.
    """

    def __init__(self, model, mesh=None, mesh_axis="sp", **kwargs):
        super().__init__(model, mesh=mesh, mesh_axis=mesh_axis, **kwargs)
        self.aligned = False
        mesh = self.mesh
        if not (getattr(self, "usable", False) and self.block_diag
                and mesh is not None):
            return
        nd = mesh.devices.size
        if nd <= 1 or self.nb % nd:
            return
        try:
            self._build_aligned(model, nd)
        except _NotAlignable:
            return
        self.aligned = True
        self.tlayout = True

    # ------------------------------------------------------------------
    def _build_aligned(self, model, nd):
        nb, bs, mB = self.nb, self.bs, self.mB
        nb_loc = nb // nd
        self.nd, self.nb_loc = nd, nb_loc
        n = self.n
        ax = self.mesh_axis

        # per-variable block id / border position (numpy)
        t_ids = np.asarray(self.t_ids)
        t_slots = np.asarray(self.t_slots)
        b_ids = np.asarray(self.b_ids)
        blk = np.full(n, -1, np.int64)
        blk[t_ids] = t_slots // bs
        off = np.full(n, -1, np.int64)
        off[t_ids] = t_slots % bs
        bpos = np.full(n, -1, np.int64)
        bpos[b_ids] = np.arange(mB)

        # combined per-device buffer layout
        szD = nb_loc * bs * bs
        szB = nb_loc * bs * mB
        szC = mB * mB
        self._bufsz = szD + szB + szC
        trash = self._bufsz

        fams = [f for f in model.con_fams + model.obj_fams if f.kx > 0]
        self._al_fams = []
        tabs = []
        tgt_parts = [[] for _ in range(nd)]
        for fam in fams:
            vidx = np.asarray(fam.vidx[:fam.n])
            pidx = np.asarray(fam.pidx[:fam.n])
            fdata = np.asarray(fam.fdata[:fam.n])
            kx = fam.kx
            b = blk[vidx]                                  # (nf, kx)
            has_t = (b >= 0)
            rowblk = np.where(has_t.any(1), b.max(1), -1)
            # consistency: all T-vars of a row in one block
            if np.any(has_t & (b != rowblk[:, None])):
                raise _NotAlignable
            dev = np.where(rowblk >= 0, rowblk // nb_loc,
                           np.arange(fam.n) % nd)
            counts = np.bincount(dev, minlength=nd)
            Rmax = max(int(counts.max()), 1)
            rows = np.zeros((nd, Rmax), np.int64)
            mask = np.zeros((nd, Rmax))
            for d in range(nd):
                rd = np.nonzero(dev == d)[0]
                rows[d, :len(rd)] = rd
                mask[d, :len(rd)] = 1.0

            # entry targets (nd, Rmax, kx, kx) -> flat buffer index
            va = vidx[rows]                                # (nd,Rmax,kx)
            ba, oa, pa = blk[va], off[va], bpos[va]
            bl = ba - np.arange(nd)[:, None, None] * nb_loc  # local block
            A = ba[:, :, :, None]
            Bc = ba[:, :, None, :]
            blA = bl[:, :, :, None]
            oA, oB = oa[:, :, :, None], oa[:, :, None, :]
            pA, pB = pa[:, :, :, None], pa[:, :, None, :]
            tt = (A >= 0) & (Bc >= 0)
            tb = (A >= 0) & (Bc < 0)
            bb = (A < 0) & (Bc < 0)
            tgt = np.full((nd, Rmax, kx, kx), trash, np.int64)
            tgt = np.where(tt, (blA * bs + oA) * bs + oB, tgt)
            if mB:
                tgt = np.where(tb, szD + (blA * bs + oA) * mB + pB, tgt)
                tgt = np.where(bb, szD + szB + pA * mB + pB, tgt)
            tgt[mask == 0.0] = trash
            tgt_parts_f = tgt.reshape(nd, -1)
            for d in range(nd):
                tgt_parts[d].append(tgt_parts_f[d])

            sh = lambda a: jax.device_put(
                jnp.asarray(a),
                NamedSharding(self.mesh, P(ax, *([None] * (a.ndim - 1)))))
            lam_src = (fam.offset + rows if fam.offset is not None
                       else np.zeros_like(rows))
            tabs.append((sh(vidx[rows]), sh(pidx[rows]),
                         sh(jnp.asarray(fdata[rows], model.dtype)),
                         sh(jnp.asarray(mask, model.dtype)),
                         sh(lam_src)))
            self._al_fams.append((fam, fam.offset is not None))
        self._al_tabs = tuple(tabs)
        tgt_all = np.stack([np.concatenate(p) for p in tgt_parts])
        shx = lambda a: jax.device_put(
            jnp.asarray(a),
            NamedSharding(self.mesh, P(ax, *([None] * (a.ndim - 1)))))
        self._al_tgt = shx(tgt_all.astype(np.int32))

        # diagonal scatter: occupied t-slots -> D diagonal (per device)
        dev_of_t = blk[t_ids] // nb_loc
        counts = np.bincount(dev_of_t, minlength=nd)
        Cmax = max(int(counts.max()), 1)
        dsrc = np.zeros((nd, Cmax), np.int64)
        dtgt = np.full((nd, Cmax), trash, np.int64)
        dmask = np.zeros((nd, Cmax))
        for d in range(nd):
            sel = np.nonzero(dev_of_t == d)[0]
            ids = t_ids[sel]
            dsrc[d, :len(sel)] = ids
            lb = blk[ids] - d * nb_loc
            dtgt[d, :len(sel)] = (lb * bs + off[ids]) * bs + off[ids]
            dmask[d, :len(sel)] = 1.0
        self._dg = (shx(dsrc), shx(dtgt.astype(np.int32)), shx(dmask))

        # padding slots -> unit diagonal (per device)
        occ = np.zeros((nb, bs), bool)
        occ[t_slots // bs, t_slots % bs] = True
        pads = []
        for d in range(nd):
            sl = occ[d * nb_loc:(d + 1) * nb_loc]
            pb, po = np.nonzero(~sl)
            pads.append((pb * bs + po) * bs + po)
        Pmax = max(max(len(p) for p in pads), 1)
        ptgt = np.full((nd, Pmax), trash, np.int64)
        for d, p in enumerate(pads):
            ptgt[d, :len(p)] = p
        self._pad_tgt = shx(ptgt.astype(np.int32))

        # local t-slot -> global variable id (for rhs gather / solution
        # scatter); padding slots masked
        src = np.zeros((nd, nb_loc * bs), np.int64)
        smask = np.zeros((nd, nb_loc * bs))
        flat_slot = t_slots
        for d in range(nd):
            sel = np.nonzero(dev_of_t == d)[0]
            loc = flat_slot[sel] - d * nb_loc * bs
            src[d, loc] = t_ids[sel]
            smask[d, loc] = 1.0
        self._rT_src = (shx(src), shx(smask))
        self._src_full_np = src          # replicated copies for tl_scatter
        self._smask_full_np = smask
        self._b_ids_np = b_ids

    # ------------------------------------------------------------------
    def tables(self):
        """Pytree of the aligned static tables, for travelling as jit
        ARGUMENTS: on a multi-process mesh, closures over non-addressable
        (globally sharded) arrays are rejected by jit, so the IPM puts
        this pytree into its ``consts`` and rebinds it around tracing via
        :meth:`bound_tables` -- the same mechanism SimdModel uses for its
        family tables."""
        if not self.aligned:
            return None
        return {"tabs": self._al_tabs, "tgt": self._al_tgt,
                "dg": self._dg, "pad": self._pad_tgt,
                "rT": self._rT_src}

    @contextmanager
    def bound_tables(self, t):
        if t is None or not self.aligned:
            yield self
            return
        saved = (self._al_tabs, self._al_tgt, self._dg, self._pad_tgt,
                 self._rT_src)
        self._al_tabs = t["tabs"]
        self._al_tgt = t["tgt"]
        self._dg = t["dg"]
        self._pad_tgt = t["pad"]
        self._rT_src = t["rT"]
        try:
            yield self
        finally:
            (self._al_tabs, self._al_tgt, self._dg, self._pad_tgt,
             self._rT_src) = saved

    # ------------------------------------------------------------------
    def _smap(self, fn, in_specs, out_specs):
        return jax.shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def _sp(self):
        return P(self.mesh_axis)

    # ------------------------------------------------------------------
    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        if not self.aligned:
            return super().assemble(x, theta, lam, sigma, d, diag_extra)
        m = self.model
        ax = self.mesh_axis
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB
        szD, szB = nb_loc * bs * bs, nb_loc * bs * mB
        fams = self._al_fams
        rep = P()

        fdt = self.assemble_dtype

        def local(x, theta, lam, sigma, d, diag_extra, tgt, dg, pad_tgt,
                  *tabs):
            if fdt is not None:
                # low-precision step set: Hessian AD sweep + scatter run in
                # the assembly dtype (see BlockTridiagKKT.assemble)
                x, theta, lam, sigma, d, diag_extra = (
                    a.astype(fdt)
                    for a in (x, theta, lam, sigma, d, diag_extra))
            parts = []
            for (fam, has_lam), tb in zip(fams, tabs):
                vidx, pidx, fdata, mask, lam_src = (t[0] for t in tb)
                if fdt is not None:
                    fdata = fdata.astype(fdt)
                    mask = mask.astype(fdt)
                xg, pg = x[vidx], theta[pidx]
                H = jax.vmap(jax.hessian(fam.fn))(xg, pg, fdata)
                if has_lam:
                    g = jax.vmap(jax.grad(fam.fn))(xg, pg, fdata)
                    w = lam[lam_src] * mask
                    dr = d[lam_src] * mask
                    M = w[:, None, None] * H + dr[:, None, None] * (
                        g[:, :, None] * g[:, None, :])
                else:
                    M = (sigma * mask)[:, None, None] * H
                parts.append(M.reshape(-1))
            vals = jnp.concatenate(parts)
            buf = jnp.zeros(self._bufsz + 1, vals.dtype)
            buf = buf.at[tgt[0]].add(vals)
            dsrc, dtgt, dmask = dg
            buf = buf.at[dtgt[0]].add(diag_extra[dsrc[0]] * dmask[0])
            buf = buf.at[pad_tgt[0]].add(
                jnp.ones(pad_tgt.shape[-1], vals.dtype))
            D = buf[:szD].reshape(nb_loc, bs, bs)
            B = buf[szD:szD + szB].reshape(nb_loc, bs, mB)
            Cp = buf[szD + szB:self._bufsz].reshape(mB, mB)
            C = jax.lax.psum(Cp, ax)
            if mB:
                C = C + jnp.diag(diag_extra[self._b_ids_np])
            return D, B, C

        sp = self._sp()
        nested = tuple(tuple(sp for _ in tb) for tb in self._al_tabs)
        fn = self._smap(
            local,
            in_specs=(rep, rep, rep, rep, rep, rep, sp, (sp, sp, sp), sp)
            + nested,
            out_specs=(sp, sp, rep))
        return fn(x, theta, lam, sigma, d, diag_extra, self._al_tgt,
                  self._dg, self._pad_tgt, *self._al_tabs)

    # ------------------------------------------------------------------
    def factor(self, K):
        if not self.aligned:
            return super().factor(K)
        ax = self.mesh_axis
        mB = self.mB
        fdt = self.factor_dtype

        def local(D, B, C):
            dg = jnp.abs(jnp.einsum("bii->bi", D))
            sT = 1.0 / jnp.sqrt(jnp.maximum(dg, 1e-30))
            D = D * sT[:, :, None] * sT[:, None, :]
            if mB:
                sB = 1.0 / jnp.sqrt(
                    jnp.maximum(jnp.abs(jnp.diag(C)), 1e-30))
                B = B * sT[:, :, None] * sB[None, None, :]
                C = C * sB[:, None] * sB[None, :]
            else:
                sB = jnp.zeros(0, D.dtype)
            if fdt is not None and fdt != D.dtype:
                D, B, C = D.astype(fdt), B.astype(fdt), C.astype(fdt)
            _, Linv, ok = _chol_linv(D)
            Z = _apply_inv(Linv, B) if mB else \
                jnp.zeros(D.shape[:2] + (0,), D.dtype)
            okf = ok.astype(D.dtype)
            if mB:
                S = C - jax.lax.psum(jnp.einsum("bij,bik->jk", B, Z), ax)
                Ls = jnp.linalg.cholesky(S)
                okf = okf * jnp.all(jnp.isfinite(Ls)).astype(D.dtype)
            else:
                Ls = jnp.zeros((0, 0), D.dtype)
            ok_all = jax.lax.psum(1.0 - okf, ax) == 0.0
            return Linv, Z, Ls, sT, sB, ok_all

        sp, rep = self._sp(), P()
        fn = self._smap(local, in_specs=(sp, sp, rep),
                        out_specs=(sp, sp, rep, sp, rep, rep))
        Linv, Z, Ls, sT, sB, ok = fn(*K)
        return (Linv, Z, Ls, sT, sB), ok

    # ------------------------------------------------------------------
    def solve_tl(self, fac, r):
        """Solve in T-layout: collectives are exactly one O(mB) psum of the
        border rhs (nothing when mB == 0)."""
        ax = self.mesh_axis
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB

        def local(Linv, Z, Ls, sT, sB, rT2, rB):
            dt = rT2.dtype
            fdt = Z.dtype
            rT = rT2[0].reshape(nb_loc, bs)
            rT = (rT * sT).astype(fdt)
            u = _apply_inv(Linv, rT[..., None])[..., 0]
            if mB:
                rBs = (rB * sB).astype(fdt)
                rhs2 = rBs - jax.lax.psum(
                    jnp.einsum("bij,bi->j", Z, rT), ax)
                z2 = jsl.solve_triangular(Ls, rhs2, lower=True)
                x2 = jsl.solve_triangular(Ls.T, z2, lower=False)
                x1 = u - jnp.einsum("bij,j->bi", Z, x2)
                xB = x2.astype(dt) * sB
            else:
                x1 = u
                xB = jnp.zeros(0, dt)
            x1 = x1.astype(dt) * sT
            return x1.reshape(1, -1), xB

        sp, rep = self._sp(), P()
        fn = self._smap(
            local, in_specs=(sp, sp, rep, sp, rep, sp, rep),
            out_specs=(sp, rep))
        return fn(*fac, *r)

    def solve(self, fac, rhs):
        if not self.aligned:
            return super().solve(fac, rhs)
        return self.tl_scatter(self.solve_tl(fac, self.tl_gather(rhs)))

    # ------------------------------------------------------------------
    def matvec_tl(self, K, v):
        """K @ v in T-layout: one O(mB) psum for the border row."""
        ax = self.mesh_axis
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB

        def local(D, B, C, vT2, vB):
            out_dt = vT2.dtype
            dt = D.dtype
            vT = vT2[0].reshape(nb_loc, bs).astype(dt)
            oT = jnp.einsum("bij,bj->bi", D, vT)
            if mB:
                vBd = vB.astype(dt)
                oT = oT + jnp.einsum("bij,j->bi", B, vBd)
                oB = (jax.lax.psum(jnp.einsum("bij,bi->j", B, vT), ax)
                      + C @ vBd)
            else:
                oB = jnp.zeros(0, dt)
            return oT.reshape(1, -1).astype(out_dt), oB.astype(out_dt)

        sp, rep = self._sp(), P()
        fn = self._smap(local, in_specs=(sp, sp, rep, sp, rep),
                        out_specs=(sp, rep))
        return fn(*K, *v)

    def matvec(self, K, v):
        if not self.aligned:
            return super().matvec(K, v)
        return self.tl_scatter(self.matvec_tl(K, self.tl_gather(v)))


class _NotAlignable(Exception):
    pass
