"""Mesh-distributed band (time-axis) condensed-KKT backend (shard_map).

Time-block "context parallelism" for transcribed optimal-control problems
(SURVEY.md §5: the honest analogue of sequence parallelism in this domain
is partitioning the support axis).  The reference pipeline never
distributes anything -- its GPU path hands one flat sparse KKT to CUDSS on
a single device (README.md:36-41); this backend is new capability, not
translation.

Design: DISTRIBUTED BLOCK CYCLIC REDUCTION.  The band KKT

    K = [ T    B ]     T: nb tridiagonal blocks of size bs
        [ B^T  C ]     B: border (first-stage/high-degree) coupling

is partitioned into ``nd`` contiguous segments of ``nb_loc = nb/nd``
blocks, with nb padded so that nb_loc is a power of two (padding blocks
are identity and decoupled).  BCR's odd/even elimination is then run with
the SAME arithmetic as the single-device backend (block_tridiag._bcr_*,
including the Gram-form Schur updates that keep eliminated blocks from
going spuriously indefinite): each level eliminates the local odd blocks,
and the only cross-device dependence -- the eliminated segment-boundary
block couples into the right neighbor's first surviving block -- travels
as an O(bs^2) halo with one ppermute pair per level.  After log2(nb_loc)
levels one block per device survives; that nd-block chain is all-gathered
(O(nd*bs^2)) and finished with the replicated single-device BCR.

Per IPM iteration, each device:
  1. evaluates ONLY its own constraint/objective rows (rows are assigned
     to the device owning their first time block) and scatter-adds into
     its local D/E/B/C buffers; boundary-stencil spill travels as an
     O(bs^2 + bs*mB) halo ppermute;
  2. runs the local BCR levels (batched Cholesky + matmuls on its own
     blocks) with the per-level halo exchange;
  3. for the border: Z = T^{-1} B via the distributed solve, then one
     psum of the O(mB^2) Schur corner, Cholesky'd redundantly.

All collectives are O(bs^2 * log nb_loc + nd*bs^2 + mB^2) per
factorization and O(bs * log nb_loc + nd*bs + mB) per solve -- never
O(nnz), never O(n) -- except the final O(n) psum that re-assembles the
replicated solution vector (the same replication the scenario backend
pays; removing it requires the sharded-iterate IPM step, tracked
separately).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax.sharding import NamedSharding, PartitionSpec as P

from .block_tridiag import (BlockTridiagKKT, _bcr_factor, _bcr_solve,
                            _chol_linv, _apply_inv, _lsolve)
from .scenario_shard import TLayoutOps


class _NotBandShardable(Exception):
    pass


def _pow2_segments(nd):
    """nb_round callable: nb -> nd * 2^ceil(log2(ceil(nb/nd)))."""
    def rnd(nb):
        per = max((nb + nd - 1) // nd, 1)
        return nd * int(2 ** np.ceil(np.log2(per)))
    return rnd


class ShardedBandKKT(TLayoutOps, BlockTridiagKKT):
    """Band-mode condensed KKT with per-device time segments.

    Falls back to the parent's single-device behavior when the layout does
    not apply; check :attr:`aligned`.
    """

    def __init__(self, model, mesh=None, mesh_axis="sp", **kwargs):
        mesh_ = mesh if mesh is not None else getattr(model, "mesh", None)
        if mesh_ is not None and mesh_.devices.size > 1:
            kwargs.setdefault("nb_round", _pow2_segments(mesh_.devices.size))
        super().__init__(model, mesh=mesh, mesh_axis=mesh_axis, **kwargs)
        self.aligned = False
        mesh = self.mesh
        if not (getattr(self, "usable", False)
                and getattr(self, "mode", None) == "band"
                and not self.block_diag and mesh is not None):
            return
        nd = mesh.devices.size
        if nd <= 1 or self.nb % nd:
            return
        nb_loc = self.nb // nd
        if nb_loc & (nb_loc - 1):          # must be a power of two
            return
        try:
            self._build_aligned(model, nd)
        except _NotBandShardable:
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

        t_ids = np.asarray(self.t_ids)
        t_slots = np.asarray(self.t_slots)
        b_ids = np.asarray(self.b_ids)
        blk = np.full(n, -1, np.int64)
        blk[t_ids] = t_slots // bs
        off = np.full(n, -1, np.int64)
        off[t_ids] = t_slots % bs
        bpos = np.full(n, -1, np.int64)
        bpos[b_ids] = np.arange(mB)

        # per-device buffer layout:
        #   [D (nb_loc,bs,bs) | E (nb_loc,bs,bs) | B (nb_loc*bs,mB) |
        #    C (mB,mB) | haloD (bs,bs) | haloE (bs,bs) | haloB (bs,mB) |
        #    trash]
        # E[k] couples local block k (rows) to block k-1 (cols); E[0] is
        # the cross-boundary coupling to the LEFT neighbor's last block,
        # owned by THIS device, filled by the halo ppermute (always zero
        # on device 0).
        szD = nb_loc * bs * bs
        szE = nb_loc * bs * bs
        szB = nb_loc * bs * mB
        szC = mB * mB
        oE, oB_, oC = szD, szD + szE, szD + szE + szB
        oHD = oC + szC
        oHE = oHD + bs * bs
        oHB = oHE + bs * bs
        self._bufsz = oHB + bs * mB
        trash = self._bufsz
        self._offs = (szD, szE, szB, szC, oHD, oHE, oHB)

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
            bmax = np.where(has_t.any(1), np.where(has_t, b, -1).max(1), -1)
            bmin = np.where(has_t.any(1),
                            np.where(has_t, b, nb + 9).min(1), -1)
            # band invariant: a row's T-vars span <= 2 adjacent blocks
            if np.any((bmax >= 0) & (bmax - bmin > 1)):
                raise _NotBandShardable
            dev = np.where(bmin >= 0, bmin // nb_loc,
                           np.arange(fam.n) % nd)
            counts = np.bincount(dev, minlength=nd)
            Rmax = max(int(counts.max()), 1)
            rows = np.zeros((nd, Rmax), np.int64)
            mask = np.zeros((nd, Rmax))
            for d_ in range(nd):
                rd = np.nonzero(dev == d_)[0]
                rows[d_, :len(rd)] = rd
                mask[d_, :len(rd)] = 1.0

            va = vidx[rows]                                # (nd,Rmax,kx)
            ba, oa, pa = blk[va], off[va], bpos[va]
            la = ba - np.arange(nd)[:, None, None] * nb_loc  # local block
            # la in 0..nb_loc-1 for own blocks; la == nb_loc for the
            # one-past-the-end (halo) block of a boundary-stencil row
            A = la[:, :, :, None]
            Bc = la[:, :, None, :]
            tA = ba[:, :, :, None] >= 0
            tB = ba[:, :, None, :] >= 0
            oA, oB2 = oa[:, :, :, None], oa[:, :, None, :]
            pA, pB = pa[:, :, :, None], pa[:, :, None, :]

            tgt = np.full((nd, Rmax, kx, kx), trash, np.int64)
            # D: same block, local
            selDD = tA & tB & (A == Bc) & (A <= nb_loc - 1)
            tgt = np.where(selDD, (A * bs + oA) * bs + oB2, tgt)
            # D halo: same block one past the end
            selDH = tA & tB & (A == Bc) & (A == nb_loc)
            tgt = np.where(selDH, oHD + oA * bs + oB2, tgt)
            # E: row block = col block + 1 (lower triangle, parent's
            # convention), local slot = row's local block
            selE = tA & tB & (A == Bc + 1) & (A <= nb_loc - 1)
            tgt = np.where(selE, oE + (A * bs + oA) * bs + oB2, tgt)
            # E halo: row in the neighbor's first block, col = own last
            selEH = tA & tB & (A == Bc + 1) & (A == nb_loc)
            tgt = np.where(selEH, oHE + oA * bs + oB2, tgt)
            # B: T row x border col
            selB = tA & ~tB & (A <= nb_loc - 1)
            if mB:
                tgt = np.where(selB, oB_ + (A * bs + oA) * mB + pB, tgt)
                selBH = tA & ~tB & (A == nb_loc)
                tgt = np.where(selBH, oHB + oA * mB + pB, tgt)
                # C: border x border
                selC = ~tA & ~tB
                tgt = np.where(selC, oC + pA * mB + pB, tgt)
            tgt[mask == 0.0] = trash
            tgt_f = tgt.reshape(nd, -1)
            for d_ in range(nd):
                tgt_parts[d_].append(tgt_f[d_])

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

        # diagonal additions: occupied t-slots -> local D diagonal
        dev_of_t = (t_slots // bs) // nb_loc
        counts = np.bincount(dev_of_t, minlength=nd)
        Cmax = max(int(counts.max()), 1)
        dsrc = np.zeros((nd, Cmax), np.int64)
        dtgt = np.full((nd, Cmax), trash, np.int64)
        dmask = np.zeros((nd, Cmax))
        for d_ in range(nd):
            sel = np.nonzero(dev_of_t == d_)[0]
            ids = t_ids[sel]
            lb = (t_slots[sel] // bs) - d_ * nb_loc
            o_ = t_slots[sel] % bs
            dsrc[d_, :len(sel)] = ids
            dtgt[d_, :len(sel)] = (lb * bs + o_) * bs + o_
            dmask[d_, :len(sel)] = 1.0
        self._dg = (shx(dsrc), shx(dtgt.astype(np.int32)), shx(dmask))

        # padding slots -> unit diagonal (per device)
        occ = np.zeros((nb, bs), bool)
        occ[t_slots // bs, t_slots % bs] = True
        pads = []
        for d_ in range(nd):
            sl = occ[d_ * nb_loc:(d_ + 1) * nb_loc]
            pb, po = np.nonzero(~sl)
            pads.append((pb * bs + po) * bs + po)
        Pmax = max(max(len(p) for p in pads), 1)
        ptgt = np.full((nd, Pmax), trash, np.int64)
        for d_, p in enumerate(pads):
            ptgt[d_, :len(p)] = p
        self._pad_tgt = shx(ptgt.astype(np.int32))

        # local slot -> global variable id (rhs gather / solution scatter)
        src = np.zeros((nd, nb_loc * bs), np.int64)
        smask = np.zeros((nd, nb_loc * bs))
        for d_ in range(nd):
            sel = np.nonzero(dev_of_t == d_)[0]
            loc = t_slots[sel] - d_ * nb_loc * bs
            src[d_, loc] = t_ids[sel]
            smask[d_, loc] = 1.0
        self._rT_src = (shx(src), shx(smask))
        self._src_full_np = src          # replicated copies for tl_scatter
        self._smask_full_np = smask
        self._b_ids_np = b_ids

    # ------------------------------------------------------------------
    def _smap(self, fn, in_specs, out_specs):
        return jax.shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def _sp(self):
        return P(self.mesh_axis)

    def _right(self):
        return [(i, (i + 1) % self.nd) for i in range(self.nd)]

    def _left(self):
        return [(i, (i - 1) % self.nd) for i in range(self.nd)]

    # ------------------------------------------------------------------
    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        if not self.aligned:
            return super().assemble(x, theta, lam, sigma, d, diag_extra)
        ax = self.mesh_axis
        nd, nb_loc, bs, mB = self.nd, self.nb_loc, self.bs, self.mB
        szD, szE, szB, szC, oHD, oHE, oHB = self._offs
        fams = self._al_fams
        rep = P()
        fdt = self.assemble_dtype

        def local(x, theta, lam, sigma, d, diag_extra, tgt, dg, pad_tgt,
                  *tabs):
            if fdt is not None:
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
            # halo exchange: boundary-stencil contributions move one
            # device to the right (device nd-1 sends exact zeros)
            halo = buf[oHD:oHB + bs * mB]
            halo = jax.lax.ppermute(halo, ax, self._right())
            hD = halo[:bs * bs]
            hE = halo[bs * bs:2 * bs * bs]
            hB = halo[2 * bs * bs:]
            D = buf[:szD].reshape(nb_loc, bs, bs)
            D = D.at[0].add(hD.reshape(bs, bs))
            E = buf[szD:szD + szE].reshape(nb_loc, bs, bs)
            E = E.at[0].add(hE.reshape(bs, bs))
            B = buf[szD + szE:szD + szE + szB].reshape(nb_loc * bs, mB)
            B = B.at[:bs].add(hB.reshape(bs, mB))
            Cp = buf[szD + szE + szB:szD + szE + szB + szC].reshape(mB, mB)
            C = jax.lax.psum(Cp, ax)
            if mB:
                C = C + jnp.diag(diag_extra[self._b_ids_np])
            return D, E, B.reshape(nb_loc, bs, mB), C

        sp = self._sp()
        nested = tuple(tuple(sp for _ in tb) for tb in self._al_tabs)
        fn = self._smap(
            local,
            in_specs=(rep, rep, rep, rep, rep, rep, sp, (sp, sp, sp), sp)
            + nested,
            out_specs=(sp, sp, sp, rep))
        return fn(x, theta, lam, sigma, d, diag_extra, self._al_tgt,
                  self._dg, self._pad_tgt, *self._al_tabs)

    # ------------------------------------------------------------------
    # distributed BCR (same arithmetic as block_tridiag._bcr_factor/_solve;
    # per level the segment-boundary dependence travels as a halo ppermute)
    # ------------------------------------------------------------------
    def _dist_bcr_factor(self, D, E, ax):
        """D, E local (nb_loc, bs, bs); E[k] couples local block k to its
        predecessor (E[0]: cross-boundary, zero on device 0).  Returns
        (levels, tail_levels, tail_root_linv, ok)."""
        levels = []
        ok = jnp.asarray(True)
        while D.shape[0] > 1:
            m = D.shape[0]
            mo = m // 2
            L, Linv, okl = _chol_linv(D[1::2])
            ok = ok & okl
            # E_even[i] couples eliminated (2i+1) to its LEFT survivor:
            # local E[1::2].  E_odd[i] couples eliminated (2i+1) to its
            # RIGHT survivor (2i+2): local E[2::2], last one pulled from
            # the right neighbor's E[0] (zero past the global end since
            # device 0's E[0] is identically zero).
            E_next0 = jax.lax.ppermute(E[0], ax, self._left())
            E_odd = jnp.concatenate([E[2::2], E_next0[None]])
            E_even = E[1::2]
            levels.append((Linv, E_odd, E_even))
            W1 = _lsolve(L, jnp.swapaxes(E_odd, -1, -2))
            W2 = _lsolve(L, E_even)
            D_new = D[0::2]
            # right-survivor updates: -W1^T W1; the last one crosses the
            # segment boundary (push right; device nd-1 pushes zeros)
            Lc = jnp.einsum("kja,kjb->kab", W1, W1)
            D_new = D_new.at[1:].add(-Lc[:mo - 1])
            hLc = jax.lax.ppermute(Lc[mo - 1], ax, self._right())
            D_new = D_new.at[0].add(-hLc)
            # left-survivor updates: -W2^T W2 (all local)
            Rc = jnp.einsum("kja,kjb->kab", W2, W2)
            D_new = D_new - Rc
            # new couplings between survivors: -W1^T W2; the last one
            # becomes the right neighbor's new E[0]
            En = -jnp.einsum("kja,kjb->kab", W1, W2)
            hEn = jax.lax.ppermute(En[mo - 1], ax, self._right())
            E = jnp.concatenate([hEn[None], En[:mo - 1]])
            D = D_new
        # cross-device tail: one block per device, couplings E[0]
        Dg = jax.lax.all_gather(D[0], ax)          # (nd, bs, bs)
        Eg = jax.lax.all_gather(E[0], ax)          # Eg[d]: block d <- d-1
        tail_levels, tail_root, okr = _bcr_factor(Dg, Eg[1:])
        return tuple(levels), tuple(tail_levels), tail_root, ok & okr

    def _dist_bcr_solve(self, levels, tail_levels, tail_root, b, ax, didx):
        """Solve T x = b; b local (nb_loc, bs) or (nb_loc, bs, r)."""
        vec = b.ndim == 2
        if vec:
            b = b[..., None]
        us = []
        for Linv, E_odd, E_even in levels:
            mo = b.shape[0] // 2
            u = _apply_inv(Linv, b[1::2])
            us.append(u)
            b_new = b[0::2]
            lc = jnp.einsum("kij,kjr->kir", E_odd, u)
            b_new = b_new.at[1:].add(-lc[:mo - 1])
            hlc = jax.lax.ppermute(lc[mo - 1], ax, self._right())
            b_new = b_new.at[0].add(-hlc)
            rc = jnp.einsum("kji,kjr->kir", E_even, u)
            b = b_new - rc
        bg = jax.lax.all_gather(b[0], ax)          # (nd, bs, r)
        xg = _bcr_solve(list(tail_levels), tail_root, bg)
        x = xg[didx][None]                         # (1, bs, r)
        for (Linv, E_odd, E_even), u in zip(reversed(levels),
                                            reversed(us)):
            mo = u.shape[0]
            # right-survivor values: x[i+1], the last from the right
            # neighbor's x[0]
            x_next0 = jax.lax.ppermute(x[0], ax, self._left())
            x_right = jnp.concatenate([x[1:], x_next0[None]])
            t1 = jnp.einsum("kij,kjr->kir", E_even, x[:mo])
            t2 = jnp.einsum("kji,kjr->kir", E_odd, x_right)
            x_odd = u - _apply_inv(Linv, t1 + t2)
            xn = jnp.zeros((2 * mo,) + x.shape[1:], x.dtype)
            x = xn.at[0::2].set(x).at[1::2].set(x_odd)
        return x[..., 0] if vec else x

    # ------------------------------------------------------------------
    def factor(self, K):
        if not self.aligned:
            return super().factor(K)
        ax = self.mesh_axis
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB
        fdt = self.factor_dtype

        def local(D, E, B, C):
            # Jacobi equilibration, consistent across the segment edge:
            # E[0]'s column scale is the LEFT neighbor's last block scale
            dg = jnp.abs(jnp.einsum("bii->bi", D))
            sT = 1.0 / jnp.sqrt(jnp.maximum(dg, 1e-30))      # (nb_loc, bs)
            s_left = jax.lax.ppermute(sT[nb_loc - 1], ax, self._right())
            D = D * sT[:, :, None] * sT[:, None, :]
            sE_col = jnp.concatenate([s_left[None], sT[:-1]])
            E = E * sT[:, :, None] * sE_col[:, None, :]
            if mB:
                sB = 1.0 / jnp.sqrt(
                    jnp.maximum(jnp.abs(jnp.diag(C)), 1e-30))
                B = B * sT[:, :, None] * sB[None, None, :]
                C = C * sB[:, None] * sB[None, :]
            else:
                sB = jnp.zeros(0, D.dtype)
            if fdt is not None and fdt != D.dtype:
                D, E, B, C = (D.astype(fdt), E.astype(fdt), B.astype(fdt),
                              C.astype(fdt))
            dt = D.dtype
            didx = jax.lax.axis_index(ax)
            levels, tails, troot, ok = self._dist_bcr_factor(D, E, ax)
            if mB:
                Z = self._dist_bcr_solve(levels, tails, troot, B, ax, didx)
                S = C - jax.lax.psum(
                    jnp.einsum("kij,kir->jr", B, Z), ax)
                Ls = jnp.linalg.cholesky(S)
                okf = (ok & jnp.all(jnp.isfinite(Ls))).astype(dt)
            else:
                Z = jnp.zeros((nb_loc, bs, 0), dt)
                Ls = jnp.zeros((0, 0), dt)
                okf = ok.astype(dt)
            ok_all = jax.lax.psum(1.0 - okf, ax) == 0.0
            return levels, tails, troot, Z, Ls, sT, sB, ok_all

        sp, rep = self._sp(), P()
        nlev = int(np.log2(nb_loc)) if nb_loc > 1 else 0
        nd = self.nd
        ntail = 0
        m = nd
        while m > 1:
            ntail += 1
            m = (m + 1) // 2
        lev_spec = tuple((sp, sp, sp) for _ in range(nlev))
        tail_spec = tuple((rep, rep, rep) for _ in range(ntail))
        fn = self._smap(local, in_specs=(sp, sp, sp, rep),
                        out_specs=(lev_spec, tail_spec, rep, sp, rep, sp,
                                   rep, rep))
        levels, tails, troot, Z, Ls, sT, sB, ok = fn(*K)
        return (levels, tails, troot, Z, Ls, sT, sB), ok

    # ------------------------------------------------------------------
    def solve_tl(self, fac, r):
        """Solve in T-layout: collectives are the BCR halos (O(bs) per
        level), the O(nd*bs) tail gather and one O(mB) border psum --
        nothing O(n)."""
        ax = self.mesh_axis
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB

        def local(levels, tails, troot, Z, Ls, sT, sB, rT2, rB):
            dt = rT2.dtype
            fdt = Z.dtype
            didx = jax.lax.axis_index(ax)
            rT = rT2[0].reshape(nb_loc, bs)
            rT = (rT * sT).astype(fdt)
            u = self._dist_bcr_solve(levels, tails, troot, rT, ax, didx)
            if mB:
                rBs = (rB * sB).astype(fdt)
                rhs2 = rBs - jax.lax.psum(
                    jnp.einsum("kij,ki->j", Z, rT), ax)
                z2 = jsl.solve_triangular(Ls, rhs2, lower=True)
                x2 = jsl.solve_triangular(Ls.T, z2, lower=False)
                x1 = u - jnp.einsum("kij,j->ki", Z, x2)
                xB = x2.astype(dt) * sB
            else:
                x1 = u
                xB = jnp.zeros(0, dt)
            x1 = x1.astype(dt) * sT
            return x1.reshape(1, -1), xB

        sp, rep = self._sp(), P()
        levels, tails = fac[0], fac[1]
        lev_spec = tuple((sp, sp, sp) for _ in levels)
        tail_spec = tuple((rep, rep, rep) for _ in tails)
        fn = self._smap(
            local,
            in_specs=(lev_spec, tail_spec, rep, sp, rep, sp, rep, sp, rep),
            out_specs=(sp, rep))
        return fn(*fac, *r)

    def solve(self, fac, rhs):
        if not self.aligned:
            return super().solve(fac, rhs)
        return self.tl_scatter(self.solve_tl(fac, self.tl_gather(rhs)))

    # ------------------------------------------------------------------
    def matvec_tl(self, K, v):
        """K @ v in T-layout: two O(bs) halo ppermutes + one O(mB) psum."""
        ax = self.mesh_axis
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB

        def local(D, E, B, C, vT2, vB):
            out_dt = vT2.dtype
            dt = D.dtype
            vT = vT2[0].reshape(nb_loc, bs).astype(dt)
            # left neighbor's last-block values (one bs-sized ppermute)
            v_left = jax.lax.ppermute(vT[nb_loc - 1], ax, self._right())
            oT = jnp.einsum("bij,bj->bi", D, vT)
            vprev = jnp.concatenate([v_left[None], vT[:-1]])
            oT = oT + jnp.einsum("bij,bj->bi", E, vprev)
            # E^T part: out[k-1] += E[k]^T v[k]; block 0's flows to the
            # LEFT neighbor's last block
            up = jnp.einsum("bji,bj->bi", E, vT)
            oT = oT.at[:nb_loc - 1].add(up[1:])
            halo_back = jax.lax.ppermute(up[0], ax, self._left())
            oT = oT.at[nb_loc - 1].add(halo_back)
            if mB:
                vBd = vB.astype(dt)
                oT = oT + jnp.einsum("bij,j->bi", B, vBd)
                oB = (jax.lax.psum(jnp.einsum("bij,bi->j", B, vT), ax)
                      + C @ vBd)
            else:
                oB = jnp.zeros(0, dt)
            return oT.reshape(1, -1).astype(out_dt), oB.astype(out_dt)

        sp, rep = self._sp(), P()
        fn = self._smap(local, in_specs=(sp, sp, sp, rep, sp, rep),
                        out_specs=(sp, rep))
        return fn(*K, *v)

    def matvec(self, K, v):
        if not self.aligned:
            return super().matvec(K, v)
        return self.tl_scatter(self.matvec_tl(K, self.tl_gather(v)))
