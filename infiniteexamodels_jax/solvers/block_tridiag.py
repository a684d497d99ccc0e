"""Structured condensed-KKT backends: block-tridiagonal / block-diagonal
plus dense arrowhead.

Transcribed problems have two dominant KKT structures (SURVEY.md §5, §7):
time-stencil coupling -> block-banded; scenario coupling through first-stage
variables -> block-diagonal + arrowhead border.  Both are instances of

    K = [ T    B ]      T: nb blocks of size bs (tridiagonal or diagonal)
        [ B^T  C ]      B: (nT, m) border, C: (m, m) dense corner

The reference pipeline hands this structure to CUDSS/MA27 as a general
sparse matrix (README.md:36-41); this design *recovers* the structure once
at build time and factorizes with dense batched per-block kernels:

- high-degree variables form the border (first-stage coupling),
- the remaining T-subgraph is split into connected components: many small
  components (scenarios) -> component-aligned blocks, batched inverse-SPD
  per block -- embarrassingly parallel over blocks and shardable over a
  device mesh; one big component (time) -> reverse-Cuthill-McKee band,
  **block cyclic reduction** (log-depth, batched matmuls),
- the border is eliminated with a dense Schur complement
  S = C - B^T T^{-1} B, with Z = T^{-1} B precomputed at factor time so the
  per-solve border work is pure matmuls.

Why BCR and explicit block inverses instead of a sequential blocked
Cholesky scan: a scan serializes ~nb small dependent factorizations plus
2*nb triangular solves, each a kernel launch too small to fill the device.
BCR halves the system log2(nb) times with *batched* operations;
precomputing the eliminated blocks' inverses turns every BCR sweep -- and
therefore every KKT solve, including the IPM's iterative refinement --
into a short chain of batched matmuls with no triangular solves at all.
The extra FLOPs (~2-3x) buy log-depth instead of linear-depth latency.
SPD-ness of every eliminated block is inherited from the regularized
condensed KKT (Schur complements of SPD matrices are SPD), and the IPM's
f64 iterative refinement + KKT-residual-based convergence test keep the
explicit-inverse route honest.

Everything is static-shape; per-iteration assembly is a handful of
scatter-adds from the same per-family COO value stream the dense backend
uses.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from .kkt import DenseKKT


# ----------------------------------------------------------------------
# batched SPD helpers / block cyclic reduction
# ----------------------------------------------------------------------
def _chol_linv(D):
    """Batched Cholesky D = L L^T plus the explicit triangular inverse
    L^{-1}.  Applying D^{-1} is then two batched matmuls:
    D^{-1} b = L^{-T} (L^{-1} b).  A non-SPD block makes its factor
    non-finite, which ``ok`` reports (the IPM's inertia-correction ladder
    reads the failure from it)."""
    L = jnp.linalg.cholesky(D)
    eye = jnp.eye(D.shape[-1], dtype=D.dtype)
    Linv = jsl.solve_triangular(L, jnp.broadcast_to(eye, D.shape),
                                lower=True)
    return L, Linv, jnp.all(jnp.isfinite(Linv))


def _lsolve(L, X):
    """W = L^{-1} X for the Gram-form factor updates: the backward-stable
    batched triangular solve (the Gram structure ``-W^T W`` of the
    downstream updates keeps the Schur complements SPD)."""
    return jsl.solve_triangular(L, X, lower=True)


def _apply_inv(Linv, b):
    """D^{-1} b from the stored triangular inverse (batched matmuls)."""
    return jnp.einsum("kji,kjl,klr->kir", Linv, Linv, b)


def _bcr_factor(D, E):
    """Block-cyclic-reduction factorization of the SPD block-tridiagonal
    matrix with diagonal blocks ``D`` (nb, bs, bs) and sub-diagonal blocks
    ``E`` (nb-1, bs, bs) where ``E[j]`` couples row block j+1 to column
    block j.

    Stability note: the Schur updates of the surviving even blocks are
    computed in *Gram form* -- with W1 = L^{-1} E_odd^T and
    W2 = L^{-1} E_even (batched triangular solves at factor time), the
    updates are ``-W^T W``, which cannot push a block spuriously indefinite
    the way explicit-inverse sandwiches ``E D^{-1} E^T`` can.  The solve
    phase then uses the stored explicit triangular inverses so every sweep
    is pure batched matmuls.

    Returns ``(levels, root, ok)``: per-level tuples
    ``(Linv, E_odd, E_even)`` plus the root block's ``Linv``.  Depth is
    ceil(log2(nb)); every level is batched."""
    levels = []
    ok = jnp.asarray(True)
    while D.shape[0] > 1:
        m = D.shape[0]
        m_odd, m_even = m // 2, (m + 1) // 2
        L, Linv, okl = _chol_linv(D[1::2])
        ok = ok & okl
        zpad = jnp.zeros((1,) + D.shape[1:], D.dtype)
        Epad = jnp.concatenate([E, zpad])          # length m
        E_odd = Epad[1::2]                         # (m_odd,) E[2k+1]
        E_even = Epad[0::2][:m_odd]                # (m_odd,) E[2k]
        levels.append((Linv, E_odd, E_even))
        # Gram factors: W1 = L^{-1} E_odd^T, W2 = L^{-1} E_even
        W1 = _lsolve(L, jnp.swapaxes(E_odd, -1, -2))
        W2 = _lsolve(L, E_even)
        D_new = D[0::2]
        # left term  E[2k-1] D^{-1} E[2k-1]^T = W1^T W1 -> index k (k>=1)
        Lc = jnp.einsum("kja,kjb->kab", W1, W1)
        D_new = D_new.at[1:].add(-Lc[:m_even - 1])
        # right term E[2k]^T D^{-1} E[2k] = W2^T W2    -> index k (k<m_odd)
        Rc = jnp.einsum("kja,kjb->kab", W2, W2)
        D_new = D_new.at[:m_odd].add(-Rc)
        # new coupling E'_k = -E[2k+1] D^{-1} E[2k] = -W1^T W2
        if m_even > 1:
            En = -jnp.einsum("kja,kjb->kab", W1, W2)
            E = En[:m_even - 1]
        else:
            E = jnp.zeros((0,) + D.shape[1:], D.dtype)
        D = D_new
    _, root_linv, okr = _chol_linv(D)
    return levels, root_linv, ok & okr


def _bcr_solve(levels, root_linv, b):
    """Solve T x = b given the BCR factorization; ``b`` is (nb, bs) or
    (nb, bs, r).  Down-sweep + up-sweep, all batched matmuls."""
    vec = b.ndim == 2
    if vec:
        b = b[..., None]
    us = []
    for Linv, E_odd, E_even in levels:
        m = b.shape[0]
        m_odd, m_even = m // 2, (m + 1) // 2
        u = _apply_inv(Linv, b[1::2])
        us.append(u)
        b_new = b[0::2]
        lc = jnp.einsum("kij,kjr->kir", E_odd, u)
        b_new = b_new.at[1:].add(-lc[:m_even - 1])
        rc = jnp.einsum("kji,kjr->kir", E_even, u)
        b_new = b_new.at[:m_odd].add(-rc)
        b = b_new
    x = _apply_inv(root_linv, b)
    for (Linv, E_odd, E_even), u in zip(reversed(levels), reversed(us)):
        m_odd = u.shape[0]
        m_even = x.shape[0]
        xpad = jnp.concatenate(
            [x, jnp.zeros((1,) + x.shape[1:], x.dtype)])
        t1 = jnp.einsum("kij,kjr->kir", E_even, x[:m_odd])
        t2 = jnp.einsum("kji,kjr->kir", E_odd, xpad[1:1 + m_odd])
        x_odd = u - _apply_inv(Linv, t1 + t2)
        xn = jnp.zeros((m_even + m_odd,) + x.shape[1:], x.dtype)
        x = xn.at[0::2].set(x).at[1::2].set(x_odd)
    return x[..., 0] if vec else x


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class BlockTridiagKKT:
    """Structured condensed-KKT backend.  Build-time analysis happens once;
    per-iteration work is scatter-add assembly + block factorization.

    ``factor_dtype=jnp.float32`` enables mixed precision: the blocks are
    Jacobi-scaled (symmetric diagonal equilibration) and factorized in f32
    while the IPM's f64 iterative refinement (driven through
    :meth:`matvec` on the f64 blocks) restores full accuracy.

    ``assemble_dtype`` independently lowers the K assembly (Hessian AD
    sweep + block scatter) and therefore the refinement REFERENCE:
    unset, K stays f64 and refinement recovers f64-quality steps from the
    f32 factors (the classical factor-low/refine-high IR scheme); set to
    f32, the whole step set is low-precision (cheapest, but steps carry
    ~1e-7-relative model error).
    """

    assemble_dtype = None

    def __init__(self, model, max_block=512, min_blocks=4, max_border=4096,
                 factor_dtype=None, mesh=None, mesh_axis="sp",
                 nb_round=None):
        self.factor_dtype = factor_dtype
        self.model = model
        # device-mesh distribution of the block-diagonal (scenario) factor:
        # sharding constraints on the (nb, bs, bs) block axis let GSPMD run
        # the batched Cholesky/inverse per-device and psum-reduce the dense
        # Schur corner S = C - B^T T^-1 B over the mesh (SURVEY.md §7.6)
        self.mesh = mesh if mesh is not None else getattr(model, "mesh", None)
        self.mesh_axis = mesh_axis if mesh is not None else \
            getattr(model, "mesh_axis", mesh_axis)
        n = model.nvar
        rows = model.hess_rows_np
        cols = model.hess_cols_np

        import scipy.sparse as sp
        from scipy.sparse.csgraph import (reverse_cuthill_mckee,
                                          connected_components)

        adj = sp.coo_matrix(
            (np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
        adj.sum_duplicates()
        deg = np.diff(adj.indptr)

        # border = unusually high-degree variables (first-stage coupling)
        med = max(int(np.median(deg)), 1)
        thresh = max(8 * med, 32)
        border_mask = deg > thresh
        if border_mask.sum() > max_border:
            order = np.argsort(deg)[::-1]
            border_mask = np.zeros(n, bool)
            border_mask[order[:max_border]] = True
        t_mask = ~border_mask
        t_ids = np.nonzero(t_mask)[0]
        b_ids = np.nonzero(border_mask)[0]
        nT, mB = len(t_ids), len(b_ids)
        self.n, self.nT, self.mB = n, nT, mB
        if nT == 0:
            self.usable = False
            return

        sub = adj[t_ids][:, t_ids]
        ncomp, labels = connected_components(sub, directed=False)
        comp_sizes = np.bincount(labels) if ncomp else np.zeros(0, int)

        # padded position of every T variable + block size
        slot = np.full(n, -1, dtype=np.int64)
        if ncomp >= min_blocks and comp_sizes.max() <= max_block:
            # scenario mode: one block per component, padded to a common bs
            bs = _round_up(int(comp_sizes.max()), 8)
            nb = int(ncomp)
            offsets = np.zeros(n, dtype=np.int64)
            counter = np.zeros(ncomp, dtype=np.int64)
            for k, v in zip(labels, t_ids):
                offsets[v] = counter[k]
                counter[k] += 1
            slot[t_ids] = labels * bs + offsets[t_ids]
            self.mode = "block_diag"
        else:
            # time mode: band ordering.  Two candidates, smaller bandwidth
            # wins -- factor cost scales with bs^2 * nT:
            # (a) reverse Cuthill-McKee on the T-subgraph (general), and
            # (b) support-interleaved order (variables sorted by relative
            #     position within their tensor, i.e. time-major across all
            #     state/control/derivative tensors) -- on transcribed OCPs
            #     this groups each support's variables together and often
            #     beats the RCM heuristic by 2-3x.
            tt = t_mask[rows] & t_mask[cols]

            def band_of(order):
                pos = np.full(n, -1, dtype=np.int64)
                pos[order] = np.arange(len(order))
                return pos, int(np.max(np.abs(pos[rows[tt]] - pos[cols[tt]]),
                                       initial=0))

            perm = reverse_cuthill_mckee(sub, symmetric_mode=True)
            pos_rcm, bw_rcm = band_of(t_ids[perm])
            pos_int = bw_int = None
            variables = getattr(getattr(model, "core", None),
                                "variables", None)
            if variables:
                frac = np.zeros(n)
                vid = np.zeros(n, dtype=np.int64)
                for v in variables:
                    sl = slice(v.offset, v.offset + v.length)
                    frac[sl] = np.arange(v.length) / max(v.length, 1)
                    vid[sl] = v.vid
                key = np.lexsort((vid[t_ids], frac[t_ids]))
                pos_int, bw_int = band_of(t_ids[key])
            # prefer RCM unless the interleave wins decisively: factor
            # work scales with (bw+1)^2 so a 2/3 bandwidth cut is ~2x, but
            # marginal wins are not worth trading away RCM's track record
            # on numerically delicate (degenerate-endgame) problems
            if bw_int is not None and bw_int < 0.66 * bw_rcm:
                pos, bw = pos_int, bw_int
            else:
                pos, bw = pos_rcm, bw_rcm
            bs = _round_up(max(bw, 1) + 1, 8)
            nb = max((nT + bs - 1) // bs, 1)
            if nb_round is not None:
                # round the block count up for mesh segmentation (band
                # partitioning); extra blocks are pure identity padding
                nb = max(int(nb_round(nb)), nb)
            slot[t_ids] = pos[t_ids]
            self.mode = "band"

        self.bs, self.nb = bs, nb
        self.usable = bs <= max_block and nb >= min_blocks
        if not self.usable:
            return
        nTpad = nb * bs
        self.nTpad = nTpad

        # -- entry classification (static) -------------------------------
        rr, cc = rows, cols
        tt = t_mask[rr] & t_mask[cc]
        pr, pc = slot[rr], slot[cc]
        blk_r = np.where(pr >= 0, pr // bs, -9)
        blk_c = np.where(pc >= 0, pc // bs, -9)
        off_r, off_c = pr % bs, pc % bs

        selD = np.nonzero(tt & (blk_r == blk_c))[0]
        selL = np.nonzero(tt & (blk_r == blk_c + 1))[0]
        if tt.any():
            cross = tt & (np.abs(blk_r - blk_c) > 1)
            if cross.any():
                # structure assumption violated; caller falls back
                self.usable = False
                return
        selB = np.nonzero(t_mask[rr] & border_mask[cc])[0]
        selC = np.nonzero(border_mask[rr] & border_mask[cc])[0]
        self.block_diag = (self.mode == "block_diag") or len(selL) == 0

        bpos = np.full(n, -1, dtype=np.int64)
        bpos[b_ids] = np.arange(mB)

        as_j = jnp.asarray

        # assembly plan per target block array: gather the COO values of
        # each destination slot into a padded (unique slots, multiplicity)
        # table, segment-sum, and write the unique sorted slots once.
        # Multiplicities are tiny (quad-1000 D: mean 1.8, max 10), so the
        # padding wastes little; take-index == nnz is the sentinel row
        # pointing at an appended zero value.  Measured on the H100 at
        # quad-1000 this beats a sorted scatter-add (atomics) and a
        # diagonal-form plan (PERF.md).
        nnz_total = len(rows)

        def _gather_plan(sel, dest):
            order = np.argsort(dest, kind="stable")
            sel_s, dest_s = sel[order], dest[order]
            u, start, counts = np.unique(dest_s, return_index=True,
                                         return_counts=True)
            mult = int(counts.max()) if len(counts) else 1
            idx = start[:, None] + np.arange(mult)[None, :]
            valid = np.arange(mult)[None, :] < counts[:, None]
            tab = np.where(valid,
                           sel_s[np.minimum(idx, len(sel_s) - 1)],
                           nnz_total)
            return as_j(tab.astype(np.int64)), as_j(u)

        self.D_tab, self.D_u = _gather_plan(
            selD, blk_r[selD] * bs * bs + off_r[selD] * bs + off_c[selD])
        self.L_tab, self.L_u = _gather_plan(
            selL, blk_c[selL] * bs * bs + off_r[selL] * bs + off_c[selL])
        self.B_tab, self.B_u = _gather_plan(
            selB, pr[selB] * mB + bpos[cc[selB]])
        self.C_tab, self.C_u = _gather_plan(
            selC, bpos[rr[selC]] * mB + bpos[cc[selC]])

        # mesh-distributed factorization applies when the scenario-block
        # axis divides the mesh (block_diag mode; band stays single-device
        # until time-block partitioning lands)
        self._mesh_ok = (
            self.mesh is not None and self.block_diag
            and nb % self.mesh.devices.size == 0)

        # scatter targets for diagonal additions + rhs permutation
        self.t_ids_np = t_ids
        self.t_ids = as_j(t_ids)
        self.t_slots = as_j(slot[t_ids])        # padded positions
        self.b_ids = as_j(b_ids)
        tslot = slot[t_ids]
        # diagonal additions: sorted+unique flat scatter into D
        dorder = np.argsort(tslot, kind="stable")
        self.diag_take = as_j(t_ids[dorder])
        self.diag_dest = as_j((tslot[dorder] // bs) * bs * bs
                              + (tslot[dorder] % bs) * (bs + 1))
        # rhs/solution permutations as pure GATHERS (no scatter at all):
        # slot_src[s] = source variable of padded slot s (self-index for
        # pads, masked to 0), out_perm[i] = position of variable i in
        # concat([x_T.flat (nTpad), x_B (mB)])
        occupied = np.zeros(nTpad, bool)
        occupied[tslot] = True
        slot_src = np.zeros(nTpad, np.int64)
        slot_src[tslot] = t_ids
        self.slot_src = as_j(slot_src)
        self.slot_mask_np = occupied.astype(np.float64).reshape(nb, bs)
        self.slot_mask = as_j(self.slot_mask_np)
        out_perm = np.zeros(n, np.int64)
        out_perm[t_ids] = tslot
        out_perm[b_ids] = nTpad + np.arange(mB)
        self.out_perm = as_j(out_perm)
        # unit diagonal on padding slots so Cholesky stays well-posed
        pad = (~occupied).astype(np.float64).reshape(nb, bs)
        self.pad_eye = as_j(np.einsum("bi,ij->bij", pad, np.eye(bs)))

    # ------------------------------------------------------------------
    def _block_sharded(self, arr):
        """Constrain a block-batched array's leading (scenario) axis to the
        mesh; identity when no mesh applies."""
        if not self._mesh_ok:
            return arr
        from jax.sharding import NamedSharding, PartitionSpec

        spec = PartitionSpec(self.mesh_axis,
                             *([None] * (arr.ndim - 1)))
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(self.mesh, spec))

    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        m = self.model
        # low-precision mode: the whole Hessian AD sweep AND the block
        # scatter run in ``assemble_dtype``.  The "float32"/"mixed" step
        # sets also measure refinement residuals against this K (a
        # ~1e-7-relative model of the true system, plenty for the barrier
        # phases they serve); the
        # "ir32" step set instead refines matrix-free against the exact
        # f64 operator (SimdModel.hvp_lag + COO J products), so this K
        # only ever feeds the f32 factorization.
        fdt = self.assemble_dtype
        vals = m.kkt_vals(x, theta, lam, sigma, d, dtype=fdt)
        dt = vals.dtype
        nb, bs, mB = self.nb, self.bs, self.mB

        vals_p = jnp.concatenate([vals, jnp.zeros(1, dt)])

        def scat(tab, u, shape):
            # gather + segment-sum + unique sorted set (see _gather_plan)
            seg = vals_p[tab].sum(axis=1)
            flat = jnp.zeros(int(np.prod(shape)), dt).at[u].set(
                seg, indices_are_sorted=True, unique_indices=True)
            return flat.reshape(shape)

        L = (scat(self.L_tab, self.L_u, (max(nb - 1, 1), bs, bs))
             if (nb > 1 and not self.block_diag)
             else jnp.zeros((max(nb - 1, 1), bs, bs), dt))
        Dflat = scat(self.D_tab, self.D_u, (nb * bs * bs,))
        B = scat(self.B_tab, self.B_u, (self.nTpad, mB))
        C = scat(self.C_tab, self.C_u, (mB, mB))
        Dflat = Dflat.at[self.diag_dest].add(
            diag_extra[self.diag_take].astype(dt),
            indices_are_sorted=True, unique_indices=True)
        D = Dflat.reshape(nb, bs, bs) + self.pad_eye.astype(dt)
        C = C + jnp.diag(diag_extra[self.b_ids].astype(dt)) if mB else C
        D = self._block_sharded(D)
        B = self._block_sharded(B.reshape(nb, bs, mB))
        return (D, L, B, C)

    # ------------------------------------------------------------------
    def matvec(self, K, v):
        """K @ v from the block representation (used by the IPM's iterative
        refinement of the condensed solve).  Computed in the BLOCK dtype;
        the caller gets v's dtype back."""
        D, L, B, C = K
        nb, bs, mB = self.nb, self.bs, self.mB
        out_dt = v.dtype
        dt = D.dtype
        v = v.astype(dt)
        # padded-slot layout via pure gather + pad mask (no scatter)
        vT = (v[self.slot_src].reshape(nb, bs)
              * self.slot_mask.astype(dt))
        out_T = jnp.einsum("bij,bj->bi", D, vT)
        if nb > 1 and not self.block_diag:
            low = jnp.einsum("bij,bj->bi", L, vT[:-1])
            up = jnp.einsum("bji,bj->bi", L, vT[1:])
            out_T = out_T.at[1:].add(low).at[:-1].add(up)
        if mB:
            vB = v[self.b_ids]
            out_T = out_T + jnp.einsum("bij,j->bi", B, vB)
            out_B = jnp.einsum("bij,bi->j", B, vT) + C @ vB
        else:
            out_B = jnp.zeros(0, dt)
        out = jnp.concatenate([out_T.reshape(-1), out_B])[self.out_perm]
        return out.astype(out_dt)

    # ------------------------------------------------------------------
    def factor(self, K):
        D, L, B, C = K
        nb, bs, mB = self.nb, self.bs, self.mB

        # Jacobi (symmetric diagonal) equilibration -- ALWAYS.  The
        # condensed KKT carries ~1/delta_c (1e8+) diagonal entries from the
        # lifted equalities; the explicit-inverse BCR (unlike backward-
        # stable triangular solves) needs the per-block conditioning tamed
        # or the IPM's Newton steps lose too many digits for the iterative
        # refinement to recover.  With ``factor_dtype`` set, the equilibrated
        # blocks are additionally cast so the factorization runs on the
        # native low-precision hardware path.
        dg = jnp.abs(jnp.einsum("bii->bi", D))
        sT = 1.0 / jnp.sqrt(jnp.maximum(dg, 1e-30))      # (nb, bs)
        D = D * sT[:, :, None] * sT[:, None, :]
        if nb > 1 and not self.block_diag:
            L = L * sT[1:, :, None] * sT[:-1, None, :]
        if mB:
            sB = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(jnp.diag(C)), 1e-30))
            B = B * sT[:, :, None] * sB[None, None, :]
            C = C * sB[:, None] * sB[None, :]
        else:
            sB = jnp.zeros(0, D.dtype)
        if self.factor_dtype is not None and self.factor_dtype != D.dtype:
            fdt = self.factor_dtype
            D, L, B, C = (D.astype(fdt), L.astype(fdt), B.astype(fdt),
                          C.astype(fdt))

        if self.block_diag:
            # batched per-block Cholesky + explicit triangular inverses:
            # embarrassingly parallel over blocks and mesh-distributed over
            # the scenario axis (each device factors its own blocks); the
            # Schur-corner einsum below contracts the sharded axis, which
            # GSPMD lowers to a psum over the mesh
            _, Linv, ok = _chol_linv(D)
            Linv = self._block_sharded(Linv)
            tfac = (Linv,)
            Z = self._block_sharded(_apply_inv(Linv, B)) if mB else \
                jnp.zeros((nb, bs, 0), D.dtype)
        else:
            levels, root_inv, ok = _bcr_factor(D, L[:nb - 1])
            tfac = (levels, root_inv)
            Z = _bcr_solve(levels, root_inv, B) if mB else \
                jnp.zeros((nb, bs, 0), D.dtype)

        if mB:
            # S = C - B^T T^{-1} B; border solves reduce to matmuls with Z
            S = C - jnp.einsum("bij,bik->jk", B, Z)
            Ls = jnp.linalg.cholesky(S)
            ok = ok & jnp.all(jnp.isfinite(Ls))
        else:
            Ls = jnp.zeros((0, 0), D.dtype)
        return (tfac, Z, Ls, sT, sB), ok

    # ------------------------------------------------------------------
    def _t_solve(self, tfac, r):
        """Solve T u = r (r: (nb, bs) or (nb, bs, k)) -- batched matmuls."""
        vec = r.ndim == 2
        if self.block_diag:
            (Linv,) = tfac
            out = _apply_inv(Linv, r[..., None] if vec else r)
            return out[..., 0] if vec else out
        levels, root_linv = tfac
        return _bcr_solve(levels, root_linv, r)

    def solve(self, fac, rhs):
        tfac, Z, Ls, sT, sB = fac
        nb, bs, mB = self.nb, self.bs, self.mB
        dt = rhs.dtype
        fdt = Z.dtype
        rT = (rhs[self.slot_src].reshape(nb, bs)
              * self.slot_mask.astype(dt))
        if sT is not None:
            rT = (rT * sT).astype(fdt)
        else:
            rT = rT.astype(fdt)
        u = self._t_solve(tfac, rT)                   # (nb, bs)
        if mB:
            rB = rhs[self.b_ids]
            if sB is not None:
                rB = (rB * sB)
            rB = rB.astype(fdt)
            # x_B = S^{-1} (r_B - Z^T r_T);  x_T = u - Z x_B
            rhs2 = rB - jnp.einsum("bij,bi->j", Z, rT)
            z2 = jsl.solve_triangular(Ls, rhs2, lower=True)
            x2 = jsl.solve_triangular(Ls.T, z2, lower=False)
            x1 = u - jnp.einsum("bij,j->bi", Z, x2)
        else:
            x1 = u
            x2 = jnp.zeros(0, fdt)
        x1 = x1.astype(dt)
        if sT is not None:
            x1 = x1 * sT
        x2 = x2.astype(dt)
        if mB and sB is not None:
            x2 = x2 * sB
        return jnp.concatenate([x1.reshape(-1), x2])[self.out_perm]


def make_structured_kkt(model, fallback=True, **kwargs):
    """Detect block structure; fall back to the dense backend when the
    problem is too small or has no usable block layout.  With a device mesh
    attached to the model, scenario-structured problems get the shard_map-
    aligned backend (assembly AND factorization local per device)."""
    try:
        mesh = kwargs.get("mesh") or getattr(model, "mesh", None)
        if mesh is not None and mesh.devices.size > 1:
            from .scenario_shard import ShardedScenarioKKT
            kkt = ShardedScenarioKKT(model, **kwargs)
            if kkt.usable and not kkt.aligned and kkt.mode == "band":
                # time-structured problem on a mesh: segment the band
                from .band_shard import ShardedBandKKT

                band = ShardedBandKKT(model, **kwargs)
                if band.usable:
                    kkt = band
        else:
            kkt = BlockTridiagKKT(model, **kwargs)
        if kkt.usable:
            return kkt
    except Exception:
        if not fallback:
            raise
    if fallback:
        return DenseKKT(model)   # f64; mixed precision is structured-only
    raise NotImplementedError(
        "no usable block structure and fallback disabled")
