"""Clipper facade: the user-facing class.

Counterpart of ``clipper_tpu/clipper.py:50-571`` (reference:
include/clipper/clipper.h:78-183, Python surface
bindings/python/py_clipper.cpp:197-232), with the same snake_case method
names. ``D1`` is (d, n1) with the data as columns, as in the reference.

Engines: ``"dense"`` builds the (m, m) M and C in the working dtype and
runs the nested solver (solvers/msrc.py); on the card it builds them for
any symmetric invariant with a device score (invariants.kernel_builds:
the built-in Euclidean and point-normal invariants, and a user's own
``DeviceScore``, whose library is compiled at first use) with the dense
build kernel, ops/affinity_pallas.build_affinity_pallas
(csrc/affinity_build.cu), which computes the same function as
ops/affinity.build_affinity. This is a departure in routing only: the JAX
facade builds through ``build_affinity`` everywhere. Any other invariant
builds through ``build_affinity`` on every device, as in the JAX facade.
``"triangle"`` keeps the
row-major datasets and solves through the symmetric-triangle capacity
engine (ops/symstore.solve_single, row-chunked by default, a CUDA kernel
on the card for either layout); ``"sharded"`` splits that storage over
the ranks of a ``torch.distributed`` process group (``mesh``; see
ops/symstore.solve_sharded_sym); ``"auto"`` takes dense below m = 8192
and the triangle from there, never the sharded engine.

The sharded engine is SPMD: every rank builds a Clipper with the same
options and calls it with the same data and u0 (the JAX package's
replicated inputs), and every rank gets the same Solution.

``solve(multistart=K)`` runs K inits of the dense engine's problem in
lock-step through the flat solver (solvers/msrc_flat.solve_multistart)
and keeps the densest cluster; the triangle engine raises for it, as the
JAX package's capacity engines do.

``Rounding.DSD`` (the exact densest subgraph, a host max flow,
solvers/dsd.py) runs on every engine over the nonzero support S of u: the
dense engines gather the (|S|, |S|) block M[S, S] on the device and copy
only that block to the host; the capacity engines round NONZERO and
rebuild that block from the invariant (:meth:`Clipper._dsd_on_support`);
the sparse path slices it from the scipy M. ``solve_as_maximum_clique``
runs the host max-clique solver (solvers/maxclique.py) on C.
``set_sparse_matrix_data`` keeps scipy input sparse: occupied-tile storage
(ops/blocksparse.py) and a solve that never makes a dense (m, m).
``solve_as_msrc_sdr`` solves the semidefinite relaxation (solvers/sdp.py)
on ``self.device`` over ``get_affinity_matrix()`` /
``get_constraint_matrix()``, which densify on the capacity and sparse
paths.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from clipper_tpu_torch import utils
from clipper_tpu_torch.invariants import kernel_builds
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.ops import affinity_pallas, blocksparse, symstore
from clipper_tpu_torch.ops.affinity import (build_affinity, create_all_to_all,
                                            distinctness_mask,
                                            gather_endpoints)
from clipper_tpu_torch.solvers import dsd, maxclique, msrc, msrc_flat, sdp
from clipper_tpu_torch.types import (Params, Rounding, Solution,
                                     as_association, resolve_device)
from clipper_tpu_torch.utils import profiling

_CAPACITY_M = 8192      # 'auto' switches to the triangle engine at this m
_DENSIFY_CAP = 16384    # largest m the capacity path densifies on demand


class Clipper:
    def __init__(self, invariant: Optional[PairwiseInvariant],
                 params: Params = Params(), *, dtype=None,
                 seed: Optional[int] = 0, engine: str = "auto",
                 mesh=None, engine_opts: Optional[dict] = None,
                 device="cuda"):
        """dtype: the working dtype (default torch's default float, the
        counterpart of the JAX package's x64 switch).

        seed: when :meth:`solve` gets no ``u0``, call k of this instance
        draws u0 from a CPU ``torch.Generator`` seeded from (seed, k), so
        runs are reproducible and equal on every device; seed=None seeds
        from the clock, as the reference does (src/utils.cpp:22-29). The
        draws differ from the JAX package's ``jax.random`` stream.

        engine: 'auto' | 'dense' | 'triangle' | 'sharded' (see the module
        docstring). mesh: the sharded engine's process group (None: the
        default group when one is initialized, else one rank). engine_opts
        are forwarded to the capacity engines (matvec, probes, power_steps,
        storage_dtype, support, tile, stats, ...).

        device: where matrices live and the solvers run, "cuda" by
        default; raises when CUDA is asked for and missing.
        """
        if engine not in ("auto", "dense", "triangle", "sharded"):
            raise ValueError(f"unknown engine {engine!r}")
        self.invariant = invariant
        self.params = params
        self.dtype = dtype or torch.get_default_dtype()
        self.seed = seed
        self.engine = engine
        self.mesh = mesh
        self.engine_opts = dict(engine_opts or {})
        self.device = resolve_device(device)
        self._nsolves = 0
        self._request: Optional[int] = None   # the tracer's request id
        self._A: Optional[torch.Tensor] = None   # (m, 2) associations
        self._M: Optional[torch.Tensor] = None   # (m, m) zero-diag symmetric
        self._C: Optional[torch.Tensor] = None   # (m, m) zero-diag 0/1
        self._soln: Optional[Solution] = None
        # capacity path: row-major datasets kept for the on-device build;
        # no dense (m, m)
        self._cap: Optional[dict] = None
        # sparse path (set_sparse_matrix_data with scipy input): symmetric
        # scipy matrices and occupied-tile device storage; no dense (m, m)
        self._M_sparse = None
        self._C_sparse = None
        self._bs: Optional[blocksparse.BlockSparseMC] = None
        self._bs_info: Optional[dict] = None

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def score_pairwise_consistency(self, D1, D2, A=None) -> None:
        """Build affinity/constraint matrices from (d, n) column-major data
        (reference: src/clipper.cpp:21-65). Under the triangle engine no
        dense (m, m) is made here: the datasets are kept and :meth:`solve`
        builds triangle storage on the device (under the sharded engine,
        each rank its slice). The dense engine builds on the card through
        the dense build kernel for a symmetric invariant with a device
        score (see the module docstring).

        Each call opens a new request of the tracer (utils/profiling): its
        span ``facade.score`` and the spans of the solves that follow share
        its id."""
        self._request = profiling.new_request()
        with profiling.annotate("facade.score", self._request):
            self._score(D1, D2, A)

    def _score(self, D1, D2, A) -> None:
        D1 = self._tensor(D1).T     # -> (n1, d) rows
        D2 = self._tensor(D2).T
        if A is not None and np.size(A) == 0:
            A = None
        m = len(A) if A is not None else D1.shape[0] * D2.shape[0]
        if self._resolve_engine(m) in ("triangle", "sharded"):
            if A is None:
                A = create_all_to_all(D1.shape[0], D2.shape[0])
            self._A = as_association(A, device=self.device)
            self._cap = {"D1": D1, "D2": D2}
            self._M = self._C = None
            self._clear_sparse()
            return
        if self.device.type == "cuda" and kernel_builds(self.invariant):
            if A is None:
                A = create_all_to_all(D1.shape[0], D2.shape[0])
            self._A = as_association(A, device=self.device)
            P1, P2 = gather_endpoints(D1, D2, self._A)
            self._M, self._C = affinity_pallas.build_affinity_pallas(
                self.invariant, P1, P2, self._A,
                affinityeps=self.params.affinityeps)
        else:
            self._M, self._C, self._A = build_affinity(
                self.invariant, D1, D2, A,
                affinityeps=self.params.affinityeps, dtype=self.dtype)
        self._cap = None
        self._clear_sparse()

    def _resolve_engine(self, m: int) -> str:
        if self.engine == "auto":
            return "dense" if m < _CAPACITY_M else "triangle"
        return self.engine

    # ------------------------------------------------------------------
    # solvers
    # ------------------------------------------------------------------

    def solve(self, u0=None, *, generator: Optional[torch.Generator] = None,
              multistart: int = 1) -> Solution:
        """Solve MSRC by graduated projected gradient ascent
        (reference: src/clipper.cpp:69-78). Without u0, a U[0, 1) vector is
        drawn from ``generator`` if given, else from the instance's seeded
        stream (see ``seed``).

        multistart > 1 draws that many u0 vectors from the same stream,
        one after another, solves them in parallel through the flat solver
        over the full-precision [M; C] and keeps the solution with the
        highest F (an extension; the reference solves from one init). An
        explicit u0 with multistart > 1 is contradictory and raises
        ValueError; the triangle engine raises NotImplementedError for
        multistart.

        Rounding.DSD rounds the engine's u by the exact densest subgraph
        of its nonzero support (reference: src/clipper.cpp:294-300), on
        the host (see the module docstring).

        Matrices injected sparse (``set_sparse_matrix_data`` with scipy
        input at low tile occupancy) are solved over their occupied-tile
        storage; no dense (m, m) is made.

        The whole call, to the mask on the host, is the tracer's span
        ``facade.solve`` of the last build's request (utils/profiling)."""
        with profiling.annotate("facade.solve", self._request):
            return self._solve(u0, generator, multistart)

    def _solve(self, u0, generator: Optional[torch.Generator],
               multistart: int) -> Solution:
        self._require_matrices()
        if multistart > 1 and u0 is not None:
            raise ValueError(
                "solve(u0=..., multistart>1) is contradictory: an explicit "
                "u0 fixes the single init. Pass generator=... to seed the "
                "multistart draws instead")
        if multistart > 1 and self._cap is not None:
            raise NotImplementedError(
                "multistart on the capacity engines is not supported; run "
                "separate solves with explicit generators (each solve "
                "rebuilds tile storage, so restarts are not near-free here)")
        if generator is None:
            generator = torch.Generator()
            if self.seed is None:
                generator.seed()
            else:
                generator.manual_seed(int(np.random.SeedSequence(
                    [self.seed, self._nsolves]).generate_state(1)[0]))
        self._nsolves += 1
        if self._bs_info is not None:
            return self._solve_sparse(u0, generator, multistart)
        m = self._m()
        t0 = time.perf_counter()
        if multistart > 1:
            u0s = torch.stack([utils.randvec(generator, m, dtype=self.dtype,
                                             device=self.device)
                               for _ in range(multistart)])
            soln = msrc_flat.solve_multistart(self._M, self._C, u0s,
                                              self.params)
        else:
            if u0 is None:
                u0 = utils.randvec(generator, m, dtype=self.dtype,
                                   device=self.device)
            u0 = self._tensor(u0)
            if self._cap is not None:
                soln = self._solve_capacity(u0)
            else:
                soln = msrc.solve_msrc(self._M, self._C, u0, self.params)
        if self.params.rounding == Rounding.DSD:
            mask = (self._dsd_on_support(soln.u) if self._cap is not None
                    else self._dsd_dense(soln.u))
            soln = Solution(ifinal=soln.ifinal, mask=mask, u0=soln.u0,
                            u=soln.u, score=soln.score)
        soln.mask.cpu()     # synchronize before reading the clock
        soln.t = time.perf_counter() - t0
        self._soln = soln
        return soln

    def _solve_capacity(self, u0: torch.Tensor) -> Solution:
        """Solve through a symmetric-triangle capacity engine: one device
        (ops/symstore.solve_single) or the ranks of ``mesh``
        (solve_sharded_sym), storage built on the device in int8 (f64
        working precision stores f64), no dense (m, m) anywhere. The
        engine rounds NONZERO for Rounding.DSD: :meth:`solve` reruns exact
        DSD on the support."""
        params = self.params
        if params.rounding == Rounding.DSD:
            params = dataclasses.replace(params, rounding=Rounding.NONZERO)
        opts = dict(affinityeps=self.params.affinityeps)
        if self.dtype == torch.float64:
            # reference-parity working precision stores full f64 tiles
            opts["storage_dtype"] = torch.float64
        else:
            opts.update(storage_dtype=torch.int8, probes=16, power_steps=4)
        opts.update(self.engine_opts)
        if self.engine == "sharded":
            return symstore.solve_sharded_sym(
                self.invariant, self._cap["D1"], self._cap["D2"], self._A,
                u0, params, self.mesh, **opts)
        u, F, ifinal = symstore.solve_single(
            self.invariant, self._cap["D1"], self._cap["D2"], self._A, u0,
            params, **opts)
        mask = msrc.round_solution(u, F, params.rounding)
        return Solution(ifinal=ifinal, mask=mask, u0=u0, u=u, score=F)

    def _mask_of(self, nodes, m: int) -> torch.Tensor:
        mask = torch.zeros(m, dtype=torch.bool, device=self.device)
        mask[torch.as_tensor(np.asarray(nodes, np.int64),
                             device=self.device)] = True
        return mask

    def _dsd_mask(self, S: np.ndarray, M_SS, m: int) -> torch.Tensor:
        """The (m,) mask of the exact DSD of the block M_SS = M[S, S] (S
        ascending, so its strict upper triangle is M's restricted to S)."""
        return self._mask_of(S[np.asarray(dsd.solve(M_SS), np.int64)], m)

    def _dsd_dense(self, u: torch.Tensor) -> torch.Tensor:
        """Exact DSD on u's nonzero support S (all vertices when S is
        empty, as in the JAX facade): M[S, S] is gathered on the device
        and only that block goes to the host."""
        m = u.shape[0]
        S = torch.nonzero(u > 0).flatten()
        if S.numel() == 0:
            S = torch.arange(m, device=u.device)
        M_SS = self._M.index_select(0, S).index_select(1, S)
        return self._dsd_mask(S.cpu().numpy(), M_SS, m)

    def _dsd_on_support(self, u: torch.Tensor) -> torch.Tensor:
        """Exact DSD without a dense (m, m) on the capacity path: the flow
        gadget reads only M[S, S] of the nonzero support S (reference:
        src/clipper.cpp:294-300), so that block is rebuilt from the
        invariant on the device and only it goes to the host."""
        m = self._A.shape[0]
        S = torch.nonzero(u > 0).flatten()
        if S.numel() == 0:
            return torch.zeros(m, dtype=torch.bool, device=self.device)
        A_S = self._A[S]
        P1, P2 = gather_endpoints(self._cap["D1"], self._cap["D2"], A_S)
        scores = self.invariant.score_block(P1, P1, P2, P2)
        keep = distinctness_mask(A_S) & (scores > self.params.affinityeps)
        return self._dsd_mask(S.cpu().numpy(),
                              torch.where(keep, scores, 0.0), m)

    def _solve_sparse(self, u0, generator: torch.Generator,
                      multistart: int) -> Solution:
        """Solve over the occupied-tile storage of set_sparse_matrix_data:
        the K restarts as K lanes of one lock-step solve, the objective
        u'(M + I)u polished exactly by a scipy sparse product (int8 tiles
        bias the in-loop F, and omega = round(F) needs it well under 0.5),
        and DSD on the scipy block M[S, S]."""
        m = self._bs_info["m"]
        t0 = time.perf_counter()
        if u0 is not None:
            u0s = self._tensor(u0)[None]
        else:
            u0s = torch.stack([utils.randvec(generator, m, dtype=self.dtype,
                                             device=self.device)
                               for _ in range(max(1, int(multistart)))])
        us, Fs, ifinals = blocksparse.solve_prepared_multi(
            self._bs, self._bs_info, u0s, self.params, power_steps=4)
        us_np = us.cpu().numpy().astype(np.float64)
        Fps = [float(un @ (self._M_sparse @ un) + un @ un) for un in us_np]
        best = int(np.argmax(Fps))
        u_np, Fp = us_np[best], Fps[best]
        u = self._tensor(u_np)
        if self.params.rounding == Rounding.DSD:
            S = np.flatnonzero(u_np > 0)
            mask = self._dsd_mask(S, self._M_sparse[np.ix_(S, S)].toarray(),
                                  m)
        else:
            mask = msrc.round_solution(u, self._tensor(Fp),
                                       self.params.rounding)
        soln = Solution(ifinal=ifinals[best], mask=mask, u0=u0s[best], u=u,
                        score=self._tensor(Fp))
        soln.mask.cpu()     # synchronize before reading the clock
        soln.t = time.perf_counter() - t0
        self._soln = soln
        return soln

    def solve_as_maximum_clique(self, params=None) -> Solution:
        """The exact (or heuristic, or k-core) maximum clique of C
        (reference: src/clipper.cpp:82-97) by the host solver; score -1
        and ifinal 0, as in the reference. C is densified for it on the
        capacity and sparse paths (the solver works on a bitset
        adjacency)."""
        self._require_matrices()
        m = self._m()
        if self._cap is not None:
            C = self._densify_cap()[1]
        elif self._C is not None:
            C = self._C
        else:
            C = self._C_sparse.toarray()
        t0 = time.perf_counter()
        nodes = maxclique.solve(C, params or maxclique.Params())
        t = time.perf_counter() - t0
        zeros = torch.zeros(m, dtype=self.dtype, device=self.device)
        self._soln = Solution(
            ifinal=torch.tensor(0, dtype=torch.int32, device=self.device),
            mask=self._mask_of(nodes, m), u0=zeros, u=zeros.clone(),
            score=self._tensor(-1.0), t=t)
        return self._soln

    def solve_as_msrc_sdr(self, params=None) -> Solution:
        """Solve the MSRC semidefinite relaxation (reference:
        src/clipper.cpp:101-113, src/sdp.cpp:88-303) by the ADMM of
        solvers/sdp.py on ``self.device``; the selected nodes become the
        mask, with score -1 and ifinal 0 as in the JAX facade."""
        self._require_matrices()
        m = self._m()
        M = self.get_affinity_matrix()
        C = self.get_constraint_matrix()
        t0 = time.perf_counter()
        sdp_soln = sdp.solve(M, C, params or sdp.Params(), device=self.device)
        t = time.perf_counter() - t0
        zeros = torch.zeros(m, dtype=self.dtype, device=self.device)
        self._soln = Solution(
            ifinal=torch.tensor(0, dtype=torch.int32, device=self.device),
            mask=self._mask_of(sdp_soln.nodes, m), u0=zeros, u=zeros.clone(),
            score=self._tensor(-1.0), t=t)
        return self._soln

    @staticmethod
    def solve_as_msrc_sdr_batched(Ms, Cs, params=None, *,
                                  device="cuda") -> list:
        """Batched MSRC-SDR over (B, m, m) stacked affinity/constraint
        matrices (identity diagonal, as get_affinity_matrix returns), all B
        relaxations in one lock-step loop, each certified in f64 (an
        extension: the reference's SCS path is one problem a call). Returns
        a list of B ``sdp.Solution``."""
        return sdp.solve_batched(Ms, Cs, params or sdp.Params(),
                                 device=device)

    # ------------------------------------------------------------------
    # accessors (reference: src/clipper.cpp:117-166)
    # ------------------------------------------------------------------

    def get_solution(self) -> Solution:
        return self._soln

    def get_initial_associations(self) -> np.ndarray:
        return self._A.cpu().numpy()

    def get_selected_associations(self) -> np.ndarray:
        """reference: src/clipper.cpp:124-127."""
        return utils.select_inlier_associations(self._soln, self._A)

    def get_affinity_matrix(self) -> torch.Tensor:
        """Symmetric M with identity diagonal (reference:
        src/clipper.cpp:131-136); the capacity and sparse paths densify
        on demand (solve() itself never does)."""
        self._require_matrices()
        if self._cap is not None:
            M = self._densify_cap()[0]
        elif self._M is None:
            M = self._tensor(self._M_sparse.toarray())
        else:
            M = self._M
        return M + torch.eye(M.shape[0], dtype=M.dtype, device=M.device)

    def get_constraint_matrix(self) -> torch.Tensor:
        """Symmetric C with identity diagonal (reference:
        src/clipper.cpp:140-145); densified on demand as M is."""
        self._require_matrices()
        if self._cap is not None:
            C = self._densify_cap()[1]
        elif self._C is None:
            C = self._tensor(self._C_sparse.toarray())
        else:
            C = self._C
        return C + torch.eye(C.shape[0], dtype=C.dtype, device=C.device)

    def set_matrix_data(self, M, C, A=None) -> None:
        """Inject dense affinity/constraint matrices. The reference keeps
        the strict upper triangle (src/clipper.cpp:149-158); the full
        symmetric zero-diagonal form is stored here."""
        Mu = torch.triu(self._tensor(M), diagonal=1)
        Cu = torch.triu(self._tensor(C), diagonal=1)
        self._M = Mu + Mu.T
        self._C = Cu + Cu.T
        self._cap = None
        self._clear_sparse()
        if A is not None:
            self._A = as_association(A, device=self.device)

    def set_sparse_matrix_data(self, M, C, A=None, *, tile: int = 128,
                               max_occupancy: float = 0.5,
                               storage_dtype=None) -> None:
        """Inject upper-triangular (no diagonal) sparse or dense matrices
        (reference: src/clipper.cpp:162-166).

        scipy.sparse input stays sparse: it is symmetrized sparsely and
        stored as occupied tiles on the device (ops/blocksparse.from_scipy),
        and :meth:`solve` runs over the tiles with no dense (m, m)
        (reference: include/clipper/clipper.h:139-143). Above
        ``max_occupancy`` the tiles save nothing and the matrices take the
        dense path, as does dense input. storage_dtype: the tiles' dtype
        (default int8 in f32 working precision, f64 in f64)."""
        import scipy.sparse as sp

        if not sp.issparse(M):
            M, C = _host(M), _host(C)
            self.set_matrix_data(M + M.T, C + C.T, A)
            return
        M = sp.triu(sp.csr_matrix(M), k=1)
        C = sp.triu(sp.csr_matrix(C), k=1)
        M_sym = (M + M.T).tocsr()
        C_sym = (C + C.T).tocsr()
        if storage_dtype is None:
            storage_dtype = (torch.float64 if self.dtype == torch.float64
                             else torch.int8)
        bs, info = blocksparse.from_scipy(
            M_sym, C_sym, tile=tile, storage_dtype=storage_dtype,
            max_occupancy=max_occupancy, device=self.device)
        if bs is None:
            self.set_matrix_data(M_sym.toarray(), C_sym.toarray(), A)
            return
        self._M_sparse, self._C_sparse = M_sym, C_sym
        self._bs, self._bs_info = bs, info
        self._M = self._C = None
        self._cap = None
        if A is not None:
            self._A = as_association(A, device=self.device)

    def set_parallelize(self, parallelize: bool) -> None:
        """No-op, kept for API parity (reference:
        include/clipper/clipper.h:148): the build is data-parallel on the
        device."""

    # ------------------------------------------------------------------

    def _densify_cap(self):
        """Dense (M, C) rebuilt on demand for the matrix accessors on the
        capacity path, refused past m = 16384: the capacity engine exists
        to avoid a dense (m, m)."""
        m = self._A.shape[0]
        if m > _DENSIFY_CAP:
            raise RuntimeError(
                f"get_*_matrix would materialize a dense ({m}, {m}); the "
                "capacity engine exists to avoid exactly that; use "
                "get_selected_associations / the Solution instead")
        M, C, _ = build_affinity(self.invariant, self._cap["D1"],
                                 self._cap["D2"], self._A,
                                 affinityeps=self.params.affinityeps,
                                 dtype=self.dtype)
        return M, C

    def _m(self) -> int:
        if self._M is not None:
            return self._M.shape[0]
        if self._cap is not None:
            return self._A.shape[0]
        return self._bs_info["m"]

    def _clear_sparse(self):
        self._M_sparse = self._C_sparse = None
        self._bs = self._bs_info = None

    def _require_matrices(self):
        if ((self._M is None or self._C is None) and self._cap is None
                and self._bs_info is None):
            raise RuntimeError(
                "no affinity/constraint matrices; call "
                "score_pairwise_consistency or set_matrix_data first")


def _host(X) -> np.ndarray:
    """A dense host array of scipy, tensor or array-like input."""
    if hasattr(X, "toarray"):
        return np.asarray(X.toarray())
    if isinstance(X, torch.Tensor):
        return X.cpu().numpy()
    return np.asarray(X)


# API-parity alias matching the reference class name.
CLIPPER = Clipper
