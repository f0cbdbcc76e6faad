"""The pair solver: one working pair per iteration, on the device.

The port of `tpusvm/solver/smo.py`. Each iteration, step for step as the
JAX `_body`:
  1. the Keerthi index sets; i_high = first argmin of f over I_high,
     i_low = first argmax over I_low; b_high, b_low from them;
  2. the stop check b_low <= b_high + 2 tau;
  3. the K-row refresh: the rows of i_high and i_low are recomputed only
     for an index that changed since the last update (the JAX package's
     lax.cond, here the `need` flags of the pair_rows kernel);
  4. the analytic pair update (solver/analytic.py) in the accumulator
     dtype, the f update with the two rows, and the alpha update;
  5. the status, in the reference's order: NO_WORKING_SET, CONVERGED,
     INFEASIBLE_UV, NONPOS_ETA, STALLED, MAX_ITER.

PyTorch has no device-side while loop, so the loop runs in chunks of
`chunk` iterations and the host reads the statuses once a chunk. Every
step is predicated on its problem's status being RUNNING, so the steps
after termination change nothing and any chunk size gives the
one-iteration-at-a-time loop's alpha, f, n_iter and status bit for bit.
On the card one chunk is captured as a CUDA graph after an eager first
chunk and replayed: no host round trip inside a chunk.

The state carries a leading problem axis: `smo_solve_batched` runs K
problems over one X in lockstep (the one-vs-rest heads), each predicated
on its own status, with one pair_rows launch a step refreshing all 2K
rows. Every operation acts on each problem's row alone, so a head's
trajectory in the batched run is its solo run's bit for bit.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tpusvm_torch import kernels
from tpusvm_torch.device import resolve_device
from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel, replay
from tpusvm_torch.ops.rbf import sq_norms
from tpusvm_torch.ops.selection import masked_argmax, masked_argmin
from tpusvm_torch.solver.analytic import pair_update
from tpusvm_torch.status import Status

# iterations a chunk: a captured graph of this many steps, one status read
# each (PERF.md section 6: chunk sizes timed on the card, 32 fastest)
DEFAULT_CHUNK = 32


@dataclasses.dataclass
class SMOResult:
    """The JAX SMOResult fields, and host-side telemetry of this run."""

    alpha: torch.Tensor   # (n,) accum dtype; padded rows exactly 0
    b: float              # (b_high + b_low) / 2
    b_high: float
    b_low: float
    n_iter: int           # updates + 1 (the reference's count)
    status: Status
    row_refreshes: int    # iterations that recomputed at least one K row
    host_syncs: int       # host reads of device state: one a chunk, +1
    host_wait_s: float    # host seconds blocked at those reads
    chunks: int           # chunks run (the first eager, the rest replayed)
    chunk: int            # iterations a chunk
    graphed: bool         # whether the chunks after the first were a graph


@dataclasses.dataclass
class BatchedSMOResult:
    """K lockstep problems: per-problem tensors on the host, shared
    counters."""

    alpha: torch.Tensor         # (K, n)
    b: torch.Tensor             # (K,)
    b_high: torch.Tensor
    b_low: torch.Tensor
    n_iter: torch.Tensor        # (K,) int64
    status: torch.Tensor        # (K,) int32
    row_refreshes: torch.Tensor  # (K,) int64
    host_syncs: int
    host_wait_s: float
    chunks: int
    chunk: int
    graphed: bool

    def head(self, k: int) -> SMOResult:
        return SMOResult(
            alpha=self.alpha[k], b=float(self.b[k]),
            b_high=float(self.b_high[k]), b_low=float(self.b_low[k]),
            n_iter=int(self.n_iter[k]), status=Status(int(self.status[k])),
            row_refreshes=int(self.row_refreshes[k]),
            host_syncs=self.host_syncs, host_wait_s=self.host_wait_s,
            chunks=self.chunks, chunk=self.chunk, graphed=self.graphed)


class _PairState:
    """Static buffers of K lockstep problems and the step that updates
    them in place (so a captured graph replays on the same memory)."""

    def __init__(self, X, Ys, valid, alpha0, f0, *, C, gamma, eps, tau,
                 max_iter, kernel, degree, coef0, sn):
        B, n = Ys.shape
        dev = X.device
        adt = f0.dtype
        self.X, self.Y, self.sn = X, Ys, sn
        # the label halves of the index sets, with the validity mask: the
        # masks are then where(pos, alpha < C - eps, neg & (alpha > eps))
        # and its mirror, as ops/selection.py defines them
        self.pos = (Ys == 1) & valid
        self.neg = (Ys == -1) & valid
        self.C, self.eps, self.tau, self.max_iter = C, eps, tau, max_iter
        self.kernel, self.gamma, self.coef0 = kernel, gamma, coef0
        self.degree = degree
        # C as a device scalar of the accumulator dtype: pair_update's
        # as_tensor then makes no host-to-device copy inside a capture
        self.C_t = torch.tensor(C, dtype=adt, device=dev)
        self.alpha = alpha0.clone()
        self.f = f0.clone()
        self.rows = torch.zeros(2 * B, n, dtype=X.dtype, device=dev)
        self.prev = torch.full((B, 2), n, dtype=torch.int64, device=dev)
        nan = float("nan")
        self.b_high = torch.full((B,), nan, dtype=adt, device=dev)
        self.b_low = torch.full((B,), nan, dtype=adt, device=dev)
        self.n_iter = torch.ones(B, dtype=torch.int64, device=dev)
        self.status = torch.full((B,), int(Status.RUNNING), dtype=torch.int32,
                                 device=dev)
        self.refreshes = torch.zeros(B, dtype=torch.int64, device=dev)

    def step(self) -> None:
        alpha, f, Y = self.alpha, self.f, self.Y
        C, eps = self.C, self.eps
        adt = f.dtype
        B, n = Y.shape
        live = self.status == Status.RUNNING
        below = alpha < C - eps
        above = alpha > eps
        m_high = torch.where(self.pos, below, self.neg & above)
        m_low = torch.where(self.pos, above, self.neg & below)
        i_high, found_h = masked_argmin(f, m_high, dim=1)
        i_low, found_l = masked_argmax(f, m_low, dim=1)
        found = found_h & found_l
        pair = torch.stack([i_high, i_low], dim=1)           # (B, 2)
        ih, il = pair[:, :1], pair[:, 1:]
        take = (live & found)[:, None]
        b_pair = torch.where(take, f.gather(1, pair),
                             torch.stack([self.b_high, self.b_low], dim=1))
        self.b_high.copy_(b_pair[:, 0])
        self.b_low.copy_(b_pair[:, 1])
        b_high, b_low = self.b_high, self.b_low
        converged = found & (b_low <= b_high + 2.0 * self.tau)
        proceed = live & found & ~converged

        # the K-row refresh, only for an index that changed; the kernel
        # reads `need` on the device and skips the X pass when it is clear
        need = proceed[:, None] & (pair != self.prev)
        pair_rows_kernel(self.X, pair.reshape(-1), need.reshape(-1),
                         self.rows, family=self.kernel, gamma=self.gamma,
                         coef0=self.coef0, degree=self.degree, sn=self.sn)
        self.refreshes.add_(need.any(dim=1))
        rows = self.rows.view(B, 2, n)
        k_high, k_low = rows[:, 0], rows[:, 1]

        y_pair = Y.gather(1, pair).to(adt)
        y_h, y_l = y_pair[:, 0], y_pair[:, 1]
        a_pair = alpha.gather(1, pair)
        # K11 = k_high[i_high], K12 = k_high[i_low], K22 = k_low[i_low]
        kk = rows.gather(2, pair[:, None, :].expand(B, 2, 2)).to(adt)
        upd = pair_update(kk[:, 0, 0], kk[:, 1, 1], kk[:, 0, 1], y_h, y_l,
                          a_pair[:, 0], a_pair[:, 1], b_high, b_low,
                          self.C_t, eps, proceed)

        # the f and alpha updates happen on a live problem's last
        # iteration too (with zero deltas), as in the JAX while loop; a
        # terminated problem's state is left exactly as it is
        f_new = (f + (upd.da_h * y_h)[:, None] * k_high.to(adt)
                 + (upd.da_l * y_l)[:, None] * k_low.to(adt))
        f.copy_(torch.where(live[:, None], f_new, f))
        a_h = alpha.gather(1, ih)[:, 0]
        alpha.scatter_(1, ih, torch.where(live, a_h + upd.da_h, a_h)[:, None])
        a_l = alpha.gather(1, il)[:, 0]
        alpha.scatter_(1, il, torch.where(live, a_l + upd.da_l, a_l)[:, None])

        self.n_iter.add_(upd.do_update)
        status = torch.where(
            ~found, int(Status.NO_WORKING_SET), torch.where(
                converged, int(Status.CONVERGED), torch.where(
                    ~upd.feasible, int(Status.INFEASIBLE_UV), torch.where(
                        ~upd.eta_ok, int(Status.NONPOS_ETA), torch.where(
                            upd.stalled, int(Status.STALLED), torch.where(
                                self.n_iter > self.max_iter,
                                int(Status.MAX_ITER),
                                int(Status.RUNNING)))))))
        self.status.copy_(torch.where(live, status.to(torch.int32),
                                      self.status))
        self.prev.copy_(torch.where(upd.do_update[:, None], pair, self.prev))


def _run(state: _PairState, chunk: int, graph: bool):
    """Run chunks until no problem is RUNNING. Returns (host syncs, host
    seconds blocked, chunks, whether a graph ran)."""
    syncs = chunks = 0
    wait = 0.0
    cuda_graph = None
    while True:
        if cuda_graph is not None:
            replay(cuda_graph, chunk)
        else:
            for _ in range(chunk):
                state.step()
        chunks += 1
        t = time.perf_counter()
        running = bool((state.status == Status.RUNNING).any())
        wait += time.perf_counter() - t
        syncs += 1
        if not running:
            return syncs, wait, chunks, cuda_graph is not None
        if graph and cuda_graph is None:
            # the eager first chunk was the warm-up (the kernel library
            # loaded, its launch attributes set); capture records and does
            # not run, so the state stays where that chunk left it
            torch.cuda.synchronize(state.X.device)
            cuda_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(cuda_graph):
                for _ in range(chunk):
                    state.step()


def _prepare(X, Ys, valid, alpha0, *, warm_start, accum_dtype, kernel,
             degree, coef0, gamma, targets, device):
    kernels.validate_family(kernel)
    if kernels.is_approx(kernel):
        raise NotImplementedError(
            f"kernel={kernel!r}: the approximate-kernel feature maps are not "
            "ported yet (ROADMAP Queue 1 item 10)")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    if dev.type == "cuda" and X.dtype != torch.float32:
        raise ValueError(
            f"the card's K-row kernel takes float32 features, got {X.dtype}")
    X = X.contiguous()
    if X.is_cuda and X.data_ptr() % 16:
        # the K-row kernel streams X with 16-byte bulk copies
        X = X.clone()
    Ys = torch.as_tensor(Ys, device=dev).to(torch.int32)
    B, n = Ys.shape
    adt = X.dtype if accum_dtype is None else accum_dtype
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, device=dev).to(torch.bool))
    zero = torch.zeros((), dtype=adt, device=dev)
    alpha = (torch.zeros(B, n, dtype=adt, device=dev) if alpha0 is None
             else torch.as_tensor(alpha0, device=dev).to(adt).expand(B, n))
    alpha = torch.where(valid, alpha, zero)
    yf = Ys.to(adt)
    z = yf if targets is None else torch.as_tensor(
        targets, device=dev).to(adt).expand(B, n)
    if warm_start:
        kw = dict(gamma=gamma, coef0=coef0, degree=degree)
        f0 = torch.stack([
            kernels.matvec(kernel, X, (alpha[b] * yf[b]).to(X.dtype),
                           **kw).to(adt) for b in range(B)]) - z
    else:
        f0 = -z
    f0 = torch.where(valid, f0, zero)
    sn = sq_norms(X) if kernels.needs_norms(kernel) else None
    return X, Ys, valid, alpha.contiguous(), f0.contiguous(), sn


def _solve(X, Ys, valid, alpha0, *, C, gamma, eps, tau, max_iter,
           warm_start, accum_dtype, kernel, degree, coef0, targets, chunk,
           graph, device) -> BatchedSMOResult:
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    X, Ys, valid, alpha, f0, sn = _prepare(
        X, Ys, valid, alpha0, warm_start=warm_start, accum_dtype=accum_dtype,
        kernel=kernel, degree=degree, coef0=coef0, gamma=gamma,
        targets=targets, device=device)
    if graph == "auto":
        graph = X.is_cuda
    elif graph and not X.is_cuda:
        raise ValueError("graph=True captures a CUDA graph: it needs the card")
    state = _PairState(X, Ys, valid, alpha, f0, C=C, gamma=gamma, eps=eps,
                       tau=tau, max_iter=max_iter, kernel=kernel,
                       degree=degree, coef0=coef0, sn=sn)
    syncs, wait, chunks, graphed = _run(state, chunk, bool(graph))
    t = time.perf_counter()
    out = [state.alpha, state.b_high, state.b_low, state.n_iter,
           state.status, state.refreshes]
    alpha, b_high, b_low, n_iter, status, refreshes = (
        o.cpu() if X.is_cuda else o for o in out)
    wait += time.perf_counter() - t
    return BatchedSMOResult(
        alpha=alpha, b=(b_high + b_low) / 2.0, b_high=b_high, b_low=b_low,
        n_iter=n_iter, status=status, row_refreshes=refreshes,
        host_syncs=syncs + 1, host_wait_s=wait, chunks=chunks, chunk=chunk,
        graphed=graphed)


def smo_solve(
    X,
    Y,
    valid=None,
    alpha0=None,
    *,
    C: float = 10.0,
    gamma: float = 0.00125,
    eps: float = 1e-12,
    tau: float = 1e-5,
    max_iter: int = 100000,
    warm_start: bool = False,
    accum_dtype=None,
    kernel: str = "rbf",
    degree: int = 3,
    coef0: float = 0.0,
    targets=None,
    chunk: int = DEFAULT_CHUNK,
    graph="auto",
    device="cuda",
) -> SMOResult:
    """Run pairwise SMO to termination on `device`.

    X (n, d) features (float32 on the card; any float dtype on the CPU),
    Y (n,) labels in {+1, -1} (padded rows 0), valid (n,) bool mask of
    real rows, alpha0 starting duals (zeros if None) with warm_start=True
    rebuilding f from them. accum_dtype (default: X's dtype) holds alpha,
    f and the pair arithmetic; the K rows stay in X's dtype. kernel,
    degree, coef0: the family. targets: pseudo-targets z replacing the
    labels in f = K(alpha*y) - z (epsilon-SVR). chunk: iterations between
    host status reads. graph: "auto" captures a chunk as a CUDA graph on
    the card (True requires the card, False runs every chunk eagerly).
    Returns SMOResult; `alpha` of padded rows is exactly 0.
    """
    Y = torch.as_tensor(Y)
    res = _solve(X, Y[None], valid, alpha0, C=C, gamma=gamma, eps=eps,
                 tau=tau, max_iter=max_iter, warm_start=warm_start,
                 accum_dtype=accum_dtype, kernel=kernel, degree=degree,
                 coef0=coef0, targets=targets, chunk=chunk, graph=graph,
                 device=device)
    return res.head(0)


def smo_solve_batched(X, Ys, valid=None, *, C: float = 10.0,
                      gamma: float = 0.00125, eps: float = 1e-12,
                      tau: float = 1e-5, max_iter: int = 100000,
                      accum_dtype=None, kernel: str = "rbf", degree: int = 3,
                      coef0: float = 0.0, chunk: int = DEFAULT_CHUNK,
                      graph="auto", device="cuda") -> BatchedSMOResult:
    """K pair solves over one X in lockstep: Ys (K, n) label rows. Each
    problem stops on its own status; the loop ends when none is RUNNING.
    Each problem's result equals smo_solve on its labels bit for bit."""
    Ys = torch.as_tensor(Ys)
    if Ys.ndim != 2:
        raise ValueError(f"Ys must be (K, n), got shape {tuple(Ys.shape)}")
    return _solve(X, Ys, valid, None, C=C, gamma=gamma, eps=eps, tau=tau,
                  max_iter=max_iter, warm_start=False,
                  accum_dtype=accum_dtype, kernel=kernel, degree=degree,
                  coef0=coef0, targets=None, chunk=chunk, graph=graph,
                  device=device)

