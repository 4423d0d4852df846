"""Batched multi-start fitting engine (Sec 4.3's fit, as a hot path): a
copy of ``repro.core.fitting`` (``FitRequest``, ``FitStats``,
``fit_batch``), held to the reference's outputs on fixed inputs by
``tests/test_torch_perfmodel.py``.

Rubick's premise is a continuously reconfigured cluster steered by an
always-calibrated performance model: the online loop refits model types
whenever prediction drifts, so fitting runs *during* scheduling, not
once at profiling time.  The scipy reference path
(``perfmodel.fit(engine="scalar")``) makes every refit 3 serial
Nelder-Mead runs whose each step is one Python-level loss call — at
fleet scale the refits cost more wall-clock than the scheduling they
steer.

This engine keeps Nelder-Mead (same direct search, same scipy update
rules and initial-simplex construction, same sigmoid reparametrization
of the Table-1 bounds) but steps **all restarts of all pending fits as
one batched simplex tensor**:

  * every candidate vertex of every simplex lands in one ``(K, 7)``
    parameter matrix per fit, evaluated against the fit's sample columns
    in a single ``titer_from_statics`` pass (the k-independent parts of
    Eq. 1 are precomputed once per request);
  * per-simplex convergence masks freeze finished restarts (scipy's
    fatol/xatol criterion) while the rest keep stepping;
  * an RMSLE-plateau early stop replaces the fixed iteration budget:
    when a simplex's best loss has not improved for ``plateau_iters``
    iterations it is done — warm-started refits converge in a small
    fraction of the 3000-iteration reference budget.

Because the best vertex is never discarded and the warm start ``x0`` is
a vertex of restart 0, ``loss(result) ≤ loss(x0)`` always — the
``rmsle_after ≤ rmsle_before`` guarantee ``CalibrationManager`` publishes
is preserved by construction.  The reference's ``tests/test_fitting.py``
states batched ≤ scalar window RMSLE (within 1e-6) as a property; fresh
draws have falsified it (ROADMAP, Quirks), and this copy keeps the
reference's behaviour, fault included.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.perfmodel import (_BOUNDS, Env, FitParams, ModelProfile,
                                  TiterStatics, sample_arrays,
                                  titer_from_statics, titer_statics)

_LO = np.array([b[0] for b in _BOUNDS])
_HI = np.array([b[1] for b in _BOUNDS])

# scipy Nelder-Mead constants (standard, non-adaptive coefficients and
# the default initial-simplex perturbations) — shared so the batched
# search walks the same trajectory as the scalar reference
_RHO, _CHI, _PSI, _SIGMA = 1.0, 2.0, 0.5, 0.5
_NONZDELT, _ZDELT = 0.05, 0.00025
_N = 7                                    # parameter dimension


def _from_z(z: np.ndarray) -> np.ndarray:
    """Unbounded z-space → bounded parameter space (rows are vectors).
    The clip keeps exp() in range; beyond ±40 the sigmoid is saturated
    at the bound to double precision anyway."""
    return _LO + (_HI - _LO) / (1.0 + np.exp(-np.clip(z, -40.0, 40.0)))


def _to_z(x: np.ndarray) -> np.ndarray:
    """Bounded parameter vector → z-space (the scalar path's transform)."""
    return -np.log(np.clip((_HI - _LO) / np.clip(x - _LO, 1e-12, None)
                           - 1.0, 1e-9, 1e9))


@dataclass(frozen=True)
class FitRequest:
    """One pending fit: a model type's sample window + warm start."""
    profile: ModelProfile
    samples: tuple                # ((plan, alloc, measured T_iter), ...)
    env: Env
    x0: FitParams | None = None


@dataclass
class FitStats:
    """Accumulated engine cost, for auditing refit overhead in benches
    (``bench_calibration`` reports these as ``fit_s_on``/``n_fit_iters``
    instead of burying fit time inside simulation wall-clock)."""
    seconds: float = 0.0
    iters: int = 0                # batched NM iterations (all fits of a
                                  # call step together: one iteration
                                  # advances every live simplex)
    evals: int = 0                # candidate parameter vectors evaluated
    n_fits: int = 0
    n_calls: int = 0


@dataclass
class _FitData:
    """Per-request evaluation state: precomputed sample statics + loss."""
    statics: TiterStatics
    log_true: np.ndarray

    def loss(self, z_rows: np.ndarray) -> np.ndarray:
        """Window RMSLE per z-space row — one batched predictor pass
        evaluates all rows × all samples (matches the scalar engine's
        loss: non-finite predictions drop out per row; 1e6 when a row
        has no finite prediction at all).

        Shapes:
            z_rows: (R, 7) sigmoid-space candidate rows
            returns: (R,) RMSLE per row over this fit's samples
        """
        pred = titer_from_statics(self.statics, _from_z(z_rows))
        ok = np.isfinite(pred)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            lp = np.log(np.maximum(np.where(ok, pred, 1.0), 1e-9))
            sq = np.where(ok, np.square(lp - self.log_true), 0.0)
            cnt = ok.sum(axis=1)
            out = np.sqrt(sq.sum(axis=1) / cnt)
        return np.where(cnt == 0, 1e6, out)


def _prepare(req: FitRequest) -> _FitData:
    env = req.env or Env()
    cols, a_gpus, a_cpus, a_node, true = sample_arrays(req.samples, env)
    return _FitData(
        statics=titer_statics(req.profile, cols, a_gpus, a_cpus, env,
                              per_node=a_node),
        log_true=np.log(np.maximum(true, 1e-9)))


def fit_batch(requests: list[FitRequest], *, n_restarts: int = 3,
              maxiter: int = 3000, fatol: float = 1e-7, xatol: float = 1e-7,
              plateau_iters: int = 40, plateau_tol: float = 1e-9,
              dominated_margin: float = 1e-4, dominated_after: int = 30,
              stats: FitStats | None = None) -> list[FitParams]:
    """Fit every request's 7-tuple in one vectorized multi-start search.

    All ``len(requests) × n_restarts`` simplices advance together: each
    iteration gathers the live simplices' candidate points into per-fit
    (K, 7) parameter matrices and scores them in one batched pass each.
    Restart starts replicate the scalar engine's (``z0`` warm start, then
    seeded unit-normal perturbations), so both engines explore the same
    basins.  Returns one ``FitParams`` per request, in order; results are
    independent of how requests are batched (each fit's simplices only
    ever see their own samples).

    A restart stops on scipy's fatol/xatol criterion, on an RMSLE
    plateau (no improvement > ``plateau_tol`` for ``plateau_iters``
    iterations), or when *dominated*: stuck for ``dominated_after``
    iterations while ``dominated_margin`` behind its fit's best restart.
    Nelder-Mead is a local method — a simplex descending slower than
    plateau_tol per ~30 iterations does not escape its basin, so a
    dominated restart cannot close a 100× parity-bar gap; cutting it
    saves the bulk of warm-refit wall-clock (the warm restart wins
    early, the cold restarts would otherwise grind for hundreds of
    iterations).

    Shapes:
        requests: length-F list of FitRequest
        n_restarts: scalar R (simplices per fit)
        maxiter: scalar iteration cap
        fatol: scalar function-value convergence tolerance
        xatol: scalar simplex-spread convergence tolerance
        plateau_iters: scalar plateau window
        plateau_tol: scalar plateau improvement threshold
        dominated_margin: scalar RMSLE gap for domination
        dominated_after: scalar stuck-iteration threshold
        stats: optional FitStats accumulator (mutated in place)
        returns: length-F list of FitParams, one per request in order
    """
    if not requests:
        return []
    t0 = time.perf_counter()
    n_evals = 0
    data = [_prepare(r) for r in requests]
    F, R = len(requests), n_restarts
    M = F * R
    fidx = np.repeat(np.arange(F), R)         # simplex → owning fit

    def evaluate(z_rows: np.ndarray, rows_fidx: np.ndarray) -> np.ndarray:
        nonlocal n_evals
        n_evals += len(z_rows)
        if F == 1:
            return data[0].loss(z_rows)
        out = np.empty(len(z_rows))
        for i in np.unique(rows_fidx):
            sel = rows_fidx == i
            out[sel] = data[i].loss(z_rows[sel])
        return out

    # --- starts: same construction as the scalar engine ------------------
    starts = np.empty((M, _N))
    for i, req in enumerate(requests):
        z0 = _to_z((req.x0 or FitParams()).as_vector())
        for r in range(R):
            rng = np.random.default_rng(r)
            starts[i * R + r] = z0 + rng.normal(0, 1.0, _N) * (r > 0)

    # --- initial simplices (scipy's default construction) ----------------
    sim = np.repeat(starts[:, None, :], _N + 1, axis=1)
    for k in range(_N):
        col = sim[:, k + 1, k]
        sim[:, k + 1, k] = np.where(col != 0.0, (1.0 + _NONZDELT) * col,
                                    _ZDELT)
    fsim = evaluate(sim.reshape(M * (_N + 1), _N),
                    np.repeat(fidx, _N + 1)).reshape(M, _N + 1)
    order = np.argsort(fsim, axis=1)
    fsim = np.take_along_axis(fsim, order, axis=1)
    sim = np.take_along_axis(sim, order[:, :, None], axis=1)

    active = np.ones(M, bool)
    best = fsim[:, 0].copy()
    since_improve = np.zeros(M, int)
    it = 0
    while it < maxiter and active.any():
        # convergence (scipy's fatol/xatol criterion) + RMSLE plateau
        xspread = np.abs(sim[:, 1:] - sim[:, :1]).max(axis=(1, 2))
        fspread = np.abs(fsim[:, 1:] - fsim[:, :1]).max(axis=1)
        improved = fsim[:, 0] < best - plateau_tol
        since_improve = np.where(improved, 0, since_improve + 1)
        best = np.minimum(best, fsim[:, 0])
        active &= ~((xspread <= xatol) & (fspread <= fatol))
        active &= since_improve < plateau_iters
        fit_best = np.repeat(best.reshape(F, R).min(axis=1), R)
        active &= ~((best > fit_best + dominated_margin)
                    & (since_improve >= dominated_after))
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        it += 1

        s, fs = sim[idx], fsim[idx]
        xbar = s[:, :-1].sum(axis=1) / _N
        worst = s[:, -1]
        xr = (1.0 + _RHO) * xbar - _RHO * worst
        fxr = evaluate(xr, fidx[idx])

        f0, fsecond, fworst = fs[:, 0], fs[:, -2], fs[:, -1]
        expand = fxr < f0
        accept_r = (~expand) & (fxr < fsecond)
        cout = (~expand) & (~accept_r) & (fxr < fworst)
        cin = (~expand) & (~accept_r) & (~cout)

        # one secondary point per simplex that needs it (xe / xc / xcc)
        second = np.where(
            expand[:, None],
            (1.0 + _RHO * _CHI) * xbar - _RHO * _CHI * worst,
            np.where(cout[:, None],
                     (1.0 + _PSI * _RHO) * xbar - _PSI * _RHO * worst,
                     (1.0 - _PSI) * xbar + _PSI * worst))
        need2 = ~accept_r
        fsec = np.full(idx.size, np.inf)
        if need2.any():
            fsec[need2] = evaluate(second[need2], fidx[idx][need2])

        new_worst = s[:, -1].copy()
        new_fworst = fs[:, -1].copy()
        shrink = np.zeros(idx.size, bool)
        # expansion: keep the better of xe / xr
        e_take_xe = expand & (fsec < fxr)
        e_take_xr = expand & ~e_take_xe
        # outside contraction accepts when fxc <= fxr, else shrink
        c_take = cout & (fsec <= fxr)
        shrink |= cout & ~c_take
        # inside contraction accepts when fxcc < fworst, else shrink
        cc_take = cin & (fsec < fworst)
        shrink |= cin & ~cc_take

        take_second = e_take_xe | c_take | cc_take
        take_xr = e_take_xr | accept_r
        new_worst[take_second] = second[take_second]
        new_fworst[take_second] = fsec[take_second]
        new_worst[take_xr] = xr[take_xr]
        new_fworst[take_xr] = fxr[take_xr]
        s[:, -1] = new_worst
        fs[:, -1] = new_fworst

        if shrink.any():
            sh = np.flatnonzero(shrink)
            s[sh, 1:] = s[sh, :1] + _SIGMA * (s[sh, 1:] - s[sh, :1])
            fs[sh, 1:] = evaluate(
                s[sh, 1:].reshape(sh.size * _N, _N),
                np.repeat(fidx[idx][sh], _N)).reshape(sh.size, _N)

        order = np.argsort(fs, axis=1)
        fsim[idx] = np.take_along_axis(fs, order, axis=1)
        sim[idx] = np.take_along_axis(s, order[:, :, None], axis=1)

    # best vertex across each fit's restarts (restart 0 starts AT x0 and
    # the best vertex only ever improves, so loss(result) ≤ loss(x0))
    per_fit = fsim[:, 0].reshape(F, R)
    pick = np.argmin(per_fit, axis=1)
    out = [FitParams.from_vector(_from_z(sim[i * R + pick[i], 0]))
           for i in range(F)]
    if stats is not None:
        stats.seconds += time.perf_counter() - t0
        stats.iters += it
        stats.evals += n_evals
        stats.n_fits += F
        stats.n_calls += 1
    return out
