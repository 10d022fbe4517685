"""TCMF: temporal-regularized matrix factorization for high-dimensional
forecasting.

Counterpart of ``analytics_zoo_tpu/zouwu/model/tcmf.py`` (ref
``pyzoo/zoo/zouwu/model/forecast/tcmf_forecaster.py`` (API) +
``pyzoo/zoo/zouwu/model/tcmf/DeepGLO.py`` + ``tcmf_model.py``): factor a
panel Y [n_series, T] into F [n, k] @ X [k, T], forecast the small
temporal basis X forward, and emit per-series forecasts F @ X_future,
optionally refined by a local temporal net on the residuals (DeepGLO
hybrid).

- **The factorization** (JAX: one jitted ``fori_loop``) is a loop of
  ``num_steps`` steps over device tensors: the loss ``mean((F @ X - Y)²)
  + lam * (mean(diff(X)²) + mean(F²) + mean(X²))``, its gradients by
  autograd and the port's optax-order Adam (``learn.optimizers.Adam``);
  nothing is read back until the final mse. ``svd=True`` starts from
  numpy's SVD, as JAX does (the same start bit for bit); ``svd=False``
  draws ``0.1 * N(0, 1)`` from a ``torch.Generator`` seeded from
  ``seed`` (JAX's threefry draws differ).
- ``distributed=True`` (XShards input, ``num_workers > 1``): across
  ranks (a process group, ``init_orca_context(cluster_mode=
  "multihost")``; every rank fits the same panel) the series are blocked
  by rows over the ranks, JAX's layout: each rank holds its rows of Y and
  F (the first ``n % ranks`` ranks one row more), X is replicated and its
  gradient summed over the ranks (one ``all_reduce`` a step), and Adam on
  F stays rowwise and local. Each rank's loss terms are scaled so that
  their sum over the ranks is JAX's global ``mse + lam * (smooth + l2)``:
  F's terms divided by the global counts, X's counted once.
  ``fit_report["devices_used"]`` is the number of ranks, and F is
  gathered whole on every rank after the fit. Without a process group it
  runs on a one-device mesh over ``device`` (``devices_used`` 1).
- The basis forecasts (closed-form AR, or the port's ``TCNForecaster``),
  the DeepGLO local TCN, ``fit_incremental``, ``rolling_evaluate``,
  calendar features, covariates, ``val_len`` and save/load (JAX's files:
  ``tcmf_factors.npz``, ``tcmf_config.json``, ``local_tcn``) are JAX's.
- ``device``: ``cuda`` unless the caller passes ``device="cpu"``; without
  CUDA that raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device


def _coerce_panel(x):
    """Reference input contract (tcmf_forecaster.py fit: dict of ndarray
    {"id", "y"} or XShards of such dicts) → (y [n,T] float32, ids or None,
    was_xshards)."""
    from analytics_zoo_tpu_torch.data.shard import XShards

    if isinstance(x, XShards):
        parts = x.collect()
        ys, ids = [], []
        for d in parts:
            assert isinstance(d, dict) and "y" in d, \
                "XShards for TCMF must hold {'id': ..., 'y': ...} dicts"
            ys.append(np.asarray(d["y"], np.float32))
            if d.get("id") is not None:
                ids.append(np.asarray(d["id"]))
        y = np.concatenate(ys, axis=0)
        id_arr = np.concatenate(ids) if len(ids) == len(ys) and ids else None
        return y, id_arr, True
    if isinstance(x, dict) and "y" in x:
        return (np.asarray(x["y"], np.float32),
                np.asarray(x["id"]) if x.get("id") is not None else None,
                False)
    return np.asarray(x, np.float32), None, False


def _time_features(idx) -> np.ndarray:
    """[4, T] calendar regressors from a DatetimeIndex, each normalized
    to [-0.5, 0.5] (the ref's use_time path derives hour/weekday/day/
    month features from dti/start_date+freq for the temporal net)."""
    import pandas as pd
    idx = pd.DatetimeIndex(idx)
    return np.stack([
        idx.hour.to_numpy() / 23.0 - 0.5,
        idx.dayofweek.to_numpy() / 6.0 - 0.5,
        (idx.day.to_numpy() - 1) / 30.0 - 0.5,
        (idx.month.to_numpy() - 1) / 11.0 - 0.5,
    ]).astype(np.float32)


class TCMFForecaster:
    """fit(x) → predict(horizon) (ref tcmf_forecaster.py TCMFForecaster).

    Reference argument names are accepted: ``rank`` (=k),
    ``learning_rate`` (=lr), ``normalize``, ``svd``, ``alt_iters`` /
    ``max_FX_epoch`` (together set the optimization step budget).
    """

    def __init__(self, k: int = 8, lam: float = 1e-3, ar_order: int = 8,
                 lr: float = 0.05, basis_forecaster: str = "ar",
                 use_local: bool = False, local_lookback: int = 16,
                 rank: Optional[int] = None,
                 learning_rate: Optional[float] = None,
                 normalize: bool = False, svd: bool = False,
                 period: Optional[int] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.k = int(rank) if rank is not None else k
        self.lam, self.ar_order = lam, ar_order
        self.lr = learning_rate if learning_rate is not None else lr
        self.basis_forecaster = basis_forecaster
        # DeepGLO hybrid: a local temporal net on the residuals Y - F@X
        # refines the global forecast (ref DeepGLO.py: global MF + local
        # TCN combination)
        self.use_local = use_local
        self.local_lookback = int(local_lookback)
        self.normalize = bool(normalize)       # ref DeepGLO.py:521-528
        self.svd = bool(svd)                   # ref DeepGLO svd init
        self.period = period                   # ref use_time/period
        self.seed = seed
        self.F: Optional[np.ndarray] = None
        self.X: Optional[np.ndarray] = None
        self._local = None
        self._norm = None                      # (mean, std, mini)
        self._covariates = None
        self._time_feats = None                # [4, T] calendar regressors
        self._dti_last = None                  # last training timestamp
        self._dti_freq = None                  # pandas freq string
        self._was_xshards = False
        self.fit_report: dict = {}

    # ------------------------------------------------------------- fit --
    def fit(self, x, num_steps: int = 300, distributed: Optional[bool] = None,
            num_workers: Optional[int] = None, covariates=None,
            val_len: int = 0, **ref_kwargs) -> float:
        """x: [n_series, T] ndarray, {"id","y"} dict, or XShards of dicts
        (ref fit input contract). Returns final reconstruction MSE.

        ``distributed=True`` (implied by XShards input or ``num_workers``)
        blocks the series over the ranks of the process group, or runs on
        a one-device mesh without one (the module docstring). Reference epoch knobs map onto ``num_steps`` as the ref's
        total F/X epoch budget: ``init_FX_epoch + alt_iters *
        max_FX_epoch`` (DeepGLO.py train_all: initial joint fit, then ``alt_iters`` alternating rounds of
        ``max_FX_epoch`` each); ``y_iters``/``max_TCN_epoch`` set the local
        residual net's epochs when ``use_local=True``. ``dti`` (or
        ``start_date``+``freq``) derives calendar regressors
        (hour/weekday/day/month) entering the AR basis design; predict
        extends them into the future automatically. Unknown kwargs
        raise.
        """
        known = {"max_FX_epoch", "init_FX_epoch", "alt_iters", "y_iters",
                 "max_TCN_epoch", "start_date", "freq", "dti", "period"}
        unknown = set(ref_kwargs) - known
        if unknown:
            raise TypeError(f"fit() got unexpected kwargs {sorted(unknown)}")
        if {"max_FX_epoch", "init_FX_epoch", "alt_iters"} & set(ref_kwargs):
            num_steps = (ref_kwargs.get("init_FX_epoch", 0)
                         + ref_kwargs.get("alt_iters", 1)
                         * ref_kwargs.get("max_FX_epoch", 0)) or num_steps
        self._local_epochs = ref_kwargs.get(
            "max_TCN_epoch", ref_kwargs.get("y_iters", 3))
        if ref_kwargs.get("period"):
            self.period = ref_kwargs["period"]
        y, ids, was_xshards = _coerce_panel(x)
        assert y.ndim == 2, f"TCMF expects [n_series, T], got {y.shape}"
        self._ids = ids
        self._was_xshards = was_xshards
        if distributed is None:
            distributed = was_xshards or (num_workers or 0) > 1
        self._covariates = (np.asarray(covariates, np.float32)
                            if covariates is not None else None)

        # dti / start_date+freq → calendar regressors entering the AR
        # basis design (ref DeepGLO use_time: datetime features derived
        # from the index become temporal-net covariates). Future values
        # are deterministic, so predict() extends them automatically.
        # Reset first: a refit without dti must not keep the previous
        # fit's calendar state (misaligned with the new X).
        self._time_feats = self._dti_last = self._dti_freq = None
        dti = ref_kwargs.get("dti")
        if dti is None and ref_kwargs.get("start_date") is not None:
            import pandas as pd
            dti = pd.date_range(ref_kwargs["start_date"],
                                periods=y.shape[1],
                                freq=ref_kwargs.get("freq", "D"))
        if dti is not None:
            import pandas as pd
            dti = pd.DatetimeIndex(dti)
            if len(dti) != y.shape[1]:
                raise ValueError(
                    f"dti length {len(dti)} must match T={y.shape[1]}")
            freq = (dti.freqstr or ref_kwargs.get("freq")
                    or pd.infer_freq(dti))
            if freq is None:
                raise ValueError(
                    "dti has no inferable frequency (irregular index); "
                    "pass freq=... so predict() can extend the calendar "
                    "features correctly")
            self._dti_freq = freq
            self._time_feats = _time_features(dti)
            self._dti_last = dti[-1]

        # ref fit(val_len=24): the last val_len columns are a holdout —
        # split BEFORE normalization (no leakage into the scalers) and
        # trim the covariates to the training window so the AR design
        # stays aligned; the held covariates become the validation
        # forecast's known future regressors
        holdout = hold_cov = None
        if val_len:
            if val_len >= y.shape[1] - 2:
                raise ValueError(
                    f"val_len={val_len} leaves too little history "
                    f"(T={y.shape[1]})")
            holdout = y[:, -val_len:]
            y = y[:, :-val_len]
            if self._covariates is not None:
                if self._covariates.shape[1] != y.shape[1] + val_len:
                    raise ValueError(
                        "covariates must span the same T as the input "
                        "(incl. the val_len window)")
                hold_cov = self._covariates[:, -val_len:]
                self._covariates = self._covariates[:, :-val_len]
            if self._time_feats is not None:
                # predict(val_len) re-derives the holdout stamps from
                # _dti_last + freq, so only the training slice is kept
                self._time_feats = self._time_feats[:, :-val_len]
                self._dti_last = dti[y.shape[1] - 1]

        if self.normalize:
            m = y.mean(axis=1)
            s = y.std(axis=1) + 1e-8
            y = (y - m[:, None]) / s[:, None]
            mini = float(np.abs(y.min()))
            y = y + mini
            self._norm = (m, s, mini)

        mesh = self._mesh() if distributed else None
        mse = self._run_factorization(y, num_steps, mesh)
        if self.use_local:
            self._fit_local(y, epochs=min(getattr(self, "_local_epochs", 3),
                                          10))
        if holdout is not None:
            # score through predict(): the SAME forecaster configuration
            # (basis ar/tcn, DeepGLO local residuals, denormalization,
            # known future covariates) the user will run
            val_pred = self.predict(int(val_len), future_covariates=hold_cov)
            self.fit_report["val_mse"] = float(
                np.mean((val_pred - holdout) ** 2))
        return mse

    def _mesh(self):
        """A 1-D data mesh over the ranks of the process group, or a
        one-device mesh over ``device`` without one."""
        import torch.distributed as dist
        from analytics_zoo_tpu_torch.parallel.mesh import build_mesh
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            return build_mesh(set_default=False)
        return build_mesh(devices=[self.device], set_default=False)

    def _init_factors(self, y: np.ndarray):
        n, t = y.shape
        if self.svd:
            # ref DeepGLO svd=True: seed F/X from the truncated SVD
            u, s, vt = np.linalg.svd(y, full_matrices=False)
            r = min(self.k, s.shape[0])
            f0 = np.zeros((n, self.k), np.float32)
            x0 = np.zeros((self.k, t), np.float32)
            f0[:, :r] = u[:, :r] * np.sqrt(s[:r])
            x0[:r] = np.sqrt(s[:r])[:, None] * vt[:r]
            return f0, x0
        gen = torch.Generator().manual_seed(int(self.seed))
        return ((torch.randn((n, self.k), generator=gen) * 0.1).numpy(),
                (torch.randn((self.k, t), generator=gen) * 0.1).numpy())

    def _run_factorization(self, y: np.ndarray, num_steps: int,
                           mesh) -> float:
        """``num_steps`` Adam steps on the device; one read-back, of the
        final mse."""
        from analytics_zoo_tpu_torch.learn.optimizers import Adam

        n, t = y.shape
        f0, x0 = self._init_factors(y)
        if mesh is not None and mesh.size > 1:
            return self._run_sharded(y, f0, x0, num_steps, mesh)
        dev = self.device
        y_dev = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
        params = [torch.from_numpy(f0).to(dev), torch.from_numpy(x0).to(dev)]
        opt = Adam(learningrate=self.lr)
        state = opt.init(params)
        lam = self.lam
        for step in range(int(num_steps)):
            f, x = (p.detach().requires_grad_(True) for p in params)
            mse = torch.mean((f @ x - y_dev) ** 2)
            # temporal smoothness on the basis + L2 — the reference's
            # temporal regularizer role (DeepGLO TCN-regularized X)
            smooth = torch.mean(torch.diff(x, dim=1) ** 2)
            l2 = torch.mean(f ** 2) + torch.mean(x ** 2)
            grads = torch.autograd.grad(mse + lam * (smooth + l2), (f, x))
            with torch.no_grad():
                opt.step(params, list(grads), state, step)
        with torch.no_grad():
            final_mse = torch.mean((params[0] @ params[1] - y_dev) ** 2)
        self.fit_report = {
            "sharded": mesh is not None,
            "devices_used": int(mesh.devices.size) if mesh is not None
            else 1,
            "n_series": n, "t": t, "num_steps": num_steps,
        }
        self.F = params[0].cpu().numpy()
        self.X = params[1].cpu().numpy()
        return float(final_mse)

    def _run_sharded(self, y: np.ndarray, f0: np.ndarray, x0: np.ndarray,
                     num_steps: int, mesh) -> float:
        """The factorization with the series blocked over the ranks of
        ``mesh`` (the module docstring); the global final mse."""
        from analytics_zoo_tpu_torch.learn.optimizers import Adam
        from analytics_zoo_tpu_torch.parallel import collectives

        n, t = y.shape
        k = f0.shape[1]
        axis = mesh.axis_names[0]
        p, r = mesh.size, mesh.coord(axis)
        counts = [len(b) for b in np.array_split(np.arange(n), p)]
        lo = sum(counts[:r])
        hi = lo + counts[r]
        dev = self.device
        y_dev = torch.from_numpy(np.ascontiguousarray(y[lo:hi])).to(dev)
        params = [torch.from_numpy(np.ascontiguousarray(f0[lo:hi])).to(dev),
                  torch.from_numpy(np.ascontiguousarray(x0)).to(dev)]
        opt = Adam(learningrate=self.lr)
        state = opt.init(params)
        lam = self.lam
        for step in range(int(num_steps)):
            f, x = (q.detach().requires_grad_(True) for q in params)
            # this rank's share of each global mean; X's terms once over
            # the ranks
            mse = torch.sum((f @ x - y_dev) ** 2) / (n * t)
            smooth = torch.mean(torch.diff(x, dim=1) ** 2) / p
            l2 = torch.sum(f ** 2) / (n * k) + torch.mean(x ** 2) / p
            gf, gx = torch.autograd.grad(mse + lam * (smooth + l2), (f, x))
            collectives.all_reduce_(gx, mesh, (axis,))
            with torch.no_grad():
                opt.step(params, [gf, gx], state, step)
        with torch.no_grad():
            sq = torch.sum((params[0] @ params[1] - y_dev) ** 2).reshape(1)
            collectives.all_reduce_(sq, mesh, (axis,))
            final_mse = sq[0] / (n * t)
            # F whole on every rank: the blocks padded to the largest
            pad = torch.zeros((max(counts), k), dtype=params[0].dtype,
                              device=dev)
            pad[:counts[r]] = params[0]
            blocks = collectives.all_gather(pad, mesh, axis, 0)
            whole = torch.cat([blocks[i * max(counts):i * max(counts) + c]
                               for i, c in enumerate(counts)])
        self.fit_report = {"sharded": True, "devices_used": int(p),
                           "n_series": n, "t": t, "num_steps": num_steps}
        self.F = whole.cpu().numpy()
        self.X = params[1].cpu().numpy()
        return float(final_mse)

    # ---- DeepGLO hybrid local model over residuals ----
    def _fit_local(self, y: np.ndarray, epochs: int = 3):
        """Train a TCN on residual windows pooled across series (ref
        DeepGLO's local network refining the global factorization)."""
        from analytics_zoo_tpu_torch.zouwu.model.forecast import TCNForecaster

        resid = y - self.F @ self.X                       # [n, T]
        p = min(self.local_lookback, resid.shape[1] - 2)
        if p < 2:
            self._local = None
            return
        xs, ys = [], []
        for row in resid:
            # window starts 0..T-p-1 inclusive: the final window targets
            # row[T-1], the freshest residual the TCN must extrapolate
            for s in range(0, len(row) - p, max(1, p // 4)):
                xs.append(row[s:s + p, None])
                ys.append(row[s + p:s + p + 1])
        self._local = TCNForecaster(future_seq_len=1,
                                    num_channels=(16, 16), kernel_size=3,
                                    device=self.device)
        self._local.fit(np.asarray(xs, np.float32),
                        np.asarray(ys, np.float32), epochs=epochs,
                        batch_size=min(64, len(xs)))
        self._resid_hist = resid

    def _local_forecast(self, horizon: int) -> np.ndarray:
        """Roll the residual TCN forward per series — [n, horizon]."""
        if self._local is None:
            return 0.0
        p = min(self.local_lookback, self._resid_hist.shape[1] - 2)
        hist = self._resid_hist[:, -p:].astype(np.float32)  # [n, p]
        outs = []
        for _ in range(horizon):
            nxt = self._local.predict(hist[..., None])      # [n, 1]
            nxt = np.asarray(nxt).reshape(-1, 1)
            outs.append(nxt)
            hist = np.concatenate([hist[:, 1:], nxt], axis=1)
        return np.concatenate(outs, axis=1)

    # ----------------------------------------------------- incremental --
    def fit_incremental(self, x_incr, covariates_incr=None) -> None:
        """Extend the temporal basis for new observations with F FIXED:
        each new column solves the ridge system
        ``(FᵀF + λI) x_t = Fᵀ y_t`` in closed form
        (ref tcmf_forecaster.fit_incremental: update X on incoming data
        without re-factorizing). Accepts the same input formats as fit."""
        if self.F is None:
            raise RuntimeError("call fit first")
        y_new, _, _ = _coerce_panel(x_incr)
        if y_new.ndim != 2 or y_new.shape[0] != self.F.shape[0]:
            raise ValueError(
                f"x_incr must be [n_series={self.F.shape[0]}, t_new], "
                f"got {y_new.shape}")
        if self._covariates is not None:
            if covariates_incr is None:
                raise ValueError(
                    "the model was fit with covariates: fit_incremental "
                    "needs covariates_incr [r, t_new] to keep the basis "
                    "design aligned (ref fit_incremental covariates_incr)")
            cov_incr = np.asarray(covariates_incr, np.float32)
            if cov_incr.shape != (self._covariates.shape[0], y_new.shape[1]):
                raise ValueError(
                    f"covariates_incr must be "
                    f"[{self._covariates.shape[0]}, {y_new.shape[1]}], "
                    f"got {cov_incr.shape}")
            self._covariates = np.concatenate(
                [self._covariates, cov_incr], axis=1)
        if self._time_feats is not None:
            import pandas as pd
            new_idx = pd.date_range(self._dti_last,
                                    periods=y_new.shape[1] + 1,
                                    freq=self._dti_freq)[1:]
            self._time_feats = np.concatenate(
                [self._time_feats, _time_features(new_idx)], axis=1)
            self._dti_last = new_idx[-1]
        if self._norm is not None:
            m, s, mini = self._norm
            y_new = (y_new - m[:, None]) / s[:, None] + mini
        g = self.F.T @ self.F + self.lam * np.eye(self.k, dtype=np.float32)
        x_new = np.linalg.solve(g, self.F.T @ y_new)      # [k, t_new]
        self.X = np.concatenate([self.X, x_new], axis=1)
        if self.use_local and self._local is not None:
            resid = y_new - self.F @ x_new
            self._resid_hist = np.concatenate([self._resid_hist, resid],
                                              axis=1)

    # -------------------------------------------------------- forecast --
    def _basis_design(self, row: np.ndarray, p: int, per: Optional[int]):
        """AR design for one factor row: p lags, optional seasonal
        lag-``per`` regressor and external covariate rows (the ref's
        use_time/period/covariates entering the temporal net). Targets
        start at ``max(p, per)`` so every regressor index is in range."""
        t = len(row)
        start = max(p, per or 0)
        cols = [row[start - lag:t - lag] for lag in range(p, 0, -1)]
        if per:
            cols.append(row[start - per:t - per])
        if self._covariates is not None:
            for cov in self._covariates:
                cols.append(cov[start:t])
        if self._time_feats is not None:
            for tf in self._time_feats:
                cols.append(tf[start:t])
        cols.append(np.ones(t - start))
        return np.stack(cols, 1), row[start:]

    def _forecast_basis_ar(self, horizon: int,
                           future_covariates=None) -> np.ndarray:
        """Closed-form AR(p) (+ seasonal/covariate regressors) per factor
        row, rolled forward ``horizon``. ``future_covariates`` [r, horizon]
        supplies the known future regressor values (ref
        predict(future_covariates=...)); without them the last historical
        value is held."""
        t = self.X.shape[1]
        p = min(self.ar_order, t - 1)
        per = self.period if self.period and max(p, self.period) < t - 1 \
            else None
        if future_covariates is not None:
            fc = np.asarray(future_covariates, np.float32)
            if self._covariates is None:
                raise ValueError("future_covariates given but the model "
                                 "was fit without covariates")
            if fc.shape != (self._covariates.shape[0], horizon):
                raise ValueError(
                    f"future_covariates must be "
                    f"[{self._covariates.shape[0]}, {horizon}], "
                    f"got {fc.shape}")
        else:
            fc = None
        ftf = None
        if self._time_feats is not None:
            import pandas as pd
            future_idx = pd.date_range(self._dti_last,
                                       periods=horizon + 1,
                                       freq=self._dti_freq)[1:]
            ftf = _time_features(future_idx)
        futures = []
        for row in self.X:
            design, target = self._basis_design(row, p, per)
            coef, *_ = np.linalg.lstsq(design, target, rcond=None)
            hist = list(row)
            out = []
            for h in range(horizon):
                feats = list(hist[-p:])
                if per:
                    feats.append(hist[-per])
                if self._covariates is not None:
                    if fc is not None:
                        feats.extend(fc[:, h])
                    else:  # future values unknown: hold last observed
                        feats.extend(c[-1] for c in self._covariates)
                if ftf is not None:
                    feats.extend(ftf[:, h])
                feats.append(1.0)
                nxt = float(np.dot(coef, feats))
                out.append(nxt)
                hist.append(nxt)
            futures.append(out)
        return np.asarray(futures, np.float32)          # [k, horizon]

    def _forecast_basis_tcn(self, horizon: int) -> np.ndarray:
        from analytics_zoo_tpu_torch.zouwu.model.forecast import TCNForecaster
        p = min(max(self.ar_order * 2, 8), self.X.shape[1] - horizon)
        if p < 1:
            raise ValueError(
                f"horizon={horizon} too long for the tcn basis forecaster: "
                f"fitted series length is {self.X.shape[1]}; need "
                f"horizon < T (or use basis_forecaster='ar')")
        xs, ys = [], []
        for row in self.X:
            for s in range(len(row) - p - horizon + 1):
                xs.append(row[s:s + p, None])
                ys.append(row[s + p:s + p + horizon])
        f = TCNForecaster(future_seq_len=horizon, num_channels=(16, 16),
                          kernel_size=3, device=self.device)
        f.fit(np.asarray(xs, np.float32), np.asarray(ys, np.float32),
              epochs=3, batch_size=min(32, len(xs)))
        last = np.stack([row[-p:, None] for row in self.X]).astype(np.float32)
        return f.predict(last)                           # [k, horizon]

    def predict(self, horizon: int = 24, future_covariates=None,
                num_workers: Optional[int] = None) -> np.ndarray:
        """[n_series, horizon] forecasts (ref predict(horizon, ...))."""
        if self.X is None:
            raise RuntimeError("call fit first")
        if self.basis_forecaster == "tcn":
            xf = self._forecast_basis_tcn(horizon)
        else:
            xf = self._forecast_basis_ar(horizon, future_covariates)
        out = self.F @ xf
        if self.use_local:
            out = out + self._local_forecast(horizon)
        if self._norm is not None:
            m, s, mini = self._norm
            out = (out - mini) * s[:, None] + m[:, None]
        return out

    # -------------------------------------------------------- evaluate --
    def evaluate(self, y_true: np.ndarray, metrics=("mse",),
                 target_covariates=None,
                 num_workers: Optional[int] = None) -> dict:
        """Forecast ``y_true.shape[1]`` steps and score (ref evaluate:
        target_value's second dim is the horizon; ``target_covariates``
        are the known future regressors for that window)."""
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        y_true, _, _ = _coerce_panel(y_true)
        pred = self.predict(y_true.shape[1],
                            future_covariates=target_covariates)
        return {m: Evaluator.evaluate(m, y_true, pred) for m in metrics}

    def rolling_evaluate(self, y_stream: np.ndarray, horizon: int,
                         metrics=("mse",), covariates=None) -> list:
        """Rolling-origin evaluation over a stream of future observations
        (the scale path the reference runs over Ray workers: repeatedly
        forecast ``horizon`` steps, then absorb the actuals via
        ``fit_incremental`` and roll forward). Returns one metrics dict
        per origin, each tagged with its start offset.

        ``covariates`` [r, y_stream.shape[1]]: future regressor values
        aligned with ``y_stream``; required when the model was fitted
        with covariates (each window is sliced for
        ``predict(future_covariates=...)`` and
        ``fit_incremental(covariates_incr=...)``)."""
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        y_stream, _, _ = _coerce_panel(y_stream)
        n, total = y_stream.shape
        if self.F is None:
            raise RuntimeError("call fit first")
        assert n == self.F.shape[0], "series count mismatch"
        if self._covariates is not None and covariates is None:
            raise ValueError(
                "model was fitted with covariates; rolling_evaluate needs "
                "covariates [r, y_stream_len] aligned with y_stream")
        cov = None
        if covariates is not None:
            cov = np.asarray(covariates, np.float32)
            if cov.shape[1] != total:
                raise ValueError(
                    f"covariates second dim {cov.shape[1]} must match "
                    f"y_stream length {total}")
        results = []
        for start in range(0, total - horizon + 1, horizon):
            chunk = y_stream[:, start:start + horizon]
            cov_chunk = (cov[:, start:start + horizon]
                         if cov is not None else None)
            pred = self.predict(horizon, future_covariates=cov_chunk)
            scores = {m: Evaluator.evaluate(m, chunk, pred) for m in metrics}
            scores["origin"] = start
            results.append(scores)
            self.fit_incremental(chunk, covariates_incr=cov_chunk)
        return results

    def is_xshards_distributed(self) -> bool:
        """ref tcmf_forecaster.is_xshards_distributed."""
        return self._was_xshards

    # ------------------------------------------------------- save/load --
    def save(self, path: str) -> None:
        """ref tcmf_forecaster.save: persist factors + config."""
        os.makedirs(path, exist_ok=True)
        arrays = {"F": self.F, "X": self.X}
        if self._norm is not None:
            arrays.update(norm_m=self._norm[0], norm_s=self._norm[1],
                          norm_mini=np.float32(self._norm[2]))
        if self._covariates is not None:
            arrays["covariates"] = self._covariates
        if self._time_feats is not None:
            arrays["time_feats"] = self._time_feats
        if self.use_local and self._local is not None:
            arrays["resid_hist"] = self._resid_hist
            self._local.save(os.path.join(path, "local_tcn"))
        np.savez(os.path.join(path, "tcmf_factors.npz"),
                 **{k: v for k, v in arrays.items() if v is not None})
        cfg = dict(k=self.k, lam=self.lam, ar_order=self.ar_order,
                   lr=self.lr, basis_forecaster=self.basis_forecaster,
                   use_local=self.use_local,
                   local_lookback=self.local_lookback,
                   normalize=self.normalize, svd=self.svd,
                   period=self.period, seed=self.seed,
                   was_xshards=self._was_xshards,
                   dti_last=(str(self._dti_last)
                             if self._dti_last is not None else None),
                   dti_freq=self._dti_freq)
        with open(os.path.join(path, "tcmf_config.json"), "w") as f:
            json.dump(cfg, f)

    @classmethod
    def load(cls, path: str, is_xshards_distributed: bool = False,
             device: DeviceLike = None) -> "TCMFForecaster":
        with open(os.path.join(path, "tcmf_config.json")) as f:
            cfg = json.load(f)
        was_xshards = cfg.pop("was_xshards", False)
        dti_last = cfg.pop("dti_last", None)
        dti_freq = cfg.pop("dti_freq", None)
        model = cls(device=device, **cfg)
        if dti_last is not None:
            import pandas as pd
            model._dti_last = pd.Timestamp(dti_last)
            model._dti_freq = dti_freq
        data = np.load(os.path.join(path, "tcmf_factors.npz"))
        model.F = data["F"]
        model.X = data["X"]
        if "norm_m" in data:
            model._norm = (data["norm_m"], data["norm_s"],
                           float(data["norm_mini"]))
        model._covariates = data["covariates"] if "covariates" in data \
            else None
        model._time_feats = data["time_feats"] if "time_feats" in data \
            else None
        if "resid_hist" in data:
            from analytics_zoo_tpu_torch.zouwu.model.forecast import TCNForecaster
            model._resid_hist = data["resid_hist"]
            p = min(model.local_lookback, model._resid_hist.shape[1] - 2)
            model._local = TCNForecaster(future_seq_len=1,
                                         num_channels=(16, 16),
                                         kernel_size=3, device=model.device)
            model._local.restore(
                os.path.join(path, "local_tcn"),
                sample_x=model._resid_hist[:1, -p:, None].astype(np.float32))
        model._was_xshards = was_xshards or is_xshards_distributed
        return model
