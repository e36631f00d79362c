"""TCMF forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/tcmf_forecaster.py): temporal
convolutional matrix factorization for many related series, with
DeepGLO's hybrid local network.

Three stages, as in JAX:

1. The factorization Y[n, T] ~ F[n, k] X[k, T] trains on the port's
   Estimator as an embedding model (`_Factorization`: an
   `nn.Embedding(n, rank)` for F and an `x_basis` [rank, T] parameter
   drawn from normal(0.1)); a batch is a slice of series ids, the id
   set tiled `reps` times so that a small n still gives an epoch a few
   hundred rows.  JAX shards the table over its "tp" mesh axis
   (`shard_rules={"embed": "tp"}`); one card has no mesh, so the port
   passes none.
2. The basis rows X are rolled into (window -> next value) samples and
   fit by the port's `TCNForecaster` (batch min(256, samples),
   max(2, min(20, epochs // 2)) epochs).
3. The hybrid local TCN is fit on per-series windows of [y, global
   reconstruction, covariates...], subsampled to `max_local_samples`
   (series, offset) pairs with numpy's generator.

`predict(horizon)` rolls the basis TCN forward, recombines through F
and (hybrid) rolls the local TCN with the global forecast and future
covariates as channels; `fit_incremental` appends columns and refits
from a warm start (`Estimator.set_params`); `rolling_validation`,
`evaluate`, `save` / `load` (a pickle whose TCN parameters are
torch-layout numpy state_dicts, where JAX pickles flax trees).
`device` (None: the CUDA card, or a raise) is where all three stages
train.  pandas is imported only by `_time_covariates`, for a
DatetimeIndex.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device


class _Factorization(nn.Module):
    """ids [b] -> F[ids] @ X, the reconstructed rows [b, T]."""

    def __init__(self, num_series: int, rank: int, length: int, device):
        super().__init__()
        self.embed_f = nn.Embedding(num_series, rank, device=device)
        # flax's default Embed init: std 1/sqrt(rank)
        nn.init.normal_(self.embed_f.weight, std=rank ** -0.5)
        self.x_basis = nn.Parameter(
            0.1 * torch.randn(rank, length, device=device))

    def forward(self, ids):
        return self.embed_f(ids.long()) @ self.x_basis


def _time_covariates(T: int, dti=None, t0: int = 0,
                     ramp_scale: Optional[int] = None) -> np.ndarray:
    """[c_t, T] default time covariates: calendar features of a
    DatetimeIndex, or an absolute time ramp (`t0` the global index of
    the first column, `ramp_scale` the denominator fixed at the first
    fit, so later windows continue the training ramp)."""
    if dti is not None:
        import pandas as pd
        dti = pd.DatetimeIndex(dti)
        return np.stack([
            dti.hour.to_numpy() / 23.0,
            dti.dayofweek.to_numpy() / 6.0,
            (dti.day.to_numpy() - 1) / 30.0,
            (dti.month.to_numpy() - 1) / 11.0,
        ]).astype(np.float32)
    scale = max((ramp_scale if ramp_scale is not None else T) - 1, 1)
    return (np.arange(t0, t0 + T, dtype=np.float32) / scale)[None]


def _next_value_windows(rows: np.ndarray, lb: int):
    """Every row's (window of lb, next value) samples, row by row:
    x [rows * (T - lb), lb], y [rows * (T - lb)]."""
    T = rows.shape[1]
    x = np.lib.stride_tricks.sliding_window_view(rows, lb, axis=1)
    return (x[:, :T - lb].reshape(-1, lb).astype(np.float32),
            rows[:, lb:].reshape(-1).astype(np.float32))


class TCMFForecaster:
    """fit on Y [n_series, T]; predict(horizon) -> [n_series, horizon].

    JAX's constructor (`vbsize`, `rank`, `tcn_lookback`,
    `num_channels_X`, `num_channels_Y`, `use_time`, `hybrid`,
    `max_local_samples`, `lr`, `seed`) and `device`."""

    def __init__(self, vbsize: int = 128, rank: int = 16,
                 tcn_lookback: int = 16,
                 num_channels_X: tuple = (32, 32),
                 num_channels_Y: tuple = (16, 16),
                 use_time: bool = True,
                 hybrid: bool = True,
                 max_local_samples: int = 20_000,
                 lr: float = 5e-3, seed: int = 0, device=None):
        self.vbsize = vbsize          # vertical (series) batch size
        self.rank = rank
        self.tcn_lookback = tcn_lookback
        self.num_channels_X = tuple(num_channels_X)
        self.num_channels_Y = tuple(num_channels_Y)
        self.use_time = use_time
        self.hybrid = hybrid
        self.max_local_samples = max_local_samples
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self._est = None              # factorization estimator
        self._tcn = None              # basis forecaster
        self._local = None            # hybrid per-series forecaster
        self.n = self.T = None
        self._cov = None              # [c, T] stacked covariates

    # -- covariates ------------------------------------------------------

    def _stack_covariates(self, T, covariates, dti, t0: int = 0):
        parts = []
        if self.use_time:
            parts.append(_time_covariates(
                T, dti, t0=t0, ramp_scale=getattr(self, "_ramp_scale",
                                                  None)))
        if covariates is not None:
            cov = np.asarray(covariates, np.float32)
            if cov.ndim != 2 or cov.shape[1] != T:
                raise ValueError(
                    f"covariates must be [r, T={T}], got {cov.shape}")
            parts.append(cov)
        if not parts:
            return np.zeros((0, T), np.float32)
        return np.concatenate(parts, axis=0)

    # -- stage 1: the factorization --------------------------------------

    def fit(self, x, val_len: int = 0, epochs: int = 20,
            batch_size: Optional[int] = None,
            covariates=None, dti=None):
        """`x` is {"y": [n, T]} or a bare [n, T] ndarray; `covariates`
        [r, T] are global for all series, stacked under the time
        covariates when `use_time`."""
        self._prepare(x, covariates, dti)
        self._fit_factorization(epochs, batch_size)
        self._fit_basis_tcn(epochs)
        if self.hybrid:
            self._fit_local(epochs)
        return self

    def _prepare(self, x, covariates=None, dti=None):
        """The normalized series (per-series mean and std) and the
        stacked covariates of a first fit."""
        y = np.asarray(x["y"] if isinstance(x, dict) else x, np.float32)
        if y.ndim != 2:
            raise ValueError(f"TCMF expects [n_series, T], got {y.shape}")
        self.n, self.T = y.shape
        self._y_mean = y.mean(axis=1, keepdims=True)
        self._y_std = y.std(axis=1, keepdims=True) + 1e-6
        self._yn = (y - self._y_mean) / self._y_std
        self._ramp_scale = self.T
        self._cov = self._stack_covariates(self.T, covariates, dti)

    def _factorization_estimator(self):
        from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(self.seed)
            module = _Factorization(self.n, self.rank, self.T, self.device)
        return Estimator.from_torch(module, loss="mse", optimizer="adam",
                                    learning_rate=self.lr, seed=self.seed)

    def _factorization_data(self):
        ids = np.arange(self.n, dtype=np.int32)
        # small n would mean one optimizer step per epoch: tile the id
        # set so that each epoch carries several hundred rows of work
        reps = max(1, min(16, 512 // max(self.n, 1)))
        return {"x": np.tile(ids, reps), "y": np.tile(self._yn, (reps, 1))}

    def _fit_factorization(self, epochs, batch_size, warm_params=None):
        self._est = self._factorization_estimator()
        if warm_params is not None:
            self._est.set_params(warm_params)
        self._est.fit(self._factorization_data(), epochs=epochs,
                      batch_size=batch_size or min(self.vbsize, self.n))
        module = self._est.get_model()
        self._X = module.x_basis.detach().cpu().numpy()          # [k, T]
        self._F = module.embed_f.weight.detach().cpu().numpy()   # [n, k]

    # -- stage 2: TCN over the learned temporal basis --------------------

    def _lookback(self) -> int:
        return min(self.tcn_lookback, self.T - 1)

    def _tcn_forecaster(self, n_in: int, channels):
        from analytics_zoo_tpu_torch.chronos.forecaster.tcn_forecaster \
            import TCNForecaster
        return TCNForecaster(
            past_seq_len=self._lookback(), future_seq_len=1,
            input_feature_num=n_in, output_feature_num=1,
            num_channels=channels, lr=self.lr, seed=self.seed,
            device=self.device)

    def _fit_basis_tcn(self, epochs):
        self._tcn = self._tcn_forecaster(1, self.num_channels_X)
        # every basis row rolled into (window -> next value) samples
        xs, ys = _next_value_windows(self._X, self._lookback())
        self._tcn.fit({"x": xs[..., None], "y": ys[:, None, None]},
                      epochs=max(2, min(20, epochs // 2)),
                      batch_size=min(256, len(xs)))

    # -- stage 3: DeepGLO hybrid local network ---------------------------

    def _local_channels(self):
        return 2 + self._cov.shape[0]   # y, global recon, covariates

    def _fit_local(self, epochs):
        """The shared per-series network on [y, recon, cov...] windows
        (DeepGLO's train_Yseq with the global prediction as Ycov)."""
        xs, ys = self._local_windows()
        self._local = self._tcn_forecaster(self._local_channels(),
                                           self.num_channels_Y)
        self._local.fit({"x": xs, "y": ys},
                        epochs=max(2, min(20, epochs // 2)),
                        batch_size=min(256, len(xs)))

    def _local_windows(self):
        """The local network's (x [s, lb, channels], y [s, 1, 1])."""
        lb = self._lookback()
        recon = self._F @ self._X                    # [n, T] normalized
        # subsample (series, offset) pairs before making windows: the
        # full n * (T - lb) set need not fit in host memory
        n_win = self.n * (self.T - lb)
        if n_win > self.max_local_samples:
            flat = np.random.default_rng(self.seed).choice(
                n_win, self.max_local_samples, replace=False)
        else:
            flat = np.arange(n_win)
        series, t0 = np.divmod(flat, self.T - lb)
        steps = t0[:, None] + np.arange(lb)[None]               # [s, lb]
        xs = np.empty((len(flat), lb, self._local_channels()), np.float32)
        xs[:, :, 0] = self._yn[series[:, None], steps]
        xs[:, :, 1] = recon[series[:, None], steps]
        xs[:, :, 2:] = self._cov[:, steps].transpose(1, 2, 0)
        ys = self._yn[series, t0 + lb].astype(np.float32)[:, None, None]
        return xs, ys

    # -- prediction ------------------------------------------------------

    def _roll_basis(self, horizon):
        lb = self._lookback()
        X = self._X.copy()
        for _ in range(horizon):
            window = X[:, -lb:][..., None].astype(np.float32)
            nxt = self._tcn.predict({"x": window})  # [k, 1, 1]
            X = np.concatenate([X, nxt[:, :, 0]], axis=1)
        return X[:, self.T:]                         # [k, horizon]

    def predict(self, horizon: int = 1, future_covariates=None,
                future_dti=None) -> np.ndarray:
        """Global: roll the basis TCN `horizon` steps ahead and
        recombine through F.  Hybrid: the local network then rolls each
        series forward with [its own history, the global forecast,
        future covariates] as channels."""
        if self._tcn is None:
            raise RuntimeError("call fit first")
        x_future = self._roll_basis(horizon)
        global_n = self._F @ x_future                # [n, horizon], norm
        if not self.hybrid or self._local is None:
            return global_n * self._y_std + self._y_mean

        cov_future = self._stack_covariates(
            horizon, future_covariates, future_dti, t0=self.T) \
            if (self.use_time or future_covariates is not None) else \
            np.zeros((0, horizon), np.float32)
        if cov_future.shape[0] != self._cov.shape[0]:
            raise ValueError(
                f"future covariates give {cov_future.shape[0]} channels "
                f"but the model was fit with {self._cov.shape[0]}; pass "
                "the same covariate rows to predict")
        lb = self._lookback()
        recon = self._F @ self._X                    # [n, T]
        # rolling buffers: [n, T+h] histories of y / recon / covariates
        y_hist = self._yn.copy()
        r_hist = np.concatenate([recon, global_n], axis=1)
        c_hist = np.concatenate([self._cov, cov_future], axis=1)
        for h in range(horizon):
            t = self.T + h
            chans = [y_hist[:, t - lb:t], r_hist[:, t - lb:t]]
            chans += [np.broadcast_to(c_hist[j, t - lb:t],
                                      (self.n, lb))
                      for j in range(c_hist.shape[0])]
            window = np.stack(chans, axis=-1).astype(np.float32)
            nxt = self._local.predict({"x": window})[:, 0, 0]  # [n]
            y_hist = np.concatenate([y_hist, nxt[:, None]], axis=1)
        out = y_hist[:, self.T:]
        return out * self._y_std + self._y_mean

    # -- rolling retrain -------------------------------------------------

    def fit_incremental(self, x_incr, covariates_incr=None,
                        dti_incr=None, epochs: int = 5):
        """Append new time columns and retrain briefly from a warm
        start: X is extended with its last value as the new columns'
        start, and F with the trained X prefix warm-start the
        factorization through `Estimator.set_params`."""
        if getattr(self, "_X", None) is None:
            # _X (not _est) is the gate: load() restores all warm-start
            # state, so a loaded model can roll forward too
            raise RuntimeError("call fit before fit_incremental")
        y_incr = np.asarray(
            x_incr["y"] if isinstance(x_incr, dict) else x_incr,
            np.float32)
        if y_incr.shape[0] != self.n:
            raise ValueError(
                f"fit_incremental needs the same {self.n} series, got "
                f"{y_incr.shape[0]}")
        t_new = y_incr.shape[1]
        yn_incr = (y_incr - self._y_mean) / self._y_std
        self._yn = np.concatenate([self._yn, yn_incr], axis=1)
        cov_incr = self._stack_covariates(t_new, covariates_incr,
                                          dti_incr, t0=self.T)
        if cov_incr.shape[0] != self._cov.shape[0]:
            raise ValueError(
                f"incremental covariates give {cov_incr.shape[0]} "
                f"channels, model has {self._cov.shape[0]}")
        self._cov = np.concatenate([self._cov, cov_incr], axis=1)
        self.T += t_new

        warm = {
            "embed_f.weight": torch.from_numpy(self._F),
            "x_basis": torch.from_numpy(np.concatenate(
                [self._X, np.repeat(self._X[:, -1:], t_new, axis=1)],
                axis=1)),
        }
        self._fit_factorization(epochs, None, warm_params=warm)
        self._fit_basis_tcn(epochs)
        if self.hybrid:
            self._fit_local(epochs)
        return self

    def rolling_validation(self, x, tau: int = 24, n: int = 4,
                           epochs: int = 20, epochs_incr: int = 5,
                           metric=("mse",),
                           covariates=None, dti=None) -> dict:
        """Walk-forward evaluation with retraining: fit on the first
        T - n*tau columns, then n rounds of (forecast tau ahead, score
        against the observed window, fold the window in through
        fit_incremental).  Per-metric means over the rounds, and the
        rounds' scores under "rounds"."""
        y = np.asarray(x["y"] if isinstance(x, dict) else x, np.float32)
        if y.ndim != 2:
            raise ValueError(f"TCMF expects [n_series, T], got {y.shape}")
        T = y.shape[1]
        t0 = T - n * tau
        if t0 <= self.tcn_lookback:
            raise ValueError(
                f"rolling_validation needs T - n*tau > tcn_lookback; "
                f"got T={T}, n={n}, tau={tau}")
        cov = (np.asarray(covariates, np.float32)
               if covariates is not None else None)

        def cov_slice(lo, hi):
            return cov[:, lo:hi] if cov is not None else None

        def dti_slice(lo, hi):
            return dti[lo:hi] if dti is not None else None

        self.fit({"y": y[:, :t0]}, epochs=epochs,
                 covariates=cov_slice(0, t0), dti=dti_slice(0, t0))
        rounds = []
        for r in range(n):
            lo, hi = t0 + r * tau, t0 + (r + 1) * tau
            truth = y[:, lo:hi]
            rounds.append(self.evaluate(
                {"y": truth}, metric=metric,
                future_covariates=cov_slice(lo, hi),
                future_dti=dti_slice(lo, hi)))
            self.fit_incremental({"y": truth},
                                 covariates_incr=cov_slice(lo, hi),
                                 dti_incr=dti_slice(lo, hi),
                                 epochs=epochs_incr)
        out = {m: float(np.mean([r[m] for r in rounds]))
               for m in metric}
        out["rounds"] = rounds
        return out

    # -- evaluation ------------------------------------------------------

    def evaluate(self, target_value, metric=("mse",),
                 future_covariates=None, future_dti=None) -> dict:
        y_true = np.asarray(
            target_value["y"] if isinstance(target_value, dict)
            else target_value, np.float32)
        pred = self.predict(horizon=y_true.shape[1],
                            future_covariates=future_covariates,
                            future_dti=future_dti)
        out = {}
        for m in metric:
            if m == "mse":
                out[m] = float(np.mean((pred - y_true) ** 2))
            elif m == "mae":
                out[m] = float(np.mean(np.abs(pred - y_true)))
            else:
                raise ValueError(f"unknown metric {m}")
        return out

    # -- persistence ----------------------------------------------------

    @staticmethod
    def _host_params(fc):
        if fc is None:
            return None
        return {k: v.detach().cpu().numpy() for k, v in
                fc._estimator().get_model().state_dict().items()}

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({
                "config": dict(vbsize=self.vbsize, rank=self.rank,
                               tcn_lookback=self.tcn_lookback,
                               num_channels_X=self.num_channels_X,
                               num_channels_Y=self.num_channels_Y,
                               use_time=self.use_time,
                               hybrid=self.hybrid,
                               max_local_samples=self.max_local_samples,
                               lr=self.lr, seed=self.seed),
                "n": self.n, "T": self.T,
                "ramp_scale": getattr(self, "_ramp_scale", None),
                "F": getattr(self, "_F", None),
                "X": getattr(self, "_X", None),
                "yn": getattr(self, "_yn", None),
                "cov": getattr(self, "_cov", None),
                "y_mean": getattr(self, "_y_mean", None),
                "y_std": getattr(self, "_y_std", None),
                "tcn_params": self._host_params(self._tcn),
                "local_params": self._host_params(self._local),
            }, f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    @classmethod
    def load(cls, path: str, device=None):
        """The forecaster saved at `path`, on `device` (None: the CUDA
        card)."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        self = cls(**d["config"], device=device)
        self.n, self.T = d["n"], d["T"]
        if d.get("ramp_scale") is not None:
            self._ramp_scale = d["ramp_scale"]
        self._F, self._X = d["F"], d["X"]
        self._yn = d.get("yn")
        self._cov = d.get("cov")
        self._y_mean, self._y_std = d["y_mean"], d["y_std"]
        for attr, key, n_in, channels in (
                ("_tcn", "tcn_params", 1, self.num_channels_X),
                ("_local", "local_params", None, self.num_channels_Y)):
            if d.get(key) is None:
                continue
            fc = self._tcn_forecaster(
                n_in or self._local_channels(), channels)
            fc._estimator().set_params({k: torch.from_numpy(v)
                                        for k, v in d[key].items()})
            setattr(self, attr, fc)
        return self
