"""Seasonal ARIMA forecaster (counterpart of
analytics_zoo_tpu/chronos/forecaster/arima_forecaster.py): a native
multiplicative SARIMA (p, d, q)(P, D, Q, m) in numpy and scipy, on the
host as in JAX, the same code on the same float64 data.

    phi(B) Phi(B^m) (1-B)^d (1-B^m)^D (y_t - mu) = theta(B) Theta(B^m) e_t

Fit by conditional sum of squares: the residual recursion on the
differenced series is one IIR filter (`scipy.signal.lfilter`),
minimized by L-BFGS-B over PACF-space parameters pushed through the
Monahan (1984) Durbin-Levinson transform, so every fit is stationary
and invertible.  d and D are estimated from the data when not given
(a lag-1, resp. lag-m, autocorrelation heuristic).  scipy is imported
inside the functions that use it.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# parameter transforms and polynomial helpers
# ---------------------------------------------------------------------------

def _pacf_to_ar(raw: np.ndarray) -> np.ndarray:
    """Unconstrained raw params -> stationary AR coefficients via
    tanh-PACF + Durbin-Levinson (Monahan 1984)."""
    r = np.tanh(np.asarray(raw, np.float64))
    phi = np.zeros(0)
    for k in range(len(r)):
        phi = np.concatenate([phi - r[k] * phi[::-1], [r[k]]])
    return phi


def _poly_mul_seasonal(nonseas: np.ndarray, seas: np.ndarray,
                       m: int) -> np.ndarray:
    """(1 - sum a_i B^i)(1 - sum A_j B^(jm)) -> coefficient vector c of
    the product written as 1 - sum c_i B^i (c indexed from lag 1)."""
    pn = np.concatenate([[1.0], -np.asarray(nonseas, np.float64)])
    ps = np.zeros(len(seas) * m + 1)
    ps[0] = 1.0
    for j, a in enumerate(np.asarray(seas, np.float64)):
        ps[(j + 1) * m] = -a
    return -np.convolve(pn, ps)[1:]


def _difference(y: np.ndarray, d: int, D: int, m: int) -> np.ndarray:
    """Apply (1-B)^d then (1-B^m)^D."""
    work = np.asarray(y, np.float64)
    for _ in range(d):
        work = np.diff(work)
    for _ in range(D):
        work = work[m:] - work[:-m]
    return work


def _estimate_d(y: np.ndarray, max_d: int = 2) -> int:
    """pmdarima's ndiffs as a heuristic: difference while the series
    still behaves like a unit root (lag-1 autocorrelation ~1) and
    differencing keeps reducing variance."""
    d = 0
    work = np.asarray(y, np.float64)
    while d < max_d and len(work) > 10:
        c = work - work.mean()
        denom = float(c @ c)
        if denom <= 1e-12:
            break
        rho1 = float(c[1:] @ c[:-1]) / denom
        if rho1 < 0.95:
            break
        nxt = np.diff(work)
        if nxt.var() > work.var():
            break
        work = nxt
        d += 1
    return d


def _estimate_D(y: np.ndarray, m: int, max_D: int = 1) -> int:
    """pmdarima's nsdiffs as a heuristic: the
    lag-m autocorrelation stays high until seasonally differenced."""
    if m <= 1 or len(y) < 3 * m:
        return 0
    D = 0
    work = np.asarray(y, np.float64)
    while D < max_D and len(work) > 2 * m:
        c = work - work.mean()
        denom = float(c @ c)
        if denom <= 1e-12:
            break
        rho_m = float(c[m:] @ c[:-m]) / denom
        if rho_m < 0.6:
            break
        work = work[m:] - work[:-m]
        D += 1
    return D


class _SARIMA:
    """CSS-fitted seasonal ARIMA on a single series."""

    def __init__(self, p, d, q, P, D, Q, m):
        self.p, self.d, self.q = int(p), int(d), int(q)
        self.P, self.D, self.Q = int(P), int(D), int(Q)
        self.m = int(m)
        self.mu = 0.0
        self.sigma2 = 1.0
        self.ar_: np.ndarray = np.zeros(0)      # combined AR coefficients
        self.ma_: np.ndarray = np.zeros(0)      # combined MA (+ convention)
        self.raw_: Optional[np.ndarray] = None  # optimizer-space params

    # -- parameterization ----------------------------------------------

    def _split(self, raw):
        i = 0
        phi = _pacf_to_ar(raw[i:i + self.p]); i += self.p
        th = _pacf_to_ar(raw[i:i + self.q]); i += self.q
        Phi = _pacf_to_ar(raw[i:i + self.P]); i += self.P
        Th = _pacf_to_ar(raw[i:i + self.Q]); i += self.Q
        return phi, th, Phi, Th

    def _combined(self, raw):
        phi, th, Phi, Th = self._split(raw)
        ar = _poly_mul_seasonal(phi, Phi, self.m)
        # theta(B) = 1 + sum ma_j B^j; the stationary transform builds
        # 1 - sum c_i B^i with roots outside the unit circle, so
        # ma = -c is invertible by construction
        ma = -_poly_mul_seasonal(th, Th, self.m)
        return ar, ma

    # -- CSS -----------------------------------------------------------

    @staticmethod
    def _residuals(w, ar, ma):
        from scipy.signal import lfilter
        # e_t = w_t - sum ar_i w_{t-i} - sum ma_j e_{t-j}: an IIR filter
        b = np.concatenate([[1.0], -ar])
        a = np.concatenate([[1.0], ma])
        return lfilter(b, a, w)

    def fit(self, y: np.ndarray):
        from scipy.optimize import minimize

        y = np.asarray(y, np.float64)
        w = _difference(y, self.d, self.D, self.m)
        span = self.p + self.q + (self.P + self.Q) * self.m
        if len(w) < 2 * span + 8:
            raise ValueError(
                f"series too short ({len(y)}) for SARIMA"
                f"({self.p},{self.d},{self.q})"
                f"({self.P},{self.D},{self.Q},{self.m})")
        self.mu = float(w.mean())
        wc = w - self.mu
        n_par = self.p + self.q + self.P + self.Q
        burn = min(len(wc) // 4, span)

        def css(raw):
            ar, ma = self._combined(raw)
            e = self._residuals(wc, ar, ma)[burn:]
            return float(e @ e)

        if n_par:
            res = minimize(css, np.zeros(n_par), method="L-BFGS-B")
            self.raw_ = res.x
        else:
            self.raw_ = np.zeros(0)
        self.ar_, self.ma_ = self._combined(self.raw_)
        e = self._residuals(wc, self.ar_, self.ma_)
        self.sigma2 = float(e[burn:] @ e[burn:]) / max(
            len(e) - burn - n_par, 1)
        self._w_hist = wc
        self._e_hist = e
        self._y_hist = y
        return self

    # -- forecasting ---------------------------------------------------

    def _forecast_diffed(self, h: int) -> np.ndarray:
        """h-step forecast of the centered differenced series."""
        w = list(self._w_hist)
        e = list(self._e_hist)
        out = []
        for _ in range(h):
            val = 0.0
            for i, c in enumerate(self.ar_):
                if len(w) - 1 - i >= 0:
                    val += c * w[len(w) - 1 - i]
            for j, c in enumerate(self.ma_):
                if len(e) - 1 - j >= 0:
                    val += c * e[len(e) - 1 - j]
            w.append(val)
            e.append(0.0)       # future shocks have zero expectation
            out.append(val)
        return np.asarray(out)

    def forecast(self, h: int):
        """-> (point forecasts, forecast std), each of length h."""
        h = int(h)
        wf = self._forecast_diffed(h) + self.mu

        # invert the differencing: rebuild the chain of differenced
        # histories (level 0 = raw y ... level d+D = fully differenced),
        # then integrate future values back down the chain
        chain = [self._y_hist]
        for _ in range(self.d):
            chain.append(np.diff(chain[-1]))
        for _ in range(self.D):
            x = chain[-1]
            chain.append(x[self.m:] - x[:-self.m])
        future = list(wf)
        for li in range(len(chain) - 2, -1, -1):
            # level li+1 came from level li by a seasonal diff iff we're
            # past the d ordinary diffs
            lag = self.m if li >= self.d else 1
            ext = list(chain[li])
            out = []
            for t in range(h):
                val = future[t] + ext[-lag]
                ext.append(val)
                out.append(val)
            future = out
        point = np.asarray(future)

        # forecast std via psi weights of the ARMA part, convolved with
        # the expansion of the integration operators (1-B)^-d (1-B^m)^-D
        psi = self._psi_weights(h)
        poly = np.array([1.0])
        for _ in range(self.d):
            poly = np.convolve(poly, np.ones(h))[:h]
        for _ in range(self.D):
            q = np.zeros(h)
            q[::self.m] = 1.0
            poly = np.convolve(poly, q)[:h]
        psi_int = np.convolve(poly, psi)[:h]
        var = self.sigma2 * np.cumsum(psi_int ** 2)
        return point, np.sqrt(var)

    def _psi_weights(self, h: int) -> np.ndarray:
        psi = np.zeros(h)
        psi[0] = 1.0
        for j in range(1, h):
            val = self.ma_[j - 1] if j - 1 < len(self.ma_) else 0.0
            for i in range(min(j, len(self.ar_))):
                val += self.ar_[i] * psi[j - 1 - i]
            psi[j] = val
        return psi

    def extend(self, new_obs: Sequence[float]):
        """Filter new observations through the fitted model (no refit) —
        powers one-step-ahead rolling evaluation.  The innovation of the
        level equals the innovation of the differenced series (the
        integration terms are known history)."""
        for obs in np.asarray(new_obs, np.float64).reshape(-1):
            pred = float(self.forecast(1)[0][0])
            y = np.append(self._y_hist, obs)
            self._y_hist = y
            self._w_hist = _difference(y, self.d, self.D, self.m) - self.mu
            self._e_hist = np.append(self._e_hist, obs - pred)


class ARIMAForecaster:
    """JAX's ARIMAForecaster surface (constructor, fit / predict /
    evaluate / save / restore / load) over the native SARIMA above.  d
    and D are estimated from the data when not given."""

    def __init__(self, p: int = 2, q: int = 2,
                 seasonality_mode: bool = True, P: int = 1, Q: int = 1,
                 m: int = 7, metric: str = "mse", d: Optional[int] = None,
                 D: Optional[int] = None):
        self.config = dict(p=int(p), q=int(q),
                           seasonality_mode=bool(seasonality_mode),
                           P=int(P), Q=int(Q), m=int(m), metric=metric,
                           d=d, D=D)
        self.model: Optional[_SARIMA] = None

    def fit(self, data, validation_data=None) -> Dict[str, float]:
        """data / validation_data: 1-D numpy arrays.
        Returns {metric: value} on the validation horizon (a tail split
        of `data` when validation_data is omitted)."""
        data = np.asarray(data, np.float64).reshape(-1)
        if validation_data is None:
            cut = max(len(data) - max(len(data) // 10, 1), 8)
            data, validation_data = data[:cut], data[cut:]
        validation_data = np.asarray(validation_data,
                                     np.float64).reshape(-1)
        c = self.config
        d = c["d"] if c["d"] is not None else _estimate_d(data)
        if c["seasonality_mode"]:
            D = c["D"] if c["D"] is not None else _estimate_D(data, c["m"])
            P, Q, m = c["P"], c["Q"], c["m"]
        else:
            D, P, Q, m = 0, 0, 0, 1
        self.model = _SARIMA(c["p"], d, c["q"], P, D, Q, m).fit(data)
        val = self.evaluate(validation_data, metrics=[c["metric"]])[0]
        return {c["metric"]: float(val)}

    def predict(self, horizon: int, rolling: bool = False,
                with_interval: bool = False, alpha: float = 0.05):
        """Point forecasts; optionally (point, (lower, upper)) at
        1-alpha coverage.  `rolling` feeds each point forecast back as
        if observed and
        restores the model state afterwards."""
        if self.model is None:
            raise RuntimeError(
                "You must call fit or restore first before calling "
                "predict!")
        if rolling:
            saved = pickle.dumps(self.model.__dict__)
            out = []
            for _ in range(int(horizon)):
                f = float(self.model.forecast(1)[0][0])
                out.append(f)
                self.model.extend([f])
            self.model.__dict__.update(pickle.loads(saved))
            return np.asarray(out)
        point, std = self.model.forecast(int(horizon))
        if with_interval:
            from scipy.stats import norm
            z = float(norm.ppf(1.0 - alpha / 2.0))
            return point, (point - z * std, point + z * std)
        return point

    def evaluate(self, validation_data, metrics: List[str] = ("mse",),
                 rolling: bool = False) -> List[float]:
        """Multi-step (default) or one-step-ahead rolling evaluation
        against held-out data."""
        if validation_data is None:
            raise ValueError("Input invalid validation_data of None")
        if self.model is None:
            raise RuntimeError(
                "You must call fit or restore first before calling "
                "evaluate!")
        from analytics_zoo_tpu_torch.orca.automl.metrics import Evaluator
        target = np.asarray(validation_data, np.float64).reshape(-1)
        if rolling:
            saved = pickle.dumps(self.model.__dict__)
            preds = []
            for obs in target:
                preds.append(float(self.model.forecast(1)[0][0]))
                self.model.extend([obs])
            self.model.__dict__.update(pickle.loads(saved))
            preds = np.asarray(preds)
        else:
            preds = self.predict(len(target))
        return [float(np.mean(Evaluator.evaluate(m, target, preds)))
                for m in metrics]

    def save(self, checkpoint_file: str):
        if self.model is None:
            raise RuntimeError(
                "You must call fit or restore first before calling save!")
        with open(checkpoint_file, "wb") as f:
            pickle.dump({"config": self.config,
                         "state": self.model.__dict__}, f)

    @classmethod
    def load(cls, checkpoint_file: str, device=None) -> "ARIMAForecaster":
        """TSPipeline.load's entry point; `device` is taken for the
        window forecasters' signature and unused (the model is host
        numpy)."""
        fc = cls()
        fc.restore(checkpoint_file)
        return fc

    def restore(self, checkpoint_file: str):
        with open(checkpoint_file, "rb") as f:
            blob = pickle.load(f)
        self.config = blob["config"]
        st = blob["state"]
        self.model = _SARIMA(st["p"], st["d"], st["q"], st["P"], st["D"],
                             st["Q"], st["m"])
        self.model.__dict__.update(st)
        return self
