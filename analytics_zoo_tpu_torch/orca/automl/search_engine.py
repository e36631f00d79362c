"""Hyperparameter search engine (counterpart of
analytics_zoo_tpu/orca/automl/search_engine.py).

Trials run under successive-halving early stopping (ASHA-style rungs):
every trial trains to the first rung, only the top 1/eta advance to the
next, and so on; sampling is random, grid, or TPE after a random
warm-up half, all pure Python over one `random.Random(seed)`, so a seed
gives the same configs and, for the same metrics, the same trial table
as the JAX engine's.

Concurrency (`parallelism=N`): the card cannot be shared in fractions,
so parallel trials target the host's cores, not the card:

* `backend="thread"`: trials share this process; torch's CPU ops
  release the GIL, so CPU trials overlap.  No serialization
  requirement on the trainable.
* `backend="process"`: persistent spawned workers, each owning a fixed
  subset of trials for the whole search (state never crosses the
  process boundary until the final export).  The parent exports
  `CUDA_VISIBLE_DEVICES=""` around the spawn (JAX exports
  `JAX_PLATFORMS=cpu`), so the workers never see the card; a trainable
  that builds port models there passes `device="cpu"`.  The trainable
  must be picklable (a module-level function or class).  The best
  trial's state comes back as ("estimator", (parameters, model_state))
  for an Estimator-like state, the parameters of a torch module as a
  CPU numpy state_dict and its buffers (`get_model_state()`) as numpy
  too, or ("raw", state) otherwise.
* `backend="device"`: for trainables that need the card: every trial
  runs in this process, one at a time through
  `common.device_lease`; `parallelism` is ignored (and logged).

A trial whose train call raises is marked NaN and culled at the next rung;
if every trial fails the search raises.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.orca.automl import hp as hp_mod

logger = logging.getLogger("analytics_zoo_tpu_torch")


@dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    state: Any = None            # opaque per-trial state (e.g. estimator)
    metric_history: List[float] = field(default_factory=list)
    epochs_trained: int = 0
    stopped: bool = False
    error: Optional[str] = None

    @property
    def best_metric(self):
        return self.metric_history[-1] if self.metric_history else None


#: the variable that hides the CUDA devices from the process workers
_VISIBLE = "CUDA_VISIBLE_DEVICES"


def _restore_env(name: str, value: Optional[str]) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _process_worker_main(conn, trainable):
    """Persistent trial worker (spawned process).  Owns the states of its
    assigned trials; never ships them back except on explicit export.
    CUDA_VISIBLE_DEVICES="" is exported by the PARENT around the spawn:
    the CUDA runtime reads it when it starts, so setting it here could
    come after the trainable's import touched torch.cuda."""
    states: Dict[int, Any] = {}
    while True:
        msg = conn.recv()
        if msg[0] == "train":
            _, tid, config, add = msg
            try:
                state, metric = trainable(config, states.get(tid), add)
                states[tid] = state
                conn.send(("ok", tid, float(metric)))
            except Exception as e:  # report, don't kill the worker
                conn.send(("err", tid, f"{type(e).__name__}: {e}"))
        elif msg[0] == "export":
            tid = msg[1]
            est = states.get(tid)
            payload, err = None, None
            if est is None:
                err = "trial state missing in worker"
            elif hasattr(est, "get_model"):
                # orca Estimator convention: numpy (params, model_state)
                try:
                    payload = ("estimator",
                               (_host_params(est.get_model()),
                                _host_arrays(est.get_model_state())))
                except Exception as e:
                    err = f"get_model export failed: {e}"
            else:
                payload = ("raw", est)  # picklable-or-bust generic state
            try:
                conn.send(("state", tid, payload, err))
            except Exception as e:  # unpicklable raw state
                conn.send(("state", tid, None,
                           f"state not picklable: {e}"))
        elif msg[0] == "free":
            # culled trial: drop its model from worker memory (the Ray
            # Tune analog terminates dead trial actors)
            states.pop(msg[1], None)
        elif msg[0] == "stop":
            conn.close()
            return


def _host_arrays(tree):
    """A mapping of tensors as numpy arrays on the host (other values
    as they are)."""
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
            for k, v in tree.items()}


def _host_params(model):
    """A torch module's parameters as a CPU numpy state_dict; any other
    model (a mapping of arrays, a picklable object) as it is."""
    if hasattr(model, "named_parameters"):
        return {k: p.detach().cpu().numpy()
                for k, p in model.named_parameters()}
    return model


class SearchEngine:
    """trainable(config, state, epochs) -> (state, metric): train `state`
    (None on first call) for `epochs` more epochs, return updated state and
    the current validation metric."""

    def __init__(self, trainable: Callable, search_space: Dict[str, Any],
                 metric_mode: str = "min", n_sampling: int = 4,
                 epochs: int = 1, grace_epochs: int = 1, eta: int = 2,
                 seed: int = 0, parallelism: int = 1,
                 backend: str = "thread",
                 search_algorithm: str = "random"):
        self.trainable = trainable
        self.search_space = search_space
        self.mode = metric_mode
        if metric_mode not in ("min", "max"):
            raise ValueError("metric_mode must be 'min' or 'max'")
        if backend not in ("thread", "process", "device"):
            raise ValueError(
                "backend must be 'thread', 'process' or 'device'")
        if search_algorithm not in ("random", "tpe"):
            raise ValueError(
                "search_algorithm must be 'random' or 'tpe' (the "
                "reference's skopt/bayesopt role is filled by TPE)")
        self.search_algorithm = search_algorithm
        self.n_sampling = n_sampling
        self.epochs = epochs
        self.grace_epochs = max(1, grace_epochs)
        self.eta = max(2, eta)
        self.rng = random.Random(seed)
        self.parallelism = max(1, int(parallelism))
        self.backend = backend
        self.trials: List[Trial] = []
        # process backend hooks this to evict culled trials from workers
        self._free_trial: Optional[Callable[[Trial], None]] = None

    # ------------------------------------------------------------------

    def _configs(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.search_space.items()
                     if isinstance(v, hp_mod.GridSearch)]
        if grid_keys:
            # cartesian product over grid axes; non-grid hyperparameters are
            # sampled ONCE and held fixed across combos so the grid compares
            # like with like (n_sampling does not apply to grid mode)
            base = hp_mod.sample_config(self.search_space, self.rng)
            grids = [self.search_space[k].grid_values() for k in grid_keys]
            configs = []
            for combo in itertools.product(*grids):
                cfg = dict(base)
                cfg.update(dict(zip(grid_keys, combo)))
                configs.append(cfg)
            return configs
        n = self.n_sampling
        if self.search_algorithm == "tpe":
            # warm-up half at random; the rest are TPE-sampled after the
            # first rung's observations arrive (BOHB-style)
            n = max(2, n // 2)
        return [hp_mod.sample_config(self.search_space, self.rng)
                for _ in range(n)]

    def _sort_key(self, t: "Trial"):
        """NaN metrics (diverged trials) always rank worst."""
        import math
        m = t.best_metric
        if m is None or math.isnan(m):
            return math.inf
        return m if self.mode == "min" else -m

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    # -- TPE (Tree-structured Parzen Estimator) -------------------------
    #
    # The reference plugs skopt/bayesopt into Ray Tune
    # (ray_tune_search_engine.py search_alg); here the model-based
    # sampler is hyperopt's TPE, dependency-free: observations split
    # into good/bad by metric quantile, candidates are drawn from a
    # kernel density over the GOOD configs and ranked by the density
    # ratio l(x)/g(x).

    _TPE_GAMMA = 0.3          # good-quantile fraction
    _TPE_CANDIDATES = 24      # candidates scored per new trial

    def _tpe_split(self):
        scored = [t for t in self.trials if t.best_metric is not None
                  and not math.isnan(t.best_metric)]
        scored.sort(key=self._sort_key)
        n_good = max(1, int(len(scored) * self._TPE_GAMMA))
        return scored[:n_good], scored[n_good:]

    def _tpe_sample_config(self, good: List[Trial],
                           bad: List[Trial]) -> Dict[str, Any]:
        def density(values, x, lo, hi):
            """Parzen estimate over observed numeric values."""
            if not values:
                return 1.0
            bw = max((hi - lo) / max(len(values), 1), 1e-12)
            return sum(
                math.exp(-0.5 * ((x - v) / bw) ** 2) for v in values
            ) / (len(values) * bw) + 1e-12

        cfg = {}
        for key, space in self.search_space.items():
            if not isinstance(space, hp_mod.SampleSpace):
                cfg[key] = space
                continue
            g_vals = [t.config[key] for t in good]
            b_vals = [t.config[key] for t in bad]
            if isinstance(space, (hp_mod.Choice, hp_mod.GridSearch)):
                cats = space.grid_values()
                # categorical TPE: counts in the good set + uniform prior
                weights = [1.0 + sum(1 for v in g_vals if v == c)
                           for c in cats]
                total = sum(weights)
                r = self.rng.random() * total
                acc = 0.0
                cfg[key] = cats[-1]
                for c, w in zip(cats, weights):
                    acc += w
                    if r <= acc:
                        cfg[key] = c
                        break
                continue
            log = isinstance(space, hp_mod.LogUniform)
            xform = math.log if log else (lambda v: v)
            g_obs = [xform(v) for v in g_vals]
            b_obs = [xform(v) for v in b_vals]
            lo = min(g_obs + b_obs, default=0.0)
            hi = max(g_obs + b_obs, default=1.0)
            best_x, best_score = None, -math.inf
            for _ in range(self._TPE_CANDIDATES):
                # draw from the good-KDE: gaussian around a good point
                if g_obs:
                    center = self.rng.choice(g_obs)
                    bw = max((hi - lo) / max(len(g_obs), 1), 1e-12)
                    x = self.rng.gauss(center, bw)
                else:
                    x = xform(space.sample(self.rng))
                score = (density(g_obs, x, lo, hi)
                         / density(b_obs, x, lo, hi))
                if score > best_score:
                    best_x, best_score = x, score
            raw = math.exp(best_x) if log else best_x
            # clamp to the space's EXACT bounds and honor its value
            # contract (ints for RandInt, q-steps for QUniform)
            if log:
                raw = min(max(raw, math.exp(space.log_lower)),
                          math.exp(space.log_upper))
            elif isinstance(space, hp_mod.RandInt):
                raw = int(min(max(round(raw), space.lower),
                              space.upper - 1))
            elif isinstance(space, hp_mod.QUniform):
                raw = round(raw / space.q) * space.q
                raw = min(max(raw, space.lower), space.upper)
            else:
                raw = min(max(raw, space.lower), space.upper)
            cfg[key] = raw
        return cfg

    def run(self) -> Trial:
        self.trials = [Trial(i, c) for i, c in enumerate(self._configs())]
        if self.backend == "device":
            if self.parallelism > 1:
                logger.info(
                    "backend='device': %d-way parallelism requested but "
                    "the card cannot be shared — trials serialize "
                    "through the device lease",
                    self.parallelism)
            best = self._run_rungs(self._train_batch_device)
        elif self.parallelism > 1 and self.backend == "process":
            best = self._run_with_process_pool()
        else:
            train_batch = (self._train_batch_threaded
                           if self.parallelism > 1
                           else self._train_batch_serial)
            best = self._run_rungs(train_batch)
        return best

    # -- rung scheduling (shared across backends) -----------------------

    def _run_rungs(self, train_batch: Callable[[List[Tuple[Trial, int]]],
                                               None]) -> Trial:
        alive = list(self.trials)
        budget = self.grace_epochs
        grid_mode = any(isinstance(v, hp_mod.GridSearch)
                        for v in self.search_space.values())
        # grid mode compares like with like — TPE must not pollute it
        tpe_pending = (self.search_algorithm == "tpe" and not grid_mode
                       and len(self.trials) < self.n_sampling)
        while alive:
            # a lone survivor always trains to the full epoch budget
            if len(alive) == 1 and not tpe_pending:
                budget = self.epochs
            work = []
            for t in alive:
                add = min(budget, self.epochs) - t.epochs_trained
                if add > 0:
                    work.append((t, add))
            train_batch(work)
            if tpe_pending:
                # first-rung observations are in: spend the remaining
                # sampling budget on model-guided configs at the same rung
                tpe_pending = False
                good, bad = self._tpe_split()
                fresh = []
                for _ in range(self.n_sampling - len(self.trials)):
                    t = Trial(len(self.trials),
                              self._tpe_sample_config(good, bad))
                    self.trials.append(t)
                    fresh.append(t)
                if fresh:
                    train_batch([(t, min(budget, self.epochs))
                                 for t in fresh])
                    alive = alive + fresh
            # errored trials are dead regardless of rank
            alive = [t for t in alive if not t.stopped]
            if budget >= self.epochs or not alive:
                break
            # successive halving: keep the top 1/eta (NaN trials drop first)
            alive.sort(key=self._sort_key)
            keep = max(1, len(alive) // self.eta)
            for t in alive[keep:]:
                t.stopped = True
                if self._free_trial is not None:
                    self._free_trial(t)
            alive = alive[:keep]
            budget = min(self.epochs, budget * self.eta)
        # rank finishers first: a culled trial's early-rung metric is not
        # comparable to a survivor's full-budget metric (and the process
        # backend has already freed culled trials' states)
        finishers = [t for t in self.trials
                     if not t.stopped and t.best_metric is not None]
        candidates = finishers or [t for t in self.trials
                                   if t.best_metric is not None]
        if not candidates:
            raise RuntimeError("all trials failed before reporting a metric")
        best = min(candidates, key=self._sort_key)
        if best.best_metric is None or math.isnan(best.best_metric):
            raise RuntimeError(
                "all trials diverged (NaN metrics); widen/lower the "
                "learning-rate space")
        return best

    def _record(self, t: Trial, add: int, metric: float,
                error: Optional[str] = None):
        if error is not None:
            logger.warning("trial %d failed: %s", t.trial_id, error)
            t.error = error
            t.stopped = True
            t.metric_history.append(float("nan"))
            if self._free_trial is not None:
                self._free_trial(t)
            return
        t.epochs_trained += add
        t.metric_history.append(float(metric))

    # -- executors ------------------------------------------------------

    def _train_batch_serial(self, work: List[Tuple[Trial, int]],
                            trial_cm: Optional[Callable] = None):
        """One-at-a-time trials; `trial_cm(trial)` (if given) wraps each
        trainable call — the device backend passes the accelerator
        lease here so the error-recording protocol lives once."""
        from contextlib import nullcontext

        for t, add in work:
            try:
                with (trial_cm(t) if trial_cm else nullcontext()):
                    t.state, metric = self.trainable(t.config, t.state,
                                                     add)
            except Exception as e:
                self._record(t, add, 0.0, f"{type(e).__name__}: {e}")
            else:
                self._record(t, add, metric)

    def _train_batch_device(self, work: List[Tuple[Trial, int]]):
        """Card-bound trials: in-process, one at a time through the
        host's accelerator lease.  Other lease users in this process
        (serving loads, benchmark stages, a concurrent search)
        interleave safely at trial boundaries."""
        from analytics_zoo_tpu_torch.common.device_lease import device_lease

        self._train_batch_serial(
            work, lambda t: device_lease(f"automl-trial-{t.trial_id}"))

    def _train_batch_threaded(self, work: List[Tuple[Trial, int]]):
        """Concurrent trials in-process: torch's ops release the GIL, so
        CPU trials overlap on the host's cores."""
        from concurrent.futures import ThreadPoolExecutor

        def one(item):
            t, add = item
            return self.trainable(t.config, t.state, add)

        with ThreadPoolExecutor(self.parallelism) as ex:
            futures = [(t, add, ex.submit(one, (t, add)))
                       for t, add in work]
            for t, add, fut in futures:
                try:
                    t.state, metric = fut.result()
                except Exception as e:
                    self._record(t, add, 0.0, f"{type(e).__name__}: {e}")
                else:
                    self._record(t, add, metric)

    # -- process backend (Ray-actor analog) -----------------------------

    def _run_with_process_pool(self) -> Trial:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # never fork a live CUDA context
        n_workers = min(self.parallelism, len(self.trials))
        workers, conns = [], []
        # workers must see no card, so they never contend for it; the
        # CUDA runtime reads this variable when the child starts it, so
        # export it for the duration of the spawns
        prev_visible = os.environ.get(_VISIBLE)
        os.environ[_VISIBLE] = ""

        def owner(t: Trial):
            return conns[t.trial_id % n_workers]

        def train_batch(work: List[Tuple[Trial, int]]):
            by_tid = {}
            for t, add in work:
                owner(t).send(("train", t.trial_id, t.config, add))
                by_tid[t.trial_id] = (t, add)
            for t, add in work:  # one reply per request, per owner, FIFO
                status, tid, payload = owner(t).recv()
                tt, aa = by_tid[tid]
                if status == "ok":
                    self._record(tt, aa, payload)
                else:
                    self._record(tt, aa, 0.0, payload)

        self._free_trial = lambda t: owner(t).send(("free", t.trial_id))
        try:
            # spawning inside the try: a failed spawn (unpicklable
            # trainable, fd exhaustion) must still tear down the workers
            # already started
            for _ in range(n_workers):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_process_worker_main,
                                args=(child, self.trainable), daemon=True)
                p.start()
                conns.append(parent)
                workers.append(p)
            _restore_env(_VISIBLE, prev_visible)
            best = self._run_rungs(train_batch)
            owner(best).send(("export", best.trial_id))
            status, _, payload, err = owner(best).recv()
            if err is not None:
                raise RuntimeError(
                    f"best-trial export from worker failed: {err}")
            # ("estimator", (params, model_state)) or ("raw", state)
            best.state = payload
            return best
        finally:
            _restore_env(_VISIBLE, prev_visible)
            self._free_trial = None
            for c in conns:
                try:
                    c.send(("stop",))
                    c.close()
                except (BrokenPipeError, OSError):
                    pass
            for p in workers:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()

    def trial_table(self) -> List[Dict[str, Any]]:
        return [{"trial_id": t.trial_id, "config": t.config,
                 "metric": t.best_metric, "epochs": t.epochs_trained,
                 "stopped": t.stopped, "error": t.error}
                for t in self.trials]
