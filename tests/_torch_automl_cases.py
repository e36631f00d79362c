"""Picklable trainables and model creators for the AutoML tests
(`tests/test_torch_automl.py`): the process backend's spawned workers
import this module, which loads numpy, torch and the port only."""

import os

import numpy as np
import torch

#: the data of the Estimator trials: y = x @ W + noise
_RNG = np.random.default_rng(0)
X = _RNG.normal(size=(128, 4)).astype(np.float32)
W = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
Y = (X @ W + 0.01 * _RNG.normal(size=128)).astype(np.float32)


def proc_trainable(config, state, add_epochs):
    """Cheap math; raises where the worker could see a CUDA device."""
    if os.environ.get("CUDA_VISIBLE_DEVICES") != "" \
            or torch.cuda.is_available():
        raise RuntimeError("a trial worker sees a CUDA device")
    count = (state or 0) + add_epochs
    return count, config["p"] + 0.01 * count


def counting_trainable(config, state, add_epochs):
    """The metric improves with epochs, so the rungs matter."""
    trained = (state or 0) + add_epochs
    return trained, config["p"] / trained


class TinyEst:
    """Minimal picklable Estimator-contract object for the worker
    export (JAX's `_TinyEst`, with the port's `set_params`)."""

    def __init__(self, lr):
        self.lr = lr
        self.loss = 10.0
        self.params = None

    def fit(self, data, epochs=1, batch_size=32, feature_cols=None,
            label_cols=None):
        for _ in range(epochs):
            self.loss *= self.lr
        return self

    def evaluate(self, data, batch_size=32, feature_cols=None,
                 label_cols=None):
        return {"loss": self.loss}

    def get_model(self):
        return {"w": np.float64(self.loss)}

    def get_model_state(self):
        return {"count": torch.tensor([3])}

    def set_params(self, params):
        self.params = params
        return self


def tiny_creator(config):
    return TinyEst(config["lr"])


class MLP(torch.nn.Module):
    def __init__(self, width):
        super().__init__()
        self.fc1 = torch.nn.Linear(4, width)
        self.fc2 = torch.nn.Linear(width, 1)
        self.register_buffer("seen", torch.zeros(()))

    def forward(self, a):
        if self.training:
            self.seen += a.shape[0]
        return self.fc2(torch.relu(self.fc1(a)))[..., 0]


def mlp_creator(config):
    """An `Estimator.from_torch` of a small MLP on the CPU, its weights
    drawn from the config's seed."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(config.get("seed", 0)))
        model = MLP(int(config["width"]))
    return Estimator.from_torch(model, loss="mse", optimizer="adam",
                                learning_rate=float(config["lr"]))
