"""What the port's Chronos tests share: one torch thread per test
process, and the comparisons' helpers.

The port's Chronos models are small, so every torch op is a few
microseconds of work; at torch's default thread count each op also
pays a parallel region, and with the suite's xdist workers on the same
cores those regions wait for each other (an AutoTS search took 93 s in
six concurrent processes at 8 threads, 2.3 s at 1).  `one_torch_thread`
runs a module's tests at one thread and restores the count after;
`two_torch_threads` at two.  Import one of them into a test module to
apply it there."""

import numpy as np
import pytest
import torch

#: f32 predictions: |port - JAX| <= TOL * max(1, |JAX|)
TOL = 1e-5
#: first-step gradients: |port - JAX| <= GRAD_TOL * max |JAX| per tensor
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """For a module whose comparisons need torch's parallel reductions:
    test_torch_imageclassification.py's ragged fits against JAX's fast
    variance sit near their tolerance at one thread, and hold at 2."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(2, prev))
    yield
    torch.set_num_threads(prev)


def close(got, want, tol=TOL):
    """|got - want| <= tol * max(1, |want|) everywhere, shapes equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def grads_close(got_tree, want_tree, tol=GRAD_TOL, zero=()):
    """Each leaf of two flax-layout trees within tol of the JAX leaf's
    largest magnitude.  The leaves named in `zero` ("a/b/bias") have an
    exact gradient of 0: both sides there are rounding noise, each held
    within tol of the largest gradient of the whole tree."""
    import jax
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert len(got) == len(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for path, g in got:
        w, g = np.asarray(want[path]), np.asarray(g)
        if "/".join(str(k.key) for k in path) in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= tol * top, path
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, (path, scale)


def same(got, want):
    """Equal outputs, exactly, recursively over tuples, lists and
    dicts; DataFrames by `assert_frame_equal(check_exact=True)`."""
    import pandas as pd
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            same(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def series_matrix(n, T, seed=0):
    """[n, T] f32 series: a low-rank seasonal mix plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    basis = np.stack([np.sin(0.2 * t), np.cos(0.13 * t),
                      np.sin(0.07 * t + 1.0)])
    return (rng.normal(size=(n, 3)) @ basis
            + 0.1 * rng.normal(size=(n, T))).astype(np.float32)
