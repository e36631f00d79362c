"""The job of the port's elastic-driver tests (tests/test_torch_elastic.py):
a small MLP trained with Adam on deterministic batches, a committed
checkpoint each epoch, a heartbeat and the `train.step` fault site a
step.  Run as a script it is one process member of the driver: it
resumes from the checkpoint it is given, SIGKILLs itself at a step when
told to (a preempted member gets no goodbye), and writes its final
weights.  torch and the port only: the member imports no JAX."""

import os
import signal
import sys

import numpy as np
import torch

DIM, BATCH, EPOCHS, STEPS = 8, 16, 4, 4


def _batch(epoch, step):
    r = np.random.default_rng(1000 * epoch + step)
    x = r.normal(size=(BATCH, DIM)).astype(np.float32)
    w = np.random.default_rng(7).normal(size=(DIM, 1)).astype(np.float32)
    y = x @ w + 0.01 * r.normal(size=(BATCH, 1)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.float32))


def _init():
    ri = np.random.default_rng(3)
    model = torch.nn.Sequential(torch.nn.Linear(DIM, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                (0.1 * ri.normal(size=tuple(p.shape))).astype(np.float32)))
    return model, torch.optim.Adam(model.parameters(), lr=1e-2)


def run_job(ckpt_dir, resume, beat, on_step=None):
    """Train from `resume` (a committed checkpoint, or None) to the last
    epoch; `beat()` before each step, `on_step(epoch, step)` after the
    fault site.  Returns the final state_dict."""
    from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from analytics_zoo_tpu_torch.resilience import fault_point

    model, opt = _init()
    start = 0
    if resume:
        state = load_checkpoint(resume)
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        start = int(resume.rsplit("-", 1)[1]) + 1
    for epoch in range(start, EPOCHS):
        for step in range(STEPS):
            beat()
            fault_point("train.step", epoch=epoch, step=step)
            if on_step is not None:
                on_step(epoch, step)
            x, y = _batch(epoch, step)
            opt.zero_grad()
            torch.mean((model(x) - y) ** 2).backward()
            opt.step()
        save_checkpoint(os.path.join(ckpt_dir, f"ckpt-{epoch}"),
                        {"model": model.state_dict(),
                         "opt": opt.state_dict()}, block=True)
    return model.state_dict()


def main(argv):
    """argv: checkpoint dir, output file, attempt, resume ("" = none),
    heartbeat dir, worker id, the step to die at on attempt 1 as
    "epoch:step" ("" = none)."""
    ckpt_dir, out, attempt, resume, hb_dir, wid, kill_at = argv
    torch.set_num_threads(1)
    from analytics_zoo_tpu_torch.resilience import touch_heartbeat

    def on_step(epoch, step):
        if int(attempt) == 1 and kill_at == f"{epoch}:{step}":
            os.kill(os.getpid(), signal.SIGKILL)

    state = run_job(ckpt_dir, resume or None,
                    lambda: touch_heartbeat(hb_dir, int(wid)), on_step)
    torch.save(state, out)


if __name__ == "__main__":
    main(sys.argv[1:])
