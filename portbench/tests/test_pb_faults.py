"""The comparison that decides ``correct`` fails when the timed path is
broken underneath: the rest of a run (set-up, window, check against the
reference, the cell's limits) is driven at a small size on the CPU, with
the harness's look for a chip skipped, and each fault the cell can have
planted in the program.  A sound run at the same size is correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench import judge, manifest

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def correct(workload: str, **kw) -> bool:
    out, _ = tiny.drive(workload, CPU, **kw)
    return judge.verdict(out["numbers"],
                         manifest.limits(workload)["limits"])[0]


# -- the fleet --------------------------------------------------------------

def _state_unchanged(monkeypatch):
    """The catch-up's cache writes never commit: every round decodes with
    its row masked out."""
    from repro_torch.serving import collaborative
    real = collaborative.step_at

    def step_at(params, cfg, cache, tokens, pos, active, **kw):
        return real(params, cfg, cache, tokens, pos,
                    torch.zeros_like(active), **kw)

    monkeypatch.setattr(collaborative, "step_at", step_at)


def _half_batch(monkeypatch):
    """Only the first half of the slots' alarms are caught up; the others
    keep fhat = u."""
    from repro_torch.serving.collaborative import CollaborativeEngine
    real = CollaborativeEngine._catchup

    def catchup(self, params, cache, server_pos, t, triggered, u):
        half = np.array(triggered, copy=True)
        half[len(half) // 2:] = False
        if not half.any():
            return None, u
        return real(self, params, cache, server_pos, t, half, u)

    monkeypatch.setattr(CollaborativeEngine, "_catchup", catchup)


def _token_altered(monkeypatch):
    """Stream 0's token is altered where the history records it, so the
    server replays a token the stream never sent."""
    from repro_torch.serving import collaborative
    real = collaborative.record_history

    def record(history, tokens_t, idx, active):
        tokens_t = tokens_t.clone()
        tokens_t[0] = (tokens_t[0] + 1) % 512
        real(history, tokens_t, idx, active)

    monkeypatch.setattr(collaborative, "record_history", record)


def _answer_altered(monkeypatch):
    """Stream 0's verdict is altered where the combine produces it: its
    correction applied twice."""
    from repro_torch.serving.collaborative import CollaborativeEngine
    real = CollaborativeEngine._fuse

    def fuse(self, u, v, triggered):
        out = real(self, u, v, triggered).clone()
        out[0] = 2 * out[0] - u[0]
        return out

    monkeypatch.setattr(CollaborativeEngine, "_fuse", fuse)


def test_fleet_sound_run_is_correct():
    assert correct("granite-8b.fleet")


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered, _answer_altered])
def test_fleet_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not correct("granite-8b.fleet")


# -- training ---------------------------------------------------------------

def _train_state_unchanged(monkeypatch):
    """The optimizer computes the gradients' norm and changes nothing."""
    from repro_torch.training import optimizer

    def update(self, grads, state, params):
        state.count += 1
        return optimizer.global_norm([g.float() for g in grads])

    monkeypatch.setattr(optimizer.AdamW, "update", update)


def _train_half_batch(monkeypatch):
    """Each step sees the first half of its batch's rows: the mean is
    taken over the rest."""
    from repro_torch.training import loop
    real = loop.make_train_step

    def make(cfg, opt, **kw):
        step = real(cfg, opt, **kw)

        def half(model, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(model, state, {k: v[:n] for k, v in batch.items()})

        return half

    monkeypatch.setattr(loop, "make_train_step", make)


@pytest.mark.parametrize("workload", ["granite-8b.train", "zamba2-7b.train"])
def test_train_sound_run_is_correct(workload):
    assert correct(workload)


@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_batch])
@pytest.mark.parametrize("workload", ["granite-8b.train", "zamba2-7b.train"])
def test_train_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    assert not correct(workload)


@pytest.mark.parametrize("workload", ["granite-8b.fleet", "granite-8b.train",
                                      "zamba2-7b.train"])
def test_control_reads_three_times_the_program(workload):
    """The control (the reference in float8 in the program's place) at the
    small size reads at least three times the program on one of the
    cell's compared numbers and is not correct under the cell's limits,
    as it must at the cell's size."""
    out, ctx = tiny.drive(workload, CPU, control=True)
    limits = manifest.limits(workload)["limits"]
    ctl = ctx.readings["control"]
    assert any(ctl[k] >= 3 * out["numbers"][k] and ctl[k] > 0
               for k in limits), (ctl, out["numbers"])
    assert not judge.verdict(ctl, limits)[0], (ctl, limits)
