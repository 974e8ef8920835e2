"""The readers of the training step's ranges (``forward_ms.train``,
``backward_ms.train``, ``backward_idle_share.train``) on made-up profile
summaries: complete and incomplete traces, and a program whose trace has
no such range (the readers then return nothing)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import manifest

FORWARD = manifest.reader("forward_ms.train")
BACKWARD = manifest.reader("backward_ms.train")
IDLE = manifest.reader("backward_idle_share.train")


def run(*, complete=True, ranges=None, idle_gaps=None, steps=2,
        window_s=4.0):
    ranges = {"train.forward": 0.6, "train.backward": 2.4,
              "adamw_update": 0.24} if ranges is None else ranges
    idle_gaps = ([["train.backward", 0.2], ["host outside any op", 0.01]]
                 if idle_gaps is None else idle_gaps)
    return SimpleNamespace(profile={
        "complete": complete, "ranges": ranges, "idle_gaps": idle_gaps,
        "steps": steps, "window_s": window_s, "busy_s": 3.5})


def test_device_ms_a_step():
    assert FORWARD(run()) == pytest.approx(300.0)
    assert BACKWARD(run()) == pytest.approx(1200.0)
    assert BACKWARD(run(steps=1)) == pytest.approx(2400.0)


def test_backward_idle_share_of_the_window():
    assert IDLE(run()) == pytest.approx(5.0)
    assert IDLE(run(window_s=2.0)) == pytest.approx(10.0)


@pytest.mark.parametrize("reader", [FORWARD, BACKWARD, IDLE])
def test_incomplete_trace_reads_nothing(reader):
    assert reader(run(complete=False)) is None


@pytest.mark.parametrize("reader", [FORWARD, BACKWARD, IDLE])
def test_program_without_the_ranges_reads_nothing(reader):
    """The parent commit's program opens only ``adamw_update`` and the
    kernels' backward ranges."""
    prof = run(ranges={"adamw_update": 0.24,
                       "flash_attention_backward": 0.35},
               idle_gaps=[["host outside any op", 0.2]])
    assert reader(prof) is None


def test_backward_idle_missing_from_the_gaps():
    """A short list holds every name that had a gap: a missing name had
    none.  A full list of 10 dropped the smaller ones: unknown."""
    short = [["host outside any op", 0.2], ["aten::mm", 0.001]]
    assert IDLE(run(idle_gaps=short)) == 0.0
    full = [[f"aten::op{i}", 0.01] for i in range(10)]
    assert IDLE(run(idle_gaps=full)) is None
    assert IDLE(run(idle_gaps=full[:9] + [["train.backward", 0.04]])) == \
        pytest.approx(1.0)
