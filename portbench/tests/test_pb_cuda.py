"""The harness on the card, through the port's CUDA kernels, at small
sizes: each cell's runner is correct under its limits, and the control
(the reference in float8 in the program's place) reads at least three
times the program on one of the compared numbers and is not correct
under the cell's limits.  Run on the chip
with ``python -m pytest -m cuda portbench/tests/test_pb_cuda.py``;
skipped without a card.  The full-size control runs by
``portbench/control.py`` (PERF.md)."""
from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny
from portbench import judge, manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


SIZES = {"granite-8b.fleet": dict(tiny.GRANITE),
         "granite-8b.train": dict(tiny.GRANITE),
         "zamba2-7b.train": dict(tiny.ZAMBA, ssm_chunk=128)}


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_cell_is_correct_and_its_control_reads_three_times(
        card, workload, monkeypatch):
    if workload.endswith(".train"):
        real = tiny.mix

        def mix(w):
            return dict(real(w), seq=256)

        monkeypatch.setattr(tiny, "mix", mix)
    out, ctx = tiny.drive(workload, card, p=SIZES[workload], control=True)
    limits = manifest.limits(workload)["limits"]
    assert judge.verdict(out["numbers"], limits)[0], out["numbers"]
    ctl = ctx.readings["control"]
    assert any(ctl[k] >= 3 * out["numbers"][k] and ctl[k] > 0
               for k in limits), (ctl, out["numbers"])
    assert not judge.verdict(ctl, limits)[0], (ctl, limits)
