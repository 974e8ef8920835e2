"""The dense Qwen archs (qwen1.5-110b, qwen2.5-32b, qwen1.5-32b: QKV bias,
GQA at G = 2 and 5, MHA) in the port against the JAX reference on the
CPU at SMOKE size, f32, the same weights carried across by the bridge:
forward and decode, the joint loss and its gradients, three AdamW steps,
MonitorSession sync and scan, greedy generation, and the bridge with
checkpoints both ways.  The cases are in tests/_torch_families.py; the
MoE family's are in tests/test_torch_moe.py.

Tolerances: whole towers f32 1e-4 (``TOL_E2E``); trigger traces exact
outside the tie band, whose size each session test prints.
"""
import pytest
import torch

import _torch_families as fam

ARCHS = ("qwen1.5-110b", "qwen2.5-32b", "qwen1.5-32b")


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one intra-op thread is as fast alone and does not
    thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference(arch):
    fam.forward_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    fam.loss_and_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    fam.train_steps(arch)


@pytest.mark.parametrize("mode", ["sync", "scan"])
@pytest.mark.parametrize("arch", ARCHS)
def test_session_matches_jax_session(arch, mode):
    fam.session(arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_equals_scan_in_the_port(arch):
    fam.sync_equals_scan(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    fam.greedy_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_checkpoints_cross_both_ways(arch, tmp_path):
    fam.bridge_and_checkpoint(arch, tmp_path)
