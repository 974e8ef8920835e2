"""The port's kernels as ``torch.library`` ops (``kernels/ops.py``) under
graph capture, on the CPU.

Each op exports as one ``repro_torch.*`` node, with no ``aten.empty*``
left where a shape function once stood for the kernel; the exported
``collab_forward`` (granite-8b SMOKE) and the per-element decode
``step_at``, cache writes included, equal eager bitwise (before the ops
were registered, an export computed on uninitialised memory); every op
passes ``torch.library.opcheck``; and the dry run's counters (the fake
implementations' FLOPs and bytes) are the shape functions' own.
"""
import copy

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import signs
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssd_flops


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, seed=0):
    """Small seeded inputs of each op, and its non-tensor arguments."""
    g = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32))
    pos = torch.tensor([3, 6], dtype=torch.int32)
    return {
        "decode_attention": (t(2, 4, 32), t(2, 8, 2, 32), t(2, 8, 2, 32),
                             pos),
        "decode_attention_partial": (t(2, 4, 32), t(2, 4, 2, 32),
                                     t(2, 4, 2, 32), pos, 4),
        "monitor_combine": (t(8), t(8), t(8), 0.2, 0.1, 0.25),
        "flash_attention_fwd": (t(1, 16, 4, 32), t(1, 16, 2, 32),
                                t(1, 16, 2, 32), 0),
        "ssd_scan_fwd": (t(1, 32, 2, 16), -torch.from_numpy(
            g.random((1, 32, 2)).astype(np.float32)), t(1, 32, 16),
            t(1, 32, 16), 16),
    }[name]


class _Call(torch.nn.Module):
    def __init__(self, op, statics):
        super().__init__()
        self.op, self.statics = op, statics

    def forward(self, *tensors):
        it = iter(tensors)
        return self.op(*[next(it) if s is None else s for s in self.statics])


def _split(args):
    return (tuple(None if isinstance(a, torch.Tensor) else a for a in args),
            tuple(a for a in args if isinstance(a, torch.Tensor)))


@pytest.mark.parametrize("name", sorted(ops.OPS))
def test_op_exports_as_one_node(name):
    args = _inputs(name)
    statics, tensors = _split(args)
    ep = signs.export_graph(_Call(ops.OPS[name], statics), tensors)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count(f"repro_torch.{name}.default") == 1, targets
    assert not [t for t in targets if "empty" in t], targets
    out, want = ep.module()(*tensors), ops.OPS[name](*args)
    for a, b in zip(tree_leaves(out), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(ops.OPS))
def test_opcheck(name):
    torch.library.opcheck(ops.OPS[name], _inputs(name))


def _export_equal(module, args, mutated):
    """Export ``module`` at ``args``; run the program and eager on copies
    of ``args``; assert the outputs and every leaf of ``mutated(args)``
    (the inputs written in place) equal bitwise, and that they moved."""
    ep = signs.export_graph(module, args)
    a, b = copy.deepcopy(args), copy.deepcopy(args)
    with torch.no_grad():
        got, want = ep.module()(*a), module(*b)
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(x, y)
    moved = False
    for x, y, z in zip(tree_leaves(mutated(a)), tree_leaves(mutated(b)),
                       tree_leaves(mutated(args))):
        assert torch.equal(x, y)
        moved |= not torch.equal(x, z)
    return ep, moved


def test_exported_collab_forward_is_bitwise_eager():
    cfg = registry.get_smoke("granite-8b")
    model = signs._model(cfg, "cpu")
    batch = signs.forward_batch(cfg, 2, 8, "cpu")
    ep, _ = _export_equal(signs._Forward(model, cfg), (batch,),
                          lambda a: [])
    targets = [str(n.target) for n in ep.graph.nodes]
    # the server's and the edge tower's layers, each one flash node
    assert targets.count("repro_torch.flash_attention_fwd.default") == \
        cfg.n_layers + cfg.monitor.n_layers
    assert not [t for t in targets if "empty" in t]


class _StepAt(torch.nn.Module):
    def __init__(self, params, cfg):
        super().__init__()
        self.params, self.cfg = params, cfg

    def forward(self, cache, tokens, pos, active):
        from repro_torch.serving.engine import step_at
        return step_at(self.params, self.cfg, cache, tokens, pos, active)


def test_exported_step_at_is_bitwise_eager_cache_writes_included():
    from repro_torch.models import api
    cfg = registry.get_smoke("granite-8b")
    model = signs._model(cfg, "cpu")
    cache = api.init_cache(cfg, 3, 8, "cpu")
    g = torch.Generator().manual_seed(1)
    for leaf in tree_leaves(cache):     # a cache some steps in
        leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
    tokens = torch.tensor([5, 7, 11])
    pos = torch.tensor([2, 0, 5], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    ep, moved = _export_equal(_StepAt(model.server, cfg),
                              (cache, tokens, pos, active), lambda a: a[0])
    assert moved
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count("repro_torch.decode_attention.default") \
        == cfg.n_layers
    assert not [t for t in targets if "empty" in t]


def _expected(name, args):
    """The shape functions' counts, as the dry run has read them."""
    if name == "decode_attention":
        q, k = args[0], args[1]
        B, Hq, D = q.shape
        C, Hkv = k.shape[1], k.shape[2]
        return (4.0 * B * Hq * C * D, 2 * q.numel() * 4
                + 2 * B * C * Hkv * D * 4 + 4 * B)
    if name == "decode_attention_partial":
        q, k = args[0], args[1]
        B, Hq, D = q.shape
        C, Hkv = k.shape[1], k.shape[2]
        return (4.0 * B * Hq * C * D, (q.numel() * 2 + B * Hq) * 4
                + 2 * B * C * Hkv * D * 4 + 4 * B)
    if name == "monitor_combine":
        n = args[0].shape[0]
        return 8.0 * n, 3 * 4 * n + 2 * 4 * n + 8
    if name == "flash_attention_fwd":
        q, k, v = args[:3]
        B, S, Hq, D = q.shape
        pairs = ops.attention_pairs(S, k.shape[1], args[3])
        return (2.0 * B * Hq * (D + v.shape[3]) * pairs,
                4 * (q.numel() + k.numel() + v.numel() + q.numel()
                     + B * Hq * S))
    xdt, la, Bm = args[0], args[1], args[2]
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    return (ssd_flops(B, S, H, args[4], P, N),
            4 * (2 * xdt.numel() + la.numel() + 2 * Bm.numel()
                 + B * H * P * N))


@pytest.mark.parametrize("device", ["fake", "meta"])
@pytest.mark.parametrize("name", sorted(ops.OPS))
def test_dry_run_counters_unchanged(name, device):
    """A fake or meta call runs the shape function: outputs of the
    kernel's shapes and dtypes, no arithmetic, and the counts the dry run
    reads."""
    args = _inputs(name)
    want = ops.OPS[name](*args)
    counts = {}
    ops.shape_counters.append(counts)
    try:
        if device == "fake":
            with FakeTensorMode(allow_non_fake_inputs=True):
                out = ops.OPS[name](*args)
        else:
            out = ops.OPS[name](*[a.to("meta") if isinstance(
                a, torch.Tensor) else a for a in args])
    finally:
        ops.shape_counters.remove(counts)
    for o, w in zip(tree_leaves(out), tree_leaves(want)):
        assert (o.shape, o.dtype) == (w.shape, w.dtype)
    key = name.replace("_fwd", "")
    flops, n_bytes = _expected(name, args)
    assert counts == {key: {"calls": 1, "flops": float(flops),
                            "bytes": float(n_bytes)}}
