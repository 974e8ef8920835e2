"""The port's partition rules (repro_torch.distributed.sharding) against
the reference's (src/repro/distributed/sharding.py), mirroring
tests/test_sharding.py: for all 10 registry archs at FULL size, shape-only
(the port's modules on the meta device, ``jax.eval_shape`` on the
reference side), on the (16, 16) and (2, 16, 16) meshes, the parameter,
optimizer (ZeRO-1 and not), cache and batch specs equal the reference's
leaf for leaf.  No device is needed."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.distributed import sharding as jshd
from repro.models import api as japi
from repro.nn.module import iter_paths as jpaths
from repro_torch.configs import registry as treg
from repro_torch.core.decomposition import CollabLM
from repro_torch.distributed import sharding as shd
from repro_torch.models import api as tapi

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
KEY = jax.random.PRNGKey(0)
CACHE_B, CACHE_S = 128, 4096

_SHAPES = {}


def shapes(arch):
    """(the reference's param shapes, the port's FULL model on meta)."""
    if arch not in _SHAPES:
        jcfg = jreg.get_full(arch)
        _SHAPES[arch] = (
            jax.eval_shape(lambda: jdeco.init_collab_lm(KEY, jcfg)),
            CollabLM(treg.get_full(arch), "meta"))
    return _SHAPES[arch]


def ref_specs(tree):
    return {p: tuple(s) for p, s in jpaths(tree)}


def port_specs(tree):
    return dict(shd.iter_paths(tree))


@pytest.mark.parametrize("arch", jreg.names())
def test_param_and_opt_specs_match_reference(arch):
    jshapes, model = shapes(arch)
    want_shapes = {p: tuple(l.shape) for p, l in jpaths(jshapes)}
    got_shapes = port_specs(shd.param_shapes(model))
    assert got_shapes == want_shapes
    n_split = 0
    for sizes, names in MESHES:
        jm = jshd.abstract_mesh(sizes, names)
        tm = shd.abstract_mesh(sizes, names)
        want = ref_specs(jshd.param_specs(jshapes, jm))
        got = port_specs(shd.param_specs(model, tm))
        assert got == want, {p: (got[p], want[p]) for p in want
                             if got.get(p) != want[p]}
        n_split += sum(1 for s in got.values() if any(s))
        for zero1 in (False, True):
            assert port_specs(shd.opt_specs(model, tm, zero1=zero1)) == \
                ref_specs(jshd.opt_specs(jshapes, jm, zero1=zero1)), zero1
    assert n_split > 0


def _leaf_name(path: str) -> str:
    """A cache leaf's name in the port's layout: the reference keeps the
    VLM's image K/V as ``cross_k``/``cross_v`` and a hybrid's or xLSTM's
    trailing layers in a ``_tail`` entry of their own."""
    return (path.replace("cross_k", "cross/k").replace("cross_v", "cross/v")
            .replace("_tail", ""))


@pytest.mark.parametrize("arch", jreg.names())
def test_cache_specs_match_reference(arch):
    """Leaf for leaf from the batch axis on (zamba2 and the xLSTM stack a
    super-block's layers on one axis in the port, on two in the
    reference; those leading layer axes are never split)."""
    jc = jax.eval_shape(lambda: japi.init_cache(jreg.get_full(arch), CACHE_B,
                                                CACHE_S))
    tc = tapi.init_cache(treg.get_full(arch), CACHE_B, CACHE_S, "meta")
    tleaves = dict(shd.iter_paths(tc))
    for sizes, names in MESHES:
        jm = jshd.abstract_mesh(sizes, names)
        tm = shd.abstract_mesh(sizes, names)
        for kw in (dict(mode="heads"), dict(mode="time"),
                   dict(use_model=False)):
            want = jax.tree_util.tree_flatten_with_path(
                jshd.cache_specs(jc, jm, CACHE_B, **kw),
                is_leaf=lambda x: isinstance(x, P))[0]
            got = port_specs(shd.cache_specs(tc, tm, CACHE_B, **kw))
            jl = dict((jax.tree_util.keystr(p), l) for p, l in
                      jax.tree_util.tree_flatten_with_path(jc)[0])
            seen = set()
            for path, spec in want:
                key = jax.tree_util.keystr(path)
                name = _leaf_name(key.replace("['", "").replace("']", "/")
                                  .replace(".", "").strip("/"))
                assert name in got, (name, sorted(got))
                seen.add(name)
                k = len(tleaves[name].shape) - 1   # dims from the batch axis
                want_tail = tuple(spec)[-k:] if len(tuple(spec)) else ()
                got_tail = got[name][-k:] if got[name] else ()
                assert got_tail == want_tail, (name, kw, got[name], spec)
                assert all(a is None for a in tuple(spec)[:-k]), spec
                assert tuple(jl[key].shape)[-k:] == \
                    tuple(tleaves[name].shape)[-k:]
            assert seen == set(got), kw


def test_cache_specs_shard_batch_and_trailing():
    cfg = treg.get_full("granite-8b")
    cache = tapi.init_cache(cfg, 128, 32768, "meta")
    mesh = shd.abstract_mesh((16, 16), ("data", "model"))
    k_spec = shd.cache_specs(cache, mesh, 128)["blocks"].k
    assert k_spec[1] == "data" and "model" in k_spec and k_spec[2] is None
    time = shd.cache_specs(cache, mesh, 128, mode="time")["blocks"].k
    assert time[1] == "data" and time[2] == "model"
    assert all(ax is None for ax in time[3:])
    edge = shd.cache_specs(cache, mesh, 128, use_model=False)["blocks"].k
    assert "model" not in edge


@pytest.mark.parametrize("shape,batch", [((1, 524288), 1), ((256, 4096), 256),
                                         ((6, 4096), 6), ((8, 3, 5), 8)])
def test_batch_spec_matches_reference(shape, batch):
    for sizes, names in MESHES:
        got = shd.batch_spec(shd.abstract_mesh(sizes, names), shape, batch)
        want = jshd.batch_spec(jshd.abstract_mesh(sizes, names), shape,
                               batch)
        assert got == tuple(want), (sizes, shape)
    mesh = shd.abstract_mesh((16, 16), ("data", "model"))
    assert shd.batch_spec(mesh, (1, 524288), 1) == ()
    assert shd.replicated(mesh) == ()


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v3-671b",
                                  "zamba2-7b", "xlstm-350m"])
def test_monitor_tower_replicated(arch):
    _, model = shapes(arch)
    specs = shd.param_specs(model, shd.abstract_mesh(*MESHES[0]))
    for path, spec in shd.iter_paths(specs):
        if path.startswith(("edge/", "u_head/", "v_head/")):
            assert not any(spec), (path, spec)


def test_moe_expert_parallel_vs_ff_parallel():
    """deepseek-v3 (256 experts) splits experts; mixtral (8 on a 16-wide
    axis) splits d_ff."""
    mesh = shd.abstract_mesh(*MESHES[0])
    ds = port_specs(shd.param_specs(shapes("deepseek-v3-671b")[1], mesh))
    gate = [s for p, s in ds.items() if p.endswith("moe/w_gate")]
    assert gate and all(s[-3:] == ("model", None, None) for s in gate)
    mx = port_specs(shd.param_specs(shapes("mixtral-8x22b")[1], mesh))
    gate = [s for p, s in mx.items() if p.endswith("moe/w_gate")]
    assert gate and all(s[-3:] == (None, None, "model") for s in gate)


def test_opt_specs_zero1_widens_over_data():
    mesh = shd.abstract_mesh(*MESHES[0])
    _, model = shapes("deepseek-v3-671b")
    z1 = port_specs(shd.opt_specs(model, mesh, zero1=True))
    sh = port_specs(shd.param_shapes(model))
    gate = {p: s for p, s in z1.items() if p.endswith("moe/w_gate")}
    assert gate and all("data" in s for s in gate.values())
    for path, spec in z1.items():
        for dim, ax in zip(sh[path], spec):
            if ax is not None:
                n = np.prod([mesh.shape[a] for a in
                             (ax if isinstance(ax, tuple) else (ax,))])
                assert dim % n == 0, (path, spec)


def test_local_shard_blocks_reassemble():
    """Each position's block under a spec, laid back in mesh order, is the
    whole leaf; a tuple of axes splits over their product row-major."""
    mesh = shd.abstract_mesh((2, 2, 3), ("pod", "data", "model"))
    x = torch.arange(4 * 6 * 5).reshape(4, 6, 5)
    spec = (("pod", "data"), "model")
    blocks = {}
    for flat in range(mesh.size):
        c = mesh.coords(flat)
        blocks[(c["pod"] * 2 + c["data"], c["model"])] = shd.local_shard(
            x, spec, mesh, c)
    assert blocks[(0, 0)].shape == (1, 2, 5)
    whole = torch.cat([torch.cat([blocks[(i, j)] for j in range(3)], dim=1)
                       for i in range(4)], dim=0)
    assert torch.equal(whole, x)
    with pytest.raises(ValueError, match="split"):
        shd.local_shard(torch.zeros(5, 2), ("model",), mesh,
                        {"pod": 0, "data": 0, "model": 0})
