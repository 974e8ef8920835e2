"""Step functions of the launchers (``launch/steps.py``).

Three steps per architecture, matching the reference's input-shape kinds:

  train_step    (train_4k)    : collaborative forward, loss, gradients,
                AdamW (in place: the model and the optimizer state)
  prefill_step  (prefill_32k) : collaborative forward (monitor and
                corrector scores)
  serve_step    (decode_32k)  : one new token against the caches: server
                decode and corrector, edge decode and monitor, the fused
                combine and the trigger mask

``monitor_step`` is the edge-only path (no server tower).  The reference
jit-compiles these and returns new caches; here they run eagerly and
update the caches in place (the returned dict still names them).  On the
card the serve step's decodes reach the ``decode_attention`` kernel
through ``decode_step``, its combine is one ``monitor_combine`` launch,
and train/prefill reach ``flash_attention`` (and ``ssd_scan`` on the
hybrid) through ``collab_forward``.

Each step runs unchanged on a model placed on a DeviceMesh
(``distributed.sharding.distribute_collab``, DTensor parameters and
batch), and the serve and monitor steps on placed caches
(``models.api.init_cache(..., device_mesh=)``): the server cache split
by ``cache_specs(mode=cfg.decode_cache_shard)`` (``"time"``: its time
axis over ``model``, decode attention combined across ranks), the edge
cache over the data axes only, so the monitor step needs no collective.
``step_and_specs`` builds such a model, its optimizer state or caches
and a batch from shapes alone, for the dry run (``launch/dryrun.py``):
call it under a ``FakeTensorMode`` over a fake process group
(``launch.mesh.device_mesh(..., backend="fake")``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import decomposition as deco
from repro_torch.core.gating import masked_correction
from repro_torch.distributed.sharding import mesh_of
from repro_torch.kernels import ops
from repro_torch.models import api as model_api
from repro_torch.nn.module import linear, softplus
from repro_torch.training.loop import make_train_step as _loop_train_step
from repro_torch.training.loop import placed_region, trainable

EDGE_CACHE_LEN = 1024  # edge ring-buffer budget (device memory constraint)


def make_train_step(cfg: ArchConfig, opt) -> Callable:
    """(model, opt_state, batch) -> {"loss", "grad_norm"} (0-d tensors): one
    AdamW step in place on a ``trainable`` model."""
    step = _loop_train_step(cfg, opt)

    def train_step(model, opt_state, batch) -> Dict[str, torch.Tensor]:
        parts = step(model, opt_state, batch)
        return {"loss": parts["total"], "grad_norm": parts["grad_norm"]}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(model, batch) -> logits, u, the gated fhat and the trigger rate."""
    m = cfg.monitor

    def prefill_step(model, batch) -> Dict[str, torch.Tensor]:
        # DTensor's dispatch cannot run under inference mode
        grad_off = torch.no_grad() if mesh_of(model) is not None \
            else torch.inference_mode()
        with grad_off, placed_region(model):
            out = deco.collab_forward(model, cfg, batch)
            fhat, mask = masked_correction(out["u"], out["corr"],
                                           m.threshold, m.trigger_margin)
            rate = mask.mean()
        return {"logits": out["logits"], "u": out["u"], "fhat": fhat,
                "trigger_rate": rate}

    return prefill_step


@contextlib.contextmanager
def _decoding(model):
    """Inference mode for an unplaced model; on a DeviceMesh no_grad and
    ``placed_region`` (DTensor's dispatch cannot run under inference
    mode)."""
    if mesh_of(model) is None:
        with torch.inference_mode():
            yield
        return
    with torch.no_grad(), placed_region(model):
        yield


def _edge_u(model, cfg: ArchConfig, hidden_t: torch.Tensor) -> torch.Tensor:
    hd = model.u_head
    feats = torch.tanh(linear(hd.w_feat, hidden_t.float()))
    return feats @ hd.a + softplus(hd.raw_t)


def make_serve_step(cfg: ArchConfig) -> Callable:
    """(model, server_cache, edge_cache, tokens (B,), pos) -> logits, u,
    fhat, mask and the two caches (updated in place).  The ungated step:
    the server decodes every token, and ``fhat = u - mask * s*sigmoid(v)``
    with ``mask = u > threshold - margin``, fused in one ``monitor_combine``
    call."""
    ecfg = deco.edge_arch(cfg)
    m = cfg.monitor

    def serve_step(model, server_cache, edge_cache, tokens,
                   pos) -> Dict[str, object]:
        with _decoding(model):
            logits, h = model_api.decode_step(model.server, cfg,
                                              server_cache, tokens, pos)
            v = linear(model.v_head, h.float())[..., 0]
            _, eh = model_api.decode_step(model.edge, ecfg, edge_cache,
                                          tokens, pos, with_logits=False)
            u = _edge_u(model, cfg, eh)
            fhat_all, mask, _ = ops.monitor_combine(
                u, v, u, s=m.s, threshold=m.threshold,
                margin=m.trigger_margin)
            fhat = torch.where(mask > 0, fhat_all, u)
        return {"logits": logits, "u": u, "fhat": fhat, "mask": mask,
                "server_cache": server_cache, "edge_cache": edge_cache}

    return serve_step


def make_monitor_step(cfg: ArchConfig) -> Callable:
    """Edge-only decode step (the device's always-on path): (model,
    edge_cache, tokens, pos) -> u and the edge cache (in place)."""
    ecfg = deco.edge_arch(cfg)

    def monitor_step(model, edge_cache, tokens, pos) -> Dict[str, object]:
        with _decoding(model):
            _, eh = model_api.decode_step(model.edge, ecfg, edge_cache,
                                          tokens, pos, with_logits=False)
            u = _edge_u(model, cfg, eh)
        return {"u": u, "edge_cache": edge_cache}

    return monitor_step


# ---------------------------------------------------------------------------
# Shape-only inputs for each step (the dry run)
# ---------------------------------------------------------------------------


def placed_shapes(cfg: ArchConfig, device_mesh) -> deco.CollabLM:
    """A ``CollabLM`` of ``cfg`` whose parameters are DTensors on
    ``device_mesh`` placed by the partition rules, each holding this
    rank's block as an uninitialised tensor on the mesh's device type
    (under a ``FakeTensorMode``: fake, so a FULL config takes no memory).
    The layout is built on the meta device first."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    model = deco.CollabLM(cfg, device="meta")
    specs = shd.named_specs(model, device_mesh)
    coords = shd.mesh_coords(device_mesh)
    for name, p in list(model.named_parameters()):
        block = shd.local_shard(p, specs[name], device_mesh, coords)
        local = torch.empty(block.shape, dtype=p.dtype,
                            device=device_mesh.device_type)
        dt = DTensor.from_local(local, device_mesh,
                                shd.placements(specs[name], device_mesh),
                                run_check=False, shape=p.shape,
                                stride=p.stride())
        shd.set_param(model, name, torch.nn.Parameter(dt,
                                                       requires_grad=False))
    return model


def batch_specs(cfg: ArchConfig, shape, device_mesh) -> Dict[str, object]:
    """The model inputs of ``shape`` (a train or prefill ``ShapeConfig``)
    as DTensors cut by ``batch_spec``, uninitialised (the reference's
    ``input_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    tok = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    leaves = {"tokens": (tok, torch.int32)}
    if cfg.family == "vlm":
        leaves["image_embeds"] = ((B, cfg.n_image_tokens, cfg.d_model),
                                  torch.float32)
    if shape.kind == "train":
        leaves["labels"] = (tok, torch.int32)
        leaves["monitor_target"] = ((B, S), torch.float32)
    return {key: _batch_leaf(shp, dtype, B, device_mesh)
            for key, (shp, dtype) in leaves.items()}


def _batch_leaf(shp, dtype, B: int, device_mesh):
    """An uninitialised DTensor of global shape ``shp`` cut by
    ``batch_spec``: this rank's block on the mesh's device type."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    spec = shd.batch_spec(device_mesh, shp, B)
    whole = torch.empty(shp, device="meta")
    block = shd.local_shard(whole, spec, device_mesh,
                            shd.mesh_coords(device_mesh))
    local = torch.empty(block.shape, dtype=dtype,
                        device=device_mesh.device_type)
    return DTensor.from_local(local, device_mesh,
                              shd.placements(spec, device_mesh),
                              run_check=False, shape=shp,
                              stride=whole.stride())


def step_and_specs(cfg: ArchConfig, shape, device_mesh) -> Tuple[Callable,
                                                                 Tuple]:
    """(step_fn, args) of ``shape``'s kind on ``device_mesh`` from shapes
    alone: the train step (AdamW at lr 3e-4, its moments placed by
    ``opt_specs(zero1=cfg.zero1)``) over (model, opt_state, batch), the
    prefill step over (model, batch), or the serve step over (model,
    server_cache, edge_cache, tokens, pos), as the reference builds them
    (``repro/launch/steps.py:120-130``): the server cache at
    ``decode_capacity(cfg, S)`` placed by ``cache_specs(mode=
    cfg.decode_cache_shard)``, the edge cache at ``min(S,
    EDGE_CACHE_LEN)`` over the data axes only, tokens (B,) (or (B, K)
    for audio) cut by ``batch_spec``, and the last position ``S - 1``
    (every slot valid), a plain scalar: replicated."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.training.optimizer import AdamW, keeps_masters
    model = placed_shapes(cfg, device_mesh)
    if shape.kind == "decode":
        return make_serve_step(cfg), (model, *decode_specs(cfg, shape,
                                                           device_mesh))
    batch = batch_specs(cfg, shape, device_mesh)
    if shape.kind == "train":
        opt = AdamW(lr=3e-4)
        state = opt.init(trainable(model), masters=keeps_masters(cfg),
                         placements=shd.opt_placements(
                             model, device_mesh, zero1=cfg.zero1))
        return make_train_step(cfg, opt), (model, state, batch)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (model, batch)
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def decode_specs(cfg: ArchConfig, shape, device_mesh) -> Tuple:
    """(server_cache, edge_cache, tokens, pos) of a decode ``shape`` on
    ``device_mesh`` (``step_and_specs``); the caches zeroed, tokens
    uninitialised."""
    B, S = shape.global_batch, shape.seq_len
    dev = device_mesh.device_type
    server = model_api.init_cache(cfg, B, S, dev, device_mesh=device_mesh)
    edge = model_api.init_cache(deco.edge_arch(cfg), B,
                                min(S, EDGE_CACHE_LEN), dev,
                                device_mesh=device_mesh, use_model=False)
    shp = (B, cfg.n_codebooks) if cfg.family == "audio" else (B,)
    tokens = _batch_leaf(shp, torch.int32, B, device_mesh)
    pos = torch.full((), S - 1, dtype=torch.int32, device=dev)
    return server, edge, tokens, pos
