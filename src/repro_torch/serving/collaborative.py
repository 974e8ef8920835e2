"""Collaborative monitor -> trigger -> correct serving, batched over
independent streams (``serving/collaborative.py``, sync and scan paths).

  device: the edge tower decodes every token of every stream and scores
          u_t with the truncated-basis head (paper Eq. 8); stream i
          triggers when u_t > its threshold.
  server: the large backbone sees a stream's tokens only on a trigger:
          it catches its cache up on that stream's backlog and returns
          the corrector, so the device reports f_hat = u - s*sigma(v).

Each batch row (slot) is an independent stream with its own clock
(``edge_pos``), server position (``server_pos``) and backlog
(``history[i, server_pos[i]:t_i+1]``, kept on the device).  A trigger on
stream i ships only stream i's backlog and charges only stream i in the
``CommsMeter``.  The public entry point is ``MonitorSession``
(``serving/api.py``); the paths here are private:

  * ``_step`` (mode="sync"): the online protocol, one token per stream
    per step, a blocking catch-up on triggers, and the fused
    ``monitor_combine`` kernel for fhat.
  * ``_run_scan`` (mode="scan"): offline trace evaluation, edge and server
    in lockstep over the whole stream, corrections routed through
    ``core.gating.compact_correction`` with static capacity.  It does not
    touch the engine's protocol state.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import decomposition as deco
from repro_torch.core.gating import CommsMeter, compact_correction
from repro_torch.kernels import ops
from repro_torch.models import api as model_api
from repro_torch.nn.module import linear, resolve_device
from repro_torch.serving.engine import ServeEngine, step_at

# payload: one token id (4B) + edge score (4B) per shipped token
TOKEN_BYTES = 8


def _params_device(params) -> torch.device:
    return next(params.parameters()).device


class CollaborativeEngine:
    """Parameters, caches and per-slot protocol state for one batch of
    monitored streams on ``device``.  Serve through ``session()``."""

    def __init__(self, params: deco.CollabLM, cfg: ArchConfig, batch: int,
                 max_len: int, *, device, capacity: Optional[int] = None,
                 monitor_n: Optional[int] = None):
        self.device = resolve_device(device)
        if _params_device(params) != self.device:
            raise ValueError(f"parameters are on {_params_device(params)}, "
                             f"the engine on {self.device}")
        self.cfg, self.m = cfg, cfg.monitor
        self.params = params
        self.batch, self.max_len = batch, max_len
        self.edge = ServeEngine(params.edge, deco.edge_arch(cfg), batch,
                                max_len, self.device)
        self.server = ServeEngine(params.server, cfg, batch, max_len,
                                  self.device)
        self.capacity = batch if capacity is None else min(capacity, batch)
        self.monitor_n = self.m.n_features if monitor_n is None else monitor_n
        self.server_pos = np.zeros(batch, np.int64)
        self.edge_pos = np.zeros(batch, np.int64)
        self.active = np.ones(batch, bool)
        self.t = 0  # session step counter
        self._history = torch.zeros((batch, max_len), dtype=torch.int64,
                                    device=self.device)
        self.comms = CommsMeter(bytes_per_request=TOKEN_BYTES, n_streams=batch)
        # per-stream trigger points: stream i triggers when u_i > _thr_eff[i]
        self._thr_eff = np.full(batch, self._calibrated_point(), np.float32)

    def _calibrated_point(self) -> np.float32:
        return np.float32(self.m.threshold - self.m.trigger_margin)

    def session(self, config=None, *, streams=None):
        """Open a ``MonitorSession`` over this engine."""
        from repro_torch.serving.api import MonitorSession
        return MonitorSession(self, config, streams=streams)

    # -- heads ---------------------------------------------------------------
    # Both heads end in an elementwise product and a reduction over the
    # feature axis, not a matvec: a matvec's rounding can depend on how
    # many rows it gets, which would break per-row identity between the
    # sync path's full batch and the scan path's compacted buffer.
    def _u_head(self, params, hidden_t: torch.Tensor) -> torch.Tensor:
        hd = params.u_head
        feats = torch.tanh(linear(hd.w_feat, hidden_t.float()))
        # Eq. 8 truncation: only the first n basis features reach the device
        idx = torch.arange(feats.shape[-1], device=feats.device)
        mask = (idx < self.monitor_n).float()
        t = deco.softplus(hd.raw_t)
        return torch.sum(feats * (hd.a * mask), dim=-1) + t

    def _v_head(self, params, hidden_t: torch.Tensor) -> torch.Tensor:
        hd = params.v_head
        return torch.sum(hidden_t.float() * hd.w[:, 0], dim=-1) + hd.b[0]

    # -- online (lazy, per-element) path -------------------------------------
    def _record_at(self, tokens_t: torch.Tensor, pos: np.ndarray,
                   active: np.ndarray) -> None:
        """history[i, pos[i]] = tokens_t[i] where active; other slots keep
        their history bit-for-bit."""
        rows = torch.arange(self.batch, device=self.device)
        idx = torch.as_tensor(np.clip(pos, 0, self.max_len - 1),
                              device=self.device)
        act = torch.as_tensor(active, device=self.device)
        self._history[rows, idx] = torch.where(act, tokens_t,
                                               self._history[rows, idx])

    def _catchup(self, params, server_pos: np.ndarray, t, triggered: np.ndarray,
                 u: torch.Tensor):
        """Masked per-element server catch-up + fused correction.

        Each triggered stream i replays history[i, server_pos[i]:t_i+1]
        into the server cache at its own positions; untriggered rows keep
        their cache bit-unchanged.  Rounds run to the longest triggered
        backlog, and a stream that has finished is masked out of later
        rounds.  ``t``: scalar or (B,) end positions.  Returns (v, fhat).
        """
        B = self.batch
        t_vec = np.broadcast_to(np.asarray(t, np.int64), (B,))
        n_rounds = int(np.max(np.where(triggered, t_vec + 1 - server_pos, 0)))
        # every round's positions, masks and tokens in one transfer/gather
        pos = server_pos[None, :] + np.arange(n_rounds)[:, None]     # (R, B)
        act = triggered[None, :] & (pos <= t_vec[None, :])
        pos_d = torch.as_tensor(pos.astype(np.int32), device=self.device)
        act_d = torch.as_tensor(act, device=self.device)
        idx = torch.as_tensor(np.clip(pos, 0, self.max_len - 1).T,
                              device=self.device)
        tok = torch.gather(self._history, 1, idx).T                  # (R, B)
        last_hidden = torch.zeros((B, self.cfg.d_model), dtype=torch.float32,
                                  device=self.device)
        for r in range(n_rounds):
            _, hidden = step_at(params.server, self.cfg, self.server.cache,
                                tok[r], pos_d[r], act_d[r], with_logits=False)
            last_hidden = torch.where(act_d[r][:, None], hidden.float(),
                                      last_hidden)
        v = self._v_head(params, last_hidden)
        trig_d = torch.as_tensor(triggered, device=self.device)
        if self.m.sigma == "sigmoid":
            # fused combine: fhat, trigger mask and safety counters in one
            # pass over the batch (the Hopper kernel on a CUDA tensor)
            fhat_all, _, _ = ops.monitor_combine(
                u, v, u, s=self.m.s, threshold=self.m.threshold,
                margin=self.m.trigger_margin)
        else:
            fhat_all = u - self.m.s * deco.sigma(v, self.m.sigma)
        return v, torch.where(trig_d, fhat_all, u)

    def _monitor_prologue(self, tokens_t):
        """The edge half of one step: record each active slot's token at
        its position, decode the edge tower (one call, each row at its own
        position), score u and decide the trigger.  Inactive slots report
        u = 0 and never trigger."""
        pos, active = self.edge_pos, self.active
        if not active.any():
            raise ValueError("no attached streams (empty slot pool)")
        if (pos[active] >= self.max_len).any():
            raise ValueError(f"stream longer than max_len={self.max_len}")
        tokens_t = torch.as_tensor(np.asarray(tokens_t),
                                   device=self.device).long()
        self._record_at(tokens_t, pos, active)
        act_d = torch.as_tensor(active, device=self.device)
        pos_d = torch.as_tensor(pos.astype(np.int32), device=self.device)
        _, hidden = self.edge.decode_at(tokens_t, pos_d, act_d,
                                        with_logits=False)
        u = self._u_head(self.params, hidden)
        if not active.all():
            u = torch.where(act_d, u, torch.zeros_like(u))
        u_np = u.cpu().numpy()  # the step's one host sync
        triggered = (u_np > self._thr_eff) & active
        return u, u_np, triggered

    @torch.inference_mode()
    def _step(self, tokens_t) -> Dict[str, np.ndarray]:
        """One synchronous monitoring step over the slot pool.  Returns
        full-batch u, fhat, triggered (inactive slots: 0/0/False)."""
        B = self.batch
        active = self.active.copy()
        t_vec = self.edge_pos.copy()  # per-slot time before this step
        u, u_np, triggered = self._monitor_prologue(tokens_t)
        if triggered.any():
            _, fhat_d = self._catchup(self.params, self.server_pos, t_vec,
                                      triggered, u)
            fhat = fhat_d.cpu().numpy()
            shipped = np.where(triggered, t_vec + 1 - self.server_pos, 0)
            self.comms.update_per_stream(shipped, active.astype(np.int64))
            self.server_pos = np.where(triggered, t_vec + 1, self.server_pos)
            self.server.pos = int(self.server_pos.max())
        else:
            fhat = u_np.copy()
            self.comms.update_per_stream(np.zeros(B, np.int64),
                                         active.astype(np.int64))
        self.edge_pos = t_vec + active
        self.t += 1
        return {"u": u_np, "fhat": fhat, "triggered": triggered}

    # -- slot pool (driven by MonitorSession.attach/detach) -------------------
    def _attach_slot(self, slot: int) -> None:
        """Admit a new stream into ``slot``: every per-slot state the
        previous tenant left (edge and server cache rows, token history,
        positions, threshold) is reset, as in a freshly built engine."""
        rows = np.zeros(self.batch, bool)
        rows[slot] = True
        self.edge.zero_rows(rows)
        self.server.zero_rows(rows)
        self._history[slot] = 0
        self.server_pos[slot] = 0
        self.edge_pos[slot] = 0
        self._thr_eff[slot] = self._calibrated_point()
        self.active[slot] = True

    def _detach_slot(self, slot: int) -> None:
        """Retire the stream in ``slot``: masked out of decode, trigger and
        comms accounting from the next step on (attach zeroes on reuse)."""
        self.active[slot] = False

    # -- offline scan path ---------------------------------------------------
    def _scan(self, params, tokens: torch.Tensor, thr_eff: torch.Tensor):
        """Edge + server decode in lockstep over time on fresh caches of the
        engine's capacity (so attention widths match the online path),
        corrections through compact_correction.  Returns batch-major
        (u, fhat, triggered, served)."""
        ecfg = deco.edge_arch(self.cfg)
        cfg, m = self.cfg, self.m
        B, S = tokens.shape
        edge_cache = model_api.init_cache(ecfg, B, self.max_len, self.device)
        server_cache = model_api.init_cache(cfg, B, self.max_len, self.device)

        def corrector(buf):  # (capacity, d) gathered server hiddens
            return m.s * deco.sigma(self._v_head(params, buf), m.sigma)

        out = []
        for t in range(S):
            tok_t = tokens[:, t]
            _, eh = model_api.decode_step(params.edge, ecfg, edge_cache, tok_t,
                                          t, with_logits=False)
            u = self._u_head(params, eh)
            _, sh = model_api.decode_step(params.server, cfg, server_cache,
                                          tok_t, t, with_logits=False)
            fhat, served, _ = compact_correction(
                u, sh.float(), corrector, thr_eff, 0.0, self.capacity)
            out.append((u, fhat, u > thr_eff, served))
        return tuple(torch.stack(x, dim=1) for x in zip(*out))

    @torch.inference_mode()
    def _run_scan(self, token_stream) -> Dict[str, object]:
        """Offline trace evaluation with the sync path's semantics (exact
        when capacity == batch).  Comms come from the trigger trace: a
        trigger at time t ships the backlog since that stream's previous
        trigger, so a stream ships (index of its last trigger + 1) tokens."""
        tokens = torch.as_tensor(np.asarray(token_stream),
                                 device=self.device).long()
        B, S = tokens.shape
        if S > self.max_len:
            raise ValueError(f"stream longer than max_len={self.max_len}")
        thr = (self._thr_eff if B == self.batch
               else np.full(B, self._calibrated_point(), np.float32))
        u, fhat, trig, served = self._scan(
            self.params, tokens, torch.as_tensor(thr, device=self.device))
        trig_np = trig.cpu().numpy()
        comms = CommsMeter(bytes_per_request=TOKEN_BYTES, n_streams=B)
        any_trig = trig_np.any(axis=1)
        last = np.where(any_trig, S - 1 - np.argmax(trig_np[:, ::-1], axis=1), -1)
        comms.update_per_stream(last + 1, np.full(B, S, np.int64),
                                events=trig_np.sum(axis=1))
        return {"u": u.cpu().numpy(), "fhat": fhat.cpu().numpy(),
                "triggered": trig_np, "served": served.cpu().numpy(),
                "comms": comms.report()}
