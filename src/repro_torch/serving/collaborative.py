"""Collaborative monitor -> trigger -> correct serving, batched over
independent streams (``serving/collaborative.py``: sync, async and scan
paths).

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
  * ``_step_async`` (mode="async"): the pipelined online path.  A trigger
    hands the same masked catch-up to a worker (``serving/async_rpc.py``:
    inproc, a CUDA side stream, a thread, a mock remote) that owns the
    server cache for the session, and the edge loop keeps decoding;
    corrections merge 1..``max_staleness`` steps late while u and the
    trigger decision stay exact.  ``max_staleness=0`` is bit-identical to
    ``_step``.  Over the ``wire`` transport the server half is a
    ``CorrectionServer`` in another process (``serving/server.py``): it
    owns the session's server cache, and the engine's own stays cold.
  * ``_run_scan`` (mode="scan"): offline trace evaluation, edge and server
    in lockstep over the whole stream, corrections routed through
    ``core.gating.compact_correction`` with static capacity.  It does not
    touch the engine's protocol state.

``self.metrics`` (a ``MetricsRegistry``) is always on.  The span tracer
is off (``None``) unless a session installs one
(``SessionConfig(trace=True)``); each instrumentation site is then one
``is not None`` check.  The span names are the reference's.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import decomposition as deco
from repro_torch.core.gating import CommsMeter, compact_correction
from repro_torch.kernels import ops
from repro_torch.models import api as model_api
from repro_torch.nn.module import linear, resolve_device
from repro_torch.observability import MetricsRegistry
from repro_torch.serving.async_rpc import Backlog
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
        # (a policy rewrites the vector between steps; serving/policy.py)
        self._thr_eff = np.full(batch, self._calibrated_point(), np.float32)
        self.metrics = MetricsRegistry()
        self._tracer = None
        self._dispatcher = None
        self._worker = None
        self._remote_detached = False  # set when a wire session closes

    def _calibrated_point(self) -> np.float32:
        return np.float32(self.m.threshold - self.m.trigger_margin)

    def session(self, config=None, *, streams=None, worker=None):
        """Open a ``MonitorSession`` over this engine (``worker``: a
        ready-made ``async_rpc`` worker for an async session)."""
        from repro_torch.serving.api import MonitorSession
        return MonitorSession(self, config, streams=streams, worker=worker)

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

    def _backlog(self, server_pos: np.ndarray, t, triggered: np.ndarray,
                 history: Optional[np.ndarray] = None) -> Backlog:
        """The catch-up's inputs for the triggered streams, on the device
        and the current stream: each triggered stream i replays history[i,
        server_pos[i]:t_i+1].  Rounds run to the longest triggered backlog;
        a stream that has finished is masked out of later rounds.  ``t``:
        scalar or (B,) end positions.  The tokens are gathered now, so a
        worker never reads the history, which later steps overwrite.
        ``history``: None reads the engine's own (on the device); the
        correction server passes its host mirror, (B, max_len) int32,
        whose tokens are gathered on the host and uploaded as one (R, B)
        block."""
        B = self.batch
        t_vec = np.broadcast_to(np.asarray(t, np.int64), (B,))
        n_rounds = int(np.max(np.where(triggered, t_vec + 1 - server_pos, 0)))
        # every round's positions, masks and tokens in one transfer/gather
        pos = server_pos[None, :] + np.arange(n_rounds)[:, None]     # (R, B)
        act = triggered[None, :] & (pos <= t_vec[None, :])
        clipped = np.clip(pos, 0, self.max_len - 1)
        if history is None:
            idx = torch.as_tensor(clipped.T, device=self.device)
            tokens = torch.gather(self._history, 1, idx).T           # (R, B)
        else:
            tokens = torch.as_tensor(
                history[np.arange(B)[None, :], clipped].astype(np.int64),
                device=self.device)
        return Backlog(
            tokens=tokens,
            pos=torch.as_tensor(pos.astype(np.int32), device=self.device),
            active=torch.as_tensor(act, device=self.device),
            triggered=torch.as_tensor(triggered, device=self.device))

    def _catchup_v(self, params, cache, backlog: Backlog) -> torch.Tensor:
        """Masked per-element server catch-up on ``cache`` (written in
        place; untriggered rows stay bit-unchanged).  Returns v (B,)."""
        B = self.batch
        last_hidden = torch.zeros((B, self.cfg.d_model), dtype=torch.float32,
                                  device=self.device)
        for r in range(backlog.tokens.shape[0]):
            _, hidden = step_at(params.server, self.cfg, cache,
                                backlog.tokens[r], backlog.pos[r],
                                backlog.active[r], with_logits=False)
            last_hidden = torch.where(backlog.active[r][:, None],
                                      hidden.float(), last_hidden)
        return self._v_head(params, last_hidden)

    def _fuse(self, u: torch.Tensor, v: torch.Tensor,
              triggered: torch.Tensor) -> torch.Tensor:
        """fhat = u - s*sigma(v) where ``triggered``, else u; elementwise,
        so the correction server fuses every reply of a replay in one
        call."""
        if self.m.sigma == "sigmoid":
            # fused combine: fhat, trigger mask and safety counters in one
            # pass (the Hopper kernel on a CUDA tensor)
            fhat_all, _, _ = ops.monitor_combine(
                u, v, u, s=self.m.s, threshold=self.m.threshold,
                margin=self.m.trigger_margin)
        else:
            fhat_all = u - self.m.s * deco.sigma(v, self.m.sigma)
        return torch.where(triggered, fhat_all, u)

    def _catchup_apply(self, params, cache, backlog: Backlog,
                       u: torch.Tensor):
        """Masked per-element server catch-up + fused correction on
        ``cache`` (written in place).  Returns (v, fhat).  An async
        session's worker runs this on the cache it owns; it reads nothing
        of the engine's live state."""
        v = self._catchup_v(params, cache, backlog)
        return v, self._fuse(u, v, backlog.triggered)

    def _catchup(self, params, cache, server_pos: np.ndarray, t,
                 triggered: np.ndarray, u: torch.Tensor):
        """The catch-up of ``_backlog`` and ``_catchup_apply`` on ``cache``,
        back to back on the current stream.  Returns (v, fhat)."""
        return self._catchup_apply(params, cache,
                                   self._backlog(server_pos, t, triggered), u)

    def _monitor_prologue(self, tokens_t):
        """The edge half of one step, shared by ``_step`` and
        ``_step_async`` so the two stay bit-identical by construction:
        record each active slot's token at its position, decode the edge
        tower (one call, each row at its own position), score u and decide
        the trigger.  Touches no server state.  Inactive slots report u = 0
        and never trigger."""
        pos, active = self.edge_pos, self.active
        if not active.any():
            raise ValueError("no attached streams (empty slot pool)")
        if (pos[active] >= self.max_len).any():
            raise ValueError(f"stream longer than max_len={self.max_len}")
        tr = self._tracer
        t0 = tr.clock() if tr is not None else 0.0
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
        if tr is not None:
            tr.done("edge.decode", "edge", t0, step=self.t)
            t1 = tr.clock()
        u_np = u.cpu().numpy()  # the step's one host sync
        # per-stream thresholds (a policy's, or the calibrated point)
        triggered = (u_np > self._thr_eff) & active
        if tr is not None:
            tr.done("edge.trigger", "edge", t1, step=self.t,
                    n_triggered=int(triggered.sum()))
        return u, u_np, triggered

    def _check_not_detached(self) -> None:
        """After a ``wire`` session the engine's server state lived in the
        remote correction server and went with the session (the server
        frees the lease at BYE and zeroes it for its next tenant): the
        local server cache is cold while ``server_pos`` records the remote
        progress, so serving on would replay partial backlogs into an
        empty cache.  Refuse."""
        if self._remote_detached:
            raise RuntimeError(
                "this engine's server state lived in a remote correction "
                "server (wire transport) and was discarded when the "
                "session closed; create a fresh engine to serve again")

    @torch.inference_mode()
    def _step(self, tokens_t) -> Dict[str, np.ndarray]:
        """One synchronous monitoring step over the slot pool.  Returns
        full-batch u, fhat, triggered (inactive slots: 0/0/False)."""
        B = self.batch
        self._check_not_detached()
        active = self.active.copy()
        t_vec = self.edge_pos.copy()  # per-slot time before this step
        u, u_np, triggered = self._monitor_prologue(tokens_t)
        if triggered.any():
            tr = self._tracer
            t0 = tr.clock() if tr is not None else 0.0
            _, fhat_d = self._catchup(self.params, self.server.cache,
                                      self.server_pos, t_vec, triggered, u)
            fhat = fhat_d.cpu().numpy()
            if tr is not None:
                # the sync path blocks on the server here
                tr.done("edge.catchup", "edge", t0, step=self.t,
                        n_triggered=int(triggered.sum()))
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

    # -- async pipelined online path -----------------------------------------
    def _start_async(self, *, transport: str = "stream",
                     max_staleness: int = 1,
                     latency_s: Optional[float] = None,
                     address: Optional[str] = None,
                     wire_coalesce: bool = True,
                     worker=None) -> None:
        """Open an async session: hand the server cache to a worker and set
        up the dispatch/merge layer.  ``transport``: inproc | stream |
        thread | mock_remote | wire | shm (``serving/async_rpc.py``);
        ``max_staleness``: 0 is the strict synchronous boundary
        (bit-identical to ``_step``), k >= 1 lets a reply land 1..k steps
        after its trigger, blocking the edge loop only at k;
        ``latency_s``: a simulated round trip (stream, thread, mock_remote;
        None keeps the transport's default).  ``address`` (wire and shm):
        the correction server's UDS path or host:port (``python -m
        repro_torch.launch.server``), or ``fleet:<router>``; the server
        then owns the session's server cache and only ``server_pos`` comes
        home.
        ``wire_coalesce=False`` opts the session out of the server's
        request coalescing."""
        from repro_torch.serving import async_rpc
        if self._dispatcher is not None:
            raise RuntimeError("async session already open")
        self._check_not_detached()
        if worker is None:
            wire_opts = None
            if transport in ("wire", "shm") and address is not None:
                wire_opts = dict(address=address, batch=self.batch,
                                 max_len=self.max_len, coalesce=wire_coalesce,
                                 comms=self.comms, metrics=self.metrics,
                                 tracer=self._tracer)
            worker = async_rpc.make_worker(transport, self._catchup_apply,
                                           self.params, self.server.cache,
                                           latency_s=latency_s,
                                           wire_opts=wire_opts)
        self._worker = worker
        self._dispatcher = async_rpc.Dispatcher(
            worker, max_staleness=max_staleness, comms=self.comms,
            tracer=self._tracer)
        # what has been shipped (dispatched) per stream; merges move
        # ``server_pos`` (what the protocol state reflects) up to this
        self._dispatch_pos = self.server_pos.copy()

    @torch.inference_mode()
    def _step_async(self, tokens_t) -> Dict[str, np.ndarray]:
        """One pipelined monitoring step: ``_step``'s monitor semantics (u
        and the trigger decision never wait on the server); corrections
        from earlier triggers merge into this step's fhat."""
        if self._dispatcher is None:
            raise RuntimeError("no open async session (use MonitorSession)")
        m, B = self.m, self.batch
        active = self.active.copy()
        t_vec = self.edge_pos.copy()
        u, u_np, triggered = self._monitor_prologue(tokens_t)
        # dispatch first, so the strict boundary (max_staleness=0) merges
        # this step's own reply below
        tr = self._tracer
        if triggered.any():
            t0 = tr.clock() if tr is not None else 0.0
            shipped = np.where(triggered, t_vec + 1 - self._dispatch_pos, 0)
            # one request per same-position cohort, each with a scalar-t
            # backlog, as the reference ships them (a uniform pool is one
            # request); a socket worker is corked around the fan-out, so
            # the cohort's requests leave in one transmit
            worker = self._worker
            corked = hasattr(worker, "cork")
            if corked:
                worker.cork()
            try:
                for p in sorted(set(t_vec[triggered].tolist())):
                    mask_p = triggered & (t_vec == p)
                    self._dispatcher.dispatch(
                        t=int(p), triggered=mask_p,
                        server_pos=self._dispatch_pos,
                        backlog=self._backlog(self._dispatch_pos, int(p),
                                              mask_p),
                        u=u, u_host=u_np, step_t=self.t)
            finally:
                if corked:
                    worker.uncork()
            self.comms.update_per_stream(shipped, active.astype(np.int64))
            self._dispatch_pos = np.where(triggered, t_vec + 1,
                                          self._dispatch_pos)
            if tr is not None:
                tr.done("edge.dispatch", "edge", t0, step=self.t,
                        n_triggered=int(triggered.sum()))
        else:
            self.comms.update_per_stream(np.zeros(B, np.int64),
                                         active.astype(np.int64))
        fhat = u_np.copy()
        t_merge = tr.clock() if tr is not None else 0.0
        n_merged = 0
        for r in self._dispatcher.collect(self.t):
            # membership changes drain first, so a reply's mask names only
            # attached slots; the `live` gate is defensive
            live = r.triggered & self.active
            if r.step_t == self.t:
                # same-step merge (strict boundary): the fused fhat from
                # this step's u, bit-identical to ``_step``
                fhat = np.where(live, r.fhat, fhat)
            else:
                # late merge: the stale corrector applied to today's u.
                # corr >= 0, so fhat <= u: staleness can only keep a
                # warning raised, never suppress one
                corr = (m.s * deco.sigma(torch.from_numpy(r.v), m.sigma)
                        ).numpy()
                fhat = np.where(live, u_np - corr, fhat)
            self.server_pos = np.where(live, r.t + 1, self.server_pos)
            n_merged += 1
        if tr is not None and n_merged:
            tr.done("edge.merge", "edge", t_merge, step=self.t,
                    n_replies=n_merged)
        self.edge_pos = t_vec + active
        self.t += 1
        return {"u": u_np, "fhat": fhat, "triggered": triggered}

    def _drain_async(self) -> None:
        """Settle every in-flight request (their replies update protocol
        state only) and order the engine's stream after the worker's.
        Required before any slot-pool membership change: a reply must
        never land on a slot re-leased since its dispatch."""
        for r in self._dispatcher.drain():
            live = r.triggered & self.active
            self.server_pos = np.where(live, r.t + 1, self.server_pos)
        self._worker.settle()

    def _finish_async(self) -> None:
        """Drain the pipeline's tail, re-adopt the worker's server cache
        (the engine's stream already waits on the worker's) and close the
        async session."""
        if self._dispatcher is None:
            return
        self._drain_async()
        self.server.cache = self._worker.cache
        self.server.pos = int(self.server_pos.max())
        if self._worker.kind in ("wire", "shm"):
            # the worker's cache is the engine's cold one (the real cache
            # lived, and went, in the server process): serving on would be
            # silently wrong
            self._remote_detached = True
        self._worker.close()
        self._dispatcher = self._worker = None

    # -- slot pool (driven by MonitorSession.attach/detach) -------------------
    def _attach_slot(self, slot: int) -> None:
        """Admit a new stream into ``slot``: every per-slot state the
        previous tenant left (edge and server cache rows, token history,
        positions, threshold) is reset, as in a freshly built engine.  In
        async mode the pipeline drains first, and the rows are reset in
        the cache the worker owns; over the wire an ATTACH frame tells the
        correction server to zero and re-lease its row."""
        rows = np.zeros(self.batch, bool)
        rows[slot] = True
        if self._dispatcher is not None:
            self._drain_async()
            if self._worker.kind in ("wire", "shm"):
                self._worker.attach_slot(slot)
            else:
                self.server.zero_rows(rows, self._worker.cache)
            self._dispatch_pos[slot] = 0
        else:
            self.server.zero_rows(rows)
        self.edge.zero_rows(rows)
        self._history[slot] = 0
        self.server_pos[slot] = 0
        self.edge_pos[slot] = 0
        # a fresh tenant starts at the calibrated operating point: a
        # threshold a policy raised for the previous tenant must not leak
        self._thr_eff[slot] = self._calibrated_point()
        self.active[slot] = True

    def _detach_slot(self, slot: int) -> None:
        """Retire the stream in ``slot``: masked out of decode, trigger and
        comms accounting from the next step on (attach zeroes on reuse).
        In async mode the pipeline drains first, so no in-flight reply can
        land on the freed slot; over the wire a DETACH frame tells the
        correction server."""
        if self._dispatcher is not None:
            self._drain_async()
            if self._worker.kind in ("wire", "shm"):
                self._worker.detach_slot(slot)
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
        tr = self._tracer
        t0 = tr.clock() if tr is not None else 0.0
        thr = (self._thr_eff if B == self.batch
               else np.full(B, self._calibrated_point(), np.float32))
        u, fhat, trig, served = self._scan(
            self.params, tokens, torch.as_tensor(thr, device=self.device))
        trig_np = trig.cpu().numpy()
        if tr is not None:
            tr.done("scan.run", "edge", t0, batch=int(B), steps=int(S))
        comms = CommsMeter(bytes_per_request=TOKEN_BYTES, n_streams=B)
        any_trig = trig_np.any(axis=1)
        last = np.where(any_trig, S - 1 - np.argmax(trig_np[:, ::-1], axis=1), -1)
        comms.update_per_stream(last + 1, np.full(B, S, np.int64),
                                events=trig_np.sum(axis=1))
        return {"u": u.cpu().numpy(), "fhat": fhat.cpu().numpy(),
                "triggered": trig_np, "served": served.cpu().numpy(),
                "comms": comms.report()}

    # -- the reference engine's shim ------------------------------------------
    def run_async(self, token_stream, *, transport: str = "stream",
                  max_staleness: int = 1, latency_s: Optional[float] = None,
                  address: Optional[str] = None, wire_coalesce: bool = True,
                  worker=None) -> Dict[str, object]:
        """Deprecated, as in the reference: a thin shim over
        ``MonitorSession`` in async mode, kept so that code written
        against the reference's engine runs unchanged.  Serves the whole
        stream and closes the session."""
        from repro_torch.serving.api import SessionConfig, TransportSpec
        warnings.warn(
            "CollaborativeEngine.run_async() is deprecated: open a "
            "MonitorSession instead -- engine.session(SessionConfig("
            "mode='async', ...)).run(stream)", DeprecationWarning,
            stacklevel=2)
        spec = TransportSpec(transport, address=address,
                             latency_s=latency_s, coalesce=wire_coalesce)
        config = SessionConfig(mode="async", transport=spec,
                               max_staleness=max_staleness)
        with self.session(config, worker=worker) as s:
            return s.run(token_stream)
