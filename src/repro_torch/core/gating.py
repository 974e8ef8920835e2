"""Trigger-gated correction and communication accounting
(``core/gating.py``): ``trigger_mask`` and ``masked_correction`` (dense
compute, the trigger applied as a mask, as the paper-scale experiments
use it), ``compact_correction`` (the serving scan path's static-capacity
gather), and ``CommsMeter``, per stream for the serving paths (with the
async path's pipelining counters) and in aggregate for the paper's Fig-4
accounting."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def trigger_mask(u: torch.Tensor, threshold: float,
                 margin: float) -> torch.Tensor:
    """1.0 where the device must consult the server (u near or above
    gamma), else 0.0."""
    return (u > threshold - margin).float()


def masked_correction(u: torch.Tensor, corr: torch.Tensor, threshold: float,
                      margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fhat = u - corr where triggered, u elsewhere.  Returns (fhat, mask)."""
    mask = trigger_mask(u, threshold, margin)
    return u - mask * corr, mask


def compact_correction(u: torch.Tensor, xs: torch.Tensor,
                       corrector: Callable, threshold, margin: float,
                       capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-capacity gated correction over a flat batch.

    u: (N,) monitor scores; xs: (N, ...) server inputs; ``corrector`` maps
    a (capacity, ...) buffer to (capacity,) corrections (>= 0).  Returns
    (fhat, mask, n_triggered).  The reference's contract holds: rows are
    ranked by urgency ``u - (threshold - margin)`` with a stable sort
    (untriggered rows at the back, ties by row index), only ``capacity``
    rows reach the corrector, overflow rows keep plain ``u`` (a dropped
    correction can only keep a warning raised), and untriggered rows in
    the buffer get their corrections zeroed, so their fhat is exactly u.
    ``threshold`` may be a scalar or an (N,) tensor of per-stream points.
    """
    n = u.shape[0]
    urgency = u - (threshold - margin)
    triggered = urgency > 0
    key = torch.where(triggered, -urgency, torch.full_like(urgency, float("inf")))
    order = torch.argsort(key, stable=True)
    sel = order[:capacity]
    corr_buf = corrector(xs[sel])
    valid = triggered[sel]
    fhat = u.index_add(0, sel, -(corr_buf * valid))
    mask = torch.zeros(n, dtype=torch.float32, device=u.device)
    mask = mask.index_copy(0, sel, valid.float())
    return fhat, mask, triggered.sum()


@dataclass
class CommsMeter:
    """Device->server traffic per stream (paper Fig 4), token level.

    ``bytes_per_request`` is the payload of one shipped token; the
    baseline ships every observed token.  Each token ships at most once,
    so ``bytes_sent <= bytes_baseline``.  In async mode tokens are charged
    at dispatch, when they leave the device, so the bytes and the Fig-4
    reduction do not depend on the staleness window.

    The async path also meters its pipeline (``serving/async_rpc.py``'s
    ``Dispatcher`` fills these): per-stream in-flight requests, the edge
    loop's stall time blocked on overdue replies, the server busy time,
    and ``overlap_ratio``, the share of request wall time hidden behind
    edge decode.

    The ``wire`` transport (``async_rpc.SocketWorker``) meters what it
    measures on the socket: bytes written and read (frames with their
    headers, the handshake included) and each request's round trip.
    This is the reference's meter without its shm and failover counters,
    which belong to transports not ported yet (ROADMAP queue 1, item 6).
    """

    bytes_per_request: int
    n_streams: int = 1
    rate_window: int = 64
    total_steps: int = 0
    triggered: int = 0
    tokens_shipped: int = 0
    tokens_sent: Optional[np.ndarray] = None
    tokens_seen: Optional[np.ndarray] = None
    # -- async pipelining (filled by the Dispatcher) ------------------------
    requests_inflight: Optional[np.ndarray] = None  # (n_streams,) in flight now
    inflight_peak: int = 0     # max simultaneous in-flight requests
    dispatched: int = 0        # async requests dispatched
    merged_late: int = 0       # replies merged >= 1 step after their trigger
    stall_s: float = 0.0       # edge-loop time blocked on overdue replies
    server_busy_s: float = 0.0  # worker compute time
    request_wall_s: float = 0.0  # dispatch -> reply visible (incl. latency)
    # -- wire transport (filled by SocketWorker): measured, not modelled ----
    wire_tx_bytes: int = 0     # bytes written to the socket
    wire_rx_bytes: int = 0     # bytes read off the socket
    wire_rtt_s: float = 0.0    # sum of measured dispatch -> reply round trips
    wire_rtt_max_s: float = 0.0
    wire_replies: int = 0

    def __post_init__(self) -> None:
        if self.tokens_sent is None:
            self.tokens_sent = np.zeros(self.n_streams, np.int64)
        if self.tokens_seen is None:
            self.tokens_seen = np.zeros(self.n_streams, np.int64)
        if self.requests_inflight is None:
            self.requests_inflight = np.zeros(self.n_streams, np.int64)
        self._ring_events = np.zeros((self.n_streams, self.rate_window), bool)
        self._ring_seen = np.zeros((self.n_streams, self.rate_window), bool)
        self._ring_pos = 0
        self._per_stream_used = False
        self._async_used = False
        self._wire_used = False
        self._inflight_reqs = 0

    def update(self, n_triggered: int, n_total: int) -> None:
        """Aggregate accounting: ``n_triggered`` of ``n_total`` inputs
        consulted the server, each shipping one request.  It feeds neither
        the per-stream counts nor the windowed rate."""
        self.total_steps += int(n_total)
        self.triggered += int(n_triggered)
        self.tokens_shipped += int(n_triggered)

    def update_per_stream(self, sent, seen, events=None) -> None:
        """sent/seen: (n_streams,) tokens shipped/observed by this event;
        ``events``: trigger events per stream (default ``sent > 0``)."""
        sent = np.asarray(sent, np.int64)
        seen = np.asarray(seen, np.int64)
        if events is None:
            events = (sent > 0).astype(np.int64)
        self._per_stream_used = True
        self.tokens_sent += sent
        self.tokens_seen += seen
        self.tokens_shipped += int(sent.sum())
        self.triggered += int(np.asarray(events).sum())
        self.total_steps += int(seen.sum())
        self._ring_events[:, self._ring_pos] = np.asarray(events) > 0
        self._ring_seen[:, self._ring_pos] = seen > 0
        self._ring_pos = (self._ring_pos + 1) % self.rate_window

    def recent_trigger_rate(self) -> np.ndarray:
        ev = self._ring_events.sum(axis=1, dtype=np.int64)
        seen = self._ring_seen.sum(axis=1, dtype=np.int64)
        return ev / np.maximum(seen, 1)

    # -- async pipelining ----------------------------------------------------
    def record_dispatch(self, mask) -> None:
        """A catch-up request left the edge; ``mask``: (n_streams,) bool of
        the streams it serves."""
        self._async_used = True
        self.requests_inflight += np.asarray(mask, bool)
        self.dispatched += 1
        self._inflight_reqs += 1
        self.inflight_peak = max(self.inflight_peak, self._inflight_reqs)

    def record_merge(self, mask, age: int) -> None:
        """The reply for ``mask`` merged ``age`` edge steps after its
        trigger (0: the strict synchronous boundary)."""
        self.requests_inflight -= np.asarray(mask, bool)
        self._inflight_reqs -= 1
        if age > 0:
            self.merged_late += 1

    def record_stall(self, dt: float) -> None:
        """The edge loop blocked ``dt`` seconds on an overdue reply."""
        self.stall_s += float(dt)

    def record_server_busy(self, compute_s: float, wall_s: float) -> None:
        self.server_busy_s += float(compute_s)
        self.request_wall_s += float(wall_s)

    # -- wire transport (measured bytes and latency; serving/wire.py) -------
    def record_wire_tx(self, nbytes: int) -> None:
        """``nbytes`` handed to the kernel (frames with their headers, the
        handshake included): the measured counterpart of ``bytes_sent``."""
        self._wire_used = True
        self.wire_tx_bytes += int(nbytes)

    def record_wire_rx(self, nbytes: int) -> None:
        self._wire_used = True
        self.wire_rx_bytes += int(nbytes)

    def record_wire_rtt(self, dt: float) -> None:
        """One measured dispatch -> reply round trip over the socket
        (serialization, the kernel, the server's replay, decoding)."""
        self._wire_used = True
        self.wire_replies += 1
        self.wire_rtt_s += float(dt)
        self.wire_rtt_max_s = max(self.wire_rtt_max_s, float(dt))

    @property
    def overlap_ratio(self) -> float:
        """Share of request wall time (server compute + network) hidden
        behind edge decode; 1.0 when the pipeline never stalled."""
        if self.request_wall_s <= 0.0:
            return 1.0 if self.stall_s == 0.0 else 0.0
        return max(0.0, 1.0 - self.stall_s / self.request_wall_s)

    @property
    def trigger_rate(self) -> float:
        return self.triggered / max(self.total_steps, 1)

    @property
    def bytes_sent(self) -> int:
        return self.tokens_shipped * self.bytes_per_request

    @property
    def bytes_baseline(self) -> int:
        return self.total_steps * self.bytes_per_request

    @property
    def reduction(self) -> float:
        return self.bytes_baseline / max(self.bytes_sent, 1)

    def per_stream_report(self) -> Dict[str, np.ndarray]:
        sent_b = self.tokens_sent * self.bytes_per_request
        base_b = self.tokens_seen * self.bytes_per_request
        return {"bytes_sent": sent_b,
                "bytes_baseline": base_b,
                "reduction_x": base_b / np.maximum(sent_b, 1),
                "recent_trigger_rate": self.recent_trigger_rate()}

    def report(self) -> Dict[str, object]:
        rep = {"trigger_rate": self.trigger_rate,
               "bytes_sent": self.bytes_sent,
               "bytes_baseline": self.bytes_baseline,
               "reduction_x": self.reduction}
        if self._per_stream_used:
            rep["per_stream"] = self.per_stream_report()
        if self._async_used:  # only when the pipelined path ran
            rep["async"] = {
                "requests": self.dispatched,
                "merged_late": self.merged_late,
                "inflight_now": int(self.requests_inflight.sum()),
                "inflight_peak": self.inflight_peak,
                "stall_s": self.stall_s,
                "server_busy_s": self.server_busy_s,
                "request_wall_s": self.request_wall_s,
                "overlap_ratio": self.overlap_ratio,
            }
        if self._wire_used:  # only when the wire transport ran
            rep["wire"] = {
                "tx_bytes": self.wire_tx_bytes,
                "rx_bytes": self.wire_rx_bytes,
                "replies": self.wire_replies,
                "rtt_mean_s": self.wire_rtt_s / max(self.wire_replies, 1),
                "rtt_max_s": self.wire_rtt_max_s,
            }
        return rep
