"""A monitoring fleet served by ``MonitorSession`` (sync mode): every slot
holds a stream (a session) that sends one token a step, each step waits
for its verdicts (a closed loop), and a stream that has sent ``max_len``
tokens is detached and a fresh stream attached in its slot.  Which
streams raise an alarm (consult the server) at a step is the traffic's
schedule (``traffic.alarms_due``), applied through the program's
per-stream trigger points (a ``TriggerPolicy`` that forces or suppresses
the consult), so every seed's fleet does the same work a step: the
catch-up's rounds a step are the longest backlog among the alarms.

Set-up: the seeded weights, then the ramp, ``max_len`` steps, after which
every first stream has been replaced and every age is held by as many
slots.  Up to its last ``ramp_scheduled_steps`` steps the ramp alarms
every stream every step (one catch-up round a step, so the server keeps
up cheaply); then it follows the schedule, which the window continues.
Window: steps for ``seconds``.  Then, traced, a short profiled
sub-window.  Then the check: the reference's u and v over a seeded sample
of the streams served in the window, with the longest of them, against
the program's u, alarms and verdicts at every position they were
served."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, judge, port, profiling, spec, traffic
from portbench.reference import serve as ref_serve


def scheduled_policy():
    """A client-held ``TriggerPolicy`` whose trigger points are -inf for
    the slots in ``due`` (consult) and +inf for the others."""
    from repro_torch.serving.policy import TriggerPolicy

    class Scheduled(TriggerPolicy):
        name = "scheduled"
        due = None

        def step_thresholds(self):
            return np.where(self.due, -np.inf, np.inf).astype(np.float32)

    return Scheduled()


class Fleet:
    """The slots' lanes, streams, positions and records, and per step what
    the catch-up had to do (kept from the program's alarms)."""

    def __init__(self, seed: int, mix: dict, vocab: int):
        self.seed, self.mix, self.V = seed, mix, vocab
        self.B, self.L = B, L = mix["streams"], mix["max_len"]
        self.lane = traffic.lane_order(seed, B)
        self.life = traffic.first_lives(B, L)[self.lane]
        self.forced_until = L - mix["ramp_scheduled_steps"]
        self.t = 0                               # global step
        self.sid = np.arange(B)                  # stream id in each slot
        self.next_id = B
        self.pos = np.zeros(B, np.int64)         # next position a slot sends
        self.server_pos = np.zeros(B, np.int64)
        self.toks = np.stack([self._tokens(i) for i in range(B)])
        self.rec: Dict[int, Dict[str, np.ndarray]] = {
            i: self._record() for i in range(B)}
        self.steps: List[dict] = []

    def _tokens(self, sid: int) -> np.ndarray:
        return traffic.stream_tokens(self.seed, sid, self.L, self.V)

    def _record(self) -> Dict[str, np.ndarray]:
        return {k: np.full(self.L, np.nan) for k in ("u", "fhat",
                                                     "triggered", "due")}

    def due(self) -> np.ndarray:
        if self.t < self.forced_until:
            return np.ones(self.B, bool)
        return traffic.alarms_due(self.mix["schedule_seed"], self.t, self.B,
                                  self.mix["alarm_rate"])[self.lane]

    def step(self, sess, policy) -> dict:
        rows = np.arange(self.B)
        tok = self.toks[rows, self.pos]
        policy.due = due = self.due()
        t0 = time.perf_counter()
        r = sess.step(tok)
        dt = time.perf_counter() - t0
        trig = np.asarray(r["triggered"], bool)
        for slot in range(self.B):
            rec = self.rec[int(self.sid[slot])]
            p = self.pos[slot]
            rec["u"][p], rec["fhat"][p] = r["u"][slot], r["fhat"][slot]
            rec["triggered"][p] = float(trig[slot])
            rec["due"][p] = float(due[slot])
        info = {"seconds": dt, "alarms": int(trig.sum()),
                "obs": self.B, "pos": self.pos.copy(),
                "server_pos": self.server_pos.copy(), "triggered": trig,
                "sids": self.sid.copy()}
        self.steps.append(info)
        self.server_pos = np.where(trig, self.pos + 1, self.server_pos)
        self.pos = self.pos + 1
        self.t += 1
        for slot in np.nonzero(self.pos >= self.life)[0]:
            sess.detach(int(self.sid[slot]))
            new = self.next_id
            self.next_id += 1
            got = sess.attach(new)
            if got != slot:
                raise RuntimeError(f"stream {new} took slot {got}, not {slot}")
            self.sid[slot], self.pos[slot], self.server_pos[slot] = new, 0, 0
            self.life[slot] = self.L
            self.toks[slot] = self._tokens(new)
            self.rec[new] = self._record()
        return info


def rounds(info: dict):
    """Each catch-up round of a step: the positions its active rows
    decode."""
    trig = info["triggered"]
    if not trig.any():
        return []
    sp, pos = info["server_pos"][trig], info["pos"][trig]
    n = int(np.max(pos + 1 - sp))
    return [(sp + r)[sp + r <= pos] for r in range(n)]


def step_flops(info: dict, p: dict) -> float:
    """Useful model flops of a step: the edge tower per observation at its
    position, the server per replayed token at its position."""
    e = spec.edge_block(p)
    m = p["monitor"]
    f = 0.0
    for q in info["pos"]:
        f += (counts.dense_token_flops(e, min(q + 1, e["window"]),
                                       unembed=False)
              + 2.0 * m["d_model"] * m["n_features"])
    for act in rounds(info):
        for q in act:
            f += (counts.dense_token_flops(p, q + 1, unembed=False)
                  + 2.0 * p["d_model"])
    return f


def decode_bound_s(infos: List[dict], p: dict) -> float:
    """The least time the server's decode attention could take over these
    steps, counting only the active rows of every round and layer."""
    hd, elt = spec.head_dim(p), 2
    total = 0.0
    for info in infos:
        for act in rounds(info):
            fl, nb = counts.decode_rows(act, p["n_heads"], p["n_kv_heads"],
                                        hd, elt)
            total += p["n_layers"] * counts.bound_s(
                fl, nb, counts.PEAKS["bf16_flops"])
    return total


def run(ctx) -> dict:
    from repro_torch import kernels
    from repro_torch.serving import MonitorSession, SessionConfig
    p, mix, dev, seed = ctx.p, ctx.mix, ctx.device, ctx.seed
    cfg, model = port.collab_model(p, seed, dev)
    policy = scheduled_policy()
    sess = MonitorSession.open(
        model, cfg, batch=mix["streams"], max_len=mix["max_len"], device=dev,
        config=SessionConfig(mode=mix["mode"], policy=policy,
                             trace=bool(ctx.trace)))
    fleet = Fleet(seed, mix, p["vocab_size"])
    for _ in range(mix["max_len"]):
        fleet.step(sess, policy)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.reset_peak()
    first = len(fleet.steps)
    spans0 = len(sess.tracer.spans()) if sess.tracer is not None else 0
    t0 = time.perf_counter()
    while True:
        fleet.step(sess, policy)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    peak = ctx.peak()
    win = fleet.steps[first:]
    lat_ms = np.concatenate([np.full(i["alarms"], i["seconds"] * 1e3)
                             for i in win])
    obs = sum(i["obs"] for i in win)
    out = {"attempted": obs, "failed": 0, "memory_peak_bytes": peak,
           "metrics": {"setup_s": setup_s, "obs_per_s": obs / window_s,
                       "alarm_ms_p95": (float(np.percentile(lat_ms, 95))
                                        if lat_ms.size else None)},
           "diag": {"setup_s": setup_s, "window_s": window_s,
                    "steps": len(win), "alarms": int(lat_ms.size),
                    "positions": int(fleet.pos.max()),
                    "rounds": [len(rounds(i)) for i in win],
                    "step_ms": [round(i["seconds"] * 1e3, 1) for i in win]}}
    if ctx.trace:
        # what the per-layer readers read
        run_ = SimpleNamespace(p=p, mix=mix, peak_bytes=peak)
        run_.window_s, run_.steps = window_s, len(win)
        run_.spans = sess.tracer.spans()[spans0:]
        run_.useful_flops = sum(step_flops(i, p) for i in win)

        def steps(n):
            for _ in range(n):
                fleet.step(sess, policy)

        prof = profiling.trace_steps(torch, steps, mix["profile_steps"],
                                     kernels.launch_counts)
        traced = fleet.steps[len(fleet.steps) - prof["steps"]:]
        prof["decode_bound_s"] = decode_bound_s(traced, p)
        prof["decode_server"] = f", {spec.head_dim(p)}, " \
            f"{p['n_heads'] // p['n_kv_heads']}>"
        run_.profile = prof
        out["run"] = run_
    sess.close()
    del sess, model
    gc.collect()
    ctx.free()
    t1 = time.perf_counter()
    out["numbers"] = check(ctx, fleet, first)
    out["diag"]["check_s"] = time.perf_counter() - t1
    return out


def check(ctx, fleet: Fleet, first: int) -> Dict[str, float]:
    """The reference over a seeded sample of ``check_streams`` of the
    streams served in the window, with the longest of them, at every
    position each was served."""
    p, mix = ctx.p, ctx.mix
    served = sorted({int(s) for i in fleet.steps[first:] for s in i["sids"]})
    length = {s: int(np.sum(~np.isnan(fleet.rec[s]["u"]))) for s in served}
    longest = max(served, key=lambda s: (length[s], -s))
    rest = [s for s in served if s != longest]
    rng = np.random.default_rng([int(ctx.seed) % (1 << 64), 9])
    n = min(len(rest), mix["check_streams"] - 1)
    pick = sorted([longest] + rng.choice(rest, size=n, replace=False)
                  .tolist())
    T = length[longest]
    tokens = np.stack([fleet._tokens(s)[:T] for s in pick])
    u_ref, v_ref = ref_serve.scores(ctx.seed, p, tokens, ctx.device)
    rec = {k: np.stack([fleet.rec[s][k][:T] for s in pick])
           for k in ("u", "fhat", "triggered", "due")}
    s = p["monitor"].get("s", 0.2)
    numbers = judge.fleet_numbers(rec, u_ref, v_ref, s)
    if ctx.control:
        # the reference in float8 put in the program's place: its own
        # u and verdicts at the same served positions and alarms
        u8, v8 = ref_serve.scores(ctx.seed, p, tokens, ctx.device, "fp8")
        ok = ~np.isnan(rec["u"])
        trig = ok & (rec["due"] > 0.5)
        ctl = {"u": np.where(ok, u8, np.nan), "due": rec["due"],
               "triggered": trig.astype(float),
               "fhat": np.where(trig, u8 - s / (1.0 + np.exp(-v8)), u8)}
        ctx.readings["control"] = judge.fleet_numbers(ctl, u_ref, v_ref, s)
    return numbers
