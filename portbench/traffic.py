"""The general traffic generator: every mix under ``mixes/`` is a JSON
file of parameters that these functions read, and every draw is a
function of ``--seed`` alone.

* Monitoring streams (the ``fleet`` runner): stream ``i`` of a run is a
  sequence of ``max_len`` token ids drawn uniformly over the vocabulary
  from the seed and ``i``, so a replacement stream is as determined as
  the first ones, however fast the program runs.  The fleet's slots run
  lanes: lane ``k``'s first stream sends 1 + (k * max_len) // streams
  tokens and every later one max_len, and at global step ``t`` the
  lanes due an alarm are a Bernoulli draw at the mix's alarm rate from
  the mix's ``schedule_seed`` and ``t``.  The run's seed only deals the
  lanes to the slots, so every seed gets the same lengths and alarms
  (the same work a step) in another order.
* Language-model batches (the ``train`` runner): a frozen copy of the port's
  ``data/tokens.py::lm_batches`` (Zipf draws with a Markov bigram
  successor) and ``data/synthetic.py::monitoring_target`` (the health
  index the monitor is trained on), every batch a fresh draw.
Imports nothing of the program."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator

import numpy as np

HERE = Path(__file__).resolve().parent
STREAM, LANES, LM = 1, 2, 3   # the draws' tags under one seed


def load_mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


def stream_tokens(seed: int, stream: int, length: int,
                  vocab: int) -> np.ndarray:
    """Stream ``stream``'s token ids, (length,) int64, uniform."""
    return _rng(seed, STREAM, stream).integers(0, vocab, length,
                                               dtype=np.int64)


def lane_order(seed: int, batch: int) -> np.ndarray:
    """The lane each slot runs: a seeded permutation of 0..batch-1."""
    return _rng(seed, LANES).permutation(batch)


def first_lives(batch: int, length: int) -> np.ndarray:
    """Lane k's first stream sends 1 + (k * length) // batch tokens, so
    once the first streams are all replaced every age from 0 to
    length - 1 is held by as many lanes."""
    return 1 + (np.arange(batch) * length) // batch


def alarms_due(schedule_seed: int, step: int, batch: int,
               rate: float) -> np.ndarray:
    """(batch,) bool over lanes: the lanes due an alarm at global step
    ``step``, independently at ``rate``; the same for every run seed."""
    return np.random.default_rng([int(schedule_seed), int(step)]).random(
        batch) < rate


def zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(vocab, size=shape, p=probs).astype(np.int32)


def markov_stream(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                  d: dict) -> np.ndarray:
    base = zipf_tokens(rng, (batch, seq), vocab, d["zipf_a"])
    succ = (d["succ_mul"] * base[:, :-1] + d["succ_add"]) % vocab
    use_succ = rng.uniform(size=(batch, seq - 1)) < d["order_mix"]
    out = base.copy()
    out[:, 1:] = np.where(use_succ, succ, base[:, 1:])
    return out


def monitoring_target(tokens: np.ndarray, vocab: int, d: dict) -> np.ndarray:
    """Per-position health index: an EWMA of occurrences of a fixed
    pseudo-random hazardous subset of the vocabulary, plus a slow
    sinusoidal drift.  (B, S) -> (B, S) float32."""
    frac = d["hazard_frac"]
    rng = np.random.default_rng(d["hazard_seed"])
    hazard = (rng.uniform(size=vocab) < frac).astype(np.float32)
    h = hazard[tokens.reshape(-1)].reshape(tokens.shape)
    B, S = tokens.shape
    f = np.zeros((B, S), np.float32)
    acc = np.zeros((B,), np.float32)
    for t in range(S):
        acc = d["ewma"] * acc + (1 - d["ewma"]) * h[:, t]
        f[:, t] = acc
    f = f / (frac + 1e-9)
    drift = 0.3 * np.sin(2 * np.pi * np.arange(S) / d["drift_period"])
    return (f + drift[None, :] - 0.5).astype(np.float32)


def lm_batches(seed: int, vocab: int, batch: int, seq: int,
               d: dict) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens, labels (B, S) int32, monitor_target
    (B, S) f32}, each batch a fresh draw."""
    rng = _rng(seed, LM)
    while True:
        toks = markov_stream(rng, batch, seq + 1, vocab, d)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "monitor_target": monitoring_target(toks[:, :-1], vocab, d)}
