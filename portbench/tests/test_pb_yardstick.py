"""The yardstick on the CPU: counts against hand counts and the port's own
arithmetic, the draws depend on the seed alone, the spec names every leaf
of the port's model, the seeded weights follow the port's distributions."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench import counts, spec, traffic, weights


def test_attention_pairs_by_hand():
    assert counts.attention_pairs(4, 4, 0) == 10          # 1 + 2 + 3 + 4
    assert counts.attention_pairs(5, 5, 2) == 9           # 1 + 2 + 2 + 2 + 2
    assert counts.attention_pairs(3, 8, 0) == 6


def test_counts_equal_the_ports():
    from repro_torch.kernels import ops, ssm_scan
    for S, T, w in ((4096, 4096, 0), (4096, 4096, 1024), (77, 77, 10)):
        assert counts.attention_pairs(S, T, w) == ops.attention_pairs(S, T, w)
    for args in ((2, 4096, 112, 128, 64, 64), (1, 300, 4, 128, 64, 16)):
        assert counts.ssd_flops(*args) == ssm_scan.ssd_flops(*args)


def test_ssd_flops_by_hand():
    # one chunk of 2 rows, B = H = P = N = 1: C B^T over 3 pairs (2 flops
    # each), G @ xdt over 3 pairs, 4 n N P for the state
    assert counts.ssd_flops(1, 2, 1, 2, 1, 1) == 1 * 2 * 3 * 1 + (2 * 3 + 8)


def test_flash_and_decode_counts_by_hand():
    fl, nb = counts.flash_call(1, 2, 1, 1, 4, 4, 0, 2)
    assert fl == 2.0 * (4 + 4) * 3
    assert nb == 2 * (2 * 4 + 2 * 8 + 2 * 4) + 4 * 2
    fl, nb = counts.decode_rows([0, 2], 4, 2, 8, 2)
    assert fl == 4.0 * 4 * 8 * (1 + 3)
    assert nb == 2 * (2 * 1 * 2 * 8 + 2 * 4 * 8) + 2 * (2 * 3 * 2 * 8
                                                         + 2 * 4 * 8)
    assert counts.bound_s(1e12, 0, 1e12) == 1.0
    assert counts.bound_s(0, counts.PEAKS["hbm_bytes_per_s"], 1.0) == 1.0


def test_train_flops_by_hand():
    p = tiny.GRANITE
    B, S = 1, 4
    d, ff, V, L = 256, 512, 512, 2
    proj = L * (2 * d * 4 * 64 + 2 * d * 2 * 64 + 3 * d * ff)
    attn = L * 4 * 4 * 64 * (10 / 4)
    server = B * S * (2 * proj + attn + 2 * d * V)
    e = spec.edge_block(p)
    eproj = 1 * (4 * 64 * 64 + 3 * 64 * 128)
    edge = B * S * (2 * eproj + 1 * 4 * 2 * 32 * (10 / 4) + 2 * 64 * 16
                    + 2 * d)
    assert e["n_layers"] == 1
    assert counts.train_flops(p, B, S) == pytest.approx(3 * (server + edge))


def test_peaks_are_the_published_ones():
    assert counts.PEAKS["bf16_flops"] == 989e12
    assert counts.PEAKS["tf32_flops"] == 495e12
    assert counts.PEAKS["f32_flops"] == 67e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_draws_depend_on_the_seed_alone():
    a = traffic.stream_tokens(2**31 + 9, 5, 64, 49152)
    traffic.stream_tokens(2**31 + 9, 6, 64, 49152)
    b = traffic.stream_tokens(2**31 + 9, 5, 64, 49152)
    c = traffic.stream_tokens(2**31 + 10, 5, 64, 49152)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 49152
    o1 = traffic.lane_order(7, 16)
    assert np.array_equal(o1, traffic.lane_order(7, 16))
    assert not np.array_equal(o1, traffic.lane_order(8, 16))
    assert sorted(o1) == list(range(16))
    d = traffic.load_mix("train")["data"]
    g1, g2 = (traffic.lm_batches(3, 512, 2, 16, d) for _ in range(2))
    for _ in range(2):
        x, y = next(g1), next(g2)
        for k in x:
            assert np.array_equal(x[k], y[k])
    assert not np.array_equal(next(g1)["tokens"],
                              next(traffic.lm_batches(4, 512, 2, 16, d))
                              ["tokens"])


def test_frozen_copies_equal_the_ports():
    from repro_torch.data import synthetic, tokens
    d = traffic.load_mix("train")["data"]
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    a = traffic.markov_stream(r1, 2, 40, 300, d)
    b = tokens.markov_stream(r2, 2, 40, 300)
    assert np.array_equal(a, b)
    assert np.array_equal(traffic.monitoring_target(a, 300, d),
                          synthetic.monitoring_target(a, 300))


@pytest.mark.parametrize("which", ["tiny-granite", "tiny-zamba2",
                                   "granite-8b", "granite-8b.pp3",
                                   "zamba2-7b.pp3"])
def test_spec_names_every_leaf_of_the_port(which):
    from portbench import port
    from repro_torch.core.decomposition import CollabLM
    if which.startswith("tiny"):
        p = tiny.GRANITE if which == "tiny-granite" else tiny.ZAMBA
    else:
        p = json.loads((tiny.ROOT / "portbench" / "configs"
                        / f"{which}.json").read_text())["port"]
    model = CollabLM(port.arch(p), "meta")
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in model.named_parameters()]
    assert sorted(got) == sorted(spec.leaves(p))


def test_weights_follow_the_ports_distributions():
    p = tiny.GRANITE
    g = spec.groups(p)
    a = weights.draw_group(11, "server.blocks.0", g["server.blocks.0"], p,
                           torch.device("cpu"))
    b = weights.draw_group(11, "server.blocks.0", g["server.blocks.0"], p,
                           torch.device("cpu"))
    c = weights.draw_group(12, "server.blocks.0", g["server.blocks.0"], p,
                           torch.device("cpu"))
    w = a["server.blocks.0.mlp.w_gate.w"]
    assert w.dtype == torch.bfloat16 and torch.equal(
        w, b["server.blocks.0.mlp.w_gate.w"])
    assert not torch.equal(w, c["server.blocks.0.mlp.w_gate.w"])
    assert float(w.float().std()) == pytest.approx(1 / 16, rel=0.05)
    assert torch.equal(a["server.blocks.0.ln_attn.scale"],
                       torch.ones(256))
    z = tiny.ZAMBA
    m = weights.draw_group(3, "server.mamba_blocks.0.0",
                           spec.groups(z)["server.mamba_blocks.0.0"], z,
                           torch.device("cpu"))
    H = spec.ssm_dims(z)["H"]
    assert torch.allclose(m["server.mamba_blocks.0.0.mamba.A_log"],
                          torch.log(torch.linspace(1, 16, H)))
    assert float(m["server.mamba_blocks.0.0.mamba.conv_x.w"].std()) == \
        pytest.approx(0.5, rel=0.1)


def test_mix_files_are_data():
    for name in ("fleet", "train"):
        mix = traffic.load_mix(name)
        json.dumps(mix)
        assert mix["runner"] in ("fleet", "train")
    assert traffic.load_mix("fleet")["alarm_rate"] == 0.15


def test_fleet_schedule_is_the_same_work_for_every_seed():
    """Two seeds deal the lanes to other slots, and give every step the
    same set of first lengths and the same set of alarms."""
    B, L, rate = 64, 32, 0.15
    lives = traffic.first_lives(B, L)
    assert lives.min() == 1 and lives.max() == L
    a, b = traffic.lane_order(2**31 + 1, B), traffic.lane_order(2**31 + 2, B)
    assert not np.array_equal(a, b)
    assert sorted(lives[a]) == sorted(lives[b])
    n = 0
    for t in range(40):
        due = traffic.alarms_due(27, t, B, rate)
        assert np.array_equal(due, traffic.alarms_due(27, t, B, rate))
        assert sorted(zip(lives[a], due[a])) == sorted(zip(lives[b], due[b]))
        n += int(due.sum())
    assert 0.05 < n / (40 * B) < 0.3
