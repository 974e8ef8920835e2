"""Per-architecture smoke tests of the port, the counterpart of
tests/test_arch_smoke.py: the SMOKE variant of every arch of the port's
registry runs one forward (shapes, no NaN), one collaborative AdamW train
step (finite loss before and after, a gradient on every parameter) and
one decode step against a fresh cache, on the CPU.  No JAX: parity with
the reference is the family tests' (tests/test_torch_families.py,
test_torch_moe.py, test_torch_hybrid.py, test_torch_vlm.py,
test_torch_audio.py, test_torch_xlstm.py)."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import decomposition as deco
from repro_torch.core.losses import collab_lm_loss
from repro_torch.data import tokens as tok
from repro_torch.models import api as model_api
from repro_torch.training.loop import make_train_step, to_device, trainable
from repro_torch.training.optimizer import AdamW

ARCHS = registry.names()
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg):
    return deco.init_collab_lm(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg):
    return to_device(next(tok.lm_batches(0, cfg, B, S)), "cpu")


def test_registry_has_the_ten_lm_archs():
    assert len(ARCHS) == 10 and registry._LATER == ()


@pytest.mark.parametrize("arch", ARCHS)
class TestArchSmoke:
    def test_forward_shapes_no_nan(self, arch):
        cfg = registry.get_smoke(arch)
        model = _model(cfg)
        with torch.no_grad():
            out = model_api.forward(model.server, cfg, _batch(cfg))
        tail = (cfg.n_codebooks,) if cfg.family == "audio" else ()
        assert out["logits"].shape == (B, S) + tail + (cfg.vocab_size,)
        assert out["hidden"].shape == (B, S, cfg.d_model)
        assert torch.isfinite(out["logits"]).all()

    def test_one_train_step(self, arch):
        cfg = registry.get_smoke(arch)
        model = _model(cfg)
        params = trainable(model)
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        batch = _batch(cfg)
        m = make_train_step(cfg, opt)(model, state, batch)
        assert torch.isfinite(m["total"]) and float(m["grad_norm"]) > 0
        assert all(p.grad is not None for p in params)
        with torch.no_grad():
            after = collab_lm_loss(deco.collab_forward(model, cfg, batch),
                                   batch)["total"]
        assert torch.isfinite(after)

    def test_decode_step(self, arch):
        cfg = registry.get_smoke(arch)
        model = _model(cfg)
        cache = model_api.init_cache(cfg, B, S, "cpu")
        tokens = _batch(cfg)["tokens"][:, S - 1]
        with torch.no_grad():
            logits, hidden = model_api.decode_step(model.server, cfg, cache,
                                                   tokens, S - 1)
        tail = (cfg.n_codebooks,) if cfg.family == "audio" else ()
        assert logits.shape == (B,) + tail + (cfg.vocab_size,)
        assert hidden.shape == (B, cfg.d_model)
        assert torch.isfinite(logits).all()
