"""The port's text generation (ServeEngine.prefill / sample / generate)
against the JAX reference's engine on the same weights, dense and hybrid,
and checkpoints that cross frameworks in both directions
(training/checkpoint.py), for the collaborative LM and the paper-scale
tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.serving.engine import ServeEngine as JEngine
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch import bridge
from repro_torch.core import decomposition as tdeco
from repro_torch.core.decomposition import CollabLM, collab_forward
from repro_torch.data.synthetic import financial_series, financial_xy
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.loop import to_device, trainable
from repro_torch.training.optimizer import SGD, AdamW

from _torch_parity import TOL, TOL_E2E, configs, token_stream

GEN_ARCHS = ("granite-8b", "paper-synthetic", "zamba2-7b")
B, PROMPT, NEW, MAX_LEN = 3, 6, 6, 16
_PAIRS = {}



@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many tiny ops: one intra-op thread is as fast alone
    and does not thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def pair(arch):
    """(JAX cfg, port cfg, reference params, the port's model with the same
    weights on the CPU): the reference's init_collab_lm, jit-compiled (half
    the time of its op-by-op run), drawn once per process."""
    if arch not in _PAIRS:
        jcfg, tcfg = configs(arch)
        params = jax.jit(lambda k: jdeco.init_collab_lm(k, jcfg))(
            jax.random.PRNGKey(0))
        model = bridge.collab_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
        _PAIRS[arch] = (jcfg, tcfg, params, model)
    return _PAIRS[arch]


def _ref_generate(jcfg, params, prompt, n_new):
    """The reference's generate, its logits kept: prefill, then n_new
    decode steps, each token the argmax of the logits before it."""
    eng = JEngine(params, jcfg, B, MAX_LEN)
    logits = eng.prefill(jnp.asarray(prompt))
    toks, seen = [], []
    tok = eng.sample(logits)
    for _ in range(n_new):
        toks.append(np.asarray(tok))
        seen.append(np.asarray(logits, np.float32))
        logits, _ = eng.decode(tok)
        tok = eng.sample(logits)
    return np.stack(toks, 1), np.stack(seen, 1)


def compare_greedy(tokens, logits, ref_tokens, ref_logits, tol):
    """Logits within ``tol`` (atol and rtol) and tokens equal, row by row,
    up to a row's first differing token, which is allowed only where the
    reference's top-2 margin is inside the tie band (twice the logit
    tolerance); a row is not compared past it.  Returns the number of such
    tie-band positions."""
    ties = 0
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    band = 2 * tol * (1 + np.abs(top2[..., 1]))
    for b in range(tokens.shape[0]):
        for j in range(tokens.shape[1]):
            np.testing.assert_allclose(logits[b, j], ref_logits[b, j],
                                       atol=tol, rtol=tol,
                                       err_msg=f"row {b} step {j}")
            if tokens[b, j] != ref_tokens[b, j]:
                assert margin[b, j] <= band[b, j], (b, j, margin[b, j])
                ties += 1
                break
    return ties


@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_greedy_generate_matches_reference(arch):
    """granite-8b SMOKE (f32), the paper's SERVING (bf16) and zamba2-7b
    SMOKE (f32, hybrid): the prefill's last logits and every generated
    step's logits within the end-to-end tolerance, tokens equal outside
    the tie band; the engine's position ends at prompt + n_new."""
    jcfg, tcfg, params, model = pair(arch)
    prompt = token_stream(tcfg, B, PROMPT, seed=3)
    want_toks, want_logits = _ref_generate(jcfg, params["server"], prompt,
                                           NEW)
    eng = ServeEngine(model.server, tcfg, B, MAX_LEN, "cpu")
    toks, logits = eng.generate(torch.as_tensor(prompt), NEW,
                                return_logits=True)
    assert toks.shape == (B, NEW) and toks.dtype == torch.int32
    assert eng.pos == PROMPT + NEW
    tol = TOL_E2E[tcfg.dtype]
    pre = ServeEngine(model.server, tcfg, B, MAX_LEN, "cpu")
    np.testing.assert_allclose(pre.prefill(prompt).numpy(),
                               want_logits[:, 0], atol=tol, rtol=tol)
    assert pre.pos == PROMPT
    ties = compare_greedy(toks.numpy(), logits.numpy(), want_toks,
                          want_logits, tol)
    print(f"{arch}: {ties} of {B * NEW} generated positions in the tie band")
    if arch == "paper-synthetic":  # the loop above is the reference's own
        ref = JEngine(params["server"], jcfg, B, MAX_LEN).generate(
            jnp.asarray(prompt), NEW)
        np.testing.assert_array_equal(np.asarray(ref), want_toks)


@pytest.mark.parametrize("arch", ("granite-8b", "zamba2-7b"))
def test_sampling_repeats_itself_from_its_seed(arch):
    """temperature > 0: two engines seeded alike draw bitwise the same
    tokens, another seed draws others; temperature 0 is the argmax."""
    _, tcfg, _, model = pair(arch)
    prompt = torch.as_tensor(token_stream(tcfg, B, PROMPT, seed=4))

    def run(seed, temperature):
        eng = ServeEngine(model.server, tcfg, B, MAX_LEN, "cpu", seed=seed)
        return eng.generate(prompt, 8, temperature=temperature)

    a, b, c = run(5, 1.5), run(5, 1.5), run(6, 1.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
    eng = ServeEngine(model.server, tcfg, B, MAX_LEN, "cpu")
    logits = torch.randn(B, tcfg.vocab_size,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(eng.sample(logits), logits.argmax(-1).to(torch.int32))


def test_sampling_follows_the_softmax():
    """The Gumbel-max draw has the categorical's frequencies."""
    _, tcfg, _, model = pair("granite-8b")
    eng = ServeEngine(model.server, tcfg, B, MAX_LEN, "cpu", seed=1)
    logits = torch.log(torch.tensor([[0.6, 0.3, 0.1]])).repeat(20000, 1)
    freq = torch.bincount(eng.sample(logits, 1.0).long(), minlength=3) / 20000
    np.testing.assert_allclose(freq.numpy(), [0.6, 0.3, 0.1], atol=0.015)


# -------------------------------------------------------------- checkpoints
def _forward_pair(jcfg, tcfg, jparams, model, seed=5):
    toks = token_stream(tcfg, 2, 12, seed=seed)
    batch = {"tokens": toks}
    want = jax.jit(lambda p, t: jdeco.collab_forward(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    with torch.no_grad():
        got = collab_forward(model, tcfg, to_device(batch, "cpu"))
    tol = TOL_E2E[tcfg.dtype]
    for k in ("u", "v", "fhat", "logits"):
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=tol, rtol=tol, err_msg=k)


def _random_like(tree, rng, scale):
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


@pytest.mark.parametrize("arch", ("granite-8b", "paper-synthetic"))
def test_reference_checkpoint_loads_into_the_port(arch, tmp_path):
    """A reference save (params, an AdamState with moments, meta) read by
    the port: the same collab_forward, the moments and count exactly, the
    f32 masters exactly the reference's parameters."""
    jcfg, tcfg, params, _ = pair(arch)
    rng = np.random.default_rng(0)
    st = jopt.AdamW().init(params)
    st = st._replace(count=jnp.asarray(7, jnp.int32),
                     m=_random_like(st.m, rng, 1e-3),
                     v=_random_like(st.v, rng, 1e-6))
    jckpt.save(str(tmp_path), 42, params, st, meta={"arch": arch})
    model = CollabLM(tcfg, "cpu")
    state = AdamW().init(trainable(model))
    step, meta = tckpt.load(str(tmp_path), model, state)
    assert (step, meta) == (42, {"arch": arch}) and state.count == 7
    _forward_pair(jcfg, tcfg, params, model)
    got = bridge.moments_to_numpy(model, state)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(got[key]),
                        jax.tree.leaves(getattr(st, key))):
            np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(bridge.collab_to_numpy(model, state)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", ("granite-8b", "paper-synthetic"))
def test_port_checkpoint_loads_into_the_reference(arch, tmp_path):
    """A port save read by the reference's load into its own templates:
    the same collab_forward, the moments exactly, and each parameter the
    port's f32 master (not its bf16 stored weight) exactly."""
    jcfg, tcfg, params, _ = pair(arch)
    model = bridge.collab_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    opt = AdamW()
    state = opt.init(trainable(model))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # masters off the bf16 grid, moments nonzero
        for p, mw, m, v in zip(model.parameters(), state.master, state.m,
                               state.v):
            m.normal_(0, 1e-3, generator=gen)
            v.uniform_(0, 1e-6, generator=gen)
            if mw is not None:
                mw.add_(torch.randn(mw.shape, generator=gen) * 1e-4)
                p.copy_(mw)
    state.count = 3
    tckpt.save(str(tmp_path), 9, model, state)
    tmpl = jax.tree.map(jnp.zeros_like, params)
    step, jparams, jst = jckpt.load(str(tmp_path), tmpl,
                                    jopt.AdamW().init(tmpl))
    assert step == 9 and int(jst.count) == 3
    _forward_pair(jcfg, tcfg, jparams, model)
    ours = bridge.moments_to_numpy(model, state)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(ours[key]),
                        jax.tree.leaves(getattr(jst, key))):
            np.testing.assert_array_equal(a, np.asarray(b))
    masters = bridge.collab_to_numpy(model, state)
    for a, b in zip(jax.tree.leaves(masters), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    if tcfg.dtype == "bfloat16":
        w = model.server.blocks[0].attn.wq.w
        assert w.dtype == torch.bfloat16 and not np.array_equal(
            w.detach().float().numpy(), masters["server"]["blocks"]["attn"]["wq"]["w"][0])


@pytest.mark.parametrize("u_mode", ("truncated", "independent"))
def test_paper_checkpoint_crosses_both_ways(u_mode, tmp_path):
    """The paper-scale tree: the reference's trained parameters load into
    the port with the same paper_forward, and the port's parameters and
    SGD state (m only, as the reference's SGD) load into the reference."""
    cfg = jreg.get_smoke("paper-financial")
    x, f = financial_xy(financial_series(0, n_days=300))
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (1,)
    rng = np.random.default_rng(0)

    def mlp(dims):
        return {f"l{i}": {"w": rng.standard_normal(dims[i:i + 2]).astype(
            np.float32) / 8, "b": rng.standard_normal(dims[i + 1]).astype(
            np.float32) / 8} for i in range(len(dims) - 1)}

    tree = {"v": mlp(dims), "raw_t": np.float32(-2.5)}
    if u_mode == "independent":
        tree["u_net"] = mlp((29, 10, 1))
    else:
        tree["a"] = rng.standard_normal(cfg.n_basis).astype(np.float32) / 10
    jparams = jax.tree.map(jnp.asarray, tree)
    jckpt.save(str(tmp_path / "ref"), 3, jparams)
    model = tdeco.PaperDecomposition(
        cfg, u_mode=u_mode, u_dims=(29, 10, 1), device="cpu")
    assert tckpt.load(str(tmp_path / "ref"), model)[0] == 3
    want = jax.jit(lambda p, x: jdeco.paper_forward(p, x, cfg, u_mode=u_mode))(
        jparams, jnp.asarray(x))
    with torch.no_grad():
        got = tdeco.paper_forward(model, torch.as_tensor(x), cfg,
                                  u_mode=u_mode)
    for k in ("u", "fhat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL["float32"], rtol=TOL["float32"])
    opt = SGD()
    state = opt.init(trainable(model))
    for m in state.m:
        m.normal_(0, 1e-2)
    state.count = 2
    tckpt.save(str(tmp_path / "port"), 5, model, state)
    step, back, jst = jckpt.load(str(tmp_path / "port"), jparams,
                                 jopt.SGD().init(jparams))
    assert step == 5 and int(jst.count) == 2 and jst.v is None
    for a, b in zip(jax.tree.leaves(bridge.paper_to_numpy(model)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(bridge.moments_to_numpy(model, state)["m"]),
                    jax.tree.leaves(jst.m)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoint_keys_are_the_reference_keystr(tmp_path):
    """The files hold exactly the keys jax.tree_util.keystr gives."""
    jcfg, tcfg, params, model = pair("paper-synthetic")
    state = AdamW().init(trainable(model))
    tckpt.save(str(tmp_path), 0, model, state)
    with np.load(tmp_path / "params.npz") as npz:
        assert set(npz.files) == set(jckpt._flatten(params))
    with np.load(tmp_path / "opt.npz") as npz:
        assert set(npz.files) == set(
            jckpt._flatten(jopt.AdamW().init(params)))
