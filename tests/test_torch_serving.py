"""Port serving against the JAX package, and the port's own invariants.

The JAX prefill/decode steps are jitted (un-jitted interpret-mode decode
costs about a second a step on the CPU). Tolerances, per element:
  * f32 logits and caches: 1e-4 absolute (whole layers; the two sides sum
    matrix products in other orders);
  * bf16: 2e-2 + 2e-2*|ref| (8 bits of mantissa; rounding points differ).
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _setup(dtype, **kw):
    jcfg = tiny_cfg("serve", dtype=DTYPES[dtype], **kw)
    cfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    flat = {path_str(p): np.asarray(x.astype(jnp.float32)) for p, x in leaves}
    return jcfg, cfg, jparams, load_flat(flat, cfg, device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


# ------------------------------------------ (g) prefill/decode against JAX

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_steps_match_jax(dtype):
    jcfg, cfg, jparams, params = _setup(dtype, vocab_size=200)
    B, P, max_seq, n_dec = 2, 8, 16, 4
    toks = _tokens(5, (B, P + n_dec), jcfg.vocab_size)

    jpre = jax.jit(JS.make_prefill_step(jcfg, max_seq))
    jdec = jax.jit(JS.make_decode_step(jcfg))
    jstate, jlog = jpre(jparams, jnp.asarray(toks[:, :P]))
    state, log = TS.make_prefill_step(cfg, max_seq)(
        params, torch.from_numpy(toks[:, :P]))
    decode = TS.make_decode_step(cfg)

    def check(state, log, jstate, jlog):
        assert int(state.index) == int(jstate.index)
        assert state.index.dtype == torch.int32
        _close(log, jlog, dtype)
        for kv in ("k", "v"):
            got = state.cache["seg0_dense"]["attn"][kv]
            want = jstate.cache["seg0_dense"]["attn"][kv]
            assert tuple(got.shape) == want.shape  # (L, B, max_seq, K, hd)
            _close(got, want, dtype)

    check(state, log, jstate, jlog)
    for i in range(P, P + n_dec):
        t = toks[:, i:i + 1]
        jstate, jlog = jdec(jparams, jstate, jnp.asarray(t))
        state, log = decode(params, state, torch.from_numpy(t))
        check(state, log, jstate, jlog)


def test_greedy_generate_token_ids_match_jax():
    jcfg, cfg, jparams, params = _setup("f32")
    prompt = _tokens(6, (2, 8), jcfg.vocab_size)
    want = JS.greedy_generate(jcfg, jparams, jnp.asarray(prompt), n_steps=6,
                              max_seq=16)
    got = TS.greedy_generate(cfg, params, prompt, n_steps=6, max_seq=16,
                             device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------- (h) prefill+decode == full forward

@pytest.mark.parametrize("name,kw", [("gqa", {}),
                                     ("tied_pad", dict(tie_embeddings=True,
                                                       vocab_size=200))])
def test_prefill_decode_matches_full(name, kw):
    cfg = tconfig.ModelConfig(**dataclasses.asdict(tiny_cfg(name, **kw)))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    B, S, P = 2, 32, 24
    toks = torch.from_numpy(_tokens(7, (B, S), cfg.vocab_size))
    with torch.no_grad():
        h, _, _ = TM.forward(params, cfg, toks)
        ref = TM.logits_from_hidden(params, cfg, h)[:, -1]
    state, logits = TS.make_prefill_step(cfg, max_seq=S)(params, toks[:, :P])
    assert int(state.index) == P
    cache_k = state.cache["seg0_dense"]["attn"]["k"]
    decode = TS.make_decode_step(cfg)
    for i in range(P, S):
        state, logits = decode(params, state, toks[:, i:i + 1])
    # the decode step writes the preallocated cache in place
    assert state.cache["seg0_dense"]["attn"]["k"] is cache_k
    assert int(state.index) == S
    torch.testing.assert_close(logits[:, -1], ref, atol=2e-4, rtol=0)


def test_greedy_generate_rejects_overflowing_cache():
    cfg = tconfig.ModelConfig(**dataclasses.asdict(tiny_cfg("ovf")))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq=8"):
        TS.greedy_generate(cfg, params, np.zeros((1, 6), np.int32),
                           n_steps=4, max_seq=8, device="cpu")


# --------------------------------------------- (i) the card is the default

def test_entry_points_default_to_cuda():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return  # on the card the defaults simply run there
    cfg = tconfig.ModelConfig(**dataclasses.asdict(tiny_cfg("dev")))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    flat = {k: v.numpy() for k, v in TM.flatten(params).items()}
    calls = [
        lambda: resolve_device(),
        lambda: TM.init_params(cfg, torch.Generator().manual_seed(0)),
        lambda: TM.init_cache(cfg, 1, 8),
        lambda: load_flat(flat, cfg),
        lambda: TS.greedy_generate(cfg, params, np.zeros((1, 4), np.int32),
                                   n_steps=2, max_seq=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device cuda requested but no "
                           "CUDA device"):
            call()


# ---------------------------------------------- (j) no JAX in the port

def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(REPO)} imports {mod}"
