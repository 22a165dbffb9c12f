"""Port model code against the JAX package on the same inputs: config and
registry, the weight bridge, the dense layers, and the full forward with
logits. Inputs are made with numpy from a seed and handed to both sides.

Tolerances, per element:
  * f32 layers: 2e-5 absolute (unit-scale activations; the two sides
    sum matrix products in other orders);
  * f32 hidden states and logits after whole layers: 1e-4 absolute;
  * bf16: 2e-2 + 2e-2*|ref| — bf16 keeps 8 bits of mantissa, and the two
    sides round matmul outputs at slightly different places.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import load_flat, to_flat  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype, atol_f32=2e-5):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=atol_f32, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _tcfg(jcfg):
    """The port's ModelConfig with every field of a JAX one."""
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def jax_flat(params) -> dict:
    """JAX param tree -> {path_str: f32 numpy} (the bridge's input)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {path_str(p): np.asarray(x.astype(jnp.float32)) for p, x in leaves}


MODEL_CFGS = {
    "gqa": dict(),                                   # tiny_cfg: H=4, K=2
    "padvocab": dict(vocab_size=200),                # 200 -> 256 padded
    "tied": dict(tie_embeddings=True, vocab_size=200),
}
BRIDGE_CFGS = {**MODEL_CFGS,
               "qkvbias_gelu_learned": dict(qkv_bias=True, mlp_kind="gelu",
                                            pos_embed="learned",
                                            max_position=64)}


# --------------------------------------------------------- (c) config/registry

def test_model_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.ModelConfig)]
    assert tf == jf
    j, t = jconfig.ModelConfig(), tconfig.ModelConfig()
    for prop in ("head_dim", "padded_vocab", "segments", "d_inner"):
        assert getattr(t, prop) == getattr(j, prop)
    assert t.torch_dtype == torch.bfloat16
    assert tconfig.ModelConfig(dtype="float32").torch_dtype == torch.float32


@pytest.mark.parametrize("arch", list(jreg.LLAMA_PAPER) + list(jreg.PAPER_EXTRA))
def test_get_arch_matches_jax_field_by_field(arch):
    j, t = jreg.get_arch(arch), treg.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.padded_vocab, t.segments) == \
        (j.head_dim, j.padded_vocab, j.segments)
    assert t.num_params() == j.num_params()


def test_get_arch_unported_families_raise():
    """No ``ARCH_IDS`` family is left unported (the VLM and audio were the
    last): every id resolves to JAX's config, and only an id outside the
    registry raises."""
    unported = [a for a in jreg.ARCH_IDS if a not in treg._MODULES]
    assert unported == []
    for arch in jreg.ARCH_IDS:
        assert dataclasses.asdict(treg.get_arch(arch)) == \
            dataclasses.asdict(jreg.get_arch(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("no-such-arch")


# -------------------------------------------------------------- (d) bridge

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(BRIDGE_CFGS))
def test_weight_bridge_keys_and_round_trip(name, dtype):
    jcfg = tiny_cfg(name, dtype={"f32": "float32", "bf16": "bfloat16"}[dtype],
                    **BRIDGE_CFGS[name])
    cfg = _tcfg(jcfg)
    flat = jax_flat(JM.init_params(jax.random.PRNGKey(0), jcfg))
    assert set(flat) == set(TM.param_shapes(cfg))
    params = load_flat(flat, cfg, device="cpu")
    assert set(params.state_dict()) == {k.replace("/", ".") for k in flat}
    assert tuple(params.state_dict()["segments.seg0_dense.attn.wq"].shape) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.n_heads * jcfg.head_dim)
    back = to_flat(params)
    assert set(back) == set(flat)
    for k in flat:  # bitwise, bf16 included
        np.testing.assert_array_equal(back[k], flat[k])
        assert params.state_dict()[k.replace("/", ".")].dtype == cfg.torch_dtype


def test_weight_bridge_rejects_wrong_tree():
    jcfg = tiny_cfg("gqa")
    flat = jax_flat(JM.init_params(jax.random.PRNGKey(0), jcfg))
    flat.pop("lm_head/w")
    with pytest.raises(KeyError, match="lm_head/w"):
        load_flat(flat, _tcfg(jcfg), device="cpu")


def test_init_params_follows_jax_init_rules():
    cfg = _tcfg(tiny_cfg("qkv", qkv_bias=True))
    p = TM.flatten(TM.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    assert {k: tuple(v.shape) for k, v in p.items()} == TM.param_shapes(cfg)
    assert (p["final_norm/s"] == 1).all()
    assert (p["segments/seg0_dense/attn/norm"] == 1).all()
    assert (p["segments/seg0_dense/attn/bq"] == 0).all()
    std = p["segments/seg0_dense/ffn/w_up"].std().item()
    assert abs(std - 0.02) < 0.002


# --------------------------------------------------------------- (e) layers

def _layer_inputs(seed, cfg, B=2, S=12):
    rng = np.random.default_rng(seed)
    D, H, K, hd, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    shapes = {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
              "wo": (H * hd, D), "w_gate": (D, Fd), "w_up": (D, Fd),
              "w_down": (Fd, D)}
    p = {k: (rng.standard_normal(s, dtype=np.float32) / math.sqrt(s[0]))
         for k, s in shapes.items()}
    return x, p


def _both(arr, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _both(3 * rng.standard_normal((2, 5, 64), dtype=np.float32), dtype)
    sj, st = _both(1 + rng.standard_normal(64, dtype=np.float32), dtype)
    got = TL.rmsnorm(xt, st, 1e-5)
    assert got.dtype == xt.dtype
    _close(got, JL.rmsnorm(xj, sj, 1e-5), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 9, 4, 32), dtype=np.float32), dtype)
    pos = np.arange(100, 109)  # decode-like positions past the prompt
    cj, sj = JL.rope_tables(jnp.asarray(pos), 32, 10000.0)
    ct, stab = TL.rope_tables(torch.from_numpy(pos), 32, 10000.0)
    _close(ct, cj, "f32", atol_f32=1e-5)  # f32 angles up to 108 rad
    _close(stab, sj, "f32", atol_f32=1e-5)
    _close(TL.apply_rope(xt, ct, stab), JL.apply_rope(xj, cj, sj), dtype,
           atol_f32=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp_matches_jax(kind, dtype):
    cfg = tiny_cfg("mlp", mlp_kind=kind)
    x, p = _layer_inputs(2, cfg)
    xj, xt = _both(x, dtype)
    names = ("w_up", "w_down") if kind == "gelu" else ("w_gate", "w_up",
                                                       "w_down")
    pj = {k: _both(p[k], dtype)[0] for k in names}
    pt = {k: _both(p[k], dtype)[1] for k in names}
    want = JL.apply_mlp(pj, cfg, xj, Rules())
    _close(TL.apply_mlp(pt, _tcfg(cfg), xt), want, dtype, atol_f32=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_attention_matches_jax(dtype):
    cfg = tiny_cfg("attn")  # H=4, K=2, hd=16
    x, p = _layer_inputs(3, cfg)
    xj, xt = _both(x, dtype)
    names = ("wq", "wk", "wv", "wo")
    pj = {k: _both(p[k], dtype)[0] for k in names}
    pt = {k: _both(p[k], dtype)[1] for k in names}
    S = x.shape[1]
    want, _ = jax.jit(lambda p, x: JL.apply_attention(
        p, cfg, x, jnp.arange(S), Rules(), mode="train"))(pj, xj)
    got, _ = TL.apply_attention(pt, _tcfg(cfg), xt, torch.arange(S))
    _close(got, want, dtype, atol_f32=1e-4)


# -------------------------------------------------- (f) forward and logits

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_forward_and_logits_match_jax(name, dtype):
    jcfg = tiny_cfg(name, dtype={"f32": "float32", "bf16": "bfloat16"}[dtype],
                    **MODEL_CFGS[name])
    cfg = _tcfg(jcfg)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = load_flat(jax_flat(jparams), cfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 24),
                                             dtype=np.int32)

    def jfwd(p, t):
        h, _, _ = JM.forward(p, jcfg, t)
        return h, JM.logits_from_hidden(p, jcfg, h)

    h_j, lg_j = jax.jit(jfwd)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        h_t, _, _ = TM.forward(params, cfg, torch.from_numpy(toks))
        lg_t = TM.logits_from_hidden(params, cfg, h_t)
    assert h_t.dtype == cfg.torch_dtype and lg_t.dtype == cfg.torch_dtype
    _close(h_t, h_j, dtype, atol_f32=1e-4)
    _close(lg_t, lg_j, dtype, atol_f32=1e-4)
    if cfg.padded_vocab != cfg.vocab_size:  # pad columns pinned at -1e9
        pad = lg_t[..., cfg.vocab_size:].float()
        assert pad.numel() and (pad == float(torch.tensor(
            -1e9, dtype=cfg.torch_dtype))).all()
