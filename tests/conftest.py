"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real single
CPU device; only launch/dryrun.py forces 512 placeholder devices."""
import jax
import jax.numpy as jnp
import pytest

# one canonical REPRO_FUSED pin helper (tests force dispatch routes, e.g.
# 'off' for the jnp reference paths); `python -m pytest` from the repo
# root — the documented tier-1 command — puts `benchmarks` on sys.path
from benchmarks.common import repro_fused  # noqa: F401  (re-exported)
from repro.models import ModelConfig


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def tiny_cfg(name="tiny", **kw):
    base = dict(name=name, family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
                attn_kv_block=16, attn_q_block=16, loss_chunk=16)
    base.update(kw)
    return ModelConfig(**base)


@pytest.fixture
def tiny():
    return tiny_cfg()


def tiny_params():
    import jax.numpy as jnp
    return {
        "tok_embed": {"w": jax.random.normal(jax.random.PRNGKey(1), (64, 32))},
        "segments": {"seg0": {"attn": {"wq": jax.random.normal(
            jax.random.PRNGKey(2), (2, 32, 32))}}},
        "norm": {"s": jnp.ones((32,))},
        "lm_head": {"w": jax.random.normal(jax.random.PRNGKey(3), (32, 64))},
    }


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skipped "
        "without one")
