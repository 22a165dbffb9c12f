"""The port's synthetic LM data against the JAX package's.

The parts that come from numpy (the Zipf CDF, the bigram constants) must
be equal exactly. The random draws come from a torch generator and cannot
give ``jax.random``'s bits, so the rest is held to the same statistics:
  * the share of positions that follow the bigram map lies within 3 sigma
    of its expectation, bigram_prob plus the chance that a noise draw
    lands on the successor anyway (sigma from the per-position Bernoulli
    variances);
  * the Zipf sampler's empirical CDF lies within 1.95 / sqrt(n) of the
    CDF at every token (the Kolmogorov-Smirnov bound at level 0.001; a
    discrete law only makes it more conservative).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402


def _cfg(**kw):
    base = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    base.update(kw)
    return base


def test_data_config_fields_match_jax():
    # the port keeps JAX's leading fields (the unpacked text batch's), with
    # their defaults; the fields of the unported formats come with them
    jf = [(f.name, f.default) for f in dataclasses.fields(JD.DataConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TD.DataConfig)]
    assert len(tf) == 6 and tf == jf[:len(tf)]


@pytest.mark.parametrize("vocab,a", [(1000, 1.2), (32000, 1.2), (50, 0.7)])
def test_zipf_cdf_equals_jax(vocab, a):
    np.testing.assert_array_equal(TD._zipf_cdf(vocab, a), JD._zipf_cdf(vocab, a))


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_bigram_constants_and_cdf_equal_jax(seed):
    j = JD.SyntheticLM(JD.DataConfig(**_cfg(seed=seed)))
    t = TD.SyntheticLM(TD.DataConfig(**_cfg(seed=seed)), device="cpu")
    assert (t._a, t._b) == (j._a, j._b)
    np.testing.assert_array_equal(t._cdf.numpy(), np.asarray(j._cdf))


def test_batch_shapes_labels_and_determinism():
    ds = TD.SyntheticLM(TD.DataConfig(**_cfg()), device="cpu")
    b = ds.global_batch_at(7)
    assert b["tokens"].shape == b["labels"].shape == (8, 64)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert ((b["tokens"] >= 0) & (b["tokens"] < 1000)).all()
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()
    again = ds.global_batch_at(7)
    assert all(torch.equal(b[k], again[k]) for k in b)
    other = ds.global_batch_at(8)
    assert not torch.equal(b["tokens"], other["tokens"])
    fresh = TD.SyntheticLM(TD.DataConfig(**_cfg()), device="cpu")
    assert torch.equal(fresh.global_batch_at(7)["tokens"], b["tokens"])
    reseeded = TD.SyntheticLM(TD.DataConfig(**_cfg(seed=4)), device="cpu")
    assert not torch.equal(reseeded.global_batch_at(7)["tokens"], b["tokens"])


def test_host_batch_at_slices_the_rows():
    ds = TD.SyntheticLM(TD.DataConfig(**_cfg()), device="cpu")
    full = ds.global_batch_at(2)
    for host in range(4):
        part = ds.host_batch_at(2, host, 4)
        for k in full:
            assert torch.equal(part[k], full[k][2 * host:2 * host + 2])
    with pytest.raises(ValueError, match="split"):
        ds.host_batch_at(2, 0, 3)


def test_bigram_share_within_three_sigma():
    cfg = TD.DataConfig(**_cfg(seq_len=256, global_batch=64))
    ds = TD.SyntheticLM(cfg, device="cpu")
    toks = ds.global_batch_at(1)["tokens"].long().numpy()
    pmf = np.diff(np.concatenate([[0.0], TD._zipf_cdf(cfg.vocab_size,
                                                      cfg.zipf_a)]))
    succ = (ds._a * toks[:, :-1] + ds._b) % cfg.vocab_size
    hits = (toks[:, 1:] == succ).sum()
    q = cfg.bigram_prob + (1 - cfg.bigram_prob) * pmf[succ]
    assert abs(hits - q.sum()) <= 3 * np.sqrt((q * (1 - q)).sum())


def test_zipf_sampler_marginal_within_ks_bound():
    cfg = TD.DataConfig(**_cfg())
    ds = TD.SyntheticLM(cfg, device="cpu")
    n = 200_000
    draws = ds._sample_zipf(torch.Generator().manual_seed(0), (n,)).numpy()
    assert draws.min() >= 0 and draws.max() < cfg.vocab_size
    emp = np.cumsum(np.bincount(draws, minlength=cfg.vocab_size)) / n
    cdf = TD._zipf_cdf(cfg.vocab_size, cfg.zipf_a)
    assert np.abs(emp - cdf).max() <= 1.95 / np.sqrt(n)


def test_make_dataset_matches_jax_and_unported_formats_raise():
    jcfg = tiny_cfg("data", vocab_size=500)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    j = JD.make_dataset(jcfg, seq_len=16, global_batch=4, seed=9)
    t = TD.make_dataset(tcfg, seq_len=16, global_batch=4, seed=9, device="cpu")
    jd = dataclasses.asdict(j.cfg)
    assert dataclasses.asdict(t.cfg) == {k: jd[k] for k in
                                         dataclasses.asdict(t.cfg)}
    with pytest.raises(NotImplementedError, match="item 6"):
        TD.make_dataset(tcfg, 16, 4, pack_documents=True, device="cpu")
    for family, kw in (("audio", {"n_codebooks": 2}),
                       ("vlm", {"n_image_tokens": 4})):
        other = dataclasses.replace(tcfg, family=family, **kw)
        with pytest.raises(NotImplementedError, match="item 13"):
            TD.make_dataset(other, 16, 4, device="cpu")
