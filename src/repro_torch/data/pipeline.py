"""Deterministic, shard-aware synthetic LM data (the unpacked text batch of
``repro.data.pipeline``).

A batch is a pure function of ``(seed, step)``: tokens follow a Zipf
marginal with an affine bigram backbone the model can learn, and labels
are the next token, -1 last. Each host takes its rows of the global batch.

The parts that come from numpy are the JAX package's exactly: the Zipf
CDF and the bigram constants ``a``, ``b`` from
``np.random.RandomState(seed)``. The random draws (first token, noise
tokens, bigram coins) come from a CPU ``torch.Generator`` seeded from
``(seed, step)``; they cannot give ``jax.random``'s bits, so a batch has
the JAX pipeline's distribution but not its tokens. Draws are made on the
CPU, so a batch is the same on every device, and land on
``resolve_device(device)``: the card unless the caller asks for the CPU.

Not ported yet, and raising ``NotImplementedError``: packed documents
(ROADMAP.md Queue 1 item 6), audio codebooks and image stubs (item 13).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bigram_prob: float = 0.8     # P(next token follows the affine map)
    zipf_a: float = 1.2          # Zipf exponent for the noise marginal


def _zipf_cdf(vocab: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, vocab + 1) ** a
    return np.cumsum(w / w.sum())


class SyntheticLM:
    """Stateless synthetic next-token dataset."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cdf = torch.from_numpy(
            _zipf_cdf(cfg.vocab_size, cfg.zipf_a)).to(torch.float32)
        # affine bigram backbone: next = (a * prev + b) % V
        rng = np.random.RandomState(cfg.seed)
        self._a = int(rng.randint(3, 97) * 2 + 1)  # odd -> bijective mod V
        self._b = int(rng.randint(0, cfg.vocab_size))

    def _generator(self, step: int) -> torch.Generator:
        """The CPU generator of ``step``'s draws, seeded from (seed, step)."""
        state = np.random.SeedSequence([self.cfg.seed, step]).generate_state(1)
        return torch.Generator().manual_seed(int(state[0]))

    def _sample_zipf(self, gen: torch.Generator, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen)
        return torch.searchsorted(self._cdf, u).to(torch.int32)

    def _gen_tokens(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        cfg = self.cfg
        first = self._sample_zipf(gen, (batch,)).long()
        noise = self._sample_zipf(gen, (batch, cfg.seq_len)).long()
        coin = torch.rand((batch, cfg.seq_len), generator=gen) < cfg.bigram_prob
        toks = torch.empty((batch, cfg.seq_len), dtype=torch.int64)
        prev = first
        for s in range(cfg.seq_len):
            prev = torch.where(coin[:, s],
                               (self._a * prev + self._b) % cfg.vocab_size,
                               noise[:, s])
            toks[:, s] = prev
        return toks.to(torch.int32)

    def global_batch_at(self, step: int) -> dict:
        """The full batch for ``step``: tokens (B, S) int32 and the
        next-token labels (B, S) int32, -1 last."""
        cfg = self.cfg
        toks = self._gen_tokens(self._generator(step), cfg.global_batch)
        labels = torch.cat([toks[:, 1:], torch.full(
            (cfg.global_batch, 1), -1, dtype=torch.int32)], dim=1)
        return {"tokens": toks.to(self.device),
                "labels": labels.to(self.device)}

    def host_batch_at(self, step: int, host_id: int = 0,
                      n_hosts: int = 1) -> dict:
        """This host's shard (rows host_id::n_hosts of the global batch)."""
        if self.cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {self.cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        per = self.cfg.global_batch // n_hosts
        return {k: v[host_id * per:(host_id + 1) * per]
                for k, v in self.global_batch_at(step).items()}


def make_dataset(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                 pack_documents: bool = False, device=None) -> SyntheticLM:
    """Dataset matched to a ModelConfig: unpacked text batches. Packed
    documents, audio codebooks and image stubs raise until ported."""
    for on, what, item in (
            (pack_documents, "packed documents", 6),
            (model_cfg.family == "audio" and model_cfg.n_codebooks,
             "audio codebooks", 13),
            (model_cfg.family == "vlm" and model_cfg.n_image_tokens,
             "image stubs", 13)):
        if on:
            raise NotImplementedError(f"make_dataset: {what} are not ported "
                                      f"yet; ROADMAP.md Queue 1 item {item}")
    return SyntheticLM(DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
    ), device=device)
