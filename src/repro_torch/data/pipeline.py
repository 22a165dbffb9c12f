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

Packed batches (``pack_documents``): variable-length documents are
first-fit binned into fixed-S rows, as the JAX package's ``_packed_batch``
does. A packed batch carries three more (B, S) operands: ``segment_ids``
(int32, the document's id within its row, 1..N in placement order, 0 on
pad), ``positions`` (int32, the position within the document, 0 on pad)
and ``loss_weights`` (f32, 1 where the label is a next token within the
document, 0 at each document's end and on pad). Labels are -1 wherever
the weight is 0. The document lengths come from the same
``np.random.RandomState`` keyed on (seed, step) as in JAX, so the layout
(``segment_ids``, ``positions``, ``loss_weights`` and the -1 labels) is
JAX's bitwise; the candidate documents' tokens come from this module's
generator (seeded from (seed, step, 17)) and are not JAX's.
:func:`unpack_to_rows` is the offset-preserving inverse the parity tests
use. Packing runs on the host in numpy, as a loader would.

Audio (``n_codebooks``): tokens and labels (B, C, S), each codebook's
row drawn as a text row is, labels -1 at each codebook's last position.
VLM (``n_image_tokens``): the batch also carries ``image_embeds`` (B,
n_image_tokens, d_model), f32 whatever the model's dtype, 0.02 * N(0, 1)
as JAX's; they come from a generator seeded from (seed, step, 7), so
they have JAX's distribution but not its values, as the tokens do. Both
are stubs of a frontend (EnCodec, the vision tower). Packing is a
plain-text format and raises with either, as in JAX.
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
    n_codebooks: int = 0         # audio: tokens (B, n_codebooks, S)
    n_image_tokens: int = 0      # vlm: synthetic patch embeddings
    d_model: int = 0             # vlm: embedding width
    pack_documents: bool = False  # first-fit packed multi-document rows
    min_doc_len: int = 8         # packed: shortest sampled document


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

    def _generator(self, step: int, *salt: int) -> torch.Generator:
        """The CPU generator of ``step``'s draws, seeded from (seed, step)
        and ``salt`` (the packed batch's documents: 17; the image
        embeddings: 7)."""
        state = np.random.SeedSequence(
            [self.cfg.seed, step, *salt]).generate_state(1)
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

    def _packed_batch(self, step: int) -> dict:
        """First-fit packed (B, S) batch (see the module docstring): the
        JAX package's ``_packed_batch``, on the host in numpy."""
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        lo = min(cfg.min_doc_len, S)
        rng = np.random.RandomState(
            (1000003 * cfg.seed + 7919 * step + 13) % (2 ** 31 - 1))
        # enough candidates to fill B rows at the ~(lo+S)/2 mean length
        n_cand = 4 * B + 8
        lens = rng.randint(lo, S + 1, size=n_cand)
        cand = self._gen_tokens(self._generator(step, 17), n_cand).numpy()
        tokens = np.zeros((B, S), np.int32)
        labels = np.full((B, S), -1, np.int32)
        segment_ids = np.zeros((B, S), np.int32)
        positions = np.zeros((B, S), np.int32)
        weights = np.zeros((B, S), np.float32)
        fill = np.zeros(B, np.int64)
        nseg = np.zeros(B, np.int64)
        for d in range(n_cand):
            L = int(lens[d])
            b = next((b for b in range(B) if S - fill[b] >= L), None)
            if b is None:
                if int((S - fill).max()) < lo:
                    break  # no later candidate fits anywhere
                continue
            o = int(fill[b])
            doc = cand[d, :L]
            tokens[b, o:o + L] = doc
            segment_ids[b, o:o + L] = nseg[b] + 1
            positions[b, o:o + L] = np.arange(L)
            labels[b, o:o + L - 1] = doc[1:]  # within the document only:
            weights[b, o:o + L - 1] = 1.0     # its last token predicts
            fill[b] += L                      # nothing across the boundary
            nseg[b] += 1
        out = {"tokens": tokens, "labels": labels, "segment_ids": segment_ids,
               "positions": positions, "loss_weights": weights}
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}

    def global_batch_at(self, step: int) -> dict:
        """The full batch for ``step``: tokens (B, S) int32 and the
        next-token labels (B, S) int32, -1 last; packed, also
        ``segment_ids``, ``positions`` and ``loss_weights``; audio, tokens
        and labels (B, C, S); VLM, also ``image_embeds`` (B, T, D) f32."""
        cfg = self.cfg
        if cfg.pack_documents:
            if cfg.n_codebooks or cfg.n_image_tokens:
                raise ValueError("pack_documents: packing is a plain-text "
                                 "format (no audio codebooks / image rows)")
            return self._packed_batch(step)
        gen = self._generator(step)
        if cfg.n_codebooks:
            toks = torch.stack([self._gen_tokens(gen, cfg.global_batch)
                                for _ in range(cfg.n_codebooks)], dim=1)
        else:
            toks = self._gen_tokens(gen, cfg.global_batch)
        labels = torch.cat([toks[..., 1:], torch.full(
            toks.shape[:-1] + (1,), -1, dtype=torch.int32)], dim=-1)
        batch = {"tokens": toks.to(self.device),
                 "labels": labels.to(self.device)}
        if cfg.n_image_tokens:
            shape = (cfg.global_batch, cfg.n_image_tokens, cfg.d_model)
            batch["image_embeds"] = (0.02 * torch.randn(
                shape, generator=self._generator(step, 7))).to(self.device)
        return batch

    def host_batch_at(self, step: int, host_id: int = 0,
                      n_hosts: int = 1) -> dict:
        """This host's shard (rows host_id::n_hosts of the global batch)."""
        if self.cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {self.cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        per = self.cfg.global_batch // n_hosts
        return {k: v[host_id * per:(host_id + 1) * per]
                for k, v in self.global_batch_at(step).items()}


def unpack_to_rows(batch: dict) -> dict:
    """Packed batch -> one row per document, offset-preserving: the JAX
    package's ``unpack_to_rows``.

    Each document keeps its packed row offset, and everything outside it
    is pad (token 0, label -1, segment and position 0, weight 0), so every
    per-document computation sees its tokens in the same lanes as in the
    packed run. Rows in (row, id) order; tensors on the batch's device.
    """
    keys = ("tokens", "labels", "segment_ids", "positions", "loss_weights")
    host = {k: torch.as_tensor(batch[k]).cpu().numpy() for k in keys}
    fill = {"tokens": 0, "labels": -1, "segment_ids": 0, "positions": 0,
            "loss_weights": 0.0}
    rows = {k: [] for k in keys}
    segs = host["segment_ids"]
    for b in range(segs.shape[0]):
        for s in np.unique(segs[b]):
            if s == 0:
                continue
            m = segs[b] == s
            for k in keys:
                rows[k].append(np.where(m, host[k][b], fill[k])
                               .astype(host[k].dtype))
    device = torch.as_tensor(batch["tokens"]).device
    return {k: torch.from_numpy(np.stack(v)).to(device)
            for k, v in rows.items()}


def make_dataset(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                 pack_documents: bool = False, device=None) -> SyntheticLM:
    """Dataset matched to a ModelConfig: text batches, unpacked or packed
    (``pack_documents``), with the audio codebooks and the VLM's image
    stubs wired up as JAX's ``make_dataset`` does."""
    return SyntheticLM(DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        n_codebooks=model_cfg.n_codebooks if model_cfg.family == "audio"
        else 0,
        n_image_tokens=model_cfg.n_image_tokens if model_cfg.family == "vlm"
        else 0,
        d_model=model_cfg.d_model,
        pack_documents=pack_documents,
    ), device=device)
