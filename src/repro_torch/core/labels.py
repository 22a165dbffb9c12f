"""Parameter labeling: which update branch each parameter takes.

A copy of ``repro.core.labels`` over the port's flat ``{path_str: tensor}``
mappings. Groups (paper Algorithm 1 + Appendix C):
  * ``last``   — the LM head (logit-producing matrix); momentum + colnorm.
  * ``first``  — the token embedding.
  * ``matrix`` — every other >=2-D weight; stateless normalization.
  * ``vector`` — <=1-D params and per-layer scales/biases stacked to 2-D;
    Adam.
Classification is by path against configurable patterns, with the
dimensionality fallback. ``layer_group`` is the coarser bucketing of the
telemetry plane (``repro_torch.obs.stats``).
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.models.model import flatten

LAST_LAYER_PATTERNS = (r"lm_head", r"output_head", r"codebook_head")
FIRST_LAYER_PATTERNS = (r"tok_embed", r"embed_tokens", r"frame_embed", r"patch_embed")
# promoted to ``last`` by LabelRules.tied(): with tie_embeddings the token
# embedding IS the logit-producing matrix, stored (V, D)
TIED_LAST_PATTERNS = (r"tok_embed", r"embed_tokens")
# per-layer scales/biases/SSM scalars even when stacked to >=2-D
VECTOR_PATTERNS = (r"norm", r"bias", r"/b[qkv]$", r"A_log", r"dt_bias",
                   r"/D$", r"conv_b", r"conv_w", r"/s$", r"scale")


@dataclasses.dataclass(frozen=True)
class LabelRules:
    last: tuple = LAST_LAYER_PATTERNS
    first: tuple = FIRST_LAYER_PATTERNS
    vector: tuple = VECTOR_PATTERNS
    # logit-producing matrices stored transposed, (V, D): labeled ``last``
    # ahead of ``first`` and flagged by ``transposed`` so that SCALE flips
    # its col/row kind
    tied_last: tuple = ()

    @classmethod
    def tied(cls, tied_last: tuple = TIED_LAST_PATTERNS, **kw) -> "LabelRules":
        """Rules for a ``tie_embeddings=True`` model: the token embedding is
        the LM head, so it takes the ``last`` (momentum) branch."""
        return cls(tied_last=tuple(tied_last), **kw)

    def classify(self, path: str, ndim: int) -> str:
        if ndim <= 1:
            return "vector"
        for pat in self.vector:
            if re.search(pat, path):
                return "vector"
        for pat in self.tied_last:
            if re.search(pat, path):
                return "last"
        for pat in self.last:
            if re.search(pat, path):
                return "last"
        for pat in self.first:
            if re.search(pat, path):
                return "first"
        return "matrix"

    def transposed(self, path: str, ndim: int = 2) -> bool:
        """True when ``path`` names a matrix stored (d_out, d_in) — a tied
        head; col/row norm kinds must be flipped for it."""
        if ndim <= 1:
            return False
        return any(re.search(pat, path) for pat in self.tied_last)


# Coarse layer groups for observability (paper Fig. 4 / Fig. 10 axes): the
# output head, the token embedding, and everything in between. Coarser than
# the optimizer labels above: the paper states its variance and column-norm
# figures per layer group.
LAYER_GROUPS = ("embedding", "hidden", "lm_head")


def layer_group(path: str, tied: bool = False) -> str:
    """Map a parameter path to its Fig. 4 layer group.

    ``tied=True`` mirrors :meth:`LabelRules.tied`: with weight tying the
    token embedding IS the logit-producing matrix, so it reports under
    ``lm_head`` instead of ``embedding``.
    """
    for pat in LAST_LAYER_PATTERNS:
        if re.search(pat, path):
            return "lm_head"
    if tied:
        for pat in TIED_LAST_PATTERNS:
            if re.search(pat, path):
                return "lm_head"
    for pat in FIRST_LAYER_PATTERNS:
        if re.search(pat, path):
            return "embedding"
    return "hidden"


def label_tree(params, rules: LabelRules | None = None,
               require_last: bool = False) -> dict:
    """``{path: label}`` of a flat (or nested) parameter mapping.

    ``require_last=True``: a mapping with an embedding-like (``first``)
    matrix but no ``last`` matrix is an error — the ``tie_embeddings=True``
    model handed the untied rules, whose head would silently lose its
    momentum branch.
    """
    rules = rules or LabelRules()
    labels = {k: rules.classify(k, x.ndim) for k, x in flatten(params).items()}
    if require_last:
        labs = set(labels.values())
        if "first" in labs and "last" not in labs:
            raise ValueError(
                "params contain an embedding-like ('first') matrix but no "
                "logit-producing ('last') matrix matched the label rules. "
                "For a tie_embeddings=True model the head IS the embedding: "
                "build the optimizer with rules=LabelRules.tied() so the "
                "tied matrix takes the 'last' (momentum + output-dim "
                "normalization) branch. For a custom head name, extend "
                "LabelRules(last=...).")
    return labels


def transposed_tree(params, rules: LabelRules | None = None) -> dict:
    """``{path: bool}``: True where a leaf is a transposed-storage head."""
    rules = rules or LabelRules()
    return {k: rules.transposed(k, x.ndim)
            for k, x in flatten(params).items()}
