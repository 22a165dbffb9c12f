"""The port's memory accounting (``repro_torch.core.memory``) against the
JAX package's ``repro.core.memory`` and the paper's Appendix B: exact
integer equality of every report on the paper's 1B and 7B shapes and on
the configs the port knows, and the paper's published totals within the
0.5% the JAX package's own test allows (5% for APOLLO at rank 256, whose
projector convention differs, as there).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import memory as JM  # noqa: E402
from repro.core.labels import LabelRules as JRules  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import memory as TM  # noqa: E402
from repro_torch.core.labels import LabelRules as TRules  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402


def llama_shapes(d, ff, L, V):
    """The JAX test's nested shape tree and the port's flat one."""
    nested = {"tok_embed": {"w": (V, d)}, "lm_head": {"w": (d, V)}}
    for i in range(L):
        nested[f"layer_{i}"] = {
            "q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d),
            "ln1": (d,), "ln2": (d,)}
    flat = {f"{a}/{b}": s for a, sub in nested.items()
            for b, s in sub.items()}
    return nested, flat


SHAPES = {"1b": llama_shapes(2048, 5461, 24, 32000),
          "7b": llama_shapes(4096, 11008, 32, 32000)}
PAPER_7B = {"sgd": 13.476, "adam": 40.428, "muon": 26.952, "swan": 14.524,
            "apollo_mini": 14.531, "scale": 13.738}
PAPER_1B = {"sgd": 2.678, "adam": 8.034, "muon": 5.356, "swan": 3.202,
            "scale": 2.809}


@pytest.mark.parametrize("kw", [{}, {"dtype_bytes": 4}, {"rank": 128},
                                {"dtype_bytes": 4,
                                 "momentum_dtype": "bfloat16"}])
@pytest.mark.parametrize("size", list(SHAPES))
@pytest.mark.parametrize("method", TM.METHODS)
def test_memory_report_equals_jax(method, size, kw):
    nested, flat = SHAPES[size]
    want = JM.memory_report(nested, method, **kw)
    for shapes in (flat, nested):
        got = TM.memory_report(shapes, method, **kw)
        assert (got.method, got.weight_bytes, got.state_bytes) == (
            want.method, want.weight_bytes, want.state_bytes)
        assert got.gb() == want.gb() and got.gb(False) == want.gb(False)
    assert TM.optimizer_state_elements(flat, method) == \
        JM.optimizer_state_elements(nested, method)
    assert TM.momentum_eligible_elements(flat, method) == \
        JM.momentum_eligible_elements(nested, method)


@pytest.mark.parametrize("arch", ["llama-60m", "llama-1b", "llama-7b",
                                  "gemma-2b"])
def test_memory_report_on_port_configs_equals_jax(arch):
    """The port's own parameter paths (stacked layers) against the JAX
    package's report on the same {path: shape} mapping, default and tied
    rules."""
    shapes = param_shapes(get_arch(arch))
    for trules, jrules in ((None, None), (TRules.tied(), JRules.tied())):
        for method in TM.METHODS:
            got = TM.memory_report(shapes, method, dtype_bytes=4,
                                   rules=trules)
            want = JM.memory_report(shapes, method, dtype_bytes=4,
                                    rules=jrules)
            assert (got.weight_bytes, got.state_bytes) == (
                want.weight_bytes, want.state_bytes), (arch, method)


@pytest.mark.parametrize("size,paper", [("7b", PAPER_7B), ("1b", PAPER_1B)])
def test_paper_appendix_b_totals(size, paper):
    _, flat = SHAPES[size]
    for method, want in paper.items():
        total = TM.memory_report(flat, method).gb()[2]
        assert abs(total - want) / want < 0.005, (method, total, want)
    if size == "7b":
        total = TM.memory_report(flat, "apollo", rank=256).gb()[2]
        assert abs(total - 16.144) / 16.144 < 0.05


def test_methods_and_errors_match_jax():
    assert TM.METHODS == JM.METHODS
    _, flat = SHAPES["1b"]
    with pytest.raises(ValueError, match="unknown method"):
        TM.optimizer_state_elements(flat, "nonesuch")
    with pytest.raises(ValueError, match="momentum_dtype"):
        TM.memory_report(flat, "adam", momentum_dtype="fp8")
