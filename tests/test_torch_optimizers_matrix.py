"""The optimizer names that multiply matrices (Muon, SWAN, the ns and svd
norm ablations, GaLore, Fira, APOLLO, APOLLO-Mini) against the JAX
package's: the cases, the three steps and the tolerances of
``test_torch_optimizers.py`` (see its docstring), split off so that each
file runs in well under a minute on one worker (JAX's eager Newton-Schulz
compiles its ``scan`` anew on every call).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_optimizers import (ALL_CASES, MATRIX_NAMES, _check,  # noqa: E402,F401
                                   one_torch_thread)

CASES = [c for c, (name, _) in ALL_CASES.items() if name in MATRIX_NAMES]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["update", "update_params"])
@pytest.mark.parametrize("case", CASES)
def test_matrix_optimizer_matches_jax_after_three_steps(case, entry, dt):
    _check(case, entry, dt)
