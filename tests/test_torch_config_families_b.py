"""Config-family training steps, part 2 of 3: the cases
``STEP_SPLIT[1]`` of ``tests/test_torch_config_families.py`` (its
docstring states what is compared and the tolerances)."""

import pytest

from test_torch_config_families import STEP_SPLIT, check_step


@pytest.mark.parametrize("case", STEP_SPLIT[1])
def test_config_step_matches_jax(case):
    check_step(case)
