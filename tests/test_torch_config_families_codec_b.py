"""Config-family codec containers, part 2 of 2: the cases
``CODEC_SPLIT[1]`` of ``tests/test_torch_config_families_codec.py`` (its
docstring states what is compared)."""

import pytest

from test_torch_config_families_codec import CODEC_SPLIT, check_case


@pytest.mark.parametrize("case,geom", CODEC_SPLIT[1])
def test_config_codec_container_equals_jax(case, geom):
    print(f"{case} {geom}: {check_case(case, geom)} B byte-identical")
