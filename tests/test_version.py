"""Version hygiene: the package's __version__ must match pyproject.toml so
every artifact (bench.py embeds it) self-identifies its code state."""

import pathlib
import re

import relativitypathtracer_tpu as pkg

REPO = pathlib.Path(__file__).resolve().parents[1]


import pytest

pytestmark = pytest.mark.fast  # inner-loop subset


def test_version_matches_pyproject():
    text = (REPO / "pyproject.toml").read_text()
    m = re.search(r'^version = "([^"]+)"', text, re.M)
    assert m, "pyproject.toml has no version line"
    assert pkg.__version__ == m.group(1)
