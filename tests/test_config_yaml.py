"""The config loader's YAML subset against PyYAML on every config."""

import glob
import os

import pytest

from mipsfusion_tpu.config import load_config, parse_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def test_every_config_is_listed():
    assert len(CONFIGS) >= 30


@pytest.mark.parametrize("path", CONFIGS)
def test_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    ours, theirs = parse_yaml(text), yaml.full_load(text)
    assert ours == theirs
    assert repr(ours) == repr(theirs)         # same types (int vs float)


def test_scalars_resolve_like_yaml_1_1():
    doc = parse_yaml(
        "a: 1\nb: -2.5\nc: 1e-3\nd: 1.0e-3\ne: True\nf: false\ng: null\n"
        "h: ~\ni: 'x # y'\nj: \"q\"\nk: plain text  # comment\nl:\n"
        "m: [1, [2, 3.0], x]\nn: []\no: .5\n")
    assert doc == {"a": 1, "b": -2.5, "c": "1e-3", "d": 0.001, "e": True,
                   "f": False, "g": None, "h": None, "i": "x # y",
                   "j": "q", "k": "plain text", "l": None,
                   "m": [1, [2, 3.0], "x"], "n": [], "o": 0.5}


def test_block_sequences():
    doc = parse_yaml("a:\n- - -1.5\n  - 2\n- - 3\n  - 4\nb:\n  - x\n"
                     "  - k: 1\n    j: 2\n")
    assert doc == {"a": [[-1.5, 2], [3, 4]], "b": ["x", {"k": 1, "j": 2}]}


@pytest.mark.parametrize("text", ["a: {b: 1}", "a: &x 1", "a: |\n  t",
                                  "a: [1, 2", "a: 1\n  b: 2", "- a\nb: 1"])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_load_config_resolves_inheritance():
    cfg = load_config(os.path.join(ROOT, "configs/synthetic/orbit.yaml"))
    assert cfg["cam"]["H"] == 240                 # the child's value
    assert cfg["tracking"]["iter_RO"] == 5        # from configs/base.yaml
    assert "inherit_from" not in cfg
