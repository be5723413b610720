"""Config system: recursive YAML loader with single-parent ``inherit_from``.

Parity: /root/reference/utils/config.py:4-48 (load_config / update_recursive).
Our loader adds defaults injection and dotted-path overrides but keeps the
same inheritance semantics: a child yaml names its parent via
``inherit_from`` and its values win over the parent's on a deep merge.

``parse_yaml`` reads the YAML subset the files under ``configs/`` use:
nested block mappings, block and flow sequences, plain and quoted
scalars, ``True``/``False``, ``null`` and comments, resolved as YAML 1.1
(PyYAML) resolves them. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)"
                    r"([eE][-+][0-9]+)?$")
_KEY = re.compile(r"([^:#'\"]+):(\s|$)")
_BOOL = {"true": True, "false": False}
_NULL = {"", "~", "null"}


def _scalar(text: str) -> Any:
    t = text.strip()
    if t[:1] in ("'", '"'):
        if len(t) < 2 or t[-1] != t[0]:
            raise ValueError(f"unterminated string: {text!r}")
        return t[1:-1]
    if t.startswith("["):
        value, rest = _flow(t)
        if rest.strip():
            raise ValueError(f"trailing text after flow list: {text!r}")
        return value
    if t[:1] in ("{", "&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML: {text!r}")
    if t.lower() in _NULL:
        return None
    if t.lower() in _BOOL:
        return _BOOL[t.lower()]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    return t


def _flow(text: str) -> Tuple[List[Any], str]:
    """Parse a flow sequence at the start of ``text``; returns (list,
    the text after its closing bracket)."""
    items: List[Any] = []
    rest = text[1:].lstrip()
    while True:
        if rest.startswith("]"):
            return items, rest[1:]
        if rest.startswith("["):
            item, rest = _flow(rest)
        else:
            m = re.match(r"([^,\]]*)", rest)
            item, rest = _scalar(m.group(1)), rest[m.end():]
        items.append(item)
        rest = rest.lstrip()
        if rest.startswith(","):
            rest = rest[1:].lstrip()
        elif not rest.startswith("]"):
            raise ValueError(f"bad flow sequence: {text!r}")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _is_seq(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[List], i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block (mapping or sequence) whose lines start at
    ``lines[i]`` with indentation ``indent``."""
    if _is_seq(lines[i][1]):
        seq = []
        while i < len(lines) and lines[i][0] == indent and \
                _is_seq(lines[i][1]):
            item = lines[i][1][1:]
            if not item.strip():
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    value, i = None, i + 1
            elif _is_seq(item.strip()) or _KEY.match(item.strip()):
                # the item's text starts a block of its own, one column
                # past the dash plus its spaces
                lines[i] = [indent + 1 + len(item) - len(item.lstrip()),
                            item.strip()]
                value, i = _block(lines, i, lines[i][0])
            else:
                value, i = _scalar(item), i + 1
            seq.append(value)
        return seq, i
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        m = _KEY.match(text)
        if not m or _is_seq(text):
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, rest = m.group(1).strip(), text[m.end():]
        i += 1
        if rest.strip():
            if len(lines) > i and lines[i][0] > indent:
                raise ValueError(f"unexpected indentation after {text!r}")
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_seq(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """Parse a YAML document of the subset described in the module
    docstring. An empty document gives None."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("---", "..."):
            continue
        if body.strip():
            lines.append([len(body) - len(body.lstrip()), body.strip()])
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unparsed text at {lines[i][1]!r}")
    return value


def _read(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return parse_yaml(f.read()) or {}


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Deep-merge ``src`` into ``dst`` in place (src wins on leaves)."""
    for k, v in src.items():
        if k not in dst:
            dst[k] = {}
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = v


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, recursively resolving ``inherit_from`` chains.

    ``inherit_from`` is resolved relative to the current working directory
    first (matching the reference's repo-root-relative convention), then
    relative to the directory of the child file.
    """
    cfg_special = _read(path)

    inherit = cfg_special.get("inherit_from")
    if inherit is not None:
        if not os.path.exists(inherit):
            candidate = os.path.join(os.path.dirname(path), inherit)
            if os.path.exists(candidate):
                inherit = candidate
        cfg = load_config(inherit, default_path)
    elif default_path is not None:
        cfg = _read(default_path)
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    cfg.pop("inherit_from", None)
    return cfg


def apply_overrides(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Return a copy of ``cfg`` with dotted-path overrides applied.

    e.g. ``apply_overrides(cfg, {"mapping.iters": 5})``.
    """
    out = copy.deepcopy(cfg)
    for dotted, value in overrides.items():
        node = out
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out
