"""YAML loading: PyYAML when present, a subset parser otherwise.

This package's own copy of ``pbte_tpu/io/yamlish.py``. PyYAML reads
config.yaml, si.yaml and the legacy Control.yaml in full; without it the
subset parser covers the shapes those files use (nested maps, scalars,
inline lists, block lists of scalars or maps). PyYAML (YAML 1.1) reads
``1e-7`` as a string, so callers coerce numbers with ``float()``.
"""

from __future__ import annotations

from typing import Any


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    if not t:
        return None
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_parse_scalar(x) for x in inner.split(",")] if inner else []
    if (t.startswith('"') and t.endswith('"')) or (t.startswith("'") and t.endswith("'")):
        return t[1:-1]
    low = t.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", "none"):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _strip_comment(line: str) -> str:
    # Not quote-aware; good enough for the config schema (values with '#'
    # inside quotes are not used by any reference config).
    pos = line.find("#")
    return line[:pos] if pos >= 0 else line


def loads_subset(text: str) -> Any:
    """Parse an indentation-structured YAML subset: nested maps, scalar values,
    inline lists, and block lists of scalars or maps."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append(line)

    pos = 0

    def parse_block(indent: int) -> Any:
        nonlocal pos
        result: Any = None
        while pos < len(lines):
            line = lines[pos]
            cur_indent = len(line) - len(line.lstrip())
            if cur_indent < indent:
                break
            stripped = line.strip()
            if stripped.startswith("- "):
                if result is None:
                    result = []
                if not isinstance(result, list):
                    raise ValueError(f"mixed list/map at line: {line}")
                item_text = stripped[2:]
                pos += 1
                if ":" in item_text and not item_text.startswith("["):
                    # list of maps: first key inline, rest indented deeper
                    key, _, val = item_text.partition(":")
                    item = {key.strip(): _parse_scalar(val)}
                    extra = parse_block(cur_indent + 2)
                    if isinstance(extra, dict):
                        item.update(extra)
                    result.append(item)
                else:
                    result.append(_parse_scalar(item_text))
            else:
                if result is None:
                    result = {}
                if not isinstance(result, dict):
                    break
                key, sep, val = stripped.partition(":")
                if not sep:
                    raise ValueError(f"cannot parse line: {line}")
                pos += 1
                val = val.strip()
                if val:
                    result[key.strip()] = _parse_scalar(val)
                else:
                    result[key.strip()] = parse_block(cur_indent + 1)
        return result

    return parse_block(0)


def load_yaml_file(path: str) -> Any:
    with open(path) as f:
        text = f.read()
    try:
        import yaml  # type: ignore

        return yaml.safe_load(text)
    except ImportError:
        return loads_subset(text)
