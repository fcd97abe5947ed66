"""Hierarchical configuration system.

Schema-compatible with the reference simulator's config stack: an INI-style
file whose section headers may nest with '/' separators, layered with
command-line overrides of the form ``--section/sub/key=value``
(reference: common/config/config.hpp, common/misc/handle_args.cc:45-58,
carbon_sim.cfg).  The parser here is a small hand-written one (the
reference uses a Boost.Spirit grammar, common/config/config_file_grammar.hpp);
behavior, not implementation, is what we keep.

Values are typed on *read*: ``get_int/get_float/get_bool/get_str`` convert
the stored string, mirroring the reference's typed lookups
(common/config/config.hpp getInt/getBool/...).  Quoted strings keep their
inner text; bare words are kept verbatim.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Config", "ConfigError", "load_config", "parse_overrides"]


class ConfigError(Exception):
    """Raised for missing keys or malformed config input."""


_SECTION_RE = re.compile(r"^\[([A-Za-z0-9_/\-\.]*)\]\s*$")
_KEY_RE = re.compile(r"^([A-Za-z0-9_\-\.]+)\s*=\s*(.*)$")

_TRUE_WORDS = {"true", "yes", "on", "1"}
_FALSE_WORDS = {"false", "no", "off", "0"}


def _strip_comment(line: str) -> str:
    """Drop a trailing ``#`` comment, honoring double-quoted strings."""
    out = []
    in_quote = False
    for ch in line:
        if ch == '"':
            in_quote = not in_quote
        elif ch == "#" and not in_quote:
            break
        out.append(ch)
    return "".join(out)


def _parse_value(raw: str) -> str:
    raw = raw.strip()
    if len(raw) >= 2 and raw[0] == '"' and raw[-1] == '"':
        return raw[1:-1]
    return raw


class Config:
    """A tree of ``section -> {key: string-value}`` with typed accessors.

    Keys are addressed by full path, e.g. ``cfg.get_int("general/total_cores")``.
    Layering: defaults < config file < CLI overrides — the same precedence
    the reference applies (file then --section/key=value flags,
    common/misc/handle_args.cc:45-58).
    """

    def __init__(self, data: Optional[Dict[str, Dict[str, str]]] = None):
        # Flat map: section-path -> {key: raw-string-value}.
        self._data: Dict[str, Dict[str, str]] = {}
        if data:
            for sec, kv in data.items():
                self._data[sec] = dict(kv)

    # ---------------------------------------------------------------- parse

    @classmethod
    def from_text(cls, text: str) -> "Config":
        cfg = cls()
        cfg.merge_text(text)
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path, "r") as f:
            return cls.from_text(f.read())

    def merge_text(self, text: str) -> None:
        section = ""
        for lineno, line in enumerate(text.splitlines(), start=1):
            line = _strip_comment(line).strip()
            if not line:
                continue
            m = _SECTION_RE.match(line)
            if m:
                section = m.group(1).strip("/")
                self._data.setdefault(section, {})
                continue
            m = _KEY_RE.match(line)
            if m:
                key, raw = m.group(1), m.group(2)
                self._data.setdefault(section, {})[key] = _parse_value(raw)
                continue
            raise ConfigError(f"malformed config line {lineno}: {line!r}")

    def merge_file(self, path: str) -> None:
        with open(path, "r") as f:
            self.merge_text(f.read())

    def merge(self, other: "Config") -> None:
        for sec, kv in other._data.items():
            self._data.setdefault(sec, {}).update(kv)

    def set(self, path: str, value: Any) -> None:
        section, _, key = path.rpartition("/")
        if not key:
            raise ConfigError(f"override path needs section/key: {path!r}")
        if isinstance(value, bool):
            value = "true" if value else "false"
        self._data.setdefault(section, {})[key] = str(value)

    # ---------------------------------------------------------------- read

    def _lookup(self, path: str) -> str:
        section, _, key = path.rpartition("/")
        try:
            return self._data[section][key]
        except KeyError:
            raise ConfigError(f"config key not found: {path!r}") from None

    def has(self, path: str) -> bool:
        section, _, key = path.rpartition("/")
        return section in self._data and key in self._data[section]

    _MISSING = object()

    def _raw(self, path: str, default: Any) -> Any:
        """Stored string for ``path``, or ``default`` if absent (and a default
        was given); raises ConfigError when absent with no default."""
        if not self.has(path):
            if default is not Config._MISSING:
                return default
            raise ConfigError(f"config key not found: {path!r}")
        return self._lookup(path)

    def get_str(self, path: str, default: Any = _MISSING) -> str:
        return self._raw(path, default)

    def get_int(self, path: str, default: Any = _MISSING) -> int:
        raw = self._raw(path, default)
        if not isinstance(raw, str):
            return raw
        try:
            return int(raw, 0)
        except ValueError:
            pass
        # Tolerate float-formatted integers (e.g. "2.0").
        try:
            f = float(raw)
        except ValueError:
            raise ConfigError(f"{path!r} is not an integer: {raw!r}") from None
        if f != int(f):
            raise ConfigError(f"{path!r} is not an integer: {raw!r}")
        return int(f)

    def get_float(self, path: str, default: Any = _MISSING) -> float:
        raw = self._raw(path, default)
        if not isinstance(raw, str):
            return raw
        try:
            return float(raw)
        except ValueError:
            raise ConfigError(f"{path!r} is not a number: {raw!r}") from None

    def get_bool(self, path: str, default: Any = _MISSING) -> bool:
        raw = self._raw(path, default)
        if not isinstance(raw, str):
            return raw
        raw = raw.strip().lower()
        if raw in _TRUE_WORDS:
            return True
        if raw in _FALSE_WORDS:
            return False
        raise ConfigError(f"{path!r} is not a boolean: {raw!r}")

    def get_list(self, path: str, default: Any = _MISSING) -> List[str]:
        """Comma-separated list value -> stripped items (empty -> [])."""
        raw = self._raw(path, default)
        if not isinstance(raw, str):
            return list(raw)
        raw = raw.strip()
        if not raw:
            return []
        return [item.strip() for item in raw.split(",") if item.strip()]

    def section(self, path: str) -> Dict[str, str]:
        return dict(self._data.get(path.strip("/"), {}))

    def sections(self) -> Iterator[str]:
        return iter(sorted(self._data.keys()))

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self._data))

    # ------------------------------------------------------------- serialize

    def to_text(self) -> str:
        out: List[str] = []
        for sec in sorted(self._data.keys()):
            kv = self._data[sec]
            if sec:
                out.append(f"[{sec}]")
            for key in sorted(kv.keys()):
                val = kv[key]
                if val == "" or any(c.isspace() for c in val) or "," in val or "#" in val:
                    out.append(f'{key} = "{val}"')
                else:
                    out.append(f"{key} = {val}")
            out.append("")
        return "\n".join(out)

    def __repr__(self) -> str:
        nsec = len(self._data)
        nkey = sum(len(kv) for kv in self._data.values())
        return f"<Config {nsec} sections, {nkey} keys>"


def parse_overrides(argv: List[str]) -> Tuple[List[Tuple[str, str]], List[str]]:
    """Split ``--section/key=value`` flags from an argv list.

    Returns (overrides, remaining_args).  Mirrors the reference's CLI
    convention where any --path=value flag is a config override
    (common/misc/handle_args.cc:45-58).
    """
    overrides: List[Tuple[str, str]] = []
    rest: List[str] = []
    for arg in argv:
        if arg.startswith("--") and "=" in arg:
            path, _, value = arg[2:].partition("=")
            if "/" in path:
                overrides.append((path, value))
                continue
        rest.append(arg)
    return overrides, rest


def default_config_path() -> str:
    return os.path.join(os.path.dirname(__file__), "defaults.cfg")


def load_config(
    path: Optional[str] = None,
    overrides: Optional[List[Tuple[str, str]]] = None,
    argv: Optional[List[str]] = None,
) -> Config:
    """Load defaults, then an optional config file, then overrides."""
    cfg = Config.from_file(default_config_path())
    if path is not None:
        cfg.merge_file(path)
    if argv is not None:
        parsed, _ = parse_overrides(argv)
        for p, v in parsed:
            cfg.set(p, v)
    if overrides:
        for p, v in overrides:
            cfg.set(p, v)
    return cfg


def split_set_overrides(argv):
    """Partition ``argv`` into (positional_args, overrides) where the
    overrides are the ``sec/key=val`` payloads of ``--set sec/key=val``
    or ``--set=sec/key=val`` flags — the shared flag grammar of the
    profiling tools (tools/profile_round.py, tools/profile_phases.py),
    extracted so the two parsers cannot drift."""
    overrides: List[str] = []
    plain: List[str] = []
    it = iter(argv)
    for a in it:
        if a == "--set":
            try:
                overrides.append(next(it))
            except StopIteration:
                raise SystemExit("--set requires a sec/key=val argument")
        elif a.startswith("--set="):
            overrides.append(a[len("--set="):])
        else:
            plain.append(a)
    return plain, overrides


def apply_set_overrides(cfg: "Config", overrides) -> None:
    """Apply ``sec/key=val`` override strings onto a Config in order."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        cfg.set(key, val)
