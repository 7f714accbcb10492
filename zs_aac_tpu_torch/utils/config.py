"""The drivers' config reader: the YAML subset of the repo's configs, no pyyaml.

``load_config(path)`` returns what ``yaml.safe_load`` returns for the YAML
the repo writes and reads (``configs/*.yaml``, ``yaml.safe_dump`` output of a
dict of scalars, lists and dicts): ``#`` comments, block mappings, block
sequences, flow sequences and mappings that may span lines (with a trailing
comma), single- and double-quoted strings, and plain scalars resolved by
YAML 1.1's rules as PyYAML applies them (``yes``/``no``/``on``/``off`` are
booleans, ``5e-5`` and ``1.0e3`` are strings, ``1.0e+3`` a float, ``017``
octal, ``1:30`` sexagesimal), with the ``!!float``, ``!!int``, ``!!str``,
``!!bool`` and ``!!null`` tags. A ``.json`` path is read as JSON.

Anything else (anchors and aliases, block scalars, multi-line plain or
quoted scalars, complex keys, dates, several documents) raises a
``ValueError`` that names the line.
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

__all__ = ["load_config", "parse_yaml"]

# PyYAML's implicit resolvers (yaml/resolver.py), in the order it tries them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Err(ValueError):
    pass


def _sexagesimal(parts, cast):
    value = cast(0)
    for p in parts:
        value = value * 60 + cast(p)
    return value


def _yaml_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    s = s.lstrip("+-")
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    if ":" in s:
        return sign * _sexagesimal(s.split(":"), int)
    return sign * int(s)


def _yaml_float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1 if s[0] == "-" else 1
    s = s.lstrip("+-")
    if s == ".inf":
        return sign * float("inf")
    if s == ".nan":
        return float("nan")
    if ":" in s:
        return sign * _sexagesimal(s.split(":"), float)
    return sign * float(s)


def _resolve(s: str, line: int) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers."""
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _NULL.match(s):
        return None
    if _FLOAT.match(s):
        return _yaml_float(s)
    if _INT.match(s):
        return _yaml_int(s)
    if _TIMESTAMP.match(s) or s in ("<<", "="):
        raise _Err(f"line {line}: {s!r} (a date, merge key or value key) is outside the subset")
    return s


_TAGS = {"!!str": str, "!!float": _yaml_float, "!!int": _yaml_int,
         "!!bool": lambda s: {"yes": True, "true": True, "on": True, "no": False,
                              "false": False, "off": False}[s.lower()],
         "!!null": lambda s: None}


class _Scanner:
    """One value written on a line (or, for flow collections, several
    joined lines): a quoted or plain scalar, or a flow collection."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def err(self, msg):
        raise _Err(f"line {self.line}: {msg}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def quoted(self) -> str:
        q, s = self.s[self.i], self.s
        self.i += 1
        out = []
        while True:
            if self.i >= len(s):
                self.err("unterminated quoted string (multi-line strings are outside the subset)")
            c = s[self.i]
            if q == "'" and c == "'":
                if s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX:
                    n = _HEX[e]
                    out.append(chr(int(s[self.i + 2:self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    self.err(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        stops = ",[]{}" if flow else ""
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in stops:
                break
            if c == ":" and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t" + stops):
                break
            self.i += 1
        return self.s[start:self.i].rstrip()

    def node(self, flow: bool = False) -> Any:
        self.ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self.collection("]")
        if c == "{":
            return self.collection("}")
        if c in "'\"":
            return self.quoted()
        if c == "!":
            m = re.match(r"!![a-z]+", self.s[self.i:])
            tag = m.group(0) if m else self.s[self.i:self.i + 2]
            if tag not in _TAGS:
                self.err(f"tag {tag!r} is outside the subset")
            self.i += len(tag)
            self.ws()
            if self.i < len(self.s) and self.s[self.i] in "'\"":
                raw = self.quoted()
            else:
                raw = self.plain(flow)
            try:
                return _TAGS[tag](raw)
            except (ValueError, KeyError, IndexError):
                self.err(f"{raw!r} is not a valid {tag}")
        if c in "&*|>%@`?":
            self.err(f"{c!r} (anchors, aliases, block scalars, directives, complex keys) "
                     "is outside the subset")
        if c == "-" and self.s[self.i + 1:self.i + 2] in ("", " "):
            self.err("a block sequence cannot start after a key on the same line")
        return _resolve(self.plain(flow), self.line)

    def collection(self, close: str) -> Any:
        self.i += 1
        out: Any = [] if close == "]" else {}
        while True:
            self.ws()
            if self.i >= len(self.s):
                self.err("unterminated flow collection")
            if self.s[self.i] == close:
                self.i += 1
                return out
            item = self.node(flow=True)
            self.ws()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                value = self.node(flow=True)
                if isinstance(out, list):
                    out.append({item: value})     # a single-pair mapping, as YAML reads it
                else:
                    out[item] = value
            elif isinstance(out, list):
                out.append(item)
            else:
                out[item] = None
            self.ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != close:
                self.err(f"expected ',' or {close!r} in a flow collection")

    def end(self):
        self.ws()
        if self.i != len(self.s):
            self.err(f"unexpected text {self.s[self.i:]!r}")


def _strip_comment(text: str) -> Tuple[str, int]:
    """The line without its comment, and its flow-bracket balance."""
    quote, depth, i = None, 0, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote == "'" and text[i + 1:i + 2] == "'":
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip(), depth
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return text.rstrip(), depth


def _logical_lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of each line that holds something, a
    flow collection's continuation lines joined to the line it opened on."""
    out: List[Tuple[int, str, int]] = []
    pending = None
    docs = 0
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise _Err(f"line {n}: tabs in indentation")
        body, depth = _strip_comment(raw)
        if pending is not None:
            ind, content, start, d = pending
            content, d = content + " " + body.strip(), d + depth
            pending = (ind, content, start, d) if d > 0 else None
            if pending is None:
                out.append((ind, content, start))
            continue
        if not body.strip():
            continue
        if body.rstrip() in ("---", "..."):
            docs += body.rstrip() == "---"
            if out or docs > 1:
                raise _Err(f"line {n}: several documents are outside the subset")
            continue
        ind = len(body) - len(body.lstrip(" "))
        if depth > 0:
            pending = (ind, body.strip(), n, depth)
        else:
            out.append((ind, body.strip(), n))
    if pending is not None:
        raise _Err(f"line {pending[2]}: unterminated flow collection")
    return out


def _split_key(content: str, line: int):
    """(key, rest) of a ``key: value`` line, or None where it holds no key."""
    sc = _Scanner(content, line)
    if content[0] in "'\"":
        key = sc.quoted()
        sc.ws()
        if content[sc.i:sc.i + 1] != ":":
            return None
        return key, content[sc.i + 1:]
    if content[0] in "[{":
        return None
    raw = sc.plain(flow=False)
    if sc.i >= len(content) or content[sc.i] != ":":
        return None
    if content[0] in "?&*!|>%@`":
        raise _Err(f"line {line}: {content[0]!r} before a key is outside the subset")
    return _resolve(raw, line), content[sc.i + 1:]


class _Parser:
    def __init__(self, lines):
        self.lines, self.k = lines, 0

    def peek(self):
        return self.lines[self.k] if self.k < len(self.lines) else None

    @staticmethod
    def is_item(content):
        return content == "-" or content.startswith("- ")

    def block(self, ind: int) -> Any:
        ind0, content, n = self.peek()
        if self.is_item(content):
            return self.sequence(ind0)
        if _split_key(content, n) is not None:
            return self.mapping(ind0)
        self.k += 1
        sc = _Scanner(content, n)
        value = sc.node()
        sc.end()
        nxt = self.peek()
        if nxt is not None and nxt[0] > ind:
            raise _Err(f"line {nxt[2]}: multi-line plain scalars are outside the subset")
        return value

    def value_after(self, rest: str, ind: int, n: int, in_seq_item: bool) -> Any:
        if rest.strip():
            sc = _Scanner(rest, n)
            value = sc.node()
            sc.end()
            nxt = self.peek()
            if nxt is not None and nxt[0] > ind and not in_seq_item:
                raise _Err(f"line {nxt[2]}: unexpected indentation")
            return value
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt[0] > ind or (nxt[0] == ind and self.is_item(nxt[1]) and not in_seq_item):
            return self.block(ind)
        return None

    def mapping(self, ind: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line[0] < ind:
                return out
            i, content, n = line
            if i > ind:
                raise _Err(f"line {n}: unexpected indentation")
            if self.is_item(content):
                if out:
                    raise _Err(f"line {n}: a sequence item inside a mapping")
                return out
            kv = _split_key(content, n)
            if kv is None:
                raise _Err(f"line {n}: expected 'key: value'")
            self.k += 1
            out[kv[0]] = self.value_after(kv[1], ind, n, False)

    def sequence(self, ind: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line[0] < ind:
                return out
            i, content, n = line
            if i > ind:
                raise _Err(f"line {n}: unexpected indentation")
            if not self.is_item(content):
                return out
            rest = content[1:]
            body = rest.lstrip(" ")
            if not body:
                self.k += 1
                out.append(self.value_after("", ind, n, True) if (
                    self.peek() is not None and self.peek()[0] > ind) else None)
                continue
            # the item's content starts a node at its own column
            col = ind + 1 + len(rest) - len(body)
            self.lines[self.k] = (col, body, n)
            if self.is_item(body) or _split_key(body, n) is not None:
                out.append(self.block(col))
            else:
                self.k += 1
                sc = _Scanner(body, n)
                out.append(sc.node())
                sc.end()
                nxt = self.peek()
                if nxt is not None and nxt[0] > ind:
                    raise _Err(f"line {nxt[2]}: unexpected indentation")


def parse_yaml(text: str) -> Any:
    """The value of a YAML document in the subset (see the module doc)."""
    lines = _logical_lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    value = p.block(lines[0][0])
    if p.peek() is not None:
        raise _Err(f"line {p.peek()[2]}: unexpected content after the document's top node")
    return value


def load_config(path: str) -> Any:
    """A driver config file: JSON where ``path`` ends in ``.json``, else the
    YAML subset, as ``yaml.safe_load`` reads it."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if str(path).endswith(".json"):
        return json.loads(text)
    return parse_yaml(text)
