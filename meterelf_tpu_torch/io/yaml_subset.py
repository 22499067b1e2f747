"""A reader and a writer for the subset of YAML that camera parameter
files use, with no dependency: the card's machine has no PyYAML.

``load`` gives what ``yaml.safe_load`` (PyYAML, YAML 1.1) gives for a
document made of

- block mappings, nested by indentation, and block sequences (also the
  "indentless" form, ``- item`` lines at their key's indentation), whose
  entries may be mappings (``- name: ...``);
- flow sequences and flow mappings (``[x, y]``, ``{h: 1, l: 2}``), which
  may span lines;
- comments, and plain, single-quoted and double-quoted scalars on one
  line.

Plain scalars resolve as PyYAML's implicit resolvers resolve them: the
booleans ``yes/no/true/false/on/off`` (lower, Capitalised or UPPER),
ints (decimal, ``0b``, ``0x``, a leading ``0`` for octal, ``:`` for base
60), floats only with a dot (``1.0``, ``.5``, ``1.0e+3``; ``1e3`` stays
a string), ``.inf`` and ``.nan``, and ``~``, ``null`` and the empty
value as None. So ``angle_of_zero: 90`` is an int, as the strict type
checks of params.py expect.

Anything else raises ``YamlSubsetError`` (a ValueError) and is never
read otherwise: anchors and aliases, tags, block scalars (``|``, ``>``),
explicit keys, directives and document markers, scalars that continue
on a second line, timestamps, merge keys, tabs, and the flow
forms whose reading differs between YAML versions (a ``:`` or ``?``
inside a plain scalar in a flow collection, a key: value pair as a flow
sequence entry). ``dump`` writes the block form of a mapping that
``load`` and ``yaml.safe_load`` read back equal.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple


class YamlSubsetError(ValueError):
    """The document is not YAML, or uses YAML outside the subset."""


# PyYAML's implicit resolvers (yaml/resolver.py), in its order of trial
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_REFUSED = re.compile(r"""^(?:<<|=
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
                     (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                      re.X)   # merge key, value key, timestamps
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010ffff]")
# characters a plain scalar cannot start with ('-' can, before a non-space)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ",
            '"': '"', "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}


def resolve(text: str) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    if _REFUSED.match(text):
        raise YamlSubsetError(f"plain scalar {text!r}: a merge key, value "
                              "key or timestamp (outside the subset)")
    try:
        return _construct(text)
    except ValueError as e:   # int('', 2) of '0b_', as PyYAML fails
        raise YamlSubsetError(f"plain scalar {text!r}: {e}") from e


def _construct(text: str) -> Any:
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _base60([float(p) for p in v.split(":")], 0.0)
        return sign * float(v)
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _base60([int(p) for p in v.split(":")], 0)
        return sign * int(v)
    if _NULL.match(text):
        return None
    return text


def _base60(digits: List[Any], zero: Any) -> Any:
    value = zero
    for d in digits:
        value = value * 60 + d
    return value


def _fail(lineno: int, what: str) -> YamlSubsetError:
    return YamlSubsetError(f"line {lineno}: {what}")


def _quoted(text: str, pos: int, lineno: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos] (a quote), on one line ->
    (its value, the position after the closing quote)."""
    q = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if c == "\n":
            break
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            n = _ESCAPE_CODES.get(e)
            digits = text[i + 2:i + 2 + n] if n else ""
            if not n or len(digits) != n or not all(
                    d in "0123456789abcdefABCDEF" for d in digits):
                raise _fail(lineno, f"escape {text[i:i + 2]!r} outside the "
                            "subset")
            out.append(chr(int(digits, 16)))
            i += 2 + n
            continue
        out.append(c)
        i += 1
    raise _fail(lineno, "a quoted scalar that does not close on its line")


def _check_plain_start(text: str, pos: int, lineno: int) -> None:
    c = text[pos]
    if c in _INDICATORS and not (
            c == "-" and text[pos + 1:pos + 2] not in ("", " ", "\n")):
        raise _fail(lineno, f"{c!r} cannot start a scalar here (anchors, "
                    "aliases, tags, block scalars and explicit keys are "
                    "outside the subset)")


def _block_plain(text: str, pos: int, lineno: int) -> Tuple[str, int]:
    """The plain scalar at text[pos] in block context -> (its text, the
    position where it stops: the end, a ': ' or a ' #')."""
    _check_plain_start(text, pos, lineno)
    i = pos
    while i < len(text):
        c = text[i]
        if c == ":" and text[i + 1:i + 2] in ("", " "):
            break
        if c == "#" and text[i - 1] == " ":
            break
        i += 1
    return text[pos:i].rstrip(" "), i


def _rest_is_empty(text: str, pos: int) -> bool:
    """Only blanks or a comment from pos to the end of the line."""
    rest = text[pos:].split("\n", 1)[0]
    stripped = rest.lstrip(" ")
    return not stripped or (stripped[0] == "#" and (
        len(stripped) < len(rest) or pos == 0 or text[pos - 1] == " "))


class _Flow:
    """Recursive descent over a flow collection that may span lines."""

    def __init__(self, buf: str, lineno: int) -> None:
        self.buf = buf
        self.lineno = lineno

    def fail(self, pos: int, what: str) -> YamlSubsetError:
        return _fail(self.lineno + self.buf.count("\n", 0, pos), what)

    def skip(self, pos: int) -> int:
        b = self.buf
        while pos < len(b):
            c = b[pos]
            if c in " \n":
                pos += 1
            elif c == "#":
                if pos > 0 and b[pos - 1] not in " \n":
                    raise self.fail(pos, "'#' that is not a comment")
                end = b.find("\n", pos)
                pos = len(b) if end < 0 else end
            else:
                break
        return pos

    def peek(self, pos: int) -> str:
        if pos >= len(self.buf):
            raise self.fail(pos, "a flow collection that does not close")
        return self.buf[pos]

    def scalar(self, pos: int) -> Tuple[Any, int]:
        b = self.buf
        if b[pos] in "'\"":
            return _quoted(b, pos, self.lineno + b.count("\n", 0, pos))
        _check_plain_start(b, pos, self.lineno + b.count("\n", 0, pos))
        i = pos
        while i < len(b) and b[i] not in ",[]{}\n" and not (
                b[i] == "#" and b[i - 1] == " ") and not (
                b[i] == ":" and b[i + 1:i + 2] in ("", " ", "\n", ",", "[",
                                                   "]", "{", "}")):
            i += 1
        text = b[pos:i].rstrip(" ")
        if ":" in text or "?" in text:
            raise self.fail(pos, f"plain scalar {text!r} with ':' or '?' "
                            "in a flow collection (outside the subset)")
        return resolve(text), i

    def value(self, pos: int) -> Tuple[Any, int]:
        pos = self.skip(pos)
        c = self.peek(pos)
        if c == "[":
            return self.sequence(pos + 1)
        if c == "{":
            return self.mapping(pos + 1)
        return self.scalar(pos)

    def sequence(self, pos: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while True:
            pos = self.skip(pos)
            if self.peek(pos) == "]":
                return out, pos + 1
            v, pos = self.value(pos)
            pos = self.skip(pos)
            c = self.peek(pos)
            if c == ":":
                raise self.fail(pos, "a key: value pair as a flow sequence "
                                "entry (outside the subset)")
            out.append(v)
            if c == ",":
                pos += 1
            elif c == "]":
                return out, pos + 1
            else:
                raise self.fail(pos, f"expected ',' or ']', found {c!r}")

    def mapping(self, pos: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        while True:
            pos = self.skip(pos)
            c = self.peek(pos)
            if c == "}":
                return out, pos + 1
            if c in "[{":
                raise self.fail(pos, "a collection as a mapping key")
            key, pos = self.scalar(pos)
            while self.peek(pos) == " ":
                pos += 1
            value = None
            if self.buf[pos] == ":":
                if self.peek(pos + 1) not in " \n":
                    raise self.fail(pos, "':' not followed by a blank")
                pos = self.skip(pos + 1)
                if self.peek(pos) not in ",}":
                    value, pos = self.value(pos)
                    pos = self.skip(pos)
            out[key] = value
            c = self.peek(pos)
            if c == ",":
                pos += 1
            elif c != "}":
                raise self.fail(pos, f"expected ',' or '}}', found {c!r}")


class _Block:
    """The block structure, one entry of ``lines`` a line that is not
    blank and not only a comment: [indent, text, line number]."""

    def __init__(self, text: str) -> None:
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise YamlSubsetError(f"unacceptable character {bad.group()!r}")
        if "\t" in text:   # PyYAML refuses most tabs outside quotes
            raise YamlSubsetError("a tab character (outside the subset)")
        self.lines: List[List[Any]] = []
        for n, raw in enumerate(text.split("\n"), 1):
            line = raw[:-1] if raw.endswith("\r") else raw
            if any(c in line for c in "\r\x85\u2028\u2029"):
                raise _fail(n, "a line break other than LF or CRLF")
            body = line.lstrip(" ")
            if not body or body.startswith("#"):
                continue
            indent = len(line) - len(body)
            if indent == 0 and (body[:1] == "%" or body.rstrip(" ") in (
                    "---", "...") or body[:4] in ("--- ", "... ")):
                raise _fail(n, "directives and document markers are "
                            "outside the subset")
            self.lines.append([indent, body.rstrip(" "), n])
        self.i = 0

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node(-1)
        if self.i < len(self.lines):
            raise _fail(self.lines[self.i][2], "content after the document")
        return value

    def at(self, indent: int) -> Optional[str]:
        """The current line's text when it is at ``indent``, else None."""
        if self.i < len(self.lines) and self.lines[self.i][0] == indent:
            return self.lines[self.i][1]
        return None

    def deeper(self, indent: int) -> bool:
        return self.i < len(self.lines) and self.lines[self.i][0] > indent

    def node(self, parent: int) -> Any:
        indent, text, lineno = self.lines[self.i]
        if _is_entry(text):
            return self.sequence(indent)
        if self.key(text, lineno) is not None:
            return self.mapping(indent)
        return self.inline(text, parent)

    def key(self, text: str, lineno: int) -> Optional[Tuple[Any, str]]:
        """(key, the text after ':') when the line is 'key: ...', else
        None."""
        if text[0] in "'\"":
            key, pos = _quoted(text, 0, lineno)
        elif text[0] in "[{":
            return None
        else:
            plain, pos = _block_plain(text, 0, lineno)
            key = resolve(plain)
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if text[pos:pos + 1] == ":" and text[pos + 1:pos + 2] in ("", " "):
            return key, text[pos + 1:].lstrip(" ")
        return None

    def mapping(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while (text := self.at(indent)) is not None:
            lineno = self.lines[self.i][2]
            kv = None if _is_entry(text) else self.key(text, lineno)
            if kv is None:
                raise _fail(lineno, "expected 'key: value'")
            key, rest = kv
            if rest and not _rest_is_empty(rest, 0):
                value = self.inline(rest, indent)
            else:
                self.i += 1
                if self.deeper(indent):
                    value = self.node(indent)
                elif (t := self.at(indent)) is not None and _is_entry(t):
                    value = self.sequence(indent)
                else:
                    value = None
            out[key] = value
        if self.deeper(indent):
            raise _fail(self.lines[self.i][2], "bad indentation (or a "
                        "scalar that continues on a second line)")
        return out

    def sequence(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while (text := self.at(indent)) is not None and _is_entry(text):
            rest = text[1:].lstrip(" ")
            if not rest or rest[0] == "#":
                self.i += 1
                out.append(self.node(indent) if self.deeper(indent)
                           else None)
                continue
            # the entry's content as a line of its own, at its column
            self.lines[self.i][:2] = [indent + len(text) - len(rest), rest]
            out.append(self.node(indent))
        if self.deeper(indent):
            raise _fail(self.lines[self.i][2], "bad indentation (or a "
                        "scalar that continues on a second line)")
        return out

    def inline(self, text: str, parent: int) -> Any:
        """A scalar or a flow collection that starts on the current line
        (at ``text``, the end of that line); advances past it."""
        lineno = self.lines[self.i][2]
        if text[0] in "[{":
            rest = [f"{' ' * ind}{t}" for ind, t, _ in self.lines[self.i + 1:]]
            buf = "\n".join([text] + rest)
            flow = _Flow(buf, lineno)
            value, end = flow.value(0)
            used = buf.count("\n", 0, end)
            for ind, _, n in self.lines[self.i + 1:self.i + 1 + used]:
                if ind <= parent:
                    raise _fail(n, "a flow collection's line not indented "
                                "past its parent")
            pos = end
        elif text[0] in "'\"":
            value, pos = _quoted(text, 0, lineno)
            buf, used = text, 0
        else:
            plain, pos = _block_plain(text, 0, lineno)
            value, buf, used = resolve(plain), text, 0
        if not _rest_is_empty(buf, pos):
            raise _fail(lineno + used, "unexpected text after a value")
        self.i += used + 1
        return value


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def load(text: str) -> Any:
    """``yaml.safe_load(text)`` for a document in the subset (module
    docstring); YamlSubsetError for anything else."""
    return _Block(text).document()


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------

_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"cannot write the float {v!r}")
        r = repr(v)
        # PyYAML's float needs a dot: 1e-05 -> 1.0e-05
        return r.replace("e", ".0e", 1) if "." not in r else r
    if isinstance(v, str):
        if _KEY.match(v) and resolve(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"cannot write a {type(v).__name__}")


def _flow(v: Any) -> str:
    if isinstance(v, list):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}"
                               for k, x in v.items()) + "}"
    return _scalar(v)


def _leaf(v: Any) -> bool:
    """A collection of scalars (written in flow style), or a scalar."""
    items = v.values() if isinstance(v, dict) else v
    return (not isinstance(v, (list, dict))
            or not any(isinstance(x, (list, dict)) for x in items))


def _block(v: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(v, dict):
        for k, x in v.items():
            if _leaf(x):
                lines.append(f"{pad}{_scalar(k)}: {_flow(x)}")
            else:
                lines.append(f"{pad}{_scalar(k)}:")
                lines += _block(x, indent + 2)
    else:
        for x in v:
            if _leaf(x):
                lines.append(f"{pad}- {_flow(x)}")
            else:
                sub = _block(x, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines += sub[1:]
    return lines


def dump(data: Dict[str, Any]) -> str:
    """A mapping of scalars, lists and mappings as block YAML, with the
    collections of scalars in flow style; ``load`` and ``yaml.safe_load``
    read it back equal."""
    if not isinstance(data, dict) or not data:
        raise ValueError("dump writes a non-empty mapping")
    return "\n".join(_block(data, 0)) + "\n"
