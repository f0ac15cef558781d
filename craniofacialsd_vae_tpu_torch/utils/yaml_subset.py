"""A reader for the YAML subset the run configs use, resolved as PyYAML's
``safe_load`` resolves it (YAML 1.1), for machines without ``pyyaml``.

Supported: block mappings and block sequences by indentation, flow
sequences and flow mappings (``[4, 4]``, ``{a: 1}``), full-line and
trailing comments, and plain, single- and double-quoted scalars. Plain
scalars resolve by YAML 1.1's implicit rules, as PyYAML does: ``1e-4``
(no dot) stays the *string* ``'1e-4'``, ``1.0e-4`` is a float, ``none``
is a string, ``True``/``yes``/``on`` are bools, ``~``/``null``/empty are
None, ``010`` is octal. Anything else (anchors, tags, block scalars,
multi-line plain scalars, timestamps) raises ``ValueError`` rather than
being read differently from PyYAML.
"""

from __future__ import annotations

import json
import re

__all__ = ["safe_load", "safe_dump"]

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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# the first characters PyYAML's resolvers are registered for
_FIRST = {"bool": "yYnNtTfFoO", "float": "-+0123456789.",
          "int": "-+0123456789", "null": "~nN"}


def _sexagesimal(value: str, cast):
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str):
    """A plain (unquoted) scalar as ``yaml.safe_load`` resolves it."""
    first = text[:1]
    if first in _FIRST["bool"] and _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if first in _FIRST["float"] and _FLOAT.match(text):
        return _to_float(text)
    if first in _FIRST["int"] and _INT.match(text):
        return _to_int(text)
    if (first == "" or first in _FIRST["null"]) and _NULL.match(text):
        return None
    if text == "<<" or text == "=":
        raise ValueError(f"unsupported YAML scalar {text!r}")
    if first.isdigit() and _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are not supported: {text!r}")
    if first in "!&*|>%@`":
        raise ValueError(f"unsupported YAML construct {text!r}")
    return text


# ---------------------------------------------------------------- lexing
def _strip_comment(line: str) -> str:
    """The line without a trailing comment (``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    continue
                if quote == '"' and line[i - 1:i] == "\\":
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _open_brackets(line: str) -> int:
    """Flow brackets opened and not closed on ``line`` (outside quotes)."""
    depth, quote = 0, None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> list:
    """(indent, content, line number) of each line with content; a flow
    collection spread over several lines is joined into its first."""
    out, pending = [], None
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tabs in indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if pending is not None:
            indent, content, first = pending
            content = f"{content} {line.strip()}"
            if _open_brackets(content) > 0:
                pending = (indent, content, first)
            else:
                out.append((indent, content, first))
                pending = None
            continue
        if line in ("---", "..."):
            continue
        entry = (len(line) - len(line.lstrip(" ")), line.strip(), n)
        if _open_brackets(entry[1]) > 0:
            pending = entry
        else:
            out.append(entry)
    if pending is not None:
        raise ValueError(f"line {pending[2]}: unterminated flow collection")
    return out


def _unquote(text: str, n: int) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"line {n}: unterminated quoted scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        return body.replace("''", "'")
    out, i = [], 0
    escapes = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
               "r": "\r", "0": "\0", " ": " ", "a": "\a", "b": "\b",
               "e": "\x1b", "f": "\f", "v": "\v"}
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        nxt = body[i + 1:i + 2]
        if nxt in escapes:
            out.append(escapes[nxt])
            i += 2
        elif nxt in ("x", "u", "U"):
            width = {"x": 2, "u": 4, "U": 8}[nxt]
            out.append(chr(int(body[i + 2:i + 2 + width], 16)))
            i += 2 + width
        else:
            raise ValueError(f"line {n}: unsupported escape \\{nxt}")
    return "".join(out)


def _scalar(text: str, n: int):
    text = text.strip()
    if text[:1] in "'\"":
        return _unquote(text, n)
    if text[:1] in "[{":
        value, rest = _flow(text, 0, n)
        if text[rest:].strip():
            raise ValueError(f"line {n}: trailing text after {text[:rest]!r}")
        return value
    if re.search(r":( |$)", text):
        raise ValueError(f"line {n}: mapping values are not allowed here: "
                         f"{text!r}")
    return resolve_plain(text)


def _flow(text: str, i: int, n: int):
    """A flow sequence or mapping starting at ``text[i]`` → (value, index
    after it)."""
    close = "]" if text[i] == "[" else "}"
    is_map = close == "}"
    items = {} if is_map else []
    i += 1

    def skip(i):
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise ValueError(f"line {n}: unterminated flow collection")
        return i

    def token(i, stops):
        """A plain or quoted scalar's text from ``text[i]`` up to a stop."""
        start, quote = i, None
        while i < len(text):
            ch = text[i]
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"" and i == start:
                quote = ch
            elif ch in ",]}" or (":" in stops and ch == ":"
                                 and text[i + 1:i + 2] in (" ", ",", "}", "")):
                break
            i += 1
        return text[start:i].strip(), i

    def item(i, stops):
        i = skip(i)
        if text[i] in "[{":
            return _flow(text, i, n)
        tok, i = token(i, stops)
        return (_scalar(tok, n) if tok else None), i

    while True:
        i = skip(i)
        if text[i] == close:
            return items, i + 1
        if is_map:
            key, i = item(i, ":")
            i = skip(i)
            value = None
            if text[i] == ":":
                i = skip(i + 1)
                if text[i] not in ",}":
                    value, i = item(i, "")
            items[key] = value
        else:
            value, i = item(i, "")
            items.append(value)
        i = skip(i)
        if i < len(text) and text[i] == ",":
            i += 1
        elif i < len(text) and text[i] != close:
            raise ValueError(f"line {n}: expected ',' or {close!r} in flow "
                             "collection")


def _split_key(content: str, n: int):
    """``key: value`` → (key, value text) or None when ``content`` is not a
    mapping entry."""
    if content[:1] in "'\"":
        end = content.find(content[0], 1)
        while content[0] == "'" and content[end + 1:end + 2] == "'":
            end = content.find("'", end + 2)
        if end < 0:
            raise ValueError(f"line {n}: unterminated quoted key")
        rest = content[end + 1:]
        if rest == ":" or rest.startswith(": "):
            return _unquote(content[:end + 1], n), rest[1:].strip()
        return None
    if content[:1] in "[{":
        return None
    m = re.search(r":( |$)", content)
    if not m:
        return None
    return resolve_plain(content[:m.start()].rstrip()), content[m.end():]


# --------------------------------------------------------------- parsing
def _block(lines: list, i: int, indent: int):
    """The block node whose lines start at ``lines[i]`` with ``indent`` →
    (value, next line index)."""
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        return _sequence(lines, i, indent)
    if _split_key(content, lines[i][2]) is not None:
        return _mapping(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1][0] >= indent:
        raise ValueError(f"line {lines[i][2]}: multi-line plain scalars are "
                         "not supported")
    return _scalar(content, lines[i][2]), i + 1


def _value_after(lines: list, i: int, indent: int, text: str, n: int,
                 in_sequence: bool = False):
    """The value of an entry whose inline text is ``text`` (the entry on
    line i - 1): inline, or the nested block that follows."""
    if text:
        if i < len(lines) and lines[i][0] > indent:
            raise ValueError(f"line {lines[i][2]}: unexpected indentation "
                             "(multi-line scalars are not supported)")
        return _scalar(text, n), i
    if i < len(lines):
        nxt_indent, nxt, _ = lines[i]
        if nxt_indent > indent:
            return _block(lines, i, nxt_indent)
        # a block sequence may sit at its key's own indentation
        if (not in_sequence and nxt_indent == indent
                and (nxt == "-" or nxt.startswith("- "))):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines: list, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, n = lines[i]
        entry = _split_key(content, n)
        if entry is None:
            break
        key, text = entry
        out[key], i = _value_after(lines, i + 1, indent, text.strip(), n)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"line {lines[i][2]}: unexpected indentation")
    return out, i


def _sequence(lines: list, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent:
        _, content, n = lines[i]
        if not (content == "-" or content.startswith("- ")):
            break
        text = content[1:].strip()
        if text and (text == "-" or text.startswith("- ")
                     or _split_key(text, n) is not None):
            # "- key: value" or "- - x": a block whose first line shares
            # the dash's
            child = indent + 1 + len(content[1:]) - len(content[1:].lstrip())
            sub = [(child, text, n)] + lines[i + 1:]
            value, j = _block(sub, 0, child)
            out.append(value)
            i = i + j
            continue
        value, i = _value_after(lines, i + 1, indent, text, n,
                                in_sequence=True)
        out.append(value)
    return out, i


def safe_load(text: str):
    """The document in ``text`` as ``yaml.safe_load`` gives it, for the
    subset described in the module docstring."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"line {lines[i][2]}: unexpected content "
                         f"{lines[i][1]!r}")
    return value


_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 reads a float only with a dot in it
        return text.replace("e", ".0e") if "." not in text else text
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    raise ValueError(f"cannot write {type(v).__name__} {v!r} as YAML")


def safe_dump(data: dict) -> str:
    """A mapping of mappings, lists and scalars (None, bool, int, float,
    str) as block YAML that ``safe_load`` here and PyYAML's read back as
    the same values: strings double-quoted, lists in flow style, floats
    with a dot."""
    lines = []

    def mapping(d: dict, indent: int) -> None:
        for k, v in d.items():
            key = k if isinstance(k, str) and _PLAIN_KEY.match(k) \
                and resolve_plain(k) == k else json.dumps(str(k))
            if isinstance(v, dict) and v:
                lines.append(" " * indent + f"{key}:")
                mapping(v, indent + 2)
            else:
                lines.append(" " * indent + f"{key}: "
                             + ("{}" if isinstance(v, dict)
                                else _dump_scalar(v)))

    mapping(data, 0)
    return "\n".join(lines) + "\n"
