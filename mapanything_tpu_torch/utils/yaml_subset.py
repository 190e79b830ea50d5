"""A parser of the YAML subset that ``configs/`` is written in, with
``yaml.safe_load``'s results (YAML 1.1 scalars, as PyYAML resolves them).

The card's machine has no PyYAML, so the port's config reader parses with
this. What it reads:

- block mappings and block sequences (a sequence may sit at its key's
  indentation; ``- key: value`` items open a mapping), with ``#`` comments;
- flow sequences and flow mappings on one line, nested (``[11, 17, 23]``,
  ``{depth_mode: exp, confidence_vmin: 1.0}``);
- single-quoted scalars (``''`` escapes a quote) and double-quoted ones
  (backslash escapes), which may run over several lines (folded: a line break
  and the next line's indentation become one space, an empty line a newline);
- plain scalars on one line, resolved by PyYAML's YAML 1.1 rules: null (``~``,
  ``null``, empty), bool (``true``/``yes``/``on`` and their opposites, in
  three cases), int (decimal, ``0b``, ``0x``, a leading-zero octal,
  sexagesimal ``1:30``, underscores), float (a dot and, for an exponent, its
  sign: ``1.0e-4`` is a float, ``5e-5`` and ``1.0e4`` stay strings;
  ``.inf``, ``.nan``) and strings.

Anything else (anchors, aliases, tags, block scalars ``|`` and ``>``, plain
scalars over several lines, flow collections over several lines, documents
markers and directives, timestamps, merge keys, tabs in indentation) raises
``YamlSubsetError``: the parser does not guess.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

__all__ = ["YamlSubsetError", "loads", "load_file", "resolve_plain"]


class YamlSubsetError(ValueError):
    """A construct outside the subset, or a document that is not valid YAML."""


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast):
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers and constructors."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        value, sign = text.replace("_", ""), 1
        if value[0] == "-":
            sign = -1
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
    if _FLOAT.match(text):
        value, sign = text.replace("_", "").lower(), 1.0
        if value[0] == "-":
            sign = -1.0
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _TIMESTAMP.match(text):
        raise YamlSubsetError(f"timestamps are outside the subset: {text!r}")
    if text in ("<<", "="):
        raise YamlSubsetError(f"merge and value keys are outside the subset: {text!r}")
    return text


def _strip_comment(rest: str, where: str) -> None:
    """What follows a complete node on its line: nothing, or a comment."""
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise YamlSubsetError(f"{where}: unexpected {rest!r} after a value")


def _unescape_double(body: str, where: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YamlSubsetError(f"{where}: unknown escape \\{e}")
    return "".join(out)


def _fold(pieces: List[str]) -> str:
    """Join the lines of a multi-line quoted scalar: trailing and leading blanks of the
    breaks dropped, a break between text lines a space, each empty line a newline."""
    first, *rest = pieces
    out = first.rstrip(" \t")
    empty = 0
    for k, piece in enumerate(rest):
        last = k == len(rest) - 1
        text = piece.lstrip(" \t") if last else piece.strip(" \t")
        if not text and not last:
            empty += 1
            continue
        out += "\n" * empty if empty else " "
        out += text
        empty = 0
    return out


class _Parser:
    def __init__(self, text: str, name: str):
        self.lines = text.splitlines()
        self.name = name
        self.indent_of_node = -1  # the indentation of the entry whose value is being read

    def where(self, i: int) -> str:
        return f"{self.name}:{i + 1}"

    # ---------------------------------------------------------------- lines
    def content(self, i: int) -> Tuple[int, str]:
        """(indentation, text) of line i; text '' for a blank or comment-only line."""
        line = self.lines[i]
        stripped = line.lstrip(" ")
        if stripped.startswith("\t") or (stripped and "\t" in line[:len(line) - len(stripped)]):
            raise YamlSubsetError(f"{self.where(i)}: tabs in indentation")
        if not stripped.strip() or stripped.startswith("#"):
            return -1, ""
        return len(line) - len(stripped), stripped.rstrip()

    def next_content(self, i: int) -> int:
        while i < len(self.lines) and self.content(i)[1] == "":
            i += 1
        return i

    # ---------------------------------------------------------------- scalars
    def quoted(self, i: int, col: int) -> Tuple[str, int, str]:
        """A quoted scalar opening at column ``col`` of line i: (value, the line it
        closes on, the rest of that line after the closing quote)."""
        quote = self.lines[i][col]
        pieces, line, start = [], i, col + 1
        while True:
            text = self.lines[line]
            j = start
            while j < len(text):
                if quote == "'" and text[j] == "'":
                    if j + 1 < len(text) and text[j + 1] == "'":
                        j += 2
                        continue
                    break
                if quote == '"' and text[j] == "\\":
                    j += 2
                    continue
                if quote == '"' and text[j] == '"':
                    break
                j += 1
            if j < len(text):
                pieces.append(text[start:j])
                break
            if quote == '"' and text.endswith("\\") and not text.endswith("\\\\"):
                raise YamlSubsetError(f"{self.where(line)}: escaped line breaks are outside the subset")
            pieces.append(text[start:])
            line += 1
            start = 0
            if line >= len(self.lines):
                raise YamlSubsetError(f"{self.where(i)}: unterminated quoted scalar")
        raw = _fold(pieces) if len(pieces) > 1 else pieces[0]
        value = raw.replace("''", "'") if quote == "'" else _unescape_double(raw, self.where(i))
        return value, line, self.lines[line][j + 1:]

    def inline(self, i: int, col: int) -> Tuple[Any, int]:
        """The node that starts at column ``col`` of line i and ends on its line (or,
        quoted, on a later one); returns (value, the next line)."""
        text = self.lines[i]
        c = text[col]
        if c in "\"'":
            value, end, rest = self.quoted(i, col)
            _strip_comment(rest, self.where(end))
            return value, end + 1
        if c in "[{":
            value, j = self.flow(text, col, self.where(i))
            _strip_comment(text[j:], self.where(i))
            return value, i + 1
        if c in "&*!|>%@`":
            raise YamlSubsetError(f"{self.where(i)}: {c!r} (anchors, aliases, tags, block scalars, directives) "
                                  "is outside the subset")
        plain = re.split(r"\s#", text[col:], maxsplit=1)[0].rstrip()
        if ": " in plain or plain.endswith(":"):
            raise YamlSubsetError(f"{self.where(i)}: a mapping where a scalar was expected: {plain!r}")
        if text.startswith(("---", "...")) and col == 0:
            raise YamlSubsetError(f"{self.where(i)}: document markers are outside the subset")
        nxt = self.next_content(i + 1)
        if nxt < len(self.lines) and self.content(nxt)[0] > self.indent_of_node and not self.key_or_item(nxt):
            raise YamlSubsetError(f"{self.where(nxt)}: plain scalars over several lines are outside the subset")
        return resolve_plain(plain), i + 1

    def flow(self, text: str, j: int, where: str) -> Tuple[Any, int]:
        """A flow collection opening at text[j]; returns (value, index after it)."""
        close = "]" if text[j] == "[" else "}"
        items: list = []
        mapping = {} if close == "}" else None
        j += 1
        while True:
            while j < len(text) and text[j] == " ":
                j += 1
            if j >= len(text):
                raise YamlSubsetError(f"{where}: flow collections over several lines are outside the subset")
            if text[j] == close:
                return (mapping if mapping is not None else items), j + 1
            key, j = self.flow_node(text, j, where)
            while j < len(text) and text[j] == " ":
                j += 1
            if mapping is not None:
                if j >= len(text) or text[j] != ":":
                    raise YamlSubsetError(f"{where}: a flow mapping entry without ':'")
                value, j = self.flow_node(text, j + 1, where, allow_empty=True)
                mapping[key] = value
            else:
                items.append(key)
            while j < len(text) and text[j] == " ":
                j += 1
            if j < len(text) and text[j] == ",":
                j += 1
            elif j < len(text) and text[j] != close:
                raise YamlSubsetError(f"{where}: unexpected {text[j]!r} in a flow collection")

    def flow_node(self, text: str, j: int, where: str, allow_empty: bool = False) -> Tuple[Any, int]:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise YamlSubsetError(f"{where}: flow collections over several lines are outside the subset")
        c = text[j]
        if c in "[{":
            return self.flow(text, j, where)
        if c in "\"'":
            k = j + 1
            while k < len(text):
                if c == "'" and text[k] == "'":
                    if k + 1 < len(text) and text[k + 1] == "'":
                        k += 2
                        continue
                    break
                if c == '"' and text[k] == "\\":
                    k += 2
                    continue
                if c == '"' and text[k] == '"':
                    break
                k += 1
            if k >= len(text):
                raise YamlSubsetError(f"{where}: quoted scalars over several lines inside a flow collection")
            raw = text[j + 1:k]
            return (raw.replace("''", "'") if c == "'" else _unescape_double(raw, where)), k + 1
        if c in "&*!|>%@`":
            raise YamlSubsetError(f"{where}: {c!r} is outside the subset")
        m = re.match(r"(?:[^,\[\]{}:#]|:(?=[^\s,\[\]{}])|#(?<!\s#))*", text[j:])
        plain = m.group(0).rstrip()
        if not plain and not allow_empty:
            raise YamlSubsetError(f"{where}: an empty entry in a flow collection")
        return resolve_plain(plain), j + len(m.group(0))

    # ---------------------------------------------------------------- blocks
    def key_or_item(self, i: int) -> bool:
        text = self.content(i)[1]
        return text == "-" or text.startswith("- ") or self.split_key(text) is not None

    @staticmethod
    def split_key(text: str):
        """(key text, column of the value) if the line opens a mapping entry, else None."""
        if text[0] in "\"'":
            q = text[0]
            k = 1
            while k < len(text) and (text[k] != q or (q == "'" and text[k + 1:k + 2] == "'")):
                k += 2 if q == "'" and text[k] == "'" else 1
            if text[k + 1:k + 2] == ":" and (k + 2 == len(text) or text[k + 2] == " "):
                return text[:k + 1], k + 2
            return None
        if text[0] in "[{-?&*!|>%@`#":
            if not (text[0] == "-" and len(text) > 1 and text[1] not in " "):
                return None
        m = re.match(r"([^#]*?)\s*:(?: |$)", text)
        return None if m is None else (m.group(1), m.end())

    def key_value(self, key_text: str, i: int) -> Any:
        if key_text[0] == "'":
            return key_text[1:-1].replace("''", "'")
        if key_text[0] == '"':
            return _unescape_double(key_text[1:-1], self.where(i))
        return resolve_plain(key_text)

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        """The block node whose first line i is at ``indent``."""
        text = self.content(i)[1]
        if text == "-" or text.startswith("- "):
            return self.sequence(i, indent)
        if self.split_key(text) is not None:
            return self.mapping(i, indent)
        self.indent_of_node = indent
        return self.inline(i, indent)

    def nested(self, i: int, parent_indent: int, allow_sequence_at_parent: bool) -> Tuple[Any, int]:
        """The value of an entry whose line ends after its indicator: the block on the
        following lines if indented deeper (a sequence may also sit at the parent's
        indentation), else null."""
        nxt = self.next_content(i + 1)
        if nxt < len(self.lines):
            ind, text = self.content(nxt)
            if ind > parent_indent or (allow_sequence_at_parent and ind == parent_indent
                                       and (text == "-" or text.startswith("- "))):
                return self.block(nxt, ind)
        return None, i + 1

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while True:
            i = self.next_content(i)
            if i >= len(self.lines):
                return out, i
            ind, text = self.content(i)
            if ind < indent:
                return out, i
            if ind > indent:
                raise YamlSubsetError(f"{self.where(i)}: unexpected indentation")
            split = self.split_key(text)
            if split is None:
                if text == "-" or text.startswith("- "):
                    return out, i
                raise YamlSubsetError(f"{self.where(i)}: expected 'key: value', got {text!r}")
            key_text, value_col = split
            key = self.key_value(key_text, i)
            rest = text[value_col:]
            if rest.strip() == "" or rest.strip().startswith("#"):
                out[key], i = self.nested(i, indent, allow_sequence_at_parent=True)
            else:
                col = indent + value_col + len(rest) - len(rest.lstrip(" "))
                self.indent_of_node = indent
                out[key], i = self.inline(i, col)

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out: list = []
        while True:
            i = self.next_content(i)
            if i >= len(self.lines):
                return out, i
            ind, text = self.content(i)
            if ind < indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlSubsetError(f"{self.where(i)}: unexpected indentation")
                return out, i
            if ind > indent:
                raise YamlSubsetError(f"{self.where(i)}: unexpected indentation")
            rest = text[1:]
            if rest.strip() == "" or rest.strip().startswith("#"):
                value, i = self.nested(i, indent, allow_sequence_at_parent=False)
            else:
                col = indent + 1 + len(rest) - len(rest.lstrip(" "))
                # The item's text as a line of its own at its column: a mapping opened
                # on the dash line continues on the lines indented to that column.
                self.lines[i] = " " * col + self.lines[i][col:]
                value, i = self.block(i, col)
            out.append(value)

    def document(self) -> Any:
        i = self.next_content(0)
        if i >= len(self.lines):
            return None
        ind, _ = self.content(i)
        value, i = self.block(i, ind)
        i = self.next_content(i)
        if i < len(self.lines):
            raise YamlSubsetError(f"{self.where(i)}: unexpected {self.content(i)[1]!r}")
        return value


def loads(text: str, name: str = "<string>") -> Any:
    """Parse one YAML document of the subset."""
    return _Parser(text, name).document()


def load_file(path) -> Any:
    with open(path) as f:
        return loads(f.read(), str(path))
