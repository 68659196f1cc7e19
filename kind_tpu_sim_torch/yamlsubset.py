"""A reader and a writer for the YAML the kube manifests use.

The machine with the card has no PyYAML, so the port reads and writes
the manifests in ``pods/`` itself:

* :func:`load_all` reads a (possibly multi-document) stream as
  ``yaml.safe_load_all`` does, for block mappings and sequences, plain
  and quoted scalars, flow sequences, the literal ``|`` and folded
  ``>`` block scalars, comments, ``---`` between documents and ``...``
  ending one (content after it needs a ``---`` first). Plain
  scalars are typed by the YAML 1.1 rules ``yaml.SafeLoader`` applies
  (ints, floats, bools, null; everything else a string). Anything else
  (anchors, aliases, tags, directives, flow mappings other than ``{}``,
  complex keys, multi-line plain or quoted scalars, timestamps, an
  indicator out of place) raises ``ValueError`` naming the line: never a
  silent misparse.
* :func:`dump` writes one document as ``yaml.safe_dump(doc,
  sort_keys=False)`` does: block style, sequences in a mapping not
  indented, strings plain where they read back as the same string and
  single-quoted otherwise (``'4'``), long values wrapped at spaces past
  column 80. A string with line breaks is written as a literal block
  (``|``, with yaml's indentation and chomping indicators: ``|2`` for
  text that starts with a space or a break, ``|-`` for text without a
  final break, ``|+`` for text ending in two), as the dumper of
  ``kind_tpu_sim/manifests.py`` does (``yaml.safe_dump`` would fold it
  into a quoted scalar). It
  takes dicts (whose keys are simple: scalars, and strings of 1-127
  characters), lists, strings of printable ASCII (and line breaks in a
  literal block), ints, bools and None, and raises ``ValueError`` on
  anything else, such as a float or a string it would have to
  double-quote.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

# -- typing plain scalars (yaml.resolver.Resolver's implicit rules) ----

_IMPLICIT = (
    ("bool", "yYnNtTfFoO", re.compile(
        r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
        r"|on|On|ON|off|Off|OFF)$")),
    ("float", "-+0123456789.", re.compile(
        r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
        r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
        r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
        r"|[-+]?\.(?:inf|Inf|INF)"
        r"|\.(?:nan|NaN|NAN))$")),
    ("int", "-+0123456789", re.compile(
        r"^(?:[-+]?0b[0-1_]+"
        r"|[-+]?0[0-7_]+"
        r"|[-+]?(?:0|[1-9][0-9_]*)"
        r"|[-+]?0x[0-9a-fA-F_]+"
        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")),
    ("merge", "<", re.compile(r"^(?:<<)$")),
    ("null", "~nN", re.compile(r"^(?:~|null|Null|NULL|)$")),
    ("timestamp", "0123456789", re.compile(
        r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
        r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")),
    ("value", "=", re.compile(r"^(?:=)$")),
)


def _kind(text: str) -> str:
    """The type a plain scalar ``text`` resolves to."""
    first = text[:1]
    for kind, starts, pattern in _IMPLICIT:
        if (first in starts or (kind == "null" and not text)) \
                and pattern.match(text):
            return kind
    return "str"


def _sexagesimal(text: str, cast) -> object:
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def _typed(text: str, where: str) -> object:
    """A plain scalar's value, as yaml.SafeLoader constructs it."""
    kind = _kind(text)
    if kind == "str":
        return text
    if kind == "null":
        return None
    if kind == "bool":
        return text.lower() in ("yes", "true", "on")
    if kind == "int":
        body = text.replace("_", "")
        sign = -1 if body[0] == "-" else 1
        if body[0] in "+-":
            body = body[1:]
        if body == "0":
            return 0
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body[0] == "0":
            return sign * int(body, 8)
        if ":" in body:
            return sign * _sexagesimal(body, int)
        return sign * int(body)
    if kind == "float":
        body = text.replace("_", "").lower()
        sign = -1.0 if body[0] == "-" else 1.0
        if body[0] in "+-":
            body = body[1:]
        if body == ".inf":
            return sign * math.inf
        if body == ".nan":
            return math.nan
        if ":" in body:
            return sign * _sexagesimal(body, float)
        return sign * float(body)
    raise ValueError(f"{where}: {text!r} resolves to a YAML {kind}, "
                     "which this reader does not construct")


# -- the reader ---------------------------------------------------------

_BREAK_FREE = " \t"


class _Line:
    __slots__ = ("no", "indent", "text", "raw", "has_break")

    def __init__(self, no: int, indent: int, text: str, raw: str,
                 has_break: bool = True):
        self.no = no          # 1-based line number in the stream
        self.indent = indent  # column of the first character of text
        self.text = text      # the line from `indent` on
        self.raw = raw        # the whole line
        self.has_break = has_break  # a line break ends it


def _blank(text: str) -> bool:
    stripped = text.lstrip(" ")
    return not stripped or stripped.startswith("#")


def _quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]`` and the index just
    past its closing quote. It must close on this line."""
    quote = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            i += 1
            esc = text[i:i + 1]
            simple = {"0": "\0", "a": "\a", "b": "\b", "t": "\t",
                      "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
                      "r": "\r", "e": "\x1b", " ": " ", '"': '"',
                      "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
                      "L": "\u2028", "P": "\u2029"}
            if esc in simple:
                out.append(simple[esc])
                i += 1
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(esc)
            digits = text[i + 1:i + 1 + (width or 0)]
            if width is None or len(digits) != width or not all(
                    c in "0123456789abcdefABCDEF" for c in digits):
                raise ValueError(f"{where}: bad escape in a "
                                 "double-quoted scalar")
            out.append(chr(int(digits, 16)))
            i += 1 + width
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"{where}: a quoted scalar that does not close on "
                     "its line is not supported")


def _rest_is_comment(text: str, pos: int, where: str) -> None:
    rest = text[pos:]
    if rest.strip(" ") and not (rest.lstrip(" ").startswith("#")
                                and rest[:1] in ("", " ")):
        raise ValueError(f"{where}: unexpected {rest.strip()!r} after "
                         "a complete value")


def _plain_end(text: str, pos: int, flow: bool) -> int:
    """Where the plain scalar starting at ``pos`` ends: at a comment,
    at a ': ' (a mapping indicator), and in a flow collection at ',',
    '[', ']', '{' or '}'."""
    i = pos
    while i < len(text):
        ch = text[i]
        nxt = text[i + 1:i + 2]
        if ch == "#" and i > pos and text[i - 1] in _BREAK_FREE:
            break
        if ch == ":" and (nxt in ("", " ", "\t")
                          or (flow and nxt in ",[]{}")):
            break
        if flow and ch in ",[]{}":
            break
        i += 1
    return i


# a plain scalar may not start with these: anchors, aliases, tags,
# directives, reserved indicators and flow indicators out of place
_RESERVED_START = "&*!%@`,]}"


def _flow_seq(text: str, pos: int, where: str) -> Tuple[list, int]:
    """The flow sequence starting at ``text[pos] == '['`` and the index
    past its ']'; it must close on this line."""
    out: list = []
    i = pos + 1
    while True:
        while i < len(text) and text[i] in _BREAK_FREE:
            i += 1
        if i >= len(text):
            raise ValueError(f"{where}: a flow sequence that does not "
                             "close on its line is not supported")
        ch = text[i]
        if ch == "]":
            return out, i + 1
        if ch == "[":
            item, i = _flow_seq(text, i, where)
        elif ch == "{":
            if text[i:i + 2] != "{}":
                raise ValueError(f"{where}: flow mappings are not "
                                 "supported")
            item, i = {}, i + 2
        elif ch in "'\"":
            item, i = _quoted(text, i, where)
        elif ch in _RESERVED_START or ch == "#" or ch in ",}":
            raise ValueError(f"{where}: {ch!r} in a flow sequence is not "
                             "supported")
        else:
            if ch in "-?:" and text[i + 1:i + 2] in ("", " ", ",", "]"):
                raise ValueError(f"{where}: {ch!r} indicator in a flow "
                                 "sequence is not supported")
            end = _plain_end(text, i, flow=True)
            item = _typed(text[i:end].rstrip(" \t"), where)
            i = end
        while i < len(text) and text[i] in _BREAK_FREE:
            i += 1
        if text[i:i + 1] == ":":
            raise ValueError(f"{where}: a mapping inside a flow sequence "
                             "is not supported")
        out.append(item)
        if text[i:i + 1] == ",":
            i += 1
        elif text[i:i + 1] != "]":
            raise ValueError(f"{where}: expected ',' or ']' in a flow "
                             "sequence")


def _key_split(text: str, where: str) -> Optional[Tuple[object, str]]:
    """(key, the text after its ':') when ``text`` opens a mapping
    entry, else None."""
    if text[:1] in "'\"":
        key, end = _quoted(text, 0, where)
        j = end
        while j < len(text) and text[j] in _BREAK_FREE:
            j += 1
        if text[j:j + 1] == ":" and text[j + 1:j + 2] in ("", " ", "\t"):
            return key, text[j + 1:]
        return None
    if text[:1] in "[{":
        return None
    if text[:1] == "?" and text[1:2] in ("", " "):
        raise ValueError(f"{where}: complex keys ('? ') are not "
                         "supported")
    end = _plain_end(text, 0, flow=False)
    if end < len(text) and text[end] == ":":
        raw = text[:end].rstrip(" \t")
        if raw[:1] in _RESERVED_START:
            raise ValueError(f"{where}: {raw[:1]!r} (anchor, alias, tag "
                             "or reserved indicator) is not supported")
        if not raw:
            raise ValueError(f"{where}: an empty key is not supported")
        return _typed(raw, where), text[end + 1:]
    return None


class _Reader:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def where(self, line: _Line) -> str:
        return f"line {line.no}"

    def peek(self) -> Optional[_Line]:
        """The next line that holds content, skipping blank and comment
        lines."""
        while self.i < len(self.lines) and _blank(self.lines[self.i].raw):
            self.i += 1
        if self.i == len(self.lines):
            return None
        line = self.lines[self.i]
        if line.text.startswith("\t"):
            raise ValueError(f"line {line.no}: a tab in the indentation")
        return line

    def block(self, indent: int) -> object:
        line = self.peek()
        if line.text.startswith("-") and line.text[1:2] in ("", " "):
            return self.sequence(indent)
        if _key_split(line.text, self.where(line)) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(line, line.text, indent)

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            where = self.where(line)
            if line.indent > indent:
                raise ValueError(f"{where}: unexpected indentation")
            split = _key_split(line.text, where)
            if split is None:
                if line.text.startswith("-"):
                    raise ValueError(f"{where}: a sequence entry where a "
                                     "mapping key was expected")
                raise ValueError(f"{where}: expected a mapping key")
            key, rest = split
            if isinstance(key, (dict, list)):
                raise ValueError(f"{where}: unhashable key")
            self.i += 1
            col = line.indent + len(line.text) - len(rest)
            out[key] = self.value(line, rest, col, indent, mapping=True)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            where = self.where(line)
            if line.indent > indent:
                raise ValueError(f"{where}: unexpected indentation")
            if not (line.text.startswith("-")
                    and line.text[1:2] in ("", " ")):
                return out
            rest = line.text[1:]
            stripped = rest.lstrip(" ")
            col = line.indent + 1 + len(rest) - len(stripped)
            if stripped and not stripped.startswith("#") and (
                    (stripped.startswith("-")
                     and stripped[1:2] in ("", " "))
                    or _key_split(stripped, where) is not None):
                # a collection opening on the dash's line: read it as if
                # its first line started at `col`
                self.lines[self.i] = _Line(line.no, col, stripped,
                                           " " * col + stripped,
                                           line.has_break)
                out.append(self.block(col))
                continue
            self.i += 1
            out.append(self.value(line, rest, col, indent,
                                  mapping=False))

    def value(self, line: _Line, rest: str, col: int, indent: int,
              mapping: bool) -> object:
        """The value after ``key:`` or ``-`` on ``line``; ``rest`` is
        the line past the indicator, starting at column ``col``."""
        stripped = rest.lstrip(" \t")
        if not stripped or stripped.startswith("#"):
            nxt = self.peek()
            if nxt is not None and nxt.indent > indent:
                return self.block(nxt.indent)
            if (mapping and nxt is not None and nxt.indent == indent
                    and nxt.text.startswith("-")
                    and nxt.text[1:2] in ("", " ")):
                return self.sequence(indent)  # indentless sequence
            return None
        return self.inline(line, stripped, indent)

    def inline(self, line: _Line, text: str, indent: int) -> object:
        """A value that starts on ``line`` (``text`` from its first
        character); block scalars read the lines under it."""
        where = self.where(line)
        ch = text[0]
        if ch in "|>":
            return self.block_scalar(line, text, indent)
        if ch in _RESERVED_START:
            raise ValueError(f"{where}: {ch!r} (anchor, alias, tag or "
                             "reserved indicator) is not supported")
        if ch in "-?:" and text[1:2] in ("", " ", "\t"):
            raise ValueError(f"{where}: a {ch!r} indicator is not allowed "
                             "here")
        if ch == "[":
            value, end = _flow_seq(text, 0, where)
            _rest_is_comment(text, end, where)
        elif ch == "{":
            if not text.startswith("{}"):
                raise ValueError(f"{where}: flow mappings are not "
                                 "supported")
            value = {}
            _rest_is_comment(text, 2, where)
        elif ch in "'\"":
            value, end = _quoted(text, 0, where)
            _rest_is_comment(text, end, where)
        else:
            end = _plain_end(text, 0, flow=False)
            if end < len(text) and text[end] == ":":
                raise ValueError(f"{where}: a mapping value is not "
                                 "allowed here")
            value = _typed(text[:end].rstrip(" \t"), where)
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise ValueError(f"line {nxt.no}: a scalar continued on the "
                             "next line is not supported")
        return value

    def block_scalar(self, line: _Line, text: str, indent: int) -> str:
        """A literal or folded block scalar whose header is ``text``:
        yaml's scan_block_scalar, over the raw lines under the header."""
        where = self.where(line)
        folded = text[0] == ">"
        chomping: Optional[bool] = None
        increment: Optional[int] = None
        i = 1
        for _ in range(2):
            ch = text[i:i + 1]
            if ch in ("+", "-") and chomping is None:
                chomping = ch == "+"
                i += 1
            elif ch.isdigit() and increment is None:
                if ch == "0":
                    raise ValueError(f"{where}: indentation indicator 0")
                increment = int(ch)
                i += 1
        _rest_is_comment(text, i, where)
        under = self.lines[self.i:]
        raws = [ln.raw for ln in under]

        def lead(raw: str) -> int:
            return len(raw) - len(raw.lstrip(" "))

        min_indent = max(indent + 1, 1)
        j = 0
        breaks: List[str] = []
        if increment is None:
            # leading blank lines, then the first text line's column
            widest = 0
            while j < len(raws) and not raws[j].strip(" "):
                widest = max(widest, len(raws[j]))
                breaks.append("\n")
                j += 1
            first = lead(raws[j]) if j < len(raws) else 0
            if j < len(raws) and widest > first:
                raise ValueError(f"{where}: a leading blank line indented "
                                 "past the block scalar's text")
            block_indent = max(min_indent, first)
        else:
            block_indent = min_indent + increment - 1

        def blank(raw: str) -> bool:
            return not raw.strip(" ") and len(raw) <= block_indent

        def text_line(raw: str) -> bool:
            return not blank(raw) and (not raw.strip(" ")
                                       or lead(raw) >= block_indent)

        while j < len(raws) and blank(raws[j]):
            breaks.append("\n")
            j += 1
        chunks: List[str] = []
        line_break = ""
        while j < len(raws) and text_line(raws[j]):
            chunks.extend(breaks)
            content = raws[j][block_indent:]
            leading_non_space = content[:1] not in (" ", "\t")
            chunks.append(content)
            line_break = "\n" if under[j].has_break else ""
            j += 1
            breaks = []
            while j < len(raws) and blank(raws[j]):
                breaks.append("\n")
                j += 1
            if j < len(raws) and text_line(raws[j]):
                if (folded and line_break == "\n" and leading_non_space
                        and raws[j][block_indent:][:1] not in (" ", "\t")):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        self.i += j
        return "".join(chunks)


def _document_lines(text: str) -> List[List[_Line]]:
    """The stream split at ``---`` and ``...`` lines, each document's
    lines."""
    text = text.replace("\r\n", "\n")
    if "\r" in text:
        raise ValueError("a bare carriage return is not supported")
    raws = text.split("\n")
    if text.endswith("\n"):
        raws.pop()
    docs: List[List[_Line]] = [[]]
    # documents that count only if they hold content: what stands
    # before the first '---', and what follows a '...' (which may hold
    # nothing but blank lines and comments)
    implicit = {0}
    ended = False
    opened = False
    for no, raw in enumerate(raws, start=1):
        if raw.startswith("---") and raw[3:4] in ("", " ", "\t"):
            tail = raw[3:].strip()
            if tail and not tail.startswith("#"):
                raise ValueError(f"line {no}: content after '---' is not "
                                 "supported")
            if not opened:
                opened = True
            elif ended:
                docs.pop()
                implicit.discard(len(docs))
            ended = False
            docs.append([])
            continue
        if raw.startswith("...") and raw[3:4] in ("", " ", "\t"):
            tail = raw[3:].strip()
            if tail and not tail.startswith("#"):
                raise ValueError(f"line {no}: content after '...' is not "
                                 "supported")
            opened = ended = True
            docs.append([])
            implicit.add(len(docs) - 1)
            continue
        if raw.startswith("%"):
            raise ValueError(f"line {no}: directives are not supported")
        if ended and not _blank(raw):
            raise ValueError(f"line {no}: content after '...' needs a "
                             "'---' first")
        stripped = raw.lstrip(" ")
        docs[-1].append(_Line(no, len(raw) - len(stripped), stripped, raw,
                              has_break=no < len(raws)
                              or text.endswith("\n")))
    if opened:
        docs = [d for i, d in enumerate(docs)
                if i not in implicit or not all(_blank(ln.raw) for ln in d)]
    return docs


def load_all(text: str) -> list:
    """Every document of ``text``, typed as ``yaml.safe_load_all``
    types them (an empty document is None)."""
    out = []
    for lines in _document_lines(text):
        reader = _Reader(lines)
        line = reader.peek()
        if line is None:
            out.append(None)
            continue
        doc = reader.block(line.indent)
        rest = reader.peek()
        if rest is not None:
            raise ValueError(f"line {rest.no}: content after the end of "
                             "the document's root node")
        out.append(doc)
    return out


# -- the writer ---------------------------------------------------------

_WIDTH = 80


def _plain_ok(text: str) -> bool:
    """Whether yaml's emitter writes ``text`` as a plain scalar in block
    context (its analyze_scalar, for printable ASCII without breaks)."""
    if not text or _kind(text) != "str":
        return False
    if text.startswith(("---", "...")):
        return False
    if text[0] == " " or text[-1] == " ":
        return False
    for i, ch in enumerate(text):
        followed = i + 1 >= len(text) or text[i + 1] == " "
        preceded = i == 0 or text[i - 1] == " "
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                return False
            if ch in "?:-" and followed:
                return False
        else:
            if ch == ":" and followed:
                return False
            if ch == "#" and preceded:
                return False
    return True


class _Writer:
    """Tracks the column as yaml's Emitter does, for scalar wrapping."""

    def __init__(self):
        self.parts: List[str] = []
        self.column = 0
        self.whitespace = True
        # a literal block ends its own last line
        self.line_start = False
        # yaml's open_ended: a ``|+`` block was the last thing written
        self.open_ended = False

    def write(self, text: str) -> None:
        self.parts.append(text)
        self.column += len(text)
        self.open_ended = False

    def newline(self, indent: int) -> None:
        self.parts.append(("" if self.line_start else "\n") + " " * indent)
        self.line_start = False
        self.column = indent
        self.whitespace = True

    def block(self, text: str, indent: int) -> None:
        """``text`` as yaml's write_literal writes it, its lines at
        ``indent``; only text yaml's analyze_scalar allows in a block
        (printable ASCII and breaks, no space before a break or at the
        end)."""
        if (not all(ch == "\n" or " " <= ch <= "~" for ch in text)
                or text.endswith(" ") or " \n" in text):
            raise ValueError(f"{text!r}: not written as a literal block")
        hints = "2" if text[0] in " \n" else ""
        if text[-1] != "\n":
            hints += "-"
        elif len(text) == 1 or text[-2] == "\n":
            hints += "+"
        self.write(("|" if self.whitespace else " |") + hints)
        lines = text.split("\n")
        if text.endswith("\n"):
            lines.pop()
        self.parts.append("".join(
            "\n" + (" " * indent + ln if ln else "") for ln in lines) + "\n")
        self.line_start = True
        self.open_ended = hints.endswith("+")
        self.column = 0
        self.whitespace = True

    def scalar(self, value, indent: int, simple_key: bool) -> None:
        """One scalar after an indicator (``-``, ``:``) or at a line's
        start; continuation lines of a wrapped value start at
        ``indent``."""
        if value is None:
            text, style = "null", ""
        elif isinstance(value, bool):
            text, style = ("true" if value else "false"), ""
        elif isinstance(value, int):
            text, style = str(value), ""
        elif isinstance(value, str):
            if "\n" in value and not simple_key:
                self.block(value, indent)
                return
            if not all(" " <= ch <= "~" for ch in value):
                raise ValueError(f"{value!r}: only printable ASCII strings "
                                 "are written")
            if simple_key and (not value or len(value) >= 128):
                raise ValueError(f"{value!r}: not a simple key")
            text = value
            style = "" if _plain_ok(value) else "'"
        else:
            raise ValueError(f"cannot write {type(value).__name__} "
                             f"{value!r}")
        split = not simple_key
        if style == "":
            if not self.whitespace:
                self.write(" ")
            self.whitespace = False
            self._words(text, indent, split, quoted=False)
        else:
            self.write("'" if self.whitespace else " '")
            self.whitespace = False
            self._words(text, indent, split, quoted=True)
            self.write("'")

    def _words(self, text: str, indent: int, split: bool,
               quoted: bool) -> None:
        """yaml's write_plain / write_single_quoted for text without
        line breaks: a lone space past the width becomes a line break."""
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split
                            and (not quoted
                                 or (start != 0 and end != len(text)))):
                        self.newline(indent)
                        self.whitespace = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " " or (quoted and ch == "'"):
                if start < end:
                    self.write(text[start:end])
                    start = end
            if quoted and ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
            end += 1

    def node(self, value, indent: int, in_mapping: bool) -> None:
        """A value after ``key:`` (in_mapping) or ``-``."""
        if isinstance(value, dict) and value:
            self.mapping(value, indent + 2, first_inline=not in_mapping)
        elif isinstance(value, list) and value:
            if not in_mapping:
                raise ValueError("nested sequences are not written")
            self.sequence(value, indent)
        elif isinstance(value, (dict, list)):
            self.write(" {}" if isinstance(value, dict) else " []")
            self.whitespace = False
        else:
            self.scalar(value, indent + 2, simple_key=False)

    def mapping(self, value: dict, indent: int, first_inline: bool) -> None:
        for n, (key, item) in enumerate(value.items()):
            if n or not first_inline:
                if self.parts:
                    self.newline(indent)
                else:
                    self.write(" " * indent)
            else:
                self.write(" ")
                self.whitespace = True
            if isinstance(key, (dict, list)):
                raise ValueError("collection keys are not written")
            self.scalar(key, indent + 2, simple_key=True)
            self.write(":")
            self.whitespace = False
            self.node(item, indent, in_mapping=True)

    def sequence(self, value: list, indent: int) -> None:
        for item in value:
            if self.parts:
                self.newline(indent)
            else:
                self.write(" " * indent)
            self.write("-")
            self.whitespace = False
            self.node(item, indent, in_mapping=False)


def dump(doc) -> str:
    """``doc`` as ``yaml.safe_dump(doc, sort_keys=False)`` writes it,
    strings with line breaks as literal blocks."""
    if not isinstance(doc, (dict, list)) or not doc:
        raise ValueError("only a non-empty mapping or sequence is written")
    writer = _Writer()
    if isinstance(doc, dict):
        writer.mapping(doc, 0, first_inline=False)
    else:
        writer.sequence(doc, 0)
    end = "...\n" if writer.open_ended else ""
    return "".join(writer.parts) + ("" if writer.line_start else "\n") + end
