"""Reader and writer for the flat YAML subset of the recovery manifests.

The pipeline's manifests (``recoveries.py``, the tiling manifest, the
continue file) are block-style YAML of one shape: a mapping whose values are
a scalar (string, int, float, bool, ``null``), a list of scalars, or one
mapping of scalars -- or, for the continue file, a top-level list of scalars.
This module reads and writes exactly that subset without PyYAML, and
interoperates with it: what :func:`dumps` writes, ``yaml.safe_load`` reads to
the same object, and what ``yaml.safe_dump`` writes for these shapes
(including its quoting, its ``1.0e-05`` floats and its folding of long
scalars at 80 columns), :func:`loads` reads to the same object.

Scalars resolve as PyYAML's YAML 1.1 resolvers do (``1e-05`` without a dot is
a string there, ``yes``/``off`` are booleans).  Anything outside the subset
(flow collections other than ``[]``/``{}``, anchors, tags, block scalars,
deeper nesting) raises :class:`FlatYamlError`.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Tuple

Scalar = Any


class FlatYamlError(ValueError):
    """The text is not in the supported subset (or not valid YAML)."""


_BOOLS = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
          "NO": False, "true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False, "on": True,
          "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULLS = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# forms PyYAML resolves to something this subset does not carry (octal, hex,
# binary and sexagesimal numbers, timestamps, merge keys): refuse, never
# hand back a string where PyYAML would hand back a number
_OTHER_RESOLVED = re.compile(
    r"^(?:[-+]?0b[01_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?|<<|=)$")
# a string written plain: path-like, so no resolver can take it for a number,
# a boolean, null or a timestamp, and no indicator character occurs in it
_PLAIN_PATH = re.compile(r"^[A-Za-z0-9_./-]+(?: [A-Za-z0-9_./-]+)*$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


# --- writer ------------------------------------------------------------------

def _dump_scalar(value: Scalar) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text and "e" in text:   # 1e-05 -> 1.0e-05 (a float to
            text = text.replace("e", ".0e")   # YAML 1.1 only with the dot)
        return text
    if isinstance(value, str):
        if "/" in value and _PLAIN_PATH.match(value) and value[0] != "-":
            return value
        return json.dumps(value, ensure_ascii=False)
    raise FlatYamlError(f"unsupported scalar {type(value).__name__}")


def _dump_list(items, out: List[str]) -> None:
    for item in items:
        if isinstance(item, (list, tuple, dict)):
            raise FlatYamlError("lists hold scalars only")
        out.append(f"- {_dump_scalar(item)}")


def dumps(data: Any) -> str:
    """Serialize a manifest (mapping, or list of scalars), keys sorted."""
    out: List[str] = []
    if isinstance(data, (list, tuple)):
        if not data:
            return "[]\n"
        _dump_list(data, out)
    elif isinstance(data, dict):
        if not data:
            return "{}\n"
        for key in sorted(data):
            value = data[key]
            k = _dump_scalar(key)
            if isinstance(value, (list, tuple)):
                if value:
                    out.append(f"{k}:")
                    _dump_list(value, out)
                else:
                    out.append(f"{k}: []")
            elif isinstance(value, dict):
                if not value:
                    out.append(f"{k}: {{}}")
                    continue
                out.append(f"{k}:")
                for sub in sorted(value):
                    if isinstance(value[sub], (list, tuple, dict)):
                        raise FlatYamlError("nested mappings hold scalars only")
                    out.append(f"  {_dump_scalar(sub)}: "
                               f"{_dump_scalar(value[sub])}")
            else:
                out.append(f"{k}: {_dump_scalar(value)}")
    else:
        raise FlatYamlError("a manifest is a mapping or a list")
    return "\n".join(out) + "\n"


def dump(data: Any, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dumps(data))


# --- reader ------------------------------------------------------------------

def _resolve_plain(text: str) -> Scalar:
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER_RESOLVED.match(text):
        raise FlatYamlError(f"unsupported scalar form: {text!r}")
    if text[0] in "[]{}&*!|>%@`\"'" or (text[0] in "-?:," and
                                        (len(text) == 1 or text[1] == " ")):
        raise FlatYamlError(f"unsupported syntax: {text!r}")
    return text


def _fold(lines: List[str]) -> str:
    """YAML line folding: a single break becomes a space, each further
    (empty) line a newline."""
    out = lines[0]
    pending = 0
    for line in lines[1:]:
        if line == "":
            pending += 1
            continue
        out += "\n" * pending if pending else " "
        pending = 0
        out += line
    return out + "\n" * pending


def _unescape_double(body: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        i += 1
        if i >= len(body):
            raise FlatYamlError("dangling escape")
        code = body[i]
        i += 1
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
        elif code in _HEX:
            digits = body[i:i + _HEX[code]]
            if len(digits) != _HEX[code]:
                raise FlatYamlError("short hex escape")
            out.append(chr(int(digits, 16)))
            i += _HEX[code]
        else:
            raise FlatYamlError(f"unknown escape \\{code}")
    return "".join(out)


def _quoted(first: str, more: List[str], pos: int) -> Tuple[str, str, int]:
    """Parse a quoted scalar that starts at ``first[0]`` and may continue on
    the lines ``more[pos:]``.  Returns (value, rest of the last line, new
    pos)."""
    quote = first[0]
    pieces: List[str] = []       # raw text per physical line
    line = first[1:]
    while True:
        i = 0
        end = -1
        while i < len(line):
            if quote == '"' and line[i] == "\\":
                i += 2
                continue
            if line[i] == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                end = i
                break
            i += 1
        if end >= 0:
            pieces.append(line[:end])
            rest = line[end + 1:]
            break
        pieces.append(line)
        if pos >= len(more):
            raise FlatYamlError("unterminated quoted scalar")
        line = more[pos].strip(" ")
        pos += 1
    if quote == "'":
        text = _fold([pieces[0].rstrip(" ") if len(pieces) > 1 else pieces[0]]
                     + [p.strip(" ") for p in pieces[1:-1]]
                     + ([pieces[-1].lstrip(" ")] if len(pieces) > 1 else []))
        return text.replace("''", "'"), rest, pos
    # double-quoted: a line that ends in an unescaped backslash joins the
    # next one without a space; otherwise the break folds
    text = pieces[0]
    pending = 0
    for k in range(1, len(pieces)):
        piece = pieces[k].lstrip(" ")
        if piece == "" and k < len(pieces) - 1:
            pending += 1
            continue
        n_bs = len(text) - len(text.rstrip("\\"))
        if n_bs % 2 == 1 and not pending:
            text = text[:-1] + piece
        else:
            text = text.rstrip(" ") + ("\n" * pending if pending else " ") + piece
        pending = 0
    return _unescape_double(text), rest, pos


def _strip_comment(text: str) -> str:
    if text.startswith("#"):
        return ""
    idx = text.find(" #")
    return text if idx < 0 else text[:idx]


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _scalar(text: str, lines: List[str], pos: int, indent: int
            ) -> Tuple[Scalar, int]:
    """Parse the scalar that starts with ``text`` (already stripped) on the
    line before ``lines[pos]``; continuation lines are those indented deeper
    than ``indent``."""
    if text[:1] in "\"'":
        value, rest, pos = _quoted(text, lines, pos)
        if _strip_comment(rest.strip(" ")):
            raise FlatYamlError(f"trailing text after quoted scalar: {rest!r}")
        return value, pos
    if text in ("[]", "{}"):
        raise FlatYamlError("empty collection where a scalar is expected")
    parts = [_strip_comment(text).rstrip(" ")]
    while pos < len(lines):
        nxt = lines[pos]
        if nxt.strip(" ") == "":
            # blank lines inside a folded plain scalar
            look = pos
            while look < len(lines) and lines[look].strip(" ") == "":
                look += 1
            if look < len(lines) and _indent(lines[look]) > indent:
                parts.extend([""] * (look - pos))
                pos = look
                continue
            break
        if _indent(nxt) <= indent:
            break
        parts.append(nxt.strip(" "))
        pos += 1
    return _resolve_plain(_fold(parts)), pos


def _split_key(text: str, lines: List[str], pos: int
               ) -> Tuple[Scalar, str, int]:
    """``key: rest`` -> (key, rest, pos)."""
    if text[:1] in "\"'":
        key, rest, pos = _quoted(text, lines, pos)
        rest = rest.lstrip(" ")
        if not rest.startswith(":"):
            raise FlatYamlError(f"expected ':' after key {key!r}")
        return key, rest[1:].strip(" "), pos
    m = re.match(r"^(.*?):(?: +(.*))?$", text)
    if not m or not m.group(1):
        raise FlatYamlError(f"expected 'key: value', got {text!r}")
    return _resolve_plain(m.group(1).rstrip(" ")), (m.group(2) or "").strip(" "), pos


def _is_item(stripped: str) -> bool:
    return stripped == "-" or stripped.startswith("- ")


def _read_list(lines: List[str], pos: int, indent: int
               ) -> Tuple[List[Scalar], int]:
    items: List[Scalar] = []
    while pos < len(lines):
        line = lines[pos]
        stripped = line.strip(" ")
        if stripped == "" or stripped.startswith("#"):
            pos += 1
            continue
        if _indent(line) != indent or not _is_item(stripped):
            break
        value, pos = _scalar(stripped[1:].strip(" "), lines, pos + 1, indent)
        items.append(value)
    return items, pos


def loads(text: str) -> Any:
    """Parse a manifest.  Empty text gives ``None`` (as ``yaml.safe_load``)."""
    lines = text.replace("\r\n", "\n").split("\n")
    if any("\t" in ln[:_indent(ln) + 1] for ln in lines):
        raise FlatYamlError("tab indentation")
    pos = 0
    while pos < len(lines) and (lines[pos].strip(" ") == ""
                                or lines[pos].lstrip(" ").startswith("#")
                                or lines[pos].rstrip(" ") == "---"):
        pos += 1
    if pos == len(lines):
        return None
    first = lines[pos].strip(" ")
    if first in ("[]", "{}"):
        if any(ln.strip(" ") and not ln.lstrip(" ").startswith("#")
               and ln.rstrip(" ") != "..." for ln in lines[pos + 1:]):
            raise FlatYamlError("text after an empty collection")
        return [] if first == "[]" else {}
    if _is_item(first):
        indent = _indent(lines[pos])
        items, pos = _read_list(lines, pos, indent)
        _expect_end(lines, pos)
        return items
    data: Dict[Any, Any] = {}
    while pos < len(lines):
        line = lines[pos]
        stripped = line.strip(" ")
        if stripped == "" or stripped.startswith("#"):
            pos += 1
            continue
        if line.rstrip(" ") == "...":
            pos += 1
            break
        if _indent(line) != 0:
            raise FlatYamlError(f"unexpected indentation: {line!r}")
        key, rest, pos = _split_key(stripped, lines, pos + 1)
        if key in data:
            raise FlatYamlError(f"duplicate key {key!r}")
        if _strip_comment(rest) != "":
            if rest == "[]":
                data[key] = []
            elif rest == "{}":
                data[key] = {}
            else:
                data[key], pos = _scalar(rest, lines, pos, 0)
            continue
        # value on the following lines: a list, a mapping, or null
        look = pos
        while look < len(lines) and (lines[look].strip(" ") == "" or
                                     lines[look].lstrip(" ").startswith("#")):
            look += 1
        if look == len(lines):
            data[key] = None
            pos = look
            continue
        nxt = lines[look]
        nind = _indent(nxt)
        if _is_item(nxt.strip(" ")):
            data[key], pos = _read_list(lines, look, nind)
        elif nind > 0:
            sub: Dict[Any, Any] = {}
            pos = look
            while pos < len(lines):
                sline = lines[pos]
                sstrip = sline.strip(" ")
                if sstrip == "" or sstrip.startswith("#"):
                    pos += 1
                    continue
                if _indent(sline) < nind:
                    break
                if _indent(sline) != nind:
                    raise FlatYamlError(f"unexpected indentation: {sline!r}")
                skey, srest, pos = _split_key(sstrip, lines, pos + 1)
                if _strip_comment(srest) == "":
                    # null, unless deeper lines follow (outside the subset)
                    if pos < len(lines) and lines[pos].strip(" ") and \
                            _indent(lines[pos]) > nind:
                        raise FlatYamlError("nesting deeper than one mapping")
                    sub[skey] = None
                elif srest in ("[]", "{}"):
                    raise FlatYamlError("nested mappings hold scalars only")
                else:
                    sub[skey], pos = _scalar(srest, lines, pos, nind)
            data[key] = sub
        else:
            data[key] = None
            pos = look
    _expect_end(lines, pos)
    return data


def _expect_end(lines: List[str], pos: int) -> None:
    for line in lines[pos:]:
        s = line.strip(" ")
        if s and not s.startswith("#") and line.rstrip(" ") != "...":
            raise FlatYamlError(f"unexpected text: {line!r}")


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as fh:
        return loads(fh.read())
