"""The YAML header of an Osmap map, without OpenCV or PyYAML.

os1 writes the header through OpenCV's ``cv::FileStorage`` (Osmap.cpp:
68-178), and so does the reference package when OpenCV is installed
(``os1_tpu/io/osmap_io.py::_write_yaml_header``); without OpenCV the
reference package writes ``yaml.safe_dump`` of the header dict instead.

:func:`write_header` writes FileStorage's layout::

    %YAML:1.0
    ---
    mappointsFile: "/maps/room.mappoints"
    keyframesFile: "/maps/room.keyframes"
    featuresFile: "/maps/room.features"
    nMappoints: 1952
    nKeyframes: 21
    nFeatures: 17421
    Options: 0
    cameraMatrices:
       - { fx:400., fy:400., cx:320., cy:240. }

with FileStorage's own string quoting, real format (an integral value as
``400.``, any other as ``%.17g``, infinities as ``.Inf``) and flow-map line
wrapping, as OpenCV 5 writes them. The one difference from OpenCV 5's file is
the directive line: OpenCV 5 writes ``%YAML 1.2``, this writes ``%YAML:1.0``
as OpenCV 3 and 4 (and so os1) write and read it; OpenCV 5 reads both.

:func:`read_header` reads that layout, with any of FileStorage's real formats
(``400.``, ``4.0000000000000000e+02``), and the plain-YAML layout of the
reference package's fallback. It returns the keys the reference package's
reader returns: the three file names (str), the four counts (int) and
``cameraMatrices`` (a list of {fx, fy, cx, cy} float dicts).
"""
from __future__ import annotations

import math

FILE_KEYS = ("mappointsFile", "keyframesFile", "featuresFile")
COUNT_KEYS = ("nMappoints", "nKeyframes", "nFeatures", "Options")
K_KEYS = ("fx", "fy", "cx", "cy")
WRAP_MARGIN = 71  # FileStorage starts a new line in a flow map past this column
_FLOW_INDENT = 7  # a wrapped flow map's continuation lines: "   - { " aligned
_BARE = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_ -()/+;")


def _real(v: float) -> str:
    """A double as FileStorage writes it."""
    if math.isnan(v):
        return ".Nan"
    if math.isinf(v):
        return ".Inf" if v > 0 else "-.Inf"
    if -2**31 <= v < 2**31 and v == int(v):  # cvRound(v) == v
        return f"{int(v)}."
    return "%.17g" % v


def _string(s: str) -> str:
    """A string as FileStorage writes it: bare when it is plain, else in
    double quotes with backslash escapes."""
    if len(s) > 1 and s[0] == s[-1] and s[0] in "\"'":
        return s  # already quoted: written as it is
    quote = not s or s[0] == " " or s[0] in "0123456789+-." or any(c not in _BARE for c in s)
    out = []
    for c in s:
        if c in "\\'\"":
            out.append("\\" + c)
        elif c in "\n\r\t":
            out.append({"\n": "\\n", "\r": "\\r", "\t": "\\t"}[c])
        elif ord(c) < 0x20 or ord(c) == 0x7F:
            out.append(f"\\x{ord(c):02x}")
        else:
            out.append(c)
    body = "".join(out)
    return f'"{body}"' if quote else body


def _flow_map(pairs) -> list[str]:
    """``   - { k:v, ... }`` wrapped as FileStorage wraps it."""
    lines, line = [], "   - {"
    for i, (k, v) in enumerate(pairs):
        if i:
            line += ","
            if len(line) + len(k) + len(v) > WRAP_MARGIN:
                lines.append(line)
                line = " " * (_FLOW_INDENT - 1)
        line += f" {k}:{v}"
    lines.append(line + " }")
    return lines


def write_header(path: str, header: dict) -> None:
    lines = ["%YAML:1.0", "---"]
    lines += [f"{k}: {_string(str(header[k]))}" for k in FILE_KEYS if k in header]
    lines += [f"{k}: {int(header[k])}" for k in COUNT_KEYS if k in header]
    lines.append("cameraMatrices:")
    for kmat in header["cameraMatrices"]:
        lines += _flow_map([(k, _real(float(kmat[k]))) for k in K_KEYS])
    if not header["cameraMatrices"]:
        lines.append("   []")
    with open(path, "w", encoding="utf-8", newline="\n") as f:
        f.write("\n".join(lines) + "\n")


# --------------------------------------------------------------------- #
# reading
# --------------------------------------------------------------------- #
def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        out, i, body = [], 0, s[1:-1]
        while i < len(body):
            c = body[i]
            if c == "\\" and i + 1 < len(body):
                e = body[i + 1]
                if e == "x":
                    out.append(chr(int(body[i + 2:i + 4], 16)))
                    i += 4
                    continue
                out.append({"n": "\n", "r": "\r", "t": "\t", "0": "\0"}.get(e, e))
                i += 2
                continue
            out.append(c)
            i += 1
        return "".join(out)
    return s


def _parse_real(s: str) -> float:
    s = _unquote(s)
    low = s.lower()
    if low in (".inf", "+.inf"):
        return math.inf
    if low == "-.inf":
        return -math.inf
    if low == ".nan":
        return math.nan
    return float(s)


def _matrices(block: list[str]) -> list[dict]:
    """The items of ``cameraMatrices``: flow maps (``- { fx:400., ... }``,
    perhaps over several lines) or block maps (``- fx: 400.0``)."""
    items = []
    for line in block:
        s = line.strip()
        if s.startswith("- ") or s == "-":
            items.append([s[1:].strip()])
        elif items and s:
            items[-1].append(s)
    out = []
    for parts in items:
        text = " ".join(parts).strip()
        if text.startswith("{"):
            pairs = text.strip("{} ").split(",")
        else:
            pairs = parts
        kmat = {}
        for pair in pairs:
            if ":" in pair:
                k, v = pair.split(":", 1)
                kmat[k.strip()] = v.strip()
        out.append({k: _parse_real(kmat[k]) for k in K_KEYS if k in kmat})
    return out


def read_header(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        lines = [ln.rstrip("\n\r") for ln in f]
    top: dict[str, list[str]] = {}  # key -> its value's lines (the first one inline)
    key = None
    for ln in lines:
        if not ln.strip() or ln.startswith(("%", "---", "#", "...")):
            continue
        if ln[0] not in " -" and ":" in ln:
            key, rest = ln.split(":", 1)
            key = key.strip()
            top[key] = [rest.strip()]
        elif key is not None:
            top[key].append(ln)
    out = {}
    for k in FILE_KEYS:
        if k in top:
            # A long scalar may be folded over several lines.
            out[k] = _unquote(" ".join(s.strip() for s in top[k] if s.strip()))
    for k in COUNT_KEYS:
        if k in top:
            out[k] = int(_parse_real(top[k][0]))
    mats = top.get("cameraMatrices", [""])
    out["cameraMatrices"] = _matrices(mats[1:]) if mats[0] == "" else []
    return out
