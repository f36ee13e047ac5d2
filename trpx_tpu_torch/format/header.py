"""Byte-exact ``.trpx`` XML header emission and parsing.

A ``.trpx`` file is exactly one XML empty-element header followed immediately
(no separator, no newline) by the raw bitstream bytes (Terse.hpp:454-474).
The attribute order and formatting are fixed:

``<Terse prolix_bits="P" signed="S" block="B" memory_size="M"
number_of_values="N"[ dimensions="d0 d1 ..."] number_of_frames="F"/>``

The parser mirrors the reference's ``XML_element`` scanner
(XML_element.hpp:216-541): it scans for the named tag, skipping XML comments
and CDATA sections, captures attributes, and reports the byte offset of the
first binary byte after the element.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class TrpxMeta:
    prolix_bits: int
    signed: bool
    block: int
    memory_size: int
    number_of_values: int
    dimensions: tuple[int, ...] = ()
    number_of_frames: int = 1


def emit_header(meta: TrpxMeta) -> bytes:
    """Emit the header byte-for-byte as ``Terse::write`` does
    (Terse.hpp:454-474): fixed attribute order, ``signed`` as 0/1,
    space-separated dimensions, no trailing newline."""
    parts = [
        f'<Terse prolix_bits="{meta.prolix_bits}"',
        f' signed="{1 if meta.signed else 0}"',
        f' block="{meta.block}"',
        f' memory_size="{meta.memory_size}"',
        f' number_of_values="{meta.number_of_values}"',
    ]
    if meta.dimensions:
        parts.append(' dimensions="' + " ".join(str(d) for d in meta.dimensions) + '"')
    parts.append(f' number_of_frames="{meta.number_of_frames}"/>')
    return "".join(parts).encode("ascii")


_ATTR_RE = re.compile(rb'([A-Za-z_][\w.:-]*)\s*=\s*("([^"]*)"|\'([^\']*)\')')


def _find_tag(data: bytes, tag: bytes, start: int = 0) -> tuple[int, int]:
    """Find ``<tag`` skipping comments and CDATA (XML_element.hpp:442-452).
    Returns (offset of '<', offset just past the tag name)."""
    i = start
    n = len(data)
    while True:
        j = data.find(b"<", i)
        if j < 0 or j + 1 >= n:
            raise ValueError(f"tag <{tag.decode()}> not found")
        if data.startswith(b"<!--", j):
            end = data.find(b"-->", j + 4)
            if end < 0:
                raise ValueError("unterminated XML comment")
            i = end + 3
            continue
        if data.startswith(b"<![CDATA[", j):
            end = data.find(b"]]>", j + 9)
            if end < 0:
                raise ValueError("unterminated CDATA section")
            i = end + 3
            continue
        after = j + 1 + len(tag)
        if data[j + 1 : after] == tag and (
            after >= n or data[after : after + 1] in (b" ", b"\t", b"\n", b"\r", b">", b"/")
        ):
            return j, after
        i = j + 1


def parse_header(data: bytes, tag: str = "Terse", start: int = 0) -> tuple[TrpxMeta, int]:
    """Parse the header out of ``data``; return (meta, payload_offset).

    ``payload_offset`` is the index of the first bitstream byte — the parser
    leaves the "stream" exactly past the element like XML_element.hpp:116-120.
    """
    tagb = tag.encode("ascii")
    tag_at, after = _find_tag(data, tagb, start)
    gt = data.find(b">", after)
    if gt < 0:
        raise ValueError("unterminated XML element")
    empty = data[gt - 1 : gt] == b"/"
    attr_blob = data[after : gt - 1 if empty else gt]
    attrs: dict[str, str] = {}
    for m in _ATTR_RE.finditer(attr_blob):
        val = m.group(3) if m.group(3) is not None else m.group(4)
        attrs[m.group(1).decode("ascii")] = val.decode("ascii")
    end = gt + 1
    if not empty:
        close = data.find(b"</" + tagb + b">", end)
        if close < 0:
            raise ValueError(f"missing </{tag}>")
        end = close + len(tagb) + 3

    def geti(name: str, default: int | None = None) -> int:
        if name not in attrs:
            if default is None:
                raise ValueError(f"missing required attribute {name!r}")
            return default
        try:
            return int(attrs[name])
        except ValueError:
            # reference parses memory_size via stold (Terse.hpp:495)
            return int(float(attrs[name]))

    dims: tuple[int, ...] = ()
    if attrs.get("dimensions"):
        dims = tuple(int(t) for t in attrs["dimensions"].split())
    meta = TrpxMeta(
        prolix_bits=geti("prolix_bits"),
        signed=bool(geti("signed")),
        block=geti("block", 12),
        memory_size=geti("memory_size"),
        number_of_values=geti("number_of_values"),
        dimensions=dims,
        # write() always emits it (Terse.hpp:469); default 1 for robustness
        number_of_frames=geti("number_of_frames", 1),
    )
    # Validate ranges before any consumer divides/allocates by them.
    # The reference asserts none of this (hostile headers reach the
    # decoder raw); a production decoder must refuse them cleanly.
    if meta.block <= 0:
        raise ValueError(f"invalid block={meta.block} (must be positive)")
    if meta.number_of_values <= 0:
        raise ValueError(
            f"invalid number_of_values={meta.number_of_values}")
    if meta.number_of_frames <= 0:
        raise ValueError(
            f"invalid number_of_frames={meta.number_of_frames}")
    if meta.memory_size < 0:
        raise ValueError(f"invalid memory_size={meta.memory_size}")
    if not 0 <= meta.prolix_bits <= 73:
        # 73 = 10 + 63, the widest width the 12-bit header form encodes
        # (Terse.hpp:530-533); our own encoder emits 65 for INT64_MIN
        # blocks (signed width = 1 + bitlength(|v|))
        raise ValueError(
            f"invalid prolix_bits={meta.prolix_bits} (0..73)")
    if any(d <= 0 for d in meta.dimensions):
        raise ValueError(f"invalid dimensions={meta.dimensions}")
    return meta, end
