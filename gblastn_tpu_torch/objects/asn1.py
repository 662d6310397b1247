"""Generic ASN.1 value tree with NCBI text + binary (BER) writers.

Replaces the role of the NCBI serial library's object streams for the
subset of types the BLAST formatters emit (reference:
NCBI c++/src/serial/objostrasn.cpp (text) and
objostrasnb.cpp (binary)):

* text form follows CObjectOStreamAsn: 2-space indents, `{` on the
  member line, enum names bare, strings doubled-quote escaped, REAL as
  ``{ mantissa, 10, exponent }`` (WriteDouble2, objostrasn.cpp:159);
* binary form follows CObjectOStreamAsnBinary: constructed values use
  indefinite lengths (0x80 ... 00 00), SEQUENCE/SET-OF tag 0x30/0x31,
  members and CHOICE alternatives wrapped in context-specific
  constructed tags by definition order, VisibleString tag 26, REAL as
  tag 9 with an ISO-6093 NR3 decimal payload (WriteDouble2,
  objostrasnb.cpp:662-703).

The node model carries the definition-order tag of every member, so
encoders need no schema: builders (objects.seqalign) hard-code the tag
numbers from the reference .asn modules they cite.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Int:
    value: int


@dataclass
class Real:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Bool:
    value: bool


@dataclass
class Enum:
    """ENUMERATED (or named INTEGER in text form): prints the name,
    encodes the value."""

    name: str
    value: int
    integer: bool = False    # INTEGER with named values, not ENUMERATED


@dataclass
class Octets:
    """OCTET STRING: text form ``'...'H`` hex, BER tag 4."""

    value: bytes


@dataclass
class Member:
    """A SEQUENCE member or CHOICE alternative: ``tag`` is the
    zero-based definition-order context tag."""

    name: str
    tag: int
    value: object


@dataclass
class Seq:
    members: list = field(default_factory=list)   # list[Member]


@dataclass
class Choice:
    alt: Member = None


@dataclass
class Of:
    """SET OF / SEQUENCE OF."""

    items: list = field(default_factory=list)
    set_of: bool = True


# ------------------------------------------------------------------ text

def _real_parts(v: float) -> tuple[int, int]:
    """(mantissa, exponent) with value == mantissa * 10**exponent
    (DoubleToString_Ecvt convention, 15 significant digits)."""
    if v == 0.0:
        return 0, 0
    s = f"{abs(v):.14e}"            # d.14 digits e+xx
    mant_s, exp_s = s.split("e")
    digits = mant_s.replace(".", "").rstrip("0") or "0"
    e1 = int(exp_s)
    mant = int(digits)
    if v < 0:
        mant = -mant
    return mant, e1 - (len(digits) - 1)


def _quote(s: str) -> str:
    return '"' + s.replace('"', '""') + '"'


def _text(node, indent: int, out: list) -> None:
    pad = "  " * indent
    if isinstance(node, Int):
        out.append(str(node.value))
    elif isinstance(node, Bool):
        out.append("TRUE" if node.value else "FALSE")
    elif isinstance(node, Real):
        m, e = _real_parts(node.value)
        out.append("{ %d, 10, %d }" % (m, e))
    elif isinstance(node, Str):
        out.append(_quote(node.value))
    elif isinstance(node, Octets):
        hx = node.value.hex().upper()
        # CObjectOStreamAsn wraps octet-string hex across lines
        lines = [hx[i: i + 78] for i in range(0, len(hx), 78)] or [""]
        out.append("'" + "\n".join(lines) + "'H")
    elif isinstance(node, Enum):
        out.append(node.name)
    elif isinstance(node, Choice):
        out.append(node.alt.name + " ")
        _text(node.alt.value, indent, out)
    elif isinstance(node, Seq):
        out.append("{\n")
        for i, mem in enumerate(node.members):
            out.append("  " * (indent + 1) + mem.name + " ")
            _text(mem.value, indent + 1, out)
            out.append(",\n" if i + 1 < len(node.members) else "\n")
        out.append(pad + "}")
    elif isinstance(node, Of):
        if not node.items:
            out.append("{\n" + pad + "}")
            return
        out.append("{\n")
        for i, item in enumerate(node.items):
            out.append("  " * (indent + 1))
            _text(item, indent + 1, out)
            out.append(",\n" if i + 1 < len(node.items) else "\n")
        out.append(pad + "}")
    else:
        raise TypeError(f"unknown ASN.1 node {node!r}")


def to_text(type_name: str, node) -> str:
    out = [type_name + " ::= "]
    _text(node, 0, out)
    out.append("\n")
    return "".join(out)


# ------------------------------------------------------------------ binary

def _len_bytes(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(b)]) + b


def _prim(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _len_bytes(len(content)) + content


def _ctx(tag: int, inner: bytes) -> bytes:
    """Context-specific constructed, indefinite length (the NCBI
    member/alternative wrapper, objostrasnb.cpp:1000)."""
    if tag < 31:
        head = bytes([0xA0 | tag])
    else:
        head = bytes([0xBF, tag])     # high-tag-number form, tag < 128
    return head + b"\x80" + inner + b"\x00\x00"


def _int_content(v: int) -> bytes:
    n = 1
    while not -(1 << (8 * n - 1)) <= v < (1 << (8 * n - 1)):
        n += 1
    return v.to_bytes(n, "big", signed=True)


def to_ber(node) -> bytes:
    if isinstance(node, Int):
        return _prim(0x02, _int_content(node.value))
    if isinstance(node, Bool):
        return _prim(0x01, b"\xff" if node.value else b"\x00")
    if isinstance(node, Real):
        if node.value == 0.0:
            return _prim(0x09, b"")
        txt = f"{node.value:.15g}".encode("ascii")
        return _prim(0x09, b"\x03" + txt)
    if isinstance(node, Str):
        return _prim(0x1A, node.value.encode("ascii", "replace"))
    if isinstance(node, Octets):
        return _prim(0x04, node.value)
    if isinstance(node, Enum):
        tag = 0x02 if node.integer else 0x0A
        return _prim(tag, _int_content(node.value))
    if isinstance(node, Choice):
        return _ctx(node.alt.tag, to_ber(node.alt.value))
    if isinstance(node, Seq):
        inner = b"".join(
            _ctx(m.tag, to_ber(m.value)) for m in node.members
        )
        return b"\x30\x80" + inner + b"\x00\x00"
    if isinstance(node, Of):
        inner = b"".join(to_ber(i) for i in node.items)
        head = b"\x31\x80" if node.set_of else b"\x30\x80"
        return head + inner + b"\x00\x00"
    raise TypeError(f"unknown ASN.1 node {node!r}")


# ------------------------------------------------------------ text parser

@dataclass
class Named:
    """Parsed ``name value`` pair: a SEQUENCE member or a CHOICE
    alternative (the text form does not distinguish them). Chains nest:
    ``local str "q1"`` parses as Named(local, Named(str, "q1"))."""

    name: str
    value: object


def named_get(items, name, default=None):
    """Member lookup inside a parsed ``{ ... }`` block."""
    for it in items:
        if isinstance(it, Named) and it.name == name:
            return it.value
    return default


def _tokenize(text: str):
    """Token stream for NCBI ASN.1 text form (CObjectIStreamAsn)."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
        elif text.startswith("--", i):        # comment to end of line
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
        elif c in "{},":
            yield c, c
            i += 1
        elif text.startswith("::=", i):
            yield "::=", "::="
            i += 3
        elif c == '"':
            j = i + 1
            parts = []
            while j < n:
                if text[j] == '"':
                    if j + 1 < n and text[j + 1] == '"':
                        parts.append('"')
                        j += 2
                        continue
                    break
                # literal newline in a wrapped string is a space-less
                # continuation in NCBI text output
                if text[j] != "\n":
                    parts.append(text[j])
                j += 1
            yield "str", "".join(parts)
            i = j + 1
        elif c == "'":
            j = text.index("'", i + 1)
            hx = "".join(text[i + 1: j].split())
            suffix = text[j + 1: j + 2]
            if suffix.upper() == "H":
                yield "octets", bytes.fromhex(hx)
            else:                               # 'B' bit string
                yield "octets", int(hx or "0", 2).to_bytes(
                    (len(hx) + 7) // 8 or 1, "big"
                )
            i = j + 2
        elif c == "-" or c.isdigit():
            j = i + 1
            while j < n and (text[j].isdigit()):
                j += 1
            yield "int", int(text[i:j])
            i = j
        else:
            j = i
            while j < n and (text[j].isalnum() or text[j] in "-_."):
                j += 1
            yield "ident", text[i:j]
            i = j


class _Tokens:
    def __init__(self, text):
        self._it = list(_tokenize(text))
        self._pos = 0

    def peek(self):
        if self._pos < len(self._it):
            return self._it[self._pos]
        return None, None

    def next(self):
        t = self.peek()
        if t[0] is None:
            raise ValueError("unexpected end of ASN.1 text")
        self._pos += 1
        return t


def _parse_value(tk: _Tokens):
    kind, val = tk.next()
    if kind == "{":
        items = []
        k, _ = tk.peek()
        if k == "}":
            tk.next()
            return items
        while True:
            items.append(_parse_value(tk))
            k, _ = tk.next()
            if k == "}":
                return items
            if k != ",":
                raise ValueError(f"expected ',' or '}}', got {k}")
    if kind in ("int", "str", "octets"):
        return val
    if kind == "ident":
        if val == "TRUE":
            return True
        if val == "FALSE":
            return False
        if val == "NULL":
            return None
        k, _ = tk.peek()
        if k in (",", "}", None):
            return val                       # bare enum identifier
        return Named(val, _parse_value(tk))
    raise ValueError(f"unexpected token {kind}:{val!r}")


def parse_text(text: str):
    """Parse ``Type ::= value`` NCBI ASN.1 text; returns (type, value).

    Schema-free: SEQUENCE members and CHOICE alternatives both come
    back as Named(name, value); ``{ ... }`` blocks as Python lists;
    REAL ``{ m, 10, e }`` as the 3-int list (use real_value())."""
    tk = _Tokens(text)
    kind, name = tk.next()
    if kind != "ident":
        raise ValueError("expected type name")
    kind, _ = tk.next()
    if kind != "::=":
        raise ValueError("expected '::='")
    return name, _parse_value(tk)


def real_value(v) -> float:
    """Interpret a parsed REAL: [m, 10, e] list or a plain int."""
    if isinstance(v, list) and len(v) == 3:
        return float(v[0]) * 10.0 ** float(v[2])
    return float(v)
