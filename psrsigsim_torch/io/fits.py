"""Minimal FITS reader/writer (no cfitsio / astropy dependency; a copy of
psrsigsim_tpu/io/fits.py, which the port cannot import).

The reference reaches FITS through fitsio->cfitsio via the pdat toolbox
(reference: io/psrfits.py:7-10); neither is available here, so this module
implements the slice of FITS the PSRFITS standard needs, from the spec:

* 2880-byte header/data blocks of 80-char card images
* PRIMARY HDUs (with or without data) and BINTABLE extensions
* TFORM codes L X B I J K A E D C M (fixed-length; PSRFITS uses no heap)
* TDIM multidimensional cells, big-endian on disk

Template-copy fidelity matters (output files are compared byte for byte), so headers
preserve original card images verbatim unless a card's value is edited.

An optional C++ fast path accelerates the hot encode (float -> big-endian
int16 scaling) — see psrsigsim_torch/io/native.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Card", "Header", "HDU", "FitsFile", "bintable_dtype"]

BLOCK = 2880
CARDLEN = 80

# TFORM letter -> (numpy big-endian dtype, bytes per element)
_TFORM_DTYPES = {
    "L": ("S1", 1),  # logical, stored as 'T'/'F' bytes; exposed as S1
    "B": (">u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "A": ("S", 1),  # character; repeat = string length
    "E": (">f4", 4),
    "D": (">f8", 8),
    "C": (">c8", 8),
    "M": (">c16", 16),
}


class Card:
    """One 80-character header card; keeps the raw image for fidelity."""

    __slots__ = ("image", "key")

    def __init__(self, image):
        self.image = image.ljust(CARDLEN)[:CARDLEN]
        # cached: headers are scanned by key thousands of times per file
        self.key = self.image[:8].strip()

    # -- value parsing -----------------------------------------------------
    @property
    def value(self):
        img = self.image
        if img[8:10] != "= ":
            return img[8:].strip()  # COMMENT / HISTORY / blank
        body = img[10:]
        # string value: starts with quote; '' escapes a quote
        s = body.lstrip()
        if s.startswith("'"):
            out = []
            i = 1
            while i < len(s):
                if s[i] == "'":
                    if i + 1 < len(s) and s[i + 1] == "'":
                        out.append("'")
                        i += 2
                        continue
                    break
                out.append(s[i])
                i += 1
            return "".join(out).rstrip()
        # strip trailing comment
        val = body.split("/", 1)[0].strip()
        if val == "T":
            return True
        if val == "F":
            return False
        if val == "":
            return None
        try:
            if any(c in val for c in ".EeDd") and not val.lstrip("+-").isdigit():
                return float(val.replace("D", "E").replace("d", "e"))
            return int(val)
        except ValueError:
            return val

    @property
    def comment(self):
        img = self.image
        if img[8:10] != "= ":
            return ""
        body = img[10:]
        s = body.lstrip()
        if s.startswith("'"):
            # find closing quote, then '/'
            i = 1
            while i < len(s):
                if s[i] == "'":
                    if i + 1 < len(s) and s[i + 1] == "'":
                        i += 2
                        continue
                    break
                i += 1
            rest = s[i + 1 :]
        else:
            rest = body.split("/", 1)[1] if "/" in body else ""
        return rest.split("/", 1)[-1].strip() if "/" in ("/" + rest) and rest else ""

    @staticmethod
    def make(key, value, comment=""):
        """Format a new card image per the FITS standard."""
        key = key.upper()
        if key in ("COMMENT", "HISTORY", "") or value is None and comment and key:
            text = "" if value is None else str(value)
            return Card(f"{key:<8}{text}")
        if isinstance(value, bool):
            val = "T" if value else "F"
            field = f"{val:>20}"
        elif isinstance(value, (int, np.integer)):
            field = f"{int(value):>20}"
        elif isinstance(value, (float, np.floating)):
            field = f"{_fmt_float(float(value)):>20}"
        elif isinstance(value, bytes):
            value = value.decode("ascii", "replace")
            field = _fmt_str(value)
        elif isinstance(value, str):
            field = _fmt_str(value)
        elif value is None:
            field = " " * 20
        else:
            raise TypeError(f"unsupported card value {value!r}")
        img = f"{key:<8}= {field}"
        if comment:
            img = f"{img} / {comment}"
        return Card(img)

    def with_value(self, value):
        """New card with the same key/comment but a different value."""
        return Card.make(self.key, value, self.comment)

    def __repr__(self):
        return f"Card({self.image.rstrip()!r})"


def _fmt_float(v):
    if v == int(v) and abs(v) < 1e15:
        s = f"{v:.1f}"
    else:
        s = f"{v:.14G}"
        if "E" in s:
            m, e = s.split("E")
            if "." not in m:
                m += "."
            s = f"{m}E{int(e):+03d}"
    return s


def _fmt_str(value):
    inner = value.replace("'", "''")
    # closing quote at col >= 20 (min 8-char string field)
    return f"'{inner:<8}'"


class Header:
    """Ordered collection of cards with dict-style access by key.

    ``cards`` must be mutated through the Header methods (``__setitem__``
    appends/replaces) — a lazy key index accelerates the lookups that
    dominate bulk PSRFITS writing.
    """

    def __init__(self, cards=None):
        self.cards = list(cards) if cards else []
        self._idx = None  # lazy {key: first index}

    @classmethod
    def parse(cls, raw):
        cards = []
        for off in range(0, len(raw), CARDLEN):
            img = raw[off : off + CARDLEN].decode("ascii", "replace")
            if img[:8].strip() == "END":
                return cls(cards)
            cards.append(Card(img))
        raise ValueError("header block missing END card")

    def _find(self, key):
        if self._idx is None:
            idx = {}
            for i, c in enumerate(self.cards):
                idx.setdefault(c.key, i)
            self._idx = idx
        return self._idx.get(key.upper(), -1)

    def __contains__(self, key):
        return self._find(key) >= 0

    def __getitem__(self, key):
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        return self.cards[i].value

    def get(self, key, default=None):
        i = self._find(key)
        return self.cards[i].value if i >= 0 else default

    def __setitem__(self, key, value):
        i = self._find(key)
        if i >= 0:
            self.cards[i] = self.cards[i].with_value(value)  # key unchanged
        else:
            # insert before END position (i.e. append)
            self.cards.append(Card.make(key, value))
            if self._idx is not None:
                self._idx.setdefault(self.cards[-1].key, len(self.cards) - 1)

    def keys(self):
        return [c.key for c in self.cards if c.key]

    def items(self):
        return [(c.key, c.value) for c in self.cards if c.key]

    def copy(self):
        return Header([Card(c.image) for c in self.cards])

    def serialize(self):
        out = "".join(c.image for c in self.cards) + "END".ljust(CARDLEN)
        pad = (-len(out)) % BLOCK
        return (out + " " * pad).encode("ascii")


def _parse_tform(tform):
    """'2048E' -> (2048, 'E'); 'A' -> (1, 'A')."""
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code in ("P", "Q"):
        raise NotImplementedError("variable-length (heap) columns not supported")
    return repeat, code


def bintable_dtype(header):
    """Build the numpy structured dtype of one BINTABLE row, honoring TDIM.

    Returns (dtype, colinfo) where colinfo maps name -> (repeat, code, shape).
    """
    tfields = header["TFIELDS"]
    fields = []
    colinfo = {}
    for n in range(1, tfields + 1):
        name = str(header[f"TTYPE{n}"]).strip()
        repeat, code = _parse_tform(str(header[f"TFORM{n}"]))
        tdim = header.get(f"TDIM{n}")
        if tdim:
            dims = tuple(int(x) for x in str(tdim).strip("() ").split(","))
            shape = tuple(reversed(dims))  # FITS is column-major
        elif repeat > 1 and code != "A":
            shape = (repeat,)
        else:
            shape = ()
        if code == "A":
            base = f"S{repeat}"
            shape = ()
        else:
            base = _TFORM_DTYPES[code][0]
        fields.append((name, base, shape) if shape else (name, base))
        colinfo[name] = (repeat, code, shape)
    return np.dtype(fields), colinfo


class HDU:
    """One header-data unit: header + ndarray payload (None, image array, or
    structured record array for BINTABLEs)."""

    def __init__(self, header, data=None, name=None):
        self.header = header
        self.data = data
        self._name = name

    @property
    def name(self):
        if self._name:
            return self._name
        return str(self.header.get("EXTNAME", "PRIMARY")).strip()

    @property
    def is_bintable(self):
        return str(self.header.get("XTENSION", "")).strip() == "BINTABLE"

    def read_header(self):
        """fitsio-compatible accessor: mapping of key -> value."""
        return dict(self.header.items())

    def get_nrows(self):
        return 0 if self.data is None else len(self.data)

    def __getitem__(self, key):
        """Column access (by name) or row access (by int) on table data."""
        if isinstance(key, str):
            return self.data[key]
        return self.data[key]


def _data_nbytes(header):
    bitpix = abs(header["BITPIX"])
    naxis = header["NAXIS"]
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= header[f"NAXIS{i}"]
    gcount = header.get("GCOUNT", 1)
    pcount = header.get("PCOUNT", 0)
    return (bitpix // 8) * gcount * (pcount + n)


class FitsFile:
    """A FITS file as a list of HDUs; read/write whole files."""

    def __init__(self, hdus=None):
        self.hdus = hdus or []

    @classmethod
    def read(cls, path):
        with open(path, "rb") as f:
            raw = f.read()
        hdus = []
        off = 0
        while off < len(raw):
            # accumulate header blocks until END
            hstart = off
            header = None
            while header is None:
                block_end = off + BLOCK
                if block_end > len(raw):
                    raise ValueError("truncated FITS header")
                chunk = raw[hstart:block_end]
                if b"END     " in _card_keys(chunk) or _has_end(chunk):
                    header = Header.parse(chunk)
                off = block_end
            nbytes = _data_nbytes(header)
            data = None
            if nbytes:
                payload = raw[off : off + nbytes]
                if header.get("XTENSION", "").strip() == "BINTABLE":
                    dtype, _ = bintable_dtype(header)
                    nrows = header["NAXIS2"]
                    data = np.frombuffer(
                        payload[: dtype.itemsize * nrows], dtype=dtype
                    ).copy()
                else:
                    data = _image_array(header, payload)
                off += nbytes + ((-nbytes) % BLOCK)
            hdus.append(HDU(header, data))
        return cls(hdus)

    # -- access ------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, int):
            return self.hdus[key]
        key = key.upper()
        for h in self.hdus:
            if h.name.upper() == key:
                return h
        raise KeyError(key)

    def __contains__(self, key):
        try:
            self[key]
            return True
        except KeyError:
            return False

    def names(self):
        return [h.name for h in self.hdus]

    # -- write -------------------------------------------------------------
    def write(self, path):
        with open(path, "wb") as f:
            for hdu in self.hdus:
                self._sync_table_geometry(hdu)
                f.write(hdu.header.serialize())
                if hdu.data is not None:
                    payload = _serialize_data(hdu)
                    f.write(payload)
                    f.write(b"\x00" * ((-len(payload)) % BLOCK))

    @staticmethod
    def _sync_table_geometry(hdu):
        """Keep NAXIS1/NAXIS2 consistent with the record array actually held."""
        if hdu.is_bintable and hdu.data is not None:
            hdu.header["NAXIS1"] = hdu.data.dtype.itemsize
            hdu.header["NAXIS2"] = len(hdu.data)


def _card_keys(chunk):
    return b"".join(chunk[i : i + 8] for i in range(0, len(chunk), CARDLEN))


def _has_end(chunk):
    for i in range(0, len(chunk), CARDLEN):
        if chunk[i : i + 8].rstrip() == b"END":
            return True
    return False


_BITPIX_DTYPES = {
    8: ">u1",
    16: ">i2",
    32: ">i4",
    64: ">i8",
    -32: ">f4",
    -64: ">f8",
}


def _image_array(header, payload):
    dtype = np.dtype(_BITPIX_DTYPES[header["BITPIX"]])
    shape = tuple(
        header[f"NAXIS{i}"] for i in range(header["NAXIS"], 0, -1)
    )
    count = int(np.prod(shape)) if shape else 0
    return np.frombuffer(payload[: count * dtype.itemsize], dtype=dtype).reshape(shape).copy()


def _serialize_data(hdu):
    data = hdu.data
    if hdu.is_bintable:
        return data.tobytes()
    return np.ascontiguousarray(data).tobytes()
