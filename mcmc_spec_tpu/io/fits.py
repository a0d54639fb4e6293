"""Minimal FITS reader and writer: primary HDU skip + binary-table columns.

astropy is not part of this framework's dependency set, but the filter
transmission curves (``bps/*.fits``) and the Vega reference spectrum
(``vegaspec.fits``) consumed by the reference (``mft6.py:616-641,3486``) are
FITS binary tables.  This reader covers exactly what those files use:
2880-byte header blocks of 80-char cards, BINTABLE extensions with scalar
columns of TFORM types ``E`` (f32), ``D`` (f64), ``J`` (i32), ``I`` (i16),
``A`` (char), big-endian per the FITS standard.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

BLOCK = 2880

_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAEDC])")
_TFORM_DTYPE = {
    "E": (">f4", 4),
    "D": (">f8", 8),
    "J": (">i4", 4),
    "I": (">i2", 2),
    "K": (">i8", 8),
    "B": ("u1", 1),
    "L": ("u1", 1),
    "A": ("S1", 1),
}


def _read_header(buf: bytes, offset: int):
    """Parse one header; returns (cards dict, next_offset)."""
    cards = {}
    pos = offset
    while True:
        block = buf[pos : pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        pos += BLOCK
        done = False
        for i in range(0, BLOCK, 80):
            card = block[i : i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" not in card[8:10]:
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                val = val[1:].split("'")[0].strip()
            cards[key] = val
        if done:
            break
    return cards, pos


def _data_size(cards) -> int:
    naxis = int(cards.get("NAXIS", 0))
    if naxis == 0:
        return 0
    size = abs(int(cards.get("BITPIX", 8))) // 8
    for i in range(1, naxis + 1):
        size *= int(cards[f"NAXIS{i}"])
    size += int(cards.get("PCOUNT", 0))
    gcount = int(cards.get("GCOUNT", 1))
    return size * gcount


def _iter_hdus(path: str):
    with open(path, "rb") as f:
        buf = f.read()
    offset = 0
    while offset < len(buf):
        cards, data_start = _read_header(buf, offset)
        size = _data_size(cards)
        padded = ((size + BLOCK - 1) // BLOCK) * BLOCK
        yield cards, buf[data_start : data_start + size]
        offset = data_start + padded


def list_hdus(path: str) -> List[dict]:
    """Header cards of every HDU."""
    return [cards for cards, _ in _iter_hdus(path)]


def read_bintable(path: str, hdu: Optional[int] = None, extname: Optional[str] = None
                  ) -> Dict[str, np.ndarray]:
    """Columns of a BINTABLE HDU as a dict keyed by TTYPE (case-preserved).

    Select by 1-based ``hdu`` index (default: first BINTABLE) or ``extname``.
    """
    for i, (cards, data) in enumerate(_iter_hdus(path)):
        if cards.get("XTENSION", "").startswith("BINTABLE"):
            if hdu is not None and i != hdu:
                continue
            if extname is not None and cards.get("EXTNAME", "").strip() != extname:
                continue
            return _parse_bintable(cards, data)
    raise ValueError(f"no matching BINTABLE HDU in {path}")


def _parse_bintable(cards, data) -> Dict[str, np.ndarray]:
    nrows = int(cards["NAXIS2"])
    rowlen = int(cards["NAXIS1"])
    tfields = int(cards["TFIELDS"])

    names, dtypes, counts, offsets = [], [], [], []
    off = 0
    for i in range(1, tfields + 1):
        tform = cards[f"TFORM{i}"].strip()
        m = _TFORM_RE.match(tform)
        if not m:
            raise ValueError(f"unsupported TFORM {tform!r}")
        count = int(m.group(1)) if m.group(1) else 1
        code = m.group(2)
        dt, width = _TFORM_DTYPE[code]
        names.append(cards.get(f"TTYPE{i}", f"col{i}").strip())
        dtypes.append((dt, code))
        counts.append(count)
        offsets.append(off)
        off += width * count
    if off != rowlen:
        raise ValueError(f"row length mismatch: {off} != {rowlen}")

    raw = np.frombuffer(data[: nrows * rowlen], dtype="u1").reshape(nrows, rowlen)
    out = {}
    for name, (dt, code), count, o in zip(names, dtypes, counts, offsets):
        width = _TFORM_DTYPE[code][1]
        sub = raw[:, o : o + width * count]
        if code == "A":
            out[name] = np.array([bytes(r).decode("ascii", "replace").strip() for r in sub])
        else:
            arr = sub.reshape(nrows * count * width).view(dt).reshape(nrows, count)
            vals = arr[:, 0] if count == 1 else arr
            out[name] = np.ascontiguousarray(vals).astype(
                np.float64 if code in "ED" else np.int64
            )
    return out


_WRITE_TFORM = {"f8": "D", "f4": "E", "i4": "J", "i8": "K", "i2": "I"}


def _card(key: str, value) -> bytes:
    if isinstance(value, bool):
        val = f"{'T' if value else 'F':>20}"
    elif isinstance(value, str):
        val = f"'{value:<8}'"
    else:
        val = f"{value:>20}"
    return f"{key:<8}= {val}".ljust(80).encode("ascii")


def _header(cards) -> bytes:
    buf = b"".join(_card(k, v) for k, v in cards) + b"END".ljust(80)
    return buf.ljust(-(-len(buf) // BLOCK) * BLOCK, b" ")


def write_bintable(path: str, columns: Dict[str, np.ndarray],
                   extname: Optional[str] = None) -> None:
    """Write scalar columns as one BINTABLE extension after an empty primary HDU.

    The inverse of :func:`read_bintable` for the numeric TFORMs it reads
    (``D``, ``E``, ``J``, ``K``, ``I``); columns must share one length.
    """
    cols = {k: np.asarray(v) for k, v in columns.items()}
    nrows = {len(v) for v in cols.values()}
    if len(nrows) != 1:
        raise ValueError(f"columns differ in length: {sorted(nrows)}")
    (nrows,) = nrows
    dtypes = [np.dtype(v.dtype).newbyteorder(">") for v in cols.values()]
    forms = []
    for name, v in cols.items():
        key = f"{v.dtype.kind}{v.dtype.itemsize}"
        if key not in _WRITE_TFORM:
            raise ValueError(f"column {name!r}: unsupported dtype {v.dtype}")
        forms.append(_WRITE_TFORM[key])
    rec = np.empty(nrows, dtype=[(n, dt) for n, dt in zip(cols, dtypes)])
    for name, v in cols.items():
        rec[name] = v
    data = rec.tobytes()
    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
             ("NAXIS1", rec.dtype.itemsize), ("NAXIS2", nrows), ("PCOUNT", 0),
             ("GCOUNT", 1), ("TFIELDS", len(cols))]
    for i, (name, form) in enumerate(zip(cols, forms), start=1):
        cards += [(f"TTYPE{i}", name), (f"TFORM{i}", form)]
    if extname:
        cards.append(("EXTNAME", extname))
    primary = _header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True)])
    with open(path, "wb") as f:
        f.write(primary + _header(cards) + data)
        f.write(b"\0" * (-len(data) % BLOCK))
