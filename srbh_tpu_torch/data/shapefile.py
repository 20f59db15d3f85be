"""Minimal ESRI Shapefile I/O (polygons + DBF attributes).

The port's copy of ``srbh_tpu/data/shapefile.py`` (numpy + struct). The
reference manipulates fishnet grids as shapefiles via OGR/geopandas
(generate_WSF_mask_Globeheight_grid.py:275-449, BH_loader.py:908-929); this
reads and writes the subset the predictor needs: polygon records (type 5)
with their bounding boxes, a sidecar .shx index, DBF numeric/string fields,
and .prj passthrough. Corrupt record content raises where it is found
(``struct.error`` or ``ValueError``).

The grid workflows only ever consume polygon *bounds* (generateindex uses
``geometry.bounds``), which the .shp record header stores directly — no ring
parsing needed on read.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ShapeRecord:
    bounds: Tuple[float, float, float, float]  # minx, miny, maxx, maxy
    attributes: Dict[str, object] = field(default_factory=dict)
    rings: Optional[List[np.ndarray]] = None  # each (n, 2) xy vertex array


def read_shapefile(path: str) -> List[ShapeRecord]:
    """Read polygon bounds + DBF attributes from ``path`` (.shp)."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    with open(base + ".shp", "rb") as f:
        buf = f.read()
    if len(buf) < 100:
        raise ValueError(f"{path}: truncated shapefile header")
    (code,) = struct.unpack(">i", buf[:4])
    if code != 9994:
        raise ValueError(f"{path}: not a shapefile")
    records: List[ShapeRecord] = []
    pos = 100
    while pos + 8 <= len(buf):
        _num, content_len = struct.unpack(">ii", buf[pos: pos + 8])
        if content_len <= 0 or pos + 8 + content_len * 2 > len(buf):
            # a fuzzed length of <= 0 would stall the loop in place
            raise ValueError(f"{path}: corrupt shapefile: record at "
                             f"{pos} claims {content_len * 2} bytes")
        rec = buf[pos + 8: pos + 8 + content_len * 2]
        (rtype,) = struct.unpack("<i", rec[:4])
        if rtype in (3, 5, 13, 15):  # polyline/polygon (+Z): bbox first
            minx, miny, maxx, maxy = struct.unpack("<4d", rec[4:36])
            nparts, npoints = struct.unpack("<ii", rec[36:44])
            if nparts < 0 or npoints < 0 or \
                    44 + 4 * nparts + 16 * npoints > len(rec):
                raise ValueError(f"{path}: corrupt shapefile: record at "
                                 f"{pos}: {nparts} parts/{npoints} points "
                                 f"exceed {len(rec)} content bytes")
            parts = list(struct.unpack(f"<{nparts}i",
                                       rec[44: 44 + 4 * nparts]))
            pts_off = 44 + 4 * nparts
            pts = np.frombuffer(rec, "<f8", count=npoints * 2,
                                offset=pts_off).reshape(npoints, 2)
            starts = parts + [npoints]
            rings = [pts[starts[i]: starts[i + 1]].copy()
                     for i in range(nparts)]
            records.append(ShapeRecord((minx, miny, maxx, maxy),
                                       rings=rings))
        elif rtype in (1, 11):  # point
            x, y = struct.unpack("<2d", rec[4:20])
            records.append(ShapeRecord((x, y, x, y)))
        elif rtype == 0:  # null shape
            records.append(ShapeRecord((0.0, 0.0, 0.0, 0.0)))
        else:
            raise ValueError(f"unsupported shape type {rtype}")
        pos += 8 + content_len * 2
    # attributes
    dbf = base + ".dbf"
    if os.path.exists(dbf):
        for rec, attrs in zip(records, _read_dbf(dbf)):
            rec.attributes = attrs
    return records


def _read_dbf(path: str) -> List[Dict[str, object]]:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 32:
        raise ValueError(f"{path}: truncated DBF header")
    n_rec, header_len, rec_len = struct.unpack("<IHH", buf[4:12])
    if rec_len <= 0:
        raise ValueError(f"{path}: corrupt DBF: record length {rec_len}")
    # clamp the declared record count to the number of COMPLETE records the
    # file can hold: a fuzzed uint32 n_rec otherwise spins the record loop
    # for billions of empty iterations, and a truncated tail record would
    # decode missing bytes into silently-wrong (''/None) attribute values
    n_rec = min(n_rec, max(0, (len(buf) - header_len)) // rec_len)
    fields = []
    pos = 32
    while pos < len(buf) and buf[pos] != 0x0D:
        name = buf[pos: pos + 11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(buf[pos + 11]) if pos + 11 < len(buf) else "C"
        flen = buf[pos + 16] if pos + 16 < len(buf) else 0
        fdec = buf[pos + 17] if pos + 17 < len(buf) else 0
        fields.append((name, ftype, flen, fdec))
        pos += 32
    out = []
    pos = header_len
    for _ in range(n_rec):
        rec = buf[pos: pos + rec_len]
        attrs: Dict[str, object] = {}
        off = 1  # deletion flag
        for name, ftype, flen, fdec in fields:
            raw = rec[off: off + flen].decode("ascii", "replace").strip()
            if ftype in ("N", "F"):
                if raw == "":
                    attrs[name] = None
                elif fdec or "." in raw:
                    attrs[name] = float(raw)
                else:
                    attrs[name] = int(raw)
            else:
                attrs[name] = raw
            off += flen
        out.append(attrs)
        pos += rec_len
    return out


def write_shapefile(
    path: str,
    records: Sequence[ShapeRecord],
    fields: Optional[Sequence[Tuple[str, str, int, int]]] = None,
    prj_wkt: Optional[str] = None,
):
    """Write polygon records: a record's ``rings`` as its parts when it has
    them, else its bounds as one axis-aligned rectangle (all that the JAX
    package's writer writes, and then the same bytes). The header and each
    record carry ``bounds`` as given.

    ``fields``: (name, 'N'|'C', length, decimals) DBF spec; values come from
    each record's ``attributes``.
    """
    base = path[:-4] if path.lower().endswith(".shp") else path
    shp_records = []
    gminx = gminy = float("inf")
    gmaxx = gmaxy = float("-inf")
    for rec in records:
        minx, miny, maxx, maxy = rec.bounds
        gminx, gminy = min(gminx, minx), min(gminy, miny)
        gmaxx, gmaxy = max(gmaxx, maxx), max(gmaxy, maxy)
        # one closed ring, clockwise (shapefile outer-ring convention)
        rings = rec.rings or [[(minx, maxy), (maxx, maxy), (maxx, miny),
                               (minx, miny), (minx, maxy)]]
        starts = np.cumsum([0] + [len(r) for r in rings])
        content = struct.pack("<i", 5)
        content += struct.pack("<4d", minx, miny, maxx, maxy)
        content += struct.pack("<ii", len(rings), int(starts[-1]))
        content += struct.pack(f"<{len(rings)}i", *(int(v) for v in starts[:-1]))
        for ring in rings:
            for x, y in ring:
                content += struct.pack("<2d", x, y)
        shp_records.append(content)

    shp = bytearray()
    shx = bytearray()
    offset = 50  # in 16-bit words
    body = bytearray()
    for i, content in enumerate(shp_records):
        clen = len(content) // 2
        body += struct.pack(">ii", i + 1, clen) + content
        shx += struct.pack(">ii", offset, clen)
        offset += 4 + clen
    if not records:
        gminx = gminy = gmaxx = gmaxy = 0.0

    def header(total_words):
        h = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(">i", total_words)
        h += struct.pack("<ii", 1000, 5)
        h += struct.pack("<4d", gminx, gminy, gmaxx, gmaxy)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    with open(base + ".shp", "wb") as f:
        f.write(header(50 + len(body) // 2) + body)
    with open(base + ".shx", "wb") as f:
        f.write(header(50 + len(shx) // 2) + shx)

    fields = list(fields or [])
    with open(base + ".dbf", "wb") as f:
        n = len(records)
        field_descs = bytearray()
        rec_len = 1
        for name, ftype, flen, fdec in fields:
            field_descs += name.encode("ascii")[:10].ljust(11, b"\x00")
            field_descs += ftype.encode("ascii")
            field_descs += b"\x00" * 4
            field_descs += bytes([flen, fdec]) + b"\x00" * 14
            rec_len += flen
        if not fields:  # DBF needs at least one field
            field_descs += b"FID".ljust(11, b"\x00") + b"N" + b"\x00" * 4 + bytes([10, 0]) + b"\x00" * 14
            rec_len += 10
        header_len = 32 + len(field_descs) + 1
        f.write(struct.pack("<BBBBIHH", 3, 24, 1, 1, n, header_len, rec_len))
        f.write(b"\x00" * 20)
        f.write(field_descs + b"\x0d")
        for i, rec in enumerate(records):
            row = b" "
            if fields:
                for name, ftype, flen, fdec in fields:
                    v = rec.attributes.get(name, 0 if ftype == "N" else "")
                    if ftype == "N":
                        if v is None:
                            s = ""  # empty numeric cell: all-spaces, the
                            # form _read_dbf round-trips back to None
                        elif fdec:
                            s = f"{float(v):.{fdec}f}"
                        else:
                            s = str(int(v))
                        row += s.rjust(flen)[:flen].encode("ascii")
                    else:
                        row += str(v).ljust(flen)[:flen].encode("ascii")
            else:
                row += str(i).rjust(10).encode("ascii")
            f.write(row)
        f.write(b"\x1a")
    if prj_wkt:
        with open(base + ".prj", "w") as f:
            f.write(prj_wkt)


def update_dbf_fields(path: str, new_fields, values_per_record,
                      records=None):
    """Append/overwrite DBF attribute columns (the Fishgrid_stats pattern,
    demo_preprocess_height_v2.py:1143-1186): rewrite the shapefile with the
    merged attribute table. Pass ``records`` (from a prior
    :func:`read_shapefile` of the same file) to skip the re-parse."""
    if records is None:
        records = read_shapefile(path)
    for i, rec in enumerate(records):
        for j, (name, *_spec) in enumerate(new_fields):
            rec.attributes[name] = values_per_record[j][i]
    # preserve existing fields + add new ones. The caller's explicit
    # (type, width, decimals) specs take precedence; inference from values
    # scans ALL records with str > float > int/None priority (a mixed
    # column like [1.5, 'n/a'] must become text, not crash float('n/a')
    # in write_shapefile; [None, 2, 3.5] must stay numeric with decimals).
    existing: Dict[str, Tuple[str, str, int, int]] = {}
    for spec in new_fields:
        existing[spec[0]] = tuple(spec)
    seen_str: Dict[str, int] = {}
    seen_float: set = set()
    order: List[str] = []
    for rec in records:
        for k, v in rec.attributes.items():
            if k in existing:
                continue
            if k not in seen_str and k not in order:
                order.append(k)
            if isinstance(v, str):
                seen_str[k] = max(seen_str.get(k, 0), len(v))
            elif isinstance(v, float):
                seen_float.add(k)
    for k in order:
        if k in seen_str:
            width = min(254, max(32, seen_str[k]))
            existing[k] = (k, "C", width, 0)
        elif k in seen_float:
            existing[k] = (k, "N", 19, 6)
        else:
            existing[k] = (k, "N", 19, 0)
    prj = None
    base = path[:-4]
    if os.path.exists(base + ".prj"):
        with open(base + ".prj") as f:
            prj = f.read()
    write_shapefile(path, records, list(existing.values()), prj)
    return records
