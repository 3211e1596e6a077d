"""Minimal dependency-free .xlsx reader (stdlib zipfile + ElementTree) —
the port's copy of ``mertools_tpu/io/xlsx.py``.

The reference distributes its emotion-wheel tables as Excel files read with
``pd.read_excel`` (``MER2025/MER2025_Track23/my_affectgpt/evaluation/
wheel.py:16-55``); pandas needs openpyxl for that, which this image lacks.
An .xlsx is a zip of XML parts — this reads the subset those wheel tables
(and any simple single-table sheet) use:

- ``xl/workbook.xml``      sheet list (name -> r:id),
- ``xl/_rels/workbook.xml.rels``  r:id -> worksheet part,
- ``xl/sharedStrings.xml`` shared-string table (``<si>`` with nested ``<t>``),
- ``xl/worksheets/*.xml``  rows of ``<c r="A1" t="...">`` cells with ``<v>``
  values (shared/inline/number/bool/str types).

``read_xlsx_records`` mirrors ``pd.read_excel(...).to_dict("records")``:
first row = header, missing cells = None.
"""

from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_NS_R = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
_NS_PR = ("{http://schemas.openxmlformats.org/package/2006/relationships}")


def _col_index(cell_ref: str) -> int:
    col = re.match(r"[A-Z]+", cell_ref).group(0)
    idx = 0
    for ch in col:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def _si_text(si) -> str:
    # a shared-string item may hold one <t> or multiple rich-text runs
    return "".join(t.text or "" for t in si.iter(f"{_NS}t"))


def _cell_value(c, shared: list):
    ctype = c.get("t", "n")
    if ctype == "inlineStr":
        node = c.find(f"{_NS}is")
        return _si_text(node) if node is not None else None
    v = c.find(f"{_NS}v")
    if v is None or v.text is None:
        return None
    if ctype == "s":
        return shared[int(v.text)]
    if ctype == "b":
        return bool(int(v.text))
    if ctype == "str":
        return v.text
    # numeric: keep ints exact
    f = float(v.text)
    return int(f) if f.is_integer() else f


def read_xlsx_rows(path: str, sheet: str | int = 0) -> list[list]:
    """-> list of rows (list of cell values, None for blanks), first sheet by
    default; ``sheet`` may be a name or index."""
    with zipfile.ZipFile(path) as z:
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        rels = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        rid_to_target = {r.get("Id"): r.get("Target")
                         for r in rels.iter(f"{_NS_PR}Relationship")}
        sheets = [(s.get("name"), rid_to_target[s.get(f"{_NS_R}id")])
                  for s in wb.iter(f"{_NS}sheet")]
        if isinstance(sheet, int):
            target = sheets[sheet][1]
        else:
            target = dict(sheets)[sheet]
        target = target.lstrip("/")   # some writers emit absolute part names
        if not target.startswith("xl/"):
            target = "xl/" + target
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            sst = ET.fromstring(z.read("xl/sharedStrings.xml"))
            shared = [_si_text(si) for si in sst.iter(f"{_NS}si")]
        ws = ET.fromstring(z.read(target))

        rows = []
        for row in ws.iter(f"{_NS}row"):
            cells: dict[int, object] = {}
            for c in row.iter(f"{_NS}c"):
                ref = c.get("r")
                ci = _col_index(ref) if ref else len(cells)
                cells[ci] = _cell_value(c, shared)
            width = max(cells) + 1 if cells else 0
            rows.append([cells.get(i) for i in range(width)])
        return rows


def read_xlsx_records(path: str, sheet: str | int = 0) -> list[dict]:
    """pd.read_excel(...).to_dict('records') equivalent: header row keys,
    rows padded with None."""
    rows = read_xlsx_rows(path, sheet)
    if not rows:
        return []
    header = [str(h) if h is not None else f"col{i}"
              for i, h in enumerate(rows[0])]
    out = []
    for r in rows[1:]:
        r = list(r) + [None] * (len(header) - len(r))
        out.append(dict(zip(header, r)))
    return out
