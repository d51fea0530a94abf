"""Minimal XLSX writer (stdlib only); the port's own copy of
gpt2_vision_language_tpu/obs/xlsx.py.

The reference exports its metrics CSV to XLSX via pandas+openpyxl
(train_gpt2.py:509-517); openpyxl is not a dependency, so this writes
the (small, text/number-only) workbook directly — XLSX is just a zip of
XML parts. Inline strings keep it single-file simple.
"""

from __future__ import annotations

import csv
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _cell(value: str) -> str:
    try:
        float(value)
        if value.strip() != "":
            return f"<c t=\"n\"><v>{value}</v></c>"
    except ValueError:
        pass
    return f'<c t="inlineStr"><is><t>{escape(value)}</t></is></c>'


def rows_to_xlsx(rows, path: str, sheet_name: str = "metrics") -> None:
    body = "".join(
        "<row>" + "".join(_cell(str(v)) for v in row) + "</row>" for row in rows
    )
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{body}</sheetData></worksheet>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK.format(name=escape(sheet_name)))
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def csv_to_xlsx(csv_path: str, xlsx_path: str) -> None:
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    rows_to_xlsx(rows, xlsx_path)
