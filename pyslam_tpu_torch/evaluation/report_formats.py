"""Evaluation report writers: LaTeX, HTML, and PDF from CSV tables (host
copy of ``pyslam_tpu/evaluation/report_formats.py``).

Reference surface: pySLAM writes comparative CSV/LaTeX/HTML/PDF reports
from the evaluation grids (``slam_evaluation_manager.py:574-596`` using
``utilities/evaluation_latex.csv_list_to_pdf`` and
``utilities/evaluation_html.csv_list_to_html``).  Here:

  * ``csv_to_latex``      — one CSV -> booktabs-style tabular
  * ``csv_list_to_latex`` — full report .tex document
  * ``csv_list_to_html``  — self-contained styled HTML report
  * ``csv_list_to_pdf``   — dependency-free minimal PDF writer (monospace
    table pages; no LaTeX toolchain in this image, so the PDF is generated
    directly)
"""

from __future__ import annotations

import csv
import os
import zlib


def _read_csv(path: str) -> list[list[str]]:
    with open(path) as f:
        return [row for row in csv.reader(f)]


def csv_to_latex(path: str, caption: str | None = None) -> str:
    rows = _read_csv(path)
    if not rows:
        return ""
    ncol = len(rows[0])
    out = ["\\begin{table}[h]", "\\centering",
           "\\begin{tabular}{" + "l" * ncol + "}", "\\hline"]
    out.append(" & ".join(c.replace("_", "\\_") for c in rows[0]) + " \\\\")
    out.append("\\hline")
    for row in rows[1:]:
        out.append(" & ".join(c.replace("_", "\\_") for c in row) + " \\\\")
    out += ["\\hline", "\\end{tabular}"]
    if caption:
        out.append(f"\\caption{{{caption}}}")
    out.append("\\end{table}")
    return "\n".join(out)


def csv_list_to_latex(csv_paths: list[str], out_path: str,
                      title: str = "SLAM evaluation report") -> str:
    doc = ["\\documentclass{article}", "\\usepackage[margin=2cm]{geometry}",
           "\\begin{document}", f"\\section*{{{title}}}"]
    for p in csv_paths:
        doc.append(csv_to_latex(p, caption=os.path.basename(p)))
        doc.append("")
    doc.append("\\end{document}")
    text = "\n".join(doc)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path


def csv_list_to_html(csv_paths: list[str], out_path: str,
                     title: str = "SLAM evaluation report") -> str:
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{title}</title><style>",
        "body{font-family:sans-serif;margin:2em;}",
        "table{border-collapse:collapse;margin:1em 0;}",
        "th,td{border:1px solid #999;padding:4px 10px;text-align:right;}",
        "th{background:#eee;} td:first-child,th:first-child{text-align:left;}",
        "</style></head><body>", f"<h1>{title}</h1>"]
    for p in csv_paths:
        rows = _read_csv(p)
        if not rows:
            continue
        parts.append(f"<h2>{os.path.basename(p)}</h2><table>")
        parts.append("<tr>" + "".join(f"<th>{c}</th>" for c in rows[0])
                     + "</tr>")
        for row in rows[1:]:
            parts.append("<tr>" + "".join(f"<td>{c}</td>" for c in row)
                         + "</tr>")
        parts.append("</table>")
    parts.append("</body></html>")
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path


# ------------------------------------------------------------- minimal PDF
def _pdf_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def csv_list_to_pdf(csv_paths: list[str], out_path: str,
                    title: str = "SLAM evaluation report") -> str:
    """Write a minimal valid PDF (Courier text pages) with the tables —
    no external toolchain required."""
    lines: list[str] = [title, ""]
    for p in csv_paths:
        rows = _read_csv(p)
        if not rows:
            continue
        widths = [max(len(r[i]) for r in rows if i < len(r))
                  for i in range(len(rows[0]))]
        lines.append(os.path.basename(p))
        for r in rows:
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        lines.append("")

    pages: list[list[str]] = []
    per_page = 54
    for i in range(0, len(lines), per_page):
        pages.append(lines[i:i + per_page])

    objs: list[bytes] = []

    def add(obj: bytes) -> int:
        objs.append(obj)
        return len(objs)  # 1-indexed object number

    font = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Courier >>")
    page_ids = []
    content_ids = []
    for page in pages:
        stream = ["BT /F1 9 Tf 36 806 Td 14 TL"]
        for ln in page:
            stream.append(f"({_pdf_escape(ln)}) Tj T*")
        stream.append("ET")
        data = zlib.compress("\n".join(stream).encode("latin-1", "replace"))
        cid = add(b"<< /Length " + str(len(data)).encode()
                  + b" /Filter /FlateDecode >>\nstream\n" + data
                  + b"\nendstream")
        content_ids.append(cid)
    pages_id = len(objs) + len(pages) + 1
    for cid in content_ids:
        page_ids.append(add(
            f"<< /Type /Page /Parent {pages_id} 0 R /MediaBox [0 0 612 842] "
            f"/Resources << /Font << /F1 {font} 0 R >> >> "
            f"/Contents {cid} 0 R >>".encode()))
    kids = " ".join(f"{i} 0 R" for i in page_ids)
    pid = add(f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>"
              .encode())
    assert pid == pages_id
    cat = add(f"<< /Type /Catalog /Pages {pid} 0 R >>".encode())

    out = bytearray(b"%PDF-1.4\n")
    offsets = [0]
    for i, obj in enumerate(objs, 1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objs)+1}\n".encode()
    out += b"0000000000 65535 f \n"
    for off in offsets[1:]:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objs)+1} /Root {cat} 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    with open(out_path, "wb") as f:
        f.write(bytes(out))
    return out_path
