"""ASCII table renderer byte-compatible with the PrettyTable output used for
the reference's paper tables (quant_tables_orig/*.txt); a copy of
``vfi_tpu/eval/tables.py``.

PrettyTable's centering rule (verified against the golden tables): with odd
excess space, the extra space goes right if the cell text has odd length,
left if even.
"""

from __future__ import annotations

from typing import List, Sequence


def _justify(text: str, width: int) -> str:
    excess = width - len(text)
    if excess % 2:
        if len(text) % 2:
            return " " * (excess // 2) + text + " " * (excess // 2 + 1)
        return " " * (excess // 2 + 1) + text + " " * (excess // 2)
    return " " * (excess // 2) + text + " " * (excess // 2)


def render_table(field_names: Sequence[str], rows: List[Sequence[str]]) -> str:
    cols = [[str(f)] + [str(r[i]) for r in rows] for i, f in enumerate(field_names)]
    widths = [max(len(c) for c in col) for col in cols]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(cells):
        return "|" + "|".join(" " + _justify(str(c), w) + " " for c, w in zip(cells, widths)) + "|"

    out = [sep, line(field_names), sep]
    out += [line(r) for r in rows]
    out.append(sep)
    return "\n".join(out)
