"""CSV tables as uce_tpu's pandas code reads, merges and writes them, without
pandas (the card's machine has none): ``read_csv`` types each column as
``pandas.read_csv`` does, ``merge`` is ``DataFrame.merge`` on one key
column (left or inner: the left rows' order, then the right rows' order for
each), and ``write_csv`` is ``to_csv(index=False)``. A table is (header,
rows), rows of Python values with None for NA."""

from __future__ import annotations

import csv

# The strings that pandas.read_csv reads as NA by default (pandas'
# STR_NA_VALUES).
PANDAS_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _pandas_column(cells: list[str]) -> list:
    """One column of a CSV as ``pandas.read_csv`` types it: int, float (an
    int column with an NA too), or text; NA cells become None."""
    values = [None if c in PANDAS_NA_STRINGS else c for c in cells]
    present = [v for v in values if v is not None]
    for cast in (int, float):
        try:
            for v in present:
                cast(v)
        except ValueError:
            continue
        if cast is int and len(present) < len(values):
            cast = float  # pandas stores an int column with NAs as float64
        return [None if v is None else cast(v) for v in values]
    return values


def read_csv(path: str) -> tuple[list[str], list[list]]:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    columns = [_pandas_column([r[j] if j < len(r) else "" for r in body])
               for j in range(len(header))]
    return header, [list(r) for r in zip(*columns)] if body else []


def merge(left: tuple, right: tuple, on: str, how: str) -> tuple[list[str], list[list]]:
    """``left.merge(right, on=on, how=how)`` for ``how`` "left" or "inner":
    the left columns, then the right ones but the key. An int column of the
    right that gains an NA becomes float, as in pandas."""
    if how not in ("left", "inner"):
        raise ValueError(f"unsupported merge {how!r}")
    (lh, lrows), (rh, rrows) = left, right
    lk, rk = lh.index(on), rh.index(on)
    keep = [j for j in range(len(rh)) if j != rk]
    by_key: dict = {}
    for r in rrows:
        by_key.setdefault(r[rk], []).append([r[j] for j in keep])
    rows = []
    for r in lrows:
        matches = by_key.get(r[lk])
        if matches:
            rows += [r + m for m in matches]
        elif how == "left":
            rows.append(r + [None] * len(keep))
    header = lh + [rh[j] for j in keep]
    for j in range(len(lh), len(header)):
        col = [r[j] for r in rows]
        if None in col and all(isinstance(v, int) and not isinstance(v, bool)
                               for v in col if v is not None):
            for r in rows:
                r[j] = None if r[j] is None else float(r[j])
    return header, rows


def cell(v) -> str:
    """A value as pandas' to_csv writes it: NA empty, floats by repr."""
    if v is None or (isinstance(v, float) and v != v):
        return ""
    if isinstance(v, float):
        return repr(float(v))
    return str(v)


def write_csv(path: str, header: list[str], rows: list[list]) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([cell(v) for v in r] for r in rows)


def column(table: tuple, name: str) -> list:
    header, rows = table
    j = header.index(name)
    return [r[j] for r in rows]
