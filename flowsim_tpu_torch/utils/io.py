"""CSV loaders for case data (no pandas).

Counterpart of ``flowsim_tpu/utils/io.py``; the same tables are read with the
standard ``csv`` module and NumPy, reproducing what the pandas calls there
do: a header row, the units row skipped (``skiprows=[1]``), all-empty columns
and incomplete rows dropped, rows sorted by a named column.
"""

from __future__ import annotations

import csv

import numpy as np

from flowsim_tpu_torch.geometry import TrapezoidStation


def _read_rows(path: str) -> list[list[str]]:
    # utf-8-sig: some of the case tables carry a byte-order mark
    with open(path, newline="", encoding="utf-8-sig") as f:
        return [row for row in csv.reader(f) if any(c.strip() for c in row)]


def _to_float(cell: str) -> float:
    cell = cell.strip()
    return float(cell) if cell else np.nan


def _numeric(rows: list[list[str]]) -> np.ndarray:
    width = max(len(r) for r in rows)
    return np.array([[_to_float(c) for c in r] + [np.nan] * (width - len(r)) for r in rows],
                    dtype=np.float64)


def _stable_sort(arr: np.ndarray, col: int) -> np.ndarray:
    return arr[np.argsort(arr[:, col], kind="stable")]


def import_table(path: str, header: bool = True, sort_by: str = None) -> np.ndarray:
    """Generic CSV -> float array (ref custom_functions.py:120-126): drops
    all-empty columns, then rows with a missing value."""
    rows = _read_rows(path)
    names = [c.strip() for c in rows[0]] if header else None
    arr = _numeric(rows[1:] if header else rows)
    keep = ~np.all(np.isnan(arr), axis=0)
    arr = arr[:, keep]
    arr = arr[~np.any(np.isnan(arr), axis=1)]
    if sort_by is not None:
        if names is None:
            raise ValueError("sort_by needs a header row")
        cols = [n for n, k in zip(names, keep) if k]
        arr = _stable_sort(arr, cols.index(sort_by))
    return arr


def _table_without_units_row(path: str, sort_by: str) -> np.ndarray:
    rows = _read_rows(path)
    names = [c.strip() for c in rows[0]]
    arr = _numeric(rows[2:])  # row 1 holds the units
    return _stable_sort(arr, names.index(sort_by))


def import_hydrograph(path: str, hr_to_s_conversion: bool = True) -> np.ndarray:
    """(time, flow) table, hours -> seconds (ref custom_functions.py:109-118)."""
    arr = _table_without_units_row(path, "time")
    if hr_to_s_conversion:
        arr[:, 0] *= 3600.0
    return arr


def import_area_curve(path: str) -> np.ndarray:
    """(stage, area) curve with km^2 -> m^2 (ref custom_functions.py:100-107)."""
    arr = _table_without_units_row(path, "stage")[:, :2].copy()
    arr[:, 1] *= 1e6
    return arr


def import_grid_table(path: str):
    """A two-way table: first column the row keys, header row the column
    keys.  Returns (row_keys, col_keys, values[rows, cols]) with NaN for
    empty cells."""
    rows = _read_rows(path)
    col_keys = np.array([_to_float(c) for c in rows[0][1:]], dtype=np.float64)
    body = _numeric(rows[1:])
    return body[:, 0], col_keys, body[:, 1:]


def load_trapezoid_stations(file_path: str, n_main=None, n_fp=None, skip_files=("53.csv",)):
    """Fitted compound-trapezoid stations from composite_trapezoids.csv.

    Mirrors ref custom_functions.py:128-157 (including the hard-coded skip of
    cross-section 53) and returns TrapezoidStation configs for the
    struct-of-tensors geometry constructor.
    """
    rows = _read_rows(file_path)
    names = [c.strip() for c in rows[0]]
    chainages, stations = [], []
    for raw in rows[1:]:
        row = dict(zip(names, (c.strip() for c in raw)))
        if row["file"] in skip_files:
            continue
        chainages.append(float(row["chainage"]))
        stations.append(
            TrapezoidStation(
                z_bed=float(row["z_min"]),
                b_main=float(row["b_main"]),
                m_main=float(row["m_main"]),
                n_main=float(row["n_main"]) if n_main is None else float(n_main),
                h_bank=float(row["h_bankfull"]),
                b_fp_left=float(row["b_fp_left"]),
                b_fp_right=float(row["b_fp_right"]),
                m_fp=float(row["m_fp"]),
                n_left=float(row["n_left"]) if n_fp is None else float(n_fp),
                n_right=float(row["n_right"]) if n_fp is None else float(n_fp),
            )
        )
    return chainages, stations
