"""Text data loading (CSV/TSV/LibSVM with auto-detection).

Host-side equivalent of the reference parser stack (reference:
src/io/parser.cpp:262 CreateParser with format auto-detection by line
inspection, src/io/parser.hpp CSVParser:18 / TSVParser:55 /
LibSVMParser:91, and DatasetLoader label/weight/group/ignore column
handling, src/io/dataset_loader.cpp:167-260). Robustness mirrors the
reference's Atof/field handling: quoted fields, NA strings ("na",
"nan", "null", "none", empty), name:-addressed columns against the
header, inf values. CSV/TSV rides pandas' C parser (the host-side
equivalent of the reference's hand-rolled C++ parser); LibSVM parses
to scipy CSR so sparse files feed the EFB data plane without
densifying. The port's copy of the JAX package's io/text_loader.py;
without pandas the CSV/TSV route is the ``csv`` module's.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log

NA_STRINGS = ["", "na", "nan", "null", "none", "n/a", "NA", "NaN", "NAN",
              "Null", "NULL", "None", "NONE", "N/A", "?"]


def _detect_format(lines: List[str]) -> str:
    """reference Parser::CreateParser line inspection (parser.cpp:262):
    colon-separated index:value tokens mean LibSVM; else the delimiter
    with the most columns wins."""
    sample = [ln for ln in lines if ln.strip()]
    if not sample:
        return "csv"

    def libsvm_verdict(ln: str):
        """True / False / None (a bare label line is compatible with
        LibSVM — rows can be all-default — but is no evidence)."""
        toks = ln.replace("\t", " ").split()
        if len(toks) == 1:
            try:
                float(toks[0])
                return None
            except ValueError:
                return False
        pairs = [t for t in toks[1:] if ":" in t]
        ok = 0
        for t in pairs:
            k, _, v = t.partition(":")
            try:
                int(k), float(v)
                ok += 1
            except ValueError:
                return False
        return ok > 0

    verdicts = [libsvm_verdict(ln) for ln in sample]
    if any(v is True for v in verdicts) and not any(v is False
                                                    for v in verdicts):
        return "libsvm"
    tabs = sample[-1].count("\t")
    commas = sample[-1].count(",")
    return "tsv" if tabs >= commas and tabs > 0 else "csv"


def _resolve_column(spec: str, header_names: Optional[Sequence[str]],
                    default: int = -1, what: str = "column",
                    label_col: Optional[int] = None) -> int:
    """label_column/weight_column/group_column spec -> raw file column
    (reference config.h: int index or 'name:<column>'). Integer specs
    for non-label columns do NOT count the label column (reference
    parser semantics / docs: 'it doesn't count the label column'), so
    they shift past it; name: specs address the file directly."""
    if spec == "":
        return default
    if spec.startswith("name:"):
        name = spec[5:]
        if header_names and name in header_names:
            return list(header_names).index(name)
        log.fatal("Could not find %s %s in data file header", what, name)
    try:
        idx = int(spec)
    except ValueError:
        log.fatal("Invalid %s specifier %r (use an index or name:<col>)",
                  what, spec)
        return default
    if label_col is not None and idx >= label_col >= 0:
        idx += 1
    return idx


def _resolve_ignore(spec: str, header_names,
                    label_col: Optional[int] = None) -> List[int]:
    """Comma list of ignore columns through the same resolution as the
    single-column specs (missing names are fatal, like the reference's
    DatasetLoader ignore handling; int indices don't count the label)."""
    if not spec:
        return []
    named = spec.startswith("name:")
    items = (spec[5:] if named else spec).split(",")
    return [_resolve_column("name:" + it.strip() if named else it.strip(),
                            header_names, -1, "ignore_column", label_col)
            for it in items if it.strip()]


def _group_sizes_from_query_ids(qids: np.ndarray) -> np.ndarray:
    """A query-id column becomes per-query sizes: consecutive equal ids
    form one group (reference metadata.cpp query handling)."""
    if len(qids) == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(np.diff(qids) != 0)
    bounds = np.concatenate([[-1], change, [len(qids) - 1]])
    return np.diff(bounds).astype(np.int64)


def load_text_file(path: str, config: Config):
    """Returns (matrix, label, weight, group, init_score); matrix is
    dense ndarray for CSV/TSV, scipy CSR for LibSVM (when scipy is
    available)."""
    with open(path) as fh:
        head = [fh.readline() for _ in range(3)]
    fmt = _detect_format(head)

    header_names = None
    skip = 0
    if config.header:
        delim = "\t" if fmt != "csv" else ","
        header_names = [t.strip().strip('"') for t in
                        head[0].strip().split(delim)]
        skip = 1

    if fmt == "libsvm":
        mat, label = _load_libsvm(path, skip)
        weight = None
        group = None
    else:
        delim = "\t" if fmt == "tsv" else ","
        try:
            import pandas as pd
            df = pd.read_csv(path, sep=delim, header=None, skiprows=skip,
                             na_values=NA_STRINGS, keep_default_na=True,
                             quotechar='"', skip_blank_lines=True,
                             comment=None)
            raw = np.empty(df.shape, dtype=np.float64)
            for i, col in enumerate(df.columns):
                raw[:, i] = pd.to_numeric(df[col], errors="coerce")
            n_bad = int(np.all(np.isnan(raw), axis=0).sum())
            if n_bad == raw.shape[1] and raw.size:
                log.fatal("Could not parse any numeric column from %s "
                          "(wrong delimiter or header=true missing?)", path)
        except ImportError:
            raw = _parse_delimited_fallback(path, delim, skip)
        if raw.ndim == 1:
            raw = raw.reshape(-1, 1)
        label_col = _resolve_column(config.label_column, header_names, 0,
                                    "label_column")
        weight_col = _resolve_column(config.weight_column, header_names,
                                     -1, "weight_column", label_col)
        group_col = _resolve_column(config.group_column, header_names,
                                    -1, "group_column", label_col)
        drop = set(_resolve_ignore(config.ignore_column, header_names,
                                   label_col))
        drop.update(c for c in (label_col, weight_col, group_col) if c >= 0)
        cols = [c for c in range(raw.shape[1]) if c not in drop]
        label = raw[:, label_col] if label_col >= 0 else None
        weight = raw[:, weight_col] if weight_col >= 0 else None
        group = (_group_sizes_from_query_ids(raw[:, group_col])
                 if group_col >= 0 else None)
        mat = raw[:, cols]

    # sidecar files override inline columns (reference
    # dataset_loader.cpp LoadQueryBoundaries / SetWeights)
    qpath = path + ".query"
    if os.path.exists(qpath):
        group = np.loadtxt(qpath, dtype=np.int64).reshape(-1)
    wpath = path + ".weight"
    if os.path.exists(wpath):
        weight = np.loadtxt(wpath, dtype=np.float64).reshape(-1)
    # initial scores: "<data>.init" (or the initscore_filename override,
    # reference config "initscore_filename"), one row per data row, one
    # column per class (reference metadata.cpp:389-430 LoadInitialScore;
    # class-major flattening like Metadata::init_score_)
    init_score = None
    ipath = config.initscore_filename or (path + ".init")
    if os.path.exists(ipath):
        isc = np.loadtxt(ipath, dtype=np.float64, ndmin=2)
        init_score = isc.T.reshape(-1)  # [num_class * n], class-major
        log.info("Loading initial scores...")
    return mat, label, weight, group, init_score


def _parse_delimited_fallback(path: str, delim: str, skip: int) -> np.ndarray:
    """csv-module fallback (quoted fields + NA strings) when pandas is
    unavailable."""
    import csv

    na = set(s.lower() for s in NA_STRINGS)
    rows = []
    with open(path, newline="") as fh:
        reader = csv.reader(fh, delimiter=delim, quotechar='"')
        for i, rec in enumerate(reader):
            if i < skip or not rec:
                continue
            vals = []
            for tok in rec:
                t = tok.strip()
                if t.lower() in na:
                    vals.append(np.nan)
                    continue
                try:
                    vals.append(float(t))
                except ValueError:
                    vals.append(np.nan)
            rows.append(vals)
    width = max((len(r) for r in rows), default=0)
    mat = np.full((len(rows), width), np.nan)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = r
    return mat


def _load_libsvm(path: str, skip: int):
    """LibSVM '<label> <idx>:<val> ...' -> (CSR matrix, labels); rows
    with malformed pairs fail loudly with the line number (reference
    parser.hpp LibSVMParser)."""
    labels = []
    data, indices, indptr = [], [], [0]
    max_feat = -1
    with open(path) as fh:
        for i, line in enumerate(fh):
            if i < skip:
                continue
            toks = line.strip().split()
            if not toks:
                continue
            try:
                labels.append(float(toks[0]))
            except ValueError:
                log.fatal("Line %d of %s: bad label %r", i + 1, path,
                          toks[0])
            for t in toks[1:]:
                if ":" not in t:
                    continue
                k, _, v = t.partition(":")
                try:
                    k = int(k)
                    val = float(v)
                except ValueError:
                    log.fatal("Line %d of %s: bad feature pair %r",
                              i + 1, path, t)
                indices.append(k)
                data.append(val)
                max_feat = max(max_feat, k)
            indptr.append(len(data))
    try:
        import scipy.sparse as sp
        mat = sp.csr_matrix(
            (np.asarray(data, dtype=np.float64),
             np.asarray(indices, dtype=np.int64),
             np.asarray(indptr, dtype=np.int64)),
            shape=(len(labels), max_feat + 1))
    except ImportError:
        mat = np.zeros((len(labels), max_feat + 1), dtype=np.float64)
        for r in range(len(labels)):
            s, e = indptr[r], indptr[r + 1]
            mat[r, indices[s:e]] = data[s:e]
    return mat, np.asarray(labels)
