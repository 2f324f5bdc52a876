"""Binned training dataset — the host data plane of the port.

Re-design of the reference Dataset/DatasetLoader/Metadata (reference:
src/io/dataset.cpp, src/io/dataset_loader.cpp, src/io/metadata.cpp,
include/LightGBM/dataset.h), mirroring the JAX package's io/dataset.py.
Instead of per-feature ``Bin`` objects with virtual push/iterate calls,
the whole dataset is one packed integer ndarray ``bins [num_data,
num_groups]`` (uint8 when every group has <=256 bins) that the tree
learner packs into its planar device state once. Bin finding
(``BinMapper.find_bin``) runs host-side on a bounded sample, exactly like
the reference (bin_construct_sample_cnt, dataset_loader.cpp:527
ConstructFromSampleData).

Exclusive Feature Bundling: sparse near-mutually-exclusive features are
packed into shared bundle columns (io/efb.py; reference
dataset.cpp:50-302), so the device matrix is [N, num_groups] with
num_groups << num_features on sparse data.

scipy CSR/CSC inputs are consumed without densifying the raw floats:
only the bundled bin-code matrix is materialized. With num_machines > 1
in a process group of more than one rank the bin mappers come from the
distributed protocol of io/distributed.py (each rank bins its share of
the features, the mappers are all-gathered), bit-identical to
single-machine construction.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import network
from ..config import Config
from ..utils import log
from .binning import BinMapper
from .distributed import distributed_find_bin_mappers, find_bins_for_features
from .efb import BundleTables, build_bundles, bundle_eligible


def _is_sparse(data) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:
        return False
    return sp.issparse(data)


def _csc_col(data, f: int):
    """(row_indices, values) of column ``f`` of a CSC matrix — the only
    sparse access pattern the data plane needs (reference sparse_bin.hpp
    iterates per-feature nonzeros the same way)."""
    start, end = data.indptr[f], data.indptr[f + 1]
    return data.indices[start:end], data.data[start:end]


def _reject_inf_feature(vals: np.ndarray, names, f: int) -> None:
    """±Inf feature values corrupt bin boundaries and flow silently into
    histogram sums; reject at construction, naming the column. NaN stays
    legal — it is the missing-value representation."""
    inf = np.isinf(vals)
    if inf.any():
        log.fatal(
            "Feature '%s' (column %d) contains %d infinite value(s); "
            "replace them with NaN (missing) or clip to a finite range",
            names[f] if f < len(names) else str(f), f, int(inf.sum()))


class Metadata:
    """Per-row training metadata (reference: src/io/metadata.cpp):
    label, weights, query boundaries, init scores."""

    def __init__(self, num_data: int) -> None:
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None

    def set_label(self, label: Optional[np.ndarray]) -> None:
        if label is None:
            self.label = None
            return
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            log.fatal("Length of label (%d) != num_data (%d)", len(label),
                      self.num_data)
        bad = ~np.isfinite(label)
        if bad.any():
            log.fatal(
                "Label contains %d non-finite value(s) (NaN/Inf), first "
                "at row %d; clean the label column before constructing "
                "the Dataset", int(bad.sum()), int(np.flatnonzero(bad)[0]))
        self.label = label

    def set_weights(self, weights: Optional[np.ndarray]) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).reshape(-1)
        if len(weights) != self.num_data:
            log.fatal("Length of weights (%d) != num_data (%d)",
                      len(weights), self.num_data)
        self.weights = weights

    def set_init_score(self, init_score: Optional[np.ndarray]) -> None:
        if init_score is None:
            self.init_score = None
            return
        init_score = np.asarray(init_score, dtype=np.float64).reshape(
            -1, order="F")
        if len(init_score) % self.num_data != 0:
            log.fatal("Length of init_score is not a multiple of num_data")
        if not np.isfinite(init_score).all():
            log.fatal("init_score contains non-finite values; scores must "
                      "be finite")
        self.init_score = init_score

    def set_query(self, group: Optional[np.ndarray]) -> None:
        """``group``: per-query sizes (the reference's group field), kept
        as boundaries (reference metadata.cpp query_boundaries_)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        if group.sum() != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)",
                      int(group.sum()), self.num_data)
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(group)]).astype(np.int32)

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)


class BinnedDataset:
    """The constructed training dataset: packed bin codes + metadata.

    ``bins`` is [num_data, num_groups] int, ``bin_mappers`` holds
    per-used-feature mappers, ``real_feature_index`` maps used-feature ->
    original column (reference used_feature_map_ inverse).
    """

    def __init__(self) -> None:
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bins: Optional[np.ndarray] = None  # [N, G] group bin codes
        self.bin_mappers: List[BinMapper] = []
        self.real_feature_index: List[int] = []  # used idx -> original idx
        self.inner_feature_index: Dict[int, int] = {}
        self.feature_names: List[str] = []
        self.metadata: Metadata = Metadata(0)
        self.max_bin: int = 255
        self.bundles: Optional[BundleTables] = None  # None == identity
        self._monotone_constraints: List[int] = []
        # construct-time row-occupancy statistics (ops/multival.py)
        # read by the histogram-layout decision; None until a bin matrix
        # exists
        self.occupancy = None

    # ------------------------------------------------------------------
    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    @property
    def num_bins_per_feature(self) -> np.ndarray:
        return np.asarray([m.num_bin for m in self.bin_mappers],
                          dtype=np.int32)

    @property
    def max_num_bin(self) -> int:
        return int(self.num_bins_per_feature.max()) if self.bin_mappers else 1

    # --- EFB views --------------------------------------------------------
    @property
    def efb_trivial(self) -> bool:
        return self.bundles is None or self.bundles.is_trivial

    @property
    def group_max_bins(self) -> int:
        """Max bin-code count over the physical bundle columns (== max
        feature num_bin when bundling is trivial)."""
        if self.efb_trivial:
            return self.max_num_bin
        return int(self.bundles.group_num_bins.max())

    def device_bins(self, device) -> torch.Tensor:
        """The row-major [N, G] bin codes on ``device``: uint8, or int32
        for wider codes (torch gathers no uint16)."""
        b = self.bins
        # tpulint: sync-ok(once: FusedSerialGrower.bins_device caches the upload)
        return torch.as_tensor(np.ascontiguousarray(
            b if b.dtype == np.uint8 else b.astype(np.int32)), device=device)

    def device_bundle_tables(self, device):
        """(group_of, offset_of, nslots_of, skip_of) int32 tensors on
        ``device``, or None when bundling is trivial (consumers then
        index features directly)."""
        if self.efb_trivial:
            return None
        return self.bundles.device(device)

    def device_hist_tables(self, device):
        """Gather tables for bundle-hist → per-feature-hist conversion,
        or None when bundling is trivial."""
        if self.efb_trivial:
            return None
        return self.bundles.hist_tables(
            [m.num_bin for m in self.bin_mappers], self.max_num_bin, device)

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[np.ndarray] = None,
                    weight: Optional[np.ndarray] = None,
                    group: Optional[np.ndarray] = None,
                    init_score: Optional[np.ndarray] = None,
                    feature_names: Optional[Sequence[str]] = None,
                    categorical_feature: Optional[Sequence[int]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Construct from a raw row-major matrix: dense, or scipy CSR /
        CSC.

        Mirrors LGBM_DatasetCreateFromMat ->
        DatasetLoader::ConstructFromSampleData: sample rows, find bins per
        feature, then push all rows through the mappers. ``reference``
        aligns bin mappers (and bundles) with a previously constructed
        dataset (validation data; reference Dataset::CreateValid).
        """
        sparse_input = _is_sparse(data)
        data_csr = None
        if sparse_input:
            import scipy.sparse as sp
            # keep the CSR form (when that is what arrived) for the
            # row-sampling step below
            if sp.isspmatrix_csr(data):
                data_csr = data
            data = data.tocsc() if not sp.isspmatrix_csc(data) else data
        else:
            data = np.asarray(data)
            if data.ndim != 2:
                log.fatal("Data must be 2-dimensional")
        n, total_features = data.shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = total_features
        ds.metadata = Metadata(n)
        ds.metadata.set_label(label)
        ds.metadata.set_weights(weight)
        ds.metadata.set_query(group)
        ds.metadata.set_init_score(init_score)
        ds.max_bin = config.max_bin

        if feature_names is None:
            feature_names = [f"Column_{i}" for i in range(total_features)]
        ds.feature_names = list(feature_names)

        if reference is not None:
            ds.bin_mappers = reference.bin_mappers
            ds.real_feature_index = reference.real_feature_index
            ds.inner_feature_index = reference.inner_feature_index
            ds.feature_names = reference.feature_names
            ds.max_bin = reference.max_bin
            ds._monotone_constraints = reference._monotone_constraints
            ds.bundles = reference.bundles
            ds._apply_mappers(data)
            return ds

        if categorical_feature is None:
            categorical_feature = _parse_categorical(
                config.categorical_feature, ds.feature_names)
        cat_set = set(categorical_feature or [])

        # --- sampling for bin finding (dataset_loader.cpp:120-165) ---
        sample_cnt = min(config.bin_construct_sample_cnt, n)
        rng = np.random.RandomState(config.data_random_seed)
        if sample_cnt < n:
            sample_idx = np.sort(rng.choice(n, size=sample_cnt, replace=False))
            if sparse_input:
                rows = data_csr if data_csr is not None else data.tocsr()
                sample = rows[sample_idx].tocsc()
            else:
                sample = data[sample_idx]
        else:
            sample = data
        if not sparse_input:
            sample = np.asarray(sample, dtype=np.float64)

        def sample_col_nonzeros(f):
            """(row_indices, values) of the sample column's stored
            entries — the full column for dense input."""
            if sparse_input:
                idx, vals = _csc_col(sample, f)
                return idx, np.asarray(vals, dtype=np.float64)
            return np.arange(sample_cnt), sample[:, f]

        # --- per-feature bin finding (DatasetLoader::ConstructBinMappers) ---
        if config.num_machines > 1 and network.is_active():
            # the distributed protocol (reference dataset_loader.cpp:
            # 917-990): each rank bins its own features over the whole
            # sample, then the mappers are all-gathered
            mappers = distributed_find_bin_mappers(sample, config, cat_set)
        else:
            mappers = [m for _, m in find_bins_for_features(
                sample, range(total_features), config, sample_cnt, cat_set,
                pre_filter=config.feature_pre_filter)]

        used = [f for f in range(total_features) if not mappers[f].is_trivial]
        if not used:
            log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        ds.bin_mappers = [mappers[f] for f in used]
        ds.real_feature_index = used
        ds.inner_feature_index = {f: i for i, f in enumerate(used)}
        if config.monotone_constraints:
            ds._monotone_constraints = [
                config.monotone_constraints[f]
                if f < len(config.monotone_constraints) else 0
                for f in used]

        # --- EFB bundling decision over the sample (dataset.cpp:50-302) ---
        if config.enable_bundle and len(used) > 1:
            nonzero_rows: List[np.ndarray] = []
            bundle_ok: List[bool] = []
            empty = np.empty(0, dtype=np.int64)
            for i, f in enumerate(used):
                m = ds.bin_mappers[i]
                ok = bundle_eligible(m) and m.sparse_rate >= 0.5
                bundle_ok.append(ok)
                if not ok:
                    nonzero_rows.append(empty)
                    continue
                idx, vals = sample_col_nonzeros(f)
                b = m.values_to_bins(vals)
                nonzero_rows.append(np.asarray(idx)[b != m.most_freq_bin])
            ds.bundles = build_bundles(
                nonzero_rows, ds.bin_mappers, sample_cnt, True,
                bundle_ok=bundle_ok,
                max_bundle_bins=config.efb_max_bundle_bins,
                max_conflict_rate=config.efb_max_conflict_rate)
            if ds.bundles.is_trivial:
                ds.bundles = None
        ds._apply_mappers(data)
        return ds

    def _apply_mappers(self, data) -> None:
        """Push every row through the mappers into the packed bin-code
        matrix: [N, F_used] per-feature codes when bundling is trivial,
        [N, num_groups] bundle codes otherwise (reference
        FeatureGroup::PushData / Bin::Push; sparse inputs touch only
        their stored entries)."""
        n = data.shape[0]
        sparse = _is_sparse(data)
        mappers = self.bin_mappers
        bt = self.bundles

        def col_bins(i: int):
            """(row_indices_or_None, codes) for used feature i; None row
            indices mean 'all rows, in order'."""
            f = self.real_feature_index[i]
            if sparse:
                idx, vals = _csc_col(data, f)
                vals = np.asarray(vals, dtype=np.float64)
                _reject_inf_feature(vals, self.feature_names, f)
                return idx, mappers[i].values_to_bins(vals)
            col = np.asarray(data[:, f], dtype=np.float64)
            _reject_inf_feature(col, self.feature_names, f)
            return None, mappers[i].values_to_bins(col)

        def put(bins, g: int, i: int) -> None:
            idx, codes = col_bins(i)
            if idx is None:
                bins[:, g] = codes.astype(bins.dtype)
            else:
                bins[:, g] = bins.dtype.type(mappers[i].value_to_bin(0.0))
                bins[idx, g] = codes.astype(bins.dtype)

        if bt is None or bt.is_trivial:
            f_used = len(mappers)
            dtype = np.uint8 if all(m.num_bin <= 256 for m in mappers) \
                else np.uint16
            bins = np.empty((n, f_used), dtype=dtype)
            for i in range(f_used):
                put(bins, i, i)
        else:
            dtype = np.uint8 if int(bt.group_num_bins.max()) <= 256 \
                else np.uint16
            bins = np.empty((n, bt.num_groups), dtype=dtype)
            for g, members in enumerate(bt.groups):
                if len(members) == 1:
                    put(bins, g, members[0])
                else:
                    # shared column: code 0 = every member at its
                    # most-frequent bin; later members overwrite on the
                    # (conflict-budgeted) overlapping rows
                    code = np.zeros(n, dtype=dtype)
                    for i in members:
                        idx, codes = col_bins(i)
                        mfb = bt.skip_of[i]
                        keep = codes != mfb
                        rows = np.flatnonzero(keep) if idx is None \
                            else idx[keep]
                        b = codes[keep]
                        slot = b - (b > mfb)
                        code[rows] = (bt.offset_of[i] + slot).astype(dtype)
                    bins[:, g] = code
        self.bins = bins
        self.num_data = n
        self._measure_occupancy()

    def _measure_occupancy(self) -> None:
        """Record construct-time row-occupancy statistics for the
        histogram-layout decision (ops/histogram.py hist_layout)."""
        self.occupancy = None
        if self.bins is None or self.bins.size == 0:
            return
        from ..ops.multival import measure_occupancy
        self.occupancy = measure_occupancy(self.bins)

    # ------------------------------------------------------------------
    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None) -> "BinnedDataset":
        return BinnedDataset.from_matrix(
            data, Config(), label=label, weight=weight, group=group,
            init_score=init_score, reference=self)

    def feature_bins(self) -> np.ndarray:
        """The per-feature bin matrix [N, F_used] on the host: ``bins``
        itself without bundling, else each feature's codes decoded out
        of its bundle column (``Dataset.add_features_from``)."""
        if self.efb_trivial:
            return self.bins
        bt = self.bundles
        f_used = len(self.bin_mappers)
        dtype = (np.uint8 if all(m.num_bin <= 256 for m in self.bin_mappers)
                 else np.uint16)
        out = np.empty((self.num_data, f_used), dtype=dtype)
        for f in range(f_used):
            codes = self.bins[:, bt.group_of[f]].astype(np.int32)
            rel = codes - bt.offset_of[f]
            inband = (rel >= 0) & (rel < bt.nslots_of[f])
            dec = rel + (rel >= bt.skip_of[f])
            out[:, f] = np.where(inband, dec, bt.skip_of[f]).astype(dtype)
        return out

    # --- binary file (reference Dataset::SaveBinaryFile, dataset.cpp:890)
    def save_binary(self, filename: str) -> None:
        """The JAX package's ``LGTPU1`` file: a JSON header (mappers,
        bundle groups, the codes' dtype), then the [N, G] bin codes
        every device layout is built from (the planar code planes and
        the multi-value slot planes alike), then the metadata."""
        header = {
            "num_data": self.num_data,
            "num_total_features": self.num_total_features,
            "real_feature_index": self.real_feature_index,
            "feature_names": self.feature_names,
            "max_bin": self.max_bin,
            "monotone_constraints": self._monotone_constraints,
            "bin_mappers": [m.to_dict() for m in self.bin_mappers],
            "bundle_groups": None if self.efb_trivial else self.bundles.groups,
            "bins_dtype": str(self.bins.dtype),
            "has_label": self.metadata.label is not None,
            "has_weights": self.metadata.weights is not None,
            "has_query": self.metadata.query_boundaries is not None,
            "has_init_score": self.metadata.init_score is not None,
        }
        md = self.metadata
        with open(filename, "wb") as fh:
            hdr = json.dumps(header).encode()
            fh.write(b"LGTPU1\n")
            fh.write(len(hdr).to_bytes(8, "little"))
            fh.write(hdr)
            fh.write(self.bins.tobytes())
            if md.label is not None:
                fh.write(md.label.astype(np.float32).tobytes())
            if md.weights is not None:
                fh.write(md.weights.astype(np.float32).tobytes())
            if md.query_boundaries is not None:
                qb = md.query_boundaries.astype(np.int32)
                fh.write(len(qb).to_bytes(8, "little"))
                fh.write(qb.tobytes())
            if md.init_score is not None:
                isc = md.init_score.astype(np.float64)
                fh.write(len(isc).to_bytes(8, "little"))
                fh.write(isc.tobytes())

    @classmethod
    def load_binary(cls, filename: str) -> "BinnedDataset":
        """A dataset from a ``save_binary`` file (either package's)."""
        with open(filename, "rb") as fh:
            if fh.readline() != b"LGTPU1\n":
                log.fatal("%s is not a lightgbm_tpu binary dataset file",
                          filename)
            hdr_len = int.from_bytes(fh.read(8), "little")
            header = json.loads(fh.read(hdr_len).decode())
            ds = cls()
            ds.num_data = n = header["num_data"]
            ds.num_total_features = header["num_total_features"]
            ds.real_feature_index = list(header["real_feature_index"])
            ds.inner_feature_index = {f: i for i, f in
                                      enumerate(ds.real_feature_index)}
            ds.feature_names = list(header["feature_names"])
            ds.max_bin = header["max_bin"]
            ds._monotone_constraints = list(header["monotone_constraints"])
            ds.bin_mappers = [BinMapper.from_dict(d)
                              for d in header["bin_mappers"]]
            groups = header.get("bundle_groups")
            if groups:
                ds.bundles = BundleTables(
                    [list(g) for g in groups],
                    [m.num_bin for m in ds.bin_mappers],
                    [m.most_freq_bin for m in ds.bin_mappers])
            dtype = np.dtype(header["bins_dtype"])
            g = len(groups) if groups else len(ds.bin_mappers)
            ds.bins = np.frombuffer(fh.read(n * g * dtype.itemsize),
                                    dtype=dtype).reshape(n, g).copy()
            ds.metadata = md = Metadata(n)

            def read(dt, count):
                return np.frombuffer(fh.read(np.dtype(dt).itemsize * count),
                                     dtype=dt).copy()
            if header["has_label"]:
                md.label = read(np.float32, n)
            if header["has_weights"]:
                md.weights = read(np.float32, n)
            if header["has_query"]:
                md.query_boundaries = read(
                    np.int32, int.from_bytes(fh.read(8), "little"))
            if header["has_init_score"]:
                md.init_score = read(
                    np.float64, int.from_bytes(fh.read(8), "little"))
        ds._measure_occupancy()
        return ds

    def monotone_constraint(self, inner_feature: int) -> int:
        if not self._monotone_constraints:
            return 0
        return self._monotone_constraints[inner_feature]


def _parse_categorical(spec: Union[str, List[int], List[str], None],
                       feature_names: Sequence[str]) -> List[int]:
    """Resolve Config.categorical_feature (indices, names, or 'name:a,b' /
    '0,1,2' strings) to column indices."""
    if spec is None:
        return []
    if isinstance(spec, str):
        s = spec.strip()
        if not s:
            return []
        items: List[Any] = [x for x in (s[5:] if s.startswith("name:") else s)
                            .split(",") if x]
    else:
        items = list(spec)
    out: List[int] = []
    name_index = {nm: i for i, nm in enumerate(feature_names)}
    for it in items:
        if isinstance(it, str) and not it.lstrip("-").isdigit():
            if it in name_index:
                out.append(name_index[it])
            else:
                log.warning("Unknown categorical feature name %s, ignored", it)
        else:
            out.append(int(it))
    return out
