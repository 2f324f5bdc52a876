"""Distributed dataset construction: bin finding split over the ranks.

The port of the JAX package's io/distributed.py (reference:
src/io/dataset_loader.cpp:917-990 ConstructBinMappersFromTextData: with
num_machines > 1 the features are partitioned across machines, each
machine finds the bin boundaries of its own features, and the
serialized BinMappers ride a Network::Allgather at :984, so every
machine ends with the same full mapper set).

Here a rank of the default process group plays a machine: it bins the
features it owns (``partition_features``), serializes the mappers into
a byte buffer, and the buffers of every rank ride one ``all_gather``
over the group (``allgather_bytes``). As in the JAX package, every rank
holds the whole sample and bins its features over all of it, so the
mappers are bit-identical to single-machine construction; without a
group, io/dataset.py bins every feature itself through
``find_bins_for_features``.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import network
from ..config import Config
from ..utils import log
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, K_ZERO_THRESHOLD, BinMapper


def partition_features(num_features: int, world: int,
                       workload: Optional[Sequence[int]] = None
                       ) -> List[List[int]]:
    """Workload-balanced assignment of features to ranks, largest
    first, each rank's list sorted (the JAX package's greedy)."""
    if workload is None:
        workload = [1] * num_features
    order = sorted(range(num_features), key=lambda f: -workload[f])
    loads = [0] * world
    owned: List[List[int]] = [[] for _ in range(world)]
    for f in order:
        r = int(np.argmin(loads))
        owned[r].append(f)
        loads[r] += workload[f]
    for lst in owned:
        lst.sort()
    return owned


def find_bins_for_features(sample, features: Sequence[int],
                           config: Config, total_sample_cnt: int,
                           cat_set=frozenset(), pre_filter: bool = False
                           ) -> List[Tuple[int, BinMapper]]:
    """Host-side bin finding for a feature subset over a sample
    (reference BinMapper::FindBin). ``sample`` may be a scipy CSC
    matrix: a column's stored values are the dense column less its
    structural zeros, which the |value| > kZeroThreshold filter drops
    anyway, so the boundaries equal the dense path's."""
    is_sparse = hasattr(sample, "getformat")
    if is_sparse and sample.getformat() != "csc":
        sample = sample.tocsc()
    out = []
    for f in features:
        if is_sparse:
            col = np.asarray(
                sample.data[sample.indptr[f]:sample.indptr[f + 1]],
                dtype=np.float64)
        else:
            col = np.asarray(sample[:, f], dtype=np.float64)
        nonzero = col[(np.abs(col) > K_ZERO_THRESHOLD) | np.isnan(col)]
        m = BinMapper()
        mb = (config.max_bin_by_feature[f]
              if config.max_bin_by_feature
              and f < len(config.max_bin_by_feature)
              else config.max_bin)
        m.find_bin(nonzero, total_sample_cnt, mb,
                   min_data_in_bin=config.min_data_in_bin,
                   min_split_data=config.min_data_in_leaf,
                   pre_filter=pre_filter,
                   bin_type=BIN_CATEGORICAL if f in cat_set else BIN_NUMERICAL,
                   use_missing=config.use_missing,
                   zero_as_missing=config.zero_as_missing)
        out.append((f, m))
    return out


def serialize_mappers(pairs: List[Tuple[int, BinMapper]],
                      pad_to: Optional[int] = None) -> np.ndarray:
    """(feature, mapper) list -> uint8 buffer: an int64 length header,
    then the JSON of the mappers (the boundaries, not the data)."""
    payload = json.dumps([(f, m.to_dict()) for f, m in pairs]).encode()
    buf = np.frombuffer(payload, dtype=np.uint8)
    header = np.frombuffer(np.int64(len(buf)).tobytes(), dtype=np.uint8)
    out = np.concatenate([header, buf])
    if pad_to is not None:
        if len(out) > pad_to:
            raise ValueError(f"serialized mappers ({len(out)}B) exceed "
                             f"buffer ({pad_to}B)")
        out = np.pad(out, (0, pad_to - len(out)))
    return out


def deserialize_mappers(buf: np.ndarray) -> List[Tuple[int, BinMapper]]:
    n = int(np.frombuffer(bytes(buf[:8]), dtype=np.int64)[0])
    payload = bytes(buf[8:8 + n])
    return [(int(f), BinMapper.from_dict(d))
            for f, d in json.loads(payload.decode())]


def allgather_bytes(buf: np.ndarray) -> np.ndarray:
    """This rank's uint8 buffer -> [world, L] uint8, row r from rank r,
    on every rank (the stand-in for Network::Allgather,
    dataset_loader.cpp:984). The buffers are padded to one size (the
    largest, rounded up to 128 bytes) and gathered with ``all_gather``
    over the default group."""
    dev = network.comm_device()
    n = torch.tensor([len(buf)], dtype=torch.int64, device=dev)
    pad = -(-int(network.pmax(n).item()) // 128) * 128
    t = torch.zeros(pad, dtype=torch.uint8, device=dev)
    t[:len(buf)] = torch.as_tensor(np.ascontiguousarray(buf), device=dev)
    return network.all_gather(t).cpu().numpy()


def construct_bin_mappers_distributed(
        local_sample, rank: int, world: int, config: Config,
        cat_set=frozenset(), total_sample_cnt: Optional[int] = None,
        pre_filter: bool = False) -> List[Tuple[int, BinMapper]]:
    """One rank's local half of the protocol: the (feature, mapper)
    pairs of the features this rank owns, binned over its sample. The
    collective half is ``serialize_mappers`` -> ``allgather_bytes`` ->
    ``merge_gathered_mappers``."""
    f_total = local_sample.shape[1]
    owned = partition_features(f_total, world)[rank]
    total = total_sample_cnt or int(local_sample.shape[0])
    return find_bins_for_features(local_sample, owned, config, total,
                                  cat_set, pre_filter=pre_filter)


def merge_gathered_mappers(gathered: np.ndarray,
                           f_total: int) -> List[BinMapper]:
    """[world, L] buffers -> the full mapper list in feature order."""
    mappers: List[Optional[BinMapper]] = [None] * f_total
    for r in range(gathered.shape[0]):
        for f, m in deserialize_mappers(gathered[r]):
            mappers[f] = m
    missing = [f for f, m in enumerate(mappers) if m is None]
    if missing:
        log.fatal("Distributed bin finding left features without "
                  "mappers: %s", missing)
    return mappers


def distributed_find_bin_mappers(sample, config: Config,
                                 cat_set=frozenset()) -> List[BinMapper]:
    """The num_machines > 1 construction protocol over the default
    process group (reference ConstructBinMappersFromTextData,
    dataset_loader.cpp:917-990): the features are partitioned over the
    ranks, each rank bins its own over the whole sample, the serialized
    mappers are all-gathered, and every rank merges the same full
    set."""
    n, f_total = sample.shape
    pairs = construct_bin_mappers_distributed(
        sample, network.rank(), network.world_size(), config, cat_set,
        total_sample_cnt=n, pre_filter=config.feature_pre_filter)
    return merge_gathered_mappers(
        allgather_bytes(serialize_mappers(pairs)), f_total)
