"""Row-distribution maps.

JAX analogue of ``Tpetra::Map``
(packages/tpetra/core/src/Tpetra_Map_decl.hpp:246 — the distribution of
global row indices over processes, with GID↔LID translation at :682-:730
and owner lookup via the Directory). Differences, by design:

  * the shard count and local sizes are **static** (compiled into the
    program). Two modes:
      - contiguous **uniform** (``Map.uniform``): owner-of-GID is
        closed-form arithmetic — the reference's
        ContiguousUniformDirectory (src/Tpetra_DirectoryImpl_decl.hpp:209)
        reduced to a divide;
      - contiguous **nonuniform** (``Map.contiguous``): per-shard extents
        ``lows``; owner lookup is a searchsorted over the P+1 boundaries —
        the DistributedContiguousDirectory (:248) reduced to a bisect.
    Arbitrary GID distributions are handled by COMPOSING a permutation
    (``parallel.partition.partition_to_permutation`` + ``permute_csr``)
    with a contiguous map; the ``Directory`` class below packages that
    composition as the reference's noncontiguous GID→(owner,LID) lookup
    (src/Tpetra_DirectoryImpl_decl.hpp:311).
  * every shard carries the same padded local length ``n_local_pad``
    (multiple of the sublane count) — the SPMD uniformity XLA requires.
    Padding rows follow the framework-wide identity-row convention.

A "global padded vector" for Map m is the concatenation of the P padded
local chunks — shape (P * n_local_pad,); helpers translate between that
layout and logical host vectors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.formats import ROW_ALIGN, round_up


@dataclasses.dataclass(frozen=True)
class Map:
    """Contiguous row partition. Uniform mode (``lows is None``): shard s
    owns GIDs [chunk*s, min(chunk*(s+1), n_global)); nonuniform mode:
    shard s owns [lows[s], lows[s+1])."""

    n_global: int
    n_shards: int
    n_local_pad: int
    lows: tuple[int, ...] | None = None  # len P+1 when nonuniform

    @classmethod
    def uniform(cls, n_global: int, n_shards: int,
                align: int = ROW_ALIGN) -> "Map":
        chunk = -(-n_global // n_shards)
        return cls(n_global=n_global, n_shards=n_shards,
                   n_local_pad=round_up(chunk, align))

    @classmethod
    def contiguous(cls, sizes, align: int = ROW_ALIGN) -> "Map":
        """Nonuniform contiguous map from per-shard owned counts."""
        sizes = [int(s) for s in sizes]
        lows = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
        return cls(n_global=lows[-1], n_shards=len(sizes),
                   n_local_pad=round_up(max(max(sizes), 1), align),
                   lows=lows)

    @property
    def chunk(self) -> int:
        return -(-self.n_global // self.n_shards)

    def shard_lo(self, s: int) -> int:
        if self.lows is not None:
            return self.lows[s]
        return min(self.chunk * s, self.n_global)

    def shard_hi(self, s: int) -> int:
        if self.lows is not None:
            return self.lows[s + 1]
        return min(self.chunk * (s + 1), self.n_global)

    def n_owned(self, s: int) -> int:
        return self.shard_hi(s) - self.shard_lo(s)

    def owner_of(self, gids: np.ndarray) -> np.ndarray:
        if self.lows is not None:
            return (np.searchsorted(np.asarray(self.lows), gids,
                                    side="right") - 1).clip(0,
                                                            self.n_shards - 1)
        return np.minimum(np.asarray(gids) // self.chunk, self.n_shards - 1)

    def gid_to_lid(self, gids: np.ndarray, s: int) -> np.ndarray:
        """Local index (into the padded local chunk) of owned GIDs."""
        return np.asarray(gids) - self.shard_lo(s)

    @property
    def n_global_pad(self) -> int:
        return self.n_shards * self.n_local_pad

    # -- host-side layout helpers -----------------------------------------
    def to_padded(self, x: np.ndarray) -> np.ndarray:
        """Host (n_global, ...) → padded sharded layout (P*n_local_pad, ...)."""
        x = np.asarray(x)
        out = np.zeros((self.n_global_pad,) + x.shape[1:], dtype=x.dtype)
        for s in range(self.n_shards):
            lo, hi = self.shard_lo(s), self.shard_hi(s)
            out[s * self.n_local_pad:s * self.n_local_pad + (hi - lo)] = x[lo:hi]
        return out

    def from_padded(self, xp: np.ndarray) -> np.ndarray:
        xp = np.asarray(xp)
        out = np.zeros((self.n_global,) + xp.shape[1:], dtype=xp.dtype)
        for s in range(self.n_shards):
            lo, hi = self.shard_lo(s), self.shard_hi(s)
            out[lo:hi] = xp[s * self.n_local_pad:s * self.n_local_pad + (hi - lo)]
        return out


@dataclasses.dataclass(frozen=True)
class Directory:
    """Distributed GID→(owner, LID) lookup for ARBITRARY row numberings:
    a contiguous Map composed with the renumbering permutation (the role
    of Tpetra's DistributedNoncontiguousDirectory,
    src/Tpetra_DirectoryImpl_decl.hpp:311, realized as a host-side
    permutation instead of a distributed hash table — map construction is
    a host/fillComplete-time activity in this framework).

    ``new_of_old[g]`` = position of original row g in the permuted
    contiguous numbering that ``map`` distributes.
    """

    map: Map
    new_of_old: np.ndarray

    def remote_index_list(self, gids) -> tuple[np.ndarray, np.ndarray]:
        """(owning shard, local index) per original GID — the analogue of
        Tpetra::Map::getRemoteIndexList (src/Tpetra_Map_decl.hpp:730)."""
        new_ids = self.new_of_old[np.asarray(gids, dtype=np.int64)]
        owners = self.map.owner_of(new_ids)
        lids = new_ids - np.asarray([self.map.shard_lo(int(o))
                                     for o in owners])
        return owners, lids
