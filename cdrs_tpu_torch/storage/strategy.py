"""Storage strategies: category -> {replicate(rf) | ec(k, m)} x tier, the
port of ``cdrs_tpu/storage/strategy.py`` (host numpy, the same names,
arithmetic and messages).

* ``replicate(rf)``: rf full copies on rf distinct nodes; one live copy
  reads or re-replicates the file.
* ``ec(k, m)``: k data plus m parity shards of ``ceil(size / k)`` bytes
  each on k + m distinct nodes, spread across failure domains like
  replicas.  Any k live shards reconstruct the file: the stripe is lost
  below k live shards and at risk at exactly k reachable.  It stores
  ``(k + m) / k`` x the raw bytes, but rebuilding one shard reads k
  shards, and a read whose primary shard is down gathers k shards.

Every strategy sits on a storage tier (hot/warm/cold) with a relative byte
cost and a throughput factor.  The stack consumes three integers per
category (``StrategyVectors``):

=============  ==============  =========================
               replicate(rf)   ec(k, m)
=============  ==============  =========================
n_shards       rf              k + m
min_live       1               k
shard_div      1               k   (shard = ceil(size/div))
=============  ==============  =========================

so a config of replicate strategies only is the rf semantics bit for bit,
and ``ec(1, m)`` normalizes to ``ec_k = 0``, which makes it
``replicate(m + 1)`` end to end.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

__all__ = ["StorageTier", "Strategy", "StorageConfig", "StrategyVectors",
           "DEFAULT_TIERS", "storage_config_from_dict",
           "load_storage_config", "resolve_storage_config"]


@dataclass(frozen=True)
class StorageTier:
    """One storage medium class: relative cost and speed."""

    name: str
    #: Relative cost per stored byte (hot disk/flash = 1.0).  The cost
    #: digest multiplies stored bytes by this — a dimensionless "cost
    #: unit" that makes EC-cold vs replicate-hot comparable.
    byte_cost: float = 1.0
    #: Throughput factor in (0, 1] relative to the hot tier: reads of a
    #: file on this tier are served ``1/throughput`` x slower (the
    #: serve router's tier penalty).
    throughput: float = 1.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("storage tier needs a name")
        if self.byte_cost <= 0:
            raise ValueError(
                f"tier {self.name!r}: byte_cost must be > 0, got "
                f"{self.byte_cost}")
        if not 0.0 < self.throughput <= 1.0:
            raise ValueError(
                f"tier {self.name!r}: throughput must be in (0, 1], got "
                f"{self.throughput}")


def _default_tiers() -> dict[str, StorageTier]:
    return {t.name: t for t in (
        StorageTier("hot", byte_cost=1.0, throughput=1.0),
        StorageTier("warm", byte_cost=0.6, throughput=0.6),
        StorageTier("cold", byte_cost=0.35, throughput=0.25),
    )}


#: The built-in tier schema (hot flash/disk, warm disk, cold archive).
DEFAULT_TIERS: dict[str, StorageTier] = _default_tiers()

_SPEC_RE = re.compile(
    r"^\s*(?:(?:replicate|rf)\((?P<rf>-?\d+)\)"
    r"|ec\((?P<k>-?\d+)\s*,\s*(?P<m>-?\d+)\))"
    r"\s*(?::(?P<tier>\w+))?(?::(?P<loc>region|spread))?\s*$")


@dataclass(frozen=True)
class Strategy:
    """One category's storage strategy (module-docstring arithmetic)."""

    kind: str = "replicate"   # "replicate" | "ec"
    rf: int = 1               # replicate only
    k: int = 1                # ec: data shards
    m: int = 0                # ec: parity shards
    tier: str = "hot"
    #: Placement locality on a geo-hierarchical topology: ``"spread"``
    #: (default) lets copies/shards cross top-level domains — the
    #: region-loss survival posture; ``"region"`` pins the whole file to
    #: its primary's top-level domain — zero WAN bytes for data whose
    #: durability target is satisfied in-region (stripes stay local; a
    #: WAN partition strands them rather than losing them).  Ignored by
    #: non-hierarchical topologies.
    locality: str = "spread"

    def __post_init__(self):
        if self.locality not in ("spread", "region"):
            raise ValueError(
                f"unknown strategy locality {self.locality!r} "
                f"(want 'spread' or 'region')")
        if self.kind not in ("replicate", "ec"):
            raise ValueError(
                f"unknown strategy kind {self.kind!r} (want 'replicate' "
                f"or 'ec')")
        if self.kind == "replicate" and self.rf < 1:
            raise ValueError(
                f"replicate rf must be >= 1, got {self.rf}")
        if self.kind == "ec":
            if self.k < 1:
                raise ValueError(f"ec k must be >= 1, got {self.k}")
            if self.m < 0:
                raise ValueError(f"ec m must be >= 0, got {self.m}")

    # -- the three integers everything consumes --------------------------
    @property
    def n_shards(self) -> int:
        """Distinct nodes the strategy occupies per file."""
        return self.rf if self.kind == "replicate" else self.k + self.m

    @property
    def min_live(self) -> int:
        """Live shards below which the file is LOST (cannot be read or
        reconstructed): 1 full copy, or k EC shards."""
        return 1 if self.kind == "replicate" else self.k

    @property
    def shard_div(self) -> int:
        """Per-shard bytes = ceil(size / shard_div)."""
        return 1 if self.kind == "replicate" else self.k

    @property
    def overhead(self) -> float:
        """Stored bytes / raw bytes at full strength (rf, or (k+m)/k)."""
        return float(self.n_shards) / float(self.shard_div)

    @property
    def repair_read_shards(self) -> int:
        """Shards read over the wire to rebuild ONE shard: a replicate
        repair copies one replica; an EC repair reconstructs from k."""
        return 1 if self.kind == "replicate" else self.k

    def spec(self) -> str:
        body = (f"replicate({self.rf})" if self.kind == "replicate"
                else f"ec({self.k},{self.m})")
        out = f"{body}:{self.tier}"
        if self.locality != "spread":
            out += f":{self.locality}"
        return out

    @classmethod
    def from_spec(cls, spec, tier: str | None = None) -> "Strategy":
        """Parse ``replicate(3)``, ``rf(3)``, ``ec(6,3)``, each with an
        optional ``:tier`` suffix; a bare int is ``replicate(n)``."""
        if isinstance(spec, Strategy):
            return spec
        if isinstance(spec, int):
            return cls(kind="replicate", rf=spec, tier=tier or "hot")
        if isinstance(spec, dict):
            d = dict(spec)
            kind = d.pop("kind", None)
            allowed = {"rf", "k", "m", "tier", "locality"}
            unknown = set(d) - allowed
            if unknown:
                raise ValueError(
                    f"unknown strategy keys {sorted(unknown)} in {spec!r}")
            if kind is None:
                kind = ("replicate" if "rf" in d
                        else "ec" if "k" in d else None)
            # A dict must size itself explicitly: a tier-only dict would
            # otherwise silently default to ec(1, 0) — ONE copy.
            if kind is None or (kind == "replicate" and "rf" not in d) \
                    or (kind == "ec" and "k" not in d):
                raise ValueError(
                    f"strategy dict {spec!r} needs 'rf' (replicate) or "
                    f"'k' + optional 'm' (ec)")
            if kind == "replicate" and ("k" in d or "m" in d):
                raise ValueError(
                    f"replicate strategy dict {spec!r} must not carry "
                    f"ec keys 'k'/'m'")
            if kind == "ec" and "rf" in d:
                raise ValueError(
                    f"ec strategy dict {spec!r} must not carry 'rf'")
            if tier is not None:
                d.setdefault("tier", tier)
            return cls(kind=kind,
                       **{k: (str(v) if k in ("tier", "locality")
                              else int(v))
                          for k, v in d.items()})
        m = _SPEC_RE.match(str(spec))
        if not m:
            raise ValueError(
                f"bad strategy spec {spec!r} (want 'replicate(3)', "
                f"'ec(6,3)', optionally ':tier' e.g. 'ec(6,3):cold')")
        t = m.group("tier")
        loc = m.group("loc")
        if loc is None and t in ("region", "spread"):
            # 'ec(2,1):region' omits the tier: the greedy tier group
            # must not swallow the locality keyword (those two words
            # are reserved — no tier may use them).
            t, loc = None, t
        t = t or tier or "hot"
        loc = loc or "spread"
        if m.group("rf") is not None:
            return cls(kind="replicate", rf=int(m.group("rf")), tier=t,
                       locality=loc)
        return cls(kind="ec", k=int(m.group("k")), m=int(m.group("m")),
                   tier=t, locality=loc)


@dataclass
class StrategyVectors:
    """Per-CATEGORY-index arrays of the strategy arithmetic, the form the
    controller, faults layer and serve router consume vectorized.  Index
    with a category vector (``vec[cat]``); files with ``cat == -1``
    (not yet planned) use the replicate defaults."""

    categories: tuple[str, ...]
    n_shards: np.ndarray      # (n_cat,) int32
    min_live: np.ndarray      # (n_cat,) int32
    shard_div: np.ndarray     # (n_cat,) int64
    ec_k: np.ndarray          # (n_cat,) int32 — k for ec, 0 for replicate
    tier_idx: np.ndarray      # (n_cat,) int32 into tier_names
    tier_names: tuple[str, ...]
    byte_cost: np.ndarray     # (n_cat,) float64 per stored byte
    read_penalty: np.ndarray  # (n_cat,) float64 = 1/tier.throughput
    #: (n_cat,) bool — category pins its files to the primary's
    #: top-level hierarchy domain (``locality: region``).
    region_local: np.ndarray = None
    #: Defaults for files with ``cat == -1`` (not yet planned): the
    #: config's default tier.
    default_tier_idx: int = 0
    default_byte_cost: float = 1.0
    default_read_penalty: float = 1.0

    def file_min_live(self, cat: np.ndarray) -> np.ndarray:
        """(n,) int32 min live shards per file (-1-cat files: 1)."""
        c = np.asarray(cat)
        return np.where(c >= 0, self.min_live[np.clip(c, 0, None)],
                        1).astype(np.int32)

    def file_shard_bytes(self, cat: np.ndarray,
                         sizes: np.ndarray) -> np.ndarray:
        """(n,) int64 per-shard bytes (``ceil(size / shard_div)``;
        -1-cat files: the full size — a replicate shard IS the file)."""
        c = np.asarray(cat)
        div = np.where(c >= 0, self.shard_div[np.clip(c, 0, None)], 1)
        return -(-np.asarray(sizes, dtype=np.int64) // div)

    def file_region_local(self, cat: np.ndarray) -> np.ndarray:
        """(n,) bool region-locality per file (-1-cat files: spread)."""
        c = np.asarray(cat)
        return np.where(c >= 0,
                        self.region_local[np.clip(c, 0, None)], False)

    def file_ec_k(self, cat: np.ndarray) -> np.ndarray:
        """(n,) int32 EC data-shard count per file (0 = replicate)."""
        c = np.asarray(cat)
        return np.where(c >= 0, self.ec_k[np.clip(c, 0, None)],
                        0).astype(np.int32)

    def file_n_shards(self, cat: np.ndarray,
                      default_rf: int = 1) -> np.ndarray:
        """(n,) int32 target shard count per file (the rf vector's
        generalization; -1-cat files keep ``default_rf``)."""
        c = np.asarray(cat)
        return np.where(c >= 0, self.n_shards[np.clip(c, 0, None)],
                        int(default_rf)).astype(np.int32)


@dataclass
class StorageConfig:
    """category -> Strategy mapping plus the tier schema.

    ``strategies`` may cover a subset of categories; missing categories
    fall back to ``replicate(scoring rf)`` on the ``default_tier`` when
    resolved (``vectors``/``resolve_storage_config``)."""

    strategies: dict[str, Strategy] = field(default_factory=dict)
    tiers: dict[str, StorageTier] = field(default_factory=_default_tiers)
    default_tier: str = "hot"

    def __post_init__(self):
        parsed = {}
        for c, s in self.strategies.items():
            try:
                parsed[c] = Strategy.from_spec(s)
            except ValueError as e:
                raise ValueError(
                    f"storage strategy for category {c!r}: {e}") from None
        self.strategies = parsed
        self.tiers = {n: (t if isinstance(t, StorageTier)
                          else StorageTier(name=n, **dict(t)))
                      for n, t in self.tiers.items()}
        if self.default_tier not in self.tiers:
            raise ValueError(
                f"default_tier {self.default_tier!r} is not a defined "
                f"tier {sorted(self.tiers)}")
        for c, s in self.strategies.items():
            if s.tier not in self.tiers:
                raise ValueError(
                    f"storage strategy for category {c!r} names unknown "
                    f"tier {s.tier!r} (defined: {sorted(self.tiers)})")

    @property
    def pure_replication(self) -> bool:
        """True when no category erasure-codes (the degenerate config)."""
        return all(s.kind == "replicate" for s in self.strategies.values())

    def strategy_for(self, category: str,
                     scoring_rf: int | None = None) -> Strategy:
        s = self.strategies.get(category)
        if s is not None:
            return s
        if scoring_rf is None:
            raise ValueError(
                f"no storage strategy for category {category!r} and no "
                f"scoring rf to fall back on")
        return Strategy(kind="replicate", rf=int(scoring_rf),
                        tier=self.default_tier)

    def vectors(self, categories, scoring_rf=None) -> StrategyVectors:
        """Resolve every category to its strategy arithmetic.

        ``scoring_rf`` (per-category rf mapping or vector) backs the
        replicate fallback for unmapped categories; categories in
        ``strategies`` that are not in ``categories`` are rejected — a
        typo'd category name must not silently become a no-op."""
        categories = tuple(categories)
        unknown = sorted(set(self.strategies) - set(categories))
        if unknown:
            raise ValueError(
                f"storage strategies name unknown categories {unknown} "
                f"(want a subset of {categories})")
        if scoring_rf is None:
            rf_by_cat = {}
        elif isinstance(scoring_rf, dict):
            rf_by_cat = scoring_rf
        else:
            rf_by_cat = dict(zip(categories, scoring_rf))
        resolved = [self.strategy_for(c, rf_by_cat.get(c))
                    for c in categories]
        tier_names = tuple(sorted(self.tiers))
        tidx = {t: i for i, t in enumerate(tier_names)}
        return StrategyVectors(
            categories=categories,
            n_shards=np.asarray([s.n_shards for s in resolved], np.int32),
            min_live=np.asarray([s.min_live for s in resolved], np.int32),
            shard_div=np.asarray([s.shard_div for s in resolved],
                                 np.int64),
            # ec(1, m) IS replication (a 1-shard "stripe" is a full
            # copy; reconstruction fan-in 1 is a plain copy), so it
            # normalizes to ec_k=0 — this is what makes the
            # ec(1, m) == replicate(m+1) identity exact end to end.
            ec_k=np.asarray([s.k if s.kind == "ec" and s.k > 1 else 0
                             for s in resolved], np.int32),
            tier_idx=np.asarray([tidx[s.tier] for s in resolved],
                                np.int32),
            tier_names=tier_names,
            region_local=np.asarray(
                [s.locality == "region" for s in resolved], bool),
            byte_cost=np.asarray([self.tiers[s.tier].byte_cost
                                  for s in resolved], np.float64),
            read_penalty=np.asarray(
                [1.0 / self.tiers[s.tier].throughput for s in resolved],
                np.float64),
            default_tier_idx=tidx[self.default_tier],
            default_byte_cost=self.tiers[self.default_tier].byte_cost,
            default_read_penalty=1.0
            / self.tiers[self.default_tier].throughput,
        )

    def describe(self, categories, scoring_rf=None) -> list[dict]:
        """Per-category resolution table (the ``cdrs storage show``
        payload): strategy, tier, overhead, loss threshold, repair read
        amplification."""
        rf_by_cat = (scoring_rf if isinstance(scoring_rf, dict)
                     else dict(zip(categories, scoring_rf))
                     if scoring_rf is not None else {})
        rows = []
        for c in categories:
            s = self.strategy_for(c, rf_by_cat.get(c))
            t = self.tiers[s.tier]
            rows.append({
                "category": c,
                "strategy": s.spec(),
                "kind": s.kind,
                "n_shards": s.n_shards,
                "min_live": s.min_live,
                "storage_overhead": round(s.overhead, 4),
                "tier": s.tier,
                "tier_byte_cost": t.byte_cost,
                "tier_throughput": t.throughput,
                "cost_per_raw_byte": round(s.overhead * t.byte_cost, 4),
                "repair_read_shards": s.repair_read_shards,
                "locality": s.locality,
            })
        return rows

    def to_dict(self) -> dict:
        return {
            "default_tier": self.default_tier,
            "tiers": {n: {"byte_cost": t.byte_cost,
                          "throughput": t.throughput}
                      for n, t in sorted(self.tiers.items())},
            "strategies": {c: s.spec()
                           for c, s in sorted(self.strategies.items())},
        }

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_scoring(cls, scoring, tier: str = "hot") -> "StorageConfig":
        """The degenerate config: every category ``replicate(scoring
        rf)`` on one tier — bit-for-bit the historical behaviour."""
        return cls(strategies={
            c: Strategy(kind="replicate", rf=int(r), tier=tier)
            for c, r in scoring.replication_factors.items()},
            default_tier=tier)

    @classmethod
    def ec_archival(cls, scoring=None, k: int = 6, m: int = 3,
                    tier: str = "cold") -> "StorageConfig":
        """The production Archival shape: cold data erasure-codes down a
        tier (HDFS EC's RS(6,3) default), everything else replicates at
        its scoring rf on the hot tier."""
        strategies: dict[str, Strategy] = {
            "Archival": Strategy(kind="ec", k=k, m=m, tier=tier)}
        if scoring is not None:
            for c, r in scoring.replication_factors.items():
                if c != "Archival":
                    strategies[c] = Strategy(kind="replicate", rf=int(r))
        return cls(strategies=strategies)


def storage_config_from_dict(d) -> StorageConfig:
    """Build a StorageConfig from a plain dict (parsed JSON).

    Unknown keys are rejected — a typo'd table must not silently fall
    back to defaults (the scoring_config_from_dict contract)."""
    allowed = {"strategies", "tiers", "default_tier"}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown storage config keys: {sorted(unknown)}")
    kwargs = dict(d)
    if "tiers" in kwargs:
        tiers = dict(_default_tiers())
        for name, spec in kwargs["tiers"].items():
            extra = set(spec) - {"byte_cost", "throughput"}
            if extra:
                raise ValueError(
                    f"unknown tier keys for {name!r}: {sorted(extra)}")
            tiers[name] = StorageTier(name=name, **spec)
        kwargs["tiers"] = tiers
    return StorageConfig(**kwargs)


def load_storage_config(path: str) -> StorageConfig:
    """Load a StorageConfig from a JSON file."""
    import json

    with open(path, encoding="utf-8") as f:
        return storage_config_from_dict(json.load(f))


def resolve_storage_config(spec: str | None, scoring) -> StorageConfig | None:
    """The CLI contract for ``--storage_config``: None passes through
    (no storage subsystem — historical behaviour), ``replicate`` is the
    explicit degenerate config, ``ec_archival`` the built-in EC preset,
    anything else a JSON file path."""
    if not spec:
        return None
    if spec == "replicate":
        return StorageConfig.from_scoring(scoring)
    if spec == "ec_archival":
        return StorageConfig.ec_archival(scoring)
    return load_storage_config(spec)
