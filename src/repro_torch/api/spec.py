"""Factory spec strings — the faiss ``index_factory`` idea for this repo.

One comma-separated string names an index structure, its payload coding
and its id coding, so benchmarks/services can sweep the whole
codec × structure matrix from a single ``--spec`` flag::

    spec   := struct ("," pq)? ("," key "=" value)*
    struct := "Flat" | "IVF" <nlist> | "NSG" <R> | "HNSW" <M>
    pq     := "PQ" <m> ("x" <bits>)?          # IVF only
    keys   := ids          = unc64|unc32|compact|ef|roc|gap_ans|wt|wt1
              codes        = polya            # IVF+PQ only
              cache_mb     = <float>          # DecodedListCache budget
              cache_policy = lru|2q           # DecodedListCache eviction
              max_epochs   = <int>            # auto-compact ingest threshold
              engine       = auto|xla|pallas  # scan backend (IVF + graph)

``ids=wt|wt1`` (the joint wavelet tree) applies only to IVF — friend
lists are not a partition.  ``cache_policy``/``max_epochs`` apply to the
structures that own a decode cache / take online ingest (IVF + graph,
not Flat).  :func:`parse_spec` accepts options in any order;
:meth:`IndexSpec.__str__` emits the canonical form (struct, PQ, ids,
codes, cache_mb, cache_policy, max_epochs, engine) so canonical strings
round-trip exactly: ``str(parse_spec(s)) == s``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from ..core.codecs import CODEC_NAMES

__all__ = ["IndexSpec", "parse_spec", "KNOWN_OPTION_KEYS"]

#: every ``key=value`` option :func:`parse_spec` accepts, in canonical
#: emission order.  The grammar block in ``docs/architecture.md`` must
#: list exactly these keys — analysis rule RPA007 fails on drift.
KNOWN_OPTION_KEYS = ("ids", "codes", "cache_mb", "cache_policy",
                     "max_epochs", "engine")

_WT_NAMES = ("wt", "wt1")
_ID_NAMES = tuple(CODEC_NAMES) + _WT_NAMES
_ENGINES = ("auto", "xla", "pallas")
_CACHE_POLICIES = ("lru", "2q")
_STRUCT_RE = re.compile(r"^(Flat|IVF|NSG|HNSW)(\d+)?$")
_PQ_RE = re.compile(r"^PQ(\d+)(?:x(\d+))?$")


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Parsed, canonical form of one factory string."""

    kind: str                         # "flat" | "ivf" | "nsg" | "hnsw"
    nlist: int = 0                    # IVF cluster count
    degree: int = 0                   # NSG R / HNSW M
    pq_m: int = 0                     # 0 = flat vectors
    pq_bits: int = 8
    ids: str = "roc"                  # id codec ("" for Flat)
    codes: Optional[str] = None       # None | "polya"
    cache_mb: Optional[float] = None  # DecodedListCache budget
    cache_policy: Optional[str] = None  # None (= "lru") | "lru" | "2q"
    max_epochs: Optional[int] = None  # compact once ingest exceeds this
    engine: Optional[str] = None      # scan backend, IVF + graph (None = "auto")

    def __post_init__(self) -> None:
        if self.kind not in ("flat", "ivf", "nsg", "hnsw"):
            raise ValueError(f"unknown index kind {self.kind!r}")
        if self.kind == "ivf" and self.nlist <= 0:
            raise ValueError("IVF needs a positive nlist (e.g. 'IVF1024')")
        if self.kind in ("nsg", "hnsw") and self.degree <= 0:
            raise ValueError(f"{self.kind.upper()} needs a positive degree")
        if self.kind == "flat":
            # "roc" is the untouched dataclass default; anything else was
            # explicitly requested and is an error on Flat
            if self.pq_m or self.codes or self.ids not in ("", "roc"):
                raise ValueError("Flat takes no PQ/ids/codes options")
            object.__setattr__(self, "ids", "")
        else:
            if self.ids not in _ID_NAMES:
                raise ValueError(
                    f"unknown id codec {self.ids!r}; options: {_ID_NAMES}")
        if self.kind in ("nsg", "hnsw"):
            if self.ids in _WT_NAMES:
                raise ValueError(
                    "ids=wt/wt1 is a joint structure over an IVF partition; "
                    "graph friend lists must use a per-list codec")
            if self.pq_m or self.codes:
                raise ValueError("graph indexes store flat vectors "
                                 "(no PQ/codes options)")
        if self.codes is not None:
            if self.codes != "polya":
                raise ValueError(f"unknown code codec {self.codes!r}")
            if not self.pq_m:
                raise ValueError("codes=polya requires a PQ token")
        if self.pq_m and self.pq_bits != 8:
            raise ValueError("only 8-bit PQ is supported (PQmx8)")
        if self.engine is not None and self.engine not in _ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; options: {_ENGINES}")
        if self.cache_mb is not None and self.cache_mb <= 0:
            raise ValueError("cache_mb must be positive")
        if self.cache_policy is not None:
            if self.cache_policy not in _CACHE_POLICIES:
                raise ValueError(f"unknown cache_policy "
                                 f"{self.cache_policy!r}; "
                                 f"options: {_CACHE_POLICIES}")
            if self.kind == "flat":
                raise ValueError("Flat has no decode cache "
                                 "(cache_policy does not apply)")
        if self.max_epochs is not None:
            if self.max_epochs <= 0:
                raise ValueError("max_epochs must be positive")
            if self.kind == "flat":
                raise ValueError("Flat ingest has no epochs "
                                 "(max_epochs does not apply)")

    def __str__(self) -> str:
        if self.kind == "flat":
            parts = ["Flat"]
        elif self.kind == "ivf":
            parts = [f"IVF{self.nlist}"]
        else:
            parts = [f"{self.kind.upper()}{self.degree}"]
        if self.pq_m:
            parts.append(f"PQ{self.pq_m}x{self.pq_bits}")
        if self.kind != "flat":
            parts.append(f"ids={self.ids}")
        if self.codes:
            parts.append(f"codes={self.codes}")
        if self.cache_mb is not None:
            mb = self.cache_mb
            parts.append(f"cache_mb={int(mb) if mb == int(mb) else mb}")
        if self.cache_policy is not None:
            parts.append(f"cache_policy={self.cache_policy}")
        if self.max_epochs is not None:
            parts.append(f"max_epochs={self.max_epochs}")
        if self.engine is not None:
            parts.append(f"engine={self.engine}")
        return ",".join(parts)


def parse_spec(spec: str) -> IndexSpec:
    """Parse a factory string into an :class:`IndexSpec` (see module doc)."""
    if isinstance(spec, IndexSpec):
        return spec
    tokens = [t.strip() for t in str(spec).split(",") if t.strip()]
    if not tokens:
        raise ValueError("empty index spec")
    m = _STRUCT_RE.match(tokens[0])
    if not m or (m.group(1) == "Flat") != (m.group(2) is None):
        raise ValueError(
            f"bad structure token {tokens[0]!r} "
            "(expected Flat, IVF<nlist>, NSG<R> or HNSW<M>)")
    struct, num = m.group(1), int(m.group(2) or 0)
    kw = dict(kind=struct.lower(), nlist=0, degree=0, pq_m=0, pq_bits=8,
              ids="" if struct == "Flat" else "roc", codes=None,
              cache_mb=None, cache_policy=None, max_epochs=None, engine=None)
    if struct == "IVF":
        kw["nlist"] = num
    elif struct in ("NSG", "HNSW"):
        kw["degree"] = num
    seen = set()
    for tok in tokens[1:]:
        pm = _PQ_RE.match(tok)
        if pm:
            if "pq" in seen:
                raise ValueError("duplicate PQ token")
            if struct != "IVF":
                raise ValueError(f"PQ token is only valid on IVF, got {tok!r} "
                                 f"on {struct}")
            seen.add("pq")
            kw["pq_m"] = int(pm.group(1))
            kw["pq_bits"] = int(pm.group(2) or 8)
            continue
        if "=" not in tok:
            raise ValueError(f"bad spec token {tok!r}")
        key, val = tok.split("=", 1)
        if key in seen:
            raise ValueError(f"duplicate option {key!r}")
        seen.add(key)
        if key == "ids":
            kw["ids"] = val
        elif key == "codes":
            kw["codes"] = val
        elif key == "cache_mb":
            kw["cache_mb"] = float(val)
        elif key == "cache_policy":
            kw["cache_policy"] = val
        elif key == "max_epochs":
            kw["max_epochs"] = int(val)
        elif key == "engine":
            kw["engine"] = val
        else:
            raise ValueError(f"unknown spec option {key!r} "
                             f"(known: {', '.join(KNOWN_OPTION_KEYS)})")
    return IndexSpec(**kw)
