"""Versioned, content-addressed artifact store for approximate operators.

Own copy of ``repro.library.store``, with the same on-disk format and
content keys, so a library written by either package reads in the other.
Layout (one directory per operator signature, one JSON file per
operator)::

    <root>/
      mul2b_wce1/
        3f9a2c41d0b85e77.json     # content-addressed key
      adder2b_wce2/
        ...

Each record carries the circuit netlist, the template parameters that
produced it, synthesized area, the search proxies, and error metrics
*measured exhaustively at store time* against the exact operator.
``FORMAT_VERSION`` is embedded per record; readers reject newer formats.
The content key is the SHA-256 of the canonical (sorted-keys) JSON of the
behaviour-defining payload, so storing the same netlist twice is a no-op.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

from ..core.arith import benchmark
from ..core.circuits import Circuit, Gate, Op
from ..core.miter import measure_error
from ..core.templates import TemplateParams

__all__ = [
    "FORMAT_VERSION",
    "OperatorSignature",
    "OperatorRecord",
    "OperatorStore",
    "atomic_write_json",
    "circuit_to_dict",
    "circuit_from_dict",
]

FORMAT_VERSION = 1


def atomic_write_json(path: Path, doc: dict) -> None:
    """Serialize ``doc`` to a uniquely named temp file next to ``path`` and
    ``os.replace`` it into place (atomic on POSIX): concurrent writers
    sharing one store never expose torn JSON, and losing a
    same-destination race just publishes identical bytes twice."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.stem}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(doc, sort_keys=True, indent=1))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise

OP_KINDS = ("mul", "adder")


# ---------------------------------------------------------------------------
# circuit / params serialization
# ---------------------------------------------------------------------------
def circuit_to_dict(c: Circuit) -> dict:
    return {
        "n_inputs": c.n_inputs,
        "nodes": [[g.op.value, list(g.args)] for g in c.nodes],
        "outputs": list(c.outputs),
        "name": c.name,
    }


def circuit_from_dict(d: dict) -> Circuit:
    c = Circuit(n_inputs=int(d["n_inputs"]), name=d.get("name", "circuit"))
    c.nodes = [Gate(Op(op), tuple(args)) for op, args in d["nodes"]]
    c.outputs = [int(o) for o in d["outputs"]]
    return c


def _params_to_dict(p: TemplateParams | None) -> dict | None:
    if p is None:
        return None
    return {"lits": p.lits.tolist(), "sel": p.sel.tolist()}


def _params_from_dict(d: dict | None) -> TemplateParams | None:
    if d is None:
        return None
    return TemplateParams(
        np.asarray(d["lits"], dtype=np.int8), np.asarray(d["sel"], dtype=bool)
    )


# ---------------------------------------------------------------------------
# signature / record
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class OperatorSignature:
    """What the operator *is*: ``(op_kind, bits, error_metric, threshold)``."""

    op_kind: str        # "mul" | "adder"
    bits: int           # operand bit width (the paper: 2, 3, 4)
    error_metric: str   # "wce" | "mae" | "mse" (paper's miter: wce)
    threshold: int      # the ET the operator was searched under

    def __post_init__(self) -> None:
        # ValueError (not assert): signatures() must be able to skip foreign
        # directories (e.g. a future mul8b_* store merged in with cp)
        if self.op_kind not in OP_KINDS:
            raise ValueError(f"unknown op_kind {self.op_kind!r}")
        if not 1 <= self.bits <= 4:
            raise ValueError("LUT lowering supports 1..4-bit operands")
        # the threshold is part of the dirname; a fractional one (tempting
        # for mae/mse signatures) would not round-trip through
        # from_dirname — 'mae0.5' parses as metric 'mae0.' — so records
        # would be written but never correctly read back.  Refuse loudly.
        if self.threshold != int(self.threshold) or self.threshold < 1:
            raise ValueError(
                f"threshold must be a positive integer (got "
                f"{self.threshold!r}); signature dirnames cannot encode "
                f"fractional thresholds — scale the metric instead"
            )
        # normalize 2.0 -> 2 so the dirname never renders a float repr
        object.__setattr__(self, "threshold", int(self.threshold))
        if self.error_metric != self.error_metric.rstrip("0123456789."):
            raise ValueError(
                f"error_metric {self.error_metric!r} must not end in "
                f"digits (it would not round-trip through the dirname)"
            )

    @property
    def dirname(self) -> str:
        return f"{self.op_kind}{self.bits}b_{self.error_metric}{self.threshold}"

    @classmethod
    def from_dirname(cls, name: str) -> "OperatorSignature":
        kind_bits, metric_thr = name.split("_", 1)
        for kind in OP_KINDS:
            if kind_bits.startswith(kind):
                bits = int(kind_bits[len(kind):-1])
                break
        else:
            raise ValueError(f"unparseable signature dir {name!r}")
        metric = metric_thr.rstrip("0123456789")
        return cls(kind, bits, metric, int(metric_thr[len(metric):]))

    @property
    def benchmark_name(self) -> str:
        return f"{self.op_kind}_i{2 * self.bits}"

    def exact_values(self) -> np.ndarray:
        """Ground-truth outputs of the exact reference operator."""
        return benchmark(self.benchmark_name).eval_words()


@dataclass
class OperatorRecord:
    """One stored operator: netlist + provenance + measured error metrics."""

    signature: OperatorSignature
    circuit: Circuit
    area: float
    wce: int                      # measured exhaustively at store time
    mae: float                    # mean |err| over all assignments (QoS predictor)
    mse: float = -1.0             # mean squared err (-1 = pre-mse record)
    source: str = "unknown"       # shared | xpat | muscat | mecals | tensor | ...
    proxies: dict = field(default_factory=dict)
    params: TemplateParams | None = None
    meta: dict = field(default_factory=dict)   # grid_point, wall_s, ...
    key: str = ""                 # content hash; filled by the store

    def payload(self) -> dict:
        """The behaviour-defining payload the content key hashes over."""
        return {
            "format_version": FORMAT_VERSION,
            "signature": {
                "op_kind": self.signature.op_kind,
                "bits": self.signature.bits,
                "error_metric": self.signature.error_metric,
                "threshold": self.signature.threshold,
            },
            "circuit": circuit_to_dict(self.circuit),
            "params": _params_to_dict(self.params),
        }

    def content_key(self) -> str:
        blob = json.dumps(self.payload(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
class OperatorStore:
    """Directory-backed operator library.

    ``put`` is idempotent (content-addressed); ``query`` returns records
    re-verified at read time only structurally (metrics were measured at
    write time and live in the record).
    """

    def __init__(self, root: str | os.PathLike) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ write
    def put(self, record: OperatorRecord) -> str:
        """Persist ``record``; idempotent and, via :func:`atomic_write_json`,
        safe under concurrent writers sharing one store."""
        key = record.content_key()
        record.key = key
        path = self.root / record.signature.dirname / f"{key}.json"
        if path.exists():
            return key
        doc = record.payload()
        doc.update(
            area=record.area,
            wce=record.wce,
            mae=record.mae,
            mse=record.mse,
            source=record.source,
            proxies=record.proxies,
            meta=record.meta,
            key=key,
        )
        atomic_write_json(path, doc)
        return key

    def put_circuit(
        self,
        circuit: Circuit,
        signature: OperatorSignature,
        *,
        area: float,
        source: str = "unknown",
        proxies: dict | None = None,
        params: TemplateParams | None = None,
        meta: dict | None = None,
    ) -> OperatorRecord:
        """Measure a candidate against the exact reference and store it.

        Raises if the candidate violates the signature's error threshold
        *under the signature's own metric* (``wce`` / ``mae`` / ``mse``)
        — the store only ever holds sound operators, and an mae-signed
        record was really validated under mae, not a wce proxy.
        """
        stats = measure_error(circuit, signature.exact_values())
        val = stats.value(signature.error_metric)
        if val > signature.threshold:
            raise ValueError(
                f"unsound operator: measured {signature.error_metric} "
                f"{val:g} > threshold {signature.threshold} for "
                f"{signature.dirname}"
            )
        rec = OperatorRecord(
            signature=signature, circuit=circuit, area=float(area),
            wce=stats.wce, mae=stats.mae, mse=stats.mse, source=source,
            proxies=dict(proxies or {}), params=params, meta=dict(meta or {}),
        )
        self.put(rec)
        return rec

    # ------------------------------------------------------------------- read
    def _load(self, path: Path) -> OperatorRecord:
        doc = json.loads(path.read_text())
        ver = int(doc.get("format_version", -1))
        if ver > FORMAT_VERSION:
            raise ValueError(
                f"{path}: format_version {ver} is newer than supported "
                f"{FORMAT_VERSION}; upgrade the reader"
            )
        s = doc["signature"]
        sig = OperatorSignature(
            s["op_kind"], int(s["bits"]), s["error_metric"], int(s["threshold"])
        )
        return OperatorRecord(
            signature=sig,
            circuit=circuit_from_dict(doc["circuit"]),
            area=float(doc["area"]),
            wce=int(doc["wce"]),
            mae=float(doc["mae"]),
            mse=float(doc.get("mse", -1.0)),
            source=doc.get("source", "unknown"),
            proxies=doc.get("proxies", {}),
            params=_params_from_dict(doc.get("params")),
            meta=doc.get("meta", {}),
            key=doc.get("key", path.stem),
        )

    def signatures(self) -> list[OperatorSignature]:
        out = []
        for d in sorted(self.root.iterdir()):
            if d.is_dir():
                try:
                    out.append(OperatorSignature.from_dirname(d.name))
                except ValueError:
                    continue
        return out

    def records(self, signature: OperatorSignature) -> list[OperatorRecord]:
        """All records stored under one signature, sorted by (area, wce)."""
        d = self.root / signature.dirname
        recs = [self._load(p) for p in sorted(d.glob("*.json"))] if d.is_dir() else []
        recs.sort(key=lambda r: (r.area, r.wce))
        return recs

    def query(
        self,
        op_kind: str | None = None,
        bits: int | None = None,
        *,
        error_metric: str | None = None,
        max_threshold: int | None = None,
        source: str | None = None,
    ) -> list[OperatorRecord]:
        """All records matching the filters, sorted by (area, wce)."""
        recs: list[OperatorRecord] = []
        for sig in self.signatures():
            if op_kind is not None and sig.op_kind != op_kind:
                continue
            if bits is not None and sig.bits != bits:
                continue
            if error_metric is not None and sig.error_metric != error_metric:
                continue
            if max_threshold is not None and sig.threshold > max_threshold:
                continue
            for rec in self.records(sig):
                if source is None or rec.source == source:
                    recs.append(rec)
        recs.sort(key=lambda r: (r.area, r.wce))
        return recs

    def __len__(self) -> int:
        return sum(
            1
            for sig in self.signatures()
            for _ in (self.root / sig.dirname).glob("*.json")
        )

    def version_token(self) -> str:
        """Cheap fingerprint of the store's *readable* contents.

        Records are content-addressed, so the sorted set of relative
        record paths changes exactly when an operator is added, removed,
        or merged in -- no file needs to be opened.  Foreign signature
        dirs the reader would skip anyway do not perturb the token.
        """
        h = hashlib.sha256()
        for sig in self.signatures():
            for p in sorted((self.root / sig.dirname).glob("*.json")):
                h.update(f"{sig.dirname}/{p.name}\n".encode())
        return h.hexdigest()[:16]
