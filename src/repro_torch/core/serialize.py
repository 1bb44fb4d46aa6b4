"""Condensed-graph serialization (paper §3.1: "serialize the graph onto
disk in a standardized format").

Three formats:

* :func:`save_condensed` / :func:`load_condensed` — the *condensed*
  structure itself (chains + direct edges + properties) as raw little-
  endian buffers + a JSON manifest (same discipline as
  :mod:`repro_torch.train.checkpoint`: atomic rename,
  restart-safe).  This is
  what "store the deduplicated graph back into the database" (paper §6.5)
  maps to.
* :func:`export_edge_list` — the *expanded* representation as a plain
  ``src dst`` text/npz edge list consumable by external tools
  (NetworkX et al.), the paper's interchange path.
* :class:`ShardSpillStore` + :class:`ShardAssembly` — the *spill* format
  for sharded out-of-core extraction (DESIGN.md §8): per-shard extraction
  outputs (shard-local node-space candidates, per-rule ``Chain`` arrays
  and direct edge blocks) written incrementally as each shard finishes,
  one atomically-committed record per shard, each with a byte-accounted
  manifest.  :func:`merge_assemblies` / :func:`tree_merge_records` are
  the merge half: pairwise (or ``arity``-wise) sorted-key unions that
  stream spilled shards a group at a time, so the single-pass all-shards
  merge of DESIGN.md §7 becomes a log-depth tree reduce whose resident
  operand count is ``arity + 1`` records, independent of shard count.

The port's copy of the JAX package's module of the same name: the same
files, byte for byte, so a directory either package wrote loads in the
other: a spill, a delta log or a plan report.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .condensed import BipartiteEdges, Chain, CondensedGraph, merge_chain_shards

__all__ = [
    "save_condensed",
    "load_condensed",
    "save_crossover_table",
    "load_crossover_table",
    "save_plan_report",
    "load_plan_report",
    "export_edge_list",
    "SpillError",
    "ShardSpillStore",
    "ShardAssembly",
    "merge_assemblies",
    "tree_merge_records",
    "DeltaLog",
    "SPILL_MANIFEST",
]

_FORMAT_VERSION = 1
_SPILL_VERSION = 1

# Name of the closing top-level manifest a complete spill directory must
# carry (written once by ShardSpillStore.finalize, after every record).
SPILL_MANIFEST = "spill_manifest.json"


def save_condensed(graph: CondensedGraph, directory: str) -> str:
    """Write a condensed graph to ``directory`` (paper §3.1 "standardized
    format", §6.5 "store the deduplicated graph back into the
    database"): every chain level / direct / property / node-type array
    as a raw little-endian buffer, plus a ``manifest.json`` recording
    dtype, shape and file per array.  Written to ``<directory>.tmp``
    and committed by one atomic rename, so a crashed save never leaves a
    half-written directory behind.  Returns ``directory``."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict = {
        "version": _FORMAT_VERSION,
        "n_real": graph.n_real,
        "chains": [],
        "direct": None,
        "properties": {},
        "node_type": None,
    }
    idx = 0

    def dump(arr: np.ndarray) -> Dict:
        nonlocal idx
        fname = f"{idx:04d}.bin"
        idx += 1
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())
        return {"file": fname, "dtype": arr.dtype.str, "shape": list(arr.shape)}

    for chain in graph.chains:
        edges = []
        for e in chain.edges:
            edges.append({
                "src": dump(e.src), "dst": dump(e.dst),
                "n_src": e.n_src, "n_dst": e.n_dst,
            })
        manifest["chains"].append(edges)
    if graph.direct is not None:
        manifest["direct"] = {
            "src": dump(graph.direct.src), "dst": dump(graph.direct.dst),
            "n_src": graph.direct.n_src, "n_dst": graph.direct.n_dst,
        }
    for name, arr in graph.node_properties.items():
        manifest["properties"][name] = dump(np.asarray(arr))
    if graph.node_type is not None:
        manifest["node_type"] = dump(np.asarray(graph.node_type))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)
    return directory


def save_crossover_table(table, path: str) -> str:
    """Persist a measured-crossover dispatch table
    (:class:`repro_torch.kernels.autotune.CrossoverTable`) next to the pack it
    was recorded for — same atomic-rename discipline as the graph
    manifests, so a reloaded pack replays the exact dispatch decisions
    that were measured (golden-tested: tests/test_crossover_golden.py).
    Returns ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(table.to_json())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_crossover_table(path: str):
    """Load a table written by :func:`save_crossover_table`."""
    from ..kernels.autotune import CrossoverTable

    with open(path) as f:
        return CrossoverTable.from_json(f.read())


def save_plan_report(report, path: str) -> str:
    """Persist an extraction-plan report
    (:class:`repro_torch.core.cost.PlanReport`) as canonical JSON — same atomic
    write-replace discipline as :func:`save_crossover_table`, so an
    audited plan decision can ride next to the artifacts it produced
    (tests/test_torch_plan.py reads both packages' reports).  Returns ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(report.to_json())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_plan_report(path: str):
    """Load a report written by :func:`save_plan_report`."""
    from .cost import PlanReport

    with open(path) as f:
        return PlanReport.from_json(f.read())


def load_condensed(directory: str) -> CondensedGraph:
    """Inverse of :func:`save_condensed` (paper §3.1): read the
    ``manifest.json`` written there and rebuild the ``CondensedGraph``
    with identical array bytes, shapes and dtypes.  Rejects manifests
    from a different format version."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported format version {manifest['version']}")

    def load(meta: Dict) -> np.ndarray:
        with open(os.path.join(directory, meta["file"]), "rb") as f:
            return np.frombuffer(
                f.read(), dtype=np.dtype(meta["dtype"])
            ).reshape(meta["shape"])

    chains = []
    for edges_meta in manifest["chains"]:
        edges = [
            BipartiteEdges(load(m["src"]), load(m["dst"]), m["n_src"], m["n_dst"])
            for m in edges_meta
        ]
        chains.append(Chain(edges))
    direct = None
    if manifest["direct"] is not None:
        m = manifest["direct"]
        direct = BipartiteEdges(load(m["src"]), load(m["dst"]), m["n_src"], m["n_dst"])
    props = {k: load(m) for k, m in manifest["properties"].items()}
    node_type = load(manifest["node_type"]) if manifest["node_type"] else None
    return CondensedGraph(
        manifest["n_real"], chains, direct, node_properties=props,
        node_type=node_type,
    )


# ---------------------------------------------------------------------------
# Spill format for sharded out-of-core extraction (DESIGN.md §8)
# ---------------------------------------------------------------------------

class SpillError(RuntimeError):
    """A spill directory is absent, partial, or corrupt.

    Raised by :meth:`ShardSpillStore.open` / :meth:`ShardSpillStore.validate`
    when the closing manifest is missing (the writer crashed before
    :meth:`ShardSpillStore.finalize`), a listed record is gone or
    truncated, or an uncommitted ``*.tmp`` record is left behind.  A
    partial spill is rejected here, never silently merged.
    """


@dataclasses.dataclass
class ShardAssembly:
    """One shard's (or one merged partial's) assembled extraction output.

    The unit of the spill format and of the tree-reduce merge
    (DESIGN.md §8): for every Edges rule either a shard-local
    :class:`~repro_torch.core.condensed.Chain` plus its local virtual-layer key
    spaces (``chains[rule_index] = (chain, layer_keys)``) or, for rules
    with no postponed join, the shard's direct edge block over dense real
    ids (``direct[rule_index] = (src_ids, dst_ids)``).  ``dropped``
    counts endpoints that missed the node space.  Merging two assemblies
    with :func:`merge_assemblies` is associative (sorted-key union +
    remap, shard-order concat), which is what makes the tree reduce
    byte-identical to the single-pass merge.
    """

    chains: Dict[int, Tuple[Chain, List[np.ndarray]]]
    direct: Dict[int, Tuple[np.ndarray, np.ndarray]]
    dropped: int = 0

    def nbytes(self) -> int:
        """Resident bytes of every edge / key array in this assembly —
        the quantity charged to ``ExtractionBudget.charge_assembly`` and
        recorded in the record's byte-accounted manifest."""
        n = 0
        for chain, keys in self.chains.values():
            n += chain.nbytes()
            n += sum(int(k.nbytes) for k in keys)
        for s, d in self.direct.values():
            n += int(s.nbytes) + int(d.nbytes)
        return n


def merge_assemblies(parts: Sequence[ShardAssembly]) -> ShardAssembly:
    """Merge shard assemblies (in shard order) into one partial.

    Per rule: chains go through
    :func:`~repro_torch.core.condensed.merge_chain_shards` (sorted-key union of
    the local virtual key spaces, local ids *remapped* — never offset —
    through ``searchsorted``, per-level edges concatenated in part
    order); direct edge blocks concatenate in part order; dropped counts
    sum.  Every one of those operations is associative, so folding
    groups of parts in any tree shape — provided group order follows
    shard order — yields the same bytes as merging all shards at once.
    """
    if not parts:
        raise ValueError("merge_assemblies needs at least one part")
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    for p in parts[1:]:
        if sorted(p.chains) != sorted(first.chains) or sorted(p.direct) != sorted(first.direct):
            raise ValueError("shard assemblies disagree on rule structure")
    chains: Dict[int, Tuple[Chain, List[np.ndarray]]] = {}
    for r in first.chains:
        merged, keys = merge_chain_shards(
            [p.chains[r][0] for p in parts],
            [p.chains[r][1] for p in parts],
        )
        chains[r] = (merged, keys)
    direct: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for r in first.direct:
        direct[r] = (
            np.concatenate([p.direct[r][0] for p in parts]),
            np.concatenate([p.direct[r][1] for p in parts]),
        )
    return ShardAssembly(chains, direct, sum(p.dropped for p in parts))


def _assembly_to_arrays(a: ShardAssembly) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Flatten a :class:`ShardAssembly` into the (arrays, meta) pair a
    spill record stores; inverse of :func:`_assembly_from_arrays`."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict = {"dropped": int(a.dropped), "rules": {}}
    for r, (chain, keys) in a.chains.items():
        meta["rules"][str(r)] = {
            "kind": "chain",
            "levels": [[e.n_src, e.n_dst] for e in chain.edges],
        }
        for lvl, e in enumerate(chain.edges):
            arrays[f"r{r}_lvl{lvl}_src"] = e.src
            arrays[f"r{r}_lvl{lvl}_dst"] = e.dst
        for k, key_arr in enumerate(keys):
            arrays[f"r{r}_key{k}"] = key_arr
    for r, (s, d) in a.direct.items():
        meta["rules"][str(r)] = {"kind": "direct"}
        arrays[f"r{r}_direct_src"] = s
        arrays[f"r{r}_direct_dst"] = d
    return arrays, meta


def _assembly_from_arrays(
    arrays: Dict[str, np.ndarray], meta: Dict
) -> ShardAssembly:
    chains: Dict[int, Tuple[Chain, List[np.ndarray]]] = {}
    direct: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for r_str, info in meta["rules"].items():
        r = int(r_str)
        if info["kind"] == "direct":
            direct[r] = (arrays[f"r{r}_direct_src"], arrays[f"r{r}_direct_dst"])
            continue
        edges = [
            BipartiteEdges(
                arrays[f"r{r}_lvl{lvl}_src"], arrays[f"r{r}_lvl{lvl}_dst"],
                int(n_src), int(n_dst),
            )
            for lvl, (n_src, n_dst) in enumerate(info["levels"])
        ]
        keys = [
            arrays[f"r{r}_key{k}"] for k in range(len(info["levels"]) - 1)
        ]
        chains[r] = (Chain(edges), keys)
    return ShardAssembly(chains, direct, int(meta["dropped"]))


class ShardSpillStore:
    """A directory of atomically-committed array records + one closing
    manifest — the on-disk side of out-of-core shard assembly
    (DESIGN.md §8).

    Layout::

        <directory>/
          spill_manifest.json     # written LAST by finalize(): version,
                                  # pipeline meta, {record: nbytes} map
          <record name>/          # one dir per record, atomic-renamed
            record.json           # per-array meta + total payload bytes
            0000.bin ...          # raw little-endian array buffers

    Records are written to ``<name>.tmp-<pid>`` and committed by a
    single ``os.rename`` — a record directory either exists completely
    or not at all, so a crash can only ever leave behind ``*.tmp-*``
    litter and a missing closing manifest, both of which
    :meth:`validate` rejects.  Record names are namespaced by the
    extraction pipeline (``nodes_r<rule>_s<shard>``, ``shard_s<shard>``,
    ``nodespace``, merge partials ``<prefix>L<level>g<group>``).

    The per-record manifest carries ``nbytes`` (summed array payload),
    making the spill *byte-accounted*: `ExtractionBudget` charges the
    same number while the record's arrays are resident, so RAM-vs-disk
    accounting lines up exactly.
    """

    def __init__(self, directory: str, create: bool = True) -> None:
        """``create=True`` opens the store *for writing*: the directory is
        made if absent and any closing manifest left by a previous run is
        removed — the spill is partial again until this run's
        :meth:`finalize`.  Without that invalidation, a re-run into a
        used directory that crashes mid-way would leave the *old*
        manifest certifying a mix of old and new records, exactly the
        silent-merge case :meth:`validate` exists to reject.
        ``create=False`` opens read-only (see :meth:`open`)."""
        self.directory = directory
        if create:
            os.makedirs(directory, exist_ok=True)
            try:
                # racy-safe: concurrent multi-host writers may all try
                os.remove(os.path.join(directory, SPILL_MANIFEST))
            except FileNotFoundError:
                pass
        elif not os.path.isdir(directory):
            raise SpillError(f"spill directory {directory!r} does not exist")

    # -- record I/O -----------------------------------------------------------
    def write_record(
        self, name: str, arrays: Dict[str, np.ndarray], meta: Optional[Dict] = None
    ) -> int:
        """Atomically write one record; returns its payload bytes.

        Atomicity is with respect to *process* crashes (the failure mode
        extraction actually restarts from): the rename makes the record
        appear all-at-once in the namespace, and an interrupted write
        only ever leaves ``*.tmp-*`` litter behind.  Payload ``.bin``
        files are not individually fsynced, so OS/power-loss durability
        is not claimed — :meth:`validate` stats every payload against
        its manifest size, which catches that case too.
        """
        tmp = os.path.join(self.directory, f"{name}.tmp-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        record: Dict = {"arrays": {}, "meta": meta or {}, "nbytes": 0}
        for i, (aname, arr) in enumerate(arrays.items()):
            arr = np.ascontiguousarray(arr)
            fname = f"{i:04d}.bin"
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(arr.tobytes())
            record["arrays"][aname] = {
                "file": fname, "dtype": arr.dtype.str, "shape": list(arr.shape),
            }
            record["nbytes"] += int(arr.nbytes)
        with open(os.path.join(tmp, "record.json"), "w") as f:
            json.dump(record, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.directory, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return int(record["nbytes"])

    def _record_header(self, name: str) -> Dict:
        """Parse a record's ``record.json`` alone — no payload I/O."""
        rdir = os.path.join(self.directory, name)
        try:
            with open(os.path.join(rdir, "record.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise SpillError(f"spill record {name!r} is missing or partial: {e}")

    def read_record(
        self, name: str, names: Optional[Sequence[str]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict, int]:
        """Load one record; returns ``(arrays, meta, nbytes)``.

        ``names`` restricts which arrays are read from disk (the record's
        total ``nbytes`` is reported either way) — e.g. the node-space
        candidate pass skips the property columns it will stream later.
        A missing or truncated payload raises :class:`SpillError`.
        """
        rdir = os.path.join(self.directory, name)
        record = self._record_header(name)
        arrays: Dict[str, np.ndarray] = {}
        for aname, m in record["arrays"].items():
            if names is not None and aname not in names:
                continue
            try:
                with open(os.path.join(rdir, m["file"]), "rb") as f:
                    arrays[aname] = np.frombuffer(
                        f.read(), dtype=np.dtype(m["dtype"])
                    ).reshape(m["shape"])
            except (OSError, ValueError) as e:
                raise SpillError(
                    f"spill record {name!r} array {aname!r} is missing or "
                    f"truncated: {e}"
                )
        return arrays, record["meta"], int(record["nbytes"])

    def has_record(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.directory, name, "record.json"))

    def delete_record(self, name: str) -> None:
        shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def rename_record(self, old: str, new: str) -> None:
        """Move a committed record to a new name — metadata-only (no
        payload rewrite).  An existing target is replaced."""
        src = os.path.join(self.directory, old)
        dst = os.path.join(self.directory, new)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.rename(src, dst)

    def list_records(self) -> List[str]:
        """Committed record names (sorted); ``*.tmp-*`` litter excluded —
        including a tmp directory whose ``record.json`` was fully written
        before a crash interrupted the commit rename."""
        return sorted(
            d for d in os.listdir(self.directory)
            if ".tmp-" not in d
            and os.path.isfile(os.path.join(self.directory, d, "record.json"))
        )

    # -- shard-assembly convenience -------------------------------------------
    def write_assembly(self, name: str, assembly: ShardAssembly) -> int:
        arrays, meta = _assembly_to_arrays(assembly)
        return self.write_record(name, arrays, meta)

    def read_assembly(self, name: str) -> Tuple[ShardAssembly, int]:
        arrays, meta, nbytes = self.read_record(name)
        return _assembly_from_arrays(arrays, meta), nbytes

    # -- completeness ---------------------------------------------------------
    def finalize(self, meta: Optional[Dict] = None) -> str:
        """Write the closing manifest over every record currently
        committed on disk.  Until this exists the spill is *partial* by
        definition and :meth:`open` refuses it."""
        manifest = {
            "version": _SPILL_VERSION,
            "meta": meta or {},
            "records": {},
        }
        for name in self.list_records():
            # header-only: finalizing must not re-read the whole spill
            manifest["records"][name] = int(self._record_header(name)["nbytes"])
        manifest["total_bytes"] = sum(manifest["records"].values())
        path = os.path.join(self.directory, SPILL_MANIFEST)
        tmp = path + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def clear_records(self) -> None:
        """Delete every committed record (and ``*.tmp-*`` litter) — a
        writer starting a fresh run into a reused directory calls this so
        stale records from a previous run (e.g. a larger ``n_shards``)
        are never certified into the new closing manifest.  Single-writer
        only: concurrent multi-host processes must not race it, so the
        multi-host driver requires a fresh directory instead."""
        for d in os.listdir(self.directory):
            path = os.path.join(self.directory, d)
            if os.path.isdir(path) and (
                ".tmp-" in d or os.path.isfile(os.path.join(path, "record.json"))
            ):
                shutil.rmtree(path, ignore_errors=True)

    def manifest(self) -> Dict:
        path = os.path.join(self.directory, SPILL_MANIFEST)
        try:
            with open(path) as f:
                return json.load(f)
        except OSError:
            raise SpillError(
                f"{self.directory!r} has no {SPILL_MANIFEST}: the spill is "
                "partial (writer did not finalize) — refusing to merge it"
            )
        except ValueError as e:
            raise SpillError(
                f"{self.directory!r} has a corrupt {SPILL_MANIFEST}: {e}"
            )

    def validate(self) -> Dict:
        """Crash-safety gate: reject partial or corrupt spills.

        Checks, in order: the closing manifest exists; no uncommitted
        ``*.tmp-*`` record directories are left behind; every listed
        record's header is present with byte counts matching the
        manifest; every payload file's on-disk size equals
        ``itemsize × prod(shape)`` from the header (so a truncated or
        lost ``.bin`` is caught *here*, without reading the spill back).
        Header/stat work only — O(records), not O(bytes).  Returns the
        parsed manifest on success, raises :class:`SpillError` otherwise.
        """
        manifest = self.manifest()
        if manifest.get("version") != _SPILL_VERSION:
            raise SpillError(
                f"unsupported spill version {manifest.get('version')}"
            )
        litter = [
            d for d in os.listdir(self.directory)
            if ".tmp-" in d and os.path.isdir(os.path.join(self.directory, d))
        ]
        if litter:
            raise SpillError(
                f"uncommitted spill records left behind: {sorted(litter)} — "
                "the writing run crashed mid-record; re-run the extraction"
            )
        for name, nbytes in manifest["records"].items():
            if not self.has_record(name):
                raise SpillError(
                    f"spill record {name!r} listed in the manifest is missing"
                )
            header = self._record_header(name)
            if int(header["nbytes"]) != nbytes:
                raise SpillError(
                    f"spill record {name!r} byte count mismatch: manifest "
                    f"says {nbytes}, record says {header['nbytes']}"
                )
            for aname, m in header["arrays"].items():
                path = os.path.join(self.directory, name, m["file"])
                expect = int(np.dtype(m["dtype"]).itemsize) * int(
                    np.prod(m["shape"], dtype=np.int64)
                )
                try:
                    got = os.path.getsize(path)
                except OSError:
                    raise SpillError(
                        f"spill record {name!r} array {aname!r} payload is "
                        "missing"
                    )
                if got != expect:
                    raise SpillError(
                        f"spill record {name!r} array {aname!r} is truncated:"
                        f" {got} bytes on disk, header says {expect}"
                    )
        return manifest

    @classmethod
    def open(cls, directory: str) -> "ShardSpillStore":
        """Open an existing spill for reading; validates completeness."""
        store = cls(directory, create=False)
        store.validate()
        return store


def tree_merge_records(
    store: ShardSpillStore,
    names: Sequence[str],
    arity: int = 2,
    out_prefix: str = "partial_",
    budget=None,
    keep_leaves: bool = True,
) -> Tuple[str, Optional[ShardAssembly]]:
    """Log-depth tree reduce over spilled assembly records (DESIGN.md §8).

    ``names`` are record names in shard order.  Each round groups
    ``arity`` consecutive records, loads just that group, merges it with
    :func:`merge_assemblies`, writes the partial back as a new record,
    and frees the operands — so at any instant at most ``arity`` input
    records plus one output are resident, regardless of shard count.
    A trailing singleton is carried to the next round unchanged (it
    simply joins a later group), which preserves shard order and hence
    byte-identity with the single-pass merge.  Intermediate partials are
    deleted once consumed; the input leaf records are kept when
    ``keep_leaves`` (the default — a crash mid-merge loses no shard
    output and the merge can simply be re-run).

    ``budget`` (an ``ExtractionBudget``) gets the merge-phase residency
    recorded: operand + output bytes per group via ``note_merge``, and
    one ``n_merge_rounds`` increment per level.  Returns ``(final record
    name, final assembly or None)`` — the assembly is the last round's
    in-memory output, handed back so callers need not re-read from disk
    the record that was just written; it is ``None`` exactly when no
    merge ran (a single input record, returned by name untouched).
    """
    if arity < 2:
        raise ValueError(f"tree-reduce arity must be >= 2, got {arity}")
    if not names:
        raise ValueError("tree_merge_records needs at least one record")
    current = list(names)
    intermediates: set = set()
    level = 0
    last_merged: Optional[ShardAssembly] = None
    while len(current) > 1:
        nxt: List[str] = []
        last_merged = None  # only the final round's survivor is reusable
        for g, i in enumerate(range(0, len(current), arity)):
            group = current[i : i + arity]
            if len(group) == 1:
                nxt.append(group[0])  # carried: joins a later group
                continue
            loaded = [store.read_assembly(n) for n in group]
            merged = merge_assemblies([a for a, _ in loaded])
            out_name = f"{out_prefix}L{level}g{g}"
            out_bytes = store.write_assembly(out_name, merged)
            if budget is not None:
                budget.note_merge(
                    sum(nb for _, nb in loaded) + out_bytes
                )
            for n in group:
                if n in intermediates or not keep_leaves:
                    store.delete_record(n)
            intermediates.add(out_name)
            nxt.append(out_name)
            last_merged = merged if len(nxt) == 1 else None
        if budget is not None:
            budget.n_merge_rounds += 1
        current = nxt
        level += 1
    return current[0], (last_merged if len(current) == 1 else None)


# ---------------------------------------------------------------------------
# Crash-safe delta log for incremental extraction (DESIGN.md §9)
# ---------------------------------------------------------------------------

class DeltaLog:
    """A replayable, crash-safe log of table deltas for incremental
    extraction (:mod:`repro_torch.core.delta`, DESIGN.md §9), built on
    :class:`ShardSpillStore`'s atomic-commit records.

    One committed entry per :func:`repro_torch.core.delta.apply_delta` call,
    named ``delta_000000``, ``delta_000001``, ... in apply order.  An
    append is: write the entry record (payload + fsynced ``record.json``,
    committed by one atomic rename), then rewrite the closing manifest
    (fsync + atomic ``os.replace``) — *manifest-last*, so the manifest
    always certifies a consistent prefix of the log.  A crash can
    therefore only leave (a) ``*.tmp-*`` litter from a torn record write,
    or (b) a committed entry the manifest never certified (torn append);
    :meth:`open` rejects both with :class:`SpillError` — exactly like a
    partial extraction spill — and ``DeltaLog(dir, recover=True)`` drops
    the uncertified tail, restoring the last acknowledged state.
    Truncated or missing payloads of *certified* entries are corruption,
    rejected by validation and never recovered over.

    Entry payload: the insert rows per table (column arrays) and the
    delete specs per table (``(key_column, values)``); replaying every
    certified entry over the base catalog rebuilds the identical graph
    (asserted byte-for-byte in tests/test_torch_delta.py).
    """

    _KIND = "delta_log"

    def __init__(
        self, directory: str, create: bool = True, recover: bool = False
    ) -> None:
        if create:
            os.makedirs(directory, exist_ok=True)
        self.store = ShardSpillStore(directory, create=False)
        self.directory = directory
        has_manifest = os.path.exists(
            os.path.join(directory, SPILL_MANIFEST)
        )
        if not has_manifest:
            if self.store.list_records() or self._tmp_litter():
                raise SpillError(
                    f"{directory!r} has delta records but no {SPILL_MANIFEST}:"
                    " the log was never certified — refusing to replay it"
                )
            # a freshly created log is certified-empty from the start
            self._n = 0
            self.store.finalize(meta={"kind": self._KIND, "n_entries": 0})
            return
        if recover:
            self._drop_uncertified()
        self._n = self._validate()

    # -- integrity ------------------------------------------------------------
    def _tmp_litter(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.directory)
            if ".tmp-" in d and os.path.isdir(os.path.join(self.directory, d))
        )

    def _drop_uncertified(self) -> None:
        """Recovery: delete ``*.tmp-*`` litter and committed entries the
        manifest never certified (the torn tail of a crashed append)."""
        certified = set(self.store.manifest()["records"])
        for name in self._tmp_litter():
            shutil.rmtree(
                os.path.join(self.directory, name), ignore_errors=True
            )
        for name in self.store.list_records():
            if name not in certified:
                self.store.delete_record(name)

    def _validate(self) -> int:
        """Full crash-safety gate; returns the certified entry count."""
        manifest = self.store.validate()
        meta = manifest.get("meta", {})
        if meta.get("kind") != self._KIND:
            raise SpillError(
                f"{self.directory!r} is not a delta log "
                f"(kind={meta.get('kind')!r})"
            )
        n = int(meta.get("n_entries", -1))
        expect = [self._entry_name(i) for i in range(n)]
        listed = sorted(manifest["records"])
        if listed != expect:
            raise SpillError(
                f"delta log manifest is inconsistent: certifies {listed}, "
                f"expected exactly {expect}"
            )
        extra = sorted(set(self.store.list_records()) - set(listed))
        if extra:
            raise SpillError(
                f"uncertified delta records beyond the manifest: {extra} — "
                "a torn append; reopen with DeltaLog(dir, recover=True) to "
                "drop the tail"
            )
        return n

    @classmethod
    def open(cls, directory: str) -> "DeltaLog":
        """Open an existing log for replay/append; validates completeness
        (raises :class:`SpillError` on any torn or corrupt state)."""
        return cls(directory, create=False)

    # -- entries --------------------------------------------------------------
    @staticmethod
    def _entry_name(index: int) -> str:
        return f"delta_{index:06d}"

    def __len__(self) -> int:
        return self._n

    def append(self, inserts=None, deletes=None) -> int:
        """Durably log one delta; returns its entry index.

        ``inserts``: ``{table: {column: values}}`` rows to append;
        ``deletes``: ``{table: (key_column, values)}`` — drop every row
        whose key column takes one of the values.  Write order is
        entry-record first (atomic commit), manifest last (atomic
        replace): the entry is acknowledged only once the manifest
        certifies it.
        """
        arrays: Dict[str, np.ndarray] = {}
        ins_meta: List = []
        del_meta: List = []
        for ti, (tname, cols) in enumerate(sorted((inserts or {}).items())):
            colnames = list(cols)
            ins_meta.append([tname, colnames])
            for ci, cname in enumerate(colnames):
                arrays[f"ins{ti}_{ci}"] = np.asarray(cols[cname])
        for di, (tname, spec) in enumerate(sorted((deletes or {}).items())):
            key_col, values = spec
            del_meta.append([tname, key_col])
            arrays[f"del{di}"] = np.asarray(values)
        index = self._n
        self.store.write_record(
            self._entry_name(index), arrays,
            meta={"index": index, "inserts": ins_meta, "deletes": del_meta},
        )
        self._n = index + 1
        self.store.finalize(meta={"kind": self._KIND, "n_entries": self._n})
        return index

    def read(self, index: int):
        """Load entry ``index``; returns ``(inserts, deletes)`` in the
        exact shapes :meth:`append` took them."""
        if not 0 <= index < self._n:
            raise IndexError(f"delta log has {self._n} entries, not {index}")
        arrays, meta, _ = self.store.read_record(self._entry_name(index))
        inserts = {
            tname: {
                cname: arrays[f"ins{ti}_{ci}"]
                for ci, cname in enumerate(colnames)
            }
            for ti, (tname, colnames) in enumerate(meta["inserts"])
        }
        deletes = {
            tname: (key_col, arrays[f"del{di}"])
            for di, (tname, key_col) in enumerate(meta["deletes"])
        }
        return inserts, deletes

    def entries(self):
        """Iterate certified entries in apply order (the replay order)."""
        for i in range(self._n):
            yield self.read(i)


def export_edge_list(
    graph: CondensedGraph, path: str, fmt: str = "npz",
    drop_self_loops: bool = True,
) -> str:
    """Expand and write src/dst (+multiplicity) for external consumers —
    the paper's EXP interchange path (§4.1 baseline representation):
    ``fmt='npz'`` for NumPy-native tools, ``'txt'`` for the classic
    whitespace edge-list format (NetworkX et al.)."""
    exp = graph.expand(drop_self_loops=drop_self_loops)
    if fmt == "npz":
        np.savez_compressed(
            path, src=exp.src, dst=exp.dst, multiplicity=exp.multiplicity,
            n=exp.n,
        )
        return path if path.endswith(".npz") else path + ".npz"
    if fmt == "txt":
        with open(path, "w") as f:
            for s, d in zip(exp.src, exp.dst):
                f.write(f"{s} {d}\n")
        return path
    raise ValueError(fmt)
