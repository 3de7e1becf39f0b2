"""Checkpoint inspector / fsck — operational tooling for the C/R system
(``src/repro/launch/inspect_ckpt.py`` on the port's modules: the same
report, key for key, and the same exit codes on a checkpoint written by
either package).

The paper's production-hardening lessons (annotated region tables, attention
to warnings, debuggability) imply an operator workflow: before relying on a
checkpoint for a restart, *verify* it. This tool:

  * lists committed steps, the LATEST pointer, staging-dir litter;
  * prints the manifest summary (arch, config digest, lower-half descriptor,
    bytes by state role from the region registry);
  * for incremental (v3 chunked) checkpoints: chunk-level stats — object
    count/bytes in the content-addressed store, per-step dedup ratio
    (logical payload bytes ÷ unique chunk bytes), orphaned / missing /
    refcount-drifted objects;
  * ``--verify`` reads every shard (including buddy replicas; chunked shards
    resolve and digest-check every chunk), checks CRCs, and reports coverage
    per leaf — exit code 1 on any damage, so it slots into restart
    automation.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.inspect_ckpt <ckpt-root> [--step N]
      [--verify] [--scrub] [--health] [--subscribers]
"""
from __future__ import annotations

import argparse
import json
import zlib
from collections import defaultdict
from pathlib import Path

from ..core import atomic, cas
from ..core.checkpoint import _unpack_shard
from ..core.codec import CHUNK_ENCODED, _np_dtype, entropy_block_stats
from ..core.codec import decode as codec_decode
from ..core.elastic import ShardRange
from ..core.storage import RemoteTier, Tier, TieredStore


def _chunk_store(root: Path) -> cas.ChunkStore:
    return cas.ChunkStore(TieredStore(Tier("inspect", root)))


def _tiered_store(root: Path, slow_root: Path | None = None,
                  remote_root: Path | None = None) -> TieredStore:
    """The cross-tier store view the scrub/health commands operate on —
    tier names match the runtime's default hierarchy roles."""
    return TieredStore(
        Tier("fast", root),
        Tier("slow", slow_root) if slow_root else None,
        drain_async=False,
        remote=RemoteTier("remote", remote_root) if remote_root else None)


def _all_manifests(store: TieredStore) -> list:
    """Every committed manifest on every mounted tier (deduped by step) —
    the scrub's mark set must span the whole hierarchy or a slow-tier-only
    step's chunks would read as dead."""
    manifests, seen = [], set()
    for tier in store.tiers():
        for s in atomic.list_committed_steps(tier.root):
            if s in seen:
                continue
            try:
                manifests.append(json.loads(
                    (atomic.committed_dir(tier.root, s) /
                     atomic.MANIFEST).read_text()))
                seen.add(s)
            except (OSError, ValueError):
                pass            # other tiers may hold a readable copy
    return manifests


def run_scrub(root: Path, slow_root: Path | None = None,
              remote_root: Path | None = None, sample: int | None = None,
              seed: int = 0, out=print) -> dict:
    """``inspect_ckpt --scrub``: re-hash live objects across the mounted
    tiers, quarantine corrupt copies (never the last one) and heal from a
    good replica/tier. Persists ``_CAS/last_scrub.json``."""
    store = _tiered_store(root, slow_root, remote_root)
    chunks = cas.ChunkStore(store)
    live = cas.live_chunk_refs(_all_manifests(store))
    rep = chunks.scrub(live, sample=sample, seed=seed)
    try:
        atomic.atomic_write_bytes(store.fast.root / cas.SCRUB_FILE,
                                  json.dumps(rep).encode())
    except OSError:
        pass
    out(f"scrub: {rep['scanned']} scanned, {rep['clean']} clean, "
        f"{rep['healed']} healed, {rep['quarantined']} quarantined, "
        f"{rep['unrecoverable']} unrecoverable")
    rep["ok"] = rep["unrecoverable"] == 0
    return rep


def run_health(root: Path, slow_root: Path | None = None,
               remote_root: Path | None = None, out=print) -> dict:
    """``inspect_ckpt --health``: the persisted per-tier error counters +
    circuit-breaker state (``_CAS/health.json``), the last scrub summary
    (``_CAS/last_scrub.json``), and the quarantine contents with digests.
    Reads files only — the writer process owns the live counters."""
    store = _tiered_store(root, slow_root, remote_root)
    chunks = cas.ChunkStore(store)
    rep: dict = {"tiers": {}, "last_scrub": None, "quarantine": []}
    tier = store.locate(cas.HEALTH_FILE)
    if tier is not None:
        try:
            rep["tiers"] = json.loads(tier.read_file(cas.HEALTH_FILE))
        except (OSError, ValueError):
            pass
    tier = store.locate(cas.SCRUB_FILE)
    if tier is not None:
        try:
            rep["last_scrub"] = json.loads(tier.read_file(cas.SCRUB_FILE))
        except (OSError, ValueError):
            pass
    for tier_name, rel, digest, replica, size in chunks.quarantine_entries():
        rep["quarantine"].append(
            {"tier": tier_name, "rel": rel, "digest": digest,
             "replica": replica, "bytes": size})
    if not rep["tiers"]:
        out("health: no recorded tier health (run a save or maintenance "
            "pass first)")
    for name, snap in rep["tiers"].items():
        br = snap.get("breaker", {})
        counters = snap.get("counters", {})
        errs = sum(v for k, v in counters.items() if k.endswith("_errors"))
        retries = sum(v for k, v in counters.items()
                      if k.endswith("_retries"))
        out(f"  tier {name}: breaker {br.get('state', '?')} "
            f"({br.get('trips', 0)} trip(s)), {errs} error(s), "
            f"{retries} retried")
        for k in sorted(counters):
            out(f"    {k}: {counters[k]}")
    ls = rep["last_scrub"]
    if ls:
        out(f"  last scrub: {ls.get('scanned', 0)} scanned, "
            f"{ls.get('healed', 0)} healed, "
            f"{ls.get('quarantined', 0)} quarantined, "
            f"{ls.get('unrecoverable', 0)} unrecoverable "
            f"(seed {ls.get('seed')})")
    out(f"  quarantine: {len(rep['quarantine'])} entr"
        f"{'y' if len(rep['quarantine']) == 1 else 'ies'}")
    for q in rep["quarantine"]:
        out(f"    [{q['tier']}] {q['digest']} (replica {q['replica']}, "
            f"{q['bytes']} B) -> {q['rel']}")
    rep["ok"] = not any(
        s.get("breaker", {}).get("state") == "open"
        for s in rep["tiers"].values())
    return rep


def run_subscribers(root: Path, out=print) -> dict:
    """``inspect_ckpt --subscribers``: the WeightSync view of this store —
    the current announcement (``_WS/ANNOUNCE``) and every replica status
    file subscribers publish after each sync (``_WS/subscribers/*.json``).
    Per replica: live/degraded state, last flipped step vs the announced
    one, cache residency, wire-byte split (peer vs source) and the last
    error if it is holding last-good. Exit 1 if any replica is degraded
    or lagging the announcement."""
    from ..core.weightsync import ANNOUNCE_REL, SUBSCRIBERS_DIR
    rep: dict = {"announce": None, "subscribers": []}
    try:
        rep["announce"] = json.loads((root / ANNOUNCE_REL).read_text())
    except (OSError, ValueError):
        pass
    ann = rep["announce"]
    if ann:
        out(f"  announce: step {ann.get('step')} seq {ann.get('seq')} "
            f"({ann.get('step_dir')})")
    else:
        out("  announce: none (no publisher has committed here)")
    sdir = root / SUBSCRIBERS_DIR
    for p in sorted(sdir.glob("*.json")) if sdir.is_dir() else []:
        try:
            rep["subscribers"].append(json.loads(p.read_text()))
        except (OSError, ValueError):
            rep["subscribers"].append(
                {"name": p.stem, "state": "unreadable"})
    if not rep["subscribers"]:
        out("  subscribers: none published")
    lagging = 0
    for s in rep["subscribers"]:
        c = s.get("counters", {})
        wire = c.get("wire_bytes", 0)
        peer = c.get("peer_bytes", 0)
        lag = (ann is not None and s.get("last_flipped_step") is not None
               and s["last_flipped_step"] < int(ann["step"]))
        bad = s.get("state") != "live" or lag
        lagging += bad
        out(f"  {'!' if bad else ' '} {s.get('name', '?'):16s} "
            f"{s.get('state', '?'):9s} step {s.get('last_flipped_step')}"
            + (f" (announced {ann['step']})" if lag else "")
            + f"  cache {s.get('cache_chunks', 0)} chunk(s) "
            f"{s.get('cache_bytes', 0)/2**20:.2f} MiB  "
            f"wire {wire/2**20:.2f} MiB "
            f"({peer/max(wire, 1)*100:.0f}% peer)  "
            f"syncs {c.get('syncs', 0)} flips {c.get('flips', 0)}")
        if s.get("last_error"):
            out(f"      last_error: {s['last_error']}")
    rep["ok"] = not lagging
    return rep


def _cas_report(root: Path, manifests: list, deep: bool = False,
                covered=frozenset()) -> dict:
    """Chunk-level stats for one storage root. The inspector sees a single
    tier, but the store may span several (burst buffer + scratch keep
    manifests with different retention), so the published ``refs.json`` —
    the last cross-tier mark set — also vouches for liveness: an object is
    an orphan only if neither this root's manifests nor the published refs
    reference it, and refcount drift is only flagged when refs UNDERCOUNT
    what this root's manifests require (overcounts are other tiers' steps).

    ``deep`` (--verify) reads + re-hashes live objects; the default
    status listing checks existence only, so plain inspect stays a
    metadata operation. ``covered`` digests — the ones the inspected
    step's own shard records reference — are skipped by the deep pass
    (existence check only): the per-shard crc/decode verification reads
    and digest-checks every one of them anyway, and reading them twice
    doubled verify IO."""
    store = _chunk_store(root)
    live = cas.live_chunk_refs(manifests)
    refs = store.load_refs()
    published = {d for d, n in refs.items() if n > 0}
    on_disk = store.digests_on_disk()
    missing = []
    deep_reads = 0
    for d in sorted(set(live)):
        if deep and d not in covered:
            deep_reads += 1
            try:
                store.get(d)
            except Exception:  # noqa — unreadable on this root, any cause
                missing.append(d)
        elif d not in on_disk:
            missing.append(d)
    orphans = sorted(on_disk - set(live) - published)
    drift = {d: (refs.get(d, 0), n) for d, n in live.items()
             if refs.get(d, 0) < n}
    stats = store.stats()
    return {
        "objects": stats["objects"],
        "object_bytes": stats["bytes"],
        "references": sum(live.values()),
        "orphans": len(orphans),
        "missing": len(missing),
        "ref_drift": len(drift),
        "deep_reads": deep_reads,
        "ok": not (orphans or missing or drift),
    }


def _codec_report(mdir: Path, manifest: dict, report: dict, out) -> None:
    """Per-codec encoded-vs-raw byte totals for the inspected step — the
    effective compression each codec delivered ON THIS DATA (a lossless
    pre-conditioner like ``byteplane`` is exactly 1.00x here; its payoff
    shows in the -zstd variant's ratio and in dedup). Chunked records
    carry ``payload_bytes`` in the manifest; inline (full-mode) shards
    cost one 4-byte header-length read each — no payload IO."""
    per: defaultdict = defaultdict(lambda: [0, 0, 0])  # shards, raw, enc
    for rec in manifest["leaves"].values():
        for s in rec["shards"]:
            shape = ShardRange(tuple(s["start"]), tuple(s["stop"])).shape
            numel = 1
            for d in shape:
                numel *= d
            raw = numel * _np_dtype(s["dtype"]).itemsize
            enc = s.get("payload_bytes")
            if enc is None and s.get("chunk_lens"):
                enc = sum(s["chunk_lens"])
            if enc is None and "chunks" not in s:
                for fname in s.get("replicas", [s["file"]]):
                    p = mdir / fname
                    if p.exists():
                        with p.open("rb") as f:
                            hlen = int.from_bytes(f.read(4), "little")
                        enc = p.stat().st_size - 4 - hlen
                        break
            if enc is None:            # v3/v4 chunked record, sizes unknown
                continue
            ent = per[s["codec"]]
            ent[0] += 1
            ent[1] += raw
            ent[2] += enc
    if not per:
        return
    report["codecs"] = {
        c: {"shards": n, "raw_bytes": raw, "encoded_bytes": enc,
            "ratio": round(raw / max(enc, 1), 3)}
        for c, (n, raw, enc) in sorted(per.items())}
    for c, (n, raw, enc) in sorted(per.items()):
        out(f"    codec {c:15s} {n:5d} shard(s)  "
            f"{raw/2**20:10.2f} MiB raw -> {enc/2**20:10.2f} MiB encoded  "
            f"({raw/max(enc, 1):.2f}x)")


def _entropy_planes(payload, raw_len: int, k: int, codec: str,
                    table) -> None:
    """Fold one chunk-encoded shard's block stats into the per-plane
    table: ``table[(codec, plane)] = [raw, encoded, blocks, n_raw_escape,
    n_rle, n_rans]``. The transformed stream lays the k byteplanes out
    contiguously (plane p = bytes ``p*(n//k) .. (p+1)*(n//k)``, ragged
    tail passed through at the end), so a block's plane is a pure
    function of its absolute raw offset; a block straddling a plane
    boundary is attributed to the plane holding its start."""
    plane_len = raw_len // max(k, 1)
    for off, blen, flag, enc_len in entropy_block_stats(payload, raw_len):
        if plane_len and off >= plane_len * k:
            plane = "tail"
        else:
            plane = min(off // plane_len, k - 1) if plane_len else 0
        ent = table[(codec, plane)]
        ent[0] += blen
        ent[1] += 3 + enc_len
        ent[2] += 1
        ent[3 + flag] += 1


def _emit_entropy_planes(table, report: dict, out) -> None:
    """Per-plane raw/encoded bytes and escape counts for the chunk-
    encoded codecs — the operator view of WHERE the entropy stage bites
    (sign/exponent planes compress; mantissa planes escape to raw)."""
    if not table:
        return
    planes = {}
    for (codec, plane), (raw, enc, nb, n_raw, n_rle, n_rans) \
            in sorted(table.items(), key=lambda kv: (kv[0][0],
                                                     str(kv[0][1]))):
        planes.setdefault(codec, {})[str(plane)] = {
            "raw_bytes": raw, "encoded_bytes": enc, "blocks": nb,
            "raw_escape_blocks": n_raw, "rle_blocks": n_rle,
            "rans_blocks": n_rans}
        out(f"    plane {codec}[{plane}]: "
            f"{raw/2**20:8.2f} MiB raw -> {enc/2**20:8.2f} MiB encoded "
            f"({raw/max(enc, 1):.2f}x)  blocks {nb} "
            f"[raw-escape {n_raw}, rle {n_rle}, rans {n_rans}]")
    report["entropy_planes"] = planes


def _step_dedup(root: Path, manifest: dict) -> dict | None:
    """Per-step dedup ratio: logical payload bytes of the step's chunked
    shards ÷ unique chunk object bytes they reference. Also counts shard
    records per chunking scheme (v4; v3 records are implicitly fixed)."""
    digests: set = set()
    payload = 0
    n_chunked = 0
    schemes: defaultdict = defaultdict(int)
    for rec in manifest["leaves"].values():
        for s in rec["shards"]:
            if "chunks" not in s:
                continue
            n_chunked += 1
            payload += s.get("payload_bytes", 0)
            digests.update(s["chunks"])
            schemes[s.get("chunking", "fixed")] += 1
    if not n_chunked:
        return None
    uniq = 0
    for d in digests:
        p = root / cas.object_rel(d)
        if not p.exists():              # primary lost, buddy replica serves
            p = root / cas.object_rel(d, 1)
        if p.exists():
            uniq += p.stat().st_size
    return {"chunked_shards": n_chunked, "chunks": len(digests),
            "payload_bytes": payload, "unique_chunk_bytes": uniq,
            "chunking": dict(schemes),
            "dedup_ratio": payload / max(uniq, 1)}


def _chunk_histogram(root: Path, manifest: dict, deep: bool = False) -> dict:
    """Per-scheme chunk-size distribution (p10/p50/p90) vs the configured
    bounds — misconfigured CDC bounds (avg too small for the leaf sizes,
    max force-cutting everything) show up here during fsck instead of as
    silent dedup loss.

    Sizes come free for v5 CDC records (``chunk_lens``) and fixed records
    (derived from ``chunk_size``); for older CDC records (v4 — no length
    lists) sizes require a stat per unique object, so those are only
    collected under ``--verify`` (``deep``)."""
    import numpy as np
    sizes: defaultdict = defaultdict(list)
    stat_digests: defaultdict = defaultdict(set)
    for rec in manifest["leaves"].values():
        for s in rec["shards"]:
            if "chunks" not in s:
                continue
            scheme = s.get("chunking", "fixed")
            lens = s.get("chunk_lens")
            if lens:
                sizes[scheme].extend(lens)
            elif scheme == "fixed" and s.get("chunk_size") \
                    and s.get("payload_bytes") is not None:
                k, payload = len(s["chunks"]), s["payload_bytes"]
                if k:
                    sizes[scheme].extend(
                        [s["chunk_size"]] * (k - 1)
                        + [payload - (k - 1) * s["chunk_size"]])
            elif deep:
                stat_digests[scheme].update(s["chunks"])
    for scheme, digests in stat_digests.items():
        for d in digests:
            p = root / cas.object_rel(d)
            if not p.exists():
                p = root / cas.object_rel(d, 1)
            if p.exists():
                sizes[scheme].append(p.stat().st_size)
    bounds = manifest.get("chunk_bounds")
    out = {}
    for scheme, ss in sorted(sizes.items()):
        if not ss:
            continue
        p10, p50, p90 = (int(v) for v in
                         np.percentile(ss, [10, 50, 90]))
        ent = {"chunks": len(ss), "p10": p10, "p50": p50, "p90": p90}
        if scheme == "cdc" and bounds:
            ent["configured"] = {"min": bounds[0], "avg": bounds[1],
                                 "max": bounds[2]}
        elif scheme == "fixed" and manifest.get("chunk_size"):
            ent["configured"] = {"size": manifest["chunk_size"]}
        out[scheme] = ent
    return out


def _policy_block(manifest: dict, report: dict, out) -> None:
    """Print the policy a v6 manifest embeds (the writer's effective
    configuration — what a zero-config restart will adopt). A corrupted
    block degrades to a WARNING, never a crash: restore does not depend
    on it (shard records are self-describing), so the inspector must not
    either. v≤5 manifests simply predate the block."""
    fmt = int(manifest.get("format", 0))
    if fmt < 6:
        out("  policy: not recorded (v≤5)")
        return
    try:
        from ..core.policy import CheckpointPolicy
        block = manifest.get("policy")
        if not isinstance(block, dict):
            raise ValueError("policy block missing or not a mapping")
        p = CheckpointPolicy.from_dict(block)
        report["policy"] = p.to_dict()
        ck, pl, du, co = p.chunking, p.pipeline, p.durability, p.codec
        out(f"  policy: mode={p.mode} writers={p.n_writers} "
            f"codec={co.codec or 'auto'}/{co.params_codec or 'auto'}")
        out(f"    chunking={ck.scheme}@{ck.chunk_size/2**10:.0f}K "
            f"scan={ck.scan_backend}  io_threads={pl.io_threads} "
            f"persist_queue={pl.persist_queue_depth}"
            + (f" host_budget={pl.host_bytes_budget/2**20:.0f}M"
               if pl.host_bytes_budget else "")
            + f"  replicas={du.replicas} retain={du.retain}")
    except Exception as e:  # noqa — untrusted manifest content, any shape
        report["policy_error"] = f"{type(e).__name__}: {e}"
        out(f"  ! policy block unreadable ({type(e).__name__}: {e}) — "
            f"restore is unaffected (shard records are self-describing); "
            f"zero-config restarts will NOT auto-adopt the writer's "
            f"settings for this step")


def _step_rels(manifest: dict, step_dir: str) -> list:
    """Every storage-relative path the inspected step depends on: its
    inline shard files (all replicas) plus the unique chunk objects its
    chunked shards reference."""
    rels: list = []
    digests: set = set()
    for rec in manifest["leaves"].values():
        for s in rec["shards"]:
            if "chunks" in s:
                digests.update(s["chunks"])
            else:
                for fname in s.get("replicas", [s["file"]]):
                    rels.append(f"{step_dir}/{fname}")
    rels.extend(cas.object_rel(d) for d in sorted(digests))
    return rels


def _tier_residency(tier_roots: dict, manifest: dict, step_dir: str,
                    report: dict, out) -> None:
    """Per-tier residency of the inspected step — how many of its files
    (shards + chunk objects) each tier holds. The restore hierarchy reads
    fast → slow → remote, so `fast 0/N, remote N/N` is the cold-restart
    shape: every byte will stream off the object store's ranged reads."""
    rels = _step_rels(manifest, step_dir)
    if not rels:
        return
    res = {}
    for name, root in tier_roots.items():
        if root is None:
            continue
        root = Path(root)
        present = sum(1 for r in rels if (root / r).exists())
        res[name] = {"present": present, "total": len(rels)}
    report["residency"] = res
    out("    residency: " + "  ".join(
        f"{name} {v['present']}/{v['total']}" for name, v in res.items()))


def _pending_rounds(root: Path, staging: list) -> list:
    """In-flight (pending-stage) rounds: staging dirs whose PENDING marker
    still parses. An overlapped save(blocking=False) legitimately keeps
    one of these alive while it persists in the background — the operator
    needs the owning step and its AGE to tell a live round from crash
    litter, not a blanket 'orphaned' verdict."""
    import time
    rounds = []
    for name in staging:
        marker = root / name / atomic.PENDING
        try:
            info = json.loads(marker.read_text())
            rounds.append({"dir": name, "step": int(info.get("step", -1)),
                           "age_s": round(max(time.time()
                                              - float(info.get("t", 0)), 0),
                                          1)})
        except (OSError, ValueError):
            # no/torn marker: either mid-commit (marker already cleared,
            # rename pending) or true litter — listed, but age unknown
            rounds.append({"dir": name, "step": None, "age_s": None})
    return sorted(rounds, key=lambda r: (r["age_s"] is None,
                                         -(r["age_s"] or 0)))


def inspect(root: Path, step=None, verify=False, out=print,
            slow_root: Path | None = None, remote_root: Path | None = None):
    report = {"root": str(root), "ok": True, "problems": []}
    latest = atomic.read_latest(root)
    steps = atomic.list_committed_steps(root)
    staging = [d.name for d in root.iterdir()
               if d.is_dir() and ".tmp-" in d.name] if root.exists() else []
    report.update(latest=latest, steps=steps, staging=staging)
    out(f"checkpoint root: {root}")
    out(f"  committed steps: {steps or 'none'}   LATEST -> {latest}")
    if staging:
        pending = _pending_rounds(root, staging)
        report["pending_rounds"] = pending
        for pr in pending:
            if pr["age_s"] is not None:
                out(f"  ~ in-flight round: step {pr['step']} "
                    f"age {pr['age_s']}s ({pr['dir']}) — an overlapped "
                    f"save in progress, or crash litter if the age keeps "
                    f"growing")
            else:
                out(f"  ! staging dir without a readable PENDING marker: "
                    f"{pr['dir']} (mid-commit or crash litter; "
                    f"gc with atomic.gc_staging)")
    if latest is not None and latest not in steps:
        report["problems"].append(f"LATEST={latest} is not a committed step")
    step = step if step is not None else latest
    if step is None:
        report["ok"] = not report["problems"]
        return report

    mdir = root / f"step_{step:08d}"
    manifest = json.loads((mdir / atomic.MANIFEST).read_text())
    extra = manifest.get("extra", {})
    out(f"  step {step}: format v{manifest['format']}  "
        f"mode={manifest.get('mode', 'full')}  "
        f"arch={extra.get('arch', '?')}  "
        f"config={extra.get('config_digest', '?')[:12]}")
    _policy_block(manifest, report, out)
    lh = extra.get("lower_half", {})
    if lh:
        out(f"  lower half at save (informational): mesh="
            f"{lh.get('mesh_shape')} axes={lh.get('mesh_axes')} "
            f"{lh.get('runtime')}")
    by_role = defaultdict(lambda: [0, 0])
    for row in manifest.get("registry", []):
        by_role[row["role"]][0] += 1
        by_role[row["role"]][1] += row["nbytes"]
    for role, (n, b) in sorted(by_role.items()):
        out(f"    {role:8s} {n:5d} regions  {b/2**20:10.2f} MiB")
    n_shards = sum(len(r["shards"]) for r in manifest["leaves"].values())
    out(f"    {len(manifest['leaves'])} leaves, {n_shards} shards")
    report.update(step=step, leaves=len(manifest["leaves"]),
                  shards=n_shards, mode=manifest.get("mode", "full"),
                  roles={k: v[1] for k, v in by_role.items()})
    _codec_report(mdir, manifest, report, out)
    _tier_residency({"fast": root, "slow": slow_root,
                     "remote": remote_root},
                    manifest, mdir.name, report, out)

    dedup = _step_dedup(root, manifest)
    if dedup is not None:
        report["dedup"] = dedup
        schemes = "+".join(f"{v}×{k}" for k, v in
                           sorted(dedup["chunking"].items()))
        out(f"    chunked: {dedup['chunked_shards']} shard(s) [{schemes}], "
            f"{dedup['chunks']} unique chunk(s), dedup ratio "
            f"{dedup['dedup_ratio']:.2f}x "
            f"({dedup['payload_bytes']/2**20:.2f} MiB logical / "
            f"{dedup['unique_chunk_bytes']/2**20:.2f} MiB stored)")
        hist = _chunk_histogram(root, manifest, deep=verify)
        if hist:
            report["chunk_hist"] = hist
            for scheme, h in hist.items():
                cfg = h.get("configured", {})
                cfg_s = ("  configured " + "/".join(
                    f"{k}={v/2**10:.0f}K" for k, v in cfg.items())
                    if cfg else "")
                out(f"    {scheme} chunk sizes: p10 {h['p10']/2**10:.1f}K  "
                    f"p50 {h['p50']/2**10:.1f}K  p90 {h['p90']/2**10:.1f}K"
                    f"{cfg_s}")
    if (root / cas.CAS_DIR).exists():
        # manifests are only needed for the CAS mark set — full-mode roots
        # skip these reads entirely. An unreadable historical manifest is a
        # damage finding under --verify, informational otherwise (the
        # plain listing is a status query about the inspected step).
        all_manifests = []
        for s in steps:
            try:
                all_manifests.append(json.loads(
                    (root / f"step_{s:08d}" / atomic.MANIFEST).read_text()))
            except (OSError, ValueError):
                if verify:
                    report["problems"].append(
                        f"step {s}: unreadable manifest")
        # the per-shard verify pass below reads + digest-checks every chunk
        # the inspected step references — the deep CAS pass only needs to
        # read the digests OTHER retained steps pin (halves verify IO)
        covered = {d for rec in manifest["leaves"].values()
                   for s in rec["shards"] if "chunks" in s
                   for d in s["chunks"]} if verify else frozenset()
        report["cas"] = _cas_report(root, all_manifests, deep=verify,
                                    covered=covered)
        c = report["cas"]
        out(f"    CAS: {c['objects']} object(s) "
            f"{c['object_bytes']/2**20:.2f} MiB, "
            f"{c['references']} reference(s), {c['orphans']} orphan(s), "
            f"{c['missing']} missing, {c['ref_drift']} ref drift(s)")
        if verify:
            if c["missing"]:
                report["problems"].append(
                    f"CAS: {c['missing']} referenced chunk object(s) missing")
            if c["orphans"]:
                report["problems"].append(
                    f"CAS: {c['orphans']} orphaned chunk object(s) "
                    f"(unreclaimed by GC)")
            if c["ref_drift"]:
                report["problems"].append(
                    f"CAS: refs.json drifts from committed manifests on "
                    f"{c['ref_drift']} digest(s) (stale cache; next GC "
                    f"repairs)")

    if verify:
        chunk_store = _chunk_store(root)
        good = bad = replicas_ok = 0
        plane_table: defaultdict = defaultdict(lambda: [0] * 6)
        for name, rec in manifest["leaves"].items():
            for s in rec["shards"]:
                if "chunks" in s:
                    try:
                        payload = chunk_store.read_payload(
                            s["chunks"], s.get("payload_bytes"))
                        if (zlib.crc32(payload) & 0xFFFFFFFF) != s["crc32"]:
                            raise ValueError("payload crc mismatch")
                        rng = ShardRange(tuple(s["start"]), tuple(s["stop"]))
                        codec_decode(payload, s["codec"], rng.shape,
                                     s["dtype"], s.get("meta", {}))
                        if s["codec"] in CHUNK_ENCODED:
                            # payload is the ENCODED stream (v7 records:
                            # crc/lens describe stored bytes) — walk its
                            # block framing for the per-plane view
                            raw_len = s.get("raw_payload_bytes")
                            if raw_len is None:
                                numel = 1
                                for d in rng.shape:
                                    numel *= d
                                raw_len = numel * \
                                    _np_dtype(s["dtype"]).itemsize
                            k = (s.get("meta") or {}).get("bp") or \
                                _np_dtype(s["dtype"]).itemsize
                            _entropy_planes(payload, int(raw_len), int(k),
                                            s["codec"], plane_table)
                        good += 1
                    except Exception as e:  # noqa
                        bad += 1
                        report["problems"].append(
                            f"{name}: chunked shard unreadable "
                            f"({type(e).__name__}: {e})")
                    continue
                readable = False
                for i, fname in enumerate(s.get("replicas", [s["file"]])):
                    p = mdir / fname
                    if not p.exists():
                        continue
                    try:
                        _unpack_shard(p.read_bytes())
                        readable = True
                        if i > 0:
                            replicas_ok += 1
                        break
                    except Exception as e:  # noqa
                        report["problems"].append(
                            f"{name}: {fname}: {type(e).__name__}")
                if readable:
                    good += 1
                else:
                    bad += 1
                    report["problems"].append(
                        f"{name}: shard {s['file']} unreadable on all "
                        f"replicas")
        _emit_entropy_planes(plane_table, report, out)
        out(f"  verify: {good} shard(s) ok, {bad} damaged"
            + (f", {replicas_ok} recovered via buddy replica"
               if replicas_ok else ""))
        report.update(verified=True, shards_ok=good, shards_bad=bad)
    report["ok"] = not report["problems"]
    for p in report["problems"]:
        out(f"  !! {p}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", type=Path)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--slow-root", type=Path, default=None,
                    help="slow (scratch) tier root — adds its per-tier "
                         "residency column for the inspected step")
    ap.add_argument("--remote-root", type=Path, default=None,
                    help="remote object-store tier root — adds its "
                         "per-tier residency column")
    ap.add_argument("--scrub", action="store_true",
                    help="re-hash live chunk objects across the mounted "
                         "tiers; quarantine corrupt copies and heal from "
                         "a good replica/tier")
    ap.add_argument("--scrub-sample", type=int, default=None,
                    help="scrub a seeded N-digest sample instead of the "
                         "full live set")
    ap.add_argument("--scrub-seed", type=int, default=0,
                    help="seed for --scrub-sample (replayable subset)")
    ap.add_argument("--subscribers", action="store_true",
                    help="print the WeightSync announcement and every "
                         "published replica status (state, flipped step, "
                         "cache residency, peer/source wire split)")
    ap.add_argument("--health", action="store_true",
                    help="print per-tier error counters, circuit-breaker "
                         "state, quarantine contents and the last scrub "
                         "summary")
    args = ap.parse_args(argv)
    sink = (lambda *_: None) if args.json else print
    if args.scrub or args.health or args.subscribers:
        rep = {}
        if args.scrub:
            rep["scrub"] = run_scrub(
                args.root, slow_root=args.slow_root,
                remote_root=args.remote_root, sample=args.scrub_sample,
                seed=args.scrub_seed, out=sink)
        if args.health:
            rep["health"] = run_health(
                args.root, slow_root=args.slow_root,
                remote_root=args.remote_root, out=sink)
        if args.subscribers:
            rep["subscribers"] = run_subscribers(args.root, out=sink)
        rep["ok"] = all(r["ok"] for r in rep.values())
        if args.json:
            print(json.dumps(rep, indent=1, default=str))
        return 0 if rep["ok"] else 1
    rep = inspect(args.root, step=args.step, verify=args.verify, out=sink,
                  slow_root=args.slow_root, remote_root=args.remote_root)
    if args.json:
        print(json.dumps(rep, indent=1, default=str))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
