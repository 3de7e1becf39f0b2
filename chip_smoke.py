#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # everything, as documented below
    python3 chip_smoke.py --parity-only  # build + kernel parity, no main path
    python3 chip_smoke.py --profile      # + device time of save 2 / restore

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. Kernel parity on the card: each kernel against its plain PyTorch version
   byte for byte (tolerance 0) on 64 MiB of random bytes, ragged lengths,
   all-zero and constant runs (runs > 255, across 4096-byte blocks, a
   partial last block) and itemsizes 1/2/4/8; the gear scan's candidates
   against the numpy oracle on a 16 MiB slice; the RLE glue's stream
   against the numpy codec oracle.
3. The main path: the full gemma3-1b training state (bf16 params, f32
   AdamW moments; 321 leaves, ~10.0 GB) on the card, saved by
   ``CheckpointManager`` as an incremental CDC round (params through the
   fused K2+K1+K3 dispatch, moments through the segmented K1 scan), ~10% of
   the leaves changed, saved again asynchronously, restored onto the card
   and compared bit for bit. Every kernel's launch count must be > 0, and
   two leaves re-encoded by the host oracle must give the same chunk
   digests.
4. Prints one JSON line of per-kernel numbers (CUDA-event times at the
   main path's largest shapes, bounds from the bytes each kernel moves),
   one JSON line of end-to-end save/restore numbers, and last the
   ``{"ok": true, "device": ...}`` line. Any failure exits non-zero.

It imports nothing of JAX or of the ``repro`` package. Scratch checkpoints
go to ``build/chip_smoke_store`` (removed at the end), logs to
``chiprun_out/``.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
MIN_FREE_BYTES = 25e9
MiB = 1 << 20


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bits(t):
    import torch
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def max_abs_err(a, b) -> int:
    import torch
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


class DeviceProfile:
    """``with DeviceProfile(on) as p:`` traces the CUDA activity of the
    block with ``torch.profiler`` when `on`; ``p.summary(wall_s)`` then
    gives device-busy seconds (kernels + copies, one stream: they do not
    overlap), the idle share of the wall time, and the top entries."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)

    def summary(self, wall_s: float):
        if self.prof is None:
            return None
        rows = sorted(((e.key, e.count, e.self_device_time_total)
                       for e in self.prof.key_averages()
                       if e.self_device_time_total > 0),
                      key=lambda r: -r[2])
        busy = sum(r[2] for r in rows) / 1e6
        return {"wall_s": wall_s, "device_busy_s": busy,
                "idle_share": 1.0 - busy / wall_s,
                "top": [{"name": k[:80], "count": c, "ms": us / 1e3}
                        for k, c, us in rows[:12]]}


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of `fn()` over `iters` runs after `warmup`."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2 — kernel parity
# ---------------------------------------------------------------------------

def parity(dev):
    import numpy as np
    import torch

    from repro_torch.core import cdc_scan
    from repro_torch.core.cdc import GearChunker
    from repro_torch.core.codec import plane_stream_encode
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent

    ck = GearChunker(1 << 20, device=dev)
    ms, ml = int(ck.mask_strict), int(ck.mask_loose)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def rand(n):
        return torch.randint(0, 256, (n,), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def runs(n, maxlen=700):
        reps = torch.randint(1, maxlen, (n // 100 + 1,), generator=g,
                             device=dev)
        vals = torch.randint(0, 256, reps.shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)
        return torch.repeat_interleave(vals, reps)[:n].contiguous()

    inputs = {
        "random_64MiB": rand(64 * MiB),
        "random_ragged": rand(64 * MiB + 12_345),
        "zeros_ragged": torch.zeros(5 * MiB + 7, dtype=torch.uint8,
                                    device=dev),
        "const_partial_block": torch.full((4096 * 37 + 1000,), 0xA7,
                                          dtype=torch.uint8, device=dev),
        "runs_ragged": runs(3 * MiB + 4097),
        "one_byte": rand(1),
        "window": rand(64),
    }
    checks = 0
    for name, u8 in inputs.items():
        n = u8.numel()
        for k in (1, 2, 4, 8):
            a, b = bp.forward_planes(u8, k), bp.forward_plain(u8, k)
            if not torch.equal(a, b):
                fail(f"K2 byteplane_fwd != plain on {name} k={k}")
            checks += 1
        padded = torch.zeros(cdc_scan.padded_len(n), dtype=torch.uint8,
                             device=dev)
        padded[cdc_scan.WINDOW:cdc_scan.WINDOW + n] = u8
        if not torch.equal(cdc_scan.gear_scan(padded, ms, ml),
                           cdc_scan.gear_scan_plain(padded, ms, ml)):
            fail(f"K1 gear_scan != plain on {name}")
        nb = -(-n // ent.B)
        blk = torch.zeros(nb * ent.B, dtype=torch.uint8, device=dev)
        blk[:n] = u8
        blk = blk.view(nb, ent.B)
        for a, b in zip(ent.rle_emission(blk, n),
                        ent.rle_emission_plain(blk, n)):
            if not torch.equal(a, b):
                fail(f"K3 rle_emit != plain on {name}")
        checks += 2
        torch.cuda.synchronize()
    # K1 through the segmented scanner: candidates vs the numpy oracle
    data = inputs["random_64MiB"][:16 * MiB].cpu().numpy()
    got = cdc_scan.GearScanner(ms, ml, backend="pallas",
                               device=dev).scan(data)
    ref = cdc_scan.scan_candidates_numpy(data, ms, ml)
    if not all(np.array_equal(x, y) for x, y in zip(got, ref)):
        fail("K1 candidates != numpy oracle on the 16 MiB slice")
    # K3 + glue: the framed stream vs the numpy codec oracle
    t = bp.forward_plain(runs(4 * MiB + 999, 3000), 2).cpu().numpy()
    s, bl = ent.encode_stream(t, "byteplane-rle", device=dev)
    rs, rbl = plane_stream_encode(t, "byteplane-rle")
    if not (np.array_equal(s, rs) and np.array_equal(bl, rbl)):
        fail("byteplane-rle stream on the card != numpy oracle")
    say(f"parity: {checks + 2} kernel/plain comparisons byte-identical "
        f"({len(inputs)} inputs, k in 1/2/4/8); 16 MiB candidate slice "
        f"and RLE stream identical to the numpy oracles")
    del inputs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3 — the main path
# ---------------------------------------------------------------------------

def main_path(dev, card: str, profile: bool = False):
    import torch

    from repro_torch.configs import gemma3_1b
    from repro_torch.core import cdc_scan
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                         CodecPolicy, DurabilityPolicy,
                                         PipelinePolicy)
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent
    from repro_torch.state import train_state

    store_dir = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    free = shutil.disk_usage(store_dir).free
    say(f"store: {store_dir} free={free}")
    if free < MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {store_dir}; need "
             f"{int(MIN_FREE_BYTES)} for two rounds of the 10 GB state")

    def policy(scan="auto", keepalive_s=60.0, **codec):
        return CheckpointPolicy(
            mode="incremental",
            chunking=ChunkingPolicy(scheme="cdc", chunk_size=MiB,
                                    scan_backend=scan),
            pipeline=PipelinePolicy(io_threads=8),
            durability=DurabilityPolicy(keepalive_s=keepalive_s),
            codec=CodecPolicy(codec="raw", params_codec="byteplane-rle",
                              **codec))

    try:
        t0 = time.monotonic()
        state = train_state(gemma3_1b.CONFIG, dev, seed=0)
        torch.cuda.synchronize()
        leaves = leaf_paths(state)
        nbytes = sum(t.nbytes for _, t in leaves)
        say(f"state: gemma3-1b full width/depth, {len(leaves)} leaves, "
            f"{nbytes} bytes, built in {time.monotonic() - t0:.3f} s")
        mgr = CheckpointManager(TieredStore(Tier("fast", store_dir / "a")),
                                policy(), device=dev)
        cdc_scan.launches = bp.launches = ent.launches = 0
        t0 = time.monotonic()
        r1 = mgr.save(state, 1)
        save1_s = time.monotonic() - t0
        say(f"save step 1: {save1_s:.3f} s, new_object_bytes="
            f"{r1['new_object_bytes']} chunks={r1['chunks']}")
        changed = changed_bytes = 0
        for i, (name, t) in enumerate(leaves):
            if i % 10 != 3 and name != "step":
                continue
            if t.dtype.is_floating_point:
                t.add_(1e-3)
            else:
                bits(t).add_(1)
            changed += 1
            changed_bytes += t.nbytes
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with DeviceProfile(profile) as prof2:
            mgr.save(state, 2, blocking=False)
            mgr.wait()
        save2_s = time.monotonic() - t0
        r2 = mgr.last_report
        launches = {"gear_scan": cdc_scan.launches,
                    "byteplane_fwd": bp.launches,
                    "rle_emit": ent.launches}
        say(f"save step 2 (async, {changed} leaves / {changed_bytes} bytes "
            f"changed): {save2_s:.3f} s, new_object_bytes="
            f"{r2['new_object_bytes']}; launches {launches}")
        for k, v in launches.items():
            if v <= 0:
                fail(f"kernel {k} was not launched on the main path")
        if not r2["new_object_bytes"] < 0.5 * r1["new_object_bytes"]:
            fail("step 2 did not dedup against step 1")
        t0 = time.monotonic()
        with DeviceProfile(profile) as prof_r:
            restored, _ = mgr.restore(state, step=2)
            torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        for (name, a), (_, b) in zip(leaf_paths(restored), leaves):
            if not (a.device == b.device and a.dtype == b.dtype
                    and a.shape == b.shape
                    and torch.equal(bits(a), bits(b))):
                fail(f"restored leaf {name} is not bit-exact")
        say(f"restore step 2 onto {dev}: {restore_s:.3f} s, all "
            f"{len(leaves)} leaves bit-exact")
        del restored
        # the host oracle re-encodes two leaves: same chunk digests
        m2 = mgr.load_manifest(2)["leaves"]
        sub_names = ("params/embed", "params/stage_0/b0/mlp/wg")
        sub = {"params": {"embed": state["params"]["embed"],
                          "stage_0": {"b0": {"mlp": {
                              "wg": state["params"]["stage_0"]["b0"]["mlp"]
                              ["wg"]}}}}}
        # the numpy oracle encodes a 604 MB leaf in one go before its first
        # chunk (and heartbeat): give its writer a longer keepalive
        oracle = CheckpointManager(
            TieredStore(Tier("fast", store_dir / "oracle")),
            policy(scan="numpy", keepalive_s=600.0,
                   device_precondition=False), device=dev)
        t0 = time.monotonic()
        oracle.save(sub, 2)
        oracle_s = time.monotonic() - t0
        mo = oracle.load_manifest(2)["leaves"]
        for name in sub_names:
            if mo[name]["shards"] != m2[name]["shards"]:
                fail(f"{name}: host-oracle chunk records differ from the "
                     "device path's")
        say(f"host oracle re-encode of {sub_names} ({oracle_s:.3f} s): "
            f"identical chunk digests "
            f"({len(m2['params/embed']['shards'][0]['chunks'])} chunks for "
            f"params/embed)")
        oracle.close()
        mgr.close()
        stats = {"save1_s": save1_s, "save2_s": save2_s,
                 "restore_s": restore_s, "state_bytes": nbytes,
                 "save1_GBps": nbytes / save1_s / 1e9,
                 "save2_GBps": nbytes / save2_s / 1e9,
                 "restore_GBps": nbytes / restore_s / 1e9,
                 "new_object_bytes_1": r1["new_object_bytes"],
                 "new_object_bytes_2": r2["new_object_bytes"],
                 "chunks_1": r1["chunks"], "changed_leaves": changed,
                 "snapshot1_s": r1["snapshot_s"],
                 "snapshot2_s": r2["snapshot_s"],
                 "oracle_reencode_s": oracle_s, "profiled": profile,
                 "card": card}
        if profile:
            stats["device_save2"] = prof2.summary(save2_s)
            stats["device_restore"] = prof_r.summary(restore_s)
        return state, launches, stats
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4 — per-kernel numbers at the main path's largest shapes
# ---------------------------------------------------------------------------

def kernel_table(dev, embed, launches: dict) -> list:
    """Time each kernel and its plain version on the largest payload the
    main path gives it: params/embed (the fused dispatch's biggest)."""
    import torch

    from repro_torch.core import cdc_scan
    from repro_torch.core.cdc import GearChunker
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent

    ck = GearChunker(MiB, device=dev)          # the main path's masks
    ms, ml = int(ck.mask_strict), int(ck.mask_loose)
    raw = embed.reshape(-1).view(torch.uint8)
    n = raw.numel()
    t = bp.forward_planes(raw, 2)
    padded = torch.zeros(cdc_scan.padded_len(n), dtype=torch.uint8,
                         device=dev)
    padded[cdc_scan.WINDOW:cdc_scan.WINDOW + n] = t
    nb = -(-n // ent.B)
    blk = torch.zeros(nb * ent.B, dtype=torch.uint8, device=dev)
    blk[:n] = t
    blk = blk.view(nb, ent.B)
    saved = dict(launches)
    rows = []
    specs = [
        ("gear_scan", "src/repro_torch/csrc/gear_scan.cu",
         "src/repro/core/cdc_scan.py:301",
         lambda: cdc_scan.gear_scan(padded, ms, ml),
         lambda: cdc_scan.gear_scan_plain(padded, ms, ml),
         2 * padded.numel(), list(padded.shape)),
        ("byteplane_fwd", "src/repro_torch/csrc/byteplane_fwd.cu",
         "src/repro/kernels/ckpt_codec/byteplane.py:101",
         lambda: bp.forward_planes(raw, 2),
         lambda: bp.forward_plain(raw, 2), 2 * n, [n]),
        ("rle_emit", "src/repro_torch/csrc/rle_emit.cu",
         "src/repro/kernels/ckpt_codec/entropy.py:88",
         lambda: ent.rle_emission(blk, n),
         lambda: ent.rle_emission_plain(blk, n), 3 * blk.numel(),
         list(blk.shape)),
    ]
    for name, src, replaces, kern, plain, moved, shape in specs:
        a, b = kern(), plain()
        if not isinstance(a, tuple):
            a, b = (a,), (b,)
        err = max(max_abs_err(x, y) for x, y in zip(a, b))
        if err:
            fail(f"{name} disagrees with its plain version at the main "
                 f"path's shape (max abs err {err})")
        del a, b
        ms_k = time_ms(kern, iters=10)
        ms_p = time_ms(plain, iters=2)
        torch.cuda.empty_cache()
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": saved[name],
            "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape,
        })
    return rows


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             "(src/repro_torch missing)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    card = card_line()
    say(card)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build
    t0 = time.monotonic()
    logs = build.build_all()
    say(f"build: {len(logs)} kernels in {time.monotonic() - t0:.3f} s "
        f"(nvcc, sm_90a) into {build.build_dir()}")
    (out_dir / "chip_smoke_ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    dev = torch.device("cuda")
    parity(dev)
    if "--parity-only" in sys.argv[1:]:
        say(card)
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    state, launches, stats = main_path(dev, card,
                                       profile="--profile" in sys.argv[1:])
    embed = state["params"]["embed"]
    del state
    torch.cuda.empty_cache()
    rows = kernel_table(dev, embed, launches)
    say(card)
    say(json.dumps({"main_path": stats}))
    say(json.dumps({"kernels": rows}))
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps({"card": card, "main_path": stats, "kernels": rows},
                   indent=1))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
