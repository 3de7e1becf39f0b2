#!/usr/bin/env python3
"""Where K4's time goes: time the byteplane inverse kernel
(``src/repro_torch/csrc/byteplane_inv.cu``) on 603,979,776 random bytes
(the size of gemma3-1b's ``params/embed`` in bf16) at itemsizes 1, 2 and 4,
with one part of it changed at a time, beside an older design and a copy of
the same bytes.

    python3 scripts/k4_ablation.py                       # every variant
    python3 scripts/k4_ablation.py base tile16384        # some of them
    python3 scripts/k4_ablation.py --old OLD/byteplane_inv.cu  # + an old
                                                         #   design

Variants of the source (each edits a copy; the edit must find its anchor;
``a+b`` applies the edits of both):
  base        the kernel as it is (tiles of 32 KB of input, copied into
              shared memory with bulk copies; each lane of the look-back
              reads one status word a step; streaming stores)
  carveout    the launch first sets the kernel's preferred shared memory
              carveout to all of it (cudaFuncSetAttribute)
  look2/look4/look8  the look-back replaced by one whose lanes each read
              2, 4 or 8 consecutive status words a step
  tile64k     tiles of 64 KB (the dynamic shared memory limit raised past
              48 KB, the carveout as in ``carveout``)
  tile96k     tiles of 96 KB (likewise)
  acquire     status words written with st.release.gpu and polled with
              ld.acquire.gpu (the kernel's are relaxed)
  sleep       the look-back's poll backs off 32 ns (__nanosleep) before
              it reads again the words not yet published
  nostcs      the output stored with plain 16-byte stores
  trace       the kernel as it is, with each tile's CTA writing the global
              timer (ns) as it takes its tile, once its bulk copies have
              landed, once its look-back ends and once its stores are
              issued, and its SM, after the status words; one JSON line an
              itemsize summarises them (``phases_us``: percentiles of each
              phase; with the kernel's own tiles only)
  nolookback  no look-back: every tile's prefix taken as 0. Its output is
              wrong (not checked); its time is what the kernel costs
              without waiting on its predecessors
``--old PATH`` builds another ``byteplane_inv.cu`` with the same C
interface (the earlier three-launch design) and times it as ``old``;
``copy`` is ``out.copy_(u8)``, the same bytes read and written once.

Each variant is held byte for byte against ``inverse_plain`` at every
itemsize, then timed in ``ROUNDS`` rounds (CUDA events, 10 launches a
round after a warm-up; the order of the variants reversed every other
round). Prints one JSON line a variant (median ms and every round's ms at
each itemsize, the share of the bound 2n / 3.35 TB/s) and the card's name
and power limit. Builds go to ``build/k4_ablation/``. Needs nvcc and a card
(sm_90a).
"""
from __future__ import annotations

import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "byteplane_inv.cu"
OUT = ROOT / "build" / "k4_ablation"
N = 603_979_776
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
ITEMSIZES = (1, 2, 4)
ROUNDS = 5
UNCHECKED = {"nolookback"}      # wrong on purpose: timed, not checked
TRACE_AT = 1 << 20              # the trace's offset in the scratch (bytes)
TIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));'

STORE = ("__stcs(reinterpret_cast<uint4*>(dst) + j,\n"
         "               make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], "
         "o[4 * j + 3]));")
TABLE = "{0, 32768, 16384, 8192, 8192, 4096, 4096,\n                               4096, 4096}"


def tile_bytes(n: int) -> tuple:
    return ("constexpr int TILE_BYTES = 32768;",
            f"constexpr int TILE_BYTES = {n};")


LAUNCH = "  const int64_t blocks = ntiles > 0 ? ntiles : 1;\n"
CARVEOUT = (LAUNCH, """  {
    const cudaError_t e = cudaFuncSetAttribute(
        inverse_tiles<K>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
""" + LAUNCH)
SMEM_LIMIT = (LAUNCH, """  {
    const cudaError_t e = cudaFuncSetAttribute(
        inverse_tiles<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TILE_ELEMS[K] * K);
    if (e != cudaSuccess) return (int)e;
  }
""" + LAUNCH)
# the look-back with LOOK consecutive status words a lane per step (lane 0
# the nearest): it waits only for the words nearer than the nearest P
LOOK_BACK_WIDE = """__device__ __forceinline__ uint32_t look_back(const unsigned long long* st,
                                              int stride, int64_t tile) {
  constexpr int LOOK = %d;
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (int64_t i0 = tile - 1 - (int64_t)lane * LOOK;; i0 -= 32 * LOOK) {
    unsigned long long s[LOOK];
#pragma unroll
    for (int j = 0; j < LOOK; ++j)
      s[j] = i0 - j >= 0 ? peek(st + (i0 - j) * stride) : FLAG_P;
    int jp, lp;                  // the nearest P: its lane and place there
    for (;;) {
      int ju = LOOK;             // the lane's nearest unpublished word
      jp = LOOK;
#pragma unroll
      for (int j = LOOK - 1; j >= 0; --j) {
        if ((s[j] >> 32) == 0) ju = j;
        if (s[j] & FLAG_P) jp = j;
      }
      const unsigned pl = __ballot_sync(FULL, jp < LOOK);
      lp = pl ? __ffs(pl) - 1 : 32;
      const bool wait = lane < lp ? ju < LOOK : (lane == lp && ju < jp);
      if (!__any_sync(FULL, wait)) break;
#pragma unroll
      for (int j = 0; j < LOOK; ++j)
        if ((s[j] >> 32) == 0) s[j] = peek(st + (i0 - j) * stride);
    }
    uint32_t sum = 0u;
#pragma unroll
    for (int j = 0; j < LOOK; ++j)
      if (lane < lp || (lane == lp && j <= jp))
        sum = __vadd4(sum, (uint32_t)s[j]);
    prefix = __vadd4(prefix, warp_sum4(sum));
    if (lp < 32) return prefix;
  }
}"""
EDITS = {
    "base": [],
    "carveout": [CARVEOUT],
    "look2": [("look_back", LOOK_BACK_WIDE % 2)],
    "look4": [("look_back", LOOK_BACK_WIDE % 4)],
    "look8": [("look_back", LOOK_BACK_WIDE % 8)],
    "tile64k": [(TABLE, "{0, 65536, 32768, 16384, 16384, 8192, 8192, 8192, "
                        "8192}"), tile_bytes(65536), SMEM_LIMIT, CARVEOUT],
    "tile96k": [(TABLE, "{0, 98304, 49152, 24576, 24576, 12288, 12288, "
                        "12288, 12288}"), tile_bytes(98304), SMEM_LIMIT,
                CARVEOUT],
    "acquire": [("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64"),
                ("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64")],
    "sleep": [("      if ((s >> 32) == 0) s = peek(st + i * stride);\n",
               "      __nanosleep(32);\n"
               "      if ((s >> 32) == 0) s = peek(st + i * stride);\n")],
    "nostcs": [(STORE, "reinterpret_cast<uint4*>(dst)[j] =\n"
                       "            make_uint4(o[4 * j], o[4 * j + 1], "
                       "o[4 * j + 2], o[4 * j + 3]);")],
    "trace": [
        ("  const int64_t tile = s_tile;\n",
         "  const int64_t tile = s_tile;\n"
         "  unsigned long long* trace_ = reinterpret_cast<unsigned long long*>("
         "reinterpret_cast<char*>(status) + " + str(TRACE_AT) + ") + tile * 5;\n"
         "  unsigned long long t0_, t1_, t2_;\n  " + TIMER.format("t0_") + "\n"),
        ("    mbar_wait(bar, 0);",
         "    mbar_wait(bar, 0);\n    " + TIMER.format("t1_") + "\n"
         "    if (threadIdx.x == 0) trace_[2] = t1_;"),
        ("      prefix = look_back(status + g, G, tile);\n",
         "      prefix = look_back(status + g, G, tile);\n"
         "      if (threadIdx.x == 0) {\n        " + TIMER.format("t2_") +
         "\n        trace_[2] = t2_;\n      }\n"),
        ("  if (tile == 0 && threadIdx.x < tail)",
         "  if (threadIdx.x == 0) {\n    unsigned long long t3_;\n"
         "    unsigned sm_;\n    " + TIMER.format("t3_") + "\n"
         '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));\n'
         "    trace_[0] = t0_; trace_[1] = t1_; trace_[3] = t3_; "
         "trace_[4] = sm_;\n  }\n"
         "  if (tile == 0 && threadIdx.x < tail)")],
    "nolookback": [("      prefix = look_back(status + g, G, tile);",
                    "      prefix = 0u;")],
}


def replace_function(s: str, fn: str, new: str) -> str:
    """`s` with the device function named `fn` (from its ``__device__``
    line through its closing brace) replaced by `new`."""
    head = s.index(f"uint32_t {fn}(")
    start = s.rindex("\n", 0, head) + 1
    depth, i = 0, s.index("{", head)
    while True:
        depth += {"{": 1, "}": -1}.get(s[i], 0)
        if depth == 0:
            return s[:start] + new + s[i + 1:]
        i += 1


def variant_source(name: str) -> Path:
    s = SOURCE.read_text()
    for old, new in (e for part in name.split("+") for e in EDITS[part]):
        if old == "look_back":
            s = replace_function(s, old, new)
            continue
        if old not in s:
            raise SystemExit(f"{name}: anchor not found: {old!r}")
        s = s.replace(old, new, 1)
    path = OUT / name / "byteplane_inv.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(s)
    return path


def trace_summary(fn, u8, out, k: int) -> dict:
    """One launch of the ``trace`` variant: percentiles (µs) of each tile's
    phases (take to copies landed, through the look-back, on to stores
    issued, the whole), the tiles in flight on average and at most."""
    import numpy as np
    import torch

    from repro_torch.kernels.ckpt_codec import byteplane as bp
    ntiles = -(-(u8.numel() // k) // bp.INV_TILE[k])
    fn(u8, out, k)
    torch.cuda.synchronize()
    raw = fn.scratch["t"][TRACE_AT:TRACE_AT + ntiles * 40]
    tr = raw.view(torch.int64).view(ntiles, 5).cpu().numpy()
    t0, t1, t2, t3 = (tr[:, i].astype(np.float64) for i in range(4))
    span = t3.max() - t0.min()
    pct = (10, 50, 90, 99)

    def q(x):
        return {p: float(np.percentile(x, p)) / 1e3 for p in pct}
    ev = np.concatenate([np.stack([t0, np.ones(ntiles)], 1),
                         np.stack([t3, -np.ones(ntiles)], 1)])
    ev = ev[np.argsort(ev[:, 0], kind="stable")]
    return {"trace_itemsize": k, "tiles": ntiles, "span_us": span / 1e3,
            "phases_us": {"loads": q(t1 - t0), "look_back": q(t2 - t1),
                          "stores": q(t3 - t2), "whole": q(t3 - t0)},
            "in_flight_mean": float((t3 - t0).sum() / span),
            "in_flight_max": int(np.cumsum(ev[:, 1]).max()),
            "sms": int(np.unique(tr[:, 4]).size)}


def main() -> int:
    import torch

    from repro_torch.kernels import timing
    from repro_torch.kernels.ckpt_codec import byteplane as bp

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args = sys.argv[1:]
    old = None
    if "--old" in args:
        i = args.index("--old")
        old = Path(args[i + 1])
        del args[i:i + 2]
    names = args or list(EDITS)
    unknown = {p for n in names for p in n.split("+")} - set(EDITS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; "
                         f"known: {list(EDITS)}")
    card = timing.card_line()
    srcs = {n: variant_source(n) for n in names}
    if old is not None:
        srcs["old"] = old
    with ThreadPoolExecutor(len(srcs)) as pool:
        fns = dict(zip(srcs, pool.map(
            lambda kv: timing.byteplane_inv_launcher(timing.load_variant(
                "byteplane_inv", kv[1], OUT / kv[0])), srcs.items())))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    u8 = torch.randint(0, 256, (N,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    out = torch.empty_like(u8)
    bound_ms = 2 * N / HBM_BYTES_PER_S * 1e3
    runs = {name: {k: [] for k in ITEMSIZES} for name in [*fns, "copy"]}
    for k in ITEMSIZES:
        want = bp.inverse_plain(u8, k)
        for name, fn in fns.items():
            if name in UNCHECKED:
                continue
            out.zero_()
            if not torch.equal(fn(u8, out, k), want):
                raise SystemExit(f"{name} != inverse_plain at k={k}")
        del want
        order = [*fns, "copy"]
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                if name == "copy":
                    ms = timing.time_ms(lambda: out.copy_(u8), iters=10)
                else:
                    fn = fns[name]
                    ms = timing.time_ms(lambda: fn(u8, out, k), iters=10)
                runs[name][k].append(ms)
    for name, fn in fns.items():
        if "trace" in name.split("+"):
            for k in ITEMSIZES:
                print(json.dumps({"variant": name,
                                  **trace_summary(fn, u8, out, k)}),
                      flush=True)
    for name, by_k in runs.items():
        med = {k: statistics.median(v) for k, v in by_k.items()}
        print(json.dumps({
            "variant": name, "bytes": N, "bound_ms": bound_ms,
            "ms": med, "bound_share": {k: bound_ms / m for k, m in
                                       med.items()},
            "rounds_ms": by_k}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
