#!/usr/bin/env python3
"""Where K7's time goes, and what it replaced: time the RMSNorm kernel
(``src/repro_torch/csrc/rmsnorm.cu``) at every shape of
``chip_smoke.K7_SHAPES`` (bf16, the L2 cold, device ms a call inside a
CUDA graph) with one part of its stream route changed at a time, beside an
older design of the kernel.

    python3 scripts/k7_ablation.py                       # every variant
    python3 scripts/k7_ablation.py base stages2          # some of them
    python3 scripts/k7_ablation.py --old OLD/rmsnorm.cu  # + an old design
    python3 scripts/k7_ablation.py --wide                # + 16,384 rows of
                                                         #   D 512 ... 8192

Variants of the source (each edits a copy; the edit must find its anchor):
  base        the kernel as it is, on the launcher's plan
  noevict     bulk loads without the L2 evict_first hint
  release0    a consumer warp waits for its bulk store to read a stage and
              releases that stage at once (not one stage later)
  directstore the consumer warps write y to global memory from registers
              (16-byte stores) instead of through the stage and a bulk store
  ldcs        the warp route loads x with ld.global.cs (streaming) in place
              of __ldg
  stcs        the warp route stores y with st.global.cs (streaming)
  held6/held8 the warp route holds 6 or 8 vectors a lane, not 5 (more
              registers; rows of up to 3 or 4 KB held)
  lb64        the warp kernel launch-bounded to 64 registers a thread
Variants of the stream plan (the same library, another launch plan):
  stages2     a ring of two stages
  onecta      one CTA an SM (a grid of the SM count)
  halfrows    half the rows a stage
  doublerows  twice the rows a stage (where the stage still fits)
  fourcta     half the rows a stage and up to four CTAs an SM
Plans of the warp kernel: ``warp{W}``, a grid of ceil(N / W) CTAs of W
warps, one row a warp (``warp1`` is the warp route). Routes, forced:
``stream`` and ``warp`` (one warp a row and a CTA, 16-byte loads into
registers: the stream route's yardstick). ``--old PATH`` builds
an earlier ``rmsnorm.cu`` with the C interface it had before launch plans
(x, scale, out, rows, D, eps, x_bf16, scale_bf16, stream) and times it
as ``old``; ``rmsnorm_plain`` is timed as ``plain``, ``F.rms_norm`` as
``library``, and a copy of x (``clone``: the same bytes read and written)
as ``copy``.

Prints one JSON line a variant (ms at each shape; max abs error against
``rmsnorm_plain`` at the prefill block norm where the variant is a full
kernel) and the card's name and power limit. Builds go to
``build/k7_ablation/``. Needs nvcc and a card (sm_90a).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "rmsnorm.cu"
OUT = ROOT / "build" / "k7_ablation"

EDITS = {
    "base": [],
    "noevict": [(".L2::cache_hint [%0], [%1], %2, [%3], %4;\\n\" ::\"r\"(dst),\n"
                 "      \"l\"(src), \"r\"(bytes), \"r\"(bar), \"l\"(pol)",
                 " [%0], [%1], %2, [%3];\\n\" ::\"r\"(dst),\n"
                 "      \"l\"(src), \"r\"(bytes), \"r\"(bar)")],
    "directstore": [
        ("    for (int j = 0; j < cnt; ++j)\n"
         "      norm_row_shared<T>(reinterpret_cast<uint4*>(mine + j * "
         "row_bytes), w,\n                         nvec, d, eps, lane);",
         """    constexpr int N = Vec<T>::N;
    for (int j = 0; j < cnt; ++j) {
      const uint4* row = reinterpret_cast<const uint4*>(mine + j * row_bytes);
      uint4* orow = reinterpret_cast<uint4*>(out + (row0 + first + j) * d);
      float ss = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        float f[N];
        unpack<T>(row[v], f);
        add_squares(f, ss);
      }
      const float r = inv_rms(warp_total(ss), d, eps);
      for (int v = lane; v < nvec; v += 32) {
        float f[N];
        unpack<T>(row[v], f);
        for (int e = 0; e < N; ++e) f[e] = norm_out(f[e], r, w[v * N + e]);
        orow[v] = pack<T>(f);
      }
    }"""),
        ("      if (cnt > 0)\n        bulk_store(out + (row0 + first) * d, "
         "smem_u32(mine),\n                   (uint32_t)(cnt * row_bytes));\n",
         "")],
    "ldcs": [("        if (idx < nvec) v[j] = __ldg(xr + idx);",
              "        if (idx < nvec) v[j] = __ldcs(xr + idx);")],
    "stcs": [("        orow[idx] = pack<T>(f);",
              "        __stcs(orow + idx, pack<T>(f));")],
    "held6": [("constexpr int HELD = 5;", "constexpr int HELD = 6;")],
    "held8": [("constexpr int HELD = 5;", "constexpr int HELD = 8;")],
    "lb64": [("__launch_bounds__(MAX_WARPS * 32)\nrms_warp_kernel",
              "__launch_bounds__(MAX_WARPS * 32, 4)\nrms_warp_kernel")],
    "release0": [("      if (i > 0) {\n        bulk_wait_read_all_but_one();\n"
                  "        mbar_arrive(empty((i - 1) % stages));\n      }",
                  "      asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\""
                  " ::: \"memory\");\n      mbar_arrive(empty(s));")],
}
PLANS = ("stages2", "onecta", "halfrows", "doublerows", "fourcta")
ROUTES = ("stream", "warp")
# the warp kernel on a grid of ceil(N / W) CTAs of W warps: warp{W}
WARP_PLANS = ("warp2", "warp4", "warp8")


def variant_source(name: str) -> str:
    s = SOURCE.read_text()
    for old, new in EDITS[name]:
        if old not in s:
            raise SystemExit(f"{name}: anchor not found: {old!r}")
        s = s.replace(old, new)
    return s


def build(name: str, text: str) -> Path:
    from repro_torch.kernels import build as kb
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    r = subprocess.run([kb.nvcc(), *kb.NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    return so


def plan_variant(name: str, plan, n: int, d: int, sms: int):
    """`plan` (a stream plan) with one part changed, or None where the
    change does not apply."""
    from repro_torch.kernels.rmsnorm import ops as rn
    if plan.route != "stream":
        return None
    rows, stages = plan.rows, plan.stages
    if name == "stages2":
        stages = 2
    elif name in ("halfrows", "fourcta"):
        rows = rows // 2
    elif name == "doublerows":
        rows = rows * 2
    if rows < 1 or rows * d * 2 >= 1 << 20:
        return None
    smem = rn.stream_smem(d, 2, rows, stages)
    if smem > rn.SMEM_LIMIT:
        return None
    warps = min(rn.MAX_WARPS, rows)
    cap = {"onecta": 1, "fourcta": 4}.get(name, 2)
    per_sm = max(1, min(cap, rn.SMEM_PER_SM // (smem + 1024)))
    grid = min(-(-n // rows), per_sm * sms)
    return rn.Plan("stream", rows, stages, warps, grid, smem)


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.rmsnorm import ops as rn
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args = sys.argv[1:]
    old = None
    if "--old" in args:
        i = args.index("--old")
        old = Path(args[i + 1])
        del args[i:i + 2]
    every = [*EDITS, *PLANS, *WARP_PLANS, *ROUTES, "plain", "library",
             "copy"]
    wide = "--wide" in args
    if wide:
        args.remove("--wide")
    names = args or every
    unknown = set(names) - set(every) - {"old"}
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    # base's library also runs the plan variants and the forced routes
    texts = {n: variant_source(n) for n in ("base", *names) if n in EDITS}
    if old is not None:
        texts["old"] = old.read_text()
    with ThreadPoolExecutor(max(len(texts), 1)) as ex:
        libs = dict(zip(texts, ex.map(lambda n: build(n, texts[n]), texts)))
    P, I, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).rt_rmsnorm
        fn.argtypes = kb.SIGNATURES["rmsnorm"][1] if name != "old" else \
            [P, P, P, I64, I64, F32, I, I, P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    sms = rn._sms(dev)

    def call(name, plan):
        def run(x, sc):
            out = torch.empty_like(x)
            n, d = x.shape
            stream = torch.cuda.current_stream().cuda_stream
            if name == "old":
                err = fns["old"](x.data_ptr(), sc.data_ptr(), out.data_ptr(),
                                 n, d, rn.EPS, 1, 1, stream)
            else:
                err = fns[name](x.data_ptr(), sc.data_ptr(), out.data_ptr(),
                                n, d, rn.EPS, 1, 1, rn._ROUTE_ID[plan.route],
                                plan.rows, plan.stages, plan.warps, plan.grid,
                                plan.smem, stream)
            if err:
                raise SystemExit(f"{name}: launch failed ({err}) {plan}")
            return out
        return run

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    rows = {n: {"variant": n, "ms": {}} for n in names if n != "old"}
    if old is not None:
        rows["old"] = {"variant": "old", "ms": {}}
    shapes = dict(cs.K7_SHAPES)
    if wide:
        shapes.update({f"wide_d{d}": (16_384, d)
                       for d in (512, 1024, 2048, 4096, 8192)})
    for shape, (n, d) in shapes.items():
        sets = cs.rotating_inputs(dev, g, n, d)
        sc = (torch.randn((d,), generator=g, device=dev) * 0.1) \
            .to(torch.bfloat16)
        iters = cs.cold_iters(n, d)
        plan = rn.launch_plan(n, d, 2, True, sms=sms)
        for name, row in rows.items():
            if name in EDITS or name == "old":
                fn = call(name, plan)
            elif name in PLANS:
                p = plan_variant(name, plan, n, d, sms)
                if p is None:
                    continue
                fn = call("base", p)
            elif name in WARP_PLANS:
                if plan.route == "scalar":
                    continue
                w_ = int(name[4:])
                fn = call("base", rn.Plan("warp", 1, 0, w_, -(-n // w_), 0))
            elif name in ROUTES:
                fn = call("base", rn.launch_plan(n, d, 2, True, route=name,
                                                 sms=sms))
            elif name == "copy":
                fn = (lambda x, s: x.clone())
            elif name == "plain":
                fn = rn.rmsnorm_plain
            else:
                w = 1.0 + sc
                fn = (lambda x, s, w=w, d=d:
                      F.rms_norm(x, (d,), weight=w, eps=rn.EPS))
            row["ms"][shape] = cs.time_graph_ms(lambda x: fn(x, sc), sets,
                                                iters)
            if shape == "prefill_block" and (name in EDITS or name == "old"):
                x = sets[0]
                row["max_abs_err"] = (fn(x, sc).float() - rn.rmsnorm_plain(
                    x, sc).float()).abs().max().item()
        del sets
        torch.cuda.empty_cache()
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
