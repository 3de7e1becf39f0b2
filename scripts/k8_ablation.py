#!/usr/bin/env python3
"""Where K8's time goes: build variants of the bf16 flash-attention kernel
(``src/repro_torch/csrc/flash_attention.cu``) with one part taken out, and
time each at the serving prefill's shapes on one GPU.

    python3 scripts/k8_ablation.py            # every variant
    python3 scripts/k8_ablation.py base nos   # some of them

Variants (each edits a copy of the source; the edit must find its anchor):
  base       the kernel as it is
  noload     the producer signals the K/V tiles without loading them
  nosoftmax  the softmax of a tile returns at once (p = raw scores)
  nos        S = Q.K^T is not issued after a warpgroup's first tile
  nopv       P.V is not issued after a warpgroup's first tile
  exp2f      2^x through libm's exp2f instead of ex2.approx
The variants other than base compute wrong results on purpose: only their
times mean something. Each prints one JSON line: CUDA-event ms at B 8,
S 2048, H 4, K 1, D 256, causal and with the 512 window (block_q 128), and
base's max abs error against ``flash_attention_plain``. Builds go to
``build/k8_ablation/``. Needs nvcc and a card (sm_90a).
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

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "k8_ablation"


def _producer_without_loads(s: str) -> str:
    for kind in ("k", "v"):
        head = f"        mbar_expect_tx(b{kind}, G::TILE);\n#pragma unroll\n"
        i = s.index(head)
        j = s.index(";\n", s.index("tma_load(", i)) + 2
        s = s[:i] + f"        mbar_arrive(b{kind});\n" + s[j:]
    return s


EDITS = {
    "base": [],
    "noload": [_producer_without_loads],
    "nosoftmax": [("  float mx[2] = {NEG_INF, NEG_INF};\n",
                   "  corr[0] = corr[1] = 1.f;\n  if (mul > -1.f) return;\n"
                   "  float mx[2] = {NEG_INF, NEG_INF};\n")],
    "nos": [("      issue_s(sc, i);\n", "      wg_commit();\n")],
    "nopv": [("      issue_pv(o, p, i - 1);\n", "      wg_commit();\n")],
    "exp2f": [("    corr[i] = fast_exp2(m[i] - m_new);",
               "    corr[i] = exp2f(m[i] - m_new);"),
              ("      const float pv = fast_exp2(sc[4 * j + e] - m[e >> 1]);",
               "      const float pv = exp2f(sc[4 * j + e] - m[e >> 1]);")],
}


def variant_source(name: str) -> str:
    s = SOURCE.read_text()
    for edit in EDITS[name]:
        if callable(edit):
            s = edit(s)
        else:
            old, new = edit
            if old not in s:
                raise SystemExit(f"{name}: anchor not found: {old!r}")
            s = s.replace(old, new)
    return s


def build(name: str) -> Path:
    from repro_torch.kernels import build as kb
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(variant_source(name))
    r = subprocess.run([kb.nvcc(), *kb.NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    return so


def main() -> int:
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    names = sys.argv[1:] or list(EDITS)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, S, H, K, D = 8, 2048, 4, 1, 256
    q, k, v = (torch.randn((B, S, n, D), generator=g, device=dev)
               .to(torch.bfloat16) for n in (H, K, K))
    out = torch.empty_like(q)
    ref = {w: fa.flash_attention_plain(q, k, v, causal=True, window=w)
           .float() for w in (0, 512)}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).rt_flash_attention_bq
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, F, F, I, I, I, I, P]
        row = {"variant": name}
        for w in (0, 512):
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, S, S, H, K, D, D ** -0.5, 0.0,
                         1, w, 1, 128,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: launch failed ({err})")
            for _ in range(3):
                call()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(30):
                call()
            e1.record()
            e1.synchronize()
            row[f"ms_window{w}"] = e0.elapsed_time(e1) / 30
            if name == "base":
                call()
                row[f"max_abs_err_window{w}"] = \
                    (out.float() - ref[w]).abs().max().item()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
