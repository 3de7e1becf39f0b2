"""The benchmark's own yardstick: the H100's published peaks, the
operations a training step needs, the bytes each hand-written kernel must
move, and the arithmetic that turns a device trace into busy time and idle
gaps. The program's own counters and formulas are not read here, so that
a change to the program cannot move the yardstick.

Byte counts follow one convention: each input byte read once and each
output byte written once, whatever a kernel reads again."""
from __future__ import annotations

import math

# one H100 SXM (NVIDIA's data sheet; dense bf16 tensor-core rate, HBM3)
PEAK_FLOPS = 989.4e12
PEAK_BYTES_S = 3.35e12

MIB = 1 << 20
ACCEL_MIN_BYTES = 2 * MIB   # the save path scans smaller leaves on the host
SCAN_SEGMENT = 4 * MIB      # a raw leaf is scanned in segments of this size
ENCODE_BATCH = 64 * MIB     # K3 runs over a params leaf this much at a time

# kernels by the names their CUDA functions carry in a device trace
KERNELS = {
    "K1": ("gear_scan_kernel",),
    "K2": ("byteplane_fwd_kernel",),
    "K3": ("rle_emit_kernel",),
    "K4": ("inverse_tiles",),
    "K7": ("rms_stream_kernel", "rms_warp_kernel", "rms_scalar_kernel"),
    "K8": ("flash_kernel", "flash_wgmma_kernel"),
}


def kernel_of(name: str):
    """The K number of a traced kernel name, or None."""
    for k, names in KERNELS.items():
        if any(n in name for n in names):
            return k
    return None


# ---------------------------------------------------------------------------
# a training step's operations (model FLOPs: no recompute)
# ---------------------------------------------------------------------------

def matmul_params(c: dict) -> int:
    """Weights that take part in a matrix product for every token, the
    output head included (tied or not)."""
    d, L, V = c["d_model"], c["n_layers"], c["vocab_size"]
    if c["family"] == "ssm":
        s = c["ssm"]
        di = s["expand"] * d
        nh = di // s["head_dim"]
        proj = 2 * di + 2 * s["n_groups"] * s["d_state"] + nh
        return L * (d * proj + di * d) + V * d
    H, hd, ff = c["n_heads"], c["head_dim"], c["d_ff"]
    return L * (4 * d * H * hd + 2 * d * ff) + d * V


def mixer_flops_per_token(c: dict, seq: int) -> float:
    """Forward operations a token takes in one layer's sequence mixer
    beyond its weight products. The chunked SSD's four products, each
    chunk block over its causal half (l·(l+1)/2 of its l² pairs): C·Bᵀ
    once a group of heads that share B and C, its product with each
    head's x, each head's chunk state and its read-out. Attention's two
    (QKᵀ and PV over the whole sequence, non-causal)."""
    if c["family"] == "ssm":
        s = c["ssm"]
        nh = s["expand"] * c["d_model"] // s["head_dim"]
        l, n, p = min(s["chunk_size"], seq), s["d_state"], s["head_dim"]
        g = s["n_groups"]
        return g * n * (l + 1) + nh * (p * (l + 1) + 4 * n * p)
    return 4 * seq * c["n_heads"] * c["head_dim"]


def step_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per weight and token, plus three
    times the mixers' forward products (forward and backward)."""
    tokens = batch * seq
    return 6.0 * matmul_params(c) * tokens + \
        3.0 * c["n_layers"] * mixer_flops_per_token(c, seq) * tokens


# ---------------------------------------------------------------------------
# kernels: launches a step or a checkpoint makes, and their bounds
# ---------------------------------------------------------------------------

def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the bf16 peak."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS)


def k7_step(c: dict, batch: int, seq: int) -> list:
    """Bound seconds of each K7 launch of one training step (an SSM
    config's norms: each layer's input norm at d and gated norm at
    d_inner, run again in the backward's recompute of the layer, and the
    final norm once); bf16 rows and scale: (2·rows·D + D)·2 bytes."""
    if c["family"] != "ssm":
        return []
    rows, L = batch * seq, c["n_layers"]
    di = c["ssm"]["expand"] * c["d_model"]

    def b(D):
        return bound_s((2 * rows * D + D) * 2)

    return [b(c["d_model"]), b(di)] * (2 * L) + [b(c["d_model"])]


def k8_step(c: dict, batch: int, seq: int) -> list:
    """Bound seconds of each K8 launch of one training step (an encoder's
    attention, non-causal: each layer forward and again in the recompute);
    bytes of q, k, v and out in bf16, operations 4·B·H·S²·D."""
    if c["family"] != "encoder":
        return []
    H, hd = c["n_heads"], c["head_dim"]
    nbytes = 4 * batch * seq * H * hd * 2
    flops = 4.0 * batch * H * seq * seq * hd
    return [bound_s(nbytes, flops)] * (2 * c["n_layers"])


def encode_save(leaves: list) -> dict:
    """Per kernel, (launches, bound seconds) of one save of `leaves`
    ([(name, nbytes)]): a leaf of at least ``ACCEL_MIN_BYTES`` is scanned
    on the card (K1 over ``SCAN_SEGMENT`` segments, 2 bytes a byte); a
    params leaf (byteplane-rle) goes through K2 (2 a byte), K1 over its
    planes (2) and K3 (3, a launch each ``ENCODE_BATCH``) in one
    dispatch."""
    out = {k: [0, 0.0] for k in ("K1", "K2", "K3")}
    for name, n in leaves:
        if n < ACCEL_MIN_BYTES:
            continue
        if name.startswith("params/"):
            for k, per in (("K1", 2), ("K2", 2), ("K3", 3)):
                out[k][0] += math.ceil(n / ENCODE_BATCH) if k == "K3" else 1
                out[k][1] += bound_s(per * n)
        else:
            out["K1"][0] += math.ceil(n / SCAN_SEGMENT)
            out["K1"][1] += bound_s(2 * n)
    return {k: tuple(v) for k, v in out.items()}


def decode_restore(leaves: list) -> tuple:
    """(launches, bound seconds) of K4 in one restore: one launch a params
    leaf, 2 bytes a byte."""
    p = [n for name, n in leaves if name.startswith("params/")]
    return len(p), sum(bound_s(2 * n) for n in p)


# ---------------------------------------------------------------------------
# trace arithmetic
# ---------------------------------------------------------------------------

def union(intervals: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clip(intervals: list, lo: float, hi: float) -> list:
    return [[max(a, lo), min(b, hi)] for a, b in intervals
            if b > lo and a < hi]


def busy(intervals: list, lo: float, hi: float) -> float:
    return sum(b - a for a, b in clip(union(intervals), lo, hi))


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The idle [start, end) spans of [lo, hi) between the intervals."""
    out, t = [], lo
    for a, b in clip(union(intervals), lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def roofline_share(rec, kernels, expected_launches: int, bound: float,
                   what: str):
    """Σ bound time over Σ traced time of `kernels`, in %, where the trace
    of `rec` holds as many launches as the benchmark's model of the work
    says (else None, and a note on standard error)."""
    import sys
    if rec.trace is None or not expected_launches:
        return None
    times = rec.trace.kernel_times()
    got = [t for k in kernels for t in times.get(k, [])]
    if len(got) != expected_launches:
        print(f"crbench: {what}: {len(got)} launches traced, "
              f"{expected_launches} expected; not reported", file=sys.stderr)
        return None
    return 100.0 * bound / sum(got)
