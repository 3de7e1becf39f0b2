"""The yardstick's counts against counts made by hand: the operations of
a training step of both configurations, and the launches and bytes of
K1–K4, K7 and K8."""
import json

import pytest

from crbench import yardstick as Y
from crbench.tests.conftest import REPO

MIB = 1 << 20


def config(name):
    return json.loads((REPO / "crbench" / "configs" / f"{name}.json")
                      .read_text())


def test_mamba2_step_flops_by_hand():
    c = config("mamba2-780m.l4")
    # per layer: in_proj 1536 x (2·3072 + 2·128 + 48), out_proj 3072 x 1536;
    # the tied head 50,280 x 1536
    weights = 4 * (1536 * 6448 + 3072 * 1536) + 50280 * 1536
    assert Y.matmul_params(c) == weights == 135_720_960
    # SSD a token, a layer, forward, each 256-row chunk block over its
    # causal half, 256·257/2 pairs, so 257/2 pairs a token at 2 operations
    # a multiply-add: C·Bᵀ once for the one group of B and C (128
    # multiply-adds a pair), its product with x in each of 48 heads (64),
    # and each head's chunk state and read-out (2·128·64 each)
    ssd = 128 * 257 + 48 * (64 * 257 + 2 * 2 * 128 * 64)
    assert ssd == 2_395_264
    tokens = 8 * 2048
    want = 6 * weights * tokens + 3 * 4 * ssd * tokens
    assert Y.step_flops(c, 8, 2048) == want == 13_812_841_316_352
    # two groups of B and C take C·Bᵀ twice
    two = dict(c, ssm=dict(c["ssm"], n_groups=2))
    assert Y.mixer_flops_per_token(two, 2048) - \
        Y.mixer_flops_per_token(c, 2048) == 128 * 257


def test_hubert_step_flops_by_hand():
    c = config("hubert-xlarge.l6")
    # per layer q, k, v, o (1280 x 16·80 each) and the FFN (1280 x 5120
    # twice); the head 1280 x 504
    weights = 6 * (4 * 1280 * 1280 + 2 * 1280 * 5120) + 1280 * 504
    assert Y.matmul_params(c) == weights == 118_609_920
    # attention a token, a layer, forward: QKᵀ and PV over 768 keys
    attn = 2 * 2 * 768 * 16 * 80
    tokens = 11 * 768
    assert Y.step_flops(c, 11, 768) == 6 * weights * tokens + \
        3 * 6 * attn * tokens


def test_k7_launches_and_bytes():
    c = config("mamba2-780m.l4")
    per = Y.k7_step(c, 8, 2048)
    # 4 layers x (input norm, gated norm) forward and in the recompute,
    # and the final norm
    assert len(per) == 4 * 2 * 2 + 1
    rows = 8 * 2048
    d1536 = (2 * rows * 1536 + 1536) * 2 / 3.35e12
    d3072 = (2 * rows * 3072 + 3072) * 2 / 3.35e12
    assert sum(per) == pytest.approx(9 * d1536 + 8 * d3072, rel=1e-12)
    # the kernel table's bounds at these rows: 0.0300 and 0.0601 ms
    assert d1536 * 1e3 == pytest.approx(0.0300, abs=5e-5)
    assert d3072 * 1e3 == pytest.approx(0.0601, abs=5e-5)
    assert Y.k7_step(config("hubert-xlarge.l6"), 11, 768) == []


def test_k8_launches_and_bound():
    c = config("hubert-xlarge.l6")
    per = Y.k8_step(c, 11, 768)
    assert len(per) == 12                   # 6 layers, forward + recompute
    flops = 4 * 11 * 16 * 768 * 768 * 80
    nbytes = 4 * 11 * 768 * 16 * 80 * 2
    assert flops / 989.4e12 > nbytes / 3.35e12      # bound by operations
    assert per[0] == pytest.approx(flops / 989.4e12, rel=1e-12)
    assert Y.k8_step(config("mamba2-780m.l4"), 8, 2048) == []


def test_encode_and_decode_counts():
    leaves = [("params/a", 3 * MIB), ("params/small", MIB),
              ("opt/m/a", 10 * MIB), ("opt/v/small", MIB)]
    enc = Y.encode_save(leaves)
    bw = 3.35e12
    assert enc["K1"] == (1 + 3, pytest.approx((2 * 3 + 2 * 10) * MIB / bw))
    assert enc["K2"] == (1, pytest.approx(2 * 3 * MIB / bw))
    assert enc["K3"] == (1, pytest.approx(3 * 3 * MIB / bw))
    assert Y.decode_restore(leaves) == (2, pytest.approx(2 * 4 * MIB / bw))


def test_trace_arithmetic():
    iv = [[0, 2], [1, 3], [5, 6], [9, 12]]
    assert Y.union(iv) == [[0, 3], [5, 6], [9, 12]]
    assert Y.busy(iv, 1, 10) == 2 + 1 + 1
    assert Y.gaps(iv, -1, 13) == [(-1, 0), (3, 5), (6, 9), (12, 13)]
    assert Y.kernel_of("void rms_warp_kernel<__nv_bfloat16>(...)") == "K7"
    assert Y.kernel_of("inverse_tiles(unsigned char const*)") == "K4"
    assert Y.kernel_of("ampere_bf16_s16816gemm") is None
