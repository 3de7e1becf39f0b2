"""K7's launch plan and its PyTorch twin on the CPU (the CUDA kernel itself
runs only on the card: ``test_torch_cuda_kernels.py``, ``chip_smoke.py``).

``ops.launch_plan`` decides how ``csrc/rmsnorm.cu`` is launched (route,
rows a stage, stages, warps, grid, shared memory); ``ops.walk`` lists the
rows each CTA and warp of a plan computes, as the kernel walks them; and
``ops.rmsnorm_twin`` computes those rows in the kernel's summation order.
Here: every row is covered exactly once (ragged last stages too), stages
are whole 16-byte units and fit in shared memory, the routes are chosen as
``ops`` documents them for the serving and training path's shapes, and the
twin agrees with ``rmsnorm_plain`` and with the JAX package's Pallas kernel
in interpret mode, on inputs made with numpy from a seed."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_fused as jrms
from repro_torch.kernels.rmsnorm import ops as rn

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}      # test_kernels.py:66
# (rows, D) of gemma3-1b's norms: serving prefill (8 × 2048 tokens; block,
# q and k norms), the training step (4 × 1024), decode (8 sequences)
PREFILL = [(16_384, 1152), (65_536, 256), (16_384, 256)]
TRAIN = [(4096, 1152), (16_384, 256), (4096, 256)]
DECODE = [(8, 1152), (32, 256), (8, 256)]
PATH = PREFILL + TRAIN + DECODE
# ragged last stages, chameleon-34b's width, and the small sweeps
EDGES = [(16_384 + 3, 1152), (1000, 1152), (777, 256), (300, 8192),
         (100_000, 8192), (257, 1152), (16, 64), (37, 96), (15, 128)]


def _covered(plan, n_rows):
    hits = np.zeros(n_rows, np.int64)
    for _, _, r0, cnt in rn.walk(plan, n_rows):
        assert cnt >= 1
        hits[r0:r0 + cnt] += 1
    return hits


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("route", [None, *rn.ROUTES])
@pytest.mark.parametrize("n_rows,d", PATH + EDGES + [(50, 37), (5, 8195)])
def test_plan_covers_every_row_once(n_rows, d, route, itemsize):
    if route not in (None, "scalar") and (d * itemsize) % 16:
        with pytest.raises(ValueError):
            rn.launch_plan(n_rows, d, itemsize, True, route=route)
        return
    plan = rn.launch_plan(n_rows, d, itemsize, True, route=route)
    assert (_covered(plan, n_rows) == 1).all()
    assert plan.grid >= 1 and 1 <= plan.warps <= rn.MAX_WARPS


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n_rows,d", PREFILL + TRAIN + EDGES[:5])
def test_stream_stages_are_whole_16_byte_units_and_fit(n_rows, d, itemsize):
    plan = rn.launch_plan(n_rows, d, itemsize, True, route="stream")
    stage = plan.rows * d * itemsize
    assert stage % 16 == 0 and stage < 1 << 20     # bulk copy, tx count
    assert plan.rows % plan.warps == 0             # whole rows a warp
    assert 2 <= plan.stages <= rn.STAGES
    assert plan.smem == rn.stream_smem(d, itemsize, plan.rows, plan.stages)
    assert plan.smem <= rn.SMEM_LIMIT              # 227 KB
    n_blocks = -(-n_rows // plan.rows)
    assert plan.grid <= n_blocks                   # no CTA without work
    # the last stage is ragged where rows do not divide N
    last = n_rows - (n_blocks - 1) * plan.rows
    assert 1 <= last <= plan.rows and (last * d * itemsize) % 16 == 0


# the stage of the q/k norms is 32 rows of 512 B; forced at the block
# norm's D 1,152, 8 rows of 2,304 B; at 4,096 rows of 512 B it shrinks to
# 8 rows so that the blocks still cover the SMs twice
STAGE_ROWS = {(65_536, 256): 32, (16_384, 256): 32, (16_384, 1152): 8,
              (4096, 1152): 8, (4096, 256): 8, (4097, 256): 8}


@pytest.mark.parametrize("n_rows,d", sorted(STAGE_ROWS))
def test_stream_stages_cover_the_sms(n_rows, d):
    plan = rn.launch_plan(n_rows, d, 2, True, route="stream")
    assert plan.rows == STAGE_ROWS[(n_rows, d)]
    assert plan.grid >= rn.SMS
    assert -(-n_rows // plan.rows) >= 2 * rn.SMS


@pytest.mark.parametrize("n_rows,d", [(65_536, 256), (16_384, 256),
                                      (4097, 256)])
def test_many_short_rows_stream(n_rows, d):
    plan = rn.launch_plan(n_rows, d, 2, True)
    assert plan.route == "stream" and plan.rows == STAGE_ROWS[(n_rows, d)]


@pytest.mark.parametrize("n_rows,d", [(16_384, 1152), (4096, 1152),
                                      (16_384, 8192), (300, 8192)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rows_of_2_kb_and_more_take_the_warp_route(n_rows, d, itemsize):
    # training's 4,096-row block norms too: a CTA a row, every SM busy
    plan = rn.launch_plan(n_rows, d, itemsize, True)
    assert plan == rn.Plan("warp", 1, 0, 1, n_rows, 0)


@pytest.mark.parametrize("n_rows,d", DECODE)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_rows_take_the_warp_route(n_rows, d, itemsize):
    plan = rn.launch_plan(n_rows, d, itemsize, True)
    assert plan == rn.Plan("warp", 1, 0, 1, n_rows, 0)


@pytest.mark.parametrize("n_rows,d", [(4096, 256), (1000, 256),
                                      (4096, 128)])
def test_up_to_4096_short_rows_take_the_warp_route(n_rows, d):
    # the training step's k norm: a CTA a row beat the stream's ring there
    plan = rn.launch_plan(n_rows, d, 2, True)
    assert plan == rn.Plan("warp", 1, 0, 1, n_rows, 0)


@pytest.mark.parametrize("n_rows,d,itemsize,aligned", [
    (16, 37, 2, True), (16_384, 37, 4, True), (16_384, 1152, 2, False),
    (8, 256, 4, False), (5, 8195, 2, True)])
def test_unaligned_rows_take_the_scalar_route(n_rows, d, itemsize, aligned):
    assert rn.launch_plan(n_rows, d, itemsize, aligned).route == "scalar"
    for route in ("stream", "warp"):
        with pytest.raises(ValueError):
            rn.launch_plan(n_rows, d, itemsize, aligned, route=route)


@pytest.mark.parametrize("route", [None, "stream", "warp"])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_width_8192_is_planned(itemsize, route):
    plan = rn.launch_plan(16_384, 8192, itemsize, True, route=route)
    assert plan.smem <= rn.SMEM_LIMIT
    assert (_covered(plan, 16_384) == 1).all()


def test_unknown_route_raises():
    with pytest.raises(ValueError):
        rn.launch_plan(8, 256, 2, True, route="tma")


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).astype(DTYPES[dtype])
    s = (rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32) \
        .astype(DTYPES[dtype])
    return x, s


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", [None, *rn.ROUTES])
@pytest.mark.parametrize("shape", [(16, 64), (37, 96), (3, 5, 128),
                                   (300, 256), (260, 1152), (3, 8192)])
def test_twin_matches_plain(shape, route, dtype):
    x, s = _inputs(shape, dtype, 1000 + sum(shape))
    xt, st = _torch(x, dtype), _torch(s, dtype)
    n_rows = int(np.prod(shape[:-1]))
    plan = rn.launch_plan(n_rows, shape[-1], xt.element_size(), True,
                          route=route)
    got = rn.rmsnorm_twin(xt, st, plan)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(xt, st).float(),
                               atol=RMS_TOL[dtype], rtol=0)


@pytest.mark.parametrize("d", [37, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_twin_of_a_misaligned_view_matches_plain(dtype, d):
    x, s = _inputs((41 * d + 1,), dtype, 5)
    flat, st = _torch(x, dtype), _torch(s[:d], dtype)
    xt = flat[1:].view(41, d)           # storage offset of one element
    assert xt.is_contiguous() and xt.data_ptr() % 16
    plan = rn.launch_plan(41, d, xt.element_size(),
                          xt.data_ptr() % 16 == 0)
    assert plan.route == "scalar"
    torch.testing.assert_close(rn.rmsnorm_twin(xt, st, plan).float(),
                               rn.rmsnorm_plain(xt, st).float(),
                               atol=RMS_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vector_routes_sum_in_one_order(dtype):
    """stream and warp share the per-lane order: their twins give the
    same bits (what the card tests ask of the kernels)."""
    x, s = _inputs((260, 1152), dtype, 77)
    xt, st = _torch(x, dtype), _torch(s, dtype)
    outs = [rn.rmsnorm_twin(xt, st, rn.launch_plan(
        260, 1152, xt.element_size(), True, route=r))
        for r in ("stream", "warp")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("route", [None, *rn.ROUTES])
@pytest.mark.parametrize("shape", [(16, 64), (37, 96), (3, 5, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_twin_matches_pallas(shape, dtype, route):
    """The sweep of ``test_torch_model_kernels.py``'s K7 test (the shapes
    of ``tests/test_kernels.py``), through each route's twin."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32).astype(DTYPES[dtype])
    s = (rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32) \
        .astype(DTYPES[dtype])
    ref = jrms(jnp.asarray(x), jnp.asarray(s), block_rows=8, interpret=True)
    xt, st = _torch(x, dtype), _torch(s, dtype)
    plan = rn.launch_plan(int(np.prod(shape[:-1])), shape[-1],
                          xt.element_size(), True, route=route)
    got = rn.rmsnorm_twin(xt, st, plan)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=RMS_TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    x, s = _inputs((8, 1152), "bfloat16", 3)
    xt, st = _torch(x, "bfloat16"), _torch(s, "bfloat16")
    before = rn.launches
    got = rn.rmsnorm_fused(xt, st, route="stream")
    assert rn.launches == before
    assert torch.equal(got, rn.rmsnorm_plain(xt, st))
