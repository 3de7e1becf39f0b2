"""The compute layout's specs and K8's query offset, no processes.

``act_constrainer``: for the ten full configs on the five meshes of
``test_torch_partition.py``, each with no flag, ``dp_over_model``,
``seq_shard_resid`` and ``seq_shard_attn``, the port's spec of every
activation name equals the JAX package's (its ``with_sharding_constraint``
captured on a mesh that is only a shape, ``NamedSharding`` a record of
(mesh, spec)).

``q_offset``: the plain K8 on the query rows ``[off, off + n)`` of a
sequence against all its keys equals the JAX ``attention_reference`` on
the whole sequence, sliced to those rows — causal and windowed, f32 and
bf16, within ``ATTN_TOL`` — and the tile plan at an offset visits exactly
the key tiles the offset mask keeps."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import repro.sharding.partition as jpart
from repro.configs import CONFIGS as JCONFIGS
from repro.kernels.flash_attention import attention_reference as jref
from repro_torch.configs import ARCH_IDS, CONFIGS
from repro_torch.convert import from_jax_state
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.sharding.partition import act_constrainer

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((8, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
FLAGS = {"none": {}, "dp_over_model": {"dp_over_model": True},
         "seq_shard_resid": {"seq_shard_resid": True},
         "seq_shard_attn": {"seq_shard_attn": True}}
NAMES = {"resid": 3, "moe_in": 3, "attn_q": 4, "attn_kv": 4,
         "attn_q_local": 4, "attn_kv_local": 4}
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}     # test_kernels.py:34


class _ShapeMesh:
    """A JAX mesh that is only its axis names and device-array shape."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


class _NS:
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _jax_specs(cfg, shape, names, monkeypatch):
    monkeypatch.setattr(jpart, "NamedSharding", _NS)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    constrain = jpart.act_constrainer(cfg, _ShapeMesh(shape, names))
    return {n: tuple(constrain(np.zeros((1,) * nd), n).spec)
            for n, nd in NAMES.items()}


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_act_constrainer_specs_match_jax(arch, flag, monkeypatch):
    for shape, names in MESHES:
        jcfg = dataclasses.replace(JCONFIGS[arch], **FLAGS[flag])
        tcfg = dataclasses.replace(CONFIGS[arch], **FLAGS[flag])
        want = _jax_specs(jcfg, shape, names, monkeypatch)
        lay = act_constrainer(tcfg, AbstractMesh(shape, names))
        assert lay.specs == want, (shape, flag)
        # what the forward reads follows the specs
        assert lay.seq_resid == (lay.tp_axis is not None
                                 and want["resid"][1] is not None)
        assert lay.seq_attn == (lay.tp_axis is not None
                                and want["attn_q"][1] is not None)


def _normal(rng, shape, dtype):
    return rng.standard_normal(shape).astype(np.float32).astype(DTYPES[dtype])


def _port(a):
    return from_jax_state({"a": a}, device="cpu")["a"]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 24), (False, 0)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_q_offset_matches_reference_sliced(causal, window, dtype):
    """Four ranks' query rows of a 128-token sequence (GQA 4:2)."""
    B, S, H, K, D, tp = 2, 128, 4, 2, 32, 4
    rng = np.random.default_rng(S + window + causal)
    q = _normal(rng, (B, S, H, D), dtype)
    k = _normal(rng, (B, S, K, D), dtype)
    v = _normal(rng, (B, S, K, D), dtype)
    ref = np.asarray(jref(*(jnp.asarray(t).transpose(0, 2, 1, 3)
                            for t in (q, k, v)),
                          causal=causal, window=window), np.float32)
    ref = ref.transpose(0, 2, 1, 3)
    n = S // tp
    for r in range(tp):
        got = fa.flash_attention_plain(_port(q[:, r * n:(r + 1) * n]),
                                       _port(k), _port(v), causal=causal,
                                       window=window, q_offset=r * n)
        np.testing.assert_allclose(got.float().numpy(),
                                   ref[:, r * n:(r + 1) * n],
                                   atol=ATTN_TOL[dtype], err_msg=str(r))


@pytest.mark.parametrize("sq,sk,causal,window,off", [
    (1024, 4096, True, 0, 3072), (512, 2048, True, 0, 512),
    (100, 300, True, 50, 130), (192, 1024, False, 96, 448),
    (128, 512, True, 64, 63), (128, 512, True, 64, 65)])
def test_tile_plan_at_an_offset_visits_the_masked_tiles(sq, sk, causal,
                                                        window, off):
    import torch
    mask = fa._mask(sq, sk, causal, window, torch.device("cpu"), off)
    for bq in (64, 128):
        tiles, order = fa.tile_plan(sq, sk, causal, window, bq, q_offset=off)
        assert sorted(order) == list(range(len(tiles)))
        for qt, visits in enumerate(tiles):
            rows = mask[qt * bq:(qt + 1) * bq]
            keep = rows.any(0)
            want = sorted({int(j) // fa.BLOCK_K
                           for j in keep.nonzero().flatten()})
            assert [t for t, _ in visits] == want, (qt, bq)
            for t, masked in visits:
                blk = rows[:, t * fa.BLOCK_K:(t + 1) * fa.BLOCK_K]
                full = blk.shape[1] == fa.BLOCK_K and bool(blk.all())
                assert masked or full, (qt, t)
