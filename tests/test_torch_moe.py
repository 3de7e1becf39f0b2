"""The port's MoE layer (``repro_torch.models.moe``) on the CPU, held against
the JAX package's ``repro.models.moe`` at the reduced llama4-scout MoE
(d 64, 8 experts of 64, f32): ``capacity`` exactly; the arrival-order
positions and per-expert counts exactly, across the 2,048-assignment block
edge; ``moe_apply``'s output, aux values and gradients with drops forced
(capacity factor 0.5), with top-k 1 and 2 and a shared expert; and a row
of tied probabilities (the lower expert index wins, as ``lax.top_k``).

Tolerances: positions, counts and ``drop_fraction`` exact (integers, and a
0/1 mean taken as ``jnp.mean`` takes it); outputs 1e-5 of their largest
entry, the load-balance and z losses 1e-6 relative (f32 sums in another
order); gradients 1e-4 of each leaf's largest entry (as
``tests/test_torch_train.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import moe

ARCH = "llama4-scout-17b-a16e"
CFG = reduced(get_config(ARCH))
JCFG = jreduced(jget_config(ARCH))


def _cfgs(**moe_kw):
    return (dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe,
                                                             **moe_kw)),
            dataclasses.replace(JCFG, moe=dataclasses.replace(JCFG.moe,
                                                              **moe_kw)))


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jcfg.d_model)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("E,k,cf,tokens", [
    (8, 1, 1.25, 64), (8, 2, 0.5, 80), (16, 1, 1.5, 4096),
    (384, 8, 1.25, 4096), (16, 1, 1.5, 4), (8, 2, 1.0, 7)])
def test_capacity_matches_jax(E, k, cf, tokens):
    cfg, jcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf)
    assert moe.capacity(cfg.moe, tokens) == \
        jmoe.capacity(jcfg.moe, tokens)


@pytest.mark.parametrize("n,E", [(5000, 8), (2048, 3), (4097, 16),
                                 (300, 8)])
def test_positions_and_counts_match_jax(n, E):
    """Token-major arrival order across the 2,048-assignment block edge
    (and a partial last block padded with an id no expert has)."""
    ids = np.random.default_rng(n).integers(0, E, n).astype(np.int32)
    ref_pos, ref_counts = jmoe._positions_in_expert(jnp.asarray(ids), E)
    pos, counts = moe._positions_in_expert(torch.from_numpy(ids), E)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    # and batched over a leading group axis, as moe_apply calls it
    two = np.stack([ids, ids[::-1]])
    pos2, counts2 = moe._positions_in_expert(torch.from_numpy(two), E)
    np.testing.assert_array_equal(pos2[0].numpy(), np.asarray(ref_pos))
    r_pos, r_counts = jmoe._positions_in_expert(jnp.asarray(two[1]), E)
    np.testing.assert_array_equal(pos2[1].numpy(), np.asarray(r_pos))
    np.testing.assert_array_equal(counts2[1].numpy(), np.asarray(r_counts))


def _check_apply(cfg, jcfg, x, group_size=4096, seed=0):
    jp, tp = _params(jcfg, seed)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                              group_size=group_size)
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x), cfg,
                             group_size=group_size)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    assert set(taux) == set(jaux)
    assert float(taux["drop_fraction"]) == float(jaux["drop_fraction"])
    for key in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6, err_msg=key)
    return jaux


@pytest.mark.parametrize("top_k,shared", [(1, 1), (2, 1), (2, 0), (1, 0)])
def test_moe_apply_with_drops_matches_jax(top_k, shared):
    """Capacity factor 0.5: a share of the assignments is dropped and
    must contribute exactly nothing."""
    cfg, jcfg = _cfgs(top_k=top_k, n_shared_experts=shared,
                      capacity_factor=0.5)
    aux = _check_apply(cfg, jcfg, _x((2, 80, CFG.d_model)))
    assert float(aux["drop_fraction"]) > 0.2


def test_moe_apply_groups_match_jax():
    """Two groups of 64 tokens: each group's capacity and positions are
    its own."""
    cfg, jcfg = _cfgs(top_k=2, capacity_factor=0.5)
    _check_apply(cfg, jcfg, _x((4, 32, CFG.d_model), seed=3),
                 group_size=64)


def test_moe_apply_decode_group_matches_jax():
    """A decode step's group is its batch (one token a sequence)."""
    cfg, jcfg = _cfgs(top_k=2)
    _check_apply(cfg, jcfg, _x((3, 1, CFG.d_model), seed=4))


def test_tied_probabilities_take_the_lower_expert():
    """A zero router gives every expert the same probability: the top-k
    are experts 0..k-1, as ``lax.top_k`` picks them, and the output is
    JAX's."""
    cfg, jcfg = _cfgs(top_k=2, capacity_factor=2.0)
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    probs = torch.full((1, 5, 8), 1 / 8)
    _, topi = moe._top_k(probs, 2)
    assert topi.tolist() == [[[0, 1]] * 5]
    _, ref = jax.lax.top_k(jnp.full((5, 8), 1 / 8), 2)
    np.testing.assert_array_equal(topi[0].numpy(), np.asarray(ref))
    x = _x((1, 16, CFG.d_model), seed=5)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_and_expert_gradients_match_jax(top_k):
    """d/d(params, x) of Σ y·r + aux: the router gets its gradient through
    topw, the load-balance probabilities and the z-loss; the expert ids
    carry none."""
    cfg, jcfg = _cfgs(top_k=top_k, capacity_factor=0.5)
    jp, tp = _params(jcfg, seed=2)
    x = _x((2, 40, CFG.d_model), seed=6)
    r = _x((2, 40, CFG.d_model), seed=7)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(y * r) + aux["load_balance_loss"] \
            + aux["router_z_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    names = ["router", "wd", "wg", "wu"]
    live = {n: tp[n].clone().requires_grad_() for n in names}
    shared = {k: v.clone().requires_grad_() for k, v in tp["shared"].items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply({**live, "shared": shared}, tx, cfg)
    loss = (y * torch.from_numpy(r)).sum() + aux["load_balance_loss"] \
        + aux["router_z_loss"]
    loss.backward()
    pairs = [(n, live[n].grad, jg[n]) for n in names] + \
        [(f"shared/{k}", shared[k].grad, jg["shared"][k]) for k in shared] \
        + [("x", tx.grad, jgx)]
    for name, got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
