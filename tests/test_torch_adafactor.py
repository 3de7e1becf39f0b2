"""The port's Adafactor (``repro_torch.optim.adafactor``) on the CPU, held
against the JAX package's ``repro.optim.adafactor``: the factored state's
shapes (a port of ``test_sharding_optim.py::
test_adafactor_factored_state_shapes``), the state tree's leaf names,
and three updates of a stacked (R, E, d, f) expert leaf, a non-factored
leaf and a leaf with weight decay, in f32 and in bf16.

Tolerances: f32 parameters and moments 1e-6 relative (+1e-7 of the leaf's
largest entry: the row and column means and the clipping RMS sum in
another order); bf16 parameters within one bf16 ulp of JAX's (the f32
update rounded once to bf16), moments as f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.split_state import leaf_paths as jleaf_paths
from repro.optim import Adafactor as JAdafactor
from repro_torch.convert import from_jax_state, to_numpy_state
from repro_torch.core.split_state import leaf_paths
from repro_torch.optim import Adafactor


def test_adafactor_factored_state_shapes():
    opt = Adafactor(min_dim_size_to_factor=4)
    params = {"w": torch.ones((8, 16)), "b": torch.ones((8,))}
    st = opt.init(params)
    assert st["f"]["w"]["v_row"].shape == (8,)
    assert st["f"]["w"]["v_col"].shape == (16,)
    assert st["f"]["b"]["v"].shape == (8,)
    assert st["count"].dtype == torch.int32
    grads = {"w": torch.ones((8, 16)), "b": torch.ones((8,))}
    new_p, st2 = opt.update(grads, st, params, lr=0.01)
    assert all(bool(torch.isfinite(x).all()) for _, x in leaf_paths(new_p))
    assert int(st2["count"]) == 1


def _tree(rng, dtype):
    """A stacked expert leaf (R, E, d, f), a stacked matrix under the
    factoring threshold on one axis, a vector and a 3-D attention leaf."""
    shapes = {"stage_0": {"b0": {"moe": {"wg": (2, 3, 40, 48)},
                                 "norm": {"scale": (40,)},
                                 "q": (40, 4, 16)}},
              "embed": (64, 40)}

    def build(node):
        return {k: build(v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32)
                for k, v in node.items()}

    p = build(shapes)
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), p)


@pytest.mark.parametrize("dtype,wd", [("float32", 0.0), ("float32", 0.1),
                                      ("bfloat16", 0.0)])
def test_three_updates_match_jax(dtype, wd):
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    jopt, topt = JAdafactor(weight_decay=wd), Adafactor(weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = from_jax_state(params, "cpu")
    tst = topt.init(tp)
    assert [(n, tuple(a.shape)) for n, a in jleaf_paths(jst)] == \
        [(n, tuple(t.shape)) for n, t in leaf_paths(tst)]
    # the (R, E, d, f) leaf keeps R and E in both factors
    assert tst["f"]["stage_0"]["b0"]["moe"]["wg"]["v_row"].shape == \
        (2, 3, 40)
    assert tst["f"]["stage_0"]["b0"]["moe"]["wg"]["v_col"].shape == \
        (2, 3, 48)
    # (4, 16): 4 is under the threshold of 32, so q is not factored
    assert set(tst["f"]["stage_0"]["b0"]["q"]) == {"v"}
    for i, lr in enumerate((1e-2, 3e-3, 1e-3)):
        grads = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(
                rng.standard_normal(a.shape).astype(np.float32) * (i + 1),
                dtype)), params)
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp,
                              jnp.float32(lr))
        topt.update(from_jax_state(grads, "cpu"), tst, tp,
                    torch.tensor(lr))
    assert int(tst["count"]) == int(jst["count"]) == 3
    got = dict(leaf_paths(to_numpy_state({"p": tp, "s": tst})))
    for name, ref in jleaf_paths({"p": jp, "s": jst}):
        g = got[name]
        r = np.asarray(ref)
        if r.dtype.kind in "iu":
            np.testing.assert_array_equal(g, r, err_msg=name)
            continue
        if str(r.dtype) == "bfloat16":
            g = torch.from_numpy(g.view(np.int16)).view(torch.bfloat16) \
                .float().numpy()
            r = r.astype(np.float32)
            # one bf16 ulp: 2^-7 of the value's binade
            ulp = 2.0 ** (np.floor(np.log2(np.abs(r) + 1e-30)) - 7)
            assert np.all(np.abs(g - r) <= ulp), name
            continue
        np.testing.assert_allclose(g, r, rtol=1e-6,
                                   atol=1e-7 * np.abs(r).max(),
                                   err_msg=name)


def test_update_clips_over_the_whole_stacked_leaf():
    """The RMS that clips the update is the whole leaf's: one layer with
    large gradients scales every layer of the stack, as in JAX."""
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((2, 40, 48)).astype(np.float32)}
    g = {"w": rng.standard_normal((2, 40, 48)).astype(np.float32)}
    g["w"][1] *= 1e3
    jopt, topt = JAdafactor(), Adafactor()
    jp, _ = jopt.update(jax.tree.map(jnp.asarray, g),
                        jopt.init(jax.tree.map(jnp.asarray, p)),
                        jax.tree.map(jnp.asarray, p), 1e-2)
    tp = from_jax_state(p, "cpu")
    topt.update(from_jax_state(g, "cpu"), topt.init(tp), tp, 1e-2)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
