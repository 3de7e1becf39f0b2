"""The rest of the attention zoo in the port, on the CPU, held against the
JAX package at ``reduced(cfg)`` for the six configs beside gemma3-1b:
gemma2-9b (post norms, attention softcap 50, final softcap 30,
``attn_scale``, local/global alternation), stablelm-1.6b (LayerNorm, 25%
rotary, MHA), starcoder2-3b (biases, non-gated gelu, GQA), chameleon-34b
(qk-norm, Adafactor) and the MoE configs llama4-scout-17b-a16e and
kimi-k2-1t-a32b (capacity dispatch, a shared expert, kimi's dense first
layer; Adafactor). Weights come from the JAX ``Model.init`` through
``convert.params_from_jax``, tokens from a numpy seed; the kernel wrappers
take their plain versions (the tensors lie on the CPU).

Per config: the full-size training state's leaf names, shapes and dtypes
(``abstract_train_state`` with the config's own optimizer, meta tensors;
a MoE router stays f32 in a bf16 model) and the reduced ``param_specs``
against JAX's; the loss and every metric (the MoE aux values among them),
the prefill's last logits and three decode steps; one train step with
the config's optimizer.

Tolerances (``tests/test_torch_train.py``'s): f32 loss and metrics 1e-5
relative, logits 1e-5 of their largest entry; the train step's metrics
2e-5 relative, parameters a tenth of the step's learning rate, optimizer
moments 1e-4 of each leaf's largest entry. ``drop_fraction`` also within
2^-23 absolute: JAX's jitted layer scan fuses its ``1 - mean`` into one
rounding (−5.96e-8 where nothing drops), where eager ``moe_apply`` rounds
twice and the port equals it bit for bit (``tests/test_torch_moe.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.split_state import abstract_train_state as jabstract
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.models import Model as JModel
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.steps import make_train_step as jmake_step
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import from_jax_state, params_from_jax
from repro_torch.core.split_state import abstract_train_state, leaf_paths
from repro_torch.models import Model
from repro_torch.optim import Adafactor, make_optimizer
from repro_torch.state import param_specs
from repro_torch.train.steps import make_train_step

ZOO = ["gemma2-9b", "stablelm-1.6b", "starcoder2-3b", "chameleon-34b",
       "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """The JAX ``Model.init`` of the reduced config from ``PRNGKey(1)``,
    once per config for both tests that use it."""
    jm = JModel(jreduced(jget_config(arch)))
    return jm, jm.init(jax.random.PRNGKey(1))


def _atol(metric):
    return 2.0 ** -23 if metric == "drop_fraction" else 0.0


def _tokens(seed, cfg, B=2, S=40):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _spec_leaves(node, prefix=""):
    """(name, shape, dtype) of each ``param_specs`` leaf, in sorted-key
    order (the specs' leaves are tuples)."""
    for k in sorted(node):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(node[k], dict):
            yield from _spec_leaves(node[k], name)
        else:
            yield (name, tuple(node[k][0]), node[k][2])


def _specs(pairs):
    return [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for n, x in pairs]


def test_arch_ids_are_the_attention_families():
    """The attention families and, since the SSM, RG-LRU and encoder
    slice, the three others (``tests/test_torch_families.py``)."""
    assert ARCH_IDS == tuple(sorted(ZOO + ["gemma3-1b", "mamba2-780m",
                                           "recurrentgemma-9b",
                                           "hubert-xlarge"]))
    for arch in ARCH_IDS:
        Model(get_config(arch))


@pytest.mark.parametrize("arch", ZOO)
def test_full_size_state_tree_matches_jax(arch):
    """Leaf names, shapes and dtypes of the full-width training state with
    the config's own optimizer, without allocating."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    ref = _specs(jleaf_paths(jabstract(JModel(jcfg),
                                       jmake_optimizer(jcfg))))
    opt = make_optimizer(cfg)
    assert isinstance(opt, Adafactor) == (cfg.optimizer == "adafactor")
    got = _specs(leaf_paths(abstract_train_state(Model(cfg), opt)))
    assert got == ref
    if cfg.moe is not None:
        routers = [d for n, _, d in got if n.endswith("moe/router")]
        assert routers and set(routers) == {"float32"}


@pytest.mark.parametrize("arch", ZOO)
def test_forward_prefill_and_decode_match_jax(arch):
    cfg = reduced(get_config(arch))
    jm, jp = _jax_init(arch)
    tm = Model(cfg)
    ref = _specs(jleaf_paths(jp))
    assert list(_spec_leaves(param_specs(cfg))) == ref
    assert _specs(leaf_paths(tm.abstract_params())) == ref
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(0, cfg)
    jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    assert set(tmet) == set(jmet)
    if cfg.moe is not None:
        assert {"load_balance_loss", "router_z_loss",
                "drop_fraction"} <= set(tmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=_atol(k), err_msg=k)

    def close(got, ref, what):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=what)

    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :24]), cache_len=32)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :24]), cache_len=32)
    close(tlog, jlog, "prefill")
    jdecode = jax.jit(jm.decode_step)          # one compile, three steps
    for i in range(3):
        nt = toks[:, 24 + i]
        jlog, jc = jdecode(jp, jc, jnp.asarray(nt))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nt))
        close(tlog, jlog, f"decode {i}")
    assert int(tc["pos"]) == int(jc["pos"]) == 27


@pytest.mark.parametrize("arch", ZOO)
def test_train_step_with_own_optimizer_matches_jax(arch):
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    (jm, jp), tm = _jax_init(arch), Model(cfg)
    jopt, topt = jmake_optimizer(jcfg), make_optimizer(cfg)
    # the JAX init_train_state of these params
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.key_data(jax.random.PRNGKey(0))}
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate), "cpu")
    toks = _tokens(5, cfg, B=4, S=24)
    jnew, jmet = jmake_step(jm, jopt)(jstate, {"tokens": jnp.asarray(toks)})
    tnew, tmet = make_train_step(tm, topt)(
        tstate, {"tokens": torch.from_numpy(toks)})
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-5, atol=_atol(k), err_msg=k)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    lr = float(jmet["lr"])
    for (name, ref), (tname, got) in zip(jleaf_paths(jnew),
                                         leaf_paths(tnew)):
        assert name == tname
        r, g = np.asarray(ref, np.float32), _np(got)
        atol = 0.1 * lr if name.startswith("params/") else \
            1e-4 * np.abs(r).max() + 1e-20
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
