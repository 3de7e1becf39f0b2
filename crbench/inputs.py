"""Everything a run feeds the program and the reference, made from
``--seed`` on the device: the weights (a few large draws, cast to the
dtype they are trained in) and each step's batch, keyed by (seed, step) so
that a restored data state finds its batch again.

Every seed gives the same sizes: only the values change."""
from __future__ import annotations

import hashlib
import math

import torch

MASK_SPAN = 10          # HuBERT's masked span, in frames
MASK_START = 0.08       # the chance that a frame starts one


def key(seed: int, *tags) -> int:
    """A 63-bit generator seed for (seed, tags)."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(key(seed, *tags))
    return g


def weights(spec: dict, seed: int, device) -> dict:
    """{leaf name: tensor} of a parameter spec ({name: (shape, init,
    dtype)}): every normal leaf cut from one draw, each uniform leaf from
    another."""
    g = generator(device, seed, "weights")
    normal = [(n, s) for n, s in spec.items()
              if isinstance(s[1], float)]
    total = sum(math.prod(s[0]) for _, s in normal)
    draw = torch.randn(total, generator=g, device=device)
    out, pos = {}, 0
    for name, (shape, scale, dt) in normal:
        n = math.prod(shape)
        out[name] = draw[pos:pos + n].view(shape).mul(scale).to(
            getattr(torch, dt))
        pos += n
    del draw
    for name, (shape, how, dt) in spec.items():
        if name in out:
            continue
        t = {"zeros": torch.zeros, "ones": torch.ones}.get(how)
        if t is not None:
            v = t(shape, device=device)
        elif how == "a_log":
            v = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float64,
                               device=device).log().float().expand(shape)
        elif how == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt0 = torch.exp(torch.rand(shape, generator=g, device=device)
                            * (hi - lo) + lo)
            v = dt0 + torch.log(-torch.expm1(-dt0))     # softplus⁻¹
        else:
            raise ValueError(f"{name}: unknown init {how!r}")
        out[name] = v.to(getattr(torch, dt)).contiguous()
    return {n: out[n] for n in spec}


def _zipf_cdf(vocab: int, device, a: float = 1.1):
    r = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = r.pow(-a)
    return torch.cumsum(p / p.sum(), 0).float()


def batch(c: dict, seed: int, step: int, device) -> dict:
    """The batch of data step `step`. A language model's tokens follow a
    Zipf law (exponent 1.1) over a seeded order of the vocabulary; an
    encoder's frames are unit normals in bf16 (the CNN front end's output
    stands in), with uniform cluster labels and HuBERT's span mask (each
    frame starts a span of 10 masked frames with probability 0.08)."""
    B, S = c["train"]["batch"], c["train"]["seq_len"]
    g = generator(device, seed, "batch", step)
    V = c["vocab_size"]
    if c["family"] != "encoder":
        cdf = _zipf_cdf(V, device)
        order = torch.randperm(V, generator=generator(device, seed, "vocab"),
                               device=device)
        u = torch.rand((B, S), generator=g, device=device)
        rank = torch.searchsorted(cdf, u).clamp_(max=V - 1)
        return {"tokens": order[rank].to(torch.int32)}
    feats = torch.randn((B, S, c["d_model"]), generator=g, device=device)
    labels = torch.randint(0, V, (B, S), generator=g, device=device,
                           dtype=torch.int32)
    starts = (torch.rand((B, S), generator=g, device=device) < MASK_START).int()
    run = torch.cumsum(starts, 1)
    ahead = torch.nn.functional.pad(run, (MASK_SPAN, 0))[:, :S]
    return {"features": feats.to(torch.bfloat16), "labels": labels,
            "mask": run > ahead}
