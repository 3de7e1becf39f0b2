"""The bf16 flash-attention kernel's tile arithmetic (``ops.tile_plan``,
which ``csrc/flash_attention.cu`` carries as ``key_range``,
``tile_masked`` and the rank order) against the dense mask ``ops._mask``
and ``ops.unmasked_pairs``: every unmasked (query, key) pair lies in a
visited tile, a tile marked interior holds no masked pair, a skipped tile
is fully masked, and the launch order is a permutation of the query tiles
with non-increasing work. The kernel itself runs only on the card
(``test_torch_cuda_kernels.py``)."""
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.flash_attention import ops as fa


def _tile_counts(mask, bq, bk):
    """(unmasked, masked) pairs of real rows and keys in each (q tile,
    key tile)."""
    sq, sk = mask.shape
    nq, nk = -(-sq // bq), -(-sk // bk)
    real = torch.zeros((nq * bq, nk * bk), dtype=torch.bool)
    real[:sq, :sk] = True
    keep = torch.zeros_like(real)
    keep[:sq, :sk] = mask
    tiles = (nq, bq, nk, bk)
    on = keep.view(tiles).sum(dim=(1, 3))
    return on, (real & ~keep).view(tiles).sum(dim=(1, 3))


def _check(sq, sk, causal, window, bq, bk):
    tiles, order = fa.tile_plan(sq, sk, causal, window, bq, bk)
    mask = fa._mask(sq, sk, causal, window, "cpu")
    on, off = _tile_counts(mask, bq, bk)
    nq, nk = on.shape
    assert len(tiles) == nq
    visited_pairs = 0
    for qt, visits in enumerate(tiles):
        kts = [kt for kt, _ in visits]
        assert kts == sorted(set(kts)) and all(0 <= kt < nk for kt in kts)
        for kt in range(nk):
            if kt not in kts:
                assert on[qt, kt] == 0, (qt, kt, "skipped tile unmasked")
        for kt, masked in visits:
            visited_pairs += int(on[qt, kt])
            if not masked:
                assert off[qt, kt] == 0, (qt, kt, "interior tile masked")
    assert visited_pairs == int(mask.sum()) == \
        fa.unmasked_pairs(sq, sk, causal, window)
    assert sorted(order) == list(range(nq))
    work = [len(tiles[t]) for t in order]
    assert all(a >= b for a, b in zip(work, work[1:]))


@settings(max_examples=150, deadline=None)
@given(sq=st.integers(1, 3000), sk=st.integers(1, 3000),
       causal=st.booleans(), window=st.integers(0, 600),
       bq=st.sampled_from([64, 128]), bk=st.sampled_from([64, 128]))
def test_tile_plan_matches_mask(sq, sk, causal, window, bq, bk):
    _check(sq, sk, causal, window, bq, bk)


def test_tile_plan_at_the_paths_shapes():
    """The serving prefill (S 2048) and the training step (S 1024), causal
    and with the 512 window, at both block sizes of the kernel; the
    kernel's tile edges (windows 63-65, 128, 511, 513)."""
    for s in (1024, 2048):
        for window in (0, 63, 64, 65, 128, 511, 512, 513):
            for bq in fa.BLOCK_QS:
                _check(s, s, True, window, bq, fa.BLOCK_K)
    tiles, order = fa.tile_plan(2048, 2048, True, 0, 128)
    assert order == list(range(15, -1, -1))
    assert [len(t) for t in tiles] == [2 * (qt + 1) for qt in range(16)]
    assert [[kt for kt, m in t if m] for t in tiles] == \
        [[2 * qt, 2 * qt + 1] for qt in range(16)]
