"""The plain v7 reader against checkpoints that the program wrote on the
CPU, with the cells' save policy: every leaf bit for bit, through both
codecs, leaves above and below the size the save path scans on the
device, stored and run-length blocks; and a damaged chunk refused."""
import numpy as np
import pytest
import torch

from crbench.reference import ckpt_reader as R


def saved(tmp_path, state, step=7):
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.core.storage import Tier, TieredStore
    pol = CheckpointPolicy().with_overrides(
        mode="incremental", chunking="cdc", chunk_size=1 << 20, codec="raw",
        params_codec="byteplane-rle", io_threads=8, retain=1)
    m = CheckpointManager(TieredStore(Tier("fast", tmp_path / "s")),
                          policy=pol, device="cpu")
    m.save(state, step, blocking=True)
    m.close()
    return tmp_path / "s"


def bits(t):
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def state():
    g = torch.Generator().manual_seed(5)
    big = torch.randn(3 << 20, generator=g).to(torch.bfloat16)  # 6 MiB
    big[: 1 << 20] = 0                       # runs: RLE blocks
    return {
        "params": {"big": big.view(1536, -1),
                   "small": torch.randn(1000, generator=g)
                   .to(torch.bfloat16),
                   "f32": torch.randn(48, generator=g)},
        "opt": {"m": torch.randn(3 << 19, generator=g).view(-1, 1024),
                "count": torch.tensor(3, dtype=torch.int32)},
    }


def test_reads_the_programs_checkpoint_bit_for_bit(tmp_path):
    st = state()
    root = saved(tmp_path, st)
    step, man, leaves = R.read_leaves(root)
    assert step == 7
    codecs = {s["codec"] for rec in man["leaves"].values()
              for s in rec["shards"]}
    assert codecs == {"raw", "byteplane-rle"}
    flat = {"params/big": st["params"]["big"],
            "params/small": st["params"]["small"],
            "params/f32": st["params"]["f32"], "opt/m": st["opt"]["m"],
            "opt/count": st["opt"]["count"]}
    assert set(leaves) == set(flat)
    for n, t in flat.items():
        got = leaves[n]
        assert got.shape == tuple(t.shape)
        np.testing.assert_array_equal(got.view(bits(t).dtype), bits(t))


def test_unframe_reads_both_block_kinds():
    # a stored block of 4096 bytes, then a run-length block of 10 bytes
    raw = bytes(range(256)) * 16
    enc = bytes([0, 0, 16]) + raw + bytes([1, 4, 0, 7, 9, 3, 1])
    out = R.unframe(enc, 4096 + 10)
    assert out[:4096].tobytes() == raw
    assert out[4096:].tolist() == [9] * 7 + [1] * 3


def test_a_damaged_chunk_is_refused(tmp_path):
    root = saved(tmp_path, state())
    obj = sorted((root / "_CAS" / "objects").rglob("*.obj"))[0]
    data = bytearray(obj.read_bytes())
    data[0] ^= 1
    obj.write_bytes(bytes(data))
    with pytest.raises(R.FormatError):
        R.read_leaves(root)
