#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # everything, as documented below
    python3 chip_smoke.py --parity-only  # build + kernel parity, no main path
    python3 chip_smoke.py --k7-only      # build, K7's routes against the
                                         #   plain version, K7's times at the
                                         #   path's shapes, no main path
    python3 chip_smoke.py --k8-only      # build, K7/K8 parity, K8's times at
                                         #   the path's shapes, no main path
    python3 chip_smoke.py --profile      # + device time of save 2 / restore,
                                         #   of the uninterrupted serve, of
                                         #   one training step and of the
                                         #   zoo's step, preempt save and
                                         #   restore (also with --zoo-only)
    python3 chip_smoke.py --reliability-only  # build, parity, the
                                         #   reliability phase alone
    python3 chip_smoke.py --zoo-only     # build, parity, the zoo phase
                                         #   alone (needs 30 GB of disk
                                         #   under build/)
    python3 chip_smoke.py --families-only  # build, parity, the families
                                         #   phase alone (15 GB of disk)
    python3 chip_smoke.py --zoo-serve-only  # build, parity, the zoo
                                         #   serving phase alone (10 GB of
                                         #   disk)
    python3 chip_smoke.py --sharding-only  # build, parity, the sharding
                                         #   phase alone
    python3 chip_smoke.py --parallel-only  # build, K7/K8 parity, the zoo
                                         #   phase, then the parallel
                                         #   phase (30 GB of disk)
    python3 chip_smoke.py --remat-only   # build, K7/K8 parity, the remat
                                         #   phase alone
    python3 chip_smoke.py --compile-only # build, K7/K8 parity, the
                                         #   compile phase alone (its dry
                                         #   run then has no measured
                                         #   peaks to meet)
    python3 chip_smoke.py --compile-only --op-cost  # + C4's 30 serves
                                         #   (decode tokens/s through the
                                         #   operators, three ways; also
                                         #   in a full run)
    python3 chip_smoke.py --mixers-only  # build, parity, the mixers
                                         #   phase alone
    python3 chip_smoke.py --examples-only  # build, K7/K8 parity, the
                                         #   examples phase alone
    python3 chip_smoke.py --engine-only  # build, parity, the main path
                                         #   alone (the checkpoint round,
                                         #   its streaming restore and the
                                         #   engine's fault paths)
    python3 chip_smoke.py --stacks ...   # with any of the above: sample
                                         #   every thread's Python stack
                                         #   each 10 ms, counted per phase
                                         #   (and per run of preempt_resume)
                                         #   into chiprun_out/
                                         #   chip_smoke_stacks.txt

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. Kernel parity on the card: K1-K3 against their plain PyTorch versions
   byte for byte (tolerance 0) on 64 MiB of random bytes, ragged lengths,
   all-zero and constant runs (runs > 255, across 4096-byte blocks, a
   partial last block) and itemsizes 1/2/4/8; the gear scan's candidates
   against the numpy oracle on a 16 MiB slice; the RLE and rANS glue's
   streams and the K2+K1 ``scan_transform_async`` route against the numpy
   oracles. K7 (RMSNorm) and K8 (flash attention) against their plain
   versions in f32 and bf16 over the ``tests/test_kernels.py`` sweeps and
   the serving path's shapes, within that file's tolerances; K7 with each
   route forced (``RMS_ROUTE_CASES``: the path's shapes, D 37, D 8192, a
   misaligned view), its vector routes bit-equal; K8 at the
   bf16 kernel's edges (``ATTN_EDGES``: every head dim, ragged S, Sq != Sk,
   windows on and beside tile edges, the training shapes; bf16 at the
   launcher's block_q and at 64 and 128), two launches bit-equal; the
   reduced gemma3-1b model on the card (kernels) against the same model
   on the CPU (plain versions) in f32.
3. The checkpoint path: the gemma3-1b training state at full width,
   ``MAIN_LAYERS`` (2) of 26 layers (bf16 params, f32 AdamW moments;
   ~3.6 GB, ~10.0 GB at full depth) on the card, saved by
   ``CheckpointManager`` as an incremental CDC round (params through the
   fused K2+K1+K3 dispatch, moments through the segmented K1 scan), ~10% of
   the leaves changed, saved again asynchronously, restored onto the card
   and compared bit for bit. The launch counts of K1-K3 must be > 0, and
   one leaf of each route (``params/stage_0/b0/mlp/wg`` and its f32
   moment ``opt/m/...``) re-encoded by the host oracle must give the same
   chunk digests. Step 2 is then restored again through
   ``restore_streaming`` (``wait_frontier()`` and ``state()`` timed beside
   the blocking restore): bit-exact on the card, its frontier the leaves
   of the first two first-use classes (embed and block 0), K4 launched.
   Those two leaves, saved through the device route into a fresh store
   (two replicas), are restored onto the card bit-exact three ways: with
   one encoded chunk object of the params leaf zeroed (the direct
   placement's fallback), after a save of a changed copy dies at
   ``rank0_after_fused_dispatch`` while K1-K3 run (``gc()`` then
   ``fsck`` ok, ``latest_step()`` the last good step, the next save
   commits), and from the buddy replica with the primary object deleted.
4. The serving path: ``repro_torch.launch.serve.run`` serves full-width
   gemma3-1b in bf16 (8 requests, 2048-token prompts, 64 new tokens)
   uninterrupted, then again preempted at token 32 into a fresh workdir,
   then resumed from that checkpoint; the resumed tokens must equal the
   uninterrupted run's, and the launch counts of K7 and K8 must be > 0.
5. The training path: ``repro_torch.train.loop.Trainer`` trains
   full-width gemma3-1b, ``TRAIN_LAYERS`` (6) of 26 layers (bf16 params,
   f32 AdamW; synthetic pipeline seed 0, batch 4, sequence 1024 > window
   512); each step runs under deterministic algorithms, as in the
   launcher. Run A takes four steps uninterrupted; run B, in a fresh
   workdir with the checkpoint round's policy and ``ckpt_every=4``, is
   preempted after step 3 (``PreemptionGuard.request()``: blocking save);
   a new Trainer restores step 3 — K4 decoding every params leaf on the
   card — and runs step 4 (an overlapped save), whose ``params_digest``
   must equal run A's.
   The trained params (the leaves the int8 codec encodes) are then saved
   with ``params_codec="int8"`` through the K5 route and through the host
   oracle (``device_precondition=False``): manifests and CAS objects must
   be identical; the params
   restored through K6 must equal the host decode bit for bit. K1-K8 must
   all have launched in the phase.
6. The reliability plane: a ``WeightPublisher`` on a ``CheckpointManager``
   (the checkpoint round's policy, retain 1) over a fast/slow store
   wrapped in a seeded ``FaultPlane`` publishes full-width gemma3-1b
   params (``RELIABILITY_LAYERS`` (2) of 26 layers, bf16, seed 99) twice. Round 0 runs with the fast tier full
   (persistent ENOSPC on its object writes) and latency on the slow tier,
   and must commit degraded; round 1 changes every 10th leaf under a
   transient EIO and a silent bit-rot on two named fast-tier object
   writes (chunks the round re-promotes from the slow tier, because the
   CAS dedup check looks at the fast tier only: the rot site depends on
   that re-promotion) and the same latency; each round's fired sites must
   match its schedule. The
   inspector (``--verify``) must exit 1, ``scrub`` must heal the rot from
   the slow tier, the inspector must then exit 0, and round 1 restored
   onto the card (K4) must equal the published params bit for bit.
   ``serve.run(..., weight_sync=<fast root>)`` with the serving phase's
   traffic, at the same depth, must flip to round 1, serve params bit-equal to it and give
   the tokens of a direct loop (prefill with the initial params, decode
   with round 1's); a second subscriber's delta sync from round 0 to
   round 1 may pull no more than the changed leaves' new chunks plus 1
   MiB. Launches are counted per segment, from 0 just before it: K1-K3
   must launch in the publisher's saves, K4 in the restore, K7 and K8 in
   ``serve.run``. One ``{"reliability": ...}`` JSON
   line carries the round, inspector, scrub, restore, sync and serve
   times and bytes.
7. The rest of the attention zoo: K8 at the new configs' path shapes
   (``ZOO_ATTN``: causal; gemma2-9b with softcap 50 and q scaled so its
   logits reach it, windowed 4096 at S 8192 and global at S 2048;
   stablelm-1.6b, starcoder2-3b, chameleon-34b, llama4-scout and kimi-k2
   at S 2048, and llama4's training shape) and K7 at their widths and
   chameleon's qk-norm rows (``ZOO_RMS``), bf16, within the tolerances
   above; K8 also within ``attn_err``'s bound relative to the plain
   output, which the plain output without gemma2's softcap or window must
   fail. Then llama4-scout-17b-a16e at full width, 2 of 48
   layers (~6.5 G params, ~13 GB of bf16), trains through the port's
   ``Trainer`` with Adafactor (synthetic pipeline seed 0, batch 4 × 1024)
   in the training phase's harness (``preempt_resume``): run A four
   steps; run B preempted after step 3 and resumed to step 4, whose
   ``params_digest`` must equal run A's. Its 2.7 GB expert
   stack ``params/stage_0/b0/moe/wg`` is a leaf past 2^31 bytes: restored
   through K4 it must equal the saved leaf bit for bit, and its device cut
   points and chunk digests in a window across byte 2^31 must equal the
   host oracle's (``straddle_check``). Launches are read per segment from
   0: run A's steps must launch K7 and K8, run B's saves K1-K3, the
   restore K4. One ``{"zoo": ...}`` line carries the step times, tokens/s,
   peak device bytes, ``drop_fraction``, save and restore times and bytes,
   and the largest leaf. The phase needs 30 GB of disk under ``build/``
   (``build/chip_smoke_zoo``, removed when it ends).
8. The SSM, RG-LRU and encoder families: K8 at their path shapes
   (``FAMILY_K8``: hubert-xlarge's head dim 80, non-causal, which runs
   the D 128 instantiation over maps of inner dim 80; recurrentgemma-9b's
   MQA window of 2,048 at B 8, S 4,096) within ``attn_err``'s bound, K7 at
   their widths (``FAMILY_RMS``: 1,536, mamba2's gated norm at 3,072,
   4,096), and the reduced configs on the card against the CPU. Then
   ``serve.run`` serves mamba2-780m at full width, 12 of 48 layers (8
   requests of 2,048-token prompts, 64 new tokens) and
   recurrentgemma-9b at full width, 3 of 38 layers (4,096-token prompts,
   past the window), each uninterrupted, preempted at token 32 and
   resumed: the resumed tokens must equal the uninterrupted run's. Then
   ``preempt_resume`` trains mamba2-780m (3 of 48 layers, SSD chunks of
   256) and hubert-xlarge (3 of 48 layers, encoder batches) at full
   width with AdamW, batch 4 × 1024: finite losses, and the resumed run's
   ``params_digest`` equal to run A's. Launches are read per segment: K7
   (and K8 where there is attention) in the serves and steps, K1-K3 in
   the training saves, K4 in the restores. K8 and K7 are timed at the
   families' shapes (``FAMILY_K8``, ``FAMILY_RMS``). One
   ``{"families": ...}`` JSON line carries the prefill, decode, save and
   restore numbers of each serve and the step, tokens/s, peak and
   ``restore_to_first_step_s`` of each training run. Its checkpoints go
   to ``build/chip_smoke_families`` (removed when it ends).
9. The zoo served (``zoo_serving``): K8 and K7 at the phase's prefill
   shapes against their plain versions (``ZOO_SERVE_K8``: B 8, gemma2-9b's
   local and global layers at S 4,608 with its softcap and window;
   ``ZOO_SERVE_RMS``), then ``serve.run`` serves, at full width with the
   serving phase's traffic, stablelm-1.6b (2 of 24 layers),
   starcoder2-3b (2 of 30), gemma2-9b (2 of 42: one local, one global;
   4,608-token prompts past its window of 4,096), chameleon-34b (1 of 48)
   and kimi-k2-1t-a32b (2 of 61: the dense layer and one MoE layer of 384
   experts, 39.94 GB of bf16), each uninterrupted and, but for kimi-k2,
   preempted at token 32 and resumed: the resumed tokens must equal the
   uninterrupted run's, tokens must lie in the vocabulary, K8 must launch
   once a layer and K7 ``k7_per_forward`` times a forward (the RMSNorm
   configs; chameleon's q/k norms counted). Each config is then prefilled
   with 2 × 64 tokens and decoded token by token from ``init_cache``
   (kimi-k2 at the no-drop capacity): the same argmax, and the logits
   within ``MESH_SERVE_RTOL`` of the largest. One ``{"zoo_serving": ...}``
   line carries each config's prefill s, decode tokens/s, save s and
   bytes, restore s, launches per run and peak device bytes. Stores go to
   ``build/chip_smoke_zoo_serve``, each config's removed after it runs.
10. The remat phase (``remat_phase``), after the families: full-width,
   full-depth gemma3-1b (26 layers, five remat units), one batch of 4 ×
   1,024 tokens, the same bf16 params, ``make_train_step(...).grads``
   under each of ``full``, ``nothing``, ``dots`` and ``offload_resid``
   (after a warm-up call): loss and every gradient bit-equal to
   ``full``'s, the peaks ordered ``nothing`` < ``dots`` < ``full`` with
   ``offload_resid`` not above ``nothing``, K8 launched twice as often as
   under ``full``; each policy's seconds, peak and K7/K8 launches are
   printed. Then ``Trainer`` trains mamba2-780m at full width and all 48
   layers (AdamW, 4 × 1,024 tokens, SSD chunks of 256, its config's
   ``nothing`` policy) three steps with no checkpoint: finite loss and
   ``grad_norm`` at every step, peak and step s printed, and the peak of
   its forward and backward alone (``grads``, no update). One
   ``{"remat": ...}`` line. Every training step of the script runs under
   its config's policy (``nothing``), so K7 and K8 run again in each
   step's recompute.
11. The sharding phase (``sharding``), after the families: full-width
   gemma3-1b moved card → four CPU ranks → card, bit for bit.
12. The parallel phase (``parallel``), after the zoo, on its checkpoint:
   K8 with ``q_offset`` at llama4-scout's training shape and gemma2-9b's
   window of 4,096 at S 8,192, each split four ways over the sequence,
   within ``attn_err``'s bound (the no-offset control must fail it); four
   rank processes on the one card (gloo on CUDA tensors) check the
   collectives, restore the zoo's step 4 onto a (2,2) mesh through
   ``Trainer(mesh=)`` (K4 decodes each rank's shards) and take step 5
   with the layout step: loss and grad_norm within 1e-3 of the zoo's run
   A, each rank's peak device bytes below the full bf16 parameter tree's,
   K4, K7 and K8 launched in every rank; then ``moe_apply_shard_map``
   over four ranks against ``moe_apply``'s routed experts on one. One
   ``{"parallel": ...}`` line.
13. The compile phase (``compile``): the dry run
   (``launch.dryrun.run_cell`` on fake tensors over a fake process group)
   traces each rank of the parallel phase's cell, whose predicted step
   peak must be within 25% of the rank's measured ``peak_device_bytes``
   and whose state bytes must equal the rank's local state bytes (each
   part printed beside the measured one), and gemma3-1b's train_4k,
   prefill_32k and decode_32k on (16, 16), whose records are printed;
   four ranks on the card serve full-width gemma3-1b
   (``MESH_SERVE_LAYERS``) on
   the sharded layout on (2,2) and (1,4) (``--serve-rank``: four prompts
   of 1,024 tokens, eight decode steps, the one-device run's tokens
   forced), every step's logits within ``MESH_SERVE_RTOL`` of the
   one-device run's; the one-device prefill exported into an empty
   ``core.aot_cache.AotCache`` (a miss) and loaded in a fresh process
   (``--aot-load``: a hit, outputs bit-equal to the eager prefill's, K7
   and K8 launched by the loaded program); the host µs of a K7 call
   through the registered operator against the direct wrapper, and with
   ``--op-cost`` serving's decode tokens/s both ways (30 serves). One
   ``{"compile": ...}`` line; the kernel rows carry ``launches_compile``.
14. The mixers phase (``mixers``): one device takes a train step and
   serves a prefill and ``MIXER_STEPS`` decode steps of each of
   ``MIXER_CELLS`` (mamba2-780m at 2 of 48 layers, recurrentgemma-9b at
   3 of 38, full width), then four ranks on the card (``--mixers-rank``,
   gloo) run them on the (1, 4) mesh, where the SSM's heads and the
   RG-LRU's channels split over ``"model"``: the layout step's loss and
   grad_norm within ``PAR_RTOL`` of one device's, each step's logits
   within ``MESH_SERVE_RTOL`` of its largest and the argmax equal but at
   a bf16 near tie, K7 and K8 launched a rank as often as on one device,
   each rank's peak device bytes, and the split mixer's seconds beside
   the whole-leaf mixer's (``_mixer_times``). One ``{"mixers": ...}``
   line; the kernel rows carry ``launches_mixers``.
15. The examples phase (``examples``), last: the port's twins of the four
   examples (``examples/torch_*.py``) through their ``main(device=)`` on
   the card at their reduced configs — quickstart, preempt_and_resume and
   serve_with_cr in this process, one after another, while
   elastic_rescale runs as its 8 gloo ranks beside them —
   each with its original's check (digests equal, preempted at 12 and
   restored from 12, tokens equal, digests across meshes), its seconds and
   each process's peak device bytes; K7 and K8 must launch in the phase.
   One ``{"examples": ...}`` line; the kernel rows carry
   ``launches_examples`` (the elastic ranks count K7 and K8 only; the
   others are null there).
16. Prints one JSON line of per-kernel numbers (CUDA-event times at each
   path's largest shapes, bounds from the bytes or operations each kernel
   needs, the plain version's and a library call's time; K7 also at every
   shape of ``K7_SHAPES`` with the L2 cold, each route forced; K8 also at the
   serving and training shapes of ``K8_SHAPES`` with TFLOP/s, both
   block_q and its ptxas registers and spills; K6 beside the one PyTorch
   call that computes it, ``torch.mul(q, scales[:, None], out=bf16)``,
   bit-equal at both output dtypes; K4 with the share of its bound,
   ``bound_share``, and beside its earlier three-launch design,
   ``earlier_ms``, built from git at ``K4_EARLIER_COMMIT`` where the
   checkout has that history, else null),
   one JSON line of end-to-end numbers,
   one ``{"phase_s": ...}`` line (each phase's wall seconds, also printed
   as the phase ends, and the total), and last the
   ``{"ok": true, "device": ...}`` line. Any failure exits
   non-zero.

K4-K6 join the parity phase: K4 byte for byte on the same inputs and
itemsizes as K2 (and K4 of K2 is the identity), and five launches in a row
on the 64 MiB input at itemsizes 1 and 2, each equal to the plain version
(K4's tiles join through a look-back whose races would show only now and
then), K5 byte for byte on q and
bit for bit on the scales over bf16/f32 inputs with exact .5 ties,
all-zero blocks and ragged lengths, K6 bit for bit on both output dtypes.

It imports nothing of JAX or of the ``repro`` package. Scratch checkpoints
go to ``build/chip_smoke_store``, ``build/chip_smoke_serve`` and
``build/chip_smoke_train`` (each removed when its phase ends, and all at
the end), logs to ``chiprun_out/``.
The reliability phase's go to ``build/chip_smoke_reliability``, removed
when it ends.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit(f"{ROOT} is not a checkout of the repository "
             "(src/repro_torch missing)")
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels.timing import card_line, time_ms  # noqa: E402
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12                # H100 SXM dense bf16, NVIDIA data sheet
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
# the deterministic train step needs cuBLAS's workspace setting before the
# process first uses cuBLAS (the serving phase runs before training), as
# ``python -m repro_torch.launch.train`` sets it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
MIN_FREE_BYTES = 25e9
MiB = 1 << 20
# gemma3-1b's layers in the checkpoint round, of 26, and the reliability
# phase's: two, to keep the script inside its limit (the engine treats a
# local and a global layer's leaves alike; the round moves the state's
# bytes, 3.56 GB at two layers and 4.63 GB at six; the reliability phase's
# publishes, syncs, scrub and inspections the params', 0.72 GB at two and
# 0.93 GB at six)
MAIN_LAYERS = 2
RELIABILITY_LAYERS = 2
# K4's earlier design (tile sums, a per-plane tile scan, then the inverse:
# three launches that read the input twice) is timed beside it where git
# can show its source at this commit
K4_EARLIER_COMMIT = "cffcb76"
PHASE_S: dict = {}             # wall seconds of each phase of this run
T_START = time.monotonic()


CURRENT_PHASE = ["setup", ""]      # (phase, segment): the sampler's key


class phase:
    """``with phase(name):`` records the block's wall seconds in
    ``PHASE_S`` and prints them as the phase ends (a run cut by its time
    limit then shows how far it got)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        CURRENT_PHASE[:] = [self.name, ""]

    def __exit__(self, *exc):
        PHASE_S[self.name] = time.monotonic() - self.t0
        CURRENT_PHASE[:] = ["between", ""]
        say(f"phase {self.name}: {PHASE_S[self.name]:.3f} s")


class StackSampler:
    """With ``--stacks``: a daemon thread samples every other thread's
    Python stack each `period` seconds and counts, per phase, the
    innermost `depth` frames of each sample (a thread blocked in a C call,
    a read, an fsync or a lock shows as the line that made the call).
    ``write(path)`` writes each phase's most frequent stacks with their
    share of that phase's samples."""

    def __init__(self, period: float = 0.01, depth: int = 4):
        import collections
        import threading
        self.period, self.depth = period, depth
        self.counts = collections.defaultdict(collections.Counter)
        self.samples = collections.Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        me = __import__("threading").get_ident()
        while not self._stop.wait(self.period):
            ph = "/".join(p for p in CURRENT_PHASE if p)
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                key, f = [], frame
                while f is not None and len(key) < self.depth:
                    key.append(f"{Path(f.f_code.co_filename).name}:"
                               f"{f.f_lineno}:{f.f_code.co_name}")
                    f = f.f_back
                self.counts[ph][" < ".join(key)] += 1
                self.samples[ph] += 1

    def write(self, path: Path, top: int = 40):
        self._stop.set()
        self._thread.join()
        lines = []
        for ph, c in self.counts.items():
            n = self.samples[ph]
            lines.append(f"== {ph}: {n} thread samples, period "
                         f"{self.period} s")
            for key, k in c.most_common(top):
                lines.append(f"{k / n:7.3f} {k:7d}  {key}")
        path.write_text("\n".join(lines) + "\n")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a):
    print(*a, flush=True)


def bits(t):
    import torch
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def max_abs_err(a, b) -> int:
    import torch
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


class DeviceProfile:
    """``with DeviceProfile(on) as p:`` traces the CUDA activity of the
    block with ``torch.profiler`` when `on`; ``p.summary(wall_s)`` then
    gives device-busy seconds (kernels + copies, one stream: they do not
    overlap), the idle share of the wall time, and the top entries. With
    `host`, the host's operators are traced too and the summary adds the
    top ones by self CPU time."""

    def __init__(self, on: bool, host: bool = False):
        self.on = on
        self.host = host
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CUDA] + \
                ([ProfilerActivity.CPU] if self.host else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)

    def summary(self, wall_s: float):
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        # device-side events only (kernels, copies): with the host traced,
        # each operator also carries its kernels' device time
        rows = sorted(((e.key, e.count, e.self_device_time_total)
                       for e in self.prof.key_averages()
                       if e.self_device_time_total > 0
                       and e.device_type != DeviceType.CPU),
                      key=lambda r: -r[2])
        busy = sum(r[2] for r in rows) / 1e6
        out = {"wall_s": wall_s, "device_busy_s": busy,
               "idle_share": 1.0 - busy / wall_s,
               "top": [{"name": k[:80], "count": c, "ms": us / 1e3}
                       for k, c, us in rows[:12]],
               # the model kernels' device time, every route summed
               "model_kernels": {
                   name: {"count": sum(c for k, c, _ in rows if tag in k),
                          "ms": sum(us for k, _, us in rows if tag in k)
                          / 1e3}
                   for name, tag in (("rmsnorm", "rms_"),
                                     ("flash_attention", "flash_"))}}
        if self.host:
            ops = sorted(((e.key, e.count, e.self_cpu_time_total)
                          for e in self.prof.key_averages()
                          if e.self_cpu_time_total > 0),
                         key=lambda r: -r[2])
            out["host_self_s"] = sum(r[2] for r in ops) / 1e6
            out["host_top"] = [{"name": k[:80], "count": c, "ms": us / 1e3}
                               for k, c, us in ops[:15]]
        return out


# ---------------------------------------------------------------------------
# phase 2 — kernel parity
# ---------------------------------------------------------------------------

def parity(dev):
    import numpy as np
    import torch

    from repro_torch.core import cdc_scan
    from repro_torch.core.cdc import GearChunker
    from repro_torch.core.codec import byteplane_forward, plane_stream_encode
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent

    ck = GearChunker(1 << 20, device=dev)
    ms, ml = int(ck.mask_strict), int(ck.mask_loose)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def rand(n):
        return torch.randint(0, 256, (n,), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def runs(n, maxlen=700):
        reps = torch.randint(1, maxlen, (n // 100 + 1,), generator=g,
                             device=dev)
        vals = torch.randint(0, 256, reps.shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)
        return torch.repeat_interleave(vals, reps)[:n].contiguous()

    inputs = {
        "random_64MiB": rand(64 * MiB),
        "random_ragged": rand(64 * MiB + 12_345),
        "zeros_ragged": torch.zeros(5 * MiB + 7, dtype=torch.uint8,
                                    device=dev),
        "const_partial_block": torch.full((4096 * 37 + 1000,), 0xA7,
                                          dtype=torch.uint8, device=dev),
        "runs_ragged": runs(3 * MiB + 4097),
        "one_byte": rand(1),
        "window": rand(64),
    }
    checks = 0
    for name, u8 in inputs.items():
        n = u8.numel()
        for k in (1, 2, 4, 8):
            a, b = bp.forward_planes(u8, k), bp.forward_plain(u8, k)
            if not torch.equal(a, b):
                fail(f"K2 byteplane_fwd != plain on {name} k={k}")
            if not torch.equal(bp.inverse_planes(u8, k),
                               bp.inverse_plain(u8, k)):
                fail(f"K4 byteplane_inv != plain on {name} k={k}")
            if not torch.equal(bp.inverse_planes(a, k), u8):
                fail(f"K4 of K2 is not the identity on {name} k={k}")
            checks += 3
        padded = torch.zeros(cdc_scan.padded_len(n), dtype=torch.uint8,
                             device=dev)
        padded[cdc_scan.WINDOW:cdc_scan.WINDOW + n] = u8
        if not torch.equal(cdc_scan.gear_scan(padded, ms, ml),
                           cdc_scan.gear_scan_plain(padded, ms, ml)):
            fail(f"K1 gear_scan != plain on {name}")
        nb = -(-n // ent.B)
        blk = torch.zeros(nb * ent.B, dtype=torch.uint8, device=dev)
        blk[:n] = u8
        blk = blk.view(nb, ent.B)
        for a, b in zip(ent.rle_emission(blk, n),
                        ent.rle_emission_plain(blk, n)):
            if not torch.equal(a, b):
                fail(f"K3 rle_emit != plain on {name}")
        checks += 2
        torch.cuda.synchronize()
    # K4 launched again and again on one input: every launch equal
    u8 = inputs["random_64MiB"]
    for k in (1, 2):
        want = bp.inverse_plain(u8, k)
        for i in range(5):
            if not torch.equal(bp.inverse_planes(u8, k), want):
                fail(f"K4 byteplane_inv launch {i} != plain on random_64MiB "
                     f"k={k}")
            checks += 1
        del want
    # K1 through the segmented scanner: candidates vs the numpy oracle
    data = inputs["random_64MiB"][:16 * MiB].cpu().numpy()
    got = cdc_scan.GearScanner(ms, ml, backend="pallas",
                               device=dev).scan(data)
    ref = cdc_scan.scan_candidates_numpy(data, ms, ml)
    if not all(np.array_equal(x, y) for x, y in zip(got, ref)):
        fail("K1 candidates != numpy oracle on the 16 MiB slice")
    # K3 + glue: the framed stream vs the numpy codec oracle
    t = bp.forward_plain(runs(4 * MiB + 999, 3000), 2).cpu().numpy()
    s, bl = ent.encode_stream(t, "byteplane-rle", device=dev)
    rs, rbl = plane_stream_encode(t, "byteplane-rle")
    if not (np.array_equal(s, rs) and np.array_equal(bl, rbl)):
        fail("byteplane-rle stream on the card != numpy oracle")
    # the rANS glue: same framed stream as the numpy oracle
    w = torch.randn(2 * MiB, generator=g, device=dev).mul_(0.02) \
        .to(torch.bfloat16).view(torch.uint8)
    t = bp.forward_plain(w, 2).cpu().numpy()
    s, bl = ent.encode_stream(t, "byteplane-rans", device=dev)
    rs, rbl = plane_stream_encode(t, "byteplane-rans")
    if not (np.array_equal(s, rs) and np.array_equal(bl, rbl)):
        fail("byteplane-rans stream on the card != numpy oracle")
    # K2+K1 without the entropy stage, and K2 alone: the routes of fixed
    # chunking and device_entropy=False
    data = w.cpu().numpy()
    sc = cdc_scan.GearScanner(ms, ml, backend="pallas", device=dev)
    (gs, gl), gt = sc.scan_transform_async(data, 2).result()
    rt = byteplane_forward(data, 2)
    rs, rl = cdc_scan.scan_candidates_numpy(rt, ms, ml)
    if not (np.array_equal(gt, rt) and np.array_equal(gs, rs)
            and np.array_equal(gl, rl)):
        fail("scan_transform_async on the card != numpy oracle")
    if not np.array_equal(cdc_scan.transform_async(data, 2, dev).result(),
                          rt):
        fail("transform_async on the card != numpy oracle")
    say(f"parity: {checks + 2} kernel/plain comparisons byte-identical "
        f"({len(inputs)} inputs, k in 1/2/4/8, K1-K4); 16 MiB candidate "
        f"slice, RLE and rANS streams, scan_transform_async and "
        f"transform_async identical to the numpy oracles")
    del inputs
    torch.cuda.empty_cache()
    int8_parity(dev, g)


def int8_parity(dev, g):
    """K5 and K6 against their plain versions, bit for bit: blocks whose
    amax is 127 or 254 (scale 1.0 or 2.0) holding exact .5 ties of the
    quotient, all-zero blocks, random normals and subnormal-scale blocks,
    in bf16 and f32, at ragged lengths."""
    import torch

    from repro_torch.kernels.ckpt_codec import int8_codec as ic
    B = ic.BLOCK
    nb = 4099
    halves = (torch.randint(-253, 254, (nb, B), generator=g, device=dev)
              .float() * 0.5)                 # k + 0.5 ties and integers
    ties = torch.where(torch.arange(nb, device=dev)[:, None] % 2 == 0,
                       halves, halves * 2.0)  # scale 1 and scale 2 blocks
    ties[:, 0] = torch.where(torch.arange(nb, device=dev) % 2 == 0, 127.0,
                             254.0)
    ties[::7] = 0.0                           # all-zero blocks
    normal = torch.randn((nb, B), generator=g, device=dev) * 0.02
    tiny = torch.randn((nb, B), generator=g, device=dev) * 1e-39
    checks = 0
    for dtype in (torch.bfloat16, torch.float32):
        for name, x in (("ties", ties), ("normal", normal), ("tiny", tiny)):
            flat = x.to(dtype).reshape(-1)
            for n in (flat.numel(), flat.numel() - 77, 1, 300):
                xs = flat[:n]
                (q, s), (pq, ps) = ic.quantize_blocks(xs), \
                    ic.quantize_plain(xs)
                if not (torch.equal(q, pq) and torch.equal(bits(s), bits(ps))):
                    fail(f"K5 quantize != plain on {name} {dtype} n={n}")
                for out in (torch.bfloat16, torch.float32):
                    a = ic.dequantize_blocks(q, s, n, out)
                    b = ic.dequantize_plain(q, s, n, out)
                    if not torch.equal(bits(a), bits(b)):
                        fail(f"K6 dequantize != plain on {name} {dtype} "
                             f"n={n} -> {out}")
                checks += 3
    torch.cuda.synchronize()
    say(f"parity: K5/K6 {checks} comparisons bit-identical (ties, zero "
        f"blocks, normals, subnormal scales; bf16/f32; ragged lengths)")


# tolerances of tests/test_kernels.py:34, :66 (the sums run in another
# order than the plain versions')
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# (B, Sq, Sk, H, K, D, causal, window, softcap): the test_kernels.py
# sweeps, then the serving path's prefill shapes (local and global layers)
ATTN_CASES = [
    (1, 64, 64, 4, 4, 32, True, 0, 0.0),
    (2, 128, 128, 4, 1, 16, True, 0, 0.0),
    (1, 96, 96, 8, 2, 64, True, 0, 0.0), (1, 60, 60, 2, 2, 16, True, 0, 0.0),
    (1, 80, 80, 4, 2, 32, True, 16, 0.0),
    (1, 80, 80, 4, 2, 32, True, 0, 30.0),
    (1, 80, 80, 4, 2, 32, False, 24, 0.0),
    (1, 80, 80, 4, 2, 32, False, 0, 0.0),
    (8, 2048, 2048, 4, 1, 256, True, 512, 0.0),
    (8, 2048, 2048, 4, 1, 256, True, 0, 0.0),
]
# the bf16 kernel's edges: every head dim, ragged S, Sq != Sk, windows on
# and beside the 64-key tile edges, the training step's shapes (inputs
# from a generator of their own, so that K7's and the cases above keep
# their inputs)
ATTN_EDGES = [
    *[(1, 200, 200, 4, 2, d, True, 0, 0.0) for d in range(16, 257, 16)],
    *[(2, 150, 150, 4, 1, d, False, 0, 20.0) for d in (16, 64, 80, 256)],
    (1, 130, 130, 4, 4, 80, False, 40, 0.0),
    (4, 1024, 1024, 16, 16, 80, False, 0, 0.0),    # hubert-xlarge's shape
    (1, 1000, 1000, 4, 1, 256, True, 0, 0.0),
    (1, 2047, 2047, 4, 1, 256, True, 512, 0.0),
    (1, 100, 300, 4, 1, 128, False, 0, 0.0),
    (1, 300, 100, 4, 2, 64, True, 0, 0.0),
    (2, 130, 700, 4, 1, 256, False, 65, 0.0),
    *[(1, 1100, 1100, 4, 1, 256, True, w, 0.0)
      for w in (63, 64, 65, 128, 511, 513)],
    (4, 1024, 1024, 4, 1, 256, True, 0, 0.0),
    (4, 1024, 1024, 4, 1, 256, True, 512, 0.0),
    # q_offset (a 10th entry): one rank's rows of a longer sequence, at an
    # offset of 0, on a 64-key tile edge and beside it
    *[(1, 256, 1024, 4, 2, 128, True, 0, 0.0, o) for o in (0, 512, 511,
                                                           513)],
    *[(1, 200, 1024, 4, 1, 256, True, 128, 0.0, o) for o in (448, 449)],
    (1, 130, 700, 4, 1, 64, False, 65, 0.0, 300),
    (2, 256, 1024, 4, 2, 128, True, 0, 50.0, 768),
]
# two launches at this shape must be bit-equal (the training resume is
# bit-exact only if K8 does not depend on scheduling)
ATTN_DETERMINISM = (2, 1024, 4, 1, 256)
# (rows shape, D): the test_kernels.py sweep, then the path's widths
RMS_CASES = [((16,), 64), ((37,), 96), ((3, 5), 128), ((8 * 2048,), 1152),
             ((8 * 2048, 4), 256), ((8, 1), 1152)]

# K7's routes, each forced where it can run: the path's (rows, D) (serving
# prefill, training step, decode), a ragged last stage, chameleon-34b's D
# 8192 and D 37; then a view at an odd offset (inputs from a generator of
# their own, so that the cases above keep theirs)
RMS_ROUTE_CASES = [(16_384, 1152), (65_536, 256), (16_384, 256),
                   (4096, 1152), (4096, 256), (8, 1152), (32, 256), (8, 256),
                   (16_384 + 3, 1152), (300, 8192), (37, 37)]
RMS_MISALIGNED = [(16_384, 1152), (37, 37)]


def rms_flip_report(x, s, got, eps: float) -> str:
    """Where the kernel and the plain version differ most: the element,
    its f64-exact value and the two roundings."""
    import torch
    from repro_torch.kernels.rmsnorm import ops as rn
    ref = rn.rmsnorm_plain(x, s, eps=eps)
    diff = (got.float() - ref.float()).abs().reshape(-1)
    i = int(diff.argmax())
    d = x.shape[-1]
    row = x.reshape(-1, d)[i // d].double()
    exact = (row[i % d] / torch.sqrt(row.square().mean() + eps)
             * (1.0 + s.double()[i % d])).item()
    return (f"element {i} (row {i // d}, col {i % d}): f64-exact {exact!r}, "
            f"kernel {got.reshape(-1)[i].item()!r}, plain "
            f"{ref.reshape(-1)[i].item()!r}")


def k7_route_parity(dev) -> dict:
    """Each K7 route, forced, against ``rmsnorm_plain`` (``RMS_TOL``); the
    stream and warp routes bit-equal on the same rows; two launches
    bit-equal; the launch count one up per call."""
    import torch

    from repro_torch.kernels.rmsnorm import ops as rn
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    worst, checks = {}, 0

    def check(x, s, route, name, what):
        nonlocal checks
        before = rn.launches
        got = rn.rmsnorm_fused(x, s, route=route)
        if rn.launches != before + 1:
            fail(f"K7 {what} route {route}: launch count {before} -> "
                 f"{rn.launches}")
        err = (got.float() - rn.rmsnorm_plain(x, s).float()).abs().max()
        err = err.item()
        if not err <= RMS_TOL[name]:
            fail(f"K7 {what} route {route}: max abs err {err} > "
                 f"{RMS_TOL[name]}; {rms_flip_report(x, s, got, rn.EPS)}")
        worst[f"{route or 'auto'}_{name}"] = max(
            worst.get(f"{route or 'auto'}_{name}", 0.0), err)
        checks += 1
        return got

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for n, d in RMS_ROUTE_CASES:
            x = torch.randn((n, d), generator=g, device=dev).to(dtype)
            s = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dtype)
            vector = (d * x.element_size()) % 16 == 0
            outs = {}
            for route in (None, *rn.ROUTES):
                if route in ("stream", "warp") and not vector:
                    continue
                outs[route] = check(x, s, route, name, f"{name} {n} x {d}")
            if vector:
                ref = bits(outs["stream"])
                if not torch.equal(bits(outs["warp"]), ref):
                    fail(f"K7 {name} {n} x {d}: routes stream and warp "
                         "differ in bits")
                again = rn.rmsnorm_fused(x, s, route="stream")
                if not torch.equal(bits(again), ref):
                    fail(f"K7 {name} {n} x {d}: two stream launches differ")
            del x, s, outs
        for n, d in RMS_MISALIGNED:
            flat = torch.randn((n * d + 1,), generator=g, device=dev)
            x = flat.to(dtype)[1:].view(n, d)
            s = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dtype)
            check(x, s, None, name, f"{name} misaligned {n} x {d}")
            check(x, s, "scalar", name, f"{name} misaligned {n} x {d}")
    torch.cuda.synchronize()
    say(f"parity: K7 routes forced at {len(RMS_ROUTE_CASES)} shapes and "
        f"{len(RMS_MISALIGNED)} misaligned views, f32 and bf16: {checks} "
        f"checks within tolerance; stream/warp bit-equal, two "
        f"launches bit-equal; worst {json.dumps(worst)}")
    return worst


def model_kernel_parity(dev):
    """K7 and K8 against their plain versions on the card, f32 and bf16."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    g_edges = torch.Generator(device=dev)
    g_edges.manual_seed(8)

    def randn(*shape, dtype, gen=g):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for rows, d in RMS_CASES:
            x = randn(*rows, d, dtype=dtype)
            s = (randn(d, dtype=torch.float32) * 0.1).to(dtype)
            err = (rn.rmsnorm_fused(x, s).float()
                   - rn.rmsnorm_plain(x, s).float()).abs().max().item()
            if not err <= RMS_TOL[name]:
                fail(f"K7 rmsnorm {name} rows={rows} D={d}: max abs err "
                     f"{err} > {RMS_TOL[name]}; "
                     f"{rms_flip_report(x, s, rn.rmsnorm_fused(x, s), rn.EPS)}")
            worst[f"rmsnorm_{name}"] = max(worst.get(f"rmsnorm_{name}", 0),
                                           err)
        cases = [(c, g) for c in ATTN_CASES] + \
            [(c, g_edges) for c in ATTN_EDGES]
        for (B, Sq, Sk, H, K, D, causal, window, cap, *off), gen in cases:
            q = randn(B, Sq, H, D, dtype=dtype, gen=gen)
            k = randn(B, Sk, K, D, dtype=dtype, gen=gen)
            v = randn(B, Sk, K, D, dtype=dtype, gen=gen)
            kw = dict(causal=causal, window=window, softcap=cap,
                      q_offset=off[0] if off else 0)
            ref = fa.flash_attention_plain(q, k, v, **kw).float()
            # bf16: the launcher's choice of block_q and both forced
            for bq in ((0, 64, 128) if dtype == torch.bfloat16 else (0,)):
                err = (fa.flash_attention(q, k, v, block_q=bq, **kw).float()
                       - ref).abs().max().item()
                if not err <= ATTN_TOL[name]:
                    fail(f"K8 flash_attention {name} B={B} Sq={Sq} Sk={Sk} "
                         f"H={H} K={K} D={D} {kw} block_q={bq}: max abs "
                         f"err {err} > {ATTN_TOL[name]}")
                key = f"flash_attention_{name}"
                worst[key] = max(worst.get(key, 0), err)
            del q, k, v, ref
        torch.cuda.synchronize()
    B, S, H, K, D = ATTN_DETERMINISM
    q, k, v = (randn(B, S, n, D, dtype=torch.bfloat16, gen=g_edges)
               for n in (H, K, K))
    for window in (0, 512):
        a, b = (fa.flash_attention(q, k, v, causal=True, window=window)
                for _ in range(2))
        if not torch.equal(bits(a), bits(b)):
            fail(f"K8 is not deterministic: two launches at {(B, S, H, K, D)}"
                 f" window {window} differ")
    del q, k, v, a, b
    torch.cuda.empty_cache()
    say(f"parity: K7 over {len(RMS_CASES)} shapes and K8 over "
        f"{len(ATTN_CASES) + len(ATTN_EDGES)} shapes/masks, f32 and bf16 "
        f"(bf16 at block_q "
        f"auto/64/128), within tolerance; K8 bit-equal over two launches at "
        f"{ATTN_DETERMINISM}; worst max abs err {json.dumps(worst)}")
    worst["k7_routes"] = k7_route_parity(dev)
    worst["model_logits"] = model_reference(dev)
    return worst


def model_reference(dev, atol: float = 1e-4) -> float:
    """Reduced gemma3-1b (f32, window 16) on the card — norms and prefill
    attention through K7/K8 — against the same weights on the CPU, where
    the wrappers take their plain versions: prefill and four decode steps
    (the ring buffers wrap) give the same logits within `atol` (the f32
    tolerance of the CPU tests against the JAX package) and the same
    greedy tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    model = Model(reduced(get_config("gemma3-1b")))
    cpu = torch.device("cpu")
    params = {"cpu": model.init(seed=3, device=cpu)}
    params["gpu"] = _to(params["cpu"], dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (4, 40), dtype=np.int32))
    runs = {}
    for key, d in (("cpu", cpu), ("gpu", dev)):
        logits, cache = model.prefill(params[key], tokens.to(d),
                                      cache_len=48)
        seq = [logits.cpu()]
        tok = logits.argmax(-1).int()
        for _ in range(4):
            logits, cache = model.decode_step(params[key], cache, tok)
            seq.append(logits.cpu())
            tok = logits.argmax(-1).int()
        runs[key] = torch.stack(seq)
    err = (runs["gpu"] - runs["cpu"]).abs().max().item()
    if not (torch.isfinite(runs["gpu"]).all() and err <= atol
            and torch.equal(runs["gpu"].argmax(-1), runs["cpu"].argmax(-1))):
        fail(f"reduced gemma3-1b on the card disagrees with the CPU: "
             f"max abs logit err {err} (tolerance {atol})")
    say(f"model: reduced gemma3-1b prefill + 4 decode steps on the card "
        f"match the CPU plain versions (max abs logit err {err})")
    return err


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 3 — the main path
# ---------------------------------------------------------------------------

def main_path(dev, card: str, profile: bool = False):
    import dataclasses

    import torch

    from repro_torch.configs import gemma3_1b
    from repro_torch.core import cdc_scan
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                         CodecPolicy, DurabilityPolicy,
                                         PipelinePolicy)
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent
    from repro_torch.state import train_state

    store_dir = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    free = shutil.disk_usage(store_dir).free
    say(f"store: {store_dir} free={free}")
    if free < MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {store_dir}; need "
             f"{int(MIN_FREE_BYTES)} for two rounds of the state")

    def policy(scan="auto", durability=None, **codec):
        return CheckpointPolicy(
            mode="incremental",
            chunking=ChunkingPolicy(scheme="cdc", chunk_size=MiB,
                                    scan_backend=scan),
            pipeline=PipelinePolicy(io_threads=8),
            durability=DurabilityPolicy(keepalive_s=60.0,
                                        **(durability or {})),
            codec=CodecPolicy(codec="raw", params_codec="byteplane-rle",
                              **codec))

    try:
        t0 = time.monotonic()
        cfg = dataclasses.replace(gemma3_1b.CONFIG, n_layers=MAIN_LAYERS)
        state = train_state(cfg, dev, seed=0)
        torch.cuda.synchronize()
        leaves = leaf_paths(state)
        nbytes = sum(t.nbytes for _, t in leaves)
        say(f"state: gemma3-1b full width, {MAIN_LAYERS} of "
            f"{gemma3_1b.CONFIG.n_layers} layers, {len(leaves)} leaves, "
            f"{nbytes} bytes, built in {time.monotonic() - t0:.3f} s")
        mgr = CheckpointManager(TieredStore(Tier("fast", store_dir / "a")),
                                policy(), device=dev)
        cdc_scan.launches = bp.launches = ent.launches = 0
        t0 = time.monotonic()
        r1 = mgr.save(state, 1)
        save1_s = time.monotonic() - t0
        say(f"save step 1: {save1_s:.3f} s, new_object_bytes="
            f"{r1['new_object_bytes']} chunks={r1['chunks']}")
        changed = changed_bytes = 0
        for i, (name, t) in enumerate(leaves):
            if i % 10 != 3 and name != "step":
                continue
            if t.dtype.is_floating_point:
                t.add_(1e-3)
            else:
                bits(t).add_(1)
            changed += 1
            changed_bytes += t.nbytes
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with DeviceProfile(profile) as prof2:
            mgr.save(state, 2, blocking=False)
            mgr.wait()
        save2_s = time.monotonic() - t0
        r2 = mgr.last_report
        launches = {"gear_scan": cdc_scan.launches,
                    "byteplane_fwd": bp.launches,
                    "rle_emit": ent.launches}
        say(f"save step 2 (async, {changed} leaves / {changed_bytes} bytes "
            f"changed): {save2_s:.3f} s, new_object_bytes="
            f"{r2['new_object_bytes']}; launches {launches}")
        for k, v in launches.items():
            if v <= 0:
                fail(f"kernel {k} was not launched on the main path")
        if not r2["new_object_bytes"] < 0.5 * r1["new_object_bytes"]:
            fail("step 2 did not dedup against step 1")
        t0 = time.monotonic()
        with DeviceProfile(profile) as prof_r:
            restored, _ = mgr.restore(state, step=2)
            torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        _assert_state(restored, leaves, dev, "restore")
        say(f"restore step 2 onto {dev}: {restore_s:.3f} s, all "
            f"{len(leaves)} leaves bit-exact")
        del restored
        stream_stats = streaming_restore(mgr, state, leaves, dev)
        say(f"restore_streaming step 2 onto {dev}: frontier "
            f"{stream_stats['frontier_s']:.3f} s "
            f"({len(stream_stats['frontier'])} leaves), whole "
            f"{stream_stats['whole_s']:.3f} s, blocking restore "
            f"{restore_s:.3f} s; K4 launches "
            f"{stream_stats['k4_launches']}")
        # the host oracle re-encodes one leaf of each device route (a bf16
        # params leaf through K2+K1+K3, its f32 moment through the
        # segmented K1 scan; each spans several scan segments): same chunk
        # digests. params/embed's chunking is held against the plain
        # versions in the kernel table.
        m2 = mgr.load_manifest(2)["leaves"]
        sub_names = ("params/stage_0/b0/mlp/wg", "opt/m/stage_0/b0/mlp/wg")

        def wg(tree):
            return {"stage_0": {"b0": {"mlp": {
                "wg": tree["stage_0"]["b0"]["mlp"]["wg"]}}}}

        sub = {"params": wg(state["params"]),
               "opt": {"m": wg(state["opt"]["m"])}}
        oracle = CheckpointManager(
            TieredStore(Tier("fast", store_dir / "oracle")),
            policy(scan="numpy", device_precondition=False), device=dev)
        t0 = time.monotonic()
        oracle.save(sub, 2)
        oracle_s = time.monotonic() - t0
        mo = oracle.load_manifest(2)["leaves"]
        for name in sub_names:
            if mo[name]["shards"] != m2[name]["shards"]:
                fail(f"{name}: host-oracle chunk records differ from the "
                     "device path's")
        say(f"host oracle re-encode of {sub_names} ({oracle_s:.3f} s): "
            f"identical chunk digests ("
            + ", ".join(f"{len(m2[n]['shards'][0]['chunks'])} chunks for {n}"
                        for n in sub_names) + ")")
        oracle.close()
        mgr.close()
        fault_stats = engine_faults(sub, store_dir / "faults", policy, dev)
        stats = {"n_layers": MAIN_LAYERS,
                 "of_layers": gemma3_1b.CONFIG.n_layers,
                 "save1_s": save1_s, "save2_s": save2_s,
                 "restore_s": restore_s, "state_bytes": nbytes,
                 "save1_GBps": nbytes / save1_s / 1e9,
                 "save2_GBps": nbytes / save2_s / 1e9,
                 "restore_GBps": nbytes / restore_s / 1e9,
                 "new_object_bytes_1": r1["new_object_bytes"],
                 "new_object_bytes_2": r2["new_object_bytes"],
                 "chunks_1": r1["chunks"], "changed_leaves": changed,
                 "snapshot1_s": r1["snapshot_s"],
                 "snapshot2_s": r2["snapshot_s"],
                 "oracle_reencode_s": oracle_s,
                 "restore_streaming": stream_stats,
                 "faults": fault_stats, "profiled": profile,
                 "card": card}
        if profile:
            stats["device_save2"] = prof2.summary(save2_s)
            stats["device_restore"] = prof_r.summary(restore_s)
        return state, launches, stats
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _assert_state(got, want_leaves, dev, what: str):
    """Every leaf of `got` lies on `dev` and equals `want_leaves` (the
    ``leaf_paths`` of the saved state) bit for bit."""
    import torch

    from repro_torch.core.split_state import leaf_paths
    got = leaf_paths(got)
    if [n for n, _ in got] != [n for n, _ in want_leaves]:
        fail(f"{what}: the leaf names differ from the saved state's")
    for (name, a), (_, b) in zip(got, want_leaves):
        if not (a.device.type == dev.type and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(bits(a), bits(b))):
            fail(f"{what}: leaf {name} is not bit-exact on {dev}")


def streaming_restore(mgr, state, leaves, dev) -> dict:
    """Restore step 2 again through ``restore_streaming``: time
    ``wait_frontier()`` and then ``state()``; every leaf bit-equal to the
    saved state and on the card; the frontier the leaves of the first
    ``policy.restore.frontier_classes`` first-use classes and not every
    leaf; K4 launched."""
    from repro_torch.core.elastic import leaf_first_use_class
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    k4_before = bp.inverse_launches
    t0 = time.monotonic()
    stream, _ = mgr.restore_streaming(state, step=2)
    stream.wait_frontier()
    _sync(dev)
    frontier_s = time.monotonic() - t0
    got = stream.state()
    _sync(dev)
    whole_s = time.monotonic() - t0
    k4 = bp.inverse_launches - k4_before
    _assert_state(got, leaves, dev, "restore_streaming")
    del got
    n_classes = mgr.policy.restore.frontier_classes
    classes = sorted({leaf_first_use_class(n) for n, _ in leaves})
    want = {n for n, _ in leaves
            if leaf_first_use_class(n) in classes[:n_classes]}
    frontier = list(stream.frontier_names)
    if set(frontier) != want or len(frontier) != len(want):
        fail(f"restore_streaming: frontier {sorted(frontier)} is not the "
             f"first {n_classes} first-use classes {sorted(want)}")
    if "params/embed" not in want or not any(
            n.startswith("params/stage_0/b0/") for n in want) \
            or len(want) >= len(leaves):
        fail(f"restore_streaming: frontier {sorted(want)} is not embed "
             "and block 0")
    if k4 <= 0:
        fail("restore_streaming: K4 (byteplane_inv) was not launched")
    return {"frontier_s": frontier_s, "whole_s": whole_s,
            "frontier": frontier, "frontier_classes": n_classes,
            "leaves": len(leaves), "k4_launches": k4}


def engine_faults(sub, root: Path, policy, dev) -> dict:
    """The engine's fault paths on `sub` (one byteplane-rle params leaf and
    its f32 moment), saved through the device route (`policy()`, two
    replicas) into a fresh store under `root`, each restored onto `dev`
    bit-exact:

    1. one encoded chunk object of the params leaf zeroed: the direct
       placement's crc gate fails and the verified path reads the replica;
    2. a save of a changed `sub` dies at ``rank0_after_fused_dispatch``
       while K1-K3 run: ``gc()`` leaves ``fsck`` ok, ``latest_step()`` is
       the last good step, and the next save commits and restores;
    3. the primary object of a params chunk deleted: the restore reads the
       buddy replica."""
    import dataclasses

    from repro_torch.core import cas
    from repro_torch.core import codec as codec_mod
    from repro_torch.core.atomic import CrashInjector, CrashPoint
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.errors import AbortedError
    from repro_torch.core.split_state import leaf_paths, map_leaves
    from repro_torch.core.storage import Tier, TieredStore
    shutil.rmtree(root, ignore_errors=True)
    params_leaf = next(n for n, _ in leaf_paths(sub)
                       if n.startswith("params/"))

    # one writer rank: rank 0 writes the params leaf, so the crash point
    # rank0_after_fused_dispatch is on its path (the moment is raw)
    pol = dataclasses.replace(
        policy(durability={"replicas": 2, "max_retries": 0, "retain": 4}),
        n_writers=1)

    def mk():
        return CheckpointManager(TieredStore(Tier("fast", root)), pol,
                                 device=dev)

    def restore(mgr, step, want, what):
        t0 = time.monotonic()
        got, _ = mgr.restore(sub, step=step)
        _sync(dev)
        _assert_state(got, leaf_paths(want), dev, what)
        return time.monotonic() - t0

    def first_chunk(mgr, step):
        """The digest of the params leaf's first encoded chunk."""
        rec = mgr.load_manifest(step)["leaves"][params_leaf]["shards"][0]
        if rec["codec"] not in codec_mod.CHUNK_ENCODED:
            fail(f"faults: {params_leaf} was saved as {rec['codec']}")
        return rec["chunks"][0]

    out = {"leaf": params_leaf}
    t0 = time.monotonic()
    mgr = mk()
    mgr.save(sub, 1)
    out["save_s"] = time.monotonic() - t0
    # 1. damage one encoded chunk object of the params leaf
    obj = root / cas.object_rel(first_chunk(mgr, 1))
    good = obj.read_bytes()
    obj.write_bytes(b"\x00" * len(good))
    out["damaged_restore_s"] = restore(mgr, 1, sub, "damaged chunk")
    obj.write_bytes(good)
    mgr.close()
    # 2. a crash between the fused dispatch and chunk submission
    sub2 = map_leaves(lambda t: t.clone(), sub)
    changed = next(t for n, t in leaf_paths(sub2) if n == params_leaf)
    changed.add_(1e-3)
    _sync(dev)
    before = read_counts()
    t0 = time.monotonic()
    try:
        mk().save(sub2, 2,
                  crash=CrashInjector("rank0_after_fused_dispatch"))
        fail("faults: the save did not die at rank0_after_fused_dispatch")
    except (CrashPoint, AbortedError) as e:
        out["crash"] = type(e).__name__
    out["crashed_save_s"] = time.monotonic() - t0
    after = read_counts()
    crash_launches = {k: after[k] - before[k]
                      for k in ("gear_scan", "byteplane_fwd", "rle_emit")}
    if any(v <= 0 for v in crash_launches.values()):
        fail(f"faults: K1-K3 did not all run in the crashed save "
             f"{crash_launches}")
    out["crash_launches"] = crash_launches
    mgr = mk()
    gc_report = mgr.gc()
    fsck = mgr.chunks.fsck(mgr._live_chunk_refs())
    if not fsck["ok"]:
        fail(f"faults: fsck after the crash and gc: {fsck}")
    if mgr.latest_step() != 1:
        fail(f"faults: latest_step() {mgr.latest_step()} after the crash, "
             "not 1")
    out["gc_swept"] = gc_report["cas"]["swept"]
    out["after_crash_restore_s"] = restore(mgr, 1, sub, "after the crash")
    t0 = time.monotonic()
    mgr.save(sub2, 3)
    out["recovered_save_s"] = time.monotonic() - t0
    if mgr.latest_step() != 3:
        fail("faults: the save after the crash did not commit")
    out["recovered_restore_s"] = restore(mgr, 3, sub2, "after recovery")
    # 3. the buddy replica, the primary object deleted
    digest = first_chunk(mgr, 3)
    obj = root / cas.object_rel(digest)
    replica = root / cas.object_rel(digest, replica=1)
    if not replica.exists():
        fail(f"faults: no buddy replica {replica}")
    obj.unlink()
    out["replica_restore_s"] = restore(mgr, 3, sub2, "buddy replica")
    mgr.close()
    del sub2
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 7 — per-kernel numbers at each path's largest shapes
# ---------------------------------------------------------------------------

def k4_earlier_source():
    """The earlier K4 source, from git at ``K4_EARLIER_COMMIT``, written
    under ``build/k4_earlier/``, as (path, where it came from); None where
    the checkout has no such history."""
    rel = "src/repro_torch/csrc/byteplane_inv.cu"
    try:
        text = subprocess.run(
            ["git", "-C", str(ROOT), "show", f"{K4_EARLIER_COMMIT}:{rel}"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    if "tile_sums" not in text:
        return None
    path = ROOT / "build" / "k4_earlier" / "byteplane_inv.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path, f"git {K4_EARLIER_COMMIT}:{rel}"


def kernel_table(dev, embed, launches: dict) -> list:
    """Time each checkpoint kernel (K1-K6) and its plain version on the
    largest payload its path gives it, params/embed (603,979,776 bytes of
    bf16): K1-K3 over the save's fused dispatch, K4 over the transformed
    stream, K5 over the leaf, K6 back to bf16. `launches`: each kernel's
    count on its path (the checkpoint round's for K1-K3, the training
    phase's for K4-K6)."""
    import torch

    from repro_torch.core import cdc_scan
    from repro_torch.core.cdc import GearChunker
    from repro_torch.kernels import timing
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent
    from repro_torch.kernels.ckpt_codec import int8_codec as ic

    ck = GearChunker(MiB, device=dev)          # the main path's masks
    ms, ml = int(ck.mask_strict), int(ck.mask_loose)
    raw = embed.reshape(-1).view(torch.uint8)
    n = raw.numel()
    t = bp.forward_planes(raw, 2)
    d2 = t.view(2, n // 2)
    padded = torch.zeros(cdc_scan.padded_len(n), dtype=torch.uint8,
                         device=dev)
    padded[cdc_scan.WINDOW:cdc_scan.WINDOW + n] = t
    nb = -(-n // ent.B)
    blk = torch.zeros(nb * ent.B, dtype=torch.uint8, device=dev)
    blk[:n] = t
    blk = blk.view(nb, ent.B)
    flat = embed.reshape(-1)
    ne = flat.numel()
    q, sc = ic.quantize_blocks(flat)
    nq = sc.numel()
    # K6 as one PyTorch call: int8 × f32 in f32, cast to the output dtype
    # on the store; held bit for bit against K6 at both output dtypes
    q2, sc2 = q.view(nq, ic.BLOCK), sc.view(nq, 1)
    k6_out = {dt: torch.empty(nq, ic.BLOCK, dtype=dt, device=dev)
              for dt in (torch.bfloat16, torch.float32)}

    def k6_library(dt=torch.bfloat16):
        return torch.mul(q2, sc2, out=k6_out[dt])

    for dt in k6_out:
        if not torch.equal(bits(k6_library(dt).reshape(-1)[:ne]),
                           bits(ic.dequantize_blocks(q, sc, ne, dt))):
            fail(f"torch.mul(q, scales[:, None], out={dt}) is not bit-equal "
                 "to K6 at params/embed")
    rows = []
    # name, source, replaces, kernel, plain, bytes moved, shape,
    # library call (or None) and what it is
    specs = [
        ("gear_scan", "src/repro_torch/csrc/gear_scan.cu",
         "src/repro/core/cdc_scan.py:301",
         lambda: cdc_scan.gear_scan(padded, ms, ml),
         lambda: cdc_scan.gear_scan_plain(padded, ms, ml),
         2 * padded.numel(), list(padded.shape), None, None),
        ("byteplane_fwd", "src/repro_torch/csrc/byteplane_fwd.cu",
         "src/repro/kernels/ckpt_codec/byteplane.py:101",
         lambda: bp.forward_planes(raw, 2),
         lambda: bp.forward_plain(raw, 2), 2 * n, [n], None, None),
        ("rle_emit", "src/repro_torch/csrc/rle_emit.cu",
         "src/repro/kernels/ckpt_codec/entropy.py:88",
         lambda: ent.rle_emission(blk, n),
         lambda: ent.rle_emission_plain(blk, n), 3 * blk.numel(),
         list(blk.shape), None, None),
        ("byteplane_inv", "src/repro_torch/csrc/byteplane_inv.cu",
         "src/repro/kernels/ckpt_codec/byteplane.py:127",
         lambda: bp.inverse_planes(t, 2), lambda: bp.inverse_plain(t, 2),
         2 * n, [n],
         lambda: torch.cumsum(d2, dim=1, dtype=torch.uint8).t().contiguous(),
         "torch.cumsum(d, dim=1, dtype=torch.uint8) + transpose"),
        ("quantize_blocks", "src/repro_torch/csrc/int8_codec.cu",
         "src/repro/kernels/ckpt_codec/kernel.py:32",
         lambda: ic.quantize_blocks(flat), lambda: ic.quantize_plain(flat),
         2 * ne + nq * ic.BLOCK + 4 * nq, [ne], None, None),
        ("dequantize_blocks", "src/repro_torch/csrc/int8_codec.cu",
         "src/repro/kernels/ckpt_codec/kernel.py:64",
         lambda: ic.dequantize_blocks(q, sc, ne, torch.bfloat16),
         lambda: ic.dequantize_plain(q, sc, ne, torch.bfloat16),
         nq * ic.BLOCK + 4 * nq + 2 * ne, [ne], k6_library,
         "torch.mul(q, scales[:, None], out=<bf16>); bit-equal to K6 "
         "for bf16 and f32 outputs"),
    ]
    for name, src, replaces, kern, plain, moved, shape, lib, lib_what \
            in specs:
        a, b = kern(), plain()
        if not isinstance(a, tuple):
            a, b = (a,), (b,)
        err = max(max_abs_err(bits(x), bits(y)) for x, y in zip(a, b))
        if err:
            fail(f"{name} disagrees with its plain version at params/embed "
                 f"(max abs err {err})")
        del a, b
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": time_ms(kern, iters=10),
               "plain_ms": time_ms(plain, iters=2),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": time_ms(lib, iters=10) if lib else None,
               "shape": shape, "dtype": "bfloat16"}
        if lib_what:
            row["library_call"] = lib_what
        rows.append(row)
        torch.cuda.empty_cache()
    if not torch.equal(bp.inverse_planes(t, 2), raw):
        fail("K4 does not invert K2 at params/embed")
    k4 = next(r for r in rows if r["name"] == "byteplane_inv")
    k4["bound_share"] = k4["bound_ms"] / k4["ms"]
    found = k4_earlier_source()
    if found is None:
        k4["earlier_ms"] = None
        k4["earlier_from"] = (f"not timed: no git history at "
                              f"{K4_EARLIER_COMMIT} in this checkout")
    else:
        earlier = timing.byteplane_inv_launcher(timing.load_variant(
            "byteplane_inv", found[0], ROOT / "build" / "k4_earlier"))
        out = torch.empty_like(t)
        if not torch.equal(earlier(t, out, 2), raw):
            fail(f"the earlier K4 ({found[1]}) does not invert K2 at "
                 "params/embed")

        def kern():
            return bp.inverse_planes(t, 2)

        turns = [time_ms(lambda: earlier(t, out, 2), iters=10),
                 time_ms(kern, iters=10), time_ms(kern, iters=10),
                 time_ms(lambda: earlier(t, out, 2), iters=10)]
        k4["earlier_ms"] = (turns[0] + turns[3]) / 2
        k4["earlier_turns"] = turns     # earlier, K4, K4, earlier
        k4["earlier_from"] = f"timed in this run: {found[1]}"
        del out
    return rows


# ---------------------------------------------------------------------------
# phase 4 — the serving path
# ---------------------------------------------------------------------------

SERVE = dict(full_config=True, n_requests=8, prompt_len=2048, gen_len=64,
             ckpt_every=0, seed=0)
PREEMPT_AT = 32


def serving(dev, card: str, profile: bool = False):
    """Serve full-width gemma3-1b uninterrupted, then preempted at token 32
    and resumed; the tokens must match and K7/K8 must have launched.
    `profile` traces the uninterrupted run (device and host)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.launch import serve

    root = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    vocab = get_config("gemma3-1b").vocab_size
    try:
        rn.launches = fa.launches = 0
        t0 = time.monotonic()
        with DeviceProfile(profile, host=True) as prof:
            full = serve.run("gemma3-1b", workdir=str(root / "full"),
                             device=dev, **SERVE)
        full_s = time.monotonic() - t0
        per_run = {"rmsnorm": rn.launches, "flash_attention": fa.launches}
        pre = serve.run("gemma3-1b", workdir=str(root / "pre"),
                        preempt_at=PREEMPT_AT, device=dev, **SERVE)
        res = serve.run("gemma3-1b", workdir=str(root / "pre"),
                        device=dev, **SERVE)
        launches = {"rmsnorm": rn.launches,
                    "flash_attention": fa.launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        # the serving store's fast tier (core.storage.default_store: a
        # burst buffer in /dev/shm, per process)
        shutil.rmtree(Path("/dev/shm") / f"repro-bb-{os.getpid()}",
                      ignore_errors=True)
    say(f"serving: launches {launches} (uninterrupted run alone: "
        f"{per_run})")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    toks = full["tokens"]
    if not (full["status"] == res["status"] == "completed"
            and pre["status"] == "preempted"
            and toks.shape == (SERVE["n_requests"], SERVE["gen_len"])
            and ((toks >= 0) & (toks < vocab)).all()):
        fail(f"serving runs ended {full['status']}/{pre['status']}/"
             f"{res['status']} or gave tokens out of range")
    if not np.array_equal(pre["tokens"][:, :PREEMPT_AT],
                          toks[:, :PREEMPT_AT]):
        fail("the preempted run's tokens differ before the preemption")
    if not np.array_equal(res["tokens"], toks):
        fail("the resumed run's tokens differ from the uninterrupted run's")
    stats = {"arch": "gemma3-1b", "n_requests": SERVE["n_requests"],
             "prompt_len": SERVE["prompt_len"],
             "gen_len": SERVE["gen_len"], "preempt_at": PREEMPT_AT,
             "prefill_s": full["prefill_s"],
             "decode_tok_per_s": full["tok_per_s"],
             "decode_s": full["decode_s"], "uninterrupted_s": full_s,
             "save_s": pre["save_s"], "save_bytes": pre["save_bytes"],
             "restore_s": res["restore_s"],
             "resumed_decode_tok_per_s": res["tok_per_s"],
             "token_exact": True, "launches": launches,
             "launches_uninterrupted": per_run, "profiled": profile,
             "card": card}
    if profile:
        stats["device_uninterrupted"] = prof.summary(full_s)
    say(f"serving: prefill {stats['prefill_s']:.3f} s, decode "
        f"{stats['decode_tok_per_s']:.1f} tok/s, preempt save "
        f"{stats['save_s']:.3f} s / {stats['save_bytes']} bytes, restore "
        f"{stats['restore_s']:.3f} s; resumed tokens identical")
    return stats, launches


# K8's timed shapes: (B, S, H, K, D, window[, causal]), causal unless
# said: the serving prefill's global and local layers and the training
# step's
K8_SHAPES = {"serve": (8, 2048, 4, 1, 256, 0),
             "serve_window512": (8, 2048, 4, 1, 256, 512),
             "train": (4, 1024, 4, 1, 256, 0),
             "train_window512": (4, 1024, 4, 1, 256, 512)}


def k8_shapes(dev, g, shapes: dict | None = None) -> dict:
    """K8 (bf16) at each entry of `shapes` (default ``K8_SHAPES``):
    CUDA-event ms at the launcher's choice of block_q and at each forced
    one, the bound from the unmasked pairs' flops (and the bytes: q, k, v
    read, out written once), the achieved TFLOP/s, and the library call's
    ms (``F.scaled_dot_product_attention``: ``is_causal``, no mask without
    causality, or a band mask for the window)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    bf = torch.bfloat16
    out = {}
    for name, (B, S, H, K, D, window, *c) in (shapes or K8_SHAPES).items():
        causal = c[0] if c else True
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(bf)
        k = torch.randn((B, S, K, D), generator=g, device=dev).to(bf)
        v = torch.randn((B, S, K, D), generator=g, device=dev).to(bf)
        flops = 4 * D * B * H * fa.unmasked_pairs(S, S, causal, window)
        moved = (2 * q.numel() + k.numel() + v.numel()) * 2
        by_ops = flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                window=window),
                     iters=20, warmup=2)
        by_bq = {str(bq): time_ms(
            lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                       block_q=bq), iters=20, warmup=2)
            for bq in fa.BLOCK_QS}
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        if window:
            band = fa._mask(S, S, causal, window, dev)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True), iters=20,
                warmup=2)
        else:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20,
                warmup=2)
        out[name] = {
            "shape": [B, S, H, K, D], "window": window, "causal": causal,
            "kernel_dim": fa.kernel_dim(D), "ms": ms,
            "ms_by_block_q": by_bq, "library_ms": lib,
            "bound_ms": max(flops / BF16_FLOPS,
                            moved / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if by_ops else "bytes",
            "flops": flops, "tflops": flops / (ms * 1e-3) / 1e12}
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def k8_ptxas() -> dict:
    """Registers a thread and spill bytes of each D = 256 instantiation of
    the bf16 kernel, from the ptxas report that the build keeps beside the
    library (with block_q 128, ``setmaxnreg`` then moves the consumers to
    240 registers and the producer to 24)."""
    import re

    from repro_torch.kernels import build
    log = build.ptxas_log("flash_attention")
    text = log.read_text() if log.exists() else ""
    out = {}
    for m in re.finditer(
            r"Compiling entry function '[^']*flash_wgmma_kernelILi(\d+)"
            r"ELi(\d)ELb([01])E[^']*'.*?(\d+) bytes stack frame, (\d+) "
            r"bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) "
            r"registers", text, flags=re.S):
        d, nwg, cap, stack, st, ld, regs = (int(x) for x in m.groups())
        if d == 256:
            out[f"block_q{64 * nwg}{'_softcap' if cap else ''}"] = {
                "registers": regs, "spill_bytes": st + ld,
                "stack_bytes": stack}
    return out



# K7's timed shapes, bf16: (rows, D) of gemma3-1b's norms (a prefill of
# 8 × 2048 tokens, a training forward of 4 × 1024, a decode step of 8
# sequences: the block norms, the q norms of 4 heads, the k norms of one)
K7_SHAPES = {"prefill_block": (16_384, 1152), "prefill_q": (65_536, 256),
             "prefill_k": (16_384, 256), "train_block": (4096, 1152),
             "train_q": (16_384, 256), "train_k": (4096, 256),
             "decode_block": (8, 1152), "decode_q": (32, 256),
             "decode_k": (8, 256)}
L2_BYTES = 50e6                    # H100 L2


def cold_iters(n: int, d: int, itemsize: int = 2) -> int:
    """Calls of a norm of (n, d) to time in one graph: 200 at the decode
    shapes (launch-bound); otherwise enough that the calls move 40 times
    the L2, so that the outputs still in the L2 when the graph ends (at
    most its size) are under 5% of the bytes written."""
    if n < 1024:
        return 200
    return max(20, math.ceil(40 * L2_BYTES / (2 * n * d * itemsize)))


def rotating_inputs(dev, g, n: int, d: int, dtype=None) -> list:
    """Input sets of (n, d) for timing with the L2 cold: enough sets that
    the inputs span four times the L2 (views of one tensor), each read
    again only after the others."""
    import torch
    dtype = dtype or torch.bfloat16
    per = n * d * torch.tensor([], dtype=dtype).element_size()
    sets = max(3, math.ceil(4 * L2_BYTES / per))
    big = torch.randn((sets * n, d), generator=g, device=dev).to(dtype)
    return [big[i * n:(i + 1) * n] for i in range(sets)]


def time_cold_ms(fn, sets: list, iters: int) -> float:
    """Mean CUDA-event ms of ``fn(x)`` over `iters` eager calls, x rotating
    over `sets` (the last set warms up): host launch cost included."""
    import torch
    fn(sets[-1])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    k = len(sets) - 1
    start.record()
    for i in range(iters):
        fn(sets[i % k])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, sets: list, iters: int) -> float:
    """Device ms a call of ``fn(x)`` inside one CUDA graph of `iters` calls,
    x rotating over `sets` and each call writing an output of its own (all
    kept alive through the capture, so that the graph's pool gives no two
    calls one buffer): the L2 cold for inputs and outputs, no host launch
    cost between calls; the median of five replays."""
    import torch
    fn(sets[-1])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    k = len(sets) - 1
    with torch.cuda.graph(graph):
        outs = [fn(sets[i % k]) for i in range(iters)]
    del outs
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[2]


def k7_shapes(dev, g, kernels: dict | None = None,
              plain: bool = True, shapes: dict | None = None) -> dict:
    """K7 (bf16) at each entry of `shapes` (default ``K7_SHAPES``), the L2
    cold, device ms a call
    inside a CUDA graph: the launcher's plan (``ms``), each function of
    `kernels` (name → fn(x, scale); default: each route forced where it
    runs), the plain version, the library call (``F.rms_norm`` with weight
    1 + scale) and a copy of x (``clone``: the same bytes read and
    written); the bound from the bytes at the data sheet's rate; and at
    the decode shapes the eager ms a call of K7 and of the library call as
    well (host launch cost included: what the decode step pays)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn
    bf = torch.bfloat16
    if kernels is None:
        kernels = {r: (lambda x, s, r=r: rn.rmsnorm_fused(x, s, route=r))
                   for r in ("stream", "warp")}
    out = {}
    for name, (n, d) in (shapes or K7_SHAPES).items():
        sets = rotating_inputs(dev, g, n, d)
        sc = (torch.randn((d,), generator=g, device=dev) * 0.1).to(bf)
        w = 1.0 + sc
        iters = cold_iters(n, d)
        lib = (lambda x: F.rms_norm(x, (d,), weight=w, eps=rn.EPS))
        row = {"rows": n, "d": d,
               "route": rn.launch_plan(n, d, 2, True,
                                       sms=rn._sms(dev)).route,
               "bound_ms": (2 * n * d + d) * 2 / HBM_BYTES_PER_S * 1e3,
               "ms": time_graph_ms(lambda x: rn.rmsnorm_fused(x, sc), sets,
                                   iters),
               "library_ms": time_graph_ms(lib, sets, iters),
               "copy_ms": time_graph_ms(lambda x: x.clone(), sets, iters)}
        if plain:
            row["plain_ms"] = time_graph_ms(
                lambda x: rn.rmsnorm_plain(x, sc), sets, max(iters // 5, 10))
        row["ms_by"] = {k: time_graph_ms(lambda x, f=f: f(x, sc), sets,
                                         iters)
                        for k, f in kernels.items()}
        if n < 1024:
            row["call_ms"] = time_cold_ms(lambda x: rn.rmsnorm_fused(x, sc),
                                          sets, iters)
            row["library_call_ms"] = time_cold_ms(lib, sets, iters)
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        out[name] = row
        del sets
    torch.cuda.empty_cache()
    return out


def model_kernel_table(dev, launches: dict) -> list:
    """K7 and K8 at the serving path's largest shapes (bf16): the block
    norm over the prefill's 8·2048 rows of 1152, and a global layer's
    causal attention (B 8, S 2048, H 4, K 1, D 256); K7 also at the other
    ``K7_SHAPES`` (``k7_shapes``), K8 at the other ``K8_SHAPES``
    (``k8_shapes``) and with its ptxas counts."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bf = torch.bfloat16
    rows = []
    # K7: the serving prefill's block norm is the row's main shape; the
    # other path shapes add keys of their own (``k7_shapes``)
    n, d = K7_SHAPES["prefill_block"]
    x = torch.randn((n, d), generator=g, device=dev).to(bf)
    sc = (torch.randn((d,), generator=g, device=dev) * 0.1).to(bf)
    err = (rn.rmsnorm_fused(x, sc).float()
           - rn.rmsnorm_plain(x, sc).float()).abs().max().item()
    del x
    k7 = k7_shapes(dev, g)
    main = k7["prefill_block"]
    rows.append({
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:24",
        "launches": launches["rmsnorm"], "max_abs_err": err,
        "tolerance": RMS_TOL["bfloat16"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": main["library_ms"],
        "shape": [n, d], "dtype": "bfloat16",
        "launches_train": launches.get("rmsnorm_train"), "shapes": k7})
    # K8: the serving prefill's causal (global) layer is the row's main
    # shape; the other path shapes add keys of their own
    B, S, H, K, D = K8_SHAPES["serve"][:5]
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, K, D), generator=g, device=dev).to(bf)
    v = torch.randn((B, S, K, D), generator=g, device=dev).to(bf)
    err = (fa.flash_attention(q, k, v, causal=True).float()
           - fa.flash_attention_plain(q, k, v, causal=True).float()) \
        .abs().max().item()
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                       iters=3)
    del q, k, v
    shapes = k8_shapes(dev, g)
    serve = shapes["serve"]
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "tolerance": ATTN_TOL["bfloat16"],
        "ms": serve["ms"], "plain_ms": plain_ms,
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "shape": [B, S, H, K, D], "dtype": "bfloat16", "causal": True,
        "window": 0, "flops": serve["flops"]}
    for name, suffix in (("serve_window512", "_window512"),
                         ("train", "_train"),
                         ("train_window512", "_train_window512")):
        for key in ("ms", "library_ms", "bound_ms"):
            row[key + suffix] = shapes[name][key]
    for name, suffix in (("serve", ""), ("serve_window512", "_window512"),
                         ("train", "_train"),
                         ("train_window512", "_train_window512")):
        row["tflops" + suffix] = shapes[name]["tflops"]
    row["ms_by_block_q"] = {n: sh["ms_by_block_q"] for n, sh in shapes.items()}
    row["ptxas"] = k8_ptxas()
    rows.append(row)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5 — the training path
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq_len=1024, seed=0)
TRAIN_STEPS = 4
PREEMPT_AFTER = 3
# gemma3-1b's layers in the training phase, of 26: one period of its
# five-local, one-global attention pattern
TRAIN_LAYERS = 6


def _counters():
    from repro_torch.core import cdc_scan
    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent
    from repro_torch.kernels.ckpt_codec import int8_codec as ic
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    # kernel → (module, counter attribute)
    return {"gear_scan": (cdc_scan, "launches"),
            "byteplane_fwd": (bp, "launches"),
            "rle_emit": (ent, "launches"),
            "byteplane_inv": (bp, "inverse_launches"),
            "quantize_blocks": (ic, "quantize_launches"),
            "dequantize_blocks": (ic, "dequantize_launches"),
            "rmsnorm": (rn, "launches"),
            "flash_attention": (fa, "launches")}


def reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def _record_rounds(manager, into: list):
    """Keep each checkpoint round's report (the trainer's async saves
    report their persist time only when the round lands)."""
    inner = manager._write_round

    def write_round(*a, **kw):
        rep = inner(*a, **kw)
        into.append({k: rep.get(k) for k in (
            "step", "seconds", "blocking_s", "snapshot_s", "overlapped",
            "bytes", "new_object_bytes", "chunks")})
        return rep

    manager._write_round = write_round


# the checkpoint round's policy, as TrainerConfig fields, for run B of the
# training and zoo phases; retain 1 bounds the disk to two rounds
TRAIN_CKPT = dict(ckpt_mode="incremental", chunking="cdc", chunk_size=MiB,
                  codec="raw", params_codec="byteplane-rle", io_threads=8,
                  async_ckpt=True, ckpt_every=2, retain=1)
HISTORY_KEYS = ("loss", "nll", "drop_fraction", "load_balance_loss",
                "router_z_loss", "step_s", "grad_norm")


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def preempt_resume(cfg, root: Path, dev, profile: bool = False,
                   on_saved=None, on_restored=None, next_steps: int = 0):
    """Run A (``TRAIN_STEPS`` steps, no checkpoint), run B (``TRAIN_CKPT``
    saving every ``TRAIN_STEPS`` steps: its checkpoints are the blocking
    one at the preemption after step ``PREEMPT_AFTER`` and the overlapped
    one at step ``TRAIN_STEPS``) and its resume to step ``TRAIN_STEPS``
    (K4 decodes every params leaf), each in a workdir under
    `root`. Fails unless run B's losses, the resumed losses and the resumed
    ``params_digest`` equal run A's. ``on_saved(trainer)`` sees run B at
    the preemption; ``on_restored(trainer)`` sees the restored state before
    the resumed step, its time left out of ``restore_to_first_step_s``.
    With `next_steps`, run A takes that many more steps after its digest
    (``stats["next"]``: their loss and grad_norm), the steps that follow
    the resumed run's last checkpoint.
    Launches are read per segment, each counted from 0: ``steps`` (run A's
    steps), ``saves`` (run B's steps and saves), ``restore`` and
    ``resumed`` (the resumed step and its save). With `profile`, step 3 of
    run A (host and device), the preempt save and the restore are traced.
    Returns (stats, launches, the resumed state)."""
    import torch

    from repro_torch.core.preempt import PreemptionGuard
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.train.loop import Trainer, TrainerConfig

    def store(name):
        return TieredStore(Tier("fast", root / name))

    stats, launches = {}, {}
    # ---- run A: uninterrupted -----------------------------------------
    CURRENT_PHASE[1] = "run_a"
    torch.cuda.reset_peak_memory_stats(dev)
    tA = Trainer(cfg, TrainerConfig(workdir=str(root / "a"), log_every=1,
                                    ckpt_every=0, **TRAIN),
                 store=store("a"), device=dev)
    t0 = time.monotonic()
    tA.init_or_restore()
    torch.cuda.synchronize()
    stats["init_s"] = time.monotonic() - t0
    stats["state_bytes"] = sum(t.nbytes for _, t in leaf_paths(tA.state))
    stats["params"] = sum(t.numel() for _, t in
                          leaf_paths(tA.state["params"]))
    reset_counts()
    # stop_after leaves the run "paused": no end-of-run save
    tA.fit(TRAIN_STEPS, stop_after=2)
    with DeviceProfile(profile, host=True) as prof:
        t0 = time.monotonic()
        tA.fit(TRAIN_STEPS, stop_after=1)
        prof_s = time.monotonic() - t0
    tA.fit(TRAIN_STEPS, stop_after=1)
    torch.cuda.synchronize()
    launches["steps"] = read_counts()
    stats["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    hist = tA.history
    for key in HISTORY_KEYS:
        if key in hist[0]:
            stats[key] = [h[key] for h in hist]
    # steps after the first (which includes first-call set-up)
    stats["tokens_per_s"] = TRAIN["batch"] * TRAIN["seq_len"] * \
        (TRAIN_STEPS - 1) / sum(stats["step_s"][1:])
    if profile:
        stats["device_step"] = prof.summary(prof_s)
    digest_a = tA.params_digest()
    if next_steps:
        tA.fit(TRAIN_STEPS + next_steps, stop_after=next_steps)
        stats["next"] = [{k: h[k] for k in ("step", "loss", "grad_norm")}
                         for h in tA.history[TRAIN_STEPS:]]
    tA.manager.close()
    del tA
    torch.cuda.empty_cache()
    say(f"{cfg.arch_id} A: {TRAIN_STEPS} steps, loss {stats['loss']}, "
        f"step s {stats['step_s']}, peak {stats['peak_device_bytes']} "
        f"bytes, state {stats['state_bytes']} bytes, digest "
        f"{digest_a[:16]}")
    if not all(math.isfinite(x) for x in stats["loss"]):
        fail(f"{cfg.arch_id} training loss is not finite: {stats['loss']}")
    # ---- run B: preempted after step 3 --------------------------------
    CURRENT_PHASE[1] = "run_b"
    tcfg_b = TrainerConfig(workdir=str(root / "b"), log_every=1, **TRAIN,
                           **{**TRAIN_CKPT, "ckpt_every": TRAIN_STEPS})
    tB = Trainer(cfg, tcfg_b, store=store("b"), device=dev)
    rounds: list = []
    _record_rounds(tB.manager, rounds)
    tB.init_or_restore()
    reset_counts()
    with PreemptionGuard() as guard:
        tB.fit(TRAIN_STEPS, guard=guard, stop_after=PREEMPT_AFTER)
        guard.request()
        with DeviceProfile(profile) as prof_save:
            t0 = time.monotonic()
            rep = tB.fit(TRAIN_STEPS, guard=guard)
            stats["preempt_exit_s"] = time.monotonic() - t0
    launches["saves"] = read_counts()
    if profile:
        stats["device_preempt_save"] = prof_save.summary(
            stats["preempt_exit_s"])
    if rep["status"] != "preempted" or rep["step"] != PREEMPT_AFTER \
            or tB.manager.latest_step() != PREEMPT_AFTER:
        fail(f"{cfg.arch_id} run B ended {rep['status']} at step "
             f"{rep['step']} (latest checkpoint {tB.manager.latest_step()})")
    if [h["loss"] for h in tB.history] != stats["loss"][:PREEMPT_AFTER]:
        fail(f"{cfg.arch_id} run B's losses differ from run A's before the "
             "preemption")
    if on_saved is not None:
        on_saved(tB)
    tB.manager.close()
    del tB
    torch.cuda.empty_cache()
    # ---- resume: K4 decodes every params leaf on restore --------------
    CURRENT_PHASE[1] = "restore"
    tC = Trainer(cfg, tcfg_b, store=store("b"), device=dev)
    _record_rounds(tC.manager, rounds)
    ends: list = []
    inner = tC.step_fn

    def timed_step(state, batch):
        out = inner(state, batch)
        torch.cuda.synchronize()
        ends.append(time.monotonic())
        return out

    tC.step_fn = timed_step
    reset_counts()
    with DeviceProfile(profile) as prof_r:
        t0 = time.monotonic()
        tC.init_or_restore()
        torch.cuda.synchronize()
        stats["restore_s"] = time.monotonic() - t0
    launches["restore"] = read_counts()
    if profile:
        stats["device_restore"] = prof_r.summary(stats["restore_s"])
    k4 = launches["restore"]["byteplane_inv"]
    n_params = len(leaf_paths(tC.state["params"]))
    if tC.restored_from != PREEMPT_AFTER or k4 < n_params:
        fail(f"{cfg.arch_id} resume restored step {tC.restored_from} with "
             f"{k4} K4 launches for {n_params} params leaves")
    check_s = 0.0
    if on_restored is not None:
        t1 = time.monotonic()
        on_restored(tC)
        check_s = time.monotonic() - t1
    reset_counts()
    CURRENT_PHASE[1] = "resumed"
    out = tC.fit(TRAIN_STEPS)
    launches["resumed"] = read_counts()
    CURRENT_PHASE[1] = ""
    stats["restore_to_first_step_s"] = ends[0] - t0 - check_s
    stats["resumed_loss"] = [h["loss"] for h in tC.history]
    digest_c = tC.params_digest()
    if out["status"] != "completed" or digest_c != digest_a:
        fail(f"{cfg.arch_id}: the resumed run's params_digest "
             f"{digest_c[:16]} != the uninterrupted run's {digest_a[:16]} "
             f"({out['status']})")
    if stats["resumed_loss"] != stats["loss"][PREEMPT_AFTER:]:
        fail(f"{cfg.arch_id}: the resumed step's loss differs from run A's")
    stats["saves"] = rounds
    stats["restore_k4_launches"] = k4
    say(f"{cfg.arch_id} B/resume: preempted at step {PREEMPT_AFTER}, "
        f"restored in {stats['restore_s']:.3f} s ({k4} K4 launches), first "
        f"resumed step done {stats['restore_to_first_step_s']:.3f} s after "
        f"the restore began; params_digest identical; saves "
        f"{json.dumps(rounds)}")
    tC.manager.close()
    state = tC.state
    del tC
    return stats, launches, state


def training(dev, card: str, profile: bool = False):
    """``preempt_resume`` of gemma3-1b (``TRAIN_LAYERS`` of 26 layers) with
    AdamW; then the int8 routes. Returns (stats, launches over the
    phase)."""
    import dataclasses

    import torch

    from repro_torch.configs import gemma3_1b
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                         CodecPolicy, DurabilityPolicy,
                                         PipelinePolicy)
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore

    cfg = dataclasses.replace(gemma3_1b.CONFIG, n_layers=TRAIN_LAYERS)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # the checkpoint round's keepalive (10 GB rounds on a shared host)
    os.environ["REPRO_CKPT_KEEPALIVE_S"] = "60"

    def store(name):
        return TieredStore(Tier("fast", root / name))

    stats = {"arch": cfg.arch_id, **TRAIN, "steps": TRAIN_STEPS,
             "preempt_after": PREEMPT_AFTER, "card": card,
             "profiled": profile}
    try:
        run, segments, state = preempt_resume(cfg, root, dev, profile)
        stats.update(run)
        n_params = len(leaf_paths(state["params"]))
        shutil.rmtree(root / "b", ignore_errors=True)
        reset_counts()
        # ---- int8: K5 save route vs the host oracle, K6 restore -------
        def int8_manager(name, **codec):
            return CheckpointManager(store(name), CheckpointPolicy(
                mode="incremental",
                chunking=ChunkingPolicy(scheme="cdc", chunk_size=MiB),
                pipeline=PipelinePolicy(io_threads=8),
                durability=DurabilityPolicy(keepalive_s=60.0),
                codec=CodecPolicy(codec="raw", params_codec="int8",
                                  **codec)), device=dev)

        mgr_d = int8_manager("int8_device")
        mgr_h = int8_manager("int8_host", device_precondition=False)
        step = TRAIN_STEPS
        # the params, the leaves the int8 codec encodes: the moments would
        # go raw through both routes alike
        params = {"params": state["params"]}
        t0 = time.monotonic()
        k5_before = read_counts()["quantize_blocks"]
        rep_d = mgr_d.save(params, step)
        stats["int8_device_save_s"] = time.monotonic() - t0
        k5 = read_counts()["quantize_blocks"] - k5_before
        t0 = time.monotonic()
        rep_h = mgr_h.save(params, step)
        stats["int8_host_save_s"] = time.monotonic() - t0
        if read_counts()["quantize_blocks"] != k5_before + k5 or \
                k5 < n_params:
            fail(f"K5 launched {k5} times for {n_params} params leaves "
                 "(or the host route launched it)")
        leaves_d = mgr_d.load_manifest(step)["leaves"]
        leaves_h = mgr_h.load_manifest(step)["leaves"]
        objs = {"int8_device": mgr_d.chunks.digests_on_disk(),
                "int8_host": mgr_h.chunks.digests_on_disk()}
        if leaves_d != leaves_h or objs["int8_device"] != objs["int8_host"]:
            fail("int8 saves: the K5 route's manifest or CAS objects differ "
                 "from the host oracle's")
        abstract = params
        t0 = time.monotonic()
        k6_before = read_counts()["dequantize_blocks"]
        got, _ = mgr_d.restore(abstract, step=step, validate=False)
        torch.cuda.synchronize()
        stats["int8_device_restore_s"] = time.monotonic() - t0
        k6 = read_counts()["dequantize_blocks"] - k6_before
        ref, _ = mgr_h.restore(abstract, step=step, validate=False)
        if read_counts()["dequantize_blocks"] != k6_before + k6 or \
                k6 < n_params:
            fail(f"K6 launched {k6} times for {n_params} params leaves "
                 "(or the host route launched it)")
        for (name, a), (_, b) in zip(leaf_paths(got), leaf_paths(ref)):
            if not (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(bits(a), bits(b))):
                fail(f"int8 restore through K6 differs from the host "
                     f"decode at {name}")
        stats.update(int8_new_object_bytes=rep_d.get("new_object_bytes"),
                     int8_save_bytes=rep_d["bytes"],
                     int8_host_save_bytes=rep_h["bytes"],
                     int8_objects=len(objs["int8_device"]),
                     int8_k5_launches=k5, int8_k6_launches=k6)
        say(f"train int8: K5 route save {stats['int8_device_save_s']:.3f} s "
            f"(snapshot pins {rep_d['bytes']} bytes; host route "
            f"{rep_h['bytes']}), host route "
            f"{stats['int8_host_save_s']:.3f} s: identical manifests and "
            f"{len(objs['int8_device'])} CAS objects; K6 restore of the "
            f"params {stats['int8_device_restore_s']:.3f} s, equal to the "
            f"host decode")
        mgr_d.close()
        mgr_h.close()
        del state, params, got, ref
        segments["int8"] = read_counts()
    finally:
        os.environ.pop("REPRO_CKPT_KEEPALIVE_S", None)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    launches = _sum_counts(*segments.values())
    stats["launches"] = launches
    say(f"train: launches over the phase {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the training path")
    return stats, launches


def rans_stage_ms(dev) -> dict:
    """The byteplane-rans device entropy stage (PyTorch ops, no kernel of
    its own yet) on 64 MiB of a bf16 leaf's transformed stream."""
    import torch

    from repro_torch.kernels.ckpt_codec import byteplane as bp
    from repro_torch.kernels.ckpt_codec import entropy as ent
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w = torch.randn(32 * MiB, generator=g, device=dev).mul_(0.02) \
        .to(torch.bfloat16).view(torch.uint8)
    t = bp.forward_plain(w, 2)
    ms = time_ms(lambda: ent.encode(t, "byteplane-rans", ent.rle_emission),
                 iters=2)
    rle = time_ms(lambda: ent.encode(t, "byteplane-rle", ent.rle_emission),
                  iters=2)
    return {"bytes": t.numel(), "rans_encode_ms": ms,
            "rle_encode_ms": rle}


# ---------------------------------------------------------------------------
# phase 6 — the reliability plane
# ---------------------------------------------------------------------------

PUBLISH_SEED = 99          # the published params (the served ones: seed 0)
CHANGE_EVERY = 10          # round 1 changes every 10th params leaf
DELTA_SLACK = MiB          # delta-sync bytes allowed past the changed chunks


def _sites(fired) -> dict:
    """{(op, tier, kind): firings} of a ``FaultPlane.fired()`` log."""
    out: dict = {}
    for op, tier, _rel, kind, _key in fired:
        out[(op, tier, kind)] = out.get((op, tier, kind), 0) + 1
    return out


def _retries(store) -> int:
    return sum(v for snap in store.health_report().values()
               for k, v in snap.get("counters", {}).items()
               if k.endswith("_retries"))


def _inspect_rc(root) -> tuple:
    """``python -m repro_torch.launch.inspect_ckpt ROOT --verify --json``
    in-process: (exit code, report, seconds)."""
    import contextlib
    import io

    from repro_torch.launch import inspect_ckpt
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = inspect_ckpt.main([str(root), "--verify", "--json"])
    return rc, json.loads(buf.getvalue()), time.monotonic() - t0


def reliability(dev, card: str, serve_tok_per_s=None):
    """The reliability plane on the publisher → subscriber path, at full
    gemma3-1b width (``RELIABILITY_LAYERS`` of 26 layers): a
    ``WeightPublisher`` on a ``CheckpointManager``
    (the checkpoint round's policy, retain 1) over a fast/slow store
    wrapped in a seeded ``FaultPlane``; round 0 publishes the params with
    the fast tier full (every object fails over to the slow tier: a
    degraded commit) and latency on the slow tier; round 1 changes every
    10th leaf under a transient EIO and a silent bit-rot on two named
    fast-tier object writes (unchanged chunks re-promoted from the slow
    tier, so the slow copy stays good) and the same latency. The
    inspector finds the rot (exit 1), ``scrub`` heals it from the slow
    tier (exit 0 after), round 1 restores onto the card through K4 bit
    for bit, ``serve --weight-sync`` hot-swaps round 1 token for token
    against a direct loop, and a second subscriber's delta sync pulls only
    the changed chunks.

    The rot site relies on that re-promotion: the CAS dedup check looks
    at the fast tier only, so round 1 rewrites the unchanged chunks there.
    A dedup that also saw the slow tier would leave no such write, and the
    schedule would have to move. (The rot cannot sit on a round-0 write:
    the drain copies a fast-tier object to the slow tier unverified, so
    no good copy would be left to heal from.)

    Launches are read per segment, each with the counts set to 0 just
    before it: the publisher's saves (K1-K3), the restore (K4) and
    ``serve.run`` (K7, K8)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.faults import FaultPlane, wrap_store
    from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                         CodecPolicy, DurabilityPolicy,
                                         PipelinePolicy)
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.core.weightsync import (WeightPublisher,
                                             WeightSubscriber,
                                             assert_bitexact)
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.train.steps import make_serve_fns

    root = ROOT / "build" / "chip_smoke_reliability"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    if free < MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {root}; need "
             f"{int(MIN_FREE_BYTES)}")
    cfg = dataclasses.replace(get_config("gemma3-1b"),
                              n_layers=RELIABILITY_LAYERS)

    def params_only(n):
        return n.startswith("params/")

    stats = {"arch": cfg.arch_id, "full_width": True, "card": card,
             "n_layers": RELIABILITY_LAYERS,
             "of_layers": get_config("gemma3-1b").n_layers}
    launches = {seg: dict.fromkeys(read_counts(), 0)
                for seg in ("publish", "restore", "serve")}

    def count(seg):
        for k, v in read_counts().items():
            launches[seg][k] += v

    try:
        model = Model(cfg)
        params = model.init(seed=PUBLISH_SEED, device=dev)
        tree = {"params": params}
        leaves = leaf_paths(tree)
        stats["params_bytes"] = sum(t.nbytes for _, t in leaves)
        stats["leaves"] = len(leaves)
        plane = FaultPlane(seed=7)
        fast, slow = root / "fast", root / "slow"
        store = wrap_store(TieredStore(Tier("fast", fast),
                                       Tier("slow", slow)), plane)
        mgr = CheckpointManager(store, CheckpointPolicy(
            mode="incremental",
            chunking=ChunkingPolicy(scheme="cdc", chunk_size=MiB),
            pipeline=PipelinePolicy(io_threads=8),
            durability=DurabilityPolicy(keepalive_s=60.0, retain=1),
            codec=CodecPolicy(codec="raw", params_codec="byteplane-rle")),
            device=dev)
        WeightPublisher(mgr)
        # the subscribers read both tiers of the publisher, without faults
        delta = WeightSubscriber(
            TieredStore(Tier("fast", fast), Tier("slow", slow)),
            root / "cache-delta", name="delta", leaf_filter=params_only,
            policy=CheckpointPolicy(pipeline=PipelinePolicy(io_threads=8)))
        rounds = []

        def publish(step, schedule):
            for spec in schedule:
                plane.add(**spec)
            before = (_retries(store), mgr.chunks.degraded_writes,
                      len(plane.fired()))
            reset_counts()
            t0 = time.monotonic()
            rep = mgr.save(tree, step)
            store.wait_drained()
            seconds = time.monotonic() - t0
            count("publish")
            fired = _sites(plane.fired()[before[2]:])
            want = {(d["op"], d["tier"], d["kind"]) for d in schedule}
            if set(fired) != want or any(
                    fired[(d["op"], d["tier"], d["kind"])] != d.get("count", 1)
                    for d in schedule if d.get("count", 1) > 0):
                fail(f"round {step}: the plane fired {fired}, the "
                     f"schedule was {schedule}")
            plane.clear()
            r = {"step": step, "save_s": seconds,
                 "degraded": bool(rep.get("degraded")),
                 "retries": _retries(store) - before[0],
                 "degraded_objects": mgr.chunks.degraded_writes - before[1],
                 "new_object_bytes": rep["new_object_bytes"],
                 "chunks": rep["chunks"],
                 "fired": {"/".join(k): v for k, v in fired.items()}}
            rounds.append(r)
            say(f"reliability: round {step} {json.dumps(r)}")
            return r

        slow_latency = dict(op="write", kind="latency", tier="slow",
                            match=".obj", count=-1, latency_s=0.001)
        # ---- round 0: the fast tier is full for the whole round --------
        r0 = publish(0, [dict(op="write", kind="enospc", tier="fast",
                              match=".obj", count=-1), slow_latency])
        if not (r0["degraded"] and mgr.load_manifest(0).get("degraded")
                and r0["degraded_objects"] > 0):
            fail(f"round 0 did not commit degraded: {r0}")
        t0 = time.monotonic()
        st = delta.sync()
        full_sync_s = time.monotonic() - t0
        full_bytes = delta.counters["wire_bytes"]
        if st["state"] != "live" or st["last_flipped_step"] != 0:
            fail(f"the subscriber's full sync ended {st}")
        assert_bitexact(delta.current()[1], tree)
        full_flip_s = delta.counters["last_flip_blocking_s"]
        # ---- round 1: 10% of the leaves change; EIO and bit-rot --------
        m0 = mgr.load_manifest(0)["leaves"]
        changed = [n for i, (n, _) in enumerate(leaves)
                   if i % CHANGE_EVERY == 3]
        named = dict(leaves)
        with torch.no_grad():
            for n in changed:
                named[n].add_(1e-3)
        torch.cuda.synchronize(dev)
        # two chunks of unchanged leaves: round 1 re-promotes them from
        # the slow tier to the fast one (the dedup check is fast-only)
        kept = [d for n, rec in sorted(m0.items()) if n not in changed
                for s in rec["shards"] for d in s["chunks"]]
        eio_d, rot_d = sorted(set(kept), key=kept.index)[:2]
        r1 = publish(1, [dict(op="write", kind="eio", tier="fast",
                              match=eio_d),
                         dict(op="write", kind="bitrot", tier="fast",
                              match=rot_d), slow_latency])
        if r1["degraded"] or r1["retries"] < 1:
            fail(f"round 1: {r1}")
        stats["rounds"] = rounds
        # ---- inspect, scrub, inspect, restore --------------------------
        rc, rep, secs = _inspect_rc(fast)
        stats["inspect_before"] = {"rc": rc, "seconds": secs,
                                   "problems": len(rep["problems"]),
                                   "first_problem": rep["problems"][:1]}
        say(f"reliability: inspector before the scrub rc {rc} in "
            f"{secs:.3f} s: {len(rep['problems'])} problem(s), first "
            f"{rep['problems'][:1]}")
        if rc != 1 or not any(rot_d in p or "unreadable" in p
                              for p in rep["problems"]):
            fail("the inspector did not find the rotten object")
        t0 = time.monotonic()
        srep = mgr.scrub()["scrub"]
        stats["scrub"] = dict(srep, seconds=time.monotonic() - t0)
        if srep["healed"] < 1 or srep["unrecoverable"]:
            fail(f"the scrub did not heal the rot: {srep}")
        rc, rep, secs = _inspect_rc(fast)
        stats["inspect_after"] = {"rc": rc, "seconds": secs,
                                  "problems": len(rep["problems"])}
        if rc != 0:
            fail(f"the inspector after the scrub: rc {rc} {rep['problems']}")
        reset_counts()
        t0 = time.monotonic()
        got, _ = mgr.restore(tree, step=1)
        torch.cuda.synchronize(dev)
        stats["restore_s"] = time.monotonic() - t0
        count("restore")
        assert_bitexact(dict(leaf_paths(got)), tree)
        del got
        # ---- serve --weight-sync: round 1 hot-swapped before decoding --
        reset_counts()
        t0 = time.monotonic()
        res = serve.run("gemma3-1b", workdir=str(root / "serve"),
                        weight_sync=str(fast), device=dev,
                        n_layers=RELIABILITY_LAYERS, **SERVE)
        serve_s = time.monotonic() - t0
        count("serve")
        if res.get("weight_sync_step") != 1:
            fail(f"serve --weight-sync flipped {res.get('weight_sync_step')}"
                 ", not round 1")
        assert_bitexact(dict(leaf_paths({"params": res.pop("params")})),
                        tree)
        n, p, g = SERVE["n_requests"], SERVE["prompt_len"], SERVE["gen_len"]
        prefill_fn, decode_fn, _ = make_serve_fns(model)
        prompts = np.random.default_rng(SERVE["seed"]).integers(
            0, cfg.vocab_size, (n, p), dtype=np.int32)
        init = model.init(seed=SERVE["seed"], device=dev)
        tok, cache = prefill_fn(init, torch.from_numpy(prompts).to(dev),
                                cache_len=p + g)
        del init
        out = np.full((n, g), -1, np.int32)
        out[:, 0] = tok.cpu().numpy()
        for c in range(1, g):
            tok, cache = decode_fn(params, cache,
                                   torch.from_numpy(out[:, c - 1]).to(dev))
            out[:, c] = tok.cpu().numpy()
        del cache
        if not np.array_equal(res["tokens"], out):
            fail("the hot-swapped serve's tokens differ from the direct "
                 "loop's (prefill initial params, decode round 1)")
        ws = res["weight_sync"]
        polling_s = res["decode_s"] - ws["flip_sync_s"] - ws["swap_s"]
        stats["serve"] = {
            "weight_sync_step": 1, "token_exact": True, "run_s": serve_s,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "tok_per_s": res["tok_per_s"],
            "tok_per_s_polling": n * (g - 1) / polling_s,
            "serving_phase_tok_per_s": serve_tok_per_s, **ws}
        # ---- delta sync: round 1 moves only the changed chunks ---------
        m1 = mgr.load_manifest(1)["leaves"]
        old = {d for rec in m0.values() for s in rec["shards"]
               for d in s["chunks"]}
        new_chunks = {}
        for name in changed:
            for s in m1[name]["shards"]:
                for d, ln in zip(s["chunks"], s["chunk_lens"]):
                    if d not in old:
                        new_chunks[d] = ln
        t0 = time.monotonic()
        st = delta.sync()
        delta_s = time.monotonic() - t0
        delta_bytes = delta.counters["wire_bytes"] - full_bytes
        bound = sum(new_chunks.values()) + DELTA_SLACK
        if st["last_flipped_step"] != 1 or not 0 < delta_bytes <= bound:
            fail(f"delta sync: {delta_bytes} bytes against a bound of "
                 f"{bound} ({st})")
        assert_bitexact(delta.current()[1], tree)
        # what one poll of an up-to-date subscriber costs, in its parts:
        # the ANNOUNCE read and parse, and the status (a cache walk)
        t0 = time.monotonic()
        for _ in range(5):
            delta.poll()
        poll_s = (time.monotonic() - t0) / 5
        t0 = time.monotonic()
        for _ in range(5):
            delta.status()
        status_s = (time.monotonic() - t0) / 5
        stats["serve"].update(idle_poll_announce_s=poll_s,
                              idle_poll_status_s=status_s)
        stats["full_sync"] = {"seconds": full_sync_s, "bytes": full_bytes,
                              "flip_blocking_s": full_flip_s}
        stats["delta_sync"] = {
            "seconds": delta_s, "bytes": delta_bytes,
            "changed_leaves": len(changed),
            "changed_chunk_bytes": sum(new_chunks.values()),
            "slack_bytes": DELTA_SLACK,
            "flip_blocking_s": delta.counters["last_flip_blocking_s"]}
        delta.close()
        mgr.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(Path("/dev/shm") / f"repro-bb-{os.getpid()}",
                      ignore_errors=True)
    stats["launches"] = launches
    for seg, names in (("publish", ("gear_scan", "byteplane_fwd",
                                    "rle_emit")),
                       ("restore", ("byteplane_inv",)),
                       ("serve", ("rmsnorm", "flash_attention"))):
        for k in names:
            if launches[seg][k] <= 0:
                fail(f"kernel {k} was not launched by the reliability "
                     f"phase's {seg}")
    say(f"reliability: launches {launches}")
    return stats


# ---------------------------------------------------------------------------
# phase 7 — the rest of the attention zoo: llama4-scout trained at full width
# ---------------------------------------------------------------------------

ZOO_ARCH = "llama4-scout-17b-a16e"
ZOO_LAYERS = 2                # of 48: ~6.5 G params, ~13 GB of bf16
ZOO_LEAF = "params/stage_0/b0/moe/wg"   # (2, 16, 5120, 8192) bf16
ZOO_MIN_FREE_BYTES = 30e9     # two ~13 GB rounds on disk at once (retain 1)
STRADDLE = 1 << 31            # the window must straddle this byte
# K8 at the new configs' path shapes, bf16, causal: (B, S, H, K, D, window,
# softcap, q scale, v scale), S 2048 and llama4's training shape. gemma2's
# rows scale q by 16, so the scaled logits (N(0, 1) at its scale 1/16)
# reach its softcap of 50, and v by 1/4, so the outputs (near single rows
# of v under so sharp a softmax) stay below 2; its local row runs at its
# full context of 8192, where the window of 4096 masks half the keys.
ZOO_ATTN = {
    "gemma2-9b_local": (1, 8192, 16, 8, 256, 4096, 50.0, 16.0, 0.25),
    "gemma2-9b_global": (2, 2048, 16, 8, 256, 0, 50.0, 16.0, 0.25),
    "stablelm-1.6b": (2, 2048, 32, 32, 64, 0, 0.0, 1.0, 1.0),
    "starcoder2-3b": (2, 2048, 24, 2, 128, 0, 0.0, 1.0, 1.0),
    "chameleon-34b": (2, 2048, 64, 8, 128, 0, 0.0, 1.0, 1.0),
    "llama4-scout-17b-a16e": (2, 2048, 40, 8, 128, 0, 0.0, 1.0, 1.0),
    "kimi-k2-1t-a32b": (2, 2048, 64, 8, 128, 0, 0.0, 1.0, 1.0),
    "llama4_train": (4, 1024, 40, 8, 128, 0, 0.0, 1.0, 1.0),
}
ZOO_RMS = {"gemma2-9b": (4096, 3584), "llama4-scout-17b-a16e": (4096, 5120),
           "kimi-k2-1t-a32b": (4096, 7168), "chameleon-34b": (4096, 8192),
           "chameleon-34b_q_norm": (4096 * 64, 128),
           "chameleon-34b_k_norm": (4096 * 8, 128)}


def attn_err(got, ref) -> tuple:
    """(max abs err, max of err / bound): the bound on |got − ref| is one
    bf16 ulp of each value of `ref` (at most 2^-7 of it) plus ``ATTN_TOL``
    of `ref`'s RMS, so a flat tolerance cannot hide a small output."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    bound = ref.abs() * 2.0 ** -7 + \
        ATTN_TOL["bfloat16"] * ref.pow(2).mean().sqrt()
    return err.max().item(), (err / bound).max().item()


def k8_row_parity(dev, g, name: str, row: tuple, worst: dict):
    """K8 (bf16, causal) at one row (B, S, H, K, D, window, softcap, q
    scale, v scale) against its plain version: within ``ATTN_TOL`` and
    ``attn_err``'s bound; where the row sets a softcap or a window, the
    plain output with it switched off must fail that bound, so a K8 that
    ignored it would. Records the errors in `worst`."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    B, S, H, K, D, window, cap, qs, vs = row
    bf = torch.bfloat16
    q = (torch.randn((B, S, H, D), generator=g, device=dev) * qs).to(bf)
    k = torch.randn((B, S, K, D), generator=g, device=dev).to(bf)
    v = (torch.randn((B, S, K, D), generator=g, device=dev) * vs).to(bf)
    kw = dict(causal=True, window=window, softcap=cap)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    err, rel = attn_err(fa.flash_attention(q, k, v, **kw), ref)
    if not (err <= ATTN_TOL["bfloat16"] and rel <= 1.0):
        fail(f"K8 at {name} {(B, S, H, K, D)} {kw}: max abs err {err} "
             f"(> {ATTN_TOL['bfloat16']}?), {rel} of the relative bound")
    worst[f"k8_{name}"] = err
    worst[f"k8_{name}_of_bound"] = rel
    for off in [o for o, on in (("softcap", cap), ("window", window)) if on]:
        _, moved = attn_err(fa.flash_attention_plain(
            q, k, v, **{**kw, off: 0}), ref)
        if not moved > 1.0:
            fail(f"K8 at {name}: the plain output without the {off} is "
                 f"within the bound ({moved} of it)")
        worst[f"k8_{name}_no_{off}_of_bound"] = moved
    del q, k, v, ref
    torch.cuda.empty_cache()


def k7_row_parity(dev, g, name: str, n: int, d: int, worst: dict):
    """K7 (bf16) over `n` rows of `d` against its plain version, within
    ``RMS_TOL``; records the error in `worst`."""
    import torch

    from repro_torch.kernels.rmsnorm import ops as rn
    bf = torch.bfloat16
    x = torch.randn((n, d), generator=g, device=dev).to(bf)
    s = (torch.randn((d,), generator=g, device=dev) * 0.1).to(bf)
    err = (rn.rmsnorm_fused(x, s).float()
           - rn.rmsnorm_plain(x, s).float()).abs().max().item()
    if not err <= RMS_TOL["bfloat16"]:
        fail(f"K7 at {name} {(n, d)}: max abs err {err} > "
             f"{RMS_TOL['bfloat16']}")
    worst[f"k7_{name}"] = err


def zoo_parity(dev) -> dict:
    """K8 and K7 against their plain versions at the new configs' path
    shapes (bf16, ``RMS_TOL``/``ATTN_TOL``, the ``tests/test_kernels.py``
    tolerances; K8 also within ``attn_err``'s bound relative to the plain
    output). Where a row sets a softcap or a window, the plain output with
    it switched off must fail that bound (``k8_row_parity``)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    worst = {}
    for name, row in ZOO_ATTN.items():
        k8_row_parity(dev, g, name, row, worst)
    for name, (n, d) in ZOO_RMS.items():
        k7_row_parity(dev, g, name, n, d, worst)
    say(f"zoo parity: K8 at {len(ZOO_ATTN)} and K7 at {len(ZOO_RMS)} path "
        f"shapes of the new configs within tolerance; worst "
        f"{json.dumps(worst)}")
    return worst


def straddle_check(record, leaf_u8, itemsize: int, at: int,
                   chunk_size: int) -> dict:
    """Hold the device route's cut points and chunk digests of one leaf
    (`record`: its manifest shard record, chunk-encoded with its
    ``codec``; `leaf_u8`: the
    leaf's bytes on the host) against the host oracle in a window that
    straddles byte `at` of the transformed stream.

    The window starts at the raw cut behind a device cut point ``c`` a few
    chunks before `at`: the stored cuts are rounded up to the entropy
    block grid, so the raw cut is the one candidate (loose ⊇ strict) of
    the oracle scan in ``(c − block, c]``; a cut point with none or two
    there is passed over. From a raw cut on, CDC depends only on the bytes
    that follow, so the oracle's cuts over the window (the last, forced by
    the window's end, dropped), rounded up to the grid, must be the
    device's, and each chunk's oracle encoding must hash to the device's
    digest and length. The oracle's transformed bytes are computed from
    the leaf's elements around the window (``codec.byteplane_forward`` of
    that slice), never from the whole leaf."""
    import numpy as np

    from repro_torch.core import codec as codec_mod
    from repro_torch.core.cas import chunk_digest
    from repro_torch.core.cdc import GearChunker
    from repro_torch.core.cdc_scan import WINDOW, scan_candidates_numpy
    blk = codec_mod.ENTROPY_BLOCK
    n = int(record["raw_payload_bytes"])
    k = int(itemsize)
    ne = n // k
    if n != len(leaf_u8) or n % k:
        fail(f"straddle check: record of {n} bytes for a leaf of "
             f"{len(leaf_u8)} bytes (itemsize {k})")
    ck = GearChunker(chunk_size, device="cpu")
    ms, ml = int(ck.mask_strict), int(ck.mask_loose)

    def stream(lo, hi):
        """Bytes [lo, hi) of the transformed stream, inside one plane."""
        p = lo // ne
        if hi > (p + 1) * ne:
            fail(f"straddle window [{lo}, {hi}) crosses a plane edge")
        j0, j1 = lo - p * ne, hi - p * ne
        e0 = max(j0 - 1, 0)
        sub = codec_mod.byteplane_forward(leaf_u8[e0 * k:j1 * k], k)
        m = j1 - e0
        return sub[p * m + (j0 - e0):(p + 1) * m]

    cuts = np.cumsum(np.asarray(record["chunk_raw_lens"], np.int64))
    starts = np.concatenate([[0], cuts[:-1]])
    span = 24 * chunk_size
    for c in cuts[(cuts <= at - 2 * chunk_size)][::-1][:8]:
        c = int(c)
        lo = c - blk - WINDOW
        _, loose = scan_candidates_numpy(stream(lo, c), ms, ml)
        raw = [int(x) + lo for x in loose if c - blk < int(x) + lo <= c]
        if len(raw) == 1:
            break
    else:
        fail("straddle check: no device cut point before the window with "
             "one candidate behind it")
    e = raw[0]
    w = stream(e, min(e + span, n))
    host = ck.cut_points_n(len(w), scan_candidates_numpy(w, ms, ml))[:-1]
    aligned = []
    for x in host:
        a = -(-(e + x) // blk) * blk
        if not aligned or a > aligned[-1]:
            aligned.append(a)
    dev_cuts = [int(x) for x in cuts if c < x <= aligned[-1]]
    if aligned != dev_cuts or not (c < at < aligned[-1]):
        fail(f"straddle check: oracle cuts {aligned} != device cuts "
             f"{dev_cuts} in the window from {c} (raw {e}) across {at}")
    i0 = int(np.searchsorted(cuts, c)) + 1      # first chunk after c
    checked = 0
    for i, (a, b) in enumerate(zip([c] + aligned[:-1], aligned)):
        j = i0 + i
        if int(starts[j]) != a or int(cuts[j]) != b:
            fail(f"straddle check: chunk {j} spans {starts[j]}..{cuts[j]},"
                 f" the oracle {a}..{b}")
        body = codec_mod.plane_encode_chunk(stream(a, b), record["codec"])
        if chunk_digest(body) != record["chunks"][j] or \
                len(body) != int(record["chunk_lens"][j]):
            fail(f"straddle check: chunk {j} ({a}..{b}) of the device "
                 "route differs from the host oracle's encoding")
        checked += 1
    return {"window": [c, aligned[-1]], "raw_cut": e, "at": at,
            "chunks": checked, "cuts_after_at": sum(x > at for x in aligned)}


def zoo(dev, card: str, profile: bool = False, keep: bool = False) -> dict:
    """``preempt_resume`` of llama4-scout-17b-a16e at full width (d 5120,
    40/8 heads of 128, 16 experts of 8192, top-1 and a shared expert,
    capacity factor 1.5, vocab 202,048), 2 of 48 layers, bf16 params,
    Adafactor. The 2.7 GB expert stack is the first leaf past 2^31 bytes
    through the fused K2+K1+K3 route and K4: its restore must equal the
    saved leaf bit for bit, and its cut points and chunk digests in a
    window across byte 2^31 must equal the host oracle's
    (``straddle_check``). The run's segments must launch K7 and K8 (run A's
    steps), K1-K3 (run B's saves) and K4 (the restore). With `keep`, run
    A also takes step 5, and the workdir (run B's step-4 checkpoint) is
    left for the parallel phase, which removes it."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.save_path import to_host
    from repro_torch.core.split_state import leaf_paths

    cfg = dataclasses.replace(get_config(ZOO_ARCH), n_layers=ZOO_LAYERS)
    root = ROOT / "build" / "chip_smoke_zoo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    if free < ZOO_MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {root}; need "
             f"{int(ZOO_MIN_FREE_BYTES)} for two rounds of the 13 GB state")
    os.environ["REPRO_CKPT_KEEPALIVE_S"] = "60"
    stats = {"arch": cfg.arch_id, "n_layers": ZOO_LAYERS,
             "of_layers": get_config(ZOO_ARCH).n_layers, **TRAIN,
             "steps": TRAIN_STEPS, "preempt_after": PREEMPT_AFTER,
             "optimizer": cfg.optimizer, "card": card, "profiled": profile}
    held = {}

    def on_saved(trainer):
        leaves = leaf_paths(trainer.state)
        big = dict(leaves)[ZOO_LEAF]
        stats["largest_leaf"] = {"name": ZOO_LEAF, "bytes": big.nbytes,
                                 "shape": list(big.shape)}
        if big.nbytes <= STRADDLE or \
                big.nbytes < max(t.nbytes for _, t in leaves):
            fail(f"{ZOO_LEAF} ({big.nbytes} bytes) is not the largest leaf "
                 "or not past 2^31 bytes")
        held["saved"] = to_host(big)

    def on_restored(trainer):
        got = to_host(dict(leaf_paths(trainer.state))[ZOO_LEAF])
        saved = held["saved"]
        if got.shape != saved.shape or \
                not (got.view("u1") == saved.view("u1")).all():
            fail(f"{ZOO_LEAF} restored through K4 differs from the saved "
                 "leaf")
        held["record"] = trainer.manager.load_manifest(PREEMPT_AFTER)[
            "leaves"][ZOO_LEAF]["shards"][0]

    try:
        run, launches, state = preempt_resume(cfg, root, dev, profile,
                                              on_saved, on_restored,
                                              next_steps=int(keep))
        del state
        torch.cuda.empty_cache()
        stats.update(run)
        rec = held["record"]
        t0 = time.monotonic()
        stats["straddle"] = straddle_check(
            rec, held.pop("saved").reshape(-1).view("u1"), 2, STRADDLE, MiB)
        stats["straddle"]["seconds"] = time.monotonic() - t0
        stats["straddle"]["leaf_chunks"] = len(rec["chunks"])
    finally:
        held.clear()
        os.environ.pop("REPRO_CKPT_KEEPALIVE_S", None)
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"zoo: {cfg.arch_id} ({ZOO_LAYERS} layers, {stats['params']} "
        f"params), drop_fraction {stats['drop_fraction']}; {ZOO_LEAF} "
        f"({stats['largest_leaf']['bytes']} bytes) restored bit for bit; "
        f"device cuts and digests equal the host oracle's in "
        f"{json.dumps(stats['straddle'])}")
    for seg, kernels in (("steps", ("rmsnorm", "flash_attention")),
                         ("saves", ("gear_scan", "byteplane_fwd",
                                    "rle_emit")),
                         ("restore", ("byteplane_inv",))):
        for k in kernels:
            if launches[seg][k] <= 0:
                fail(f"kernel {k} was not launched in the zoo's {seg}")
    stats["launches"] = launches
    say(f"zoo launches {json.dumps(launches)}")
    return stats


# ---------------------------------------------------------------------------
# phase 8 — the SSM, RG-LRU and encoder families
# ---------------------------------------------------------------------------

# served at full width: (layers, prompt length); mamba2-780m at 12 of 48,
# recurrentgemma-9b at 3 of 38 (RG-LRU, RG-LRU, local attention); prompts
# past recurrentgemma's window of 2,048, so that the local layers' ring
# wraps (mamba2 at 48 layers until the parallel phase joined the script,
# 24 until the zoo serving phase did; cut to keep it inside its limit)
FAMILY_SERVE = {"mamba2-780m": (12, 2048), "recurrentgemma-9b": (3, 4096)}
# trained at full width through ``preempt_resume``: layers of 48 (12 until
# the parallel phase joined the script, 6 until the zoo serving phase did;
# cut to keep it inside its limit; mamba2-780m trains at all 48 layers in
# the remat phase)
FAMILY_TRAIN = {"mamba2-780m": 3, "hubert-xlarge": 3}
# K8 at the families' path shapes, bf16, held against its plain version
# and timed: (B, S, H, K, D, window, causal); hubert's training steps at
# head dim 80 (the D 128 instantiation, ``kernel_dim``) and recurrentgemma's
# local-attention prefill of ``FAMILY_SERVE``'s 8 requests of 4,096 tokens
FAMILY_K8 = {"hubert_train": (4, 1024, 16, 16, 80, 0, False),
             "recurrentgemma_serve": (8, 4096, 16, 1, 256, 2048, True)}
# K7 at the families' widths: (rows, D) of the serving prefills' block
# norms and mamba2's gated norm over d_inner
FAMILY_RMS = {"mamba2-780m": (8 * 2048, 1536),
              "mamba2-780m_gated": (8 * 2048, 3072),
              "recurrentgemma-9b": (8 * 4096, 4096)}
FAMILY_MIN_FREE_BYTES = 15e9


def families_parity(dev) -> dict:
    """K8 and K7 against their plain versions at the families' path shapes
    (``FAMILY_K8``, ``FAMILY_RMS``; bf16, ``ATTN_TOL``/``RMS_TOL``; K8 also
    within ``attn_err``'s bound); where a row sets a window, the plain
    output without it must fail that bound. At recurrentgemma's B 8 the
    plain version's f32 scores are 8.6 GB a tensor (about 30 GB at its
    peak). Then the reduced configs on the card against the CPU
    (``family_reference``)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    bf = torch.bfloat16
    worst = {}
    for name, (B, S, H, K, D, window, causal) in FAMILY_K8.items():
        q, k, v = (torch.randn((B, S, n, D), generator=g, device=dev).to(bf)
                   for n in (H, K, K))
        kw = dict(causal=causal, window=window)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        err, rel = attn_err(fa.flash_attention(q, k, v, **kw), ref)
        if not (err <= ATTN_TOL["bfloat16"] and rel <= 1.0):
            fail(f"K8 at {name} {(B, S, H, K, D)} {kw}: max abs err {err} "
                 f"(> {ATTN_TOL['bfloat16']}?), {rel} of the relative bound")
        worst[f"k8_{name}"] = err
        worst[f"k8_{name}_of_bound"] = rel
        if window:
            _, moved = attn_err(fa.flash_attention_plain(
                q, k, v, causal=causal, window=0), ref)
            if not moved > 1.0:
                fail(f"K8 at {name}: the plain output without the window is "
                     f"within the bound ({moved} of it)")
            worst[f"k8_{name}_no_window_of_bound"] = moved
        del q, k, v, ref
        torch.cuda.empty_cache()
    for name, (n, d) in FAMILY_RMS.items():
        x = torch.randn((n, d), generator=g, device=dev).to(bf)
        sc = (torch.randn((d,), generator=g, device=dev) * 0.1).to(bf)
        err = (rn.rmsnorm_fused(x, sc).float()
               - rn.rmsnorm_plain(x, sc).float()).abs().max().item()
        if not err <= RMS_TOL["bfloat16"]:
            fail(f"K7 at {name} {(n, d)}: max abs err {err} > "
                 f"{RMS_TOL['bfloat16']}")
        worst[f"k7_{name}"] = err
        del x
    say(f"families parity: K8 at {len(FAMILY_K8)} and K7 at "
        f"{len(FAMILY_RMS)} path shapes within tolerance; worst "
        f"{json.dumps(worst)}")
    worst["reference"] = family_reference(dev)
    return worst


def family_reference(dev, atol: float = 1e-4) -> dict:
    """The reduced mamba2-780m and recurrentgemma-9b (f32) on the card —
    norms and prefill attention through K7/K8 — against the same weights
    on the CPU (plain versions): prefill and four decode steps give the
    same logits within `atol` and the same greedy tokens; the reduced
    hubert-xlarge's ``encode`` gives the same logits within `atol`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    cpu = torch.device("cpu")
    out = {}
    for arch in ("mamba2-780m", "recurrentgemma-9b", "hubert-xlarge"):
        cfg = reduced(get_config(arch))
        model = Model(cfg)
        params = {"cpu": model.init(seed=3, device=cpu)}
        params["gpu"] = _to(params["cpu"], dev)
        rng = np.random.default_rng(3)
        if cfg.family == "encoder":
            inp = torch.from_numpy(rng.standard_normal(
                (2, 48, cfg.d_model), dtype=np.float32))
        else:
            inp = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (4, 32), dtype=np.int32))
        runs = {}
        for key, d in (("cpu", cpu), ("gpu", dev)):
            if cfg.family == "encoder":
                runs[key] = model.encode(params[key], inp.to(d)).cpu()
                continue
            logits, cache = model.prefill(params[key], inp.to(d),
                                          cache_len=40)
            seq = [logits.cpu()]
            tok = logits.argmax(-1).int()
            for _ in range(4):
                logits, cache = model.decode_step(params[key], cache, tok)
                seq.append(logits.cpu())
                tok = logits.argmax(-1).int()
            runs[key] = torch.stack(seq)
        err = (runs["gpu"] - runs["cpu"]).abs().max().item()
        if not (torch.isfinite(runs["gpu"]).all() and err <= atol
                and torch.equal(runs["gpu"].argmax(-1),
                                runs["cpu"].argmax(-1))):
            fail(f"reduced {arch} on the card disagrees with the CPU: max "
                 f"abs logit err {err} (tolerance {atol})")
        out[arch] = err
    say(f"families model: reduced mamba2/recurrentgemma prefill + 4 decode "
        f"steps and hubert encode on the card match the CPU plain versions "
        f"(max abs logit err {json.dumps(out)})")
    return out


def serve_runs(dev, arch: str, layers: int, prompt_len: int, root: Path,
               card: str, profile: bool = False, preempt: bool = True,
               what: str = "families serve") -> dict:
    """``serve.run`` of `arch` at full width, `layers` deep: 8 requests of
    `prompt_len` tokens, 64 new, greedy; uninterrupted, then (with
    `preempt`) preempted at token 32 and resumed. The resumed tokens must
    equal the uninterrupted run's, the preempted run's before token 32;
    tokens must lie in the vocabulary; K7 (where the config's norm is
    RMSNorm) and K8 (where it has attention) must launch in the
    uninterrupted run. Launches are read per run, and the uninterrupted
    run's peak device bytes. `profile` traces the uninterrupted run
    (device and host)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    kw = dict(SERVE, prompt_len=prompt_len, n_layers=layers)
    plan = [("uninterrupted", {})]
    if preempt:
        plan += [("preempted", {"preempt_at": PREEMPT_AT}), ("resumed", {})]
    runs, launches = {}, {}
    t0 = time.monotonic()
    for name, extra in plan:
        wd = root / arch / ("full" if name == "uninterrupted" else "pre")
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with DeviceProfile(profile and name == "uninterrupted",
                           host=True) as prof:
            t1 = time.monotonic()
            runs[name] = serve.run(arch, workdir=str(wd), device=dev, **kw,
                                   **extra)
            runs[name]["wall_s"] = time.monotonic() - t1
        runs[name]["peak"] = torch.cuda.max_memory_allocated(dev)
        if profile and name == "uninterrupted":
            runs[name]["device"] = prof.summary(runs[name]["wall_s"])
        launches[name] = read_counts()
    full = runs["uninterrupted"]
    pre, res = runs.get("preempted"), runs.get("resumed")
    cfg = get_config(arch)
    toks = full["tokens"]
    if not (full["status"] == "completed"
            and toks.shape == (kw["n_requests"], kw["gen_len"])
            and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{arch} serving ended {full['status']} or gave tokens out of "
             "range")
    if preempt:
        if not (pre["status"] == "preempted"
                and res["status"] == "completed"):
            fail(f"{arch} preempted/resumed serving ended {pre['status']}/"
                 f"{res['status']}")
        if not np.array_equal(pre["tokens"][:, :PREEMPT_AT],
                              toks[:, :PREEMPT_AT]):
            fail(f"{arch}: the preempted run's tokens differ before the "
                 "preemption")
        if not np.array_equal(res["tokens"], toks):
            fail(f"{arch}: the resumed run's tokens differ from the "
                 "uninterrupted run's")
    need = (["rmsnorm"] if cfg.norm == "rmsnorm" else []) + \
        (["flash_attention"] if any(k.startswith("attn")
                                    for k in cfg.pattern) else [])
    for k in need:
        if launches["uninterrupted"][k] <= 0:
            fail(f"kernel {k} was not launched serving {arch}")
    stats = {"arch": arch, "n_layers": layers, "of_layers": cfg.n_layers,
             "n_requests": kw["n_requests"], "prompt_len": prompt_len,
             "gen_len": kw["gen_len"],
             "preempt_at": PREEMPT_AT if preempt else None,
             "prefill_s": full["prefill_s"],
             "decode_tok_per_s": full["tok_per_s"],
             "decode_s": full["decode_s"],
             "uninterrupted_s": full["wall_s"],
             "peak_device_bytes": full["peak"],
             "save_s": pre and pre["save_s"],
             "save_bytes": pre and pre["save_bytes"],
             "restore_s": res and res["restore_s"],
             "resumed_decode_tok_per_s": res and res["tok_per_s"],
             "phase_s": time.monotonic() - t0, "token_exact": preempt,
             "launches": launches, "card": card}
    if profile:
        stats["device_uninterrupted"] = full["device"]
    cr = (f"preempt save {stats['save_s']:.3f} s / {stats['save_bytes']} "
          f"bytes, restore {stats['restore_s']:.3f} s; resumed tokens "
          "identical" if preempt else "no preempt")
    say(f"{what} {arch} ({layers} layers): prefill "
        f"{stats['prefill_s']:.3f} s, decode {stats['decode_tok_per_s']:.1f}"
        f" tok/s, peak {stats['peak_device_bytes']} bytes, {cr}; launches "
        f"{json.dumps(launches)}")
    return stats


def families(dev, card: str, profile: bool = False) -> dict:
    """The SSM, RG-LRU and encoder families at full width: ``serve_runs``
    of mamba2-780m (12 of 48 layers, 2,048-token prompts) and
    recurrentgemma-9b (3 of 38 layers, 4,096-token prompts);
    ``preempt_resume`` of
    mamba2-780m (3 of 48 layers: SSD chunks of 256, whose gradient the
    reference gives as NaN) and hubert-xlarge (3 of 48 layers, encoder
    batches, K8 at head dim 80) with AdamW, each resumed to the
    uninterrupted run's ``params_digest``. Launches are read per segment:
    K7/K8 in the serves and steps, K1-K3 in the training saves, K4 in the
    restores."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    root = ROOT / "build" / "chip_smoke_families"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    if free < FAMILY_MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {root}; need "
             f"{int(FAMILY_MIN_FREE_BYTES)} for the families' checkpoints")
    os.environ["REPRO_CKPT_KEEPALIVE_S"] = "60"
    out = {"serve": {}, "train": {}, "launches": {}, "card": card}
    try:
        for arch, (layers, prompt) in FAMILY_SERVE.items():
            st = serve_runs(dev, arch, layers, prompt, root, card, profile)
            out["serve"][arch] = st
            for seg, c in st["launches"].items():
                out["launches"][f"{arch}_serve_{seg}"] = c
            shutil.rmtree(root / arch, ignore_errors=True)
            torch.cuda.empty_cache()
        for arch, layers in FAMILY_TRAIN.items():
            cfg = dataclasses.replace(get_config(arch), n_layers=layers)
            run, launches, state = preempt_resume(cfg, root / arch, dev,
                                                  profile)
            del state
            torch.cuda.empty_cache()
            run.update(arch=arch, n_layers=layers,
                       of_layers=get_config(arch).n_layers, **TRAIN,
                       steps=TRAIN_STEPS, preempt_after=PREEMPT_AFTER)
            out["train"][arch] = run
            for seg, c in launches.items():
                out["launches"][f"{arch}_train_{seg}"] = c
            steps = ["rmsnorm"] if cfg.norm == "rmsnorm" else []
            if any(k.startswith("attn") for k in cfg.pattern):
                steps.append("flash_attention")
            for seg, kernels in (("steps", steps),
                                 ("saves", ("gear_scan", "byteplane_fwd",
                                            "rle_emit")),
                                 ("restore", ("byteplane_inv",))):
                for k in kernels:
                    if launches[seg][k] <= 0:
                        fail(f"kernel {k} was not launched in {arch}'s "
                             f"training {seg}")
            shutil.rmtree(root / arch, ignore_errors=True)
    finally:
        os.environ.pop("REPRO_CKPT_KEEPALIVE_S", None)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(Path("/dev/shm") / f"repro-bb-{os.getpid()}",
                      ignore_errors=True)
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    out["k8"] = k8_shapes(dev, g, FAMILY_K8)
    out["k7"] = k7_shapes(dev, g, kernels={}, shapes=FAMILY_RMS)
    say(f"families: K8 {json.dumps(out['k8'])}; K7 {json.dumps(out['k7'])}")
    return out


# ---------------------------------------------------------------------------
# phase 9 — the zoo served at full width through ``serve.run``
# ---------------------------------------------------------------------------

# served at full width: (layers, prompt length, preempted and resumed);
# gemma2-9b one (local, global) pair with prompts past its window of 4,096
# (the ring wraps), chameleon-34b one layer of 8,192, kimi-k2 its dense
# first layer and one MoE layer (39.94 GB of bf16: expert stacks of 11.27
# GB, 5.6 G elements a leaf) uninterrupted only: its serving save, ~40 GB
# at the serving saves' ~0.4 GB/s, would take ~100 s of the script's limit.
# stablelm-1.6b (24 layers) and starcoder2-3b (30) are cut to their first
# two to keep the script inside its limit: a GB of serving state costs
# ~6.5 s here (the save, its drain to the throttled slow tier as the run
# ends, the restore), and the phase took 125 s at 24 and 8 layers, 80 s at
# 6 and 4
ZOO_SERVE = {"stablelm-1.6b": (2, 2048, True),
             "starcoder2-3b": (2, 2048, True),
             "gemma2-9b": (2, 4608, True),
             "chameleon-34b": (1, 2048, True),
             "kimi-k2-1t-a32b": (2, 2048, False)}
# K8 at these prefills' shapes, bf16, causal: (B, S, H, K, D, window,
# softcap, q scale, v scale) as in ``ZOO_ATTN`` (gemma2's q scaled so its
# logits reach the softcap)
ZOO_SERVE_K8 = {
    "stablelm-1.6b": (8, 2048, 32, 32, 64, 0, 0.0, 1.0, 1.0),
    "starcoder2-3b": (8, 2048, 24, 2, 128, 0, 0.0, 1.0, 1.0),
    "gemma2-9b_local": (8, 4608, 16, 8, 256, 4096, 50.0, 16.0, 0.25),
    "gemma2-9b_global": (8, 4608, 16, 8, 256, 0, 50.0, 16.0, 0.25),
    "chameleon-34b": (8, 2048, 64, 8, 128, 0, 0.0, 1.0, 1.0),
    "kimi-k2-1t-a32b": (8, 2048, 64, 8, 128, 0, 0.0, 1.0, 1.0)}
# K7 at the RMSNorm configs' prefill norms (rows, D), chameleon's q/k norms
# over heads of 128 among them; stablelm-1.6b and starcoder2-3b are
# LayerNorm configs (plain ops in both packages: no K7 on their path)
ZOO_SERVE_RMS = {"gemma2-9b": (8 * 4608, 3584),
                 "chameleon-34b": (8 * 2048, 8192),
                 "chameleon-34b_q_norm": (8 * 2048 * 64, 128),
                 "chameleon-34b_k_norm": (8 * 2048 * 8, 128),
                 "kimi-k2-1t-a32b": (8 * 2048, 7168)}
# prefill <-> decode at full width: B x S tokens prefilled, and the same
# tokens decoded one at a time from ``init_cache``; the last logits held
# within MESH_SERVE_RTOL of the largest (bf16 serving), the argmax equal;
# MoE at the no-drop capacity, as ``tests/test_models_smoke.py``
ZOO_PD = (2, 64)
ZOO_SERVE_MIN_FREE_BYTES = 10e9     # chameleon's 3.6 GB serving save


def k7_per_forward(cfg) -> int:
    """K7 launches in one forward of an attention-only decoder: each
    block's input and MLP norms, its post norms and its q/k norms where the
    config has them, and the final norm; none for a LayerNorm config."""
    if cfg.norm != "rmsnorm":
        return 0
    return 1 + cfg.n_layers * (2 + 2 * cfg.post_norm + 2 * cfg.qk_norm)


def zoo_serve_parity(dev) -> dict:
    """K8 and K7 against their plain versions at the zoo serving phase's
    prefill shapes (``ZOO_SERVE_K8``, ``ZOO_SERVE_RMS``; bf16, as
    ``zoo_parity``). gemma2-9b's plain scores at B 8, S 4,608 are 10.9 GB
    a tensor."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    worst = {}
    for name, row in ZOO_SERVE_K8.items():
        k8_row_parity(dev, g, name, row, worst)
    for name, (n, d) in ZOO_SERVE_RMS.items():
        k7_row_parity(dev, g, name, n, d, worst)
    say(f"zoo serving parity: K8 at {len(ZOO_SERVE_K8)} and K7 at "
        f"{len(ZOO_SERVE_RMS)} prefill shapes within tolerance; worst "
        f"{json.dumps(worst)}")
    return worst


def prefill_decode(dev, arch: str, layers: int) -> dict:
    """`arch` at full width, `layers` deep, weights from seed 0: ``ZOO_PD``
    tokens prefilled, and decoded one at a time from ``init_cache``; the
    prefill's logits and the last decode step's must have the same argmax
    and differ by at most ``MESH_SERVE_RTOL`` of the largest |logit|.

    A MoE config's top-k choice is discontinuous: where a position's k-th
    and (k+1)-th router probabilities lie closer than the two paths'
    bf16-rounded inputs move them, the paths may route it to other experts.
    Where the last position's experts differ at some MoE layer, that layer
    must show such a near tie (its margin below the largest difference of
    the two paths' probabilities there), and the last step is decoded again
    from the same cache with the prefill's experts at every MoE layer
    (their probabilities as weights): that step's logits are the ones held
    to the bound."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.split_state import map_leaves
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    model = Model(cfg)
    B, S = ZOO_PD
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device=dev, dtype=torch.int32)
    # each ``_top_k`` call's probabilities and experts (one call a MoE
    # layer and forward); `forced` experts replace the next calls' own
    top_k, routed, forced = moe_mod._top_k, [], []

    def spy(probs, k):
        w, i = top_k(probs, k)
        if forced:
            i = forced.pop(0).reshape(i.shape)
            w = probs.gather(-1, i)
        routed.append((probs.detach(), i))
        return w, i

    t0 = time.monotonic()
    moe_mod._top_k = spy
    try:
        with torch.no_grad():
            params = model.init(seed=0, device=dev)
            pf, _ = model.prefill(params, toks)
            n_moe = len(routed)
            cache = model.init_cache(B, S, device=dev)
            for t in range(S - 1):
                _, cache = model.decode_step(params, cache, toks[:, t])
            before = map_leaves(torch.clone, cache) if n_moe else None
            dec, cache = model.decode_step(params, cache, toks[:, -1])
            layers_routed = []
            for (pp, ip), (pd, id_) in zip(routed[:n_moe],
                                           routed[-n_moe:] if n_moe
                                           else []):
                pp, ip = (r.reshape(B, S, -1)[:, -1] for r in (pp, ip))
                pd, id_ = pd.reshape(B, -1), id_.reshape(B, -1)
                srt = pp.sort(-1, descending=True).values
                k = cfg.moe.top_k
                layers_routed.append({
                    "experts": ip,
                    "experts_equal": [set(a.tolist()) == set(b.tolist())
                                      for a, b in zip(ip, id_)],
                    "prefill_margin": (srt[:, k - 1] - srt[:, k]).tolist(),
                    "prob_max_abs_diff": (pp - pd).abs().amax(-1).tolist()})
            held = dec
            if not all(all(r["experts_equal"]) for r in layers_routed):
                forced[:] = [r["experts"] for r in layers_routed]
                held, _ = model.decode_step(params, before, toks[:, -1])
            del params, cache, before
    finally:
        moe_mod._top_k = top_k
    torch.cuda.synchronize(dev)
    top = pf.abs().max().item()
    err = (pf - held).abs().max().item()
    same = torch.equal(pf.argmax(-1), dec.argmax(-1)) and \
        torch.equal(pf.argmax(-1), held.argmax(-1))
    out = {"tokens": [B, S], "max_abs_err": err, "max_abs_logit": top,
           "of_largest": err / top, "argmax_equal": same,
           "seconds": time.monotonic() - t0}
    ties = True
    if layers_routed:
        for r in layers_routed:
            del r["experts"]
            ties &= all(eq or m <= d for eq, m, d in zip(
                r["experts_equal"], r["prefill_margin"],
                r["prob_max_abs_diff"]))
        out["routing"] = layers_routed
        out["forced_prefill_experts"] = held is not dec
        if held is not dec:
            out["own_routing_max_abs_err"] = (pf - dec).abs().max().item()
    say(f"zoo prefill/decode {arch} ({layers} layers): {json.dumps(out)}")
    if not (torch.isfinite(pf).all() and torch.isfinite(held).all()
            and same and err <= MESH_SERVE_RTOL * top and ties):
        fail(f"{arch}: prefill and step-by-step decode disagree at full "
             f"width: {json.dumps(out)} (bound {MESH_SERVE_RTOL} of the "
             "largest logit, the same argmax; experts that differ only at "
             "a near tie)")
    return out


def zoo_serving(dev, card: str, profile: bool = False) -> dict:
    """stablelm-1.6b, starcoder2-3b, gemma2-9b, chameleon-34b and
    kimi-k2-1t-a32b served at full width through ``serve.run``
    (``serve_runs``, at the depths of ``ZOO_SERVE``): uninterrupted, and but
    for kimi-k2 preempted at token 32 and resumed token for token. In the
    uninterrupted run K8 must launch once a layer (the prefill; decode is
    PyTorch ops, as in the reference) and K7 exactly ``k7_per_forward``
    times a forward (chameleon's q/k norms included). Then each config's
    ``prefill_decode``. The kernels are first held to their plain versions
    at the phase's shapes (``zoo_serve_parity``). The stores go to
    ``build/chip_smoke_zoo_serve``, each config's removed after it runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    root = ROOT / "build" / "chip_smoke_zoo_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    if free < ZOO_SERVE_MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {root}; need "
             f"{int(ZOO_SERVE_MIN_FREE_BYTES)} for the serving saves")
    shm = Path("/dev/shm") / f"repro-bb-{os.getpid()}"
    os.environ["REPRO_CKPT_KEEPALIVE_S"] = "60"
    out = {"serve": {}, "prefill_decode": {}, "launches": {}, "card": card}
    try:
        t0 = time.monotonic()
        out["parity"] = zoo_serve_parity(dev)
        out["seconds"] = {"parity": time.monotonic() - t0}
        t0 = time.monotonic()
        for arch, (layers, prompt, preempt) in ZOO_SERVE.items():
            st = serve_runs(dev, arch, layers, prompt, root, card, profile,
                            preempt, what="zoo serve")
            cfg = dataclasses.replace(get_config(arch), n_layers=layers)
            want = {"rmsnorm": SERVE["gen_len"] * k7_per_forward(cfg),
                    "flash_attention": sum(k.startswith("attn")
                                           for k in cfg.layer_kinds)}
            for k, n in want.items():
                if st["launches"]["uninterrupted"][k] != n:
                    fail(f"serving {arch}: {k} launched "
                         f"{st['launches']['uninterrupted'][k]} times, "
                         f"expected {n}")
            # the serving path reports no MoE statistics (the prefill's
            # aux values are dropped, as in the reference)
            st["drop_fraction"] = None
            out["serve"][arch] = st
            for seg, c in st["launches"].items():
                out["launches"][f"{arch}_{seg}"] = c
            shutil.rmtree(root / arch, ignore_errors=True)
            shutil.rmtree(shm / arch, ignore_errors=True)
            torch.cuda.empty_cache()
            out["prefill_decode"][arch] = prefill_decode(dev, arch, layers)
            torch.cuda.empty_cache()
            out["seconds"][arch] = time.monotonic() - t0
            say(f"zoo serve {arch}: {out['seconds'][arch]:.3f} s in all")
            t0 = time.monotonic()
    finally:
        os.environ.pop("REPRO_CKPT_KEEPALIVE_S", None)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(shm, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# the remat phase: full-width, full-depth gemma3-1b's loss and gradients
# under each remat policy (26 layers: five units, four of its six-block
# pattern and one of two), and mamba2-780m trained at all 48 layers
REMAT_POLICIES = ("full", "nothing", "dots", "offload_resid")
REMAT_TRAIN_ARCH = "mamba2-780m"
REMAT_TRAIN_STEPS = 3


def remat_phase(dev, card: str) -> dict:
    """(a) gemma3-1b at full width and depth, one batch of 4 × 1,024
    tokens, the same bf16 params: ``make_train_step(...).grads`` (the
    step's loss and gradients under ``train.steps.deterministic``) once
    under each policy of ``REMAT_POLICIES`` after a warm-up call. Loss and
    every gradient must be bit-equal to ``full``'s (the recompute replays
    the same kernels on the same inputs), the peaks ordered ``nothing`` <
    ``dots`` < ``full`` with ``offload_resid`` not above ``nothing``, and
    K8 launched twice as often as under ``full`` (forward and recompute).
    (b) ``Trainer`` trains mamba2-780m at full width and all 48 layers
    (AdamW, batch 4 × 1,024, SSD chunks of 256, its config's ``nothing``
    policy) for ``REMAT_TRAIN_STEPS`` steps with no checkpoint: finite
    loss and ``grad_norm`` at every step; then the peak of the forward and
    backward alone (``grads``, no update) at the trained state. Launches
    are read per segment."""
    import dataclasses

    import torch

    from repro_torch.configs import gemma3_1b, get_config
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.steps import make_train_step

    out = {"card": card, "policies": {}, "launches": {}}
    # ---- (a) the four policies at full depth ------------------------------
    cfg = gemma3_1b.CONFIG
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    pipe = SyntheticPipeline(cfg, batch=TRAIN["batch"],
                             seq_len=TRAIN["seq_len"], device=dev)
    batch, _ = pipe.next(pipe.init_state(TRAIN["seed"]))
    state = {"params": params,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    out["gemma3"] = {"arch": cfg.arch_id, "n_layers": cfg.n_layers,
                     "units": sum(st.repeat for st in model.stages),
                     "params": sum(t.numel() for _, t in
                                   leaf_paths(params)), **TRAIN}

    def grads_under(policy):
        m = Model(dataclasses.replace(cfg, remat_policy=policy))
        step = make_train_step(m, make_optimizer(m.cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        t0 = time.monotonic()
        loss, _, g = step.grads(state, batch)
        torch.cuda.synchronize()
        sec = time.monotonic() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        host = [t.cpu() for _, t in leaf_paths(g)]
        del g
        return loss.cpu(), host, {"s": sec, "peak_device_bytes": peak,
                                  "base_bytes": base,
                                  "launches": launches}

    grads_under("nothing")          # warm-up: first-call set-up, not kept
    ref_loss = ref = None
    for policy in REMAT_POLICIES:
        loss, host, st = grads_under(policy)
        if policy == "full":
            ref_loss, ref = loss, host
        elif not (torch.equal(loss, ref_loss) and all(
                torch.equal(bits(a), bits(b)) for a, b in zip(host, ref))):
            bad = [n for (n, _), a, b in zip(leaf_paths(params), host, ref)
                   if not torch.equal(bits(a), bits(b))]
            fail(f"remat {policy}: loss or gradients differ from full's "
                 f"(loss {float(loss)} vs {float(ref_loss)}; leaves "
                 f"{bad[:5]})")
        st["loss"] = float(loss)
        out["policies"][policy] = st
        out["launches"][f"gemma3_{policy}"] = st["launches"]
        say(f"remat {policy}: {st['s']:.3f} s, peak "
            f"{st['peak_device_bytes']} bytes (base {st['base_bytes']}), "
            f"K7 {st['launches']['rmsnorm']} K8 "
            f"{st['launches']['flash_attention']} launches, loss "
            f"{st['loss']} ({card})")
        del host
    del ref, state, params
    torch.cuda.empty_cache()
    pk = {p: out["policies"][p]["peak_device_bytes"] for p in REMAT_POLICIES}
    if not (pk["nothing"] < pk["dots"] < pk["full"]
            and pk["offload_resid"] <= pk["nothing"]):
        fail(f"remat peaks out of order: {pk}")
    k8 = {p: out["policies"][p]["launches"]["flash_attention"]
          for p in REMAT_POLICIES}
    for p in ("nothing", "dots", "offload_resid"):
        if k8[p] != 2 * k8["full"] or k8["full"] != cfg.n_layers:
            fail(f"remat {p}: K8 launched {k8[p]} times against full's "
                 f"{k8['full']} ({cfg.n_layers} layers)")
    # ---- (b) mamba2-780m at full depth ------------------------------------
    mcfg = get_config(REMAT_TRAIN_ARCH)
    root = ROOT / "build" / "chip_smoke_remat"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Trainer(mcfg, TrainerConfig(workdir=str(root), log_every=1,
                                         ckpt_every=0, **TRAIN),
                     store=TieredStore(Tier("fast", root / "store")),
                     device=dev)
        t0 = time.monotonic()
        tr.init_or_restore()
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        state_bytes = sum(t.nbytes for _, t in leaf_paths(tr.state))
        reset_counts()
        # stop_after leaves the run paused: no end-of-run save
        tr.fit(REMAT_TRAIN_STEPS, stop_after=REMAT_TRAIN_STEPS)
        torch.cuda.synchronize()
        out["launches"]["mamba2_steps"] = read_counts()
        hist = tr.history
        run = {"arch": mcfg.arch_id, "n_layers": mcfg.n_layers,
               "remat_policy": mcfg.remat_policy,
               "ssd_chunk": mcfg.ssm.chunk_size, **TRAIN,
               "steps": REMAT_TRAIN_STEPS, "init_s": init_s,
               "state_bytes": state_bytes,
               "params": sum(t.numel() for _, t in
                             leaf_paths(tr.state["params"])),
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
               **{k: [h[k] for h in hist] for k in ("loss", "grad_norm",
                                                    "step_s")}}
        # the forward and backward alone (no update) at the trained state:
        # which part of the step sets its peak
        mpipe = SyntheticPipeline(mcfg, batch=TRAIN["batch"],
                                  seq_len=TRAIN["seq_len"], device=dev)
        mbatch, _ = mpipe.next(mpipe.init_state(TRAIN["seed"]))
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        g = make_train_step(tr.model, tr.optimizer).grads(tr.state,
                                                          mbatch)[2]
        torch.cuda.synchronize()
        run["grads_peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        run["grads_base_bytes"] = base
        del g
        tr.manager.close()
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    run["tokens_per_s"] = TRAIN["batch"] * TRAIN["seq_len"] * \
        (REMAT_TRAIN_STEPS - 1) / sum(run["step_s"][1:])
    out["mamba2"] = run
    say(f"remat {mcfg.arch_id} at {mcfg.n_layers} layers: loss "
        f"{run['loss']}, grad_norm {run['grad_norm']}, step s "
        f"{run['step_s']}, peak {run['peak_device_bytes']} bytes (the "
        f"forward and backward alone {run['grads_peak_device_bytes']}), "
        f"state {state_bytes} bytes ({card})")
    if len(hist) != REMAT_TRAIN_STEPS or not all(
            math.isfinite(x) for x in run["loss"] + run["grad_norm"]):
        fail(f"remat {mcfg.arch_id}: loss or grad_norm not finite at "
             f"every step: {run['loss']} {run['grad_norm']}")
    if out["launches"]["mamba2_steps"]["rmsnorm"] <= 0:
        fail(f"remat {mcfg.arch_id}: K7 was not launched in its steps")
    return out


# the sharding phase: gemma3-1b at full width, SHARD_LAYERS of its 26 layers
# (6 until the parallel phase joined the script; cut to keep it inside its
# limit)
SHARD_LAYERS = 2
SHARD_MESH = (2, 2)
SHARD_MIN_FREE_BYTES = 15e9


def _shard_tcfg(workdir: Path):
    from repro_torch.train.loop import TrainerConfig
    return TrainerConfig(workdir=str(workdir), log_every=1, **TRAIN,
                         **TRAIN_CKPT)


def _shard_cfg():
    import dataclasses

    from repro_torch.configs import gemma3_1b
    return dataclasses.replace(gemma3_1b.CONFIG, n_layers=SHARD_LAYERS)


def sharding_rank(root: Path) -> int:
    """One CPU rank of phase B (``--sharding-rank``, spawned by
    ``sharding``): joins the gloo group of SHARD_MESH's ranks, restores
    phase A's step-2 checkpoint onto the (2,2) mesh through the port's
    ``Trainer`` (this rank reads only the saved shards that overlap its
    ranges), and saves the state again as a (2,2) checkpoint into
    ``root/b``. Prints one RESULT line."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // world))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / "rendezvous"), world),
        rank=rank, world_size=world)
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import param_specs
    from repro_torch.train.loop import Trainer

    mesh = make_host_mesh(SHARD_MESH, ("data", "model"), device="cpu")
    t = Trainer(_shard_cfg(), _shard_tcfg(root / "a"),
                store=TieredStore(Tier("fast", root / "a")), device="cpu",
                mesh=mesh)
    out = {"rank": rank}
    t0 = time.monotonic()
    t.init_or_restore()
    out["restore_s"] = time.monotonic() - t0
    out["restore_bytes_read"] = t.manager.bytes_read
    out["restored_from"] = t.restored_from
    out["digest"] = t.params_digest()
    out["local_bytes"] = sum(x.to_local().nbytes
                             for _, x in leaf_paths(t.state))
    mgr = CheckpointManager(TieredStore(Tier("fast", root / "b")),
                            policy=t.manager.policy, device="cpu",
                            group=t.manager.group)
    t0 = time.monotonic()
    rep = mgr.save(t.state, t.py_step, extra=t._extra())
    out["save_s"] = time.monotonic() - t0
    out.update({k: rep[k] for k in ("bytes", "rank_bytes",
                                    "new_object_bytes", "seconds")})
    if rank == 0:
        # every leaf the partition rules shard has a record per range
        leaves = mgr.load_manifest(t.py_step)["leaves"]
        specs = param_specs(t._abstract["params"], mesh)
        out["sharded_leaves"] = 0
        for name, sh in leaf_paths(specs):
            if any(e is not None for e in sh.spec):
                n = len(leaves["params/" + name]["shards"])
                if n < 2:
                    out["unsharded"] = name
                out["sharded_leaves"] += 1
        out["lower_half"] = mgr.load_manifest(t.py_step)["extra"][
            "lower_half"]
    mgr.close()
    t.manager.close()
    print("RESULT::" + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharding(dev, card: str) -> dict:
    """Phase 10, the state moved card → four ranks → card: gemma3-1b at
    full width (SHARD_LAYERS of 26 layers), AdamW, batch 4 × 1024, the
    checkpoint round's policy, deterministic algorithms.

    A. The card as mesh (1,1) over NCCL (world size 1): ``Trainer(mesh=)``
       takes three steps and saves at step 2; ``params_digest`` after
       steps 2 and 3, and step 3's loss.
    B. Four CPU ranks (gloo; ``--sharding-rank``, spawned here with
       ``device="cpu"`` asked for by name and no card visible) restore A's
       step 2 onto a (2,2) ``("data", "model")`` mesh: each rank's
       ``params_digest`` must equal A's; they save the state again as a
       (2,2) checkpoint, whose manifest must hold more than one shard
       record for every leaf the partition rules shard.
    C. The card restores B's checkpoint onto (1,1) (M×N, 4 ranks to 1; K4
       decodes the params on the card): ``params_digest`` equal to A's
       step 2; it takes step 3, whose loss and ``params_digest`` must
       equal A's bit for bit.

    Launches are read per segment: K7/K8 in A's steps, K1-K3 in A's save,
    K4 in C's restore, K7/K8 in C's step."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import Trainer

    root = ROOT / "build" / "chip_smoke_sharding"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    if free < SHARD_MIN_FREE_BYTES:
        fail(f"only {free} bytes free under {root}; need "
             f"{int(SHARD_MIN_FREE_BYTES)} for the sharding checkpoints")
    cfg = _shard_cfg()
    os.environ["REPRO_CKPT_KEEPALIVE_S"] = "60"
    out = {"arch": cfg.arch_id, "n_layers": SHARD_LAYERS, "of_layers": 26,
           **TRAIN, "mesh_b": list(SHARD_MESH), "card": card,
           "launches": {}}
    procs = []
    try:
        # ---- A: the card, mesh (1,1), NCCL ------------------------------
        mesh = make_host_mesh((1, 1), ("data", "model"), device=dev)
        out["backend_a"] = dist.get_backend()
        if out["backend_a"] != "nccl":
            fail(f"the card's process group is {out['backend_a']}, not nccl")
        rounds: list = []
        tA = Trainer(cfg, _shard_tcfg(root / "a"),
                     store=TieredStore(Tier("fast", root / "a")),
                     device=dev, mesh=mesh)
        _record_rounds(tA.manager, rounds)
        tA.init_or_restore()
        out["state_bytes"] = sum(t.to_local().nbytes for t in
                                 _leaves(tA.state))
        reset_counts()
        tA.fit(3, stop_after=2)           # saves step 2 (ckpt_every=2)
        torch.cuda.synchronize()
        out["launches"]["a_steps_and_save"] = read_counts()
        digest2 = tA.params_digest()
        reset_counts()
        tA.fit(3, stop_after=1)           # step 3, no save (paused)
        out["launches"]["a_step3"] = read_counts()
        digest3 = tA.params_digest()
        loss3 = tA.history[-1]["loss"]
        out["a"] = {"loss": [h["loss"] for h in tA.history],
                    "step_s": [h["step_s"] for h in tA.history],
                    "save": rounds[0], "digest2": digest2[:16],
                    "digest3": digest3[:16]}
        if tA.manager.latest_step() != 2 or rounds[0]["step"] != 2:
            fail(f"phase A's latest checkpoint is step "
                 f"{tA.manager.latest_step()}, not 2")
        tA.manager.close()
        del tA
        torch.cuda.empty_cache()
        say(f"sharding A ({card}): 3 steps on mesh (1,1) over "
            f"{out['backend_a']}, losses "
            f"{out['a']['loss']}, save at step 2 {json.dumps(rounds[0])}")
        # ---- B: four CPU ranks, mesh (2,2), gloo ------------------------
        world = SHARD_MESH[0] * SHARD_MESH[1]
        env = {**os.environ, "WORLD_SIZE": str(world),
               "CUDA_VISIBLE_DEVICES": "",
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 4)
                                          // world))}
        t0 = time.monotonic()
        logs = [open(root / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sharding-rank",
             str(root)], stdout=subprocess.PIPE, stderr=logs[r], text=True,
            env={**env, "RANK": str(r)}) for r in range(world)]
        ranks = []
        for r, p in enumerate(procs):
            stdout, _ = p.communicate(timeout=900)
            logs[r].seek(0)
            err = logs[r].read()
            logs[r].close()
            if p.returncode:
                fail(f"phase B rank {r} exited {p.returncode}; its stderr "
                     f"ends:\n{err[-4000:]}")
            ranks.append(json.loads(next(
                line for line in stdout.splitlines()
                if line.startswith("RESULT::"))[len("RESULT::"):]))
        out["b_wall_s"] = time.monotonic() - t0
        out["b"] = ranks
        for r in ranks:
            if r["restored_from"] != 2 or r["digest"] != digest2:
                fail(f"phase B rank {r['rank']} restored step "
                     f"{r['restored_from']} with params_digest "
                     f"{r['digest'][:16]} != phase A's {digest2[:16]}")
        if "unsharded" in ranks[0] or ranks[0]["sharded_leaves"] == 0:
            fail(f"phase B's manifest holds one shard record for "
                 f"{ranks[0].get('unsharded')}, a leaf the partition rules "
                 "shard")
        say(f"sharding B ({card}): 4 CPU ranks restored step 2 onto "
            f"{SHARD_MESH} (bytes read per rank "
            f"{[r['restore_bytes_read'] for r in ranks]}, seconds "
            f"{[round(r['restore_s'], 3) for r in ranks]}), digests equal "
            f"A's; (2,2) save {ranks[0]['seconds']:.3f} s, "
            f"{ranks[0]['bytes']} bytes, new_object_bytes "
            f"{ranks[0]['new_object_bytes']}, per rank "
            f"{[r['rank_bytes'] for r in ranks]}")
        # ---- C: the card restores B's (2,2) checkpoint onto (1,1) -------
        tC = Trainer(cfg, _shard_tcfg(root / "b"),
                     store=TieredStore(Tier("fast", root / "b")),
                     device=dev, mesh=mesh)
        ends: list = []
        inner = tC.step_fn

        def timed_step(state, batch):
            res = inner(state, batch)
            torch.cuda.synchronize()
            ends.append(time.monotonic())
            return res

        tC.step_fn = timed_step
        reset_counts()
        t0 = time.monotonic()
        tC.init_or_restore()
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        out["launches"]["c_restore"] = read_counts()
        t1 = time.monotonic()
        digest_c2 = tC.params_digest()
        check_s = time.monotonic() - t1
        if tC.restored_from != 2 or digest_c2 != digest2:
            fail(f"phase C restored step {tC.restored_from} with "
                 f"params_digest {digest_c2[:16]} != phase A's step 2 "
                 f"{digest2[:16]}")
        reset_counts()
        tC.fit(3, stop_after=1)
        out["launches"]["c_step3"] = read_counts()
        loss_c3 = tC.history[-1]["loss"]
        digest_c3 = tC.params_digest()
        out["c"] = {"restore_s": restore_s,
                    "restore_bytes_read": tC.manager.bytes_read,
                    "restore_to_first_step_s": ends[0] - t0 - check_s,
                    "loss3": loss_c3, "digest3": digest_c3[:16]}
        tC.manager.close()
        del tC
        if loss_c3 != loss3 or digest_c3 != digest3:
            fail(f"phase C's step 3 (loss {loss_c3!r}, digest "
                 f"{digest_c3[:16]}) differs from A's (loss {loss3!r}, "
                 f"digest {digest3[:16]})")
        say(f"sharding C ({card}): restored B's (2,2) checkpoint onto (1,1) "
            f"in {restore_s:.3f} s ({out['c']['restore_bytes_read']} bytes "
            f"read), first step done {out['c']['restore_to_first_step_s']:.3f}"
            f" s after the restore began; step 3 loss {loss_c3!r} and "
            "params_digest equal A's bit for bit")
        need = {"a_steps_and_save": ("rmsnorm", "flash_attention",
                                     "gear_scan", "byteplane_fwd",
                                     "rle_emit"),
                "c_restore": ("byteplane_inv",),
                "c_step3": ("rmsnorm", "flash_attention")}
        for seg, kernels in need.items():
            for k in kernels:
                if out["launches"][seg][k] <= 0:
                    fail(f"kernel {k} was not launched in the sharding "
                         f"phase's {seg}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        os.environ.pop("REPRO_CKPT_KEEPALIVE_S", None)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"sharding: launches {json.dumps(out['launches'])} ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 11 — compute with the sharded layout: four ranks share the card
# ---------------------------------------------------------------------------

PAR_MESH = (2, 2)
PAR_WORLD = 4
PAR_STEP = TRAIN_STEPS + 1     # the step after the zoo's last checkpoint
# K8 with q_offset: (B, S, H, K, D, window, softcap, q scale, v scale),
# causal, the rows split four ways over the sequence: llama4-scout's
# training shape, and gemma2-9b's local layer (window 4096) at S 8192 with
# q scaled past its softcap (as ZOO_ATTN)
PAR_ATTN = {"llama4_train_sp4": (4, 1024, 40, 8, 128, 0, 0.0, 1.0, 1.0),
            "gemma2-9b_local_sp4": (1, 8192, 16, 8, 256, 4096, 50.0, 16.0,
                                    0.25)}
# the EP check: one MoE layer of llama4-scout at full width on the
# training batch's 4 × 1024 tokens, over a (1, 4) mesh (4 experts a rank)
PAR_EP_MESH = (1, 4)
PAR_EP_TOKENS = (4, 1024)
PAR_RTOL = 1e-3                # tests/test_torch_train.py:172, bf16
PAR_IO_THREADS = 2             # a rank's restore fetches in flight


def q_offset_parity(dev) -> dict:
    """P0: K8 with ``q_offset`` against its plain version at PAR_ATTN, each
    of the four ranks' row blocks at its offset, within ``attn_err``'s
    bound; the plain output of the same rows without the offset must fail
    that bound (for every rank past the first). Times each rank's launch
    (CUDA events), the plain version and SDPA with the offset's mask
    (none where the row sets a softcap, which SDPA does not take)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    bf = torch.bfloat16
    out = {}
    for name, (B, S, H, K, D, window, cap, qs, vs) in PAR_ATTN.items():
        q = (torch.randn((B, S, H, D), generator=g, device=dev) * qs).to(bf)
        k = torch.randn((B, S, K, D), generator=g, device=dev).to(bf)
        v = (torch.randn((B, S, K, D), generator=g, device=dev) * vs).to(bf)
        n = S // PAR_WORLD
        kw = dict(causal=True, window=window, softcap=cap)
        row = {"shape": [B, S, H, K, D], "rows": n, "window": window,
               "softcap": cap, "ranks": []}
        for r in range(PAR_WORLD):
            off = r * n
            qr = q[:, off:off + n].contiguous()
            ref = fa.flash_attention_plain(qr, k, v, q_offset=off, **kw)
            err, rel = attn_err(fa.flash_attention(qr, k, v, q_offset=off,
                                                   **kw), ref)
            if not (err <= ATTN_TOL["bfloat16"] and rel <= 1.0):
                fail(f"K8 q_offset {name} rank {r} (offset {off}): max abs "
                     f"err {err}, {rel} of the bound")
            rank = {"q_offset": off, "max_abs_err": err, "of_bound": rel}
            if off:
                _, moved = attn_err(fa.flash_attention_plain(qr, k, v, **kw),
                                    ref)
                if not moved > 1.0:
                    fail(f"K8 q_offset {name} rank {r}: the plain output "
                         f"without the offset is within the bound ({moved}"
                         " of it)")
                rank["no_offset_of_bound"] = moved
            flops = 4 * D * B * H * fa.unmasked_pairs(n, S, True, window,
                                                      off)
            moved_b = (2 * qr.numel() + k.numel() + v.numel()) * 2
            rank["flops"] = flops
            rank["bound_ms"] = max(flops / BF16_FLOPS,
                                   moved_b / HBM_BYTES_PER_S) * 1e3
            rank["bound_by"] = "operations" if flops / BF16_FLOPS > \
                moved_b / HBM_BYTES_PER_S else "bytes"
            rank["ms"] = time_ms(lambda: fa.flash_attention(
                qr, k, v, q_offset=off, **kw), iters=20, warmup=2)
            rank["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
                qr, k, v, q_offset=off, **kw), iters=3)
            rank["library_ms"] = None
            if not cap:
                qt, kt, vt = (a.transpose(1, 2).contiguous()
                              for a in (qr, k, v))
                mask = fa._mask(n, S, True, window, dev, off)
                rank["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True),
                    iters=20, warmup=2)
                del qt, kt, vt, mask
            row["ranks"].append(rank)
            del qr, ref
        for key in ("ms", "plain_ms", "bound_ms", "flops"):
            row[key] = sum(x[key] for x in row["ranks"])
        libs = [x["library_ms"] for x in row["ranks"]]
        row["library_ms"] = None if None in libs else sum(libs)
        row["bound_by"] = row["ranks"][0]["bound_by"]
        out[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    say(f"parallel P0: K8 with q_offset at {list(PAR_ATTN)} within "
        f"attn_err's bound, the no-offset controls outside it; "
        f"{json.dumps({n: {k: r[k] for k in ('ms', 'plain_ms', 'bound_ms', 'library_ms')} for n, r in out.items()})}")
    return out


def _probe_collectives(dev) -> dict:
    """The four collectives of ``sharding.collectives`` on CUDA tensors
    over the world's gloo group: all-gather, reduce-scatter, all-to-all
    and all-reduce, each checked against the values it must give."""
    import torch
    import torch.distributed as dist

    from repro_torch.sharding import collectives as C
    r, n = dist.get_rank(), dist.get_world_size()
    grp = dist.group.WORLD
    x = torch.full((4, 3), float(r + 1), device=dev)
    got = {
        "all_gather": C.all_gather(x, grp, 0),
        "reduce_scatter": C.reduce_scatter(
            torch.arange(4 * n * 3, device=dev, dtype=torch.float32)
            .view(4 * n, 3) * (r + 1), grp, 0),
        "all_to_all": C.all_to_all(
            torch.arange(n, device=dev, dtype=torch.float32) + 10 * r, grp),
        "all_reduce": C.all_reduce(x, grp)}
    tri = n * (n + 1) // 2
    want = {
        "all_gather": torch.arange(1, n + 1, device=dev).float()
        .repeat_interleave(4)[:, None].expand(4 * n, 3),
        "reduce_scatter": torch.arange(4 * n * 3, device=dev).float()
        .view(4 * n, 3)[4 * r:4 * r + 4] * tri,
        "all_to_all": torch.arange(n, device=dev).float() * 10 + r,
        "all_reduce": torch.full((4, 3), float(tri), device=dev)}
    return {k: bool(got[k].device == x.device and torch.equal(got[k],
                                                               want[k]))
            for k in got}


def _ep_check(dev) -> dict:
    """P2: ``moe_apply_shard_map`` over the (1, 4) mesh against
    ``moe.moe_groups`` (``moe_apply`` without the shared expert) on one
    rank, llama4-scout's MoE layer at full width with ``capacity_factor =
    n_experts`` (nothing drops), bf16 weights from a seed."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import moe_groups
    from repro_torch.models.moe_shard_map import moe_apply_shard_map
    from repro_torch.sharding.partition import mesh_axes
    base = get_config(ZOO_ARCH)
    m = base.moe
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        m, capacity_factor=float(m.n_experts)))
    mesh = make_host_mesh(PAR_EP_MESH, ("data", "model"), device=dev)
    ax = mesh_axes(mesh)
    mi = mesh.get_coordinate()[1]
    E, D, Fd = m.n_experts, base.d_model, m.d_expert
    El = E // ax.tp
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    bf = torch.bfloat16

    def randn(*shape, s):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    x = randn(*PAR_EP_TOKENS, D, s=1.0)
    router = randn(D, E, s=D ** -0.5)
    full = {"wg": [], "wu": [], "wd": []}
    mine = {"wg": [], "wu": [], "wd": []}
    for e in range(E):
        for k, shape, s in (("wg", (D, Fd), D ** -0.5),
                            ("wu", (D, Fd), D ** -0.5),
                            ("wd", (Fd, D), Fd ** -0.5)):
            w = randn(*shape, s=s)
            if mi * El <= e < (mi + 1) * El:
                mine[k].append(w)
            if mi == 0:
                full[k].append(w)
    params = {"router": router, **{k: torch.stack(v) for k, v in
                                   mine.items()}}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    y, aux = moe_apply_shard_map(params, x, cfg, mesh, ax)
    torch.cuda.synchronize()
    out = {"mesh": list(PAR_EP_MESH), "tokens": list(PAR_EP_TOKENS),
           "seconds": time.monotonic() - t0,
           "aux": {k: float(v) for k, v in aux.items()}}
    if mi == 0:
        ref, raux = moe_groups({"router": router, **{
            k: torch.stack(v) for k, v in full.items()}}, x, cfg)
        rf = ref.float()
        err = (y.float() - rf).abs()
        bound = rf.abs() * 2.0 ** -7 + PAR_RTOL * rf.pow(2).mean().sqrt()
        out["y_max_abs_err"] = err.max().item()
        out["y_of_bound"] = (err / bound).max().item()
        out["ref_aux"] = {k: float(v) for k, v in raux.items()}
        out["aux_rel"] = {k: abs(out["aux"][k] - out["ref_aux"][k])
                          / max(abs(out["ref_aux"][k]), 1e-12)
                          for k in ("load_balance_loss", "router_z_loss")}
        out["ok"] = out["y_of_bound"] <= 1.0 and \
            all(v <= PAR_RTOL for v in out["aux_rel"].values()) and \
            out["aux"]["drop_fraction"] == out["ref_aux"]["drop_fraction"]
    return out


def parallel_rank(root: Path) -> int:
    """One of the four ranks of P1/P2 (``--parallel-rank``, spawned by
    ``parallel``), each a process on the one card in a gloo group (NCCL
    refuses two ranks on one card): checks the collectives on CUDA
    tensors, restores the zoo's step-4 checkpoint onto the (2,2) mesh
    through ``Trainer(mesh=)`` with llama4-scout's preset (K4 decodes its
    params shards), takes step 5 with the layout step, then runs the EP
    check. Prints one RESULT line."""
    import dataclasses

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / "rendezvous_par"), world),
        rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.configs.presets import preset_overrides
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import Trainer, TrainerConfig

    out = {"rank": rank, "probe": _probe_collectives(dev)}
    mesh = make_host_mesh(PAR_MESH, ("data", "model"), device=dev)
    cfg = dataclasses.replace(get_config(ZOO_ARCH), n_layers=ZOO_LAYERS,
                              **preset_overrides(ZOO_ARCH))
    # two fetches in flight a rank: each rank decodes all ~13 GB of the
    # zoo's one-shard leaves on the host, four ranks at once
    tcfg = TrainerConfig(workdir=str(root / "b"), log_every=1, **TRAIN,
                         **{**TRAIN_CKPT, "io_threads": PAR_IO_THREADS})
    t = Trainer(cfg, tcfg, store=TieredStore(Tier("fast", root / "b")),
                device=dev, mesh=mesh)
    reset_counts()
    t0 = time.monotonic()
    t.init_or_restore()
    torch.cuda.synchronize()
    out["restore_s"] = time.monotonic() - t0
    out["restored_from"] = t.restored_from
    out["restore_bytes_read"] = t.manager.bytes_read
    out["launches_restore"] = read_counts()
    out["local_param_bytes"] = sum(
        x.to_local().nbytes for x in _leaves(t.state["params"]))
    out["local_state_bytes"] = sum(
        x.to_local().nbytes for x in _leaves(t.state))
    out["peak_restore_bytes"] = torch.cuda.max_memory_allocated(dev)
    # the step's peak device bytes by part: forward and backward (up to
    # the gradient norm), the norm, the optimizer's update
    peaks = {}

    def mark(part):
        torch.cuda.synchronize()
        peaks[part] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    from repro_torch.train import steps as steps_mod
    norm, update = steps_mod.global_norm, t.optimizer.update

    def marked_norm(*a, **kw):
        mark("forward_backward")
        n = norm(*a, **kw)
        mark("grad_norm")
        return n

    def marked_update(*a, **kw):
        res = update(*a, **kw)
        mark("update")
        return res

    steps_mod.global_norm, t.optimizer.update = marked_norm, marked_update
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t.fit(PAR_STEP, stop_after=1)
    torch.cuda.synchronize()
    steps_mod.global_norm = norm
    out["launches_step"] = read_counts()
    mark("rest")
    out["peak_by_part"] = peaks
    out["peak_device_bytes"] = max(peaks.values())
    h = t.history[-1]
    out.update(step=h["step"], loss=h["loss"], grad_norm=h["grad_norm"],
               step_s=h["step_s"])
    t.manager.close()
    del t
    torch.cuda.empty_cache()
    out["ep"] = _ep_check(dev)
    print("RESULT::" + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel(dev, card: str, zoo_stats: dict) -> dict:
    """Phase 11, computing with the sharded layout.

    P0. K8 with ``q_offset`` (``q_offset_parity``).
    P1. Four ranks share the card (``--parallel-rank``; the parent frees
        its card memory first): the gloo collectives on CUDA tensors,
        then the zoo's step-4 checkpoint restored onto a (2,2)
        ``("data", "model")`` mesh (llama4-scout at full width, 2 of 48
        layers, its preset: ``seq_shard_resid``), and step 5 with the
        layout step. Each rank's loss and grad_norm must equal the zoo's
        run A at step 5 within ``PAR_RTOL``, its peak device bytes must
        stay below the full bf16 parameter tree's, and K4 (restore), K7
        and K8 (step) must launch in every rank.
    P2. ``moe_apply_shard_map`` over four ranks against ``moe_apply``'s
        routed experts on one (``_ep_check``).
    Removes the zoo's workdir when it ends."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    root = ROOT / "build" / "chip_smoke_zoo"
    cfg = get_config(ZOO_ARCH)
    out = {"arch": cfg.arch_id, "n_layers": ZOO_LAYERS, "mesh": list(PAR_MESH),
           "world": PAR_WORLD, "card": card, "step": PAR_STEP}
    try:
        t0 = time.monotonic()
        out["q_offset"] = q_offset_parity(dev)
        out["p0_s"] = time.monotonic() - t0
        abstract = Model(dataclasses.replace(
            cfg, n_layers=ZOO_LAYERS)).abstract_params()
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in _leaves(abstract))
        ref = {h["step"]: h for h in zoo_stats["next"]}[PAR_STEP]
        out["run_a"] = ref
        torch.cuda.empty_cache()
        out["parent_device_bytes"] = torch.cuda.memory_allocated(dev)
        t0 = time.monotonic()
        ranks = _spawn_ranks("--parallel-rank", root, PAR_WORLD, 900,
                             {"REPRO_CKPT_KEEPALIVE_S": "120"})
        out["p1_p2_wall_s"] = time.monotonic() - t0
        out["ranks"] = ranks
        (ROOT / "chiprun_out" / "chip_smoke_parallel_ranks.json").write_text(
            json.dumps(out, indent=1))
        for r in ranks:
            if not all(r["probe"].values()):
                fail(f"parallel rank {r['rank']}: gloo collectives on CUDA "
                     f"tensors gave wrong values: {r['probe']}")
            if r["restored_from"] != TRAIN_STEPS or r["step"] != PAR_STEP:
                fail(f"parallel rank {r['rank']} restored step "
                     f"{r['restored_from']} and took step {r['step']}")
            for key in ("loss", "grad_norm"):
                rel = abs(r[key] - ref[key]) / abs(ref[key])
                r[f"{key}_rel_diff"] = rel
                if not rel <= PAR_RTOL:
                    fail(f"parallel rank {r['rank']}: step {PAR_STEP} {key} "
                         f"{r[key]!r} vs run A's {ref[key]!r} (rel {rel})")
            if not r["peak_device_bytes"] < out["param_bytes"]:
                fail(f"parallel rank {r['rank']}: peak device bytes "
                     f"{r['peak_device_bytes']} not below the full "
                     f"parameter tree's {out['param_bytes']}")
            for seg, kernels in (("launches_restore", ("byteplane_inv",)),
                                 ("launches_step", ("rmsnorm",
                                                    "flash_attention"))):
                for k in kernels:
                    if r[seg][k] <= 0:
                        fail(f"parallel rank {r['rank']}: kernel {k} was not "
                             f"launched in its {seg[9:]}")
        ep = ranks[0]["ep"]
        if not ep.get("ok"):
            fail(f"parallel P2: moe_apply_shard_map differs from moe_apply "
                 f"beyond the bf16 tolerance: {json.dumps(ep)}")
        out["launches"] = {
            "restore": _sum_counts(*[r["launches_restore"] for r in ranks]),
            "step": _sum_counts(*[r["launches_step"] for r in ranks])}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"parallel ({card}): {PAR_WORLD} ranks on one card, mesh "
        f"{PAR_MESH}: restore s {[round(r['restore_s'], 3) for r in ranks]}, "
        f"step {PAR_STEP} s {[round(r['step_s'], 3) for r in ranks]}, peak "
        f"bytes {[r['peak_device_bytes'] for r in ranks]} (full params "
        f"{out['param_bytes']}), loss rel diff "
        f"{[r['loss_rel_diff'] for r in ranks]}, grad_norm rel diff "
        f"{[r['grad_norm_rel_diff'] for r in ranks]}; EP "
        f"{json.dumps(ep)}")
    return out

# ---------------------------------------------------------------------------
# phase 12 — the compile-side tools: the dry run against the card, serving
# on the sharded layout, the AOT program cache, the registered ops' cost
# ---------------------------------------------------------------------------

# the parallel phase's cell as the dry run traces it: llama4-scout at its
# ZOO_LAYERS, the preset, the training batch over PAR_MESH, no exec mesh
# (the Trainer sets none)
PEAK_RTOL = 0.25               # predicted step peak vs measured, a rank
COMPILE_SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # gemma3-1b
# serving on the layout: gemma3-1b at full width, MESH_SERVE_LAYERS (one
# period of its five-local, one-global attention pattern, so that the
# global layer's full-length cache is sharded too), four prompts of 1,024
# tokens, past the 512 window, and eight decode steps, the one-device
# run's tokens forced, on each mesh over four ranks sharing the card
MESH_SERVE_LAYERS = 6
MESH_SERVE = dict(batch=4, prompt_len=1024, steps=8, seed=5)
MESH_SERVE_MESHES = ((2, 2), (1, 4))
MESH_SERVE_CACHE = MESH_SERVE["prompt_len"] + MESH_SERVE["steps"]
# a logit's difference from the one-device run's, over the largest
# reference logit: bf16 activations whose row-parallel partial sums are
# added across ranks in f32 and rounded once (PERF.md §6)
MESH_SERVE_RTOL = 2e-2
AOT_TAG = "gemma3-1b-prefill"
OP_COST_CALLS = 5000           # K7 calls timed a round (host µs a call)
OP_COST_ROUNDS = 10            # alternating rounds of the three ways
# C4's serving runs: the serving phase's traffic with 32 generated tokens
# of 64 (30 runs of 64 took 98 s of the script's limit)
OP_COST_SERVE = dict(SERVE, gen_len=32)


def _gemma_serve_model():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    return Model(dataclasses.replace(get_config("gemma3-1b"),
                                     n_layers=MESH_SERVE_LAYERS))


def _serve_tokens(dev, vocab: int):
    import torch
    g = torch.Generator().manual_seed(MESH_SERVE["seed"])
    return torch.randint(0, vocab, (MESH_SERVE["batch"],
                                    MESH_SERVE["prompt_len"]),
                         generator=g).to(dev)


def mesh_serve_reference(dev, root: Path) -> dict:
    """The one-device serve the mesh ranks are held to: prefill and
    ``MESH_SERVE["steps"]`` decode steps of greedy tokens; writes tokens,
    logits and next tokens to ``root/mesh_serve_ref.pt``."""
    import torch
    model = _gemma_serve_model()
    params = model.init(seed=MESH_SERVE["seed"], device=dev)
    tokens = _serve_tokens(dev, model.cfg.vocab_size)
    t0 = time.monotonic()
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens,
                                      cache_len=MESH_SERVE_CACHE)
        ref = {"tokens": tokens.cpu(), "logits": [logits.cpu()],
               "next": [logits.argmax(-1).int().cpu()]}
        for _ in range(MESH_SERVE["steps"]):
            logits, cache = model.decode_step(params, cache,
                                              ref["next"][-1].to(dev))
            ref["logits"].append(logits.cpu())
            ref["next"].append(logits.argmax(-1).int().cpu())
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    torch.save(ref, root / "mesh_serve_ref.pt")
    del params, cache
    torch.cuda.empty_cache()
    return {"seconds": seconds}


def _local_tree(tree, specs: dict, prefix: str = ""):
    """This rank's block of every leaf of `tree` under `specs` (leaf name →
    ``NamedSharding``), each a contiguous copy."""
    out = {}
    for k, t in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(t, dict):
            out[k] = _local_tree(t, specs, name)
            continue
        rng = specs[name].local_range(tuple(t.shape))
        out[k] = t[tuple(slice(a, b) for a, b in
                         zip(rng.start, rng.stop))].contiguous()
    return out


def serve_rank(root: Path) -> int:
    """One of the four ranks serving on the sharded layout (``--serve-
    rank``, spawned by ``mesh_serving``), a process on the one card in a
    gloo group: for each of ``MESH_SERVE_MESHES``, its shards of the
    seeded gemma3-1b params, ``parallel.prefill`` of its rows and
    ``MESH_SERVE["steps"]`` ``parallel.decode_step``s with the one-device
    run's tokens forced; each step's logits against the one-device run's
    rows. Prints one RESULT line."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / "rendezvous_serve"), world),
        rank=rank, world_size=world)
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import parallel
    from repro_torch.sharding.partition import param_specs
    ref = torch.load(root / "mesh_serve_ref.pt")
    model = _gemma_serve_model()
    full = model.init(seed=MESH_SERVE["seed"], device=dev)
    B = MESH_SERVE["batch"]
    out = {"rank": rank, "meshes": []}
    for shape in MESH_SERVE_MESHES:
        mesh = make_host_mesh(shape, ("data", "model"), device=dev)
        params = _local_tree(full, dict(leaf_paths(param_specs(
            model.abstract_params(), mesh))))
        lay = parallel.serve_layout(model.cfg, mesh, B, MESH_SERVE_CACHE)
        lo, hi = parallel.batch_rows(lay, B)
        errs = []

        def check(logits, i):
            want = ref["logits"][i][lo:hi].to(dev)
            errs.append([(logits - want).abs().max().item(),
                         want.abs().max().item()])

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with torch.no_grad():
            logits, cache = parallel.prefill(
                model, params, ref["tokens"][lo:hi].to(dev), lay,
                cache_len=MESH_SERVE_CACHE)
            torch.cuda.synchronize()
            prefill_s = time.monotonic() - t0
            check(logits, 0)
            t1 = time.monotonic()
            for i in range(MESH_SERVE["steps"]):
                logits, cache = parallel.decode_step(
                    model, params, cache, ref["next"][i][lo:hi].to(dev), lay)
                check(logits, i + 1)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t1
        out["meshes"].append({
            "mesh": list(shape), "rows": [lo, hi], "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_tok_per_s":
            (hi - lo) * MESH_SERVE["steps"] / decode_s,
            "max_abs_err": [e[0] for e in errs],
            "rel_err": max(e[0] / e[1] for e in errs),
            "launches": read_counts(),
            "local_param_bytes": sum(t.nbytes for t in _leaves(params))})
        del params, cache
        torch.cuda.empty_cache()
    print("RESULT::" + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_ranks(flag: str, root: Path, world: int, timeout: int,
                 env: dict | None = None) -> list:
    """`world` processes of ``chip_smoke.py flag root`` on the card (`env`
    added to theirs), stdout and stderr in files under `root` (a rank
    blocked on a full pipe would stall its peers); their RESULT lines (a
    failing rank's stderr fails the script)."""
    env = {**os.environ, "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 4) // world)),
           **(env or {})}
    logs = [open(root / f"{flag[2:]}{r}.log", "w+") for r in range(world)]
    outs = [open(root / f"{flag[2:]}{r}.out", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(root)],
        stdout=outs[r], stderr=logs[r], env={**env, "RANK": str(r)})
        for r in range(world)]
    try:
        res = []
        for r, p in enumerate(procs):
            p.wait(timeout=timeout)
            logs[r].seek(0)
            outs[r].seek(0)
            err, text = logs[r].read(), outs[r].read()
            if p.returncode:
                fail(f"{flag} rank {r} exited {p.returncode}; its stderr "
                     f"ends:\n{err[-4000:]}")
            res.append(json.loads(next(
                line for line in text.splitlines()
                if line.startswith("RESULT::"))[len("RESULT::"):]))
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def mesh_serving(dev, root: Path) -> dict:
    """Serving on the sharded layout: the one-device reference here, then
    four ranks (``--serve-rank``) on each mesh; every step's logits within
    ``MESH_SERVE_RTOL`` of the reference's largest, K7 and K8 launched in
    every rank's prefill."""
    out = {"reference": mesh_serve_reference(dev, root), **MESH_SERVE,
           "meshes": [list(m) for m in MESH_SERVE_MESHES],
           "rtol": MESH_SERVE_RTOL}
    t0 = time.monotonic()
    ranks = _spawn_ranks("--serve-rank", root, PAR_WORLD, 600)
    out["ranks_wall_s"] = time.monotonic() - t0
    out["ranks"] = ranks
    for r in ranks:
        for m in r["meshes"]:
            if not m["rel_err"] <= MESH_SERVE_RTOL:
                fail(f"mesh serving {m['mesh']} rank {r['rank']}: logits "
                     f"{m['rel_err']} of the largest from the one-device "
                     f"run's (bound {MESH_SERVE_RTOL}): {m['max_abs_err']}")
            for k in ("rmsnorm", "flash_attention"):
                if m["launches"][k] <= 0:
                    fail(f"mesh serving {m['mesh']} rank {r['rank']}: "
                         f"kernel {k} was not launched")
    out["rel_err"] = {str(m): max(x["rel_err"] for r in ranks
                                  for x in r["meshes"] if x["mesh"] == m)
                      for m in out["meshes"]}
    return out


def _aot_prefill(dev):
    """(prefill function, params, tokens) of the AOT check: gemma3-1b at
    full width, MESH_SERVE_LAYERS, seeded, on the card."""
    model = _gemma_serve_model()
    params = model.init(seed=MESH_SERVE["seed"], device=dev)
    tokens = _serve_tokens(dev, model.cfg.vocab_size)

    def prefill(p, t):
        return model.prefill(p, t, cache_len=MESH_SERVE_CACHE)

    return prefill, params, tokens


def aot_load(root: Path) -> int:
    """The AOT cache's second bring-up (``--aot-load``, a fresh process):
    load the exported prefill (must hit), run it, compare it with the
    eager prefill here and the parent's; read K7/K8's launches in the
    program's run. Prints one RESULT line."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.aot_cache import AotCache
    from repro_torch.core.split_state import leaf_paths
    dev = torch.device("cuda")
    t0 = time.monotonic()
    prefill, params, tokens = _aot_prefill(dev)
    cache = AotCache(root / "aot")
    t1 = time.monotonic()
    program, source = cache.load_or_compile(prefill, (params, tokens),
                                            tag=AOT_TAG)
    load_s = time.monotonic() - t1
    reset_counts()
    with torch.no_grad():
        got = program(params, tokens)
        torch.cuda.synchronize()
        launches = read_counts()
        want = prefill(params, tokens)
    parent = torch.load(root / "aot_eager.pt")
    equal = torch.equal(got[0], want[0]) and all(
        torch.equal(a, b) for (_, a), (_, b) in
        zip(leaf_paths(got[1]), leaf_paths(want[1])))
    print("RESULT::" + json.dumps({
        "source": source, "load_s": load_s, "stats": cache.stats,
        "setup_s": t1 - t0, "launches": launches,
        "equal_eager": bool(equal),
        "equal_parent": bool(torch.equal(got[0].cpu(), parent)),
        "max_abs_err": (got[0] - want[0]).abs().max().item()}), flush=True)
    return 0


def aot_check(dev, root: Path) -> dict:
    """Export gemma3-1b's one-device prefill into an empty ``AotCache`` (a
    miss), then load it in a fresh process (``--aot-load``): a hit whose
    outputs equal the eager prefill's, with K7 and K8 launched by the
    loaded program."""
    import torch

    from repro_torch.core.aot_cache import AotCache
    prefill, params, tokens = _aot_prefill(dev)
    cache = AotCache(root / "aot")
    t0 = time.monotonic()
    _, source = cache.load_or_compile(prefill, (params, tokens), tag=AOT_TAG)
    compile_s = time.monotonic() - t0
    if source != "compile":
        fail(f"AOT cache: an empty cache gave {source!r}")
    with torch.no_grad():
        torch.save(prefill(params, tokens)[0].cpu(), root / "aot_eager.pt")
    del params
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--aot-load", str(root)], capture_output=True,
                       text=True, timeout=600)
    wall_s = time.monotonic() - t0
    if p.returncode:
        fail(f"AOT load process exited {p.returncode}: {p.stderr[-4000:]}")
    res = json.loads(next(line for line in p.stdout.splitlines()
                          if line.startswith("RESULT::"))[len("RESULT::"):])
    out = {"compile_s": compile_s, "stats": cache.stats,
           "bytes": sum(f.stat().st_size for f in (root / "aot").iterdir()),
           "load_process_s": wall_s, **{f"load_{k}": v for k, v in
                                        res.items()}}
    if res["source"] != "cache":
        fail(f"AOT cache: the fresh process did not hit: {res}")
    if not (res["equal_eager"] and res["equal_parent"]):
        fail(f"AOT cache: the loaded program's prefill differs from the "
             f"eager one: {res}")
    for k in ("rmsnorm", "flash_attention"):
        if res["launches"][k] <= 0:
            fail(f"AOT cache: the loaded program launched no {k}")
    return out


def _spread(xs) -> dict:
    xs = sorted(xs)
    n = len(xs)
    med = xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2
    return {"median": med, "min": xs[0], "max": xs[-1], "n": n}


def op_cost(dev, serves: bool = False) -> dict:
    """The registered operators' host cost, three ways, alternating in
    ``OP_COST_ROUNDS`` rounds: "op" forces every K7 call through the
    dispatcher (``rn.untraced`` false), "entry" is the model's entry as it
    ships (``rn.rmsnorm``: the CUDA implementation without the dispatcher
    on an untraced tensor), "direct" calls the kernels' wrappers with no
    operator at all (the path before the operators). Host µs a K7 call
    at the decode step's block-norm shape (8 rows of 1,152, bf16,
    ``OP_COST_CALLS`` calls a round); with `serves` (``--op-cost``) also
    serving's decode tokens/s (one serving run a way a round,
    ``OP_COST_SERVE``: 30 serves, ~50 s, a measurement with no check);
    medians with their min and max."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.launch import serve
    x = torch.randn((8, 1, 1152), device=dev).to(torch.bfloat16)
    s = torch.randn((1152,), device=dev).to(torch.bfloat16)
    rms = rn.op()
    calls = {"op": lambda: rms(x, s, 1e-6), "entry": lambda: rn.rmsnorm(x, s),
             "direct": lambda: rn.rmsnorm_fused(x, s)}
    us = {k: [] for k in calls}
    for _ in range(OP_COST_ROUNDS):
        for k, fn in calls.items():
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OP_COST_CALLS):
                fn()
            us[k].append((time.perf_counter() - t0) / OP_COST_CALLS * 1e6)
            torch.cuda.synchronize()
    out = {"k7_host_us": {k: _spread(v) for k, v in us.items()},
           "k7_host_us_rounds": us, "serve_rounds": serves}
    if not serves:
        return out
    root = ROOT / "build" / "chip_smoke_opcost"
    saved = (rn.op, fa.op, rn.untraced)

    def direct_fa(q, k, v, causal, window, softcap, scale, q_offset):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=q_offset)

    tok = {k: [] for k in calls}
    try:
        for i in range(OP_COST_ROUNDS):
            for way in calls:
                if way == "op":
                    rn.untraced = lambda t: False
                elif way == "direct":
                    rn.op = lambda: (lambda a, b, eps: rn.rmsnorm_fused(
                        a, b, eps=eps))
                    fa.op = lambda: direct_fa
                res = serve.run("gemma3-1b",
                                workdir=str(root / f"{way}{i}"),
                                device=dev, **OP_COST_SERVE)
                rn.op, fa.op, rn.untraced = saved
                tok[way].append(res["tok_per_s"])
    finally:
        rn.op, fa.op, rn.untraced = saved
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(Path("/dev/shm") / f"repro-bb-{os.getpid()}",
                      ignore_errors=True)
    out["decode_tok_per_s"] = {k: _spread(v) for k, v in tok.items()}
    out["decode_tok_per_s_rounds"] = tok
    return out


def compile_phase(dev, card: str, par: dict | None,
                  op_cost_serves: bool = False) -> dict:
    """Phase 12, the compile-side tools.

    C1. The dry run (``launch.dryrun.run_cell``) traces each of the four
        ranks of the parallel phase's cell on fake tensors; with `par`
        (the parallel phase's record) each rank's predicted step peak must
        be within ``PEAK_RTOL`` of its measured ``peak_device_bytes`` and
        its state bytes equal the measured local state's (both printed by
        part). Then gemma3-1b's ``COMPILE_SHAPES`` on (16, 16).
    C2. Serving on the sharded layout (``mesh_serving``).
    C3. The AOT program cache (``aot_check``).
    C4. The registered operators' host cost (``op_cost``; its serving
        rounds with `op_cost_serves`, ``--op-cost``)."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.configs.presets import preset_overrides
    from repro_torch.launch.dryrun import run_cell
    root = ROOT / "build" / "chip_smoke_compile"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"card": card}
    try:
        t0 = time.monotonic()
        cell = ShapeSpec("parallel_step", TRAIN["seq_len"], TRAIN["batch"],
                         "train")
        # the Trainer sets no exec mesh, so the preset's shard_map runs
        # ``moe_apply``: the route that "gspmd" names
        over = {"n_layers": ZOO_LAYERS, **preset_overrides(ZOO_ARCH),
                "moe_impl": "gspmd"}
        preds = [run_cell(ZOO_ARCH, None, "single", shape=cell,
                          mesh_shape=PAR_MESH, overrides=over, rank=r)
                 for r in range(PAR_WORLD)]
        for rec in preds:
            if rec["status"] != "ok":
                fail(f"dry run of the parallel cell, rank {rec['rank']}: "
                     f"{rec.get('error')}\n{rec.get('traceback', '')}")
        cmp = []
        for rec in preds:
            mem = rec["memory"]
            row = {"rank": rec["rank"], "trace_s": rec["trace_s"],
                   "predicted_peak": mem["peak_bytes_est"],
                   "predicted_by_part": mem["peak_by_part"],
                   "predicted_state_bytes": mem["state_bytes"],
                   "predicted_argument_bytes": mem["argument_bytes"]}
            if par is not None:
                meas = par["ranks"][rec["rank"]]
                row.update(measured_peak=meas["peak_device_bytes"],
                           measured_by_part=meas["peak_by_part"],
                           measured_state_bytes=meas["local_state_bytes"])
                row["peak_rel"] = (mem["peak_bytes_est"]
                                   - meas["peak_device_bytes"]) \
                    / meas["peak_device_bytes"]
            cmp.append(row)
        out["parallel_cell"] = cmp
        say(f"compile C1: the parallel cell's prediction against the card "
            f"({card}): {json.dumps(cmp)}")
        for row in cmp:
            if par is None:
                continue
            if not abs(row["peak_rel"]) <= PEAK_RTOL:
                fail(f"dry run: rank {row['rank']}'s predicted step peak "
                     f"{row['predicted_peak']} is {row['peak_rel']:+.3f} "
                     f"from the measured {row['measured_peak']}")
            if row["predicted_state_bytes"] != row["measured_state_bytes"]:
                fail(f"dry run: rank {row['rank']}'s state bytes "
                     f"{row['predicted_state_bytes']} != measured "
                     f"{row['measured_state_bytes']}")
        out["gemma3"] = {}
        for name in COMPILE_SHAPES:
            rec = run_cell("gemma3-1b", name, "single")
            if rec["status"] != "ok":
                fail(f"dry run gemma3-1b × {name}: {rec.get('error')}\n"
                     f"{rec.get('traceback', '')}")
            out["gemma3"][name] = rec
            say(f"compile C1: gemma3-1b × {name} × (16,16): "
                f"{json.dumps(rec)}")
        out["c1_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["mesh_serving"] = mesh_serving(dev, root)
        out["c2_s"] = time.monotonic() - t0
        say(f"compile C2: serving on the layout ({card}): rel err "
            f"{out['mesh_serving']['rel_err']}, ranks "
            f"{json.dumps(out['mesh_serving']['ranks'])}")
        t0 = time.monotonic()
        out["aot"] = aot_check(dev, root)
        out["c3_s"] = time.monotonic() - t0
        say(f"compile C3: AOT cache ({card}): {json.dumps(out['aot'])}")
        t0 = time.monotonic()
        out["op_cost"] = op_cost(dev, op_cost_serves)
        out["c4_s"] = time.monotonic() - t0
        say(f"compile C4: registered-op cost ({card}): "
            f"{json.dumps(out['op_cost'])}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# phase 13 — the SSM and RG-LRU mixers split over the TP axis: four ranks
# share the card on a (1, 4) mesh
# ---------------------------------------------------------------------------

MIXER_MESH = (1, 4)
MIXER_WORLD = 4
# full width, cut in depth: mamba2-780m at 2 of 48 layers (SSD chunk 256),
# recurrentgemma-9b at 3 of 38 (RG-LRU, RG-LRU, local attention) with
# sequences of 4,096 past its 2,048 window; (batch, seq) of the layout
# step and of the served prompts
MIXER_CELLS = {"mamba2-780m": dict(layers=2, train=(4, 2048),
                                   serve=(4, 2048)),
               "recurrentgemma-9b": dict(layers=3, train=(1, 4096),
                                         serve=(1, 4096))}
MIXER_SEED = 13
MIXER_STEPS = 8                # decode steps after the prefill
MIXER_REPS = 3                 # timed calls of each mixer


def _mixer_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch),
                               n_layers=MIXER_CELLS[arch]["layers"])


def _mixer_tokens(cfg, shape, salt: int):
    import torch
    g = torch.Generator().manual_seed(MIXER_SEED + salt)
    return torch.randint(0, cfg.vocab_size, shape, generator=g,
                         dtype=torch.int32)


def mixer_reference(dev, arch: str) -> dict:
    """One device's run of a mixer cell: the train step's loss and
    grad_norm from the seeded state, then the seeded params' prefill and
    ``MIXER_STEPS`` greedy decode steps (logits and next tokens), with
    the K7/K8 launches of each and its peak device bytes."""
    import torch

    from repro_torch.core.split_state import init_train_state
    from repro_torch.models import Model
    from repro_torch.models.model import set_constrainer
    from repro_torch.optim import make_optimizer
    from repro_torch.train.steps import make_train_step
    cfg = _mixer_cfg(arch)
    spec = MIXER_CELLS[arch]
    model, opt = Model(cfg), make_optimizer(cfg)
    set_constrainer(None)
    batch = {"tokens": _mixer_tokens(cfg, spec["train"], 0)}
    out = {"arch": arch, "cfg": cfg, "batch": batch,
           "tokens": _mixer_tokens(cfg, spec["serve"], 1)}
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(model, opt, seed=MIXER_SEED, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, m = make_train_step(model, opt)(
        state, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    out["train"] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "step_s": time.monotonic() - t0,
                    "launches": read_counts(),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    del state, m
    torch.cuda.empty_cache()
    params = model.init(seed=MIXER_SEED, device=dev)
    cache_len = spec["serve"][1] + MIXER_STEPS
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        logits, cache = model.prefill(params, out["tokens"].to(dev),
                                      cache_len=cache_len)
        serve = {"logits": [logits.cpu()],
                 "next": [logits.argmax(-1).int().cpu()]}
        for _ in range(MIXER_STEPS):
            logits, cache = model.decode_step(params, cache,
                                              serve["next"][-1].to(dev))
            serve["logits"].append(logits.cpu())
            serve["next"].append(logits.argmax(-1).int().cpu())
    torch.cuda.synchronize()
    serve.update(seconds=time.monotonic() - t0, launches=read_counts(),
                 peak_device_bytes=torch.cuda.max_memory_allocated(dev))
    out["serve"] = serve
    del params, cache
    torch.cuda.empty_cache()
    return out


def _bf16_spacing(v) -> float:
    """The gap between adjacent bf16 values at magnitude `v`."""
    return 2.0 ** (math.floor(math.log2(float(v))) - 7)


def _shards(local_tree, abstract):
    """This rank's blocks (`local_tree`) as the layout step reads a sharded
    state: each its block and the global shape of `abstract`'s leaf
    (``launch.dryrun.Shard``, the two attributes of a ``DTensor`` that the
    step uses)."""
    from repro_torch.core.split_state import leaf_paths, tree_unflatten
    from repro_torch.launch.dryrun import Shard
    ab = dict(leaf_paths(abstract))
    return tree_unflatten(local_tree, [Shard(t, ab[n].shape)
                                       for n, t in leaf_paths(local_tree)])


def _timed(fn, dev, reps: int) -> float:
    """Seconds a call of `fn` (after one warm-up call), the card synced."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.monotonic() - t0) / reps


def _mixer_times(model, lay, params, dev, ref_shape) -> dict:
    """The first mixer block of the stack, at the served prompts' shape:
    the program's split mixer (``parallel._mixer`` on this rank's gathered
    shares, its collectives over gloo included), every rank at once; its
    compute alone (``split_compute_s``: the same forward on the rank's
    shares, each rank in turn while the others wait, the output's
    all-reduce left out and the gated norm's all-gather replaced by a
    local copy of the rank's columns into zeroed whole rows, the same
    bytes); the whole-leaf mixer (``ssd_forward``/``rglru_forward`` on
    the leaves gathered over every axis) on rank 0 alone, the others
    waiting, and on every rank at once (the replicated layout's work).
    Also the split output's largest difference from the whole one, over
    the whole one's largest."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import RGLRU
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.models import layers, parallel, rglru, ssm
    cfg = model.cfg
    stage = model.stages[0]
    j = next(i for i, k in enumerate(stage.kinds)
             if k not in parallel.ATTN)
    kind, key = stage.kinds[j], "rglru" if stage.kinds[j] == RGLRU else "ssm"
    flat = leaf_paths(params["stage_0"])
    names = [n for n, _ in flat if n.startswith(f"b{j}/{key}/")]
    leaves = [t[0] for n, t in flat if n in names]
    g = torch.Generator(device=dev).manual_seed(MIXER_SEED + 2)
    x = torch.randn((*ref_shape, cfg.d_model), generator=g,
                    device=dev).to(getattr(torch, cfg.dtype))
    with torch.no_grad():
        p, split = parallel._gather(lay, "stage_0", names, leaves)
        sub = {n.split("/", 1)[1] for n in split}
        whole = {n.rsplit("/", 1)[1]: parallel._param(
            lay, f"stage_0/{n}", t, full=True, layer=True)[0]
            for n, t in zip(names, leaves)}
        fwd = rglru.rglru_forward if kind == RGLRU else ssm.ssd_forward
        out = {"kind": kind, "split": sorted(sub)}

        def split_fn():
            return parallel._mixer(cfg, p[f"b{j}"], lay, sub, x, kind)

        def whole_fn():
            return fwd(whole, x, cfg)

        pm, kw, _ = parallel._mixer_params(cfg, p[f"b{j}"], lay, sub, kind)
        if "norm" in kw:
            lo = kw["norm"].args[1]

            def local_norm(g, scale):
                rows = g.new_zeros((*g.shape[:-1], scale.shape[0]))
                rows[..., lo:lo + g.shape[-1]] = g
                return layers.rmsnorm(rows, scale)[..., lo:lo + g.shape[-1]]

            kw = {"norm": local_norm}

        def compute_fn():
            return fwd(pm, x, cfg, **kw)

        want = whole_fn().float()
        out["rel_err"] = float((split_fn().float() - want).abs().max()
                               / want.abs().max())
        dist.barrier()
        out["split_s"] = _timed(split_fn, dev, MIXER_REPS)
        for r in range(dist.get_world_size()):
            dist.barrier()
            if dist.get_rank() == r:
                out["split_compute_s"] = _timed(compute_fn, dev, MIXER_REPS)
        dist.barrier()
        if dist.get_rank() == 0:
            out["whole_alone_s"] = _timed(whole_fn, dev, MIXER_REPS)
        dist.barrier()
        out["whole_s"] = _timed(whole_fn, dev, MIXER_REPS)
        dist.barrier()
    return out


def _mixer_cell(ref: dict, mesh, dev) -> dict:
    """One mixer cell on this rank (``mixers_rank``): its shards of the
    seeded params; the prefill and decode steps on the layout with the
    one-device run's tokens forced, each step's logits against the
    reference's rows and their argmax against its next tokens; the
    mixer's times (``_mixer_times``); the layout step from the seeded
    state (moments of this rank's shards only); K7/K8 launches and the
    rank's peak device bytes."""
    import torch

    from repro_torch.core.split_state import (abstract_train_state,
                                              leaf_paths, state_shardings)
    from repro_torch.models import Model, parallel
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding.partition import batch_spec, param_specs
    from repro_torch.train.steps import make_train_step
    cfg = ref["cfg"]
    model, opt = Model(cfg), make_optimizer(cfg)
    out = {"arch": cfg.arch_id, "seconds": {}}
    t_cell = time.monotonic()
    full = model.init(seed=MIXER_SEED, device=dev)
    params = _local_tree(full, dict(leaf_paths(param_specs(
        model.abstract_params(), mesh))))
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out["seconds"]["init"] = time.monotonic() - t_cell
    # serving on the layout
    B, S = ref["tokens"].shape
    cache_len = S + MIXER_STEPS
    lay = parallel.serve_layout(cfg, mesh, B, cache_len)
    lo, hi = parallel.batch_rows(lay, B)
    sv = ref["serve"]
    errs, same, flips = [], [], []

    def check(logits, i):
        want = sv["logits"][i][lo:hi].to(dev)
        errs.append((logits - want).abs().max().item()
                    / want.abs().max().item())
        got = logits.argmax(-1).int().cpu()
        same.append(bool(torch.equal(got, sv["next"][i][lo:hi])))
        if not same[-1]:
            # each row that picks another token: the reference's gap
            # between its top two logits, the row's largest error, and the
            # spacing of bf16 at the row's largest logit
            top2 = want.topk(2, dim=-1).values
            for b in (got != sv["next"][i][lo:hi]).nonzero()[:, 0].tolist():
                flips.append({"step": i, "row": lo + b, "ref_gap": float(
                    top2[b, 0] - top2[b, 1]), "row_err": float(
                    (logits[b] - want[b]).abs().max()),
                    "bf16_spacing": _bf16_spacing(want[b].abs().max())})

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        logits, cache = parallel.prefill(model, params,
                                         ref["tokens"][lo:hi].to(dev), lay,
                                         cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        check(logits, 0)
        t1 = time.monotonic()
        for i in range(MIXER_STEPS):
            logits, cache = parallel.decode_step(
                model, params, cache, sv["next"][i][lo:hi].to(dev), lay)
            check(logits, i + 1)
    torch.cuda.synchronize()
    out["serve"] = {"rows": [lo, hi], "prefill_s": prefill_s,
                    "decode_s": time.monotonic() - t1, "rel_err": errs,
                    "argmax_equal": same, "flips": flips,
                    "launches": read_counts(),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(
                        dev)}
    del cache
    out["seconds"]["serve"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["mixer"] = _mixer_times(model, lay, params, dev, (B, S))
    out["seconds"]["mixer"] = time.monotonic() - t0
    t0 = time.monotonic()
    # the layout step
    abstract = abstract_train_state(model, opt)
    sh = state_shardings(abstract, mesh, opt)
    local = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev),
             "rng": torch.zeros(2, dtype=torch.int32, device=dev)
             .view(torch.uint32)}
    state = _shards(local, abstract)
    batch = {k: v.to(dev) for k, v in ref["batch"].items()}
    bsh = batch_spec(batch, mesh, cfg)
    lb = _local_tree(batch, bsh)
    step = make_train_step(model, opt, shardings=sh,
                           batch_axes=bsh["tokens"].dim_axes(2)[0])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out["seconds"]["state"] = time.monotonic() - t0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, m = step(state, lb)
    torch.cuda.synchronize()
    out["train"] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "step_s": time.monotonic() - t0,
                    "launches": read_counts(),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(
                        dev)}
    out["local_param_bytes"] = sum(t.nbytes for t in _leaves(params))
    out["local_state_bytes"] = sum(t.nbytes for t in _leaves(local))
    out["peak_device_bytes"] = max(out["serve"]["peak_device_bytes"],
                                   out["train"]["peak_device_bytes"])
    del state, local, params
    torch.cuda.empty_cache()
    out["seconds"]["total"] = time.monotonic() - t_cell
    return out


def mixers_rank(root: Path) -> int:
    """One of the four ranks of the mixers phase (``--mixers-rank``,
    spawned by ``mixers``), a process on the one card in a gloo group
    (NCCL refuses two ranks on one card): each cell of the reference file
    the parent wrote (``_mixer_cell``) on the (1, 4) mesh. Prints one
    RESULT line."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    refs = torch.load(root / "mixers_ref.pt", weights_only=False)
    dev = torch.device(refs["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / "rendezvous_mix"), world),
        rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(MIXER_MESH, ("data", "model"), device=dev)
    out = {"rank": rank, "startup_s": time.monotonic() - T_START}
    out["cells"] = [_mixer_cell(ref, mesh, dev) for ref in refs["cells"]]
    print("RESULT::" + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mixers(dev, card: str) -> dict:
    """Phase 13, the SSM and RG-LRU mixers split over the TP axis.

    One device runs each of ``MIXER_CELLS`` (``mixer_reference``); then
    four ranks (``--mixers-rank``; the parent frees its card memory
    first) run them on the (1, 4) mesh. Each rank's layout step must give
    one device's loss and grad_norm within ``PAR_RTOL``; its prefill and
    decode logits must be within ``MESH_SERVE_RTOL`` of the reference's
    largest with the argmax equal; its mixer must run split (its
    ``A_log`` or ``wx`` split over ``"model"``) and agree with the
    whole-leaf mixer within ``MESH_SERVE_RTOL``; and each rank must launch
    K7 (and K8 where the cell has attention) as often as one device does,
    in the step and in serving."""
    import torch
    root = ROOT / "build" / "chip_smoke_mixers"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"mesh": list(MIXER_MESH), "world": MIXER_WORLD, "card": card,
           "cells": {}}
    try:
        t0 = time.monotonic()
        refs = [mixer_reference(dev, arch) for arch in MIXER_CELLS]
        out["reference_s"] = time.monotonic() - t0
        torch.save({"device": str(dev), "cells": refs},
                   root / "mixers_ref.pt")
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        ranks = _spawn_ranks("--mixers-rank", root, MIXER_WORLD, 600)
        out["ranks_wall_s"] = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (ROOT / "chiprun_out" / "chip_smoke_mixers_ranks.json").write_text(
        json.dumps({"card": card, **out, "ranks": ranks, "reference": [
            {k: r[k] for k in ("arch", "train")} for r in refs]}, indent=1))
    launches = {"train": [], "serve": []}
    for i, ref in enumerate(refs):
        cfg = ref["cfg"]
        kernels = ("rmsnorm", "flash_attention") if any(
            k.startswith("attn") for k in cfg.layer_kinds) else ("rmsnorm",)
        cell = {"n_layers": cfg.n_layers, "train_shape": list(
            ref["batch"]["tokens"].shape), "serve_shape": list(
            ref["tokens"].shape), "decode_steps": MIXER_STEPS,
            "reference": {
                "train": ref["train"],
                "serve": {k: ref["serve"][k] for k in (
                    "seconds", "launches", "peak_device_bytes")}},
            "ranks": [r["cells"][i] for r in ranks]}
        for rk, r in enumerate(cell["ranks"]):
            tag = f"mixers {ref['arch']} rank {rk}"
            for k in ("loss", "grad_norm"):
                want = ref["train"][k]
                r["train"][f"{k}_rel_diff"] = abs(r["train"][k] - want) \
                    / abs(want)
                if not r["train"][f"{k}_rel_diff"] <= PAR_RTOL:
                    fail(f"{tag}: layout step {k} {r['train'][k]!r} vs one "
                         f"device's {want!r}")
            if not max(r["serve"]["rel_err"]) <= MESH_SERVE_RTOL:
                fail(f"{tag}: logits {r['serve']['rel_err']} of the largest "
                     f"from one device's (bound {MESH_SERVE_RTOL})")
            # the argmax must be one device's but at a near tie: a row
            # whose reference top two logits lie within one bf16 spacing
            # of its largest (the activations' precision cannot order them)
            for f in r["serve"]["flips"]:
                if not f["ref_gap"] <= f["bf16_spacing"]:
                    fail(f"{tag}: argmax differs from one device's past a "
                         f"near tie: {json.dumps(f)}")
            mx = r["mixer"]
            if not any(n in mx["split"] for n in ("ssm/A_log", "rglru/wx")):
                fail(f"{tag}: the mixer ran replicated ({mx['split']})")
            if not mx["rel_err"] <= MESH_SERVE_RTOL:
                fail(f"{tag}: split mixer {mx['rel_err']} of the largest "
                     "from the whole-leaf mixer's")
            for seg in ("train", "serve"):
                for k in kernels:
                    got, want = r[seg]["launches"][k], \
                        ref[seg]["launches"][k]
                    if not (got > 0 and got == want):
                        fail(f"{tag}: {k} launched {got} times in the "
                             f"{seg} run, one device {want}")
            launches["train"].append(r["train"]["launches"])
            launches["serve"].append(r["serve"]["launches"])
        out["cells"][ref["arch"]] = cell
    out["launches"] = {seg: _sum_counts(*c) for seg, c in launches.items()}
    say(f"mixers ({card}): {MIXER_WORLD} ranks on one card, mesh "
        f"{MIXER_MESH}: " + "; ".join(
            f"{a}: mixer split s "
            f"{[round(r['mixer']['split_s'], 5) for r in c['ranks']]}, "
            f"its compute alone s "
            f"{[round(r['mixer']['split_compute_s'], 5) for r in c['ranks']]}"
            ", "
            f"whole alone s {c['ranks'][0]['mixer']['whole_alone_s']:.5f}, "
            f"whole every rank s "
            f"{[round(r['mixer']['whole_s'], 5) for r in c['ranks']]}, "
            f"step s {[round(r['train']['step_s'], 3) for r in c['ranks']]}"
            f", peak bytes "
            f"{[r['peak_device_bytes'] for r in c['ranks']]}, loss rel "
            f"{[r['train']['loss_rel_diff'] for r in c['ranks']]}, "
            f"logits rel {max(max(r['serve']['rel_err']) for r in c['ranks'])}"
            f", argmax flips at near ties "
            f"{[f for r in c['ranks'] for f in r['serve']['flips']]}"
            for a, c in out["cells"].items()))
    return out


EXAMPLES_IN_PROCESS = ("quickstart", "preempt_and_resume", "serve_with_cr")
EXAMPLE_ELASTIC = "elastic_rescale"


def _example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_report(name: str, res: dict, seconds: float, launches: dict,
                    peaks: list) -> dict:
    out = {"seconds": seconds, "check": res["check"],
           "peak_device_bytes": peaks}
    shutil.rmtree(res["workdir"], ignore_errors=True)
    say(f"example {name}: {seconds:.3f} s, {json.dumps(out['check'])}, "
        f"peaks {peaks}, launches {json.dumps(launches)}")
    return out


def examples(dev) -> dict:
    """The examples phase: each twin's ``main(device=dev)``, its seconds,
    its check and launches, and each process's peak device bytes; the
    twins' temp dirs under ``build/``, removed as each ends. The elastic
    twin's 8 ranks (processes of their own, which report their K7/K8
    launches and peaks) run in a thread beside the in-process twins, which
    run one after another, their launches and peak read around each.
    Fails if a check fails or K7 or K8 never launched."""
    import tempfile
    import threading

    import torch
    root = ROOT / "build" / "chip_smoke_examples"
    shm = Path("/dev/shm") / f"repro-bb-{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, str(root)
    out, launches, elastic = {}, {}, {}

    def run_elastic():
        t0 = time.monotonic()
        try:
            elastic["res"] = _example(EXAMPLE_ELASTIC).main(device=dev)
        except Exception as e:      # reported once the thread is joined
            elastic["error"] = repr(e)
        elastic["seconds"] = time.monotonic() - t0

    worker = threading.Thread(target=run_elastic, name="example-elastic")
    try:
        worker.start()
        for name in EXAMPLES_IN_PROCESS:
            # the serving store's fast tier is per process under /dev/shm,
            # where an earlier serve's checkpoint would be a resume point
            shutil.rmtree(shm, ignore_errors=True)
            mod = _example(name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.monotonic()
            res = mod.main(device=dev)
            torch.cuda.synchronize()
            launches[name] = read_counts()
            out[name] = _example_report(
                name, res, time.monotonic() - t0, launches[name],
                [torch.cuda.max_memory_allocated(dev)])
    finally:
        # the ranks are stopped by the twin's own main, never left behind
        worker.join()
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(shm, ignore_errors=True)
        if "res" not in elastic:
            shutil.rmtree(root, ignore_errors=True)
    if "error" in elastic:
        fail(f"example {EXAMPLE_ELASTIC} failed: {elastic['error']}")
    ranks = elastic["res"]["ranks"]
    launches[EXAMPLE_ELASTIC] = {
        k: (sum(r["launches"][k] for r in ranks)
            if k in ("rmsnorm", "flash_attention") else None)
        for k in _counters()}
    out[EXAMPLE_ELASTIC] = _example_report(
        EXAMPLE_ELASTIC, elastic["res"], elastic["seconds"],
        launches[EXAMPLE_ELASTIC], [r["peak_device_bytes"] for r in ranks])
    shutil.rmtree(root, ignore_errors=True)
    for name, rep in out.items():
        if not rep["check"]["ok"]:
            fail(f"example {name} failed its check: "
                 f"{json.dumps(rep['check'])}")
    for k in ("rmsnorm", "flash_attention"):
        if sum(c[k] for c in launches.values()) <= 0:
            fail(f"kernel {k} was not launched in the examples phase")
    return {**out, "launches": launches}


def _leaves(tree):
    from repro_torch.core.split_state import leaf_paths
    return [t for _, t in leaf_paths(tree)]


def main() -> int:
    if sys.argv[1:2] == ["--sharding-rank"]:
        return sharding_rank(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-rank"]:
        return serve_rank(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--mixers-rank"]:
        return mixers_rank(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--aot-load"]:
        return aot_load(Path(sys.argv[2]))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if "--stacks" in sys.argv[1:]:
        import atexit
        atexit.register(StackSampler().write,
                        out_dir / "chip_smoke_stacks.txt")
    card = card_line()
    say(card)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build
    t0 = time.monotonic()
    with phase("build"):
        logs = build.build_all()
    say(f"build: {len(build.KERNELS)} kernels from {len(logs)} sources in "
        f"{time.monotonic() - t0:.3f} s (nvcc, sm_90a) into "
        f"{build.build_dir()}")
    (out_dir / "chip_smoke_ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    dev = torch.device("cuda")
    if "--k7-only" in sys.argv[1:]:
        k7_route_parity(dev)
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        say(json.dumps({"k7": k7_shapes(dev, g)}))
        say(card)
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--k8-only" in sys.argv[1:]:
        model_kernel_parity(dev)
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        say(json.dumps({"k8": k8_shapes(dev, g), "ptxas": k8_ptxas()}))
        say(card)
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    with phase("parity"):
        parity(dev)
        model_kernel_parity(dev)
    if "--parity-only" in sys.argv[1:]:
        say(card)
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--zoo-only" in sys.argv[1:]:
        parity_zoo = zoo_parity(dev)
        z = zoo(dev, card, profile="--profile" in sys.argv[1:])
        z["parity"] = parity_zoo
        say(card)
        say(json.dumps({"zoo": z}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--parallel-only" in sys.argv[1:]:
        model_kernel_parity(dev)
        parity_zoo = zoo_parity(dev)
        z = zoo(dev, card, keep=True)
        z["parity"] = parity_zoo
        par = parallel(dev, card, z)
        (out_dir / "chip_smoke_parallel.json").write_text(
            json.dumps({"card": card, "zoo": z, "parallel": par}, indent=1))
        say(card)
        say(json.dumps({"zoo": z}))
        say(json.dumps({"parallel": par}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--families-only" in sys.argv[1:]:
        parity_fam = families_parity(dev)
        fam = families(dev, card, profile="--profile" in sys.argv[1:])
        fam["parity"] = parity_fam
        (out_dir / "chip_smoke_families.json").write_text(
            json.dumps({"card": card, "families": fam}, indent=1))
        say(card)
        say(json.dumps({"families": fam}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--zoo-serve-only" in sys.argv[1:]:
        with phase("zoo_serving"):
            zs = zoo_serving(dev, card, profile="--profile" in sys.argv[1:])
        (out_dir / "chip_smoke_zoo_serve.json").write_text(
            json.dumps({"card": card, "zoo_serving": zs,
                        "phase_s": PHASE_S}, indent=1))
        say(json.dumps({"phase_s": PHASE_S}))
        say(card)
        say(json.dumps({"zoo_serving": zs}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--remat-only" in sys.argv[1:]:
        model_kernel_parity(dev)
        with phase("remat"):
            rem = remat_phase(dev, card)
        (out_dir / "chip_smoke_remat.json").write_text(
            json.dumps({"card": card, "remat": rem}, indent=1))
        say(json.dumps({"phase_s": PHASE_S}))
        say(card)
        say(json.dumps({"remat": rem}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--compile-only" in sys.argv[1:]:
        model_kernel_parity(dev)
        with phase("compile"):
            comp = compile_phase(dev, card, None,
                                 "--op-cost" in sys.argv[1:])
        (out_dir / "chip_smoke_compile.json").write_text(
            json.dumps({"card": card, "compile": comp}, indent=1))
        say(json.dumps({"phase_s": PHASE_S}))
        say(card)
        say(json.dumps({"compile": comp}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--mixers-only" in sys.argv[1:]:
        with phase("mixers"):
            mix = mixers(dev, card)
        (out_dir / "chip_smoke_mixers.json").write_text(
            json.dumps({"card": card, "mixers": mix, "phase_s": PHASE_S},
                       indent=1))
        say(json.dumps({"phase_s": PHASE_S}))
        say(card)
        say(json.dumps({"mixers": mix}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--examples-only" in sys.argv[1:]:
        model_kernel_parity(dev)
        with phase("examples"):
            ex = examples(dev)
        (out_dir / "chip_smoke_examples.json").write_text(
            json.dumps({"card": card, "examples": ex, "phase_s": PHASE_S},
                       indent=1))
        say(json.dumps({"phase_s": PHASE_S}))
        say(card)
        say(json.dumps({"examples": ex}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--sharding-only" in sys.argv[1:]:
        sh = sharding(dev, card)
        say(card)
        say(json.dumps({"sharding": sh}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--engine-only" in sys.argv[1:]:
        reset_counts()
        with phase("main_path"):
            _, launches, stats = main_path(dev, card)
        (out_dir / "chip_smoke_engine.json").write_text(
            json.dumps({"card": card, "main_path": stats,
                        "launches": launches}, indent=1))
        say(json.dumps({"phase_s": PHASE_S}))
        say(card)
        say(json.dumps({"main_path": stats, "launches": launches}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--reliability-only" in sys.argv[1:]:
        rel = reliability(dev, card)
        say(card)
        say(json.dumps({"reliability": rel}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    profile = "--profile" in sys.argv[1:]
    reset_counts()
    with phase("main_path"):
        state, launches, stats = main_path(dev, card, profile=profile)
        embed = state["params"]["embed"]
        del state
        torch.cuda.empty_cache()
    reset_counts()
    with phase("serving"):
        serve_stats, serve_launches = serving(dev, card, profile=profile)
    reset_counts()
    with phase("training"):
        train_stats, train_launches = training(dev, card, profile=profile)
        torch.cuda.empty_cache()
    with phase("reliability"):
        rel = reliability(dev, card, serve_stats["decode_tok_per_s"])
        torch.cuda.empty_cache()
    with phase("zoo"):
        parity_zoo = zoo_parity(dev)
        zoo_stats = zoo(dev, card, profile=profile, keep=True)
        zoo_stats["parity"] = parity_zoo
        torch.cuda.empty_cache()
    with phase("parallel"):
        par = parallel(dev, card, zoo_stats)
        torch.cuda.empty_cache()
    with phase("families"):
        parity_fam = families_parity(dev)
        fam = families(dev, card, profile=profile)
        fam["parity"] = parity_fam
        torch.cuda.empty_cache()
    with phase("zoo_serving"):
        zs = zoo_serving(dev, card, profile=profile)
    with phase("remat"):
        rem = remat_phase(dev, card)
        torch.cuda.empty_cache()
    with phase("sharding"):
        shard = sharding(dev, card)
    codec = ("byteplane_inv", "quantize_blocks", "dequantize_blocks")
    with phase("kernel_tables"):
        rows = kernel_table(dev, embed, {
            **launches, **{k: train_launches[k] for k in codec}})
        del embed
        torch.cuda.empty_cache()
        rows += model_kernel_table(dev, {
            **serve_launches, "rmsnorm_train": train_launches["rmsnorm"]})
    for row in rows:
        row["launches_reliability"] = {
            seg: c[row["name"]] for seg, c in rel["launches"].items()}
        row["launches_zoo"] = {
            seg: c[row["name"]] for seg, c in zoo_stats["launches"].items()}
        row["launches_families"] = {
            seg: c[row["name"]] for seg, c in fam["launches"].items()}
        row["launches_zoo_serving"] = {
            seg: c[row["name"]] for seg, c in zs["launches"].items()}
        row["launches_remat"] = {
            seg: c[row["name"]] for seg, c in rem["launches"].items()}
        row["launches_sharding"] = {
            seg: c[row["name"]] for seg, c in shard["launches"].items()}
        row["launches_parallel"] = {
            seg: c[row["name"]] for seg, c in par["launches"].items()}
        if row["name"] == "flash_attention":
            row["families"] = fam["k8"]
            row["q_offset"] = par["q_offset"]
        elif row["name"] == "rmsnorm":
            row["families"] = fam["k7"]
    with phase("rans_stage"):
        stats["rans_stage"] = rans_stage_ms(dev)
    with phase("compile"):
        comp = compile_phase(dev, card, par, "--op-cost" in sys.argv[1:])
    for row in rows:
        row["launches_compile"] = {
            "mesh_serving": sum(m["launches"][row["name"]]
                                for r in comp["mesh_serving"]["ranks"]
                                for m in r["meshes"]),
            "aot_load": comp["aot"]["load_launches"][row["name"]]}
    with phase("mixers"):
        mix = mixers(dev, card)
    for row in rows:
        row["launches_mixers"] = {
            seg: c[row["name"]] for seg, c in mix["launches"].items()}
    with phase("examples"):
        ex = examples(dev)
    for row in rows:
        row["launches_examples"] = {
            seg: c[row["name"]] for seg, c in ex["launches"].items()}
    PHASE_S["total"] = time.monotonic() - T_START
    say(json.dumps({"phase_s": PHASE_S}))
    say(card)
    say(json.dumps({"reliability": rel}))
    say(json.dumps({"zoo": zoo_stats}))
    say(json.dumps({"families": fam}))
    say(json.dumps({"zoo_serving": zs}))
    say(json.dumps({"remat": rem}))
    say(json.dumps({"sharding": shard}))
    say(json.dumps({"parallel": par}))
    say(json.dumps({"compile": comp}))
    say(json.dumps({"mixers": mix}))
    say(json.dumps({"examples": ex}))
    say(json.dumps({"main_path": stats, "serving": serve_stats,
                    "training": train_stats}))
    say(json.dumps({"kernels": rows}))
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps({"card": card, "main_path": stats,
                    "serving": serve_stats, "training": train_stats,
                    "reliability": rel, "zoo": zoo_stats, "families": fam,
                    "zoo_serving": zs,
                    "remat": rem, "sharding": shard, "parallel": par, "compile": comp,
                    "mixers": mix, "examples": ex, "kernels": rows,
                    "phase_s": PHASE_S},
                   indent=1))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
